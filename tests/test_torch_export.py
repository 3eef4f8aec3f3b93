"""The port's exported serving artifacts (``dlwp_cs_tpu_torch.serve.export``)
against the JAX package's, and its operators for ``torch.export``.

The cases of ``tests/test_export.py`` that apply to the port, on the CPU at
n = 8 (filters (4, 8)): the JAX estimator gets seeded flax parameters and
normalization stats, the port's estimator the same tree through
``load_jax_params``.  Tolerances:

* the port's artifact against the port's live ``ForecastService``: equal,
  since on the CPU both run the same plain operations in the same order
  (the exported step calls the kernels' operators, whose CPU
  implementation is the plain version the live wrappers run);
* against the JAX package's ``ExportedForecaster`` (exported on the CPU
  from the same weights): 2e-5 in normalized units (float32 sums in
  another order), 2e-5 of the largest std on denormalized fields;
* a batch bucketed with padding against single calls: 1e-5 of the largest
  std (the same operations at another batch size);
* normalized against raw units: 1e-5 relative, the float32 normalization.

``test_format1_backcompat`` has no counterpart: a format-1 artifact of the
reference is StableHLO, which a PyTorch artifact is not (``ROADMAP.md``'s
recorded divergences).
"""

import dataclasses
import json
import shutil
import subprocess
import sys
import types
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.estimator import DLWPEstimator as JEstimator
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu.models import ExperimentConfig as JExperimentConfig
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import ConvLSTMConfig, DataConfig, ExperimentConfig, UNetConfig
from dlwp_cs_tpu_torch.ops import library
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3_plain
from dlwp_cs_tpu_torch.ops.ring_kernel import xring_fused_apply_plain
from dlwp_cs_tpu_torch.serve import (
    ExportedForecaster,
    ExportedForecastService,
    ForecastHTTPServer,
    ForecastService,
    ensemble_request,
    export_forecaster,
    forecast_request,
)
from dlwp_cs_tpu_torch.serve import export as export_mod

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
N = 8
STEPS = 3
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}
STD_MAX = 300.0


@pytest.fixture(scope="module")
def served():
    """The JAX estimator, the port's on the same weights, the constants and
    raw windows with their init times."""
    jcfg = JExperimentConfig(data=JDataConfig(**DATA), model=JUNetConfig(filters=(4, 8)))
    jest = JEstimator(jcfg)
    x0 = jnp.zeros((1, 6, N, N, jcfg.data.input_channels))
    params = jax.jit(jest.model.init)(jax.random.PRNGKey(1), x0)
    jest.state = types.SimpleNamespace(params=params)
    jest.stats = STATS
    cfg = ExperimentConfig(data=DataConfig(**DATA), model=UNetConfig(filters=(4, 8)))
    est = DLWPEstimator(cfg, device="cpu").load_state(
        STATS, jax.tree_util.tree_map(np.array, params))
    rng = np.random.default_rng(0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    windows = (rng.normal(size=(4, 2, 6, N, N, 2)) * std + mean).astype(np.float32)
    t0 = np.asarray([9668.5, 9700.25, 9701.0, 10123.75])
    return jest, est, const, windows, t0


@pytest.fixture(scope="module")
def artifact(served, tmp_path_factory):
    _, est, const, _, _ = served
    path = tmp_path_factory.mktemp("export") / "artifact"
    export_forecaster(est, path, steps=STEPS, batch_sizes=(1, 4), constants=const)
    return path


def test_layout_and_meta(artifact):
    assert (artifact / "step_b1.pt2").exists()
    assert (artifact / "step_b4.pt2").exists()
    assert (artifact / "stats.npz").exists()
    meta = json.loads((artifact / "meta.json").read_text())
    assert meta["format"] == export_mod._FORMAT
    assert meta["steps"] == STEPS
    assert meta["steps_values"] == [STEPS]
    assert meta["batch_sizes"] == [1, 4]
    assert meta["window_shape"] == [2, 6, N, N, 2]
    assert meta["variables"] == ["z500", "t2m"]
    assert meta["platforms"] == ["cpu"]
    assert (meta["step_hours"], meta["output_time_steps"]) == (6.0, 2)
    exp = ExportedForecaster.load(artifact, device="cpu")
    assert len(exp._lead_hours(STEPS)) == STEPS * 2
    with np.load(artifact / "stats.npz") as f:
        np.testing.assert_array_equal(f["std"], np.float32(STATS["std"]))


def test_matches_live_service(served, artifact):
    _, est, const, windows, t0 = served
    svc = ForecastService(est, constants=const)
    exp = ExportedForecaster.load(artifact, device="cpu")
    live = svc.forecast(windows[0], t0[0], steps=STEPS)
    aot = exp.forecast(windows[0], t0[0])
    assert aot.fields.shape == live.fields.shape == (1, 2 * STEPS, 6, N, N, 2)
    np.testing.assert_array_equal(aot.fields, live.fields)
    np.testing.assert_array_equal(aot.lead_hours, live.lead_hours)
    np.testing.assert_array_equal(aot.init_times, [t0[0]])
    assert aot.variables == ("z500", "t2m")


def test_matches_reference_artifact(served, artifact, tmp_path):
    """The port's artifact against the JAX package's ``ExportedForecaster``,
    both exported on the CPU from the same weights."""
    from dlwp_cs_tpu.serve import ExportedForecaster as JExportedForecaster
    from dlwp_cs_tpu.serve import export_forecaster as j_export_forecaster

    jest, _, const, windows, t0 = served
    j_export_forecaster(jest, tmp_path / "jax", steps=STEPS, batch_sizes=(4,),
                        constants=const)
    ref = JExportedForecaster.load(tmp_path / "jax")
    exp = ExportedForecaster.load(artifact, device="cpu")
    want = ref.forecast(windows[:3], t0[:3])
    got = exp.forecast(windows[:3], t0[:3])
    assert got.fields.shape == np.asarray(want.fields).shape == (3, 2 * STEPS, 6, N, N, 2)
    np.testing.assert_allclose(got.fields, np.asarray(want.fields), rtol=0,
                               atol=2e-5 * STD_MAX)
    mean, std = exp._mean, exp._std
    normed = (windows[:3] - mean) / std
    np.testing.assert_allclose(
        exp.forecast(normed, t0[:3], normalized=True).fields,
        np.asarray(ref.forecast(normed, t0[:3], normalized=True).fields), rtol=0, atol=2e-5)
    np.testing.assert_array_equal(got.lead_hours, np.asarray(want.lead_hours))


def test_loads_in_a_fresh_process_from_the_artifact_alone(served, artifact, tmp_path):
    """A process that has only the artifact directory (copied away from the
    checkpoint-free export) and this package serves the same forecast."""
    _, est, const, windows, t0 = served
    alone = tmp_path / "alone"
    shutil.copytree(artifact, alone)
    np.save(tmp_path / "window.npy", windows[1])
    code = (
        "import sys, numpy as np\n"
        "from dlwp_cs_tpu_torch.serve.export import ExportedForecaster\n"
        f"exp = ExportedForecaster({str(alone)!r}, device='cpu')\n"
        f"w = np.load({str(tmp_path / 'window.npy')!r})\n"
        f"np.save({str(tmp_path / 'out.npy')!r}, exp.forecast(w, {float(t0[1])!r}).fields)\n"
        "print(sorted(m for m in sys.modules if m.startswith(('jax', 'dlwp_cs_tpu.'))))\n"
    )
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                         text=True, timeout=300, check=True)
    assert out.stdout.strip().splitlines()[-1] == "[]", out.stdout
    live = ForecastService(est, constants=const).forecast(windows[1], t0[1], steps=STEPS)
    np.testing.assert_array_equal(np.load(tmp_path / "out.npy"), live.fields)


def test_bucketing_and_padding(artifact, served):
    _, _, _, windows, t0 = served
    exp = ExportedForecaster.load(artifact, device="cpu")
    # batch 3 buckets to the exported 4; results equal per-member calls
    batched = exp.forecast(windows[:3], t0[:3])
    assert batched.fields.shape[0] == 3
    np.testing.assert_array_equal(batched.init_times, t0[:3])
    for i in range(3):
        single = exp.forecast(windows[i], float(t0[i]))
        np.testing.assert_allclose(batched.fields[i], single.fields[0], rtol=0,
                                   atol=1e-5 * STD_MAX)
    # beyond the largest exported bucket -> clean error
    with pytest.raises(ValueError, match="exceeds the largest"):
        exp.forecast(np.concatenate([windows, windows[:1]]), np.append(t0, t0[0]))


def test_normalized_mode_and_contract_errors(artifact, served):
    _, _, _, windows, t0 = served
    exp = ExportedForecaster.load(artifact, device="cpu")
    raw = exp.forecast(windows[0], t0[0])
    norm = exp.forecast((windows[0] - exp._mean) / exp._std, t0[0], normalized=True)
    np.testing.assert_allclose(norm.fields * exp._std + exp._mean, raw.fields,
                               rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError, match="window must be"):
        exp.forecast(windows[0][..., :1], t0[0])
    with pytest.raises(ValueError, match="t0_days batch"):
        exp.forecast(windows, t0[:2])
    with pytest.raises(ValueError, match="exported with steps"):
        exp.forecast(windows[0], t0[0], steps=STEPS + 1)


def test_artifact_served_over_http(artifact, served):
    """The deployment without model code: the HTTP front end over the
    artifact alone."""
    _, est, const, windows, t0 = served
    svc = ExportedForecastService(artifact, max_wait_ms=100.0, device="cpu")
    assert svc.steps == STEPS
    assert svc.info()["backend"] == "aot-artifact"
    srv = ForecastHTTPServer(svc).start()
    try:
        fields, lead, init = forecast_request("127.0.0.1", srv.port, windows[0], t0[0], STEPS)
        live = ForecastService(est, constants=const).forecast(windows[0], t0[0], steps=STEPS)
        np.testing.assert_array_equal(fields, live.fields)
        np.testing.assert_array_equal(lead, live.lead_hours)
        np.testing.assert_array_equal(init, [t0[0]])
        # an unexported steps value -> a clean 400 with the artifact's message
        with pytest.raises(RuntimeError, match="exported with steps"):
            forecast_request("127.0.0.1", srv.port, windows[0], t0[0], STEPS + 1)
        # /ensemble is not served by artifact backends: a well-formed request
        # meets that gate, not the malformed-payload 400
        with pytest.raises(RuntimeError, match="does not support /ensemble"):
            ensemble_request("127.0.0.1", srv.port, windows[0], t0[0], STEPS, 3)
        assert svc.info()["step_hours"] == 6.0
        assert svc.info()["output_time_steps"] == 2
        assert svc.info()["platforms"] == ["cpu"]
    finally:
        srv.stop()
    assert svc.stats.requests >= 1


def test_unfitted_estimator_rejected(tmp_path):
    cfg = ExperimentConfig(data=DataConfig(grid_n=N, variables=("z500", "t2m"), constants=()),
                           model=UNetConfig(filters=(4, 8)))
    with pytest.raises(RuntimeError, match="fit or load"):
        export_forecaster(DLWPEstimator(cfg, device="cpu"), tmp_path / "x", steps=1)


def test_format_version_guard(artifact, tmp_path):
    broken = tmp_path / "broken"
    shutil.copytree(artifact, broken)
    meta = json.loads((broken / "meta.json").read_text())
    meta["format"] = 999
    (broken / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="unsupported artifact format"):
        ExportedForecaster.load(broken, device="cpu")
    # a StableHLO artifact of the reference (format 2) is not a PyTorch one
    meta["format"] = 2
    (broken / "meta.json").write_text(json.dumps(meta))
    with pytest.raises(ValueError, match="unsupported artifact format 2"):
        ExportedForecaster.load(broken, device="cpu")


def test_device_defaults_to_the_gpu(artifact, monkeypatch):
    """Without a GPU and without ``device=``, loading raises; a CPU artifact
    does not run on another platform."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedForecaster(artifact)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ExportedForecastService(artifact)
    with pytest.raises(ValueError, match="exported for"):
        ExportedForecaster(artifact, device="meta")


def test_reexport_removes_stale_programs(served, artifact, tmp_path):
    _, est, const, windows, t0 = served
    target = tmp_path / "re"
    shutil.copytree(artifact, target)
    stale = target / "step_b7.pt2"
    stale.write_bytes(b"stale")
    export_forecaster(est, target, steps=STEPS, batch_sizes=(1,), constants=const)
    assert not stale.exists()
    assert not (target / "step_b4.pt2").exists()  # the old bucket
    assert (target / "step_b1.pt2").exists()
    fc = ExportedForecaster.load(target, device="cpu").forecast(windows[0], t0[0])
    assert np.isfinite(fc.fields).all()


def test_failed_reexport_preserves_old_artifact(served, artifact, tmp_path, monkeypatch):
    """A failure in the middle of an export over a live artifact directory
    leaves the previous artifact servable: the programs are staged under
    tmp names, and stale deletion and the meta rewrite come only after every
    export succeeded."""
    _, est, const, windows, t0 = served
    target = tmp_path / "live"
    shutil.copytree(artifact, target)
    before = sorted(p.name for p in target.glob("step_b*.pt2"))
    meta_before = (target / "meta.json").read_text()
    real_export = torch.export.export
    calls = {"n": 0}

    def failing_export(*a, **kw):
        calls["n"] += 1
        if calls["n"] >= 2:
            raise RuntimeError("simulated mid-export failure")
        return real_export(*a, **kw)

    monkeypatch.setattr(export_mod.torch.export, "export", failing_export)
    with pytest.raises(RuntimeError, match="simulated"):
        export_forecaster(est, target, steps=(1, STEPS), batch_sizes=(1, 2), constants=const)
    assert sorted(p.name for p in target.glob("step_b*.pt2")) == before
    assert not list(target.glob(".step_b*"))
    assert (target / "meta.json").read_text() == meta_before
    fc = ExportedForecaster.load(target, device="cpu").forecast(windows[0], t0[0])
    assert np.isfinite(fc.fields).all()


def test_republish_failing_at_a_rename_leaves_the_old_artifact_servable(
        served, artifact, tmp_path, monkeypatch):
    """A republish that fails at its second ``Path.replace`` (after the first
    new program was renamed into place) leaves the old artifact loading and
    forecasting as before, and its meta.json names no missing program: the
    programs are renamed first, stats.npz and meta.json after them, and the
    old buckets' programs are deleted last."""
    import pathlib

    _, est, const, windows, t0 = served
    target = tmp_path / "live"
    shutil.copytree(artifact, target)
    before = ExportedForecaster.load(target, device="cpu").forecast(windows[0], t0[0])
    real_replace = pathlib.Path.replace
    calls = []

    def failing_replace(self, dst):
        calls.append(Path(dst).name)
        if len(calls) == 2:
            raise OSError("simulated crash at the second rename")
        return real_replace(self, dst)

    monkeypatch.setattr(pathlib.Path, "replace", failing_replace)
    with pytest.raises(OSError, match="simulated"):
        export_forecaster(est, target, steps=STEPS, batch_sizes=(1, 2), constants=const)
    monkeypatch.undo()
    assert calls == ["step_b1.pt2", "step_b2.pt2"]
    meta = json.loads((target / "meta.json").read_text())
    assert meta["batch_sizes"] == [1, 4]
    assert all((target / f"step_b{b}.pt2").exists() for b in meta["batch_sizes"])
    assert not list(target.glob(".*"))
    after = ExportedForecaster.load(target, device="cpu").forecast(windows[0], t0[0])
    np.testing.assert_array_equal(after.fields, before.fields)


def test_empty_steps_and_platforms_rejected(served, tmp_path):
    _, est, const, _, _ = served
    with pytest.raises(ValueError, match="at least one"):
        export_forecaster(est, tmp_path / "x", steps=[], constants=const)
    with pytest.raises(ValueError, match="at least one"):
        export_forecaster(est, tmp_path / "x", steps=STEPS, batch_sizes=(), constants=const)
    with pytest.raises(ValueError, match="platforms"):
        export_forecaster(est, tmp_path / "x", steps=STEPS, constants=const,
                          platforms=("cuda",))
    with pytest.raises(ValueError, match="constant"):
        export_forecaster(est, tmp_path / "x", steps=STEPS)
    assert not (tmp_path / "x").exists()


@pytest.fixture(scope="module")
def multi(served, tmp_path_factory):
    _, est, const, _, _ = served
    path = tmp_path_factory.mktemp("export_multi") / "artifact"
    export_forecaster(est, path, steps=(1, STEPS), batch_sizes=(1,), constants=const)
    return path


def test_two_steps_values_served(served, multi):
    _, est, const, windows, t0 = served
    exp = ExportedForecaster.load(multi, device="cpu")
    assert exp.steps_values == [1, STEPS]
    svc = ForecastService(est, constants=const)
    for s in (1, STEPS):
        aot = exp.forecast(windows[0], t0[0], steps=s)
        live = svc.forecast(windows[0], t0[0], steps=s)
        assert aot.fields.shape == live.fields.shape == (1, 2 * s, 6, N, N, 2)
        np.testing.assert_array_equal(aot.fields, live.fields)
    with pytest.raises(ValueError, match="pass steps"):
        exp.forecast(windows[0], t0[0])
    with pytest.raises(ValueError, match="exported with steps"):
        exp.forecast(windows[0], t0[0], steps=2)


def test_multi_steps_over_http(served, multi):
    """One artifact serves two steps values over HTTP."""
    _, _, _, windows, t0 = served
    svc = ExportedForecastService(multi, max_wait_ms=50.0, device="cpu")
    assert svc.steps_values == [1, STEPS]
    srv = ForecastHTTPServer(svc).start()
    try:
        f1, lead1, _ = forecast_request("127.0.0.1", srv.port, windows[0], t0[0], 1)
        f3, lead3, _ = forecast_request("127.0.0.1", srv.port, windows[0], t0[0], STEPS)
        assert f1.shape[1] == 2 and f3.shape[1] == STEPS * 2
        assert len(lead1) == 2 and len(lead3) == STEPS * 2
        # the common prefix of the two products is the same model call
        np.testing.assert_array_equal(f3[:, :2], f1)
        with pytest.raises(RuntimeError, match="exported with steps"):
            forecast_request("127.0.0.1", srv.port, windows[0], t0[0], 2)
    finally:
        srv.stop()


def test_convlstm_artifact_matches_live_service(tmp_path):
    """The xring ConvLSTM exports through the ring kernel's operator and
    serves what the live service serves (equal on the CPU)."""
    data = DataConfig(grid_n=N, variables=("z500", "t2m"), constants=())
    cfg = ExperimentConfig(data=data, model=ConvLSTMConfig(conv_backend="xring",
                                                           filters=(4, 4)))
    est = DLWPEstimator(cfg, device="cpu", seed=3).load_state(STATS)
    export_forecaster(est, tmp_path / "lstm", steps=2, batch_sizes=(2,))
    program = torch.export.load(tmp_path / "lstm" / "step_b2.pt2")
    targets = {str(n.target) for n in program.graph.nodes if n.op == "call_function"}
    assert "dlwp_cs_torch.xring_fused_apply.default" in targets
    rng = np.random.default_rng(5)
    windows = (rng.normal(size=(2, 2, 6, N, N, 2)) * 10 + 100).astype(np.float32)
    got = ExportedForecaster(tmp_path / "lstm", device="cpu").forecast(windows, [100.0, 200.5])
    want = ForecastService(est).forecast(windows, [100.0, 200.5], steps=2)
    np.testing.assert_array_equal(got.fields, want.fields)


def test_export_tool_writes_an_artifact(served, tmp_path, capsys):
    """``python -m dlwp_cs_tpu_torch.tools.export_artifact`` on a checkpoint
    of a model without constants, then on one of a model with a constant
    channel taken from ``--constants-store``, an HDF5 store."""
    from dlwp_cs_tpu_torch.tools import export_artifact

    cfg = ExperimentConfig(data=DataConfig(grid_n=N, variables=("z500", "t2m"), constants=()),
                           model=UNetConfig(filters=(4,)))
    est = DLWPEstimator(cfg, device="cpu", seed=1).load_state(STATS)
    est.save(tmp_path / "ckpt")
    argv = ["--checkpoint", str(tmp_path / "ckpt"), "--out", str(tmp_path / "art"),
            "--steps", "1,2", "--batch-sizes", "1,2", "--device", "cpu"]
    assert export_artifact.main(argv) == 0
    assert "2 programs" in capsys.readouterr().out
    exp = ExportedForecaster(tmp_path / "art", device="cpu")
    assert exp.steps_values == [1, 2] and exp.batch_sizes == [1, 2]
    rng = np.random.default_rng(2)
    w = (rng.normal(size=(2, 6, N, N, 2)) * 10 + 100).astype(np.float32)
    np.testing.assert_array_equal(exp.forecast(w, 10.0, steps=2).fields,
                                  ForecastService(est).forecast(w, 10.0, steps=2).fields)
    from dlwp_cs_tpu_torch.data import MemoryStore, write_store

    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    write_store(tmp_path / "s.h5", MemoryStore.from_raw(
        np.zeros((3, 6, N, N, 2), np.float32), [0.0, 0.25, 0.5], ("z500", "t2m"),
        constants=const, constant_names=("topography",)))
    cfg = dataclasses.replace(cfg, data=DataConfig(**DATA))
    est = DLWPEstimator(cfg, device="cpu", seed=1).load_state(STATS)
    est.save(tmp_path / "ckpt_c")
    argv = ["--checkpoint", str(tmp_path / "ckpt_c"), "--out", str(tmp_path / "art_c"),
            "--steps", "2", "--device", "cpu", "--constants-store", str(tmp_path / "s.h5")]
    assert export_artifact.main(argv) == 0
    np.testing.assert_array_equal(
        ExportedForecaster(tmp_path / "art_c", device="cpu").forecast(w, 10.0).fields,
        ForecastService(est, constants=const).forecast(w, 10.0, steps=2).fields)


# ---- ops/library.py --------------------------------------------------------

def _conv_args(dtype):
    rng = np.random.default_rng(7)
    x = torch.from_numpy(rng.normal(size=(2, 6, N, N, 3)).astype(np.float32)).to(dtype)
    from dlwp_cs_tpu_torch.ops.halo import ext_strips

    ks = [torch.from_numpy((rng.normal(size=(3, 3, 3, 5)) * 0.2).astype(np.float32)).to(dtype)
          for _ in range(2)]
    bs = [torch.from_numpy(rng.normal(size=(5,)).astype(np.float32)).to(dtype)
          for _ in range(2)]
    return x, ext_strips(x), ks, bs


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_conv_operator_is_the_wrapper(dtype):
    """``dlwp_cs_torch::cs_conv3x3`` on a CPU tensor is the plain version;
    its fake implementation gives the shape and dtype (``opcheck``)."""
    x, ext, ks, bs = _conv_args(dtype)
    got = torch.ops.dlwp_cs_torch.cs_conv3x3(x, ext, *ks, *bs)
    torch.testing.assert_close(got, cs_conv3x3_plain(x, ext, *ks, *bs), rtol=0, atol=0)
    torch.library.opcheck(library.cs_conv3x3_op, (x, ext, *ks, *bs),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_ring_operator_is_the_wrapper(dtype):
    from dlwp_cs_tpu_torch.ops.ringfix import _same_conv

    x, ext, ks, _ = _conv_args(dtype)
    bases = (_same_conv(x, ks[0]), _same_conv(x, ks[1]))
    got = torch.ops.dlwp_cs_torch.xring_fused_apply(*bases, ext, *ks)
    torch.testing.assert_close(got, xring_fused_apply_plain(*bases, ext, *ks), rtol=0, atol=0)
    torch.library.opcheck(library.xring_fused_apply_op, (*bases, ext, *ks),
                          test_utils=("test_schema", "test_faketensor"))


@pytest.mark.parametrize("backend", ["auto", "xring"])
def test_cs_conv_routes_inference_through_the_operators(backend):
    """Inside ``use_library_ops`` an inference conv calls the operator (and
    equals the direct path); a conv that asks for a gradient keeps the
    autograd function, and outside the context nothing is routed."""
    from dlwp_cs_tpu_torch.ops.conv import cs_conv

    x, _, ks, bs = _conv_args(torch.float32)
    direct = cs_conv(x, *ks, bias_eq=bs[0], bias_pole=bs[1], backend=backend)
    seen = []

    def spy(op):
        def call(*args):
            seen.append(op)
            return op(*args)
        return call

    name = "cs_conv3x3_op" if backend == "auto" else "xring_fused_apply_op"
    from dlwp_cs_tpu_torch.ops import conv as conv_mod

    real = getattr(conv_mod, name)
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(conv_mod, name, spy(real))
        with library.use_library_ops():
            routed = cs_conv(x, *ks, bias_eq=bs[0], bias_pole=bs[1], backend=backend)
            assert len(seen) == 1
            k = ks[0].clone().requires_grad_(True)
            cs_conv(x, k, ks[1], bias_eq=bs[0], bias_pole=bs[1], backend=backend).sum().backward()
            assert len(seen) == 1 and k.grad is not None
        cs_conv(x, *ks, bias_eq=bs[0], bias_pole=bs[1], backend=backend)
        assert len(seen) == 1
    torch.testing.assert_close(routed, direct, rtol=0, atol=0)
