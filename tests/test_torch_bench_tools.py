"""The port's measurement tools (``dlwp_cs_tpu_torch/tools/``:
``capacity_bench``, ``trainer_wallclock``, ``serve_bench``,
``ensemble_bench``, ``scaling_bench``) against the reference's
``tools/``, and the forward kernel's streamed-weights plans, on the CPU.

* The capacity sweep's FLOP count equals the reference's
  ``unet_train_flops`` at every configuration of its sweep and batches 1,
  8 and 16.
* Each tool's ``main([..., "--device", "cpu", "--small"], rows)`` returns 0,
  prints the reference's keys, and reports every time as ``None`` (no CPU
  time is printed as the card's); without a card and without those flags it
  raises.  No process group is spawned here (``scaling_bench`` runs its
  ``1x1`` row in-process).
* ``ensemble_bench``'s folded member 0 equals the batch-1 rollout bit for
  bit, and ``serve_bench``'s ``auto`` rollout equals the reference's
  ``make_rollout_fn`` on the same parameters (the port's, seeded, handed to
  the reference as its flax tree) within 2e-5 in float32 at C8.
* The forward plan (``tc_plan``, ``fused_fits``) streams the weights with
  each chunk at exactly the sweep's three bfloat16 shapes whose resident
  plan does not fit the H100's 232,448 bytes, within 231,424 bytes (1 KB
  left for the launch), and every plan of the flagship's shapes is the
  one the resident planner gave before the mode existed.
"""

import importlib.util
import json
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.data import insolation_stats as j_insolation_stats
from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
from dlwp_cs_tpu.models import DataConfig as JDataConfig
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.rollout import make_rollout_fn as j_make_rollout_fn
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.models import DataConfig
from dlwp_cs_tpu_torch.ops.hopper_conv import fused_fits, fwd_plan, fwd_plan_args
from dlwp_cs_tpu_torch.tools import (
    capacity_bench,
    ensemble_bench,
    scaling_bench,
    serve_bench,
    trainer_wallclock,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

REPO = Path(__file__).resolve().parents[1]
SMS = 132
SMEM = 232448 - 1024


def _reference_tool(name):
    """The reference's ``tools/<name>.py``, loaded from its file (the
    directory is no package); it imports JAX, which runs on the CPU."""
    spec = importlib.util.spec_from_file_location(f"ref_{name}", REPO / "tools" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


@pytest.mark.parametrize("batch", [1, 8, 16])
def test_unet_train_flops_equals_the_reference(batch):
    ref = _reference_tool("capacity_bench")
    dcfg = DataConfig()
    for _, n, filters, _, _ in capacity_bench.CONFIGS:
        args = (n, filters, batch, dcfg.input_channels, dcfg.output_channels)
        assert capacity_bench.unet_train_flops(*args) == ref.unet_train_flops(*args)
    assert [c[:4] for c in capacity_bench.CONFIGS] == [
        ("flagship C48 (32,64,128) b16", 48, (32, 64, 128), 16),
        ("wide C48 (64,128,256) b16", 48, (64, 128, 256), 16),
        ("wider C48 (128,256,512) b8", 48, (128, 256, 512), 8),
        ("hires C96 (32,64,128) b8", 96, (32, 64, 128), 8),
        ("hires+wide C96 (64,128,256) b8", 96, (64, 128, 256), 8),
        ("hires+wide C96 (64,128,256,256) b8", 96, (64, 128, 256, 256), 8)]


def test_unet_convs_are_the_models_3x3_convs(monkeypatch):
    from dlwp_cs_tpu_torch.models import CubeSphereUNet, UNetConfig, layers

    # only the shapes are read: skip the truncated-normal draws, which take
    # seconds a model at these widths
    monkeypatch.setattr(layers, "lecun_normal_", lambda t, generator=None: t)
    for _, n, filters, _, _ in capacity_bench.CONFIGS + capacity_bench.SMALL_CONFIGS:
        model = CubeSphereUNet(UNetConfig(output_channels=8, filters=filters), 12,
                               device="meta")
        shapes = [tuple(c.kernel_eq.shape[2:]) for name, c in model.convs.items()
                  if name != "head"]
        assert [c[1:] for c in capacity_bench.unet_convs(n, filters, 12)] == shapes


def _json_lines(out):
    return [json.loads(line) for line in out.splitlines() if line[:1] in "[{"]


CPU = ["--device", "cpu", "--small"]
TOOLS = {
    "capacity_bench": (["--quick", "--repeats", "2"],
                       ["label", "n", "filters", "batch", "step_ms", "spread_ms",
                        "gridpoints_per_s", "tflops_per_s", "pct_of_bf16_peak"],
                       ["step_ms", "spread_ms", "gridpoints_per_s", "tflops_per_s",
                        "pct_of_bf16_peak"]),
    "serve_bench": (["--steps", "2", "--batches", "1", "2", "--repeats", "2"],
                    ["backend", "batch", "rollout_ms", "forecasts_per_s"],
                    ["rollout_ms", "forecasts_per_s"]),
    "ensemble_bench": (["--steps", "2", "--members", "2", "3", "--repeats", "2",
                        "--unrolls", "1", "2"],
                       ["what"], []),
    "scaling_bench": (["--configs", "1x1", "--iters", "1", "--batch-per-device", "1"],
                      ["mesh_shape", "n_devices", "step_seconds", "gridpoints_per_s",
                       "gridpoints_per_s_per_chip", "efficiency_vs_single"],
                      ["step_seconds", "gridpoints_per_s", "gridpoints_per_s_per_chip",
                       "efficiency_vs_single"]),
}


@pytest.mark.parametrize("tool", sorted(TOOLS))
def test_tool_runs_on_the_cpu_with_the_references_keys_and_no_times(tool, capsys):
    argv, keys, times = TOOLS[tool]
    mod = globals()[tool]
    rows = []
    assert mod.main(argv + CPU, rows) == 0
    out = capsys.readouterr().out
    lines = _json_lines(out)
    printed = lines[0] if len(lines) == 1 and isinstance(lines[0], list) else lines
    assert printed and len(printed) == len(rows)
    for line, row in zip(printed, rows):
        assert all(k in line for k in keys), (keys, line)
        assert all(line[k] is None for k in times), line
        assert line["card"] == "cpu (no times)"
    if tool == "capacity_bench":
        assert [r["conv3x3"] for r in rows] == [6, 10]
        assert all(r["fallback"] == [] for r in rows)
        # the plain versions stream nothing; three untimed steps on the CPU
        assert [(r["streamed"], r["steps_run"]) for r in rows] == [([], 3), ([], 3)]
    if tool == "ensemble_bench":
        assert rows[0]["what"] == "rollout b=1" and rows[0]["ms"] is None
        for r, m in zip(rows[1:], (2, 3)):
            assert r["what"] == f"ensemble M={m}"
            assert r["folded_ms"] is r["sequential_ms"] is r["speedup"] is None
            assert r["member0_bitwise_equal_to_rollout"]
    if tool == "scaling_bench":
        assert tuple(rows[0]["mesh_shape"]) == (1, 1) and not rows[0]["ranks_share_one_card"]


def test_trainer_wallclock_runs_on_the_cpu_with_no_times(capsys):
    rows = []
    assert trainer_wallclock.main(["--steps", "3", "--epochs", "2", "--fused", "2"] + CPU,
                                  rows) == 0
    out = capsys.readouterr().out
    for label in ("fused=2", "steps/epoch=3", "epoch 0:", "epoch 1:", "steady-state:"):
        assert label in out
    (r,) = rows
    assert r["per_step_ms"] == [None, None] and r["steady_ms"] is None
    assert r["dispatch_ms"] is None and r["data_wait_ms"] is None
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))


def test_trainer_wallclock_store_pipeline_on_the_cpu():
    """``store_pipeline`` over a ``MemoryStore`` (as on a machine without
    h5py): SeriesDataset -> prefetch_to_device -> Trainer.fit."""
    store = trainer_wallclock.synthetic_store(8, 3 * 2 + 8)
    r = trainer_wallclock.wallclock(steps=3, epochs=2, store=store, workers=0,
                                    device=torch.device("cpu"), small=True)
    assert r["store"] and r["steps"] == 3 and r["per_step_ms"] == [None, None]
    assert len(r["losses"]) == 3 and all(np.isfinite(r["losses"]))


@pytest.mark.parametrize("tool", sorted(TOOLS) + ["trainer_wallclock"])
def test_tool_without_a_card_raises(tool):
    mod = globals()[tool]
    if torch.cuda.is_available():
        pytest.skip("a card is present: the tools run there")
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])
    with pytest.raises(ValueError, match="--small"):
        mod.main(["--device", "cpu"])


def _flax_params(model):
    """The port model's parameters as the reference's flax tree."""
    tree = {}
    for scope, module in model.jax_scopes().items():
        node = tree
        for part in scope.split("/"):
            node = node.setdefault(part, {})
        node.update({k: jnp.asarray(p.detach().numpy()) for k, p in module.named_parameters()})
    return {"params": tree}


def test_serve_bench_rollout_matches_the_reference_rollout():
    n, filters, steps = 8, (4, 8), 3
    models = serve_bench.build_models(n, filters, "cpu", compute_dtype="float32", seed=3)
    ours = serve_bench.make_rollouts(models, n, steps=steps, device="cpu")["auto"]
    jd = JDataConfig(grid_n=n)
    jm = JUNet(JUNetConfig(output_channels=jd.output_channels, filters=filters))
    lat, lon = CubedSphere(n).cell_latlon
    # the insolation normalized by the JAX pipeline's own statistics
    mean, std = j_insolation_stats(lat, lon)
    ref_roll = jax.jit(j_make_rollout_fn(
        jm.apply, jd, lat=lat, lon=lon, constants=jnp.zeros((6, n, n, len(jd.constants))),
        insol_mean=mean, insol_std=std, steps=steps))
    window = np.random.default_rng(11).normal(
        size=(2, jd.input_time_steps, 6, n, n, jd.n_variables)).astype(np.float32)
    ref = np.asarray(ref_roll(_flax_params(models["auto"]), jnp.asarray(window), 9000.0).fields)
    got = ours(torch.from_numpy(window), 9000.0).fields.numpy()
    assert got.shape == ref.shape == (2, 2 * steps, 6, n, n, jd.n_variables)
    np.testing.assert_allclose(got, ref, rtol=0, atol=2e-5)


# ---- the forward kernel's streamed weights ---------------------------------

# the plans the flagship's 8 conv shapes took before the streamed mode
# existed: ``(h, cs, nw, tpb, smem)`` at 132 SMs, by dtype and batch
FLAGSHIP = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
            (12, 128, 128), (24, 192, 64), (48, 96, 32)]
FLAGSHIP_PLANS = {
    ("bfloat16", 1): [(2, 32, 2, 1, 30720), (2, 32, 2, 1, 55040), (4, 16, 1, 1, 38784),
                      (4, 16, 1, 1, 52608), (5, 16, 1, 1, 43328), (5, 16, 1, 1, 70976),
                      (4, 16, 1, 1, 107904), (2, 32, 2, 1, 101120)],
    ("bfloat16", 16): [(5, 32, 4, 2, 45120), (5, 32, 4, 4, 79040), (5, 64, 4, 2, 70592),
                       (5, 64, 4, 2, 112064), (10, 64, 4, 2, 109824), (10, 64, 4, 3, 192768),
                       (10, 32, 4, 5, 188160), (5, 16, 2, 8, 97472)],
    ("float32", 1): [(5, 16, 2, 1, 93472), (5, 16, 2, 1, 102688), (5, 16, 1, 1, 62368),
                     (5, 16, 1, 1, 80800), (4, 16, 1, 1, 57280), (4, 16, 1, 1, 94144),
                     (5, 16, 1, 1, 154528), (5, 16, 2, 1, 139552)],
    ("float32", 16): [(5, 32, 4, 4, 102944), (5, 32, 4, 8, 121376), (10, 32, 4, 3, 112256),
                      (10, 32, 4, 5, 149120), (12, 32, 4, 3, 121280), (12, 32, 4, 3, 195008),
                      (10, 16, 2, 9, 185728), (5, 32, 4, 8, 195104)],
}


@pytest.mark.parametrize("dtype,b", sorted(FLAGSHIP_PLANS))
def test_flagship_forward_plans_are_unchanged(dtype, b):
    tdt = getattr(torch, dtype)
    got = [fwd_plan_args(tdt, b, n, n, cin, cout, SMS) for n, cin, cout in FLAGSHIP]
    assert got == FLAGSHIP_PLANS[dtype, b]
    assert not any(fwd_plan(tdt, b, n, n, cin, cout, SMS).geom.stream
                   for n, cin, cout in FLAGSHIP)


def test_streamed_forward_exactly_at_the_sweeps_refused_shapes():
    """Of every 3x3 conv of the capacity sweep at its batch (and at batch
    1), the bf16 forward streams its weights at exactly (12, 512 -> 512),
    (24, 768 -> 256) and (24, 512 -> 256), whose resident plans refuse;
    each streamed plan fits, and every conv of the sweep plans its forward,
    dx and dw kernels (no fallback)."""
    dcfg = DataConfig()
    streamed = set()
    for _, n, filters, batch, _ in capacity_bench.CONFIGS:
        for i, (s, cin, cout) in enumerate(capacity_bench.unet_convs(n, filters,
                                                                     dcfg.input_channels)):
            for b in (1, batch):
                plan = fwd_plan(torch.bfloat16, b, s, s, cin, cout, SMS)
                assert plan.geom.smem <= SMEM
                try:
                    fwd_plan(torch.bfloat16, b, s, s, cin, cout, SMS, stream=False)
                    assert not plan.geom.stream
                except ValueError:
                    assert plan.geom.stream
                    streamed.add((b == batch, s, cin, cout))
                assert fused_fits(torch.bfloat16, b, s, cin, cout, SMS, i > 0, True)
    assert streamed == {(w, *c) for w in (False, True)
                        for c in ((12, 512, 512), (24, 768, 256), (24, 512, 256))}


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
@pytest.mark.parametrize("b,n,cin,cout", [(8, 12, 512, 512), (8, 24, 768, 256),
                                          (8, 24, 512, 256), (1, 12, 512, 512)])
def test_streamed_geometry_counts_two_stages_of_a_chunks_weights(dtype, b, n, cin, cout):
    """A streamed plan's shared memory: two stages of 9 taps x kc units x
    cs (bf16: rows of cs + 8 or 16 units; f32: the weights as n x (9 kc +
    8) units) beside the input stages, as ``make_tc_geom`` counts it."""
    tdt = getattr(torch, dtype)
    g = fwd_plan(tdt, b, n, n, cin, cout, SMS, stream=True).geom
    stage = (g.h + 2) * (n + 2) * (g.kc + 8)
    if dtype == "bfloat16":
        wstage = 9 * g.kc * (g.cs + (8 if (g.cs // 8) % 2 == 0 else 16))
        assert g.smem == 2 * (2 * wstage + 2 * stage)
    else:
        wstage = g.cs * (9 * g.kc + 8)
        assert g.smem == 2 * (2 * wstage + 3 * stage)
    assert g.stream and g.smem <= SMEM and g.kp == -(-cin * tdt.itemsize // 2 // g.kc) * g.kc
