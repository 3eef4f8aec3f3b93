"""The port's example workflows (``dlwp_cs_tpu_torch.examples``) against the
reference's ``examples/01..07``.

One module fixture runs the reference's seven scripts in this process, as a
user chains them through a workdir (each loaded from its file; their
metric, request and step functions wrapped in the loaded module to record
what they returned).  Another runs the port's chain through each example's
``main([...])`` with ``--device cpu`` (04 takes none).  Sizes are below the
README's CPU smoke: C8 from a 32 x 64 grid over 12 days (bilinear weights:
the conservative generator has tests of its own), the U-Net with filters
(4,).

Tolerances, float32 on the CPU:

* 01: the port's ``predictors_cs.h5``, read by the reference's
  ``open_store``, against the reference's: fields 1e-5 of each variable's
  largest |value|, mean and std 1e-6 relative, constants 1e-5
  (``tests/test_torch_preprocessing.py``'s);
* 02: ``experiment.json`` equal, ``stats.json`` the same keys, its values
  1e-6 relative;
* 03, 06: the same parameters (``load_jax_params``) give forecasts within
  1e-5 of each variable's std; lead hours and init times equal;
* 04: the same ``forecast.npz`` and store give the same table, 1e-5
  relative;
* 05: per-step sequence losses over 4 steps from the reference's
  ``PRNGKey(0)`` parameters, 1e-5 relative;
* 07: with the reference's perturbations, CRPS, RMSE and spread per lead
  within 1e-5 of the largest std; the exported artifact against the live
  service below the reference's 1e-4 gate.

``05 --mesh`` runs in ``tests/test_torch_parallel_train.py``'s 4-rank group.
"""

import contextlib
import importlib
import importlib.util
import io
import json
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

REPO = Path(__file__).resolve().parents[1]
BUILD = ["--grid", "8", "--nlat", "32", "--nlon", "64", "--days", "12", "--remap", "bilinear"]
TRAIN = ["--epochs", "1", "--batch", "4", "--filters", "4", "--workers", "0"]
FORECAST = ["--days", "1", "--inits", "2"]
SEQUENCE = ["--sequence", "2", "--steps", "4", "--batch", "4", "--filters", "4"]
SERVE = ["--selftest", "--steps", "2"]
ENSEMBLE = ["--members", "4", "--steps", "2"]
NAMES = ("01_build_dataset", "02_train", "03_forecast", "04_evaluate", "05_sequence_train",
         "06_serve", "07_ensemble_export")


def port(name):
    return importlib.import_module(f"dlwp_cs_tpu_torch.examples.{name}")


def _reference(name):
    spec = importlib.util.spec_from_file_location(f"reference_example_{name[:2]}",
                                                  REPO / "examples" / f"{name}.py")
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _recording(record, key, fn):
    def wrapped(*args, **kwargs):
        out = fn(*args, **kwargs)
        record.setdefault(key, []).append(out)
        return out

    return wrapped


def _run(main, argv):
    """``main(argv)``'s exit code and standard output."""
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        rc = main(argv)
    return rc, out.getvalue()


@pytest.fixture(scope="module")
def ref(tmp_path_factory):
    """The reference's chain: its workdir, stdout per script and what the
    wrapped functions returned."""
    wd = tmp_path_factory.mktemp("reference")
    rec, out = {"workdir": wd}, {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPLBACKEND", "Agg")

        def run(name, args, wrap=()):
            mod = _reference(name)
            for attr in wrap:
                setattr(mod, attr, _recording(rec, attr, getattr(mod, attr)))
            if name == "05_sequence_train":
                make, init = mod.make_sequence_train_step, mod.init_state

                def init_recording(params, opt):
                    # a host copy: the train step donates the parameters' buffers
                    rec["init_params"] = jax_to_numpy(params)
                    return init(params, opt)

                mod.init_state = init_recording

                def make_recording(*a, **k):
                    step = make(*a, **k)

                    def recorded(*sa):
                        state, m = step(*sa)
                        rec.setdefault("step_losses", []).append(float(m["loss"]))
                        return state, m

                    return recorded

                mod.make_sequence_train_step = make_recording
            mp.setattr(sys, "argv", [name, "--workdir", str(wd), *args])
            buf = io.StringIO()
            with contextlib.redirect_stdout(buf):
                assert mod.main() == 0, name
            out[name] = buf.getvalue()

        run("01_build_dataset", BUILD)
        run("02_train", TRAIN)
        run("03_forecast", FORECAST)
        run("04_evaluate", [], wrap=("forecast_error", "persistence_error", "climo_error",
                                     "acc_curve"))
        run("05_sequence_train", SEQUENCE)
        run("06_serve", SERVE, wrap=("forecast_request",))
        run("07_ensemble_export", ENSEMBLE, wrap=("crps_ensemble", "spread_error"))
    rec["stdout"] = out
    return rec


@pytest.fixture(scope="module")
def chain(tmp_path_factory):
    """The port's chain through each example's ``main``, ``--device cpu``
    (04 takes no ``--device``): its workdir and each run's stdout."""
    wd = tmp_path_factory.mktemp("port")
    out = {}
    with pytest.MonkeyPatch.context() as mp:
        mp.setenv("MPLBACKEND", "Agg")
        for key, name, args in (
            ("01", "01_build_dataset", BUILD), ("02", "02_train", TRAIN),
            ("03", "03_forecast", FORECAST), ("04", "04_evaluate", []),
            ("05", "05_sequence_train", SEQUENCE), ("06", "06_serve", SERVE),
            ("07", "07_ensemble_export", ENSEMBLE),
            ("06 --artifact", "06_serve", ["--selftest", "--artifact"]),
        ):
            device = [] if name == "04_evaluate" else ["--device", "cpu"]
            rc, text = _run(port(name).main, ["--workdir", str(wd), *args, *device])
            assert rc == 0, (key, text)
            out[key] = text
    return wd, out


@pytest.fixture(scope="module")
def ref_store(ref):
    """The reference's store, read by the port."""
    from dlwp_cs_tpu_torch.data import open_store

    return open_store(ref["workdir"] / "predictors_cs.h5").load()


@pytest.fixture(scope="module")
def est(ref):
    """The port's estimator with the reference's trained parameters and
    stats (``load_jax_params``), on the CPU."""
    from dlwp_cs_tpu.estimator import DLWPEstimator as JEstimator
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator
    from dlwp_cs_tpu_torch.models.config import ExperimentConfig
    from dlwp_cs_tpu_torch.utils import load_json

    model_dir = ref["workdir"] / "model"
    jest = JEstimator.load(model_dir)
    tree = {"params": jax_to_numpy(jest.state.params["params"])}
    cfg = ExperimentConfig.from_json(load_json(model_dir / "experiment.json"))
    return DLWPEstimator(cfg, device="cpu").load_state(load_json(model_dir / "stats.json"),
                                                      params=tree)


def jax_to_numpy(tree):
    if isinstance(tree, dict):
        return {k: jax_to_numpy(v) for k, v in tree.items()}
    return np.asarray(tree)


def _std(store):
    return np.asarray(store.std, np.float32)


# ---- 01 ----------------------------------------------------------------------

def test_01_store_matches_reference(ref, chain):
    """The same arguments give the same store: the port's HDF5 file read by
    the reference's ``open_store``."""
    from dlwp_cs_tpu.data import open_store as j_open_store

    theirs = j_open_store(ref["workdir"] / "predictors_cs.h5").load()
    ours = j_open_store(chain[0] / "predictors_cs.h5").load()
    assert ours.variables == theirs.variables
    assert ours.constant_names == theirs.constant_names
    np.testing.assert_array_equal(ours.times, theirs.times)
    scale = np.abs(theirs.fields).max(axis=(0, 1, 2, 3))
    assert np.all(np.abs(ours.fields - theirs.fields).max(axis=(0, 1, 2, 3)) <= 1e-5 * scale)
    np.testing.assert_allclose(ours.mean, theirs.mean, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.std, theirs.std, rtol=1e-6, atol=0)
    np.testing.assert_allclose(ours.constants, theirs.constants, rtol=0, atol=1e-5)
    assert "wrote" in chain[1]["01"] and str(ours.fields.shape) in chain[1]["01"]


def test_01_conservative_weights_take_the_grid_kind_from_lats(tmp_path):
    """``build_store`` on a grid with points on the poles (ERA5's kind) uses
    the generator's ``lat_centered=False`` weights, on a cell-centred one
    the default ones: the store equals the ``Preprocessor``'s with them."""
    from dlwp_cs_tpu_torch.data import Preprocessor
    from dlwp_cs_tpu_torch.remap import conservative_weights

    ex = port("01_build_dataset")
    for n_lat, centred in ((18, True), (19, False)):
        src = ex.synthetic_sources(n_lat, 36, 1.0, 6.0, cell_centered=centred)
        got = ex.build_store(*src, grid=6, remap="conservative", cache_dir=tmp_path,
                             device="cpu")
        sources, constants, lats, lons, times = src
        w = conservative_weights("ll2cs", n_lat=n_lat, n_lon=36, n_cs=6,
                                 lat_centered=centred, cache_dir=tmp_path)
        want = Preprocessor(sources, lats, lons, times).data_to_series(
            6, weights=w, constant_sources=constants, device="cpu")
        np.testing.assert_array_equal(got.fields, want.fields)
        np.testing.assert_array_equal(got.constants, want.constants)


def test_01_synthetic_sources_are_the_reference_function():
    """The analytic sources, bitwise; ``cell_centered=False`` is the grid
    with its poles."""
    from dlwp_cs_tpu_torch.remap import latlon_grid

    ref_mod = _reference("01_build_dataset")
    ours = port("01_build_dataset").synthetic_sources(9, 16, 3.0, 6.0)
    theirs = ref_mod.synthetic_sources(9, 16, 3.0, 6.0)
    for a, b in zip(ours, theirs):
        if isinstance(a, dict):
            assert a.keys() == b.keys()
            for k in a:
                np.testing.assert_array_equal(a[k], b[k])
        else:
            np.testing.assert_array_equal(a, b)
    lats = port("01_build_dataset").synthetic_sources(9, 16, 1.0, 6.0, cell_centered=False)[2]
    np.testing.assert_array_equal(lats, latlon_grid(9, 16, cell_centered=False)[0])
    assert lats[0] == pytest.approx(-np.pi / 2) and lats[-1] == pytest.approx(np.pi / 2)


# ---- 02 ----------------------------------------------------------------------

def test_02_model_files_match_reference(ref, chain):
    """``experiment.json`` and ``stats.json`` hold the reference's keys and
    values; the directory loads into ``DLWPEstimator.load``."""
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator
    from dlwp_cs_tpu_torch.utils import load_json

    ours_dir, theirs_dir = chain[0] / "model", ref["workdir"] / "model"
    assert json.loads(load_json(ours_dir / "experiment.json")) == json.loads(
        load_json(theirs_dir / "experiment.json"))
    ours, theirs = (load_json(d / "stats.json") for d in (ours_dir, theirs_dir))
    assert ours.keys() == theirs.keys()
    for k in theirs:
        np.testing.assert_allclose(ours[k], theirs[k], rtol=1e-6, atol=0, err_msg=k)
    est = DLWPEstimator.load(ours_dir, device="cpu")
    assert est.config.model.filters == (4,) and est.stats["insol_std"] == ours["insol_std"]
    assert int(est.state.step) > 0
    assert "saved model to" in chain[1]["02"]
    kinds = {json.loads(line)["kind"]
             for line in (chain[0] / "metrics.jsonl").read_text().splitlines()}
    assert kinds == {"step", "epoch"}


def test_02_convlstm_trains_and_loads(ref_store, tmp_path):
    """``--model convlstm``: the recurrent family trains, saves and loads."""
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator

    ex = port("02_train")
    cfg = ex.experiment_config(ref_store, model="convlstm", filters=(4, 4), batch=4, epochs=1)
    trainer, state, stats = ex.train(ref_store, cfg, workers=0, device="cpu", verbose=False)
    ex.save_model(tmp_path / "model", state, cfg, stats)
    est = DLWPEstimator.load(tmp_path / "model", device="cpu")
    assert type(est.config.model).__name__ == "ConvLSTMConfig"
    assert len(trainer.history.steps) == int(state.step) > 0
    assert all(np.isfinite(r["loss"]) for r in trainer.history.steps)


# ---- 03 ----------------------------------------------------------------------

def test_03_forecast_matches_reference(ref, ref_store, est):
    """The reference's trained parameters in the port give its
    ``forecast.npz``."""
    theirs = np.load(ref["workdir"] / "forecast.npz", allow_pickle=True)
    ours = port("03_forecast").forecast_from_tail(est, ref_store, days=1, inits=2)
    assert ours["fields"].shape == theirs["fields"].shape
    assert np.all(np.abs(ours["fields"] - theirs["fields"]).max(axis=(0, 1, 2, 3, 4))
                  <= 1e-5 * _std(ref_store))
    np.testing.assert_array_equal(ours["lead_hours"], theirs["lead_hours"])
    np.testing.assert_array_equal(ours["init_times"], theirs["init_times"])
    assert list(ours["variables"]) == list(theirs["variables"])


def test_03_npz_round_trip(chain):
    fz = np.load(chain[0] / "forecast.npz", allow_pickle=True)
    assert fz["fields"].shape[:2] == (2, 4) and np.isfinite(fz["fields"]).all()
    np.testing.assert_array_equal(fz["lead_hours"], [6.0, 12.0, 18.0, 24.0])
    assert "(B, leads, 6, n, n, C)" in chain[1]["03"]


def test_03_store_too_short_exits(ref_store, est):
    with pytest.raises(SystemExit, match="store too short"):
        port("03_forecast").forecast_from_tail(est, ref_store, days=60, inits=2)


# ---- 04 ----------------------------------------------------------------------

def test_04_scores_match_reference(ref, ref_store):
    """The reference's ``forecast.npz`` and store give its table."""
    fz = np.load(ref["workdir"] / "forecast.npz", allow_pickle=True)
    ex = port("04_evaluate")
    ours = ex.score(fz["fields"], fz["lead_hours"], fz["init_times"], ref_store)
    for key, name in (("rmse", "forecast_error"), ("persistence", "persistence_error"),
                      ("climatology", "climo_error"), ("acc", "acc_curve")):
        np.testing.assert_allclose(ours[key], np.asarray(ref[name][0]), rtol=1e-5, atol=0,
                                   err_msg=key)
    table = ex.format_table(ours, 0)
    theirs = ref["stdout"]["04_evaluate"].strip().splitlines()
    assert table.splitlines()[0] == theirs[0] and len(table.splitlines()) == len(theirs)


def test_04_writes_the_reference_figures(chain):
    assert (chain[0] / "rmse_curves.png").stat().st_size > 0
    assert (chain[0] / "forecast_map.png").stat().st_size > 0
    assert chain[1]["04"].startswith("lead(h)  RMSE(model)")


# ---- 05 ----------------------------------------------------------------------

def test_05_sequence_losses_match_reference(ref, ref_store):
    """Four sequence steps from the reference's ``PRNGKey(0)`` parameters
    over the same batches."""
    from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, UNetConfig, load_jax_params
    from dlwp_cs_tpu_torch.train import params_of

    tree = ref["init_params"]
    dcfg = DataConfig(grid_n=ref_store.grid_n, variables=ref_store.variables,
                      constants=ref_store.constant_names)
    model = CubeSphereUNet(UNetConfig(output_channels=dcfg.output_channels, filters=(4,)),
                           dcfg.input_channels, device="cpu")
    params = params_of(load_jax_params(model, tree))
    out = port("05_sequence_train").sequence_train(
        ref_store, sequence=2, steps=4, batch=4, filters=(4,), params=params, device="cpu")
    assert len(ref["step_losses"]) == 4
    np.testing.assert_allclose(out["losses"], ref["step_losses"], rtol=1e-5, atol=0)


def test_05_cli_output(chain):
    assert "final sequence loss (mean of last 20):" in chain[1]["05"]
    assert port("05_sequence_train").parse_mesh("2X4") == (2, 4)


# ---- 06 ----------------------------------------------------------------------

def test_06_selftest_matches_reference_service(ref, ref_store, est):
    """The self-test's three HTTP answers against the reference's on the
    same windows."""
    ex = port("06_serve")
    svc = ex.live_service(est, ref_store)
    try:
        got = ex.selftest(svc, ref_store, steps=2, log=lambda *a: None)
    finally:
        svc.close()
    assert got["ok"] and got["stats"].requests == 3
    theirs = ref["forecast_request"]
    assert len(theirs) == 3
    tol = 1e-5 * _std(ref_store)
    for fields, lead, init in theirs:
        i = int(np.flatnonzero(np.asarray(ref_store.times) == init[0])[0])
        ours = got["results"][i]
        assert np.all(np.abs(ours[0] - fields).max(axis=(0, 1, 2, 3, 4)) <= tol)
        np.testing.assert_array_equal(ours[1], lead)
        np.testing.assert_array_equal(ours[2], init)


@pytest.mark.parametrize("key", ["06", "06 --artifact"])
def test_06_cli_selftest(chain, key):
    text = chain[1][key]
    assert "selftest ok" in text and "requests=3" in text


# ---- 07 ----------------------------------------------------------------------

def test_07_scores_match_reference_with_its_perturbations(ref, ref_store, est):
    """CRPS, the ensemble mean's RMSE and the spread per lead, with the
    reference's ``PRNGKey(0)`` perturbations handed in."""
    import jax

    from dlwp_cs_tpu.rollout import ic_perturbations

    ex = port("07_ensemble_export")
    svc = port("06_serve").live_service(est, ref_store)
    n_lead = 2 * est.config.data.output_time_steps
    _, window, _ = ex.last_window(ref_store, input_time_steps=2, n_lead=n_lead)
    pert = np.array(ic_perturbations(jax.random.PRNGKey(0), (1,) + window.shape, 4))
    got = ex.ensemble_scores(svc, ref_store, steps=2, members=4, perturbations=pert,
                             device="cpu", log=lambda *a: None)
    svc.close()
    crps = np.asarray(ref["crps_ensemble"][0]).mean(axis=(0, 2, 3, 4, 5))
    rmse, spread = (np.asarray(v) for v in ref["spread_error"][0])
    tol = 1e-5 * float(_std(ref_store).max())
    for name, theirs in (("crps", crps), ("rmse", rmse), ("spread", spread)):
        np.testing.assert_allclose(got[name], theirs, rtol=0, atol=tol, err_msg=name)


def test_07_cli_output(chain):
    """The chain's 07 passed its gate: the exported artifact within 1e-4 of
    the live service (on the CPU, equal)."""
    text = chain[1]["07"]
    assert "ensemble+export ok" in text and "crps=" in text
    assert "exported vs live maxdiff 0.00e+00" in text
    assert (chain[0] / "rollout_artifact" / "meta.json").exists()


# ---- the command line --------------------------------------------------------

def test_example_runs_as_a_module(chain):
    """``python -m dlwp_cs_tpu_torch.examples.03_forecast`` in a fresh
    process."""
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run(
        [sys.executable, "-m", "dlwp_cs_tpu_torch.examples.03_forecast", "--workdir",
         str(chain[0]), *FORECAST, "--device", "cpu"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert "forecast: (2, 4, 6, 8, 8, 4)" in out.stdout


@pytest.mark.parametrize("name", NAMES)
def test_example_without_a_gpu_raises(name, request, monkeypatch, tmp_path):
    """No ``--device`` and no GPU: ``resolve_device``'s error, before any
    work.  04 puts nothing on a device and takes no ``--device``: it scores
    the chain's forecast on a machine without a GPU, as the reference's
    does."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    if name == "04_evaluate":
        chain = request.getfixturevalue("chain")
        monkeypatch.setenv("MPLBACKEND", "Agg")
        rc, text = _run(port(name).main, ["--workdir", str(chain[0])])
        assert rc == 0 and text == chain[1]["04"]
        return
    with pytest.raises(RuntimeError, match="device='cpu'"):
        port(name).main(["--workdir", str(tmp_path)])
    assert not (tmp_path / "predictors_cs.h5").exists()
