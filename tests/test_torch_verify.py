"""The port's ``verify/`` (and ``utils/misc.py``) against the JAX package's.

Every function gets the same numpy-seeded inputs in both packages; the
port's takes torch tensors too.  Tolerance 1e-6 relative (of the largest
entry where a float32 sum can cancel: CRPS, spread), exact where the code
is the same numpy (metrics, alignment, relabeling) or counts (rank
histogram).  The reference mount is empty, so the oracle reads golden npz
files this test writes: one fabricated with the JAX package's ops and one
with the port's, each in a scrambled face convention, and both packages'
``compare_to_golden`` run on each.
"""

import datetime as dt

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_cs_tpu import verify as jverify
from dlwp_cs_tpu.utils import misc as jmisc
from dlwp_cs_tpu_torch import verify
from dlwp_cs_tpu_torch.data import MemoryStore
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.padding import cs_pad
from dlwp_cs_tpu_torch.utils import misc
from dlwp_cs_tpu_torch.verify.oracle import our_lonlat
from dlwp_cs_tpu_torch.verify.relabel import D4_ELEMENTS
from tests.test_oracle import SCRAMBLE, _fake_golden, _smooth_field

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8


def _fields(seed=0, b=3, lead=4, c=2):
    rng = np.random.default_rng(seed)
    f = rng.normal(size=(b, lead, 6, N, N, c)).astype(np.float32)
    t = (f + 0.3 * rng.normal(size=f.shape)).astype(np.float32)
    return f, t


def _same(ours, ref, rel=None):
    ours = ours.cpu().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(ref)
    assert ours.shape == ref.shape
    if rel is None:
        np.testing.assert_array_equal(ours, ref)
    else:
        np.testing.assert_allclose(ours, ref, rtol=rel, atol=rel * float(np.abs(ref).max()))


# ---- metrics ---------------------------------------------------------------

@pytest.mark.parametrize("method", ["rmse", "mse", "mae"])
@pytest.mark.parametrize("weighted", [False, True])
@pytest.mark.parametrize("keep", [False, True])
def test_forecast_error_matches_reference(method, weighted, keep):
    f, t = _fields()
    w = CubedSphere(N).area_weights if weighted else None
    ref = jverify.forecast_error(f, t, method, weights=w, keep_channels=keep)
    _same(verify.forecast_error(f, t, method, weights=w, keep_channels=keep), ref)
    _same(verify.forecast_error(torch.from_numpy(f), torch.from_numpy(t), method,
                                weights=None if w is None else torch.from_numpy(w),
                                keep_channels=keep), ref)
    with pytest.raises(ValueError, match="method"):
        verify.forecast_error(f, t, "bias")


def test_baseline_errors_and_acc_match_reference():
    f, t = _fields(1)
    w = CubedSphere(N).area_weights
    init = f[:, 0]
    clim = t.mean(axis=(0, 1))
    monthly = np.random.default_rng(2).normal(size=(12, 6, N, N, 2)).astype(np.float32)
    months = np.random.default_rng(3).integers(0, 12, size=t.shape[:2])
    pairs = [
        (verify.persistence_error(torch.from_numpy(init), t, weights=w),
         jverify.persistence_error(init, t, weights=w)),
        (verify.climo_error(clim, torch.from_numpy(t), "mae", keep_channels=True),
         jverify.climo_error(clim, t, "mae", keep_channels=True)),
        (verify.monthly_climo_error(monthly, t, torch.from_numpy(months), weights=w),
         jverify.monthly_climo_error(monthly, t, months, weights=w)),
        (verify.acc_curve(torch.from_numpy(f), t, clim, weights=w),
         jverify.acc_curve(f, t, clim, weights=w)),
        (verify.acc_curve(f, t, clim, keep_channels=True),
         jverify.acc_curve(f, t, clim, keep_channels=True)),
    ]
    for ours, ref in pairs:
        _same(ours, ref)


# ---- ensemble scores ---------------------------------------------------------

@pytest.mark.parametrize("m", [1, 2, 5])
@pytest.mark.parametrize("fair", [True, False])
def test_crps_matches_reference(m, fair):
    rng = np.random.default_rng(m)
    mem = rng.normal(size=(2, m, 3, 6, N, N, 2)).astype(np.float32)
    truth = rng.normal(size=(2, 3, 6, N, N, 2)).astype(np.float32)
    ref = jverify.crps_ensemble(jnp.asarray(mem), jnp.asarray(truth), fair=fair)
    _same(verify.crps_ensemble(torch.from_numpy(mem), torch.from_numpy(truth), fair=fair,
                               device="cpu"),
          ref, rel=1e-6)
    moved = np.moveaxis(mem, 1, -1)
    _same(verify.crps_ensemble(moved, truth, member_axis=-1, fair=fair, device="cpu"), ref,
          rel=1e-6)


def test_spread_error_and_rank_histogram_match_reference():
    rng = np.random.default_rng(7)
    mem = rng.normal(size=(2, 4, 3, 6, N, N, 2)).astype(np.float32)
    truth = rng.normal(size=(2, 3, 6, N, N, 2)).astype(np.float32)
    for kw in ({}, {"lead_axis": 0}):
        ref = jverify.spread_error(jnp.asarray(mem), jnp.asarray(truth), **kw)
        ours = verify.spread_error(torch.from_numpy(mem), torch.from_numpy(truth), device="cpu",
                                   **kw)
        for a, r in zip(ours, ref):
            _same(a, r, rel=1e-6)
    with pytest.raises(ValueError, match="2 members"):
        verify.spread_error(mem[:, :1], truth, device="cpu")
    with pytest.raises(ValueError, match="lead_axis"):
        verify.spread_error(np.moveaxis(mem, 1, -1), truth, member_axis=-1, device="cpu")
    with pytest.raises(ValueError, match="truth shape"):
        verify.crps_ensemble(mem, truth[:1], device="cpu")
    truth[0, 0, 0, 0, 0] = mem[0, 2, 0, 0, 0, 0]  # a tie counts as above
    _same(verify.rank_histogram(torch.from_numpy(mem), torch.from_numpy(truth), device="cpu"),
          jverify.rank_histogram(jnp.asarray(mem), jnp.asarray(truth)))


# ---- alignment, time conversions ---------------------------------------------

def test_align_truth_matches_reference():
    rng = np.random.default_rng(5)
    times = 9000.0 + 0.25 * np.arange(20)
    store = MemoryStore.from_raw(rng.normal(size=(20, 6, N, N, 2)).astype(np.float32), times,
                                 ("a", "b"))
    init = times[[2, 10, 15]]
    leads = np.asarray([6.0, 12.0, 24.0, 48.0])
    ours, ref = verify.align_truth(store, init, leads), jverify.align_truth(store, init, leads)
    assert set(ours) == set(ref)
    for k in ref:
        _same(ours[k], ref[k])
    assert not ours["kept"].all()  # the last init's 48 h lead leaves the store
    for bad in (np.asarray([9000.1]), np.asarray([8000.0])):
        with pytest.raises(ValueError):
            verify.align_truth(store, bad, leads)
    with pytest.raises(ValueError, match="between store samples"):
        verify.align_truth(store, init[:1], np.asarray([3.0]))


def test_time_conversions_match_reference():
    days = np.asarray([0.0, 9668.5, 12000.125])
    assert misc.days_to_datetime(days) == jmisc.days_to_datetime(days)
    assert misc.days_to_datetime(9668.5) == jmisc.days_to_datetime(9668.5)
    dates = [dt.datetime(2026, 6, 21, 12), dt.datetime(2000, 1, 1, tzinfo=dt.timezone.utc)]
    np.testing.assert_array_equal(misc.datetime_to_days(dates), jmisc.datetime_to_days(dates))
    assert misc.datetime_to_days(dates[0]) == jmisc.datetime_to_days(dates[0]) == 9668.5


# ---- relabeling and the oracle -------------------------------------------------

@pytest.mark.parametrize("seed", [0, 1])
def test_relabeling_matches_reference(seed):
    rng = np.random.default_rng(seed)
    perm = tuple(rng.permutation(6).tolist())
    orient = tuple(D4_ELEMENTS[i] for i in rng.integers(0, 8, size=6))
    ours = verify.FaceRelabeling(perm=perm, orient=orient)
    ref = jverify.FaceRelabeling(perm=perm, orient=orient)
    assert verify.FaceRelabeling.from_json(ref.to_json()) == ours
    x = rng.normal(size=(2, 6, N, N, 3))
    _same(verify.apply_relabeling(x, ours), jverify.apply_relabeling(x, ref))
    inv = verify.invert_relabeling(ours)
    assert (inv.perm, inv.orient) == tuple(
        getattr(jverify.invert_relabeling(ref), k) for k in ("perm", "orient"))
    field = _smooth_field(seed=seed)
    theirs = verify.apply_relabeling(field, ours)
    got = verify.infer_relabeling(field, theirs)
    want = jverify.infer_relabeling(field, theirs)
    assert (got.perm, got.orient) == (want.perm, want.orient) == (perm, orient)
    with pytest.raises(ValueError, match="ambiguous|degenerate"):
        verify.infer_relabeling(np.ones((6, N, N)), np.ones((6, N, N)))


def _torch_golden(tmp_path, scramble=SCRAMBLE):
    """A golden npz in the ``scramble`` convention made with the port's ops
    (D4-symmetric kernels, so the conv does not depend on orientation)."""
    rng = np.random.default_rng(8)
    x = rng.normal(size=(2, 6, N, N, 3)).astype(np.float32)
    ks = []
    for _ in range(2):
        k = rng.normal(size=(3, 3, 3, 4)).astype(np.float32) * 0.2
        ks.append(sum(np.swapaxes(np.rot90(k, kk, axes=(0, 1)), 0, 1) if flip
                      else np.rot90(k, kk, axes=(0, 1)) for kk, flip in D4_ELEMENTS) / 8)
    bs = [rng.normal(size=(4,)).astype(np.float32) for _ in range(2)]
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a, np.float32))  # noqa: E731
    pad_out = cs_pad(t(x), 1).numpy()
    conv_out = cs_conv(t(x), t(ks[0]), t(ks[1]), bias_eq=t(bs[0]), bias_pole=t(bs[1]),
                       backend="xla").numpy()
    path = tmp_path / "golden_torch.npz"
    rel = verify.apply_relabeling
    np.savez(path, lonlat=rel(our_lonlat(N), scramble), pad_in=rel(x, scramble),
             pad_out=rel(pad_out, scramble), pad_width=np.int64(1), conv_in=rel(x, scramble),
             conv_kernel_eq=ks[0], conv_kernel_pole=ks[1], conv_bias_eq=bs[0],
             conv_bias_pole=bs[1], conv_out=rel(conv_out, scramble))
    return path


@pytest.mark.parametrize("maker", ["jax", "jax_generic", "torch"])
def test_oracle_matches_reference(tmp_path, maker):
    """Both packages' oracles on golden files fabricated by the JAX
    package (D4-symmetric and generic kernels) and by the port: the same
    recovered convention and errors within float32 rounding of each
    other, and both report a corrupted conv output."""
    if maker == "torch":
        path = _torch_golden(tmp_path)
    else:
        path = _fake_golden(tmp_path, d4_symmetric_kernels=maker == "jax")
    ours, ref = verify.compare_to_golden(path, device="cpu"), jverify.compare_to_golden(path)
    assert (ours.relabeling.perm, ours.relabeling.orient) == (
        ref.relabeling.perm, ref.relabeling.orient) == (SCRAMBLE.perm, SCRAMBLE.orient)
    assert ours.lonlat_err_deg < 1e-10 and abs(ours.lonlat_err_deg - ref.lonlat_err_deg) < 1e-9
    assert ours.pad_err < 1e-6 and ref.pad_err < 1e-6
    assert ours.conv_err < 1e-5 and ref.conv_err < 1e-5
    assert ours.ok() and ref.ok()
    with np.load(path) as z:
        bad = {k: z[k] for k in z.files}
    bad["conv_out"] = bad["conv_out"] + 0.1
    del bad["pad_in"], bad["pad_out"], bad["pad_width"]
    np.savez(tmp_path / "bad.npz", **bad)
    ours = verify.compare_to_golden(tmp_path / "bad.npz", device="cpu")
    ref = jverify.compare_to_golden(tmp_path / "bad.npz")
    assert ours.pad_err is None and not ours.ok() and not ref.ok()
    assert abs(ours.conv_err - ref.conv_err) < 1e-5


def test_oracle_refuses_a_pole_axis_change(tmp_path):
    poleswap = verify.FaceRelabeling(perm=(4, 1, 2, 3, 0, 5), orient=((0, False),) * 6)
    path = _torch_golden(tmp_path, poleswap)
    with pytest.raises(ValueError, match="different pole axes"):
        verify.compare_to_golden(path, device="cpu")
    with pytest.raises(ValueError, match="different pole axes"):
        jverify.compare_to_golden(path)


def test_verify_entry_points_go_to_the_gpu_unless_told(tmp_path, monkeypatch):
    """With no device named the scores and the oracle go to the GPU, and
    with none present they raise instead of running on the CPU."""
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    mem = np.zeros((1, 2, 1, 6, N, N, 1), np.float32)
    truth = np.zeros((1, 1, 6, N, N, 1), np.float32)
    for score in (verify.crps_ensemble, verify.spread_error, verify.rank_histogram):
        with pytest.raises(RuntimeError, match="no CUDA device"):
            score(mem, truth)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        verify.compare_to_golden(_torch_golden(tmp_path))
