"""The port's remap (``dlwp_cs_tpu_torch.remap``) and the chart inverses of
its geometry against the JAX package's.

The same inputs, made from numpy seeds, go to both packages.  Tolerances:

* the chart inverses, the bilinear weights and the conservative weights
  are the same numpy code (or the same C++ source and flags) in both, so
  they must be bitwise equal; the reference's generator is built by its own
  ``make`` in a copy of ``tools/csremap`` under ``tmp_path``, the port's by
  ``build_csremap`` into ``dlwp_cs_tpu_torch/_build``;
* ``apply_remap`` on the CPU against ``dlwp_cs_tpu.remap.apply_remap``
  (a gather and a ``segment_sum``): float32 and integer fields (promoted
  to float32) 1e-6 of the largest |x| (float32 sums of one row's nonzeros,
  in the same order); bfloat16 one bfloat16 rounding of the largest |x|
  (2**-8), since the two libraries need not round the partial sums alike
  (measured: 0 in all three);
* against ``RemapWeights.apply_numpy`` (``np.add.at`` in nonzero order):
  bitwise in float32 and float64, the same sums in the same order.
"""

import os
import shutil

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_cs_tpu.geometry import cubed_sphere as jgeo
from dlwp_cs_tpu.remap import apply as japply
from dlwp_cs_tpu.remap import native as jnative
from dlwp_cs_tpu.remap import weights as jweights
from dlwp_cs_tpu_torch.geometry import cubed_sphere as tgeo
from dlwp_cs_tpu_torch.remap import (
    RemapWeights,
    apply_remap,
    build_csremap,
    conservative_weights,
    cs_to_ll_weights,
    from_faces,
    latlon_grid,
    ll_to_cs_weights,
    load_csremap,
    remap_cs_to_ll,
    remap_ll_to_cs,
    to_faces,
)
from dlwp_cs_tpu_torch.remap import native as tnative
from dlwp_cs_tpu_torch.remap import weights as tweights

REPO_TOOL = tnative._SOURCE.parent

pytestmark = pytest.mark.skipif(shutil.which(os.environ.get("CXX", "g++")) is None,
                                reason="no C++ compiler for the weight generator")


def _sphere_points(seed=0, n=2000):
    rng = np.random.default_rng(seed)
    p = rng.normal(size=(n, 3))
    # every edge and corner of the cube (ties between faces), unnormalized
    s = [-1.0, 0.0, 1.0]
    ties = np.array([(a, b, c) for a in s for b in s for c in s
                     if sorted(map(abs, (a, b, c))).count(1.0) >= 2], np.float64)
    return np.concatenate([p, ties, 3.5 * ties])


def test_chart_inverse_and_tie_break_match_reference():
    p = _sphere_points()
    ours = tgeo.xyz_to_face_angles(p)
    ref = jgeo.xyz_to_face_angles(p)
    for a, b in zip(ours, ref):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_array_equal(tgeo.xyz_to_face(p), jgeo.xyz_to_face(p))
    # a corner touches three faces: it goes to the lowest index
    assert tgeo.xyz_to_face(np.array([1.0, 1.0, 1.0])) == 0
    assert tgeo.xyz_to_face(np.array([-1.0, 1.0, -1.0])) == 1
    assert tgeo.xyz_to_face(np.array([-1.0, -1.0, 1.0])) == 2
    # round trip through each face's chart
    rng = np.random.default_rng(1)
    for f in range(6):
        xi, eta = rng.uniform(-0.99, 0.99, size=(2, 500))
        face, a, b = tgeo.xyz_to_face_angles(tgeo.face_xyz(f, xi, eta) * 2.0)
        assert np.all(face == f)
        np.testing.assert_allclose(np.tan(a), xi, atol=1e-14)
        np.testing.assert_allclose(np.tan(b), eta, atol=1e-14)
        for g in range(6):
            np.testing.assert_array_equal(
                tgeo._face_local_exact(g, tgeo.face_xyz(f, xi, eta)),
                jgeo._face_local_exact(g, jgeo.face_xyz(f, xi, eta)))
    with pytest.raises(ValueError, match="face"):
        tgeo._face_local_exact(6, p)


@pytest.mark.parametrize("n,h,w,centered", [(6, 19, 36, True), (8, 12, 24, False),
                                            (12, 18, 36, True), (5, 7, 10, False)])
def test_bilinear_weights_match_reference(n, h, w, centered):
    lats, lons = latlon_grid(h, w, cell_centered=centered)
    jl, jo = jweights.latlon_grid(h, w, cell_centered=centered)
    np.testing.assert_array_equal(lats, jl)
    np.testing.assert_array_equal(lons, jo)
    for ours, ref in (
        (ll_to_cs_weights(lats, lons, tgeo.CubedSphere(n)),
         jweights.ll_to_cs_weights(lats, lons, jgeo.CubedSphere(n))),
        (cs_to_ll_weights(tgeo.CubedSphere(n), lats, lons),
         jweights.cs_to_ll_weights(jgeo.CubedSphere(n), lats, lons)),
    ):
        assert ours.shape == ref.shape
        for k in ("rows", "cols", "vals"):
            a, b = getattr(ours, k), getattr(ref, k)
            assert a.dtype == b.dtype
            np.testing.assert_array_equal(a, b)
        np.testing.assert_array_equal(ours.row_sums(), ref.row_sums())
        x = np.random.default_rng(n).normal(size=(2, ours.shape[1])).astype(np.float32)
        np.testing.assert_array_equal(ours.apply_numpy(x), ref.apply_numpy(x))


def test_bilinear_1d_matches_reference_and_refuses_a_descending_axis():
    rng = np.random.default_rng(3)
    grid = np.sort(rng.uniform(0, 2 * np.pi, 17))
    x = rng.uniform(-7, 14, 300)
    for periodic in (True, False):
        for a, b in zip(tweights._bilinear_1d(grid, x, periodic=periodic),
                        jweights._bilinear_1d(grid, x, periodic=periodic)):
            np.testing.assert_array_equal(a, b)
    with pytest.raises(ValueError, match="ascending"):
        tweights._bilinear_1d(grid[::-1], x, periodic=False)
    lats, lons = latlon_grid(9, 18)
    with pytest.raises(ValueError, match="ascending"):
        ll_to_cs_weights(lats[::-1], lons, tgeo.CubedSphere(4))


def test_weights_save_load_cross_package(tmp_path):
    lats, lons = latlon_grid(12, 24)
    ours = ll_to_cs_weights(lats, lons, tgeo.CubedSphere(8))
    back = jweights.RemapWeights.load(ours.save(tmp_path / "a" / "w.npz"))
    ref = jweights.ll_to_cs_weights(lats, lons, jgeo.CubedSphere(8))
    again = RemapWeights.load(ref.save(tmp_path / "b.npz"))
    for w in (back, again):
        assert w.shape == ours.shape
        for k in ("rows", "cols", "vals"):
            np.testing.assert_array_equal(getattr(w, k), getattr(ours, k))


@pytest.fixture(scope="module")
def ref_tool(tmp_path_factory):
    """The reference's generator, built by its own ``make`` in a copy of
    ``tools/csremap`` (nothing is written into the repository's copy)."""
    d = tmp_path_factory.mktemp("csremap_ref")
    for name in ("Makefile", "csremap.cpp"):
        shutil.copy(REPO_TOOL / name, d / name)
    return d


def _ref_conservative(ref_tool, monkeypatch, **kw):
    monkeypatch.setattr(jnative, "_TOOL_DIR", ref_tool)
    return jnative.conservative_weights(**kw)


@pytest.mark.parametrize("mode", ["ll2cs", "cs2ll"])
@pytest.mark.parametrize("lat_centered,method", [(True, "exact"), (False, "exact"),
                                                 (True, "sampled")])
def test_conservative_weights_bitwise_equal_to_reference(ref_tool, monkeypatch, tmp_path,
                                                         mode, lat_centered, method):
    if shutil.which("make") is None:
        pytest.skip("the reference's build needs make")
    before = sorted(p.name for p in REPO_TOOL.iterdir())
    kw = dict(n_lat=19, n_lon=36, n_cs=6, lat_centered=lat_centered, method=method,
              samples=4, dtype=np.float64)
    ours = conservative_weights(mode, cache_dir=tmp_path / "ours", **kw)
    ref = _ref_conservative(ref_tool, monkeypatch, mode=mode, cache_dir=tmp_path / "ref",
                            **kw)
    assert ours.shape == ref.shape
    for k in ("rows", "cols", "vals"):
        np.testing.assert_array_equal(getattr(ours, k), getattr(ref, k))
    np.testing.assert_allclose(ours.row_sums(), 1.0, atol=1e-12)
    assert np.all(np.diff(ours.rows) >= 0)
    # the port built into its own _build/ and wrote nothing beside the source
    assert build_csremap().parent.parent == tnative._BUILD_ROOT
    assert sorted(p.name for p in REPO_TOOL.iterdir()) == before
    # published by a rename: no tmp file is left in the cache
    assert [p.name for p in (tmp_path / "ours").iterdir()] == [
        f"csremap_{mode}_19x36_c6_{'exact' if method == 'exact' else 's4'}_"
        f"{int(lat_centered)}.bin"]


def test_conservative_cache_regenerates_a_corrupt_entry_once(tmp_path):
    kw = dict(n_lat=10, n_lon=20, n_cs=4, cache_dir=tmp_path)
    good = conservative_weights("ll2cs", **kw)
    path = next(tmp_path.iterdir())
    for corrupt in (b"CSRM\x01", path.read_bytes()[:40], b"XXXX" + bytes(40)):
        path.write_bytes(corrupt)
        w = conservative_weights("ll2cs", **kw)
        np.testing.assert_array_equal(w.vals, good.vals)
    np.testing.assert_array_equal(load_csremap(path, dtype=np.float64).rows, good.rows)
    bad = tmp_path / "bad.bin"
    bad.write_bytes(b"NOPE" + bytes(20))
    with pytest.raises(ValueError, match="not a CSRM"):
        load_csremap(bad)
    with pytest.raises(ValueError, match="mode"):
        conservative_weights("ll2ll", **kw)


@pytest.fixture(scope="module")
def grids():
    """Bilinear ll->cs and cs->ll, and exact conservative ll->cs (rows of
    4 to a few dozen nonzeros), on small grids."""
    lats, lons = latlon_grid(19, 36)
    cs = tgeo.CubedSphere(6)
    return {"ll2cs": ll_to_cs_weights(lats, lons, cs),
            "cs2ll": cs_to_ll_weights(cs, lats, lons),
            "conservative": conservative_weights(
                "ll2cs", n_lat=19, n_lon=36, n_cs=6, lat_centered=False,
                cache_dir=None)}


@pytest.mark.parametrize("kind", ["ll2cs", "cs2ll", "conservative"])
@pytest.mark.parametrize("dtype", ["float32", "int32", "bool", "bfloat16"])
def test_apply_remap_matches_reference_on_cpu(grids, kind, dtype):
    w = grids[kind]
    rng = np.random.default_rng(5)
    raw = rng.normal(size=(2, 3, w.shape[1])) * 50.0
    if dtype == "int32":
        raw = np.round(raw).astype(np.int32)
    elif dtype == "bool":
        raw = raw > 0
    if dtype == "bfloat16":
        x = torch.from_numpy(raw.astype(np.float32)).bfloat16()
        jx = jnp.asarray(x.float().numpy(), jnp.bfloat16)
    else:
        x = torch.from_numpy(np.asarray(raw, np.float32) if dtype == "float32" else raw)
        jx = jnp.asarray(x.numpy())
    out = apply_remap(w, x)
    ref = np.asarray(japply.apply_remap(w, jx).astype(jnp.float32))
    want = {"bfloat16": torch.bfloat16}.get(dtype, torch.float32)
    assert out.dtype == want and out.shape == (2, 3, w.shape[0])
    scale = float(np.abs(np.asarray(raw, np.float64)).max())
    tol = 2.0**-8 if dtype == "bfloat16" else 1e-6
    np.testing.assert_allclose(out.float().numpy(), ref, rtol=0, atol=tol * scale)
    if dtype != "bfloat16":  # the plain version on the promoted field: the same sums
        np.testing.assert_array_equal(out.numpy(), w.apply_numpy(x.numpy().astype(np.float32)))


def test_apply_remap_float64_and_repeatability(grids):
    w = grids["conservative"]
    x = torch.from_numpy(np.random.default_rng(6).normal(size=(4, w.shape[1])))
    out = apply_remap(w, x)
    assert out.dtype == torch.float64
    w64 = RemapWeights(w.rows, w.cols, w.vals.astype(np.float64), w.shape)
    np.testing.assert_array_equal(out.numpy(), w64.apply_numpy(x.numpy()))
    np.testing.assert_array_equal(apply_remap(w, x).numpy(), out.numpy())
    # the device-side weights are memoised per (device, dtype)
    cache = w.__dict__["_device_cache"]
    held = cache[torch.device("cpu"), torch.float64][1]
    apply_remap(w, x)
    assert cache[torch.device("cpu"), torch.float64][1] is held


def test_nan_confined_to_the_rows_that_use_its_column(grids):
    w = grids["conservative"]
    x = np.random.default_rng(7).normal(size=(2, w.shape[1])).astype(np.float32)
    col = int(w.cols[len(w.cols) // 2])
    x[1, col] = np.nan
    out = apply_remap(w, torch.from_numpy(x)).numpy()
    users = np.zeros(w.shape[0], bool)
    users[w.rows[w.cols == col]] = True
    assert users.sum() >= 1 and not users.all()
    np.testing.assert_array_equal(np.isnan(out[1]), users)
    assert not np.isnan(out[0]).any()
    ref = np.asarray(japply.apply_remap(w, jnp.asarray(x)))
    np.testing.assert_array_equal(np.isnan(out), np.isnan(ref))


def test_unsorted_weights_are_sorted_stably(grids):
    w = grids["conservative"]
    # shuffle whole rows, keeping each row's nonzeros in their order
    perm_rows = np.random.default_rng(8).permutation(w.shape[0])
    order = np.concatenate([np.flatnonzero(w.rows == r) for r in perm_rows])
    shuffled = RemapWeights(w.rows[order], w.cols[order], w.vals[order], w.shape)
    x = torch.from_numpy(np.random.default_rng(9).normal(size=(3, w.shape[1]))
                         .astype(np.float32))
    np.testing.assert_array_equal(apply_remap(shuffled, x).numpy(), apply_remap(w, x).numpy())
    bad = RemapWeights(w.rows + 1, w.cols, w.vals, w.shape)
    with pytest.raises(ValueError, match="outside"):
        apply_remap(bad, x)
    with pytest.raises(ValueError, match="source dim"):
        apply_remap(w, x[:, :-1])


def test_shaped_wrappers_and_faces_match_reference(grids):
    fwd, inv = grids["ll2cs"], grids["cs2ll"]
    x = np.random.default_rng(10).normal(size=(2, 19, 36)).astype(np.float32)
    cube = remap_ll_to_cs(fwd, torch.from_numpy(x), 6)
    assert tuple(cube.shape) == (2, 6, 6, 6)
    np.testing.assert_allclose(cube.numpy(), np.asarray(japply.remap_ll_to_cs(
        fwd, jnp.asarray(x), 6)), rtol=0, atol=1e-6 * np.abs(x).max())
    back = remap_cs_to_ll(inv, cube, 19, 36)
    assert tuple(back.shape) == (2, 19, 36)
    np.testing.assert_allclose(back.numpy(), np.asarray(japply.remap_cs_to_ll(
        inv, jnp.asarray(cube.numpy()), 19, 36)), rtol=0, atol=1e-6 * np.abs(x).max())
    flat = torch.from_numpy(np.random.default_rng(11).normal(size=(4, 6 * 5 * 5))
                            .astype(np.float32))
    f = to_faces(flat, 5)
    assert tuple(f.shape) == (4, 6, 5, 5)
    np.testing.assert_array_equal(from_faces(f).numpy(), flat.numpy())
    np.testing.assert_array_equal(to_faces(flat.numpy(), 5),
                                  np.asarray(japply.to_faces(jnp.asarray(flat.numpy()), 5)))
    with pytest.raises(ValueError):
        to_faces(flat, 4)
    with pytest.raises(ValueError):
        from_faces(flat)


def test_apply_remap_device(grids, monkeypatch):
    w = grids["ll2cs"]
    x = np.ones((1, w.shape[1]), np.float32)
    np.testing.assert_allclose(apply_remap(w, x, device="cpu").numpy(), 1.0, atol=1e-6)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        apply_remap(w, x)  # an array names no device: the GPU, which is missing
