"""The port's barotropic baseline against the JAX package's: the spherical
harmonic transform and its operators at T21 and T10, the tendency of
solid-body flow and an 8-step RK4 integration, in float32, from the same
numpy inputs.

Tolerances (float32, the same float64 tables cast once on both sides; the
FFT and the Legendre contraction sum in another order):

* transforms and operators: 2e-5 of the largest |value| of the reference's
  output (spectral coefficients of order 1-10 summed over up to 34
  latitudes);
* the tendency: 2e-5 of its largest |value| plus 2e-5 of the advective
  scale U |zeta| / a (the steady state's tendency is rounding);
* 8 RK4 steps: 1e-4 of the largest |zeta| (rounding carried through 32
  tendencies);
* a float64 round trip: 1e-12 absolute, on the port's own and against the
  reference's under ``jax.enable_x64``.
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.barotropic import BarotropicModel as JModel
from dlwp_cs_tpu.barotropic import SphericalHarmonics as JSHT
from dlwp_cs_tpu_torch.barotropic import BarotropicModel, SphericalHarmonics

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

LMAXES = (21, 10)


def _spec(lmax, seed, m_max=5, l_max=8, dtype=np.complex64):
    """A band-limited field's coefficients (the m = 0 row real)."""
    rng = np.random.default_rng(seed)
    spec = np.zeros((lmax + 1, lmax + 1), dtype)
    for m in range(min(m_max, lmax + 1)):
        for l in range(m, min(l_max, lmax + 1)):
            spec[m, l] = rng.normal() + 1j * rng.normal() * (m > 0)
    return spec


def _mask(lmax):
    return np.triu(np.ones((lmax + 1, lmax + 1), bool))


def _close(ours, ref, rel):
    ours = ours.numpy() if isinstance(ours, torch.Tensor) else ours
    ref = np.asarray(ref)
    assert ours.shape == ref.shape and ours.dtype == ref.dtype
    np.testing.assert_allclose(ours, ref, rtol=0, atol=rel * np.abs(ref).max())


@pytest.fixture(scope="module")
def pairs():
    return {lmax: (SphericalHarmonics(lmax, device="cpu"), JSHT(lmax)) for lmax in LMAXES}


@pytest.fixture(scope="module")
def reference(pairs):
    """The reference's outputs, once per module: each transform and
    operator on a seeded grid field (batch 2) and a band-limited spectrum."""
    out = {}
    for lmax, (_, js) in pairs.items():
        grid = np.random.default_rng(lmax).normal(size=(2, js.nlat, js.nlon)).astype(np.float32)
        spec = _spec(lmax, seed=lmax + 1)
        s = jnp.asarray(spec)
        out[lmax] = {
            "grid": grid, "spec": spec,
            "grid_to_spec": np.asarray(js.grid_to_spec(jnp.asarray(grid))),
            "spec_to_grid": np.asarray(js.spec_to_grid(s)),
            "laplacian": np.asarray(js.laplacian(s)),
            "inverse_laplacian": np.asarray(js.inverse_laplacian(s)),
            "ddlon": np.asarray(js.ddlon(s)),
            "cos_lat_grad": [np.asarray(v) for v in js.cos_lat_grad(s)],
        }
    return out


@pytest.mark.parametrize("lmax", LMAXES)
def test_grid_and_tables_match_reference(pairs, lmax):
    ts, js = pairs[lmax]
    assert (ts.nlat, ts.nlon) == (js.nlat, js.nlon)
    for name in ("sinlat", "weights", "lats", "lons", "laplacian_eig", "_plm"):
        np.testing.assert_array_equal(getattr(ts, name), getattr(js, name))


@pytest.mark.parametrize("lmax", LMAXES)
def test_transforms_match_reference(pairs, reference, lmax):
    ts, _ = pairs[lmax]
    ref = reference[lmax]
    _close(ts.grid_to_spec(torch.from_numpy(ref["grid"])), ref["grid_to_spec"], 2e-5)
    _close(ts.spec_to_grid(torch.from_numpy(ref["spec"])), ref["spec_to_grid"], 2e-5)
    # numpy inputs go to the transform's device
    _close(ts.spec_to_grid(ref["spec"]), ref["spec_to_grid"], 2e-5)
    back = ts.grid_to_spec(ts.spec_to_grid(torch.from_numpy(ref["spec"]))).numpy()
    np.testing.assert_allclose(back[_mask(lmax)], ref["spec"][_mask(lmax)], atol=2e-5)


@pytest.mark.parametrize("lmax", LMAXES)
@pytest.mark.parametrize("op", ["laplacian", "inverse_laplacian", "ddlon", "cos_lat_grad"])
def test_operators_match_reference(pairs, reference, lmax, op):
    ts, _ = pairs[lmax]
    ref = reference[lmax]
    spec = torch.from_numpy(ref["spec"])
    ours = getattr(ts, op)(spec)
    if op == "cos_lat_grad":
        assert len(ours) == 3
        for o, r in zip(ours, ref[op]):
            _close(o, r, 2e-5)
    else:
        _close(ours, ref[op], 2e-5)


def test_float64_round_trip_reaches_1e_12():
    """The tables are cast from float64 per dtype: a float64 round trip is
    exact to 1e-12, as the reference's is under x64, and the two agree."""
    ts = SphericalHarmonics(15, device="cpu")
    spec = _spec(15, seed=1, m_max=4, l_max=7, dtype=np.complex128)
    f = ts.spec_to_grid(torch.from_numpy(spec))
    assert f.dtype == torch.float64
    back = ts.grid_to_spec(f).numpy()
    np.testing.assert_allclose(back[_mask(15)], spec[_mask(15)], rtol=0, atol=1e-12)
    with jax.enable_x64(True):
        js = JSHT(15)
        jf = js.spec_to_grid(jnp.asarray(spec))
        assert jf.dtype == jnp.float64
        jback = np.asarray(js.grid_to_spec(jf))
    np.testing.assert_allclose(f.numpy(), np.asarray(jf), rtol=0, atol=1e-12)
    np.testing.assert_allclose(back, jback, rtol=0, atol=1e-12)
    # the float32 tables of the same object are cast apart
    f32 = ts.spec_to_grid(torch.from_numpy(spec.astype(np.complex64)))
    assert f32.dtype == torch.float32
    np.testing.assert_allclose(f32.numpy(), f.numpy(), atol=1e-5 * np.abs(f.numpy()).max())


def test_solid_body_tendency_matches_reference():
    ts, js = SphericalHarmonics(21, device="cpu"), JSHT(21)
    model = BarotropicModel(ts, dt=1800.0, hyperdiffusion_time=1e12)
    jmodel = JModel(js, dt=1800.0, hyperdiffusion_time=1e12)
    z0 = model.solid_body_vorticity(15.0)
    np.testing.assert_array_equal(z0, jmodel.solid_body_vorticity(15.0))
    tend = model.tendency(ts.grid_to_spec(torch.as_tensor(z0, dtype=torch.float32)))
    ref = np.asarray(jmodel.tendency(js.grid_to_spec(jnp.asarray(z0, jnp.float32))))
    scale = 15.0 * np.abs(z0).max() / ts.radius
    np.testing.assert_allclose(tend.numpy(), ref, rtol=0,
                               atol=2e-5 * np.abs(ref).max() + 2e-5 * scale)
    # steady: the tendency is negligible against the advective scale
    assert float(ts.spec_to_grid(tend).abs().max()) < 20 * scale * 1e-2


def test_integration_matches_reference():
    ts, js = SphericalHarmonics(21, device="cpu"), JSHT(21)
    model, jmodel = BarotropicModel(ts, dt=1800.0), JModel(js, dt=1800.0)
    z0 = model.rossby_haurwitz_vorticity()
    np.testing.assert_array_equal(z0, jmodel.rossby_haurwitz_vorticity())
    ours = model.integrate(torch.as_tensor(z0, dtype=torch.float32), 8, save_every=4)
    ref = np.asarray(jmodel.integrate(jnp.asarray(z0, jnp.float32), 8, save_every=4))
    assert ours.shape == (2, ts.nlat, ts.nlon) and ours.dtype == torch.float32
    assert ours.device == ts.device
    np.testing.assert_allclose(ours.numpy(), ref, rtol=0, atol=1e-4 * np.abs(ref).max())
    c = np.corrcoef(ours[-1].numpy().ravel(), z0.ravel())[0, 1]
    assert np.isfinite(ours.numpy()).all() and c > 0.5


@pytest.mark.parametrize("n_steps,save_every", [(8, 0), (8, 3)])
def test_integrate_errors_match_reference(n_steps, save_every):
    model = BarotropicModel(SphericalHarmonics(10, device="cpu"))
    jmodel = JModel(JSHT(10))
    z0 = model.solid_body_vorticity()
    with pytest.raises(ValueError) as ref:
        jmodel.integrate(jnp.asarray(z0, jnp.float32), n_steps, save_every=save_every)
    with pytest.raises(ValueError) as ours:
        model.integrate(z0, n_steps, save_every=save_every)
    assert str(ours.value) == str(ref.value)


@pytest.mark.parametrize("lmax,nlon", [(10, 20), (10, 19), (21, 42)])
def test_nyquist_guard_matches_reference(lmax, nlon):
    with pytest.raises(ValueError) as ref:
        JSHT(lmax, nlon=nlon)
    with pytest.raises(ValueError) as ours:
        SphericalHarmonics(lmax, nlon=nlon, device="cpu")
    assert str(ours.value) == str(ref.value)
    SphericalHarmonics(lmax, nlon=2 * lmax + 1, device="cpu")  # just past the guard
