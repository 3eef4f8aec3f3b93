"""The port's geometry and insolation against the JAX package.

Inputs come from numpy seeds; the same arrays go to both packages.
Tolerances: the edge table and the cell coordinates are the same numpy
code, so they must be equal; insolation runs in float32 in both, with
sin/cos from different libraries, so it is held to 2e-3 W/m^2 (about 1e-6
of the 1361 W/m^2 solar constant, a few float32 ulps).
"""

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from dlwp_cs_tpu.geometry import cubed_sphere as jgeo
from dlwp_cs_tpu.geometry.insolation import INSOLATION_PERIOD_DAYS as J_PERIOD
from dlwp_cs_tpu.geometry.insolation import insolation as jinsolation
from dlwp_cs_tpu_torch.geometry import cubed_sphere as tgeo
from dlwp_cs_tpu_torch.geometry.insolation import (
    INSOLATION_PERIOD_DAYS,
    insolation,
)


def test_edge_table_matches_reference():
    ours = [[(l.face, l.edge, l.reverse) for l in row] for row in tgeo.edge_table()]
    ref = [[(l.face, l.edge, l.reverse) for l in row] for row in jgeo.edge_table()]
    assert ours == ref
    assert (tgeo.EDGE_S, tgeo.EDGE_N, tgeo.EDGE_W, tgeo.EDGE_E) == (
        jgeo.EDGE_S, jgeo.EDGE_N, jgeo.EDGE_W, jgeo.EDGE_E)
    assert tgeo.EQUATORIAL_FACES == jgeo.EQUATORIAL_FACES
    assert tgeo.POLAR_FACES == jgeo.POLAR_FACES


@pytest.mark.parametrize("n", [2, 8, 13, 48])
def test_cell_latlon_matches_reference(n):
    tgeo.verify_edge_table(n)
    lat, lon = tgeo.CubedSphere(n).cell_latlon
    rlat, rlon = jgeo.CubedSphere(n).cell_latlon
    np.testing.assert_array_equal(lat, rlat)
    np.testing.assert_array_equal(lon, rlon)
    np.testing.assert_array_equal(
        tgeo.CubedSphere(n).cell_xyz, jgeo.CubedSphere(n).cell_xyz
    )


def test_bad_resolution_and_face():
    with pytest.raises(ValueError):
        tgeo.CubedSphere(1)
    with pytest.raises(ValueError):
        tgeo.face_xyz(6, 0.0, 0.0)


def test_insolation_matches_reference():
    assert INSOLATION_PERIOD_DAYS == J_PERIOD
    rng = np.random.default_rng(3)
    lat, lon = (a.astype(np.float32) for a in tgeo.CubedSphere(8).cell_latlon)
    days = rng.uniform(0.0, INSOLATION_PERIOD_DAYS, size=(16, 1, 1, 1))
    days = days.astype(np.float32)
    ours = insolation(torch.from_numpy(days), torch.from_numpy(lat),
                      torch.from_numpy(lon)).numpy()
    ref = np.asarray(jinsolation(jnp.asarray(days), jnp.asarray(lat),
                                 jnp.asarray(lon)))
    assert ours.dtype == np.float32 and ours.shape == (16, 6, 8, 8)
    np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-3)
    assert ours.max() > 1000.0 and ours.min() == 0.0  # day and night present
