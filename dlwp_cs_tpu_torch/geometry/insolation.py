"""Analytic top-of-atmosphere solar irradiance in torch.

The counterpart of ``dlwp_cs_tpu.geometry.insolation``: the Spencer (1971)
Fourier series for declination, equation of time and Sun-Earth distance,
then the zenith-angle formula.  :func:`insolation` runs on the device
inside the rollout loop, in the dtype of its inputs (float32 on the serving
path, as the reference computes it); with ``xp=numpy`` (or
:func:`insolation_np`) it runs on the host for the data pipeline, as the
reference's ``xp=numpy`` path does, float64 for float64 inputs.
"""

from __future__ import annotations

import math

import numpy as np
import torch

__all__ = [
    "insolation",
    "insolation_np",
    "INSOLATION_PERIOD_DAYS",
    "J2000_EPOCH",
    "SOLAR_CONSTANT",
]

# Mean total solar irradiance, W/m^2.
SOLAR_CONSTANT = 1361.0

# Days-since-epoch convention: 2000-01-01 00:00 UTC.
J2000_EPOCH = "2000-01-01T00:00:00Z"

# mod(epoch_days, 365.25) is 0-based and is exactly the DOY-1 that Spencer's
# day angle wants (0.0 on Jan 1): do not add 1.
_DAYS_PER_YEAR = 365.25

# The formula is periodic in 1461 days (4 * 365.25).  Reduce epoch days
# modulo this on the host in float64 before the float32 clock: present-day
# epoch days (~9700) carry an ~84 s float32 ULP, reduced values ~10 s.
INSOLATION_PERIOD_DAYS = 1461.0


def _spencer_terms(g, xp=torch):
    """Declination (rad), equation of time (rad), distance factor (a/r)^2;
    ``xp`` is ``torch`` or ``numpy``."""
    c1, s1 = xp.cos(g), xp.sin(g)
    c2, s2 = xp.cos(2 * g), xp.sin(2 * g)
    c3, s3 = xp.cos(3 * g), xp.sin(3 * g)
    decl = (
        0.006918
        - 0.399912 * c1
        + 0.070257 * s1
        - 0.006758 * c2
        + 0.000907 * s2
        - 0.002697 * c3
        + 0.001480 * s3
    )
    eot = 0.000075 + 0.001868 * c1 - 0.032077 * s1 - 0.014615 * c2 - 0.040849 * s2
    dist = (
        1.000110
        + 0.034221 * c1
        + 0.001280 * s1
        + 0.000719 * c2
        + 0.000077 * s2
    )
    return decl, eot, dist


def insolation(days_since_epoch, lat, lon, *, s0: float = SOLAR_CONSTANT, xp=torch):
    """TOA downward solar irradiance in W/m^2.

    ``days_since_epoch``: days since 2000-01-01 00:00 UTC (the fraction
    encodes UTC time of day), broadcasting against ``lat``/``lon`` (radians,
    lon east-positive) from the left: ``(T, 1, 1, 1)`` with lat ``(6, n, n)``
    gives ``(T, 6, n, n)``.  ``xp`` is ``torch`` (tensors) or ``numpy``
    (array-likes).  Returns ``s0 * (a/r)^2 * max(cos(zenith), 0)``.
    """
    if xp is np:
        days_since_epoch, lat, lon = map(np.asarray, (days_since_epoch, lat, lon))
    d = days_since_epoch
    doy = xp.remainder(d, _DAYS_PER_YEAR)
    frac = xp.remainder(d, 1.0)
    day_angle = 2.0 * math.pi * doy / _DAYS_PER_YEAR
    decl, eot, dist = _spencer_terms(day_angle, xp)
    # solar noon at lon 0 is 12 UTC; eot shifts apparent time
    hour_angle = 2.0 * math.pi * (frac - 0.5) + lon + eot
    cos_zen = xp.sin(lat) * xp.sin(decl) + xp.cos(lat) * xp.cos(decl) * xp.cos(hour_angle)
    lit = np.maximum(cos_zen, 0.0) if xp is np else torch.clamp_min(cos_zen, 0.0)
    return s0 * dist * lit


def insolation_np(days_since_epoch, lat, lon, *, s0: float = SOLAR_CONSTANT):
    """:func:`insolation` in numpy, for the host data pipeline."""
    return insolation(days_since_epoch, lat, lon, s0=s0, xp=np)
