"""Small utilities: time conversions, index splits, NaN handling.

The port's copy of ``dlwp_cs_tpu.utils.misc`` (numpy only): the converters
for the canonical time axis, float days since 2000-01-01 00 UTC, and the
grab-bag helpers ``day_of_year``, ``train_test_split_ind`` and
``delete_nan_samples``, with the reference's arguments, errors and return
types (``method="random"`` draws from ``np.random.default_rng(0)``, so the
index sets are the reference's).
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

__all__ = [
    "datetime_to_days",
    "days_to_datetime",
    "day_of_year",
    "train_test_split_ind",
    "delete_nan_samples",
]

_EPOCH = _dt.datetime(2000, 1, 1, tzinfo=_dt.timezone.utc)


def datetime_to_days(dates):
    """datetime(s) -> float days since 2000-01-01 00 UTC (naive datetimes
    are taken as UTC)."""
    single = isinstance(dates, _dt.datetime)
    seq = [dates] if single else list(dates)
    out = np.array([
        ((d.replace(tzinfo=_dt.timezone.utc) if d.tzinfo is None else d) - _EPOCH
         ).total_seconds() / 86400.0
        for d in seq
    ])
    return out[0] if single else out


def days_to_datetime(days):
    """float days since the epoch -> UTC datetime(s): one for a scalar, a
    list otherwise."""
    arr = np.atleast_1d(np.asarray(days, np.float64))
    out = [_EPOCH + _dt.timedelta(days=float(d)) for d in arr]
    return out[0] if np.isscalar(days) or np.asarray(days).ndim == 0 else out


def day_of_year(days):
    """1-based day of year of epoch-days timestamps: a float for a scalar,
    an array otherwise."""
    arr = np.atleast_1d(np.asarray(days, np.float64))
    out = np.array(
        [float((_EPOCH + _dt.timedelta(days=float(d))).timetuple().tm_yday) for d in arr]
    )
    return out[0] if np.asarray(days).ndim == 0 else out


def train_test_split_ind(n_samples: int, test_size, *, method: str = "last"):
    """``(train_idx, test_idx)`` of ``n_samples``: ``test_size`` a count
    (int) or a fraction (float); ``method`` ``'last'``, ``'first'`` or
    ``'random'`` (sorted index sets of one seeded permutation)."""
    n_test = (
        int(round(n_samples * test_size)) if isinstance(test_size, float) else int(test_size)
    )
    if not 0 < n_test < n_samples:
        raise ValueError(f"test size {n_test} out of range for {n_samples} samples")
    idx = np.arange(n_samples)
    if method == "last":
        return idx[:-n_test], idx[-n_test:]
    if method == "first":
        return idx[n_test:], idx[:n_test]
    if method == "random":
        perm = np.random.default_rng(0).permutation(n_samples)
        return np.sort(perm[n_test:]), np.sort(perm[:n_test])
    raise ValueError(f"unknown method {method!r}")


def delete_nan_samples(x: np.ndarray, *, axis: int = 0):
    """Drop the samples along ``axis`` that hold any NaN; returns ``(clean,
    kept_idx)``."""
    moved = np.moveaxis(x, axis, 0)
    flat = moved.reshape(moved.shape[0], -1)
    keep = ~np.isnan(flat).any(axis=1)
    return np.moveaxis(moved[keep], 0, axis), np.nonzero(keep)[0]
