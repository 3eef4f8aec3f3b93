"""Time conversions for the canonical time axis: float days since
2000-01-01 00 UTC.

The port's copy of what it needs of ``dlwp_cs_tpu.utils.misc`` (the
converters that ``verify/alignment.py`` uses); the reference's other
helpers (``day_of_year``, ``train_test_split_ind``,
``delete_nan_samples``) are not ported yet (ROADMAP.md queue 1, item 16).
"""

from __future__ import annotations

import datetime as _dt

import numpy as np

__all__ = ["datetime_to_days", "days_to_datetime"]

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
