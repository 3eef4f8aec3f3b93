"""Forecast/truth alignment.

The port's copy of ``dlwp_cs_tpu.verify.alignment`` (numpy): given a
predictor store (a flat time series) and forecasts ``(B, L, ...)`` with
their initialization times and lead hours, produce in one pass the aligned
truth, the initialization fields (for persistence) and the valid months
(for a monthly climatology).
"""

from __future__ import annotations

import numpy as np

from dlwp_cs_tpu_torch.utils.misc import days_to_datetime

__all__ = ["align_truth"]


def align_truth(store, init_times, lead_hours):
    """Align store truth with forecasts.

    Args:
      store: predictor store (``fields (T, 6, n, n, C)``, ``times`` days).
      init_times: ``(B,)`` initialization times (days since epoch).
      lead_hours: ``(L,)`` forecast leads in hours.

    Returns dict with:
      ``truth`` (B, L', 6, n, n, C), ``init_fields`` (B, 6, n, n, C),
      ``lead_hours`` (L',) — leads truncated to those with full truth
      coverage, ``valid_months`` (B, L') 0-based months of the valid times.
    """
    times = np.asarray(store.times, np.float64)
    if len(times) < 2:
        raise ValueError("store must contain at least 2 samples")
    spacing = np.diff(times)
    dt = float(spacing[0])
    if not np.allclose(spacing, dt, rtol=0, atol=1e-9):
        raise ValueError(
            "store times are not uniformly spaced — index-based alignment "
            "would select wrong verification samples"
        )
    tol = dt * 1e-3  # a valid time must land ON a sample, not merely near one
    init_times = np.asarray(init_times, np.float64)
    lead_hours = np.asarray(lead_hours, np.float64)
    b, n_lead = len(init_times), len(lead_hours)
    shape = (b, n_lead) + store.fields.shape[1:]
    truth = np.zeros(shape, np.float32)
    months = np.zeros((b, n_lead), np.int64)
    valid = np.ones((b, n_lead), bool)
    init_fields = np.zeros((b,) + store.fields.shape[1:], np.float32)
    for bi in range(b):
        idx0 = int(round((init_times[bi] - times[0]) / dt))
        if not 0 <= idx0 < len(times):
            raise ValueError(f"init time {init_times[bi]} outside the store")
        if abs(times[idx0] - init_times[bi]) > tol:
            raise ValueError(
                f"init time {init_times[bi]} is not a store sample "
                f"(nearest is {times[idx0]})"
            )
        init_fields[bi] = store.fields[idx0]
        for li in range(n_lead):
            t_valid = init_times[bi] + lead_hours[li] / 24.0
            idx = int(round((t_valid - times[0]) / dt))
            if 0 <= idx < len(times) and abs(times[idx] - t_valid) <= tol:
                truth[bi, li] = store.fields[idx]
                months[bi, li] = days_to_datetime(float(t_valid)).month - 1
            elif 0 <= idx < len(times):
                # a lead that falls BETWEEN store samples (model dt not a
                # multiple of the store spacing) must not silently verify
                # against the nearest sample
                raise ValueError(
                    f"valid time {t_valid} (init {init_times[bi]} + "
                    f"{lead_hours[li]} h) falls between store samples "
                    f"(spacing {dt * 24:g} h)"
                )
            else:
                valid[bi, li] = False
    keep = valid.all(axis=0)
    return {
        "truth": truth[:, keep],
        "init_fields": init_fields,
        "lead_hours": lead_hours[keep],
        "valid_months": months[:, keep],
        "kept": keep,
    }
