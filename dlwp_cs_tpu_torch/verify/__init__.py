"""Forecast verification metrics and the cross-implementation oracle."""

from dlwp_cs_tpu_torch.verify.alignment import align_truth
from dlwp_cs_tpu_torch.verify.ensemble import crps_ensemble, rank_histogram, spread_error
from dlwp_cs_tpu_torch.verify.metrics import (
    acc_curve,
    climo_error,
    forecast_error,
    monthly_climo_error,
    persistence_error,
)
from dlwp_cs_tpu_torch.verify.oracle import OracleReport, compare_to_golden
from dlwp_cs_tpu_torch.verify.relabel import (
    FaceRelabeling,
    apply_relabeling,
    infer_relabeling,
    invert_relabeling,
)

__all__ = [
    "align_truth",
    "crps_ensemble",
    "rank_histogram",
    "spread_error",
    "OracleReport",
    "compare_to_golden",
    "FaceRelabeling",
    "apply_relabeling",
    "infer_relabeling",
    "invert_relabeling",
    "acc_curve",
    "climo_error",
    "forecast_error",
    "monthly_climo_error",
    "persistence_error",
]
