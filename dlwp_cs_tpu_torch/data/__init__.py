from dlwp_cs_tpu_torch.data.channels import (
    advance_window,
    fold_time,
    make_input_insolation,
    pack_inputs,
    unfold_time,
)
from dlwp_cs_tpu_torch.data.prefetch import PrefetchIterator, prefetch_to_device
from dlwp_cs_tpu_torch.data.series import SeriesDataset, insolation_stats
from dlwp_cs_tpu_torch.data.store import MemoryStore, normalize_store, select_constants

__all__ = [
    "MemoryStore",
    "PrefetchIterator",
    "SeriesDataset",
    "advance_window",
    "fold_time",
    "insolation_stats",
    "make_input_insolation",
    "normalize_store",
    "pack_inputs",
    "prefetch_to_device",
    "select_constants",
    "unfold_time",
]
