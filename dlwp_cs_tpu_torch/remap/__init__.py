"""Lat-lon <-> cubed-sphere remapping: weight generation (numpy, the C++
generator) and application on the device (torch)."""

from dlwp_cs_tpu_torch.remap.apply import (
    apply_remap,
    from_faces,
    remap_cs_to_ll,
    remap_ll_to_cs,
    to_faces,
)
from dlwp_cs_tpu_torch.remap.native import (
    build_csremap,
    conservative_weights,
    load_csremap,
    run_csremap,
)
from dlwp_cs_tpu_torch.remap.weights import (
    RemapWeights,
    cs_to_ll_weights,
    latlon_grid,
    ll_to_cs_weights,
)

__all__ = [
    "apply_remap",
    "from_faces",
    "remap_cs_to_ll",
    "remap_ll_to_cs",
    "to_faces",
    "RemapWeights",
    "build_csremap",
    "conservative_weights",
    "load_csremap",
    "run_csremap",
    "cs_to_ll_weights",
    "latlon_grid",
    "ll_to_cs_weights",
]
