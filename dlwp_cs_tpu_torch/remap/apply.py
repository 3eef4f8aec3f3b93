"""Remap application on the device, and the face/column reshapes.

The counterpart of ``dlwp_cs_tpu.remap.apply``, which applies the sparse
weights as one gather and one ``segment_sum`` on the device.  Here the same
contraction runs on the tensor's device (the GPU for the dataset build and
for remapping forecasts back to lat-lon): the nonzeros are sorted by target
row once (stably), each nonzero's source column is gathered and scaled by
its weight, and each row's products are summed in order by
``torch.segment_reduce``.  That sum uses no atomics, so a result on the GPU
is bitwise repeatable, and only a row's own nonzeros enter it, so a NaN in
a source column poisons exactly the rows that use that column.  Rows are
not padded to a common length: conservative lat-lon -> cubed-sphere rows
run from a few nonzeros to hundreds.
"""

from __future__ import annotations

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.remap.weights import RemapWeights

__all__ = ["apply_remap", "remap_ll_to_cs", "remap_cs_to_ll", "to_faces", "from_faces"]


def _device_weights(weights: RemapWeights, device: torch.device, dtype: torch.dtype):
    """``(cols, vals, offsets)`` on ``device``: the nonzeros sorted by row
    (stably), ``vals`` in ``dtype``, ``offsets`` the ``n_target + 1`` row
    starts.  Memoised on the weights object per (device, dtype) as long as
    its ``rows``/``cols``/``vals`` arrays are the same objects, so a loop of
    batches copies them to the device once."""
    cache = weights.__dict__.setdefault("_device_cache", {})
    arrays = (weights.rows, weights.cols, weights.vals)
    hit = cache.get((device, dtype))
    if hit is not None and all(a is b for a, b in zip(hit[0], arrays)):
        return hit[1]
    n_tgt, n_src = weights.shape
    rows = np.asarray(weights.rows, np.int64)
    cols = np.asarray(weights.cols, np.int64)
    if rows.size and (rows.min() < 0 or rows.max() >= n_tgt
                      or cols.min() < 0 or cols.max() >= n_src):
        raise ValueError(f"remap weights index outside their shape {weights.shape}")
    order = np.argsort(rows, kind="stable")
    offsets = np.zeros(n_tgt + 1, np.int64)
    np.cumsum(np.bincount(rows, minlength=n_tgt), out=offsets[1:])
    # the weights are never cast to an integer type: apply_remap promotes
    # an integer field to float32 first
    vals = torch.from_numpy(np.asarray(weights.vals)[order]).to(dtype)
    out = (torch.from_numpy(cols[order]).to(device), vals.to(device),
           torch.from_numpy(offsets).to(device))
    cache[device, dtype] = (arrays, out)
    return out


def apply_remap(weights: RemapWeights, x, *, device=None):
    """Apply a sparse remap along the last axis: ``(..., n_src) -> (...,
    n_tgt)``.

    A tensor ``x`` is remapped on its own device (or moved to ``device``
    first); anything else is made a tensor on ``device`` (``None``: the
    GPU, which must exist).  An integer or boolean field is promoted to
    float32; the weights take ``x``'s floating dtype (bfloat16 in gives
    bfloat16 weights, float64 float64 ones), as the reference casts them.
    """
    if x.shape[-1] != weights.shape[1]:
        raise ValueError(f"source dim {x.shape[-1]} != {weights.shape[1]}")
    if isinstance(x, torch.Tensor):
        if device is not None:
            x = x.to(resolve_device(device))
    else:
        x = torch.as_tensor(np.asarray(x), device=resolve_device(device))
    if not x.is_floating_point():
        x = x.to(torch.float32)
    cols, vals, offsets = _device_weights(weights, x.device, x.dtype)
    lead = x.shape[:-1]
    # (nnz, M): each nonzero's source column over the flattened leading
    # axes, scaled by its weight; then the sum of each row's run of them
    src = x.reshape(-1, weights.shape[1]).t().contiguous()
    prods = src.index_select(0, cols) * vals[:, None]
    out = torch.segment_reduce(prods, "sum", offsets=offsets, axis=0, unsafe=True)
    return out.t().reshape(lead + (weights.shape[0],))


def remap_ll_to_cs(weights: RemapWeights, x, n: int, *, device=None):
    """``(..., H, W) -> (..., 6, n, n)`` via an LL->CS weight matrix."""
    flat = x.reshape(x.shape[:-2] + (-1,))
    out = apply_remap(weights, flat, device=device)
    return out.reshape(tuple(x.shape[:-2]) + (6, n, n))


def remap_cs_to_ll(weights: RemapWeights, x, n_lat: int, n_lon: int, *, device=None):
    """``(..., 6, n, n) -> (..., H, W)`` via a CS->LL weight matrix."""
    flat = x.reshape(x.shape[:-3] + (-1,))
    out = apply_remap(weights, flat, device=device)
    return out.reshape(tuple(x.shape[:-3]) + (n_lat, n_lon))


def to_faces(x, n: int):
    """Reshape a flat column dim ``ncol = 6*n*n`` into ``(6, n, n)``; the
    column order is face-major, then ``i`` (eta row), then ``j`` (xi col)."""
    if x.shape[-1] != 6 * n * n:
        raise ValueError(f"expected ncol={6 * n * n}, got {x.shape[-1]}")
    return x.reshape(tuple(x.shape[:-1]) + (6, n, n))


def from_faces(x):
    """Inverse of :func:`to_faces`: ``(..., 6, n, n) -> (..., 6*n*n)``."""
    if x.ndim < 3 or x.shape[-3] != 6 or x.shape[-1] != x.shape[-2]:
        raise ValueError(f"expected (..., 6, n, n), got {tuple(x.shape)}")
    return x.reshape(tuple(x.shape[:-3]) + (-1,))
