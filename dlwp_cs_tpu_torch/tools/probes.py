"""The probe kernels of ``csrc/cs_probes.cu``: wrappers and plain versions.

* :data:`lane_store`: x stored into 3 channel-offset slices of a scratch row
  and summed back, 3·x; replaces ``tools/kernel_variants.py::_store_kernel``.
* The lowering probes of ``tools/mosaic_bisect{,2,3}.py``, one wrapper each:
  :data:`probe_assemble` (kA: the padded face assembled with ghost rows,
  then ghost columns; ``xpad[1:N+1, 2:N+2]``), :data:`probe_rows_int`,
  :data:`probe_rows_slice`, :data:`probe_col_int` and
  :data:`probe_col_newaxis` (bisect2's ``mk`` variants: only the S and N
  ghost rows, or only the W column, written; the reference writes them by
  int, slice or new-axis index, the same writes here, so one kernel with an
  edge mask serves all four and each is still its own launch),
  :data:`probe_select` (kB), :data:`probe_dot` (kC),
  :data:`probe_shifted_dots` (kD), :data:`probe_bias` (kE),
  :data:`probe_dw_reshape` (bisect3 k1) and :data:`probe_dw_batched` (k2).

The reference's scratch is uninitialised; here it starts as zeros, so the
cells no probe writes (bisect2's E column, kD's frame) read as zero.  Every
wrapper takes float32 or bfloat16, runs its plain version (its ``plain``)
on a CPU tensor and launches its kernel (counted in ``launches``) on a
CUDA tensor; the plain versions sum in ``torch.promote_types(dtype,
float32)`` and round once to the output type (the dw probes return the sum
type).
"""

from __future__ import annotations

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.cuda_build import DTYPES, I32, VP, CudaLibrary, KernelWrapper

__all__ = [
    "PROBES",
    "assemble_plain",
    "bias_plain",
    "dot_plain",
    "dw_batched_plain",
    "dw_reshape_plain",
    "lane_store",
    "lane_store_plain",
    "probe_assemble",
    "probe_bias",
    "probe_col_int",
    "probe_col_newaxis",
    "probe_dot",
    "probe_dw_batched",
    "probe_dw_reshape",
    "probe_rows_int",
    "probe_rows_slice",
    "probe_select",
    "probe_shifted_dots",
    "select_plain",
    "shifted_dots_plain",
]

GHOST_S, GHOST_N, GHOST_W, GHOST_E = 1, 2, 4, 8
_ASSEMBLE_ROWS = 4  # padded rows a block of the assembly kernel holds


def _acc(t):
    return t.to(torch.promote_types(t.dtype, torch.float32))


def lane_store_plain(x):
    """``x`` (..., C) -> 3·x: x copied into the three C-wide slices of a
    ``(..., 3C)`` scratch, the slices summed back, rounded once."""
    c = x.shape[-1]
    s = _acc(torch.cat([x, x, x], dim=-1))
    return (s[..., :c] + s[..., c : 2 * c] + s[..., 2 * c :]).to(x.dtype)


def assemble_plain(x, e, mask):
    """``x`` (N, N, C), ``e`` (4, N+2, C) [S, N, W, E] -> ``xpad[1:N+1,
    2:N+2]`` (N, N, C) of the zero scratch ``xpad`` (N+2, N+2, C) holding x
    in its interior, then the ghost rows, then the ghost columns that
    ``mask`` (``GHOST_*`` bits) names."""
    n = x.shape[0]
    xpad = x.new_zeros((n + 2, n + 2, x.shape[-1]))
    xpad[1 : n + 1, 1 : n + 1] = x
    if mask & GHOST_S:
        xpad[0] = e[0]
    if mask & GHOST_N:
        xpad[n + 1] = e[1]
    if mask & GHOST_W:
        xpad[:, 0] = e[2]
    if mask & GHOST_E:
        xpad[:, n + 1] = e[3]
    return xpad[1 : n + 1, 2 : n + 2]


def select_plain(k1, k2, programs=2):
    """``(programs, C, D)``: tap (1, 1) of ``k1`` for program ids below 4,
    of ``k2`` from 4 on (the reference's ``jnp.where(s < 4, ...)``)."""
    return torch.stack([(k1 if s < 4 else k2)[1, 1] for s in range(programs)])


def dot_plain(x, k):
    """``x`` (N, N, C) . ``k`` (C, D) -> (N, N, D), summed wide, rounded once."""
    return (_acc(x) @ _acc(k)).to(x.dtype)


def shifted_dots_plain(x, k):
    """``x`` (N, N, C), ``k`` (3, 3, C, D) -> (N, N, D): the 9 shifted
    products of the zero-framed face, summed wide, rounded once."""
    n = x.shape[0]
    p = F.pad(_acc(x), (0, 0, 1, 1, 1, 1))
    kf = _acc(k)
    acc = sum(p[dy : dy + n, dx : dx + n] @ kf[dy, dx] for dy in range(3) for dx in range(3))
    return acc.to(x.dtype)


def bias_plain(x, b):
    """``x`` (..., D) + ``b`` (D,), summed wide, rounded once."""
    return (_acc(x) + _acc(b)).to(x.dtype)


def dw_reshape_plain(x, g):
    """``x`` (n, n, C), ``g`` (n, n, D) -> ``x.reshape(n², C)ᵀ ·
    g.reshape(n², D)`` (C, D) in the sum type."""
    return _acc(x).reshape(-1, x.shape[-1]).T @ _acc(g).reshape(-1, g.shape[-1])


def dw_batched_plain(x, g):
    """The same as :func:`dw_reshape_plain`, as the reference's k2 sums it:
    per column the product over rows, then the sum over the columns."""
    return torch.einsum("ijc,ijd->jcd", _acc(x), _acc(g)).sum(dim=0)


_LIB = CudaLibrary("cs_probes.cu", {
    "cs_lane_store_launch": [I32, VP, VP, I32, I32, I32, VP],
    "cs_probe_assemble_launch": [I32, VP, VP, VP, I32, I32, I32, I32, VP],
    "cs_probe_select_launch": [I32, VP, VP, VP, I32, I32, I32, VP],
    "cs_probe_dot_launch": [I32, VP, VP, VP, I32, I32, I32, VP],
    "cs_probe_shifted_launch": [I32, VP, VP, VP, I32, I32, I32, VP],
    "cs_probe_bias_launch": [I32, VP, VP, VP, I32, I32, VP],
    "cs_probe_dw_launch": [I32, VP, VP, VP, I32, I32, I32, I32, VP],
}, "cs_probes_error_string")


def _check(name, shapes):
    """Raise unless every tensor of ``shapes`` (``[(t, shape)]``) has its
    shape, the first one's device (CUDA) and dtype (float32 or bfloat16),
    and is contiguous."""
    ref = shapes[0][0]
    if ref.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {ref.device}")
    if ref.dtype not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, not {ref.dtype}")
    for t, shape in shapes:
        if tuple(t.shape) != tuple(shape):
            raise ValueError(f"{name}: expected shape {tuple(shape)}, got {tuple(t.shape)}")
        if t.device != ref.device or t.dtype != ref.dtype or not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors of one dtype on one device")


class _LaneStore(KernelWrapper):
    plain = staticmethod(lane_store_plain)

    def __call__(self, x):
        """``x`` (B, 6, n, n, C) -> 3·x (see :func:`lane_store_plain`)."""
        if x.device.type == "cpu":
            return self.plain(x)
        if x.ndim != 5:
            raise ValueError(f"{self.name}: expected (B, 6, n, n, C), got {tuple(x.shape)}")
        _check(self.name, [(x, x.shape)])
        n, c = x.shape[3], x.shape[4]
        out = torch.empty_like(x)
        dev = self._device(x)
        self._launch("cs_lane_store_launch", dev, DTYPES[x.dtype], x.data_ptr(), out.data_ptr(),
                     x.numel() // (n * c), n, c, sizes=3)
        return out


class _Assemble(KernelWrapper):
    def __init__(self, name, mask):
        super().__init__(name, _LIB)
        self.mask = mask

    def plain(self, x, e):
        return assemble_plain(x, e, self.mask)

    def __call__(self, x, e):
        """``x`` (N, N, C), ``e`` (4, N+2, C) -> (N, N, C), see
        :func:`assemble_plain` with this probe's ghost lines."""
        if x.device.type == "cpu":
            return self.plain(x, e)
        n, c = x.shape[0], x.shape[-1]
        _check(self.name, [(x, (n, n, c)), (e, (4, n + 2, c))])
        out = torch.empty_like(x)
        dev = self._device(x)
        self._launch("cs_probe_assemble_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                     e.data_ptr(), out.data_ptr(), n, c, _ASSEMBLE_ROWS, self.mask, sizes=4)
        return out


class _Select(KernelWrapper):
    plain = staticmethod(select_plain)

    def __call__(self, k1, k2, programs=2):
        """``k1``, ``k2`` (3, 3, C, D) -> (programs, C, D), see
        :func:`select_plain`."""
        if k1.device.type == "cpu":
            return self.plain(k1, k2, programs)
        c, d = k1.shape[-2], k1.shape[-1]
        _check(self.name, [(k1, (3, 3, c, d)), (k2, (3, 3, c, d))])
        out = k1.new_empty((programs, c, d))
        dev = self._device(k1)
        self._launch("cs_probe_select_launch", dev, DTYPES[k1.dtype], k1.data_ptr(),
                     k2.data_ptr(), out.data_ptr(), programs, c, d, sizes=3)
        return out


class _Dot(KernelWrapper):
    def __init__(self, name, shifted):
        super().__init__(name, _LIB)
        self.shifted = shifted
        self.plain = shifted_dots_plain if shifted else dot_plain

    def __call__(self, x, k):
        """``x`` (N, N, C) with ``k`` (C, D) (:func:`dot_plain`), or ``k``
        (3, 3, C, D) for the shifted probe (:func:`shifted_dots_plain`)."""
        if x.device.type == "cpu":
            return self.plain(x, k)
        n, c, d = x.shape[0], x.shape[-1], k.shape[-1]
        _check(self.name, [(x, (n, n, c)), (k, (3, 3, c, d) if self.shifted else (c, d))])
        out = x.new_empty((n, n, d))
        dev = self._device(x)
        if self.shifted:
            self._launch("cs_probe_shifted_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                         k.data_ptr(), out.data_ptr(), n, c, d, sizes=3)
        else:
            self._launch("cs_probe_dot_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                         k.data_ptr(), out.data_ptr(), n * n, c, d, sizes=3)
        return out


class _Bias(KernelWrapper):
    plain = staticmethod(bias_plain)

    def __call__(self, x, b):
        """``x`` (..., D) + ``b`` (D,), see :func:`bias_plain`."""
        if x.device.type == "cpu":
            return self.plain(x, b)
        d = x.shape[-1]
        _check(self.name, [(x, x.shape), (b, (d,))])
        out = torch.empty_like(x)
        dev = self._device(x)
        self._launch("cs_probe_bias_launch", dev, DTYPES[x.dtype], x.data_ptr(), b.data_ptr(),
                     out.data_ptr(), x.numel() // d, d, sizes=2)
        return out


class _Dw(KernelWrapper):
    def __init__(self, name, batched):
        super().__init__(name, _LIB)
        self.batched = batched
        self.plain = dw_batched_plain if batched else dw_reshape_plain

    def __call__(self, x, g):
        """``x`` (n, n, C), ``g`` (n, n, D) -> (C, D) float32, see
        :func:`dw_reshape_plain` / :func:`dw_batched_plain`."""
        if x.device.type == "cpu":
            return self.plain(x, g)
        n, c, d = x.shape[0], x.shape[-1], g.shape[-1]
        _check(self.name, [(x, (n, n, c)), (g, (n, n, d))])
        out = torch.empty((c, d), dtype=torch.float32, device=x.device)
        dev = self._device(x)
        self._launch("cs_probe_dw_launch", dev, DTYPES[x.dtype], x.data_ptr(), g.data_ptr(),
                     out.data_ptr(), n, c, d, int(self.batched), sizes=4)
        return out


lane_store = _LaneStore("lane_store", _LIB)
probe_assemble = _Assemble("probe_assemble", GHOST_S | GHOST_N | GHOST_W | GHOST_E)
probe_rows_int = _Assemble("probe_rows_int", GHOST_S | GHOST_N)
probe_rows_slice = _Assemble("probe_rows_slice", GHOST_S | GHOST_N)
probe_col_int = _Assemble("probe_col_int", GHOST_W)
probe_col_newaxis = _Assemble("probe_col_newaxis", GHOST_W)
probe_select = _Select("probe_select", _LIB)
probe_dot = _Dot("probe_dot", shifted=False)
probe_shifted_dots = _Dot("probe_shifted_dots", shifted=True)
probe_bias = _Bias("probe_bias", _LIB)
probe_dw_reshape = _Dw("probe_dw_reshape", batched=False)
probe_dw_batched = _Dw("probe_dw_batched", batched=True)

# every probe of tools/mosaic_bisect{,2,3}.py by the reference's name
PROBES = {
    "A-assembly": probe_assemble, "B-select": probe_select, "C-dot": probe_dot,
    "D-shifted-dots": probe_shifted_dots, "E-bias": probe_bias,
    "rows-int-idx": probe_rows_int, "rows-slice-idx": probe_rows_slice,
    "col-int-idx": probe_col_int, "col-newaxis": probe_col_newaxis,
    "reshape-collapse": probe_dw_reshape, "batched-dot": probe_dw_batched,
}
