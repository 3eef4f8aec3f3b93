"""The probe kernels of ``csrc/cs_probes.cu``: wrappers and plain versions.

* :data:`lane_store`: x stored into 3 channel-offset slices of a scratch row
  and summed back, 3·x; replaces ``tools/kernel_variants.py::_store_kernel``.
  Tiles of pixels, 16-byte accesses where C allows (:func:`lane_store_geom`);
  the kernel it replaced stays as the timing row :data:`lane_store_v1`.
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
type).  The assembly and ghost-write probes are a 16-byte gather, the
select 16-byte copies, the dot and shifted dots one implicit GEMM on the
tensor cores (:func:`conv_plan`), the dw probes a split-K GEMM there
(:func:`dw_split`) whose partials ``torch.sum`` adds in a fixed order.
The kernels they replaced stay as timing rows, each the same wrapper with
``v1`` (:data:`PROBES_V1`); no tool path runs them.
"""

from __future__ import annotations

import ctypes

import torch
import torch.nn.functional as F

from dataclasses import dataclass

from dlwp_cs_tpu_torch.ops.cuda_build import DTYPES, I32, VP, CudaLibrary, KernelWrapper

__all__ = [
    "LaneGeom",
    "PROBES",
    "PROBES_V1",
    "assemble_plain",
    "bias_plain",
    "conv_plan",
    "dot_plain",
    "dw_batched_plain",
    "dw_reshape_plain",
    "dw_slices",
    "dw_split",
    "lane_store",
    "lane_store_geom",
    "lane_store_plain",
    "lane_store_v1",
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
_ASSEMBLE_ROWS = 4  # padded rows a block of the v1 assembly kernel holds
# csrc/cs_probes.cu: the dw kernel's block tile (Cin, Cout) and pixels per
# chunk; the card's shared memory per block and the most a block may take
# for two to share an SM
_DW_MC, _DW_ND, _DW_KS = 32, 64, 64
_SMEM_LIMIT, _SMEM_TWO = 232448, (228 * 1024) // 2 - 1024
# csrc/cs_probes.cu's lane store: threads a block, the items a thread moves
# per tile (16-byte items, or single elements), an SM's threads and shared
# memory (228 KB, less 1 KB a block), and the grid's waves of resident blocks
_LS_THREADS, _LS_VEC_ITEMS, _LS_ELEM_ITEMS = 256, 4, 8
_SM_THREADS, _SM_SMEM, _LS_WAVES = 2048, 233472, 2


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


@dataclass(frozen=True)
class LaneGeom:
    """The lane store's launch, as ``csrc/cs_probes.cu::
    cs_lane_store_tiles_launch`` takes and checks it: ``vec`` 16-byte
    items (else elements), ``u`` items a pixel, ``p`` pixels a tile,
    ``ntiles`` tiles over ``npix`` pixels, ``grid`` blocks looping over
    them, ``smem`` bytes (the tile's scratch rows of 3C)."""

    npix: int
    c: int
    vec: bool
    u: int
    p: int
    ntiles: int
    grid: int
    smem: int


def lane_store_geom(esize: int, npix: int, c: int, vec: bool, sm_count: int) -> LaneGeom:
    """The lane store's tiles for ``npix`` pixels of ``c`` channels of
    ``esize`` bytes: as many whole pixels as a block's threads move in one
    pass, the grid the tiles or ``_LS_WAVES`` waves of the blocks an SM
    holds, whichever is fewer.  ``vec`` needs C's bytes a multiple of 16;
    ``ValueError`` where one pixel does not fit a tile."""
    if npix < 1 or c < 1 or (vec and (c * esize) % 16):
        raise ValueError(f"lane store: {npix} pixels of C={c} ({esize}-byte), vec={vec}")
    u = c * esize // 16 if vec else c
    p = (_LS_VEC_ITEMS if vec else _LS_ELEM_ITEMS) * _LS_THREADS // u
    if p < 1:
        raise ValueError(f"lane store: a pixel of C={c} is wider than a tile")
    smem = 3 * p * u * (16 if vec else esize)
    resident = min(_SM_THREADS // _LS_THREADS, _SM_SMEM // (smem + 1024))
    ntiles = -(-npix // p)
    return LaneGeom(npix, c, vec, u, p, ntiles, min(ntiles, _LS_WAVES * resident * sm_count),
                    smem)


@dataclass(frozen=True)
class ConvGeom:
    """The dot and shifted-dots kernel's geometry, as
    ``csrc/cs_probes.cu::make_conv_geom`` computes it: ``h`` face rows and
    ``dn`` output channels per block, ``cp`` staged 16-bit units per pixel,
    ``kpe`` K rows per tap, ``smem`` bytes; grid (ceil(N / h), ceil(D / dn))."""

    n: int
    c: int
    d: int
    ntaps: int
    h: int
    dn: int
    cp: int
    kpe: int
    smem: int

    @property
    def blocks(self):
        return -(-self.n // self.h) * -(-self.d // self.dn)


def conv_geom(esize: int, shifted: bool, n: int, c: int, d: int, h: int, dn: int) -> ConvGeom:
    """:class:`ConvGeom` of one launch; ``ValueError`` where the kernel
    refuses it."""
    if n < 1 or c < 1 or d < 1 or not 1 <= h <= n or dn < 16 or dn % 16:
        raise ValueError(f"probe conv: n={n}, C={c}, D={d}, h={h}, dn={dn}")
    upe = esize // 2
    step = 8 // upe
    cpe = -(-c // step) * step
    while (cpe * upe // 8) % 2 == 0:  # an odd multiple of 8 units
        cpe += step
    cp = cpe * upe
    kpe = -(-c // (16 // upe)) * (16 // upe)
    ntaps = 9 if shifted else 1
    cells = (h + 2) * (n + 2) if shifted else h * n
    smem = ntaps * kpe * (dn + 8) * esize + 2 * (cells + 1) * cp
    if smem > _SMEM_LIMIT:
        raise ValueError(f"probe conv: {smem} bytes of shared memory for h={h}, dn={dn}")
    return ConvGeom(n, c, d, ntaps, h, dn, cp, kpe, smem)


def conv_plan(dtype, shifted: bool, n: int, c: int, d: int, sm_count: int) -> ConvGeom:
    """The dot (``shifted`` False: 1 tap) or shifted-dots (9 taps) probe's
    launch: of the blocks of h in 1, 2, 4 face rows and dn channels (D
    halved down to 16) that fit two to an SM where any does, the most
    blocks within one wave of ``sm_count``, then the widest slice, else the
    fewest blocks."""
    esize = torch.empty((), dtype=dtype).element_size()
    geoms, dn = [], -(-d // 16) * 16
    while dn >= 16:
        for h in (1, 2, 4):
            try:
                geoms.append(conv_geom(esize, shifted, n, c, d, min(h, n), dn))
            except ValueError:
                pass
        dn = -(-(dn // 2) // 16) * 16 if dn > 16 else 0
    pool = [g for g in geoms if g.smem <= _SMEM_TWO] or geoms
    if not pool:
        raise ValueError(f"probe conv: n={n}, C={c}, D={d} does not fit a block")
    wave = [g for g in pool if g.blocks <= sm_count]
    if wave:
        return max(wave, key=lambda g: (g.blocks, g.dn, g.h))
    return min(pool, key=lambda g: (g.blocks, -g.dn))


def dw_split(n: int, c: int, d: int, batched: bool, sm_count: int) -> int:
    """K slices of the dw probe: about one wave of ``sm_count`` blocks over
    its (32 Cin x 64 Cout) tiles, at most one slice per chunk of 64 pixels
    (k1) or per column (k2)."""
    tiles = -(-c // _DW_MC) * -(-d // _DW_ND)
    units = n if batched else -(-n * n // _DW_KS)
    return max(1, min(units, sm_count // tiles))


def dw_slices(n: int, nsplit: int, batched: bool):
    """The pixel chunks of each K slice, in the order the kernel sums them:
    per slice a list of chunks, each a list of flat pixel indices (i * n +
    j) that go into one fresh sum; k2's chunk is a column (rows i in order),
    k1's a run of up to 64 consecutive pixels.  The kernel adds the chunks
    of a slice in order and ``torch.sum`` the slices."""
    total = n if batched else n * n
    out = []
    for s in range(nsplit):
        lo, hi = total * s // nsplit, total * (s + 1) // nsplit
        if batched:
            out.append([[i * n + j for i in range(n)] for j in range(lo, hi)])
        else:
            out.append([list(range(p, min(p + _DW_KS, hi))) for p in range(lo, hi, _DW_KS)])
    return out


_LIB = CudaLibrary("cs_probes.cu", {
    "cs_lane_store_launch": [I32, VP, VP, I32, I32, I32, VP],
    "cs_lane_store_tiles_launch": [I32, VP, VP, ctypes.c_longlong] + [I32] * 4 + [VP],
    "cs_probe_assemble_launch": [I32, VP, VP, VP, I32, I32, I32, I32, VP],
    "cs_probe_select_launch": [I32, VP, VP, VP, I32, I32, I32, VP],
    "cs_probe_dot_launch": [I32, VP, VP, VP, I32, I32, I32, VP],
    "cs_probe_shifted_launch": [I32, VP, VP, VP, I32, I32, I32, VP],
    "cs_probe_bias_launch": [I32, VP, VP, VP, I32, I32, VP],
    "cs_probe_dw_launch": [I32, VP, VP, VP, I32, I32, I32, I32, VP],
    "cs_probe_gather_launch": [I32, VP, VP, VP, I32, I32, I32, I32, VP],
    "cs_probe_select_vec_launch": [I32, VP, VP, VP, I32, I32, I32, I32, VP],
    "cs_probe_conv_tc_launch": [I32, VP, VP, VP] + [I32] * 7 + [VP],
    "cs_probe_dw_tc_launch": [I32, VP, VP, VP] + [I32] * 5 + [VP],
}, "cs_probes_error_string")


def _vec(t, width, *tensors):
    """16-byte accesses where ``width`` elements and every address allow."""
    v = 16 // t.element_size()
    return 1 if width % v or any(a.data_ptr() % 16 for a in (t, *tensors)) else v


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
    """#15; ``v1``: the kernel its redesign replaced (a timing row)."""

    plain = staticmethod(lane_store_plain)

    def __init__(self, name, v1=False):
        super().__init__(name, _LIB)
        self.v1 = v1

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
        if self.v1:
            self._launch("cs_lane_store_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                         out.data_ptr(), x.numel() // (n * c), n, c, sizes=3)
            return out
        g = lane_store_geom(x.element_size(), x.numel() // c, c, _vec(x, c, out) > 1,
                            self._sm_count[dev])
        self._launch("cs_lane_store_tiles_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                     out.data_ptr(), g.npix, c, int(g.vec), g.p, g.grid, sizes=5)
        return out


class _Probe(KernelWrapper):
    """A probe's wrapper; ``v1``: the kernel its redesign replaced (a
    timing row)."""

    def __init__(self, name, v1=False):
        super().__init__(name, _LIB)
        self.v1 = v1


class _Assemble(_Probe):
    def __init__(self, name, mask, v1=False):
        super().__init__(name, v1)
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
        ptrs = (x.data_ptr(), e.data_ptr(), out.data_ptr())
        if self.v1:
            self._launch("cs_probe_assemble_launch", dev, DTYPES[x.dtype], *ptrs, n, c,
                         _ASSEMBLE_ROWS, self.mask, sizes=4)
        else:
            self._launch("cs_probe_gather_launch", dev, DTYPES[x.dtype], *ptrs, n, c,
                         self.mask, _vec(x, c, e, out), sizes=4)
        return out


class _Select(_Probe):
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
        ptrs = (k1.data_ptr(), k2.data_ptr(), out.data_ptr())
        if self.v1:
            self._launch("cs_probe_select_launch", dev, DTYPES[k1.dtype], *ptrs, programs, c,
                         d, sizes=3)
        else:
            self._launch("cs_probe_select_vec_launch", dev, DTYPES[k1.dtype], *ptrs, programs,
                         c, d, _vec(k1, c * d, k2, out), sizes=4)
        return out


class _Dot(_Probe):
    def __init__(self, name, shifted, v1=False):
        super().__init__(name, v1)
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
        ptrs = (x.data_ptr(), k.data_ptr(), out.data_ptr())
        if not self.v1:
            g = conv_plan(x.dtype, self.shifted, n, c, d, self._sm_count[dev])
            self._launch("cs_probe_conv_tc_launch", dev, DTYPES[x.dtype], *ptrs, n, c, d,
                         int(self.shifted), g.h, g.dn, g.smem, sizes=7)
        elif self.shifted:
            self._launch("cs_probe_shifted_launch", dev, DTYPES[x.dtype], *ptrs, n, c, d,
                         sizes=3)
        else:
            self._launch("cs_probe_dot_launch", dev, DTYPES[x.dtype], *ptrs, n * n, c, d,
                         sizes=3)
        return out


class _Bias(_Probe):
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


class _Dw(_Probe):
    def __init__(self, name, batched, v1=False):
        super().__init__(name, v1)
        self.batched = batched
        self.plain = dw_batched_plain if batched else dw_reshape_plain

    def __call__(self, x, g):
        """``x`` (n, n, C), ``g`` (n, n, D) -> (C, D) float32, see
        :func:`dw_reshape_plain` / :func:`dw_batched_plain`."""
        if x.device.type == "cpu":
            return self.plain(x, g)
        n, c, d = x.shape[0], x.shape[-1], g.shape[-1]
        _check(self.name, [(x, (n, n, c)), (g, (n, n, d))])
        dev = self._device(x)
        if self.v1:
            out = torch.empty((c, d), dtype=torch.float32, device=x.device)
            self._launch("cs_probe_dw_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                         g.data_ptr(), out.data_ptr(), n, c, d, int(self.batched), sizes=4)
            return out
        nsplit = dw_split(n, c, d, self.batched, self._sm_count[dev])
        part = torch.empty((nsplit, c, d), dtype=torch.float32, device=x.device)
        self._launch("cs_probe_dw_tc_launch", dev, DTYPES[x.dtype], x.data_ptr(),
                     g.data_ptr(), part.data_ptr(), n, c, d, int(self.batched), nsplit, sizes=5)
        return part[0] if nsplit == 1 else part.sum(dim=0)


lane_store = _LaneStore("lane_store")
lane_store_v1 = _LaneStore("lane_store_v1", v1=True)


def _probes(v1=False):
    """Every probe of tools/mosaic_bisect{,2,3}.py by the reference's name;
    ``v1``: the kernels the redesign replaced (the bias probe has none)."""
    tag = "_v1" if v1 else ""
    rows = GHOST_S | GHOST_N
    out = {
        "A-assembly": _Assemble("probe_assemble" + tag, rows | GHOST_W | GHOST_E, v1),
        "B-select": _Select("probe_select" + tag, v1),
        "C-dot": _Dot("probe_dot" + tag, False, v1),
        "D-shifted-dots": _Dot("probe_shifted_dots" + tag, True, v1),
        "E-bias": None if v1 else _Bias("probe_bias"),
        "rows-int-idx": _Assemble("probe_rows_int" + tag, rows, v1),
        "rows-slice-idx": _Assemble("probe_rows_slice" + tag, rows, v1),
        "col-int-idx": _Assemble("probe_col_int" + tag, GHOST_W, v1),
        "col-newaxis": _Assemble("probe_col_newaxis" + tag, GHOST_W, v1),
        "reshape-collapse": _Dw("probe_dw_reshape" + tag, False, v1),
        "batched-dot": _Dw("probe_dw_batched" + tag, True, v1),
    }
    return {k: v for k, v in out.items() if v is not None}


PROBES = _probes()
PROBES_V1 = _probes(v1=True)
probe_assemble = PROBES["A-assembly"]
probe_select = PROBES["B-select"]
probe_dot = PROBES["C-dot"]
probe_shifted_dots = PROBES["D-shifted-dots"]
probe_bias = PROBES["E-bias"]
probe_rows_int = PROBES["rows-int-idx"]
probe_rows_slice = PROBES["rows-slice-idx"]
probe_col_int = PROBES["col-int-idx"]
probe_col_newaxis = PROBES["col-newaxis"]
probe_dw_reshape = PROBES["reshape-collapse"]
probe_dw_batched = PROBES["batched-dot"]
