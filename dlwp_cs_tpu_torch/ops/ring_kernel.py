"""The xring cubed-sphere conv: cuDNN SAME convs + a hand-written ring-fix
kernel, and its backward.

The counterpart of ``dlwp_cs_tpu.ops.ring_kernel``::

    cs_conv3x3_xring(x, ...) = xring_fused_apply(same_conv(x, k_eq),
                                                 same_conv(x, k_pole),
                                                 ext_strips(x)) + bias

Two CUDA kernels (``csrc/cs_ring.cu``, whose header says what bounds them)
replace the Pallas kernels:

* :data:`ring_fixes` (``_ring_kernel``): the per-edge fixes and the corner
  corrections from the ghost strips, each rounded to the input dtype;
  :func:`ring_apply` adds them (the [S, N] and [W, E] pairs) onto a base
  in that dtype;
* :data:`xring_fused_apply` (``_fused_kernel``): the face select of the two
  SAME-conv bases, the fixes on the boundary ring and the corners
  subtracted, one f32 sum rounded once.

Both launch the ring blocks on the tensor cores (the fix dots as a GEMM of
the staged strips with each edge's taps), the fused apply with copy blocks
for the faces' interiors, with the numbers of :func:`ring_plan`.  Beside
each, its plain-torch version (:func:`ring_fixes_plain`,
:func:`xring_fused_apply_plain`), which CPU tensors take; on a CUDA tensor
the wrapper launches the kernel or raises, and counts the launch in its
``launches``.

:func:`cs_conv3x3_xring` is a ``torch.autograd.Function``.  Its backward
is :func:`split_vjp` (the default: the SAME convs' VJP on the split base,
the ring's transpose and Eᵀ, in plain torch; the reference has no backward
kernel here) or autograd through
:func:`~dlwp_cs_tpu_torch.ops.ringfix.cs_conv3x3_ringfix`
(``backward="ringfix"``).
"""

from __future__ import annotations

import functools
from dataclasses import dataclass

import torch
import torch.nn.functional as F
from torch.autograd.function import once_differentiable

from dlwp_cs_tpu_torch.ops.cuda_build import (
    DTYPES,
    I32,
    VP,
    CudaLibrary,
    KernelWrapper,
    check_cuda_args,
    check_faces,
)
from dlwp_cs_tpu_torch.ops.halo import _ext_transpose, ext_strips
from dlwp_cs_tpu_torch.ops.ringfix import (
    _corner_ghosts,
    _corner_taps,
    _edge_taps,
    _same_conv,
    _same_conv_vjp,
    _windows,
    add_group_bias,
    cs_conv3x3_ringfix,
    face_select,
    ring_apply,
    ring_contract,
)

__all__ = [
    "cs_conv3x3_xring",
    "grid_roles",
    "ring_apply",
    "ring_blocks",
    "ring_fixes",
    "ring_fixes_plain",
    "ring_geom",
    "ring_plan",
    "split_vjp",
    "xring_fused_apply",
    "xring_fused_apply_plain",
    "xring_fits",
]

_GROUPS = (slice(0, 4), slice(4, 6))  # equatorial, polar faces


def _fix_terms(ext, k_eq, k_pole):
    """f32 ``(fixes (B, 6, 4, n, D), corners (B, 6, 4, D))`` from the ghost
    strips and the kernels rounded to ``ext``'s dtype."""
    e32 = ext.float()
    fix_sn, fix_we, corners = ring_contract(e32[:, :, :2], e32[:, :, 2:],
                                            k_eq.to(ext.dtype), k_pole.to(ext.dtype))
    return torch.cat([fix_sn, fix_we], dim=2), corners


def ring_fixes_plain(ext, k_eq, k_pole):
    """Plain-torch ring fixes: ``ext`` (B, 6, 4, n+2, Cin) from
    :func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips`, HWIO kernels (3, 3, Cin,
    D) -> ``(fixes, corners)``, (B, 6, 4, n, D) in [S, N, W, E] edge order
    and (B, 6, 4, D) in [sw, se, nw, ne] corner order: f32 sums of
    ``ext``-dtype values, each rounded once to ``ext``'s dtype."""
    fixes, corners = _fix_terms(ext, k_eq, k_pole)
    return fixes.to(ext.dtype), corners.to(ext.dtype)


def xring_fused_apply_plain(base_eq, base_po, ext, k_eq, k_pole):
    """Plain-torch fused select + ring correction: ``base_*`` (B, 6, n, n,
    D) the two SAME-conv outputs, ``ext`` their input's ghost strips.
    ``select(base) + S|row 0 + N|row n-1 + W|col 0 + E|col n-1 - sw - se -
    nw - ne``, summed in f32 in that order and rounded once to
    ``base_eq``'s dtype."""
    n = base_eq.shape[2]
    fixes, cor = _fix_terms(ext, k_eq, k_pole)
    acc = face_select(base_eq, base_po).to(torch.float32, copy=True)
    acc[:, :, 0] += fixes[:, :, 0]
    acc[:, :, n - 1] += fixes[:, :, 1]
    acc[:, :, :, 0] += fixes[:, :, 2]
    acc[:, :, :, n - 1] += fixes[:, :, 3]
    acc[:, :, 0, 0] -= cor[:, :, 0]
    acc[:, :, 0, n - 1] -= cor[:, :, 1]
    acc[:, :, n - 1, 0] -= cor[:, :, 2]
    acc[:, :, n - 1, n - 1] -= cor[:, :, 3]
    return acc.to(base_eq.dtype)


# the card's shared memory per block (232,448 bytes) and the most a block may
# take for two to share an SM (1 KB each reserved)
_SMEM_LIMIT, _SMEM_TWO = 232448, (228 * 1024) // 2 - 1024


@dataclass(frozen=True)
class RingGeom:
    """The ring kernels' geometry, as ``csrc/cs_ring.cu::make_ring_geom``
    computes it: ``cp`` staged 16-bit units per strip position, ``kpe`` K
    rows per tap, ``dn`` channels per slice, ``nsplit`` slices, ``spb``
    strips per ring block, ``nch`` strip chunks per edge of the equatorial
    and the polar group, ``nring`` ring blocks, ``ncopy`` copy blocks,
    ``smem`` bytes."""

    esize: int
    batch: int
    n: int
    cin: int
    d: int
    cp: int
    kpe: int
    dn: int
    nsplit: int
    spb: int
    nch: tuple
    nring: int
    ncopy: int
    smem: int


def ring_geom(esize: int, b: int, n: int, cin: int, d: int, spb: int, dn: int, ncopy: int,
              apply: bool = True) -> RingGeom:
    """:class:`RingGeom` of one launch (``esize`` 4 float32, 2 bfloat16);
    ``ValueError`` on sizes the kernel refuses."""
    if (b < 1 or n < 2 or cin < 1 or d < 1 or not 1 <= spb <= 8 or dn < 16 or dn % 16
            or ncopy < 0 or (apply and n > 2 and ncopy < 1) or (not apply and ncopy)):
        raise ValueError(f"ring kernel: b={b}, n={n}, Cin={cin}, D={d}, spb={spb}, dn={dn}, "
                         f"ncopy={ncopy}")
    upe = esize // 2  # 16-bit units per element
    step = 8 // upe
    cpe = -(-cin // step) * step
    while (cpe * upe // 8) % 2 == 0:  # an odd multiple of 8 units
        cpe += step
    cp = cpe * upe
    kpe = -(-cin // (16 // upe)) * (16 // upe)
    nsplit = -(-d // dn)
    nch = (-(-4 * b // spb), -(-2 * b // spb))
    nring = 4 * sum(nch) * nsplit
    # staged cells: a strip's n + 2 positions and the corner dots' 4, then
    # one zero cell; the edge's 3 taps; the fused apply's base lines and
    # the flags of its corners; where Cin's bytes are not a multiple of 16,
    # each strip's raw copy
    a_units = (spb * (n + 6) + 1) * cp
    smem = 3 * kpe * (dn + 8) * esize + 2 * a_units
    if apply:
        smem += spb * n * (dn + 8) * esize + 4 * 2 * spb
    if (cin * esize) % 16:  # each strip's raw 16-byte copies, repacked into cells
        smem = -(-smem // 16) * 16 + spb * (-(-(n + 2) * cin * esize // 16) * 16 + 16)
    if smem > _SMEM_LIMIT:
        raise ValueError(f"ring kernel: {smem} bytes of shared memory for spb={spb}, dn={dn}")
    return RingGeom(esize, b, n, cin, d, cp, kpe, dn, nsplit, spb, nch, nring, ncopy, smem)


def ring_plan(dtype, b: int, n: int, cin: int, d: int, sm_count: int,
              apply: bool = True) -> RingGeom:
    """The ring kernels' launch: strips per ring block ``spb`` (1..8) and
    channels per slice ``dn`` (D split in 1, 2, 4, ... slices of a multiple
    of 16) whose block fits two to an SM where any does (else the card's
    shared memory), taking the most ring blocks that fit one wave of
    ``sm_count`` (at batch 1 the slices fill the card; at larger batches
    the chunks of strips), else the fewest; the fused apply's copy blocks
    fill the card twice (at most one per interior row).  Raises
    ``ValueError`` where no block fits."""
    esize = torch.empty((), dtype=dtype).element_size()
    rows = b * 6 * (n - 2)
    ncopy = min(rows, 2 * sm_count) if apply else 0
    dns, s = [], 1
    while True:
        dn = -(-(-(-d // s)) // 16) * 16
        if dn < 16 or (dns and dn == dns[-1]):
            break
        dns.append(dn)
        if dn == 16:
            break
        s *= 2
    geoms = []
    for dn in dns:
        for spb in range(1, min(8, 4 * b) + 1):
            try:
                geoms.append(ring_geom(esize, b, n, cin, d, spb, dn, ncopy, apply))
            except ValueError:
                pass
    pool = [g for g in geoms if g.smem <= _SMEM_TWO] or geoms
    if not pool:
        raise ValueError(f"ring kernel: n={n}, Cin={cin}, D={d} needs more shared memory "
                         "than one block has")
    wave = [g for g in pool if g.nring <= sm_count]
    if wave:
        return max(wave, key=lambda g: (g.nring, g.dn, -g.spb))
    return min(pool, key=lambda g: (g.nring, -g.dn, g.spb))


def grid_roles(g: RingGeom):
    """The fused apply's grid in launch order, as ``csrc/cs_ring.cu::
    cs_xring_tc_kernel`` assigns it: ``("ring", r)`` or ``("copy", q)`` per
    block, the two kinds alternating while both last, then the rest of the
    more numerous kind."""
    both = min(g.nring, g.ncopy)
    roles = []
    for b in range(g.nring + g.ncopy):
        if b < 2 * both:
            roles.append(("copy" if b & 1 else "ring", b >> 1))
        else:
            roles.append(("copy" if g.ncopy > g.nring else "ring", b - both))
    return roles


def ring_blocks(g: RingGeom, apply: bool = True):
    """What each block of the launch writes, in launch order: per block a
    list of ``(face, i, j, d0, d1)`` output runs (face = batch item * 6 +
    face of the cube; channels d0..d1-1) for the fused apply (a corner
    pixel under both of its ring blocks: the second of them to arrive
    writes it), or of ``("fix", face, edge, t, d0, d1)`` and ``("corner",
    face, c, d0, d1)`` for the fixes."""
    n = g.n
    rows = g.batch * 6 * (n - 2)
    out = []
    for kind, r in grid_roles(g) if apply else [("ring", r) for r in range(g.nring)]:
        if kind == "copy":
            runs = []
            for u in range(r, rows, g.ncopy):
                face, i = u // (n - 2), 1 + u % (n - 2)
                runs += [(face, i, j, 0, g.d) for j in range(1, n - 1)]
            out.append(runs)
            continue
        sl, q = r % g.nsplit, r // g.nsplit
        e, ch = divmod(q, sum(g.nch))
        grp = 0 if ch < g.nch[0] else 1
        ch -= g.nch[0] * grp
        nf, f0 = (2, 4) if grp else (4, 0)
        d0, d1 = sl * g.dn, min((sl + 1) * g.dn, g.d)
        runs = []
        for sg in range(ch * g.spb, min((ch + 1) * g.spb, g.batch * nf)):
            face = (sg // nf) * 6 + f0 + sg % nf
            for t in range(n):
                if apply:
                    runs.append((face, (0, n - 1, t, t)[e], (t, t, 0, n - 1)[e], d0, d1))
                else:
                    runs.append(("fix", face, e, t, d0, d1))
            if not apply and e < 2:
                runs += [("corner", face, 2 * e, d0, d1), ("corner", face, 2 * e + 1, d0, d1)]
        out.append(runs)
    return out

_RING_LIB = CudaLibrary("cs_ring.cu", {
    "cs_ring_tc_launch": [I32] * 3 + [VP] * 10 + [I32] * 9 + [VP],
    "cs_ring_fixes_launch": [I32, I32] + [VP] * 5 + [I32] * 6 + [VP],
    "cs_xring_apply_launch": [I32, I32] + [VP] * 6 + [I32] * 6 + [VP],
}, "cs_ring_error_string")


def _strips_shape(name, ext, k_eq, k_pole):
    """Check the CUDA arguments; ``(b, n, cin, d, k_eq, k_pole)`` with the
    kernels rounded to ``ext``'s dtype, as the kernels read them."""
    check_faces(name, ext, strips=True)
    b, _, _, np2, cin = ext.shape
    d = k_eq.shape[-1]
    k_eq = k_eq.to(ext.dtype).contiguous()
    k_pole = k_pole.to(ext.dtype).contiguous()
    check_cuda_args(name, ext, {
        "ext": (ext, (b, 6, 4, np2, cin)),
        "k_eq": (k_eq, (3, 3, cin, d)),
        "k_pole": (k_pole, (3, 3, cin, d)),
    })
    return b, np2 - 2, cin, d, k_eq, k_pole


class _RingFixesKernel(KernelWrapper):
    def __call__(self, ext, k_eq, k_pole):
        """Ring fixes and corners of the ghost strips ``ext`` (B, 6, 4, n+2,
        Cin) with HWIO kernels (3, 3, Cin, D), see :func:`ring_fixes_plain`."""
        if ext.device.type == "cpu":
            return ring_fixes_plain(ext, k_eq, k_pole)
        b, n, cin, d, k_eq, k_pole = _strips_shape("ring_fixes", ext, k_eq, k_pole)
        dev = self._device(ext)
        g = ring_plan(ext.dtype, b, n, cin, d, self._sm_count[dev], apply=False)
        fixes = torch.empty((b, 6, 4, n, d), dtype=ext.dtype, device=ext.device)
        corners = torch.empty((b, 6, 4, d), dtype=ext.dtype, device=ext.device)
        self._launch(
            "cs_ring_tc_launch", dev, DTYPES[ext.dtype], dev, 0,
            0, 0, *(t.data_ptr() for t in (ext, k_eq, k_pole)), 0, fixes.data_ptr(),
            corners.data_ptr(), 0, 0, b, n, cin, d, g.spb, g.dn, 0, 1, g.smem, sizes=9,
        )
        return fixes, corners


class _XringApplyKernel(KernelWrapper):
    def __init__(self, name, library):
        super().__init__(name, library)
        self._count_buffers = {}

    def __call__(self, base_eq, base_po, ext, k_eq, k_pole):
        """Fused select + ring correction of the SAME-conv outputs
        ``base_*`` (B, 6, n, n, D) with the ghost strips ``ext`` (B, 6, 4,
        n+2, Cin) of their input, see :func:`xring_fused_apply_plain`."""
        if base_eq.device.type == "cpu":
            return xring_fused_apply_plain(base_eq, base_po, ext, k_eq, k_pole)
        b, n, cin, d, k_eq, k_pole = _bases_shape("xring_fused_apply", base_eq, base_po, ext,
                                                  k_eq, k_pole)
        dev = self._device(ext)
        g = ring_plan(ext.dtype, b, n, cin, d, self._sm_count[dev])
        out = torch.empty_like(base_eq)
        # the corners' handoff between the S/N and the W/E ring blocks
        cx = torch.empty((b, 6, 4, 3, d), dtype=torch.float32, device=ext.device)
        cnt = self._counters(ext.device, b * 6 * 4 * g.nsplit)
        self._launch(
            "cs_ring_tc_launch", dev, DTYPES[ext.dtype], dev, 1,
            *(t.data_ptr() for t in (base_eq, base_po, ext, k_eq, k_pole, out)), 0, 0,
            cx.data_ptr(), cnt.data_ptr(), b, n, cin, d, g.spb, g.dn, g.ncopy,
            _copy_vec(d, base_eq, base_po, out), g.smem, sizes=9,
        )
        return out

    def _counters(self, device, size):
        """The handoff's arrival counts on ``device``: zero, and left zero by
        every launch (the second block of a corner resets its count), so
        one buffer per device serves every launch there as long as two
        launches never run at once (the port's callers issue them on one
        stream).  Made outside any CUDA-graph capture, grown as launches
        need.  Every buffer once handed out lives as long as the wrapper: a
        graph captured with an older, smaller buffer keeps its address, and
        a replay after the buffer grew counts in it, which is still zero
        and still its own.  The last one is the live one."""
        bufs = self._count_buffers.setdefault(device, [])
        if not bufs or bufs[-1].numel() < size:
            if device.type == "cuda" and torch.cuda.is_current_stream_capturing():
                raise RuntimeError(
                    f"{self.name}: call it once outside graph capture at this size first")
            bufs.append(torch.zeros(max(size, 4096), dtype=torch.int32, device=device))
        return bufs[-1]


def _bases_shape(name, base_eq, base_po, ext, k_eq, k_pole):
    """:func:`_strips_shape`, and the bases (B, 6, n, n, D) checked."""
    check_faces(name, base_eq)
    b, n, cin, d, k_eq, k_pole = _strips_shape(name, ext, k_eq, k_pole)
    check_cuda_args(name, ext, {
        "base_eq": (base_eq, (b, 6, n, n, d)),
        "base_po": (base_po, (b, 6, n, n, d)),
    })
    return b, n, cin, d, k_eq, k_pole


def _copy_vec(d, *tensors):
    """16-byte accesses where D and the addresses allow, else 1."""
    vec = 16 // tensors[0].element_size()
    return 1 if d % vec or any(t.data_ptr() % 16 for t in tensors) else vec


ring_fixes = _RingFixesKernel("ring_fixes", _RING_LIB)
xring_fused_apply = _XringApplyKernel("xring_fused_apply", _RING_LIB)


def _xring_forward(x, k_eq, k_pole, b_eq, b_pole, apply=None):
    # the dual base: two full 6-face SAME convs, the select in the kernel
    # (``apply``: the wrapper, looked up at the call, or its registered
    # operator, ops/library.py)
    apply = xring_fused_apply if apply is None else apply
    out = apply(_same_conv(x, k_eq), _same_conv(x, k_pole), ext_strips(x), k_eq, k_pole)
    return add_group_bias(out, b_eq, b_pole)


def _boundary_cotangents(g):
    """Cotangents of (fixes, corners) under :func:`ring_apply`: the fix
    strips receive g's boundary lines (+), the corners g's corner cells (-)."""
    n = g.shape[2]
    d_fix = torch.stack(
        [g[:, :, 0, :, :], g[:, :, n - 1, :, :], g[:, :, :, 0, :], g[:, :, :, n - 1, :]],
        dim=2,
    )  # (B, 6, 4, n, D) in [S, N, W, E] order
    d_cor = -torch.stack(
        [g[:, :, 0, 0], g[:, :, 0, n - 1], g[:, :, n - 1, 0], g[:, :, n - 1, n - 1]],
        dim=2,
    )  # (B, 6, 4, D) in [sw, se, nw, ne] order
    return d_fix, d_cor


def _ring_transpose(ext, d_fix, d_cor, k_eq, k_pole):
    """Transpose of ``(ext, taps) -> (fixes, corners)`` in ``ext``'s dtype:
    ``(d_ext, dk_eq, dk_pole)``, the kernel cotangents (3, 3, Cin, D) of the
    ring's taps only (the SAME convs' dk adds separately).  The window
    transpose is three shifted zero-pads."""
    b, _, _, np2, cin = ext.shape
    n = np2 - 2
    d = d_fix.shape[-1]
    dt = ext.dtype
    d_fix = d_fix.to(dt)
    d_cor = d_cor.to(dt)
    d_ext_groups, dk_ring = [], []
    for faces, k in zip(_GROUPS, (k_eq, k_pole)):
        taps = _edge_taps(k).reshape(4, 3 * cin, d).to(dt)
        dfg = d_fix[:, faces]  # (B, F, 4, n, D)
        nf = dfg.shape[1]
        d_win = torch.einsum("bfend,ekd->bfenk", dfg, taps).reshape(b, nf, 4, n, 3, cin)
        # strip position s receives d_win[t, dy] for every t + dy == s
        d_ext_g = (
            F.pad(d_win[..., 0, :], (0, 0, 0, 2))
            + F.pad(d_win[..., 1, :], (0, 0, 1, 1))
            + F.pad(d_win[..., 2, :], (0, 0, 2, 0))
        )  # (B, F, 4, n+2, C)
        # corners: the ends of the S/N strips fed the corner dots
        ck = _corner_taps(k).to(dt)  # (4, C, D)
        dcg = d_cor[:, faces]  # (B, F, 4, D)
        sw, se, nw, ne = torch.einsum("bfed,ecd->bfec", dcg, ck).unbind(2)
        s_line = F.pad(sw[:, :, None], (0, 0, 0, n + 1)) + F.pad(se[:, :, None], (0, 0, n + 1, 0))
        n_line = F.pad(nw[:, :, None], (0, 0, 0, n + 1)) + F.pad(ne[:, :, None], (0, 0, n + 1, 0))
        zeros = torch.zeros_like(s_line)
        d_ext_groups.append(d_ext_g + torch.stack([s_line, n_line, zeros, zeros], dim=2))

        # tap gradients of the ring part: per batch item, then summed
        eg = ext[:, faces]
        win = _windows(eg)
        d_taps = torch.einsum("bfenk,bfend->bekd", win, dfg).sum(dim=0)
        d_s, d_n, d_w, d_e = d_taps.reshape(4, 3, cin, d).unbind(0)
        dsw, dse, dnw, dne = torch.einsum("bfec,bfed->ecd", _corner_ghosts(eg), dcg).unbind(0)
        z = torch.zeros_like(d_s[0])
        row0 = torch.stack([d_s[0] + d_w[0] + dsw, d_s[1], d_s[2] + d_e[0] + dse])
        row1 = torch.stack([d_w[1], z, d_e[1]])
        row2 = torch.stack([d_n[0] + d_w[2] + dnw, d_n[1], d_n[2] + d_e[2] + dne])
        dk_ring.append(torch.stack([row0, row1, row2], dim=0))
    return torch.cat(d_ext_groups, dim=1), dk_ring[0], dk_ring[1]


def split_vjp(x, k_eq, k_pole, b_eq, b_pole, g):
    """VJP of the CS conv's linear map: the SAME convs' VJP on the split
    base (faces 0:4 with ``k_eq``, 4:6 with ``k_pole``), the ring's explicit
    transpose and Eᵀ.  Returns ``(dx, dk_eq, dk_pole, db_eq, db_pole)``; in
    bf16 the ring's dk is added to the SAME conv's in that dtype, as the
    reference does."""
    g = g.to(x.dtype)
    dx_eq, dk_eq_base = _same_conv_vjp(x[:, :4], k_eq, g[:, :4])
    dx_po, dk_po_base = _same_conv_vjp(x[:, 4:], k_pole, g[:, 4:])
    d_fix, d_cor = _boundary_cotangents(g)
    d_ext, dk_eq_ring, dk_po_ring = _ring_transpose(ext_strips(x), d_fix, d_cor, k_eq, k_pole)
    dx = torch.cat([dx_eq, dx_po], dim=1) + _ext_transpose(d_ext.contiguous())
    g32 = g.float()
    db_eq = g32[:, :4].sum(dim=(0, 1, 2, 3)).to(b_eq.dtype)
    db_po = g32[:, 4:].sum(dim=(0, 1, 2, 3)).to(b_pole.dtype)
    return (
        dx,
        dk_eq_base + dk_eq_ring.to(dk_eq_base.dtype),
        dk_po_base + dk_po_ring.to(dk_po_base.dtype),
        db_eq,
        db_po,
    )


class _XringConv(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, k_eq, k_pole, b_eq, b_pole, backward):
        ctx.save_for_backward(x, k_eq, k_pole, b_eq, b_pole)
        ctx.backward_mode = backward
        return _xring_forward(x, k_eq, k_pole, b_eq, b_pole)

    @staticmethod
    @once_differentiable
    def backward(ctx, g):
        saved = ctx.saved_tensors
        if ctx.backward_mode == "split":
            return (*split_vjp(*saved, g), None)
        with torch.enable_grad():
            ins = [t.detach().requires_grad_(True) for t in saved]
            out = cs_conv3x3_ringfix(ins[0], ins[1], ins[2], bias_eq=ins[3], bias_pole=ins[4])
            return (*torch.autograd.grad(out, ins, g), None)


def cs_conv3x3_xring(x, k_eq, k_pole, b_eq, b_pole, backward: str = "split"):
    """CS conv, 3x3/stride-1, ``(B, 6, n, n, Cin) -> (B, 6, n, n, Cout)``:
    cuDNN SAME convs + the fused ring kernel.  The same map as
    ``cs_conv3x3_ringfix`` / ``cs_pad`` + VALID conv; kernels (3, 3, Cin,
    Cout) and biases (Cout,) are required (pass zeros), all of ``x``'s
    dtype.  ``backward``: ``"split"`` (:func:`split_vjp`) or ``"ringfix"``
    (autograd through ``cs_conv3x3_ringfix``)."""
    if backward not in ("split", "ringfix"):
        raise ValueError(f"unknown xring backward {backward!r}")
    if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
        raise ValueError(f"expected (B, 6, n, n, C), got {tuple(x.shape)}")
    return _XringConv.apply(x.contiguous(), k_eq, k_pole, b_eq, b_pole, backward)


@functools.lru_cache(maxsize=None)
def xring_fits(dtype, b, n, cin, cout, sm_count) -> bool:
    """Whether the fused ring kernel that :func:`cs_conv3x3_xring` launches
    on a card of ``sm_count`` SMs plans the conv ``(b, 6, n, n, cin) ->
    cout`` in ``dtype`` (:func:`ring_plan`; the backward is torch).  Only
    the plan's ``ValueError`` is caught, and nothing is launched."""
    try:
        ring_plan(dtype, b, n, cin, cout, sm_count)
    except ValueError:
        return False
    return True
