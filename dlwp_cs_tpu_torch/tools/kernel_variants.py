"""Formulations of the small-channel cubed-sphere conv on the tensor cores
and the CUDA cores, side by side.

The counterpart of the reference's ``tools/kernel_variants.py``, at its
shape (n, C, B) = (48, 32, 16), bfloat16.  Rows (device ms per call, CUDA
graphs; ``None`` on the CPU):

  base       - kernel #1 (``ext_strips`` + the fused conv kernel)
  npack      - kernel #3: kn2row on the tensor cores, taps (C, 9*C)
  im2col     - kernel #13: im2col on the tensor cores, weights (9*C, C)
  bdpack     - #1 on the batch->lane packed layout (4 items in the channels,
               block-diagonal taps), the pack and unpack reshapes included
  bdonly     - the same without the reshapes
  im2col_p   - #13 on the packed layout, reshapes included
  im2colonly - the same without the reshapes
  xla_same, xla_same_p    - cuDNN SAME per face group (unpacked, packed)
  vjp_same, vjp_same_p    - its autograd input cotangent
  dw_same, dw_same_p      - its autograd weight cotangent
  dx_cur     - the dx kernel (#4)
  dx_align   - the dx kernel writing the raw ring (#14)
  dec_base, dec_pack2     - #1 at the decoder's Cin = 96, Cout = 32, and on
               the layout packed by 2
  lane_store - kernel #15, 3·x

The rows the reference checks are held against ``base`` (``dec_pack2``
against ``dec_base``, ``lane_store`` against 3·x) and their errors printed;
one that exceeds one bf16 ulp of |base| + 1e-4 raises.  Every row that
launches a kernel of the port is also held against the same function
through the kernel's plain version, on the same inputs, within the same
bound.  ``--chain``: #1 conv-relu-conv against one conv.

    python -m dlwp_cs_tpu_torch.tools.kernel_variants [--chain]   # on the card
    python -m dlwp_cs_tpu_torch.tools.kernel_variants --device cpu --small
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.conv_variants import (
    cs_conv3x3_dx_ring,
    cs_conv3x3_dx_ring_plain,
    cs_conv3x3_im2col,
    cs_conv3x3_im2col_plain,
    cs_conv3x3_npack,
    cs_conv3x3_npack_plain,
    im2col_taps,
    npack_taps,
)
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    cs_conv3x3,
    cs_conv3x3_dx,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
)
from dlwp_cs_tpu_torch.ops.ringfix import _same_conv
from dlwp_cs_tpu_torch.tools.probes import lane_store, lane_store_plain
from dlwp_cs_tpu_torch.tools.timing import (
    add_device_args,
    bf16_excess,
    check_close,
    device_ms,
    tool_device,
)

__all__ = ["SHAPE", "SHAPE_SMALL", "chain", "main", "run"]

SHAPE = (48, 32, 16)  # (n, C, B)
SHAPE_SMALL = (8, 8, 4)
PACK = 4  # batch items packed into the channels
DEC_CIN = 96  # the decoder conv's input channels (Cout = C)
REPS = 20


def _pack_batch(x, p):
    """(B, 6, n, m, C) -> (B/p, 6, n, m, p*C), p-major in the channels."""
    b, f, n, m, c = x.shape
    return x.reshape(b // p, p, f, n, m, c).permute(0, 2, 3, 4, 1, 5).reshape(
        b // p, f, n, m, p * c)


def _unpack_batch(y, p):
    """Inverse of :func:`_pack_batch`."""
    bp, f, n, m, pc = y.shape
    return y.reshape(bp, f, n, m, p, pc // p).permute(0, 4, 1, 2, 3, 5).reshape(
        bp * p, f, n, m, pc // p)


def _block_diag_taps(k, p):
    """(3, 3, Cin, Cout) -> (3, 3, p*Cin, p*Cout), block-diagonal per tap."""
    kh, kw, cin, cout = k.shape
    eye = torch.eye(p, dtype=k.dtype, device=k.device)
    return torch.einsum("ij,hwcd->hwicjd", eye, k).reshape(kh, kw, p * cin, p * cout)


# (kernel wrapper, its plain version) of the rows that launch one
CONV = (cs_conv3x3, cs_conv3x3_plain)
NPACK = (cs_conv3x3_npack, cs_conv3x3_npack_plain)
IM2COL = (cs_conv3x3_im2col, cs_conv3x3_im2col_plain)
DX = (cs_conv3x3_dx, cs_conv3x3_dx_plain)
DX_RING = (cs_conv3x3_dx_ring, cs_conv3x3_dx_ring_plain)
STORE = (lane_store, lane_store_plain)


def run(device, small: bool = False, reps: int = REPS):
    """The rows of the module docstring: ``{name: {"ms": ..., "max_abs_err":
    ... or None, "plain_max_abs_err": ... or None}}`` plus ``"shape"``.
    Every row's function runs once on any device (a kernel's row once more
    through its plain version); times only on the card."""
    device = torch.device(device)
    n, c, b = SHAPE_SMALL if small else SHAPE
    dt = torch.bfloat16
    gen = torch.Generator().manual_seed(0)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dt)

    x = rand(b, 6, n, n, c)
    ke, kp = rand(3, 3, c, c, scale=0.2), rand(3, 3, c, c, scale=0.2)
    zb = torch.zeros(c, device=device, dtype=dt)
    ke9, kp9 = npack_taps(ke), npack_taps(kp)
    kem, kpm = im2col_taps(ke), im2col_taps(kp)
    keb, kpb = _block_diag_taps(ke, PACK), _block_diag_taps(kp, PACK)
    kebm, kpbm = im2col_taps(keb), im2col_taps(kpb)
    zbp = torch.zeros(PACK * c, device=device, dtype=dt)
    xp = _pack_batch(x, PACK)
    g = rand(b, 6, n, n, c)

    def same(v, k1, k2):
        return torch.cat([_same_conv(v[:, :4], k1), _same_conv(v[:, 4:], k2)], dim=1)

    def grad_of(fn, wrt):  # the cotangent of fn's output g, pulled back to wrt
        def call(_):
            t = wrt.detach().requires_grad_(True)
            return torch.autograd.grad(fn(t), t, g)[0]
        return call

    def with_ext(v):
        return v, ext_strips(v)

    def same_k(v, k):  # one kernel for both groups, as the reference's dw row
        return same(v, k, k)

    def same_k_packed(v, k):
        kb = _block_diag_taps(k, PACK)
        return _unpack_batch(same(_pack_batch(v, PACK), kb, kb), PACK)

    xd = rand(b, 6, n, n, DEC_CIN)
    ke2 = rand(3, 3, DEC_CIN, c, scale=0.1)
    kb2 = _block_diag_taps(ke2, 2)
    zb2 = torch.zeros(2 * c, device=device, dtype=dt)

    # name: (kernel and plain version or None, the row's function of the
    # kernel, the row it is checked against or None)
    rows = {
        "base": (CONV, lambda f: f(x, ext_strips(x), ke, kp, zb, zb), None),
        "npack": (NPACK, lambda f: f(x, ext_strips(x), ke9, kp9, zb, zb), "base"),
        "im2col": (IM2COL, lambda f: f(x, ext_strips(x), kem, kpm, zb, zb), "base"),
        "bdpack": (CONV, lambda f: _unpack_batch(f(
            *with_ext(_pack_batch(x, PACK)), keb, kpb, zbp, zbp), PACK), "base"),
        "bdonly": (CONV, lambda f: f(xp, ext_strips(xp), keb, kpb, zbp, zbp), "base_packed"),
        "im2col_p": (IM2COL, lambda f: _unpack_batch(f(
            *with_ext(_pack_batch(x, PACK)), kebm, kpbm, zbp, zbp), PACK), "base"),
        "im2colonly": (IM2COL, lambda f: f(xp, ext_strips(xp), kebm, kpbm, zbp, zbp),
                       "base_packed"),
        "xla_same": (None, lambda _: same(x, ke, kp), None),
        "xla_same_p": (None, lambda _: _unpack_batch(
            same(_pack_batch(x, PACK), keb, kpb), PACK), None),
        "vjp_same": (None, grad_of(lambda v: same(v, ke, kp), x), None),
        "vjp_same_p": (None, grad_of(lambda v: _unpack_batch(
            same(_pack_batch(v, PACK), keb, kpb), PACK), x), None),
        "dw_same": (None, grad_of(lambda k: same_k(x, k), ke), None),
        "dw_same_p": (None, grad_of(lambda k: same_k_packed(x, k), ke), None),
        "dx_cur": (DX, lambda f: f(g, ke, kp), None),
        "dx_align": (DX_RING, lambda f: f(g, ke, kp), None),
        "dec_base": (CONV, lambda f: f(xd, ext_strips(xd), ke2, ke2, zb, zb), None),
        "dec_pack2": (CONV, lambda f: _unpack_batch(f(
            *with_ext(_pack_batch(xd, 2)), kb2, kb2, zb2, zb2), 2), "dec_base"),
        "lane_store": (STORE, lambda f: f(x), "three_x"),
    }
    refs = {}
    out = {"shape": {"n": n, "c": c, "batch": b, "pack": PACK, "dec_cin": DEC_CIN},
           "flops": 2 * b * 6 * n * n * 9 * c * c}
    for name, (pair, body, against) in rows.items():
        grad = name.startswith(("vjp", "dw_"))
        kernel = pair[0] if pair else None
        with torch.enable_grad() if grad else torch.no_grad():
            got = body(kernel)
            ms = device_ms(lambda: body(kernel), reps, device)
            plain_err = None if pair is None else check_close(name, got, body(pair[1]))
        if name in ("base", "dec_base"):
            refs[name] = got
        if name == "base":
            refs["base_packed"] = _pack_batch(got, PACK)
            refs["three_x"] = 3 * x
        err = None
        if against is not None:
            ref = refs[against]
            err = float((got.float() - ref.float()).abs().max())
            if against == "three_x" and not torch.equal(got, ref):
                raise RuntimeError(f"{name} differs from 3*x: max |diff| {err}")
            if bf16_excess(got, ref) > 1e-4:
                raise RuntimeError(f"{name} disagrees with {against}: max |diff| {err}")
        out[name] = {"ms": ms, "max_abs_err": err, "against": against,
                     "plain_max_abs_err": plain_err}
    return out


def chain(device, small: bool = False, reps: int = REPS):
    """#1 conv-relu-conv against one conv: ``(single_ms, chain_ms)``."""
    device = torch.device(device)
    n, c, b = SHAPE_SMALL if small else SHAPE
    gen = torch.Generator().manual_seed(0)
    x, ke, kp = ((torch.randn(s, generator=gen) * sc).to(device, torch.bfloat16)
                 for s, sc in (((b, 6, n, n, c), 1.0), ((3, 3, c, c), 0.2), ((3, 3, c, c), 0.2)))
    zb = torch.zeros(c, device=device, dtype=torch.bfloat16)

    def single(v):
        return cs_conv3x3(v, ext_strips(v), ke, kp, zb, zb)

    def chain2(v):
        return single(F.leaky_relu(single(v), 0.1))

    chain2(x)
    return device_ms(lambda: single(x), reps, device), device_ms(lambda: chain2(x), reps, device)


def _fmt(ms):
    return "-" if ms is None else f"{ms:.4f}"


def main(argv=None, out=None) -> int:
    """The command line; ``out``, a list, receives what the run returned
    (for a caller that reads the numbers, as ``chip_smoke.py`` does)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    ap.add_argument("--chain", action="store_true", help="conv-relu-conv against one conv")
    args = ap.parse_args(argv)
    device = tool_device(args)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (no times)"
    print(f"device={name}")
    if args.chain:
        t1, t2 = chain(device, args.small)
        if out is not None:
            out.append({"single_ms": t1, "chain_ms": t2})
        ratio = "-" if t1 is None else f"{t2 / t1:.2f}"
        print(f"single conv {_fmt(t1)} ms   conv-relu-conv {_fmt(t2)} ms   ratio {ratio}")
        return 0
    rows = run(device, args.small)
    if out is not None:
        out.append(rows)
    for key, r in rows.items():
        if key in ("shape", "flops"):
            continue
        tf = "" if r["ms"] is None or key not in ("base", "npack", "im2col", "bdpack",
                                                  "bdonly", "im2col_p", "im2colonly") \
            else f"  {rows['flops'] / r['ms'] / 1e9:6.1f} TF/s"
        err = ("" if r["max_abs_err"] is None
               else f"  maxerr={r['max_abs_err']:.3e} vs {r['against']}")
        if r["plain_max_abs_err"] is not None:
            err += f"  maxerr={r['plain_max_abs_err']:.3e} vs plain"
        print(f"{key:10s} {_fmt(r['ms'])} ms{tf}{err}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
