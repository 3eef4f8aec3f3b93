"""Where the fused conv's time goes, at each U-Net level's shape.

The counterpart of the reference's ``tools/conv_micro.py``.  Rows (device
ms per call, CUDA graphs; ``None`` on the CPU):

  same     - cuDNN SAME per face group, no halo (wrong math; a lower bound)
  ext      - ``ext_strips`` alone (the gathers feeding the kernel)
  kernel   - kernel #12: the conv kernel on precomputed strips
  pallas   - the whole fused conv: ``ext_strips`` + kernel #1
  ringfix  - the ring-fix formulation (``cs_conv3x3_ringfix``)
  dx_pl    - the dx kernel (#4)
  dx_xla   - autograd of the ring-fix conv, input cotangent
  dw_xla   - autograd of the ring-fix conv, weight cotangents

Kernel #12's output is held bitwise against #1's on the same strips and
within one bf16 ulp of |ref| + 1e-4 of the plain conv, and #4's against its
plain version the same way; each level's row also carries #12's plain and
library times (the face-grouped cuDNN conv) and its bytes and operations.

    python -m dlwp_cs_tpu_torch.tools.conv_micro             # on the card
    python -m dlwp_cs_tpu_torch.tools.conv_micro --device cpu --small
"""

from __future__ import annotations

import argparse
import sys

import torch

import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops.conv_variants import cs_conv3x3_kernel_only
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    cs_conv3x3,
    cs_conv3x3_dx,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
)
from dlwp_cs_tpu_torch.ops.padding import cs_pad
from dlwp_cs_tpu_torch.ops.ringfix import _same_conv, cs_conv3x3_ringfix
from dlwp_cs_tpu_torch.tools.timing import (
    add_device_args,
    check_close,
    device_ms,
    face_grouped,
    tool_device,
)

__all__ = ["LEVELS", "LEVELS_SMALL", "main", "run"]

# (n, Cin, Cout, batch) per U-Net level at the training batch (C48, b = 16)
LEVELS = [(48, 32, 32, 16), (24, 64, 64, 16), (12, 128, 128, 16)]
LEVELS_SMALL = [(8, 8, 8, 2), (4, 16, 16, 2)]
ROWS = ("same", "ext", "kernel", "pallas", "ringfix", "dx_pl", "dx_xla", "dw_xla")
REPS = 20


def run(levels, dtype, device, reps: int = REPS):
    """One row per level: the shape, the device ms of each of ``ROWS``,
    whether #12 equals #1 bitwise (it must: the same kernel on the same
    strips), #12's and #4's errors against their plain versions, and #12's
    plain and library ms, bytes and operations.  Every row's function runs
    once on any device; times only on the card."""
    device = torch.device(device)
    gen = torch.Generator().manual_seed(0)
    out = []
    for n, cin, cout, b in levels:
        if cin != cout:  # dx_pl's chain input is the cotangent
            raise ValueError(f"conv_micro levels need Cin == Cout, got {cin}, {cout}")
        x = torch.randn((b, 6, n, n, cin), generator=gen).to(device, dtype)
        ke, kp = ((torch.randn((3, 3, cin, cout), generator=gen) * 0.1).to(device, dtype)
                  for _ in range(2))
        be = bp = torch.zeros(cout, device=device, dtype=dtype)
        g = torch.randn((b, 6, n, n, cout), generator=gen).to(device, dtype)
        ext = ext_strips(x)
        kernel_out = cs_conv3x3_kernel_only(x, ext, ke, kp, be, bp)
        fused_out = cs_conv3x3(x, ext, ke, kp, be, bp)
        equal = bool(torch.equal(kernel_out, fused_out))
        if not equal:
            raise RuntimeError(f"kernel #12 differs from #1 at n={n}, C={cin}")
        kernel_err = check_close(f"kernel #12 at n={n}, C={cin}", kernel_out,
                                  cs_conv3x3_plain(x, ext, ke, kp, be, bp))
        dx_err = check_close(f"kernel #4 at n={n}, C={cin}", cs_conv3x3_dx(x, ke, kp),
                              cs_conv3x3_dx_plain(x, ke, kp))
        # one cuDNN call computing #12's function: the padded faces (built
        # outside the timed call) through a conv grouped by face
        padded, w = face_grouped(cs_pad(x, 1), (ke, kp))

        def ringfix(v):
            return cs_conv3x3_ringfix(v, ke, kp, bias_eq=be, bias_pole=bp)

        def dx_xla():
            v = x.detach().requires_grad_(True)
            return torch.autograd.grad(ringfix(v), v, x)[0]

        def dw_xla():
            ks = [k.detach().requires_grad_(True) for k in (ke, kp)]
            return torch.autograd.grad(
                cs_conv3x3_ringfix(x, *ks, bias_eq=be, bias_pole=bp), ks, g)

        fns = {
            "same": lambda: torch.cat([_same_conv(x[:, :4], ke), _same_conv(x[:, 4:], kp)], 1),
            "ext": lambda: ext_strips(x),
            "kernel": lambda: cs_conv3x3_kernel_only(x, ext, ke, kp, be, bp),
            "pallas": lambda: cs_conv3x3(x, ext_strips(x), ke, kp, be, bp),
            "ringfix": lambda: ringfix(x),
            "dx_pl": lambda: cs_conv3x3_dx(x, ke, kp),
            "dx_xla": dx_xla,
            "dw_xla": dw_xla,
        }
        row = {"n": n, "cin": cin, "cout": cout, "batch": b, "kernel_equals_fused": equal,
               "kernel_max_abs_err": kernel_err, "dx_max_abs_err": dx_err,
               "flops": 2 * b * 6 * n * n * 9 * cin * cout,
               "kernel_plain_ms": device_ms(
                   lambda: cs_conv3x3_plain(x, ext, ke, kp, be, bp), 3, device),
               "kernel_library_ms": device_ms(lambda: F.conv2d(padded, w, groups=6), reps,
                                              device),
               "bytes": x.element_size() * (x.numel() + ext.numel() + 2 * ke.numel()
                                            + 2 * cout + b * 6 * n * n * cout)}
        row["ops"] = row["flops"]
        for name in ROWS:
            with torch.no_grad() if name not in ("dx_xla", "dw_xla") else torch.enable_grad():
                fns[name]()
                row[name] = device_ms(fns[name], reps, device)
        out.append(row)
    return out


def main(argv=None, out=None) -> int:
    """The command line; ``out``, a list, receives the rows (for a caller
    that reads the numbers, as ``chip_smoke.py`` does)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)
    rows = run(LEVELS_SMALL if args.small else LEVELS, torch.bfloat16, device)
    if out is not None:
        out.extend(rows)
    name = torch.cuda.get_device_name(device) if device.type == "cuda" else "cpu (no times)"
    print(f"device={name}")
    for r in rows:
        line = " ".join(f"{k}={'-' if r[k] is None else '%.4f' % r[k]}ms" for k in ROWS)
        tf = "" if r["pallas"] is None else f"  pallas={r['flops'] / r['pallas'] / 1e9:.1f}TF/s"
        print(f"n={r['n']:3d} c={r['cin']:3d}: {line}{tf}  kernel==pallas "
              f"{r['kernel_equals_fused']}, kernel vs plain {r['kernel_max_abs_err']:.3g}, "
              f"dx_pl vs plain {r['dx_max_abs_err']:.3g}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
