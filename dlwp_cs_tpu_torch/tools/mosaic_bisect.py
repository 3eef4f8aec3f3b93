"""The reference's lowering probes as CUDA kernels, each held against its
plain version.

The counterpart of the reference's ``tools/mosaic_bisect.py``,
``mosaic_bisect2.py`` and ``mosaic_bisect3.py``: kA-kE at N = 48, C = D =
64; bisect2's four ghost-write variants at N = 48, C = 64; bisect3's two dw
formulations at (n, C, D) = (48, 32, 64), (24, 64, 64), (12, 128, 128).
Inputs are seeded random values (the reference compiles on zeros).  Each
probe prints ``OK`` with its error against its plain version and its device
time, or raises: the assembly, select and bias probes must be equal (no sum
is reordered), the products within 1e-5 of the largest reference entry
(f32 sums in another order) plus, for bfloat16 outputs, one bf16 ulp of the
entry (both sides round their sum once).  Each row also carries the
plain version's device time and that of one PyTorch call computing the
probe's function (:func:`library_call`), with its error, and the probe's
bytes and operations.  The four ghost-write variants' output window
``xpad[1:N+1, 2:N+2]`` holds no ghost row and no W column, so their
outputs (x's columns 1.., then zeros) cannot show whether those writes
happened; the assembly probe's E column can.

    python -m dlwp_cs_tpu_torch.tools.mosaic_bisect [--dtype float32]   # on the card
    python -m dlwp_cs_tpu_torch.tools.mosaic_bisect --device cpu --small
"""

from __future__ import annotations

import argparse
import sys

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.tools import probes
from dlwp_cs_tpu_torch.tools.timing import add_device_args, device_ms, tool_device

__all__ = ["DW_SHAPES", "compare", "library_call", "main", "run"]

N, C, D = 48, 64, 64
DW_SHAPES = [(48, 32, 64), (24, 64, 64), (12, 128, 128)]
EXACT = ("A-assembly", "B-select", "E-bias", "rows-int-idx", "rows-slice-idx", "col-int-idx",
         "col-newaxis")
REPS = 20


def _cases(device, dtype, small):
    """``(name, probe, args)`` of every probe, on seeded random inputs."""
    gen = torch.Generator().manual_seed(0)
    n, c, d = (8, 8, 8) if small else (N, C, D)

    def rand(*shape, scale=1.0):
        return (torch.randn(shape, generator=gen) * scale).to(device, dtype)

    x, e = rand(n, n, c), rand(4, n + 2, c)
    k4 = rand(3, 3, c, d, scale=(9 * c) ** -0.5)
    cases = [
        ("A-assembly", probes.probe_assemble, (x, e)),
        ("B-select", probes.probe_select, (k4, rand(3, 3, c, d))),
        ("C-dot", probes.probe_dot, (x, rand(c, d, scale=c**-0.5))),
        ("D-shifted-dots", probes.probe_shifted_dots, (x, k4)),
        ("E-bias", probes.probe_bias, (rand(n, n, d), rand(d))),
    ]
    for name in ("rows-int-idx", "rows-slice-idx", "col-int-idx", "col-newaxis"):
        cases.append((name, probes.PROBES[name], (x, e)))
    for nn, cc, dd in [(8, 8, 16), (4, 16, 16)] if small else DW_SHAPES:
        xs, gs = rand(nn, nn, cc), rand(nn, nn, dd)
        cases.append((f"reshape-collapse n={nn}", probes.probe_dw_reshape, (xs, gs)))
        cases.append((f"batched-dot n={nn}", probes.probe_dw_batched, (xs, gs)))
    return cases


def compare(name, got, ref):
    """``(max_abs_err, tolerance, ok)`` of probe ``name``'s output against
    its plain version's (see the module docstring)."""
    err = float((got.float() - ref.float()).abs().max())
    if name in EXACT:
        return err, "equal", bool(torch.equal(got, ref))
    bound = 1e-5 * float(ref.float().abs().max())
    tol = "1e-5*max|ref|"
    if got.dtype == torch.bfloat16:
        bound = bound + ref.float().abs() * 2.0**-7
        tol += " + 2**-7*|ref|"
    return err, tol, bool(((got.float() - ref.float()).abs() <= bound).all())


def library_call(probe, args):
    """``(call, as_probe)``: one PyTorch call computing ``probe``'s function
    on ``args`` (its operands laid out outside the call), and the map of its
    result to the probe's layout and type.  The dw products come out in the
    inputs' type (the probes return float32)."""
    x = args[0]
    same = lambda y: y  # noqa: E731
    if probe is probes.probe_assemble:  # x's columns 1.., then the E ghost column
        n, e = x.shape[0], args[1]
        return lambda: torch.cat([x[:, 1:], e[3, 1 : n + 1, None]], 1), same
    if isinstance(probe, probes._Assemble):  # no ghost cell in the output window
        return lambda: F.pad(x[:, 1:], (0, 0, 0, 1)), same
    if probe is probes.probe_select:  # programs 0 and 1 both take k1 (s < 4)
        return lambda: torch.stack([x[1, 1]] * 2), same
    if probe is probes.probe_dot:
        return lambda: torch.matmul(x, args[1]), same
    if probe is probes.probe_shifted_dots:
        xc = x.permute(2, 0, 1)[None].contiguous(memory_format=torch.channels_last)
        wc = args[1].permute(3, 2, 0, 1).contiguous()
        return (lambda: F.conv2d(xc, wc, padding=1)), lambda y: y[0].permute(1, 2, 0)
    if probe is probes.probe_bias:
        return lambda: torch.add(x, args[1]), same
    xs, gs = x.reshape(-1, x.shape[-1]).T, args[1].reshape(-1, args[1].shape[-1])
    return (lambda: torch.matmul(xs, gs)), lambda y: y.float()  # the dw probes


def _ops(probe, args, out):
    """The probe's arithmetic operations (0 for the copies and the select)."""
    x = args[0]
    if probe is probes.probe_dot:
        return 2 * out.numel() * x.shape[-1]
    if probe is probes.probe_shifted_dots:
        return 2 * out.numel() * 9 * x.shape[-1]
    if probe is probes.probe_bias:
        return out.numel()
    if probe in (probes.probe_dw_reshape, probes.probe_dw_batched):
        return 2 * out.numel() * x.shape[0] * x.shape[1]
    return 0


def run(device, dtype=torch.bfloat16, small: bool = False, reps: int = REPS):
    """Every probe once against its plain version (on the CPU the probe is
    its plain version), then timed on the card: one dict per probe with its
    name, error, tolerance and ms.  Raises at the first probe outside its
    tolerance.  Each row also has the plain version's and the library
    call's ms, the library call's error, and the bytes (each input read
    once, the output written once) and operations."""
    device = torch.device(device)
    rows = []
    for name, probe, args in _cases(device, dtype, small):
        got, ref = probe(*args), probe.plain(*args)
        err, tol, ok = compare(name, got, ref)
        if not ok:
            raise RuntimeError(f"{name}: {err} against its plain version ({tol})")
        library, as_probe = library_call(probe, args)
        rows.append({
            "name": name, "probe": probe.name, "dtype": str(dtype).split(".")[-1],
            "max_abs_err": err, "tolerance": tol,
            "library_max_abs_err": float((as_probe(library()).float() - ref.float()).abs().max()),
            "ms": device_ms(lambda: probe(*args), reps, device),
            "plain_ms": device_ms(lambda: probe.plain(*args), 5, device),
            "library_ms": device_ms(library, reps, device),
            "shapes": [tuple(a.shape) for a in args],
            "bytes": sum(a.numel() * a.element_size() for a in (*args, got)),
            "ops": _ops(probe, args, got)})
    return rows


def main(argv=None, out=None) -> int:
    """The command line; ``out``, a list, receives the rows (for a caller
    that reads the numbers, as ``chip_smoke.py`` does)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    add_device_args(ap)
    ap.add_argument("--dtype", default="bfloat16", choices=("bfloat16", "float32"))
    args = ap.parse_args(argv)
    device = tool_device(args)
    rows = run(device, getattr(torch, args.dtype), args.small)
    if out is not None:
        out.extend(rows)
    for r in rows:
        ms = " ".join("-" if r[k] is None else f"{r[k]:.4f}"
                      for k in ("ms", "plain_ms", "library_ms"))
        print(f"{r['name']}: OK (maxerr={r['max_abs_err']:.3e}, {r['tolerance']}) "
              f"{ms} ms (probe, plain, library)", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
