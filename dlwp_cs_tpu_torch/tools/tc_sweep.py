"""Time the tensor-core conv, dx and dw kernels under many plans, on the card.

The forward (#1) and dx (#4) kernels take their tiles, slices and walks
from ``ops/hopper_conv.py::tc_plan``, the dw kernel (#5) its items, blocks
and K slices from ``dw_tc_plan``, in bfloat16 and (3xTF32) float32.  This
tool times, at each conv shape of the flagship C48 U-Net (the forward also
at n = 96), the plans around the plan's own: for the forward and dx,
slices of 8-64 channels (the float32 forward: 8-32), 1-8 n8 tiles per warp
(float32: 1-4), tiles of whole rows up to 256 pixels, and tiles per block
around the grid that keeps the SMs full; for dw, items of whole face rows,
the blocks' Cin and Cout groups and the K slices for 1-8 blocks per SM.
Every plan's output is held against the plain version (forward and dx:
bfloat16 one bf16 ulp of |ref| + 1e-4, float32 1e-4; dw 1e-5 of the
largest entry).  Rows: the shape, cuDNN's time (the face-grouped conv, its
dgrad for dx, its wgrad for dw; float32 with TF32 off), the time of the
plan's own choice and the fastest plans.  ``_tc_score`` (the training-batch
choice) and the float32 plans were fitted on these rows (an H100, batch
16).

    python -m dlwp_cs_tpu_torch.tools.tc_sweep [--dtype float32] [--kind fwd,dx,dw] [--out FILE.json]   # on the card
"""

from __future__ import annotations

import argparse
import json
import sys

import torch
import torch.nn.functional as F

from dlwp_cs_tpu_torch.ops import hopper_conv as hc
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.padding import cs_pad
from dlwp_cs_tpu_torch.tools.timing import bf16_excess, face_grouped, graph_ms

__all__ = ["SHAPES", "candidates", "dw_candidates", "main", "run"]

# (n, Cin, Cout) of the flagship U-Net's convs, and n = 96
SHAPES = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
          (12, 128, 128), (24, 192, 64), (48, 96, 32), (96, 64, 64)]
HEIGHTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)


def candidates(b, rows, cols, kch, nch, dx, sm_count, esize=2):
    """The plans around ``tc_plan``'s for ``esize``-byte elements: ``(h, cs,
    nw, tpb, smem)`` each."""
    out = []
    widest = min(64 if esize == 2 or dx else 32, max(8, 1 << (nch - 1).bit_length()))
    hs = [h for h in range(1, rows + 1) if h * cols <= 256]
    hs = [h for h in hs if h in HEIGHTS or h == hs[-1]]
    for cs in (8, 16, 32, 64):
        for h in hs if cs <= widest else ():
            for wn in (1, 2, 4):
                nw = cs // 8 // wn
                if nw < 1 or nw * 8 * wn != cs:
                    continue
                try:
                    g = hc.tc_geom(rows, cols, kch, nch, h, cs, nw, dx, esize)
                except ValueError:
                    continue
                if g.smem > hc._SMEM_LIMIT - 1024:
                    continue
                tiles = b * 6 * g.ntr * g.nslices
                auto = max(1, -(-tiles // (hc._tc_blocks_per_sm(g) * sm_count)))
                for tpb in sorted({1, auto, max(1, auto // 2), 2 * auto}):
                    if tpb == 1 or tiles // tpb >= sm_count // 2:
                        out.append((h, cs, nw, tpb, g.smem))
    return out


def dw_candidates(b, n, cin, cout, sm_count, esize=2):
    """The dw plans around ``dw_tc_plan``'s for ``esize``-byte elements:
    ``(rows, nsplit, cig, ng, smem)`` each, items of whole rows dividing the
    face, K slices for 1, 2, 4 and 8 blocks per SM."""
    out = []
    for rows in [r for r in range(1, n + 1) if n % r == 0]:
        for cig, ng in ((1, 1), (2, 1), (1, 2)):
            g = hc.dw_tc_geom(b, n, cin, cout, rows, 1, cig, ng, esize)
            if g.smem > hc._SMEM_LIMIT - 1024:
                continue
            for bps in (1, 2, 4, 8):
                out.append(g._replace(nsplit=hc._dw_nsplit(g, b, n, cin, cout, sm_count,
                                                           bps)).args())
    return sorted(set(out))


def _sweep(launch, check, plans, reps):
    rows = []
    for plan in plans:
        launch(plan)
        torch.cuda.synchronize()
        if not check():
            raise RuntimeError(f"plan {plan} disagrees with the plain version")
        rows.append((graph_ms(lambda: launch(plan), reps), plan))
    return sorted(rows)


def run(batches=(16, 1), dx_batch=16, reps=10, dtype=torch.bfloat16, kinds=("fwd", "dx")):
    """The rows of the module docstring, as dicts, for each of ``kinds``
    (``"fwd"`` at ``batches``, ``"dx"`` and ``"dw"`` at ``dx_batch``); the
    full table of each shape under ``"all"``."""
    dev, bf = torch.device("cuda"), torch.bfloat16
    f32 = dtype == torch.float32
    esize, code = (4, 0) if f32 else (2, 1)
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device=dev).manual_seed(0)

    def rand(*shape, scale=1.0, dt=bf):
        return (torch.randn(shape, generator=gen, device=dev) * scale).to(dt)

    def row(kind, b, n, cin, cout, lib_ms, own, rows):
        own_ms = next((t for t, p in rows if p == own), None)
        return {"kind": kind, "dtype": str(dtype).split(".")[-1], "batch": b, "n": n,
                "cin": cin, "cout": cout, "library_ms": lib_ms, "plan": own, "plan_ms": own_ms,
                "best": rows[:5], "all": rows}

    def close(y, ref):
        if f32:
            return float((y - ref).abs().max()) <= 1e-4
        return bf16_excess(y, ref) <= 1e-4

    out = []
    for b in batches if "fwd" in kinds else ():
        for n, cin, cout in SHAPES:
            x = rand(b, 6, n, n, cin, dt=dtype)
            ks = [rand(3, 3, cin, cout, scale=(9 * cin) ** -0.5, dt=dtype) for _ in range(2)]
            bs = [rand(cout, scale=0.1, dt=dtype) for _ in range(2)]
            e = ext_strips(x)
            y = torch.empty((b, 6, n, n, cout), dtype=dtype, device=dev)
            ref = hc.cs_conv3x3_plain(x, e, *ks, *bs)
            ptrs = [t.data_ptr() for t in (x, e, *ks, *bs, y)]

            def launch(plan, ptrs=ptrs, b=b, n=n, cin=cin, cout=cout):
                hc.cs_conv3x3._launch("cs_conv3x3_launch", dev.index or 0, code, dev.index or 0,
                                      *ptrs, b, n, n, cin, cout, *plan, 0, sizes=11)

            rows = _sweep(launch, lambda y=y, ref=ref: close(y, ref),
                          candidates(b, n, n, cin, cout, False, sms, esize), reps)
            p, w = face_grouped(cs_pad(x, 1), ks)
            bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
            lib = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), reps)
            out.append(row("fwd", b, n, cin, cout, lib,
                           hc.tc_plan(b, n, n, cin, cout, sms, esize=esize).args(), rows))
            yield out[-1]
    b = dx_batch
    for n, cin, cout in SHAPES[1:8] if "dx" in kinds else ():
        g = rand(b, 6, n, n, cout, dt=dtype)
        ks = [rand(3, 3, cin, cout, scale=(9 * cout) ** -0.5, dt=dtype) for _ in range(2)]
        dx = torch.empty((b, 6, n, n, cin), dtype=dtype, device=dev)
        de = torch.empty((b, 6, 4, n + 2, cin), dtype=dtype, device=dev)
        ref = hc.cs_conv3x3_dx_plain(g, *ks)
        ptrs = [t.data_ptr() for t in (g, *ks, dx, de)]

        def launch(plan, ptrs=ptrs, n=n, cin=cin, cout=cout):
            hc.cs_conv3x3_dx._launch("cs_conv3x3_dx_launch", dev.index or 0, code,
                                     dev.index or 0, *ptrs, b, n, cin, cout, *plan, sizes=9)

        rows = _sweep(launch, lambda dx=dx, de=de, ref=ref: close(dx, ref[0]) and close(de, ref[1]),
                      candidates(b, n + 2, n + 2, cout, cin, True, sms, esize), reps)
        xz = torch.zeros((b, 6, n, n, cin), dtype=dtype, device=dev)
        p, w = face_grouped(cs_pad(xz, 1), ks)
        go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
        lib = graph_ms(lambda: torch.ops.aten.convolution_backward(
            go, p, w, [6 * cout], [1, 1], [0, 0], [1, 1], False, [0, 0], 6,
            [True, False, False]), reps)
        out.append(row("dx", b, n, cin, cout, lib,
                       hc.tc_plan(b, n + 2, n + 2, cout, cin, sms, dx=True, esize=esize).args(),
                       rows))
        yield out[-1]
    for n, cin, cout in SHAPES[:8] if "dw" in kinds else ():
        x, g = rand(b, 6, n, n, cin, dt=dtype), rand(b, 6, n, n, cout, dt=dtype)
        e = ext_strips(x)
        ref = hc.cs_conv3x3_dw_plain(x, e, g)
        scale = max(float(r.abs().max()) for r in ref)
        parts = {}

        def launch(plan, x=x, e=e, g=g, n=n, cin=cin, cout=cout):
            if plan not in parts:  # the partial sums of this plan's K slices
                f = dict(dtype=torch.float32, device=dev)
                parts[plan] = (torch.empty((plan[1], 2, 3, 3, cin, cout), **f),
                               torch.empty((plan[1], 2, cout), **f))
            dk, db = parts[plan]
            hc.cs_conv3x3_dw._launch(
                "cs_conv3x3_dw_launch", dev.index or 0, code, dev.index or 0,
                *(t.data_ptr() for t in (x, e, g, dk, db)), b, n, cin, cout, *plan, sizes=9)
            return dk.sum(dim=0), db.sum(dim=0)

        rows = []
        for plan in dw_candidates(b, n, cin, cout, sms, esize):
            dk, db = launch(plan)
            got = (dk[0], dk[1], db[0], db[1])
            if any(float((a - r).abs().max()) > 1e-5 * scale for a, r in zip(got, ref)):
                raise RuntimeError(f"dw plan {plan} disagrees with the plain version")
            rows.append((graph_ms(lambda plan=plan: launch(plan), reps), plan))
        rows.sort()
        p, w = face_grouped(cs_pad(x, 1), [x.new_zeros((3, 3, cin, cout))] * 2)
        go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
        lib = graph_ms(lambda: torch.ops.aten.convolution_backward(
            go, p, w, [6 * cout], [1, 1], [0, 0], [1, 1], False, [0, 0], 6,
            [False, True, True]), reps)
        out.append(row("dw", b, n, cin, cout, lib,
                       hc.dw_tc_plan(b, n, cin, cout, sms, esize).args(), rows))
        yield out[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write every row (all plans) as JSON here")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    ap.add_argument("--kind", default="fwd,dx",
                    help="comma-separated kernels to sweep: fwd, dx, dw (default fwd,dx)")
    args = ap.parse_args(argv)
    kinds = tuple(args.kind.split(","))
    if not set(kinds) <= {"fwd", "dx", "dw"}:
        raise ValueError(f"--kind takes fwd, dx and dw, not {args.kind}")
    if not torch.cuda.is_available():
        raise RuntimeError("tc_sweep times CUDA kernels: it needs a card")
    torch.backends.cudnn.allow_tf32 = False
    print(f"device={torch.cuda.get_device_name(0)}")
    rows = []
    for r in run(dtype=getattr(torch, args.dtype), kinds=kinds):
        rows.append(r)
        best = [(round(t, 4), p[:4]) for t, p in r["best"]]
        own = "-" if r["plan_ms"] is None else f"{r['plan_ms']:.4f}"
        print(f"{r['kind']} b={r['batch']} ({r['n']}, {r['cin']}->{r['cout']}): cuDNN "
              f"{r['library_ms']:.4f} ms, tc_plan {r['plan'][:4]} {own} ms, fastest {best}",
              flush=True)
    for kind, b in {(r["kind"], r["batch"]) for r in rows}:
        sel = [r for r in rows if (r["kind"], r["batch"]) == (kind, b)]
        own = sum(r["plan_ms"] or r["best"][0][0] for r in sel)
        fastest = sum(r["best"][0][0] for r in sel)
        print(f"{kind} b={b}: tc_plan's plans {own:.4f} ms in sum, the fastest {fastest:.4f} ms")
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f)
    return 0


if __name__ == "__main__":
    sys.exit(main())
