"""Time the tensor-core conv and dx kernels under many plans, on the card.

The forward (#1, bfloat16 and float32) and bfloat16 dx (#4) kernels take
their tiles, slices and walks from ``ops/hopper_conv.py::tc_plan``.  This
tool times, at each conv shape of the flagship C48 U-Net (and n = 96), the
plans around it: slices of 8-64 channels (float32: 8-32), 1-8 n8 tiles per
warp (float32: 1-4), tiles of whole rows up to 256 pixels, and tiles per
block around the grid that keeps the SMs full.  Every plan's output is held
against the plain version (bfloat16: one bf16 ulp of |ref| + 1e-4;
float32: 1e-4).  Rows: the shape, cuDNN's time (the face-grouped conv, or
its dgrad for dx; float32 with TF32 off), the time of ``tc_plan``'s own
choice and the fastest plans.  ``_tc_score`` (the training-batch choice)
was fitted on these rows (an H100, batch 16).

    python -m dlwp_cs_tpu_torch.tools.tc_sweep [--dtype float32] [--out FILE.json]   # on the card
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

__all__ = ["SHAPES", "candidates", "main", "run"]

# (n, Cin, Cout) of the flagship U-Net's convs, and n = 96
SHAPES = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
          (12, 128, 128), (24, 192, 64), (48, 96, 32), (96, 64, 64)]
HEIGHTS = (1, 2, 3, 4, 5, 6, 8, 10, 12, 16)


def candidates(b, rows, cols, kch, nch, dx, sm_count, esize=2):
    """The plans around ``tc_plan``'s for ``esize``-byte elements: ``(h, cs,
    nw, tpb, smem)`` each."""
    out = []
    widest = min(64 if esize == 2 else 32, max(8, 1 << (nch - 1).bit_length()))
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


def _sweep(launch, check, plans, reps):
    rows = []
    for plan in plans:
        launch(plan)
        torch.cuda.synchronize()
        if not check():
            raise RuntimeError(f"plan {plan} disagrees with the plain version")
        rows.append((graph_ms(lambda: launch(plan), reps), plan))
    return sorted(rows)


def run(batches=(16, 1), dx_batch=16, reps=10, dtype=torch.bfloat16):
    """The rows of the module docstring, as dicts; the full table of each
    shape under ``"all"``.  float32: the forward only (its dx kernel is not
    a tensor-core kernel)."""
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
    for b in batches:
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
                                      *ptrs, b, n, n, cin, cout, *plan, sizes=10)

            rows = _sweep(launch, lambda y=y, ref=ref: close(y, ref),
                          candidates(b, n, n, cin, cout, False, sms, esize), reps)
            p, w = face_grouped(cs_pad(x, 1), ks)
            bias = torch.cat([bs[0]] * 4 + [bs[1]] * 2)
            lib = graph_ms(lambda: F.conv2d(p, w, bias, groups=6), reps)
            out.append(row("fwd", b, n, cin, cout, lib,
                           hc.tc_plan(b, n, n, cin, cout, sms, esize=esize).args(), rows))
            yield out[-1]
    if f32:
        return
    b = dx_batch
    for n, cin, cout in SHAPES[1:8]:
        g = rand(b, 6, n, n, cout)
        ks = [rand(3, 3, cin, cout, scale=(9 * cout) ** -0.5) for _ in range(2)]
        dx = torch.empty((b, 6, n, n, cin), dtype=bf, device=dev)
        de = torch.empty((b, 6, 4, n + 2, cin), dtype=bf, device=dev)
        ref = hc.cs_conv3x3_dx_plain(g, *ks)[0]
        ptrs = [t.data_ptr() for t in (g, *ks, dx, de)]

        def launch(plan, ptrs=ptrs, n=n, cin=cin, cout=cout):
            hc.cs_conv3x3_dx._launch("cs_conv3x3_dx_launch", dev.index or 0, 1, dev.index or 0,
                                     *ptrs, b, n, cin, cout, *plan, sizes=9)

        rows = _sweep(launch, lambda dx=dx, ref=ref: bf16_excess(dx, ref) <= 1e-4,
                      candidates(b, n + 2, n + 2, cout, cin, True, sms), reps)
        xz = torch.zeros((b, 6, n, n, cin), dtype=bf, device=dev)
        p, w = face_grouped(cs_pad(xz, 1), ks)
        go = g.permute(0, 2, 3, 1, 4).reshape(b, n, n, 6 * cout).permute(0, 3, 1, 2)
        lib = graph_ms(lambda: torch.ops.aten.convolution_backward(
            go, p, w, [6 * cout], [1, 1], [0, 0], [1, 1], False, [0, 0], 6,
            [True, False, False]), reps)
        out.append(row("dx", b, n, cin, cout, lib,
                       hc.tc_plan(b, n + 2, n + 2, cout, cin, sms, dx=True).args(), rows))
        yield out[-1]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", default=None, help="write every row (all plans) as JSON here")
    ap.add_argument("--dtype", choices=("bfloat16", "float32"), default="bfloat16")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("tc_sweep times CUDA kernels: it needs a card")
    torch.backends.cudnn.allow_tf32 = False
    print(f"device={torch.cuda.get_device_name(0)}")
    rows = []
    for r in run(dtype=getattr(torch, args.dtype)):
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
