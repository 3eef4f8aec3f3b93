"""Where the im2col conv kernel's time goes, on the card: phases taken out,
and the width of its K windows.

Kernel #13 (``csrc/cs_conv3x3_mma.cu::cs_conv3x3_im2col_gemm_kernel``)
walks K in windows; each window is a chain: the copy wait and a barrier,
the next windows' copies (the column gather of the block's pixels from
``x`` and the ghost strips, the weights' rows), then the k steps (ldmatrix
loads and ``mma.sync`` products).  This tool builds variants of the source
with phases compiled out - by switches put into a copy of it under
``_build/im2col_phases/`` - launches each through the port's wrapper with
the plan's launch, and prints the device time of every variant: the
difference to the full kernel is what that phase adds.  The variants'
outputs are wrong by design and are not checked; the full kernel is held
against its plain version.  It also times the full kernel with each K
window width the plan chooses from (``ops/conv_variants.py::
im2col_launch``), in the plan's tile configuration.

    python -m dlwp_cs_tpu_torch.tools.im2col_phases [--out FILE.json]   # on the card
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from dlwp_cs_tpu_torch.ops import conv_variants as cv
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.tools import phases
from dlwp_cs_tpu_torch.tools.timing import bf16_excess, graph_ms

__all__ = ["ANCHORS", "SHAPES", "VARIANTS", "main", "patched_source", "run"]

# (B, n, Cin, Cout): the flagship U-Net's distinct convs at batch 1 (a
# model call, as the kernel tools time it) and conv_micro's levels and the
# decoder's conv at batch 16
SHAPES = [(1, 48, 12, 32), (1, 48, 32, 32), (1, 24, 32, 64), (1, 24, 64, 64),
          (1, 12, 64, 128), (1, 12, 128, 128), (1, 24, 192, 64), (1, 48, 96, 32),
          (16, 48, 32, 32), (16, 24, 64, 64), (16, 12, 128, 128), (16, 48, 96, 32)]
SWITCHES = ("NO_A", "NO_B", "NO_MMA", "NO_K", "NO_WALK")
# the source text each switch guards (each must appear in the source once)
ANCHORS = {
    "NO_A": [("copy_unit(adst + off / 2,", "if (!NO_A) copy_unit(adst + off / 2,")],
    "NO_B": [("copy_unit(bdst + kk * g.bpitch", "if (!NO_B) copy_unit(bdst + kk * g.bpitch")],
    "NO_MMA": [("for (int b = 0; b < C::TN; ++b) cs3x3::mma_bf16(",
                "for (int b = 0; b < C::TN; ++b)\n"
                "          if (NO_MMA) acc[a][b][0] += __uint_as_float(af[a][0] ^ bf[b][1]);\n"
                "          else cs3x3::mma_bf16(")],
    "NO_K": [("nks = ntw * wd / 16;", "nks = NO_K ? 0 : ntw * wd / 16;")],
    "NO_WALK": [("if (s < g.nwin) load_window(s, s);",
                 "if (!NO_WALK && s < g.nwin) load_window(s, s);"),
                ("for (int q = 0; q < g.nwin; ++q) {",
                 "for (int q = 0; q < (NO_WALK ? 0 : g.nwin); ++q) {")],
}
VARIANTS = {
    "full": (), "no_gather": ("NO_A",), "no_weights": ("NO_B",), "no_copies": ("NO_A", "NO_B"),
    "ldmatrix_only": ("NO_A", "NO_B", "NO_MMA"), "waits_only": ("NO_A", "NO_B", "NO_K"),
    "empty": ("NO_WALK",),
}


def patched_source(switches) -> str:
    """``cs_conv3x3_mma.cu`` with every switch's guard in place, those of
    ``switches`` on."""
    return phases.patched_source(cv._MMA_LIB, ANCHORS, SWITCHES, switches)


def run(reps: int = 20):
    """Every variant at ``SHAPES`` (bfloat16, the kernel's only type), and
    the full kernel at each K window width: one dict per shape with the
    plan's launch and the device ms of each."""
    libs = phases.variant_libraries(cv._MMA_LIB, ANCHORS, SWITCHES, VARIANTS, "im2col_phases")
    kernel = cv.cs_conv3x3_im2col
    saved = kernel.library, kernel.launches
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for b, n, cin, cout in SHAPES:
            x = torch.randn((b, 6, n, n, cin), generator=gen, device="cuda").bfloat16()
            ws = [(torch.randn((9 * cin, cout), generator=gen, device="cuda")
                   * (9 * cin) ** -0.5).bfloat16() for _ in range(2)]
            bs = [(torch.randn((cout,), generator=gen, device="cuda") * 0.1).bfloat16()
                  for _ in range(2)]
            ext = ext_strips(x)
            out = torch.empty((b, 6, n, n, cout), dtype=torch.bfloat16, device="cuda")
            plan = cv.im2col_plan(b, n, cin, cout, sms)
            row = {"batch": b, "n": n, "cin": cin, "cout": cout, "plan": plan._asdict(),
                   "variant_ms": {}, "window_ms": {}}
            idx = kernel._device(x)
            for name, lib in libs.items():
                kernel.library = lib

                def call(p=plan):
                    kernel._launch_kernel(idx, x, ext, *ws, *bs, out, plan=p)

                call()
                if name == "full":
                    ref = cv.cs_conv3x3_im2col_plain(x, ext, *ws, *bs)
                    if bf16_excess(out, ref) > 1e-4:
                        raise RuntimeError("the full im2col kernel is off its plain version")
                    for kw in cv._IM2_KWS:
                        p = cv.im2col_launch(b, n, cin, cout, plan.cfg, kw)
                        if p.smem <= cv._SMEM_LIMIT:
                            row["window_ms"][f"{p.tpw}x{p.bks}"] = graph_ms(
                                lambda p=p: call(p), reps)
                row["variant_ms"][name] = graph_ms(call, reps)
            rows.append(row)
    finally:
        kernel.library, kernel.launches = saved
    return rows


def main(argv=None, out=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("im2col_phases times CUDA kernels: it needs a card")
    rows = run()
    if out is not None:
        out.extend(rows)
    for r in rows:
        p = r["plan"]
        print(f"B={r['batch']} n={r['n']} Cin={r['cin']} Cout={r['cout']} "
              f"({p['bm']}x{p['bn']}, {p['kg']} warp group(s) along K, {p['nwin']} windows of "
              f"{p['tpw']}x{p['bks']}): "
              + "; ".join(f"{k} {v * 1e3:.2f} us" for k, v in r["variant_ms"].items())
              + " | windows (taps x channels): "
              + "; ".join(f"{k} {v * 1e3:.2f} us" for k, v in r["window_ms"].items()),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
