"""Where the ring kernels' time goes, on the card: phases taken out one at a
time.

The fused apply (#7, ``csrc/cs_ring.cu::cs_xring_tc_kernel``) and the
fixes (#6) run each ring block as a chain of phases: staging (the taps, the
strips' cells - where Cin's bytes are not a multiple of 16, raw and then
repacked - and, for the fused apply, the base lines, by ``cp.async``),
the GEMM's k loop on the tensor cores, the epilogue (the lines written, the
corners' terms published), the corner handoff between the S/N and W/E
blocks, and beside them the copy blocks.  This tool builds variants of
``cs_ring.cu`` with one phase (or several) compiled out - by switches put
into a copy of the source under ``_build/ring_phases/`` - launches each
through the port's own wrappers on the plan's shapes, and prints the
device time of every variant: the difference to the full kernel is what
that phase adds to the launch.  The variants' outputs are wrong by design
and are not checked; the full kernel is held against its plain version.

    python -m dlwp_cs_tpu_torch.tools.ring_phases [--out FILE.json]   # on the card
"""

from __future__ import annotations

import argparse
import json
import sys

import torch

from dlwp_cs_tpu_torch.ops import ring_kernel as rk
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.tools import phases
from dlwp_cs_tpu_torch.tools.timing import bf16_excess, graph_ms

__all__ = ["ANCHORS", "SHAPES", "VARIANTS", "main", "patched_source", "run"]

# (B, n, Cin, D): the ConvLSTM's gate convs when serving and training
SHAPES = [(1, 48, 64, 128), (1, 48, 39, 128), (16, 48, 64, 128)]
SWITCHES = ("NO_TAPS", "NO_CELLS", "NO_ROWS", "NO_K", "NO_EPI", "NO_HANDOFF", "NO_COPY")
# the source text each switch guards (each must appear in cs_ring.cu once)
ANCHORS = {
    "NO_TAPS": [("tapgemm::stage_taps<T>(W, 3,", "if (!NO_TAPS) tapgemm::stage_taps<T>(W, 3,")],
    "NO_CELLS": [("  if (g.raw) {\n    // Cin's bytes",
                  "  if (NO_CELLS) {\n  } else if (g.raw) {\n    // Cin's bytes"),
                 ("  if (g.raw) {  // the raw strips into cells",
                  "  if (!NO_CELLS && g.raw) {  // the raw strips into cells")],
    "NO_ROWS": [("    stage_rows<T>(bt,", "    if (!NO_ROWS) stage_rows<T>(bt,")],
    "NO_K": [("const tapgemm::Gemm gm{ns * rps, 3, g.kpt,",
              "const tapgemm::Gemm gm{ns * rps, 3, NO_K ? 0 : g.kpt,")],
    "NO_EPI": [("[&](int m, int nl, float v0, float v1) {\n      const int s = m / rps, t = m - s * rps;\n"
                "      if (t >= n",
                "[&](int m, int nl, float v0, float v1) {\n      if (NO_EPI && v0 != 1234.5f) return;\n"
                "      const int s = m / rps, t = m - s * rps;\n      if (t >= n")],
    "NO_HANDOFF": [("    __syncthreads();\n    if (threadIdx.x < 2 * ns) {",
                    "    if (NO_HANDOFF) return;\n    __syncthreads();\n"
                    "    if (threadIdx.x < 2 * ns) {")],
    "NO_COPY": [("    copy_block<T, V>(base_eq, base_po, out, g, idx);",
                 "    if (!NO_COPY) copy_block<T, V>(base_eq, base_po, out, g, idx);")],
}
VARIANTS = {
    "full": (), "no_taps": ("NO_TAPS",), "no_cells": ("NO_CELLS",), "no_rows": ("NO_ROWS",),
    "no_k_loop": ("NO_K",), "no_epilogue": ("NO_EPI",), "no_handoff": ("NO_HANDOFF",),
    "no_copy": ("NO_COPY",), "staging_only": ("NO_K", "NO_EPI", "NO_HANDOFF", "NO_COPY"),
    "empty": SWITCHES,
}


def patched_source(switches) -> str:
    """``cs_ring.cu`` with every switch's guard in place, those of
    ``switches`` on."""
    return phases.patched_source(rk._RING_LIB, ANCHORS, SWITCHES, switches)


def run(reps: int = 20):
    """Every variant of both ring kernels at ``SHAPES`` in bfloat16 and
    float32: one dict per (dtype, shape) with each variant's device ms for
    the fused apply and, for the variants that keep its work, the fixes."""
    libs = phases.variant_libraries(rk._RING_LIB, ANCHORS, SWITCHES, VARIANTS, "ring_phases")
    wrappers = (rk.xring_fused_apply, rk.ring_fixes)
    saved = [(w.library, w.launches) for w in wrappers]
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for dtype in (torch.bfloat16, torch.float32):
            for b, n, cin, d in SHAPES:
                x = torch.randn((b, 6, n, n, cin), generator=gen, device="cuda").to(dtype)
                ks = [(torch.randn((3, 3, cin, d), generator=gen, device="cuda")
                       * (9 * cin) ** -0.5).to(dtype) for _ in range(2)]
                bases = [torch.randn((b, 6, n, n, d), generator=gen, device="cuda").to(dtype)
                         for _ in range(2)]
                ext = ext_strips(x)
                row = {"dtype": str(dtype).split(".")[-1], "batch": b, "n": n, "cin": cin,
                       "d": d, "apply_ms": {}, "fixes_ms": {}}
                for name, lib in libs.items():
                    for w in wrappers:
                        w.library = lib
                    apply = lambda: rk.xring_fused_apply(*bases, ext, *ks)  # noqa: E731
                    fixes = lambda: rk.ring_fixes(ext, *ks)  # noqa: E731
                    out = apply()
                    if name == "full":
                        ref = rk.xring_fused_apply_plain(*bases, ext, *ks)
                        err = (float((out - ref).abs().max()) if dtype == torch.float32
                               else bf16_excess(out, ref))
                        if err > 1e-4:
                            raise RuntimeError(f"the full ring kernel is off its plain "
                                               f"version by {err}")
                    row["apply_ms"][name] = graph_ms(apply, reps)
                    if not set(VARIANTS[name]) & {"NO_ROWS", "NO_HANDOFF", "NO_COPY"}:
                        row["fixes_ms"][name] = graph_ms(fixes, reps)
                rows.append(row)
    finally:
        for w, (lib, count) in zip(wrappers, saved):
            w.library, w.launches = lib, count
    return rows


def main(argv=None, out=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--out", help="write the rows to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        raise RuntimeError("ring_phases times CUDA kernels: it needs a card")
    torch.backends.cuda.matmul.allow_tf32 = False
    rows = run()
    if out is not None:
        out.extend(rows)
    for r in rows:
        for kind in ("apply_ms", "fixes_ms"):
            print(f"{r['dtype']} B={r['batch']} n={r['n']} Cin={r['cin']} D={r['d']} "
                  f"{kind[:-3]}: " + "; ".join(f"{k} {v * 1e3:.2f} us"
                                               for k, v in r[kind].items()), flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
