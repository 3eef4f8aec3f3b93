"""Where the kn2row conv kernel's time goes, on the card: phases taken out,
and the tile it is launched with.

Kernel #3 (``csrc/cs_conv3x3_mma.cu::cs_conv3x3_npack_tiles_kernel``)
stages a tile's padded rows and the dy slices of the taps by ``cp.async``,
then per dy runs one product over the tile's cells (ldmatrix loads and
``mma.sync``), one exchange of the product through shared memory and the
dx-shifted adds into the sums each thread holds, and ends with the bias,
one rounding and the stores.  ``no_exchange`` drops the product's stores
to shared memory (the adds then read stale sums); ``barriers_only`` keeps
the dy rounds' waits, barriers and fragment loads; ``staging_only`` the
copies and their wait; ``empty`` the launch and the index set-up.  The
tool also prints how many blocks an SM holds (the occupancy calculator).
This tool builds variants of the source with phases compiled out - by
switches put into a copy of it under ``_build/npack_phases/`` - launches each through the port's wrapper with
the plan's launch, and prints the device time of every variant: the
difference to the full kernel is what that phase adds.  The variants'
outputs are wrong by design and are not checked; the full kernel is held
against its plain version, and so is the full kernel with every tile
(rows x channels) the plan chooses from (``ops/conv_variants.py::
npack_tiles``), each of which it also times: how the plan's rule is read.

    python -m dlwp_cs_tpu_torch.tools.npack_phases [--out FILE.json]   # on the card
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
# model call, as the kernel tools time it), conv_micro's levels and the
# decoder's conv at batch 16, and the packed layout's 128 channels
SHAPES = [(1, 48, 12, 32), (1, 48, 32, 32), (1, 24, 32, 64), (1, 24, 64, 64),
          (1, 12, 64, 128), (1, 12, 128, 128), (1, 24, 192, 64), (1, 48, 96, 32),
          (16, 48, 32, 32), (16, 24, 64, 64), (16, 12, 128, 128), (16, 48, 96, 32),
          (1, 48, 128, 128)]
SWITCHES = ("NO_STAGE", "NO_MMA", "NO_PF", "NO_ADDS", "NO_EPI", "NO_DY")
# the source text each switch guards (each must appear in the source once)
ANCHORS = {
    "NO_STAGE": [("im2::copy_unit(tdst, tsrc,", "if (!NO_STAGE) im2::copy_unit(tdst, tsrc,"),
                 ("im2::copy_unit(wdst, wsrc,", "if (!NO_STAGE) im2::copy_unit(wdst, wsrc,")],
    "NO_MMA": [("if (b < tns) cs3x3::mma_bf16(acc[a][b], af[a], bfr[b][0], bfr[b][1]);",
                "if (b < tns) {\n"
                "              if (NO_MMA) acc[a][b][0] += __uint_as_float(af[a][0] ^ bfr[b][1]);\n"
                "              else cs3x3::mma_bf16(acc[a][b], af[a], bfr[b][0], bfr[b][1]);\n"
                "            }")],
    "NO_PF": [("*reinterpret_cast<float2*>(\n                Pf + (long long)((mt0 + a)",
               "if (!NO_PF) *reinterpret_cast<float2*>(\n                Pf + (long long)((mt0 + a)")],
    "NO_ADDS": [("for (int dx = 0; dx < 3; ++dx) {\n          const float* q",
                 "for (int dx = 0; dx < (NO_ADDS ? 0 : 3); ++dx) {\n          const float* q")],
    "NO_DY": [("for (int dy = 0; dy < 3; ++dy) {\n    if (g.wbufs > 1 && dy < 2)",
               "for (int dy = 0; dy < (NO_DY ? 0 : 3); ++dy) {\n    if (g.wbufs > 1 && dy < 2)")],
    # the stores stay behind a test the compiler cannot decide, so that the
    # sums they would write are still computed
    "NO_EPI": [("if (g.go && co + 8 <= cout) {",
                "if (NO_EPI && __bfloat162float(r[0]) != 1e30f) continue;\n"
                "    if (g.go && co + 8 <= cout) {")],
}
VARIANTS = {
    "full": (), "no_staging": ("NO_STAGE",), "no_products": ("NO_MMA",),
    "no_exchange": ("NO_PF",), "no_adds": ("NO_ADDS",), "no_epilogue": ("NO_EPI",),
    "barriers_only": ("NO_STAGE", "NO_MMA", "NO_PF", "NO_ADDS", "NO_EPI"),
    "staging_only": ("NO_DY", "NO_EPI"), "empty": ("NO_STAGE", "NO_DY", "NO_EPI"),
}


def patched_source(switches) -> str:
    """``cs_conv3x3_mma.cu`` with every switch's guard in place, those of
    ``switches`` on."""
    return phases.patched_source(cv._MMA_LIB, ANCHORS, SWITCHES, switches)


def run(reps: int = 20):
    """Every variant at ``SHAPES`` (bfloat16, the kernel's only type), and
    the full kernel with every tile: one dict per shape with the plan's
    launch and the device ms of each."""
    libs = phases.variant_libraries(cv._MMA_LIB, ANCHORS, SWITCHES, VARIANTS, "npack_phases")
    kernel = cv.cs_conv3x3_npack
    saved = kernel.library, kernel.launches
    dev = torch.device("cuda")
    sms = torch.cuda.get_device_properties(dev).multi_processor_count
    gen = torch.Generator(device="cuda").manual_seed(0)
    rows = []
    try:
        for b, n, cin, cout in SHAPES:
            x = torch.randn((b, 6, n, n, cin), generator=gen, device="cuda").bfloat16()
            ws = [(torch.randn((cin, 9 * cout), generator=gen, device="cuda")
                   * (9 * cin) ** -0.5).bfloat16() for _ in range(2)]
            bs = [(torch.randn((cout,), generator=gen, device="cuda") * 0.1).bfloat16()
                  for _ in range(2)]
            ext = ext_strips(x)
            out = torch.empty((b, 6, n, n, cout), dtype=torch.bfloat16, device="cuda")
            plan = cv.npack_plan(b, n, cin, cout, sms)
            row = {"batch": b, "n": n, "cin": cin, "cout": cout, "plan": plan._asdict(),
                   "blocks_per_sm": cv.npack_occupancy(plan), "variant_ms": {},
                   "tile_ms": {}}
            idx = kernel._device(x)
            ref = cv.cs_conv3x3_npack_plain(x, ext, *ws, *bs)
            for name, lib in libs.items():
                kernel.library = lib

                def call(p=plan):
                    kernel._launch_kernel(idx, x, ext, *ws, *bs, out, plan=p)

                call()
                if name == "full":
                    if bf16_excess(out, ref) > 1e-4:
                        raise RuntimeError("the full kn2row kernel is off its plain version")
                    for p in cv.npack_tiles(b, n, cin, cout):
                        call(p)
                        if bf16_excess(out, ref) > 1e-4:
                            raise RuntimeError(f"the kn2row kernel's tile {p} is off its "
                                               "plain version")
                        row["tile_ms"][f"{p.h}x{p.bn}/{p.wbufs}"] = graph_ms(
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
        raise RuntimeError("npack_phases times CUDA kernels: it needs a card")
    rows = run()
    if out is not None:
        out.extend(rows)
    for r in rows:
        p = r["plan"]
        print(f"B={r['batch']} n={r['n']} Cin={r['cin']} Cout={r['cout']} "
              f"({p['h']} rows x {p['bn']} channels, {p['wbufs']} weight buffer(s), "
              f"{p['blocks']} blocks, {r['blocks_per_sm']} an SM): "
              + "; ".join(f"{k} {v * 1e3:.2f} us" for k, v in r["variant_ms"].items())
              + " | tiles (rows x channels / buffers): "
              + "; ".join(f"{k} {v * 1e3:.2f} us" for k, v in r["tile_ms"].items()),
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
