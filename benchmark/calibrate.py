"""The readings that correctness limits are set from, at a cell's own
size, in one process.

    python3 benchmark/calibrate.py --workload <cell> --seconds <s> \
        --seeds <n> ... [--control-seeds <n> ...] [--out FILE]

For each seed: the cell's set-up, a window of ``--seconds`` at the
cell's own load, and the numbers its run compares (the program's
readings; the limit goes above the largest).  For each control seed also
the numbers with the reference computed in TF32 in the program's place
(the control; the limit goes below the smallest).  One JSON line a seed,
then a summary line.  Card only.
"""

from __future__ import annotations

import argparse
import gc
import json
import sys
import time
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))


def readings(bench, workload: str, seed: int, seconds: float, *, control: bool,
             device="cuda") -> dict:
    import torch

    from benchmark import work

    cell = bench.cell(workload)
    cfg = cell["model"]
    layers = bench.flops(cfg["kind"]).conv_layers(cfg)
    load = bench.load(cell["traffic_params"]["load"]).Load(
        cell, seed, torch.device(device), layers, work)
    load.setup()
    rec = load.window(seconds)
    load.release()
    gc.collect()
    if torch.device(device).type == "cuda":
        torch.cuda.empty_cache()
    out = {"seed": seed, "attempted": rec["attempted"], "failed": rec["failed"],
           "program": load.check()}
    if control:
        out["control"] = load.control()
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seconds", type=float, default=5.0)
    ap.add_argument("--seeds", type=int, nargs="+", required=True)
    ap.add_argument("--control-seeds", type=int, nargs="*", default=[])
    ap.add_argument("--out")
    args = ap.parse_args(argv)

    import torch

    from benchmark.spec import Bench

    if not torch.cuda.is_available():
        print("needs a CUDA device", file=sys.stderr)
        return 2
    bench = Bench()
    lines = []
    for seed in dict.fromkeys(args.seeds + args.control_seeds):
        t = time.perf_counter()
        r = readings(bench, args.workload, seed, args.seconds,
                     control=seed in args.control_seeds)
        r["seconds"] = time.perf_counter() - t
        lines.append(r)
        print(json.dumps(r), flush=True)
    summary = {"workload": args.workload, "card": torch.cuda.get_device_name(0),
               "limits": bench.cell(args.workload)["limits"]}
    for part in ("program", "control"):
        vals = [r[part] for r in lines if part in r]
        if vals:
            agg = max if part == "program" else min
            summary[part] = {k: agg(v[k] for v in vals) for k in vals[0]}
    print(json.dumps(summary), flush=True)
    if args.out:
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text("\n".join(json.dumps(x) for x in lines + [summary]) + "\n")
    return 0


if __name__ == "__main__":
    sys.exit(main())
