"""Run one cell of ``BENCHMARK.json`` once and print one JSON line.

    python3 benchmark/run.py --workload <cell> --seed <n> --seconds <s> --trace <0|1>

From the root of a checkout that holds ``dlwp_cs_tpu_torch``.  The cell's
load (``loads/<kind>.py``, named by its traffic) sets the program up on the card
from the seed and warms up every shape of its traffic; that is
``setup_s``.  It then measures for ``--seconds``.  With ``--trace 1`` the
window is cut in two: the host-clock per-layer metrics read its first
part, untraced, and the device metrics the device trace of its last
:data:`TRACED_SHARE` under ``torch.profiler``, whose launch cost (some
microseconds a kernel) would otherwise slow what the host clock reads.  Once
the window has closed and the peak memory is read, the program's state is
freed and the plain reference checks the window's answers: ``correct``.
The numbers compared are printed with their limits, last on standard
error and last in the JSON line (``checks``).

Exits with 2 and prints no result when there is no CUDA device (or fewer
than the cell asks for), and with 3 when the process holds JAX or the JAX
package once the window has closed.
"""

from __future__ import annotations

import time

T_PROCESS = time.perf_counter()

import argparse  # noqa: E402
import gc  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402
from types import SimpleNamespace  # noqa: E402

ROOT = Path(__file__).resolve().parents[1]
if str(ROOT) not in sys.path:
    sys.path.insert(0, str(ROOT))

# build and kernel caches at fixed paths inside the checkout
for var, sub in (("TRITON_CACHE_DIR", "triton"), ("TORCH_EXTENSIONS_DIR", "torch_extensions")):
    os.environ.setdefault(var, str(ROOT / ".bench_cache" / sub))
# one host thread for CPU math: the cells' host loops are single-threaded,
# and idle pool threads only take cores from them
for var in ("OMP_NUM_THREADS", "MKL_NUM_THREADS", "OPENBLAS_NUM_THREADS"):
    os.environ[var] = "1"

FORBIDDEN = ("jax", "jaxlib", "flax", "dlwp_cs_tpu")
TRACED_SHARE = 0.4


def forbidden_modules() -> list[str]:
    """Top-level names in ``sys.modules`` that are JAX or the JAX package,
    compared whole (``dlwp_cs_tpu_torch`` is not ``dlwp_cs_tpu``)."""
    return sorted({m.split(".")[0] for m in sys.modules} & set(FORBIDDEN))


def _device_info(device, peak_bytes):
    import torch

    if device.type == "cuda":
        return {"platform": "gpu", "kind": torch.cuda.get_device_name(device), "count": 1,
                "memory_peak_bytes": int(peak_bytes)}
    return {"platform": "cpu", "kind": "cpu", "count": 1, "memory_peak_bytes": 0}


def run_cell(bench, workload: str, seed: int, seconds: float, trace: bool, device="cuda",
             t_process: float = T_PROCESS) -> dict:
    """One run of ``workload``; returns the result line as a dict."""
    import torch

    from benchmark import work
    from benchmark.trace import traced_window

    device = torch.device(device)
    cell = bench.cell(workload)
    cfg = cell["model"]
    layers = bench.flops(cfg["kind"]).conv_layers(cfg)
    load = bench.load(cell["traffic_params"]["load"]).Load(cell, seed, device, layers, work)
    if device.type == "cuda":
        torch.cuda.reset_peak_memory_stats(device)
    load.setup()
    setup_s = time.perf_counter() - t_process
    gc.collect()
    gc.freeze()  # set-up's objects are not scanned again inside the window
    host = load.window(seconds * (1.0 - TRACED_SHARE)) if trace else None
    with traced_window(trace) as tracer:
        rec = load.window(seconds * TRACED_SHARE if trace else seconds)
    parts = [r for r in (host, rec) if r is not None]
    host = parts[0]
    if device.type == "cuda":
        torch.cuda.synchronize(device)
    peak = torch.cuda.max_memory_allocated(device) if device.type == "cuda" else 0
    dev_info = _device_info(device, peak)
    summary = None
    if tracer is not None:
        t_read = time.perf_counter()
        summary = tracer.summary(bench.conv_kernel_patterns())
        print(f"trace read in {time.perf_counter() - t_read:.1f} s", file=sys.stderr)
    del tracer
    load.release()
    gc.unfreeze()
    gc.collect()
    if device.type == "cuda":
        torch.cuda.empty_cache()
    numbers = load.check()
    limits = cell["limits"]
    checks = {k: {"value": v, "limit": limits[k]} for k, v in numbers.items()}
    attempted = sum(r["attempted"] for r in parts)
    failed = sum(r["failed"] for r in parts)
    correct = failed == 0 and attempted > 0 and all(c["value"] <= c["limit"]
                                                    for c in checks.values())

    dtype = cfg["model"]["compute_dtype"]
    peaks = bench.peaks(dev_info["kind"])
    # host-clock numbers from the untraced part, device ones from the traced
    run = SimpleNamespace(setup_s=setup_s, trace=summary, peaks=peaks, dtype=dtype,
                          window_s=host["window_s"], member_days=host["member_days"],
                          model_flops=host["model_flops"], calls=rec["calls"],
                          conv_bound_s=None)
    if peaks and rec["calls"]:
        run.conv_bound_s = rec["calls"] * work.conv3x3_bound_s(
            layers, rec["conv_rows"], peak_flops=peaks[dtype],
            bytes_per_s=peaks["hbm_bytes_per_s"], dtype=dtype)
    section = "per_layer" if trace else "end_to_end"
    metrics = {}
    for m in bench.metrics_of(workload, section):
        value = bench.reader(section, m["name"])(run)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    out = {"correct": bool(correct), "attempted": int(attempted), "failed": int(failed),
           "metrics": metrics, "device": dev_info}
    if summary is not None:
        out["device"]["busy_s"] = summary["busy_s"]
        out["device"]["window_s"] = summary["window_s"]
        top = sorted(summary["by_name"].items(), key=lambda kv: -kv[1])[:10]
        out["breakdown"] = {"device_ops": [[k, v] for k, v in top],
                            "idle_gaps": [[k, v] for k, v in summary["idle_gaps"]]}
    out["checks"] = checks
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    from benchmark.spec import Bench

    bench = Bench()
    chips = bench.cell(args.workload)["chips"]
    import torch

    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        print(f"needs {chips} CUDA device(s); found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}", file=sys.stderr)
        return 2
    torch.set_num_threads(1)
    out = run_cell(bench, args.workload, args.seed, args.seconds, bool(args.trace))
    bad = forbidden_modules()
    if bad:
        print(f"the run loaded {bad}: the benchmark measures the PyTorch port alone",
              file=sys.stderr)
        return 3
    for name, c in out["checks"].items():
        print(f"check {name} {c['value']!r} limit {c['limit']!r}", file=sys.stderr)
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
