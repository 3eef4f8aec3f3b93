"""Scaling-efficiency sweep of the train step over (data, spatial) meshes.

The counterpart of the reference's ``tools/scaling_bench.py``: a command
line over ``parallel/scaling.py::measure_scaling`` (weak scaling: the
global batch grows with the data axis), one JSON line per configuration:
step time, grid points/s, per-rank throughput and the efficiency against
one device.

The reference builds every mesh over the devices of one process; here a
``DxS`` configuration of more than one rank runs on ``D*S`` ranks of a
gloo group spawned on this host (``parallel/launch.py::spawn_group``; one
group per rank count, rank 0's numbers), and ``1x1`` runs in the calling
process, alone on the card, as the baseline of every efficiency.  Ranks
that share one card take turns on it, so their lines carry
``"ranks_share_one_card": true``: their efficiency measures time slicing,
not scaling.  Each line also carries the collectives rank 0's steps issued
on the device and through the host (``device_collectives``,
``host_collectives``; on the card every collective of a multi-rank row runs
on the device).  On the CPU every time is ``None``.

    python -m dlwp_cs_tpu_torch.tools.scaling_bench [--configs 1x1,2x1,4x1,8x1,2x4]
    python -m dlwp_cs_tpu_torch.tools.scaling_bench --device cpu --small --configs 1x1
"""

from __future__ import annotations

import argparse
import dataclasses
import json
import sys
import tempfile

import torch

from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, UNetConfig
from dlwp_cs_tpu_torch.parallel import collectives
from dlwp_cs_tpu_torch.parallel.launch import spawn_group
from dlwp_cs_tpu_torch.parallel.scaling import ScalingResult, measure_scaling
from dlwp_cs_tpu_torch.tools.timing import add_device_args, card, tool_device

__all__ = ["main", "parse_configs", "scaling_rank", "sweep"]

TIMES = ("step_seconds", "gridpoints_per_s", "gridpoints_per_s_per_chip",
         "efficiency_vs_single")


def parse_configs(text: str):
    """``"1x1,4x1,2x2"`` -> ``[(1, 1), (4, 1), (2, 2)]``: (data, spatial)."""
    out = []
    for tok in text.split(","):
        d, s = tok.lower().split("x")
        out.append((int(d), int(s)))
    return out


def scaling_rank(grid, filters, batch_per_device, configs, iters, device):
    """:func:`measure_scaling` of the U-Net at C``grid`` over ``configs``
    on this rank (``device``: ``None`` for the GPU, or ``"cpu"``), one
    configuration at a time; its results as dicts, each with the
    collectives its steps issued on the device and through the host
    (``device_collectives``, ``host_collectives``)."""
    dcfg = DataConfig(grid_n=grid)
    model = CubeSphereUNet(UNetConfig(output_channels=dcfg.output_channels,
                                      filters=tuple(filters)),
                           dcfg.input_channels, device=device,
                           generator=torch.Generator().manual_seed(0))
    rows = []
    for config in configs:
        before = collectives.device_calls, collectives.host_calls
        results = measure_scaling(model, n_grid=grid, in_channels=dcfg.input_channels,
                                  out_channels=dcfg.output_channels,
                                  batch_per_device=batch_per_device,
                                  mesh_configs=(tuple(config),), iters=iters, device=device)
        rows += [dict(dataclasses.asdict(r),
                      device_collectives=collectives.device_calls - before[0],
                      host_collectives=collectives.host_calls - before[1]) for r in results]
    return rows


def _group_rank(*args):
    """A spawned rank of :func:`sweep`: :func:`scaling_rank`, one CPU
    thread each (the ranks share the host's cores)."""
    torch.set_num_threads(1)
    return scaling_rank(*args)


def sweep(configs, *, grid, filters, batch_per_device, iters, device):
    """Every configuration of ``configs``: ``1x1`` in this process, each
    rank count above one in a group of its own; the efficiency against
    the ``1x1`` row where there is one.  Returns ``(ScalingResult,
    counts)`` pairs in the order of ``configs``: ``counts`` the rank's
    ``device_collectives`` and ``host_collectives`` of that row."""
    dev_arg = "cpu" if device.type == "cpu" else None
    found = {}
    if (1, 1) in configs:
        for r in scaling_rank(grid, filters, batch_per_device, [(1, 1)], iters, dev_arg):
            found[(1, 1)] = r
    for size in sorted({d * s for d, s in configs if d * s > 1}):
        mine = [c for c in configs if c[0] * c[1] == size]
        if device.type == "cuda":
            torch.cuda.empty_cache()
        with tempfile.TemporaryDirectory() as tmp:
            ranks = spawn_group(_group_rank, size, grid, filters, batch_per_device, mine,
                                iters, dev_arg, workdir=tmp)
        for r in ranks[0]:
            found[tuple(r["mesh_shape"])] = r
    base = found.get((1, 1))
    out = []
    for c in configs:
        if c not in found:
            continue
        r = dict(found[c], mesh_shape=tuple(found[c]["mesh_shape"]))
        counts = {k: r.pop(k) for k in ("device_collectives", "host_collectives")}
        if base is not None:
            r["efficiency_vs_single"] = (r["gridpoints_per_s_per_chip"]
                                         / base["gridpoints_per_s_per_chip"])
        out.append((ScalingResult(**r), counts))
    return out


def main(argv=None, rows=None) -> int:
    """The command line; ``rows``, a list, receives the lines' dicts (for a
    caller that reads the numbers, as ``chip_smoke.py`` does)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--grid", type=int, default=48)
    ap.add_argument("--filters", type=int, nargs="+", default=[64, 128, 256])
    ap.add_argument("--batch-per-device", type=int, default=8)
    ap.add_argument("--iters", type=int, default=10)
    ap.add_argument("--configs", default="1x1,2x1,4x1,8x1,2x4",
                    help="comma list of DATAxSPATIAL mesh shapes")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)
    name = card(device)
    grid, filters = (8, (4, 8)) if args.small else (args.grid, tuple(args.filters))
    cards = torch.cuda.device_count() if device.type == "cuda" else 0
    print(f"[scaling] cards={cards} platform={device.type} grid=C{grid} [{name}]",
          file=sys.stderr)
    results = sweep(parse_configs(args.configs), grid=grid, filters=filters,
                    batch_per_device=args.batch_per_device, iters=args.iters, device=device)
    for r, counts in results:
        line = dict(dataclasses.asdict(r), **counts)
        if device.type == "cpu":
            line.update(dict.fromkeys(TIMES))
        line["ranks_share_one_card"] = device.type == "cuda" and r.n_devices > cards
        line["card"] = name
        print(json.dumps(line))
        if rows is not None:
            rows.append(line)
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
