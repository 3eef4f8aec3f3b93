"""Ensemble rollout throughput: members folded into the batch vs sequential.

The counterpart of the reference's ``tools/ensemble_bench.py``: the design
claim of ``rollout/ensemble.py``, that folding M members into the batch of
one rollout (kernel #1 at batch M) beats M sequential batch-1 rollouts
(the reference-style host loop), for the flagship bf16 U-Net's 28-call
rollout.  Each ensemble row also says whether the folded control member
(member 0, unperturbed) is bitwise equal to the batch-1 rollout of its
window: #1 sums each output in one K order whatever the batch.

The reference's ``--unrolls`` probes its ``lax.scan`` unroll knob; the
port's rollout is a Python loop with no such knob, so the option is
accepted and the batch-1 rollout is timed once (said on stderr).

Timing: the host clock around one call that ends in
``torch.cuda.synchronize()``, median over ``--repeats``
(``tools/timing.py::wall_ms``); the reference's tunnel-overhead
subtraction does not carry over.  On the CPU every time is ``None``.

    python -m dlwp_cs_tpu_torch.tools.ensemble_bench [--steps 28] [--members 8 16]
    python -m dlwp_cs_tpu_torch.tools.ensemble_bench --device cpu --small
"""

from __future__ import annotations

import argparse
import json
import sys

import numpy as np
import torch

from dlwp_cs_tpu_torch.models import DataConfig
from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3
from dlwp_cs_tpu_torch.rollout import ic_perturbations, make_ensemble_rollout, make_rollout_fn
from dlwp_cs_tpu_torch.tools.serve_bench import FILTERS, SMALL, build_models, rollout_inputs
from dlwp_cs_tpu_torch.tools.timing import add_device_args, card, tool_device, wall_ms

__all__ = ["main", "run"]

AMPLITUDE = 0.05  # the perturbations' standard deviation, normalized units


def run(members, *, steps, repeats, device, grid=48, small=False, seed=0):
    """The batch-1 rollout's row, then one row per ensemble size of
    ``members``: the reference's keys, the card, #1's launches of one
    folded call and whether its member 0 equals the batch-1 rollout."""
    n, filters = SMALL if small else (grid, FILTERS)
    dcfg = DataConfig(grid_n=n)
    model = build_models(n, filters, device, seed=seed)["auto"]
    common = dict(rollout_inputs(n), steps=steps, device=device)
    rng = np.random.default_rng(seed)
    window = torch.from_numpy(rng.normal(size=(1, dcfg.input_time_steps, 6, n, n,
                                               dcfg.n_variables)).astype(np.float32)).to(device)
    roll1 = make_rollout_fn(model, dcfg, **common)
    name = card(device)

    def one():
        return roll1(window, 9000.0).fields

    ms, _ = wall_ms(one, 1, repeats, device)
    rows = [{"what": "rollout b=1", "ms": ms, "card": name}]
    control = one()
    for m in members:
        ens = make_ensemble_rollout(model, dcfg, members=m, keep_members=True, **common)
        pert = ic_perturbations(torch.Generator().manual_seed(1), window.shape, m,
                                device=device)

        def folded(ens=ens, pert=pert):
            return ens(window, 9000.0, pert, AMPLITUDE)

        def sequential(m=m):
            return [one() for _ in range(m)]

        before = cs_conv3x3.launches
        out = folded()
        launches = cs_conv3x3.launches - before
        equal = bool(torch.equal(out.members[:, 0], control))
        t_fold, _ = wall_ms(folded, 1, repeats, device)
        t_seq, _ = wall_ms(sequential, 1, repeats, device)
        rows.append({"what": f"ensemble M={m}", "folded_ms": t_fold, "sequential_ms": t_seq,
                     "speedup": None if t_fold is None else t_seq / max(t_fold, 1e-9),
                     "card": name, "launches": {cs_conv3x3.name: launches},
                     "member0_bitwise_equal_to_rollout": equal})
    return rows


def main(argv=None, rows=None) -> int:
    """The command line; ``rows``, a list, receives the rows (for a caller
    that reads the numbers, as ``chip_smoke.py`` does)."""
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--steps", type=int, default=28)
    ap.add_argument("--members", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--grid", type=int, default=48, help="the C grid (--small: C8)")
    ap.add_argument("--repeats", type=int, default=5)
    ap.add_argument("--unrolls", type=int, nargs="+", default=[1, 2, 4],
                    help="accepted: the port's rollout loop has no unroll")
    add_device_args(ap)
    args = ap.parse_args(argv)
    device = tool_device(args)
    name = card(device)
    print(f"steps={args.steps} [{name}]; --unrolls {args.unrolls}: the port's rollout is a "
          "Python loop with no unroll, so the batch-1 rollout is timed once",
          file=sys.stderr, flush=True)
    out = run(args.members, steps=args.steps, repeats=args.repeats, device=device,
              grid=args.grid, small=args.small)
    for r in out:
        if "ms" in r:
            t = "(no time on the CPU)" if r["ms"] is None else f"{r['ms']:7.2f} ms [{name}]"
            print(f"{r['what']}: {t}", file=sys.stderr, flush=True)
        elif r["folded_ms"] is None:
            print(f"{r['what']}: (no times on the CPU); member 0 bitwise "
                  f"{r['member0_bitwise_equal_to_rollout']}", file=sys.stderr, flush=True)
        else:
            print(f"{r['what']}: folded {r['folded_ms']:8.2f} ms  sequential "
                  f"{r['sequential_ms']:8.2f} ms  speedup {r['speedup']:5.2f}x; member 0 "
                  f"bitwise {r['member0_bitwise_equal_to_rollout']} [{name}]",
                  file=sys.stderr, flush=True)
    if rows is not None:
        rows.extend(out)
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
