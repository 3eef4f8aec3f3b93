"""Example 5: autoregressive sequence fine-tuning.

The counterpart of the reference's ``examples/05_sequence_train.py``: the
U-Net applied ``--sequence`` times autoregressively per step, the loss
averaged over all the predicted windows (``train/sequence.py``), from
parameters drawn from ``torch.Generator().manual_seed(0)`` (the reference
draws them from ``PRNGKey(0)``).

``--mesh DxS`` trains data-parallel over ``D`` groups with face rows
domain-decomposed over ``S`` (the halo exchange under every conv, the band
ring-fix conv).  The reference builds that mesh over the devices of one
process; here it is ``D * S`` ranks of a gloo group spawned on this host
(``parallel/launch.py``), each running
:func:`~dlwp_cs_tpu_torch.train.make_sharded_sequence_train_step` on the
same global batches; several ranks may share one card.

Usage:
  python -m dlwp_cs_tpu_torch.examples.05_sequence_train --workdir /tmp/dlwp \\
      [--sequence 3] [--steps 200] [--mesh DATAxSPATIAL] [--device cpu]
      (expects 01_build_dataset to have run)
"""

from __future__ import annotations

import argparse
import tempfile
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.data import SeriesDataset, open_store, select_constants
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry import CubedSphere
from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, TrainConfig, UNetConfig
from dlwp_cs_tpu_torch.train import (
    init_state,
    make_optimizer,
    make_sequence_loss,
    make_sequence_train_step,
    make_sharded_sequence_train_step,
    model_apply,
    params_of,
)

__all__ = ["main", "mesh_rank", "parse_mesh", "sequence_train"]


def parse_mesh(text: str) -> tuple[int, int]:
    """``"2x4"`` -> ``(2, 4)``: the data and spatial sizes."""
    d, sp = (int(v) for v in text.lower().split("x"))
    return d, sp


def sequence_train(store, *, sequence: int = 3, steps: int = 100, batch: int = 8,
                   filters=(8, 16), lr: float = 5e-4, mesh=None, params=None, device=None,
                   log=print) -> dict:
    """``steps`` sequence-training steps on ``store`` (a ``MemoryStore``),
    from ``params`` (by name; default: the U-Net's seeded initialisation)
    on ``device`` (``None``: the GPU).  With ``mesh`` (the calling rank's
    ``create_mesh(data=D, spatial=S)``) every rank of the mesh runs this
    with the same store and arguments.  Returns ``losses`` (one per step)
    and the final ``state``."""
    dev = resolve_device(device)
    n = store.grid_n
    lat, lon = CubedSphere(n).cell_latlon
    dcfg = DataConfig(grid_n=n, variables=store.variables, constants=store.constant_names)
    ds = SeriesDataset(store, dcfg, lat=lat, lon=lon, batch_size=batch, shuffle=True,
                       sequence=sequence)
    model = CubeSphereUNet(UNetConfig(output_channels=dcfg.output_channels,
                                      filters=tuple(filters)),
                           dcfg.input_channels, device=dev,
                           generator=torch.Generator().manual_seed(0))
    constants = select_constants(store, dcfg.constants)
    common = dict(lat=lat, lon=lon, constants=constants, insol_mean=ds.insol_mean,
                  insol_std=ds.insol_std, sequence=sequence)
    opt = make_optimizer(TrainConfig(learning_rate=lr))
    if mesh is not None:
        step = make_sharded_sequence_train_step(model_apply(model), dcfg, opt, mesh, **common)
    else:
        step = make_sequence_train_step(make_sequence_loss(model_apply(model), dcfg, **common),
                                        opt)
    if params is None:
        params = params_of(model)
    state = init_state({k: v.to(dev) for k, v in params.items()}, opt)

    if len(ds) == 0:
        raise SystemExit(
            f"dataset yields no batches (batch_size {ds.batch_size} > "
            f"{ds.n_samples} windows) — lower --batch"
        )
    # the sharded step cuts each rank's block from the global batch itself
    feed = (lambda a: torch.as_tensor(a)) if mesh is not None else (
        lambda a: torch.as_tensor(a).to(dev))
    done = 0
    losses = []
    while done < steps:
        for window, targets, t0 in ds:
            state, m = step(state, feed(window), feed(t0), feed(targets))
            losses.append(float(m["loss"]))
            done += 1
            if done % 20 == 0:
                log(f"step {done}: seq-loss {np.mean(losses[-20:]):.5f}")
            if done >= steps:
                break
    return {"losses": losses, "state": state}


def mesh_rank(store, data: int, spatial: int, kwargs: dict) -> dict:
    """One rank of ``--mesh DATAxSPATIAL``: :func:`sequence_train` on this
    rank's ``create_mesh(data=data, spatial=spatial)``; rank 0 logs.
    Returns the rank's ``losses``."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import create_mesh

    mesh = create_mesh(data=data, spatial=spatial, device=kwargs.get("device"))
    log = print if dist.get_rank() == 0 else (lambda *a: None)
    return {"losses": sequence_train(store, mesh=mesh, log=log, **kwargs)["losses"]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--workdir", required=True)
    ap.add_argument("--sequence", type=int, default=3)
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=8)
    ap.add_argument("--filters", type=int, nargs="+", default=[8, 16])
    ap.add_argument("--lr", type=float, default=5e-4)
    ap.add_argument(
        "--mesh",
        default=None,
        help="DATAxSPATIAL mesh, e.g. 2x4: that many ranks spawned on this host "
        "(default: one process)",
    )
    ap.add_argument("--device", default=None, help="training device (default: the GPU)")
    args = ap.parse_args(argv)
    resolve_device(args.device)
    workdir = Path(args.workdir)

    store = open_store(workdir / "predictors_cs.h5").load()
    kwargs = dict(sequence=args.sequence, steps=args.steps, batch=args.batch,
                  filters=tuple(args.filters), lr=args.lr, device=args.device)
    if args.mesh:
        from dlwp_cs_tpu_torch.parallel.launch import spawn_group

        d, sp = parse_mesh(args.mesh)
        print(f"mesh: data={d} x spatial={sp} over {d * sp} ranks", flush=True)
        with tempfile.TemporaryDirectory(dir=workdir) as ranks_dir:
            losses = spawn_group(mesh_rank, d * sp, store, d, sp, kwargs,
                                 workdir=ranks_dir)[0]["losses"]
    else:
        losses = sequence_train(store, **kwargs)["losses"]
    print(f"final sequence loss (mean of last 20): {np.mean(losses[-20:]):.5f}")
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
