"""Export a serving artifact from an existing checkpoint.

The counterpart of the reference's ``tools/export_artifact.py``: turns a
``DLWPEstimator.save`` checkpoint directory into a standalone artifact
(:mod:`dlwp_cs_tpu_torch.serve.export`: one ``torch.export`` program of the
rollout step per batch bucket) without retraining or a running service.

    python -m dlwp_cs_tpu_torch.tools.export_artifact --checkpoint CKPT \\
        --out ART --steps 8,56 [--batch-sizes 1,8] [--device cpu]

Several ``--steps`` values share one artifact; the serving layer checks each
request's value against them.  The programs run on the device they were
exported on: the GPU unless ``--device`` names another.  A model with
constant channels takes them from ``--constants-store``, an HDF5 store
(:func:`~dlwp_cs_tpu_torch.data.store.open_store`, which needs h5py).
"""

from __future__ import annotations

import argparse
import sys

__all__ = ["main"]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--checkpoint", required=True, help="DLWPEstimator.save directory")
    ap.add_argument("--out", required=True, help="artifact directory to write")
    ap.add_argument("--steps", required=True,
                    help="comma-separated rollout lengths, e.g. 8,56")
    ap.add_argument("--batch-sizes", default="1",
                    help="comma-separated window batch buckets (default 1)")
    ap.add_argument("--constants-store", default=None,
                    help="predictor store with the model's constant channels")
    ap.add_argument("--platforms", default=None,
                    help="comma-separated platforms: the device's type alone, if given")
    ap.add_argument("--device", default=None,
                    help="device to load and export on (default: the GPU)")
    args = ap.parse_args(argv)

    from dlwp_cs_tpu_torch.data.store import open_store
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator
    from dlwp_cs_tpu_torch.serve import export_forecaster

    store = None if args.constants_store is None else open_store(args.constants_store)
    est = DLWPEstimator.load(args.checkpoint, device=args.device)
    steps = [int(s) for s in args.steps.split(",")]
    target = export_forecaster(
        est,
        args.out,
        steps=steps,
        batch_sizes=[int(b) for b in args.batch_sizes.split(",")],
        constants_store=store,
        platforms=None if args.platforms is None else args.platforms.split(","),
    )
    n_programs = len(list(target.glob("step_b*.pt2")))
    print(f"[export] wrote {target} (steps={steps}, {n_programs} programs)")
    return 0


if __name__ == "__main__":
    sys.exit(main())
