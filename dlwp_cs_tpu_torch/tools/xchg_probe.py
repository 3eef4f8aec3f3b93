"""How long a rank waits for its ring neighbours on a card that ranks share:
the premise of the band-row exchange's design (#10, #11).

Every rank of a ring of 2 or 4 processes sharing one card runs rounds: it
writes the round's number into both neighbours' counters (in their
buffers, mapped by CUDA IPC: ``parallel/symmetric.py``) and waits until
its own two counters reach it, so each round is one round trip to each
neighbour.  The wait is taken two ways, in turns (spin, stream, stream,
spin), each over ``rounds`` rounds enqueued back to back between CUDA
events:

* ``spin``: one thread of a one-block kernel spins on the counters
  (``csrc/cs_band_proto.cuh::wait_for``, the first design's wait): the
  context keeps its time slice while it spins;
* ``stream``: ``cuStreamWriteValue64`` into the neighbours' counters and
  ``cuStreamWaitValue64(..., GEQ)`` on one's own, held in the GPU's front
  end, where a context with nothing runnable can give up its slice.

    python -m dlwp_cs_tpu_torch.tools.xchg_probe [--rounds 200] [--out FILE.json]

prints the ms per round of each way on 2 and 4 ranks (the largest rank's
mean of its two turns).  The exchange kernels build on the stream waits
where a round of them costs far less than a spinning one.
"""

from __future__ import annotations

import argparse
import json
import sys
import tempfile

import torch

from dlwp_cs_tpu_torch.parallel import symmetric

__all__ = ["main", "probe_rank", "summary"]

WAYS = ("spin", "stream")


def probe_rank(rounds: int = 200) -> dict:
    """One rank of a ring sharing the card (a collective call of every rank
    of the default group): ms per round of each way, in turns ``spin,
    stream, stream, spin``, after ``rounds`` rounds of warm-up each."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import create_mesh
    from dlwp_cs_tpu_torch.parallel.mesh import SPATIAL_AXIS

    world = dist.get_world_size()
    mesh = create_mesh(data=1, spatial=world)
    dev = torch.device("cuda", torch.cuda.current_device())
    ring = symmetric.ring_buffer(mesh, SPATIAL_AXIS, dev, "probe")
    ring.reserve(1, symmetric.LIB)
    lib = symmetric.LIB.build()
    stream = torch.cuda.current_stream(dev).cuda_stream
    timeout_ns, diag = int(symmetric.SPIN_TIMEOUT_S * 1e9), symmetric._diag()

    def enqueue(way, n):
        for _ in range(n):
            ring.epoch += 1
            if way == "spin":
                err = lib.cs_sym_spin_round(ring.me, ring.right, ring.left, ring.epoch,
                                            timeout_ns, diag, ring.coord, stream)
            else:
                err = lib.cs_sym_round(ring.me, ring.right, ring.left, ring.epoch, stream)
            symmetric._check(err, f"the probe's {way} round")

    out = {"world": world, "rank": dist.get_rank(), "rounds": rounds,
           **{f"{way}_ms": [] for way in WAYS}}
    for way in ("spin", "stream", "stream", "spin"):
        enqueue(way, rounds)  # warm-up
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        enqueue(way, rounds)
        end.record()
        end.synchronize()
        err = symmetric.timeout_error()
        if err is not None:
            raise err
        out[f"{way}_ms"].append(start.elapsed_time(end) / rounds)
    return out


def summary(ranks: list) -> dict:
    """Per way, the largest rank's mean of its two turns (ms per round)."""
    return {f"{way}_ms": max(sum(r[f"{way}_ms"]) / len(r[f"{way}_ms"]) for r in ranks)
            for way in WAYS}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--rounds", type=int, default=200)
    ap.add_argument("--out", default=None, help="write every rank's numbers to this JSON file")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("xchg_probe: needs a CUDA card", file=sys.stderr)
        return 2
    from dlwp_cs_tpu_torch.parallel.launch import spawn_group

    rows = {}
    for world in (2, 4):
        with tempfile.TemporaryDirectory() as workdir:
            ranks = spawn_group(probe_rank, world, args.rounds, workdir=workdir)
        rows[world] = {"ranks": ranks, **summary(ranks)}
        print(f"{world} ranks sharing {torch.cuda.get_device_name(0)}: ms per round trip "
              f"spin {rows[world]['spin_ms']:.4f}, stream {rows[world]['stream_ms']:.4f}",
              flush=True)
    if args.out:
        with open(args.out, "w") as f:
            json.dump(rows, f, indent=1)
    return 0


if __name__ == "__main__":
    sys.exit(main())
