"""What the loads share: the precision switch of the reference, the
comparison numbers and a seeded reservoir of answers to check."""

from __future__ import annotations

import contextlib

import numpy as np
import torch

from benchmark.reference.geometry import cell_latlon
from benchmark.reference.rollout import Rollout


@contextlib.contextmanager
def precision(tf32: bool):
    """float32 matrix products and convs in full float32 (``tf32=False``,
    the reference) or in TF32 (the control)."""
    m, c = torch.backends.cuda.matmul, torch.backends.cudnn
    saved = (m.allow_tf32, c.allow_tf32)
    m.allow_tf32 = c.allow_tf32 = tf32
    try:
        yield
    finally:
        m.allow_tf32, c.allow_tf32 = saved


def rms(a, b) -> float:
    """Root mean square of ``a - b`` (numpy or tensors), in float64."""
    a = np.asarray(a.detach().cpu() if isinstance(a, torch.Tensor) else a, np.float64)
    b = np.asarray(b.detach().cpu() if isinstance(b, torch.Tensor) else b, np.float64)
    return float(np.sqrt(np.mean(np.square(a - b))))


class Reservoir:
    """A uniform sample of ``size`` items of a stream, drawn from ``rng``:
    the same stream and seed keep the same items."""

    def __init__(self, size: int, rng):
        self.size, self.rng, self.seen, self.items = size, rng, 0, []

    def offer(self, item):
        if self.seen < self.size:
            self.items.append(item)
        else:
            j = int(self.rng.integers(0, self.seen + 1))
            if j < self.size:
                self.items[j] = item
        self.seen += 1


def normalise(raw, stats, device):
    """Raw host fields ``(..., C)`` to normalised float32 on ``device``."""
    mean = torch.tensor(stats["mean"], dtype=torch.float32, device=device)
    std = torch.tensor(stats["std"], dtype=torch.float32, device=device)
    return (torch.as_tensor(raw, device=device) - mean) / std


def in_std_units(raw, stats, *, spread: bool = False) -> np.ndarray:
    """The program's raw float32 answers back in normalised units, in
    float64 (a spread has no offset)."""
    raw = np.asarray(raw, np.float64)
    std = np.asarray(stats["std"], np.float64)
    return raw / std if spread else (raw - np.asarray(stats["mean"], np.float64)) / std


def reference_rollout(cfg: dict, weights: dict, constants) -> Rollout:
    """The plain reference's rollout of the configuration ``cfg`` on the
    benchmark's weights and constants."""
    lat, lon = cell_latlon(cfg["data"]["grid_n"])
    return Rollout(cfg["kind"], weights, cfg["model"], cfg["data"], cfg["stats"], constants,
                   lat, lon)
