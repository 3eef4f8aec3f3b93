"""Everything a run feeds both sides, made from ``--seed``: the weights,
the constant fields, the raw windows and init times, and the ensembles'
unit perturbations.

Device tensors come from one ``torch.Generator`` on the run's device in a
fixed order, in a few large calls; host choices (which window a request
takes, its init time, which answers are compared) from one numpy
generator.  The same seed gives the same inputs on every run.
"""

from __future__ import annotations

import math

import numpy as np
import torch

from benchmark.reference.models import param_shapes

# flax's lecun_normal: a normal truncated at 2 std, rescaled by the std of
# the truncated unit normal to keep variance 1 / fan_in
_TRUNC_STD = 0.87962566103423978
BIAS_STD = 0.1


class Inputs:
    def __init__(self, seed: int, device):
        self.device = torch.device(device)
        self.gen = torch.Generator(self.device).manual_seed(int(seed))
        self.rng = np.random.default_rng(int(seed))

    def normal(self, *shape):
        return torch.randn(shape, generator=self.gen, device=self.device)

    def weights(self, kind: str, model: dict, data: dict, in_ch: int) -> dict:
        """Every parameter by name, float32: kernels lecun-normal over
        their fan-in, biases normal with std :data:`BIAS_STD`."""
        shapes = param_shapes(kind, model, data, in_ch)
        flat = torch.empty(sum(math.prod(s) for s in shapes.values()), device=self.device)
        torch.nn.init.trunc_normal_(flat, 0.0, 1.0, -2.0, 2.0, generator=self.gen)
        out, at = {}, 0
        for name, shape in shapes.items():
            size = math.prod(shape)
            std = BIAS_STD if len(shape) == 1 else math.sqrt(1.0 / math.prod(shape[:-1])) / _TRUNC_STD
            out[name] = (flat[at:at + size].view(shape) * std).contiguous()
            at += size
        return out

    def constants(self, data: dict):
        n, k = data["grid_n"], len(data["constants"])
        return self.normal(6, n, n, k) if k else None

    def raw_windows(self, count: int, data: dict, stats: dict) -> np.ndarray:
        """``(count, T_in, 6, n, n, C)`` float32 host windows in physical
        units: the climatology plus one standard deviation of noise."""
        n, c = data["grid_n"], len(data["variables"])
        mean = torch.tensor(stats["mean"], device=self.device)
        std = torch.tensor(stats["std"], device=self.device)
        x = self.normal(count, data["input_time_steps"], 6, n, n, c) * std + mean
        return x.cpu().numpy()

    def init_times(self, count: int, span) -> np.ndarray:
        """``count`` init times on the 6-hourly clock inside ``span`` (days
        since 2000-01-01)."""
        lo, hi = span
        return lo + 0.25 * self.rng.integers(0, int((hi - lo) / 0.25), size=count)

    def perturbations(self, count: int, members: int, data: dict, antithetic: bool = True):
        """``(count, members, T_in, 6, n, n, C)`` unit perturbations: member
        0 the control's zeros, then ``+eps, -eps`` pairs (antithetic)."""
        n, c, t = data["grid_n"], len(data["variables"]), data["input_time_steps"]
        rest = (t, 6, n, n, c)
        zero = torch.zeros((count, 1) + rest, device=self.device)
        if antithetic:
            eps = self.normal(count, members // 2, *rest)
            return torch.cat([zero, eps, -eps], dim=1)[:, :members]
        return torch.cat([zero, self.normal(count, members - 1, *rest)], dim=1)
