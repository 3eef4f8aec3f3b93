"""Closed-loop ensemble forecasts: one client sends
``ForecastService.forecast_ensemble`` requests back to back, each a new
raw window and init time, with unit perturbations from a pool made on the
card (member 0 the control, then antithetic pairs).

Traffic parameters: ``steps`` (model calls a forecast), ``members``,
``amplitude`` (perturbation std in normalised units), ``antithetic``,
``window_pool`` and ``perturbation_pool`` (sizes of the pools the requests
cycle through), ``t0_days`` (init-time span, days since 2000-01-01),
``check_sample`` (ensembles compared with the reference) and ``service``
(keyword arguments of ``ForecastService``).

Compared: the ensemble mean and spread of the sampled ensembles in
standard deviations of each variable, RMS over every lead, face and
cell, the worst sample (``mean_err``, ``spread_err``).
"""

from __future__ import annotations

import time

import numpy as np
import torch

from benchmark import program
from benchmark.loads.common import (Reservoir, in_std_units, normalise, precision,
                                    reference_rollout, rms)
from benchmark.inputs import Inputs
from benchmark.reference.rollout import mean_spread


class Load:
    def __init__(self, cell: dict, seed: int, device, layers, work):
        self.cfg, self.tp = cell["model"], cell["traffic_params"]
        self.device = torch.device(device)
        self.seed, self.layers, self.work = seed, layers, work
        self.k = 0  # requests sent so far: a second window goes on from the first

    def setup(self):
        cfg, tp = self.cfg, self.tp
        inp = Inputs(self.seed, self.device)
        self.weights = inp.weights(cfg["kind"], cfg["model"], cfg["data"], cfg["input_channels"])
        self.constants = inp.constants(cfg["data"])
        self.windows = inp.raw_windows(tp["window_pool"], cfg["data"], cfg["stats"])
        self.t0s = inp.init_times(4096, tp["t0_days"])
        self.pert = inp.perturbations(tp["perturbation_pool"], tp["members"], cfg["data"],
                                      tp["antithetic"])
        self.sample = Reservoir(tp["check_sample"], inp.rng)
        self.svc = program.service(cfg, self.weights, self.constants, self.device,
                                   **tp.get("service", {}))
        self._request(-1)  # warm-up: every shape of the window's requests

    def _request(self, k: int):
        tp, w = self.tp, len(self.windows) - 1
        # the warm-up takes the pools' last entries, the window the others
        i = w if k < 0 else k % w
        p = len(self.pert) - 1 if k < 0 else k % max(1, len(self.pert) - 1)
        t0 = float(self.t0s[k % len(self.t0s)])
        return (i, p, t0), self.svc.forecast_ensemble(
            self.windows[i], t0, steps=tp["steps"],
            members=tp["members"], amplitude=tp["amplitude"], keep_members=False,
            perturbations=self.pert[p][None])

    def window(self, seconds: float) -> dict:
        t_start = time.perf_counter()
        end, k0, done, failed = t_start + seconds, self.k, 0, 0
        while time.perf_counter() < end:
            try:
                key, fc = self._request(self.k)
            except Exception:  # noqa: BLE001 — counted, the window goes on
                failed += 1
            else:
                done += 1
                self.sample.offer((key, fc.mean, fc.spread))
            self.k += 1
        window_s = time.perf_counter() - t_start
        tp, data = self.tp, self.cfg["data"]
        calls = done * tp["steps"]
        days = tp["steps"] * data["output_time_steps"] * data["step_hours"] / 24.0
        return {"window_s": window_s, "attempted": self.k - k0, "failed": failed,
                "member_days": done * tp["members"] * days, "calls": calls,
                "model_flops": self.work.forward_flops(self.layers, tp["members"]) * calls,
                "conv_rows": tp["members"]}

    def release(self):
        self.svc.close()
        del self.svc

    def _reference(self, key, tf32: bool):
        i, p, t0 = key
        cfg, tp = self.cfg, self.tp
        ro = reference_rollout(cfg, self.weights, self.constants)
        with precision(tf32):
            w = normalise(self.windows[i], cfg["stats"], self.device)
            members = w[None] + torch.tensor(tp["amplitude"], dtype=torch.float32,
                                             device=self.device) * self.pert[p]
            out = ro.run(members, np.full(tp["members"], t0), tp["steps"])
            return mean_spread(out)

    def _numbers(self, produced) -> dict:
        worst = {"mean_err": 0.0, "spread_err": 0.0}
        for key, (mean, spread) in produced:
            ref_mean, ref_spread = self._reference(key, tf32=False)
            worst["mean_err"] = max(worst["mean_err"], rms(mean, ref_mean))
            worst["spread_err"] = max(worst["spread_err"], rms(spread, ref_spread))
        return worst if produced else {"mean_err": float("inf"), "spread_err": float("inf")}

    def check(self) -> dict:
        stats = self.cfg["stats"]
        return self._numbers([
            (key, (in_std_units(m[0], stats), in_std_units(s[0], stats, spread=True)))
            for key, m, s in self.sample.items])

    def control(self) -> dict:
        """The numbers with the reference in TF32 in the program's place."""
        return self._numbers([(key, self._reference(key, tf32=True))
                              for key, _, _ in self.sample.items])
