"""Exported serving artifacts: ``torch.export`` programs of the rollout step,
replayed on the GPU as one CUDA graph per forecast.

The counterpart of ``dlwp_cs_tpu.serve.export``.  The reference serializes
the whole compiled rollout as StableHLO and serves it as one dispatch per
forecast (``jax.jit(exp.call)``).  Here each window batch bucket gets one
``torch.export`` program of ONE model call of the rollout
(:class:`~dlwp_cs_tpu_torch.rollout.estimator.RolloutStep`: the insolation
and the channel assembly, the model with its weights baked in, the next
window and the advanced clock), written with ``torch.export.save``.
:class:`ExportedForecaster` loops it ``steps`` times.  On the GPU the first
request at a ``(steps, bucket)`` runs that loop eagerly once (the kernels'
plans and buffers settle), then captures the whole rollout (the ``steps``
calls, the clock reduction and the copy into a static output buffer) into
one ``torch.cuda.CUDAGraph`` on static input buffers and replays it from
then on: one dispatch per forecast.  On the CPU the loop runs eagerly
through the kernels' plain versions.

Artifact layout (a directory)::

    meta.json        steps values, batch sizes, window shape, stats, platforms
    stats.npz        per-variable mean/std (raw-units contract)
    step_b{N}.pt2    one exported program per window batch bucket

The programs call the 3x3 conv kernels as the operators that
:mod:`dlwp_cs_tpu_torch.ops.library` registers, so a process that serves an
artifact needs that module (imported here), not the model classes, the
estimator or a checkpoint.  ``steps`` values are served by the loop and
checked against the artifact's list, as the reference checks its
executables'.  A StableHLO artifact of the reference is not a PyTorch one:
the format guard rejects it.
"""

from __future__ import annotations

import contextlib
import json
import threading
import time
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry.insolation import INSOLATION_PERIOD_DAYS
from dlwp_cs_tpu_torch.ops.library import use_library_ops
from dlwp_cs_tpu_torch.ops.ringfix import _full_f32
from dlwp_cs_tpu_torch.rollout.estimator import Forecast, RolloutStep
from dlwp_cs_tpu_torch.serve.service import MicroBatcher, _select_constants

__all__ = [
    "ExportedForecastService",
    "ExportedForecaster",
    "export_forecaster",
]

_FORMAT = "dlwp_cs_tpu_torch.export/1"


def _program_name(b: int) -> str:
    return f"step_b{b}.pt2"


def export_forecaster(
    estimator,
    path,
    *,
    steps,
    batch_sizes=(1,),
    constants=None,
    constants_store=None,
    platforms=None,
) -> Path:
    """Export the fitted estimator's rollout step as a standalone artifact.

    Args:
      estimator: a fitted/loaded
        :class:`~dlwp_cs_tpu_torch.estimator.DLWPEstimator`; the programs
        run on its device.
      path: artifact directory (created/overwritten; stale ``step_b*.pt2``
        programs of a previous export are removed once every new program
        has been written).
      steps: model calls per forecast (56 = 14 days at the default 2 x 6 h
        a call): an int or an iterable of ints, each a rollout length the
        artifact serves.
      batch_sizes: window batch buckets; shapes are static in an exported
        program, so each becomes one program.
      constants / constants_store: static channels, as for
        :class:`~dlwp_cs_tpu_torch.serve.ForecastService` (baked into the
        programs).
      platforms: ``None``, or the estimator's device type alone (``["cuda"]``
        or ``["cpu"]``): a program is traced on the device it will run on.

    Exported signature per bucket: ``(window (B, T_in, 6, n, n, C) f32
    normalized, t_days (B,) f32 reduced mod 1461) -> (next window, the
    call's (B, T_out, 6, n, n, C) fields, t_days + T_out steps)``.
    """
    if estimator.state is None or estimator.stats is None:
        raise RuntimeError("estimator has no state: fit or load it first")
    dcfg = estimator.config.data
    if constants is None and constants_store is not None:
        constants = _select_constants(constants_store, dcfg.constants)
    if len(dcfg.constants) and constants is None:
        raise ValueError(
            f"model uses constant channels {dcfg.constants} — pass "
            "constants= or constants_store="
        )
    steps_values = sorted(
        {int(steps)} if np.isscalar(steps) else {int(s) for s in steps}
    )
    if not steps_values:
        raise ValueError("steps must name at least one rollout length")
    batch_sizes = sorted(set(int(b) for b in batch_sizes))
    if not batch_sizes:
        raise ValueError("batch_sizes must name at least one bucket")
    dev = estimator.device
    if platforms is not None and list(platforms) != [dev.type]:
        raise ValueError(
            f"the programs are traced on the estimator's device ({dev.type}); "
            f"platforms={list(platforms)} names another"
        )
    n, t_in, c_var = dcfg.grid_n, dcfg.input_time_steps, dcfg.n_variables
    lat, lon = estimator.cs.cell_latlon
    stats = estimator.stats
    step = RolloutStep(
        estimator.model, dcfg, lat=lat, lon=lon, constants=constants,
        insol_mean=stats["insol_mean"], insol_std=stats["insol_std"], device=dev,
    )
    target = Path(path)
    target.mkdir(parents=True, exist_ok=True)
    # Stage every program under a tmp name first, then publish so that a
    # failure or a crash at any point leaves a meta.json whose programs all
    # exist: the programs are renamed into place first, then stats.npz and
    # meta.json are each written to a tmp name and renamed over the old one,
    # meta.json last, and only then are the programs of buckets the new
    # meta.json does not name deleted.
    staged: dict[str, Path] = {}
    try:
        for b in batch_sizes:
            window = torch.zeros((b, t_in, 6, n, n, c_var), dtype=torch.float32, device=dev)
            t = torch.zeros((b,), dtype=torch.float32, device=dev)
            tmp = target / f".step_b{b}.tmp.pt2"
            staged[_program_name(b)] = tmp
            with torch.no_grad(), use_library_ops():
                # one real call first: the halo's index tables are memoised
                # per (n, device) at first use, which must not be under the
                # tracer's fake tensors
                step(window, t)
                program = torch.export.export(step, (window, t), strict=False)
            torch.export.save(program, tmp)
        programs = set(staged)
        for name in sorted(programs):
            staged[name].replace(target / name)
        meta = {
            "format": _FORMAT,
            # the longest product, as the reference's primary value; the full
            # set lives in steps_values
            "steps": steps_values[-1],
            "steps_values": steps_values,
            "batch_sizes": batch_sizes,
            "window_shape": [t_in, 6, n, n, c_var],
            "variables": list(dcfg.variables),
            "platforms": [dev.type],
            # temporal contract: clients sample the input window at this spacing
            "step_hours": dcfg.step_hours,
            "output_time_steps": dcfg.output_time_steps,
        }
        staged["stats.npz"] = target / ".stats.tmp.npz"
        np.savez(
            staged["stats.npz"],
            mean=np.asarray(stats["mean"], np.float32),
            std=np.asarray(stats["std"], np.float32),
        )
        staged["stats.npz"].replace(target / "stats.npz")
        staged["meta.json"] = target / ".meta.tmp.json"
        staged["meta.json"].write_text(json.dumps(meta, indent=1))
        staged["meta.json"].replace(target / "meta.json")
    finally:
        for tmp in staged.values():
            tmp.unlink(missing_ok=True)
    for old in target.glob("step_b*.pt2"):
        if old.name not in programs:
            old.unlink()
    return target


class _Captured:
    """One ``(steps, bucket)`` rollout captured as a CUDA graph, with its
    static input and output buffers."""

    def __init__(self, program, steps, window, t0):
        self.window = window.clone()
        self.t0 = t0.clone()
        self.graph = torch.cuda.CUDAGraph()
        with torch.cuda.graph(self.graph):
            self.out = _rollout(program, self.window, self.t0, steps)

    def __call__(self, window, t0):
        self.window.copy_(window)
        self.t0.copy_(t0)
        self.graph.replay()
        return self.out.cpu()


def _rollout(program, window, t0, steps):
    """``steps`` calls of an exported step: ``(B, steps * T_out, 6, n, n,
    C)`` fields.  The clock is reduced mod 1461 on the device as the live
    rollout reduces it."""
    t = torch.remainder(t0, INSOLATION_PERIOD_DAYS)
    outs = []
    for _ in range(steps):
        window, out, t = program(window, t)
        outs.append(out)
    return torch.cat(outs, dim=1)


class ExportedForecaster:
    """Serve forecasts from an :func:`export_forecaster` artifact on
    ``device`` (the GPU unless named; it must be the artifact's platform).

    Needs only this module and the operators of
    :mod:`dlwp_cs_tpu_torch.ops.library` (no model classes, no checkpoint).
    Same raw-units contract as ``ForecastService.forecast``.  On a CUDA
    device each ``(steps, bucket)`` is one CUDA-graph replay per forecast
    after its first request; a kernel that does not build or launch
    raises, with no fallback to the plain versions.
    """

    def __init__(self, path, *, device=None):
        target = Path(path)
        self.meta = json.loads((target / "meta.json").read_text())
        fmt = self.meta.get("format")
        if fmt != _FORMAT:
            raise ValueError(f"unsupported artifact format {fmt!r}")
        self.device = resolve_device(device)
        if self.device.type not in self.meta["platforms"]:
            raise ValueError(
                f"artifact exported for {self.meta['platforms']}, asked to run on "
                f"{self.device}"
            )
        with np.load(target / "stats.npz") as f:
            self._mean = f["mean"].astype(np.float32)
            self._std = f["std"].astype(np.float32)
        self.steps_values = [int(s) for s in self.meta["steps_values"]]
        self.batch_sizes = sorted(int(b) for b in self.meta["batch_sizes"])
        self.variables = tuple(self.meta["variables"])
        self._programs = {
            b: torch.export.load(target / _program_name(b)).module()
            for b in self.batch_sizes
        }
        self._graphs: dict[tuple[int, int], _Captured] = {}
        # one forecast at a time: a graph's static buffers are shared
        self._lock = threading.Lock()

    @classmethod
    def load(cls, path, *, device=None) -> "ExportedForecaster":
        return cls(path, device=device)

    def _lead_hours(self, steps: int) -> np.ndarray:
        t_out = int(self.meta["output_time_steps"])
        return (np.arange(steps * t_out) + 1.0) * self.meta["step_hours"]

    def _resolve_steps(self, steps) -> int:
        if steps is None:
            if len(self.steps_values) > 1:
                raise ValueError(
                    f"artifact exports steps={self.steps_values}; pass "
                    "steps= explicitly"
                )
            return self.steps_values[0]
        if int(steps) not in self.steps_values:
            raise ValueError(
                f"this artifact was exported with steps={self.steps_values}; "
                f"got steps={int(steps)}"
            )
        return int(steps)

    def _check_window(self, window) -> np.ndarray:
        want = tuple(self.meta["window_shape"])
        window = np.asarray(window, np.float32)
        if window.shape == want:
            window = window[None]
        elif window.ndim != 6 or window.shape[1:] != want:
            raise ValueError(
                f"window must be {want} or (B,) + that shape, got "
                f"{window.shape}"
            )
        return window

    def forecast(self, window, t0_days, *, steps=None,
                 normalized: bool = False) -> Forecast:
        """Forecast one window batch.

        ``window``: raw ``(T_in, 6, n, n, C_var)`` or ``(B,) + that``;
        ``t0_days``: scalar / ``(B,)`` init times (days since 2000-01-01);
        ``steps``: one of the artifact's values (optional when it has
        exactly one).  The batch buckets up to the next exported size (error
        if above the largest); padding members are discarded.
        """
        steps = self._resolve_steps(steps)
        window = self._check_window(window)
        b = window.shape[0]
        bucket = next((s for s in self.batch_sizes if s >= b), None)
        if bucket is None:
            raise ValueError(
                f"batch {b} exceeds the largest exported size "
                f"{self.batch_sizes[-1]}"
            )
        t0 = np.atleast_1d(np.asarray(t0_days, np.float64))
        if t0.shape[0] == 1 and b > 1:
            t0 = np.repeat(t0, b)
        if t0.shape[0] != b:
            raise ValueError(
                f"t0_days batch {t0.shape[0]} != window batch {b}"
            )
        if not normalized:
            window = (window - self._mean) / self._std
        pad = bucket - b
        if pad:
            window = np.concatenate(
                [window, np.repeat(window[-1:], pad, axis=0)], axis=0
            )
            t0 = np.concatenate([t0, np.repeat(t0[-1:], pad)])
        # float64 periodic reduction before the f32 cast (the insolation
        # clock's precision, rollout/estimator.py)
        t0_red = np.mod(t0, INSOLATION_PERIOD_DAYS).astype(np.float32)
        fields = self._run(steps, bucket, window, t0_red)[:b]
        if not normalized:
            fields = fields * self._std + self._mean
        return Forecast(
            fields=fields,
            lead_hours=self._lead_hours(steps),
            init_times=t0[:b],
            variables=self.variables,
        )

    def _run(self, steps, bucket, window, t0):
        """The normalized fields of ``steps`` calls at ``bucket``, numpy."""
        program = self._programs[bucket]
        window = torch.from_numpy(np.ascontiguousarray(window, np.float32)).to(self.device)
        t0 = torch.from_numpy(t0).to(self.device)
        # float32 cuDNN convs (the ConvLSTM's SAME convs) in full float32,
        # as the live path runs them; the choice is baked in at capture
        with self._lock, torch.no_grad(), _full_f32(window):
            if self.device.type != "cuda":
                return _rollout(program, window, t0, steps).numpy()
            captured = self._graphs.get((steps, bucket))
            if captured is None:
                # eagerly once: the plans, the ring kernel's count buffers
                # and cuDNN's algorithms settle outside the capture
                _rollout(program, window, t0, steps)
                torch.cuda.synchronize(self.device)
                captured = _Captured(program, steps, window, t0)
                self._graphs[steps, bucket] = captured
            return captured(window, t0).numpy()


class ExportedForecastService(MicroBatcher):
    """Serve an artifact behind the micro-batching HTTP front end.

    The deployment without model code: a process with this package serves
    ``/forecast`` from an :func:`export_forecaster` directory,
    ``ForecastHTTPServer(ExportedForecastService(path))``.  ``steps`` must
    be one of the artifact's values; any other is rejected (HTTP 400).
    ``/ensemble`` is not available on artifact backends (the perturbations
    need the live model): the front end replies 400.  ``device``: as
    :class:`ExportedForecaster` (the GPU unless named).
    """

    def __init__(self, artifact, *, max_batch: int | None = None,
                 max_wait_ms: float = 5.0, max_queue: int = 64,
                 request_timeout_s: float | None = 120.0, device=None):
        exp = (artifact if isinstance(artifact, ExportedForecaster)
               else ExportedForecaster.load(artifact, device=device))
        self._exp = exp
        self.steps = int(exp.meta["steps"])
        self.steps_values = list(exp.steps_values)
        self.quantized = False
        self.device = exp.device
        cap = max(exp.batch_sizes)
        self._init_batcher(
            cap if max_batch is None else min(int(max_batch), cap),
            max_wait_ms, max_queue=max_queue,
            request_timeout_s=request_timeout_s,
        )

    def _worker_context(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _check_window(self, window):
        return self._exp._check_window(window)

    def _validate_request(self, steps: int, members: int | None = None):
        self._exp._resolve_steps(steps)  # submit-time rejection

    def forecast(self, window, t0_days, *, steps: int,
                 normalized: bool = False) -> Forecast:
        fc = self._forecast_batch(window, t0_days, steps=steps,
                                  normalized=normalized)
        with self._lock:
            self.stats.requests += fc.fields.shape[0]
            self.stats.batches += 1
        return fc

    def _forecast_batch(self, window, t0_days, *, steps: int,
                        normalized: bool = False) -> Forecast:
        t0_wall = time.perf_counter()
        fc = self._exp.forecast(window, t0_days, steps=steps,
                                normalized=normalized)
        with self._lock:
            self.stats.dispatch_seconds += time.perf_counter() - t0_wall
        return fc

    def info(self) -> dict:
        meta = self._exp.meta
        t_in, _, n, _, c_var = meta["window_shape"]
        return {
            "grid_n": n,
            "variables": list(meta["variables"]),
            "input_time_steps": t_in,
            "steps": meta["steps"],
            "steps_values": self.steps_values,
            "batch_sizes": meta["batch_sizes"],
            "platforms": meta["platforms"],
            "step_hours": meta.get("step_hours"),
            "output_time_steps": meta.get("output_time_steps"),
            "backend": "aot-artifact",
            "quantized": False,
        }
