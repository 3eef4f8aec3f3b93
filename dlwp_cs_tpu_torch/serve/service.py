"""Forecast serving: batched autoregressive inference on the device.

The counterpart of ``dlwp_cs_tpu.serve.service``: one resident model,
direct ``forecast`` and ``forecast_ensemble`` calls, and ``submit`` /
``submit_ensemble`` future APIs whose micro-batcher coalesces concurrent
single-window requests with the same parameters into one device dispatch
(padded to a power-of-two bucket), with a bounded queue and request
timeouts.

Request contract: a RAW (physical-units) input window ``(T_in, 6, n, n,
C_var)`` plus its init time; the service normalizes, rolls out and returns
denormalized numpy fields.

Under a device mesh (``mesh=``) the model runs spatially decomposed
(:func:`~dlwp_cs_tpu_torch.parallel.make_spatial_apply`), one process per
rank, in one of two modes (:class:`ForecastService`): collective calls
(every rank calls ``forecast`` / ``forecast_ensemble`` with the same
arguments), or a rank-0 front end (rank 0 submits, the others
``follow()``).
"""

from __future__ import annotations

import contextlib
import dataclasses
import math
import queue
import threading
import time
from collections import deque
from concurrent.futures import Future
from dataclasses import dataclass

import numpy as np
import torch
import torch.distributed as dist
from torch.distributed.device_mesh import DeviceMesh

from dlwp_cs_tpu_torch.estimator import DLWPEstimator
from dlwp_cs_tpu_torch.models import build_model
from dlwp_cs_tpu_torch.parallel.collectives import axis_size
from dlwp_cs_tpu_torch.parallel.mesh import DATA_AXIS
from dlwp_cs_tpu_torch.parallel.sharding import make_spatial_apply
from dlwp_cs_tpu_torch.rollout.ensemble import EnsembleForecast, EnsembleForecaster
from dlwp_cs_tpu_torch.rollout.estimator import Forecast, TimeSeriesEstimator

__all__ = [
    "ForecastService",
    "MicroBatcher",
    "RequestTimeout",
    "ServiceOverloaded",
    "ServiceStats",
]


class ServiceOverloaded(RuntimeError):
    """The batcher queue is full: shed load."""


class RequestTimeout(RuntimeError):
    """A queued request expired before dispatch."""


@dataclass
class ServiceStats:
    """Counters for observability (``ForecastService.stats``)."""

    requests: int = 0
    batches: int = 0
    # bucket padding: requests repeated to fill the power-of-two micro-batch
    padded_members: int = 0
    # mesh data-axis padding: members repeated to fill the data dimension
    padded_mesh: int = 0
    # the mesh front end's broadcasts of a dispatch's host inputs (header,
    # windows, init times, amplitude) over the group's gloo, sent or received
    host_broadcasts: int = 0
    device_seconds: float = 0.0

    @property
    def mean_batch(self) -> float:
        return self.requests / self.batches if self.batches else 0.0


def _resolve(fut: Future, *, result=None, error=None):
    """Resolve a waiter's future, tolerating caller-side cancellation (a
    cancelled Future raises on set_result, which must not kill the worker)."""
    try:
        if error is not None:
            fut.set_exception(error)
        else:
            fut.set_result(result)
    except Exception:  # noqa: BLE001 — cancelled/already-resolved future
        pass


def _bucket(n: int, max_batch: int) -> int:
    """Smallest power of two >= n, capped at max_batch."""
    b = 1
    while b < n:
        b *= 2
    return min(b, max_batch)


@dataclass
class _Request:
    """One queued single-window request."""

    kind: str            # "fc" or "ens"
    window: np.ndarray   # (1, T_in, 6, n, n, C)
    t0: float
    key: tuple           # coalescing key, kind included
    params: dict         # dispatch kwargs shared by the coalesced batch
    fut: Future
    deadline: float | None  # monotonic expiry, None = never


class MicroBatcher:
    """Micro-batching front end: coalesces concurrent single-member
    ``submit`` requests into one dispatch (padded to the next power-of-two
    bucket, padding members discarded).

    The queue is bounded (``max_queue``): a full queue makes ``submit`` raise
    :class:`ServiceOverloaded` at once, and requests older than
    ``request_timeout_s`` at dispatch fail with :class:`RequestTimeout`.

    Subclasses provide ``_forecast_batch(window, t0_days, *, steps,
    normalized)``, ``_check_window(window)`` and ``_worker_context()``
    (and, to serve ``submit_ensemble``, ``_ensemble_batch``), and call
    :meth:`_init_batcher` in their constructor.
    """

    def _init_batcher(self, max_batch: int, max_wait_ms: float,
                      max_queue: int = 64,
                      request_timeout_s: float | None = 120.0):
        self.max_batch = int(max_batch)
        self.max_wait_s = float(max_wait_ms) / 1e3
        self.max_queue = int(max_queue)
        self.request_timeout_s = request_timeout_s
        self.stats = ServiceStats()
        self._queue: queue.Queue = queue.Queue(maxsize=self.max_queue)
        self._lock = threading.Lock()
        self._worker: threading.Thread | None = None
        self._closed = False

    def _enqueue(self, req: _Request) -> Future:
        with self._lock:
            # closed-check + enqueue are atomic against close(): an item
            # enqueued after the close sentinel would never be served
            if self._closed:
                raise RuntimeError("service is closed")
            try:
                self._queue.put_nowait(req)
            except queue.Full:
                raise ServiceOverloaded(
                    f"request queue full ({self.max_queue} pending)"
                ) from None
            if self._worker is None:
                self._worker = threading.Thread(
                    target=self._run_worker, name="forecast-batcher",
                    daemon=True,
                )
                self._worker.start()
        return req.fut

    def _deadline(self) -> float | None:
        if self.request_timeout_s is None:
            return None
        return time.monotonic() + float(self.request_timeout_s)

    def submit(self, window, t0_days, *, steps: int,
               normalized: bool = False) -> Future:
        """Enqueue a single-member request; returns a Future[Forecast].

        Concurrent submissions with the same ``steps`` coalesce into one
        device dispatch.  The worker thread starts lazily on first use.
        Raises :class:`ServiceOverloaded` when the queue is full.
        """
        window = self._check_window(window)
        if window.shape[0] != 1:
            raise ValueError(
                "submit takes one member per request; use forecast() for "
                "explicit batches"
            )
        self._validate_request(int(steps))
        return self._enqueue(_Request(
            kind="fc",
            window=window,
            t0=float(np.asarray(t0_days).reshape(())),
            key=("fc", int(steps), bool(normalized)),
            params={"steps": int(steps), "normalized": bool(normalized)},
            fut=Future(),
            deadline=self._deadline(),
        ))

    def submit_ensemble(self, window, t0_days, *, steps: int, members: int,
                        amplitude=0.05, seed: int = 0, antithetic: bool = True,
                        keep_members: bool = False, normalized: bool = False) -> Future:
        """Enqueue a single-window ensemble request; returns a
        Future[EnsembleForecast].

        Requests with the same ``(steps, members, amplitude, seed,
        antithetic, keep_members, normalized)`` coalesce into one dispatch
        whose members fold into the batch of one rollout.  Different seeds
        do not coalesce (one seeded ``torch.Generator`` draws the whole
        dispatch's perturbations).  A request's perturbations depend on its
        place in the coalesced batch, so a coalesced member forecast
        differs sample by sample (not in distribution) from the same
        request dispatched alone.
        """
        window = self._check_window(window)
        if window.shape[0] != 1:
            raise ValueError(
                "submit_ensemble takes one window per request; use "
                "forecast_ensemble() for explicit batches"
            )
        self._validate_request(int(steps), members=int(members))
        amp = np.asarray(amplitude, np.float32)
        key = ("ens", int(steps), int(members), tuple(np.ravel(amp).tolist()), int(seed),
               bool(antithetic), bool(keep_members), bool(normalized))
        return self._enqueue(_Request(
            kind="ens",
            window=window,
            t0=float(np.asarray(t0_days).reshape(())),
            key=key,
            params={
                "steps": int(steps), "members": int(members), "amplitude": amp,
                "seed": int(seed), "antithetic": bool(antithetic),
                "keep_members": bool(keep_members), "normalized": bool(normalized),
            },
            fut=Future(),
            deadline=self._deadline(),
        ))

    def _validate_request(self, steps: int, members: int | None = None):
        """Cap hook (overridden by ForecastService); default: no caps."""

    def _run_worker(self):
        with self._worker_context():
            self._serve_queue()

    def _serve_queue(self):
        # Mismatched-key requests wait in a worker-local deque, never
        # re-enqueued into the bounded queue (which could deadlock the
        # worker against a full queue only it drains).
        pending: deque = deque()
        closing = False
        while True:
            if pending:
                item = pending.popleft()
            else:
                if closing:
                    return
                item = self._queue.get()
                if item is None:
                    return
            batch = [item]
            key = item.key
            # earlier-stashed peers with the same key join first
            i = 0
            while i < len(pending) and len(batch) < self.max_batch:
                if pending[i].key == key:
                    batch.append(pending[i])
                    del pending[i]
                else:
                    i += 1
            deadline = time.monotonic() + self.max_wait_s
            while len(batch) < self.max_batch and not closing:
                left = deadline - time.monotonic()
                if left <= 0:
                    break
                try:
                    nxt = self._queue.get(timeout=left)
                except queue.Empty:
                    break
                if nxt is None:
                    # sentinel mid-collection: flush this batch and any
                    # pending batches, then exit
                    closing = True
                    break
                if nxt.key == key:
                    batch.append(nxt)
                else:
                    pending.append(nxt)
            self._flush(batch)

    def _flush(self, batch):
        # shed requests whose client deadline passed while queued
        now = time.monotonic()
        alive = []
        for it in batch:
            if it.deadline is not None and now > it.deadline:
                _resolve(it.fut, error=RequestTimeout(
                    f"request expired after {self.request_timeout_s}s in "
                    "queue"
                ))
            else:
                alive.append(it)
        if not alive:
            return
        batch = alive
        windows = np.concatenate([b.window for b in batch], axis=0)
        t0 = np.asarray([b.t0 for b in batch], np.float64)
        bucket = _bucket(len(batch), self.max_batch)
        pad = bucket - len(batch)
        if pad:
            windows = np.concatenate(
                [windows, np.repeat(windows[-1:], pad, axis=0)], axis=0
            )
            t0 = np.concatenate([t0, np.repeat(t0[-1:], pad)])
        ens = batch[0].kind == "ens"
        try:
            fc = self._dispatch(ens, windows, t0, batch[0].params, len(batch))
        except Exception as e:  # noqa: BLE001 — propagate to every waiter
            for b in batch:
                _resolve(b.fut, error=e)
            return
        with self._lock:
            self.stats.requests += len(batch)
            self.stats.batches += 1
            self.stats.padded_members += pad
        for i, b in enumerate(batch):
            if ens:
                out = fc._replace(
                    mean=fc.mean[i : i + 1],
                    spread=fc.spread[i : i + 1],
                    members=None if fc.members is None else fc.members[i : i + 1],
                    init_times=np.asarray([b.t0]),
                )
            else:
                out = fc._replace(fields=fc.fields[i : i + 1], init_times=np.asarray([b.t0]))
            _resolve(b.fut, result=out)

    def _dispatch(self, ens: bool, windows, t0, params: dict, requests: int):
        """One device dispatch of ``requests`` coalesced requests, padded to
        ``windows.shape[0]``."""
        dispatch = self._ensemble_batch if ens else self._forecast_batch
        return dispatch(windows, t0, **params)

    def close(self):
        """Stop the batching worker (pending requests are flushed first)."""
        with self._lock:
            already = self._closed
            self._closed = True
            worker = self._worker
            self._worker = None
        if worker is not None and not already:
            # put(None) can block on a full queue, so the lock is not held:
            # the worker needs it in _flush.  _closed was set under the lock,
            # so _enqueue adds nothing after the sentinel.
            self._queue.put(None)
            worker.join(timeout=30)


def _select_constants(store, names):
    """Constant channels ``names`` (in order) of a store as a
    ``(6, n, n, len(names))`` array, or None when ``names`` is empty."""
    names = list(names)
    if not names:
        return None
    if store.constants is None:
        raise ValueError(f"store has no constants; need {names}")
    have = list(store.constant_names)
    missing = [c for c in names if c not in have]
    if missing:
        raise ValueError(f"constants {missing} not in store {have}")
    return np.asarray(store.constants)[..., [have.index(c) for c in names]]


# the mesh front end's header kinds (ForecastService._send_header)
_STOP, _FORECAST, _ENSEMBLE = 0, 1, 2


class ForecastService(MicroBatcher):
    """Batched rollout serving on top of a loaded
    :class:`~dlwp_cs_tpu_torch.estimator.DLWPEstimator`, on the estimator's
    device (the batcher's worker thread launches there too).

    ``constants`` / ``constants_store``: the normalized static channels in
    ``DataConfig.constants`` order (required when the model uses them).
    ``max_batch``, ``max_wait_ms``, ``max_queue``, ``request_timeout_s``:
    the micro-batcher (see :class:`MicroBatcher`).  ``max_steps`` /
    ``max_members``: server-side caps on client-supplied rollout length and
    ensemble size (``ValueError``).  ``quantize``: serve the same model
    with ``conv_backend="int8"`` (:mod:`~dlwp_cs_tpu_torch.ops.quant`) on a
    copy of the estimator's parameters, quantized at every call; inference
    only, and the activation scale is per model call, so the requests of
    one batch share it, as in the reference.

    ``mesh``: an optional ``DeviceMesh``
    (:func:`~dlwp_cs_tpu_torch.parallel.create_mesh`) on the estimator's
    device type, one process per rank.  The model forward then runs
    domain-decomposed (batch over ``data``, face rows over ``spatial``,
    columns over ``spatial_x``) with the band ring-fix conv; a forecast's
    window batch is padded to a multiple of the ``data`` size, an
    ensemble's to the smallest multiple whose ``batch * members`` the
    ``data`` size divides, as the reference pads them (``stats.padded_mesh``).
    Each dispatch is a collective, made in one of two modes:

    * collective calls: every rank calls ``forecast`` /
      ``forecast_ensemble`` with the same arguments (the same seeded
      ``generator``, or the same ``perturbations``) and gets the same
      result;
    * a rank-0 front end: rank 0 (the mesh's first rank) calls ``submit`` /
      ``submit_ensemble``, whose micro-batcher coalesces as on one device;
      every other rank calls :meth:`follow`, which blocks.  Before each
      dispatch rank 0's batcher thread broadcasts a header (the kind,
      ``steps``, the batch, ``members``, ``amplitude``, ``seed``,
      ``antithetic``, ``keep_members``, ``normalized``) and the window and
      ``t0`` arrays over the process group; each follower runs the same
      dispatch (an ensemble's generator seeded from the broadcast seed, so
      every rank draws the same perturbations).  ``close()`` on rank 0
      flushes the queue and broadcasts a stop header, which ends the
      followers' :meth:`follow`.

    The two modes do not interleave: one thread per rank issues all of the
    service's collectives (gloo collectives issued from two threads would
    interleave differently on each rank and deadlock).  Collective calls
    come before rank 0's first ``submit``; from then until ``close()`` rank
    0's direct ``forecast`` / ``forecast_ensemble`` raise ``RuntimeError``.
    Under a mesh ``close()`` is collective: rank 0 broadcasts the stop
    header, and a rank that is not in :meth:`follow` receives it in its own
    ``close()``.  A follower waits for each header in a broadcast, so the
    process group's timeout bounds the idle time between dispatches.
    """

    def __init__(self, estimator, *, constants=None, constants_store=None,
                 max_batch: int = 8, max_wait_ms: float = 5.0,
                 max_queue: int = 64, request_timeout_s: float | None = 120.0,
                 max_steps: int = 1464, max_members: int = 64,
                 quantize: bool = False, mesh=None):
        if estimator.state is None or estimator.stats is None:
            raise RuntimeError("estimator has no state: load it first")
        if quantize and mesh is not None:
            raise ValueError(
                "quantize=True is incompatible with mesh= (the sharded band "
                "conv would silently override the int8 dispatch)"
            )
        self.config = estimator.config
        dcfg = self.config.data
        if constants is None and constants_store is not None:
            constants = _select_constants(constants_store, dcfg.constants)
        if len(dcfg.constants) and constants is None:
            raise ValueError(
                f"model uses constant channels {dcfg.constants} — pass "
                "constants= or constants_store="
            )
        self.device = estimator.device
        lat, lon = estimator.cs.cell_latlon
        stats = estimator.stats
        self._mean = np.asarray(stats["mean"], np.float32)
        self._std = np.asarray(stats["std"], np.float32)
        self.quantized = bool(quantize)
        model = estimator.model
        if quantize:
            # the same model and parameters, the int8 conv dispatch
            model = build_model(
                dataclasses.replace(self.config.resolved_model(), conv_backend="int8"),
                dcfg.input_channels, device=self.device, generator=torch.Generator(),
            ).eval()
            model.load_state_dict(estimator.model.state_dict())
        self.mesh = mesh
        self._data_div = 1
        self._leading = False  # rank 0 of a mesh, once it has submitted
        self.follow_errors: list[Exception] = []
        if mesh is not None:
            if not isinstance(mesh, DeviceMesh):
                raise TypeError(f"mesh must be a DeviceMesh (create_mesh), got {type(mesh)}")
            if mesh.device_type != self.device.type:
                raise ValueError(
                    f"mesh is on {mesh.device_type}, the estimator on {self.device}"
                )
            model = make_spatial_apply(model, mesh, band_conv="ringfix")
            self._data_div = axis_size(mesh, DATA_AXIS)
            self._root = int(mesh.mesh.flatten()[0])
            self._rank = dist.get_rank()
        self._est = TimeSeriesEstimator(
            model=model,
            data_cfg=dcfg,
            lat=lat,
            lon=lon,
            constants=constants,
            insol_mean=stats["insol_mean"],
            insol_std=stats["insol_std"],
            device=self.device,
        )
        self._init_batcher(max_batch, max_wait_ms, max_queue=max_queue,
                           request_timeout_s=request_timeout_s)
        self.max_steps = int(max_steps)
        self.max_members = int(max_members)

    @classmethod
    def load(cls, path, *, device=None, **kwargs) -> "ForecastService":
        """Build a service from a ``DLWPEstimator.save`` checkpoint
        directory, on ``device`` (the GPU unless named); ``kwargs`` go to
        the constructor."""
        return cls(DLWPEstimator.load(path, device=device), **kwargs)

    def _worker_context(self):
        if self.device.type == "cuda":
            return torch.cuda.device(self.device)
        return contextlib.nullcontext()

    def _validate_request(self, steps: int, members: int | None = None):
        if not 1 <= steps <= self.max_steps:
            raise ValueError(
                f"steps={steps} outside [1, {self.max_steps}] "
                "(server-side cap)"
            )
        if members is not None and not 1 <= members <= self.max_members:
            raise ValueError(
                f"members={members} outside [1, {self.max_members}] "
                "(server-side cap)"
            )

    def submit(self, window, t0_days, *, steps: int, normalized: bool = False) -> Future:
        self._lead("submit")
        return super().submit(window, t0_days, steps=steps, normalized=normalized)

    def submit_ensemble(self, window, t0_days, **kwargs) -> Future:
        self._lead("submit_ensemble")
        return super().submit_ensemble(window, t0_days, **kwargs)

    # -- the mesh front end ------------------------------------------------
    def _lead(self, what: str):
        """Under a mesh, only rank 0 submits; it then leads until close()."""
        if self.mesh is None:
            return
        if self._rank != self._root:
            raise RuntimeError(
                f"{what} under a mesh runs on rank {self._root}; rank {self._rank} "
                "calls follow()"
            )
        self._leading = True

    def _collective_call(self, what: str):
        if self._leading:
            raise RuntimeError(
                f"{what}: rank {self._root} leads the mesh front end (it has "
                "submitted) and the other ranks follow() its batcher until close(); "
                "submit() or submit_ensemble() instead"
            )

    def _dispatch(self, ens: bool, windows, t0, params: dict, requests: int):
        if self.mesh is not None:
            # rank 0's batcher thread: the followers run the same dispatch
            if ens:
                params = dict(params, amplitude=self._amplitude(params["amplitude"]))
            self._send_header(_ENSEMBLE if ens else _FORECAST, windows, t0, params, requests)
        return super()._dispatch(ens, windows, t0, params, requests)

    def _amplitude(self, amplitude) -> np.ndarray:
        """A scalar or per-variable amplitude as ``(C_var,)`` float32."""
        return np.ascontiguousarray(np.broadcast_to(
            np.asarray(amplitude, np.float32), (self.config.data.n_variables,)))

    def _broadcast(self, t):
        """One host input of a dispatch from rank 0 (gloo), counted."""
        dist.broadcast(t, src=self._root)
        self.stats.host_broadcasts += 1

    def _send_header(self, kind: int, windows=None, t0=None, params=None, requests=0):
        p = params or {}
        header = torch.tensor(
            [kind, p.get("steps", 0), 0 if windows is None else windows.shape[0], requests,
             p.get("members", 0), p.get("seed", 0), p.get("antithetic", False),
             p.get("keep_members", False), p.get("normalized", False)], dtype=torch.int64)
        self._broadcast(header)
        if kind == _STOP:
            return
        if kind == _ENSEMBLE:
            self._broadcast(torch.from_numpy(p["amplitude"]))
        self._broadcast(torch.from_numpy(np.ascontiguousarray(windows, np.float32)))
        self._broadcast(torch.from_numpy(np.ascontiguousarray(t0, np.float64)))

    def _recv_header(self):
        """A follower's side of :meth:`_send_header`: ``None`` for the stop
        header, else ``(ens, windows, t0, params, requests)``."""
        header = torch.empty(9, dtype=torch.int64)
        self._broadcast(header)
        (kind, steps, batch, requests, members, seed, antithetic, keep,
         normalized) = header.tolist()
        if kind == _STOP:
            return None
        params = {"steps": steps, "normalized": bool(normalized)}
        if kind == _ENSEMBLE:
            amplitude = torch.empty(self.config.data.n_variables, dtype=torch.float32)
            self._broadcast(amplitude)
            params.update(members=members, amplitude=amplitude.numpy(), seed=seed,
                          antithetic=bool(antithetic), keep_members=bool(keep))
        windows = torch.empty((batch,) + self._window_shape(), dtype=torch.float32)
        t0 = torch.empty(batch, dtype=torch.float64)
        self._broadcast(windows)
        self._broadcast(t0)
        return kind == _ENSEMBLE, windows.numpy(), t0.numpy(), params, requests

    def follow(self) -> int:
        """Run rank 0's front end on this rank (a rank other than 0 of a
        mesh service): each dispatch rank 0's batcher broadcasts, until
        rank 0's ``close()``.  Returns the number of dispatches run.  A
        dispatch that raises here raises on rank 0 too, which hands the
        error to its requests and goes on; so does this loop, keeping the
        exception in ``follow_errors``."""
        if self.mesh is None or self._rank == self._root:
            raise RuntimeError("follow() runs on the ranks other than 0 of a mesh service")
        with self._lock:
            if self._closed:
                raise RuntimeError("service is closed")
        runs = 0
        with self._worker_context():
            while True:
                got = self._recv_header()
                if got is None:
                    with self._lock:
                        self._closed = True
                    return runs
                ens, windows, t0, params, requests = got
                try:
                    super()._dispatch(ens, windows, t0, params, requests)
                except Exception as e:  # noqa: BLE001 — rank 0 reports it to its waiters
                    self.follow_errors.append(e)
                    continue
                with self._lock:
                    self.stats.requests += requests
                    self.stats.batches += 1
                    self.stats.padded_members += windows.shape[0] - requests
                runs += 1

    def close(self):
        """Stop the batching worker (pending requests are flushed first).
        Under a mesh a collective call (see the class docstring): rank 0
        then broadcasts the stop header; a follower that has left
        :meth:`follow` returns at once."""
        if self.mesh is None:
            return super().close()
        with self._lock:
            already = self._closed
            self._closed = True
            worker = self._worker
            self._worker = None
        if already:
            return
        if worker is not None:
            self._queue.put(None)
            worker.join()  # its collectives end before the stop header
        if self._rank == self._root:
            self._send_header(_STOP)
            self._leading = False
        elif self._recv_header() is not None:
            raise RuntimeError(
                f"close() on rank {self._rank} received a dispatch: rank {self._root} "
                "leads a front end, so this rank calls follow()"
            )

    def info(self) -> dict:
        """Model/grid metadata."""
        dcfg = self.config.data
        return {
            "grid_n": dcfg.grid_n,
            "variables": list(dcfg.variables),
            "constants": list(dcfg.constants),
            "input_time_steps": dcfg.input_time_steps,
            "output_time_steps": dcfg.output_time_steps,
            "step_hours": dcfg.step_hours,
            "add_insolation": dcfg.add_insolation,
            "quantized": self.quantized,
        }

    def _window_shape(self):
        dcfg = self.config.data
        n = dcfg.grid_n
        return (dcfg.input_time_steps, 6, n, n, dcfg.n_variables)

    def _check_window(self, window) -> np.ndarray:
        window = np.asarray(window, np.float32)
        want = self._window_shape()
        if window.shape == want:
            window = window[None]
        elif window.ndim != 6 or window.shape[1:] != want:
            raise ValueError(
                f"window must be {want} or (B,) + that shape, got "
                f"{window.shape}"
            )
        return window

    def forecast(self, window, t0_days, *, steps: int,
                 normalized: bool = False) -> Forecast:
        """Synchronous forecast of one window batch.

        ``window``: raw ``(T_in, 6, n, n, C_var)`` (or with a leading batch
        dim); ``t0_days``: scalar / (B,) init times in days since
        2000-01-01.  Returns a denormalized :class:`Forecast` with numpy
        fields unless ``normalized=True`` (then input and output stay in
        training-normalized units).
        """
        self._collective_call("forecast")
        self._validate_request(int(steps))
        fc = self._forecast_batch(window, t0_days, steps=steps,
                                  normalized=normalized)
        with self._lock:
            # direct calls count in the batcher's units: requests = client
            # windows, batches = device dispatches
            self.stats.requests += fc.fields.shape[0]
            self.stats.batches += 1
        return fc

    def forecast_ensemble(self, window, t0_days, *, steps: int, members: int,
                          amplitude=0.05, generator=None, antithetic: bool = True,
                          keep_members: bool = False, normalized: bool = False,
                          perturbations=None) -> EnsembleForecast:
        """Perturbed-IC ensemble forecast of one window batch.

        The raw-units contract of :meth:`forecast`; ``amplitude`` is the
        perturbations' standard deviation in normalized units (scalar or
        per variable ``(C_var,)``), drawn from ``generator`` (a
        ``torch.Generator``; default: a CPU generator seeded with 0) or
        given as unit ``perturbations`` ``(B, members, T_in, 6, n, n,
        C_var)``.  The members fold into the batch of one rollout
        (:mod:`dlwp_cs_tpu_torch.rollout.ensemble`); returns an
        :class:`~dlwp_cs_tpu_torch.rollout.ensemble.EnsembleForecast` of
        numpy arrays, ``mean`` and ``members`` (when kept) denormalized and
        ``spread`` scaled by the std (a spread has no offset) unless
        ``normalized=True``.
        """
        self._collective_call("forecast_ensemble")
        self._validate_request(int(steps), members=int(members))
        fc = self._ensemble_impl(
            window, t0_days, steps=steps, members=members, amplitude=amplitude,
            generator=generator, antithetic=antithetic, keep_members=keep_members,
            normalized=normalized, perturbations=perturbations,
        )
        with self._lock:
            self.stats.requests += fc.mean.shape[0]
            self.stats.batches += 1
        return fc

    def _ensemble_batch(self, window, t0_days, *, steps: int, members: int,
                        amplitude=0.05, seed: int = 0, antithetic: bool = True,
                        keep_members: bool = False,
                        normalized: bool = False) -> EnsembleForecast:
        """The batcher's ensemble dispatch: ``seed`` seeds a CPU
        ``torch.Generator``; leaves the stats to the batcher."""
        return self._ensemble_impl(
            window, t0_days, steps=steps, members=members, amplitude=amplitude,
            generator=torch.Generator().manual_seed(int(seed)), antithetic=antithetic,
            keep_members=keep_members, normalized=normalized,
        )

    def _ensemble_impl(self, window, t0_days, *, steps: int, members: int,
                       amplitude=0.05, generator=None, antithetic: bool = True,
                       keep_members: bool = False, normalized: bool = False,
                       perturbations=None) -> EnsembleForecast:
        window, t0 = self._prepare(window, t0_days, normalized)
        b = window.shape[0]
        # mesh data-axis divisibility: the rollout batch is b * members, so
        # pad b to the smallest b' with (b' * members) % data_div == 0
        unit = self._data_div // math.gcd(int(members), self._data_div)
        pad = (-b) % unit
        if pad:
            window = np.concatenate([window, np.repeat(window[-1:], pad, axis=0)], axis=0)
            t0 = np.concatenate([t0, np.repeat(t0[-1:], pad)])
            if perturbations is not None:
                perturbations = torch.as_tensor(perturbations)
                perturbations = torch.cat(
                    [perturbations, perturbations[-1:].expand(pad, *perturbations.shape[1:])])
        e = self._est
        # a forecaster per call: building its rollout only moves the grid
        # and the constants to the device
        ens = EnsembleForecaster(
            model=e.model, data_cfg=e.data_cfg, lat=e.lat, lon=e.lon,
            constants=e.constants, insol_mean=e.insol_mean,
            insol_std=e.insol_std, device=e.device,
        )
        t0_wall = time.perf_counter()
        fc = ens.predict(
            window, t0, steps=steps, members=members, generator=generator,
            amplitude=amplitude, antithetic=antithetic, keep_members=keep_members,
            perturbations=perturbations,
        )
        mean = fc.mean[:b].cpu().numpy()  # waits for the device
        spread = fc.spread[:b].cpu().numpy()
        mem = None if fc.members is None else fc.members[:b].cpu().numpy()
        with self._lock:
            self.stats.device_seconds += time.perf_counter() - t0_wall
            self.stats.padded_mesh += pad
        if not normalized:
            mean = mean * self._std + self._mean
            spread = spread * self._std  # a spread is scaled, not shifted
            if mem is not None:
                mem = mem * self._std + self._mean
        return fc._replace(mean=mean, spread=spread, members=mem,
                           lead_hours=fc.lead_hours.cpu().numpy(),
                           init_times=np.asarray(fc.init_times)[:b])

    def _prepare(self, window, t0_days, normalized: bool):
        """The checked, normalized window batch and its float64 init times
        (a scalar ``t0_days`` broadcast over the batch)."""
        window = self._check_window(window)
        if not normalized:
            window = (window - self._mean) / self._std
        t0 = np.atleast_1d(np.asarray(t0_days, np.float64))
        if t0.shape[0] == 1 and window.shape[0] > 1:
            t0 = np.repeat(t0, window.shape[0])
        if t0.shape[0] != window.shape[0]:
            raise ValueError(
                f"t0_days batch {t0.shape[0]} != window batch "
                f"{window.shape[0]}"
            )
        return window, t0

    def _forecast_batch(self, window, t0_days, *, steps: int,
                        normalized: bool = False) -> Forecast:
        window, t0 = self._prepare(window, t0_days, normalized)
        b = window.shape[0]
        pad = (-b) % self._data_div  # mesh data-axis divisibility
        if pad:
            window = np.concatenate([window, np.repeat(window[-1:], pad, axis=0)], axis=0)
            t0 = np.concatenate([t0, np.repeat(t0[-1:], pad)])
        t0_wall = time.perf_counter()
        fc = self._est.predict(window, t0, steps=steps)
        fields = fc.fields[:b].cpu().numpy()  # waits for the device
        with self._lock:
            self.stats.device_seconds += time.perf_counter() - t0_wall
            self.stats.padded_mesh += pad
        if not normalized:
            fields = fields * self._std + self._mean
        return fc._replace(
            fields=fields,
            lead_hours=fc.lead_hours.cpu().numpy(),
            init_times=np.asarray(fc.init_times)[:b],
        )
