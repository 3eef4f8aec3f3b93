"""Series windowing dataset: the training-batch assembler.

The counterpart of ``dlwp_cs_tpu.data.series``: serves input windows
``t-(T_in-1)dt .. t`` and target windows ``t+dt .. t+T_out*dt``, folds time
x variable into channels, appends TOA insolation channels per sample time
and static constant channels, supports shuffling, sub-sampling interval and
drop-remainder.  Batch assembly is vectorized numpy on the host (insolation
through the numpy copy of the formula, :func:`insolation_np`), producing
``(B, 6, n, n, C)`` float32 arrays for
:func:`~dlwp_cs_tpu_torch.data.prefetch.prefetch_to_device`.  Batches equal
the reference's for the same store and seed.
"""

from __future__ import annotations

import itertools
from collections import deque

import numpy as np

from dlwp_cs_tpu_torch.data.store import select_constants
from dlwp_cs_tpu_torch.geometry.insolation import INSOLATION_PERIOD_DAYS, insolation_np
from dlwp_cs_tpu_torch.models.config import DataConfig

__all__ = ["SeriesDataset", "insolation_stats"]


def insolation_stats(lat, lon, *, n_times: int = 64) -> tuple[float, float]:
    """Deterministic (mean, std) of insolation over a year on this grid."""
    times = np.linspace(0.0, 365.25, n_times, endpoint=False)
    vals = insolation_np(times[:, None, None, None], lat, lon)
    return float(vals.mean()), float(vals.std())


class SeriesDataset:
    """Sliding-window (inputs, targets) batches from a predictor store.

    Args:
      store: a MemoryStore (``fields (T,6,n,n,C)``, ``times``,
        ``mean``/``std``, optional ``constants``).
      cfg: DataConfig (time steps, insolation, constants selection).
      lat, lon: ``(6, n, n)`` radians (from ``CubedSphere.cell_latlon``).
      batch_size: samples per batch.
      shuffle: reshuffle sample order each epoch.
      interval: stride (in store samples) of one model time step dt — e.g.
        interval=2 on 3-hourly data gives dt=6h (reference's ``interval``).
      sample_stride: stride between consecutive training samples.
      drop_remainder: drop the final short batch (static shapes for jit).
      scale: normalize fields with the store's mean/std.
      channels_last: if False, emit ``(B, C, 6, n, n)`` (the reference's
        channels-first generator option); the compute path is channels-last,
        so this exists for API parity and external consumers.
      impute: the reference's ``impute_missing`` analog.  ``False``: NaNs
        pass through.  ``True`` / ``'zero'``: fill NaNs with 0 (the
        post-normalization valid-cell mean).  ``'cell_mean'``: fill each
        masked cell with its OWN time-mean (a fitted per-feature imputer,
        like the reference's sklearn Imputer) — cells that are NaN at every
        time fall back to 0.
      sample_slice: optional ``slice`` restricting which window starts this
        dataset serves — the per-host input-sharding hook for multi-host
        training (each host constructs its own disjoint slice, e.g. via
        ``parallel.multihost.host_batch_slice`` semantics over samples).
      sequence: if set to ``k``, batches are for autoregressive multi-step
        training (the reference generator's ``sequence`` mode):
        ``(window (B, Tin, 6, n, n, C) raw normalized fields,
        targets (B, k, 6, n, n, Tout*C), t0_days (B,))``; insolation and
        constants are attached by the sequence loss at each rollout step
        (``train/sequence.py``).
      seed: shuffle seed.
    """

    def __init__(
        self,
        store,
        cfg: DataConfig,
        *,
        lat,
        lon,
        batch_size: int = 8,
        shuffle: bool = False,
        interval: int = 1,
        sample_stride: int = 1,
        drop_remainder: bool = True,
        scale: bool = True,
        channels_last: bool = True,
        impute: bool | str = False,
        sample_slice: slice | None = None,
        sequence: int | None = None,
        seed: int = 0,
        workers: int = 0,
    ):
        self.store = store
        self.cfg = cfg
        self.lat = np.asarray(lat)
        self.lon = np.asarray(lon)
        self.batch_size = int(batch_size)
        self.shuffle = bool(shuffle)
        self.interval = int(interval)
        self.drop_remainder = bool(drop_remainder)
        self.scale = bool(scale)
        self.channels_last = bool(channels_last)
        if impute is True:
            impute = "zero"
        if impute not in (False, "zero", "cell_mean"):
            raise ValueError(
                f"impute must be False/True/'zero'/'cell_mean', got {impute!r}"
            )
        self.impute = impute
        self._impute_fill_cache: np.ndarray | None = None
        self.sequence = None if sequence is None else int(sequence)
        if self.sequence is not None and self.sequence < 1:
            raise ValueError(f"sequence must be >= 1, got {sequence}")
        if self.sequence is not None and not self.channels_last:
            # sequence batches are raw (B, Tin, 6, n, n, C) windows consumed
            # by the in-graph assembly of train/sequence.py, which is
            # channels-last by contract; silently ignoring the flag would
            # hand a channels-first consumer mislabeled axes
            raise ValueError(
                "channels_last=False is not supported in sequence mode "
                "(sequence windows feed the in-graph channels-last assembly)"
            )
        self._rng = np.random.default_rng(seed)
        # batch-assembly thread pool size; > 1 makes __iter__ delegate to
        # iter_batches (same delivery order — see its docstring)
        self.workers = int(workers)

        t_total = store.fields.shape[0]
        n_out_windows = self.sequence or 1
        span = (
            cfg.input_time_steps + n_out_windows * cfg.output_time_steps - 1
        ) * self.interval
        if t_total <= span:
            raise ValueError(
                f"store has {t_total} samples; window needs > {span}"
            )
        self._starts = np.arange(0, t_total - span, sample_stride)
        if sample_slice is not None:
            self._starts = self._starts[sample_slice]
            if len(self._starts) == 0:
                raise ValueError(f"sample_slice {sample_slice} selects no samples")
        if cfg.add_insolation:
            self.insol_mean, self.insol_std = insolation_stats(self.lat, self.lon)
        else:
            self.insol_mean, self.insol_std = 0.0, 1.0
        self._mean = np.asarray(store.mean, np.float32)
        self._std = np.asarray(store.std, np.float32)
        # pre-normalized training cache (store.normalize_store): the
        # per-batch normalization pass — a full read-modify-write of every
        # window on the host hot path — is already baked into the fields
        self.prenormalized = bool(
            getattr(store, "attrs", {}).get("normalized")
        )
        if self.prenormalized:
            self.scale = False
        if store.constants is not None and len(cfg.constants) > 0:
            self.constants = select_constants(store, cfg.constants)
        else:
            self.constants = None

        # Verify the store's sampling interval is uniform (windowing assumes it).
        dt = np.diff(np.asarray(store.times))
        if len(dt) and not np.allclose(dt, dt[0], rtol=1e-6):
            raise ValueError("store times are not uniformly spaced")
        self.dt_days = float(dt[0]) * self.interval if len(dt) else 0.0

    # -- size --------------------------------------------------------------
    @property
    def n_samples(self) -> int:
        return len(self._starts)

    def __len__(self) -> int:
        n_batches, rem = divmod(self.n_samples, self.batch_size)
        return n_batches if (self.drop_remainder or rem == 0) else n_batches + 1

    # -- batch assembly ----------------------------------------------------
    def _window_indices(self, starts: np.ndarray):
        cfg = self.cfg
        n_out = (self.sequence or 1) * cfg.output_time_steps
        offs_in = np.arange(cfg.input_time_steps) * self.interval
        offs_out = (cfg.input_time_steps + np.arange(n_out)) * self.interval
        return starts[:, None] + offs_in[None, :], starts[:, None] + offs_out[None, :]

    def _gather(self, idx2d: np.ndarray) -> np.ndarray:
        """Fetch ``fields[idx]`` for a (B, T) index array -> (B, T, 6, n, n, C)."""
        fields = self.store.fields
        flat = idx2d.reshape(-1)
        if isinstance(fields, np.ndarray):
            out = fields[flat]
        else:  # an array-like store: fancy indexing, sorted unique
            uniq, inv = np.unique(flat, return_inverse=True)
            out = np.asarray(fields[uniq.tolist()])[inv]
        # every branch above produced a FRESH array (fancy indexing copies),
        # so copy=False avoids a further 14 MB pass for f32 stores
        return out.reshape(idx2d.shape + fields.shape[1:]).astype(
            np.float32, copy=False
        )

    def _normalize(self, x: np.ndarray) -> np.ndarray:
        if not self.scale:
            return x
        # in place: every caller passes a freshly materialized array, and
        # the two temporaries of `(x - mean) / std` cost ~28 MB of
        # allocation+copy per flagship batch on the hot path
        x -= self._mean
        x /= self._std
        return x

    def _impute_fill(self) -> np.ndarray:
        """(6, n, n, C) per-cell fill values for ``impute='cell_mean'``.

        The per-cell time-mean over valid samples (the fitted imputer),
        normalized like the fields; cells with no valid sample fall back to
        0 (the channel mean post-normalization).  Computed once, streamed in
        chunks so a large array-like store never loads fully.
        """
        if self._impute_fill_cache is None:
            fields = self.store.fields
            tot = np.zeros(fields.shape[1:], np.float64)
            cnt = np.zeros(fields.shape[1:], np.int64)
            for lo in range(0, fields.shape[0], 64):
                blk = np.asarray(fields[lo : lo + 64], dtype=np.float64)
                m = np.isfinite(blk)
                tot += np.where(m, blk, 0.0).sum(axis=0)
                cnt += m.sum(axis=0)
            with np.errstate(invalid="ignore", divide="ignore"):
                cell_mean = tot / np.maximum(cnt, 1)
                chan_mean = tot.sum(axis=(0, 1, 2)) / np.maximum(
                    cnt.sum(axis=(0, 1, 2)), 1
                )
            # never-valid cells fall back to the CHANNEL-wide mean in raw
            # units (with scaling on, that normalizes near zero anyway; a
            # raw literal 0.0 would be wildly out of distribution for e.g.
            # geopotential when scale=False)
            cell_mean = np.where(cnt > 0, cell_mean, chan_mean)
            fill = self._normalize(cell_mean)
            self._impute_fill_cache = np.nan_to_num(
                fill.astype(np.float32), copy=False
            )
        return self._impute_fill_cache

    def _impute_window(self, win: np.ndarray) -> np.ndarray:
        """Fill NaNs in a normalized (B, T, 6, n, n, C) window."""
        if self.impute == "cell_mean":
            return np.where(np.isnan(win), self._impute_fill(), win)
        return np.nan_to_num(win, copy=False)

    def make_batch(self, starts: np.ndarray):
        """Assemble one (inputs, targets) pair for the given window starts."""
        cfg = self.cfg
        idx_in, idx_out = self._window_indices(starts)
        x_win = self._normalize(self._gather(idx_in))  # (B, Tin, 6, n, n, C)
        y_win = self._normalize(self._gather(idx_out))  # (B, Tout', 6, n, n, C)
        if self.impute:
            x_win = self._impute_window(x_win)
            y_win = self._impute_window(y_win)
        b, t_in = x_win.shape[:2]
        if self.sequence is not None:
            # sequence mode: raw window + stacked target windows + t0 clock
            k, t_out = self.sequence, cfg.output_time_steps
            targets = np.stack(
                [_fold(y_win[:, s * t_out : (s + 1) * t_out]) for s in range(k)],
                axis=1,
            )
            # reduce mod the insolation period in float64 BEFORE the f32
            # cast (geometry/insolation.py): raw present-day epoch days
            # would quantize the training forcing clock to ~84 s
            t0 = np.asarray(self.store.times, np.float64)[
                starts + (t_in - 1) * self.interval
            ]
            t0 = np.mod(t0, INSOLATION_PERIOD_DAYS).astype(np.float32)
            return x_win, targets, t0
        parts = [_fold(x_win)]
        if cfg.add_insolation:
            times = np.asarray(self.store.times)[idx_in]  # (B, Tin)
            ins = insolation_np(
                times[..., None, None, None], self.lat, self.lon
            ).astype(np.float32)
            ins = (ins - self.insol_mean) / self.insol_std
            parts.append(_fold(ins[..., None]))
        if self.constants is not None:
            parts.append(
                np.broadcast_to(
                    self.constants[None], (b,) + self.constants.shape
                ).astype(np.float32)
            )
        inputs = np.concatenate(parts, axis=-1)
        targets = _fold(y_win)
        if not self.channels_last:
            inputs = np.moveaxis(inputs, -1, 1)
            targets = np.moveaxis(targets, -1, 1)
        return inputs, targets

    def _epoch_slices(self):
        order = self._starts.copy()
        if self.shuffle:
            self._rng.shuffle(order)
        bs = self.batch_size
        stop = (
            self.n_samples - self.n_samples % bs
            if self.drop_remainder
            else self.n_samples
        )
        return [order[lo : lo + bs] for lo in range(0, stop, bs)]

    def __iter__(self):
        if self.workers > 1:
            return self.iter_batches(self.workers)
        return (self.make_batch(s) for s in self._epoch_slices())

    def iter_batches(self, workers: int):
        """Epoch iterator assembling up to ``workers`` batches concurrently.

        Batch assembly (gathers, normalization, insolation, channel fold:
        host numpy) can dominate the input pipeline of a fast device step;
        numpy releases the GIL for the big ufuncs, so a small thread pool
        overlaps it.  Delivery order is
        IDENTICAL to the serial iterator (futures resolved in submission
        order), so shuffling/resume determinism is unchanged.
        """
        from concurrent.futures import ThreadPoolExecutor

        slices = self._epoch_slices()
        if self.impute == "cell_mean":
            self._impute_fill()  # prime the cache outside the pool

        def gen():
            # no `with`: an abandoned generator is finalized during GC /
            # interpreter teardown, where the context manager's blocking
            # join can die mid-shutdown — cancel and return instead
            ex = ThreadPoolExecutor(int(workers))
            try:
                inflight = deque()
                it = iter(slices)
                for s in itertools.islice(it, int(workers) + 2):
                    inflight.append(ex.submit(self.make_batch, s))
                while inflight:
                    f = inflight.popleft()
                    for s in it:
                        inflight.append(ex.submit(self.make_batch, s))
                        break
                    yield f.result()
            finally:
                try:
                    ex.shutdown(wait=False, cancel_futures=True)
                except Exception:  # noqa: BLE001 — interpreter teardown
                    pass

        return gen()

    # Valid-time helper for verification alignment.
    def target_times(self) -> np.ndarray:
        """(n_samples, T_out) valid times (days) of each sample's targets."""
        _, idx_out = self._window_indices(self._starts)
        return np.asarray(self.store.times)[idx_out]


def _fold(x: np.ndarray) -> np.ndarray:
    """``(B, T, 6, n, n, C) -> (B, 6, n, n, T*C)`` on the host, time-major
    outer (the layout of :func:`~dlwp_cs_tpu_torch.data.channels.fold_time`)."""
    t = x.shape[1]
    x = np.moveaxis(x, 1, -2)
    return np.ascontiguousarray(x.reshape(x.shape[:-2] + (t * x.shape[-1],)))
