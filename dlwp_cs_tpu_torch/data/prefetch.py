"""Host->device prefetching: keep the card fed.

The counterpart of ``dlwp_cs_tpu.data.prefetch``.  A background thread
pulls batches (nested tuples, lists or dicts of numpy arrays or tensors)
from the iterable and copies them to the device ``depth`` batches ahead:

* on a CUDA device, through pinned host buffers with ``non_blocking``
  copies on a side stream; each batch carries an event that the consumer's
  stream waits on, so compute never reads a batch before its copy ends and
  the copy of batch k+1 overlaps the compute of batch k;
* on the CPU, the same thread without pinning.

With ``sharding=mesh`` the thread cuts this rank's block out of every
tensor before the copy, as ``parallel.shard_batch`` does (the batch axis
over ``data``; with ``spatial=True`` also the face rows and columns of
every ``(B, 6, n, n, C)`` tensor), so only the block reaches the device.
The cut reads the rank's mesh coordinates and issues no collective: the
thread must not, while the consumer's steps issue theirs.

Errors in the iterable reach the consumer; :meth:`PrefetchIterator.close`
releases the thread of an abandoned iterator and cannot hang.
"""

from __future__ import annotations

import queue
import threading

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device

__all__ = ["prefetch_to_device", "PrefetchIterator"]


def _tree_map(fn, item):
    if isinstance(item, (tuple, list)):
        return type(item)(_tree_map(fn, v) for v in item)
    if isinstance(item, dict):
        return {k: _tree_map(fn, v) for k, v in item.items()}
    return fn(item)


def _tensors(item):
    out = []
    _tree_map(lambda t: out.append(t) if isinstance(t, torch.Tensor) else None, item)
    return out


class PrefetchIterator:
    """Iterator wrapper with a copy-ahead background thread."""

    _SENTINEL = object()

    def __init__(self, iterable, *, depth: int = 2, device=None, sharding=None,
                 spatial: bool = False):
        self.device = resolve_device(device)
        self.sharding, self.spatial = sharding, spatial
        self._cuda = self.device.type == "cuda"
        self._stream = torch.cuda.Stream(self.device) if self._cuda else None
        self._queue: queue.Queue = queue.Queue(maxsize=depth)
        self._err: BaseException | None = None
        self._closed = False
        self._thread = threading.Thread(
            target=self._worker, args=(iterable,), daemon=True
        )
        self._thread.start()

    def _copy(self, a):
        t = torch.as_tensor(np.ascontiguousarray(a)) if isinstance(a, np.ndarray) else a
        if isinstance(t, torch.Tensor) and self.sharding is not None:
            t = self._block(t)
        if not isinstance(t, torch.Tensor) or t.device == self.device:
            return t
        if self._cuda and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

    def _block(self, t):
        from dlwp_cs_tpu_torch.parallel.mesh import local_block

        spatial = self.spatial and t.ndim == 5 and t.shape[1] == 6
        return local_block(t, self.sharding, spatial=spatial)

    def _put(self, item):
        """``(batch on the device, event its copy records or None)``."""
        if not self._cuda:
            return _tree_map(self._copy, item), None
        with torch.cuda.stream(self._stream):
            out = _tree_map(self._copy, item)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self, iterable):
        try:
            for item in iterable:
                if self._closed:
                    return
                self._queue.put(self._put(item))
        except BaseException as e:  # propagate into consumer
            self._err = e
        finally:
            # The sentinel must reach a live consumer (blocking put), but a
            # closing consumer may have refilled the queue after draining
            # (depth=1), and a plain blocking put would then hang this
            # thread: poll with a timeout and give up once closed.
            while True:
                try:
                    self._queue.put(self._SENTINEL, timeout=0.1)
                    return
                except queue.Full:
                    if self._closed:
                        return

    def __iter__(self):
        return self

    def __next__(self):
        item = self._queue.get()
        if item is self._SENTINEL:
            # re-arm: an exhausted iterator raises StopIteration on every
            # later call (Trainer.fit calls next() again after a short chunk)
            self._queue.put(self._SENTINEL)
            if self._err is not None:
                raise self._err
            raise StopIteration
        out, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            # the batch was allocated on the copy stream and is used here
            for t in _tensors(out):
                t.record_stream(stream)
        return out

    def close(self) -> None:
        """Release the worker of an abandoned iterator (a worker blocked on
        a full queue would otherwise pin ``depth + 1`` device batches)."""
        self._closed = True
        # drain until the worker has exited: one drain pass can race with
        # the worker's just-unblocked put refilling the queue (depth=1)
        while self._thread.is_alive():
            try:
                self._queue.get_nowait()
            except queue.Empty:
                self._thread.join(timeout=0.05)
        # the worker is gone, but its last put may have landed after the
        # last get above (and its sentinel then given up on the full
        # queue): empty the queue, so that every next() after close finds
        # the sentinel, never a stale batch, and never blocks
        while True:
            try:
                self._queue.get_nowait()
            except queue.Empty:
                break
        self._queue.put_nowait(self._SENTINEL)

    def __del__(self):  # noqa: D105 - best-effort release
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(iterable, *, depth: int = 2, device=None, sharding=None,
                       spatial: bool = False):
    """Wrap an iterable of batches; yields device copies ``depth`` ahead.

    ``device``: where the batches go (``None``: the GPU, which must exist).
    ``sharding``: the reference's multi-device input feed; here a mesh
    (:func:`~dlwp_cs_tpu_torch.parallel.create_mesh`), whose rank gets its
    block of every tensor (the batch over ``data``; with ``spatial``, face
    rows over ``spatial`` and columns over ``spatial_x`` of every ``(B, 6,
    n, n, C)`` tensor), as ``parallel.shard_batch`` cuts them.  Without
    ``spatial`` these are what ``Trainer(mesh=...)`` and the data-parallel
    steps take; the spatial steps take the global batch.
    """
    return PrefetchIterator(iterable, depth=depth, device=device, sharding=sharding,
                            spatial=spatial)
