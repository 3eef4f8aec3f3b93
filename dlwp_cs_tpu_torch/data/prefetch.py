"""Host->device prefetching: keep the card fed.

The counterpart of ``dlwp_cs_tpu.data.prefetch``.  A background thread
pulls batches (nested tuples, lists or dicts of numpy arrays or tensors)
from the iterable and copies them to the device ``depth`` batches ahead:

* on a CUDA device, through pinned host buffers with ``non_blocking``
  copies on a side stream; each batch carries an event that the consumer's
  stream waits on, so compute never reads a batch before its copy ends and
  the copy of batch k+1 overlaps the compute of batch k;
* on the CPU, the same thread without pinning.

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

    def __init__(self, iterable, *, depth: int = 2, device=None):
        self.device = resolve_device(device)
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
        if not isinstance(t, torch.Tensor) or t.device == self.device:
            return t
        if self._cuda and t.device.type == "cpu":
            return t.pin_memory().to(self.device, non_blocking=True)
        return t.to(self.device)

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
        try:
            self._queue.put_nowait(self._SENTINEL)
        except queue.Full:
            pass

    def __del__(self):  # noqa: D105 - best-effort release
        try:
            self.close()
        except Exception:
            pass


def prefetch_to_device(iterable, *, depth: int = 2, device=None, sharding=None):
    """Wrap an iterable of batches; yields device copies ``depth`` ahead.

    ``device``: where the batches go (``None``: the GPU, which must exist).
    ``sharding`` (the reference's multi-device input feed) is not ported.
    """
    if sharding is not None:
        raise NotImplementedError(
            "sharded input feeding is not ported yet: ROADMAP.md queue 1, item 17"
        )
    return PrefetchIterator(iterable, depth=depth, device=device)
