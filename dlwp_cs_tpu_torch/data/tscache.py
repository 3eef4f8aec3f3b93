"""TensorStore (zarr-format) training cache.

A copy of ``dlwp_cs_tpu.data.tscache``: the canonical store schema as a
zarr-format directory written and read through tensorstore, chunked per
time sample and read concurrently, usable by
:class:`~dlwp_cs_tpu_torch.data.series.SeriesDataset` like the other
stores.  tensorstore is imported lazily: the GPU machine has none, and
there these functions raise an ``ImportError`` that says so.
"""

from __future__ import annotations

import json
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.data.store import MemoryStore

__all__ = ["write_ts_cache", "TSStore", "open_ts_cache"]


def _ts():
    try:
        import tensorstore as ts
    except ImportError as e:
        raise ImportError(
            "the tensorstore training cache needs the tensorstore package, "
            "which is not installed here; use an HDF5 or in-memory store"
        ) from e
    return ts


def _spec(path, *, shape=None, dtype="float32", chunks=None):
    spec = {
        "driver": "zarr",
        "kvstore": {"driver": "file", "path": str(path)},
    }
    if shape is not None:
        spec["metadata"] = {
            "shape": list(shape),
            "chunks": list(chunks or shape),
            "dtype": "<f4" if dtype == "float32" else dtype,
        }
        spec["create"] = True
        spec["delete_existing"] = True
    return spec


def write_ts_cache(path, store: MemoryStore) -> Path:
    """Write a MemoryStore as a zarr-format tensorstore cache directory."""
    ts = _ts()
    root = Path(path)
    root.mkdir(parents=True, exist_ok=True)
    fields = np.asarray(store.fields, np.float32)
    arr = ts.open(
        _spec(root / "fields", shape=fields.shape,
              chunks=(1,) + fields.shape[1:])
    ).result()
    arr[...] = fields
    if store.constants is not None:
        carr = ts.open(
            _spec(root / "constants", shape=store.constants.shape)
        ).result()
        carr[...] = np.asarray(store.constants, np.float32)
    meta = {
        "times": [float(t) for t in store.times],
        "variables": list(store.variables),
        "mean": [float(v) for v in store.mean],
        "std": [float(v) for v in store.std],
        "constant_names": list(store.constant_names),
        "attrs": store.attrs,
    }
    (root / "meta.json").write_text(json.dumps(meta))
    return root


class _TSFields:
    """Array-like adapter over a tensorstore array (int/slice/array index)."""

    def __init__(self, arr):
        self._arr = arr
        self.shape = tuple(arr.shape)

    def __getitem__(self, idx):
        if isinstance(idx, (list, np.ndarray)):
            idx = np.asarray(idx)
            # issue ALL reads before blocking: tensorstore is async-native,
            # so the chunk fetches overlap instead of paying one round-trip
            # latency per index
            futs = [self._arr[int(i)].read() for i in idx]
            return np.stack([np.asarray(f.result()) for f in futs])
        return np.asarray(self._arr[idx].read().result())


class TSStore:
    """Lazy tensorstore-backed store with the MemoryStore interface."""

    def __init__(self, path):
        ts = _ts()
        self.path = Path(path)
        meta = json.loads((self.path / "meta.json").read_text())
        self.fields = _TSFields(ts.open(_spec(self.path / "fields")).result())
        self.times = np.asarray(meta["times"], np.float64)
        self.variables = tuple(meta["variables"])
        self.mean = np.asarray(meta["mean"])
        self.std = np.asarray(meta["std"])
        self.constant_names = tuple(meta["constant_names"])
        self.attrs = meta.get("attrs", {})
        if self.constant_names:
            self.constants = np.asarray(
                ts.open(_spec(self.path / "constants")).result().read().result()
            )
        else:
            self.constants = None

    @property
    def grid_n(self) -> int:
        return self.fields.shape[2]

    def load(self) -> MemoryStore:
        return MemoryStore(
            fields=self.fields[:],
            times=self.times,
            variables=self.variables,
            mean=self.mean,
            std=self.std,
            constants=self.constants,
            constant_names=self.constant_names,
            attrs=self.attrs,
        )


def open_ts_cache(path) -> TSStore:
    return TSStore(path)
