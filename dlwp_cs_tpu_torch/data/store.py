"""Predictor stores: the training data format.

The counterpart of ``dlwp_cs_tpu.data.store``: the cubed-sphere layout
``(time, 6, n, n, C_var)`` channels-last, times as float64 days since
2000-01-01, normalization stats beside the fields.  :class:`MemoryStore`
holds it in RAM; :func:`write_store` writes it to HDF5, chunked one time
sample per chunk, and :class:`H5Store` (:func:`open_store`) reads it back
lazily, in the reference's file layout, so either package reads the
other's files.  HDF5 needs ``h5py``, imported when a file is touched; the
GPU machine has none, and there these raise an ``ImportError`` that says
so (:func:`import_h5py`).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass, field
from pathlib import Path

import numpy as np

__all__ = [
    "MemoryStore",
    "H5Store",
    "normalize_store",
    "open_store",
    "select_constants",
    "write_store",
]


def import_h5py(what: str = "HDF5 stores"):
    """``h5py``, or an ``ImportError`` naming it and what needs it."""
    try:
        import h5py
    except ImportError as e:
        raise ImportError(
            f"{what} need h5py, which is not installed here; without it, "
            "build and train from a MemoryStore (or the tensorstore cache)"
        ) from e
    return h5py


@dataclass
class MemoryStore:
    """In-memory predictor store.

    Attributes:
      fields: ``(T, 6, n, n, C)`` float32 raw (unnormalized) fields.
      times: ``(T,)`` float64 days since 2000-01-01 00 UTC.
      variables: channel names, length C.
      mean / std: ``(C,)`` float64 normalization stats.
      constants: optional ``(6, n, n, K)`` float32 *normalized* static fields.
      constant_names: length K.
    """

    fields: np.ndarray
    times: np.ndarray
    variables: tuple[str, ...]
    mean: np.ndarray
    std: np.ndarray
    constants: np.ndarray | None = None
    constant_names: tuple[str, ...] = ()
    attrs: dict = field(default_factory=dict)

    def __post_init__(self):
        t, f6, n, n2, c = self.fields.shape
        if f6 != 6 or n != n2:
            raise ValueError(f"fields must be (T, 6, n, n, C), got {self.fields.shape}")
        if len(self.times) != t:
            raise ValueError("times length mismatch")
        if len(self.variables) != c or len(self.mean) != c or len(self.std) != c:
            raise ValueError("variables/mean/std length mismatch with channels")
        if self.constants is not None:
            if self.constants.ndim != 4 or self.constants.shape[:3] != (6, n, n):
                raise ValueError(
                    f"constants must be (6, {n}, {n}, K), got "
                    f"{self.constants.shape}"
                )
            if len(self.constant_names) != self.constants.shape[3]:
                raise ValueError(
                    f"{len(self.constant_names)} constant_names for "
                    f"{self.constants.shape[3]} constant channels"
                )

    @property
    def grid_n(self) -> int:
        return self.fields.shape[2]

    @classmethod
    def from_raw(cls, fields, times, variables, constants=None, constant_names=(),
                 attrs=None, scaler: str = "standard"):
        """Compute normalization stats from the data itself (build time).

        ``scaler``: ``'standard'`` (per-channel mean/std — the reference's
        default), ``'minmax'`` (maps the observed range to [0, 1] — the
        reference's ``scaler_type='MinMaxScaler'`` option, stored as
        ``mean=min, std=max-min``), ``'robust'`` (median / IQR — the
        reference's ``scaler_type='RobustScaler'`` option, outlier-immune),
        or ``'maxabs'`` (``x / max|x|`` — sklearn ``MaxAbsScaler`` parity),
        all stored so the ``(x - mean) / std`` pipeline is unchanged.  The
        choice is recorded in ``attrs['scaler']``.

        NaN-aware: variables with masked regions (e.g. sst over land) get
        stats over the valid cells only, so normalization never NaNs the
        whole channel (imputation handles the gaps downstream).
        """
        import warnings

        fields = np.asarray(fields, dtype=np.float32)
        with np.errstate(invalid="ignore"), warnings.catch_warnings():
            warnings.simplefilter("ignore", RuntimeWarning)  # all-NaN slices
            if scaler == "standard":
                mean = np.nanmean(fields, axis=(0, 1, 2, 3), dtype=np.float64)
                std = np.nanstd(fields, axis=(0, 1, 2, 3), dtype=np.float64)
            elif scaler == "minmax":
                lo = np.nanmin(fields, axis=(0, 1, 2, 3))
                hi = np.nanmax(fields, axis=(0, 1, 2, 3))
                mean = lo.astype(np.float64)
                std = (hi - lo).astype(np.float64)
            elif scaler == "robust":
                # feed the f32 array directly — an .astype(np.float64) here
                # transiently tripled host memory on multi-GB stores for no
                # statistical gain (percentiles of f32 data are f32-exact)
                q = np.nanpercentile(
                    fields, [25.0, 50.0, 75.0], axis=(0, 1, 2, 3)
                )
                mean = q[1].astype(np.float64)
                std = (q[2] - q[0]).astype(np.float64)
            elif scaler == "maxabs":
                # sklearn MaxAbsScaler parity: x / max|x|, center untouched
                mean = np.zeros(fields.shape[-1], np.float64)
                std = np.nanmax(
                    np.abs(fields), axis=(0, 1, 2, 3)
                ).astype(np.float64)
            else:
                raise ValueError(
                    "scaler must be 'standard', 'minmax', 'robust' or "
                    f"'maxabs', got {scaler!r}"
                )
        # all-NaN / constant channels: identity normalization
        mean = np.where(np.isfinite(mean), mean, 0.0)
        std = np.where(~np.isfinite(std) | (std < 1e-12), 1.0, std)
        attrs = dict(attrs or {})
        attrs.setdefault("scaler", scaler)
        return cls(
            fields=fields,
            times=np.asarray(times, dtype=np.float64),
            variables=tuple(variables),
            mean=mean,
            std=std,
            constants=None if constants is None else np.asarray(constants, np.float32),
            constant_names=tuple(constant_names),
            attrs=attrs,
        )


def normalize_store(store: MemoryStore) -> MemoryStore:
    """Pre-normalized copy of a store (``attrs['normalized'] = True``).

    A training-cache transform: with the fields stored as ``(x - mean) /
    std`` f32, :class:`~dlwp_cs_tpu_torch.data.series.SeriesDataset` serves
    them as they are (no per-batch normalization pass) and keeps
    ``mean``/``std`` for denormalization.
    """
    if store.attrs.get("normalized"):
        return store
    fields = (
        (np.asarray(store.fields, np.float32) - store.mean.astype(np.float32))
        / store.std.astype(np.float32)
    )
    return dataclasses.replace(
        store, fields=fields, attrs={**store.attrs, "normalized": True}
    )


def write_store(path, store: MemoryStore) -> Path:
    """Write a MemoryStore to HDF5."""
    h5py = import_h5py()
    path = Path(path)
    path.parent.mkdir(parents=True, exist_ok=True)
    with h5py.File(path, "w") as f:
        f.create_dataset(
            "fields",
            data=store.fields,
            chunks=(1,) + store.fields.shape[1:],
            compression=None,
        )
        f.create_dataset("times", data=store.times)
        f.create_dataset("mean", data=store.mean)
        f.create_dataset("std", data=store.std)
        f.attrs["variables"] = json.dumps(list(store.variables))
        f.attrs["attrs"] = json.dumps(store.attrs)
        if store.constants is not None:
            f.create_dataset("constants", data=store.constants)
            f.attrs["constant_names"] = json.dumps(list(store.constant_names))
    return path


class H5Store:
    """Lazy HDF5-backed store with the MemoryStore interface.

    ``fields`` is the live h5py dataset (sliceable without loading);
    everything small is read eagerly.
    """

    def __init__(self, path):
        h5py = import_h5py()
        self.path = Path(path)
        self._f = h5py.File(self.path, "r")
        self.fields = self._f["fields"]
        self.times = np.asarray(self._f["times"])
        self.mean = np.asarray(self._f["mean"])
        self.std = np.asarray(self._f["std"])
        self.variables = tuple(json.loads(self._f.attrs["variables"]))
        self.attrs = json.loads(self._f.attrs.get("attrs", "{}"))
        if "constants" in self._f:
            self.constants = np.asarray(self._f["constants"])
            self.constant_names = tuple(json.loads(self._f.attrs["constant_names"]))
        else:
            self.constants = None
            self.constant_names = ()

    @property
    def grid_n(self) -> int:
        return self.fields.shape[2]

    def load(self) -> MemoryStore:
        """Read fully into RAM."""
        return MemoryStore(
            fields=np.asarray(self.fields),
            times=self.times,
            variables=self.variables,
            mean=self.mean,
            std=self.std,
            constants=self.constants,
            constant_names=self.constant_names,
            attrs=self.attrs,
        )

    def close(self):
        self._f.close()


def open_store(path) -> H5Store:
    return H5Store(path)


def select_constants(store, names):
    """Pull constant channels ``names`` (in order) from a store as a
    ``(6, n, n, len(names))`` array, with a clear error for missing ones.
    Shared by the series dataset and the serving/export layers."""
    names = list(names)
    if not names:
        return None
    if store.constants is None:
        raise ValueError(f"store has no constants; need {names}")
    have = list(store.constant_names)
    missing = [c for c in names if c not in have]
    if missing:
        raise ValueError(f"constants {missing} not in store {have}")
    idx = [have.index(c) for c in names]
    return np.asarray(store.constants)[..., idx]
