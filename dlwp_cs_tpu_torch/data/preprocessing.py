"""Preprocessor: raw lat-lon reanalysis -> cubed-sphere predictor store.

The counterpart of ``dlwp_cs_tpu.data.preprocessing``: select variables,
remap them to the cubed sphere, compute per-variable normalization stats
and write the canonical predictor store.  The chain runs in-process and
streams each variable in time batches to bound memory; the remap of each
batch runs on the device (the GPU unless the caller names another), the
derived variables, the stats and the constants' standardization on the
host, as in the reference.
"""

from __future__ import annotations

from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.data.store import MemoryStore, import_h5py, write_store
from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
from dlwp_cs_tpu_torch.remap.apply import apply_remap
from dlwp_cs_tpu_torch.remap.weights import RemapWeights, ll_to_cs_weights

__all__ = ["Preprocessor"]


class Preprocessor:
    """Builds cubed-sphere predictor stores from lat-lon sources.

    Args:
      sources: mapping ``variable name -> (T, H, W)`` array-like (numpy or
        h5py datasets; ERA5 files opened via ``data.era5`` produce these).
      lats, lons: 1-D grid coordinates in **radians** (ascending lats).
      times: ``(T,)`` float64 days since 2000-01-01 00 UTC.
      derived: optional mapping ``name -> (deps, fn)`` of variables computed
        from sources, e.g. the papers' 300-700 hPa thickness
        ``{"tau300-700": (("z300", "z700"), lambda z3, z7: z3 - z7)}``.
        ``fn`` receives ``(B, H, W)`` float32 blocks of each dep and returns
        the same shape; it is evaluated on the host per streamed time
        batch, so a derived series never materializes in full.
    """

    def __init__(self, sources: dict, lats, lons, times, derived=None):
        self.sources = dict(sources)
        self.lats = np.asarray(lats, np.float64)
        self.lons = np.asarray(lons, np.float64)
        self.times = np.asarray(times, np.float64)
        if not self.sources:
            raise ValueError("no source variables given")
        t = len(self.times)
        for k, v in self.sources.items():
            if v.shape != (t, len(self.lats), len(self.lons)):
                raise ValueError(
                    f"source {k!r} has shape {v.shape}, expected "
                    f"{(t, len(self.lats), len(self.lons))}"
                )
        self.derived = {}
        for name, (deps, fn) in (derived or {}).items():
            if name in self.sources:
                raise ValueError(f"derived {name!r} shadows a source")
            missing = [d for d in deps if d not in self.sources]
            if missing:
                raise ValueError(
                    f"derived {name!r} depends on unknown sources {missing}"
                )
            self.derived[name] = (tuple(deps), fn)

    def data_to_series(
        self,
        n: int,
        *,
        variables: list[str] | None = None,
        weights: RemapWeights | None = None,
        constant_sources: dict | None = None,
        path: str | Path | None = None,
        batch_size: int = 256,
        scaler: str = "standard",
        device=None,
    ):
        """Remap selected variables to a C{n} store.

        ``weights``: precomputed LL->CS weights (else bilinear generated).
        ``constant_sources``: mapping name -> (H, W) static lat-lon fields;
        remapped and standardized into the store's constants.
        ``scaler``: 'standard' | 'minmax' | 'robust' | 'maxabs'
        normalization stats (the reference's sklearn ``scaler_type``
        option).
        ``device``: where the remap runs (``None``: the GPU, which must
        exist).  Each variable streams to the device ``batch_size`` time
        steps at a time, as float32, and is remapped there
        (:func:`~dlwp_cs_tpu_torch.remap.apply.apply_remap`).
        Returns the MemoryStore (and writes HDF5 if ``path`` given).
        """
        dev = resolve_device(device)
        if path is not None:
            import_h5py()  # before the remap, not after it
        cs = CubedSphere(n)
        if variables is None:
            variables = list(self.sources) + list(self.derived)
        else:
            variables = list(variables)
        missing = [
            v for v in variables
            if v not in self.sources and v not in self.derived
        ]
        if missing:
            raise ValueError(f"unknown variables {missing}")
        if weights is None:
            weights = ll_to_cs_weights(self.lats, self.lons, cs)
        t_total = len(self.times)
        fields = np.empty((t_total, 6, n, n, len(variables)), np.float32)
        for ci, name in enumerate(variables):
            for lo in range(0, t_total, batch_size):
                hi = min(lo + batch_size, t_total)
                if name in self.derived:
                    deps, fn = self.derived[name]
                    block = np.asarray(
                        fn(*[
                            np.asarray(self.sources[d][lo:hi], np.float32)
                            for d in deps
                        ]),
                        np.float32,
                    )
                    if block.shape != (hi - lo, len(self.lats),
                                       len(self.lons)):
                        raise ValueError(
                            f"derived {name!r} returned shape {block.shape}"
                        )
                    block = block.reshape(hi - lo, -1)
                else:
                    block = np.asarray(
                        self.sources[name][lo:hi], np.float32
                    ).reshape(hi - lo, -1)
                out = apply_remap(weights, torch.from_numpy(block).to(dev))
                fields[lo:hi, ..., ci] = out.cpu().numpy().reshape(hi - lo, 6, n, n)
        constants = None
        constant_names = ()
        if constant_sources:
            constant_names = tuple(constant_sources)
            ks = []
            for cname, cfield in constant_sources.items():
                flat = torch.from_numpy(np.asarray(cfield, np.float32).reshape(1, -1))
                cube = apply_remap(weights, flat.to(dev)).cpu().numpy().reshape(6, n, n)
                std = cube.std()
                cube = (cube - cube.mean()) / (std if std > 1e-12 else 1.0)
                ks.append(cube)
            constants = np.stack(ks, axis=-1)
        store = MemoryStore.from_raw(
            fields,
            self.times,
            variables,
            constants=constants,
            constant_names=constant_names,
            attrs={"grid_n": n, "source_grid": [len(self.lats), len(self.lons)]},
            scaler=scaler,
        )
        if path is not None:
            write_store(path, store)
        return store
