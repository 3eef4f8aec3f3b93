"""Driver for the first-party C++ conservative remap weight generator.

The counterpart of ``dlwp_cs_tpu.remap.native``: build the generator
``tools/csremap/csremap.cpp``, run it per (direction, grids) and load the
sparse map it writes.  The generator computes exact spherical overlap
areas by default (``method="exact"``; rows sum to 1, global integrals are
conserved to rounding); ``method="sampled"`` is its first-order k x k
sub-cell fallback.  Application never goes through the binary: the weights
feed :func:`dlwp_cs_tpu_torch.remap.apply.apply_remap` on the device.

The binary is compiled at first use with ``$CXX`` (default ``g++``) and the
flags of the tool's Makefile into ``dlwp_cs_tpu_torch/_build/``, keyed by a
hash of the source, the compiler and the flags, as the CUDA kernels are
(``ops/cuda_build.py``); ``make`` is not needed, and nothing is written
beside the source.
"""

from __future__ import annotations

import hashlib
import os
import struct
import subprocess
import threading
from pathlib import Path

import numpy as np

from dlwp_cs_tpu_torch.remap.weights import RemapWeights

__all__ = ["build_csremap", "run_csremap", "load_csremap", "conservative_weights"]

_SOURCE = Path(__file__).resolve().parents[2] / "tools" / "csremap" / "csremap.cpp"
_BUILD_ROOT = Path(__file__).resolve().parents[1] / "_build"
# tools/csremap/Makefile's CXXFLAGS
_CXX_FLAGS = ("-O3", "-std=c++17", "-Wall", "-Wextra", "-pthread")
_BUILD_LOCK = threading.Lock()


def build_csremap(*, force: bool = False) -> Path:
    """Compile the generator (once per source, compiler and flags); returns
    the binary's path under ``_build/``."""
    cxx = os.environ.get("CXX", "g++")
    tag = hashlib.sha256(
        _SOURCE.read_bytes() + " ".join((cxx,) + _CXX_FLAGS).encode()
    ).hexdigest()[:16]
    binary = _BUILD_ROOT / f"csremap-{tag}" / "csremap"
    with _BUILD_LOCK:
        if binary.exists() and not force:
            return binary
        binary.parent.mkdir(parents=True, exist_ok=True)
        tmp = binary.with_name(f".csremap.tmp{os.getpid()}")
        proc = subprocess.run(
            [cxx, *_CXX_FLAGS, "-o", str(tmp), str(_SOURCE)],
            capture_output=True, text=True,
        )
        if proc.returncode != 0:
            tmp.unlink(missing_ok=True)
            raise RuntimeError(
                f"{cxx} failed on {_SOURCE.name} ({proc.returncode}):\n"
                f"{proc.stdout}{proc.stderr}"
            )
        os.replace(tmp, binary)
    return binary


def run_csremap(
    mode: str,
    *,
    n_lat: int,
    n_lon: int,
    n_cs: int,
    out_path,
    samples: int = 8,
    lat_centered: bool = True,
    method: str = "exact",
) -> Path:
    """Run the generator; returns the written weight file path."""
    if mode not in ("ll2cs", "cs2ll"):
        raise ValueError(f"mode must be ll2cs|cs2ll, got {mode!r}")
    binary = build_csremap()
    out_path = Path(out_path)
    out_path.parent.mkdir(parents=True, exist_ok=True)
    subprocess.run(
        [
            str(binary),
            "--mode", mode,
            "--nlat", str(n_lat),
            "--nlon", str(n_lon),
            "--ncs", str(n_cs),
            "--samples", str(samples),
            "--method", method,
            "--lat-centered", "1" if lat_centered else "0",
            "--out", str(out_path),
        ],
        check=True,
        capture_output=True,
    )
    return out_path


def load_csremap(path, dtype=np.float32) -> RemapWeights:
    """Load a CSRM (version 1) binary weight file into :class:`RemapWeights`.

    ``dtype``: value precision; the file stores float64 (pass ``np.float64``
    to keep full precision, e.g. for conservation checks).
    """
    raw = Path(path).read_bytes()
    if raw[:4] != b"CSRM":
        raise ValueError(f"{path} is not a CSRM weight file")
    version, n_t, n_s = struct.unpack_from("<III", raw, 4)
    if version != 1:
        raise ValueError(f"unsupported CSRM version {version}")
    (nnz,) = struct.unpack_from("<Q", raw, 16)
    off = 24
    rows = np.frombuffer(raw, dtype="<i4", count=nnz, offset=off)
    off += 4 * nnz
    cols = np.frombuffer(raw, dtype="<i4", count=nnz, offset=off)
    off += 4 * nnz
    vals = np.frombuffer(raw, dtype="<f8", count=nnz, offset=off)
    return RemapWeights(
        rows=rows.copy(),
        cols=cols.copy(),
        vals=vals.astype(dtype),
        shape=(int(n_t), int(n_s)),
    )


def conservative_weights(
    mode: str,
    *,
    n_lat: int,
    n_lon: int,
    n_cs: int,
    samples: int = 8,
    lat_centered: bool = True,
    method: str = "exact",
    cache_dir=None,
    dtype=np.float32,
) -> RemapWeights:
    """Generate (or reuse cached) conservative weights via the C++ tool."""
    import tempfile

    cache_dir = Path(cache_dir) if cache_dir else Path(tempfile.gettempdir())
    tag = method if method != "sampled" else f"s{samples}"
    name = f"csremap_{mode}_{n_lat}x{n_lon}_c{n_cs}_{tag}_{int(lat_centered)}.bin"
    path = cache_dir / name

    def generate():
        # published by a rename: the tool writes its output path directly,
        # so a crash mid-generation (or two processes at once) would
        # otherwise leave a truncated file in the cache
        tmp = path.with_name(f".{name}.tmp{os.getpid()}")
        try:
            run_csremap(
                mode,
                n_lat=n_lat,
                n_lon=n_lon,
                n_cs=n_cs,
                out_path=tmp,
                samples=samples,
                lat_centered=lat_centered,
                method=method,
            )
            os.replace(tmp, path)
        finally:
            tmp.unlink(missing_ok=True)

    if not path.exists():
        generate()
    try:
        return load_csremap(path, dtype=dtype)
    except (ValueError, struct.error, EOFError):
        # a corrupt or truncated cache entry (a cut inside the fixed-size
        # header raises struct.error): regenerate once
        path.unlink(missing_ok=True)
        generate()
        return load_csremap(path, dtype=dtype)
