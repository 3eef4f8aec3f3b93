"""Fused halo-pad + 3x3 cubed-sphere conv: the Hopper kernel, its plain
version and its wrapper.

The counterpart of ``dlwp_cs_tpu.ops.pallas_conv`` (forward only).  The
CUDA kernel ``csrc/cs_conv3x3.cu`` replaces the Pallas kernel ``_kernel``
in both of its launch shapes (whole face and row bands); its header says
what bounds it and how.

* :func:`cs_conv3x3_plain` computes the same function in plain torch: the
  padded face built with ``torch.cat``, 9 tap einsums in f32, the face's
  weight group, the bias, one cast.  CPU tensors take it; on the card it is
  only the comparison in ``chip_smoke.py``.
* :data:`cs_conv3x3` is the wrapper.  On a CPU tensor it returns the plain
  version; on a CUDA tensor it launches the kernel or raises, and counts
  the launch in ``cs_conv3x3.launches``.

The kernel is compiled with ``nvcc`` for ``sm_90a`` at its first CUDA use,
from the repository's source, into ``dlwp_cs_tpu_torch/_build/<hash>/``,
and bound with ``ctypes`` (a plain C entry point; no PyTorch headers).
"""

from __future__ import annotations

import ctypes
import hashlib
import math
import os
import shutil
import subprocess
import threading
import time
from pathlib import Path

import torch

__all__ = ["cs_conv3x3", "cs_conv3x3_plain", "tile_plan"]

_PKG = Path(__file__).resolve().parents[1]
_SOURCE = _PKG / "csrc" / "cs_conv3x3.cu"
_BUILD_ROOT = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

# Register tile of one thread and the block-size cap (csrc/cs_conv3x3.cu).
_PX, _CO, _MAX_THREADS = 4, 8, 256


def _padded_faces(x, ext):
    """``(B, 6, n+2, n+2, C)``: x framed by its ghost rows and columns."""
    n = x.shape[2]
    mid = torch.cat(
        [ext[:, :, 2, 1 : n + 1, None], x, ext[:, :, 3, 1 : n + 1, None]], dim=3
    )
    return torch.cat([ext[:, :, 0, None], mid, ext[:, :, 1, None]], dim=2)


def cs_conv3x3_plain(x, ext, k_eq, k_pole, b_eq, b_pole):
    """Plain-torch fused CS conv: ``(B, 6, n, n, Cin) -> (B, 6, n, n, Cout)``.

    ``ext`` is :func:`~dlwp_cs_tpu_torch.ops.halo.ext_strips` of ``x``.
    Kernels and biases are rounded to ``x``'s dtype, the taps summed in f32
    and the result cast once to ``x``'s dtype.
    """
    n = x.shape[2]
    dt = x.dtype
    p = _padded_faces(x, ext).float()
    parts = []
    for k, bias, faces in ((k_eq, b_eq, slice(0, 4)), (k_pole, b_pole, slice(4, 6))):
        kf = k.to(dt).float()
        acc = sum(
            torch.einsum("bfijc,cd->bfijd", p[:, faces, dy : dy + n, dx : dx + n], kf[dy, dx])
            for dy in range(3)
            for dx in range(3)
        )
        parts.append(acc + bias.to(dt).float())
    return torch.cat(parts, dim=1).to(dt)


def tile_plan(b: int, n: int, cout: int, sm_count: int):
    """``(h, cs)``: output rows and output channels per block.

    A block holds at most 256 threads of ``4 x 8`` (pixels x channels)
    register tiles.  ``cs`` is the widest power-of-two channel slice that
    lets one row fit a block; ``h`` the most rows that fit, lowered until the
    grid holds two blocks per SM where the batch is small (batch-1 serving).
    """
    ncg = -(-n // _PX)
    if ncg > _MAX_THREADS:
        raise ValueError(f"face size {n} is too large for the conv kernel")
    widest = 1 << ((_CO * (_MAX_THREADS // ncg)).bit_length() - 1)
    cs = min(1 << (max(cout, _CO) - 1).bit_length(), widest)
    per_row = ncg * (cs // _CO)
    nslices = -(-cout // cs)
    h = min(n, _MAX_THREADS // per_row)
    while h > 1 and math.ceil(n / h) * nslices * 6 * b < 2 * sm_count:
        h -= 1
    return h, cs


def _find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class _Conv3x3Kernel:
    """Wrapper of the CUDA kernel; ``launches`` counts kernel launches."""

    def __init__(self):
        self.launches = 0
        self.build_seconds = None
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()
        self._sm_count: dict[int, int] = {}

    def build(self):
        """Compile (once per source hash) and load the shared library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            t0 = time.perf_counter()
            src = _SOURCE.read_bytes()
            tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
            lib_path = _BUILD_ROOT / tag / "libcs_conv3x3.so"
            if not lib_path.exists():
                lib_path.parent.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(f".tmp{os.getpid()}.so")
                proc = subprocess.run(
                    [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(_SOURCE)],
                    capture_output=True, text=True,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed ({proc.returncode}):\n{self.build_log}"
                    )
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            vp, i32 = ctypes.c_void_p, ctypes.c_int
            lib.cs_conv3x3_launch.argtypes = [i32, i32] + [vp] * 7 + [i32] * 6 + [vp]
            lib.cs_conv3x3_launch.restype = i32
            lib.cs_conv3x3_error_string.argtypes = [i32]
            lib.cs_conv3x3_error_string.restype = ctypes.c_char_p
            self.build_seconds = time.perf_counter() - t0
            self._lib = lib
            return lib

    def __call__(self, x, ext, k_eq, k_pole, b_eq, b_pole):
        """Fused CS conv of ``x`` (B, 6, n, n, Cin) with ghost strips ``ext``
        (B, 6, 4, n+2, Cin), HWIO kernels (3, 3, Cin, Cout) and biases
        (Cout,), all of ``x``'s dtype; returns (B, 6, n, n, Cout)."""
        if x.device.type == "cpu":
            return cs_conv3x3_plain(x, ext, k_eq, k_pole, b_eq, b_pole)
        if x.device.type != "cuda":
            raise ValueError(f"cs_conv3x3 runs on cuda or cpu, not {x.device}")
        if x.dtype not in _DTYPES:
            raise ValueError(f"cs_conv3x3 takes float32 or bfloat16, not {x.dtype}")
        if x.ndim != 5 or x.shape[1] != 6 or x.shape[2] != x.shape[3]:
            raise ValueError(f"expected x (B, 6, n, n, C), got {tuple(x.shape)}")
        b, _, n, _, cin = x.shape
        cout = k_eq.shape[-1]
        shapes = {
            "ext": (ext, (b, 6, 4, n + 2, cin)),
            "k_eq": (k_eq, (3, 3, cin, cout)),
            "k_pole": (k_pole, (3, 3, cin, cout)),
            "b_eq": (b_eq, (cout,)),
            "b_pole": (b_pole, (cout,)),
        }
        for name, (t, want) in shapes.items():
            if tuple(t.shape) != want:
                raise ValueError(f"{name} must be {want}, got {tuple(t.shape)}")
            if t.device != x.device or t.dtype != x.dtype:
                raise ValueError(
                    f"{name} is {t.dtype} on {t.device}; x is {x.dtype} on {x.device}"
                )
        args = [x, ext, k_eq, k_pole, b_eq, b_pole]
        if not all(t.is_contiguous() for t in args):
            raise ValueError("cs_conv3x3 takes contiguous tensors")
        lib = self.build()
        dev = x.device.index if x.device.index is not None else torch.cuda.current_device()
        if torch.cuda.current_device() != dev:  # the launch goes to the current device
            with torch.cuda.device(dev):
                return self(x, ext, k_eq, k_pole, b_eq, b_pole)
        if dev not in self._sm_count:
            self._sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        h, cs = tile_plan(b, n, cout, self._sm_count[dev])
        out = torch.empty((b, 6, n, n, cout), dtype=x.dtype, device=x.device)
        stream = torch.cuda.current_stream(x.device).cuda_stream
        err = lib.cs_conv3x3_launch(
            _DTYPES[x.dtype], dev, *(t.data_ptr() for t in args), out.data_ptr(),
            b, n, cin, cout, h, cs, stream,
        )
        if err != 0:
            raise RuntimeError(
                f"cs_conv3x3 launch failed: {lib.cs_conv3x3_error_string(err).decode()}"
                f" (B={b}, n={n}, Cin={cin}, Cout={cout}, h={h}, cs={cs})"
            )
        with self._lock:
            self.launches += 1
        return out


cs_conv3x3 = _Conv3x3Kernel()
