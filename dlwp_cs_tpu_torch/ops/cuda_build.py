"""Build, bind and launch the hand-written CUDA kernels of ``csrc/``.

Each kernel source is compiled with ``nvcc`` for ``sm_90a`` at its first
CUDA use into ``dlwp_cs_tpu_torch/_build/<hash of source, headers and
flags>/`` and
bound with ``ctypes`` (plain C entry points; no PyTorch headers).  Every
entry point takes ``(dtype, device, pointers..., six sizes, stream)`` and
returns a ``cudaError_t``.  :class:`KernelWrapper` is the launch
bookkeeping the kernel wrappers share: the library, the launch count and
the SM count per device.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import shutil
import subprocess
import threading
from pathlib import Path

import torch

__all__ = [
    "CudaLibrary",
    "DTYPES",
    "I32",
    "KernelWrapper",
    "VP",
    "check_cuda_args",
    "check_faces",
]

_PKG = Path(__file__).resolve().parents[1]
_BUILD_ROOT = _PKG / "_build"
_NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
    "-shared", "-Xcompiler", "-fPIC", "-Xptxas", "-v",
)
# element types the kernels take, as the ``dtype`` code of their entry points
DTYPES = {torch.float32: 0, torch.bfloat16: 1}
VP, I32 = ctypes.c_void_p, ctypes.c_int


def _find_nvcc() -> str:
    for cand in (
        os.path.join(os.environ.get("CUDA_HOME", "/usr/local/cuda"), "bin", "nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError("nvcc not found: set CUDA_HOME or put nvcc on PATH")


class CudaLibrary:
    """A shared library compiled by ``nvcc`` from one source under
    ``csrc/``, cached under ``_build/`` by the hash of the source and the
    flags, and loaded with ``ctypes``.  ``functions`` maps each C entry point
    to its argument types; every entry point returns a ``cudaError_t``, which
    ``error_string`` names."""

    def __init__(self, source: str, functions: dict, error_string: str):
        self.source = _PKG / "csrc" / source
        self.functions = functions
        self.error_string = error_string
        self.build_log = ""
        self._lib = None
        self._lock = threading.Lock()

    def build(self):
        """Compile (once per source hash) and load the library."""
        with self._lock:
            if self._lib is not None:
                return self._lib
            # the source and every header of csrc/ it may include
            src = self.source.read_bytes() + b"".join(
                p.read_bytes() for p in sorted(self.source.parent.glob("*.cuh")))
            tag = hashlib.sha256(src + " ".join(_NVCC_FLAGS).encode()).hexdigest()[:16]
            lib_path = _BUILD_ROOT / tag / f"lib{self.source.stem}.so"
            if not lib_path.exists():
                lib_path.parent.mkdir(parents=True, exist_ok=True)
                tmp = lib_path.with_name(f".tmp{os.getpid()}.so")
                proc = subprocess.run(
                    [_find_nvcc(), *_NVCC_FLAGS, "-o", str(tmp), str(self.source)],
                    capture_output=True, text=True,
                )
                self.build_log = proc.stdout + proc.stderr
                if proc.returncode != 0:
                    raise RuntimeError(
                        f"nvcc failed on {self.source.name} ({proc.returncode}):\n"
                        f"{self.build_log}"
                    )
                os.replace(tmp, lib_path)
            lib = ctypes.CDLL(str(lib_path))
            for name, argtypes in self.functions.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = I32
            err = getattr(lib, self.error_string)
            err.argtypes = [I32]
            err.restype = ctypes.c_char_p
            self._lib = lib
            return lib


def check_cuda_args(name, ref, tensors):
    """Raise unless every tensor of ``tensors`` (``{name: (t, shape)}``) has
    its shape and ``ref``'s device and dtype, and all are contiguous."""
    if ref.dtype not in DTYPES:
        raise ValueError(f"{name} takes float32 or bfloat16, not {ref.dtype}")
    for arg, (t, want) in tensors.items():
        if tuple(t.shape) != want:
            raise ValueError(f"{arg} must be {want}, got {tuple(t.shape)}")
        if t.device != ref.device or t.dtype != ref.dtype:
            raise ValueError(
                f"{arg} is {t.dtype} on {t.device}; expected {ref.dtype} on {ref.device}"
            )
        if not t.is_contiguous():
            raise ValueError(f"{name} takes contiguous tensors ({arg} is not)")


def check_faces(name, t, strips: bool = False):
    """Raise unless ``t`` is a CUDA tensor shaped ``(B, 6, H, W, C)``: whole
    faces or a shard's local block (or, with ``strips``, ghost strips ``(B,
    6, 4, W+2, C)``).  Each wrapper then checks the exact shapes it takes."""
    if t.device.type != "cuda":
        raise ValueError(f"{name} runs on cuda or cpu, not {t.device}")
    if strips:
        if t.ndim != 5 or tuple(t.shape[1:3]) != (6, 4) or t.shape[3] < 3:
            raise ValueError(f"{name}: expected (B, 6, 4, W+2, C), got {tuple(t.shape)}")
    elif t.ndim != 5 or t.shape[1] != 6:
        raise ValueError(f"{name}: expected (B, 6, H, W, C), got {tuple(t.shape)}")


class KernelWrapper:
    """Launch bookkeeping shared by the kernel wrappers: the library, the
    launch count (``launches``, one per kernel launch and nowhere else) and
    the SM count per device."""

    def __init__(self, name: str, library: CudaLibrary):
        self.name = name
        self.library = library
        self.launches = 0
        self._lock = threading.Lock()
        self._sm_count: dict[int, int] = {}

    def _device(self, t) -> int:
        """The tensor's device index; the launch goes to the current device."""
        dev = t.device.index if t.device.index is not None else torch.cuda.current_device()
        if dev not in self._sm_count:
            self._sm_count[dev] = torch.cuda.get_device_properties(dev).multi_processor_count
        return dev

    def _launch(self, fn_name, dev, *args, sizes: int = 6):
        """Call the C entry point ``fn_name`` on the current stream of device
        ``dev``; ``args`` end with ``sizes`` sizes, which an error message
        names."""
        lib = self.library.build()
        if torch.cuda.current_device() != dev:  # the launch goes to the current device
            with torch.cuda.device(dev):
                return self._launch(fn_name, dev, *args, sizes=sizes)
        err = getattr(lib, fn_name)(*args, torch.cuda.current_stream(dev).cuda_stream)
        if err != 0:
            msg = getattr(lib, self.library.error_string)(err).decode()
            raise RuntimeError(f"{self.name} launch failed: {msg} (sizes {args[-sizes:]})")
        with self._lock:
            self.launches += 1
