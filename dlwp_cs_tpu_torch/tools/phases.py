"""Variants of a kernel library with phases compiled out, for the phase
tools (``ring_phases``, ``im2col_phases``).

A tool names switches, the source text each switch guards (its anchors,
each of which must appear in the source once) and its variants (a name and
the switches it turns on).  Each variant is the source with every guard in
place and a ``#define`` per switch, built by ``nvcc`` under
``_build/<tool>/<variant>/`` beside copies of the source's headers.
"""

from __future__ import annotations

from concurrent.futures import ThreadPoolExecutor

from dlwp_cs_tpu_torch.ops import cuda_build

__all__ = ["patched_source", "variant_libraries"]


def patched_source(lib: cuda_build.CudaLibrary, anchors, switches, on) -> str:
    """``lib``'s source with every guard of ``anchors`` (switch -> [(old,
    new)]) in place and every switch of ``switches`` defined, those of
    ``on`` to 1."""
    src = lib.source.read_text()
    for name, pairs in anchors.items():
        for old, new in pairs:
            if src.count(old) != 1:
                raise RuntimeError(f"an anchor of {name} is not in {lib.source.name} once")
            src = src.replace(old, new)
    return "".join(f"#define {s} {int(s in on)}\n" for s in switches) + src


def variant_libraries(lib: cuda_build.CudaLibrary, anchors, switches, variants,
                      subdir: str) -> dict[str, cuda_build.CudaLibrary]:
    """One built library per variant of ``variants`` (name -> switches on),
    with ``lib``'s entry points, under ``_build/<subdir>/<name>/``: one
    ``nvcc`` per variant, all started at once."""

    def build(name):
        d = cuda_build._BUILD_ROOT / subdir / name
        d.mkdir(parents=True, exist_ok=True)
        for h in lib.source.parent.glob("*.cuh"):
            (d / h.name).write_bytes(h.read_bytes())
        (d / lib.source.name).write_text(
            patched_source(lib, anchors, switches, variants[name]))
        variant = cuda_build.CudaLibrary(lib.source.name, lib.functions, lib.error_string)
        variant.source = d / lib.source.name
        variant.build()
        return variant

    with ThreadPoolExecutor(len(variants)) as pool:
        return dict(zip(variants, pool.map(build, variants)))
