"""The work a model call needs, from the layer list of a model kind
(``flops/<kind>.py``): FLOPs, and the least time the card could take for
the 3x3 convs by their FLOPs and bytes.

A layer is ``(n, cin, cout, k, count)``: a ``k x k`` conv on ``6 * n * n``
cells per row, ``count`` times a call.  A conv's FLOPs are ``2 * rows * 6
* n * n * k * k * cin * cout``; its bytes, each input read once and each
output written once: the activations in, the result out and both weight
groups.
"""

from __future__ import annotations

DTYPE_BYTES = {"float32": 4, "bfloat16": 2}


def _flops(rows, n, cin, cout, k):
    return 2.0 * rows * 6 * n * n * k * k * cin * cout


def forward_flops(layers, rows: int) -> float:
    return sum(_flops(rows, n, ci, co, k) * c for n, ci, co, k, c in layers)


def conv3x3_bound_s(layers, rows: int, *, peak_flops: float, bytes_per_s: float,
                    dtype: str) -> float:
    """Sum over the 3x3 convs of ``max(FLOPs / peak, bytes / bandwidth)``."""
    b = DTYPE_BYTES[dtype]
    total = 0.0
    for n, ci, co, k, c in layers:
        if k != 3:
            continue
        nbytes = rows * 6 * n * n * (ci + co) + 2 * k * k * ci * co
        total += c * max(_flops(rows, n, ci, co, k) / peak_flops, nbytes * b / bytes_per_s)
    return total
