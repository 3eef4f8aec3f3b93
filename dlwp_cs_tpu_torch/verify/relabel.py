"""Face-ordering relabeling shim.

The port's copy of ``dlwp_cs_tpu.verify.relabel`` (pure numpy).  Different
cubed-sphere codes agree on the sphere but differ in face *ordering* and
per-face index *orientation*, so cross-implementation comparisons need a
relabeling: a permutation of the 6 faces combined with a D4 element
(quarter-turn rotation x optional transpose-flip) per face.

- :class:`FaceRelabeling`: the mapping, JSON-serializable.
- :func:`apply_relabeling` / :func:`invert_relabeling`: reindex ``(..., 6,
  n, n, C)`` arrays between conventions (numpy take/rot90; for golden
  tensors, not the compute path).
- :func:`infer_relabeling`: recover the mapping from one smooth
  non-symmetric field sampled in both conventions (e.g. cell-centre
  longitude and latitude).
"""

from __future__ import annotations

import dataclasses
import json
from dataclasses import dataclass

import numpy as np

__all__ = [
    "FaceRelabeling",
    "apply_relabeling",
    "invert_relabeling",
    "infer_relabeling",
]

# A D4 element is (k, flip): rotate the face array by k quarter turns
# (np.rot90 in the (row, col) plane), then, if flip, transpose rows/cols.


def _apply_d4(face: np.ndarray, k: int, flip: bool) -> np.ndarray:
    """``face``: ``(n, n, ...)`` with rows=axis0, cols=axis1."""
    out = np.rot90(face, k=k % 4, axes=(0, 1))
    if flip:
        out = np.swapaxes(out, 0, 1)
    return out


D4_ELEMENTS = tuple((k, flip) for flip in (False, True) for k in range(4))


@dataclass(frozen=True)
class FaceRelabeling:
    """Mapping OURS -> THEIRS.

    ``perm[f]``: which of *their* faces corresponds to our face ``f``.
    ``orient[f] = (k, flip)``: the D4 element transforming our face ``f``'s
    index layout into theirs.
    """

    perm: tuple[int, ...]
    orient: tuple[tuple[int, bool], ...]

    def __post_init__(self):
        if sorted(self.perm) != list(range(6)) or len(self.orient) != 6:
            raise ValueError(f"invalid relabeling {self.perm} / {self.orient}")

    def to_json(self) -> str:
        return json.dumps(dataclasses.asdict(self))

    @classmethod
    def from_json(cls, text: str) -> "FaceRelabeling":
        raw = json.loads(text)
        return cls(
            perm=tuple(raw["perm"]),
            orient=tuple((int(k), bool(f)) for k, f in raw["orient"]),
        )

    @classmethod
    def identity(cls) -> "FaceRelabeling":
        return cls(perm=tuple(range(6)), orient=((0, False),) * 6)


def apply_relabeling(
    x: np.ndarray, mapping: FaceRelabeling, *, axis: int | None = None
) -> np.ndarray:
    """Convert ``(..., 6, n, n)`` or ``(..., 6, n, n, C)`` from OUR convention
    to THEIRS.  The face axis is inferred as the unique axis of size 6 whose
    two successors are square; if the shape makes that ambiguous (e.g. a
    batch of 6 samples on an n=6 grid), pass ``axis`` explicitly."""
    ax = _face_axis(x) if axis is None else axis
    x = np.moveaxis(x, (ax, ax + 1, ax + 2), (0, 1, 2))
    out = np.empty_like(x)
    for f in range(6):
        out[mapping.perm[f]] = _apply_d4(x[f], *mapping.orient[f])
    return np.moveaxis(out, (0, 1, 2), (ax, ax + 1, ax + 2))


def invert_relabeling(mapping: FaceRelabeling) -> FaceRelabeling:
    """THEIRS -> OURS mapping such that applying both is the identity."""
    perm = [0] * 6
    orient = [(0, False)] * 6
    for f in range(6):
        g = mapping.perm[f]
        k, flip = mapping.orient[f]
        perm[g] = f
        # inverse of (rot_k then maybe transpose): transpose first (if set)
        # then rot_{-k}; in (k, flip) canonical form:
        orient[g] = (((-k) % 4, False) if not flip else (k % 4, True))
    return FaceRelabeling(perm=tuple(perm), orient=tuple(orient))


def _face_axis(x: np.ndarray) -> int:
    cands = [
        ax
        for ax in range(x.ndim - 2)
        if x.shape[ax] == 6 and x.shape[ax + 1] == x.shape[ax + 2]
    ]
    if not cands:
        raise ValueError(f"no (6, n, n) axis triple in shape {x.shape}")
    if len(cands) > 1:
        raise ValueError(
            f"shape {x.shape} has multiple (6, n, n) axis candidates "
            f"{cands} — pass axis= explicitly to apply_relabeling"
        )
    return cands[0]


def infer_relabeling(
    ours: np.ndarray, theirs: np.ndarray, *, rtol: float = 1e-3
) -> FaceRelabeling:
    """Recover the OURS->THEIRS mapping from one field in both conventions.

    ``ours`` / ``theirs``: ``(6, n, n)`` or ``(6, n, n, C)`` samples of the
    same smooth, non-symmetric physical field (cell-center lon/lat stacked as
    channels is ideal).  Every (our face, their face, D4) candidate is scored
    by normalized MSE; the assignment must be an unambiguous permutation or a
    ValueError is raised (symmetric fields can't identify the mapping).
    """
    a = np.asarray(ours, dtype=np.float64)
    b = np.asarray(theirs, dtype=np.float64)
    if a.shape != b.shape or a.shape[0] != 6 or a.shape[1] != a.shape[2]:
        raise ValueError(f"need matching (6, n, n[, C]) fields, got {a.shape} vs {b.shape}")
    scale = float(np.mean(a**2)) + 1e-30

    perm = [-1] * 6
    orient = [(0, False)] * 6
    taken = set()
    for f in range(6):
        scored = sorted(
            (
                float(np.mean((_apply_d4(a[f], k, flip) - b[g]) ** 2)) / scale,
                g,
                (k, flip),
            )
            for g in range(6)
            for k, flip in D4_ELEMENTS
        )
        # EVERY candidate below tolerance must be the single winner: a
        # same-face tie (a D4-symmetric field) is just as unidentifiable as
        # a cross-face one, and inspecting only the top two would let a
        # same-face duplicate shadow a genuine third-ranked ambiguity.
        hits = [c for c in scored if c[0] <= rtol]
        if not hits:
            err, g, d4 = scored[0]
            raise ValueError(
                f"our face {f}: no counterpart within rtol (best err {err:.3g} "
                f"vs their face {g} {d4})"
            )
        if len(hits) > 1:
            (e0, g0, d0), (e1, g1, d1) = hits[0], hits[1]
            raise ValueError(
                f"our face {f}: ambiguous match (their face {g0} {d0} err "
                f"{e0:.3g} vs {g1} {d1} err {e1:.3g}) — use a less "
                "symmetric field"
            )
        err, g, d4 = hits[0]
        if g in taken:
            raise ValueError(f"their face {g} matched twice — degenerate field")
        taken.add(g)
        perm[f] = g
        orient[f] = d4
    return FaceRelabeling(perm=tuple(perm), orient=tuple(orient))
