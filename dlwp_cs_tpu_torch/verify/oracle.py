"""Reference-allclose oracle against a golden file.

The counterpart of ``dlwp_cs_tpu.verify.oracle``: it reads a golden npz
extracted from another cubed-sphere implementation, recovers that
implementation's face convention from its cell centres
(:func:`~dlwp_cs_tpu_torch.verify.relabel.infer_relabeling` against this
package's geometry), relabels the golden tensors into this convention and
runs the port's own ``cs_pad`` and ``cs_conv`` (``backend="xla"``: a halo
pad and one VALID conv per weight group) on them, in the golden tensors'
dtype, on ``device`` (default: the GPU, as every entry point of the port;
the CPU tests pass ``device="cpu"``).

Golden file contract (npz):

- ``lonlat``  : (6, n, n, 2) degrees, the golden's convention (lon, lat).
- ``pad_in``  : (B, 6, n, n, C);  ``pad_out``: (B, 6, n+2w, n+2w, C); ``pad_width``: ().
- ``conv_in`` : (B, 6, n, n, Ci); ``conv_kernel_eq``/``conv_kernel_pole``:
  (kh, kw, Ci, Co) HWIO; ``conv_bias_eq``/``conv_bias_pole``: (Co,);
  ``conv_out``: (B, 6, n, n, Co).

Either group (pad, conv) may be missing.
"""

from __future__ import annotations

from dataclasses import dataclass
from pathlib import Path

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.padding import cs_pad
from dlwp_cs_tpu_torch.verify.relabel import (
    FaceRelabeling,
    _apply_d4,
    apply_relabeling,
    infer_relabeling,
    invert_relabeling,
)

__all__ = ["OracleReport", "compare_to_golden", "our_lonlat"]


def our_lonlat(n: int) -> np.ndarray:
    """(6, n, n, 2) cell-center (lon, lat) in degrees, OUR convention."""
    lat, lon = CubedSphere(n).cell_latlon
    return np.stack([np.rad2deg(lon), np.rad2deg(lat)], axis=-1)


@dataclass
class OracleReport:
    relabeling: FaceRelabeling
    lonlat_err_deg: float
    pad_err: float | None = None
    conv_err: float | None = None

    def ok(self, atol: float = 1e-4) -> bool:
        checks = [e for e in (self.pad_err, self.conv_err) if e is not None]
        return bool(checks) and all(e <= atol for e in checks)


def _group_kernel(kernel, to_ours, mapping, our_faces) -> np.ndarray:
    """Rotate a reference weight-group kernel into our convention.

    The data landing on our face ``f`` was transformed by the D4 element
    ``to_ours.orient[mapping.perm[f]]``; if that element is uniform across
    the group, applying it to the (kh, kw) kernel axes makes our conv
    reproduce the reference's (conv commutes with plane isometries applied
    to input, kernel and output alike).
    """
    ds = {to_ours.orient[mapping.perm[f]] for f in our_faces}
    if len(ds) != 1:
        raise ValueError(
            f"weight group faces {tuple(our_faces)} have non-uniform "
            f"orientation offsets {sorted(ds)}: the conventions cannot share "
            "group weights — reference grouping differs structurally"
        )
    (k, flip), = ds
    # kernel is (kh, kw, Ci, Co) with rows/cols leading — the same layout
    # contract as a face block, so relabel's D4 application is the single
    # source of truth (keeping the two modules in exact lockstep)
    return np.ascontiguousarray(_apply_d4(kernel, k, flip))


def compare_to_golden(path, *, device=None) -> OracleReport:
    """Run the allclose oracle against a golden npz on ``device``; returns
    the error report."""
    dev = resolve_device(device)
    t = lambda a: torch.from_numpy(np.ascontiguousarray(a)).to(dev)  # noqa: E731
    with np.load(Path(path)) as z:
        golden = {k: z[k] for k in z.files}
    lonlat_ref = golden["lonlat"]
    n = lonlat_ref.shape[1]

    # Step 1: empirically recover the reference's face convention.  Match on
    # 3-D unit vectors (lon wraps; naive lon-degree MSE would be wrong).
    lon = np.deg2rad(lonlat_ref[..., 0])
    lat = np.deg2rad(lonlat_ref[..., 1])
    xyz_ref = np.stack(
        [np.cos(lat) * np.cos(lon), np.cos(lat) * np.sin(lon), np.sin(lat)], -1
    )
    ours = our_lonlat(n)
    lon_o = np.deg2rad(ours[..., 0])
    lat_o = np.deg2rad(ours[..., 1])
    xyz_ours = np.stack(
        [np.cos(lat_o) * np.cos(lon_o), np.cos(lat_o) * np.sin(lon_o), np.sin(lat_o)],
        -1,
    )
    mapping = infer_relabeling(xyz_ours, xyz_ref)
    to_ours = invert_relabeling(mapping)
    # true angular error between unit vectors: 2*arcsin(chord/2), not a
    # rad2deg of a raw component difference (which saturates at ~114° for
    # antipodal cells instead of 180°)
    relabeled = apply_relabeling(xyz_ref, to_ours)
    chord = float(
        np.max(np.linalg.norm(relabeled - xyz_ours, axis=-1))
    )
    lonlat_err = 2.0 * np.arcsin(min(1.0, chord / 2.0))
    report = OracleReport(relabeling=mapping, lonlat_err_deg=np.rad2deg(lonlat_err))

    # Step 2: pad oracle.
    if "pad_in" in golden:
        x = apply_relabeling(golden["pad_in"], to_ours)
        want = apply_relabeling(golden["pad_out"], to_ours)
        w = int(golden["pad_width"])
        got = cs_pad(t(x), w).cpu().numpy()
        # Corner ghost cells are implementation-defined (the reference and
        # this repo both synthesize them; schemes may differ) — compare the
        # edge ghosts + interior, mask the four w x w corner blocks.
        mask = np.ones(got.shape, bool)
        mask[..., :w, :w, :] = False
        mask[..., :w, -w:, :] = False
        mask[..., -w:, :w, :] = False
        mask[..., -w:, -w:, :] = False
        report.pad_err = float(np.max(np.abs((got - want)[mask])))

    # Step 3: conv oracle.  If a weight group's faces all carry the same
    # orientation offset d (the common case: conventions differ by a global
    # rotation), conv commutes with d —
    # ``conv(d(x), d(kernel)) = d(conv(x, kernel))`` — so the reference's
    # kernels are rotated by the group's d before running our conv.  A
    # non-uniform group would mean the two implementations can't share
    # weights at all and is reported as a hard error.
    if "conv_in" in golden:
        x = apply_relabeling(golden["conv_in"], to_ours)
        want = apply_relabeling(golden["conv_out"], to_ours)
        # our eq group must land on the reference's eq group: a pole-axis-
        # changing relabeling (e.g. a 90° rotation about x) maps some of our
        # equatorial faces onto their pole faces — kernels can't be shared
        # even when the per-group orientation offsets happen to be uniform
        if sorted(mapping.perm[:4]) != [0, 1, 2, 3]:
            raise ValueError(
                f"relabeling maps our equatorial faces onto reference faces "
                f"{tuple(mapping.perm[:4])}: the conventions use different "
                "pole axes, so eq/polar weight groups cannot be shared"
            )
        k_eq = _group_kernel(golden["conv_kernel_eq"], to_ours, mapping, range(4))
        k_po = _group_kernel(golden["conv_kernel_pole"], to_ours, mapping, range(4, 6))
        got = cs_conv(
            t(x), t(k_eq), t(k_po),
            bias_eq=t(golden["conv_bias_eq"]), bias_pole=t(golden["conv_bias_pole"]),
            backend="xla",
        ).cpu().numpy()
        # Face-edge outputs depend on corner-ghost policy: compare
        # interiors, masking a margin of the kernel's half-width (a 5x5
        # kernel reads corner ghosts from 2 cells in, not 1).
        kh, kw = golden["conv_kernel_eq"].shape[:2]
        mh, mw = kh // 2, kw // 2
        interior = (
            got[..., mh : got.shape[-3] - mh, mw : got.shape[-2] - mw, :]
            - want[..., mh : want.shape[-3] - mh, mw : want.shape[-2] - mw, :]
        )
        report.conv_err = float(np.max(np.abs(interior)))
    return report
