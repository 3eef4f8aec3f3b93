"""Barotropic vorticity model on spherical harmonics (dynamical baseline).

The counterpart of ``dlwp_cs_tpu.barotropic.model``, the reference's
algorithm on the port's transform (:mod:`.spharm`): RK4 steps of

    d(zeta)/dt = -V . grad(zeta + f) - nu * (-lap)^k zeta,

with psi = lap^{-1} zeta, u = -(1/a) dpsi/dphi, v = (1/(a cos)) dpsi/dlambda
and the advection evaluated pseudo-spectrally (transform method).  The
integration is a Python loop of steps on the model's device in place of
the reference's two ``lax.scan``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np
import torch

from dlwp_cs_tpu_torch.barotropic.spharm import SphericalHarmonics

__all__ = ["BarotropicModel"]

_OMEGA = 7.292e-5  # Earth rotation rate, 1/s


@dataclass
class BarotropicModel:
    """T{lmax} barotropic vorticity model.

    Attributes:
      sht: the transform/grid object; the model runs on its device.
      dt: time step in seconds.
      hyperdiffusion_order: k in (-lap)^k (2 = del^4).
      hyperdiffusion_time: e-folding time (s) of the smallest resolved scale.
    """

    sht: SphericalHarmonics
    dt: float = 1800.0
    hyperdiffusion_order: int = 2
    hyperdiffusion_time: float = 6 * 3600.0

    def __post_init__(self):
        s = self.sht
        eig = np.abs(s.laplacian_eig)  # per-l positive eigenvalues
        k = self.hyperdiffusion_order
        # rounded to float32 in every dtype, as the reference's
        self._damp = np.float32((eig / eig[-1]) ** k / self.hyperdiffusion_time)  # (L+1,)
        coslat = np.sqrt(1.0 - s.sinlat**2)
        # planetary vorticity enters the tendency through the beta term only
        self._beta_y = 2.0 * _OMEGA * coslat[:, None] / s.radius
        self._consts: dict = {}

    def _terms(self, real_dtype, device):
        """The damping ``(L+1,)`` and beta ``(nlat, 1)`` terms in
        ``real_dtype`` on ``device``."""
        key = (real_dtype, device)
        if key not in self._consts:
            self._consts[key] = tuple(torch.as_tensor(a, dtype=real_dtype, device=device)
                                      for a in (self._damp, self._beta_y))
        return self._consts[key]

    def tendency(self, zeta_spec):
        """d(zeta_spec)/dt for spectral relative vorticity."""
        s = self.sht
        damp, beta_y = self._terms(zeta_spec.real.dtype, zeta_spec.device)
        psi = s.inverse_laplacian(zeta_spec)
        _, dpsi_x, dpsi_y = s.cos_lat_grad(psi)
        u, v = -dpsi_y, dpsi_x
        _, dz_x, dz_y = s.cos_lat_grad(zeta_spec)
        adv = u * dz_x + v * (dz_y + beta_y)
        return -s.grid_to_spec(adv) - zeta_spec * damp

    def step(self, zeta_spec):
        """One RK4 step."""
        dt = self.dt
        k1 = self.tendency(zeta_spec)
        k2 = self.tendency(zeta_spec + 0.5 * dt * k1)
        k3 = self.tendency(zeta_spec + 0.5 * dt * k2)
        k4 = self.tendency(zeta_spec + dt * k3)
        return zeta_spec + (dt / 6.0) * (k1 + 2 * k2 + 2 * k3 + k4)

    def integrate(self, zeta0_grid, n_steps: int, *, save_every: int = 1):
        """Integrate from a grid vorticity field ``(nlat, nlon)`` (a tensor,
        or an array that ``torch.as_tensor`` converts, keeping its dtype) on
        the model's device; returns the grid every ``save_every`` steps,
        ``(n_steps // save_every, nlat, nlon)``, there."""
        s = self.sht
        if save_every < 1:
            raise ValueError(f"save_every must be >= 1, got {save_every}")
        if n_steps % save_every:
            raise ValueError(
                f"n_steps={n_steps} not divisible by save_every={save_every} "
                f"— the trailing {n_steps % save_every} steps would be "
                "silently dropped"
            )
        z = s.grid_to_spec(torch.as_tensor(zeta0_grid, device=s.device))
        snaps = []
        for _ in range(n_steps // save_every):
            for _ in range(save_every):
                z = self.step(z)
            snaps.append(s.spec_to_grid(z))
        return torch.stack(snaps)

    # -- helpers -----------------------------------------------------------
    def solid_body_vorticity(self, u0: float = 15.0):
        """Grid relative vorticity (numpy) of solid-body zonal flow u =
        u0*cos(lat)."""
        s = self.sht
        return 2.0 * u0 * s.sinlat[:, None] / s.radius * np.ones((1, s.nlon))

    def rossby_haurwitz_vorticity(self, m: int = 4, amp: float = 8e-6):
        """Classic Rossby-Haurwitz-like initial relative vorticity (numpy)."""
        s = self.sht
        lat = s.lats[:, None]
        lon = s.lons[None, :]
        return amp * np.cos(lat) ** m * np.sin(m * lon) * np.sin(lat) + (
            self.solid_body_vorticity(15.0)
        )
