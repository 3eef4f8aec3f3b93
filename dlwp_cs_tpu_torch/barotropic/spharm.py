"""Spherical harmonic transforms in torch (triangular truncation).

The counterpart of ``dlwp_cs_tpu.barotropic.spharm``, the transform under
the barotropic baseline: longitude is an FFT (``torch.fft.rfft`` /
``irfft``), latitude a contraction against the associated Legendre table
``(M+1, L+1, nlat)`` on a Gaussian grid (exact quadrature for triangular
truncation).  Spectral layout: complex coefficients ``[m, l]`` on an
``(M+1, L+1)`` array, zero for ``l < m`` (triangular T{L}).

The tables are built once in float64 with numpy and cast lazily per (real
dtype, device), so a float64 round trip reaches ~1e-12.  ``torch.einsum``
does not mix complex and real operands: the Legendre contractions run on
the real view of the complex side.  On the card a float32 contraction runs
in full float32 whatever ``torch.backends.cuda.matmul.allow_tf32`` says
(:func:`~dlwp_cs_tpu_torch.ops.ringfix._full_f32`).
"""

from __future__ import annotations

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.ops.ringfix import _full_f32

__all__ = ["SphericalHarmonics"]

_EARTH_RADIUS = 6.371e6


def _gauss_legendre(n: int):
    """Gaussian nodes (sin lat) and weights on [-1, 1]."""
    x, w = np.polynomial.legendre.leggauss(n)
    return x, w


class SphericalHarmonics:
    """Forward/inverse SHT on a Gaussian grid, truncation T{lmax}.

    ``grid_to_spec(f)``: ``(..., nlat, nlon)`` real -> ``(..., M+1, L+1)``
    complex; ``spec_to_grid`` inverts.  Also provides the Laplacian's
    eigenvalues and the spectral operators the barotropic model uses.
    ``device``: where numpy inputs go (``None``: the GPU, which must
    exist); a tensor is transformed on its own device.
    """

    def __init__(self, lmax: int, *, nlat: int | None = None, nlon: int | None = None,
                 radius: float = _EARTH_RADIUS, device=None):
        self.device = resolve_device(device)
        self.lmax = int(lmax)
        self.nlat = nlat or (lmax + 1) * 3 // 2 + 1
        self.nlon = nlon or 2 * self.nlat
        self.radius = float(radius)
        if self.nlon <= 2 * self.lmax:
            # at nlon == 2*lmax the m = lmax mode lands in the rfft Nyquist
            # bin, whose single-real-coefficient convention breaks the
            # half-complex doubling this transform assumes: round trips
            # would silently corrupt every l at m = lmax
            raise ValueError(
                f"nlon={self.nlon} must exceed 2*lmax={2 * self.lmax} "
                "(Nyquist aliasing of the highest zonal mode)"
            )
        x, w = _gauss_legendre(self.nlat)
        order = np.argsort(x)  # ascending latitude
        self.sinlat = x[order]
        self.weights = w[order]
        self.lats = np.arcsin(self.sinlat)
        self.lons = np.arange(self.nlon) * 2 * np.pi / self.nlon
        self._plm = self._build_legendre()  # (M+1, L+1, nlat) float64
        l = np.arange(self.lmax + 1)
        self.laplacian_eig = -l * (l + 1) / self.radius**2  # per l
        self._tables: dict = {}

    def _tables_for(self, real_dtype, device):
        """The float64 tables cast to ``real_dtype`` on ``device``: the
        Legendre table, the quadrature weights, the Laplacian's eigenvalues
        (and theirs with l = 0 set to 1), ``i m``, cos(lat) ``(nlat, 1)`` and
        the latitude spacing's gradient ``(nlat, 1)``."""
        key = (real_dtype, device)
        if key not in self._tables:
            def cast(a):
                return torch.as_tensor(a, dtype=real_dtype, device=device)

            m = torch.arange(self.lmax + 1, dtype=real_dtype, device=device)[:, None]
            lat = cast(self.lats)
            self._tables[key] = {
                "plm": cast(self._plm),
                "w": cast(self.weights),
                "eig": cast(self.laplacian_eig),
                "eig_inv": cast(np.where(self.laplacian_eig == 0, 1.0, self.laplacian_eig)),
                "im": torch.complex(torch.zeros_like(m), m),
                "coslat": cast(np.sqrt(1.0 - self.sinlat**2))[:, None],
                "dlat": torch.gradient(lat)[0][:, None],
            }
        return self._tables[key]

    def _tensor(self, a):
        return a if isinstance(a, torch.Tensor) else torch.as_tensor(a, device=self.device)

    # -- tables ------------------------------------------------------------
    def _build_legendre(self) -> np.ndarray:
        lmax, x = self.lmax, self.sinlat
        nlat = len(x)
        p = np.zeros((lmax + 1, lmax + 1, nlat))
        sx = np.sqrt(np.maximum(0.0, 1.0 - x * x))
        pmm = np.full(nlat, 1.0 / np.sqrt(4.0 * np.pi))
        p[0, 0] = pmm
        for m in range(1, lmax + 1):
            pmm = -np.sqrt((2.0 * m + 1.0) / (2.0 * m)) * sx * pmm
            p[m, m] = pmm
        for m in range(lmax + 1):
            if m + 1 <= lmax:
                p[m, m + 1] = np.sqrt(2.0 * m + 3.0) * x * p[m, m]
            for l in range(m + 2, lmax + 1):
                a = np.sqrt((4.0 * l**2 - 1.0) / (l**2 - m**2))
                b = np.sqrt(((l - 1.0) ** 2 - m**2) / (4.0 * (l - 1.0) ** 2 - 1.0))
                p[m, l] = a * (x * p[m, l - 1] - b * p[m, l - 2])
        return p

    # -- transforms --------------------------------------------------------
    def grid_to_spec(self, f):
        """Real field(s) ``(..., nlat, nlon)`` -> complex ``(..., M+1, L+1)``."""
        f = self._tensor(f)
        fm = torch.fft.rfft(f, dim=-1)[..., : self.lmax + 1]  # (..., nlat, M+1)
        fm = fm.transpose(-1, -2)  # (..., M+1, nlat)
        t = self._tables_for(fm.real.dtype, fm.device)
        # quadrature: sum_j f_m(x_j) P_l^m(x_j) w_j, on the real view
        integrand = torch.view_as_real((fm * t["w"]).contiguous())
        with _full_f32(f):
            spec = torch.einsum("...mjc,mlj->...mlc", integrand, t["plm"])
        return torch.view_as_complex(spec.contiguous()) * (2.0 * np.pi / self.nlon)

    def spec_to_grid(self, spec):
        """Complex ``(..., M+1, L+1)`` -> real ``(..., nlat, nlon)``."""
        spec = self._tensor(spec)
        t = self._tables_for(spec.real.dtype, spec.device)
        with _full_f32(spec):
            fm = torch.einsum("...mlc,mlj->...mjc", torch.view_as_real(spec.resolve_conj()),
                              t["plm"])
        fm = torch.view_as_complex(fm.contiguous()).transpose(-1, -2)  # (..., nlat, M+1)
        full = fm.new_zeros(fm.shape[:-1] + (self.nlon // 2 + 1,))
        full[..., : self.lmax + 1] = fm
        return torch.fft.irfft(full, n=self.nlon, dim=-1) * self.nlon

    # -- differential operators (spectral) ---------------------------------
    def laplacian(self, spec):
        return spec * self._tables_for(spec.real.dtype, spec.device)["eig"]

    def inverse_laplacian(self, spec):
        out = spec / self._tables_for(spec.real.dtype, spec.device)["eig_inv"]
        out[..., 0] = 0.0
        return out

    def ddlon(self, spec):
        """d/dlon in spectral space: multiply by i*m."""
        return spec * self._tables_for(spec.real.dtype, spec.device)["im"]

    def cos_lat_grad(self, spec):
        """``(f, dx, dy)`` on the grid: the field, its longitude derivative
        over ``a cos(lat)`` (exact, spectral) and its latitude derivative
        over ``a``, by differences of the grid field along latitude
        (centred inside, one-sided at the ends) over those of the latitudes.
        """
        f = self.spec_to_grid(spec)
        dflon = self.spec_to_grid(self.ddlon(spec))
        t = self._tables_for(f.dtype, f.device)
        dx = dflon / (self.radius * t["coslat"])
        dlat = torch.gradient(f, dim=f.ndim - 2)[0] / t["dlat"]
        return f, dx, dlat / self.radius
