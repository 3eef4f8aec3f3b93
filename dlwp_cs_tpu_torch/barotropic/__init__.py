"""Barotropic vorticity baseline on torch spherical harmonics."""

from dlwp_cs_tpu_torch.barotropic.model import BarotropicModel
from dlwp_cs_tpu_torch.barotropic.spharm import SphericalHarmonics

__all__ = ["BarotropicModel", "SphericalHarmonics"]
