from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere, edge_table
from dlwp_cs_tpu_torch.geometry.insolation import insolation

__all__ = ["CubedSphere", "edge_table", "insolation"]
