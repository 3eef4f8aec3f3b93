"""The reference's PyTorch mirror names over the port's own modules.

``dlwp_cs_tpu.models.torch_mirror`` is the JAX package's CPU-only torch
re-implementation of its cubed-sphere model, kept as a cross-framework
oracle.  In the port the PyTorch model is the system itself, so these names
are thin aliases: :func:`torch_cs_pad` is
:func:`~dlwp_cs_tpu_torch.ops.padding.cs_pad`,
:class:`TorchCubeSphereConv2D` a
:class:`~dlwp_cs_tpu_torch.models.layers.CubeSphereConv2D` built from given
weights, :class:`TorchCubeSphereUNet` a
:class:`~dlwp_cs_tpu_torch.models.unet.CubeSphereUNet` built when the flax
parameters arrive.  They take ``device=`` (``None``: the GPU, which must
exist), and run on the port's kernels there.
"""

from __future__ import annotations

import numpy as np
import torch

from dlwp_cs_tpu_torch.device import resolve_device
from dlwp_cs_tpu_torch.models.config import UNetConfig
from dlwp_cs_tpu_torch.models.layers import CubeSphereConv2D
from dlwp_cs_tpu_torch.models.unet import CubeSphereUNet
from dlwp_cs_tpu_torch.models.weights import load_jax_params
from dlwp_cs_tpu_torch.ops.padding import cs_pad

__all__ = ["TorchCubeSphereConv2D", "TorchCubeSphereUNet", "torch_cs_pad"]

torch_cs_pad = cs_pad


class TorchCubeSphereConv2D(CubeSphereConv2D):
    """Cubed-sphere conv with the given HWIO weights (numpy or tensors):
    faces 0-3 take ``kernel_eq`` and ``bias_eq``, faces 4-5 ``kernel_pole``
    and ``bias_pole`` (no bias where ``bias_eq`` is None)."""

    def __init__(self, kernel_eq, kernel_pole, bias_eq=None, bias_pole=None, *, device=None):
        k_eq = torch.as_tensor(np.asarray(kernel_eq, np.float32))
        kh, kw, cin, cout = k_eq.shape
        super().__init__(cin, cout, (kh, kw), use_bias=bias_eq is not None,
                         generator=torch.Generator())  # overwritten below
        params = {"kernel_eq": k_eq, "kernel_pole": np.asarray(kernel_pole, np.float32)}
        if bias_eq is not None:
            params["bias_eq"] = np.asarray(bias_eq, np.float32)
            params["bias_pole"] = np.asarray(bias_eq if bias_pole is None else bias_pole,
                                             np.float32)
        with torch.no_grad():
            for name, value in params.items():
                getattr(self, name).copy_(torch.as_tensor(value))
        self.to(resolve_device(device))

    @staticmethod
    def from_flax(scope: dict, *, device=None) -> "TorchCubeSphereConv2D":
        """Build from one flax CubeSphereConv2D parameter scope."""
        return TorchCubeSphereConv2D(
            scope["kernel_eq"],
            scope.get("kernel_pole", scope["kernel_eq"]),
            scope.get("bias_eq"),
            scope.get("bias_pole", scope.get("bias_eq")),
            device=device,
        )


class TorchCubeSphereUNet:
    """:class:`~dlwp_cs_tpu_torch.models.unet.CubeSphereUNet` of ``config``,
    built by :meth:`load_flax_params` (which reads the input channels off the
    parameters); calling it on a numpy array or a tensor runs the float32
    forward without gradients on ``device``."""

    def __init__(self, config: UNetConfig, *, device=None):
        self.config = config
        self.device = resolve_device(device)
        self.model: CubeSphereUNet | None = None

    def load_flax_params(self, params) -> "TorchCubeSphereUNet":
        """Load a flax parameter tree, ``{"params": {...}}`` or its inside."""
        tree = params.get("params", params)
        cin = np.shape(tree["enc0_conv0"]["kernel_eq"])[2]
        model = CubeSphereUNet(self.config, cin, device=self.device).eval()
        self.model = load_jax_params(model, {"params": tree})
        return self

    def __call__(self, x):
        if self.model is None:
            raise RuntimeError("call load_flax_params first")
        x = torch.as_tensor(x).to(self.device, torch.float32)
        with torch.no_grad():
            return self.model(x)
