"""The inference kernels as PyTorch operators, so that ``torch.export`` can
trace a model that launches them.

A kernel wrapper (:data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3`,
:data:`~dlwp_cs_tpu_torch.ops.ring_kernel.xring_fused_apply`) reads its
tensors' ``data_ptr`` and launches through ``ctypes``: a tracer's fake
tensors have no data, so ``torch.export`` cannot trace through it.  This
module registers two operators in the ``dlwp_cs_torch`` namespace:

* ``dlwp_cs_torch::cs_conv3x3`` (kernel #1, ``csrc/cs_conv3x3.cu``): the
  fused halo-pad + 3x3 conv's forward;
* ``dlwp_cs_torch::xring_fused_apply`` (kernel #7, ``csrc/cs_ring.cu``): the
  xring conv's fused select and ring correction.

Each operator's implementation is the wrapper itself: on a CUDA tensor it
plans, launches the kernel and counts the launch (or raises); on a CPU
tensor it runs the plain version.  The plans are Python work on shapes and
run there, never under fake tensors; ``register_fake`` gives the tracer
only the output's shape and dtype.  An exported program holds calls to
these operators by name, so a process that loads one imports this module
first (:mod:`dlwp_cs_tpu_torch.serve.export` does).

The operators serve inference only: training keeps
:func:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3_fused` and the xring
``autograd.Function``.  :func:`~dlwp_cs_tpu_torch.ops.conv.cs_conv` calls
them where no gradient is asked for, inside :func:`use_library_ops`; outside
it the live path calls the wrappers directly and pays no operator dispatch.
"""

from __future__ import annotations

import contextlib
import contextvars

import torch
from torch import Tensor

from dlwp_cs_tpu_torch.ops.hopper_conv import cs_conv3x3 as _conv_kernel
from dlwp_cs_tpu_torch.ops.ring_kernel import xring_fused_apply as _xring_kernel

__all__ = ["NAMESPACE", "cs_conv3x3_op", "library_ops_enabled", "use_library_ops",
           "xring_fused_apply_op"]

NAMESPACE = "dlwp_cs_torch"

_ROUTE: contextvars.ContextVar = contextvars.ContextVar("library_ops", default=False)


@contextlib.contextmanager
def use_library_ops(enabled: bool = True):
    """Within this context, ``cs_conv``'s inference 3x3 convs call the
    registered operators in place of the kernel wrappers."""
    token = _ROUTE.set(bool(enabled))
    try:
        yield
    finally:
        _ROUTE.reset(token)


def library_ops_enabled(*tensors) -> bool:
    """True inside :func:`use_library_ops` when none of ``tensors`` will get
    a gradient (the operators have no backward)."""
    if not _ROUTE.get():
        return False
    return not (torch.is_grad_enabled() and any(
        t is not None and t.requires_grad for t in tensors))


@torch.library.custom_op(f"{NAMESPACE}::cs_conv3x3", mutates_args=())
def cs_conv3x3_op(x: Tensor, ext: Tensor, k_eq: Tensor, k_pole: Tensor, b_eq: Tensor,
                  b_pole: Tensor) -> Tensor:
    """Kernel #1 on a CUDA tensor, ``cs_conv3x3_plain`` on a CPU tensor;
    arguments as :data:`~dlwp_cs_tpu_torch.ops.hopper_conv.cs_conv3x3`."""
    return _conv_kernel(x, ext, k_eq, k_pole, b_eq, b_pole)


@cs_conv3x3_op.register_fake
def _(x, ext, k_eq, k_pole, b_eq, b_pole):
    return x.new_empty(tuple(x.shape[:-1]) + (k_eq.shape[-1],))


@torch.library.custom_op(f"{NAMESPACE}::xring_fused_apply", mutates_args=())
def xring_fused_apply_op(base_eq: Tensor, base_po: Tensor, ext: Tensor, k_eq: Tensor,
                         k_pole: Tensor) -> Tensor:
    """Kernel #7 on a CUDA tensor, ``xring_fused_apply_plain`` on a CPU
    tensor; arguments as
    :data:`~dlwp_cs_tpu_torch.ops.ring_kernel.xring_fused_apply`."""
    return _xring_kernel(base_eq, base_po, ext, k_eq, k_pole)


@xring_fused_apply_op.register_fake
def _(base_eq, base_po, ext, k_eq, k_pole):
    return torch.empty_like(base_eq)
