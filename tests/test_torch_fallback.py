"""Shapes past a kernel's plan, and the fused ring apply's arrival counts.

``cs_conv`` on a CUDA tensor asks the wrappers' plans before any launch
(:func:`~dlwp_cs_tpu_torch.ops.hopper_conv.fused_fits`, :func:`~dlwp_cs_
tpu_torch.ops.ring_kernel.xring_fits`): where a plan of the kernels that
the call would run refuses the shape (the forward kernel's, the dx kernel's
when ``x`` will get a gradient and the dw kernel's when a weight or a bias
will, the ring kernel's under ``'xring'``), the conv takes the ring-fix
composition under ``'auto'`` and ``'xring'``, as the reference's ``'auto'``
does past its kernels' gates, and raises under ``'pallas'``, as the
reference's does.  Here, on the CPU, at an H100's 132 SMs:

* the route refuses exactly where one of those plans raises, over a grid
  of shapes, keeps every flagship shape (and n = 96) on its kernels, and
  refuses the shapes named in the port's fault record;
* which gradients are taken decides which backward plans count;
* ``'pallas'`` raises at a refused shape and ``'xring'`` takes ring-fix;
* at one refused shape (float32 with a gradient, n = 128, Cin = Cout = 32,
  batch 1: only the dw plan refuses), ``cs_conv`` with the SM count of a
  card (a stand-in on the CPU) takes the ring-fix composition, whose
  output and gradients match the JAX package's ``cs_conv`` (which takes
  ring-fix off the TPU) within 2e-5 of the largest entry (float32 sums in
  another order, as for ``ringfix`` in ``test_torch_ring.py``).

The fused ring apply keeps every arrival-count buffer it has handed out
alive, so that a CUDA graph captured before the buffer grew still counts
in memory of its own.  The card tests (``tests/test_torch_cuda.py``) train
through the refused shape and replay such a graph.
"""

import gc
import weakref

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.ops.conv import cs_conv as j_cs_conv
from dlwp_cs_tpu_torch.ops import conv as conv_mod
from dlwp_cs_tpu_torch.ops.conv import cs_conv
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    dw_launch_args,
    dx_plan_args,
    fused_fits,
    fwd_plan,
    fwd_plan_args,
)
from dlwp_cs_tpu_torch.ops.ring_kernel import (
    _RING_LIB,
    _XringApplyKernel,
    ring_plan,
    xring_fits,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

SMS = 132
DTYPES = [torch.float32, torch.bfloat16]
# (n, Cin, Cout) of the flagship U-Net's 3x3 convs and the n = 96 shape of
# the card's checks; (n, Cin, D) of the ConvLSTM's gate convs (xring)
FLAGSHIP = [(48, 12, 32), (48, 32, 32), (24, 32, 64), (24, 64, 64), (12, 64, 128),
            (12, 128, 128), (24, 192, 64), (48, 96, 32), (96, 64, 64)]
GATES = [(48, 39, 128), (48, 64, 128)]
GRID = [(b, n, c) for b in (1, 16) for n in (48, 96, 128, 192, 256, 384)
        for c in (8, 16, 32, 192, 384, 512)]


def _refuses(fn, *args):
    try:
        fn(*args)
    except ValueError:
        return True
    return False


def conv3x3_route(dtype, b, n, cin, cout, sms, grad, backend):
    """The route ``cs_conv`` takes on a card of ``sms`` SMs, with every
    gradient taken (``grad``) or none."""
    if backend == "xring":
        fits = xring_fits(dtype, b, n, cin, cout, sms)
    else:
        fits = fused_fits(dtype, b, n, cin, cout, sms, grad, grad)
    return "kernel" if fits else "ringfix"


def _plans_refuse(dtype, b, n, cin, cout, grad, backend):
    """Whether a plan of the kernels that ``cs_conv`` would launch refuses,
    asked of the plan functions themselves."""
    if backend == "xring":
        return _refuses(ring_plan, dtype, b, n, cin, cout, SMS)
    plans = [(fwd_plan_args, (dtype, b, n, n, cin, cout, SMS))]
    if grad:
        plans += [(dx_plan_args, (dtype, b, n, cin, cout, SMS)),
                  (dw_launch_args, (dtype, b, n, cin, cout, SMS))]
    return any(_refuses(fn, *args) for fn, args in plans)


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("grad", [False, True])
@pytest.mark.parametrize("backend", ["auto", "xring"])
def test_route_refuses_exactly_where_a_plan_refuses(dtype, grad, backend):
    refused = 0
    for b, n, c in GRID:
        want = "ringfix" if _plans_refuse(dtype, b, n, c, c, grad, backend) else "kernel"
        assert conv3x3_route(dtype, b, n, c, c, SMS, grad, backend) == want, (b, n, c)
        refused += want == "ringfix"
    assert 0 < refused < len(GRID)  # the grid reaches both sides


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("b", [1, 16])
def test_route_keeps_the_flagship_shapes_on_their_kernels(dtype, b):
    for n, cin, cout in FLAGSHIP:
        for grad in (False, True):
            assert conv3x3_route(dtype, b, n, cin, cout, SMS, grad, "auto") == "kernel"
    for n, cin, d in GATES:
        assert conv3x3_route(dtype, b, n, cin, d, SMS, True, "xring") == "kernel"


@pytest.mark.parametrize("dtype,n,cin,grad,backend", [
    (torch.float32, 128, 32, True, "auto"),     # the f32 dw kernel's row of n = 128
    (torch.float32, 192, 8, True, "auto"),      # ... of n = 192, at every Cin
    (torch.float32, 256, 32, True, "auto"),     # the dx kernel's 258-pixel frame row
    (torch.bfloat16, 256, 32, True, "auto"),
    (torch.bfloat16, 48, 512, False, "auto"),   # the bf16 forward's weights of one slice
    (torch.bfloat16, 192, 384, False, "auto"),
    (torch.float32, 48, 512, False, "xring"),   # the ring kernel's f32 block
    (torch.bfloat16, 384, 8, False, "auto"),    # every kernel at n = 384
    (torch.float32, 384, 8, False, "auto"),
])
@pytest.mark.parametrize("b", [1, 16])
def test_route_refuses_the_recorded_fault_shapes(dtype, n, cin, grad, backend, b):
    """Each recorded fault shape takes ring-fix, but the bfloat16
    forward's: where one slice's resident weights do not fit, the forward
    kernel streams them with each chunk, so those shapes stay on #1."""
    if (dtype, grad, backend) == (torch.bfloat16, False, "auto") and n < 384:
        assert fwd_plan_args(dtype, b, n, n, cin, cin, SMS) == fwd_plan(
            dtype, b, n, n, cin, cin, SMS, stream=True).args()
        with pytest.raises(ValueError, match="cannot hold the weights"):
            fwd_plan(dtype, b, n, n, cin, cin, SMS, stream=False)
        assert conv3x3_route(dtype, b, n, cin, cin, SMS, grad, backend) == "kernel"
        return
    assert conv3x3_route(dtype, b, n, cin, cin, SMS, grad, backend) == "ringfix"


@pytest.mark.parametrize("cin", [8, 16])
def test_float32_dw_still_plans_narrow_inputs_at_n128(cin):
    assert conv3x3_route(torch.float32, 1, 128, cin, cin, SMS, True, "auto") == "kernel"


def test_route_is_memoised():
    for fits, args in ((fused_fits, (torch.float32, 1, 128, 32, 32, SMS, True, True)),
                       (xring_fits, (torch.float32, 1, 48, 512, 512, SMS))):
        fits(*args)
        hits = fits.cache_info().hits
        fits(*args)
        assert fits.cache_info().hits == hits + 1


@pytest.mark.parametrize("dtype,n,x_grad,w_grad,fits", [
    (torch.float32, 128, False, True, False),   # the dw plan refuses: weights need it
    (torch.float32, 128, True, False, True),    # frozen weights: no dw launch
    (torch.bfloat16, 256, False, True, True),   # data input: no dx launch
    (torch.bfloat16, 256, True, False, False),  # the dx plan refuses
    (torch.float32, 128, True, True, False),
    (torch.bfloat16, 256, False, False, True),
])
def test_the_gradients_taken_decide_which_backward_plans_count(monkeypatch, dtype, n, x_grad,
                                                                w_grad, fits):
    """``dx`` where ``x`` will get a gradient, ``dw`` where a weight or a
    bias will, as the fused backward launches them; under ``no_grad``
    neither."""
    monkeypatch.setattr(conv_mod, "_sm_count", lambda x: SMS)
    x = torch.empty((1, 6, n, n, 32), dtype=dtype, requires_grad=x_grad)
    ks = [torch.empty((3, 3, 32, 32), dtype=dtype, requires_grad=w_grad) for _ in range(2)]
    assert conv_mod._kernels_fit(x, *ks, None, None, "auto") is fits
    bias = torch.empty((32,), dtype=dtype, requires_grad=True)
    frozen = [k.detach() for k in ks]
    assert conv_mod._kernels_fit(x, *frozen, bias, None, "auto") is (
        fused_fits(dtype, 1, n, 32, 32, SMS, x_grad, True))
    with torch.no_grad():
        assert conv_mod._kernels_fit(x, *ks, bias, bias, "auto") is True


def _refused_case(seed=3):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(1, 6, 128, 128, 32)).astype(np.float32)
    ks = [(rng.normal(size=(3, 3, 32, 32)) * (9 * 32) ** -0.5).astype(np.float32)
          for _ in range(2)]
    bs = [(rng.normal(size=(32,)) * 0.1).astype(np.float32) for _ in range(2)]
    g = rng.normal(size=(1, 6, 128, 128, 32)).astype(np.float32)
    return [x, *ks, *bs], g


def _must_not_run(*args, **kwargs):
    raise AssertionError("cs_conv took a path that the route refuses")


def test_cs_conv_takes_ringfix_where_the_dw_plan_refuses(monkeypatch):
    """The refused shape through ``cs_conv`` with a card's SM count: the
    ring-fix composition, never the fused kernel path; output and
    gradients against the JAX package's ``cs_conv`` and ``jax.grad``."""
    monkeypatch.setattr(conv_mod, "_sm_count", lambda x: SMS)
    monkeypatch.setattr(conv_mod, "cs_conv3x3_fused", _must_not_run)
    args, g = _refused_case()
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    out = cs_conv(ins[0], ins[1], ins[2], bias_eq=ins[3], bias_pole=ins[4])
    grads = torch.autograd.grad(out, ins, torch.from_numpy(g))

    def j_out(*a):
        return j_cs_conv(a[0], a[1], a[2], bias_eq=a[3], bias_pole=a[4])

    jargs = [jnp.asarray(a) for a in args]
    ref = jax.jit(j_out)(*jargs)  # compiled once, not op by op
    ref_grads = jax.jit(jax.grad(lambda *a: jnp.vdot(j_out(*a), jnp.asarray(g)),
                                 argnums=(0, 1, 2, 3, 4)))(*jargs)
    for ours, r in zip((out, *grads), (ref, *ref_grads)):
        r = np.asarray(r)
        np.testing.assert_allclose(ours.detach().numpy(), r, rtol=0,
                                   atol=2e-5 * float(np.abs(r).max()))


@pytest.mark.parametrize("backend", ["pallas", "pallas_interpret"])
def test_pallas_raises_where_a_plan_refuses(monkeypatch, backend):
    """The reference's ``'pallas'`` raises where its kernels do not fit
    (only ``'auto'`` falls back); so does the port's, before any launch."""
    monkeypatch.setattr(conv_mod, "_sm_count", lambda x: SMS)
    monkeypatch.setattr(conv_mod, "cs_conv3x3_fused", _must_not_run)
    monkeypatch.setattr(conv_mod, "cs_conv3x3_ringfix", _must_not_run)
    args, _ = _refused_case()
    ins = [torch.from_numpy(a).requires_grad_(True) for a in args]
    with pytest.raises(ValueError, match="configuration unsupported"):
        cs_conv(ins[0], ins[1], ins[2], bias_eq=ins[3], bias_pole=ins[4], backend=backend)


@pytest.mark.parametrize("backend", ["xring", "xring_interpret"])
def test_xring_takes_ringfix_where_the_ring_plan_refuses(monkeypatch, backend):
    """At (1, 6, 48, 48, 512) -> 512 in float32 the ring kernel's plan
    refuses: ``cs_conv`` hands the conv, unchanged, to the ring-fix
    composition and never to the xring wrapper."""
    monkeypatch.setattr(conv_mod, "_sm_count", lambda x: SMS)
    monkeypatch.setattr(conv_mod, "cs_conv3x3_xring", _must_not_run)
    calls = []

    def ringfix(x, k_eq, k_pole, bias_eq=None, bias_pole=None):
        calls.append((x, k_eq, k_pole, bias_eq, bias_pole))
        return x

    monkeypatch.setattr(conv_mod, "cs_conv3x3_ringfix", ringfix)
    x = torch.zeros((1, 6, 48, 48, 512))
    k = torch.zeros((3, 3, 512, 512))
    with torch.no_grad():
        assert cs_conv(x, k, k, backend=backend) is x
    assert len(calls) == 1 and calls[0][1] is k and calls[0][3] is None


def test_cs_conv_keeps_the_kernel_path_without_a_gradient(monkeypatch):
    """The same shape without a gradient: the forward plan alone decides,
    and it plans, so the fused kernel path runs."""
    monkeypatch.setattr(conv_mod, "_sm_count", lambda x: SMS)
    calls = []

    def fused(*args):
        calls.append(args[0].shape)
        return torch.zeros(args[0].shape[:-1] + (args[2].shape[-1],))

    monkeypatch.setattr(conv_mod, "cs_conv3x3_fused", fused)
    args, _ = _refused_case()
    ts = [torch.from_numpy(a) for a in args]
    with torch.no_grad():
        cs_conv(ts[0], ts[1], ts[2], bias_eq=ts[3], bias_pole=ts[4])
    assert calls == [(1, 6, 128, 128, 32)]


def test_cpu_tensors_keep_their_path():
    """Without a card's SM count (a CPU tensor) nothing is routed: the
    wrappers' plain versions fit every shape."""
    x = torch.zeros((1, 6, 4, 4, 2), requires_grad=True)
    assert conv_mod._sm_count(x) is None
    assert conv_mod._kernels_fit(x, torch.zeros((3, 3, 2, 3)), torch.zeros((3, 3, 2, 3)),
                                 None, None, "auto") is True


def test_counter_buffers_outlive_their_growth():
    """Every arrival-count buffer handed out stays alive after the counts
    grow (a graph captured with it may replay later); the newest is the
    live one, and smaller requests keep getting it."""
    kernel = _XringApplyKernel("xring_fused_apply_test", _RING_LIB)
    cpu = torch.device("cpu")
    first = kernel._counters(cpu, 96)
    ref = weakref.ref(first)
    assert first.dtype == torch.int32 and first.numel() >= 96 and not first.any()
    del first
    grown = kernel._counters(cpu, 10 * ref().numel())
    gc.collect()
    assert ref() is not None and ref().data_ptr() != grown.data_ptr()
    assert grown.numel() >= 10 * ref().numel() and not grown.any()
    assert kernel._counters(cpu, 1) is grown
    bufs = kernel._count_buffers[cpu]
    assert len(bufs) == 2 and bufs[0] is ref() and bufs[1] is grown
