"""The kernel tools' kernels (#3, #12-#16): the port's plain versions against
the TPU kernels, run in JAX interpret mode on the CPU.

The reference launches these kernels only from its tools, mostly from
bodies nested inside a tool function (``tools/kernel_variants.py``'s
``_kernel_im2col``, ``_dx_aligned_kernel``, ``_store_kernel``) or defined at
the top of a script that compiles them when it is imported
(``tools/mosaic_bisect.py``'s kA-kE, ``tools/mosaic_bisect3.py``'s k1, k2).
:func:`_tool_kernel` takes such a body out of its file with ``ast`` (the
file is not edited) and defines it in a namespace holding ``jax``, ``jnp``,
``lax``, ``pl`` and the script's globals at this test's sizes; each test
then launches it through ``pl.pallas_call(..., interpret=True)`` with the
tool's BlockSpecs.  Kernel #3 is ``pallas_conv._kernel_npack`` and #12
``pallas_conv._kernel`` on strips computed beforehand, as the tools launch
them.  ``tools/mosaic_bisect2.py`` builds its four probes from one-line
lambdas passed to ``mk``; their bodies are written out here
(:data:`_BISECT2_BODIES`) in the shape of ``mk``'s kernel.

Interpret mode fills scratch memory that a kernel never writes with NaN:
bisect2's probes never write the padded E column and kD never writes its
scratch's frame, so the reference's outputs there are NaN; the port's
scratch starts as zeros.  Those tests compare where the reference is
defined and check that its NaNs are exactly the unwritten cells.

Inputs are seeded numpy at n = 8 (Cin in {8, 12}, Cout in {8, 16}).
Tolerances: float32 1e-5 absolute on outputs of order 1 (sums in another
order); bfloat16 one bf16 ulp of |ref| + 1e-4 (both sides round an f32 sum
once, and the two sums may straddle a rounding boundary); the copies, the
select, the bias add and 3·x exactly.
"""

import ast
import functools
from pathlib import Path

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from jax import lax
from jax.experimental import pallas as pl
from jax.experimental.pallas import tpu as pltpu

from dlwp_cs_tpu.ops import pallas_conv as pc
from dlwp_cs_tpu.ops.halo import ext_strips as jext_strips
from dlwp_cs_tpu_torch.ops.conv_variants import (
    cs_conv3x3_dx_ring,
    cs_conv3x3_dx_ring_plain,
    cs_conv3x3_im2col,
    cs_conv3x3_im2col_plain,
    cs_conv3x3_kernel_only,
    cs_conv3x3_npack,
    cs_conv3x3_npack_plain,
    im2col_taps,
    mma_plan,
    npack_taps,
)
from dlwp_cs_tpu_torch.ops.halo import ext_strips
from dlwp_cs_tpu_torch.ops.hopper_conv import (
    _padded_faces,
    cs_conv3x3_dw_plain,
    cs_conv3x3_dx_plain,
    cs_conv3x3_plain,
)
from dlwp_cs_tpu_torch.tools import probes

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

TOOLS = Path(__file__).resolve().parents[1] / "tools"
N, B = 8, 2
CHANNELS = [(8, 8), (12, 16)]
DTYPES = ["float32", "bfloat16"]
VMEM = pl.BlockSpec(memory_space=pltpu.VMEM)


def _tool_kernel(filename, name, **globals_):
    """The function ``name`` defined anywhere in ``tools/<filename>``, taken
    out with ``ast`` and defined in a namespace of JAX, Pallas and
    ``globals_`` (the script's globals or enclosing variables it reads)."""
    path = TOOLS / filename
    for node in ast.walk(ast.parse(path.read_text())):
        if isinstance(node, ast.FunctionDef) and node.name == name:
            ns = dict(jax=jax, jnp=jnp, lax=lax, pl=pl, **globals_)
            exec(compile(ast.Module(body=[node], type_ignores=[]), str(path), "exec"), ns)
            return ns[name]
    raise LookupError(f"{name} not in {path}")


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _jdt(dtype):
    return jnp.float32 if dtype == "float32" else jnp.bfloat16


def _close(ours, ref, dtype):
    ours = ours.float().numpy() if isinstance(ours, torch.Tensor) else np.asarray(ours)
    ref = np.asarray(jnp.asarray(ref).astype(jnp.float32))
    assert ours.shape == ref.shape
    if dtype == "float32":
        np.testing.assert_allclose(ours, ref, rtol=0, atol=1e-5)
    else:
        diff = np.abs(ours - ref)
        assert (diff <= np.abs(ref) * 2.0**-7 + 1e-4).all(), diff.max()


def _conv_inputs(cin, cout, seed=0):
    x = _rand((B, 6, N, N, cin), seed)
    ks = [_rand((3, 3, cin, cout), seed + s, (9 * cin) ** -0.5) for s in (1, 2)]
    bs = [_rand((cout,), seed + s, 0.1) for s in (3, 4)]
    return x, ks, bs


def _face_call(kernel, x, ext, weights, biases, cout, scratch):
    """The tools' ``pallas_call`` of a conv kernel: grid (B, 6), one face
    and its strips per step, weights and (1, Cout) biases whole."""
    b, _, n, _, cin = x.shape
    return pl.pallas_call(
        functools.partial(kernel, n=n),
        grid=(b, 6),
        in_specs=[
            pl.BlockSpec((1, 1, n, n, cin), lambda i, f: (i, f, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 4, n + 2, cin), lambda i, f: (i, f, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            VMEM, VMEM, VMEM, VMEM,
        ],
        out_specs=pl.BlockSpec((1, 1, n, n, cout), lambda i, f: (i, f, 0, 0, 0),
                               memory_space=pltpu.VMEM),
        out_shape=jax.ShapeDtypeStruct((b, 6, n, n, cout), x.dtype),
        scratch_shapes=[pltpu.VMEM(s, x.dtype) for s in scratch],
        interpret=True,
    )(x, ext, *weights, *(bb.reshape(1, -1) for bb in biases))


def _port(dtype, *arrays):
    return [torch.from_numpy(a).to(getattr(torch, dtype)) for a in arrays]


# ---- #3 kn2row, #13 im2col, #12 the conv kernel on given strips -----------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_npack_matches_tpu_kernel(dtype, cin, cout):
    """Kernel #3's plain version against ``pallas_conv._kernel_npack``
    launched as ``tools/kernel_variants.py::call_kernel`` launches it, on
    the tap-packed weights (Cin, 9*Cout); the wrapper on CPU tensors is the
    plain version and counts no launch."""
    x, ks, bs = _conv_inputs(cin, cout)
    jdt = _jdt(dtype)
    jx = jnp.asarray(x, jdt)
    taps = [jnp.asarray(k, jdt).transpose(2, 0, 1, 3).reshape(cin, 9 * cout) for k in ks]
    ref = _face_call(pc._kernel_npack, jx, jext_strips(jx), taps,
                     [jnp.asarray(b, jdt) for b in bs], cout, [(N + 2, N + 2, cin)])
    tx, *tw = _port(dtype, x, *ks, *bs)
    te = ext_strips(tx)
    ptaps = [npack_taps(k) for k in tw[:2]]
    np.testing.assert_array_equal(ptaps[0].float().numpy(),
                                  np.asarray(taps[0].astype(jnp.float32)))
    ours = cs_conv3x3_npack_plain(tx, te, *ptaps, *tw[2:])
    _close(ours, ref, dtype)
    before = cs_conv3x3_npack.launches
    torch.testing.assert_close(cs_conv3x3_npack(tx, te, *ptaps, *tw[2:]), ours, rtol=0, atol=0)
    assert cs_conv3x3_npack.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_im2col_matches_tpu_kernel(dtype, cin, cout):
    """Kernel #13's plain version against ``_kernel_im2col`` (taken out of
    ``tools/kernel_variants.py``) launched as ``call_im2col`` launches it,
    on the unpacked layout: weights (9*Cin, Cout), scratches for the padded
    face and the (n, n, 9*Cin) column tile."""
    kernel = _tool_kernel("kernel_variants.py", "_kernel_im2col")
    x, ks, bs = _conv_inputs(cin, cout, seed=10)
    jdt = _jdt(dtype)
    jx = jnp.asarray(x, jdt)
    wm = [jnp.asarray(k, jdt).reshape(9 * cin, cout) for k in ks]
    ref = _face_call(kernel, jx, jext_strips(jx), wm, [jnp.asarray(b, jdt) for b in bs], cout,
                     [(N + 2, N + 2, cin), (N, N, 9 * cin)])
    tx, *tw = _port(dtype, x, *ks, *bs)
    te = ext_strips(tx)
    pw = [im2col_taps(k) for k in tw[:2]]
    ours = cs_conv3x3_im2col_plain(tx, te, *pw, *tw[2:])
    _close(ours, ref, dtype)
    before = cs_conv3x3_im2col.launches
    torch.testing.assert_close(cs_conv3x3_im2col(tx, te, *pw, *tw[2:]), ours, rtol=0, atol=0)
    assert cs_conv3x3_im2col.launches == before


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_kernel_only_matches_tpu_kernel(dtype, cin, cout):
    """Kernel #12 (``tools/conv_micro.py::_kernel_only``: ``pallas_conv._kernel``
    on strips computed outside it) against the port's #12 on the port's own
    strips: its plain version is the conv's."""
    x, ks, bs = _conv_inputs(cin, cout, seed=20)
    jdt = _jdt(dtype)
    jx = jnp.asarray(x, jdt)
    jext = jext_strips(jx)
    ref = _face_call(pc._kernel, jx, jext, [jnp.asarray(k, jdt) for k in ks],
                     [jnp.asarray(b, jdt) for b in bs], cout, [(N + 2, N + 2, cin)])
    tx, *tw = _port(dtype, x, *ks, *bs)
    te = ext_strips(tx)
    np.testing.assert_array_equal(te.float().numpy(), np.asarray(jext.astype(jnp.float32)))
    before = cs_conv3x3_kernel_only.launches
    ours = cs_conv3x3_kernel_only(tx, te, *tw)
    assert cs_conv3x3_kernel_only.launches == before
    torch.testing.assert_close(ours, cs_conv3x3_plain(tx, te, *tw), rtol=0, atol=0)
    _close(ours, ref, dtype)


def test_formulations_agree_in_float64():
    """kn2row, im2col and the 9-tap conv are one linear map: in float64 the
    plain versions agree to rounding (and keep float64)."""
    x, ks, bs = _conv_inputs(12, 16, seed=30)
    tx, *tw = (torch.from_numpy(a).double() for a in (x, *ks, *bs))
    te = ext_strips(tx)
    base = cs_conv3x3_plain(tx, te, *tw)
    npk = cs_conv3x3_npack_plain(tx, te, *(npack_taps(k) for k in tw[:2]), *tw[2:])
    im = cs_conv3x3_im2col_plain(tx, te, *(im2col_taps(k) for k in tw[:2]), *tw[2:])
    assert base.dtype == npk.dtype == im.dtype == torch.float64
    torch.testing.assert_close(npk, base, rtol=0, atol=1e-12)
    torch.testing.assert_close(im, base, rtol=0, atol=1e-12)


@pytest.mark.parametrize("kind", ["npack", "im2col"])
def test_mma_plan_fits_the_flagship_shapes(kind):
    """Every flagship conv and its levels at batch 16 get a row tile that
    fits one block (im2col also the packed layout's 128 channels at n = 48,
    where kn2row's product does not fit); at batch 1 the grid spreads over
    the 132 SMs."""
    shapes = [(1, 48, 12, 32), (1, 48, 32, 32), (1, 24, 32, 64), (1, 24, 64, 64),
              (1, 12, 64, 128), (1, 12, 128, 128), (1, 24, 192, 64), (1, 48, 96, 32),
              (16, 48, 32, 32), (16, 24, 64, 64), (16, 12, 128, 128), (16, 48, 96, 32)]
    if kind == "im2col":
        shapes.append((4, 48, 128, 128))
    else:
        with pytest.raises(ValueError, match="shared memory"):
            mma_plan(kind, 4, 48, 128, 128, 132)
    for b, n, cin, cout in shapes:
        h = mma_plan(kind, b, n, cin, cout, 132)
        assert 1 <= h <= 8
        if b == 1:
            assert -(-n // h) * 6 >= min(2 * 132, n * 6)
    with pytest.raises(ValueError, match="shared memory"):
        mma_plan(kind, 1, 48, 1024, 256, 132)


# ---- #14 the input cotangent with the raw ring ------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("cin,cout", CHANNELS)
def test_dx_ring_matches_tpu_kernel(dtype, cin, cout):
    """Kernel #14's plain version against ``_dx_aligned_kernel`` (taken out
    of ``tools/kernel_variants.py``) launched as ``dx_aligned`` launches it,
    with ``kT = k.swapaxes(2, 3)``: the interior dx and the raw ring; the
    interior is #4's dx and the ring agrees with #4's d_ext where both
    define it."""
    kernel = _tool_kernel("kernel_variants.py", "_dx_aligned_kernel")
    _, ks, _ = _conv_inputs(cin, cout, seed=40)
    g = _rand((B, 6, N, N, cout), 41)
    jdt = _jdt(dtype)
    kts = [jnp.asarray(k, jdt).swapaxes(2, 3) for k in ks]
    din, dring = pl.pallas_call(
        kernel,
        grid=(B, 6),
        in_specs=[pl.BlockSpec((1, 1, N, N, cout), lambda i, f: (i, f, 0, 0, 0),
                               memory_space=pltpu.VMEM), VMEM, VMEM],
        out_specs=(
            pl.BlockSpec((1, 1, N, N, cin), lambda i, f: (i, f, 0, 0, 0),
                         memory_space=pltpu.VMEM),
            pl.BlockSpec((1, 1, 4, N + 2, cin), lambda i, f: (i, f, 0, 0, 0),
                         memory_space=pltpu.VMEM),
        ),
        out_shape=(jax.ShapeDtypeStruct((B, 6, N, N, cin), jdt),
                   jax.ShapeDtypeStruct((B, 6, 4, N + 2, cin), jdt)),
        scratch_shapes=[pltpu.VMEM((N + 4, N + 4, cout), jdt)],
        interpret=True,
    )(jnp.asarray(g, jdt), *kts)
    tg, tk_eq, tk_po = _port(dtype, g, *ks)
    dx, ring = cs_conv3x3_dx_ring_plain(tg, tk_eq, tk_po)
    _close(dx, din, dtype)
    _close(ring, dring, dtype)
    before = cs_conv3x3_dx_ring.launches
    wdx, wring = cs_conv3x3_dx_ring(tg, tk_eq, tk_po)
    assert cs_conv3x3_dx_ring.launches == before
    assert torch.equal(wdx, dx) and torch.equal(wring, ring)
    dx4, d_ext = cs_conv3x3_dx_plain(tg, tk_eq, tk_po)
    assert torch.equal(dx, dx4)
    assert torch.equal(ring[:, :, :2], d_ext[:, :, :2])
    assert torch.equal(ring[:, :, 2:, 1 : N + 1], d_ext[:, :, 2:, 1 : N + 1])


# ---- #15 the lane-offset store ----------------------------------------------

@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("c", [8, 12])
def test_lane_store_matches_tpu_kernel(dtype, c):
    """Kernel #15's plain version against ``_store_kernel`` (taken out of
    ``tools/kernel_variants.py``, its channel count C bound to this test's)
    launched as ``lane_store`` launches it: both are 3·x exactly."""
    kernel = _tool_kernel("kernel_variants.py", "_store_kernel", C=c)
    x = _rand((B, 6, N, N, c), 50)
    jdt = _jdt(dtype)
    spec = pl.BlockSpec((1, 1, N, N, c), lambda i, f: (i, f, 0, 0, 0), memory_space=pltpu.VMEM)
    ref = pl.pallas_call(kernel, grid=(B, 6), in_specs=[spec], out_specs=spec,
                         out_shape=jax.ShapeDtypeStruct(x.shape, jdt),
                         scratch_shapes=[pltpu.VMEM((N, N, 3 * c), jdt)],
                         interpret=True)(jnp.asarray(x, jdt))
    (tx,) = _port(dtype, x)
    before = probes.lane_store.launches
    ours = probes.lane_store(tx)
    assert probes.lane_store.launches == before
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))
    assert torch.equal(ours, 3 * tx)


# ---- #16 the lowering probes ------------------------------------------------

PN, PC, PD = 8, 8, 16  # the probes' N, C, D at this test's size


def _probe_call(kernel, out_shape, *args, scratch=(), grid=None, out_spec=None):
    kw = {} if grid is None else {"grid": grid}
    return pl.pallas_call(
        kernel, out_shape=out_shape, in_specs=[VMEM] * len(args),
        out_specs=out_spec or VMEM, scratch_shapes=list(scratch), interpret=True, **kw,
    )(*args)


@pytest.mark.parametrize("dtype", DTYPES)
def test_assembly_probe_matches_tpu_kernel(dtype):
    """kA: the padded face assembled with both ghost rows, then both ghost
    columns (which overwrite the corners); out = xpad[1:N+1, 2:N+2]."""
    jdt = _jdt(dtype)
    kernel = _tool_kernel("mosaic_bisect.py", "kA", N=PN)
    x, e = _rand((PN, PN, PC), 60), _rand((4, PN + 2, PC), 61)
    ref = _probe_call(kernel, jax.ShapeDtypeStruct((PN, PN, PC), jdt), jnp.asarray(x, jdt),
                      jnp.asarray(e, jdt), scratch=[pltpu.VMEM((PN + 2, PN + 2, PC), jdt)])
    tx, te = _port(dtype, x, e)
    ours = probes.probe_assemble(tx, te)
    np.testing.assert_array_equal(ours.float().numpy(), np.asarray(ref.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_select_and_bias_probes_match_tpu_kernels(dtype):
    """kB (tap (1, 1) selected by program id on a grid of 2: both ids are
    below 4) and kE (a (D,) bias added in f32, rounded once): exact."""
    jdt = _jdt(dtype)
    kb = _tool_kernel("mosaic_bisect.py", "kB")
    ke = _tool_kernel("mosaic_bisect.py", "kE", dt=jdt)
    k1, k2 = _rand((3, 3, PC, PD), 62), _rand((3, 3, PC, PD), 63)
    ref_b = _probe_call(kb, jax.ShapeDtypeStruct((2, PC, PD), jdt), jnp.asarray(k1, jdt),
                        jnp.asarray(k2, jdt), grid=(2,),
                        out_spec=pl.BlockSpec((1, PC, PD), lambda i: (i, 0, 0),
                                              memory_space=pltpu.VMEM))
    xe, b = _rand((PN, PN, PD), 64), _rand((1, PD), 65)
    ref_e = _probe_call(ke, jax.ShapeDtypeStruct((PN, PN, PD), jdt), jnp.asarray(xe, jdt),
                        jnp.asarray(b, jdt))
    tk1, tk2, txe, tb = _port(dtype, k1, k2, xe, b)
    np.testing.assert_array_equal(probes.probe_select(tk1, tk2).float().numpy(),
                                  np.asarray(ref_b.astype(jnp.float32)))
    np.testing.assert_array_equal(probes.probe_bias(txe, tb[0]).float().numpy(),
                                  np.asarray(ref_e.astype(jnp.float32)))


@pytest.mark.parametrize("dtype", DTYPES)
def test_dot_probes_match_tpu_kernels(dtype):
    """kC (one (N, N, C) x (C, D) product) and kD (9 shifted products of
    the scratch holding x in its interior): f32 sums, one rounding.  kD's
    reference leaves its scratch's frame unwritten (NaN in interpret mode),
    so its border pixels are NaN there; the port's frame is zero."""
    jdt = _jdt(dtype)
    kc = _tool_kernel("mosaic_bisect.py", "kC", dt=jdt)
    kd = _tool_kernel("mosaic_bisect.py", "kD", N=PN, D=PD, dt=jdt)
    x = _rand((PN, PN, PC), 66)
    k2, k4 = _rand((PC, PD), 67, PC**-0.5), _rand((3, 3, PC, PD), 68, (9 * PC) ** -0.5)
    out = jax.ShapeDtypeStruct((PN, PN, PD), jdt)
    ref_c = _probe_call(kc, out, jnp.asarray(x, jdt), jnp.asarray(k2, jdt))
    ref_d = _probe_call(kd, out, jnp.asarray(x, jdt), jnp.asarray(k4, jdt),
                        scratch=[pltpu.VMEM((PN + 2, PN + 2, PC), jdt)])
    tx, tk2, tk4 = _port(dtype, x, k2, k4)
    _close(probes.probe_dot(tx, tk2), ref_c, dtype)
    ours_d = probes.probe_shifted_dots(tx, tk4)
    ref_d = np.asarray(ref_d.astype(jnp.float32))
    border = np.ones((PN, PN), bool)
    border[1:-1, 1:-1] = False
    assert np.isnan(ref_d[border]).all() and not np.isnan(ref_d[~border]).any()
    _close(ours_d[1:-1, 1:-1], ref_d[1:-1, 1:-1], dtype)
    # the border: the same 9 products of the zero-framed face
    pad = np.pad(tx.float().numpy(), ((1, 1), (1, 1), (0, 0)))
    want = sum(pad[dy : dy + PN, dx : dx + PN] @ tk4[dy, dx].float().numpy()
               for dy in range(3) for dx in range(3))
    _close(ours_d[border], torch.from_numpy(want[border]).to(tx.dtype).float().numpy(), dtype)


# tools/mosaic_bisect2.py's four bodies, written out (the script passes them
# to ``mk`` as one-line lambdas)
_BISECT2_BODIES = {
    "rows-int-idx": lambda e, xpad: (xpad.__setitem__((0, slice(None), slice(None)), e[0]),
                                     xpad.__setitem__((PN + 1, slice(None), slice(None)), e[1])),
    "rows-slice-idx": lambda e, xpad: (xpad.__setitem__((slice(0, 1),), e[0:1]),
                                       xpad.__setitem__((slice(PN + 1, PN + 2),), e[1:2])),
    "col-int-idx": lambda e, xpad: xpad.__setitem__((slice(None), 0, slice(None)), e[2]),
    "col-newaxis": lambda e, xpad: xpad.__setitem__((slice(None), slice(0, 1), slice(None)),
                                                    e[2][:, None, :]),
}


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("name", sorted(_BISECT2_BODIES))
def test_ghost_write_probes_match_tpu_kernels(dtype, name):
    """bisect2's ``mk`` kernel with each body: the interior, then only the
    S/N ghost rows or only the W column; out = xpad[1:N+1, 2:N+2].  The
    padded E column is never written: NaN in the reference's interpret
    mode, zero in the port's scratch; the rest equal."""
    jdt = _jdt(dtype)
    body = _BISECT2_BODIES[name]

    def kernel(x_ref, e_ref, o_ref, xpad):  # tools/mosaic_bisect2.py::mk's kernel
        xpad[1 : PN + 1, 1 : PN + 1, :] = x_ref[:]
        body(e_ref, xpad)
        o_ref[:] = xpad[1 : PN + 1, 2 : PN + 2, :]

    x, e = _rand((PN, PN, PC), 70), _rand((4, PN + 2, PC), 71)
    ref = _probe_call(kernel, jax.ShapeDtypeStruct((PN, PN, PC), jdt), jnp.asarray(x, jdt),
                      jnp.asarray(e, jdt), scratch=[pltpu.VMEM((PN + 2, PN + 2, PC), jdt)])
    ref = np.asarray(ref.astype(jnp.float32))
    tx, te = _port(dtype, x, e)
    ours = probes.PROBES[name](tx, te).float().numpy()
    assert np.isnan(ref[:, -1]).all() and not np.isnan(ref[:, :-1]).any()
    np.testing.assert_array_equal(ours[:, :-1], ref[:, :-1])
    assert not ours[:, -1].any()


@pytest.mark.parametrize("dtype", DTYPES)
@pytest.mark.parametrize("n,c,d", [(8, 8, 16), (4, 16, 16)])
def test_dw_probes_match_tpu_kernels(dtype, n, c, d):
    """bisect3's k1 (x.reshape(n², C)ᵀ · g.reshape(n², D)) and k2 (a
    product batched over the columns, then summed over them), f32 out."""
    jdt = _jdt(dtype)
    ks = [_tool_kernel("mosaic_bisect3.py", k, n=n, C=c, D=d) for k in ("k1", "k2")]
    x, g = _rand((n, n, c), 72), _rand((n, n, d), 73)
    tx, tg = _port(dtype, x, g)
    for kernel, probe in zip(ks, (probes.probe_dw_reshape, probes.probe_dw_batched)):
        ref = _probe_call(kernel, jax.ShapeDtypeStruct((c, d), jnp.float32),
                          jnp.asarray(x, jdt), jnp.asarray(g, jdt))
        ours = probe(tx, tg)
        assert ours.dtype == torch.float32
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=0, atol=1e-5)


def test_probe_wrappers_run_their_plain_versions_on_cpu():
    """On a CPU tensor every probe is its plain version and counts no
    launch; the probe tool checks each against it."""
    from dlwp_cs_tpu_torch.tools import mosaic_bisect

    before = {k.name: k.launches for k in (*probes.PROBES.values(), probes.lane_store)}
    rows = mosaic_bisect.run("cpu", torch.float32, small=True)
    assert [r["ms"] for r in rows] == [None] * len(rows)
    assert {r["probe"] for r in rows} == {k.name for k in probes.PROBES.values()}
    after = {k.name: k.launches for k in (*probes.PROBES.values(), probes.lane_store)}
    assert after == before


@pytest.mark.parametrize("dtype", DTYPES)
def test_probe_library_calls_compute_the_probes(dtype):
    """The one PyTorch call timed beside each probe computes the probe's
    function: equal to the plain version for the copies, select and bias,
    within the probe tool's tolerance for the products; the dw products
    come out in the inputs' type, so in bfloat16 within one bf16 ulp."""
    from dlwp_cs_tpu_torch.tools import mosaic_bisect

    for name, probe, args in mosaic_bisect._cases("cpu", getattr(torch, dtype), True):
        call, as_probe = mosaic_bisect.library_call(probe, args)
        got, ref = as_probe(call()), probe.plain(*args)
        assert got.shape == ref.shape, name
        if probe in (probes.probe_dw_reshape, probes.probe_dw_batched) and dtype == "bfloat16":
            bound = ref.abs() * 2.0**-7 + 1e-5 * float(ref.abs().max())
            assert bool(((got - ref).abs() <= bound).all()), name
        else:
            assert mosaic_bisect.compare(name, got.to(ref.dtype), ref)[2], name


def test_tools_hold_every_kernel_row_against_its_plain_version():
    """kernel_variants checks each row that launches a kernel of the port
    against the same function through the kernel's plain version (and no
    cuDNN row); conv_micro checks #12 and #4 and reports #12's bytes and
    operations for its bound."""
    from dlwp_cs_tpu_torch.tools import conv_micro, kernel_variants

    rows = kernel_variants.run("cpu", small=True)
    kernel_rows = {"base", "npack", "im2col", "bdpack", "bdonly", "im2col_p", "im2colonly",
                   "dx_cur", "dx_align", "dec_base", "dec_pack2", "lane_store"}
    for name, r in rows.items():
        if name not in ("shape", "flops"):
            assert (r["plain_max_abs_err"] is not None) == (name in kernel_rows), name
    for r in conv_micro.run(conv_micro.LEVELS_SMALL, torch.bfloat16, "cpu"):
        assert r["kernel_max_abs_err"] == 0 and r["dx_max_abs_err"] == 0
        assert r["ops"] == r["flops"] and r["bytes"] > 0
        assert r["kernel_plain_ms"] is None and r["kernel_library_ms"] is None


def test_check_close_holds_one_bf16_ulp_or_1e_4():
    """The shared check: one bf16 ulp of |ref| + 1e-4 in bfloat16, 1e-4 in
    float32, over tuples too."""
    from dlwp_cs_tpu_torch.tools.timing import check_close

    ref = torch.tensor([1.0, -2.0, 0.0])
    assert check_close("f32", ref + 5e-5, ref) == pytest.approx(5e-5, rel=1e-3)
    with pytest.raises(RuntimeError, match="plain version"):
        check_close("f32", (ref, ref + 2e-4), (ref, ref))
    rb = ref.to(torch.bfloat16)
    assert check_close("bf16", rb * (1 + 2.0**-7), rb) == 2.0**-6
    with pytest.raises(RuntimeError, match="plain version"):
        check_close("bf16", rb * (1 + 2.0**-6), rb)


# ---- the plain versions' sum type (F1) --------------------------------------

def _old_conv_plain(x, ext, k_eq, k_pole, b_eq, b_pole):
    """cs_conv3x3_plain as it summed before the promoted sum type: .float()."""
    rows, cols, dt = x.shape[2], x.shape[3], x.dtype
    p = _padded_faces(x, ext).float()
    parts = []
    for k, bias, faces in ((k_eq, b_eq, slice(0, 4)), (k_pole, b_pole, slice(4, 6))):
        kf = k.to(dt).float()
        acc = sum(torch.einsum("bfijc,cd->bfijd", p[:, faces, dy : dy + rows, dx : dx + cols],
                               kf[dy, dx]) for dy in range(3) for dx in range(3))
        parts.append(acc + bias.to(dt).float())
    return torch.cat(parts, dim=1).to(dt)


def _old_dx_frame(dout, k_eq, k_pole):
    n, dt = dout.shape[2], dout.dtype
    q = torch.nn.functional.pad(dout.float(), (0, 0, 2, 2, 2, 2))
    parts = []
    for k, faces in ((k_eq, slice(0, 4)), (k_pole, slice(4, 6))):
        kf = k.to(dt).float()
        parts.append(sum(torch.einsum("bfijd,cd->bfijc",
                                      q[:, faces, 2 - dy : n + 4 - dy, 2 - dx : n + 4 - dx],
                                      kf[dy, dx]) for dy in range(3) for dx in range(3)))
    return torch.cat(parts, dim=1).to(dt)


def _old_dw(x, ext, dout):
    n = x.shape[2]
    p = _padded_faces(x, ext).float()
    d = dout.to(x.dtype).float()
    out = [torch.stack([torch.stack([
        torch.einsum("bfijc,bfijd->cd", p[:, f, dy : dy + n, dx : dx + n], d[:, f])
        for dx in range(3)]) for dy in range(3)]) for f in (slice(0, 4), slice(4, 6))]
    return out[0], out[1], d[:, :4].sum(dim=(0, 1, 2, 3)), d[:, 4:].sum(dim=(0, 1, 2, 3))


@pytest.mark.parametrize("dtype", DTYPES)
def test_plain_versions_are_bitwise_unchanged_in_f32_and_bf16(dtype):
    """The plain conv, dx and dw sum in promote_types(dtype, float32): for
    float32 and bfloat16 inputs that is float32, as before (bitwise)."""
    x, ks, bs = _conv_inputs(12, 16, seed=80)
    tx, *tw = _port(dtype, x, *ks, *bs)
    te = ext_strips(tx)
    g = _port(dtype, _rand((B, 6, N, N, 16), 81))[0]
    assert torch.equal(cs_conv3x3_plain(tx, te, *tw), _old_conv_plain(tx, te, *tw))
    dx, d_ext = cs_conv3x3_dx_plain(g, *tw[:2])
    frame = _old_dx_frame(g, *tw[:2])
    assert torch.equal(dx, frame[:, :, 1 : N + 1, 1 : N + 1])
    assert torch.equal(d_ext[:, :, :2], torch.stack([frame[:, :, 0], frame[:, :, N + 1]], 2))
    for new, old in zip(cs_conv3x3_dw_plain(tx, te, g), _old_dw(tx, te, g)):
        assert new.dtype == torch.float32 and torch.equal(new, old)


def test_plain_versions_sum_float64_in_float64():
    """A float64 input is summed and returned in float64 (the reference step
    of the f32 gradient check), within 1e-12 of a numpy float64 conv."""
    x, ks, bs = _conv_inputs(8, 8, seed=90)
    tx, *tw = (torch.from_numpy(a).double() for a in (x, *ks, *bs))
    te = ext_strips(tx)
    out = cs_conv3x3_plain(tx, te, *tw)
    assert out.dtype == torch.float64
    p = _padded_faces(tx, te).numpy()
    want = np.empty(out.shape)
    for faces, k, b in ((slice(0, 4), ks[0], bs[0]), (slice(4, 6), ks[1], bs[1])):
        want[:, faces] = sum(p[:, faces, dy : dy + N, dx : dx + N] @ k[dy, dx].astype(np.float64)
                             for dy in range(3) for dx in range(3)) + b
    np.testing.assert_allclose(out.numpy(), want, rtol=0, atol=1e-12)
    g = torch.from_numpy(_rand((B, 6, N, N, 8), 91)).double()
    assert all(t.dtype == torch.float64 for t in cs_conv3x3_dx_plain(g, *tw[:2]))
    assert all(t.dtype == torch.float64 for t in cs_conv3x3_dw_plain(tx, te, g))


# ---- the tools on the CPU ---------------------------------------------------

@pytest.mark.parametrize("tool,argv", [
    ("conv_micro", []), ("kernel_variants", []), ("kernel_variants", ["--chain"]),
    ("mosaic_bisect", []), ("mosaic_bisect", ["--dtype", "float32"]),
])
def test_tool_main_runs_on_cpu_small(tool, argv, capsys):
    """Each tool's main with ``--device cpu --small``: the plain versions,
    every check passing, no times."""
    import importlib

    mod = importlib.import_module(f"dlwp_cs_tpu_torch.tools.{tool}")
    assert mod.main(["--device", "cpu", "--small", *argv]) == 0
    out = capsys.readouterr().out
    assert "cpu (no times)" in out or "OK" in out
    assert "FAIL" not in out


@pytest.mark.parametrize("tool", ["conv_micro", "kernel_variants", "mosaic_bisect"])
def test_tool_main_needs_a_card_or_the_cpu_at_small_sizes(tool, monkeypatch):
    import importlib

    mod = importlib.import_module(f"dlwp_cs_tpu_torch.tools.{tool}")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA card"):
        mod.main([])
    with pytest.raises(ValueError, match="--small"):
        mod.main(["--device", "cpu"])
