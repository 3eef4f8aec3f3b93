"""The port's spatially decomposed serving path against the JAX package.

One group of 4 CPU ranks (gloo, meeting through a ``FileStore``) runs every
sharded case of this file once (:func:`_rank_cases`, spawned by the
``group`` fixture); the tests hold each rank's results against the JAX
package's ``shard_map`` code on the conftest's 8 virtual CPU devices, run as
its own tests run it (``interpret=True``, ``band_conv="pallas_interpret"``).
The spawned ranks import this module, so JAX is imported only inside the
fixtures and tests that the pytest process runs.

Inputs are seeded numpy at n = 8.  Tolerances:

* pads: exact copies and the same two-term corner means: 1e-6;
* float32 convs, pads-then-convs and the U-Net: sums in another order,
  3e-5 absolute on outputs of order 1 (the JAX tests' own 2e-5 to 3e-5);
* bfloat16 convs: one rounding of a f32 sum on each side, which may
  straddle a bf16 boundary, within 2**-6 of the largest output;
* the band-row exchange (kernel #10's plain version): equal, since it moves
  values;
* the forecast service: 1e-4 of the largest std on denormalized fields, as
  ``tests/test_torch_serve.py``;
* the sharded ConvLSTM (n = 16, as the reference's ``TestShardedConvLSTM``):
  5e-5 against the reference's single-device forward, its own tolerance.
"""

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.parallel.launch import spawn_group

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8
F32_TOL = 3e-5
BF16_REL = 2.0**-6
DATA = dict(grid_n=N, variables=("z500", "t2m"), constants=("topography",))
STATS = {"mean": [5400.0, 280.0], "std": [300.0, 20.0],
         "insol_mean": 300.0, "insol_std": 400.0}

# the port's meshes span the group's 4 ranks: the data dimension takes what
# the tiling leaves (a pad on 2 bands runs on a (2, 2) mesh)
PADS_1D = [(2, 1), (2, 2), (4, 1), (4, 2)]  # (S, width)
PADS_2D = [((2, 2), 1), ((2, 2), 2), ((1, 2), 1), ((1, 2), 2), ((2, 1), 1), ((2, 1), 2)]
MODELS = [  # (mesh (data, spatial, spatial_x), overlap, band_conv)
    ((1, 4, 1), True, "ringfix"), ((1, 4, 1), True, "pallas"), ((2, 2, 1), True, "pallas"),
    ((1, 4, 1), False, "ringfix"), ((1, 2, 2), True, "ringfix"), ((1, 2, 2), True, "pallas"),
]
# U-Net paths through the remote-copy kernels' plain versions: (mesh,
# band_impl, band_conv); (2, 2, 1) is 2 row bands on each data half
MODELS_REMOTE = [
    ((1, 4, 1), "rdma", "pallas"), ((2, 2, 1), "rdma", "pallas"),
    ((1, 4, 1), "ppermute", "overlap"), ((2, 2, 1), "ppermute", "overlap"),
    ((1, 4, 1), "rdma_interpret", "overlap_interpret"), ((1, 4, 1), "rdma", "ringfix"),
]
CTX_ERRORS = [  # (mesh, kwargs, exception, match); exception None: accepted
    ((1, 2, 2), dict(band_impl="rdma"), "ValueError", "band_impl"),
    ((1, 2, 2), dict(band_conv="overlap"), "ValueError", "not available on the 2-D"),
    ((1, 2, 2), dict(band_conv="palas"), "ValueError", "not available on the 2-D"),
    ((1, 4, 1), dict(overlap=False, band_conv="pallas"), "ValueError", "overlap=True"),
    # kernels #10 and #11, once rejected as not ported
    ((1, 4, 1), dict(band_conv="overlap"), None, None),
    ((1, 4, 1), dict(band_conv="overlap_interpret"), None, None),
    ((1, 4, 1), dict(band_conv="nope"), "ValueError", "unknown band_conv"),
    ((1, 4, 1), dict(band_impl="rdma"), None, None),
    ((1, 4, 1), dict(band_impl="rdma_interpret"), None, None),
    ((1, 4, 1), dict(band_impl="bogus"), "ValueError", "unknown band exchange"),
    ((1, 4, 1), dict(band_impl="zero"), "ValueError", "moves no band rows"),
    ((1, 4, 1), dict(band_impl="zero", overlap=False), "ValueError", "moves no band rows"),
    ((1, 4, 1), dict(band_impl="zero", band_conv="pallas"), "ValueError", "moves no band rows"),
    ((1, 2, 2), dict(band_impl="rdma_interpret", band_conv="pallas"), "ValueError", "band_impl"),
    ((1, 2, 2), dict(band_impl="rdma", band_conv="overlap"), "ValueError", "band_impl"),
    ((1, 2, 2), dict(band_conv="overlap_interpret", overlap=True), "ValueError",
     "not available on the 2-D"),
    ((1, 4, 1), dict(overlap=False, band_conv="overlap"), "ValueError", "overlap=True"),
    ((1, 4, 1), dict(overlap=False, band_conv="overlap_interpret", band_impl="rdma"),
     "ValueError", "overlap=True"),
    ((1, 4, 1), dict(band_impl="zero", band_conv="overlap"), "ValueError", "moves no band rows"),
    ((1, 4, 1), dict(band_impl="rdma", band_conv="overlap"), None, None),
]
XCHG_CASES = [(2, 1), (2, 2), (4, 1), (4, 2)]  # (S, width) of the band exchange, n = 16
DESCRIPTOR_MESHES = [(2, 2, 1), (1, 2, 2), (4, 1, 1)]  # the sharding descriptors' meshes
# the sharded ConvLSTM: (conv backend, mesh, band_conv); kernel #11's plain
# version ("overlap") runs on row bands only
LSTM_N = 16
LSTM_CASES = [(backend, shape, band_conv) for backend in ("xring", "ringfix")
              for shape, convs in (((1, 4, 1), ("ringfix", "pallas", "overlap")),
                                   ((2, 2, 1), ("ringfix", "pallas", "overlap")),
                                   ((1, 2, 2), ("ringfix", "pallas")))
              for band_conv in convs]


# the plain collectives against lax: each rank's input shape and seed, the
# gathers' (axis, tiled), a ppermute naming two receivers of the four
COLL_SHAPE, COLL_SEED = (2, 6, 3, 4, 5), 90
COLL_GATHERS = [(0, True), (3, True), (0, False), (3, False)]
COLL_PERM = [(0, 2), (2, 1)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _conv_inputs():
    x = _rand((2, 6, N, N, 3), 11)
    ks = [_rand((3, 3, 3, 5), s, 0.2) for s in (12, 13)]
    bs = [_rand((5,), s) for s in (14, 15)]
    return x, ks, bs


def _lstm_config(module, backend=None):
    """The reference test's ConvLSTM (``tests/test_convlstm.py``,
    ``TestShardedConvLSTM``) from ``module``'s ``ConvLSTMConfig``."""
    kw = {} if backend is None else {"conv_backend": backend}
    return module.ConvLSTMConfig(output_channels=4, filters=(4, 4), input_time_steps=2,
                                 variable_channels=2, add_insolation=True, **kw)


# ensembles under the mesh: members, amplitude, the seed of the front end's
# dispatch and of the reference's perturbations
ENS_MEMBERS, ENS_AMP, ENS_SEED, ENS_KEY = 3, 0.05, 5, 11


def _service_inputs():
    rng = np.random.default_rng(0)
    const = rng.normal(size=(6, N, N, 1)).astype(np.float32)
    mean, std = np.asarray(STATS["mean"], np.float32), np.asarray(STATS["std"], np.float32)
    windows = (rng.normal(size=(3, 2, 6, N, N, 2)) * std + mean).astype(np.float32)
    return const, windows, np.asarray([9668.5, 9700.25, 9701.0])


def _caught(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads type and message
        return type(e).__name__, str(e)
    return None


# ---- what each rank runs ---------------------------------------------------

def _rank_cases(params, lstm_params, ens_pert):
    import torch.distributed as dist

    from dlwp_cs_tpu_torch import models
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator
    from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, UNetConfig
    from dlwp_cs_tpu_torch.parallel import create_mesh, make_spatial_apply
    from dlwp_cs_tpu_torch.parallel.collectives import all_gather, axis_index, ppermute, psum
    from dlwp_cs_tpu_torch.parallel.halo import halo_pieces, sharded_cs_pad, use_band_exchange
    from dlwp_cs_tpu_torch.parallel.halo2d import sharded_cs_pad_2d
    from dlwp_cs_tpu_torch.parallel.hopper_band import band_conv3x3
    from dlwp_cs_tpu_torch.parallel.hopper_tile import make_tile_pallas_conv3x3, tile_conv3x3
    from dlwp_cs_tpu_torch.parallel.mesh import gather_blocks, local_block
    from dlwp_cs_tpu_torch.parallel.overlap import sharded_ringfix_conv3x3
    from dlwp_cs_tpu_torch.parallel.overlap_band import band_conv3x3_overlap
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_rdma
    from dlwp_cs_tpu_torch.parallel.sharding import sharded_model_ctx
    from dlwp_cs_tpu_torch.serve import ForecastService

    torch.set_num_threads(1)  # 4 ranks share the host's cores
    meshes = {}

    def mesh(shape):  # every rank creates the meshes in the same order
        if shape not in meshes:
            d, sy, sx = shape
            meshes[shape] = create_mesh(data=d, spatial=sy, spatial_x=sx, device="cpu")
        return meshes[shape]

    def coords(m):
        return tuple(axis_index(m, a) for a in ("data", "spatial", "spatial_x"))

    out = {"rank": dist.get_rank()}
    x = torch.from_numpy(_rand((2, 6, N, N, 3), 1))
    for s, w in PADS_1D:
        m = mesh((4 // s, s, 1))
        band = local_block(x, m)
        out["pad1d", s, w] = (coords(m), sharded_cs_pad(band, w, mesh=m).numpy())
    m = mesh((1, 4, 1))
    out["pieces"] = (coords(m), [p.numpy() for p in halo_pieces(local_block(x, m), 1, mesh=m)])
    with use_band_exchange("zero"):
        out["pad1d_zero"] = sharded_cs_pad(local_block(x, m), 1, mesh=m).numpy()
    for (sy, sx), w in PADS_2D:
        m = mesh((4 // (sy * sx), sy, sx))
        out["pad2d", sy, sx, w] = (coords(m), sharded_cs_pad_2d(local_block(x, m), w, mesh=m).numpy())

    xc, ks, bs = _conv_inputs()
    for dt in (torch.float32, torch.bfloat16):
        args = [torch.from_numpy(a).to(dt) for a in (*ks, *bs)]
        m = mesh((1, 4, 1))
        band = local_block(torch.from_numpy(xc).to(dt), m)
        out["ringfix", dt] = gather_blocks(
            sharded_ringfix_conv3x3(band, *args, mesh=m), m).float().numpy()
        out["band", dt] = gather_blocks(band_conv3x3(band, *args, mesh=m), m).float().numpy()
        m = mesh((1, 2, 2))
        tile = local_block(torch.from_numpy(xc).to(dt), m)
        out["tile", dt] = gather_blocks(tile_conv3x3(tile, *args, mesh=m), m).float().numpy()
    for s in (2, 4):  # kernel #11's plain version on 2 and 4 bands
        m = mesh((4 // s, s, 1))
        for dt in (torch.float32, torch.bfloat16):
            args = [torch.from_numpy(a).to(dt) for a in (*ks, *bs)]
            band = local_block(torch.from_numpy(xc).to(dt), m)
            out["overlap", s, dt] = gather_blocks(
                band_conv3x3_overlap(band, *args, mesh=m), m).float().numpy()
    x16 = torch.from_numpy(_rand((2, 6, 16, 16, 3), 21))
    for s, w in XCHG_CASES:  # kernel #10's plain version
        m = mesh((4 // s, s, 1))
        out["rdma", s, w] = (coords(m), [t.numpy() for t in band_exchange_rdma(
            local_block(x16, m), w, mesh=m)])
    # tiles of 8 rows x 4 columns (h > wl) leave the kernel for pad-then-VALID
    m = mesh((2, 1, 2))
    tall = local_block(torch.from_numpy(xc), m)
    conv = make_tile_pallas_conv3x3(m)
    out["tile_tall"] = gather_blocks(conv(tall, *map(torch.from_numpy, (*ks, *bs))), m).numpy()

    cfg = ExperimentConfig(data=DataConfig(**DATA), model=UNetConfig(filters=(4, 8)))
    est = DLWPEstimator(cfg, device="cpu").load_state(STATS, params)
    xu = torch.from_numpy(_rand((4, 6, N, N, cfg.data.input_channels), 61))
    for shape, overlap, band_conv in MODELS:
        fn = make_spatial_apply(est.model, mesh(shape), overlap=overlap, band_conv=band_conv)
        out["unet", shape, overlap, band_conv] = fn(xu).numpy()
    for shape, band_impl, band_conv in MODELS_REMOTE:
        fn = make_spatial_apply(est.model, mesh(shape), band_impl=band_impl, band_conv=band_conv)
        out["unet_remote", shape, band_impl, band_conv] = fn(xu).numpy()

    xl = torch.from_numpy(_rand((2, 6, LSTM_N, LSTM_N, 7), 71))
    nets = {}
    for backend, shape, band_conv in LSTM_CASES:
        if backend not in nets:
            nets[backend] = models.load_jax_params(models.CubeSphereConvLSTMNet(
                _lstm_config(models, backend), 7, device="cpu"), lstm_params)
        fn = make_spatial_apply(nets[backend], mesh(shape), band_conv=band_conv)
        out["lstm", backend, shape, band_conv] = fn(xl).numpy()

    const, windows, t0 = _service_inputs()
    svc = ForecastService(est, constants=const, mesh=mesh((2, 2, 1)), max_wait_ms=500.0)
    fc = svc.forecast(windows, t0, steps=2)
    out["service"] = (fc.fields, np.asarray(fc.init_times), svc.stats.padded_mesh,
                      svc.stats.requests)
    # ensembles under the mesh, collective calls: one window, 3 members on
    # data = 2 (padded by one window), with the reference's perturbations;
    # then with a seeded generator, as the front end's dispatch draws them
    ens = svc.forecast_ensemble(windows[0], t0[0], steps=2, members=ENS_MEMBERS,
                                amplitude=ENS_AMP, perturbations=ens_pert, keep_members=True)
    out["ensemble"] = (ens.mean, ens.spread, ens.members, np.asarray(ens.init_times),
                       svc.stats.padded_mesh)
    seeded = svc.forecast_ensemble(windows[1], t0[1], steps=2, members=ENS_MEMBERS,
                                   amplitude=ENS_AMP, keep_members=True,
                                   generator=torch.Generator().manual_seed(ENS_SEED))
    out["ensemble_seeded"] = (seeded.mean, seeded.spread, seeded.members)
    # the rank-0 front end: rank 0 submits, the others follow
    if dist.get_rank() == 0:
        batches = svc.stats.batches
        futs = [svc.submit(windows[i], t0[i], steps=2) for i in range(3)]
        fcs = [f.result(timeout=300) for f in futs]
        dispatches = svc.stats.batches - batches
        efc = svc.submit_ensemble(windows[1], t0[1], steps=2, members=ENS_MEMBERS,
                                  amplitude=ENS_AMP, seed=ENS_SEED,
                                  keep_members=True).result(timeout=300)
        leading = _caught(lambda: svc.forecast(windows, t0, steps=1))
        svc.close()
        out["front"] = {"fields": [f.fields for f in fcs],
                        "init_times": [np.asarray(f.init_times) for f in fcs],
                        "dispatches": dispatches, "leading": leading,
                        "ensemble": (efc.mean, efc.spread, efc.members)}
    else:
        wrong_rank = _caught(lambda: svc.submit(windows[0], t0[0], steps=1))
        runs = svc.follow()
        svc.close()  # a no-op once follow() has returned
        out["front"] = {"runs": runs, "wrong_rank": wrong_rank,
                        "errors": [repr(e) for e in svc.follow_errors]}
    out["front_stats"] = (svc.stats.requests, svc.stats.batches, svc.stats.padded_members,
                          svc.stats.padded_mesh)
    out["closed_submit"] = _caught(lambda: svc.submit(windows[0], t0[0], steps=1))

    for i, (shape, kwargs, _, _) in enumerate(CTX_ERRORS):
        out["ctx_error", i] = _caught(lambda: sharded_model_ctx(mesh(shape), **kwargs)())
    m = mesh((1, 4, 1))
    band = local_block(x, m)
    out["bad_width"] = _caught(lambda: sharded_cs_pad(band, 3, mesh=m))
    out["bad_batch"] = _caught(lambda: local_block(x[:1], mesh((2, 2, 1))))
    grad = band.clone().requires_grad_(True)
    out["grad"] = _caught(lambda: sharded_cs_pad(grad, 1, mesh=m))
    # the sharding descriptors (item 17e): shard_batch and prefetch_to_device
    # cut by their spec what local_block cuts from the mesh
    from dlwp_cs_tpu_torch.data import prefetch_to_device
    from dlwp_cs_tpu_torch.parallel import (
        batch_sharding,
        batch_spatial_sharding,
        replicated,
        shard_batch,
        stacked_batch_sharding,
    )

    xb = torch.from_numpy(_rand((4, 6, N, N, 3), 5))
    stacked = torch.stack([xb, 2 * xb, 3 * xb])  # (k, B, 6, n, n, C)
    for shape in DESCRIPTOR_MESHES:
        dm = mesh(shape)
        fed = list(prefetch_to_device(iter([(xb, 2 * xb)]), device="cpu",
                                      sharding=batch_sharding(dm)))
        out["descriptors", shape] = {
            "spatial": (shard_batch(xb, batch_spatial_sharding(dm)), local_block(xb, dm)),
            "batch": (shard_batch((xb,), batch_sharding(dm))[0],
                      local_block(xb, dm, spatial=False)),
            "prefetch": ([t for item in fed for t in item],
                         [local_block(xb, dm, spatial=False),
                          local_block(2 * xb, dm, spatial=False)]),
            "stacked": (shard_batch(stacked, stacked_batch_sharding(dm)),
                        torch.stack([local_block(t, dm, spatial=False) for t in stacked])),
            "replicated": (shard_batch(xb, replicated(dm)), xb),
        }
    me = float(dist.get_rank())
    t = torch.full((2,), me)
    out["collectives"] = (
        all_gather(t, m, "spatial").numpy(),
        psum(t, mesh((1, 2, 2)), ("spatial", "spatial_x")).numpy(),
        ppermute(t, m, "spatial", [(0, 3), (3, 0)]).numpy(),
    )
    # the plain transport (a CPU tensor's) on seeded draws, one per rank:
    # psum in rank order, tiled and stacked gathers, a ppermute that leaves
    # two receivers unnamed, a psum over (spatial, spatial_x)
    plain = {}
    for dt in (torch.float32, torch.bfloat16):
        xs = torch.from_numpy(_rand(COLL_SHAPE, COLL_SEED + dist.get_rank())).to(dt)
        plain["psum", dt] = psum(xs, m, "spatial")
        plain["psum_joint", dt] = psum(xs, mesh((1, 2, 2)), ("spatial", "spatial_x"))
        for axis, tiled in COLL_GATHERS:
            plain["gather", axis, tiled, dt] = all_gather(xs, m, "spatial", axis=axis, tiled=tiled)
        plain["ppermute", dt] = ppermute(xs, m, "spatial", COLL_PERM)
    out["collectives_plain"] = {k: v.float().numpy() for k, v in plain.items()}
    return out


@pytest.fixture(scope="module")
def jax_model():
    """The reference estimator (filters (4, 8)) with seeded parameters; its
    U-Net serves both the model and the service tests."""
    import types

    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.estimator import DLWPEstimator as JEstimator
    from dlwp_cs_tpu.models import DataConfig as JDataConfig
    from dlwp_cs_tpu.models import ExperimentConfig as JExperimentConfig
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")
    jcfg = JExperimentConfig(data=JDataConfig(**DATA), model=JUNetConfig(filters=(4, 8)))
    jest = JEstimator(jcfg)
    x0 = jnp.zeros((1, 6, N, N, jcfg.data.input_channels))
    jest.state = types.SimpleNamespace(
        params=jax.jit(jest.model.init)(jax.random.PRNGKey(1), x0))
    jest.stats = STATS
    return jest


@pytest.fixture(scope="module")
def jax_convlstm():
    """The reference ConvLSTM's seeded parameters (numpy) and its
    single-device forward on the sharded cases' input."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu import models as jmodels

    net = jmodels.CubeSphereConvLSTMNet(_lstm_config(jmodels))
    x = jnp.asarray(_rand((2, 6, LSTM_N, LSTM_N, 7), 71))
    params = jax.jit(net.init)(jax.random.PRNGKey(2), x)
    return jax.tree_util.tree_map(np.asarray, params), np.asarray(jax.jit(net.apply)(params, x))


def _reference_perturbations():
    """The perturbations the reference's mesh service draws for one window
    padded to two, with ``ENS_KEY``: ``(2, members, T_in, 6, n, n, C)``."""
    import jax

    from dlwp_cs_tpu.rollout import ic_perturbations

    _, windows, _ = _service_inputs()
    return np.array(ic_perturbations(jax.random.PRNGKey(ENS_KEY), (2,) + windows.shape[1:],
                                     ENS_MEMBERS))


@pytest.fixture(scope="module")
def group(jax_model, jax_convlstm, tmp_path_factory):
    import jax

    params = jax.tree_util.tree_map(np.asarray, jax_model.state.params)
    results = spawn_group(_rank_cases, 4, params, jax_convlstm[0],
                          _reference_perturbations()[:1],
                          workdir=tmp_path_factory.mktemp("ranks"))
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    return results


def _jax_sharded(fn, x, sy, sx, data=1):
    """JAX ``shard_map`` of ``fn`` over rows (and columns) of ``x``."""
    import jax
    from jax.sharding import PartitionSpec as P

    from dlwp_cs_tpu.parallel import create_mesh

    spec = P(None, None, "spatial", "spatial_x" if sx > 1 else None, None)
    jmesh = create_mesh(data=data, spatial=sy, spatial_x=sx)
    return np.asarray(jax.jit(jax.shard_map(fn, mesh=jmesh, in_specs=spec, out_specs=spec,
                                            check_vma=False))(x))


def _block(stacked, coords, bh, bw):
    """The block at ``coords`` (data, iy, jx) of a shard_map output whose
    local blocks are ``bh x bw`` (the caller picks the batch half of a data
    coordinate)."""
    _, iy, jx = coords
    return stacked[:, :, iy * bh : (iy + 1) * bh, jx * bw : (jx + 1) * bw]


@pytest.mark.parametrize("s,width", XCHG_CASES)
def test_band_exchange_matches_reference(group, s, width):
    """Kernel #10's plain version (the ``ppermute`` pair) against the
    reference's Pallas remote-copy kernel in interpret mode, on a data=1
    mesh of S CPU devices: equal."""
    import os

    import jax
    from jax.sharding import PartitionSpec as P

    from dlwp_cs_tpu.parallel import create_mesh
    from dlwp_cs_tpu.parallel.rdma_halo import band_exchange_rdma

    if (os.cpu_count() or 1) < 4:
        pytest.skip("interpret-mode RDMA needs >= ~1 core per device")
    x = _rand((2, 6, 16, 16, 3), 21)
    spec = P(None, None, "spatial", None, None)
    fn = jax.jit(jax.shard_map(
        lambda xl: band_exchange_rdma(xl, width, n_shards=s, interpret=True),
        mesh=create_mesh(data=1, spatial=s), in_specs=spec, out_specs=(spec, spec),
        check_vma=False))
    ref = [np.asarray(t) for t in fn(x)]
    for r in group:
        coords, ours = r["rdma", s, width]
        d = slice(None) if s == 4 else slice(coords[0], coords[0] + 1)
        for got, want in zip(ours, ref):
            np.testing.assert_array_equal(got, _block(want, coords, width, 16)[d])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("s", [2, 4])
def test_overlap_conv_matches_reference(group, s, dtype):
    """Kernel #11's plain version (the ghost rows assembled from the seam
    strips, the ``ppermute`` pair's rows and the corner table) against the
    reference's Pallas kernel in interpret mode, on a data=1 mesh of S CPU
    devices: float32 within 2e-5 (the reference's own tolerance), bfloat16
    within 2**-6 of the largest output."""
    import os

    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.parallel.overlap_band import band_conv3x3_overlap

    if (os.cpu_count() or 1) < 4:
        pytest.skip("interpret-mode RDMA needs >= ~1 core per device")
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, ks, bs = _conv_inputs()
    x, *w = (jnp.asarray(a, jdt) for a in (x, *ks, *bs))
    ref = _jax_sharded(lambda xl: band_conv3x3_overlap(xl, *w, "spatial", s, True),
                       x, s, 1).astype(np.float32)
    for r in group:
        ours = r["overlap", s, dtype]
        if dtype == torch.float32:
            np.testing.assert_allclose(ours, ref, rtol=0, atol=2e-5)
        else:
            _close(ours, ref, dtype)


def test_eq_corner_table_matches_reference():
    from dlwp_cs_tpu.parallel.overlap_band import _eq_corner_table as jtable

    from dlwp_cs_tpu_torch.parallel.overlap_band import _eq_corner_table

    for n in (8, 16, 48):
        assert _eq_corner_table(n) == jtable(n)


@pytest.mark.parametrize("s,width", PADS_1D)
def test_sharded_pad_matches_reference(group, s, width):
    from dlwp_cs_tpu.ops import cs_pad
    from dlwp_cs_tpu.parallel.halo import sharded_cs_pad as jpad

    x = _rand((2, 6, N, N, 3), 1)
    ref = _jax_sharded(lambda xl: jpad(xl, width, n_shards=s), x, s, 1)
    full = np.asarray(cs_pad(x, width))
    h = N // s
    for r in group:
        coords, ours = r["pad1d", s, width]
        d = slice(None) if s == 4 else slice(coords[0], coords[0] + 1)
        want = _block(ref, coords, h + 2 * width, N + 2 * width)[d]
        np.testing.assert_allclose(ours, want, rtol=0, atol=1e-6)
        iy = coords[1]
        np.testing.assert_allclose(ours, full[d, :, iy * h : iy * h + h + 2 * width],
                                   rtol=0, atol=1e-6)


def test_zero_band_exchange_moves_no_band_rows(group):
    """``use_band_exchange("zero")``: the ghost rows between bands come back
    as zeros (a conv that moves them itself fills them); the rest of the
    halo is the full exchange's."""
    for r in group:
        coords, full = r["pad1d", 4, 1]
        zero = r["pad1d_zero"]
        iy = coords[1]
        inner = [row for row, interior in ((0, iy > 0), (-1, iy < 3)) if interior]
        for row in inner:
            assert not zero[:, :, row, 1:-1].any()
        keep = np.ones(zero.shape[2], bool)
        keep[inner] = False
        np.testing.assert_array_equal(zero[:, :, keep], full[:, :, keep])


def test_halo_pieces_match_reference(group):
    from dlwp_cs_tpu.parallel.halo import halo_pieces as jpieces

    x = _rand((2, 6, N, N, 3), 1)
    for i, (bh, bw) in enumerate([(1, N + 2), (1, N + 2), (2, 1), (2, 1)]):
        ref = _jax_sharded(lambda xl: jpieces(xl, 1, n_shards=4)[i], x, 4, 1)
        for r in group:
            coords, pieces = r["pieces"]
            np.testing.assert_allclose(pieces[i], _block(ref, coords, bh, bw),
                                       rtol=0, atol=1e-6)


@pytest.mark.parametrize("tiling,width", PADS_2D)
def test_sharded_pad_2d_matches_reference(group, tiling, width):
    from dlwp_cs_tpu.ops import cs_pad
    from dlwp_cs_tpu.parallel.halo2d import sharded_cs_pad_2d as jpad2d

    sy, sx = tiling
    x = _rand((2, 6, N, N, 3), 1)
    ref = _jax_sharded(lambda xl: jpad2d(xl, width, sy=sy, sx=sx), x, sy, sx)
    full = np.asarray(cs_pad(x, width))
    h, wl = N // sy, N // sx
    for r in group:
        coords, ours = r["pad2d", sy, sx, width]
        d = slice(None) if sy * sx == 4 else slice(coords[0], coords[0] + 1)
        want = _block(ref, coords, h + 2 * width, wl + 2 * width)[d]
        np.testing.assert_allclose(ours, want, rtol=0, atol=1e-6)
        iy, jx = coords[1:]
        np.testing.assert_allclose(
            ours, full[d, :, iy * h : iy * h + h + 2 * width, jx * wl : jx * wl + wl + 2 * width],
            rtol=0, atol=1e-6)


def _close(ours, ref, dtype):
    if dtype == torch.float32:
        np.testing.assert_allclose(ours, ref, rtol=0, atol=F32_TOL)
    else:
        err = np.abs(ours - ref).max()
        assert err <= BF16_REL * np.abs(ref).max(), err


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("conv", ["ringfix", "band", "tile"])
def test_band_and_tile_convs_match_reference(group, conv, dtype):
    """The band ring-fix conv, and the band and tile kernels' plain
    versions (the CPU path of kernels #8, #9), against the reference's
    ``sharded_ringfix_conv3x3`` and its Pallas band and tile kernels."""
    import jax.numpy as jnp

    from dlwp_cs_tpu.parallel.overlap import sharded_ringfix_conv3x3
    from dlwp_cs_tpu.parallel.pallas_band import band_conv3x3_pallas
    from dlwp_cs_tpu.parallel.pallas_tile import tile_conv3x3_pallas

    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    x, ks, bs = _conv_inputs()
    x, *w = (jnp.asarray(a, jdt) for a in (x, *ks, *bs))
    fns = {
        "ringfix": (lambda xl: sharded_ringfix_conv3x3(xl, *w, n_shards=4), 4, 1),
        "band": (lambda xl: band_conv3x3_pallas(xl, *w, "spatial", 4, True), 4, 1),
        "tile": (lambda xl: tile_conv3x3_pallas(xl, *w, "spatial", "spatial_x", 2, 2, True),
                 2, 2),
    }
    fn, sy, sx = fns[conv]
    ref = _jax_sharded(fn, x, sy, sx).astype(np.float32)
    for r in group:
        _close(r[conv, dtype], ref, dtype)


def test_tall_tiles_go_pad_then_valid(group):
    """h > wl: the tile conv closure leaves the kernel for pad-then-VALID
    (with its own 3x3 conv cleared, or it would recurse)."""
    from dlwp_cs_tpu.ops import cs_conv

    x, ks, bs = _conv_inputs()
    ref = np.asarray(cs_conv(x, *ks, bias_eq=bs[0], bias_pole=bs[1], backend="xla"))
    for r in group:
        np.testing.assert_allclose(r["tile_tall"], ref, rtol=0, atol=F32_TOL)


@pytest.fixture(scope="module")
def jax_unet_outputs(jax_model):
    import jax

    jm = jax_model
    x = _rand((4, 6, N, N, jm.config.data.input_channels), 61)
    return x, np.asarray(jax.jit(jm.model.apply)(jm.state.params, x))


@pytest.mark.parametrize("shape,overlap,band_conv", MODELS)
def test_unet_spatial_apply_matches_reference(group, jax_unet_outputs, shape, overlap,
                                              band_conv):
    """A small U-Net (filters (4, 8)) through ``make_spatial_apply`` against
    the reference's forward (whose own tests pin its sharded applies, the
    Pallas band and tile kernels' included, to it); the band and tile convs
    are held against the reference's kernels above."""
    _, single = jax_unet_outputs
    for r in group:
        np.testing.assert_allclose(r["unet", shape, overlap, band_conv], single,
                                   rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("shape,band_impl,band_conv", MODELS_REMOTE)
def test_unet_remote_copy_paths_match_reference(group, jax_unet_outputs, shape, band_impl,
                                                band_conv):
    """The small U-Net through ``make_spatial_apply`` with the band-row
    exchange of kernel #10 (``band_impl='rdma'``) and the band conv of
    kernel #11 (``band_conv='overlap'``), their plain versions on the CPU,
    on 4 and 2 row bands, against the reference's single-device forward."""
    _, single = jax_unet_outputs
    for r in group:
        np.testing.assert_allclose(r["unet_remote", shape, band_impl, band_conv], single,
                                   rtol=0, atol=F32_TOL)


@pytest.mark.parametrize("backend,shape,band_conv", LSTM_CASES)
def test_sharded_convlstm_matches_reference(group, jax_convlstm, backend, shape, band_conv):
    """The ConvLSTM (filters (4, 4), 2 input times, insolation, n = 16)
    through ``make_spatial_apply`` on row bands and 2x2 tiles, from the
    reference's parameter tree, against the reference's single-device
    forward: 5e-5, as ``tests/test_convlstm.py::TestShardedConvLSTM``."""
    _, single = jax_convlstm
    for r in group:
        ours = r["lstm", backend, shape, band_conv]
        assert ours.shape == single.shape == (2, 6, LSTM_N, LSTM_N, 4)
        np.testing.assert_allclose(ours, single, rtol=0, atol=5e-5)


def test_forecast_service_on_mesh_matches_reference(group, jax_model):
    """``ForecastService(mesh=create_mesh(data=2, spatial=2))`` at batch 3
    (padded to 4 over the data dimension), 2 steps, against the reference's
    service on the same mesh; every rank gets the same forecast.  Then the
    rank-0 front end: 3 submits on rank 0 while the others follow()
    coalesce into one dispatch, equal to the collective forecast of the
    same windows."""
    from dlwp_cs_tpu.parallel import create_mesh
    from dlwp_cs_tpu.serve import ForecastService as JForecastService

    const, windows, t0 = _service_inputs()
    ref = JForecastService(jax_model, constants=const, mesh=create_mesh(data=2, spatial=2))
    want = np.asarray(ref.forecast(windows, t0, steps=2).fields)
    std = np.asarray(STATS["std"], np.float32)
    for r in group:
        fields, init_times, padded, requests = r["service"]
        assert fields.shape == want.shape == (3, 4, 6, N, N, 2)
        np.testing.assert_allclose(fields, want, rtol=0, atol=1e-4 * float(std.max()))
        np.testing.assert_array_equal(fields, group[0]["service"][0])
        np.testing.assert_array_equal(init_times, t0)
        assert (padded, requests) == (1, 3)
    front = group[0]["front"]
    assert front["dispatches"] == 1
    for i in range(3):
        assert front["fields"][i].shape == (1, 4, 6, N, N, 2)
        np.testing.assert_allclose(front["fields"][i][0], want[i], rtol=0,
                                   atol=1e-4 * float(std.max()))
        np.testing.assert_array_equal(front["init_times"][i], [t0[i]])
    # the coalesced batch of 3 runs at batch 4 (one padding member), the
    # collective call at batch 3 padded to 4 over data: the same sums
    np.testing.assert_array_equal(np.concatenate(front["fields"]), group[0]["service"][0])
    kind, msg = front["leading"]
    assert kind == "RuntimeError" and "submit()" in msg


def test_mesh_front_end_followers(group):
    """Ranks 1-3 follow() both of rank 0's dispatches, refuse to submit,
    and keep the same counts as rank 0; close() ends the front end on
    every rank."""
    for r in group[1:]:
        front = r["front"]
        assert front["runs"] == 2 and front["errors"] == []
        kind, msg = front["wrong_rank"]
        assert kind == "RuntimeError" and "follow()" in msg
    # requests: 3 collective + 1 + 1 ensembles + 3 submits + 1 submit_ensemble
    # in 5 dispatches; the submits' bucket pads one member; the mesh pads the
    # forecast, both collective ensembles and the submitted one
    for r in group:
        assert r["front_stats"] == (9, 5, 1, 4)
        kind, msg = r["closed_submit"]
        assert kind == "RuntimeError" and ("closed" if r is group[0] else "follow()") in msg


def test_mesh_ensemble_pads_data_axis_matches_reference(group, jax_model):
    """``forecast_ensemble`` under data = 2 with 3 members: the window batch
    padded by one (``stats.padded_mesh``), against the reference's mesh
    service with its own perturbations handed in; then the front end's
    ``submit_ensemble`` with a seed against the collective call with the
    generator seeded alike: every rank drew the same perturbations."""
    import jax

    from dlwp_cs_tpu.parallel import create_mesh
    from dlwp_cs_tpu.serve import ForecastService as JForecastService

    const, windows, t0 = _service_inputs()
    ref = JForecastService(jax_model, constants=const, mesh=create_mesh(data=2, spatial=2))
    want = ref.forecast_ensemble(windows[0], t0[0], steps=2, members=ENS_MEMBERS,
                                 amplitude=ENS_AMP, key=jax.random.PRNGKey(ENS_KEY),
                                 keep_members=True)
    tol = 1e-4 * float(np.max(STATS["std"]))
    for r in group:
        mean, spread, members, init_times, padded = r["ensemble"]
        assert mean.shape == np.asarray(want.mean).shape == (1, 4, 6, N, N, 2)
        assert members.shape == (1, ENS_MEMBERS, 4, 6, N, N, 2)
        np.testing.assert_allclose(mean, np.asarray(want.mean), rtol=0, atol=tol)
        np.testing.assert_allclose(spread, np.asarray(want.spread), rtol=0, atol=tol)
        np.testing.assert_allclose(members, np.asarray(want.members), rtol=0, atol=tol)
        np.testing.assert_array_equal(init_times, [t0[0]])
        assert padded == 2  # the forecast's one window and the ensemble's
        for a, b in zip(r["ensemble_seeded"], group[0]["ensemble_seeded"]):
            np.testing.assert_array_equal(a, b)
    for a, b in zip(group[0]["front"]["ensemble"], group[0]["ensemble_seeded"]):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize("i", range(len(CTX_ERRORS)),
                         ids=[f"{k}" for _, k, _, _ in CTX_ERRORS])
def test_sharded_model_ctx_rejections(group, i):
    """Options that would be accepted and ignored raise; the remote-copy
    kernels' spellings (#10: ``band_impl='rdma'``, #11:
    ``band_conv='overlap'``, and their ``_interpret`` names) are accepted
    on row bands, as in the reference."""
    _, _, kind, match = CTX_ERRORS[i]
    for r in group:
        got = r["ctx_error", i]
        if kind is None:
            assert got is None, got
        else:
            assert got is not None and got[0] == kind and match in got[1], got


@pytest.mark.parametrize("case,kind,match", [
    ("bad_width", "ValueError", "halo width"),
    ("bad_batch", "ValueError", "does not split"),
    # differentiated outside collectives.recording(), whose backward could
    # not keep the ranks in step (tests/test_torch_parallel_train.py
    # differentiates the pads inside one)
    ("grad", "RuntimeError", "recording()"),
])
def test_sharded_path_rejects_bad_inputs(group, case, kind, match):
    for r in group:
        got = r[case]
        assert got is not None and got[0] == kind and match in got[1], got


def test_collectives_follow_jax_semantics(group):
    """all_gather in coordinate order; psum over two dimensions (the 2x2
    mesh's four ranks); ppermute on the end pair {0 <-> 3}, zeros in
    between."""
    for r in group:
        gathered, summed, swapped = r["collectives"]
        np.testing.assert_array_equal(gathered, np.repeat([0.0, 1.0, 2.0, 3.0], 2))
        np.testing.assert_array_equal(summed, [6.0, 6.0])
        want = {0: 3.0, 3: 0.0}.get(r["rank"], 0.0)
        np.testing.assert_array_equal(swapped, [want, want])


def _jax_collective(fn, dtype, mesh_shape, spec_axes):
    """Each rank's result of ``fn`` (a ``lax`` collective on one rank's
    block) under ``shard_map`` over the ranks' seeded draws, stacked along
    a leading axis split over ``spec_axes``."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from dlwp_cs_tpu.parallel import create_mesh

    xs = np.stack([_rand(COLL_SHAPE, COLL_SEED + r) for r in range(4)])
    jdt = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    spec = P(spec_axes)
    mapped = jax.jit(jax.shard_map(lambda xb: fn(xb[0])[None], mesh=create_mesh(*mesh_shape),
                                   in_specs=spec, out_specs=spec, check_vma=False))
    return np.asarray(mapped(jnp.asarray(xs, jdt)).astype(jnp.float32))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_psum_sums_in_rank_order(group, dtype):
    """The plain ``psum`` (a CPU tensor's transport) is ``((x0 + x1) + x2)
    + x3`` in the tensor's dtype, bitwise, on every rank, over 4 bands and
    over (spatial, spatial_x) of the 2x2 mesh; against ``lax.psum`` under
    ``shard_map`` within one rounding of each add (f32 1e-6, bf16 2**-6 of
    the largest sum)."""
    from jax import lax

    xs = [torch.from_numpy(_rand(COLL_SHAPE, COLL_SEED + r)).to(dtype) for r in range(4)]
    chain = ((xs[0] + xs[1]) + xs[2]) + xs[3]
    refs = {"psum": _jax_collective(lambda x: lax.psum(x, "spatial"), dtype, (1, 4), "spatial"),
            "psum_joint": _jax_collective(lambda x: lax.psum(x, ("spatial", "spatial_x")),
                                          dtype, (1, 2, 2), ("spatial", "spatial_x"))}
    tol = 1e-6 if dtype == torch.float32 else 2.0**-6
    for r in group:
        for key, ref in refs.items():
            got = r["collectives_plain"][key, dtype]
            np.testing.assert_array_equal(got, chain.float().numpy())
            np.testing.assert_allclose(got, ref[r["rank"]], rtol=0,
                                       atol=tol * float(np.abs(ref).max()))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
@pytest.mark.parametrize("axis,tiled", COLL_GATHERS)
def test_plain_all_gather_matches_lax(group, dtype, axis, tiled):
    """The plain tiled and stacked ``all_gather`` along axes 0 and 3 equal
    ``lax.all_gather`` under ``shard_map``."""
    from jax import lax

    ref = _jax_collective(lambda x: lax.all_gather(x, "spatial", axis=axis, tiled=tiled), dtype,
                          (1, 4), "spatial")
    for r in group:
        np.testing.assert_array_equal(r["collectives_plain"]["gather", axis, tiled, dtype],
                                      ref[r["rank"]])


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16], ids=["f32", "bf16"])
def test_plain_ppermute_gives_zeros_to_unnamed_receivers(group, dtype):
    """A ``ppermute`` whose pairs name two of the four receivers equals
    ``lax.ppermute``: the two others get zeros."""
    from jax import lax

    ref = _jax_collective(lambda x: lax.ppermute(x, "spatial", COLL_PERM), dtype, (1, 4),
                          "spatial")
    receivers = {dst for _, dst in COLL_PERM}
    for r in group:
        got = r["collectives_plain"]["ppermute", dtype]
        np.testing.assert_array_equal(got, ref[r["rank"]])
        assert (r["rank"] in receivers) or not got.any()


# ---- in one process, no group ----------------------------------------------

def _conv_case():
    x, ks, bs = _conv_inputs()
    return torch.from_numpy(x), [torch.from_numpy(a) for a in (*ks, *bs)]


@pytest.mark.parametrize("backend", ["auto", "pallas", "xring", "ringfix", "xla"])
def test_cs_conv_honours_an_installed_pad(backend):
    """Under an installed pad every 3x3 conv goes pad-then-VALID through it,
    whatever the backend: the single-device formulations would read
    neighbour faces a shard's block does not hold."""
    from dlwp_cs_tpu_torch.ops.conv import cs_conv
    from dlwp_cs_tpu_torch.ops.padding import cs_pad, use_pad_impl

    x, (k_eq, k_po, b_eq, b_po) = _conv_case()
    calls = []

    def pad(xb, width):
        calls.append(width)
        with use_pad_impl(None):
            return cs_pad(xb, width)

    with use_pad_impl(pad):
        ours = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po, backend=backend)
    assert calls == [1]
    ref = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po, backend="xla")
    torch.testing.assert_close(ours, ref, rtol=0, atol=1e-5)


def test_conv3x3_impl_precedes_the_backend_and_shard_local_region_clears_it():
    from dlwp_cs_tpu_torch.ops.conv import cs_conv, shard_local_region, use_conv3x3_impl
    from dlwp_cs_tpu_torch.ops.padding import use_pad_impl

    x, (k_eq, k_po, b_eq, b_po) = _conv_case()
    seen = []

    def conv(*args):
        seen.append(len(args))
        return torch.zeros(())

    head = torch.zeros((1, 1, 3, 4))
    with use_conv3x3_impl(conv):
        assert cs_conv(x, k_eq, k_po, backend="xring").ndim == 0
        assert cs_conv(x, head, head).shape == (2, 6, N, N, 4)  # a 1x1 conv keeps its path
        with use_pad_impl(lambda *a: None), shard_local_region():
            local = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po)
    assert seen == [5]
    ref = cs_conv(x, k_eq, k_po, bias_eq=b_eq, bias_pole=b_po, backend="xla")
    torch.testing.assert_close(local, ref, rtol=0, atol=1e-5)


def test_block_kernel_wrappers_run_their_plain_version_on_cpu():
    """Kernels #8 and #9 on a CPU tensor: the plain version, no launch; on
    whole faces it is the single-device conv."""
    from dlwp_cs_tpu_torch.ops.halo import ext_strips
    from dlwp_cs_tpu_torch.ops.hopper_conv import (
        cs_conv3x3_band,
        cs_conv3x3_plain,
        cs_conv3x3_tile,
    )

    x, w = _conv_case()
    ext = ext_strips(x)
    for wrapper in (cs_conv3x3_band, cs_conv3x3_tile):
        before = wrapper.launches
        torch.testing.assert_close(wrapper(x, ext, *w), cs_conv3x3_plain(x, ext, *w),
                                   rtol=0, atol=0)
        assert wrapper.launches == before


def test_remote_copy_kernels_on_one_shard_and_cpu():
    """Kernel #10 on one shard returns the band's own (top, bottom) rows, as
    the reference does, with no launch; #10 refuses a tensor that requires a
    gradient, as the reference's kernel has no VJP (#11 takes one: its
    backward is the band ring-fix composition's,
    ``tests/test_torch_parallel_train.py``); neither counts a launch for a
    CPU tensor."""
    import types

    from dlwp_cs_tpu_torch.parallel.overlap_band import band_conv3x3_overlap, overlap_supported
    from dlwp_cs_tpu_torch.parallel.rdma_halo import band_exchange_rdma

    one = types.SimpleNamespace(mesh_dim_names=("data", "spatial"), shape=(1, 1))
    x = torch.from_numpy(_rand((1, 6, N, N, 3), 3))
    before = (band_exchange_rdma.launches, band_conv3x3_overlap.launches)
    below, above = band_exchange_rdma(x, 2, mesh=one)
    torch.testing.assert_close(below, x[:, :, -2:], rtol=0, atol=0)
    torch.testing.assert_close(above, x[:, :, :2], rtol=0, atol=0)
    with pytest.raises(ValueError, match="at least 2 shards"):
        band_conv3x3_overlap(x, *_conv_case()[1], mesh=one)
    assert (band_exchange_rdma.launches, band_conv3x3_overlap.launches) == before
    two = types.SimpleNamespace(mesh_dim_names=("data", "spatial"), shape=(1, 2))
    grad = x[:, :, : N // 2].clone().requires_grad_(True)
    with pytest.raises(NotImplementedError, match="carries no gradient"):
        band_exchange_rdma(grad, 1, mesh=two)
    # the gate refuses what the math refuses, as the reference's
    assert overlap_supported((2, 6, N // 4, N, 3), 4, torch.float32)
    assert overlap_supported((2, 6, N // 4, N, 3), 4, torch.bfloat16)
    assert not overlap_supported((2, 6, N, N, 3), 1, torch.float32)  # 1 shard
    assert not overlap_supported((2, 6, 3, N, 3), 4, torch.float32)  # not a band
    assert not overlap_supported((2, 6, N // 4, N, 3), 4, torch.float64)


@pytest.mark.parametrize("ndim", [4, 5, 6])
@pytest.mark.parametrize("spatial_x", [False, True], ids=["2d_mesh", "3d_mesh"])
def test_sharding_descriptors_match_reference_specs(ndim, spatial_x):
    """The reference's sharding names return descriptors whose per-dimension
    specs equal its ``PartitionSpec``s (``spatial_x`` only on a mesh with
    that dimension); the training steps and the scaling harness are ported
    (their behaviour: ``tests/test_torch_parallel_train.py``,
    ``tests/test_torch_train.py``)."""
    import types

    import jax
    from jax.sharding import Mesh

    from dlwp_cs_tpu.parallel import mesh as jmesh
    import dlwp_cs_tpu_torch.parallel as par
    from dlwp_cs_tpu_torch.parallel import scaling, sharding
    from dlwp_cs_tpu_torch.parallel.halo import use_band_exchange
    from dlwp_cs_tpu_torch.train.trainer import Trainer

    names = ("data", "spatial", "spatial_x") if spatial_x else ("data", "spatial")
    ref_mesh = Mesh(np.asarray(jax.devices()[:1]).reshape((1,) * len(names)), names)
    ours_mesh = types.SimpleNamespace(mesh_dim_names=names, shape=(1,) * len(names))
    for name, args in (("batch_sharding", (ndim,)), ("batch_spatial_sharding", (ndim,)),
                       ("stacked_batch_sharding", (ndim,)), ("replicated", ())):
        ours = getattr(par, name)(ours_mesh, *args)
        ref = getattr(jmesh, name)(ref_mesh, *args)
        assert isinstance(ours, par.BlockSharding) and ours.mesh is ours_mesh
        assert ours.spec == tuple(ref.spec), name
    # a trainer on the mesh takes batch blocks cut by batch_sharding as it
    # takes blocks cut by the mesh, and refuses others
    trainer = types.SimpleNamespace(mesh=ours_mesh)
    x = torch.ones(2, 3)
    for feeds in (par.batch_sharding(ours_mesh), ours_mesh):
        feed = Trainer._feed(trainer, types.SimpleNamespace(sharding=feeds), "cpu")
        assert feed(x) is x
    for other in (par.batch_spatial_sharding(ours_mesh), par.replicated(ours_mesh),
                  par.batch_sharding(types.SimpleNamespace(mesh_dim_names=names))):
        with pytest.raises(ValueError, match="not this trainer's"):
            Trainer._feed(trainer, types.SimpleNamespace(sharding=other), "cpu")
    with pytest.raises(ValueError, match="spatial=True with a sharding descriptor"):
        par.shard_batch(x, par.batch_sharding(ours_mesh), spatial=True)
    with pytest.raises(ValueError, match="a sharding spec of 5 dimensions"):
        par.shard_batch(x, par.batch_sharding(ours_mesh))
    for name in ("make_spatial_train_step", "make_dp_train_step", "make_dp_shardmap_train_step",
                 "make_dp_eval_step", "make_dp_shardmap_eval_step", "make_dp_scanned_train_step",
                 "make_dp_shardmap_scanned_train_step"):
        assert getattr(par, name) is getattr(sharding, name)
    assert par.measure_scaling is scaling.measure_scaling
    assert par.ScalingResult is scaling.ScalingResult
    for impl in ("ppermute", "rdma", "rdma_interpret", "zero"):  # #10 is ported
        with use_band_exchange(impl):
            pass
    with pytest.raises(ValueError, match="unknown band exchange"):
        with use_band_exchange("nope"):
            pass


@pytest.mark.parametrize("shape", DESCRIPTOR_MESHES)
def test_sharding_descriptors_cut_as_the_mesh(group, shape):
    """On every rank: ``shard_batch`` by ``batch_spatial_sharding`` equals
    ``local_block(spatial=True)``, by ``batch_sharding`` and
    ``prefetch_to_device(sharding=batch_sharding(mesh))`` the batch block,
    ``stacked_batch_sharding`` cuts dimension 1, ``replicated`` nothing."""
    for r in group:
        for what, (ours, ref) in r["descriptors", shape].items():
            ours, ref = (list(ours), list(ref)) if isinstance(ref, list) else ([ours], [ref])
            assert len(ours) == len(ref), what
            for o, e in zip(ours, ref):
                torch.testing.assert_close(o, e, rtol=0, atol=0, msg=f"rank {r['rank']} {what}")
                assert o.is_contiguous()


def test_single_process_needs_no_group(monkeypatch):
    """Without a process group: create_mesh raises, initialize_distributed
    reports a single process and initializes nothing, and one process owns
    the whole batch."""
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.parallel import create_mesh, host_batch_slice, initialize_distributed

    assert not dist.is_initialized()
    monkeypatch.delenv("WORLD_SIZE", raising=False)
    assert initialize_distributed() is False and not dist.is_initialized()
    with pytest.raises(RuntimeError, match="process group"):
        create_mesh(data=1, device="cpu")
    assert host_batch_slice(8) == slice(0, 8)
