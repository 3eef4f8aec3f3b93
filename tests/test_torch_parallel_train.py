"""The port's training under a mesh against the JAX package.

One group of 4 CPU ranks (gloo, meeting through a ``FileStore``) runs every
case of this file once (:func:`_rank_cases`, spawned by the ``group``
fixture): the data-parallel steps, the spatial step on row bands (the band
ring-fix conv, kernel #8's and #11's plain versions, kernel #10 with #8) and
on 2 x 2 tiles (pad-then-VALID, kernel #9's plain version), the
area-weighted spatial step, three steps in a row, the sharded sequence step,
``Trainer(mesh=...)`` and the collectives' gradients.  The spawned ranks
import this module, so JAX is imported only inside the fixtures and tests.

The reference's own tests hold its sharded steps against its single-device
step (``tests/test_parallel.py``, ``tests/test_sequence_training.py``,
``tests/test_dp_trainer.py``); these hold the port's sharded steps against
the same single-device steps of the JAX package (its pad-then-VALID
``'xla'`` conv, the same linear map), run on the conftest's CPU devices,
and against the JAX package's own ``make_dp_shardmap_train_step`` and
``Trainer(mesh=...)`` on 4 devices, at the reference tests' tolerances:

* data-parallel steps: loss ``rel=1e-5``, parameters ``atol=1e-5``,
  gradient norm ``rel=1e-4``;
* spatial steps (mean and area-weighted): loss ``rel=1e-4``, parameters
  ``atol=1e-4``; three steps in a row: loss ``rel=1e-3``;
* the sharded sequence step: loss ``rel=1e-5``, parameters ``atol=1e-4``;
* the sequence example (``examples/05``) under ``--mesh 2x2``: its per-step
  losses against its one-process run, ``rel=1e-5``;
* the trainer: epoch losses ``rel=1e-4``, parameters ``atol=1e-5``;
* one SGD step at learning rate 1 through each block kernel: parameters
  ``atol=1e-6`` (the single-device SGD tolerance of
  ``tests/test_torch_train.py``), and every parameter moved (its gradient
  is present);
* the collectives' backward passes and the sharded pads' gradients in
  float64 against the single-process gradient of the gathered
  computation: 1e-12.

Inputs are seeded numpy at n = 8 with filters (4, 8): the bands shrink 2 -> 1
rows on 4 bands.  Every rank's parameters after every step are bitwise
equal to rank 0's.
"""

import importlib

import numpy as np
import pytest
import torch

from dlwp_cs_tpu_torch.parallel.launch import spawn_group

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8
B = 4  # the global batch
MODEL = dict(output_channels=2, filters=(4, 8))
# spatial steps: (mesh (data, spatial, spatial_x), make_spatial_train_step options)
SPATIAL = [
    ((1, 4, 1), dict(band_conv="ringfix")),
    ((1, 4, 1), dict(band_conv="pallas")),  # kernel #8's plain version
    ((1, 4, 1), dict(band_conv="overlap")),  # kernel #11's plain version
    ((1, 4, 1), dict(band_impl="rdma", band_conv="pallas")),  # #10's, then #8's
    ((1, 4, 1), dict(overlap=False)),  # pad-then-VALID on bands
    ((2, 2, 1), dict(band_conv="ringfix")),
    ((1, 2, 2), dict(band_conv="ringfix")),  # pad-then-VALID on tiles
    ((1, 2, 2), dict(band_conv="pallas")),  # kernel #9's plain version
]
WEIGHTED = [((2, 2, 1), dict(band_conv="pallas")), ((1, 2, 2), dict(band_conv="pallas"))]
# one SGD step at learning rate 1 through each block kernel's backward
SGD = [((4, 1, 1), None), ((1, 4, 1), dict(band_conv="pallas")),
       ((1, 4, 1), dict(band_conv="overlap")), ((1, 2, 2), dict(band_conv="pallas"))]
SEQUENCE_MESHES = [(2, 2, 1), (1, 2, 2)]
SEQ = 3
# examples/05's arguments in the group: --sequence 2 --steps 3 --batch 4 --filters 4
EXAMPLE05 = dict(sequence=2, steps=3, batch=4, filters=(4,), device="cpu")
DATA = dict(grid_n=N, variables=("a", "b"), input_time_steps=2, output_time_steps=2,
            add_insolation=True, constants=("topo",))
INSOL = dict(insol_mean=300.0, insol_std=400.0)
# the collectives' gradient cases: (name, mesh)
COLLECTIVES = [("all_gather", (1, 4, 1)), ("all_gather_stacked", (1, 4, 1)),
               ("psum", (1, 4, 1)), ("psum_2d", (1, 2, 2)), ("ppermute_ring", (1, 4, 1)),
               ("ppermute_ends", (1, 4, 1))]
PAD_GRADS = [((1, 4, 1), 1), ((1, 4, 1), 2), ((1, 2, 2), 1)]


def _rand(shape, seed, scale=1.0):
    return (np.random.default_rng(seed).normal(size=shape) * scale).astype(np.float32)


def _batches():
    """Two global batches ``(x, y)`` of the spatial and data-parallel cases."""
    return [(_rand((B, 6, N, N, 3), 10 + i), _rand((B, 6, N, N, 2), 20 + i)) for i in range(2)]


def _sequence_batch():
    rng = np.random.default_rng(11)
    window = rng.normal(size=(B, 2, 6, N, N, 2)).astype(np.float32)
    targets = rng.normal(size=(B, SEQ, 6, N, N, 4)).astype(np.float32)
    t0 = np.asarray([1.0, 1.25, 50.5, 117.75], np.float32)
    consts = np.random.default_rng(9).normal(size=(6, N, N, 1)).astype(np.float32)
    return window, t0, targets, consts


def _example_store():
    """The sequence example's store: the analytic sources of examples/01 on a
    C8 grid, 12 days at 6 h."""
    ex01 = importlib.import_module("dlwp_cs_tpu_torch.examples.01_build_dataset")
    return ex01.build_store(*ex01.synthetic_sources(16, 32, 12.0, 6.0), grid=N,
                            remap="bilinear", device="cpu")


def _trainer_data():
    """The reference DP trainer test's data at batch 8: blocks of 2 on data=4."""
    x = _rand((8, 6, N, N, 3), 0)
    return x, 0.5 * x[..., :2]


def _estimator_case():
    """``(config, store)`` of ``DLWPEstimator.fit(mesh=...)``: batch 4, one
    per rank on data = 4, shuffled by the configuration's seed."""
    from dlwp_cs_tpu_torch.data import MemoryStore
    from dlwp_cs_tpu_torch.models import DataConfig, ExperimentConfig, UNetConfig
    from dlwp_cs_tpu_torch.models.config import TrainConfig

    rng = np.random.default_rng(3)
    t = 14
    fields = (rng.normal(size=(t, 6, N, N, 2)) * [3.0, 10.0] + [1.0, 280.0]).astype(np.float32)
    store = MemoryStore.from_raw(fields, 9000.0 + 0.25 * np.arange(t), ("a", "b"),
                                 constants=rng.normal(size=(6, N, N, 1)).astype(np.float32),
                                 constant_names=("orog",))
    cfg = ExperimentConfig(data=DataConfig(grid_n=N, variables=("a", "b"), constants=("orog",)),
                           model=UNetConfig(filters=(4, 8)),
                           train=TrainConfig(batch_size=4, max_epochs=2, learning_rate=1e-2))
    return cfg, store


def _collective_inputs(rank):
    """float64 ``(x, w)`` of one rank for the collectives' gradient cases."""
    rng = np.random.default_rng(100 + rank)
    return rng.normal(size=(2, 3)), rng.normal(size=(2, 3))


def _pad_inputs():
    """float64 field and, per rank, cotangent seeds of the pads' cases."""
    return np.random.default_rng(7).normal(size=(1, 6, N, N, 2))


def _numpy_params(params):
    return {k: v.detach().cpu().numpy().copy() for k, v in params.items()}


def _caught(fn):
    try:
        fn()
    except Exception as e:  # noqa: BLE001 — the test reads type and message
        return type(e).__name__, str(e)
    return None


# ---- what each rank runs ---------------------------------------------------

def _rank_cases(workdir):
    import torch.distributed as dist

    from dlwp_cs_tpu_torch.data import prefetch_to_device
    from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
    from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, UNetConfig
    from dlwp_cs_tpu_torch.models.config import TrainConfig
    from dlwp_cs_tpu_torch.ops.losses import AreaWeightedLoss, mse
    from dlwp_cs_tpu_torch.parallel import (
        collectives,
        create_mesh,
        make_dp_eval_step,
        make_dp_scanned_train_step,
        make_dp_shardmap_eval_step,
        make_dp_shardmap_scanned_train_step,
        make_dp_shardmap_train_step,
        make_dp_train_step,
        make_spatial_train_step,
        shard_batch,
    )
    from dlwp_cs_tpu_torch.parallel.halo import sharded_cs_pad
    from dlwp_cs_tpu_torch.parallel.halo2d import sharded_cs_pad_2d
    from dlwp_cs_tpu_torch.parallel.mesh import local_block
    from dlwp_cs_tpu_torch.train import (
        Trainer,
        init_state,
        make_optimizer,
        make_sharded_sequence_train_step,
        model_apply,
        params_of,
    )

    torch.set_num_threads(1)  # 4 ranks share the host's cores
    meshes = {}

    def mesh(shape):  # every rank creates the meshes in the same order
        if shape not in meshes:
            d, sy, sx = shape
            meshes[shape] = create_mesh(data=d, spatial=sy, spatial_x=sx, device="cpu")
        return meshes[shape]

    def unet(**kw):
        return CubeSphereUNet(UNetConfig(**dict(MODEL, **kw)), 3, device="cpu",
                              generator=torch.Generator().manual_seed(0))

    model = unet()
    apply = model_apply(model)
    adam = make_optimizer(TrainConfig(learning_rate=1e-3))
    (x, y), (x2, y2) = [tuple(map(torch.from_numpy, b)) for b in _batches()]
    out = {"rank": dist.get_rank()}

    def record(key, state, m):
        out[key] = (float(m["loss"]), float(m["grad_norm"]), _numpy_params(state.params))

    # data parallel: one step of each impl, two scanned steps, the eval steps
    m4 = mesh((4, 1, 1))
    for name, make in (("gspmd", make_dp_train_step), ("shard_map", make_dp_shardmap_train_step)):
        state, m = make(apply, adam, mse, m4)(init_state(params_of(model), adam),
                                             *shard_batch((x, y), m4))
        record(("dp", name), state, m)
    for name, make in (("gspmd", make_dp_scanned_train_step),
                       ("shard_map", make_dp_shardmap_scanned_train_step)):
        xs = torch.stack([local_block(t, m4, spatial=False) for t in (x, x2)])
        ys = torch.stack([local_block(t, m4, spatial=False) for t in (y, y2)])
        state, m = make(apply, adam, mse, m4)(init_state(params_of(model), adam), xs, ys)
        out["dp_scanned", name] = (m["loss"].numpy(), m["grad_norm"].numpy(),
                                   _numpy_params(state.params))
    for name, make in (("gspmd", make_dp_eval_step), ("shard_map", make_dp_shardmap_eval_step)):
        out["dp_eval", name] = float(make(apply, mse, m4)(
            params_of(model), *shard_batch((x, y), m4))["loss"])

    # the spatial step, mean and area-weighted losses
    for shape, kw in SPATIAL:
        calls = collectives.calls
        state, m = make_spatial_train_step(apply, adam, mse, mesh(shape), **kw)(
            init_state(params_of(model), adam), x, y)
        record(("spatial", shape, tuple(kw.items())), state, m)
        out["calls", shape, tuple(kw.items())] = collectives.calls - calls
    aw = AreaWeightedLoss("mse", CubedSphere(N).area_weights)
    for shape, kw in WEIGHTED:
        state, m = make_spatial_train_step(apply, adam, aw, mesh(shape), **kw)(
            init_state(params_of(model), adam), x, y)
        record(("weighted", shape), state, m)
    # three steps in a row, as the reference's multi-step test
    fast = make_optimizer(TrainConfig(learning_rate=1e-2))
    step = make_spatial_train_step(apply, fast, mse, mesh((2, 2, 1)))
    state = init_state(params_of(model), fast)
    for _ in range(3):
        state, m = step(state, x, 0.3 * x[..., :2])
    record("three_steps", state, m)
    # one SGD step at learning rate 1 through each block kernel's backward
    sgd = make_optimizer(TrainConfig(optimizer="sgd", learning_rate=1.0))
    for shape, kw in SGD:
        if kw is None:
            step = make_dp_train_step(apply, sgd, mse, mesh(shape))
            state, m = step(init_state(params_of(model), sgd), *shard_batch((x, y), mesh(shape)))
        else:
            step = make_spatial_train_step(apply, sgd, mse, mesh(shape), **kw)
            state, m = step(init_state(params_of(model), sgd), x, y)
        record(("sgd", shape, None if kw is None else tuple(kw.items())), state, m)

    # rejections: kernel #10 carries no gradient (as the reference's); a
    # batch that data does not divide
    out["rdma_ringfix"] = _caught(lambda: make_spatial_train_step(
        apply, adam, mse, mesh((1, 4, 1)), band_impl="rdma", band_conv="ringfix")(
            init_state(params_of(model), adam), x, y))
    out["bad_batch_spatial"] = _caught(lambda: make_spatial_train_step(
        apply, adam, mse, mesh((2, 2, 1)))(init_state(params_of(model), adam), x[:3], y[:3]))
    out["bad_batch_trainer"] = _caught(lambda: Trainer(model, TrainConfig(), mesh=m4).fit(
        init_state(params_of(model), adam), [(x[:3], y[:3])], verbose=False))

    # the sharded sequence step
    window, t0, targets, consts = _sequence_batch()
    dcfg = DataConfig(**DATA)
    seq_model = CubeSphereUNet(UNetConfig(output_channels=dcfg.output_channels, filters=(4, 8)),
                               dcfg.input_channels, device="cpu",
                               generator=torch.Generator().manual_seed(0))
    lat, lon = CubedSphere(N).cell_latlon
    for shape in SEQUENCE_MESHES:
        step = make_sharded_sequence_train_step(
            model_apply(seq_model), dcfg, fast, mesh(shape), lat=lat, lon=lon,
            constants=consts, sequence=SEQ, **INSOL)
        state, m = step(init_state(params_of(seq_model), fast), window, t0, targets)
        record(("sequence", shape), state, m)
    # the sequence example (examples/05) under --mesh 2x2, as each of its
    # spawned ranks runs it, and in one process on the same store
    ex05 = importlib.import_module("dlwp_cs_tpu_torch.examples.05_sequence_train")
    store = _example_store()
    out["example05", "mesh"] = ex05.mesh_rank(store, 2, 2, EXAMPLE05)["losses"]
    out["example05", "one"] = ex05.sequence_train(store, log=lambda *a: None,
                                                  **EXAMPLE05)["losses"]

    # Trainer(mesh=data 4): global batches, a workdir (rank 0 writes), then a
    # prefetcher of this rank's blocks; restore_or_init on every rank
    tx, ty = map(torch.from_numpy, _trainer_data())
    tcfg = TrainConfig(learning_rate=1e-2, max_epochs=2)
    small = unet(filters=(4,))
    trainer = Trainer(small, tcfg, mesh=m4, workdir=workdir)
    state = trainer.fit(trainer.init(tx), [(tx, ty)], val_data=[(tx, ty)], verbose=False)
    trainer.close()
    fed = Trainer(small, tcfg, mesh=m4)
    fed_state = fed.fit(fed.init(tx), lambda: prefetch_to_device(
        iter([(tx, ty)]), device="cpu", sharding=m4), val_data=[(tx, ty)], verbose=False)
    resumed = Trainer(small, tcfg, mesh=m4, workdir=workdir)
    restored = resumed.restore_or_init(tx)
    resumed.close()
    out["trainer"] = {
        "epochs": trainer.history.epochs, "params": _numpy_params(state.params),
        "fed_epochs": fed.history.epochs, "fed_params": _numpy_params(fed_state.params),
        "restored_step": restored.step, "restored": _numpy_params(restored.params),
        "epochs_done": resumed._epochs_done,
    }

    # DLWPEstimator.fit(mesh=data 4), validation on the same store
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator

    cfg, store = _estimator_case()
    est = DLWPEstimator(cfg, device="cpu").fit(store, val_store=store, mesh=m4, verbose=False)
    out["estimator"] = (est.state.step, est._last_history.epochs, _numpy_params(est.state.params),
                        {k: p.detach().numpy().copy() for k, p in est.model.named_parameters()})

    # the scaling harness: every configuration the group can form
    from dlwp_cs_tpu_torch.parallel import measure_scaling

    out["scaling"] = measure_scaling(
        unet(), n_grid=N, in_channels=3, out_channels=2, batch_per_device=1,
        mesh_configs=((1, 1), (2, 1), (4, 1), (1, 4)), iters=1, device="cpu")

    # the collectives' backward passes, float64
    xr, wr = map(torch.from_numpy, _collective_inputs(dist.get_rank()))
    fns = {
        "all_gather": lambda t, m: collectives.all_gather(t, m, "spatial", axis=1),
        "all_gather_stacked": lambda t, m: collectives.all_gather(t, m, "spatial", axis=0,
                                                                  tiled=False),
        "psum": lambda t, m: collectives.psum(t, m, "spatial"),
        "psum_2d": lambda t, m: collectives.psum(t, m, ("spatial", "spatial_x")),
        "ppermute_ring": lambda t, m: collectives.ppermute(t, m, "spatial",
                                                           [(i, (i + 1) % 4) for i in range(4)]),
        "ppermute_ends": lambda t, m: collectives.ppermute(t, m, "spatial", [(0, 3), (3, 0)]),
    }
    for name, shape in COLLECTIVES:
        xg = xr.clone().requires_grad_(True)
        with collectives.recording() as rec:
            yv = fns[name](xg, mesh(shape))
            wfull = torch.from_numpy(np.random.default_rng(200 + dist.get_rank()).normal(
                size=tuple(yv.shape)))
            value = torch.sum(wfull * yv)
        out["collective", name] = collectives.grad(rec, [value], [xg])[0].numpy()
    out["outside_recording"] = _caught(
        lambda: collectives.psum(xr.clone().requires_grad_(True), mesh((1, 4, 1)), "spatial"))
    # the sharded pads' gradients, float64
    field = torch.from_numpy(_pad_inputs())
    for shape, width in PAD_GRADS:
        m = mesh(shape)
        block = local_block(field, m).requires_grad_(True)
        pad = sharded_cs_pad if shape[2] == 1 else sharded_cs_pad_2d
        with collectives.recording() as rec:
            padded = pad(block, width, mesh=m)
            seed = torch.from_numpy(np.random.default_rng(300 + dist.get_rank()).normal(
                size=tuple(padded.shape)))
            value = torch.sum(seed * padded)
        out["pad_grad", shape, width] = collectives.grad(rec, [value], [block])[0].numpy()
    out["workdir"] = workdir
    return out


@pytest.fixture(scope="module")
def group(tmp_path_factory):
    results = spawn_group(_rank_cases, 4, str(tmp_path_factory.mktemp("trainer")),
                          workdir=tmp_path_factory.mktemp("ranks"))
    assert [r["rank"] for r in results] == [0, 1, 2, 3]
    return results


# ---- the reference ---------------------------------------------------------

def _flax_tree(params):
    """Port parameters by name (``convs.<scope>.<param>``) as the
    reference's flax tree."""
    tree = {}
    for name, p in params.items():
        _, scope, key = name.split(".")
        tree.setdefault(scope, {})[key] = np.asarray(p)
    return {"params": tree}


def _port_init(**kw):
    from dlwp_cs_tpu_torch.models import CubeSphereUNet, UNetConfig
    from dlwp_cs_tpu_torch.train import params_of

    return _numpy_params(params_of(CubeSphereUNet(
        UNetConfig(**dict(MODEL, **kw)), 3, device="cpu",
        generator=torch.Generator().manual_seed(0))))


@pytest.fixture(scope="module")
def jax_steps():
    """``run(cfg, loss, batches) -> (metrics, params)``: the JAX package's
    single-device train step (its 'xla' conv), from the port's seeded
    parameters, over the given global batches."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
    from dlwp_cs_tpu.models import TrainConfig as JTrainConfig
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
    from dlwp_cs_tpu.train import init_state, make_optimizer, make_train_step

    if len(jax.devices()) < 8:
        pytest.skip("needs 8 virtual JAX devices")
    apply = jax.jit(JUNet(JUNetConfig(**MODEL, conv_backend="xla")).apply)
    tree = _flax_tree(_port_init())

    def run(cfg, loss, batches):
        opt = make_optimizer(JTrainConfig(**cfg))
        state = init_state(jax.tree.map(jnp.asarray, tree), opt)
        step = make_train_step(apply, opt, loss, jit=False)
        for xb, yb in batches:
            state, m = step(state, jnp.asarray(xb), jnp.asarray(yb))
        return m, jax.tree.map(np.asarray, state.params)["params"]

    return run


def _assert_params(ours, ref, atol, what):
    for name, p in ours.items():
        _, scope, key = name.split(".")
        np.testing.assert_allclose(p, ref[scope][key], rtol=0, atol=atol,
                                   err_msg=f"{what}: {name}")


def _assert_bitwise_across_ranks(group, key, params_at=2):
    for r in group[1:]:
        for name, p in group[0][key][params_at].items():
            np.testing.assert_array_equal(r[key][params_at][name], p,
                                          err_msg=f"rank {r['rank']} {key} {name}")


# ---- data parallel ---------------------------------------------------------

@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
def test_dp_step_matches_reference(group, jax_steps, impl):
    """One data-parallel step on data = 4 (a block of 1 a rank) against the
    reference's single-device step: loss, gradient norm and parameters."""
    from dlwp_cs_tpu.ops import losses as jlosses

    x, y = _batches()[0]
    jm, ref = jax_steps(dict(learning_rate=1e-3), jlosses.mse, [(x, y)])
    for r in group:
        loss, gnorm, params = r["dp", impl]
        assert loss == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert gnorm == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        _assert_params(params, ref, 1e-5, f"rank {r['rank']}")
    _assert_bitwise_across_ranks(group, ("dp", impl))


def test_dp_shardmap_step_matches_the_references_shardmap_step(group):
    """The port's data-parallel step against the JAX package's own
    ``make_dp_shardmap_train_step`` on 4 CPU devices."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
    from dlwp_cs_tpu.models import TrainConfig as JTrainConfig
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
    from dlwp_cs_tpu.ops import losses as jlosses
    from dlwp_cs_tpu.parallel import create_mesh, shard_batch
    from dlwp_cs_tpu.parallel.sharding import make_dp_shardmap_train_step
    from dlwp_cs_tpu.train import init_state, make_optimizer

    x, y = _batches()[0]
    jmesh = create_mesh(data=4, spatial=1)
    opt = make_optimizer(JTrainConfig(learning_rate=1e-3))
    step = make_dp_shardmap_train_step(JUNet(JUNetConfig(**MODEL, conv_backend="xla")).apply,
                                       opt, jlosses.mse, jmesh)
    state, m = step(init_state(jax.tree.map(jnp.asarray, _flax_tree(_port_init())), opt),
                    *shard_batch((jnp.asarray(x), jnp.asarray(y)), jmesh))
    ref = jax.tree.map(np.asarray, state.params)["params"]
    for impl in ("gspmd", "shard_map"):
        loss, gnorm, params = group[0]["dp", impl]
        assert loss == pytest.approx(float(m["loss"]), rel=1e-5)
        assert gnorm == pytest.approx(float(m["grad_norm"]), rel=1e-4)
        _assert_params(params, ref, 1e-5, impl)


@pytest.mark.parametrize("impl", ["gspmd", "shard_map"])
def test_dp_scanned_and_eval_steps_match_reference(group, jax_steps, impl):
    """Two scanned data-parallel steps against two single-device steps; the
    eval step's loss against the reference's loss of the global batch."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
    from dlwp_cs_tpu.ops import losses as jlosses

    batches = _batches()
    jm, ref = jax_steps(dict(learning_rate=1e-3), jlosses.mse, batches)
    for r in group:
        losses, gnorms, params = r["dp_scanned", impl]
        assert losses.shape == (2,)
        assert float(losses[-1]) == pytest.approx(float(jm["loss"]), rel=1e-5)
        assert float(gnorms[-1]) == pytest.approx(float(jm["grad_norm"]), rel=1e-4)
        _assert_params(params, ref, 1e-5, f"rank {r['rank']}")
    _assert_bitwise_across_ranks(group, ("dp_scanned", impl))
    x, y = batches[0]
    tree = jax.tree.map(jnp.asarray, _flax_tree(_port_init()))
    want = float(jlosses.mse(JUNet(JUNetConfig(**MODEL, conv_backend="xla")).apply(
        tree, jnp.asarray(x)), jnp.asarray(y)))
    for r in group:
        assert r["dp_eval", impl] == pytest.approx(want, rel=1e-5)


# ---- the spatial step ------------------------------------------------------

@pytest.mark.parametrize("shape,kw", SPATIAL,
                         ids=[f"{s}-{'-'.join(map(str, k.values()))}" for s, k in SPATIAL])
def test_spatial_step_matches_reference(group, jax_steps, shape, kw):
    """The spatial step on bands and tiles, through every conv formulation
    and the block kernels' plain versions, against the reference's
    single-device step: loss ``rel=1e-4``, parameters ``atol=1e-4``;
    bitwise equal parameters on every rank."""
    from dlwp_cs_tpu.ops import losses as jlosses

    x, y = _batches()[0]
    jm, ref = jax_steps(dict(learning_rate=1e-3), jlosses.mse, [(x, y)])
    key = ("spatial", shape, tuple(kw.items()))
    for r in group:
        loss, _, params = r[key]
        assert loss == pytest.approx(float(jm["loss"]), rel=1e-4)
        _assert_params(params, ref, 1e-4, f"rank {r['rank']}")
    _assert_bitwise_across_ranks(group, key)
    # every rank issued the same number of collectives, the backward's included
    assert len({r["calls", shape, tuple(kw.items())] for r in group}) == 1


@pytest.mark.parametrize("shape,kw", WEIGHTED, ids=[str(s) for s, _ in WEIGHTED])
def test_area_weighted_spatial_step_matches_reference(group, jax_steps, shape, kw):
    """``local_terms`` sliced to each rank's rows (and columns): the sums of
    the shards' weighted error sums and weight sums give the single-device
    weighted loss and update."""
    from dlwp_cs_tpu.geometry import CubedSphere as JCubedSphere
    from dlwp_cs_tpu.ops import AreaWeightedLoss as JAreaWeightedLoss

    x, y = _batches()[0]
    jm, ref = jax_steps(dict(learning_rate=1e-3),
                        JAreaWeightedLoss("mse", JCubedSphere(N).area_weights), [(x, y)])
    for r in group:
        loss, _, params = r["weighted", shape]
        assert loss == pytest.approx(float(jm["loss"]), rel=1e-4)
        _assert_params(params, ref, 1e-4, f"rank {r['rank']}")
    _assert_bitwise_across_ranks(group, ("weighted", shape))


def test_multi_step_training_stays_equivalent(group, jax_steps):
    from dlwp_cs_tpu.ops import losses as jlosses

    x, _ = _batches()[0]
    jm, _ = jax_steps(dict(learning_rate=1e-2), jlosses.mse, [(x, 0.3 * x[..., :2])] * 3)
    for r in group:
        assert r["three_steps"][0] == pytest.approx(float(jm["loss"]), rel=1e-3)
    _assert_bitwise_across_ranks(group, "three_steps")


@pytest.mark.parametrize("shape,kw", SGD, ids=["dp", "band", "overlap", "tile"])
def test_every_parameter_gets_its_gradient(group, jax_steps, shape, kw):
    """One SGD step at learning rate 1 through the data-parallel step (the
    fused conv's autograd function) and through kernels #8, #11 and #9,
    whose forward is a launch with no ``grad_fn``: every parameter moved
    (its gradient is present and non-zero) and equals the reference's."""
    from dlwp_cs_tpu.ops import losses as jlosses

    x, y = _batches()[0]
    _, ref = jax_steps(dict(optimizer="sgd", learning_rate=1.0), jlosses.mse, [(x, y)])
    init = _port_init()
    key = ("sgd", shape, None if kw is None else tuple(kw.items()))
    for r in group:
        params = r[key][2]
        for name, p in params.items():
            assert np.abs(p - init[name]).max() > 0, f"{name} got no gradient"
        _assert_params(params, ref, 1e-6, f"rank {r['rank']}")
    _assert_bitwise_across_ranks(group, key)


def test_rdma_exchange_carries_no_gradient_as_in_the_reference(group):
    """Under ``band_impl='rdma'`` the band ring-fix conv differentiates the
    exchange itself: the reference's Pallas remote-copy kernel has no JVP
    and its step fails; the port's kernel #10 raises, saying so.  Through
    ``band_conv='pallas'`` both train (``test_spatial_step_matches_reference``)."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
    from dlwp_cs_tpu.models import TrainConfig as JTrainConfig
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
    from dlwp_cs_tpu.ops import losses as jlosses
    from dlwp_cs_tpu.parallel import create_mesh, make_spatial_train_step
    from dlwp_cs_tpu.train import init_state, make_optimizer

    x, y = _batches()[0]
    opt = make_optimizer(JTrainConfig(learning_rate=1e-3))
    step = make_spatial_train_step(JUNet(JUNetConfig(**MODEL)).apply, opt, jlosses.mse,
                                   create_mesh(data=1, spatial=2), band_impl="rdma_interpret",
                                   band_conv="ringfix")
    with pytest.raises(AssertionError):  # in pallas_call's JVP rule
        step(init_state(jax.tree.map(jnp.asarray, _flax_tree(_port_init())), opt),
             jnp.asarray(x), jnp.asarray(y))
    for r in group:
        kind, msg = r["rdma_ringfix"]
        assert kind == "NotImplementedError" and "carries no gradient" in msg, msg


@pytest.mark.parametrize("case", ["bad_batch_spatial", "bad_batch_trainer"])
def test_batch_the_data_axis_does_not_divide_raises(group, case):
    for r in group:
        got = r[case]
        assert got is not None and got[0] == "ValueError" and "does not split" in got[1], got


# ---- sequence training -----------------------------------------------------

@pytest.fixture(scope="module")
def jax_sequence_step():
    """``(metrics, params)`` of the reference's single-device sequence step
    from the port's seeded parameters."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.geometry import CubedSphere as JCubedSphere
    from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
    from dlwp_cs_tpu.models import DataConfig as JDataConfig
    from dlwp_cs_tpu.models import TrainConfig as JTrainConfig
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
    from dlwp_cs_tpu.train import (
        init_state,
        make_optimizer,
        make_sequence_loss,
        make_sequence_train_step,
    )
    from dlwp_cs_tpu_torch.models import CubeSphereUNet, DataConfig, UNetConfig
    from dlwp_cs_tpu_torch.train import params_of

    dcfg = JDataConfig(**DATA)
    window, t0, targets, consts = _sequence_batch()
    tree = _flax_tree(_numpy_params(params_of(CubeSphereUNet(
        UNetConfig(output_channels=dcfg.output_channels, filters=(4, 8)),
        DataConfig(**DATA).input_channels, device="cpu",
        generator=torch.Generator().manual_seed(0)))))
    model = JUNet(JUNetConfig(output_channels=dcfg.output_channels, filters=(4, 8),
                              conv_backend="xla"))
    lat, lon = JCubedSphere(N).cell_latlon
    opt = make_optimizer(JTrainConfig(learning_rate=1e-2))
    loss = make_sequence_loss(model.apply, dcfg, lat=lat, lon=lon, constants=consts,
                              sequence=SEQ, **INSOL)
    state, m = make_sequence_train_step(loss, opt)(
        init_state(jax.tree.map(jnp.asarray, tree), opt), jnp.asarray(window), jnp.asarray(t0),
        jnp.asarray(targets))
    return m, jax.tree.map(np.asarray, state.params)["params"]


@pytest.mark.parametrize("shape", SEQUENCE_MESHES, ids=str)
def test_sharded_sequence_step_matches_reference(group, jax_sequence_step, shape):
    """``make_sharded_sequence_train_step`` (per-tile insolation and
    constants) against the reference's single-device sequence step, as
    ``tests/test_sequence_training.py`` holds the reference's own."""
    m, ref = jax_sequence_step
    for r in group:
        value, _, params = r["sequence", shape]
        assert value == pytest.approx(float(m["loss"]), rel=1e-5)
        _assert_params(params, ref, 1e-4, f"rank {r['rank']}")
    _assert_bitwise_across_ranks(group, ("sequence", shape))


def test_example05_mesh_matches_one_process(group):
    """``examples/05_sequence_train --mesh 2x2``: every rank's per-step
    sequence losses against the one-process run of the example on the same
    store, from the same seeded parameters over the same batches
    (``rel=1e-5``, the sharded sequence step's tolerance)."""
    one = group[0]["example05", "one"]
    assert len(one) == EXAMPLE05["steps"] and all(np.isfinite(one))
    for r in group:
        assert r["example05", "one"] == one
        np.testing.assert_allclose(r["example05", "mesh"], one, rtol=1e-5, atol=0,
                                   err_msg=f"rank {r['rank']}")


# ---- the trainer -----------------------------------------------------------

def test_trainer_with_mesh_matches_reference(group):
    """``Trainer(mesh=create_mesh(data=4)).fit`` against the reference's
    ``Trainer(mesh=...)`` on 4 CPU devices, as ``tests/test_dp_trainer.py``;
    fed with global batches or with a prefetcher of each rank's blocks: the
    same run.  Rank 0 alone wrote the metrics and the checkpoints, and
    ``restore_or_init`` gives every rank the last checkpoint's state."""
    import jax
    import jax.numpy as jnp

    from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
    from dlwp_cs_tpu.models import TrainConfig as JTrainConfig
    from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
    from dlwp_cs_tpu.parallel import create_mesh
    from dlwp_cs_tpu.train import Trainer as JTrainer
    from dlwp_cs_tpu.train import init_state

    x, y = map(jnp.asarray, _trainer_data())
    cfg = JTrainConfig(learning_rate=1e-2, max_epochs=2)
    t_ref = JTrainer(JUNet(JUNetConfig(**dict(MODEL, filters=(4,)), conv_backend="xla")), cfg,
                     mesh=create_mesh(data=4, spatial=1))
    s_ref = t_ref.fit(init_state(jax.tree.map(jnp.asarray, _flax_tree(_port_init(filters=(4,)))),
                                 t_ref.optimizer), [(x, y)], val_data=[(x, y)], verbose=False)
    ref = jax.tree.map(np.asarray, s_ref.params)["params"]
    for r in group:
        t = r["trainer"]
        for epochs, params in ((t["epochs"], t["params"]), (t["fed_epochs"], t["fed_params"])):
            assert len(epochs) == len(t_ref.history.epochs) == 2
            for a, b in zip(epochs, t_ref.history.epochs):
                assert a["train_loss"] == pytest.approx(b["train_loss"], rel=1e-4)
                assert a["val_loss"] == pytest.approx(b["val_loss"], rel=1e-4)
            _assert_params(params, ref, 1e-5, f"rank {r['rank']}")
        for name, p in t["params"].items():
            np.testing.assert_array_equal(p, group[0]["trainer"]["params"][name])
            np.testing.assert_array_equal(t["restored"][name], p)
        assert t["restored_step"] == 2 and t["epochs_done"] == 2


def test_estimator_fit_with_mesh_matches_one_process(group):
    """``DLWPEstimator.fit(mesh=create_mesh(data=4))`` (each rank's
    prefetcher copies its block of the seeded shuffle's batches) against
    the one-process fit of the same store, itself held against the
    reference in ``tests/test_torch_train.py``: epoch losses 1e-5 relative,
    parameters 1e-5 absolute (two epochs of Adam at 1e-2, sums of 4 blocks
    in another order); serving runs the trained weights."""
    from dlwp_cs_tpu_torch.estimator import DLWPEstimator

    cfg, store = _estimator_case()
    one = DLWPEstimator(cfg, device="cpu").fit(store, val_store=store, verbose=False)
    for r in group:
        step, epochs, params, served = r["estimator"]
        assert step == one.state.step
        for a, b in zip(epochs, one._last_history.epochs):
            for key in ("train_loss", "val_loss"):
                assert a[key] == pytest.approx(b[key], rel=1e-5)
        for name, p in one.state.params.items():
            np.testing.assert_allclose(params[name], p.detach().numpy(), rtol=0, atol=1e-5)
            np.testing.assert_array_equal(served[name], params[name])
            np.testing.assert_array_equal(params[name], group[0]["estimator"][2][name])


def test_measure_scaling_runs_the_configurations_the_group_forms(group):
    """``measure_scaling`` on a group of 4: the one-device row on every
    rank, ``(4, 1)`` through the data-parallel step and ``(1, 4)`` through
    the spatial step; ``(2, 1)`` needs a mesh of 2 ranks, which the group
    cannot form, and is skipped.  The efficiency is against the one-device
    row, 1.0 there."""
    for r in group:
        rows = r["scaling"]
        assert [row.mesh_shape for row in rows] == [(1, 1), (4, 1), (1, 4)]
        assert [row.n_devices for row in rows] == [1, 4, 4]
        assert rows[0].efficiency_vs_single == 1.0
        for row in rows:
            assert row.step_seconds > 0 and np.isfinite(row.gridpoints_per_s)
            assert row.gridpoints_per_s_per_chip == pytest.approx(
                row.gridpoints_per_s / row.n_devices)
            assert row.efficiency_vs_single == pytest.approx(
                row.gridpoints_per_s_per_chip / rows[0].gridpoints_per_s_per_chip)


def test_trainer_with_mesh_writes_on_rank_0_only(group):
    import json
    from pathlib import Path

    root = Path(group[0]["workdir"])
    lines = [json.loads(ln) for ln in (root / "metrics.jsonl").read_text().splitlines()]
    # one writer: 2 epochs of 1 step each, and the epoch records, once
    assert [r["kind"] for r in lines] == ["step", "epoch", "step", "epoch"]
    assert any((root / "checkpoints").iterdir())


# ---- the collectives' gradients --------------------------------------------

def _gathered_gradient(name):
    """The single-process gradient of sum_r <w_r, f_r(x_0, .., x_3)> with
    respect to every rank's x, float64."""
    xs = [torch.from_numpy(_collective_inputs(r)[0]).requires_grad_(True) for r in range(4)]
    if name == "psum_2d":  # every rank in one 2 x 2 group
        outs = [sum(xs)] * 4
    elif name == "psum":
        outs = [sum(xs)] * 4
    elif name == "all_gather":
        outs = [torch.cat(xs, dim=1)] * 4
    elif name == "all_gather_stacked":
        outs = [torch.stack(xs, dim=0)] * 4
    elif name == "ppermute_ring":
        outs = [xs[(r - 1) % 4] for r in range(4)]
    else:  # the end pair {0 <-> 3}, zeros between
        outs = [xs[3], torch.zeros_like(xs[0]), torch.zeros_like(xs[0]), xs[0]]
    total = sum(torch.sum(torch.from_numpy(np.random.default_rng(200 + r).normal(
        size=tuple(o.shape))) * o) for r, o in enumerate(outs))
    grads = torch.autograd.grad(total, xs, allow_unused=True)
    return [np.zeros((2, 3)) if g is None else g.numpy() for g in grads]


@pytest.mark.parametrize("name,shape", COLLECTIVES, ids=[c for c, _ in COLLECTIVES])
def test_collective_backward_is_the_transpose(group, name, shape):
    """Each collective's backward, run on every rank, against the gradient
    of the gathered computation in one process (float64): the transposes
    (inverse permutation, the sum of the cotangents then the shard's slice,
    ``psum``) and nothing scaled by the shard count."""
    want = _gathered_gradient(name)
    for r in group:
        np.testing.assert_allclose(r["collective", name], want[r["rank"]], rtol=0, atol=1e-12)


def test_collective_differentiated_outside_a_recording_raises(group):
    for r in group:
        kind, msg = r["outside_recording"]
        assert kind == "RuntimeError" and "recording()" in msg, msg


@pytest.mark.parametrize("shape,width", PAD_GRADS, ids=[f"{s}-w{w}" for s, w in PAD_GRADS])
def test_sharded_pad_gradient_matches_the_gathered_pad(group, shape, width):
    """The sharded pads' gradients (every seam collective's transpose at
    once) against autograd through the single-device ``cs_pad`` of the
    gathered field, each rank's cotangent on its rows of the padded field:
    float64."""
    from dlwp_cs_tpu_torch.ops.padding import cs_pad

    _, sy, sx = shape
    h, wl = N // sy, N // sx
    field = torch.from_numpy(_pad_inputs()).requires_grad_(True)
    padded = cs_pad(field, width)
    total = 0.0
    for rank in range(4):  # rank = iy * sx + jx on a data = 1 mesh
        iy, jx = divmod(rank, sx)
        block = padded[:, :, iy * h: iy * h + h + 2 * width, jx * wl: jx * wl + wl + 2 * width]
        seed = torch.from_numpy(np.random.default_rng(300 + rank).normal(size=tuple(block.shape)))
        total = total + torch.sum(seed * block)
    (grad,) = torch.autograd.grad(total, field)
    for r in group:
        iy, jx = divmod(r["rank"], sx)
        want = grad[:, :, iy * h:(iy + 1) * h, jx * wl:(jx + 1) * wl].numpy()
        np.testing.assert_allclose(r["pad_grad", shape, width], want, rtol=0, atol=1e-12)
