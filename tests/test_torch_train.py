"""The port's training path against the JAX package: losses, the train
step's optimizer numerics, the series dataset, prefetching, checkpoints,
the trainer and the estimator.

The port's parameters come from its own seeded initialisation and are
carried to the reference as a flax tree, so both start equal.  The
reference model runs its pad-then-VALID ('xla') conv path, the port its
default path (the fused conv's autograd function on its plain versions):
the same linear map.  Tolerances:

* losses and metrics, float32: 1e-5 relative (the same sums of ~10^3
  terms, reduced in another order; measured 1.3e-6);
* train-step loss and grad_norm: 1e-5 relative (a U-Net forward and
  backward in another summation order);
* parameters after 3 steps: 1e-6 absolute for SGD; 2e-5 for the Adam
  family.  Adam normalizes its update, ``m / (sqrt(v) + eps)``, so a
  gradient entry near zero, whose last bits differ between the two
  frameworks, can move its parameter by up to +-lr either way: Adam
  magnifies rounding noise in tiny gradients to the learning rate's scale
  (measured here: 7e-8);
* the trainer's step and epoch losses (SGD): 1e-5 relative; its restored
  best parameters 1e-6 absolute;
* batches of the dataset: equal (the same numpy code).
"""

import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from dlwp_cs_tpu.data import MemoryStore as JMemoryStore
from dlwp_cs_tpu.data import SeriesDataset as JSeriesDataset
from dlwp_cs_tpu.models import CubeSphereUNet as JUNet
from dlwp_cs_tpu.models import TrainConfig as JTrainConfig
from dlwp_cs_tpu.models import UNetConfig as JUNetConfig
from dlwp_cs_tpu.ops import losses as jlosses
from dlwp_cs_tpu.train import Trainer as JTrainer
from dlwp_cs_tpu.train import init_state as j_init_state
from dlwp_cs_tpu.train import make_optimizer as j_make_optimizer
from dlwp_cs_tpu.train import make_train_step as j_make_train_step
from dlwp_cs_tpu_torch import DLWPEstimator
from dlwp_cs_tpu_torch.data import MemoryStore, SeriesDataset, prefetch_to_device
from dlwp_cs_tpu_torch.geometry.cubed_sphere import CubedSphere
from dlwp_cs_tpu_torch.models import (
    CubeSphereUNet,
    DataConfig,
    ExperimentConfig,
    UNetConfig,
    load_jax_params,
)
from dlwp_cs_tpu_torch.models.config import TrainConfig
from dlwp_cs_tpu_torch.ops import losses
from dlwp_cs_tpu_torch.train import (
    Trainer,
    init_state,
    make_optimizer,
    make_scanned_train_step,
    make_train_step,
    model_apply,
    params_of,
)
from dlwp_cs_tpu_torch.utils.checkpoint import (
    latest_step,
    restore_checkpoint,
    save_checkpoint,
)

# the suite runs its files in worker processes that share the host's cores:
# one intra-op thread each keeps them off each other's
torch.set_num_threads(1)

N = 8
MODEL = dict(output_channels=2, filters=(4, 8))


def _flax_tree(model):
    """The port model's parameters as the reference's flax tree (numpy)."""
    tree = {}
    for name, p in model.named_parameters():  # convs.<scope>.<param>
        _, scope, key = name.split(".")
        tree.setdefault(scope, {})[key] = p.detach().numpy().copy()
    return {"params": tree}


@pytest.fixture(scope="module")
def jax_apply():
    return jax.jit(JUNet(JUNetConfig(**MODEL, conv_backend="xla")).apply)


class _StubMesh:
    """A mesh as the port reads one (``mesh_dim_names``, ``shape``,
    ``get_local_rank``) at fixed coordinates, with no process group."""

    def __init__(self, sizes: dict, coords: dict):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())
        self._coords = coords

    def get_local_rank(self, name):
        return self._coords[name]


def _data(seed=0, steps=3, b=2):
    rng = np.random.default_rng(seed)
    x = rng.normal(size=(steps, b, 6, N, N, 3)).astype(np.float32)
    y = rng.normal(size=(steps, b, 6, N, N, 2)).astype(np.float32)
    return x, y


# -- losses -------------------------------------------------------------------


def test_losses_match_reference():
    rng = np.random.default_rng(0)
    p, t, clim = (rng.normal(size=(2, 6, N, N, 3)).astype(np.float32) for _ in range(3))
    w = CubedSphere(N).area_weights
    pt, tt, ct = map(torch.from_numpy, (p, t, clim))
    pj, tj, cj = map(jnp.asarray, (p, t, clim))
    pairs = [
        (losses.mse(pt, tt), jlosses.mse(pj, tj)),
        (losses.mae(pt, tt), jlosses.mae(pj, tj)),
        (losses.weighted_mse(pt, tt, w), jlosses.weighted_mse(pj, tj, w)),
        (losses.weighted_mae(pt, tt, w), jlosses.weighted_mae(pj, tj, w)),
        (losses.anomaly_correlation(pt, tt, ct), jlosses.anomaly_correlation(pj, tj, cj)),
        (losses.anomaly_correlation(pt, tt, ct, weights=w),
         jlosses.anomaly_correlation(pj, tj, cj, weights=w)),
    ]
    for base in ("mse", "mae"):
        ours, ref = losses.AreaWeightedLoss(base, w), jlosses.AreaWeightedLoss(base, w)
        pairs.append((ours(pt, tt), ref(pj, tj)))
        pairs += list(zip(ours.local_terms(pt, tt), ref.local_terms(pj, tj)))
    lats = np.linspace(-87.5, 87.5, 8)
    ll = rng.normal(size=(2, 2, 8, 16, 3)).astype(np.float32)
    for base in ("mse", "mae"):
        pairs.append((losses.latitude_weighted_loss(base, lats)(
            torch.from_numpy(ll), torch.zeros(ll.shape)),
            jlosses.latitude_weighted_loss(base, lats)(jnp.asarray(ll), jnp.zeros(ll.shape))))
    for ours, ref in pairs:
        np.testing.assert_allclose(ours.numpy(), np.asarray(ref), rtol=1e-5, atol=1e-7)
    np.testing.assert_array_equal(losses.latitude_weights(lats), jlosses.latitude_weights(lats))
    # whole faces need no slice, named axes or not; a band needs its axis
    # and the mesh to slice the weights by
    aw = losses.AreaWeightedLoss("mse", w)
    for a, b in zip(aw.local_terms(pt, tt, spatial_axis="spatial"), aw.local_terms(pt, tt)):
        torch.testing.assert_close(a, b, rtol=0, atol=0)
    with pytest.raises(ValueError, match="no spatial_axis"):
        aw.local_terms(pt[:, :, :4], tt[:, :, :4])
    with pytest.raises(ValueError, match="no spatial_x_axis"):
        aw.local_terms(pt[:, :, :, :4], tt[:, :, :, :4], spatial_axis="spatial")
    with pytest.raises(ValueError, match="needs the mesh"):
        aw.local_terms(pt[:, :, :4], tt[:, :, :4], spatial_axis="spatial")
    with pytest.raises(ValueError, match="base"):
        losses.AreaWeightedLoss("huber", w)


@pytest.mark.parametrize("sy,sx", [(4, 1), (2, 2), (1, 2)])
def test_local_terms_slice_weights_by_mesh_coordinates(sy, sx):
    """``local_terms`` on each block of a (sy, sx) tiling, its weights
    sliced by the (stub) mesh's coordinates, against the reference's under
    ``shard_map`` on sy * sx CPU devices; the blocks' sums are the whole
    field's."""
    from jax.sharding import PartitionSpec as P

    from dlwp_cs_tpu.parallel import create_mesh as j_create_mesh

    rng = np.random.default_rng(4)
    p, t = (rng.normal(size=(2, 6, N, N, 3)).astype(np.float32) for _ in range(2))
    w = CubedSphere(N).area_weights
    ref_loss = jlosses.AreaWeightedLoss("mae", w)
    names = ("spatial", "spatial_x") if sx > 1 else ("spatial",)
    spec = P(None, None, "spatial", "spatial_x" if sx > 1 else None, None)

    def terms(pl, tl):
        wsum, wtot = ref_loss.local_terms(pl, tl, spatial_axis="spatial",
                                          spatial_x_axis="spatial_x" if sx > 1 else None)
        return jnp.stack([wsum, wtot])[None]

    jmesh = j_create_mesh(data=1, spatial=sy, spatial_x=sx)
    ref = np.asarray(jax.jit(jax.shard_map(terms, mesh=jmesh, in_specs=(spec, spec),
                                           out_specs=P(names, None), check_vma=False))(
        jnp.asarray(p), jnp.asarray(t)))
    ours = losses.AreaWeightedLoss("mae", w)
    h, wl = N // sy, N // sx
    sums = np.zeros(2)
    for iy in range(sy):
        for jx in range(sx):
            mesh = _StubMesh({"data": 1, "spatial": sy, "spatial_x": sx},
                             {"spatial": iy, "spatial_x": jx})
            cut = (slice(None), slice(None), slice(iy * h, (iy + 1) * h), slice(jx * wl, (jx + 1) * wl))
            got = ours.local_terms(torch.from_numpy(p[cut]), torch.from_numpy(t[cut]),
                                   spatial_axis="spatial",
                                   spatial_x_axis="spatial_x" if sx > 1 else None, mesh=mesh)
            np.testing.assert_allclose([float(v) for v in got], ref[iy * sx + jx], rtol=1e-5)
            sums += [float(v) for v in got]
    whole = ours.local_terms(torch.from_numpy(p), torch.from_numpy(t))
    np.testing.assert_allclose(sums, [float(v) for v in whole], rtol=1e-5)


# -- train step ---------------------------------------------------------------


@pytest.mark.parametrize("kw", [
    dict(optimizer="adam"),
    dict(optimizer="adamw", weight_decay=0.1),
    dict(optimizer="sgd", learning_rate=1e-2),
    dict(optimizer="adam", lr_schedule="cosine", lr_decay_steps=2),
    dict(optimizer="adam", lr_schedule="warmup_cosine", lr_warmup_steps=1, lr_decay_steps=4),
    dict(optimizer="adam", grad_clip_norm=0.5),
    dict(optimizer="sgd", learning_rate=1e-2, grad_clip_norm=0.5),
    dict(optimizer="adam", grad_accum_steps=2),
], ids=["adam", "adamw", "sgd", "cosine", "warmup_cosine", "clip", "sgd_clip", "accum2"])
def test_train_step_matches_optax(kw, jax_apply):
    """Three steps of the port's make_train_step against the reference's,
    from the same parameters: loss, pre-clip grad_norm and parameters."""
    x, y = _data()
    tree = _flax_tree(CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu",
                                     generator=torch.Generator().manual_seed(0)))
    # the reference's parameter tree, carried into the port by load_jax_params
    model = load_jax_params(CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu"), tree)
    jopt = j_make_optimizer(JTrainConfig(**kw))
    jstate = j_init_state(jax.tree.map(jnp.asarray, tree), jopt)
    jstep = j_make_train_step(jax_apply, jopt, jlosses.mse, jit=False)
    opt = make_optimizer(TrainConfig(**kw))
    state = init_state(params_of(model), opt)
    step = make_train_step(model_apply(model), opt, losses.mse)
    for i in range(3):
        jstate, jm = jstep(jstate, jnp.asarray(x[i]), jnp.asarray(y[i]))
        state, m = step(state, torch.from_numpy(x[i]), torch.from_numpy(y[i]))
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    assert state.step == 3
    ref = jax.tree.map(np.asarray, jstate.params)["params"]
    atol = 1e-6 if kw["optimizer"] == "sgd" else 2e-5
    for name, p in state.params.items():
        _, scope, key = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), ref[scope][key], rtol=0,
                                   atol=atol, err_msg=name)


def test_grad_accum_holds_params_between_updates():
    x, y = _data(steps=2)
    model = CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu")
    opt = make_optimizer(TrainConfig(grad_accum_steps=2))
    state = init_state(params_of(model), opt)
    step = make_train_step(model_apply(model), opt, losses.mse)
    s1, _ = step(state, torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    for k, p in s1.params.items():
        torch.testing.assert_close(p, state.params[k], rtol=0, atol=0)
    assert s1.opt_state["inner"]["count"] == 0 and s1.opt_state["mini_step"] == 1
    s2, _ = step(s1, torch.from_numpy(x[1]), torch.from_numpy(y[1]))
    assert s2.opt_state["inner"]["count"] == 1 and s2.opt_state["gradient_step"] == 1
    assert any(not torch.equal(p, state.params[k]) for k, p in s2.params.items())


# -- data ---------------------------------------------------------------------


def _stores(t=14, n=N, seed=0):
    rng = np.random.default_rng(seed)
    fields = (rng.normal(size=(t, 6, n, n, 2)) * [3.0, 10.0] + [1.0, 280.0]).astype(np.float32)
    times = 9000.0 + 0.25 * np.arange(t)
    const = rng.normal(size=(6, n, n, 2)).astype(np.float32)
    kw = dict(variables=("a", "b"), constants=const, constant_names=("lsm", "orog"))
    return (MemoryStore.from_raw(fields, times, **kw),
            JMemoryStore.from_raw(fields, times, **kw))


@pytest.mark.parametrize("sequence", [None, 2])
def test_series_dataset_matches_reference(sequence):
    ours_store, ref_store = _stores()
    np.testing.assert_array_equal(ours_store.mean, ref_store.mean)
    dcfg = DataConfig(grid_n=N, variables=("a", "b"), constants=("orog",))
    lat, lon = CubedSphere(N).cell_latlon
    kw = dict(lat=lat, lon=lon, batch_size=3, shuffle=True, seed=5, sequence=sequence)
    ours = SeriesDataset(ours_store, dcfg, **kw)
    ref = JSeriesDataset(ref_store, dcfg, **kw)
    assert (ours.insol_mean, ours.insol_std) == (ref.insol_mean, ref.insol_std)
    assert len(ours) == len(ref) > 1
    for _ in range(2):  # two epochs: the shuffle order follows the seed
        for a, b in zip(ours, ref):
            for u, v in zip(a, b):
                np.testing.assert_array_equal(u, v)
    if sequence is None:
        x, _ = next(iter(ours))
        assert x.shape == (3, 6, N, N, dcfg.input_channels)


def test_prefetch_on_cpu_keeps_order_and_raises_errors():
    batches = [(np.full((2, 3), i, np.float32), np.full((2,), -i, np.float32))
               for i in range(5)]
    got = list(prefetch_to_device(iter(batches), device="cpu", depth=2))
    assert len(got) == 5
    for i, (a, b) in enumerate(got):
        assert isinstance(a, torch.Tensor) and float(a[0, 0]) == i and float(b[0]) == -i

    def broken():
        yield batches[0]
        raise OSError("disk gone")

    it = prefetch_to_device(broken(), device="cpu")
    next(it)
    with pytest.raises(OSError, match="disk gone"):
        next(it)
    # an abandoned iterator releases its thread
    it = prefetch_to_device(iter(batches * 10), device="cpu", depth=1)
    next(it)
    it.close()
    assert not it._thread.is_alive()
    with pytest.raises(StopIteration):
        next(it)
    # sharding=: this rank's block of every tensor (test_prefetch_copies_this_ranks_block)
    it = prefetch_to_device(iter(batches), device="cpu", sharding=_StubMesh({"data": 2}, {"data": 1}))
    assert [tuple(a.shape) for a, _ in it] == [(1, 3)] * 5


def test_prefetch_close_leaves_no_stale_batch(monkeypatch):
    """``next()`` after ``close()`` neither returns a batch nor blocks, even
    where the worker's last put lands after close's last drain: a queue
    whose empty ``get_nowait`` stalls 0.25 s (a closing thread descheduled
    there) lets the blocked put of the next batch complete in that window,
    and the worker's sentinel then gives up on the full queue."""
    import queue
    import threading
    import time

    from dlwp_cs_tpu_torch.data import prefetch as prefetch_mod

    class StallingQueue(queue.Queue):
        def get_nowait(self):
            with self.mutex:
                empty = not self._qsize()
            if empty:
                time.sleep(0.25)
                raise queue.Empty
            return super().get_nowait()

    monkeypatch.setattr(prefetch_mod.queue, "Queue", StallingQueue)
    batches = ((np.full((2, 3), i, np.float32),) for i in range(100))
    it = prefetch_to_device(batches, device="cpu", depth=1)
    time.sleep(0.2)  # the worker filled the queue and blocks on its next put
    it.close()
    assert not it._thread.is_alive()
    outcomes = []

    def consume():
        for _ in range(2):
            try:
                outcomes.append(next(it))
            except StopIteration:
                outcomes.append("stop")

    reader = threading.Thread(target=consume, daemon=True)
    reader.start()
    reader.join(timeout=5.0)
    assert not reader.is_alive(), f"next() after close() blocked after {outcomes}"
    assert outcomes == ["stop", "stop"]


def test_prefetch_copies_this_ranks_block():
    """``prefetch_to_device(sharding=mesh)``: the batch axis over ``data``
    and, with ``spatial``, the face rows and columns of every ``(B, 6, n,
    n, C)`` tensor, as ``shard_batch`` cuts them; other tensors keep their
    other axes."""
    from dlwp_cs_tpu_torch.parallel import shard_batch

    rng = np.random.default_rng(1)
    x = rng.normal(size=(4, 6, N, N, 3)).astype(np.float32)
    t0 = np.arange(4, dtype=np.float32)
    mesh = _StubMesh({"data": 2, "spatial": 2, "spatial_x": 2},
                     {"data": 1, "spatial": 0, "spatial_x": 1})
    for spatial in (False, True):
        it = prefetch_to_device(iter([(x, t0), {"x": x}]), device="cpu", sharding=mesh,
                                spatial=spatial)
        (xb, tb), d = list(it)
        want = shard_batch(torch.from_numpy(x), mesh, spatial=spatial)
        torch.testing.assert_close(xb, want, rtol=0, atol=0)
        torch.testing.assert_close(d["x"], want, rtol=0, atol=0)
        torch.testing.assert_close(tb, torch.tensor([2.0, 3.0]), rtol=0, atol=0)
        assert it.sharding is mesh and it.spatial is spatial


SEQ_DATA = dict(grid_n=N, variables=("a", "b"), input_time_steps=2, output_time_steps=2,
                add_insolation=True, constants=())


def test_sequence_loss_and_step_match_reference():
    """``make_sequence_loss`` and two steps of ``make_sequence_train_step``
    on a sequence batch of the port's ``SeriesDataset`` against the
    reference's (the window advance and the insolation clock of
    ``data/channels.py``): loss and grad norm 1e-5 relative, parameters
    2e-5 (Adam, as ``test_train_step_matches_optax``)."""
    from dlwp_cs_tpu.models import DataConfig as JDataConfig
    from dlwp_cs_tpu.train import make_sequence_loss as j_make_sequence_loss
    from dlwp_cs_tpu.train import make_sequence_train_step as j_make_sequence_train_step
    from dlwp_cs_tpu_torch.train import make_sequence_loss, make_sequence_train_step

    dcfg = DataConfig(**SEQ_DATA)
    rng = np.random.default_rng(5)
    store = MemoryStore.from_raw(rng.normal(size=(30, 6, N, N, 2)).astype(np.float32),
                                 9000.0 + 0.25 * np.arange(30), ("a", "b"))
    lat, lon = CubedSphere(N).cell_latlon
    ds = SeriesDataset(store, dcfg, lat=lat, lon=lon, batch_size=3, sequence=3)
    window, targets, t0 = ds.make_batch(np.array([0, 5, 9]))
    model = CubeSphereUNet(UNetConfig(output_channels=dcfg.output_channels, filters=(4, 8)),
                           dcfg.input_channels, device="cpu",
                           generator=torch.Generator().manual_seed(0))
    tree = _flax_tree(model)
    jmodel = JUNet(JUNetConfig(output_channels=dcfg.output_channels, filters=(4, 8),
                               conv_backend="xla"))
    kw = dict(lat=lat, lon=lon, insol_mean=300.0, insol_std=400.0, sequence=3)
    jloss = j_make_sequence_loss(jmodel.apply, JDataConfig(**SEQ_DATA), **kw)
    loss = make_sequence_loss(model_apply(model), dcfg, **kw)
    jargs = tuple(map(jnp.asarray, (window, t0, targets)))
    args = tuple(map(torch.from_numpy, (window, t0, targets)))
    jtree = jax.tree.map(jnp.asarray, tree)
    with torch.no_grad():
        value = float(loss(params_of(model), *args))
    with pytest.raises(ValueError, match="sequence=3"):
        loss(params_of(model), args[0], args[1], args[2][:, :2])
    jopt = j_make_optimizer(JTrainConfig(learning_rate=1e-2))
    opt = make_optimizer(TrainConfig(learning_rate=1e-2))
    jstate = j_init_state(jax.tree.map(jnp.copy, jtree), jopt)  # the step donates it
    state = init_state(params_of(model), opt)
    jstep = j_make_sequence_train_step(jloss, jopt)
    step = make_sequence_train_step(loss, opt)
    for i in range(2):
        jstate, jm = jstep(jstate, *jargs)
        if i == 0:  # the reference's loss at the initial parameters (one compile: the step's)
            np.testing.assert_allclose(value, float(jm["loss"]), rtol=1e-5)
        state, m = step(state, *args)
        for key in ("loss", "grad_norm"):
            np.testing.assert_allclose(float(m[key]), float(jm[key]), rtol=1e-5)
    ref = jax.tree.map(np.asarray, jstate.params)["params"]
    for name, p in state.params.items():
        _, scope, key = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), ref[scope][key], rtol=0, atol=2e-5,
                                   err_msg=name)


# -- checkpoints --------------------------------------------------------------


def test_checkpoint_roundtrip_and_partial_dirs(tmp_path):
    model = CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu")
    opt = make_optimizer(TrainConfig())
    state = init_state(params_of(model), opt)
    x, y = _data(steps=1)
    state, _ = make_train_step(model_apply(model), opt, losses.mse)(
        state, torch.from_numpy(x[0]), torch.from_numpy(y[0]))
    save_checkpoint(tmp_path, state, step=1, extras={"ok": 1})
    save_checkpoint(tmp_path, state, step=1, extras={"ok": 2})  # overwrite
    # what a crash mid-write leaves: a temporary dir, and a step dir with no state
    (tmp_path / ".step_7.tmp-99").mkdir()
    (tmp_path / "step_9").mkdir()
    (tmp_path / "step_9" / "extras.json").write_text("{}")
    assert latest_step(tmp_path) == 1
    template = init_state(params_of(model), opt)
    restored, extras = restore_checkpoint(tmp_path, template)
    assert extras == {"ok": 2} and restored.step == 1
    assert restored.opt_state["count"] == 1
    for k, p in state.params.items():
        torch.testing.assert_close(restored.params[k], p, rtol=0, atol=0)
        assert restored.params[k].requires_grad
        torch.testing.assert_close(restored.opt_state["mu"][k], state.opt_state["mu"][k],
                                   rtol=0, atol=0)


# -- trainer ------------------------------------------------------------------


def _train_setup():
    rng = np.random.default_rng(0)
    x, x2, xv = (rng.normal(size=(2, 6, N, N, 3)).astype(np.float32) for _ in range(3))
    yv = rng.normal(size=(2, 6, N, N, 2)).astype(np.float32)
    train = [(x, 0.5 * x[..., :2]), (x2, 0.5 * x2[..., :2])]
    # the validation loss rises after the first epoch: early stopping at
    # epoch 2 (patience 2) and a best-weights restore of epoch 0.  SGD:
    # Adam would turn rounding noise in near-zero gradients into +-lr steps
    # (module docstring), which over several epochs leaves the two
    # frameworks' loss curves apart by more than rounding
    cfg = dict(optimizer="sgd", learning_rate=1.0, max_epochs=6, early_stopping_patience=2,
               min_epochs=2, metrics_every=3, checkpoint_every_epochs=1)
    return train, [(xv, yv)], cfg


def test_trainer_matches_reference(jax_apply):
    train, val, cfg = _train_setup()
    model = CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu")
    trainer = Trainer(model, TrainConfig(**cfg))
    state = trainer.init(train[0][0])
    tree = _flax_tree(CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu",
                                     generator=torch.Generator().manual_seed(0)))
    for name, p in state.params.items():  # init() draws from cfg.seed = 0
        _, scope, key = name.split(".")
        np.testing.assert_array_equal(p.detach().numpy(), tree["params"][scope][key])
    state = trainer.fit(state, train, val_data=val, verbose=False)

    jmodel = JUNet(JUNetConfig(**MODEL, conv_backend="xla"))
    jtrainer = JTrainer(jmodel, JTrainConfig(**cfg))
    jstate = j_init_state(jax.tree.map(jnp.asarray, tree), jtrainer.optimizer)
    jstate = jtrainer.fit(jstate, [tuple(map(jnp.asarray, b)) for b in train],
                          val_data=[tuple(map(jnp.asarray, b)) for b in val], verbose=False)

    ours, ref = trainer.history, jtrainer.history
    assert [r["epoch"] for r in ours.epochs] == [r["epoch"] for r in ref.epochs] == [0, 1, 2]
    for key in ("train_loss", "val_loss"):
        np.testing.assert_allclose([r[key] for r in ours.epochs],
                                   [r[key] for r in ref.epochs], rtol=1e-5)
    np.testing.assert_allclose([r["loss"] for r in ours.steps],
                               [r["loss"] for r in ref.steps], rtol=1e-5)
    assert trainer.stopper.best == pytest.approx(jtrainer.stopper.best, rel=1e-5)
    # both restored the best (epoch 0) weights
    best = jax.tree.map(np.asarray, jstate.params)["params"]
    for name, p in state.params.items():
        _, scope, key = name.split(".")
        np.testing.assert_allclose(p.detach().numpy(), best[scope][key], rtol=0, atol=1e-6)
    val_now = float(trainer.eval_step(state.params, *map(torch.from_numpy, val[0]))["loss"])
    assert val_now == pytest.approx(ours.epochs[0]["val_loss"], rel=1e-6)


def test_resumed_run_ends_where_the_uninterrupted_run_does(tmp_path):
    train, val, cfg = _train_setup()
    cfg = dict(cfg, early_stopping_patience=10, max_epochs=3)

    def trainer(workdir):
        return Trainer(CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu"),
                       TrainConfig(**cfg), workdir=workdir)

    full = trainer(tmp_path / "full")
    s_full = full.fit(full.restore_or_init(train[0][0]), train, val_data=val, verbose=False)

    first = trainer(tmp_path / "cut")
    first.fit(first.restore_or_init(train[0][0]), train, val_data=val, epochs=1,
              verbose=False)  # the "crash" after one epoch
    assert latest_step(tmp_path / "cut" / "checkpoints") == 2
    second = trainer(tmp_path / "cut")
    resumed = second.restore_or_init(train[0][0])
    assert resumed.step == 2 and second._epochs_done == 1
    s_cut = second.fit(resumed, train, val_data=val, verbose=False)
    assert [r["epoch"] for r in second.history.epochs] == [1, 2]
    assert s_cut.step == s_full.step == 6
    assert second.stopper.best == full.stopper.best
    for k, p in s_full.params.items():
        torch.testing.assert_close(s_cut.params[k], p, rtol=0, atol=0)
    for t in (full, first, second):
        t.close()


def test_trainer_rejects_mesh_and_profiles(tmp_path):
    """A data-parallel step the reference does not have raises (training
    under a mesh: ``tests/test_torch_parallel_train.py``); the profiler
    window writes a trace."""
    model = CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu")
    with pytest.raises(ValueError, match="dp_impl"):
        Trainer(model, TrainConfig(), dp_impl="pmap")
    train, _, _ = _train_setup()
    t = Trainer(model, TrainConfig(max_epochs=1), workdir=tmp_path, profile_steps=(0, 0))
    t.fit(t.init(train[0][0]), train, verbose=False)
    t.close()
    assert (tmp_path / "profile" / "trace.json").exists()
    assert len(t.history.steps) == 2 and (tmp_path / "metrics.jsonl").exists()


# -- estimator ----------------------------------------------------------------


def test_estimator_fit_save_load(tmp_path):
    store, _ = _stores(t=12)
    cfg = ExperimentConfig(
        data=DataConfig(grid_n=N, variables=("a", "b"), constants=("lsm", "orog")),
        model=UNetConfig(filters=(4, 8)),
        train=TrainConfig(batch_size=2, max_epochs=2, learning_rate=1e-2),
    )
    est = DLWPEstimator(cfg, device="cpu").fit(store, val_store=store, verbose=False)
    assert est.state.step == 2 * (9 // 2)
    assert len(est._last_history.epochs) == 2
    # serving runs the trained weights
    for name, p in est.model.named_parameters():
        torch.testing.assert_close(p, est.state.params[name].detach(), rtol=0, atol=0)
    est.save(tmp_path / "model")
    back = DLWPEstimator.load(tmp_path / "model", device="cpu")
    assert back.config == est.config and back.state.step == est.state.step
    np.testing.assert_array_equal(back.stats["mean"], est.stats["mean"])
    assert back.stats["insol_std"] == est.stats["insol_std"]
    for name, p in back.model.named_parameters():
        torch.testing.assert_close(p, est.state.params[name].detach(), rtol=0, atol=0)
    # training goes on from the loaded state
    back.fit(store, epochs=1, verbose=False)
    assert back.state.step == est.state.step + 4
    with pytest.raises(RuntimeError, match="fit or load"):
        DLWPEstimator(cfg, device="cpu").save(tmp_path / "none")
    bad = dataclasses.replace(cfg, data=dataclasses.replace(cfg.data, step_hours=3.0))
    with pytest.raises(ValueError, match="step_hours"):
        DLWPEstimator(bad, device="cpu").fit(store, verbose=False)


def test_fused_steps_equal_single_steps():
    """A Trainer configured with ``fused_steps=k`` ends where single steps
    do, and ``make_scanned_train_step`` over k stacked batches equals k
    ``make_train_step`` calls, bitwise."""
    train, _, cfg = _train_setup()
    train = train + train[:1]  # 3 batches: a k=2 window and a tail
    runs = []
    for fused in (1, 2):
        t = Trainer(CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu"),
                    TrainConfig(**dict(cfg, max_epochs=1, fused_steps=fused)))
        runs.append((t.fit(t.init(train[0][0]), train, verbose=False), t.history))
    (s1, h1), (s2, h2) = runs
    assert s1.step == s2.step == 3
    assert [r["step"] for r in h2.steps] == [0, 1, 2]
    np.testing.assert_allclose([r["loss"] for r in h2.steps], [r["loss"] for r in h1.steps],
                               rtol=0, atol=0)
    for k, p in s1.params.items():
        torch.testing.assert_close(s2.params[k], p, rtol=0, atol=0)

    model = CubeSphereUNet(UNetConfig(**MODEL), 3, device="cpu")
    opt = make_optimizer(TrainConfig(**dict(cfg, optimizer="adam", learning_rate=1e-3)))
    x, y = _data(steps=2)
    single = make_train_step(model_apply(model), opt, losses.mse)
    scanned = make_scanned_train_step(model_apply(model), opt, losses.mse)
    s_one = init_state(params_of(model), opt)
    ms = []
    for i in range(2):
        s_one, m = single(s_one, torch.from_numpy(x[i]), torch.from_numpy(y[i]))
        ms.append(m)
    s_k, mk = scanned(init_state(params_of(model), opt),
                      torch.from_numpy(x), torch.from_numpy(y))
    assert s_k.step == s_one.step == 2 and mk["loss"].shape == (2,)
    for key in ("loss", "grad_norm"):
        torch.testing.assert_close(mk[key], torch.stack([m[key] for m in ms]), rtol=0, atol=0)
    for k, p in s_one.params.items():
        torch.testing.assert_close(s_k.params[k], p, rtol=0, atol=0)
