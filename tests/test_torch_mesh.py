"""The port's mesh policy (``znicz_tpu_torch/parallel/mesh.py``) against the
JAX package's, on the CPU: ``parse_mesh_arg`` and ``resolve_mesh`` case for
case with tests/test_spmd.py, the backend chosen from the layout, the
Megatron layout of ``plan_tp_sharding`` against the reference's
``NamedSharding`` specs, and the counter RNG's shard form (dropout's mask,
the stochastic pools' uniforms) against the reference's draws over the
global batch, bit for bit."""

from __future__ import annotations

import numpy as np
import pytest
import torch
import torch.distributed as dist

from znicz_tpu.config import root as ref_root
from znicz_tpu.ops import dropout as ref_dropout
from znicz_tpu.ops import pooling as ref_pooling
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu.parallel import mesh as ref_mesh
from znicz_tpu.telemetry.registry import REGISTRY as REF_REGISTRY
from znicz_tpu_torch.config import root
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.ops import dropout, pooling, rngbits
from znicz_tpu_torch.parallel import distributed, elastic, fused, mesh
from znicz_tpu_torch.telemetry.registry import REGISTRY


def _gauge(registry) -> tuple:
    g = registry.gauge("mesh_axis_size")
    return (g.value(axis="data", site="train"),
            g.value(axis="model", site="train"))


@pytest.fixture
def one_rank():
    """A one-process gloo group on a loopback port, torn down after."""
    distributed.initialize(f"127.0.0.1:{elastic.free_port()}", 1, 0,
                           device="cpu")
    try:
        yield
    finally:
        distributed.shutdown()


# -- parse_mesh_arg / resolve_mesh (tests/test_spmd.py:91-128) ---------------
def test_1x1_and_none_degenerate_to_single_device():
    for shape in (None, (1, 1), "1,1"):
        assert mesh.resolve_mesh(shape) is None
        assert ref_mesh.resolve_mesh(shape) is None
    assert mesh.mesh_shape_of(None) == ref_mesh.mesh_shape_of(None) == (1, 1)


def test_string_and_tuple_forms_agree():
    assert mesh.parse_mesh_arg("4,2") == ref_mesh.parse_mesh_arg("4,2") \
        == (4, 2)
    errors = []
    for shape in ("2,1", (2, 1), [2]):
        with pytest.raises(ValueError, match="no process group") as e:
            mesh.resolve_mesh(shape, device="cpu")
        errors.append(str(e.value))
    assert len(set(errors)) == 1
    assert "--coordinator" in errors[0] and "torchrun" in errors[0] \
        and "parallel.elastic" in errors[0]


def test_single_number_means_pure_dp():
    assert mesh.parse_mesh_arg("8") == ref_mesh.parse_mesh_arg("8") == (8, 1)


def test_oversubscribed_mesh_refuses(one_rank):
    with pytest.raises(ValueError, match="devices"):
        ref_mesh.resolve_mesh((16, 2))
    with pytest.raises(ValueError, match="needs 4 ranks but the process "
                                         "group has 1"):
        mesh.resolve_mesh((2, 2), device="cpu")
    assert dist.get_backend() == "gloo"


def test_junk_rejected():
    for bad in ("", "a,b", "0,1", "1,2,3"):
        for parse in (mesh.parse_mesh_arg, ref_mesh.parse_mesh_arg):
            with pytest.raises(ValueError):
                parse(bad)
    for resolve in (mesh.resolve_mesh, ref_mesh.resolve_mesh):
        with pytest.raises(ValueError, match="mesh_shape"):
            resolve((4, 2, 2))


def test_launcher_mesh_lands_in_config():
    saved, ref_saved = (root.common.get("mesh_shape"),
                        ref_root.common.get("mesh_shape"))
    try:
        Launcher("znicz_tpu_torch.models.wine", device="cpu",
                 mesh="2,2").build()
        assert tuple(root.common.mesh_shape) == (2, 2)
    finally:
        root.common.mesh_shape = saved
        ref_root.common.mesh_shape = ref_saved


def test_gauge_restamps_as_the_reference():
    """A refused mesh leaves the gauges as they were; None and (1, 1)
    restamp them 1/1."""
    ref_mesh.resolve_mesh((2, 1))
    g = REGISTRY.gauge("mesh_axis_size")
    g.set(2, axis="data", site="train")       # as a live (2, 1) mesh leaves
    g.set(1, axis="model", site="train")
    assert _gauge(REF_REGISTRY) == _gauge(REGISTRY) == (2, 1)
    with pytest.raises(ValueError):
        ref_mesh.resolve_mesh((16, 2))
    with pytest.raises(ValueError):
        mesh.resolve_mesh((2, 1), device="cpu")
    assert _gauge(REF_REGISTRY) == _gauge(REGISTRY) == (2, 1)
    for shape in (None, (1, 1)):
        ref_mesh.resolve_mesh((2, 1))
        g.set(2, axis="data", site="train")
        ref_mesh.resolve_mesh(shape)
        mesh.resolve_mesh(shape)
        assert _gauge(REF_REGISTRY) == _gauge(REGISTRY) == (1, 1)


def test_a_1x1_mesh_is_the_meshless_trainer_bit_for_bit():
    spec = fused.ModelSpec((fused.LayerSpec(
        kind="fc", activation="linear", include_bias=True,
        hypers=(0.1, 0.0, 0.0, 0.9), hypers_bias=(0.1, 0.0, 0.0, 0.9)),),
        "softmax")
    gen = np.random.default_rng(5)
    params = [(torch.from_numpy(gen.standard_normal((6, 4)).astype(
        np.float32)), torch.zeros(4))]
    vels = [(torch.zeros(6, 4), torch.zeros(4))]
    x = torch.from_numpy(gen.standard_normal((32, 6)).astype(np.float32))
    y = torch.from_numpy(gen.integers(0, 4, 32).astype(np.int32))
    runs = []
    for mesh_shape in (None, (1, 1), "1,1"):
        tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                                device="cpu", mesh=mesh_shape)
        assert tr.mesh is None and tr.shard is None
        runs.append((tr.train_epoch(x, y, np.arange(32), 8)["loss"],
                     tr.params[0][0].numpy()))
    for loss, w in runs[1:]:
        np.testing.assert_array_equal(loss, runs[0][0])
        np.testing.assert_array_equal(w, runs[0][1])


def test_unit_graph_under_a_mesh_warns_and_runs_on_one_device(caplog):
    import logging

    from znicz_tpu_torch import prng
    from znicz_tpu_torch.models import mnist
    saved = root.mnist.synthetic.to_dict()
    try:
        root.mnist.synthetic.update({"n_train": 100, "n_valid": 20,
                                     "n_test": 0})
        prng.seed_all(3)
        wf = mnist.MnistWorkflow()
        wf.initialize(device="cpu")
        with caplog.at_level(logging.WARNING):
            wf.train(fused=False, mesh_shape=(2, 1), max_epochs=1)
    finally:
        root.mnist.synthetic.update(saved)
    assert "fused-path feature" in caplog.text
    assert len(wf.decision.epoch_metrics) == 1


# -- the backend --------------------------------------------------------------
@pytest.mark.parametrize("cards,world,want", [
    (0, 2, "gloo"), (1, 2, "gloo"), (1, 1, "nccl"), (2, 2, "nccl"),
    (4, 4, "nccl"), (2, 4, "gloo")])
def test_backend_follows_the_layout(monkeypatch, cards, world, want):
    monkeypatch.setattr(torch.cuda, "device_count", lambda: cards)
    assert mesh.choose_backend("cpu", world) == "gloo"
    if cards:
        assert mesh.choose_backend("cuda", world) == want
        assert [mesh.rank_device("cuda", r).index for r in range(world)] \
            == [r % cards for r in range(world)]
    assert mesh.rank_device("cpu", 3) == torch.device("cpu")


def test_initialize_needs_a_rendezvous_for_more_processes(monkeypatch):
    for k in ("MASTER_ADDR", "MASTER_PORT", "RANK", "WORLD_SIZE"):
        monkeypatch.delenv(k, raising=False)
    distributed.initialize(None)             # one process: a no-op
    assert not dist.is_initialized()
    assert distributed.process_shard(10) == slice(0, 10)
    with pytest.raises(ValueError, match="rendezvous"):
        distributed.initialize(num_processes=2, device="cpu")
    with pytest.raises(ValueError, match="num_processes"):
        distributed.initialize("127.0.0.1:1", device="cpu")


# -- the Megatron layout -------------------------------------------------
SHAPE_RUNS = {
    "mlp": [(784, 100), (100, 10)],
    "conv": [(3, 3, 3, 96), (5, 5, 96, 256), (3, 3, 256, 384),
             (3, 3, 384, 384), (3, 3, 384, 256), (9216, 4096), (4096, 4096),
             (4096, 1000)],
    "indivisible": [(8, 10), (10, 5), (5, 12), (12, 4)],
    "vector": [(10,), (6, 8), (8, 6)],
}


def _ref_dim(sharding) -> int | None:
    spec = tuple(sharding.spec)
    if "model" not in spec:
        return None
    return spec.index("model") - len(sharding.spec)


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("run", sorted(SHAPE_RUNS))
def test_plan_tp_sharding_splits_the_reference_dims(run, tp):
    ref = ref_mesh.make_mesh(n_data=8 // tp, n_model=tp)
    pidx = ref_pidx = 0
    for shape in SHAPE_RUNS[run]:
        dim, pidx = mesh.plan_tp_sharding(tp, pidx, shape)
        sh, ref_pidx = ref_mesh.plan_tp_sharding(ref, ref_pidx, shape)
        assert (dim, pidx) == (_ref_dim(sh), ref_pidx), shape
        if len(shape) >= 2:
            assert mesh.shard_params(tp, pidx, len(shape)) == _ref_dim(
                ref_mesh.shard_params(ref, ref_pidx, len(shape)))


def _ref_spec(layers, loss):
    return ref_fused.ModelSpec(tuple(ref_fused.LayerSpec(**la)
                                     for la in layers), loss)


def _layer(kind, include_bias=True, **cfg):
    return {"kind": kind, "activation": "linear",
            "include_bias": include_bias, "hypers": (0.1, 0.0, 0.0, 0.9),
            "hypers_bias": (0.1, 0.0, 0.0, 0.9),
            "config": tuple(sorted(cfg.items()))}


def _pairs(shapes, tied=()):
    gen = np.random.default_rng(0)
    params = [(None, None) if s is None or i in tied else
              (gen.standard_normal(s).astype(np.float32),
               np.zeros(s[-1], np.float32)) for i, s in enumerate(shapes)]
    return params, [tuple(None if a is None else np.zeros_like(a)
                          for a in p) for p in params]


LAYOUT_MODELS = {
    "alexnet": ([_layer("conv", stride=4, padding=0),
                 _layer("max_pool", ksize=3, stride=2, padding=0),
                 _layer("conv", stride=1, padding=2),
                 _layer("conv", stride=1, padding=1),
                 _layer("fc"), _layer("dropout", ratio=0.5, seed=1,
                                      unit_id=4),
                 _layer("fc"), _layer("fc")],
                [(11, 11, 3, 96), None, (5, 5, 96, 256), (3, 3, 256, 384),
                 (13 * 13 * 384, 4096), None, (4096, 4096), (4096, 1000)],
                "softmax", ()),
    "indivisible": ([_layer("fc"), _layer("fc"), _layer("fc")],
                    [(8, 10), (10, 5), (5, 6)], "softmax", ()),
    "tied_deconv": ([_layer("conv", stride=1, padding=1),
                     _layer("conv", stride=1, padding=1),
                     _layer("deconv", include_bias=False, stride=1,
                            padding=1, tie=0)],
                    [(3, 3, 1, 8), (3, 3, 8, 8), (3, 3, 1, 8)], "mse",
                    (2,)),
}


@pytest.mark.parametrize("tp", [2, 4])
@pytest.mark.parametrize("model", sorted(LAYOUT_MODELS))
def test_trainer_layout_is_the_reference_trainers(model, tp):
    """Each row's split dim in the port's trainer layout equals the
    reference FusedTrainer's weight sharding on a (8/tp, tp) mesh (a tied
    deconv's follows its encoder)."""
    layers, shapes, loss, tied = LAYOUT_MODELS[model]
    params, vels = _pairs(shapes, tied)
    ref = ref_fused.FusedTrainer(spec=_ref_spec(layers, loss),
                                 params=params, vels=vels,
                                 mesh=ref_mesh.make_mesh(8 // tp, tp))
    want = [None if sh is None else _ref_dim(sh)
            for sh, _ in ref._param_shardings]
    spec = fused.ModelSpec(tuple(fused.LayerSpec(**la) for la in layers),
                           loss)
    tparams = [tuple(None if a is None else torch.from_numpy(a) for a in p)
               for p in params]
    got = fused._tp_dims(spec, tparams, tp)
    assert got == want


# -- the counter RNG's shard form -------------------------------------------
SEED, COUNTERS, RATIO = 0x5EED, (3, 1, 256), 0.5


def _shard_masks(shape, dp, tp):
    """Each (data, model) rank's mask of its shard of ``shape``, by the
    port's offset form."""
    b, c = shape[0], shape[-1]
    feat = int(np.prod(shape[1:]))
    key = rngbits.fold(SEED, *COUNTERS)
    out = {}
    for d in range(dp):
        for m in range(tp):
            bl, k = b // dp, c // tp
            local = (bl,) + tuple(shape[1:-1]) + (k,)
            index = (d * bl * feat, k, c, m * k) if tp > 1 \
                else (d * bl * feat, feat, feat, 0)
            out[d, m] = dropout.mask_from_key(key, local, RATIO,
                                              index=index)
    return out


@pytest.mark.parametrize("shape,dp,tp", [
    ((128, 6, 6, 256), 2, 1), ((128, 4096), 2, 1), ((128, 6, 6, 256), 1, 2),
    ((128, 6, 6, 256), 2, 2), ((12, 5, 3, 8), 3, 4)])
def test_dropout_shard_mask_is_the_global_reference_mask(shape, dp, tp):
    want = ref_dropout.make_mask(SEED, COUNTERS, shape, RATIO, np)
    b, c = shape[0], shape[-1]
    for (d, m), got in _shard_masks(shape, dp, tp).items():
        sl = want[d * (b // dp):(d + 1) * (b // dp),
                  ..., m * (c // tp):(m + 1) * (c // tp)]
        np.testing.assert_array_equal(got.numpy(), sl)


def test_dropout_shard_forms_agree_and_default_is_the_whole():
    """The whole tensor's (0, n, n, 0) is the default's mask, and the op
    refuses a shard placement that is no shard of rows."""
    key = rngbits.fold(SEED, *COUNTERS)
    x = torch.from_numpy(np.random.default_rng(1).standard_normal(
        (8, 3, 3, 16)).astype(np.float32))
    n = x.numel()
    np.testing.assert_array_equal(
        dropout.dropout(x, key, RATIO, index=(0, n, n, 0)).numpy(),
        dropout.dropout(x, key, RATIO).numpy())
    for bad in ((0, 0, 16, 0), (0, 8, 16, 12), (0, 7, 16, 0)):
        with pytest.raises(ValueError, match="no shard"):
            dropout.dropout(x, key, RATIO, index=bad)


@pytest.mark.parametrize("dp,tp", [(2, 1), (1, 2), (2, 2)])
def test_stochastic_pool_shard_uniforms_are_the_global_draws(dp, tp):
    """The stochastic pools' uniforms of a shard (the pool output's rows
    of a data index, channels of a model index) are the reference's
    ``stochastic_uniform`` over the global output at those elements."""
    shape = (8, 4, 4, 12)
    want = np.asarray(ref_pooling.stochastic_uniform(SEED, COUNTERS,
                                                     shape))
    b, c = shape[0], shape[-1]
    feat = int(np.prod(shape[1:]))
    for d in range(dp):
        for m in range(tp):
            bl, k = b // dp, c // tp
            index = (d * bl * feat, k, c, m * k)
            got = pooling.stochastic_uniform(SEED, COUNTERS,
                                             (bl, 4, 4, k), "cpu", index)
            np.testing.assert_array_equal(
                got.numpy(), want[d * bl:(d + 1) * bl, ..., m * k:(m + 1) * k])
