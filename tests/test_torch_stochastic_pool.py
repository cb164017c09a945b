"""Stochastic pooling in the port (``ops/pooling.py``, ``nn/pooling.py``,
``nn/gd_pooling.py``, the fused kinds ``stochastic_pool`` and
``stochastic_abs_pool``) and the device form of the counter RNG's fold
(``ops/rngbits.py`` ``fold_t``), against the JAX package on the CPU:

* ``stochastic_uniform`` and the pool's train and eval forms bit for bit
  the reference's numpy and XLA tiers, at tests/test_ops_conv.py:201-216's
  case and at ragged, padded, signed and all-zero windows, with max(x, 0)
  and |x| weights;
* ``fold_t`` over counters held in int64 and int32 tensors (the plan
  rows' bit views), near 2³² too, equal to the host ``fold``;
* a small conv net with a stochastic and a stochastic-abs pool: its unit
  graph driven over an epoch's minibatches as tests/test_fused_conv.py
  drives the reference's, the weights held to the reference's unit graph
  at rtol 5e-4 / atol 1e-5, and its evaluation forms equal; its fused
  spec (the reference's ``extract_model`` configs: unit id and stream
  seed) trained by the port's ``FusedTrainer`` against the reference's,
  and the plan-fed step (the captured one, run eagerly here) bit for bit
  the eager one; ``run`` of the CIFAR sample with its max pool made
  stochastic, both paths, against the reference's epoch-0 metrics."""

import dataclasses
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu.ops import pooling as ref_pool
from znicz_tpu.ops import rngbits as ref_rngbits
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.models import cifar
from znicz_tpu_torch.ops import pooling, rngbits
from znicz_tpu_torch.parallel import capture, fused

SPLIT = {"n_train": 200, "n_valid": 80, "n_test": 80, "noise": 0.3,
         "size": 16}
RTOL, ATOL = 5e-4, 1e-5
LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 8, "kx": 3, "padding": 1},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "stochastic_pooling", "->": {"kx": 2}},
    {"type": "conv_tanh", "->": {"n_kernels": 8, "kx": 3},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "stochastic_abs_pooling", "->": {"kx": 3, "sliding": 2,
                                              "padding": 1}},
    {"type": "all2all_tanh", "->": {"output_sample_shape": 24},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def split():
    trees = (ref_root.cifar, root.cifar)
    saved = [(t.synthetic.to_dict(), t.get("minibatch_size"),
              t.get("layers")) for t in trees]
    for t in trees:
        t.synthetic.update(SPLIT)
        t.minibatch_size = 40
    yield
    for t, (syn, mb, layers) in zip(trees, saved):
        t.synthetic.update(syn)
        t.minibatch_size = mb
        t.layers = layers


# -- the ops ----------------------------------------------------------------
def _input(case: str, rng):
    shape, window = {"reference": ((2, 8, 8, 3), (2, 2, 0)),
                     "ragged": ((2, 7, 9, 5), (3, 2, 0)),
                     "padded": ((3, 6, 6, 4), (3, 2, 1)),
                     "signed": ((2, 8, 6, 3), (2, 1, 0)),
                     "all_zero": ((2, 8, 8, 4), (2, 2, 0))}[case]
    x = rng.normal(size=shape).astype(np.float32)
    if case in ("reference", "all_zero"):
        x = np.abs(x)
    if case == "all_zero":
        x[:, :4, :4, :] = 0.0        # whole windows with no weight
    return x, window


@pytest.mark.parametrize("counters", [(1, 2, 3), (0, 0, 0),
                                      (2 ** 32 - 1, 7, 2 ** 32 - 5)])
def test_stochastic_uniform_matches_reference(counters):
    shape = (2, 4, 4, 3)
    want = ref_pool.stochastic_uniform(42, counters, shape, xp=np)
    np.testing.assert_array_equal(np.asarray(ref_pool.stochastic_uniform(
        42, counters, shape, xp=jnp)), want)
    got = pooling.stochastic_uniform(42, counters, shape)
    assert got.dtype == torch.float32
    np.testing.assert_array_equal(got.numpy(), want)
    # the counters as device words: the same bits
    dev = pooling.stochastic_uniform(
        42, (counters[0], torch.tensor([counters[1]]),
             torch.tensor([counters[2]], dtype=torch.int64)), shape)
    np.testing.assert_array_equal(dev.numpy(), want)


@pytest.mark.parametrize("case", ["reference", "ragged", "padded",
                                  "signed", "all_zero"])
@pytest.mark.parametrize("use_abs", [False, True])
@pytest.mark.parametrize("deterministic", [False, True])
def test_pool_forms_match_reference(case, use_abs, deterministic):
    x, (k, s, p) = _input(case, np.random.default_rng(8))
    oshape = pooling.pool_out_shape(x.shape, k, s, p)
    u = ref_pool.stochastic_uniform(42, (1, 2, 3), oshape, xp=np)
    kw = dict(use_abs=use_abs, deterministic=deterministic)
    y_np, i_np = ref_pool.np_stochastic_pooling(
        x, k, s, p, None if deterministic else u, **kw)
    y_x, i_x = ref_pool.xla_stochastic_pooling(
        jnp.asarray(x), k, s, p, None if deterministic else jnp.asarray(u),
        **kw)
    y, i = pooling.stochastic_pooling(
        torch.from_numpy(x), k, s, p,
        None if deterministic else torch.from_numpy(u), **kw)
    assert y.dtype == torch.float32 and i.dtype == torch.int32
    for want_y, want_i in ((y_np, i_np), (np.asarray(y_x), np.asarray(i_x))):
        np.testing.assert_array_equal(y.numpy(), want_y)
        np.testing.assert_array_equal(i.numpy(), want_i)
    g_y, g_i = pooling.np_stochastic_pooling(
        x, k, s, p, None if deterministic else u, **kw)
    np.testing.assert_array_equal(g_y, y_np)
    np.testing.assert_array_equal(g_i, i_np)
    if case == "all_zero" and not deterministic:
        # a window without weight takes no tap: 0 and slot 0
        assert (y.numpy()[:, :2, :2, :] == 0).all()
        assert (i.numpy()[:, :2, :2, :] == 0).all()


def test_pool_refuses_missing_uniforms():
    x = torch.ones((1, 4, 4, 2))
    with pytest.raises(ValueError, match="u must be"):
        pooling.stochastic_pooling(x, 2)
    with pytest.raises(ValueError, match="u must be"):
        pooling.stochastic_pooling(x, 2, u=torch.zeros((1, 3, 3, 2)))


def test_device_fold_matches_host_fold():
    rng = np.random.default_rng(21)
    seeds = rng.integers(0, 2 ** 63, 64, dtype=np.int64)
    ctrs = rng.integers(0, 2 ** 32, (64, 3), dtype=np.int64)
    ctrs[:8] = 2 ** 32 - 1 - np.arange(24).reshape(8, 3)   # near 2³²
    for seed, (a, b, c) in zip(seeds, ctrs):
        want = ref_rngbits.fold(int(seed), int(a), int(b), int(c))
        assert rngbits.fold(int(seed), a, b, c) == int(want)
        # int64 words, and int32 words holding the uint32 bits (the plan
        # rows' view): the same key
        i32 = torch.from_numpy(np.array([b, c], np.uint32).view(np.int32))
        for words in (torch.tensor([b, c], dtype=torch.int64), i32):
            got = rngbits.fold_t(int(seed), int(a), words[0:1], words[1:2])
            assert isinstance(got, torch.Tensor) and int(got) == int(want)
        # a leading tensor counter too
        got = rngbits.fold_t(int(seed), torch.tensor([a]), int(b), int(c))
        assert int(got) == int(want)
    assert isinstance(rngbits.fold_t(5, 1, 2, 3), int)


# -- the units and the fused kinds -------------------------------------------
def _workflows(layers=LAYERS):
    ref_prng.seed_all(1234)
    ref_wf = ref_cifar.CifarWorkflow(layers=layers)
    ref_wf.initialize(device=Device.create("xla"))
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow(layers=layers)
    wf.initialize(device="cpu")
    return ref_wf, wf


def _drive(wf, idx, klass=TRAIN, gd=True):
    """tests/test_fused_conv.py's ``_drive_graph``: the minibatches of
    ``idx`` in order, the loader's counters set as the tick loop sets
    them; returns the last minibatch's pool outputs."""
    ld = wf.loader
    n = len(idx)
    outs = []
    for off in range(0, n, ld.max_minibatch_size):
        mb = idx[off:off + ld.max_minibatch_size]
        ld.minibatch_class = klass
        ld.minibatch_size = len(mb)
        ld.minibatch_offset = min(off + ld.max_minibatch_size, n)
        ld.fill_minibatch(mb, klass)
        for f in wf.forwards:
            f.run()
        wf.evaluator.run()
        if gd:
            for g in reversed(wf.gds):
                g.run()
        outs = [(np.asarray(wf.forwards[i].output.mem).copy(),
                 np.asarray(wf.forwards[i].input_offset.mem).copy())
                for i in (1, 3)]
    return outs


def test_units_match_reference_unit_graph(split):
    ref_wf, wf = _workflows()
    assert [type(f).__name__ for f in wf.forwards] == [
        type(f).__name__ for f in ref_wf.forwards]
    assert [type(g).__name__ for g in wf.gds] == [
        type(g).__name__ for g in ref_wf.gds]
    for rf, f in zip(ref_wf.forwards, wf.forwards):
        if hasattr(rf, "unit_id"):
            assert (f.unit_id, f.rng.stream_seed) == (rf.unit_id,
                                                      rf.rng.stream_seed)
    n0, n1, n2 = wf.loader.class_lengths
    train = np.arange(n0 + n1, n0 + n1 + n2)
    got = _drive(wf, train)
    want = _drive(ref_wf, train)
    for (gy, gi), (wy, wi) in zip(got, want):
        np.testing.assert_allclose(gy, wy, rtol=RTOL, atol=ATOL)
        np.testing.assert_array_equal(gi, wi)
    for f, rf in zip(wf.forwards, ref_wf.forwards):
        if rf.weights:
            np.testing.assert_allclose(f.weights.mem, rf.weights.mem,
                                       rtol=RTOL, atol=ATOL, err_msg=f.name)
    # validation minibatches take the deterministic form, offsets all 0
    valid = np.arange(n0, n0 + n1)
    got = _drive(wf, valid, VALID, gd=False)
    want = _drive(ref_wf, valid, VALID, gd=False)
    for (gy, gi), (wy, wi) in zip(got, want):
        np.testing.assert_allclose(gy, wy, rtol=RTOL, atol=ATOL)
        assert not gi.any() and not wi.any()


def test_fused_spec_is_the_references(split):
    ref_wf, wf = _workflows()
    spec, _, _ = ref_fused.extract_model(ref_wf)
    assert [(la.kind, la.config) for la in wf.spec.layers] == [
        (la.kind, la.config) for la in spec.layers]
    cfg = wf.spec.layers[1].cfg
    assert cfg["unit_id"] == zlib.crc32(b"fwd1_stochastic_pooling")
    assert cfg["seed"] == prng.get("pooling").stream_seed


def _trainers(split_data=True):
    ref_wf, wf = _workflows()
    spec, params, vels = ref_fused.extract_model(ref_wf)
    ref_tr = ref_fused.FusedTrainer(spec=spec, params=params, vels=vels)
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu", unit_index=spec.unit_index)
    return ref_wf, wf, ref_tr, (pspec, pparams, pvels)


def test_fused_trainer_matches_reference(split):
    ref_wf, wf, ref_tr, (spec, params, vels) = _trainers()
    tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                            device="cpu")
    ld = wf.loader
    n0, n1, n2 = ld.class_lengths
    idx = np.random.default_rng(3).permutation(np.arange(n0 + n1, n0 + n1
                                                         + n2))
    for epoch, ctr_base in ((0, 0), (1, 40)):
        want = ref_tr.train_epoch(ref_wf.loader.original_data.devmem,
                                  ref_wf.loader.original_labels.devmem, idx,
                                  40, epoch=epoch, ctr_base=ctr_base)
        got = tr.train_epoch(ld.original_data, ld.original_labels, idx, 40,
                             epoch=epoch, ctr_base=ctr_base)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
        np.testing.assert_array_equal(got["n_err"], want["n_err"])
    for (w, b), (rw, rb) in zip(tr.params, ref_tr.params):
        if w is not None:
            np.testing.assert_allclose(w.numpy(), np.asarray(rw), rtol=RTOL,
                                       atol=ATOL)
            np.testing.assert_allclose(b.numpy(), np.asarray(rb), rtol=RTOL,
                                       atol=ATOL)
    got = tr.eval_epoch(ld.original_data, ld.original_labels,
                        np.arange(n0, n0 + n1), 40)
    want = ref_tr.eval_epoch(ref_wf.loader.original_data.devmem,
                             ref_wf.loader.original_labels.devmem,
                             np.arange(n0, n0 + n1), 40)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=RTOL)
    np.testing.assert_array_equal(got["n_err"], want["n_err"])


class _Direct:
    """A captured graph's stand-in on the CPU: a replay runs the step."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_plan_fed_step_equals_eager_step(split, monkeypatch):
    """The captured step reads its epoch and counter from the plan row at
    each replay: run here eagerly through the plan, it draws every step's
    own bits, so its epochs equal the eager step's bit for bit (a fold of
    Python ints frozen into the graph would repeat one draw)."""
    calls = []

    def fake(plan, fn):
        calls.append(fn)
        fn()
        return _Direct(fn)
    monkeypatch.setattr(capture.StepPlan, "capture", fake)
    _, wf, _, (spec, params, vels) = _trainers()
    ld = wf.loader
    n0, n1, n2 = ld.class_lengths
    idx = np.arange(n0 + n1, n0 + n1 + n2)
    runs = []
    for plan_fed in (True, False):
        tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                                device="cpu")
        if plan_fed:
            tr.uncaptured_reason = None   # the card's path, run here
        ms = [tr.train_epoch(ld.original_data, ld.original_labels, idx, 40,
                             epoch=e, ctr_base=c)
              for e, c in ((0, 0), (1, 0), (2 ** 32 - 1, 2 ** 31 + 7))]
        runs.append((tr, ms))
    (tr_p, ms_p), (tr_e, ms_e) = runs
    assert len(calls) == 1
    for a, b in zip(ms_p, ms_e):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for (w, b), (we, be) in zip(tr_p.params, tr_e.params):
        if w is not None:
            assert torch.equal(w, we) and torch.equal(b, be)


def test_unit_graph_matches_own_fused_trainer(split):
    _, wf = _workflows()
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cpu")
    ld = wf.loader
    n0, n1, n2 = ld.class_lengths
    idx = np.arange(n0 + n1, n0 + n1 + n2)
    tr.train_epoch(ld.original_data, ld.original_labels, idx, 40, epoch=0)
    _drive(wf, idx)
    for f, (w, b) in zip(wf.forwards, tr.params):
        if w is not None:
            np.testing.assert_allclose(w.numpy(), f.weights.mem, rtol=RTOL,
                                       atol=ATOL, err_msg=f.name)


def test_depooling_ties_to_a_stochastic_pool():
    pool = fused.LayerSpec("stochastic_pool", "linear", False, (0.0,) * 4,
                           (0.0,) * 4, (("ksize", (2, 2)), ("padding", (0, 0)),
                                        ("seed", 5), ("stride", (2, 2)),
                                        ("unit_id", 9)))
    depool = fused.LayerSpec("depooling", "linear", False, (0.0,) * 4,
                             (0.0,) * 4, (("ksize", (2, 2)),
                                          ("padding", (0, 0)),
                                          ("stride", (2, 2)), ("tie", 0)))
    spec = fused.ModelSpec((pool, depool), "mse")
    x = torch.rand((2, 4, 4, 3))
    out, caches = fused.forward(spec, [(None, None)] * 2, x,
                                want_caches=True, train=True, epoch=1, ctr=2)
    assert out.shape == x.shape
    # each window keeps exactly its drawn tap
    assert torch.equal((out != 0).sum(), torch.tensor(2 * 2 * 2 * 3))


@pytest.mark.parametrize("fused_path", [False, True])
def test_cifar_sample_with_stochastic_pool_matches_reference(split,
                                                             fused_path):
    layers = [dict(la, type="stochastic_pooling")
              if la["type"] == "max_pooling" else la
              for la in root.cifar.layers]
    ref_root.cifar.layers = root.cifar.layers = layers
    ref_prng.seed_all(1234)
    want = ref_cifar.run(device=Device.create("xla"), epochs=1,
                         fused=fused_path).decision.epoch_metrics
    prng.seed_all(1234)
    got = cifar.run(device="cpu", epochs=1,
                    fused=fused_path).decision.epoch_metrics
    assert len(got) == len(want) == 1
    for k, v in want[0].items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(got[0][k], v, rtol=RTOL, err_msg=k)
        elif k.endswith("_n_err"):
            assert got[0][k] == v, (k, got, want)


def test_numpy_device_matches_torch_cpu(split):
    """The numpy device's golden units draw the same picks: its epoch
    equals the torch CPU unit graph's."""
    runs = []
    for device in ("numpy", "cpu"):
        prng.seed_all(1234)
        wf = cifar.CifarWorkflow(layers=LAYERS)
        wf.initialize(device=device)
        wf.train(fused=False, max_epochs=1)
        runs.append(wf.decision.epoch_metrics[0])
    for k, v in runs[1].items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(runs[0][k], v, rtol=RTOL, err_msg=k)
        elif k.endswith("_n_err"):
            assert runs[0][k] == v, (k, runs)
