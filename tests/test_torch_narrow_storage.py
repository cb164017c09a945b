"""Narrow activation storage through the port's conv stack
(``ModelSpec.storage_dtype`` bfloat16 and float16) against the JAX package
on the CPU, on numpy inputs made from seeds.

- Each kernel that reads a stored activation, its plain version at bf16
  and f16 against the reference's Pallas kernel in interpret mode, which
  converts the stored value to float32 and rounds once, as the port does:
  the pool select, the depooling scatter, the LRN forward, the pair
  forward (unsplit and over halves), dropout and the pool's values bit
  for bit; the LRN backward, the pair backward (dx unsplit and as halves)
  with no fold or the strict-ReLU fold, and the activation backward
  within rtol 1e-5 / atol 1e-7 (the float32 tolerance of
  tests/test_torch_lrn_pool.py).  The pair's tanh fold the reference
  takes in narrow arithmetic (its ``D2·y·y`` rounded to bf16/f16), the
  port at the stored value in float32: within 2e-2 (bf16) / 2e-3 (f16)
  of the largest |dx| (its factor cancels near tanh's saturation).  The
  depooling scatter's overlapping sums round once where the port stores
  them, the reference's at the layer's end: equal after that cast.  The
  stochastic pool: the port's narrow forward equals the reference's
  float32 forward rounded once.
- The caches: the input and the loss head's output float32, every inner
  cache in the storage dtype (tests/test_fused_conv.py:272-293), a
  split-out conv's halves too.
- Merged equals split at bf16 (tests/test_fused_conv.py:127-178): the
  ``fused1`` spec's epoch equals the ``split`` spec's bit for bit for
  conv_str and conv_tanh: the pair selects on the LRN output rounded to
  bf16 and takes the folded derivative at the stored y, as the split
  layers do.
- One train epoch and one eval epoch at bf16 of the CIFAR-like net, the
  shrunk AlexNet under fused1 and fused2, the tied and untied autoencoder
  (depooling) and the stochastic-pool net against the reference's
  ``FusedTrainer`` at bf16 on carried-across weights: losses within rtol
  5e-3, error counts within 2 a step, every parameter within 5e-4 + 5% of
  its tensor's largest element.  The reference's fused step takes the
  unfolded activation derivatives in bf16 arithmetic and its XLA tier
  rounds after each op, where every port kernel computes in float32 from
  the stored value: with the reference in interpret mode and its
  derivatives taken at the stored value in float32 (a test-local patch of
  its activation classes), the CIFAR-like epoch agrees within loss rtol
  1e-4, error counts exactly and 2e-3 of each tensor's largest element.
- The config tree's ``root.common.storage_dtype``/``compute_dtype`` reach
  the trainer's spec through ``train(fused=True)``
  (tests/test_fused_conv.py:520-533).

Torch runs at 2 threads."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import autoencoder as ref_ae
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu.ops import activations as ref_act
from znicz_tpu.ops import elementwise as ref_el
from znicz_tpu.ops import lrn_pool as ref_lp
from znicz_tpu.ops import pooling as ref_pool
from znicz_tpu.ops import tuning as ref_tuning
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import cifar
from znicz_tpu_torch.ops import (activations, dropout, lrn_pool,
                                 normalization, pooling, rngbits)
from znicz_tpu_torch.parallel import fused
from test_torch_alexnet import _both as _alexnets, small_net  # noqa: F401
from test_torch_autoencoder import TIED
from test_torch_stochastic_pool import LAYERS as STOCHASTIC_LAYERS

HP = (5, 1e-4, 0.75, 2.0)
NARROW = {"bfloat16": torch.bfloat16, "float16": torch.float16}
JNP = {"bfloat16": jnp.bfloat16, "float16": jnp.float16}
CIFAR_SPLIT = {"n_train": 200, "n_valid": 80, "n_test": 80, "noise": 0.3,
               "size": 16}
AE_SPLIT = {"n_train": 300, "n_valid": 60, "n_test": 60, "noise": 0.35}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def interpret(monkeypatch):
    monkeypatch.setattr(ref_tuning, "_INTERPRET", True)


@pytest.fixture(autouse=True)
def small(small_net):                                  # noqa: F811
    """The small CIFAR and autoencoder splits in both config trees (the
    shrunk AlexNet's is ``small_net``'s); restored after."""
    trees = [(t.cifar, CIFAR_SPLIT, 40) for t in (ref_root, root)] + [
        (t.mnist_ae, AE_SPLIT, 60) for t in (ref_root, root)]
    saved = [(t.synthetic.to_dict(), t.get("minibatch_size"),
              t.get("layers")) for t, _, _ in trees]
    for t, split, batch in trees:
        t.synthetic.update(split)
        t.minibatch_size = batch
    yield
    for (t, _, _), (syn, mb, layers) in zip(trees, saved):
        t.synthetic.update(syn)
        t.minibatch_size = mb
        t.layers = layers


def _narrow(a, storage):
    """(numpy float32 of the narrow values, torch narrow, jnp narrow)."""
    t = torch.from_numpy(np.ascontiguousarray(a)).to(NARROW[storage])
    return t.float().numpy(), t, jnp.asarray(a).astype(JNP[storage])


def _f32(a):
    return np.asarray(jnp.asarray(a).astype(jnp.float32))


def _halves(t):
    return tuple(h.contiguous() for h in lrn_pool.split_cols(t))


# -- the kernels' plain versions ----------------------------------------------
@pytest.mark.parametrize("storage", sorted(NARROW))
@pytest.mark.parametrize("use_abs", [False, True])
def test_pool_select_and_depooling(storage, use_abs, interpret):
    rng = np.random.default_rng(1)
    for shape, k, st, pad in (((2, 9, 9, 8), 3, 2, 0),
                              ((3, 8, 8, 4), 2, 2, 0),
                              ((2, 7, 6, 3), 3, 2, 1)):
        _, xt, xj = _narrow(rng.standard_normal(shape) * 3, storage)
        pool = pooling.maxabs_pooling if use_abs else pooling.max_pooling
        ref = ref_pool.maxabs_pooling if use_abs else ref_pool.max_pooling
        y, off = pool(xt, k, st, pad)
        wy, woff = ref(xj, k, st, pad)
        assert y.dtype == xt.dtype
        np.testing.assert_array_equal(y.float().numpy(), _f32(wy))
        np.testing.assert_array_equal(off.numpy(), np.asarray(woff))
        # the depooling forward scatters the stored pooled values; where
        # windows overlap, the reference's float32 sum is rounded to the
        # storage dtype at the layer's end, the port's where it is stored
        got = pooling.depooling(y, off, shape, k, st, pad)
        want = ref_pool.depooling(wy, woff, shape, k, st, pad)
        assert got.dtype == xt.dtype
        np.testing.assert_array_equal(
            got.float().numpy(), _f32(jnp.asarray(want).astype(
                JNP[storage])))


@pytest.mark.parametrize("storage", sorted(NARROW))
def test_lrn_pair_of_the_split_routing(storage, interpret):
    rng = np.random.default_rng(2)
    for shape in ((2, 6, 5, 32), (3, 4, 4, 7)):
        _, xt, xj = _narrow(rng.standard_normal(shape) * 3, storage)
        y = normalization.lrn_y(xt, *HP)
        assert y.dtype == xt.dtype
        np.testing.assert_array_equal(y.float().numpy(),
                                      _f32(ref_el.pallas_lrn_y(xj, *HP)))
        err = rng.standard_normal(shape).astype(np.float32)
        dx = normalization.gd_lrn_x(torch.from_numpy(err), xt, *HP)
        assert dx.dtype == torch.float32
        np.testing.assert_allclose(
            dx.numpy(), np.asarray(ref_el.pallas_gd_lrn_x(
                jnp.asarray(err), xj, *HP)), rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("storage", sorted(NARROW))
@pytest.mark.parametrize("geom", [(2, 9, 9, 8, (3, 3), (2, 2)),
                                  (3, 11, 7, 4, (2, 3), (2, 2)),
                                  (1, 15, 15, 96, (3, 3), (2, 2))])
def test_lrn_maxpool_pair(storage, geom, interpret):
    b, h, w, c, k, st = geom
    rng = np.random.default_rng(h * c)
    _, xt, xj = _narrow(rng.standard_normal((b, h, w, c)) * 3, storage)
    xe, xo = ref_lp.split_cols(xj)
    want_y, want_off = ref_lp.pallas_lrn_maxpool_split(xe, xo, *HP, k, st,
                                                       0)
    for y, off in (lrn_pool.lrn_maxpool(xt, *HP, k, st),
                   lrn_pool.lrn_maxpool_split(*_halves(xt), *HP, k, st)):
        assert y.dtype == xt.dtype
        np.testing.assert_array_equal(y.float().numpy(), _f32(want_y))
        np.testing.assert_array_equal(off.numpy(), np.asarray(want_off))
    err = rng.standard_normal(tuple(y.shape)).astype(np.float32)
    for fold in (None, "strict_relu", "tanh"):
        # the tanh fold: 1.1438 − 0.3885·y² in the reference's narrow
        # arithmetic cancels near saturation, so the bound is a share of
        # the largest |dx|
        share = {None: 0.0, "strict_relu": 0.0,
                 "tanh": 2e-2 if storage == "bfloat16" else 2e-3}[fold]
        for split in (False, True):
            want = ref_lp.pallas_gd_lrn_maxpool_split(
                jnp.asarray(err), want_off, xe, xo, *HP, k, st, 0, fold,
                split)
            got = lrn_pool.gd_lrn_maxpool_split(
                torch.from_numpy(err), off, *_halves(xt), *HP, k, st, 0,
                fold, return_split=split)
            unsplit = lrn_pool.gd_lrn_maxpool(torch.from_numpy(err), off,
                                              xt, *HP, k, st, 0, fold)
            got = got if split else (got,)
            want = want if split else (want,)
            mine = _halves(unsplit) if split else (unsplit,)
            for g, wa, u in zip(got, want, mine):
                assert g.dtype == torch.float32
                assert torch.equal(g, u)
                wa = np.asarray(wa)
                np.testing.assert_allclose(
                    g.numpy(), wa, rtol=1e-5,
                    atol=max(1e-7, share * np.abs(wa).max()))


@pytest.mark.parametrize("storage", sorted(NARROW))
def test_dropout_rounds_once(storage, interpret):
    x32, xt, xj = _narrow(np.random.default_rng(4).standard_normal(
        (6, 5, 7)) * 3, storage)
    counters = (9, 2, 40)
    got = dropout.dropout(xt, rngbits.fold(11, *counters), 0.4)
    want = ref_el.pallas_dropout(xj, 11, counters, 0.4)
    assert got.dtype == xt.dtype
    np.testing.assert_array_equal(got.float().numpy(), _f32(want))
    # one rounding: the float32 product of the stored value, cast once
    mask = dropout.mask_from_key(rngbits.fold(11, *counters), x32.shape,
                                 0.4)
    assert torch.equal(got, (torch.from_numpy(x32) * mask).to(xt.dtype))


@pytest.mark.parametrize("storage", sorted(NARROW))
@pytest.mark.parametrize("name", sorted(activations.ACT_IDS))
def test_act_bwd_on_a_stored_y(storage, name, interpret):
    rng = np.random.default_rng(5)
    x = (rng.standard_normal((6, 10)) * 2).astype(np.float32)
    err = rng.standard_normal((6, 10)).astype(np.float32)
    y = activations.BY_NAME[name].fwd(torch.from_numpy(x))
    _, yt, yj = _narrow(y.numpy(), storage)
    _, xt, xj = _narrow(x, storage)
    needs = activations.BY_NAME[name].needs_input
    got = activations.act_bwd(name, torch.from_numpy(err), yt,
                              xt if needs else None)
    want = ref_el.pallas_act_bwd(name, jnp.asarray(err), yj,
                                 xj if needs else None)
    assert got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-7)
    assert torch.equal(activations.apply_bwd(activations.BY_NAME[name],
                                             torch.from_numpy(err), yt, xt),
                       got)


@pytest.mark.parametrize("storage", sorted(NARROW))
@pytest.mark.parametrize("deterministic", [False, True])
def test_stochastic_pool_rounds_once(storage, deterministic):
    rng = np.random.default_rng(6)
    x32, xt, _ = _narrow(rng.standard_normal((2, 8, 6, 3)) * 2, storage)
    u = None if deterministic else torch.from_numpy(
        rng.random((2, 4, 3, 3)).astype(np.float32))
    y, off = pooling.stochastic_pooling(xt, 2, 2, 0, u, False, deterministic)
    wy, woff = ref_pool.xla_stochastic_pooling(
        jnp.asarray(x32), 2, 2, 0, None if u is None else jnp.asarray(
            u.numpy()), False, deterministic)
    assert y.dtype == xt.dtype
    np.testing.assert_array_equal(
        y.numpy() if y.dtype == torch.float32 else y.float().numpy(),
        torch.from_numpy(np.array(wy)).to(xt.dtype).float().numpy())
    np.testing.assert_array_equal(off.numpy(), np.asarray(woff))


# -- the fused step ------------------------------------------------------------
def _cifar_pair(layers=None):
    ref_prng.seed_all(1234)
    ref_wf = ref_cifar.CifarWorkflow(layers=layers)
    ref_wf.initialize(device=Device.create("xla"))
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow(layers=layers)
    wf.initialize(device="cpu")
    return ref_wf, wf


def _ae_reference(layers):
    ref_prng.seed_all(1234)
    wf = ref_ae.MnistAEWorkflow(layers=layers)
    wf.initialize(device=Device.create("xla"))
    return wf


@pytest.mark.parametrize("storage", sorted(NARROW))
@pytest.mark.parametrize("routing", ["fused1", "fused2"])
def test_cache_dtypes(storage, routing, monkeypatch):
    """Only the layers after the first store narrow: the input and the
    logits stay float32, every inner cache (a split-out conv's halves
    too) is in the storage dtype."""
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", routing)
    _, wf = _alexnets()
    spec = dataclasses.replace(wf.spec, storage_dtype=storage)
    x = wf.loader.original_data[:4]
    params = wf.spec_rows(wf.params)
    out, caches = fused.forward(spec, params, x, want_caches=True,
                                train=True, epoch=0, ctr=4)
    assert out.dtype == torch.float32
    assert caches[0][0].dtype == torch.float32
    inner = [t.dtype for c in caches[1:]
             for t in (c[0] if isinstance(c[0], tuple) else (c[0],))]
    assert set(inner) == {NARROW[storage]}
    halves = [c[0] for c in caches if isinstance(c[0], tuple)]
    assert len(halves) == (2 if routing == "fused2" else 0)


def _split_vs_merged_layers(conv_type):
    return [
        {"type": conv_type, "->": {"n_kernels": 8, "kx": 5, "sliding": 2},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}},
        {"type": "norm", "->": {"n": 5}},
        {"type": "max_pooling", "->": {"kx": 3, "sliding": 2}},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.1, "gradient_moment": 0.9}}]


@pytest.mark.parametrize("conv_type", ["conv_str", "conv_tanh"])
def test_merged_equals_split_at_bf16(conv_type, monkeypatch):
    results = []
    for routing in ("fused1", "split"):
        monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", routing)
        _, wf = _cifar_pair(_split_vs_merged_layers(conv_type))
        assert [la.kind for la in wf.spec.layers].count("lrn_pool") == (
            routing == "fused1")
        spec = dataclasses.replace(wf.spec, storage_dtype="bfloat16")
        tr = fused.FusedTrainer(spec=spec, params=wf.spec_rows(wf.params),
                                vels=wf.spec_rows(wf.vels), device="cpu")
        ld = wf.loader
        n0, n1, n2 = ld.class_lengths
        m = tr.train_epoch(ld.original_data, ld.original_labels,
                           np.arange(n0 + n1, n0 + n1 + n2),
                           ld.max_minibatch_size)
        results.append((m, [t for pair in tr.params for t in pair
                            if t is not None]))
    (m_m, p_m), (m_s, p_s) = results
    np.testing.assert_array_equal(m_m["loss"], m_s["loss"])
    np.testing.assert_array_equal(m_m["n_err"], m_s["n_err"])
    assert len(p_m) == len(p_s)
    for a, b in zip(p_m, p_s):
        assert torch.equal(a, b)


def _epochs(ref_wf, storage, mse=False, batch=40, n=None):
    """(reference train and eval metrics, the port's, the reference's
    params, the port's) at ``storage`` on carried-across weights."""
    spec, params, vels = ref_fused.extract_model(ref_wf)
    spec = dataclasses.replace(spec, storage_dtype=storage)
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu", unit_index=spec.unit_index)
    pspec = dataclasses.replace(pspec, storage_dtype=storage)
    data = np.asarray(ref_wf.loader.original_data.mem)
    target = data if mse else np.asarray(ref_wf.loader.original_labels.mem)
    idx = np.random.default_rng(3).permutation(len(data))[:n or len(data)]
    copy = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    ref = ref_fused.FusedTrainer(spec=spec, params=copy(params),
                                 vels=copy(vels))
    want = (ref.train_epoch(data, target, idx, batch, epoch=0),
            ref.eval_epoch(data, target, idx, batch))
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    xt, tt = torch.from_numpy(data.copy()), torch.from_numpy(target.copy())
    got = (port.train_epoch(xt, tt, idx, batch, epoch=0),
           port.eval_epoch(xt, tt, idx, batch))
    return want, got, ref.params, port.params


def _assert_close(want, got, wparams, gparams, loss_rtol, n_err, frac):
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["loss"], np.asarray(w["loss"]),
                                   rtol=loss_rtol)
        assert np.abs(g["n_err"] - np.asarray(w["n_err"])).max() <= n_err
    for wp, gp in zip(wparams, convert.to_numpy(gparams)):
        for w, g in zip(wp, gp):
            assert (w is None) == (g is None)
            if w is not None:
                w = np.asarray(w)
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=frac[0] + frac[1] * np.abs(w).max())


#: loss rtol, error counts a step, (atol, fraction of the tensor's largest
#: element) for the parameters: the stated bf16 tolerance against the
#: reference's own fused step
BF16_TOL = (5e-3, 2, (5e-4, 5e-2))


@pytest.mark.parametrize("net", ["cifar", "stochastic"])
def test_cifar_nets_bf16_epoch_match_reference(net, monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused1")
    ref_wf, _ = _cifar_pair(STOCHASTIC_LAYERS if net == "stochastic"
                            else None)
    _assert_close(*_epochs(ref_wf, "bfloat16"), *BF16_TOL)


@pytest.mark.parametrize("routing", ["fused1", "fused2"])
def test_alexnet_bf16_epoch_matches_reference(routing, monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", routing)
    ref_wf, _ = _alexnets()
    _assert_close(*_epochs(ref_wf, "bfloat16", batch=32), *BF16_TOL)


@pytest.mark.parametrize("layers", [None, TIED], ids=["config4", "tied"])
def test_autoencoder_bf16_epoch_matches_reference(layers):
    _assert_close(*_epochs(_ae_reference(layers), "bfloat16", mse=True,
                           batch=60, n=150), *BF16_TOL)


@pytest.mark.parametrize("storage", sorted(NARROW))
def test_cifar_epoch_matches_a_float32_arithmetic_reference(
        storage, interpret, monkeypatch):
    """With the reference's kernels in interpret mode and its unfolded
    derivatives taken at the stored value in float32 (as the port's
    kernels and the reference's own Pallas act_bwd take it), the narrow
    epochs agree closely: the looser stated tolerance is the reference's
    narrow arithmetic, not the port's storage."""
    for cls in (ref_act.Tanh, ref_act.Sigmoid, ref_act.StrictRelu,
                ref_act.Relu):
        def bwd(err_y, y, x=None, xp=np, _orig=cls.bwd):
            return _orig(err_y, y.astype(np.float32), x, xp)
        monkeypatch.setattr(cls, "bwd", staticmethod(bwd))
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused1")
    ref_wf, _ = _cifar_pair()
    _assert_close(*_epochs(ref_wf, storage), 1e-4, 0, (0.0, 2e-3))


def test_dtype_knobs_from_config_tree(monkeypatch):
    """root.common.{compute,storage}_dtype reach the fused spec through
    train(fused=True), and the epoch runs at them."""
    _, wf = _cifar_pair()
    saved = {k: root.common.get(k) for k in ("storage_dtype",
                                             "compute_dtype")}
    root.common.update({"storage_dtype": "bfloat16",
                        "compute_dtype": "bfloat16"})
    try:
        tr = wf.train(fused=True, max_epochs=1)
    finally:
        root.common.update(saved)
    assert tr.spec.storage_dtype == "bfloat16"
    assert tr.spec.compute_dtype == "bfloat16"
    m = wf.decision.epoch_metrics[-1]
    assert all(np.isfinite(v) for k, v in m.items() if k.endswith("_loss"))
    for w, b in tr.params:
        assert w is None or w.dtype == torch.float32

