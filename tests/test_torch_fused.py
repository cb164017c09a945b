"""The port's fused step (znicz_tpu_torch.parallel.fused) against the JAX
package's ``FusedTrainer`` on carried-across weights: one train epoch and
one eval epoch over the same indices, in both.  Per-step loss must match
at rtol 1e-5 and n_err exactly; final params and velocities at atol 1e-5.
All inputs are numpy, made from seeds.

``apply_updates`` alone: bit for bit against the per-tensor expression it
ran before it called ``ops.update.sgd_update_many`` (kept below as the
golden), and within rtol 2.4e-7 / atol 1e-8 of the reference's
``apply_updates`` on the same numpy inputs (the tolerance
tests/test_torch_update.py holds the update to XLA at), on MNIST's spec
and a tied-deconv autoencoder spec; one call of the list form a step, two
where a tied deconv updates the W its encoder conv then updates.

Every activation of the step goes through ``ops.activations.apply_fwd``
/ ``apply_bwd`` (the kernels on the card): one train step and one eval
step of the port's MNIST, CIFAR, AlexNet (narrow widths) and autoencoder
samples, and a unit-graph epoch of MNIST and CIFAR (its weighted units),
call them for a non-linear activation as often as chip_smoke.py's launch
counts say."""

import contextlib
import dataclasses
import importlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import alexnet
from znicz_tpu_torch.ops import activations, update
from znicz_tpu_torch.parallel import fused
from znicz_tpu_torch.profile_fused import MODELS


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mnist_reference(n_train):
    """A tiny JAX MNIST workflow (784→16→10) and its extract_model."""
    ref_prng.seed_all(1234)
    saved = ref_root.mnist.synthetic.to_dict()
    ref_root.mnist.synthetic.update({"n_train": n_train, "n_valid": 40,
                                     "n_test": 40})
    try:
        wf = ref_mnist.MnistWorkflow(layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}}])
        wf.initialize(device=Device.create("xla"))
    finally:
        ref_root.mnist.synthetic.update(saved)
    spec, params, vels = ref_fused.extract_model(wf)
    data = np.asarray(wf.loader.original_data.mem)
    labels = np.asarray(wf.loader.original_labels.mem)
    return spec, params, vels, data, labels


def _hand_built(loss, activation_layer):
    """A hand-built ModelSpec with decay, L1 mix and momentum on every
    layer, optionally a standalone activation layer, MSE or softmax."""
    rng = np.random.default_rng(5)
    hyp = (0.05, 1e-3, 0.3, 0.9)
    hyp_b = (0.02, 1e-4, 0.5, 0.8)

    def fc(act, n_in, n_out):
        layer = ref_fused.LayerSpec(kind="fc", activation=act,
                                    include_bias=True, hypers=hyp,
                                    hypers_bias=hyp_b)
        w = (rng.standard_normal((n_in, n_out)) * 0.3).astype(np.float32)
        b = (rng.standard_normal(n_out) * 0.1).astype(np.float32)
        v = ((rng.standard_normal((n_in, n_out)) * 0.01).astype(np.float32),
             (rng.standard_normal(n_out) * 0.01).astype(np.float32))
        return layer, (w, b), v

    layers, params, vels = [], [], []
    first = fc("linear" if activation_layer else "sigmoid", 24, 12)
    for item in ([first] + ([(ref_fused.LayerSpec(
            kind="activation", activation="tanh", include_bias=False,
            hypers=(0.0,) * 4, hypers_bias=(0.0,) * 4), (None, None),
            (None, None))] if activation_layer else [])
            + [fc("tanh" if loss == "mse" else "linear", 12, 6)]):
        layers.append(item[0])
        params.append(item[1])
        vels.append(item[2])
    spec = ref_fused.ModelSpec(tuple(layers), loss)
    data = rng.standard_normal((90, 24)).astype(np.float32)
    target = (rng.standard_normal((90, 6)).astype(np.float32)
              if loss == "mse" else rng.integers(0, 6, 90).astype(np.int32))
    return spec, params, vels, data, target


CASES = {
    # name: (builder, indices count, batch)
    "mnist_full_batches": (lambda: _mnist_reference(200), 200, 20),
    "mnist_short_last_batch": (lambda: _mnist_reference(205), 205, 20),
    "softmax_activation_layer": (lambda: _hand_built("softmax", True), 85,
                                 16),
    "mse": (lambda: _hand_built("mse", False), 90, 16),
    "mse_activation_layer_short_batch": (lambda: _hand_built("mse", True),
                                         77, 10),
}


@pytest.mark.parametrize("case", sorted(CASES))
def test_epoch_matches_reference_trainer(case):
    build, n_idx, batch = CASES[case]
    spec, params, vels, data, target = build()
    rng = np.random.default_rng(11)
    indices = rng.permutation(len(data))[:n_idx]
    # the same indices through both trainers
    ref = ref_fused.FusedTrainer(spec=spec, params=params, vels=vels)
    ref_train = ref.train_epoch(data, target, indices, batch, epoch=0)
    ref_eval = ref.eval_epoch(data, target, indices, batch)

    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    x = torch.from_numpy(np.array(data))      # writable copies
    t = torch.from_numpy(np.array(target))
    got_train = port.train_epoch(x, t, indices, batch)
    got_eval = port.eval_epoch(x, t, indices, batch)

    for want, got in ((ref_train, got_train), (ref_eval, got_eval)):
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["n_err"], want["n_err"])
    for want, got in ((ref.params, port.params), (ref.vels, port.vels)):
        for wp, gp in zip(want, convert.to_numpy(got)):
            for w, g in zip(wp, gp):
                assert (w is None) == (g is None)
                if w is not None:
                    np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                               atol=1e-5)


@pytest.mark.parametrize("n,batch", [(100, 20), (105, 20), (7, 10)])
def test_idx_matrix_matches_reference(n, batch):
    indices = np.random.default_rng(n).permutation(n + 3)[:n]
    want = ref_fused.FusedTrainer._idx_matrix(None, indices, batch, 40)
    got = fused.FusedTrainer._idx_matrix(indices, batch, 40)
    for w, g in zip(want, got):
        assert w.dtype == g.dtype
        np.testing.assert_array_equal(g, w)


@pytest.mark.parametrize("kind", ["lrn_pool", "stochastic_pool",
                                  "dropout", "deconv", "depooling"])
def test_unported_kinds_raise_naming_the_roadmap(kind):
    """Nothing of these kinds is left unported: the narrow-storage forms of
    lrn_pool, the stochastic pool, dropout and depooling are accepted (their
    kernels take the storage dtypes).  A tied deconv with a bias is refused
    as the reference's fused path refuses it, naming no item."""
    def row(k, include_bias=False, **cfg):
        return fused.LayerSpec(kind=k, activation="linear",
                               include_bias=include_bias,
                               hypers=(0.0,) * 4, hypers_bias=(0.0,) * 4,
                               config=tuple(sorted(cfg.items())))
    pool = dict(ksize=(2, 2), stride=(2, 2), padding=(0, 0))
    conv = dict(stride=(1, 1), padding=(0, 0))
    layers, storage = {
        "lrn_pool": ((row("lrn_pool"),), "bfloat16"),
        "stochastic_pool": ((row("stochastic_pool", seed=5, unit_id=9,
                                 **pool),), "bfloat16"),
        "dropout": ((row("dropout"),), "bfloat16"),
        "deconv": ((row("conv", True, **conv),
                    row("deconv", True, tie=0, **conv)), "float32"),
        "depooling": ((row("max_pool", **pool),
                       row("depooling", tie=0, **pool)), "bfloat16"),
    }[kind]
    if kind != "deconv":
        assert fused.ModelSpec(layers, "mse",
                               storage_dtype=storage).storage_dtype == storage
        return
    with pytest.raises(NotImplementedError,
                       match="reference's fused path refuses it too"):
        fused.ModelSpec(layers, "mse", storage_dtype=storage)


@pytest.mark.parametrize("kind", ["max_pool", "maxabs_pool", "lrn",
                                  "lrn_pool", "dropout"])
def test_narrow_storage_through_float32_kernels_raises(kind):
    """The pool, LRN and dropout kernels take every storage dtype: a
    bfloat16 or float16 storage dtype on a spec with them is accepted (an
    unknown one is still refused)."""
    layer = fused.LayerSpec(kind=kind, activation="linear",
                            include_bias=False, hypers=(0.0,) * 4,
                            hypers_bias=(0.0,) * 4)
    fused.ModelSpec((layer,), "mse")                     # float32: fine
    for storage in ("bfloat16", "float16"):
        assert fused.ModelSpec((layer,), "mse", storage_dtype=storage
                               ).storage_dtype == storage
    with pytest.raises(ValueError, match="unknown dtype"):
        fused.ModelSpec((layer,), "mse", storage_dtype="float8")


@pytest.mark.parametrize("kwargs", [{"mesh": object()},
                                    {"augment": object()}])
def test_trainer_options_outside_the_slice_raise(kwargs):
    """A mesh is not ported yet; an augment policy is, but one without a
    device_apply (the device crop) is refused."""
    spec, params, vels, _, _ = _hand_built("mse", False)
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    error, match = ((TypeError, "device_apply") if "augment" in kwargs
                    else (NotImplementedError, "ROADMAP.md"))
    with pytest.raises(error, match=match):
        fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                           device="cpu", **kwargs)


# -- apply_updates on the list form of the update ---------------------------
def _golden_apply_updates(spec, params, vels, grads):
    """The port's apply_updates before the list form: the update written
    out per tensor in torch with Python-float hypers."""
    cur_w = [p[0] for p in params]
    cur_b = [p[1] for p in params]
    new_v = [list(v) for v in vels]
    for i in reversed(range(len(spec.layers))):
        layer, grad = spec.layers[i], grads[i]
        if grad is None:
            continue
        tgt = layer.cfg.get("tie", i) if layer.kind == "deconv" else i
        w, b = cur_w[tgt], cur_b[i]
        (vw, vb), (gw, gb) = vels[i], grad
        lr, wd, l1, mom = layer.hypers
        reg = wd * ((1.0 - l1) * w + 0.5 * l1 * torch.sign(w))
        vw2 = mom * vw - lr * (gw + reg)
        cur_w[tgt] = w + vw2
        new_v[i][0] = vw2
        if b is not None:
            lrb, wdb, l1b, momb = layer.hypers_bias
            regb = wdb * ((1.0 - l1b) * b + 0.5 * l1b * torch.sign(b))
            vb2 = momb * vb - lrb * (gb + regb)
            cur_b[i] = b + vb2
            new_v[i][1] = vb2
    return (list(zip(cur_w, cur_b)), [tuple(v) for v in new_v])


def _autoencoder_spec(tied: bool):
    """The conv autoencoder's rows (conv 5×5×8 → max pool 2 → depooling →
    deconv) with decay and an L1 mix, the deconv tied to the conv's W
    (its own velocity, no W of its own) or holding its own W."""
    def row(kind, hypers=(0.0,) * 4, include_bias=False, **cfg):
        return ref_fused.LayerSpec(kind=kind, activation="linear",
                                   include_bias=include_bias, hypers=hypers,
                                   hypers_bias=(0.002, 0.0, 0.0, 0.9),
                                   config=tuple(sorted(cfg.items())))
    rng = np.random.default_rng(9)
    conv = dict(stride=(1, 1), padding=(2, 2))
    pool = dict(ksize=(2, 2), stride=(2, 2), padding=(0, 0))
    w = (rng.standard_normal((5, 5, 1, 8)) * 0.2).astype(np.float32)
    w[rng.random(w.shape) < 0.2] = 0.0
    b = (rng.standard_normal(8) * 0.1).astype(np.float32)
    layers = (row("conv", (0.0005, 1e-3, 0.9, 0.9), True, **conv),
              row("max_pool", **pool), row("depooling", tie=1, **pool),
              row("deconv", (0.0007, 5e-4, 0.3, 0.5),
                  **(dict(conv, tie=0) if tied else conv)))
    params = [(w, b), (None, None), (None, None),
              (None, None) if tied else (w[::-1].copy(), None)]
    vels = [tuple(None if a is None else
                  (rng.standard_normal(a.shape) * 0.01).astype(np.float32)
                  for a in p) for p in params]
    vels[3] = ((rng.standard_normal(w.shape) * 0.01).astype(np.float32),
               None)
    return ref_fused.ModelSpec(layers, "mse"), params, vels


def _mnist_spec():
    spec, params, vels, _, _ = _mnist_reference(40)
    # decay and an L1 mix on every tensor, l1 = 0.9 where the two
    # conventions of 1 − l1 differ in float32
    layers = tuple(dataclasses.replace(la, hypers=(0.03, 5e-4, 0.9, 0.9),
                                       hypers_bias=(0.02, 1e-3, 0.3, 0.5))
                   for la in spec.layers)
    return ref_fused.ModelSpec(layers, spec.loss), params, vels


UPDATE_SPECS = {"mnist": _mnist_spec,
                "autoencoder_tied": lambda: _autoencoder_spec(True),
                "autoencoder_untied": lambda: _autoencoder_spec(False)}


def _update_inputs(name):
    """(reference spec, numpy params, vels, grads) and the port's
    (spec, params, vels, grads) on the CPU."""
    spec, params, vels = UPDATE_SPECS[name]()
    rng = np.random.default_rng(len(name))
    grads = []
    for la, (w, b), (vw, _) in zip(spec.layers, params, vels):
        if la.kind not in fused.PARAM_KINDS:
            grads.append(None)
            continue
        shape = (w if w is not None else vw).shape
        grads.append(((rng.standard_normal(shape) * 0.1).astype(np.float32),
                      None if b is None else
                      (rng.standard_normal(b.shape) * 0.1).astype(
                          np.float32)))
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    pgrads = [None if g is None else tuple(
        None if a is None else torch.from_numpy(a) for a in g)
        for g in grads]
    return (spec, params, vels, grads), (pspec, pparams, pvels, pgrads)


def _pairs_equal(got, want):
    for gp, wp in zip(got, want):
        for a, b in zip(gp, wp):
            assert (a is None) == (b is None)
            if a is not None:
                assert torch.equal(a.view(torch.int32), b.view(torch.int32))


@pytest.mark.parametrize("name", sorted(UPDATE_SPECS))
def test_apply_updates_equals_the_per_tensor_golden_bit_for_bit(name):
    """In place, the lists given returned, at lr_scale None and at a
    scale of exactly 1."""
    for scale in (None, torch.ones(1)):
        _, (spec, params, vels, grads) = _update_inputs(name)
        want = _golden_apply_updates(spec, params, vels, grads)
        got = fused.apply_updates(spec, params, vels, grads, scale)
        assert got[0] is params and got[1] is vels
        for g, w in zip(got, want):
            _pairs_equal(g, w)


@pytest.mark.parametrize("name", sorted(UPDATE_SPECS))
def test_apply_updates_matches_the_reference(name):
    (rspec, rparams, rvels, rgrads), port = _update_inputs(name)

    def j(pairs):
        return [None if p is None else tuple(
            None if a is None else jnp.asarray(a) for a in p) for p in pairs]
    want = ref_fused.apply_updates(rspec, j(rparams), j(rvels), j(rgrads))
    got = fused.apply_updates(*port)
    for g, w in zip(got, want):
        for gp, wp in zip(convert.to_numpy(g), w):
            for a, b in zip(gp, wp):
                assert (a is None) == (b is None)
                if a is not None:
                    np.testing.assert_allclose(a, np.asarray(b), rtol=2.4e-7,
                                               atol=1e-8)


@pytest.mark.parametrize("name,calls", [("mnist", [4]),
                                        ("autoencoder_tied", [1, 2]),
                                        ("autoencoder_untied", [3])])
def test_one_update_call_a_step_and_a_new_one_at_a_tie(name, calls):
    """Every W and b in one call; a tied deconv's update of the conv's W
    is a call of its own, and the conv's entry then reads its output."""
    _, (spec, params, vels, grads) = _update_inputs(name)
    seen = []

    def spy(entries, inplace=False):
        assert inplace
        # the entries as the call reads them (the call overwrites them)
        seen.append([tuple(t.clone() if torch.is_tensor(t) else t
                           for t in e) for e in entries])
        return update.plain_sgd_update_many(entries, inplace)
    launches = update.sgd_update_launches
    new_params, _ = fused.apply_updates(spec, params, vels, grads, many=spy)
    assert [len(e) for e in seen] == calls
    assert update.sgd_update_launches == launches   # no kernel on the CPU
    if name == "autoencoder_tied":
        first = update.plain_sgd_update_many(seen[0])[0][0]
        assert torch.equal(seen[1][0][0], first)     # the tie's new W
        assert new_params[3] == (None, None)


# -- the activations of a step go through the kernels' helpers --------------
#: model → (its config tree, the tree's keys for a small run, the
#: non-linear activations (forward calls of a train step, of an eval
#: step), (backward calls of a train step, of an eval step)): MNIST's tanh
#: fc; CIFAR's two tanh convs and tanh fc; AlexNet's five strict-ReLU
#: convs and two fc, conv1's and conv2's derivatives folded into the
#: LRN→pool pairs; the autoencoder linear throughout
ACT_CALLS = {
    "mnist": ("mnist", {"synthetic": {"n_train": 40, "n_valid": 20,
                                      "n_test": 20},
                        "minibatch_size": 20}, (1, 1), (1, 0)),
    "cifar": ("cifar", {"synthetic": {"n_train": 20, "n_valid": 10,
                                      "n_test": 10, "size": 16},
                        "minibatch_size": 10}, (3, 3), (3, 0)),
    "alexnet": ("alexnet", {"synthetic": {"n_train": 8, "n_valid": 4,
                                          "n_test": 4},
                            "minibatch_size": 4, "size": 67,
                            "n_classes": 7,
                            "layers": alexnet.make_layers(
                                7, widths=(8, 12, 8, 8, 8, 24, 16))},
                (7, 7), (5, 0)),
    "autoencoder": ("mnist_ae", {"synthetic": {"n_train": 40, "n_valid": 20,
                                               "n_test": 20},
                                 "minibatch_size": 20}, (0, 0), (0, 0)),
}


@contextlib.contextmanager
def _small(model):
    """ACT_CALLS's small size in the port's config tree of ``model``,
    restored after; yields the sample's module, seeded."""
    tree_name, cfg, _, _ = ACT_CALLS[model]
    # the sample's defaults first: a key read before them would be
    # restored as None
    module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, tree_name)
    saved_syn = tree.synthetic.to_dict()
    saved = {k: tree.get(k) for k in cfg if k != "synthetic"}
    tree.synthetic.update(cfg["synthetic"])
    tree.update({k: v for k, v in cfg.items() if k != "synthetic"})
    prng.seed_all(1234)
    try:
        yield module
    finally:
        tree.synthetic.update(saved_syn)
        tree.update(saved)


def _small_sample(model):
    """The port's sample ``model`` initialized on the CPU at ACT_CALLS's
    small size."""
    with _small(model) as module:
        wf = getattr(module, MODELS[model][0])()
        wf.initialize(device="cpu")
    return wf


def _spy_helpers(monkeypatch) -> list:
    """Record "fwd"/"bwd" for each call of the helpers with a non-linear
    activation (the calls that launch a kernel on the card)."""
    seen = []

    def spy(which, real):
        def call(act, *args):
            if act is not activations.Activation:
                seen.append(which)
            return real(act, *args)
        return call
    monkeypatch.setattr(activations, "apply_fwd",
                        spy("fwd", activations.apply_fwd))
    monkeypatch.setattr(activations, "apply_bwd",
                        spy("bwd", activations.apply_bwd))
    return seen


@pytest.mark.parametrize("model", sorted(ACT_CALLS))
def test_a_step_calls_the_kernel_helpers_per_activation(model, monkeypatch):
    wf = _small_sample(model)
    *_, want_fwd, want_bwd = ACT_CALLS[model]
    seen = _spy_helpers(monkeypatch)
    ld = wf.loader
    batch = ld.max_minibatch_size
    x = ld.original_data[:batch]
    t = (ld.original_targets if wf.loss_function == "mse"
         else ld.original_labels)[:batch]
    params, vels = wf.spec_rows(wf.params), wf.spec_rows(wf.vels)
    with torch.no_grad():
        _, _, metrics = fused.train_minibatch(wf.spec, params, vels, x, t)
        train = (seen.count("fwd"), seen.count("bwd"))
        seen.clear()
        fused.eval_minibatch(wf.spec, params, x, t)
        evals = (seen.count("fwd"), seen.count("bwd"))
    assert np.isfinite(float(metrics["loss"]))
    assert (train[0], evals[0]) == want_fwd
    assert (train[1], evals[1]) == want_bwd


@pytest.mark.parametrize("model", ["mnist", "cifar"])
def test_a_unit_graph_epoch_calls_the_kernel_helpers_per_activation(
        model, monkeypatch):
    """The weighted units of the unit graph go through the same helpers:
    each non-linear layer forward on every tick and backward on every
    tick whose GD chain runs (every train tick of one epoch but its
    last), as chip_smoke.py's UNIT_PATHS counts the launches (these two
    fold nothing on the fused step either, so its counts serve)."""
    seen = _spy_helpers(monkeypatch)
    _, cfg, (per_tick, _), (per_gd_tick, _) = ACT_CALLS[model]
    with _small(model) as module:
        module.run(device="cpu", epochs=1, fused=False)
    split, batch = cfg["synthetic"], cfg["minibatch_size"]
    train = -(-split["n_train"] // batch)
    ticks = train + sum(-(-split[k] // batch) for k in ("n_valid",
                                                         "n_test"))
    assert seen.count("fwd") == per_tick * ticks
    assert seen.count("bwd") == per_gd_tick * (train - 1)
