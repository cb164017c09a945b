"""Gradient accumulation, the scaled in-place update and the plan-fed
(captured) step of the port's fused trainer, on the CPU, against the JAX
package on the same numpy inputs:

* ``FusedTrainer(accum_steps=k)`` — 2 over 6 batches and 3 over 5 (a
  trailing partial group) — against the reference's
  ``FusedTrainer(accum_steps=k)`` at rtol 1e-6 / atol 1e-7
  (tests/test_fused_parallel.py:210-265); through dropout and LRN against
  the port's own manual accumulation with explicit per-step RNG
  coordinates at that tolerance, as tests/test_fused_parallel.py:294 holds
  the reference, and against the reference's trainer at rtol 1e-5 / atol
  1e-6; ``run_fused`` with ``root.common.accum_steps = 2`` against the
  reference's at PERF.md §2's tolerances;
* ``accum_steps=1`` bit for bit the per-step path the port ran before
  accumulation (each step's gradients, then the per-tensor update
  written out in torch), and bad values refused with ``ValueError``;
* the update's plain version with a learning-rate scale: at s = 1 bit for
  bit the unscaled form, in place and out of place; at s ≠ 1 within rtol
  2.4e-7 / atol 1e-8 of the reference's ``apply_updates(lr_scale=s)``
  (tests/test_torch_update.py's tolerance against XLA's contracted
  update); a tensor twice among a call's inputs refused;
* the step as the CUDA graph runs it — its indices, mask and scales read
  from the plan at the device step counter, its metrics written at the
  counter — run eagerly here (the capture replaced by direct calls), bit
  for bit the eager step over whole train and eval epochs, with and
  without accumulation, and the SOM's; the launch counts a capture took
  added on each replay."""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

import chip_smoke
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, ops, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import cifar, mnist
from znicz_tpu_torch.ops import update
from znicz_tpu_torch.parallel import capture, fused, som


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _mnist(n_train=300):
    """The reference's tiny MNIST (784→16→10) with decay and momentum:
    its extract_model, the port's copy on the CPU, data and labels."""
    ref_prng.seed_all(1234)
    saved = ref_root.mnist.synthetic.to_dict()
    ref_root.mnist.synthetic.update({"n_train": n_train, "n_valid": 40,
                                     "n_test": 40})
    try:
        wf = ref_mnist.MnistWorkflow(layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
                    "weights_decay": 5e-4}},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}}])
        wf.initialize(device=Device.create("xla"))
    finally:
        ref_root.mnist.synthetic.update(saved)
    spec, params, vels = ref_fused.extract_model(wf)
    port = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    return ((spec, params, vels), port,
            np.asarray(wf.loader.original_data.mem),
            np.asarray(wf.loader.original_labels.mem))


def _copy(pairs):
    return [tuple(None if a is None else np.array(a) for a in p)
            for p in pairs]


def _params_close(got, want, rtol, atol):
    for gp, wp in zip(convert.to_numpy(got), want):
        for g, w in zip(gp, wp):
            assert (g is None) == (w is None)
            if w is not None:
                np.testing.assert_allclose(g, np.asarray(w), rtol=rtol,
                                           atol=atol)


@pytest.mark.parametrize("accum,n_batches", [(2, 6), (3, 5)])
def test_accumulation_matches_reference_trainer(accum, n_batches):
    (spec, params, vels), port, data, labels = _mnist()
    batch = 50
    idx = np.arange(n_batches * batch)
    ref = ref_fused.FusedTrainer(spec=spec, params=_copy(params),
                                 vels=_copy(vels), accum_steps=accum)
    want = ref.train_epoch(data, labels, idx, batch, epoch=0)
    tr = fused.FusedTrainer(spec=port[0], params=port[1], vels=port[2],
                            device="cpu", accum_steps=accum)
    got = tr.train_epoch(torch.from_numpy(data.copy()),
                         torch.from_numpy(labels.copy()), idx, batch,
                         epoch=0)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-6)
    np.testing.assert_array_equal(got["n_err"], want["n_err"])
    _params_close(tr.params, ref.params, 1e-6, 1e-7)
    _params_close(tr.vels, ref.vels, 1e-6, 1e-7)
    # the sums are zero again after the call's last (partial) group
    assert all(torch.count_nonzero(a) == 0 for pair in tr._acc if pair
               for a in pair if a is not None)


def _golden_epoch(spec, params, vels, data, labels, idx, batch):
    """The per-step path before accumulation: each step's gradients, then
    the update written out per tensor in torch with Python-float hypers
    (tests/test_torch_fused.py's golden), out of place."""
    rows, mask, _ = fused.FusedTrainer._idx_matrix(idx, batch)
    for s in range(len(rows)):
        ix = torch.from_numpy(rows[s]).long()
        grads, _ = fused.grad_minibatch(spec, params, data[ix], labels[ix],
                                        torch.from_numpy(mask[s]))
        new_p, new_v = [], []
        for layer, (w, b), (vw, vb), grad in zip(spec.layers, params, vels,
                                                 grads):
            if grad is None:
                new_p.append((w, b))
                new_v.append((vw, vb))
                continue
            out = []
            for t, v, g, (lr, wd, l1, mom) in ((w, vw, grad[0], layer.hypers),
                                              (b, vb, grad[1],
                                               layer.hypers_bias)):
                reg = wd * ((1.0 - l1) * t + 0.5 * l1 * torch.sign(t))
                v2 = mom * v - lr * (g + reg)
                out.append((t + v2, v2))
            new_p.append((out[0][0], out[1][0]))
            new_v.append((out[0][1], out[1][1]))
        params, vels = new_p, new_v
    return params, vels


def test_accum_one_is_the_per_step_path_bit_for_bit():
    _, (spec, params, vels), data, labels = _mnist()
    x, t = torch.from_numpy(data.copy()), torch.from_numpy(labels.copy())
    idx = np.random.default_rng(1).permutation(len(data))[:285]
    want_p, want_v = _golden_epoch(spec, params, vels, x, t, idx, 40)
    tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                            device="cpu", accum_steps=1)
    tr.train_epoch(x, t, idx, 40)
    for got, want in ((tr.params, want_p), (tr.vels, want_v)):
        for gp, wp in zip(got, want):
            for g, w in zip(gp, wp):
                assert torch.equal(g.view(torch.int32), w.view(torch.int32))


@pytest.mark.parametrize("bad", [0, -1, 1.5, True, "2"])
def test_bad_accum_steps_raise(bad):
    _, (spec, params, vels), _, _ = _mnist(40)
    with pytest.raises(ValueError, match="accum_steps"):
        fused.FusedTrainer(spec=spec, params=params, vels=vels,
                           device="cpu", accum_steps=bad)


#: tests/test_fused_parallel.py:299-304's net: conv tanh, LRN, dropout,
#: softmax on 12×12×3
DROPOUT_LAYERS = [
    {"type": "conv_tanh", "->": {"n_kernels": 6, "kx": 3, "padding": 1},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
    {"type": "norm", "->": {"n": 5}},
    {"type": "dropout", "->": {"dropout_ratio": 0.3}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
]


def _dropout_pair():
    """Both packages' CIFAR workflow of DROPOUT_LAYERS at 120/40/40,
    seeded alike; (reference wf, port wf)."""
    syn = {"n_train": 120, "n_valid": 40, "n_test": 40, "noise": 0.3,
           "size": 12}
    out = []
    for tree, module, p, dev in ((ref_root, ref_cifar, ref_prng,
                                  Device.create("xla")),
                                 (root, cifar, prng, "cpu")):
        saved = tree.cifar.synthetic.to_dict(), tree.cifar.minibatch_size
        tree.cifar.synthetic.update(syn)
        tree.cifar.minibatch_size = 30
        try:
            p.seed_all(7)
            wf = module.CifarWorkflow(layers=DROPOUT_LAYERS)
            wf.initialize(device=dev)
        finally:
            tree.cifar.synthetic.update(saved[0])
            tree.cifar.minibatch_size = saved[1]
        out.append(wf)
    return out


def test_accumulation_through_dropout_keys_each_micro_batch():
    ref_wf, wf = _dropout_pair()
    spec = wf.spec
    params, vels = wf.spec_rows(wf.params), wf.spec_rows(wf.vels)
    ld = wf.loader
    idx = np.arange(80, 200)               # the 120 train rows
    tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                            device="cpu", accum_steps=2)
    tr.train_epoch(ld.original_data, ld.original_labels, idx, 30, epoch=5)
    # the port's own manual accumulation, per-step RNG coordinates explicit
    rows, mask, ctrs = tr._idx_matrix(idx, 30)
    p = [tuple(None if a is None else a.clone() for a in pair)
         for pair in params]
    v = [tuple(None if a is None else a.clone() for a in pair)
         for pair in vels]
    acc = fused.grad_zeros(spec, p)
    for i in range(len(rows)):
        ix = torch.from_numpy(rows[i]).long()
        g, _ = fused.grad_minibatch(spec, p, ld.original_data[ix],
                                    ld.original_labels[ix],
                                    torch.from_numpy(mask[i]), epoch=5,
                                    ctr=int(ctrs[i]))
        acc = [None if a is None else tuple(
            None if x is None else x + y for x, y in zip(a, b))
            for a, b in zip(acc, g)]
        if (i + 1) % 2 == 0 or i + 1 == len(rows):
            fused.apply_updates(spec, p, v, acc)
            acc = fused.grad_zeros(spec, p)
    _params_close(tr.params, convert.to_numpy(p), 1e-6, 1e-7)
    # and the reference's trainer on its own copy of the same weights
    rspec, rparams, rvels = ref_fused.extract_model(ref_wf)
    ref = ref_fused.FusedTrainer(spec=rspec,
                                 params=jax.tree_util.tree_map(np.array,
                                                               rparams),
                                 vels=jax.tree_util.tree_map(np.array,
                                                             rvels),
                                 accum_steps=2)
    rld = ref_wf.loader
    ref.train_epoch(rld.original_data.devmem, rld.original_labels.devmem,
                    idx, 30, epoch=5)
    _params_close(tr.params, ref.params, 1e-5, 1e-6)


@pytest.fixture
def mnist_split():
    split = {"n_train": 500, "n_valid": 100, "n_test": 100, "noise": 3.0}
    saved = (ref_root.mnist.synthetic.to_dict(),
             root.mnist.synthetic.to_dict(),
             ref_root.common.get("accum_steps"),
             root.common.get("accum_steps"))
    ref_root.mnist.synthetic.update(split)
    root.mnist.synthetic.update(split)
    yield split
    ref_root.mnist.synthetic.update(saved[0])
    root.mnist.synthetic.update(saved[1])
    ref_root.common.accum_steps = saved[2]
    root.common.accum_steps = saved[3]


def test_run_fused_with_accum_steps_matches_reference(mnist_split):
    ref_root.common.accum_steps = root.common.accum_steps = 2
    ref_prng.seed_all(1234)
    want = ref_mnist.run(device=Device.create("xla"), epochs=2, fused=True)
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=2, fused=True)
    for g, w in zip(wf.decision.epoch_metrics, want.decision.epoch_metrics):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif k.endswith("_n_err"):
                assert abs(g[k] - w[k]) <= 0.001 * mnist_split[
                    {"train": "n_train", "validation": "n_valid",
                     "test": "n_test"}[k.split("_")[0]]]
    for f, (w, b) in zip(want.forwards, wf.params):
        np.testing.assert_allclose(w.numpy(), np.asarray(f.weights.mem),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(b.numpy(), np.asarray(f.bias.mem),
                                   rtol=1e-4, atol=1e-6)


# -- the update with a learning-rate scale, in place ------------------------
def _update_entries(seed, scale=None):
    rng = np.random.default_rng(seed)
    out = []
    for k, shape in enumerate(((37, 129), (129,), (1000,))):
        w, g, v = ((rng.standard_normal(shape) * s).astype(np.float32)
                   for s in (1.0, 0.1, 0.01))
        w[rng.random(shape) < 0.3] = 0.0
        hypers = (0.03, 5e-4 * (k % 2), (0.0, 0.3, 1.0)[k], 0.9)
        out.append(tuple(torch.from_numpy(a) for a in (w, g, v))
                   + (update.fused_constants(hypers), scale))
    return out


@pytest.mark.parametrize("inplace", [False, True])
def test_plain_update_at_a_scale_of_one_is_the_unscaled_update(inplace):
    want = update.plain_sgd_update_many([e[:4] for e in _update_entries(5)])
    entries = _update_entries(5, torch.ones(1))
    got = update.sgd_update_many(entries, inplace=inplace)
    for (a, b), (c, d), e in zip(got, want, entries):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        assert torch.equal(b.view(torch.int32), d.view(torch.int32))
        assert (a is e[0] and b is e[2]) == inplace


@pytest.mark.parametrize("s", [0.5, 0.1, 1.7])
def test_plain_update_at_a_scale_matches_the_reference(s):
    """One fc layer's W and b through the reference's apply_updates at
    lr_scale s (a traced float32, as its scan passes it) and through the
    port's, in place."""
    entries = _update_entries(9, torch.full((1,), s))
    (w, gw, vw, _, _), (b, gb, vb, _, _) = entries[:2]
    layer = ref_fused.LayerSpec(kind="fc", activation="linear",
                                include_bias=True,
                                hypers=(0.03, 5e-4, 0.3, 0.9),
                                hypers_bias=(0.05, 0.0, 0.0, 0.8))
    spec = ref_fused.ModelSpec((layer,), "mse")
    w = torch.randn(37, 129, generator=torch.Generator().manual_seed(2))
    b = torch.randn(129, generator=torch.Generator().manual_seed(3))
    j = jnp.asarray
    want_p, want_v = jax.jit(lambda p, v, g, sc: ref_fused.apply_updates(
        spec, p, v, g, sc))([(j(w.numpy()), j(b.numpy()))],
                           [(j(vw.numpy()), j(vb.numpy()))],
                           [(j(gw.numpy()), j(gb.numpy()))], jnp.float32(s))
    pspec = convert.from_reference([dataclasses.asdict(layer)], "mse", [],
                                   [], device="cpu")[0]
    params, vels = [(w.clone(), b.clone())], [(vw.clone(), vb.clone())]
    fused.apply_updates(pspec, params, vels, [(gw, gb)], entries[0][4])
    for got, want in ((params, want_p), (vels, want_v)):
        for g, w2 in zip(got[0], want[0]):
            np.testing.assert_allclose(g.numpy(), np.asarray(w2),
                                       rtol=2.4e-7, atol=1e-8)


@pytest.mark.parametrize("where", ["same_entry", "across_entries"])
def test_a_tensor_twice_among_the_inputs_is_refused(where):
    entries = [list(e) for e in _update_entries(3)]
    if where == "same_entry":
        entries[1][1] = entries[1][0]            # grad is w
    else:
        entries.append((entries[1][0], entries[1][1].clone(),
                        entries[1][2].clone(), entries[1][3], None))
    with pytest.raises(ValueError, match="also"):
        update.sgd_update_many([tuple(e) for e in entries], inplace=True)


def test_a_scale_must_be_one_float32_on_the_device():
    entries = _update_entries(4, torch.ones(2))
    with pytest.raises(ValueError, match="scale"):
        update.sgd_update_many(entries)


# -- the plan-fed step, run eagerly -----------------------------------------
class _Direct:
    """Stands in for a captured graph on the CPU: the capture runs the
    step once (the eager step the capture follows), a replay runs it
    again."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def direct(monkeypatch):
    captured = []

    def fake(plan, fn):
        captured.append(fn)
        fn()
        return _Direct(fn)
    monkeypatch.setattr(capture.StepPlan, "capture", fake)
    return captured


def _hand_spec():
    rng = np.random.default_rng(0)
    hyp, hyp_b = (0.05, 1e-3, 0.3, 0.9), (0.02, 1e-4, 0.5, 0.8)
    layers = (fused.LayerSpec("fc", "tanh", True, hyp, hyp_b),
              fused.LayerSpec("fc", "linear", True, hyp, hyp_b))
    params = [tuple((rng.standard_normal(s) * 0.3).astype(np.float32)
                    for s in ((24, 12), (12,))),
              tuple((rng.standard_normal(s) * 0.3).astype(np.float32)
                    for s in ((12, 6), (6,)))]
    vels = [tuple(np.zeros_like(a) for a in p) for p in params]
    data = torch.from_numpy(rng.standard_normal((90, 24)).astype(np.float32))
    target = torch.from_numpy(rng.integers(0, 6, 90).astype(np.int32))
    return fused.ModelSpec(layers, "softmax"), params, vels, data, target


@pytest.mark.parametrize("accum", [1, 2, 3])
def test_plan_fed_steps_equal_the_eager_steps(direct, accum):
    spec, params, vels, data, target = _hand_spec()
    idx = np.random.default_rng(4).permutation(90)[:85]
    scales = np.linspace(1.0, 0.5, 6).astype(np.float32)
    runs = []
    for planned in (False, True):
        tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                                device="cpu", accum_steps=accum)
        if planned:
            tr.uncaptured_reason = None        # the card's path, run here
        runs.append((tr.train_epoch(data, target, idx, 16, lr_scale=scales,
                                    lr_scale_bias=0.7),
                     tr.eval_epoch(data, target, idx, 16),
                     tr.train_epoch(data, target, idx[:40], 16),
                     tr.params, tr.vels))
    for a, b in zip(runs[0][:3], runs[1][:3]):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    for rows_a, rows_b in zip(runs[0][3:], runs[1][3:]):
        for pa, pb in zip(rows_a, rows_b):
            for x, y in zip(pa, pb):
                assert torch.equal(x.view(torch.int32), y.view(torch.int32))
    # one capture a variant: train (and accumulate), eval
    assert len(direct) == (2 if accum == 1 else 3)


def test_plan_fed_som_steps_equal_the_eager_steps(direct):
    rng = np.random.default_rng(6)
    w = rng.standard_normal((16, 2)).astype(np.float32)
    data = torch.from_numpy(rng.standard_normal((200, 2)).astype(np.float32))
    runs = []
    for planned in (False, True):
        tr = som.FusedSOMTrainer(w, (4, 4), device="cpu")
        tr.captured = planned
        diffs = [tr.train_epoch(data, np.arange(200)[::-1], 20, lr, sigma)
                 for lr, sigma in ((0.5, 2.0), (0.3, 1.2))]
        runs.append((diffs, tr.weights))
    assert runs[0][0] == runs[1][0]
    assert torch.equal(runs[0][1], runs[1][1])
    assert len(direct) == 1


def test_a_replay_adds_the_launches_its_capture_took():
    before = update.sgd_update_launches
    graph = capture.StepGraph(_Direct(lambda: None),
                              [(update, "sgd_update_launches", 2)])
    graph.replay()
    graph.replay()
    assert update.sgd_update_launches == before + 4


def test_every_kernel_counter_is_one_the_trainer_counts():
    """The counters ``ops.launch_counts`` reads (and a capture moves) are
    chip_smoke.py's, one for each kernel it checks."""
    names = {(m, a) for _, _, m, a in chip_smoke.KERNELS.values()}
    assert set(ops.launch_counts()) == names


def test_the_trainer_reports_why_it_runs_uncaptured():
    spec, params, vels, _, _ = _hand_spec()
    tr = fused.FusedTrainer(spec=spec, params=params, vels=vels,
                            device="cpu")
    assert not tr.captured and "cpu" in tr.uncaptured_reason
    with pytest.raises(ValueError, match="capture=True"):
        fused.FusedTrainer(spec=spec, params=params, vels=vels,
                           device="cpu", capture=True)
    drop = fused.ModelSpec(spec.layers[:1] + (fused.LayerSpec(
        "dropout", "linear", False, (0.0,) * 4, (0.0,) * 4,
        (("ratio", 0.5), ("seed", 1), ("unit_id", 2))),) + spec.layers[1:],
        "softmax")
    tr = fused.FusedTrainer(spec=drop, params=[params[0], (None, None),
                                               params[1]],
                            vels=[vels[0], (None, None), vels[1]],
                            device="cpu")
    tr.device = torch.device("cuda")            # as on the card
    assert "dropout" in tr._uncaptured(None)
