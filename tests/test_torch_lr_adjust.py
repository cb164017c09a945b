"""The port's learning-rate schedules (znicz_tpu_torch.nn.lr_adjust) and
their two paths against the JAX package on the same seeds:

* every policy's ``scale(it)`` and ``policy(lr, it)`` equal the
  reference's float for float;
* the MNIST unit graph (``run()``) and fused path (``run_fused()``) with
  an ``lr_adjuster_config`` — by epoch, by minibatch, and with a bias
  policy of its own — against the reference's ``run()``/``run_fused()``
  at 500/100/100 for two epochs: losses within rtol 1e-4 and error counts
  within 0.1% of each class (PERF.md §2), weights and biases within rtol
  1e-4 / atol 1e-6, and the adjuster's rates and iteration count equal;
* ``FusedTrainer.train_epoch(lr_scale=...)``, a scalar and a per-step
  array for the weights and the biases, against the reference's
  ``FusedTrainer.train_epoch`` on carried-across weights (the tolerances
  of tests/test_torch_fused.py: losses rtol 1e-5, error counts exact,
  parameters and velocities atol 1e-5)."""

import dataclasses

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.nn import lr_adjust as ref_lr
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.nn import lr_adjust
from znicz_tpu_torch.parallel import fused

SPLIT = {"n_train": 500, "n_valid": 100, "n_test": 100, "noise": 3.0}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def split():
    saved = (ref_root.mnist.synthetic.to_dict(),
             root.mnist.synthetic.to_dict())
    ref_root.mnist.synthetic.update(SPLIT)
    root.mnist.synthetic.update(SPLIT)
    yield
    ref_root.mnist.synthetic.update(saved[0])
    root.mnist.synthetic.update(saved[1])


POLICIES = {
    "fixed": "fixed",
    "step_exp": "step_exp",
    "step_exp_half_every_3": ("step_exp", {"gamma": 0.5, "step": 3}),
    "exp": "exp",
    "exp_0.7": ("exp", {"gamma": 0.7}),
    "inv": "inv",
    "inv_steep": ("inv", {"gamma": 0.05, "power": 1.5}),
    "arbitrary": ("arbitrary", {"schedule": [(1.0, 2), (0.5, 5),
                                             (0.1, 9)]}),
}


@pytest.mark.parametrize("name", sorted(POLICIES))
def test_policy_equals_the_reference_float_for_float(name):
    got = lr_adjust.make_policy(POLICIES[name])
    want = ref_lr.make_policy(POLICIES[name])
    assert type(got).__name__ == type(want).__name__
    for it in range(60):
        assert got.scale(it) == want.scale(it), it
        assert got(0.03, it) == want(0.03, it), it


def test_make_policy_forms_and_names():
    assert sorted(lr_adjust.POLICIES) == sorted(ref_lr.POLICIES)
    p = lr_adjust.ExpPolicy(0.5)
    assert lr_adjust.make_policy(p) is p
    assert isinstance(lr_adjust.make_policy("inv"), lr_adjust.InvPolicy)


#: adjuster configs: by epoch; by minibatch; by minibatch with a bias
#: policy of its own
ADJUSTERS = {
    "by_epoch": {"policy": ("step_exp", {"gamma": 0.5, "step": 1})},
    "by_minibatch": {"policy": ("exp", {"gamma": 0.9}), "by_epoch": False},
    "bias_policy": {"policy": ("inv", {"gamma": 0.2, "power": 0.75}),
                    "bias_policy": ("arbitrary",
                                    {"schedule": [(1.0, 3), (0.25, 100)]}),
                    "by_epoch": False},
}


def _close(got_wf, want_wf, got_params):
    """Epoch metrics at PERF.md §2's tolerances, then each layer's
    weights and bias (the port's as ``got_params``) at rtol 1e-4 / atol
    1e-6."""
    got, want = got_wf.decision.epoch_metrics, want_wf.decision.epoch_metrics
    assert len(got) == len(want) == 2
    sizes = {"train": SPLIT["n_train"], "validation": SPLIT["n_valid"],
             "test": SPLIT["n_test"]}
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif k.endswith("_n_err"):
                assert abs(g[k] - w[k]) <= 0.001 * sizes[k.split("_")[0]]
    for f, (w, b) in zip(want_wf.forwards, got_params):
        np.testing.assert_allclose(np.asarray(w), np.asarray(f.weights.mem),
                                   rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(np.asarray(b), np.asarray(f.bias.mem),
                                   rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("adj", sorted(ADJUSTERS))
def test_unit_graph_with_an_adjuster_matches_reference(split, adj):
    ref_prng.seed_all(1234)
    want = ref_mnist.run(device=Device.create("xla"), epochs=2, fused=False,
                         lr_adjuster_config=ADJUSTERS[adj])
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=2, fused=False,
                   lr_adjuster_config=ADJUSTERS[adj])
    _close(wf, want, [(f.weights.mem, f.bias.mem) for f in wf.forwards])
    # the adjuster sits between the decision and the GD chain, and the
    # rates it left on the GD units are the reference's
    assert [u.name for u in wf._topo] == [u.name for u in want._topo]
    assert wf.lr_adjuster._minibatches == want.lr_adjuster._minibatches
    for g, rg in zip(wf.gds, want.gds):
        assert (g.learning_rate, g.learning_rate_bias) == (
            rg.learning_rate, rg.learning_rate_bias)


@pytest.mark.parametrize("adj", sorted(ADJUSTERS))
def test_fused_path_with_an_adjuster_matches_reference(split, adj):
    ref_prng.seed_all(1234)
    want = ref_mnist.run(device=Device.create("xla"), epochs=2, fused=True,
                         lr_adjuster_config=ADJUSTERS[adj])
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=2, fused=True,
                   lr_adjuster_config=ADJUSTERS[adj])
    _close(wf, want, [(w.numpy(), b.numpy()) for w, b in wf.params])
    assert wf.lr_adjuster._minibatches == want.lr_adjuster._minibatches


def test_the_adjuster_moves_the_fused_weights(split):
    """The schedule reaches the update: the fused run with a by-epoch
    step_exp adjuster ends on other weights than one without."""
    runs = []
    for cfg in (None, ADJUSTERS["by_epoch"]):
        prng.seed_all(1234)
        runs.append(mnist.run(device="cpu", epochs=2, fused=True,
                              lr_adjuster_config=cfg).params[0][0])
    assert not torch.equal(*runs)


def _mnist_trainers():
    """The reference's FusedTrainer and the port's on a tiny MNIST
    (784→16→10, 300 train rows) from the same weights."""
    ref_prng.seed_all(1234)
    saved = ref_root.mnist.synthetic.to_dict()
    ref_root.mnist.synthetic.update({"n_train": 300, "n_valid": 40,
                                     "n_test": 40})
    try:
        wf = ref_mnist.MnistWorkflow(layers=[
            {"type": "all2all_tanh", "->": {"output_sample_shape": 16},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
                    "weights_decay": 5e-4}},
            {"type": "softmax", "->": {"output_sample_shape": 10},
             "<-": {"learning_rate": 0.03, "gradient_moment": 0.9,
                    "learning_rate_bias": 0.05}}])
        wf.initialize(device=Device.create("xla"))
    finally:
        ref_root.mnist.synthetic.update(saved)
    spec, params, vels = ref_fused.extract_model(wf)
    data = np.asarray(wf.loader.original_data.mem)
    labels = np.asarray(wf.loader.original_labels.mem)
    ref = ref_fused.FusedTrainer(spec=spec, params=params, vels=vels)
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu")
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    return ref, port, data, labels


#: (lr_scale, lr_scale_bias) of one 7-step epoch (300 rows at batch 40,
#: 280 of them used)
SCALES = {
    "scalar": (0.5, None),
    "scalar_and_bias": (0.5, 2.0),
    "per_step": (np.linspace(1.0, 0.25, 7).astype(np.float32), None),
    "per_step_and_bias": (np.linspace(1.0, 0.25, 7).astype(np.float32),
                          np.geomspace(2.0, 0.1, 7).astype(np.float32)),
}


@pytest.mark.parametrize("case", sorted(SCALES))
def test_train_epoch_lr_scale_matches_reference(case):
    ref, port, data, labels = _mnist_trainers()
    lr_scale, lr_scale_bias = SCALES[case]
    indices = np.random.default_rng(3).permutation(len(data))[:280]
    want = ref.train_epoch(data, labels, indices, 40, epoch=0,
                           lr_scale=lr_scale, lr_scale_bias=lr_scale_bias)
    got = port.train_epoch(torch.from_numpy(data.copy()),
                           torch.from_numpy(labels.copy()), indices, 40,
                           epoch=0, lr_scale=lr_scale,
                           lr_scale_bias=lr_scale_bias)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    np.testing.assert_array_equal(got["n_err"], want["n_err"])
    for w_rows, g_rows in ((ref.params, port.params), (ref.vels, port.vels)):
        for wp, gp in zip(w_rows, convert.to_numpy(g_rows)):
            for w, g in zip(wp, gp):
                np.testing.assert_allclose(g, np.asarray(w), rtol=0,
                                           atol=1e-5)


def test_a_scale_of_one_is_the_default():
    """lr_scale 1.0 (the default) and a per-step array of ones give the
    same bits; 0.5 gives others."""
    runs = []
    for scale in (1.0, np.ones(7, np.float32), 0.5):
        _, port, data, labels = _mnist_trainers()
        port.train_epoch(torch.from_numpy(data.copy()),
                         torch.from_numpy(labels.copy()), np.arange(280), 40,
                         lr_scale=scale)
        runs.append(port.params[0][0])
    assert torch.equal(runs[0], runs[1])
    assert not torch.equal(runs[0], runs[2])
