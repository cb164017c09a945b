"""The port's MNIST conv autoencoder (BASELINE config 4: conv 5×5×16 pad 2
→ max-pool 2 → depooling tied to the pool → deconv 16→1, MSE against the
input) against the JAX package's ``MnistAEWorkflow`` on the CPU, at
300/60/60 with batch 60 (tests/test_deconv_units.py's size):

* the same unit topology, data and initial weights, bit for bit;
* ``run(epochs=2)`` on the unit graph (the default entry point): per-epoch
  ``*_mse`` within rtol 5e-4 of the JAX unit graph's (the reference's
  tolerance for conv stacks), on the ``cpu`` and ``numpy`` devices;
* ``run(epochs=2, fused=True)``: per-epoch metrics within rtol 5e-4 of the
  JAX fused run's;
* one fused epoch on carried weights (``convert.from_reference``) against
  ``znicz_tpu.parallel.FusedTrainer``: per-step losses within rtol 5e-4,
  params within atol 1e-5 — also for a deconv tied to the encoder conv;
* the port's fused epoch against its own unit graph over the same
  minibatches, weights within rtol 5e-4 / atol 1e-5, as
  tests/test_deconv_units.py holds the reference's.

The CLI trains it with and without ``--fused``."""

import dataclasses
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import autoencoder as ref_ae
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import autoencoder
from znicz_tpu_torch.parallel import fused

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = {"n_train": 300, "n_valid": 60, "n_test": 60, "noise": 0.35}
RTOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small():
    """The small split and batch in both config trees; restored after."""
    saved = [(t.mnist_ae.synthetic.to_dict(), t.mnist_ae.minibatch_size)
             for t in (ref_root, root)]
    for t in (ref_root, root):
        t.mnist_ae.synthetic.update(SPLIT)
        t.mnist_ae.minibatch_size = 60
    yield
    for t, (syn, mb) in zip((ref_root, root), saved):
        t.mnist_ae.synthetic.update(syn)
        t.mnist_ae.minibatch_size = mb


def _pair(device="cpu", layers=None):
    ref_prng.seed_all(1234)
    ref_wf = ref_ae.MnistAEWorkflow(layers=layers)
    ref_wf.initialize(device=Device.create("xla"))
    prng.seed_all(1234)
    wf = autoencoder.MnistAEWorkflow(layers=layers)
    wf.initialize(device=device)
    return ref_wf, wf


def _assert_metrics(got, want, keys=("_mse", "_loss")):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith(keys):
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_topology_data_and_initial_weights_are_the_reference(small, device):
    ref_wf, wf = _pair(device)
    assert [u.name for u in wf._topo] == [u.name for u in ref_wf._topo]
    assert [type(u).__name__ for u in wf.units] == [
        type(u).__name__ for u in ref_wf.units]
    np.testing.assert_array_equal(wf.loader.original_data.numpy(),
                                  np.asarray(ref_wf.loader.original_data.mem))
    assert wf.loader.original_data.shape[1:] == (28, 28, 1)
    for rf, f in zip(ref_wf.forwards, wf.forwards):
        if rf.weights:
            np.testing.assert_array_equal(f.weights.mem,
                                          np.asarray(rf.weights.mem))
        assert bool(f.include_bias) == bool(rf.include_bias)
    assert wf.forwards[2].input_offset is wf.forwards[1].input_offset
    assert [la.kind for la in wf.spec.layers] == [
        "conv", "max_pool", "depooling", "deconv"]
    assert wf.spec.layers[2].cfg["tie"] == 1


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_unit_graph_two_epochs_match_reference(small, device):
    ref_prng.seed_all(1234)
    want = ref_ae.run(device=Device.create("xla"), epochs=2,
                      fused=False).decision.epoch_metrics
    prng.seed_all(1234)
    wf = autoencoder.run(device=device, epochs=2)
    got = wf.decision.epoch_metrics
    _assert_metrics(got, want)
    assert sorted(got[0]) == ["epoch", "test_mse", "train_mse",
                              "validation_mse"]
    assert got[-1]["train_mse"] < got[0]["train_mse"]
    # the stop tick gate-skips the GD chain: 2·5 train ticks, 9 updates
    counts = {name: n for name, n, _ in wf.time_table()}
    assert counts["gd3_deconv"] == counts["gd0_conv"] == 9
    assert counts["fwd3_deconv"] == counts["evaluator"] == 14


def test_fused_run_matches_reference(small):
    ref_prng.seed_all(1234)
    want = ref_ae.run(device=Device.create("xla"), epochs=2,
                      fused=True).decision.epoch_metrics
    prng.seed_all(1234)
    got = autoencoder.run(device="cpu", epochs=2,
                          fused=True).decision.epoch_metrics
    _assert_metrics(got, want)
    assert "train_mse" in got[0] and "validation_mse" in got[0]


TIED = [
    {"type": "conv", "->": {"n_kernels": 8, "kx": 5, "padding": 2},
     "<-": {"learning_rate": 0.0005, "gradient_moment": 0.9,
            "weights_decay": 1e-3}},
    {"type": "max_pooling", "->": {"kx": 2}},
    {"type": "depooling", "->": {"tie": 1}},
    {"type": "deconv_tanh", "->": {"tie": 0},
     "<-": {"learning_rate": 0.0005, "gradient_moment": 0.5,
            "weights_decay": 1e-3}},
]


@pytest.mark.parametrize("layers", [None, TIED], ids=["config4", "tied"])
def test_fused_epoch_matches_reference_trainer(small, layers):
    """extract_model's spec and weights carried across: one train epoch
    and one eval epoch over the same indices in both trainers."""
    ref_wf, wf = _pair(layers=layers)
    spec, params, vels = ref_fused.extract_model(ref_wf)
    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu", unit_index=spec.unit_index)
    assert (pspec.layers, pspec.loss) == (wf.spec.layers, wf.spec.loss)
    for (w, b), (pw, pb) in zip(convert.to_numpy(pparams),
                                convert.to_numpy(wf.params)):
        for a, c in ((w, pw), (b, pb)):
            assert (a is None) == (c is None)
            if a is not None:
                np.testing.assert_array_equal(a, c)
    data = np.asarray(ref_wf.loader.original_data.mem)
    indices = np.random.default_rng(3).permutation(len(data))[:150]
    ref = ref_fused.FusedTrainer(spec=spec, params=params, vels=vels)
    want = (ref.train_epoch(data, data, indices, 60, epoch=0),
            ref.eval_epoch(data, data, indices, 60))
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    x = torch.from_numpy(np.array(data))
    got = (port.train_epoch(x, x, indices, 60),
           port.eval_epoch(x, x, indices, 60))
    for w, g in zip(want, got):
        np.testing.assert_allclose(g["loss"], w["loss"], rtol=RTOL)
    for want_p, got_p in ((ref.params, port.params), (ref.vels, port.vels)):
        for wp, gp in zip(want_p, convert.to_numpy(got_p)):
            for a, c in zip(wp, gp):
                assert (a is None) == (c is None)
                if a is not None:
                    np.testing.assert_allclose(c, np.asarray(a), rtol=0,
                                               atol=1e-5)


@pytest.mark.parametrize("layers", [None, TIED], ids=["config4", "tied"])
def test_fused_epoch_matches_own_unit_graph(small, layers):
    """Same weights, the same (unshuffled) train minibatches: the fused
    step and the units' chain leave the same weights (the reference's own
    check, tests/test_deconv_units.py)."""
    prng.seed_all(1234)
    wf = autoencoder.MnistAEWorkflow(layers=layers)
    wf.initialize(device="cpu")
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cpu")
    ld = wf.loader
    n0, n1, n2 = ld.class_lengths
    idx = np.arange(n0 + n1, n0 + n1 + n2)
    tr.train_epoch(ld.original_data, ld.original_targets, idx,
                   ld.max_minibatch_size)
    for off in range(0, n2, ld.max_minibatch_size):
        mb = idx[off:off + ld.max_minibatch_size]
        ld.minibatch_class, ld.minibatch_size = 2, len(mb)
        ld.fill_minibatch(mb, 2)
        for f in wf.forwards:
            f.run()
        wf.evaluator.run()
        for g in reversed(wf.gds):
            g.run()
    for i, (f, (w, b)) in enumerate(zip(wf.forwards, tr.params)):
        if w is not None:
            np.testing.assert_allclose(w.numpy(), f.weights.mem, rtol=RTOL,
                                       atol=1e-5, err_msg=f"layer {i}")


def test_fused_run_writes_back_into_the_units(small):
    """After run_fused the units hold the trained weights and velocities
    (a tied deconv keeps its own velocity, its W being the conv's)."""
    prng.seed_all(1234)
    wf = autoencoder.MnistAEWorkflow(layers=TIED)
    wf.initialize(device="cpu")
    w0 = wf.forwards[0].weights.mem.copy()
    wf.train(fused=True, max_epochs=1)
    conv, dec = wf.forwards[0], wf.forwards[3]
    assert dec.weights is conv.weights
    np.testing.assert_array_equal(conv.weights.mem, wf.params[0][0].numpy())
    np.testing.assert_array_equal(wf.gds[3].velocity_weights.mem,
                                  wf.vels[3][0].numpy())
    assert wf.params[3] == (None, None)
    assert not np.array_equal(conv.weights.mem, w0)


def test_fused_path_refuses_what_the_reference_refuses(small):
    """A tied deconv with a trainable layer below the tied conv (or with a
    bias) trains on the unit graph only, as in the reference: the fused
    path refuses it, the unit graph runs it."""
    below = [{"type": "conv", "->": {"n_kernels": 1, "kx": 3, "padding": 1},
              "<-": {"learning_rate": 0.0005}}
             ] + [dict(la) for la in TIED]
    below[2] = {"type": "max_pooling", "->": {"kx": 2}}
    below[3] = {"type": "depooling", "->": {"tie": 2}}
    below[4] = {"type": "deconv", "->": {"tie": 1}}
    prng.seed_all(1234)
    wf = autoencoder.MnistAEWorkflow(layers=below)
    wf.initialize(device="cpu")
    with pytest.raises(NotImplementedError, match="unit graph"):
        wf.train(fused=True, max_epochs=1)
    wf.train(max_epochs=1)
    assert len(wf.decision.epoch_metrics) == 1


@pytest.mark.parametrize("fused_flag", [[], ["--fused"]],
                         ids=["unit_graph", "fused"])
def test_cli_trains_one_epoch_on_the_cpu(fused_flag):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.autoencoder", "--epochs", "1", "--device",
         "cpu", *fused_flag, "--set", "mnist_ae.synthetic.n_train=200",
         "--set", "mnist_ae.synthetic.n_valid=50",
         "--set", "mnist_ae.synthetic.n_test=50"], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'epoch': 0" in proc.stdout and "train_mse" in proc.stdout
