"""The port's CIFAR-10 conv net (BASELINE config 2) on the unit graph —
``run(fused=False)``, the reference's default entry point: conv tanh →
max pool → LRN → conv tanh → avg pool → fc tanh → softmax, one minibatch
a tick through the conv, pooling and LRN units — against the JAX
package's unit graph on the CPU, at 300/100/100 on 16×16×3 samples:

* the same topology and initial weights, bit for bit;
* ``run(epochs=2)``: per-epoch losses within rtol 5e-4 (the reference's
  tolerance for conv stacks) and error counts exact, with the reference
  on its XLA tier and on interpret-mode Pallas (its LRN and pool kernels);
* the port's numpy device against its torch CPU device, and its unit
  graph against its own fused trainer over one epoch (rtol 5e-4 / atol
  1e-5); ``run_fused`` reads and writes back the units' weights."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu.ops import tuning
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import cifar
from znicz_tpu_torch.parallel.fused import FusedTrainer

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SPLIT = {"n_train": 300, "n_valid": 100, "n_test": 100, "noise": 0.3,
         "size": 16}
RTOL = 5e-4


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def split():
    saved = (ref_root.cifar.synthetic.to_dict(),
             root.cifar.synthetic.to_dict())
    ref_root.cifar.synthetic.update(SPLIT)
    root.cifar.synthetic.update(SPLIT)
    yield
    ref_root.cifar.synthetic.update(saved[0])
    root.cifar.synthetic.update(saved[1])


def _assert_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)


def test_topology_and_initial_weights_are_the_reference(split):
    ref_prng.seed_all(1234)
    ref_wf = ref_cifar.CifarWorkflow()
    ref_wf.initialize(device=Device.create("xla"))
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow()
    wf.initialize(device="cpu")
    assert [u.name for u in wf._topo] == [u.name for u in ref_wf._topo]
    assert [type(u).__name__ for u in wf.units] == [
        type(u).__name__ for u in ref_wf.units]
    for rf, f in zip(ref_wf.forwards, wf.forwards):
        assert bool(f.weights) == bool(rf.weights)
        if rf.weights:
            np.testing.assert_array_equal(f.weights.mem,
                                          np.asarray(rf.weights.mem))
            np.testing.assert_array_equal(f.bias.mem,
                                          np.asarray(rf.bias.mem))
    # the fused path's spec and params come from the same units
    for (w, _), f in zip(wf.params, wf.forwards):
        if w is not None:
            np.testing.assert_array_equal(w.numpy(), f.weights.mem)


@pytest.mark.parametrize("tier", ["xla", "pallas_interpret"])
def test_two_epochs_match_reference_unit_graph(split, monkeypatch, tier):
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
        assert tuning.use_pallas()
    ref_prng.seed_all(1234)
    want = ref_cifar.run(device=Device.create("xla"), epochs=2,
                         fused=False).decision.epoch_metrics
    prng.seed_all(1234)
    wf = cifar.run(device="cpu", epochs=2)
    got = wf.decision.epoch_metrics
    _assert_metrics(got, want)
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    counts = {name: n for name, n, _ in wf.time_table()}
    assert counts["gd0_conv_tanh"] == counts["gd2_norm"] == 5
    assert counts["fwd2_norm"] == counts["evaluator"] == 10


def test_numpy_device_matches_torch_cpu(split):
    prng.seed_all(1234)
    m_np = cifar.run(device="numpy", epochs=2).decision.epoch_metrics
    prng.seed_all(1234)
    m_t = cifar.run(device="cpu", epochs=2).decision.epoch_metrics
    _assert_metrics(m_t, m_np)


def test_unit_graph_matches_fused_trainer_one_epoch(split):
    """Same weights and the same (unshuffled) minibatches: the fused step
    (with its merged LRN→pool pair) and the units' chain give the same
    weights after an epoch."""
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow()
    wf.initialize(device="cpu")
    tr = FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                      vels=wf.spec_rows(wf.vels), device="cpu")
    ld = wf.loader
    n0, n1, n2 = ld.class_lengths
    idx = np.arange(n0 + n1, n0 + n1 + n2)
    tr.train_epoch(ld.original_data, ld.original_labels, idx,
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
    # no LRN→pool merge in CIFAR (its LRN follows the pool)
    assert wf.spec.unit_index == tuple(range(len(wf.forwards)))
    for f, (w, b) in zip(wf.forwards, tr.params):
        if w is not None:
            np.testing.assert_allclose(w.numpy(), f.weights.mem, rtol=RTOL,
                                       atol=1e-5, err_msg=f.name)
            np.testing.assert_allclose(b.numpy(), f.bias.mem, rtol=RTOL,
                                       atol=1e-5, err_msg=f.name)


def test_fused_run_writes_back_into_the_units(split):
    prng.seed_all(1234)
    wf = cifar.CifarWorkflow()
    wf.initialize(device="cpu")
    w0 = wf.forwards[0].weights.mem.copy()
    wf.train(fused=True, max_epochs=1)
    for (w, b), (vw, _), f, g in zip(wf.params, wf.vels, wf.forwards,
                                     wf.gds):
        if w is None:
            assert not f.weights
            continue
        np.testing.assert_array_equal(f.weights.mem, w.numpy())
        np.testing.assert_array_equal(f.bias.mem, b.numpy())
        np.testing.assert_array_equal(g.velocity_weights.mem, vw.numpy())
    assert not np.array_equal(wf.forwards[0].weights.mem, w0)


def test_cli_trains_the_unit_graph_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    sets = ["cifar.synthetic.n_train=60", "cifar.synthetic.size=8",
            "cifar.synthetic.n_valid=20", "cifar.synthetic.n_test=20"]
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.cifar", "--epochs", "1", "--device", "cpu",
         *[a for s in sets for a in ("--set", s)]], cwd=REPO, env=env,
        capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'epoch': 0" in proc.stdout and "train_loss" in proc.stdout
