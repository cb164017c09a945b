"""The port's RBM (``ops/rbm.py``, ``nn/rbm_units.py``, ``parallel/rbm.py``
``FusedRBMTrainer`` and the ``models/mnist_rbm.py`` sample) against the
JAX package on the CPU, at tests/test_rbm.py's cases and tolerances:

* the probabilities (rtol 1e-6 of the numpy golden), the Bernoulli draws
  (equal to the reference's numpy and XLA tiers at the same counters) and
  a CD-1 step (rtol 1e-4 / atol 1e-6), the port's torch and numpy forms;
* ``Binarization`` (equal), ``RBM`` (rtol 1e-5 / atol 1e-6) and five
  ``RBMTrainer`` steps on the bars data (errors rtol 1e-4, weights rtol
  1e-4 / atol 1e-6), on the port's torch CPU and numpy devices;
* ``FusedRBMTrainer`` against the unit graph's trainer over two epochs
  (tests/test_rbm.py:132) and against the reference's fused trainer, and
  its plan-fed step (the captured one, run eagerly here: its epoch and
  counter read from the plan row) bit for bit its eager step;
* ``pretrain_stack`` of both packages on the same data, each level's
  weights and hidden biases within rtol 1e-4 / atol 1e-6, the [0, 1]
  rescale folded into level 0; the sample's pretraining and fine-tune on
  both paths, epoch-0 losses within rtol 1e-4 and error counts equal;
* ``python -m znicz_tpu_torch znicz_tpu_torch.models.mnist_rbm`` on the
  CPU, and ``run()`` without a device raising on a host without a card."""

import os
import subprocess
import sys
import zlib

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu import Vector as RefVector
from znicz_tpu import Workflow as RefWorkflow
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device as RefDevice
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist_rbm as ref_mnist_rbm
from znicz_tpu.nn import rbm_units as ref_units
from znicz_tpu.ops import rbm as ref_ops
from znicz_tpu.parallel import rbm as ref_fused_rbm
from znicz_tpu_torch import backends, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.models import mnist_rbm
from znicz_tpu_torch.nn import rbm_units
from znicz_tpu_torch.ops import rbm as rbm_ops
from znicz_tpu_torch.parallel import capture
from znicz_tpu_torch.parallel.rbm import FusedRBMTrainer
from znicz_tpu_torch.workflow import Workflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"minibatch_size": 32, "hidden": [32, 16]}
SMALL_SPLIT = {"n_train": 384, "n_valid": 64, "n_test": 64}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def bars(n, size=4, stream="bars"):
    """tests/test_rbm.py's horizontal and vertical bars, from the port's
    stream (the reference's draws for the same seed)."""
    gen = prng.get(stream)
    data = np.zeros((n, size, size), np.float32)
    for i in range(n):
        if gen.randint(0, 2):
            data[i, gen.randint(0, size), :] = 1.0
        else:
            data[i, :, gen.randint(0, size)] = 1.0
    return data.reshape(n, size * size)


# -- the ops ----------------------------------------------------------------
def test_probs_golden():
    v = np.array([[0.0, 1.0], [0.3, -2.0]], np.float32)
    w = np.array([[1.0, -1.0], [2.0, 0.5]], np.float32)
    hb = np.array([0.5, -0.5], np.float32)
    want = ref_ops.hidden_probs(v, w, hb, np)
    got = rbm_ops.hidden_probs(*map(torch.from_numpy, (v, w, hb)))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)
    np.testing.assert_allclose(rbm_ops.np_hidden_probs(v, w, hb), want,
                               rtol=1e-6)
    vb = np.array([0.1, -0.2], np.float32)
    want = ref_ops.visible_probs(want, w, vb, np)
    got = rbm_ops.visible_probs(got, torch.from_numpy(w),
                                torch.from_numpy(vb))
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-6)


@pytest.mark.parametrize("counters", [(1, 2, 3), (0, 2 ** 32 - 1, 7)])
def test_sampling_identical_across_tiers(counters):
    p = np.random.default_rng(4).uniform(0, 1, (8, 16)).astype(np.float32)
    want = ref_ops.sample_bernoulli(p, 1234, counters, np)
    np.testing.assert_array_equal(np.asarray(ref_ops.sample_bernoulli(
        jnp.asarray(p), 1234, counters, jnp)), want)
    got = rbm_ops.sample_bernoulli(torch.from_numpy(p), 1234, counters)
    np.testing.assert_array_equal(got.numpy(), want)
    np.testing.assert_array_equal(
        rbm_ops.np_sample_bernoulli(p, 1234, counters), want)
    # the epoch and counter as device words (a captured step's)
    words = torch.tensor([counters[1], counters[2]], dtype=torch.int64)
    got = rbm_ops.sample_bernoulli(torch.from_numpy(p), 1234,
                                   (counters[0], words[0:1], words[1:2]))
    np.testing.assert_array_equal(got.numpy(), want)


def test_cd1_step_matches_reference():
    prng.seed_all(1234)
    v0 = bars(16)
    w = prng.get("w").normal(0, 0.01, (16, 8)).astype(np.float32)
    vb, hb = np.zeros(16, np.float32), np.zeros(8, np.float32)
    want_np = ref_ops.np_cd1_step(w, vb, hb, v0, 0.1, 99, (0, 1, 2))
    want_x = ref_ops.xla_cd1_step(*map(jnp.asarray, (w, vb, hb, v0)), 0.1,
                                  99, (0, 1, 2))
    got = rbm_ops.cd1_step(*map(torch.from_numpy, (w, vb, hb, v0)), 0.1, 99,
                           (0, 1, 2))
    got_np = rbm_ops.np_cd1_step(w, vb, hb, v0, 0.1, 99, (0, 1, 2))
    for name, g, gn, a, b in zip("w vb hb recon".split(), got, got_np,
                                 want_np, want_x):
        for want in (a, b):
            np.testing.assert_allclose(g.numpy(), np.asarray(want),
                                       rtol=1e-4, atol=1e-6, err_msg=name)
        np.testing.assert_allclose(gn, a, rtol=1e-4, atol=1e-6,
                                   err_msg=name)


def test_cd1_momentum_step_matches_reference():
    rng = np.random.default_rng(5)
    v0 = (rng.uniform(0, 1, (20, 12)) > 0.5).astype(np.float32)
    params = tuple(rng.normal(0, 0.1, s).astype(np.float32)
                   for s in ((12, 6), (12,), (6,)))
    vels = tuple(rng.normal(0, 0.01, p.shape).astype(np.float32)
                 for p in params)
    want = ref_ops.cd1_momentum_step(params, vels, v0, 0.3, 0.6, 1e-3, 7,
                                     (5, 1, 20), np)
    got = rbm_ops.cd1_momentum_step(
        tuple(map(torch.from_numpy, params)),
        tuple(map(torch.from_numpy, vels)), torch.from_numpy(v0), 0.3, 0.6,
        1e-3, 7, (5, 1, 20))
    for g, w in zip((*got[0], *got[1], got[2]),
                    (*want[0], *want[1], want[2])):
        np.testing.assert_allclose(g.numpy(), w, rtol=1e-4, atol=1e-6)


# -- the units --------------------------------------------------------------
def _wire(pkg, cls, x, device, **kw):
    if pkg == "ref":
        unit = cls(RefWorkflow(name="dummy"), **kw)
        unit.__dict__["input"] = RefVector(np.asarray(x, np.float32))
        unit.initialize(RefDevice.create(device))
        return unit
    dev = backends.get(device)
    unit = cls(Workflow(name="dummy"), **kw)
    unit.__dict__["input"] = Vector(np.asarray(x, np.float32)).initialize(
        dev)
    unit.initialize(dev)
    return unit


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_binarization_matches_reference(device):
    p = np.random.default_rng(6).uniform(0, 1, (6, 10)).astype(np.float32)
    ref_prng.seed_all(7)
    ref = _wire("ref", ref_units.Binarization, p, "numpy")
    prng.seed_all(7)
    port = _wire("port", rbm_units.Binarization, p, device)
    assert port.unit_id == ref.unit_id
    ref.run()
    port.run()
    np.testing.assert_array_equal(port.output.mem, ref.output.mem)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_rbm_forward_matches_reference(device):
    prng.seed_all(1234)
    v = bars(12)
    ref_prng.seed_all(3)
    ref = _wire("ref", ref_units.RBM, v, "xla", n_hidden=8)
    prng.seed_all(3)
    port = _wire("port", rbm_units.RBM, v, device, n_hidden=8)
    np.testing.assert_array_equal(port.weights.mem, ref.weights.mem)
    ref.run()
    port.run()
    np.testing.assert_allclose(port.output.mem, ref.output.mem, rtol=1e-5,
                               atol=1e-6)


def _train(pkg, device, epochs=5, n=64, lr=2.0):
    (ref_prng if pkg == "ref" else prng).seed_all(11)
    prng.seed_all(11)
    v = bars(n)
    units = ref_units if pkg == "ref" else rbm_units
    fwd = _wire(pkg, units.RBM, v, device, n_hidden=12)
    tr = units.RBMTrainer(fwd.workflow, learning_rate=lr)
    tr.setup_from_forward(fwd)
    tr.initialize(fwd.device)
    errs = []
    for _ in range(epochs):
        fwd.run()
        tr.run()
        errs.append(tr.recon_err)
    return errs, fwd, tr


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_trainer_matches_reference(device):
    errs_ref, f_ref, t_ref = _train("ref", "xla")
    errs, f, t = _train("port", device)
    assert t.unit_id == t_ref.unit_id
    np.testing.assert_allclose(errs, errs_ref, rtol=1e-4)
    np.testing.assert_allclose(f.weights.mem, f_ref.weights.mem, rtol=1e-4,
                               atol=1e-6)
    np.testing.assert_allclose(t.velocity_weights.mem,
                               t_ref.velocity_weights.mem, rtol=1e-4,
                               atol=1e-6)


def test_cd1_learns_bars():
    errs, _, _ = _train("port", "cpu", epochs=100)
    assert errs[-1] < errs[0] * 0.1, (errs[0], errs[-1])


# -- the fused trainer --------------------------------------------------------
class _Ld:
    """The loader fields the unit trainer reads."""
    epoch_number = 0
    minibatch_offset = 0
    minibatch_size = 16


def _fused(w0, v, tr, device="cpu", capture_=None):
    return FusedRBMTrainer(
        w0, np.zeros(v.shape[1], np.float32), np.zeros(12, np.float32),
        seed=tr.rng.stream_seed, unit_id=tr.unit_id, learning_rate=0.5,
        momentum=0.6, weights_decay=1e-4, device=device, capture=capture_)


def test_fused_epoch_matches_unit_graph():
    """tests/test_rbm.py:132 on the port: the fused epochs reproduce the
    unit trainer's steps (the same counters, so the same draws)."""
    prng.seed_all(21)
    v = bars(64)
    batch = 16
    dev = backends.get("cpu")
    fwd = _wire("port", rbm_units.RBM, v, "cpu", n_hidden=12)
    tr = rbm_units.RBMTrainer(fwd.workflow, learning_rate=0.5, momentum=0.6,
                              weights_decay=1e-4)
    tr.setup_from_forward(fwd)
    tr.initialize(dev)
    w0 = np.array(fwd.weights.mem)
    ld = _Ld()
    fwd.workflow.loader = ld
    ftr = _fused(w0, v, tr)
    for epoch in range(2):
        ld.epoch_number = epoch
        for off in range(0, len(v), batch):
            fwd.__dict__["input"] = Vector(v[off:off + batch]).initialize(
                dev)
            ld.minibatch_offset = off + batch
            tr.run()
        ftr.train_epoch(torch.from_numpy(v), np.arange(len(v)), batch,
                        epoch)
    assert ftr.host_syncs == 2
    np.testing.assert_allclose(ftr.params[0].numpy(), tr.weights.mem,
                               rtol=1e-4, atol=1e-6)


def test_fused_trainer_matches_reference():
    prng.seed_all(21)
    v = bars(64)
    w0 = prng.get("w").normal(0, 0.01, (16, 12)).astype(np.float32)
    kw = dict(seed=77, unit_id=zlib.crc32(b"rbm_pre0"), learning_rate=0.5,
              momentum=0.6, weights_decay=1e-4)
    zeros = (np.zeros(16, np.float32), np.zeros(12, np.float32))
    ref = ref_fused_rbm.FusedRBMTrainer(w0, *zeros, **kw)
    port = FusedRBMTrainer(w0, *zeros, device="cpu", **kw)
    perm = np.random.default_rng(1).permutation(64)
    for epoch in range(2):
        want = ref.train_epoch(jnp.asarray(v), perm, 16, epoch)
        got = port.train_epoch(torch.from_numpy(v), perm, 16, epoch)
        np.testing.assert_allclose(got, want, rtol=1e-4)
    for g, w in zip(port.params + port.vels, ref.params + ref.vels):
        np.testing.assert_allclose(g.numpy(), np.asarray(w), rtol=1e-4,
                                   atol=1e-6)


class _Direct:
    """A captured graph's stand-in on the CPU: a replay runs the step."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


def test_plan_fed_step_equals_eager_step(monkeypatch):
    calls = []

    def fake(plan, fn):
        calls.append(fn)
        fn()
        return _Direct(fn)
    monkeypatch.setattr(capture.StepPlan, "capture", fake)
    prng.seed_all(21)
    v = torch.from_numpy(bars(64))
    w0 = prng.get("w").normal(0, 0.01, (16, 12)).astype(np.float32)
    runs = []
    for plan_fed in (True, False):
        tr = FusedRBMTrainer(w0, np.zeros(16, np.float32),
                             np.zeros(12, np.float32), seed=5, unit_id=9,
                             learning_rate=0.5, momentum=0.6, device="cpu")
        tr.captured = plan_fed           # the card's path, run here
        means = [tr.train_epoch(v, np.arange(64), 16, e)
                 for e in (0, 1, 2 ** 32 - 1)]
        runs.append((tr, means))
    (tr_p, m_p), (tr_e, m_e) = runs
    assert len(calls) == 1 and m_p == m_e
    for a, b in zip(tr_p.params + tr_p.vels, tr_e.params + tr_e.vels):
        assert torch.equal(a, b)


def test_capture_needs_the_card():
    with pytest.raises(ValueError, match="capture=True"):
        FusedRBMTrainer(np.zeros((2, 2), np.float32), np.zeros(2),
                        np.zeros(2), seed=1, unit_id=1, device="cpu",
                        capture=True)


# -- the sample ---------------------------------------------------------------
@pytest.fixture
def small():
    saved = (ref_root.mnist_rbm.to_dict(), root.mnist_rbm.to_dict())
    for t in (ref_root.mnist_rbm, root.mnist_rbm):
        t.update(SMALL)
        t.synthetic.update(SMALL_SPLIT)
        t.pretrain.update({"epochs": 2})
    yield
    ref_root.mnist_rbm.update(saved[0])
    root.mnist_rbm.update(saved[1])


def test_pretrain_stack_matches_reference(small):
    data = np.random.default_rng(9).normal(0, 1, (256, 64)).astype(
        np.float32)
    kw = dict(epochs=2, learning_rate=0.1, momentum=0.5,
              weights_decay=2e-4, batch=32)
    ref_prng.seed_all(1234)
    want = ref_mnist_rbm.pretrain_stack(data, [24, 8], **kw)
    prng.seed_all(1234)
    trainers = []
    got = mnist_rbm.pretrain_stack(data, [24, 8], device="cpu",
                                   trainers=trainers, **kw)
    assert [t.host_syncs for t in trainers] == [2, 2]
    assert len(got) == len(want) == 2
    for (w, hb), (rw, rhb) in zip(got, want):
        assert w.shape == rw.shape and w.dtype == np.float32
        np.testing.assert_allclose(w, rw, rtol=1e-4, atol=1e-6)
        np.testing.assert_allclose(hb, rhb, rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("fused", [False, True])
def test_sample_matches_reference(small, fused):
    ref_prng.seed_all(1234)
    want = ref_mnist_rbm.run(device=RefDevice.create("xla"), epochs=1,
                             fused=fused)
    prng.seed_all(1234)
    wf = mnist_rbm.run(device="cpu", epochs=1, fused=fused)
    for f, rf in zip(wf.forwards[:1], want.forwards[:1]):
        # the fine-tuned first layer, from the installed level 0
        np.testing.assert_allclose(f.weights.mem, rf.weights.mem,
                                   rtol=1e-3, atol=1e-5)
    got, want = wf.decision.epoch_metrics, want.decision.epoch_metrics
    assert len(got) == len(want) == 1
    for k, v in want[0].items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(got[0][k], v, rtol=1e-4, err_msg=k)
        elif k.endswith("_n_err"):
            assert got[0][k] == v, (k, got, want)


def test_install_pretrained_refuses_a_wrong_shape(small):
    prng.seed_all(1234)
    wf = mnist_rbm.MnistRBMWorkflow()
    wf.initialize(device="cpu")
    with pytest.raises(ValueError, match="pretrained"):
        wf.install_pretrained([(np.zeros((3, 3), np.float32),
                                np.zeros(3, np.float32))])


def test_run_without_a_device_needs_the_card(small):
    if torch.cuda.is_available():
        pytest.skip("this host has a CUDA card")
    with pytest.raises(RuntimeError, match="needs a CUDA device"):
        mnist_rbm.run(epochs=1)


def test_cli_trains_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    sets = ["mnist_rbm.synthetic.n_train=192", "mnist_rbm.synthetic.n_valid=64",
            "mnist_rbm.synthetic.n_test=64", "mnist_rbm.minibatch_size=32",
            "mnist_rbm.pretrain.epochs=1"]
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.mnist_rbm", "--epochs", "1", "--device",
         "cpu", *[a for s in sets for a in ("--set", s)]], cwd=REPO,
        env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "'epoch': 0" in proc.stdout and "train_loss" in proc.stdout
