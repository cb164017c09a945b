"""The MNIST unit graph of the port (StartPoint → MnistLoader → All2AllTanh
→ All2AllSoftmax → EvaluatorSoftmax → DecisionGD → GDSoftmax → GDTanh →
EndPoint, ``run(fused=False)``) end to end on the CPU at 500/100/100,
against the JAX package's unit graph on the same seed:

* the same initial weights, bit for bit;
* the weights after the first train tick's GD units within rtol 1e-5;
* ``run(epochs=2)`` per-epoch losses within rtol 1e-4 and error counts
  exact, with the reference on its XLA tier and on interpret-mode Pallas.

Inside the port: the numpy device against the CPU torch device, the unit
graph against the fused trainer over one epoch of identical minibatches
(rtol 1e-4, atol 1e-5, the reference's own check), and the GD units
skipped on the final train minibatch."""

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu.ops import tuning
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.parallel.fused import FusedTrainer

SPLIT = {"n_train": 500, "n_valid": 100, "n_test": 100, "noise": 0.35}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def split():
    """Set the synthetic split in both config trees; restore afterwards."""
    saved = (ref_root.mnist.synthetic.to_dict(),
             root.mnist.synthetic.to_dict())

    def set_split(**kw):
        ref_root.mnist.synthetic.update({**SPLIT, **kw})
        root.mnist.synthetic.update({**SPLIT, **kw})
    set_split()
    yield set_split
    ref_root.mnist.synthetic.update(saved[0])
    root.mnist.synthetic.update(saved[1])


def _pair(device="cpu"):
    """Both packages' MNIST workflows, initialized on the same seed."""
    ref_prng.seed_all(1234)
    ref_wf = ref_mnist.MnistWorkflow()
    ref_wf.initialize(device=Device.create("xla"))
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow()
    wf.initialize(device=device)
    return ref_wf, wf


def _assert_metrics(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)


def test_graph_has_the_reference_topology(split):
    ref_wf, wf = _pair()
    names = [u.name for u in wf._topo]
    assert names == [u.name for u in ref_wf._topo]
    assert [type(u).__name__ for u in wf.units] == [
        type(u).__name__ for u in ref_wf.units]


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_initial_weights_are_bit_identical(split, device):
    ref_wf, wf = _pair(device)
    for rf, f, (w, b) in zip(ref_wf.forwards, wf.forwards, wf.params):
        np.testing.assert_array_equal(f.weights.mem,
                                      np.asarray(rf.weights.mem))
        np.testing.assert_array_equal(f.bias.mem, np.asarray(rf.bias.mem))
        # the fused path's params are the units' weights
        np.testing.assert_array_equal(w.numpy(), f.weights.mem)
        np.testing.assert_array_equal(b.numpy(), f.bias.mem)


def test_weights_after_the_first_train_tick(split):
    """Ticks 1–2 serve the test and validation minibatches (GD skipped);
    tick 3 is the first train minibatch, whose GD units update W and b."""
    ref_wf, wf = _pair()
    ref_wf.run(max_ticks=3)
    wf.run(max_ticks=3)
    assert [g.run_count for g in wf.gds] == [1, 1]
    for rf, f in zip(ref_wf.forwards, wf.forwards):
        for name in ("weights", "bias"):
            want = np.asarray(getattr(rf, name).mem)
            got = getattr(f, name).mem
            if name == "bias":      # zeros at init: the update moved it
                assert np.any(got != 0)
            np.testing.assert_allclose(got, want, rtol=1e-5, atol=1e-7,
                                       err_msg=f"{f.name}.{name}")
    for rg, g in zip(ref_wf.gds, wf.gds):
        np.testing.assert_allclose(g.velocity_weights.mem,
                                   np.asarray(rg.velocity_weights.mem),
                                   rtol=1e-5, atol=1e-8)


@pytest.mark.parametrize("tier,noise", [("xla", 0.35), ("xla", 3.0),
                                        ("pallas_interpret", 0.35)])
def test_two_epochs_match_reference_unit_graph(split, monkeypatch, tier,
                                               noise):
    """noise 0.35 is the sample's default; 3.0 makes the classes overlap
    so the error counts are large and their exact agreement is a check."""
    split(noise=noise)
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
        assert tuning.use_pallas()
    ref_prng.seed_all(1234)
    want = ref_mnist.run(device=Device.create("xla"), epochs=2,
                         fused=False).decision.epoch_metrics
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=2, fused=False)
    _assert_metrics(wf.decision.epoch_metrics, want)
    assert wf.decision.epoch_metrics[-1]["train_loss"] \
        < wf.decision.epoch_metrics[0]["train_loss"]
    if noise > 1:
        assert wf.decision.epoch_metrics[-1]["validation_n_err"] > 0


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_short_last_minibatches_match_reference(split, device):
    """Class sizes that are not multiples of the batch: each class's last
    minibatch is short, padded with its last row and masked by the
    evaluator, on both of the port's devices."""
    split(n_train=450, n_valid=130, n_test=70, noise=3.0)
    ref_prng.seed_all(1234)
    want = ref_mnist.run(device=Device.create("xla"), epochs=2,
                         fused=False).decision.epoch_metrics
    prng.seed_all(1234)
    wf = mnist.run(device=device, epochs=2, fused=False)
    _assert_metrics(wf.decision.epoch_metrics, want)
    assert [g.run_count for g in wf.gds] == [9, 9]


def test_numpy_device_matches_torch_cpu(split):
    """The golden numpy units against the torch units (float64 host math
    in places against float32), as the reference's backends_agree."""
    split(noise=3.0)
    prng.seed_all(1234)
    m_np = mnist.run(device="numpy", epochs=2).decision.epoch_metrics
    prng.seed_all(1234)
    m_t = mnist.run(device="cpu", epochs=2).decision.epoch_metrics
    _assert_metrics(m_t, m_np)


def test_unit_graph_matches_fused_trainer_one_epoch(split):
    """Same weights and the same (unshuffled) minibatches: the fused
    step and the units' chain give the same weights after an epoch."""
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow()
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
        ld.minibatch_class = 2
        ld.minibatch_size = len(mb)
        ld.fill_minibatch(mb, 2)
        for f in wf.forwards:
            f.run()
        wf.evaluator.run()
        for g in reversed(wf.gds):
            g.run()
    for (w, b), f in zip(tr.params, wf.forwards):
        np.testing.assert_allclose(w.numpy(), f.weights.mem, rtol=1e-4,
                                   atol=1e-5)
        np.testing.assert_allclose(b.numpy(), f.bias.mem, rtol=1e-4,
                                   atol=1e-5)


def test_gd_units_skip_the_last_train_minibatch(split):
    """2 epochs of 5 train minibatches: each GD unit runs 9 times (the
    final minibatch's tick sets ``complete`` and gate-skips the chain);
    every other unit runs on all 14 ticks."""
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=2)
    counts = {name: n for name, n, _ in wf.time_table()}
    assert counts["gd0_all2all_tanh"] == counts["gd1_softmax"] == 9
    assert counts["fwd0_all2all_tanh"] == counts["fwd1_softmax"] == 14
    assert counts["evaluator"] == counts["decision"] == 14
    assert counts["end_point"] == 1
    assert bool(wf.decision.complete)
    assert [t["epoch"] for t in wf.epoch_timings] == [0, 1]
    assert all(t["ticks"] == 7 for t in wf.epoch_timings)


def test_fused_run_writes_back_into_the_units(split):
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    w0 = wf.forwards[0].weights.mem.copy()
    wf.train(fused=True, max_epochs=1)
    for (w, b), (vw, _), f, g in zip(wf.params, wf.vels, wf.forwards,
                                     wf.gds):
        np.testing.assert_array_equal(f.weights.mem, w.numpy())
        np.testing.assert_array_equal(f.bias.mem, b.numpy())
        np.testing.assert_array_equal(g.velocity_weights.mem, vw.numpy())
    assert not np.array_equal(wf.forwards[0].weights.mem, w0)


def test_fused_path_refuses_the_numpy_device(split):
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="numpy")
    with pytest.raises(ValueError, match="numpy"):
        wf.train(fused=True, max_epochs=1)
