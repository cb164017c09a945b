"""The port's dropout units (nn/dropout.py) and the unit graph they complete,
AlexNet's (``models.alexnet.run(fused=False)``), against the JAX package
on the CPU:

* the keep masks and outputs bit-equal to the JAX units' at the same
  counters ``(crc32(name), epoch, minibatch offset)``: the port's numpy
  device materialises the mask as the reference's numpy tier does; its
  torch device leaves the ``mask`` Vector empty and the backward
  regenerates the stream from the same key, as the reference's Pallas
  mode does; evaluation is the identity;
* the shrunk AlexNet of tests/test_torch_alexnet.py (67×67×3, widths
  8-12-8-8-8-24-16, 7 classes, batch 32, both dropout layers) on the unit
  graph against the JAX numpy-device unit graph for one epoch, at
  tests/test_torch_alexnet.py's tolerances (losses rtol 1e-5, error counts
  exact), on the port's cpu and numpy devices, and for two epochs with
  the weights and biases at the end;
* the CLI trains AlexNet's unit graph.

Card-only cases hold the units on the card against the CPU bit for bit,
with the dropout kernel's launches; they skip on a host without a card."""

import os
import subprocess
import sys
import zlib

import numpy as np
import pytest
import torch

from znicz_tpu import Vector as RefVector
from znicz_tpu import Workflow as RefWorkflow
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device as RefDevice
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import alexnet as ref_alexnet
from znicz_tpu.nn import dropout as ref_dropout
from znicz_tpu.loader.base import TRAIN as REF_TRAIN, VALID as REF_VALID
from znicz_tpu_torch import backends, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.loader.base import TRAIN, VALID
from znicz_tpu_torch.memory import Vector
from znicz_tpu_torch.models import alexnet
from znicz_tpu_torch.nn import dropout
from znicz_tpu_torch.ops import dropout as drop_ops
from znicz_tpu_torch.workflow import Workflow

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"n_train": 64, "n_valid": 32, "n_test": 32, "noise": 0.4}
WIDTHS = (8, 12, 8, 8, 8, 24, 16)
N_CLASSES = 7


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Loader:
    """The loader fields the dropout units read."""

    def __init__(self, klass, epoch, offset):
        self.minibatch_class = klass
        self.epoch_number = epoch
        self.minibatch_offset = offset


def _arrays(shape, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal(shape).astype(np.float32),
            rng.standard_normal(shape).astype(np.float32))


def _ref_pair(x, err, klass, epoch, offset, device="numpy"):
    wf = RefWorkflow(name="ref")
    wf.loader = _Loader(klass, epoch, offset)
    f = ref_dropout.DropoutForward(wf, name="fwd10_dropout",
                                   dropout_ratio=0.4)
    f.__dict__["input"] = RefVector(x.copy())
    f.initialize(RefDevice.create(device))
    f.run()
    g = ref_dropout.DropoutBackward(wf)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = RefVector(err.copy())
    g.initialize(f.device)
    g.run()
    return f, g


def _port_pair(x, err, klass, epoch, offset, device):
    dev = backends.get(device)
    wf = Workflow(name="port")
    wf.loader = _Loader(klass, epoch, offset)
    f = dropout.DropoutForward(wf, name="fwd10_dropout", dropout_ratio=0.4)
    f.__dict__["input"] = Vector(x.copy()).initialize(dev)
    f.initialize(dev)
    f.run()
    g = dropout.DropoutBackward(wf)
    g.setup_from_forward(f)
    g.__dict__["err_output"] = Vector(err.copy()).initialize(dev)
    g.initialize(dev)
    g.run()
    return f, g


@pytest.mark.parametrize("device", ["cpu", "numpy"])
@pytest.mark.parametrize("epoch, offset", [(0, 32), (3, 96), (1, 2 ** 32 - 1)])
def test_train_masks_are_the_reference_units(device, epoch, offset):
    assert (TRAIN, VALID) == (REF_TRAIN, REF_VALID)
    x, err = _arrays((4, 3, 2, 10))
    ref_prng.seed_all(42)
    rf, rg = _ref_pair(x, err, TRAIN, epoch, offset)
    prng.seed_all(42)
    f, g = _port_pair(x, err, TRAIN, epoch, offset, device)
    assert f.unit_id == rf.unit_id == zlib.crc32(b"fwd10_dropout")
    assert f.counters() == (f.unit_id, epoch, offset)
    mask = np.asarray(rf.mask.mem)
    assert 0.4 < (mask > 0).mean() < 0.8
    np.testing.assert_array_equal(f.output.mem, np.asarray(rf.output.mem))
    np.testing.assert_array_equal(g.err_input.mem,
                                  np.asarray(rg.err_input.mem))
    np.testing.assert_array_equal(g.err_input.mem, err * mask)
    if device == "numpy":
        np.testing.assert_array_equal(f.mask.mem, mask)
    else:   # Pallas-mode contract: no mask; the backward re-derives it
        assert not f.mask
        want = drop_ops.plain_make_mask(prng.get("dropout").stream_seed,
                                        f.counters(), x.shape, 0.4).numpy()
        np.testing.assert_array_equal(want, mask)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_eval_is_the_identity(device):
    """Both directions, as the reference's numpy tier's all-ones mask."""
    x, err = _arrays((4, 10), seed=2)
    f, g = _port_pair(x, err, VALID, 2, 8, device)
    rf, rg = _ref_pair(x, err, VALID, 2, 8)
    np.testing.assert_array_equal(f.output.mem, x)
    np.testing.assert_array_equal(f.output.mem, np.asarray(rf.output.mem))
    np.testing.assert_array_equal(g.err_input.mem, err)
    np.testing.assert_array_equal(g.err_input.mem,
                                  np.asarray(rg.err_input.mem))


def test_distinct_units_draw_distinct_masks():
    x, err = _arrays((8, 16), seed=3)
    dev = backends.get("numpy")
    wf = Workflow(name="port")
    wf.loader = _Loader(TRAIN, 0, 16)
    masks = []
    for name in ("fwd10_dropout", "fwd12_dropout"):
        f = dropout.DropoutForward(wf, name=name)
        f.__dict__["input"] = Vector(x.copy()).initialize(dev)
        f.initialize(dev)
        f.run()
        masks.append(f.mask.mem)
    assert not np.array_equal(*masks)


# -- AlexNet's unit graph -----------------------------------------------------
@pytest.fixture
def small_net():
    """The shrunk net in both config trees; restored after."""
    saved = [(t.alexnet.synthetic.to_dict(),
              {k: t.alexnet.get(k) for k in ("minibatch_size", "size",
                                             "n_classes", "layers")})
             for t in (ref_root, root)]
    for t, mod in ((ref_root, ref_alexnet), (root, alexnet)):
        t.alexnet.synthetic.update(SMALL)
        t.alexnet.update({"minibatch_size": 32, "size": 67,
                          "n_classes": N_CLASSES})
        t.alexnet.layers = mod.make_layers(N_CLASSES, widths=WIDTHS)
    yield
    for t, (syn, top) in zip((ref_root, root), saved):
        t.alexnet.synthetic.update(syn)
        t.alexnet.update(top)


def _reference_run(epochs):
    """``epochs`` of the JAX unit graph on its numpy device (the golden
    units): its epoch metrics, and its units' weights and biases."""
    saved = (ref_root.alexnet.synthetic.to_dict(),
             {k: ref_root.alexnet.get(k) for k in ("minibatch_size", "size",
                                                   "n_classes", "layers")})
    ref_root.alexnet.synthetic.update(SMALL)
    ref_root.alexnet.update({"minibatch_size": 32, "size": 67,
                             "n_classes": N_CLASSES})
    ref_root.alexnet.layers = ref_alexnet.make_layers(N_CLASSES,
                                                      widths=WIDTHS)
    try:
        ref_prng.seed_all(1234)
        wf = ref_alexnet.run(device=RefDevice.create("numpy"),
                             epochs=epochs, fused=False)
        return wf.decision.epoch_metrics, [
            np.asarray(f.weights.mem) for f in wf.forwards if f.weights], [
            np.asarray(f.bias.mem) for f in wf.forwards if f.bias]
    finally:
        ref_root.alexnet.synthetic.update(saved[0])
        ref_root.alexnet.update(saved[1])


@pytest.fixture(scope="module")
def reference_epoch():
    """One epoch of the reference, computed once for the module."""
    return _reference_run(1)


@pytest.fixture(scope="module")
def reference_two_epochs():
    """Two epochs of the reference: epoch 1 draws its dropout masks at
    other counters and starts from weights the GD chain moved."""
    return _reference_run(2)


def _assert_metrics_match(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k, v in w.items():
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], v, rtol=1e-5, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == v, (k, got, want)


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_alexnet_unit_graph_matches_reference_one_epoch(small_net, device,
                                                        reference_epoch):
    want, want_w, _ = reference_epoch
    prng.seed_all(1234)
    wf = alexnet.run(device=device, epochs=1, fused=False)
    got = wf.decision.epoch_metrics
    assert len(got) == len(want) == 1
    assert sorted(got[0]) == sorted(want[0])
    for k, w in want[0].items():
        if k.endswith("_loss"):
            np.testing.assert_allclose(got[0][k], w, rtol=1e-5, err_msg=k)
        elif k.endswith("_n_err") or k == "epoch":
            assert got[0][k] == w, (k, got, want)
    # the GD chain ran on the train ticks: the weights moved as the
    # reference's (conv and fc products in another summation order)
    got_w = [f.weights.mem for f in wf.forwards if f.weights]
    assert len(got_w) == len(want_w) == 8
    for g, w in zip(got_w, want_w):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)
    names = [type(u).__name__ for u in wf.forwards]
    assert names.count("DropoutForward") == 2
    assert not any(f.mask for f in wf.forwards
                   if isinstance(f, dropout.DropoutForward)) \
        or device == "numpy"


@pytest.mark.parametrize("device", ["cpu", "numpy"])
def test_alexnet_unit_graph_matches_reference_two_epochs(
        small_net, device, reference_two_epochs):
    """Past epoch 0 as well: both epochs' metrics, and the weights and
    biases at the end, at the one-epoch case's tolerances."""
    want, want_w, want_b = reference_two_epochs
    prng.seed_all(1234)
    wf = alexnet.run(device=device, epochs=2, fused=False)
    _assert_metrics_match(wf.decision.epoch_metrics, want)
    got_w = [f.weights.mem for f in wf.forwards if f.weights]
    got_b = [f.bias.mem for f in wf.forwards if f.bias]
    assert len(got_w) == len(want_w) == 8 and len(got_b) == len(want_b)
    for g, w in zip(got_w + got_b, want_w + want_b):
        np.testing.assert_allclose(g, w, rtol=1e-4, atol=1e-6)


def test_cli_trains_alexnet_on_the_unit_graph(tmp_path):
    cfg = tmp_path / "small.py"
    cfg.write_text("from znicz_tpu_torch.models.alexnet import make_layers\n"
                   f"root.alexnet.layers = make_layers(10, widths={WIDTHS})\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.alexnet", str(cfg), "--epochs", "1",
         "--device", "cpu", "--set", "alexnet.size=67", "--set",
         "alexnet.n_classes=10", "--set", "alexnet.synthetic.n_train=32",
         "--set", "alexnet.synthetic.n_valid=16", "--set",
         "alexnet.synthetic.n_test=16", "--set", "alexnet.minibatch_size=16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "'epoch': 0" in ln]
    assert len(lines) == 1 and "validation_loss" in lines[0], proc.stdout


# -- on the card --------------------------------------------------------------
@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
def test_cuda_units_equal_the_cpu_bit_for_bit():
    x, err = _arrays((128, 6, 6, 256), seed=5)
    before = drop_ops.dropout_launches
    f, g = _port_pair(x, err, TRAIN, 1, 384, "cuda")
    torch.cuda.synchronize()
    assert drop_ops.dropout_launches == before + 2
    cf, cg = _port_pair(x, err, TRAIN, 1, 384, "cpu")
    np.testing.assert_array_equal(f.output.mem, cf.output.mem)
    np.testing.assert_array_equal(g.err_input.mem, cg.err_input.mem)
    assert not f.mask
