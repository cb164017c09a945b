"""The port's CIFAR sample (znicz_tpu_torch.models.cifar, BASELINE config
2) against the JAX package's, on the CPU.  Sizes are those of
tests/test_fused_conv.py (16×16×3 samples, 200/80/80, batch 40).

- the synthetic data and the initial weights are bit-identical, and the
  model spec equals ``extract_model``'s;
- one fused train epoch on carried-across weights matches the reference's
  ``FusedTrainer``, with its XLA tier, with its Pallas kernels in
  interpret mode, and with both packages on the implicit-GEMM conv tier
  (``ZNICZ_TPU_CONV=pallas``, the reference's tier functions seen to run):
  weights at rtol 5e-4 / atol 1e-5 (the reference's own tolerance for
  conv stacks, tests/test_fused_conv.py), error counts exactly;
- ``cifar.run(device="cpu", epochs=2)`` gives the reference
  ``run_fused``'s metrics: losses at rtol 5e-4, error counts exactly;
- a second layer config (strided conv, max-abs pooling with padding, a
  custom LRN, padded average pooling) builds the same spec and weights
  and trains the same epoch;
- the CLI trains the sample on the CPU."""

import dataclasses
import json
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu.ops import tuning
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import cifar
from znicz_tpu_torch.parallel import fused
from test_torch_conv_gemm import assert_both_took_the_tier, pallas_conv_tier

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"n_train": 200, "n_valid": 80, "n_test": 80, "noise": 0.3,
         "size": 16}
#: every ported layer option the default config leaves out (an LRN is kept
#: away from a following max pool, which the reference would merge)
OTHER_LAYERS = [
    {"type": "conv_str",
     "->": {"n_kernels": 6, "kx": 3, "ky": 5, "sliding": (2, 1),
            "padding": (2, 1)},
     "<-": {"learning_rate": 0.05, "gradient_moment": 0.5,
            "weights_decay": 1e-3}},
    {"type": "maxabs_pooling", "->": {"kx": 3, "sliding": 2, "padding": 1}},
    {"type": "lrn", "->": {"n": 4, "alpha": 1e-2, "beta": 0.6, "k": 1.0}},
    {"type": "conv_relu", "->": {"n_kernels": 5, "kx": 3, "padding": 1,
                                 "weights_filling": "uniform"},
     "<-": {"learning_rate": 0.05}},
    {"type": "avg_pooling", "->": {"kx": 2, "padding": 1}},
    {"type": "softmax", "->": {"output_sample_shape": 10},
     "<-": {"learning_rate": 0.05}},
]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def small_split():
    """The tiny split and batch 40 in both config trees; restored after."""
    saved = [(t.cifar.synthetic.to_dict(), t.cifar.get("minibatch_size"))
             for t in (ref_root, root)]
    for t in (ref_root, root):
        t.cifar.synthetic.update(SMALL)
        t.cifar.minibatch_size = 40
    yield
    for t, (syn, mb) in zip((ref_root, root), saved):
        t.cifar.synthetic.update(syn)
        t.cifar.minibatch_size = mb


def _both(layers=None, seed=1234):
    """(reference workflow on the XLA backend, port workflow on the CPU),
    initialized from the same seed."""
    ref_prng.seed_all(seed)
    ref = ref_cifar.CifarWorkflow(layers=layers)
    ref.initialize(device=Device.create("xla"))
    prng.seed_all(seed)
    port = cifar.CifarWorkflow(layers=layers)
    port.initialize(device="cpu")
    return ref, port


def _assert_spec_and_weights_equal(ref, port):
    spec, params, vels = ref_fused.extract_model(ref)
    assert [dataclasses.asdict(la) for la in port.spec.layers] == \
        [dataclasses.asdict(la) for la in spec.layers]
    for want, got in ((params, port.params), (vels, port.vels)):
        for wp, gp in zip(want, convert.to_numpy(got)):
            for w, g in zip(wp, gp):
                assert (w is None) == (g is None)
                if w is not None:
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)
    return spec, params, vels


def test_data_weights_and_spec_equal_the_reference():
    ref, port = _both()
    np.testing.assert_array_equal(
        port.loader.original_data.numpy(),
        np.asarray(ref.loader.original_data.mem))
    np.testing.assert_array_equal(
        port.loader.original_labels.numpy(),
        np.asarray(ref.loader.original_labels.mem))
    assert port.loader.class_lengths == ref.loader.class_lengths
    spec, _, _ = _assert_spec_and_weights_equal(ref, port)
    assert [la.kind for la in spec.layers] == [
        "conv", "max_pool", "lrn", "conv", "avg_pool", "fc", "fc"]


def _epoch_against_reference(ref, monkeypatch, tier, json_spec=False):
    """One train epoch of the reference FusedTrainer and of the port's on
    carried-across weights, over the same shuffled train indices."""
    spec, params, vels = ref_fused.extract_model(ref)
    ld = ref.loader
    data = np.array(ld.original_data.mem)
    labels = np.array(ld.original_labels.mem)
    n0, n1, n2 = ld.class_lengths
    idx = np.random.default_rng(7).permutation(np.arange(n0 + n1,
                                                         n0 + n1 + n2))
    calls = None
    if tier == "pallas_interpret":
        monkeypatch.setattr(tuning, "_INTERPRET", True)
        assert tuning.use_pallas()
    elif tier == "pallas_conv":
        calls = pallas_conv_tier(monkeypatch)
    copy = lambda t: jax.tree_util.tree_map(np.array, t)  # noqa: E731
    tr = ref_fused.FusedTrainer(spec=spec, params=copy(params),
                                vels=copy(vels))
    want = tr.train_epoch(data, labels, idx, ld.max_minibatch_size,
                          epoch=0)

    layers = [dataclasses.asdict(la) for la in spec.layers]
    if json_spec:     # as a file would carry it: tuples become lists
        layers = json.loads(json.dumps(layers))
    pspec, pparams, pvels = convert.from_reference(
        layers, spec.loss, params, vels, device="cpu")
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    got = port.train_epoch(torch.from_numpy(data), torch.from_numpy(labels),
                           idx, ld.max_minibatch_size)
    if calls is not None:
        assert_both_took_the_tier(calls)
    np.testing.assert_array_equal(got["n_err"], np.asarray(want["n_err"]))
    np.testing.assert_allclose(got["loss"], np.asarray(want["loss"]),
                               rtol=5e-4)
    for i, (wp, gp) in enumerate(zip(tr.params,
                                     convert.to_numpy(port.params))):
        for w, g in zip(wp, gp):
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_allclose(
                    g, np.asarray(w), rtol=5e-4, atol=1e-5,
                    err_msg=f"layer {i} ({spec.layers[i].kind}) diverged")
    return pspec


@pytest.mark.parametrize("tier", ["xla", "pallas_interpret", "pallas_conv"])
def test_fused_epoch_matches_reference_trainer(tier, monkeypatch):
    ref, _ = _both()
    _epoch_against_reference(ref, monkeypatch, tier)


def test_other_layer_options_match_reference(monkeypatch):
    ref, port = _both(OTHER_LAYERS)
    spec, _, _ = _assert_spec_and_weights_equal(ref, port)
    assert [la.kind for la in spec.layers] == [
        "conv", "maxabs_pool", "lrn", "conv", "avg_pool", "fc"]
    pspec = _epoch_against_reference(ref, monkeypatch, "xla", json_spec=True)
    assert pspec.layers[1].cfg == {"ksize": (3, 3), "stride": (2, 2),
                                   "padding": (1, 1)}


def test_run_matches_reference_run_fused():
    ref_prng.seed_all(1234)
    want = ref_cifar.run(device=Device.create("xla"), epochs=2,
                         fused=True).decision.epoch_metrics
    prng.seed_all(1234)
    got = cifar.run(device="cpu", epochs=2, fused=True).decision.epoch_metrics
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=5e-4, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)
    assert got[-1]["train_loss"] < got[0]["train_loss"]


def test_cli_trains_one_epoch_on_the_cpu():
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.cifar", "--fused", "--epochs", "1",
         "--device", "cpu", "--set", "cifar.synthetic.n_train=120",
         "--set", "cifar.synthetic.n_valid=40",
         "--set", "cifar.synthetic.n_test=40",
         "--set", "cifar.synthetic.size=12", "--set",
         "cifar.minibatch_size=40"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "'epoch': 0" in ln]
    assert len(lines) == 1 and "validation_loss" in lines[0], proc.stdout
