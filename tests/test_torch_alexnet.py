"""The port's AlexNet sample (znicz_tpu_torch.models.alexnet, BASELINE
config 3) against the JAX package's, on the CPU, at the shrunk size of
tests/test_lrn_pool.py (67×67×3 samples, widths 8-12-8-8-8-24-16, 7
classes, batch 32) with its strict-ReLU convs and both dropout layers:

- the synthetic data, the initial weights and the spec (the merged
  LRN→pool pairs with the folded ReLU derivative, dropout's seed and unit
  ids, the write-back map) equal ``extract_model``'s under ``fused1``;
- one fused train epoch on carried-across weights matches the reference's
  ``FusedTrainer``: under ``fused1`` with its XLA tier, with its Pallas
  kernels in interpret mode, and with both packages on the implicit-GEMM
  conv tier (``ZNICZ_TPU_CONV=pallas``, the reference's tier functions
  seen to run), within rtol 1e-5, and under the default
  ``fused2`` (parity-split convs) within tests/test_lrn_pool.py:289-296's
  tolerances (loss rtol 1e-5 / atol 1e-6, weights rtol 2e-4 / atol 2e-5);
  error counts exactly;
- ``alexnet.run(epochs=2)`` gives the reference ``run_fused``'s metrics
  (the deferred tail step and its dropout keys included);
- conv1's geometry (11×11 stride 4 on C=3, 227 → 55) and conv2's (5×5 pad
  2) through the port's convs, TF32 off, within rtol 1e-4 and an absolute
  1e-5 of the largest element (other summation orders than XLA's);
- the CLI trains the sample on the CPU and refuses ``data_dir``.

The full-width net (62.4 M parameters) is not built here: chip_smoke.py
checks its geometry and parameter count on the card."""

import dataclasses
import os
import subprocess
import sys

import jax
import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import alexnet as ref_alexnet
from znicz_tpu.ops import conv as ref_conv
from znicz_tpu.ops import tuning
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import alexnet
from znicz_tpu_torch.ops import conv
from znicz_tpu_torch.parallel import fused
from test_torch_conv_gemm import assert_both_took_the_tier, pallas_conv_tier

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


@pytest.fixture(autouse=True)
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


def _both(seed=77):
    """(reference workflow on the XLA backend, port workflow on the CPU),
    initialized from the same seed."""
    ref_prng.seed_all(seed)
    ref = ref_alexnet.AlexNetWorkflow()
    ref.initialize(device=Device.create("xla"))
    prng.seed_all(seed)
    port = alexnet.AlexNetWorkflow()
    port.initialize(device="cpu")
    return ref, port


def test_data_weights_and_spec_equal_the_reference(monkeypatch):
    ref, port = _both()
    np.testing.assert_array_equal(port.loader.original_data.numpy(),
                                  np.asarray(ref.loader.original_data.mem))
    np.testing.assert_array_equal(port.loader.original_labels.numpy(),
                                  np.asarray(ref.loader.original_labels.mem))
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused1")
    spec, params, vels = ref_fused.extract_model(ref)
    assert [dataclasses.asdict(la) for la in port.spec.layers] == \
        [dataclasses.asdict(la) for la in spec.layers]
    assert port.spec.unit_index == spec.unit_index
    assert [la.kind for la in spec.layers] == [
        "conv", "lrn_pool", "conv", "lrn_pool", "conv", "conv", "conv",
        "max_pool", "dropout", "fc", "dropout", "fc", "fc"]
    for want, got in ((params, port.spec_rows(port.params)),
                      (vels, port.spec_rows(port.vels))):
        for wp, gp in zip(want, convert.to_numpy(got)):
            for w, g in zip(wp, gp):
                assert (w is None) == (g is None)
                if w is not None:
                    assert g.dtype == w.dtype
                    np.testing.assert_array_equal(g, w)


def _epoch_against_reference(ref, routing, tier, monkeypatch):
    """One train epoch of the reference FusedTrainer and of the port's on
    carried-across weights, over the same shuffled train indices."""
    if routing is None:
        monkeypatch.delenv("ZNICZ_TPU_LRN_POOL", raising=False)
    else:
        monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", routing)
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
    want = tr.train_epoch(data, labels, idx, ld.max_minibatch_size, epoch=3)

    pspec, pparams, pvels = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, params,
        vels, device="cpu", unit_index=spec.unit_index)
    port = fused.FusedTrainer(spec=pspec, params=pparams, vels=pvels,
                              device="cpu")
    got = port.train_epoch(torch.from_numpy(data), torch.from_numpy(labels),
                           idx, ld.max_minibatch_size, epoch=3)
    if calls is not None:
        assert_both_took_the_tier(calls)
    return spec, want, got, tr.params, port.params


@pytest.mark.parametrize("tier", ["xla", "pallas_interpret", "pallas_conv"])
def test_fused1_epoch_matches_reference_trainer(tier, monkeypatch):
    ref, _ = _both()
    spec, want, got, wparams, gparams = _epoch_against_reference(
        ref, "fused1", tier, monkeypatch)
    np.testing.assert_array_equal(got["n_err"], np.asarray(want["n_err"]))
    np.testing.assert_allclose(got["loss"], np.asarray(want["loss"]),
                               rtol=1e-5)
    for i, (wp, gp) in enumerate(zip(wparams, convert.to_numpy(gparams))):
        for w, g in zip(wp, gp):
            assert (w is None) == (g is None)
            if w is not None:
                np.testing.assert_allclose(
                    g, np.asarray(w), rtol=1e-5, atol=1e-7,
                    err_msg=f"layer {i} ({spec.layers[i].kind}) diverged")


def test_default_fused2_epoch_matches_reference_trainer(monkeypatch):
    """The reference's default routing makes conv1 and conv2 emit
    column-parity halves; ``from_reference`` keeps those keys, so the port
    runs the same fused2 routing (split convs, the pair over halves), and
    its epoch stays within the tolerances the reference holds fused2 to
    against fused1."""
    ref, _ = _both()
    spec, want, got, wparams, gparams = _epoch_against_reference(
        ref, None, "xla", monkeypatch)
    assert sum(bool(la.cfg.get("split_out")) for la in spec.layers) == 2
    pspec = convert.from_reference(
        [dataclasses.asdict(la) for la in spec.layers], spec.loss, [], [],
        device="cpu")[0]
    assert [dataclasses.asdict(la) for la in pspec.layers] == \
        [dataclasses.asdict(la) for la in spec.layers]
    np.testing.assert_array_equal(got["n_err"], np.asarray(want["n_err"]))
    np.testing.assert_allclose(got["loss"], np.asarray(want["loss"]),
                               rtol=1e-5, atol=1e-6)
    for wp, gp in zip(wparams, convert.to_numpy(gparams)):
        if wp[0] is not None:
            np.testing.assert_allclose(gp[0], np.asarray(wp[0]), rtol=2e-4,
                                       atol=2e-5)


def test_run_matches_reference_run_fused(monkeypatch):
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused1")
    ref_prng.seed_all(1234)
    want = ref_alexnet.run(device=Device.create("xla"), epochs=2,
                           fused=True).decision.epoch_metrics
    prng.seed_all(1234)
    wf = alexnet.run(device="cpu", epochs=2, fused=True)
    got = wf.decision.epoch_metrics
    assert len(got) == len(want) == 2
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith("_loss"):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)
    # write-back landed each trained row on its layer: the pool, LRN and
    # dropout layers hold no parameters
    assert [p[0] is not None for p in wf.params] == [
        la["type"].startswith(("conv", "all2all", "softmax"))
        for la in wf.layers_config]


#: (x shape, w shape, stride, padding): AlexNet's conv1 at its full
#: spatial size, conv2 at its own with narrow channels
CONV_GEOMS = {"conv1": ((2, 227, 227, 3), (11, 11, 3, 8), 4, 0),
              "conv2": ((2, 27, 27, 16), (5, 5, 16, 12), 1, 2)}


@pytest.mark.parametrize("fn", ["forward", "grad_input", "grad_weights"])
@pytest.mark.parametrize("geom", sorted(CONV_GEOMS))
def test_alexnet_conv_geometries_match_reference(geom, fn):
    assert not torch.backends.cudnn.allow_tf32
    assert not torch.backends.cuda.matmul.allow_tf32
    x_shape, w_shape, stride, padding = CONV_GEOMS[geom]
    rng = np.random.default_rng(11)
    x = rng.standard_normal(x_shape).astype(np.float32)
    w = (rng.standard_normal(w_shape) * 0.1).astype(np.float32)
    out = (x_shape[1] + 2 * padding - w_shape[0]) // stride + 1
    assert out == (55 if geom == "conv1" else 27)
    err = rng.standard_normal((x_shape[0], out, out, w_shape[3])).astype(
        np.float32)
    t, j = torch.from_numpy, jnp.asarray
    if fn == "forward":
        got = conv.conv2d(t(x), t(w), stride, padding).numpy()
        want = ref_conv.xla_conv2d(j(x), j(w), stride, padding)
    elif fn == "grad_input":
        got = conv.conv2d_grad_input(t(err), t(w), x_shape, stride,
                                     padding).numpy()
        want = ref_conv.xla_conv2d_grad_input(j(err), j(w), x_shape, stride,
                                              padding)
    else:
        got = conv.conv2d_grad_weights(t(x), t(err), w_shape, stride,
                                       padding).numpy()
        want = ref_conv.xla_conv2d_grad_weights(j(x), j(err), w_shape,
                                                stride, padding)
    want = np.asarray(want)
    assert got.shape == want.shape and got.dtype == np.float32
    # a weight-gradient element sums 2·55·55 products in another order
    # than XLA's: the absolute tolerance scales with the largest element
    np.testing.assert_allclose(got, want, rtol=1e-4,
                               atol=1e-5 * max(1.0, np.abs(want).max()))


def test_cli_trains_one_epoch_on_the_cpu(tmp_path):
    """The CLI with a config file (narrow widths, which keep the process
    small) and ``--set`` overrides, as a user would shrink the sample."""
    cfg = tmp_path / "small.py"
    cfg.write_text("from znicz_tpu_torch.models.alexnet import make_layers\n"
                   f"root.alexnet.layers = make_layers(10, widths={WIDTHS})\n")
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.alexnet", str(cfg), "--fused", "--epochs",
         "1", "--device", "cpu", "--set", "alexnet.size=67", "--set",
         "alexnet.n_classes=10", "--set", "alexnet.synthetic.n_train=48",
         "--set", "alexnet.synthetic.n_valid=16", "--set",
         "alexnet.synthetic.n_test=16", "--set", "alexnet.minibatch_size=16"],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "'epoch': 0" in ln]
    assert len(lines) == 1 and "validation_loss" in lines[0], proc.stdout


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernels run only on a card")
def test_cuda_epoch_matches_cpu():
    """One epoch of the shrunk net on the card and on the CPU: losses
    within rtol 5e-4 (cuDNN's summation order), error counts within 1% of
    each class."""
    runs = {}
    for dev in ("cpu", "cuda"):
        prng.seed_all(1234)
        runs[dev] = alexnet.run(device=dev, epochs=1).decision \
            .epoch_metrics[0]
    for name, n in (("train", SMALL["n_train"]),
                    ("validation", SMALL["n_valid"]),
                    ("test", SMALL["n_test"])):
        np.testing.assert_allclose(runs["cuda"][f"{name}_loss"],
                                   runs["cpu"][f"{name}_loss"], rtol=5e-4)
        assert abs(runs["cuda"][f"{name}_n_err"]
                   - runs["cpu"][f"{name}_n_err"]) <= 0.01 * n
