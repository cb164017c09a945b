"""The port's MNIST sample against the JAX package's, end to end on the
CPU: the same seed gives the same synthetic data, initial weights and
shuffles, and the fused runs give the same per-epoch metrics.  Sizes are
those of tests/test_mnist_functional.py (600/200/200), 3 epochs.  Losses
must match at rtol 1e-4 and error counts exactly.  A tiny MSE workflow
covers the regression head, its loader and decision the same way."""

import os
import subprocess
import sys

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import mnist

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SMALL = {"n_train": 600, "n_valid": 200, "n_test": 200, "noise": 0.35}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def sizes():
    """Set the synthetic split in both config trees; restore afterwards."""
    saved = (ref_root.mnist.synthetic.to_dict(),
             root.mnist.synthetic.to_dict())

    def set_sizes(**kw):
        ref_root.mnist.synthetic.update({**SMALL, **kw})
        root.mnist.synthetic.update({**SMALL, **kw})
    set_sizes()
    yield set_sizes
    ref_root.mnist.synthetic.update(saved[0])
    root.mnist.synthetic.update(saved[1])


@pytest.mark.parametrize("name", ["mnist_synthetic", "weights", "loader",
                                  "default"])
def test_prng_streams_are_bit_identical(name):
    ref_prng.seed_all(99)
    prng.seed_all(99)
    a, b = ref_prng.get(name), prng.get(name)
    assert a.stream_seed == b.stream_seed
    np.testing.assert_array_equal(a.normal(0, 1, (5, 3)),
                                  b.normal(0, 1, (5, 3)))
    np.testing.assert_array_equal(a.uniform(-1, 1, 7), b.uniform(-1, 1, 7))
    np.testing.assert_array_equal(a.randint(0, 10, 9), b.randint(0, 10, 9))
    ia, ib = np.arange(20), np.arange(20)
    a.shuffle(ia)
    b.shuffle(ib)
    np.testing.assert_array_equal(ia, ib)


def test_torch_generator_follows_the_stream_seed():
    prng.seed_all(5)
    a = torch.rand(4, generator=prng.get("noise").torch_generator("cpu"))
    prng.seed_all(5)          # reseeding drops and rebuilds the generator
    b = torch.rand(4, generator=prng.get("noise").torch_generator("cpu"))
    prng.seed_all(6)
    c = torch.rand(4, generator=prng.get("noise").torch_generator("cpu"))
    torch.testing.assert_close(a, b, rtol=0, atol=0)
    assert not torch.equal(a, c)


def test_data_weights_and_shuffles_are_equal(sizes):
    ref_prng.seed_all(1234)
    ref_wf = ref_mnist.MnistWorkflow()
    ref_wf.initialize(device=Device.create("xla"))
    prng.seed_all(1234)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    np.testing.assert_array_equal(
        wf.loader.original_data.numpy(),
        np.asarray(ref_wf.loader.original_data.mem))
    np.testing.assert_array_equal(
        wf.loader.original_labels.numpy(),
        np.asarray(ref_wf.loader.original_labels.mem))
    assert wf.loader.class_lengths == ref_wf.loader.class_lengths
    for fwd, (w, b) in zip(ref_wf.forwards, wf.params):
        np.testing.assert_array_equal(w.numpy(), np.asarray(fwd.weights.mem))
        np.testing.assert_array_equal(b.numpy(), np.asarray(fwd.bias.mem))
    for e in range(3):
        np.testing.assert_array_equal(wf.loader.train_permutation(e),
                                      ref_wf.loader.train_permutation(e))


@pytest.mark.parametrize("noise", [0.35, 3.0])
def test_fused_run_matches_reference(sizes, noise):
    """noise 0.35 is the sample's default (separable: few errors); 3.0
    makes the classes overlap so the error counts are large and exact
    agreement is a real check."""
    sizes(noise=noise)
    ref_prng.seed_all(1234)
    ref_metrics = ref_mnist.run(device=Device.create("xla"), epochs=3,
                                fused=True).decision.epoch_metrics
    prng.seed_all(1234)
    metrics = mnist.run(device="cpu", epochs=3,
                        fused=True).decision.epoch_metrics
    assert len(metrics) == len(ref_metrics) == 3
    for got, want in zip(metrics, ref_metrics):
        assert sorted(got) == sorted(want)
        for k in want:
            if k.endswith("_loss"):
                np.testing.assert_allclose(got[k], want[k], rtol=1e-4,
                                           err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert got[k] == want[k], (k, got, want)
    if noise > 1:
        assert metrics[-1]["validation_n_err"] > 0


def test_train_without_fused_trains_on_the_unit_graph(sizes):
    """``fused=False`` (the default) is the unit-graph tick loop: it
    trains, each GD unit skipping only the final train minibatch."""
    prng.seed_all(1234)
    wf = mnist.run(device="cpu", epochs=2, fused=False)
    metrics = wf.decision.epoch_metrics
    assert [m["epoch"] for m in metrics] == [0, 1]
    assert metrics[1]["train_loss"] < metrics[0]["train_loss"]
    steps = -(-SMALL["n_train"] // root.mnist.minibatch_size)
    assert [g.run_count for g in wf.gds] == [2 * steps - 1] * 2


def _cli(*args):
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    return subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         "znicz_tpu_torch.models.mnist", *args],
        cwd=REPO, env=env, capture_output=True, text=True, timeout=120)


def test_cli_trains_one_epoch_on_the_cpu():
    proc = _cli("--fused", "--epochs", "1", "--device", "cpu",
                "--set", "mnist.synthetic.n_train=300",
                "--set", "mnist.synthetic.n_valid=100",
                "--set", "mnist.synthetic.n_test=100",
                "--set", "mnist.minibatch_size=50")
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "'epoch': 0" in ln]
    assert len(lines) == 1 and "validation_loss" in lines[0], proc.stdout


def test_cli_without_fused_trains_on_the_unit_graph():
    proc = _cli("--epochs", "1", "--device", "cpu",
                "--set", "mnist.synthetic.n_train=300",
                "--set", "mnist.synthetic.n_valid=100",
                "--set", "mnist.synthetic.n_test=100")
    assert proc.returncode == 0, proc.stderr
    lines = [ln for ln in proc.stdout.splitlines() if "'epoch': 0" in ln]
    assert len(lines) == 1 and "validation_loss" in lines[0], proc.stdout


def test_cli_numpy_device_trains_on_the_unit_graph():
    proc = _cli("--epochs", "1", "--device", "numpy",
                "--set", "mnist.synthetic.n_train=200",
                "--set", "mnist.synthetic.n_valid=100",
                "--set", "mnist.synthetic.n_test=100")
    assert proc.returncode == 0, proc.stderr
    assert "'epoch': 0" in proc.stdout, proc.stdout


def _with_stochastic_pool(layers):
    """A sample's layers with its max pools made stochastic pools, a layer
    type that still has no unit and no fused kind."""
    return [dict(la, type="stochastic_pooling")
            if la["type"] == "max_pooling" else la for la in layers]


@pytest.mark.parametrize("model", ["cifar", "alexnet"])
def test_cli_without_fused_raises_for_conv_models(model, tmp_path):
    """A conv sample with a layer that has no unit yet — CIFAR or AlexNet
    with stochastic pools — raises in the tick loop, naming the
    conv-stack units it waits for.  (AlexNet's dropout has its unit:
    tests/test_torch_dropout_units.py trains its unit graph.)"""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    sets = {"cifar": ["cifar.synthetic.n_train=20", "cifar.synthetic.size=8",
                      "cifar.synthetic.n_valid=10",
                      "cifar.synthetic.n_test=10"],
            "alexnet": ["alexnet.synthetic.n_train=4", "alexnet.size=67",
                        "alexnet.n_classes=5", "alexnet.synthetic.n_valid=2",
                        "alexnet.synthetic.n_test=2"]}[model]
    args = [a for s in sets for a in ("--set", s)]
    layers = {"cifar": "root.cifar.layers",
              "alexnet": "alexnet.make_layers(5)"}[model]
    config = tmp_path / "stochastic_pool.py"
    config.write_text(
        f"from znicz_tpu_torch.models import {model}  # its defaults\n"
        f"root.{model}.update({{'layers': [\n"
        "    dict(la, type='stochastic_pooling')\n"
        "    if la['type'] == 'max_pooling' else la\n"
        f"    for la in {layers}]}})\n")
    args.insert(0, str(config))
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch",
         f"znicz_tpu_torch.models.{model}", *args, "--epochs", "1",
         "--device", "cpu"], cwd=REPO, env=env, capture_output=True,
        text=True, timeout=120)
    assert proc.returncode != 0
    assert "NotImplementedError" in proc.stderr
    assert "ROADMAP.md queue 1 item 5" in proc.stderr, proc.stderr


@pytest.mark.parametrize("model", ["cifar", "alexnet"])
def test_run_without_fused_raises_for_conv_models(model):
    from znicz_tpu_torch.models import alexnet, cifar
    saved = getattr(root, model).to_dict()
    getattr(root, model).synthetic.update(
        {"n_train": 4, "n_valid": 2, "n_test": 2, "size": 8}
        if model == "cifar" else {"n_train": 4, "n_valid": 2, "n_test": 2})
    if model == "alexnet":
        root.alexnet.update({"size": 67, "n_classes": 5,
                             "layers": _with_stochastic_pool(
                                 alexnet.make_layers(5))})
    else:
        root.cifar.update({"layers": _with_stochastic_pool(
            root.cifar.layers)})
    try:
        module = {"cifar": cifar, "alexnet": alexnet}[model]
        with pytest.raises(NotImplementedError, match="conv"):
            module.run(device="cpu", epochs=1, fused=False)
    finally:
        getattr(root, model).update(saved)


def _mse_workflows(autoencoder: bool):
    """The same tiny MSE model in both packages, on one numpy dataset:
    explicit regression targets, or (autoencoder) the input itself."""
    from znicz_tpu.loader.fullbatch import FullBatchLoaderMSE as RefLoader
    from znicz_tpu.standard_workflow import StandardWorkflow as RefWorkflow
    from znicz_tpu_torch.loader.fullbatch import FullBatchLoaderMSE
    from znicz_tpu_torch.standard_workflow import StandardWorkflow

    rng = np.random.default_rng(3)
    x = rng.standard_normal((100, 12)).astype(np.float32) * 4
    y = None if autoencoder else rng.standard_normal(
        (100, 5)).astype(np.float32)
    n_out = 12 if autoencoder else 5

    def fill(loader, ref: bool):
        def load_data():
            if ref:
                loader.original_data.mem = x.copy()
                loader.original_labels.mem = np.zeros(100, np.int32)
                if y is not None:
                    loader.original_targets.mem = y.copy()
            else:
                loader.original_data = x.copy()
                loader.original_labels = np.zeros(100, np.int32)
                if y is not None:
                    loader.original_targets = y.copy()
            loader.class_lengths = [20, 20, 60]
        loader.load_data = load_data
        return loader

    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 8},
               "<-": {"learning_rate": 0.05, "gradient_moment": 0.5,
                      "weights_decay": 1e-3}},
              {"type": "all2all", "->": {"output_sample_shape": n_out},
               "<-": {"learning_rate": 0.05, "learning_rate_bias": 0.02}}]
    kw = dict(minibatch_size=16, normalization_type="linear")
    ref = RefWorkflow(None, "mse", layers=layers, loss_function="mse",
                      loader=fill(RefLoader(**kw), True),
                      decision_config={"max_epochs": 3})
    port = StandardWorkflow("mse", layers=layers, loss_function="mse",
                            loader=fill(FullBatchLoaderMSE(**kw), False),
                            decision_config={"max_epochs": 3})
    return ref, port


@pytest.mark.parametrize("autoencoder", [False, True])
def test_mse_workflow_matches_reference(autoencoder):
    ref, port = _mse_workflows(autoencoder)
    ref_prng.seed_all(1234)
    ref.initialize(device=Device.create("xla"))
    ref.train(fused=True)
    prng.seed_all(1234)
    port.initialize(device="cpu")
    port.train(fused=True)
    want, got = ref.decision.epoch_metrics, port.decision.epoch_metrics
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith(("_loss", "_mse")):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
    for fwd, (w, b) in zip(ref.forwards, port.params):
        np.testing.assert_allclose(w.numpy(), np.asarray(fwd.weights.mem),
                                   atol=1e-5)
        np.testing.assert_allclose(b.numpy(), np.asarray(fwd.bias.mem),
                                   atol=1e-5)


def _write_idx(path, arr):
    import gzip
    import struct
    with gzip.open(path, "wb") as fh:
        fh.write(struct.pack(">HBB", 0, 0x08, arr.ndim))
        fh.write(struct.pack(f">{arr.ndim}I", *arr.shape))
        fh.write(arr.astype(np.uint8).tobytes())


def test_real_idx_files_load_like_the_reference(tmp_path):
    """Small drop-in IDX files in ``common.mnist_dir``: both loaders read
    the same [test | valid | train] layout and normalize it the same."""
    rng = np.random.default_rng(2)
    for name, n in (("train", 60), ("t10k", 20)):
        _write_idx(tmp_path / f"{name}-images-idx3-ubyte.gz",
                   rng.integers(0, 256, (n, 28, 28)))
        _write_idx(tmp_path / f"{name}-labels-idx1-ubyte.gz",
                   rng.integers(0, 10, n))
    saved = (ref_root.common.get("mnist_dir"), root.common.get("mnist_dir"))
    ref_root.common.mnist_dir = root.common.mnist_dir = str(tmp_path)
    try:
        ref_prng.seed_all(1234)
        ref_loader = ref_mnist.MnistLoader(minibatch_size=10)
        ref_loader.initialize(device=Device.create("numpy"))
        prng.seed_all(1234)
        loader = mnist.MnistLoader(minibatch_size=10)
        loader.initialize(torch.device("cpu"))
    finally:
        ref_root.common.mnist_dir, root.common.mnist_dir = saved
    assert loader.class_lengths == ref_loader.class_lengths == [20, 10, 50]
    np.testing.assert_array_equal(loader.original_data.numpy(),
                                  np.asarray(ref_loader.original_data.mem))
    np.testing.assert_array_equal(loader.original_labels.numpy(),
                                  np.asarray(ref_loader.original_labels.mem))
