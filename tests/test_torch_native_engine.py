"""The port's binding of the native C++ engine (znicz_tpu_torch.export
``NativeEngine``, ``build_native``) against the JAX package's, on the
CPU.

- the library builds from ``native/znicz_infer.cpp`` and
  ``native/parallel.h`` with the Makefile's flags into the port's
  ``build/`` directory, keyed on both sources, and is reused;
- on one file per chain (every layer kind of tests/test_torch_serving_card.py
  and a port export of MNIST), the port's engine answers bit for bit what
  the reference's does, and within tests/test_native_engine.py:56's
  rtol 1e-4 / atol 1e-5 of the port's own forward;
- a file the C++ loader refuses raises ``IOError`` in both."""

import os

import numpy as np
import pytest
import torch

from znicz_tpu import export as ref_export
from znicz_tpu_torch import cuda_build, export
from znicz_tpu_torch.serving import ServingEngine
from znicz_tpu_torch.serving.engine import output_features, torch_forward
from test_torch_serving_card import CHAINS, write_chain


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module")
def engines():
    return export.NativeEngine(), ref_export.NativeEngine()


def test_the_library_builds_into_the_package_and_is_reused():
    first = export.build_native()
    assert os.path.dirname(first) == str(cuda_build.BUILD_DIR)
    assert os.path.basename(first).startswith("libznicz_infer-")
    assert export.build_native() == first
    mtime = os.path.getmtime(first)
    assert export.build_native(force=True) == first
    assert os.path.getmtime(first) >= mtime


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_native_answers_equal_the_reference_bit_for_bit(name, engines,
                                                        tmp_path):
    path, shape = write_chain(tmp_path / f"{name}.znn", name)
    port, ref = (e.load(path) for e in engines)
    assert port.n_layers == ref.n_layers == len(export.read_znn(path))
    layers = export.read_znn(path)
    feats = output_features(layers, shape)
    x = np.random.default_rng(4).standard_normal(
        (6,) + shape).astype(np.float32)
    got, want = port.infer(x, feats), ref.infer(x, feats)
    assert np.array_equal(got.view(np.int32), want.view(np.int32))
    np.testing.assert_allclose(
        got, torch_forward(layers, torch.from_numpy(x)).numpy(),
        rtol=1e-4, atol=1e-5)


def test_the_native_backend_serves_a_port_export(engines, tmp_path):
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import mnist
    saved = root.mnist.synthetic.to_dict()
    root.mnist.synthetic.update({"n_train": 100, "n_valid": 20,
                                 "n_test": 20})
    try:
        prng.seed_all(8)
        wf = mnist.MnistWorkflow()
        wf.initialize(device="cpu")
    finally:
        root.mnist.synthetic.update(saved)
    path = export.export_workflow(wf, str(tmp_path / "mnist.znn"))
    x = np.asarray(wf.loader.original_data[:7], np.float32)
    native = ServingEngine(path, backend="native")
    want = engines[1].load(path).infer(x, 10)
    assert np.array_equal(native.predict(x), want)
    m = native.metrics()
    assert (m["backend"], m["forward_calls"]) == ("native", 1)
    assert native.warmup((784,)) == 0


def test_a_refused_file_raises_in_both(engines, tmp_path):
    bad = tmp_path / "bad.znn"
    bad.write_bytes(b"NOPE" + b"\0" * 32)
    for eng in engines:
        with pytest.raises(IOError):
            eng.load(str(bad))
