"""The port's ``.znn`` export (znicz_tpu_torch.export) against the JAX
package's, on the CPU.

- MNIST, CIFAR, the conv autoencoder, the shrunk AlexNet of
  tests/test_lrn_pool.py and the SOM: the reference's workflow and the
  port's, built from one seed and given the same weights (new seeded
  draws carried into both, or the port's own after a fused epoch),
  export files equal byte for byte, and each package reads the other's;
- the port's ``read_znn`` equals the reference's field by field, on the
  exports and on the hand-written chains of every layer kind;
- the reader's refusals (bad magic, a short header, a dangling depool
  tie, a bias or weight blob that disagrees with its geometry, a blob
  past the end) are the reference's, message for message;
- the commit writes the reference's manifest (the same fields and
  digest), each package verifies the other's, and a bit-flipped copy
  raises the port's ``ArtifactCorrupt`` on verify and on load."""

import contextlib
import json
import os
import struct

import numpy as np
import pytest
import torch

from znicz_tpu import durability as ref_durability
from znicz_tpu import export as ref_export
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.models import alexnet as ref_alexnet
from znicz_tpu.models import autoencoder as ref_ae
from znicz_tpu.models import cifar as ref_cifar
from znicz_tpu.models import kohonen as ref_kohonen
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu_torch import durability, export, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.models import alexnet, autoencoder, cifar, kohonen, mnist
from znicz_tpu_torch.serving import ServingEngine
from test_torch_serving_card import CHAINS, write_chain

#: config → (tree, split, other keys, (reference, port) workflow classes)
CONFIGS = {
    "mnist": ("mnist", {"n_train": 200, "n_valid": 50, "n_test": 50},
              {}, (ref_mnist.MnistWorkflow, mnist.MnistWorkflow)),
    "cifar": ("cifar", {"n_train": 80, "n_valid": 40, "n_test": 40,
                        "size": 16}, {"minibatch_size": 40},
              (ref_cifar.CifarWorkflow, cifar.CifarWorkflow)),
    "autoencoder": ("mnist_ae", {"n_train": 100, "n_valid": 40,
                                 "n_test": 40}, {"minibatch_size": 40},
                    (ref_ae.MnistAEWorkflow, autoencoder.MnistAEWorkflow)),
    "alexnet": ("alexnet", {"n_train": 32, "n_valid": 16, "n_test": 16},
                {"minibatch_size": 16, "size": 67, "n_classes": 7},
                (ref_alexnet.AlexNetWorkflow, alexnet.AlexNetWorkflow)),
    "som": ("kohonen", {"n_train": 200}, {"minibatch_size": 100},
            (ref_kohonen.KohonenWorkflow, kohonen.KohonenWorkflow)),
}
#: the shrunk AlexNet's widths (tests/test_lrn_pool.py:249-250)
ALEXNET_WIDTHS = (8, 12, 8, 8, 8, 24, 16)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@contextlib.contextmanager
def configured(name: str):
    """``name``'s small split and keys in both config trees; restored
    after."""
    tree, split, keys, _ = CONFIGS[name]
    keys = dict(keys)
    if name == "alexnet":
        keys["layers"] = None               # per tree, below
    saved = []
    for t, mod in ((ref_root, ref_alexnet), (root, alexnet)):
        node = getattr(t, tree)
        saved.append((node, node.synthetic.to_dict(),
                      {k: node.get(k) for k in keys}))
        node.synthetic.update(split)
        node.update({k: v for k, v in keys.items() if k != "layers"})
        if name == "alexnet":
            node.layers = mod.make_layers(keys["n_classes"],
                                          widths=ALEXNET_WIDTHS)
    try:
        yield
    finally:
        for node, syn, top in saved:
            node.synthetic.update(syn)
            node.update(top)


def _pair(name: str, seed: int = 1234):
    """(reference workflow on the numpy device, port workflow on the
    CPU), initialized from one seed."""
    ref_cls, port_cls = CONFIGS[name][3]
    ref_prng.seed_all(seed)
    ref = ref_cls()
    ref.initialize(device=Device.create("numpy"))
    prng.seed_all(seed)
    port = port_cls()
    port.initialize(device="cpu")
    return ref, port


def _units(wf) -> list:
    """The units whose weights export reads, in order."""
    return [wf.forward] if not hasattr(wf, "forwards") else wf.forwards


def _carry(src_units, dst_units) -> None:
    for s, d in zip(src_units, dst_units):
        for attr in ("weights", "bias"):
            v = getattr(s, attr, None)
            if v is not None and v:
                getattr(d, attr).mem = np.array(v.mem, np.float32)


def _fresh_weights(ref, port, seed: int = 9) -> None:
    """New seeded draws for every weight and bias, set on both."""
    rng = np.random.default_rng(seed)
    for r, p in zip(_units(ref), _units(port)):
        for attr in ("weights", "bias"):
            v = getattr(r, attr, None)
            if v is not None and v:
                shape = np.asarray(v.mem).shape
                a = rng.standard_normal(shape).astype(np.float32)
                getattr(r, attr).mem = a
                getattr(p, attr).mem = a.copy()


def _assert_layers_equal(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g.kind, g.activation, g.p) == (w.kind, w.activation, w.p)
        for a, b in ((g.w, w.w), (g.b, w.b)):
            assert (a is None) == (b is None)
            if a is not None:
                assert a.dtype == b.dtype and a.shape == b.shape
                assert np.array_equal(a.view(np.int32), b.view(np.int32))


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_exports_equal_the_reference_byte_for_byte(name, tmp_path):
    with configured(name):
        ref, port = _pair(name)
    _fresh_weights(ref, port)
    want = ref_export.export_workflow(ref, str(tmp_path / "ref.znn"))
    got = export.export_workflow(port, str(tmp_path / "port.znn"))
    with open(want, "rb") as a, open(got, "rb") as b:
        ref_bytes, port_bytes = a.read(), b.read()
    assert port_bytes == ref_bytes
    # each package reads the other's file to the same rows
    _assert_layers_equal(export.read_znn(want), ref_export.read_znn(got))
    kinds = {la.kind for la in export.read_znn(got)}
    assert kinds == {"mnist": {"fc", "softmax"},
                     "cifar": {"conv", "max_pool", "lrn", "avg_pool", "fc",
                               "softmax"},
                     "autoencoder": {"conv", "max_pool", "depool",
                                     "deconv"},
                     "alexnet": {"conv", "max_pool", "lrn", "dropout", "fc",
                                 "softmax"},
                     "som": {"kohonen"}}[name]


def test_the_trained_port_exports_what_the_reference_would(tmp_path):
    """After a fused epoch the units hold the trained weights
    (``write_back``); carried into the reference's units they export to
    the same bytes, and the export serves the trained forward."""
    with configured("mnist"):
        ref, _ = _pair("mnist")
        prng.seed_all(1234)
        port = mnist.run(device="cpu", epochs=1, fused=True)
    first = np.array(port.forwards[0].weights.mem)
    assert not np.array_equal(first, np.asarray(ref.forwards[0].weights.mem))
    _carry(port.forwards, ref.forwards)
    want = ref_export.export_workflow(ref, str(tmp_path / "ref.znn"))
    got = export.export_workflow(port, str(tmp_path / "port.znn"))
    assert open(got, "rb").read() == open(want, "rb").read()
    eng = ServingEngine(got, backend="cpu", buckets=(8,))
    x = np.asarray(port.loader.original_data[:8], np.float32)
    y = eng.predict(x)
    np.testing.assert_allclose(y.sum(axis=1), 1.0, rtol=1e-5)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_read_znn_equals_the_reference_field_by_field(name, tmp_path):
    path, _ = write_chain(tmp_path / f"{name}.znn", name)
    _assert_layers_equal(export.read_znn(path), ref_export.read_znn(path))


def _write(path, rows):
    with open(path, "wb") as fh:
        export._write_header(fh, len(rows))
        for row in rows:
            export._pack_layer(fh, *row)


def _bad_files(tmp_path) -> dict:
    K = export.KIND
    out = {}
    out["bad_magic"] = tmp_path / "bad.znn"
    out["bad_magic"].write_bytes(b"NOPE" + b"\0" * 32)
    out["short_header"] = tmp_path / "stub.znn"
    out["short_header"].write_bytes(b"ZNN1\x02")
    out["short_layer"] = tmp_path / "short_layer.znn"
    out["short_layer"].write_bytes(b"ZNN1" + struct.pack("<I", 1) + b"\0" * 12)
    out["tie_to_avg_pool"] = tmp_path / "tie_avg.znn"
    _write(out["tie_to_avg_pool"], [
        (K["avg_pool"], 0, [2, 2, 0, 0, 2, 2, 0, 0]),
        (K["depool"], 0, [2, 2, 0, 0, 2, 2, 0, 0])])
    out["tie_to_itself"] = tmp_path / "tie_self.znn"
    _write(out["tie_to_itself"], [(K["depool"], 0, [2, 2, 0, 0, 2, 2, 0, 0])])
    out["tie_forward"] = tmp_path / "tie_fwd.znn"
    _write(out["tie_forward"], [
        (K["depool"], 0, [2, 2, 1, 0, 2, 2, 0, 0]),
        (K["max_pool"], 0, [2, 2, 0, 0, 2, 2, 0, 0])])
    w = np.zeros((4, 3), np.float32)
    out["bias_geometry"] = tmp_path / "badb.znn"
    _write(out["bias_geometry"], [(K["fc"], 0, [4, 3], w,
                                   np.zeros(2, np.float32))])
    out["weight_geometry"] = tmp_path / "badw.znn"
    _write(out["weight_geometry"], [(K["conv"], 0, [3, 3, 2, 4, 1, 1, 0, 0],
                                     np.zeros(10, np.float32))])
    out["unknown_kind"] = tmp_path / "kind.znn"
    out["unknown_kind"].write_bytes(
        b"ZNN1" + struct.pack("<I", 1) + struct.pack("<II8i", 99, 0,
                                                     *[0] * 8))
    out["oversized_blob"] = tmp_path / "huge.znn"
    out["oversized_blob"].write_bytes(
        b"ZNN1" + struct.pack("<I", 1) + struct.pack("<II", 0, 0)
        + struct.pack("<8i", 4, 4, 0, 0, 0, 0, 0, 0)
        + struct.pack("<Q", 1 << 60))
    out["truncated_bias_size"] = tmp_path / "trunc.znn"
    out["truncated_bias_size"].write_bytes(
        b"ZNN1" + struct.pack("<I", 1) + struct.pack("<II", 0, 0)
        + struct.pack("<8i", 1, 1, 0, 0, 0, 0, 0, 0) + struct.pack("<Q", 1)
        + np.zeros(1, np.float32).tobytes())
    return out


@pytest.mark.parametrize("case", [
    "bad_magic", "short_header", "short_layer", "tie_to_avg_pool",
    "tie_to_itself", "tie_forward", "bias_geometry", "weight_geometry",
    "unknown_kind", "oversized_blob", "truncated_bias_size"])
def test_reader_refusals_are_the_reference(case, tmp_path):
    path = str(_bad_files(tmp_path)[case])
    with pytest.raises(IOError) as want:
        ref_export.read_znn(path)
    with pytest.raises(IOError) as got:
        export.read_znn(path)
    assert type(got.value) is type(want.value)
    assert str(got.value) == str(want.value)


def test_manifest_is_the_reference_and_each_verifies_the_other(tmp_path):
    port_path, _ = write_chain(tmp_path / "port.znn", "conv")
    ref_path = str(tmp_path / "ref.znn")
    with open(ref_path + ".tmp", "wb") as fh:    # the same bytes, committed
        fh.write(open(port_path, "rb").read())  # by the reference
    ref_export._commit_znn(ref_path)
    got = json.load(open(durability.manifest_path(port_path)))
    want = json.load(open(ref_durability.manifest_path(ref_path)))
    for key in ("created", "artifact"):
        got.pop(key)
        want.pop(key)
    assert got == want
    assert durability.verify(ref_path)["manifest"] is not None
    assert ref_durability.verify(port_path)["manifest"] is not None


def test_a_bit_flipped_copy_is_refused(tmp_path):
    path, _ = write_chain(tmp_path / "m.znn", "mlp")
    blob = bytearray(open(path, "rb").read())
    blob[len(blob) // 2] ^= 0x10
    with open(path, "wb") as fh:
        fh.write(bytes(blob))
    with pytest.raises(durability.ArtifactCorrupt) as info:
        durability.verify(path)
    assert info.value.reason == "digest"
    with pytest.raises(durability.ArtifactCorrupt):
        ServingEngine(path, backend="cpu")
    with pytest.raises(ref_durability.ArtifactCorrupt):
        ref_durability.verify(path)
