"""The port's image loaders (znicz_tpu_torch.loader.image,
``OnTheFlyImageLoader``) and AlexNet's ``data_dir`` pipeline on PNG trees
the tests write with PIL.

``decode_image`` and ``FullBatchImageLoader`` equal the JAX package's bit
for bit (the same PIL decode); ``OnTheFlyImageLoader`` serves the
full-batch loader's rows and labels (rtol 1e-6, the reference's own test
tolerance) and the reference's on-the-fly loader's bit for bit, through
``fetch`` with augmentation too.  ``AlexNetWorkflow(data_dir=...)`` at a
shrunk width trains through ``run_fused`` → ``StreamTrainer`` with the
crop on the device, and its epoch 0 equals the reference's (losses rtol
1e-5, error counts exact, as tests/test_torch_alexnet.py holds the
resident run)."""

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device, NumpyDevice
from znicz_tpu.config import root as ref_root
from znicz_tpu.loader.image import FullBatchImageLoader as RefFullBatch
from znicz_tpu.loader.image import decode_image as ref_decode
from znicz_tpu.loader.streaming import OnTheFlyImageLoader as RefOTF
from znicz_tpu.models import alexnet as ref_alexnet
from znicz_tpu.workflow import Workflow as RefWorkflow
from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.loader import RandomCropFlip
from znicz_tpu_torch.loader.image import FullBatchImageLoader, decode_image
from znicz_tpu_torch.loader.streaming import OnTheFlyImageLoader
from znicz_tpu_torch.models import alexnet
from znicz_tpu_torch.parallel.stream import StreamTrainer
from znicz_tpu_torch.workflow import Workflow

Image = pytest.importorskip("PIL.Image")


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def write_tree(root_dir, splits, classes, hw, seed, mode="RGB"):
    """``root_dir/<split>/<class>/<i>.png`` of seeded random pixels;
    ``splits``: split → images a class."""
    gen = np.random.default_rng(seed)
    for split, n in splits.items():
        for cname in classes:
            d = root_dir / split / cname
            d.mkdir(parents=True)
            for i in range(n):
                shape = hw + ((3,) if mode == "RGB" else ())
                arr = gen.integers(0, 256, shape).astype(np.uint8)
                Image.fromarray(arr, mode).save(d / f"{i:03d}.png")
    return root_dir


@pytest.fixture
def image_tree(tmp_path):
    return write_tree(tmp_path, {"train": 4, "valid": 2},
                      ("cats", "dogs"), (8, 8), seed=1)


@pytest.mark.parametrize("kw", [{}, {"grayscale": True},
                                {"size": (6, 5)},
                                {"crop": (1, 2, 0, 1)}])
def test_decode_equals_the_references(image_tree, kw):
    p = str(image_tree / "train" / "dogs" / "001.png")
    kw = dict(kw)
    a = decode_image(p, kw.get("size"), kw.get("grayscale", False),
                     kw.get("crop"))
    b = ref_decode(p, kw.get("size"), kw.get("grayscale", False),
                   kw.get("crop"))
    assert a.dtype == np.float32 and a.tobytes() == b.tobytes()


def test_otf_loader_matches_fullbatch_loaders(image_tree):
    splits = {"train_paths": [str(image_tree / "train")],
              "validation_paths": [str(image_tree / "valid")]}
    otf = OnTheFlyImageLoader(Workflow(name="w"), minibatch_size=4,
                              **splits)
    otf.initialize("cpu")
    full = FullBatchImageLoader(Workflow(name="w2"), minibatch_size=4,
                                **splits)
    full.initialize("cpu")
    ref = RefFullBatch(RefWorkflow(name="w3"), minibatch_size=4, **splits)
    ref.initialize(NumpyDevice())
    ref_otf = RefOTF(RefWorkflow(name="w4"), minibatch_size=4, **splits)
    ref_otf.initialize(NumpyDevice())
    assert otf.class_lengths == full.class_lengths == ref.class_lengths
    assert otf.label_map == full.label_map == {"cats": 0, "dogs": 1}
    np.testing.assert_array_equal(full.original_data.numpy(),
                                  np.asarray(ref.original_data.mem))
    idx = np.asarray([0, 3, 7, 11])
    d, lab = otf.read_batch(idx)
    np.testing.assert_allclose(d, full.original_data.numpy()[idx],
                               rtol=1e-6)
    np.testing.assert_array_equal(lab, full.original_labels.numpy()[idx])
    rd, rl = ref_otf.read_batch(idx)
    assert d.tobytes() == rd.tobytes()
    np.testing.assert_array_equal(lab, rl)
    assert otf.n_classes == 2


def test_otf_fetch_with_augmentation_equals_the_references(tmp_path):
    from znicz_tpu.loader import RandomCropFlip as RefRandomCropFlip
    tree = write_tree(tmp_path, {"train": 5, "valid": 2}, ("a", "b", "c"),
                      (12, 11), seed=2, mode="L")
    splits = {"train_paths": [str(tree / "train")],
              "validation_paths": [str(tree / "valid")]}
    otf = OnTheFlyImageLoader(Workflow(name="w"), minibatch_size=5,
                              grayscale=True,
                              augment=RandomCropFlip((8, 8), seed=3),
                              **splits)
    otf.initialize("cpu")
    ref = RefOTF(RefWorkflow(name="w2"), minibatch_size=5, grayscale=True,
                 augment=RefRandomCropFlip((8, 8), seed=3), **splits)
    ref.initialize(NumpyDevice())
    assert otf.sample_shape == (8, 8, 1) and otf.raw_sample_shape == (
        12, 11, 1)
    rows = [0, 5, 6, 13, 20]
    for epoch in (None, 0, 5):
        a, la = otf.fetch(rows, epoch)
        b, lb = ref.fetch(rows, epoch)
        assert a.tobytes() == b.tobytes()
        np.testing.assert_array_equal(la, lb)


@pytest.fixture
def small_alexnet():
    """The shrunk AlexNet over a data_dir in both config trees (67² crops
    of 76² decodes, 3 classes, batch 8); restored after."""
    keys = ("minibatch_size", "size", "n_classes", "layers", "decode_size",
            "data_dir")
    saved = [{k: t.alexnet.get(k) for k in keys} for t in (ref_root, root)]
    for t, mod in ((ref_root, ref_alexnet), (root, alexnet)):
        t.alexnet.update({"minibatch_size": 8, "size": 67, "n_classes": 3,
                          "decode_size": 76})
        t.alexnet.layers = mod.make_layers(3, widths=(8, 12, 8, 8, 8, 24,
                                                      16))
    yield
    for t, top in zip((ref_root, root), saved):
        t.alexnet.update(top)


def test_alexnet_data_dir_epoch0_equals_the_references(
        tmp_path, small_alexnet, monkeypatch):
    # the reference's default LRN→pool routing splits its convs by column
    # parity, another summation order; pin the routing the port runs
    monkeypatch.setenv("ZNICZ_TPU_LRN_POOL", "fused1")
    tree = write_tree(tmp_path, {"train": 6, "valid": 3, "test": 2},
                      ("n01", "n02", "n03"), (90, 84), seed=4)
    ref_prng.seed_all(1234)
    want = ref_alexnet.run(device=Device.create("xla"), epochs=1,
                           fused=True, data_dir=str(tree))
    prng.seed_all(1234)
    got = alexnet.run(device="cpu", epochs=1, fused=True,
                      data_dir=str(tree))
    ld = got.loader
    assert isinstance(ld, OnTheFlyImageLoader)
    assert ld.class_lengths == [6, 9, 18]
    assert ld.raw_sample_shape == (76, 76, 3)
    assert ld.sample_shape == (67, 67, 3)
    g, w = got.decision.epoch_metrics[0], want.decision.epoch_metrics[0]
    assert sorted(g) == sorted(w)
    for k in w:
        if k.endswith("_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5, err_msg=k)
        elif k.endswith("_n_err") or k == "epoch":
            assert g[k] == w[k], (k, g, w)


def test_alexnet_data_dir_trains_through_the_stream_trainer(
        tmp_path, small_alexnet):
    tree = write_tree(tmp_path, {"train": 4}, ("a", "b", "c"), (80, 80),
                      seed=5)
    prng.seed_all(1)
    wf = alexnet.AlexNetWorkflow(data_dir=str(tree))
    wf.initialize(device="cpu")
    trainer = wf.run_fused(max_epochs=1)
    assert type(trainer) is StreamTrainer and trainer.device_augment
    assert trainer.augment is wf.loader.augment
    assert np.isfinite(wf.decision.epoch_metrics[0]["train_loss"])
    with pytest.raises(ValueError, match="no train/"):
        alexnet.make_imagenet_loader(str(tmp_path / "train"))
