"""The port's normalizers and its wine, video_ae, kanji and yale_faces
samples against the JAX package's.

The ``mean_disp``, ``external_mean`` and ``pointwise`` normalizers give
the reference's float32 bits on the same data (``none`` and ``linear``
too).  Each sample trains one epoch on the unit graph and one on the fused
path from the same seed in both packages: the data (and for kanji and
yale_faces the rendered PNG trees) are the reference's bit for bit, and
epoch 0's losses agree within rtol 1e-5 (1e-4 where a conv stack sums in
another order) with error counts exact.  kanji and yale_faces train from
disk through ``OnTheFlyImageLoader`` (the fused path through the
``StreamTrainer``; yale_faces with its crops on the device), at their
sample sizes with fewer images a class."""

import os

import numpy as np
import pytest
import torch

from znicz_tpu import normalization as ref_norm
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu_torch import normalization, prng
from znicz_tpu_torch.config import root


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("name", ["none", "linear", "mean_disp",
                                  "external_mean", "pointwise"])
@pytest.mark.parametrize("shape", [(50, 13), (20, 6, 5, 3)])
def test_normalizers_equal_the_references(name, shape):
    gen = np.random.default_rng(len(shape))
    data = (gen.standard_normal(shape) * 10.0 ** gen.uniform(
        -1, 3, (1,) + shape[1:])).astype(np.float32)
    kw = ({"mean_source": data.mean(axis=0)} if name == "external_mean"
          else {})
    ref = ref_norm.create_normalizer(name, **kw).fit(data)
    mine = normalization.create_normalizer(name, **kw).fit(
        torch.from_numpy(data))
    for x in (data, data[:7] * 1.5):
        want = ref.apply(x)
        got = mine.apply(torch.from_numpy(x)).numpy()
        assert got.dtype == np.float32 and got.tobytes() == want.tobytes()


def test_external_mean_from_a_file_and_unknown_names(tmp_path):
    mean = np.arange(6, dtype=np.float32).reshape(2, 3)
    p = str(tmp_path / "mean.npy")
    np.save(p, mean)
    x = torch.ones((4, 2, 3))
    np.testing.assert_array_equal(
        normalization.create_normalizer("external_mean", mean_source=p)
        .apply(x).numpy(), 1.0 - mean[None].repeat(4, 0))
    with pytest.raises(ValueError, match="mean_source"):
        normalization.create_normalizer("external_mean")
    with pytest.raises(ValueError, match="unknown normalizer"):
        normalization.create_normalizer("zscore")


#: sample → (config overrides for both trees, loss rtol)
SAMPLES = {
    "wine": ({}, 1e-5),
    "video_ae": ({"synthetic": {"n_train_seq": 6, "n_valid_seq": 2,
                                "n_test_seq": 0, "frames_per_seq": 10}},
                 1e-4),
    "kanji": ({"per_class": {"train": 10, "valid": 4}}, 1e-4),
    "yale_faces": ({"per_subject": {"train": 8, "valid": 4}}, 1e-4),
}


@pytest.fixture
def sample_trees(tmp_path):
    """Both config trees shrunk per SAMPLES and rendering into tmp_path;
    restored after.  The samples are imported first: their defaults land
    in the trees at import."""
    import importlib
    for name in SAMPLES:
        for pkg in ("znicz_tpu", "znicz_tpu_torch"):
            importlib.import_module(f"{pkg}.models.{name}")
    saved = [(t.common.get("cache_dir"),
              {k: t.get(k).to_dict() if hasattr(t.get(k), "to_dict")
               else t.get(k) for k in SAMPLES}) for t in (ref_root, root)]
    for t, sub in ((ref_root, "ref"), (root, "port")):
        t.common.cache_dir = str(tmp_path / sub)
        for name, (over, _) in SAMPLES.items():
            for k, v in over.items():
                getattr(getattr(t, name), k).update(v)
    yield tmp_path
    for t, (cache, trees) in zip((ref_root, root), saved):
        t.common.cache_dir = cache
        for name, tree in trees.items():
            if tree is not None:
                getattr(t, name).update(tree)


def _tree_bytes(d):
    out = {}
    for base, _, files in os.walk(d):
        for f in files:
            p = os.path.join(base, f)
            out[os.path.relpath(p, d)] = open(p, "rb").read()
    return out


@pytest.mark.parametrize("fused", [False, True])
@pytest.mark.parametrize("sample", sorted(SAMPLES))
def test_sample_epoch0_equals_the_references(sample_trees, sample, fused):
    import importlib
    ref_mod = importlib.import_module(f"znicz_tpu.models.{sample}")
    mod = importlib.import_module(f"znicz_tpu_torch.models.{sample}")
    ref_prng.seed_all(1234)
    want = ref_mod.run(device=Device.create("xla"), epochs=1, fused=fused)
    prng.seed_all(1234)
    got = mod.run(device="cpu", epochs=1, fused=fused)
    if sample in ("kanji", "yale_faces"):
        a, b = (_tree_bytes(sample_trees / p) for p in ("port", "ref"))
        assert a and a == b
        assert got.loader.class_lengths == want.loader.class_lengths
    else:
        np.testing.assert_array_equal(
            got.loader.original_data.numpy(),
            np.asarray(want.loader.original_data.mem))
    g, w = got.decision.epoch_metrics[0], want.decision.epoch_metrics[0]
    assert sorted(g) == sorted(w)
    rtol = SAMPLES[sample][1]
    for k in w:
        if k.endswith(("_loss", "_mse")):
            np.testing.assert_allclose(g[k], w[k], rtol=rtol, err_msg=k)
        elif k.endswith("_n_err") or k == "epoch":
            assert g[k] == w[k], (k, g, w)
    if fused and sample in ("kanji", "yale_faces"):
        from znicz_tpu_torch.loader.streaming import OnTheFlyImageLoader
        assert isinstance(got.loader, OnTheFlyImageLoader)
