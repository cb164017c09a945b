"""The port's crop-and-mirror augmentation (znicz_tpu_torch.loader.augment)
against the JAX package's.

``RandomCropFlip.apply`` (numpy, the loaders' host path) and
``device_apply`` (torch ops on the tensor's device) cut bit for bit the
reference's pixels, both its host ``apply`` and its jnp ``device_apply``,
over several seeds, epochs (epoch words past 2³¹ too) and rows; the eval
crop is the center; a loader's fetch equals the reference loader's.  The
resident ``FusedTrainer(augment=...)`` trains bit for bit as the
``StreamTrainer`` with device and with host augmentation on the same
shards (eager steps and plan-fed steps), and within the tolerance of
tests/test_torch_fused.py (loss rtol 1e-5, n_err exact, params atol
1e-5) of the reference's ``FusedTrainer(augment=...)``."""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from znicz_tpu.backends import NumpyDevice
from znicz_tpu.loader import RandomCropFlip as RefRandomCropFlip
from znicz_tpu.loader import RecordLoader as RefRecordLoader
from znicz_tpu.parallel import FusedTrainer as RefFusedTrainer
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu.workflow import Workflow as RefWorkflow
from znicz_tpu_torch import convert
from znicz_tpu_torch.loader import (RandomCropFlip, RecordLoader,
                                    write_records)
from znicz_tpu_torch.parallel import capture
from znicz_tpu_torch.parallel.fused import FusedTrainer
from znicz_tpu_torch.parallel.stream import StreamTrainer
from znicz_tpu_torch.workflow import Workflow


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


class _Direct:
    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def direct(monkeypatch):
    def fake(plan, fn):
        fn()
        return _Direct(fn)
    monkeypatch.setattr(capture.StepPlan, "capture", fake)


ROWS = np.asarray([3, 0, 11, 7, 15, 3, 8, 2, 9, 1, 4, 5, 6, 10, 12, 13,
                   1_000_003, 2_147_483_647])


@pytest.mark.parametrize("mirror", [True, False])
@pytest.mark.parametrize("epoch", [0, 4, 77, 2**31 + 5])
@pytest.mark.parametrize("seed", [21, 1234, 2**32 + 9])
def test_crops_bit_equal_the_references(seed, epoch, mirror):
    gen = np.random.default_rng(seed % 1000)
    data = gen.standard_normal((len(ROWS), 12, 10, 3)).astype(np.float32)
    ref = RefRandomCropFlip((8, 7), mirror=mirror, seed=seed)
    pol = RandomCropFlip((8, 7), mirror=mirror, seed=seed)
    train = np.ones(len(ROWS), bool)
    want = ref.apply(data, ROWS, epoch, train)
    want_dev = np.asarray(ref.device_apply(
        jnp.asarray(data), jnp.asarray(ROWS), jnp.uint32(epoch)))
    np.testing.assert_array_equal(want, want_dev)
    assert pol.apply(data, ROWS, epoch, train).tobytes() == want.tobytes()
    x = torch.from_numpy(data)
    got = pol.device_apply(x, torch.from_numpy(ROWS), epoch)
    assert got.numpy().tobytes() == want.tobytes()
    # the epoch as a captured step's int32 plan word
    word = torch.tensor([np.uint32(epoch).view(np.int32)], dtype=torch.int32)
    got = pol.device_apply(x, torch.from_numpy(ROWS).to(torch.int32), word)
    assert got.numpy().tobytes() == want.tobytes()
    # eval: the center crop, whatever the rows and epoch
    center = data[:, 2:10, 1:8]
    np.testing.assert_array_equal(
        pol.device_apply(x, ROWS, epoch, train=False).numpy(), center)
    np.testing.assert_array_equal(pol.apply(data, ROWS, None, train),
                                  center)


def test_mixed_batch_and_whole_frame_mirror():
    """Eval rows inside a train batch get the center crop; a crop the size
    of the frame still mirrors."""
    gen = np.random.default_rng(3)
    data = gen.standard_normal((16, 12, 10, 3)).astype(np.float32)
    rows = np.arange(16)
    is_train = rows >= 5
    for out_hw in ((8, 8), (12, 10)):
        ref = RefRandomCropFlip(out_hw, seed=11)
        pol = RandomCropFlip(out_hw, seed=11)
        np.testing.assert_array_equal(pol.apply(data, rows, 2, is_train),
                                      ref.apply(data, rows, 2, is_train))
    got = RandomCropFlip((12, 10), seed=11).apply(data, rows, 0,
                                                  np.ones(16, bool))
    flipped = sum(np.array_equal(got[j], data[j][:, ::-1])
                  for j in range(16))
    assert 0 < flipped < 16
    with pytest.raises(ValueError, match="exceeds"):
        RandomCropFlip((20, 20)).out_shape((12, 10, 3))


def test_loader_fetch_equals_the_reference_loaders(tmp_path):
    gen = np.random.default_rng(5)
    data = gen.standard_normal((24, 12, 10, 3)).astype(np.float32)
    labels = np.arange(24, dtype=np.int32) % 3
    tr = write_records(str(tmp_path / "t.znr"), data[4:], labels[4:])
    va = write_records(str(tmp_path / "v.znr"), data[:4], labels[:4])
    ref = RefRecordLoader(RefWorkflow(name="w"), train_paths=tr,
                          validation_paths=va, minibatch_size=4,
                          augment=RefRandomCropFlip((8, 8), seed=7))
    ref.initialize(NumpyDevice())
    ld = RecordLoader(Workflow(name="w"), train_paths=tr,
                      validation_paths=va, minibatch_size=4,
                      augment=RandomCropFlip((8, 8), seed=7))
    ld.initialize("cpu")
    assert ld.sample_shape == ref.sample_shape == (8, 8, 3)
    assert ld.raw_sample_shape == (12, 10, 3)
    for rows, epoch in (([0, 1, 2, 3], 0), ([4, 9, 14, 19], 3),
                        ([2, 5, 23], 9)):
        np.testing.assert_array_equal(ld.fetch(rows, epoch)[0],
                                      ref.fetch(rows, epoch)[0])
    # the unit graph's minibatch at the loader's epoch
    ld.epoch_number = 3
    ld.fill_minibatch(np.asarray([4, 9, 14, 19]), 2)
    np.testing.assert_array_equal(ld.minibatch_data.mem,
                                  ref.fetch([4, 9, 14, 19], 3)[0])


def _conv_model(seed):
    gen = np.random.default_rng(seed)
    n, big, crop, classes = 48, 12, 8, 5
    data = gen.standard_normal((n, big, big, 2)).astype(np.float32)
    labels = gen.integers(0, classes, n).astype(np.int32)
    hyp = (0.05, 0.0, 0.0, 0.9)
    layers = (ref_fused.LayerSpec("conv", "tanh", True, hyp, hyp,
                                  (("padding", (1, 1)), ("stride", (1, 1)))),
              ref_fused.LayerSpec("fc", "linear", True, hyp, hyp))
    params = [((gen.standard_normal((3, 3, 2, 4)) * 0.2).astype(np.float32),
               np.zeros(4, np.float32)),
              ((gen.standard_normal((crop * crop * 4, classes)) * 0.1)
               .astype(np.float32), np.zeros(classes, np.float32))]
    vels = [(np.zeros_like(w), np.zeros_like(b)) for w, b in params]
    return layers, params, vels, data, labels, crop


def _eq(a, b):
    return all(torch.equal(x, y) for pa, pb in zip(a, b)
               for x, y in zip(pa, pb) if x is not None)


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("path", ["stream_device", "stream_host"])
def test_resident_augment_equals_streaming(tmp_path, direct, path,
                                           planned):
    layers, params, vels, data, labels, crop = _conv_model(6)
    pol = RandomCropFlip((crop, crop), mirror=True, seed=77)
    spec, pp, pv = convert.from_reference(
        [dataclasses.asdict(la) for la in layers], "softmax", params, vels,
        device="cpu")
    res = FusedTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       augment=pol)
    ld = RecordLoader(Workflow(name="w"), minibatch_size=12, augment=pol,
                      train_paths=write_records(str(tmp_path / "a.znr"),
                                                data, labels, 20))
    ld.initialize("cpu")
    st = StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       loader=ld, device_augment=path == "stream_device")
    if planned:
        res.uncaptured_reason = st.uncaptured_reason = None
    idx = np.random.default_rng(2).permutation(48)
    d, t = torch.from_numpy(data), torch.from_numpy(labels)
    for ep in range(2):
        rm = res.train_epoch(d, t, idx, 12, epoch=ep)
        sm = st.train_epoch(None, None, idx, 12, epoch=ep)
        for k in rm:
            np.testing.assert_array_equal(rm[k], sm[k])
    re_ = res.eval_epoch(d, t, idx, 12)
    se = st.eval_epoch(None, None, idx, 12)
    np.testing.assert_array_equal(re_["loss"], se["loss"])
    assert _eq(res.params, st.params) and _eq(res.vels, st.vels)


def test_resident_augment_equals_the_references():
    layers, params, vels, data, labels, crop = _conv_model(8)
    cp = lambda t: [tuple(np.array(a) for a in p) for p in t]  # noqa: E731
    ref = RefFusedTrainer(spec=ref_fused.ModelSpec(layers, "softmax"),
                          params=cp(params), vels=cp(vels),
                          augment=RefRandomCropFlip((crop, crop), seed=77))
    spec, pp, pv = convert.from_reference(
        [dataclasses.asdict(la) for la in layers], "softmax", params, vels,
        device="cpu")
    res = FusedTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       augment=RandomCropFlip((crop, crop), seed=77))
    idx = np.arange(48)
    for ep in range(2):
        want = ref.train_epoch(jnp.asarray(data), jnp.asarray(labels), idx,
                               12, epoch=ep)
        got = res.train_epoch(torch.from_numpy(data),
                              torch.from_numpy(labels), idx, 12, epoch=ep)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["n_err"], want["n_err"])
    want = ref.eval_epoch(jnp.asarray(data), jnp.asarray(labels), idx, 12)
    got = res.eval_epoch(torch.from_numpy(data), torch.from_numpy(labels),
                         idx, 12)
    np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
    for (gw, gb), (ww, wb) in zip(res.params, ref.params):
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0,
                                   atol=1e-5)
