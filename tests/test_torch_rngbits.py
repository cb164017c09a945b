"""The port's counter RNG and dropout (znicz_tpu_torch.ops.rngbits,
ops.dropout) against the JAX package's, on the CPU.

- ``fold`` and ``uniform01`` give the reference's bits for 64-bit stream
  seeds, crc32 unit ids ≥ 2³¹ and counters that wrap u32;
- ``plain_make_mask`` equals ``znicz_tpu.ops.dropout.make_mask`` bit for
  bit, and ``dropout`` on a CPU tensor is ``plain_dropout``;
- the keys of a fused epoch — the head steps, then the previous epoch's
  deferred last step with its own epoch and counter base — are the ones
  the reference's ``FusedTrainer`` feeds its masks.

A card-only case holds the kernel against its plain version and skips on
a host without a card."""

import zlib

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.ops import dropout as ref_dropout
from znicz_tpu.ops import rngbits as ref_rngbits
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu_torch import prng
from znicz_tpu_torch.ops import dropout, rngbits
from znicz_tpu_torch.parallel import fused

SEEDS = [0, 1234, 2 ** 32 + 7, 2 ** 63 + 12345,
         ref_prng.get("dropout").stream_seed]
COUNTERS = [(0, 0, 0), (zlib.crc32(b"fwd10_dropout"), 3, 512),
            (zlib.crc32(b"fwd12_dropout"), 1, 2 ** 32 - 1),
            (2 ** 31 + 5, 2 ** 32 - 2, 2 ** 31)]


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.mark.parametrize("seed", SEEDS)
@pytest.mark.parametrize("counters", COUNTERS)
def test_fold_equals_reference(seed, counters):
    want = int(ref_rngbits.fold(seed, *counters))
    assert rngbits.fold(seed, *counters) == want


def test_fold_wraps_counters_as_uint32():
    """A counter past 2³² folds as its uint32 value, as the reference's
    ``ctrs.astype(np.uint32)`` hands it over."""
    ctr = 2 ** 32 + 640
    wrapped = int(np.asarray(ctr).astype(np.uint32))
    assert rngbits.fold(5, 7, 1, ctr) == int(ref_rngbits.fold(5, 7, 1,
                                                              wrapped))


@pytest.mark.parametrize("key", [0, 1, 0x9E3779B9, 2 ** 32 - 1,
                                 int(ref_rngbits.fold(99, 2 ** 31, 4, 7))])
def test_uniform01_equals_reference(key):
    n = 4099
    want = ref_rngbits.uniform01(np.uint32(key), n)
    got = rngbits.uniform01(key, n).numpy()
    assert got.dtype == np.float32
    np.testing.assert_array_equal(got, want)


@pytest.mark.parametrize("ratio", [0.5, 0.1, 0.3, 0.0])
@pytest.mark.parametrize("shape", [(4, 6, 6, 8), (16, 64), (5, 3)])
def test_make_mask_equals_reference(ratio, shape):
    seed, counters = SEEDS[3], COUNTERS[2]
    want = ref_dropout.make_mask(seed, counters, shape, ratio, np)
    got = dropout.plain_make_mask(seed, counters, shape, ratio).numpy()
    assert got.dtype == np.float32 and got.shape == shape
    np.testing.assert_array_equal(got, want)


def test_cpu_dropout_is_the_plain_version_forward_and_backward():
    rng = np.random.default_rng(3)
    x = torch.from_numpy(rng.standard_normal((8, 6, 6, 16)).astype(
        np.float32))
    key = rngbits.fold(SEEDS[1], *COUNTERS[1])
    before = dropout.dropout_launches
    got = dropout.dropout(x, key, 0.5)
    assert dropout.dropout_launches == before
    mask = ref_dropout.make_mask(SEEDS[1], COUNTERS[1], tuple(x.shape), 0.5,
                                 np)
    np.testing.assert_array_equal(got.numpy(), x.numpy() * mask)
    # the backward is the same call on err: the same mask
    err = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    np.testing.assert_array_equal(dropout.dropout(err, key, 0.5).numpy(),
                                  err.numpy() * mask)


@pytest.mark.parametrize("bad", ["float64", "non_contiguous", "ratio_one",
                                 "ratio_negative"])
def test_dropout_refuses_inputs_the_kernel_does_not_take(bad):
    x = torch.zeros((4, 8))
    with pytest.raises((TypeError, ValueError)):
        if bad == "float64":
            dropout.dropout(x.double(), 1, 0.5)
        elif bad == "non_contiguous":
            dropout.dropout(x.t(), 1, 0.5)
        elif bad == "ratio_one":
            dropout.dropout(x, 1, 1.0)
        else:
            dropout.dropout(x, 1, -0.1)


@pytest.mark.parametrize("n,batch,ctr_base", [(512, 128, 0), (500, 128, 0),
                                              (70, 32, 384), (1, 128, 511)])
def test_step_counters_equal_reference(n, batch, ctr_base):
    idx = np.arange(n)
    want = ref_fused.FusedTrainer._idx_matrix(None, idx, batch, ctr_base)
    got = fused.FusedTrainer._idx_matrix(idx, batch, ctr_base)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g, w)
        assert g.dtype == w.dtype


class _Recorder:
    """Stands in for ``train_minibatch`` and records the dropout keys the
    trainer hands each step."""

    def __init__(self, cfg):
        self.cfg, self.keys = cfg, []

    def __call__(self, spec, params, vels, x, t, mask, epoch, ctr,
                 lr_scale=None, lr_scale_bias=None):
        self.keys.append(fused.dropout_key(self.cfg, epoch, ctr))
        zero = torch.zeros(())
        return params, vels, {"loss": zero, "n_err": zero.int()}


def test_fused_epoch_key_schedule_equals_reference(monkeypatch):
    """run_fused's calls: epoch 0's head, then epoch 1 starting with
    epoch 0's deferred last minibatch (epoch 0, counter base = split)."""
    prng.seed_all(1234)
    cfg = {"ratio": 0.5, "seed": prng.get("dropout").stream_seed,
           "unit_id": zlib.crc32(b"fwd10_dropout")}
    n_train, batch = 300, 128
    split = ((n_train - 1) // batch) * batch
    perm = np.arange(n_train)
    calls = [(perm[:split], 0, 0), (perm[split:], 0, split),
             (perm[:split], 1, 0)]
    rec = _Recorder(cfg)
    monkeypatch.setattr(fused, "train_minibatch", rec)
    spec = fused.ModelSpec((), "mse")
    tr = fused.FusedTrainer(spec=spec, params=[], vels=[], device="cpu")
    data = torch.zeros((n_train, 1))
    for indices, epoch, base in calls:
        tr.train_epoch(data, data, indices, batch, epoch=epoch,
                       ctr_base=base)
    want = []
    ref_prng.seed_all(1234)
    assert ref_prng.get("dropout").stream_seed == cfg["seed"]
    for indices, epoch, base in calls:
        _, _, ctrs = ref_fused.FusedTrainer._idx_matrix(None, indices, batch,
                                                        base)
        want += [int(ref_rngbits.fold(cfg["seed"], cfg["unit_id"], epoch,
                                      c)) for c in ctrs]
    assert rec.keys == want
    # an epoch left to the trainer continues from the last one given
    rec.keys.clear()
    tr.train_epoch(data, data, perm[:batch], batch)
    assert rec.keys == [int(ref_rngbits.fold(cfg["seed"], cfg["unit_id"],
                                             2, batch))]


@pytest.mark.skipif("not torch.cuda.is_available()",
                    reason="the CUDA kernel runs only on a card")
@pytest.mark.parametrize("shape,ratio", [((128, 6, 6, 256), 0.5),
                                         ((128, 4096), 0.5),
                                         ((7, 13, 5), 0.3)])
def test_cuda_kernel_matches_plain_version(shape, ratio):
    x = torch.randn(shape, generator=torch.Generator().manual_seed(1)).cuda()
    key = rngbits.fold(SEEDS[3], 2 ** 31 + 5, 1, 2 ** 32 - 1)
    before = dropout.dropout_launches
    got = dropout.dropout(x, key, ratio)
    torch.cuda.synchronize()
    assert dropout.dropout_launches == before + 1
    assert torch.equal(got, dropout.plain_dropout(x, key, ratio))
