"""The fused trainers' steps replayed from CUDA graphs, on a card, against
the same steps run one by one (``capture=False``) from the same start:

* train and eval epochs bit for bit — metrics, parameters and velocities
  — for MNIST (also with ``accum_steps`` 2 and a per-step learning-rate
  schedule), CIFAR and the autoencoder on both conv tiers, and the SOM,
  with cuDNN held to its deterministic algorithms (a choice the capture
  does not make);
* each kernel's launches over an epoch the same both ways, and one
  capture a step variant;
* the update kernel with a learning-rate scale and in place, bit for bit
  its plain version;
* a step that cannot be captured raises, and the trainer does not go on
  uncaptured (last: a failed capture is the file's last CUDA work).

Every test needs a CUDA card and skips without one; this file imports no
JAX (tests/test_torch_accum.py holds the same step functions to the
reference on the CPU)."""

import contextlib
import importlib
import os

import numpy as np
import pytest
import torch

from znicz_tpu_torch import ops, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.ops import update
from znicz_tpu_torch.parallel import capture, fused, som
from znicz_tpu_torch.profile_fused import MODELS

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA graphs run only on a card")

#: model → its split for these epochs (full widths)
SPLITS = {"mnist": {"n_train": 600, "n_valid": 200, "n_test": 100},
          "cifar": {"n_train": 400, "n_valid": 200, "n_test": 100},
          "autoencoder": {"n_train": 400, "n_valid": 200, "n_test": 100}}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


@contextlib.contextmanager
def _tier(gemm: bool):
    saved = os.environ.get("ZNICZ_TPU_CONV")
    if gemm:
        os.environ["ZNICZ_TPU_CONV"] = "pallas"
    else:
        os.environ.pop("ZNICZ_TPU_CONV", None)
    try:
        yield
    finally:
        if saved is None:
            os.environ.pop("ZNICZ_TPU_CONV", None)
        else:
            os.environ["ZNICZ_TPU_CONV"] = saved


def _workflow(model):
    cls_name, tree_name = MODELS[model][:2]
    tree = getattr(root, tree_name)
    saved = tree.synthetic.to_dict()
    tree.synthetic.update(SPLITS[model])
    prng.seed_all(1234)
    try:
        module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
        wf = getattr(module, cls_name)()
        wf.initialize(device="cuda")
    finally:
        tree.synthetic.update(saved)
    return wf


def _perms(wf):
    """The train set's shuffles of epochs 0 and 1 (each drawn once: the
    loader's stream moves on)."""
    return [wf.loader.train_permutation(e).copy() for e in (0, 1)]


def _epochs(wf, perms, capture_, accum_steps=1):
    """Two train epochs over ``perms`` (the second at a per-step scale) and
    an eval epoch of the workflow's model on a trainer of its own;
    (metrics, trainer, launches over the second train epoch)."""
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cuda",
                            accum_steps=accum_steps, capture=capture_)
    ld = wf.loader
    batch = ld.max_minibatch_size
    target = (ld.original_targets if wf.loss_function == "mse"
              else ld.original_labels)
    data = ld.original_data
    out = [tr.train_epoch(data, target, perms[0], batch, epoch=0)]
    perm = perms[1]
    steps = -(-len(perm) // batch)
    before = ops.launch_counts()
    out.append(tr.train_epoch(data, target, perm, batch, epoch=1,
                              lr_scale=np.linspace(1.0, 0.5, steps),
                              lr_scale_bias=0.8))
    torch.cuda.synchronize()
    after = ops.launch_counts()
    out.append(tr.eval_epoch(data, target, np.arange(ld.class_lengths[1]),
                             batch))
    return out, tr, {k: after[k] - before[k] for k in after}


def _bits_equal(a, b):
    for x, y in zip(a, b):
        for p, q in zip(x, y):
            assert (p is None) == (q is None)
            if p is not None:
                assert torch.equal(p.view(torch.int32), q.view(torch.int32))


@pytest.mark.parametrize("model,gemm,accum", [
    ("mnist", False, 1), ("mnist", False, 2), ("cifar", False, 1),
    ("cifar", True, 1), ("autoencoder", False, 1),
    ("autoencoder", True, 1)])
def test_captured_epochs_equal_uncaptured_bit_for_bit(deterministic, model,
                                                      gemm, accum):
    with _tier(gemm):
        wf = _workflow(model)
        perms = _perms(wf)
        (m_c, tr_c, n_c), (m_u, tr_u, n_u) = (
            _epochs(wf, perms, cap, accum) for cap in (None, False))
    assert tr_c.captured and not tr_u.captured
    for a, b in zip(m_c, m_u):
        for k in a:
            np.testing.assert_array_equal(a[k], b[k])
    _bits_equal(tr_c.params, tr_u.params)
    _bits_equal(tr_c.vels, tr_u.vels)
    assert n_c == n_u                             # the same launches
    assert any(n_c.values())
    plans = list(tr_c._plans.values())
    # one graph a variant: train (and accumulate), eval
    assert sorted(v for p in plans for v in p.graphs) == sorted(
        ["eval", "train"] + (["accumulate"] if accum > 1 else []))


def test_captured_som_epochs_equal_uncaptured_bit_for_bit():
    rng = np.random.default_rng(3)
    w = rng.uniform(-1, 1, (64, 2)).astype(np.float32)
    data = torch.from_numpy(rng.normal(0, 0.5, (2000, 2)).astype(
        np.float32)).cuda()
    runs = []
    for cap in (None, False):
        tr = som.FusedSOMTrainer(w, (8, 8), device="cuda", capture=cap)
        before = ops.launch_counts()
        diffs = [tr.train_epoch(data, np.arange(2000)[::-1].copy(), 100,
                                lr, sigma)
                 for lr, sigma in ((0.5, 4.0), (0.45, 3.6), (0.4, 3.2))]
        after = ops.launch_counts()
        runs.append((tr.captured, diffs, tr.weights.clone(),
                     after[("kohonen", "distance_argmin_launches")]
                     - before[("kohonen", "distance_argmin_launches")]))
    assert runs[0][0] and not runs[1][0]
    assert runs[0][1] == runs[1][1]
    assert torch.equal(runs[0][2], runs[1][2])
    assert runs[0][3] == runs[1][3] == 3 * 20


@pytest.mark.parametrize("inplace", [False, True])
def test_cuda_update_with_a_scale_matches_plain_bit_for_bit(inplace):
    """MNIST's table (W2, b2, W1, b1) with a weight scale and a bias
    scale, as the fused step calls it, and s = 1 and an unaligned entry."""
    gen = torch.Generator().manual_seed(11)
    shapes = [(100, 10), (10,), (784, 100), (100,), (333,)]
    s_w = torch.full((1,), 0.37, device="cuda")
    s_b = torch.full((1,), 1.9, device="cuda")
    one = torch.ones(1, device="cuda")
    entries = []
    for k, shape in enumerate(shapes):
        w, g, v = (torch.randn(shape, generator=gen) * s
                   for s in (1.0, 0.1, 0.01))
        w[torch.rand(shape, generator=gen) < 0.25] = 0.0
        w, g, v = (t.cuda() for t in (w, g, v))
        if k == 4:                               # one float off alignment
            w, g, v = (torch.cat([t.new_zeros(1), t])[1:] for t in (w, g, v))
        consts = update.fused_constants((0.03, 5e-4, 0.3, 0.9))
        entries.append((w, g, v, consts,
                        (s_w, s_b, s_w, s_b, one)[k]))
    want = update.plain_sgd_update_many(
        [tuple(t.clone() if torch.is_tensor(t) else t for t in e[:3])
         + e[3:] for e in entries])
    before = update.sgd_update_launches
    got = update.sgd_update_many(entries, inplace=inplace)
    torch.cuda.synchronize()
    assert update.sgd_update_launches == before + 1
    for (a, b), (c, d), e in zip(got, want, entries):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
        assert torch.equal(b.view(torch.int32), d.view(torch.int32))
        assert (a.data_ptr() == e[0].data_ptr()) == inplace


def test_replays_count_the_launches_of_their_capture():
    """A captured MNIST train epoch of 6 steps: one launch of each of its
    kernels a step, the first step eager and five replays."""
    wf = _workflow("mnist")
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cuda")
    ld = wf.loader
    before = ops.launch_counts()
    tr.train_epoch(ld.original_data, ld.original_labels, _perms(wf)[0],
                   ld.max_minibatch_size)
    after = ops.launch_counts()
    moved = {k: v - before[k] for k, v in after.items() if v != before[k]}
    assert moved == {("softmax", "softmax_ce_launches"): 6,
                     ("update", "sgd_update_launches"): 6,
                     ("activations", "act_fwd_launches"): 6,
                     ("activations", "act_bwd_launches"): 6}
    graph = next(iter(tr._plans.values())).graphs["train"]
    assert isinstance(graph, capture.StepGraph)
    assert sorted(n for _, _, n in graph.launches) == [1, 1, 1, 1]


def test_a_failing_capture_raises_and_stays_captured(monkeypatch):
    wf = _workflow("mnist")
    tr = fused.FusedTrainer(spec=wf.spec, params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cuda")
    real = fused.eval_minibatch

    def syncing(*args):
        out = real(*args)
        out["loss"].cpu()                        # a host sync in the step
        return out
    monkeypatch.setattr(fused, "eval_minibatch", syncing)
    ld = wf.loader
    before = ops.launch_counts()
    with pytest.raises(RuntimeError):
        tr.eval_epoch(ld.original_data, ld.original_labels,
                      np.arange(300), ld.max_minibatch_size)
    torch.cuda.synchronize()
    assert tr.captured
    # the eager step before the capture counted its launches; the failed
    # capture took back what it counted
    moved = {k: v - before[k] for k, v in ops.launch_counts().items()
             if v != before[k]}
    assert moved == {("softmax", "softmax_ce_launches"): 1,
                     ("activations", "act_fwd_launches"): 1}
    assert not any(p.graphs for p in tr._plans.values())
