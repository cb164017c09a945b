"""Device checkpoints of a fused trainer whose steps replay CUDA graphs,
on a card:

* a restore into a trainer whose graphs are captured copies in place —
  every tensor keeps its address — and the next replayed epoch trains the
  restored weights: its metrics, params and velocities equal, bit for bit,
  the epoch the trainer ran from the checkpoint's state the first time;
* an asynchronous save (``block=False``) followed at once by a step that
  updates the params in place writes the state as it was at the save.

Every test needs a CUDA card and skips without one; this file imports no
JAX (tests/test_torch_checkpoint.py holds the checkpointer on the CPU)."""

import importlib

import numpy as np
import pytest
import torch

from znicz_tpu_torch import prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.parallel import checkpoint, fused
from znicz_tpu_torch.parallel.checkpoint import TrainerCheckpointer
from znicz_tpu_torch.profile_fused import MODELS

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the CUDA graphs run only on a card")

#: model → its split (full widths)
SPLITS = {"mnist": {"n_train": 600, "n_valid": 200, "n_test": 100},
          "cifar": {"n_train": 400, "n_valid": 200, "n_test": 100}}


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


def _trainer(model: str):
    module = importlib.import_module(f"znicz_tpu_torch.models.{model}")
    tree = getattr(root, model)
    saved = tree.synthetic.to_dict()
    tree.synthetic.update(SPLITS[model])
    prng.seed_all(1234)
    try:
        wf = getattr(module, MODELS[model][0])()
        wf.initialize(device="cuda")
    finally:
        tree.synthetic.update(saved)
    tr = fused.FusedTrainer(workflow=wf, spec=wf.spec,
                            params=wf.spec_rows(wf.params),
                            vels=wf.spec_rows(wf.vels), device="cuda")
    assert tr.captured, tr.uncaptured_reason
    return wf, tr


def _epoch(wf, tr, epoch):
    ld = wf.loader
    return tr.train_epoch(ld.original_data, ld.original_labels,
                          ld.train_permutation(epoch),
                          ld.max_minibatch_size, epoch=epoch)


def _tensors(tr):
    return [t for pair in tr.params + tr.vels for t in pair
            if t is not None]


@pytest.mark.parametrize("model", sorted(SPLITS))
def test_restore_into_a_captured_trainer_is_in_place(model, deterministic,
                                                     tmp_path):
    wf, tr = _trainer(model)
    _epoch(wf, tr, 0)                   # captures the train graph
    ck = TrainerCheckpointer(str(tmp_path))
    ck.save(tr, 0)
    first = _epoch(wf, tr, 1)           # replays from the saved state
    want = [t.clone() for t in _tensors(tr)]
    ptrs = [t.data_ptr() for t in _tensors(tr)]
    graphs = {k: dict(p.graphs) for k, p in tr._plans.items()}
    with torch.no_grad():
        for t in _tensors(tr):
            t.add_(1.0)
    assert ck.restore(tr) == 0
    assert [t.data_ptr() for t in _tensors(tr)] == ptrs
    again = _epoch(wf, tr, 1)
    # the same graphs replayed: nothing was captured again
    assert {k: dict(p.graphs) for k, p in tr._plans.items()} == graphs
    for k in first:
        np.testing.assert_array_equal(again[k], first[k], err_msg=k)
    for got, w in zip(_tensors(tr), want):
        torch.testing.assert_close(got, w, rtol=0, atol=0)
    ck.close()


@pytest.mark.parametrize("model", sorted(SPLITS))
def test_async_save_holds_the_state_at_the_save(model, deterministic,
                                                tmp_path):
    wf, tr = _trainer(model)
    _epoch(wf, tr, 0)
    at_save = [t.clone() for t in _tensors(tr)]
    ck = TrainerCheckpointer(str(tmp_path))
    ck.save(tr, 5, block=False)
    _epoch(wf, tr, 1)                   # updates the params in place now
    ck.wait()
    moved = [not torch.equal(a, b) for a, b in zip(_tensors(tr), at_save)]
    assert any(moved)
    with np.load(str(tmp_path / "5" / checkpoint.STATE_FILE)) as z:
        saved = [z[k] for k, t in checkpoint._entries(tr) if t is not None]
    for got, want in zip(saved, at_save):
        np.testing.assert_array_equal(got, want.cpu().numpy())
    ck.close()
