"""Device checkpoints of the fused trainer
(``znicz_tpu_torch.parallel.checkpoint.TrainerCheckpointer``) and the
directory half of ``durability`` on the CPU, at small sizes: the
reference's contract without Orbax.

* a round trip, in place: the trainer's tensors keep their addresses
  (``data_ptr()``), which CUDA graphs captured on the card depend on;
* ``max_to_keep`` with asynchronous saves, ``wait``/``close``,
  ``latest_step``;
* a spec mismatch refused before any array is read;
* ``on_blessed`` once per step, after the step's manifest commits, its
  exceptions logged and swallowed;
* a corrupt newest step quarantined and the restore landing on the older
  one; an explicit corrupt step raising ``ArtifactCorrupt``; the
  reference's ``durability.verify`` accepting the port's step directories
  and the port's the reference's directory manifests;
* the ``checkpoint.save``/``checkpoint.load`` fault sites, gradient
  accumulators checked zero at a save and zeroed at a restore, and
  ``run_fused(checkpoint_dir=...)`` saving an epoch's state after its
  deferred tail update."""

import json
import os
import threading

import numpy as np
import pytest
import torch

from znicz_tpu import durability as ref_durability
from znicz_tpu_torch import durability, prng
from znicz_tpu_torch.config import root
from znicz_tpu_torch.durability import integrity
from znicz_tpu_torch.models import mnist
from znicz_tpu_torch.parallel import checkpoint
from znicz_tpu_torch.parallel.checkpoint import (TrainerCheckpointer,
                                                 restore_trainer,
                                                 save_trainer)
from znicz_tpu_torch.parallel.fused import FusedTrainer
from znicz_tpu_torch.resilience.faults import (FaultInjected, FaultPlan,
                                               FaultSpec)

SPLIT = {"n_train": 240, "n_valid": 60, "n_test": 60}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small():
    saved = (root.mnist.synthetic.to_dict(),
             root.mnist.get("minibatch_size"))
    root.mnist.synthetic.update(SPLIT)
    root.mnist.minibatch_size = 60
    yield
    root.mnist.synthetic.update(saved[0])
    root.mnist.minibatch_size = saved[1]


def _workflow(layers=None):
    prng.seed_all(21)
    wf = mnist.MnistWorkflow(layers=layers)
    wf.initialize(device="cpu")
    return wf


def _trainer(wf, accum_steps=1):
    return FusedTrainer(workflow=wf, spec=wf.spec,
                        params=wf.spec_rows(wf.params),
                        vels=wf.spec_rows(wf.vels), device="cpu",
                        accum_steps=accum_steps)


def _train(wf, tr, epoch=0):
    ld = wf.loader
    idx = np.arange(sum(ld.class_lengths[:2]), sum(ld.class_lengths))
    return tr.train_epoch(ld.original_data, ld.original_labels, idx,
                          ld.max_minibatch_size, epoch=epoch)


def _state(tr):
    return [None if t is None else t.clone()
            for pair in tr.params + tr.vels for t in pair]


def _assert_state(tr, want):
    got = [t for pair in tr.params + tr.vels for t in pair]
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            torch.testing.assert_close(g, w, rtol=0, atol=0)


def test_round_trip_in_place(small, tmp_path):
    wf = _workflow()
    tr = _trainer(wf)
    _train(wf, tr)
    want = _state(tr)
    ck = TrainerCheckpointer(str(tmp_path))
    ck.save(tr, 3)
    assert ck.latest_step() == 3
    step_dir = str(tmp_path / "3")
    assert sorted(os.listdir(step_dir)) == sorted(
        [checkpoint.STATE_FILE, checkpoint.META_FILE,
         integrity.DIR_MANIFEST_NAME])
    ptrs = [t.data_ptr() for pair in tr.params + tr.vels for t in pair
            if t is not None]
    _train(wf, tr, epoch=1)
    assert ck.restore(tr) == 3
    _assert_state(tr, want)
    assert ptrs == [t.data_ptr() for pair in tr.params + tr.vels
                    for t in pair if t is not None]
    # the reference's verifier accepts the port's step directory
    assert ref_durability.verify(step_dir)["verified"] == "manifest"
    ck.close()


def test_absent_rows_stay_absent(small, tmp_path):
    """A parameter-less row (a standalone activation) is saved as absent
    keys and restored as None."""
    layers = [
        {"type": "all2all", "->": {"output_sample_shape": 16},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}},
        {"type": "activation_tanh"},
        {"type": "softmax", "->": {"output_sample_shape": 10},
         "<-": {"learning_rate": 0.05, "gradient_moment": 0.9}}]
    wf = _workflow(layers)
    tr = _trainer(wf)
    _train(wf, tr)
    want = _state(tr)
    save_trainer(tr, str(tmp_path), step=0)
    with np.load(str(tmp_path / "0" / checkpoint.STATE_FILE)) as z:
        assert "params/1/w" not in z.files and "params/0/w" in z.files
    _train(wf, tr, epoch=1)
    assert restore_trainer(tr, str(tmp_path)) == 0
    _assert_state(tr, want)


def test_max_to_keep_with_async_saves(small, tmp_path):
    wf = _workflow()
    tr = _trainer(wf)
    blessed = []
    ck = TrainerCheckpointer(str(tmp_path), max_to_keep=2,
                             on_blessed=lambda s, d: blessed.append(s))
    states = {}
    for step in range(4):
        _train(wf, tr, epoch=step)
        states[step] = _state(tr)
        ck.save(tr, step, block=False)
    ck.wait()
    assert sorted(os.listdir(str(tmp_path))) == ["2", "3"]
    assert blessed == [0, 1, 2, 3]
    assert ck.latest_step() == 3
    ck.restore(tr, step=2)
    _assert_state(tr, states[2])
    ck.close()


def test_on_blessed_fires_once_a_step_after_the_manifest(small, tmp_path,
                                                         caplog):
    wf = _workflow()
    tr = _trainer(wf)
    seen = []

    def on_blessed(step, step_dir):
        # the step is verifiable when its subscriber hears of it
        assert durability.verify(step_dir)["verified"] == "manifest"
        seen.append((step, step_dir, threading.current_thread().name))
        raise RuntimeError("a broken subscriber")

    ck = TrainerCheckpointer(str(tmp_path), on_blessed=on_blessed)
    ck.save(tr, 0)
    ck.save(tr, 1, block=False)
    ck.close()
    assert [(s, d) for s, d, _ in seen] == [
        (0, str(tmp_path / "0")), (1, str(tmp_path / "1"))]
    assert all(name.startswith("checkpoint-writer") for *_, name in seen)
    assert "on_blessed callback failed" in caplog.text


def test_spec_mismatch_refused_before_any_array_is_read(small, tmp_path,
                                                        monkeypatch):
    wf = _workflow()
    tr = _trainer(wf)
    save_trainer(tr, str(tmp_path), step=0)
    other = _workflow([
        {"type": "all2all_tanh", "->": {"output_sample_shape": 12}},
        {"type": "softmax", "->": {"output_sample_shape": 10}}])
    tr2 = _trainer(other)
    want = _state(tr2)

    def no_read(*a, **kw):
        raise AssertionError("an array was read")
    monkeypatch.setattr(checkpoint.np, "load", no_read)
    with pytest.raises(ValueError, match="spec mismatch"):
        restore_trainer(tr2, str(tmp_path))
    _assert_state(tr2, want)


def test_corrupt_newest_step_is_quarantined(small, tmp_path):
    wf = _workflow()
    tr = _trainer(wf)
    ck = TrainerCheckpointer(str(tmp_path), max_to_keep=None)
    ck.save(tr, 0)
    want = _state(tr)
    _train(wf, tr)
    ck.save(tr, 1)
    state = str(tmp_path / "1" / checkpoint.STATE_FILE)
    size = os.path.getsize(state)
    with open(state, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))
    with pytest.raises(durability.ArtifactCorrupt):
        ck.restore(tr, step=1)
    assert ck.latest_step() == 1
    assert ck.restore(tr) == 0
    _assert_state(tr, want)
    assert os.path.isdir(str(tmp_path / "1.corrupt"))
    assert ck.latest_step() == 0
    ck.close()


def test_no_checkpoint_raises(small, tmp_path):
    tr = _trainer(_workflow())
    with pytest.raises(FileNotFoundError):
        restore_trainer(tr, str(tmp_path))


def test_reference_directory_manifest_verifies_in_the_port(tmp_path):
    d = tmp_path / "7"
    d.mkdir()
    (d / "a.bin").write_bytes(b"x" * 100)
    (d / "sub").mkdir()
    (d / "sub" / "b.bin").write_bytes(b"y" * 10)
    ref_durability.write_manifest(str(d), kind="checkpoint")
    assert durability.verify(str(d))["verified"] == "manifest"
    (d / "sub" / "b.bin").write_bytes(b"z" * 10)
    with pytest.raises(durability.ArtifactCorrupt) as e:
        durability.verify(str(d))
    assert e.value.reason == "digest"
    assert durability.newest_verified([str(d)]) is None
    assert os.path.isdir(str(tmp_path / "7.corrupt"))


def test_fault_sites(small, tmp_path):
    tr = _trainer(_workflow())
    ck = TrainerCheckpointer(str(tmp_path))
    with FaultPlan([FaultSpec("checkpoint.save", times=1)]):
        with pytest.raises(FaultInjected):
            ck.save(tr, 0)
    assert ck.latest_step() is None
    ck.save(tr, 0)
    with FaultPlan([FaultSpec("checkpoint.load", times=1)]):
        with pytest.raises(FaultInjected):
            ck.restore(tr)
    ck.close()


def test_accumulators_are_zero_at_a_save_and_after_a_restore(small,
                                                             tmp_path):
    wf = _workflow()
    tr = _trainer(wf, accum_steps=2)
    ck = TrainerCheckpointer(str(tmp_path))
    ck.save(tr, 0)
    tr._acc[0][0].add_(1.0)
    with pytest.raises(RuntimeError, match="accumulation"):
        ck.save(tr, 1)
    ck.restore(tr, step=0)
    assert not any(bool(a.any()) for pair in tr._acc if pair for a in pair
                   if a is not None)
    ck.close()


def test_run_fused_checkpoints_each_epoch(small, tmp_path):
    """``run_fused(checkpoint_dir=...)`` saves every epoch (the mid-run
    ones with their deferred tail update, the last one without it) and
    closes its checkpointer; each step restores to the workflow's state
    at that epoch."""
    prng.seed_all(21)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    wf.decision.max_epochs = 2
    seen = []
    ck = TrainerCheckpointer(str(tmp_path), max_to_keep=None,
                             on_blessed=lambda s, d: seen.append(s))
    tr = wf.train(fused=True, checkpointer=ck)
    assert seen == [0, 1]
    final = _state(tr)
    ck.restore(tr, step=1)
    _assert_state(tr, final)
    with open(str(tmp_path / "0" / checkpoint.META_FILE)) as fh:
        assert json.load(fh)["step"] == 0
    ck.close()
    wf2 = mnist.MnistWorkflow()
    prng.seed_all(21)
    wf2.initialize(device="cpu")
    wf2.train(fused=True, max_epochs=2,
              checkpoint_dir=str(tmp_path / "owned"), checkpoint_every=2)
    assert sorted(os.listdir(str(tmp_path / "owned"))) == ["1"]
