"""Snapshots and resume in the port (``znicz_tpu_torch.snapshotter``)
against the JAX package's, on the CPU at small sizes.

* Snapshots cross packages: a mid-run snapshot written by the JAX
  package's ``SnapshotterToFile`` loads into the port, which finishes the
  run and matches the JAX continuous run (losses rtol 1e-4, error counts
  exact, final params atol 1e-5, the tolerances of
  tests/test_torch_mnist.py and tests/test_torch_fused.py); the reverse
  holds too, and each package's ``durability.verify`` accepts the other's
  files.  The PRNG state crosses both ways.
* The port alone: a run stopped right after its epoch-1 snapshot (a
  preemption) and resumed through ``Launcher(snapshot=...)`` equals the
  continuous run bit for bit, on the fused path and on the unit graph;
  the gz/bz2/xz codecs; the pinned torn-save order
  (``checkpoint.write_torn``); a corrupt ``current`` falling back to an
  older verified snapshot; every candidate corrupt → None; a direct load
  of a corrupt snapshot raising ``ArtifactCorrupt`` (the cases of
  tests/test_durability.py and tests/test_launcher.py)."""

import json
import os
import time

import numpy as np
import pytest
import torch

import znicz_tpu.snapshotter as ref_snapshotter
from znicz_tpu import durability as ref_durability
from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import Device
from znicz_tpu.config import root as ref_root
from znicz_tpu.launcher import Launcher as RefLauncher
from znicz_tpu.models import mnist as ref_mnist
from znicz_tpu_torch import durability, prng, snapshotter
from znicz_tpu_torch.config import root
from znicz_tpu_torch.launcher import Launcher
from znicz_tpu_torch.models import cifar, mnist
from znicz_tpu_torch.resilience.faults import (FaultInjected, FaultPlan,
                                               FaultSpec)
from znicz_tpu_torch.snapshotter import SnapshotterToFile
from znicz_tpu_torch.standard_workflow import sample_snapshotter_config

SPLIT = {"n_train": 300, "n_valid": 60, "n_test": 60, "noise": 3.0}
CIFAR_SPLIT = {"n_train": 120, "n_valid": 40, "n_test": 40, "noise": 0.3,
               "size": 16}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def small():
    """Small splits in both packages' trees (MNIST batch 60, CIFAR batch
    40); restored after, with any snapshotter subtree a test grew."""
    saved = [(t.mnist.synthetic.to_dict(), t.mnist.get("minibatch_size"),
              t.cifar.synthetic.to_dict(), t.cifar.get("minibatch_size"))
             for t in (ref_root, root)]
    for t in (ref_root, root):
        t.mnist.synthetic.update(SPLIT)
        t.mnist.minibatch_size = 60
        t.cifar.synthetic.update(CIFAR_SPLIT)
        t.cifar.minibatch_size = 40
    yield
    for t, (ms, mb, cs, cb) in zip((ref_root, root), saved):
        t.mnist.synthetic.update(ms)
        t.mnist.minibatch_size = mb
        t.cifar.synthetic.update(cs)
        t.cifar.minibatch_size = cb
        for tree in (t.mnist, t.cifar):
            tree.__dict__.pop("snapshotter", None)


class Preempted(Exception):
    """Raised right after the epoch-1 snapshot: the run dies there."""


def _preempt_after_second_epoch(monkeypatch, cls):
    """Make ``cls.epoch_end`` raise Preempted(path of the epoch-1
    ``current`` snapshot) once two epochs have been seen."""
    orig = cls.epoch_end

    def epoch_end(self, improved, before_save=None):
        orig(self, improved, before_save)
        if self._epochs_seen == 2:
            raise Preempted(self.last_path)
    monkeypatch.setattr(cls, "epoch_end", epoch_end)
    return orig


def _preempted_snapshot(monkeypatch, run, cls, directory):
    orig = _preempt_after_second_epoch(monkeypatch, cls)
    try:
        run({"directory": directory, "interval": 1})
    except Preempted as e:
        return e.args[0]
    finally:
        monkeypatch.setattr(cls, "epoch_end", orig)
    raise AssertionError("the run was not stopped after epoch 1")


def _unit_arrays(wf) -> dict:
    """Every unit's state Vector on the host, keyed as a snapshot keys
    them."""
    out = {}
    for unit in wf.units:
        for attr in snapshotter._STATE_VECTORS:
            vec = unit.__dict__.get(attr)
            if vec is not None and vec:
                out[f"{unit.name}/{attr}"] = np.array(vec.mem)
    return out


def _metrics_close(got, want):
    assert len(got) == len(want)
    for g, w in zip(got, want):
        assert sorted(g) == sorted(w)
        for k in w:
            if k.endswith(("_loss", "_mse")):
                np.testing.assert_allclose(g[k], w[k], rtol=1e-4, err_msg=k)
            elif k.endswith("_n_err") or k == "epoch":
                assert g[k] == w[k], (k, g, w)


# -- snapshots cross packages ------------------------------------------------
def _ref_run(epochs, snapshotter_config=None):
    ref_prng.seed_all(7)
    wf = ref_mnist.MnistWorkflow(snapshotter_config=snapshotter_config)
    wf.decision.max_epochs = epochs
    wf.initialize(device=Device.create("xla"))
    wf.train(fused=True)
    return wf


def _port_run(epochs, snapshotter_config=None, fused=True, model=mnist):
    prng.seed_all(7)
    return model.run(device="cpu", epochs=epochs, fused=fused,
                     snapshotter_config=snapshotter_config)


def test_reference_snapshot_resumes_in_the_port(small, monkeypatch,
                                                tmp_path):
    cont = _ref_run(3)
    path = _preempted_snapshot(
        monkeypatch, lambda cfg: _ref_run(3, cfg),
        ref_snapshotter.SnapshotterToFile, str(tmp_path))
    assert durability.verify(path)["verified"] == "manifest"
    res = Launcher("znicz_tpu_torch.models.mnist", device="cpu",
                   snapshot=path, epochs=3, fused=True, seed=7).run()
    _metrics_close(res.decision.epoch_metrics, cont.decision.epoch_metrics)
    want = {k: np.asarray(v) for k, v in _unit_arrays(cont).items()}
    for k, v in _unit_arrays(res).items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_port_snapshot_resumes_in_the_reference(small, monkeypatch,
                                                tmp_path):
    cont = _port_run(3)
    path = _preempted_snapshot(
        monkeypatch, lambda cfg: _port_run(3, cfg), SnapshotterToFile,
        str(tmp_path))
    assert ref_durability.verify(path)["verified"] == "manifest"
    res = RefLauncher("znicz_tpu.models.mnist", backend="xla",
                      snapshot=path, epochs=3, fused=True, seed=7).run()
    _metrics_close(res.decision.epoch_metrics, cont.decision.epoch_metrics)
    want = _unit_arrays(cont)
    got = _unit_arrays(res)
    assert sorted(got) == sorted(want)
    for k, v in got.items():
        np.testing.assert_allclose(v, want[k], atol=1e-5, rtol=0,
                                   err_msg=k)


def test_reference_unit_graph_snapshot_loads_into_the_port(small,
                                                           tmp_path):
    """The reference's unit-graph snapshot (taken before its last tick's
    GD chain, at the finished epoch's number) loads as it is."""
    ref_prng.seed_all(7)
    ref = ref_mnist.MnistWorkflow(
        snapshotter_config={"directory": str(tmp_path), "prefix": "ref"})
    ref.decision.max_epochs = 1
    ref.initialize(device=Device.create("numpy"))
    ref.run()
    path = ref.snapshotter.last_path
    prng.seed_all(11)
    wf = mnist.MnistWorkflow()
    wf.initialize(device="cpu")
    meta = SnapshotterToFile.load(wf, path)
    with np.load(path) as z:
        saved = {k: z[k] for k in z.files if k != "__meta_json__"}
    got = _unit_arrays(wf)
    assert sorted(got) == sorted(saved)
    for k in saved:
        np.testing.assert_array_equal(got[k], saved[k])
    assert wf.loader.epoch_number == meta["epoch_number"] == 0
    assert wf.decision.epoch_metrics == meta["epoch_metrics"]
    assert wf.decision.best_n_err == meta["best_n_err"]


def test_prng_state_crosses_packages():
    ref_prng.seed_all(3)
    prng.seed_all(3)
    for p in (ref_prng, prng):
        p.get("loader").normal(size=5)
    gen = prng.get("loader").torch_generator("cpu")
    torch.rand(4, generator=gen)
    port_state = json.loads(json.dumps(prng.state()))
    assert port_state["loader"]["fold"] == 0
    assert "torch" in port_state["loader"]
    ref_state = json.loads(json.dumps(ref_prng.state()))
    ref_prng.seed_all(99)
    ref_prng.set_state(port_state)
    prng.seed_all(99)
    prng.set_state(ref_state)
    np.testing.assert_array_equal(ref_prng.get("loader").normal(size=3),
                                  prng.get("loader").normal(size=3))
    want = torch.rand(4, generator=gen)
    prng.seed_all(99)
    prng.set_state(port_state)
    got = torch.rand(4, generator=prng.get("loader").torch_generator("cpu"))
    torch.testing.assert_close(got, want, rtol=0, atol=0)


# -- the port alone ----------------------------------------------------------
RESUME_CASES = {
    "mnist_fused": (mnist, True, None),
    "mnist_units": (mnist, False, None),
    "mnist_units_lr_by_minibatch": (
        mnist, False, {"policy": ("step_exp", {"gamma": 0.5, "step": 3}),
                       "by_epoch": False}),
    "cifar_fused": (cifar, True, None),
}


@pytest.mark.parametrize("case", sorted(RESUME_CASES))
def test_midrun_resume_equals_continuous(case, small, monkeypatch,
                                         tmp_path):
    """A run stopped right after its epoch-1 snapshot and resumed in a
    fresh workflow for the third epoch ends bit for bit where the
    continuous 3-epoch run ends: params, velocities and epoch metrics."""
    model, fused, adj = RESUME_CASES[case]

    def run(epochs, cfg=None):
        prng.seed_all(7)
        return model.run(device="cpu", epochs=epochs, fused=fused,
                         snapshotter_config=cfg, lr_adjuster_config=adj)
    cont = run(3)
    path = _preempted_snapshot(monkeypatch, lambda cfg: run(3, cfg),
                               SnapshotterToFile, str(tmp_path))
    launcher = Launcher(model.__name__, device="cpu", snapshot=path,
                        epochs=3, fused=fused, seed=7)
    if adj is not None:
        # the samples take an adjuster as an argument, not from their
        # tree: resume into a workflow built with it
        def build(module, device):
            wf = module.MnistWorkflow(lr_adjuster_config=adj)
            wf.initialize(device=device)
            return wf
        launcher._build_workflow_only = build
    res = launcher.run()
    assert res.decision.epoch_metrics == cont.decision.epoch_metrics
    want, got = _unit_arrays(cont), _unit_arrays(res)
    assert sorted(got) == sorted(want)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k], err_msg=k)
    if fused:
        for a, b in zip(cont.params + cont.vels, res.params + res.vels):
            for x, y in zip(a, b):
                assert (x is None) == (y is None)
                if x is not None:
                    torch.testing.assert_close(y, x, rtol=0, atol=0)


def test_unit_graph_saves_after_the_gd_chain(small):
    """The snapshotter fires in a tick after the decision and the GD
    chain's last unit, so an epoch's snapshot holds its last update."""
    wf = mnist.MnistWorkflow(snapshotter_config={"directory": "unused"})
    wf.initialize(device="cpu")
    order = wf._topo
    snap = order.index(wf.snapshotter)
    assert snap > order.index(wf.decision)
    assert all(snap > order.index(g) for g in wf.gds)


@pytest.mark.parametrize("codec", ["gz", "bz2", "xz"])
def test_codec_round_trip(codec, small, tmp_path):
    wf = _port_run(1, {"directory": str(tmp_path), "prefix": f"c_{codec}",
                       "compression": codec})
    path = os.path.join(str(tmp_path), f"c_{codec}_current.npz.{codec}")
    assert os.path.exists(path) and wf.snapshotter.last_path == path
    assert ref_durability.verify(path, deep=True)["verified"] == "manifest"
    prng.seed_all(12)
    wf2 = mnist.MnistWorkflow()
    wf2.initialize(device="cpu")
    meta = SnapshotterToFile.load(wf2, path)
    assert meta["epoch_number"] == 1
    want, got = _unit_arrays(wf), _unit_arrays(wf2)
    for k in want:
        np.testing.assert_array_equal(got[k], want[k])
    # and the reference reads it
    ref_prng.seed_all(12)
    ref = ref_mnist.MnistWorkflow()
    ref.initialize(device=Device.create("numpy"))
    ref_snapshotter.SnapshotterToFile.load(ref, path)
    np.testing.assert_array_equal(ref.forwards[0].weights.mem,
                                  want["fwd0_all2all_tanh/weights"])


def test_unknown_codec_is_refused():
    with pytest.raises(ValueError, match="compression"):
        SnapshotterToFile(None, compression="zip")


def _tiny_workflow():
    saved = root.mnist.synthetic.to_dict()
    root.mnist.synthetic.update({"n_train": 60, "n_valid": 20, "n_test": 0})
    try:
        prng.seed_all(9)
        wf = mnist.MnistWorkflow()
        wf.initialize(device="cpu")
    finally:
        root.mnist.synthetic.update(saved)
    return wf


def _flip_byte(path):
    size = os.path.getsize(path)
    with open(path, "r+b") as fh:
        fh.seek(size // 2)
        b = fh.read(1)
        fh.seek(size // 2)
        fh.write(bytes([b[0] ^ 0xFF]))


def test_save_writes_manifest(tmp_path):
    snap = SnapshotterToFile(_tiny_workflow(), directory=str(tmp_path))
    path = snap.save("current")
    assert durability.verify(path)["verified"] == "manifest"
    assert ref_durability.verify(path)["verified"] == "manifest"
    with open(path + ".json") as fh:
        assert json.load(fh)["epoch_number"] == 0


def test_torn_save_ordering_pinned(tmp_path):
    """A death between the blob and manifest renames leaves the NEW blob
    with NO manifest; restore loads it and heals the manifest."""
    wf = _tiny_workflow()
    snap = SnapshotterToFile(wf, directory=str(tmp_path))
    snap.save("current")
    blob = str(tmp_path / "snapshot_current.npz")
    first = durability.sha256_file(blob)[0]
    wf.loader.epoch_number = 5
    with FaultPlan([FaultSpec("checkpoint.write_torn", times=1)]):
        with pytest.raises(FaultInjected):
            snap.save("current")
    assert durability.sha256_file(blob)[0] != first
    assert not os.path.exists(blob + ".manifest.json")
    found = SnapshotterToFile.restore(_tiny_workflow(),
                                      directory=str(tmp_path))
    assert found is not None
    meta, path = found
    assert path == blob and int(meta["epoch_number"]) == 5
    assert os.path.exists(blob + ".manifest.json")


def test_save_fault_fires_before_any_write(tmp_path):
    snap = SnapshotterToFile(_tiny_workflow(),
                             directory=str(tmp_path / "snaps"))
    with FaultPlan([FaultSpec("checkpoint.save", times=1)]):
        with pytest.raises(FaultInjected):
            snap.save("current")
    assert not os.path.exists(str(tmp_path / "snaps"))


def test_corrupt_current_falls_back_to_older_verified(tmp_path):
    snap = SnapshotterToFile(_tiny_workflow(), directory=str(tmp_path))
    older = snap.save("best")
    newer = snap.save("current")
    past = time.time() - 60
    os.utime(older, (past, past))
    _flip_byte(newer)
    found = SnapshotterToFile.restore(_tiny_workflow(),
                                      directory=str(tmp_path))
    assert found is not None and found[1] == older
    assert os.path.exists(newer + ".corrupt")
    assert not os.path.exists(newer)
    assert snapshotter.snapshot_candidates(str(tmp_path)) == [older]


def test_bitflip_fault_site_drives_fallback(tmp_path):
    snap = SnapshotterToFile(_tiny_workflow(), directory=str(tmp_path))
    with FaultPlan([FaultSpec("artifact.bitflip", after=1, times=1)]):
        first = snap.save("best")
        second = snap.save("current")
    past = time.time() - 60
    os.utime(first, (past, past))
    found = SnapshotterToFile.restore(_tiny_workflow(),
                                      directory=str(tmp_path))
    assert found is not None and found[1] == first
    assert os.path.exists(second + ".corrupt")


def test_every_candidate_corrupt_returns_none(tmp_path):
    snap = SnapshotterToFile(_tiny_workflow(), directory=str(tmp_path))
    _flip_byte(snap.save("current"))
    assert SnapshotterToFile.restore(_tiny_workflow(),
                                     directory=str(tmp_path)) is None


def test_direct_load_of_corrupt_snapshot_is_typed(tmp_path):
    wf = _tiny_workflow()
    path = SnapshotterToFile(wf, directory=str(tmp_path)).save("current")
    _flip_byte(path)
    with pytest.raises(durability.ArtifactCorrupt):
        SnapshotterToFile.load(wf, path)


def test_load_fault_site(tmp_path):
    wf = _tiny_workflow()
    path = SnapshotterToFile(wf, directory=str(tmp_path)).save("current")
    with FaultPlan([FaultSpec("checkpoint.load", times=1)]):
        with pytest.raises(FaultInjected):
            SnapshotterToFile.load(wf, path)


def test_samples_default_their_snapshotter_from_the_tree(small, tmp_path):
    root.mnist.snapshotter = {"directory": str(tmp_path), "interval": 2,
                              "prefix": "tree"}
    wf = mnist.MnistWorkflow()
    assert isinstance(wf.snapshotter, SnapshotterToFile)
    assert (wf.snapshotter.directory, wf.snapshotter.interval,
            wf.snapshotter.prefix) == (str(tmp_path), 2, "tree")
    explicit = mnist.MnistWorkflow(snapshotter_config={"prefix": "arg"})
    assert explicit.snapshotter.prefix == "arg"
    root.mnist.__dict__.pop("snapshotter")
    assert mnist.MnistWorkflow().snapshotter is None
    assert sample_snapshotter_config(root.mnist, {}) == {}
    assert sample_snapshotter_config(root.mnist, None) is None


def test_loader_reset_state_rebuilds_the_stored_epoch(small):
    prng.seed_all(5)
    a = mnist.MnistWorkflow()
    a.initialize(device="cpu")
    st = prng.state()
    want = a.loader.train_permutation(1).copy()
    prng.seed_all(5)
    b = mnist.MnistWorkflow()
    b.initialize(device="cpu")
    prng.set_state(st)
    b.loader.epoch_number = 1
    b.loader.reset_state()
    np.testing.assert_array_equal(b.loader._shuffled[2], want)
    assert b.loader.resume_epoch() == 1
