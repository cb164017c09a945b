"""The port's streaming data plane (znicz_tpu_torch.loader.streaming,
znicz_tpu_torch.parallel.stream) on the CPU.

* ``BatchPrefetcher``: every row in order, into fresh tensors or into a
  ``StagingRing``'s slots; a producer's error raised in the consumer; an
  abandoned iteration releases (and joins) the producer.
* ``StreamTrainer`` over ``.znr`` shards: bit for bit the port's resident
  ``FusedTrainer`` on the same rows (eager steps, and the plan-fed steps the
  card replays from CUDA graphs, run here directly), with ``accum_steps`` 1
  and 2, for a softmax head and both MSE targets; and within the tolerance
  of tests/test_torch_fused.py (per-step loss rtol 1e-5, n_err exact,
  params atol 1e-5) of the JAX package's ``StreamTrainer`` on the same
  shards.
* ``run_fused`` over a ``RecordLoader`` routes to the ``StreamTrainer`` and
  equals the reference's run epoch for epoch (rtol 1e-5).
* The unit graph through ``fill_minibatch``: the same minibatches as the
  full-batch loader's, bit for bit, and the whole MNIST unit graph's epoch
  from shards equal to its epoch from the resident loader."""

import dataclasses

import numpy as np
import pytest
import torch

from znicz_tpu import prng as ref_prng
from znicz_tpu.backends import NumpyDevice
from znicz_tpu.loader import RecordLoader as RefRecordLoader
from znicz_tpu.parallel import fused as ref_fused
from znicz_tpu.parallel.stream import StreamTrainer as RefStreamTrainer
from znicz_tpu.workflow import Workflow as RefWorkflow
from znicz_tpu_torch import convert, prng
from znicz_tpu_torch.loader import (BatchPrefetcher, RecordLoader,
                                    StagingRing, StreamingLoader,
                                    write_records)
from znicz_tpu_torch.loader.fullbatch import FullBatchLoader
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
    """A capture that runs the plan-fed step directly (the CPU has no
    graphs): the card's captured path, step for step."""
    def fake(plan, fn):
        fn()
        return _Direct(fn)
    monkeypatch.setattr(capture.StepPlan, "capture", fake)


def _dataset(n=60, shape=(6, 6, 1), classes=5, seed=0):
    gen = np.random.default_rng(seed)
    data = gen.standard_normal((n, *shape)).astype(np.float32)
    labels = gen.integers(0, classes, n).astype(np.int32)
    return data, labels


def _loader(paths, batch, **kw):
    ld = RecordLoader(Workflow(name="w"), train_paths=paths,
                      minibatch_size=batch, **kw)
    ld.initialize("cpu")
    return ld


# -- the prefetcher ----------------------------------------------------------
@pytest.mark.parametrize("ring", [False, True])
def test_prefetcher_yields_all_rows_in_order(tmp_path, ring):
    data, labels = _dataset(n=32)
    ld = _loader(write_records(str(tmp_path / "d.znr"), data, labels,
                               shard_size=12), 8)
    rows = np.random.default_rng(1).permutation(32).reshape(4, 8)
    st = StagingRing("cpu", 2, 8, ld.sample_shape, ld.label_shape,
                     ld.label_dtype, dest=True) if ring else None
    got = []
    for x, t in BatchPrefetcher(ld, rows, depth=2, device="cpu", ring=st):
        got.append((x.clone(), t.clone()))     # a slot is valid until next
        if ring:
            assert x.data_ptr() in (st.x[0].data_ptr(), st.x[1].data_ptr())
    assert len(got) == 4
    for i, (x, t) in enumerate(got):
        np.testing.assert_array_equal(x.numpy(), data[rows[i]])
        np.testing.assert_array_equal(t.numpy(), labels[rows[i]])
    assert ld.reader == "native" and ld.served()["native"] == 32


def test_prefetcher_skip_labels_reads_no_labels(tmp_path):
    data, labels = _dataset(n=16)
    ld = _loader(write_records(str(tmp_path / "d.znr"), data, labels), 8)
    got = list(BatchPrefetcher(ld, np.arange(16).reshape(2, 8),
                               device="cpu", skip_labels=True))
    assert all(t is None for _, t in got)
    np.testing.assert_array_equal(got[1][0].numpy(), data[8:])


def test_producer_error_surfaces():
    class Exploding(StreamingLoader):
        def load_meta(self):
            self.class_lengths = [0, 0, 8]
            self.sample_shape = (2,)

        def read_batch(self, indices):
            raise RuntimeError("disk on fire")

    ld = Exploding(Workflow(name="w"))
    ld.load_data()
    with pytest.raises(RuntimeError, match="disk on fire"):
        list(BatchPrefetcher(ld, np.zeros((1, 4), np.int32), device="cpu"))


@pytest.mark.parametrize("ring", [False, True])
def test_abandoned_iteration_releases_producer(tmp_path, ring):
    data, labels = _dataset(n=64)
    ld = _loader(write_records(str(tmp_path / "d.znr"), data, labels), 8)
    st = StagingRing("cpu", 2, 8, ld.sample_shape, ld.label_shape,
                     ld.label_dtype, dest=True) if ring else None
    pf = BatchPrefetcher(ld, np.arange(64).reshape(8, 8), depth=2,
                         device="cpu", ring=st)
    it = iter(pf)
    next(it)
    it.close()                 # GeneratorExit → finally → pf.close()
    pf._thread.join(timeout=5.0)
    assert not pf._thread.is_alive()


# -- StreamTrainer against the resident trainer and the reference ------------
def _mnist_like(n_train=50, n_valid=10, batch=20, seed=42):
    """A tiny MLP spec (36→12 tanh→5 softmax) and data from the reference's
    hand-built helpers, as numpy."""
    gen = np.random.default_rng(seed)
    hyp, hyp_b = (0.05, 1e-3, 0.3, 0.9), (0.02, 1e-4, 0.5, 0.8)
    layers = (ref_fused.LayerSpec("fc", "tanh", True, hyp, hyp_b),
              ref_fused.LayerSpec("fc", "linear", True, hyp, hyp_b))
    params = [tuple((gen.standard_normal(s) * 0.3).astype(np.float32)
                    for s in ((36, 12), (12,))),
              tuple((gen.standard_normal(s) * 0.3).astype(np.float32)
                    for s in ((12, 5), (5,)))]
    vels = [tuple(np.zeros_like(a) for a in p) for p in params]
    data, labels = _dataset(n=n_train + n_valid, seed=seed)
    return layers, params, vels, data, labels


AE_HYP = (0.01, 0.0, 0.0, 0.9)


def _ae_spec(feats=25, hidden=8, seed=77):
    gen = np.random.default_rng(seed)
    layers = (ref_fused.LayerSpec("fc", "tanh", True, AE_HYP, AE_HYP),
              ref_fused.LayerSpec("fc", "linear", True, AE_HYP, AE_HYP))
    params = [((gen.standard_normal((feats, hidden)) * 0.1).astype(
        np.float32), np.zeros(hidden, np.float32)),
        ((gen.standard_normal((hidden, feats)) * 0.1).astype(np.float32),
         np.zeros(feats, np.float32))]
    vels = [(np.zeros_like(w), np.zeros_like(b)) for w, b in params]
    return layers, params, vels


def _port(layers, loss, params, vels):
    return convert.from_reference([dataclasses.asdict(la) for la in layers],
                                  loss, params, vels, device="cpu")


def _eq(a, b):
    return all(torch.equal(x, y) for pa, pb in zip(a, b)
               for x, y in zip(pa, pb) if x is not None)


CASES = {
    # case → (loss, mse_target)
    "softmax": ("softmax", None),
    "mse_input": ("mse", "input"),
    "mse_labels": ("mse", "labels"),
}


def _case(case, tmp_path):
    """(ref spec layers, loss, params, vels, resident data, resident target,
    shard paths, batch, mse_target, indices)."""
    loss, mse_target = CASES[case]
    if case == "softmax":
        layers, params, vels, data, labels = _mnist_like()
        flat = data.reshape(len(data), -1)
        paths = write_records(str(tmp_path / "s.znr"), flat, labels,
                              shard_size=24)
        return (layers, loss, params, vels, flat, labels, paths, 20,
                "input", np.arange(10, 60))
    layers, params, vels = _ae_spec()
    gen = np.random.default_rng(78)
    clean = gen.standard_normal((48, 25)).astype(np.float32)
    if case == "mse_input":
        paths = write_records(str(tmp_path / "ae.znr"), clean,
                              np.zeros(48, np.int32), shard_size=20)
        return (layers, loss, params, vels, clean, clean, paths, 16,
                mse_target, np.arange(48))
    noisy = clean + (gen.standard_normal((48, 25)) * 0.3).astype(np.float32)
    paths = write_records(str(tmp_path / "dn.znr"), noisy, clean,
                          shard_size=24)
    return (layers, loss, params, vels, noisy, clean, paths, 16,
            mse_target, np.arange(48))


@pytest.mark.parametrize("planned", [False, True])
@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_trainer_bitwise_vs_resident(tmp_path, direct, case, accum,
                                            planned):
    (layers, loss, params, vels, data, target, paths, batch, mse_target,
     idx) = _case(case, tmp_path)
    spec, pp, pv = _port(layers, loss, params, vels)
    res = FusedTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       accum_steps=accum)
    st = StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       loader=_loader(paths, batch), accum_steps=accum,
                       mse_target=mse_target, prefetch_depth=1)
    if planned:
        res.uncaptured_reason = st.uncaptured_reason = None
    d, t = torch.from_numpy(data), torch.from_numpy(target)
    for ep in range(2):
        rm = res.train_epoch(d, t, idx, batch, epoch=ep,
                             lr_scale=np.float32(0.9) ** ep)
        sm = st.train_epoch(None, None, idx, batch, epoch=ep,
                            lr_scale=np.float32(0.9) ** ep)
        for k in rm:
            np.testing.assert_array_equal(rm[k], sm[k])
    re_, se = res.eval_epoch(d, t, idx, batch), st.eval_epoch(None, None,
                                                              idx, batch)
    np.testing.assert_array_equal(re_["loss"], se["loss"])
    assert _eq(res.params, st.params) and _eq(res.vels, st.vels)
    # the label block is never read where the input is the target
    assert st.stream_stats["batches"] == 3 * -(-len(idx) // batch)


@pytest.mark.parametrize("accum", [1, 2])
@pytest.mark.parametrize("case", sorted(CASES))
def test_stream_trainer_equals_the_references(tmp_path, case, accum):
    (layers, loss, params, vels, data, target, paths, batch, mse_target,
     idx) = _case(case, tmp_path)
    ref_spec = ref_fused.ModelSpec(layers, loss)
    ref_ld = RefRecordLoader(RefWorkflow(name="w"), train_paths=paths,
                             minibatch_size=batch)
    ref_ld.initialize(NumpyDevice())
    cp = lambda t: [tuple(np.array(a) for a in p) for p in t]  # noqa: E731
    ref = RefStreamTrainer(spec=ref_spec, params=cp(params), vels=cp(vels),
                           loader=ref_ld, accum_steps=accum,
                           mse_target=mse_target)
    spec, pp, pv = _port(layers, loss, params, vels)
    st = StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       loader=_loader(paths, batch), accum_steps=accum,
                       mse_target=mse_target)
    for ep in range(2):
        want = ref.train_epoch(None, None, idx, batch, epoch=ep)
        got = st.train_epoch(None, None, idx, batch, epoch=ep)
        np.testing.assert_allclose(got["loss"], want["loss"], rtol=1e-5)
        np.testing.assert_array_equal(got["n_err"], want["n_err"])
    for (gw, gb), (ww, wb) in zip(st.params, ref.params):
        np.testing.assert_allclose(gw.numpy(), np.asarray(ww), rtol=0,
                                   atol=1e-5)
        np.testing.assert_allclose(gb.numpy(), np.asarray(wb), rtol=0,
                                   atol=1e-5)


def test_stream_trainer_refusals(tmp_path):
    from znicz_tpu_torch.loader import RandomCropFlip
    with pytest.raises(ValueError, match="on the StreamingLoader"):
        StreamTrainer(augment=RandomCropFlip((4, 4)))
    layers, params, vels = _ae_spec()
    spec, pp, pv = _port(layers, "mse", params, vels)
    with pytest.raises(TypeError, match="StreamingLoader"):
        StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu")
    ld = _loader(write_records(str(tmp_path / "p.znr"),
                               np.zeros((8, 25), np.float32),
                               np.zeros(8, np.int32)), 4)
    with pytest.raises(ValueError, match="augment policy"):
        StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                      loader=ld, device_augment=True)
    with pytest.raises(ValueError, match="mse_target"):
        StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                      loader=ld, mse_target="both")


def test_step_callback_sees_every_train_step(tmp_path):
    layers, params, vels, data, labels = _mnist_like()
    spec, pp, pv = _port(layers, "softmax", params, vels)
    paths = write_records(str(tmp_path / "c.znr"),
                          data.reshape(len(data), -1), labels)
    seen = []
    st = StreamTrainer(spec=spec, params=pp, vels=pv, device="cpu",
                       loader=_loader(paths, 20),
                       step_callback=lambda e, s: seen.append((e, s)))
    st.train_epoch(None, None, np.arange(10, 60), 20, epoch=3)
    st.eval_epoch(None, None, np.arange(10), 20)
    assert seen == [(3, 0), (3, 1), (3, 2)]


# -- run_fused and the unit graph over shards ---------------------------------
def test_run_fused_routes_to_the_stream_trainer(tmp_path):
    """StandardWorkflow.run_fused over a RecordLoader trains a
    StreamTrainer, epoch for epoch as the reference's run_fused."""
    from znicz_tpu.backends import Device as RefDevice
    from znicz_tpu.standard_workflow import StandardWorkflow as RefSW
    from znicz_tpu_torch.standard_workflow import StandardWorkflow

    data, labels = _dataset(n=80, shape=(5, 5, 1), classes=4, seed=3)
    tr = write_records(str(tmp_path / "tr.znr"), data[20:], labels[20:],
                       shard_size=32)
    va = write_records(str(tmp_path / "va.znr"), data[:20], labels[:20])
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 12},
               "<-": {"learning_rate": 0.05}},
              {"type": "softmax", "->": {"output_sample_shape": 4},
               "<-": {"learning_rate": 0.05}}]
    decision = {"max_epochs": 3, "fail_iterations": 10}
    ref_prng.seed_all(9)
    ref = RefSW(None, "swf", layers=layers, decision_config=decision,
                loader=RefRecordLoader(None, train_paths=tr,
                                       validation_paths=va,
                                       minibatch_size=16))
    ref.initialize(device=RefDevice.create("xla"))
    ref.run_fused()
    prng.seed_all(9)
    wf = StandardWorkflow("swf", layers=layers, decision_config=decision,
                          loader=RecordLoader(None, train_paths=tr,
                                              validation_paths=va,
                                              minibatch_size=16))
    wf.initialize(device="cpu")
    trainer = wf.run_fused()
    assert type(trainer) is StreamTrainer and trainer.mse_target == "input"
    got, want = wf.decision.epoch_metrics, ref.decision.epoch_metrics
    assert len(got) == len(want) == 3
    for g, w in zip(got, want):
        for k in ("train_loss", "validation_loss"):
            np.testing.assert_allclose(g[k], w[k], rtol=1e-5)
        for k in ("train_n_err", "validation_n_err"):
            assert g[k] == w[k]
    assert got[-1]["train_loss"] < got[0]["train_loss"]
    # written back into the unit graph's weights
    np.testing.assert_allclose(wf.forwards[0].weights.mem,
                               ref.forwards[0].weights.mem, rtol=0,
                               atol=1e-5)


def test_run_fused_infers_the_mse_target(tmp_path):
    from znicz_tpu_torch.standard_workflow import StandardWorkflow
    gen = np.random.default_rng(4)
    noisy = gen.standard_normal((40, 9)).astype(np.float32)
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 4},
               "<-": {"learning_rate": 0.01}},
              {"type": "all2all", "->": {"output_sample_shape": 9},
               "<-": {"learning_rate": 0.01}}]
    for labels, want in ((noisy * 0.5, "labels"),
                         (np.zeros(40, np.int32), "input")):
        paths = write_records(str(tmp_path / f"{want}.znr"), noisy, labels)
        prng.seed_all(5)
        wf = StandardWorkflow("ae", layers=layers, loss_function="mse",
                              decision_config={"max_epochs": 1},
                              loader=RecordLoader(None, train_paths=paths,
                                                  minibatch_size=8))
        wf.initialize(device="cpu")
        assert wf.run_fused().mse_target == want


def test_unit_graph_serving_matches_fullbatch(tmp_path):
    """Same seed: the streaming loader serves the full-batch loader's
    minibatches byte for byte (the reference's
    TestRecordLoader::test_unit_graph_serving_matches_fullbatch)."""
    data, labels = _dataset()
    tr = write_records(str(tmp_path / "train.znr"), data[20:], labels[20:],
                       shard_size=20)
    va = write_records(str(tmp_path / "valid.znr"), data[10:20],
                       labels[10:20])
    te = write_records(str(tmp_path / "test.znr"), data[:10], labels[:10])

    class Resident(FullBatchLoader):
        def load_data(self):
            self.original_data = data.copy()
            self.original_labels = labels.copy()
            self.class_lengths = [10, 10, 40]

    prng.seed_all(77)
    ld_s = RecordLoader(Workflow(name="w"), train_paths=tr,
                        validation_paths=va, test_paths=te,
                        minibatch_size=16)
    ld_s.initialize("cpu")
    prng.seed_all(77)
    ld_r = Resident(Workflow(name="w2"), minibatch_size=16)
    ld_r.initialize("cpu")
    for _ in range(5):                  # one epoch: 1 test, 1 valid, 3 train
        ld_s.run()
        ld_r.run()
        assert ld_s.minibatch_class == ld_r.minibatch_class
        assert ld_s.minibatch_size == ld_r.minibatch_size
        n = ld_s.minibatch_size
        np.testing.assert_array_equal(ld_s.minibatch_data.mem[:n],
                                      ld_r.minibatch_data.mem[:n])
        np.testing.assert_array_equal(ld_s.minibatch_labels.mem[:n],
                                      ld_r.minibatch_labels.mem[:n])


@pytest.mark.parametrize("fused", [False, True])
def test_mnist_from_shards_equals_resident(tmp_path, fused):
    """The MNIST sample (shrunk) trained from shards of its own normalized
    data, on the unit graph (fill_minibatch) and on the fused path, equals
    the resident run bit for bit, epoch metrics and weights."""
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import mnist
    from znicz_tpu_torch.standard_workflow import StandardWorkflow

    saved = root.mnist.to_dict()
    layers = [{"type": "all2all_tanh", "->": {"output_sample_shape": 16},
               "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}},
              {"type": "softmax", "->": {"output_sample_shape": 10},
               "<-": {"learning_rate": 0.03, "gradient_moment": 0.9}}]
    root.mnist.update({"minibatch_size": 20})
    root.mnist.synthetic.update({"n_train": 60, "n_valid": 20,
                                 "n_test": 20})
    try:
        prng.seed_all(7)
        res = mnist.MnistWorkflow(layers=layers)
        res.initialize(device="cpu")
        ld = res.loader
        d, lab = ld.original_data.numpy(), ld.original_labels.numpy()
        splits = {}
        for name, (a, b) in (("test", (0, 20)), ("valid", (20, 40)),
                             ("train", (40, 100))):
            splits[name] = write_records(str(tmp_path / f"{name}.znr"),
                                         d[a:b], lab[a:b], shard_size=25)
        res.train(fused=fused, max_epochs=2)
        prng.seed_all(7)
        sw = StandardWorkflow(
            "mnist_shards", layers=layers,
            decision_config=root.mnist.decision.to_dict(),
            loader=RecordLoader(None, train_paths=splits["train"],
                                validation_paths=splits["valid"],
                                test_paths=splits["test"],
                                minibatch_size=20))
        sw.initialize(device="cpu")
        sw.train(fused=fused, max_epochs=2)
    finally:
        root.mnist.update(saved)
    assert sw.decision.epoch_metrics == res.decision.epoch_metrics
    assert _eq(sw.params, res.params)


def test_prefetchers_under_thread_pressure(tmp_path):
    """More consumers than cores, each with its own prefetcher and ring
    over one loader, with the interpreter switching threads every
    microsecond: every minibatch arrives whole, in order, in its slot."""
    import os
    import sys
    import threading

    data, labels = _dataset(n=96, shape=(4, 4, 2))
    ld = _loader(write_records(str(tmp_path / "d.znr"), data, labels,
                               shard_size=20), 8)
    rows = [np.random.default_rng(k).permutation(96).reshape(12, 8)
            for k in range(2 * (os.cpu_count() or 2) + 2)]
    bad = []

    def consume(r):
        st = StagingRing("cpu", 2, 8, ld.sample_shape, ld.label_shape,
                         ld.label_dtype, dest=True)
        for i, (x, t) in enumerate(BatchPrefetcher(ld, r, depth=1,
                                                   device="cpu", ring=st)):
            if not (np.array_equal(x.numpy(), data[r[i]])
                    and np.array_equal(t.numpy(), labels[r[i]])):
                bad.append(i)

    prev = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=consume, args=(r,))
                   for r in rows]
        for th in threads:
            th.start()
        for th in threads:
            th.join(timeout=60)
        assert not any(th.is_alive() for th in threads)
    finally:
        sys.setswitchinterval(prev)
    assert not bad
