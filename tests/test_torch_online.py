"""The port's live-data loop (``znicz_tpu_torch.online``) against the JAX
package's (``znicz_tpu.online``), on the CPU:

- capture: the same record bytes as the reference's ``encode_record``; a
  ring written by each package reads in the other; the byte budget,
  restart append, seeded sampling, torn tail and fail-open behaviour
  under the injected ``capture.append`` fault as tests/test_online.py
  pins them, with the same counts in both packages;
- replay: the same shuffled window under a seed as the reference's
  ``ReplayReader`` on the same ring, and the same ``ReplayLoader``
  hold-back split and minibatches;
- the online trainer: on the same ring and seed, the same round outcomes
  (starved / blessed / refused) as the reference's ``OnlineTrainer``,
  eval losses and final parameters within rtol 1e-4 / atol 1e-5 (the
  streams are such that no bless decision sits within 10× of that
  tolerance of its bar); a refused round restores the blessed parameters
  into the same tensors; the plan-fed path (the card's, its graph replays
  run eagerly here) captures one train and one eval graph for the
  trainer's life; candidates cross ``read_znn`` both ways;
- the online SOM: bit-identical to the reference's ``OnlineSom``;
- ``online-train``: exit codes and outputs as the reference's."""

import json
import os
import time

import numpy as np
import pytest
import torch

from znicz_tpu import durability as ref_durability
from znicz_tpu.backends import Device
from znicz_tpu.export import read_znn as ref_read_znn
from znicz_tpu.online import capture as ref_capture
from znicz_tpu.online import cli as ref_cli
from znicz_tpu.online import replay as ref_replay
from znicz_tpu.online import som as ref_som
from znicz_tpu.online import trainer as ref_trainer
from znicz_tpu.resilience import faults as ref_faults
from znicz_tpu_torch import durability
from znicz_tpu_torch.export import read_znn
from znicz_tpu_torch.online import capture, replay, som, trainer
from znicz_tpu_torch.online import cli as port_cli
from znicz_tpu_torch.ops import kohonen as som_ops
from znicz_tpu_torch.parallel import capture as step_capture
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.serving.zoo import write_demo_model

RTOL, ATOL = 1e-4, 1e-5
PKGS = {"port": (capture, replay, faults),
        "ref": (ref_capture, ref_replay, ref_faults)}

#: a fixed 13->3 logit rule so captured "served outputs" carry LEARNABLE
#: chosen labels (argmax) — random labels would (rightly) refuse
_RULE = np.linspace(-1.0, 1.0, 13 * 3).reshape(13, 3).astype(np.float32)


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _rows(n, seed, features=13):
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(n):
        x = rng.standard_normal((1, features)).astype(np.float32)
        y = (x[:, :13] @ _RULE if features >= 13
             else np.tile(x.sum(axis=1, keepdims=True), (1, 3)))
        out.append((x, y.astype(np.float32)))
    return out


def _fill(log, n, seed=0, model=None, features=13):
    for x, y in _rows(n, seed, features):
        log.append(x, y, model=model)
    assert log.flush(20.0), "capture writer did not settle"


# -- capture -----------------------------------------------------------------
@pytest.mark.parametrize("model,xs,ys", [
    (None, (1, 13), (1, 3)), ("wine", (4, 13), (4, 3)),
    ("m" * 255, (2, 28, 28, 1), (2, 10)), ("ü", (3,), (3,))])
def test_record_bytes_equal_the_reference(model, xs, ys):
    rng = np.random.default_rng(len(xs))
    x = rng.standard_normal(xs).astype(np.float32)
    y = rng.standard_normal(ys).astype(np.float64)       # cast on encode
    blob = capture.encode_record(model, x, y)
    assert blob == ref_capture.encode_record(model, x, y)
    head = capture.REC_HEADER.size
    for mod in (capture, ref_capture):
        rec = mod.decode_payload(blob[head:])
        assert rec.model == model
        np.testing.assert_array_equal(rec.x, x)
        np.testing.assert_array_equal(rec.y, y.astype(np.float32))
    with pytest.raises(ValueError, match="too long"):
        capture.encode_record("m" * 256, x, y)


@pytest.mark.parametrize("writer", ["port", "ref"])
def test_a_ring_reads_in_both_packages(writer, tmp_path):
    cap_mod = PKGS[writer][0]
    log = cap_mod.CaptureLog(str(tmp_path), max_bytes=65536,
                             segment_bytes=900)
    _fill(log, 12, seed=1, model="wine")
    _fill(log, 3, seed=2)
    log.close()
    got = {}
    for name, (mod, _r, _f) in PKGS.items():
        segs = mod.segment_files(str(tmp_path))
        recs, stats = [], []
        for seg in segs:
            r, off, status = mod.read_records(seg)
            recs += [(c.model, c.x.tobytes(), c.y.tobytes()) for c in r]
            stats.append((os.path.basename(seg), off, status))
        got[name] = (recs, stats)
    assert got["port"] == got["ref"]
    assert len(got["port"][0]) == 15 and len(got["port"][1]) > 1


def _ring_case(case, mod, faults_mod, tmp_path):
    """One of tests/test_online.py's ring cases; what it observed."""
    if case == "budget":
        log = mod.CaptureLog(str(tmp_path), max_bytes=8192,
                             segment_bytes=1024)
        _fill(log, 200, seed=1)
        m = log.metrics()
        disk = sum(os.path.getsize(p)
                   for p in mod.segment_files(str(tmp_path)))
        log.close()
        assert m["bytes"] <= 8192 and disk <= 8192
        assert m["segments_deleted"] > 0
        return {k: m[k] for k in ("records", "bytes", "segments",
                                  "segments_deleted")}, disk
    if case == "restart":
        log = mod.CaptureLog(str(tmp_path), max_bytes=65536)
        _fill(log, 5, seed=2)
        log.close()
        first = [os.path.basename(p)
                 for p in mod.segment_files(str(tmp_path))]
        log2 = mod.CaptureLog(str(tmp_path), max_bytes=65536)
        _fill(log2, 5, seed=3)
        log2.close()
        return first, [os.path.basename(p)
                       for p in mod.segment_files(str(tmp_path))]
    if case == "fail_open":
        log = mod.CaptureLog(str(tmp_path), max_bytes=65536)
        plan = faults_mod.FaultPlan([faults_mod.FaultSpec(
            "capture.append", times=3, message="test: tap failure")], seed=1)
        x = np.ones((1, 4), np.float32)
        with plan:
            results = [log.append(x, x) for _ in range(5)]
        snap = plan.snapshot()["capture.append:error"]
        assert log.flush(10.0)
        m = log.metrics()
        log.close()
        return results, snap, m["dropped_error"], m["records"]
    if case == "sampling":
        out = []
        for run in range(2):
            log = mod.CaptureLog(str(tmp_path / f"s{run}"),
                                 max_bytes=65536, sample=0.5, seed=9)
            _fill(log, 40, seed=4)
            m = log.metrics()
            out.append((m["records"], m["dropped_sampled"]))
            log.close()
        assert out[0] == out[1] and 0 < out[0][0] < 40
        return out
    if case == "torn":
        log = mod.CaptureLog(str(tmp_path), max_bytes=65536)
        _fill(log, 6, seed=5)
        log.close()
        (seg,) = mod.segment_files(str(tmp_path))
        blob = open(seg, "rb").read()
        open(seg, "wb").write(blob + blob[:mod.REC_HEADER.size + 4])
        recs, off, status = mod.read_records(seg)
        partial = (len(recs), off == len(blob), status)
        rotten = bytearray(blob)
        rotten[mod.REC_HEADER.size + 3] ^= 0xFF
        open(seg, "wb").write(bytes(rotten))
        recs, off, status = mod.read_records(seg)
        return partial, (len(recs), off, status)
    raise ValueError(case)


@pytest.mark.parametrize("case", ["budget", "restart", "fail_open",
                                  "sampling", "torn"])
def test_ring_behaviour_equals_the_reference(case, tmp_path):
    got = {}
    for name, (mod, _r, faults_mod) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _ring_case(case, mod, faults_mod, d)
    assert got["port"] == got["ref"]
    if case == "fail_open":
        assert got["port"] == ([False, False, False, True, True], 3, 3, 2)
    if case == "torn":
        assert got["port"] == ((6, True, "partial"), (0, 0, "torn"))


def test_stale_partial_tail_is_written_off_as_the_reference(tmp_path):
    log = capture.CaptureLog(str(tmp_path), max_bytes=65536,
                             segment_bytes=600)
    _fill(log, 12, seed=6)
    log.close()
    segs = capture.segment_files(str(tmp_path))
    assert len(segs) >= 2
    blob = open(segs[0], "rb").read()
    open(segs[0], "wb").write(blob[:len(blob) - 3])
    got = {}
    for name, (_c, rep, _f) in PKGS.items():
        reader = rep.ReplayReader(str(tmp_path), seed=0)
        reader.poll()
        got[name] = reader.status()
    assert got["port"] == got["ref"]
    assert got["port"]["torn"] == 1 and got["port"]["pending"] == 11


# -- replay ------------------------------------------------------------------
def test_replay_window_equals_the_reference_under_a_seed(tmp_path):
    log = capture.CaptureLog(str(tmp_path), max_bytes=262144)
    _fill(log, 60, seed=7)
    log.close()

    def draw(rep, seed, window=4096):
        r = rep.ReplayReader(str(tmp_path), seed=seed, window=window)
        out = [[rec.x.tobytes() for rec in r.take(10, timeout_s=0.0)]
               for _ in range(4)]
        return out, r.status()
    for seed, window in ((5, 4096), (6, 4096), (5, 25)):
        assert draw(replay, seed, window) == draw(ref_replay, seed, window)
    assert draw(replay, 5)[0] != draw(replay, 6)[0]
    assert draw(replay, 5, 25)[1]["dropped"] == 35


def test_cold_log_and_live_appends(tmp_path):
    reader = replay.ReplayReader(str(tmp_path / "nothing"), seed=0)
    t0 = time.monotonic()
    assert reader.take(32, timeout_s=0.3) == []
    assert time.monotonic() - t0 < 5.0
    log = capture.CaptureLog(str(tmp_path / "live"), max_bytes=262144)
    try:
        _fill(log, 8, seed=8)
        readers = [rep.ReplayReader(str(tmp_path / "live"), seed=0)
                   for rep in (replay, ref_replay)]
        assert [r.poll() for r in readers] == [8, 8]
        _fill(log, 5, seed=9)
        assert [r.poll() for r in readers] == [5, 5]
    finally:
        log.close()


def test_replay_loader_equals_the_reference(tmp_path):
    log = capture.CaptureLog(str(tmp_path), max_bytes=262144)
    _fill(log, 32, seed=11)
    log.close()
    port = replay.ReplayLoader(str(tmp_path), minibatch_size=8,
                               holdback_every=4, seed=0)
    port.initialize(device="cpu")
    ref = ref_replay.ReplayLoader(str(tmp_path), minibatch_size=8,
                                  holdback_every=4, seed=0)
    ref.initialize(device=Device.create("numpy"))
    assert port.class_lengths == ref.class_lengths == [0, 8, 24]
    idx = np.arange(32)
    for a, b in zip(port.read_batch(idx), ref.read_batch(idx)):
        np.testing.assert_array_equal(a, b)
    port.run()
    assert tuple(port.minibatch_data.mem.shape[1:]) == (13,)
    assert port.minibatch_labels.mem.dtype == np.int32
    with pytest.raises(ValueError, match="holdback_every"):
        replay.ReplayLoader(str(tmp_path), holdback_every=1)
    empty = replay.ReplayLoader(str(tmp_path / "cold"))
    with pytest.raises(ValueError, match="cold log"):
        empty.initialize(device="cpu")


def test_records_to_arrays_equals_the_reference():
    recs = [capture.CaptureRecord(None, np.ones((2, 3), np.float32),
                                  np.zeros((2, 4), np.float32)),
            capture.CaptureRecord(None, np.full(3, 2.0, np.float32),
                                  np.ones((1, 4), np.float32))]
    for a, b in zip(replay.records_to_arrays(recs),
                    ref_replay.records_to_arrays(recs)):
        np.testing.assert_array_equal(a, b)
    assert [a.shape for a in replay.records_to_arrays([])] == [(0, 0)] * 2


# -- the online trainer ------------------------------------------------------
@pytest.fixture(scope="module")
def wine_znn(tmp_path_factory):
    path = tmp_path_factory.mktemp("online_model") / "wine.znn"
    write_demo_model(str(path), "wine", seed=7)
    return str(path)


class _Direct:
    """Stands in for a captured graph on the CPU: the capture runs the
    step once, a replay runs it again (tests/test_torch_accum.py)."""

    def __init__(self, fn):
        self.fn = fn

    def replay(self):
        self.fn()


@pytest.fixture
def direct(monkeypatch):
    def fake(plan, fn):
        fn()
        return _Direct(fn)
    monkeypatch.setattr(step_capture.StepPlan, "capture", fake)


#: the rounds both trainers run: (records appended before, poisoned)
ROUNDS = [(0, False), (80, False), (80, True), (70, False), (60, False)]


def _drive(tr, capdir, fill_mod):
    log = fill_mod.CaptureLog(capdir, max_bytes=1 << 20)
    outs = []
    try:
        for i, (n, poison) in enumerate(ROUNDS):
            if n:
                _fill(log, n, seed=20 + i)
            outs.append(tr.run_round(poison_labels=poison))
    finally:
        log.close()
    return outs


def _params(tr):
    return [tuple(None if t is None else np.asarray(t.cpu() if
                                                    isinstance(t,
                                                               torch.Tensor)
                                                    else t)
                  for t in pair) for pair in tr.trainer.params]


def _trainer(mod, model, tmp_path, **kw):
    return mod.OnlineTrainer(
        model, str(tmp_path / "cap"), candidates_dir=str(tmp_path / "c"),
        checkpoint_dir=str(tmp_path / "ck"), round_samples=64,
        min_round_samples=16, holdback_every=8, poll_timeout_s=0.2,
        seed=3, **kw)


@pytest.mark.parametrize("planned", [False, True])
def test_rounds_equal_the_reference_trainer(planned, wine_znn, tmp_path,
                                            request):
    """The same ring and seed through both trainers: the same outcomes,
    eval losses and final parameters; on the plan-fed path one train and
    one eval graph serve every round, refusals included."""
    if planned:
        request.getfixturevalue("direct")
    (tmp_path / "ref").mkdir()
    (tmp_path / "port").mkdir()
    ref_tr = _trainer(ref_trainer, wine_znn, tmp_path / "ref")
    port_tr = _trainer(trainer, wine_znn, tmp_path / "port", device="cpu")
    if planned:
        port_tr.trainer.uncaptured_reason = None   # the card's path, here
    try:
        want = _drive(ref_tr, str(tmp_path / "ref" / "cap"), ref_capture)
        ptrs = [t.data_ptr() for pair in port_tr.trainer.params
                for t in pair if t is not None]
        got = _drive(port_tr, str(tmp_path / "port" / "cap"), capture)
        assert [t.data_ptr() for pair in port_tr.trainer.params
                for t in pair if t is not None] == ptrs
    finally:
        ref_tr.close()
        port_tr.close()
    assert [o["outcome"] for o in got] == [o["outcome"] for o in want] == [
        "starved", "blessed", "refused", "blessed", "blessed"]
    for g, w in zip(got, want):
        assert {k: v for k, v in g.items()
                if k not in trainer.PORT_KEYS and "loss" not in k
                and k not in ("candidate", "checkpoint", "why")} \
            == {k: v for k, v in w.items()
                if "loss" not in k
                and k not in ("candidate", "checkpoint", "why")}
        for k in ("eval_loss", "blessed_loss"):
            if k in w and w[k] is not None:
                np.testing.assert_allclose(g[k], w[k], rtol=RTOL, atol=ATOL)
                bar = w["blessed_loss"] * (1 + 0.10) + 1e-4
                # the decision is not a near tie at the test's tolerance
                assert abs(w["eval_loss"] - bar) > 10 * (RTOL * bar + ATOL)
    for gp, wp in zip(_params(port_tr), _params(ref_tr)):
        for a, b in zip(gp, wp):
            assert (a is None) == (b is None)
            if a is not None:
                np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    st = port_tr.status()
    want_st = ref_tr.status()
    assert {k: v for k, v in st.items() if k not in trainer.PORT_KEYS
            and "loss" not in k} == {k: v for k, v in want_st.items()
                                     if "loss" not in k}
    assert st["train_steps"] == sum(o.get("train_steps", 0) for o in got)
    assert st["eval_steps"] == 8                   # two a judged round
    assert st["graphs"] == (2 if planned else 0)
    if planned:
        assert len(port_tr.trainer._plans) == 2


def test_refused_round_restores_in_place_and_exports_cross(wine_znn,
                                                            tmp_path):
    capdir = tmp_path / "cap"
    log = capture.CaptureLog(str(capdir), max_bytes=262144)
    tr = trainer.OnlineTrainer(
        wine_znn, str(capdir), candidates_dir=str(tmp_path / "c"),
        checkpoint_dir=str(tmp_path / "ck"), round_samples=64,
        min_round_samples=16, poll_timeout_s=0.2, seed=3, device="cpu")
    try:
        _fill(log, 80, seed=12)
        out = tr.run_round()
        assert out["outcome"] == "blessed"
        cand = out["candidate"]
        assert durability.read_manifest(cand) is not None
        ref_durability.verify(cand)
        mine, theirs = read_znn(cand), ref_read_znn(cand)
        assert [la.kind for la in theirs] == ["fc", "fc", "softmax"]
        for a, b in zip(mine, theirs):
            np.testing.assert_array_equal(a.w, b.w)
        tensors = [t for pair in tr.trainer.params for t in pair]
        _fill(log, 80, seed=13)
        n_cands = len(os.listdir(tmp_path / "c"))
        out = tr.run_round(poison_labels=True)
        assert out["outcome"] == "refused"
        assert len(os.listdir(tmp_path / "c")) == n_cands
        assert [t for pair in tr.trainer.params for t in pair] == tensors
        for pair, (bpair, _v) in zip(tr.trainer.params, tr._blessed):
            for t, bt in zip(pair, bpair):
                assert (t is None) == (bt is None)
                if t is not None:
                    torch.testing.assert_close(t, bt, rtol=0, atol=0)
        # the reference's spec_from_znn reads the port's candidate, and
        # the reference's candidate reads in the port
        spec, params, _vels = ref_trainer.spec_from_znn(cand)
        np.testing.assert_array_equal(params[0][0], mine[0].w)
        ref_cand = str(tmp_path / "ref.znn")
        ref_trainer.export_fc_znn(spec, params, ref_cand)
        pspec, pparams, pvels = trainer.spec_from_znn(ref_cand)
        assert pspec.loss == "softmax" and len(pspec.layers) == 2
        np.testing.assert_array_equal(pparams[1][0], params[1][0])
        assert all(np.all(v == 0) for v, _b in pvels)
        # CheckpointSource picks up the blessed step through the trainer's
        # exporter: the exported step IS the blessed params, bit for bit
        from znicz_tpu_torch.promotion.sources import CheckpointSource
        src = CheckpointSource(str(tmp_path / "ck"), tr.checkpoint_exporter)
        candidate, skipped = src.poll()
        assert candidate.name == f"step-{tr.step}" and skipped == []
        dst = tmp_path / "exported.znn"
        src.materialize(candidate, str(dst))
        np.testing.assert_array_equal(ref_read_znn(str(dst))[0].w,
                                      tr._blessed[0][0][0].numpy())
    finally:
        log.close()
        tr.close()


def test_warm_start_and_refusals_of_spec_from_znn(wine_znn, tmp_path):
    spec, params, vels = trainer.spec_from_znn(wine_znn)
    rspec, rparams, _rv = ref_trainer.spec_from_znn(wine_znn)
    assert [(la.kind, la.activation, la.include_bias, la.hypers)
            for la in spec.layers] == [
        (la.kind, la.activation, la.include_bias, la.hypers)
        for la in rspec.layers]
    assert spec.loss == rspec.loss == "softmax"
    for (w, b), (rw, rb) in zip(params, rparams):
        np.testing.assert_array_equal(w, rw)
        assert (b is None) == (rb is None)
    som_znn = tmp_path / "som.znn"
    write_demo_model(str(som_znn), "kohonen", seed=7)
    with pytest.raises(ValueError, match="online.som"):
        trainer.spec_from_znn(str(som_znn))
    with pytest.raises(ValueError, match="candidates_dir"):
        trainer.OnlineTrainer(wine_znn, str(tmp_path), device="cpu")


def test_mse_chain_trains_as_the_reference(tmp_path):
    """An fc chain without a softmax head fine-tunes on MSE against the
    served outputs themselves."""
    from znicz_tpu_torch.export import (ACT, KIND, _commit_znn,
                                        _pack_layer, _write_header)
    rng = np.random.default_rng(2)
    path = str(tmp_path / "mse.znn")
    with open(path + ".tmp", "wb") as fh:
        _write_header(fh, 1)
        _pack_layer(fh, KIND["fc"], ACT["linear"], [13, 3],
                    (0.1 * rng.standard_normal((13, 3))).astype(np.float32),
                    np.zeros(3, np.float32))
    _commit_znn(path)
    got = {}
    for name, mod, cap_mod, kw in (("port", trainer, capture,
                                    {"device": "cpu"}),
                                   ("ref", ref_trainer, ref_capture, {})):
        d = tmp_path / name
        d.mkdir()
        log = cap_mod.CaptureLog(str(d / "cap"), max_bytes=262144)
        _fill(log, 64, seed=3)
        log.close()
        tr = _trainer(mod, path, d, **kw)
        try:
            out = tr.run_round()
            got[name] = (out["outcome"], out["eval_loss"], _params(tr))
        finally:
            tr.close()
    assert got["port"][0] == got["ref"][0] == "blessed"
    np.testing.assert_allclose(got["port"][1], got["ref"][1], rtol=RTOL,
                               atol=ATOL)
    for a, b in zip(got["port"][2], got["ref"][2]):
        np.testing.assert_allclose(a[0], b[0], rtol=RTOL, atol=ATOL)


# -- the online SOM ----------------------------------------------------------
def test_online_som_is_bit_identical_to_the_reference(tmp_path):
    som_znn = tmp_path / "som.znn"
    write_demo_model(str(som_znn), "kohonen", seed=7)
    port = som.OnlineSom(str(som_znn), str(tmp_path / "cap"),
                         candidates_dir=str(tmp_path / "c1"),
                         learning_rate=0.3, sigma_min=0.5,
                         decay_rounds=10.0, seed=0)
    ref = ref_som.OnlineSom(str(som_znn), str(tmp_path / "cap"),
                            candidates_dir=str(tmp_path / "c2"),
                            learning_rate=0.3, sigma_min=0.5,
                            decay_rounds=10.0, seed=0)
    w_ref = som.read_som_znn(str(som_znn))
    coords = som_ops.grid_coords(*port.grid_shape)
    rng = np.random.default_rng(3)
    for r in range(5):
        batch = rng.standard_normal((16, 6)).astype(np.float32)
        # the batch trainer's numpy step at epoch r
        lr = 0.3 * np.exp(-r / 10.0)
        sigma = max(port.sigma0 * np.exp(-r / 10.0), 0.5)
        w_ref, _diff = som_ops.np_train_step(w_ref, batch, coords, lr,
                                             sigma)
        w_ref = w_ref.astype(np.float32)
        assert port.apply_batch(batch) == ref.apply_batch(batch)
        port.round_no = ref.round_no = r + 1
        np.testing.assert_array_equal(port.weights, w_ref)
        np.testing.assert_array_equal(port.weights, ref.weights)


def test_online_som_rounds_equal_the_reference(tmp_path):
    som_znn = tmp_path / "som.znn"
    write_demo_model(str(som_znn), "kohonen", seed=7)
    capdir = tmp_path / "cap"
    log = capture.CaptureLog(str(capdir), max_bytes=262144)
    rng = np.random.default_rng(5)
    centers = (2.0 * rng.standard_normal((4, 6))).astype(np.float32)
    for i in range(240):
        x = (centers[i % 4] + 0.1 * rng.standard_normal(6)).astype(
            np.float32)[None]
        log.append(x, -x)
    assert log.flush(20.0)
    log.close()
    got = {}
    for name, mod in (("port", som), ("ref", ref_som)):
        s = mod.OnlineSom(str(som_znn), str(capdir),
                          candidates_dir=str(tmp_path / f"c_{name}"),
                          round_samples=64, min_round_samples=16,
                          poll_timeout_s=0.5, seed=1)
        outs = [s.run_round() for _ in range(4)]
        got[name] = (outs, s.weights, s.status())
    for g, w in zip(got["port"][0], got["ref"][0]):
        assert g.pop("candidate", "").replace("c_port", "") \
            == w.pop("candidate", "").replace("c_ref", "")
        assert g == w
    np.testing.assert_array_equal(got["port"][1], got["ref"][1])
    assert got["port"][2] == got["ref"][2]
    assert got["port"][0][0]["outcome"] == "blessed"
    cand = str(tmp_path / "c_port" / "som-000001.znn")
    np.testing.assert_array_equal(som.read_som_znn(cand),
                                  ref_som.read_som_znn(cand))
    with pytest.raises(ValueError, match="kohonen-head"):
        som.read_som_znn(_wine(tmp_path))


def _wine(tmp_path):
    path = str(tmp_path / "wine_for_som.znn")
    write_demo_model(path, "wine", seed=7)
    return path


# -- the CLI -----------------------------------------------------------------
def _cli(main, args, capsys):
    rc = main(args)
    lines = [json.loads(line) for line in capsys.readouterr().out
             .splitlines()[1:]]
    return rc, lines


def test_online_train_cli_equals_the_reference(tmp_path, wine_znn, capsys):
    got = {}
    for name, main, cap_mod, extra in (
            ("port", port_cli.main, capture, ["--device", "cpu"]),
            ("ref", ref_cli.main, ref_capture, [])):
        d = tmp_path / name
        log = cap_mod.CaptureLog(str(d / "cap"), max_bytes=262144)
        _fill(log, 60, seed=14)
        log.close()
        rc, lines = _cli(main, ["--model", wine_znn,
                                "--capture-dir", str(d / "cap"),
                                "--candidates", str(d / "cands"),
                                "--rounds", "1", "--round-samples", "48",
                                "--min-round-samples", "16",
                                "--poll-timeout-s", "1", *extra], capsys)
        starved = _cli(main, ["--model", wine_znn,
                              "--capture-dir", str(d / "empty"),
                              "--candidates", str(d / "cands2"),
                              "--rounds", "1", "--poll-timeout-s", "0.1",
                              "--idle-wait-s", "0.1", "--max-starved", "2",
                              *extra], capsys)
        with pytest.raises(SystemExit) as e:
            main(["--model", wine_znn, "--capture-dir", str(d)])
        capsys.readouterr()
        got[name] = (rc, lines, starved, e.value.code,
                     sorted(os.listdir(d / "cands")))
    port, ref = got["port"], got["ref"]
    assert port[0] == ref[0] == 0 and port[3] == ref[3] == 2
    assert port[4] == ref[4] and any(n.endswith(".znn") for n in port[4])
    strip = [[{k: ({a: b for a, b in v.items() if a not in trainer.PORT_KEYS}
                   if k == "final" else v) for k, v in line.items()}
              for line in got_[2][1]] for got_ in (port, ref)]
    assert port[2][0] == ref[2][0] == 2 and strip[0] == strip[1]
    (p_round, p_final), (r_round, r_final) = port[1], ref[1]
    assert p_round["outcome"] == r_round["outcome"] == "blessed"
    assert {k for k in p_round if k not in trainer.PORT_KEYS} == set(r_round)
    np.testing.assert_allclose(p_round["eval_loss"], r_round["eval_loss"],
                               rtol=RTOL, atol=ATOL)
    assert {k for k in p_final["final"]
            if k not in trainer.PORT_KEYS} == set(r_final["final"])


def test_online_train_cli_som_mode_equals_the_reference(tmp_path, capsys):
    som_znn = str(tmp_path / "som.znn")
    write_demo_model(som_znn, "kohonen", seed=7)
    log = capture.CaptureLog(str(tmp_path / "cap"), max_bytes=262144)
    _fill(log, 60, seed=15, features=6)
    log.close()
    got = {}
    for name, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        rc, lines = _cli(main, ["--model", som_znn, "--capture-dir",
                                str(tmp_path / "cap"), "--candidates",
                                str(tmp_path / f"c_{name}"), "--rounds",
                                "1", "--round-samples", "32",
                                "--min-round-samples", "8",
                                "--poll-timeout-s", "0.5"], capsys)
        for line in lines:
            line.pop("candidate", None)
        got[name] = (rc, lines)
        with pytest.raises(SystemExit) as e:
            main(["--model", som_znn, "--capture-dir", str(tmp_path)])
        capsys.readouterr()
        assert e.value.code == 2
    assert got["port"] == got["ref"]
    assert got["port"][1][0]["outcome"] == "blessed"


def test_online_train_runs_from_the_ports_main(tmp_path, wine_znn, capsys):
    from znicz_tpu_torch.__main__ import main as port_main
    rc = port_main(["online-train", "--model", wine_znn, "--capture-dir",
                    str(tmp_path / "empty"), "--candidates",
                    str(tmp_path / "c"), "--rounds", "1",
                    "--poll-timeout-s", "0.05", "--idle-wait-s", "0.05",
                    "--max-starved", "1", "--device", "cpu"])
    assert rc == 2
    assert "online-train [fc-fine-tune]" in capsys.readouterr().out


def test_serve_capture_dir_taps_every_served_answer(tmp_path, wine_znn):
    """``serve --capture-dir``: each served /predict lands in the ring as
    (input, answer), read alike by both packages; the ring survives the
    process, and a restart appends after it."""
    import re
    import signal
    import subprocess
    import sys
    import urllib.request
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    capdir = tmp_path / "cap"
    rows = np.random.default_rng(3).standard_normal((4, 13)).astype(
        np.float32)
    answers = []
    for run in range(2):
        p = subprocess.Popen(
            [sys.executable, "-m", "znicz_tpu_torch", "serve", "--model",
             wine_znn, "--backend", "cpu", "--port", "0", "--capture-dir",
             str(capdir), "--capture-mb", "1"],
            stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True,
            cwd=repo, env=dict(os.environ, PYTHONPATH=repo,
                               OMP_NUM_THREADS="2"))
        try:
            first = p.stdout.readline()
            assert first.startswith("capturing served traffic into"), first
            url = re.search(r"at (http://[\d.]+:\d+/)",
                            p.stdout.readline()).group(1)
            for x in rows[2 * run:2 * run + 2]:
                req = urllib.request.Request(
                    url + "predict",
                    json.dumps({"inputs": x[None].tolist()}).encode(),
                    {"Content-Type": "application/json"})
                with urllib.request.urlopen(req, timeout=60) as r:
                    answers.append(json.loads(r.read())["outputs"])
        finally:
            p.send_signal(signal.SIGTERM)
            out, err = p.communicate(timeout=60)
        assert p.returncode == 0, err
    segs = capture.segment_files(str(capdir))
    assert len(segs) == 2                # one segment a process
    for mod in (capture, ref_capture):
        recs = [r for seg in segs for r in mod.read_records(seg)[0]]
        assert len(recs) == 4
        for rec, x, y in zip(recs, rows, answers):
            assert rec.model is None
            np.testing.assert_array_equal(rec.x, x[None])
            np.testing.assert_allclose(rec.y, np.asarray(y, np.float32),
                                       rtol=1e-6)
