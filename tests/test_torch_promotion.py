"""The port's promotion controller (``znicz_tpu_torch.promotion``) against
the JAX package's (``znicz_tpu.promotion``), on the CPU:

- the SLO math and the sample builders: the same quantiles, breaches and
  parsed samples, exactly, for the same inputs (``SLOPolicy``,
  ``BurnRatePolicy``, ``delta_quantile``, ``registry_sample``,
  ``parse_prometheus``, ``prometheus_sample``, ``count_breach``);
- the ledger: a ledger written by either package replays to the same
  ``LedgerReplay`` in both, a torn tail skipped;
- the sources: the same candidate order and resume over one directory,
  and over the port's ``TrainerCheckpointer`` steps;
- the controller's state machine with a scripted target, case for case
  with ``tests/test_promotion.py``: the same outcomes and ledger events;
- the in-process ``EngineTarget`` rollback under latency injected at
  ``engine.forward`` (the old generation answers the same bytes), and
  ``HttpTarget`` driving the port's ``serve`` over ``POST /admin/reload``
  and ``/metrics``, through a 409 + ``Retry-After``;
- ``python -m znicz_tpu_torch promote``: exit codes and outputs as the
  reference's; ``--fleet`` raises naming ROADMAP.md queue 1 item 11."""

import dataclasses
import json
import math
import os
import re
import signal
import subprocess
import sys
import threading
import time
import urllib.error
import urllib.request

import numpy as np
import pytest
import torch

from znicz_tpu import durability as ref_durability
from znicz_tpu import promotion as ref_promotion
from znicz_tpu.promotion import cli as ref_cli
from znicz_tpu.resilience import faults as ref_faults
from znicz_tpu.telemetry import registry as ref_registry
from znicz_tpu_torch import durability, promotion
from znicz_tpu_torch.promotion import cli as port_cli
from znicz_tpu_torch.resilience import faults
from znicz_tpu_torch.serving import ServingEngine, ServingServer
from znicz_tpu_torch.serving.zoo import write_demo_model
from znicz_tpu_torch.telemetry import registry

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
PKGS = {"port": (promotion, durability, faults, registry),
        "ref": (ref_promotion, ref_durability, ref_faults, ref_registry)}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _sample(pkg, buckets, count=None, req=0.0, err=0.0, breaker="closed",
            at=None):
    cum = dict(buckets)
    cum.setdefault(math.inf, max(cum.values()) if cum else 0.0)
    return pkg.SLOSample(at=time.time() if at is None else at,
                         latency_cum=cum,
                         latency_count=(count if count is not None
                                        else cum[math.inf]),
                         requests=req, errors_5xx=err,
                         breaker_state=breaker)


# -- SLO math ----------------------------------------------------------------
#: (start, now) sample arguments: pre-swap traffic cancelled, the overflow
#: bucket, empty deltas, trickles under min_samples, 5xx shares, breakers
SLO_CASES = [
    (({10.0: 0.0, 100.0: 0.0},), ({10.0: 99.0, 100.0: 100.0},)),
    (({10.0: 0.0, 100.0: 0.0},), ({10.0: 90.0, 100.0: 100.0},)),
    (({10.0: 0.0, 100.0: 0.0},),
     ({10.0: 0.0, 100.0: 0.0, math.inf: 50.0},)),
    (({10.0: 0.0, 100.0: 1000.0},), ({10.0: 50.0, 100.0: 1050.0},)),
    (({10.0: 0.0, 100.0: 0.0},), ({10.0: 0.0, 100.0: 0.0},)),
    (({10.0: 0.0, 100.0: 0.0},), ({10.0: 0.0, 100.0: 3.0},)),
    (({10.0: 0.0},), ({10.0: 100.0}, None, 100.0, 5.0)),
    (({10.0: 0.0},), ({10.0: 100.0}, None, 100.0, 0.0)),
    (({},), ({}, None, 0.0, 0.0, "open")),
    (({},), ({}, None, 0.0, 0.0, None)),
    (({10.0: 2.0, 25.0: 4.0}, None, 10.0, 1.0),
     ({10.0: 40.0, 25.0: 60.0, 250.0: 90.0}, None, 80.0, 3.0,
      "half_open")),
]
POLICIES = [dict(max_p99_ms=50.0, min_samples=5),
            dict(max_p99_ms=None, max_error_rate=0.01, min_samples=5),
            dict(max_p99_ms=None, max_error_rate=None),
            dict(max_p99_ms=20.0, max_error_rate=0.02, min_samples=3,
                 quantile=0.5, require_breaker_closed=False)]


@pytest.mark.parametrize("case", range(len(SLO_CASES)))
def test_slo_math_equals_the_reference(case):
    start, now = SLO_CASES[case]
    got = {}
    for name, (pkg, *_rest) in PKGS.items():
        a = _sample(pkg, *start, at=1.0)
        b = _sample(pkg, *now, at=2.0)
        got[name] = ([pkg.delta_quantile(a, b, q) for q in (0.5, 0.9, 0.99)],
                     [pkg.SLOPolicy(**kw).evaluate(a, b)
                      for kw in POLICIES])
    assert got["port"] == got["ref"]


def test_burn_rate_policy_equals_the_reference():
    got = {}
    for name, (pkg, *_rest) in PKGS.items():
        out = []
        for kw in (dict(objective="availability", target=0.99,
                        window_s=10.0, probe_interval_s=1.0,
                        max_burn_rate=2.0, min_samples=5),
                   dict(objective="latency", threshold_ms=25.0,
                        target=0.9, window_s=8.0, probe_interval_s=1.0,
                        fast_window_s=3.0, max_burn_rate=1.5)):
            pol = pkg.BurnRatePolicy(**kw)
            start = _sample(pkg, {10.0: 0.0, 25.0: 0.0, 100.0: 0.0},
                            req=0.0, at=0.0)
            for t in range(1, 9):
                now = _sample(pkg, {10.0: 10.0 * t, 25.0: 12.0 * t,
                                    100.0: 20.0 * t},
                              req=20.0 * t, err=float(t * t) / 2.0,
                              breaker="closed" if t < 7 else "open",
                              at=float(t))
                out.append(pol.evaluate(start, now))
        for bad in (dict(objective="nope"), dict(objective="latency"),
                    dict(target=1.5), dict(window_s=1.0,
                                           fast_window_s=2.0)):
            with pytest.raises(ValueError) as e:
                pkg.BurnRatePolicy(**bad)
            out.append(str(e.value))
        got[name] = out
    assert got["port"] == got["ref"]


def _fill_registry(reg):
    h = reg.histogram("predict_latency_ms", "t", buckets=(10.0, 100.0))
    for v in (5.0, 5.0, 50.0, 500.0):
        h.observe(v)
    reg.counter("requests_total", "t").inc(route="/predict", code="200")
    reg.counter("requests_total").inc(route="/predict", code="503")
    reg.counter("requests_total").inc(route="/metrics", code="200")
    reg.counter("errors_total", "t").inc(route="/predict", code="503")
    reg.counter("errors_total").inc(route="/predict", code="400")
    reg.counter("errors_total").inc(route="/predict", code="junk")


def _fields(s):
    d = dataclasses.asdict(s)
    d.pop("at")
    return d


def test_sample_builders_equal_the_reference():
    got = {}
    for name, (pkg, _d, _f, reg_mod) in PKGS.items():
        reg = reg_mod.MetricsRegistry()
        empty = pkg.registry_sample(registry=reg_mod.MetricsRegistry())
        _fill_registry(reg)
        a = pkg.registry_sample(breaker_state="closed", registry=reg)
        text = reg.render_prometheus()
        b = pkg.prometheus_sample(text)
        enum = pkg.prometheus_sample(
            'breaker_state{state="closed"} 0\n'
            'breaker_state{state="open"} 1\n'
            'x_total{a="q\\"uote"} +Inf\n# HELP junk\n')
        with pytest.raises(ValueError):
            pkg.prometheus_sample("this is { not exposition")
        got[name] = (_fields(empty), _fields(a), _fields(b), _fields(enum),
                     pkg.parse_prometheus(text))
    assert got["port"] == got["ref"]
    _empty, a, b, enum, _parsed = got["port"]
    assert a["latency_cum"] == b["latency_cum"] \
        == {10.0: 2.0, 100.0: 3.0, math.inf: 4.0}
    assert a["requests"] == b["requests"] == 2.0
    assert a["errors_5xx"] == b["errors_5xx"] == 1.0
    assert enum["breaker_state"] == "open"


def test_promotion_families_register_at_import():
    from znicz_tpu_torch.promotion import slo
    text = registry.REGISTRY.render_prometheus()
    for fam in ("promotions_total", "promotion_generation",
                "slo_breaches_total"):
        assert f"# TYPE {fam} " in text, fam
    before = registry.REGISTRY.counter("slo_breaches_total").value(
        slo="error_rate")
    slo.count_breach({"slo": "error_rate", "value": 0.5, "limit": 0.1})
    assert registry.REGISTRY.counter("slo_breaches_total").value(
        slo="error_rate") == before + 1


# -- ledger ------------------------------------------------------------------
LEDGER_SCRIPT = [
    ("candidate", dict(candidate="a.znn", attempt=1)),
    ("outcome", dict(outcome="promoted", candidate="a.znn",
                     deployed="/d/1-a.znn", generation=2)),
    ("candidate", dict(candidate="b.znn", attempt=2, skipped=["z.znn"])),
    ("outcome", dict(outcome="verify_failed", candidate="b.znn")),
    ("attempt_crashed", {}),
    ("candidate", dict(candidate="c.znn", attempt=4)),
    ("outcome", dict(outcome="aborted", candidate="c.znn")),
    ("candidate", dict(candidate="d.znn", attempt=5)),
    ("outcome", dict(outcome="rolled_back", candidate="d.znn",
                     deployed="/d/5-d.znn", generation=4)),
    ("state", dict(state="watching", candidate="d.znn")),
]


@pytest.mark.parametrize("writer", ["port", "ref"])
@pytest.mark.parametrize("torn", [False, True])
def test_ledger_replays_alike_in_both_packages(writer, torn, tmp_path):
    path = str(tmp_path / "l.jsonl")
    led = PKGS[writer][0].PromotionLedger(path)
    for event, fields in LEDGER_SCRIPT:
        led.append(event, **fields)
    if torn:
        with open(path, "a") as fh:
            fh.write('{"ts": 1, "event": "outc')       # crash mid-append
    got = {}
    for name, (pkg, *_rest) in PKGS.items():
        reader = pkg.PromotionLedger(path)
        got[name] = (dataclasses.asdict(reader.replay()),
                     [e["event"] for e in reader.entries()])
    assert got["port"] == got["ref"]
    rep, events = got["port"]
    assert rep["attempted"] == {"a.znn", "b.znn", "c.znn", "d.znn"}
    assert rep["consecutive_failures"] == 3       # verify, crash, rollback
    assert rep["last_promoted_path"] == "/d/1-a.znn"
    assert len(events) == len(LEDGER_SCRIPT)


# -- sources -----------------------------------------------------------------
def _touch(path, mtime):
    with open(path, "wb") as fh:
        fh.write(b"x")
    os.utime(path, (mtime, mtime))


def test_directory_source_order_and_resume_equal_the_reference(tmp_path):
    for name, mtime in (("a.znn", 100), ("b.znn", 200), ("a.znn.tmp", 300),
                        ("a.znn.manifest.json", 300), ("c.znn", 150)):
        _touch(tmp_path / name, mtime)
    got = {}
    for name, (pkg, *_rest) in PKGS.items():
        src = pkg.DirectorySource(str(tmp_path))
        first = src.poll()
        again = src.poll()
        resumed = pkg.DirectorySource(str(tmp_path))
        resumed.resume({"b.znn"})
        got[name] = ((first[0].name, first[1]), again,
                     (resumed.poll()[0].name,))
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("b.znn", ["a.znn", "c.znn"])


def _fc_trainer(device="cpu"):
    from znicz_tpu_torch.parallel import fused
    rng = np.random.default_rng(0)
    hyp = (0.05, 0.0, 0.0, 0.9)
    spec = fused.ModelSpec((fused.LayerSpec("fc", "tanh", True, hyp, hyp),
                            fused.LayerSpec("fc", "linear", True, hyp,
                                            hyp)), "softmax")
    params = [(rng.standard_normal((6, 5)).astype(np.float32),
               rng.standard_normal(5).astype(np.float32)),
              (rng.standard_normal((5, 3)).astype(np.float32),
               rng.standard_normal(3).astype(np.float32))]
    vels = [tuple(np.zeros_like(a) for a in p) for p in params]
    return fused.FusedTrainer(spec=spec, params=params, vels=vels,
                              device=device)


def test_checkpoint_source_over_the_ports_steps(tmp_path):
    from znicz_tpu_torch.parallel.checkpoint import TrainerCheckpointer
    ck = TrainerCheckpointer(str(tmp_path), max_to_keep=None)
    tr = _fc_trainer()
    for step in (1, 3):
        ck.save(tr, step, block=True)
    ck.close()
    # step 5 mid-save: a directory without its manifest
    os.makedirs(tmp_path / "5")
    (tmp_path / "5" / "state.npz").write_bytes(b"")
    got = {}
    for name, (pkg, dur, *_rest) in PKGS.items():
        calls = []
        src = pkg.CheckpointSource(str(tmp_path), exporter=lambda p, d:
                                   calls.append((p, d)))
        first = src.poll()
        second = src.poll()
        dur.write_manifest(str(tmp_path / "5"), kind="checkpoint")
        third = src.poll()
        src.materialize(third[0], "/dev/null")
        resumed = pkg.CheckpointSource(str(tmp_path), exporter=None)
        resumed.resume({"step-3", "junk", "step-x"})
        got[name] = ((first[0].name, first[1]), second,
                     (third[0].name, third[1]), calls, resumed.last_step)
        durability.invalidate_manifest(str(tmp_path / "5"))
    assert got["port"] == got["ref"]
    assert got["port"][0] == ("step-3", ["step-1"])
    assert got["port"][2][0] == "step-5"


# -- controller against a scripted fake target -------------------------------
class FakeTarget:
    """Scripted target: records reloads, serves queued reload records and
    SLO samples (the last entry repeats when the script runs dry)."""

    def __init__(self, samples):
        self.reloads = []
        self.reload_outcomes = []
        self.samples = list(samples)
        self.generation = 1
        self.attached = None

    def attach(self, fn):
        self.attached = fn

    def reload(self, path):
        self.reloads.append(path)
        if self.reload_outcomes:
            return self.reload_outcomes.pop(0)
        self.generation += 1
        return {"outcome": "ok", "error": None,
                "generation": self.generation}

    def sample(self):
        if len(self.samples) > 1:
            return self.samples.pop(0)
        return self.samples[0]


def _write_demo(path, seed=7):
    write_demo_model(str(path), "wine", seed=seed)


def _rot(path):
    with open(path, "r+b") as fh:
        fh.seek(40)
        fh.write(b"\xff\xff")


def _scenario(case, pkg, faults_mod, tmp_path):
    """Drive one case of tests/test_promotion.py's state-machine tests;
    returns (outcomes, ledger events, reload basenames, status)."""
    zero = _sample(pkg, {10.0: 0.0, 100.0: 0.0})
    slow = _sample(pkg, {10.0: 0.0, 100.0: 100.0})
    target = FakeTarget([zero])
    cands = tmp_path / "cands"
    cands.mkdir()
    kw = {}
    if case == "crash_loop":
        kw["max_consecutive_failures"] = 2
    if case == "prune":
        kw["keep_deployed"] = 2

    def controller(tgt):
        return pkg.PromotionController(
            pkg.DirectorySource(str(cands)), tgt,
            deploy_dir=str(tmp_path / "deploy"),
            policy=pkg.SLOPolicy(window_s=0.2, probe_interval_s=0.05,
                                 max_p99_ms=50.0, max_error_rate=0.5,
                                 min_samples=3), **kw)
    ctl = controller(target)
    out = [ctl.run_once()]
    extra = None
    if case == "happy":
        _write_demo(cands / "v1.znn")
        out.append(ctl.run_once())
        ref_durability.verify(target.reloads[0])
        extra = callable(target.attached)
    elif case == "verify_failed":
        _write_demo(cands / "rot.znn")
        _rot(cands / "rot.znn")
        out.append(ctl.run_once())
    elif case in ("breach", "unjudgeable"):
        _write_demo(cands / "v1.znn")
        out.append(ctl.run_once())
        if case == "breach":
            target.samples = [zero, slow]
        else:
            def _dead():
                raise RuntimeError("metrics endpoint gone")
            target.sample = _dead
        _write_demo(cands / "v2.znn", seed=11)
        out.append(ctl.run_once())
        extra = target.reloads[-1] == target.reloads[0]
    elif case == "no_previous":
        target.samples = [zero, slow]
        _write_demo(cands / "v1.znn")
        out.append(ctl.run_once())
    elif case == "canary_failed":
        target.reload_outcomes = [{"outcome": "canary_failed",
                                   "error": "non-finite",
                                   "generation": 1}]
        _write_demo(cands / "v1.znn")
        out.append(ctl.run_once())
    elif case == "crash_loop":
        for i in range(2):
            _write_demo(cands / f"rot{i}.znn")
            _rot(cands / f"rot{i}.znn")
            try:
                out.append(ctl.run_once())
            except pkg.CrashLoop as e:
                out.append(f"CrashLoop({e.failures})")
    elif case == "resume":
        _write_demo(cands / "v1.znn")
        out.append(ctl.run_once())
        _write_demo(cands / "v2.znn", seed=11)
        _rot(cands / "v2.znn")
        out.append(ctl.run_once())
        ctl2 = controller(FakeTarget([zero]))
        out.append(ctl2.run_once())
        st = ctl2.status()
        st.pop("last_candidate")
        with ctl2._lock:
            extra = (st, ctl2._previous == target.reloads[0])
    elif case == "export_fault":
        _write_demo(cands / "v1.znn")
        plan = faults_mod.FaultPlan([faults_mod.FaultSpec(
            "promotion.export", times=1, message="export blip")], seed=3)
        with plan:
            out.append(ctl.run_once())
        extra = plan.snapshot().get("promotion.export:error")
    elif case == "prune":
        for i in range(4):
            _write_demo(cands / f"v{i}.znn", seed=i + 1)
            out.append(ctl.run_once())
        kept = sorted(f for f in os.listdir(tmp_path / "deploy")
                      if f.endswith(".znn"))
        with ctl._lock:
            extra = (kept, os.path.basename(ctl._previous) in kept)
    elif case == "stop_mid_watch":
        _write_demo(cands / "v1.znn")
        out.append(ctl.run_once())
        ctl._stop.set()
        _write_demo(cands / "v2.znn", seed=11)
        out.append(ctl.run_once())
        extra = ctl.ledger.replay().consecutive_failures
    events = [(e["event"], e.get("state") or e.get("outcome"))
              for e in ctl.ledger.entries()]
    reasons = [None if e.get("reason") is None
               else e["reason"].replace(str(tmp_path), "<dir>")
               for e in ctl.ledger.entries() if e["event"] == "outcome"]
    status = ctl.status()
    status.pop("last_candidate")
    return (out, events, [os.path.basename(r) for r in target.reloads],
            status, reasons, extra)


STATE_MACHINE_CASES = ["happy", "verify_failed", "breach", "no_previous",
                       "canary_failed", "crash_loop", "resume",
                       "export_fault", "prune", "stop_mid_watch",
                       "unjudgeable"]


@pytest.mark.parametrize("case", STATE_MACHINE_CASES)
def test_controller_state_machine_equals_the_reference(case, tmp_path):
    got = {}
    for name, (pkg, _d, faults_mod, _r) in PKGS.items():
        d = tmp_path / name
        d.mkdir()
        got[name] = _scenario(case, pkg, faults_mod, d)
    port, ref = got["port"], got["ref"]
    assert port[:4] == ref[:4]
    # reasons carry exception reprs: the same where they are the
    # controller's own words
    assert [r if r is None or "Error(" not in r else r.split("(")[0]
            for r in port[4]] == [
        r if r is None or "Error(" not in r else r.split("(")[0]
        for r in ref[4]]
    assert port[5] == ref[5]
    want_last = {"happy": "promoted", "verify_failed": "verify_failed",
                 "breach": "rolled_back", "no_previous": "rollback_failed",
                 "canary_failed": "canary_failed",
                 "crash_loop": "CrashLoop(2)", "resume": None,
                 "export_fault": "promoted", "prune": "promoted",
                 "stop_mid_watch": "aborted", "unjudgeable": "rolled_back"}
    assert port[0][-1] == want_last[case]


def test_controller_counts_its_metrics(tmp_path):
    reg = registry.REGISTRY
    before = (reg.counter("promotions_total").value(outcome="promoted"),
              reg.counter("slo_breaches_total").value(slo="p99_latency_ms"))
    out = _scenario("breach", promotion, faults, tmp_path)
    assert out[0] == [None, "promoted", "rolled_back"]
    assert reg.counter("promotions_total").value(outcome="promoted") \
        == before[0] + 1
    assert reg.counter("slo_breaches_total").value(
        slo="p99_latency_ms") == before[1] + 1
    assert reg.gauge("promotion_generation").value() == 2


# -- real engine/server integration ------------------------------------------
def _post(url, x, timeout=30.0):
    req = urllib.request.Request(
        url + "predict", json.dumps({"inputs": x}).encode(),
        {"Content-Type": "application/json"})
    with urllib.request.urlopen(req, timeout=timeout) as r:
        return r.status, json.loads(r.read())


def _get(url, path):
    with urllib.request.urlopen(url + path, timeout=10) as r:
        return json.loads(r.read())


def test_engine_target_rollback_serves_identical_bytes(tmp_path):
    """Latency injected at ``engine.forward`` during the watch window: the
    controller rolls back and the old generation answers the same bytes
    (tests/test_promotion.py's acceptance, on the port's CPU engine)."""
    v1 = str(tmp_path / "v1.znn")
    _write_demo(v1)
    engine = ServingEngine(v1, backend="cpu", buckets=(1, 2))
    server = ServingServer(engine, max_wait_ms=1.0).start()
    cands = tmp_path / "cands"
    cands.mkdir()
    x = [[0.1, -0.2, 0.3, 0.4, 0.5, -0.6, 0.7, 0.8, -0.9, 1.0, 0.1, 0.2,
          0.3]]
    stop, pause = threading.Event(), threading.Event()
    served = []

    def traffic():
        while not stop.is_set():
            if not pause.is_set():
                try:
                    _post(server.url, x)
                    served.append(1)
                except urllib.error.URLError:
                    pass
            stop.wait(0.01)

    def quiesced_predict():
        pause.set()
        deadline = time.monotonic() + 5.0
        while server.batcher.queue_depth() > 0 \
                and time.monotonic() < deadline:
            time.sleep(0.01)
        time.sleep(0.05)
        try:
            return _post(server.url, x)[1]["outputs"]
        finally:
            pause.clear()

    thread = threading.Thread(target=traffic, daemon=True)
    thread.start()
    try:
        deadline = time.monotonic() + 60.0
        while len(served) < 5 and time.monotonic() < deadline:
            time.sleep(0.05)
        assert len(served) >= 5
        ctl = promotion.PromotionController(
            promotion.DirectorySource(str(cands)),
            promotion.EngineTarget(server=server),
            deploy_dir=str(tmp_path / "deploy"),
            policy=promotion.SLOPolicy(window_s=1.0, probe_interval_s=0.2,
                                       max_p99_ms=50.0, max_error_rate=0.5,
                                       min_samples=3))
        _write_demo(cands / "v2.znn", seed=11)
        assert ctl.run_once() == "promoted"
        gen_blessed = engine.generation
        y_blessed = quiesced_predict()
        _write_demo(cands / "v3.znn", seed=23)
        plan = faults.FaultPlan([faults.FaultSpec(
            "engine.forward", kind="latency", latency_s=0.08,
            message="regressed candidate")], seed=7)
        with plan:
            assert ctl.run_once() == "rolled_back"
        assert engine.generation == gen_blessed + 2
        assert quiesced_predict() == y_blessed
        health = _get(server.url, "healthz")
        assert health["promotion"]["state"] == "rolled_back"
        assert health["promotion"]["last_outcome"] == "rolled_back"
    finally:
        stop.set()
        thread.join(5)
        assert not thread.is_alive()
        server.stop()
        engine.close()


def test_http_target_waits_out_a_409_retry_after(tmp_path):
    """A reload in flight answers 409 + Retry-After; HttpTarget raises
    ReloadBusy, the controller's reload retry waits it out, and the
    candidate promotes over the admin surface."""
    v1 = str(tmp_path / "v1.znn")
    _write_demo(v1)
    engine = ServingEngine(v1, backend="cpu", buckets=(1, 2))
    server = ServingServer(engine, max_wait_ms=1.0,
                           admin_token="s3cret").start()
    release = threading.Event()
    blocker = threading.Thread(target=release.wait, daemon=True)
    blocker.start()
    try:
        with server._reload_mu:
            server._reload_thread = blocker        # a reload "in flight"
        target = promotion.HttpTarget(server.url, admin_token="s3cret")
        with pytest.raises(promotion.ReloadBusy):
            target.reload(v1)
        req = urllib.request.Request(
            server.url + "admin/reload", b"{}",
            {"Content-Type": "application/json", "X-Admin-Token": "s3cret"})
        with pytest.raises(urllib.error.HTTPError) as exc:
            urllib.request.urlopen(req, timeout=30)
        assert exc.value.code == 409
        ra = int(exc.value.headers.get("Retry-After"))
        assert ra >= 1 and json.loads(exc.value.read())["retry_after_s"] == ra
        cands = tmp_path / "cands"
        cands.mkdir()
        _write_demo(cands / "v2.znn", seed=11)
        ctl = promotion.PromotionController(
            promotion.DirectorySource(str(cands)), target,
            deploy_dir=str(tmp_path / "deploy"),
            policy=promotion.SLOPolicy(window_s=0.3, probe_interval_s=0.1,
                                       max_p99_ms=50.0, min_samples=3),
            reload_retry=promotion.controller.RetryPolicy(
                max_attempts=20, base_delay_s=0.1, max_delay_s=0.3))
        threading.Timer(0.5, release.set).start()
        assert ctl.run_once() == "promoted"
        assert engine.generation == 2
        assert _get(server.url, "healthz")["last_reload"]["outcome"] == "ok"
    finally:
        release.set()
        blocker.join(5)
        server.stop()
        engine.close()


def test_http_target_polls_past_a_stale_record():
    """A 202 whose ``last_reload`` is the previous reload's record: the
    target polls /healthz until a newer record lands (as the
    reference's)."""
    from http.server import BaseHTTPRequestHandler, ThreadingHTTPServer
    old = {"outcome": "ok", "error": None, "at": 111.0}
    new = {"outcome": "verify_failed", "error": "rot", "at": 222.0}
    seen = {"health": 0}

    class Handler(BaseHTTPRequestHandler):
        def log_message(self, *args):
            pass

        def _send(self, code, obj):
            body = json.dumps(obj).encode()
            self.send_response(code)
            self.send_header("Content-Length", str(len(body)))
            self.end_headers()
            self.wfile.write(body)

        def do_GET(self):
            seen["health"] += 1
            rec = old if seen["health"] <= 2 else new
            self._send(200, {"model_generation": 5, "last_reload": rec})

        def do_POST(self):
            self.rfile.read(int(self.headers.get("Content-Length", 0)))
            self._send(202, {"model_generation": 5, "last_reload": old})

    srv = ThreadingHTTPServer(("127.0.0.1", 0), Handler)
    threading.Thread(target=srv.serve_forever, daemon=True).start()
    try:
        target = promotion.HttpTarget(
            f"http://127.0.0.1:{srv.server_port}/", timeout_s=10.0)
        rec = target.reload("/candidate.znn")
        assert rec == {"outcome": "verify_failed", "error": "rot",
                       "generation": 5}
        assert seen["health"] >= 3
    finally:
        srv.shutdown()


def _serve(args):
    """A port ``serve`` subprocess on the CPU; (process, base url)."""
    env = dict(os.environ, PYTHONPATH=REPO, OMP_NUM_THREADS="2")
    p = subprocess.Popen([sys.executable, "-m", "znicz_tpu_torch", "serve",
                          "--backend", "cpu", "--port", "0", *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=REPO)
    for _ in range(5):
        line = p.stdout.readline()
        m = re.search(r"at (http://[\d.]+:\d+/)", line)
        if m:
            return p, m.group(1)
    p.kill()
    out, err = p.communicate(timeout=30)
    raise AssertionError(f"serve did not start: {out}{err}")


def _stop(p):
    p.send_signal(signal.SIGTERM)
    out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err
    return out


def test_promote_cli_drives_the_ports_serve(tmp_path):
    """``promote --once`` against a ``serve`` process it shares nothing
    with: POST /admin/reload (token-gated), the SLO watch on /metrics,
    and the promotion families on that server's /metrics from zero."""
    v1 = str(tmp_path / "v1.znn")
    _write_demo(v1)
    p, url = _serve(["--model", v1, "--admin-token", "s3cret",
                     "--max-wait-ms", "1"])
    try:
        text = urllib.request.urlopen(
            url + "metrics?format=prometheus", timeout=10).read().decode()
        assert "promotion_generation 0" in text \
            and "# TYPE promotions_total counter" in text
        cands = tmp_path / "cands"
        cands.mkdir()
        _write_demo(cands / "v2.znn", seed=11)
        rc = port_cli.main(["--candidates", str(cands), "--url", url,
                            "--admin-token", "s3cret", "--once",
                            "--window-s", "0.3", "--probe-interval-s",
                            "0.1"])
        assert rc == 0
        health = _get(url, "healthz")
        assert health["model_generation"] == 2
        assert health["last_reload"]["outcome"] == "ok"
        led = promotion.PromotionLedger(
            str(cands / "_deploy" / "promotions.jsonl"))
        assert led.replay().promotions == 1
    finally:
        _stop(p)


def _cli_runs(main, tmp_path, capsys):
    """The promote CLI's --once outcomes without a server: an empty
    directory, then a crash loop of one rotten candidate."""
    cands = tmp_path / "cands"
    cands.mkdir()
    out = []
    argv = ["--candidates", str(cands), "--url", "http://127.0.0.1:9/",
            "--once", "--max-failures", "1"]
    out.append((main(argv), capsys.readouterr().out))
    _write_demo(cands / "rot.znn")
    _rot(cands / "rot.znn")
    out.append((main(argv), capsys.readouterr().out))
    with pytest.raises(SystemExit) as e:
        main(["--url", "http://x/"])
    capsys.readouterr()
    out.append(e.value.code)
    with pytest.raises(SystemExit) as e:
        main(["--candidates", str(cands), "--url", "a", "--url", "b"])
    capsys.readouterr()
    out.append(e.value.code)
    return out


def test_promote_cli_exit_codes_equal_the_references(tmp_path, capsys):
    got = {}
    for name, main in (("port", port_cli.main), ("ref", ref_cli.main)):
        d = tmp_path / name
        d.mkdir()
        got[name] = _cli_runs(main, d, capsys)
    assert got["port"] == got["ref"]
    assert got["port"][0] == (0, "promote: no new candidate\n")
    assert got["port"][1] == (2, "")


def test_promote_fleet_raises_naming_item_11(tmp_path):
    with pytest.raises(NotImplementedError, match="queue 1 item 11"):
        port_cli.main(["--candidates", str(tmp_path), "--url",
                       "http://127.0.0.1:9/", "--fleet"])
    from znicz_tpu_torch.__main__ import main as port_main
    with pytest.raises(NotImplementedError, match="item 11"):
        port_main(["promote", "--candidates", str(tmp_path), "--url",
                   "http://127.0.0.1:9/", "--fleet"])
