"""The port's model zoo and replica sets (``znicz_tpu_torch.serving.zoo``,
``serving.replicas``) against the JAX package's, on the CPU: the same
calls on the same ``.znn`` files, the port's engines with
``backend="cpu"``, the reference's as its own tests run them.

- ``make_demo_zoo`` writes the reference's bytes for the same seed;
  ``write_demo_model`` refuses an unknown family in both;
- token-bucket quotas on an injected clock, ``admit``'s refusals and
  their Retry-After; criticality and deadline classes
  (``effective_policy``) and entry validation;
- the eviction order under a memory budget, page-ins (counts and
  answers), the placement hint, ``reload``/``reload_all`` records, and
  the ``--model``/``--zoo`` grammar;
- the replica set: round robin, a sick replica routed around and
  re-admitted, the rolling reload, and hedging under a
  ``replica.slow.1`` latency fault (the hedge wins); its metrics report
  the one-device mesh;
- ``write_trained_model`` trains both families on the host
  (``"autoencoder"`` and the RBM-pretrained ``"mnist_rbm"``) and serves
  them against the reference's engine; ``make_full_zoo`` writes all five
  families and a zoo of them serves each."""

import os

import numpy as np
import pytest
import torch

from znicz_tpu.resilience import faults as ref_faults
from znicz_tpu.resilience import overload as ref_overload
from znicz_tpu.serving import engine as ref_engine
from znicz_tpu.serving import replicas as ref_replicas
from znicz_tpu.serving import zoo as ref_zoo
from znicz_tpu_torch import durability
from znicz_tpu_torch.resilience import faults, overload
from znicz_tpu_torch.serving import ServingEngine, replicas, zoo

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


#: each package: (zoo module, replicas module, engine factory, faults,
#: overload)
PORT = (zoo, replicas, lambda p, **kw: ServingEngine(p, backend="cpu",
                                                     **kw),
        faults, overload)
REF = (ref_zoo, ref_replicas,
       lambda p, **kw: ref_engine.ServingEngine(p, backend="jax", **kw),
       ref_faults, ref_overload)


@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    """The reference's demo trio, and the port's written apart."""
    base = tmp_path_factory.mktemp("zoo")
    return (ref_zoo.make_demo_zoo(str(base / "ref"), seed=7),
            zoo.make_demo_zoo(str(base / "port"), seed=7))


def _x(family, n=3, seed=0):
    return np.random.default_rng(seed).standard_normal(
        (n, zoo.DEMO_SHAPES[family])).astype(np.float32)


def test_demo_zoo_bytes_equal(demo, tmp_path):
    ref_paths, port_paths = demo
    assert sorted(port_paths) == sorted(ref_paths) \
        == list(zoo.DEMO_FAMILIES)
    for fam in zoo.DEMO_FAMILIES:
        with open(port_paths[fam], "rb") as a, \
                open(ref_paths[fam], "rb") as b:
            assert a.read() == b.read()
        durability.verify(port_paths[fam])
    assert zoo.DEMO_SHAPES == ref_zoo.DEMO_SHAPES
    for mod in (zoo, ref_zoo):
        with pytest.raises(ValueError, match="unknown demo family"):
            mod.write_demo_model(str(tmp_path / "x.znn"), "resnet")


def test_token_bucket_and_admission_match():
    class Clock:
        t = 100.0

        def __call__(self):
            return self.t

    results = []
    for pkg in (PORT, REF):
        mod = pkg[0]
        clock = Clock()
        b = mod.TokenBucket(2.0, burst=3, clock=clock)
        seq = []
        for dt in (0, 0, 0, 0, 0.2, 0.3, 0, 1.5, 0, 0, 0, 0):
            clock.t += dt
            seq.append(b.try_take())
        seq.append(b.metrics())
        z = mod.ModelZoo()
        entry = z.add("m", engine=_StubEngine(), quota_rps=1.0,
                      quota_burst=1)
        entry.quota = mod.TokenBucket(1.0, burst=1, clock=clock)
        z.admit(entry)
        with pytest.raises(mod.QuotaExceeded) as e:
            z.admit(entry)
        seq.append((str(e.value), e.value.retry_after))
        for bad in (lambda: mod.TokenBucket(0), lambda: mod.TokenBucket(
                1.0, burst=0.5), lambda: z.add("q", engine=_StubEngine(),
                                               quota_burst=3)):
            with pytest.raises(ValueError):
                bad()
        results.append(seq)
    assert results[0] == results[1]


class _StubEngine:
    """Just enough engine for registry-only checks."""
    generation = 1
    on_pagein = on_device_time = None

    def weights_resident(self):
        return True


def test_criticality_and_entry_validation():
    for mod in (zoo, ref_zoo):
        e = mod.ModelEntry("tenant-1", _StubEngine(),
                           criticality="sheddable", deadline_ms=250)
        assert e.effective_policy(None, None) == ("sheddable", 250.0)
        assert e.effective_policy("critical", 10.0) == ("critical", 10.0)
        for kw in ({"criticality": "vip"}, {"deadline_ms": -1}):
            with pytest.raises(ValueError):
                mod.ModelEntry("m", _StubEngine(), **kw)
        with pytest.raises(ValueError):
            mod.ModelEntry("bad name!", _StubEngine())
        z = mod.ModelZoo()
        z.add("a", engine=_StubEngine())
        z.add("b", engine=_StubEngine(), default=True)
        assert z.default_name == "b" and z.names() == ["a", "b"]
        with pytest.raises(ValueError):
            z.add("a", engine=_StubEngine())
        with pytest.raises(mod.UnknownModel, match="no model 'c'"):
            z.resolve("c")


def _zoo_drive(pkg, paths, budget_extra):
    """Touch tenants in a fixed order under a budget that holds all but
    the largest model; record residency, page-ins, answers, the
    placement hint and the reload records."""
    mod, _, make, _, _ = pkg
    z = mod.ModelZoo()
    for fam in mod.DEMO_FAMILIES:
        z.add(fam, engine=make(paths[fam]),
              criticality="sheddable" if fam == "wine" else "default")
    sizes = {e.name: e.engine.weight_nbytes() for e in z.entries()}
    z.memory_budget = sum(sizes.values()) - max(sizes.values()) \
        + budget_extra
    trace, answers = [], {}
    for fam in ("wine", "mnist", "kohonen", "wine", "kohonen", "mnist",
                "wine"):
        entry = z.resolve(fam)
        z.touch(entry)
        answers.setdefault(fam, []).append(entry.engine.predict(_x(fam)))
        trace.append({e.name: (e.engine.weights_resident(),
                               e.engine.metrics()["weight_pageins"])
                      for e in z.entries()})
    placed = z.set_placement_hint(["mnist", "ghost"])
    after_hint = {e.name: e.engine.weights_resident()
                  for e in z.entries()}
    cleared = z.set_placement_hint(None)
    reloads = [{k: r[k] for k in ("model", "outcome", "generation")}
               for r in z.reload_all()]
    single = z.reload("wine", paths["mnist"])      # wrong-geometry file
    rows = [{k: r[k] for k in ("model", "default", "generation",
                               "criticality", "resident", "weight_bytes",
                               "queue_depth", "state")}
            for r in z.status()]
    out = {"sizes": sizes, "trace": trace, "placed": placed,
           "after_hint": after_hint, "cleared": cleared,
           "reloads": reloads, "single": {k: single[k] for k in (
               "model", "outcome", "generation")}, "rows": rows,
           "row_keys": sorted(z.status()[0]),
           "metric_keys": sorted(z.metrics())}
    z.close()
    return out, answers


def test_eviction_pagein_placement_and_reload_all_match(demo):
    ref_paths, port_paths = demo
    got, got_y = _zoo_drive(PORT, port_paths, 1)
    want, want_y = _zoo_drive(REF, ref_paths, 1)
    assert got == want
    # the churn happened: something was evicted and paged back in
    assert any(not res for step in got["trace"]
               for res, _n in step.values())
    assert max(n for step in got["trace"] for _r, n in step.values()) > 1
    for fam in got_y:
        for a, b in zip(got_y[fam], want_y[fam]):
            np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
        # a page-in answers the bytes of the first residency
        for later in got_y[fam][1:]:
            np.testing.assert_array_equal(later, got_y[fam][0])


def test_spec_grammar_and_scan_match(demo, tmp_path):
    for spec in ("m.znn", "mnist=/a/m.znn", "a=/p.znn,criticality="
                 "critical,deadline-ms=50,quota-rps=3,quota-burst=5,"
                 "quantize=int8,default", "/x/y=z.znn"):
        assert zoo.parse_model_spec(spec) == ref_zoo.parse_model_spec(spec)
    for bad in ("a=", "a=p.znn,junk", "a=p.znn,color=red",
                "a=p.znn,quantize=int4"):
        for mod in (zoo, ref_zoo):
            with pytest.raises(ValueError):
                mod.parse_model_spec(bad)
    d = os.path.dirname(demo[1]["wine"])
    assert zoo.scan_zoo_dir(d) == ref_zoo.scan_zoo_dir(d)
    for mod in (zoo, ref_zoo):
        with pytest.raises(ValueError, match="no .znn"):
            mod.scan_zoo_dir(str(tmp_path))


def _replica_drive(pkg, path, path2):
    _, rmod, make, fmod, omod = pkg
    rs = rmod.EngineReplicaSet(lambda i: make(path), 3)
    x = _x("wine", 2)
    out = {}
    for _ in range(6):
        rs.predict(x)
    out["round_robin"] = [e.metrics()["forward_calls"]
                          for e in rs.replicas]
    sick = rs.replicas[0]
    for _ in range(sick.breaker.failure_threshold):
        sick.breaker.record_failure()
    for _ in range(6):
        rs.predict(x)
    out["sick_routed_around"] = [e.metrics()["forward_calls"]
                                 for e in rs.replicas]
    out["state_with_sick"] = (rs.resilience_state(), [
        r["breaker"] for r in rs.replica_status()])
    sick.breaker.record_success()
    for _ in range(3):
        rs.predict(x)
    out["readmitted"] = [e.metrics()["forward_calls"]
                         for e in rs.replicas]
    rec = rs.reload(path2)
    out["reload"] = (rec["outcome"], rec["generation"],
                     [r["generation"] for r in rec["replicas"]])
    out["answer"] = rs.predict(x)
    out["reload_status"] = rs.reload_status()["replica_generations"]
    m = rs.metrics()
    out["metrics"] = {k: m[k] for k in ("generation", "replica_count",
                                        "replicas_healthy", "mesh",
                                        "tensor_parallel")}
    with pytest.raises(ValueError, match="replica"):
        rmod.EngineReplicaSet.of(path, 2, breaker=object())
    rs.close()
    # hedging: replica 1 is slow; the second dispatch lands there and a
    # hedge on replica 0 wins
    hs = rmod.EngineReplicaSet(lambda i: make(path), 2,
                               hedge=omod.HedgePolicy(after_ms=150.0))
    # every replica warm first: a first call that builds must not read
    # as a slow replica
    hs.warmup((zoo.DEMO_SHAPES["wine"],))
    plan = fmod.FaultPlan([fmod.FaultSpec(
        "replica.slow.1", kind="latency", latency_s=0.6)])
    with plan:
        ys = [hs.predict(x) for _ in range(2)]
    out["hedge"] = hs.hedge_status()["outcomes"]
    out["hedge_fault_hits"] = plan.snapshot()
    out["hedged_answers"] = ys
    hs.close()
    return out


def test_replica_sets_match(demo, tmp_path):
    ref_paths, port_paths = demo
    # a second generation of the wine model (another seed)
    p2 = zoo.write_demo_model(str(tmp_path / "w2.znn"), "wine", seed=99)
    r2 = ref_zoo.write_demo_model(str(tmp_path / "rw2.znn"), "wine",
                                  seed=99)
    got = _replica_drive(PORT, port_paths["wine"], p2)
    want = _replica_drive(REF, ref_paths["wine"], r2)
    for key in ("answer",):
        np.testing.assert_allclose(got.pop(key), want.pop(key), rtol=RTOL,
                                   atol=ATOL)
    for a, b in zip(got.pop("hedged_answers"), want.pop("hedged_answers")):
        np.testing.assert_allclose(a, b, rtol=RTOL, atol=ATOL)
    assert got == want
    assert got["round_robin"] == [2, 2, 2]
    assert got["sick_routed_around"][0] == 2
    assert got["readmitted"][0] > 2
    assert got["hedge"] == {"won": 1}
    assert got["metrics"]["mesh"] == "1x1" \
        and got["metrics"]["tensor_parallel"] == 1


def test_write_trained_model(tmp_path):
    rbm = zoo.write_trained_model(str(tmp_path / "rbm.znn"), "mnist_rbm",
                                  device="cpu")
    durability.verify(rbm)
    x = np.random.default_rng(2).normal(0, 1, (3, 784)).astype(np.float32)
    np.testing.assert_allclose(
        ServingEngine(rbm, backend="cpu").predict(x),
        ref_engine.ServingEngine(rbm, backend="jax").predict(x), rtol=1e-4,
        atol=1e-5)
    with pytest.raises(ValueError, match="unknown trained family"):
        zoo.write_trained_model(str(tmp_path / "x.znn"), "resnet",
                                device="cpu")
    assert zoo.TRAINED_SAMPLE_SHAPES == ref_zoo.TRAINED_SAMPLE_SHAPES
    path = zoo.write_trained_model(str(tmp_path / "ae.znn"),
                                   "autoencoder", device="cpu")
    durability.verify(path)
    eng = ServingEngine(path, backend="cpu")
    shape = zoo.TRAINED_SAMPLE_SHAPES["autoencoder"]
    y = eng.predict(np.random.default_rng(0).uniform(
        0, 1, (2,) + shape).astype(np.float32))
    assert y.shape == (2, int(np.prod(shape))) and np.isfinite(y).all()
    ref = ref_engine.ServingEngine(path, backend="jax")
    x = np.random.default_rng(1).uniform(0, 1, (3,) + shape
                                         ).astype(np.float32)
    np.testing.assert_allclose(eng.predict(x), ref.predict(x), rtol=1e-4,
                               atol=1e-5)


def test_make_full_zoo_serves_every_family(tmp_path):
    paths = zoo.make_full_zoo(str(tmp_path / "zoo"), device="cpu")
    assert sorted(paths) == sorted(zoo.DEMO_FAMILIES
                                   + zoo.TRAINED_FAMILIES)
    assert len(paths) == 5
    # the demo trio byte for byte the reference's
    ref_paths = ref_zoo.make_demo_zoo(str(tmp_path / "ref"))
    for fam, p in ref_paths.items():
        with open(p, "rb") as a, open(paths[fam], "rb") as b:
            assert a.read() == b.read(), fam
    z = zoo.ModelZoo()
    for fam, p in paths.items():
        durability.verify(p)
        z.add(fam, p, backend="cpu")
    shapes = {**{f: (n,) for f, n in zoo.DEMO_SHAPES.items()},
              **zoo.TRAINED_SAMPLE_SHAPES}
    try:
        for fam in paths:
            x = np.random.default_rng(3).uniform(
                0, 1, (2,) + shapes[fam]).astype(np.float32)
            y = z.resolve(fam).predict(x)
            assert len(y) == 2 and np.isfinite(y).all(), fam
    finally:
        z.close()
