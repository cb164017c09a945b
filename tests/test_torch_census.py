"""The census-driven warm-up of the port's serving engine
(``ServingEngine.warmup_from_census`` and the warm-up a reload runs)
against the JAX package's, on the CPU.

- over the same flight-recorder census, both engines warm the same
  shapes within the cache-fit cap ``(cache_size − 1) // len(buckets)``,
  build each (shape, bucket) once, warn naming the shapes beyond the
  cap, warm nothing when the cap is 0, and raise on a bad operator
  fallback shape when there is no census.  A shape the model refuses
  (junk, or another zoo model's) costs the reference a miss and a cache
  slot; the port drops it before the cap (``accepts_shape``, which
  agrees with the forward on every chain);
- a kernel's error during the warm-up reaches the caller; a reload's
  warm-up that fails is logged and counted, and the swap stands;
- a dropped engine frees its executables without a collection;
- through both ``ServingServer``s: traffic of two batch sizes, then
  ``POST /admin/reload``, then the same traffic again.  The reload
  builds every observed (shape, bucket) off the request path, so the
  requests after the swap build nothing; the port's ``builds`` and
  ``cache_misses`` equal the reference engine's compiles and misses."""

import gc
import json
import logging
import urllib.request
import weakref

import numpy as np
import pytest
import torch

from znicz_tpu.serving import ServingServer as RefServingServer
from znicz_tpu.serving import engine as ref_engine
from znicz_tpu.telemetry import compilestats as ref_compilestats
from znicz_tpu.telemetry import flightrecorder as ref_fr
from znicz_tpu_torch.cuda_build import LaunchError
from znicz_tpu_torch.export import read_znn
from znicz_tpu_torch.serving import ServingEngine, ServingServer
from znicz_tpu_torch.serving import engine as engine_mod
from znicz_tpu_torch.serving.engine import accepts_shape, torch_forward
from znicz_tpu_torch.telemetry import compilestats, flightrecorder
from test_torch_serving_card import CHAINS, write_chain

TOKEN = "t0ken"


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def mlp(tmp_path):
    return write_chain(tmp_path / "mlp.znn", "mlp")[0]


def _engines(path, **kw):
    return {"port": ServingEngine(path, backend="cpu", **kw),
            "ref": ref_engine.ServingEngine(path, backend="jax", **kw)}


def _recorders(census):
    """A recorder a package with ``census`` ({shape: served requests})
    recorded, and one failed request of another shape (excluded)."""
    out = {}
    for key, mod in (("port", flightrecorder), ("ref", ref_fr)):
        rec = mod.FlightRecorder()
        for shape, n in census.items():
            for _ in range(n):
                rec.record("request", duration_ms=1.0, outcome="ok",
                           shape=list(shape), rows=1)
        rec.record("request", duration_ms=1.0, outcome="error",
                   shape=[5, 5], rows=1)
        out[key] = rec
    return out


#: (784,) is the MLP's input; (28, 28, 1) and (7, 112) flatten to it;
#: (783,) is junk the model refuses
CENSUS = {(784,): 9, (783,): 7, (28, 28, 1): 5, (7, 112): 3, (1, 784): 2}


def _stats(key, eng):
    m = eng.metrics()
    return {"misses": m["cache_misses"], "hits": m["cache_hits"],
            "cached": m["cached_executables"]}


def test_warmup_within_the_cap_skips_junk_and_warns(mlp, caplog):
    engines = _engines(mlp, buckets=(1, 8), cache_size=7)   # cap 3
    recs = _recorders(CENSUS)
    with caplog.at_level(logging.WARNING, logger="ServingEngine"):
        built = {k: e.warmup_from_census(recorder=recs[k])
                 for k, e in engines.items()}
    # the reference warms its top three, (784,), the junk (783,) and
    # (28, 28, 1): the junk costs it a miss and a dead cache slot.  The
    # port drops the junk before the cap and warms (7, 112) in its place
    assert built == {"port": 6, "ref": 4}
    assert _stats("port", engines["port"]) == {"misses": 6, "hits": 0,
                                               "cached": 6}
    assert _stats("ref", engines["ref"]) == {"misses": 5, "hits": 0,
                                             "cached": 5}
    assert engines["port"].metrics()["builds"] == 6
    warnings = [r.getMessage() for r in caplog.records
                if "cache-fit cap of 3" in r.getMessage()]
    assert len(warnings) == 2
    assert "1 observed shape(s)" in warnings[0] and "[1, 784]" in warnings[0]
    assert "[7, 112]" in warnings[1]
    # warm already: nothing more to build
    assert {k: e.warmup_from_census(recorder=recs[k])
            for k, e in engines.items()} == {"port": 0, "ref": 0}
    # a warmed shape's requests hit
    for k, e in engines.items():
        before = e.metrics()["cache_misses"]
        e.predict(np.zeros((5, 28, 28, 1), np.float32))
        e.predict(np.zeros((1, 784), np.float32))
        assert e.metrics()["cache_misses"] == before, k


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_accepts_shape_agrees_with_the_forward(name, tmp_path):
    """A chain accepts its own sample shape, and each other chain's shape
    exactly when its forward runs on it."""
    layers = read_znn(write_chain(tmp_path / f"{name}.znn", name)[0])
    for other in sorted(CHAINS):
        shape = CHAINS[other](np.random.default_rng(0))[0]
        try:
            torch_forward(layers, torch.zeros((2,) + tuple(shape)))
        except (ValueError, RuntimeError):
            runs = False
        else:
            runs = True
        assert accepts_shape(layers, shape) == runs, other
        assert runs or other != name


def test_a_zoo_census_warms_each_model_only_its_own_shapes(tmp_path):
    """The census holds every model's shapes; each engine builds its own
    and spends no miss or cache slot on the others'."""
    paths = {n: write_chain(tmp_path / f"{n}.znn", n) for n in
             ("mlp", "conv", "som")}
    rec = flightrecorder.FlightRecorder()
    for n, (_, shape) in paths.items():
        for _ in range(3):
            rec.record("request", duration_ms=1.0, outcome="ok",
                       shape=list(shape), rows=1)
    for n, (path, _) in paths.items():
        eng = ServingEngine(path, backend="cpu", buckets=(1, 8),
                            cache_size=3)                  # cap 1
        assert eng.warmup_from_census(recorder=rec) == 2, n
        m = eng.metrics()
        assert (m["builds"], m["cache_misses"],
                m["cached_executables"]) == (2, 2, 2), n


def _launch_error_at(monkeypatch, bucket):
    """Every forward of ``bucket`` rows raises the kernels' LaunchError."""
    real = engine_mod.torch_forward

    def forward(layers, x, params=None):
        if x.shape[0] == bucket:
            raise LaunchError("injected launch failure")
        return real(layers, x, params)
    monkeypatch.setattr(engine_mod, "torch_forward", forward)


def test_a_launch_error_in_the_census_warm_up_reaches_the_caller(
        mlp, monkeypatch, caplog):
    rec = flightrecorder.FlightRecorder()
    rec.record("request", duration_ms=1.0, outcome="ok", shape=[784],
               rows=1)
    eng = ServingEngine(mlp, backend="cpu", buckets=(1, 8))
    _launch_error_at(monkeypatch, 8)
    with pytest.raises(LaunchError):
        eng.warmup_from_census(recorder=rec)
    # a reload swaps (its canary runs at bucket 1), then its warm-up
    # meets the error: logged and counted, not dropped
    monkeypatch.setattr(flightrecorder, "RECORDER", rec)
    with caplog.at_level(logging.ERROR, logger="ServingEngine"):
        record = eng.reload()
    assert record["outcome"] == "ok" and eng.generation == 2
    assert eng.metrics()["warmup_failures"] == 1
    failed = [r for r in caplog.records
              if "census warm-up after the reload" in r.getMessage()]
    assert len(failed) == 1 and failed[0].exc_info[0] is LaunchError


def test_a_dropped_engine_frees_its_executables_without_a_collection(
        mlp, monkeypatch):
    """No reference cycle holds an engine: dropping it frees its
    executables (on the card their CUDA graphs) at once."""
    rec = flightrecorder.FlightRecorder()
    rec.record("request", duration_ms=1.0, outcome="ok", shape=[784],
               rows=1)
    monkeypatch.setattr(flightrecorder, "RECORDER", rec)
    collecting = gc.isenabled()
    gc.disable()
    try:
        eng = ServingEngine(mlp, backend="cpu", buckets=(1, 8))
        eng.predict(np.zeros((3, 784), np.float32))
        assert eng.reload()["outcome"] == "ok"
        # bucket 8 before; the canary seeds bucket 1, the warm-up builds 8
        assert eng.metrics()["builds"] == 2
        assert eng.metrics()["cached_executables"] == 2
        # the canary's executable is seeded bare, the others wrapped
        refs = [weakref.ref(eng)] + [weakref.ref(getattr(fn, "fn", fn))
                                     for fn in eng._cache.values()]
        del eng
        assert [r() for r in refs] == [None] * len(refs)
    finally:
        if collecting:
            gc.enable()


def test_cap_zero_and_the_fallback_shape(mlp):
    # cache_size <= len(buckets): even one shape would evict itself
    engines = _engines(mlp, buckets=(1, 8), cache_size=2)
    recs = _recorders(CENSUS)
    assert {k: e.warmup_from_census(recorder=recs[k])
            for k, e in engines.items()} == {"port": 0, "ref": 0}
    empty = _recorders({})
    engines = _engines(mlp, buckets=(1, 8))
    for k, e in engines.items():
        # no census: the operator's shape warms, and a wrong one raises
        assert e.warmup_from_census(recorder=empty[k],
                                    fallback_shape=(784,)) == 2
        with pytest.raises(Exception):
            e.warmup_from_census(recorder=empty[k], fallback_shape=(783,))
        # a census beats the fallback
        assert e.warmup_from_census(recorder=_recorders(
            {(28, 28, 1): 1})[k], fallback_shape=(783,)) == 2
    with pytest.raises(ValueError, match="fc expects"):
        engines["port"].warmup_from_census(recorder=empty["port"],
                                           fallback_shape=(783,))


def _post(url, body, headers=None):
    req = urllib.request.Request(url, data=body, method="POST",
                                 headers=headers or {})
    with urllib.request.urlopen(req, timeout=60) as r:
        return r.status, json.loads(r.read())


def _compiles(mod) -> int:
    return sum(mod.snapshot()["compiles"].get("serving.engine", {})
               .values())


def test_reload_warms_the_census_off_the_request_path(mlp, monkeypatch):
    # fresh recorders: the census is this test's traffic alone
    monkeypatch.setattr(flightrecorder, "RECORDER",
                        flightrecorder.FlightRecorder())
    monkeypatch.setattr(ref_fr, "RECORDER", ref_fr.FlightRecorder())
    engines = _engines(mlp, buckets=(1, 8, 32))
    servers = {"port": ServingServer(engines["port"], admin_token=TOKEN,
                                     max_wait_ms=1.0).start(),
               "ref": RefServingServer(engines["ref"], admin_token=TOKEN,
                                       max_wait_ms=1.0).start()}
    stats_mod = {"port": compilestats, "ref": ref_compilestats}
    rng = np.random.default_rng(0)
    traffic = [rng.standard_normal((n, 784)).astype(np.float32)
               for n in (1, 5, 1, 20, 5)]
    out = {}
    try:
        for key, server in servers.items():
            eng = engines[key]

            def serve():
                for x in traffic:
                    code, _ = _post(server.url + "predict", json.dumps(
                        {"inputs": x.tolist()}).encode())
                    assert code == 200
            serve()
            c0, m0 = _compiles(stats_mod[key]), eng.metrics()
            code, body = _post(server.url + "admin/reload", json.dumps(
                {"wait": True}).encode(), {"X-Admin-Token": TOKEN})
            assert code == 200 and body["last_reload"]["outcome"] == "ok"
            c1, m1 = _compiles(stats_mod[key]), eng.metrics()
            serve()
            c2, m2 = _compiles(stats_mod[key]), eng.metrics()
            out[key] = {"reload_builds": c1 - c0,
                        "reload_misses": m1["cache_misses"]
                        - m0["cache_misses"],
                        "after_builds": c2 - c1,
                        "after_misses": m2["cache_misses"]
                        - m1["cache_misses"],
                        "after_hits": m2["cache_hits"] - m1["cache_hits"],
                        "generation": m2["generation"]}
            if key == "port":
                out[key]["port_builds"] = (m1["builds"] - m0["builds"],
                                           m2["builds"] - m1["builds"])
    finally:
        for s in servers.values():
            s.stop()
    port_builds = out["port"].pop("port_builds")
    assert out["port"] == out["ref"]
    # the canary seeded bucket 1; the census warm-up built 8 and 32
    assert out["port"]["reload_builds"] == 2
    assert port_builds == (2, 0)
    assert out["port"]["after_builds"] == 0
    assert out["port"]["after_misses"] == 0
    assert out["port"]["after_hits"] == len(traffic)
    assert out["port"]["generation"] == 2
