"""The port's serving stack (znicz_tpu_torch.serving, .resilience,
.telemetry) against the JAX package's, on the CPU.

- every layer kind and activation of the ``.znn`` format (the chains of
  tests/test_torch_serving_card.py): ``torch_forward`` on the CPU
  against the reference's ``jax_forward`` on the same file at rtol 1e-5
  / atol 1e-6, and ``output_features`` and ``quantize_layers`` equal;
- the int8 forward against the reference's at a depth where float32
  accumulation of the int8 products is exact;
- ``ServingEngine(backend="cpu")`` against the reference's engine on the
  CPU over one call sequence: buckets 1/8/32, a chunked batch, the
  answers, and the cache's hits, misses and evictions; reload outcomes
  (``ok``, ``verify_failed``, ``canary_failed``) and generations;
  weight release and page-in; int8 serving and its fallback reasons;
- injected ``engine.forward`` faults retry, open the breaker and are
  served by the port's native engine, with the reference's counts; an
  error the forward raises of its own (a ``BuildError``, a
  ``LaunchError``, a CUDA or device error, an ``OSError`` from loading a
  kernel library) reaches the caller unretried, with no fallback call;
- the default backend raises without a card; ``tp=2`` and ``"auto"``
  raise; census warmup with no census warms nothing, and a wrong
  fallback shape raises;
- ``MicroBatcher``: N concurrent requests take at most ⌈N/max_batch⌉
  engine forwards; a full queue raises ``QueueFull``; a request whose
  deadline passes in the queue fails with ``DeadlineExceeded``;
- the breaker's states, the retry schedule (seeded jitter) and the
  registry's Prometheus text, driven the same way in both packages,
  are equal;
- ``parallel.capture.capture`` (every CUDA graph of the engine) records
  with the garbage collector off — a collection would destroy an
  unreachable graph on the capturing thread and invalidate the capture
  — and turns it on again after (``torch.cuda``'s graph calls faked)."""

import contextlib
import gc
import math
import threading
import time

import numpy as np
import pytest
import torch

import jax.numpy as jnp

from znicz_tpu import export as ref_export
from znicz_tpu.resilience import breaker as ref_breaker
from znicz_tpu.resilience import faults as ref_faults
from znicz_tpu.resilience import retry as ref_retry
from znicz_tpu.serving import engine as ref_engine
from znicz_tpu.telemetry import registry as ref_registry
from znicz_tpu_torch import cuda_build, export
from znicz_tpu_torch.ops import activations
from znicz_tpu_torch.resilience import breaker, faults, retry
from znicz_tpu_torch.serving import (DeadlineExceeded, EngineUnavailable,
                                     MicroBatcher, QueueFull, ServingEngine)
from znicz_tpu_torch.serving import engine
from znicz_tpu_torch.telemetry import flightrecorder, registry
from test_torch_serving_card import CHAINS, write_chain

RTOL, ATOL = 1e-5, 1e-6


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _x(shape, rows, seed=1):
    return np.random.default_rng(seed).standard_normal(
        (rows,) + tuple(shape)).astype(np.float32)


def test_the_chains_cover_every_kind_and_activation(tmp_path):
    kinds, acts = set(), set()
    for name in CHAINS:
        path, _ = write_chain(tmp_path / f"{name}.znn", name)
        for la in export.read_znn(path):
            kinds.add(la.kind)
            if la.kind in ("fc", "conv", "deconv", "activation"):
                acts.add(la.activation)
    assert kinds == set(export.KIND)
    assert acts == set(export.ACT)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_torch_forward_matches_jax_forward(name, tmp_path):
    path, shape = write_chain(tmp_path / f"{name}.znn", name)
    layers, ref_layers = export.read_znn(path), ref_export.read_znn(path)
    assert engine.output_features(layers, shape) == \
        ref_engine.output_features(ref_layers, shape)
    x = _x(shape, 5)
    want = np.asarray(ref_engine.jax_forward(ref_layers, x))
    got = engine.torch_forward(layers, torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (5, engine.output_features(layers,
                                                                 shape))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_quantize_layers_equals_the_reference(name, tmp_path):
    path, _ = write_chain(tmp_path / f"{name}.znn", name)
    got, n = engine.quantize_layers(export.read_znn(path))
    want, m = ref_engine.quantize_layers(ref_export.read_znn(path))
    assert n == m
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            for a, b in zip(g, w):
                assert a.dtype == b.dtype
                assert np.array_equal(a, b)


def _write_rows(path, rows):
    with open(str(path) + ".tmp", "wb") as fh:
        export._write_header(fh, len(rows))
        for row in rows:
            export._pack_layer(fh, *row)
    return export._commit_znn(str(path))


def test_int8_forward_matches_the_reference_where_f32_sums_exactly(tmp_path):
    """K = 16: |Σ xq·wq| ≤ 16·127² < 2²⁴, so the reference's float32
    accumulation of the int8 products is exact, as the port's int32
    one is."""
    rng = np.random.default_rng(3)
    K, A = export.KIND, export.ACT
    path = _write_rows(tmp_path / "q.znn", [
        (K["fc"], A["tanh"], [16, 12], rng.normal(0, 0.3, (16, 12)),
         rng.normal(0, 0.1, 12)),
        (K["fc"], A["linear"], [12, 5], rng.normal(0, 0.3, (12, 5)),
         rng.normal(0, 0.1, 5)),
        (K["softmax"], 0, [])])
    layers, ref_layers = export.read_znn(path), ref_export.read_znn(path)
    q, _ = engine.quantize_layers(layers)
    params = [(torch.from_numpy(e[0]), torch.from_numpy(la.b),
               torch.from_numpy(e[1])) if e is not None else (None, None)
              for la, e in zip(layers, q)]
    ref_params = [(e[0], la.b, e[1]) if e is not None else (la.w, la.b)
                  for la, e in zip(ref_layers, q)]
    x = _x((16,), 9)
    x[3] = 0.0                               # a zero row keeps scale 1
    got = engine.torch_forward(layers, torch.from_numpy(x), params).numpy()
    want = np.asarray(ref_engine.jax_forward(ref_layers, x, ref_params))
    np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    # and the engines agree on whether int8 serves
    port = ServingEngine(path, backend="cpu", buckets=(1, 8),
                         quantize="int8")
    ref = ref_engine.ServingEngine(path, backend="jax", buckets=(1, 8),
                                   quantize="int8")
    assert port.quantized_active() and ref.quantized_active()
    np.testing.assert_allclose(port.predict(x), ref.predict(x), rtol=RTOL,
                               atol=ATOL)
    assert port.metrics()["quantize_mode"] == "int8"


def test_int8_falls_back_as_the_reference(tmp_path):
    path, _ = write_chain(tmp_path / "conv.znn", "conv")   # conv first
    counter = registry.REGISTRY.counter("quantize_fallback_total")
    before = counter.value(reason="unsupported")
    port = ServingEngine(path, backend="cpu", quantize="int8")
    ref = ref_engine.ServingEngine(path, backend="jax", quantize="int8")
    assert not port.quantized_active() and not ref.quantized_active()
    assert counter.value(reason="unsupported") == before + 1
    assert port.metrics()["quantize_fallbacks"] == \
        ref.metrics()["quantize_fallbacks"] == 1


#: metrics both engines keep the same way over one call sequence
SAME = ("cache_hits", "cache_misses", "cache_evictions",
        "cached_executables", "forward_calls", "rows_in", "padded_rows",
        "fallback_calls", "forward_failures", "retries", "generation",
        "reloads", "weight_pageins", "weight_releases", "buckets",
        "quantized", "weights_resident", "weight_bytes")


def _same(port, ref):
    pm, rm = port.metrics(), ref.metrics()
    assert {k: pm.get(k, 0) for k in SAME} == {k: rm.get(k, 0)
                                               for k in SAME}
    assert pm["breaker"] == rm["breaker"]


@pytest.mark.parametrize("name", ["mlp", "conv", "decoder"])
def test_engine_matches_the_reference_engine(name, tmp_path):
    path, shape = write_chain(tmp_path / f"{name}.znn", name)
    port = ServingEngine(path, backend="cpu", buckets=(1, 8, 32),
                         cache_size=2)
    ref = ref_engine.ServingEngine(path, backend="jax", buckets=(1, 8, 32),
                                   cache_size=2)
    # bucket 1, 8 (padded, full), 32, 8 again (evicted), a chunked 70
    for i, rows in enumerate((1, 5, 8, 20, 3, 70, 1)):
        x = _x(shape, rows, seed=i)
        got, want = port.predict(x), ref.predict(x)
        assert got.shape == want.shape == (rows, engine.output_features(
            port.layers, shape))
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    _same(port, ref)
    assert port.metrics()["cache_evictions"] > 0
    assert port.metrics()["builds"] == port.metrics()["cache_misses"]
    # the padded rows never leak into the real ones
    x = _x(shape, 5, seed=9)
    np.testing.assert_array_equal(port.predict(x)[:3], port.predict(x[:3]))


def test_reload_outcomes_and_generations_match_the_reference(tmp_path):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    second, _ = write_chain(tmp_path / "mlp2.znn", "mlp", seed=1)
    corrupt, _ = write_chain(tmp_path / "bad.znn", "mlp", seed=2)
    blob = bytearray(open(corrupt, "rb").read())
    blob[len(blob) // 2] ^= 0x01
    open(corrupt, "wb").write(bytes(blob))
    K, A = export.KIND, export.ACT
    poison = _write_rows(tmp_path / "poison.znn", [
        (K["fc"], A["linear"], [784, 10], np.zeros((784, 10)),
         np.full(10, np.inf))])
    port = ServingEngine(path, backend="cpu", buckets=(1, 8))
    ref = ref_engine.ServingEngine(path, backend="jax", buckets=(1, 8))
    x = _x(shape, 3)
    before = port.predict(x)
    ref.predict(x)
    for target, outcome, gen in ((second, "ok", 2),
                                 (corrupt, "verify_failed", 2),
                                 (poison, "canary_failed", 2),
                                 (path, "ok", 3)):
        got, want = port.reload(target), ref.reload(target)
        assert (got["outcome"], got["generation"], got["canary"]) == \
            (want["outcome"], want["generation"], want["canary"])
        assert (got["outcome"], got["generation"]) == (outcome, gen)
        assert port.reload_status()["model_generation"] == gen
        np.testing.assert_allclose(port.predict(x), ref.predict(x),
                                   rtol=RTOL, atol=ATOL)
    np.testing.assert_array_equal(port.predict(x), before)
    ref.predict(x)
    _same(port, ref)


def test_weight_release_pages_in_again(tmp_path):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    port = ServingEngine(path, backend="cpu", buckets=(8,))
    x = _x(shape, 8)
    y = port.predict(x)
    assert port.resident_weight_bytes() == port.weight_nbytes() > 0
    assert port.release_weights() == port.weight_nbytes()
    assert port.release_weights() == 0
    m = port.metrics()
    assert not m["weights_resident"] and m["cached_executables"] == 0
    np.testing.assert_array_equal(port.predict(x), y)
    m = port.metrics()
    assert (m["weight_pageins"], m["builds"], m["cache_misses"]) == (2, 2, 2)
    assert port.ensure_weights() is False


def _faulted(plan_mod, n_errors):
    return plan_mod.FaultPlan([plan_mod.FaultSpec(
        site="engine.forward", kind="error", times=n_errors)], seed=0)


def test_injected_faults_open_the_breaker_as_the_reference(tmp_path):
    """Two predicts each exhaust two attempts (four injected faults):
    the second trips the breaker, every answer comes from the native
    engine, the third predict goes straight to it."""
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    engines = {}
    for pkg, (eng_mod, br, rt) in {
            "port": (engine, breaker, retry),
            "ref": (ref_engine, ref_breaker, ref_retry)}.items():
        kw = {"backend": "cpu" if pkg == "port" else "jax"}
        engines[pkg] = eng_mod.ServingEngine(
            path, buckets=(1, 8),
            retry=rt.RetryPolicy(max_attempts=2, base_delay_s=0.0,
                                 jitter=0.0),
            breaker=br.CircuitBreaker(failure_threshold=2,
                                      cooldown_s=3600.0), **kw)
    x = _x(shape, 4)
    clean = engines["port"].predict(x)
    engines["ref"].predict(x)
    answers = {}
    for pkg, mod in (("port", faults), ("ref", ref_faults)):
        with _faulted(mod, 4):
            answers[pkg] = [engines[pkg].predict(x) for _ in range(3)]
    _same(engines["port"], engines["ref"])
    m = engines["port"].metrics()
    assert (m["retries"], m["forward_failures"], m["fallback_calls"]) == \
        (2, 2, 3)
    assert m["breaker"]["state"] == "open"
    assert engines["port"].resilience_state() == "degraded"
    for got, want in zip(answers["port"], answers["ref"]):
        np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
        np.testing.assert_allclose(got, clean, rtol=1e-4, atol=1e-5)


def _load_missing_library(tmp_path, monkeypatch):
    """A wrapper whose kernel library cannot be loaded: the real
    ``cuda_build.kernel`` on a build that left no loadable ``.so``."""
    monkeypatch.setattr(cuda_build, "_loaded", {})
    monkeypatch.setattr(cuda_build, "_functions", {})
    monkeypatch.setattr(cuda_build, "build_all", lambda names: {
        n: tmp_path / f"lib{n}-missing.so" for n in names})

    def wrapper(act, x):
        cuda_build.kernel("activation", "znicz_act_fwd_f32", [])
    return OSError, wrapper


def _raising(error):
    def make(tmp_path, monkeypatch):
        def wrapper(act, x):
            raise error
        return type(error), wrapper
    return make


@pytest.mark.parametrize("make", [
    _raising(cuda_build.BuildError("nvcc failed on csrc/activation.cu")),
    _raising(cuda_build.LaunchError(
        "znicz_act_fwd_f32 launch failed: CUDA error 9")),
    _raising(RuntimeError(
        "CUDA error: an illegal memory access was encountered")),
    _raising(RuntimeError(
        "Expected all tensors to be on the same device, but found at "
        "least two devices, cuda:0 and cpu!")),
    _raising(RuntimeError("self.size(0) needs to be greater than 16, but "
                          "got 1")),
    _raising(OSError("libcudart.so.12: cannot open shared object file")),
    _load_missing_library],
    ids=["build", "launch", "cuda", "device_mismatch", "int_mm_rows",
         "os_error", "load"])
@pytest.mark.parametrize("policy", ["engine", "default"])
def test_a_kernel_error_reaches_the_caller(make, policy, tmp_path,
                                            monkeypatch):
    """Whatever the forward raises of its own reaches the caller at once,
    under the engine's retry policy and under one that would retry it."""
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, backend="cpu", retry=None if policy ==
                        "engine" else retry.RetryPolicy(base_delay_s=0.0))
    kind, wrapper = make(tmp_path, monkeypatch)
    monkeypatch.setattr(activations, "apply_fwd", wrapper)
    with pytest.raises(kind) as info:
        eng.predict(_x(shape, 3))
    assert not engine.engine_transient(info.value)
    m = eng.metrics()
    assert (m["fallback_calls"], m["forward_failures"], m["retries"]) == \
        (0, 0, 0)
    assert m["breaker"]["state"] == "closed"
    assert eng.resilience_state() == "ok"


def test_what_stays_transient(tmp_path):
    """Only a fault injected at the forward's site, and a per-attempt
    timeout: the same error types raised anywhere else are not."""
    assert engine.engine_transient(retry.AttemptTimeout("x"))
    for error in (faults.FaultInjected("x"), OSError("relay dropped")):
        assert not engine.engine_transient(error)
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, backend="cpu", buckets=(1, 8))
    x = _x(shape, 3)
    want = eng.predict(x)
    # three injected OSErrors: the engine's policy tries three times and
    # the native engine answers
    with faults.FaultPlan([faults.FaultSpec(
            site="engine.forward", exc="OSError", times=3)], seed=0):
        np.testing.assert_allclose(eng.predict(x), want, rtol=1e-4,
                                   atol=1e-5)
    m = eng.metrics()
    assert (m["retries"], m["forward_failures"], m["fallback_calls"]) == \
        (2, 1, 1)
    # an injected deterministic error is not retried either
    with faults.FaultPlan([faults.FaultSpec(
            site="engine.forward", exc="ValueError", times=1)], seed=0):
        with pytest.raises(ValueError, match="site=engine.forward"):
            eng.predict(x)
    assert eng.metrics()["retries"] == 2


def test_refusals(tmp_path, monkeypatch):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match='backend="cpu"'):
        ServingEngine(path)
    with pytest.raises(NotImplementedError, match="queue 1 item 9"):
        ServingEngine(path, backend="cpu", tp=2)
    with pytest.raises(ValueError, match="tensor-parallel"):
        ServingEngine(path, backend="cpu", tp=2, quantize="int8")
    with pytest.raises(ValueError, match="unknown backend"):
        ServingEngine(path, backend="auto")
    with pytest.raises(ValueError):
        ServingEngine(path, backend="cpu", buckets=(8, 1))
    eng = ServingEngine(path, backend="cpu")
    empty = flightrecorder.FlightRecorder()
    assert eng.warmup_from_census(recorder=empty) == 0
    with pytest.raises(ValueError, match="fc expects"):
        eng.warmup_from_census(recorder=empty, fallback_shape=(783,))
    with pytest.raises(ValueError):
        eng.predict(np.zeros((0, 784), np.float32))
    with pytest.raises(ValueError):
        eng.predict(np.zeros((2, 783), np.float32))
    assert eng.metrics()["fallback_calls"] == 0


def test_warmup_builds_each_bucket_once(tmp_path):
    path, shape = write_chain(tmp_path / "conv.znn", "conv")
    port = ServingEngine(path, backend="cpu", buckets=(1, 8, 32))
    ref = ref_engine.ServingEngine(path, backend="jax", buckets=(1, 8, 32))
    assert port.warmup(shape) == ref.warmup(shape) == 3
    assert port.warmup(shape) == ref.warmup(shape) == 0
    port.predict(_x(shape, 2))
    ref.predict(_x(shape, 2))
    _same(port, ref)


def test_live_workflow_source(tmp_path):
    from znicz_tpu_torch import prng
    from znicz_tpu_torch.config import root
    from znicz_tpu_torch.models import mnist
    saved = root.mnist.synthetic.to_dict()
    root.mnist.synthetic.update({"n_train": 100, "n_valid": 20,
                                 "n_test": 20})
    try:
        prng.seed_all(3)
        wf = mnist.MnistWorkflow()
        wf.initialize(device="cpu")
    finally:
        root.mnist.synthetic.update(saved)
    eng = ServingEngine(wf, backend="cpu", buckets=(1, 8))
    try:
        y = eng.predict(np.asarray(wf.loader.original_data[:5], np.float32))
        assert y.shape == (5, 10)
        np.testing.assert_allclose(y.sum(axis=1), 1.0, rtol=1e-5)
    finally:
        eng.close()


# -- the micro-batcher ---------------------------------------------------------
class FakeEngine:
    """Counts forward calls; y = Σx → (B, 1)."""

    def __init__(self, delay: float = 0.0):
        self.calls = 0
        self.delay = delay
        self._lock = threading.Lock()

    def predict(self, x):
        with self._lock:
            self.calls += 1
        if self.delay:
            time.sleep(self.delay)
        return np.asarray(x).reshape(len(x), -1).sum(axis=1, keepdims=True)


def test_batcher_coalesces_concurrent_requests(tmp_path):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, backend="cpu", buckets=(1, 8, 32))
    n, rows = 24, _x(shape, 24)
    alone = [eng.predict(rows[i:i + 1]) for i in range(n)]
    calls = eng.metrics()["forward_calls"]
    mb = MicroBatcher(eng, max_batch=8, max_wait_ms=150, max_queue=64)
    results = [None] * n
    barrier = threading.Barrier(n)

    def worker(i):
        barrier.wait()
        results[i] = mb.predict(rows[i:i + 1], timeout=30.0)
    try:
        threads = [threading.Thread(target=worker, args=(i,))
                   for i in range(n)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(30.0)
    finally:
        mb.close()
    forwards = eng.metrics()["forward_calls"] - calls
    assert forwards <= math.ceil(n / 8)
    for got, want in zip(results, alone):
        np.testing.assert_allclose(got, want, rtol=RTOL, atol=ATOL)
    m = mb.metrics()
    assert m["completed"] == n and m["forward_calls"] == forwards


def test_batcher_full_queue_raises_queue_full():
    fake = FakeEngine(delay=0.15)
    mb = MicroBatcher(fake, max_batch=2, max_wait_ms=1, max_queue=4)
    try:
        admitted, rejected = [], 0
        for _ in range(12):
            try:
                admitted.append(mb.submit(np.ones((1, 4), np.float32)))
            except QueueFull as e:
                rejected += 1
                assert e.retry_after >= 1
        assert rejected > 0
        for req in admitted:
            assert req.event.wait(30.0) and req.error is None
        m = mb.metrics()
        assert m["completed"] + m["rejected"] == 12
    finally:
        mb.close()


def test_batcher_deadline_expires_in_queue():
    fake = FakeEngine(delay=0.3)
    mb = MicroBatcher(fake, max_batch=1, max_wait_ms=1, max_queue=64)
    try:
        blocker = mb.submit(np.ones((1, 4), np.float32))
        doomed = mb.submit(np.ones((1, 4), np.float32), deadline_ms=50)
        assert doomed.event.wait(30.0)
        assert isinstance(doomed.error, DeadlineExceeded)
        assert blocker.event.wait(30.0) and blocker.error is None
        assert mb.metrics()["expired"] == 1
    finally:
        mb.close()


def test_engine_unavailable_without_a_fallback(tmp_path, monkeypatch):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, backend="cpu",
                        breaker=breaker.CircuitBreaker(failure_threshold=1,
                                                       cooldown_s=3600.0),
                        retry=retry.RetryPolicy(max_attempts=1))
    monkeypatch.setattr(export, "NativeEngine", None)   # cannot load
    with _faulted(faults, 1):
        with pytest.raises(EngineUnavailable) as info:
            eng.predict(_x(shape, 2))
    assert info.value.retry_after >= 1
    assert eng.resilience_state() == "open"


# -- the primitives, driven alike in both packages ----------------------------
class _Clock:
    def __init__(self):
        self.t = 0.0

    def __call__(self):
        return self.t


def _drive_breaker(mod) -> list:
    clock = _Clock()
    b = mod.CircuitBreaker(failure_threshold=3, cooldown_s=5.0, clock=clock)
    trace = []
    for step in ("f", "f", "s", "f", "f", "f", "a", "t6", "a", "a", "f",
                 "t12", "a", "s", "a"):
        if step == "f":
            b.record_failure()
        elif step == "s":
            b.record_success()
        elif step == "a":
            trace.append(b.allow())
        else:
            clock.t = float(step[1:])
        trace.append((b.state, round(b.retry_after(), 6)))
    trace.append(b.metrics())
    return trace


def test_breaker_states_are_the_reference():
    assert _drive_breaker(breaker) == _drive_breaker(ref_breaker)


def test_retry_schedule_is_the_reference():
    for seed in (0, 7):
        got = retry.RetryPolicy(base_delay_s=0.01, max_delay_s=0.3,
                                jitter=0.5, seed=seed)
        want = ref_retry.RetryPolicy(base_delay_s=0.01, max_delay_s=0.3,
                                     jitter=0.5, seed=seed)
        assert [got.backoff_s(i) for i in range(1, 9)] == \
            [want.backoff_s(i) for i in range(1, 9)]
    slept = {"port": [], "ref": []}
    for key, mod in (("port", retry), ("ref", ref_retry)):
        calls = []

        def flaky():
            calls.append(1)
            if len(calls) < 3:
                raise OSError("blip")
            return len(calls)
        policy = mod.RetryPolicy(max_attempts=4, base_delay_s=0.01,
                                 seed=3, sleep=slept[key].append)
        assert policy.call(flaky) == 3
    assert slept["port"] == slept["ref"]


def _drive_registry(mod) -> str:
    reg = mod.MetricsRegistry()
    c = reg.counter("requests_total", "requests by outcome")
    g = reg.gauge("queue_depth", "rows queued")
    h = reg.histogram("latency_ms", "latency", buckets=(1.0, 5.0, 25.0))
    for i in range(7):
        c.inc(outcome="ok" if i % 3 else "error")
        h.observe(float(i * 4), model="m")
    g.set(3, model="m")
    g.set(5, model='a"b')
    return reg.render_prometheus()


def test_registry_prometheus_text_is_the_reference():
    got, want = _drive_registry(registry), _drive_registry(ref_registry)
    assert got == want
    assert "latency_ms_bucket" in got


def test_jnp_and_torch_take_the_same_zero_row_scale():
    """The int8 path's row scale: a zero row keeps 1 in both."""
    h = np.array([[0.0, 0.0], [1.0, -2.5]], np.float32)
    amax = np.abs(h).max(axis=1, keepdims=True)
    want = np.asarray(jnp.where(amax > 0, amax / 127.0, 1.0))
    t = torch.from_numpy(amax)
    got = torch.where(t > 0, t / 127.0, torch.ones_like(t)).numpy()
    np.testing.assert_array_equal(got, want)


def test_the_collector_is_off_while_a_graph_records(monkeypatch):
    from znicz_tpu_torch.parallel import capture

    class Stream:
        device = torch.device("cpu")

        def wait_stream(self, other):
            pass

    recording = []

    @contextlib.contextmanager
    def graph(g, pool=None, stream=None, capture_error_mode=None):
        assert capture_error_mode == "thread_local"
        recording.append(gc.isenabled())
        yield

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph", graph)
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    runs = []
    assert gc.isenabled()
    capture.capture(lambda: runs.append(gc.isenabled()), Stream(), None)
    # the eager run collects as usual; the recorded run does not
    assert runs == [True, False] and recording == [False]
    assert gc.isenabled()
    # a capture that raises turns the collector on again too
    with pytest.raises(RuntimeError):
        capture.capture(lambda: (_ for _ in ()).throw(RuntimeError("x"))
                        if not gc.isenabled() else None, Stream(), None)
    assert gc.isenabled()


def test_one_capture_at_a_time(monkeypatch):
    """A second thread's capture waits until the first one has recorded,
    so neither turns the collector back on under the other."""
    import threading

    from znicz_tpu_torch.parallel import capture

    class Stream:
        device = torch.device("cpu")

        def wait_stream(self, other):
            pass

    monkeypatch.setattr(torch.cuda, "CUDAGraph", lambda: object())
    monkeypatch.setattr(torch.cuda, "graph",
                        lambda *a, **k: contextlib.nullcontext())
    monkeypatch.setattr(torch.cuda, "current_stream",
                        lambda device=None: Stream())
    monkeypatch.setattr(torch.cuda, "stream",
                        lambda s: contextlib.nullcontext())
    recording, release = threading.Event(), threading.Event()
    order = []

    def first():
        order.append("first")
        if len(order) == 2:             # the recorded run: hold it open
            recording.set()
            release.wait(10.0)

    def second():
        order.append("second")
    a = threading.Thread(target=capture.capture, args=(first, Stream(), None))
    a.start()
    assert recording.wait(10.0)
    b = threading.Thread(target=capture.capture,
                         args=(second, Stream(), None))
    b.start()
    b.join(0.3)
    assert b.is_alive() and order == ["first", "first"]
    assert not gc.isenabled()
    release.set()
    a.join(10.0)
    b.join(10.0)
    assert order == ["first", "first", "second", "second"]
    assert gc.isenabled()
