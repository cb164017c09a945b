"""The serving engine on a card (``znicz_tpu_torch.serving``): one CUDA
graph per bucket key, held against the eager forward.

* every layer kind of the ``.znn`` format (the chains of ``CHAINS``: an
  MLP with its softmax head; a conv stack with max and average pooling,
  LRN, dropout and a standalone activation; a conv autoencoder with its
  tied depooling and deconv; a SOM's kohonen head) at buckets 1, 8 and
  32, a padded and a full batch each: the graph's rows bit for bit the
  eager ``torch_forward`` of the same padded batch on the same weights,
  with cuDNN held to its deterministic algorithms;
* one capture a key, then cache hits; each forward's kernel launches as
  ``chip_smoke.serve_launches`` says, the capture's eager run once more, and
  exact when threads predict together through a ``MicroBatcher``;
* the int8 fc on ``torch._int_mm`` (rows padded to 32, K and N to
  multiples of 8) equal to the host's int32 product after dequantizing;
* releasing the weights drops the generation's graphs, and the next
  forward captures again and answers the same bytes;
* a forward that cannot be captured raises to the caller: no retry, no
  native fallback, the breaker closed (last: a failed capture is the
  file's last CUDA work).

Every test needs a CUDA card and skips without one; this file imports no
JAX (tests/test_torch_serving.py holds the forward to the reference on
the CPU)."""

import threading

import numpy as np
import pytest
import torch

import chip_smoke
from znicz_tpu_torch import export, ops
from znicz_tpu_torch.serving import MicroBatcher, ServingEngine
from znicz_tpu_torch.serving import engine as engine_mod

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the serving graphs run only on a "
                                       "card")

K, A = export.KIND, export.ACT


def _mlp(rng):
    return (784,), [
        (K["fc"], A["tanh"], [784, 100], rng.normal(0, 0.05, (784, 100)),
         rng.normal(0, 0.1, 100)),
        (K["fc"], A["linear"], [100, 10], rng.normal(0, 0.1, (100, 10)),
         rng.normal(0, 0.1, 10)),
        (K["softmax"], 0, [], None, None)]


def _conv(rng):
    return (12, 12, 3), [
        (K["conv"], A["tanh"], [3, 3, 3, 6, 1, 1, 1, 1],
         rng.normal(0, 0.3, (3, 3, 3, 6)), rng.normal(0, 0.1, 6)),
        (K["max_pool"], 0, [2, 2, 0, 0, 2, 2, 0, 0], None, None),
        (K["lrn"], 0, [5], np.array([1e-2, 0.75, 2.0]), None),
        (K["activation"], A["sigmoid"], [], None, None),
        (K["avg_pool"], 0, [2, 2, 0, 0, 2, 2, 0, 0], None, None),
        (K["dropout"], 0, [], None, None),
        (K["fc"], A["strict_relu"], [54, 16], rng.normal(0, 0.2, (54, 16)),
         rng.normal(0, 0.1, 16)),
        (K["fc"], A["relu"], [16, 5], rng.normal(0, 0.3, (16, 5)), None),
        (K["softmax"], 0, [], None, None)]


def _autoencoder(rng):
    return (12, 12, 1), [
        (K["conv"], A["linear"], [5, 5, 1, 4, 1, 1, 2, 2],
         rng.normal(0, 0.3, (5, 5, 1, 4)), rng.normal(0, 0.1, 4)),
        (K["max_pool"], 0, [2, 2, 0, 0, 2, 2, 0, 0], None, None),
        (K["depool"], 0, [2, 2, 1, 0, 2, 2, 0, 0], None, None),
        (K["deconv"], A["tanh"], [5, 5, 1, 4, 1, 1, 2, 2],
         rng.normal(0, 0.3, (5, 5, 1, 4)), None)]


def _strided(rng):
    # 13 → conv 3×3 s2 p1 → 7 → max pool 3×3 s2 p1 → 4 → avg pool 2×2 s1
    # p1 → 5
    return (13, 13, 2), [
        (K["conv"], A["relu"], [3, 3, 2, 5, 2, 2, 1, 1],
         rng.normal(0, 0.4, (3, 3, 2, 5)), rng.normal(0, 0.1, 5)),
        (K["max_pool"], 0, [3, 3, 0, 0, 2, 2, 1, 1], None, None),
        (K["lrn"], 0, [3], np.array([1e-3, 0.6, 1.0]), None),
        (K["avg_pool"], 0, [2, 2, 0, 0, 1, 1, 1, 1], None, None),
        (K["activation"], A["tanh"], [], None, None),
        (K["fc"], A["linear"], [125, 6], rng.normal(0, 0.1, (125, 6)),
         None)]


def _decoder(rng):
    # a pool that does not divide its input (13 → 6, depooled back to the
    # recorded 13) and a strided deconv with a bias (13 → 25)
    return (13, 13, 2), [
        (K["conv"], A["sigmoid"], [3, 3, 2, 3, 1, 1, 1, 1],
         rng.normal(0, 0.4, (3, 3, 2, 3)), rng.normal(0, 0.1, 3)),
        (K["max_pool"], 0, [2, 2, 0, 0, 2, 2, 0, 0], None, None),
        (K["depool"], 0, [2, 2, 1, 0, 2, 2, 0, 0], None, None),
        (K["deconv"], A["linear"], [3, 3, 4, 3, 2, 2, 1, 1],
         rng.normal(0, 0.4, (3, 3, 4, 3)), rng.normal(0, 0.1, 4))]


def _som(rng):
    return (2,), [(K["kohonen"], 0, [16, 2], rng.normal(0, 1, (16, 2)),
                   None)]


#: name → (sample shape, [(kind, activation, geometry, w, b)]); together
#: every layer kind and activation of the format
CHAINS = {"mlp": _mlp, "conv": _conv, "autoencoder": _autoencoder,
          "strided": _strided, "decoder": _decoder, "som": _som}


def write_chain(path, name: str, seed: int = 0):
    """Write chain ``name`` of CHAINS with seeded weights through the
    exporter's own writer (header, rows, commit with its manifest);
    returns (path, sample shape)."""
    shape, rows = CHAINS[name](np.random.default_rng(seed))
    with open(str(path) + ".tmp", "wb") as fh:
        export._write_header(fh, len(rows))
        for kind, act, geo, w, b in rows:
            export._pack_layer(fh, kind, act, geo, w, b)
    return export._commit_znn(str(path)), shape


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(autouse=True)
def deterministic():
    prev = torch.backends.cudnn.deterministic
    torch.backends.cudnn.deterministic = True
    yield
    torch.backends.cudnn.deterministic = prev


def _per_forward(eng) -> dict:
    """{(module, counter): n} of one forward of ``eng``'s layers."""
    return {chip_smoke.KERNELS[k][2:]: n
            for k, n in chip_smoke.serve_launches(eng.layers).items()}


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launch_counts().items()
            if v != before[k]}


def _times(counts: dict, n: int) -> dict:
    return {k: v * n for k, v in counts.items() if v}


@pytest.mark.parametrize("name", sorted(CHAINS))
def test_graphs_equal_the_eager_forward_bit_for_bit(name, tmp_path):
    path, shape = write_chain(tmp_path / f"{name}.znn", name)
    eng = ServingEngine(path, buckets=(1, 8, 32))
    params = eng._current().params()
    rng = np.random.default_rng(1)
    for bucket in eng.buckets:
        for rows in sorted({max(1, bucket - 3), bucket}):
            x = rng.standard_normal((rows,) + shape).astype(np.float32)
            got = eng.predict(x)
            padded = np.zeros((bucket,) + shape, np.float32)
            padded[:rows] = x
            want = engine_mod.torch_forward(
                eng.layers, torch.from_numpy(padded).cuda(), params)
            want = want.cpu().numpy()
            assert np.isfinite(want).all()       # the padded rows too
            want = want[:rows]
            assert got.shape == want.shape
            assert np.array_equal(got.view(np.int32), want.view(np.int32))
            # other rows in the bucket do not move the real ones
            half = max(1, rows // 2)
            assert np.array_equal(eng.predict(x[:half]).view(np.int32),
                                  got[:half].view(np.int32))
    m = eng.metrics()
    assert m["builds"] == len(eng.buckets)
    assert m["fallback_calls"] == 0 and m["breaker"]["state"] == "closed"


@pytest.mark.parametrize("name", ["mlp", "conv", "autoencoder"])
def test_one_capture_a_key_and_the_launches_a_replay_adds(name, tmp_path):
    path, shape = write_chain(tmp_path / f"{name}.znn", name)
    eng = ServingEngine(path, buckets=(1, 8))
    per = _per_forward(eng)
    x = np.random.default_rng(2).standard_normal((5,) + shape).astype(
        np.float32)
    before = ops.launch_counts()
    first = eng.predict(x)
    # the capture's eager run, then the replay that answered
    assert _moved(before) == _times(per, 2)
    before = ops.launch_counts()
    for _ in range(3):
        assert np.array_equal(eng.predict(x), first)
    assert _moved(before) == _times(per, 3)
    m = eng.metrics()
    assert (m["builds"], m["cache_misses"], m["cache_hits"]) == (1, 1, 3)
    assert m["cached_executables"] == 1


def test_threads_and_the_batcher_keep_the_counts_exact(tmp_path):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, buckets=(1, 8, 32))
    per = _per_forward(eng)
    x = np.random.default_rng(3).standard_normal((64,) + shape).astype(
        np.float32)
    alone = [eng.predict(x[i:i + 1]) for i in range(len(x))]
    eng.warmup(shape)
    before_m = eng.metrics()
    before = ops.launch_counts()
    mb = MicroBatcher(eng, max_batch=8, max_wait_ms=150.0, max_queue=256)
    out = [None] * len(x)
    barrier = threading.Barrier(len(x))

    def call(i):
        barrier.wait()
        out[i] = mb.predict(x[i:i + 1], timeout=60.0)
    threads = [threading.Thread(target=call, args=(i,))
               for i in range(len(x))]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    mb.close()
    forwards = eng.metrics()["forward_calls"] - before_m["forward_calls"]
    assert forwards <= -(-len(x) // 8)
    assert _moved(before) == _times(per, forwards)
    for i in range(len(x)):
        np.testing.assert_allclose(out[i], alone[i], rtol=1e-5, atol=1e-6)
    # two threads capturing different keys at once: one graph each
    eng2 = ServingEngine(path, buckets=(1, 8, 32))
    before = ops.launch_counts()
    errs = []

    def burst(rows):
        try:
            for _ in range(4):
                eng2.predict(x[:rows])
        except Exception as e:      # noqa: BLE001 — reported below
            errs.append(e)
    ts = [threading.Thread(target=burst, args=(r,)) for r in (1, 5, 20)]
    for t in ts:
        t.start()
    for t in ts:
        t.join()
    assert not errs
    assert eng2.metrics()["builds"] == 3
    assert _moved(before) == _times(per, 3 * 4 + 3)


def test_int8_fc_on_int_mm_equals_the_host_product(tmp_path):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    card = ServingEngine(path, buckets=(1, 8), quantize="int8")
    host = ServingEngine(path, buckets=(1, 8), quantize="int8",
                         backend="cpu")
    assert card.quantized_active() and host.quantized_active()
    x = np.random.default_rng(4).standard_normal((7,) + shape).astype(
        np.float32)
    np.testing.assert_allclose(card.predict(x), host.predict(x), rtol=1e-6,
                               atol=1e-7)
    xq = torch.randint(-127, 128, (3, 100), dtype=torch.int8)
    wq = torch.randint(-127, 128, (100, 10), dtype=torch.int8)
    want = xq.to(torch.int32) @ wq.to(torch.int32)
    got = engine_mod._int8_product(xq.cuda(), wq.cuda()).cpu()
    assert torch.equal(got, want)


def test_releasing_the_weights_drops_the_graphs(tmp_path):
    path, shape = write_chain(tmp_path / "conv.znn", "conv")
    eng = ServingEngine(path, buckets=(8,))
    x = np.random.default_rng(5).standard_normal((8,) + shape).astype(
        np.float32)
    first = eng.predict(x)
    assert eng.release_weights() == eng.weight_nbytes()
    m = eng.metrics()
    assert m["cached_executables"] == 0 and not m["weights_resident"]
    again = eng.predict(x)
    assert np.array_equal(first, again)
    m = eng.metrics()
    assert m["builds"] == 2 and m["weight_pageins"] == 2


def test_a_failing_capture_raises_to_the_caller(tmp_path, monkeypatch):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, buckets=(1,))
    real = engine_mod.torch_forward

    def syncing(layers, x, params=None):
        y = real(layers, x, params)
        y.sum().item()                           # a host sync
        return y
    monkeypatch.setattr(engine_mod, "torch_forward", syncing)
    x = np.zeros((1,) + shape, np.float32)
    with pytest.raises(RuntimeError) as info:
        eng.predict(x)
    assert not engine_mod.engine_transient(info.value), type(info.value)
    torch.cuda.synchronize()
    m = eng.metrics()
    assert m["fallback_calls"] == 0 and m["retries"] == 0
    assert m["breaker"]["state"] == "closed" and m["builds"] == 0
