"""The port's HTTP serving tier on a card (``znicz_tpu_torch.serving``:
``ServingServer`` over a ``ModelZoo`` of two CUDA engines, each with its
own micro-batcher and dispatch thread).

* first requests of both models from several threads at once: one model
  captures its bucket graphs while the other's thread replays; every
  answer over the binary wire is within rtol 1e-5 of the eager forward
  on the card (a request may ride a coalesced batch of another bucket,
  where cuBLAS sums in another order), bit for bit when sent alone
  (cuDNN held deterministic), and the launches equal each engine's
  launches a forward times its forwards and captures;
* a memory budget that holds one model: the two alternate from threads,
  each request pages its model in (after the other's eviction) and
  captures again; the answers stay the same bytes, the launch counts
  exact, ``fallback_calls`` 0 and the breakers closed;
* a binary request's read-only body is served without a copy beyond the
  padding.

Every test needs a CUDA card and skips without one; this file imports no
JAX (tests/test_torch_http.py holds the tier to the reference on the
CPU)."""

import http.client
import threading

import numpy as np
import pytest
import torch

import chip_smoke
from znicz_tpu_torch import ops
from znicz_tpu_torch.serving import ModelZoo, ServingEngine, ServingServer
from znicz_tpu_torch.serving import wire
from znicz_tpu_torch.serving.engine import torch_forward
from test_torch_serving_card import write_chain

pytestmark = pytest.mark.skipif("not torch.cuda.is_available()",
                                reason="the serving graphs run only on a "
                                       "card")


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
    return {chip_smoke.KERNELS[k][2:]: n
            for k, n in chip_smoke.serve_launches(eng.layers).items()}


def _moved(before: dict) -> dict:
    return {k: v - before[k] for k, v in ops.launch_counts().items()
            if v != before[k]}


def _predict(server, name, x):
    host, port = server.server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=120)
    try:
        conn.request("POST", "/predict", body=wire.encode_tensor(x),
                     headers={"Content-Type": wire.CONTENT_TYPE,
                              "Accept": wire.CONTENT_TYPE,
                              "X-Model": name})
        r = conn.getresponse()
        body = r.read()
        assert r.status == 200, body[:300]
        return np.array(wire.decode_tensor(body))
    finally:
        conn.close()


def _eager(eng, x):
    """Each row's answer from the eager forward of its padded bucket."""
    bucket = eng.bucket_for(len(x))
    padded = np.zeros((bucket,) + x.shape[1:], np.float32)
    padded[:len(x)] = x
    y = torch_forward(eng.layers, torch.from_numpy(padded).cuda())
    return y.cpu().numpy()[:len(x)]


def _zoo(tmp_path, budget=None):
    z = ModelZoo(memory_budget_bytes=budget)
    shapes = {}
    for name in ("mlp", "conv"):
        path, shapes[name] = write_chain(tmp_path / f"{name}.znn", name)
        z.add(name, engine=ServingEngine(path, buckets=(1, 8, 32)))
    return z, shapes


def _drive(server, zoo, shapes, plan):
    """Send ``plan`` ([(model, rows, seed), ...]) from one thread a
    request, all released together; returns the answers and each
    request's inputs."""
    xs = [np.random.default_rng(seed).uniform(
        -1, 1, (rows,) + shapes[name]).astype(np.float32)
        for name, rows, seed in plan]
    out = [None] * len(plan)
    errs = []
    barrier = threading.Barrier(len(plan))

    def client(i):
        try:
            barrier.wait()
            out[i] = _predict(server, plan[i][0], xs[i])
        except Exception as e:              # noqa: BLE001 — raised below
            errs.append(e)
    threads = [threading.Thread(target=client, args=(i,))
               for i in range(len(plan))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(300)
    if errs:
        raise errs[0]
    return xs, out


def _check(zoo, before_m, before, plan, xs, out):
    torch.cuda.synchronize()
    moved = _moved(before)
    want = {}
    for e in zoo.entries():
        m = e.engine.metrics()
        assert m["fallback_calls"] == 0
        assert m["breaker"]["state"] == "closed"
        calls = (m["forward_calls"] - before_m[e.name]["forward_calls"]
                 + m["builds"] - before_m[e.name]["builds"])
        for k, n in _per_forward(e.engine).items():
            want[k] = want.get(k, 0) + n * calls
    assert moved == {k: v for k, v in want.items() if v}
    for (name, _rows, _seed), x, y in zip(plan, xs, out):
        eng = zoo.resolve(name).engine
        # a request may share its batch with others: its rows are the
        # eager forward of some padded batch; alone it is this one
        np.testing.assert_allclose(y, _eager(eng, x), rtol=1e-5,
                                   atol=1e-6)


def _metrics(zoo):
    return {e.name: e.engine.metrics() for e in zoo.entries()}


def test_first_requests_capture_while_the_other_model_replays(tmp_path):
    zoo, shapes = _zoo(tmp_path)
    server = ServingServer(zoo=zoo, max_batch=32, max_wait_ms=2.0).start()
    try:
        # the MLP warm first, so its thread replays while the conv
        # model's first requests capture
        _predict(server, "mlp", np.zeros((1,) + shapes["mlp"], np.float32))
        before_m, before = _metrics(zoo), ops.launch_counts()
        plan = ([("mlp", r, 100 + i) for i, r in enumerate(
            (1, 3, 1, 7, 20, 1, 5, 2))]
            + [("conv", r, 200 + i) for i, r in enumerate(
                (1, 6, 25, 1, 8, 3))])
        xs, out = _drive(server, zoo, shapes, plan)
        _check(zoo, before_m, before, plan, xs, out)
        assert zoo.resolve("conv").engine.metrics()["builds"] >= 1
        # alone, a request's answer is bit for bit its padded batch's
        # eager forward
        for name in ("mlp", "conv"):
            x = np.random.default_rng(7).uniform(
                -1, 1, (5,) + shapes[name]).astype(np.float32)
            y = _predict(server, name, x)
            assert np.array_equal(y.view(np.int32), _eager(
                zoo.resolve(name).engine, x).view(np.int32))
    finally:
        server.stop()
        zoo.close()


def test_page_ins_after_evictions_capture_again(tmp_path):
    zoo, shapes = _zoo(tmp_path)
    sizes = {e.name: e.engine.weight_nbytes() for e in zoo.entries()}
    zoo.memory_budget = max(sizes.values()) + 1        # one at a time
    server = ServingServer(zoo=zoo, max_batch=8, max_wait_ms=1.0).start()
    try:
        first = {n: _predict(server, n, np.ones((2,) + shapes[n],
                                                np.float32) * 0.25)
                 for n in ("mlp", "conv")}
        pageins0 = _metrics(zoo)
        for rnd in range(3):
            before_m, before = _metrics(zoo), ops.launch_counts()
            plan = [(n, r, 300 + 10 * rnd + i) for i, (n, r) in enumerate(
                [("mlp", 1), ("conv", 2), ("mlp", 8), ("conv", 1),
                 ("conv", 5), ("mlp", 3)])]
            xs, out = _drive(server, zoo, shapes, plan)
            _check(zoo, before_m, before, plan, xs, out)
        m = _metrics(zoo)
        assert sum(m[n]["weight_pageins"] - pageins0[n]["weight_pageins"]
                   for n in m) >= 1
        assert sum(m[n]["weight_releases"] for n in m) >= 1
        for n in ("mlp", "conv"):
            again = _predict(server, n, np.ones((2,) + shapes[n],
                                                np.float32) * 0.25)
            assert np.array_equal(again, first[n])
    finally:
        server.stop()
        zoo.close()


def test_read_only_binary_body_is_served(tmp_path):
    path, shape = write_chain(tmp_path / "mlp.znn", "mlp")
    eng = ServingEngine(path, buckets=(1, 8))
    x = np.random.default_rng(1).uniform(-1, 1, (8,) + shape).astype(
        np.float32)
    frame = wire.decode_tensor(wire.encode_tensor(x))
    assert not frame.flags.writeable
    y = eng.predict(frame)            # a full bucket: no padding copy
    assert np.array_equal(y, eng.predict(x.copy()))
    assert np.array_equal(frame, x)   # the request bytes untouched

