"""The port's HTTP serving tier (``znicz_tpu_torch.serving.server``) against
the JAX package's, on the CPU: both ``ServingServer``s boot on port 0 over
the same ``.znn`` files (an MLP chain and a conv/pool/LRN chain of
``tests/test_torch_serving_card.CHAINS``) with the same knobs, the port's
engines with ``backend="cpu"``, and take the same request bytes.

- the answers over JSON and over the binary wire, within the tolerance of
  ``tests/test_torch_serving.py``, with the same content types and
  ``X-Model-Generation``;
- the same status codes: 200, 400 on bad bodies (JSON, binary, ragged,
  geometry, criticality), 404 (model, route, reload name), 413, 501,
  429 with a full queue and on a quota, 504 on a deadline, 403 without
  the admin token, and the admin reload's 200;
- the same JSON keys in ``/healthz`` (``mesh`` ``1x1``), ``/tracez``,
  ``/alertz``, ``/debug/flightrecorder`` and ``/debug/threadz``; the
  same ``/statusz`` sections; the span header of a traced request; a
  memo hit after the same request twice;
- the metric family names of ``/metrics`` from ``serve`` processes of
  both packages, less the three promotion families (ROADMAP.md queue 1
  item 10), and plus the port engine's ``builds`` mirror;
- ``python -m znicz_tpu_torch serve --backend cpu --port 0`` in a
  subprocess serves both wire formats and drains on SIGTERM with exit 0;
  ``--backend auto`` raises without a card; ``--tp 2``,
  ``--compile-cache-dir`` and ``--capture-dir`` raise naming their
  items, as does each sub-command of the reference not ported yet."""

import http.client
import json
import os
import re
import signal
import subprocess
import sys
import threading
import time

import numpy as np
import pytest
import torch

from znicz_tpu.serving import MicroBatcher as RefMicroBatcher
from znicz_tpu.serving import ServingServer as RefServingServer
from znicz_tpu.serving import engine as ref_engine
from znicz_tpu.serving import wire as ref_wire
from znicz_tpu.serving import zoo as ref_zoo
from znicz_tpu.telemetry import flightrecorder as ref_fr
from znicz_tpu_torch.__main__ import main as port_main
from znicz_tpu_torch.serving import (MicroBatcher, ServingEngine,
                                     ServingServer, wire, zoo)
from znicz_tpu_torch.telemetry import flightrecorder, tracing
from test_torch_serving_card import write_chain

RTOL, ATOL = 1e-5, 1e-6
REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOKEN = "s3cret"
#: the reference registers these by importing its promotion package,
#: which the port does not have yet (ROADMAP.md queue 1 item 10)
PROMOTION_FAMILIES = {"promotions_total", "promotion_generation",
                      "slo_breaches_total"}


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture(scope="module", autouse=True)
def _own_recorders():
    """Both packages' servers record every request into their package's
    process-wide flight recorder, whose shape census a reload of another
    test's engine warms later in this process: this file's traffic goes
    to recorders of its own."""
    saved = flightrecorder.RECORDER, ref_fr.RECORDER
    flightrecorder.RECORDER = flightrecorder.FlightRecorder()
    ref_fr.RECORDER = ref_fr.FlightRecorder()
    yield
    flightrecorder.RECORDER, ref_fr.RECORDER = saved


@pytest.fixture(scope="module")
def models(tmp_path_factory):
    d = tmp_path_factory.mktemp("http")
    out = {}
    for name in ("mlp", "conv"):
        out[name] = write_chain(d / f"{name}.znn", name)
    return str(d), out


def _zoo(pkg, paths):
    if pkg == "port":
        z = zoo.ModelZoo()
        make = lambda p: ServingEngine(p, backend="cpu", buckets=(1, 8))
    else:
        z = ref_zoo.ModelZoo()
        make = lambda p: ref_engine.ServingEngine(p, backend="jax",
                                                  buckets=(1, 8))
    z.add("mlp", engine=make(paths["mlp"][0]))
    z.add("conv", engine=make(paths["conv"][0]))
    # a tenant of one request per ~17 minutes: the second 429s
    z.add("quota", engine=make(paths["mlp"][0]), quota_rps=0.001,
          quota_burst=1)
    return z


KNOBS = dict(max_batch=8, max_wait_ms=2.0, max_queue=64, max_body_mb=0.5,
             admin_token=TOKEN, memo_entries=16, trace_sample=1.0)


@pytest.fixture(scope="module")
def servers(models):
    _, paths = models
    out = {"port": ServingServer(zoo=_zoo("port", paths), **KNOBS).start(),
           "ref": RefServingServer(zoo=_zoo("ref", paths), **KNOBS).start()}
    yield out
    for s in out.values():
        s.stop()
        s.zoo.close()


def _req(server, method, path, body=None, headers=None, timeout=60.0):
    """(status, headers lowercased, body bytes) of one request on a fresh
    connection."""
    host, port = server.server.server_address[:2]
    conn = http.client.HTTPConnection(host, port, timeout=timeout)
    try:
        conn.request(method, path, body=body, headers=headers or {})
        r = conn.getresponse()
        return (r.status, {k.lower(): v for k, v in r.getheaders()},
                r.read())
    finally:
        conn.close()


def _both(servers, *args, **kw):
    return {k: _req(s, *args, **kw) for k, s in servers.items()}


def _rows(shape, n, seed):
    return np.random.default_rng(seed).uniform(
        -1, 1, (n,) + tuple(shape)).astype(np.float32)


@pytest.mark.parametrize("binary", [False, True], ids=["json", "binary"])
@pytest.mark.parametrize("name", ["mlp", "conv"])
def test_answers_agree(servers, models, name, binary):
    shape = models[1][name][1]
    for i, n in enumerate((1, 5, 8, 11)):
        x = _rows(shape, n, 10 * i + binary)
        if binary:
            body = wire.encode_tensor(x)
            assert body == ref_wire.encode_tensor(x)
            headers = {"Content-Type": wire.CONTENT_TYPE,
                       "Accept": wire.CONTENT_TYPE, "X-Model": name}
        else:
            body = json.dumps({"inputs": x.tolist(), "model": name}
                              ).encode()
            headers = {"Content-Type": "application/json"}
        got = _both(servers, "POST", "/predict", body, headers)
        ys = {}
        for k, (code, hdrs, raw) in got.items():
            assert code == 200, (k, raw[:300])
            ys[k] = (wire.decode_tensor(raw) if binary
                     else np.asarray(json.loads(raw)["outputs"],
                                     np.float32))
            assert ys[k].shape[0] == n
        np.testing.assert_allclose(ys["port"], ys["ref"], rtol=RTOL,
                                   atol=ATOL)
        for h in ("content-type", "x-model-generation"):
            assert got["port"][1][h] == got["ref"][1][h]


def _codes(servers, method, path, body=None, headers=None):
    got = _both(servers, method, path, body, headers)
    codes = {k: v[0] for k, v in got.items()}
    assert codes["port"] == codes["ref"], (path, got)
    for k, (code, hdrs, raw) in got.items():
        if code in (429, 503, 504):
            assert int(hdrs["retry-after"]) >= 1
        if hdrs.get("content-type") == "application/json" and code >= 400:
            assert "error" in json.loads(raw)
    return codes["port"]


CODE_CASES = {
    "bad_json": ("POST", "/predict", b"{nope", {}, 400),
    "not_an_object": ("POST", "/predict", b"[1, 2]", {}, 400),
    "ragged": ("POST", "/predict", json.dumps(
        {"inputs": [[0.0] * 784, [0.0] * 3]}).encode(), {}, 400),
    "geometry": ("POST", "/predict", json.dumps(
        {"inputs": [[0.0] * 783]}).encode(), {}, 400),
    "criticality": ("POST", "/predict", json.dumps(
        {"inputs": [[0.0] * 784]}).encode(), {"X-Criticality": "vip"},
        400),
    "bad_binary": ("POST", "/predict", b"ZNTW\x01\x01\x02\x00" + b"\0" * 5,
                   {"Content-Type": "application/x-znicz-tensor"}, 400),
    "bad_deadline": ("POST", "/predict", json.dumps(
        {"inputs": [[0.0] * 784]}).encode(), {"X-Deadline-Ms": "soon"},
        400),
    "unknown_model": ("POST", "/predict", json.dumps(
        {"inputs": [[0.0] * 784]}).encode(), {"X-Model": "resnet"}, 404),
    "unknown_get": ("GET", "/nope", None, {}, 404),
    "unknown_post": ("POST", "/nope", b"{}", {}, 404),
    "too_large": ("POST", "/predict", b" " * 500_001, {}, 413),
    "chunked": ("POST", "/predict", b"0\r\n\r\n",
                {"Transfer-Encoding": "chunked"}, 501),
    "deadline_zero": ("POST", "/predict", json.dumps(
        {"inputs": [[0.0] * 784], "deadline_ms": 0}).encode(), {}, 504),
    "reload_no_token": ("POST", "/admin/reload", b"{}", {}, 403),
    "reload_wrong_token": ("POST", "/admin/reload", b"{}",
                           {"X-Admin-Token": "guess"}, 403),
    "reload_unknown_name": ("POST", "/admin/reload", json.dumps(
        {"name": "resnet"}).encode(), {"X-Admin-Token": TOKEN}, 404),
    "reload_bad_body": ("POST", "/admin/reload", b"[]",
                        {"X-Admin-Token": TOKEN}, 400),
    "placement_bad_body": ("POST", "/admin/placement", json.dumps(
        {"models": "mlp"}).encode(), {"X-Admin-Token": TOKEN}, 400),
    "statusz_no_token": ("GET", "/statusz", None, {}, 403),
    "threadz_no_token": ("GET", "/debug/threadz", None, {}, 403),
    "healthz_open": ("GET", "/healthz", None, {}, 200),
    "alertz_open": ("GET", "/alertz", None, {}, 200),
    "tracez_open": ("GET", "/tracez", None, {}, 200),
}


@pytest.mark.parametrize("case", sorted(CODE_CASES))
def test_status_codes_agree(servers, case):
    method, path, body, headers, want = CODE_CASES[case]
    assert _codes(servers, method, path, body, headers) == want


def test_quota_429_agrees(servers):
    body = json.dumps({"inputs": [[0.0] * 784]}).encode()
    hdrs = {"X-Model": "quota"}
    assert _codes(servers, "POST", "/predict", body, hdrs) == 200
    assert _codes(servers, "POST", "/predict", body, hdrs) == 429


class _Slow:
    def __init__(self, engine, delay):
        self.engine, self.delay = engine, delay

    def predict(self, x):
        time.sleep(self.delay)
        return self.engine.predict(x)


def _slow_servers(models, max_queue, delay):
    path = models[1]["mlp"][0]
    port = ServingEngine(path, backend="cpu", buckets=(1, 8))
    ref = ref_engine.ServingEngine(path, backend="jax", buckets=(1, 8))
    return {"port": ServingServer(port, batcher=MicroBatcher(
                _Slow(port, delay), max_batch=1, max_wait_ms=1,
                max_queue=max_queue)).start(),
            "ref": RefServingServer(ref, batcher=RefMicroBatcher(
                _Slow(ref, delay), max_batch=1, max_wait_ms=1,
                max_queue=max_queue)).start()}


def test_full_queue_429_and_queued_deadline_504(models):
    servers = _slow_servers(models, 2, 0.25)
    body = json.dumps({"inputs": [[0.0] * 784]}).encode()
    try:
        for key, server in servers.items():
            n = 8
            codes = [None] * n
            barrier = threading.Barrier(n)

            def client(i, server=server, codes=codes, barrier=barrier):
                barrier.wait()
                codes[i], hdrs, _ = _req(server, "POST", "/predict", body)
                if codes[i] == 429:
                    assert int(hdrs["retry-after"]) >= 1
            threads = [threading.Thread(target=client, args=(i,))
                       for i in range(n)]
            for t in threads:
                t.start()
            for t in threads:
                t.join(60)
            assert None not in codes and set(codes) <= {200, 429}, key
            assert codes.count(429) >= 1 and codes.count(200) >= 1, key
            # a deadline that dies in the queue behind a slow forward
            blocker = threading.Thread(target=_req, args=(
                server, "POST", "/predict", body))
            blocker.start()
            time.sleep(0.05)
            code, hdrs, raw = _req(server, "POST", "/predict", json.dumps(
                {"inputs": [[0.0] * 784], "deadline_ms": 60}).encode())
            blocker.join(30)
            assert code == 504 and b"deadline" in raw, key
    finally:
        for s in servers.values():
            s.stop()
            s.batcher.close()       # the caller's batcher: ours to close


def test_healthz_keys_agree(servers):
    got = {k: json.loads(v[2]) for k, v in
           _both(servers, "GET", "/healthz").items()}
    assert sorted(got["port"]) == sorted(got["ref"])
    assert got["port"]["mesh"] == got["ref"]["mesh"] == "1x1"
    assert got["port"]["status"] == got["ref"]["status"] == "ok"
    assert sorted(got["port"]["models"][0]) == \
        sorted(got["ref"]["models"][0])
    assert [r["model"] for r in got["port"]["models"]] == \
        [r["model"] for r in got["ref"]["models"]]


@pytest.mark.parametrize("path", ["/alertz", "/tracez",
                                  "/debug/flightrecorder",
                                  "/debug/threadz"])
def test_json_surfaces_keys_agree(servers, path):
    got = {k: json.loads(v[2]) for k, v in _both(
        servers, "GET", path, None, {"X-Admin-Token": TOKEN}).items()}
    assert sorted(got["port"]) == sorted(got["ref"])


def _sections(text: str) -> list:
    """/statusz section titles: the lines underlined with dashes."""
    lines = text.splitlines()
    return [a for a, b in zip(lines, lines[1:])
            if b and set(b) == {"-"} and len(b) == len(a)]


def test_statusz_sections_agree(servers):
    got = {k: v[2].decode() for k, v in _both(
        servers, "GET", "/statusz", None,
        {"X-Admin-Token": TOKEN}).items()}
    assert _sections(got["port"]) == _sections(got["ref"])
    assert "serving" in _sections(got["port"])
    assert "model zoo" in _sections(got["port"])
    assert "mesh: 1x1" in got["port"] and "mesh: 1x1" in got["ref"]
    assert "kernel_build_dir: " in got["port"]


def test_traced_request_returns_spans(servers):
    ctx = tracing.TraceContext(tracing.new_trace_id(),
                               tracing.new_span_id(), True)
    x = _rows((784,), 2, 77)
    got = _both(servers, "POST", "/predict",
                json.dumps({"inputs": x.tolist()}).encode(),
                {"X-Znicz-Trace": tracing.format_traceparent(ctx)})
    names = {}
    for k, (code, hdrs, _raw) in got.items():
        assert code == 200
        summary = json.loads(hdrs["x-znicz-spans"])
        names[k] = sorted({s["n"] for s in summary["spans"]})
    assert names["port"] == names["ref"]
    assert {"server.predict", "engine.forward"} <= set(names["port"])
    tz = {k: json.loads(v[2]) for k, v in
          _both(servers, "GET", "/tracez").items()}
    assert tz["port"]["stages"] == tz["ref"]["stages"]
    assert tz["port"]["retained"] >= 1 and tz["ref"]["retained"] >= 1


def test_memo_hit_after_the_same_request_twice(servers):
    x = _rows((784,), 3, 12345)
    body = json.dumps({"inputs": x.tolist()}).encode()

    def hits():
        out = {}
        for k, (_c, _h, raw) in _both(servers, "GET", "/metrics").items():
            out[k] = json.loads(raw)["zoo"]["models"]["mlp"][
                "response_cache"]["hits"]
        return out
    before = hits()
    first = _both(servers, "POST", "/predict", body)
    second = _both(servers, "POST", "/predict", body)
    after = hits()
    for k in servers:
        assert first[k][0] == second[k][0] == 200
        assert first[k][2] == second[k][2]
        assert after[k] - before[k] == 1


def test_admin_reload_waited(servers, models):
    body = json.dumps({"name": "conv", "wait": True}).encode()
    got = _both(servers, "POST", "/admin/reload", body,
                {"X-Admin-Token": TOKEN})
    out = {k: json.loads(v[2]) for k, v in got.items()}
    for k in servers:
        assert got[k][0] == 200 and out[k]["status"] == "done"
        assert out[k]["last_reload"]["outcome"] == "ok"
    assert sorted(out["port"]) == sorted(out["ref"])
    assert out["port"]["model_generation"] == out["ref"]["model_generation"]


def _serve(args, pkg):
    env = dict(os.environ, JAX_PLATFORMS="cpu", PYTHONPATH=REPO)
    p = subprocess.Popen([sys.executable, "-m", pkg, "serve", *args],
                         stdout=subprocess.PIPE, stderr=subprocess.PIPE,
                         text=True, env=env, cwd=REPO)
    line = p.stdout.readline()
    m = re.search(r"at (http://[\d.]+:(\d+)/)", line)
    if m is None:
        p.kill()
        out, err = p.communicate(timeout=30)
        raise AssertionError(f"{pkg} serve did not start: {line}{out}{err}")
    return p, int(m.group(2)), line


class _Port:
    """A stand-in with the address ``_req`` reads."""

    def __init__(self, port):
        self.server = type("S", (), {"server_address": ("127.0.0.1",
                                                        port)})


def test_metric_families_of_serve_processes(models):
    directory, paths = models
    fams = {}
    for pkg, backend in (("znicz_tpu_torch", "cpu"), ("znicz_tpu", "jax")):
        p, port, _ = _serve(["--zoo", directory, "--port", "0",
                             "--backend", backend, "--memoize", "4",
                             "--buckets", "1,8"], pkg)
        try:
            srv = _Port(port)
            for name in ("mlp", "conv"):
                x = _rows(paths[name][1], 2, 3)
                code, _h, _b = _req(srv, "POST", "/predict", json.dumps(
                    {"inputs": x.tolist(), "model": name}).encode())
                assert code == 200
            code, _h, raw = _req(srv, "GET", "/metrics?format=prometheus")
            assert code == 200
            fams[pkg] = {line.split()[2] for line in raw.decode().splitlines()
                         if line.startswith("# TYPE ")}
        finally:
            p.send_signal(signal.SIGTERM)
            p.communicate(timeout=60)
    port, ref = fams["znicz_tpu_torch"], fams["znicz_tpu"]
    assert ref - port == PROMOTION_FAMILIES
    assert port - ref == set()
    assert {"predict_latency_ms", "requests_total", "wire_requests_total",
            "model_requests_total", "serving_engine_cache_hits",
            "slo_burn_rate", "trace_stage_ms"} <= port


def test_cli_serves_both_wires_and_drains_on_sigterm(models):
    path, shape = models[1]["mlp"]
    p, port, line = _serve(["--model", f"mlp={path}", "--port", "0",
                            "--backend", "cpu", "--buckets", "1,8"],
                           "znicz_tpu_torch")
    try:
        assert "mesh 1x1" in line and "[cpu]" in line
        srv = _Port(port)
        x = _rows(shape, 3, 5)
        want = ServingEngine(path, backend="cpu").predict(x)
        code, _h, raw = _req(srv, "POST", "/predict", json.dumps(
            {"inputs": x.tolist()}).encode())
        assert code == 200
        np.testing.assert_allclose(json.loads(raw)["outputs"], want,
                                   rtol=RTOL, atol=ATOL)
        code, _h, raw = _req(srv, "POST", "/predict", wire.encode_tensor(x),
                             {"Content-Type": wire.CONTENT_TYPE,
                              "Accept": wire.CONTENT_TYPE})
        assert code == 200
        np.testing.assert_allclose(wire.decode_tensor(raw), want,
                                   rtol=RTOL, atol=ATOL)
    finally:
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err
    assert "drain complete" in out


@pytest.mark.parametrize("argv,match", [
    (["route"], "item 11"), (["autoscale"], "item 11"),
    (["chaos"], "item 10"), (["promote"], "item 10"),
    (["online-train"], "item 10"), (["lint"], "item 12"),
    (["serve", "--model", "m.znn", "--tp", "2"], "item 9"),
    (["serve", "--model", "m.znn", "--compile-cache-dir", "c"], "item 10"),
    (["serve", "--model", "m.znn", "--capture-dir", "c"], "item 10")])
def test_unported_commands_and_flags_raise(argv, match, tmp_path, capsys):
    if argv == ["lint"]:
        # item 12 is ported: `lint` runs zlint instead of raising (here
        # over an empty root, where nothing fires)
        assert port_main(argv + ["--root", str(tmp_path), "--format",
                                 "json"]) == 0
        assert json.loads(capsys.readouterr().out)["ok"] is True
        return
    with pytest.raises(NotImplementedError, match=match):
        port_main(argv)


def test_backend_auto_raises_without_a_card(models, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA card"):
        port_main(["serve", "--model", models[1]["mlp"][0], "--port", "0"])
