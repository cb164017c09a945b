"""The port's kernel-build cache (``znicz_tpu_torch.compilecache``), on the
CPU: the reference's API (``ENV_VAR``, ``dir_from_env``, ``active_dir``,
``enable``) pointing ``cuda_build``'s build directory at a shared
directory.  A second process with the same cache builds nothing — shown
with ``cuda_build.build_host``, which needs only ``g++`` — and so does a
second ``serve`` start; ``enable(None)`` with no environment variable is a
no-op, an unusable directory runs uncached, and a failing build still
raises."""

import json
import logging
import os
import re
import signal
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from znicz_tpu import compilecache as ref_compilecache
from znicz_tpu_torch import compilecache, cuda_build

REPO = Path(__file__).resolve().parent.parent


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def fresh(monkeypatch):
    """The module state enable() writes, restored after the test."""
    monkeypatch.setattr(cuda_build, "BUILD_DIR", cuda_build.BUILD_DIR)
    monkeypatch.setattr(compilecache, "_active_dir", None)
    monkeypatch.delenv(compilecache.ENV_VAR, raising=False)


def test_the_api_is_the_references():
    assert compilecache.ENV_VAR == ref_compilecache.ENV_VAR \
        == "ZNICZ_COMPILE_CACHE"
    for name in ("dir_from_env", "active_dir", "enable"):
        assert callable(getattr(compilecache, name))


def test_enable_none_without_the_variable_is_a_no_op(fresh):
    before = cuda_build.BUILD_DIR
    assert compilecache.dir_from_env() is None
    assert compilecache.enable(None) is None
    assert compilecache.active_dir() is None
    assert cuda_build.BUILD_DIR == before == \
        cuda_build.PACKAGE_DIR / "build"


def test_enable_points_the_builds_at_the_directory(fresh, tmp_path,
                                                   monkeypatch):
    d = tmp_path / "cache"
    assert compilecache.enable(str(d)) == str(d)
    assert d.is_dir() and compilecache.active_dir() == str(d)
    assert cuda_build.BUILD_DIR == d
    assert cuda_build.library_path("softmax").parent == d
    env = tmp_path / "from_env"
    monkeypatch.setenv(compilecache.ENV_VAR, str(env))
    assert compilecache.dir_from_env() == str(env)
    assert compilecache.enable() == str(env)
    assert cuda_build.BUILD_DIR == env


def test_an_unusable_directory_runs_uncached(fresh, tmp_path, caplog):
    blocker = tmp_path / "a_file"
    blocker.write_text("x")
    before = cuda_build.BUILD_DIR
    with caplog.at_level(logging.WARNING, logger="znicz.compilecache"):
        assert compilecache.enable(str(blocker / "cache")) is None
    assert "running uncached" in caplog.text
    assert cuda_build.BUILD_DIR == before
    assert compilecache.active_dir() is None


_BUILD = (
    "import json, sys\n"
    "from znicz_tpu_torch import compilecache, cuda_build\n"
    "from znicz_tpu_torch.loader import records\n"
    "assert compilecache.enable(sys.argv[1]) == sys.argv[1]\n"
    "so = cuda_build.build_host('libznr_reader',\n"
    "    records.NATIVE_DIR / 'znr_reader.cpp',\n"
    "    (records.NATIVE_DIR / 'parallel.h',))\n"
    "print(json.dumps({'so': str(so), 'builds': cuda_build.BUILDS}))\n")


def _build_in_a_process(cache):
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    env.pop(compilecache.ENV_VAR, None)
    proc = subprocess.run([sys.executable, "-c", _BUILD, str(cache)],
                          cwd=REPO, env=env, capture_output=True,
                          text=True, timeout=180)
    assert proc.returncode == 0, proc.stderr
    return json.loads(proc.stdout.strip().splitlines()[-1])


def test_a_second_process_builds_nothing(tmp_path):
    cache = tmp_path / "cache"
    first = _build_in_a_process(cache)
    second = _build_in_a_process(cache)
    assert first["builds"] == {"nvcc": 0, "g++": 1}
    assert second["builds"] == {"nvcc": 0, "g++": 0}
    assert first["so"] == second["so"]
    assert Path(first["so"]).parent == cache and Path(first["so"]).is_file()
    assert not any(p.suffix == ".tmp" for p in cache.iterdir())


def test_a_failing_build_still_raises(fresh, tmp_path):
    compilecache.enable(str(tmp_path / "cache"))
    bad = tmp_path / "bad.cpp"
    bad.write_text("this is not C++\n")
    before = dict(cuda_build.BUILDS)
    with pytest.raises(cuda_build.BuildError, match="bad.cpp"):
        cuda_build.build_host("bad", bad)
    assert cuda_build.BUILDS["g++"] == before["g++"] + 1
    assert not list((tmp_path / "cache").glob("bad-*.so"))


def _serve_once(model, cache, backend="native"):
    """A ``serve --compile-cache-dir`` process: one request, SIGTERM; its
    exit line's compiler runs."""
    import urllib.request
    env = dict(os.environ, PYTHONPATH=str(REPO), OMP_NUM_THREADS="2")
    p = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", "serve", "--model", model,
         "--backend", backend, "--port", "0", "--buckets", "1",
         "--compile-cache-dir", str(cache)],
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True, env=env,
        cwd=REPO)
    try:
        url = None
        for _ in range(5):
            m = re.search(r"at (http://[\d.]+:\d+/)", p.stdout.readline())
            if m:
                url = m.group(1)
                break
        assert url, p.stderr.read() if p.poll() is not None else "no url"
        req = urllib.request.Request(
            url + "predict", json.dumps({"inputs": [[0.1] * 13]}).encode(),
            {"Content-Type": "application/json"})
        with urllib.request.urlopen(req, timeout=60) as r:
            assert r.status == 200
    finally:
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    assert p.returncode == 0, err
    m = re.search(r"kernel builds: (\{.*\}) \(build dir (.*)\)", out)
    assert m, out
    return json.loads(m.group(1)), m.group(2)


def test_serve_second_start_builds_nothing(tmp_path):
    """``serve --backend native`` builds the C++ engine with g++ into the
    cache at its first start; the second start finds it built."""
    from znicz_tpu_torch.serving.zoo import write_demo_model
    model = str(tmp_path / "wine.znn")
    write_demo_model(model, "wine", seed=7)
    cache = tmp_path / "cache"
    first, d1 = _serve_once(model, cache)
    second, d2 = _serve_once(model, cache)
    assert d1 == d2 == str(cache)
    assert first == {"nvcc": 0, "g++": 1}
    assert second == {"nvcc": 0, "g++": 0}
    assert list(cache.glob("libznicz_infer-*.so"))
