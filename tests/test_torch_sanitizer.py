"""The port's runtime lock-order sanitizer (``znicz_tpu_torch.sanitizer``)
on the CPU, the `pytest -m san` lane.

Fixture half, as the reference's ``tests/test_sanitizer.py`` runs it on
its own module: a seeded two-lock inversion is caught with both
acquisition stacks; consistent order is clean; RLock and Condition
reentrancy are clean; the report survives the death of the thread that
made it; a long hold is reported and not fatal; the lifecycle.

Integration half: the port's ``MicroBatcher`` over a CPU
``ServingEngine``, and a ``ModelZoo`` under a memory budget with client
threads, each built while the sanitizer is on, run clean with tracked
acquires > 0.

Against the reference: the same seeded scenario through each sanitizer
in turn gives the same acquires, edges and inversions; the port's
``enable()`` refuses while the reference's patch is installed; and the
port's watch prefix ends with a separator, so it never wraps a lock of
a sibling directory whose name it prefixes (the reference's does)."""

import os
import threading
import time

import numpy as np
import pytest
import torch

from znicz_tpu import sanitizer as ref_sanitizer
from znicz_tpu_torch import sanitizer

pytestmark = pytest.mark.san


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


@pytest.fixture
def san():
    """The port's sanitizer, enabled with clean observations; tolerant
    of an outer ZNICZ_SAN=1 run already owning the patch."""
    if sanitizer.enabled():
        sanitizer.reset()
        yield sanitizer
        sanitizer.reset()
    else:
        sanitizer.enable()
        try:
            yield sanitizer
        finally:
            sanitizer.disable()


def _run(*fns):
    threads = [threading.Thread(target=fn) for fn in fns]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=30)
        assert not t.is_alive()


def _inversion_scenario(mod) -> dict:
    """A→B in one thread, then B→A in another, then A→B from three
    threads at once, through ``mod``'s explicit locks."""
    a = mod.make_lock("seed:A")
    b = mod.make_lock("seed:B")
    r = mod.make_rlock("seed:R")

    def fwd():
        with a:
            with b:
                with r:
                    with r:
                        pass

    def rev():
        with b:
            with a:
                pass

    _run(fwd)
    _run(rev)
    _run(fwd, fwd, fwd)
    return mod.report()


class TestInversionDetection:
    def test_seeded_two_lock_inversion_detected(self, san):
        a = san.make_lock("seed:A")
        b = san.make_lock("seed:B")

        def fwd():
            with a:
                with b:
                    pass

        def rev():
            with b:
                with a:
                    pass

        _run(fwd)
        _run(rev)
        rep = san.report()
        assert len(rep["inversions"]) == 1
        inv = rep["inversions"][0]
        assert set(inv["sites"]) == {"seed:A", "seed:B"}
        assert any("rev" in line for line in inv["stack"])
        assert any("fwd" in line for line in inv["other_stack"])
        with pytest.raises(sanitizer.SanError) as ei:
            san.assert_clean(rep)
        msg = str(ei.value)
        assert "INVERSION" in msg and "fwd" in msg and "rev" in msg

    def test_consistent_order_is_clean(self, san):
        a = san.make_lock("cons:A")
        b = san.make_lock("cons:B")

        def worker():
            for _ in range(50):
                with a:
                    with b:
                        pass

        _run(worker, worker, worker)
        rep = san.report()
        assert rep["inversions"] == []
        assert rep["edges"] == 1
        assert rep["acquires"] == 300
        san.assert_clean(rep)

    def test_rlock_reentrancy_not_an_inversion(self, san):
        r = san.make_rlock("reent:R")
        other = san.make_lock("reent:other")

        def worker():
            with r:
                with other:
                    with r:            # reentrant, inside `other`
                        pass

        _run(worker)
        rep = san.report()
        assert rep["inversions"] == []
        assert rep["edges"] == 1

    def test_condition_wait_reacquire_not_an_inversion(self, san):
        cond = san.make_condition("cw:cond")
        outer = san.make_lock("cw:outer")
        ready = []

        def waiter():
            with outer:
                with cond:
                    while not ready:
                        cond.wait(1.0)

        def poker():
            time.sleep(0.05)
            with cond:
                ready.append(1)
                cond.notify_all()

        _run(waiter, poker)
        rep = san.report()
        assert rep["inversions"] == []
        san.assert_clean(rep)

    def test_report_survives_thread_death(self, san):
        a = san.make_lock("dead:A")
        b = san.make_lock("dead:B")

        def doomed_fwd():
            with a:
                with b:
                    pass

        def doomed_rev():
            with b:
                with a:
                    pass

        t = threading.Thread(target=doomed_fwd)
        t.start()
        t.join(timeout=10)
        t = threading.Thread(target=doomed_rev, daemon=True)
        t.start()
        t.join(timeout=10)
        assert not t.is_alive()
        del t
        rep = san.report()
        assert rep["edges"] == 2
        assert len(rep["inversions"]) == 1
        assert rep["inversions"][0]["stack"]
        assert rep["inversions"][0]["other_stack"]

    def test_long_hold_reported_not_fatal(self, san):
        lk = san.make_lock("hold:slow")
        old = sanitizer._state.hold_ms
        sanitizer._state.hold_ms = 10.0   # 50ms hold vs 10ms threshold
        try:
            with lk:
                time.sleep(0.05)
        finally:
            sanitizer._state.hold_ms = old
        rep = san.report()
        assert any(h["site"] == "hold:slow" for h in rep["long_holds"])
        assert "LONG HOLD: hold:slow" in san.format_report(rep)
        san.assert_clean(rep)


class TestLifecycle:
    def test_double_enable_raises(self, san):
        with pytest.raises(sanitizer.SanError, match="already enabled"):
            sanitizer.enable()

    def test_reset_clears_observations(self, san):
        a = san.make_lock("rst:A")
        b = san.make_lock("rst:B")
        with a:
            with b:
                pass
        assert san.report()["edges"] == 1
        san.reset()
        rep = san.report()
        assert rep["edges"] == 0 and rep["acquires"] == 0

    def test_wrappers_survive_disable_and_threading_is_restored(self):
        assert not sanitizer.enabled()
        before = (threading.Lock, threading.RLock, threading.Condition)
        sanitizer.enable()
        assert threading.Lock is not before[0]
        lk = sanitizer.make_lock("late:A")
        rep = sanitizer.disable()
        assert rep["enabled"] is True
        assert (threading.Lock, threading.RLock,
                threading.Condition) == before
        with lk:                        # tracking off, lock still a lock
            pass
        assert not lk.locked()
        # disabling a sanitizer that is off touches nothing
        assert sanitizer.disable()["enabled"] is False
        assert (threading.Lock, threading.RLock,
                threading.Condition) == before

    def test_only_package_locks_are_wrapped(self, san):
        from znicz_tpu_torch.parallel import capture
        assert type(threading.Lock()).__name__ == "lock"   # this file
        with capture._LOCK:             # made at import, before enable
            pass
        from znicz_tpu_torch.telemetry import registry
        made = registry.Counter("zsan_probe_total", "a test's counter")
        assert isinstance(made._lock, (sanitizer.SanLock,
                                       sanitizer.SanRLock)), made._lock


class TestAgainstTheReference:
    def test_same_scenario_same_report(self):
        """The reference's sanitizer, then the port's, each enabled
        alone over the same scenario: the same counts."""
        assert not ref_sanitizer.enabled() and not sanitizer.enabled()
        reports = []
        for mod in (ref_sanitizer, sanitizer):
            mod.enable()
            try:
                reports.append(_inversion_scenario(mod))
            finally:
                mod.disable()
        want, got = reports
        assert (got["acquires"], got["edges"], len(got["inversions"])) \
            == (want["acquires"], want["edges"], len(want["inversions"]))
        assert (got["acquires"], got["edges"], len(got["inversions"])) \
            == (14, 4, 1)
        assert got["inversions"][0]["sites"] == \
            want["inversions"][0]["sites"]

    def test_enable_refuses_while_the_reference_patches(self):
        before = (threading.Lock, threading.RLock, threading.Condition)
        ref_sanitizer.enable()
        try:
            with pytest.raises(sanitizer.SanError,
                               match="threading.Lock .*already patched"):
                sanitizer.enable()
            assert not sanitizer.enabled()
            # the port's disable leaves the reference's patch in place
            sanitizer.disable()
            assert threading.Lock is not before[0]
        finally:
            ref_sanitizer.disable()
        assert (threading.Lock, threading.RLock,
                threading.Condition) == before
        sanitizer.enable()              # free again
        sanitizer.disable()

    def test_watch_prefix_ends_with_a_separator(self, tmp_path):
        pkg = os.path.dirname(os.path.abspath(sanitizer.__file__))
        sanitizer.enable()
        try:
            assert sanitizer._watched(os.path.join(pkg, "serving", "x.py"))
            assert not sanitizer._watched(pkg + "_extra" + os.sep + "x.py")
        finally:
            sanitizer.disable()
        sibling = os.path.dirname(pkg) + os.sep + "znicz_tpu"
        sanitizer.enable(watch=(sibling,))
        try:
            assert not sanitizer._watched(os.path.join(pkg, "x.py"))
            assert sanitizer._watched(os.path.join(sibling, "x.py"))
        finally:
            sanitizer.disable()
        # the reference's bare prefix wraps the port's files too
        ref_sanitizer.enable(watch=(sibling,))
        try:
            assert ref_sanitizer._watched(os.path.join(pkg, "x.py"))
        finally:
            ref_sanitizer.disable()


# -- integration: the port's serving locks, sanitized ----------------------

@pytest.fixture(scope="module")
def demo(tmp_path_factory):
    from znicz_tpu_torch.serving import zoo
    return zoo.make_demo_zoo(str(tmp_path_factory.mktemp("san")), seed=7)


def _x(family, n, seed):
    from znicz_tpu_torch.serving import zoo
    return np.random.default_rng(seed).standard_normal(
        (n, zoo.DEMO_SHAPES[family])).astype(np.float32)


class TestSanitizedServing:
    def test_microbatcher_over_a_cpu_engine_runs_clean(self, san, demo):
        from znicz_tpu_torch.resilience.overload import CoDelShedder
        from znicz_tpu_torch.serving import MicroBatcher, ServingEngine
        eng = ServingEngine(demo["mnist"], backend="cpu")
        x = _x("mnist", 2, 1)
        want = eng.predict(x)
        san.reset()
        mb = MicroBatcher(eng, max_batch=4, max_wait_ms=2.0, max_queue=64,
                          shedder=CoDelShedder(target_ms=50,
                                               interval_ms=200),
                          name="san")
        errs, answers = [], []
        try:
            def client():
                for _ in range(15):
                    try:
                        answers.append(mb.predict(x, deadline_ms=5000,
                                                  timeout=30.0))
                    except Exception as e:      # noqa: BLE001 — checked
                        errs.append(repr(e))

            _run(client, client, client)
            mb.metrics()
        finally:
            mb.close()
            eng.close()
        assert errs == []
        assert len(answers) == 45
        for y in answers:
            np.testing.assert_allclose(y, want, rtol=1e-5, atol=1e-6)
        rep = san.report()
        assert rep["acquires"] > 0, "instrumentation fell off"
        assert rep["edges"] > 0
        assert rep["inversions"] == [], sanitizer.format_report(rep)

    def test_model_zoo_with_threads_runs_clean(self, san, demo):
        from znicz_tpu_torch.serving import ModelZoo, ServingEngine
        want = {}
        for fam, path in demo.items():
            eng = ServingEngine(path, backend="cpu")
            want[fam] = eng.predict(_x(fam, 3, 2))
            eng.close()
        san.reset()
        z = ModelZoo()
        for fam, path in demo.items():
            z.add(fam, engine=ServingEngine(path, backend="cpu"),
                  default=(fam == "mnist"))
        total = z.resident_bytes()
        z.memory_budget = total // 2
        errs = []

        def client(fams):
            def go():
                try:
                    for i in range(12):
                        fam = fams[i % len(fams)]
                        entry = z.resolve(fam)
                        z.admit(entry)
                        y = entry.predict(_x(fam, 3, 2))
                        z.touch(entry)
                        np.testing.assert_allclose(y, want[fam],
                                                   rtol=1e-5, atol=1e-6)
                        z.evict_to_budget(keep=fam)
                except Exception as e:          # noqa: BLE001 — checked
                    errs.append(repr(e))
            return go

        def scraper():
            for _ in range(12):
                z.metrics()
                z.status()

        fams = sorted(demo)
        try:
            _run(client(fams), client(fams[::-1]), client(fams[1:]),
                 scraper)
            paged = z.metrics()["pagein_p50_ms"]
        finally:
            z.close()
        assert errs == []
        assert paged is not None, "the budget paged nothing in"
        rep = san.report()
        assert rep["acquires"] > 0, "instrumentation fell off"
        assert rep["inversions"] == [], sanitizer.format_report(rep)


def test_zsan_serve_subprocess_on_the_cpu(demo, tmp_path):
    """``ZNICZ_SAN=1 python -m znicz_tpu_torch serve`` on the host: the
    package enables the sanitizer at import and prints its report at
    exit; ``ZNICZ_LAUNCH_COUNTS`` writes the process's kernel launches
    (none: CPU tensors take the plain versions)."""
    import json
    import re
    import signal
    import subprocess
    import sys
    from http.client import HTTPConnection
    counts = tmp_path / "launches.json"
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = dict(os.environ, ZNICZ_SAN="1", ZNICZ_LAUNCH_COUNTS=str(counts))
    p = subprocess.Popen(
        [sys.executable, "-m", "znicz_tpu_torch", "serve", "--model",
         f"mnist={demo['mnist']}", "--backend", "cpu", "--port", "0"],
        cwd=repo, env=env, text=True, stdout=subprocess.PIPE,
        stderr=subprocess.PIPE)
    try:
        line = p.stdout.readline()
        port = int(line.split(" at http://127.0.0.1:")[1].split("/")[0])
        x = _x("mnist", 2, 3)
        conn = HTTPConnection("127.0.0.1", port, timeout=60)
        conn.request("POST", "/predict",
                     json.dumps({"inputs": x.tolist()}).encode(),
                     {"Content-Type": "application/json"})
        r = conn.getresponse()
        assert r.status == 200, r.read()
        assert np.asarray(json.loads(r.read())["outputs"]).shape[0] == 2
        conn.close()
        p.send_signal(signal.SIGTERM)
        out, err = p.communicate(timeout=60)
    finally:
        if p.poll() is None:
            p.kill()
            p.communicate()
    assert p.returncode == 0 and "drain complete" in out, err[-2000:]
    m = re.search(r"zsan: (\d+) acquires, (\d+) order edges, (\d+) "
                  r"inversion\(s\)", err)
    assert m is not None, err[-2000:]
    assert int(m.group(1)) > 0 and int(m.group(3)) == 0
    launched = json.loads(counts.read_text())
    assert "softmax.softmax_launches" in launched
    assert set(launched.values()) == {0}
