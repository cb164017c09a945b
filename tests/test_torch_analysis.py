"""The port's static analyzer (``znicz_tpu_torch.analysis``, "zlint")
against the reference's (``znicz_tpu.analysis``), on the CPU.

- parity: pointed at the reference's tree (``package="znicz_tpu"``), the
  port's analyzer with the eleven shared rule classes gives the
  reference's ``(rule, path, line, severity)`` set, where the reference
  runs its ``default_rules()`` without its jit rule;
- rule cases: a known-bad snippet that fires and a known-good twin that
  stays silent for each shared rule, through both analyzers (and through
  the port's at the port's own paths, where the scoped rules patrol
  ``znicz_tpu_torch/serving/``);
- the CUDA-graph rules (``graph-host-sync``, ``graph-tensor-branch``)
  and the torch draws of ``unseeded-random``;
- discovery: the captured callables of the port's trainers, serving
  engine and probes are found, the server's traffic tap is not, and a
  ``.item()`` and a tensor ``if`` planted in the real fused step fire;
- the gate (``pytest -m lint``): ``run_repo()`` over ``znicz_tpu_torch``
  finds nothing new, and every baseline entry has a note and matches a
  live finding (the metric it names still drifts);
- the CLI: ``python -m znicz_tpu_torch lint``."""

import json
import os
import re
import subprocess
import sys
import textwrap

import pytest
import torch

from znicz_tpu import analysis as ref
from znicz_tpu_torch import analysis as port
from znicz_tpu_torch.analysis import cli as port_cli

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def _torch_threads():
    prev = torch.get_num_threads()
    torch.set_num_threads(2)
    yield
    torch.set_num_threads(prev)


def _keys(findings) -> set:
    return {(f.rule, f.path, f.line, f.severity) for f in findings}


def _ref_shared_rules() -> list:
    return [r for r in ref.default_rules()
            if not isinstance(r, ref.JaxHygieneRule)]


# -- parity over the reference's tree ---------------------------------------

@pytest.fixture(scope="module")
def ref_tree_runs():
    """(reference's findings, the port's) over ``znicz_tpu/``, each
    analyzer run once."""
    want = ref.Analyzer(_ref_shared_rules(), root=REPO).run()
    got = port.Analyzer(port.shared_rules(), root=REPO,
                        package="znicz_tpu").run()
    return want, got


def test_shared_rules_are_the_reference_eleven():
    ids = [r.id for r in port.shared_rules()]
    assert ids == [r.id for r in _ref_shared_rules()]
    assert len(ids) == 11
    assert [r.id for r in port.default_rules()] == \
        ids[:1] + ["graph-host-sync"] + ids[1:]


def test_parity_over_the_reference_tree(ref_tree_runs):
    want, got = ref_tree_runs
    assert want, "the reference's tree has findings before its baseline"
    assert _keys(got) == _keys(want)
    assert sorted(f.context for f in got) == sorted(f.context for f in want)


# -- rule cases through both analyzers --------------------------------------

LOCKED_BAD = """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._items = []

        def add(self, x):
            with self._lock:
                self._items.append(x)

        def peek(self):
            return self._items[-1]        # unguarded read
"""

LOCKED_GOOD = LOCKED_BAD.replace(
    "            return self._items[-1]        # unguarded read",
    "            with self._lock:\n"
    "                return self._items[-1]")

CASES = {
    "lock-discipline": ("LockDisciplineRule", LOCKED_BAD, LOCKED_GOOD),
    "unseeded-random": ("UnseededRandomRule", """
    import random

    import numpy as np

    def draw(n):
        a = np.random.rand(n)
        b = np.random.default_rng()
        return a, b, random.random()
""", """
    import random

    import numpy as np

    def draw(n, seed):
        rng = np.random.default_rng(seed)
        return rng.random(n), random.Random(seed).random()
"""),
    "handler-blocking": ("HandlerSafetyRule", """
    import time

    class Handler:
        def do_GET(self):
            time.sleep(1.0)
            self.wfile.write(b"ok")
""", """
    class Handler:
        def do_GET(self):
            self.wfile.write(b"ok")
"""),
    "duration-clock": ("DurationClockRule", """
    import time

    def measure(fn):
        t0 = time.time()
        fn()
        return time.time() - t0
""", """
    import time

    def measure(fn):
        t0 = time.monotonic()
        fn()
        return {"at": time.time(), "s": time.monotonic() - t0}
"""),
    "deadline-discipline": ("DeadlineDisciplineRule", """
    def dispatch_loop(q, done, worker):
        item = q.get()
        done.wait()
        worker.join()
        return item
""", """
    def dispatch_loop(q, done, worker, cfg):
        item = q.get(timeout=1.0)
        done.wait(0.25)
        worker.join(timeout=5.0)
        return item, cfg.get("name")
"""),
    "lock-order-cycle": ("LockOrderCycleRule", """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition()

        def a(self):
            with self._lock:
                with self._cond:
                    pass

        def b(self):
            with self._cond:
                with self._lock:
                    pass
""", """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()
            self._cond = threading.Condition()

        def a(self):
            with self._lock:
                with self._cond:
                    pass

        def b(self):
            with self._lock:
                with self._cond:
                    pass
"""),
    "lock-leak": ("LockLeakRule", """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()

        def work(self):
            self._lock.acquire()
            do_something()
            self._lock.release()
""", """
    import threading

    class Box:
        def __init__(self):
            self._lock = threading.Lock()

        def work(self):
            self._lock.acquire()
            try:
                do_something()
            finally:
                self._lock.release()
"""),
    "condition-wait-predicate": ("ConditionWaitPredicateRule", """
    import threading

    class Box:
        def __init__(self):
            self._cond = threading.Condition()
            self.ready = False

        def take(self):
            with self._cond:
                if not self.ready:
                    self._cond.wait(1.0)
                return self.ready
""", """
    import threading

    class Box:
        def __init__(self):
            self._cond = threading.Condition()
            self.ready = False

        def take(self):
            with self._cond:
                while not self.ready:
                    self._cond.wait(1.0)
                return self.ready
"""),
    "retry-after-discipline": ("RetryAfterRule", """
    class Handler:
        def _predict(self):
            try:
                work()
            except QueueFull as e:
                self._reply(429, {"error": str(e)})
""", """
    class Handler:
        def _predict(self):
            try:
                work()
            except QueueFull as e:
                self._reply(429, {"error": str(e)},
                            {"Retry-After": str(e.retry_after)})
"""),
}

#: the two repo-wide rules: (registered names, doc text)
DRIFT_CASES = {
    "metric-drift": ("MetricDriftRule",
                     'from telemetry import REGISTRY\n'
                     '_c = REGISTRY.counter("foo_total", "help")\n',
                     "| `gone_total` | counter |\n| `foo_total` | counter |\n",
                     "| `foo_total` | counter |\n"),
    "span-name-drift": ("SpanNameDriftRule",
                        'from telemetry import tracing\n'
                        '_ = tracing.span("engine.forward")\n',
                        "the `engine.fwd` stage\n",
                        "the `engine.forward` stage\n"),
}


def _lint(root, pkg_analyzer, rule, source, rel):
    path = root / rel
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(textwrap.dedent(source))
    return pkg_analyzer([rule], str(root)).run([rel])


def _analyzers(tmp_path):
    """(name, analyzer factory, walked package) of the three runs."""
    return [("ref", lambda rules, root: ref.Analyzer(rules, root=root),
             "znicz_tpu"),
            ("port@ref", lambda rules, root: port.Analyzer(
                rules, root=root, package="znicz_tpu"), "znicz_tpu"),
            ("port", lambda rules, root: port.Analyzer(rules, root=root),
             "znicz_tpu_torch")]


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "good"])
@pytest.mark.parametrize("rule_id", sorted(CASES))
def test_rule_case_through_both_analyzers(tmp_path, rule_id, bad):
    cls, bad_src, good_src = CASES[rule_id]
    found = {}
    for name, make, pkg in _analyzers(tmp_path):
        mod = ref if name == "ref" else port
        rel = f"{pkg}/serving/mod.py"
        found[name] = _lint(tmp_path / name, make, getattr(mod, cls)(),
                            bad_src if bad else good_src, rel)
    want = {(r, line, sev) for r, _p, line, sev in _keys(found["ref"])}
    for name in ("port@ref", "port"):
        assert {(r, line, sev) for r, _p, line, sev
                in _keys(found[name])} == want, name
    if bad:
        assert want and {r for r, _, _ in want} == {rule_id}
    else:
        assert want == set()


@pytest.mark.parametrize("bad", [True, False], ids=["bad", "good"])
@pytest.mark.parametrize("rule_id", sorted(DRIFT_CASES))
def test_repo_rule_case_through_both_analyzers(tmp_path, rule_id, bad):
    cls, code, bad_doc, good_doc = DRIFT_CASES[rule_id]
    found = {}
    for name, make, pkg in _analyzers(tmp_path):
        root = tmp_path / name
        (root / "docs").mkdir(parents=True)
        (root / "docs" / "obs.md").write_text(bad_doc if bad else good_doc)
        mod = ref if name == "ref" else port
        kw = {"doc_paths": ("docs/obs.md",)}
        if rule_id == "metric-drift":
            kw["script_paths"] = ()
        rule = getattr(mod, cls)(**kw)
        # the module lives in the walked package, so the universe holds it
        found[name] = _lint(root, make, rule, code, f"{pkg}/m.py")
    assert _keys(found["port@ref"]) == _keys(found["ref"])
    assert _keys(found["port"]) == _keys(found["ref"])
    assert bool(found["ref"]) == bad


def test_scoped_rules_patrol_the_walked_package(tmp_path):
    """The reference's literal ``znicz_tpu/serving/`` scope never matched
    the port's paths; the port's scopes are built from the package."""
    bad = CASES["deadline-discipline"][1]
    for pkg, rel, fires in (
            ("znicz_tpu_torch", "znicz_tpu_torch/serving/m.py", True),
            ("znicz_tpu_torch", "znicz_tpu_torch/resilience/m.py", True),
            ("znicz_tpu_torch", "znicz_tpu/serving/m.py", False),
            ("znicz_tpu_torch", "znicz_tpu_torch/telemetry/m.py", False),
            ("znicz_tpu", "znicz_tpu_torch/serving/m.py", False)):
        found = _lint(tmp_path / pkg / rel.replace("/", "_"),
                      lambda rules, root, _p=pkg: port.Analyzer(
                          rules, root=root, package=_p),
                      port.DeadlineDisciplineRule(), bad, rel)
        assert bool(found) == fires, (pkg, rel)
    # the reference's own rule over the port's path: silent (its fault)
    assert _lint(tmp_path / "ref", lambda rules, root: ref.Analyzer(
        rules, root=root), ref.DeadlineDisciplineRule(), bad,
        "znicz_tpu_torch/serving/m.py") == []


def test_universe_is_the_walked_package(tmp_path):
    """A subset run's repo-wide rules see the walked package's modules,
    not the reference's: a registration only under ``znicz_tpu/`` does
    not vouch for the port's doc reference."""
    for pkg in ("znicz_tpu", "znicz_tpu_torch"):
        (tmp_path / pkg).mkdir()
        (tmp_path / pkg / "a.py").write_text("x = 1\n")
    (tmp_path / "znicz_tpu" / "reg.py").write_text(
        'from telemetry import REGISTRY\n'
        '_c = REGISTRY.counter("foo_total", "help")\n')
    (tmp_path / "docs").mkdir()
    (tmp_path / "docs" / "obs.md").write_text("| `foo_total` | counter |\n")

    def run(pkg):
        rule = port.MetricDriftRule(doc_paths=("docs/obs.md",),
                                    script_paths=())
        return port.Analyzer([rule], root=str(tmp_path), package=pkg).run(
            [f"{pkg}/a.py"])

    assert run("znicz_tpu") == []
    assert [f.path for f in run("znicz_tpu_torch")] == ["docs/obs.md"]


# -- the CUDA-graph rules ---------------------------------------------------

GRAPH_BAD = """
    import functools

    import numpy as np
    import torch

    from ..parallel import capture


    def train(plan, data, batch):
        def step(variant):
            row = plan.row()
            x = data.index_select(0, row)
            n = x.sum().item()                  # host sync
            if x.max() > 0:                     # tensor branch
                plan.put("loss", x)
            plan.advance()

        plan.run("train", functools.partial(step, "train"))


    def serve(stream, static_x):
        def forward():
            y = torch.relu(static_x)
            while torch.any(y > 1):             # tensor branch
                y = y * 0.5
            host = np.asarray(y)                # host copy
            torch.cuda.synchronize()            # device wait

        return capture.capture(forward, stream, None)


    def probe(fn, scale):
        graph = torch.cuda.CUDAGraph()
        t = torch.zeros(3, device="cuda")
        with torch.cuda.graph(graph):
            fn(t)
            k = float(t)                        # frozen into the graph
            if t.cpu()[0] > 0:                  # sync + tensor branch
                fn(t)


    def bound(plan):
        def step(lr):
            scale = float(lr)                   # a parameter, frozen
            plan.put("loss", scale)

        plan.run("train", functools.partial(step, 0.1))
"""

#: per line marker in GRAPH_BAD: the rules expected there
GRAPH_WANT = {
    "# host sync": {"graph-host-sync"},
    "# tensor branch": {"graph-tensor-branch"},
    "# host copy": {"graph-host-sync"},
    "# device wait": {"graph-host-sync"},
    "# frozen into the graph": {"graph-host-sync"},
    "# sync + tensor branch": {"graph-host-sync", "graph-tensor-branch"},
    "# a parameter, frozen": {"graph-host-sync"},
}

GRAPH_GOOD = """
    import functools

    import torch


    def train(plan, data, batch, mask):
        def step(variant):
            row = plan.row()
            x = data.index_select(0, row)
            if variant == "eval":               # a host value bound once
                plan.put("n", x)
            if x.shape[0] > 1 and x.ndim == 2 and x.dtype == torch.float32:
                plan.put("n", x)
            if mask is None or len(x) > 2 or isinstance(x, torch.Tensor):
                plan.advance()
            if x.size(0) > 1 and x.device.type == "cuda":
                plan.advance()

            def helper(x=3):                    # shadows the tensor x
                if x > 1:
                    return float(x)

        plan.run("train", functools.partial(step, "train"))


    def eager(x):
        # not captured: host reads are this function's business
        if x.sum() > 0:
            return x.item(), x.cpu().numpy(), float(x)


    class Handler:
        def _capture(self, entry, x, y):
            # the traffic tap, not a graph: a method NAMED _capture
            if x.sum() > 0:
                self.cap.append(x.tolist(), y)

        def do_POST(self):
            self._capture(None, self.x, self.y)
            self.tap.run(self.x, self.y)
"""


def _graph_lint(tmp_path, src):
    return _lint(tmp_path, lambda r, root: port.Analyzer(r, root=root),
                 port.GraphHygieneRule(), src,
                 "znicz_tpu_torch/parallel/m.py")


def test_graph_rules_fire_in_captured_steps(tmp_path):
    found = _graph_lint(tmp_path, GRAPH_BAD)
    got: dict = {}
    for f in found:
        marker = f.context.split("#", 1)[1].strip() if "#" in f.context \
            else ""
        got.setdefault("# " + marker, set()).add(f.rule)
    assert got == GRAPH_WANT


def test_graph_rules_stay_silent_outside_captures_and_on_static_tests(
        tmp_path):
    assert _graph_lint(tmp_path, GRAPH_GOOD) == []


def test_graph_branch_rule_suppresses_apart(tmp_path):
    found = _graph_lint(tmp_path, GRAPH_BAD.replace(
        "# tensor branch", "# zlint: disable=graph-tensor-branch"))
    assert not any("x.max()" in f.context or "torch.any" in f.context
                   for f in found)
    assert {f.rule for f in found} == {"graph-host-sync",
                                       "graph-tensor-branch"}


TORCH_DRAWS_BAD = """
    import torch

    def init(w, x, probs):
        a = torch.rand(3)
        b = torch.randn_like(x)
        c = torch.randint(0, 5, (2,))
        d = torch.multinomial(probs, 2)
        w.uniform_(-0.1, 0.1)
        torch.nn.init.normal_(w)
        x.bernoulli_(0.5)
        return a, b, c, d
"""

TORCH_DRAWS_GOOD = """
    import torch

    def init(w, x, probs, seed):
        gen = torch.Generator().manual_seed(seed)
        a = torch.rand(3, generator=gen)
        c = torch.randint(0, 5, (2,), generator=gen)
        d = torch.multinomial(probs, 2, generator=gen)
        w.uniform_(-0.1, 0.1, generator=gen)
        torch.nn.init.normal_(w, generator=gen)
        x.bernoulli_(0.5, generator=gen)
        y = torch.zeros(3).fill_(1.0)
        return a, c, d, y
"""


def test_unseeded_torch_draws(tmp_path):
    found = _lint(tmp_path / "bad", lambda r, root: port.Analyzer(
        r, root=root), port.UnseededRandomRule(), TORCH_DRAWS_BAD,
        "znicz_tpu_torch/m.py")
    assert {f.rule for f in found} == {"unseeded-random"}
    assert len(found) == 7
    assert _lint(tmp_path / "good", lambda r, root: port.Analyzer(
        r, root=root), port.UnseededRandomRule(), TORCH_DRAWS_GOOD,
        "znicz_tpu_torch/m.py") == []


# -- discovery over the port's own code -------------------------------------

#: file → the source text of each line that captures a callable
CAPTURE_SITES = {
    "parallel/fused.py": ["plan.run(variant, functools.partial(step, "
                          "variant))"],
    "parallel/som.py": ['plan.run("train", step)'],
    "parallel/rbm.py": ['plan.run("train", step)'],
    "serving/engine.py": ["self.graph = capture.capture(forward, "
                          "torch.cuda.Stream(self.device),"],
    "parallel/capture.py": ["with torch.cuda.graph(graph, pool=pool, "
                            "stream=stream,"],
    **{f"{probe}_probe.py": ["with torch.cuda.graph(graph):"]
       for probe in ("act", "conv_tc", "kohonen", "lrn", "lrn_pool",
                     "softmax", "update")},
}


def _source(rel):
    with open(os.path.join(REPO, "znicz_tpu_torch", rel)) as fh:
        return fh.read()


@pytest.mark.parametrize("rel", sorted(CAPTURE_SITES))
def test_discovers_the_ports_captured_callables(rel):
    import ast
    src = _source(rel)
    lines = src.splitlines()
    want = sorted(i for i, text in enumerate(lines, start=1)
                  for site in CAPTURE_SITES[rel] if text.strip() == site)
    assert want, f"{rel}: capture site text moved"
    got = sorted(c.site for c in port.find_captured(ast.parse(src)))
    assert got == want


def test_server_traffic_tap_is_not_a_graph():
    import ast
    src = _source("serving/server.py")
    assert "def _capture(self, entry" in src
    assert port.find_captured(ast.parse(src)) == []


def test_planted_item_and_branch_in_the_fused_step_fire(tmp_path):
    """The real fused step with a ``.item()`` and a tensor ``if`` planted
    after its plan-row read: both fire, and nothing else."""
    src = _source("parallel/fused.py")
    anchor = "            row = plan.row()\n"
    assert src.count(anchor) == 1
    planted = src.replace(anchor, anchor
                          + "            if row.sum() > 0:\n"
                          + "                lost = row[0].item()\n")
    found = _lint(tmp_path, lambda r, root: port.Analyzer(r, root=root),
                  port.GraphHygieneRule(), planted,
                  "znicz_tpu_torch/parallel/fused.py")
    assert sorted((f.rule, f.context) for f in found) == [
        ("graph-host-sync", "lost = row[0].item()"),
        ("graph-tensor-branch", "if row.sum() > 0:")]
    assert _lint(tmp_path / "clean", lambda r, root: port.Analyzer(
        r, root=root), port.GraphHygieneRule(), src,
        "znicz_tpu_torch/parallel/fused.py") == []


# -- the gate ---------------------------------------------------------------

@pytest.fixture(scope="module")
def port_run():
    return port.run_repo(root=REPO)


@pytest.mark.lint
def test_port_has_no_new_findings(port_run):
    findings, new, _ = port_run
    assert findings, "the baseline's entries are live findings"
    assert not new, (
        "zlint found new issues in the port (fix them, add an inline "
        "`# zlint: disable=RULE` with a comment, or baseline "
        "deliberately):\n" + "\n".join(f.render() for f in new))


@pytest.mark.lint
def test_baseline_entries_are_justified_and_live(port_run):
    findings, _, _ = port_run
    with open(os.path.join(REPO, port_cli.DEFAULT_BASELINE)) as fh:
        entries = json.load(fh)["entries"]
    live: dict = {}
    for f in findings:
        live.setdefault(f.key(), []).append(f.message)
    assert len(entries) == len(findings)
    for e in entries:
        key = (e["rule"], e["path"], e["context"])
        note = e.get("note", "")
        assert note and "TODO" not in note, e
        assert key in live, f"stale baseline entry: {e}"
        m = re.match(r"not ported yet: `(\w+)` .* queue 1 item (9|10|11) ",
                     note)
        if e["rule"] == "metric-drift" and m is None:
            assert "`duration_ms`" in note, e
        elif m is not None:
            # porting the item registers the metric: the entry goes stale
            assert any(f"'{m.group(1)}'" in msg for msg in live[key]), e


# -- the CLI ----------------------------------------------------------------

@pytest.mark.lint
def test_cli_lint_json_exits_zero():
    proc = subprocess.run(
        [sys.executable, "-m", "znicz_tpu_torch", "lint", "--format",
         "json"], capture_output=True, text=True, timeout=300, cwd=REPO)
    assert proc.returncode == 0, proc.stdout[-2000:] + proc.stderr[-2000:]
    out = json.loads(proc.stdout)
    assert out["ok"] is True and out["findings"] == []
    assert out["baselined"] > 0


def test_cli_list_rules_names_the_graph_rules(capsys):
    assert port_cli.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in port_cli.default_rules():
        assert rule.id in out
    for rid in ("graph-host-sync", "graph-tensor-branch", "lock-leak",
                "retry-after-discipline"):
        assert rid in out
    assert "jit-host-sync" not in out


def test_cli_offending_file_exits_one(tmp_path, capsys):
    pkg = tmp_path / "znicz_tpu_torch"
    pkg.mkdir()
    (pkg / "bad.py").write_text(textwrap.dedent(LOCKED_BAD))
    assert port_cli.main(["--root", str(tmp_path), "--format",
                          "json"]) == 1
    out = json.loads(capsys.readouterr().out)
    assert not out["ok"]
    assert [f["rule"] for f in out["findings"]] == ["lock-discipline"]
    (pkg / "bad.py").write_text(textwrap.dedent(LOCKED_GOOD))
    assert port_cli.main(["--root", str(tmp_path)]) == 0


def test_cli_changed_and_write_baseline(tmp_path, capsys):
    """``--changed`` lints the walked package's touched files;
    ``--write-baseline`` refuses a subset and keeps hand-written
    notes."""
    def git(*args):
        subprocess.run(["git", *args], cwd=tmp_path, check=True,
                       capture_output=True)

    pkg = tmp_path / "znicz_tpu_torch"
    pkg.mkdir()
    (pkg / "clean.py").write_text("x = 1\n")
    git("init", "-q")
    git("config", "user.email", "t@t")
    git("config", "user.name", "t")
    git("add", "-A")
    git("commit", "-qm", "seed")
    assert port_cli.main(["--changed", "--root", str(tmp_path)]) == 0
    (pkg / "clean.py").write_text(textwrap.dedent(LOCKED_BAD))
    assert port_cli.changed_paths(str(tmp_path)) == [
        "znicz_tpu_torch/clean.py"]
    assert port_cli.main(["--changed", "--root", str(tmp_path)]) == 1
    with pytest.raises(SystemExit) as exc:
        port_cli.main(["--changed", "--write-baseline", "--root",
                       str(tmp_path)])
    assert exc.value.code == 2
    bl = port_cli.DEFAULT_BASELINE
    (tmp_path / bl).parent.mkdir(parents=True)
    assert port_cli.main(["--write-baseline", "--root",
                          str(tmp_path)]) == 0
    data = json.loads((tmp_path / bl).read_text())
    data["entries"][0]["note"] = "deliberate: a test's own note"
    (tmp_path / bl).write_text(json.dumps(data))
    assert port_cli.main(["--write-baseline", "--root",
                          str(tmp_path)]) == 0
    assert json.loads((tmp_path / bl).read_text())["entries"][0][
        "note"] == "deliberate: a test's own note"
    capsys.readouterr()
    assert port_cli.main(["--root", str(tmp_path)]) == 0
