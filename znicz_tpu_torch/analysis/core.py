"""zlint core: file walker, rule registry, findings, suppressions,
baseline (port of ``znicz_tpu/analysis/core.py``).

The port's threaded serving/resilience/telemetry code and its captured
CUDA-graph steps invite the same bug classes as the reference's: lock
discipline, host syncs inside a captured step, blocking calls in HTTP
handlers, metric-name drift between code and docs.  This module is the
small framework those rules plug into; the rules themselves live in
``locks.py`` / ``torchrules.py`` / ``handlers.py`` / ``metric_drift.py``.

The package walked is a parameter (``Analyzer(package=...)``, default
``znicz_tpu_torch``): the per-module pass AND the module universe the
repo-wide rules see both walk it, and the scoped rules build their path
prefixes from its name (``ModuleInfo.package``).  Pointed at
``znicz_tpu`` the shared rules give the reference's findings.

Design points:

* **Pure stdlib** (``ast`` + ``tokenize``-free line scanning): the gate
  must run on every host the tests run on, with no new dependencies.
* **Suppressions** are source-visible: ``# zlint: disable=RULE`` (or
  ``disable=all``) on the flagged line, on a standalone comment line
  directly above it, or on a ``def``/``class`` line to cover the whole
  block.  A suppression is a reviewed decision, greppable next to the
  code it covers.
* **Baseline** (``znicz_tpu_torch/analysis/zlint_baseline.json``)
  carries deliberate findings that are awkward to annotate inline (e.g.
  in generated or vendored code, or the reference's documents).  Entries match on ``(rule, path, context)`` where
  ``context`` is the stripped source line — robust to line-number
  drift, invalidated the moment the flagged code actually changes.
"""

from __future__ import annotations

import ast
import dataclasses
import json
import os
import re

SEVERITIES = ("error", "warning")


def self_attr(node) -> str | None:
    """``self.X`` attribute node → ``"X"``, else None (shared by the
    class-shape rules: locks, handlers)."""
    if (isinstance(node, ast.Attribute)
            and isinstance(node.value, ast.Name)
            and node.value.id == "self"):
        return node.attr
    return None


def dotted(node) -> tuple | None:
    """``a.b.c`` name chain → ``("a", "b", "c")``; None for anything
    that isn't a pure Name/Attribute chain."""
    parts = []
    while isinstance(node, ast.Attribute):
        parts.append(node.attr)
        node = node.value
    if isinstance(node, ast.Name):
        parts.append(node.id)
        return tuple(reversed(parts))
    return None


def scope_prefixes(package: str, dirs) -> tuple:
    """Root-relative prefixes ``<package>/<dir>/`` of a scoped rule."""
    return tuple(f"{package}/{d}/" for d in dirs)


#: ``# zlint: disable=rule-a,rule-b`` (anywhere in a line's trailing
#: comment); the special rule name ``all`` silences every rule
_DISABLE_RE = re.compile(r"#\s*zlint:\s*disable=([a-zA-Z0-9_,\- ]+)")


@dataclasses.dataclass(frozen=True)
class Finding:
    """One rule violation at ``path:line``."""

    rule: str
    path: str            # root-relative, forward slashes
    line: int
    message: str
    severity: str = "error"
    context: str = ""    # stripped source line, the baseline match key

    def key(self) -> tuple:
        """Baseline identity: line numbers drift, source lines don't."""
        return (self.rule, self.path, self.context)

    def to_dict(self) -> dict:
        return dataclasses.asdict(self)

    def render(self) -> str:
        return (f"{self.path}:{self.line}: {self.severity}: "
                f"[{self.rule}] {self.message}")


class Rule:
    """Base class: one rule id, checked per parsed module."""

    id = "rule"
    severity = "error"
    doc = ""

    def check(self, module: "ModuleInfo") -> list:
        """Findings for one module (most rules override this)."""
        return []


class RepoRule(Rule):
    """A rule that needs the whole walked set at once (cross-file
    consistency checks like metric-name drift)."""

    def check_repo(self, modules: list, root: str) -> list:
        return []


class ModuleInfo:
    """One parsed source file plus its suppression map."""

    def __init__(self, root: str, path: str, source: str,
                 package: str = "znicz_tpu_torch"):
        self.root = root
        self.path = path.replace(os.sep, "/")
        #: the walked package; the scoped rules patrol ``<package>/...``
        self.package = package
        self.source = source
        self.lines = source.splitlines()
        self.tree = ast.parse(source, filename=path)
        self._disabled = self._scan_disables()

    # -- suppressions -----------------------------------------------------
    def _scan_disables(self) -> dict:
        """line (1-based) -> set of disabled rule ids on that line."""
        disabled: dict[int, set] = {}
        for i, text in enumerate(self.lines, start=1):
            m = _DISABLE_RE.search(text)
            if not m:
                continue
            rules = {r.strip() for r in m.group(1).split(",") if r.strip()}
            disabled.setdefault(i, set()).update(rules)
            if text.lstrip().startswith("#"):
                # a standalone comment line covers the line below it
                disabled.setdefault(i + 1, set()).update(rules)
        # a disable on a def/class header line covers the whole block
        for node in ast.walk(self.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                rules = disabled.get(node.lineno)
                if rules:
                    for ln in range(node.lineno,
                                    (node.end_lineno or node.lineno) + 1):
                        disabled.setdefault(ln, set()).update(rules)
        return disabled

    def suppressed(self, rule: str, line: int) -> bool:
        rules = self._disabled.get(line, ())
        return "all" in rules or rule in rules

    # -- finding construction ---------------------------------------------
    def line_text(self, line: int) -> str:
        if 1 <= line <= len(self.lines):
            return self.lines[line - 1].strip()
        return ""

    def finding(self, rule: Rule, node, message: str,
                severity: str | None = None) -> Finding:
        line = getattr(node, "lineno", 0) or 0
        return Finding(rule=rule.id, path=self.path, line=line,
                       message=message,
                       severity=severity or rule.severity,
                       context=self.line_text(line))


# -- baseline --------------------------------------------------------------

def load_baseline(path: str) -> set:
    """The set of baselined ``Finding.key()`` tuples (empty when the
    file is absent — a missing baseline means "everything is new")."""
    try:
        with open(path) as fh:
            data = json.load(fh)
    except FileNotFoundError:
        return set()
    keys = set()
    for entry in data.get("entries", []):
        keys.add((entry["rule"], entry["path"], entry["context"]))
    return keys


def write_baseline(path: str, findings: list) -> None:
    """Regenerate the baseline from the current finding set.  New
    entries carry a ``note`` slot the author is expected to fill in —
    an un-annotated baseline is just a muted bug list.  Hand-written
    notes on entries that survive the regeneration are carried
    forward, never clobbered back to TODO."""
    kept_notes = {}
    try:
        with open(path) as fh:
            for entry in json.load(fh).get("entries", []):
                kept_notes[(entry["rule"], entry["path"],
                            entry["context"])] = entry.get("note", "")
    except (FileNotFoundError, ValueError, KeyError):
        pass
    entries = [{"rule": f.rule, "path": f.path, "context": f.context,
                "note": kept_notes.get(f.key())
                or f"TODO justify: {f.message}"[:160]}
               for f in sorted(findings,
                               key=lambda f: (f.path, f.line, f.rule))]
    with open(path, "w") as fh:
        json.dump({"version": 1,
                   "comment": "deliberate zlint findings; every entry "
                              "needs a justifying note",
                   "entries": entries}, fh, indent=1)
        fh.write("\n")


# -- walking / running ------------------------------------------------------

#: the package walked when the caller names none
DEFAULT_PACKAGE = "znicz_tpu_torch"

#: directory basenames never descended into (``build`` holds the port's
#: kernel libraries)
_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", "node_modules",
              "build", "dist"}


def iter_py_files(root: str, rel_dirs=(DEFAULT_PACKAGE,)):
    """Root-relative paths of every .py file under ``rel_dirs``."""
    for rel in rel_dirs:
        top = os.path.join(root, rel)
        if os.path.isfile(top) and top.endswith(".py"):
            yield rel.replace(os.sep, "/")
            continue
        for dirpath, dirnames, filenames in os.walk(top):
            dirnames[:] = sorted(d for d in dirnames
                                 if d not in _SKIP_DIRS)
            for fn in sorted(filenames):
                if fn.endswith(".py"):
                    full = os.path.join(dirpath, fn)
                    yield os.path.relpath(full, root).replace(os.sep, "/")


def default_root() -> str:
    """The repo root: cwd when it contains the port's package, else the
    package's own parent (so the tool works from any cwd)."""
    if os.path.isdir(os.path.join(os.getcwd(), DEFAULT_PACKAGE)):
        return os.getcwd()
    here = os.path.dirname(os.path.abspath(__file__))
    return os.path.dirname(os.path.dirname(here))


class Analyzer:
    """Walk → parse → run rules → filter suppressions and baseline."""

    def __init__(self, rules, root: str | None = None,
                 baseline_path: str | None = None,
                 package: str = DEFAULT_PACKAGE):
        self.rules = list(rules)
        self.root = root or default_root()
        #: the walked package (root-relative directory)
        self.package = package
        self.baseline_path = baseline_path
        self.baseline = (load_baseline(baseline_path)
                         if baseline_path else set())
        #: files that failed to parse, as findings (a syntax error in a
        #: walked file must fail the gate, not vanish).  Reset on every
        #: run() — it reports ONE run, not the Analyzer's lifetime.
        self.parse_errors: list[Finding] = []

    def load(self, rel_paths, record_errors: bool = True) -> list:
        modules = []
        for rel in rel_paths:
            full = os.path.join(self.root, rel)
            try:
                with open(full, encoding="utf-8") as fh:
                    source = fh.read()
                modules.append(ModuleInfo(self.root, rel, source,
                                          self.package))
            except (SyntaxError, UnicodeDecodeError, OSError) as e:
                if record_errors:
                    self.parse_errors.append(Finding(
                        rule="parse-error",
                        path=rel.replace(os.sep, "/"),
                        line=getattr(e, "lineno", 0) or 0,
                        message=f"could not analyze: {e}",
                        severity="error"))
        return modules

    def run(self, rel_paths=None) -> list:
        """All non-suppressed findings, sorted; baseline filtering is
        :meth:`new_findings`' job so callers can show both views."""
        self.parse_errors = []
        walked = list(iter_py_files(self.root, (self.package,)))
        if rel_paths is None:
            rel_paths = walked
        modules = self.load(rel_paths)
        # repo-wide rules (metric drift) need the FULL module universe
        # even when the caller restricted the per-module pass — a
        # subset run must not turn every out-of-subset registration
        # into a spurious "unregistered reference" (syntax errors in
        # out-of-subset files are that subset's problem, not this
        # run's)
        requested = {m.path for m in modules}
        universe = modules + self.load(
            [p for p in walked if p not in requested],
            record_errors=False)
        by_path = {m.path: m for m in universe}
        findings = list(self.parse_errors)
        for rule in self.rules:
            if isinstance(rule, RepoRule):
                found = rule.check_repo(universe, self.root)
            else:
                found = [f for m in modules for f in rule.check(m)]
            for f in found:
                mod = by_path.get(f.path)
                if mod is not None and mod.suppressed(f.rule, f.line):
                    continue
                findings.append(f)
        return sorted(findings, key=lambda f: (f.path, f.line, f.rule))

    def new_findings(self, findings) -> list:
        return [f for f in findings if f.key() not in self.baseline]
