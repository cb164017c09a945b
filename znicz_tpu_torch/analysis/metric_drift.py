"""zlint rule: metric-name drift between code, docs, and smoke tooling.

The telemetry registry made metric names a cross-file contract:
``REGISTRY.counter("elastic_restarts_total", ...)`` in code, a row in
``docs/observability.md``'s inventory table, an assertion in
``tools/metrics_smoke.sh``, and Grafana dashboards nobody in this repo
can see.  Renaming one site silently breaks the others — the JSON and
text views can't disagree by construction, but code and docs can.

Cross-check, repo-wide:

* **Registered names**: constant first arguments of
  ``REGISTRY.counter/gauge/histogram(...)`` (and the module-level
  ``counter/gauge/histogram`` conveniences) across every walked module.
* **Collector families**: tuple literals shaped
  ``("counter"|"gauge"|"histogram", "name", help, samples)`` — the
  shape ``MetricsRegistry.register_collector`` samples — register
  their name too (``breaker_state`` et al).
* **Dynamic prefixes**: string constants matching ``name_`` (trailing
  underscore) used in collector code — the ``("serving_batcher_", …)``
  fan-out tuple shape AND ``"zoo_model_" + field`` concatenation *in a
  family tuple's name slot* (``("gauge", "zoo_model_" + f, …)``; a
  bare concat elsewhere must not whitelist a namespace) — whitelist
  every name they prefix.
* **References**: metric-shaped tokens in the doc inventory table, in
  backticks anywhere in the doc, and in the smoke scripts
  (``_bucket``/``_sum``/``_count`` histogram suffixes are folded onto
  their base series).  A backticked token carrying a label set
  (``model_resident{model="wine"}``) is a metric reference even when
  the bare name lacks a metric suffix — the zoo's ``model_*{model=…}``
  families read naturally in prose that way.

Findings: a referenced name nobody registers (**unregistered
reference** — the doc/smoke is asserting a series that no longer
exists) and a registered name the doc never mentions (**orphaned
registration** — an operator scraping ``/metrics`` can't look it up).
"""

from __future__ import annotations

import ast
import os
import re

from .core import Finding, RepoRule

#: docs / scripts cross-checked against the registered set, root-rel
DEFAULT_DOC_PATHS = ("docs/observability.md",)
DEFAULT_SCRIPT_PATHS = ("tools/metrics_smoke.sh",)

#: a token must look like a metric to count as a reference — suffix
#: morphology keeps prose words out of the cross-check
_METRIC_SHAPE = re.compile(
    r"^[a-z][a-z0-9_]*(_total|_ms|_seconds|_state|_epoch|_per_sec)$")

#: doc inventory-table row: ``| `name` | type | ...``
_TABLE_ROW = re.compile(r"^\|\s*`([a-z][a-z0-9_]*)`")

#: backticked token, optionally with a label set (`name{label=...}`);
#: group 2 (the label set) being present makes the token a metric
#: reference REGARDLESS of suffix morphology — `model_resident{model=
#: "wine"}` is unambiguously a metric even though a bare
#: `model_resident` would read as prose
_BACKTICK = re.compile(r"`([a-z][a-z0-9_]*)(\{[^`]*\})?`")

#: any identifier-ish token (for shell scripts)
_WORD = re.compile(r"[a-z][a-z0-9_]{3,}")

#: trailing-underscore string constants are dynamic-family prefixes
_PREFIX_SHAPE = re.compile(r"^[a-z][a-z0-9_]*_$")

_REG_METHODS = {"counter", "gauge", "histogram"}
_HISTO_SUFFIXES = ("_bucket", "_sum", "_count")


def _fold_histogram(name: str) -> str:
    for suf in _HISTO_SUFFIXES:
        if name.endswith(suf):
            return name[: -len(suf)]
    return name


class MetricDriftRule(RepoRule):
    id = "metric-drift"
    severity = "error"
    doc = ("metric name referenced in docs/smoke but never registered, "
           "or registered but undocumented")

    def __init__(self, doc_paths=DEFAULT_DOC_PATHS,
                 script_paths=DEFAULT_SCRIPT_PATHS):
        self.doc_paths = tuple(doc_paths)
        self.script_paths = tuple(script_paths)

    # -- code side --------------------------------------------------------
    def _registered(self, modules):
        """{name: (path, line)} for every constant registration site,
        plus the set of dynamic-family prefixes."""
        registered: dict[str, tuple] = {}
        prefixes: set[str] = set()
        for mod in modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Call):
                    fn = node.func
                    name = (fn.attr if isinstance(fn, ast.Attribute)
                            else fn.id if isinstance(fn, ast.Name)
                            else None)
                    if (name in _REG_METHODS and node.args
                            and isinstance(node.args[0], ast.Constant)
                            and isinstance(node.args[0].value, str)):
                        registered.setdefault(
                            node.args[0].value, (mod.path, node.lineno))
                elif isinstance(node, ast.Tuple) \
                        and len(node.elts) == 4:
                    # exactly the (kind, name, help, samples) family
                    # shape register_collector samples — shorter kind
                    # tuples (e.g. a ("counter", "gauge", "histogram")
                    # constant) must not self-register
                    first, second = node.elts[0], node.elts[1]
                    if (isinstance(first, ast.Constant)
                            and first.value in ("counter", "gauge",
                                                "histogram")):
                        if isinstance(second, ast.Constant) \
                                and isinstance(second.value, str):
                            registered.setdefault(
                                second.value, (mod.path, node.lineno))
                        elif (isinstance(second, ast.BinOp)
                              and isinstance(second.op, ast.Add)
                              and isinstance(second.left, ast.Constant)
                              and isinstance(second.left.value, str)
                              and _PREFIX_SHAPE.match(
                                  second.left.value)):
                            # a dynamic family name built by
                            # concatenation IN the family-name slot —
                            # ("gauge", "zoo_model_" + field, …) —
                            # registers its prefix.  Constrained to
                            # this slot on purpose: a bare
                            # '"model_" + x' elsewhere (a filename,
                            # a log tag) must NOT whitelist a whole
                            # metric namespace and mask drift
                            prefixes.add(second.left.value)
                if isinstance(node, ast.Tuple) and len(node.elts) == 2:
                    # the collector fan-out shape: ("serving_engine_",
                    # <metrics source>) — NOT every trailing-underscore
                    # string (tempfile prefixes would whitelist real
                    # metric families and mask drift)
                    first = node.elts[0]
                    if (isinstance(first, ast.Constant)
                            and isinstance(first.value, str)
                            and _PREFIX_SHAPE.match(first.value)):
                        prefixes.add(first.value)
        return registered, prefixes

    # -- reference side ---------------------------------------------------
    @staticmethod
    def _read_lines(root, rel):
        try:
            with open(os.path.join(root, rel), encoding="utf-8") as fh:
                return fh.read().splitlines()
        except OSError:
            return []

    def _doc_references(self, root, rel):
        """(name, line, context) tokens from one markdown doc."""
        refs, seen = [], set()
        for i, text in enumerate(self._read_lines(root, rel), start=1):
            m = _TABLE_ROW.match(text.strip())
            if m and (m.group(1), i) not in seen:
                seen.add((m.group(1), i))
                refs.append((m.group(1), i, text.strip()))
            for name, labels in _BACKTICK.findall(text):
                # a table row also matches the backtick scan — one
                # reference per (name, line), not two findings.  A
                # label set (`name{model=...}`) marks a metric
                # reference even when the bare name lacks a metric
                # suffix (the `model_*{model=...}` zoo families)
                if (labels or _METRIC_SHAPE.match(name)) \
                        and (name, i) not in seen:
                    seen.add((name, i))
                    refs.append((name, i, text.strip()))
        return refs

    def _script_references(self, root, rel):
        refs = []
        for i, text in enumerate(self._read_lines(root, rel), start=1):
            for word in _WORD.findall(text):
                folded = _fold_histogram(word)
                if _METRIC_SHAPE.match(folded):
                    refs.append((folded, i, text.strip()))
        return refs

    # -- the check --------------------------------------------------------
    def check_repo(self, modules, root) -> list:
        registered, prefixes = self._registered(modules)
        by_path = {m.path: m for m in modules}
        findings = []

        def known(name: str) -> bool:
            return (name in registered
                    or any(name.startswith(p) for p in prefixes))

        documented: set[str] = set()
        for rel in self.doc_paths:
            for name, line, context in self._doc_references(root, rel):
                documented.add(name)
                if not known(name):
                    findings.append(Finding(
                        rule=self.id, path=rel, line=line,
                        message=f"doc references metric {name!r} but "
                                f"no code registers it (renamed or "
                                f"removed?)",
                        severity=self.severity, context=context))
        for rel in self.script_paths:
            for name, line, context in self._script_references(root,
                                                               rel):
                if not known(name):
                    findings.append(Finding(
                        rule=self.id, path=rel, line=line,
                        message=f"smoke script references metric "
                                f"{name!r} but no code registers it",
                        severity=self.severity, context=context))
        for name, (path, line) in sorted(registered.items()):
            if name not in documented \
                    and not any(name.startswith(p) for p in prefixes):
                mod = by_path.get(path)
                findings.append(Finding(
                    rule=self.id, path=path, line=line,
                    message=f"metric {name!r} is registered here but "
                            f"docs/observability.md never mentions it "
                            f"(add an inventory row)",
                    severity=self.severity,
                    context=mod.line_text(line) if mod else ""))
        return findings
