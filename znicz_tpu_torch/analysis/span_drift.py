"""zlint rule: span/stage-name drift between code and docs
(``span-name-drift``).

Distributed tracing made span and stage names a cross-process
contract: the backend tags ``tracing.span("engine.forward", ...)``,
the router's assembler splits the hop into the seven canonical stages
of ``tracestore.STAGES``, and ``docs/observability.md`` documents both
so an operator reading ``/tracez`` (or ``trace_stage_ms{stage=...}``)
can look a name up.  Renaming a span site or a stage in code silently
orphans the doc — the trace still assembles, but the documentation now
describes stages that no longer exist.

Cross-check, repo-wide:

* **Registered names**: every string constant in walked code shaped
  like a stage/span name — dotted, rooted in one of the known stage
  namespaces (``router.`` / ``server.`` / ``batcher.`` / ``engine.`` /
  ``net.``).  This covers ``tracing.span("batcher.dispatch", ...)``
  call sites, the ``tracestore.STAGES`` tuple, and the assembler's
  stage-key literals in one sweep.
* **References**: backticked dotted tokens with the same namespace
  roots in the traced docs (default: ``docs/observability.md``).

Finding: a doc references a span/stage name no code registers — the
rename (or removal) that left the documentation describing a ghost
stage.  The namespace-root constraint is what keeps prose like
``np.asarray`` or ``lax.scan`` out of the cross-check.
"""

from __future__ import annotations

import ast
import os
import re

from .core import Finding, RepoRule

#: docs cross-checked against the code's span/stage literals, root-rel
DEFAULT_DOC_PATHS = ("docs/observability.md",)

#: a token must be dotted AND rooted in a stage namespace to count —
#: `np.asarray`, `lax.scan`, `znicz_tpu_torch.telemetry` all stay prose
_STAGE_SHAPE = re.compile(
    r"^(?:router|server|batcher|engine|net)\.[a-z0-9_]+(?:\.[a-z0-9_]+)*$")

#: backticked dotted token, optionally carrying a label set
_BACKTICK = re.compile(r"`([a-z][a-z0-9_.]*)(\{[^`]*\})?`")


class SpanNameDriftRule(RepoRule):
    id = "span-name-drift"
    severity = "error"
    doc = ("span/stage name referenced in docs but never registered "
           "in code (renamed or removed tracing site)")

    def __init__(self, doc_paths=DEFAULT_DOC_PATHS):
        self.doc_paths = tuple(doc_paths)

    def _registered(self, modules) -> set:
        """Every stage-shaped string constant across the walked code —
        span() call sites, the STAGES tuple, assembler stage keys."""
        names: set[str] = set()
        for mod in modules:
            for node in ast.walk(mod.tree):
                if isinstance(node, ast.Constant) \
                        and isinstance(node.value, str) \
                        and _STAGE_SHAPE.match(node.value):
                    names.add(node.value)
        return names

    def check_repo(self, modules, root) -> list:
        registered = self._registered(modules)
        findings = []
        for rel in self.doc_paths:
            try:
                with open(os.path.join(root, rel),
                          encoding="utf-8") as fh:
                    lines = fh.read().splitlines()
            except OSError:
                continue
            seen: set[tuple] = set()
            for i, text in enumerate(lines, start=1):
                for name, _labels in _BACKTICK.findall(text):
                    if not _STAGE_SHAPE.match(name) \
                            or (name, i) in seen:
                        continue
                    seen.add((name, i))
                    if name not in registered:
                        findings.append(Finding(
                            rule=self.id, path=rel, line=i,
                            message=f"doc references span/stage "
                                    f"{name!r} but no code registers "
                                    f"it (renamed or removed tracing "
                                    f"site?)",
                            severity=self.severity,
                            context=text.strip()))
        return findings
