"""zlint rule: blocking calls in HTTP handlers and dispatch threads.

The serving front is a ``ThreadingHTTPServer``: every ``do_GET`` /
``do_POST`` body runs on a connection thread whose latency is a
client's latency, and the micro-batcher's dispatch loop is the ONE
thread all requests funnel through — a stray ``time.sleep``, a
subprocess, an unbounded ``.join()`` / ``.wait()``, or ad-hoc file I/O
in either place turns into tail latency or a full-stop stall (the PR-3
profiler hang was exactly a handler thread wedged in a C-level wait).

Scope, per class:

* **handler methods**: ``do_GET`` / ``do_POST`` / ``do_PUT`` /
  ``do_DELETE`` / ``do_HEAD`` / ``do_PATCH``, plus same-class helpers
  reachable from them through ``self.<helper>()`` calls;
* **dispatch methods**: any method used as a ``threading.Thread(
  target=self.X)`` entry, plus same-class helpers reachable from it.

Flagged: ``time.sleep``, any ``subprocess.*`` call, zero-argument
``.join()`` / ``.wait()`` (unbounded — the bounded forms pass a
timeout), ``urlopen`` without ``timeout=``, and (handlers only —
producer/dispatch threads exist to do I/O) direct ``open(...)`` calls.
"""

from __future__ import annotations

import ast

from .core import Rule, dotted as _dotted, self_attr as _self_attr

_HANDLER_NAMES = {"do_GET", "do_POST", "do_PUT", "do_DELETE",
                  "do_HEAD", "do_PATCH"}

_SLEEPS = {("time", "sleep"), ("gevent", "sleep")}


class HandlerSafetyRule(Rule):
    id = "handler-blocking"
    severity = "error"
    doc = ("blocking call (sleep / subprocess / unbounded join-wait / "
           "handler file I/O) on an HTTP-handler or dispatch-thread "
           "path")

    def check(self, module) -> list:
        findings = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, node))
        return findings

    def _check_class(self, module, cls: ast.ClassDef) -> list:
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        # entry points: do_* handlers + threading.Thread targets
        entries = {}            # method name -> "handler" | "dispatch"
        for name in methods:
            if name in _HANDLER_NAMES:
                entries[name] = "handler"
        for node in ast.walk(cls):
            if isinstance(node, ast.Call):
                path = _dotted(node.func)
                if path is not None and path[-1] == "Thread":
                    for kw in node.keywords:
                        if kw.arg == "target":
                            attr = _self_attr(kw.value)
                            if attr in methods:
                                entries.setdefault(attr, "dispatch")
        if not entries:
            return []
        # close over same-class helpers reachable via self.helper()
        calls: dict[str, set] = {name: set() for name in methods}
        for name, fn in methods.items():
            for node in ast.walk(fn):
                if isinstance(node, ast.Call) \
                        and isinstance(node.func, ast.Attribute):
                    callee = _self_attr(node.func)
                    if callee in methods:
                        calls[name].add(callee)
        reach = dict(entries)
        frontier = list(entries)
        while frontier:
            src = frontier.pop()
            for callee in calls.get(src, ()):
                if callee not in reach:
                    reach[callee] = reach[src]
                    frontier.append(callee)
        findings = []
        for name, kind in reach.items():
            findings.extend(self._check_method(module, cls, methods[name],
                                               kind))
        return findings

    def _check_method(self, module, cls, fn, kind: str) -> list:
        findings = []
        where = (f"{cls.name}.{fn.name} (HTTP handler path)"
                 if kind == "handler" else
                 f"{cls.name}.{fn.name} (dispatch-thread path)")
        for node in ast.walk(fn):
            if not isinstance(node, ast.Call):
                continue
            path = _dotted(node.func)
            pair = (path[-2], path[-1]) if path and len(path) >= 2 \
                else None
            if pair in _SLEEPS:
                findings.append(module.finding(
                    self, node,
                    f"{where}: time.sleep() blocks every request "
                    f"behind this thread"))
            elif path is not None and len(path) >= 2 \
                    and path[-2] == "subprocess":
                findings.append(module.finding(
                    self, node,
                    f"{where}: subprocess call on a serving thread "
                    f"(fork+exec latency, unbounded child runtime)"))
            elif isinstance(node.func, ast.Attribute) \
                    and node.func.attr in ("join", "wait") \
                    and not node.args and not node.keywords:
                findings.append(module.finding(
                    self, node,
                    f"{where}: unbounded .{node.func.attr}() — pass a "
                    f"timeout so a dead peer cannot wedge this thread"))
            elif path is not None and path[-1] == "urlopen" \
                    and not any(kw.arg == "timeout"
                                for kw in node.keywords):
                findings.append(module.finding(
                    self, node,
                    f"{where}: urlopen without timeout= can block "
                    f"forever"))
            elif kind == "handler" and isinstance(node.func, ast.Name) \
                    and node.func.id == "open":
                findings.append(module.finding(
                    self, node,
                    f"{where}: file I/O inside an HTTP handler body; "
                    f"move it off the request path"))
        return findings
