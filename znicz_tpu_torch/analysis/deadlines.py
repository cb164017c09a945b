"""zlint rule: unbounded blocking waits on serving dispatch paths.

The overload-defense PR made "every wait is bounded" a load-bearing
contract: a request carries an end-to-end deadline, and every hop
between admission and answer checks it — which is meaningless if any
hop can park forever in a timeout-less primitive.  The bug class is
real here: the graceful-drain work audited exactly these (a
``Queue.get()`` with no timeout in a dispatch loop survives SIGTERM
forever; an ``Event.wait()`` with no bound turns a lost notify into a
hung request).

Scope: modules under ``<pkg>/serving/``, ``<pkg>/resilience/``,
``<pkg>/fleet/`` and ``<pkg>/online/`` of the walked package ``<pkg>``
(``ModuleInfo.package``; the port's by default) — the request path plus
the live-data loop riding it (the capture tap runs on the request
path; the replay tailer's bounded-poll contract is exactly a deadline
discipline).  Flagged calls:

* ``X.wait()`` with no arguments and no ``timeout=`` — ``Event``/
  ``Condition``/``subprocess`` waits block forever (the bounded forms
  pass a timeout);
* ``X.join()`` with no arguments — unbounded thread join (the
  handler-blocking rule flags these only on handler-reachable
  methods; on the request path the discipline is unconditional);
* ``X.get()`` with no arguments, or with ``block=True``/a literal
  ``True`` first argument and no ``timeout=`` — ``queue.Queue.get``
  blocks forever (``dict.get`` always takes a key argument, so the
  zero-argument shape is queue-like by construction; receivers named
  ``*var`` are exempt — ``ContextVar.get()`` never blocks and
  ``_something_var`` is this repo's contextvar naming);
* ``urlopen(...)`` / ``socket.create_connection(...)`` without
  ``timeout=`` — a peer that stops answering wedges the thread.

Justified cases get an inline ``# zlint: disable=deadline-discipline``
or a noted entry in the baseline — the point is that
an unbounded wait on the request path is a *reviewed decision*, never
an accident.
"""

from __future__ import annotations

import ast

from .core import Rule, dotted as _dotted, scope_prefixes

#: the walked package's subdirectories this rule patrols (the request
#: path — the fleet router's forward/probe hops are as much a part of
#: it as the serving front they fan out to; the online subsystem's
#: capture tap rides the request path and its replay tailer feeds a
#: trainer whose rounds promise bounded waits, so it patrols too)
SCOPE_DIRS = ("serving", "resilience", "fleet", "online")


def _has_timeout_kw(node: ast.Call) -> bool:
    return any(kw.arg == "timeout" for kw in node.keywords)


class DeadlineDisciplineRule(Rule):
    id = "deadline-discipline"
    severity = "error"
    doc = ("unbounded blocking wait (Queue.get / Event.wait / "
           "Condition.wait / join / socket connect) on a serving "
           "dispatch path — pass a timeout")

    def check(self, module) -> list:
        if not module.path.startswith(scope_prefixes(module.package,
                                                     SCOPE_DIRS)):
            return []
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            msg = self._violation(node)
            if msg is not None:
                findings.append(module.finding(self, node, msg))
        return findings

    def _violation(self, node: ast.Call) -> str | None:
        path = _dotted(node.func)
        if path is not None and path[-1] in ("urlopen",
                                             "create_connection") \
                and not _has_timeout_kw(node):
            return (f"{path[-1]} without timeout= can block this "
                    f"serving thread forever")
        if not isinstance(node.func, ast.Attribute):
            return None
        name = node.func.attr
        if name in ("wait", "join") and not node.args \
                and not node.keywords:
            return (f"unbounded .{name}() — a dead peer or lost "
                    f"notify wedges this thread past every deadline; "
                    f"pass a timeout")
        if name == "get":
            # ContextVar.get() never blocks; the repo names contextvars
            # *_var, so that receiver shape is exempt rather than
            # demanding a pragma at every propagation site
            recv = _dotted(node.func.value)
            if recv is not None and recv[-1].endswith("var"):
                return None
            blocking_pos = (len(node.args) == 1
                            and isinstance(node.args[0], ast.Constant)
                            and node.args[0].value is True)
            blocking_kw = any(kw.arg == "block"
                              and isinstance(kw.value, ast.Constant)
                              and kw.value.value is True
                              for kw in node.keywords)
            if (not node.args and not node.keywords) \
                    or ((blocking_pos or blocking_kw)
                        and not _has_timeout_kw(node)):
                return ("blocking .get() without a timeout — "
                        "queue.Queue.get parks forever; pass "
                        "timeout= so the deadline can fire")
        return None
