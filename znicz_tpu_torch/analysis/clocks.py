"""zlint rule: wall-clock durations (``duration-clock``).

``time.time()`` is the wall clock: NTP steps it, leap smearing skews
it, and a VM migration can jump it minutes in either direction.  Any
duration computed from it — ``time.time() - t0``, a wall-clock
deadline loop — silently goes wrong exactly when nobody is looking.
Library code must measure elapsed time with ``time.monotonic()`` or
``time.perf_counter()``; ``time.time()`` is for *stamps* (log
correlation, cross-process record fields), never arithmetic.

What fires:

* a ``time.time()`` call appearing directly in arithmetic
  (``+``/``-``) or a comparison — ``deadline = time.time() + 30``,
  ``while time.time() < deadline``, ``age = time.time() - t0``;
* a name assigned from ``time.time()`` that the same function later
  uses in a subtraction or comparison (``t0 = time.time(); ...;
  dt = something - t0``).

What stays silent: bare stamping (``{"at": time.time()}``,
``started = time.time()`` never subtracted), and every monotonic /
perf_counter use.  ``from time import time [as x]`` and ``import time
as t`` are both resolved — renaming the import does not dodge the
rule.

Deliberate wall-clock durations exist (e.g. "how long ago" against a
cross-process wall stamp another host wrote) — suppress those inline
with ``# zlint: disable=duration-clock`` or a justified baseline
entry, like any other rule.
"""

from __future__ import annotations

import ast

from .core import Rule, dotted


def _time_call_names(tree) -> tuple:
    """``(module_aliases, func_names)`` — the local names that mean
    ``time.time`` in this module: every ``import time [as t]`` binding
    (so ``t.time()`` resolves) plus every ``from time import time
    [as x]`` binding (so a bare ``x()`` resolves)."""
    module_aliases, func_names = set(), set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                if alias.name == "time":
                    module_aliases.add(alias.asname or alias.name)
        elif isinstance(node, ast.ImportFrom) and node.module == "time":
            for alias in node.names:
                if alias.name == "time":
                    func_names.add(alias.asname or alias.name)
    return module_aliases, func_names


class DurationClockRule(Rule):
    id = "duration-clock"
    severity = "error"
    doc = ("time.time() used in duration arithmetic; durations need "
           "time.monotonic()/perf_counter() (wall clocks jump)")

    def _is_wall_call(self, node, names) -> bool:
        module_aliases, func_names = names
        if not isinstance(node, ast.Call):
            return False
        path = dotted(node.func)
        if path is None:
            return False
        if len(path) == 2 and path[1] == "time" \
                and path[0] in module_aliases:
            return True                  # time.time() / t.time()
        if path[-2:] == ("time", "time"):
            return True                  # datetime-style dotted tails
        return len(path) == 1 and path[0] in func_names

    def check(self, module) -> list:
        from_imports = _time_call_names(module.tree)
        findings = []
        flagged_lines = set()

        def flag(node, what):
            if node.lineno in flagged_lines:
                return     # one finding per line, not one per operand
            flagged_lines.add(node.lineno)
            findings.append(module.finding(
                self, node,
                f"{what} computes a duration from the wall clock "
                f"(time.time()); use time.monotonic() or "
                f"time.perf_counter() — wall clocks jump under "
                f"NTP/migration"))

        # pass 1: direct arithmetic / comparison on a time.time() call
        for node in ast.walk(module.tree):
            if isinstance(node, ast.BinOp) \
                    and isinstance(node.op, (ast.Add, ast.Sub)):
                if any(self._is_wall_call(op, from_imports)
                       for op in (node.left, node.right)):
                    flag(node, "arithmetic on time.time()")
            elif isinstance(node, ast.Compare):
                if any(self._is_wall_call(op, from_imports)
                       for op in ([node.left] + node.comparators)):
                    flag(node, "comparison against time.time()")

        # pass 2: per-scope dataflow — a name assigned from
        # time.time() anywhere in a scope AND subtracted/compared in
        # that same scope (order-free: a linter over-approximates and
        # lets suppressions carry the rare deliberate case)
        def scope_nodes(scope):
            """Nodes of one scope, nested function bodies pruned —
            a nested def's stamp must not leak into its enclosing
            scope's flagging (it is its own entry in ``scopes``)."""
            stack = list(ast.iter_child_nodes(scope))
            while stack:
                node = stack.pop()
                yield node
                if not isinstance(node, (ast.FunctionDef,
                                         ast.AsyncFunctionDef)):
                    stack.extend(ast.iter_child_nodes(node))

        scopes = [module.tree] + [
            n for n in ast.walk(module.tree)
            if isinstance(n, (ast.FunctionDef, ast.AsyncFunctionDef))]
        for scope in scopes:
            nodes = list(scope_nodes(scope))
            stamped = {tgt.id for node in nodes
                       if isinstance(node, ast.Assign)
                       and self._is_wall_call(node.value, from_imports)
                       for tgt in node.targets
                       if isinstance(tgt, ast.Name)}
            if not stamped:
                continue
            for node in nodes:
                if isinstance(node, ast.BinOp) \
                        and isinstance(node.op, ast.Sub):
                    for op in (node.left, node.right):
                        if isinstance(op, ast.Name) and op.id in stamped:
                            flag(node, f"subtraction on {op.id!r} "
                                       f"(assigned from time.time())")
                elif isinstance(node, ast.Compare):
                    for op in [node.left] + node.comparators:
                        if isinstance(op, ast.Name) and op.id in stamped:
                            flag(node, f"comparison on {op.id!r} "
                                       f"(assigned from time.time())")
        return findings
