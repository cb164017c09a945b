"""zlint rule: lock discipline for threaded classes.

The bug class (seen in the PR-3 profiler deadlock and the ElasticRunner
co-death flake): a class shares mutable attributes between a caller
thread and a worker thread, guards them with ``with self._lock:`` in
most places, and forgets one site — which reads torn state rarely
enough to only fail under load.

Inference, per class:

1. **Lock attributes**: ``self.X`` assigned ``threading.Lock()`` /
   ``RLock()`` / ``Condition()``, or used as a ``with self.X:`` context
   with a lock-ish name (``*lock*`` / ``*cond*`` / ``*mutex*``).
2. **Guarded attributes**: ``self.Y`` accessed at least once inside a
   ``with self.<lock>:`` block anywhere in the class, AND mutated
   somewhere outside ``__init__`` (assignment, ``del``, subscript
   store, or a known mutator method call like ``.append``).  The
   mutation requirement keeps immutable config (``self.max_batch``)
   that merely *appears* inside a locked region out of the guarded set.
3. **Lock-held helpers**: a private method (``_name``) whose every
   intra-class call site is inside a locked region (directly or via
   another lock-held method) runs under the lock by construction —
   its accesses count as guarded.  This is the ``_queued_rows`` idiom:
   helpers factored out of locked regions must not need suppressions.
4. **Flag** every access (read or write) to a guarded attribute outside
   any locked region, outside ``__init__`` (construction
   happens-before publication to other threads).

``__init__`` aside, there is no "single-threaded method" exemption:
every class that owns a lock shares state across threads, and which
methods the *other* thread reaches is exactly what nobody re-audits
when code moves.  Deliberate lock-free reads get an inline
``# zlint: disable=lock-discipline`` with a justifying comment.
"""

from __future__ import annotations

import ast
import dataclasses
import re

from .core import Rule, self_attr as _self_attr

_LOCKISH_NAME = re.compile(r"(lock|cond|mutex)", re.IGNORECASE)
_LOCK_CTORS = {"Lock", "RLock", "Condition"}

#: method names that mutate their receiver in place (stdlib containers)
_MUTATORS = {"append", "appendleft", "extend", "extendleft", "insert",
             "add", "discard", "remove", "pop", "popleft", "popitem",
             "clear", "update", "setdefault", "move_to_end", "sort",
             "reverse", "rotate", "subtract"}


@dataclasses.dataclass
class _Access:
    attr: str
    lineno: int       # named like the AST field so core.finding() works
    method: str
    in_lock: bool
    mutation: bool


def _is_lock_ctor(value) -> bool:
    """``threading.Lock()`` / ``Lock()`` / ``threading.Condition()``."""
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else None
    return name in _LOCK_CTORS


class _MethodScanner:
    """Collect every ``self.X`` access in one method body, annotated
    with lock depth and mutation-ness, plus intra-class call sites."""

    def __init__(self, method_name: str, lock_attrs: set):
        self.method = method_name
        self.lock_attrs = lock_attrs
        self.accesses: list[_Access] = []
        #: (callee method name, call-site-in-lock)
        self.calls: list[tuple[str, bool]] = []
        self.thread_targets: set[str] = set()

    def scan(self, node: ast.AST, in_lock: bool = False) -> None:
        for child in ast.iter_child_nodes(node):
            self._scan_node(child, in_lock)

    def _scan_node(self, node, in_lock: bool) -> None:
        if isinstance(node, ast.With):
            held = in_lock
            for item in node.items:
                ctx = item.context_expr
                attr = _self_attr(ctx)
                if attr is not None and attr in self.lock_attrs:
                    held = True
                self._scan_node(ctx, in_lock)
            for stmt in node.body:
                self._scan_node(stmt, held)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return            # nested scopes have their own self/outer
        if isinstance(node, (ast.Assign, ast.AugAssign, ast.AnnAssign,
                             ast.Delete)):
            targets = (node.targets if isinstance(node, ast.Assign)
                       else [node.target] if hasattr(node, "target")
                       else node.targets)
            value = getattr(node, "value", None)
            # a bare annotation (`self.x: int` with no value) has no
            # runtime effect; an annotated assignment mutates like any
            # other (AnnAssign must not demote a write to a read)
            if not (isinstance(node, ast.AnnAssign) and value is None):
                for t in targets:
                    self._scan_target(t, in_lock)
            if value is not None:
                self._scan_node(value, in_lock)
            return
        if isinstance(node, ast.Call):
            self._scan_call(node, in_lock)
            return
        attr = _self_attr(node)
        if attr is not None:
            self._record(attr, node.lineno, in_lock, mutation=False)
            return
        self.scan(node, in_lock)

    def _scan_target(self, target, in_lock: bool) -> None:
        """Assignment/del target: ``self.X = ...``, ``self.X[k] = ...``
        and tuple unpacking all mutate X."""
        attr = _self_attr(target)
        if attr is not None:
            self._record(attr, target.lineno, in_lock, mutation=True)
            return
        if isinstance(target, ast.Subscript):
            base = _self_attr(target.value)
            if base is not None:
                self._record(base, target.lineno, in_lock, mutation=True)
                self._scan_node(target.slice, in_lock)
                return
        if isinstance(target, (ast.Tuple, ast.List)):
            for elt in target.elts:
                self._scan_target(elt, in_lock)
            return
        if isinstance(target, ast.Starred):
            self._scan_target(target.value, in_lock)
            return
        self._scan_node(target, in_lock)

    def _scan_call(self, node: ast.Call, in_lock: bool) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            direct = _self_attr(fn)       # self.X(...): call edge to X
            base = _self_attr(fn.value)   # self.X.m(...): receiver X
            if direct is not None:
                self.calls.append((direct, in_lock))
                self._record(direct, fn.lineno, in_lock, mutation=False)
            elif base is not None:
                if fn.attr in _MUTATORS:
                    self._record(base, fn.value.lineno, in_lock,
                                 mutation=True)
                else:
                    self._record(base, fn.value.lineno, in_lock,
                                 mutation=False)
            else:
                self._scan_node(fn.value, in_lock)
        elif isinstance(fn, ast.Name):
            pass
        else:
            self._scan_node(fn, in_lock)
        # threading.Thread(target=self.X) marks X as a thread entry
        for kw in node.keywords:
            if kw.arg == "target":
                attr = _self_attr(kw.value)
                if attr is not None:
                    self.thread_targets.add(attr)
        for arg in node.args:
            self._scan_node(arg, in_lock)
        for kw in node.keywords:
            self._scan_node(kw.value, in_lock)

    def _record(self, attr: str, line: int, in_lock: bool,
                mutation: bool, is_call: bool = False) -> None:
        if attr in self.lock_attrs:
            return
        if is_call:
            return        # method references are resolved via `calls`
        self.accesses.append(_Access(attr, line, self.method,
                                     in_lock, mutation))


class LockDisciplineRule(Rule):
    id = "lock-discipline"
    severity = "error"
    doc = ("access to a lock-guarded attribute outside the lock "
           "(guarded = touched under `with self._lock:` somewhere and "
           "mutated outside __init__)")

    def check(self, module) -> list:
        findings = []
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef):
                findings.extend(self._check_class(module, node))
        return findings

    # -- per class --------------------------------------------------------
    def _lock_attrs(self, cls: ast.ClassDef) -> set:
        locks = set()
        for node in ast.walk(cls):
            if isinstance(node, ast.Assign):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None and _is_lock_ctor(node.value):
                        locks.add(attr)
            elif isinstance(node, ast.With):
                for item in node.items:
                    attr = _self_attr(item.context_expr)
                    if attr is not None and _LOCKISH_NAME.search(attr):
                        locks.add(attr)
        return locks

    def _check_class(self, module, cls: ast.ClassDef) -> list:
        lock_attrs = self._lock_attrs(cls)
        if not lock_attrs:
            return []
        methods = {n.name: n for n in cls.body
                   if isinstance(n, (ast.FunctionDef,
                                     ast.AsyncFunctionDef))}
        scanners = {}
        thread_targets: set[str] = set()
        for name, fn in methods.items():
            sc = _MethodScanner(name, lock_attrs)
            sc.scan(fn)
            scanners[name] = sc
            thread_targets |= sc.thread_targets

        # fixpoint: private helpers whose every intra-class call site is
        # lock-held run under the lock by construction
        call_sites: dict[str, list] = {}
        for caller, sc in scanners.items():
            for callee, in_lock in sc.calls:
                if callee in methods:
                    call_sites.setdefault(callee, []).append(
                        (caller, in_lock))
        lock_held: set[str] = set()
        changed = True
        while changed:
            changed = False
            for name, sites in call_sites.items():
                if (name in lock_held or not name.startswith("_")
                        or name.startswith("__")
                        or name in thread_targets):
                    continue
                if all(in_lock or caller in lock_held
                       for caller, in_lock in sites):
                    lock_held.add(name)
                    changed = True

        def effective_in_lock(acc: _Access) -> bool:
            return acc.in_lock or acc.method in lock_held

        all_accesses = [a for sc in scanners.values()
                        for a in sc.accesses]
        method_names = set(methods)
        guarded = {a.attr for a in all_accesses
                   if effective_in_lock(a)
                   and a.attr not in method_names
                   and not (a.attr.startswith("__")
                            and a.attr.endswith("__"))}
        mutated = {a.attr for a in all_accesses
                   if a.mutation and a.method != "__init__"}
        guarded &= mutated

        findings = []
        for acc in all_accesses:
            if (acc.attr in guarded and not effective_in_lock(acc)
                    and acc.method != "__init__"):
                verb = "written" if acc.mutation else "read"
                locks = "/".join(f"self.{a}" for a in sorted(lock_attrs))
                findings.append(module.finding(
                    self, acc,
                    f"{cls.name}.{acc.method}: 'self.{acc.attr}' is "
                    f"{verb} without holding {locks}, but is guarded "
                    f"by it elsewhere in the class"))
        return findings
