"""zlint rules: lock-acquisition order, lock leaks, condition waits.

The zsan static layer.  ``lock-discipline`` (locks.py)
checks *what* a lock guards; these three rules check *how* locks are
taken — the deadlock class the ROADMAP's event-loop frontend rebuild
will multiply:

* ``lock-order-cycle`` — interprocedural lock-acquisition-order graph,
  in the lockdep tradition.  Per class, an edge ``A -> B`` is recorded
  when lock ``B`` is acquired while ``A`` is held: directly (nested
  ``with self.A: ... with self.B:``), via the intra-class call graph
  (a helper that acquires ``B``, called under ``A``), or via resolved
  cross-object calls (the zoo->engine->generation and router->backend
  chains: ``self.engine.reload()`` under the zoo lock pulls the
  engine's acquisition closure into the edge set).  Any cycle in the
  global graph is a potential deadlock and fails the gate.  Cross-
  object call targets are resolved conservatively — by unique method
  name among lock-owning classes, with a receiver-name hint
  (``entry.engine.X()`` matches ``ServingEngine``) to break ties;
  ambiguous calls contribute no edges rather than false ones.
  Reentrant re-acquisition of an already-held lock never produces an
  edge (RLock reentrancy is not an inversion), and edges between two
  *instances* of the same lock attribute are skipped (instance-level
  ordering is the runtime sanitizer's job — see
  :mod:`znicz_tpu_torch.sanitizer`).

* ``lock-leak`` — a bare ``X.acquire()`` whose release is not
  structurally guaranteed.  Accepted shapes: ``acquire()`` followed
  immediately by ``try/finally: X.release()``; ``acquire()`` inside a
  ``try`` whose ``finally`` releases ``X``; and the non-blocking probe
  idiom (``if not X.acquire(blocking=False): raise`` — the result is
  *used*) provided a ``X.release()`` exists somewhere in the same
  function.  Everything else leaks the lock on the first exception
  between acquire and release.

* ``condition-wait-predicate`` — ``cond.wait()`` outside a ``while``
  loop.  Condition variables wake spuriously and ``wait(timeout)``
  returns on timeout with the predicate still false; the only correct
  shape is ``while not pred: cond.wait(...)`` (or ``wait_for``, which
  loops internally and is never flagged).
"""

from __future__ import annotations

import ast
import dataclasses
import re
import types

from .core import RepoRule, Rule, dotted as _dotted, \
    self_attr as _self_attr

_LOCKISH_NAME = re.compile(r"(lock|cond|mutex)", re.IGNORECASE)
_CONDISH_NAME = re.compile(r"(cond|condition|(^|_)cv($|_))",
                           re.IGNORECASE)
_LOCK_CTORS = {"Lock", "RLock", "Condition"}

#: methods *of lock objects themselves* — a call like
#: ``self._lock.acquire()`` is a lock operation, not a cross-object
#: method call to another lock-owning class
_LOCK_OPS = {"acquire", "release", "locked", "wait", "wait_for",
             "notify", "notify_all"}

#: method names shared with stdlib containers/primitives: a
#: ``self._cache.get(k)`` is a dict lookup, not a call into whatever
#: lock-owning class happens to define ``get`` — these never resolve
#: cross-object (no edges beats wrong edges)
_GENERIC_METHODS = {
    "get", "put", "set", "pop", "add", "items", "keys", "values",
    "update", "clear", "remove", "discard", "append", "appendleft",
    "extend", "insert", "index", "count", "copy", "sort", "join",
    "start", "close", "read", "write", "send", "recv", "submit",
    "result", "is_set", "setdefault", "popitem", "popleft", "strip",
    "split", "format", "encode", "decode", "group", "match", "search",
    "info", "debug", "warning", "error", "exception",
    # file-object protocol: `fh.flush()` must not resolve to whatever
    # log-shaped class also defines flush
    "flush", "fileno", "readline", "readlines", "writelines", "seek",
    "tell", "truncate",
}


def _is_ctor(value, names) -> bool:
    if not isinstance(value, ast.Call):
        return False
    fn = value.func
    name = fn.attr if isinstance(fn, ast.Attribute) else \
        fn.id if isinstance(fn, ast.Name) else None
    return name in names


def _class_lock_attrs(cls: ast.ClassDef) -> set:
    """Same inference as locks.py: ctor assignment or lockish
    ``with self.X:`` usage."""
    locks = set()
    for node in ast.walk(cls):
        if isinstance(node, ast.Assign):
            for t in node.targets:
                attr = _self_attr(t)
                if attr is not None and _is_ctor(node.value,
                                                 _LOCK_CTORS):
                    locks.add(attr)
        elif isinstance(node, ast.With):
            for item in node.items:
                attr = _self_attr(item.context_expr)
                if attr is not None and _LOCKISH_NAME.search(attr):
                    locks.add(attr)
    return locks


# ---------------------------------------------------------------------------
# lock-order-cycle
# ---------------------------------------------------------------------------

@dataclasses.dataclass
class _CallSite:
    method: str           # callee method name
    held: tuple           # lock attrs held at the call site, in order
    lineno: int
    receiver: str | None  # trailing receiver name for cross calls


class _OrderScanner:
    """One method body: direct nesting edges + call sites, tracking
    the ordered set of ``self.<lock>`` attrs held at each point."""

    def __init__(self, lock_attrs: set):
        self.lock_attrs = lock_attrs
        self.acquired: set[str] = set()
        self.edges: list[tuple[str, str, int]] = []   # (src, dst, line)
        self.intra: list[_CallSite] = []
        self.cross: list[_CallSite] = []

    def scan(self, node: ast.AST, held: tuple = ()) -> None:
        for child in ast.iter_child_nodes(node):
            self._scan_node(child, held)

    def _scan_node(self, node, held: tuple) -> None:
        if isinstance(node, ast.With):
            new_held = held
            for item in node.items:
                ctx = item.context_expr
                self._scan_node(ctx, held)
                attr = _self_attr(ctx)
                if attr is not None and attr in self.lock_attrs:
                    self.acquired.add(attr)
                    if attr not in new_held:      # reentrancy: no edge
                        for h in new_held:
                            self.edges.append((h, attr, ctx.lineno))
                        new_held = new_held + (attr,)
            for stmt in node.body:
                self._scan_node(stmt, new_held)
            return
        if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                             ast.ClassDef)):
            return            # nested scopes: their own analysis unit
        if isinstance(node, ast.Call):
            self._scan_call(node, held)
            return
        self.scan(node, held)

    def _scan_call(self, node: ast.Call, held: tuple) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute):
            direct = _self_attr(fn)       # self.m(...)
            base = _self_attr(fn.value)   # self.X.m(...): receiver X
            if direct is not None:
                self.intra.append(_CallSite(direct, held, fn.lineno,
                                            None))
            elif fn.attr not in _LOCK_OPS \
                    and not fn.attr.startswith("__"):
                if base is not None and base in self.lock_attrs:
                    pass                  # op on a lock object
                else:
                    chain = _dotted(fn.value)
                    recv = chain[-1] if chain else None
                    self.cross.append(_CallSite(fn.attr, held,
                                                fn.lineno, recv))
            self._scan_node(fn.value, held)
        else:
            self._scan_node(fn, held)
        for arg in node.args:
            self._scan_node(arg, held)
        for kw in node.keywords:
            self._scan_node(kw.value, held)


@dataclasses.dataclass
class _ClassInfo:
    module: object                    # ModuleInfo
    key: tuple                        # (path, class name)
    name: str
    lock_attrs: set
    scanners: dict                    # method name -> _OrderScanner


class LockOrderCycleRule(RepoRule):
    id = "lock-order-cycle"
    severity = "error"
    doc = ("cycle in the interprocedural lock-acquisition-order graph "
           "(nested `with self.lock:` + call-graph closure) — a "
           "potential deadlock")

    # -- extraction -------------------------------------------------------
    def _extract(self, modules) -> list:
        infos = []
        for mod in sorted(modules, key=lambda m: m.path):
            for node in ast.walk(mod.tree):
                if not isinstance(node, ast.ClassDef):
                    continue
                lock_attrs = _class_lock_attrs(node)
                if not lock_attrs:
                    continue
                scanners = {}
                for fn in node.body:
                    if isinstance(fn, (ast.FunctionDef,
                                       ast.AsyncFunctionDef)):
                        sc = _OrderScanner(lock_attrs)
                        sc.scan(fn)
                        scanners[fn.name] = sc
                infos.append(_ClassInfo(mod, (mod.path, node.name),
                                        node.name, lock_attrs,
                                        scanners))
        return infos

    # -- cross-object resolution ------------------------------------------
    def _resolve(self, site: _CallSite, owner: _ClassInfo,
                 infos: list):
        """The unique lock-owning class a cross-object call lands in,
        or None.  Unique method name wins outright; a receiver-name
        hint (``engine`` -> ``ServingEngine``) breaks ties; anything
        still ambiguous resolves to nothing (no edges beats wrong
        edges)."""
        if site.method in _GENERIC_METHODS:
            return None
        cands = [ci for ci in infos if site.method in ci.scanners]
        if len(cands) > 1 and site.receiver and len(site.receiver) >= 3:
            hint = site.receiver.lstrip("_").lower()
            hinted = [ci for ci in cands
                      if hint and hint in ci.name.lstrip("_").lower()]
            if hinted:
                cands = hinted
        if len(cands) == 1 and cands[0].key != owner.key:
            return cands[0]
        if len(cands) == 1:
            return cands[0]       # self-class via indirect receiver
        return None

    # -- graph ------------------------------------------------------------
    def check_repo(self, modules, root) -> list:
        infos = self._extract(modules)
        if not infos:
            return []
        by_key = {ci.key: ci for ci in infos}

        # acquisition closure per (class, method): every lock node the
        # call can end up acquiring, through intra-class helpers and
        # resolved cross-object calls.  Iterate to fixpoint.
        closure: dict[tuple, set] = {}
        targets: dict[tuple, list] = {}
        for ci in infos:
            for mname, sc in ci.scanners.items():
                node = (ci.key, mname)
                closure[node] = {(ci.key, a) for a in sc.acquired}
                tg = []
                for site in sc.intra:
                    if site.method in ci.scanners:
                        tg.append(((ci.key, site.method), site))
                for site in sc.cross:
                    tci = self._resolve(site, ci, infos)
                    if tci is not None:
                        tg.append(((tci.key, site.method), site))
                targets[node] = tg
        changed = True
        while changed:
            changed = False
            for node, tg in targets.items():
                cur = closure[node]
                before = len(cur)
                for tnode, _site in tg:
                    cur |= closure.get(tnode, set())
                if len(cur) != before:
                    changed = True

        # edge set: direct nesting edges, then call-closure edges
        # (held lock -> every lock the callee's closure can acquire).
        # First provenance wins, so direct edges keep their own line.
        edges: dict[tuple, tuple] = {}   # (src,dst) -> (module, line)

        def add_edge(src, dst, module, line):
            if src == dst:
                return
            edges.setdefault((src, dst), (module, line))

        for ci in infos:
            for mname, sc in ci.scanners.items():
                for (a, b, line) in sc.edges:
                    add_edge((ci.key, a), (ci.key, b), ci.module, line)
        for ci in infos:
            for mname, sc in ci.scanners.items():
                node = (ci.key, mname)
                for tnode, site in targets[node]:
                    if not site.held:
                        continue
                    held_nodes = {(ci.key, h) for h in site.held}
                    for dst in sorted(closure.get(tnode, set())):
                        if dst in held_nodes:
                            continue  # already held: reentrant, no edge
                        for h in site.held:
                            add_edge((ci.key, h), dst, ci.module,
                                     site.lineno)

        return self._report_cycles(edges)

    def _report_cycles(self, edges: dict) -> list:
        adj: dict = {}
        for (src, dst) in edges:
            adj.setdefault(src, []).append(dst)
            adj.setdefault(dst, [])
        for dsts in adj.values():
            dsts.sort()
        sccs = _tarjan(adj)
        findings = []
        for scc in sccs:
            if len(scc) < 2:
                continue
            scc_set = set(scc)
            cyc_edges = sorted(
                ((s, d) for (s, d) in edges
                 if s in scc_set and d in scc_set),
                key=lambda e: (edges[e][0].path, edges[e][1]))
            module, line = edges[cyc_edges[0]]

            def disp(n):
                return f"{n[0][1]}.{n[1]}"
            names = " / ".join(sorted({disp(n) for n in scc}))
            prov = "; ".join(
                f"{disp(s)}->{disp(d)} "
                f"({edges[(s, d)][0].path}:{edges[(s, d)][1]})"
                for (s, d) in cyc_edges[:6])
            findings.append(module.finding(
                self, types.SimpleNamespace(lineno=line),
                f"lock-order cycle (potential deadlock) among "
                f"{names}; edges: {prov}"))
        return findings


def _tarjan(adj: dict) -> list:
    """Strongly connected components, iterative (rule runs on
    arbitrarily deep graphs; no recursion limit surprises).  Returns
    SCCs sorted by their smallest node."""
    index: dict = {}
    low: dict = {}
    on_stack: set = set()
    stack: list = []
    sccs: list = []
    counter = [0]
    for root in sorted(adj):
        if root in index:
            continue
        work = [(root, iter(adj[root]))]
        index[root] = low[root] = counter[0]
        counter[0] += 1
        stack.append(root)
        on_stack.add(root)
        while work:
            node, it = work[-1]
            advanced = False
            for nxt in it:
                if nxt not in index:
                    index[nxt] = low[nxt] = counter[0]
                    counter[0] += 1
                    stack.append(nxt)
                    on_stack.add(nxt)
                    work.append((nxt, iter(adj[nxt])))
                    advanced = True
                    break
                if nxt in on_stack:
                    low[node] = min(low[node], index[nxt])
            if advanced:
                continue
            work.pop()
            if work:
                parent = work[-1][0]
                low[parent] = min(low[parent], low[node])
            if low[node] == index[node]:
                scc = []
                while True:
                    w = stack.pop()
                    on_stack.discard(w)
                    scc.append(w)
                    if w == node:
                        break
                sccs.append(sorted(scc))
    return sorted(sccs, key=lambda s: s[0])


# ---------------------------------------------------------------------------
# lock-leak
# ---------------------------------------------------------------------------

def _recv_key(node) -> tuple | None:
    """Receiver identity for acquire/release matching: the dotted
    chain minus the trailing method name."""
    chain = _dotted(node)
    return chain if chain else None


def _is_lockish_recv(chain: tuple) -> bool:
    return any(_LOCKISH_NAME.search(part) for part in chain)


class LockLeakRule(Rule):
    id = "lock-leak"
    severity = "error"
    doc = ("bare `.acquire()` whose release is not guaranteed by "
           "try/finally (or the checked non-blocking probe idiom) — "
           "leaks the lock on the first exception")

    def check(self, module) -> list:
        findings = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(module, node))
        return findings

    def _check_function(self, module, fn) -> list:
        # release receivers present anywhere in THIS function (not
        # nested defs — a closure releasing its own copy proves
        # nothing about this frame)
        releases: set = set()
        acquires: list = []   # (call node, recv chain, used flag)

        def walk_stmts(stmts, finally_keys: frozenset):
            for i, stmt in enumerate(stmts):
                nxt = stmts[i + 1] if i + 1 < len(stmts) else None
                walk_stmt(stmt, nxt, finally_keys)

        def release_keys(stmts) -> frozenset:
            keys = set()
            for stmt in stmts:
                for node in ast.walk(stmt):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "release"):
                        key = _recv_key(node.func.value)
                        if key:
                            keys.add(key)
            return frozenset(keys)

        def scan_expr(expr, used: bool, nxt, finally_keys):
            for node in ast.walk(expr):
                if (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "acquire"):
                    key = _recv_key(node.func.value)
                    if key is None or not (
                            _is_lockish_recv(key)
                            or self._self_lock(key)):
                        continue
                    verdict = self._acquire_verdict(node, key, used,
                                                    nxt, finally_keys)
                    if verdict != "ok":
                        acquires.append((node, key,
                                         verdict == "probe"))
                elif (isinstance(node, ast.Call)
                        and isinstance(node.func, ast.Attribute)
                        and node.func.attr == "release"):
                    key = _recv_key(node.func.value)
                    if key:
                        releases.add(key)

        def walk_stmt(stmt, nxt, finally_keys):
            if isinstance(stmt, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                return
            if isinstance(stmt, ast.Try):
                fin = finally_keys | release_keys(stmt.finalbody)
                walk_stmts(stmt.body, fin)
                for h in stmt.handlers:
                    walk_stmts(h.body, finally_keys)
                walk_stmts(stmt.orelse, finally_keys)
                walk_stmts(stmt.finalbody, finally_keys)
                # the finally's releases count as releases
                releases.update(release_keys(stmt.finalbody))
                return
            if isinstance(stmt, ast.Expr):
                # bare expression statement: the call result is unused
                scan_expr(stmt.value, False, nxt, finally_keys)
                return
            used = isinstance(stmt, (ast.If, ast.While, ast.Assign,
                                     ast.AnnAssign, ast.AugAssign,
                                     ast.Return, ast.Assert))
            # compound statements: walk their statement lists with
            # sibling info intact (acquire-then-try works inside an
            # `if:` body too); everything else is expression territory
            for field in ("body", "orelse"):
                sub = getattr(stmt, field, None)
                if sub and isinstance(sub, list) \
                        and sub and isinstance(sub[0], ast.stmt):
                    walk_stmts(sub, finally_keys)
            for child in ast.iter_child_nodes(stmt):
                if isinstance(child, ast.stmt):
                    continue          # handled via body/orelse above
                scan_expr(child, used, nxt, finally_keys)

        self._fn_class_locks = self._enclosing_locks(module, fn)
        walk_stmts(fn.body, frozenset())

        findings = []
        for node, key, checked_probe in acquires:
            # the checked probe's release may appear later in the
            # function than the acquire — resolve after the full walk
            if checked_probe and key in releases:
                continue
            findings.append(module.finding(
                self, node,
                f"'{'.'.join(key)}.acquire()' has no structurally "
                f"guaranteed release (use `with`, or acquire "
                f"immediately before try/finally release)"))
        return findings

    # -- helpers ----------------------------------------------------------
    def _enclosing_locks(self, module, fn) -> set:
        for node in ast.walk(module.tree):
            if isinstance(node, ast.ClassDef) and any(
                    f is fn for f in ast.walk(node)):
                return _class_lock_attrs(node)
        return set()

    def _self_lock(self, key: tuple) -> bool:
        return (len(key) == 2 and key[0] == "self"
                and key[1] in self._fn_class_locks)

    @staticmethod
    def _probe(call: ast.Call) -> bool:
        """Non-blocking / bounded acquire: ``blocking=False`` or a
        timeout argument — the checked-probe idiom."""
        for kw in call.keywords:
            if kw.arg == "blocking":
                v = kw.value
                if isinstance(v, ast.Constant) and v.value is False:
                    return True
            if kw.arg == "timeout":
                return True
        if call.args:
            a = call.args[0]
            if isinstance(a, ast.Constant) and a.value is False:
                return True
            if len(call.args) > 1:
                return True       # positional timeout
        return False

    def _acquire_verdict(self, call, key, used, nxt,
                         finally_keys) -> str:
        """"ok" (structurally released), "probe" (checked non-blocking
        probe — needs a release *somewhere* in the function, resolved
        after the full walk), or "bad"."""
        if key in finally_keys:
            return "ok"           # inside try, finally releases it
        if nxt is not None and isinstance(nxt, ast.Try):
            for stmt in nxt.finalbody:
                for node in ast.walk(stmt):
                    if (isinstance(node, ast.Call)
                            and isinstance(node.func, ast.Attribute)
                            and node.func.attr == "release"
                            and _recv_key(node.func.value) == key):
                        return "ok"
        if self._probe(call) and used:
            return "probe"
        return "bad"


# ---------------------------------------------------------------------------
# condition-wait-predicate
# ---------------------------------------------------------------------------

class ConditionWaitPredicateRule(Rule):
    id = "condition-wait-predicate"
    severity = "error"
    doc = ("`cond.wait()` not guarded by a `while` predicate loop — "
           "spurious wakeups and timeouts return with the predicate "
           "still false (use `while not pred: cond.wait()` or "
           "`wait_for`)")

    def check(self, module) -> list:
        # condition attrs per class (assigned threading.Condition())
        cond_attrs: set = set()
        for node in ast.walk(module.tree):
            if isinstance(node, ast.Assign) and _is_ctor(
                    node.value, {"Condition"}):
                for t in node.targets:
                    attr = _self_attr(t)
                    if attr is not None:
                        cond_attrs.add(attr)
                    elif isinstance(t, ast.Name):
                        cond_attrs.add(t.id)
        findings = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(
                    module, node, cond_attrs))
        return findings

    def _check_function(self, module, fn, cond_attrs) -> list:
        findings = []

        def walk(node, in_while: bool):
            for child in ast.iter_child_nodes(node):
                if isinstance(child, (ast.FunctionDef,
                                      ast.AsyncFunctionDef,
                                      ast.ClassDef)):
                    continue
                if isinstance(child, ast.While):
                    walk(child, True)
                    continue
                if (isinstance(child, ast.Call)
                        and isinstance(child.func, ast.Attribute)
                        and child.func.attr == "wait"):
                    recv = child.func.value
                    name = _self_attr(recv)
                    if name is None and isinstance(recv, ast.Name):
                        name = recv.id
                    is_cond = name is not None and (
                        name in cond_attrs
                        or _CONDISH_NAME.search(name))
                    if is_cond and not in_while:
                        findings.append(module.finding(
                            self, child,
                            f"'{name}.wait()' outside a `while` "
                            f"predicate loop"))
                walk(child, in_while)

        walk(fn, False)
        return findings
