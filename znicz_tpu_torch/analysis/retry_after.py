"""zlint rule: every backpressure refusal carries ``Retry-After``.

The contract the serving tier's tests pin by hand, test by test: a
429 (quota / queue full), 503 (draining, shed, breaker open, engine
unavailable, reconcile window) or 504 (deadline) is an *honest*
refusal — it tells the client when to come back.  A refusal without
``Retry-After`` turns well-behaved clients into tight retry loops at
exactly the moment the server is trying to shed load.

Scope: modules under ``<pkg>/serving/`` and ``<pkg>/fleet/`` of the
walked package ``<pkg>`` (the two HTTP tiers).  Checked call shapes,
per function:

* ``self._reply(CODE, body, headers)`` / ``self._send(CODE, body,
  ctype, headers)`` — the fast-handler single-write idiom.  ``CODE``
  must be a literal 429/503/504; the headers argument must be a dict
  literal with a ``"Retry-After"`` key, or a name that is assigned a
  ``Retry-After`` entry (dict literal or ``h["Retry-After"] = ...``
  subscript store) somewhere in the same function.  Variable status
  codes (the router's backend passthrough) are out of scope — the
  upstream tier already enforced the contract on the literal site.
* ``self.send_response(CODE)`` — requires a ``send_header(
  "Retry-After", ...)`` call in the same function.
* ``self.send_error(CODE, ...)`` — always a finding for these codes
  (``send_error`` cannot attach headers; use ``_reply``).
"""

from __future__ import annotations

import ast

from .core import Rule, scope_prefixes

_CODES = {429, 503, 504}
_SCOPE_DIRS = ("serving", "fleet")
_HEADER = "Retry-After"


def _literal_code(node) -> int | None:
    if isinstance(node, ast.Constant) and isinstance(node.value, int):
        return node.value
    return None


def _dict_has_header(node) -> bool:
    if not isinstance(node, ast.Dict):
        return False
    return any(isinstance(k, ast.Constant) and k.value == _HEADER
               for k in node.keys)


def _own_nodes(fn):
    """Walk ``fn`` without descending into nested function/class
    scopes — a handler method inside a factory closure is scanned
    exactly once (as itself), and the outer function's header
    assignments don't vouch for the inner one's refusals."""
    stack = [fn]
    while stack:
        node = stack.pop()
        yield node
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef,
                                  ast.AsyncFunctionDef, ast.ClassDef)):
                continue
            stack.append(child)


class RetryAfterRule(Rule):
    id = "retry-after-discipline"
    severity = "error"
    doc = ("429/503/504 refusal without a Retry-After header on the "
           "same path (serving/ + fleet/) — honest refusals tell the "
           "client when to come back")

    def check(self, module) -> list:
        if not module.path.startswith(scope_prefixes(module.package,
                                                     _SCOPE_DIRS)):
            return []
        findings = []
        for node in ast.walk(module.tree):
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)):
                findings.extend(self._check_function(module, node))
        return findings

    def _check_function(self, module, fn) -> list:
        # names that provably carry a Retry-After entry somewhere in
        # this function: `h = {"Retry-After": ...}` or
        # `h["Retry-After"] = ...` (the router's passthrough idiom)
        header_names: set = set()
        sends_header = False
        for node in _own_nodes(fn):
            if isinstance(node, ast.Assign):
                if _dict_has_header(node.value):
                    for t in node.targets:
                        if isinstance(t, ast.Name):
                            header_names.add(t.id)
                for t in node.targets:
                    if (isinstance(t, ast.Subscript)
                            and isinstance(t.value, ast.Name)
                            and isinstance(t.slice, ast.Constant)
                            and t.slice.value == _HEADER):
                        header_names.add(t.value.id)
            elif (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)
                    and node.func.attr == "send_header"
                    and node.args
                    and isinstance(node.args[0], ast.Constant)
                    and node.args[0].value == _HEADER):
                sends_header = True

        findings = []
        for node in _own_nodes(fn):
            if not (isinstance(node, ast.Call)
                    and isinstance(node.func, ast.Attribute)):
                continue
            name = node.func.attr
            if name in ("_reply", "_send"):
                code = _literal_code(node.args[0]) if node.args else None
                if code not in _CODES:
                    continue
                # headers arg: _reply(code, body, headers) /
                # _send(code, body, ctype, headers)
                pos = 2 if name == "_reply" else 3
                hdr = node.args[pos] if len(node.args) > pos else None
                for kw in node.keywords:
                    if kw.arg == "headers":
                        hdr = kw.value
                if hdr is None:
                    findings.append(module.finding(
                        self, node,
                        f"{name}({code}, ...) without a Retry-After "
                        f"header — backpressure refusals must carry "
                        f"an honest come-back time"))
                elif _dict_has_header(hdr):
                    pass
                elif (isinstance(hdr, ast.Name)
                        and hdr.id in header_names):
                    pass
                elif isinstance(hdr, (ast.Name, ast.Attribute,
                                      ast.Call)):
                    # a headers value built elsewhere that this
                    # function never adds Retry-After to
                    findings.append(module.finding(
                        self, node,
                        f"{name}({code}, ...): headers argument is "
                        f"never given a Retry-After entry in this "
                        f"function"))
                else:
                    findings.append(module.finding(
                        self, node,
                        f"{name}({code}, ...) headers lack "
                        f"Retry-After"))
            elif name == "send_response":
                code = _literal_code(node.args[0]) if node.args else None
                if code in _CODES and not sends_header:
                    findings.append(module.finding(
                        self, node,
                        f"send_response({code}) without a "
                        f"send_header('Retry-After', ...) in the "
                        f"same function"))
            elif name == "send_error":
                code = _literal_code(node.args[0]) if node.args else None
                if code in _CODES:
                    findings.append(module.finding(
                        self, node,
                        f"send_error({code}) cannot attach "
                        f"Retry-After — use _reply with an honest "
                        f"come-back time"))
        return findings
