"""zlint rules: CUDA-graph hygiene in captured steps + library RNG
seeding (the port's counterpart of ``znicz_tpu/analysis/jaxrules.py``).

Two bug classes the port's captured hot paths keep re-inviting:

* **Host work inside a CUDA-graph capture** (`graph-host-sync`,
  `graph-tensor-branch`): a captured step is recorded once and replayed
  with no Python at all.  A ``.item()`` / ``.cpu()`` / ``np.asarray`` /
  ``torch.cuda.synchronize()`` / ``float(x)`` inside it either fails
  the capture or — worse — runs once, at capture time, freezing the
  value it read into every replay; a Python ``if`` on a tensor takes
  one branch for the life of the graph.  The rule finds the captured
  callables — functions passed as the callable to ``capture(fn, ...)``
  / ``StepPlan.capture(fn)`` or to ``StepPlan.run(variant, fn)``
  (``functools.partial(step, ...)`` included), and the bodies of
  ``with torch.cuda.graph(...)`` — and flags host syncs and Python
  branches on tensor expressions inside them.  A tensor expression is
  a torch call, a reduction or comparison method, or a name assigned
  from one in the captured body or the function around it.
  Shape/dtype/ndim/device attribute tests, ``len()`` / ``isinstance()``
  and ``x is None`` checks are static and exempt.
* **Unseeded global RNG** (`unseeded-random`): library code drawing
  from ``np.random.*`` module-level state, stdlib ``random.*``, or
  torch's global generator (``torch.rand``/``randn``/... and the
  in-place ``Tensor.uniform_``/``normal_``/... without
  ``generator=``) breaks the repo-wide reproducibility contract
  (``prng.seed_all``; every test pins seeds).  Seeded constructions —
  ``np.random.default_rng(seed)``, ``random.Random(seed)``,
  ``torch.Generator().manual_seed(seed)`` passed as ``generator=`` —
  are the sanctioned idiom and pass.
"""

from __future__ import annotations

import ast
import dataclasses

from .core import Rule, dotted as _dotted

#: attribute calls that force a device→host sync
_SYNC_METHODS = {"item", "tolist", "cpu", "numpy"}

#: ``module.attr`` call paths that materialize host arrays or wait for
#: the device
_SYNC_CALLS = {("np", "asarray"), ("np", "array"), ("numpy", "asarray"),
               ("numpy", "array"), ("cuda", "synchronize")}

#: attributes of a tensor that are fixed when the graph is captured
_STATIC_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                 "requires_grad", "is_sparse"}

#: tensor methods whose result is host metadata, not a device value
_STATIC_METHODS = {"size", "dim", "numel", "nelement", "stride",
                   "is_contiguous", "data_ptr", "element_size",
                   "get_device", "storage_offset"}

#: calls whose result is static whatever they are given
_STATIC_CALLS = {"len", "isinstance", "hasattr", "callable", "type", "id"}

#: tensor methods that make a device value (the shapes a branch tests)
_TENSOR_METHODS = {"sum", "mean", "any", "all", "max", "min", "amax",
                   "amin", "argmax", "argmin", "norm", "prod", "std",
                   "var", "isnan", "isinf", "isfinite", "eq", "ne", "gt",
                   "lt", "ge", "le", "count_nonzero", "nonzero", "abs",
                   "index_select", "view", "reshape", "clone",
                   "contiguous", "float", "double", "half", "bfloat16"}

#: torch functions that return host values (devices, dtypes, streams,
#: flags), not tensors
_HOST_TORCH = {"device", "dtype", "Size", "is_tensor", "is_floating_point",
               "is_complex", "numel", "get_default_dtype", "finfo",
               "iinfo", "is_grad_enabled", "no_grad", "inference_mode",
               "enable_grad", "set_grad_enabled", "manual_seed",
               "initial_seed", "Generator", "CUDAGraph", "Stream", "Event",
               "graph", "graph_pool_handle", "stream", "current_stream"}

#: np.random members that construct seeded generators (allowed)
_SEEDED_NP = {"default_rng", "Generator", "PCG64", "PCG64DXSM",
              "Philox", "SFC64", "MT19937", "SeedSequence",
              "BitGenerator", "RandomState"}

#: stdlib random members that are not global-state draws (allowed)
_SEEDED_STDLIB = {"Random", "SystemRandom"}

#: torch functions that draw from the global generator unless given
#: ``generator=``
_TORCH_DRAWS = {"rand", "randn", "randint", "randperm", "bernoulli",
                "normal", "multinomial", "rand_like", "randn_like",
                "randint_like"}

#: in-place tensor draws (``x.uniform_()``; also ``nn.init.uniform_``)
_TORCH_INPLACE_DRAWS = {"uniform_", "normal_", "bernoulli_", "random_",
                        "exponential_"}


@dataclasses.dataclass
class Captured:
    """One captured callable: the function, lambda or ``with`` node whose
    body is recorded into a graph, the parameters it has, and the line
    of the call (or ``with``) that captures it."""

    node: ast.AST
    params: set
    site: int


def _params(fn) -> set:
    args = fn.args
    names = {a.arg for a in args.posonlyargs + args.args + args.kwonlyargs}
    if args.vararg:
        names.add(args.vararg.arg)
    if args.kwarg:
        names.add(args.kwarg.arg)
    names.discard("self")
    return names


def _is_graph_with(item: ast.withitem) -> bool:
    expr = item.context_expr
    if not isinstance(expr, ast.Call):
        return False
    path = _dotted(expr.func)
    return path is not None and path[-2:] == ("cuda", "graph")


def _captured_target(call: ast.Call):
    """The callable argument a call records into a graph, or None:
    ``capture(fn, ...)`` / ``X.capture(fn)`` take it first,
    ``plan.run(variant, fn)`` second."""
    path = _dotted(call.func)
    if path is None:
        return None
    if path[-1] == "capture" and call.args:
        return call.args[0]
    if (path[-1] == "run" and isinstance(call.func, ast.Attribute)
            and len(call.args) == 2 and not call.keywords):
        return call.args[1]
    return None


def find_captured(tree: ast.AST) -> list:
    """Every captured callable of a module, as :class:`Captured`.

    A name is resolved with Python's scoping rules — innermost enclosing
    function scope outward, skipping class scopes — as the reference's
    ``find_jitted_functions`` does; a ``functools.partial(step, ...)``
    resolves to ``step``.  A target that resolves to nothing defined in
    the module (a parameter, an attribute) is not followed: the call
    that captures it is the caller's business.  ``.run(a, b)`` counts
    only when ``b`` resolves to a function or lambda of the module."""
    found = []

    def resolve(target, scopes):
        if isinstance(target, ast.Lambda):
            return target
        if isinstance(target, ast.Call):
            path = _dotted(target.func)
            if path is not None and path[-1] == "partial" and target.args:
                return resolve(target.args[0], scopes)
            return None
        if isinstance(target, ast.Name):
            for is_fn, bindings in reversed(scopes):
                if is_fn and target.id in bindings:
                    return bindings[target.id]
        return None

    def visit(node, scopes):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.AsyncFunctionDef)):
                scopes[-1][1][child.name] = child
                visit(child, scopes + [(True, {})])
            elif isinstance(child, ast.Lambda):
                visit(child, scopes + [(True, {})])
            elif isinstance(child, ast.ClassDef):
                visit(child, scopes + [(False, {})])
            else:
                if isinstance(child, (ast.With, ast.AsyncWith)) \
                        and any(_is_graph_with(i) for i in child.items):
                    found.append(Captured(child, set(), child.lineno))
                elif isinstance(child, ast.Call):
                    target = _captured_target(child)
                    fn = (resolve(target, scopes)
                          if target is not None else None)
                    if fn is not None:
                        found.append(Captured(fn, _params(fn),
                                              child.lineno))
                visit(child, scopes)

    visit(tree, [(True, {})])
    out, seen = [], set()
    for c in found:
        if id(c.node) not in seen:
            seen.add(id(c.node))
            out.append(c)
    return out


def torch_aliases(tree: ast.AST) -> set:
    """Names the module binds to torch or one of its submodules
    (``torch``, ``F`` of ``import torch.nn.functional as F``, ...)."""
    names = set()
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                if a.name.split(".")[0] == "torch":
                    names.add(a.asname or a.name.split(".")[0])
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module and node.module.split(".")[0] == "torch":
            names.update(a.asname or a.name for a in node.names)
    return names


class _Tensors:
    """Which expressions of a captured body hold device values."""

    def __init__(self, aliases: set):
        self.aliases = aliases
        self.names: set = set()

    def find(self, expr) -> str | None:
        """The first sub-expression of ``expr`` that is a device value
        (unparsed), or None when ``expr`` is static."""
        if isinstance(expr, ast.Compare) and \
                all(isinstance(op, (ast.Is, ast.IsNot)) for op in expr.ops):
            return None
        if isinstance(expr, ast.Attribute) and expr.attr in _STATIC_ATTRS:
            return None
        if isinstance(expr, ast.Name):
            return expr.id if expr.id in self.names else None
        if isinstance(expr, ast.Call):
            fn = expr.func
            path = _dotted(fn)
            if path is not None and path[-1] in _STATIC_CALLS:
                return None
            if isinstance(fn, ast.Attribute):
                if fn.attr in _STATIC_METHODS:
                    return None
                if path is not None and path[0] in self.aliases:
                    if fn.attr not in _HOST_TORCH and "cuda" not in path:
                        return ast.unparse(expr)
                    return None
                if fn.attr in _TENSOR_METHODS \
                        or self.find(fn.value) is not None:
                    return ast.unparse(expr)
        for child in ast.iter_child_nodes(expr):
            if isinstance(child, (ast.expr_context, ast.Lambda)):
                continue
            hit = self.find(child)
            if hit is not None:
                return hit
        return None

    def collect(self, nodes) -> None:
        """Mark every name assigned a device value in ``nodes`` (to a
        fixpoint: ``y = x + 1`` after ``x = torch.zeros(...)``)."""
        assigns = []
        for top in nodes:
            for node in ast.walk(top):
                if isinstance(node, ast.Assign):
                    assigns.append((node.targets, node.value))
                elif isinstance(node, (ast.AnnAssign, ast.AugAssign)) \
                        and node.value is not None:
                    assigns.append(([node.target], node.value))
                elif isinstance(node, (ast.For, ast.AsyncFor)):
                    assigns.append(([node.target], node.iter))
                elif isinstance(node, ast.NamedExpr):
                    assigns.append(([node.target], node.value))
        changed = True
        while changed:
            changed = False
            for targets, value in assigns:
                if self.find(value) is None:
                    continue
                for t in targets:
                    for sub in ast.walk(t):
                        if isinstance(sub, ast.Name) \
                                and sub.id not in self.names:
                            self.names.add(sub.id)
                            changed = True


class _GraphVisitor(ast.NodeVisitor):
    def __init__(self, rule, module, params: set, tensors: _Tensors):
        self.rule = rule
        self.module = module
        self.params = params
        self.tensors = tensors
        self.findings: list = []

    # nested defs are recorded with the captured body when it calls
    # them, so they are scanned too — but their OWN parameters shadow
    # the outer names for the subtree (a local `def helper(x=3)` must
    # not inherit the captured fn's `x`)
    def _visit_nested(self, node) -> None:
        shadowed = _params(node)
        saved = self.params, self.tensors.names
        self.params = self.params - shadowed
        self.tensors.names = self.tensors.names - shadowed
        try:
            self.generic_visit(node)
        finally:
            self.params, self.tensors.names = saved

    visit_FunctionDef = _visit_nested
    visit_AsyncFunctionDef = _visit_nested
    visit_Lambda = _visit_nested

    def visit_Call(self, node: ast.Call) -> None:
        fn = node.func
        if isinstance(fn, ast.Attribute) and fn.attr in _SYNC_METHODS:
            self.findings.append(self.module.finding(
                self.rule, node,
                f"'.{fn.attr}()' inside a captured CUDA-graph step reads "
                f"the device at capture time (or fails the capture); "
                f"the replays never run it"))
        path = _dotted(fn)
        if path is not None and len(path) >= 2 \
                and (path[-2], path[-1]) in _SYNC_CALLS:
            self.findings.append(self.module.finding(
                self.rule, node,
                f"'{'.'.join(path)}(...)' inside a captured CUDA-graph "
                f"step waits for or copies from the device mid-capture"))
        if (isinstance(fn, ast.Name) and fn.id in ("float", "int",
                                                   "bool", "complex")
                and node.args):
            arg = node.args[0]
            what = (arg.id if isinstance(arg, ast.Name)
                    and arg.id in self.params
                    else self.tensors.find(arg))
            if what is not None:
                self.findings.append(self.module.finding(
                    self.rule, node,
                    f"'{fn.id}({ast.unparse(arg)})' inside a captured "
                    f"CUDA-graph step freezes the value read at capture "
                    f"into every replay; keep it a device tensor"))
        self.generic_visit(node)

    def visit_If(self, node: ast.If) -> None:
        self._check_branch(node, node.test, "if")
        self.generic_visit(node)

    def visit_While(self, node: ast.While) -> None:
        self._check_branch(node, node.test, "while")
        self.generic_visit(node)

    def _check_branch(self, node, test, kind: str) -> None:
        what = self.tensors.find(test)
        if what is not None:
            self.findings.append(self.module.finding(
                self.rule, node,
                f"Python '{kind}' on tensor expression '{what}' inside a "
                f"captured CUDA-graph step: the capture takes one branch "
                f"for every replay (use torch.where, or decide on the "
                f"host before the capture)"))


def _enclosing_functions(tree: ast.AST) -> dict:
    """id(node) → the innermost function around it (None at top level)."""
    out: dict = {}

    def visit(node, fn):
        for child in ast.iter_child_nodes(node):
            out[id(child)] = fn
            visit(child, child if isinstance(
                child, (ast.FunctionDef, ast.AsyncFunctionDef)) else fn)

    visit(tree, None)
    return out


class GraphHygieneRule(Rule):
    id = "graph-host-sync"
    severity = "error"
    doc = ("host-sync call or Python branch on a tensor inside a captured "
           "CUDA-graph step")

    #: branches get their own id so they can be suppressed separately
    BRANCH_ID = "graph-tensor-branch"

    def check(self, module) -> list:
        aliases = torch_aliases(module.tree)
        around = _enclosing_functions(module.tree)
        findings = []
        for cap in find_captured(module.tree):
            tensors = _Tensors(aliases)
            tensors.collect([around.get(id(cap.node)) or cap.node])
            # a captured function's own parameters are host values it
            # was bound with, never device values to branch on
            tensors.names -= cap.params
            visitor = _GraphVisitor(self, module, cap.params, tensors)
            body = (cap.node.body if isinstance(cap.node.body, list)
                    else [cap.node.body])
            for stmt in body:
                visitor.visit(stmt)
            findings.extend(visitor.findings)
        out = []
        for f in findings:
            if "Python '" in f.message:
                f = dataclasses.replace(f, rule=self.BRANCH_ID)
            out.append(f)
        return out


class UnseededRandomRule(Rule):
    id = "unseeded-random"
    severity = "error"
    doc = ("draw from the process-global RNG (np.random.* / random.* / "
           "torch's global generator) in library code; use a seeded "
           "Generator (prng module)")

    def check(self, module) -> list:
        findings = []
        for node in ast.walk(module.tree):
            if not isinstance(node, ast.Call):
                continue
            path = _dotted(node.func)
            seedless = not node.args and not node.keywords
            unseeded_torch = not any(kw.arg == "generator"
                                     for kw in node.keywords)
            if (isinstance(node.func, ast.Attribute)
                    and node.func.attr in _TORCH_INPLACE_DRAWS
                    and unseeded_torch):
                findings.append(module.finding(
                    self, node,
                    f"'.{node.func.attr}(...)' without generator= draws "
                    f"from torch's global generator; pass a seeded "
                    f"torch.Generator"))
                continue
            if path is None:
                continue
            if len(path) == 2 and path[0] == "torch" \
                    and path[1] in _TORCH_DRAWS and unseeded_torch:
                findings.append(module.finding(
                    self, node,
                    f"'torch.{path[1]}(...)' without generator= draws "
                    f"from torch's global generator; pass a seeded "
                    f"torch.Generator"))
            elif len(path) >= 2 and path[-2] == "random" \
                    and (len(path) >= 3 and path[-3] in ("np", "numpy")
                         or path[0] == "np" or path[0] == "numpy"):
                member = path[-1]
                if member not in _SEEDED_NP:
                    findings.append(module.finding(
                        self, node,
                        f"'{'.'.join(path)}(...)' draws from numpy's "
                        f"global RNG; use np.random.default_rng(seed) "
                        f"or znicz_tpu_torch.prng"))
                elif member != "Generator" and seedless:
                    # default_rng()/PCG64()/... with NO seed pulls OS
                    # entropy — just as irreproducible as the global
                    # RNG (Generator itself always takes a bitgen arg)
                    findings.append(module.finding(
                        self, node,
                        f"'{'.'.join(path)}()' without a seed draws "
                        f"OS entropy; pass an explicit seed"))
            elif len(path) == 2 and path[0] == "random":
                if path[1] not in _SEEDED_STDLIB:
                    findings.append(module.finding(
                        self, node,
                        f"'random.{path[1]}(...)' draws from the "
                        f"stdlib global RNG; use random.Random(seed)"))
                elif path[1] == "Random" and seedless:
                    # SystemRandom is exempt: it CANNOT be seeded and
                    # exists for entropy, not reproducibility
                    findings.append(module.finding(
                        self, node,
                        "'random.Random()' without a seed is "
                        "irreproducible; pass an explicit seed"))
        return findings
