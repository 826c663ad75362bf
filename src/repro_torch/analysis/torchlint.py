"""torchlint: AST lint for the port's RNG and host-sync discipline
(rules T001-T003), the counterpart of the JAX package's jaxlint.

Pure AST, no imports of the linted code. The rules are heuristics tuned
to this repo's idioms:

T001  RNG discipline (jaxlint's J001 splits keys; torch has no keys).
      Every entry point of the port draws from an explicit
      torch.Generator (ROADMAP ground rules), so in package code a draw
      must pass `generator=`: torch.rand / randn / randint / randperm /
      normal / bernoulli / multinomial, the in-place Tensor.normal_ /
      uniform_ / random_ / exponential_ / bernoulli_ / cauchy_ /
      geometric_ / log_normal_, and the drawing torch.nn.init functions.
      Seeding the global generator (torch.manual_seed,
      torch.random.manual_seed, torch.cuda.manual_seed[_all]) fires too.

T002  Host sync in a hot scope (jaxlint's J002). `.item()`, `.tolist()`,
      `.cpu()`, `.numpy()`, `np.asarray` / `np.array` of a tensor and
      `float()` / `int()` / `bool()` of a tensor wait for the card.

T003  Branch on a tensor in a hot scope (jaxlint's J003). An `if`,
      `while`, `assert` or conditional expression whose test is a tensor
      calls bool() on it: an implicit host sync.

Hot scopes. JAX marks its traced code by jax.jit and pallas_call; eager
torch has neither, so a function is hot when its definition says so: a
`# hot-path` comment on its `def` line or on any line of its signature, a
machine-checked comment contract in the manner of `# guarded-by:`. The
port marks its counterpart of every function the JAX package jits
(tests/test_torch_analysis.py keeps the map). A nested function is a
scope of its own, hot only if marked.

Tensor-typedness is jaxlint's forward pass, applied to tensors:
parameters annotated as a Tensor are tensors; an assignment whose value
is a tensor binds a tensor (rebinding to a host value clears it); a
torch.* call (outside the host namespaces torch.cuda, torch.backends,
torch.distributed, ... and constructors such as torch.device) returns a
tensor, as do methods and arithmetic on tensors, and calls of the file's
own functions whose return annotation names a Tensor or whose returns
are tensors (nested functions see the tensors of their enclosing scope).
`.shape`, `.ndim`, `.dtype`, `.device`, `.numel()`, `.dim()`, `.size()`,
`len()`, `isinstance` and `x is None` are concrete. Calls of functions
the file does not define and that are not torch's are taken as host
values (eager helpers such as plain_path return Python bools), the one
place where the heuristic departs from jaxlint's. Every miss is
baseline-able.
"""
from __future__ import annotations

import ast
import builtins
import re
from typing import Dict, List, Optional, Set

from repro_torch.analysis.findings import Finding

_HOT = re.compile(r"#\s*hot-path\b")

_DRAWS = {"rand", "randn", "randint", "randperm", "normal", "bernoulli",
          "multinomial"}
_INPLACE_DRAWS = {"normal_", "uniform_", "random_", "exponential_",
                  "bernoulli_", "cauchy_", "geometric_", "log_normal_"}
_INIT_DRAWS = {"uniform_", "normal_", "trunc_normal_", "xavier_uniform_",
               "xavier_normal_", "kaiming_uniform_", "kaiming_normal_",
               "orthogonal_", "sparse_"}
_SEEDS = {"torch.manual_seed", "torch.random.manual_seed",
          "torch.cuda.manual_seed", "torch.cuda.manual_seed_all"}

# Attributes and methods of a tensor that are host values.
_CONCRETE_ATTRS = {"shape", "ndim", "dtype", "device", "is_cuda", "layout",
                   "requires_grad", "itemsize", "is_leaf"}
_CONCRETE_METHODS = {"numel", "dim", "size", "stride", "is_contiguous",
                     "data_ptr", "element_size", "get_device", "nelement",
                     "ndimension", "is_floating_point", "is_complex",
                     "storage_offset", "item", "tolist"}
_SYNC_METHODS = ("item", "tolist", "cpu", "numpy")
# Builtins whose result is a host value whatever they are given.
_CONCRETE_BUILTINS = {"len", "isinstance", "issubclass", "int", "float",
                      "bool", "str", "repr", "hash", "id", "type",
                      "callable", "hasattr", "range", "print", "format"}
_SYNC_BUILTINS = ("float", "int", "bool")
# torch.* calls that return host values, by prefix and by name.
_HOST_TORCH_PREFIXES = ("torch.cuda.", "torch.backends.",
                        "torch.distributed.", "torch.autograd.",
                        "torch.profiler.", "torch.utils.", "torch.testing.",
                        "torch.jit.", "torch.compiler.", "torch.nn.")
_HOST_TORCH = {"torch.device", "torch.Size", "torch.Generator",
               "torch.dtype", "torch.finfo", "torch.iinfo", "torch.is_tensor",
               "torch.is_floating_point", "torch.is_complex", "torch.numel",
               "torch.get_default_dtype", "torch.set_default_dtype",
               "torch.no_grad", "torch.inference_mode", "torch.enable_grad",
               "torch.set_grad_enabled", "torch.is_grad_enabled",
               "torch.manual_seed", "torch.seed", "torch.initial_seed",
               "torch.get_num_threads", "torch.set_num_threads",
               "torch.use_deterministic_algorithms",
               "torch.set_printoptions"}


class _ImportMap:
    """Resolve names/attribute chains to dotted module paths."""

    def __init__(self, tree: ast.Module):
        self.alias: Dict[str, str] = {}
        for node in ast.walk(tree):
            if isinstance(node, ast.Import):
                for a in node.names:
                    self.alias[a.asname or a.name.split(".")[0]] = \
                        a.name if a.asname else a.name.split(".")[0]
            elif isinstance(node, ast.ImportFrom) and node.module \
                    and node.level == 0:
                for a in node.names:
                    self.alias[a.asname or a.name] = \
                        f"{node.module}.{a.name}"

    def resolve(self, node: ast.AST) -> Optional[str]:
        """Dotted path of a Name/Attribute chain, e.g. 'torch.randn'."""
        parts: List[str] = []
        while isinstance(node, ast.Attribute):
            parts.append(node.attr)
            node = node.value
        if not isinstance(node, ast.Name):
            return None
        root = self.alias.get(node.id, node.id)
        return ".".join([root] + list(reversed(parts)))


def _names_tensor(annotation: Optional[ast.expr]) -> bool:
    return annotation is not None and "Tensor" in ast.unparse(annotation)


def _torch_tensor_call(dotted: Optional[str]) -> bool:
    """True when a call of `dotted` returns a tensor."""
    if not dotted or not dotted.startswith("torch."):
        return False
    if dotted.startswith("torch.nn.functional."):
        return True
    return not (dotted in _HOST_TORCH
                or dotted.startswith(_HOST_TORCH_PREFIXES))


def _signature_lines(fn: ast.FunctionDef) -> range:
    return range(fn.lineno, max(fn.lineno + 1, fn.body[0].lineno))


class _Scope:
    """One function's forward pass: which local names hold tensors, what
    it returns, and (when hot and emitting) its T002 / T003 findings."""

    def __init__(self, linter: "_Linter", fn: ast.FunctionDef, symbol: str,
                 outer: Set[str], funcs: Dict[str, bool], emit: bool):
        self.linter = linter
        self.fn = fn
        self.symbol = symbol
        self.emit = emit
        self.hot = emit and linter.is_hot(fn)
        args = fn.args
        params = args.posonlyargs + args.args + args.kwonlyargs
        if args.vararg:
            params.append(args.vararg)
        if args.kwarg:
            params.append(args.kwarg)
        self.tensors = set(outer) - {a.arg for a in params}
        self.tensors |= {a.arg for a in params if _names_tensor(a.annotation)}
        self.funcs = dict(funcs)
        self.returns_tensor = _names_tensor(fn.returns)

    # -- the pass ---------------------------------------------------------

    def run(self) -> "_Scope":
        self._block(self.fn.body)
        return self

    def _block(self, stmts: List[ast.stmt]) -> None:
        for st in stmts:
            self._stmt(st)

    def _stmt(self, st: ast.stmt) -> None:
        if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
            child = _Scope(self.linter, st, f"{self.symbol}.{st.name}",
                           self.tensors, self.funcs, self.emit).run()
            self.funcs[st.name] = child.returns_tensor
            return
        if isinstance(st, ast.ClassDef):
            return
        if isinstance(st, ast.If):
            self._check(st.test)
            self._branch_test(st, st.test, "an `if`")
            self._block(st.body)
            self._block(st.orelse)
        elif isinstance(st, ast.While):
            self._check(st.test)
            self._branch_test(st, st.test, "a `while`")
            self._block(st.body)
            self._block(st.orelse)
        elif isinstance(st, (ast.For, ast.AsyncFor)):
            self._check(st.iter)
            self._bind([st.target], self.is_tensor(st.iter))
            self._block(st.body)
            self._block(st.orelse)
        elif isinstance(st, (ast.With, ast.AsyncWith)):
            for item in st.items:
                self._check(item.context_expr)
                if item.optional_vars is not None:
                    self._bind([item.optional_vars],
                               self.is_tensor(item.context_expr))
            self._block(st.body)
        elif isinstance(st, ast.Try):
            self._block(st.body)
            for h in st.handlers:
                self._block(h.body)
            self._block(st.orelse)
            self._block(st.finalbody)
        elif isinstance(st, ast.Assert):
            self._check(st)
            self._branch_test(st, st.test, "an `assert`")
        else:
            self._check(st)
            if isinstance(st, ast.Assign):
                self._assign(st.targets, st.value)
            elif isinstance(st, ast.AnnAssign) and st.value is not None:
                self._bind([st.target], _names_tensor(st.annotation)
                           or self.is_tensor(st.value))
            elif isinstance(st, ast.AugAssign):
                if self.is_tensor(st.value):
                    self._bind([st.target], True)
            elif isinstance(st, ast.Return) and st.value is not None:
                if self.is_tensor(st.value):
                    self.returns_tensor = True

    def _assign(self, targets: List[ast.expr], value: ast.expr) -> None:
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)) and \
                    isinstance(value, (ast.Tuple, ast.List)) and \
                    len(t.elts) == len(value.elts):
                for te, ve in zip(t.elts, value.elts):
                    self._assign([te], ve)
            else:
                self._bind([t], self.is_tensor(value))

    def _bind(self, targets: List[ast.expr], tensor: bool) -> None:
        for t in targets:
            if isinstance(t, (ast.Tuple, ast.List)):
                self._bind(list(t.elts), tensor)
            elif isinstance(t, ast.Starred):
                self._bind([t.value], tensor)
            elif isinstance(t, ast.Name):
                if tensor:
                    self.tensors.add(t.id)
                else:
                    self.tensors.discard(t.id)

    # -- tensor-typedness -------------------------------------------------

    def is_tensor(self, node: Optional[ast.expr]) -> bool:
        """True when evaluating `node` could yield a tensor."""
        if node is None:
            return False
        if isinstance(node, ast.Name):
            return node.id in self.tensors
        if isinstance(node, ast.Attribute):
            if node.attr in _CONCRETE_ATTRS:
                return False
            return self.is_tensor(node.value)
        if isinstance(node, ast.Call):
            return self._call_is_tensor(node)
        if isinstance(node, ast.Compare):
            if all(isinstance(op, (ast.Is, ast.IsNot, ast.In, ast.NotIn))
                   for op in node.ops):
                return False
            return self.is_tensor(node.left) or \
                any(self.is_tensor(c) for c in node.comparators)
        if isinstance(node, ast.Subscript):
            return self.is_tensor(node.value)
        if isinstance(node, ast.BinOp):
            return self.is_tensor(node.left) or self.is_tensor(node.right)
        if isinstance(node, ast.UnaryOp):
            return self.is_tensor(node.operand)
        if isinstance(node, ast.BoolOp):
            return any(self.is_tensor(v) for v in node.values)
        if isinstance(node, ast.IfExp):
            return any(self.is_tensor(v)
                       for v in (node.test, node.body, node.orelse))
        if isinstance(node, (ast.Tuple, ast.List)):
            return any(self.is_tensor(e) for e in node.elts)
        if isinstance(node, (ast.Starred, ast.NamedExpr)):
            return self.is_tensor(node.value)
        return False                              # constants, lambdas, ...

    def _call_is_tensor(self, node: ast.Call) -> bool:
        func = node.func
        args = list(node.args) + [k.value for k in node.keywords]
        if isinstance(func, ast.Name):
            if func.id in _CONCRETE_BUILTINS:
                return False
            if func.id in self.funcs:
                return self.funcs[func.id]
            module_fn = self.linter.module_returns(func.id)
            if module_fn is not None:
                return module_fn
            if func.id in self.linter.imports.alias:
                return _torch_tensor_call(self.linter.imports.resolve(func))
            if hasattr(builtins, func.id):
                return any(self.is_tensor(a) for a in args)
            return False
        if isinstance(func, ast.Attribute):
            if self.is_tensor(func.value):
                return func.attr not in _CONCRETE_METHODS
            return _torch_tensor_call(self.linter.imports.resolve(func))
        return False

    # -- the checks -------------------------------------------------------

    def _check(self, node: ast.AST) -> None:
        """T002 / T003 inside one statement or expression of a hot scope
        (nested functions and lambdas are scopes of their own)."""
        if not self.hot:
            return
        stack = [node]
        while stack:
            sub = stack.pop()
            if isinstance(sub, (ast.FunctionDef, ast.AsyncFunctionDef,
                                ast.Lambda, ast.ClassDef)):
                continue
            if isinstance(sub, ast.Call):
                self._host_sync(sub)
            elif isinstance(sub, ast.IfExp):
                self._branch_test(sub, sub.test, "a conditional expression")
            stack.extend(ast.iter_child_nodes(sub))

    def _host_sync(self, node: ast.Call) -> None:
        func = node.func
        if isinstance(func, ast.Attribute) and func.attr in _SYNC_METHODS \
                and not node.args and not node.keywords:
            self.linter.emit("T002", node, self.symbol,
                             f".{func.attr}() inside a hot scope waits for "
                             f"the card (move it off the hot path)")
            return
        dotted = self.linter.imports.resolve(func)
        if dotted in ("numpy.asarray", "numpy.array") and node.args and \
                self.is_tensor(node.args[0]):
            self.linter.emit("T002", node, self.symbol,
                             f"{dotted}() of a tensor inside a hot scope "
                             f"copies it to the host")
            return
        if isinstance(func, ast.Name) and func.id in _SYNC_BUILTINS and \
                node.args and any(self.is_tensor(a) for a in node.args):
            self.linter.emit("T002", node, self.symbol,
                             f"{func.id}() of a tensor inside a hot scope "
                             f"(a host sync)")

    def _branch_test(self, node: ast.AST, test: ast.expr, what: str) -> None:
        if self.hot and self.is_tensor(test):
            self.linter.emit("T003", node, self.symbol,
                             f"{what} on a tensor inside a hot scope calls "
                             f"bool() on it (an implicit host sync; keep the "
                             f"decision on the card, e.g. torch.where)")


class _Linter:
    def __init__(self, tree: ast.Module, source: str, path: str):
        self.tree = tree
        self.path = path
        self.lines = source.splitlines()
        self.imports = _ImportMap(tree)
        self.findings: List[Finding] = []
        self._module_fns = {st.name: st for st in tree.body
                            if isinstance(st, (ast.FunctionDef,
                                               ast.AsyncFunctionDef))}
        self._returns: Dict[str, Optional[bool]] = {}

    def emit(self, rule: str, node: ast.AST, symbol: str,
             message: str) -> None:
        self.findings.append(Finding(
            rule=rule, path=self.path, line=getattr(node, "lineno", 0),
            symbol=symbol, message=message))

    def is_hot(self, fn: ast.FunctionDef) -> bool:
        return any(_HOT.search(self.lines[i - 1])
                   for i in _signature_lines(fn) if i - 1 < len(self.lines))

    def module_returns(self, name: str) -> Optional[bool]:
        """Whether the module-level function `name` returns a tensor; None
        when the file defines no such function."""
        fn = self._module_fns.get(name)
        if fn is None:
            return None
        if name not in self._returns:
            self._returns[name] = False         # recursion guard
            self._returns[name] = _Scope(self, fn, name, set(), {},
                                         emit=False).run().returns_tensor
        return self._returns[name]

    # -- T002 / T003 over every function ----------------------------------

    def scopes(self) -> None:
        def visit(body: List[ast.stmt], prefix: str) -> None:
            for st in body:
                if isinstance(st, (ast.FunctionDef, ast.AsyncFunctionDef)):
                    _Scope(self, st, prefix + st.name, set(), {},
                           emit=True).run()
                elif isinstance(st, ast.ClassDef):
                    visit(st.body, f"{prefix}{st.name}.")
        visit(self.tree.body, "")

    # -- T001 everywhere --------------------------------------------------

    def rng(self) -> None:
        def visit(node: ast.AST, symbol: List[str]) -> None:
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef,
                                 ast.ClassDef)):
                symbol = symbol + [node.name]
            if isinstance(node, ast.Call):
                self._draw(node, ".".join(symbol))
            for child in ast.iter_child_nodes(node):
                visit(child, symbol)
        visit(self.tree, [])

    def _draw(self, node: ast.Call, symbol: str) -> None:
        dotted = self.imports.resolve(node.func)
        if dotted in _SEEDS:
            self.emit("T001", node, symbol,
                      f"{dotted}() seeds the global generator; package code "
                      f"draws from an explicit torch.Generator")
            return
        if any(kw.arg is None for kw in node.keywords):
            return                              # **kwargs may carry one
        gen = next((kw.value for kw in node.keywords
                    if kw.arg == "generator"), None)
        if gen is not None and not (isinstance(gen, ast.Constant)
                                    and gen.value is None):
            return
        what = None
        if dotted and dotted.startswith("torch.nn.init."):
            if dotted.rsplit(".", 1)[1] in _INIT_DRAWS:
                what = dotted
        elif dotted in {f"torch.{d}" for d in _DRAWS}:
            what = dotted
        elif isinstance(node.func, ast.Attribute) and \
                node.func.attr in _INPLACE_DRAWS:
            what = f"Tensor.{node.func.attr}"
        if what:
            self.emit("T001", node, symbol,
                      f"{what}() draws from the global generator; pass "
                      f"generator= (the entry point's explicit draws)")


def lint_source(source: str, path: str) -> List[Finding]:
    """Run torchlint over one file's source; `path` only labels findings."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError as exc:
        return [Finding(rule="X001", path=path, line=exc.lineno or 0,
                        symbol="", message=f"file does not parse: {exc}")]
    linter = _Linter(tree, source, path)
    linter.rng()
    linter.scopes()
    return linter.findings


def lint_file(filename: str, repo_rel: str) -> List[Finding]:
    with open(filename, "r", encoding="utf-8") as fh:
        return lint_source(fh.read(), repo_rel)
