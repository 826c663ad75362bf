"""Lock-discipline pass for the serve and fleet tiers (rules L001-L003).

A copy of repro.analysis.locks (the port imports nothing of the JAX
package): the same pure-AST checker, the same comment contracts.

Two comment contracts drive this checker, both machine-read from the
source so the documentation and the enforcement can never drift apart:

guarded-by   on the line initialising an instance field::

                 self._queue: List[_Pending] = []   # guarded-by: _lock

             Every MUTATION of `self._queue` — assignment (tuple targets
             included), augmented assignment, `del`, subscript stores,
             and calls of mutating methods (append/pop/clear/...) — must
             sit lexically inside `with self._lock:` in the same class.
             Reads are deliberately unchecked: the serve tier's
             single-writer read paths (stats snapshots, `names()`) are
             part of its design. `__init__` is exempt — construction
             precedes sharing.

lock-order   a module-level comment::

                 # lock-order: _flush_lock -> _lock

             declaring the only permitted nesting order for the named
             pair. Any `with self.B:` lexically nested inside
             `with self.A:` where the contract says B must come first is
             an inversion (L002) — the classic ABBA deadlock shape.

L003 flags contract rot itself: a guarded-by/lock-order annotation
naming a lock attribute the class never assigns.
"""
from __future__ import annotations

import ast
import re
from typing import Dict, List, Optional, Set, Tuple

from repro_torch.analysis.findings import Finding

_GUARDED_BY = re.compile(r"#\s*guarded-by:\s*([A-Za-z_]\w*)")
_LOCK_ORDER = re.compile(r"#\s*lock-order:\s*([A-Za-z_]\w*)\s*->\s*"
                         r"([A-Za-z_]\w*)")

# Method names that mutate their receiver in place.
_MUTATORS = {"append", "extend", "insert", "remove", "pop", "popitem",
             "clear", "update", "setdefault", "add", "discard",
             "appendleft", "popleft", "sort", "reverse"}


def _self_attr(node: ast.AST) -> Optional[str]:
    """'x' for `self.x`, else None."""
    if isinstance(node, ast.Attribute) and \
            isinstance(node.value, ast.Name) and node.value.id == "self":
        return node.attr
    return None


def _with_locks(item: ast.withitem) -> Optional[str]:
    """Lock attr name for `with self.<lock>:` items."""
    return _self_attr(item.context_expr)


class _ClassPass:
    """Check one class body against its guarded-by / lock-order contracts."""

    def __init__(self, cls: ast.ClassDef, path: str, lines: List[str],
                 order: List[Tuple[str, int]], findings: List[Finding]):
        self.cls = cls
        self.path = path
        self.lines = lines
        self.findings = findings
        self.guards: Dict[str, Tuple[str, int]] = {}   # field -> (lock, line)
        self.lock_fields: Set[str] = set()
        self.order = order        # [(lock, rank)] from the module contract
        self._collect()

    def _emit(self, rule: str, line: int, symbol: str, msg: str) -> None:
        self.findings.append(Finding(rule=rule, path=self.path, line=line,
                                     symbol=symbol, message=msg))

    def _collect(self) -> None:
        """Find guarded-by annotations + lock fields across the class."""
        for node in ast.walk(self.cls):
            targets: List[ast.expr] = []
            if isinstance(node, ast.Assign):
                targets = node.targets
            elif isinstance(node, ast.AnnAssign):
                targets = [node.target]
            else:
                continue
            for t in targets:
                attr = _self_attr(t)
                if attr is None:
                    continue
                if isinstance(node.value, ast.Call):
                    dotted = ast.unparse(node.value.func)
                    if dotted.endswith(("Lock", "RLock", "Condition",
                                        "Semaphore")):
                        self.lock_fields.add(attr)
                src_line = self.lines[node.lineno - 1] \
                    if node.lineno - 1 < len(self.lines) else ""
                m = _GUARDED_BY.search(src_line)
                if m:
                    self.guards[attr] = (m.group(1), node.lineno)

    def run(self) -> None:
        cls_name = self.cls.name
        for lock, line in self.guards.values():
            if lock not in self.lock_fields:
                self._emit("L003", line, cls_name,
                           f"guarded-by names {lock!r} but {cls_name} "
                           f"never assigns self.{lock} to a lock")
        for m in self.cls.body:
            if isinstance(m, (ast.FunctionDef, ast.AsyncFunctionDef)):
                self._check_method(m, cls_name)

    # -- per-method walk --------------------------------------------------

    def _check_method(self, fn: ast.FunctionDef, cls_name: str) -> None:
        symbol = f"{cls_name}.{fn.name}"
        exempt = fn.name == "__init__"
        ranks = dict(self.order)

        def held_ok(lock: str, held: Tuple[str, ...]) -> bool:
            return lock in held

        def visit(node: ast.AST, held: Tuple[str, ...]) -> None:
            if isinstance(node, ast.With):
                acquired = [a for a in map(_with_locks, node.items)
                            if a is not None and a in self.lock_fields]
                for a in acquired:
                    for h in held:
                        if a in ranks and h in ranks \
                                and ranks[a] < ranks[h]:
                            self._emit(
                                "L002", node.lineno, symbol,
                                f"acquires self.{a} while holding "
                                f"self.{h}; the lock-order contract "
                                f"requires {self._order_str()}")
                new_held = held + tuple(acquired)
                for item in node.items:
                    visit(item.context_expr, held)
                for st in node.body:
                    visit(st, new_held)
                return
            if isinstance(node, (ast.FunctionDef, ast.AsyncFunctionDef)) \
                    and node is not fn:
                return                        # nested defs escape the region
            mutated = self._mutation_target(node)
            if mutated is not None and not exempt:
                field, verb = mutated
                lock = self.guards.get(field, (None, 0))[0]
                if lock is not None and not held_ok(lock, held):
                    self._emit(
                        "L001", node.lineno, symbol,
                        f"self.{field} is guarded-by {lock} but {verb} "
                        f"outside `with self.{lock}`")
            for child in ast.iter_child_nodes(node):
                visit(child, held)

        for st in fn.body:
            visit(st, ())

    def _mutation_target(self, node: ast.AST
                         ) -> Optional[Tuple[str, str]]:
        """(field, verb) when `node` mutates an annotated self.<field>."""
        if isinstance(node, ast.Assign):
            for t in node.targets:
                f = self._store_target(t)
                if f is not None:
                    return f, "assigned"
        elif isinstance(node, ast.AugAssign):
            f = self._store_target(node.target)
            if f is not None:
                return f, "aug-assigned"
        elif isinstance(node, ast.Delete):
            for t in node.targets:
                f = self._store_target(t)
                if f is not None:
                    return f, "deleted"
        elif isinstance(node, ast.Call) and \
                isinstance(node.func, ast.Attribute) and \
                node.func.attr in _MUTATORS:
            f = _self_attr(node.func.value)
            if f is not None and f in self.guards:
                return f, f".{node.func.attr}()-mutated"
        return None

    def _store_target(self, t: ast.expr) -> Optional[str]:
        """Annotated field stored into by target `t` (tuple/subscript ok)."""
        if isinstance(t, (ast.Tuple, ast.List)):
            for e in t.elts:
                f = self._store_target(e)
                if f is not None:
                    return f
            return None
        if isinstance(t, ast.Subscript):
            f = _self_attr(t.value)
            return f if f is not None and f in self.guards else None
        f = _self_attr(t)
        return f if f is not None and f in self.guards else None

    def _order_str(self) -> str:
        names = [n for n, _ in sorted(self.order, key=lambda kv: kv[1])]
        return " -> ".join(names)


def check_source(source: str, path: str) -> List[Finding]:
    """Run the lock-discipline pass over one file's source."""
    try:
        tree = ast.parse(source, filename=path)
    except SyntaxError:
        return []                 # torchlint already reports parse failures
    lines = source.splitlines()
    order: List[Tuple[str, int]] = []
    for line in lines:
        m = _LOCK_ORDER.search(line)
        if m:
            order = [(m.group(1), 0), (m.group(2), 1)]
            break
    findings: List[Finding] = []
    for node in ast.walk(tree):
        if isinstance(node, ast.ClassDef):
            pas = _ClassPass(node, path, lines, order, findings)
            pas.run()
            if order:
                missing = [n for n, _ in order
                           if n not in pas.lock_fields]
                if missing and not pas.lock_fields.isdisjoint(
                        {n for n, _ in order}):
                    # The contract names this class's locks partially:
                    # one side exists, the other never does — rot.
                    for n in missing:
                        findings.append(Finding(
                            rule="L003", path=path, line=1,
                            symbol=node.name,
                            message=f"lock-order names {n!r} but "
                                    f"{node.name} never assigns "
                                    f"self.{n} to a lock"))
    return findings


def check_file(filename: str, repo_rel: str) -> List[Finding]:
    with open(filename, "r", encoding="utf-8") as fh:
        return check_source(fh.read(), repo_rel)
