"""repro_torch.analysis, the port's static contract checker, held against
the JAX package's repro.analysis where the two share semantics.

The lock pass, the baseline and the findings table are the JAX package's:
the same fixtures and files give the same findings, suppressions, errors
and text through both. torchlint's rules T001-T003 (the counterparts of
J001-J003) get a seeded violation and a clean twin each. The kernel
contracts (C001-C003): declared == derived and declared >= the bound's
bytes at every registry case, the launch parameters the wrappers pass
(recorded on the CPU through a library that runs nothing) equal to their
plans', the reading of a profiler trace's launches, and seeded drift, a
tiny budget and a missing contract. The `# hot-path` map lists every jit
site of the JAX package beside its port counterpart or the reason it has
none. The gate: the runner over src/repro_torch exits 0.
"""
import ast
import dataclasses
import io
import re
import textwrap
from pathlib import Path

import numpy as np
import pytest
import torch

from repro.analysis import baseline as jax_baseline
from repro.analysis import findings as jax_findings
from repro.analysis import locks as jax_locks
from repro_torch.analysis import contracts, locks, runner, torchlint
from repro_torch.analysis.baseline import (BaselineError, Suppression,
                                           apply_baseline, load_baseline)
from repro_torch.analysis.findings import RULES, Finding, format_table
from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels import registry

REPO = Path(__file__).resolve().parents[1]
PORT = REPO / "src" / "repro_torch"


def lint(src: str):
    return torchlint.lint_source(textwrap.dedent(src), "fixture.py")


def rule_ids(findings):
    return sorted(f.rule for f in findings)


def as_tuples(findings):
    return [dataclasses.astuple(f) for f in findings]


# -- the lock pass: JAX's, finding for finding ------------------------------

_LOCK_FIXTURES = {
    "unlocked_mutation": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []   # guarded-by: _lock

            def add(self, x):
                self._items.append(x)
    """,
    "under_lock": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._items = []   # guarded-by: _lock

            def add(self, x):
                with self._lock:
                    self._items.append(x)
    """,
    "unlocked_rebind": """
        import threading

        class Sched:
            def __init__(self):
                self._lock = threading.Lock()
                self._thread = None   # guarded-by: _lock

            def stop(self):
                self._thread = None
    """,
    "tuple_swap": """
        import threading

        class Sched:
            def __init__(self):
                self._lock = threading.Lock()
                self._thread = None   # guarded-by: _lock

            def stop(self):
                with self._lock:
                    thread, self._thread = self._thread, None
                if thread is not None:
                    thread.join()
    """,
    "inverted_order": """
        import threading

        # lock-order: _flush_lock -> _lock

        class Sched:
            def __init__(self):
                self._flush_lock = threading.Lock()
                self._lock = threading.Lock()

            def run(self):
                with self._lock:
                    with self._flush_lock:
                        pass
    """,
    "contract_order": """
        import threading

        # lock-order: _flush_lock -> _lock

        class Sched:
            def __init__(self):
                self._flush_lock = threading.Lock()
                self._lock = threading.Lock()

            def run(self):
                with self._flush_lock:
                    with self._lock:
                        pass
    """,
    "guard_names_missing_lock": """
        class Box:
            def __init__(self):
                self._items = []   # guarded-by: _lock
    """,
    "order_names_missing_lock": """
        import threading

        # lock-order: _flush_lock -> _lock

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
    """,
    "del_and_subscript": """
        import threading

        class Box:
            def __init__(self):
                self._lock = threading.Lock()
                self._map = {}   # guarded-by: _lock

            def drop(self, k):
                del self._map[k]

            def put(self, k, v):
                self._map[k] = v
    """,
    "syntax_error": "def broken(:\n",
}

_ANNOTATED = ("serve/registry.py", "serve/scheduler.py",
              "fleet/admission.py", "fleet/router.py", "fleet/worker.py")


@pytest.mark.parametrize("name", sorted(_LOCK_FIXTURES))
def test_lock_fixture_findings_equal_jax(name):
    src = textwrap.dedent(_LOCK_FIXTURES[name])
    port = as_tuples(locks.check_source(src, "fixture.py"))
    want = as_tuples(jax_locks.check_source(src, "fixture.py"))
    assert port == want
    if name in ("unlocked_mutation", "inverted_order",
                "guard_names_missing_lock"):
        assert port, name                  # the fixture does fire


@pytest.mark.parametrize("rel", _ANNOTATED)
def test_port_lock_contracts_hold_under_both_checkers(rel):
    src = (PORT / rel).read_text()
    assert "# guarded-by:" in src or "# lock-order:" in src
    path = f"src/repro_torch/{rel}"
    assert locks.check_source(src, path) == []
    assert jax_locks.check_source(src, path) == []


def test_inverted_scheduler_order_is_flagged_by_both():
    src = (PORT / "serve/scheduler.py").read_text()
    assert "# lock-order: _flush_lock -> _lock" in src
    inverted = textwrap.indent(textwrap.dedent("""
        def _inverted(self):
            with self._lock:
                with self._flush_lock:
                    return len(self._queue)
    """), "    ")
    port = locks.check_source(src + inverted, "inverted.py")
    assert [f.rule for f in port] == ["L002"]
    assert as_tuples(port) == as_tuples(
        jax_locks.check_source(src + inverted, "inverted.py"))


# -- the baseline: JAX's semantics -----------------------------------------

_BASELINES = {
    "two_entries": '[[suppress]]\nrule = "L001"\npath = "a.py"\n'
                   'symbol = "Box.add"\nreason = "single writer"\n\n'
                   '[[suppress]]\nrule = "C002"\npath = "./b.py"\n'
                   'reason = "  budget waived  "\n',
    "empty": "",
    "no_entries": "# nothing suppressed\n",
    "missing_reason": '[[suppress]]\nrule = "L001"\npath = "x.py"\n',
    "blank_reason": '[[suppress]]\nrule = "L001"\npath = "x.py"\n'
                    'reason = "   "\n',
    "unknown_rule": '[[suppress]]\nrule = "Z999"\npath = "x.py"\n'
                    'reason = "nope"\n',
    "missing_path": '[[suppress]]\nrule = "C001"\nreason = "r"\n',
    "not_an_array": 'suppress = "L001"\n',
}


@pytest.mark.parametrize("name", sorted(_BASELINES))
def test_baseline_parses_as_jax_does(tmp_path, name):
    p = tmp_path / "b.toml"
    p.write_text(_BASELINES[name])
    try:
        want = [dataclasses.astuple(s) for s in jax_baseline.load_baseline(p)]
    except jax_baseline.BaselineError:
        with pytest.raises(BaselineError):
            load_baseline(p)
        return
    assert [dataclasses.astuple(s) for s in load_baseline(p)] == want


def test_baseline_missing_file_means_no_suppressions(tmp_path):
    assert load_baseline(tmp_path / "nope.toml") == []
    assert jax_baseline.load_baseline(tmp_path / "nope.toml") == []


def test_baseline_refuses_jax_rule_ids(tmp_path):
    p = tmp_path / "b.toml"
    p.write_text('[[suppress]]\nrule = "J001"\npath = "x.py"\n'
                 'reason = "the JAX catalogue"\n')
    with pytest.raises(BaselineError):
        load_baseline(p)


def test_apply_baseline_partitions_as_jax_does():
    raw = [("L001", "a.py", 3, "Box.add", "mutated"),
           ("L001", "a.py", 9, "Box.pop", "mutated"),
           ("C002", "b.py", 1, "gram_stripe", "over budget"),
           ("L002", "c.py", 4, "Sched.run", "inverted")]
    sups = [("L001", "a.py", "Box.add", "single writer"),
            ("C002", "b.py", "", "whole file"),
            ("L003", "gone.py", "", "stale")]
    port = apply_baseline([Finding(*f) for f in raw],
                          [Suppression(*s) for s in sups])
    want = jax_baseline.apply_baseline(
        [jax_findings.Finding(*f) for f in raw],
        [jax_baseline.Suppression(*s) for s in sups])
    for got, exp in zip(port, want):
        assert [dataclasses.astuple(x) for x in got] == \
            [dataclasses.astuple(x) for x in exp]
    assert [f.line for f in port[0]] == [9, 4]
    assert [s.path for s in port[2]] == ["gone.py"]


def test_format_table_text_equals_jax():
    raw = [("L002", "b.py", 7, "Sched.run", "acquires a | b"),
           ("L001", "a.py", 3, "", "mutated"),
           ("C001", "a.py", 3, "gram_stripe", "declared 1 B")]
    for title in (None, "ACTIVE findings:"):
        assert format_table([Finding(*f) for f in raw], title) == \
            jax_findings.format_table(
                [jax_findings.Finding(*f) for f in raw], title)
    assert format_table([]) == jax_findings.format_table([])


def test_repo_baseline_entries_have_reasons():
    entries = load_baseline(REPO / "analysis_baseline_torch.toml")
    assert all(e.reason for e in entries)
    lloyd = [e for e in entries if e.path == "src/repro_torch/core/kmeans.py"]
    assert [(e.rule, e.symbol) for e in lloyd] == [("T002", "_lloyd")]


# -- T001: RNG discipline ---------------------------------------------------

@pytest.mark.parametrize("call", [
    "torch.randn((3,))", "torch.rand(3)", "torch.randint(0, 5, (3,))",
    "torch.randperm(7)", "torch.normal(0.0, 1.0, (3,))",
    "torch.bernoulli(x)", "torch.multinomial(x, 1)",
    "torch.randn((3,), generator=None)", "x.normal_()", "x.uniform_(0, 1)",
    "x.random_(0, 9)", "x.exponential_()",
    "torch.nn.init.normal_(x)", "nn.init.kaiming_uniform_(x)",
    "torch.manual_seed(0)", "torch.cuda.manual_seed_all(0)"])
def test_t001_fires_on_a_global_draw(call):
    findings = lint(f"""
        import torch
        from torch import nn

        def draw(x):
            return {call}
    """)
    assert rule_ids(findings) == ["T001"]
    assert findings[0].symbol == "draw"


@pytest.mark.parametrize("call", [
    "torch.randn((3,), generator=gen)", "torch.randperm(7, generator=gen)",
    "torch.multinomial(x, 1, generator=gen)", "x.normal_(generator=gen)",
    "torch.nn.init.normal_(x, generator=gen)", "torch.nn.init.zeros_(x)",
    "torch.Generator().manual_seed(0)", "gen.manual_seed(3)",
    "torch.randn((3,), **kw)", "torch.zeros(3)"])
def test_t001_clean_with_an_explicit_generator(call):
    findings = lint(f"""
        import torch

        def draw(x, gen, kw):
            return {call}
    """)
    assert findings == []


# -- T002: host sync in a hot scope -----------------------------------------

@pytest.mark.parametrize("expr", [
    "y.item()", "y.tolist()", "y.cpu()", "y.numpy()", "float(y.sum())",
    "int(torch.argmax(y))", "bool(y.any())", "np.asarray(y)",
    "np.array(y * 2)"])
def test_t002_fires_in_a_hot_scope(expr):
    findings = lint(f"""
        import numpy as np
        import torch

        def step(x: torch.Tensor, n: int):  # hot-path
            y = x * 2
            return {expr}
    """)
    assert rule_ids(findings) == ["T002"]


@pytest.mark.parametrize("expr", [
    "float(y.shape[0])", "int(n)", "bool(x.numel())", "len(y)",
    "np.asarray(x.shape)", "float(gamma)", "int(x.size(0))",
    "bool(helper(y))"])
def test_t002_clean_on_host_values(expr):
    findings = lint(f"""
        import numpy as np
        import torch
        from somewhere import helper

        def step(x: torch.Tensor, n: int, gamma: float):  # hot-path
            y = x * 2
            return {expr}
    """)
    assert findings == []


def test_t002_clean_outside_a_hot_scope():
    findings = lint("""
        import torch

        def report(x: torch.Tensor):
            return float(x.sum()), x.item(), x.cpu()
    """)
    assert findings == []


def test_t002_follows_the_files_own_functions_and_closures():
    # Lloyd's shape: a tensor from a nested function that reads the
    # enclosing scope's tensors, then a module function's tuple.
    findings = lint("""
        import torch

        def _pair(Y: torch.Tensor):
            return Y.sum(), Y.max()

        def loop(Y: torch.Tensor, k: int):  # hot-path
            it = torch.zeros((3,))

            def running():
                return it < k

            active = running()
            while bool(active.any()):
                it = it + 1
                active = running()
            total, peak = _pair(Y)
            return int(peak)
    """)
    assert [(f.rule, f.line) for f in findings] == [("T002", 14),
                                                    ("T002", 18)]
    assert {f.symbol for f in findings} == {"loop"}


def test_hot_marker_on_any_signature_line_and_nested_scopes():
    findings = lint("""
        import torch

        def outer(x: torch.Tensor,
                  n: int) -> torch.Tensor:  # hot-path
            def inner(y: torch.Tensor):
                return y.item()

            def marked(y: torch.Tensor):  # hot-path
                return y.item()
            return x
    """)
    assert [(f.rule, f.symbol) for f in findings] == [
        ("T002", "outer.marked")]


# -- T003: branch on a tensor in a hot scope --------------------------------

def _hot_step(stmt: str) -> str:
    return ("import torch\nfrom kernels import plain_path\n\n"
            "def step(x: torch.Tensor, n: int):  # hot-path\n"
            + textwrap.indent(stmt, "    ") + "\n    return n\n")


@pytest.mark.parametrize("stmt", [
    "if x.sum() > 0:\n    n += 1",
    "while (x > 0).any():\n    x = x - 1",
    "assert (x >= 0).all()",
    "n = 1 if x.max() > 0 else 2",
    "if not x.any():\n    n = 0"])
def test_t003_fires_on_a_tensor_test(stmt):
    findings = lint(_hot_step(stmt))
    assert rule_ids(findings) == ["T003"]


@pytest.mark.parametrize("stmt", [
    "if x.shape[0] > n:\n    n += 1",
    "if x is None:\n    n = 0",
    "if x.dim() != 2 or x.dtype != torch.float32:\n    n = 0",
    "if isinstance(x, torch.Tensor):\n    n = 1",
    "n = 1 if x.device.type == 'cpu' else 2",
    "if plain_path('op', x):\n    n = 3",
    "assert x.numel() > 0"])
def test_t003_clean_on_concrete_tests(stmt):
    assert lint(_hot_step(stmt)) == []


def test_t003_clean_outside_a_hot_scope():
    findings = lint("""
        import torch

        def check(x: torch.Tensor):
            if x.sum() > 0:
                return 1
            return 0
    """)
    assert findings == []


def test_x001_fires_on_syntax_error():
    assert rule_ids(lint("def broken(:\n")) == ["X001"]


def test_the_known_finding_is_lloyds_convergence_read():
    src = (PORT / "core/kmeans.py").read_text()
    findings = torchlint.lint_source(src, "src/repro_torch/core/kmeans.py")
    assert [(f.rule, f.symbol) for f in findings] == [("T002", "_lloyd")]
    line = src.splitlines()[findings[0].line - 1]
    assert "while bool(active.any())" in line


# -- the # hot-path map: every jit site of the JAX package ------------------

# JAX jit site (src/repro file:line) -> the port's counterpart as
# (file under src/repro_torch, qualname), or the reason it has none.
HOT_MAP = {
    "serve/extend.py:97": [("serve/extend.py", "Extender.embed")],
    "serve/extend.py:108": [("serve/extend.py", "Extender.embed"),
                            ("serve/extend.py", "Extender._assign_stripes")],
    "serve/extend.py:236": [("serve/extend.py", "_assign_plain")],
    "serve/extend.py:341": [("serve/extend.py", "ShardedExtender.embed")],
    "serve/bench.py:332": "lowered for its cost analysis only",
    "serve/bench.py:335": "lowered for its cost analysis only",
    "serve/bench.py:683": "lowered for its cost analysis only",
    "serve/bench.py:686": "lowered for its cost analysis only",
    "serve/bench.py:688": "lowered for its cost analysis only",
    "serve/bench.py:796": "the bench's calibration product, timed on "
                          "purpose, not a serving path",
    "kernels/kmeans_assign/ops.py:48": [
        ("kernels/kmeans_assign/ops.py", "assign_op"),
        ("kernels/kmeans_assign/ops.py", "embed_assign_op")],
    "kernels/gram/ops.py:53": [("kernels/gram/ops.py", "gram_stripe_op")],
    "kernels/fit_sketch/ops.py:71": [("kernels/fit_sketch/ops.py",
                                      "fit_sketch_op")],
    "kernels/fwht/ops.py:52": [("kernels/fwht/ops.py", "fwht_op"),
                               ("kernels/fwht/ops.py", "srht_t_op")],
    "kernels/extend_embed/ops.py:64": [("kernels/extend_embed/ops.py",
                                        "extend_embed_op")],
    "distributed/fit.py:153": [("distributed/fit.py",
                                "ShardedFitEngine._default")],
    "distributed/fit.py:170": [("stream/accumulate.py",
                                "SketchAccumulator._store")],
    "distributed/fit.py:291": [("distributed/fit.py", "ShardedFitEngine.apply"),
                               ("distributed/fit.py",
                                "ShardedFitEngine._fused")],
    "distributed/fit.py:313": [("distributed/fit.py", "ShardedFitEngine.apply")],
    "distributed/fit.py:315": [("distributed/fit.py",
                                "ShardedFitEngine._default")],
    "distributed/fit.py:343": [("distributed/fit.py", "ShardedFitEngine.apply")],
    "stream/minibatch.py:36": [("stream/minibatch.py", "minibatch_kmeans")],
    "core/kmeans.py:97": [("core/kmeans.py", "kmeans"),
                          ("core/kmeans.py", "_lloyd")],
    "core/kernels_fn.py:88": [("core/kernels_fn.py", "gram_stripe")],
    # core.sketch.fwht is kernels/fwht/ref.py's fwht_ref, imported by name.
    "core/sketch.py:49": [("kernels/fwht/ref.py", "fwht_ref")],
    "launch/dryrun.py:101": "lowered for the dry run's cost analysis "
                            "(launch/op_analysis.py counts the port's)",
    "launch/dryrun.py:116": "lowered for the dry run's cost analysis "
                            "(launch/op_analysis.py counts the port's)",
    "launch/dryrun.py:132": "lowered for the dry run's cost analysis "
                            "(launch/op_analysis.py counts the port's)",
    "launch/serve.py:38": [("train/steps.py", "make_prefill_step.prefill_step"),
                           ("train/steps.py",
                            "make_prefill_step.mesh_prefill_step")],
    "launch/serve.py:39": [("train/steps.py", "make_decode_step.decode_step")],
    "launch/train.py:100": [("train/steps.py", "make_train_step.train_step"),
                            ("train/steps.py", "_make_mesh_step.train_step")],
}


def _jax_jit_sites():
    src = REPO / "src" / "repro"
    sites = set()
    for path in sorted(src.rglob("*.py")):
        rel = path.relative_to(src).as_posix()
        if rel.startswith("analysis/"):
            continue
        for i, line in enumerate(path.read_text().splitlines(), 1):
            if re.search(r"jax\.jit|@jit", line):
                sites.add(f"{rel}:{i}")
    return sites


def _find_def(tree, qualname):
    parts = qualname.split(".")

    def walk(node, prefix):
        for child in ast.iter_child_nodes(node):
            if isinstance(child, (ast.FunctionDef, ast.ClassDef)):
                q = prefix + [child.name]
                if q == parts:
                    return child
                hit = walk(child, q)
            else:
                hit = walk(child, prefix)
            if hit is not None:
                return hit
        return None
    return walk(tree, [])


def test_hot_map_covers_every_jax_jit_site():
    sites = _jax_jit_sites()
    assert len(sites) == 31
    assert sites == set(HOT_MAP)


@pytest.mark.parametrize("site", sorted(HOT_MAP))
def test_hot_map_counterpart_carries_the_marker(site):
    target = HOT_MAP[site]
    if isinstance(target, str):
        assert target                       # a reason, no counterpart
        return
    for rel, qualname in target:
        src = (PORT / rel).read_text()
        tree = ast.parse(src)
        fn = _find_def(tree, qualname)
        assert isinstance(fn, ast.FunctionDef), (rel, qualname)
        linter = torchlint._Linter(tree, src, rel)
        assert linter.is_hot(fn), f"{rel}::{qualname} lacks # hot-path"


# -- kernel contracts (C001-C003) -------------------------------------------

_NAMES = registry.registered_kernels()


@pytest.mark.parametrize("name", _NAMES)
def test_declared_equals_derived_and_covers_the_bound(name):
    entry = registry.get_kernel(name)
    contract = registry.get_contract(name)
    assert contract is not None, f"{name} has no memory contract (C003)"
    for case in entry.cases:
        plan = contracts.case_plan(entry, contract, case)
        assert plan.launches, case
        declared = contract.declared(plan)
        assert declared == contracts.derive(plan), case
        assert declared["dram_bytes"] >= contract.bound_bytes(plan.shapes)
        assert 0 < declared["smem_bytes"] <= contract.smem_budget
        assert contract.smem_budget <= cm.GRAM_SMEM_MAX


class _Calls:
    """A kernel library whose entry points record their arguments and
    succeed without running anything."""

    def __init__(self):
        self.calls = []

    def __getattr__(self, name):
        def call(*args):
            self.calls.append((name, args))
            return 0
        return call


def _ints(arr, n):
    return tuple(int(arr[j]) for j in range(n))


# The launch parameters each rt_* entry point is passed (csrc/ derives the
# grid, block and shared memory from them) ...
_PASSED = {
    "rt_gram_stripe": lambda a: a[10:14],
    "rt_kmeans_assign": lambda a: (a[1], a[2], a[4]),
    "rt_extend_embed": lambda a: (a[13], a[14], a[15], a[19], bool(a[20])),
    "rt_fit_sketch": lambda a: (a[14], a[15]),
    "rt_fwht": lambda a: (_ints(a[4], a[6]), _ints(a[5], a[6]), a[7]),
    "rt_fwht_rows": lambda a: (a[3], a[4]),
    "rt_srht_t_pass": lambda a: (a[11], a[12], a[13], a[5], a[1], a[15],
                                 a[4]),
}


def _fwht_calls(plan):
    """One column's row pass as rt_fwht_rows, then every pass in one
    rt_fwht call."""
    rows = [("rt_fwht_rows", ln.tiles) for ln in plan.launches
            if ln.kernel == "fwht_rows_kernel"]
    passes = [ln.tiles for ln in plan.launches
              if ln.kernel == "fwht_pass_kernel"]
    if not passes:
        return rows
    return rows + [("rt_fwht", (tuple(t[0] for t in passes),
                                tuple(t[1] for t in passes), passes[0][2]))]


def _extend_calls(plan):
    per, ranges, tiles = plan.detail
    k = plan.shapes["k"]
    return [("rt_extend_embed", (tiles, per, ranges, k, bool(k)))]


# ... and the same parameters as the contract's plan has them.
_PLANNED = {
    "gram_stripe": lambda plan: [("rt_gram_stripe", (
        *plan.launches[0].tiles, plan.launches[0].grid[0],
        plan.launches[0].smem))],
    "kmeans_assign": lambda plan: [("rt_kmeans_assign", (
        plan.shapes["n"], plan.shapes["r"], plan.shapes["k"]))],
    "extend_embed": _extend_calls,
    "embed_assign": _extend_calls,
    "fit_sketch": lambda plan: [("rt_fit_sketch", plan.detail)],
    "fwht": _fwht_calls,
    "srht_t": lambda plan: [("rt_srht_t_pass", (*ln.tiles, len(ps.bases)))
                            for ln, ps in zip(plan.launches, plan.detail)],
}


@pytest.mark.parametrize("name", _NAMES)
def test_wrapper_launches_equal_the_plan(name, monkeypatch):
    """The wrapper's launch path run on the CPU against a library that runs
    nothing: the launch parameters its rt_* calls pass are those of the
    contract's plan (chip_smoke's phase 20 holds the launches themselves,
    read from a profiler trace, to the plan on the card)."""
    monkeypatch.setattr(cm, "plain_path", lambda what, *t: False)
    monkeypatch.setattr(cm, "stream", lambda t: 0)
    entry = registry.get_kernel(name)
    contract = registry.get_contract(name)
    for i, case in enumerate(entry.cases):
        args, kw = entry.build(np.random.default_rng(i), case)
        targs = [torch.from_numpy(a) for a in args]
        lib = _Calls()
        monkeypatch.setattr(_build, "library", lambda: lib)
        entry.op(*targs, **kw)
        got = [(n, tuple(_PASSED[n](a))) for n, a in lib.calls
               if n in _PASSED]
        want = _PLANNED[name](contract.plan(*targs, **kw))
        assert got == want, case


def _kernel_event(name, grid, block, smem, ts):
    return {"ph": "X", "cat": "kernel", "name": name, "ts": ts, "dur": 1.0,
            "args": {"grid": list(grid), "block": list(block),
                     "shared memory": smem, "registers per thread": 32}}


def test_traced_launches_read_a_profiler_trace():
    """chip_smoke's phase 20 reads the launches from a torch.profiler
    chrome trace: the port's kernels by their demangled or mangled names,
    in start order, others and host events left out; they compare equal
    to the plan's launches with the static shared memory added."""
    gram = registry.get_contract("gram_stripe").plan(
        np.empty((19, 3000), np.float32), np.empty((19, 512), np.float32))
    (ln,) = gram.launches
    events = [
        _kernel_event("void rt::sum_splits_kernel(float const*, int, int, "
                      "float*)", (4, 1, 1), (256, 1, 1), 0, 30.0),
        _kernel_event("void at::native::vectorized_elementwise_kernel<4>()",
                      (9, 1, 1), (128, 1, 1), 0, 5.0),
        {"ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
         "ts": 1.0, "args": {}},
        _kernel_event("void (anonymous namespace)::gram_kernel<2, 0>("
                      "float const*, int)", (*ln.grid, 1), (ln.threads, 1, 1),
                      ln.smem + 16, 10.0),
        _kernel_event("_ZN12_GLOBAL__N_117sum_assign_kernelEPKf", (1, 1, 1),
                      (256, 1, 1), 400, 20.0),
    ]
    got = contracts.traced_launches(events)
    assert [g[0] for g in got] == ["gram_kernel", "sum_assign_kernel",
                                   "sum_splits_kernel"]
    assert got[0] == contracts.planned_launch(ln, 16)
    assert got[0] != contracts.planned_launch(ln)
    assert got[2] == contracts.planned_launch(
        cm.sum_splits_launch(3, 4 * 256)[0])


# Shapes past the registry's cases, where the plans take their other
# branches: gram walking p in chunks (p > 312) and in 8 column chunks,
# extend_embed and fit_sketch past 24 rows of p, fit_sketch past 512
# block columns, points wider than 16 values, an SRHT with blocks past m,
# one column past one segment (the row pass, then passes over its view)
# and below 32 rows (the pass kernel alone).
_BRANCHES = [
    ("gram_stripe", ((400, 1000), (400, 64)), {"kind": "rbf"}),
    ("gram_stripe", ((19, 3000), (19, 4096)), {}),
    ("extend_embed", ((50, 2000), (9, 2000), (50, 300)), {"kind": "rbf"}),
    ("embed_assign", ((50, 700), (20, 700), (50, 130), (5, 20)), {}),
    ("fit_sketch", ((50, 900), (900, 11), (50, 1100), (1100, 11), (900,)),
     {"kind": "rbf"}),
    ("kmeans_assign", ((300, 20), (9, 20)), {}),
    ("fwht", ((1 << 24, 1),), {}),
    ("fwht", ((16, 1),), {}),
]


@pytest.mark.parametrize("name,shapes,kw", _BRANCHES,
                         ids=[b[0] for b in _BRANCHES])
def test_declared_equals_derived_on_every_branch(name, shapes, kw):
    contract = registry.get_contract(name)
    plan = contract.plan(*(np.empty(s, np.float32) for s in shapes), **kw)
    assert contract.declared(plan) == contracts.derive(plan)
    assert contract.declared(plan)["dram_bytes"] >= \
        contract.bound_bytes(plan.shapes)


def test_srht_blocks_past_m_write_zeros_in_the_model():
    contract = registry.get_contract("srht_t")
    rows = np.random.default_rng(3).permutation(1 << 14)[:9]
    plan = contract.plan(np.empty((1000, 3), np.float32), None, rows,
                         1 << 14)
    first = plan.detail[0]
    assert (first.bases >= 1000).any()
    assert contract.declared(plan) == contracts.derive(plan)


def test_plans_at_the_main_shapes():
    """The main path's shapes (chip_smoke's), planned and walked: gram
    reads X once per column chunk and Xb once per block; fwht moves x
    once a pass."""
    gram = registry.get_contract("gram_stripe")
    plan = gram.plan(np.empty((19, 100_000)), np.empty((19, 512)))
    assert plan.detail.grid == (132, 1) and plan.detail.resident
    declared = gram.declared(plan)
    assert declared == contracts.derive(plan)
    assert declared["dram_bytes"] == 4 * (19 * 100_000 + 19 * 512 * 132
                                          + 100_000 * 512)
    wide = gram.plan(np.empty((19, 100_000)), np.empty((19, 4096)))
    assert wide.detail.chunks == 8
    assert gram.declared(wide)["dram_bytes"] - 4 * 19 * 100_000 * 8 == \
        4 * (19 * 4096 * wide.detail.grid[0] + 100_000 * 4096)
    fwht = registry.get_contract("fwht")
    plan = fwht.plan(np.empty((1 << 17, 512)))
    assert fwht.declared(plan)["dram_bytes"] == 2 * 8 * (1 << 17) * 512
    assert fwht.declared(plan) == contracts.derive(plan)


def _one_kernel(monkeypatch, name, contract):
    entry = registry.get_kernel(name)
    monkeypatch.setattr(registry, "_REGISTRY", {name: entry})
    monkeypatch.setattr(registry, "_CONTRACTS",
                        {} if contract is None else {name: contract})
    return entry


def test_c001_fires_on_seeded_drift(monkeypatch):
    good = registry.get_contract("gram_stripe")

    def drifted(plan):
        out = dict(good.declared(plan))
        out["dram_bytes"] -= 4 * plan.shapes["n"] * plan.shapes["w"]
        return out
    _one_kernel(monkeypatch, "gram_stripe", good._replace(declared=drifted))
    findings = contracts.verify_contracts()
    assert len(findings) == len(registry.get_kernel("gram_stripe").cases)
    assert all(f.rule == "C001" and f.symbol == "gram_stripe"
               for f in findings)


def test_c001_fires_on_drifted_shared_memory(monkeypatch):
    good = registry.get_contract("fit_sketch")
    _one_kernel(monkeypatch, "fit_sketch", good._replace(
        declared=lambda plan: dict(good.declared(plan), smem_bytes=49_152)))
    findings = contracts.verify_contracts()
    assert findings and {f.rule for f in findings} == {"C001"}
    assert "shared memory" in findings[0].message


def test_c002_fires_on_a_tiny_budget(monkeypatch):
    good = registry.get_contract("extend_embed")
    _one_kernel(monkeypatch, "extend_embed", good._replace(smem_budget=1024))
    findings = contracts.verify_contracts()
    assert findings and all(f.rule == "C002" for f in findings)


def test_c003_fires_on_a_missing_contract(monkeypatch):
    _one_kernel(monkeypatch, "fwht", None)
    findings = contracts.verify_contracts()
    assert [(f.rule, f.symbol) for f in findings] == [("C003", "fwht")]
    assert findings[0].path == "src/repro_torch/kernels/fwht/ops.py"


def test_every_registered_kernel_has_a_contract():
    assert contracts.verify_contracts() == []
    assert sorted(c.name for c in registry.CONTRACTS) == _NAMES


# -- the runner ---------------------------------------------------------------

def _tree(tmp_path, source):
    root = tmp_path / "pkg"
    root.mkdir()
    (root / "mod.py").write_text(textwrap.dedent(source))
    return root


_SEEDED = """
    import torch

    def draw():
        return torch.randn((3,))
"""


def test_runner_exits_zero_on_a_clean_tree(tmp_path):
    root = _tree(tmp_path, """
        import torch

        def draw(gen):
            return torch.randn((3,), generator=gen)
    """)
    buf = io.StringIO()
    assert runner.run([str(root)], baseline=str(tmp_path / "none.toml"),
                      contracts=False, out=buf) == 0
    assert "0 findings" in buf.getvalue()


def test_runner_exits_one_on_a_seeded_violation(tmp_path):
    root = _tree(tmp_path, _SEEDED)
    buf = io.StringIO()
    assert runner.run([str(root)], baseline=str(tmp_path / "none.toml"),
                      contracts=False, out=buf) == 1
    assert "T001" in buf.getvalue()


def test_runner_suppression_downgrades_to_zero(tmp_path, monkeypatch):
    monkeypatch.chdir(tmp_path)
    _tree(tmp_path, _SEEDED)
    (tmp_path / "b.toml").write_text(
        '[[suppress]]\nrule = "T001"\npath = "pkg/mod.py"\n'
        'symbol = "draw"\nreason = "fixture: a global draw on purpose"\n'
        '\n[[suppress]]\nrule = "L001"\npath = "pkg/gone.py"\n'
        'reason = "stale"\n')
    buf = io.StringIO()
    assert runner.run(["pkg"], baseline="b.toml", contracts=False,
                      out=buf) == 0
    text = buf.getvalue()
    assert "1 suppressed" in text and "stale suppression" in text


@pytest.mark.parametrize("broken", ["path", "baseline"])
def test_runner_exits_two_when_broken(tmp_path, broken):
    root = _tree(tmp_path, _SEEDED)
    bad = tmp_path / "bad.toml"
    bad.write_text('[[suppress]]\nrule = "T001"\npath = "x.py"\n')
    paths = [str(tmp_path / "ghost")] if broken == "path" else [str(root)]
    baseline = str(bad) if broken == "baseline" else str(tmp_path / "n.toml")
    assert runner.run(paths, baseline=baseline, contracts=False,
                      out=io.StringIO()) == 2


def test_runner_writes_github_step_summary(tmp_path, monkeypatch):
    summary = tmp_path / "summary.md"
    monkeypatch.setenv("GITHUB_STEP_SUMMARY", str(summary))
    root = _tree(tmp_path, _SEEDED)
    assert runner.run([str(root)], baseline=str(tmp_path / "none.toml"),
                      contracts=False, out=io.StringIO()) == 1
    text = summary.read_text()
    assert "repro_torch.analysis findings" in text and "ACTIVE" in text


def test_list_rules_covers_the_catalogue(capsys):
    assert runner.main(["--list-rules"]) == 0
    out = capsys.readouterr().out
    for rule in ("T001", "T002", "T003", "C001", "C002", "C003", "L001",
                 "L002", "L003", "X001"):
        assert rule in out
    assert set(RULES) == {line.split()[0] for line in out.splitlines()}
    assert "J004" not in RULES


def test_gate_runs_clean_over_the_port(monkeypatch):
    """The gate: `python -m repro_torch.analysis src/repro_torch` exits 0
    with the port's baseline, kernel contracts included."""
    monkeypatch.chdir(REPO)
    buf = io.StringIO()
    rc = runner.run(["src/repro_torch"], out=buf)
    assert rc == 0, buf.getvalue()
    assert "warning" not in buf.getvalue()
