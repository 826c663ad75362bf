"""CLI entry point: `python -m repro_torch.analysis [paths]`.

Runs all three checker families (torchlint + lock discipline over the
given paths, the kernel-contract verifier over the registry), applies
the repo-root `analysis_baseline_torch.toml` suppressions, prints one
findings table, mirrors it into the GitHub step summary when running in
CI, and exits non-zero iff any ACTIVE (unsuppressed) finding remains.

Exit codes: 0 clean, 1 active findings, 2 the run itself is broken
(malformed baseline, nonexistent path).
"""
from __future__ import annotations

import argparse
import os
import sys
from pathlib import Path
from typing import List, Sequence, TextIO

from repro_torch.analysis import locks, torchlint
from repro_torch.analysis.baseline import BaselineError, apply_baseline, \
    load_baseline
from repro_torch.analysis.findings import Finding, RULES, format_markdown, \
    format_table

BASELINE = "analysis_baseline_torch.toml"
DEFAULT_PATHS = ["src/repro_torch"]

_SKIP_DIRS = {"__pycache__", ".git", ".pytest_cache", ".ruff_cache",
              "build", "dist", ".eggs"}


def discover(paths: Sequence[str]) -> List[Path]:
    """All .py files under `paths` (files taken as-is), sorted, deduped."""
    out: List[Path] = []
    for p in paths:
        path = Path(p)
        if path.is_file():
            if path.suffix == ".py":
                out.append(path)
        elif path.is_dir():
            for f in sorted(path.rglob("*.py")):
                if not any(part in _SKIP_DIRS or part.startswith(".")
                           for part in f.parts):
                    out.append(f)
        else:
            raise FileNotFoundError(p)
    seen = set()
    uniq = []
    for f in out:
        key = f.resolve()
        if key not in seen:
            seen.add(key)
            uniq.append(f)
    return uniq


def _rel(path: Path) -> str:
    """Repo-relative posix path (what baseline entries match against)."""
    try:
        return path.resolve().relative_to(Path.cwd().resolve()).as_posix()
    except ValueError:
        return path.as_posix()


def run(paths: Sequence[str], baseline: str = BASELINE,
        contracts: bool = True, out: TextIO = sys.stdout) -> int:
    try:
        suppressions = load_baseline(baseline)
    except BaselineError as exc:
        print(f"error: {exc}", file=out)
        return 2
    try:
        files = discover(paths)
    except FileNotFoundError as exc:
        print(f"error: no such path: {exc}", file=out)
        return 2

    findings: List[Finding] = []
    for f in files:
        rel = _rel(f)
        source = f.read_text(encoding="utf-8")
        findings += torchlint.lint_source(source, rel)
        findings += locks.check_source(source, rel)
    if contracts:
        from repro_torch.analysis.contracts import verify_contracts
        findings += verify_contracts()

    active, suppressed, stale = apply_baseline(findings, suppressions)

    print(f"repro_torch.analysis: {len(files)} files, "
          f"{len(findings)} findings "
          f"({len(active)} active, {len(suppressed)} suppressed)",
          file=out)
    if active:
        print(format_table(active, title="ACTIVE findings:"), file=out)
    if suppressed:
        print(format_table(suppressed,
                           title=f"baseline-suppressed ({baseline}):"),
              file=out)
    for s in stale:
        print(f"warning: stale suppression matched nothing: "
              f"{s.rule} {s.path} {s.symbol or '(whole file)'} — "
              f"remove it from {baseline}", file=out)

    summary_path = os.environ.get("GITHUB_STEP_SUMMARY")
    if summary_path:
        with open(summary_path, "a", encoding="utf-8") as fh:
            fh.write(format_markdown(active, suppressed))

    return 1 if active else 0


def main(argv: Sequence[str] | None = None) -> int:
    parser = argparse.ArgumentParser(
        prog="python -m repro_torch.analysis",
        description="Static contract checker of the PyTorch port: torch "
                    "RNG / host-sync lint, CUDA kernel memory contracts, "
                    "lock discipline.")
    parser.add_argument("paths", nargs="*", default=DEFAULT_PATHS,
                        help="files or directories to lint "
                             "(default: src/repro_torch)")
    parser.add_argument("--baseline", default=BASELINE,
                        help=f"suppression file (default: {BASELINE})")
    parser.add_argument("--skip-contracts", action="store_true",
                        help="skip the kernel-contract verifier "
                             "(pure-AST run, no torch import)")
    parser.add_argument("--list-rules", action="store_true",
                        help="print the rule catalogue and exit")
    ns = parser.parse_args(argv)
    if ns.list_rules:
        for rule in sorted(RULES):
            print(f"{rule}  {RULES[rule]}")
        return 0
    return run(ns.paths or DEFAULT_PATHS, baseline=ns.baseline,
               contracts=not ns.skip_contracts)
