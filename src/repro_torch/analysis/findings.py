"""Finding model + rule catalogue for the port's static contract checker.

Every checker (torchlint, kernel contracts, lock discipline) reports
`Finding` records — rule id, file:line anchor, the enclosing symbol and
a one-line message — so the runner can render one table, match baseline
suppressions uniformly, and gate on the active count. `Finding`,
`sort_findings`, `format_table` and `format_markdown` are copies of
repro.analysis.findings (the port imports nothing of the JAX package).

The catalogue is the port's own:

* T001-T003 stand in for the JAX package's J001-J003: RNG discipline
  (torch draws take an explicit generator, where JAX splits keys), host
  syncs and branches on tensors inside a hot scope (a function marked
  `# hot-path`, where JAX has its jit- and Pallas-traced scopes).
* J004 (mutable static jit arguments) has no counterpart: the port has no
  jax.jit and no torch.compile, so no function has static arguments.
* C001-C003 keep their ids, with the JAX package's VMEM read as a CUDA
  block's shared memory and HBM as the card's DRAM.
* L001-L003 and X001 keep their ids and their meaning.

Rule ids are stable API: tests and `analysis_baseline_torch.toml` key on
them. Add new rules with new ids; never recycle a retired id.
"""
from __future__ import annotations

import dataclasses
from typing import Dict, List, Optional

RULES: Dict[str, str] = {
    # torchlint (AST): RNG discipline, host syncs in hot scopes
    "T001": "random draw without an explicit generator= (or a global "
            "torch.manual_seed) in package code",
    "T002": "host-sync call (.item()/.tolist()/.cpu()/.numpy()/"
            "np.asarray/float/int/bool of a tensor) inside a "
            "`# hot-path` scope",
    "T003": "Python `if`/`while`/`assert`/conditional expression on a "
            "tensor inside a `# hot-path` scope (an implicit host sync)",
    # kernel-contract verifier (registry-driven)
    "C001": "kernel's declared memory contract (DRAM bytes, shared "
            "memory) diverges from its launch plan's derived traffic",
    "C002": "kernel's per-block shared memory exceeds the budget at a "
            "registered parity case",
    "C003": "registered kernel has no memory contract",
    # infrastructure
    "X001": "file does not parse",
    # lock discipline (serve and fleet tiers)
    "L001": "field annotated `# guarded-by: <lock>` mutated outside "
            "`with self.<lock>`",
    "L002": "lock acquisition order contradicts the file's "
            "`# lock-order:` contract",
    "L003": "guarded-by/lock-order annotation names a lock the class "
            "never defines",
}


@dataclasses.dataclass(frozen=True)
class Finding:
    """One checker hit, anchored to file:line and the enclosing symbol."""
    rule: str
    path: str          # repo-relative posix path
    line: int
    symbol: str        # enclosing function/class qualname ("" at module level)
    message: str

    def render(self) -> str:
        sym = f" [{self.symbol}]" if self.symbol else ""
        return f"{self.path}:{self.line}: {self.rule}{sym} {self.message}"


def sort_findings(findings: List[Finding]) -> List[Finding]:
    return sorted(findings, key=lambda f: (f.path, f.line, f.rule))


def format_table(findings: List[Finding],
                 title: Optional[str] = None) -> str:
    """Fixed-width findings table (the CLI read-out)."""
    lines = []
    if title:
        lines.append(title)
    if not findings:
        lines.append("  (no findings)")
        return "\n".join(lines)
    for f in sort_findings(findings):
        lines.append("  " + f.render())
    return "\n".join(lines)


def format_markdown(active: List[Finding], suppressed: List[Finding]) -> str:
    """GitHub step-summary markdown: one table, active findings first."""
    out = ["## repro_torch.analysis findings",
           "",
           f"**{len(active)} active**, {len(suppressed)} baseline-suppressed",
           ""]
    if active or suppressed:
        out += ["| status | rule | location | symbol | message |",
                "|---|---|---|---|---|"]
        for status, batch in (("ACTIVE", active), ("baseline", suppressed)):
            for f in sort_findings(batch):
                msg = f.message.replace("|", "\\|")
                out.append(f"| {status} | {f.rule} | `{f.path}:{f.line}` | "
                           f"`{f.symbol}` | {msg} |")
    return "\n".join(out) + "\n"
