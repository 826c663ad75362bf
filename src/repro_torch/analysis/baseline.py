"""Baseline suppressions: `analysis_baseline_torch.toml` at the repo root.

The semantics of repro.analysis.baseline, against the port's catalogue.
A suppression is a justified, reviewed exception: every entry must carry
a non-empty `reason`, and matches are as narrow as the entry makes them:

    [[suppress]]
    rule   = "T002"                              # required: exact rule id
    path   = "src/repro_torch/core/kmeans.py"    # required: repo-relative
    symbol = "_lloyd"                            # optional: enclosing qualname
    reason = "why this is intentional"           # required, non-empty

Omitting `symbol` suppresses the rule for the whole file (use
sparingly). Line numbers are deliberately not part of the match — they
churn on every edit; rule + path + symbol is stable across refactors that
do not change behaviour. A missing file means no suppressions. A
malformed baseline (missing reason, unknown rule id) is itself a fatal
error: the suppression file must never rot into a silent allowlist.
"""
from __future__ import annotations

import dataclasses
import tomllib
from pathlib import Path
from typing import Dict, List, Tuple

from repro_torch.analysis.findings import RULES, Finding


@dataclasses.dataclass(frozen=True)
class Suppression:
    rule: str
    path: str
    symbol: str          # "" = whole file
    reason: str

    def matches(self, f: Finding) -> bool:
        if self.rule != f.rule or self.path != f.path:
            return False
        return self.symbol in ("", f.symbol)


class BaselineError(ValueError):
    """The baseline file is malformed; fix the file, don't skip it."""


def load_baseline(path: str | Path) -> List[Suppression]:
    """Parse + validate the baseline file; missing file = no suppressions."""
    p = Path(path)
    if not p.exists():
        return []
    with open(p, "rb") as fh:
        doc = tomllib.load(fh)
    entries = doc.get("suppress", [])
    if not isinstance(entries, list):
        raise BaselineError(f"{p}: [[suppress]] must be an array of tables")
    out = []
    for i, e in enumerate(entries):
        where = f"{p}: suppress[{i}]"
        for req in ("rule", "path", "reason"):
            if not isinstance(e.get(req), str) or not e.get(req).strip():
                raise BaselineError(f"{where}: non-empty {req!r} is required")
        if e["rule"] not in RULES:
            raise BaselineError(f"{where}: unknown rule id {e['rule']!r}; "
                                f"known: {sorted(RULES)}")
        out.append(Suppression(rule=e["rule"],
                               path=Path(e["path"]).as_posix(),
                               symbol=str(e.get("symbol", "")),
                               reason=e["reason"].strip()))
    return out


def apply_baseline(findings: List[Finding],
                   suppressions: List[Suppression]
                   ) -> Tuple[List[Finding], List[Finding], List[Suppression]]:
    """Partition findings into (active, suppressed); third element is the
    stale suppressions that matched nothing (reported so the baseline
    shrinks when fixes land, instead of accreting dead entries)."""
    active: List[Finding] = []
    suppressed: List[Finding] = []
    used: Dict[Suppression, int] = {s: 0 for s in suppressions}
    for f in findings:
        hit = next((s for s in suppressions if s.matches(f)), None)
        if hit is None:
            active.append(f)
        else:
            used[hit] += 1
            suppressed.append(f)
    stale = [s for s, n in used.items() if n == 0]
    return active, suppressed, stale
