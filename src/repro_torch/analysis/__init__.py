"""repro_torch.analysis: the port's static contract checker.

Three checker families behind one runner (`python -m repro_torch.analysis`),
the counterpart of the JAX package's repro.analysis:

* torchlint (T00x)    — AST lint for torch RNG and host-sync discipline
* contracts (C00x)    — CUDA kernels' memory contracts vs. their launch plans
* locks (L00x)        — serve / fleet guarded-by and lock-order discipline

Suppressions live in `analysis_baseline_torch.toml` at the repo root.
"""
from repro_torch.analysis.findings import RULES, Finding          # noqa: F401
from repro_torch.analysis.runner import main, run                 # noqa: F401
