"""The port stands alone: no jax, nothing of repro; the card by default."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.kernels import OPS, registry, reset_launches

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"]


def _imports(path):
    tree = ast.parse(path.read_text(), filename=str(path))
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module or ""


@pytest.mark.parametrize("path", PORT_FILES,
                         ids=[str(p.relative_to(REPO)) for p in PORT_FILES])
def test_no_jax_or_repro_import(path):
    bad = [m for m in _imports(path)
           if m.split(".")[0] in ("jax", "jaxlib", "repro")]
    assert not bad, f"{path} imports {bad}"


def test_port_covers_the_slice_modules():
    port = REPO / "src" / "repro_torch"
    for rel in ("core/kernels_fn.py", "core/sketch.py", "core/kmeans.py",
                "core/metrics.py", "kernels/_build.py",
                "kernels/registry.py", "serve/policy.py",
                "stream/accumulate.py", "api/backends.py",
                "serve/artifact.py", "serve/extend.py", "serve/batcher.py",
                "api/estimator.py", "data/synthetic.py"):
        assert (port / rel).is_file(), rel
    for name in ("gram", "kmeans_assign", "extend_embed", "fit_sketch"):
        assert (port / "kernels" / f"{name}" / "ops.py").is_file()
        assert (port / "kernels" / f"{name}" / "ref.py").is_file()
        assert (port / "kernels" / "csrc" / f"{name}.cu").is_file()


def test_estimator_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelKMeans()
    assert KernelKMeans(device="cpu").device.type == "cpu"


@pytest.mark.parametrize("name", sorted(OPS))
def test_wrapper_runs_plain_version_for_cpu_tensors(name):
    entry = registry.get_kernel(name)
    args, kw = entry.build(np.random.default_rng(0), entry.cases[0])
    targs = [torch.from_numpy(a) for a in args]
    reset_launches()
    got = entry.op(*targs, **kw)
    assert entry.op.launches == 0          # no kernel launched
    registry.compare(entry, got, entry.ref(*targs, **kw))


def test_wrapper_rejects_mixed_devices():
    X = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="one CUDA device"):
        OPS["gram_stripe"](X, torch.zeros((2, 3), device="meta"))
