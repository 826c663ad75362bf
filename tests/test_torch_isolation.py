"""The port stands alone: no jax, nothing of repro; the card by default."""
import ast
import pathlib

import numpy as np
import pytest
import torch

from repro_torch.api import KernelKMeans
from repro_torch.configs import get_config
from repro_torch.launch import serve, train
from repro_torch.models import LM, RG, RWKV, Whisper, get_api
from repro_torch.models.lm import init_cache_lm
from repro_torch.models.rglru import init_cache_rg
from repro_torch.models.rwkv6 import init_cache_rwkv
from repro_torch.models.whisper import init_cache_whisper
from repro_torch.kernels import OPS, registry, reset_launches
from repro_torch.train import init_train_state

REPO = pathlib.Path(__file__).resolve().parents[1]
PORT_FILES = sorted((REPO / "src" / "repro_torch").rglob("*.py")) + [
    REPO / "chip_smoke.py"] + sorted((REPO / "examples").glob("torch_*.py"))


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
                "api/estimator.py", "data/synthetic.py",
                "stream/minibatch.py", "distributed/checkpoint.py",
                "distributed/compression.py", "core/nystrom.py",
                "core/exact.py", "core/linearized.py", "core/onepass.py",
                "serve/latency.py", "serve/scheduler.py", "serve/versions.py",
                "serve/registry.py", "serve/bench.py", "stream/drift.py",
                "stream/retrain.py", "fleet/worker.py", "fleet/router.py",
                "fleet/admission.py", "fleet/controller.py",
                "fleet/rollout.py", "fleet/tier.py", "fleet/bench.py",
                "distributed/dfwht.py", "distributed/fit.py",
                "distributed/cluster.py", "distributed/fault.py",
                "launch/mesh.py", "launch/cluster.py",
                "launch/serve_cluster.py", "models/config.py",
                "models/layers.py", "models/lm.py", "models/rglru.py",
                "models/rwkv6.py", "models/whisper.py", "models/registry.py",
                "models/convert.py", "train/steps.py", "launch/specs.py",
                "launch/serve.py", "configs/__init__.py",
                "train/optimizer.py", "launch/train.py",
                "distributed/sharding.py", "launch/dryrun.py",
                "launch/op_analysis.py"):
        assert (port / rel).is_file(), rel
    for name in ("command_r_plus_104b", "dbrx_132b", "mixtral_8x7b",
                 "nemotron_4_340b", "phi4_mini_3_8b", "pixtral_12b",
                 "qwen3_14b", "recurrentgemma_2b", "rwkv6_1_6b",
                 "whisper_large_v3"):
        assert (port / "configs" / f"{name}.py").is_file(), name
    for name in ("quickstart", "serve_async", "stream_refit",
                 "distributed_clustering", "cluster_embeddings", "train_lm"):
        assert (REPO / "examples" / f"torch_{name}.py").is_file(), name
    for name in ("gram", "kmeans_assign", "extend_embed", "fit_sketch",
                 "fwht"):
        assert (port / "kernels" / f"{name}" / "ops.py").is_file()
        assert (port / "kernels" / f"{name}" / "ref.py").is_file()
        assert (port / "kernels" / "csrc" / f"{name}.cu").is_file()


def test_estimator_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        KernelKMeans()
    assert KernelKMeans(device="cpu").device.type == "cpu"


def test_lm_serving_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    assert serve.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit) as stop:
        serve.main([])                       # ap.error: exit 2, no CPU run
    assert stop.value.code == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        LM(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache_lm(cfg, 1, 8)
    assert LM(cfg, device="cpu").device.type == "cpu"


def test_hybrid_serving_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("recurrentgemma-2b", smoke=True)
    with pytest.raises(SystemExit) as stop:
        serve.main(["--arch", "recurrentgemma-2b"])   # exit 2, no CPU run
    assert stop.value.code == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RG(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache_rg(cfg, 1, 8)
    assert RG(cfg, device="cpu").device.type == "cpu"


def test_ssm_serving_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("rwkv6-1.6b", smoke=True)
    with pytest.raises(SystemExit) as stop:
        serve.main(["--arch", "rwkv6-1.6b"])          # exit 2, no CPU run
    assert stop.value.code == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        RWKV(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache_rwkv(cfg, 1, 8)
    assert RWKV(cfg, device="cpu").device.type == "cpu"


def test_encdec_serving_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("whisper-large-v3", smoke=True)
    with pytest.raises(SystemExit) as stop:
        serve.main(["--arch", "whisper-large-v3"])    # exit 2, no CPU run
    assert stop.value.code == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        Whisper(cfg)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_cache_whisper(cfg, 1, 8)
    assert Whisper(cfg, device="cpu").device.type == "cpu"


def test_training_defaults_to_the_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    cfg = get_config("phi4-mini-3.8b", smoke=True)
    api = get_api(cfg)
    assert train.build_parser().parse_args([]).device == "cuda"
    with pytest.raises(SystemExit) as stop:
        train.main(["--smoke"])              # ap.error: exit 2, no CPU run
    assert stop.value.code == 2
    with pytest.raises(RuntimeError, match="device='cpu'"):
        init_train_state(cfg, api, tp=1)
    state = init_train_state(cfg, api, tp=1, device="cpu")
    assert state.params.device.type == "cpu"
    assert state.opt["step"].device.type == "cpu"


@pytest.mark.parametrize("name", sorted(OPS))
def test_wrapper_runs_plain_version_for_cpu_tensors(name):
    entry = registry.get_kernel(name)
    args, kw = entry.build(np.random.default_rng(0), entry.cases[0])
    targs = [torch.from_numpy(a) for a in args]
    reset_launches()
    got = entry.op(*targs, **kw)
    assert entry.op.launches == 0          # no kernel launched
    registry.compare(entry, got, entry.ref(*targs, **kw), (targs, kw))


def test_wrapper_rejects_mixed_devices():
    X = torch.zeros((2, 4))
    with pytest.raises(ValueError, match="one CUDA device"):
        OPS["gram_stripe"](X, torch.zeros((2, 3), device="meta"))
