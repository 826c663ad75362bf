"""distributed/tensor_parallel.py on the CPU.

- The head split: every query head on exactly one rank, rank 0 the most,
  and the KV heads a rank reads, for head counts that do and do not
  divide by the model axis.
- compute_specs on all ten full configs at the production meshes (no
  world): the dense, moe and vlm families compute each projection,
  expert weight and embedding in JAX's TP-only layout, their norms and
  routers replicated; the other families replicated; which attention
  weights a rank gathers (phi4-mini's 24 heads over 16 ranks).
- The vocab-parallel loss and lookup on gloo worlds of 2 and 4 ranks
  (this file run as a worker, one process a rank): the loss and the
  gradient of each rank's logits chunk against train/steps.py's
  cross_entropy on the whole logits; the lookup bit for bit against
  indexing the whole table, and the table's gradient.
"""
import datetime
import math
import os
import pathlib
import subprocess
import sys

import numpy as np
import pytest
import torch

from repro_torch.configs import ARCH_IDS, get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import (MeshShape, local_shape,
                                              param_pspecs)
from repro_torch.models import get_api

REPO = pathlib.Path(__file__).resolve().parents[1]
MESHES = {"16x16": (("data", "model"), (16, 16)),
          "2x16x16": (("pod", "data", "model"), (2, 16, 16))}
B, S, V, D = 3, 5, 64, 8


@pytest.mark.parametrize("heads,kv,tp", (
    (24, 8, 16), (40, 8, 16), (32, 8, 16), (96, 8, 16), (6, 2, 4),
    (6, 3, 4), (4, 2, 4), (7, 7, 3)))
def test_every_head_on_one_rank(heads, kv, tp):
    q_per_kv = heads // kv
    spans = [TP.head_span(heads, tp, r) for r in range(tp)]
    assert [h for a, b in spans for h in range(a, b)] == list(range(heads))
    assert max(b - a for a, b in spans) == spans[0][1] - spans[0][0] \
        == -(-heads // tp)
    for r, (a, b) in enumerate(spans):
        k0, k1 = TP.kv_span(heads, q_per_kv, tp, r)
        assert {h // q_per_kv for h in range(a, b)} == set(range(k0, k1))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCH_IDS)
def test_compute_specs(arch, mesh):
    cfg = get_config(arch)
    shape = MeshShape(*MESHES[mesh])
    model = get_api(cfg).init(cfg, 16, device="meta")
    got = TP.compute_specs(model, shape)
    tp_only = param_pspecs(model, shape, use_fsdp=False)
    assert got.keys() == tp_only.keys()
    cut = 0
    for name, p in model.named_parameters():
        if cfg.family in ("dense", "moe", "vlm"):
            assert got[name] == tp_only[name], name
        else:
            assert all(e is None for e in got[name]), name
        cut += tuple(local_shape(p.shape, got[name], shape)) != p.shape
    assert bool(cut) == (cfg.family in ("dense", "moe", "vlm"))
    assert TP.compute_bytes(model, shape) == sum(
        math.prod(local_shape(p.shape, got[name], shape)) * p.element_size()
        for name, p in model.named_parameters())


@pytest.mark.parametrize("arch,gathered", (
    ("phi4-mini-3.8b", {"wq", "wk", "wv", "wo"}),
    ("qwen3-14b", {"wq", "wk", "wv", "wo"}),
    ("mixtral-8x7b", {"wk", "wv"}),
    ("nemotron-4-340b", {"wk", "wv"}),
    ("command-r-plus-104b", {"wk", "wv"})))
def test_attention_gathers_at_16(arch, gathered):
    """A weight is gathered over the model axis where some rank's heads
    are not its chunk: wq when the heads do not divide by 16, wk / wv
    when there are fewer KV heads than ranks."""
    cfg = get_config(arch)
    spans = TP.attention_spans(cfg, 16)
    widths = {"wq": cfg.n_heads, "wk": cfg.n_kv_heads, "wv": cfg.n_kv_heads,
              "wo": cfg.n_heads}
    got = {n for n, w in widths.items()
           if TP.needs_gather(w * cfg.head_dim // 16, spans[n], 16)}
    assert got == gathered


def _inputs():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((B, S, V), generator=g) * 4
    labels = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    labels[0, :2] = -1
    table = torch.randn((V, D), generator=g)
    tokens = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    return logits, labels, table, tokens


def _worker(rank: int, world: int, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh, mesh_axis
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    axis = mesh_axis(make_debug_mesh(1, world, device="cpu"), "model")
    logits, labels, table, tokens = _inputs()
    n = V // world
    part = logits[..., rank * n:(rank + 1) * n].clone().requires_grad_()
    count = (labels >= 0).sum()
    loss = TP.cross_entropy(part, labels, count, axis)
    loss.backward()
    rows = table[rank * n:(rank + 1) * n].clone().requires_grad_()
    x = TP.embedding(rows, tokens, axis)
    (x * torch.arange(D)).sum().backward()
    np.savez(os.path.join(work, f"out_{rank}.npz"), loss=loss.detach(),
             dlogits=part.grad, x=x.detach(), drows=rows.grad)
    dist.destroy_process_group()


@pytest.mark.parametrize("world", (2, 4))
def test_vocab_parallel_loss_and_lookup(tmp_path, world):
    from repro_torch.train import cross_entropy
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, __file__, str(r), str(world),
                               str(tmp_path)], env=env)
             for r in range(world)]
    assert [p.wait(timeout=120) for p in procs] == [0] * world
    logits, labels, table, tokens = _inputs()
    logits.requires_grad_()
    want = cross_entropy(logits, labels)
    want.backward()
    whole = table.clone().requires_grad_()
    x = whole[tokens]
    (x * torch.arange(D)).sum().backward()
    n = V // world
    for r in range(world):
        out = np.load(tmp_path / f"out_{r}.npz")
        np.testing.assert_allclose(out["loss"], want.item(), rtol=1e-6)
        np.testing.assert_allclose(
            out["dlogits"], logits.grad[..., r * n:(r + 1) * n].numpy(),
            rtol=1e-5, atol=1e-8)
        assert np.array_equal(out["x"], x.detach().numpy())
        assert np.array_equal(out["drows"],
                              whole.grad[r * n:(r + 1) * n].numpy())


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
