"""distributed/tensor_parallel.py on the CPU.

- The head split: every query head on exactly one rank, rank 0 the most,
  and the KV heads a rank reads, for head counts that do and do not
  divide by the model axis, and for fewer heads than ranks (a rank with
  no query head reads no KV head).
- The serving cut (serve_cuts, serve_cache_shape) without a world:
  phi4-mini's and mixtral's spans at tp 16 (one KV head a rank), a rank
  with no head, JAX's divisibility guard.
- compute_specs on all ten full configs at the production meshes (no
  world): every family computes each projection, expert weight, RG-LRU
  and RWKV weight, cross-attention weight and embedding in JAX's TP-only
  layout, their norms, routers, lam, mu_*, w0 and u replicated; which
  attention weights a rank gathers (phi4-mini's 24 heads over 16 ranks).
- On gloo worlds of 2 and 4 ranks (this file run as a worker, one process
  a rank, each world spawned once for the module):
  - the vocab-parallel loss and lookup: the loss and the gradient of
    each rank's logits chunk against train/steps.py's cross_entropy on
    the whole logits; the lookup bit for bit against indexing the whole
    table, and the table's gradient;
  - blocks computed tensor-parallel on their TP-only shards against the
    whole block on the same weights: the output, the input's gradient
    and every parameter's gradient gathered whole, within BLOCK_TOL:
    recurrentgemma's smoke `RGLRUBlock` (lam and conv_w included);
    rwkv6's smoke `RWKVBlock` (ln_x's scale, the mu_* vectors, w0 and u
    included), and at 4 ranks with heads of 32 (2 heads: ranks 1 and 3
    hold none), plain and under remat; whisper's smoke `CrossAttention`
    with the encoder output's gradient (its K/V from `kv`, the output
    through `copy_to_model` as `Whisper.forward` passes it), and at 4
    ranks with 6 heads of 16 (1.5 heads a chunk: wq, wk, wv and wo
    gathered);
  - at 4 ranks, recurrentgemma's `Attention` (2 heads over 4 ranks: ranks
    1 and 3 hold no head) the same way, once as it is and once under
    remat (the backward replays the forward's collectives on every
    rank).
"""
import dataclasses
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
TP_FAMILIES = ("dense", "moe", "vlm", "hybrid", "ssm", "encdec")
# The blocks' f32 tolerance: the row-parallel sums over the model axis
# change the order of sums (measured: at most 6.2e-7 of the tensor's
# largest magnitude, on every rank and tensor).
BLOCK_TOL = {"rtol": 1e-5, "atol_of_max": 5e-6}
BLOCK_B, BLOCK_S = 2, 40          # 40 positions: past the smoke window 32


@pytest.mark.parametrize("heads,kv,tp", (
    (24, 8, 16), (40, 8, 16), (32, 8, 16), (96, 8, 16), (6, 2, 4),
    (6, 3, 4), (4, 2, 4), (7, 7, 3), (10, 1, 16), (2, 1, 4), (2, 2, 4)))
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
        if cfg.family in TP_FAMILIES:
            assert got[name] == tp_only[name], name
        else:
            assert all(e is None for e in got[name]), name
        cut += tuple(local_shape(p.shape, got[name], shape)) != p.shape
    assert bool(cut) == (cfg.family in TP_FAMILIES)
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


SERVE_16 = MeshShape(("data", "model"), (16, 16))


@pytest.mark.parametrize("arch", ("phi4-mini-3.8b", "mixtral-8x7b"))
def test_serving_cut_at_16(arch):
    """serve_cuts at tp 16 for every model-axis rank: each attention's
    wq / wo at the rank's heads (phi4-mini's 24 heads: 2 or 1 a rank;
    mixtral's 32: 2), wk / wv at the one KV head they read, every head
    on one rank; the MLP, expert and vocab weights at the even chunk of
    JAX's TP-only spec; norms and the router whole. Each rank's cache
    holds its one KV head and its rows of the batch."""
    cfg = get_config(arch)
    model = get_api(cfg).init(cfg, 16, device="meta")
    tp_only = param_pspecs(model, SERVE_16, use_fsdp=False)
    hd, heads = cfg.head_dim, []
    for r in range(16):
        cuts = TP.serve_cuts(model, SERVE_16, r)
        h0, h1 = TP.head_span(cfg.n_heads, 16, r)
        k0, k1 = TP.kv_span(cfg.n_heads, cfg.q_per_kv, 16, r)
        assert k1 - k0 == 1 and h1 - h0 in (1, 2)
        heads += range(h0, h1)
        for name, p in model.named_parameters():
            last = name.split(".")[-1]
            if ".attn." in name and last in ("wq", "wo"):
                assert cuts[name] == (int(last == "wq"), h0 * hd, h1 * hd)
            elif ".attn." in name and last in ("wk", "wv"):
                assert cuts[name] == (1, k0 * hd, k1 * hd)
            elif any(tp_only[name]):
                dim = next(d for d, e in enumerate(tp_only[name]) if e)
                n = p.shape[dim] // 16
                assert cuts[name] == (dim, r * n, (r + 1) * n), name
            else:
                assert name not in cuts, name
        assert TP.serve_cache_shape(cuts, (cfg.n_layers, 128, 32768,
                                           cfg.n_kv_heads, hd),
                                    SERVE_16) == (cfg.n_layers, 8,
                                                  32768, 1, hd)
    assert heads == list(range(cfg.n_heads))
    assert {"embed", "unembed", "layers.0.mlp.w1", "layers.0.mlp.w2"} <= \
        set(cuts)
    assert "layers.0.mlp.router" not in cuts


def test_serving_cut_with_ranks_that_hold_no_head():
    """10 heads over 2 KV heads at tp 16 (recurrentgemma-2b's head count
    in a dense LM): six ranks hold no query head, their wq / wk / wv
    columns and wo rows empty and their cache without a KV head; a batch
    of 1 is not split over the data axis."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=1,
                              n_heads=10, n_kv_heads=2)
    model = get_api(cfg).init(cfg, 16, device="meta")
    empty = 0
    for r in range(16):
        cuts = TP.serve_cuts(model, SERVE_16, r)
        h0, h1 = TP.head_span(10, 16, r)
        shape = TP.serve_cache_shape(cuts, (1, 1, 64, 2, 128), SERVE_16)
        if h0 == h1:
            empty += 1
            for n in ("wq", "wk", "wv", "wo"):
                _, a, b = cuts[f"layers.0.attn.{n}"]
                assert a == b, n
            assert shape == (1, 1, 64, 0, 128)
        else:
            assert shape == (1, 1, 64, 1, 128)
    assert empty == 6


def test_serving_cut_keeps_jax_divisibility_guard():
    """An attention whose KV width does not divide by the model axis
    (JAX leaves wk / wv replicated) is held whole, its cache keeps every
    KV head; the MLP and vocab are still cut. A model axis of 1 cuts
    nothing."""
    cfg = dataclasses.replace(get_config("phi4-mini-3.8b"), n_layers=1,
                              n_kv_heads=1, head_dim=8, n_heads=8)
    model = get_api(cfg).init(cfg, 16, device="meta")
    cuts = TP.serve_cuts(model, SERVE_16, 3)
    assert not any(".attn." in n for n in cuts)
    assert {"embed", "unembed", "layers.0.mlp.w1"} <= set(cuts)
    assert TP.serve_cache_shape(cuts, (1, 32, 64, 1, 8), SERVE_16) == (
        1, 2, 64, 1, 8)
    assert TP.serve_cuts(model, MeshShape(("data", "model"), (4, 1)),
                         0) == {}


def _inputs():
    g = torch.Generator().manual_seed(3)
    logits = torch.randn((B, S, V), generator=g) * 4
    labels = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    labels[0, :2] = -1
    table = torch.randn((V, D), generator=g)
    tokens = torch.randint(0, V, (B, S), generator=g, dtype=torch.int32)
    return logits, labels, table, tokens


# Block cases: {case: (arch, config cut, module path, the worlds and
# remat settings it runs at)}.
BLOCKS = {
    "rglru": ("recurrentgemma-2b", {"n_layers": 3}, "layers.0",
              ((2, False), (4, False))),
    "attn": ("recurrentgemma-2b", {"n_layers": 3}, "layers.2.attn",
             ((4, False), (4, True))),
    "rwkv": ("rwkv6-1.6b", {"n_layers": 1}, "layers.0",
             ((2, False), (4, False))),
    "rwkv-h2": ("rwkv6-1.6b", {"n_layers": 1, "rwkv_head_dim": 32},
                "layers.0", ((4, False), (4, True))),
    "xattn": ("whisper-large-v3", {"n_layers": 1, "n_encoder_layers": 1},
              "dec_layers.0.xattn", ((2, False), (4, False))),
    "xattn-h6": ("whisper-large-v3", {"n_layers": 1, "n_encoder_layers": 1,
                                      "n_heads": 6, "n_kv_heads": 6,
                                      "head_dim": 16},
                 "dec_layers.0.xattn", ((4, False),)),
}


def _blocks(case):
    """The smoke model of `case` cut as BLOCKS says, drawn from a seed;
    the module under test, its prefix in the model, its input, the
    weights its output is summed with, and (cross-attention) the encoder
    output."""
    arch, cut, prefix, _ = BLOCKS[case]
    cfg = dataclasses.replace(get_config(arch, smoke=True), **cut)
    g = torch.Generator().manual_seed(11)
    model = get_api(cfg).init(cfg, 1, device="cpu", generator=g)
    mod = model.get_submodule(prefix)
    x = torch.randn((BLOCK_B, BLOCK_S, cfg.d_model), generator=g)
    w = torch.randn((BLOCK_B, BLOCK_S, cfg.d_model), generator=g)
    enc = torch.randn((BLOCK_B, cfg.n_audio_frames, cfg.d_model),
                      generator=g)
    return cfg, model, prefix, mod, x, w, enc


def _run_block(cfg, case, mod, x, w, enc, remat=False):
    """(output, the input's gradient, the encoder output's gradient or
    None, {parameter: gradient}) of sum(mod(x) * w), under remat's
    checkpoint when asked; the cross-attention over `kv(enc)`, enc passed
    through copy_to_model where the module computes tensor-parallel (as
    Whisper.forward passes it)."""
    from repro_torch.models import layers as L
    x = x.clone().requires_grad_()
    enc = enc.clone().requires_grad_()
    for p in mod.parameters():
        p.grad = None
    rcfg = dataclasses.replace(cfg, remat=remat)
    if case.startswith("xattn"):
        axis = mod.tp_axis()
        e = TP.copy_to_model(enc, axis) if axis is not None else enc
        y = L.remat(rcfg, lambda x, e: mod(x, *mod.kv(e)), x, e)
    else:
        args = {"window": cfg.window} if case == "attn" else {}
        y = L.remat(rcfg, mod, x, **args)
    (y * w).sum().backward()
    return y.detach(), x.grad, enc.grad, {n: p.grad for n, p in
                                          mod.named_parameters()}


def _key(case, remat):
    return f"{case}{'_remat' if remat else ''}"


def _block_worker(world, mesh, axis, out):
    from repro_torch.distributed.sharding import gather, local_shard
    for case, (_, _, _, runs) in BLOCKS.items():
        for remat in (r for n, r in runs if n == world):
            cfg, model, prefix, mod, x, w, enc = _blocks(case)
            spec_of = TP.compute_specs(model, mesh)
            spec = {n: spec_of[f"{prefix}.{n}"]
                    for n, _ in mod.named_parameters()}
            with torch.no_grad():
                for pname, p in mod.named_parameters():
                    p.data = local_shard(p.data.clone(), spec[pname], mesh)
            with TP.tensor_parallel(axis):
                y, dx, denc, grads = _run_block(cfg, case, mod, x, w, enc,
                                                remat)
            key = _key(case, remat)
            out[f"{key}/y"], out[f"{key}/dx"] = y, dx
            if denc is not None:
                out[f"{key}/denc"] = denc
            for pname, p in mod.named_parameters():
                out[f"{key}/shape/{pname}"] = np.asarray(p.shape)
                out[f"{key}/d/{pname}"] = gather(grads[pname], spec[pname],
                                                 mesh)


def _worker(rank: int, world: int, work: str) -> None:
    import torch.distributed as dist
    from repro_torch.launch.mesh import make_debug_mesh, mesh_axis
    torch.set_num_threads(1)
    dist.init_process_group(
        "gloo", store=dist.FileStore(os.path.join(work, "store"), world),
        rank=rank, world_size=world, timeout=datetime.timedelta(seconds=60))
    mesh = make_debug_mesh(1, world, device="cpu")
    axis = mesh_axis(mesh, "model")
    logits, labels, table, tokens = _inputs()
    n = V // world
    part = logits[..., rank * n:(rank + 1) * n].clone().requires_grad_()
    count = (labels >= 0).sum()
    loss = TP.cross_entropy(part, labels, count, axis)
    loss.backward()
    rows = table[rank * n:(rank + 1) * n].clone().requires_grad_()
    x = TP.embedding(rows, tokens, axis)
    (x * torch.arange(D)).sum().backward()
    out = {"loss": loss.detach(), "dlogits": part.grad, "x": x.detach(),
           "drows": rows.grad}
    _block_worker(world, mesh, axis, out)
    np.savez(os.path.join(work, f"out_{rank}.npz"),
             **{k: np.asarray(v) for k, v in out.items()})
    dist.destroy_process_group()


@pytest.fixture(scope="module")
def worlds(tmp_path_factory):
    """Each world's ranks' outputs, {world: [out of rank r]}: the worlds
    of 2 and 4 ranks run together."""
    env = {**os.environ, "PYTHONPATH": str(REPO / "src"),
           "OMP_NUM_THREADS": "1"}
    runs = {}
    for world in (2, 4):
        work = tmp_path_factory.mktemp(f"tp{world}")
        runs[world] = (work, [subprocess.Popen(
            [sys.executable, __file__, str(r), str(world), str(work)],
            env=env) for r in range(world)])
    out = {}
    for world, (work, procs) in runs.items():
        assert [p.wait(timeout=180) for p in procs] == [0] * world
        out[world] = [dict(np.load(work / f"out_{r}.npz"))
                      for r in range(world)]
    return out


@pytest.mark.parametrize("world", (2, 4))
def test_vocab_parallel_loss_and_lookup(worlds, world):
    from repro_torch.train import cross_entropy
    logits, labels, table, tokens = _inputs()
    logits.requires_grad_()
    want = cross_entropy(logits, labels)
    want.backward()
    whole = table.clone().requires_grad_()
    x = whole[tokens]
    (x * torch.arange(D)).sum().backward()
    n = V // world
    for r in range(world):
        out = worlds[world][r]
        np.testing.assert_allclose(out["loss"], want.item(), rtol=1e-6)
        np.testing.assert_allclose(
            out["dlogits"], logits.grad[..., r * n:(r + 1) * n].numpy(),
            rtol=1e-5, atol=1e-8)
        assert np.array_equal(out["x"], x.detach().numpy())
        assert np.array_equal(out["drows"],
                              whole.grad[r * n:(r + 1) * n].numpy())


def _close(got, want, what):
    want = want.numpy()
    np.testing.assert_allclose(
        got, want, rtol=BLOCK_TOL["rtol"],
        atol=BLOCK_TOL["atol_of_max"] * float(np.abs(want).max()),
        err_msg=what)


def _hold_block(worlds, world, case, remat):
    """Every rank's output, input gradient and (cross-attention) encoder
    output gradient, and the parameters' gradients gathered whole,
    against the whole module's; each weight a rank held was its chunk
    under JAX's TP-only spec."""
    cfg, model, prefix, mod, x, w, enc = _blocks(case)
    y, dx, denc, grads = _run_block(cfg, case, mod, x, w, enc, remat)
    key = _key(case, remat)
    assert (f"{key}/denc" in worlds[world][0]) == case.startswith("xattn")
    mesh = MeshShape(("data", "model"), (1, world))
    spec = param_pspecs(model, mesh, use_fsdp=False)
    cut = 0
    for r in range(world):
        out = worlds[world][r]
        _close(out[f"{key}/y"], y, f"rank {r} output")
        _close(out[f"{key}/dx"], dx, f"rank {r} input gradient")
        if denc is not None:
            _close(out[f"{key}/denc"], denc,
                   f"rank {r} encoder output gradient")
        for pname, p in mod.named_parameters():
            want = tuple(local_shape(p.shape, spec[f"{prefix}.{pname}"],
                                     mesh))
            assert tuple(out[f"{key}/shape/{pname}"]) == want, pname
            cut += want != tuple(p.shape)
            _close(out[f"{key}/d/{pname}"], grads[pname],
                   f"rank {r} gradient of {pname}")
    assert cut


@pytest.mark.parametrize("world", (2, 4))
def test_rglru_block_tensor_parallel(worlds, world):
    _hold_block(worlds, world, "rglru", False)


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_attention_with_ranks_that_hold_no_head(worlds, remat):
    """2 heads over 4 ranks: ranks 1 and 3 hold no query head and no KV
    head, add zeros after wo and make every collective the others make
    (a rank that skipped one would hang the world)."""
    assert [TP.head_span(2, 4, r) for r in range(4)] == [
        (0, 1), (1, 1), (1, 2), (2, 2)]
    assert [TP.kv_span(2, 2, 4, r) for r in range(4)] == [
        (0, 1), (0, 0), (0, 1), (1, 1)]
    _hold_block(worlds, 4, "attn", remat)


@pytest.mark.parametrize("world", (2, 4))
def test_rwkv_block_tensor_parallel(worlds, world):
    """rwkv6's smoke block, 4 heads of 16: 2 or 1 a rank, each rank's
    heads its chunk of wr / wk / wv / wg / wo (no gather); ln_x's sum of
    squares summed over the axis, the decay LoRA's gather, the channel
    mix's reduce-scatter and gather."""
    _hold_block(worlds, world, "rwkv", False)


@pytest.mark.parametrize("remat", (False, True), ids=("plain", "remat"))
def test_rwkv_block_with_ranks_that_hold_no_head(worlds, remat):
    """Heads of 32, 2 over 4 ranks: ranks 1 and 3 hold none, their heads'
    columns are not their chunks (wr ... wo gathered), and their ln_x
    sum of squares is 0; every rank makes every collective, in remat's
    replay too."""
    assert [TP.head_span(2, 4, r) for r in range(4)] == [
        (0, 1), (1, 1), (1, 2), (2, 2)]
    _hold_block(worlds, 4, "rwkv-h2", remat)


@pytest.mark.parametrize("world,case", ((2, "xattn"), (4, "xattn"),
                                        (4, "xattn-h6")),
                         ids=("2", "4", "4-h6"))
def test_cross_attention_tensor_parallel(worlds, world, case):
    """whisper's cross-attention: K / V of the rank's heads from the
    encoder output, whose gradient each rank sums over the axis; with 6
    heads over 4 ranks (1.5 a chunk) the rank's heads are not its chunks
    of the weights."""
    _hold_block(worlds, world, case, False)


if __name__ == "__main__":
    _worker(int(sys.argv[1]), int(sys.argv[2]), sys.argv[3])
