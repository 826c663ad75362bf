"""Tensor-parallel serving of the decoder-only LMs (dense, moe, vlm) on a
(data, model) mesh against repro.train's prefill and decode steps on the
CPU, over gloo worlds.

Eight cases at the smoke configs, f32, JAX's init_lm weights (seed 0)
carried into the port, prompts drawn with numpy: phi4-mini-3.8b (dense,
4 heads over 2 KV heads), mixtral-8x7b (moe, window 32, a prompt of 40
into a cache of 64 positions: prefill's ring branch, and decode wraps on
from there), qwen3-14b (qk_norm), pixtral-12b (vlm, text only, as JAX's
_vlm_api serves), "phi4-h6" (6 query heads over 2 KV heads of width 16:
at tp 4 rank 0 holds 2 heads, rank 1 one, and a KV head spans two
ranks), "phi4-h2" (2 heads over 1 KV head at tp 4: ranks 1 and 3 hold
no head), and phi4 and mixtral at batch 1 ("-b1"), where every data rank
computes all rows at groups 1. The first five run on the worlds (data,
model) = (1, 2), (2, 2) and (1, 4), the batch-1 cases at (2, 2), phi4-h2
at (1, 4) (`tests/torch_serve_mesh_worker.py`, one process a rank, each
world spawned once for the module, one after another within
WORLD_DEADLINE while JAX computes its references).

Each rank cuts the model once (tensor_parallel.shard_for_serving), fills
its f32 cache of its rows and KV heads with make_prefill_step(mesh=) on
the global prompt at groups = the data axis's size where the batch
splits over it (else 1), then takes four greedy steps with
make_decode_step(mesh=). Held to JAX's jitted make_prefill_step /
make_decode_step at the same groups with tests/test_torch_lm.py's
tolerances: every rank's logits of every row within LOGIT_TOL, its
greedy tokens equal to JAX's at every step, its cache within CACHE_TOL of
JAX's cache at the rank's rows and KV heads, after prefill and after the
last step; every weight and the cache at their serving shapes.

Also: on a gloo world of one rank made in this process, the mesh's
steps equal the meshless ones bit for bit for all ten configs (the
hybrid, ssm and encdec too; their gloo worlds are in
tests/test_torch_serve_mesh_families.py).
"""
import dataclasses
import json
import threading
import time

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import get_api
from repro_torch.train import make_decode_step, make_prefill_step
from test_torch_lm import CACHE_TOL, LOGIT_TOL
from torch_lm_common import SERVED, cache_keys, jax_and_port
import torch_worlds

STEPS = 4
# case: (arch, config cut, batch, prompt, cache positions)
CASES = {
    "phi4": ("phi4-mini-3.8b", {}, 2, 12, 32),
    "mixtral": ("mixtral-8x7b", {}, 2, 40, 64),
    "qwen3": ("qwen3-14b", {}, 2, 12, 32),
    "pixtral": ("pixtral-12b", {}, 2, 12, 32),
    "phi4-h6": ("phi4-mini-3.8b", {"n_heads": 6, "n_kv_heads": 2,
                                   "head_dim": 16}, 2, 12, 32),
    "phi4-h2": ("phi4-mini-3.8b", {"n_heads": 2, "n_kv_heads": 1,
                                   "head_dim": 16}, 2, 12, 32),
    "phi4-b1": ("phi4-mini-3.8b", {}, 1, 12, 32),
    "mixtral-b1": ("mixtral-8x7b", {}, 1, 40, 64),
}
WORLDS = ((1, 2), (2, 2), (1, 4))
PAIRS = tuple((w, c) for w in WORLDS for c in tuple(CASES)[:5]) + (
    ((2, 2), "phi4-b1"), ((2, 2), "mixtral-b1"), ((1, 4), "phi4-h2"))
WORLD_DEADLINE = 120.0        # seconds for the three worlds, start to join


def _configs(case):
    arch, cut = CASES[case][:2]
    return (dataclasses.replace(jax_config(arch, True), **cut),
            dataclasses.replace(get_config(arch, True), **cut))


def _prompt(cfg, B, S, seed=0):
    return np.random.default_rng(seed).integers(
        0, cfg.vocab_size, (B, S)).astype(np.int32)


def _frames(cfg, B, seed=1):
    """Whisper's audio frames (B, n_audio_frames, d), drawn with numpy."""
    return np.random.default_rng(seed).standard_normal(
        (B, cfg.n_audio_frames, cfg.d_model)).astype(np.float32)


def _groups(data, B):
    return data if B % data == 0 else 1


def _jax_serve(jcfg, params, tok, max_seq, groups):
    """JAX's jitted prefill and STEPS greedy decode steps."""
    api = jax_api(jcfg)
    prefill = jax.jit(jsteps.make_prefill_step(jcfg, api, groups=groups))
    decode = jax.jit(jsteps.make_decode_step(jcfg, api, groups=groups))
    cache = api.init_cache(jcfg, tok.shape[0], max_seq, jnp.float32)
    logits, cache = prefill(params, {"tokens": jnp.asarray(tok)}, cache)
    out = {"prefill/logits": np.asarray(logits),
           "prefill/k": np.asarray(cache["k"]),
           "prefill/v": np.asarray(cache["v"]),
           "prefill/pos": int(cache["pos"])}
    t = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out["0/tokens"] = np.asarray(t)
    for i in range(1, STEPS + 1):
        t, logits, cache = decode(params, t, cache)
        out[f"{i}/tokens"] = np.asarray(t)
        out[f"{i}/logits"] = np.asarray(logits)
    out.update({"decode/k": np.asarray(cache["k"]),
                "decode/v": np.asarray(cache["v"]),
                "decode/pos": int(cache["pos"])})
    return out


def _run_world(work, data, tp, deadline):
    """One world, its ranks started together and joined; each rank's
    out_RANK.npz."""
    world = data * tp
    wdir = work / f"world{data}x{tp}"
    torch_worlds.link(work, wdir, ("inputs.npz", "cases.json"))
    torch_worlds.run(wdir, "torch_serve_mesh_worker.py",
                     [[r, data, tp, wdir] for r in range(world)],
                     f"({data}, {tp})", deadline)
    return [dict(np.load(wdir / f"out_{r}.npz")) for r in range(world)]


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three worlds (run in a thread, one after another) and,
    meanwhile, JAX's references."""
    work = tmp_path_factory.mktemp("serve_mesh")
    inputs, cases, jax_in = {}, [], {}
    for case, (arch, cut, B, S, max_seq) in CASES.items():
        jcfg, pcfg = _configs(case)
        params, model = jax_and_port(jcfg, pcfg)
        for name, p in model.named_parameters():
            inputs[f"{case}/w/{name}"] = p.detach().numpy()
        tok = _prompt(pcfg, B, S)
        inputs[f"{case}/tokens"] = tok
        cases.append({"case": case, "arch": arch, "cut": cut, "batch": B,
                      "max_seq": max_seq,
                      "worlds": [list(w) for w, c in PAIRS if c == case]})
        jax_in[case] = (jcfg, params, tok, max_seq)
    np.savez(work / "inputs.npz", **inputs)
    (work / "cases.json").write_text(json.dumps(cases))
    worlds, failed = {}, []
    deadline = time.monotonic() + WORLD_DEADLINE

    def spawn_all():
        try:
            for data, tp in WORLDS:
                worlds[(data, tp)] = _run_world(work, data, tp, deadline)
        except AssertionError as exc:
            failed.append(exc)

    thread = threading.Thread(target=spawn_all, daemon=True)
    thread.start()
    refs = {}
    for (data, _), case in PAIRS:
        jcfg, params, tok, max_seq = jax_in[case]
        groups = _groups(data, tok.shape[0])
        if (case, groups) not in refs:
            refs[(case, groups)] = _jax_serve(jcfg, params, tok, max_seq,
                                              groups)
    thread.join(timeout=max(1.0, deadline + 30 - time.monotonic()))
    if thread.is_alive() or failed:
        raise failed[0] if failed else AssertionError("the worlds hung")
    return {"worlds": worlds, "refs": refs}


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else v


def _ranks(world, case):
    """Per global rank: (its rows of the batch, its model-axis index, its
    KV heads [k0, k1))."""
    data, tp = world
    cfg = _configs(case)[1]
    B = CASES[case][2]
    split = data > 1 and B % data == 0
    out = []
    for r in range(data * tp):
        i, m = divmod(r, tp)
        rows = slice(i * B // data, (i + 1) * B // data) if split \
            else slice(None)
        out.append((rows, m, TP.kv_span(cfg.n_heads, cfg.q_per_kv, tp, m)))
    return out


def _ref(runs, world, case):
    return runs["refs"][(case, _groups(world[0], CASES[case][2]))]


def _hold_cache(got, want, rows, kv, when):
    k0, k1 = kv
    for key in ("k", "v"):
        np.testing.assert_allclose(
            got[f"{when}/{key}"], want[f"{when}/{key}"][:, rows, :, k0:k1],
            err_msg=f"{when} {key}", **CACHE_TOL)


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_mesh_prefill_matches_jax(runs, world, case):
    want = _ref(runs, world, case)
    outs = runs["worlds"][world]
    for r, (rows, _, kv) in enumerate(_ranks(world, case)):
        got = {k[len(case) + 1:]: v for k, v in outs[r].items()
               if k.startswith(f"{case}/")}
        np.testing.assert_allclose(got["prefill/logits"],
                                   want["prefill/logits"],
                                   err_msg=f"rank {r}", **LOGIT_TOL)
        assert int(got["prefill/pos"]) == want["prefill/pos"] \
            == CASES[case][3]
        _hold_cache(got, want, rows, kv, "prefill")


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_mesh_greedy_decode_matches_jax(runs, world, case):
    want = _ref(runs, world, case)
    outs = runs["worlds"][world]
    for r, (rows, _, kv) in enumerate(_ranks(world, case)):
        got = {k[len(case) + 1:]: v for k, v in outs[r].items()
               if k.startswith(f"{case}/")}
        np.testing.assert_array_equal(got["0/tokens"], want["0/tokens"])
        for i in range(1, STEPS + 1):
            np.testing.assert_array_equal(got[f"{i}/tokens"],
                                          want[f"{i}/tokens"],
                                          err_msg=f"rank {r} step {i}")
            np.testing.assert_allclose(got[f"{i}/logits"],
                                       want[f"{i}/logits"],
                                       err_msg=f"rank {r} step {i}",
                                       **LOGIT_TOL)
        assert int(got["decode/pos"]) == want["decode/pos"] \
            == CASES[case][3] + STEPS
        _hold_cache(got, want, rows, kv, "decode")


def _serving_shape(name, shape, cfg, tp, m):
    """The shape rank m of tp holds (module docstring of
    distributed/tensor_parallel.py): attention at its heads and the KV
    heads they read, MLP, expert and vocab weights at their even chunk,
    the rest whole."""
    hd, last = cfg.head_dim, name.split(".")[-1]
    h0, h1 = TP.head_span(cfg.n_heads, tp, m)
    k0, k1 = TP.kv_span(cfg.n_heads, cfg.q_per_kv, tp, m)
    shape = list(shape)
    if ".attn." in name and last in ("wq", "wk", "wv"):
        shape[1] = ((h1 - h0) if last == "wq" else (k1 - k0)) * hd
    elif ".attn." in name and last == "wo":
        shape[0] = (h1 - h0) * hd
    elif name == "embed" or (".mlp." in name and last == "w2"):
        shape[-2] //= tp
    elif name == "unembed" or (".mlp." in name and last in ("w1", "w3")):
        shape[-1] //= tp
    return tuple(shape)


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_weights_and_cache_at_serving_shapes(runs, world, case):
    """Every weight after the cut, and the cache, at the rank's serving
    shape; the attention, MLP and vocab weights are cut (the smoke
    widths all divide; wk / wv stay whole where the rank reads every KV
    head), the norms and the router whole."""
    cfg = _configs(case)[1]
    whole = get_api(cfg).init(cfg, 1, device="meta")
    _, tp = world
    B, max_seq = CASES[case][2], CASES[case][4]
    T = min(max_seq, cfg.window) if cfg.attention == "sliding" else max_seq
    for r, (rows, m, (k0, k1)) in enumerate(_ranks(world, case)):
        out = runs["worlds"][world][r]
        cut = 0
        for name, p in whole.named_parameters():
            want = _serving_shape(name, p.shape, cfg, tp, m)
            assert tuple(out[f"{case}/shape/{name}"]) == want, (r, name)
            cut += want != tuple(p.shape)
        kv_cut = 2 if k1 - k0 < cfg.n_kv_heads else 0   # wk and wv
        mlp = 3 if cfg.activation in ("swiglu", "geglu") else 2
        assert cut == 2 + cfg.n_layers * (2 + kv_cut + mlp), r
        assert tuple(out[f"{case}/shape/cache/k"]) == (
            cfg.n_layers, len(range(B)[rows]), T, k1 - k0, cfg.head_dim), r


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one rank in this process, destroyed after the
    module if this fixture made it."""
    made = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1, device="cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


@pytest.mark.parametrize("arch", SERVED)
def test_world_of_one_is_the_meshless_step(world1, arch):
    """(1, 1): the mesh's prefill and greedy decode are the meshless
    steps' operations, bit for bit: logits, tokens and every cache leaf
    (k and v; the hybrid's h and conv, the ssm's s, tm and cm, whisper's
    xk and xv)."""
    jcfg, pcfg = jax_config(arch, True), get_config(arch, True)
    model = jax_and_port(jcfg, pcfg)[1]
    api = get_api(pcfg)
    batch = {"tokens": torch.from_numpy(_prompt(pcfg, 2, 12))}
    if pcfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(pcfg, 2))
    runs = []
    for mesh in (None, world1):
        if mesh is None:
            cache = api.init_cache(pcfg, 2, 32, torch.float32, "cpu")
        else:
            TP.shard_for_serving(model, mesh)
            cache = TP.serve_cache(model, 2, 32, torch.float32)
        prefill = make_prefill_step(pcfg, api, mesh=mesh)
        decode = make_decode_step(pcfg, api, mesh=mesh)
        logits, cache = prefill(model, batch, cache)
        out = [logits]
        t = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(STEPS):
            t, logits, cache = decode(model, t, cache)
            out += [t, logits]
        runs.append((out, cache))
    (a, ca), (b, cb) = runs
    for i, (x, y) in enumerate(zip(a, b)):
        assert torch.equal(x, y), i
    for key in cache_keys(pcfg):
        assert torch.equal(ca[key], cb[key]), key
    assert ca["pos"] == cb["pos"] == 12 + STEPS
    with pytest.raises(ValueError, match="needs the step's mesh"):
        make_prefill_step(pcfg, api)(model, batch, ca)
