"""Tensor-parallel serving of the hybrid, ssm and encdec families on a
(data, model) mesh against repro.train's prefill and decode steps on the
CPU, over gloo worlds.

Six cases at the smoke configs, f32, JAX's init_rg / init_rwkv /
init_whisper weights (seed 0) carried into the port, prompts (and
whisper's audio frames) drawn with numpy: "rg" (recurrentgemma-2b, the
hybrid: R R A R R, 2 heads over 1 KV head of 32, window 32, a prompt of
40 into a cache of 64 positions: the ring branch of the attention's
prefill, and decode wraps on from there; at tp 4 ranks 1 and 3 hold no
head but hold lru channels), "rwkv" (rwkv6-1.6b, the ssm: 4 heads of
16), "whisper" (whisper-large-v3, the encdec: 4 heads of 16, 16 frames),
"whisper-h6" (6 heads of 16 at tp 4: rank 0 holds 2 heads, rank 1 one,
rank 2 two, rank 3 one), "rwkv-h2" (2 heads of 32 at tp 4: ranks 1 and 3
hold no head of the time mix) and "rg-b1" (batch 1, where every data
rank computes the row at groups 1). The first three run on the worlds
(data, model) = (1, 2), (2, 2) and (1, 4), rg-b1 at (2, 2), whisper-h6
and rwkv-h2 at (1, 4) (`tests/torch_serve_mesh_worker.py`, one process
a rank, each world spawned once for the module, one after another
within WORLD_DEADLINE while JAX computes its references).

Each rank cuts the model once (tensor_parallel.shard_for_serving), fills
its f32 cache with make_prefill_step(mesh=) on the global batch at
groups = the data axis's size where the batch splits over it (else 1),
then takes four greedy steps with make_decode_step(mesh=). Held to JAX's
jitted make_prefill_step / make_decode_step at the same groups with
tests/test_torch_lm.py's tolerances: every rank's logits of every row
within LOGIT_TOL after prefill and each step, its greedy tokens equal to
JAX's at every step, and every cache leaf within CACHE_TOL of JAX's at
the rank's rows and at its part (k / v / xk / xv its KV heads, s its
heads, h and conv its lru channels; tm and cm whole), after prefill and
after the last step; every weight and cache leaf at its serving shape.
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

from repro.configs import get_config as jax_config
from repro.models.registry import get_api as jax_api
from repro.train import steps as jsteps
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.models import get_api
from test_torch_lm import CACHE_TOL, LOGIT_TOL
from test_torch_serve_mesh import _frames, _groups, _ids, _prompt, _run_world
from torch_lm_common import cache_keys, jax_and_port

STEPS = 4
# case: (arch, config cut, batch, prompt, cache positions)
CASES = {
    "rg": ("recurrentgemma-2b", {}, 2, 40, 64),
    "rwkv": ("rwkv6-1.6b", {}, 2, 12, 32),
    "whisper": ("whisper-large-v3", {}, 2, 12, 32),
    "whisper-h6": ("whisper-large-v3", {"n_heads": 6, "n_kv_heads": 6,
                                        "head_dim": 16}, 2, 12, 32),
    "rwkv-h2": ("rwkv6-1.6b", {"rwkv_head_dim": 32}, 2, 12, 32),
    "rg-b1": ("recurrentgemma-2b", {}, 1, 40, 64),
}
WORLDS = ((1, 2), (2, 2), (1, 4))
PAIRS = tuple((w, c) for w in WORLDS for c in ("rg", "rwkv", "whisper")) + (
    ((1, 4), "whisper-h6"), ((1, 4), "rwkv-h2"), ((2, 2), "rg-b1"))
WORLD_DEADLINE = 240.0        # seconds for the three worlds, start to join


def _configs(case):
    arch, cut = CASES[case][:2]
    return (dataclasses.replace(jax_config(arch, True), **cut),
            dataclasses.replace(get_config(arch, True), **cut))


def _jax_serve(jcfg, params, batch, max_seq, groups):
    """JAX's jitted prefill and STEPS greedy decode steps: the logits,
    tokens and every cache leaf."""
    api = jax_api(jcfg)
    prefill = jax.jit(jsteps.make_prefill_step(jcfg, api, groups=groups))
    decode = jax.jit(jsteps.make_decode_step(jcfg, api, groups=groups))
    B = batch["tokens"].shape[0]
    cache = api.init_cache(jcfg, B, max_seq, jnp.float32)
    logits, cache = prefill(params, {k: jnp.asarray(v)
                                     for k, v in batch.items()}, cache)
    keys = cache_keys(jcfg)
    out = {"prefill/logits": np.asarray(logits),
           "prefill/pos": int(cache["pos"]),
           **{f"prefill/{k}": np.asarray(cache[k]) for k in keys}}
    t = jnp.argmax(logits, axis=-1).astype(jnp.int32)
    out["0/tokens"] = np.asarray(t)
    for i in range(1, STEPS + 1):
        t, logits, cache = decode(params, t, cache)
        out[f"{i}/tokens"] = np.asarray(t)
        out[f"{i}/logits"] = np.asarray(logits)
    out.update({f"decode/{k}": np.asarray(cache[k]) for k in keys})
    out["decode/pos"] = int(cache["pos"])
    return out


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The three worlds (run in a thread, one after another) and,
    meanwhile, JAX's references."""
    work = tmp_path_factory.mktemp("serve_mesh_families")
    inputs, cases, jax_in = {}, [], {}
    for case, (arch, cut, B, S, max_seq) in CASES.items():
        jcfg, pcfg = _configs(case)
        params, model = jax_and_port(jcfg, pcfg)
        for name, p in model.named_parameters():
            inputs[f"{case}/w/{name}"] = p.detach().numpy()
        batch = {"tokens": _prompt(pcfg, B, S)}
        if pcfg.family == "encdec":
            batch["frames"] = _frames(pcfg, B)
        inputs.update({f"{case}/{k}": v for k, v in batch.items()})
        cases.append({"case": case, "arch": arch, "cut": cut, "batch": B,
                      "max_seq": max_seq,
                      "worlds": [list(w) for w, c in PAIRS if c == case]})
        jax_in[case] = (jcfg, params, batch, max_seq)
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
        jcfg, params, batch, max_seq = jax_in[case]
        groups = _groups(data, batch["tokens"].shape[0])
        if (case, groups) not in refs:
            refs[(case, groups)] = _jax_serve(jcfg, params, batch, max_seq,
                                              groups)
    thread.join(timeout=max(1.0, deadline + 30 - time.monotonic()))
    if thread.is_alive() or failed:
        raise failed[0] if failed else AssertionError("the worlds hung")
    return {"worlds": worlds, "refs": refs}


def _ranks(world, case):
    """Per global rank: (its rows of the batch, its model-axis index)."""
    data, tp = world
    B = CASES[case][2]
    split = data > 1 and B % data == 0
    return [(slice(i * B // data, (i + 1) * B // data) if split
             else slice(None), m)
            for i, m in (divmod(r, tp) for r in range(data * tp))]


def _part(key, cfg, tp, m):
    """(the dim of cache leaf `key` that rank m of tp holds a part of,
    [a, b) along it), or None for a leaf held whole: k / v / xk / xv the
    KV heads its query heads read, s its time mix's heads, h and conv its
    chunk of the lru channels."""
    if key in ("k", "v", "xk", "xv"):
        return 3, TP.kv_span(cfg.n_heads, cfg.q_per_kv, tp, m)
    if key == "s":
        return 2, TP.head_span(cfg.d_model // cfg.rwkv_head_dim, tp, m)
    if key in ("h", "conv"):
        n = cfg.d_model // tp
        return (2 if key == "h" else 3), (m * n, (m + 1) * n)
    return None


def _rank_leaf(leaf, key, rows, cfg, tp, m):
    """JAX's whole cache leaf cut to what rank m holds, at `rows`."""
    leaf = leaf[:, rows]
    part = _part(key, cfg, tp, m)
    if part is None:
        return leaf
    dim, (a, b) = part
    return np.take(leaf, np.arange(a, b), axis=dim)


def _got(runs, world, case, r):
    return {k[len(case) + 1:]: v for k, v in runs["worlds"][world][r].items()
            if k.startswith(f"{case}/")}


def _ref(runs, world, case):
    return runs["refs"][(case, _groups(world[0], CASES[case][2]))]


def _hold_cache(got, want, rows, cfg, tp, m, when):
    for key in cache_keys(cfg):
        np.testing.assert_allclose(
            got[f"{when}/{key}"],
            _rank_leaf(want[f"{when}/{key}"], key, rows, cfg, tp, m),
            err_msg=f"{when} {key}", **CACHE_TOL)


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_mesh_prefill_matches_jax(runs, world, case):
    cfg = _configs(case)[1]
    want = _ref(runs, world, case)
    for r, (rows, m) in enumerate(_ranks(world, case)):
        got = _got(runs, world, case, r)
        np.testing.assert_allclose(got["prefill/logits"],
                                   want["prefill/logits"],
                                   err_msg=f"rank {r}", **LOGIT_TOL)
        assert int(got["prefill/pos"]) == want["prefill/pos"] \
            == CASES[case][3]
        _hold_cache(got, want, rows, cfg, world[1], m, "prefill")


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_mesh_greedy_decode_matches_jax(runs, world, case):
    cfg = _configs(case)[1]
    want = _ref(runs, world, case)
    for r, (rows, m) in enumerate(_ranks(world, case)):
        got = _got(runs, world, case, r)
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
        _hold_cache(got, want, rows, cfg, world[1], m, "decode")


# The weights each family's serving cut narrows (besides attention,
# cross-attention, MLP and vocabulary): the dim and whether the range is
# the rank's heads' channels (else its even chunk).
_RG = {"w_in": (1, False), "w_gate": (1, False), "conv_w": (1, False),
       "w_a": (1, False), "w_x": (1, False), "w_out": (0, False),
       "lam": (0, False)}
_RWKV = {"wr": (1, True), "wk": (1, True), "wv": (1, True),
         "wg": (1, True), "wb": (1, True), "wo": (0, True), "w0": (0, True),
         "u": (0, True), "ck": (1, False), "cr": (1, False),
         "cv": (0, False)}


def _serving_shape(name, shape, cfg, tp, m):
    """The shape rank m of tp holds (distributed/tensor_parallel.py's
    module docstring): attention and cross-attention at its heads and the
    KV heads they read; an RG-LRU block at its chunk of the lru
    channels, lam too; an RWKV time mix at its heads' channels (wa, the
    mu_* and ln_x whole), its channel mix at the even chunks; MLP and
    vocab weights at their even chunk; the rest whole."""
    hd, last = cfg.head_dim, name.split(".")[-1]
    shape = list(shape)
    attn = ".attn." in name or ".xattn." in name
    table = {"hybrid": _RG, "ssm": _RWKV}.get(cfg.family, {})
    if attn and last in ("wq", "wk", "wv", "wo"):
        h0, h1 = (TP.head_span(cfg.n_heads, tp, m) if last in ("wq", "wo")
                  else TP.kv_span(cfg.n_heads, cfg.q_per_kv, tp, m))
        shape[int(last != "wo")] = (h1 - h0) * hd
    elif not attn and ".mlp." not in name and last in table:
        dim, heads = table[last]
        if heads:
            dh = cfg.rwkv_head_dim
            h0, h1 = TP.head_span(cfg.d_model // dh, tp, m)
            shape[dim] = (h1 - h0) * dh
        else:
            shape[dim] //= tp
    elif name == "embed" or (".mlp." in name and last == "w2"):
        shape[-2] //= tp
    elif name == "unembed" or (".mlp." in name and last in ("w1", "w3")):
        shape[-1] //= tp
    return tuple(shape)


@pytest.mark.parametrize("world,case", PAIRS, ids=_ids)
def test_weights_and_cache_at_serving_shapes(runs, world, case):
    """Every weight after the cut and every cache leaf at the rank's
    serving shape (the smoke widths all divide, so every unit is cut);
    the norms, the mu_* vectors and the LoRA's wa whole; a rank with no
    head holds empty attention columns and no KV head of the cache."""
    cfg = _configs(case)[1]
    api = get_api(cfg)
    whole = api.init(cfg, 1, device="meta")
    _, tp = world
    B, max_seq = CASES[case][2], CASES[case][4]
    leaves = api.init_cache(cfg, B, max_seq, torch.float32, "meta")
    for r, (rows, m) in enumerate(_ranks(world, case)):
        out = runs["worlds"][world][r]
        for name, p in whole.named_parameters():
            assert tuple(out[f"{case}/shape/{name}"]) == _serving_shape(
                name, p.shape, cfg, tp, m), (r, name)
        for key in cache_keys(cfg):
            shape = list(leaves[key].shape)
            shape[1] = len(range(B)[rows])
            part = _part(key, cfg, tp, m)
            if part is not None:
                dim, (a, b) = part
                shape[dim] = b - a
            assert tuple(out[f"{case}/shape/cache/{key}"]) == tuple(
                shape), (r, key)
