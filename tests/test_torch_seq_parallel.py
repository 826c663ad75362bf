"""Sequence parallelism over the model axis (JAX's seq_shard_acts:
sharding.activation_sharding(seq_axis="model", seq_div=tp), the switch
tensor_parallel's `stream` reads) for every family's tensor-parallel
training step and prefill, on the CPU over gloo worlds.

- Training: the smoke configs phi4-mini-3.8b (M 1; "phi4-m2" at M 2 with
  remat; "phi4-h6" with 6 query heads over 2 KV heads of width 16),
  mixtral-8x7b, recurrentgemma-2b, rwkv6-1.6b and whisper-large-v3 at
  its 16 frames, with JAX's weights (seed 0) and JAX's batch
  (PRNGKey(1), 4 rows a microbatch, S 16), train 3 steps with the switch
  on at the launcher's lr on the worlds (data, model) = (1, 2), (2, 2)
  and (1, 4) (tests/torch_train_mesh_worker.py, its cases alone); at
  (1, 4) also "whisper-f6", whisper at 6 frames, where the encoder's
  stream stays whole (6 % 4) and the decoder's is cut; pixtral-12b (the
  vlm: its 8 patch embeddings and 8 tokens cut as one stream of 16) at
  (1, 2) and (1, 4); and "phi4-rep" (d_ff 90, 5 heads of 10),
  "mixtral-rep" (d_ff 90) and "rwkv6-rep" (d_ff 98), whose attention,
  MLP, experts or channel mix JAX's divisibility guard leaves whole, so
  they compute replicated: gathered over S at entry and cut to the
  rank's rows at exit. Each step's loss, grad norm, parameters and both
  moments are held to JAX's jitted step with seq_shard_acts=True (its
  constraint changes no value) by tests/test_torch_train.py's F32
  tolerances and small-gradient rule, as tests/test_torch_train_mesh.py
  holds the switch off.
- At (1, 4), "phi4-s18" (S 18, which does not divide by 4) steps bit for
  bit as the same case with the switch off: the guard leaves the stream
  whole and every collective as it was.
- Serving: every family (phi4, mixtral, pixtral, recurrentgemma, rwkv6,
  whisper; the training case's JAX weights, prompts and frames drawn
  with numpy) prefills an f32 cache at B 2 through
  make_prefill_step(mesh=) and takes four greedy steps through
  make_decode_step(mesh=) on (1, 2) and (1, 4)
  (tests/torch_serve_mesh_worker.py) with the switch on, at a prompt
  length that divides by 4 and one that does not (12 and 11; 40 and 39
  for the hybrid and mixtral, past their window of 32). Where a stream
  is cut (the prompt that divides; whisper at both, its 16 frames
  dividing), the run is held to JAX's jitted prefill and decode
  (seq_shard_acts=True) as tests/test_torch_serve_mesh_families.py holds
  the switch off: every rank's logits within tests/test_torch_lm.py's
  LOGIT_TOL, its greedy tokens equal, its cache leaves at its part
  within CACHE_TOL. Where none is, the case also runs with the switch
  off and the two are held bit for bit, the decode steps' S = 1
  included.
- A world of one rank (made in this process) inside the switch steps
  bit for bit as the meshless step for every training case, and
  prefills and decodes bit for bit as the meshless steps for the hybrid
  and the encdec.
"""
import contextlib
import dataclasses
import json
import threading
import time

import jax
import numpy as np
import pytest
import torch
import torch.distributed as dist

from repro.configs import get_config as jax_config
from repro.launch import specs as jspecs
from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import activation_sharding
from repro_torch.launch.mesh import make_debug_mesh
from repro_torch.models import get_api
from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                               make_decode_step, make_prefill_step,
                               make_train_step, shard_train_state)
from test_torch_lm import LOGIT_TOL
from test_torch_serve_mesh import _frames, _prompt
from test_torch_serve_mesh_families import STEPS as SERVE_STEPS
from test_torch_serve_mesh_families import _hold_cache, _jax_serve
from test_torch_train import LR
from test_torch_train_mesh import STEPS, _hold_case, _jax_steps, _small_masks
from torch_lm_common import jax_and_port, port_of
import torch_worlds

WORLDS = ((1, 2), (2, 2), (1, 4))
SERVE_WORLDS = ((1, 2), (1, 4))
WORLD_DEADLINE = 240.0       # seconds for all five worlds, start to join
# case: (arch, config cut, sequence length)
TRAIN = {"phi4": ("phi4-mini-3.8b", {}, 16),
         "phi4-m2": ("phi4-mini-3.8b", {"microbatches": 2, "remat": True},
                     16),
         "phi4-h6": ("phi4-mini-3.8b", {"n_heads": 6, "n_kv_heads": 2,
                                        "head_dim": 16}, 16),
         "mixtral": ("mixtral-8x7b", {}, 16),
         "recurrentgemma": ("recurrentgemma-2b", {}, 16),
         "rwkv6": ("rwkv6-1.6b", {}, 16),
         "whisper": ("whisper-large-v3", {}, 16),
         "whisper-f6": ("whisper-large-v3", {"n_audio_frames": 6}, 16),
         "pixtral": ("pixtral-12b", {}, 16),
         # Widths that do not divide by 4: each unit computes replicated.
         "phi4-rep": ("phi4-mini-3.8b", {"d_ff": 90, "n_heads": 5,
                                         "n_kv_heads": 5, "head_dim": 10},
                      16),
         "mixtral-rep": ("mixtral-8x7b", {"d_ff": 90}, 16),
         "rwkv6-rep": ("rwkv6-1.6b", {"d_ff": 98}, 16),
         "phi4-s18": ("phi4-mini-3.8b", {}, 18)}
MOE = {"mixtral", "mixtral-rep"}
TRAIN_PAIRS = tuple((w, c) for w in WORLDS for c in tuple(TRAIN)[:7]) + tuple(
    ((1, 4), c) for c in ("whisper-f6", "phi4-rep", "mixtral-rep",
                          "rwkv6-rep")) + (((1, 2), "pixtral"),
                                           ((1, 4), "pixtral"))
# case (a TRAIN case, whose config and weights it serves): (arch, prompt
# lengths (one divides by 4, one does not), cache positions)
SERVE = {"phi4": ("phi4-mini-3.8b", (12, 11), 32),
         "mixtral": ("mixtral-8x7b", (40, 39), 64),
         "pixtral": ("pixtral-12b", (12, 11), 32),
         "recurrentgemma": ("recurrentgemma-2b", (40, 39), 64),
         "rwkv6": ("rwkv6-1.6b", (12, 11), 32),
         "whisper": ("whisper-large-v3", (12, 11), 32)}
SERVE_B = 2
# The serving cases no stream of which is cut on either world: the prompt
# divides by neither 2 nor 4 (whisper's 16 frames do, so its encoder is
# always cut). Only these also run with the switch off.
UNCUT = tuple((c, SERVE[c][1][1]) for c in SERVE if c != "whisper")


def _configs(case):
    arch, cut, _ = TRAIN[case]
    return (dataclasses.replace(jax_config(arch, True), seq_shard_acts=True,
                                **cut),
            dataclasses.replace(get_config(arch, True), seq_shard_acts=True,
                                **cut))


def _batch(jcfg, S):
    """JAX's batch of 4 rows a microbatch at S, and the same as tensors."""
    jb = jspecs.train_inputs(jcfg, S, 4 * jcfg.microbatches, concrete=True,
                             key=jax.random.PRNGKey(1))
    return jb, {k: torch.from_numpy(np.array(v)) for k, v in jb.items()}


def _spawn(work, worker, data, tp, deadline, *extra):
    """One world of `worker`'s ranks, started together and joined; the
    world's directory."""
    wdir = work / f"{worker}_{data}x{tp}"
    torch_worlds.link(work / worker, wdir, ("inputs.npz", "cases.json"))
    torch_worlds.run(wdir, f"torch_{worker}_worker.py",
                     [[r, data, tp, wdir, *extra] for r in range(data * tp)],
                     f"{worker} ({data}, {tp})", deadline)
    return wdir


def _serve_name(case, S, seq):
    return f"{case}-{S}-{'on' if seq else 'off'}"


def _write_inputs(work):
    """inputs.npz and cases.json of both workers; JAX's inputs of the
    training cases and of the serving cases where a stream is cut (a
    serving case takes the weights of the training case of its name)."""
    inputs, cases, jax_in, made = {}, [], {}, {}
    for case, (arch, cut, S) in TRAIN.items():
        jcfg, pcfg = _configs(case)
        params, model = made[case] = jax_and_port(jcfg, pcfg)
        jb, pb = _batch(jcfg, S)
        worlds = ([[1, 4]] if case == "phi4-s18" else
                  [list(w) for w, c in TRAIN_PAIRS if c == case])
        names = ((case, True), (f"{case}-off", False)) \
            if case == "phi4-s18" else ((case, True),)
        for name, seq in names:
            for pname, p in model.named_parameters():
                inputs[f"{name}/w/{pname}"] = p.detach().numpy()
            for k, v in pb.items():
                inputs[f"{name}/b/{k}"] = v.numpy()
            cases.append({"case": name, "arch": arch, "cut": cut,
                          "seq": seq, "worlds": worlds})
        jax_in[case] = (jcfg, pcfg, params, jb, pb)
    (work / "train_mesh").mkdir()
    np.savez(work / "train_mesh" / "inputs.npz", **inputs)
    (work / "train_mesh" / "cases.json").write_text(json.dumps(cases))
    inputs, cases, serve_in = {}, [], {}
    for case, (arch, lengths, max_seq) in SERVE.items():
        jcfg, cfg = _configs(case)
        assert TRAIN[case][:2] == (arch, {})
        params, model = made[case]
        for S in lengths:
            batch = {"tokens": _prompt(cfg, SERVE_B, S)}
            if cfg.family == "encdec":
                batch["frames"] = _frames(cfg, SERVE_B)
            for seq in (True, False)[:1 + ((case, S) in UNCUT)]:
                name = _serve_name(case, S, seq)
                for pname, p in model.named_parameters():
                    inputs[f"{name}/w/{pname}"] = p.detach().numpy()
                inputs.update({f"{name}/{k}": v for k, v in batch.items()})
                cases.append({"case": name, "arch": arch, "cut": {},
                              "seq": seq, "batch": SERVE_B,
                              "max_seq": max_seq,
                              "worlds": [list(w) for w in SERVE_WORLDS]})
            if (case, S) not in UNCUT:
                serve_in[(case, S)] = (jcfg, params, batch, max_seq)
    (work / "serve_mesh").mkdir()
    np.savez(work / "serve_mesh" / "inputs.npz", **inputs)
    (work / "serve_mesh" / "cases.json").write_text(json.dumps(cases))
    return jax_in, serve_in


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """The training worlds, then the serving worlds (in a thread, one
    after another) and, meanwhile, JAX's references and the
    small-gradient masks."""
    work = tmp_path_factory.mktemp("seq_parallel")
    jax_in, serve_in = _write_inputs(work)
    train, serve, failed = {}, {}, []
    deadline = time.monotonic() + WORLD_DEADLINE

    def spawn_all():
        try:
            for data, tp in WORLDS:
                wdir = _spawn(work, "train_mesh", data, tp, deadline,
                              "cases")
                train[(data, tp)] = dict(np.load(wdir / "out.npz"))
            for data, tp in SERVE_WORLDS:
                wdir = _spawn(work, "serve_mesh", data, tp, deadline)
                serve[(data, tp)] = [dict(np.load(wdir / f"out_{r}.npz"))
                                     for r in range(data * tp)]
        except AssertionError as exc:
            failed.append(exc)

    thread = threading.Thread(target=spawn_all, daemon=True)
    thread.start()
    refs = {}
    for (data, _), case in TRAIN_PAIRS:
        jcfg, pcfg, params, jb, pb = jax_in[case]
        groups = data if case in MOE else 1
        if (case, groups) not in refs:
            refs[(case, groups)] = (_jax_steps(jcfg, params, jb, groups),
                                    *_small_masks(pcfg, params, pb, groups))
    serve_refs = {key: _jax_serve(*args, groups=1)
                  for key, args in serve_in.items()}
    thread.join(timeout=max(1.0, deadline + 30 - time.monotonic()))
    if thread.is_alive() or failed:
        raise failed[0] if failed else AssertionError("the worlds hung")
    return {"train": train, "serve": serve, "refs": refs,
            "serve_refs": serve_refs}


def _ids(v):
    return f"{v[0]}x{v[1]}" if isinstance(v, tuple) else str(v)


@pytest.mark.parametrize("world,case", TRAIN_PAIRS, ids=_ids)
def test_sequence_parallel_step_matches_jax(runs, world, case):
    groups = world[0] if case in MOE else 1
    _hold_case(runs["train"][world], case, *runs["refs"][(case, groups)])


def test_stream_that_does_not_divide_steps_bit_for_bit(runs):
    """S 18 at tp 4: the switch on steps as it off, bit for bit."""
    out = runs["train"][(1, 4)]
    on = sorted(k for k in out if k.startswith("phi4-s18/"))
    assert len(on) > 3 * STEPS
    for key in on:
        off = "phi4-s18-off/" + key[len("phi4-s18/"):]
        if "/shape/" not in key:
            assert np.array_equal(out[key], out[off]), key


def _serve_got(out, case, S, seq):
    name = _serve_name(case, S, seq)
    return {k[len(name) + 1:]: v for k, v in out.items()
            if k.startswith(name + "/")}


@pytest.mark.parametrize("world,case,S", tuple(
    (w, c, S) for w in SERVE_WORLDS for c in SERVE for S in SERVE[c][1]
    if (c, S) not in UNCUT), ids=_ids)
def test_sequence_parallel_serving_matches_jax(runs, world, case, S):
    """Every rank's logits and greedy tokens with the switch on, after
    prefill and after each decode step, against JAX's jitted prefill and
    decode on the same weights, prompt and frames; its cache leaves at
    its part after prefill and after the last step."""
    cfg = _configs(case)[1]
    want = runs["serve_refs"][(case, S)]
    for r, out in enumerate(runs["serve"][world]):
        got = _serve_got(out, case, S, True)
        np.testing.assert_allclose(got["prefill/logits"],
                                   want["prefill/logits"],
                                   err_msg=f"rank {r}", **LOGIT_TOL)
        assert int(got["prefill/pos"]) == want["prefill/pos"] == S
        np.testing.assert_array_equal(got["0/tokens"], want["0/tokens"])
        for i in range(1, SERVE_STEPS + 1):
            what = f"rank {r} step {i}"
            np.testing.assert_array_equal(got[f"{i}/tokens"],
                                          want[f"{i}/tokens"], err_msg=what)
            np.testing.assert_allclose(got[f"{i}/logits"],
                                       want[f"{i}/logits"], err_msg=what,
                                       **LOGIT_TOL)
        assert int(got["decode/pos"]) == want["decode/pos"] \
            == S + SERVE_STEPS
        for when in ("prefill", "decode"):
            _hold_cache(got, want, slice(None), cfg, world[1], r, when)


@pytest.mark.parametrize("world,case,S", tuple(
    (w, c, S) for w in SERVE_WORLDS for c, S in UNCUT), ids=_ids)
def test_prompt_that_does_not_divide_serves_bit_for_bit(runs, world, case,
                                                        S):
    """Every rank's logits, greedy tokens, cache leaves and shapes with
    the switch on equal the same run off, bit for bit: the guard leaves
    the stream whole at prefill and at each decode step's S = 1."""
    for r, out in enumerate(runs["serve"][world]):
        on, off = (_serve_got(out, case, S, seq) for seq in (True, False))
        assert f"{SERVE_STEPS}/logits" in on and "prefill/pos" in on
        assert sorted(on) == sorted(off)
        for key in on:
            np.testing.assert_array_equal(on[key], off[key],
                                          err_msg=f"rank {r} {key}")


@pytest.fixture(scope="module")
def world1():
    """A gloo world of one rank in this process, destroyed after the
    module if this fixture made it."""
    made = not dist.is_initialized()
    mesh = make_debug_mesh(1, 1, device="cpu")
    yield mesh
    if made and dist.is_initialized():
        dist.destroy_process_group()


def _switch(mesh):
    """The switch as the dry run enters it at tp 1 around a mesh's step;
    nothing around the meshless one."""
    if mesh is None:
        return contextlib.nullcontext()
    return activation_sharding(("data",), seq_axis="model", seq_div=1)


@pytest.mark.parametrize("case", tuple(TRAIN)[:-1])
def test_world_of_one_inside_the_switch_is_the_meshless_step(world1, case):
    jcfg, pcfg = _configs(case)
    params = jax_and_port(jcfg, pcfg)[0]
    pb = _batch(jcfg, TRAIN[case][2])[1]
    api, opt = get_api(pcfg), AdamWConfig(lr=LR)
    states = [TrainState(m, adamw_init(dict(m.named_parameters()), opt))
              for m in (port_of(pcfg, params), port_of(pcfg, params))]
    states[1] = shard_train_state(states[1], world1)
    steps = [make_train_step(pcfg, api, opt_cfg=opt),
             make_train_step(pcfg, api, opt_cfg=opt, mesh=world1)]
    for i in range(STEPS):
        _, a = steps[0](states[0], pb)
        with _switch(world1):
            _, b = steps[1](states[1], pb)
        assert torch.equal(a["loss"], b["loss"]), i
        assert torch.equal(a["grad_norm"], b["grad_norm"]), i
    pa = dict(states[0].params.named_parameters())
    for name, p in states[1].params.named_parameters():
        assert torch.equal(p, pa[name]), name
        for key in ("m", "v"):
            assert torch.equal(states[1].opt[key][name],
                               states[0].opt[key][name]), (key, name)


@pytest.mark.parametrize("case", ("recurrentgemma", "whisper"))
def test_world_of_one_inside_the_switch_serves_as_meshless(world1, case):
    arch, lengths, max_seq = SERVE[case]
    cfg = get_config(arch, True)
    api = get_api(cfg)
    batch = {"tokens": torch.from_numpy(_prompt(cfg, SERVE_B, lengths[0]))}
    if cfg.family == "encdec":
        batch["frames"] = torch.from_numpy(_frames(cfg, SERVE_B))
    outs = []
    for mesh in (None, world1):
        model = api.init(cfg, 1, device="cpu",
                         generator=torch.Generator().manual_seed(0))
        if mesh is not None:
            TP.shard_for_serving(model, mesh)
            cache = TP.serve_cache(model, SERVE_B, max_seq, torch.float32)
        else:
            cache = model.init_cache(SERVE_B, max_seq, torch.float32)
        prefill = make_prefill_step(cfg, api, mesh=mesh)
        decode = make_decode_step(cfg, api, mesh=mesh)
        with _switch(mesh):
            logits, cache = prefill(model, batch, cache)
            got = [logits]
            tok = torch.argmax(logits, dim=-1).to(torch.int32)
            for _ in range(STEPS):
                tok, logits, cache = decode(model, tok, cache)
                got += [tok, logits]
        outs.append(got + [t for t in cache.values() if torch.is_tensor(t)])
    for a, b in zip(*outs):
        assert torch.equal(a, b)
