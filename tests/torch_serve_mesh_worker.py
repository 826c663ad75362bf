"""One rank of a gloo world for tests/test_torch_serve_mesh.py and
tests/test_torch_serve_mesh_families.py.

    python tests/torch_serve_mesh_worker.py RANK DATA MODEL WORKDIR

WORKDIR holds `store` (the FileStore), `cases.json` (each case's arch,
config cut, batch, prompt, cache length and the worlds it runs on) and
`inputs.npz` (each case's weights by the port's parameter names, its
prompt and, for whisper, its audio frames). On the (DATA, MODEL) mesh
the rank cuts each of its cases' models for serving
(tensor_parallel.shard_for_serving), prefills its f32 cache from the
global batch through make_prefill_step(mesh=) at groups = DATA where the
batch splits over it (else 1), then takes STEPS greedy steps through
make_decode_step(mesh=); a case with "seq" true runs both inside
sharding.activation_sharding(seq_axis="model", seq_div=MODEL), JAX's
seq_shard_acts switch. It writes to `out_RANK.npz` each parameter's
shape after the cut, each cache leaf's shape, the logits, the greedy
tokens and every cache leaf after prefill and after the last step. No
JAX runs here and no check asserts here: the test compares.
"""
import dataclasses
import datetime
import json
import os
import sys

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.configs import get_config
from repro_torch.distributed import tensor_parallel as TP
from repro_torch.distributed.sharding import activation_sharding
from repro_torch.launch.mesh import (dp_axes, make_debug_mesh, open_world,
                                     run_process)
from repro_torch.models import get_api
from repro_torch.train import make_decode_step, make_prefill_step

STEPS = 4


def serve_case(mesh, data, inp, case, res):
    tp = mesh.shape[list(mesh.mesh_dim_names).index("model")]
    with activation_sharding(dp_axes(mesh), seq_div=tp,
                             seq_axis="model" if case.get("seq") else None):
        _serve_case(mesh, data, inp, case, res)


def _serve_case(mesh, data, inp, case, res):
    cfg = dataclasses.replace(get_config(case["arch"], smoke=True),
                              **case["cut"])
    api = get_api(cfg)
    model = api.init(cfg, 1, device="meta").to_empty(device="cpu")
    name = case["case"]
    with torch.no_grad():
        for pname, p in model.named_parameters():
            p.copy_(torch.from_numpy(inp[f"{name}/w/{pname}"]))
    TP.shard_for_serving(model, mesh)
    for pname, p in model.named_parameters():
        res[f"{name}/shape/{pname}"] = np.asarray(p.shape)
    B = case["batch"]
    groups = data if B % data == 0 else 1
    cache = TP.serve_cache(model, B, case["max_seq"], torch.float32)
    leaves = [key for key, t in cache.items() if torch.is_tensor(t)]
    for key in leaves:
        res[f"{name}/shape/cache/{key}"] = np.asarray(cache[key].shape)
    prefill = make_prefill_step(cfg, api, groups, mesh=mesh)
    decode = make_decode_step(cfg, api, groups, mesh=mesh)
    batch = {"tokens": torch.from_numpy(inp[f"{name}/tokens"])}
    if f"{name}/frames" in inp:
        batch["frames"] = torch.from_numpy(inp[f"{name}/frames"])
    logits, cache = prefill(model, batch, cache)
    res[f"{name}/prefill/logits"] = logits.numpy().copy()
    for key in leaves:
        res[f"{name}/prefill/{key}"] = cache[key].numpy().copy()
    res[f"{name}/prefill/pos"] = np.asarray(cache["pos"])
    tok = torch.argmax(logits, dim=-1).to(torch.int32)
    res[f"{name}/0/tokens"] = tok.numpy().copy()
    for i in range(1, STEPS + 1):
        tok, logits, cache = decode(model, tok, cache)
        res[f"{name}/{i}/tokens"] = tok.numpy().copy()
        res[f"{name}/{i}/logits"] = logits.numpy().copy()
    for key in leaves:
        res[f"{name}/decode/{key}"] = cache[key].numpy().copy()
    res[f"{name}/decode/pos"] = np.asarray(cache["pos"])


def main():
    rank, data, tp, workdir = (int(sys.argv[1]), int(sys.argv[2]),
                               int(sys.argv[3]), sys.argv[4])
    torch.set_num_threads(1)
    with open_world("cpu", datetime.timedelta(seconds=120),
                    store=dist.FileStore(os.path.join(workdir, "store"),
                                         data * tp), rank=rank,
                    size=data * tp):
        inp = dict(np.load(os.path.join(workdir, "inputs.npz")))
        with open(os.path.join(workdir, "cases.json")) as f:
            cases = json.load(f)
        mesh = make_debug_mesh(data, tp, device="cpu")
        res = {}
        for case in cases:
            if [data, tp] in case["worlds"]:
                serve_case(mesh, data, inp, case, res)
        np.savez(os.path.join(workdir, f"out_{rank}.npz"), **res)
        dist.barrier()


if __name__ == "__main__":
    run_process(main)
