"""Training launcher at one rank: the model, AdamW, checkpoint / restart
(the port of repro/launch/train.py).

It does what the JAX launcher does on one device: the config (the smoke
config with --smoke), random weights at tp = --model = 1 (drawn from
--seed; JAX's PRNGKey(0)), a fixed synthetic batch (specs.train_inputs
from a generator seeded 7, JAX's PRNGKey(7)) that the model must drive
the loss down on, the train step of train/steps.py (cfg.microbatches,
cfg.remat, AdamW at --lr), a CheckpointManager under --ckpt-dir saving
every --ckpt-every steps and restoring the newest checkpoint first, the
same printed lines and the assertion that the loss fell. A further line
gives the warm step time (the steps after the first), tokens/s and, on
the card, the peak device memory.

The state on disk is {"params": {name: tensor}, "opt": {"m": {name:
tensor}, "v": {name: tensor}, "step": tensor}}. A restore reads it into
host tensors and copies it leaf by leaf into the live state, which the
step updates in place (a second copy of phi4-mini's 44.5 GB training
state would not fit beside the first on one card).

Differences from the JAX launcher: --data / --model other than 1 and
--sketch-grads other than 0 (the mesh and the sketched gradients) are
refused until the mesh half is ported; --smoke is --smoke / --no-smoke
and defaults to off, as JAX's store_true does; the saves are waited for
before the launcher returns.

Runs on the card unless --device cpu is given; without a card it stops.
On the card TF32 is off and bf16 GEMMs reduce in f32, as XLA's do.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.train --device cpu --smoke \
      --arch qwen3-14b --steps 20 --batch 4 --seq 64 --ckpt-dir /tmp/ckpt
  PYTHONPATH=src python -m repro_torch.launch.train --no-smoke \
      --arch phi4-mini-3.8b --batch 4 --seq 512 --steps 8
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.distributed.checkpoint import (CheckpointManager, _flatten,
                                                _unflatten,
                                                wait_for_async_saves)
from repro_torch.launch import specs
from repro_torch.launch.serve import set_matmul_precision
from repro_torch.models.registry import get_api
from repro_torch.train.optimizer import AdamWConfig
from repro_torch.train.steps import (TrainState, init_train_state,
                                     make_train_step)

MESH_HALF = "ROADMAP.md Queue A 3(b), the mesh half of training"


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.train")
    ap.add_argument("--arch", default="qwen3-14b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=False, help="reduced config (CPU-runnable)")
    ap.add_argument("--steps", type=int, default=100)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--seq", type=int, default=64)
    ap.add_argument("--data", type=int, default=1, help="data-axis size")
    ap.add_argument("--model", type=int, default=1, help="model-axis size")
    ap.add_argument("--ckpt-dir", default="")
    ap.add_argument("--ckpt-every", type=int, default=50)
    ap.add_argument("--sketch-grads", type=int, default=0,
                    help="r' for SRHT gradient compression (0 = off)")
    ap.add_argument("--lr", type=float, default=3e-3)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def state_tree(state: TrainState) -> dict:
    """The state as the checkpoint holds it: {"params", "opt"}."""
    return {"params": dict(state.params.named_parameters()),
            "opt": state.opt}


def _host_like(t: torch.Tensor) -> torch.Tensor:
    """A CPU tensor of t's shape and dtype holding no memory: restore reads
    each leaf into host memory, not beside the live state on the card."""
    return torch.empty((), dtype=t.dtype).expand(t.shape)


@torch.no_grad()
def restore_into(mgr: CheckpointManager, state: TrainState) -> int:
    """Copy the newest checkpoint into the live state; returns its step
    (FileNotFoundError when there is none)."""
    live = state_tree(state)
    like = _unflatten(live, (_host_like(t) for _, t in _flatten(live)))
    restored, step = mgr.restore_latest(like)
    for (_, dst), (_, src) in zip(_flatten(live), _flatten(restored)):
        dst.copy_(src)
    return step


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """Train; print the JAX launcher's lines and the speed line; return
    the state, config, losses, grad norms, the first step run (`start`),
    each step's seconds and the warm numbers."""
    device = torch.device(args.device)
    if device.type == "cuda":
        set_matmul_precision()
        torch.cuda.reset_peak_memory_stats(device)
    cfg = get_config(args.arch, smoke=args.smoke)
    api = get_api(cfg)
    state = init_train_state(
        cfg, api, tp=args.model, device=device,
        generator=torch.Generator(device).manual_seed(args.seed))
    opt_cfg = AdamWConfig(lr=args.lr, moment_dtype=cfg.optimizer_dtype)
    # A fixed synthetic corpus: the model must drive loss down on it.
    batch = specs.train_inputs(cfg, args.seq, args.batch,
                               torch.Generator(device).manual_seed(7))
    mgr = (CheckpointManager(args.ckpt_dir, save_every=args.ckpt_every)
           if args.ckpt_dir else None)
    start = 0
    if mgr is not None:
        try:
            start = restore_into(mgr, state)
            print(f"restored checkpoint at step {start}")
        except FileNotFoundError:
            pass

    step_fn = make_train_step(cfg, api, groups=args.data, opt_cfg=opt_cfg)
    losses, gnorms, step_s = [], [], []
    t0 = time.time()
    for step in range(start, args.steps):
        _sync(device)
        t_step = time.perf_counter()
        state, metrics = step_fn(state, batch)
        losses.append(float(metrics["loss"]))
        step_s.append(time.perf_counter() - t_step)
        gnorms.append(float(metrics["grad_norm"]))
        if mgr is not None:
            mgr.maybe_save(step + 1, state_tree(state))
        if step % 10 == 0 or step == args.steps - 1:
            print(f"step {step:5d} loss {losses[-1]:.4f} "
                  f"gnorm {gnorms[-1]:.3f} "
                  f"({(time.time()-t0):.1f}s)", flush=True)
    wait_for_async_saves()
    if not losses:
        raise SystemExit(f"nothing to train: the checkpoint is at step "
                         f"{start} and --steps is {args.steps}")
    print(f"final loss {losses[-1]:.4f} (start {losses[0]:.4f})")
    warm = step_s[1:] or step_s
    warm_s = sum(warm) / len(warm)
    out = {"state": state, "cfg": cfg, "losses": losses, "grad_norms":
           gnorms, "start": start, "step_s": step_s,
           "warm_ms": warm_s * 1e3,
           "tokens_per_s": args.batch * args.seq / warm_s}
    peak = "not measured"
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        peak = f"{out['peak_bytes'] / 1e9:.3f} GB"
    print(f"device {device.type}: warm step {out['warm_ms']:.1f} ms over "
          f"{len(warm)} steps, {out['tokens_per_s']:.1f} tokens/s; peak "
          f"device memory {peak}")
    if not losses[-1] < losses[0]:
        raise AssertionError("loss did not decrease")
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if args.data != 1 or args.model != 1:
        ap.error(f"--data / --model other than 1 need a mesh: {MESH_HALF}")
    if args.sketch_grads:
        ap.error(f"--sketch-grads needs the sketched gradients: "
                 f"{MESH_HALF}")
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to train "
                 "on the CPU")
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
