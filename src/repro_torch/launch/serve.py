"""Batched LM serving launcher: prefill + greedy decode over a batch of
synthetic requests (the port of repro/launch/serve.py).

It does what the JAX launcher does for every family (dense, moe, vlm,
the hybrid, the ssm and the encoder-decoder, through
models.registry.get_api): the config (the smoke config unless
--no-smoke), random weights at tp = 1 (drawn from --seed), a synthetic
prompt (from --seed + 1: tokens, and for encdec the audio frames drawn
first, in cfg.dtype; vlm serves text only), a cache in f32 (the
hybrid's h and conv state, the ssm's s, tm and cm, whisper's cross K/V
too), one prefill, greedy argmax,
--gen decode steps, the same two printed lines and a check that the
logits are finite. A third line gives the decode rate and, on the card,
the peak device memory.

Two differences from the JAX launcher. Its --smoke is store_true with
default True, so it can never run a published config; here the flag is
--smoke / --no-smoke and the default stays smoke. It copies each step's
tokens to the host inside the decode loop; here they stay on the device
and are copied once after the timed loop, so "ms/step" is the device
step without that copy.

Runs on the card unless --device cpu is given; without a card it stops.
On the card TF32 is off and bf16 GEMMs reduce in f32
(allow_bf16_reduced_precision_reduction = False), as XLA's do.

Usage:
  PYTHONPATH=src python -m repro_torch.launch.serve --device cpu
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
      --arch phi4-mini-3.8b --batch 8 --prompt-len 512 --gen 32 \
      --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
      --arch recurrentgemma-2b --batch 8 --prompt-len 512 --gen 32 \
      --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
      --arch rwkv6-1.6b --batch 8 --prompt-len 512 --gen 32 \
      --max-seq 1024
  PYTHONPATH=src python -m repro_torch.launch.serve --no-smoke \
      --arch whisper-large-v3 --batch 8 --prompt-len 512 --gen 32 \
      --max-seq 1024

The ssm family (rwkv6) runs its prompt in chunks of cfg.rwkv_chunk (64)
tokens: a prompt longer than that must be a multiple of it, as in the
JAX package.
"""
from __future__ import annotations

import argparse
import sys
import time

import torch

from repro_torch.configs import get_config
from repro_torch.launch import specs
from repro_torch.models.registry import get_api
from repro_torch.train.steps import make_decode_step, make_prefill_step


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="python -m repro_torch.launch.serve")
    ap.add_argument("--arch", default="phi4-mini-3.8b")
    ap.add_argument("--smoke", action=argparse.BooleanOptionalAction,
                    default=True)
    ap.add_argument("--batch", type=int, default=4)
    ap.add_argument("--prompt-len", type=int, default=16)
    ap.add_argument("--gen", type=int, default=8)
    ap.add_argument("--max-seq", type=int, default=128)
    ap.add_argument("--device", default="cuda")
    ap.add_argument("--seed", type=int, default=0)
    return ap


def set_matmul_precision() -> None:
    """Full-f32 products (no TF32) and bf16 GEMMs that reduce in f32."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False


def _sync(device: torch.device) -> None:
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def run(args: argparse.Namespace) -> dict:
    """Serve one batch; print the JAX launcher's lines; return the model,
    prompt, frames (encdec; None for the others), generated ids (B,
    gen + 1), last logits and times."""
    device = torch.device(args.device)
    if device.type == "cuda":
        set_matmul_precision()
        torch.cuda.reset_peak_memory_stats(device)
    cfg = get_config(args.arch, smoke=args.smoke)
    api = get_api(cfg)
    model = api.init(cfg, tp=1, device=device,
                     generator=torch.Generator(device).manual_seed(args.seed))
    prefill = make_prefill_step(cfg, api, groups=1)
    decode = make_decode_step(cfg, api, groups=1)

    # Synthetic request batch (vlm serves text only).
    gen = torch.Generator(device).manual_seed(args.seed + 1)
    if cfg.family == "vlm":
        pb = {"tokens": torch.randint(0, cfg.vocab_size,
                                      (args.batch, args.prompt_len),
                                      generator=gen, device=device,
                                      dtype=torch.int32)}
    else:
        pb = specs.prefill_inputs(cfg, args.prompt_len, args.batch, gen)
    cache = api.init_cache(cfg, args.batch, args.max_seq, torch.float32,
                           device)

    _sync(device)
    t0 = time.perf_counter()
    logits, cache = prefill(model, pb, cache)
    _sync(device)
    t_prefill = time.perf_counter() - t0
    tokens = torch.argmax(logits, dim=-1).to(torch.int32)
    generated = [tokens]
    t0 = time.perf_counter()
    for _ in range(args.gen):
        tokens, logits, cache = decode(model, tokens, cache)
        generated.append(tokens)
    _sync(device)
    t_decode = time.perf_counter() - t0
    gen_ids = torch.stack(generated, dim=1).cpu().numpy()
    print(f"arch={cfg.name} batch={args.batch} "
          f"prefill {args.prompt_len} tok in {t_prefill*1e3:.1f} ms; "
          f"{args.gen} decode steps in {t_decode*1e3:.1f} ms "
          f"({t_decode/max(args.gen, 1)*1e3:.2f} ms/step incl. dispatch)")
    print("generated token ids (first request):", gen_ids[0].tolist())
    out = {"model": model, "cfg": cfg, "prompt": pb["tokens"],
           "frames": pb.get("frames"), "generated": gen_ids, "logits": logits,
           "prefill_s": t_prefill, "decode_s": t_decode}
    peak = "not measured"
    if device.type == "cuda":
        out["peak_bytes"] = torch.cuda.max_memory_allocated(device)
        peak = f"{out['peak_bytes'] / 1e9:.3f} GB"
    print(f"device {device.type}: decode "
          f"{args.batch * args.gen / t_decode:.1f} tokens/s; peak device "
          f"memory {peak}")
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError(f"{cfg.name}: non-finite logits")
    return out


def main(argv=None) -> int:
    ap = build_parser()
    args = ap.parse_args(argv)
    if torch.device(args.device).type == "cuda" and \
            not torch.cuda.is_available():
        ap.error("no CUDA device is available; pass --device cpu to serve "
                 "on the CPU")
    run(args)
    return 0


if __name__ == "__main__":
    sys.exit(main())
