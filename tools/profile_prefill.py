#!/usr/bin/env python3
"""Profile one warm LM prefill on one CUDA card, kernel by kernel.

    python3 tools/profile_prefill.py [--arch whisper-large-v3]

The model and shapes of chip_smoke.py's phases 13-16 (the arch at its
published widths and depth, bf16 weights drawn from seed 0; batch LM_B,
a prompt of LM_S from seed 1, an encoder-decoder's frames from seed 2,
an f32 cache for LM_MAX_SEQ positions), with TF32 off
and bf16 GEMMs reducing in f32 as the launcher sets them: one prefill to
warm up, then one under torch.profiler. For an encoder-decoder also its
`encode(frames)` alone, so the encoder's share shows. For each: the host
ms to the last synchronize, the card's busy ms, its records and the
kernels that take most of the card's time (name, calls, ms). Prints the
card's name and power limit, then one JSON line; exits non-zero without
a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import sys

ROOT = pathlib.Path(__file__).resolve().parents[1]


def by_kernel(device: dict, host_ms: float, top: int = 8) -> dict:
    """chip_smoke.profiled's {kernel: (records, ms)} summed up."""
    busy = sum(ms for _, ms in device.values())
    most = sorted(device.items(), key=lambda kv: -kv[1][1])[:top]
    return {"host_ms": host_ms, "device_ms": busy,
            "records": sum(n for n, _ in device.values()),
            "top": [{"kernel": k[:90], "calls": n, "ms": ms}
                    for k, (n, ms) in most]}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="python3 tools/profile_prefill.py")
    ap.add_argument("--arch", default="whisper-large-v3")
    args = ap.parse_args(argv)
    import torch
    if not torch.cuda.is_available():
        print("profile_prefill: no CUDA device", file=sys.stderr)
        return 2
    sys.path[:0] = [str(ROOT), str(ROOT / "src")]
    import chip_smoke as C
    from repro_torch.launch.serve import set_matmul_precision
    set_matmul_precision()
    cfg = C.get_lm_config(args.arch)
    model = C.lm_model(torch, cfg)
    tokens = C.lm_tokens(torch, cfg, C.LM_B, C.LM_S, C.SEED + 1)
    frames = C.lm_frames(torch, cfg, C.LM_B)
    extra = () if frames is None else (frames,)
    cache = model.init_cache(C.LM_B, C.LM_MAX_SEQ, torch.float32)
    parts = {"prefill": lambda: model.prefill(tokens, *extra, cache)}
    if frames is not None:
        parts["encode"] = lambda: model.encode(frames)
    out = {"arch": cfg.name, "batch": C.LM_B, "prompt_len": C.LM_S,
           "max_seq": C.LM_MAX_SEQ}
    with torch.no_grad():
        for name, fn in parts.items():
            fn()                                      # warm-up
            C.sync(torch)
            host_ms, device = C.profiled(torch, fn)
            out[name] = by_kernel(device, host_ms)
    print(C.nvidia_smi_line())
    print(json.dumps(out))
    return 0


if __name__ == "__main__":
    sys.exit(main())
