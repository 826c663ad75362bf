#!/usr/bin/env python3
"""Time the port's gram kernel on one CUDA card over p and the input data.

    python3 tools/time_gram.py [--src DIR] [--p 19 32 ... 400]
                               [--data clustered normal] [--kinds polynomial]

At (n 100,000, w 512) by default, for each data set, p and kind: the
kernel's one-call time (CUDA events, median of 7 after warm-up), its
back-to-back time (10 calls enqueued, per call), and its largest
difference from the plain version on the same inputs. `--src` names the
`src` directory whose `repro_torch` is timed (by default this checkout's),
so the same script times another checkout's kernel through the same
public wrapper, `gram_stripe_op`. Data: `clustered` is the segmentation
proxy at p columns (the main path's data), Xb its last w points;
`normal` is standard normal columns scaled to unit norm. Prints the
card's name and power limit, one JSON line per case, and exits non-zero
without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys


def cuda_ms(torch, fn, reps: int = 7, warm: int = 2) -> float:
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_back_to_back(torch, fn, calls: int = 10) -> float:
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def inputs(torch, data: str, n: int, w: int, p: int):
    gen = torch.Generator(device="cuda").manual_seed(0)
    if data == "clustered":
        from repro_torch.data.synthetic import segmentation_proxy
        X, _ = segmentation_proxy(gen, n=n, p=p, k=7)
    else:
        X = torch.randn((p, n), generator=gen, device="cuda")
        X /= X.norm(dim=0)
    return X, X[:, n - w:]


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--src", default=str(pathlib.Path(__file__).resolve()
                                         .parents[1] / "src"))
    ap.add_argument("--n", type=int, default=100_000)
    ap.add_argument("--w", type=int, default=512)
    ap.add_argument("--p", type=int, nargs="+",
                    default=[19, 32, 40, 64, 100, 150, 200, 300, 400])
    ap.add_argument("--data", nargs="+", default=["clustered", "normal"],
                    choices=["clustered", "normal"])
    ap.add_argument("--kinds", nargs="+", default=["polynomial"],
                    choices=["polynomial", "rbf", "linear"])
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_gram: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, args.src)
    torch.backends.cuda.matmul.allow_tf32 = False
    from repro_torch.kernels.gram import ops
    from repro_torch.kernels.gram.ref import gram_stripe_ref
    print(subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip(), flush=True)
    for data in args.data:
        for p in args.p:
            X, Xb = inputs(torch, data, args.n, args.w, p)
            for kind in args.kinds:
                gamma = 0.5 if kind == "rbf" else 0.0
                want = gram_stripe_ref(X, Xb, kind, gamma, 2)

                def fn():
                    return ops.gram_stripe_op(X, Xb, kind, gamma, 2)
                err = float((fn() - want).abs().max())
                print(json.dumps({
                    "src": args.src, "data": data, "n": args.n, "w": args.w,
                    "p": p, "kind": kind, "max_abs_err": err,
                    "ms": cuda_ms(torch, fn),
                    "ms_back_to_back": cuda_ms_back_to_back(torch, fn)}),
                    flush=True)
                del want
    return 0


if __name__ == "__main__":
    sys.exit(main())
