#!/usr/bin/env python3
"""Time the port's fwht kernel at one column (c = 1) on one CUDA card.

    python3 tools/time_fwht_column.py [--m 24 31] [--row-bits 11 12 13]
                                      [--reps 5] [--out FILE]

For each n = 2^m: a column of standard normals from seed 0 on the card,
its plain transform (fwht_ref) once, then every variant held to its bits
and timed in turns, forward and then backward through the variants (so
each has two times, taken apart): the pass kernel alone over the column
(`before`: one column a thread, the plan every c != 1 keeps), and
fwht_op's one-column plan at each row-pass width L (`row_bits` L: the row
pass over segments of 2^L floats, then the pass kernel over the
(n / 2^L, 2^L) view, in place). Each L is also split into its row pass
and its view passes, launched alone, and a device copy of the column
stands beside them as the yardstick of one pass. Times are CUDA events,
the median of `--reps` calls after one warm-up; the bound is 8 n bytes
over 3.35 TB/s. Prints the card's name and power limit, then one JSON
line per n (also appended to --out); exits 1 if a variant's bits differ
from fwht_ref's, 2 without a card.
"""
from __future__ import annotations

import argparse
import json
import pathlib
import statistics
import subprocess
import sys

HBM_BYTES_PER_S = 3.35e12


def cuda_ms(torch, fn, reps: int, warm: int = 1) -> float:
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


def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--m", type=int, nargs="+", default=[24, 31])
    ap.add_argument("--row-bits", type=int, nargs="+", default=[11, 12, 13])
    ap.add_argument("--reps", type=int, default=5)
    ap.add_argument("--out", default=None)
    args = ap.parse_args()
    import torch
    if not torch.cuda.is_available():
        print("time_fwht_column: no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(pathlib.Path(__file__).resolve().parents[1]
                           / "src"))
    from repro_torch.kernels import _build, _common as cm
    from repro_torch.kernels.fwht import ops
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    lib = _build.library()
    default_bits, ok = ops.ROW_BITS, True
    for m in args.m:
        n = 1 << m
        gen = torch.Generator(device="cuda").manual_seed(0)
        x = torch.randn((n, 1), generator=gen, device="cuda")
        want = ops.fwht_ref(x).view(torch.int32)
        out = torch.empty_like(x)

        def before():
            _build.check(lib.rt_fwht(
                x.data_ptr(), out.data_ptr(), n, 1,
                *ops._fwht_plan(n, ops.MAX_PASS_BITS), 1, ops._sqrt(n),
                cm.stream(x)), "fwht")
            return out

        def plan(bits):
            def run():
                ops.ROW_BITS = bits
                try:
                    return ops.fwht_op(x)
                finally:
                    ops.ROW_BITS = default_bits
            return run

        variants = {"before": before}
        variants.update({f"row_bits {b}": plan(b) for b in args.row_bits})
        same = {}
        for name, fn in variants.items():
            same[name] = bool(torch.equal(fn().view(torch.int32), want))
        ok &= all(same.values())
        del want
        times = {name: [] for name in variants}
        order = list(variants) + list(reversed(variants))
        for name in order:
            times[name].append(cuda_ms(torch, variants[name], args.reps))
        parts = {}
        for b in args.row_bits:
            s = min(m, b)
            rows = n >> s

            def row_pass(s=s):
                _build.check(lib.rt_fwht_rows(
                    x.data_ptr(), out.data_ptr(), n, s,
                    ops.reg_bits(s - ops.MIN_ROW_BITS), 1.0,
                    cm.stream(x)), "fwht")

            def view_passes(s=s, rows=rows):
                _build.check(lib.rt_fwht(
                    out.data_ptr(), out.data_ptr(), rows, 1 << s,
                    *ops._fwht_plan(rows, ops.MAX_PASS_BITS), 4, 1.0,
                    cm.stream(x)), "fwht")

            parts[f"row_bits {b}"] = {
                "row_pass_ms": cuda_ms(torch, row_pass, args.reps),
                "view_passes_ms": (cuda_ms(torch, view_passes, args.reps)
                                   if rows > 1 else 0.0),
                "view_passes": ops.pass_bits(rows) if rows > 1 else []}
        rec = {"card": smi, "n": n, "c": 1,
               "bound_ms": 8 * n / HBM_BYTES_PER_S * 1e3,
               "copy_ms": cuda_ms(torch, lambda: out.copy_(x), args.reps),
               "before_passes": ops.pass_bits(n),
               "same_bits": same, "ms_in_turns": times, "parts": parts,
               "order": order, "reps": args.reps}
        print(json.dumps(rec), flush=True)
        if args.out:
            with open(args.out, "a") as f:
                f.write(json.dumps(rec) + "\n")
        del x, out
        torch.cuda.empty_cache()
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
