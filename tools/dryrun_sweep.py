"""Run the port's dry run over a list of cells, one process a cell (as
benchmarks/dryrun_all.py runs JAX's), and print a table per cell: rank 0's
peak and rules bytes, the bytes the port holds in a serving cell
(launch/dryrun.py held_bytes: parameters + cache), flops, collective
bytes by kind, seconds, and whether the peak fits one card.

    PYTHONPATH=src python tools/dryrun_sweep.py [--jobs 2] \\
        [--out artifacts/dryrun_torch] [--card-bytes N] \\
        [--overrides JSON] [CELL ...]

A CELL is ARCH:SHAPE[:mp]; the default list is JAX's grid on 16 x 16
(benchmarks/dryrun_all.py, which specs.cell_supported trims): all ten
configs at train_4k, prefill_32k and decode_32k, and the three long_500k
archs. A cell whose JSON exists under --out is read, not run again.
--overrides: ArchConfig overrides for every cell, as the dry run takes
them (e.g. '{"seq_shard_acts": true}'); their cells are kept under
--out/ov_HASH, HASH a digest of the overrides, so a cached cell is read
only by a sweep with the same overrides.
--card-bytes: one card's memory (torch.cuda.get_device_properties(0).
total_memory, which chip_smoke's phase 19 prints); without it the fit
column says "not known". Needs no card: the dry run runs on fake
tensors.
"""
from __future__ import annotations

import argparse
import concurrent.futures
import hashlib
import json
import os
import pathlib
import subprocess
import sys
import time

ROOT = pathlib.Path(__file__).resolve().parents[1]
ARCHS = ["rwkv6-1.6b", "recurrentgemma-2b", "whisper-large-v3",
         "phi4-mini-3.8b", "qwen3-14b", "pixtral-12b", "mixtral-8x7b",
         "dbrx-132b", "command-r-plus-104b", "nemotron-4-340b"]
LONG = ["recurrentgemma-2b", "rwkv6-1.6b", "mixtral-8x7b"]
CELLS = ([f"{a}:train_4k" for a in ARCHS] + [f"{a}:long_500k" for a in LONG]
         + [f"{a}:{s}" for a in ARCHS for s in ("prefill_32k", "decode_32k")])
GB = 1e9


def run(cell: str, out: pathlib.Path, timeout: int,
        overrides: str = "") -> dict:
    arch, shape, *mp = cell.split(":")
    multi = mp == ["mp"]
    path = out / f"{arch}__{shape}__{'mp' if multi else 'sp'}.json"
    if not path.exists():
        cmd = [sys.executable, "-m", "repro_torch.launch.dryrun", "--arch",
               arch, "--shape", shape, "--out", str(out)] + (
                   ["--multipod"] if multi else []) + (
                   ["--overrides", overrides] if overrides else [])
        env = {**os.environ, "PYTHONPATH": str(ROOT / "src")}
        t0 = time.time()
        proc = subprocess.run(cmd, capture_output=True, text=True, env=env,
                              timeout=timeout, cwd=str(ROOT))
        if proc.returncode != 0:
            raise RuntimeError(f"{cell} exited {proc.returncode}:\n"
                               f"{proc.stderr[-3000:]}")
        print(f"[dryrun_sweep] {cell} done in {time.time() - t0:.0f} s",
              flush=True)
    return json.loads(path.read_text())


def held(res: dict) -> str:
    """A serving cell's held bytes of rank 0, GB: parameters + cache."""
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun, specs
    sh = specs.SHAPES[res["shape"]]
    if sh["kind"] == "train":
        return "-"
    mesh = (MeshShape(("pod", "data", "model"), (2, 16, 16))
            if res["mesh"] == "2x16x16"
            else MeshShape(("data", "model"), (16, 16)))
    got = dryrun.held_bytes(get_config(res["arch"]), sh["kind"],
                            sh["batch"], sh["seq"], mesh)
    return f"{got['params'] / GB:.3f} + {got['cache'] / GB:.3f}"


def row(res: dict, card_bytes) -> str:
    if res["status"] != "ok":
        return (f"| {res['arch']} | {res['shape']} | {res['mesh']} | "
                f"{res['status']}: {res['reason']} ||||||||")
    mem, rules = res["memory"], res["rules_mb"]
    peak = mem["peak_mb"] * 2 ** 20
    coll = res["collectives"]["bytes"]
    kinds = ", ".join(f"{k} {v / GB:.3f}" for k, v in coll.items() if v)
    fits = ("not known" if card_bytes is None
            else "yes" if peak <= card_bytes else "no")
    return (f"| {res['arch']} | {res['shape']} | {res['mesh']} | "
            f"{peak / GB:.2f} | {rules['total'] * 2 ** 20 / GB:.3f} | "
            f"{held(res)} | {res['hlo_flops']:.4e} | {kinds or 'none'} | "
            f"{res['lower_s']} + {res['compile_s']} | {fits} |")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("cells", nargs="*", default=CELLS)
    ap.add_argument("--out", default=str(ROOT / "artifacts" /
                                         "dryrun_torch"))
    ap.add_argument("--jobs", type=int, default=2)
    ap.add_argument("--timeout", type=int, default=3600)
    ap.add_argument("--card-bytes", type=int, default=None)
    ap.add_argument("--overrides", default="",
                    help="JSON dict of ArchConfig overrides for every cell")
    args = ap.parse_args(argv)
    out = pathlib.Path(args.out)
    if args.overrides:
        canon = json.dumps(json.loads(args.overrides), sort_keys=True)
        out = out / f"ov_{hashlib.sha1(canon.encode()).hexdigest()[:10]}"
    with concurrent.futures.ThreadPoolExecutor(args.jobs) as pool:
        futures = [pool.submit(run, c, out, args.timeout, args.overrides)
                   for c in args.cells]
        results = [f.result() for f in futures]
    print("| arch | shape | mesh | peak GB / rank | rules GB / rank | "
          "held GB / rank (params + cache) | flops / rank | collective GB "
          "by kind | build + run s | fits |")
    print("|---|---|---|---|---|---|---|---|---|---|")
    for res in results:
        print(row(res, args.card_bytes))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
