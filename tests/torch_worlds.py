"""Gloo worlds of worker processes for the port's tests: one process a
rank, started together, joined against a deadline, and every failed
rank reported with its return code and the tail of its log.

    world = start(wdir, "torch_dist_worker.py", [[r, 2, wdir] for r in
                  range(2)], "world2")
    join(world, deadline)          # AssertionError naming every bad rank

Each rank's output goes to WDIR/log_RANK.txt. A rank still running at the
deadline is killed; `wait` gives each rank's code and when it exited
without judging them. `run_env_world` runs a command as the ranks of a
world with the environment torchrun gives its ranks (`torchrun_env`).
"""
import datetime
import os
import pathlib
import subprocess
import sys
import time
from typing import List, NamedTuple, Optional, Sequence, Tuple

import torch.distributed as dist

REPO = pathlib.Path(__file__).resolve().parents[1]
TAIL = 4000                 # bytes of each failed rank's log in the report


class World(NamedTuple):
    name: str
    wdir: pathlib.Path
    procs: list
    logs: list


def env() -> dict:
    return {**os.environ, "PYTHONPATH": str(REPO / "src"),
            "OMP_NUM_THREADS": "1"}


def link(work: pathlib.Path, wdir: pathlib.Path, items: Sequence[str]):
    """WDIR, made, with a symlink to each of WORK's `items`."""
    wdir.mkdir()
    for item in items:
        (wdir / item).symlink_to(work / item)


def start(wdir: pathlib.Path, worker: str, rank_args: Sequence[Sequence],
          name: str, rank_env: Optional[Sequence[dict]] = None) -> World:
    """tests/WORKER once for each rank, with that rank's arguments (and
    that rank's variables over env())."""
    logs = [open(wdir / f"log_{r}.txt", "w") for r in range(len(rank_args))]
    procs = [subprocess.Popen(
        [sys.executable, str(REPO / "tests" / worker)] + [str(a) for a in
                                                          args],
        env={**env(), **(rank_env[r] if rank_env else {})}, stdout=logs[r],
        stderr=subprocess.STDOUT) for r, args in enumerate(rank_args)]
    return World(name, wdir, procs, logs)


def wait(worlds: Sequence[World], deadline: float,
         since: Optional[float] = None) -> List[List[Tuple[int, float]]]:
    """Wait for every rank of `worlds` until `deadline`
    (time.monotonic(); a second at least), kill what still runs, close
    the logs; each world's ranks' (code, seconds from `since`, by default
    this call, to the rank's exit)."""
    t0 = time.monotonic()
    since = t0 if since is None else since
    deadline = max(deadline, t0 + 1.0)
    procs = [p for w in worlds for p in w.procs]
    ended = {}
    try:
        while len(ended) < len(procs) and time.monotonic() < deadline:
            for i, p in enumerate(procs):
                if i not in ended and p.poll() is not None:
                    ended[i] = time.monotonic() - since
            time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        for w in worlds:
            for f in w.logs:
                f.close()
    now = time.monotonic() - since
    out, i = [], 0
    for w in worlds:
        out.append([(p.returncode, ended.get(i + r, now))
                    for r, p in enumerate(w.procs)])
        i += len(w.procs)
    return out


def join(world: World, deadline: float) -> List[int]:
    """wait, then raise unless every rank exited 0, with each failed
    rank's code and log tail. Returns the codes."""
    codes = [code for code, _ in wait([world], deadline)[0]]
    bad = [r for r, code in enumerate(codes) if code != 0]
    if bad:
        tails = "".join(
            f"\n--- rank {r} (rc {codes[r]}) ---\n"
            + (world.wdir / f"log_{r}.txt").read_text()[-TAIL:] for r in bad)
        raise AssertionError(f"ranks {bad} of world {world.name} failed "
                             f"(rc {codes}):{tails}")
    return codes


def run(wdir, worker, rank_args, name, deadline) -> List[int]:
    """start and join."""
    return join(start(wdir, worker, rank_args, name), deadline)


def rendezvous(store, rank: int, world: int, seconds: float = 120.0):
    """Wait on `store` until every rank is up, before a world whose group
    timeout is short starts: that timeout also bounds gloo's connection of
    the ranks, which under load timed out on the ranks' start-up skew."""
    store.set(f"up{rank}", "1")
    store.wait([f"up{r}" for r in range(world)],
               datetime.timedelta(seconds=seconds))


def agent_store(timeout: float):
    """The ranks' store, held by this process on a port the system
    picks, as torchrun's agent holds it."""
    return dist.TCPStore("127.0.0.1", 0, is_master=True,
                         wait_for_workers=False,
                         timeout=datetime.timedelta(seconds=timeout))


def torchrun_env(store, world: int, rank: int) -> dict:
    """The variables torchrun gives rank `rank` of a world of `world`
    over `store` (TORCHELASTIC_USE_AGENT_STORE: every rank a client)."""
    return {"WORLD_SIZE": str(world), "MASTER_ADDR": "127.0.0.1",
            "MASTER_PORT": str(store.port),
            "TORCHELASTIC_USE_AGENT_STORE": "True", "RANK": str(rank),
            "LOCAL_RANK": str(rank)}


def run_env_world(cmd, world, cwd, timeout=240):
    """`cmd` (python's arguments) as each rank of a world of `world`
    processes, run in `cwd`, with the environment torchrun gives its
    ranks; returns [(returncode, stdout, stderr)] by rank. As torchrun's
    agent does, this process holds the ranks' store, on a port the system
    picks (TORCHELASTIC_USE_AGENT_STORE: every rank is a client), so no
    port is chosen and then taken by another. A rank still running at
    `timeout` seconds is killed."""
    store = agent_store(timeout)
    procs = [subprocess.Popen(
        [sys.executable] + list(cmd), cwd=cwd,
        env={**env(), **torchrun_env(store, world, r)},
        stdout=subprocess.PIPE, stderr=subprocess.PIPE, text=True)
        for r in range(world)]
    out = []
    try:
        for p in procs:
            o, e = p.communicate(timeout=timeout)
            out.append((p.returncode, o, e))
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
    del store
    return out
