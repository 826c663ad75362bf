"""Fault tolerance: heartbeats, straggler detection, elastic re-mesh,
checkpoint / restart supervision.

The JAX package's module (which holds no JAX), with TrainSupervisor over
the port's CheckpointManager (distributed/checkpoint.py). Host failure
and preemption are simulated at the process level (injected exceptions,
fake clocks); the control flow, detect -> shrink the mesh -> restore the
checkpoint onto it -> continue, is the code a multi-host launcher drives.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Any, Callable, Dict, List, Tuple

import numpy as np


class HeartbeatMonitor:
    """Tracks last-seen times per host; hosts silent > timeout are dead."""

    def __init__(self, hosts: List[str], timeout_s: float = 60.0,
                 clock: Callable[[], float] = time.monotonic):
        self.timeout = timeout_s
        self.clock = clock
        self.last: Dict[str, float] = {h: clock() for h in hosts}

    def beat(self, host: str):
        self.last[host] = self.clock()

    def dead_hosts(self) -> List[str]:
        now = self.clock()
        return [h for h, t in self.last.items() if now - t > self.timeout]

    def healthy_hosts(self) -> List[str]:
        dead = set(self.dead_hosts())
        return [h for h in self.last if h not in dead]


class StragglerTracker:
    """Flags hosts whose step times exceed `factor` x the fleet median.

    Mitigation hooks: (a) report for re-scheduling, (b) with microbatch
    gradient accumulation the supervisor can drop the slowest host's last
    microbatch (bounded staleness) — policy returned as an action string.
    """

    def __init__(self, factor: float = 2.0, window: int = 20):
        self.factor = factor
        self.window = window
        self.times: Dict[str, List[float]] = {}

    def record(self, host: str, step_time: float):
        self.times.setdefault(host, []).append(step_time)
        self.times[host] = self.times[host][-self.window:]

    def stragglers(self) -> List[str]:
        if not self.times:
            return []
        meds = {h: float(np.median(t)) for h, t in self.times.items()}
        fleet = float(np.median(list(meds.values())))
        return [h for h, m in meds.items() if m > self.factor * fleet]

    def action(self, host: str) -> str:
        return ("skip-last-microbatch" if host in self.stragglers()
                else "none")


def elastic_mesh(n_hosts_healthy: int, chips_per_host: int = 8,
                 model_parallel: int = 16):
    """Largest (data, model) mesh from surviving chips.

    Keeps the model axis fixed (weights must still fit) and shrinks the
    data axis to the largest power of two that the healthy chips support.
    Returns (shape, axis_names); callers build it with
    launch.mesh.make_mesh once the process group has been restarted on the
    surviving hosts.
    """
    chips = n_hosts_healthy * chips_per_host
    data = chips // model_parallel
    if data < 1:
        raise RuntimeError(f"not enough chips ({chips}) for model_parallel="
                           f"{model_parallel}")
    p = 1
    while p * 2 <= data:
        p *= 2
    return (p, model_parallel), ("data", "model")


@dataclasses.dataclass
class RestartReport:
    restarts: int
    completed_steps: int
    remesh_events: List[Tuple[int, Tuple[int, ...]]]


class TrainSupervisor:
    """Run a step loop with checkpoint/restart and (simulated) elastic
    re-mesh. `step_fn(state, step) -> state` may raise HostFailure."""

    def __init__(self, ckpt_manager, state_like_fn: Callable[[], Any],
                 max_restarts: int = 10):
        self.ckpt = ckpt_manager
        self.state_like_fn = state_like_fn
        self.max_restarts = max_restarts

    def run(self, state, step_fn, n_steps: int, start_step: int = 0,
            mesh=None, pspecs=None) -> Tuple[Any, RestartReport]:
        restarts = 0
        remesh_events: List[Tuple[int, Tuple[int, ...]]] = []
        step = start_step
        while step < n_steps:
            try:
                state = step_fn(state, step)
                step += 1
                self.ckpt.maybe_save(step, state)
            except HostFailure as e:
                restarts += 1
                if restarts > self.max_restarts:
                    raise RuntimeError("restart budget exhausted") from e
                # Recover: rebuild mesh from survivors, restore latest.
                shape, axes = elastic_mesh(e.healthy_hosts,
                                           e.chips_per_host,
                                           e.model_parallel)
                remesh_events.append((step, shape))
                state, step = self.ckpt.restore_latest(
                    self.state_like_fn(), mesh=mesh, pspecs=pspecs)
        return state, RestartReport(restarts, step, remesh_events)


class HostFailure(RuntimeError):
    def __init__(self, msg: str, healthy_hosts: int = 31,
                 chips_per_host: int = 8, model_parallel: int = 16):
        super().__init__(msg)
        self.healthy_hosts = healthy_hosts
        self.chips_per_host = chips_per_host
        self.model_parallel = model_parallel
