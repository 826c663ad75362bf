"""The rank-0 pump: asynchronous serving of a sharded row from one front door.

JAX serves a sharded row from one controller: an AsyncBatcher's flush
runs the sharded extension on every device at once. The port runs one
process per rank, and a sharded flush is collective (ShardedExtender: one
all_reduce per stripe), so every rank must run the same flushes in the
same order. A clock or a full bucket that each rank read for itself
would not give that. So rank 0 of the policy's mesh axis is the one
front door:

  rank 0     takes every request, decides every flush (the deadline or a
             full bucket) and every swap, and broadcasts each decision
             over the axis's group before it runs it;
  followers  loop over the messages in order (AsyncBatcher.follow,
             ModelRegistry.follow) and run the same collectives.

The pump applies to every AsyncBatcher whose policy has a mesh, a world
of one rank included, so the card runs the code of any world.

Messages. Each is a header of HEADER int64 words (kind, generation,
meta, body bytes), then, when it carries one, a body of bytes, both
broadcast from rank 0 on the model's device (gloo on the CPU, NCCL on
the card):

  FLUSH gen  meta = the request count; body = each request's width
             (int64), then the payload, one (p, W) float32 tensor: the
             requests side by side, as a drain coalesces them;
  SWAP gen   a registry row's new model, gen its new scheduler's tag;
             meta = the JSON's bytes; body = JSON (spec, version, the
             bucket widths rank 0 warms, the leaves' layout), then every
             leaf's bytes. No filesystem is shared;
  STOP gen   the batcher of that generation retires;
  NOP        an idle rank-0 pump thread's keep-alive (KEEPALIVE_S), so a
             follower's wait stays inside the group's timeout.

A generation tag names one pumped AsyncBatcher: a process counts its
pumped batchers as it builds them, and every rank builds the same ones in
the same order (the SPMD set-up; a swap builds the new scheduler on each
rank as it handles SWAP). A follower that reads a tag it does not hold
raises.

Ordering. Every collective rank 0 makes for a pumped batcher (a header,
a swap's warm-ups, a flush's compute, STOP) runs under PUMP.lock, held
for the whole header-plus-compute sequence, so the pump thread and the
main thread (a swap draining the old row while the new one serves) never
interleave collectives; the followers apply the same total order. The
lock is taken inside an AsyncBatcher's _flush_lock and never the other
way round.

Failures. A request is checked before it enters the window. A compute
failure on rank 0 after a header went out resolves that batch's futures
with the exception, as an unsharded flush does, and raises out of the
flush. The pump sends no abort message, since after a broken collective
no message is sure to arrive. The world ends instead (launch/mesh.py):
the exception leaves rank 0's world block, whose close_world abandons
every pumped batcher (no STOP) and aborts the groups. The collective
that rank 0 left half made then fails on the other ranks at once (the
connection closed) or at the latest at the group's timeout (mesh.py
TIMEOUT, or the one the world was made with). A follower raises out of
follow(), never waits for ever, and does no more with the pump: the
exception leaves its own world block, which abandons its batchers and
aborts its groups in turn. Each rank, run through mesh.run_process,
then prints the exception and leaves through os._exit with BROKEN_EXIT
(70): a code of its own, never a signal.
"""
from __future__ import annotations

import dataclasses
import json
import threading
import weakref
from typing import Dict, List, NamedTuple, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from repro_torch.serve.artifact import ClusteringSpec, FittedModel

FLUSH, SWAP, STOP, NOP = 1, 2, 3, 4
KINDS = {FLUSH: "FLUSH", SWAP: "SWAP", STOP: "STOP", NOP: "NOP"}
HEADER = 4                # int64 words: kind, generation, meta, body bytes
KEEPALIVE_S = 60.0        # a fifth of launch/mesh.py's TIMEOUT
_ALIGN = 8                # each part of a body starts on 8 bytes


class Message(NamedTuple):
    """One message as a follower reads it; body is uint8 on the device."""
    kind: int
    gen: int
    meta: int
    body: Optional[torch.Tensor]


class Pump:
    """The process's sequencer: the one lock under which rank 0 makes the
    collectives of every pumped batcher, the generation counter, and the
    counts of what this rank broadcast (messages, broadcasts, bytes)."""

    def __init__(self):
        self.lock = threading.RLock()
        self.messages = 0          # guarded-by: lock
        self.broadcasts = 0        # guarded-by: lock
        self.bytes = 0             # guarded-by: lock
        self._generations = 0      # guarded-by: lock
        # The pumped batchers built, held weakly, for retire(). A lock of
        # its own: a flush stuck in a broken collective holds self.lock.
        self._live_lock = threading.Lock()
        self._live = weakref.WeakSet()    # guarded-by: _live_lock

    def generation(self) -> int:
        """The next generation tag of this process."""
        with self.lock:
            self._generations += 1
            return self._generations

    def enlist(self, batcher) -> None:
        """Record a pumped AsyncBatcher for retire()."""
        with self._live_lock:
            self._live.add(batcher)

    def retire(self, broken: bool = False) -> None:
        """Retire every pumped batcher of this process not yet stopped, as
        its world ends: stop() (rank 0's sends its STOP; a follower's sends
        nothing), or abandon() (no message on any rank) after a broken
        collective and for a batcher whose group is gone already (a world
        that ended without close_world)."""
        with self._live_lock:
            live = [ab for ab in self._live if not ab.stopped]
        for ab in live:
            if broken or not _in_world(ab.axis.group):
                ab.abandon()
            else:
                ab.stop()

    def reset_counts(self) -> None:
        with self.lock:
            self.messages = self.broadcasts = self.bytes = 0

    def counts(self) -> Dict[str, int]:
        with self.lock:
            return {"messages": self.messages,
                    "broadcasts": self.broadcasts, "bytes": self.bytes}

    def _broadcast(self, ax, t: torch.Tensor) -> None:
        dist.broadcast(t, src=ax.peer(0), group=ax.group)
        with self.lock:
            self.broadcasts += 1
            self.bytes += t.numel() * t.element_size()

    def send(self, ax, device, kind: int, gen: int, meta: int = 0,
             body: Optional[torch.Tensor] = None) -> None:
        """Rank 0: broadcast one message over `ax` (a MeshAxis). The
        caller holds self.lock through whatever collectives follow."""
        nbytes = 0 if body is None else int(body.numel())
        head = torch.tensor([kind, gen, meta, nbytes],
                            dtype=torch.int64).to(device)
        with self.lock:
            self.messages += 1
            self._broadcast(ax, head)
            if nbytes:
                self._broadcast(ax, body)

    def receive(self, ax, device) -> Message:
        """A follower: the next message rank 0 broadcast over `ax`."""
        head = torch.empty(HEADER, dtype=torch.int64, device=device)
        self._broadcast(ax, head)
        with self.lock:
            self.messages += 1
        kind, gen, meta, nbytes = head.tolist()
        body = None
        if nbytes:
            body = torch.empty(nbytes, dtype=torch.uint8, device=device)
            self._broadcast(ax, body)
        if kind not in KINDS:
            raise RuntimeError(f"pump: unknown message kind {kind}")
        return Message(kind, gen, meta, body)


PUMP = Pump()


def _in_world(group) -> bool:
    """Whether `group` belongs to the world this process holds now."""
    if not dist.is_initialized():
        return False
    try:
        dist.get_process_group_ranks(group)
    except KeyError:
        return False
    return True


def _padded(n: int) -> int:
    return -(-n // _ALIGN) * _ALIGN


# -- FLUSH -------------------------------------------------------------------

def pack_flush(widths: Sequence[int], big: np.ndarray, device
               ) -> torch.Tensor:
    """A FLUSH body: the widths as int64, then `big` (p, sum(widths)) as
    float32, one uint8 tensor on `device` (one copy to the card)."""
    head = np.asarray(widths, np.int64).view(np.uint8)
    flat = np.ascontiguousarray(big, np.float32).reshape(-1).view(np.uint8)
    return torch.from_numpy(np.concatenate([head, flat])).to(device)


def flush_payload(body: torch.Tensor, count: int, p: int) -> torch.Tensor:
    """The (p, W) float32 payload of a FLUSH body of `count` requests."""
    return body[8 * count:].view(torch.float32).view(p, -1)


def unpack_flush(msg: Message, p: int) -> Tuple[List[int], torch.Tensor]:
    """(widths, payload (p, W)) of a FLUSH message."""
    widths = msg.body[:8 * msg.meta].view(torch.int64).tolist()
    payload = flush_payload(msg.body, msg.meta, p)
    if payload.shape[1] != sum(widths):
        raise RuntimeError(f"pump: FLUSH of widths summing to "
                           f"{sum(widths)} carried {payload.shape[1]} "
                           f"columns")
    return widths, payload


# -- SWAP --------------------------------------------------------------------

def pack_swap(model: FittedModel, version: Optional[int],
              batcher_widths: Optional[Sequence[int]],
              scheduler_widths: Optional[Sequence[int]], device
              ) -> Tuple[int, torch.Tensor]:
    """(meta, body) of a SWAP message: the JSON's byte count, and the JSON
    then every leaf's bytes as one uint8 tensor on `device`."""
    layout, parts, at = [], [], 0
    for name in model._fields[1:]:
        leaf = getattr(model, name)
        if leaf is None:
            continue
        raw = leaf.detach().contiguous().reshape(-1).view(torch.uint8)
        layout.append([name, str(leaf.dtype).split(".")[-1],
                       list(leaf.shape), at, int(raw.numel())])
        parts.append(raw.to(device))
        pad = _padded(raw.numel()) - raw.numel()
        if pad:
            parts.append(torch.zeros(pad, dtype=torch.uint8, device=device))
        at += raw.numel() + pad
    text = json.dumps({
        "spec": dataclasses.asdict(model.spec), "version": version,
        "batcher_widths": (None if batcher_widths is None
                           else [int(w) for w in batcher_widths]),
        "scheduler_widths": (None if scheduler_widths is None
                             else [int(w) for w in scheduler_widths]),
        "leaves": layout}).encode()
    blob = np.zeros(_padded(len(text)), np.uint8)
    blob[:len(text)] = np.frombuffer(text, np.uint8)
    body = torch.cat([torch.from_numpy(blob).to(device)] + parts)
    return len(text), body


def unpack_swap(msg: Message) -> Tuple[
        FittedModel, Optional[int], Optional[List[int]], Optional[List[int]]]:
    """(model, version, batcher widths, scheduler widths) of a SWAP: the
    leaves bit-equal to rank 0's, on the device the body came to."""
    start = _padded(msg.meta)
    meta = json.loads(msg.body[:msg.meta].cpu().numpy().tobytes())
    leaves = {}
    for name, dtype, shape, at, nbytes in meta["leaves"]:
        raw = msg.body[start + at:start + at + nbytes]
        leaves[name] = raw.view(getattr(torch, dtype)).reshape(
            shape).clone()
    model = FittedModel(spec=ClusteringSpec(**meta["spec"]), **leaves)
    return (model, meta["version"], meta["batcher_widths"],
            meta["scheduler_widths"])
