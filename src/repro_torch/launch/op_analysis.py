"""Op-level cost analysis of one call: the port's stand-in for
repro/launch/hlo_analysis.py.

JAX's dry run parses the compiled HLO text, weighs each computation by
the trip counts of the `while` loops around it and sums dot flops, HBM
traffic and collective bytes. The port has no HLO: eager PyTorch runs
every loop trip as it goes, so the weighting comes for free, and
`analyze(fn, *args, **kwargs)` counts the ATen operations that `fn`
dispatches, under a TorchDispatchMode inside the caller's FakeTensorMode
(or on real tensors), with JAX's keys and meanings:

  - flops: the products' flops (mm, addmm, bmm, baddbmm, convolution,
    scaled dot-product attention and their backward forms) by
    torch.utils.flop_counter's formulas; elementwise work is left out, as
    JAX's counts dot flops only;
  - traffic_bytes: the operand and output bytes of every op that is not a
    view (an eager op is one HBM round trip, the assumption JAX's makes
    for a top-level fusion); allocations (`empty`) and collectives move
    none;
  - collective_bytes / collective_counts by JAX's five kinds, each sized
    by the collective's result (the gathered tensor of an all-gather, the
    chunk of a reduce-scatter), and collective_total. A c10d op outside
    the five (broadcast, barrier, send, recv) counts under its own name;
  - memory: the live bytes of the call's device storages. Each storage
    counts once, views included, from the op that makes it until its last
    reference goes (a weak reference's callback). argument: the bytes
    live when the call starts (its arguments' storages, nn.Modules'
    parameters and buffers included, and any older storage an op reads);
    output: the bytes the call returns that were not live before; temp:
    the peak less argument; peak: argument + temp, as JAX's peak_mb is.
    Every storage counts: in the dry run each one is a fake tensor that
    stands for the card's memory.
"""
from __future__ import annotations

import weakref
from typing import Any, Callable, Dict

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_flatten
from torch.utils.flop_counter import flop_registry
from torch.utils.weak import WeakIdKeyDictionary

_COLLECTIVES = ("all-gather", "all-reduce", "reduce-scatter", "all-to-all",
                "collective-permute")

# c10d ops (in place: the first argument holds the results) and
# functional collectives (the return value is the result), by JAX's kind.
_KIND = {
    "allreduce_": "all-reduce", "allreduce_coalesced_": "all-reduce",
    "all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
    "allgather_": "all-gather", "_allgather_base_": "all-gather",
    "allgather_coalesced_": "all-gather",
    "allgather_into_tensor_coalesced_": "all-gather",
    "all_gather_into_tensor": "all-gather",
    "all_gather_into_tensor_coalesced": "all-gather",
    "reduce_scatter_": "reduce-scatter",
    "_reduce_scatter_base_": "reduce-scatter",
    "reduce_scatter_tensor_coalesced_": "reduce-scatter",
    "reduce_scatter_tensor": "reduce-scatter",
    "reduce_scatter_tensor_coalesced": "reduce-scatter",
    "alltoall_": "all-to-all", "alltoall_base_": "all-to-all",
    "all_to_all_single": "all-to-all",
}
_COLLECTIVE_NAMESPACES = ("c10d", "_c10d_functional")
# Ops that alias their input without the schema's view mark, and
# allocations that write nothing.
_NO_TRAFFIC = {"_unsafe_view", "empty", "empty_strided", "empty_like",
               "wait_tensor"}
# A constant made in the call (torch.tensor(...)) enters a mode through
# these: their input is the host's copy, their output the new tensor.
_LIFT = {"lift_fresh", "lift_fresh_copy"}


def _tensors(tree) -> list:
    return [x for x in tree_flatten(tree)[0] if isinstance(x, torch.Tensor)]


def _nbytes(tree) -> int:
    return sum(t.numel() * t.element_size() for t in _tensors(tree))


class _Live:
    """The storages alive in the call, each counted once."""

    def __init__(self):
        self.known = WeakIdKeyDictionary()   # storage -> its weak reference
        self.older = WeakIdKeyDictionary()   # storages that predate the call
        self.bytes = 0
        self.peak = 0
        self.argument = 0

    def _free(self, nbytes: int) -> Callable:
        def gone(_ref):
            self.bytes -= nbytes
        return gone

    def add(self, t: torch.Tensor, older: bool = False) -> None:
        """Count t's storage if it is new; `older`: it predates the call,
        so it counts in argument and in every moment's live bytes."""
        st = t.untyped_storage()
        if st in self.known:
            return
        nbytes = st.nbytes()
        self.known[st] = weakref.ref(st, self._free(nbytes))
        self.bytes += nbytes
        if older:
            self.older[st] = True
            self.argument += nbytes
            self.peak += nbytes
        self.peak = max(self.peak, self.bytes)

    def new_bytes(self, tree) -> int:
        """The bytes of the device storages in `tree` that do not predate
        the call, each storage once."""
        seen = WeakIdKeyDictionary()
        total = 0
        for t in _tensors(_expand_modules(tree)):
            st = t.untyped_storage()
            if st in seen or st in self.older:
                continue
            seen[st] = True
            total += st.nbytes()
        return total


class OpCounter(TorchDispatchMode):
    """Counts every op dispatched under it (see the module docstring);
    the storages of `trees` (tensors, nn.Modules, containers) are live
    when it starts."""

    def __init__(self, *trees):
        super().__init__()
        self.flops = 0
        self.traffic = 0
        self.coll_bytes = {kind: 0 for kind in _COLLECTIVES}
        self.coll_counts = {kind: 0 for kind in _COLLECTIVES}
        self.live = _Live()
        for t in _tensors(_expand_modules(trees)):
            self.live.add(t, older=True)

    def _collective(self, func, args, out) -> None:
        name = func._overloadpacket.__name__
        kind = _KIND.get(name, name)
        result = args[0] if func.namespace == "c10d" else out
        self.coll_bytes[kind] = self.coll_bytes.get(kind, 0) + \
            _nbytes(result)
        self.coll_counts[kind] = self.coll_counts.get(kind, 0) + 1

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        packet = func._overloadpacket
        name = packet.__name__
        if name not in _LIFT:            # an input not seen is older
            for t in _tensors((args, kwargs)):
                self.live.add(t, older=True)
        out = func(*args, **kwargs)
        if func.namespace in _COLLECTIVE_NAMESPACES:
            self._collective(func, args, out)
        else:
            if packet in flop_registry:
                self.flops += flop_registry[packet](*args, **kwargs,
                                                    out_val=out)
            if not func.is_view and name not in _NO_TRAFFIC:
                self.traffic += _nbytes((args, kwargs)) + _nbytes(out)
        for t in _tensors(out):
            self.live.add(t)
        return out


def _expand_modules(tree):
    """`tree` with each nn.Module replaced by its parameters and buffers
    (a NamedTuple's or dict's modules too)."""
    if isinstance(tree, torch.nn.Module):
        return list(tree.parameters()) + list(tree.buffers())
    if isinstance(tree, (list, tuple)):
        return [_expand_modules(x) for x in tree]
    if isinstance(tree, dict):
        return {k: _expand_modules(v) for k, v in tree.items()}
    return tree


def analyze(fn: Callable, *args, **kwargs) -> Dict[str, Any]:
    """Run fn(*args, **kwargs) under an OpCounter and return JAX's keys of
    hlo_analysis.analyze (flops, traffic_bytes, collective_bytes,
    collective_counts, collective_total) plus `memory` (argument, output,
    temp and peak bytes) and `result`, what fn returned."""
    counter = OpCounter(args, kwargs)
    with counter:
        result = fn(*args, **kwargs)
    live = counter.live
    return {
        "flops": float(counter.flops),
        "traffic_bytes": float(counter.traffic),
        "collective_bytes": {k: float(v)
                             for k, v in counter.coll_bytes.items()},
        "collective_counts": {k: float(v)
                              for k, v in counter.coll_counts.items()},
        "collective_total": float(sum(counter.coll_bytes.values())),
        "memory": {"argument": live.argument,
                   "output": live.new_bytes(result),
                   "temp": live.peak - live.argument, "peak": live.peak},
        "result": result,
    }
