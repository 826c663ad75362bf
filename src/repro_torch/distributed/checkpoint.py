"""Checkpoints on disk: atomic commits, async writes, retention, the JAX
layout, and restore onto a mesh.

Layout (the JAX package's repro.distributed.checkpoint, so either package
reads what the other wrote):

  <dir>/step_<N>.tmp/      while writing
  <dir>/step_<N>/          after the atomic rename (os.replace)
      manifest.json        step, time, paths, shapes, dtypes (JAX also
                           writes its treedef's repr, which no reader
                           uses; the port leaves it out)
      leaf_<i>.npy         one file per leaf, in leaf order

A state is a tree of dicts (keys in sorted order, as JAX flattens them),
lists and tuples over tensors or numpy arrays. `paths` are JAX keystr
paths ("['X_train']", "[0]"), `dtypes` numpy dtype names.

A bf16 leaf is written as JAX writes one (ml_dtypes' bfloat16 through
np.save): its raw 2-byte words under the header descr '<V2', which
np.load reads back as a `|V2` array, and "bfloat16" in `dtypes`. The
words go through torch's int16 view, so no numpy bfloat16 type is needed.
On restore a `|V2` leaf, or one whose manifest dtype is "bfloat16", is
viewed back as bf16 bit for bit before the cast to the like's dtype.

Restoring onto a mesh (restore_checkpoint's mesh= and pspecs=): pspecs
mirrors the state with one placement per leaf, a
torch.distributed.tensor Shard(dim) or Replicate() for the mesh's first
dim (the others replicate), or a tuple of them, one per mesh dim. A sharded
leaf comes back as this
rank's local chunk, split as Shard(dim) splits it (torch.chunk: equal
chunks but the last, which may be short or empty), on the mesh's device.
Every rank reads the files itself: no collective runs, so a checkpoint
written on any mesh restores onto any other (the elastic re-mesh of
distributed/fault.py).
"""
from __future__ import annotations

import json
import os
import pathlib
import shutil
import threading
import time
from typing import Any, Dict, Iterator, List, Optional, Tuple

import numpy as np
import torch


def _flatten(tree, path: str = "") -> Iterator[Tuple[str, Any]]:
    """(keystr path, leaf) in JAX's flattening order; None has no leaves."""
    if tree is None:
        return
    if isinstance(tree, dict):
        for key in sorted(tree):
            yield from _flatten(tree[key], f"{path}[{key!r}]")
    elif isinstance(tree, (list, tuple)):
        for i, sub in enumerate(tree):
            yield from _flatten(sub, f"{path}[{i}]")
    else:
        yield path, tree


def _unflatten(like, leaves: Iterator):
    if like is None:
        return None
    if isinstance(like, dict):
        return {key: _unflatten(like[key], leaves) for key in sorted(like)}
    if isinstance(like, (list, tuple)):
        return type(like)(_unflatten(sub, leaves) for sub in like)
    return next(leaves)


_BF16 = "bfloat16"
_BF16_DESCR = "<V2"             # ml_dtypes' bfloat16 in an .npy header


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host, copied: a tensor the caller
    updates in place (the port's train state) does not change under an
    asynchronous write. A bf16 tensor comes back as its raw words, a
    `|V2` array."""
    if isinstance(leaf, torch.Tensor):
        t = leaf.detach()
        host = t.cpu() if t.device.type != "cpu" else t.clone()
        if host.dtype == torch.bfloat16:
            return host.view(torch.int16).numpy().view(np.dtype("V2"))
        return host.numpy()
    return np.asarray(leaf)


def _dtype_name(leaf, host: np.ndarray) -> str:
    if isinstance(leaf, torch.Tensor) and leaf.dtype == torch.bfloat16:
        return _BF16
    return str(host.dtype)


def _save_leaf(path: pathlib.Path, arr: np.ndarray, dtype: str) -> None:
    """np.save, but a bf16 leaf under JAX's header descr '<V2' (np.save
    would write '|V2' for the void words)."""
    if dtype != _BF16:
        np.save(path, arr)
        return
    header = np.lib.format.header_data_from_array_1_0(arr)
    header["descr"] = _BF16_DESCR
    with open(path, "wb") as f:
        np.lib.format.write_array_header_1_0(f, header)
        f.write(np.ascontiguousarray(arr).tobytes())


def _as_tensor(arr: np.ndarray, dtype: str) -> torch.Tensor:
    """A loaded leaf as a tensor; bf16 words (a `|V2` array, or a leaf the
    manifest calls bfloat16) viewed back as bf16 bit for bit."""
    if dtype == _BF16 or (arr.dtype.kind == "V" and arr.dtype.itemsize == 2):
        words = np.ascontiguousarray(arr).view(np.int16)
        return torch.from_numpy(words).view(torch.bfloat16)
    return torch.as_tensor(arr)


def save_checkpoint(ckpt_dir: str, step: int, state: Any,
                    blocking: bool = True) -> str:
    """Write `state` atomically; returns the final path.

    blocking=False copies the leaves to the host now and writes the files
    on a daemon thread (wait_for_async_saves joins it).
    """
    base = pathlib.Path(ckpt_dir)
    base.mkdir(parents=True, exist_ok=True)
    tmp = base / f"step_{step}.tmp"
    final = base / f"step_{step}"
    flat = list(_flatten(state))
    host_leaves = [to_host(leaf) for _, leaf in flat]
    manifest = {
        "step": step,
        "time": time.time(),
        "paths": [path for path, _ in flat],
        "shapes": [list(leaf.shape) for leaf in host_leaves],
        "dtypes": [_dtype_name(leaf, host) for (_, leaf), host in
                   zip(flat, host_leaves)],
    }

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, (leaf, dtype) in enumerate(zip(host_leaves,
                                              manifest["dtypes"])):
            _save_leaf(tmp / f"leaf_{i}.npy", leaf, dtype)
        (tmp / "manifest.json").write_text(json.dumps(manifest))
        if final.exists():
            shutil.rmtree(final)
        os.replace(tmp, final)

    if blocking:
        write()
    else:
        t = threading.Thread(target=write, daemon=True)
        t.start()
        _ASYNC_THREADS.append(t)
    return str(final)


_ASYNC_THREADS: List[threading.Thread] = []


def wait_for_async_saves() -> None:
    for t in _ASYNC_THREADS:
        t.join()
    _ASYNC_THREADS.clear()


def latest_step(ckpt_dir: str) -> Optional[int]:
    base = pathlib.Path(ckpt_dir)
    if not base.exists():
        return None
    steps = [int(p.name[5:]) for p in base.iterdir()
             if p.is_dir() and p.name.startswith("step_")
             and not p.name.endswith(".tmp")
             and (p / "manifest.json").exists()]
    return max(steps) if steps else None


def _step_dir(ckpt_dir: str, step: Optional[int]) -> Tuple[pathlib.Path,
                                                           int]:
    step = step if step is not None else latest_step(ckpt_dir)
    if step is None:
        raise FileNotFoundError(f"no checkpoint under {ckpt_dir}")
    return pathlib.Path(ckpt_dir) / f"step_{step}", step


def read_manifest(ckpt_dir: str, step: Optional[int] = None) -> Dict:
    """The manifest (paths, shapes, dtypes) without loading any leaf."""
    path, _ = _step_dir(ckpt_dir, step)
    return json.loads((path / "manifest.json").read_text())


def _placements(spec, ndim: int) -> tuple:
    """A leaf's placements, one per mesh dim: a single placement holds for
    the mesh's first dim, with Replicate() on the others."""
    from torch.distributed.tensor import Placement, Replicate
    specs = (tuple(spec) if isinstance(spec, (tuple, list))
             else (spec,) + (Replicate(),) * (ndim - 1))
    if len(specs) != ndim or not all(isinstance(p, Placement)
                                     for p in specs):
        raise ValueError(f"a leaf's placement must be {ndim} of Shard(dim)"
                         f" / Replicate(), got {spec!r}")
    return tuple(specs)


def _spec_leaves(pspecs, ndim: int) -> List[tuple]:
    """pspecs' leaves in the state's order: a placement, or a tuple of
    placements (one per mesh dim), is a leaf."""
    from torch.distributed.tensor import Placement

    def walk(tree):
        if isinstance(tree, dict):
            for key in sorted(tree):
                yield from walk(tree[key])
        elif isinstance(tree, (list, tuple)) and not (
                tree and all(isinstance(p, Placement) for p in tree)):
            for sub in tree:
                yield from walk(sub)
        else:
            yield _placements(tree, ndim)

    return list(walk(pspecs))


def local_chunk(t: torch.Tensor, mesh, placements: tuple) -> torch.Tensor:
    """This rank's chunk of the whole tensor `t` under `placements` (one
    per mesh dim): Shard(dim) keeps chunk i of torch.chunk along dim at
    coordinate i (an empty slice past the last chunk), Replicate() all."""
    from torch.distributed.tensor import Replicate, Shard
    coord = mesh.get_coordinate()
    for i, place in enumerate(placements):
        if isinstance(place, Replicate):
            continue
        if not isinstance(place, Shard):
            raise ValueError(f"cannot restore onto placement {place!r}")
        dim = place.dim % max(t.dim(), 1)
        chunks = torch.chunk(t, mesh.size(i), dim=dim)
        t = (chunks[coord[i]] if coord[i] < len(chunks)
             else t.narrow(dim, t.shape[dim], 0))
    return t.contiguous()


def _mesh_device(mesh) -> torch.device:
    if mesh.device_type == "cuda":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device(mesh.device_type)


def restore_checkpoint(ckpt_dir: str, state_like: Any,
                       step: Optional[int] = None, mesh=None,
                       pspecs: Any = None) -> Tuple[Any, int]:
    """Restore into the structure of `state_like`: a tensor leaf comes
    back as a tensor of its dtype on its device, any other leaf as a
    numpy array of its dtype. With (mesh, pspecs) every leaf comes back
    as a tensor of the like's dtype on the mesh's device, a sharded one
    as this rank's chunk (see the module docstring)."""
    path, step = _step_dir(ckpt_dir, step)
    manifest = json.loads((path / "manifest.json").read_text())
    likes = [leaf for _, leaf in _flatten(state_like)]
    n = len(manifest["shapes"])
    if n != len(likes):
        raise ValueError(f"checkpoint has {n} leaves, expected {len(likes)}")
    specs = [None] * n
    if mesh is not None and pspecs is not None:
        specs = _spec_leaves(pspecs, mesh.ndim)
        if len(specs) != n:
            raise ValueError(f"pspecs has {len(specs)} leaves, the state "
                             f"{n}")
    out = []
    dtypes = manifest["dtypes"]
    for i, (like, spec) in enumerate(zip(likes, specs)):
        arr = np.load(path / f"leaf_{i}.npy")
        if list(arr.shape) != list(like.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        if spec is not None:
            dtype = (like.dtype if isinstance(like, torch.Tensor)
                     else torch.from_numpy(
                         np.zeros((), np.asarray(like).dtype)).dtype)
            t = _as_tensor(arr, dtypes[i]).to(dtype)
            out.append(local_chunk(t, mesh, spec).to(_mesh_device(mesh)))
        elif isinstance(like, torch.Tensor):
            out.append(_as_tensor(arr, dtypes[i]).to(like.device,
                                                      like.dtype))
        else:
            out.append(arr.astype(np.asarray(like).dtype, copy=False))
    return _unflatten(state_like, iter(out)), step


class CheckpointManager:
    """Interval and retention policy around save / restore: a save every
    `save_every` steps, the newest `keep` kept."""

    def __init__(self, ckpt_dir: str, save_every: int = 100,
                 keep: int = 3, async_saves: bool = True):
        self.dir = ckpt_dir
        self.save_every = save_every
        self.keep = keep
        self.async_saves = async_saves

    def maybe_save(self, step: int, state: Any) -> Optional[str]:
        if step % self.save_every:
            return None
        path = save_checkpoint(self.dir, step, state,
                               blocking=not self.async_saves)
        self._gc()
        return path

    def _gc(self) -> None:
        base = pathlib.Path(self.dir)
        steps = sorted(int(p.name[5:]) for p in base.iterdir()
                       if p.is_dir() and p.name.startswith("step_")
                       and not p.name.endswith(".tmp"))
        for s in steps[:-self.keep]:
            shutil.rmtree(base / f"step_{s}", ignore_errors=True)

    def restore_latest(self, state_like: Any, mesh=None,
                       pspecs: Any = None) -> Tuple[Any, int]:
        return restore_checkpoint(self.dir, state_like, mesh=mesh,
                                  pspecs=pspecs)
