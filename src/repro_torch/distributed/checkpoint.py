"""Checkpoints on disk: atomic commits, async writes, the JAX layout.

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
paths ("['X_train']", "[0]"), `dtypes` numpy dtype names. Restoring onto
a mesh waits for the torch.distributed slice of the port.
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


def to_host(leaf) -> np.ndarray:
    """A leaf as a numpy array on the host."""
    if isinstance(leaf, torch.Tensor):
        return leaf.detach().cpu().numpy()
    return np.asarray(leaf)


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
        "dtypes": [str(leaf.dtype) for leaf in host_leaves],
    }

    def write():
        if tmp.exists():
            shutil.rmtree(tmp)
        tmp.mkdir(parents=True)
        for i, leaf in enumerate(host_leaves):
            np.save(tmp / f"leaf_{i}.npy", leaf)
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


def restore_checkpoint(ckpt_dir: str, state_like: Any,
                       step: Optional[int] = None) -> Tuple[Any, int]:
    """Restore into the structure of `state_like`: a tensor leaf comes
    back as a tensor of its dtype on its device, any other leaf as a
    numpy array of its dtype."""
    path, step = _step_dir(ckpt_dir, step)
    manifest = json.loads((path / "manifest.json").read_text())
    likes = [leaf for _, leaf in _flatten(state_like)]
    n = len(manifest["shapes"])
    if n != len(likes):
        raise ValueError(f"checkpoint has {n} leaves, expected {len(likes)}")
    out = []
    for i, like in enumerate(likes):
        arr = np.load(path / f"leaf_{i}.npy")
        if list(arr.shape) != list(like.shape):
            raise ValueError(f"leaf {i}: shape {arr.shape} != "
                             f"{tuple(like.shape)}")
        if isinstance(like, torch.Tensor):
            out.append(torch.as_tensor(arr).to(like.device, like.dtype))
        else:
            out.append(arr.astype(np.asarray(like).dtype, copy=False))
    return _unflatten(state_like, iter(out)), step
