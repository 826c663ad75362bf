"""Carry the JAX package's LM weights into the port's LM.

`lm_from_jax(cfg, params_np, device)` takes `jax.tree.map(np.asarray,
params)` of `repro.models.lm.init_lm(key, cfg, tp)`: a nested dict of
numpy arrays whose "layers" leaves are stacked on a leading n_layers
axis. It unstacks them into the port's nn.ModuleList. Both packages keep
the (in, out) layout, so nothing is transposed; q_norm / k_norm and the
f32 router come across as they are. A bf16 array (ml_dtypes' bfloat16)
is carried bit for bit through its uint16 view.
"""
from __future__ import annotations

from typing import Mapping

import numpy as np
import torch

from repro_torch.models.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                  # a writable copy (JAX's are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _leaf(params: Mapping, name: str) -> np.ndarray:
    """The JAX array behind one of the port's parameter names: the norm
    modules' ".weight" is the bare array there, and "layers.<i>.<path>"
    is row i of the stacked "layers" leaf at <path>."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]
    if parts[0] != "layers":
        return params[parts[0]]
    node = params["layers"]
    for key in parts[2:]:
        node = node[key]
    return node[int(parts[1])]


@torch.no_grad()
def lm_from_jax(cfg: ArchConfig, params_np: Mapping, device=None,
                tp: int = 1) -> LM:
    """The port's LM with the JAX params' function (`tp` as given to
    init_lm; it sets the padded vocabulary)."""
    model = LM(cfg, tp, device="meta").to_empty(device=resolve_device(device))
    for name, p in model.named_parameters():
        src = _tensor(_leaf(params_np, name))
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(f"{name}: JAX gives {tuple(src.shape)} "
                             f"{src.dtype}, the port holds "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(src)
    return model
