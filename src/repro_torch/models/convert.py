"""Carry the JAX package's LM weights into the port's models.

`lm_from_jax(cfg, params_np, device)` takes `jax.tree.map(np.asarray,
params)` of `repro.models.lm.init_lm(key, cfg, tp)`: a nested dict of
numpy arrays whose "layers" leaves are stacked on a leading n_layers
axis. It unstacks them into the port's nn.ModuleList. `rg_from_jax`
does the same for `repro.models.rglru.init_rg`'s tree: "supers" holds
one entry per position of the layer pattern ("0_R", "1_R", "2_A"), each
stacked on n_super, and "rem" the remainder layers, unstacked; they go
into the port's ModuleList in `_layer_list`'s order. `rwkv_from_jax`
takes `repro.models.rwkv6.init_rwkv`'s tree, stacked as init_lm's, and
`whisper_from_jax` `repro.models.whisper.init_whisper`'s, whose
"enc_layers" and "dec_layers" are each stacked on a leading axis.
Both packages keep the (in, out) layout, so nothing is transposed;
q_norm / k_norm, the f32 router, the f32 `lam` and RWKV's f32 `mu_*`,
`w0` and `u` come across as they are. A bf16 array
(ml_dtypes' bfloat16) is carried bit for bit through its uint16 view.

`decayed_names(model)` reads the same layout for the optimizer: JAX's
AdamW decays a leaf of ndim >= 2, and a stacked leaf has one more
dimension than the port's tensor (every per-layer norm scale is decayed
there; the final norm and recurrentgemma's unstacked remainder layers'
vectors are not). `jax_leaves(model)` gives each parameter's place in
JAX's tree (its keys and row), which the sharding rules key off, and
`jax_order(model)` the parameter names in `jax.tree.flatten`'s order, in
which the sketched gradients flatten a gradient.
"""
from __future__ import annotations

from typing import (Callable, Dict, FrozenSet, List, Mapping, Optional,
                    Tuple, Union)

import numpy as np
import torch
from torch import nn

from repro_torch.models.config import ArchConfig
from repro_torch.device import resolve_device
from repro_torch.models.lm import LM
from repro_torch.models.rglru import RG, superblocks
from repro_torch.models.rwkv6 import RWKV
from repro_torch.models.whisper import Whisper

# (the ModuleList's name, index) -> (the keys of the entry's subtree in
# JAX's tree, its row there or None when the entry is not stacked)
Layer = Callable[[str, int], Tuple[Tuple[Union[str, int], ...],
                                   Optional[int]]]


def _tensor(a: np.ndarray) -> torch.Tensor:
    a = np.array(a)                  # a writable copy (JAX's are read-only)
    if a.dtype.name == "bfloat16":
        return torch.from_numpy(a.view(np.uint16)).view(torch.bfloat16)
    return torch.from_numpy(a)


def _where(name: str, layer: Layer) -> Tuple[Tuple, Optional[int]]:
    """(JAX's keys, row or None) of one of the port's parameter names: the
    norm modules' ".weight" is the bare array there, and
    "<list>.<i>.<path>" (a top-level ModuleList: "layers", "enc_layers",
    "dec_layers") is <path> in the subtree `layer` gives for entry i, at
    its row."""
    parts = name.split(".")
    if parts[-1] == "weight":
        parts = parts[:-1]
    if len(parts) < 2 or not parts[1].isdigit():
        return (parts[0],), None
    keys, row = layer(parts[0], int(parts[1]))
    return keys + tuple(parts[2:]), row


def _leaf(params: Mapping, name: str, layer: Layer) -> np.ndarray:
    """The JAX array behind one of the port's parameter names."""
    keys, row = _where(name, layer)
    node = params
    for key in keys:
        node = node[key]
    return node if row is None else node[row]


@torch.no_grad()
def _fill(model: nn.Module, params_np: Mapping, layer: Layer) -> nn.Module:
    for name, p in model.named_parameters():
        src = _tensor(_leaf(params_np, name, layer))
        if src.shape != p.shape or src.dtype != p.dtype:
            raise ValueError(f"{name}: JAX gives {tuple(src.shape)} "
                             f"{src.dtype}, the port holds "
                             f"{tuple(p.shape)} {p.dtype}")
        p.copy_(src)
    return model


def _stacked(key: str, i: int) -> Tuple[Tuple[str], int]:
    return (key,), i


def _rg_layer(cfg: ArchConfig) -> Layer:
    """init_rg's tree: "supers" holds one entry per pattern position,
    stacked on n_super; "rem" the remainder layers, unstacked."""
    pat, n_super, _ = superblocks(cfg)
    stacked = n_super * len(pat)

    def layer(key, i):
        if i < stacked:
            s, j = divmod(i, len(pat))
            return ("supers", f"{j}_{pat[j]}"), s
        return ("rem", i - stacked), None
    return layer


def jax_leaves(model: nn.Module) -> Dict[str, Tuple[Tuple, Optional[int]]]:
    """{parameter name: (the keys of its leaf in JAX's tree, its row there
    or None when the leaf is not stacked)}, in named_parameters' order."""
    layer = _rg_layer(model.cfg) if isinstance(model, RG) else _stacked
    return {name: _where(name, layer) for name, _ in model.named_parameters()}


def jax_order(model: nn.Module) -> List[str]:
    """The parameter names in `jax.tree.flatten` order of JAX's tree: its
    leaves by their sorted dict keys (list entries by index), a stacked
    leaf's rows in order. Concatenating the parameters flattened in this
    order gives JAX's flattened vector element for element."""
    where = jax_leaves(model)
    return sorted(where, key=lambda name: (where[name][0],
                                           where[name][1] or 0))


def decayed_names(model: nn.Module) -> FrozenSet[str]:
    """The names of the parameters that JAX's adamw_update decays: those
    whose leaf in JAX's tree has ndim >= 2 (optimizer.py:53)."""
    where = jax_leaves(model)
    return frozenset(name for name, p in model.named_parameters()
                     if p.dim() + (where[name][1] is not None) >= 2)


def _from_jax(cls, cfg: ArchConfig, params_np: Mapping, device, tp: int,
              layer: Layer = _stacked) -> nn.Module:
    model = cls(cfg, tp, device="meta").to_empty(
        device=resolve_device(device))
    return _fill(model, params_np, layer)


def lm_from_jax(cfg: ArchConfig, params_np: Mapping, device=None,
                tp: int = 1) -> LM:
    """The port's LM with the JAX params' function (`tp` as given to
    init_lm; it sets the padded vocabulary)."""
    return _from_jax(LM, cfg, params_np, device, tp)


def rwkv_from_jax(cfg: ArchConfig, params_np: Mapping, device=None,
                  tp: int = 1) -> RWKV:
    """The port's RWKV with the JAX params' function (`tp` as given to
    init_rwkv)."""
    return _from_jax(RWKV, cfg, params_np, device, tp)


def whisper_from_jax(cfg: ArchConfig, params_np: Mapping, device=None,
                     tp: int = 1) -> Whisper:
    """The port's Whisper with the JAX params' function (`tp` as given to
    init_whisper)."""
    return _from_jax(Whisper, cfg, params_np, device, tp)


def rg_from_jax(cfg: ArchConfig, params_np: Mapping, device=None,
                tp: int = 1) -> RG:
    """The port's RG with the JAX params' function (`tp` as given to
    init_rg)."""
    return _from_jax(RG, cfg, params_np, device, tp, _rg_layer(cfg))
