"""Shared by the LM tests: JAX's weights in both packages, and the port's
weights back in JAX's layout (stacked layers, numpy leaves)."""
import jax
import numpy as np
import torch

from repro.models import lm as jlm
from repro.models import rglru as jrg
from repro.models import rwkv6 as jrwkv
from repro.models import whisper as jwh
from repro_torch.models import RG
from repro_torch.models.convert import (lm_from_jax, rg_from_jax,
                                        rwkv_from_jax, whisper_from_jax)
from repro_torch.models.rglru import superblocks

ARCHS = ("phi4-mini-3.8b", "qwen3-14b", "nemotron-4-340b",
         "command-r-plus-104b", "mixtral-8x7b", "dbrx-132b", "pixtral-12b")
# The families the port serves: the seven above, the hybrid, the ssm and
# the encoder-decoder, all ten configs.
SERVED = ARCHS + ("recurrentgemma-2b", "rwkv6-1.6b", "whisper-large-v3")
# Per family: JAX's init and the port's converter of its tree.
_INIT = {"hybrid": (jrg.init_rg, rg_from_jax),
         "ssm": (jrwkv.init_rwkv, rwkv_from_jax),
         "encdec": (jwh.init_whisper, whisper_from_jax)}
# Per family: the cache's tensors (besides "pos").
CACHE_KEYS = {"hybrid": ("h", "conv", "k", "v"), "ssm": ("s", "tm", "cm"),
              "encdec": ("k", "v", "xk", "xv")}


def cache_keys(cfg):
    return CACHE_KEYS.get(cfg.family, ("k", "v"))


def port_of(pcfg, params):
    """The port's LM, RG, RWKV or Whisper on the CPU holding the JAX
    params tree `params` (init's layout at tp = 1)."""
    convert = _INIT.get(pcfg.family, (None, lm_from_jax))[1]
    return convert(pcfg, jax.tree.map(np.asarray, params), "cpu")


def jax_and_port(jcfg, pcfg, seed=0):
    """(JAX params, the port's LM, RG, RWKV or Whisper on the CPU with the
    same weights)."""
    init = _INIT.get(jcfg.family, (jlm.init_lm, None))[0]
    params = init(jax.random.PRNGKey(seed), jcfg, tp=1)
    return params, port_of(pcfg, params)


def _rg_params_of(model, named):
    """An RG's weights as init_rg's tree: "supers" stacked per pattern
    position, "rem" a list."""
    pat, n_super, rem = superblocks(model.cfg)
    stacked = n_super * len(pat)
    out = {"supers": {}, "rem": [{} for _ in rem]}
    for name, p in named:
        parts = name.split(".")
        if parts[-1] == "weight":
            parts = parts[:-1]
        arr = p.detach().cpu().numpy()
        if parts[0] != "layers":
            out[parts[0]] = arr
            continue
        i = int(parts[1])
        if i < stacked:
            j = i % len(pat)
            node = out["supers"].setdefault(f"{j}_{pat[j]}", {})
        else:
            node = out["rem"][i - stacked]
        for key in parts[2:-1]:
            node = node.setdefault(key, {})
        if i < stacked:
            node.setdefault(parts[-1], []).append(arr)
        else:
            node[parts[-1]] = arr

    def stack(node):
        return {k: stack(v) if isinstance(v, dict) else np.stack(v)
                for k, v in node.items()}
    out["supers"] = stack(out["supers"])
    return out


def params_of(model, named=None):
    """The port's weights as JAX's params tree of numpy arrays: each
    top-level ModuleList ("layers", "enc_layers", "dec_layers") stacked
    on a leading axis. `named`: {parameter name: tensor} laid out in
    place of the weights (an optimizer's moments, a mask)."""
    pairs = (model.named_parameters() if named is None
             else [(n, named[n]) for n, _ in model.named_parameters()])
    if isinstance(model, RG):
        return _rg_params_of(model, pairs)
    out, lists = {}, set()
    for name, p in pairs:
        parts = name.split(".")
        if parts[-1] == "weight":
            parts = parts[:-1]
        arr = p.detach().cpu().numpy()
        if len(parts) < 2 or not parts[1].isdigit():
            out[parts[0]] = arr
            continue
        lists.add(parts[0])
        node = out.setdefault(parts[0], {})
        for key in parts[2:-1]:
            node = node.setdefault(key, {})
        node.setdefault(parts[-1], []).append(arr)

    def stack(node):
        return {k: stack(v) if isinstance(v, dict) else np.stack(v)
                for k, v in node.items()}
    for key in lists:
        out[key] = stack(out[key])
    return out


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
