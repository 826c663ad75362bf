"""Shared by the LM tests: JAX's weights in both packages, and the port's
weights back in JAX's layout (stacked layers, numpy leaves)."""
import jax
import numpy as np
import torch

from repro.models import lm as jlm
from repro_torch.models.convert import lm_from_jax

ARCHS = ("phi4-mini-3.8b", "qwen3-14b", "nemotron-4-340b",
         "command-r-plus-104b", "mixtral-8x7b", "dbrx-132b", "pixtral-12b")


def jax_and_port(jcfg, pcfg, seed=0):
    """(JAX params, the port's LM on the CPU with the same weights)."""
    params = jlm.init_lm(jax.random.PRNGKey(seed), jcfg, tp=1)
    model = lm_from_jax(pcfg, jax.tree.map(np.asarray, params), "cpu")
    return params, model


def params_of(model):
    """The port's weights as JAX's params tree of numpy arrays."""
    out = {"layers": {}}
    for name, p in model.named_parameters():
        parts = name.split(".")
        if parts[-1] == "weight":
            parts = parts[:-1]
        arr = p.detach().cpu().numpy()
        if parts[0] != "layers":
            out[parts[0]] = arr
            continue
        node = out["layers"]
        for key in parts[2:-1]:
            node = node.setdefault(key, {})
        node.setdefault(parts[-1], []).append(arr)

    def stack(node):
        return {k: stack(v) if isinstance(v, dict) else np.stack(v)
                for k, v in node.items()}
    out["layers"] = stack(out["layers"])
    return out


def np_of(t: torch.Tensor) -> np.ndarray:
    return t.detach().cpu().numpy()
