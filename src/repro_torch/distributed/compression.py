"""Sketched gradients with error feedback, and the quantized artifact
codecs (the port of repro/distributed/compression.py).

Sketched gradients (beyond the paper): the paper's SRHT Omega^T = R^T H D
compresses a gradient for data-parallel training. Each round draws D
(signs over n_pad = next_pow2(n)) and R (r' rows without replacement),
s = Omega^T g is what crosses the ranks (r' floats, not n), and
g_hat = Omega s = Omega Omega^T g is an orthogonal projection of g onto a
random r'-dim subspace; the residual g - g_hat is carried by error
feedback. The order of the flattened gradient is `jax.tree.flatten`'s
(`models.convert.jax_order`), so the port sketches JAX's vector element
for element.

Differences from JAX, each for memory at rwkv6-1.6b's n_pad = 2^31:
- JAX's PRNG is not reproduced: `sketch_params` draws from a
  torch.Generator, and every entry point also takes (signs, rows), so a
  caller (the parity tests) can hand in JAX's draws. The signs are int8
  +-1 (2 GB at 2^31, not 8.6 GB of f32), applied as exact +-1.0; the rows
  are drawn with memory in proportion to r', not n_pad (a randperm of
  2^31 on the card would take 17 GB).
- `compress` and `decompress` transform one (n_pad, 1) column through the
  fwht kernel (`fwht_op`; its plain version for a CPU tensor), not the
  SRHT form `srht_t_op`, whose plan grows with n_pad whatever r' is and
  is cached per rows tensor, which changes every round.
- The transform folds the gradient into the error-feedback vector in
  place and returns it as the new one (a second n-vector would not fit).

Codecs: the JAX package's, on host numpy arrays, bit for bit: bf16 is
stored as the uint16 pattern of the round-to-nearest-even bfloat16
(torch.bfloat16 rounds so too); int8 is round-half-even of x / scale with
scale = max|x| / 127, one float per leaf kept in the artifact's quantized
map.
"""
from __future__ import annotations

from typing import Callable, Dict, List, Mapping, Optional, Tuple, Union

import numpy as np
import torch
from torch import nn

from repro_torch.core.sketch import next_pow2
from repro_torch.kernels.fwht.ops import fwht_op
from repro_torch.launch.mesh import mesh_axis
from repro_torch.models.convert import jax_order

_QUANTIZED_DTYPES = ("bf16", "int8")


def _choice(generator: torch.Generator, n: int, k: int) -> torch.Tensor:
    """k distinct draws of range(n) in random order (int64, on the
    generator's device), uniform over the k-subsets, with memory in
    proportion to k: draw with replacement until k distinct values are in
    hand, then keep a random k of them (which is uniform: the distinct set
    is uniform given its size). Where k is a quarter of n or more a
    permutation of n costs no more."""
    dev = generator.device
    if 4 * k >= n:
        return torch.randperm(n, generator=generator, device=dev)[:k]
    got = torch.empty(0, dtype=torch.int64, device=dev)
    while got.numel() < k:
        need = k - got.numel()
        draw = torch.randint(0, n, (need + need // 2 + 64,),
                             generator=generator, device=dev)
        got = torch.unique(torch.cat([got, draw]))
        del draw
    keep = torch.randperm(got.numel(), generator=generator, device=dev)[:k]
    return got[keep]


def sketch_params(generator: torch.Generator, n: int,
                  r_prime: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(signs, rows) of a round's Omega = D H R for n entries, n padded to
    n_pad: signs (n_pad,) int8 +-1, rows (r',) int64 distinct in
    [0, n_pad), on the generator's device."""
    n_pad = next_pow2(n)
    if not 0 < r_prime <= n_pad:
        raise ValueError(f"r' must be in [1, n_pad = {n_pad}], got "
                         f"{r_prime}")
    signs = torch.randint(0, 2, (n_pad,), generator=generator,
                          device=generator.device, dtype=torch.int8)
    signs.mul_(2).sub_(1)
    return signs, _choice(generator, n_pad, r_prime)


def compress(vec: torch.Tensor, signs: torch.Tensor,
             rows: torch.Tensor) -> torch.Tensor:
    """s = Omega^T g = R^T H (D g).  vec: (n,) f32 -> (r',)."""
    n_pad = signs.shape[0]
    g = torch.zeros((n_pad, 1), dtype=vec.dtype, device=vec.device)
    g[:vec.shape[0], 0] = vec
    g[:, 0].mul_(signs)
    h = fwht_op(g)
    del g
    return h[rows, 0]


def decompress(s: torch.Tensor, signs: torch.Tensor, rows: torch.Tensor,
               n: int) -> torch.Tensor:
    """g_hat = Omega s = D H R s -> (n,), a view of an n_pad buffer."""
    n_pad = signs.shape[0]
    scat = torch.zeros((n_pad, 1), dtype=s.dtype, device=s.device)
    scat[rows, 0] = s
    h = fwht_op(scat)
    del scat
    out = h[:, 0]
    out.mul_(signs)
    return out[:n]


def _metas(model_or_params) -> List[Tuple[str, torch.Size, torch.dtype]]:
    """(name, shape, dtype) of each leaf in JAX's flattening order: a
    model's parameters by `jax_order`, a {name: tensor} dict by sorted
    name (how JAX flattens a dict)."""
    if isinstance(model_or_params, nn.Module):
        named = dict(model_or_params.named_parameters())
        names = jax_order(model_or_params)
    else:
        named = dict(model_or_params)
        names = sorted(named)
    return [(name, named[name].shape, named[name].dtype) for name in names]


def make_sketched_grad_transform(model_or_params, r_prime: int,
                                 axis: Optional[str] = None,
                                 mesh=None) -> Tuple[Callable, Callable]:
    """Returns (transform, init_ef) for the parameters of a model (or a
    {name: tensor} dict), read once here: names, shapes, dtypes, device.

    transform(grads, ef, key) -> (grads_hat, ef):
      1. v = flatten(grads) + ef, in f32, in JAX's order (into ef, in place)
      2. s = compress(v) with the round's (signs, rows): `key` is a
         torch.Generator to draw them from (sketch_params), or the pair
         itself. With `axis` (a dim of `mesh`), s is averaged over it
         (JAX's pmean): each rank's grads are its local mean, and only r'
         floats cross the ranks;
      3. g_hat = decompress(s); ef' = v - g_hat (into the same buffer).
    grads_hat: {name: tensor} in each parameter's dtype (JAX's _unflatten
    casts to params_like's dtypes), views of g_hat where the dtype is f32.
    """
    if (axis is None) != (mesh is None):
        raise ValueError("axis and mesh come together")
    metas = _metas(model_or_params)
    n = sum(shape.numel() for _, shape, _ in metas)
    first = (next(model_or_params.parameters())
             if isinstance(model_or_params, nn.Module)
             else next(iter(dict(model_or_params).values())))
    device = first.device

    def init_ef() -> torch.Tensor:
        return torch.zeros((n,), dtype=torch.float32, device=device)

    def transform(grads: Mapping[str, torch.Tensor], ef: torch.Tensor,
                  key: Union[torch.Generator, Tuple]):
        signs, rows = (key if isinstance(key, tuple)
                       else sketch_params(key, n, r_prime))
        v, off = ef, 0
        for name, shape, _ in metas:
            size = shape.numel()
            v[off:off + size].add_(grads[name].reshape(-1))
            off += size
        s = compress(v, signs, rows)
        if axis is not None:
            ax = mesh_axis(mesh, axis)
            if ax.size > 1:
                s = ax.all_reduce(s).div_(ax.size)
        g_hat = decompress(s, signs, rows, n)
        v.sub_(g_hat)
        out: Dict[str, torch.Tensor] = {}
        off = 0
        for name, shape, dtype in metas:
            size = shape.numel()
            out[name] = g_hat[off:off + size].view(shape).to(dtype)
            off += size
        return out, v

    return transform, init_ef


def compression_ratio(model_or_params, r_prime: int) -> float:
    """n / r': the gradient's entries (JAX's leaves at the same tp) over
    the sketch's."""
    return sum(shape.numel() for _, shape, _ in _metas(model_or_params)) \
        / r_prime


def _f32(x) -> np.ndarray:
    if isinstance(x, torch.Tensor):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float32)


def bf16_encode(x) -> np.ndarray:
    """float array -> (same-shape) uint16 bfloat16 bit pattern."""
    b = torch.from_numpy(np.ascontiguousarray(_f32(x))).to(torch.bfloat16)
    return b.view(torch.int16).numpy().view(np.uint16)


def bf16_decode(u) -> np.ndarray:
    """uint16 bfloat16 bit pattern -> float32 (exact)."""
    i16 = np.ascontiguousarray(np.asarray(u, np.uint16)).view(np.int16)
    return torch.from_numpy(i16).view(torch.bfloat16).float().numpy()


def int8_encode(x) -> Tuple[np.ndarray, float]:
    """float array -> (int8 array, scale), symmetric absmax: decode is
    q * scale."""
    x = _f32(x)
    amax = float(np.max(np.abs(x))) if x.size else 0.0
    scale = amax / 127.0 if amax > 0.0 else 1.0
    q = np.clip(np.round(x / np.float32(scale)), -127.0, 127.0)
    return q.astype(np.int8), scale


def int8_decode(q, scale: float) -> np.ndarray:
    """Invert int8_encode -> float32."""
    return np.asarray(q, np.float32) * np.float32(scale)


def _floating(arr) -> bool:
    if isinstance(arr, torch.Tensor):
        return arr.is_floating_point()
    return np.issubdtype(np.asarray(arr).dtype, np.floating)


def quantize_state(state: dict, dtype: str = "bf16") -> Tuple[dict, dict]:
    """Encode every floating leaf of a flat dict for storage.

    Returns (encoded, quantized): `quantized` maps each encoded leaf to
    its codec, the bare string "bf16" or {"codec": "int8", "scale": s},
    ready for JSON. Integer leaves pass through and stay out of the map.
    """
    if dtype not in _QUANTIZED_DTYPES:
        raise ValueError(f"unknown quantized dtype {dtype!r}; "
                         f"have {list(_QUANTIZED_DTYPES)}")
    out, quantized = {}, {}
    for name, arr in state.items():
        if not _floating(arr):
            out[name] = arr
        elif dtype == "bf16":
            out[name] = bf16_encode(arr)
            quantized[name] = dtype
        else:
            out[name], scale = int8_encode(arr)
            quantized[name] = {"codec": "int8", "scale": scale}
    return out, quantized


def dequantize_state(state: dict, quantized: dict) -> dict:
    """Invert quantize_state: decode the recorded leaves to float32.
    Takes both map shapes, the legacy bare codec string ("bf16") and the
    per-leaf dict ({"codec": "int8", "scale": s})."""
    out = dict(state)
    for name, meta in quantized.items():
        codec = meta if isinstance(meta, str) else meta.get("codec")
        if codec not in _QUANTIZED_DTYPES:
            raise ValueError(f"leaf {name!r} encoded with unknown dtype "
                             f"{codec!r}; have {list(_QUANTIZED_DTYPES)}")
        if name not in out:
            continue
        if codec == "bf16":
            out[name] = bf16_decode(out[name])
        else:
            out[name] = int8_decode(out[name], float(meta["scale"]))
    return out
