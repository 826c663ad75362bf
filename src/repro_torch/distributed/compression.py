"""Quantized artifact codecs: bf16 bit patterns and absmax-scaled int8.

The JAX package's codecs (repro.distributed.compression), on host numpy
arrays, bit for bit: bf16 is stored as the uint16 pattern of the
round-to-nearest-even bfloat16 (torch.bfloat16 rounds so too); int8 is
round-half-even of x / scale with scale = max|x| / 127, one float per
leaf kept in the artifact's quantized map. The sketched-gradient
transform of that module belongs to the LM side and is not ported yet.
"""
from __future__ import annotations

from typing import Tuple

import numpy as np
import torch

_QUANTIZED_DTYPES = ("bf16", "int8")


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
