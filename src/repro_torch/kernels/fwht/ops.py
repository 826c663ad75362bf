"""Wrapper of the FWHT CUDA kernel (csrc/fwht.cu)."""
from __future__ import annotations

import torch

from repro_torch.kernels import _build, _common as cm
from repro_torch.kernels.fwht.ref import fwht_ref

# Butterfly stages one pass runs in shared memory: 2^10 rows x 32 columns
# of f32 is 128 KB of the block's 227 KB.
MAX_PASS_BITS = 10


def pass_bits(n: int) -> list:
    """Stages of each pass over x (n rows): log2(n) split as evenly as
    possible into passes of at most MAX_PASS_BITS, low bits first."""
    m = n.bit_length() - 1
    passes = -(-m // MAX_PASS_BITS)
    if passes == 0:
        return []
    return [m // passes + (i < m % passes) for i in range(passes)]


def fwht_op(x: torch.Tensor, normalize: bool = True) -> torch.Tensor:
    """Walsh-Hadamard transform along dim 0 of x (n, c), n = 2^m, float32.

    CPU tensors run the plain version; CUDA tensors launch the kernel
    once per pass (pass_bits), which runs the stages in the plain
    version's order and divides by the same f32 sqrt(n), so the two agree
    bit for bit. `launches` counts transforms, one per call that ran the
    kernel.
    """
    what = "fwht"
    # Checked on both paths, so a CPU run catches what the kernel refuses.
    cm.contiguous(what, "x", x, 2)
    n, c = x.shape
    if n < 1 or n & (n - 1):
        raise ValueError(f"{what}: power-of-two length required, got {n}")
    if cm.plain_path(what, x):
        return fwht_ref(x, normalize)
    out = torch.empty_like(x)
    if c == 0:
        return out
    scale = (float(torch.sqrt(torch.tensor(float(n), dtype=torch.float32)))
             if normalize else 1.0)
    bits = pass_bits(n) or [0]         # n == 1: one pass of no stages
    lib = _build.library()
    done = 0
    for i, k in enumerate(bits):
        last = i == len(bits) - 1
        rc = lib.rt_fwht_pass(x.data_ptr() if i == 0 else out.data_ptr(),
                              out.data_ptr(), n, c, done, k,
                              scale if last else 1.0, cm.stream(x))
        _build.check(rc, what)
        done += k
    fwht_op.launches += 1
    return out


fwht_op.launches = 0
