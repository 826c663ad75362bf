"""Hand-written CUDA kernels for Hopper, one package per TPU kernel.

gram/          kernel-matrix stripe kappa(X, Xb) (csrc/gram.cu)
kmeans_assign/ fused distance + argmin (csrc/kmeans_assign.cu)
extend_embed/  fused gram->projection serving stripe (csrc/extend_embed.cu)
fit_sketch/    fused gram->sketch-accumulate fit block (csrc/fit_sketch.cu)

Each package holds ref.py (the plain PyTorch version) and ops.py (the
wrapper: plain version for CPU tensors, the CUDA kernel for CUDA tensors,
a `launches` counter). _build.py compiles csrc/ on first use.
"""
from repro_torch.kernels.extend_embed.ops import extend_embed_op
from repro_torch.kernels.fit_sketch.ops import fit_sketch_op
from repro_torch.kernels.gram.ops import gram_stripe_op
from repro_torch.kernels.kmeans_assign.ops import assign_op

__all__ = ["extend_embed_op", "fit_sketch_op", "gram_stripe_op",
           "assign_op", "OPS", "reset_launches"]

OPS = {"gram_stripe": gram_stripe_op, "kmeans_assign": assign_op,
       "extend_embed": extend_embed_op, "fit_sketch": fit_sketch_op}


def reset_launches() -> None:
    """Set every wrapper's launch count to 0."""
    for op in OPS.values():
        op.launches = 0
