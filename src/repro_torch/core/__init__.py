"""Kernel functions, sketch and one-pass eigensolve, K-means, metrics, the
Nystrom and exact baselines and the Theorem 1 functions."""
from repro_torch.core.exact import ExactEig, exact_eig, exact_eig_from_gram
from repro_torch.core.kernels_fn import (gram_matrix, make_kernel,
                                         polynomial_kernel, rbf_kernel,
                                         stripe_iterator)
# `kmeans` stays the submodule here (the JAX package exports the function
# under that name): its function is repro_torch.core.kmeans.kmeans.
from repro_torch.core.kmeans import KMeansResult, kmeans_plus_plus
from repro_torch.core.linearized import (best_rank_r, brute_force_optimal,
                                         objective_from_labels,
                                         theorem1_bounds, trace_norm)
from repro_torch.core.metrics import (clustering_accuracy,
                                      kernel_approx_error,
                                      kernel_approx_error_streaming, nmi)
from repro_torch.core.nystrom import NystromResult, nystrom
from repro_torch.core.sketch import (SRHT, LowRankEig, SketchedEig, fwht,
                                     make_srht, next_pow2, one_pass_core,
                                     randomized_eig,
                                     randomized_eig_with_state, srht_apply,
                                     srht_apply_t, sketch_stream)
from repro_torch.core.onepass import (linearized_kmeans_from_Y,
                                      one_pass_kernel_kmeans)

__all__ = [
    "make_kernel", "polynomial_kernel", "rbf_kernel", "gram_matrix",
    "stripe_iterator",
    "kmeans_plus_plus", "KMeansResult",
    "fwht", "make_srht", "srht_apply", "srht_apply_t", "randomized_eig",
    "randomized_eig_with_state", "one_pass_core", "sketch_stream",
    "next_pow2", "SRHT", "LowRankEig", "SketchedEig",
    "one_pass_kernel_kmeans", "linearized_kmeans_from_Y",
    "nystrom", "NystromResult",
    "exact_eig", "exact_eig_from_gram", "ExactEig",
    "objective_from_labels", "brute_force_optimal", "theorem1_bounds",
    "best_rank_r", "trace_norm",
    "clustering_accuracy", "nmi", "kernel_approx_error",
    "kernel_approx_error_streaming",
]
