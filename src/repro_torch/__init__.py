"""PyTorch/CUDA port of the kernel-clustering system (see src/repro).

Mirrors the JAX package's layout: core/ (kernel functions, sketch,
K-means, metrics), kernels/ (hand-written CUDA kernels for Hopper),
stream/ (the one-pass sketch accumulator), api/ (KernelKMeans and its
backends), serve/ (artifact, extension, batching) and data/. It imports
torch and numpy, never jax and nothing of `repro`.
"""
