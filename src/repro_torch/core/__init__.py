"""Kernel functions, sketch and one-pass eigensolve, K-means, metrics."""
