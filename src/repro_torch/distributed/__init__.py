"""On-disk checkpoints and the artifact codecs, in the JAX package's layout."""
