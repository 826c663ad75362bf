"""FWHT: the normalized Walsh-Hadamard transform along dim 0 (csrc/fwht.cu)."""
