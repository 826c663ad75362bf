"""FWHT: the normalized Walsh-Hadamard transform along dim 0, and its SRHT
form Omega^T M (csrc/fwht.cu)."""
