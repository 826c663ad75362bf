"""The fit and Alg. 1 across the ranks of a mesh, checkpoints and fault
tolerance.

  dfwht.py        distributed FWHT: local transform + hypercube butterfly
  fit.py          ShardedFitEngine, the sharded one-pass fit's block update
  cluster.py      Alg. 1 end to end on a mesh
  checkpoint.py   checkpoints in the JAX layout, restored onto a mesh
  fault.py        heartbeats, stragglers, elastic re-mesh, restart
  compression.py  the artifact codecs (bf16 / int8)
"""
