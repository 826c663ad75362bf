"""The fit and Alg. 1 across the ranks of a mesh, the sharding rules of
training, checkpoints and fault tolerance.

  dfwht.py        distributed FWHT: local transform + hypercube butterfly
  fit.py          ShardedFitEngine, the sharded one-pass fit's block update
  cluster.py      Alg. 1 end to end on a mesh
  sharding.py     the LM side's rules (param / state / batch / cache specs,
                  JAX's letter for letter), placements, moving a tensor
                  between layouts
  tensor_parallel.py  the train step's compute over the model axis (heads,
                  MLP and expert columns, the vocab-parallel lookup and
                  loss): what GSPMD derives on JAX's side; every family's
                  serving cut (shard_for_serving, serve_cache)
  checkpoint.py   checkpoints in the JAX layout, restored onto a mesh
  fault.py        heartbeats, stragglers, elastic re-mesh, restart
  compression.py  sketched gradients with error feedback; the artifact
                  codecs (bf16 / int8)
"""
from repro_torch.distributed.sharding import (activation_sharding,
                                              batch_pspecs, cache_pspecs,
                                              maybe_shard, param_pspecs,
                                              state_pspecs)

__all__ = ["param_pspecs", "batch_pspecs", "cache_pspecs", "state_pspecs",
           "maybe_shard", "activation_sharding"]
