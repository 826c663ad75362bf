"""Serving: the FittedModel and its artifact, the extension, the batcher,
and the lifecycle around them.

  artifact.py   FittedModel + save/load in the JAX package's layout
  extend.py     out-of-sample extension through the kernels (Extender;
                ShardedExtender over a mesh)
  policy.py     ComputePolicy: which compute paths run
  batcher.py    pow-2 bucketed MicroBatcher with a coalescing queue
  scheduler.py  AsyncBatcher: futures, deadline flush, SLO accounting
  pump.py       the rank-0 pump: a mesh's async front door on rank 0,
                its flushes and swaps broadcast to the other ranks
  latency.py    streaming latency histogram: p50/p95/p99, SLO violations
  versions.py   VersionStore: <root>/v_<N>/ publish, pins, keep-last-K GC
  registry.py   ModelRegistry: rows of models, warm hot-swap (SwapReport)
  bench.py      the eight benches (run_benches) -> BENCH_serve_torch.json
"""
from repro_torch.serve.artifact import (ClusteringSpec, FittedModel,
                                        ModelSpec, fit_model, from_reference,
                                        load_model, save_model)
from repro_torch.serve.batcher import MicroBatcher, bucket_size
from repro_torch.serve.bench import (benchmark_assign, benchmark_async,
                                     benchmark_backends,
                                     benchmark_fit_scaling, benchmark_fused,
                                     benchmark_stream, benchmark_swap,
                                     format_bench, machine_calibration,
                                     median_benches, run_benches,
                                     write_bench)
from repro_torch.serve.extend import (Extender, ShardedExtender, assign,
                                     embed, embed_sharded)
from repro_torch.serve.latency import LatencyStats
from repro_torch.serve.policy import ComputePolicy, resolve_kernel_path
from repro_torch.serve.registry import (DEFAULT_REGISTRY, ModelRegistry,
                                        SwapReport)
from repro_torch.serve.scheduler import AsyncBatcher
from repro_torch.serve.versions import (VersionStore, gc_versions,
                                        latest_version, load_version,
                                        publish_version)

__all__ = ["AsyncBatcher", "ClusteringSpec", "ComputePolicy",
           "DEFAULT_REGISTRY", "Extender", "FittedModel", "LatencyStats",
           "MicroBatcher", "ModelRegistry", "ModelSpec", "SwapReport",
           "ShardedExtender", "VersionStore", "assign", "benchmark_assign",
           "benchmark_async", "benchmark_backends", "benchmark_fit_scaling",
           "benchmark_fused", "benchmark_stream", "benchmark_swap",
           "bucket_size", "embed", "embed_sharded",
           "fit_model", "format_bench", "from_reference", "gc_versions",
           "latest_version", "load_model", "load_version",
           "machine_calibration", "median_benches", "publish_version",
           "resolve_kernel_path", "run_benches", "save_model",
           "write_bench"]
