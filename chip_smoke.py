#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Phases, each fatal on failure:
  1. environment: torch version, the card's name and power limit
     (nvidia-smi), TF32 off;
  2. build the CUDA kernels of src/repro_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card, at every
     parity case of repro_torch.kernels.registry and at its main-path
     shape, with times (CUDA events, median of 7 after warm-up); fwht and
     srht_t must equal theirs exactly, and they and fit_sketch give the
     same bits on two launches; srht_t is also timed against the unfused
     pad / sign / fwht kernel / gather composition and against torch.mm
     with a materialized Omega (its library time); fit_sketch also at the
     ragged tail block and with the rbf kind, extend_embed also at the
     serving widths w = 256, 64 and 8 and with the rbf kind, both beside
     their tensor-core and fp32 bounds, with their registers, shared
     memory and HMMA counts; extend_embed gives the same bits on two
     launches too; embed_assign (the assignment folded into extend_embed's
     summing launch) at the main shape and the serving widths equals the
     unfused extend_embed -> transpose -> kmeans_assign sequence bit for
     bit, timed beside it and beside extend_embed alone; kmeans_assign
     also back to back and at its registry case (513, 16, 100); fwht at
     one column (FWHT_COLUMN_N, 1), the row pass and passes over its
     view, equal to fwht_ref bit for bit, timed one call and back to back
     beside its bound;
  4. fit: KernelKMeans on n = 100,000 points of the segmentation proxy
     (p = 19, K = 7, r = 2, l = 5, polynomial d = 2, onepass-srht,
     block 512) through the fused fit_sketch kernel, its eigensolve through
     the srht_t kernel (the default route), cross-checked against the
     canonical plain fit (fwht_fn=fwht_ref) with the same sketch and init
     (sketch state, eigenvalues, subspace, labels), with the fit's own step
     times; then the same fused fit in ten partial_fit chunks, whose
     sketch state must equal the one-shot fit's bit for bit;
  5. serve: a MicroBatcher answers requests of 1 .. 2,500 held-out queries
     on the default policy, through embed_assign (no standalone
     kmeans_assign launch), each request's labels and distances equal to
     an unbatched Extender.assign bit for bit; the queries embedded through
     extend_embed; a second batcher on the two-pass embedding serves the
     same requests through the standalone kmeans_assign kernel; both
     checked against the two-pass plain Extender on the card;
  6. stream: the same configuration as a streaming fit on the canonical
     SRHT path, its default route (every Omega^T M through the srht_t
     kernel): ten partial_fit chunks of 10,000 columns (a minibatch re-eig
     after the fifth), the model saved after the fifth and resumed from
     disk, both streams fed the last five chunks; resumed == live and
     chunked == one-shot fit bit for bit, the stream equal to phase 4's
     canonical plain fit, a one-shot fit through the unfused fwht kernel
     (fwht_fn=fwht_op) equal to both, exact srht_t and fwht launch counts,
     bf16 / int8 artifacts serving the held-out queries, and a breakdown
     of one canonical block update by part on both routes;
  8. backends (run before 7): the Nystrom backend at n = 100,000 with
     m = 64 (default_nystrom_m) and m = 1,024 (eight extend_embed
     training ranges): its training round trip through extend_embed
     against the landmarks, the 4,096 held-out queries served on the
     default policy (embed_assign against the landmarks; bucketed ==
     unbatched bit for bit; labels against the two-pass plain extension by
     the near-tie rule), the m = 64 model saved as f32 / bf16 / int8,
     loaded and served; the exact backend, the fused one-pass fit and
     Nystrom m = 64 on every tenth training point (10,000), each with its
     approximation error against the full K (exact is the floor), accuracy,
     the paper's objective L(C) under K, memory model, peak device memory
     and step times, the exact model served as above; the streaming
     approximation error of phase 4's model and the Nystrom models at
     n = 100,000; extend_embed and embed_assign at the landmark widths
     n_ref = 10 .. 1,024, w = 512 and 8, against their plain versions;
  9. lifecycle (run after 8 and before 7): (a) phase 4's model behind
     ModelRegistry().scheduler("main", max_wait_ms=2.0, slo_ms=250.0)
     with its pump thread live: 256 requests of 1-64 held-out queries
     (seed 0) all resolve, each equal to a synchronous MicroBatcher.drain
     of the same requests bit for bit though the two coalesce
     differently, labels against the two-pass plain extension (near-tie
     rule); latency percentiles, SLO violations, queries/s and the
     cooperative benchmark_async; a VersionStore under build/ (v1 pinned
     outlives gc(keep=1); unpinned, gc(keep=2) leaves v2 and v3, v3 the
     centroid rows reversed), a warm swap to v3 with 8 requests pending
     (drained into the old model bit for bit, later requests labelled
     k - 1 - old, 0 stranded futures, the old row's buckets warmed), the
     SwapReport and benchmark_swap, post-stop submits refused; (b) the
     streaming loop on the canonical route at capacity 100,000: five
     partial_fit chunks of the first half (classes 0-3), healthy traffic
     through the async front door observed by a DriftMonitor (quiet),
     drifted traffic (columns past 70,000 and the held-out queries,
     classes 4-6) with one request pending: exactly one RetrainWorker
     rollout (refit with the second half -> publish -> swap -> rebind),
     0 stranded futures, drifted-set accuracy higher after; the
     monitor's errors through the gram kernel against the plain kappa,
     and gram timed at the drift shape. Launches are counted on the
     parts no pump thread serves;
  10. fleet (run after 9 and before 7): phase 4's model published to a
     VersionStore under build/ and served by Fleet(store, n_workers=2,
     max_wait_ms=2.0, slo_ms=250.0, device="cuda"), cooperatively (no
     pump): phase 9a's 256 requests, least-loaded, each equal to an
     unbatched Extender.assign of its queries bit for bit, both replicas
     serving, labels against the two-pass plain extension (near-tie
     rule); under hash routing 64 keyed requests sent twice land on the
     same replica both times; v2 (centroid rows reversed) published and
     gc(keep=1) leaves v1, which both replicas pin; a canary rollout to
     v2 with 8 requests pending (promoted, every replica on v2, 0
     stranded, the pending ones answered by v1 bit for bit, later ones
     labelled k - 1 - old), then a rollout to v3 whose probe breaches,
     rolled back with every replica on v2; the 256 requests flooded at a
     cap of 64 columns per replica (shed > 0, admitted p99 within the
     SLO); every pin released when a fleet stops; benchmark_fleet at 1, 2
     and 4 replicas with live pumps (q/s and percentiles printed, the
     scaling not gated). Launches are counted on the cooperative parts;
  11. distributed (after 10, before 7): a NCCL world of one rank, made
     and torn down here, at the main path's width: (a) the sharded fit
     (ComputePolicy(mesh=...)) on the canonical route equal to the
     unsharded canonical fit bit for bit (stream_w, row norms, eigvals,
     U, centroids, labels) and on the fused route within 2e-3 of phase
     4's eigenvalues with labels agreeing on >= 0.99 (bitwise or not,
     printed); ten partial_fit chunks equal to the one-shot sharded fit
     on both routes, and a stream resumed from a mid-stream artifact
     equal to the live one, bit for bit; (b) a ShardedExtender over the
     4,096 held-out queries: embed equal to Extender.embed bit for bit,
     labels by the near-tie rule, a MicroBatcher on the mesh policy
     bucketed == unbatched, q/s beside Extender.assign's; (c) Alg. 1 on
     the mesh (distributed_one_pass_kernel_kmeans) at n = 100,000 padded
     to 131,072 with its draws from seed 0: distributed_fwht equal to
     fwht_op on a (131,072, 512) stripe, W within 2e-3 of the
     accumulator's sketch on the same draws, its approximation error and
     accuracy beside the single-host fit's; (d) benchmark_fit_scaling at
     n = 25,000, 50,000, 100,000 on both routes; (e) a CheckpointManager
     save / GC / restore_latest onto the mesh, bit for bit; (f) the
     launcher under torchrun (--standalone --nproc_per_node=1
     -m repro_torch.launch.cluster --distributed --dataset seg), which
     must exit 0. Launches are counted on the sharded paths, and
     fit_sketch, fwht, extend_embed and kmeans_assign must launch;
  12. launcher (after 11, before 7): repro_torch.launch.serve_cluster
     in-process at n = 100,000 points of its blob_ring (p = 2, k = 2,
     r = 2), the artifacts and bench files in a temporary directory under
     build/: (a) --swap --stream --fleet --bench all --batch-sizes
     64,512,4096 --queries 8192 prints `serve_cluster: OK`, its bench
     file holds all eight sections, srht_t, extend_embed and embed_assign
     launch; (b) --backend nystrom --nystrom-m 1024 --bench sync, and
     --fused-embed off --bench sync, which launches kmeans_assign; each
     with every launch count set to 0 just before, its seconds, launches
     and the bench's headline numbers printed; (c) --sharded --bench sync
     under torchrun (--standalone --nproc_per_node=1) and (d) the six
     examples (examples/torch_*.py; the distributed one under torchrun),
     started together as processes, each of which must exit 0, and
     beside them (e) a broken world: --sharded --bench async --smoke
     under torchrun with rank 0's compute made to fail on its first
     pumped flush (tests/torch_world_teardown_worker.py), which must end
     through launch/mesh.py with the rank's code BROKEN_EXIT (70) in
     torchrun's report, the injected error in its output, no abort
     ("terminate called", a watchdog's) and within LAUNCHER_BROKEN_S.
     While (a) and (b) run, a stand-in beside each kernel wrapper keeps the
     inputs of the first call of each distinct shape (the wrappers alone
     count launches); after each run, outside its counts, every kept call
     goes through the wrapper again on the card and through the plain
     version, held by the registry's rule (fwht and srht_t exactly), and
     a kernel that launched with no call kept fails the phase;
  13. lm (after 12, before 7): the decoder-only LM serving path
     (repro_torch.models, launch/serve.py), on which no kernel of the
     port's lies (the projections are torch.matmul, attention plain
     einsums; the launch counts read around it stay 0): (a) python -m
     repro_torch.launch.serve --no-smoke --arch phi4-mini-3.8b --batch 8
     --prompt-len 512 --gen 32 --max-seq 1024 as a process (full width
     and depth, 4.451 B parameters, bf16, an f32 cache), which must exit
     0 with finite logits; its prefill ms, decode ms/step, tokens/s and
     peak memory beside the prefill's flops bound and the decode step's
     bytes bound; (b) the same model in process: prefill(512) against
     forward(512)[:, -1] and one decode against forward(513)[:, -1]
     within the bf16 tolerances of LM_PREFILL_ULPS / LM_ROUNDINGS, a
     differing greedy token only at a near tie; the same checks at depth
     2 in f32 within 1e-4 with equal tokens; warm prefill and decode
     times, peak memory, and a decode step under the profiler; (c) the
     other six decoder-only archs at their published widths, depth cut
     to 2 (`reduced`), one at a time: prefill(256) == forward at batch 4,
     one decode == forward(257) for the non-MoE ones (capacity routing
     groups a decode step's tokens apart: the JAX package's semantics),
     8 decode steps timed; mixtral's sliding ring at full width at one
     Attention layer (prefill 4,100 > window 4,096 at batch 1, then 3
     decode steps against the windowed forward, f32 and bf16); (d) (b)'s
     model through make_prefill_step / make_decode_step(mesh=) on a NCCL
     world of one rank that the part makes and tears down
     (tensor_parallel.shard_for_serving, serve_cache): the prefill's
     logits, LM_MESH_STEPS greedy steps' tokens and logits and the f32
     cache equal to the meshless steps' on the same model and prompt,
     bit for bit (14d, 15d and 16d do the same for the hybrid, the ssm
     and the encdec: every leaf of their f32 caches, whisper's frames
     beside the prompt);
  14. hybrid (after 13, before 7): the hybrid family (models/rglru.py:
     RG-LRU blocks and local attention; no kernel of the port's lies on
     it): (a) python -m repro_torch.launch.serve --no-smoke --arch
     recurrentgemma-2b at 13a's batch, prompt, steps and cache, all 26
     layers (8 x (R R A) + R R) at the published widths, as a process
     that must exit 0, its numbers beside its bounds; (b) the same model
     in process in bf16: prefill(512) == forward(512)[:, -1] and one
     decode == forward(513)[:, -1] within bf16_tol (an R layer's decode
     counting HY_R_ROUNDINGS roundings), then the ring past the window
     (batch 1, a prompt of 2,100 > window 2,048 into 2,048 slots, 3
     decode steps, each against forward(2,103) at its position), warm
     times, peak memory and a decode step under the profiler; the same
     checks in f32 at depth 3 (one R R A superblock) within 1e-4;
  15. ssm (after 14, before 7): the ssm family (models/rwkv6.py: RWKV-6
     "Finch", the chunked WKV core and the token-shift mixes; no kernel of
     the port's lies on it): (a) python -m repro_torch.launch.serve
     --no-smoke --arch rwkv6-1.6b at 13a's batch, prompt, steps and cache,
     all 24 layers at the published widths, as a process that must exit
     0, its numbers beside its bounds; (b) the same model in process in
     bf16: prefill(512) == forward(512)[:, -1], 64 teacher-forced decode
     steps on tokens 512 .. 575, step i against forward(576)[:, 512 + i]
     within bf16_tol of i steps (an RWKV layer counting RWKV_ROUNDINGS),
     the state handoff (prefill(576)'s s, tm, cm against the cache after
     prefill(512) and the 64 steps), warm times, peak memory and a decode
     step under the profiler; the same checks in f32 at depth 2 within
     1e-4, the state within rtol and atol 2e-4;
  16. encdec (after 15, before 7): the encoder-decoder family
     (models/whisper.py: 32 encoder and 32 decoder layers over 1,500
     audio frames, the cross-attention K/V cached once at prefill; no
     kernel of the port's lies on it): (a) python -m
     repro_torch.launch.serve --no-smoke --arch whisper-large-v3 at 13a's
     batch, prompt, steps and cache (a prompt of 512 past whisper's
     published 448 text positions: the JAX model has no position table)
     as a process that must exit 0, its numbers beside its bounds; (b)
     the same model in process in bf16, its frames drawn on the card:
     prefill(512) == forward(512)[:, -1], the cache's xk and xv bit for
     bit each layer's _cross_kv of encode(frames), 8 teacher-forced decode
     steps, step i against forward(520)[:, 512 + i] within bf16_tol of
     step i (a decoder layer counting ENCDEC_ROUNDINGS once and the k and
     v of each earlier step), xk and xv unchanged by them; warm times, peak memory and a decode step under
     the profiler; the same checks in f32 at depth 2 (2 encoder and 2
     decoder layers) within 1e-4;
  17. train (after 16, before 7): the single-process training loop
     (train/optimizer.py's AdamW, train/steps.py's step with its
     gradient hook and remat, launch/train.py with its checkpoints; no
     kernel of the port's lies on it): (a) python -m
     repro_torch.launch.train --no-smoke --arch phi4-mini-3.8b --batch 4
     --seq 512 --steps 8 as a process (all 32 layers at the published
     widths, the config's microbatches 2 and remat, JAX's lr 3e-3), which
     must exit 0 with the loss fallen, its warm step and tokens/s beside
     the step's bound (lm_bounds' train branch) and its peak memory; (b)
     in process: the smoke config at M 2 with remat, f32, 3 steps on the
     card against 3 on the CPU from the same weights and batch, loss,
     grad norm, every parameter and both moments within TRAIN_TOL; a
     checkpoint / restart through launch.train.run at --smoke under
     build/ (4 steps saving every 2, then --steps 8, which must restore
     at step 4; the restored state equal to the saved one bit for bit,
     the final state to an uninterrupted run's within TRAIN_TOL); one
     full-width layer's bf16 parameters and bf16 moments saved and
     restored bit for bit; (c) one warm step of (a)'s configuration in
     process, split by CUDA events into forward + backward and grad
     norm + AdamW beside a no-grad forward, then profiled: host and card
     ms, busy share, records, the largest card parts and each class's
     sum. The launch counts read around phases 13-17 must stay 0;
  18. train-mesh (after 17, before 7): the mesh half of training
     (distributed/sharding.py's rules, shard_train_state and the sharded
     step, the sketched gradients of distributed/compression.py, the
     launcher's --data / --model / --sketch-grads): (a) python -m
     torch.distributed.run --standalone --nproc_per_node 1 chip_smoke.py
     --train-mesh-worker (launch.train.run at --data 1 --model 1 on phi4's
     full width and depth, 17a's batch, 3 steps, in a NCCL world of one),
     then the meshless step in process from the same seed: loss, grad
     norm and every parameter's and moment's checksum bit for bit, the
     peak within 5 % of 17a's; the launcher's step gathers each parameter
     at its use (its default), each block through the gather as it runs
     and again in remat's replay (counted), and no gather runs a
     collective: the box has one card, so no data-axis collective runs on
     it; (b) launch.train.run in process on
     rwkv6-1.6b at full width and depth (n_pad = 2^31) with
     --sketch-grads 2^28, 8 steps: the loss falls, the ratio is n / r',
     the transform's ms a step, the peak <= 75 GB, fwht launched twice a
     step (counted); on the first step's gradient the projection's
     identities (|g_hat| = |s| and <g_hat, e'> ~ 0 over the padded
     vectors, v = g_hat + e' to e''s rounding) and fwht_op at (2^31, 1)
     (the one-column plan) against fwht_ref, the same bits, timed beside
     its bound, the transform's ms a warm step beside the pass kernel's
     alone (SKETCH_TRANSFORM_BEFORE_MS); (c)
     compress / decompress at the ten smoke configs' n, the card
     against the CPU's plain path within 2e-4;
  19. dryrun (after 18, before 7): the dry run (launch/dryrun.py: rank 0
     of a fake world, fake tensors, op_analysis.py's counts), which
     allocates no device memory and launches no kernel: (a) phase 17's
     step (phi4-mini-3.8b at full width and depth, B 4 x S 512, M 2,
     remat) in a dry-run world of one rank: its peak within 5 % of 17a's
     measured peak, its flops within 3 % of lm_bounds' train flops plus
     the attention's masked pairs and remat's recompute, its traffic
     printed; (b) phi4-mini-3.8b x train_4k on the 16 x 16 mesh (rank 0
     of 256): status ok, collective bytes by kind equal to the sharded
     step's plan, the peak a rank at most the card's total_memory, the
     peak and seconds printed; (c) the same for recurrentgemma-2b (the
     tensor-parallel hybrid: 10 heads over 16 ranks) at full width and
     train_4k's 16 rows a rank (M 4, S 4,096) at 5 layers, one (R, R, A)
     superblock and the (R, R) remainder; (d) the same for rwkv6-1.6b
     (the tensor-parallel ssm: 32 heads of 64, 2 a rank) at 4 layers;
     (e) the same for whisper-large-v3 (the tensor-parallel encdec: 20
     heads over 16 ranks, the encoder over 1,500 frames a row) at 4
     encoder and 4 decoder layers; (f) phi4-mini-3.8b x prefill_32k, (g)
     phi4-mini-3.8b x decode_32k, (h) mixtral-8x7b x long_500k, (i)
     recurrentgemma-2b x prefill_32k (R R A R: the window's ring past
     2,048), (j) rwkv6-1.6b x decode_32k and (k) whisper-large-v3 x
     prefill_32k (4 encoder layers too) at full width and 4 layers,
     served tensor-parallel through the mesh's steps (the rank's heads
     and KV heads, its lru channels and time-mix heads, its MLP, expert,
     channel-mix and vocab chunks, held): collective bytes by kind equal
     to dryrun.serve_plan (no weight's), the peak a rank at most the
     card's total_memory, the held bytes printed; (l) phi4-mini-3.8b x
     train_4k and (m) recurrentgemma-2b x prefill_32k at 4 layers with
     seq_shard_acts on, held to their plans; (n) mixtral-8x7b x train_4k
     at full width and 4 layers (remat, as published), each parameter
     gathered over the data axes at its use (the default) and, with
     pregather, once a step: both held to their plans, and the peak at
     use below the pregather peak by at least all blocks but two in
     their computed layout (dryrun.block_bytes); the card's
     total_memory printed; the phase within 120 s;
  20. analysis (after 19, before 7): the port's static contract checker
     (repro_torch.analysis): python -m repro_torch.analysis's run over
     src/repro_torch with analysis_baseline_torch.toml must exit 0; every
     registry case of the seven kernels, their main-path shapes and fwht
     at one column (FWHT_COLUMN_N, 1) launched under one torch.profiler
     trace, each launch's kernel, grid,
     block and shared memory (CUPTI's static + dynamic) in the trace equal
     to the plan the CPU derivation walks (its dynamic shared memory plus
     ptxas's static), each call's declared DRAM bytes equal to the
     derived, the traced shared memory within the contract's budget and
     the budget within the card's opt-in limit per block; the library's
     own shared memory of extend_embed and fit_sketch equal to the plans';
     at the main shapes the modelled bytes beside the bound's;
  7. device: times on the card alone from torch.profiler traces, taken
     last so that no phase runs after the profiler: kmeans_assign,
     embed_assign beside extend_embed and the unfused sequence, and the
     card's busy share while the requests of phase 5 are served one by
     one;
then prints the `main_path` and `kernels` JSON lines, the nvidia-smi line
and, last,
{"ok": true, "device": {...}}. Exits non-zero, printing no result line,
without a CUDA card or without the repository around it.
"""
from __future__ import annotations

import collections
import json
import math
import pathlib
import re
import shutil
import statistics
import subprocess
import sys
import tempfile
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"
BUILD = ROOT / "build"                  # git-ignored: builds, artifacts
DEVICE = "cuda"

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores, TF32 on the tensor cores and HBM3 bandwidth.
# bound = max(ops / FP32, bytes / HBM); for fit_sketch and extend_embed,
# whose products run on the tensor cores, max(bytes / HBM, 3 x tensor
# flops / TF32, the rest of their flops / FP32).
FP32_FLOPS = 67e12
TF32_FLOPS = 495e12
BF16_FLOPS = 989e12      # the LM phase's bound: bf16 on the tensor cores
HBM_BYTES_PER_S = 3.35e12

# The port's configuration: the paper's Fig. 3 widths at n = 100,000.
N_TRAIN, N_QUERY, P, K, R, OVERSAMPLING, BLOCK = 100_000, 4096, 19, 7, 2, 5, 512
RP = R + OVERSAMPLING
N_PAD = 1 << (N_TRAIN - 1).bit_length()         # the SRHT's padded rows
KERNEL = {"kind": "polynomial", "gamma": 0.0, "degree": 2}
REQUESTS = (1, 7, 64, 300, 1024, 2500)
SEED = 0

TOL = 2e-3           # registry tolerance of the fused kernels
STREAM_CHUNK = 10_000                          # partial_fit chunk width
SAVED_AGREEMENT = 0.95   # tests/test_stream.py::test_int8_artifact_serves
LIBRARY_FWHT_N = 8192    # rows of the materialized H timed as torch.mm
# One column (c = 1) timed in phase 3 and traced in phase 20: the row pass
# and two passes over its (2^11, 2^13) view, a mid-size stand-in for the
# sketched gradient's (2^31, 1), which 18b times.
FWHT_COLUMN_N = 1 << 24

# Kernels the main path launches. No path of the JAX package calls gram
# (its drift monitor takes kappa in plain jnp); the port's drift monitor
# takes each sampled kernel column from it (phase 9).
MAIN_PATH = ("kmeans_assign", "extend_embed", "fit_sketch", "fwht", "srht_t",
             "embed_assign", "gram_stripe")
# Kernels that must equal their plain versions exactly (by value: srht_t
# may give +0 where the plain version gives -0).
EXACT = ("fwht", "srht_t")
# Kernels that must give the same bits on two launches at the main shapes.
REPEAT = EXACT + ("fit_sketch", "extend_embed", "gram_stripe",
                  "embed_assign")
# The widest bucket's stripe (512) is the main shape; these are the
# buckets of requests of 129-256, 64, and 1-8 queries. extend_embed gives
# each warp 2, 1 and 1 query tiles there, 4 at 512.
SERVE_WIDTHS = (256, 64, 8)
ASSIGN_CASE = {"n": 513, "r": 16, "k": 100}   # kmeans_assign's widest case
# Kernels built on the tensor cores: phase_build reports their registers,
# shared memory and HMMA instructions.
TENSOR_CORE = {"fit_sketch": "fit_sketch_kernel",
               "extend_embed": "extend_embed_kernel",
               "gram_stripe": "gram_kernel"}
GRAM_WIDE = 4096         # the column-tiled gram shape: 8 chunks of 512
# gram at p past the main path's 19: resident in four chunks of 128
# columns (100), and walked in chunks of p (400).
GRAM_DEEP = (100, 400)
RBF_GAMMA = 0.5          # the registry's rbf cases
# Phase 8: the Nystrom landmark counts at n = 100,000 (default_nystrom_m,
# and one that fills eight extend_embed training ranges), the exact
# backend's n (its gram is 400 MB and its eigh takes seconds), and the
# landmark widths extend_embed and embed_assign are held at.
NYSTROM_M = (64, 1024)
N_EXACT = 10_000
LANDMARK_N = (10, 20, 50, 64, 1024)
LANDMARK_W = (BLOCK, 8)
# Phase 9: the async front door's traffic (requests of 1-64 held-out
# queries from seed 0; the JAX bench's defaults), the requests left
# pending at the warm swap, every pow-2 bucket a coalesced flush can hit;
# the streaming loop's first fit (the first half of the training columns,
# which the proxy's class blocks leave with classes 0-3 only), the drifted
# pool (columns past 70,000 and the held-out queries: classes 4-6), the
# columns of each kind of traffic and its request width.
ASYNC_REQUESTS = 256
ASYNC_WIDTHS = (1, 64)
SWAP_PENDING = 8
ALL_BUCKETS = tuple(8 << i for i in range(8))          # 8 .. 1,024
STREAM_HALF = 50_000
DRIFT_FROM = 70_000
TRAFFIC_COLS = 2_000
TRAFFIC_WIDTH = 50
PIN_OWNER = "chip_smoke"
# Phase 10: replicas behind the fleet's front door (on the one card), the
# keys sent twice under hash routing, the per-replica queue cap of the
# overload, and benchmark_fleet's replica counts and requests.
FLEET_WORKERS = 2
FLEET_KEYS = 64
OVERLOAD_DEPTH = 64
FLEET_SWEEP = (1, 2, 4)
FLEET_BENCH_REQUESTS = 192
FLEET_KW = {"max_wait_ms": 2.0, "slo_ms": 250.0}     # the JAX bench's
# Phase 11: the model leaves a sharded fit must give bit for bit, and
# benchmark_fit_scaling's capacities.
DIST_FIT_LEAVES = ("stream_w", "stream_row_norms2", "eigvals", "centroids",
                   "U")
FIT_SCALING_NS = (25_000, 50_000, 100_000)
# Phase 12: the serving launcher at n = 100,000 on its own data
# (blob_ring, p = 2, k = 2, r = 2): the main run with every check and
# every bench, a Nystrom run and a two-pass run in-process; the sharded
# runs under torchrun and the six examples as processes, all at once.
LAUNCHER_RUNS = {
    "main": ["--n", "100000", "--k", "2", "--r", "2", "--swap", "--stream",
             "--fleet", "--bench", "all", "--batch-sizes", "64,512,4096",
             "--queries", "8192"],
    "nystrom": ["--backend", "nystrom", "--nystrom-m", "1024", "--n",
                "100000", "--bench", "sync"],
    "two-pass": ["--fused-embed", "off", "--n", "100000", "--bench",
                 "sync"],
}
# Kernels each in-process run must launch.
LAUNCHER_MUST = {"main": ("srht_t", "extend_embed", "embed_assign"),
                 "nystrom": ("extend_embed", "embed_assign"),
                 "two-pass": ("kmeans_assign",)}
# The bench file's sections: sync's "results" and the seven others.
BENCH_SECTIONS = ("results", "async", "fused", "swap", "backends", "stream",
                  "fit_scaling", "fleet")
LAUNCHER_SHARDED_N = 100_000
# The sharded runs under torchrun: the sync bench, and the async bench
# (through the rank-0 pump) with the lifecycle check --swap.
LAUNCHER_SHARDED = {"sync": ["--bench", "sync"],
                    "async": ["--bench", "async", "--swap"]}
# The broken world, started with them: the launcher under torchrun with
# rank 0's compute made to fail on its first pumped flush
# (tests/torch_world_teardown_worker.py, a group timeout of
# LAUNCHER_BROKEN_TIMEOUT s). launch/mesh.py must end it: the rank's own
# BROKEN_EXIT (70) in torchrun's report, within LAUNCHER_BROKEN_S, and no
# abort in its output.
LAUNCHER_BROKEN = ["--sharded", "--bench", "async", "--smoke"]
LAUNCHER_BROKEN_TIMEOUT = 20
LAUNCHER_BROKEN_S = 120.0
ABORT_MARKS = ("terminate called", "Watchdog caught", "SIGABRT",
               "Signal 6", "Fatal Python error")
EXAMPLES = ("torch_quickstart", "torch_serve_async", "torch_stream_refit",
            "torch_cluster_embeddings", "torch_train_lm")
TORCHRUN = ["-m", "torch.distributed.run", "--standalone",
            "--nproc_per_node=1"]
# Output arguments of a wrapper, left out of the calls phase 12 keeps.
OUTPUT_KW = ("labels", "d2")

# Phase 13: the decoder-only LM serving path. (a) phi4-mini-3.8b at full
# width and depth through the LM launcher as a process; (b) the same model
# in process, held to its own invariants and timed warm, and at depth 2 in
# f32; (c) the other six decoder-only archs at their published widths,
# depth cut to 2, one at a time, and mixtral's sliding ring at full width
# at the layer (a prefill of 4,100 > window 4,096, then 3 decode steps);
# (d) (b)'s model through the mesh's serving steps on a NCCL world of one,
# prefill and LM_MESH_STEPS greedy steps bit for bit with the meshless
# steps.
LM_ARCH = "phi4-mini-3.8b"
LM_B, LM_S, LM_GEN, LM_MAX_SEQ = 8, 512, 32, 1024
LM_SERVE = ["--no-smoke", "--arch", LM_ARCH, "--batch", str(LM_B),
            "--prompt-len", str(LM_S), "--gen", str(LM_GEN), "--max-seq",
            str(LM_MAX_SEQ)]
LM_OTHERS = ("qwen3-14b", "command-r-plus-104b", "nemotron-4-340b",
             "pixtral-12b", "mixtral-8x7b", "dbrx-132b")
LM_CUT_DEPTH = 2
LM_OTHERS_B, LM_OTHERS_S, LM_OTHERS_GEN = 4, 256, 8
RING_S, RING_STEPS = 4100, 3
LM_MESH_STEPS = 4
LM_F32_TOL = 1e-4        # abs on logits: the CPU tests' bound against JAX
LM_RING_TOL = 1e-4       # relative to the largest |output|, f32
# bf16 keeps 8 significant bits, so one rounding moves a value v by up to
# ulp(v) = 2^(floor(log2 |v|) - 7), 2^-8 |v| on average. prefill(S) runs
# every layer at forward(S)'s shapes: only the unembedding's GEMM (one row
# in S) differs, and dbrx's top-4 scatter-add sums in the order its
# atomics land: LM_PREFILL_ULPS ulps of the largest logit. A decode step
# runs every GEMM at M = B where forward runs M = B x (S + 1), so any of a
# layer's LM_ROUNDINGS rounded outputs (q, k, v, scores, probabilities,
# o-projection, MLP) may round the other way, and those steps add up like
# a random walk: sqrt(LM_ROUNDINGS x layers) x 2^-8 x the largest logit
# (phi4 at depth 32: 0.30 against logits up to 5.2; one attention layer:
# 1.0e-2 relative).
LM_PREFILL_ULPS = 2
LM_ROUNDINGS = 7

# Phase 14: the hybrid family (models/rglru.py: RG-LRU blocks and local
# attention). (a) recurrentgemma-2b at its published widths and all 26
# layers (8 x (R R A) + R R) through the LM launcher as a process, at
# phase 13's batch, prompt, steps and cache; (b) the same model in process
# in bf16, held to prefill == forward and decode == forward, then the ring
# past the window (batch 1, a prompt of HY_RING_S > window 2,048 into a
# cache of 2,048 slots, HY_RING_STEPS decode steps, each against the
# forward at its position), timed warm, a decode step profiled; the same
# checks in f32 at depth 3 (one R R A superblock).
HY_ARCH = "recurrentgemma-2b"
HY_SERVE = ["--no-smoke", "--arch", HY_ARCH, "--batch", str(LM_B),
            "--prompt-len", str(LM_S), "--gen", str(LM_GEN), "--max-seq",
            str(LM_MAX_SEQ)]
HY_CUT_DEPTH = 3
HY_RING_S, HY_RING_STEPS = 2100, 3
# An R layer's decode step differs from its forward in more than GEMM
# shapes: against the f32 cache (the launchers') it runs the width-4 conv
# and the r / i gate products in f32 where the forward rounds them to
# bf16, so every bf16 rounding of the R layer's forward counts as a step
# of bf16_tol's random walk: the two norms (2 each), the u, i, gate and
# out products (4), the conv's 4 products and 3 sums (7), h's cast, the
# gelu's cast, h x gate and the two residual adds (5), the MLP's three
# products, its gelu and its product of halves (5): 25. The r gate's
# rounding counts more: it moves log a = -8 softplus(lam) r, so h, by
# |log a| times its size, whose mean square is 64 E[softplus(lam)^2]
# E[r^2] = 64 x 1.00 x 0.293 = 18.8 steps for lam ~ U[0, 1) and r the
# sigmoid of a unit-variance projection (init_rglru_block's draws): 44.
HY_R_ROUNDINGS = 44

# Phase 15: the ssm family (models/rwkv6.py: RWKV-6 "Finch", no attention).
# (a) rwkv6-1.6b at its published widths and all 24 layers through the LM
# launcher as a process, at phase 13's batch, prompt, steps and cache; (b)
# the same model in process in bf16: prefill(LM_S) == forward(LM_S)[:, -1],
# then SSM_STEPS teacher-forced decode steps on the next tokens, step i
# against forward(LM_S + SSM_STEPS) at position LM_S + i (the WKV core
# takes a prompt longer than a chunk of 64 only in whole chunks, as the JAX
# package asserts, so forward(LM_S + 1) does not run), and the state
# handoff: prefill(LM_S + SSM_STEPS)'s s, tm and cm against the cache the
# steps leave; timed warm, a decode step profiled; the same checks in f32
# at depth SSM_CUT_DEPTH, the state within rtol and atol SSM_STATE_TOL
# (tests/test_rwkv_wkv.py's bound).
SSM_ARCH = "rwkv6-1.6b"
SSM_SERVE = ["--no-smoke", "--arch", SSM_ARCH, "--batch", str(LM_B),
             "--prompt-len", str(LM_S), "--gen", str(LM_GEN), "--max-seq",
             str(LM_MAX_SEQ)]
SSM_CUT_DEPTH = 2
SSM_STEPS = 64
SSM_STATE_TOL = 2e-4
# An RWKV layer's bf16 roundings, each a step of bf16_tol's random walk:
# the two norms (2 each), the seven token-shift mixes (x + (xs - x) mu: 3
# each, 21), the r, k, v, g, W_a and W_o products, tanh and the cast of the
# silu-gated f32 output (8), the channel mix's two products before relu,
# the square, its product with c_v, the sigmoid's cast and the gating
# product (6), the two residual adds (2): 41. The decay's two (W_a, tanh)
# move log w by |log w| times their size, and the state carries that over
# its memory of 1 / (1 - w^2) steps as it carries a rounding of k or v:
# 2 x E[(log w)^2 (d log log w)^2 / (1 - w^2)] = 0.29 of a step at
# init_rwkv's draws (w0 = -0.6, the LoRA's N(0, 1 / fan-in) weights, 15 %
# of channels at the clamp), under the two full steps already counted.
RWKV_ROUNDINGS = 41

# Phase 16: the encoder-decoder family (models/whisper.py: 32 encoder and
# 32 decoder layers over 1,500 audio frames, cross-attention). (a)
# whisper-large-v3 at its published widths and full depth through the LM
# launcher as a process, at phase 13's batch, prompt, steps and cache
# (whisper's published decoder context is 448 text positions; the JAX
# model has no position table, so 512 runs, and the four families
# compare); (b) the same model in process in bf16, its frames drawn on the
# card from SEED + 2 in cfg.dtype: prefill(LM_S) == forward(LM_S)[:, -1],
# the cache's xk and xv bit for bit each decoder layer's _cross_kv of
# encode(frames), ED_STEPS teacher-forced decode steps, step i against
# forward(LM_S + ED_STEPS)[:, LM_S + i], xk and xv unchanged by them;
# timed warm, a decode step profiled; the same checks in f32 at depth
# ED_CUT_DEPTH (encoder and decoder).
ED_ARCH = "whisper-large-v3"
ED_SERVE = ["--no-smoke", "--arch", ED_ARCH, "--batch", str(LM_B),
            "--prompt-len", str(LM_S), "--gen", str(LM_GEN), "--max-seq",
            str(LM_MAX_SEQ)]
ED_CUT_DEPTH = 2
ED_STEPS = 8
# A decoder layer's decode step rounds what an attention layer's does
# (LM_ROUNDINGS: q, k, v, scores, probabilities, o-projection, MLP) and
# its cross-attention's q, scores, probabilities and o-projection: 11.
# The cross K/V and the encoder's output are the same bits in decode and
# in the forward (the same products at the same shapes; the f32 cache
# holds bf16 values exactly), so they add none, at any step.
ENCDEC_ROUNDINGS = LM_ROUNDINGS + 4

# Phase 17: the single-process training loop (train/optimizer.py,
# train/steps.py, launch/train.py; no kernel of the port's lies on it).
# (a) phi4-mini-3.8b at its published widths and all 32 layers through the
# training launcher as a process: TRAIN_STEPS steps on a fixed batch of
# TRAIN_B x TRAIN_S tokens, the config's microbatches (2) and remat, lr
# TRAIN_LR; the loss must fall; (b) in process: the smoke config at M 2
# with remat, f32, on the card against the CPU (TRAIN_PARITY_STEPS
# steps, TRAIN_TOL), a checkpoint / restart through launch.train.run at
# --smoke under build/ (TRAIN_CKPT_STEPS then TRAIN_RESUME_STEPS against
# an uninterrupted run), one full-width layer's bf16 parameters and bf16
# moments saved and restored bit for bit; (c) one warm step of (a)'s
# configuration in process, split by CUDA events and profiled.
TRAIN_ARCH = "phi4-mini-3.8b"
TRAIN_B, TRAIN_S, TRAIN_STEPS = 4, 512, 8
TRAIN_LR = 3e-3                  # the JAX launcher's default
TRAIN_RUN = ["--no-smoke", "--arch", TRAIN_ARCH, "--batch", str(TRAIN_B),
             "--seq", str(TRAIN_S), "--steps", str(TRAIN_STEPS), "--lr",
             str(TRAIN_LR)]
TRAIN_PARITY_STEPS = 3
TRAIN_CKPT_STEPS, TRAIN_RESUME_STEPS = 4, 8
# The card against the CPU in f32 (TF32 off), as tests/test_torch_train.py
# holds the port against JAX: loss and grad norm relative; m and v against
# their tensor's largest |value|; parameters against lr (a step moves an
# element by lr m_hat / (sqrt(v_hat) + eps), whose relative error is the
# gradient's where the gradient is small). An element may miss only if its
# gradient at some step was below `small` of its tensor's largest (the
# first step's m_hat / sqrt(v_hat) is g / |g|: noise there flips +-lr),
# and such elements stay under `miss` of each tensor.
TRAIN_TOL = {"loss": 1e-5, "gnorm": 1e-5, "moments": 5e-4, "lr_frac": 0.05,
             "small": 1e-6, "miss": 1e-3}

# Phase 18 (train-mesh): (a) the launcher under torchrun (one rank,
# --data 1 --model 1: the mesh, the sharded state and step) at phi4's full
# width and depth, MESH_STEPS steps of TRAIN_RUN's batch, against the
# meshless step in process from the same seed: loss, grad norm and a
# checksum of every parameter and moment bit for bit, the peak within
# MESH_PEAK_TOL of phase 17's; (b) rwkv6-1.6b (n_pad = 2^31) at full width
# and depth with --sketch-grads SKETCH_R in process: the loss falls, the
# ratio is n / r', the transform's ms and the peak (<= SKETCH_PEAK_GB);
# the projection's identities on the first step's gradient, fwht_op at
# (2^31, 1) against fwht_ref (the same bits) and its bound; (c) compress
# and decompress at the ten smoke configs' n, the card against the CPU's
# plain path, within FWHT_TOL.
MESH_STEPS = 3
MESH_RUN = ["--no-smoke", "--arch", TRAIN_ARCH, "--batch", str(TRAIN_B),
            "--seq", str(TRAIN_S), "--steps", str(MESH_STEPS), "--lr",
            str(TRAIN_LR), "--data", "1", "--model", "1"]
MESH_PEAK_TOL = 0.05
SKETCH_ARCH = "rwkv6-1.6b"
SKETCH_R = 1 << 28                       # ratio n / r' = 5.90 at rwkv6
SKETCH_STEPS = 8
SKETCH_RUN = ["--no-smoke", "--arch", SKETCH_ARCH, "--batch", str(TRAIN_B),
              "--seq", str(TRAIN_S), "--steps", str(SKETCH_STEPS), "--lr",
              str(TRAIN_LR), "--sketch-grads", str(SKETCH_R)]
SKETCH_PEAK_GB = 75.0
# The transform's ms a warm step and fwht_op's ms at (2^31, 1) when one
# column ran through the pass kernel alone (one lane of eight live),
# printed beside this run's: chip_smoke, H100 80GB HBM3, 700.00 W.
SKETCH_TRANSFORM_BEFORE_MS = (707.4, 732.1)
FWHT_COLUMN_BEFORE_MS = 267.7
SKETCH_SMOKE_R = 4096
FWHT_TOL = 2e-4                          # fwht's registry tolerance
# 18d: the switch of sequence parallelism around the sharded step on a
# NCCL world of one, these smoke configs at B x S.
SEQ_WORLD_ARCHS = (TRAIN_ARCH, ED_ARCH)
SEQ_WORLD_B, SEQ_WORLD_S = 4, 64
CHECK_CHUNK = 1 << 26                    # elements a checksum pass reads

# Phase 19 (dryrun): (a) the dry run of phase 17's step in a dry-run world
# of one rank: its peak within DRY_PEAK_TOL of 17a's measured
# max_memory_allocated, its flops within DRY_FLOPS_TOL of lm_bounds' plus
# the masked attention pairs and remat's recompute (dryrun_flops); (b)
# phi4-mini-3.8b x train_4k on the 16 x 16 dry-run mesh, its collective
# bytes equal to the step's plan; (c) the same for recurrentgemma-2b,
# tensor-parallel hybrid, at DRY_HY_LAYERS layers (one (R, R, A)
# superblock and the (R, R) remainder); (d) rwkv6-1.6b, tensor-parallel
# ssm, at DRY_SSM_LAYERS layers; (e) whisper-large-v3, tensor-parallel
# encdec, at DRY_ED_LAYERS encoder and decoder layers; (f)-(k) the
# serving cells DRY_SERVE_CELLS at DRY_SERVE_LAYERS layers (whisper's
# encoder too), tensor-parallel through the mesh's serving steps, held to
# dryrun.serve_plan; (l) and (m) below. No device memory, no kernel; the
# whole phase within DRY_SECONDS.
DRY_PEAK_TOL = 0.05
DRY_FLOPS_TOL = 0.03
DRY_SECONDS = 120
DRY_HY_LAYERS = 5
DRY_SSM_LAYERS = 4
DRY_ED_LAYERS = 4
DRY_SERVE_LAYERS = 4
DRY_SERVE_CELLS = (("19f", "phi4-mini-3.8b", "prefill_32k"),
                   ("19g", "phi4-mini-3.8b", "decode_32k"),
                   ("19h", "mixtral-8x7b", "long_500k"),
                   ("19i", HY_ARCH, "prefill_32k"),
                   ("19j", SSM_ARCH, "decode_32k"),
                   ("19k", ED_ARCH, "prefill_32k"))
# (l) phi4-mini-3.8b x train_4k and (m) recurrentgemma-2b x prefill_32k
# with seq_shard_acts on (sequence parallelism over the model axis: the
# dry run enters activation_sharding(seq_axis="model", seq_div=16)), at
# DRY_SEQ_LAYERS layers, held to their plans as (b) and (f)-(k) are.
DRY_SEQ_LAYERS = 4
# (n) DRY_USE_ARCH x train_4k at DRY_USE_LAYERS layers gathering each
# parameter at its use and, with pregather, once a step: both held to
# their plans, the peak at use lower by the blocks but two.
DRY_USE_ARCH = "mixtral-8x7b"
DRY_USE_LAYERS = 4
USE_CUTS = {"at use": {"n_layers": DRY_USE_LAYERS},
            "pregather": {"n_layers": DRY_USE_LAYERS, "pregather": True}}
# The phase's cells run at once: DRY_HERE in this process, whose imports
# are warm, the others in DRY_JOBS spawned processes, the longest first
# (a spawned process's first cell spent 14-17 s in cold imports on the card
# machine). Each is one core's work on fake tensors; one after another
# they took 101-141 s of host time on the card machine (8 cores).
DRY_JOBS = 5
DRY_HERE = ("19b",)

SOURCES = {
    "gram_stripe": ("src/repro_torch/kernels/csrc/gram.cu",
                    "src/repro/kernels/gram/gram.py:25"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kmeans_assign.py:21"),
    "extend_embed": ("src/repro_torch/kernels/csrc/extend_embed.cu",
                     "src/repro/kernels/extend_embed/extend_embed.py:30"),
    "fit_sketch": ("src/repro_torch/kernels/csrc/fit_sketch.cu",
                   "src/repro/kernels/fit_sketch/fit_sketch.py:42"),
    "fwht": ("src/repro_torch/kernels/csrc/fwht.cu",
             "src/repro/kernels/fwht/fwht.py:28"),
    # The fwht kernel's SRHT form: the same TPU kernel with the pad, sign
    # and gather of src/repro/core/sketch.py:104 (srht_apply_t) fused in.
    "srht_t": ("src/repro_torch/kernels/csrc/fwht.cu",
               "src/repro/kernels/fwht/fwht.py:28"),
    # kmeans_assign folded into extend_embed's summing launch
    # (sum_assign_kernel, through csrc/assign.cuh).
    "embed_assign": ("src/repro_torch/kernels/csrc/extend_embed.cu",
                     "src/repro/kernels/kmeans_assign/kmeans_assign.py:21"),
}


def log(msg: str) -> None:
    print(msg, flush=True)


def nvidia_smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True,
        check=True, timeout=60)
    return out.stdout.strip().splitlines()[0]


def cuda_ms(torch, fn, reps: int = 7, warm: int = 2) -> float:
    """Median device time of fn() in ms, by CUDA events."""
    for _ in range(warm):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        b.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def cuda_ms_back_to_back(torch, fn, calls: int = 10) -> float:
    """Device time per call of `calls` calls enqueued back to back, by CUDA
    events: the host's work per call hides behind the card's, where
    cuda_ms counts it whenever it exceeds the card's."""
    fn()
    torch.cuda.synchronize()
    a = torch.cuda.Event(enable_timing=True)
    b = torch.cuda.Event(enable_timing=True)
    a.record()
    for _ in range(calls):
        fn()
    b.record()
    b.synchronize()
    return a.elapsed_time(b) / calls


def profiled(torch, fn, calls: int = 1) -> tuple:
    """`calls` calls of fn under a torch.profiler (CUPTI) trace: the host
    clock to the last synchronize in ms, and {kernel or copy: (records,
    device ms)}."""
    from torch.profiler import ProfilerActivity, profile
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
        host_s = time.perf_counter() - t0
    device = {}
    for e in prof.key_averages():
        us = getattr(e, "self_device_time_total",
                     getattr(e, "self_cuda_time_total", 0))
        if us > 0:
            device[e.key] = (e.count, us / 1e3)
    return host_s * 1e3, device


def device_ms(torch, fn, calls: int = 20):
    """Card time per call of fn, which launches each of its kernels once:
    the sum over its kernels of each one's mean device time per record
    (a mean stays right where a trace drops some records). None when the
    trace shows no device time."""
    fn()
    torch.cuda.synchronize()
    device = profiled(torch, fn, calls)[1]
    return sum(ms / n for n, ms in device.values()) or None


def max_err(torch, got, want) -> float:
    """Largest abs difference of the float outputs (labels are counted
    apart, by label_mismatches)."""
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((g - w.to(g.device)).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want) if g.is_floating_point())


def label_mismatches(got, want) -> int:
    """Rows whose labels differ between two (labels, d2) results."""
    return int((got[0] != want[0].to(got[0].device)).sum())


# -- bounds: the least time the card could take, from the shapes ------------

def kappa_ops(kind: str, degree: int) -> int:
    """Flops per kernel entry beyond the 2p of the contraction."""
    if kind == "polynomial":
        return 1 + max(int(degree) - 1, 0)
    if kind == "rbf":
        return 6           # 2 adds, 2 muls, max, exp
    return 0


def bound(ops: float, nbytes: float) -> dict:
    t_ops, t_bytes = ops / FP32_FLOPS, nbytes / HBM_BYTES_PER_S
    by = "operations" if t_ops >= t_bytes else "bytes"
    return {"bound_ms": max(t_ops, t_bytes) * 1e3, "bound_by": by,
            "bound_us": max(t_ops, t_bytes) * 1e6,
            "ops": ops, "bytes": nbytes}


def gram_bound(p, n, w, kind, degree):
    from repro_torch.kernels.gram.ops import gram_stripe_bytes
    return bound(n * w * (2 * p + kappa_ops(kind, degree)),
                 gram_stripe_bytes(p, n, w))


def assign_bound(n, r, k):
    from repro_torch.kernels.kmeans_assign.ops import assign_bytes
    return bound(n * k * (2 * r + 3) + (n + k) * 2 * r, assign_bytes(n, r, k))


def embed_assign_bound(p, n, r, w, k, kind, degree):
    """extend_embed's work, then per query the assignment's 2r flops of
    |y|^2 and k (2r + 3) of the distances; its outputs are the labels and
    distances (the embedding it writes as scratch is not counted)."""
    from repro_torch.kernels.kmeans_assign.ops import embed_assign_bytes
    return tc_bound(embed_assign_bytes(p, n, r, w, k),
                    n * w * (2 * p + 2 * r),
                    n * w * kappa_ops(kind, degree) + w * (2 * r
                                                           + k * (2 * r + 3)))


def extend_bound(p, n, r, w, kind, degree):
    from repro_torch.kernels.extend_embed.ops import extend_embed_bytes
    return bound(n * w * (2 * p + kappa_ops(kind, degree) + 2 * r),
                 extend_embed_bytes(p, n, r, w))


def fit_bytes(p, m, b, rp):
    """X, Omega, C, Ocross read once; new_rows, delta and the norms written
    once (the main path passes no V): fit_sketch_bytes."""
    from repro_torch.kernels.fit_sketch.ops import fit_sketch_bytes
    return fit_sketch_bytes(p, m, b, rp)


def fit_bound(p, m, b, rp, kind, degree):
    """fp32 on the CUDA cores. Per (m, b) entry: the tile, 2r' each for
    new_rows and delta, and 3 for the norms (one square shared by rn_rows
    and rn_cols, two adds)."""
    per_entry = 2 * p + kappa_ops(kind, degree) + 4 * rp + 3
    return bound(m * b * per_entry, fit_bytes(p, m, b, rp))


def tc_bound(nbytes, tensor_flops, other_flops) -> dict:
    """A tensor-core kernel's bound: its products (unpadded) on the tensor
    cores at three TF32 products each, the rest on the CUDA cores, the
    bytes over HBM; the largest of the three."""
    terms = {"bytes": nbytes / HBM_BYTES_PER_S,
             "tensor cores (3xTF32)": 3 * tensor_flops / TF32_FLOPS,
             "CUDA cores": other_flops / FP32_FLOPS}
    term = max(terms, key=terms.get)
    return {"bound_ms": terms[term] * 1e3,
            "bound_us": terms[term] * 1e6,
            "bound_by": "bytes" if term == "bytes" else "operations",
            "bound_term": term,
            "bound_terms_ms": {k: v * 1e3 for k, v in terms.items()}}


def fit_tc_bound(p, m, b, rp, kind, degree):
    """fit_sketch's three products take 2p + 4r' flops per entry; kappa
    and the norms the rest."""
    return tc_bound(fit_bytes(p, m, b, rp), m * b * (2 * p + 4 * rp),
                    m * b * (kappa_ops(kind, degree) + 3))


def extend_tc_bound(p, n, r, w, kind, degree):
    """extend_embed's two products take 2p + 2r flops per entry; kappa the
    rest."""
    from repro_torch.kernels.extend_embed.ops import extend_embed_bytes
    return tc_bound(extend_embed_bytes(p, n, r, w),
                    n * w * (2 * p + 2 * r), n * w * kappa_ops(kind, degree))


def fwht_bound(n, c):
    """One read and one write of x; n c log2(n) adds."""
    from repro_torch.kernels.fwht.ops import fwht_bytes
    return bound(n * c * (n.bit_length() - 1), fwht_bytes(n, c))


def srht_t_bound(m, c, rows, n_pad):
    """One read of M's m rows and of the signs, one write of the (r', c)
    result; the adds of the blocks this sketch's plan runs (its sampled
    rows decide which)."""
    from repro_torch.kernels.fwht.ops import srht_plan, srht_t_bytes
    adds = sum(len(p.bases) * (p.k << p.k) for p in srht_plan(rows, n_pad))
    return bound(adds * c, srht_t_bytes(m, c, len(rows), n_pad))


# -- phases -------------------------------------------------------------------

def timed(torch, fn) -> tuple:
    """(fn's result, seconds), the card synchronized before and after."""
    sync(torch)
    t0 = time.perf_counter()
    out = fn()
    sync(torch)
    return out, time.perf_counter() - t0


def sync(torch) -> None:
    if DEVICE == "cuda":
        torch.cuda.synchronize()


def equal_fits(torch, what, a, b, names=DIST_FIT_LEAVES) -> None:
    """The named model leaves, labels and centroids of two fits bit for
    bit."""
    for name in names:
        if not torch.equal(getattr(a.model_, name), getattr(b.model_, name)):
            raise AssertionError(f"{what}: {name} differs")
    if not torch.equal(a.labels_, b.labels_):
        raise AssertionError(f"{what}: labels differ")


def dist_fit(torch, X, y, est, mesh, tally, smi) -> dict:
    """11a: the sharded fit on both routes against the unsharded fits;
    chunked == one-shot and resumed == live on the mesh."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.serve import ComputePolicy
    canon_pol = ComputePolicy(fit_fused=False)
    mesh_canon = ComputePolicy(fit_fused=False, mesh=mesh)
    mesh_fused = ComputePolicy(mesh=mesh)
    canon, canon_s = timed(torch, lambda: KernelKMeans(
        **estimator_args(), policy=canon_pol).fit(X, seed=SEED))
    sharded, sharded_s = timed(torch, lambda: tally(lambda: KernelKMeans(
        **estimator_args(), policy=mesh_canon).fit(X, seed=SEED)))
    equal_fits(torch, "sharded canonical fit vs unsharded", sharded, canon)
    _, unsharded_fused_s = timed(torch, lambda: KernelKMeans(
        **estimator_args(), policy=ComputePolicy()).fit(X, seed=SEED))
    fused, fused_s = timed(torch, lambda: tally(lambda: KernelKMeans(
        **estimator_args(), policy=mesh_fused).fit(X, seed=SEED)))
    eig_err = float((fused.eigvals_ - est.eigvals_).abs().max())
    if not torch.allclose(fused.eigvals_, est.eigvals_, rtol=TOL, atol=TOL):
        raise AssertionError(f"sharded fused eigvals {fused.eigvals_} vs "
                             f"unsharded {est.eigvals_}")
    agree = clustering_accuracy(est.labels_, fused.labels_, K)
    if agree < 0.99:
        raise AssertionError(f"sharded fused labels agree on {agree}")
    fused_bitwise = all(torch.equal(getattr(fused.model_, n),
                                    getattr(est.model_, n))
                        for n in DIST_FIT_LEAVES)
    info = {"unsharded_canonical_fit_s": canon_s,
            "sharded_canonical_fit_s": sharded_s,
            "unsharded_fused_fit_s": unsharded_fused_s,
            "sharded_fused_fit_s": fused_s,
            "sharded_canonical_equals_unsharded": True,
            "sharded_fused_eigval_max_abs_err": eig_err,
            "sharded_fused_label_agreement": agree,
            "sharded_fused_bitwise_vs_unsharded": fused_bitwise,
            "accuracy_vs_generating_labels": clustering_accuracy(
                y, sharded.labels_, K)}
    chunks = N_TRAIN // STREAM_CHUNK
    for route, pol, one in (("canonical", mesh_canon, sharded),
                            ("fused", mesh_fused, fused)):
        live = KernelKMeans(**estimator_args(), policy=pol)

        def stream():
            for i in range(chunks):
                live.partial_fit(X[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK],
                                 seed=SEED, capacity=N_TRAIN,
                                 reeig=i == chunks - 1)
        _, info[f"{route}_chunked_s"] = timed(torch, lambda: tally(stream))
        equal_fits(torch, f"sharded {route} chunked vs one-shot", live, one)
    # Resume from a mid-stream artifact under the mesh.
    half = chunks // 2
    work = tempfile.TemporaryDirectory(dir=BUILD)
    live = KernelKMeans(**estimator_args(), policy=mesh_canon)

    def first_half():
        for i in range(half):
            live.partial_fit(X[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK],
                             seed=SEED, capacity=N_TRAIN,
                             reeig=i == half - 1)
    tally(first_half)
    path = live.save(str(pathlib.Path(work.name) / "mid"))
    resumed = KernelKMeans.load(path, device=DEVICE, policy=mesh_canon)
    for est_ in (live, resumed):
        def second_half(e=est_):
            for i in range(half, chunks):
                e.partial_fit(X[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK],
                              seed=SEED, reeig=i == chunks - 1)
        tally(second_half)
    equal_fits(torch, "resumed vs live under the mesh", resumed, live)
    work.cleanup()
    info["resumed_equals_live"] = info["chunked_equals_one_shot"] = True
    log(f"[distributed] fit at n={N_TRAIN}, world size 1 over NCCL: "
        f"canonical unsharded {canon_s:.3f} s, sharded {sharded_s:.3f} s "
        f"(stream_w, row norms, eigvals, labels, centroids equal bit for "
        f"bit); fused unsharded {unsharded_fused_s:.3f} s, sharded "
        f"{fused_s:.3f} s against phase 4's fit (eigvals max abs diff "
        f"{eig_err:.2e}, "
        f"labels agree {agree:.4f}, bitwise {fused_bitwise}); "
        f"{chunks} partial_fit chunks == one-shot on both routes "
        f"(canonical {info['canonical_chunked_s']:.3f} s, fused "
        f"{info['fused_chunked_s']:.3f} s), resumed == live [{smi}]")
    return info


def dist_serve(torch, model, Xq, mesh, tally, smi) -> dict:
    """11b: a ShardedExtender over the held-out queries against Extender;
    a MicroBatcher on the mesh policy, bucketed == unbatched."""
    from repro_torch.kernels.registry import near_tie_compare
    from repro_torch.serve import (ComputePolicy, Extender, MicroBatcher,
                                   ShardedExtender)
    pol = ComputePolicy(mesh=mesh)
    ext = Extender(model, policy=ComputePolicy())
    sh = ShardedExtender(model, policy=pol)
    emb = tally(lambda: sh.embed(Xq))
    if not torch.equal(emb, ext.embed(Xq)):
        raise AssertionError("ShardedExtender.embed != Extender.embed")
    got = tally(lambda: sh.assign(Xq))
    want, dists = plain_distances(torch, model, Xq)
    near_tie_compare(got, want, TOL, TOL, dists)
    near_tie_compare(got, ext.assign(Xq), TOL, TOL, dists)
    batcher = MicroBatcher(model, policy=pol)
    batcher.warm(REQUESTS)
    offs = np.cumsum((0,) + REQUESTS)
    reqs = [Xq[:, a:b] for a, b in zip(offs, offs[1:])]
    answers = tally(lambda: [batcher.assign_batch(r) for r in reqs])
    for b, req, ans in zip(REQUESTS, reqs, answers):
        lab, d2 = (x.cpu().numpy() for x in sh.assign(req))
        if not (np.array_equal(ans[0], lab)
                and np.array_equal(ans[1].view(np.int32), d2.view(np.int32))):
            raise AssertionError(f"mesh batcher, request of {b}: bucketed "
                                 f"!= unbatched")
    reps = 10
    _, sh_s = timed(torch, lambda: [sh.assign(Xq) for _ in range(reps)])
    _, ext_s = timed(torch, lambda: [ext.assign(Xq) for _ in range(reps)])
    info = {"queries": N_QUERY, "embed_equals_extender": True,
            "bucketed_equals_unbatched": True,
            "label_mismatch_vs_extender": float(
                (got[0] != want[0]).float().mean()),
            "sharded_assign_queries_per_s": reps * N_QUERY / sh_s,
            "extender_assign_queries_per_s": reps * N_QUERY / ext_s}
    log(f"[distributed] ShardedExtender over {N_QUERY} held-out queries: "
        f"embed == Extender.embed bit for bit, labels by the near-tie rule, "
        f"mesh MicroBatcher bucketed == unbatched; assign "
        f"{info['sharded_assign_queries_per_s']:.0f} q/s (extend_embed + "
        f"all_reduce + kmeans_assign) beside Extender.assign "
        f"{info['extender_assign_queries_per_s']:.0f} q/s (embed_assign) "
        f"[{smi}]")
    return info


def dist_alg1(torch, X, y, est, mesh, tally, smi) -> dict:
    """11c: Alg. 1 on the mesh at n = 100,000 padded to 131,072, draws
    from seed 0; the butterfly against fwht_op on a stripe, W against the
    accumulator's sketch on the same draws."""
    from repro_torch.core import kernel_approx_error_streaming
    from repro_torch.core.kernels_fn import make_kernel
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.sketch import SRHT
    from repro_torch.distributed.cluster import (
        distributed_one_pass_kernel_kmeans, distributed_sketch)
    from repro_torch.distributed.dfwht import distributed_fwht
    from repro_torch.kernels import fwht_op
    from repro_torch.launch.cluster import alg1_draws
    from repro_torch.stream.accumulate import SketchAccumulator
    kern = make_kernel("polynomial", gamma=KERNEL["gamma"],
                       degree=KERNEL["degree"])
    Xp = torch.nn.functional.pad(X, (0, N_PAD - N_TRAIN))
    signs, rows, inits = alg1_draws(SEED, N_PAD, RP, K, 10, X.device)
    stripe = (kern(Xp, Xp[:, :BLOCK]) * signs[:, None]).contiguous()
    dfw = tally(lambda: distributed_fwht(stripe, mesh))
    if not torch.equal(dfw, fwht_op(stripe)):
        raise AssertionError("distributed_fwht != fwht_op on a stripe")
    W = tally(lambda: distributed_sketch(kern, Xp, mesh, signs, rows,
                                         block=BLOCK))
    acc = SketchAccumulator(kern, N_TRAIN, R, oversampling=OVERSAMPLING,
                            block=BLOCK, sketch=SRHT(signs=signs, rows=rows,
                                                     n=N_TRAIN, n_pad=N_PAD))
    W_acc = acc.add(X)._effective_state()[0]     # the ragged tail applied
    w_err = float((W[:N_TRAIN] - W_acc).abs().max())
    if not torch.allclose(W[:N_TRAIN], W_acc, rtol=TOL, atol=TOL):
        raise AssertionError(f"distributed W vs the accumulator's: {w_err}")
    res, alg1_s = timed(torch, lambda: tally(
        lambda: distributed_one_pass_kernel_kmeans(
            kern, Xp, K, R, mesh, signs, rows, inits, block=BLOCK)))
    Y = res.Y[:, :N_TRAIN]
    if not (bool(torch.isfinite(Y).all()) and tuple(Y.shape) == (R, N_TRAIN)):
        raise AssertionError("Alg. 1 on the mesh: Y not finite (r, n)")
    err = kernel_approx_error_streaming(kern, X, Y)
    err_single = kernel_approx_error_streaming(kern, X, est.embedding_)
    info = {"n": N_TRAIN, "n_pad": N_PAD, "alg1_s": alg1_s,
            "W_max_abs_err_vs_accumulator": w_err,
            "distributed_fwht_equals_fwht_op": True,
            "eigvals": res.eigvals.tolist(), "approx_error": err,
            "approx_error_single_host_fit": err_single,
            "accuracy": clustering_accuracy(y, res.labels[:N_TRAIN], K),
            "accuracy_single_host_fit": clustering_accuracy(
                y, est.labels_, K)}
    log(f"[distributed] Alg. 1 on the mesh at n={N_TRAIN} (padded to "
        f"{N_PAD}): {alg1_s:.3f} s; distributed_fwht == fwht_op on a "
        f"({N_PAD}, {BLOCK}) stripe; W within {w_err:.2e} of the "
        f"accumulator's; approx error {err:.4f} (single-host fit "
        f"{err_single:.4f}), accuracy {info['accuracy']:.4f} (single-host "
        f"{info['accuracy_single_host_fit']:.4f}) [{smi}]")
    return info


def dist_checkpoint(torch, model, mesh) -> dict:
    """11e: CheckpointManager save / GC / restore_latest onto the mesh."""
    from torch.distributed.tensor import Replicate, Shard
    from repro_torch.distributed.checkpoint import CheckpointManager
    work = tempfile.TemporaryDirectory(dir=BUILD)
    mgr = CheckpointManager(work.name, save_every=1, keep=2,
                            async_saves=False)
    state = {"X_train": model.X_train, "stream_w": model.stream_w,
             "eigvals": model.eigvals}
    for step in range(1, 5):
        mgr.maybe_save(step, state)
    kept = sorted(p.name for p in pathlib.Path(work.name).iterdir())
    like = {k: torch.zeros_like(v) for k, v in state.items()}
    got, step = mgr.restore_latest(like, mesh=mesh, pspecs={
        "X_train": Shard(1), "stream_w": Shard(0), "eigvals": Replicate()})
    for k, v in state.items():
        if not torch.equal(got[k], v):
            raise AssertionError(f"checkpoint round trip: {k} differs")
    work.cleanup()
    if step != 4 or kept != ["step_3", "step_4"]:
        raise AssertionError(f"checkpoints kept {kept}, restored {step}")
    log(f"[distributed] CheckpointManager: 4 saves, GC kept {kept}, "
        f"restore_latest onto the mesh (Shard / Replicate) bit for bit")
    return {"kept": kept, "restored_step": step, "round_trip_equal": True}


def pumped_groups(torch, model, pol, reqs, groups) -> tuple:
    """The requests of each pumped flush, drained through a warmed mesh
    MicroBatcher, no pump: per request (labels, d2), and each drain's
    ms (its results are on the host when it returns)."""
    from repro_torch.serve import MicroBatcher
    mb = MicroBatcher(model, policy=pol)
    mb.warm([r.shape[1] for r in reqs])
    out, ms, at = [], [], 0
    for size in groups:
        for r in reqs[at:at + size]:
            mb.submit(r)
        t0 = time.perf_counter()
        out += mb.drain()
        ms.append((time.perf_counter() - t0) * 1e3)
        at += size
    return out, ms


def dist_pump(torch, model, Xq, mesh, tally, smi) -> dict:
    """11g: the rank-0 pump on the NCCL world of one rank. REQUESTS
    through a pumped AsyncBatcher, its pump thread live and the main
    thread as the client, equal to a mesh MicroBatcher drain of the same
    flushes bit for bit; a registry row with a pumped scheduler swapped
    under pending requests, 0 stranded. The launches of both runs are
    counted (every pumped flush runs under the pump's sequencer, so one
    thread launches at a time); the comparison drains are not."""
    from repro_torch.serve import AsyncBatcher, ComputePolicy, ModelRegistry
    from repro_torch.serve.pump import PUMP
    pol = ComputePolicy(mesh=mesh)
    offs = np.cumsum((0,) + REQUESTS)
    reqs = [Xq[:, a:b].cpu().numpy() for a, b in zip(offs, offs[1:])]
    ab = AsyncBatcher(model, max_wait_ms=2.0, policy=pol)
    ab.batcher.warm(REQUESTS)                # first launches, off the count
    flushes = []                             # (requests, seconds)
    inner = ab._broadcast_flush

    def timed_flush(batch):
        t0 = time.perf_counter()
        out = inner(batch)                   # numpy: the card is done
        flushes.append((len(batch), time.perf_counter() - t0))
        return out
    ab._broadcast_flush = timed_flush

    def served():
        ab.start()
        futs = [ab.submit(r) for r in reqs]
        ab.stop()
        return futs
    before = dict(tally.launches)
    PUMP.reset_counts()
    futs = tally(served)
    sent = PUMP.counts()
    got = [f.result(timeout=0) for f in futs]
    groups = [size for size, _ in flushes]
    want, drain_ms = pumped_groups(torch, model, pol, reqs, groups)
    same_answers("pumped AsyncBatcher against a mesh drain", got, want)
    # The swap: four requests pending (max_wait 100 s), the centroid rows
    # reversed in the new model; the same four after the swap.
    small = reqs[:4]
    reg = ModelRegistry()
    reg.register("pump", model, version=1)
    sched = reg.scheduler("pump", max_wait_ms=1e5, policy=pol)
    sched.batcher.warm(REQUESTS[:4])
    model_b = model._replace(centroids=torch.flip(model.centroids, [0]))

    def swapped():
        sched.start()
        pending = [sched.submit(r) for r in small]
        report = reg.swap("pump", model_b, version=2)
        stranded = sum(not f.done() for f in pending)
        new = reg.scheduler("pump")
        after = [new.submit(r) for r in small]
        new.flush()
        reg.unregister("pump")
        return pending, after, report, stranded
    PUMP.reset_counts()
    pending, after, report, stranded = tally(swapped)
    swap_sent = PUMP.counts()
    if stranded:
        raise AssertionError(f"the pumped swap stranded {stranded} futures")
    old = [f.result(timeout=0) for f in pending]
    new = [f.result(timeout=0) for f in after]
    same_answers("requests pending at the swap against the old model", old,
                 pumped_groups(torch, model, pol, small, [len(small)])[0])
    same_answers("requests after the swap against the new model", new,
                 pumped_groups(torch, model_b, pol, small, [len(small)])[0])
    flipped = sum(int((K - 1 - o[0] != n[0]).sum())
                  for o, n in zip(old, new))
    launches = {n: tally.launches[n] - before[n] for n in tally.launches}
    idle = [n for n in ("extend_embed", "kmeans_assign") if not launches[n]]
    if idle:
        raise AssertionError(f"11g never launched {idle}")
    ms = [sec * 1e3 for _, sec in flushes]
    info = {"requests": len(reqs), "queries": int(sum(REQUESTS)),
            "flushes": len(flushes), "flush_requests": groups,
            "flush_ms": ms, "ms_per_flush": sum(ms) / len(ms),
            "drain_ms": drain_ms,
            "messages": sent["messages"], "broadcasts": sent["broadcasts"],
            "bytes": sent["bytes"],
            "bytes_per_flush": sent["bytes"] / len(flushes),
            "equals_mesh_drain": True,
            "swap": {"flip_ms": report.flip_ms, "warm_s": report.warm_s,
                     "drain_s": report.drain_s,
                     "drained_requests": report.drained_requests,
                     "buckets_warmed": report.buckets_warmed,
                     "stranded": stranded, "messages": swap_sent["messages"],
                     "bytes": swap_sent["bytes"],
                     "labels_not_permuted": flipped},
            "launches": {n: launches[n] for n in ("extend_embed",
                                                  "kmeans_assign")}}
    log(f"[distributed] 11g rank-0 pump at world 1 over NCCL: {len(reqs)} "
        f"requests ({info['queries']} queries) in {len(flushes)} flushes "
        f"(requests {groups}) == a mesh MicroBatcher drain bit for bit; "
        f"{sent['messages']} messages ({sent['broadcasts']} broadcasts, "
        f"{sent['bytes']} bytes, {info['bytes_per_flush']:.0f} a flush), "
        f"{info['ms_per_flush']:.3f} ms a flush (each: "
        + ", ".join(f"{m:.3f}" for m in ms) + "; the same requests "
        "through a warmed mesh MicroBatcher drain, no pump: "
        + ", ".join(f"{m:.3f}" for m in drain_ms) + "); pumped swap under "
        f"{report.drained_requests} pending requests: flip "
        f"{report.flip_ms:.4f} ms, warm {report.warm_s:.3f} s, "
        f"{swap_sent['messages']} messages ({swap_sent['bytes']} bytes), "
        f"stranded 0, old model's answers before, the new's after "
        f"({flipped} labels not permuted); launches extend_embed "
        f"{launches['extend_embed']}, kmeans_assign "
        f"{launches['kmeans_assign']} [{smi}]")
    return info


def dist_launcher(smi) -> dict:
    """11f: the launcher under torchrun, one process on the card."""
    import os
    cmd = [sys.executable, "-m", "torch.distributed.run", "--standalone",
           "--nproc_per_node=1", "-m", "repro_torch.launch.cluster",
           "--distributed", "--dataset", "seg"]
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=300, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0:
        raise AssertionError(f"torchrun launcher exited {proc.returncode}:\n"
                             f"{proc.stdout[-2000:]}\n{proc.stderr[-2000:]}")
    log(f"[distributed] torchrun --standalone --nproc_per_node=1 -m "
        f"repro_torch.launch.cluster --distributed --dataset seg: exit 0 in "
        f"{seconds:.1f} s [{smi}]: " + " | ".join(lines))
    return {"torchrun_s": seconds, "lines": lines}


def phase_distributed(torch, est, X, y, Xq, smi) -> tuple:
    """Phase 11: the distributed package on a NCCL world of one rank that
    this phase makes and tears down: the sharded fit, sharded serving,
    Alg. 1 on the mesh, benchmark_fit_scaling, checkpoints, the rank-0
    pump (sharded async serving and the swap of a sharded row) and the
    launcher under torchrun. Launches counted on the sharded paths."""
    from repro_torch.launch.mesh import make_debug_mesh, open_world
    from repro_torch.serve import ComputePolicy, benchmark_fit_scaling
    t_phase = time.perf_counter()
    from repro_torch.api import KernelKMeans
    with open_world(DEVICE):
        mesh = make_debug_mesh(device=DEVICE)
        # First use of NCCL (the communicator is made at the first
        # collective) and of each sharded route, on a small fit outside the
        # counts and the clocks, as phase 4 warms cuBLAS.
        for fused in (False, None):
            KernelKMeans(**estimator_args(), policy=ComputePolicy(
                fit_fused=fused, mesh=mesh)).fit(X[:, :4096], seed=1)
        sync(torch)
        tally = LaunchTally(torch)
        BUILD.mkdir(parents=True, exist_ok=True)
        info = {"fit": dist_fit(torch, X, y, est, mesh, tally, smi),
                "serve": dist_serve(torch, est.model_, Xq, mesh, tally,
                                    smi),
                "alg1": dist_alg1(torch, X, y, est, mesh, tally, smi)}
        scaling = {}
        for route, fused in (("canonical", False), ("fused", None)):
            bench = benchmark_fit_scaling(
                est.model_, ns=FIT_SCALING_NS, repeats=1, seed=SEED,
                policy=ComputePolicy(fit_fused=fused, mesh=mesh))
            scaling[route] = bench
            log(f"[distributed] benchmark_fit_scaling, {route} route: " +
                "; ".join(f"n={r['n']}: single "
                          f"{r['single_cols_per_sec']:.0f} cols/s, sharded "
                          f"{r['sharded_cols_per_sec']:.0f} cols/s, "
                          f"sharded_over_single "
                          f"{r['sharded_over_single']:.3f}"
                          for r in bench["rows"]) + f" [{smi}]")
        info["fit_scaling"] = scaling
        info["checkpoint"] = dist_checkpoint(torch, est.model_, mesh)
        info["pump"] = dist_pump(torch, est.model_, Xq, mesh, tally, smi)
    info["launcher"] = dist_launcher(smi)
    idle = [n for n in ("fit_sketch", "fwht", "extend_embed",
                        "kmeans_assign") if tally.launches[n] == 0]
    if idle:
        raise AssertionError(f"phase 11 never launched {idle}")
    info["launches"] = tally.launches
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[distributed] launches {tally.launches}; phase 11 took "
        f"{info['phase_s']:.2f} s")
    return tally.launches, info


class CallKeeper:
    """Within `with`, a stand-in takes the place of each kernel wrapper in
    every repro_torch module but the wrappers' own (where a wrapper counts
    its launches through its own name): it keeps a copy of the inputs of
    the first call of each distinct shape, by kernel, then calls the
    wrapper, which alone counts the launch. Every module of the package is
    imported first, so that none takes a wrapper from its own module
    meanwhile; on leaving, every module gets its wrappers back."""

    def __init__(self, torch):
        import threading
        from repro_torch.kernels import OPS
        self.torch, self.lock = torch, threading.Lock()
        self.calls = {name: {} for name in OPS}
        self.stand_ins = {id(op): self._stand_in(name, op)
                          for name, op in OPS.items()}
        self.wrappers = {id(s): op for s, op in (
            (s, s.__wrapped__) for s in self.stand_ins.values())}

    def _stand_in(self, name, op):
        is_t = self.torch.is_tensor

        def stand_in(*args, **kw):
            key = (tuple(tuple(a.shape) if is_t(a) else a for a in args),
                   tuple((k, tuple(v.shape) if is_t(v) else v)
                         for k, v in sorted(kw.items())
                         if k not in OUTPUT_KW))
            if key not in self.calls[name]:
                with self.lock:
                    self.calls[name].setdefault(key, (
                        [a.detach().clone() if is_t(a) else a
                         for a in args],
                        {k: v.detach().clone() if is_t(v) else v
                         for k, v in kw.items() if k not in OUTPUT_KW}))
            return op(*args, **kw)
        stand_in.__wrapped__ = op
        return stand_in

    @staticmethod
    def _swap(table) -> None:
        for mod_name, mod in list(sys.modules.items()):
            if mod is None or mod_name.split(".")[0] != "repro_torch" \
                    or re.fullmatch(r"repro_torch\.kernels\.\w+\.ops",
                                    mod_name):
                continue
            for attr, value in list(vars(mod).items()):
                if id(value) in table:
                    setattr(mod, attr, table[id(value)])

    def __enter__(self):
        import importlib
        import pkgutil
        import repro_torch
        for mod in pkgutil.walk_packages(repro_torch.__path__,
                                         "repro_torch."):
            importlib.import_module(mod.name)
        self._swap(self.stand_ins)
        return self

    def __exit__(self, *exc):
        self._swap(self.wrappers)


def hold_kept(torch, run, keeper, launches) -> dict:
    """Each call `keeper` kept, through the wrapper on the card and through
    its plain version, held by the registry's rule (fwht and srht_t
    exactly): per kernel, the shapes held and the largest difference. A
    kernel that launched in the run with no call kept fails."""
    from repro_torch.kernels import registry
    held = {}
    for entry in registry.kernel_entries():
        kept = list(keeper.calls[entry.name].values())
        if launches[entry.name] and not kept:
            raise AssertionError(
                f"phase 12 {run}: {entry.name} launched "
                f"{launches[entry.name]} times, but no call of it was "
                f"kept: a call site the stand-ins do not reach")
        worst = 0.0
        for args, kw in kept:
            got = entry.op(*args, **kw)
            sync(torch)
            want = entry.ref(*args, **kw)
            try:
                registry.compare(entry, got, want, (args, kw))
                exact(torch, entry.name, got, want)
            except AssertionError as e:
                shapes = [tuple(a.shape) for a in args if torch.is_tensor(a)]
                raise AssertionError(f"phase 12 {run}: {entry.name} at "
                                     f"{shapes}: {e}") from None
            worst = max(worst, max_err(torch, got, want))
        if kept:
            held[entry.name] = {
                "shapes": len(kept), "max_abs_err": worst,
                "first": [list(a.shape) for a in kept[0][0]
                          if torch.is_tensor(a)]}
    keeper.calls = {name: {} for name in keeper.calls}   # free the copies
    log(f"[launcher] {run}: every call kept held against the plain "
        f"version: " + "; ".join(
            f"{n} {h['shapes']} shapes (first {h['first']}) max_abs_err "
            f"{h['max_abs_err']:.3e}" for n, h in held.items()))
    return held


def launcher_run(torch, name, work, smi) -> tuple:
    """One in-process run of repro_torch.launch.serve_cluster.main with
    every launch count set to 0 just before: (launches, bench dict,
    seconds, the kept calls held against the plain versions). Its output
    is printed after it, each line tagged."""
    import contextlib
    import io
    from repro_torch.kernels import OPS, reset_launches
    from repro_torch.launch import serve_cluster
    bench_out = work / f"bench_{name}.json"
    argv = LAUNCHER_RUNS[name] + [
        "--device", DEVICE, "--artifact-dir", str(work / name / "demo"),
        "--bench-out", str(bench_out)]
    buf = io.StringIO()
    keeper = CallKeeper(torch)
    sync(torch)
    reset_launches()
    t0 = time.perf_counter()
    try:
        with contextlib.redirect_stdout(buf), keeper:
            rc = serve_cluster.main(argv)
        sync(torch)
    finally:
        for line in buf.getvalue().splitlines():
            log(f"[launcher {name}] {line}")
    seconds = time.perf_counter() - t0
    launches = {n: op.launches for n, op in OPS.items()}
    lines = buf.getvalue().strip().splitlines()
    if rc != 0 or not lines or lines[-1] != "serve_cluster: OK":
        raise AssertionError(f"serve_cluster {name} did not end in OK")
    idle = [n for n in LAUNCHER_MUST[name] if launches[n] == 0]
    if idle:
        raise AssertionError(f"serve_cluster {name} never launched {idle}")
    log(f"[launcher] {name}: serve_cluster.main({' '.join(argv)}) OK in "
        f"{seconds:.2f} s [{smi}]; launches {launches}")
    held = hold_kept(torch, name, keeper, launches)
    return launches, json.loads(bench_out.read_text()), seconds, held


def bench_headlines(bench) -> dict:
    """The bench file's headline numbers."""
    lat = bench["async"]["latency"]
    return {
        "sync_qps": {str(r["batch_size"]): r["assignments_per_sec"]
                     for r in bench["results"]},
        "async_p50_ms": lat["latency_ms"]["p50"],
        "async_p99_ms": lat["latency_ms"]["p99"],
        "async_slo_violations": lat["slo_violations"],
        "fused_speedup": bench["fused"]["speedup"],
        "fused_saved_ratio": bench["fused"]["hbm"]["saved_ratio"],
        "backends": {name: {k: row[k] for k in (
            "accuracy", "kernel_approx_error", "fit_memory_bytes",
            "assignments_per_sec")}
            for name, row in bench["backends"]["per_backend"].items()},
        "matmul512_ms": bench["calibration"]["matmul512_ms"],
    }


def launcher_processes(work, smi) -> dict:
    """The launcher with --sharded under torchrun (the sync bench, and
    the async bench through the rank-0 pump with --swap), the six
    examples (the distributed one under torchrun) and the broken world
    (broken_world), started together; each but the broken world must
    exit 0. Returns each one's seconds (they overlap) and its last
    lines."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    # "--" ends torchrun's options: it would read --n as an ambiguous
    # abbreviation of its own.
    cmds = {f"serve_cluster --sharded {' '.join(extra)} (torchrun)":
            TORCHRUN + [
                "-m", "repro_torch.launch.serve_cluster", "--", "--sharded",
                *extra, "--n", str(LAUNCHER_SHARDED_N), "--device", DEVICE,
                "--artifact-dir", str(work / f"sharded_{tag}" / "demo"),
                "--bench-out", str(work / f"bench_sharded_{tag}.json")]
            for tag, extra in LAUNCHER_SHARDED.items()}
    for name in EXAMPLES:
        cmds[name] = [str(ROOT / "examples" / f"{name}.py"), "--device",
                      DEVICE]
    cmds["torch_distributed_clustering (torchrun)"] = TORCHRUN + [
        str(ROOT / "examples" / "torch_distributed_clustering.py"),
        "--device", DEVICE]
    broken = "serve_cluster --sharded, rank 0's flush broken (torchrun)"
    cmds[broken] = TORCHRUN + [
        str(ROOT / "tests" / "torch_world_teardown_worker.py"), "launcher",
        DEVICE, str(LAUNCHER_BROKEN_TIMEOUT), "--", *LAUNCHER_BROKEN,
        "--device", DEVICE, "--artifact-dir", str(work / "broken" / "demo"),
        "--bench-out", str(work / "bench_broken.json")]
    t0 = time.perf_counter()
    # Each in a session of its own, so that a kill reaches torchrun's
    # workers too.
    procs = {name: subprocess.Popen(
        [sys.executable] + cmd, env=env, cwd=str(work), text=True,
        stdout=subprocess.PIPE, stderr=subprocess.PIPE,
        start_new_session=True) for name, cmd in cmds.items()}
    out, failed = {}, []
    try:
        for name, proc in procs.items():
            so, se = proc.communicate(timeout=max(
                1.0, 300 - (time.perf_counter() - t0)))
            lines = [ln for ln in so.splitlines() if ln.strip()]
            out[name] = {"seconds": time.perf_counter() - t0,
                         "rc": proc.returncode, "lines": lines[-4:]}
            log(f"[launcher] {name}: exit {proc.returncode} by "
                f"{out[name]['seconds']:.1f} s (all started together) "
                f"[{smi}]: " + " | ".join(lines[-4:]))
            if name == broken:
                out[name].update(broken_world(so, se, proc.returncode,
                                              out[name]["seconds"], smi))
                if not out[name]["ended"]:
                    failed.append(name)
            elif proc.returncode != 0:
                failed.append(name)
                log(f"[launcher] {name} stderr:\n{se[-3000:]}")
    finally:
        for proc in procs.values():
            if proc.poll() is None:
                os.killpg(proc.pid, 9)
                proc.wait()
    if failed:
        raise AssertionError(f"phase 12: {failed} did not end as they must")
    return out


def broken_world(so: str, se: str, rc: int, seconds: float, smi) -> dict:
    """The broken world's end, from torchrun's exit code and output: the
    rank's code in torchrun's failure report (torchrun itself exits 1),
    the injected error, and no abort."""
    from repro_torch.launch.mesh import BROKEN_EXIT
    text = so + se
    codes = [int(c) for c in re.findall(r"exitcode\s*:\s*(-?\d+)", text)]
    aborts = [m for m in ABORT_MARKS if m in text]
    info = {"torchrun_rc": rc, "rank_codes": codes, "aborts": aborts,
            "injected": "injected compute failure" in text,
            "bound_s": LAUNCHER_BROKEN_S}
    # torchrun prints its report twice (log and exception).
    info["ended"] = (rc > 0 and set(codes) == {BROKEN_EXIT} and not aborts
                     and info["injected"] and seconds <= LAUNCHER_BROKEN_S)
    log(f"[launcher] broken world: torchrun exit {rc}, rank 0 exit "
        f"{codes}, injected error {'seen' if info['injected'] else 'MISSING'}"
        f", aborts {aborts or 'none'}, {seconds:.1f} s against "
        f"{LAUNCHER_BROKEN_S:.0f} s: "
        f"{'ended in order' if info['ended'] else 'FAILED'} [{smi}]")
    if not info["ended"]:
        log(f"[launcher] broken world output:\n{so[-2000:]}\n{se[-4000:]}")
    return info


def phase_launcher(torch, smi) -> tuple:
    """Phase 12: the serving launcher (repro_torch.launch.serve_cluster)
    in-process at n = 100,000: the main run (every check, every bench,
    the bench file's eight sections), a Nystrom run and a two-pass run,
    launches counted in each; then the sharded launcher under torchrun
    and the six examples as processes."""
    t_phase = time.perf_counter()
    BUILD.mkdir(parents=True, exist_ok=True)
    work_dir = tempfile.TemporaryDirectory(dir=BUILD)
    work = pathlib.Path(work_dir.name)
    launches = {}
    info = {"runs": {}}
    held = {}
    for name in LAUNCHER_RUNS:
        counted, bench, seconds, held_run = launcher_run(torch, name, work,
                                                         smi)
        for op, n in counted.items():
            launches[op] = launches.get(op, 0) + n
        for op, h in held_run.items():
            was = held.get(op, {"shapes": 0, "max_abs_err": 0.0})
            held[op] = {"shapes": was["shapes"] + h["shapes"],
                        "max_abs_err": max(was["max_abs_err"],
                                           h["max_abs_err"])}
        info["runs"][name] = {"seconds": seconds, "launches": counted,
                              "held": held_run}
        if name == "main":
            missing = [s for s in BENCH_SECTIONS if s not in bench]
            if missing:
                raise AssertionError(f"the bench file lacks {missing}")
            info["bench"] = bench_headlines(bench)
            log(f"[launcher] main bench [{smi}]: "
                f"{json.dumps(info['bench'])}")
        else:
            info["runs"][name]["sync_qps"] = {
                str(r["batch_size"]): r["assignments_per_sec"]
                for r in bench["results"]}
    info["processes"] = launcher_processes(work, smi)
    work_dir.cleanup()
    info["launches"] = launches
    info["held"] = held
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[launcher] launches {launches} (gram_stripe "
        f"{launches.get('gram_stripe', 0)}: the stream check's drift "
        f"monitor, not required); phase 12 took {info['phase_s']:.2f} s")
    return launches, info


def phase_env(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{smi} | device count {torch.cuda.device_count()} | tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> dict:
    """Build the kernels; returns, for each tensor-core kernel (TENSOR_CORE),
    ptxas's lines of each instantiation, its dynamic shared memory and the
    HMMA (tensor-core) instructions cuobjdump finds in its SASS."""
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    lib = _build.library()
    log(f"[build] {len(_build.sources())} sources -> {lib_path.name} in "
        f"{time.perf_counter() - t0:.1f} s")

    def family(label):
        return next((k for k, v in TENSOR_CORE.items()
                     if label.startswith(v)), None)

    # ptxas's registers, shared memory and spills of each kernel, under
    # the kernel's name and template arguments (fwht_pass_kernel<3, 4>).
    ptxas = {k: {} for k in TENSOR_CORE}
    for name, msg in ptxas_lines(
            (lib_path.parent / "build.log").read_text()):
        log(f"[build] {name}: {msg}")
        if family(name):
            ptxas[family(name)][name] = (
                ptxas[family(name)].get(name, "") + " " + msg).strip()
    info = {k: {"ptxas": ptxas[k], "dynamic_smem_bytes": smem_bytes(lib, k)}
            for k in TENSOR_CORE}
    cuobjdump = shutil.which("cuobjdump") or "/usr/local/cuda/bin/cuobjdump"
    if pathlib.Path(cuobjdump).exists():
        sass = subprocess.run([cuobjdump, "-sass", str(lib_path)],
                              capture_output=True, text=True, check=True,
                              timeout=300).stdout
        hmma = {k: {} for k in TENSOR_CORE}
        for fn in sass.split("Function : ")[1:]:
            label = kernel_label(fn.split()[0])
            if family(label):
                hmma[family(label)][label] = fn.count("HMMA")
        for k, counts in hmma.items():
            if not counts or min(counts.values()) == 0:
                raise AssertionError(f"{k} SASS without HMMA: {counts}")
            info[k]["sass_hmma"] = counts
    else:
        for k in TENSOR_CORE:
            info[k]["sass_hmma"] = "no cuobjdump in the toolkit"
    for k, v in info.items():
        log(f"[build] {k}: dynamic shared memory {v['dynamic_smem_bytes']} "
            f"bytes; HMMA instructions in the SASS {v['sass_hmma']}")
    return info


def ptxas_lines(log_text: str):
    """(kernel label, message) of each resource line ptxas reports in a
    build log (-Xptxas -v): registers, shared memory, spills."""
    name = ""
    for line in log_text.splitlines():
        if "Compiling entry function" in line:
            name = kernel_label(line.split("'")[1])
        elif "Used" in line or "spill" in line and "0 bytes spill" not in line:
            yield name, line.split(":", 1)[-1].strip()


def ptxas_static_smem(log_text: str) -> dict:
    """Static shared memory (bytes) of each kernel, by name (the largest
    of its instantiations), from a build log's ptxas lines."""
    out = {}
    for label, msg in ptxas_lines(log_text):
        name = label.split("<")[0]
        found = re.search(r"(\d+) bytes smem", msg)
        out[name] = max(out.get(name, 0), int(found[1]) if found else 0)
    return out


def smem_bytes(lib, name: str) -> int:
    """Dynamic shared memory of a tensor-core kernel's block: gram's from
    its plan at the main shape, the others' from their library."""
    if name != "gram_stripe":
        return getattr(lib, f"rt_{name}_smem_bytes")()
    from repro_torch.kernels import _common as cm
    return cm.gram_plan(N_TRAIN, BLOCK, P).smem


def kernel_label(mangled: str) -> str:
    """A kernel's name and integer template arguments from its mangled
    name: the last <length><name> that spells a lowercase identifier."""
    names = [m[2] for m in re.finditer(r"(?=(\d+)([a-z][a-z_]*[a-z]))",
                                       mangled) if int(m[1]) == len(m[2])]
    tpl = re.search(r"I((?:Lin?\d+E)+)E", mangled)
    args = re.findall(r"Li(n?\d+)E", tpl[1]) if tpl else []
    return ((names[-1] if names else mangled)
            + (f"<{', '.join(args)}>".replace("n", "-") if args else ""))


def main_shape_inputs(torch, dev, X):
    """The inputs each kernel gets on the main path, at full size."""
    from repro_torch.core.sketch import make_srht, srht_rows
    gen = torch.Generator(device=dev).manual_seed(7)
    srht = make_srht(N_TRAIN, RP, gen)
    Omega = srht_rows(srht, 0, N_TRAIN)
    Xb = X[:, N_TRAIN - BLOCK:]                     # the last full block
    Xt = X[:, N_TRAIN - 160:]                       # the ragged tail
    proj = torch.randn((R, N_TRAIN), generator=gen, device=dev) / 300.0
    Yq = torch.randn((1024, R), generator=gen, device=dev)
    cents = torch.randn((K, R), generator=gen, device=dev)
    kw = dict(KERNEL)
    # The SRHT block update's padded stripe and the eigensolve's Omega^T Q;
    # srht_t takes their m = 100,000 rows (Kc of the last block, q + b =
    # n; the padded Q) with the sketch's signs and rows.
    block_stripe = torch.randn((N_PAD, BLOCK), generator=gen, device=dev)
    eig_slab = torch.randn((N_PAD, RP), generator=gen, device=dev)
    sk = {"n_pad": N_PAD}
    return {
        "fwht": [((block_stripe,), {}), ((eig_slab,), {})],
        "srht_t": [((block_stripe[:N_TRAIN], srht.signs, srht.rows), sk),
                   ((eig_slab[:N_TRAIN], srht.signs, srht.rows), sk)],
        "gram_stripe": [((X, Xb), kw)],
        "fit_sketch": [((X, Omega, Xb, Omega[N_TRAIN - BLOCK:].contiguous()),
                        kw),
                       ((X, Omega, Xt, Omega[N_TRAIN - 160:].contiguous()),
                        kw)],
        "extend_embed": [((X, proj, Xb), kw)],
        "kmeans_assign": [((Yq, cents), {})],
        "embed_assign": [((X, proj, Xb, cents), kw)],
    }


def phase_kernels(torch, dev, X) -> dict:
    from repro_torch.kernels import registry
    results = {}
    main = main_shape_inputs(torch, dev, X)
    for entry in registry.kernel_entries():
        worst_case = worst_main = 0.0
        for i, case in enumerate(entry.cases):
            args, kw = entry.build(np.random.default_rng(100 + i), case)
            targs = [torch.from_numpy(a).to(dev) for a in args]
            got = entry.op(*targs, **kw)
            torch.cuda.synchronize()
            want = entry.ref(*targs, **kw)
            registry.compare(entry, got, want, (targs, kw))
            exact(torch, entry.name, got, want)
            worst_case = max(worst_case, max_err(torch, got, want))
            log(f"[kernels] {entry.name} case {case} ok "
                f"max_abs_err {max_err(torch, got, want):.3e}")
        for args, kw in main[entry.name]:
            got = entry.op(*args, **kw)
            torch.cuda.synchronize()
            want = entry.ref(*args, **kw)
            registry.compare(entry, got, want, (args, kw))
            exact(torch, entry.name, got, want)
            if entry.name in REPEAT:
                same_bits(torch, entry.name, got, entry.op(*args, **kw))
            worst_main = max(worst_main, max_err(torch, got, want))
            shapes = [tuple(a.shape) for a in args]
            log(f"[kernels] {entry.name} main shape {shapes} ok "
                f"max_abs_err {max_err(torch, got, want):.3e}")
        args, kw = main[entry.name][0]
        res = {"max_abs_err": worst_main,
               "max_abs_err_parity_cases": worst_case,
               "parity_cases": len(entry.cases),
               "ms": cuda_ms(torch, lambda: entry.op(*args, **kw)),
               "plain_ms": cuda_ms(torch, lambda: entry.ref(*args, **kw)),
               "library_ms": None}
        if isinstance(got, tuple) and got[0].dtype == torch.int32:
            res["label_mismatches"] = label_mismatches(got, want)
        if entry.name == "gram_stripe":
            res.update(gram_bound(P, N_TRAIN, BLOCK, "polynomial", 2))
            res.update(gram_extra(torch, dev, entry, main["gram_stripe"]))
        elif entry.name == "fit_sketch":
            res.update(fit_tc_bound(P, N_TRAIN, BLOCK, RP, "polynomial", 2))
            res.update(fit_sketch_extra(torch, entry, main["fit_sketch"]))
        elif entry.name == "extend_embed":
            res.update(extend_tc_bound(P, N_TRAIN, R, BLOCK, "polynomial", 2))
            res.update(extend_embed_extra(torch, entry, main["extend_embed"]))
        elif entry.name == "fwht":
            res.update(fwht_bound(N_PAD, BLOCK))
            res.update(fwht_extra(torch, dev, entry, main["fwht"]))
        elif entry.name == "srht_t":
            res.update(srht_t_extra(torch, entry, main["srht_t"]))
        elif entry.name == "embed_assign":
            res.update(embed_assign_bound(P, N_TRAIN, R, BLOCK, K,
                                          "polynomial", 2))
            res.update(embed_assign_extra(torch, entry,
                                          main["embed_assign"]))
        else:
            res.update(assign_bound(1024, R, K))
            res.update(assign_extra(torch, entry, main["kmeans_assign"]))
        log(f"[kernels] {entry.name} main shape: kernel {res['ms']:.4f} ms, "
            f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res.get('bound_term', res['bound_by'])})")
        results[entry.name] = res
    return results, {k: main[k][0] for k in ("kmeans_assign", "embed_assign")}


def same_bits(torch, name, first, again) -> None:
    """Two launches on the same inputs must give the same bits."""
    first = first if isinstance(first, tuple) else (first,)
    again = again if isinstance(again, tuple) else (again,)
    for a, b in zip(first, again):
        if not torch.equal(a.view(torch.int32), b.view(torch.int32)):
            raise AssertionError(f"{name}: two launches differ")


def gram_tc_bound(p, n, w, kind, degree) -> dict:
    """gram's product takes 2p flops per entry on the tensor cores; kappa
    the rest."""
    from repro_torch.kernels.gram.ops import gram_stripe_bytes
    return tc_bound(gram_stripe_bytes(p, n, w), n * w * 2 * p,
                    n * w * kappa_ops(kind, degree))


def gram_extra(torch, dev, entry, main) -> dict:
    """gram back to back; with the rbf and linear kinds at the main shape
    (against the plain version; linear also against torch.mm, TF32 off,
    the one PyTorch call that computes it), the same bits on two launches
    in both; the plan gram_plan chose; the column-tiled shape w = 4,096
    and p past 19 (GRAM_DEEP, standard normal columns of unit norm from a
    seed) against their plain versions; the tensor-core bound beside the
    fp32 one. No one PyTorch call computes the polynomial or rbf stripe:
    no library time."""
    import dataclasses
    from repro_torch.kernels import _common as cm, registry
    ((X, Xb), kw), = main
    plan = cm.gram_plan(N_TRAIN, BLOCK, P)
    out = {"ms_back_to_back": cuda_ms_back_to_back(
               torch, lambda: entry.op(X, Xb, **kw)),
           "plan": dataclasses.asdict(plan),
           "tc_bound_ms": gram_tc_bound(P, N_TRAIN, BLOCK, "polynomial",
                                        2)["bound_ms"],
           "tf32_matmul": torch.backends.cuda.matmul.allow_tf32,
           "library_note": "torch.mm computes the linear kind only"}
    for kind in ({"kind": "rbf", "gamma": RBF_GAMMA}, {"kind": "linear"}):
        name = kind["kind"]
        got = entry.op(X, Xb, **kind)
        torch.cuda.synchronize()
        want = entry.ref(X, Xb, **kind)
        registry.compare(entry, got, want)
        same_bits(torch, f"gram_stripe ({name})", got, entry.op(X, Xb, **kind))
        out.update({f"{name}_max_abs_err": max_err(torch, got, want),
                    f"{name}_ms": cuda_ms(torch, lambda: entry.op(X, Xb,
                                                                  **kind)),
                    f"{name}_ms_back_to_back": cuda_ms_back_to_back(
                        torch, lambda: entry.op(X, Xb, **kind)),
                    f"{name}_plain_ms": cuda_ms(
                        torch, lambda: entry.ref(X, Xb, **kind))})
    registry.compare(entry, torch.mm(X.T, Xb), entry.op(X, Xb,
                                                        kind="linear"))
    out["linear_library_ms"] = cuda_ms(torch, lambda: torch.mm(X.T, Xb))
    out["linear_library_ms_back_to_back"] = cuda_ms_back_to_back(
        torch, lambda: torch.mm(X.T, Xb))

    def held(Xs, Xbs):
        """The kernel at another shape against its plain version."""
        p, n = Xs.shape
        w = Xbs.shape[1]
        got = entry.op(Xs, Xbs, **kw)
        torch.cuda.synchronize()
        want = entry.ref(Xs, Xbs, **kw)
        registry.compare(entry, got, want)
        return {"shape": [n, w, p],
                "plan": dataclasses.asdict(cm.gram_plan(n, w, p)),
                "max_abs_err": max_err(torch, got, want),
                "ms": cuda_ms(torch, lambda: entry.op(Xs, Xbs, **kw)),
                "ms_back_to_back": cuda_ms_back_to_back(
                    torch, lambda: entry.op(Xs, Xbs, **kw)),
                "plain_ms": cuda_ms(torch, lambda: entry.ref(Xs, Xbs, **kw)),
                "bound_ms": gram_tc_bound(p, n, w, "polynomial",
                                          2)["bound_ms"],
                "fp32_bound_ms": gram_bound(p, n, w, "polynomial",
                                            2)["bound_ms"]}
    # The column-tiled shape: Xb of GRAM_WIDE columns, 8 chunks of 512.
    out["tiled"] = held(X, X[:, N_TRAIN - GRAM_WIDE:])
    out["deep"] = []
    gen = torch.Generator(device=dev).manual_seed(SEED + 17)
    for p in GRAM_DEEP:
        Xd = torch.randn((p, N_TRAIN), generator=gen, device=dev)
        Xd /= Xd.norm(dim=0)
        out["deep"].append(held(Xd, Xd[:, N_TRAIN - BLOCK:]))
        del Xd
    log(f"[kernels] gram plan {plan}")
    log(f"[kernels] gram back to back {out['ms_back_to_back']:.4f} ms; rbf "
        f"(gamma {RBF_GAMMA}) max abs err {out['rbf_max_abs_err']:.3e}, "
        f"{out['rbf_ms']:.4f} ms (back to back "
        f"{out['rbf_ms_back_to_back']:.4f}), plain {out['rbf_plain_ms']:.4f}"
        f" ms; linear {out['linear_ms']:.4f} ms (back to back "
        f"{out['linear_ms_back_to_back']:.4f}) vs torch.mm (TF32 matmul "
        f"{out['tf32_matmul']}) {out['linear_library_ms']:.4f} ms (back to "
        f"back {out['linear_library_ms_back_to_back']:.4f}); tensor-core "
        f"bound {out['tc_bound_ms']:.5f} ms")
    for res in [out["tiled"]] + out["deep"]:
        pl = res["plan"]
        log(f"[kernels] gram {res['shape']} (columns {pl['cols']} x "
            f"{pl['chunks']}, krows {pl['krows']}, resident "
            f"{pl['resident']}): kernel {res['ms']:.4f} ms (back to back "
            f"{res['ms_back_to_back']:.4f}), plain {res['plain_ms']:.4f} ms,"
            f" bound {res['bound_ms']:.4f} ms (fp32 "
            f"{res['fp32_bound_ms']:.4f}), max abs err "
            f"{res['max_abs_err']:.3e}")
    return out


def fit_sketch_extra(torch, entry, main) -> dict:
    """fit_sketch back to back, at the ragged tail block (b = 160), with
    the rbf kind at the main shape (the tile's cancellation, held against
    the plain version), and beside its fp32 CUDA-core bound. No one
    PyTorch call computes its four outputs: no library time."""
    from repro_torch.kernels import registry
    (args, kw), (targs, tkw) = main
    rbf = {"kind": "rbf", "gamma": RBF_GAMMA}
    got = entry.op(*args, **rbf)
    torch.cuda.synchronize()
    want = entry.ref(*args, **rbf)
    registry.compare(entry, got, want)
    same_bits(torch, "fit_sketch (rbf)", got, entry.op(*args, **rbf))
    b_tail = targs[2].shape[1]
    out = {"ms_back_to_back": cuda_ms_back_to_back(
               torch, lambda: entry.op(*args, **kw)),
           "fp32_bound_ms": fit_bound(P, N_TRAIN, BLOCK, RP, "polynomial",
                                      2)["bound_ms"],
           "tail_shape": [N_TRAIN, b_tail],
           "tail_ms": cuda_ms(torch, lambda: entry.op(*targs, **tkw)),
           "tail_ms_back_to_back": cuda_ms_back_to_back(
               torch, lambda: entry.op(*targs, **tkw)),
           "tail_plain_ms": cuda_ms(torch, lambda: entry.ref(*targs, **tkw)),
           "tail_bound_ms": fit_tc_bound(P, N_TRAIN, b_tail, RP, "polynomial",
                                         2)["bound_ms"],
           "rbf_max_abs_err": max_err(torch, got, want),
           "rbf_ms": cuda_ms(torch, lambda: entry.op(*args, **rbf)),
           "library_note": "no single PyTorch call computes new_rows, "
                           "delta, rn_rows and rn_cols"}
    log(f"[kernels] fit_sketch back to back {out['ms_back_to_back']:.4f} ms;"
        f" tail b={b_tail}: kernel {out['tail_ms']:.4f} ms (back to back "
        f"{out['tail_ms_back_to_back']:.4f}), plain "
        f"{out['tail_plain_ms']:.4f} ms, bound {out['tail_bound_ms']:.4f} "
        f"ms; rbf (gamma {RBF_GAMMA}) max abs err "
        f"{out['rbf_max_abs_err']:.3e}, {out['rbf_ms']:.4f} ms; fp32 "
        f"CUDA-core bound {out['fp32_bound_ms']:.4f} ms")
    return out


def extend_embed_extra(torch, entry, main) -> dict:
    """extend_embed back to back; at the serving widths (SERVE_WIDTHS),
    where a query column must get the bits of the main-shape run; with
    the rbf kind at the main shape (the tile's cancellation, held against
    the plain version); beside its fp32 CUDA-core bound. No one PyTorch
    call computes P kappa(X, Xb): no library time."""
    from repro_torch.kernels import registry
    ((X, proj, Xb), kw), = main
    rbf = {"kind": "rbf", "gamma": RBF_GAMMA}
    got = entry.op(X, proj, Xb, **rbf)
    torch.cuda.synchronize()
    want = entry.ref(X, proj, Xb, **rbf)
    registry.compare(entry, got, want)
    same_bits(torch, "extend_embed (rbf)", got, entry.op(X, proj, Xb, **rbf))
    out = {"ms_back_to_back": cuda_ms_back_to_back(
               torch, lambda: entry.op(X, proj, Xb, **kw)),
           "fp32_bound_ms": extend_bound(P, N_TRAIN, R, BLOCK, "polynomial",
                                         2)["bound_ms"],
           "rbf_max_abs_err": max_err(torch, got, want),
           "rbf_ms": cuda_ms(torch, lambda: entry.op(X, proj, Xb, **rbf)),
           "serving_widths": {},
           "library_note": "no single PyTorch call computes P kappa(X, Xb)"}
    for w in SERVE_WIDTHS:
        xb = Xb[:, :w]
        got = entry.op(X, proj, xb, **kw)
        torch.cuda.synchronize()
        registry.compare(entry, got, entry.ref(X, proj, xb, **kw))
        if not torch.equal(got, entry.op(X, proj, Xb, **kw)[:, :w]):
            raise AssertionError(f"extend_embed at w={w} differs from the "
                                 f"same columns of the w={Xb.shape[1]} run")
        out["serving_widths"][str(w)] = {
            "ms": cuda_ms(torch, lambda: entry.op(X, proj, xb, **kw)),
            "ms_back_to_back": cuda_ms_back_to_back(
                torch, lambda: entry.op(X, proj, xb, **kw)),
            "plain_ms": cuda_ms(torch, lambda: entry.ref(X, proj, xb, **kw)),
            "bound_ms": extend_tc_bound(P, N_TRAIN, R, w, "polynomial",
                                        2)["bound_ms"]}
    log(f"[kernels] extend_embed back to back {out['ms_back_to_back']:.4f} "
        f"ms; rbf (gamma {RBF_GAMMA}) max abs err "
        f"{out['rbf_max_abs_err']:.3e}, {out['rbf_ms']:.4f} ms; fp32 "
        f"CUDA-core bound {out['fp32_bound_ms']:.4f} ms; " + "; ".join(
            f"w={w}: kernel {v['ms']:.4f} ms (back to back "
            f"{v['ms_back_to_back']:.4f}), plain {v['plain_ms']:.4f} ms, "
            f"bound {v['bound_ms']:.5f} ms"
            for w, v in out["serving_widths"].items()))
    return out


def assign_case_inputs(torch, entry, dev):
    """kmeans_assign's inputs at ASSIGN_CASE, as phase 3 builds them."""
    case = entry.cases.index(ASSIGN_CASE)
    args, _ = entry.build(np.random.default_rng(100 + case), ASSIGN_CASE)
    return [torch.from_numpy(a).to(dev) for a in args]


def assign_extra(torch, entry, main) -> dict:
    """kmeans_assign back to back at the main shape, and at its widest
    registry case (ASSIGN_CASE), where every thread reads its 16 values
    for each of 100 centroids. No one PyTorch call computes it."""
    ((Yq, C), _), = main
    Yc, Cc = assign_case_inputs(torch, entry, Yq.device)
    out = {"ms_back_to_back": cuda_ms_back_to_back(
               torch, lambda: entry.op(Yq, C)),
           "registry_case": {
               "shape": [ASSIGN_CASE[k] for k in ("n", "r", "k")],
               "ms": cuda_ms(torch, lambda: entry.op(Yc, Cc)),
               "ms_back_to_back": cuda_ms_back_to_back(
                   torch, lambda: entry.op(Yc, Cc)),
               "plain_ms": cuda_ms(torch, lambda: entry.ref(Yc, Cc)),
               "bound_ms": assign_bound(*(ASSIGN_CASE[k] for k in (
                   "n", "r", "k")))["bound_ms"]},
           "library_note": "no single PyTorch call computes the argmin "
                           "with its distance"}
    rc = out["registry_case"]
    log(f"[kernels] kmeans_assign back to back {out['ms_back_to_back']:.4f}"
        f" ms; at {rc['shape']}: kernel {rc['ms']:.4f} ms (back to back "
        f"{rc['ms_back_to_back']:.4f}), plain {rc['plain_ms']:.4f} ms, bound"
        f" {rc['bound_ms']:.6f} ms")
    return out


def unfused_assign(X, proj, C, kw):
    """The sequence embed_assign replaces on the serving path:
    extend_embed_op, a transpose copy, kmeans_assign's assign_op."""
    from repro_torch.kernels.extend_embed.ops import extend_embed_op
    from repro_torch.kernels.kmeans_assign.ops import assign_op

    def unfused(xb):
        return assign_op(extend_embed_op(X, proj, xb, **kw).T.contiguous(),
                         C)
    return unfused


def embed_assign_extra(torch, entry, main) -> dict:
    """embed_assign at the main shape and the serving widths
    (SERVE_WIDTHS): bit for bit against the unfused sequence it replaces
    on the serving path (extend_embed_op, transpose, kmeans_assign's
    assign_op), within the near-tie rule of its plain version; timed one
    call and back to back beside extend_embed_op alone and beside the
    unfused sequence (unfused_ms); phase_device adds their times on the
    card alone. No one PyTorch call computes it."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.extend_embed.ops import extend_embed_op
    from repro_torch.kernels.kmeans_assign.ops import assign_op
    ((X, proj, Xb, C), kw), = main
    unfused = unfused_assign(X, proj, C, kw)
    out = {"serving_widths": {},
           "library_note": "no single PyTorch call computes the argmin of "
                           "P kappa(X, Xb)"}
    for w in (BLOCK,) + SERVE_WIDTHS:
        xb = Xb[:, :w]
        got = entry.op(X, proj, xb, C, **kw)
        torch.cuda.synchronize()
        registry.compare(entry, got, entry.ref(X, proj, xb, C, **kw),
                         ((X, proj, xb, C), kw))
        same_bits(torch, f"embed_assign at w={w} vs extend_embed_op -> "
                  f"assign_op", got, unfused(xb))
        times = {
            "ms": cuda_ms(torch, lambda: entry.op(X, proj, xb, C, **kw)),
            "ms_back_to_back": cuda_ms_back_to_back(
                torch, lambda: entry.op(X, proj, xb, C, **kw)),
            "extend_embed_ms": cuda_ms(
                torch, lambda: extend_embed_op(X, proj, xb, **kw)),
            "extend_embed_ms_back_to_back": cuda_ms_back_to_back(
                torch, lambda: extend_embed_op(X, proj, xb, **kw)),
            "unfused_ms": cuda_ms(torch, lambda: unfused(xb)),
            "unfused_ms_back_to_back": cuda_ms_back_to_back(
                torch, lambda: unfused(xb))}
        if w == BLOCK:
            out.update(times)
            continue
        times.update({
            "plain_ms": cuda_ms(torch, lambda: entry.ref(X, proj, xb, C,
                                                         **kw)),
            "bound_ms": embed_assign_bound(P, N_TRAIN, R, w, K, "polynomial",
                                           2)["bound_ms"]})
        out["serving_widths"][str(w)] = times
    log(f"[kernels] embed_assign == extend_embed_op -> assign_op bit for bit"
        f" at w = {BLOCK}, " + ", ".join(map(str, SERVE_WIDTHS)) + "; ms "
        "one call / back to back: " + "; ".join(
            f"w={w}: fold {v['ms']:.4f} / {v['ms_back_to_back']:.4f}, "
            f"extend_embed_op {v['extend_embed_ms']:.4f} / "
            f"{v['extend_embed_ms_back_to_back']:.4f}, unfused "
            f"{v['unfused_ms']:.4f} / {v['unfused_ms_back_to_back']:.4f}"
            for w, v in [(BLOCK, out)] + list(out["serving_widths"].items())))
    return out


def exact(torch, name, got, want) -> None:
    """fwht and srht_t must equal their plain versions exactly."""
    if name in EXACT and not torch.equal(got, want):
        raise AssertionError(f"{name} differs from its plain version by up "
                             f"to {max_err(torch, got, want)}")


def fwht_extra(torch, dev, entry, main) -> dict:
    """fwht beside its bound at the eigensolve's shape, and beside the one
    PyTorch call that computes a Hadamard transform: torch.mm with a
    materialized H (256 MB at n = 8,192; 68 GB at the main path's n, so
    no library time there); at the block shape, back to back."""
    from repro_torch.kernels import registry
    ((xb,), _), ((x,), _) = main
    out = {"ms_back_to_back": cuda_ms_back_to_back(torch,
                                                   lambda: entry.op(xb)),
           # A pass reads and writes the slab once: a device copy of it is
           # the yardstick of one pass.
           "copy_ms": cuda_ms(torch, lambda: xb.clone()),
           "eig_shape": list(x.shape),
           "eig_ms": cuda_ms(torch, lambda: entry.op(x)),
           "eig_plain_ms": cuda_ms(torch, lambda: entry.ref(x)),
           "eig_bound_ms": fwht_bound(N_PAD, RP)["bound_ms"]}
    n = LIBRARY_FWHT_N
    H = entry.ref(torch.eye(n, device=dev))
    xs = torch.randn((n, BLOCK), device=dev,
                     generator=torch.Generator(device=dev).manual_seed(3))
    registry.compare(entry, torch.mm(H, xs), entry.op(xs))
    out.update({"library_shape": [n, BLOCK],
                "library_ms_at_library_shape": cuda_ms(
                    torch, lambda: torch.mm(H, xs)),
                "ms_at_library_shape": cuda_ms(torch, lambda: entry.op(xs)),
                "bound_ms_at_library_shape":
                    fwht_bound(n, BLOCK)["bound_ms"]})
    del H
    log(f"[kernels] fwht at the eigensolve shape {out['eig_shape']}: kernel "
        f"{out['eig_ms']:.4f} ms, plain {out['eig_plain_ms']:.4f} ms, bound "
        f"{out['eig_bound_ms']:.5f} ms; at ({n}, {BLOCK}) kernel "
        f"{out['ms_at_library_shape']:.4f} ms vs torch.mm with a "
        f"materialized H {out['library_ms_at_library_shape']:.4f} ms")
    out.update(fwht_column(torch, dev, entry))
    return out


def fwht_column(torch, dev, entry) -> dict:
    """fwht at one column (FWHT_COLUMN_N, 1): the row pass, then the pass
    kernel over the (n / 2^s, 2^s) view, as fwht_launch_plan plans it;
    equal to fwht_ref bit for bit, one call and back to back beside its
    bound and the plain version."""
    from repro_torch.kernels.fwht.ops import fwht_launch_plan
    n = FWHT_COLUMN_N
    x = torch.randn((n, 1), device=dev,
                    generator=torch.Generator(device=dev).manual_seed(5))
    got = entry.op(x)
    torch.cuda.synchronize()
    exact(torch, entry.name, got, entry.ref(x))
    same_bits(torch, entry.name, got, entry.op(x))
    plan = [(ln.kernel, ln.tiles[0]) for ln in fwht_launch_plan(x).launches]
    out = {"column_shape": [n, 1], "column_plan": plan,
           "column_ms": cuda_ms(torch, lambda: entry.op(x)),
           "column_ms_back_to_back": cuda_ms_back_to_back(
               torch, lambda: entry.op(x)),
           "column_plain_ms": cuda_ms(torch, lambda: entry.ref(x)),
           "column_bound_ms": fwht_bound(n, 1)["bound_ms"],
           "column_bound_by": fwht_bound(n, 1)["bound_by"]}
    log(f"[kernels] fwht at one column ({n}, 1), launches {plan} (kernel, "
        f"stages): kernel {out['column_ms']:.4f} ms, back to back "
        f"{out['column_ms_back_to_back']:.4f} ms, plain "
        f"{out['column_plain_ms']:.4f} ms, bound "
        f"{out['column_bound_ms']:.4f} ms ({out['column_bound_by']}); "
        f"fwht_ref's bits")
    return out


def srht_t_extra(torch, entry, main) -> dict:
    """srht_t beside its bound; beside the one PyTorch call that computes
    Omega^T M, torch.mm with Omega materialized once (outside the timing,
    TF32 off), as its library time; and, as its yardstick, beside the
    unfused composition it replaces on the canonical path (zero pad, sign
    scaling, the fwht kernel, row gather); at the block shape and at the
    eigensolve's."""
    from repro_torch.core.sketch import SRHT, srht_rows
    from repro_torch.kernels import registry
    from repro_torch.kernels.fwht.ops import fwht_op

    def unfused(M, signs, rows, n_pad):
        Mp = torch.nn.functional.pad(M, (0, 0, 0, n_pad - M.shape[0]))
        return fwht_op((Mp * signs[:, None]).contiguous())[rows]

    out = {}
    for tag, (args, kw) in zip(("", "eig_"), main):
        M, signs, rows = args
        m = M.shape[0]
        b = srht_t_bound(m, M.shape[1], rows.cpu().numpy(), N_PAD)
        Omega = srht_rows(SRHT(signs, rows, m, N_PAD), 0, m)    # (m, r')
        registry.compare(entry, torch.mm(Omega.T, M), entry.op(*args, **kw))
        out[f"{tag}library_ms"] = cuda_ms(torch, lambda: torch.mm(Omega.T, M))
        del Omega
        if tag:
            out.update({"eig_shape": list(M.shape),
                        "eig_ms": cuda_ms(torch, lambda: entry.op(*args, **kw)),
                        "eig_plain_ms": cuda_ms(
                            torch, lambda: entry.ref(*args, **kw)),
                        "eig_bound_ms": b["bound_ms"]})
        else:
            out.update(b)
            out["ms_back_to_back"] = cuda_ms_back_to_back(
                torch, lambda: entry.op(*args, **kw))
            # One read of M, the kernel's HBM traffic, as torch.sum does it.
            out["read_ms"] = cuda_ms(torch, lambda: M.sum())
        out[f"{tag}unfused_ms"] = cuda_ms(torch, lambda: unfused(*args, **kw))
        log(f"[kernels] srht_t at {list(M.shape)}: torch.mm with a "
            f"materialized Omega {out[f'{tag}library_ms']:.4f} ms, unfused "
            f"composition through fwht_op {out[f'{tag}unfused_ms']:.4f} ms, "
            f"bound {b['bound_ms']:.5f} ms ({b['bound_by']})"
            + (f", kernel {out['eig_ms']:.4f} ms" if tag else ""))
    return out


def subspace_gap(torch, U1, U2) -> float:
    """||U1 U1^T - U2 U2^T||_F for orthonormal (n, r) bases, without the
    n x n products: 2r - 2 ||U1^T U2||_F^2 under the square root."""
    r = U1.shape[1]
    g = torch.linalg.norm((U1.T.double() @ U2.double())) ** 2
    return float(torch.sqrt(torch.clamp(2 * r - 2 * g, min=0.0)))


def estimator_args(fwht_fn=None):
    """The configuration's estimator arguments. Unset, fwht_fn leaves every
    Omega^T M of the fit to the srht_t kernel (the default route); given
    (fwht_op, or the plain fwht_ref), it runs the unfused composition
    through that transform (backend_params fwht_fn)."""
    params = {"oversampling": OVERSAMPLING}
    if fwht_fn is not None:
        params["fwht_fn"] = fwht_fn
    return dict(k=K, r=R, kernel="polynomial",
                kernel_params={"gamma": KERNEL["gamma"],
                               "degree": KERNEL["degree"]},
                backend="onepass-srht", backend_params=params, block=BLOCK,
                device=DEVICE)


def phase_fit(torch, X, y) -> tuple:
    """The main path's fit through the fused fit_sketch kernel (its
    eigensolve through srht_t), checked against the canonical plain fit
    (fwht_fn=fwht_ref) with the same sketch and init."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.sketch import SRHT
    from repro_torch.kernels import OPS, reset_launches
    from repro_torch.kernels.fwht.ref import fwht_ref
    from repro_torch.serve import ComputePolicy
    # First use of cuBLAS / cuSOLVER on a small fit, outside the count.
    KernelKMeans(**estimator_args(), policy=ComputePolicy()).fit(
        X[:, :4096], seed=1)
    torch.cuda.synchronize()
    reset_launches()
    t0 = time.perf_counter()
    est = KernelKMeans(**estimator_args(), policy=ComputePolicy()).fit(
        X, seed=SEED)
    torch.cuda.synchronize()
    fit_s = time.perf_counter() - t0
    launches = {name: op.launches for name, op in OPS.items()}
    updates = N_TRAIN // BLOCK + (1 if N_TRAIN % BLOCK else 0)
    if launches["fit_sketch"] != updates:
        raise AssertionError(f"fit_sketch launched {launches['fit_sketch']} "
                             f"times for {updates} block updates")
    if launches["srht_t"] != 1 or launches["fwht"] != 0:
        raise AssertionError(f"the fused fit's eigensolve launched srht_t "
                             f"{launches['srht_t']} and fwht "
                             f"{launches['fwht']} times, not once and never")
    if not (bool(torch.isfinite(est.embedding_).all())
            and tuple(est.embedding_.shape) == (R, N_TRAIN)):
        raise AssertionError("fit embedding is not finite (r, n)")
    m = est.model_
    sketch = SRHT(signs=m.sketch_signs, rows=m.sketch_rows, n=N_TRAIN,
                  n_pad=int(m.sketch_signs.shape[0]))
    t0 = time.perf_counter()
    canon = KernelKMeans(**estimator_args(fwht_ref), policy=None).fit(
        X, seed=SEED, sketch=sketch, init=est.kmeans_init_)
    torch.cuda.synchronize()
    canon_s = time.perf_counter() - t0
    if {name: op.launches for name, op in OPS.items()} != launches:
        raise AssertionError("the canonical fit launched a kernel")
    eig_err = float((est.eigvals_ - canon.eigvals_).abs().max())
    if not torch.allclose(est.eigvals_, canon.eigvals_, rtol=TOL, atol=TOL):
        raise AssertionError(f"eigvals {est.eigvals_.tolist()} vs canonical "
                             f"{canon.eigvals_.tolist()}")
    gap = subspace_gap(torch, est.model_.U, canon.model_.U)
    if not gap < TOL:
        raise AssertionError(f"fused and canonical subspaces differ by {gap}")
    state_err = {}
    for name in ("stream_w", "stream_row_norms2"):
        got, want = getattr(m, name), getattr(canon.model_, name)
        state_err[name] = max_err(torch, got, want)
        if not torch.allclose(got, want, rtol=TOL, atol=TOL):
            raise AssertionError(f"fused and canonical {name} differ by up "
                                 f"to {state_err[name]}")
    agree = clustering_accuracy(canon.labels_, est.labels_, K)
    if agree < 0.99:
        raise AssertionError(f"fused and canonical labels agree on {agree}")
    acc = clustering_accuracy(y, est.labels_, K)
    chunked = fused_chunked(torch, X, est)
    info = {"fit_s": fit_s, "canonical_fit_s": canon_s,
            "fit_sketch_launches": launches["fit_sketch"],
            "srht_t_launches": launches["srht_t"],
            "fwht_launches": launches["fwht"],
            "block_updates": updates, "eigvals": est.eigvals_.tolist(),
            "eigval_max_abs_err_vs_canonical": eig_err,
            "subspace_gap_vs_canonical": gap,
            **{f"{k}_max_abs_err_vs_canonical": v
               for k, v in state_err.items()},
            "label_agreement_vs_canonical": agree,
            "accuracy_vs_generating_labels": acc,
            "breakdown_s": est.fit_times_, **chunked}
    log(f"[fit] n={N_TRAIN} fused fit {fit_s:.3f} s ({updates} fit_sketch "
        f"launches, {launches['srht_t']} srht_t), canonical plain fit "
        f"{canon_s:.3f} s; eigvals "
        f"{est.eigvals_.tolist()} (max abs diff {eig_err:.2e}), subspace gap "
        f"{gap:.2e}, stream_w / stream_row_norms2 max abs diff "
        f"{state_err['stream_w']:.2e} / {state_err['stream_row_norms2']:.2e}"
        f", label agreement {agree:.4f}, accuracy vs generating labels "
        f"{acc:.4f}")
    log("[fit] breakdown of the fused fit (KernelKMeans.fit_times_, CUDA "
        "events) " + ", ".join(f"{k} {v:.4f} s"
                               for k, v in est.fit_times_.items()))
    return est, canon, launches, info


def fused_chunked(torch, X, est) -> dict:
    """The fused route in ten partial_fit chunks of 10,000 columns: its
    sketch state equals the fused one-shot fit's bit for bit (every block
    update is the same fit_sketch call, and the kernel's sums run in one
    order)."""
    from repro_torch.api import KernelKMeans
    from repro_torch.kernels import OPS
    from repro_torch.serve import ComputePolicy
    before = OPS["fit_sketch"].launches
    live = KernelKMeans(**estimator_args(), policy=ComputePolicy())
    t0 = time.perf_counter()
    for i in range(N_TRAIN // STREAM_CHUNK):
        live.partial_fit(X[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK],
                         seed=SEED, capacity=N_TRAIN, reeig=False)
    live.reeig_now()
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    for name in ("stream_w", "stream_row_norms2"):
        if not torch.equal(getattr(live.model_, name),
                           getattr(est.model_, name)):
            raise AssertionError(f"fused chunked and one-shot {name} differ")
    launches = OPS["fit_sketch"].launches - before
    log(f"[fit] fused route in {N_TRAIN // STREAM_CHUNK} partial_fit chunks"
        f" of {STREAM_CHUNK} columns and a re-eig: {seconds:.3f} s, "
        f"{launches} fit_sketch launches; stream_w and stream_row_norms2 "
        f"equal the one-shot fused fit's bit for bit")
    return {"fused_chunked_s": seconds,
            "fused_chunked_fit_sketch_launches": launches,
            "fused_chunked_equals_one_shot": True}


def phase_serve(torch, model, Xq) -> tuple:
    """Requests through a MicroBatcher on the default policy (each stripe
    one embed_assign launch, no standalone kmeans_assign) and the queries
    embedded through extend_embed; then the same requests through a
    batcher on the two-pass embedding with the standalone kmeans_assign
    kernel. Each request's bucketed labels and distances equal an
    unbatched Extender.assign of its queries bit for bit; both batchers
    are held against the two-pass plain Extender on the card."""
    from repro_torch.kernels import OPS, reset_launches
    from repro_torch.kernels.registry import near_tie_compare
    from repro_torch.serve import ComputePolicy, Extender, MicroBatcher

    def counts():
        return {name: op.launches for name, op in OPS.items()}

    batcher = MicroBatcher(model, policy=ComputePolicy())
    batcher.warm(REQUESTS)
    two_pass = MicroBatcher(model, policy=ComputePolicy(embed_fused=False,
                                                        assign_fused=True))
    two_pass.warm(REQUESTS)
    offs = [0]
    for b in REQUESTS:
        offs.append(offs[-1] + b)
    reqs = [Xq[:, a:b] for a, b in zip(offs, offs[1:])]
    Xcat = Xq[:, :offs[-1]]
    torch.cuda.synchronize()
    reset_launches()
    latency = {b: [] for b in REQUESTS}
    drain_s = []
    for _ in range(5):
        answers = []
        for b, req in zip(REQUESTS, reqs):
            t0 = time.perf_counter()
            answers.append(batcher.assign_batch(req))   # host arrays: synced
            latency[b].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tickets = [batcher.submit(req) for req in reqs]
        out = batcher.drain()
        drain_s.append(time.perf_counter() - t0)
    emb = Extender(model, policy=ComputePolicy()).embed(Xcat)
    torch.cuda.synchronize()
    launches = counts()
    if launches["kmeans_assign"]:
        raise AssertionError(f"the default policy launched the standalone "
                             f"kmeans_assign {launches['kmeans_assign']} "
                             f"times")
    for name in ("extend_embed", "embed_assign"):
        if launches[name] == 0:
            raise AssertionError(f"serving never launched {name}")
    # The standalone kernel's served path: the two-pass embedding.
    reset_launches()
    tickets2 = [two_pass.submit(req) for req in reqs]
    out2 = two_pass.drain()
    launches2 = counts()
    if not launches2["kmeans_assign"] or launches2["embed_assign"]:
        raise AssertionError(f"the two-pass batcher launched {launches2}")
    launches = {k: launches[k] + launches2[k] for k in launches}

    unbatched = Extender(model, policy=ComputePolicy())
    for b, req, t, ans in zip(REQUESTS, reqs, tickets, answers):
        lab, d2 = (x.cpu().numpy() for x in unbatched.assign(req))
        for got in (out[t], ans):
            if not (np.array_equal(got[0], lab)
                    and np.array_equal(got[1].view(np.int32),
                                       d2.view(np.int32))):
                raise AssertionError(f"the request of {b} queries: bucketed "
                                     f"!= unbatched Extender.assign")
    got = (np.concatenate([out[t][0] for t in tickets]),
           np.concatenate([out[t][1] for t in tickets]))
    got2 = (np.concatenate([out2[t][0] for t in tickets2]),
            np.concatenate([out2[t][1] for t in tickets2]))
    plain = Extender(model, policy=ComputePolicy(embed_fused=False,
                                                 assign_fused=False))
    want = plain.assign(Xcat)
    plain_emb = plain.embed(Xcat)
    dist = ((plain_emb.T.double()[:, None, :]
             - model.centroids.double()[None]) ** 2).sum(-1).cpu().numpy()
    near_tie_compare(got, want, TOL, TOL, dist)
    near_tie_compare(got2, want, TOL, TOL, dist)
    emb_err = float((emb - plain_emb).abs().max())
    if emb_err > TOL * (1 + float(plain_emb.abs().max())):
        raise AssertionError(f"fused embeddings differ by {emb_err}")
    total = offs[-1]
    qps = total / statistics.median(drain_s)
    info = {"queries": total, "drain_queries_per_s": qps,
            "drain_s_median": statistics.median(drain_s),
            "latency_ms_median": {str(b): 1e3 * statistics.median(v)
                                  for b, v in latency.items()},
            "label_mismatch_vs_two_pass": float(
                (got[0] != want[0].cpu().numpy()).mean()),
            "two_pass_kmeans_assign_label_mismatch_vs_two_pass": float(
                (got2[0] != want[0].cpu().numpy()).mean()),
            "bucketed_equals_unbatched": True,
            "launches_default_policy": {k: launches[k] - launches2[k]
                                        for k in launches},
            "launches_two_pass_kmeans_assign": launches2,
            "embed_max_abs_err_vs_two_pass": emb_err}
    log(f"[serve] {len(REQUESTS)} requests, {total} queries: coalesced "
        f"drain {qps:.0f} queries/s; per-request latency ms " + ", ".join(
            f"{b}: {1e3 * statistics.median(v):.3f}"
            for b, v in latency.items())
        + f"; embed max abs diff vs two-pass {emb_err:.2e}; bucketed == "
        f"unbatched bit for bit; launches {info['launches_default_policy']}"
        f", then on the two-pass embedding {launches2}")
    return launches, info


def transforms(n_applied: int, n_to: int, reeigs) -> int:
    """Omega^T M transforms of a canonical SRHT stream from n_applied
    applied columns to n_to added: one per full-block update, and at each
    re-eig (at n columns added) one for the staged tail, if any, and one
    for the eigensolve's Omega^T Q. The default route launches srht_t for
    each, fwht_fn=fwht_op the fwht kernel."""
    blocks = n_to // BLOCK - n_applied // BLOCK
    return blocks + sum(int(n % BLOCK != 0) + 1 for n in reeigs)


def block_breakdown(torch, X, sketch) -> dict:
    """One canonical block update (the last full block, q + b = 99,840)
    by part, called as SketchAccumulator._apply calls them, with the SRHT
    part on both routes: srht_t on Kc, and the unfused pad + signs + fwht
    kernel + gather. CUDA events, median of 7."""
    from repro_torch.core.kernels_fn import make_kernel
    from repro_torch.core.sketch import srht_apply_t_prefix, srht_rows
    from repro_torch.kernels.fwht.ops import fwht_op
    from repro_torch.stream.accumulate import SketchAccumulator
    kern = make_kernel("polynomial", gamma=KERNEL["gamma"],
                       degree=KERNEL["degree"])
    q, b = (N_TRAIN // BLOCK - 1) * BLOCK, BLOCK
    Kc = kern(X[:, :q + b], X[:, q:q + b])
    W = torch.zeros((N_TRAIN, RP), device=X.device)

    def cross():
        W[:q] += Kc[:q] @ srht_rows(sketch, q, q + b)

    def norms():
        torch.sum(Kc * Kc, dim=0)
        torch.sum(Kc[:q] * Kc[:q], dim=1)

    parts = {
        "gram_block": cuda_ms(torch, lambda: kern(X[:, :q + b],
                                                  X[:, q:q + b])),
        "srht_fused": cuda_ms(torch, lambda: srht_apply_t_prefix(
            sketch, Kc).T),
        "srht_unfused": cuda_ms(torch, lambda: srht_apply_t_prefix(
            sketch, Kc, fwht_op).T),
        "row_norms": cuda_ms(torch, norms),
        "cross_term": cuda_ms(torch, cross)}
    acc = SketchAccumulator(kern, N_TRAIN, R, sketch=sketch,
                            oversampling=OVERSAMPLING, block=BLOCK)
    acc.add(X)
    for route, fwht_fn in (("fused", None), ("unfused", fwht_op)):
        acc.fwht_fn = fwht_fn
        parts[f"whole_block_{route}"] = cuda_ms(
            torch, lambda: acc._apply(acc.W, acc.row_norms2, q, b))
    log("[stream] canonical block update at q + b = "
        f"{q + b} by part, ms: " + ", ".join(f"{k} {v:.4f}"
                                             for k, v in parts.items()))
    return parts


def phase_stream(torch, X, Xq, canon) -> tuple:
    """The streaming fit on the canonical SRHT path's default route (every
    Omega^T M through srht_t): chunked, saved, resumed, against the
    one-shot fit, the one-shot fit through the unfused fwht kernel and
    phase 4's canonical plain fit; its saved models served."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.sketch import SRHT
    from repro_torch.kernels import OPS, fwht_op, reset_launches
    from repro_torch.serve import ComputePolicy, MicroBatcher

    def counts():
        return {name: op.launches for name, op in OPS.items()}

    def check_counts(what, got, srht_t=0, fwht=0):
        want = {name: 0 for name in OPS}
        want["srht_t"], want["fwht"] = srht_t, fwht
        if got != want:
            raise AssertionError(f"{what} launched {got}, expected {want}")

    def timed(fn):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        return time.perf_counter() - t0

    policy = ComputePolicy(fit_fused=False)
    args = estimator_args()
    n_chunks = N_TRAIN // STREAM_CHUNK
    half = n_chunks // 2
    chunks = [X[:, i * STREAM_CHUNK:(i + 1) * STREAM_CHUNK]
              for i in range(n_chunks)]
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    f32_dir = str(pathlib.Path(work.name) / "f32")

    # The live stream: chunks 1..5 (a minibatch re-eig after the fifth,
    # then save), chunks 6..10 (a full re-eig after the last).
    reset_launches()
    live = KernelKMeans(**args, policy=policy)
    chunk_s, reeig_s = [], {}
    for i, chunk in enumerate(chunks):
        chunk_s.append(timed(lambda: live.partial_fit(
            chunk, seed=SEED, capacity=N_TRAIN, reeig=False)))
        if i == half - 1:
            reeig_s["minibatch"] = timed(
                lambda: live.reeig_now(kmeans_mode="minibatch"))
            save_s = timed(lambda: live.save(f32_dir))
        elif i == n_chunks - 1:
            reeig_s["full"] = timed(lambda: live.reeig_now())
    live_counts = counts()
    check_counts("the live stream", live_counts, srht_t=transforms(
        0, N_TRAIN, (half * STREAM_CHUNK, N_TRAIN)))

    # The resumed stream: load the artifact of chunk 5, feed chunks 6..10.
    reset_launches()
    t0 = time.perf_counter()
    resumed = KernelKMeans.load(f32_dir, device=live.device, policy=policy,
                                backend_params=args["backend_params"])
    torch.cuda.synchronize()
    load_s = time.perf_counter() - t0
    resumed_s = [timed(lambda: resumed.partial_fit(
        chunk, seed=SEED, reeig=(i == n_chunks - 1)))
        for i, chunk in enumerate(chunks) if i >= half]
    resumed_counts = counts()
    applied = (half * STREAM_CHUNK) // BLOCK * BLOCK
    check_counts("the resumed stream", resumed_counts,
                 srht_t=transforms(applied, N_TRAIN, (N_TRAIN,)))

    # The one-shot fit on the same path, then through the unfused fwht
    # kernel (fwht_fn=fwht_op), timed in turns.
    reset_launches()
    one = KernelKMeans(**args, policy=policy)
    one_s = timed(lambda: one.fit(X, seed=SEED))
    one_counts = counts()
    check_counts("the one-shot fit", one_counts,
                 srht_t=transforms(0, N_TRAIN, (N_TRAIN,)))
    reset_launches()
    unfused = KernelKMeans(**estimator_args(fwht_op), policy=policy)
    unfused_s = timed(lambda: unfused.fit(X, seed=SEED))
    unfused_counts = counts()
    check_counts("the one-shot fit through fwht_op", unfused_counts,
                 fwht=transforms(0, N_TRAIN, (N_TRAIN,)))
    one_again_s = timed(lambda: KernelKMeans(**args, policy=policy).fit(
        X, seed=SEED))

    state = ("stream_w", "stream_row_norms2", "eigvals", "U")

    def bits(a, b, what, names=state + ("centroids",), labels=True):
        for name in names:
            if not torch.equal(getattr(a.model_, name),
                               getattr(b.model_, name)):
                raise AssertionError(f"{what}: {name} differs")
        if labels and not torch.equal(a.labels_, b.labels_):
            raise AssertionError(f"{what}: labels differ")

    bits(resumed, live, "resumed vs live")
    bits(live, one, "chunked vs one-shot")
    bits(unfused, one, "unfused fwht_op vs srht_t one-shot fit")

    # Phase 4's canonical plain fit had the same sketch and another
    # K-means init: its sketch state and eigendecomposition must be equal.
    m, c = live.model_, canon.model_
    err = {name: max_err(torch, getattr(m, name), getattr(c, name))
           for name in ("stream_w", "stream_row_norms2", "eigvals")}
    bits(live, canon, "stream vs the canonical plain fit", state, False)
    gap = subspace_gap(torch, m.U, c.U)
    agree = clustering_accuracy(canon.labels_, live.labels_, K)
    if agree < 0.99:
        raise AssertionError(f"stream vs canonical labels agree on {agree}")

    # The final model saved in bf16 and int8, loaded, served.
    serve_policy = ComputePolicy()
    reset_launches()
    want = MicroBatcher(m, policy=serve_policy).assign_batch(Xq)[0]
    saved = {}
    for dtype in ("bf16", "int8"):
        path = str(pathlib.Path(work.name) / dtype)
        s_save = timed(lambda: live.save(path, dtype=dtype))
        t0 = time.perf_counter()
        model = KernelKMeans.load(path, device=live.device).model_
        torch.cuda.synchronize()
        s_load = time.perf_counter() - t0
        got = MicroBatcher(model, policy=serve_policy).assign_batch(Xq)[0]
        agree_q = float(np.mean(got == want))
        if agree_q < SAVED_AGREEMENT:
            raise AssertionError(f"{dtype} artifact labels agree with the "
                                 f"f32 model on {agree_q}")
        saved[dtype] = {"save_s": s_save, "load_s": s_load,
                        "label_agreement_vs_f32": agree_q}
    serve_counts = counts()
    if serve_counts["embed_assign"] == 0 or serve_counts["kmeans_assign"]:
        raise AssertionError(f"serving the saved models launched "
                             f"{serve_counts}: embed_assign never, or the "
                             f"standalone kmeans_assign")
    work.cleanup()
    sketch = SRHT(signs=m.sketch_signs, rows=m.sketch_rows, n=N_TRAIN,
                  n_pad=int(m.sketch_signs.shape[0]))
    breakdown = block_breakdown(torch, X, sketch)

    launches = {name: live_counts[name] + resumed_counts[name]
                + one_counts[name] + unfused_counts[name]
                + serve_counts[name] for name in OPS}
    info = {"chunks": n_chunks, "chunk_columns": STREAM_CHUNK,
            "partial_fit_s": chunk_s, "reeig_s": reeig_s,
            "save_f32_s": save_s, "load_f32_s": load_s,
            "resumed_partial_fit_s": resumed_s, "one_shot_fit_s": one_s,
            "one_shot_fit_again_s": one_again_s,
            "one_shot_fit_unfused_fwht_op_s": unfused_s,
            "srht_t_launches": {"live": live_counts["srht_t"],
                                "resumed": resumed_counts["srht_t"],
                                "one_shot": one_counts["srht_t"]},
            "fwht_launches_unfused_one_shot": unfused_counts["fwht"],
            "resumed_equals_live": True, "chunked_equals_one_shot": True,
            "unfused_equals_fused_route": True,
            "equals_canonical_plain": True,
            **{f"{k}_max_abs_err_vs_canonical_plain": v
               for k, v in err.items()},
            "subspace_gap_vs_canonical_plain": gap,
            "label_agreement_vs_canonical_plain": agree,
            "saved": saved, "block_breakdown_ms": breakdown}
    log("[stream] partial_fit s per chunk " + ", ".join(
        f"{t:.4f}" for t in chunk_s) + f"; re-eig s: minibatch "
        f"{reeig_s['minibatch']:.4f} (after chunk {half}), full "
        f"{reeig_s['full']:.4f}; save f32 {save_s:.4f} s, load {load_s:.4f}"
        f" s")
    log("[stream] resumed partial_fit s per chunk " + ", ".join(
        f"{t:.4f}" for t in resumed_s) + f"; one-shot fit {one_s:.4f} s, "
        f"through the unfused fwht_op {unfused_s:.4f} s, again "
        f"{one_again_s:.4f} s; srht_t launches live "
        f"{live_counts['srht_t']}, resumed {resumed_counts['srht_t']}, "
        f"one-shot {one_counts['srht_t']}")
    log(f"[stream] resumed == live, chunked == one-shot and fwht_op == "
        f"srht_t bit for bit; vs the canonical plain fit (equal): stream_w "
        f"{err['stream_w']:.2e}, row norms {err['stream_row_norms2']:.2e}, "
        f"eigvals {err['eigvals']:.2e}, subspace gap {gap:.2e}, labels "
        f"{agree:.4f}")
    log("[stream] saved models: " + ", ".join(
        f"{d} save {v['save_s']:.4f} s, load {v['load_s']:.4f} s, labels vs "
        f"f32 {v['label_agreement_vs_f32']:.4f}" for d, v in saved.items()))
    return launches, info


def serve_model(torch, model, Xq) -> tuple:
    """Serve Xq on the default policy: Extender.assign of all of it, and
    coalesced MicroBatcher drains of its requests (phase 5's, then the
    rest of Xq as one more); each request's labels
    and distances equal an unbatched Extender.assign bit for bit, and the
    served labels hold against the two-pass plain extension by the
    near-tie rule (distances within TOL). Returns (labels, facts)."""
    from repro_torch.kernels.registry import near_tie_compare
    from repro_torch.serve import ComputePolicy, Extender, MicroBatcher
    offs = [0]
    for b in REQUESTS + (Xq.shape[1] - sum(REQUESTS),):
        offs.append(offs[-1] + b)
    reqs = [Xq[:, a:b] for a, b in zip(offs, offs[1:]) if b > a]
    ext = Extender(model, policy=ComputePolicy())
    t0 = time.perf_counter()
    labels, d2 = ext.assign(Xq)
    torch.cuda.synchronize()
    assign_s = time.perf_counter() - t0
    batcher = MicroBatcher(model, policy=ComputePolicy())
    batcher.warm(tuple(r.shape[1] for r in reqs))
    drain_s = []
    for _ in range(3):
        t0 = time.perf_counter()
        tickets = [batcher.submit(req) for req in reqs]
        out = batcher.drain()
        drain_s.append(time.perf_counter() - t0)
    for req, t in zip(reqs, tickets):
        lab, dd = (x.cpu().numpy() for x in ext.assign(req))
        if not (np.array_equal(out[t][0], lab)
                and np.array_equal(out[t][1].view(np.int32),
                                   dd.view(np.int32))):
            raise AssertionError(f"the request of {req.shape[1]} queries: "
                                 f"bucketed != unbatched Extender.assign")
    got = (np.concatenate([out[t][0] for t in tickets]),
           np.concatenate([out[t][1] for t in tickets]))
    if not (np.array_equal(got[0], labels.cpu().numpy())
            and np.array_equal(got[1].view(np.int32),
                               d2.cpu().numpy().view(np.int32))):
        raise AssertionError("the drain != Extender.assign of all queries")
    plain = Extender(model, policy=ComputePolicy(embed_fused=False,
                                                 assign_fused=False))
    want = plain.assign(Xq)
    emb = plain.embed(Xq)
    dist = ((emb.T.double()[:, None, :] - model.centroids.double()[None])
            ** 2).sum(-1).cpu().numpy()
    near_tie_compare(got, want, TOL, TOL, dist)
    facts = {"queries": int(Xq.shape[1]), "requests": len(reqs),
             "assign_s": assign_s,
             "drain_s_median": statistics.median(drain_s),
             "drain_queries_per_s": Xq.shape[1] / statistics.median(drain_s),
             "label_mismatch_vs_two_pass": float(
                 (got[0] != want[0].cpu().numpy()).mean()),
             "d2_max_abs_err_vs_two_pass": max_err(
                 torch, torch.from_numpy(got[1]), want[1].cpu()),
             "bucketed_equals_unbatched": True}
    return labels, facts


def backend_args(name: str, **params):
    """The configuration's estimator arguments on the Nystrom or exact
    backend, with its backend_params (the Nystrom m)."""
    return {**estimator_args(), "backend": name, "backend_params": params}


def fit_on_card(torch, args, X, policy=None) -> tuple:
    """KernelKMeans(**args).fit(X, seed=SEED) on the card: the estimator,
    the host seconds to the last synchronize, and the peak device memory
    (since a reset just before the fit) in all and above what was
    allocated at the reset."""
    from repro_torch.api import KernelKMeans
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    t0 = time.perf_counter()
    est = KernelKMeans(**args, policy=policy).fit(X, seed=SEED)
    torch.cuda.synchronize()
    seconds = time.perf_counter() - t0
    peak = torch.cuda.max_memory_allocated()
    return est, {"fit_s": seconds, "peak_device_bytes": peak,
                 "peak_device_bytes_above_start": peak - base,
                 "fit_times_s": est.fit_times_}


def landmark_widths(torch, X, Xq) -> dict:
    """extend_embed and embed_assign at n_ref = LANDMARK_N training points
    (a Nystrom model's landmarks), w = LANDMARK_W queries: against their
    plain versions at the registry tolerances, the same bits on two
    launches, timed. Comparison launches: not counted."""
    from repro_torch.kernels import registry
    gen = torch.Generator(device=X.device).manual_seed(19)
    kw = dict(KERNEL)
    out = {"extend_embed": {}, "embed_assign": {}}
    for n in LANDMARK_N:
        proj = torch.randn((R, n), generator=gen, device=X.device) / n
        cents = torch.randn((K, R), generator=gen, device=X.device) / 30.0
        for w in LANDMARK_W:
            base = (X[:, :n].contiguous(), proj, Xq[:, :w])
            for name in out:
                entry = registry.get_kernel(name)
                args = base + ((cents,) if name == "embed_assign" else ())
                got = entry.op(*args, **kw)
                torch.cuda.synchronize()
                want = entry.ref(*args, **kw)
                registry.compare(entry, got, want, (args, kw))
                same_bits(torch, name, got, entry.op(*args, **kw))
                out[name][f"n{n}_w{w}"] = {
                    "max_abs_err": max_err(torch, got, want),
                    "ms": cuda_ms(torch, lambda: entry.op(*args, **kw)),
                    "plain_ms": cuda_ms(torch,
                                        lambda: entry.ref(*args, **kw))}
    for name, cases in out.items():
        log(f"[backends] {name} at the landmark widths (n_ref, w): " +
            "; ".join(f"{c}: err {v['max_abs_err']:.2e}, kernel "
                      f"{v['ms']:.4f} ms, plain {v['plain_ms']:.4f} ms"
                      for c, v in cases.items()))
    return out


def phase_backends(torch, X, y, Xq, onepass) -> tuple:
    """The Nystrom and exact backends fitted and served on the card; the
    memory-against-error axis of the paper at n = 100,000. Returns
    (launches of the path, facts, landmark-width results)."""
    from repro_torch.core import (gram_matrix, kernel_approx_error,
                                  kernel_approx_error_streaming,
                                  objective_from_labels)
    from repro_torch.core.kernels_fn import make_kernel
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.api import KernelKMeans, fit_memory_bytes
    from repro_torch.kernels import OPS, reset_launches
    from repro_torch.serve import ComputePolicy
    widths = landmark_widths(torch, X, Xq)
    kern = make_kernel("polynomial", gamma=KERNEL["gamma"],
                       degree=KERNEL["degree"])
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    reset_launches()

    # 1. Nystrom at n = 100,000: round trip, serving, artifacts.
    nystrom, info = {}, {"nystrom": {}}
    for m in NYSTROM_M:
        est, facts = fit_on_card(torch, backend_args("nystrom", m=m), X)
        if est.model_.n_ref != m or not bool(
                torch.isfinite(est.embedding_).all()):
            raise AssertionError(f"Nystrom m={m}: n_ref "
                                 f"{est.model_.n_ref}, embedding not finite")
        before = OPS["extend_embed"].launches
        Y = est.embedding_
        round_trip = float(torch.linalg.norm(est.embed(X) - Y)
                           / torch.linalg.norm(Y))
        if OPS["extend_embed"].launches == before:
            raise AssertionError("embed(X_train) never launched extend_embed")
        if not round_trip <= TOL:
            raise AssertionError(f"Nystrom m={m}: the training round trip "
                                 f"through extend_embed is {round_trip}")
        labels, served = serve_model(torch, est.model_, Xq)
        facts.update({"m": m, "fit_memory_bytes": fit_memory_bytes(
            "nystrom", N_TRAIN, R, m=m), "round_trip_rel": round_trip,
            "accuracy_vs_generating_labels": clustering_accuracy(
                y, est.labels_, K), "serve": served})
        if m == NYSTROM_M[0]:
            saved = {}
            for dtype in ("f32", "bf16", "int8"):
                path = est.save(str(pathlib.Path(work.name) / dtype),
                                dtype=dtype)
                model = KernelKMeans.load(path, device=est.device).model_
                got = serve_model(torch, model, Xq)[0]
                agree = float((got == labels).float().mean())
                if dtype == "f32" and not torch.equal(got, labels):
                    raise AssertionError("the f32 Nystrom artifact serves "
                                         "other labels than the live model")
                if agree < SAVED_AGREEMENT:
                    raise AssertionError(f"{dtype} Nystrom artifact labels "
                                         f"agree with the live model on "
                                         f"{agree}")
                saved[dtype] = agree
            facts["saved_label_agreement"] = saved
        nystrom[m] = est
        info["nystrom"][str(m)] = facts
        log(f"[backends] nystrom m={m} at n={N_TRAIN}: fit "
            f"{facts['fit_s']:.4f} s ({', '.join(f'{k} {v:.4f}' for k, v in est.fit_times_.items())}), "
            f"peak device memory {facts['peak_device_bytes_above_start']}"
            f" bytes above the start, memory model "
            f"{facts['fit_memory_bytes']} bytes; round trip {round_trip:.2e}"
            f"; serve: drain {served['drain_s_median'] * 1e3:.3f} ms "
            f"({served['drain_queries_per_s']:.0f} queries/s), assign of "
            f"{served['queries']} {served['assign_s'] * 1e3:.3f} ms, labels"
            f" vs two-pass {served['label_mismatch_vs_two_pass']:.4f}"
            + (f"; artifacts {facts['saved_label_agreement']}"
               if m == NYSTROM_M[0] else ""))

    # 2. Exact at n = 10,000 against the fused one-pass fit and Nystrom,
    # on every tenth training point: the proxy lays its classes out in
    # blocks, so the first 10,000 points would all be of one class.
    step = N_TRAIN // N_EXACT
    Xe, ye = X[:, ::step].contiguous(), y[::step]
    Ke = gram_matrix(kern, Xe)
    cases = {"exact": (backend_args("exact"), None),
             "onepass-srht": (estimator_args(), ComputePolicy()),
             "nystrom": (backend_args("nystrom", m=NYSTROM_M[0]), None)}
    info["exact_n"] = N_EXACT
    info["at_exact_n"] = {}
    errs = {}
    for name, (args, policy) in cases.items():
        est, facts = fit_on_card(torch, args, Xe, policy)
        errs[name] = kernel_approx_error(Ke, est.embedding_)
        facts.update({
            "kernel_approx_error": errs[name],
            "accuracy_vs_generating_labels": clustering_accuracy(
                ye, est.labels_, K),
            "objective_L": float(objective_from_labels(Ke, est.labels_, K)),
            "fit_memory_bytes": fit_memory_bytes(
                name, N_EXACT, R, **args["backend_params"])})
        if name == "exact":
            facts["serve"] = serve_model(torch, est.model_, Xq)[1]
        info["at_exact_n"][name] = facts
        log(f"[backends] {name} at n={N_EXACT}: fit {facts['fit_s']:.4f} s"
            f" ({', '.join(f'{k} {v:.4f}' for k, v in est.fit_times_.items())}), "
            f"peak device memory {facts['peak_device_bytes_above_start']}"
            f" bytes above the start, memory model "
            f"{facts['fit_memory_bytes']} bytes; error {errs[name]:.6f}, "
            f"accuracy {facts['accuracy_vs_generating_labels']:.4f}, "
            f"L(C) {facts['objective_L']:.4f}"
            + (f"; serve: drain {facts['serve']['drain_s_median'] * 1e3:.3f}"
               f" ms, labels vs two-pass "
               f"{facts['serve']['label_mismatch_vs_two_pass']:.4f}"
               if name == "exact" else ""))
    del Ke
    below = {k: v for k, v in errs.items() if v < errs["exact"] - 1e-5}
    if below:
        raise AssertionError(f"errors below the exact floor "
                             f"{errs['exact']}: {below}")

    # 3. The memory-against-error axis at n = 100,000.
    info["streaming_error_at_n_train"] = {}
    for name, est in [("onepass-srht (phase 4, fused)", onepass)] + [
            (f"nystrom m={m}", e) for m, e in nystrom.items()]:
        t0 = time.perf_counter()
        err = kernel_approx_error_streaming(kern, X, est.embedding_)
        info["streaming_error_at_n_train"][name] = err
        log(f"[backends] kernel_approx_error_streaming at n={N_TRAIN}, "
            f"{name}: {err:.6f} ({time.perf_counter() - t0:.2f} s)")
    torch.cuda.synchronize()
    launches = {name: op.launches for name, op in OPS.items()}
    work.cleanup()
    if launches["kmeans_assign"]:
        raise AssertionError(f"the default policy launched the standalone "
                             f"kmeans_assign {launches['kmeans_assign']} "
                             f"times")
    for name in ("extend_embed", "embed_assign"):
        if launches[name] == 0:
            raise AssertionError(f"phase 8 never launched {name}")
    info["launches"] = launches
    log(f"[backends] launches {launches}")
    return launches, info, widths


class LaunchTally:
    """Launch counts of the deterministic parts of phase 9: each counted
    call runs with every count set to 0 and adds what it launched. The
    parts a pump thread serves are not counted (a wrapper's `launches
    += 1` is not atomic across threads)."""

    def __init__(self, torch):
        from repro_torch.kernels import OPS
        self.torch, self.ops = torch, OPS
        self.launches = {name: 0 for name in OPS}

    def __call__(self, fn):
        from repro_torch.kernels import reset_launches
        self.torch.cuda.synchronize()
        reset_launches()
        out = fn()
        self.torch.cuda.synchronize()
        for name, op in self.ops.items():
            self.launches[name] += op.launches
        return out


def same_answers(what, got, want) -> None:
    """Per request (labels, d2) equal bit for bit."""
    for i, (g, w) in enumerate(zip(got, want)):
        if not (np.array_equal(g[0], w[0])
                and np.array_equal(g[1].view(np.int32), w[1].view(np.int32))):
            raise AssertionError(f"{what}: request {i} differs")


def plain_distances(torch, model, Xb):
    """The two-pass plain extension's assignment of Xb, and its squared
    distances to every centroid (w, k) in float64: the near-tie rule's
    reference."""
    from repro_torch.serve import ComputePolicy, Extender
    plain = Extender(model, policy=ComputePolicy(embed_fused=False,
                                                 assign_fused=False))
    emb = plain.embed(Xb)
    dist = ((emb.T.double()[:, None, :] - model.centroids.double()[None])
            ** 2).sum(-1).cpu().numpy()
    return plain.assign(Xb), dist


def held_out_requests(Xq) -> list:
    """ASYNC_REQUESTS requests of ASYNC_WIDTHS held-out queries at random
    offsets (seed SEED), as host arrays."""
    rng = np.random.RandomState(SEED)
    lo, hi = ASYNC_WIDTHS
    widths = rng.randint(lo, hi + 1, size=ASYNC_REQUESTS)
    host = Xq.cpu().numpy()
    reqs = []
    for w in widths:
        a = rng.randint(0, N_QUERY - w + 1)
        reqs.append(np.ascontiguousarray(host[:, a:a + w]))
    return reqs


def lifecycle_serve(torch, model, Xq, tally) -> dict:
    """9a: phase 4's model behind the registry's async front door with its
    pump thread live; async == sync drain bit for bit; labels against the
    two-pass plain extension; a VersionStore with pins and GC; a warm swap
    with requests pending; the async and swap benches."""
    from repro_torch.kernels.registry import near_tie_compare
    from repro_torch.serve import (ComputePolicy, MicroBatcher,
                                   ModelRegistry, VersionStore,
                                   benchmark_async, benchmark_swap)
    reqs = held_out_requests(Xq)
    queries = sum(r.shape[1] for r in reqs)

    reg = ModelRegistry()
    reg.register("main", model)
    sched = reg.scheduler("main", max_wait_ms=2.0, slo_ms=250.0)
    tally(lambda: sched.batcher.warm(ALL_BUCKETS))    # before the pump
    flushes = sched.batcher.stats["batches"]
    sched.start()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    futs = [sched.submit(r) for r in reqs]
    answers = [f.result(timeout=120.0) for f in futs]
    wall = time.perf_counter() - t0
    flushes = sched.batcher.stats["batches"] - flushes
    if sched.pump_errors:
        raise AssertionError(f"the pump failed: {sched.last_pump_error!r}")

    sync = MicroBatcher(model, policy=ComputePolicy())
    for r in reqs:
        sync.submit(r)
    same_answers("async != a synchronous drain", answers, tally(sync.drain))
    Xcat = torch.from_numpy(np.concatenate(reqs, axis=1)).to(model.device)
    want, dist = plain_distances(torch, model, Xcat)
    got = (np.concatenate([a[0] for a in answers]),
           np.concatenate([a[1] for a in answers]))
    near_tie_compare(got, want, TOL, TOL, dist)
    summary = sched.latency.summary()
    serve = {"requests": ASYNC_REQUESTS, "queries": queries,
             "flushes": flushes, "wall_s": wall,
             "queries_per_s": queries / wall, "latency": summary,
             "async_equals_sync_drain": True,
             "label_mismatch_vs_two_pass": float(
                 (got[0] != want[0].cpu().numpy()).mean())}
    lat, wait = summary["latency_ms"], summary["queue_wait_ms"]
    log(f"[lifecycle] {ASYNC_REQUESTS} requests ({queries} queries) "
        f"through the pump in {flushes} flushes: {queries / wall:.0f} "
        f"queries/s; total p50 / p95 / p99 {lat['p50']:.3f} / "
        f"{lat['p95']:.3f} / {lat['p99']:.3f} ms, queue wait "
        f"{wait['p50']:.3f} / {wait['p95']:.3f} / {wait['p99']:.3f} ms, SLO "
        f"{summary['slo_ms']} ms violations {summary['slo_violations']}; "
        f"== a synchronous drain bit for bit; labels against the two-pass "
        f"plain extension by the near-tie rule")
    bench = tally(lambda: benchmark_async(
        model, n_requests=ASYNC_REQUESTS, width_range=ASYNC_WIDTHS,
        max_wait_ms=2.0, slo_ms=250.0, seed=SEED))
    blat = bench["latency"]["latency_ms"]
    log(f"[lifecycle] benchmark_async (cooperative): "
        f"{bench['queries_per_sec']:.0f} queries/s, p50 / p95 / p99 "
        f"{blat['p50']:.3f} / {blat['p95']:.3f} / {blat['p99']:.3f} ms, SLO "
        f"violations {bench['latency']['slo_violations']}")

    # The store: v1 pinned outlives gc(keep=1); unpinned, gc(keep=2)
    # leaves v2 and v3 (the centroid rows reversed: labels k - 1 - old).
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    store = VersionStore(str(pathlib.Path(work.name) / "versions"))
    v1, v2 = store.publish(model), store.publish(model)
    store.pin(v1, PIN_OWNER)
    if store.gc(keep=1) or store.versions() != [v1, v2]:
        raise AssertionError(f"gc(keep=1) under a pin of v{v1} left "
                             f"{store.versions()}")
    v3 = store.publish(model._replace(
        centroids=model.centroids.flip(0).contiguous()))
    store.unpin(v1, PIN_OWNER)
    if store.gc(keep=2) != [v1] or store.versions() != [v2, v3]:
        raise AssertionError(f"gc(keep=2) left {store.versions()}")
    store.pin(v3, PIN_OWNER)
    model_b = store.load(v3, device=model.device)

    # The warm swap with requests pending: hold the window (no bucket is
    # due) so the swap's drain, not the pump, resolves them.
    for b in ALL_BUCKETS:
        sched.set_bucket_wait(b, 3.6e6)
    held = reqs[:SWAP_PENDING]
    pending = [sched.submit(r) for r in held]
    if sched.pending_requests != SWAP_PENDING:
        raise AssertionError(f"{sched.pending_requests} requests pending")
    old_buckets = sched.batcher.executables
    report = reg.swap("main", model_b, version=v3)
    sched2 = reg.scheduler("main")
    if report.drained_requests != SWAP_PENDING or not all(
            f.done() for f in pending):
        raise AssertionError(f"the swap drained {report.drained_requests}")
    same_answers("a pending request after the swap",
                 [f.result(timeout=0) for f in pending],
                 answers[:SWAP_PENDING])
    if not sched2.running or sched.running:
        raise AssertionError("the pump did not move to the new row")
    after = [sched2.submit(r) for r in held]
    for f, old in zip(after, answers):
        if not np.array_equal(f.result(timeout=60.0)[0], K - 1 - old[0]):
            raise AssertionError("a later request was not served by v3")
    stranded = sum(not f.done() for f in futs + pending + after)
    if stranded or not set(old_buckets) <= set(report.buckets_warmed):
        raise AssertionError(f"{stranded} stranded; warmed "
                             f"{report.buckets_warmed} of {old_buckets}")
    try:
        sched.submit(held[0])
        raise AssertionError("the retired scheduler took a request")
    except RuntimeError:
        pass
    sched2.stop()
    try:
        sched2.submit(held[0])
        raise AssertionError("a stopped scheduler took a request")
    except RuntimeError:
        pass
    if sched.pump_errors or sched2.pump_errors:
        raise AssertionError("a pump thread failed")
    swap = report.to_dict()
    swap["p95_after_ms"] = sched2.latency.total.percentile(95.0)
    bswap = tally(lambda: benchmark_swap(model, n_requests=128, seed=SEED))
    work.cleanup()
    log(f"[lifecycle] store: v{v1} pinned survived gc(keep=1); unpinned, "
        f"gc(keep=2) left v{v2}, v{v3}; warm swap v{report.old_version} -> "
        f"v{report.new_version}: flip {report.flip_ms:.4f} ms, warm "
        f"{report.warm_s:.4f} s (buckets {report.buckets_warmed}), drain "
        f"{report.drain_s:.4f} s of {report.drained_requests} pending "
        f"requests, p95 {report.p95_before_ms:.3f} -> "
        f"{swap['p95_after_ms']:.3f} ms; 0 stranded futures; later "
        f"requests labelled k - 1 - old by v3")
    log(f"[lifecycle] benchmark_swap: flip {bswap['flip_ms']:.4f} ms, warm "
        f"{bswap['warm_s']:.4f} s, drain {bswap['drain_s']:.4f} s, p95 "
        f"{bswap['p95_before_ms']:.3f} -> {bswap['p95_after_ms']:.3f} ms, "
        f"stranded {bswap['stranded_futures']}")
    if bswap["stranded_futures"]:
        raise AssertionError("benchmark_swap stranded futures")
    return {"async": serve, "benchmark_async": bench, "swap": swap,
            "benchmark_swap": bswap,
            "store": {"gc_keep_1_under_pin": [v1, v2],
                      "gc_keep_2": [v2, v3]}}


def drift_errors_plain(torch, mon, Xb):
    """The monitor's errors with the plain kappa (kernels/gram/ref.py)."""
    from repro_torch.kernels.gram.ref import gram_stripe_ref
    model = mon.model
    z = gram_stripe_ref(model.extension_ref, Xb, *mon._statics)
    resid = z - model.U @ (model.U.T @ z)
    return torch.linalg.norm(resid, dim=0) / torch.clamp(
        torch.linalg.norm(z, dim=0), min=1e-12)


def lifecycle_stream(torch, X, y, Xq, yq, tally) -> tuple:
    """9b: the streaming loop at full width on the canonical route: a fit
    of the first half, healthy traffic (quiet), drifted traffic (one
    rollout: refit -> publish -> swap -> rebind), accuracy on the drifted
    set before and after; the monitor's errors through the gram kernel
    against the plain kappa; gram timed at the drift shape."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.kernels import registry
    from repro_torch.kernels.gram.ops import gram_stripe_op
    from repro_torch.kernels.gram.ref import gram_stripe_ref
    from repro_torch.serve import Extender, ModelRegistry, VersionStore
    from repro_torch.stream import DriftMonitor, RetrainWorker
    y_host, yq_host = y.cpu().numpy(), yq.cpu().numpy()
    X_host = X.cpu().numpy()
    Xd = torch.cat([X[:, DRIFT_FROM:], Xq], dim=1)
    yd = np.concatenate([y_host[DRIFT_FROM:], yq_host])
    classes = {"first_half": np.bincount(y_host[:STREAM_HALF],
                                         minlength=K).tolist(),
               "second_half": np.bincount(y_host[STREAM_HALF:],
                                          minlength=K).tolist(),
               "drifted": np.bincount(yd, minlength=K).tolist()}

    def fit_first():
        for lo in range(0, STREAM_HALF, STREAM_CHUNK):
            est.partial_fit(X[:, lo:lo + STREAM_CHUNK], seed=SEED,
                            capacity=N_TRAIN,
                            reeig=lo + STREAM_CHUNK >= STREAM_HALF)

    est = KernelKMeans(**estimator_args())
    t0 = time.perf_counter()
    tally(fit_first)
    fit_s = time.perf_counter() - t0
    stale = est.model_

    def accuracy(model):
        labels, _ = Extender(model).assign(Xd)
        return clustering_accuracy(yd, labels.cpu().numpy(), K)

    acc_before = tally(lambda: accuracy(stale))
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    store = VersionStore(str(pathlib.Path(work.name) / "versions"))
    reg = ModelRegistry()
    reg.register("stream", stale, version=store.publish(stale))
    sched = reg.scheduler("stream", max_wait_ms=2.0, slo_ms=250.0)
    tally(lambda: sched.batcher.warm(ALL_BUCKETS))
    # The reference is what serving gives the training points
    # (ref_labels=None), as after every rollout's rebind: at rank 2 the
    # extension of a training point often differs from its K-means label
    # when the first half's 4 classes take 7 clusters (a property of the
    # JAX package's fit too), and traffic of that very half would fire.
    served = tally(lambda: Extender(stale).assign(X[:, :STREAM_HALF])[0])
    label_gap = float((served != est.labels_).float().mean())
    mon = tally(lambda: DriftMonitor(
        stale, chi2_threshold=30.0, frac_delta_threshold=0.25,
        min_queries=64, approx_err_threshold=None))
    worker = RetrainWorker("stream", reg, store, mon,
                           lambda rep: est.partial_fit(
                               X[:, STREAM_HALF:]).model_)
    rng = np.random.RandomState(SEED + 9)

    def traffic(pool):
        """TRAFFIC_COLS shuffled columns of pool (host) through the async
        front door, each request observed with its served labels."""
        cols = pool[:, rng.permutation(pool.shape[1])[:TRAFFIC_COLS]]
        chunks = [np.ascontiguousarray(cols[:, a:a + TRAFFIC_WIDTH])
                  for a in range(0, TRAFFIC_COLS, TRAFFIC_WIDTH)]
        futs = [sched.submit(c) for c in chunks]
        sched.flush()
        for c, f in zip(chunks, futs):
            mon.observe(c, f.result(timeout=0)[0])
        return chunks, futs

    healthy, _ = tally(lambda: traffic(X_host[:, :STREAM_HALF]))
    quiet = mon.report()
    if tally(worker.step) is not None:
        raise AssertionError(f"the monitor fired on healthy traffic: "
                             f"{quiet.reason}")
    gram_before = tally.launches["gram_stripe"]
    drifted, dfuts = tally(lambda: traffic(Xd.cpu().numpy()))
    if tally.launches["gram_stripe"] <= gram_before:
        raise AssertionError("the monitor never launched the gram kernel")
    # The monitor's errors through the gram kernel against the plain kappa
    # on a healthy and a drifted request, on the stale model.
    entry = registry.get_kernel("gram_stripe")
    err_gap = 0.0
    for chunk in (healthy[0], drifted[0]):
        Xb = torch.from_numpy(chunk).to(X.device)
        got, want = mon._approx_errors(Xb), drift_errors_plain(torch, mon,
                                                                Xb)
        registry.compare(entry, got, want)
        err_gap = max(err_gap, max_err(torch, got, want))
    pending = sched.submit(drifted[1])
    rollout = tally(worker.step)
    if rollout is None:
        raise AssertionError(f"drift did not fire: {mon.report().reason}")
    if tally(worker.step) is not None or worker.retrains != 1:
        raise AssertionError("drift must trigger exactly one rollout")
    stranded = sum(not f.done() for f in dfuts + [pending])
    if stranded or rollout.swap.drained_requests != 1:
        raise AssertionError(f"{stranded} futures stranded, drained "
                             f"{rollout.swap.drained_requests}")
    acc_after = tally(lambda: accuracy(reg.get("stream")))
    if not acc_after > acc_before:
        raise AssertionError(f"drifted-set accuracy {acc_before} -> "
                             f"{acc_after}")
    if worker.errors or sched.pump_errors:
        raise AssertionError(f"worker errors {worker.errors}")
    reg.unregister("stream")
    work.cleanup()

    # gram at the drift shape: the stale model's training columns against
    # one request.
    ref_pts = stale.extension_ref.contiguous()
    Xb = torch.from_numpy(drifted[0]).to(X.device)
    kind, gamma, degree = mon._statics
    kw = {"kind": kind, "gamma": gamma, "degree": degree}
    n_ref, w = ref_pts.shape[1], Xb.shape[1]
    got = gram_stripe_op(ref_pts, Xb, **kw)
    registry.compare(entry, got, gram_stripe_ref(ref_pts, Xb, **kw))
    gram = {"shape": [n_ref, w, P],
            "ms": cuda_ms(torch, lambda: gram_stripe_op(ref_pts, Xb, **kw)),
            "ms_back_to_back": cuda_ms_back_to_back(
                torch, lambda: gram_stripe_op(ref_pts, Xb, **kw)),
            "plain_ms": cuda_ms(torch, lambda: gram_stripe_ref(ref_pts, Xb,
                                                               **kw)),
            "monitor_err_max_abs_diff_vs_plain": err_gap,
            **gram_tc_bound(P, n_ref, w, kind, degree),
            "fp32_bound_ms": gram_bound(P, n_ref, w, kind,
                                        degree)["bound_ms"]}
    drift = rollout.drift
    info = {"classes": classes, "first_fit_s": fit_s,
            "training_labels_differing_from_served": label_gap,
            "quiet_report": quiet.to_dict(), "rollout": {
                k: v for k, v in rollout.to_dict().items() if k != "swap"},
            "swap": rollout.swap.to_dict(),
            "accuracy_drifted_before": acc_before,
            "accuracy_drifted_after": acc_after, "retrains": worker.retrains,
            "stranded_futures": 0}
    log(f"[lifecycle] stream: classes of the first half "
        f"{classes['first_half']}, of the second {classes['second_half']}, "
        f"of the drifted pool {classes['drifted']}; first fit "
        f"({STREAM_HALF // STREAM_CHUNK} partial_fit chunks) {fit_s:.3f} s,"
        f" its K-means labels differ from the served labels of the same "
        f"points on {label_gap:.4f}; healthy traffic quiet (chi2 "
        f"{quiet.chi2:.3g}, max delta {quiet.max_frac_delta:.3g})")
    log(f"[lifecycle] stream: drift fired ({drift.reason}; approx err p50 "
        f"{drift.approx_err_p50:.4f}, p95 {drift.approx_err_p95:.4f} over "
        f"{drift.samples} queries); rollout v{rollout.version}: refit "
        f"{rollout.refit_s:.4f} s, publish {rollout.publish_s:.4f} s, swap "
        f"{rollout.swap_s:.4f} s, detect -> swap "
        f"{rollout.detect_to_swap_s:.4f} s; one rollout, 0 stranded "
        f"futures; drifted-set accuracy {acc_before:.4f} -> "
        f"{acc_after:.4f}; monitor errors through gram vs plain kappa max "
        f"abs diff {err_gap:.2e}")
    log(f"[lifecycle] gram at the drift shape {gram['shape']}: kernel "
        f"{gram['ms']:.4f} ms (back to back {gram['ms_back_to_back']:.4f}), "
        f"plain {gram['plain_ms']:.4f} ms, bound {gram['bound_ms']:.5f} ms "
        f"({gram['bound_term']})")
    return info, gram


def phase_lifecycle(torch, model, X, y, Xq, yq) -> tuple:
    """Phase 9: 9a serving lifecycle on phase 4's model, 9b the streaming
    loop; the launches of their deterministic parts."""
    tally = LaunchTally(torch)
    info = {"serve": lifecycle_serve(torch, model, Xq, tally)}
    info["stream"], gram = lifecycle_stream(torch, X, y, Xq, yq, tally)
    log(f"[lifecycle] launches {tally.launches}")
    return tally.launches, info, gram


def fleet_serve(fleet, reqs, keys=None) -> tuple:
    """Submit `reqs` to a cooperative fleet (control() every 16 requests,
    the JAX bench's cadence), then drain it: the answers, and the worker
    each request was queued on."""
    def accepted(w):            # queued or completed, across flushes
        return w.scheduler().pending_requests + w.latency.requests

    futs, placed = [], []
    for i, r in enumerate(reqs):
        before = [accepted(w) for w in fleet.workers]
        futs.append(fleet.submit(r, key=None if keys is None else keys[i]))
        placed.append(next(w.worker_id for w, n in zip(fleet.workers, before)
                           if accepted(w) > n))
        if (i + 1) % 16 == 0:
            fleet.control()
    fleet.flush()
    return [f.result(timeout=0) for f in futs], placed


def released(store) -> None:
    held = {v: pins for v in store.versions() if (pins := store.pins(v))}
    if held:
        raise AssertionError(f"pins left after the fleet stopped: {held}")


def fleet_answers(torch, model, store, reqs, want, tally) -> tuple:
    """10a: two replicas behind least-loaded routing answer every request
    as an unbatched Extender.assign, bit for bit; hash routing places a
    key on the same replica twice."""
    from repro_torch.fleet import Fleet
    from repro_torch.kernels.registry import near_tie_compare
    from repro_torch.serve import VersionStore
    fleet = Fleet(store, n_workers=FLEET_WORKERS, device=DEVICE, **FLEET_KW)
    tally(lambda: [w.scheduler().batcher.warm(ALL_BUCKETS)
                   for w in fleet.workers])
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    answers, placed = tally(lambda: fleet_serve(fleet, reqs))
    wall = time.perf_counter() - t0
    same_answers("a fleet-routed request != an unbatched Extender.assign",
                 answers, want)
    per_worker = {w.worker_id: placed.count(w.worker_id)
                  for w in fleet.workers}
    if min(per_worker.values()) == 0:
        raise AssertionError(f"a replica served nothing: {per_worker}")
    Xcat = torch.from_numpy(np.concatenate(reqs, axis=1)).to(model.device)
    plain, dist = plain_distances(torch, model, Xcat)
    got = (np.concatenate([a[0] for a in answers]),
           np.concatenate([a[1] for a in answers]))
    near_tie_compare(got, plain, TOL, TOL, dist)
    queries = int(Xcat.shape[1])
    lat = fleet.latency().summary()
    info = {"requests": len(reqs), "queries": queries,
            "requests_per_worker": per_worker, "wall_s": wall,
            "queries_per_s": queries / wall, "latency": lat,
            "equals_unbatched_assign": True,
            "label_mismatch_vs_two_pass": float(
                (got[0] != plain[0].cpu().numpy()).mean())}
    log(f"[fleet] {len(reqs)} requests ({queries} queries), least-loaded "
        f"over {FLEET_WORKERS} replicas {per_worker}, cooperative: "
        f"{queries / wall:.0f} queries/s, total p50 / p95 / p99 "
        f"{lat['latency_ms']['p50']:.3f} / {lat['latency_ms']['p95']:.3f} "
        f"/ {lat['latency_ms']['p99']:.3f} ms; == unbatched "
        f"Extender.assign bit for bit; labels against the two-pass plain "
        f"extension by the near-tie rule")

    # A store of its own: a fleet names its replicas w0, w1, ..., the
    # owners of their pins, so a second fleet on the first one's store
    # would release the first one's pins when it stops.
    own = VersionStore(str(store.root.parent / "hash"))
    own.publish(model)
    hashed = Fleet(own, n_workers=FLEET_WORKERS, routing="hash",
                   device=DEVICE, **FLEET_KW)
    tally(lambda: [w.scheduler().batcher.warm(ALL_BUCKETS)
                   for w in hashed.workers])
    keys = [f"session-{i}" for i in range(FLEET_KEYS)]
    rounds = [tally(lambda: fleet_serve(hashed, reqs[:FLEET_KEYS], keys))
              for _ in range(2)]
    hashed.stop()
    released(own)
    if rounds[0][1] != rounds[1][1]:
        raise AssertionError("a hash-routed key changed replicas")
    for ans, _ in rounds:
        same_answers("a hash-routed request", ans, want[:FLEET_KEYS])
    info["hash_keys_per_worker"] = {w: rounds[0][1].count(w)
                                    for w in sorted(set(rounds[0][1]))}
    log(f"[fleet] hash routing: {FLEET_KEYS} keys sent twice landed on the "
        f"same replica both times {info['hash_keys_per_worker']}")
    return fleet, info


def fleet_rollouts(model, fleet, reqs, want, tally) -> dict:
    """10b, 10c: pins spare v1 from GC; a canary rollout to v2 (centroid
    rows reversed) with requests pending, then a breached rollout to v3
    that rolls back to v2."""
    store = fleet.store
    v1 = fleet.workers[0].version
    v2 = store.publish(model._replace(
        centroids=model.centroids.flip(0).contiguous()))
    removed = store.gc(keep=1)
    if removed or store.versions() != [v1, v2] or \
            store.pins(v1) != sorted(w.worker_id for w in fleet.workers):
        raise AssertionError(f"gc(keep=1) under the replicas' pins removed "
                             f"{removed}, left {store.versions()}, pins "
                             f"{store.pins(v1)}")
    held = reqs[:SWAP_PENDING]

    def promote():
        pending = [fleet.submit(r) for r in held]
        report = fleet.rollout(v2)
        fleet.flush()
        return pending, report

    pending, promote_rep = tally(promote)
    stranded = sum(not f.done() for f in pending)
    if not promote_rep.promoted or stranded or any(
            w.version != v2 for w in fleet.workers):
        raise AssertionError(f"the rollout to v{v2}: {promote_rep}, "
                             f"{stranded} stranded")
    same_answers("a request pending across the rollout",
                 [f.result(timeout=0) for f in pending], want[:SWAP_PENDING])
    later = tally(lambda: fleet_serve(fleet, held))[0]
    for got, old in zip(later, want):
        if not np.array_equal(got[0], K - 1 - old[0]):
            raise AssertionError("a later request was not served by v2")

    v3 = store.publish(model)

    def breach():
        pending = [fleet.submit(r) for r in held]
        report = fleet.rollout(v3, probe=lambda w: float("inf"))
        fleet.flush()
        return pending, report

    pending, rollback_rep = tally(breach)
    stranded_rb = sum(not f.done() for f in pending)
    if rollback_rep.state != "rolled-back" or stranded_rb or any(
            w.version != v2 for w in fleet.workers):
        raise AssertionError(f"the breached rollout to v{v3}: "
                             f"{rollback_rep}, {stranded_rb} stranded")
    for f, old in zip(pending, want):
        if not np.array_equal(f.result(timeout=0)[0], K - 1 - old[0]):
            raise AssertionError("a request pending across the rollback "
                                 "was not served by v2")
    for name, rep in (("promote", promote_rep), ("rollback", rollback_rep)):
        log(f"[fleet] rollout {name} to v{rep.version}: state {rep.state}, "
            f"canary {rep.canary_id} p95 {rep.canary_p95_ms:.3f} ms "
            f"(budget {rep.budget_ms} ms), timeline " + ", ".join(
                f"{st} {t:.4f} s" for st, t in rep.timeline)
            + f", wall {rep.wall_s:.4f} s, flips ms " + ", ".join(
                f"{k} {v['flip_ms']:.4f}" for k, v in rep.swaps.items()))
    log(f"[fleet] gc(keep=1) under the replicas' pins left v{v1}, v{v2}; "
        f"0 stranded futures across the promote and the rollback; "
        f"requests pending at the promote answered by v{v1} bit for bit, "
        f"later ones labelled k - 1 - old by v{v2}; every replica on "
        f"v{v2} after the rollback")
    return {"gc_keep_1_under_pins": [v1, v2],
            "promote": promote_rep.to_dict(),
            "rollback": rollback_rep.to_dict(), "stranded_futures": 0}


def fleet_overload(store, reqs, tally) -> dict:
    """10d: the requests flooded past a per-worker cap, control() every
    32 and no polls between."""
    from repro_torch.fleet import Fleet, ShedError
    fleet = Fleet(store, n_workers=FLEET_WORKERS,
                  max_queue_depth=OVERLOAD_DEPTH, device=DEVICE,
                  **FLEET_KW)
    tally(lambda: [w.scheduler().batcher.warm(ALL_BUCKETS)
                   for w in fleet.workers])

    def flood():
        futs, shed, breaker = [], 0, False
        for i, r in enumerate(reqs):
            try:
                futs.append(fleet.submit(r))
            except ShedError:
                shed += 1
            if (i + 1) % 32 == 0:
                breaker = fleet.control()["breaker_open"] or breaker
        fleet.flush()
        return [f.result(timeout=0) for f in futs], shed, breaker

    admitted, shed, breaker = tally(flood)
    p99 = fleet.latency().total.percentile(99.0)
    adm = fleet.admission.summary()
    fleet.stop()
    if shed == 0 or p99 > fleet.slo_ms:
        raise AssertionError(f"overload: shed {shed}, admitted p99 {p99} ms")
    log(f"[fleet] overload at {OVERLOAD_DEPTH} columns per replica: "
        f"{len(reqs)} offered, {len(admitted)} admitted, {shed} shed "
        f"{adm['shed_by_reason']}, admitted p99 {p99:.3f} ms (SLO "
        f"{fleet.slo_ms} ms), breaker opened: {breaker}")
    return {"offered": len(reqs), "admitted": len(admitted), "shed": shed,
            "shed_by_reason": adm["shed_by_reason"],
            "admitted_p99_ms": p99, "breaker_opened": breaker}


def phase_fleet(torch, model, Xq) -> tuple:
    """Phase 10: phase 4's model served by a fleet of replicas on the card
    from a VersionStore under build/: routing and answers, pins against
    GC, canary rollout and rollback, overload (all cooperative: launches
    counted); then benchmark_fleet with live pumps (not counted)."""
    from repro_torch.fleet import benchmark_fleet
    from repro_torch.serve import ComputePolicy, Extender, VersionStore
    t_phase = time.perf_counter()
    tally = LaunchTally(torch)
    reqs = held_out_requests(Xq)
    unbatched = Extender(model, policy=ComputePolicy())
    want = [tuple(x.cpu().numpy() for x in unbatched.assign(
        torch.from_numpy(r).to(model.device))) for r in reqs]
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    store = VersionStore(str(pathlib.Path(work.name) / "versions"))
    store.publish(model)
    fleet, info = fleet_answers(torch, model, store, reqs, want, tally)
    info["rollout"] = fleet_rollouts(model, fleet, reqs, want, tally)
    fleet.stop()
    released(store)
    info["overload"] = fleet_overload(store, reqs, tally)
    released(store)
    work.cleanup()

    t0 = time.perf_counter()
    bench = benchmark_fleet(model, worker_counts=FLEET_SWEEP,
                            n_requests=FLEET_BENCH_REQUESTS, seed=SEED,
                            device=DEVICE, **FLEET_KW)
    bench["wall_s"] = time.perf_counter() - t0
    for row in bench["sweep"]:
        log(f"[fleet] benchmark_fleet, {row['workers']} replica(s), pumps "
            f"live: {row['queries_per_sec']:.0f} queries/s, p50 / p95 / p99 "
            f"{row['p50_ms']:.3f} / {row['p95_ms']:.3f} / "
            f"{row['p99_ms']:.3f} ms, SLO violations "
            f"{row['slo_violations']}")
    ov, ro = bench["overload"], bench["rollout"]
    log(f"[fleet] benchmark_fleet: qps_vs_1_worker "
        f"{bench['scaling']['qps_vs_1_worker']:.3f} at "
        f"{bench['scaling']['workers_max']} replicas (not gated); overload "
        f"{ov['offered']} offered, {ov['shed']} shed {ov['shed_by_reason']}"
        f", admitted p99 {ov['admitted_p99_ms']:.3f} ms, breaker "
        f"{ov['breaker_opened']}; promote {ro['promote_s']:.4f} s, rollback "
        f"{ro['rollback']['state']}, stranded {ro['stranded_futures']}; "
        f"{bench['wall_s']:.2f} s")
    info["benchmark_fleet"] = bench
    if tally.launches["embed_assign"] == 0:
        raise AssertionError("phase 10 never launched embed_assign")
    info["launches"] = tally.launches
    info["phase_s"] = time.perf_counter() - t_phase
    log(f"[fleet] launches {tally.launches}; phase 10 took "
        f"{info['phase_s']:.2f} s")
    return tally.launches, info


# -- phase 13: the decoder-only LM serving path -------------------------------

def lm_weights(torch, cfg) -> dict:
    """Bytes of the model's weights at tp = 1 (from a model on the meta
    device: shapes and dtypes, no memory; `shapes` its meta parameters),
    of its embedding table and of
    an encoder-decoder's encoder (`enc_layers`, `enc_ln`) and its decoder
    layers' cross-attention wk and wv, whose products the cache holds (0
    for the others)."""
    from repro_torch.models import get_api
    model = get_api(cfg).init(cfg, tp=1, device="meta")

    def nbytes(params):
        return sum(p.numel() * p.element_size() for p in params)
    enc = [p for name in ("enc_layers", "enc_ln")
           for p in getattr(model, name, torch.nn.Module()).parameters()]
    xkv = [p for blk in getattr(model, "dec_layers", ())
           for p in (blk.xattn.wk, blk.xattn.wv)]
    return {"bytes": nbytes(model.parameters()),
            "shapes": list(model.parameters()),
            "embed_bytes": nbytes([model.embed]),
            "encoder_bytes": nbytes(enc),
            "encoder_params": sum(p.numel() for p in enc),
            "cross_kv_weight_bytes": nbytes(xkv),
            "row_bytes": model.embed.element_size() * cfg.d_model,
            "params": sum(p.numel() for p in model.parameters())}


def lm_bounds(torch, cfg, B, S, max_seq) -> dict:
    """The least time of one prefill of S tokens and of one decode step
    against a cache for max_seq positions (T slots: min(max_seq, window)
    under a sliding window), batch B, from the config's shapes.

    Flops: every projection on the tokens it sees (an MoE's experts on
    the E x C tokens capacity routing gives them, per group of B x S
    tokens in prefill and of B in decode), the causal attention's QK and
    PV over the pairs inside the window (decode: over all T slots, as it
    runs), the unembedding of the last position only; the embedding is a
    gather. Over 989 TFLOP/s bf16. An ssm's RWKV layer (models/rwkv6.py)
    has no attention: its six d x d products, W_a (d x 64) and the channel
    mix's two d x f in bf16; over 67 TFLOP/s f32 the LoRA's @ W_b and the
    WKV core's four products a chunk of Lc = min(rwkv_chunk, S) tokens
    (the scores and scores @ v over the causal pairs j < t only, each
    chunk's k^T v and r @ state; decode: Lc = 1, no pairs); its decay,
    shifts and gates (~10^2 elementwise flops a channel a token) are left
    out. A hybrid's R layer (models/rglru.py)
    projects through its five d x d matrices and its MLP and does not
    attend; against the f32 cache its decode runs u @ W_a and u @ W_x in
    f32 (JAX's promotion), over 67 TFLOP/s. Its conv, gates and scan
    (~10^2 elementwise flops a channel a token, under 0.1 % of its
    projections) are left out. An encoder-decoder (models/whisper.py)
    adds its encoder, every projection on B x F frames and the
    non-causal attention over F x F pairs, and each decoder layer's
    cross-attention: Q and O on the B x S tokens, K and V on the B x F
    frames, QK and PV over S x F pairs (decode: Q, O on B tokens, QK and
    PV over F). Bytes: the weights read once (of the embedding only the
    rows gathered; decode reads neither the encoder's weights nor the
    cross-attention's wk and wv, only their products), the f32 KV cache
    written (prefill) or read over all T slots (decode), an
    encoder-decoder's f32 cross K/V written (prefill) or read (decode),
    and an R layer's f32 h and conv state, or an RWKV layer's f32 s (H x
    dh x dh), tm and cm, written (prefill) or read and written (decode),
    over 3.35 TB/s. Also the coarser prefill bound 2 x parameters x the
    tokens they see (B x S; an encoder's B x F) + attention.

    The train step on B sequences of S tokens (phase 17): its products'
    flops, 3 x the forward's on every position (forward, and the
    backward's two products a forward product; the unembedding on all B
    x S positions; no recompute counted; the embedding a gather) over
    989 TFLOP/s bf16, plus the optimizer's bytes over 3.35 TB/s: each
    parameter read and written, m and v read and written in their dtype,
    the gradient read (f32 with cfg.microbatches > 1, else the
    parameter's dtype). The two run one after the other, so their times
    add."""
    w = lm_weights(torch, cfg)
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    L_, V = cfg.n_layers, cfg.vocab_padded(1)
    n_r = cfg._pattern().count("R") if cfg.family == "hybrid" else 0
    n_s = L_ if cfg.family == "ssm" else 0
    n_a = L_ - n_r - n_s
    n_e = cfg.n_encoder_layers if cfg.family == "encdec" else 0
    n_x = L_ if n_e else 0                   # decoder layers that cross
    F = cfg.n_audio_frames
    dh = cfg.rwkv_head_dim
    attn_params = d * hd * (nq + 2 * nkv) + nq * hd * d
    mlp_params = (3 if cfg.activation in ("swiglu", "geglu") else 2) \
        * d * cfg.d_ff
    win = cfg.window if cfg.attention == "sliding" else 0
    T = min(max_seq, win) if win else max_seq

    def layer_flops(tokens):
        """A layer's projections on `tokens` tokens routed as one group."""
        if not cfg.n_experts:
            return 2 * tokens * (attn_params + mlp_params)
        C = max(1, int(cfg.top_k * tokens * 1.25 / cfg.n_experts))
        return 2 * tokens * (attn_params + d * cfg.n_experts) \
            + 2 * cfg.n_experts * C * mlp_params

    def r_flops(tokens, f32):
        """An R layer's bf16 projections (f32: u @ W_a, u @ W_x apart)."""
        return 2 * tokens * ((3 if f32 else 5) * d * d + mlp_params)

    def s_flops(seqs, length):
        """An RWKV layer on `seqs` sequences of `length` tokens: (bf16
        flops, f32 flops)."""
        tokens, Lc = seqs * length, min(cfg.rwkv_chunk, length)
        pairs = seqs * (length // Lc) * Lc * (Lc - 1) // 2
        return (2 * tokens * (6 * d * d + 64 * d + 2 * d * cfg.d_ff),
                2 * tokens * 64 * d + 2 * 2 * pairs * d
                + 2 * 2 * tokens * dh * d)

    pairs = sum(min(i + 1, win) if win else i + 1 for i in range(S))
    attn_flops = 2 * 2 * B * nq * hd * pairs
    pre_s, pre_s_f32 = s_flops(B, S)
    dec_s, dec_s_f32 = s_flops(B, 1)
    enc_attn_flops = 2 * 2 * B * nq * hd * F * F
    enc_flops = n_e * (layer_flops(B * F) + enc_attn_flops)
    xq_params, xkv_params = 2 * d * nq * hd, 2 * d * nkv * hd
    x_pre = n_x * (2 * B * S * xq_params + 2 * B * F * xkv_params
                   + 2 * 2 * B * nq * hd * S * F)
    x_dec = n_x * (2 * B * xq_params + 2 * 2 * B * nq * hd * F)
    prefill_flops = n_a * (layer_flops(B * S) + attn_flops) \
        + n_r * r_flops(B * S, False) + n_s * pre_s + enc_flops + x_pre \
        + 2 * B * d * V
    pre_f32_flops = n_s * pre_s_f32
    dec_flops = n_a * (layer_flops(B) + 2 * 2 * B * nq * hd * T) \
        + n_r * r_flops(B, True) + n_s * dec_s + x_dec + 2 * B * d * V
    dec_f32_flops = n_r * 2 * B * 2 * d * d + n_s * dec_s_f32
    cache_bytes = 2 * n_a * B * T * nkv * hd * 4
    cross_bytes = 2 * n_x * B * F * nkv * hd * 4
    state_bytes = (n_r * B * 4 * d * 4              # h (d) and conv (3 d)
                   + n_s * B * (d * dh + 2 * d) * 4)  # s, tm and cm
    weights = w["bytes"] - w["embed_bytes"]
    pre_bytes = weights + B * S * w["row_bytes"] + cache_bytes \
        + cross_bytes + state_bytes
    dec_bytes = weights - w["encoder_bytes"] - w["cross_kv_weight_bytes"] \
        + B * w["row_bytes"] \
        + cache_bytes + cross_bytes + 2 * state_bytes
    coarse = 2 * (w["params"] - w["encoder_params"]) * B * S \
        + 2 * w["encoder_params"] * B * F + n_a * attn_flops \
        + n_e * enc_attn_flops

    def bound(flops, nbytes, f32_flops=0):
        t_ops = flops / BF16_FLOPS + f32_flops / FP32_FLOPS
        t_bytes = nbytes / HBM_BYTES_PER_S
        return max(t_ops, t_bytes) * 1e3, ("operations" if t_ops >= t_bytes
                                           else "bytes")
    pre_ms, pre_by = bound(prefill_flops, pre_bytes, pre_f32_flops)
    dec_ms, dec_by = bound(dec_flops, dec_bytes, dec_f32_flops)
    train_flops = 3 * (prefill_flops + 2 * B * (S - 1) * d * V)
    train_f32_flops = 3 * pre_f32_flops
    mom = 4 if cfg.optimizer_dtype == "float32" else 2
    opt_bytes = sum(p.numel() * (2 * p.element_size() + 4 * mom + (
        4 if cfg.microbatches > 1 else p.element_size()))
        for p in w["shapes"])
    t_train_ops = train_flops / BF16_FLOPS + train_f32_flops / FP32_FLOPS
    t_opt = opt_bytes / HBM_BYTES_PER_S
    return {"params": w["params"], "weight_bytes": w["bytes"],
            "train_flops": train_flops, "train_f32_flops": train_f32_flops,
            "train_attention_flops": 3 * n_a * attn_flops,
            "optimizer_bytes": opt_bytes,
            "train_products_ms": t_train_ops * 1e3,
            "train_optimizer_ms": t_opt * 1e3,
            "train_bound_ms": (t_train_ops + t_opt) * 1e3,
            "cache_slots": T, "kv_cache_bytes": cache_bytes,
            "cross_cache_bytes": cross_bytes, "state_bytes": state_bytes,
            "encoder_flops": enc_flops,
            "state_what": "s, tm and cm" if n_s else "h and conv state",
            "prefill_flops": prefill_flops,
            "prefill_f32_flops": pre_f32_flops, "prefill_bytes": pre_bytes,
            "prefill_bound_ms": pre_ms, "prefill_bound_by": pre_by,
            "prefill_2NBS_bound_ms": coarse / BF16_FLOPS * 1e3,
            "decode_flops": dec_flops, "decode_f32_flops": dec_f32_flops,
            "decode_bytes": dec_bytes,
            "decode_bound_ms": dec_ms, "decode_bound_by": dec_by}


def lm_launcher(torch, smi, arch=LM_ARCH, args=None, tag="13a") -> dict:
    """13a / 14a / 15a / 16a: `python -m repro_torch.launch.serve
    --no-smoke` on `arch` (phi4 / recurrentgemma / rwkv6 / whisper) at
    full width and depth as a process, with `args` (LM_SERVE / HY_SERVE /
    SSM_SERVE / ED_SERVE); it must exit 0 (it checks its logits are
    finite). Returns its numbers beside their bounds."""
    import os
    args = LM_SERVE if args is None else args
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cmd = [sys.executable, "-m", "repro_torch.launch.serve"] + args + [
        "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0:
        raise AssertionError(f"repro_torch.launch.serve exited "
                             f"{proc.returncode}:\n{proc.stdout[-2000:]}\n"
                             f"{proc.stderr[-3000:]}")
    head = re.search(r"prefill (\d+) tok in ([\d.]+) ms; (\d+) decode steps "
                     r"in ([\d.]+) ms \(([\d.]+) ms/step", lines[0])
    tail = re.search(r"decode ([\d.]+) tokens/s; peak device memory "
                     r"([\d.]+ GB|not measured)", lines[2])
    if not (head and tail and lines[1].startswith("generated token ids")):
        raise AssertionError(f"unexpected launcher output: {lines}")
    cfg = get_lm_config(arch)
    b = lm_bounds(torch, cfg, LM_B, LM_S, LM_MAX_SEQ)
    info = {"cmd": "python -m repro_torch.launch.serve " + " ".join(
                args), "process_s": seconds,
            "prefill_ms": float(head.group(2)),
            "decode_ms_per_step": float(head.group(5)),
            "tokens_per_s": float(tail.group(1)),
            "peak_memory": tail.group(2), "lines": lines, **b}
    log(f"[lm] {tag} {info['cmd']}: exit 0 in {seconds:.1f} s [{smi}]: "
        + " | ".join(lines))
    state = [f"f32 KV cache of {b['cache_slots']} slots "
             f"{b['kv_cache_bytes'] / 1e9:.4f} GB"] if b["kv_cache_bytes"] \
        else []
    if b["cross_cache_bytes"]:
        state.append(f"f32 cross K/V over {cfg.n_audio_frames} frames "
                     f"{b['cross_cache_bytes'] / 1e9:.4f} GB")
    if b["state_bytes"]:
        state.append(f"f32 {b['state_what']} {b['state_bytes'] / 1e9:.4f} GB")
    depth = (f"{cfg.n_encoder_layers} + {cfg.n_layers}"
             if cfg.family == "encdec" else f"{cfg.n_layers}")
    log(f"[lm] {tag} {arch} full width and depth ({depth} layers, "
        f"{b['params']:,} parameters, {b['weight_bytes'] / 1e9:.3f} GB; "
        f"{', '.join(state)}) [{smi}]: prefill "
        f"{info['prefill_ms']} ms (its first call; flops bound "
        f"{b['prefill_bound_ms']:.3f} ms by {b['prefill_bound_by']}, "
        f"2NBS {b['prefill_2NBS_bound_ms']:.3f}); decode "
        f"{info['decode_ms_per_step']} ms/step (bytes bound "
        f"{b['decode_bound_ms']:.3f} ms: {b['decode_bytes'] / 1e9:.3f} GB "
        f"over 3.35 TB/s), {info['tokens_per_s']} tokens/s; peak memory "
        f"{info['peak_memory']}")
    return info


def get_lm_config(arch, **cut):
    import dataclasses
    from repro_torch.configs import get_config
    cfg = get_config(arch)
    return dataclasses.replace(cfg, **cut) if cut else cfg


def near_ties(torch, got, want) -> dict:
    """Greedy agreement of two sets of logit rows: how many argmaxes are
    equal, and the largest gap between want's max and want at got's
    argmax (0 where they agree)."""
    pick = got.argmax(-1)
    gap = want.max(-1).values - want.gather(-1, pick[:, None])[:, 0]
    return {"argmax_equal": int((pick == want.argmax(-1)).sum()),
            "rows": int(pick.numel()), "worst_gap": float(gap.max())}


def decode_roundings(cfg, steps: int = 1) -> int:
    """The bf16 roundings in which the last of `steps` decode steps may
    part from the forward. A recurrent layer carries every rounding of
    every step on in its state (h, the conv's inputs, s, tm, cm):
    HY_R_ROUNDINGS an R layer, RWKV_ROUNDINGS an RWKV layer, each step. An
    attention layer rounds its own LM_ROUNDINGS (ENCDEC_ROUNDINGS with
    cross-attention) once, and of each earlier step only the k and v that
    step left in the KV cache or ring reach this one: 2 a step."""
    n_r = cfg._pattern().count("R") if cfg.family == "hybrid" else 0
    n_s = cfg.n_layers if cfg.family == "ssm" else 0
    n_a = cfg.n_layers - n_r - n_s
    attn = ENCDEC_ROUNDINGS if cfg.family == "encdec" else LM_ROUNDINGS
    return steps * (HY_R_ROUNDINGS * n_r + RWKV_ROUNDINGS * n_s) \
        + n_a * (attn + 2 * (steps - 1))


def bf16_tol(kind: str, roundings: int, scale: float) -> float:
    """The bf16 tolerance for values of largest magnitude `scale`:
    LM_PREFILL_ULPS ulps (prefill), or a random walk of `roundings` steps
    of 2^-8 (decode; decode_roundings)."""
    if kind == "prefill":
        return LM_PREFILL_ULPS * 2.0 ** (math.floor(math.log2(scale)) - 7)
    return math.sqrt(roundings) * 2.0 ** -8 * scale


def hold_logits(torch, what, got, want, kind, roundings, f32,
                say=True) -> dict:
    """got against want within LM_F32_TOL (f32) or bf16_tol; the greedy
    tokens equal (f32), or any that differ a near tie within the
    tolerance (bf16). Logged unless `say` is False."""
    err = float((got - want).abs().max())
    scale = float(want.abs().max())
    tol = LM_F32_TOL if f32 else bf16_tol(kind, roundings, scale)
    res = {"max_abs_err": err, "tol": tol, "ref_max_abs": scale,
           **near_ties(torch, got, want)}
    if say:
        log(f"[lm] {what}: max abs err {err:.3g} (tol {tol:.3g}, |logits| "
            f"<= {res['ref_max_abs']:.3g}); argmax equal "
            f"{res['argmax_equal']}/{res['rows']}, worst gap "
            f"{res['worst_gap']:.3g}")
    if not err <= tol:
        raise AssertionError(f"{what}: {err} > {tol}")
    if f32 and res["argmax_equal"] != res["rows"]:
        raise AssertionError(f"{what}: greedy tokens differ: {res}")
    if res["worst_gap"] > tol:
        raise AssertionError(f"{what}: a greedy token differs past a tie: "
                             f"{res}")
    return res


def lm_invariants(torch, model, tokens, decode_too=True, what="") -> dict:
    """prefill(S) against forward(S)[:, -1]; one decode after it against
    forward(S + 1)[:, -1] (where decode_too). tokens: (B, S + 1)."""
    S = tokens.shape[1] - 1
    f32 = model.cfg.param_dtype == "float32"
    out = {}
    with torch.no_grad():
        cache = model.init_cache(tokens.shape[0], S + 1, torch.float32)
        logits, cache = model.prefill(tokens[:, :S], cache)
        out["prefill"] = hold_logits(
            torch, f"{what} prefill({S}) vs forward({S})[:, -1]", logits,
            model(tokens[:, :S])[:, -1], "prefill", 0, f32)
        if decode_too:
            logits, cache = model.decode(tokens[:, S], cache)
            out["decode"] = hold_logits(
                torch, f"{what} decode after prefill({S}) vs "
                f"forward({S + 1})[:, -1]", logits, model(tokens)[:, -1],
                "decode", decode_roundings(model.cfg), f32)
    return out


def lm_times(torch, model, tokens, gen, max_seq, frames=None) -> dict:
    """Warm prefill ms and decode ms/step (host clock, synchronized; a
    prefill and two decode steps first), tokens/s of the decode. `frames`:
    an encoder-decoder's, handed to its prefill."""
    B = tokens.shape[0]
    extra = () if frames is None else (frames,)
    with torch.no_grad():
        cache = model.init_cache(B, max_seq, torch.float32)
        logits, cache = model.prefill(tokens, *extra, cache)  # warm-up
        for _ in range(2):
            logits, cache = model.decode(logits.argmax(-1), cache)
        cache = model.init_cache(B, max_seq, torch.float32)
        (logits, cache), t_pre = timed(
            torch, lambda: model.prefill(tokens, *extra, cache))
        nxt = logits.argmax(-1).to(torch.int32)

        def steps():
            nonlocal nxt, cache
            for _ in range(gen):
                logits, cache = model.decode(nxt, cache)
                nxt = logits.argmax(-1).to(torch.int32)
            return logits
        logits, t_dec = timed(torch, steps)
    if not bool(torch.isfinite(logits).all()):
        raise AssertionError("non-finite logits")
    return {"prefill_ms": t_pre * 1e3, "decode_ms_per_step":
            t_dec / gen * 1e3, "tokens_per_s": B * gen / t_dec}


def lm_decode_profile(torch, model, tokens, max_seq, steps=4,
                      frames=None) -> dict:
    """`steps` warm decode steps under torch.profiler: host and card ms a
    step, the card's busy share, and the kernels that take most of it."""
    extra = () if frames is None else (frames,)
    with torch.no_grad():
        cache = model.init_cache(tokens.shape[0], max_seq, torch.float32)
        logits, cache = model.prefill(tokens, *extra, cache)
        state = {"nxt": logits.argmax(-1), "cache": cache}

        def step():
            logits, state["cache"] = model.decode(state["nxt"],
                                                  state["cache"])
            state["nxt"] = logits.argmax(-1)
        step()
        sync(torch)
        host_ms, device = profiled(torch, lambda: [step() for _ in
                                                   range(steps)])
    busy = sum(ms for _, ms in device.values())
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:6]
    return {"host_ms_per_step": host_ms / steps,
            "device_ms_per_step": busy / steps,
            "busy_share": busy / host_ms if busy else None,
            "launches_per_step": sum(n for n, _ in device.values()) / steps,
            "top": [{"kernel": k[:90], "ms_per_step": ms / steps,
                     "calls_per_step": n / steps} for k, (n, ms) in top]}


def lm_tokens(torch, cfg, B, S, seed):
    gen = torch.Generator(DEVICE).manual_seed(seed)
    return torch.randint(0, cfg.vocab_size, (B, S), generator=gen,
                         device=DEVICE, dtype=torch.int32)


def lm_frames(torch, cfg, B):
    """An encoder-decoder's audio frames (B, n_audio_frames, d), drawn on
    the card from SEED + 2 in f32 and cast to cfg.dtype; None for the
    other families."""
    if cfg.family != "encdec":
        return None
    gen = torch.Generator(DEVICE).manual_seed(SEED + 2)
    return torch.randn((B, cfg.n_audio_frames, cfg.d_model), generator=gen,
                       device=DEVICE).to(getattr(torch, cfg.dtype))


def lm_model(torch, cfg, seed=SEED):
    """The family's model (LM, RG, RWKV or Whisper) through get_api."""
    from repro_torch.models import get_api
    return get_api(cfg).init(
        cfg, tp=1, device=DEVICE,
        generator=torch.Generator(DEVICE).manual_seed(seed))


def free(torch) -> None:
    import gc
    gc.collect()
    if DEVICE == "cuda":
        torch.cuda.empty_cache()


def lm_in_process(torch, smi, arch=LM_ARCH, cut_depth=LM_CUT_DEPTH,
                  tag="13b", ring=False, checks=None, after=1) -> dict:
    """13b / 14b / 15b / 16b: `arch` at full width and depth in bf16 held
    to its own invariants and timed warm; the same checks in f32 at depth
    `cut_depth` (an encoder-decoder's encoder too). The invariants are
    `checks(torch, model, tokens, what=)` (lm_invariants by default) on
    LM_S + `after` tokens, with `frames=` (lm_frames) for an
    encoder-decoder. With `ring`, also the ring past the window (hy_ring)
    in both."""
    checks = checks or lm_invariants
    cfg = get_lm_config(arch)
    info = {}
    if DEVICE == "cuda":
        torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    model = lm_model(torch, cfg)
    sync(torch)
    info["init_s"] = time.perf_counter() - t0
    tokens = lm_tokens(torch, cfg, LM_B, LM_S + after, SEED + 1)
    frames = lm_frames(torch, cfg, LM_B)
    extra = {} if frames is None else {"frames": frames}
    info["bf16"] = checks(torch, model, tokens, what=f"{tag} {arch} bf16",
                          **extra)
    info.update(lm_times(torch, model, tokens[:, :LM_S], LM_GEN,
                         LM_MAX_SEQ, frames))
    if DEVICE == "cuda":
        info["peak_gb"] = torch.cuda.max_memory_allocated() / 1e9
    info["decode_profile"] = prof = lm_decode_profile(
        torch, model, tokens[:, :LM_S], LM_MAX_SEQ, frames=frames)
    b = lm_bounds(torch, cfg, LM_B, LM_S, LM_MAX_SEQ)
    peak = (f"{info['peak_gb']:.3f} GB" if "peak_gb" in info
            else "not measured")
    log(f"[lm] {tag} {arch} in process, warm [{smi}]: init "
        f"{info['init_s']:.2f} s; prefill "
        f"{info['prefill_ms']:.2f} ms (flops bound "
        f"{b['prefill_bound_ms']:.3f}); decode "
        f"{info['decode_ms_per_step']:.3f} ms/step (bytes bound "
        f"{b['decode_bound_ms']:.3f}), {info['tokens_per_s']:.1f} tokens/s;"
        f" peak memory {peak} (the forward checks' f32 logits included); a "
        f"decode step under the profiler: "
        f"host {prof['host_ms_per_step']:.3f} ms, card "
        f"{prof['device_ms_per_step']:.3f} ms (busy share "
        f"{prof['busy_share']}), {prof['launches_per_step']:.0f} records; "
        f"most card time: {json.dumps(prof['top'])}")
    if ring:
        info["bf16_ring"] = hy_ring(torch, model, f"{tag} {arch} bf16")
    del model
    free(torch)
    depth = {"n_layers": cut_depth}
    if cfg.family == "encdec":
        depth["n_encoder_layers"] = cut_depth
    cut = get_lm_config(arch, **depth, param_dtype="float32",
                        dtype="float32")
    model = lm_model(torch, cut)
    frames = lm_frames(torch, cut, LM_B)
    extra = {} if frames is None else {"frames": frames}
    what = f"{tag} {arch} f32 depth {cut_depth}"
    info[f"f32_depth{cut_depth}"] = checks(torch, model, tokens, what=what,
                                           **extra)
    if ring:
        info[f"f32_depth{cut_depth}_ring"] = hy_ring(torch, model, what)
    del model
    free(torch)
    return info


def hy_ring(torch, model, what) -> dict:
    """The hybrid's local attention past its window: batch 1, a prompt of
    HY_RING_S > window tokens into a cache for HY_RING_S + HY_RING_STEPS
    positions (T = window ring slots: prefill keeps the last T positions
    rolled into slot p % T, rglru.py:241-253), prefill(HY_RING_S) ==
    forward(HY_RING_S)[:, -1], then HY_RING_STEPS decode steps, step k
    against forward(HY_RING_S + HY_RING_STEPS) at its position within the
    tolerance of k steps (decode_roundings)."""
    cfg = model.cfg
    S, steps = HY_RING_S, HY_RING_STEPS
    f32 = cfg.param_dtype == "float32"
    tokens = lm_tokens(torch, cfg, 1, S + steps, SEED + 2)
    out = {"decode": []}
    with torch.no_grad():
        cache = model.init_cache(1, S + steps, torch.float32)
        if not S > cache["k"].shape[2] == cfg.window:
            raise AssertionError(f"{what}: the ring check needs a prompt "
                                 f"past the window's {cfg.window} slots")
        logits, cache = model.prefill(tokens[:, :S], cache)
        out["prefill"] = hold_logits(
            torch, f"{what} ring: prefill({S}) vs forward({S})[:, -1]",
            logits, model(tokens[:, :S])[:, -1], "prefill", 0, f32)
        full = model(tokens)
        for k in range(steps):
            logits, cache = model.decode(tokens[:, S + k], cache)
            out["decode"].append(hold_logits(
                torch, f"{what} ring: decode step {k + 1} (position "
                f"{S + k}, {cache['k'].shape[2]} slots) vs "
                f"forward({S + steps})[:, {S + k}]", logits,
                full[:, S + k], "decode", decode_roundings(cfg, k + 1),
                f32))
    del full
    return out


def lm_others(torch, smi) -> dict:
    """13c: the six other decoder-only archs at their published widths,
    depth cut to 2, one at a time: a prefill and 8 decode steps, timed;
    prefill(S) == forward(S)[:, -1]; for the non-MoE archs also one decode
    == forward(S + 1)[:, -1] (capacity routing groups a decode step's B
    tokens apart from the forward's B x (S + 1), so an MoE drops other
    tokens: the JAX package's semantics)."""
    out = {}
    for arch in LM_OTHERS:
        cfg = get_lm_config(arch, n_layers=LM_CUT_DEPTH)
        t0 = time.perf_counter()
        model = lm_model(torch, cfg)
        sync(torch)
        init_s = time.perf_counter() - t0
        tokens = lm_tokens(torch, cfg, LM_OTHERS_B, LM_OTHERS_S + 1,
                           SEED + 1)
        res = {"reduced": f"n_layers {cfg.n_layers} of "
               f"{get_lm_config(arch).n_layers}", "init_s": init_s,
               **lm_invariants(torch, model, tokens,
                               decode_too=not cfg.n_experts,
                               what=f"13c {arch} depth {LM_CUT_DEPTH}")}
        res.update(lm_times(torch, model, tokens[:, :LM_OTHERS_S],
                            LM_OTHERS_GEN, LM_OTHERS_S + LM_OTHERS_GEN))
        b = lm_bounds(torch, cfg, LM_OTHERS_B, LM_OTHERS_S,
                      LM_OTHERS_S + LM_OTHERS_GEN)
        res.update({k: b[k] for k in ("params", "weight_bytes",
                                      "prefill_bound_ms", "decode_bound_ms")})
        log(f"[lm] 13c {arch} (published widths, depth {LM_CUT_DEPTH}: "
            f"{b['params']:,} parameters, {b['weight_bytes'] / 1e9:.2f} GB) "
            f"[{smi}]: init {init_s:.2f} s; prefill {LM_OTHERS_S} x "
            f"{LM_OTHERS_B} {res['prefill_ms']:.2f} ms (bound "
            f"{b['prefill_bound_ms']:.3f}); decode "
            f"{res['decode_ms_per_step']:.3f} ms/step (bound "
            f"{b['decode_bound_ms']:.3f})")
        out[arch] = res
        del model
        free(torch)
    out["mixtral_ring"] = lm_ring(torch, smi)
    return out


def lm_ring(torch, smi) -> dict:
    """mixtral's sliding ring at full width at the layer: one Attention
    layer prefills S = 4,100 > window 4,096 at batch 1 into a cache of
    4,096 slots (the roll of lm.py:99-102), then decodes 3 steps; each
    step's output against the windowed full-sequence forward at the same
    position, and the prefill's last position too. In f32 (the ring's
    arithmetic, tol LM_RING_TOL relative) and in bf16 (bf16_tol of one
    layer, relative)."""
    from repro_torch.models.layers import Attention
    cfg = get_lm_config("mixtral-8x7b")
    win, out = cfg.window, {}
    for dtype, tol in ((torch.float32, LM_RING_TOL),
                       (torch.bfloat16,
                        bf16_tol("decode", LM_ROUNDINGS, 1.0))):
        gen = torch.Generator(DEVICE).manual_seed(SEED)
        attn = Attention(cfg, dtype, DEVICE)
        attn.reset_parameters(gen)
        x = torch.randn((1, RING_S + RING_STEPS, cfg.d_model),
                        generator=gen, device=DEVICE).to(dtype)
        shape = (1, win, cfg.n_kv_heads, cfg.head_dim)
        kc = torch.zeros(shape, device=DEVICE)
        vc = torch.zeros(shape, device=DEVICE)
        errs = []
        with torch.no_grad():
            full = attn(x, window=win).float()
            scale = float(full[:, RING_S - 1:].abs().max())
            pre = attn.prefill(x[:, :RING_S], kc, vc, window=win)
            errs.append(float((pre[:, -1].float()
                               - full[:, RING_S - 1]).abs().max()))
            for i in range(RING_STEPS):
                pos = RING_S + i
                got = attn.decode(x[:, pos:pos + 1], kc, vc, pos, window=win)
                errs.append(float((got[:, 0].float()
                                   - full[:, pos]).abs().max()))
        rel = max(errs) / scale
        name = str(dtype).removeprefix("torch.")
        out[name] = {"max_abs_err": errs, "scale": scale, "rel_err": rel,
                     "tol": tol}
        log(f"[lm] 13c mixtral ring at full width ({name}, window {win}, "
            f"prefill {RING_S}, {RING_STEPS} decode steps): abs errs "
            f"{['%.3g' % e for e in errs]} against |out| <= {scale:.3g}: "
            f"relative {rel:.3g} (tol {tol})")
        if not rel <= tol:
            raise AssertionError(f"mixtral ring {name}: {rel} > {tol}")
        del attn, x, full
        free(torch)
    return out


def hold_state(torch, what, got, want, f32, roundings) -> dict:
    """The ssm cache `got` against `want`, key by key (s, tm, cm): in f32
    within rtol and atol SSM_STATE_TOL, in bf16 within bf16_tol of
    `roundings` of each tensor's largest |value|. `ratio` is the largest
    error over its bound (<= 1 passes)."""
    out = {}
    for key in ("s", "tm", "cm"):
        err = (got[key] - want[key]).abs()
        scale = float(want[key].abs().max())
        bound = (SSM_STATE_TOL * (1 + want[key].abs()) if f32
                 else bf16_tol("decode", roundings, scale))
        out[key] = {"max_abs_err": float(err.max()), "ref_max_abs": scale,
                    "ratio": float((err / bound).max())}
    log(f"[lm] {what}: " + "; ".join(
        f"{k} max abs err {v['max_abs_err']:.3g} (|{k}| <= "
        f"{v['ref_max_abs']:.3g}), {v['ratio']:.3g} of its bound"
        for k, v in out.items()))
    bad = [k for k, v in out.items() if not v["ratio"] <= 1]
    if bad:
        raise AssertionError(f"{what}: {bad} past the bound: {out}")
    return out


def ssm_checks(torch, model, tokens, what="") -> dict:
    """15b's invariants of an RWKV model on tokens (B, S + SSM_STEPS):
    prefill(S) against forward(S)[:, -1]; SSM_STEPS decode steps fed
    tokens S, S + 1, ... (teacher-forced), step i against
    forward(S + SSM_STEPS)[:, S + i] within the tolerance of i + 1 steps
    (decode_roundings); then the state handoff, prefill(S + SSM_STEPS)'s
    s, tm and cm against the cache those steps leave (hold_state, at
    SSM_STEPS steps' roundings in bf16)."""
    cfg = model.cfg
    B, S = tokens.shape[0], tokens.shape[1] - SSM_STEPS
    f32 = cfg.param_dtype == "float32"
    with torch.no_grad():
        cache = model.init_cache(B, S + SSM_STEPS, torch.float32)
        logits, cache = model.prefill(tokens[:, :S], cache)
        out = {"prefill": hold_logits(
            torch, f"{what} prefill({S}) vs forward({S})[:, -1]", logits,
            model(tokens[:, :S])[:, -1], "prefill", 0, f32)}
        full = model(tokens)
        steps = []
        for i in range(SSM_STEPS):
            logits, cache = model.decode(tokens[:, S + i], cache)
            steps.append(hold_logits(
                torch, f"{what} decode step {i + 1} vs forward("
                f"{S + SSM_STEPS})[:, {S + i}]", logits, full[:, S + i],
                "decode", decode_roundings(cfg, i + 1), f32, say=False))
        del full
        whole = model.init_cache(B, S + SSM_STEPS, torch.float32)
        _, whole = model.prefill(tokens, whole)
        out["handoff"] = hold_state(
            torch, f"{what} handoff: prefill({S + SSM_STEPS})'s cache vs "
            f"prefill({S}) + {SSM_STEPS} decode steps'", cache, whole, f32,
            decode_roundings(cfg, SSM_STEPS))
    out["decode"] = steps_summary(what, steps, S)
    return out


def steps_summary(what, steps, S) -> dict:
    """The teacher-forced steps' hold_logits results after a prompt of S,
    summed up and logged: each step's error and tolerance, the worst
    step's share of its tolerance, the greedy agreement."""
    n = len(steps)
    ratios = [st["max_abs_err"] / st["tol"] for st in steps]
    worst = max(range(n), key=ratios.__getitem__)
    d = {"steps": n, "max_abs_err": [st["max_abs_err"] for st in steps],
         "tol": [st["tol"] for st in steps], "worst_step": worst + 1,
         "worst_ratio": ratios[worst],
         "argmax_equal": sum(st["argmax_equal"] for st in steps),
         "rows": sum(st["rows"] for st in steps),
         "worst_gap": max(st["worst_gap"] for st in steps)}
    log(f"[lm] {what} {n} teacher-forced decode steps vs forward("
        f"{S + n}): step 1 max abs err {d['max_abs_err'][0]:.3g} "
        f"(tol {d['tol'][0]:.3g}), step {n} "
        f"{d['max_abs_err'][-1]:.3g} (tol {d['tol'][-1]:.3g}), the worst "
        f"step {d['worst_step']} at {d['worst_ratio']:.3g} of its tol; "
        f"argmax equal {d['argmax_equal']}/{d['rows']}, worst gap "
        f"{d['worst_gap']:.3g}")
    return d


def cross_kv_held(torch, model, enc, cache, what) -> int:
    """The cache's xk and xv against each decoder layer's _cross_kv of the
    encoder output `enc`, cast to the cache's dtype: the elements that
    differ, which must be none."""
    bad = 0
    for i, blk in enumerate(model.dec_layers):
        for key, t in zip(("xk", "xv"), blk.xattn.kv(enc)):
            bad += int((cache[key][i] != t.to(cache[key].dtype)).sum())
    log(f"[lm] {what}: xk and xv against _cross_kv(encode(frames)), "
        f"{bad} elements differ")
    if bad:
        raise AssertionError(f"{what}: {bad} elements of xk / xv differ")
    return bad


def encdec_checks(torch, model, tokens, what="", frames=None) -> dict:
    """16b's invariants of a Whisper model on tokens (B, S + ED_STEPS) and
    its frames: prefill(S) against forward(S)[:, -1]; the cache's xk and
    xv bit for bit each layer's _cross_kv of encode(frames)
    (cross_kv_held); ED_STEPS decode steps fed tokens S, S + 1, ...
    (teacher-forced), step i against forward(S + ED_STEPS)[:, S + i]
    within the tolerance of i + 1 steps (decode_roundings: of the earlier
    steps only the k and v each left in the self-attention cache); then
    xk and xv again, which
    the steps must leave as they were."""
    cfg = model.cfg
    B, S = tokens.shape[0], tokens.shape[1] - ED_STEPS
    f32 = cfg.param_dtype == "float32"
    with torch.no_grad():
        cache = model.init_cache(B, S + ED_STEPS, torch.float32)
        logits, cache = model.prefill(tokens[:, :S], frames, cache)
        out = {"prefill": hold_logits(
            torch, f"{what} prefill({S}) vs forward({S})[:, -1]", logits,
            model(tokens[:, :S], frames)[:, -1], "prefill", 0, f32)}
        enc = model.encode(frames)
        out["cross_after_prefill"] = cross_kv_held(
            torch, model, enc, cache, f"{what} after prefill({S})")
        full = model(tokens, frames)
        steps = []
        for i in range(ED_STEPS):
            logits, cache = model.decode(tokens[:, S + i], cache)
            steps.append(hold_logits(
                torch, f"{what} decode step {i + 1} vs forward("
                f"{S + ED_STEPS})[:, {S + i}]", logits, full[:, S + i],
                "decode", decode_roundings(cfg, i + 1), f32, say=False))
        del full
        out["cross_after_decode"] = cross_kv_held(
            torch, model, enc, cache, f"{what} after {ED_STEPS} decode steps")
    out["decode"] = steps_summary(what, steps, S)
    return out


def lm_phase(torch, number: int, parts) -> dict:
    """The frame of phases 13-17: TF32 off and bf16 GEMMs that reduce in
    f32 (as the launcher sets them), every launch count set to 0 before
    `parts()` (a dict of the phase's parts) and read after. No kernel of
    the port's lies on the LM paths (the products are torch.matmul and
    einsums), so each count must stay 0."""
    from repro_torch.kernels import OPS, reset_launches
    free(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    reset_launches()
    info = parts()
    info["kernel_launches"] = {n: op.launches for n, op in OPS.items()}
    info["phase_s"] = time.perf_counter() - t0
    log(f"[lm] phase {number} took {info['phase_s']:.1f} s; the port's "
        f"kernels launched {info['kernel_launches']} (none lies on this "
        f"path)")
    if any(info["kernel_launches"].values()):
        raise AssertionError(f"phase {number} launched a kernel of the "
                             f"port's: {info['kernel_launches']}")
    return info


def lm_mesh_world_one(torch, smi, arch=LM_ARCH, tag="13d") -> dict:
    """13d / 14d / 15d / 16d: `arch` at full width and depth (bf16, seed
    SEED; 13b's, 14b's, 15b's, 16b's model) served by the meshless steps,
    then cut for a NCCL world of one rank (made here and torn down) and
    served by the mesh's steps (make_prefill_step / make_decode_step(
    mesh=), serve_cache) on the same prompt (and whisper's frames): the
    prefill's logits, LM_MESH_STEPS greedy steps' tokens and logits, and
    every leaf of the f32 cache, bit for bit."""
    from repro_torch.distributed import tensor_parallel as TP
    from repro_torch.launch.mesh import make_debug_mesh, open_world
    from repro_torch.models import get_api
    from repro_torch.train import make_decode_step, make_prefill_step
    cfg = get_lm_config(arch)
    api = get_api(cfg)
    model = lm_model(torch, cfg)
    batch = {"tokens": lm_tokens(torch, cfg, LM_B, LM_S, SEED + 1)}
    frames = lm_frames(torch, cfg, LM_B)
    if frames is not None:
        batch["frames"] = frames

    def serve(mesh, cache):
        prefill = make_prefill_step(cfg, api, mesh=mesh)
        decode = make_decode_step(cfg, api, mesh=mesh)
        t0 = time.perf_counter()
        logits, cache = prefill(model, batch, cache)
        out = [logits]
        tok = torch.argmax(logits, dim=-1).to(torch.int32)
        for _ in range(LM_MESH_STEPS):
            tok, logits, cache = decode(model, tok, cache)
            out += [tok, logits]
        sync(torch)
        return out, cache, time.perf_counter() - t0

    plain, plain_cache, plain_s = serve(None, api.init_cache(
        cfg, LM_B, LM_MAX_SEQ, torch.float32, DEVICE))
    with open_world(DEVICE):
        mesh = make_debug_mesh(device=DEVICE)
        TP.shard_for_serving(model, mesh)
        meshed, mesh_cache, mesh_s = serve(mesh, TP.serve_cache(
            model, LM_B, LM_MAX_SEQ, torch.float32))
    leaves = [key for key, t in plain_cache.items() if torch.is_tensor(t)]
    differ = [i for i, (a, b) in enumerate(zip(plain, meshed))
              if not torch.equal(a, b)] + [
        key for key in leaves
        if not torch.equal(plain_cache[key], mesh_cache[key])]
    info = {"steps": LM_MESH_STEPS, "cache_leaves": leaves,
            "tensors_held": len(plain) + len(leaves),
            "bitwise": not differ, "meshless_s": plain_s,
            "mesh_s": mesh_s,
            "tokens": [t.tolist() for t in plain[1::2]]}
    del model, plain, meshed, plain_cache, mesh_cache, batch
    free(torch)
    log(f"[lm] {tag} {arch} (full width and depth, bf16) through the "
        f"mesh's serving steps on a NCCL world of one [{smi}]: prefill "
        f"{LM_S} x {LM_B} and {LM_MESH_STEPS} greedy steps, "
        f"{info['tensors_held']} tensors (logits, tokens, the f32 cache's "
        f"{', '.join(leaves)}) against the meshless steps: "
        f"{'bit for bit' if not differ else f'differ at {differ}'} "
        f"(meshless {plain_s:.3f} s, mesh {mesh_s:.3f} s, first use of "
        f"each)")
    if differ:
        raise AssertionError(f"{tag}: the mesh of one against the meshless "
                             f"serving steps differs at {differ}")
    return info


def phase_lm(torch, smi) -> dict:
    """Phase 13: the decoder-only LM serving path on the card (the
    projections are torch.matmul, attention plain einsums)."""
    return lm_phase(torch, 13, lambda: {
        "launcher": lm_launcher(torch, smi),
        "in_process": lm_in_process(torch, smi),
        "others": lm_others(torch, smi),
        "mesh_world_one": lm_mesh_world_one(torch, smi), "card": smi})


def phase_hybrid(torch, smi) -> dict:
    """Phase 14: the hybrid family's serving path on the card (models/
    rglru.py: RG-LRU blocks, a log-depth scan in plain PyTorch, and the
    LM path's local attention)."""
    return lm_phase(torch, 14, lambda: {
        "launcher": lm_launcher(torch, smi, HY_ARCH, HY_SERVE, "14a"),
        "in_process": lm_in_process(torch, smi, HY_ARCH, HY_CUT_DEPTH,
                                    "14b", ring=True),
        "mesh_world_one": lm_mesh_world_one(torch, smi, HY_ARCH, "14d"),
        "card": smi})


def phase_ssm(torch, smi) -> dict:
    """Phase 15: the ssm family's serving path on the card (models/
    rwkv6.py: the chunked WKV core and the token-shift mixes in plain
    PyTorch)."""
    return lm_phase(torch, 15, lambda: {
        "launcher": lm_launcher(torch, smi, SSM_ARCH, SSM_SERVE, "15a"),
        "in_process": lm_in_process(torch, smi, SSM_ARCH, SSM_CUT_DEPTH,
                                    "15b", checks=ssm_checks,
                                    after=SSM_STEPS),
        "mesh_world_one": lm_mesh_world_one(torch, smi, SSM_ARCH, "15d"),
        "card": smi})


def phase_encdec(torch, smi) -> dict:
    """Phase 16: the encoder-decoder family's serving path on the card
    (models/whisper.py: the encoder, cross-attention over its cached K/V
    and the decoder's self-attention cache, in plain PyTorch)."""
    return lm_phase(torch, 16, lambda: {
        "launcher": lm_launcher(torch, smi, ED_ARCH, ED_SERVE, "16a"),
        "in_process": lm_in_process(torch, smi, ED_ARCH, ED_CUT_DEPTH,
                                    "16b", checks=encdec_checks,
                                    after=ED_STEPS),
        "mesh_world_one": lm_mesh_world_one(torch, smi, ED_ARCH, "16d"),
        "card": smi})


# -- phase 17: the single-process training loop ------------------------------

def train_launcher(torch, smi) -> dict:
    """17a: `python -m repro_torch.launch.train` with TRAIN_RUN as a
    process; it must exit 0 (it asserts the loss fell). Its lines parsed,
    its warm step beside the step's bound."""
    import os
    env = {**os.environ, "PYTHONPATH": str(SRC)}
    cmd = [sys.executable, "-m", "repro_torch.launch.train"] + TRAIN_RUN + [
        "--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env=env, capture_output=True, text=True,
                          timeout=900, cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    lines = [ln for ln in proc.stdout.splitlines() if ln.strip()]
    if proc.returncode != 0:
        raise AssertionError(f"repro_torch.launch.train exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    steps = [re.search(r"^step +(\d+) loss ([\d.]+) gnorm ([\d.]+)", ln)
             for ln in lines]
    final = re.search(r"final loss ([\d.]+) \(start ([\d.]+)\)",
                      "\n".join(lines))
    speed = re.search(r"warm step ([\d.]+) ms over (\d+) steps, ([\d.]+) "
                      r"tokens/s; peak device memory ([\d.]+ GB|not "
                      r"measured)", lines[-1])
    if not (final and speed and any(steps)):
        raise AssertionError(f"unexpected launcher output: {lines}")
    cfg = get_lm_config(TRAIN_ARCH)
    b = lm_bounds(torch, cfg, TRAIN_B, TRAIN_S, TRAIN_S)
    info = {"cmd": "python -m repro_torch.launch.train " + " ".join(
                TRAIN_RUN), "process_s": seconds, "lines": lines,
            "first_loss": float(final.group(2)),
            "final_loss": float(final.group(1)),
            "step_losses": {int(m.group(1)): float(m.group(2))
                            for m in steps if m},
            "warm_ms": float(speed.group(1)),
            "tokens_per_s": float(speed.group(3)),
            "peak_memory": speed.group(4),
            **{k: b[k] for k in ("params", "train_flops",
                                 "train_attention_flops", "optimizer_bytes",
                                 "train_products_ms", "train_optimizer_ms",
                                 "train_bound_ms")}}
    if not info["final_loss"] < info["first_loss"]:
        raise AssertionError(f"17a: the loss did not fall: {lines}")
    log(f"[train] 17a {info['cmd']}: exit 0 in {seconds:.1f} s [{smi}]: "
        + " | ".join(lines))
    log(f"[train] 17a {TRAIN_ARCH} full width and depth ({cfg.n_layers} "
        f"layers, {b['params']:,} parameters; M {cfg.microbatches}, remat "
        f"{cfg.remat}, moments {cfg.optimizer_dtype}) [{smi}]: loss "
        f"{info['first_loss']} -> {info['final_loss']}; warm step "
        f"{info['warm_ms']} ms against its bound {b['train_bound_ms']:.2f}"
        f" ms ({b['train_flops'] / 1e12:.2f} TFLOP over 989 TFLOP/s, "
        f"{b['train_products_ms']:.2f} ms, + {b['optimizer_bytes'] / 1e9:.2f}"
        f" GB of AdamW over 3.35 TB/s, {b['train_optimizer_ms']:.2f} ms; "
        f"{info['warm_ms'] / b['train_bound_ms']:.2f}x); "
        f"{info['tokens_per_s']} tokens/s; peak memory "
        f"{info['peak_memory']}")
    return info


def held_train(what, got, want, small, tol, lr) -> dict:
    """Two {name: tensor} sets (parameters or a moment) held by TRAIN_TOL's
    rule; `small`: the elements whose gradient was small at some step.
    Returns the worst error in the rule's unit and the small-gradient
    elements off."""
    worst, off = 0.0, 0
    for name, g in got.items():
        g, w = g.detach().float().cpu(), want[name].detach().float().cpu()
        err = (g - w).abs()
        unit = (tol["lr_frac"] * lr if what == "params"
                else tol["moments"] * float(w.abs().max()))
        bad = err > unit
        s = small[name].cpu()
        if bool((bad & ~s).any()):
            raise AssertionError(
                f"{what} {name}: {int((bad & ~s).sum())} elements off, the "
                f"worst {float(err[bad & ~s].max())} against {unit}")
        n_off = int((bad & s).sum())
        if n_off >= tol["miss"] * g.numel():
            raise AssertionError(f"{what} {name}: {n_off} of {g.numel()} "
                                 f"small-gradient elements off")
        off += n_off
        if unit > 0:
            worst = max(worst, float(err[~s].max() / unit) if bool(
                (~s).any()) else 0.0)
    return {"worst_of_tol": worst, "small_gradient_off": off}


def train_parity(torch, smi) -> dict:
    """17b: the smoke config at M 2 with remat, f32, the same weights and
    batch on the card and on the CPU, TRAIN_PARITY_STEPS steps each; loss,
    grad norm, every parameter and both moments within TRAIN_TOL."""
    import dataclasses
    from repro_torch.configs import get_config
    from repro_torch.launch import specs
    from repro_torch.models import get_api
    from repro_torch.train import (AdamWConfig, TrainState, adamw_init,
                                   make_train_step)
    cfg = dataclasses.replace(get_config(TRAIN_ARCH, smoke=True),
                              microbatches=2, remat=True)
    api = get_api(cfg)
    cpu = api.init(cfg, tp=1, device="cpu",
                   generator=torch.Generator().manual_seed(SEED))
    card = api.init(cfg, tp=1, device="meta").to_empty(device=DEVICE)
    card.load_state_dict(cpu.state_dict())
    batch = specs.train_inputs(cfg, 64, 4, torch.Generator().manual_seed(1))
    opt = AdamWConfig(lr=TRAIN_LR)
    small = {}

    def record(grads):
        for name, g in grads.items():
            s = g.abs() < TRAIN_TOL["small"] * g.abs().max()
            small[name] = small[name] | s if name in small else s
        return grads

    states, steps = [], []
    for model, transform in ((cpu, record), (card, None)):
        states.append(TrainState(model, adamw_init(
            dict(model.named_parameters()), opt)))
        steps.append(make_train_step(cfg, api, grad_transform=transform,
                                     opt_cfg=opt))
    out = {"steps": []}
    for i in range(1, TRAIN_PARITY_STEPS + 1):
        _, m_cpu = steps[0](states[0], batch)
        _, m_card = steps[1](states[1], {k: v.to(DEVICE)
                                         for k, v in batch.items()})
        rel = {k: abs(float(m_card[k]) - float(m_cpu[k])) / abs(
            float(m_cpu[k])) for k in ("loss", "grad_norm")}
        if rel["loss"] > TRAIN_TOL["loss"] or \
                rel["grad_norm"] > TRAIN_TOL["gnorm"]:
            raise AssertionError(f"17b step {i}: card {m_card} against the "
                                 f"CPU's {m_cpu}")
        held = {"params": held_train(
            "params", dict(card.named_parameters()),
            dict(cpu.named_parameters()), small, TRAIN_TOL, TRAIN_LR)}
        for key in ("m", "v"):
            held[key] = held_train(key, states[1].opt[key],
                                   states[0].opt[key], small, TRAIN_TOL,
                                   TRAIN_LR)
        out["steps"].append({"loss": float(m_card["loss"]),
                             "loss_rel_err": rel["loss"],
                             "grad_norm_rel_err": rel["grad_norm"], **held})
    log(f"[train] 17b {TRAIN_ARCH} smoke, M 2, remat, f32: "
        f"{TRAIN_PARITY_STEPS} steps on the card against the CPU [{smi}]: "
        + json.dumps(out["steps"]))
    return out


def same_state(torch, what, a, b) -> None:
    """Two train states (TrainState) equal bit for bit."""
    pa, pb = dict(a.params.named_parameters()), dict(b.params.named_parameters())
    for name in pa:
        for x, y in ((pa[name], pb[name]), (a.opt["m"][name],
                                            b.opt["m"][name]),
                     (a.opt["v"][name], b.opt["v"][name])):
            if not torch.equal(x.cpu(), y.cpu()):
                raise AssertionError(f"{what}: {name} differs")
    if int(a.opt["step"]) != int(b.opt["step"]):
        raise AssertionError(f"{what}: step {int(a.opt['step'])} against "
                             f"{int(b.opt['step'])}")


def train_restart(torch, smi) -> dict:
    """17b: launch.train.run at --smoke with a checkpoint directory under
    build/: TRAIN_CKPT_STEPS steps saving every 2, then --steps
    TRAIN_RESUME_STEPS, which must restore at TRAIN_CKPT_STEPS; what it
    restores equals the state saved bit for bit, and its final state an
    uninterrupted run's within TRAIN_TOL."""
    import contextlib
    import io
    from repro_torch.distributed.checkpoint import CheckpointManager
    from repro_torch.launch import train as launch_train
    from repro_torch.models import get_api
    from repro_torch.train import init_train_state
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    ckpt = str(pathlib.Path(work.name) / "ckpt")
    base = ["--smoke", "--arch", TRAIN_ARCH, "--device", DEVICE, "--lr",
            str(TRAIN_LR)]

    def run(*argv):
        text = io.StringIO()
        with contextlib.redirect_stdout(text):
            out = launch_train.run(launch_train.build_parser().parse_args(
                base + list(argv)))
        return out, text.getvalue()

    first, _ = run("--steps", str(TRAIN_CKPT_STEPS), "--ckpt-dir", ckpt,
                   "--ckpt-every", "2")
    cfg = first["cfg"]
    fresh = init_train_state(cfg, get_api(cfg), tp=1, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(
                                 SEED + 9))
    at = launch_train.restore_into(CheckpointManager(ckpt), fresh)
    if at != TRAIN_CKPT_STEPS:
        raise AssertionError(f"17b: the newest checkpoint is at step {at}")
    same_state(torch, "17b restored against saved", fresh, first["state"])
    del fresh
    resumed, text = run("--steps", str(TRAIN_RESUME_STEPS), "--ckpt-dir",
                        ckpt, "--ckpt-every", "2")
    if f"restored checkpoint at step {TRAIN_CKPT_STEPS}" not in text:
        raise AssertionError(f"17b: no restore printed: {text}")
    whole, _ = run("--steps", str(TRAIN_RESUME_STEPS))
    no_small = {n: torch.zeros(p.shape, dtype=torch.bool) for n, p in
                whole["state"].params.named_parameters()}
    held = {"params": held_train(
        "params", dict(resumed["state"].params.named_parameters()),
        dict(whole["state"].params.named_parameters()), no_small,
        TRAIN_TOL, TRAIN_LR)}
    for key in ("m", "v"):
        held[key] = held_train(key, resumed["state"].opt[key],
                               whole["state"].opt[key], no_small, TRAIN_TOL,
                               TRAIN_LR)
    losses = {"resumed": resumed["losses"],
              "whole": whole["losses"][TRAIN_CKPT_STEPS:]}
    worst = max(abs(a - b) / abs(b) for a, b in zip(*losses.values()))
    if worst > TRAIN_TOL["loss"]:
        raise AssertionError(f"17b: resumed losses {losses}")
    work.cleanup()
    info = {"restored_at": at, "restored_bitwise": True,
            "losses": losses, "loss_rel_err": worst, **held,
            "bitwise_with_whole": all(
                torch.equal(p, dict(whole["state"].params.named_parameters(
                ))[n]) for n, p in resumed["state"].params.named_parameters())}
    log(f"[train] 17b checkpoint / restart through launch.train.run "
        f"(--smoke, {TRAIN_CKPT_STEPS} steps then {TRAIN_RESUME_STEPS}) "
        f"[{smi}]: " + json.dumps(info))
    return info


def train_bf16_round_trip(torch, smi) -> dict:
    """17b: one full-width phi4 layer's bf16 parameters and bf16 moments
    (drawn on the card) saved and restored bit for bit, the leaves read
    back as JAX's void words."""
    from repro_torch.distributed.checkpoint import (_flatten,
                                                    restore_checkpoint,
                                                    save_checkpoint)
    from repro_torch.models import layers as L
    cfg = get_lm_config(TRAIN_ARCH)
    gen = torch.Generator(DEVICE).manual_seed(SEED + 3)
    block = L.Block(cfg, torch.bfloat16, DEVICE)
    block.reset_parameters(gen)
    params = {n: p.detach() for n, p in block.named_parameters()}
    state = {"params": params, "opt": {
        key: {n: torch.randn(p.shape, generator=gen, device=DEVICE).to(
            torch.bfloat16) for n, p in params.items()}
        for key in ("m", "v")}}
    state["opt"]["step"] = torch.tensor(3, dtype=torch.int32, device=DEVICE)
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    t0 = time.perf_counter()
    save_checkpoint(work.name, 3, state)
    like = {"params": {n: torch.empty_like(p) for n, p in params.items()},
            "opt": {key: {n: torch.empty_like(t) for n, t in
                          state["opt"][key].items()} for key in ("m", "v")}}
    like["opt"]["step"] = torch.zeros((), dtype=torch.int32, device=DEVICE)
    got, step = restore_checkpoint(work.name, like)
    seconds = time.perf_counter() - t0
    words = np.load(pathlib.Path(work.name) / "step_3" / "leaf_0.npy")
    n, nbytes = 0, 0
    for (path, want), (_, have) in zip(_flatten(state), _flatten(got)):
        if want.dtype != have.dtype or not torch.equal(
                want.view(torch.int16) if want.dtype == torch.bfloat16
                else want, have.view(torch.int16)
                if have.dtype == torch.bfloat16 else have):
            raise AssertionError(f"17b bf16 round trip: {path} differs")
        n += 1
        nbytes += want.numel() * want.element_size()
    work.cleanup()
    if step != 3 or words.dtype != np.dtype("V2"):
        raise AssertionError(f"17b bf16 round trip: step {step}, leaf dtype "
                             f"{words.dtype}")
    info = {"leaves": n, "bytes": nbytes, "seconds": seconds}
    log(f"[train] 17b bf16 round trip of one full-width {TRAIN_ARCH} layer "
        f"(parameters and bf16 m, v: {n} leaves, {nbytes / 1e9:.3f} GB) "
        f"[{smi}]: bit for bit in {seconds:.2f} s, the leaves |V2 on disk")
    return info


def train_kind(name: str) -> str:
    """A coarse class of a card record's name, for the step's breakdown."""
    low = name.lower()
    if any(k in low for k in ("gemm", "cutlass", "xmma", "sm90", "nvjet",
                              "wgmma", "ampere")):
        return "gemm"
    if "memcpy" in low or "memset" in low or "copy" in low:
        return "copy"
    if "reduce" in low or "norm" in low or "softmax" in low or \
            "logsumexp" in low:
        return "reduction"
    if "index" in low or "embedding" in low or "scatter" in low or \
            "gather" in low:
        return "index"
    if "elementwise" in low:
        return "elementwise"
    return "other"


def train_profile(torch, smi) -> dict:
    """17c: (a)'s configuration in process (the launcher's state, batch,
    step): one warm step split by CUDA events into forward + backward
    (with remat's recompute) and grad norm + AdamW (an event recorded in
    the grad_transform hook), a no-grad forward of both microbatches
    alone, then one step under torch.profiler: host and card ms, busy
    share, records, the largest card parts and each class's sum."""
    from repro_torch.launch import specs
    from repro_torch.models import get_api
    from repro_torch.train import (AdamWConfig, cross_entropy,
                                   init_train_state, make_train_step)
    cfg = get_lm_config(TRAIN_ARCH)
    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, api, tp=1, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(
                                 SEED))
    batch = specs.train_inputs(cfg, TRAIN_S, TRAIN_B,
                               torch.Generator(DEVICE).manual_seed(7))
    opt = AdamWConfig(lr=TRAIN_LR, moment_dtype=cfg.optimizer_dtype)
    marks = []

    def mark(grads):
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        marks.append(ev)
        return grads

    step = make_train_step(cfg, api, grad_transform=mark, opt_cfg=opt)
    step(state, batch)                                     # warm-up
    a, b = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    marks.clear()
    a.record()
    _, metrics = step(state, batch)
    b.record()
    b.synchronize()
    split = {"step_ms": a.elapsed_time(b),
             "forward_backward_ms": a.elapsed_time(marks[0]),
             "gnorm_adamw_ms": marks[0].elapsed_time(b)}
    M = cfg.microbatches

    def forward():
        with torch.no_grad():
            for i in range(M):
                mb = {k: x.reshape(M, x.shape[0] // M, *x.shape[1:])[i]
                      for k, x in batch.items()}
                cross_entropy(api.forward(state.params, mb, 1), mb["labels"])
    split["forward_ms"] = cuda_ms(torch, forward, reps=3, warm=1)
    split["backward_recompute_ms"] = split["forward_backward_ms"] - \
        split["forward_ms"]
    host_ms, device = profiled(torch, lambda: step(state, batch))
    busy = sum(ms for _, ms in device.values())
    kinds = {}
    for name, (n, ms) in device.items():
        k = kinds.setdefault(train_kind(name), {"ms": 0.0, "records": 0})
        k["ms"] += ms
        k["records"] += n
    top = sorted(device.items(), key=lambda kv: -kv[1][1])[:8]
    b_ = lm_bounds(torch, cfg, TRAIN_B, TRAIN_S, TRAIN_S)
    info = {**split, "host_ms": host_ms, "device_ms": busy,
            "busy_share": busy / host_ms if busy else None,
            "records": sum(n for n, _ in device.values()),
            "kinds": kinds, "peak_gb": torch.cuda.max_memory_allocated() / 1e9,
            "loss": float(metrics["loss"]),
            "train_bound_ms": b_["train_bound_ms"],
            "top": [{"kernel": k[:90], "ms": ms, "calls": n}
                    for k, (n, ms) in top]}
    log(f"[train] 17c one warm step of 17a's configuration in process "
        f"[{smi}]: {split['step_ms']:.1f} ms by CUDA events (bound "
        f"{b_['train_bound_ms']:.2f}): forward + backward "
        f"{split['forward_backward_ms']:.1f} (a no-grad forward of both "
        f"microbatches {split['forward_ms']:.1f}, so backward + recompute "
        f"{split['backward_recompute_ms']:.1f}), grad norm + AdamW "
        f"{split['gnorm_adamw_ms']:.1f}; under the profiler host "
        f"{host_ms:.1f} ms, card {busy:.1f} ms (busy share "
        f"{info['busy_share']}), {info['records']} records; by class "
        f"{json.dumps(kinds)}; peak memory {info['peak_gb']:.3f} GB; most "
        f"card time: {json.dumps(info['top'])}")
    del state, batch
    free(torch)
    return info


def phase_train(torch, smi) -> dict:
    """Phase 17: the single-process training loop on the card (train/
    optimizer.py's AdamW, train/steps.py's step with the gradient hook
    and remat, launch/train.py with its checkpoints)."""
    return lm_phase(torch, 17, lambda: {
        "launcher": train_launcher(torch, smi),
        "parity": train_parity(torch, smi),
        "restart": train_restart(torch, smi),
        "bf16_round_trip": train_bf16_round_trip(torch, smi),
        "profile": train_profile(torch, smi), "card": smi})


def checksums(torch, named) -> dict:
    """{name: [sum of the words, sum of the words times (index mod 65521)
    + 1]} of each tensor's raw bits (int64 sums, which wrap the same way
    whatever the order): equal bits give equal sums."""
    out = {}
    for name, t in named.items():
        words = t.detach().reshape(-1).view(
            torch.int32 if t.element_size() == 4 else torch.int16)
        s1 = s2 = 0
        for a in range(0, words.numel(), CHECK_CHUNK):
            w = words[a:a + CHECK_CHUNK].long()
            idx = torch.arange(a, a + w.numel(), device=w.device)
            s1 += int(w.sum())
            s2 += int((w * (idx % 65521 + 1)).sum())
        out[name] = [s1, s2]
    return out


def state_checksums(torch, state) -> dict:
    named = dict(state.params.named_parameters())
    return {"params": checksums(torch, named),
            "m": checksums(torch, state.opt["m"]),
            "v": checksums(torch, state.opt["v"])}


def train_mesh_worker(argv) -> int:
    """`chip_smoke.py --train-mesh-worker OUT -- LAUNCHER ARGS`, one rank
    under torchrun: launch.train.run on the args, then the losses, grad
    norms, peak and the state's checksums to OUT (JSON), and the gather at
    use counted: the units run through sharding.call_gathered and the
    gathers of a parameter that ran a collective."""
    import torch
    from repro_torch.distributed import sharding
    from repro_torch.launch import train as launch_train
    from repro_torch.train import steps
    out_path, args = argv[0], argv[argv.index("--") + 1:]
    uses = {"units": 0, "collectives": 0}
    call, gather = sharding.call_gathered, sharding.gather

    def counted_call(*a, **k):
        uses["units"] += 1
        return call(*a, **k)

    def counted_gather(t, *a, **k):
        out = gather(t, *a, **k)
        uses["collectives"] += out is not t
        return out

    sharding.call_gathered = steps.call_gathered = counted_call
    sharding.gather = counted_gather
    out = launch_train.run(launch_train.build_parser().parse_args(args))
    pathlib.Path(out_path).write_text(json.dumps({
        "uses": uses,
        "losses": out["losses"], "grad_norms": out["grad_norms"],
        "peak_bytes": out.get("peak_bytes", 0), "warm_ms": out["warm_ms"],
        "tokens_per_s": out["tokens_per_s"],
        "checksums": state_checksums(torch, out["state"])}))
    return 0


def mesh_world_one(torch, smi, peak17) -> dict:
    """18a: MESH_RUN under torchrun (--standalone --nproc_per_node 1; a NCCL
    world of one, the sharded state and step) as a process, then the
    meshless step in process from the same seed and batch: loss, grad
    norm and every parameter's and moment's checksum bit for bit; the
    peak beside phase 17's. The launcher's step gathers at each use: each
    block through sharding.call_gathered as it runs and again in remat's
    replay, the parameters outside the blocks once a microbatch; on a
    world of one no gather runs a collective (none over the data axes
    runs on the card)."""
    import os
    from repro_torch.launch import specs
    from repro_torch.models import get_api
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step)
    BUILD.mkdir(parents=True, exist_ok=True)
    work = tempfile.TemporaryDirectory(dir=BUILD)
    out_path = pathlib.Path(work.name) / "mesh.json"
    cmd = [sys.executable] + TORCHRUN + [
        str(ROOT / "chip_smoke.py"), "--train-mesh-worker", str(out_path),
        "--"] + MESH_RUN + ["--device", DEVICE]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, env={**os.environ, "PYTHONPATH": str(SRC)},
                          capture_output=True, text=True, timeout=900,
                          cwd=str(ROOT))
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        raise AssertionError(f"18a: the launcher under torchrun exited "
                             f"{proc.returncode}:\n{proc.stdout[-3000:]}\n"
                             f"{proc.stderr[-3000:]}")
    mesh = json.loads(out_path.read_text())
    work.cleanup()
    free(torch)
    cfg = get_lm_config(TRAIN_ARCH)
    api = get_api(cfg)
    torch.cuda.reset_peak_memory_stats()
    state = init_train_state(cfg, api, tp=1, device=DEVICE,
                             generator=torch.Generator(DEVICE).manual_seed(
                                 SEED))
    batch = specs.train_inputs(cfg, TRAIN_S, TRAIN_B,
                               torch.Generator(DEVICE).manual_seed(7))
    step = make_train_step(cfg, api, opt_cfg=AdamWConfig(
        lr=TRAIN_LR, moment_dtype=cfg.optimizer_dtype))
    losses, gnorms = [], []
    for _ in range(MESH_STEPS):
        _, m = step(state, batch)
        losses.append(float(m["loss"]))
        gnorms.append(float(m["grad_norm"]))
    sums = state_checksums(torch, state)
    peak = torch.cuda.max_memory_allocated() / 1e9
    del state, batch
    free(torch)
    differ = [f"{what} {name}" for what in sums for name in sums[what]
              if sums[what][name] != mesh["checksums"][what][name]]
    if losses != mesh["losses"] or gnorms != mesh["grad_norms"] or differ:
        raise AssertionError(f"18a: the mesh of one against the meshless "
                             f"step: losses {mesh['losses']} / {losses}, "
                             f"grad norms {mesh['grad_norms']} / {gnorms}, "
                             f"checksums differ at {differ[:8]}")
    M, depth = cfg.microbatches, cfg.n_layers
    units = MESH_STEPS * M * ((2 if cfg.remat else 1) * depth + 1)
    if mesh["uses"] != {"units": units, "collectives": 0}:
        raise AssertionError(f"18a: the gather at use ran {mesh['uses']}, "
                             f"not {units} units and no collective")
    mesh_peak = mesh["peak_bytes"] / 1e9
    if abs(mesh_peak - peak17) > MESH_PEAK_TOL * peak17:
        raise AssertionError(f"18a: peak {mesh_peak:.3f} GB against phase "
                             f"17's {peak17:.3f} GB")
    info = {"cmd": "torchrun --standalone --nproc_per_node 1 -m "
                   "repro_torch.launch.train " + " ".join(MESH_RUN),
            "process_s": seconds, "losses": losses, "grad_norms": gnorms,
            "gathered_at_use": mesh["uses"],
            "tensors_held": sum(len(v) for v in sums.values()),
            "bitwise": True, "mesh_peak_gb": mesh_peak,
            "meshless_peak_gb": peak, "phase17_peak_gb": peak17,
            "mesh_warm_ms": mesh["warm_ms"],
            "mesh_tokens_per_s": mesh["tokens_per_s"]}
    log(f"[train-mesh] 18a {info['cmd']} [{smi}]: exit 0 in {seconds:.1f} "
        f"s; {MESH_STEPS} steps of {TRAIN_ARCH} (full width and depth) at "
        f"world 1 equal the meshless step bit for bit: losses {losses}, "
        f"grad norms {gnorms}, {info['tensors_held']} parameters and "
        f"moments by checksum; each parameter gathered at its use "
        f"({units} units through the gather: {MESH_STEPS} steps x M {M} x "
        f"({depth} blocks{' twice, remat' if cfg.remat else ''} + the "
        f"rest), none running a collective: one card, so no data-axis "
        f"collective); peak {mesh_peak:.3f} GB (meshless "
        f"{peak:.3f}, phase 17 {peak17:.3f}); warm step "
        f"{mesh['warm_ms']:.1f} ms, {mesh['tokens_per_s']:.1f} tokens/s")
    return info


def dot64(torch, a, b) -> float:
    """<a, b> of two f32 vectors accumulated in f64, CHECK_CHUNK at a
    time."""
    out = 0.0
    for i in range(0, a.numel(), CHECK_CHUNK):
        out += float((a[i:i + CHECK_CHUNK].double()
                      * b[i:i + CHECK_CHUNK].double()).sum())
    return out


def first_gradient(torch, cfg, api) -> tuple:
    """The first step's f32 gradient sum of SKETCH_RUN's model and batch
    (the meshless step stopped in its grad_transform hook), flattened in
    JAX's order, and the model's n."""
    from repro_torch.launch import specs
    from repro_torch.models.convert import jax_order
    from repro_torch.train import TrainState, make_train_step

    class Stop(Exception):
        pass

    model = api.init(cfg, 1, device=DEVICE,
                     generator=torch.Generator(DEVICE).manual_seed(SEED))
    batch = specs.train_inputs(cfg, TRAIN_S, TRAIN_B,
                               torch.Generator(DEVICE).manual_seed(7))
    n = sum(p.numel() for p in model.parameters())
    v = torch.empty((n,), dtype=torch.float32, device=DEVICE)

    def take(grads):
        at = 0
        for name in jax_order(model):
            g = grads[name].reshape(-1)
            v[at:at + g.numel()] = g
            at += g.numel()
        raise Stop

    try:
        make_train_step(cfg, api, grad_transform=take)(TrainState(model, {}),
                                                       batch)
    except Stop:
        pass
    del model, batch
    free(torch)
    return v, n


def sketch_identities(torch, smi) -> dict:
    """18b, on the first step's gradient v with the launcher's first draw
    (seed 0): s = compress(v), g_hat = decompress(s); over the padded
    vectors |g_hat| = |s| and <g_hat, v - g_hat> ~ 0. The launcher's
    transform (make_sketched_grad_transform on the model's names, shapes
    and dtypes) run on v at ef = 0 with the same draw: its g_hat is
    decompress(s) cast to each parameter's dtype, bit for bit, and its
    ef' is v - g_hat within one f32 rounding (v = g_hat + e'). fwht_op at (2^31, 1) against fwht_ref, the
    same bits, both timed beside the bound."""
    from repro_torch.distributed.compression import (
        compress, decompress, make_sketched_grad_transform, sketch_params)
    from repro_torch.kernels.fwht.ops import fwht_op
    from repro_torch.kernels.fwht.ref import fwht_ref
    from repro_torch.models import get_api
    from repro_torch.models.convert import jax_order
    cfg = get_lm_config(SKETCH_ARCH)
    api = get_api(cfg)
    v, n = first_gradient(torch, cfg, api)
    signs, rows = sketch_params(torch.Generator(DEVICE).manual_seed(0), n,
                                SKETCH_R)
    n_pad = signs.shape[0]
    s = compress(v, signs, rows)
    g = decompress(s, signs, rows, n_pad)
    s2, g2, vv = dot64(torch, s, s), dot64(torch, g, g), dot64(torch, v, v)
    gv = dot64(torch, g[:n], v)               # v_pad is 0 past n
    ge, ee = gv - g2, vv - 2 * gv + g2        # <g, e>, |e|^2, e = v - g
    del s
    free(torch)
    meta = api.init(cfg, 1, device="meta")
    transform, _ = make_sketched_grad_transform(meta, SKETCH_R)
    grads, at = {}, 0
    for name in jax_order(meta):
        shape = meta.get_parameter(name).shape
        grads[name] = v[at:at + shape.numel()].view(shape)
        at += shape.numel()
    ef = torch.zeros((n,), dtype=torch.float32, device=DEVICE)
    g_hat, ef = transform(grads, ef, (signs, rows))
    del grads
    g_same, at = True, 0
    for name in jax_order(meta):               # bf16 and f32 leaves
        t = g_hat[name].reshape(-1)
        g_same &= bool(torch.equal(t, g[at:at + t.numel()].to(t.dtype)))
        at += t.numel()
    del g_hat, meta
    free(torch)
    worst, gn = 0.0, g[:n]
    for i in range(0, n, CHECK_CHUNK):
        vc, gc = v[i:i + CHECK_CHUNK], gn[i:i + CHECK_CHUNK]
        ec = ef[i:i + CHECK_CHUNK].double()
        off = (vc.double() - gc.double() - ec).abs() - 2.0 ** -24 * ec.abs()
        worst = max(worst, float(off.max()))
    del g, gn, ef
    free(torch)
    info = {"n": n, "n_pad": n_pad, "r_prime": SKETCH_R,
            "norm_ratio_minus_1": math.sqrt(g2 / s2) - 1,
            "cos_g_e": ge / math.sqrt(g2 * ee),
            "transform_g_hat_same_bits": g_same,
            "v_minus_g_minus_ef_beyond_rounding": worst}
    if abs(info["norm_ratio_minus_1"]) > 1e-5 or \
            abs(info["cos_g_e"]) > 1e-5 or not g_same or worst > 0:
        raise AssertionError(f"18b: the projection's identities: {info}")
    x = torch.zeros((n_pad, 1), dtype=torch.float32, device=DEVICE)
    x[:n, 0] = v
    del v
    x[:, 0].mul_(signs)
    del signs, rows
    free(torch)
    got = fwht_op(x)
    want = fwht_ref(x)
    same = bool(torch.equal(got, want))
    err = float((got - want).abs().max())
    del got, want
    free(torch)
    if not same:
        raise AssertionError(f"18b: fwht_op at ({n_pad}, 1) differs from "
                             f"fwht_ref by {err}")
    info.update({"fwht_ms": cuda_ms(torch, lambda: fwht_op(x), reps=3,
                                    warm=1),
                 "fwht_plain_ms": cuda_ms(torch, lambda: fwht_ref(x), reps=3,
                                          warm=1),
                 "fwht_same_bits": same, "fwht_max_abs_err": err,
                 **fwht_bound(n_pad, 1)})
    del x
    free(torch)
    log(f"[train-mesh] 18b identities on the first step's gradient of "
        f"{SKETCH_ARCH} (n {n:,}, n_pad {n_pad:,}, r' {SKETCH_R:,}) "
        f"[{smi}]: |g_hat| / |s| - 1 = {info['norm_ratio_minus_1']:.3e}, "
        f"cos(g_hat, e') = {info['cos_g_e']:.3e}; the transform's g_hat "
        f"is decompress(s) in each parameter's dtype bit for bit and its "
        f"ef' is v - g_hat to one f32 rounding; fwht_op at ({n_pad}, 1) "
        f"{info['fwht_ms']:.3f} ms (bound {info['bound_ms']:.3f} ms by "
        f"{info['bound_by']}, {info['fwht_ms'] / info['bound_ms']:.1f}x; "
        f"{FWHT_COLUMN_BEFORE_MS} ms through the pass kernel alone), "
        f"fwht_ref {info['fwht_plain_ms']:.3f} ms, the same bits")
    return info


def sketch_launcher(torch, smi) -> dict:
    """18b: launch.train.run with SKETCH_RUN in process (its mesh a NCCL
    world of one): the loss falls (the launcher asserts it), the ratio
    printed is n / r', the transform's ms a step, the peak <=
    SKETCH_PEAK_GB; every launch count set to 0 just before and read
    just after."""
    import contextlib
    import io
    from repro_torch.kernels import OPS, reset_launches
    from repro_torch.launch import train as launch_train
    args = launch_train.build_parser().parse_args(SKETCH_RUN + [
        "--device", DEVICE])
    text = io.StringIO()
    free(torch)
    reset_launches()
    t0 = time.perf_counter()
    with contextlib.redirect_stdout(text):
        out = launch_train.run(args)
    seconds = time.perf_counter() - t0
    launches = {name: op.launches for name, op in OPS.items()}
    n = sum(p.numel() for p in out["state"].params.parameters())
    lines = [ln for ln in text.getvalue().splitlines() if ln.strip()]
    peak = out["peak_bytes"] / 1e9
    info = {"cmd": "python -m repro_torch.launch.train " + " ".join(
                SKETCH_RUN), "seconds": seconds, "lines": lines,
            "losses": out["losses"], "ratio": out["ratio"],
            "n": n, "transform_ms": out["transform_ms"],
            "warm_ms": out["warm_ms"], "tokens_per_s": out["tokens_per_s"],
            "peak_gb": peak, "launches": launches}
    del out
    free(torch)
    if info["ratio"] != n / SKETCH_R:
        raise AssertionError(f"18b: ratio {info['ratio']} against n / r' "
                             f"{n / SKETCH_R}")
    if peak > SKETCH_PEAK_GB:
        raise AssertionError(f"18b: peak {peak:.3f} GB > {SKETCH_PEAK_GB}")
    if launches["fwht"] != 2 * SKETCH_STEPS or any(
            c for name, c in launches.items() if name != "fwht"):
        raise AssertionError(f"18b: launches {launches}; fwht should run 2 "
                             f"a step")
    warm = info["transform_ms"][1:]
    log(f"[train-mesh] 18b {info['cmd']} in process [{smi}]: "
        + " | ".join(lines))
    log(f"[train-mesh] 18b {SKETCH_ARCH} full width and depth ({n:,} "
        f"parameters) with sketched gradients r' {SKETCH_R:,} [{smi}]: loss "
        f"{info['losses'][0]} -> {info['losses'][-1]}; ratio "
        f"{info['ratio']:.4f} = n / r'; transform {statistics.mean(warm):.1f}"
        f" ms a warm step ({info['transform_ms']}; through the pass kernel "
        f"alone {SKETCH_TRANSFORM_BEFORE_MS[0]}-"
        f"{SKETCH_TRANSFORM_BEFORE_MS[1]}); warm step "
        f"{info['warm_ms']:.1f} ms, {info['tokens_per_s']:.1f} tokens/s; "
        f"peak {peak:.3f} GB (gate {SKETCH_PEAK_GB}); launches {launches}")
    return info


def sketch_smoke_configs(torch, smi) -> dict:
    """18c: compress and decompress at each smoke config's n (r'
    SKETCH_SMOKE_R), on the card (fwht_op) against the CPU's plain path
    (fwht_ref) on the same inputs, within FWHT_TOL."""
    from repro_torch.configs import ARCH_IDS, get_config
    from repro_torch.distributed.compression import (compress, decompress,
                                                     sketch_params)
    from repro_torch.models import get_api
    out = {}
    for arch in ARCH_IDS:
        cfg = get_config(arch, smoke=True)
        n = sum(p.numel() for p in get_api(cfg).init(
            cfg, 1, device="meta").parameters())
        gen = torch.Generator().manual_seed(SEED)
        signs, rows = sketch_params(gen, n, SKETCH_SMOKE_R)
        v = torch.randn((n,), generator=gen)
        s_cpu = compress(v, signs, rows)
        s_card = compress(v.to(DEVICE), signs.to(DEVICE), rows.to(DEVICE))
        g_cpu = decompress(s_cpu, signs, rows, n)
        g_card = decompress(s_cpu.to(DEVICE), signs.to(DEVICE),
                            rows.to(DEVICE), n)
        err = max(max_err(torch, s_card, s_cpu), max_err(torch, g_card,
                                                         g_cpu))
        if err > FWHT_TOL:
            raise AssertionError(f"18c {arch}: the card against the plain "
                                 f"path {err} > {FWHT_TOL}")
        out[arch] = {"n": n, "n_pad": int(signs.shape[0]),
                     "max_abs_err": err}
    log(f"[train-mesh] 18c compress / decompress at the smoke configs, "
        f"fwht_op on the card against fwht_ref on the CPU [{smi}]: "
        + json.dumps(out))
    return out


def seq_world_one(torch, smi) -> dict:
    """18d: the switch of sequence parallelism (sharding.
    activation_sharding(seq_axis="model", seq_div=1), as the dry run
    enters it at a model axis of 1) around the sharded step on a NCCL
    world of one rank (made here and torn down): the smoke configs of
    SEQ_WORLD_ARCHS step MESH_STEPS times inside it bit for bit as the
    same mesh step outside it (losses, grad norms, every parameter and
    moment): a model axis of 1 never cuts the stream."""
    from repro_torch.configs import get_config
    from repro_torch.distributed.sharding import activation_sharding
    from repro_torch.launch import specs
    from repro_torch.launch.mesh import dp_axes, make_debug_mesh, open_world
    from repro_torch.models import get_api
    from repro_torch.train import (AdamWConfig, init_train_state,
                                   make_train_step, shard_train_state)
    info, differ = {}, []
    t0 = time.perf_counter()
    with open_world(DEVICE):
        mesh = make_debug_mesh(device=DEVICE)
        for arch in SEQ_WORLD_ARCHS:
            cfg = get_config(arch, smoke=True)
            api = get_api(cfg)
            batch = specs.train_inputs(
                cfg, SEQ_WORLD_S, SEQ_WORLD_B,
                torch.Generator(DEVICE).manual_seed(7))
            runs = []
            for seq in (None, "model"):
                state = shard_train_state(init_train_state(
                    cfg, api, tp=1, device=DEVICE,
                    generator=torch.Generator(DEVICE).manual_seed(SEED)),
                    mesh)
                step = make_train_step(cfg, api, opt_cfg=AdamWConfig(
                    lr=TRAIN_LR), mesh=mesh)
                metrics = []
                for _ in range(MESH_STEPS):
                    with activation_sharding(dp_axes(mesh), seq_axis=seq,
                                             seq_div=1):
                        _, m = step(state, batch)
                    metrics += [m["loss"].clone(), m["grad_norm"].clone()]
                runs.append((metrics, state))
            (ma, sa), (mb, sb) = runs
            pa = dict(sa.params.named_parameters())
            differ += [f"{arch} metric {i}" for i, (a, b) in
                       enumerate(zip(ma, mb)) if not torch.equal(a, b)]
            for name, p in sb.params.named_parameters():
                for what, a, b in (("param", pa[name], p),
                                   ("m", sa.opt["m"][name],
                                    sb.opt["m"][name]),
                                   ("v", sa.opt["v"][name],
                                    sb.opt["v"][name])):
                    if not torch.equal(a, b):
                        differ.append(f"{arch} {what} {name}")
            info[arch] = {"losses": [float(x) for x in mb[0::2]],
                          "tensors_held": 2 * MESH_STEPS + 3 * len(pa)}
            del runs, sa, sb, pa, batch
    free(torch)
    info["seconds"] = time.perf_counter() - t0
    info["bitwise"] = not differ
    held = ", ".join(f"{a}: {info[a]['tensors_held']} tensors"
                     for a in SEQ_WORLD_ARCHS)
    log(f"[train-mesh] 18d the sharded step inside activation_sharding("
        f"seq_axis='model', seq_div=1) on a NCCL world of one [{smi}], "
        f"smoke {', '.join(SEQ_WORLD_ARCHS)} at B {SEQ_WORLD_B} x S "
        f"{SEQ_WORLD_S}, {MESH_STEPS} steps each, against the same step "
        f"outside it: "
        f"{'bit for bit' if not differ else f'differ at {differ[:8]}'} "
        f"({held}; {info['seconds']:.1f} s)")
    if differ:
        raise AssertionError(f"18d: inside the switch the step differs at "
                             f"{differ[:8]}")
    return info


def phase_train_mesh(torch, smi, phase17) -> tuple:
    """Phase 18: the mesh half of training (distributed/sharding.py,
    shard_train_state and the sharded step, the sketched gradients,
    launch/train.py's --data / --model / --sketch-grads). Its kernel is
    fwht (compress and decompress, 2 launches a step in 18b); 18a and 18c
    launch none that count."""
    from repro_torch.kernels import OPS, reset_launches
    free(torch)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    t0 = time.perf_counter()
    peak17 = float(phase17["launcher"]["peak_memory"].split()[0])
    info = {"mesh": mesh_world_one(torch, smi, peak17)}
    info["seq_world_one"] = seq_world_one(torch, smi)
    info["sketch"] = sketch_launcher(torch, smi)
    launches = dict(info["sketch"]["launches"])
    info["identities"] = sketch_identities(torch, smi)
    info["smoke_configs"] = sketch_smoke_configs(torch, smi)
    reset_launches()
    info["phase_s"] = time.perf_counter() - t0
    info["card"] = smi
    log(f"[train-mesh] phase 18 took {info['phase_s']:.1f} s; launches "
        f"counted {launches}")
    return {name: launches.get(name, 0) for name in OPS}, info


def dryrun_flops(torch, cfg, B, S) -> dict:
    """The train step's flops as the port runs them, term by term from
    lm_bounds' train_flops (3 x the forward's products, the attention over
    the causal pairs only, no recompute): (1) the attention's masked pairs,
    since the port scores every (query, key) pair and masks the later
    ones: 4 B nq hd (S^2 - S (S + 1) / 2) a layer, 3 times (forward and
    the backward's two products); (2) remat's recomputed forward: each
    block's forward again in the backward, with the full S^2 attention,
    less the MLP's down projection, which checkpoint's early stop does not
    rerun (its output is saved by no op of the backward). A dense config
    (phase 19a runs phi4-mini-3.8b)."""
    b = lm_bounds(torch, cfg, B, S, S)
    d, hd, nq, nkv = cfg.d_model, cfg.head_dim, cfg.n_heads, cfg.n_kv_heads
    T, L_ = B * S, cfg.n_layers
    full_attn = 4 * B * nq * hd * S * S
    masked = 3 * L_ * 4 * B * nq * hd * (S * S - S * (S + 1) // 2)
    proj = 2 * T * (d * hd * (nq + 2 * nkv) + nq * hd * d
                    + 3 * d * cfg.d_ff)
    remat = L_ * (proj + full_attn - 2 * T * cfg.d_ff * d) if cfg.remat \
        else 0
    return {"lm_bounds": b["train_flops"], "masked_pairs": masked,
            "remat": remat, "expected": b["train_flops"] + masked + remat}


def dry_child(tag: str, job: tuple) -> dict:
    """One cell of phase 19, run in a child process of dry_records (or in
    this one): `job` is (cfg, B, S) for 19a, dryrun.measure of a train
    step in a dry-run world of one rank, else (arch, shape, cut) for
    dryrun.run_cell on 16 x 16 (its JSON under BUILD/dryrun/<tag>). Returns
    the record beside the process's kernel launches and whether it
    initialised CUDA, which the phase holds at none."""
    import torch
    from repro_torch.kernels import OPS
    from repro_torch.launch import dryrun
    if tag == "19a":
        from repro_torch.launch.mesh import destroy_dryrun_mesh, \
            make_dryrun_mesh
        cfg, B, S = job
        mesh = make_dryrun_mesh(shape=(1, 1))
        try:
            rec = dryrun.measure(cfg, "train", B, S, mesh)
        finally:
            destroy_dryrun_mesh(mesh)
    else:
        arch, shape, cut = job
        rec = dryrun.run_cell(arch, shape, False,
                              str(BUILD / "dryrun" / tag.replace(" ", "_")),
                              cut or None)
    return {"rec": rec, "cuda_initialized": torch.cuda.is_initialized(),
            "launches": {n: op.launches for n, op in OPS.items()}}


def dry_records(jobs: dict) -> dict:
    """Each tag's dry_child result: the DRY_HERE jobs run in this process
    while the others run in DRY_JOBS spawned processes (no CUDA state is
    forked), started in the order given; the pool's processes end with
    it."""
    import multiprocessing
    from concurrent.futures import ProcessPoolExecutor
    with ProcessPoolExecutor(DRY_JOBS, mp_context=multiprocessing.get_context(
            "spawn")) as pool:
        futures = {tag: pool.submit(dry_child, tag, job)
                   for tag, job in jobs.items() if tag not in DRY_HERE}
        here = {tag: dry_child(tag, jobs[tag]) for tag in DRY_HERE}
        return here | {tag: f.result() for tag, f in futures.items()}


def dry_record(recs, tag: str, job: tuple) -> dict:
    """`tag`'s record from phase 19's parallel run `recs`, or, where a cell
    is run alone (recs None), from dry_child in this process."""
    return (recs[tag] if recs is not None else dry_child(tag, job))["rec"]


def one_rank_job() -> tuple:
    return get_lm_config(TRAIN_ARCH), TRAIN_B, TRAIN_S


def mesh_job(arch: str, **cut) -> tuple:
    return arch, "train_4k", cut


def serve_job(arch: str, shape: str, **over) -> tuple:
    """A serving cell at DRY_SERVE_LAYERS layers, an encoder-decoder's
    encoder too, with `over` more config overrides."""
    cut = {"n_layers": DRY_SERVE_LAYERS, **over}
    if get_lm_config(arch).family == "encdec":
        cut["n_encoder_layers"] = DRY_SERVE_LAYERS
    return arch, shape, cut


def dryrun_one_rank(torch, smi, peak17, recs=None) -> dict:
    """19a: the dry run of phase 17's step (phi4-mini-3.8b at full width
    and depth, B TRAIN_B x S TRAIN_S, M 2, remat) in a dry-run world of one
    rank: its peak against 17a's measured max_memory_allocated, its flops
    against dryrun_flops."""
    cfg = get_lm_config(TRAIN_ARCH)
    rec = dry_record(recs, "19a", one_rank_job())
    res = rec["analysis"]
    want = dryrun_flops(torch, cfg, TRAIN_B, TRAIN_S)
    info = {"peak_bytes": res["memory"]["peak"],
            "argument_bytes": res["memory"]["argument"],
            "temp_bytes": res["memory"]["temp"],
            "measured_peak_bytes": peak17,
            "peak_off": res["memory"]["peak"] / peak17 - 1,
            "flops": res["flops"], "traffic_bytes": res["traffic_bytes"],
            **{f"flops_{k}": v for k, v in want.items()},
            "flops_off": res["flops"] / want["expected"] - 1,
            "microbatches": rec["microbatches"],
            "build_s": res["build_s"], "run_s": res["run_s"]}
    log(f"[dryrun] 19a {TRAIN_ARCH} B {TRAIN_B} x S {TRAIN_S}, M "
        f"{rec['microbatches']}, remat, a dry-run world of one rank "
        f"(fake tensors; built in {res['build_s']:.1f} s, run in "
        f"{res['run_s']:.1f} s): peak {info['peak_bytes'] / 1e9:.3f} GB "
        f"(argument {info['argument_bytes'] / 1e9:.3f} + temp "
        f"{info['temp_bytes'] / 1e9:.3f}) against 17a's measured "
        f"{peak17 / 1e9:.3f} GB [{smi}] ({info['peak_off']:+.4%}, within "
        f"{DRY_PEAK_TOL:.0%}); flops {res['flops'] / 1e12:.4f} TFLOP against"
        f" {want['expected'] / 1e12:.4f} = lm_bounds' "
        f"{want['lm_bounds'] / 1e12:.4f} + masked pairs "
        f"{want['masked_pairs'] / 1e12:.4f} + remat "
        f"{want['remat'] / 1e12:.4f} ({info['flops_off']:+.4%}, within "
        f"{DRY_FLOPS_TOL:.0%}); traffic {res['traffic_bytes'] / 1e12:.3f} "
        f"TB")
    if abs(info["peak_off"]) > DRY_PEAK_TOL:
        raise AssertionError(f"19a: the dry run's peak is {info['peak_off']:+.2%} "
                             f"from 17a's")
    if abs(info["flops_off"]) > DRY_FLOPS_TOL:
        raise AssertionError(f"19a: the dry run's flops are "
                             f"{info['flops_off']:+.2%} from the expected")
    return info


def dryrun_mesh_cell(torch, tag: str, arch: str, recs=None,
                     **cut) -> dict:
    """19b-19e, 19l: `arch` x train_4k (with `cut` applied to its config) on
    the 16 x 16 dry-run mesh to status ok, tensor-parallel over the model
    axis: its collective bytes by kind equal to the step's plan
    (dryrun.train_plan), its rank-0 peak at most the card's
    total_memory."""
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun, specs
    rec = dry_record(recs, tag, mesh_job(arch, **cut))
    if rec["status"] != "ok":
        raise AssertionError(f"{tag}: {rec}")
    shape = specs.SHAPES["train_4k"]
    plan = dryrun.train_plan(get_lm_config(arch, **cut), rec["microbatches"],
                             MeshShape(("data", "model"), (16, 16)),
                             shape["batch"], shape["seq"])
    got = {k: v for k, v in rec["collectives"]["bytes"].items() if v}
    card = torch.cuda.get_device_properties(0).total_memory
    peak = rec["memory"]["peak_mb"] * 2 ** 20
    log(f"[dryrun] {tag} {arch} x train_4k{f' {cut}' if cut else ''} on 16 "
        f"x 16 (rank 0 of 256 fake ranks, tensor-parallel over the model "
        f"axis, parameters gathered {rec['param_gather']}; M "
        f"{rec['microbatches']}, groups {rec['groups']}): status "
        f"ok, peak {rec['memory']['peak_mb']} MiB a rank = {peak:.0f} bytes "
        f"against the card's total_memory {card} (rules "
        f"{rec['rules_mb']['total']} MiB), flops {rec['hlo_flops']:.4e}, "
        f"collective bytes {got} against the plan {plan}; built in "
        f"{rec['lower_s']} s, run in {rec['compile_s']} s")
    if got != {k: float(v) for k, v in plan.items() if v}:
        raise AssertionError(f"{tag}: collective bytes {got} against the "
                             f"plan {plan}")
    if peak > card:
        raise AssertionError(f"{tag}: rank 0's peak {peak:.0f} bytes is "
                             f"over the card's {card}")
    return {k: rec[k] for k in ("memory", "rules_mb", "hlo_flops",
                                "hlo_traffic_bytes", "collectives",
                                "microbatches", "groups", "param_gather",
                                "lower_s", "compile_s")} | {
        "plan": plan, "cut": cut, "card_total_memory": card}


def dryrun_gather_at_use(torch, recs=None) -> dict:
    """19n: DRY_USE_ARCH x train_4k at full width and DRY_USE_LAYERS
    layers (remat, as published) on the 16 x 16 dry-run mesh, gathering
    each parameter at its use (the default) and with pregather (JAX's
    TP-only pregather_spec: once a step), each held to its plan by
    dryrun_mesh_cell; rank 0's peak at use below the pregather peak by at
    least the bytes of all blocks but the two largest in their computed
    layout (dryrun.block_bytes): pregather holds every block's gathered
    copy at once, the gather at use about two blocks'."""
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun
    cells = {mode: dryrun_mesh_cell(torch, f"19n {mode}", DRY_USE_ARCH,
                                    recs, **cut)
             for mode, cut in USE_CUTS.items()}
    gathers = {mode: cell["param_gather"] for mode, cell in cells.items()}
    blocks = sorted(dryrun.block_bytes(
        get_lm_config(DRY_USE_ARCH, n_layers=DRY_USE_LAYERS),
        MeshShape(("data", "model"), (16, 16))).values())
    bound = sum(blocks[:-2])
    peaks = {mode: cell["memory"]["peak_mb"] * 2 ** 20
             for mode, cell in cells.items()}
    fall = peaks["pregather"] - peaks["at use"]
    log(f"[dryrun] 19n {DRY_USE_ARCH} x train_4k at {DRY_USE_LAYERS} layers:"
        f" rank 0's peak {peaks['at use'] / 1e9:.3f} GB gathering at each "
        f"use, {peaks['pregather'] / 1e9:.3f} GB gathering once a step: "
        f"{fall / 1e9:.3f} GB lower, against the bound {bound / 1e9:.3f} "
        f"GB (all blocks but two, each {blocks[-1] / 1e9:.3f} GB a rank "
        f"in its computed layout)")
    if gathers != {"at use": "at each use", "pregather": "once a step"}:
        raise AssertionError(f"19n: the cells gathered {gathers}")
    if fall < bound:
        raise AssertionError(f"19n: the peak fell {fall:.0f} bytes, less "
                             f"than the blocks' {bound}")
    return {"cells": cells, "block_bytes": blocks, "bound_bytes": bound,
            "peak_fall_bytes": fall}


def dryrun_serve_cell(torch, tag: str, arch: str, shape: str, recs=None,
                      **over) -> dict:
    """19f-19k, 19m: `arch` x `shape` (a serving cell; `over` more config
    overrides) at full width and
    DRY_SERVE_LAYERS layers (an encoder-decoder's encoder too) on the 16
    x 16 dry-run mesh to status ok, served tensor-parallel through the
    mesh's steps on rank 0's held shards and cache: its collective bytes
    by kind equal to dryrun.serve_plan (the activations' collectives and
    the logits' all-gathers, no weight's), its rank-0 peak at most the
    card's total_memory; the held bytes (dryrun.held_bytes) beside JAX's
    rules."""
    from repro_torch.distributed.sharding import MeshShape
    from repro_torch.launch import dryrun, specs
    _, _, cut = job = serve_job(arch, shape, **over)
    rec = dry_record(recs, tag, job)
    if rec["status"] != "ok":
        raise AssertionError(f"{tag}: {rec}")
    sh = specs.SHAPES[shape]
    cfg = get_lm_config(arch, **cut)
    mesh = MeshShape(("data", "model"), (16, 16))
    plan = dryrun.serve_plan(cfg, sh["kind"], mesh, sh["batch"], sh["seq"])
    held = dryrun.held_bytes(cfg, sh["kind"], sh["batch"], sh["seq"], mesh)
    got = {k: v for k, v in rec["collectives"]["bytes"].items() if v}
    card = torch.cuda.get_device_properties(0).total_memory
    peak = rec["memory"]["peak_mb"] * 2 ** 20
    log(f"[dryrun] {tag} {arch} x {shape} {cut} on 16 x 16 (rank 0 of 256 "
        f"fake ranks, served tensor-parallel over the model axis; groups "
        f"{rec['groups']}): status ok, peak {rec['memory']['peak_mb']} MiB "
        f"a rank = {peak:.0f} bytes against the card's total_memory "
        f"{card}; held: parameters {held['params']} + cache "
        f"{held['cache']} bytes (JAX's rules {rec['rules_mb']['total']} "
        f"MiB); flops {rec['hlo_flops']:.4e}, collective bytes {got} "
        f"against the plan {plan}; built in {rec['lower_s']} s, run in "
        f"{rec['compile_s']} s")
    if got != {k: float(v) for k, v in plan.items() if v}:
        raise AssertionError(f"{tag}: collective bytes {got} against the "
                             f"plan {plan}")
    if peak > card:
        raise AssertionError(f"{tag}: rank 0's peak {peak:.0f} bytes is "
                             f"over the card's {card}")
    return {k: rec[k] for k in ("memory", "rules_mb", "hlo_flops",
                                "hlo_traffic_bytes", "collectives",
                                "groups", "lower_s", "compile_s")} | {
        "plan": plan, "held": held, "cut": cut, "card_total_memory": card}


def phase_dryrun(torch, smi, phase17) -> dict:
    """Phase 19: the dry run (launch/dryrun.py over op_analysis.py and a
    fake process group), which allocates none of the card's memory and
    launches no kernel: 19a against phase 17's measured step, 19b-19e
    the production mesh's train cells, dense, hybrid, ssm and encdec,
    19f-19k its serving cells: the LMs', the hybrid's, the ssm's and the
    encdec's; 19l and 19m a train and a prefill cell with sequence
    parallelism on; 19n a train cell gathering at each use and once a
    step. The cells run at once, DRY_HERE here and the others in DRY_JOBS
    child processes (dry_records), each of which reports its kernel
    launches and whether it initialised CUDA; the checks run here. Held
    to DRY_SECONDS."""
    from repro_torch.kernels import OPS, reset_launches
    free(torch)
    t0 = time.perf_counter()
    allocated = torch.cuda.memory_allocated()
    reset_launches()
    peak17 = float(phase17["launcher"]["peak_memory"].split()[0]) * 1e9
    seq = {"n_layers": DRY_SEQ_LAYERS, "seq_shard_acts": True}
    jobs = {"19b": mesh_job(TRAIN_ARCH), "19a": one_rank_job(),
            "19c": mesh_job(HY_ARCH, n_layers=DRY_HY_LAYERS),
            "19d": mesh_job(SSM_ARCH, n_layers=DRY_SSM_LAYERS),
            "19n at use": mesh_job(DRY_USE_ARCH, **USE_CUTS["at use"]),
            "19e": mesh_job(ED_ARCH, n_layers=DRY_ED_LAYERS,
                            n_encoder_layers=DRY_ED_LAYERS),
            "19n pregather": mesh_job(DRY_USE_ARCH,
                                      **USE_CUTS["pregather"]),
            "19l": mesh_job(TRAIN_ARCH, **seq),
            "19m": serve_job(HY_ARCH, "prefill_32k", **seq)} | {
        tag: serve_job(arch, shape) for tag, arch, shape in DRY_SERVE_CELLS}
    recs = dry_records(jobs)
    cells_s = time.perf_counter() - t0
    info = {"one_rank": dryrun_one_rank(torch, smi, peak17, recs),
            "mesh_cell": dryrun_mesh_cell(torch, "19b", TRAIN_ARCH, recs),
            "hybrid_cell": dryrun_mesh_cell(torch, "19c", HY_ARCH, recs,
                                            n_layers=DRY_HY_LAYERS),
            "ssm_cell": dryrun_mesh_cell(torch, "19d", SSM_ARCH, recs,
                                         n_layers=DRY_SSM_LAYERS),
            "encdec_cell": dryrun_mesh_cell(
                torch, "19e", ED_ARCH, recs, n_layers=DRY_ED_LAYERS,
                n_encoder_layers=DRY_ED_LAYERS),
            "serve_cells": {tag: dryrun_serve_cell(torch, tag, arch, shape,
                                                   recs)
                            for tag, arch, shape in DRY_SERVE_CELLS},
            "seq_train_cell": dryrun_mesh_cell(torch, "19l", TRAIN_ARCH,
                                               recs, **seq),
            "seq_prefill_cell": dryrun_serve_cell(
                torch, "19m", HY_ARCH, "prefill_32k", recs, **seq),
            "gather_at_use": dryrun_gather_at_use(torch, recs),
            "jobs": DRY_JOBS, "here": list(DRY_HERE), "cells_s": cells_s,
            "cell_cpu_s": sum(r["rec"]["lower_s"] + r["rec"]["compile_s"]
                              for r in recs.values()),
            "kernel_launches": {n: op.launches for n, op in OPS.items()},
            "child_launches": {tag: r["launches"] for tag, r in recs.items()
                               if tag not in DRY_HERE
                               and any(r["launches"].values())},
            "child_cuda": [tag for tag, r in recs.items()
                           if tag not in DRY_HERE and r["cuda_initialized"]],
            "card_total_memory": torch.cuda.get_device_properties(
                0).total_memory,
            "allocated_change": torch.cuda.memory_allocated() - allocated,
            "phase_s": time.perf_counter() - t0, "card": smi}
    log(f"[dryrun] phase 19 took {info['phase_s']:.1f} s (held to "
        f"{DRY_SECONDS} s), its {len(jobs)} cells {cells_s:.1f} s, "
        f"{', '.join(DRY_HERE)} here and the others in {DRY_JOBS} "
        f"processes ({info['cell_cpu_s']:.1f} s of cell time in all); the "
        f"card's total_memory "
        f"{info['card_total_memory']} bytes; device memory allocated by "
        f"the phase {info['allocated_change']} bytes; the port's kernels "
        f"launched {info['kernel_launches']} here and "
        f"{info['child_launches'] or 'none'} in the cells' processes, "
        f"CUDA initialised in {info['child_cuda'] or 'none'} of them")
    if (info["allocated_change"] or any(info["kernel_launches"].values())
            or info["child_launches"] or info["child_cuda"]):
        raise AssertionError("phase 19 allocated device memory or launched "
                             "a kernel")
    if info["phase_s"] > DRY_SECONDS:
        raise AssertionError(f"phase 19 took {info['phase_s']:.1f} s")
    return info


# Passes of phase 20's calls traced before the pass it checks. A trace
# taken after earlier profiler sessions of the process loses its first
# kernel records (18 of 70 late in a whole run on an H100; device_ms sees
# lost records too), so the checked pass is the last.
TRACE_WARM_PASSES = 2


def traced(torch, calls) -> list:
    """Each call of `calls` run once on the card under a torch.profiler
    (CUPTI) trace: the launches of the port's kernels that the trace
    shows, in order (contracts.traced_launches)."""
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.analysis import contracts
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for fn in calls:
            fn()
        torch.cuda.synchronize()
    with tempfile.TemporaryDirectory(dir=BUILD) as work:
        path = pathlib.Path(work) / "trace.json"
        prof.export_chrome_trace(str(path))
        events = json.loads(path.read_text())["traceEvents"]
    return contracts.traced_launches(events)


def phase_analysis(torch, dev, X) -> dict:
    """Phase 20: the port's static contract checker. The runner over
    src/repro_torch with its baseline (exit 0); every registry case of
    the seven kernels and their main-path shapes launched on the card
    under one torch.profiler trace: the trace's kernel, grid, block and
    shared memory (static + dynamic) of each launch equal to the plans
    the CPU derivation walks, declared == derived, shared memory within
    the budget and the budget within the card's opt-in limit. Returns
    the phase's summary, with each kernel's contract at its main shapes
    (modelled bytes, not measured ones)."""
    import contextlib
    import io
    from repro_torch.analysis import contracts, runner
    from repro_torch.kernels import _build, registry
    from repro_torch.kernels.extend_embed.ops import EXTEND_SMEM
    from repro_torch.kernels.fit_sketch.ops import FIT_SMEM
    t0 = time.perf_counter()
    buf = io.StringIO()
    with contextlib.chdir(ROOT):
        rc = runner.run(runner.DEFAULT_PATHS, out=buf)
    log("[analysis] " + buf.getvalue().strip().replace("\n", "\n[analysis] "))
    if rc:
        raise AssertionError(f"python -m repro_torch.analysis exited {rc}")
    lib = _build.library()
    sizes = {"extend_embed": (lib.rt_extend_embed_smem_bytes(), EXTEND_SMEM),
             "fit_sketch": (lib.rt_fit_sketch_smem_bytes(), FIT_SMEM)}
    if any(a != b for a, b in sizes.values()):
        raise AssertionError(f"shared memory of the library against the "
                             f"plans: {sizes}")
    static = ptxas_static_smem(
        (_build.build().parent / "build.log").read_text())
    optin = torch.cuda.get_device_properties(0).shared_memory_per_block_optin
    main = main_shape_inputs(torch, dev, X)
    calls = []                       # (contract, op, args, kw, what)
    for entry in registry.kernel_entries():
        contract = registry.get_contract(entry.name)
        for i, case in enumerate(entry.cases):
            args, kw = entry.build(np.random.default_rng(200 + i), case)
            calls.append((contract, entry.op,
                          [torch.from_numpy(a).to(dev) for a in args], kw,
                          f"case {case}"))
        calls += [(contract, entry.op, args, kw, f"main shape {j}")
                  for j, (args, kw) in enumerate(main[entry.name])]
        if entry.name == "fwht":
            column = torch.randn((FWHT_COLUMN_N, 1), device=dev)
            calls.append((contract, entry.op, [column], {},
                          f"column ({FWHT_COLUMN_N}, 1)"))
    one = [lambda c=c: c[1](*c[2], **c[3]) for c in calls]
    got = traced(torch, one * (1 + TRACE_WARM_PASSES))
    planned = sum(len(c[0].plan(*c[2], **c[3]).launches) for c in calls)
    lost = (1 + TRACE_WARM_PASSES) * planned - len(got)
    if not 0 <= lost <= TRACE_WARM_PASSES * planned:
        raise AssertionError(
            f"the trace shows {len(got)} launches of the port's kernels, "
            f"{1 + TRACE_WARM_PASSES} passes of the plans {planned} each: by "
            f"kernel {collections.Counter(g[0] for g in got)}")
    got = got[-planned:]
    facts, at = {}, 0
    for contract, _, args, kw, what in calls:
        plan = contract.plan(*args, **kw)
        want = [contracts.planned_launch(ln, static.get(ln.kernel, 0))
                for ln in plan.launches]
        seen, at = got[at:at + len(want)], at + len(want)
        if seen != want:
            raise AssertionError(f"{contract.name} {what}: the trace shows "
                                 f"{seen}, the plan {want}")
        declared, derived = contract.declared(plan), contracts.derive(plan)
        if declared != derived:
            raise AssertionError(f"{contract.name} {what}: declared "
                                 f"{declared}, the plan implies {derived}")
        smem = max(ln[3] for ln in seen)
        if not smem <= contract.smem_budget <= optin:
            raise AssertionError(f"{contract.name} {what}: {smem} B of "
                                 f"shared memory, budget "
                                 f"{contract.smem_budget}, the card's "
                                 f"opt-in limit {optin}")
        if what.startswith("main"):
            facts.setdefault(contract.name, []).append({
                "modelled_dram_bytes": declared["dram_bytes"],
                "bound_bytes": contract.bound_bytes(plan.shapes),
                "traced_smem_bytes": smem, "launches": len(seen)})
    for name, shapes in sorted(facts.items()):
        one = shapes[0]
        log(f"[analysis] {name}: every registry case and {len(shapes)} main "
            f"shapes launched as planned (trace); at the main shape the "
            f"modelled DRAM bytes {one['modelled_dram_bytes']} (declared == "
            f"derived), the bound's {one['bound_bytes']} "
            f"({one['modelled_dram_bytes'] / one['bound_bytes']:.4f}x), "
            f"shared memory {one['traced_smem_bytes']} B (trace) of "
            f"{registry.get_contract(name).smem_budget}")
    info = {"runner_rc": rc, "calls": len(calls), "traced_launches": len(got),
            "warm_pass_launches_lost": lost,
            "static_smem": static, "smem_optin": optin,
            "smem_budget": {n: registry.get_contract(n).smem_budget
                            for n in facts},
            "kernels": facts, "phase_s": time.perf_counter() - t0}
    log(f"[analysis] phase 20: {len(calls)} calls, {len(got)} traced "
        f"launches of the last of {1 + TRACE_WARM_PASSES} passes equal to "
        f"the plans ({lost} launches of the warm-up passes missing from "
        f"the trace); the card's opt-in shared memory "
        f"{optin} B a block; static shared memory {static}; "
        f"{info['phase_s']:.1f} s")
    return info


def phase_device(torch, kernels, inputs, model, Xq) -> dict:
    """Card time alone, from torch.profiler traces, taken last so that no
    earlier phase runs after the profiler: kmeans_assign at its main shape
    and ASSIGN_CASE; embed_assign, extend_embed_op alone and the unfused
    sequence at each width (into `kernels`); and the card's busy share
    while the six requests are served one by one, returned."""
    from repro_torch.kernels import registry
    from repro_torch.kernels.extend_embed.ops import extend_embed_op
    from repro_torch.serve import ComputePolicy, MicroBatcher
    assign, fold = (registry.get_kernel(n) for n in ("kmeans_assign",
                                                     "embed_assign"))
    (Yq, C), _ = inputs["kmeans_assign"]
    Yc, Cc = assign_case_inputs(torch, assign, Yq.device)
    res = kernels["kmeans_assign"]
    res["device_ms"] = device_ms(torch, lambda: assign.op(Yq, C))
    res["registry_case"]["device_ms"] = device_ms(
        torch, lambda: assign.op(Yc, Cc))
    (X, proj, Xb, C), kw = inputs["embed_assign"]
    unfused = unfused_assign(X, proj, C, kw)
    res = kernels["embed_assign"]
    for w in (BLOCK,) + SERVE_WIDTHS:
        xb = Xb[:, :w]
        at = res if w == BLOCK else res["serving_widths"][str(w)]
        at.update({
            "device_ms": device_ms(torch, lambda: fold.op(X, proj, xb, C,
                                                          **kw)),
            "extend_embed_device_ms": device_ms(
                torch, lambda: extend_embed_op(X, proj, xb, **kw)),
            "unfused_device_ms": device_ms(torch, lambda: unfused(xb))})
    batcher = MicroBatcher(model, policy=ComputePolicy())
    batcher.warm(REQUESTS)
    reqs, a = [], 0
    for b in REQUESTS:
        reqs.append(Xq[:, a:a + b])
        a += b
    host_ms, device = profiled(
        torch, lambda: [batcher.assign_batch(req) for req in reqs])
    busy_ms = sum(ms for _, ms in device.values())
    info = {"profiled_requests_host_ms": host_ms,
            "profiled_requests_device_ms": busy_ms,
            "profiled_requests_device_records": sum(
                n for n, _ in device.values()),
            "card_busy_share": busy_ms / host_ms if busy_ms else None}
    log(f"[device] kmeans_assign on the card "
        f"{kernels['kmeans_assign']['device_ms']} ms, at {ASSIGN_CASE} "
        f"{kernels['kmeans_assign']['registry_case']['device_ms']} ms; "
        "embed_assign / extend_embed_op / unfused on the card, ms: " +
        "; ".join(f"w={w}: {v['device_ms']} / {v['extend_embed_device_ms']}"
                  f" / {v['unfused_device_ms']}" for w, v in
                  [(BLOCK, res)] + list(res["serving_widths"].items()))
        + f"; the {len(reqs)} requests one by one under the profiler: host "
        f"{host_ms:.3f} ms, card {busy_ms:.3f} ms "
        f"({info['profiled_requests_device_records']} records)")
    return info


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device; the port's kernels run only on "
              "the card", file=sys.stderr)
        return 2
    if not (SRC / "repro_torch").is_dir():
        print(f"chip_smoke: no src/repro_torch beside {__file__}",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(SRC))
    # A phase whose world broke leaves through os._exit (launch/mesh.py).
    from repro_torch.launch.mesh import run_process
    run_process(smoke, torch)


def smoke(torch) -> int:
    """Every phase, then the kernels line and the last line."""
    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    build = phase_build()
    from repro_torch.data.synthetic import segmentation_proxy
    gen = torch.Generator(device=dev).manual_seed(0)
    Xall, yall = segmentation_proxy(gen, n=N_TRAIN + N_QUERY, p=P, k=K)
    X = Xall[:, :N_TRAIN].contiguous()
    kernels, inputs = phase_kernels(torch, dev, X)
    for name, facts in build.items():
        kernels[name].update(facts)
    summary = {}
    Xq = Xall[:, N_TRAIN:].contiguous()
    est, canon, fit_launches, summary["fit"] = phase_fit(
        torch, X, yall[:N_TRAIN])
    serve_launches, summary["serve"] = phase_serve(torch, est.model_, Xq)
    stream_launches, summary["stream"] = phase_stream(torch, X, Xq, canon)
    backend_launches, summary["backends"], widths = phase_backends(
        torch, X, yall[:N_TRAIN], Xq, est)
    for name, cases in widths.items():
        kernels[name]["landmark_widths"] = cases
    lifecycle_launches, summary["lifecycle"], gram_drift = phase_lifecycle(
        torch, est.model_, X, yall[:N_TRAIN], Xq, yall[N_TRAIN:])
    kernels["gram_stripe"]["drift_shape"] = gram_drift
    fleet_launches, summary["fleet"] = phase_fleet(torch, est.model_, Xq)
    dist_launches, summary["distributed"] = phase_distributed(
        torch, est, X, yall[:N_TRAIN], Xq, smi)
    launcher_launches, summary["launcher"] = phase_launcher(torch, smi)
    for name, held in summary["launcher"]["held"].items():
        kernels[name]["launcher_held"] = held
    summary["lm"] = phase_lm(torch, smi)
    summary["hybrid"] = phase_hybrid(torch, smi)
    summary["ssm"] = phase_ssm(torch, smi)
    summary["encdec"] = phase_encdec(torch, smi)
    summary["train"] = phase_train(torch, smi)
    mesh_launches, summary["train_mesh"] = phase_train_mesh(
        torch, smi, summary["train"])
    summary["dryrun"] = phase_dryrun(torch, smi, summary["train"])
    summary["analysis"] = phase_analysis(torch, dev, X)
    ident = summary["train_mesh"]["identities"]
    kernels["fwht"]["sketch_shape"] = {
        k: ident[k] for k in ("n_pad", "fwht_ms", "fwht_plain_ms",
                              "fwht_max_abs_err", "fwht_same_bits",
                              "bound_ms", "bound_by")}
    kernels["fwht"]["sketch_shape"].update(
        launches_a_step=2, launches=mesh_launches["fwht"],
        transform_ms=summary["train_mesh"]["sketch"]["transform_ms"])
    summary["serve"].update(phase_device(torch, kernels, inputs, est.model_,
                                         Xq))
    launches = {name: fit_launches[name] + serve_launches[name]
                + stream_launches[name] + backend_launches[name]
                + lifecycle_launches[name] + fleet_launches[name]
                + dist_launches[name] + launcher_launches[name]
                + mesh_launches.get(name, 0)
                for name in SOURCES}
    summary["launches"] = {"fit": fit_launches, "serve": serve_launches,
                           "stream": stream_launches,
                           "backends": backend_launches,
                           "lifecycle": lifecycle_launches,
                           "fleet": fleet_launches,
                           "distributed": dist_launches,
                           "launcher": launcher_launches,
                           "train_mesh": mesh_launches}
    log(f"[main path] launches {launches}")
    idle = [name for name in MAIN_PATH if launches[name] == 0]
    if idle:
        raise AssertionError(f"the main path never launched {idle}")
    line = []
    for name, (source, replaces) in SOURCES.items():
        res = kernels[name]
        line.append({"name": name, "route": "cuda", "source": source,
                     "replaces": replaces, "on_main_path": name in MAIN_PATH,
                     "launches": launches[name],
                     "max_abs_err": res.get("max_abs_err"),
                     "max_abs_err_parity_cases":
                         res.get("max_abs_err_parity_cases"),
                     "parity_cases": res.get("parity_cases"),
                     "ms": res.get("ms"), "kernel_ms": res.get("ms"),
                     "plain_ms": res.get("plain_ms"),
                     "bound_ms": res.get("bound_ms"),
                     "bound_us": res.get("bound_us"),
                     "bound_by": res.get("bound_by"),
                     "library_ms": res["library_ms"],
                     **{k: v for k, v in res.items()
                        if k.startswith(("linear_", "eig_"))
                        or k.endswith("library_shape")
                        or k.startswith(("tail_", "rbf_", "bound_t",
                                         "fp32_", "sass_", "ptxas", "tc_",
                                         "unfused_", "extend_embed_"))
                        or k in ("ms_back_to_back", "label_mismatches",
                                 "device_ms",
                                 "copy_ms", "read_ms", "library_note",
                                 "dynamic_smem_bytes", "serving_widths",
                                 "plan", "tiled", "deep", "tf32_matmul",
                                 "registry_case", "landmark_widths",
                                 "drift_shape", "launcher_held",
                                 "sketch_shape")}})
    log(json.dumps({"main_path": summary}))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--train-mesh-worker"]:
        sys.path.insert(0, str(SRC))
        from repro_torch.launch.mesh import run_process
        run_process(train_mesh_worker, sys.argv[2:])
    sys.exit(main())
