#!/usr/bin/env python3
"""Drive the PyTorch/CUDA port's main path on one GPU and check every kernel.

    python3 chip_smoke.py            # needs one CUDA card; no arguments

Phases, each fatal on failure:
  1. environment: torch version, the card's name and power limit
     (nvidia-smi), TF32 off;
  2. build the CUDA kernels of src/repro_torch/kernels/csrc;
  3. each kernel against its plain PyTorch version on the card, at every
     parity case of repro_torch.kernels.registry and at its main-path
     shape, with times (CUDA events, median of 7 after warm-up);
  4. fit: KernelKMeans on n = 100,000 points of the segmentation proxy
     (p = 19, K = 7, r = 2, l = 5, polynomial d = 2, onepass-srht,
     block 512) through the fused fit_sketch kernel, cross-checked against
     the canonical plain fit with the same sketch and init (sketch state,
     eigenvalues, subspace, labels), with the fit's own step times;
  5. serve: a MicroBatcher answers requests of 1 .. 2,500 held-out queries
     through extend_embed and kmeans_assign, checked against the two-pass
     plain Extender on the card;
then prints the `kernels` JSON line, the nvidia-smi line and, last,
{"ok": true, "device": {...}}. Exits non-zero, printing no result line,
without a CUDA card or without the repository around it.
"""
from __future__ import annotations

import json
import pathlib
import statistics
import subprocess
import sys
import time

import numpy as np

ROOT = pathlib.Path(__file__).resolve().parent
SRC = ROOT / "src"

# H100 SXM published peaks (NVIDIA data sheet, dense): fp32 outside the
# tensor cores and HBM3 bandwidth. bound = max(ops / FP32, bytes / HBM).
FP32_FLOPS = 67e12
HBM_BYTES_PER_S = 3.35e12

# The port's configuration: the paper's Fig. 3 widths at n = 100,000.
N_TRAIN, N_QUERY, P, K, R, OVERSAMPLING, BLOCK = 100_000, 4096, 19, 7, 2, 5, 512
RP = R + OVERSAMPLING
KERNEL = {"kind": "polynomial", "gamma": 0.0, "degree": 2}
REQUESTS = (1, 7, 64, 300, 1024, 2500)
SEED = 0

TOL = 2e-3           # registry tolerance of the fused kernels

# Kernels the main path launches; no path of the JAX package calls gram,
# which is ported for its tile and checked against its plain version.
MAIN_PATH = ("kmeans_assign", "extend_embed", "fit_sketch")

SOURCES = {
    "gram_stripe": ("src/repro_torch/kernels/csrc/gram.cu",
                    "src/repro/kernels/gram/gram.py:25"),
    "kmeans_assign": ("src/repro_torch/kernels/csrc/kmeans_assign.cu",
                      "src/repro/kernels/kmeans_assign/kmeans_assign.py:21"),
    "extend_embed": ("src/repro_torch/kernels/csrc/extend_embed.cu",
                     "src/repro/kernels/extend_embed/extend_embed.py:30"),
    "fit_sketch": ("src/repro_torch/kernels/csrc/fit_sketch.cu",
                   "src/repro/kernels/fit_sketch/fit_sketch.py:42"),
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


def max_err(torch, got, want) -> float:
    got = got if isinstance(got, tuple) else (got,)
    want = want if isinstance(want, tuple) else (want,)
    return max(float((g.float() - w.float()).abs().max()) if g.numel() else 0.0
               for g, w in zip(got, want))


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
    return bound(n * w * (2 * p + kappa_ops(kind, degree)),
                 4 * (p * n + p * w + n * w))


def assign_bound(n, r, k):
    return bound(n * k * (2 * r + 3) + (n + k) * 2 * r,
                 4 * (n * r + k * r) + 8 * n)


def extend_bound(p, n, r, w, kind, degree):
    return bound(n * w * (2 * p + kappa_ops(kind, degree) + 2 * r),
                 4 * (p * n + r * n + p * w + r * w))


def fit_bound(p, m, b, rp, kind, degree, masked=False):
    """Per (m, b) entry: the tile, 2r' each for new_rows and delta, and 3
    for the norms (one square shared by rn_rows and rn_cols, two adds),
    plus the V weight when a mask is passed (the main path passes none)."""
    per_entry = 2 * p + kappa_ops(kind, degree) + 4 * rp + 3 + int(masked)
    return bound(m * b * per_entry,
                 4 * (p * m + m * rp + p * b + b * rp
                      + b * rp + m * rp + m + b + m * int(masked)))


# -- phases -------------------------------------------------------------------

def phase_env(torch) -> str:
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    smi = nvidia_smi_line()
    log(f"[env] torch {torch.__version__} cuda {torch.version.cuda} | "
        f"{smi} | device count {torch.cuda.device_count()} | tf32 "
        f"matmul={torch.backends.cuda.matmul.allow_tf32} "
        f"cudnn={torch.backends.cudnn.allow_tf32}")
    return smi


def phase_build() -> None:
    from repro_torch.kernels import _build
    t0 = time.perf_counter()
    lib_path = _build.build()
    _build.library()
    log(f"[build] {len(_build.sources())} sources -> {lib_path.name} in "
        f"{time.perf_counter() - t0:.1f} s")
    for line in (lib_path.parent / "build.log").read_text().splitlines():
        if "Used" in line or "spill" in line and "0 bytes spill" not in line:
            log(f"[build] {line.strip()}")


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
    return {
        "gram_stripe": [((X, Xb), kw)],
        "fit_sketch": [((X, Omega, Xb, Omega[N_TRAIN - BLOCK:].contiguous()),
                        kw),
                       ((X, Omega, Xt, Omega[N_TRAIN - 160:].contiguous()),
                        kw)],
        "extend_embed": [((X, proj, Xb), kw)],
        "kmeans_assign": [((Yq, cents), {})],
    }


def phase_kernels(torch, dev, X) -> dict:
    from repro_torch.kernels import registry
    from repro_torch.kernels.gram.ref import gram_stripe_ref
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
            registry.compare(entry, got, want)
            worst_case = max(worst_case, max_err(torch, got, want))
            log(f"[kernels] {entry.name} case {case} ok "
                f"max_abs_err {max_err(torch, got, want):.3e}")
        for args, kw in main[entry.name]:
            got = entry.op(*args, **kw)
            torch.cuda.synchronize()
            want = entry.ref(*args, **kw)
            registry.compare(entry, got, want)
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
        if entry.name == "gram_stripe":
            Xa, Xba = args
            res.update(gram_bound(P, N_TRAIN, BLOCK, "polynomial", 2))
            lin = {"kind": "linear"}
            got = entry.op(Xa, Xba, **lin)
            registry.compare(entry, got, gram_stripe_ref(Xa, Xba, **lin))
            res["linear_ms"] = cuda_ms(torch, lambda: entry.op(Xa, Xba, **lin))
            res["linear_library_ms"] = cuda_ms(
                torch, lambda: torch.mm(Xa.T, Xba))
        elif entry.name == "fit_sketch":
            res.update(fit_bound(P, N_TRAIN, BLOCK, RP, "polynomial", 2))
        elif entry.name == "extend_embed":
            res.update(extend_bound(P, N_TRAIN, R, BLOCK, "polynomial", 2))
        else:
            res.update(assign_bound(1024, R, K))
        log(f"[kernels] {entry.name} main shape: kernel {res['ms']:.4f} ms, "
            f"plain {res['plain_ms']:.4f} ms, bound {res['bound_ms']:.4f} ms "
            f"({res['bound_by']})")
        results[entry.name] = res
    return results


def subspace_gap(torch, U1, U2) -> float:
    """||U1 U1^T - U2 U2^T||_F for orthonormal (n, r) bases, without the
    n x n products: 2r - 2 ||U1^T U2||_F^2 under the square root."""
    r = U1.shape[1]
    g = torch.linalg.norm((U1.T.double() @ U2.double())) ** 2
    return float(torch.sqrt(torch.clamp(2 * r - 2 * g, min=0.0)))


def estimator_args():
    return dict(k=K, r=R, kernel="polynomial",
                kernel_params={"gamma": KERNEL["gamma"],
                               "degree": KERNEL["degree"]},
                backend="onepass-srht",
                backend_params={"oversampling": OVERSAMPLING}, block=BLOCK,
                device="cuda")


def phase_fit(torch, X, y) -> tuple:
    """The main path's fit through the fused fit_sketch kernel, checked
    against the canonical plain fit with the same sketch and init."""
    from repro_torch.api import KernelKMeans
    from repro_torch.core.metrics import clustering_accuracy
    from repro_torch.core.sketch import SRHT
    from repro_torch.kernels import OPS, reset_launches
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
    if not (bool(torch.isfinite(est.embedding_).all())
            and tuple(est.embedding_.shape) == (R, N_TRAIN)):
        raise AssertionError("fit embedding is not finite (r, n)")
    m = est.model_
    sketch = SRHT(signs=m.sketch_signs, rows=m.sketch_rows, n=N_TRAIN,
                  n_pad=int(m.sketch_signs.shape[0]))
    t0 = time.perf_counter()
    canon = KernelKMeans(**estimator_args(), policy=None).fit(
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
    info = {"fit_s": fit_s, "canonical_fit_s": canon_s,
            "fit_sketch_launches": launches["fit_sketch"],
            "block_updates": updates, "eigvals": est.eigvals_.tolist(),
            "eigval_max_abs_err_vs_canonical": eig_err,
            "subspace_gap_vs_canonical": gap,
            **{f"{k}_max_abs_err_vs_canonical": v
               for k, v in state_err.items()},
            "label_agreement_vs_canonical": agree,
            "accuracy_vs_generating_labels": acc,
            "breakdown_s": est.fit_times_}
    log(f"[fit] n={N_TRAIN} fused fit {fit_s:.3f} s ({updates} fit_sketch "
        f"launches), canonical plain fit {canon_s:.3f} s; eigvals "
        f"{est.eigvals_.tolist()} (max abs diff {eig_err:.2e}), subspace gap "
        f"{gap:.2e}, stream_w / stream_row_norms2 max abs diff "
        f"{state_err['stream_w']:.2e} / {state_err['stream_row_norms2']:.2e}"
        f", label agreement {agree:.4f}, accuracy vs generating labels "
        f"{acc:.4f}")
    log("[fit] breakdown of the fused fit (KernelKMeans.fit_times_, CUDA "
        "events) " + ", ".join(f"{k} {v:.4f} s"
                               for k, v in est.fit_times_.items()))
    return est, launches, info


def phase_serve(torch, model, Xq) -> tuple:
    """Requests through a MicroBatcher on the fused kernels, checked
    against the two-pass plain Extender on the card."""
    from repro_torch.kernels import OPS, reset_launches
    from repro_torch.kernels.registry import assign_compare
    from repro_torch.serve import ComputePolicy, Extender, MicroBatcher
    batcher = MicroBatcher(model, policy=ComputePolicy())
    batcher.warm(REQUESTS)
    offs = [0]
    for b in REQUESTS:
        offs.append(offs[-1] + b)
    reqs = [Xq[:, a:b] for a, b in zip(offs, offs[1:])]
    torch.cuda.synchronize()
    reset_launches()
    latency = {b: [] for b in REQUESTS}
    drain_s = []
    for _ in range(5):
        for b, req in zip(REQUESTS, reqs):
            t0 = time.perf_counter()
            batcher.assign_batch(req)          # returns host arrays: synced
            latency[b].append(time.perf_counter() - t0)
        t0 = time.perf_counter()
        tickets = [batcher.submit(req) for req in reqs]
        out = batcher.drain()
        drain_s.append(time.perf_counter() - t0)
    launches = {name: op.launches for name, op in OPS.items()}
    for name in ("extend_embed", "kmeans_assign"):
        if launches[name] == 0:
            raise AssertionError(f"serving never launched {name}")
    got = (np.concatenate([out[t][0] for t in tickets]),
           np.concatenate([out[t][1] for t in tickets]))
    Xcat = Xq[:, :offs[-1]]
    plain = Extender(model, policy=ComputePolicy(embed_fused=False,
                                                 assign_fused=False))
    want = plain.assign(Xcat)
    assign_compare(got, want, TOL, TOL)
    emb_err = float((Extender(model, policy=ComputePolicy()).embed(Xcat)
                     - plain.embed(Xcat)).abs().max())
    if emb_err > TOL * (1 + float(plain.embed(Xcat).abs().max())):
        raise AssertionError(f"fused embeddings differ by {emb_err}")
    total = offs[-1]
    qps = total / statistics.median(drain_s)
    info = {"queries": total, "drain_queries_per_s": qps,
            "drain_s_median": statistics.median(drain_s),
            "latency_ms_median": {str(b): 1e3 * statistics.median(v)
                                  for b, v in latency.items()},
            "label_mismatch_vs_two_pass": float(
                (got[0] != want[0].cpu().numpy()).mean()),
            "embed_max_abs_err_vs_two_pass": emb_err}
    log(f"[serve] {len(REQUESTS)} requests, {total} queries: coalesced "
        f"drain {qps:.0f} queries/s; per-request latency ms " + ", ".join(
            f"{b}: {1e3 * statistics.median(v):.3f}"
            for b, v in latency.items())
        + f"; embed max abs diff vs two-pass {emb_err:.2e}")
    return launches, info


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
    dev = torch.device("cuda", 0)
    smi = phase_env(torch)
    phase_build()
    from repro_torch.data.synthetic import segmentation_proxy
    gen = torch.Generator(device=dev).manual_seed(0)
    Xall, yall = segmentation_proxy(gen, n=N_TRAIN + N_QUERY, p=P, k=K)
    X = Xall[:, :N_TRAIN].contiguous()
    kernels = phase_kernels(torch, dev, X)
    summary = {}
    est, fit_launches, summary["fit"] = phase_fit(torch, X, yall[:N_TRAIN])
    serve_launches, summary["serve"] = phase_serve(
        torch, est.model_, Xall[:, N_TRAIN:].contiguous())
    launches = {name: fit_launches[name] + serve_launches[name]
                for name in SOURCES}
    log(f"[main path] launches {launches}")
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
                     **{k: res[k] for k in ("linear_ms", "linear_library_ms")
                        if k in res}})
    log(json.dumps({"main_path": summary}))
    log(json.dumps({"kernels": line}))
    log(smi)
    log(json.dumps({"ok": True, "device": {
        "platform": "gpu", "kind": torch.cuda.get_device_name(0),
        "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
