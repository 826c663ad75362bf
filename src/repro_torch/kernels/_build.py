"""Build the CUDA kernels of ``kernels/csrc`` and bind them with ctypes.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc`` process (all
started together) for ``sm_90a`` and linked into one shared library with
a plain C interface, loaded with ``ctypes``. The library is built on
first use into ``build/repro_torch/<hash>/`` at the root of the checkout,
keyed by a hash of the sources and flags, so an edited source rebuilds
and an unchanged one loads at once.

Nothing here runs at import time: the CPU tests import every module on a
machine without ``nvcc``.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import pathlib
import shutil
import subprocess
import threading
from typing import Optional

CSRC = pathlib.Path(__file__).resolve().parent / "csrc"
REPO_ROOT = pathlib.Path(__file__).resolve().parents[3]
BUILD_ROOT = REPO_ROOT / "build" / "repro_torch"
LIB_NAME = "librepro_torch_kernels.so"

NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-O3",
              "-std=c++17", "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_LL = ctypes.c_longlong
_F = ctypes.c_float

# argtypes of every C entry point (pointers and the stream as c_void_p, so
# ctypes never cuts a 64-bit address to an int).
SIGNATURES = {
    "rt_gram_stripe": (_P, _LL, _I, _P, _LL, _I, _I, _I, _F, _I, _I, _I, _I,
                       _I, _P, _P),
    "rt_kmeans_assign": (_P, _I, _I, _P, _I, _P, _P, _P),
    "rt_extend_embed": (_P, _LL, _I, _P, _LL, _I, _P, _LL, _I, _I, _I, _F,
                        _I, _I, _I, _I, _P, _P, _P, _I, _P, _P, _P),
    "rt_extend_embed_smem_bytes": (),
    "rt_fit_sketch": (_P, _LL, _I, _P, _I, _P, _LL, _I, _P, _P, _I, _I, _F,
                      _I, _I, _I, _P, _P, _P, _P),
    "rt_fit_sketch_smem_bytes": (),
    "rt_fwht": (_P, _P, _LL, _I, _P, _P, _I, _I, _F, _P),
    "rt_fwht_rows": (_P, _P, _LL, _I, _I, _F, _P),
    "rt_srht_t_pass": (_P, _LL, _P, _P, _I, _LL, _P, _P, _P, _P, _I, _I,
                       _I, _I, _F, _I, _P),
}

_lock = threading.Lock()
_lib: Optional[ctypes.CDLL] = None


def sources() -> list:
    return sorted(CSRC.glob("*.cu"))


def _digest() -> str:
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for path in sorted(CSRC.iterdir()):
        if path.suffix in (".cu", ".cuh"):
            h.update(path.name.encode())
            h.update(path.read_bytes())
    return h.hexdigest()[:16]


def _nvcc() -> str:
    found = shutil.which("nvcc")
    if found:
        return found
    default = pathlib.Path("/usr/local/cuda/bin/nvcc")
    if default.exists():
        return str(default)
    raise RuntimeError("nvcc not found: the CUDA kernels of repro_torch "
                       "build only on a machine with the CUDA toolkit")


def build(out_dir: Optional[pathlib.Path] = None) -> pathlib.Path:
    """Compile every source in parallel and link the shared library.

    Returns the library path; the compiler's output (with ``-Xptxas -v``:
    registers, shared memory and spills of each kernel) is kept beside it
    in ``build.log``. Each process compiles in a directory of its own and
    renames the finished library into place, so concurrent first uses
    (test workers) never see half a library.
    """
    out_dir = out_dir or BUILD_ROOT / _digest()
    lib_path = out_dir / LIB_NAME
    if lib_path.exists():
        return lib_path
    work = out_dir / f"work-{os.getpid()}"
    work.mkdir(parents=True, exist_ok=True)
    nvcc = _nvcc()
    procs = []
    for src in sources():
        obj = work / (src.stem + ".o")
        cmd = [nvcc, *NVCC_FLAGS, "-I", str(CSRC), "-c", str(src),
               "-o", str(obj)]
        procs.append((src, obj, subprocess.Popen(
            cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT)))
    log, failed = [], []
    for src, _, proc in procs:
        out, _ = proc.communicate()
        log.append(f"== {src.name} (rc {proc.returncode})\n"
                   f"{out.decode(errors='replace')}")
        if proc.returncode:
            failed.append(src.name)
    (work / "build.log").write_text("\n".join(log))
    if failed:
        raise RuntimeError(f"nvcc failed on {failed}:\n" + "\n".join(log))
    link = subprocess.run(
        [nvcc, "-gencode", "arch=compute_90a,code=sm_90a", "-shared",
         "-o", str(work / LIB_NAME), *[str(obj) for _, obj, _ in procs]],
        stdout=subprocess.PIPE, stderr=subprocess.STDOUT)
    if link.returncode:
        raise RuntimeError("nvcc link failed:\n"
                           + link.stdout.decode(errors="replace"))
    os.replace(work / "build.log", out_dir / "build.log")
    os.replace(work / LIB_NAME, lib_path)      # atomic rename
    shutil.rmtree(work, ignore_errors=True)
    return lib_path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first use."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(str(build()))
            for name, argtypes in SIGNATURES.items():
                fn = getattr(lib, name)
                fn.argtypes = argtypes
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib


def check(rc: int, what: str) -> None:
    """Raise if a C entry point returned a CUDA error code."""
    if rc != 0:
        raise RuntimeError(f"{what}: CUDA launch failed with error {rc}")
