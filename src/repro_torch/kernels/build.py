"""Builds the port's CUDA kernels with nvcc at first use.

Each `csrc/<name>.cu` compiles, on its own, into a shared library with a
plain C interface (`build/repro_torch/<name>-<hash>.so`) that ctypes
loads; no PyTorch headers are involved, so a build takes seconds. The
file name carries a hash of the source, the csrc/ headers it includes
(`hopper.cuh`, the attention kernels' Hopper building blocks;
`ssd_scan.cuh`, the SSD kernels' prefix sum) and the
flags, so an edited source or header is rebuilt and a stale library is
never loaded.

Flags: `sm_90a`, `-O3`, and `-fmad=false`, with no fast math. The only
fused multiply-adds are the explicit `__fmaf_rn` calls: in the scheduler's
kernels exactly where the JAX reference rounds once (see
`numerics.fma_f32`), in the attention and SSD kernels in their dot products
and sums, whose contract is a tolerance.

Nothing here runs at import time: the CPU tests import every module on
machines that have no nvcc.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import re
import shutil
import subprocess
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCES = ("carbon_score", "route_score", "greedy_fill", "flash_attention", "flash_attention_bwd",
           "flash_decode", "ssd_chunk", "ssd_chunk_bwd", "threefry", "tap_scan", "tap_probe",
           "knapsack")
NVCC_FLAGS = (
    "-gencode", "arch=compute_90a,code=sm_90a",
    "-O3", "-std=c++17", "-fmad=false",
    "-Xptxas", "-v",
    "-shared", "-Xcompiler", "-fPIC",
)

_LIBS: dict[str, ctypes.CDLL] = {}


def build_dir() -> Path:
    """`build/repro_torch/` at the root of the checkout (in .gitignore)."""
    return Path(__file__).resolve().parents[3] / "build" / "repro_torch"


def nvcc() -> str:
    for cand in (
        os.environ.get("CUDA_HOME") and Path(os.environ["CUDA_HOME"]) / "bin" / "nvcc",
        Path("/usr/local/cuda/bin/nvcc"),
        shutil.which("nvcc"),
    ):
        if cand and Path(cand).is_file():
            return str(cand)
    raise RuntimeError("nvcc not found (set CUDA_HOME); the CUDA kernels cannot be built")


def _headers(src: bytes) -> list:
    """The csrc/ headers a source includes (`#include "x.cuh"`)."""
    return sorted(set(re.findall(rb'^#include "([\w.]+\.cuh)"', src, re.MULTILINE)))


def library_path(name: str) -> Path:
    src = (CSRC / f"{name}.cu").read_bytes()
    parts = [src] + [(CSRC / h.decode()).read_bytes() for h in _headers(src)]
    digest = hashlib.sha256(b"".join(parts) + " ".join(NVCC_FLAGS).encode()).hexdigest()[:16]
    return build_dir() / f"{name}-{digest}.so"


def build_all(names=SOURCES) -> dict:
    """Compiles every missing library in parallel (one nvcc per source,
    all started together) and returns {name: (seconds, ptxas report)};
    a library that was already built reports 0.0 seconds and the report
    kept beside it (`<library>.log`)."""
    out = {}
    procs = {}
    build_dir().mkdir(parents=True, exist_ok=True)
    t0 = time.perf_counter()
    for name in names:
        lib = library_path(name)
        if lib.exists():
            log = lib.with_suffix(".log")
            out[name] = (0.0, log.read_text() if log.exists() else "cached")
            continue
        tmp = lib.with_suffix(f".{os.getpid()}.tmp")
        cmd = [nvcc(), *NVCC_FLAGS, "-o", str(tmp), str(CSRC / f"{name}.cu")]
        procs[name] = (
            subprocess.Popen(cmd, stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True),
            tmp,
            lib,
        )
    for name, (proc, tmp, lib) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode != 0:
            raise RuntimeError(f"nvcc failed on csrc/{name}.cu (exit {proc.returncode}):\n{log}")
        lib.with_suffix(".log").write_text(log.strip())
        os.replace(tmp, lib)  # atomic: a concurrent loader never sees half a file
        out[name] = (time.perf_counter() - t0, log.strip())
    return out


def load(name: str) -> ctypes.CDLL:
    """The loaded library for csrc/<name>.cu, built first if missing."""
    lib = _LIBS.get(name)
    if lib is None:
        path = library_path(name)
        if not path.exists():
            build_all((name,))
        lib = ctypes.CDLL(str(path))
        _LIBS[name] = lib
    return lib


def check(lib: ctypes.CDLL, status: int, what: str) -> None:
    """Raises on a non-zero cudaError_t returned by a C entry point
    (every library exports `repro_error_string` to name it)."""
    if status != 0:
        lib.repro_error_string.restype = ctypes.c_char_p
        lib.repro_error_string.argtypes = [ctypes.c_int]
        msg = lib.repro_error_string(status).decode()
        raise RuntimeError(f"{what}: CUDA error {status} ({msg}) at launch")
