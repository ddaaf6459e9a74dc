"""`ssd_chunk_intra_bwd` at mamba2-1.3B's training shape, for comparing two
versions of its kernel on one card.

    PYTHONPATH=src python3 -m repro_torch.launch.ssd_profile [--old-bwd FILE]

Builds csrc/ssd_chunk_bwd.cu and, at the training shape (B 8, nc 16, l
256, H 64, P 64, N 128, seeded inputs and cotangents) under the init's,
strong and weak decays, holds the kernel to its plain version (chip_smoke
3d's bound, |err| <= 2e-5 max(1, sum|terms|) + 2e-5 |plain| with each
output's sum|terms| from `ssd_chunk_intra_bwd_terms`, two runs bitwise
equal) and prints each output's share of that bound beside the share
that the kernel's arithmetic emulated (`ssd_chunk_intra_bwd_tc`) reaches
on the same inputs. At the init's decays it times the kernel: ms a call
from CUDA-graph replay (the median of the replays between CUDA events)
from a cold L2 (a 128 MB read before each call, its own time subtracted)
and warm (back to back), per eager call, its kernels' device time by
name from torch.profiler, and the memory a call allocates.

With --old-bwd FILE, a ssd_chunk_bwd.cu with the C interface of commit
05d4b34 (scratch G, dG and ci; its design on the float32 CUDA cores) is
built beside the package, held to the same bound, and timed against the
package's kernel in turns (old, new, new, old), with its kernels' device
times. There is no .git on the card: copy it first,
    git show 05d4b34:src/repro_torch/kernels/csrc/ssd_chunk_bwd.cu > build/old_ssd_chunk_bwd.cu

Prints one JSON line, with ptxas's registers and spills of every entry,
the function's bounds (`ssd_chunk.bwd_bounds_ms`), and the nvidia-smi
name and power limit. Runs on the CUDA card only.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import subprocess
import sys
from pathlib import Path

import torch
import torch.nn.functional as F

from repro_torch.kernels import build
from repro_torch.kernels import ssd_chunk as sdc
from repro_torch.launch import profile_util as pu

SEED = 0
SSD_TOL = 2e-5  # chip_smoke.py's
FP32_OPS_PER_S, TF32_OPS_PER_S, HBM_BYTES_PER_S = 67e12, 495e12, 3.35e12  # H100 SXM data sheet
TRAIN = (8, 16, 256, 64, 64, 128)  # B, nc, l, H, P, N
ENTRIES = ("bwd_scores_tc", "bwd_head_tc", "bwd_dgsum", "bwd_bc_tc")
OLD_ENTRIES = ("bwd_scores_kernel", "bwd_head_kernel", "bwd_dg_kernel", "bwd_bc_kernel")
OUTPUTS = ("da", "dx", "dB", "dC")


def inputs(dev, g, decays):
    """chip_smoke.py 3d's inputs at the training shape: decays "strong" a =
    -softplus(N(0,1)), "weak" 0.01 x that, "init" dt * A with the repo's
    init; x, B, C and the cotangents normal."""
    B, nc, l, H, P, N = TRAIN
    sp = F.softplus(torch.randn((B, nc, l, H), generator=g, device=dev))
    if decays == "strong":
        a = -sp
    elif decays == "weak":
        a = -0.01 * sp
    else:
        a = sp * -(torch.rand((H,), generator=g, device=dev) * 15.0 + 1.0)
    x = torch.randn((B, nc, l, H, P), generator=g, device=dev)
    Bm, Cm = (torch.randn((B, nc, l, N), generator=g, device=dev) for _ in range(2))
    dy = torch.randn((B, nc, l, H, P), generator=g, device=dev)
    dS = torch.randn((B, nc, H, N, P), generator=g, device=dev)
    dtot = torch.randn((B, nc, H), generator=g, device=dev)
    return a.contiguous(), x, Bm, Cm, dy, dS, dtot


def of_bound(got, want, terms) -> dict:
    """Each output's largest |err| / 3d's bound."""
    return {name: float(((gv - wv).abs() / (SSD_TOL * tv.clamp_min(1.0)
                                            + SSD_TOL * wv.abs())).max())
            for name, gv, wv, tv in zip(OUTPUTS, got, want, terms)}


def held(fn, args, what) -> dict:
    """fn's outputs against the plain backward within 3d's bound, and a
    second run bitwise the first."""
    got, again = fn(*args), fn(*args)
    want = sdc.ssd_chunk_intra_bwd_plain(*args)
    terms = sdc.ssd_chunk_intra_bwd_terms(*args)
    torch.cuda.synchronize()
    for name, gv, av in zip(OUTPUTS, got, again):
        if not (torch.isfinite(gv).all() and torch.equal(gv.view(torch.int32),
                                                         av.view(torch.int32))):
            raise SystemExit(f"ssd_profile: {what}: {name} not finite, or two runs differ")
    shares = of_bound(got, want, terms)
    if max(shares.values()) > 1.0:
        raise SystemExit(f"ssd_profile: {what}: beyond 3d's bound ({shares})")
    return {"max_abs_err": max(float((gv - wv).abs().max()) for gv, wv in zip(got, want)),
            "of_bound": shares}


def old_bwd(path: Path):
    """Commit 05d4b34's backward built from `path` beside the package's
    libraries -> (a call with the new wrapper's arguments, ptxas's
    report)."""
    try:
        log = pu.use_edited(build, "ssd_chunk_bwd", path.read_text(), "old_ssd_bwd")
        lib = build.load("ssd_chunk_bwd")
    finally:
        pu.use_package(build, "ssd_chunk_bwd")  # the wrapper keeps the package's
    lib.ssd_chunk_bwd_launch.argtypes = [ctypes.c_void_p] * 14 + [ctypes.c_int] * 6 + [
        ctypes.c_void_p]
    lib.ssd_chunk_bwd_launch.restype = ctypes.c_int

    def run(a, x, Bm, Cm, dy, dS, dtot):
        B, nc, l, H = a.shape
        outs = (torch.empty_like(a), torch.empty_like(x), torch.empty_like(Bm),
                torch.empty_like(Cm))
        G, dG = (torch.empty((B, nc, l, l), device=a.device) for _ in range(2))
        ci = torch.empty((B, nc, H, l), device=a.device)
        status = lib.ssd_chunk_bwd_launch(
            *(t.data_ptr() for t in (a, x, Bm, Cm, dy, dS, dtot, *outs, G, dG, ci)), B, nc, l, H,
            x.shape[-1], Bm.shape[-1], torch.cuda.current_stream().cuda_stream)
        if status:
            raise SystemExit(f"ssd_profile: the old backward returned {status}")
        return outs

    return run, log


def ptxas(log: str, entries=ENTRIES) -> list:
    return [ln for e in entries for ln in pu.ptxas(log, e, None)]


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--old-bwd", default=None, type=Path,
                    help="a ssd_chunk_bwd.cu of commit 05d4b34 to time in turns")
    args = ap.parse_args(argv)
    if not torch.cuda.is_available():
        print("ssd_profile: no CUDA device", file=sys.stderr)
        return 2
    torch.backends.cuda.matmul.allow_tf32 = False  # the plain version in full float32
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    built = build.build_all(("ssd_chunk_bwd",))
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)
    line = {"device": torch.cuda.get_device_name(0), "torch": torch.__version__,
            "ptxas": ptxas(built["ssd_chunk_bwd"][1]),
            "bounds_ms": sdc.bwd_bounds_ms(TRAIN, FP32_OPS_PER_S, TF32_OPS_PER_S,
                                           HBM_BYTES_PER_S)}
    for decays in ("strong", "weak", "init"):  # the init's inputs stay for the timing
        bargs = inputs(dev, g, decays)
        line[decays] = held(sdc.ssd_chunk_intra_bwd_cuda, bargs, f"{decays} decays")
        line[decays]["emulated_of_bound"] = of_bound(
            sdc.ssd_chunk_intra_bwd_tc(*bargs), sdc.ssd_chunk_intra_bwd_plain(*bargs),
            sdc.ssd_chunk_intra_bwd_terms(*bargs))
        print(f"  {decays} decays: {line[decays]}", flush=True)

    def new():
        return sdc.ssd_chunk_intra_bwd_cuda(*bargs)

    train = line["init"]
    train.update(pu.times(torch, new, reps=5, inner=2))
    torch.cuda.reset_peak_memory_stats()
    base = torch.cuda.memory_allocated()
    new()
    torch.cuda.synchronize()
    train["call_peak_mb"] = (torch.cuda.max_memory_allocated() - base) / 1e6
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    new()
    start.record()
    for _ in range(5):
        new()
    end.record()
    end.synchronize()
    train["eager_ms"] = start.elapsed_time(end) / 5
    train["kernels_ms"] = pu.kernel_ms(torch, new)
    if args.old_bwd is not None:
        run, log = old_bwd(args.old_bwd)

        def old():
            return run(*bargs)

        line["old"] = {**held(run, bargs, "the old backward"), "ptxas": ptxas(log, OLD_ENTRIES),
                       "kernels_ms": pu.kernel_ms(torch, old)}
        line["turns"] = [(name, pu.times(torch, old if name == "old" else new, reps=3, inner=1))
                         for name in ("old", "new", "new", "old")]
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
