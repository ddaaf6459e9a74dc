"""The attention kernels at chip_smoke.py phase 7's shapes, for comparing
two versions of the package on one card.

    python3 src/repro_torch/launch/attention_profile.py [--src DIR] [--label NAME]
        [--split] [--old-bwd FILE]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported (by default this checkout's `src`), so the script times the
package of another checkout (its `src`) as well as this one; run it once
per version, in turns (old, new, new, old), to compare two versions on
one card. Each version builds its own kernels (`build/repro_torch/`
beside its `src`).

It times, bf16, seeded random inputs, ms a call from CUDA-graph replay
(the median of the replays between CUDA events), from a cold L2 (a 128 MB
read before each call, its own time subtracted) and warm (back to back):
  - `flash_attention_cuda` at PaliGemma-3B's prefill (B 8, H 8 on K 1, S
    4096, hd 256, prefix 256: `attention_tc<256>`) and GLM-4-9B's (B 8, H
    32 on K 2, S 4096, hd 128, causal: `attention_tc<128>`);
  - `flash_decode_cuda` at PaliGemma-3B's last decode step (B 8, H 8 on K
    1, a 4161-slot cache, pos 4160: `decode_tc<256>`) and GLM-4-9B's (B 8,
    H 32 on K 2: `decode_tc<128>`);
  - with `--split`, where the time of `decode_tc<256>` goes: copies of the
    package's flash_decode.cu that stop after the loads (every tile loaded,
    nothing computed) and before the combine (the split's partial written,
    no ticket), built beside and timed at the same shape; the source's
    `// SPLIT ...` lines mark the cuts (a source without them is refused);
  - `flash_attention_bwd_cuda` at Qwen1.5-0.5B's training shape (B 8, H 16
    on K 16, S 4096, hd 64, causal), from the forward's statistics, with
    its three kernels' device times from torch.profiler, and the forward
    there with and without the statistics;
  - with `--old-bwd FILE`, a flash_attention_bwd.cu with the interface of
    commit 0dde21f (the float32 scratch, no statistics: its CUDA-core
    kernel) built beside the package and timed against the package's
    backward in turns (old, new, new, old) at that shape. The copy is
    taken from git before the run, into the ignored build directory, as
    `git show 0dde21f:src/repro_torch/kernels/csrc/flash_attention_bwd.cu
    > build/old_flash_attention_bwd.cu`.
Every kernel is held to its plain version (chip_smoke.py's tolerances:
bf16 1e-4 + 2^-7 |plain| forward; each backward gradient's error from the
float32 plain gradient within 1.5x the plain bf16 path's) before it is
timed. It prints one JSON line, with the ptxas registers and spills of
the hd 256 and hd 128 forward instances and of the backward's bf16
entries, and the nvidia-smi name and power limit. The library yardstick
at the same shapes is chip_smoke.py phase 7's: no module of the package
names a library attention call (tests/test_torch_hygiene.py).
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import inspect
import json
import subprocess
import sys
from pathlib import Path

_spec = importlib.util.spec_from_file_location(  # beside this file: --src may lack it
    "profile_util", Path(__file__).with_name("profile_util.py"))
pu = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(pu)

SEED = 0
B, S_PROMPT, S_CACHE = 8, 4096, 4161
SHAPES = {  # label: (H, K, hd, mask, prefix_len)
    "hd256": (8, 1, 256, "prefix", 256),
    "hd128": (32, 2, 128, "causal", 0),
}
ATOL, RTOL = 1e-4, 2.0 ** -7
TRAIN = (16, 16, 4096, 64)  # Qwen1.5-0.5B's training attention: H, K, S, hd (causal, B 8)
BWD_RATIO = 1.5  # chip_smoke.py's ATTN_BWD_RATIO
BWD_ENTRIES = ("bwd_delta", "bwd_dkdv_tc", "bwd_dq_tc")


def _held(torch, got, want, what):
    torch.cuda.synchronize()
    diff = (got.float() - want.float()).abs()
    if not bool((diff <= ATOL + RTOL * want.float().abs()).all()):
        raise SystemExit(f"attention_profile: {what} differs from its plain version by "
                         f"{float(diff.max()):.3e}")
    return float(diff.max())


def _held_bwd(torch, fa, got, q, k, v, g) -> list:
    """Each gradient's max abs error from the float32 plain gradient,
    within BWD_RATIO x the plain bf16 path's (chip_smoke.py 3c's gate)."""
    torch.cuda.synchronize()
    exact = fa.flash_attention_bwd_plain(q.float(), k.float(), v.float(), g.float())
    plain = fa.flash_attention_bwd_plain(q, k, v, g)
    errs = [float((a.float() - b).abs().max()) for a, b in zip(got, exact)]
    errs_p = [float((a.float() - b).abs().max()) for a, b in zip(plain, exact)]
    if not all(e <= BWD_RATIO * p for e, p in zip(errs, errs_p)):
        raise SystemExit(f"attention_profile: backward errors {errs} against the plain bf16 "
                         f"path's {errs_p}")
    return errs


def _old_bwd(torch, build, fa, path: Path, q, k, v, g):
    """Commit 0dde21f's backward (its C interface: a float32 [3, B, H, S]
    scratch, no statistics) built from `path` beside the package's
    libraries and loaded on its own -> (a call on q, k, v, g that returns
    its gradients, ptxas's report)."""
    try:
        log = pu.use_edited(build, "flash_attention_bwd", path.read_text(), "old_bwd")
        lib = build.load("flash_attention_bwd")
    finally:
        pu.use_package(build, "flash_attention_bwd")  # the wrappers keep the package's
    lib.flash_attention_bwd_launch.argtypes = (
        [ctypes.c_void_p] * 8 + [ctypes.c_int] * 7
        + [ctypes.POINTER(ctypes.c_longlong), ctypes.c_int, ctypes.c_int, ctypes.c_float,
           ctypes.c_void_p])
    B, H, S, hd = q.shape
    outs = (torch.empty_like(q), torch.empty_like(k), torch.empty_like(v))
    stats = torch.empty((3, B, H, S), dtype=torch.float32, device=q.device)
    strides = (ctypes.c_longlong * 21)(*(st for x in (q, k, v, g, *outs)
                                         for st in fa._kernel_strides(x)))

    def run():
        status = lib.flash_attention_bwd_launch(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), g.data_ptr(), *(x.data_ptr() for x in outs),
            stats.data_ptr(), 1, B, H, k.shape[1], S, S, hd, strides, 0, 0, 1.0 / hd ** 0.5,
            torch.cuda.current_stream().cuda_stream)
        if status:
            raise SystemExit(f"attention_profile: the old backward returned {status}")
        return outs

    return run, log


# Cuts of the decode source for --split: (a `// SPLIT <name>` line of
# decode_tc<256>, the statement put after it).
SPLIT_MARKERS = {
    "loads": (("// SPLIT tile loaded", "continue;"), ("// SPLIT split loaded", "return;")),
    "no_combine": (("// SPLIT partial written", "return;"),),
}


def _cut_source(src: str, kind: str) -> str:
    for marker, stmt in SPLIT_MARKERS[kind]:
        if src.count(marker) != 1:
            raise SystemExit(f"attention_profile: marker {marker!r} not found once")
        src = src.replace(marker, f"{marker}\n    {stmt}")
    return src


def _split(torch, build, args_fn) -> dict:
    """decode_tc<256>'s time with the package's source cut after the loads
    and before the combine."""
    src = (build.CSRC / "flash_decode.cu").read_text()
    res = {}
    try:
        for kind in ("loads", "no_combine"):
            pu.use_edited(build, "flash_decode", _cut_source(src, kind), f"split_{kind}")
            res[kind] = pu.times(torch, args_fn, reps=20, inner=50)
    finally:
        pu.use_package(build, "flash_decode")
    return res


def _train_bwd(torch, build, fa, randn, old_bwd) -> dict:
    """The backward at the training shape: the package's, its kernels,
    the forward with and without the statistics, and with `old_bwd` the
    two backwards in turns (old, new, new, old)."""
    H, K, S, hd = TRAIN
    q, g = randn(B, H, S, hd), randn(B, H, S, hd)
    k, v = randn(B, K, S, hd), randn(B, K, S, hd)
    _, lse, o32 = fa.flash_attention_cuda(q, k, v, stats=True)

    def new():
        return fa.flash_attention_bwd_cuda(q, k, v, g, lse=lse, o32=o32)

    out = {**pu.times(torch, new, reps=5, inner=2),
           "max_abs_err": _held_bwd(torch, fa, new(), q, k, v, g),
           "kernels_ms": pu.kernel_ms(torch, new),
           "forward": pu.times(torch, lambda: fa.flash_attention_cuda(q, k, v), reps=5, inner=2),
           "forward_stats": pu.times(torch, lambda: fa.flash_attention_cuda(q, k, v, stats=True),
                                   reps=5, inner=2)}
    if old_bwd is not None:
        old, log = _old_bwd(torch, build, fa, old_bwd, q, k, v, g)
        out["old_max_abs_err"] = _held_bwd(torch, fa, old(), q, k, v, g)
        out["old_ptxas"] = [ln for e in ("bwd_stats", "bwd_dkdv", "bwd_dq")
                            for ln in pu.ptxas(log, e, None)]
        out["turns"] = [(name, pu.times(torch, old if name == "old" else new, reps=3, inner=1))
                        for name in ("old", "new", "new", "old")]
    return out


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to time")
    ap.add_argument("--label", default="this")
    ap.add_argument("--split", action="store_true", help="also decode_tc<256>'s split")
    ap.add_argument("--old-bwd", default=None, type=Path,
                    help="a flash_attention_bwd.cu of commit 0dde21f to time in turns")
    args = ap.parse_args(argv)
    src = Path(args.src).resolve() if args.src else Path(__file__).resolve().parents[2]
    sys.path.insert(0, str(src))
    import torch

    if not torch.cuda.is_available():
        print("attention_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch.kernels import build
    from repro_torch.kernels import flash_attention as fa
    from repro_torch.kernels import flash_decode as fd

    built = build.build_all(("flash_attention", "flash_decode", "flash_attention_bwd"))
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    g = torch.Generator(device=dev).manual_seed(SEED)

    def randn(*shape):
        return torch.randn(shape, generator=g, device=dev).to(torch.bfloat16)

    line = {"label": args.label, "package": repro_torch.__file__, "torch": torch.__version__,
            "ptxas": pu.ptxas(built["flash_attention"][1], "attention_tc")
            + pu.ptxas(built["flash_decode"][1], "decode_tc")
            + [ln for e in BWD_ENTRIES
               for ln in pu.ptxas(built["flash_attention_bwd"][1], e, None)]}
    for name, (H, K, hd, mask, pl) in SHAPES.items():
        q, k, v = randn(B, H, S_PROMPT, hd), randn(B, K, S_PROMPT, hd), randn(B, K, S_PROMPT, hd)

        def attn(q=q, k=k, v=v, mask=mask, pl=pl):
            return fa.flash_attention_cuda(q, k, v, mask_mode=mask, prefix_len=pl)

        err = _held(torch, attn(), fa.flash_attention_plain(q, k, v, mask_mode=mask,
                                                            prefix_len=pl), f"attention {name}")
        line[f"attention_{name}"] = {**pu.times(torch, attn, reps=5, inner=3), "max_abs_err": err}
        del q, k, v
        qd = randn(B, H, hd)
        kd, vd = randn(B, S_CACHE, K, hd), randn(B, S_CACHE, K, hd)
        pos = torch.full((1,), S_CACHE - 1, dtype=torch.int32, device=dev)

        def dec(qd=qd, kd=kd, vd=vd, pos=pos):
            return fd.flash_decode_cuda(qd, kd, vd, pos)

        err = _held(torch, dec(), fd.flash_decode_plain(qd, kd, vd, pos), f"decode {name}")
        line[f"decode_{name}"] = {**pu.times(torch, dec, reps=20, inner=50), "max_abs_err": err}
        if args.split and hd == 256:
            line["decode_hd256"]["split"] = _split(torch, build, dec)
        del qd, kd, vd
    if "stats" in inspect.signature(fa.flash_attention_cuda).parameters:
        line["bwd_train"] = _train_bwd(torch, build, fa, randn, args.old_bwd)
    else:  # a package before the bf16 backward read the forward's statistics
        line["bwd_train"] = "not timed: this package's forward writes no statistics"
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
