"""Where the knapsack kernel's time goes inside a launch: device-clock
stamps from the first thread of each knapsack's block or group.

    python3 src/repro_torch/launch/knapsack_stamps.py [--src DIR] [--label NAME]

It copies the package (this checkout's, or the one in `--src DIR`, a
checkout's `src`) into `build/stamps/NAME/src/`, puts stamps into the
copy's `kernels/csrc/knapsack.cu` and imports the copy, whose own
`build.load` compiles the stamped source and whose own `knapsack_dp_cuda`
launches it, at `knapsack_profile.py`'s three inputs (grid 512). The
source marks its phase boundaries with `// STAMP n` lines, n = 0 at the
start, 1 after the prologue, 2 after the forward DP, 3 after the argmin,
4 after the walk back; the earlier one-block-a-knapsack source has no such
lines, and takes the stamps before the code lines listed in `_BLOCK_MARKS`
(its per-type set-up runs inside the forward DP: no prologue). Each stamp
is `%globaltimer` (ns) and `clock64()`. It prints, for each shape, one
JSON line: the longest knapsack's phases in us and in SM cycles, each
phase's share of all knapsacks' time, the span of the launch and the
spread of the knapsacks' starts; then the nvidia-smi name and power limit.
The shipped kernel carries no stamps.
"""
from __future__ import annotations

import argparse
import ctypes
import importlib.util
import json
import re
import shutil
import subprocess
import sys
from pathlib import Path

PHASES = ("prologue", "forward", "argmin", "walk")
_STAMP = """
__device__ unsigned long long* g_stamps;
#define STAMP(j, row, when) if ((when) && g_stamps) { \\
  unsigned long long* s_ = g_stamps + 16ull * (row); \\
  asm volatile("mov.u64 %0, %globaltimer;" : "=l"(s_[j])); s_[8 + (j)] = clock64(); }
"""
_SETTER = """
extern "C" int knapsack_set_stamps(void* p) {
  unsigned long long* q = static_cast<unsigned long long*>(p);
  return static_cast<int>(cudaMemcpyToSymbol(g_stamps, &q, sizeof(q)));
}
"""
# the one-block-a-knapsack source: (code, the code with stamps before it)
_BLOCK_MARKS = (
    ("  const int lane = tid & 31;", "  STAMP(0, blockIdx.x, threadIdx.x == 0)\n"
     "  STAMP(1, blockIdx.x, threadIdx.x == 0)\n  const int lane = tid & 31;"),
    ("  // e* = argmin(best): the first NaN",
     "  STAMP(2, blockIdx.x, tid == 0)\n  // e* = argmin(best): the first NaN"),
    ("  // Walk back: the last step first.",
     "  STAMP(3, blockIdx.x, true)\n  // Walk back: the last step first."),
    ("    if (taken) counts[m] = static_cast<float>(taken);\n  }\n}",
     "    if (taken) counts[m] = static_cast<float>(taken);\n  }\n  STAMP(4, blockIdx.x, true)\n}"),
)


def stamped(source: str) -> str:
    """The kernel source with stamps at its phase boundaries."""
    marks = re.findall(r"^ *// STAMP (\d)$", source, flags=re.M)
    if marks:
        if sorted(marks) != list("01234"):
            raise ValueError(f"knapsack_stamps: the source marks stamps {marks}, not 0-4 once")
        source = re.sub(r"^( *)// STAMP (\d)$", r"\1STAMP(\2, kn, t == 0)", source, flags=re.M)
    else:
        for mark, text in _BLOCK_MARKS:
            if source.count(mark) != 1:
                raise ValueError(f"knapsack_stamps: {mark!r} not found once")
            source = source.replace(mark, text)
    head = source.index("namespace {")
    return source[:head] + _STAMP + source[head:] + _SETTER


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to stamp")
    ap.add_argument("--label", default="this")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve()
    pkg = (Path(args.src) if args.src else here.parents[2]) / "repro_torch"
    copy = here.parents[3] / "build" / "stamps" / args.label / "src"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(pkg, copy / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    cu = copy / "repro_torch" / "kernels" / "csrc" / "knapsack.cu"
    cu.write_text(stamped(cu.read_text()))
    sys.path.insert(0, str(copy))
    import torch

    if not torch.cuda.is_available():
        print("knapsack_stamps: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import knapsack as kpk
    if not Path(build.__file__).resolve().is_relative_to(copy):
        raise RuntimeError(f"knapsack_stamps: imported {build.__file__}, not the stamped copy")
    # this checkout's inputs, made with the stamped copy's package
    spec = importlib.util.spec_from_file_location("knapsack_profile",
                                                  here.with_name("knapsack_profile.py"))
    kp = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(kp)
    lib = build.load("knapsack")  # the stamped source, built by the copy
    lib.knapsack_set_stamps.argtypes = [ctypes.c_void_p]
    dev = torch.device("cuda")
    for label, kargs in kp.inputs(torch, dev).items():
        K = kargs[0].shape[0]
        want = kpk.knapsack_dp_cuda(*kargs, kp.GRID)  # stamps off: a warm-up, the reference
        stamps = torch.zeros(K, 16, dtype=torch.int64, device=dev)
        lib.knapsack_set_stamps(stamps.data_ptr())
        got = kpk.knapsack_dp_cuda(*kargs, kp.GRID)
        torch.cuda.synchronize()
        lib.knapsack_set_stamps(None)
        if not torch.equal(got, want):
            print(f"knapsack_stamps: {label}: the stamped run's counts differ", file=sys.stderr)
            return 1
        s = stamps.cpu().double()
        total = s[:, 4] - s[:, 0]
        j = int(total.argmax())
        parts = s[:, 1:5] - s[:, 0:4]
        line = {
            "label": args.label, "shape": label, "longest_knapsack": j,
            "longest_us": {p: float(parts[j, i]) / 1e3 for i, p in enumerate(PHASES)},
            "longest_cycles": {p: float(s[j, 9 + i] - s[j, 8 + i]) for i, p in enumerate(PHASES)},
            "share": {p: float(parts[:, i].sum() / total.sum()) for i, p in enumerate(PHASES)},
            "mean_us": float(total.mean()) / 1e3,
            "span_us": float(s[:, 4].max() - s[:, 0].min()) / 1e3,
            "start_spread_us": float(s[:, 0].max() - s[:, 0].min()) / 1e3,
        }
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
