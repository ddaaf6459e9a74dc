"""Where a tap_probe launch spends its time: device-clock stamps from the
first thread of every block, and the longest item of each kind.

    python3 src/repro_torch/launch/probe_stamps.py [--src DIR] [--label NAME] [--warm]

It copies the package (this checkout's, or the one in `--src DIR`, a
checkout's `src`) into `build/stamps/NAME/src/`, puts stamps into the
copy's `kernels/csrc/tap_probe.cu` and imports the copy, whose own
`build.load` compiles the stamped source and whose own `tap_probe_cuda`
launches it, at three loops' probes: the main path (M4096 x N256: the
landings by cloud, the arrivals, Qe and Qc), fleet B (the same at F16)
and W2 (F16, and Qt at L512), on values whose sums depend on their order.

The source marks its stamps with comment lines: `// STAMP n` (thread 0 of
the block takes `%globaltimer` as mark n once every thread of the block
has reached the line), `// ITEM k` (each thread takes `clock64()`) and
`// ITEM_END k` (the cycles since that thread's `// ITEM k`, the most over
the launch kept: a warp's most, then one atomic a warp into its block's
row, so that the stamps do not queue on one address). The earlier
grid-barrier source has no such lines and takes them at the code lines
listed in `_BARRIER_MARKS`: mark 0 at a block's start, 2p - 1 when the
block has done phase p - 1's work, 2p when the grid barrier lets it into
phase p, 15 at its end; items 2p (a one-column window of phase p), 2p + 1
(a wider window: staged and added) and 16 + p (its chain alone).

For each shape it prints one JSON line: the launch's time with stamps off
(CUDA-graph replay from a cold L2, the median of 15 replays of 20
launches, each after a 128 MB read whose own time is subtracted; with
`--warm`, back to back), then, from one stamped launch from a cold L2
(with `--warm`, right after a launch of the same probe): the
span from the first block's start to the last block's end, the spread of
the blocks' starts, for each mark the time of the first and the last
block to reach it after the first start, the longest time a block spent
from its previous mark to it, and the longest item of each kind in SM
cycles and us at the card's clock; and a split of the launch (launch and
drain, each stretch between marks, the tail) that sums to its time. Then
the nvidia-smi name and power limit. The shipped kernel carries no stamps.
"""
from __future__ import annotations

import argparse
import ctypes
import json
import re
import shutil
import statistics
import subprocess
import sys
from pathlib import Path

SEED, T = 0, 4
N_MARKS, N_ITEMS, MAX_BLOCKS = 16, 32, 1 << 16
_STAMP = """
__device__ unsigned long long* g_stamps;  // [blocks, 16] %globaltimer, ns
__device__ unsigned long long* g_items;   // [blocks, 32] the most cycles of an item of each kind
#define STAMP(j) { __syncthreads(); if (threadIdx.x == 0 && g_stamps) { \\
  unsigned long long t_; asm volatile("mov.u64 %0, %globaltimer;" : "=l"(t_)); \\
  g_stamps[16ull * blockIdx.x + (j)] = t_; } }
#define ITEM(k) const long long item_##k##_ = clock64();
// the most of a warp's threads, then of the block's warps: one atomic a warp
#define ITEM_MAX(k, cycles) if (g_items) { const unsigned a_ = __activemask(); \\
  const unsigned m_ = __reduce_max_sync(a_, static_cast<unsigned>(cycles)); \\
  if ((threadIdx.x & 31) == __ffs(a_) - 1) \\
    atomicMax(g_items + 32ull * blockIdx.x + (k), static_cast<unsigned long long>(m_)); }
#define ITEM_END(k) ITEM_MAX(k, clock64() - item_##k##_)
"""
_SETTER = """
extern "C" int tap_probe_set_stamps(void* stamps, void* items) {
  unsigned long long* s = static_cast<unsigned long long*>(stamps);
  unsigned long long* i = static_cast<unsigned long long*>(items);
  cudaError_t err = cudaMemcpyToSymbol(g_stamps, &s, sizeof(s));
  if (err == cudaSuccess) err = cudaMemcpyToSymbol(g_items, &i, sizeof(i));
  return static_cast<int>(err);
}
"""
# the grid-barrier source: (code, the code with stamps)
_CHAIN_PUT = ("        put(p, phase, it, window_chain(tile + lane_id * kTileFloats, "
              "p.job[it.k].lev[phase]));\n")
_BARRIER_MARKS = (
    ("  const long long start = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n",
     "  const long long start = static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;\n"
     "  STAMP(0)\n"),
    ("    if (phase > 0) grid_sync(p.sync);\n",
     "    if (phase > 0) {\n      STAMP(2 * phase - 1)\n      grid_sync(p.sync);\n"
     "      STAMP(2 * phase)\n    }\n"),
    ("      put(p, phase, it, column_window(it.x, v, it.i, it.j, phase > 0));\n",
     "      ITEM(c)\n      put(p, phase, it, column_window(it.x, v, it.i, it.j, phase > 0));\n"
     "      ITEM_MAX(2 * phase, clock64() - item_c_)\n"),
    ("    for (long long grp = start / 32; grp < groups; grp += all_warps) {\n",
     "    for (long long grp = start / 32; grp < groups; grp += all_warps) {\n      ITEM(w)\n"),
    ("      copies_done();\n      __syncwarp();\n",
     "      copies_done();\n      __syncwarp();\n      ITEM(a)\n"),
    (_CHAIN_PUT,
     _CHAIN_PUT + "        ITEM_MAX(2 * phase + 1, clock64() - item_w_)\n"
     "        ITEM_MAX(16 + phase, clock64() - item_a_)\n"),
    ("      __syncwarp();  // the tiles are free for the warp's next windows\n    }\n  }\n}\n",
     "      __syncwarp();  // the tiles are free for the warp's next windows\n    }\n  }\n"
     "  STAMP(15)\n}\n"),
)
_BARRIER_NAMES = {0: "start", 15: "end", **{2 * p - 1: f"phase {p - 1} done" for p in range(1, 7)},
                  **{2 * p: f"barrier {p} out" for p in range(1, 7)}}
_BARRIER_ITEMS = {**{2 * p: f"phase {p} column window" for p in range(7)},
                  **{2 * p + 1: f"phase {p} wide window" for p in range(7)},
                  **{16 + p: f"phase {p} chain" for p in range(7)}}


def stamped(source: str):
    """The kernel source with stamps, and the names of its marks and items."""
    marks = re.findall(r"^ *// STAMP (\d+) ?(.*)$", source, flags=re.M)
    if marks:
        names = {int(n): (text or f"mark {n}") for n, text in marks}
        items = {int(k): (text or f"item {k}")
                 for k, text in re.findall(r"^ *// ITEM (\d+) ?(.*)$", source, flags=re.M)}
        source = re.sub(r"^( *)// STAMP (\d+).*$", r"\1STAMP(\2)", source, flags=re.M)
        source = re.sub(r"^( *)// ITEM (\d+).*$", r"\1ITEM(\2)", source, flags=re.M)
        source = re.sub(r"^( *)// ITEM_END (\d+).*$", r"\1ITEM_END(\2)", source, flags=re.M)
    else:
        for mark, text in _BARRIER_MARKS:
            if source.count(mark) != 1:
                raise ValueError(f"probe_stamps: {mark!r} not found once")
            source = source.replace(mark, text)
        names, items = _BARRIER_NAMES, _BARRIER_ITEMS
    if not all(0 <= n < N_MARKS for n in names) or not all(0 <= k < N_ITEMS for k in items):
        raise ValueError(f"probe_stamps: marks {sorted(names)} or items {sorted(items)} "
                         "out of room")
    head = source.index("namespace {")
    return source[:head] + _STAMP + source[head:] + _SETTER, names, items


def inputs(torch, dev) -> dict:
    """{shape label: (lanes, inputs, backlog parts)}: the loops'
    probes on values whose sums depend on their order."""
    g = torch.Generator(device=dev).manual_seed(SEED)

    def data(*shape):
        x = torch.rand(shape, generator=g, device=dev) * 10.0 ** torch.randint(
            -3, 9, shape, generator=g, device=dev).float()
        return torch.where(torch.rand(shape, generator=g, device=dev) < 0.3, -x, x)

    out = {}
    for label, lanes, L in (("main F1 x M4096 x N256", (), None),
                            ("fleet B F16 x M4096 x N256", (16,), None),
                            ("W2 F16 x M4096 x N256 x L512", (16,), 512)):
        x = {"dispatched": data(*lanes, 4096, 256), "arrived": data(*lanes, 4096),
             "part0": data(*lanes, 4096), "part1": data(*lanes, 4096, 256)}
        parts = ["part0", "part1"]
        if L:
            x["transfer_occupancy"] = data(*lanes, 4096, L)
            parts.append("transfer_occupancy")
        out[label] = (lanes, x, parts)
    return out


def replay_ms(torch, fn, reps: int = 15, inner: int = 20) -> float:
    """Device ms a call: `inner` calls captured in one CUDA graph, the
    median of `reps` replays between CUDA events."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        fn()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            fn()
    graph.replay()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def cold_ms(torch, fn) -> float:
    """Device ms a call from a cold L2: each call after a 128 MB read
    (CUDA-graph replay), minus the time of that read alone."""
    flush = torch.empty(32 * 2**20, device="cuda")
    sink = torch.empty((), device="cuda")

    def evict():
        torch.sum(flush, dim=0, out=sink)

    def cold():
        evict()
        fn()

    return replay_ms(torch, cold) - replay_ms(torch, evict)


def summary(torch, stamps, items, names: dict, item_names: dict, kernel_us: float,
            mhz: float) -> dict:
    """The marks' times after the first start, the longest stretch into
    each mark, the longest items and the launch's split (see the module
    docstring); `stamps` [blocks, 16] ns (0: not reached), `items` [32]."""
    s = stamps.double()
    t0 = float(s[:, 0].min())
    end = float(s[:, 15].max())
    marks, steps = {}, {}
    prev = s[:, 0].clone()
    for m in sorted(names):
        hit = s[:, m] > 0
        if m == 0 or not bool(hit.any()):
            continue
        col = s[hit, m]
        marks[names[m]] = {"first_us": (float(col.min()) - t0) / 1e3,
                           "last_us": (float(col.max()) - t0) / 1e3, "blocks": int(hit.sum())}
        steps[names[m]] = float((s[hit, m] - prev[hit]).max()) / 1e3
        prev = torch.where(hit, s[:, m], prev)
    span = (end - t0) / 1e3
    # the split: the last block to reach each mark, in the order they are
    # reached, then the tail; launch and drain the rest of the launch's time
    split = {"launch and drain": kernel_us - span}
    at = 0.0
    for name, v in sorted(marks.items(), key=lambda kv: kv[1]["last_us"]):
        if name == names[15]:
            continue
        split[f"to last {name}"] = v["last_us"] - at
        at = v["last_us"]
    split["tail"] = span - at
    longest = {item_names[k]: {"cycles": int(items[k]), "us": int(items[k]) / mhz}
               for k in sorted(item_names) if int(items[k]) > 0}
    return {"kernel_us": kernel_us, "span_us": span,
            "start_spread_us": (float(s[:, 0].max()) - t0) / 1e3, "blocks": int(s.shape[0]),
            "marks": marks, "longest_into_mark_us": steps, "longest_items": longest,
            "split_us": split}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to stamp")
    ap.add_argument("--label", default="this")
    ap.add_argument("--warm", action="store_true", help="inputs and code in L2, not cold")
    args = ap.parse_args(argv)
    here = Path(__file__).resolve()
    pkg = (Path(args.src) if args.src else here.parents[2]) / "repro_torch"
    copy = here.parents[3] / "build" / "stamps" / args.label / "src"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(pkg, copy / "repro_torch", ignore=shutil.ignore_patterns("__pycache__"))
    cu = copy / "repro_torch" / "kernels" / "csrc" / "tap_probe.cu"
    text, names, item_names = stamped(cu.read_text())
    cu.write_text(text)
    sys.path.insert(0, str(copy))
    import torch

    if not torch.cuda.is_available():
        print("probe_stamps: no CUDA device", file=sys.stderr)
        return 2
    from repro_torch.kernels import build
    from repro_torch.kernels import taps as tpk
    if not Path(build.__file__).resolve().is_relative_to(copy):
        raise RuntimeError(f"probe_stamps: imported {build.__file__}, not the stamped copy")
    lib = build.load("tap_probe")  # the stamped source, built by the copy
    lib.tap_probe_set_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p]
    dev = torch.device("cuda")
    mhz = float(subprocess.run(
        ["nvidia-smi", "--query-gpu=clocks.max.sm", "--format=csv,noheader,nounits"],
        capture_output=True, text=True, timeout=60).stdout.split()[0])
    for label, (lanes, x, parts) in inputs(torch, dev).items():
        series = {n: torch.zeros(lanes + (T,), device=dev)
                  for n in ("arrived", "transfer_occupancy", "backlog")}
        series["dispatched"] = torch.zeros(lanes + (T, 256), device=dev)
        plan = tpk.ProbePlan(lanes, T, x, {n: series[n] for n in x if n in series}, parts,
                             series["backlog"], by_column=("dispatched",))
        want = tpk.ProbePlan(lanes, T, x, {n: series[n].clone() for n in x if n in series},
                             parts, series["backlog"].clone(), by_column=("dispatched",))
        tpk.tap_probe_plain(want, 1, x)
        call = lambda: tpk.tap_probe_cuda(plan, 1, x)  # noqa: E731
        kernel_us = (replay_ms(torch, call) if args.warm else cold_ms(torch, call)) * 1e3
        stamps = torch.zeros(MAX_BLOCKS, N_MARKS, dtype=torch.int64, device=dev)
        items = torch.zeros(MAX_BLOCKS, N_ITEMS, dtype=torch.int64, device=dev)
        if args.warm:  # the same launch just before, unstamped
            tpk.tap_probe_cuda(plan, 2, x)
        else:
            torch.sum(torch.empty(32 * 2**20, device=dev))  # L2 cold, as the loops find it
        build.check(lib, lib.tap_probe_set_stamps(stamps.data_ptr(), items.data_ptr()),
                    "tap_probe_set_stamps")
        tpk.tap_probe_cuda(plan, 2, x)
        torch.cuda.synchronize()
        build.check(lib, lib.tap_probe_set_stamps(None, None), "tap_probe_set_stamps")
        for n in want.outputs:
            if not torch.equal(plan.outputs[n][..., 2, :] if n == "dispatched" else
                               plan.outputs[n][..., 2], want.outputs[n][..., 1, :]
                               if n == "dispatched" else want.outputs[n][..., 1]):
                print(f"probe_stamps: {label}: the stamped run's {n} differs", file=sys.stderr)
                return 1
        if not torch.equal(plan.backlog[..., 2], want.backlog[..., 1]):
            print(f"probe_stamps: {label}: the stamped run's backlog differs", file=sys.stderr)
            return 1
        used = stamps[:, 0] > 0
        line = {"label": args.label, "shape": label, "l2": "warm" if args.warm else "cold",
                "sm_mhz": mhz,
                **summary(torch, stamps[used].cpu(), items.max(dim=0).values.cpu(), names,
                          item_names, kernel_us, mhz)}
        print(json.dumps(line), flush=True)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
