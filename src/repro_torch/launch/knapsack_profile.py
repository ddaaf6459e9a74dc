"""What the knapsack DP costs on the card: `knapsack_dp` at its three
timed shapes, and one ExactDPPPolicy slot at the main width.

    python3 src/repro_torch/launch/knapsack_profile.py [--src DIR] [--label NAME]
        [--turns 2]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported, so the script times the package of another checkout (its
`src`) as well as this one; run it once per version, in turns, to
compare two versions on one card. It calls only `knapsack_dp_cuda(scores,
weights, caps, budget, grid)` and `simulate`, which every version with
the kernel accepts.

The shapes (`inputs`), all at grid 512 (ExactDPPPolicy's default):
  - fleet A: 512 lanes x (1 + N5) knapsacks of M5 from the policy's score
    pass (`carbon_scores_cuda`) on `build_fleet(["diurnal"], per_kind=512)`
    with queues U{0..999} drawn from seed 0 on the card;
  - paper: the first 6 of those (one lane, the Fig. 2 setup's size);
  - main: 257 knapsacks of M4096 (the edge's and 256 clouds') from the
    score pass on `slot_profile.py`'s M4096 x N256 instance at slot 0.
For each it prints ms a call from CUDA-graph replay, warm (back to back)
and cold (a 128 MB read before each call, its own time subtracted), and
per eager call from CUDA events. Then `--turns` rounds of ExactDPP,
CarbonIntensity, CarbonIntensity, ExactDPP over T_EXACT slots of
`slot_profile.py`'s instance (its arrival table, summary records): ms a
slot from CUDA events. One JSON line, then the nvidia-smi name and power
limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

SEED, V, GRID, FLEET_A_LANES, T_EXACT = 0, 0.05, 512, 512, 8


def _stacked(torch, first, rest):
    """[..., M] and [..., R, M] -> [(...) * (1 + R), M]: the policy's rows"""
    return torch.cat([first[..., None, :], rest], dim=-2).reshape(-1, first.shape[-1])


def inputs(torch, dev) -> dict:
    """{shape label: (scores, weights, caps, budget)} of knapsack_dp at grid
    512 (see the module docstring)."""
    from repro_torch import convert
    from repro_torch.configs import fleet_scenarios
    from repro_torch.core import carbon
    from repro_torch.kernels import carbon_score as cs
    from repro_torch.launch import slot_profile

    g = torch.Generator(device=dev).manual_seed(SEED)
    V_t = torch.full((), V, device=dev)
    fleet = fleet_scenarios.build_fleet(["diurnal"], per_kind=FLEET_A_LANES, Tc=96, seed=SEED,
                                        device=dev).to(dev)
    pe, pc, Pe, Pc = fleet.spec
    Qe = torch.randint(0, 1000, tuple(pe.shape), generator=g, device=dev).float()
    Qc = torch.randint(0, 1000, tuple(pc.shape), generator=g, device=dev).float()
    c, _, b = cs.carbon_scores_cuda(Qc, pc, Qe, pe, V_t * fleet.carbon[:, 0, 1:],
                                    V_t * fleet.carbon[:, 0, 0])
    fleet_args = (_stacked(torch, b, c.transpose(-1, -2)),
                  _stacked(torch, pe, pc.transpose(-1, -2)),
                  _stacked(torch, Qe, Qc.transpose(-1, -2)),
                  torch.cat([Pe[:, None], Pc], dim=-1).reshape(-1).contiguous())
    spec, state0, table, _ = slot_profile._instance(torch, convert, carbon, dev)
    mpe, mpc, mPe, mPc = spec.as_arrays(dev)
    Ce, Cc = table(0, 0, dev)
    c, _, b = cs.carbon_scores_cuda(state0.Qc, mpc, state0.Qe, mpe, V_t * Cc, V_t * Ce)
    main_args = (_stacked(torch, b, c.T), _stacked(torch, mpe, mpc.T),
                 _stacked(torch, state0.Qe, state0.Qc.T),
                 torch.cat([mPe.reshape(1), mPc]).contiguous())
    return {f"fleet A F{FLEET_A_LANES} x 6 x M5": fleet_args,
            "paper 6 x M5": tuple(x[:6].contiguous() for x in fleet_args),
            f"main 257 x M{slot_profile.M}": main_args}


def replay_ms(torch, fn, reps: int, inner: int) -> float:
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
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        graph.replay()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def events_ms(torch, fn, reps: int, inner: int) -> float:
    """Median over `reps` of the mean of `inner` eager calls, CUDA events."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(inner):
            fn()
        end.record()
        end.synchronize()
        times.append(start.elapsed_time(end) / inner)
    return statistics.median(times)


def kernel_times(torch, fn, reps: int, inner: int) -> dict:
    """ms a call: cold and warm from CUDA-graph replay, and eager."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")

    def evict():
        torch.sum(flush, dim=0, out=sink)

    def cold():
        evict()
        fn()

    warm = replay_ms(torch, fn, reps, inner)
    cold_ms = replay_ms(torch, cold, reps, inner) - replay_ms(torch, evict, reps, inner)
    return {"ms": cold_ms, "warm_ms": warm, "call_ms": events_ms(torch, fn, reps, inner)}


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to time")
    ap.add_argument("--label", default="this")
    ap.add_argument("--turns", type=int, default=2)
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("knapsack_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import convert, core
    from repro_torch.core import carbon
    from repro_torch.kernels import build
    from repro_torch.kernels import knapsack as kpk
    from repro_torch.launch import slot_profile

    built = build.build_all(("carbon_score", "greedy_fill", "threefry", "knapsack"))
    ptxas = [ln.split(":", 1)[-1].strip() for ln in built["knapsack"][1].splitlines()
             if "spill" in ln or "registers" in ln]
    dev = torch.device("cuda")
    kernel = {}
    for label, kargs in inputs(torch, dev).items():
        reps, inner = (3, 1) if label.startswith("main") else (20, 5)
        kernel[label] = kernel_times(
            torch, lambda a=kargs: kpk.knapsack_dp_cuda(*a, GRID), reps, inner)

    spec, state0, table, arrivals = slot_profile._instance(torch, convert, carbon, dev)
    arrive = slot_profile._TableArrivals(arrivals)
    pols = {"ExactDPP": core.ExactDPPPolicy(V=V, grid=GRID),
            "CarbonIntensity": core.CarbonIntensityPolicy(V=V)}

    def slot_ms(pol):
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        core.simulate(pol, spec, table, arrive, T_EXACT, SEED, state0=state0, record="summary",
                      device=dev)
        end.record()
        end.synchronize()
        return start.elapsed_time(end) / T_EXACT

    for pol in pols.values():
        slot_ms(pol)  # warm-up: the builds and the allocator
    slots = {name: [] for name in pols}
    for _ in range(args.turns):
        for name in ("ExactDPP", "CarbonIntensity", "CarbonIntensity", "ExactDPP"):
            slots[name].append(slot_ms(pols[name]))
    line = {"label": args.label, "package": repro_torch.__file__, "torch": torch.__version__,
            "knapsack_ptxas": ptxas, "knapsack_dp": kernel,
            f"ms_per_slot M{slot_profile.M}xN{slot_profile.N} T={T_EXACT}": slots}
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
