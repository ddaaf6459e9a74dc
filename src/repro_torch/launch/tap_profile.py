"""What the telemetry taps cost on the card: the tap kernel's time, the
taps' cost a slot in the runs, and what the probe's per-slot sums launch
and cost.

    python3 src/repro_torch/launch/tap_profile.py [--src DIR] [--label NAME]
        [--turns 3] [--sums] [--sums-only]

`--src DIR` puts DIR first on the module path before `repro_torch` is
imported, so the script times the package of another checkout (its
`src`) as well as this one; run it once per version, in turns, to
compare two versions on one card. It uses only calls that both versions
accept, and the fused probe only where the package has one.

It measures, summary records, seed 0:
  - kernel: `tap_scan_cuda` over a whole run's probe series, from a run
    with taps on, at bench_telemetry_overhead's fleet
    (`build_fleet(["diurnal-slack"], per_kind=32)`, F32 x M5 x N5,
    CarbonIntensity V=0.05, T=192) and at chip_smoke.py's main path (M4096
    x N256, T=64: the instance of `slot_profile.py`), and on seeded series
    at F1 x T192 (bench_stream_overhead's run length) and F16 x T64 (fleet
    B's); ms a call from CUDA-graph replay (20 calls a graph, the median
    of 15 replays between CUDA events);
  - ms_per_slot: the main path, the bench fleet and fleet B (F16 x M4096 x
    N256, chip_smoke.py's four kinds x 4, T=64) with taps off and on,
    `--turns` rounds of off, on, on, off, ms per slot from CUDA events;
  - with `--sums`, probe_sums at the six loops' probe shapes (the main
    path, fleet B, W2 with Qt at L512, the bench fleet, the stream
    instance M2048 x N64, fleet B faulted: the retry pool, no arrivals):
    the sums of one slot (the landings by cloud, the arrivals, the
    backlog's parts and their adds) as one torch call each into slot t of
    the [*lanes, T] tape (the earlier path), and, where the package has
    it, as one `tap_probe` launch: each one's ms from CUDA-graph replay,
    cold (a 128 MB read before each call, its own time subtracted) and
    warm, and from torch.profiler over 8 calls the kernels, memsets and
    host launch, cooperative launch and memset calls a call; with
    `--sums-only`, that alone (run it in turns against another tree).
It prints one JSON line (with tap_scan's ptxas registers and spills)
and the nvidia-smi name and power limit.
"""
from __future__ import annotations

import argparse
import json
import statistics
import subprocess
import sys

SEED, V, T_MAIN, T_BENCH = 0, 0.05, 64, 192
FLEET_B_KINDS, FLEET_B_PER_KIND = ("diurnal", "bursty", "heterogeneous-fleet", "overload"), 4


def _events_ms(torch, fn, reps: int, inner: int) -> float:
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


def _cold_ms(torch, fn) -> float:
    """Device ms a call from a cold L2: each call after a 128 MB read
    (CUDA-graph replay), minus the time of that read alone."""
    flush = torch.empty(32 * 2**20, device="cuda")
    sink = torch.empty((), device="cuda")

    def evict():
        torch.sum(flush, dim=0, out=sink)

    def cold():
        evict()
        fn()

    return _replay_ms(torch, cold) - _replay_ms(torch, evict)


def _replay_ms(torch, fn, reps: int = 15, inner: int = 20) -> float:
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


def _launches(torch, fn, calls: int = 8) -> dict:
    """Device kernels and memsets, and host launch and memset calls, a
    call of `fn`, from torch.profiler."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(calls):
            fn()
        torch.cuda.synchronize()
    out = {"kernels": 0, "memsets": 0, "cudaLaunchKernel": 0, "cudaMemsetAsync": 0,
           "cudaLaunchCooperativeKernel": 0}
    names = set()
    for evt in prof.key_averages():
        if evt.device_type == DeviceType.CUDA:
            kind = "memsets" if "memset" in evt.key.lower() else "kernels"
            out[kind] += evt.count
            if kind == "kernels":
                names.add(evt.key[:60])
        elif evt.key in out:
            out[evt.key] += evt.count
    out = {k: v / calls for k, v in out.items()}
    out["kernel_names"] = sorted(names)
    return out


PROBE_SHAPES = {  # label: (lanes, M, N, L, faulted)
    "main F1 x M4096 x N256": ((), 4096, 256, None, False),
    "fleet B F16 x M4096 x N256": ((16,), 4096, 256, None, False),
    "W2 F16 x M4096 x N256 x L512": ((16,), 4096, 256, 512, False),
    "bench fleet F32 x M5 x N5": ((32,), 5, 5, None, False),
    "stream M2048 x N64": ((), 2048, 64, None, False),
    "fleet B faulted F16 x M4096 x N256": ((16,), 4096, 256, None, True),
}


def _probe_sums(torch, dev, tpk) -> dict:
    """One slot's probe sums at the loops' shapes: one torch call a sum
    and, where the package has it, the fused `tap_probe`."""
    T, t = 64, 5
    res = {}
    for label, (lanes, M, N, L, faulted) in PROBE_SHAPES.items():
        g = torch.Generator(device=dev).manual_seed(SEED)

        def ints(*shape, hi=1000):
            return torch.randint(0, hi, lanes + shape, generator=g, device=dev).float()

        inputs = {"dispatched": ints(M, N, hi=9)}
        if not faulted:
            inputs["arrived"] = ints(M, hi=400)
        inputs["part0"], inputs["part1"] = ints(M), ints(M, N)
        parts = ["part0", "part1"]
        if L:
            inputs["transfer_occupancy"] = ints(M, L)
            parts.append("transfer_occupancy")
        if faulted:
            inputs["retry_depth"] = ints(M, N, hi=9)
            parts.append("retry_depth")
        series = {n: torch.zeros(lanes + (T,), device=dev)
                  for n in ("arrived", "transfer_occupancy", "retry_depth", "backlog")}
        series["dispatched"] = torch.zeros(lanes + (T, N), device=dev)
        e1 = tuple(range(len(lanes), len(lanes) + 1))
        e2 = tuple(range(len(lanes), len(lanes) + 2))

        def sums(inputs=inputs, series=series, e1=e1, e2=e2):
            """the probe as one torch call a sum and the adds (the earlier path)"""
            torch.sum(inputs["dispatched"], dim=-2, out=series["dispatched"][..., t, :])
            if "arrived" in inputs:
                torch.sum(inputs["arrived"], dim=e1, out=series["arrived"][..., t])
            totals = [torch.sum(inputs["part0"], dim=e1), torch.sum(inputs["part1"], dim=e2)]
            for n in ("transfer_occupancy", "retry_depth"):
                if n in inputs:
                    totals.append(torch.sum(inputs[n], dim=e2, out=series[n][..., t]))
            acc = totals[0]
            for x in totals[1:-1]:
                acc = acc + x
            torch.add(acc, totals[-1], out=series["backlog"][..., t])

        res[label] = {"torch_sums": {"ms": _cold_ms(torch, sums),
                                     "warm_ms": _replay_ms(torch, sums), **_launches(torch, sums)}}
        if hasattr(tpk, "ProbePlan"):
            plan = tpk.ProbePlan(lanes, T, inputs, {n: series[n] for n in inputs if n in series},
                                 parts, series["backlog"], by_column=("dispatched",))

            def probe(plan=plan, inputs=inputs):
                tpk.tap_probe_cuda(plan, t, inputs)

            res[label]["tap_probe"] = {"ms": _cold_ms(torch, probe),
                                       "warm_ms": _replay_ms(torch, probe),
                                       **_launches(torch, probe)}
    return res


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--src", default=None, help="a checkout's src directory to time")
    ap.add_argument("--label", default="this")
    ap.add_argument("--turns", type=int, default=3)
    ap.add_argument("--sums", action="store_true", help="also the probe sums' launches")
    ap.add_argument("--sums-only", action="store_true", help="the probe sums alone")
    args = ap.parse_args(argv)
    if args.src:
        sys.path.insert(0, args.src)
    import torch

    if not torch.cuda.is_available():
        print("tap_profile: no CUDA device", file=sys.stderr)
        return 2
    import repro_torch
    from repro_torch import convert, core
    from repro_torch import telemetry as tlm
    from repro_torch.configs import fleet_scenarios
    from repro_torch.core import carbon
    from repro_torch.kernels import build
    from repro_torch.kernels import taps as tpk
    from repro_torch.launch import slot_profile

    names = ("carbon_score", "greedy_fill", "threefry", "tap_scan") + \
        (("tap_probe",) if "tap_probe" in build.SOURCES else ())
    built = build.build_all(names)
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                         capture_output=True, text=True, timeout=60).stdout.strip()
    dev = torch.device("cuda")
    if args.sums_only:
        print(json.dumps({"label": args.label, "package": repro_torch.__file__,
                          "probe_sums": _probe_sums(torch, dev, tpk)}), flush=True)
        print(smi, flush=True)
        return 0
    ptxas = [ln.split(":", 1)[-1].strip() for ln in built["tap_scan"][1].splitlines()
             if "spill" in ln or "registers" in ln]
    cfg = tlm.TelemetryConfig()
    ci = core.CarbonIntensityPolicy(V=V)
    spec, state0, table, _ = slot_profile._instance(torch, convert, carbon, dev)
    arrivals = core.UniformArrivals(M=slot_profile.M, amax=slot_profile.A_MAX)
    bench = fleet_scenarios.build_fleet(["diurnal-slack"], per_kind=32, Tc=96, seed=SEED,
                                        device=dev).to(dev)
    fleet_b = fleet_scenarios.build_fleet(FLEET_B_KINDS, per_kind=FLEET_B_PER_KIND,
                                          M=slot_profile.M, N=slot_profile.N, Tc=96, seed=SEED,
                                          device=dev).to(dev)
    runs = {
        "main": (lambda tel: core.simulate(ci, spec, table, arrivals, T_MAIN, SEED, state0=state0,
                                           record="summary", device=dev, telemetry=tel), T_MAIN),
        "bench fleet": (lambda tel: core.simulate_fleet(ci, bench, T_BENCH, SEED,
                                                        record="summary", device=dev,
                                                        telemetry=tel), T_BENCH),
        "fleet B": (lambda tel: core.simulate_fleet(ci, fleet_b, T_MAIN, SEED, record="summary",
                                                    device=dev, telemetry=tel), T_MAIN),
    }

    def probe_of(tel):
        return tlm.TelemetryProbe(
            emissions=tel.emission_rate, arrived=tel.arrived, dispatched=tel.dispatched_cloud,
            processed=tel.processed, failed=tel.failed, wasted=tel.wasted, backlog=tel.backlog,
            stale=tel.staleness, clouds_down=tel.clouds_down, retry_depth=tel.retry_depth,
            transfer_occupancy=tel.transfer_occupancy, missed=tel.missed, shed=tel.shed)

    def seeded(lanes, T):
        """integral counts past 2**24 and non-integral emissions"""
        g = torch.Generator(device=dev).manual_seed(SEED + T)
        ints = lambda hi: torch.randint(0, hi, lanes + (T,), generator=g, device=dev).float()  # noqa: E731
        arrived = ints(2**20)
        processed = torch.minimum(ints(2**20), arrived)
        z = torch.zeros(lanes + (T,), device=dev)
        return tlm.TelemetryProbe(
            emissions=torch.rand(lanes + (T,), generator=g, device=dev) * 1e6, arrived=arrived,
            dispatched=torch.zeros(lanes + (T, 5), device=dev), processed=processed, failed=z,
            wasted=z, backlog=torch.cumsum(arrived - processed, dim=-1), stale=z.int(),
            clouds_down=z, retry_depth=z, transfer_occupancy=z, missed=z, shed=z)

    kernel = {}
    probes = {"bench fleet F32 x T192": probe_of(runs["bench fleet"][0](cfg).telemetry),
              "main F1 x T64": probe_of(runs["main"][0](cfg).telemetry),
              "F1 x T192": seeded((1,), T_BENCH), "F16 x T64": seeded((16,), T_MAIN)}
    for name, probe in probes.items():
        lanes, T = tuple(probe.backlog.shape[:-1]), probe.backlog.shape[-1]
        out = tpk.TapOut.empty(lanes, T, dev)
        state = torch.zeros(lanes + (7,), device=dev)
        kernel[name] = _replay_ms(torch, lambda p=probe, o=out, s=state, T=T: tpk.tap_scan_cuda(
            cfg, p, o, s, 0, T))

    def slot_ms(run, slots, tel):
        return _events_ms(torch, lambda: run(tel), reps=1, inner=1) / slots

    times = {n: {"off": [], "on": []} for n in runs}
    for _ in range(args.turns):
        for name, (run, slots) in runs.items():
            for mode in ("off", "on", "on", "off"):
                times[name][mode].append(slot_ms(run, slots, None if mode == "off" else cfg))
    line = {"label": args.label, "package": repro_torch.__file__, "torch": torch.__version__,
            "tap_scan_ptxas": ptxas, "kernel_ms": kernel, "ms_per_slot": times}
    if args.sums:
        line["probe_sums"] = _probe_sums(torch, dev, tpk)
    print(json.dumps(line), flush=True)
    print(smi, flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
