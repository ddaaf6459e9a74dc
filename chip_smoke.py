#!/usr/bin/env python3
"""Smoke run of the PyTorch port (`src/repro_torch`) on one CUDA card.

    python3 chip_smoke.py

Drives the port's two main paths and holds each hand-written kernel
against its plain PyTorch version on the card. The paper's slot loop,
`simulate` and `serve_loop`, with `CarbonIntensityPolicy` (Algorithm 1)
and the paper's `QueueLengthPolicy` baseline, runs at M=4096 task types
x N=256 clouds; the WAN route-aware slot loop, `simulate(graph=)` with
`NetworkAwareDPPPolicy` and its transfer-blind baseline
`StaticRoutePolicy(CarbonIntensityPolicy)`, at M=4096 x N=256 x L=512
routes. Phases, one or more lines each:

1. device: name, compute capability (must be 9.0) and the nvidia-smi
   name / power limit;
2. build: the three kernels compiled from csrc/ with nvcc, in parallel;
3. kernels vs plain versions on the card, bitwise, at the main paths'
   shapes and at small, ragged and degenerate ones (route_scores in both
   of its rounding modes);
4. main path, M4096xN256: `simulate` for both policies (T=64, summary
   records) under `torch.cuda.set_sync_debug_mode("error")`, launch
   counters checked, ms per slot from CUDA events, then again in turns
   (A, B, B, A); then T=16 on the card and through the CPU plain
   versions: queues bitwise, emissions within rtol 1e-6;
4b. WAN path, M4096xN256xL512 on the congested-uplink topology: the same
   for both WAN policies (T=64, launch counters per policy, idle share),
   then T=8 on the card and through the CPU plain versions: Qe, Qc, Qt
   bitwise, emissions within rtol 1e-6;
5. paper headline: `paper_spec()`, T=2000, V=0.05, both policies on the
   UK-regional source; the emission reduction (the paper reports 54%);
5b. WAN headline: congested-uplink at M5xN5, T=192, V=0.1, route-aware
   vs transfer-blind emission reduction over 8 instances (must exceed
   5%);
6. `serve_loop` at M4096xN256 for 32 slots: p50/p95/p99 decision latency
   and tasks/sec; its trajectory bitwise equal to `simulate` on the card;
7. each kernel's median time (CUDA events) at its main path's shapes
   beside its bound and its plain version's time.

The last three lines are the JSON kernel table, the nvidia-smi name and
power limit, and the JSON device record. Any failure ends the run with a non-zero exit; nothing
falls back to the CPU. The main-path configuration: the spec of the
repo's M4096xN256 bench rows (`benchmarks/paper_benches.py`
`_random_instance`: pe~U(1,8), pc~U(2,100) kWh) with budgets scaled to
the paper's loads (edge 0.86, clouds 0.33 at a_m(t)~U{0..400}), starting
from that instance's backlog Qe, Qc~U{0..999}; carbon from a numpy
`diurnal_table`; arrivals from a numpy table (so CPU and card draw the
same numbers). The WAN configuration is the WAN subsystem's acceptance
scenario, `configs/fleet_scenarios.py::congested_uplink` (Table-I spec
tiled to M x N, two routes per cloud, the clean alternates' bandwidth at
the offered load, arrivals U{0..240}) seeded as `build_network_fleet`
seeds lane 0, from a backlog Qe, Qc~U{0..999} and empty links.
Everything is made from SEED.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

SEED = 0
M_MAIN, N_MAIN = 4096, 256
A_MAX = 400
T_MAIN, T_CPU, T_PAPER, T_SERVE = 64, 16, 2000, 32
T_WAN_CPU, T_WAN_HEADLINE, WAN_INSTANCES, V_WAN = 8, 192, 8, 0.1
HBM_BYTES_PER_S = 3.35e12  # H100 SXM data sheet
FP32_OPS_PER_S = 67e12     # H100 SXM data sheet, non-tensor float32


def say(*parts) -> None:
    print(*parts, flush=True)


def fail(msg: str) -> None:
    raise SystemExit(f"chip_smoke FAILED: {msg}")


def smi_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, reps: int, inner: int) -> float:
    """Median over `reps` of the mean time of `inner` back-to-back eager
    calls, from CUDA events (warm caches). Includes the host's launch
    cost wherever that is longer than the device work."""
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


def _replay_ms(body, reps: int, inner: int) -> float:
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        body()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        for _ in range(inner):
            body()
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


def graph_ms(fn, reps: int, inner: int) -> tuple:
    """Device time of one call, (warm, cold): `inner` calls captured into
    one CUDA graph and replayed `reps` times between CUDA events, the
    median per call; the replay launches from the device, so no host
    launch cost is timed. Warm: back to back, inputs left in the 50 MB L2
    by the call before. Cold: each call after a 128 MB read that evicts
    L2, minus the time of that read alone."""
    flush = torch.empty(32 * 2**20, dtype=torch.float32, device="cuda")
    sink = torch.empty((), dtype=torch.float32, device="cuda")

    def evict():
        torch.sum(flush, dim=0, out=sink)

    def cold():
        evict()
        fn()

    warm_ms = _replay_ms(fn, reps, inner)
    cold_ms = _replay_ms(cold, reps, inner) - _replay_ms(evict, reps, inner)
    return warm_ms, cold_ms


def profile_slots(run, slots: int):
    """Time per slot from torch.profiler over `run()` (covering `slots`
    slots): ({'total': ms, kernel name: ms} on the device, or None when
    the profiler recorded no device time; {op name: (self host ms, calls)}
    on the host, profiler overhead included)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        run()
        torch.cuda.synchronize()
    per, host = {}, {}
    total = 0.0
    for evt in prof.key_averages():
        # kernels, memsets and copies; the `repro.<phase>` labels also show
        # on the device timeline, as spans over the kernels inside them
        if evt.key.startswith("repro."):
            continue
        if evt.device_type == DeviceType.CUDA:
            per[evt.key] = evt.self_device_time_total / 1e3 / slots
            total += per[evt.key]
        elif evt.device_type == DeviceType.CPU:
            host[evt.key] = (evt.self_cpu_time_total / 1e3 / slots, evt.count / slots)
    if total <= 0.0:
        return None, host
    per["total"] = total
    return per, host


class TableArrivals:
    """Plays back a numpy [T, M] arrival table on any device (staged
    once by `to`), so the card and the CPU see the same arrivals."""

    def __init__(self, table: np.ndarray):
        self.table = table
        self._on = {}

    def to(self, device):
        device = torch.device(device)
        if device not in self._on:
            self._on[device] = torch.as_tensor(self.table, device=device)
        return self

    def __call__(self, t, seed, device):
        return self.to(device)._on[torch.device(device)][t % self.table.shape[0]]


def main_instance(convert, carbon, dev):
    """The M4096xN256 main-path configuration (see the module docstring)."""
    rng = np.random.default_rng(SEED)
    M, N = M_MAIN, N_MAIN
    pe = rng.uniform(1, 8, M).astype(np.float32)
    pc = rng.uniform(2, 100, (M, N)).astype(np.float32)
    mean_arrivals = M * A_MAX / 2
    Pe = np.float32(pe.mean() * mean_arrivals / 0.86)
    Pc = np.full(N, pc.mean() * mean_arrivals / N / 0.33, np.float32)
    Qe0 = rng.integers(0, 1000, M).astype(np.float32)
    Qc0 = rng.integers(0, 1000, (M, N)).astype(np.float32)
    T_tab = max(T_MAIN, T_SERVE)
    table = carbon.diurnal_table(T_tab, N, rng)
    arrivals = rng.integers(0, A_MAX + 1, (T_tab, M)).astype(np.float32)
    return dict(
        spec=lambda d: convert.spec_from_numpy(pe, pc, Pe, Pc, d),
        state0=lambda d: convert.state_from_numpy(Qe0, Qc0, d),
        carbon=carbon.TableCarbonSource(table=table).to(dev).to("cpu"),
        arrivals=TableArrivals(arrivals).to(dev).to("cpu"),
    )


def drive_path(tag, size, policies, sim, expected, ops, dev):
    """Runs `sim(pol, T_MAIN, "summary", dev)` for each policy under sync
    debug mode "error", with the launch counters set to 0 just before
    and read just after each run. Returns ({policy: ms/slot from CUDA
    events}, {policy: result}, the counters summed over the path)."""
    ms, results, total = {}, {}, {}
    for pname, pol in policies.items():
        torch.cuda.synchronize()
        ops.reset_launch_counts()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        host0 = time.perf_counter()
        torch.cuda.set_sync_debug_mode("error")
        try:
            start.record()
            res = sim(pol, T_MAIN, "summary", dev)
            end.record()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        host_s = time.perf_counter() - host0
        launches = ops.launch_counts()
        if launches != expected[pname]:
            fail(f"{pname}: kernel launches {launches}, expected {expected[pname]}")
        for k, v in launches.items():
            total[k] = total.get(k, 0) + v
        if not (torch.isfinite(res.emissions).all() and torch.isfinite(res.Qc).all()):
            fail(f"{pname}: non-finite emissions or queues")
        if res.Qc.shape != (1, M_MAIN, N_MAIN) or res.emissions.shape != (T_MAIN,):
            fail(f"{pname}: unexpected result shapes {tuple(res.Qc.shape)}")
        ms[pname] = start.elapsed_time(end) / T_MAIN
        results[pname] = res
        say(f"[{tag}] {pname} {size} T={T_MAIN} record=summary under sync debug mode 'error': "
            f"launches {launches}; {ms[pname]:.4f} ms/slot (CUDA events), host "
            f"{1e3 * host_s / T_MAIN:.4f} ms/slot; cum emissions "
            f"{float(res.cum_emissions[-1]):.6e}, final backlog {float(res.final_backlog):.6e}, "
            f"processed {float(res.processed.sum()):.6e}")
    return ms, results, total


def profile_path(tag, policies, sim, ms, dev):
    """Where a slot's time goes: device time per slot (torch.profiler
    over 8 slots) against the unprofiled ms/slot; the rest is the device
    idle, waiting for the host to launch."""
    for pname, pol in policies.items():
        prof, host = profile_slots(lambda pol=pol: sim(pol, 8, "summary", dev), slots=8)
        top_host = sorted(((v[0], v[1], k) for k, v in host.items()), reverse=True)
        ops_per_slot = sum(v[1] for k, v in host.items() if k.startswith("aten::"))
        say(f"[{tag}] {pname}: host under the profiler {sum(v[0] for v in host.values()):.4f} "
            f"ms/slot of self time, {ops_per_slot:.1f} aten op calls/slot (nested calls "
            "counted); top host ops per slot "
            + ", ".join(f"{k[:40]} {v:.4f} ms ({c:.1f} calls)" for v, c, k in top_host[:6]))
        if prof is None:
            say(f"[{tag}] {pname}: device time per slot not measured (the profiler recorded "
                "no device time)")
            continue
        busy = prof.pop("total")
        top = sorted(((v, k) for k, v in prof.items()), reverse=True)
        say(f"[{tag}] {pname}: device busy {busy:.4f} ms/slot of {ms[pname]:.4f} ms/slot "
            f"(idle share {1.0 - busy / ms[pname]:.3f}); top kernels per slot "
            + ", ".join(f"{k[:48]} {v:.4f} ms" for v, k in top[:5]))


def in_turns(tag, policies, sim, dev):
    """ms/slot of each policy over T_MAIN slots, run in turns A, B, B, A
    (CUDA events, no sync debug mode), so that a cost of running first
    shows apart from a cost of the policy."""
    names = list(policies)
    runs = {p: [] for p in names}
    for pname in names + names[::-1]:
        torch.cuda.synchronize()
        start = torch.cuda.Event(enable_timing=True)
        end = torch.cuda.Event(enable_timing=True)
        start.record()
        sim(policies[pname], T_MAIN, "summary", dev)
        end.record()
        end.synchronize()
        runs[pname].append(start.elapsed_time(end) / T_MAIN)
    say(f"[{tag}] in turns {' '.join(names + names[::-1])}: "
        + "; ".join(f"{p} " + " / ".join(f"{x:.4f}" for x in v) + " ms/slot"
                    for p, v in runs.items()))


def card_vs_cpu(tag, policies, sim, T, queues, dev):
    """T slots on the card and through the CPU plain versions: the
    recorded `queues` bitwise, emissions within rtol 1e-6."""
    for pname, pol in policies.items():
        t0 = time.perf_counter()
        gpu = sim(pol, T, "full", dev)
        cpu = sim(pol, T, "full", "cpu")
        for q in queues:
            if not torch.equal(getattr(gpu, q).cpu(), getattr(cpu, q)):
                fail(f"{pname}: card and CPU {q} differ over T={T}")
        em_g, em_c = gpu.emissions.cpu().double(), cpu.emissions.double()
        rel = float(((em_g - em_c).abs() / em_c.abs().clamp_min(1e-30)).max())
        if rel > 1e-6:
            fail(f"{pname}: emissions differ by rtol {rel:.3e} > 1e-6")
        say(f"[{tag}] {pname} T={T} card vs CPU plain path: {', '.join(queues)} bitwise equal "
            f"over {T} slots, emissions max rel diff {rel:.3e} (limit 1e-6); "
            f"{time.perf_counter() - t0:.1f} s")


def wan_instance(convert, fleet_scenarios, M, N, T_tab, dev, j=0):
    """The congested-uplink instance of lane j (see the module
    docstring), with its arrival table and a starting backlog."""
    spec, table, amax, graph = fleet_scenarios.congested_uplink(
        M, N, 96, np.random.default_rng((SEED, 1, j)))
    rng = np.random.default_rng((SEED, 2, j))
    Qe0 = rng.integers(0, 1000, M).astype(np.float32)
    Qc0 = rng.integers(0, 1000, (M, N)).astype(np.float32)
    arrivals = rng.integers(0, amax.astype(np.int64) + 1, (T_tab, M)).astype(np.float32)
    return dict(
        spec=lambda d: convert.spec_from_numpy(spec.pe, spec.pc, spec.Pe, spec.Pc, d),
        state0=lambda d: convert.state_from_numpy(Qe0, Qc0, d),
        graph=graph,
        table=table,
        arrivals=TableArrivals(arrivals).to(dev).to("cpu"),
    )


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: torch.cuda.is_available() is False; this run needs a CUDA card",
              file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    import repro_torch.core as core
    from repro_torch import convert
    import repro_torch.network as net
    from repro_torch.configs import fleet_scenarios
    from repro_torch.configs.paper_workloads import V_PAPER, paper_spec
    from repro_torch.core import carbon
    from repro_torch.kernels import build, ops
    from repro_torch.kernels import carbon_score as cs
    from repro_torch.kernels import greedy_fill as gf
    from repro_torch.kernels import route_score as rs
    from repro_torch.serve import serve_loop

    dev = torch.device("cuda", 0)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False

    # ---- 1. device -------------------------------------------------
    name = torch.cuda.get_device_name(0)
    cap = torch.cuda.get_device_capability(0)
    smi = smi_line()
    say(f"[1 device] {name} capability {cap[0]}.{cap[1]} torch {torch.__version__} "
        f"cuda {torch.version.cuda} count {torch.cuda.device_count()}")
    say(f"[1 device] nvidia-smi: {smi}")
    if cap != (9, 0):
        fail(f"compute capability {cap}, the kernels are built for sm_90a")

    # ---- 2. build --------------------------------------------------
    t0 = time.perf_counter()
    built = build.build_all()
    say(f"[2 build] {len(built)} kernels in {time.perf_counter() - t0:.2f} s (parallel nvcc)")
    for kname, (secs, log) in built.items():
        regs = [ln.strip() for ln in log.splitlines() if "registers" in ln or "spill" in ln]
        say(f"[2 build] {kname}: {secs:.2f} s; " + " | ".join(regs))

    # ---- 3. kernels vs plain versions on the card -------------------
    max_err = {"carbon_scores": 0.0, "route_scores": 0.0, "greedy_fill": 0.0}
    g = torch.Generator(device=dev)
    g.manual_seed(SEED)

    def check_scores(Qc, pc, Qe, pe, vcc, vce, label):
        got = cs.carbon_scores_cuda(Qc, pc, Qe, pe, vcc, vce)
        want = cs.carbon_scores_plain(Qc, pc, Qe, pe, vcc, vce)
        torch.cuda.synchronize()
        for part, a, b in zip(("c", "n1", "b"), got, want):
            if not torch.equal(a, b):
                fail(f"carbon_scores {label}: {part} differs from the plain version")
        err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))
        max_err["carbon_scores"] = max(max_err["carbon_scores"], err)
        say(f"[3 kernels] carbon_scores {label}: c, n1, b bitwise equal to plain")

    def rand(shape, lo, hi):
        return torch.rand(shape, generator=g, device=dev) * (hi - lo) + lo

    def ints(shape, hi):
        return torch.randint(0, hi, shape, generator=g, device=dev).float()

    for M, N in ((M_MAIN, N_MAIN), (257, 129), (100, 37), (5, 5)):
        check_scores(ints((M, N), 5000), rand((M, N), 1, 100), ints((M,), 5000),
                     rand((M,), 1, 10), rand((N,), 0, 35), rand((), 0, 35), f"{M}x{N}")
    check_scores(ints((M_MAIN, N_MAIN), 4), rand((M_MAIN, N_MAIN), 1, 100), ints((M_MAIN,), 5),
                 rand((M_MAIN,), 1, 10), rand((N_MAIN,), 0, 35), rand((), 0, 35),
                 f"{M_MAIN}x{N_MAIN} tie-heavy Qc")

    def check_routes(Qt, pt, Qcr, extra, Qe, pe, vct, vce, label):
        for mode, ex in (("with extra", extra), ("without extra", None)):
            got = rs.route_scores_cuda(Qt, pt, Qcr, ex, Qe, pe, vct, vce)
            want = rs.route_scores_plain(Qt, pt, Qcr, ex, Qe, pe, vct, vce)
            torch.cuda.synchronize()
            for part, a, b in zip(("rc", "l1", "b"), got, want):
                if not torch.equal(a, b):
                    fail(f"route_scores {label} {mode}: {part} differs from the plain version")
            err = max(float((got[0] - want[0]).abs().max()), float((got[2] - want[2]).abs().max()))
            max_err["route_scores"] = max(max_err["route_scores"], err)
        say(f"[3 kernels] route_scores {label}: rc, l1, b bitwise equal to plain, with and "
            "without extra")

    L_MAIN = 2 * N_MAIN
    for M, L in ((M_MAIN, L_MAIN), (257, 129), (100, 37), (5, 5), (300, 1), (1, 1)):
        check_routes(ints((M, L), 500), rand((M, L), 0, 5), ints((M, L), 900),
                     rand((M, L), 0, 50), ints((M,), 900), rand((M,), 1, 8), rand((L,), 0, 40),
                     rand((), 0, 40), f"{M}x{L}")
    zeros = torch.zeros((M_MAIN, L_MAIN), device=dev)
    check_routes(ints((M_MAIN, L_MAIN), 3), zeros, ints((M_MAIN, L_MAIN), 2), zeros,
                 ints((M_MAIN,), 900), rand((M_MAIN,), 1, 8), rand((L_MAIN,), 0, 40),
                 rand((), 0, 40), f"{M_MAIN}x{L_MAIN} tie-heavy rc")

    variants = {
        "stop": dict(stop_at_first_unfit=True),
        "nostop": dict(stop_at_first_unfit=False),
        "literal": dict(literal_edge_budget=True),
        "sort_key": dict(stop_at_first_unfit=False, sort_key=True),
    }

    def check_fill(S, E, C, P, label):
        for vname, kw in variants.items():
            kw, S_v = dict(kw), S
            if kw.pop("sort_key", False):
                S_v = torch.where(C > 0, -C, 1.0)
                kw["sort_key"] = S_v
            got = gf.greedy_fill_cuda(S_v, E, C, P, **kw)
            want = gf.greedy_fill_plain(S_v, E, C, P, **kw)
            torch.cuda.synchronize()
            if not torch.equal(got, want):
                fail(f"greedy_fill {label} {vname}: counts differ from the plain version")
            max_err["greedy_fill"] = max(max_err["greedy_fill"], float((got - want).abs().max()))
        say(f"[3 kernels] greedy_fill {label}: counts bitwise equal to plain in "
            f"{', '.join(variants)}")

    B, M = N_MAIN + 1, M_MAIN
    check_fill(rand((B, M), -100, 50), rand((B, M), 0.5, 10), ints((B, M), 50),
               rand((B,), 1, 40000), f"[{B},{M}]")
    for (B, M) in ((9, 120), (3, 33), (1, 7), (4, 1), (1, 1)):
        S, E, C = rand((B, M), -200, 50), rand((B, M), 0.5, 20), ints((B, M), 100)
        P = rand((B,), 0, 500)
        check_fill(S, E, C, P, f"[{B},{M}]")
        check_fill(S, E, C, torch.zeros_like(P), f"[{B},{M}] zero budget")
        check_fill(S.abs(), E, C, P, f"[{B},{M}] non-negative scores")
        check_fill(S, E, torch.zeros_like(C), P, f"[{B},{M}] zero caps")

    # ---- 4. main path at M4096xN256 --------------------------------
    inst = main_instance(convert, carbon, dev)
    spec_d, state0_d = inst["spec"](dev), inst["state0"](dev)
    spec_h, state0_h = inst["spec"]("cpu"), inst["state0"]("cpu")
    policies = {
        "CarbonIntensity": core.CarbonIntensityPolicy(V=V_PAPER),
        "QueueLength": core.QueueLengthPolicy(),
    }

    def sim(pol, T, record, d):
        spec, state0 = (spec_d, state0_d) if d == dev else (spec_h, state0_h)
        return core.simulate(pol, spec, inst["carbon"], inst["arrivals"], T, SEED,
                             state0=state0, record=record, device=d)

    expected = {
        "CarbonIntensity": {"carbon_scores": T_MAIN, "route_scores": 0, "greedy_fill": T_MAIN},
        "QueueLength": {"carbon_scores": 0, "route_scores": 0, "greedy_fill": T_MAIN},
    }
    main_ms, results, main_launches = drive_path("4 main", f"M{M_MAIN}xN{N_MAIN}", policies, sim,
                                                 expected, ops, dev)
    finals = {p: core.NetworkState(Qe=r.Qe[0], Qc=r.Qc[0]) for p, r in results.items()}
    profile_path("4 profile", policies, sim, main_ms, dev)
    in_turns("4 main", policies, sim, dev)
    card_vs_cpu("4 main", policies, sim, T_CPU, ("Qe", "Qc"), dev)

    # ---- 4b. WAN path at M4096xN256xL512 ----------------------------
    wan = wan_instance(convert, fleet_scenarios, M_MAIN, N_MAIN, T_MAIN, dev)
    wspec_d, wstate0_d = wan["spec"](dev), wan["state0"](dev)
    wspec_h, wstate0_h = wan["spec"]("cpu"), wan["state0"]("cpu")
    wgraph_d, wgraph_h = wan["graph"].to(dev), wan["graph"].to("cpu")
    wcarbon = core.TableCarbonSource(table=wan["table"]).to(dev).to("cpu")
    wan_policies = {
        "NetworkAwareDPP": net.NetworkAwareDPPPolicy(V=V_WAN),
        "StaticRoute(CarbonIntensity)": net.StaticRoutePolicy(core.CarbonIntensityPolicy(V=V_WAN)),
    }

    def wan_sim(pol, T, record, d):
        spec, state0, graph = ((wspec_d, wstate0_d, wgraph_d) if d == dev
                               else (wspec_h, wstate0_h, wgraph_h))
        return core.simulate(pol, spec, wcarbon, wan["arrivals"], T, SEED, state0=state0,
                             record=record, device=d, graph=graph)

    wan_expected = {
        "NetworkAwareDPP": {"carbon_scores": T_MAIN, "route_scores": T_MAIN,
                            "greedy_fill": T_MAIN},
        "StaticRoute(CarbonIntensity)": {"carbon_scores": T_MAIN, "route_scores": 0,
                                         "greedy_fill": T_MAIN},
    }
    wan_ms, wan_results, wan_launches = drive_path(
        "4b wan", f"M{M_MAIN}xN{N_MAIN}xL{wgraph_d.L}", wan_policies, wan_sim, wan_expected,
        ops, dev)
    wan_final = wan_results["NetworkAwareDPP"]
    profile_path("4b profile", wan_policies, wan_sim, wan_ms, dev)
    in_turns("4b wan", wan_policies, wan_sim, dev)
    card_vs_cpu("4b wan", wan_policies, wan_sim, T_WAN_CPU, ("Qe", "Qc", "Qt"), dev)

    # ---- 5. paper headline -----------------------------------------
    pspec = paper_spec().to(dev)
    uk = core.UKRegionalTraceSource(N=5).to(dev)
    arrive = core.UniformArrivals(M=5, amax=400)
    cum = {}
    for pname, pol in policies.items():
        t0 = time.perf_counter()
        # the random sources draw on the card from per-slot generators:
        # the loop stays free of host syncs with them too
        torch.cuda.set_sync_debug_mode("error")
        try:
            r = core.simulate(pol, pspec, uk, arrive, T_PAPER, SEED, record="summary", device=dev)
        finally:
            torch.cuda.set_sync_debug_mode(0)
        cum[pname] = float(r.cum_emissions[-1])
        say(f"[5 paper] {pname}: cumulative emissions {cum[pname]:.6e} over T={T_PAPER} under "
            f"sync debug mode 'error' ({1e3 * (time.perf_counter() - t0) / T_PAPER:.4f} ms/slot host)")
    reduction = 100.0 * (1.0 - cum["CarbonIntensity"] / cum["QueueLength"])
    if not 0.0 < reduction < 100.0:
        fail(f"paper headline reduction {reduction:.2f}% is not a reduction")
    say(f"[5 paper] emission reduction CarbonIntensity(V={V_PAPER}) vs QueueLength on the "
        f"UK-regional source: {reduction:.2f}% (paper: 54%)")

    # ---- 5b. WAN headline -------------------------------------------
    # the JAX bench's network/congested-uplink rows: M5xN5, V=0.1, T=192,
    # from empty queues and links, arrivals U{0..amax}; here 8 lanes
    t0 = time.perf_counter()
    reductions = []
    for j in range(WAN_INSTANCES):
        w = wan_instance(convert, fleet_scenarios, 5, 5, T_WAN_HEADLINE, dev, j=j)
        src = core.TableCarbonSource(table=w["table"]).to(dev)
        cum = {}
        for pname, pol in wan_policies.items():
            r = core.simulate(pol, w["spec"](dev), src, w["arrivals"], T_WAN_HEADLINE, SEED,
                              record="summary", device=dev, graph=w["graph"].to(dev))
            cum[pname] = float(r.cum_emissions[-1])
        reductions.append(100.0 * (1.0 - cum["NetworkAwareDPP"] / cum["StaticRoute(CarbonIntensity)"]))
    wan_reduction = statistics.fmean(reductions)
    say(f"[5b wan] emission reduction NetworkAwareDPP(V={V_WAN}) vs StaticRoute(CarbonIntensity) "
        f"on congested-uplink M5xN5, T={T_WAN_HEADLINE}, mean of {WAN_INSTANCES} instances: "
        f"{wan_reduction:.2f}% (per instance " + ", ".join(f"{x:.2f}" for x in reductions)
        + f"); {time.perf_counter() - t0:.1f} s")
    if not wan_reduction > 5.0:
        fail(f"WAN headline reduction {wan_reduction:.2f}% is not above 5%")

    # ---- 6. serve_loop ---------------------------------------------
    pol = policies["CarbonIntensity"]
    rep = serve_loop(pol, spec_d, inst["carbon"], inst["arrivals"], T_SERVE, SEED, device=dev)
    ref = core.simulate(pol, spec_d, inst["carbon"], inst["arrivals"], T_SERVE, SEED,
                        record="full", device=dev)
    ref_backlog = torch.stack([torch.sum(ref.Qe[t]) + torch.sum(ref.Qc[t])
                               for t in range(T_SERVE)]).cpu().numpy()
    if not (np.array_equal(rep.emissions, ref.emissions.cpu().numpy())
            and np.array_equal(rep.backlog, ref_backlog.astype(np.float64))
            and torch.equal(rep.state.Qe, ref.Qe[-1]) and torch.equal(rep.state.Qc, ref.Qc[-1])):
        fail("serve_loop trajectory differs from simulate on the card")
    say(f"[6 serve] M{M_MAIN}xN{N_MAIN} {T_SERVE} slots (warmup {rep.warmup}): decision latency "
        f"p50 {rep.p50_us:.1f} us, p95 {rep.p95_us:.1f} us, p99 {rep.p99_us:.1f} us; "
        f"{rep.tasks_per_sec:,.0f} tasks/sec; trajectory bitwise equal to simulate")

    # ---- 7. kernel times at the main path's shapes -------------------
    # inputs as the main path's last slot hands them to each kernel
    st, st_ql = finals["CarbonIntensity"], finals["QueueLength"]
    pe, pc, Pe, Pc = spec_d.as_arrays(dev)
    V = torch.full((), V_PAPER, device=dev)
    Ce, Cc = inst["carbon"](T_MAIN - 1, 0, dev)
    vcc, vce = V * Cc, V * Ce
    score_args = (st.Qc, pc, st.Qe, pe, vcc, vce)
    c, n1, b = cs.carbon_scores_cuda(*score_args)
    fill_args = (torch.cat([b[None], c.T]), torch.cat([pe[None], pc.T]),
                 torch.cat([st.Qe[None], st.Qc.T]), torch.cat([Pe.reshape(1), Pc]))
    ql_scores = torch.cat([torch.where(st_ql.Qe > 0, -st_ql.Qe, 1.0)[None],
                           torch.where(st_ql.Qc > 0, -st_ql.Qc, 1.0).T])
    ql_args = (ql_scores, fill_args[1], torch.cat([st_ql.Qe[None], st_ql.Qc.T]), fill_args[3])
    M, N, B = M_MAIN, N_MAIN, N_MAIN + 1
    rows = []

    def row(kname, source, replaces, launches, times, call_ms, plain_ms, nbytes, nops):
        warm_ms, ms = times
        bound_b, bound_o = nbytes / HBM_BYTES_PER_S * 1e3, nops / FP32_OPS_PER_S * 1e3
        rows.append({
            "name": kname, "route": "cuda", "source": source, "replaces": replaces,
            "launches": launches, "max_abs_err": max_err[kname], "ms": ms,
            "plain_ms": plain_ms, "bound_ms": max(bound_b, bound_o),
            "bound_by": "bytes" if bound_b >= bound_o else "operations", "library_ms": None,
        })
        say(f"[7 time] {kname}: {ms:.5f} ms device time from a cold L2, {warm_ms:.5f} ms warm "
            f"(CUDA graph replay, CUDA events, median) vs bound {max(bound_b, bound_o):.5f} ms "
            f"({nbytes / 1e6:.2f} MB, {nops / 1e6:.1f} M ops); {call_ms:.5f} ms per eager call; "
            f"plain version {plain_ms:.3f} ms")

    ms = graph_ms(lambda: cs.carbon_scores_cuda(*score_args), reps=20, inner=50)
    call_ms = cuda_ms(lambda: cs.carbon_scores_cuda(*score_args), reps=20, inner=50)
    plain_ms = cuda_ms(lambda: cs.carbon_scores_plain(*score_args), reps=5, inner=3)
    row("carbon_scores", "src/repro_torch/kernels/csrc/carbon_score.cu",
        "src/repro/kernels/carbon_score.py:69", main_launches["carbon_scores"], ms, call_ms,
        plain_ms,
        nbytes=4 * (3 * M * N + 4 * M + N + 1), nops=3 * M * N + 2 * M)

    # greedy_fill: scores and energies are read and counts written for
    # every item; caps are read, and the walk steps, only for the
    # negative-score items of this run's inputs
    n_neg = int((fill_args[0] < 0).sum())
    ms = graph_ms(lambda: gf.greedy_fill_cuda(*fill_args), reps=10, inner=10)
    call_ms = cuda_ms(lambda: gf.greedy_fill_cuda(*fill_args), reps=10, inner=10)
    ms_ql = graph_ms(lambda: gf.greedy_fill_cuda(*ql_args, stop_at_first_unfit=False,
                                                 sort_key=ql_scores), reps=10, inner=10)[1]
    plain_ms = cuda_ms(lambda: gf.greedy_fill_plain(*fill_args), reps=3, inner=1)
    L = max(1, (M - 1).bit_length())  # bitonic sort over 2^L slots: 2^(L-1) * L(L+1)/2 compares
    row("greedy_fill", "src/repro_torch/kernels/csrc/greedy_fill.cu",
        "src/repro/core/policies.py:53", main_launches["greedy_fill"], ms, call_ms, plain_ms,
        nbytes=4 * (3 * B * M + n_neg + B),
        nops=B * (2 * M + (1 << (L - 1)) * L * (L + 1) // 2) + 4 * n_neg)
    n_neg_ql = int((ql_scores < 0).sum())
    say(f"[7 time] greedy_fill with QueueLength inputs (sort_key, no stop): {ms_ql:.5f} ms device "
        f"time (cold L2), {n_neg_ql} negative-score items; the row above had CarbonIntensity inputs, "
        f"{n_neg} negative-score items over {B} lanes")

    # route_scores: inputs as the WAN path's last NetworkAwareDPP slot
    # hands them, in the mode without extra that the path runs; the
    # mode with extra (route_compute_weight != 0) on the same inputs
    Qt_f, Qc_f, Qe_f = wan_final.Qt[0], wan_final.Qc[0], wan_final.Qe[0]
    wpe = wspec_d.as_arrays(dev)[0]
    Vw = torch.full((), V_WAN, device=dev)
    wCe, wCc = wcarbon(T_MAIN - 1, 0, dev)
    VCt = Vw * torch.cat([wCe.reshape(1), wCc]).index_select(0, wgraph_d.region)
    route_args = (Qt_f, wgraph_d.pt, Qc_f.index_select(1, wgraph_d.dest), None, Qe_f, wpe, VCt,
                  Vw * wCe)
    extra = rand(tuple(Qt_f.shape), 0, 50)
    extra_args = route_args[:3] + (extra,) + route_args[4:]
    Lw = wgraph_d.L
    ms = graph_ms(lambda: rs.route_scores_cuda(*route_args), reps=20, inner=50)
    call_ms = cuda_ms(lambda: rs.route_scores_cuda(*route_args), reps=20, inner=50)
    plain_ms = cuda_ms(lambda: rs.route_scores_plain(*route_args), reps=5, inner=3)
    row("route_scores", "src/repro_torch/kernels/csrc/route_score.cu",
        "src/repro/kernels/route_score.py:82", wan_launches["route_scores"], ms, call_ms,
        plain_ms, nbytes=4 * (4 * M * Lw + 4 * M + Lw + 1), nops=3 * M * Lw + 2 * M)
    warm_x, cold_x = graph_ms(lambda: rs.route_scores_cuda(*extra_args), reps=20, inner=50)
    say(f"[7 time] route_scores with extra (route_compute_weight != 0): {cold_x:.5f} ms from a "
        f"cold L2, {warm_x:.5f} ms warm vs bound "
        f"{4 * (5 * M * Lw + 4 * M + Lw + 1) / HBM_BYTES_PER_S * 1e3:.5f} ms (bytes)")

    say(json.dumps({"kernels": rows}))
    say(smi)  # the nvidia-smi name, power limit line as it prints it
    say(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": name,
                                           "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
