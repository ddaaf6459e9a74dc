"""Fleet scenario registry and WAN topology scenarios (counterpart of
`repro.configs.fleet_scenarios`).

Each generator makes ONE instance from an instance-local numpy
generator, drawing in the JAX generator's order, so specs, graphs and
the `diurnal_table` / `bursty_table` tables are bitwise the JAX
scenario's. `build_fleet` fans a list of scenario names out to
`per_kind` instances each (generator `default_rng((seed, i, j))`, as
the JAX builder seeds them) and stacks them into a `FleetScenario` for
`simulate_fleet`. The scenarios (NetworkSpec, carbon table [Tc, N+1],
arrival caps amax [M]):

  * diurnal             -- paper workload mix under day/night carbon
                           cycles with per-region phase jitter.
  * diurnal-slack       -- diurnal carbon at ~60% load.
  * bursty              -- rare multi-slot carbon spikes + heavy-tailed
                           per-type arrival caps.
  * heterogeneous-fleet -- per-instance scaling of task energies and
                           cloud budgets.
  * overload            -- ~1.8x the diurnal load.
  * multi-region-uk     -- UK regional traces with the region -> site
                           assignment rotated per instance. Its table
                           comes from the port's `uk_regional_table`,
                           bitwise the JAX package's (float32 op by
                           op, glibc's sinf, the twin's `normal`).

The WAN scenarios add a LinkGraph. Task data volumes scale with compute
cost: size[m] = pc[m, 0] / 20.

  * star                -- one finite direct link per cloud.
  * congested-uplink    -- per cloud a wide, dirty primary and a clean,
                           narrow alternate on a green backbone whose
                           total bandwidth sits at the offered load.
  * multi-region-uk-wan -- ESO-style regional traces with direct and
                           relayed routes.

multi-region-uk-wan renders its table with the port's
`uk_regional_table` on `device`, as multi-region-uk does.
`build_network_fleet` stacks `per_kind` instances of each named
topology (generator `default_rng((seed, 1 + i, j))`, as the JAX
function seeds them) into a FleetScenario whose stacked graph routes
every lane through the transfer layer.

The fault scenarios (`with_faults`) and the deadline scenarios
(`with_deadlines`) add per-lane fault and deadline parameters to a
fleet, each lane from its own numpy generator, bitwise JAX's.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, Dict, Sequence

import numpy as np

from repro_torch.configs.paper_workloads import A_MAX, paper_spec
from repro_torch.core.carbon import _UK_REGIONS, bursty_table, diurnal_table, uk_regional_table
from repro_torch.core.queueing import NetworkSpec
from repro_torch.core.simulator import FleetScenario, stack_scenarios
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.network.graph import congested_uplink_graph, multi_region_wan_graph, star_graph


def _base(M: int, N: int) -> NetworkSpec:
    """Paper Table-I spec tiled/truncated to (M, N)."""
    base = paper_spec()
    pe = np.resize(np.asarray(base.pe, np.float32), M)
    pc_col = np.resize(np.asarray(base.pc, np.float32)[:, 0], M)
    pc = np.tile(pc_col[:, None], (1, N))
    scale = (M / base.M) * (N / base.N)
    return NetworkSpec(
        pe=pe,
        pc=pc,
        Pe=float(base.Pe) * (M / base.M),
        Pc=np.full((N,), float(np.asarray(base.Pc)[0]) * scale / N, np.float32),
    )


def diurnal(M: int, N: int, Tc: int, rng: np.random.Generator, device=DEFAULT_DEVICE):
    spec = _base(M, N)
    amax = np.full((M,), float(A_MAX), np.float32)
    return spec, diurnal_table(Tc, N, rng), amax


def bursty(M: int, N: int, Tc: int, rng: np.random.Generator, device=DEFAULT_DEVICE):
    spec = _base(M, N)
    # heavy-tailed workload mix: a few hot types, many cold ones
    amax = np.round(A_MAX * rng.pareto(1.5, M).clip(0.05, 4.0)).astype(np.float32)
    return spec, bursty_table(Tc, N, rng), amax


def heterogeneous_fleet(M: int, N: int, Tc: int, rng: np.random.Generator,
                        device=DEFAULT_DEVICE):
    base = _base(M, N)
    # mixed hardware generations: per-cloud efficiency and budget spread,
    # per-type edge-link cost spread
    eff = rng.uniform(0.5, 2.0, (1, N)).astype(np.float32)
    spec = dataclasses.replace(
        base,
        pe=np.asarray(base.pe) * rng.uniform(0.5, 2.0, M).astype(np.float32),
        pc=np.asarray(base.pc) * eff,
        Pc=np.asarray(base.Pc) * rng.uniform(0.4, 1.6, N).astype(np.float32),
    )
    amax = np.round(A_MAX * rng.uniform(0.3, 1.5, M)).astype(np.float32)
    return spec, diurnal_table(Tc, N, rng), amax


def diurnal_slack(M: int, N: int, Tc: int, rng: np.random.Generator, device=DEFAULT_DEVICE):
    """Diurnal carbon with ~40% capacity headroom: arrivals scaled down
    so deferring work out of intensity peaks is feasible."""
    spec = _base(M, N)
    amax = np.full((M,), round(0.6 * A_MAX), np.float32)
    return spec, diurnal_table(Tc, N, rng, amp=110.0, noise=15.0), amax


def overload(M: int, N: int, Tc: int, rng: np.random.Generator, device=DEFAULT_DEVICE):
    """Offered load ~1.8x the plain diurnal scenario: no policy clears
    these queues."""
    spec = _base(M, N)
    amax = np.round(1.8 * A_MAX * rng.uniform(0.9, 1.1, M)).astype(np.float32)
    return spec, diurnal_table(Tc, N, rng), amax


def multi_region_uk(M: int, N: int, Tc: int, rng: np.random.Generator,
                    device=DEFAULT_DEVICE):
    spec = _base(M, N)
    amax = np.full((M,), float(A_MAX), np.float32)
    table = uk_regional_table(Tc, N, seed=int(rng.integers(1 << 30)),
                              rotate=int(rng.integers(len(_UK_REGIONS))), device=device)
    return spec, table, amax


SCENARIOS: Dict[str, Callable] = {
    "diurnal": diurnal,
    "diurnal-slack": diurnal_slack,
    "bursty": bursty,
    "heterogeneous-fleet": heterogeneous_fleet,
    "multi-region-uk": multi_region_uk,
    "overload": overload,
}


def build_fleet(kinds: Sequence[str] = tuple(SCENARIOS), per_kind: int = 16, M: int = 5,
                N: int = 5, Tc: int = 96, seed: int = 0, device=DEFAULT_DEVICE) -> FleetScenario:
    """Stacks `per_kind` instances of every named scenario (F =
    len(kinds) * per_kind). Unknown names raise KeyError listing the
    registry. `device` renders multi-region-uk's tables."""
    instances = []
    for i, kind in enumerate(kinds):
        try:
            gen = SCENARIOS[kind]
        except KeyError:
            raise KeyError(f"unknown scenario {kind!r}; registered: {sorted(SCENARIOS)}") from None
        for j in range(per_kind):
            instances.append(gen(M, N, Tc, np.random.default_rng((seed, i, j)), device=device))
    return stack_scenarios(instances)


def _task_sizes(spec: NetworkSpec) -> np.ndarray:
    return (np.asarray(spec.pc, np.float32)[:, 0] / 20.0).astype(np.float32)


def star(M: int, N: int, Tc: int, rng: np.random.Generator, device=DEFAULT_DEVICE):
    """Hub-and-spoke: bandwidth caps bite only under bursts."""
    spec = _base(M, N)
    size = _task_sizes(spec)
    load = float(0.5 * A_MAX * size.sum())  # mean size-units/slot offered
    graph = star_graph(M, N, rng, size=size, bw_range=(0.25 * load, 0.7 * load))
    amax = np.full((M,), float(A_MAX), np.float32)
    return spec, diurnal_table(Tc, N, rng), amax, graph


def congested_uplink(M: int, N: int, Tc: int, rng: np.random.Generator,
                     device=DEFAULT_DEVICE):
    """The clean alternates saturate, so a route-aware policy trades
    clean-but-queued against dirty-but-instant while a transfer-blind
    one burns the dirty primaries. The backbone is priced in the last
    cloud's region (row index N), whose intensity column is scaled down
    to backbone levels."""
    spec = _base(M, N)
    size = _task_sizes(spec)
    amax = np.full((M,), round(0.6 * A_MAX), np.float32)
    load = float(0.5 * 0.6 * A_MAX * size.sum())  # size-units/slot
    graph = congested_uplink_graph(M, N, rng, size=size, clean_bw=1.0 * load / N,
                                   dirty_bw=10.0 * load / N)
    table = diurnal_table(Tc, N, rng)
    table[:, N] = np.clip(0.25 * table[:, N], 5.0, 120.0)
    return spec, table, amax, graph


def multi_region_uk_wan(M: int, N: int, Tc: int, rng: np.random.Generator,
                        device=DEFAULT_DEVICE):
    """Relays cost ~1.8x the transfer energy but can ride a decorrelated
    wind-front trough in another region. Direct links carry the full
    offered load (the transfer-blind baseline must not be starved);
    relays have less headroom."""
    spec = _base(M, N)
    size = _task_sizes(spec)
    amax = np.full((M,), float(A_MAX), np.float32)
    load = float(0.5 * A_MAX * size.sum())
    graph = multi_region_wan_graph(M, N, rng, size=size)
    L = graph.L
    direct = np.arange(L) % 2 == 0
    bw = np.where(direct, load, 0.35 * load).astype(np.float32)
    graph = graph._replace(bw=bw * rng.uniform(0.9, 1.1, L).astype(np.float32))
    table = uk_regional_table(Tc, N, seed=int(rng.integers(1 << 30)),
                              rotate=int(rng.integers(len(_UK_REGIONS))), device=device)
    return spec, table, amax, graph


NETWORK_SCENARIOS: Dict[str, Callable] = {
    "star": star,
    "congested-uplink": congested_uplink,
    "multi-region-uk-wan": multi_region_uk_wan,
}


def build_network_fleet(kinds: Sequence[str] = ("congested-uplink", "multi-region-uk-wan"),
                        per_kind: int = 16, M: int = 5, N: int = 5, Tc: int = 96, seed: int = 0,
                        device=DEFAULT_DEVICE) -> FleetScenario:
    """WAN twin of `build_fleet`: `per_kind` instances of every named
    topology scenario, stacked with their graphs. Graphs must share (M,
    N, L), so only kinds of one route count mix: the default stacks the
    two 2N-route topologies; "star" (N routes) is built on its own.
    `device` renders multi-region-uk-wan's tables."""
    instances, graphs = [], []
    for i, kind in enumerate(kinds):
        try:
            gen = NETWORK_SCENARIOS[kind]
        except KeyError:
            raise KeyError(f"unknown network scenario {kind!r}; registered: "
                           f"{sorted(NETWORK_SCENARIOS)}") from None
        for j in range(per_kind):
            spec, table, amax, graph = gen(M, N, Tc, np.random.default_rng((seed, 1 + i, j)),
                                           device=device)
            instances.append((spec, table, amax))
            graphs.append(graph)
    return stack_scenarios(instances, graphs=graphs)


# ---------------------------------------------------------------------------
# Fault scenario registry (repro_torch.faults). Each generator returns one
# lane's FaultParams from an instance-local numpy generator, drawing in the
# JAX generator's order, so the parameters are the JAX scenario's bit for
# bit; `with_faults` stacks per-lane draws onto a fleet's `faults` axis.
#
#   * regional-blackout  -- one random cloud per lane loses all capacity
#     for a scheduled mid-run window (plus rare Markov flickers and task
#     failures): the recovery-time scenario.
#   * telemetry-brownout -- long carbon-feed dropouts plus partial capacity
#     brownouts: the staleness-guard scenario.
#   * flappy-uplink      -- WAN only: the clean alternate routes (odd link
#     indices in congested-uplink) hard-flap on a Markov chain; the dirty
#     primaries stay mostly up.


def regional_blackout(M: int, N: int, L, rng: np.random.Generator):
    from repro_torch.faults import make_faults

    del M
    sched_start = np.zeros((N,), np.float32)
    sched_len = np.zeros((N,), np.float32)
    n_b = int(rng.integers(N))
    sched_start[n_b] = float(rng.uniform(40.0, 64.0))
    sched_len[n_b] = float(rng.uniform(24.0, 48.0))
    return make_faults(N, L, device="cpu", sched_start=sched_start, sched_len=sched_len,
                       cloud_p_down=0.004, cloud_p_up=0.25, task_p_fail=0.03, backoff_max=6.0)


def telemetry_brownout(M: int, N: int, L, rng: np.random.Generator):
    from repro_torch.faults import make_faults

    del M, rng
    return make_faults(N, L, device="cpu", telem_p_down=0.10, telem_p_up=0.06,
                       brown_p_start=0.04, brown_p_end=0.20, brown_floor=0.5)


def flappy_uplink(M: int, N: int, L, rng: np.random.Generator):
    from repro_torch.faults import make_faults

    del M, rng
    if L is None:
        raise ValueError("flappy-uplink is a WAN fault scenario: build it on a network fleet "
                         "(with_faults over build_network_fleet)")
    alt = np.arange(L) % 2 == 1
    return make_faults(N, L, device="cpu",
                       link_p_down=np.where(alt, 0.12, 0.02).astype(np.float32),
                       link_p_up=np.full((L,), 0.35, np.float32),
                       link_floor=np.zeros((L,), np.float32), task_p_fail=0.01)


FAULT_SCENARIOS: Dict[str, Callable] = {
    "regional-blackout": regional_blackout,
    "telemetry-brownout": telemetry_brownout,
    "flappy-uplink": flappy_uplink,
}


def with_faults(fleet: FleetScenario, kind: str, seed: int = 0) -> FleetScenario:
    """Attaches per-lane draws of a named fault scenario to a fleet
    (stacked on the `faults` axis, float32 tensors on the CPU until
    `simulate_fleet` stages them). Lane j draws from
    default_rng((seed, 9, j)), disjoint from the instance streams of
    `build_fleet`, so the same fleet is comparable with and without
    faults."""
    from repro_torch.faults import stack_faults

    try:
        gen = FAULT_SCENARIOS[kind]
    except KeyError:
        raise KeyError(f"unknown fault scenario {kind!r}; registered: "
                       f"{sorted(FAULT_SCENARIOS)}") from None
    M = fleet.arrival_amax.shape[1]
    N = fleet.spec.Pc.shape[1]
    L = None if fleet.graph is None else fleet.graph.bw.shape[-1]
    return fleet._replace(faults=stack_faults(
        gen(M, N, L, np.random.default_rng((seed, 9, j))) for j in range(fleet.F)))


# Deadline scenarios (`repro_torch.deadlines`). Each generator returns one
# lane's DeadlineParams (float32 tensors on the CPU) from an
# instance-local numpy generator, drawing in the JAX generator's order,
# so every lane's parameters are JAX's bit for bit; `with_deadlines`
# stacks per-lane draws onto a fleet's `deadlines` axis.
#
#   * tight-uniform  -- every type a small finite deadline (2..6 extra
#     slots) and a matching WaitAwhile window; shedding off.
#   * mixed-slo      -- about half the types a tight deadline (1..4), the
#     rest none; windows follow deadlines.
#   * shed-overload  -- tight deadlines (2..4) with admission control on
#     at 0.6 headroom: the graceful-degradation scenario (pair it with
#     the "overload" arrivals).
#   * generous-slack -- deadlines of 48..59 extra slots on 64 rings,
#     wider than the waiting the benched policies induce.


def tight_uniform(M: int, rng: np.random.Generator):
    from repro_torch.deadlines import make_deadlines

    d = rng.integers(2, 7, M).astype(np.float32)
    return make_deadlines(M, device="cpu", deadline=d, window=d)


def mixed_slo(M: int, rng: np.random.Generator):
    from repro_torch.deadlines import make_deadlines

    tight = rng.random(M) < 0.5
    d = np.where(tight, rng.integers(1, 5, M).astype(np.float32), np.inf).astype(np.float32)
    return make_deadlines(M, device="cpu", deadline=d, window=d)


def shed_overload(M: int, rng: np.random.Generator):
    from repro_torch.deadlines import make_deadlines

    d = rng.integers(2, 5, M).astype(np.float32)
    return make_deadlines(M, device="cpu", deadline=d, window=d, shed_on=1.0, headroom=0.6)


def generous_slack(M: int, rng: np.random.Generator):
    from repro_torch.deadlines import make_deadlines

    d = rng.integers(48, 60, M).astype(np.float32)
    return make_deadlines(M, D=64, device="cpu", deadline=d, window=d)


DEADLINE_SCENARIOS: Dict[str, Callable] = {
    "tight-uniform": tight_uniform,
    "mixed-slo": mixed_slo,
    "shed-overload": shed_overload,
    "generous-slack": generous_slack,
}


def with_deadlines(fleet: FleetScenario, kind: str, seed: int = 0) -> FleetScenario:
    """Attaches per-lane draws of a named deadline scenario to a fleet
    (stacked on the `deadlines` axis, float32 tensors on the CPU until
    `simulate_fleet` stages them). Lane j draws from
    default_rng((seed, 11, j)), disjoint from the instance and fault
    streams, so the same fleet is comparable with and without the
    deadline layer."""
    from repro_torch.deadlines import stack_deadlines

    try:
        gen = DEADLINE_SCENARIOS[kind]
    except KeyError:
        raise KeyError(f"unknown deadline scenario {kind!r}; registered: "
                       f"{sorted(DEADLINE_SCENARIOS)}") from None
    M = fleet.arrival_amax.shape[1]
    return fleet._replace(deadlines=stack_deadlines(
        gen(M, np.random.default_rng((seed, 11, j))) for j in range(fleet.F)))
