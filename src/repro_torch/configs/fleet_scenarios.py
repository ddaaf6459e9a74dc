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
                           whose noise is the twin's `normal` (about 1%
                           of draws an ulp or so off JAX's), so parity
                           tests feed JAX's fleet through
                           `convert.fleet_from_reference`.

The WAN scenarios add a LinkGraph. Task data volumes scale with compute
cost: size[m] = pc[m, 0] / 20.

  * star                -- one finite direct link per cloud.
  * congested-uplink    -- per cloud a wide, dirty primary and a clean,
                           narrow alternate on a green backbone whose
                           total bandwidth sits at the offered load.
  * multi-region-uk-wan -- ESO-style regional traces with direct and
                           relayed routes.

multi-region-uk-wan renders its table with the port's
`uk_regional_table` on `device`, as multi-region-uk does (so parity
tests feed JAX's multi-region-uk-wan fleet through
`convert.fleet_from_reference`). `build_network_fleet` stacks `per_kind`
instances of each named topology (generator `default_rng((seed, 1 + i,
j))`, as the JAX function seeds them) into a FleetScenario whose
stacked graph routes every lane through the transfer layer.
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
