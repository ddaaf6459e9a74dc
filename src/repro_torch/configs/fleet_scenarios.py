"""WAN topology scenarios (counterpart of the network part of
`repro.configs.fleet_scenarios`).

Each generator makes ONE instance (NetworkSpec, carbon table [Tc, N+1],
arrival caps amax [M], LinkGraph) from an instance-local numpy
generator, drawing in the JAX generator's order, so the spec, the graph
and the `diurnal_table` tables are bitwise the JAX scenario's. Task data
volumes scale with compute cost: size[m] = pc[m, 0] / 20.

  * star                -- one finite direct link per cloud.
  * congested-uplink    -- per cloud a wide, dirty primary and a clean,
                           narrow alternate on a green backbone whose
                           total bandwidth sits at the offered load.
  * multi-region-uk-wan -- ESO-style regional traces with direct and
                           relayed routes.

multi-region-uk-wan renders its table with the port's
`uk_regional_table` on `device`, whose noise comes from that device's
torch generator (not the JAX threefry stream), so that table is the
port's own; parity tests feed both packages one table. The fleet
builder (`build_network_fleet`) comes with the fleet slice.
"""
from __future__ import annotations

from typing import Callable, Dict

import numpy as np

from repro_torch.configs.paper_workloads import A_MAX, paper_spec
from repro_torch.core.carbon import _UK_REGIONS, diurnal_table, uk_regional_table
from repro_torch.core.queueing import NetworkSpec
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


def _task_sizes(spec: NetworkSpec) -> np.ndarray:
    return (np.asarray(spec.pc, np.float32)[:, 0] / 20.0).astype(np.float32)


def star(M: int, N: int, Tc: int, rng: np.random.Generator):
    """Hub-and-spoke: bandwidth caps bite only under bursts."""
    spec = _base(M, N)
    size = _task_sizes(spec)
    load = float(0.5 * A_MAX * size.sum())  # mean size-units/slot offered
    graph = star_graph(M, N, rng, size=size, bw_range=(0.25 * load, 0.7 * load))
    amax = np.full((M,), float(A_MAX), np.float32)
    return spec, diurnal_table(Tc, N, rng), amax, graph


def congested_uplink(M: int, N: int, Tc: int, rng: np.random.Generator):
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
