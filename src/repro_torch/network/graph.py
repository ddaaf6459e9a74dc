"""WAN link graph for carbon-aware transfer scheduling (counterpart of
`repro.network.graph`).

A `LinkGraph` describes the routes a dispatched task can take from the
edge to the clouds. Every route l has

  dest[l]    -- destination cloud index (several routes may share one)
  bw[l]      -- bandwidth in size-units per slot (inf = unconstrained)
  pt[m,l]    -- transfer energy (kWh) to move one type-m task over l
  region[l]  -- carbon-region index into the [N+1] intensity row
                (0 = edge region, 1..N = cloud regions)
  size[m]    -- data volume of a type-m task (same units as bw * slot)
  primary[n] -- the default route to cloud n (what a transfer-blind
                policy uses)

A multi-hop path is one composite route (summed pt, bottleneck bw,
dominant-hop region), so the in-flight state stays a dense [M, L] array.

The builders validate and return host data (numpy: int32 indices,
float32 values), as `paper_spec` returns a numpy spec; `LinkGraph.to`
stages a graph on a device once, before a loop. The builders draw from
an `np.random.Generator` exactly as the JAX builders do, so the same
generator state gives bitwise the same graph in both packages.
`stack_graphs` stacks graphs of one (M, N, L) onto a leading fleet axis
F (dest/region/bw [F, L], pt [F, M, L], size [F, M], primary [F, N]),
the graph of a WAN `FleetScenario`.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.core.queueing import DTYPE


class LinkGraph(NamedTuple):
    dest: object     # [L] destination cloud per route
    bw: object       # [L] bandwidth (size-units / slot; inf allowed)
    pt: object       # [M, L] transfer energy per task
    region: object   # [L] carbon-region index into the [N+1] row
    size: object     # [M] data volume per task
    primary: object  # [N] default route per cloud

    @property
    def L(self) -> int:
        return self.dest.shape[-1]

    @property
    def M(self) -> int:
        return self.size.shape[-1]

    @property
    def N(self) -> int:
        return self.primary.shape[-1]

    def to(self, device) -> "LinkGraph":
        """The graph as tensors on `device`: float32 values and int64
        indices (the index type of `scatter_` / `index_select`), a
        leading fleet axis kept. A no-op for a graph already staged
        there."""
        device = torch.device(device)

        def idx(x):
            return torch.as_tensor(x, dtype=torch.int64, device=device)

        def val(x):
            return torch.as_tensor(x, dtype=DTYPE, device=device)

        return LinkGraph(dest=idx(self.dest), bw=val(self.bw), pt=val(self.pt),
                         region=idx(self.region), size=val(self.size),
                         primary=idx(self.primary))


def make_graph(dest, bw, pt, region, size, primary) -> LinkGraph:
    """Validating constructor from host (numpy / list) data; returns a
    graph of numpy arrays."""
    # np.array copies: a JAX array's host view is read-only
    dest_h = np.array(dest, np.int32)
    bw_h = np.array(bw, np.float32)
    pt_h = np.array(pt, np.float32)
    region_h = np.array(region, np.int32)
    size_h = np.array(size, np.float32)
    primary_h = np.array(primary, np.int32)
    L, M, N = dest_h.shape[-1], size_h.shape[-1], primary_h.shape[-1]
    if bw_h.shape != (L,) or region_h.shape != (L,):
        raise ValueError(f"bw/region must be [{L}]")
    if pt_h.shape != (M, L):
        raise ValueError(f"pt must be [{M}, {L}], got {pt_h.shape}")
    if int(dest_h.max()) >= N or int(dest_h.min()) < 0:
        raise ValueError(f"dest out of range for N={N}")
    if int(region_h.max()) > N or int(region_h.min()) < 0:
        raise ValueError("region indexes the [N+1] intensity row")
    # zero/negative sizes would make floor(prog/size) NaN inside the
    # loop; negative bandwidth would silently un-transfer work
    if not np.all(size_h > 0):
        raise ValueError("size must be strictly positive per task type")
    if not np.all(bw_h >= 0):
        raise ValueError("bw must be non-negative (use inf for unconstrained links)")
    return LinkGraph(dest=dest_h, bw=bw_h, pt=pt_h, region=region_h, size=size_h,
                     primary=primary_h)


def direct_graph(M: int, N: int) -> LinkGraph:
    """The degenerate graph: one infinite-bandwidth, zero-transfer-energy
    link per cloud, in cloud order. Tasks dispatched on route n land in
    Qc[:, n] the same slot and add zero transfer carbon, so
    `NetworkAwareDPPPolicy` on it acts bitwise as `CarbonIntensityPolicy`
    (the subsystem's regression anchor)."""
    return make_graph(
        dest=np.arange(N),
        bw=np.full((N,), np.inf, np.float32),
        pt=np.zeros((M, N), np.float32),
        region=np.arange(1, N + 1),
        size=np.ones((M,), np.float32),
        primary=np.arange(N),
    )


def star_graph(M: int, N: int, rng: np.random.Generator, size=None,
               bw_range=(40.0, 160.0), pt_scale: float = 0.6) -> LinkGraph:
    """One finite-bandwidth direct link per cloud (hub-and-spoke WAN),
    priced in its destination's carbon region."""
    size = np.ones(M, np.float32) if size is None else np.asarray(size, np.float32)
    bw = rng.uniform(*bw_range, N).astype(np.float32)
    pt = (pt_scale * size[:, None] * rng.uniform(0.5, 1.5, (1, N))).astype(np.float32)
    return make_graph(dest=np.arange(N), bw=bw, pt=pt, region=np.arange(1, N + 1),
                      size=size, primary=np.arange(N))


def congested_uplink_graph(M: int, N: int, rng: np.random.Generator, size=None,
                           clean_bw: float = 25.0, dirty_bw: float = 400.0,
                           pt_clean: float = 0.4, pt_dirty: float = 2.5) -> LinkGraph:
    """Two routes per cloud: links l = 2n are the wide, energy-hungry
    primaries priced in the destination's region; links l = 2n+1 are
    clean, cheap, narrow alternates on a green backbone priced in the
    last cloud's region (row index N), which saturate under load."""
    size = np.ones(M, np.float32) if size is None else np.asarray(size, np.float32)
    L = 2 * N
    dest = np.repeat(np.arange(N), 2)
    bw = np.where(np.arange(L) % 2 == 0, dirty_bw, clean_bw).astype(
        np.float32
    ) * rng.uniform(0.9, 1.1, L).astype(np.float32)
    per_link = np.where(np.arange(L) % 2 == 0, pt_dirty, pt_clean)
    pt = (size[:, None] * per_link[None, :] * rng.uniform(0.9, 1.1, (1, L))).astype(np.float32)
    region = np.where(np.arange(L) % 2 == 0, dest + 1, N)
    return make_graph(dest=dest, bw=bw, pt=pt, region=region, size=size,
                      primary=2 * np.arange(N))


def multi_region_wan_graph(M: int, N: int, rng: np.random.Generator, size=None,
                           relay_overhead: float = 1.8) -> LinkGraph:
    """UK-WAN style: every cloud is reachable directly (l = 2n, priced in
    its own region) and through a composite relay route (l = 2n+1) priced
    in another region, at `relay_overhead` times the transfer energy."""
    size = np.ones(M, np.float32) if size is None else np.asarray(size, np.float32)
    L = 2 * N
    dest = np.repeat(np.arange(N), 2)
    bw = rng.uniform(30.0, 120.0, L).astype(np.float32)
    hop = rng.uniform(0.3, 0.9, L).astype(np.float32)
    per_link = np.where(np.arange(L) % 2 == 0, hop, relay_overhead * hop)
    pt = (size[:, None] * per_link[None, :]).astype(np.float32)
    relay_region = (dest + 1 + rng.integers(1, N, L)) % (N + 1)
    region = np.where(np.arange(L) % 2 == 0, dest + 1, relay_region)
    return make_graph(dest=dest, bw=bw, pt=pt, region=region, size=size,
                      primary=2 * np.arange(N))


def stack_graphs(graphs) -> LinkGraph:
    """Stacks graphs sharing (M, N, L) into one graph with a leading
    fleet axis (numpy), for `FleetScenario.graph` / `simulate_fleet`."""
    graphs = list(graphs)
    shapes = {(g.M, g.N, g.L) for g in graphs}
    if len(shapes) != 1:
        raise ValueError(f"stacked graphs must share (M, N, L); got {sorted(shapes)}")
    return LinkGraph(*(np.stack([np.asarray(getattr(g, f)) for g in graphs])
                       for f in LinkGraph._fields))
