"""Carbon-aware WAN transfer subsystem, in PyTorch (counterpart of
`repro.network`).

A `LinkGraph` of bandwidth-capped, carbon-priced routes sits between
the edge and the clouds; the in-flight transfer queue `Qt [M, L]` runs
through the slot loop (`simulate_network`, or `core.simulate(graph=)`),
and `NetworkAwareDPPPolicy` ranks (task type, route) pairs by queue
drift plus V-weighted carbon, through the `route_scores` kernel on the
card. Regression anchor: on `direct_graph` the whole stack is bitwise
the link-free simulator under `CarbonIntensityPolicy`.
"""
from repro_torch.network.graph import (
    LinkGraph,
    congested_uplink_graph,
    direct_graph,
    make_graph,
    multi_region_wan_graph,
    stack_graphs,
    star_graph,
)
from repro_torch.network.policy import NetworkAwareDPPPolicy, StaticRoutePolicy
from repro_torch.network.sim import NetSimResult, simulate_network
from repro_torch.network.transfer import (
    LinkState,
    NetAction,
    init_links,
    land_in_clouds,
    network_emissions,
    step_links,
    transfer_energy,
)

__all__ = [
    "LinkGraph",
    "LinkState",
    "NetAction",
    "NetSimResult",
    "NetworkAwareDPPPolicy",
    "StaticRoutePolicy",
    "congested_uplink_graph",
    "direct_graph",
    "init_links",
    "land_in_clouds",
    "make_graph",
    "multi_region_wan_graph",
    "network_emissions",
    "simulate_network",
    "stack_graphs",
    "star_graph",
    "step_links",
    "transfer_energy",
]
