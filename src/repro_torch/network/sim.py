"""WAN network simulator (counterpart of `repro.network.sim`): the slot
loop of `core.simulator.simulate` with the in-flight transfer queue
threaded through it.

`core.simulator.simulate(..., graph=...)` delegates here. Policies
receive two extra keywords each slot -- `graph` and the in-flight queue
`Qt [M, L]` -- and return a `NetAction(dt [M,L], w [M,N])`.

Slot order (eqs. (7)-(8) with the link hop inserted):
  observe (Ce, Cc), arrivals  ->  act (dt, w)  ->  account emissions
  (edge + per-region transfer + cloud)  ->  links inject dt, drain one
  slot of bandwidth, deliver  ->  Qe loses dispatches / gains arrivals,
  Qc loses w / gains deliveries.

As in `simulate`, a Python loop drives the slots with every tensor on
the device and no host sync inside the loop. On `direct_graph`
deliveries equal dispatches in the same slot and the transfer term is
+0.0, so the trajectory is bitwise the link-free `simulate`'s.

Every tensor may carry a leading lane axis (`core.simulate_fleet` on a
fleet with a stacked graph: the spec, the graph, the state and the keys
[F, ...]); the result's fields are then [F, ...], as JAX's vmap stacks
them. A forecaster threads through the loop as in `simulate`, and so
do the deadline layer (`deadlines=`), whose clock runs on edge
waiting: a task stops aging once it is put onto a link, and the
telemetry layer (`telemetry=`), whose probe counts the tasks landing in
each cloud (not the link injections) and the in-flight transfers.
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.core.queueing import DTYPE, NetworkSpec, NetworkState, init_state
from repro_torch.core.simulator import (
    ForecastFeed,
    deadline_edge,
    make_slot_loop,
    record_stride,
    start_deadlines,
    start_taps,
)
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.network.graph import LinkGraph
from repro_torch.network.transfer import (
    init_links,
    land_in_clouds,
    network_emissions,
    step_links,
    transfer_energy,
)
from repro_torch.telemetry.profile import slot_range


class NetSimResult(NamedTuple):
    emissions: torch.Tensor        # [T] per-slot end-to-end carbon
    cum_emissions: torch.Tensor    # [T] cumulative sum
    Qe: torch.Tensor               # [R, M] edge queues (post-step)
    Qc: torch.Tensor               # [R, M, N] cloud queues (post-step)
    Qt: torch.Tensor               # [R, M, L] in-flight transfers (post-step)
    dispatched: torch.Tensor       # [T] tasks put onto links
    delivered: torch.Tensor        # [T] tasks landed in cloud queues
    processed: torch.Tensor        # [T] tasks processed
    energy_edge: torch.Tensor      # [T] edge dispatch energy
    energy_transfer: torch.Tensor  # [T] WAN transfer energy
    energy_cloud: torch.Tensor     # [T, N] cloud compute energy
    telemetry: object = None       # a telemetry.Telemetry frame, or None
    deadlines: object = None       # a deadlines.DeadlineLedger, or None

    # R depends on `record` as in SimResult: T for "full", 1 for
    # "summary", T//k for a stride k. A fleet adds a leading [F] axis to
    # every field.

    @property
    def final_backlog(self) -> torch.Tensor:
        return self.Qe[-1].sum() + self.Qc[-1].sum() + self.Qt[-1].sum()


def simulate_network(
    policy: Callable,
    spec: NetworkSpec,
    graph: LinkGraph,
    carbon_source: Callable,
    arrival_source: Callable,
    T: int,
    key=0,
    state0: NetworkState | None = None,
    record: str | int = "full",
    device=DEFAULT_DEVICE,
    *,
    forecaster=None,
    error_params=None,
    faults=None,
    telemetry=None,
    deadlines=None,
) -> NetSimResult:
    """Runs the network + WAN for T slots under a route-aware policy on
    `device`, starting from empty links. `record` works as in
    `simulate`; scalar series always cover all T slots. `forecaster` and
    `error_params` work as in `simulate`: each slot the observed row
    updates the forecaster and the policy gets its [H, N+1] prediction
    as `forecast=`; emissions are accounted at the true intensities.
    `faults` (a FaultParams with link fields) runs the fault layer
    (`faults.simulate_network_faulted`, a NetFaultSimResult).
    `deadlines` (a DeadlineParams) threads the deadline layer as in
    `simulate`: the policy gets `deadline_view=`, the edge queue takes
    admitted - expired for the arrivals, and the result's `deadlines` is
    the ledger. `telemetry` works as in `simulate`; here the probe's
    `dispatched` is the landings a cloud and `transfer_occupancy` the
    tasks in flight."""
    if faults is not None:
        from repro_torch.faults.sim import simulate_network_faulted

        return simulate_network_faulted(policy, spec, graph, faults, carbon_source,
                                        arrival_source, T, key, state0=state0, record=record,
                                        device=device, forecaster=forecaster,
                                        error_params=error_params, telemetry=telemetry,
                                        deadlines=deadlines)
    stride = record_stride(record, T)
    R = T // stride
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, key, device, deadlines,
                          horizon=T)
    dev = loop.device
    g = graph.to(dev)
    M, N, L = loop.spec.M, loop.spec.N, g.L
    pe, pc, _, _ = loop.spec.as_arrays(dev)
    lanes = tuple(g.dest.shape[:-1])
    F = lanes[0] if lanes else None
    state = init_state(M, N, device=dev, F=F) if state0 is None else NetworkState(
        Qe=state0.Qe.to(dev, DTYPE), Qc=state0.Qc.to(dev, DTYPE)
    )
    links = init_links(M, L, device=dev, F=F)
    k_carbon, k_arrive, k_policy = loop.keys
    feed = None if forecaster is None else ForecastFeed.start(forecaster, loop, error_params)
    zeros = lambda *shape: torch.zeros(lanes + shape, dtype=DTYPE, device=dev)  # noqa: E731
    C, disp, deliv, proc, ee, et = (zeros(T) for _ in range(6))
    ec = zeros(T, N)
    Qe_rec, Qc_rec, Qt_rec = zeros(R, M), zeros(R, M, N), zeros(R, M, L)
    dl = loop.deadlines
    if dl is not None:
        from repro_torch.deadlines.model import deadline_view

        dstate, tape = start_deadlines(dl, M, lanes, T, record, dev)
    taps = start_taps(telemetry, lanes, T, N, record, dev, emissions=C, processed=proc,
                      **({} if dl is None else {"missed": tape.missed, "shed": tape.shed}))
    for t in slot_range(T):
        Ce, Cc = loop.carbon_source(t, k_carbon, dev)
        a = loop.arrival_source(t, k_arrive, dev)
        kw = {} if feed is None else {"forecast": feed(Ce, Cc, t)}
        if dl is not None:
            kw["deadline_view"] = deadline_view(dl, dstate)
        act = policy(state, loop.spec, Ce, Cc, a, rng.SlotKey(k_policy, t), graph=g, Qt=links.Qt,
                     **kw)
        C[..., t] = network_emissions(loop.spec, g, act, Ce, Cc)
        links, delivered = step_links(links, g, act.dt)
        land = land_in_clouds(delivered, g, N)
        d_sum = torch.sum(act.dt, dim=-1)
        if dl is None:
            Qe = torch.clamp_min(state.Qe - d_sum, 0.0) + a
        else:
            Qe, dstate, expired, shed, admitted = deadline_edge(dl, dstate, state.Qe, d_sum, a)
            tape.put(t, expired, shed, admitted, dstate.Qd)
        state = NetworkState(Qe=Qe, Qc=torch.clamp_min(state.Qc - act.w, 0.0) + land)
        disp[..., t] = torch.sum(act.dt, dim=(-2, -1))
        deliv[..., t] = torch.sum(delivered, dim=(-2, -1))
        proc[..., t] = torch.sum(act.w, dim=(-2, -1))
        ee[..., t] = torch.sum(act.dt * pe[..., :, None], dim=(-2, -1))
        et[..., t] = torch.sum(transfer_energy(g, act.dt), dim=-1)
        ec[..., t, :] = torch.sum(act.w * pc, dim=-2)
        if taps is not None:
            taps.slot(t, land, arrived=a, backlog=(state.Qe, state.Qc, links.Qt),
                      transfer_occupancy=links.Qt)
        if (t + 1) % stride == 0:
            r = (t + 1) // stride - 1
            Qe_rec[..., r, :] = state.Qe
            Qc_rec[..., r, :, :] = state.Qc
            Qt_rec[..., r, :, :] = links.Qt
    return NetSimResult(
        emissions=C,
        cum_emissions=torch.cumsum(C, dim=-1),
        Qe=Qe_rec,
        Qc=Qc_rec,
        Qt=Qt_rec,
        dispatched=disp,
        delivered=deliv,
        processed=proc,
        energy_edge=ee,
        energy_transfer=et,
        energy_cloud=ec,
        telemetry=None if taps is None else taps.frame(),
        deadlines=None if dl is None else tape.ledger(),
    )
