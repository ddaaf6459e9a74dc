"""Faulted simulators (counterpart of `repro.faults.sim`): the slot loops
of `core.simulator.simulate` and `network.sim.simulate_network` with the
fault processes in their carry.

`simulate(..., faults=...)`, `simulate_network(..., faults=...)` and
`simulate_fleet` on a fleet with a fault axis delegate here. With
`faults=no_faults(...)` these loops reduce to bitwise identities of the
fault-free ones.

Slot order (the fault hooks around the fault-free order):

  true carbon, arrivals, the slot's fault uniforms (one draw launch)
  -> fault chains step (outages, brownouts, flaps, telemetry); the retry
     pool releases toward Qc with exponential backoff
  -> the policy acts on the OBSERVED (possibly stale) intensities, a
     spec whose cloud budgets are scaled by the capacity factors, and a
     `fault_view=` keyword (base policies ignore it; StalenessGuardPolicy
     degrades on it)
  -> service masking: w_eff = w * cloud_on
  -> emissions at TRUE intensities on the effective action
  -> task failures drawn out of w_eff into the retry pool; their spent
     energy is in the ledger already and is reported as `wasted`
  -> queues step: Qc gains dispatches (or deliveries) and released
     retries.

Conservation, per slot and exact in float32 integral counts:
  cum(arrived) = Qe + Qc [+ Qt] + retry + cum(processed) - cum(failed).

With `deadlines=` the deadline layer runs in both loops as in the
fault-free ones; its clock runs on edge waiting, so outages that starve
dispatch show up as expiries (or, with shedding on, as sheds), and the
retry pool, already dispatched, never expires. Conservation then adds
cum(missed) + cum(shed) to the right-hand side.

The fault stream is `fold_in(key, FAULT_STREAM_SALT)`, then each slot
`fold_in(., t)` split two ways (`model.fault_draws`), so the carbon,
arrival and policy streams are the fault-free run's bitwise. As in the
fault-free loops every tensor lives on the device, no slot syncs with the
host, and every tensor may carry a leading lane axis (a fleet).
"""
from __future__ import annotations

from typing import Callable, NamedTuple

import torch

from repro_torch import random as R
from repro_torch.core import rng
from repro_torch.core.queueing import DTYPE, Action, NetworkSpec, NetworkState, emissions, init_state
from repro_torch.core.simulator import (
    ForecastFeed,
    SlotLoop,
    SlotProbe,
    deadline_edge,
    make_slot_loop,
    record_stride,
    start_deadlines,
    start_taps,
)
from repro_torch.device import DEFAULT_DEVICE
from repro_torch.faults.model import (
    FAULT_STREAM_SALT,
    FaultParams,
    fault_draws,
    init_faults,
    requeue_failed,
    step_faults,
)
from repro_torch.telemetry.profile import slot_range


class FaultSimResult(NamedTuple):
    """SimResult plus the fault ledger. `processed` counts processing
    attempts on up clouds; completed work is processed - failed.
    `backlog` is the post-step total Qe + Qc + retry every slot. A fleet
    adds a leading [F] axis to every field."""

    emissions: torch.Tensor      # [T] per-slot carbon (true intensities)
    cum_emissions: torch.Tensor  # [T]
    Qe: torch.Tensor             # [R, M] edge queues (post-step)
    Qc: torch.Tensor             # [R, M, N] cloud queues (post-step)
    retry: torch.Tensor          # [R, M, N] retry pool (post-step)
    arrived: torch.Tensor        # [T] tasks arriving at the edge
    dispatched: torch.Tensor     # [T] tasks dispatched
    processed: torch.Tensor      # [T] processing attempts (post service mask)
    energy_edge: torch.Tensor    # [T]
    energy_cloud: torch.Tensor   # [T, N]
    failed: torch.Tensor         # [T] tasks failed and banked for retry
    requeued: torch.Tensor       # [T] retry tasks released back into Qc
    wasted: torch.Tensor         # [T] carbon spent on failed attempts
    stale: torch.Tensor          # [T] carbon-signal age seen by the policy
    clouds_down: torch.Tensor    # [T] clouds with zero capacity this slot
    backlog: torch.Tensor        # [T] Qe + Qc + retry totals (post-step)
    telemetry: object = None     # a telemetry.Telemetry frame, or None
    deadlines: object = None     # a deadlines.DeadlineLedger, or None

    @property
    def final_backlog(self) -> torch.Tensor:
        return self.Qe[-1].sum() + self.Qc[-1].sum() + self.retry[-1].sum()


class NetFaultSimResult(NamedTuple):
    """NetSimResult plus the fault ledger (see FaultSimResult)."""

    emissions: torch.Tensor
    cum_emissions: torch.Tensor
    Qe: torch.Tensor             # [R, M]
    Qc: torch.Tensor             # [R, M, N]
    Qt: torch.Tensor             # [R, M, L]
    retry: torch.Tensor          # [R, M, N]
    arrived: torch.Tensor        # [T]
    dispatched: torch.Tensor     # [T]
    delivered: torch.Tensor      # [T]
    processed: torch.Tensor      # [T]
    energy_edge: torch.Tensor    # [T]
    energy_transfer: torch.Tensor  # [T]
    energy_cloud: torch.Tensor   # [T, N]
    failed: torch.Tensor         # [T]
    requeued: torch.Tensor       # [T]
    wasted: torch.Tensor         # [T]
    stale: torch.Tensor          # [T]
    clouds_down: torch.Tensor    # [T]
    links_down: torch.Tensor     # [T] routes with zero bandwidth this slot
    backlog: torch.Tensor        # [T] Qe + Qc + Qt + retry (post-step)
    telemetry: object = None     # a telemetry.Telemetry frame, or None
    deadlines: object = None     # a deadlines.DeadlineLedger, or None

    @property
    def final_backlog(self) -> torch.Tensor:
        return self.Qe[-1].sum() + self.Qc[-1].sum() + self.Qt[-1].sum() + self.retry[-1].sum()


# the per-slot scalar series of both loops (the WAN loop adds delivered,
# energy_transfer and links_down)
_SERIES = ("emissions", "arrived", "dispatched", "processed", "energy_edge", "failed",
           "requeued", "wasted", "stale", "clouds_down", "backlog")


def _total(x: torch.Tensor, dims: int) -> torch.Tensor:
    return torch.sum(x, dim=tuple(range(-dims, 0)))


class _Faulted:
    """What both faulted loops share: the loop, its fault stream and
    carry, the deadline carry and tape when the loop has the layer, the
    recorder of every series and queue, and the slot's fault step up to
    the policy's call."""

    def __init__(self, loop: SlotLoop, faults: FaultParams, key, state0, T: int, record,
                 forecaster, error_params, telemetry=None, L=None, extra_series=(),
                 extra_queues=()):
        self.loop = loop
        dev = loop.device
        spec = loop.spec
        self.M, self.N = spec.M, spec.N
        self.pe, self.pc, self.Pe, self.Pc = spec.as_arrays(dev)
        self.faults = faults.to(dev)
        self.lanes = tuple(self.pe.shape[:-1])
        F = self.lanes[0] if self.lanes else None
        self.k_fault = R.fold_in(rng.key_of(key, dev), FAULT_STREAM_SALT)
        self.L = L
        self.state = init_state(self.M, self.N, device=dev, F=F) if state0 is None else \
            NetworkState(Qe=state0.Qe.to(dev, DTYPE), Qc=state0.Qc.to(dev, DTYPE))
        self.fs = init_faults(self.M, self.N, L, device=dev, F=F)
        self.feed = None if forecaster is None else ForecastFeed.start(forecaster, loop,
                                                                       error_params)
        self.stride = record_stride(record, T)
        zeros = lambda *shape: torch.zeros(self.lanes + shape, dtype=DTYPE, device=dev)  # noqa: E731
        self.series = {n: zeros(T) for n in _SERIES + tuple(extra_series)}
        # stale is int32, as the view has it (the result's field is its float32)
        self.series["stale"] = torch.zeros(self.lanes + (T,), dtype=torch.int32, device=dev)
        self.series["energy_cloud"] = zeros(T, self.N)
        R_ = T // self.stride
        self.queues = {"Qe": zeros(R_, self.M), "Qc": zeros(R_, self.M, self.N),
                       "retry": zeros(R_, self.M, self.N)}
        for n, width in extra_queues:
            self.queues[n] = zeros(R_, self.M, width)
        self.dstate = self.tape = None
        if loop.deadlines is not None:
            self.dstate, self.tape = start_deadlines(loop.deadlines, self.M, self.lanes, T,
                                                     record, dev)
        shared = {n: self.series[n] for n in ("arrived", "failed", "wasted", "backlog", "stale",
                                               "clouds_down", "processed")}
        if self.tape is not None:
            shared.update(missed=self.tape.missed, shed=self.tape.shed)
        self.taps = start_taps(telemetry, self.lanes, T, self.N, record, dev,
                               emissions=self.series["emissions"], **shared)
        # the backlog series: the tape's probe writes it, or this one
        self.sums = SlotProbe({"backlog": self.series["backlog"]}, self.lanes, T) \
            if self.taps is None else None

    def observe(self, t: int):
        """Carbon, arrivals and the fault step of slot t: (Ce, Cc, a,
        view, spec_t, the observed Ce and Cc, the policy's keywords)."""
        loop = self.loop
        k_carbon, k_arrive, _ = loop.keys
        Ce, Cc = loop.carbon_source(t, k_carbon, loop.device)
        a = loop.arrival_source(t, k_arrive, loop.device)
        self.u = fault_draws(self.k_fault, t, self.M, self.N, self.L)
        self.fs, view = step_faults(self.fs, self.faults, t, self.u,
                                    torch.cat([Ce[..., None], Cc], dim=-1))
        spec_t = NetworkSpec(pe=self.pe, pc=self.pc, Pe=self.Pe, Pc=self.Pc * view.cloud_cap)
        obs_Ce, obs_Cc = view.obs_row[..., 0], view.obs_row[..., 1:]
        kw = {"fault_view": view}
        if self.feed is not None:
            kw["forecast"] = self.feed(obs_Ce, obs_Cc, t)
        if self.tape is not None:
            from repro_torch.deadlines.model import deadline_view

            kw["deadline_view"] = deadline_view(loop.deadlines, self.dstate)
        return Ce, Cc, a, view, spec_t, obs_Ce, obs_Cc, kw

    def edge(self, t: int, d_sum, a):
        """The edge queue after slot t: its dispatches out and the
        arrivals in, through the deadline layer when the loop has it."""
        Qe = self.state.Qe
        if self.tape is None:
            return torch.clamp_min(Qe - d_sum, 0.0) + a
        Qe, self.dstate, expired, shed, admitted = deadline_edge(self.loop.deadlines, self.dstate,
                                                                 Qe, d_sum, a)
        self.tape.put(t, expired, shed, admitted, self.dstate.Qd)
        return Qe

    def ledger(self):
        return None if self.tape is None else self.tape.ledger()

    def probe(self, t: int, landed, backlog, **sums):
        """Slot t's backlog (the totals of the parts `backlog` added left
        to right, as the JAX loop sums them) and, with taps on, the tape's
        fields that the series do not hold (`TapTape.slot`: the tasks
        landing in each cloud and the totals of `sums`): one `tap_probe`
        launch either way."""
        if self.taps is not None:
            self.taps.slot(t, landed, backlog=backlog, **sums)
        else:
            self.sums(t, backlog)

    def frame(self):
        return None if self.taps is None else self.taps.frame()

    def fail(self, w_eff):
        self.fs, failed = requeue_failed(self.fs, self.faults, w_eff, self.u.fail)
        return failed

    def put(self, t: int, **values):
        for n, v in values.items():
            self.series[n][..., t] = v

    def keep(self, t: int, **queues):
        """Records the post-step queues at the end of every stride."""
        if (t + 1) % self.stride == 0:
            r = (t + 1) // self.stride - 1
            for n, q in queues.items():
                self.queues[n].select(len(self.lanes), r).copy_(q)


def simulate_faulted(policy: Callable, spec: NetworkSpec, faults: FaultParams,
                     carbon_source: Callable, arrival_source: Callable, T: int, key=0,
                     state0: NetworkState | None = None, record: str | int = "full",
                     device=DEFAULT_DEVICE, forecaster=None, error_params=None,
                     telemetry=None, deadlines=None) -> FaultSimResult:
    """The link-free faulted run on `device`; see the module docstring for
    the slot order. `record`, `forecaster`, `error_params` and
    `deadlines` work as in `core.simulate`; the forecaster sees what the
    telemetry feed delivers (the frozen row during dropouts).
    `telemetry` works as in `core.simulate`; the probe reads the fault
    ledger (failures, waste, staleness, clouds down, the retry pool)."""
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, key, device, deadlines,
                          horizon=T)
    run = _Faulted(loop, faults, key, state0, T, record, forecaster, error_params, telemetry)
    _, _, k_policy = loop.keys
    pe, pc = run.pe, run.pc
    for t in slot_range(T):
        Ce, Cc, a, view, spec_t, obs_Ce, obs_Cc, kw = run.observe(t)
        act = policy(run.state, spec_t, obs_Ce, obs_Cc, a, rng.SlotKey(k_policy, t), **kw)
        w_eff = act.w * view.cloud_on[..., None, :]
        C_t = emissions(loop.spec, Action(d=act.d, w=w_eff), Ce, Cc)
        failed = run.fail(w_eff)
        run.state = NetworkState(
            Qe=run.edge(t, torch.sum(act.d, dim=-1), a),
            Qc=torch.clamp_min(run.state.Qc - w_eff, 0.0) + act.d + view.released,
        )
        run.put(t, emissions=C_t, arrived=torch.sum(a, dim=-1),
                dispatched=_total(act.d, 2), processed=_total(w_eff, 2),
                energy_edge=_total(act.d * pe[..., :, None], 2),
                failed=_total(failed, 2), requeued=_total(view.released, 2),
                wasted=torch.sum(Cc * torch.sum(failed * pc, dim=-2), dim=-1),
                stale=view.stale, clouds_down=torch.sum(1.0 - view.cloud_on, dim=-1))
        run.series["energy_cloud"][..., t, :] = torch.sum(w_eff * pc, dim=-2)
        run.probe(t, act.d, (run.state.Qe, run.state.Qc, run.fs.retry), retry_depth=run.fs.retry)
        run.keep(t, Qe=run.state.Qe, Qc=run.state.Qc, retry=run.fs.retry)
    s, q = run.series, run.queues
    return FaultSimResult(
        emissions=s["emissions"], cum_emissions=torch.cumsum(s["emissions"], dim=-1),
        Qe=q["Qe"], Qc=q["Qc"], retry=q["retry"],
        arrived=s["arrived"], dispatched=s["dispatched"], processed=s["processed"],
        energy_edge=s["energy_edge"], energy_cloud=s["energy_cloud"],
        failed=s["failed"], requeued=s["requeued"], wasted=s["wasted"],
        stale=s["stale"].to(DTYPE), clouds_down=s["clouds_down"], backlog=s["backlog"],
        telemetry=run.frame(), deadlines=run.ledger(),
    )


def simulate_network_faulted(policy: Callable, spec: NetworkSpec, graph, faults: FaultParams,
                             carbon_source: Callable, arrival_source: Callable, T: int, key=0,
                             state0: NetworkState | None = None, record: str | int = "full",
                             device=DEFAULT_DEVICE, forecaster=None, error_params=None,
                             telemetry=None, deadlines=None) -> NetFaultSimResult:
    """The WAN faulted run: link flaps scale each route's bandwidth in
    `step_links`; everything else is `simulate_faulted`'s (the deadline
    clock runs on edge waiting, before link injection)."""
    from repro_torch.network.transfer import (
        init_links,
        land_in_clouds,
        network_emissions,
        step_links,
        transfer_energy,
    )

    if faults.link_p_down is None:
        raise ValueError(
            "network fault runs need link fields: build the FaultParams with "
            f"L={graph.L} (make_faults(N, L=...)) so the flap chain matches the graph")
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, key, device, deadlines,
                          horizon=T)
    g = graph.to(loop.device)
    run = _Faulted(loop, faults, key, state0, T, record, forecaster, error_params, telemetry, L=g.L,
                   extra_series=("delivered", "energy_transfer", "links_down"),
                   extra_queues=(("Qt", g.L),))
    links = init_links(run.M, g.L, device=loop.device, F=run.lanes[0] if run.lanes else None)
    _, _, k_policy = loop.keys
    pe, pc = run.pe, run.pc
    for t in slot_range(T):
        Ce, Cc, a, view, spec_t, obs_Ce, obs_Cc, kw = run.observe(t)
        act = policy(run.state, spec_t, obs_Ce, obs_Cc, a, rng.SlotKey(k_policy, t), graph=g,
                     Qt=links.Qt, **kw)
        w_eff = act.w * view.cloud_on[..., None, :]
        C_t = network_emissions(loop.spec, g, act._replace(w=w_eff), Ce, Cc)
        links, delivered = step_links(links, g, act.dt, bw_scale=view.bw_scale)
        land = land_in_clouds(delivered, g, run.N)
        failed = run.fail(w_eff)
        run.state = NetworkState(
            Qe=run.edge(t, torch.sum(act.dt, dim=-1), a),
            Qc=torch.clamp_min(run.state.Qc - w_eff, 0.0) + land + view.released,
        )
        run.put(t, emissions=C_t, arrived=torch.sum(a, dim=-1),
                dispatched=_total(act.dt, 2), delivered=_total(delivered, 2),
                processed=_total(w_eff, 2), energy_edge=_total(act.dt * pe[..., :, None], 2),
                energy_transfer=torch.sum(transfer_energy(g, act.dt), dim=-1),
                failed=_total(failed, 2), requeued=_total(view.released, 2),
                wasted=torch.sum(Cc * torch.sum(failed * pc, dim=-2), dim=-1),
                stale=view.stale, clouds_down=torch.sum(1.0 - view.cloud_on, dim=-1),
                links_down=torch.sum(1.0 - view.link_on, dim=-1))
        run.series["energy_cloud"][..., t, :] = torch.sum(w_eff * pc, dim=-2)
        run.probe(t, land, (run.state.Qe, run.state.Qc, links.Qt, run.fs.retry),
                  retry_depth=run.fs.retry, transfer_occupancy=links.Qt)
        run.keep(t, Qe=run.state.Qe, Qc=run.state.Qc, Qt=links.Qt, retry=run.fs.retry)
    s, q = run.series, run.queues
    return NetFaultSimResult(
        emissions=s["emissions"], cum_emissions=torch.cumsum(s["emissions"], dim=-1),
        Qe=q["Qe"], Qc=q["Qc"], Qt=q["Qt"], retry=q["retry"],
        arrived=s["arrived"], dispatched=s["dispatched"], delivered=s["delivered"],
        processed=s["processed"], energy_edge=s["energy_edge"],
        energy_transfer=s["energy_transfer"], energy_cloud=s["energy_cloud"],
        failed=s["failed"], requeued=s["requeued"], wasted=s["wasted"],
        stale=s["stale"].to(DTYPE), clouds_down=s["clouds_down"], links_down=s["links_down"],
        backlog=s["backlog"], telemetry=run.frame(), deadlines=run.ledger(),
    )
