"""Queueing-network simulator (paper §V numerical analysis), in PyTorch.

Counterpart of `repro.core.simulator.simulate`: every slot observes the
carbon intensities and arrivals, acts with the policy (score pass +
greedy fill), accounts emissions (eq. 5) and steps the queues (eqs.
7-8). The JAX package runs the slots in one `lax.scan`; here a Python
loop drives them with every tensor on the device and no host sync inside
the loop (no `.item()`, no copy to or from the host, no tensor used as a
Python bool), so the device never waits for the host to read a result.

`graph=` routes the run through the WAN transfer layer
(`repro_torch.network`); `forecaster=` threads a forecaster
(`repro_torch.forecast`) through the loop and hands the policy its
prediction; `faults=` runs the fault layer (`repro_torch.faults`);
`deadlines=` threads the deadline layer (`repro_torch.deadlines`: age
rings, expiry, admission shedding) through any of these loops.
`simulate_vsweep` and `simulate_fleet` run the same loop over a leading
lane axis (V values, or stacked scenarios, with a stacked WAN graph,
forecast-error lanes, fault lanes and deadline lanes), which every
tensor of the slot carries. `telemetry=` turns on the telemetry layer
(`repro_torch.telemetry`) in any of these loops: each slot records the
probe's raw fields, and the tap kernel turns them into the result's
`telemetry` frame after the run (or after every flush chunk when
streaming).
"""
from __future__ import annotations

import dataclasses
import math
from typing import Callable, NamedTuple

import numpy as np
import torch

from repro_torch import random as R
from repro_torch.core import rng
from repro_torch.core.carbon import DeviceCache, TableCarbonSource
from repro_torch.core.queueing import DTYPE, NetworkSpec, NetworkState, emissions, init_state, step
from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels import ops
from repro_torch.kernels.taps import ProbePlan, TapOut
from repro_torch.telemetry.profile import slot_range
from repro_torch.telemetry.stream import check_stream, split_telemetry, stream_flush
from repro_torch.telemetry.taps import TelemetryProbe


@dataclasses.dataclass(frozen=True)
class UniformArrivals:
    """a_m(t) ~ U{0..amax} i.i.d. (paper §V uses amax=400):
    `randint(fold_in(key, t), (M,), 0, amax + 1)`, one draw; `block`
    draws a range of slots in one (see `SlotBlocks`)."""

    M: int
    amax: int = 400

    def __call__(self, t: int, key, device) -> torch.Tensor:
        return self.block(t, None, key, device)

    def block(self, t0: int, count, key, device) -> torch.Tensor:
        """Slots t0..t0+count-1 -> [count, ..., M] (count None: slot t0)."""
        return ops.threefry_draw(rng.key_of(key, device), t0, self.M, finish="randint_f32",
                                 minval=0, maxval=self.amax + 1, count=count)

    @property
    def slot_width(self) -> int:
        return self.M

    @property
    def a_max(self) -> float:
        return float(self.amax)


@dataclasses.dataclass(frozen=True, eq=False)  # identity hash: array field
class FleetArrivals(DeviceCache):
    """The fleet's arrivals: a_m(t) = floor(u_m * (amax_m + 1)), u ~
    U[0, 1) from `uniform(fold_in(key, t), (M,))` (the JAX fleet's
    closure, `repro/core/simulator.py:644-649`). `amax` is [M] or, for F
    lanes, [F, M]; one draw either way, and one for a block of slots."""

    amax: object

    def _tensors(self, device):
        # amax + 1.0 in float32, once, as the JAX closure computes it
        return self._cached(device, lambda dev: torch.as_tensor(
            self.amax, dtype=DTYPE, device=dev) + 1.0)

    def __call__(self, t: int, key, device) -> torch.Tensor:
        return self.block(t, None, key, device)

    def block(self, t0: int, count, key, device) -> torch.Tensor:
        """Slots t0..t0+count-1 -> [count, ..., M] (count None: slot t0)."""
        scale = self._tensors(device)
        return ops.threefry_draw(rng.key_of(key, device), t0, scale.shape[-1], finish="floor",
                                 scale=scale, count=count)

    @property
    def slot_width(self) -> int:
        return int(np.shape(self.amax)[-1])


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(DeviceCache):
    """a_m(t) ~ Poisson(rate_m), clipped at `clip` to keep a_m bounded
    (Lemma 1 requires bounded arrivals). `poisson(fold_in(key, t))`:
    JAX's samplers and keys, not its bits (see `repro_torch.random`),
    two draws a slot (the fold inside them)."""

    rates: tuple
    clip: int = 2000

    def _tensors(self, device):
        return self._cached(device, lambda dev: torch.tensor(self.rates, dtype=DTYPE, device=dev))

    def __call__(self, t: int, key, device) -> torch.Tensor:
        lam = self._tensors(device)
        return torch.clamp_max(R.poisson(rng.key_of(key, device), lam, t=t).to(DTYPE),
                               float(self.clip))

    @property
    def a_max(self) -> float:
        return float(self.clip)


class SimResult(NamedTuple):
    emissions: torch.Tensor      # [T] per-slot carbon emissions C(t)
    cum_emissions: torch.Tensor  # [T] cumulative sum
    Qe: torch.Tensor             # [R, M] edge queue trajectory (post-step)
    Qc: torch.Tensor             # [R, M, N] cloud queue trajectory (post-step)
    dispatched: torch.Tensor     # [T] total tasks dispatched
    processed: torch.Tensor      # [T] total tasks processed
    energy_edge: torch.Tensor    # [T] edge energy spent
    energy_cloud: torch.Tensor   # [T, N] cloud energy spent
    telemetry: object = None     # a telemetry.Telemetry frame, or None
    deadlines: object = None     # a deadlines.DeadlineLedger, or None

    # R depends on `record`: T for "full", 1 for "summary", T//k for a
    # stride k. Scalar series cover all T slots in every mode, and
    # Qe[-1]/Qc[-1] is the final state in every mode.

    @property
    def final_backlog(self) -> torch.Tensor:
        return self.Qe[-1].sum() + self.Qc[-1].sum()


def _bind(source, device):
    """Stages a source's constant tensors on `device` before a loop."""
    to = getattr(source, "to", None)
    return to(device) if callable(to) else source


BLOCK_BYTES = 64 << 20  # the most one block draw of a source writes


class SlotBlocks:
    """A source with a `block(t0, count, key, device)` method, drawn a
    block of slots at a time: slot t is row t - t0 of the block that
    holds it, each row bitwise the source's own draw at slot t. A block
    spans the slots whose draws fit in BLOCK_BYTES (4 bytes a value,
    `slot_width` values a key), cut at the run's `horizon`."""

    def __init__(self, source, horizon: int):
        self.source, self.horizon = source, horizon
        self._held = None  # (key, t0, count, block)

    def __call__(self, t: int, key, device):
        held = self._held
        if held is None or held[0] is not key or not held[1] <= t < held[1] + held[2]:
            lanes = math.prod(key.shape[:-1]) if torch.is_tensor(key) else 1
            per_slot = 4 * lanes * self.source.slot_width
            count = max(1, min(self.horizon - t, BLOCK_BYTES // per_slot))
            held = self._held = (key, t, count, self.source.block(t, count, key, device))
        block = held[3]
        i = t - held[1]
        return tuple(x[i] for x in block) if isinstance(block, tuple) else block[i]


def _blocked(source, horizon):
    return source if horizon is None or not hasattr(source, "block") else \
        SlotBlocks(source, horizon)


class SlotLoop(NamedTuple):
    """What one slot of the paper's loop needs: the policy, the spec on
    the device, the sources, the three keys `simulate` splits from its
    key (carbon, arrivals, policy: `split(key, 3)`, on the device, [..., 2]
    each, one per lane for a fleet), as the JAX loop does, and the
    deadline layer's parameters on the device (None when it is off)."""

    policy: Callable
    spec: NetworkSpec
    carbon_source: Callable
    arrival_source: Callable
    keys: tuple
    device: torch.device
    deadlines: object = None


def make_slot_loop(policy, spec, carbon_source, arrival_source, key, device,
                   deadlines=None, horizon=None) -> SlotLoop:
    """The loop of a run of `horizon` slots (None: slots are served one
    at a time, as `serve_loop` does): sources with a `block` method are
    drawn a block of slots a launch (`SlotBlocks`)."""
    device = resolve_device(device)
    ks = R.split(rng.key_of(key, device), 3)
    return SlotLoop(
        policy=policy,
        spec=spec.to(device),
        carbon_source=_blocked(_bind(carbon_source, device), horizon),
        arrival_source=_blocked(_bind(arrival_source, device), horizon),
        keys=tuple(ks[..., i, :].contiguous() for i in range(3)),
        device=device,
        deadlines=None if deadlines is None else deadlines.to(device),
    )


class SlotProbe:
    """The sums a loop writes into [*lanes, T] series each slot, one
    `tap_probe` launch a slot: each input summed, in XLA:CPU's order,
    into the series of its name (`dispatched`: the landings [*lanes, M,
    N] over M, per cloud) and `backlog` = its parts' totals added left
    to right, a part that is also a named input summed once. The sums'
    plan is fixed at the first slot."""

    def __init__(self, series: dict, lanes: tuple, T: int):
        self.series, self.lanes, self.T, self.plan = series, lanes, T, None

    def __call__(self, t: int, backlog=(), **inputs) -> None:
        inputs = {n: x for n, x in inputs.items() if x is not None}
        parts = []
        for i, x in enumerate(backlog):
            name = next((n for n, y in inputs.items() if y is x), None)
            if name is None:
                name = f"part{i}"
                inputs[name] = x
            parts.append(name)
        if self.plan is None:
            self.plan = ProbePlan(
                self.lanes, self.T, inputs,
                {n: self.series[n] for n in inputs if n in self.series}, parts,
                self.series.get("backlog") if parts else None, by_column=("dispatched",))
        ops.tap_probe(self.plan, t, inputs)


class TapTape:
    """The telemetry probe's fields over a run of T slots ([*lanes, T],
    `dispatched` [*lanes, T, N], `stale` int32) and the tap kernel's
    outputs. A loop hands over the [*lanes, T] series it records anyway
    (`shared`: emissions and processed; the faulted loops' arrived,
    failed, wasted, clouds_down, backlog and stale; the deadline tape's
    missed and shed); the tape allocates the others, zeros where a field
    does not apply to the loop. Each slot the loop hands over the tensors
    of the fields it does not share (`slot`: one `tap_probe` launch),
    which also flushes a streamed chunk; `frame()` runs the taps and
    returns the Telemetry frame: one `tap_scan` a run, or one a chunk
    when streaming."""

    def __init__(self, telemetry, lanes: tuple, T: int, N: int, record, device, **shared):
        self.cfg, self.stream = split_telemetry(telemetry)
        if self.stream is not None:
            check_stream(self.stream, T, record)
        fields = {}
        for name in TelemetryProbe._fields:
            if name in shared:
                fields[name] = shared[name]
            elif name == "dispatched":
                fields[name] = torch.zeros(lanes + (T, N), dtype=DTYPE, device=device)
            else:
                fields[name] = torch.zeros(lanes + (T,), device=device,
                                           dtype=torch.int32 if name == "stale" else DTYPE)
        self.probe = TelemetryProbe(**fields)
        self.sums = SlotProbe(self.probe._asdict(), lanes, T)
        self.out = TapOut.empty(lanes, T, device)
        self.state = torch.zeros(lanes + (7,), dtype=DTYPE, device=device)  # init_taps, packed
        self.lanes, self.T, self.t0 = lanes, T, 0

    def slot(self, t: int, landed, arrived=None, backlog=(), **sums) -> None:
        """Writes slot t's fields that the loop does not record, then
        flushes a streamed chunk that slot t ends: `dispatched` = the
        tasks landing in each cloud (`landed` [*lanes, M, N] summed over
        M); `arrived` and each of `sums` ({field: tensor}) totalled;
        `backlog` = the parts' totals added left to right (`SlotProbe`)."""
        self.sums(t, backlog, dispatched=landed, arrived=arrived, **sums)
        if self.stream is not None and (t + 1) % self.stream.flush_every == 0:
            t0 = self.t0
            self._scan(t + 1)
            stream_flush(self.stream, self.out.series(self.probe), t0, t + 1)

    def _scan(self, t1: int) -> None:
        ops.tap_scan(self.cfg, self.probe, self.out, self.state, self.t0, t1)
        self.t0 = t1

    def frame(self):
        if self.t0 < self.T:
            self._scan(self.T)
        return self.out.frame(self.probe)


def start_taps(telemetry, lanes: tuple, T: int, N: int, record, device, **shared):
    """The tape of a run with telemetry on, None with it off (no tape,
    nothing launched)."""
    return None if telemetry is None else TapTape(telemetry, lanes, T, N, record, device, **shared)


class DeadlineTape:
    """The deadline layer's record over a run of T slots: the missed,
    shed and admitted counts a slot ([*lanes, T]) and the age rings at
    the end of every `stride`-th slot ([*lanes, T // stride, M, D]), as
    the JAX loops record them; `ledger()` is the result's `deadlines`."""

    def __init__(self, lanes: tuple, M: int, D: int, T: int, stride: int, device):
        zeros = lambda *shape: torch.zeros(lanes + shape, dtype=DTYPE, device=device)  # noqa: E731
        self.missed, self.shed, self.admitted = zeros(T), zeros(T), zeros(T)
        self.Qd = zeros(T // stride, M, D)
        self.stride = stride

    def put(self, t: int, expired, shed, admitted, Qd) -> None:
        """Slot t's counts [..., M] and its post-step rings."""
        self.missed[..., t] = torch.sum(expired, dim=-1)
        self.shed[..., t] = torch.sum(shed, dim=-1)
        self.admitted[..., t] = torch.sum(admitted, dim=-1)
        if (t + 1) % self.stride == 0:
            self.Qd[..., (t + 1) // self.stride - 1, :, :] = Qd

    def ledger(self):
        from repro_torch.deadlines.model import DeadlineLedger

        return DeadlineLedger(missed=self.missed, shed=self.shed, admitted=self.admitted,
                              Qd=self.Qd)


def start_deadlines(params, M: int, lanes: tuple, T: int, record, device):
    """The deadline carry (empty rings, a cold estimator; one a lane) and
    the tape of a run, for `params` already on `device`."""
    from repro_torch.deadlines.model import init_deadlines

    dstate = init_deadlines(M, params.D, device, F=lanes[0] if lanes else None)
    return dstate, DeadlineTape(lanes, M, params.D, T, record_stride(record, T), device)


def init_forecaster_carry(forecaster, N, key, carbon_source, error_params, device):
    """The forecaster's carry, built the one way `simulate` and the WAN
    `simulate_network` build it: the carbon key, the playback table when
    the source carries one, and the per-run (bias, noise) override of
    its ForecastErrorModel only when given (so a forecaster without an
    `error` keyword keeps working)."""
    kw = {} if error_params is None else {"error": error_params}
    return forecaster.init(N, key=key, table=getattr(carbon_source, "table", None),
                           device=device, **kw)


class ForecastFeed:
    """A forecaster and its carry in a slot loop: each slot the observed
    row (Ce, Cc) updates the carry, then the forecast [..., H, N+1] of
    slot t is the policy's `forecast=`, as the JAX scan body does it."""

    def __init__(self, forecaster, carry):
        self.forecaster, self.carry = forecaster, carry

    @classmethod
    def start(cls, forecaster, loop: "SlotLoop", error_params) -> "ForecastFeed":
        N = loop.spec.N
        return cls(forecaster, init_forecaster_carry(forecaster, N, loop.keys[0],
                                                     loop.carbon_source, error_params,
                                                     loop.device))

    def __call__(self, Ce, Cc, t: int):
        self.carry = self.forecaster.update(self.carry, torch.cat([Ce[..., None], Cc], dim=-1))
        return self.forecaster.predict(self.carry, t)


class Slot(NamedTuple):
    """What one slot of `slot_step` leaves: the next state, the action,
    the arrivals and C(t); with the deadline layer also its next carry
    and the slot's expired, shed and admitted counts [..., M]."""

    state: NetworkState
    act: object
    a: torch.Tensor
    C: torch.Tensor
    dstate: object = None
    expired: torch.Tensor | None = None
    shed: torch.Tensor | None = None
    admitted: torch.Tensor | None = None


def deadline_edge(params, dstate, Qe, d_sum, a):
    """The deadline step and the edge queue's update it gives, as every
    deadline-threaded loop of the JAX package writes it: (next Qe, next
    carry, expired, shed, admitted), Qe' = max(Qe - d_sum, 0) + admitted -
    expired in that order (bitwise `+ a` under `no_deadlines`)."""
    from repro_torch.deadlines.model import step_deadlines

    dstate, admitted, expired, shed = step_deadlines(params, dstate, d_sum, a)
    return torch.clamp_min(Qe - d_sum, 0.0) + admitted - expired, dstate, expired, shed, admitted


def slot_step(loop: SlotLoop, state: NetworkState, t: int, feed: ForecastFeed | None = None,
              dstate=None) -> Slot:
    """One slot: observe, act, account, step. The body both `simulate`
    and `serve.loop.make_serve_step` run, so their trajectories are
    bitwise equal. The policy gets its key `fold_in(k_policy, t)` as a
    `rng.SlotKey`, computed only by a policy that draws, and, with a
    forecast `feed`, the forecast of slot t. With the loop's deadline
    layer, `dstate` is its carry: the policy gets the slot's
    `deadline_view=` and the edge queue takes admitted - expired in
    place of the arrivals (`deadline_edge`)."""
    k_carbon, k_arrive, k_policy = loop.keys
    Ce, Cc = loop.carbon_source(t, k_carbon, loop.device)
    a = loop.arrival_source(t, k_arrive, loop.device)
    kw = {} if feed is None else {"forecast": feed(Ce, Cc, t)}
    if loop.deadlines is not None:
        from repro_torch.deadlines.model import deadline_view

        kw["deadline_view"] = deadline_view(loop.deadlines, dstate)
    act = loop.policy(state, loop.spec, Ce, Cc, a, rng.SlotKey(k_policy, t), **kw)
    C_t = emissions(loop.spec, act, Ce, Cc)
    if loop.deadlines is None:
        return Slot(step(state, act, a), act, a, C_t)
    Qe, dstate, expired, shed, admitted = deadline_edge(loop.deadlines, dstate, state.Qe,
                                                        torch.sum(act.d, dim=-1), a)
    nxt = NetworkState(Qe=Qe, Qc=torch.clamp_min(state.Qc - act.w, 0.0) + act.d)
    return Slot(nxt, act, a, C_t, dstate, expired, shed, admitted)


def record_stride(record, T: int) -> int:
    """The slot stride at which `record` keeps the post-step state: 1
    for "full", T for "summary", k for an int stride k dividing T. The
    state after slot t goes to row (t + 1) // stride - 1 when
    (t + 1) % stride == 0, so there are T // stride rows."""
    if record == "full":
        return 1
    if record == "summary":
        return T
    if not isinstance(record, int) or isinstance(record, bool) or record <= 0 or T % record:
        raise ValueError(
            f"record={record!r} must be 'full', 'summary', or a positive int stride dividing T={T}"
        )
    return record


def simulate(
    policy: Callable,
    spec: NetworkSpec,
    carbon_source: Callable,
    arrival_source: Callable,
    T: int,
    key=0,
    state0: NetworkState | None = None,
    record: str | int = "full",
    device=DEFAULT_DEVICE,
    graph=None,
    forecaster=None,
    error_params=None,
    faults=None,
    telemetry=None,
    deadlines=None,
) -> SimResult:
    """Runs the network for T slots under `policy` on `device`.

    `key` is an int seed (`PRNGKey(seed)`) or a threefry key. `record`
    controls how much trajectory the result carries: "full" stacks the
    post-step queues every slot; "summary" keeps only the final state (a
    length-1 leading axis); an int stride k keeps the state at the end
    of every k-th slot ([T//k, ...]). The per-slot scalar series are
    computed the same way in every mode, so they agree bitwise across
    modes.

    Sources are called as `source(t, key, device)`; sources with a
    `to(device)` method are staged on the device first.

    When `forecaster` (see `repro_torch.forecast`) is given, its carry
    runs beside the queues: each slot the observed intensity row updates
    it and its [H, N+1] prediction goes to the policy as `forecast=`
    (LookaheadDPPPolicy takes it); emissions are still accounted at the
    true intensities. The forecaster's `init` gets the carbon key, the
    playback table when the source has one (`carbon_source.table`), and
    `error_params = (bias, noise)` when given, which overrides its
    ForecastErrorModel for this run (the fleet's forecast-quality lanes).

    When `graph` (a `repro_torch.network.LinkGraph`) is given, the run
    goes through the WAN transfer layer (`network.simulate_network`):
    the policy is called with `graph=` / `Qt=` keywords, returns a
    NetAction, and the result is a NetSimResult.

    When `faults` (a `repro_torch.faults.FaultParams`) is given, the run
    goes through the fault layer (`faults.simulate_faulted`): outage,
    brownout, flap and telemetry chains join the loop, the policy sees
    the observed (possibly stale) intensities, capacity-scaled budgets
    and a `fault_view=` keyword, and the result is a FaultSimResult
    (NetFaultSimResult with a graph). With `no_faults(...)` it is
    bitwise this loop's.

    When `deadlines` (a `repro_torch.deadlines.DeadlineParams`) is given,
    the age rings and the rate estimate join the loop: the policy gets
    each slot's `deadline_view=`, overdue tasks expire, admission control
    may shed arrivals, and the result's `deadlines` is a DeadlineLedger
    (missed, shed and admitted a slot, and the rings `Qd` recorded as
    `record` says). With `no_deadlines(M)` every other field is bitwise
    the run without it. It composes with `graph`, `faults` and
    `forecaster`.

    `telemetry` (a `repro_torch.telemetry.TelemetryConfig`) turns on the
    metrics taps and SLO monitors: each slot records the probe's fields
    (most of them sums the loop keeps anyway) and after the run one
    `tap_scan` launch fills the result's `telemetry`, a Telemetry frame of
    per-slot series, run gauges and alert records, the same in every
    record mode. A `StreamConfig` also flushes each `flush_every` slots'
    TapSeries to a host channel during the run (one `tap_scan` a chunk;
    the frame is bitwise the batch frame). With `telemetry=None` nothing
    is recorded or launched and every field is bitwise the run without
    it. It composes with every other layer.
    """
    if graph is not None:
        from repro_torch.network.sim import simulate_network

        return simulate_network(policy, spec, graph, carbon_source, arrival_source, T, key,
                                state0=state0, record=record, device=device,
                                forecaster=forecaster, error_params=error_params, faults=faults,
                                telemetry=telemetry, deadlines=deadlines)
    if faults is not None:
        from repro_torch.faults.sim import simulate_faulted

        return simulate_faulted(policy, spec, faults, carbon_source, arrival_source, T, key,
                                state0=state0, record=record, device=device,
                                forecaster=forecaster, error_params=error_params,
                                telemetry=telemetry, deadlines=deadlines)
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, key, device, deadlines,
                          horizon=T)
    dev = loop.device
    state = init_state(spec.M, spec.N, device=dev) if state0 is None else NetworkState(
        Qe=state0.Qe.to(dev, DTYPE), Qc=state0.Qc.to(dev, DTYPE)
    )
    feed = None if forecaster is None else ForecastFeed.start(forecaster, loop, error_params)
    return _drive(loop, state, T, record, feed, telemetry)


def _drive(loop: SlotLoop, state: NetworkState, T: int, record, feed=None,
           telemetry=None) -> SimResult:
    """T slots of `loop` from `state`, recorded as `record` says. Every
    tensor may carry leading lanes (those of the state): the series are
    then [*lanes, T], the queues [*lanes, R, M(, N)], as the JAX
    package's vmap stacks them. With `telemetry`, each slot adds the
    probe's arrivals, landings a cloud and backlog to the tape."""
    stride = record_stride(record, T)
    R_ = T // stride
    dev = loop.device
    lanes = tuple(state.Qe.shape[:-1])
    M, N = state.M, state.N
    pe, pc, _, _ = loop.spec.as_arrays(dev)
    zeros = lambda *shape: torch.zeros(lanes + shape, dtype=DTYPE, device=dev)  # noqa: E731
    C, disp, proc, ee = zeros(T), zeros(T), zeros(T), zeros(T)
    ec = zeros(T, N)
    Qe_rec, Qc_rec = zeros(R_, M), zeros(R_, M, N)
    dstate = tape = None
    if loop.deadlines is not None:
        dstate, tape = start_deadlines(loop.deadlines, M, lanes, T, record, dev)
    taps = start_taps(telemetry, lanes, T, N, record, dev, emissions=C, processed=proc,
                      **({} if tape is None else {"missed": tape.missed, "shed": tape.shed}))
    for t in slot_range(T):
        s = slot_step(loop, state, t, feed, dstate)
        state, act = s.state, s.act
        C[..., t] = s.C
        disp[..., t] = torch.sum(act.d, dim=(-2, -1))
        proc[..., t] = torch.sum(act.w, dim=(-2, -1))
        ee[..., t] = torch.sum(act.d * pe[..., :, None], dim=(-2, -1))
        ec[..., t, :] = torch.sum(act.w * pc, dim=-2)
        if tape is not None:
            dstate = s.dstate
            tape.put(t, s.expired, s.shed, s.admitted, dstate.Qd)
        if taps is not None:
            taps.slot(t, act.d, arrived=s.a, backlog=(state.Qe, state.Qc))
        if (t + 1) % stride == 0:
            r = (t + 1) // stride - 1
            Qe_rec[..., r, :] = state.Qe
            Qc_rec[..., r, :, :] = state.Qc
    return SimResult(
        emissions=C,
        cum_emissions=torch.cumsum(C, dim=-1),
        Qe=Qe_rec,
        Qc=Qc_rec,
        dispatched=disp,
        processed=proc,
        energy_edge=ee,
        energy_cloud=ec,
        telemetry=None if taps is None else taps.frame(),
        deadlines=None if tape is None else tape.ledger(),
    )


def _lanes_of(x, F: int) -> torch.Tensor:
    """x with a leading lane axis of F, as one contiguous tensor."""
    return x.expand((F,) + tuple(x.shape)).contiguous()


def simulate_vsweep(
    make_policy: Callable,
    Vs,
    spec: NetworkSpec,
    carbon_source: Callable,
    arrival_source: Callable,
    T: int,
    key=0,
    device=DEFAULT_DEVICE,
) -> SimResult:
    """The whole simulation over a vector of V values at once (the JAX
    package's `vmap` over V, `repro/core/simulator.py:474-494`): lane i
    runs `make_policy(Vs)` with V = Vs[i], all lanes on one spec and one
    key, so every lane observes the same intensities and arrivals.
    `make_policy` receives the [F] tensor of V values on the device; a
    policy whose V enters only through arithmetic (CarbonIntensityPolicy)
    takes it as it is. Every result field has a leading [F] axis."""
    dev = resolve_device(device)
    V = _f32_on(Vs, dev).reshape(-1)
    F = V.shape[0]
    spec_d = spec.to(dev)
    lane_spec = NetworkSpec(*(_lanes_of(x, F) for x in spec_d.as_arrays(dev)))
    loop = make_slot_loop(make_policy(V), lane_spec, carbon_source, arrival_source, key, dev,
                          horizon=T)
    return _drive(loop, init_state(spec.M, spec.N, device=dev, F=F), T, "full")


class FleetSpec(NamedTuple):
    """Stacked NetworkSpec fields; every field has the leading fleet axis F."""

    pe: object  # [F, M]
    pc: object  # [F, M, N]
    Pe: object  # [F]
    Pc: object  # [F, N]


class FleetScenario(NamedTuple):
    """A stack of F independent simulation instances (numpy float32
    arrays, as `stack_scenarios` and `configs.fleet_scenarios.build_fleet`
    make them): the spec, a carbon playback table per lane (col 0 = edge,
    cols 1..N = clouds, rows repeat modulo Tc) and per-type uniform
    arrival caps. Optional axes (None = off for the whole fleet):
    `graph`, a stacked LinkGraph (`network.stack_graphs`), routes every
    lane through the WAN transfer layer; `err_bias` / `err_noise` [F]
    override each lane's ForecastErrorModel (`sweep_forecast_errors`);
    `faults`, a stacked `faults.FaultParams` (`configs.fleet_scenarios.
    with_faults`), runs every lane through the fault layer; `deadlines`,
    a stacked `deadlines.DeadlineParams` (`configs.fleet_scenarios.
    with_deadlines`; every lane its own parameters, D shared), runs every
    lane through the deadline layer."""

    spec: FleetSpec
    carbon: object        # [F, Tc, N+1] intensity playback tables
    arrival_amax: object  # [F, M] per-type uniform arrival caps
    graph: object | None = None
    err_bias: object | None = None
    err_noise: object | None = None
    faults: object | None = None
    deadlines: object | None = None

    @property
    def F(self) -> int:
        return self.arrival_amax.shape[0]

    def to(self, device) -> "FleetScenario":
        """The spec, tables, caps, graph, forecast-error, fault and
        deadline lanes as tensors on `device`, so a run copies nothing
        from the host."""
        opt = lambda x: None if x is None else _f32_on(x, device)  # noqa: E731
        return self._replace(spec=FleetSpec(*(_f32_on(x, device) for x in self.spec)),
                             carbon=_f32_on(self.carbon, device),
                             arrival_amax=_f32_on(self.arrival_amax, device),
                             graph=None if self.graph is None else self.graph.to(device),
                             err_bias=opt(self.err_bias), err_noise=opt(self.err_noise),
                             faults=None if self.faults is None else self.faults.to(device),
                             deadlines=None if self.deadlines is None
                             else self.deadlines.to(device))


def _f32_on(x, device) -> torch.Tensor:
    if not torch.is_tensor(x):
        x = torch.from_numpy(np.asarray(x, np.float32))
    return x.to(device=device, dtype=DTYPE)


def stack_scenarios(instances, graphs=None) -> FleetScenario:
    """Stacks an iterable of (NetworkSpec, carbon_table [Tc, N+1], amax
    [M]) triples into one FleetScenario of float32 numpy arrays. Tables
    must share Tc and specs (M, N). `graphs`, when given, is a parallel
    iterable of LinkGraphs (sharing M, N, L) stacked onto the fleet's
    graph axis."""
    f32 = lambda x: np.asarray(x, np.float32)  # noqa: E731
    pes, pcs, Pes, Pcs, tabs, amaxs = [], [], [], [], [], []
    for spec, table, amax in instances:
        pe = f32(spec.pe)
        pes.append(pe)
        pcs.append(f32(spec.pc))
        Pes.append(f32(spec.Pe))
        Pcs.append(f32(spec.Pc))
        tabs.append(f32(table))
        amaxs.append(np.broadcast_to(f32(amax), pe.shape))
    fleet = FleetScenario(
        spec=FleetSpec(pe=np.stack(pes), pc=np.stack(pcs), Pe=np.stack(Pes), Pc=np.stack(Pcs)),
        carbon=np.stack(tabs),
        arrival_amax=np.stack(amaxs),
    )
    if graphs is not None:
        from repro_torch.network.graph import stack_graphs

        fleet = fleet._replace(graph=stack_graphs(graphs))
    return fleet


def sweep_forecast_errors(fleet: FleetScenario, bias, noise) -> FleetScenario:
    """Attaches per-lane ForecastErrorModel parameters ([F] arrays or
    scalars, broadcast), so one `simulate_fleet` call sweeps forecast
    quality across lanes."""
    F = fleet.F
    return fleet._replace(
        err_bias=np.broadcast_to(np.asarray(bias, np.float32), (F,)).copy(),
        err_noise=np.broadcast_to(np.asarray(noise, np.float32), (F,)).copy(),
    )


def simulate_fleet(
    policy: Callable,
    fleet: FleetScenario,
    T: int,
    key=0,
    record: str | int = "full",
    device=DEFAULT_DEVICE,
    forecaster=None,
    telemetry=None,
) -> SimResult:
    """Runs F independent instances for T slots at once (the JAX
    package's `vmap` of `simulate` over the stacked scenario,
    `repro/core/simulator.py:598-676`): every tensor of the loop carries
    the lane axis F, so one slot launches each kernel once for the whole
    fleet. Lane f draws from `split(key, F)[f]` (then `split(k_f, 3)` as
    `simulate` does), its carbon is its table's row t mod Tc, and its
    arrivals floor(uniform(fold_in(k_arrive_f, t), (M,)) * (amax_f + 1)).

    A fleet with a stacked graph runs every lane through the WAN transfer
    layer (the result is a NetSimResult); a fleet with a fault axis runs
    every lane through the fault layer, its fault stream
    fold_in(k_f, FAULT_STREAM_SALT) and all lanes' fault uniforms one
    draw a slot (a FaultSimResult, or NetFaultSimResult with a graph);
    a fleet with a deadline axis runs every lane through the deadline
    layer, with that lane's parameters (its result's `deadlines` a
    DeadlineLedger with a leading [F] axis); `forecaster` threads one
    forecaster through every lane (each lane's table and carbon key, and
    with `err_bias`/`err_noise` its own error parameters), as `simulate`
    does. Every result field has a leading [F] axis; `record` works as
    in `simulate` ("summary" keeps [F, 1, M] / [F, 1, M, N]).

    `telemetry` threads to every lane, whatever layers the fleet runs:
    the result's `telemetry` frame has a leading [F] axis on every field
    (select one with `telemetry.lane`, reduce the fleet with
    `telemetry.manifest`); one `tap_scan` launch covers every lane, and a
    StreamConfig pushes each chunk once a lane, tagged with its index."""
    dev = resolve_device(device)
    fleet = fleet.to(dev)
    spec = NetworkSpec(*fleet.spec)
    keys = R.split(rng.key_of(key, dev), fleet.F)
    carbon = TableCarbonSource(table=fleet.carbon)
    arrivals = FleetArrivals(amax=fleet.arrival_amax)
    err = None if fleet.err_bias is None else (fleet.err_bias, fleet.err_noise)
    if fleet.graph is not None:
        from repro_torch.network.sim import simulate_network

        return simulate_network(policy, spec, fleet.graph, carbon, arrivals, T, keys,
                                record=record, device=dev, forecaster=forecaster,
                                error_params=err, faults=fleet.faults, telemetry=telemetry,
                                deadlines=fleet.deadlines)
    if fleet.faults is not None:
        from repro_torch.faults.sim import simulate_faulted

        return simulate_faulted(policy, spec, fleet.faults, carbon, arrivals, T, keys,
                                record=record, device=dev, forecaster=forecaster,
                                error_params=err, telemetry=telemetry, deadlines=fleet.deadlines)
    loop = make_slot_loop(policy, spec, carbon, arrivals, keys, dev, fleet.deadlines, horizon=T)
    feed = None if forecaster is None else ForecastFeed.start(forecaster, loop, err)
    return _drive(loop, init_state(spec.M, spec.N, device=dev, F=fleet.F), T, record, feed,
                  telemetry)


def mean_rate_stability_metric(result: SimResult) -> torch.Tensor:
    """E[Q(T)]/T proxy for (10)-(11): total terminal backlog over horizon.
    A mean-rate-stable system drives this toward 0 as T grows."""
    T = result.emissions.shape[0]
    return result.final_backlog / T
