"""Queueing-network simulator (paper §V numerical analysis), in PyTorch.

Counterpart of `repro.core.simulator.simulate`: every slot observes the
carbon intensities and arrivals, acts with the policy (score pass +
greedy fill), accounts emissions (eq. 5) and steps the queues (eqs.
7-8). The JAX package runs the slots in one `lax.scan`; here a Python
loop drives them with every tensor on the device and no host sync inside
the loop (no `.item()`, no copy to or from the host, no tensor used as a
Python bool), so the device never waits for the host to read a result.

`graph=` routes the run through the WAN transfer layer
(`repro_torch.network`). The forecaster / faults / telemetry / deadlines
arguments of the JAX `simulate` belong to later slices of the port.
"""
from __future__ import annotations

import dataclasses
from typing import Callable, NamedTuple

import torch

from repro_torch.core import rng
from repro_torch.core.carbon import DeviceCache
from repro_torch.core.queueing import DTYPE, NetworkSpec, NetworkState, emissions, init_state, step
from repro_torch.device import DEFAULT_DEVICE, resolve_device


@dataclasses.dataclass(frozen=True)
class UniformArrivals:
    """a_m(t) ~ U{0..amax} i.i.d. (paper §V uses amax=400), drawn on the
    device from a generator seeded with fold_in(seed, t)."""

    M: int
    amax: int = 400

    def __call__(self, t: int, seed: int, device) -> torch.Tensor:
        g = rng.generator(rng.fold_in(seed, t), device)
        return torch.randint(0, self.amax + 1, (self.M,), generator=g, device=device).to(DTYPE)

    @property
    def a_max(self) -> float:
        return float(self.amax)


@dataclasses.dataclass(frozen=True)
class PoissonArrivals(DeviceCache):
    """a_m(t) ~ Poisson(rate_m), clipped at `clip` to keep a_m bounded
    (Lemma 1 requires bounded arrivals)."""

    rates: tuple
    clip: int = 2000

    def _tensors(self, device):
        return self._cached(device, lambda dev: torch.tensor(self.rates, dtype=DTYPE, device=dev))

    def __call__(self, t: int, seed: int, device) -> torch.Tensor:
        g = rng.generator(rng.fold_in(seed, t), device)
        return torch.clamp_max(torch.poisson(self._tensors(device), generator=g), float(self.clip))

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


class SlotLoop(NamedTuple):
    """What one slot of the paper's loop needs: the policy, the spec on
    the device, the sources, and the three seeds `simulate` splits from
    its seed (carbon, arrivals, policy), as the JAX loop splits its key."""

    policy: Callable
    spec: NetworkSpec
    carbon_source: Callable
    arrival_source: Callable
    seeds: tuple
    device: torch.device


def make_slot_loop(policy, spec, carbon_source, arrival_source, seed, device) -> SlotLoop:
    device = resolve_device(device)
    return SlotLoop(
        policy=policy,
        spec=spec.to(device),
        carbon_source=_bind(carbon_source, device),
        arrival_source=_bind(arrival_source, device),
        seeds=tuple(rng.split(seed, 3)),
        device=device,
    )


def slot_step(loop: SlotLoop, state: NetworkState, t: int):
    """One slot: observe, act, account, step. The body both `simulate`
    and `serve.loop.make_serve_step` run, so their trajectories are
    bitwise equal. Returns (next state, action, arrivals, C(t))."""
    k_carbon, k_arrive, k_policy = loop.seeds
    Ce, Cc = loop.carbon_source(t, k_carbon, loop.device)
    a = loop.arrival_source(t, k_arrive, loop.device)
    act = loop.policy(state, loop.spec, Ce, Cc, a, rng.fold_in(k_policy, t))
    C_t = emissions(loop.spec, act, Ce, Cc)
    return step(state, act, a), act, a, C_t


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
    seed: int = 0,
    state0: NetworkState | None = None,
    record: str | int = "full",
    device=DEFAULT_DEVICE,
    graph=None,
) -> SimResult:
    """Runs the network for T slots under `policy` on `device`.

    `record` controls how much trajectory the result carries: "full"
    stacks the post-step queues every slot; "summary" keeps only the
    final state (a length-1 leading axis); an int stride k keeps the
    state at the end of every k-th slot ([T//k, ...]). The per-slot
    scalar series are computed the same way in every mode, so they agree
    bitwise across modes.

    Sources are called as `source(t, seed, device)`; sources with a
    `to(device)` method are staged on the device first.

    When `graph` (a `repro_torch.network.LinkGraph`) is given, the run
    goes through the WAN transfer layer (`network.simulate_network`):
    the policy is called with `graph=` / `Qt=` keywords, returns a
    NetAction, and the result is a NetSimResult.
    """
    if graph is not None:
        from repro_torch.network.sim import simulate_network

        return simulate_network(policy, spec, graph, carbon_source, arrival_source, T, seed,
                                state0=state0, record=record, device=device)
    stride = record_stride(record, T)
    R = T // stride
    loop = make_slot_loop(policy, spec, carbon_source, arrival_source, seed, device)
    dev = loop.device
    M, N = spec.M, spec.N
    pe, pc, _, _ = loop.spec.as_arrays(dev)
    state = init_state(M, N, device=dev) if state0 is None else NetworkState(
        Qe=state0.Qe.to(dev, DTYPE), Qc=state0.Qc.to(dev, DTYPE)
    )
    zeros = lambda *shape: torch.zeros(shape, dtype=DTYPE, device=dev)  # noqa: E731
    C, disp, proc, ee = zeros(T), zeros(T), zeros(T), zeros(T)
    ec = zeros(T, N)
    Qe_rec, Qc_rec = zeros(R, M), zeros(R, M, N)
    for t in range(T):
        state, act, _, C_t = slot_step(loop, state, t)
        C[t] = C_t
        disp[t] = torch.sum(act.d)
        proc[t] = torch.sum(act.w)
        ee[t] = torch.sum(act.d * pe[:, None])
        ec[t] = torch.sum(act.w * pc, dim=0)
        if (t + 1) % stride == 0:
            r = (t + 1) // stride - 1
            Qe_rec[r] = state.Qe
            Qc_rec[r] = state.Qc
    return SimResult(
        emissions=C,
        cum_emissions=torch.cumsum(C, dim=0),
        Qe=Qe_rec,
        Qc=Qc_rec,
        dispatched=disp,
        processed=proc,
        energy_edge=ee,
        energy_cloud=ec,
    )


def mean_rate_stability_metric(result: SimResult) -> torch.Tensor:
    """E[Q(T)]/T proxy for (10)-(11): total terminal backlog over horizon.
    A mean-rate-stable system drives this toward 0 as T grows."""
    T = result.emissions.shape[0]
    return result.final_backlog / T
