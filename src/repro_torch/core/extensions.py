"""Beyond-paper scheduling extensions (counterpart of
`repro.core.extensions`).

* ThresholdPolicy  -- the naive carbon heuristic (process only when
  CI < threshold, ignore queues): what operators do without the
  drift-plus-penalty machinery. Ablation baseline. QueueLengthPolicy's
  action (its stacked greedy fill) with `w` gated by Cc < threshold;
  takes lanes as QueueLengthPolicy does.
* oracle_emissions_for_work / oracle_emissions_horizon -- clairvoyant
  lower bounds (numpy, copied from the JAX package).
* AdaptiveVController -- closed-loop V tuning: Theorem 1 trades
  emissions (B/V) against queue growth (O(V)); this controller walks V
  multiplicatively to hold total backlog at a target, removing the
  hand-tuning the paper leaves open. Its `policy()` is the port's
  CarbonIntensityPolicy, so it runs the score and fill kernels.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.policies import CarbonIntensityPolicy, QueueLengthPolicy, _np64
from repro_torch.core.queueing import Action, NetworkSpec


@dataclasses.dataclass(frozen=True)
class ThresholdPolicy:
    """Process greedily whenever the cloud's CI is below `threshold`;
    dispatch like the queue-length policy. Carbon-aware but queue-blind:
    no stability guarantee (see tests for the failure mode)."""

    threshold: float = 200.0

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, *,
                 fault_view=None, deadline_view=None):
        del fault_view, deadline_view
        base = QueueLengthPolicy()(state, spec, Ce, Cc, arrivals, key)
        # the threshold compares as a float32 value, as JAX's weak float does
        cut = torch.full((), float(self.threshold), dtype=torch.float32, device=Cc.device)
        gate = (Cc < cut).to(torch.float32)[..., None, :]
        return Action(d=base.d, w=base.w * gate)


def oracle_emissions_for_work(
    spec: NetworkSpec,
    carbon_table: np.ndarray,  # [T, N+1] (edge, clouds)
    edge_energy: float,        # total edge kWh the policy actually spent
    cloud_energy: np.ndarray | float,  # total cloud kWh spent (sum or [N])
) -> float:
    """Clairvoyant lower bound on the emissions of doing the SAME amount
    of work: spend `edge_energy` in the globally cheapest edge slots
    (budget Pe each) and `cloud_energy` in the cheapest (slot, cloud)
    cells (budget Pc[n] each). Relaxations vs any feasible schedule --
    fractional tasks, no arrival-time constraints, free cloud choice --
    only lower the cost, so lb <= any policy's emissions for equal work.
    Tensors are read on the host.
    """
    carbon_table = _np64(carbon_table)
    T = carbon_table.shape[0]
    Pe = float(_np64(spec.Pe))
    Pc = _np64(spec.Pc)

    total = 0.0
    # edge: cheapest slots first
    edge_ci = np.sort(carbon_table[:, 0].astype(np.float64))
    remaining = float(_np64(edge_energy))
    for ci in edge_ci:
        take = min(Pe, remaining)
        total += ci * take
        remaining -= take
        if remaining <= 0:
            break
    total += max(remaining, 0.0) * float(edge_ci[-1])

    # clouds: cheapest (slot, cloud) cells first
    cloud_ci = carbon_table[:, 1:].astype(np.float64)  # [T, N]
    cells = [(cloud_ci[s, n], Pc[n]) for s in range(T)
             for n in range(cloud_ci.shape[1])]
    cells.sort()
    remaining = float(np.sum(_np64(cloud_energy)))
    for ci, cap in cells:
        take = min(cap, remaining)
        total += ci * take
        remaining -= take
        if remaining <= 0:
            break
    total += max(remaining, 0.0) * float(cells[-1][0])
    return float(total)


def oracle_emissions_horizon(
    carbon_table: np.ndarray,          # [T, N+1] (edge, clouds)
    edge_energy: np.ndarray,           # [T] edge kWh actually spent per slot
    cloud_energy: np.ndarray,          # [T, N] cloud kWh spent per slot
    horizon: int | None = None,
) -> float:
    """Clairvoyant-horizon lower bound on the emissions of the SAME
    per-slot energy profile (companion to `oracle_emissions_for_work`,
    which bounds against *totals* under budget caps).

    Every kWh the policy spent in slot s is re-priced at the cheapest
    intensity available within its deferral window [s, s+horizon)
    (same region; rows wrap modulo T like the playback tables), with
    budget contention ignored. Dropping the capacity constraint only
    cheapens the relaxation, so the result lower-bounds any feasible
    schedule that defers each unit of work at most `horizon-1` slots --
    exactly the move set of an H-slot receding-horizon policy. With
    horizon=None (or >= T) the window spans the whole trace: the
    un-budgeted full-trace bound. Tensors are read on the host.
    """
    ci = _np64(carbon_table)
    T = ci.shape[0]
    H = T if horizon is None else int(min(max(horizon, 1), T))
    edge_e = _np64(edge_energy).reshape(T)
    cloud_e = _np64(cloud_energy).reshape(T, -1)
    if cloud_e.shape[1] != ci.shape[1] - 1:
        raise ValueError(
            f"cloud_energy has {cloud_e.shape[1]} columns, carbon_table "
            f"provides {ci.shape[1] - 1} cloud regions"
        )
    # windowed min over [s, s+H) per column, wrapping like the tables
    wmin = ci.copy()
    for h in range(1, H):
        np.minimum(wmin, np.roll(ci, -h, axis=0), out=wmin)
    total = float(np.sum(edge_e * wmin[:, 0]))
    total += float(np.sum(cloud_e * wmin[:, 1:]))
    return total


@dataclasses.dataclass
class AdaptiveVController:
    """Multiplicative V feedback: hold total backlog near `target_backlog`.

    backlog > target * (1+band)  ->  V /= step   (drain queues)
    backlog < target * (1-band)  ->  V *= step   (chase carbon harder)
    Clamped to [v_min, v_max]. One update per slot (a host float: the
    caller reads the backlog); the policy object is rebuilt cheaply
    (pure dataclass)."""

    target_backlog: float
    V: float = 0.05
    step: float = 1.15
    band: float = 0.25
    v_min: float = 1e-4
    v_max: float = 10.0

    def update(self, backlog: float) -> float:
        if backlog > self.target_backlog * (1 + self.band):
            self.V = max(self.V / self.step, self.v_min)
        elif backlog < self.target_backlog * (1 - self.band):
            self.V = min(self.V * self.step, self.v_max)
        return self.V

    def policy(self) -> CarbonIntensityPolicy:
        return CarbonIntensityPolicy(V=self.V)
