"""Scheduling policies (counterpart of `repro.core.policies`).

* CarbonIntensityPolicy -- the paper's Algorithm 1 (drift-plus-penalty
  greedy): one score pass, then the edge row and all N cloud rows in one
  stacked [N+1, M] greedy fill.
* LookaheadDPPPolicy -- Algorithm 1 on deferral-penalized intensities
  from an [H, N+1] forecast (`repro_torch.forecast`; the parent of the
  WAN policy).
* QueueLengthPolicy -- the paper's baseline: longest edge queue ->
  shortest cloud queue; clouds process their longest queues; carbon-blind.
* RandomPolicy -- feasible random actions (stress/property tests).
* ExactDPPPolicy -- the exact per-slot minimizer of (19): bounded
  knapsacks on an energy grid, one `knapsack_dp` launch a slot.
* literal_algorithm1 -- the numpy transcription of Algorithm 1, the
  oracle the vectorised policy must match.

All policies share the signature
    policy(state, spec, Ce, Cc, arrivals, key, *, fault_view=None,
           deadline_view=None) -> Action
with `key` a threefry key, an int seed or the simulator's
`rng.SlotKey` (see core.rng). The faulted simulator passes the slot's
`fault_view` (a `repro_torch.faults.FaultView`); these policies are
fault-blind and ignore it, as the JAX package's do
(`faults.StalenessGuardPolicy` is the one that reads it). The same goes
for `deadline_view` (a `repro_torch.deadlines.DeadlineView`, passed by
the deadline-threaded loops): urgency and deferral live in
`repro_torch.deadlines.policy`. They run on the device of `state`; on the
CPU the kernels are replaced by their plain versions. The state and
spec may carry a leading lane axis (Qe [F, M], Qc [F, M, N], the spec's
fields likewise, Ce [F], Cc [F, N]): the fleet's lanes, or V values
(`V` an [F] tensor) for `simulate_vsweep`.
Notes vs. the paper's pseudocode (`literal_edge_budget`,
`stop_at_first_unfit`) are those of the JAX module.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core import rng
from repro_torch.core.knapsack import bounded_knapsack_min_batch
from repro_torch.core.queueing import Action, NetworkSpec, NetworkState
from repro_torch.kernels import ops
from repro_torch.kernels.numerics import fma_f32
from repro_torch.telemetry.profile import phase


def greedy_fill(scores, unit_energy, max_items, budget, *,
                stop_at_first_unfit=True, literal_edge_budget=False,
                sort_key=None, chunk=64):
    """The one greedy knapsack fill (Algorithm 1, both halves).

    Per lane, items with a negative score are visited in increasing
    `sort_key` order (default score/unit_energy), ties by index; each
    takes min(cap, floor(P/e)) and decrements P. `stop_at_first_unfit`
    reproduces the pseudocode's `break`; `literal_edge_budget` the
    printed edge line (P -= fits*e, always stopping at the first unfit).

    Accepts [M] or [B, M] inputs with a scalar or [B] budget. `chunk` is
    the JAX engine's top_k width: it must be >= 1 and changes nothing,
    since both engines give the counts of the full sequential walk.
    """
    if int(chunk) < 1:
        raise ValueError(f"chunk={chunk!r} must be >= 1")
    single = scores.dim() == 1
    if single:
        scores, unit_energy, max_items = scores[None], unit_energy[None], max_items[None]
        if sort_key is not None:
            sort_key = sort_key[None]
    budget = torch.as_tensor(budget, dtype=torch.float32, device=scores.device).reshape(-1)
    budget = budget.expand(scores.shape[0])
    with phase("greedy_fill"):
        counts = ops.greedy_fill(
            scores, unit_energy, max_items, budget,
            stop_at_first_unfit=stop_at_first_unfit,
            literal_edge_budget=literal_edge_budget, sort_key=sort_key,
        )
    return counts[0] if single else counts


def _scalar(value: float, device) -> torch.Tensor:
    # torch.full writes on the device: no host-to-device copy, no sync
    return torch.full((), value, dtype=torch.float32, device=device)


def _dispatch_matrix(Qc, n1, d_counts):
    """d[..., m, n1[m]] = d_counts[m], zero elsewhere (JAX `.at[...].set`)."""
    return torch.zeros_like(Qc).scatter_(-1, n1.long()[..., None], d_counts[..., None])


def _stack_rows(first, rest):
    """Every lane's edge row `first` [..., M] over its N cloud rows
    `rest` [..., N, M], as the fill's [lanes * (N+1), M] rows."""
    rows = torch.cat([first[..., None, :], rest], dim=-2)
    return rows if rows.dim() == 2 else rows.reshape(-1, first.shape[-1])


def _stacked_fill(scores, pe, pc, Qe, Qc, Pe, Pc, **kw):
    """The edge row and the N cloud rows of every lane as one fill of
    [lanes * (N+1), M] rows, `scores` stacked by `_stack_rows`. Returns
    counts [..., N+1, M]."""
    lanes, M = tuple(Qc.shape[:-2]), Qc.shape[-2]
    counts = greedy_fill(
        scores,
        _stack_rows(pe, pc.transpose(-1, -2)),
        _stack_rows(Qe, Qc.transpose(-1, -2)),
        torch.cat([Pe[..., None], Pc], dim=-1).reshape(-1),
        **kw,
    )
    return counts.reshape(lanes + (-1, M))


def _policy_V(V, dev) -> torch.Tensor:
    """A policy's V as a float32 tensor on `dev` (one value, or one a lane)."""
    if torch.is_tensor(V):
        return V.to(device=dev, dtype=torch.float32)
    return _scalar(V, dev)


def _score_pass(state, pe, pc, Ce, Cc, V):
    """Score pass (c [..., M, N], n1 [..., M], b [..., M]) on pre-scaled
    intensities; a V of one value per lane scales its lane's
    intensities."""
    VCc = V[..., None] * Cc if V.dim() else V * Cc
    with phase("policy_score"):
        return ops.carbon_scores(state.Qc, pc, state.Qe, pe, VCc, V * Ce)


@dataclasses.dataclass(frozen=True)
class CarbonIntensityPolicy:
    """Paper Algorithm 1: carbon-intensity based drift-plus-penalty greedy.

    The score pass always goes through `kernels.ops.carbon_scores` (the
    CUDA kernel on the card, its plain version on the CPU), so the JAX
    policy's `score_backend` / `score_block_*` / `score_interpret` fields
    have no counterpart here. `fill_chunk` is accepted and, as in the
    JAX package, changes no action.
    """

    V: float = 0.05
    stop_at_first_unfit: bool = True
    literal_edge_budget: bool = False
    fill_chunk: int = 64

    def _fill_all(self, b, c, pe, pc, Qe, Qc, Pe, Pc):
        """Edge dispatch + N cloud fills as one stacked [N+1, M] fill per
        lane (all lanes' rows in one call). Returns (d_counts [..., M],
        w [..., M, N])."""
        M = Qc.shape[-2]
        if self.literal_edge_budget:
            # the literal pseudocode variant only exists for the edge
            # branch; clouds keep the corrected budget accounting
            d_counts = greedy_fill(
                b.reshape(-1, M), pe.reshape(-1, M), Qe.reshape(-1, M), Pe.reshape(-1),
                literal_edge_budget=True, chunk=self.fill_chunk,
            ).reshape(b.shape)
            w = greedy_fill(
                c.transpose(-1, -2).reshape(-1, M), pc.transpose(-1, -2).reshape(-1, M),
                Qc.transpose(-1, -2).reshape(-1, M), Pc.reshape(-1),
                stop_at_first_unfit=self.stop_at_first_unfit, chunk=self.fill_chunk,
            ).reshape(c.transpose(-1, -2).shape).transpose(-1, -2)
            return d_counts, w
        counts = _stacked_fill(_stack_rows(b, c.transpose(-1, -2)), pe, pc, Qe, Qc, Pe, Pc,
                               stop_at_first_unfit=self.stop_at_first_unfit,
                               chunk=self.fill_chunk)
        return counts[..., 0, :], counts[..., 1:, :].transpose(-1, -2)

    def _scores(self, state, pe, pc, Ce, Cc, V):
        return _score_pass(state, pe, pc, Ce, Cc, V)

    def _V(self, dev) -> torch.Tensor:
        return _policy_V(self.V, dev)

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc,
                 arrivals=None, key=None, *, fault_view=None, deadline_view=None) -> Action:
        del arrivals, key, fault_view, deadline_view
        dev = state.Qc.device
        pe, pc, Pe, Pc = spec.as_arrays(dev)
        c, n1, b = self._scores(state, pe, pc, Ce, Cc, self._V(dev))
        d_counts, w = self._fill_all(b, c, pe, pc, state.Qe, state.Qc, Pe, Pc)
        return Action(d=_dispatch_matrix(state.Qc, n1, d_counts), w=w)


def discount_powers(discount: float, H: int, device) -> torch.Tensor:
    """discount**h for h = 0..H-1, float32 `pow` on `device` (on the CPU
    the values of XLA:CPU's `discount ** arange(H)`; chip_smoke.py holds
    the card's to them)."""
    return _scalar(discount, device) ** torch.arange(H, dtype=torch.float32, device=device)


@dataclasses.dataclass(frozen=True)
class LookaheadDPPPolicy(CarbonIntensityPolicy):
    """Receding-horizon drift-plus-penalty: plans against an [H, N+1]
    intensity forecast ([F, H, N+1] on a lane axis) and acts on the first
    slot with deferral-penalized intensities

        C_eff = C_now + defer_weight * max(0, C_now - Cmin)
        Cmin  = min_h forecast[h] / discount**h         (h = 0..H-1)

    Row 0 of the forecast is overwritten with the observed (Ce, Cc), so
    H=1 gives Cmin = C_now and acts bitwise as CarbonIntensityPolicy;
    with no forecast (forecast=None) the policy is the myopic parent. The
    forecasters of `repro_torch.forecast` feed it through
    `simulate(..., forecaster=)` and `simulate_fleet(..., forecaster=)`.
    """

    H: int = 8
    discount: float = 0.98
    defer_weight: float = 2.0

    def effective_intensities(self, Ce, Cc, forecast):
        if forecast is None or self.H <= 0:
            return Ce, Cc
        if forecast.shape[-2] < self.H:
            raise ValueError(
                f"forecast covers {forecast.shape[-2]} slots but the policy plans over "
                f"H={self.H}: configure the forecaster with H >= {self.H} (silently "
                "planning short would mislabel every lookahead result)"
            )
        dev = Cc.device
        f = forecast[..., : self.H, :].to(device=dev, dtype=torch.float32, copy=True)
        f[..., 0, :] = torch.cat([Ce[..., None], Cc], dim=-1)
        g = discount_powers(self.discount, f.shape[-2], dev)
        cmin = torch.amin(f / g[:, None], dim=-2)  # [..., N+1]
        w = _scalar(self.defer_weight, dev)
        # single-rounded, as XLA:CPU contracts `C + w * max(...)` under jit
        Ce_eff = fma_f32(w, torch.clamp_min(Ce - cmin[..., 0], 0.0), Ce)
        Cc_eff = fma_f32(w, torch.clamp_min(Cc - cmin[..., 1:], 0.0), Cc)
        return Ce_eff, Cc_eff

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc,
                 arrivals=None, key=None, forecast=None, *, fault_view=None,
                 deadline_view=None) -> Action:
        del fault_view, deadline_view
        Ce_eff, Cc_eff = self.effective_intensities(Ce, Cc, forecast)
        return super().__call__(state, spec, Ce_eff, Cc_eff, arrivals, key)


@dataclasses.dataclass(frozen=True)
class QueueLengthPolicy:
    """Paper §V baseline: queue-length based, carbon-blind.

    The same stacked greedy fill as Algorithm 1, ordered by
    -queue-length (sort_key) and never stopping at an unfit type. n1 is a
    plain `torch.argmin` (first index on ties), as in the JAX policy."""

    fill_chunk: int = 64

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc,
                 arrivals=None, key=None, *, fault_view=None, deadline_view=None) -> Action:
        del Ce, Cc, arrivals, key, fault_view, deadline_view
        pe, pc, Pe, Pc = spec.as_arrays(state.Qc.device)
        n1 = torch.argmin(state.Qc, dim=-1)
        scores = _stack_rows(torch.where(state.Qe > 0, -state.Qe, 1.0),
                             torch.where(state.Qc > 0, -state.Qc, 1.0).transpose(-1, -2))
        counts = _stacked_fill(scores, pe, pc, state.Qe, state.Qc, Pe, Pc,
                               stop_at_first_unfit=False, sort_key=scores,
                               chunk=self.fill_chunk)
        return Action(d=_dispatch_matrix(state.Qc, n1, counts[..., 0, :]),
                      w=counts[..., 1:, :].transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class RandomPolicy:
    """Feasible uniformly-random actions (tests / stress). Random
    fractions of per-type feasible maxima, with the shared budget divided
    across types: `kd, kw = split(key)`, `uniform(kd, (M, N))` and
    `uniform(kw, (M, N))`, as the JAX policy draws them, in one draw
    (the slot folded in when `key` is the simulator's SlotKey)."""

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc,
                 arrivals=None, key=0, *, fault_view=None, deadline_view=None) -> Action:
        del Ce, Cc, arrivals, fault_view, deadline_view
        dev = state.Qc.device
        pe, pc, Pe, Pc = spec.as_arrays(dev)
        M, N = spec.M, spec.N
        base, t = rng.draw_key(key, dev)
        f = ops.threefry_draw(base, t, 2 * M * N, finish="uniform", seg=M * N)
        fd = f[..., :M * N].reshape(state.Qc.shape)
        fw = f[..., M * N:].reshape(state.Qc.shape)
        cap_d = torch.minimum(state.Qe[..., None] / N,
                              (Pe[..., None, None] / (M * N)) / pe[..., None])
        d = torch.floor(fd * torch.clamp_min(cap_d, 0.0))
        cap_w = torch.minimum(state.Qc, (Pc[..., None, :] / M) / pc)
        w = torch.floor(fw * torch.clamp_min(cap_w, 0.0))
        return Action(d=d, w=w)


@dataclasses.dataclass(frozen=True)
class ExactDPPPolicy:
    """Beyond-paper: exact per-slot minimizer of (19) via bounded-
    knapsack DP over a discretized energy grid (`core.knapsack`):
    O(M * grid) a knapsack, for small instances, to measure the greedy
    gap.

    One score pass (`kernels.ops.carbon_scores`: c = fma(V*Cc, pc, -Qc),
    b = fma(V*Ce, pe, min Qc) - Qe, as the JAX policy rounds under jit),
    then the edge knapsack at n1 and the N cloud knapsacks of every lane
    as one `knapsack_dp` launch. V may be a tensor (one value, or one a
    lane: `simulate_vsweep`, `faults.StalenessGuardPolicy`)."""

    V: float = 0.05
    grid: int = 512  # energy discretization cells per knapsack

    def __call__(self, state: NetworkState, spec: NetworkSpec, Ce, Cc,
                 arrivals=None, key=None, *, fault_view=None, deadline_view=None) -> Action:
        del arrivals, key, fault_view, deadline_view
        dev = state.Qc.device
        pe, pc, Pe, Pc = spec.as_arrays(dev)
        c, n1, b = _score_pass(state, pe, pc, Ce, Cc, _policy_V(self.V, dev))
        lanes, M = tuple(state.Qc.shape[:-2]), state.Qc.shape[-2]
        counts = bounded_knapsack_min_batch(
            _stack_rows(b, c.transpose(-1, -2)),
            _stack_rows(pe, pc.transpose(-1, -2)),
            _stack_rows(state.Qe, state.Qc.transpose(-1, -2)),
            torch.cat([Pe[..., None], Pc], dim=-1).reshape(-1),
            self.grid,
        ).reshape(lanes + (-1, M))
        return Action(d=_dispatch_matrix(state.Qc, n1, counts[..., 0, :]),
                      w=counts[..., 1:, :].transpose(-1, -2))


def _np64(x) -> np.ndarray:
    if torch.is_tensor(x):
        x = x.detach().cpu().numpy()
    return np.asarray(x, np.float64)


def literal_algorithm1(state, spec, Ce, Cc, V,
                       stop_at_first_unfit=True, literal_edge_budget=False):
    """Pure-Python transcription of Algorithm 1 (numpy float64,
    data-dependent control flow), copied from the JAX package. Oracle
    for tests: the vectorised policy must match. Returns an Action of
    float32 CPU tensors."""
    pe = _np64(spec.pe)
    pc = _np64(spec.pc)
    Qe = _np64(state.Qe).copy()
    Qc = _np64(state.Qc).copy()
    Ce = float(Ce)
    Cc = _np64(Cc)
    M, N = pc.shape
    d = np.zeros((M, N))
    w = np.zeros((M, N))

    n1 = np.argmin(Qc, axis=1)
    b = V * Ce * pe + Qc[np.arange(M), n1] - Qe
    order = np.argsort(b / pe, kind="stable")
    P = float(spec.Pe)
    for m in order:
        fits = np.floor(P / pe[m])
        if fits <= 0:
            if stop_at_first_unfit or literal_edge_budget:
                break
            continue
        if b[m] < 0:
            take = min(Qe[m], fits)
            d[m, n1[m]] = take
            P -= (fits if literal_edge_budget else take) * pe[m]

    Pc_all = _np64(spec.Pc)
    for n in range(N):
        c = V * Cc[n] * pc[:, n] - Qc[:, n]
        order = np.argsort(c / pc[:, n], kind="stable")
        P = float(Pc_all[n])
        for m in order:
            fits = np.floor(P / pc[m, n])
            if fits <= 0:
                if stop_at_first_unfit:
                    break
                continue
            if c[m] < 0:
                take = min(Qc[m, n], fits)
                w[m, n] = take
                P -= take * pc[m, n]
    return Action(d=torch.as_tensor(d, dtype=torch.float32),
                  w=torch.as_tensor(w, dtype=torch.float32))
