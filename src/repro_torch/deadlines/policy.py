"""Deadline-aware policies (counterpart of `repro.deadlines.policy`),
driven by the `DeadlineView` the deadline-threaded loops pass as
`deadline_view=`:

* SlackThresholdPolicy -- escalates the effective V toward pure
  backpressure as slack -> 0: the urgency share of the carbon term is
  subtracted from the scores (the score at V_eff = (1 - u) * V), so the
  score kernel and the one stacked greedy fill run as they are.
* EDDPolicy -- earliest-due-date: carbon-blind dispatch ordered by slack,
  longest-queue cloud processing; the classical deadline baseline.
* WaitAwhilePolicy -- suspend/resume deferral: act only when the current
  slot ranks among the J cheapest slots of the forecast inside each
  task's admissible window min(W, slack); otherwise suspend by lifting
  scores to >= 0, which the fill never takes. Due work always resumes.

With `deadline_view=None` (or no forecast, for WaitAwhile) each policy
is its parent, bitwise. The state and view may carry a leading lane axis
(a fleet), as every policy of the port.

Rounding follows XLA:CPU inside the simulator's scan: SlackThreshold's
urgency is clip(fma(-slack, f32(1 / slack_scale), 1), 0, 1) (the
division by the constant scale becomes a multiply by its reciprocal,
contracted with the subtraction, as in the guard's decay), and its score
updates are fma(-(u * (V * C)), p, score), one rounding each
(`numerics.fma_f32`).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.policies import (
    LookaheadDPPPolicy,
    _dispatch_matrix,
    _scalar,
    _stack_rows,
    _stacked_fill,
)
from repro_torch.core.queueing import Action
from repro_torch.kernels.numerics import fma_f32

# Slack values are capped here before they enter sort keys, so +inf
# (empty queue, no deadline) stays orderable and arithmetic-safe.
_SLACK_CAP = 1e6


@dataclasses.dataclass(frozen=True)
class SlackThresholdPolicy(LookaheadDPPPolicy):
    """Urgency-escalated drift-plus-penalty.

    Per-type urgency u = clip(1 - slack / slack_scale, 0, 1) shrinks the
    carbon term of the DPP score to its (1 - u) share; u = 0 (slack >=
    slack_scale, or +inf) leaves the parent's scores bit for bit (the
    subtraction is an exact -0.0). Types at their last service
    opportunity (`due`) also get `due_push` subtracted from their
    dispatch score, which puts them at the head of the fill.
    """

    slack_scale: float = 4.0
    due_push: float = 1e6

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, forecast=None, *,
                 fault_view=None, deadline_view=None) -> Action:
        del fault_view
        if deadline_view is None:
            return super().__call__(state, spec, Ce, Cc, arrivals, key, forecast)
        dev = state.Qc.device
        pe, pc, Pe, Pc = spec.as_arrays(dev)
        V = self._V(dev)
        Ce_eff, Cc_eff = self.effective_intensities(Ce, Cc, forecast)
        c, n1, b = self._scores(state, pe, pc, Ce_eff, Cc_eff, V)
        inv = float(np.float32(1.0) / np.float32(self.slack_scale))
        u = torch.clamp(fma_f32(-deadline_view.slack, inv, 1.0), 0.0, 1.0)
        VCe = V * Ce_eff                                       # [...]
        VCc = (V[..., None] if V.dim() else V) * Cc_eff        # [..., N]
        b = fma_f32(-(u * VCe[..., None]), pe, b)
        c = fma_f32(-(u[..., :, None] * VCc[..., None, :]), pc, c)
        b = b - deadline_view.due * _scalar(self.due_push, dev)
        d_counts, w = self._fill_all(b, c, pe, pc, state.Qe, state.Qc, Pe, Pc)
        return Action(d=_dispatch_matrix(state.Qc, n1, d_counts), w=w)


@dataclasses.dataclass(frozen=True)
class EDDPolicy:
    """Earliest-due-date baseline: carbon-blind, deadline-greedy.

    Edge: every type with waiting tasks dispatches in ascending-slack
    order (to its shortest cloud queue), as many as energy allows.
    Clouds: longest queues first, as in QueueLengthPolicy. Without a
    view all occupied types tie (slack +inf) and the fill takes them in
    index order.
    """

    fill_chunk: int = 64

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, *, fault_view=None,
                 deadline_view=None) -> Action:
        del Ce, Cc, arrivals, key, fault_view
        pe, pc, Pe, Pc = spec.as_arrays(state.Qc.device)
        n1 = torch.argmin(state.Qc, dim=-1)
        if deadline_view is None:
            slack = torch.full_like(state.Qe, float("inf"))
        else:
            slack = deadline_view.slack
        # occupied types get a strictly negative key ordered by slack
        # (the fill takes only negative keys)
        edge = torch.where(state.Qe > 0, torch.clamp_max(slack, _SLACK_CAP) - (_SLACK_CAP + 1.0),
                           1.0)
        scores = _stack_rows(edge, torch.where(state.Qc > 0, -state.Qc, 1.0).transpose(-1, -2))
        counts = _stacked_fill(scores, pe, pc, state.Qe, state.Qc, Pe, Pc,
                               stop_at_first_unfit=False, sort_key=scores,
                               chunk=self.fill_chunk)
        return Action(d=_dispatch_matrix(state.Qc, n1, counts[..., 0, :]),
                      w=counts[..., 1:, :].transpose(-1, -2))


@dataclasses.dataclass(frozen=True)
class WaitAwhilePolicy(LookaheadDPPPolicy):
    """Suspend/resume deferral: act in the J cheapest admissible slots.

    Per type, the admissible window is min(window, slack) slots of the
    [H, N+1] forecast. The edge dispatch of type m suspends unless the
    current edge intensity ranks among the J cheapest admissible slots
    (strictly cheaper count < J); cloud n's processing of type m by the
    same test on cloud n's column. Suspension lifts a score to
    max(score, 0), which the fill never takes and which cannot trip its
    early stop. Due types resume and get the `due_push` boost. Row 0 of
    the ranked forecast is the observed (Ce, Cc), not the effective
    intensities.
    """

    J: int = 2
    due_push: float = 1e6

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, forecast=None, *,
                 fault_view=None, deadline_view=None) -> Action:
        del fault_view
        if deadline_view is None or forecast is None or self.H <= 0:
            return super().__call__(state, spec, Ce, Cc, arrivals, key, forecast)
        dev = state.Qc.device
        pe, pc, Pe, Pc = spec.as_arrays(dev)
        V = self._V(dev)
        Ce_eff, Cc_eff = self.effective_intensities(Ce, Cc, forecast)
        c, n1, b = self._scores(state, pe, pc, Ce_eff, Cc_eff, V)

        f = forecast[..., : self.H, :].to(device=dev, dtype=torch.float32, copy=True)
        f[..., 0, :] = torch.cat([Ce[..., None], Cc], dim=-1)      # [..., H, N+1]
        wait = torch.minimum(deadline_view.window, deadline_view.slack)
        h = torch.arange(f.shape[-2], dtype=torch.float32, device=dev)
        adm = h <= wait[..., None]                                  # [..., M, H]
        due = deadline_view.due > 0.0

        # edge gate: the rank of now among the admissible edge slots
        fE = f[..., :, 0]                                           # [..., H]
        rank_e = torch.sum((fE < fE[..., :1])[..., None, :] & adm, dim=-1)
        act_edge = (rank_e < self.J) | due
        b = torch.where(act_edge, b, torch.clamp_min(b, 0.0))
        b = b - deadline_view.due * _scalar(self.due_push, dev)

        # cloud gate: the rank per (type, cloud) on that cloud's column
        fC = f[..., :, 1:]                                          # [..., H, N]
        cheaper = fC < fC[..., :1, :]
        rank_c = torch.sum(cheaper[..., None, :, :] & adm[..., :, :, None], dim=-2)  # [..., M, N]
        act_cloud = (rank_c < self.J) | due[..., None]
        c = torch.where(act_cloud, c, torch.clamp_min(c, 0.0))

        d_counts, w = self._fill_all(b, c, pe, pc, state.Qe, state.Qc, Pe, Pc)
        return Action(d=_dispatch_matrix(state.Qc, n1, d_counts), w=w)


__all__ = ["EDDPolicy", "SlackThresholdPolicy", "WaitAwhilePolicy"]
