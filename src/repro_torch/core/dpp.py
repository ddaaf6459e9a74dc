"""Drift-plus-penalty machinery (paper §IV.A, Lemma 1), in PyTorch.

Counterpart of `repro.core.dpp`. Per-slot surrogate coefficients:

  b[m,n] = V*Ce*pe[m]     + Qc[m,n] - Qe[m]   (dispatch coefficient)
  c[m,n] = V*Cc[n]*pc[m,n] - Qc[m,n]          (processing coefficient)

Minimizing (19) == min sum b*d + sum c*w subject to the energy knapsacks
(12)-(14). These helpers are unfused (a multiply, then an add), as the
JAX package computes them outside `jit`; the policies' score pass goes
through `kernels.ops.carbon_scores`, which is single-rounded like the
reference under `jit`.
"""
from __future__ import annotations

import torch

from repro_torch.core.queueing import Action, NetworkSpec, NetworkState, emissions, lyapunov, step


def dispatch_scores(state: NetworkState, spec_pe, Ce, V) -> torch.Tensor:
    """b[m,n] for all (m,n). spec_pe: [M]; Ce scalar."""
    return V * Ce * spec_pe[:, None] + state.Qc - state.Qe[:, None]


def processing_scores(state: NetworkState, spec_pc, Cc, V) -> torch.Tensor:
    """c[m,n] for all (m,n). spec_pc: [M,N]; Cc: [N]."""
    return V * Cc[None, :] * spec_pc - state.Qc


def surrogate_value(state, spec: NetworkSpec, action: Action, Ce, Cc, V) -> torch.Tensor:
    """Objective (19) evaluated at an action."""
    pe, pc, _, _ = spec.as_arrays(state.Qc.device)
    b = dispatch_scores(state, pe, Ce, V)
    c = processing_scores(state, pc, Cc, V)
    return torch.sum(b * action.d) + torch.sum(c * action.w)


def drift_plus_penalty(state, spec, action, arrivals, Ce, Cc, V) -> torch.Tensor:
    """Exact Delta(t) + V*C(t) for one realized transition (LHS of (17))."""
    nxt = step(state, action, arrivals)
    return (lyapunov(nxt) - lyapunov(state)) + V * emissions(spec, action, Ce, Cc)


def lemma1_rhs(state, spec, action, arrivals, Ce, Cc, V, B) -> torch.Tensor:
    """RHS of the Lemma-1 bound (17)."""
    pe, pc, _, _ = spec.as_arrays(state.Qc.device)
    b = dispatch_scores(state, pe, Ce, V)
    c = processing_scores(state, pc, Cc, V)
    return (
        B
        + torch.sum(state.Qe * arrivals)
        + torch.sum(b * action.d)
        + torch.sum(c * action.w)
    )
