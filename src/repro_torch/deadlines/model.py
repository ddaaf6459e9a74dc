"""Deadline / SLO state for the queueing network (counterpart of
`repro.deadlines.model`).

Every task type gets a deadline (bounded tolerable waiting at the edge),
and the slot loops get an overload-robustness layer, as loop-carried
tensors that may carry leading lane axes (a fleet sweeps deadline
scenarios across its lanes in the same launches):

  * age rings -- the edge queue Qe[m] is shadowed by an age-bucketed
    decomposition `Qd [M, D]`: ring j holds the type-m tasks that have
    had j prior service opportunities. Dispatches drain oldest-first;
    unserved tasks age one ring a slot. The ring count D is the shape of
    the `rings` field.
  * expiry -- a task still queued after `deadline[m]` extra slots beyond
    its first service opportunity expires into the slot's `missed`
    count, so float32 conservation stays exact in integral counts:
      cum(arrived) = Qe + Qc [+ Qt] [+ retry]
                     + cum(processed) - cum(failed)
                     + cum(missed) + cum(shed)
  * admission control -- with `shed_on`, arrivals that projected service
    capacity cannot clear inside their deadline are shed at the door.
    Capacity is an EWMA `mu[m]` of observed dispatch rates, updated only
    on slots with queued work.

The infinite-deadline anchor: with `no_deadlines(...)` every deadline is
+inf and shedding is off, so the expiry mask is all false (`expired` is
an exact +0.0) and the admission select returns the arrivals untouched:
the slot loops' queue update `max(Qe - d, 0) + admitted - expired` is
bitwise `+ a`.

Rounding follows XLA:CPU inside the simulator's scan: the EWMA is one
FMA, fma(1 - alpha, mu, alpha * d), and the admission cap's product and
difference are one, fma(headroom * mu, deadline + 1, -queued)
(`numerics.fma_f32`). Every other step moves integral counts below
2**24, where any order is exact. Construction validates with numpy;
the slot step never syncs with the host.
"""
from __future__ import annotations

from typing import NamedTuple

import numpy as np
import torch

from repro_torch.device import DEFAULT_DEVICE, resolve_device
from repro_torch.kernels.numerics import fma_f32
from repro_torch.telemetry.profile import phase

DEFAULT_RINGS = 32

_F32 = torch.float32


class DeadlineParams(NamedTuple):
    """Deadline-layer parameters, float32 tensors ([F, ...] on a fleet's
    lane axis). `deadline[m]` counts extra slots beyond the first service
    opportunity (deadline d allows d + 1 opportunities; +inf disables
    expiry); finite deadlines lie in [0, D - 1]."""

    deadline: torch.Tensor  # [M] max extra waiting slots (+inf = none)
    window: torch.Tensor    # [M] WaitAwhile deferral window W (+inf = none)
    shed_on: torch.Tensor   # []  1.0 = admission control active
    headroom: torch.Tensor  # []  admission capacity factor (< 1 sheds early)
    alpha: torch.Tensor     # []  EWMA rate of the dispatch-rate estimate
    rings: torch.Tensor     # [D] zeros; its shape carries the ring count D

    @property
    def D(self) -> int:
        return self.rings.shape[-1]

    def to(self, device) -> "DeadlineParams":
        """Every leaf as a float32 tensor on `device` (numpy leaves too)."""
        dev = resolve_device(device)

        def leaf(x):
            if not torch.is_tensor(x):
                x = torch.from_numpy(np.asarray(x, np.float32))
            return x.to(device=dev, dtype=_F32)
        return DeadlineParams(*(leaf(x) for x in self))


class DeadlineState(NamedTuple):
    """The slot loop's deadline carry."""

    Qd: torch.Tensor  # [M, D] age rings; their sum over D is Qe exactly
    mu: torch.Tensor  # [M] EWMA of the observed dispatch rate


class DeadlineLedger(NamedTuple):
    """A run's deadline accounting, on a result's `.deadlines` field.
    Series cover all T slots in every record mode; `Qd` follows the
    record mode's length R, as Qe and Qc do. A fleet adds a leading [F]
    axis to every field."""

    missed: torch.Tensor    # [T] tasks expired past their deadline a slot
    shed: torch.Tensor      # [T] arrivals rejected by admission control
    admitted: torch.Tensor  # [T] arrivals admitted to the edge queue
    Qd: torch.Tensor        # [R, M, D] recorded age rings (post-step)

    @property
    def total_missed(self) -> torch.Tensor:
        return torch.sum(self.missed, dim=-1)

    @property
    def total_shed(self) -> torch.Tensor:
        return torch.sum(self.shed, dim=-1)


class DeadlineView(NamedTuple):
    """What one slot of deadline state shows the policy."""

    deadline: torch.Tensor  # [M] per-type deadline (+inf = none)
    window: torch.Tensor    # [M] per-type deferral window
    slack: torch.Tensor     # [M] slots before the oldest queued task expires
    #                             (+inf when the queue is empty or no deadline)
    due: torch.Tensor       # [M] 1.0 where slack <= 0: the last service chance
    ages: torch.Tensor      # [M, D] the rings themselves


def no_deadlines(M: int, D: int = DEFAULT_RINGS, device=DEFAULT_DEVICE) -> DeadlineParams:
    """Infinite deadlines and windows, shedding off: the bitwise anchor."""
    dev = resolve_device(device)
    inf = torch.full((M,), float("inf"), dtype=_F32, device=dev)
    return DeadlineParams(
        deadline=inf,
        window=inf.clone(),
        shed_on=torch.zeros((), dtype=_F32, device=dev),
        headroom=torch.ones((), dtype=_F32, device=dev),
        alpha=torch.full((), 0.2, dtype=_F32, device=dev),
        rings=torch.zeros((D,), dtype=_F32, device=dev),
    )


def make_deadlines(M: int, D: int = DEFAULT_RINGS, device=DEFAULT_DEVICE,
                   **overrides) -> DeadlineParams:
    """`no_deadlines` with per-field overrides, scalars broadcast to the
    field's shape: the one constructor scenario builders and tests use.
    Rejects finite deadlines outside [0, D - 1] (deeper ones would never
    expire)."""
    base = no_deadlines(M, D, device)
    bad = set(overrides) - (set(DeadlineParams._fields) - {"rings"})
    if bad:
        raise ValueError(f"unknown DeadlineParams fields: {sorted(bad)}")
    if "deadline" in overrides:
        d = overrides["deadline"]
        d = d.detach().cpu().numpy() if torch.is_tensor(d) else np.asarray(d, np.float32)
        finite = d[np.isfinite(d)]
        if finite.size and (finite.max() > D - 1 or finite.min() < 0):
            raise ValueError(
                f"finite deadlines must lie in [0, D-1] = [0, {D - 1}] (got "
                f"{finite.min():g}..{finite.max():g}); raise D to track older tasks")
    dev = base.deadline.device
    cast = {}
    for k, v in overrides.items():
        x = v if torch.is_tensor(v) else torch.from_numpy(np.asarray(v, np.float32))
        cast[k] = torch.broadcast_to(x.to(device=dev, dtype=_F32),
                                     getattr(base, k).shape).clone()
    return base._replace(**cast)


def stack_deadlines(params) -> DeadlineParams:
    """Per-lane DeadlineParams stacked onto a leading fleet axis (every
    lane with the same M and D)."""
    params = list(params)
    return DeadlineParams(*(torch.stack([torch.as_tensor(p[i], dtype=_F32) for p in params])
                            for i in range(len(DeadlineParams._fields))))


def init_deadlines(M: int, D: int, device=DEFAULT_DEVICE, F: int | None = None) -> DeadlineState:
    """Empty rings and a cold estimator; with `F`, F lanes of them."""
    dev = resolve_device(device)
    lanes = () if F is None else (int(F),)
    return DeadlineState(Qd=torch.zeros(lanes + (M, D), dtype=_F32, device=dev),
                         mu=torch.zeros(lanes + (M,), dtype=_F32, device=dev))


def _ring_index(D: int, device) -> torch.Tensor:
    return torch.arange(D, dtype=_F32, device=device)


def deadline_view(params: DeadlineParams, ds: DeadlineState) -> DeadlineView:
    """The slot's view for the policy: the slack of each type's OLDEST
    queued task (its deadline less its ring index) and the last-chance
    flag. Empty queues and infinite deadlines both read slack = +inf."""
    idx = _ring_index(ds.Qd.shape[-1], ds.Qd.device)
    oldest = torch.amax(torch.where(ds.Qd > 0.0, idx, -1.0), dim=-1)  # [..., M], -1 = empty
    slack = torch.where(oldest >= 0.0, params.deadline - oldest, float("inf"))
    due = (slack <= 0.0).to(_F32)
    return DeadlineView(deadline=params.deadline, window=params.window, slack=slack, due=due,
                        ages=ds.Qd)


def step_deadlines(params: DeadlineParams, ds: DeadlineState, d_sum: torch.Tensor,
                   a: torch.Tensor):
    """One slot of deadline dynamics for `d_sum [..., M]` tasks dispatched
    off the edge and `a [..., M]` arrivals (before admission). Returns
    (next state, admitted, expired, shed), each [..., M]; the caller's
    edge-queue update is `max(Qe - d_sum, 0) + admitted - expired`.

    In order: drain `d_sum` oldest-first (ring j gives up min(Qd[j],
    max(0, d - the rings above j)), a reversed prefix sum); expire the
    post-drain rings at index >= deadline; age the rest one ring up (the
    top ring sticky); move `mu` toward the dispatch rate on slots that
    had queued work; admit at most floor(headroom * mu * (deadline + 1)
    - queued) arrivals where shedding is on, the deadline finite and the
    estimator warm (mu > 0), and every arrival otherwise."""
    with phase("deadline_step"):
        return _step_deadlines(params, ds, d_sum, a)


def _step_deadlines(params, ds, d_sum, a):
    Qd = ds.Qd
    idx = _ring_index(Qd.shape[-1], Qd.device)
    total = torch.sum(Qd, dim=-1)  # == Qe before this step
    d_clamped = torch.minimum(d_sum, total)

    # oldest-first drain: older[j] = the rings above j
    older = torch.flip(torch.cumsum(torch.flip(Qd, (-1,)), dim=-1), (-1,)) - Qd
    taken = torch.minimum(Qd, torch.clamp_min(d_clamped[..., None] - older, 0.0))
    after = Qd - taken

    # expiry: post-drain tasks at ring >= deadline miss their window
    expired_rings = torch.where(idx >= params.deadline[..., None], after, 0.0)
    expired = torch.sum(expired_rings, dim=-1)
    kept = after - expired_rings

    # aging: one ring up, the top ring sticky
    shifted = torch.cat([torch.zeros_like(kept[..., :1]), kept[..., :-1]], dim=-1)
    shifted = torch.cat([shifted[..., :-1], shifted[..., -1:] + kept[..., -1:]], dim=-1)

    # the dispatch-rate estimate, on slots with queued work only
    alpha = params.alpha[..., None]
    mu = torch.where(total > 0.0, fma_f32(1.0 - alpha, ds.mu, alpha * d_clamped), ds.mu)

    # admission: the deadline and the select are sanitized so that no
    # inf * 0 appears, even in the branch not taken
    queued = torch.sum(shifted, dim=-1)
    finite = torch.isfinite(params.deadline)
    d_safe = torch.where(finite, params.deadline, 0.0)
    room = fma_f32(params.headroom[..., None] * mu, d_safe + 1.0, -queued)
    cap = torch.where((mu > 0.0) & finite, torch.floor(torch.clamp_min(room, 0.0)),
                      float("inf"))
    shed = torch.where(params.shed_on[..., None] > 0.0, torch.clamp_min(a - cap, 0.0), 0.0)
    admitted = a - shed

    Qd = torch.cat([shifted[..., :1] + admitted[..., None], shifted[..., 1:]], dim=-1)
    return DeadlineState(Qd=Qd, mu=mu), admitted, expired, shed
