"""Graceful degradation: the StalenessGuardPolicy wrapper (counterpart of
`repro.faults.guard`).

The port's base policies are fault-blind, as the JAX package's are: they
ignore the `fault_view` the faulted simulator passes. All degradation
lives in this one wrapper around any drift-plus-penalty policy (anything
with a `V` field: CarbonIntensityPolicy, LookaheadDPPPolicy,
NetworkAwareDPPPolicy):

  * staleness blending -- the penalty weight decays linearly with the
    carbon signal's age, V_eff = V * clip(1 - stale/s0, 0, 1), a
    per-lane device tensor (the policies take a tensor V). Past
    `stale_after` slots the policy is the V = 0 drift minimizer;
  * outage-aware dispatch -- down clouds get `outage_penalty` added to
    their Qc columns before scoring, so no dispatch targets them and
    dispatch stops when every cloud is down. Dead WAN routes get the same
    through the Qt term when the view has links.

A `deadline_view` goes on to the inner policy after the decay, so a
deadline-aware inner policy (`deadlines.SlackThresholdPolicy`) escalates
from V_eff. With a fresh signal and no outage both adjustments are exact
identities (V * 1.0, Qc + 0.0), so the guard is bitwise its inner policy
under zero faults.

Rounding follows XLA:CPU inside the simulator's scan, where the division
by the constant s0 becomes a multiply by its float32 reciprocal,
contracted with the subtraction: decay = fma(-stale, 1/s0, 1.0). It
differs from the correctly rounded 1 - stale/s0 at stale_after 6, 7, 10,
11 and 13 on a few counts; the default 8 is exact either way.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.kernels.numerics import fma_f32


@dataclasses.dataclass(frozen=True)
class StalenessGuardPolicy:
    """Wraps a DPP-family policy with staleness and outage degradation.

    `stale_after`: the carbon signal's age (slots) at which the carbon
    penalty is fully distrusted (V_eff reaches 0).
    `outage_penalty`: virtual backlog added to unavailable clouds and
    routes; anything above every reachable queue length works.
    """

    inner: object
    stale_after: int = 8
    outage_penalty: float = 1e9

    def __post_init__(self):
        if self.stale_after <= 0:
            raise ValueError(
                f"stale_after={self.stale_after} must be positive (it divides the staleness "
                "counter)")
        if not hasattr(self.inner, "V"):
            raise ValueError(
                "StalenessGuardPolicy needs a drift-plus-penalty inner policy with a V field; "
                f"got {type(self.inner).__name__}")

    def __call__(self, state, spec, Ce, Cc, arrivals=None, key=None, *, fault_view=None,
                 forecast=None, graph=None, Qt=None, deadline_view=None):
        inner = self.inner
        if fault_view is not None:
            dev = state.Qc.device
            inv = float(np.float32(1.0) / np.float32(self.stale_after))
            decay = torch.clamp(fma_f32(-fault_view.stale.to(torch.float32), inv, 1.0), 0.0, 1.0)
            V = inner.V if torch.is_tensor(inner.V) else torch.full(
                (), float(inner.V), dtype=torch.float32, device=dev)
            inner = dataclasses.replace(inner, V=V.to(device=dev, dtype=torch.float32) * decay)
            big = torch.full((), float(np.float32(self.outage_penalty)), dtype=torch.float32,
                             device=dev)
            state = state._replace(Qc=state.Qc + big * (1.0 - fault_view.cloud_on)[..., None, :])
            if Qt is not None and fault_view.link_on is not None:
                Qt = Qt + big * (1.0 - fault_view.link_on)[..., None, :]
        kwargs = {} if forecast is None else {"forecast": forecast}
        if deadline_view is not None:
            # deadline urgency composes with the decay: a deadline-aware
            # inner policy escalates from the decayed V
            kwargs["deadline_view"] = deadline_view
        if graph is not None:
            return inner(state, spec, Ce, Cc, arrivals, key, graph=graph, Qt=Qt, **kwargs)
        return inner(state, spec, Ce, Cc, arrivals, key, **kwargs)
