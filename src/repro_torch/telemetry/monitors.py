"""SLO health monitors (counterpart of `repro.telemetry.monitors`).

Each monitor is a per-slot threshold condition on the slot's
`TelemetryProbe` and the tap state. The [..., K] int32 activity vector
is a per-slot series; `finalize_taps` (or the `tap_scan` kernel) reduces
the [..., T, K] matrix into alert records (tripped flag, first-trip slot,
active-slot count) after the run.

The registry order is the alert axis: `Telemetry.alert_active[..., k]`,
`alert_first_slot[..., k]` etc. all index `MONITORS[k]`.
"""
from __future__ import annotations

import numpy as np
import torch

# Alert axis, in the JAX package's order.
MONITORS = (
    # backlog grew by more than growth_thresh for growth_sustain
    # consecutive slots: the system is losing the stability race.
    "backlog_growth",
    # the carbon signal the policy acts on is older than stale_budget
    # slots (beyond what StalenessGuardPolicy is tuned to absorb).
    "signal_staleness",
    # every cloud reports zero capacity: nothing the policy dispatches
    # can be serviced this slot.
    "all_clouds_down",
    # the flow-conservation residual
    #   cum(arrived) - (backlog + cum(processed) - cum(failed))
    #                - cum(missed) - cum(shed)
    # left the +/- drift_tol band: the ledger is leaking tasks.
    "conservation_drift",
    # tasks expired past their deadline this slot (beyond miss_tol):
    # the scheduler is converting deferral into SLO violations.
    "deadline_miss",
    # admission control rejected more than shed_frac of this slot's
    # arrivals: the system is in sustained overload.
    "shed_rate",
)
K = len(MONITORS)


def f32(x, like: torch.Tensor) -> torch.Tensor:
    """A config threshold as the float32 value JAX compares with (a
    Python float is weakly typed there and rounds to float32)."""
    return torch.tensor(np.float32(x), device=like.device)


def monitor_conditions(cfg, probe, growth_run: torch.Tensor,
                       residual: torch.Tensor) -> torch.Tensor:
    """[..., K] int32 per-slot alert conditions (1 = firing).

    `growth_run` is the count of consecutive growth slots (this slot
    included); `residual` the conservation residual after this slot.
    Everything else comes off the probe; its leading axes are lanes."""
    n_clouds = probe.dispatched.shape[-1]
    arrived = probe.arrived
    conds = (
        growth_run >= cfg.growth_sustain,
        probe.stale > cfg.stale_budget,
        probe.clouds_down >= f32(n_clouds, arrived),
        torch.abs(residual) > f32(cfg.drift_tol, arrived),
        probe.missed > f32(cfg.miss_tol, arrived),
        probe.shed > f32(cfg.shed_frac, arrived) * arrived,
    )
    return torch.stack([c.to(torch.int32) for c in conds], dim=-1)
