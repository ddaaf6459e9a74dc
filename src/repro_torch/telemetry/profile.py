"""Phase annotation for profiler traces (counterpart of
`repro.telemetry.profile`).

`phase("policy_score")` is `torch.profiler.record_function` with a
`repro.<name>` label, so a `torch.profiler` timeline shows the slot
anatomy (score pass, greedy fill) instead of a wall of kernels. Labels
are metadata only and never change the computation.
"""
from __future__ import annotations

import torch

# The slot anatomy, in execution order; the names the JAX package uses.
# Only the first and third are placed in the ported slice.
PHASES = (
    "policy_score",   # DPP score tables
    "route_score",    # WAN (type, route, cloud) score tables
    "greedy_fill",    # budget fill
    "transfer_step",  # link injection / drain / delivery
    "fault_step",     # fault chain transitions + observation masking
    "fault_retry",    # failure draws + retry-pool backoff
)


def phase(name: str):
    """Context manager labelling the ops run inside it as `repro.<name>`."""
    return torch.profiler.record_function(f"repro.{name}")
