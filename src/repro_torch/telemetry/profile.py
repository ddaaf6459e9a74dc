"""Phase annotation for profiler traces (counterpart of
`repro.telemetry.profile`).

`phase("policy_score")` is `torch.profiler.record_function` with a
`repro.<name>` label, so a `torch.profiler` timeline shows the slot
anatomy (score pass, greedy fill) instead of a wall of kernels. Labels
are metadata only and never change the computation.
"""
from __future__ import annotations

import contextlib

import torch

# The slot anatomy, in execution order: the names the JAX package uses,
# and two of the port's own. Each is placed in the port's slot loops.
PHASES = (
    "slot",           # one slot of a loop, around the others (the port's)
    "policy_score",   # DPP score tables
    "route_score",    # WAN (type, route, cloud) score tables
    "greedy_fill",    # budget fill
    "transfer_step",  # link injection / drain / delivery
    "fault_step",     # fault chain transitions + observation masking
    "fault_retry",    # failure draws + retry-pool backoff
    "stream_flush",   # a streamed chunk's copy to the host channel (the port's)
)


def phase(name: str):
    """Context manager labelling the ops run inside it as `repro.<name>`."""
    return torch.profiler.record_function(f"repro.{name}")


def slot_range(T: int):
    """range(T) for a loop over a run's slots, each slot's body labelled
    `repro.slot` (what `repro_torch.analysis.audit` reads as a slot)."""
    for t in range(T):
        with phase("slot"):
            yield t


@contextlib.contextmanager
def trace_to(logdir):
    """Records a `torch.profiler` trace of the enclosed block (host ops,
    and the card's kernels when one is in use) and writes it into
    `logdir` as a Chrome trace (`trace.json`, viewable in Perfetto or
    chrome://tracing beside `export.to_chrome_trace`'s series)."""
    from pathlib import Path

    from torch.profiler import ProfilerActivity, profile

    acts = [ProfilerActivity.CPU] + ([ProfilerActivity.CUDA] if torch.cuda.is_available() else [])
    out = Path(logdir)
    out.mkdir(parents=True, exist_ok=True)
    with profile(activities=acts) as prof:
        yield prof
    prof.export_chrome_trace(str(out / "trace.json"))
