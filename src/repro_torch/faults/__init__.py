"""Fault injection and graceful degradation for the scheduler
(counterpart of `repro.faults`).

`model.py` -- the fault processes (Markov outages, brownouts, link flaps,
telemetry dropouts, task failure with backoff retry) as loop-carried
tensors, a slot's uniforms in one draw launch; `sim.py` -- the faulted
slot loops that `simulate(..., faults=...)` delegates to; `guard.py` --
the StalenessGuardPolicy wrapper. `no_faults` runs are bitwise equal to
fault-free runs: the layer's regression anchor.
"""
from repro_torch.faults.guard import StalenessGuardPolicy
from repro_torch.faults.model import (
    FAULT_STREAM_SALT,
    FaultDraws,
    FaultParams,
    FaultState,
    FaultView,
    fault_draws,
    fault_paths,
    init_faults,
    make_faults,
    no_faults,
    requeue_failed,
    stack_faults,
    step_faults,
)
from repro_torch.faults.sim import (
    FaultSimResult,
    NetFaultSimResult,
    simulate_faulted,
    simulate_network_faulted,
)

__all__ = [
    "FAULT_STREAM_SALT",
    "FaultDraws",
    "FaultParams",
    "FaultSimResult",
    "FaultState",
    "FaultView",
    "NetFaultSimResult",
    "StalenessGuardPolicy",
    "fault_draws",
    "fault_paths",
    "init_faults",
    "make_faults",
    "no_faults",
    "requeue_failed",
    "simulate_faulted",
    "simulate_network_faulted",
    "stack_faults",
    "step_faults",
]
