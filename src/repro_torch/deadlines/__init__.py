"""The deadline / SLO layer (counterpart of `repro.deadlines`): age-ringed
edge queues, expiry, admission control and load shedding (`model.py`),
and the deadline-aware policies (`policy.py`). `no_deadlines` runs are
bitwise equal to runs without the layer: its regression anchor."""
from repro_torch.deadlines.model import (
    DEFAULT_RINGS,
    DeadlineLedger,
    DeadlineParams,
    DeadlineState,
    DeadlineView,
    deadline_view,
    init_deadlines,
    make_deadlines,
    no_deadlines,
    stack_deadlines,
    step_deadlines,
)
from repro_torch.deadlines.policy import (
    EDDPolicy,
    SlackThresholdPolicy,
    WaitAwhilePolicy,
)

__all__ = [
    "DEFAULT_RINGS",
    "DeadlineLedger",
    "DeadlineParams",
    "DeadlineState",
    "DeadlineView",
    "deadline_view",
    "init_deadlines",
    "make_deadlines",
    "no_deadlines",
    "stack_deadlines",
    "step_deadlines",
    "EDDPolicy",
    "SlackThresholdPolicy",
    "WaitAwhilePolicy",
]
