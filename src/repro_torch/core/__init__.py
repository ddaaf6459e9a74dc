"""The paper's model and slot loop, in PyTorch (counterpart of
`repro.core`)."""
from repro_torch.core.carbon import (
    ConstantCarbonSource,
    RandomCarbonSource,
    TableCarbonSource,
    UKRegionalTraceSource,
    bursty_table,
    diurnal_table,
    from_eso_csv,
    materialize,
    uk_regional_table,
)
from repro_torch.core.policies import (
    CarbonIntensityPolicy,
    LookaheadDPPPolicy,
    QueueLengthPolicy,
    RandomPolicy,
    greedy_fill,
    literal_algorithm1,
)
from repro_torch.core.queueing import (
    Action,
    NetworkSpec,
    NetworkState,
    emissions,
    init_state,
    is_feasible,
    step,
)
from repro_torch.core.simulator import (
    PoissonArrivals,
    SimResult,
    UniformArrivals,
    mean_rate_stability_metric,
    simulate,
)

__all__ = [
    "Action",
    "CarbonIntensityPolicy",
    "ConstantCarbonSource",
    "LookaheadDPPPolicy",
    "NetworkSpec",
    "NetworkState",
    "PoissonArrivals",
    "QueueLengthPolicy",
    "RandomCarbonSource",
    "RandomPolicy",
    "SimResult",
    "TableCarbonSource",
    "UKRegionalTraceSource",
    "UniformArrivals",
    "bursty_table",
    "diurnal_table",
    "emissions",
    "from_eso_csv",
    "greedy_fill",
    "init_state",
    "is_feasible",
    "literal_algorithm1",
    "materialize",
    "mean_rate_stability_metric",
    "simulate",
    "step",
    "uk_regional_table",
]
