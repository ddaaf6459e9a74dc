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
    ExactDPPPolicy,
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
    FleetArrivals,
    FleetScenario,
    FleetSpec,
    PoissonArrivals,
    SimResult,
    UniformArrivals,
    init_forecaster_carry,
    mean_rate_stability_metric,
    simulate,
    simulate_fleet,
    simulate_vsweep,
    stack_scenarios,
    sweep_forecast_errors,
)

__all__ = [
    "Action",
    "CarbonIntensityPolicy",
    "ConstantCarbonSource",
    "ExactDPPPolicy",
    "FleetArrivals",
    "FleetScenario",
    "FleetSpec",
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
    "init_forecaster_carry",
    "init_state",
    "is_feasible",
    "literal_algorithm1",
    "materialize",
    "mean_rate_stability_metric",
    "simulate",
    "simulate_fleet",
    "simulate_vsweep",
    "stack_scenarios",
    "step",
    "sweep_forecast_errors",
    "uk_regional_table",
]

from repro_torch.core.extensions import (  # noqa: E402
    AdaptiveVController,
    ThresholdPolicy,
    oracle_emissions_for_work,
    oracle_emissions_horizon,
)

__all__ += [
    "AdaptiveVController",
    "ThresholdPolicy",
    "oracle_emissions_for_work",
    "oracle_emissions_horizon",
]
