"""Carbon-intensity forecasting and the forecast-quality stress axis, in
PyTorch (counterpart of `repro.forecast`).

Forecasters produce an [H, N+1] intensity forecast each slot (row 0 =
the observed present; [F, H, N+1] on a fleet's lanes);
`LookaheadDPPPolicy` consumes them through `simulate(..., forecaster=)`
and `simulate_fleet(..., forecaster=)`. See forecasters.py for the
contract.
"""
from repro_torch.forecast.forecasters import (
    EWMAForecaster,
    Forecaster,
    PersistenceForecaster,
    RidgeARForecaster,
    SeasonalNaiveForecaster,
)
from repro_torch.forecast.metrics import forecast_errors, rolling_forecasts
from repro_torch.forecast.source import (
    ClairvoyantTableForecaster,
    ForecastErrorModel,
    ForecastedCarbonSource,
)

__all__ = [
    "Forecaster",
    "PersistenceForecaster",
    "SeasonalNaiveForecaster",
    "EWMAForecaster",
    "RidgeARForecaster",
    "ForecastErrorModel",
    "ForecastedCarbonSource",
    "ClairvoyantTableForecaster",
    "forecast_errors",
    "rolling_forecasts",
]
