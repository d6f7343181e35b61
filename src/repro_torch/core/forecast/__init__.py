"""Utilization forecasting (paper §3.1): predictive mean + variance.

The GP (non-parametric) and ARIMA (parametric) forecasters, the oracle
forecaster class and the persistence forecast.  The engines' ``oracle``
forecaster reads the trace directly, as the reference's do."""
from repro_torch.core.forecast.arima import ARIMAConfig, ARIMAForecaster
from repro_torch.core.forecast.base import (Forecast, peak_over_horizon,
                                            persistence_peak)
from repro_torch.core.forecast.gp import GPConfig, GPForecaster, build_patterns
from repro_torch.core.forecast.oracle import OracleForecaster

__all__ = ["Forecast", "peak_over_horizon", "persistence_peak",
           "ARIMAConfig", "ARIMAForecaster", "GPConfig", "GPForecaster",
           "build_patterns", "OracleForecaster"]
