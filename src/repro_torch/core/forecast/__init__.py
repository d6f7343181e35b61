"""Utilization forecasting (paper §3.1): predictive mean + variance.

Ported: the GP forecaster and the persistence forecast.  ARIMA and the
oracle forecaster class are still to port (the engine's ``oracle``
forecaster reads the trace directly and needs neither)."""
from repro_torch.core.forecast.base import (Forecast, peak_over_horizon,
                                            persistence_peak)
from repro_torch.core.forecast.gp import GPConfig, GPForecaster, build_patterns

__all__ = ["Forecast", "peak_over_horizon", "persistence_peak",
           "GPConfig", "GPForecaster", "build_patterns"]
