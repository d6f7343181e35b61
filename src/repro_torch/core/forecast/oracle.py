"""Oracle forecaster: perfect information about future utilization
(counterpart of ``repro/core/forecast/oracle.py``).

The paper's Fig. 3 isolates the value of the shaping mechanism from the
quality of the predictor by plugging in an oracle: the simulator hands
it the true future slice of each component's utilization series, and it
returns that slice with zero variance, so the safeguard buffer collapses
to its static term K1 * R.  The engines compute the true future peaks
inline (``sim/engine.py::_oracle_peaks``, ``sim/step.py::_oracle_peaks``),
as the reference's do; this class is the forecaster-protocol form.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.forecast.base import Forecast
from repro_torch.device import resolve_device


@dataclasses.dataclass(frozen=True)
class OracleForecaster:
    """Returns the supplied future truth, variance = 0.  Each method
    returns tensors on ``device`` (CUDA unless the caller asks for the
    CPU)."""

    def forecast_from_future(self, future, *,
                             device: str | torch.device = "cuda") -> Forecast:
        dev = resolve_device(device)
        future = torch.as_tensor(future, dtype=torch.float32, device=dev)
        return Forecast(mean=future, var=torch.zeros_like(future))

    # Forecaster-protocol shim: with no future supplied, degrade to
    # persistence
    def forecast(self, window, horizon: int, *, valid=None,
                 device: str | torch.device = "cuda") -> Forecast:
        dev = resolve_device(device)
        last = torch.as_tensor(window, dtype=torch.float32, device=dev)[-1]
        mean = last.expand(horizon).contiguous()
        return Forecast(mean=mean, var=torch.zeros_like(mean))

    def forecast_batch(self, windows, horizon: int, *, valid=None,
                       device: str | torch.device = "cuda") -> Forecast:
        dev = resolve_device(device)
        w = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        mean = w[:, -1:].expand(w.shape[0], horizon).contiguous()
        return Forecast(mean=mean, var=torch.zeros_like(mean))
