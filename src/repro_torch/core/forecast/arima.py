"""ARIMA(p, d, q) forecasting (paper §3.1.1), batched.

Counterpart of ``repro/core/forecast/arima.py``: the paper's auto-ARIMA
with the reference's fixed shapes.  For every series of a batch and
every order (p, d, q) with d <= ``max_d``, p <= ``max_p``, q <=
``max_q`` and p + q > 0: difference the scale-normalised window d
times, fit ARMA(p, q) by Hannan-Rissanen (a long AR(``long_ar``) least
squares fit supplies innovation estimates, then a second regresses on p
lags of the series and q of the innovations; both ridge-regularised,
with excluded columns pinned to 0), score it by AIC = n log(sigma^2) +
2 (p + q + 2), and keep the first order of least AIC: its k-step
recursion with future innovations zero, and the psi-weight variance
sigma^2 * sum_{j<k} psi_j^2, integrated when d = 1.  A window with too
few valid samples falls back to its last value.  As in the paper, the
variances are in-sample and so narrow (the over-confidence that Fig. 4a
studies); this is the reference's function, kept as it is.

The whole forecast of a batch is ``repro_torch.kernels.ops.arima_forecast``:
one CUDA kernel launch on the card (``kernels/csrc/arima_forecast.cu``,
one warp per series, one lane per order), the plain version
(``kernels/ref.py::arima_select``) on the CPU.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.forecast.base import Forecast
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

MAX_P = 3
MAX_Q = 2
LONG_AR = 6          # stage-1 long-AR order m


@dataclasses.dataclass(frozen=True)
class ARIMAConfig:
    max_p: int = MAX_P
    max_q: int = MAX_Q
    max_d: int = 1
    long_ar: int = LONG_AR


@dataclasses.dataclass(frozen=True)
class ARIMAForecaster:
    """Auto-ARIMA forecaster (paper's parametric model)."""

    cfg: ARIMAConfig = ARIMAConfig()

    @torch.no_grad()
    def forecast_batch(self, windows, horizon: int, *, valid=None, ready=None,
                       device: str | torch.device = "cuda") -> Forecast:
        """Forecast ``(B, T)`` windows (oldest first) ``horizon`` steps
        ahead; ``valid`` masks samples a young series has not seen yet.
        ``ready`` (B,) bool on ``device`` forecasts only the rows it marks
        (the device engine's forecast-ready rows): each of those is
        bit-identical to the row forecast without a mask, and the other
        rows carry no forecast (the kernel skips them).
        Returns a Forecast of ``(B, horizon)`` tensors on ``device``."""
        dev = resolve_device(device)
        w = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        v = (torch.ones(w.shape, dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
        mean, var = kops.arima_forecast(w, v, horizon, self.cfg, ready)
        return Forecast(mean=mean, var=var)
