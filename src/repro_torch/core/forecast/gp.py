"""GP regression with a history-dependent kernel (paper §3.1.2), batched.

Counterpart of ``repro/core/forecast/gp.py``.  The reference forecasts
one series and ``vmap``s it over a fleet; here every function carries
the batch of series as its first axis, ``windows (B, T)``.  Rows never
interact, so a row's result does not depend on the batch it rides in
(the engine pads batches to power-of-two buckets and relies on that).

Series are modeled as ``y_t = f(y_{t-1}, ..., y_{t-h}) + eps`` (Eq. 4)
and ``f`` is learned by GP regression over pattern inputs
``[t, y_{t-h}, ..., y_{t-1}]`` (Eq. 5) with the Gram matrix of Eq. 6.
Hyper-parameters ``(ell, sf, sn)`` are fitted by a fixed number of Adam
steps on the log marginal likelihood, and the forecast iterates the
posterior mean (Eqs. 7-8) over the horizon.  That work, after the
patterns are built, takes one of two routes, chosen from the config and
the shapes before anything is launched, the same on every device:

* the fused GP program, ``repro_torch.kernels.ops.gp_fit_forecast``,
  where it takes the shapes (N <= ``gp_forecast.MAX_N`` patterns, D <=
  ``MAX_D`` features, ``opt_steps`` <= ``MAX_STEPS``): one CUDA kernel
  launch per batch on the card (``kernels/csrc/gp_forecast.cu``), the
  plain version (``kernels/ref.py``, autograd through the Gram matrix) on
  the CPU;
* otherwise the Gram route (:func:`gram_fit_forecast`), the reference's
  own structure: each Adam step a Gram matrix (``ops.gram``), its
  Cholesky factor and solves (``torch.linalg``), the closed-form gradient
  with respect to K and its ``(ell, sf)`` part (``ops.gram_bwd``); then
  the fit and one cross-Gram a horizon step.  On the card the Gram pair
  is ``kernels/csrc/gp_gram.cu``.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.core.forecast.base import Forecast
from repro_torch.device import resolve_device
from repro_torch.kernels import gp_forecast
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref


@dataclasses.dataclass(frozen=True)
class GPConfig:
    history: int = 10          # h — pattern length (paper uses 10/20/40)
    max_patterns: int = 10     # N — latest patterns kept (paper: N = h)
    kernel: str = "exp"        # "exp" (paper's choice) or "rbf"
    opt_steps: int = 25        # evidence-maximization Adam steps
    opt_lr: float = 0.08
    jitter: float = 1e-5


def build_patterns(windows: torch.Tensor, h: int,
                   n: int) -> tuple[torch.Tensor, torch.Tensor]:
    """(X, y) from the last ``n`` patterns of each window.

    X[b, i] = [t_i, y_{t_i-h}, ..., y_{t_i-1}],  y[b, i] = y_{t_i}  (Eq. 5),
    with the time feature normalized to [0, 1] over the window."""
    B, T = windows.shape
    n_avail = T - h
    if n_avail < 1:
        raise ValueError(f"window of {T} samples must be longer than history {h}")
    n = min(n, n_avail)
    tgt = torch.arange(T - n, T, device=windows.device)
    t_feat = tgt.to(torch.float32) / float(max(T - 1, 1))
    hist = windows[:, tgt[:, None] + torch.arange(-h, 0, device=windows.device)]
    X = torch.cat([t_feat.expand(B, n)[:, :, None], hist], dim=2)
    return X, windows[:, tgt]


def _standardize(y: torch.Tensor, valid: torch.Tensor):
    w = valid.to(y.dtype)
    cnt = torch.clamp_min(w.sum(1), 1.0)
    mu = (y * w).sum(1) / cnt
    var = ((y - mu[:, None]) ** 2 * w).sum(1) / cnt
    sd = torch.sqrt(torch.clamp_min(var, 1e-10))
    return (y - mu[:, None]) / sd[:, None], mu, sd


def fit_inputs(w: torch.Tensor, v: torch.Tensor, cfg: GPConfig):
    """What ``gp_fit_forecast`` takes from ``(B, T)`` windows ``w`` with
    valid samples ``v``: patterns X (B,N,D), targets y (B,N), row_valid
    (B,N), the last h standardized values hist (B,h), and the
    standardization's mu and sd (B,)."""
    T = w.shape[1]
    h = cfg.history
    z, mu, sd = _standardize(w, v)
    X, y = build_patterns(z, h, cfg.max_patterns)
    n = X.shape[1]
    # a pattern row is valid iff its whole history + target are observed
    tgt = torch.arange(T - n, T, device=w.device)
    row_valid = v[:, tgt[:, None] + torch.arange(-h, 1, device=w.device)].all(2)
    return X, y, row_valid, z[:, -h:], mu, sd


def finish(mean_z: torch.Tensor, var_z: torch.Tensor, w: torch.Tensor,
           v: torch.Tensor, mu: torch.Tensor, sd: torch.Tensor,
           cfg: GPConfig) -> Forecast:
    """Standardized ``(B, horizon)`` forecasts back to the windows' units,
    with persistence where a window is too short for the GP."""
    mean = mean_z * sd[:, None] + mu[:, None]
    var = var_z * (sd ** 2)[:, None]
    # degenerate window (fewer than h+1 valid points): persistence with
    # an inflated variance rather than NaN
    enough = (v.sum(1) >= cfg.history + 1)[:, None]
    last = w[:, -1:]
    mean = torch.where(enough, mean, last)
    var = torch.where(enough, var, (0.5 * torch.abs(last) + 1.0) ** 2)
    return Forecast(mean=mean, var=var)


def fused_takes(cfg: GPConfig, n: int, d: int) -> bool:
    """Whether the fused GP program takes ``n`` patterns of ``d`` features
    under ``cfg``; otherwise the forecast takes the Gram route."""
    return (n <= gp_forecast.MAX_N and d <= gp_forecast.MAX_D
            and cfg.opt_steps <= gp_forecast.MAX_STEPS)


# The Gram route's least batch: below it cuSOLVER factors one matrix by
# another routine (potrf, not potrfBatched) and cuBLAS solves a batch of at
# most 8 by a loop of single solves, and each gives other bits, so a row's
# forecast would depend on its batch.
ROUTE_MIN_ROWS = 16


def _optimize_evidence(X: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                       cfg: GPConfig) -> torch.Tensor:
    """The reference's fixed Adam loop on the log marginal likelihood,
    ``(B, 3)`` log ``(ell, sf, sn)``: each step one Gram matrix, its factor
    and the closed-form gradient (``ref.gp_evidence_grad`` with the
    dispatching Gram pair)."""
    def grad(p):
        return kref.gp_evidence_grad(p, X, y, row_valid, cfg, kops.gram, kops.gram_bwd)

    return kref.gp_adam(grad, X.shape[0], X.device, cfg)


def gram_fit_forecast(X: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                      hist: torch.Tensor, T: int, horizon: int, cfg: GPConfig,
                      ready: torch.Tensor | None = None):
    """The Gram route: what ``ops.gp_fit_forecast`` returns, ``(mean, var,
    log_params)`` in standardized units, for any number of patterns.
    Every row is computed (a batch of fewer than ROUTE_MIN_ROWS padded
    with all-invalid rows); with ``ready`` (B,) bool on X's device the
    unmarked rows are zeroed by ``torch.where``, so nothing is read back
    to the host and a CUDA graph can hold the route.  The factor's solves
    go through ``L^-1`` (``ref.inverse_solver``), whose rows, unlike a
    batched triangular solve's with one right-hand side, do not depend on
    the batch.  The forward Gram kernel runs ``opt_steps + 1 + horizon``
    times, its gradient ``opt_steps`` times."""
    B = X.shape[0]
    if B < ROUTE_MIN_ROWS:
        # all-invalid rows, as the engines pad a batch
        pad = ROUTE_MIN_ROWS - B
        X, y, row_valid, hist = (torch.cat([t, t.new_zeros((pad,) + t.shape[1:])])
                                 for t in (X, y, row_valid, hist))
    log_params = _optimize_evidence(X, y, row_valid, cfg)
    mean, var = kref.gp_fit_horizon(log_params, X, y, row_valid, hist, T, horizon, cfg,
                                    kops.gram, kref.inverse_solver)
    out = (mean[:B], var[:B], log_params[:B])
    if ready is None:
        return out
    return tuple(torch.where(ready[:, None], o, 0.0) for o in out)


@dataclasses.dataclass(frozen=True)
class GPForecaster:
    """History-kernel GP forecaster (paper's non-parametric model)."""

    cfg: GPConfig = GPConfig()

    @torch.no_grad()
    def forecast_batch(self, windows, horizon: int, *, valid=None, ready=None,
                       device: str | torch.device = "cuda") -> Forecast:
        """Forecast ``(B, T)`` windows (oldest first) ``horizon`` steps
        ahead; ``valid`` masks samples a young series has not seen yet.
        ``ready`` (B,) bool on ``device`` forecasts only the rows it marks
        (the device engine's forecast-ready rows): each of those is
        bit-identical to the row forecast without a mask, and the other
        rows carry no forecast (the GP program skips them; the Gram route
        computes them and zeroes them).
        Returns a Forecast of ``(B, horizon)`` tensors on ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        w = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        B, T = w.shape
        v = (torch.ones((B, T), dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
        X, y, row_valid, hist, mu, sd = fit_inputs(w, v, cfg)
        fit = (kops.gp_fit_forecast if fused_takes(cfg, *X.shape[1:])
               else gram_fit_forecast)
        mean_z, var_z, _ = fit(X, y, row_valid, hist, T, horizon, cfg, ready)
        return finish(mean_z, var_z, w, v, mu, sd, cfg)
