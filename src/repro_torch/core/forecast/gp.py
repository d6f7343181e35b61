"""GP regression with a history-dependent kernel (paper §3.1.2), batched.

Counterpart of ``repro/core/forecast/gp.py``.  The reference forecasts
one series and ``vmap``s it over a fleet; here every function carries
the batch of series as its first axis, ``windows (B, T)``.  Rows never
interact, so a row's result does not depend on the batch it rides in
(the engine pads batches to power-of-two buckets and relies on that).

Series are modeled as ``y_t = f(y_{t-1}, ..., y_{t-h}) + eps`` (Eq. 4)
and ``f`` is learned by GP regression over pattern inputs
``[t, y_{t-h}, ..., y_{t-1}]`` (Eq. 5) with the Gram matrix of Eq. 6
(``repro_torch.kernels.ops.gram``: the CUDA kernel on the card, the
plain version on the CPU).  Hyper-parameters ``(ell, sf, sn)`` are
fitted by a fixed number of Adam steps on the log marginal likelihood,
and the forecast iterates the posterior mean (Eqs. 7-8) over the
horizon.
"""
from __future__ import annotations

import dataclasses
import math

import torch

from repro_torch.core.forecast.base import Forecast
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops


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


def _cholesky(K: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; NaN where a matrix is not positive
    definite, as ``jnp.linalg.cholesky`` returns (``torch.linalg.cholesky``
    would raise for the whole batch)."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill((info > 0)[:, None, None], float("nan"))


def _noisy_cholesky(X, row_valid, ell, sf, sn, cfg: GPConfig) -> torch.Tensor:
    """Cholesky factor of ``K(X, X) + diag(noise)``; invalid pattern rows
    are decoupled with noise 1e6 so they carry no information."""
    K = kops.gram(X, X, ell, sf, kind=cfg.kernel)
    noise = torch.where(row_valid, sn[:, None] ** 2 + cfg.jitter, 1e6)
    return _cholesky(K + torch.diag_embed(noise))


def _neg_log_marginal(log_params: torch.Tensor, X: torch.Tensor,
                      y: torch.Tensor, row_valid: torch.Tensor,
                      cfg: GPConfig) -> torch.Tensor:
    """Per-series negative log marginal likelihood, ``(B,)``."""
    ell, sf, sn = log_params.exp().unbind(1)
    L = _noisy_cholesky(X, row_valid, ell, sf, sn, cfg)
    alpha = torch.cholesky_solve(y[:, :, None], L)[:, :, 0]
    n_eff = row_valid.sum(1).to(y.dtype)
    logdet = torch.where(row_valid,
                         torch.log(torch.diagonal(L, dim1=1, dim2=2)), 0.0)
    return ((0.5 * y * alpha).sum(1) + logdet.sum(1)
            + 0.5 * n_eff * math.log(2.0 * math.pi))


def _optimize_evidence(X: torch.Tensor, y: torch.Tensor,
                       row_valid: torch.Tensor, cfg: GPConfig) -> torch.Tensor:
    """A fixed Adam loop on the log marginal likelihood, per series:
    log-params ``(B, 3)`` for ``(ell, sf, sn)``.

    As in the reference, a non-finite gradient entry (a non-PD step) is
    zeroed and the log-params are clipped to [-6, 6] after each step.
    The bias corrections ``1 - b**(i+1)`` are float32 powers, as the
    reference computes them from its float32 step counter."""
    B = X.shape[0]
    b1, b2, eps = 0.9, 0.999, 1e-8
    steps = torch.arange(1, cfg.opt_steps + 1, dtype=torch.float32)
    bc1 = (1 - torch.tensor(b1, dtype=torch.float32) ** steps).tolist()
    bc2 = (1 - torch.tensor(b2, dtype=torch.float32) ** steps).tolist()
    init = torch.log(torch.tensor([1.0, 1.0, 0.3], dtype=torch.float32))
    p = init.to(X.device).expand(B, 3).clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for i in range(cfg.opt_steps):
        lp = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = _neg_log_marginal(lp, X, y, row_valid, cfg).sum()
            (g,) = torch.autograd.grad(loss, lp)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1[i]
        vh = v / bc2[i]
        p = torch.clamp(p - cfg.opt_lr * mh / (torch.sqrt(vh) + eps), -6.0, 6.0)
    return p


@dataclasses.dataclass(frozen=True)
class GPForecaster:
    """History-kernel GP forecaster (paper's non-parametric model)."""

    cfg: GPConfig = GPConfig()

    @torch.no_grad()
    def forecast_batch(self, windows, horizon: int, *, valid=None,
                       device: str | torch.device = "cuda") -> Forecast:
        """Forecast ``(B, T)`` windows (oldest first) ``horizon`` steps
        ahead; ``valid`` masks samples a young series has not seen yet.
        Returns a Forecast of ``(B, horizon)`` tensors on ``device``."""
        cfg = self.cfg
        dev = resolve_device(device)
        w = torch.as_tensor(windows, dtype=torch.float32, device=dev)
        B, T = w.shape
        v = (torch.ones((B, T), dtype=torch.bool, device=dev) if valid is None
             else torch.as_tensor(valid, dtype=torch.bool, device=dev))
        h = cfg.history
        z, mu, sd = _standardize(w, v)
        X, y = build_patterns(z, h, cfg.max_patterns)
        n = X.shape[1]
        # a pattern row is valid iff its whole history + target are observed
        tgt = torch.arange(T - n, T, device=dev)
        row_valid = v[:, tgt[:, None] + torch.arange(-h, 1, device=dev)].all(2)

        ell, sf, sn = _optimize_evidence(X, y, row_valid, cfg).exp().unbind(1)
        L = _noisy_cholesky(X, row_valid, ell, sf, sn, cfg)
        alpha = torch.cholesky_solve(y[:, :, None], L)[:, :, 0]

        # iterated k-step-ahead: the predictive mean is fed back into the
        # history; the predictive variance at each step is Eq. 8's
        hist = z[:, -h:]
        means, variances = [], []
        for k in range(horizon):
            t_next = torch.full((B, 1), (T + k) / max(T - 1, 1),
                                dtype=torch.float32, device=dev)
            xs = torch.cat([t_next, hist], dim=1)[:, None, :]
            ks = kops.gram(xs, X, ell, sf, kind=cfg.kernel)[:, 0]
            mean_k = (ks * alpha).sum(1)
            kv = torch.cholesky_solve(ks[:, :, None], L)[:, :, 0]
            var_k = torch.clamp_min(sf ** 2 + sn ** 2 - (ks * kv).sum(1), 1e-9)
            means.append(mean_k)
            variances.append(var_k)
            hist = torch.cat([hist[:, 1:], mean_k[:, None]], dim=1)

        mean = torch.stack(means, 1) * sd[:, None] + mu[:, None]
        var = torch.stack(variances, 1) * (sd ** 2)[:, None]
        # degenerate window (fewer than h+1 valid points): persistence with
        # an inflated variance rather than NaN
        enough = (v.sum(1) >= h + 1)[:, None]
        last = w[:, -1:]
        mean = torch.where(enough, mean, last)
        var = torch.where(enough, var, (0.5 * torch.abs(last) + 1.0) ** 2)
        return Forecast(mean=mean, var=var)
