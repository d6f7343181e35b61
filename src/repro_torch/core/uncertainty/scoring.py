"""Variance and quantile helpers shared by the forecasters, the safeguard
and the engine, and the proper scoring metrics of predictive
distributions (counterpart of ``repro/core/uncertainty/scoring.py``):
coverage against the nominal level, pinball loss, Gaussian and
empirical CRPS.
"""
from __future__ import annotations

import math

import numpy as np
import torch


def sigma_from_var(var: torch.Tensor) -> torch.Tensor:
    """Predictive standard deviation; the clamp absorbs float32 variances
    that round to tiny negatives without inflating exact zeros.  The root
    is taken in float64 and rounded once, which makes it the correctly
    rounded float32 root that XLA computes (PyTorch's vectorized float32
    root on the CPU is off by an ulp for ~0.6% of inputs)."""
    return torch.sqrt(torch.clamp_min(var, 0.0).double()).to(var.dtype)


def sigma_from_var_np(var: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`sigma_from_var` for host-side code."""
    return np.sqrt(np.maximum(var, 0.0))


def bucket_pow2(n: int, base: int = 64) -> int:
    """Smallest power-of-two batch bucket >= n (never below ``base``)."""
    b = base
    while b < n:
        b *= 2
    return b


def gaussian_quantile_scale(q) -> torch.Tensor:
    """z such that ``mean + z * sigma`` is the Gaussian q-quantile."""
    return torch.special.ndtri(torch.as_tensor(q, dtype=torch.float32))


def empirical_coverage(y: torch.Tensor, upper: torch.Tensor,
                       where: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of outcomes ``y <= upper``; compare against the nominal
    quantile level.  ``where`` masks invalid rows."""
    hit = (y <= upper).float()
    if where is None:
        return hit.mean()
    w = where.float()
    return (hit * w).sum() / torch.clamp_min(w.sum(), 1.0)


def pinball_loss(y: torch.Tensor, pred_q: torch.Tensor, q) -> torch.Tensor:
    """Mean pinball (quantile) loss of predicted q-quantiles: ``u * (q -
    1[u < 0])`` with ``u = y - pred_q``, minimized in expectation by the
    true q-quantile."""
    q = torch.as_tensor(q, dtype=torch.float32, device=y.device)
    u = y - pred_q
    return torch.maximum(q * u, (q - 1.0) * u).mean()


def crps_gaussian(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Closed-form CRPS of N(mean, var) predictions, averaged over y:
    ``s * (z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi))``, ``z = (y - m) / s``."""
    sigma = torch.clamp_min(sigma_from_var(var), 1e-9)
    z = (y - mean) / sigma
    phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
    return (sigma * (z * (2.0 * cdf - 1.0) + 2.0 * phi - 1.0 / math.sqrt(math.pi))).mean()


def crps_empirical(y: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Sample-based CRPS, averaged over y, in the energy form ``E|X - y| -
    0.5 E|X - X'|``; ``samples`` is ``(n,)`` shared by every y or
    ``(batch, n)``."""
    if samples.dim() == 1:
        samples = samples.expand(y.shape[0], samples.shape[0])
    term1 = (samples - y[:, None]).abs().mean(1)
    term2 = (samples[:, :, None] - samples[:, None, :]).abs().mean((1, 2))
    return (term1 - 0.5 * term2).mean()
