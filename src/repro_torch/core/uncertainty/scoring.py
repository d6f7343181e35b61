"""Variance and quantile helpers shared by the forecasters, the safeguard
and the engine (counterpart of ``repro/core/uncertainty/scoring.py:38-75``).
"""
from __future__ import annotations

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
