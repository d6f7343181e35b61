"""Forecast container and the batched reductions shared by the engine
(counterpart of ``repro/core/forecast/base.py``).

A forecast is the k-step-ahead predictive mean and *variance* of each
series in a batch: tensors of shape ``(B, horizon)``.  The variance is
what the safeguard (Eq. 9) consumes.
"""
from __future__ import annotations

import dataclasses

import torch


@dataclasses.dataclass(frozen=True)
class Forecast:
    mean: torch.Tensor   # (B, horizon)
    var: torch.Tensor    # (B, horizon) predictive variance


def peak_over_horizon(fc: Forecast) -> tuple[torch.Tensor, torch.Tensor]:
    """(peak mean, its variance) per series: the max of the predictive
    path (paper §4.2) and that step's variance.  ``torch.argmax`` returns
    the first maximum, as ``jnp.argmax`` does."""
    k = torch.argmax(fc.mean, dim=1, keepdim=True)
    return (torch.take_along_dim(fc.mean, k, 1)[:, 0],
            torch.take_along_dim(fc.var, k, 1)[:, 0])


def _sum_rows(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis one term at a time from the first, the
    order in which XLA:CPU reduces a row, so the float32 sums are the
    reference's to the bit."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def persistence_peak(windows: torch.Tensor,
                     valid: torch.Tensor) -> tuple[torch.Tensor, torch.Tensor]:
    """The ``persist`` forecaster over ``(B, W)`` windows: mean = last
    observation, var = masked window variance + 1e-6."""
    w = valid.to(windows.dtype)
    cnt = torch.clamp_min(_sum_rows(w), 1.0)
    mu = _sum_rows(windows * w) / cnt
    var = _sum_rows(((windows - mu[:, None]) ** 2) * w) / cnt
    return windows[:, -1], var + 1e-6
