"""Safe-guard buffer (paper Eq. 9):  beta = K1 * R_A  +  K2 * V_A.

Counterpart of ``repro/core/shaper/safeguard.py``.  K1 scales the static
term (a floor as a fraction of the reservation R), K2 the dynamic term:
K2 predictive standard deviations of the forecaster (the paper's
"three-sigma" bands).  Elementwise, so it runs on whatever device its
tensors are on.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.uncertainty.scoring import sigma_from_var
from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class SafeguardConfig:
    k1: float = 0.05   # paper's best: 5% static floor
    k2: float = 3.0    # paper's best: 3-sigma dynamic band


def beta(request: torch.Tensor, var: torch.Tensor,
         cfg: SafeguardConfig) -> torch.Tensor:
    """Buffer added on top of the predicted peak utilization.

    ``k1 * request`` is added to the dynamic term with a single rounding
    (``ops.fma_f32``, a fused multiply-add), which is how XLA compiles the
    reference's expression; two roundings would move about 0.5% of the
    demands by one ulp.  At k1 = 1 XLA drops the multiplication by one
    and contracts ``k2 * sigma + request`` instead."""
    if np.float32(cfg.k1) == 1:
        return kops.fma_f32(sigma_from_var(var), np.float32(cfg.k2), request)
    dyn = cfg.k2 * sigma_from_var(var)
    return kops.fma_f32(request, np.float32(cfg.k1), dyn)


def shaped_demand(pred_peak: torch.Tensor, request: torch.Tensor,
                  var: torch.Tensor, cfg: SafeguardConfig) -> torch.Tensor:
    """Allocation target: forecast peak + beta, clamped into [0, request]
    (the shaper only redeems slack; it never grants more than reserved)."""
    b = beta(request, var, cfg)
    return torch.minimum(torch.clamp_min(pred_peak + b, 0.0), request)
