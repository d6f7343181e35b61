"""Safe-guard buffer (paper Eq. 9):  beta = K1 * R_A  +  K2 * V_A.

Counterpart of ``repro/core/shaper/safeguard.py``.  K1 scales the static
term (a floor as a fraction of the reservation R), K2 the dynamic term:
K2 predictive standard deviations of the forecaster (the paper's
"three-sigma" bands).  With conformal calibration
(``SimConfig.calibration``) the dynamic term is a per-series calibrated
multiplier times sigma instead (:func:`shaped_demand_scaled`).
Elementwise, so it runs on whatever device its tensors are on.
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


def clip_request(x: torch.Tensor, request: torch.Tensor) -> torch.Tensor:
    """``clip(x, 0, request)`` as XLA:CPU's clamp gives it: a NaN ``x`` is
    kept as it is (ATen's vectorised min and max give a NaN of all ones
    on the CPU, CUDA its canonical NaN)."""
    return torch.where(torch.isnan(x), x, torch.minimum(torch.clamp_min(x, 0.0), request))


def shaped_demand(pred_peak: torch.Tensor, request: torch.Tensor,
                  var: torch.Tensor, cfg: SafeguardConfig) -> torch.Tensor:
    """Allocation target: forecast peak + beta, clamped into [0, request]
    (the shaper only redeems slack; it never grants more than reserved)."""
    return clip_request(pred_peak + beta(request, var, cfg), request)


def shaped_demand_scaled(pred_peak: torch.Tensor, request: torch.Tensor,
                         var: torch.Tensor, k1: float, scale: torch.Tensor, *,
                         k1_folded: bool = False) -> torch.Tensor:
    """Eq. 9 with a per-element sigma multiplier ``scale`` (the conformal
    safeguard), clamped into [0, request] as :func:`shaped_demand`.

    XLA contracts ``k1 * request + scale * sigma`` into
    ``fma(k1, request, scale * sigma)``, rounded once (``ops.fma_f32``).
    Where k1 is a constant of the compiled program (the reference's
    device engine: ``k1_folded``) and equals 1, XLA drops the product by
    one and contracts ``scale * sigma + request`` instead; the host
    engine passes k1 as an argument, so its program keeps the first form
    at every k1."""
    k1 = np.float32(k1)
    sigma = sigma_from_var(var)
    if k1_folded and k1 == 1:
        b = kops.fma_f32(scale, sigma, request)
    else:
        b = kops.fma_f32(request, k1, scale * sigma)
    return clip_request(pred_peak + b, request)
