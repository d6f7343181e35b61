"""Device dispatch for the port's kernels (counterpart of
``repro.kernels.ops``).

The tensor's device decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain PyTorch version.  There is no switch
that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import gp_gram as _gg
from repro_torch.kernels import ref


def gram(xa: torch.Tensor, xb: torch.Tensor, lengthscale: torch.Tensor,
         sigma_f: torch.Tensor, *, kind: str = "exp") -> torch.Tensor:
    """Gram matrix k_h(xa, xb) (paper Eq. 6) per series.

    xa: (B,M,D), xb: (B,N,D), lengthscale and sigma_f: (B,) -> (B,M,N).
    Differentiable with respect to lengthscale and sigma_f."""
    if xa.device.type == "cuda":
        return _gg.Gram.apply(xa.contiguous(), xb.contiguous(),
                              lengthscale.contiguous(), sigma_f.contiguous(),
                              kind)
    if xa.device.type == "cpu":
        return ref.gram(xa, xb, lengthscale, sigma_f, kind=kind)
    raise ValueError(f"no gram implementation for device {xa.device}")
