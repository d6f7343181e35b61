"""Shared neural building blocks (counterpart of ``repro.models.layers``):
the subset Whisper uses — linear layers, LayerNorm, the GELU MLP and
embeddings.

Functional style, as in the reference: ``init_*`` returns a tensor or a
dict of tensors drawn from an explicit ``torch.Generator`` on ``device``
(``generator=None`` draws from the device's default generator; the
``meta`` device allocates nothing), and the apply functions are pure.
Linear weights are ``(d_in, d_out)``.
"""
from __future__ import annotations

import torch
import torch.nn.functional as F


def _dense_init(shape, dtype, generator, device) -> torch.Tensor:
    """Truncated normal in [-2, 2], scaled by fan_in**-0.5 (fan_in =
    shape[0]), drawn in fp32 and cast."""
    w = torch.empty(shape, dtype=torch.float32, device=device)
    torch.nn.init.trunc_normal_(w, 0.0, 1.0, -2.0, 2.0, generator=generator)
    return (w * shape[0] ** -0.5).to(dtype)


def init_linear(d_in: int, d_out: int, dtype, *, generator=None,
                device="cpu") -> torch.Tensor:
    return _dense_init((d_in, d_out), dtype, generator, device)


def matmul(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """``x @ w`` in the activation dtype.  Both operands share x's dtype,
    and the GEMM accumulates in fp32 (cuBLAS and the CPU both do for
    bf16; callers that need every partial sum in fp32 on the card turn
    off ``torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction``)."""
    return torch.matmul(x, w.to(x.dtype))


# ----------------------------------------------------------------------
# norms
# ----------------------------------------------------------------------

def init_layernorm(d: int, *, device="cpu") -> dict:
    return {"scale": torch.ones((d,), dtype=torch.float32, device=device),
            "bias": torch.zeros((d,), dtype=torch.float32, device=device)}


def layer_norm(x: torch.Tensor, p: dict, eps: float) -> torch.Tensor:
    """LayerNorm in fp32 with the population variance; result in x's dtype."""
    xf = x.float()
    mu = xf.mean(-1, keepdim=True)
    var = xf.var(-1, keepdim=True, correction=0)
    return ((xf - mu) * torch.rsqrt(var + eps) * p["scale"]
            + p["bias"]).to(x.dtype)


# ----------------------------------------------------------------------
# MLPs
# ----------------------------------------------------------------------

def init_gelu_mlp(d: int, ff: int, dtype, *, generator=None,
                  device="cpu") -> dict:
    return {"up": init_linear(d, ff, dtype, generator=generator, device=device),
            "down": init_linear(ff, d, dtype, generator=generator, device=device)}


def gelu_mlp(p: dict, x: torch.Tensor) -> torch.Tensor:
    """up -> GELU (the tanh approximation, jax.nn.gelu's default) in fp32
    -> down."""
    h = matmul(x, p["up"])
    return matmul(F.gelu(h.float(), approximate="tanh").to(x.dtype), p["down"])


# ----------------------------------------------------------------------
# embeddings
# ----------------------------------------------------------------------

def init_embedding(vocab: int, d: int, dtype, *, generator=None,
                   device="cpu") -> torch.Tensor:
    w = torch.empty((vocab, d), dtype=torch.float32, device=device)
    w.normal_(generator=generator)
    return (w * d ** -0.5).to(dtype)
