"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

They define what each kernel computes: the CPU path runs them, and the
kernel checks compare the CUDA kernels with them on the card.  The Gram
functions carry an explicit batch of series where the reference used
``vmap``: ``xa (B, M, D)``, ``xb (B, N, D)`` and per-series
``lengthscale`` and ``sigma_f`` of shape ``(B,)``.  Attention keeps the
reference's ``(B, H, S, D)`` layout.
"""
from __future__ import annotations

import torch

KINDS = ("exp", "rbf")


def _dot_last(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Sum of ``a * b`` over the last axis, one term at a time from the
    first: the order and roundings of the CUDA kernel's loop."""
    acc = torch.zeros(torch.broadcast_shapes(a.shape[:-1], b.shape[:-1]),
                      dtype=a.dtype, device=a.device)
    for k in range(a.shape[-1]):
        acc = acc + a[..., k] * b[..., k]
    return acc


def sq_dists(xa: torch.Tensor, xb: torch.Tensor) -> torch.Tensor:
    """Pairwise squared distances ``(B,M,D) x (B,N,D) -> (B,M,N)`` by the
    reference's identity ``max(|a|^2 + |b|^2 - 2 a.b, 0)``."""
    na = _dot_last(xa, xa)
    nb = _dot_last(xb, xb)
    ab = _dot_last(xa[:, :, None, :], xb[:, None, :, :])
    return torch.clamp_min(na[:, :, None] + nb[:, None, :] - 2.0 * ab, 0.0)


def _unit_kernel(d2: torch.Tensor, ell: torch.Tensor, kind: str):
    """(k, t): ``exp(-r/ell)`` or ``exp(-d2/(2 ell^2))``, and the factor
    (``r`` or ``d2``) that d/d ell multiplies the kernel by."""
    if kind == "exp":
        r = torch.sqrt(d2 + 1e-12)
        return torch.exp(-r / ell), r
    if kind == "rbf":
        return torch.exp(-0.5 * d2 / (ell * ell)), d2
    raise ValueError(f"unknown kernel kind: {kind!r} (expected one of {KINDS})")


def gram(xa: torch.Tensor, xb: torch.Tensor, lengthscale: torch.Tensor,
         sigma_f: torch.Tensor, kind: str = "exp") -> torch.Tensor:
    """k_h(x, x') of paper Eq. 6 per series: ``sf^2 * exp(-r / ell)``
    (``exp``, the paper's choice) or ``sf^2 * exp(-r^2 / 2 ell^2)``."""
    d2 = sq_dists(xa.float(), xb.float())
    k, _ = _unit_kernel(d2, lengthscale[:, None, None], kind)
    sf = sigma_f[:, None, None]
    return (sf * sf) * k


def gram_bwd(grad: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
             lengthscale: torch.Tensor, sigma_f: torch.Tensor,
             kind: str = "exp") -> tuple[torch.Tensor, torch.Tensor]:
    """Gradient of ``sum(grad * gram(...))`` with respect to the
    per-series ``(lengthscale, sigma_f)``: the analytic form the CUDA
    backward kernel computes, ``d_ell = sum G K r / ell^2`` (exp) or
    ``sum G K d2 / ell^3`` (rbf), and ``d_sf = 2 sf sum G k``."""
    d2 = sq_dists(xa.float(), xb.float())
    ell = lengthscale[:, None, None]
    k, t = _unit_kernel(d2, ell, kind)
    sf = sigma_f[:, None, None]
    gk = grad * k
    l2 = lengthscale * lengthscale
    denom = l2 if kind == "exp" else l2 * lengthscale
    d_ell = (gk * (sf * sf) * t).sum((1, 2)) / denom
    d_sf = 2.0 * sigma_f * gk.sum((1, 2))
    return d_ell, d_sf


# ----------------------------------------------------------------------
# flash_attention — causal/full multi-head attention with GQA
# ----------------------------------------------------------------------

def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """Reference attention.  q: (B,Hq,S,D), k/v: (B,Hkv,T,D) with
    Hq % Hkv == 0 (GQA).  fp32 throughout, ``-inf`` mask, query i at key
    position T-S+i.  Returns (B,Hq,S,D) in q.dtype."""
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if Hq % Hkv:
        raise ValueError(f"Hq={Hq} is not a multiple of Hkv={Hkv}")
    group = Hq // Hkv
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    qf = q.float()
    kf = k.float().repeat_interleave(group, dim=1)
    vf = v.float().repeat_interleave(group, dim=1)
    logits = torch.matmul(qf, kf.transpose(-1, -2)) * sm_scale
    if causal:
        qpos = torch.arange(S, device=q.device)[:, None] + (T - S)
        kpos = torch.arange(T, device=q.device)[None, :]
        logits = logits.masked_fill(kpos > qpos, float("-inf"))
    w = torch.softmax(logits, dim=-1)
    return torch.matmul(w, vf).to(q.dtype)
