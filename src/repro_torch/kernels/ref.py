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

import math

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
# gp_fit_forecast — the GP's evidence loop, fit and horizon per series
# ----------------------------------------------------------------------
#
# ``cfg`` is a ``repro_torch.core.forecast.GPConfig`` (read for ``kernel``,
# ``jitter``, ``opt_steps`` and ``opt_lr``).

ADAM_B1, ADAM_B2, ADAM_EPS = 0.9, 0.999, 1e-8
GP_INIT = (1.0, 1.0, 0.3)   # (ell, sf, sn) before the first Adam step


def adam_bias_corrections(steps: int) -> tuple[list[float], list[float]]:
    """``1 - b**(i+1)`` for i < steps as float32 powers, as the reference
    computes them from its float32 step counter."""
    i = torch.arange(1, steps + 1, dtype=torch.float32)
    return ((1 - torch.tensor(ADAM_B1, dtype=torch.float32) ** i).tolist(),
            (1 - torch.tensor(ADAM_B2, dtype=torch.float32) ** i).tolist())


def cholesky_nan(K: torch.Tensor) -> torch.Tensor:
    """Batched Cholesky factor; NaN where a matrix is not positive
    definite, as ``jnp.linalg.cholesky`` returns (``torch.linalg.cholesky``
    would raise for the whole batch)."""
    L, info = torch.linalg.cholesky_ex(K)
    return L.masked_fill((info > 0)[:, None, None], float("nan"))


def gp_noisy_cholesky(X, row_valid, ell, sf, sn, cfg) -> torch.Tensor:
    """Cholesky factor of ``K(X, X) + diag(noise)``; invalid pattern rows
    are decoupled with noise 1e6 so they carry no information."""
    K = gram(X, X, ell, sf, kind=cfg.kernel)
    noise = torch.where(row_valid, sn[:, None] ** 2 + cfg.jitter, 1e6)
    return cholesky_nan(K + torch.diag_embed(noise))


def gp_neg_log_marginal(log_params: torch.Tensor, X: torch.Tensor,
                        y: torch.Tensor, row_valid: torch.Tensor,
                        cfg) -> torch.Tensor:
    """Per-series negative log marginal likelihood, ``(B,)``."""
    ell, sf, sn = log_params.exp().unbind(1)
    L = gp_noisy_cholesky(X, row_valid, ell, sf, sn, cfg)
    alpha = torch.cholesky_solve(y[:, :, None], L)[:, :, 0]
    n_eff = row_valid.sum(1).to(y.dtype)
    logdet = torch.where(row_valid,
                         torch.log(torch.diagonal(L, dim1=1, dim2=2)), 0.0)
    return ((0.5 * y * alpha).sum(1) + logdet.sum(1)
            + 0.5 * n_eff * math.log(2.0 * math.pi))


def gp_optimize_evidence(X: torch.Tensor, y: torch.Tensor,
                         row_valid: torch.Tensor, cfg) -> torch.Tensor:
    """A fixed Adam loop on the log marginal likelihood, per series:
    log-params ``(B, 3)`` for ``(ell, sf, sn)``, the gradient by autograd.

    As in the reference, a non-finite gradient entry (a non-PD step) is
    zeroed and the log-params are clipped to [-6, 6] after each step."""
    B = X.shape[0]
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    bc1, bc2 = adam_bias_corrections(cfg.opt_steps)
    init = torch.log(torch.tensor(GP_INIT, dtype=torch.float32))
    p = init.to(X.device).expand(B, 3).clone()
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for i in range(cfg.opt_steps):
        lp = p.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = gp_neg_log_marginal(lp, X, y, row_valid, cfg).sum()
            (g,) = torch.autograd.grad(loss, lp)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1[i]
        vh = v / bc2[i]
        p = torch.clamp(p - cfg.opt_lr * mh / (torch.sqrt(vh) + eps), -6.0, 6.0)
    return p


def gp_fit_forecast(X: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                    hist: torch.Tensor, T: int, horizon: int, cfg):
    """Fit the GP of each series and iterate its posterior mean over the
    horizon, in standardized units (the work of the CUDA ``gp_forecast``
    kernel).

    X (B,N,D) patterns, y (B,N) targets, row_valid (B,N), hist (B,D-1)
    the series' last D-1 standardized values, T the window length.
    Returns ``(mean, var, log_params)``: ``(B, horizon)`` each, and the
    fitted ``(B, 3)`` log ``(ell, sf, sn)``."""
    B = X.shape[0]
    log_params = gp_optimize_evidence(X, y, row_valid, cfg)
    ell, sf, sn = log_params.exp().unbind(1)
    L = gp_noisy_cholesky(X, row_valid, ell, sf, sn, cfg)
    alpha = torch.cholesky_solve(y[:, :, None], L)[:, :, 0]

    # iterated k-step-ahead: the predictive mean is fed back into the
    # history; the predictive variance at each step is Eq. 8's
    means, variances = [], []
    for k in range(horizon):
        t_next = torch.full((B, 1), (T + k) / max(T - 1, 1),
                            dtype=torch.float32, device=X.device)
        xs = torch.cat([t_next, hist], dim=1)[:, None, :]
        ks = gram(xs, X, ell, sf, kind=cfg.kernel)[:, 0]
        mean_k = (ks * alpha).sum(1)
        kv = torch.cholesky_solve(ks[:, :, None], L)[:, :, 0]
        var_k = torch.clamp_min(sf ** 2 + sn ** 2 - (ks * kv).sum(1), 1e-9)
        means.append(mean_k)
        variances.append(var_k)
        hist = torch.cat([hist[:, 1:], mean_k[:, None]], dim=1)
    return torch.stack(means, 1), torch.stack(variances, 1), log_params


def gp_evidence_grad(log_params: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                     row_valid: torch.Tensor, cfg) -> torch.Tensor:
    """The gradient of ``gp_neg_log_marginal`` with respect to the
    log-params in the closed form the CUDA kernel computes, ``(B, 3)``.

    With K = L L^T the noisy Gram matrix, alpha = K^-1 y and M the
    diagonal of row_valid, the loss's gradient with respect to K is

        G = 0.5 (L^-T M L^-1 - alpha alpha^T)

    for any mask: the logdet term sums log L_ii over valid rows only, and
    reverse mode through the factor turns d/dL_ii = m_i / L_ii into
    L^-T diag(m / 2) L^-1.  Then, as in ``gram_bwd``, d/d log ell =
    ell sum G sf^2 k t / ell^2 (exp) or / ell^3 (rbf), d/d log sf =
    sf 2 sf sum G k, and d/d log sn = sn 2 sn sum_valid G_ii.  A factor
    that is not positive definite gives NaN, as autograd's does."""
    ell, sf, sn = log_params.exp().unbind(1)
    d2 = sq_dists(X.float(), X.float())
    k, t = _unit_kernel(d2, ell[:, None, None], cfg.kernel)
    s2 = (sf * sf)[:, None, None]
    noise = torch.where(row_valid, sn[:, None] ** 2 + cfg.jitter, 1e6)
    L = cholesky_nan(s2 * k + torch.diag_embed(noise))
    alpha = torch.cholesky_solve(y[:, :, None], L)[:, :, 0]
    eye = torch.eye(X.shape[1], dtype=X.dtype, device=X.device).expand_as(L)
    W = torch.linalg.solve_triangular(L, eye, upper=False)          # L^-1
    m = row_valid.to(X.dtype)
    G = 0.5 * (W.transpose(1, 2) @ (m[:, :, None] * W)
               - alpha[:, :, None] * alpha[:, None, :])
    gk = G * k
    l2 = ell * ell
    denom = l2 if cfg.kernel == "exp" else l2 * ell
    d_ell = (gk * s2 * t).sum((1, 2)) / denom
    d_sf = 2.0 * sf * gk.sum((1, 2))
    d_sn = 2.0 * sn * (torch.diagonal(G, dim1=1, dim2=2) * m).sum(1)
    return torch.stack([d_ell * ell, d_sf * sf, d_sn * sn], 1)


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
