"""Plain PyTorch versions of the port's kernels (counterpart of
``repro.kernels.ref``).

They define what each kernel computes: the CPU path runs them, and the
kernel checks compare the CUDA kernels with them on the card.  The Gram
functions carry an explicit batch of series where the reference used
``vmap``: ``xa (B, M, D)``, ``xb (B, N, D)`` and per-series
``lengthscale`` and ``sigma_f`` of shape ``(B,)``.  Attention keeps the
reference's ``(B, H, S, D)`` layout.  The device engine's sequential
programs (Algorithm 1's pass and the scheduler's event loops) carry a
leading member axis and take CPU tensors only.
"""
from __future__ import annotations

import math

import numpy as np
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


F32_TINY = 2.0**-126   # the least normal float32


def _daz(x: torch.Tensor) -> torch.Tensor:
    """``x`` with every subnormal read as a zero of its sign."""
    return torch.where(x.abs() < F32_TINY, torch.copysign(torch.zeros_like(x), x), x)


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA:CPU's fused
    multiply-add gives it.  ``b`` is a tensor that broadcasts or a Python
    or numpy scalar, taken as float32 (as JAX takes a weakly typed one).

    The float64 product of two float32 values is exact; the float64 sum
    is made round-to-odd (its TwoSum error decides the last bit), and a
    53-bit round-to-odd value rounds to the 24 bits of float32 as the
    exact sum would (53 >= 2 * 24 + 2).

    Subnormals go as on XLA:CPU (x86's flush-to-zero and
    denormals-are-zero): an input below 2**-126 in magnitude is read as a
    zero of its sign, and a result is flushed to a zero of its sign when
    it is tiny after rounding: when the exact value, rounded to float32's
    24 bits as if the exponent had no lower limit, lies below 2**-126.
    So 2**-126 - 2**-150 is flushed, while an exact value a quarter of an
    ulp below 2**-126 rounds up to it and is kept.  Scaling by 2**64
    (exact) brings that rounding into the normal range."""
    a64, c64 = _daz(a).double(), _daz(c).double()
    if isinstance(b, torch.Tensor):
        b64 = _daz(b).double()
    else:
        b64 = float(np.float32(b))
        b64 = math.copysign(0.0, b64) if abs(b64) < F32_TINY else b64
    p = a64 * b64
    s = p + c64
    bp = s - p
    err = (p - (s - bp)) + (c64 - bp)
    inexact = (err != 0) & torch.isfinite(err) & ((s.view(torch.int64) & 1) == 0)
    toward = torch.where(err > 0, math.inf, -math.inf).to(s.dtype)
    s = torch.where(inexact, torch.nextafter(s, toward), s)
    tiny = (s * 2.0**64).float().abs() < F32_TINY * 2.0**64
    return torch.where(tiny, torch.copysign(torch.zeros_like(s), s), s).float()


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


def gp_noisy_factor(K, row_valid, sn, cfg) -> torch.Tensor:
    """Cholesky factor of ``K + diag(noise)``; invalid pattern rows are
    decoupled with noise 1e6 so they carry no information."""
    noise = torch.where(row_valid, sn[:, None] ** 2 + cfg.jitter, 1e6)
    return cholesky_nan(K + torch.diag_embed(noise))


def cholesky_solver(L: torch.Tensor):
    """``b (B, N) -> (L L^T)^-1 b`` by ``torch.cholesky_solve``."""
    return lambda b: torch.cholesky_solve(b[:, :, None], L)[:, :, 0]


def triangular_inverse(L: torch.Tensor) -> torch.Tensor:
    """``L^-1`` of a batch of lower factors, by one triangular solve with
    the identity."""
    eye = torch.eye(L.shape[1], dtype=L.dtype, device=L.device).expand_as(L)
    return torch.linalg.solve_triangular(L, eye, upper=False)


def inverse_solve(b: torch.Tensor, W: torch.Tensor) -> torch.Tensor:
    """``W^T W b`` for ``b (B, N)`` and ``W = L^-1``: ``(L L^T)^-1 b`` by
    two products, each summed along a row.  On the card a row's result
    does not depend on the batch it rides in, which cuBLAS's batched
    triangular solve with one right-hand side does not give."""
    u = (W * b[:, None, :]).sum(2)
    return (W * u[:, :, None]).sum(1)


def inverse_solver(L: torch.Tensor):
    """``b (B, N) -> (L L^T)^-1 b`` by :func:`inverse_solve`."""
    W = triangular_inverse(L)
    return lambda b: inverse_solve(b, W)


def gp_neg_log_marginal(log_params: torch.Tensor, X: torch.Tensor,
                        y: torch.Tensor, row_valid: torch.Tensor,
                        cfg) -> torch.Tensor:
    """Per-series negative log marginal likelihood, ``(B,)``."""
    ell, sf, sn = log_params.exp().unbind(1)
    L = gp_noisy_factor(gram(X, X, ell, sf, kind=cfg.kernel), row_valid, sn, cfg)
    alpha = torch.cholesky_solve(y[:, :, None], L)[:, :, 0]
    n_eff = row_valid.sum(1).to(y.dtype)
    logdet = torch.where(row_valid,
                         torch.log(torch.diagonal(L, dim1=1, dim2=2)), 0.0)
    return ((0.5 * y * alpha).sum(1) + logdet.sum(1)
            + 0.5 * n_eff * math.log(2.0 * math.pi))


def gp_optimize_evidence(X: torch.Tensor, y: torch.Tensor,
                         row_valid: torch.Tensor, cfg) -> torch.Tensor:
    """A fixed Adam loop on the log marginal likelihood, per series:
    log-params ``(B, 3)`` for ``(ell, sf, sn)``, the gradient by autograd
    (``gp_adam``)."""
    def grad(lp):
        lp = lp.detach().requires_grad_(True)
        with torch.enable_grad():
            loss = gp_neg_log_marginal(lp, X, y, row_valid, cfg).sum()
            return torch.autograd.grad(loss, lp)[0]

    return gp_adam(grad, X.shape[0], X.device, cfg)


def gp_adam(grad, B: int, device, cfg) -> torch.Tensor:
    """The reference's fixed Adam loop over ``(B, 3)`` log-params from
    ``GP_INIT``, ``grad(p)`` giving each step's gradient: a non-finite
    entry (a non-PD step) is zeroed and the log-params are clipped to
    [-6, 6] after each step."""
    b1, b2, eps = ADAM_B1, ADAM_B2, ADAM_EPS
    bc1, bc2 = adam_bias_corrections(cfg.opt_steps)
    # filled on the device from float32 values: no copy from the host,
    # which a CUDA graph cannot capture
    p = torch.empty((B, 3), dtype=torch.float32, device=device)
    for j, x in enumerate(torch.log(torch.tensor(GP_INIT, dtype=torch.float32)).tolist()):
        p[:, j] = x
    m = torch.zeros_like(p)
    v = torch.zeros_like(p)
    for i in range(cfg.opt_steps):
        g = grad(p)
        g = torch.where(torch.isfinite(g), g, 0.0)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g * g
        mh = m / bc1[i]
        vh = v / bc2[i]
        p = torch.clamp(p - cfg.opt_lr * mh / (torch.sqrt(vh) + eps), -6.0, 6.0)
    return p


def gp_fit_forecast(X: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                    hist: torch.Tensor, T: int, horizon: int, cfg,
                    ready: torch.Tensor | None = None):
    """Fit the GP of each series and iterate its posterior mean over the
    horizon, in standardized units (the work of the CUDA ``gp_forecast``
    kernel).

    X (B,N,D) patterns, y (B,N) targets, row_valid (B,N), hist (B,D-1)
    the series' last D-1 standardized values, T the window length.
    Returns ``(mean, var, log_params)``: ``(B, horizon)`` each, and the
    fitted ``(B, 3)`` log ``(ell, sf, sn)``.  With ``ready`` (B,) bool
    only the series it marks are computed (sliced out, as rows never
    interact) and the others come back zeros, as the kernel writes them."""
    if ready is not None:
        out = [torch.zeros((X.shape[0], n), dtype=torch.float32, device=X.device)
               for n in (horizon, horizon, 3)]
        if ready.any():
            for o, r in zip(out, gp_fit_forecast(X[ready], y[ready], row_valid[ready],
                                                 hist[ready], T, horizon, cfg)):
                o[ready] = r
        return tuple(out)
    log_params = gp_optimize_evidence(X, y, row_valid, cfg)
    mean, var = gp_fit_horizon(log_params, X, y, row_valid, hist, T, horizon, cfg,
                               gram, cholesky_solver)
    return mean, var, log_params


def gp_fit_horizon(log_params, X, y, row_valid, hist, T: int, horizon: int, cfg,
                   gram_fn, solver):
    """The fit at the fitted ``(B, 3)`` log-params and the iterated
    k-step-ahead forecast: the predictive mean is fed back into the
    history; the predictive variance at each step is Eq. 8's.  ``gram_fn``
    computes the Gram matrices (``gram`` or the dispatching ``ops.gram``),
    ``solver(L)`` gives the solves with the factor L (``cholesky_solver``
    or ``inverse_solver``).  Returns ``(mean, var)``, ``(B, horizon)``
    each."""
    B = X.shape[0]
    ell, sf, sn = log_params.exp().unbind(1)
    solve = solver(gp_noisy_factor(gram_fn(X, X, ell, sf, kind=cfg.kernel), row_valid, sn,
                                   cfg))
    alpha = solve(y)
    means, variances = [], []
    for k in range(horizon):
        t_next = torch.full((B, 1), (T + k) / max(T - 1, 1),
                            dtype=torch.float32, device=X.device)
        xs = torch.cat([t_next, hist], dim=1)[:, None, :]
        ks = gram_fn(xs, X, ell, sf, kind=cfg.kernel)[:, 0]
        mean_k = (ks * alpha).sum(1)
        kv = solve(ks)
        var_k = torch.clamp_min(sf ** 2 + sn ** 2 - (ks * kv).sum(1), 1e-9)
        means.append(mean_k)
        variances.append(var_k)
        hist = torch.cat([hist[:, 1:], mean_k[:, None]], dim=1)
    return torch.stack(means, 1), torch.stack(variances, 1)


def gp_evidence_grad(log_params: torch.Tensor, X: torch.Tensor, y: torch.Tensor,
                     row_valid: torch.Tensor, cfg, gram_fn=None, gram_bwd_fn=None
                     ) -> torch.Tensor:
    """The gradient of ``gp_neg_log_marginal`` with respect to the
    log-params in the closed form the CUDA kernels compute, ``(B, 3)``.

    With K = L L^T the noisy Gram matrix, alpha = K^-1 y and M the
    diagonal of row_valid, the loss's gradient with respect to K is

        G = 0.5 (L^-T M L^-1 - alpha alpha^T)

    for any mask: the logdet term sums log L_ii over valid rows only, and
    reverse mode through the factor turns d/dL_ii = m_i / L_ii into
    L^-T diag(m / 2) L^-1.  Then ``gram_bwd`` gives d/d ell = sum G sf^2
    k t / ell^2 (exp) or / ell^3 (rbf) and d/d sf = 2 sf sum G k, and
    d/d sn = 2 sn sum_valid G_ii; each is multiplied by its parameter for
    the log.  A factor that is not positive definite gives NaN, as
    autograd's does.

    ``gram_fn`` and ``gram_bwd_fn`` (default: this module's plain
    versions) compute the Gram matrix and its ``(ell, sf)`` gradient: the
    GP's Gram route passes the dispatching ``ops.gram`` and
    ``ops.gram_bwd``.  K, the factor, L^-1 and G each live only as long as
    the step needs them."""
    gram_fn = gram if gram_fn is None else gram_fn
    gram_bwd_fn = gram_bwd if gram_bwd_fn is None else gram_bwd_fn
    ell, sf, sn = log_params.exp().unbind(1)
    W = triangular_inverse(gp_noisy_factor(gram_fn(X, X, ell, sf, kind=cfg.kernel),
                                           row_valid, sn, cfg))     # L^-1
    alpha = inverse_solve(y, W)
    m = row_valid.to(X.dtype)
    G = 0.5 * (W.transpose(1, 2) @ (m[:, :, None] * W)
               - alpha[:, :, None] * alpha[:, None, :])
    del W
    d_ell, d_sf = gram_bwd_fn(G, X, X, ell, sf, kind=cfg.kernel)
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


# ----------------------------------------------------------------------
# pessimistic_pass — Algorithm 1's sequential pass; resolve_oom,
# admit_queued, place_missing_elastic — the device engine's event loops
# ----------------------------------------------------------------------
#
# Every tensor carries a leading member axis S and members never
# interact.  These take CPU tensors only: each walks its rows or events
# in Python over numpy copies, in float32.  Sums over more than 32 rows
# are taken in the order XLA:CPU gives the reference's reductions
# (:func:`xla_sum`), and the CUDA kernels take them in the same order.

TREE_WINDOW = 32   # XLA:CPU's tree-reduction window


def xla_sum(x: np.ndarray, *, ftz: bool = False) -> np.ndarray:
    """Float32 sum over axis 0 in the order XLA:CPU reduces it.

    XLA:CPU rewrites a reduction whose reduced dimension exceeds 32 into
    a tree: the dimension is padded to a multiple of 32 (the padding
    split between its two ends, the odd one at the end), each window of
    32 is summed in order, and the window sums are reduced the same way;
    32 or fewer are summed in order.  ``ftz``: each add as
    :func:`add_xla` takes it (subnormals as zeros, x86's NaN), else as
    numpy's float32 add.  Where LLVM vectorised a window's loop across
    the reduced dimension the order differs: the (A, C, 2) tables' sums
    take :func:`xla_table_sum`, the (A, C) tables' :func:`xla_slot_sum`."""
    n = x.shape[0]
    if n <= TREE_WINDOW:
        return _fold(x, ftz)
    padded = -(-n // TREE_WINDOW) * TREE_WINDOW
    lo = (padded - n) // 2
    parts = [_fold(x[max(j - lo, 0):min(j + TREE_WINDOW - lo, n)], ftz)
             for j in range(0, padded, TREE_WINDOW)]
    return xla_sum(np.stack(parts), ftz=ftz)


# The reference's sum of an (A, C) table over both axes
# (``jnp.where(on_h, mem, 0.0).sum()``: the OOM handler's per-host total,
# ``repro/sim/step.py:502``), as XLA:CPU compiles it on x86-64 with
# AVX-512 (read as the (A, C, 2) tables' below, jax 0.9.0; a standalone
# ``jax.jit(lambda u, run, host, h: jnp.where(run & (host == h), u[:, :,
# 1], 0.0).sum())`` compiles to the handler's own kernel).  Over A > 32
# slots the select is a kernel of its own and the sum a reduce-window of
# 32 whole slots over its (A, C) output (padded as xla_sum pads), then a
# reduce of the window sums in order, 0 + w0 + w1 + ...; over A <= 32 one
# reduce, fused with the select, reads the (A, C, 2) usage itself.  A
# window of n slots is summed either serially (0 + each slot's components
# in order) or in VF lanes: lane l starts at 0 (l = 0) or -0 and adds
# slots l, l + VF, ... below nv, each slot's components in order; the
# lanes are reduced in a tree (lane i with i + VF/2, then i + VF/4, ...),
# and slots nv..n-1 are added to it serially.  nv = VF * floor((n - tail)
# / VF): the reduce-window's loads have no gaps (tail 0), except where
# its windows are bounded at run time (A % 32 == 31: windows of 32 and
# one of 31); the fused reduce's loads of the usage's memory half do, at
# C <= 4, unless the loop is unrolled whole (A = VF).  Which, by (A, C)
# (:func:`xla_slot_plan`):
#     C = 1 or C >= 9            serial
#     C in 2..8, A <= 32:  A = 4, 8: VF A;  A = 16..19, 24..27, 32: VF 8;
#                          A = 20..23: VF 4;  A = 28..31: VF 4 (C = 4)
#                          or 8;  other A: serial;  tail 1 at C <= 4
#                          and A > VF
#     C in 2..8, A > 32:   A % 32 == 0: VF 8 (C <= 6) or 4;
#                          A % 32 == 31: VF 8 (C = 2) or 4, tail 1;
#                          other A (a padded window): serial
# The values summed are memory usages, never NaN, so the operand order
# of each add does not show.


def xla_slot_plan(A: int, C: int) -> tuple[int, int]:
    """(VF, tail) of XLA:CPU's kernel for an (A, C) table's sum (see
    above): VF 0 for a serial sum, else the lanes; a window of n slots
    sums ``VF * ((n - tail) // VF)`` of them in the lanes."""
    if not 2 <= C <= 8:
        return 0, 0
    if A > TREE_WINDOW:
        r = A % TREE_WINDOW
        if r == 0:
            return (8 if C <= 6 else 4), 0
        if r == TREE_WINDOW - 1:
            return (8 if C == 2 else 4), 1
        return 0, 0
    if A in (4, 8):
        vf = A
    elif 16 <= A <= 19 or 24 <= A <= 27 or A == TREE_WINDOW:
        vf = 8
    elif 20 <= A <= 23:
        vf = 4
    elif 28 <= A <= 31:
        vf = 4 if C == 4 else 8
    else:
        return 0, 0
    return vf, int(C <= 4 and A > vf)


def _slot_window_sum(x: np.ndarray, vf: int, tail: int) -> np.float32:
    """One window's (n, C) sum as its kernel takes it (:func:`xla_slot_plan`)."""
    n = x.shape[0]
    nv = vf * ((n - tail) // vf) if vf else 0
    acc = np.float32(0.0)
    if nv:
        lanes = np.full(vf, -0.0, np.float32)
        lanes[0] = 0.0
        for j in range(0, nv, vf):
            for c in range(x.shape[1]):
                lanes = lanes + x[j:j + vf, c]
        while len(lanes) > 1:
            lo, hi = np.split(lanes, 2)
            lanes = lo + hi
        acc = lanes[0]
    for v in x[nv:].reshape(-1):
        acc = np.float32(acc + v)
    return acc


def xla_slot_sum(x: np.ndarray) -> np.float32:
    """Float32 sum of an (A, C) table over both axes in the order of
    XLA:CPU's compiled ``x.sum()`` (see above)."""
    x = np.asarray(x, np.float32)
    A = x.shape[0]
    vf, tail = xla_slot_plan(*x.shape)
    if A <= TREE_WINDOW:
        return _slot_window_sum(x, vf, tail)
    padded = -(-A // TREE_WINDOW) * TREE_WINDOW
    lo = (padded - A) // 2
    acc = np.float32(0.0)
    for j in range(0, padded, TREE_WINDOW):
        acc = np.float32(acc + _slot_window_sum(x[max(j - lo, 0):min(j + TREE_WINDOW - lo, A)],
                                                vf, tail))
    return acc


# The reference's sums of an (A, C, 2) slot table over its slots and
# components (``usage.sum((0, 1))``: the rings' usage and shaped-demand
# sums), as XLA:CPU compiles them on x86-64 with AVX-512 (read from the
# dumped program, ``XLA_FLAGS=--xla_dump_to=DIR``: the HLO, each kernel's
# LLVM IR after optimisation and its object file's disassembly; jax
# 0.9.0).  Over A > 32 slots the HLO is a reduce-window of 32 whole slots
# (the slot axis padded to a multiple of 32, the padding split between its
# ends, the odd one at the end) and a reduce of the window sums in order,
# w0 + 0 + w1 + ...; over A <= 32 one reduce.  Each window's kernel sums
# its n slots one of two ways, as LLVM's vectoriser chose for the shape:
#   * serial: 0 + each slot's components in order, the running sum the
#     first operand (a padded window checks each slot's bounds, so its
#     loop is never vectorised);
#   * VF lanes (C of 2, 3 or 4): lane l starts at 0 (l = 0) or -0 and
#     adds slots l, l + VF, ... below nv, each slot's components in order;
#     the lanes are reduced in a tree (lane i with i + VF/2, then i + VF/4,
#     ..., the first operand the higher lane or the lower as the register
#     allocation put it); then slots nv..n-1 are added to the tree's sum
#     serially.  A vectorised loop keeps a scalar epilogue (its
#     interleaved loads have gaps, the other resource), so nv = VF *
#     floor((n - 1) / VF); the fully unrolled n of 2, 4, 8 at C = 2 has
#     none (nv = n).
# Which, by (A, C) (XLA_TABLE_VF):
#     A = C = 1                       no add: the entry itself
#     C = 1 or C >= 5                 serial
#     C in 2..4, A <= 32:  A = 16..19, 24..27, 32: VF 8;  A = 20..23,
#                          28..31: VF 4;  A = 2, 4, 8 at C = 2: VF A,
#                          unrolled;  other A: serial
#     C in 2..4, A > 32:   A % 32 == 0: VF 8;  A % 32 == 31 (windows of 32
#                          and a last of 31): VF 4;  other A: serial
# and the first operand of each lane add, the data (True) or the lane,
# component by component, and of the tree's adds (XLA_LANE_ORDER).  On
# x86 a NaN result is the first operand's NaN where both are NaN
# (:func:`nan_x86`), so these orders decide the payload.
# (first A, last A, VF) of the vectorised A <= 32 at C of 2, 3 and 4
XLA_TABLE_VF = ((16, 19, 8), (20, 23, 4), (24, 27, 8), (28, 31, 4), (32, 32, 8))
# (VF, C): (data first, per component; the tree's higher lane first)
XLA_LANE_ORDER = {(2, 2): ((False, False), False),
                  (8, 2): ((False, False), False), (8, 3): ((True, True, True), True),
                  (8, 4): ((False,) * 4, False), (4, 2): ((False, False), False),
                  (4, 3): ((False, True, False), False),
                  (4, 4): ((True, True, True, False), False)}


def xla_table_plan(A: int, C: int) -> tuple[int, bool]:
    """(VF, unrolled) of XLA:CPU's kernel for an (A, C, 2) table's sum over
    its windows (see above): VF 0 for a serial sum, else the lanes, and
    whether the loop is fully unrolled (no scalar epilogue)."""
    if not 2 <= C <= 4:
        return 0, False
    if A <= TREE_WINDOW:
        if C == 2 and A in (2, 4, 8):
            return A, True
        return next((vf for lo, hi, vf in XLA_TABLE_VF if lo <= A <= hi), 0), False
    return {0: 8, TREE_WINDOW - 1: 4}.get(A % TREE_WINDOW, 0), False


def _window_sum(x: np.ndarray, vf: int, unrolled: bool) -> np.ndarray:
    """One window's (n, C, 2) sum over its slots and components, as its
    kernel takes it (:func:`xla_table_plan`), each add as :func:`add_xla`."""
    n, C = x.shape[:2]
    acc, nv = np.zeros(2, np.float32), 0
    if vf:
        data_first, hi_first = XLA_LANE_ORDER[(vf, C)]
        nv = n if unrolled else (n - 1) // vf * vf
        lanes = np.full((vf, 2), -0.0, np.float32)
        lanes[0] = 0.0
        for j in range(0, nv, vf):
            for c in range(C):
                d = x[j:j + vf, c]
                lanes = add_xla(d, lanes) if data_first[c] else add_xla(lanes, d)
        while len(lanes) > 1:
            lo, hi = np.split(lanes, 2)
            lanes = add_xla(hi, lo) if hi_first else add_xla(lo, hi)
        acc = lanes[0]
    for row in x[nv:].reshape(-1, 2):
        acc = add_xla(acc, row)
    return acc


def xla_table_sum(x: np.ndarray) -> np.ndarray:
    """(2,) float32 sum of an (A, C, 2) table over (A, C) in the order of
    XLA:CPU's compiled ``x.sum((0, 1))`` (see above), with x86's
    denormals-are-zero, flush-to-zero and NaN operands."""
    A, C = x.shape[:2]
    if A * C == 1:                     # XLA drops the reduce: a copy
        return x[0, 0].copy()
    vf, unrolled = xla_table_plan(A, C)
    if A <= TREE_WINDOW:
        return _window_sum(x, vf, unrolled)
    padded = -(-A // TREE_WINDOW) * TREE_WINDOW
    lo = (padded - A) // 2
    sums = [_window_sum(x[max(j - lo, 0):min(j + TREE_WINDOW - lo, A)], vf, unrolled)
            for j in range(0, padded, TREE_WINDOW)]
    acc = add_xla(sums[0], np.float32(0.0))
    for w in sums[1:]:
        acc = add_xla(acc, w)
    return acc


def _fold(x: np.ndarray, ftz: bool) -> np.ndarray:
    """Float32 sum over axis 0 in order, from the first row."""
    if not len(x):
        return np.zeros(x.shape[1:], np.float32)
    if not ftz:
        return np.cumsum(x, axis=0, dtype=np.float32)[-1]
    acc = np.asarray(x[0], np.float32)
    for row in x[1:]:
        acc = add_xla(acc, row)
    return acc


# XLA:CPU's float32 arithmetic, as x86 gives it to the reference's
# compiled tick: denormals-are-zero and flush-to-zero (an operand below
# 2**-126 in magnitude read as a zero of its sign, a result below it
# flushed to one), and a NaN result of an add, a product or a quotient
# the first NaN operand, quieted, or x86's default NaN 0xffc00000 (inf -
# inf, 0 * inf, 0 / 0).  numpy keeps subnormals, and its vectorised
# loops may keep either NaN operand.
DEFAULT_NAN = np.uint32(0xFFC00000).view(np.float32)


def _as_f32(*xs):
    return np.broadcast_arrays(*(np.asarray(x, np.float32) for x in xs))


def ftz(x) -> np.ndarray:
    """``x`` with every subnormal a zero of its sign."""
    x = np.asarray(x, np.float32)
    return np.where(np.abs(x) < np.float32(F32_TINY), np.copysign(np.float32(0.0), x),
                    x).astype(np.float32)


def nan_x86(a, b) -> np.ndarray:
    """The NaN x86 gives for ``a op b`` where the result is a NaN: the
    first NaN operand, quieted, else its default NaN."""
    a, b = _as_f32(a, b)
    quiet = lambda x: (x.view(np.uint32) | np.uint32(0x400000)).view(np.float32)  # noqa: E731
    return np.where(np.isnan(a), quiet(a), np.where(np.isnan(b), quiet(b), DEFAULT_NAN))


def _add_nan_x86(a, b) -> np.ndarray:
    """``a + b`` in float32 with x86's NaN (:func:`nan_x86`), subnormals
    kept: where the reference's compiled tick adds ``b + a``, as XLA:CPU
    emits the update ``scale_sum + sum`` (the sum's NaN where both are)."""
    a, b = _as_f32(a, b)
    with np.errstate(invalid="ignore"):
        r = (a + b).astype(np.float32)
    return np.where(np.isnan(r), nan_x86(a, b), r).astype(np.float32)


def add_xla(a, b) -> np.ndarray:
    """``a + b`` as XLA:CPU adds float32 (a sum below 2**-126 is exact, so
    flushing after rounding is x86's flush)."""
    a, b = _as_f32(a, b)
    with np.errstate(invalid="ignore"):
        r = ftz(ftz(a) + ftz(b))
    return np.where(np.isnan(r), nan_x86(a, b), r).astype(np.float32)


def sub_xla(a, b) -> np.ndarray:
    """``a - b`` as XLA:CPU subtracts float32."""
    a, b = _as_f32(a, b)
    with np.errstate(invalid="ignore"):
        r = ftz(ftz(a) - ftz(b))
    return np.where(np.isnan(r), nan_x86(a, b), r).astype(np.float32)


def mul_xla(a, b) -> np.ndarray:
    """``a * b`` as XLA:CPU multiplies float32: :func:`fma_f32` with an
    addend of -0, which adds nothing to any product (its flush is x86's
    after rounding)."""
    a, b = _as_f32(a, b)
    r = fma_f32(torch.from_numpy(a.copy()), torch.from_numpy(b.copy()),
                torch.full(a.shape, -0.0)).numpy()
    return np.where(np.isnan(r), nan_x86(a, b), r).astype(np.float32)


def div_xla(a, b) -> np.ndarray:
    """``a / b`` as XLA:CPU divides float32: a quotient that rounds below
    2**-126 at float32's 24 bits (found on the quotient scaled by 2**64,
    exact) flushed to a zero of its sign."""
    a, b = _as_f32(a, b)
    a, b = ftz(a), ftz(b)
    with np.errstate(invalid="ignore", divide="ignore", over="ignore"):
        r = (a / b).astype(np.float32)
        scaled = ((a * np.float32(2.0**64)).astype(np.float32) / b).astype(np.float32)
    tiny = (r != 0) & (np.abs(r) <= np.float32(F32_TINY)) & (np.abs(scaled) < np.float32(2.0**-62))
    r = np.where(tiny, np.copysign(np.float32(0.0), scaled), r)
    return np.where(np.isnan(r), nan_x86(a, b), r).astype(np.float32)


def _numpy(*ts):
    return [t.numpy().copy() for t in ts]


def _tensors(*arrays):
    return tuple(torch.from_numpy(a) for a in arrays)


def pessimistic_pass(valid, dem, core, el, host, order, free0):
    """Algorithm 1's greedy pass over the rows of the processing order
    (``repro/core/shaper/pessimistic.py:117-143``).

    valid (S,A) bool: row r holds a running app; dem (S,A,C,2) f32 the
    row's shaped demand by component; core and el (S,A,C) bool its core
    and elastic components; host (S,A,C) int32; order (S,A,C) int32 its
    components oldest-first; free0 (S,H,2) f32 the hosts' capacity.
    Returns remove_pos (S,A) bool (full preemption of row r), kill_pos
    (S,A,C) bool (partial preemption of the row's j-th component in
    ``order``) and the free table (S,H,2) after the pass."""
    valid, dem, core, el, host, order, free = _numpy(valid, dem, core, el, host,
                                                     order, free0)
    S, A, C = core.shape
    remove = np.zeros((S, A), bool)
    kill = np.zeros((S, A, C), bool)
    for s in range(S):
        f = free[s]
        for r in np.flatnonzero(valid[s]):
            # core components (lines 11-19): the app's demand per host,
            # summed in component order, must fit everywhere (< 0 fails)
            core_dem = np.zeros_like(f)
            for c in np.flatnonzero(core[s, r]):
                core_dem[host[s, r, c]] += dem[s, r, c]
            trial = f - core_dem
            if (trial < 0.0).any():
                remove[s, r] = True
                continue
            f[:] = trial
            # elastic components (lines 25-33), oldest first (<= 0 fails)
            for j, c in enumerate(order[s, r]):
                if not el[s, r, c]:
                    continue
                h = host[s, r, c]
                after = f[h] - dem[s, r, c]
                if (after <= 0.0).any():
                    kill[s, r, j] = True
                else:
                    f[h] = after
    return _tensors(remove, kill, free)


def _on_host(run, host, H):
    """(A*C, H) bool: flat row e runs on host h."""
    return run.reshape(-1)[:, None] & (host.reshape(-1)[:, None] == np.arange(H))


def _free_table(run, host, alloc, cap):
    """(H, 2) capacity minus the allocations of running components over
    the flat (slot, component) rows (``repro/sim/step.py:_free_resources``)."""
    on = _on_host(run, host, cap.shape[0])
    return cap - xla_sum(np.where(on[:, :, None], alloc.reshape(-1, 1, 2), 0.0
                                  ).astype(np.float32))


def _worst_fit(free, cpu, mem) -> int:
    """The fitting host with the most free memory, the lowest index on
    ties; -1 when none fits (``repro/sim/step.py:_worst_fit``)."""
    ok = (free[:, 0] >= cpu) & (free[:, 1] >= mem)
    if not ok.any():
        return -1
    return int(np.argmax(np.where(ok, free[:, 1], -np.inf)))


def resolve_oom(slot_gid, work_done, comp_running, comp_host, alloc, usage,
                failed, queued, oom_kills, failure_events, partial_preemptions,
                is_core, host_cap):
    """The OS OOM handler (``repro/sim/step.py:472``).  For each host
    whose running components' memory usage exceeds capacity + 1e-6 at
    entry, kill the component of largest ``usage - alloc`` overage (the
    largest flat (slot, comp) index on ties) until the host fits.  A core
    victim fails its whole app (evicted, marked failed and requeued); an
    elastic victim is a partial preemption.  The entry totals are column
    sums in XLA's tree of 32-row windows (:func:`xla_sum`), the loop's
    total the (A, C) table's compiled order (:func:`xla_slot_sum`).

    Slot-table tensors are (S,A[,C[,2]]); failed and queued (S,N) bool;
    the three counters (S,) int32; is_core the trace's (S,N,C); host_cap
    (H,2).  Returns the updated slot_gid, work_done, comp_running, alloc,
    usage, failed, queued, the three counters and the monitor rows to
    reset (S,A*C) bool."""
    (slot_gid, work_done, run, host, alloc, usage, failed, queued, oom, fail, part,
     is_core, cap) = _numpy(slot_gid, work_done, comp_running, comp_host, alloc,
                            usage, failed, queued, oom_kills, failure_events,
                            partial_preemptions, is_core, host_cap)
    S, A, C = run.shape
    lim = cap[:, 1] + np.float32(1e-6)
    monreset = np.zeros((S, A * C), bool)
    for s in range(S):
        mem = usage[s, :, :, 1]                 # a view: kills zero it
        on = _on_host(run[s], host[s], len(lim))
        tot0 = xla_sum(np.where(on, mem.reshape(-1, 1), 0.0).astype(np.float32))
        for h in np.flatnonzero(tot0 > lim):
            while True:
                on_h = run[s] & (host[s] == h)
                if not on_h.any():
                    break
                tot = xla_slot_sum(np.where(on_h, mem, 0.0))
                if not tot > lim[h]:
                    break
                over = np.where(on_h, mem - alloc[s, :, :, 1], -np.inf).reshape(-1)
                vic = A * C - 1 - int(np.argmax(over[::-1] == over.max()))
                a, c = divmod(vic, C)
                g = slot_gid[s, a]
                if is_core[s, g, c]:
                    usage[s, a] = 0.0
                    run[s, a] = False
                    alloc[s, a] = 0.0
                    slot_gid[s, a] = -1
                    work_done[s, a] = 0.0
                    failed[s, g] = queued[s, g] = True
                    oom[s] += 1
                    fail[s] += 1
                else:
                    usage[s, a, c] = 0.0
                    run[s, a, c] = False
                    alloc[s, a, c] = 0.0
                    monreset[s, vic] = True
                    part[s] += 1
    return _tensors(slot_gid, work_done, run, alloc, usage, failed, queued,
                    oom, fail, part, monreset)


def _try_place(free, cpu, mem, exists, is_core):
    """Worst-fit placement of one app's components: every core component
    must fit (else the app is refused), then elastic ones best-effort
    (``repro/sim/step.py:_admit_queued.try_place``).  Updates ``free``;
    returns (admitted, host per component or -1)."""
    placement = np.full(cpu.shape, -1, np.int32)
    for core_pass in (True, False):
        for c in np.flatnonzero(exists & (is_core == core_pass)):
            h = _worst_fit(free, cpu[c], mem[c])
            if h < 0:
                if core_pass:
                    return False, placement
                continue
            placement[c] = h
            free[h, 0] -= cpu[c]
            free[h, 1] -= mem[c]
    return True, placement


def admit_queued(submit, gid, cpu_req, mem_req, exists, is_core, slot_gid,
                 work_done, comp_running, comp_host, alloc, alive_since, queued,
                 has_saved, saved_work, t, host_cap, resume: bool, tenant=None, elig=None,
                 admitted=None):
    """FIFO admission (``repro/sim/step.py:554``): while an app is queued
    and a slot is empty, place the head (least submit, then least gid)
    into the first empty slot if all its core components fit; stop at the
    first head that does not.  ``resume`` (``work_lost_on_kill=False``)
    restarts an app from its saved work.

    The trace columns are (S,N[,C]); t (S,) f32; host_cap (H,2).  Returns
    the updated slot_gid, work_done, comp_running, comp_host, alloc,
    alive_since, queued, has_saved and the monitor rows to reset (S,A*C).

    With the control plane's gate (``tenant`` (S,N) int32, ``elig`` (S,T)
    bool and ``admitted`` (S,T) int32, else all None) only the apps of
    eligible tenants are heads, the others stay queued, and each admitted
    app adds one to its tenant's ``admitted``, returned last."""
    (submit, gid, cpu_req, mem_req, exists, is_core, slot_gid, work_done, run, host,
     alloc, alive, queued, has_saved, saved_work, t, cap) = _numpy(
        submit, gid, cpu_req, mem_req, exists, is_core, slot_gid, work_done,
        comp_running, comp_host, alloc, alive_since, queued, has_saved, saved_work,
        t, host_cap)
    S, A, C = run.shape
    resets = np.zeros((S, A, C), bool)
    gated = tenant is not None
    if gated:
        tenant, elig, admitted = _numpy(tenant, elig, admitted)
    for s in range(S):
        ok_app = (elig[s][np.clip(tenant[s], 0, elig.shape[1] - 1)] if gated
                  else np.ones(queued.shape[1], bool))
        while (queued[s] & ok_app).any() and (slot_gid[s] < 0).any():
            q = np.flatnonzero(queued[s] & ok_app)
            tied = q[submit[s, q] == submit[s, q].min()]
            head = tied[np.argmin(gid[s, tied])]
            slot = np.flatnonzero(slot_gid[s] < 0)[0]
            free = _free_table(run[s], host[s], alloc[s], cap)
            ok, placement = _try_place(free, cpu_req[s, head], mem_req[s, head],
                                       exists[s, head], is_core[s, head])
            if not ok:
                break
            placed = placement >= 0
            slot_gid[s, slot] = head
            work_done[s, slot] = (saved_work[s, head] if resume and has_saved[s, head]
                                  else 0.0)
            run[s, slot] = placed
            host[s, slot] = np.maximum(placement, 0)
            alloc[s, slot, :, 0] = np.where(placed, cpu_req[s, head], 0.0)
            alloc[s, slot, :, 1] = np.where(placed, mem_req[s, head], 0.0)
            alive[s, slot] = t[s]
            queued[s, head] = has_saved[s, head] = False
            resets[s, slot] = True
            if gated and 0 <= tenant[s, head] < admitted.shape[1]:
                admitted[s, tenant[s, head]] += 1
    out = _tensors(slot_gid, work_done, run, host, alloc, alive, queued, has_saved,
                   resets.reshape(S, A * C))
    return out + _tensors(admitted) if gated else out


def place_missing_elastic(cpu_req, mem_req, exists, is_core, slot_gid, comp_running,
                          comp_host, alloc, alive_since, t, host_cap):
    """Best-effort re-placement of the running apps' missing elastic
    components at their reservation, in row-major (slot, component) order
    over the entry snapshot, each by worst fit
    (``repro/sim/step.py:670``).  Returns the updated comp_running,
    comp_host, alloc and alive_since."""
    (cpu_req, mem_req, exists, is_core, slot_gid, run, host, alloc, alive, t,
     cap) = _numpy(cpu_req, mem_req, exists, is_core, slot_gid, comp_running,
                   comp_host, alloc, alive_since, t, host_cap)
    for s in range(run.shape[0]):
        g = np.maximum(slot_gid[s], 0)
        missing = ((slot_gid[s] >= 0)[:, None] & exists[s, g] & ~is_core[s, g]
                   & ~run[s])
        if not missing.any():
            continue
        free = _free_table(run[s], host[s], alloc[s], cap)
        for a, c in zip(*np.nonzero(missing)):
            cpu, mem = cpu_req[s, g[a], c], mem_req[s, g[a], c]
            h = _worst_fit(free, cpu, mem)
            if h < 0:
                continue
            free[h, 0] -= cpu
            free[h, 1] -= mem
            run[s, a, c] = True
            host[s, a, c] = h
            alloc[s, a, c] = (cpu, mem)
            alive[s, a, c] = t[s]
    return _tensors(run, host, alloc, alive)


def leap_skip(slot_gid, queued, arrived, submit, done, t, left, tick, calib_left=None):
    """The run of provably idle ticks before each member's next real tick
    (the scalar ``lax.while_loop`` of ``repro/sim/step.py:955-970``).

    A member is idle when some app is not done, its budget ``left`` is
    positive, no slot holds an app, the queue is empty and, where
    ``calib_left`` (S, R) int32 (the calibration state's ticks to each
    pending score) is given, no score is pending; then, while
    fewer than ``left`` ticks were skipped and the next arrival lies
    beyond ``t + tick`` (rounded once to float32, compared in float32),
    the clock advances one tick.  slot_gid (S,A) int32; queued, arrived,
    done (S,N) bool; submit (S,N) f32; t (S,) f32; left (S,) int32; tick
    a float taken as float32.  Returns ``(t, lead)``: the new clock and
    the ticks skipped, ``(S,)`` each."""
    slot_gid, queued, arrived, submit, done, t, left = _numpy(
        slot_gid, queued, arrived, submit, done, t, left)
    idle = (~done.all(-1) & (left > 0) & (slot_gid < 0).all(-1) & ~queued.any(-1))
    if calib_left is not None:
        idle &= (calib_left.numpy() == 0).all(-1)
    next_sub = np.where(arrived, np.float32(np.inf), submit).min(-1)
    tick = np.float32(tick)
    lead = np.zeros_like(left)
    for s in np.nonzero(idle)[0]:
        tc, n = t[s], 0
        while n < left[s] and next_sub[s] > tc + tick:
            tc += tick
            n += 1
        t[s], lead[s] = tc, n
    return _tensors(t, lead)


# ----------------------------------------------------------------------
# ARIMA (paper §3.1.1): the work of the CUDA arima_forecast kernel.  Every
# float32 operation below is one IEEE operation in the order the kernel
# performs it (sums one term at a time from 0, products and sums rounded
# separately, square roots and logarithms correctly rounded through
# float64), so the kernel gives these bits.
# ----------------------------------------------------------------------

ARIMA_RIDGE = 1e-4


def _f32(x: float) -> float:
    return float(np.float32(x))


def _seq_sum(x: torch.Tensor) -> torch.Tensor:
    """Sum over the last axis from 0, one term at a time."""
    acc = torch.zeros(x.shape[:-1], dtype=x.dtype, device=x.device)
    for k in range(x.shape[-1]):
        acc = acc + x[..., k]
    return acc


def _lags(z: torch.Tensor, k: int) -> torch.Tensor:
    """(..., T, k): column j is z lagged by j + 1, zeros before the start."""
    T = z.shape[-1]
    if k == 0:
        return z.new_zeros(z.shape + (0,))
    zp = torch.cat([torch.zeros(z.shape[:-1] + (k,), dtype=z.dtype, device=z.device), z], -1)
    return torch.stack([zp[..., k - 1 - j:k - 1 - j + T] for j in range(k)], -1)


def _masked_lstsq(A: torch.Tensor, z: torch.Tensor, rows: torch.Tensor,
                  cols: torch.Tensor) -> torch.Tensor:
    """The reference's ridge-regularised masked least squares
    (``repro/core/forecast/arima.py:51``): A (..., T, n), z and rows
    (..., T), cols (..., n) float 1/0.  The normal equations are summed
    row by row, excluded columns pinned to beta = 0 by identity rows, and
    solved by LU with partial pivoting (the first largest pivot)."""
    n = A.shape[-1]
    Aw = A * cols[..., None, :]
    G = torch.zeros(A.shape[:-2] + (n, n), dtype=A.dtype, device=A.device)
    b = torch.zeros(A.shape[:-2] + (n,), dtype=A.dtype, device=A.device)
    for t in range(A.shape[-2]):
        a, r = Aw[..., t, :], rows[..., t]
        G = torch.where(r[..., None, None], G + a[..., :, None] * a[..., None, :], G)
        b = torch.where(r[..., None], b + a * z[..., t, None], b)
    eye = torch.eye(n, dtype=A.dtype, device=A.device)
    G = G + eye * _f32(ARIMA_RIDGE)
    both = (cols[..., :, None] * cols[..., None, :]) > 0
    G = torch.where(both, G, eye)
    return _lu_solve(G, b) * cols


def _lu_solve(G: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Solve G x = b over the leading axes: LU with partial pivoting (the
    first row of largest magnitude), then back substitution."""
    G, b = G.clone(), b.clone()
    n = G.shape[-1]
    rows = torch.arange(n, device=G.device).expand(b.shape).contiguous()
    for k in range(n):
        piv = G[..., k:, k].abs().argmax(-1, keepdim=True) + k
        perm = rows.clone()
        perm[..., k] = piv[..., 0]
        perm.scatter_(-1, piv, k)
        G = torch.gather(G, -2, perm[..., None].expand_as(G))
        b = torch.gather(b, -1, perm)
        lk = G[..., k + 1:, k] / G[..., k:k + 1, k]
        G[..., k + 1:, k + 1:] = G[..., k + 1:, k + 1:] - lk[..., None] * G[..., k:k + 1, k + 1:]
        b[..., k + 1:] = b[..., k + 1:] - lk * b[..., k:k + 1]
    x = torch.zeros_like(b)
    for i in reversed(range(n)):
        acc = b[..., i]
        for j in range(i + 1, n):
            acc = acc - G[..., i, j] * x[..., j]
        x[..., i] = acc / G[..., i, i]
    return x


def arima_select(windows: torch.Tensor, valid: torch.Tensor, horizon: int, cfg):
    """ARIMA forecasts of ``(B, T)`` windows (oldest first), the
    reference's function (``repro/core/forecast/arima.py:140-212``) over
    rows and candidate orders at once: scale-normalise; for each (p, d, q)
    (d, then p, then q; p + q > 0) fit ARMA(p, q) to the d-times differenced
    series by Hannan-Rissanen (a long AR(``long_ar``) fit for innovation
    estimates, then p lags of the series and q of the innovations; both
    by :func:`_masked_lstsq`); score it by AIC; forecast the first
    minimum's k-step recursion with its psi-weight variance (integrated
    when d = 1); fall back to the last value with variance
    ``(0.5 |last| + 1)^2`` when fewer than ``long_ar + max_p + 2``
    samples are valid; clamp the variance at 1e-9.

    Returns ``(mean, var, best, aic)``: ``(B, horizon)`` twice, the chosen
    candidate's index ``(B,)`` and every candidate's AIC ``(B, K)``
    (non-finite ones as +inf)."""
    P, Q, M, D1 = cfg.max_p, cfg.max_q, cfg.long_ar, cfg.max_d + 1
    x = windows.float()
    B, T = x.shape
    dev = x.device
    w = valid.float()
    cnt = _seq_sum(w)
    den = torch.clamp_min(cnt, 1.0)
    mu = _seq_sum(x * w) / den
    dv = x - mu[:, None]
    var0 = _seq_sum(dv * dv * w) / den
    sd = torch.sqrt(torch.clamp_min(var0, _f32(1e-8)).double()).float()
    y = (x - mu[:, None]) / sd[:, None]

    # the series and its sample mask for each d: (B, D1, T)
    diff = torch.cat([torch.zeros_like(y[:, :1]), y[:, 1:] - y[:, :-1]], 1)
    Z = torch.stack([y, diff][:D1], 1)
    vm = torch.cat([torch.zeros_like(valid[:, :1]), valid[:, 1:] & valid[:, :-1]], 1)
    ZM = torch.stack([valid, vm][:D1], 1)
    t_idx = torch.arange(T, device=dev)

    # stage 1: long AR(M) on each differenced series
    ones = torch.ones_like(Z)[..., None]
    A1 = torch.cat([ones, _lags(Z, M)], -1)
    rows1 = ZM & (t_idx >= M)
    beta1 = _masked_lstsq(A1, Z, rows1, torch.ones(M + 1, device=dev))
    E = torch.where(rows1, Z - _dot_last(A1, beta1[..., None, :]), 0.0)

    # stage 2 per candidate: (B, K, ...)
    cands = [(p, d, q) for d in range(D1) for p in range(P + 1) for q in range(Q + 1)
             if p + q > 0]
    K = len(cands)
    cd = torch.tensor([c[1] for c in cands], device=dev)
    cp = torch.tensor([c[0] for c in cands], device=dev)
    cq = torch.tensor([c[2] for c in cands], device=dev)
    pmask = (torch.arange(P, device=dev) < cp[:, None]).float()          # (K, P)
    qmask = (torch.arange(Q, device=dev) < cq[:, None]).float()          # (K, Q)
    cols = torch.cat([torch.ones(K, 1, device=dev), pmask, qmask], 1)   # (K, n2)
    z, zm = Z[:, cd], ZM[:, cd]                                         # (B, K, T)
    e, r1 = E[:, cd], rows1[:, cd]
    need = ((cp == P) & (cq == Q))[:, None] & (t_idx >= P) & (t_idx >= Q)  # (K, T)
    e_rows = torch.roll(r1, 1, -1)
    rows2 = zm & need & torch.where((cq > 0)[:, None], e_rows, True)
    A2 = torch.cat([torch.ones_like(z)[..., None], _lags(z, P), _lags(e, Q)], -1)
    beta2 = _masked_lstsq(A2, z, rows2, cols.expand(B, K, -1))
    resid = torch.where(rows2, z - _dot_last(A2, beta2[..., None, :]), 0.0)
    n_eff = torch.clamp_min(rows2.sum(-1).float(), 1.0)
    sig2 = torch.clamp_min(_seq_sum(resid * resid) / n_eff, _f32(1e-10))
    pen = torch.tensor([_f32(2.0 * (p + q + 2)) for p, _, q in cands], device=dev)
    aic = n_eff * torch.log(sig2.double()).float() + pen
    aic = torch.where(torch.isfinite(aic), aic, torch.inf)
    best = torch.argmin(aic, -1)                                        # (B,)

    def pick(v):
        return torch.take_along_dim(v, best.view(B, *(1,) * (v.dim() - 1)), 1)[:, 0]

    d, bz, bres, bsig = cd[best], pick(z), pick(resid), pick(sig2)
    delta, phi, theta = (pick(beta2)[:, sl] for sl in (0, slice(1, 1 + P), slice(1 + P, None)))
    zl = [bz[:, T - 1 - i] if T - 1 - i >= 0 else torch.zeros_like(delta) for i in range(P)]
    el = [bres[:, T - 1 - i] if T - 1 - i >= 0 else torch.zeros_like(delta) for i in range(Q)]
    zero = torch.zeros_like(delta)
    csum, means = zero, []
    for _ in range(horizon):
        s1, s2 = zero, zero
        for i in range(P):
            s1 = s1 + phi[:, i] * zl[i]
        for i in range(Q):
            s2 = s2 + theta[:, i] * el[i]
        zt = (delta + s1) + s2
        zl, el = [zt] + zl[:-1], [zero] + el[:-1]
        csum = csum + zt
        means.append(torch.where(d > 0, y[:, T - 1] + csum, zt))
    psi = [torch.ones_like(delta)]
    for j in range(1, horizon):
        s = zero
        for i in range(P):
            s = s + phi[:, i] * (psi[j - 1 - i] if j - 1 - i >= 0 else zero)
        psi.append((theta[:, j - 1] if j <= Q else zero) + s)
    ipsi, c, cs2, variances = [], zero, zero, []
    for j in range(horizon):
        c = c + psi[j]
        pj = torch.where(d > 0, c, psi[j])
        cs2 = cs2 + pj * pj
        variances.append(bsig * cs2)
    mean = torch.stack(means, 1) * sd[:, None] + mu[:, None]
    var = torch.stack(variances, 1) * (sd * sd)[:, None]
    enough = (cnt >= float(M + P + 2))[:, None]
    last = x[:, T - 1:]
    u = 0.5 * torch.abs(last) + 1.0
    mean = torch.where(enough, mean, last)
    var = torch.where(enough, var, u * u)
    var = torch.maximum(var, torch.tensor(_f32(1e-9), device=dev))
    return mean, var, best, aic


def arima_forecast(windows: torch.Tensor, valid: torch.Tensor, horizon: int, cfg,
                   ready: torch.Tensor | None = None):
    """``(mean, var)``, ``(B, horizon)`` each: :func:`arima_select`'s
    forecasts.  With ``ready`` (B,) bool only the series it marks are
    computed (sliced out, as rows never interact) and the others come
    back zeros, as the kernel writes them."""
    if ready is None:
        return arima_select(windows, valid, horizon, cfg)[:2]
    out = [torch.zeros((windows.shape[0], horizon), dtype=torch.float32,
                       device=windows.device) for _ in range(2)]
    if ready.any():
        for o, r in zip(out, arima_select(windows[ready], valid[ready], horizon, cfg)[:2]):
            o[ready] = r
    return tuple(out)


# ----------------------------------------------------------------------
# conformal calibration: the work of the CUDA kernels in calib.cu
# ----------------------------------------------------------------------

def fmax(a, b) -> np.ndarray:
    """Float32 max as the reference's compiled tick takes it (a select, so
    no NaN is quieted): a NaN operand, the first where both are and its
    sign bit is set, else the second; +0 above -0 (numpy's maximum keeps
    its first NaN and its second of two zeros)."""
    a, b = _as_f32(a, b)
    zeros = (a == 0) & (b == 0)
    signed = np.where(np.signbit(a) & np.signbit(b), np.float32(-0.0), np.float32(0.0))
    both = np.isnan(a) & np.isnan(b)
    with np.errstate(invalid="ignore"):
        out = np.where(zeros, signed, np.maximum(a, b))
    out = np.where(np.isnan(b), b, out)
    return np.where(np.isnan(a) & (~np.isnan(b) | np.signbit(a)), a, out).astype(np.float32)


def sort_keys(x: np.ndarray) -> np.ndarray:
    """uint32 keys that order float32 values as ``jnp.sort`` does: -0 and
    +0 equal, every NaN equal and after +inf (ties then keep their
    positions, the sort being stable)."""
    u = np.where(x == 0, np.uint32(0), np.asarray(x, np.float32).view(np.uint32))
    key = np.where(u & np.uint32(0x80000000), ~u, u | np.uint32(0x80000000))
    return np.where(np.isnan(x), np.uint32(0xFFFFFFFF), key).astype(np.uint32)


def conformal_scale(scores, counts, q, fallback, rolled: bool):
    """The conformal quantile of each score ring
    (``repro/core/uncertainty/conformal.py:83,113``).

    scores (B, cap) f32; counts (B,) int32, the scores ever pushed; q and
    fallback (G,) f32, row r taking entry ``r // (B / G)``.  Of the
    ``n = min(count, cap)`` live cells (rolled: the last n, the others
    read as +inf; circular: every cell, the unwritten ones +inf) returns
    the one at position ``k = ceil((n + 1) q) - 1`` (in float32, clipped
    to ``[0, n - 1]``) of the stable sort by :func:`sort_keys`, its own
    bits; ``fallback`` where n = 0.  Returns (B,) f32."""
    s, c, q, fb = _numpy(scores, counts, q, fallback)
    B, cap = s.shape
    per = B // q.shape[0]
    n = np.minimum(c, cap).astype(np.int32)
    if rolled:
        s = np.where(np.arange(cap)[None, :] < (cap - n)[:, None], np.float32(np.inf), s)
    order = np.argsort(sort_keys(s), axis=1, kind="stable")
    qr, fbr = np.repeat(q, per), np.repeat(fb, per)
    k = np.ceil((n.astype(np.float32) + np.float32(1.0)) * qr).astype(np.int32) - 1
    k = np.minimum(np.maximum(k, 0), np.maximum(n - 1, 0))
    rows = np.arange(B)
    val = s[rows, order[rows, k]] if cap else np.zeros(B, np.float32)
    return torch.from_numpy(np.where(n > 0, val, fbr).astype(np.float32))


def _tiled(x: np.ndarray) -> np.ndarray:
    """(S, M) per monitor row -> (S, 2M) per series row (cpu, then mem)."""
    return np.concatenate([x, x], -1)


def calib_observe(ring, ring_count, pool, pool_count, mean, sigma, scale, peak, left,
                  due, q, resolved, errors, dropped, usage, mon_count, active, groups=None, *,
                  pool_on: bool, adaptive: bool, gamma: float, budget: float,
                  q_min: float, q_max: float):
    """One tick of the outstanding predictions of each member
    (``repro/core/uncertainty/online.py:317``, ``calib_observe``).

    The calibration state as ``CalibState`` holds it, S members of R =
    2M series rows; usage (S, M, 2) f32 and mon_count (S, M) int32 per
    monitor row (series r < M reads its cpu, M + r its mem); active (S,)
    bool.  Rows age where active and a prediction is pending; a row whose
    prediction comes due scores ``(peak - mean) / max(sigma, 1e-6)`` into
    its ring at ``count % cap`` if its monitor count is the one due, else
    counts as dropped; the member's scores enter its pool in row order at
    ``pool_count + k``, only the last ``pool_cap`` of them when more
    resolve.  A score is miscovered when ``peak > fma(scale, sigma,
    mean)``; adaptive, ``q`` becomes ``clip(fma(gamma, err_rate - budget,
    q), q_min, q_max)`` where any resolved.  Returns (ring, ring_count,
    pool, pool_count, peak, left, q, resolved, errors, dropped).

    ``groups``, the per-tenant tier (``online.py:375-413``), is None or
    (group_ring (S, G, gcap) f32, group_count (S, G) int32, group (S, R)
    int32 each row's group at deploy or -1, group_resolved, group_errors
    (S, G) int32): each resolved row of a group also scores into its
    group's ring, the group's scores of the tick in row order at
    ``group_count + k``, the last ``gcap`` of them when more resolve; the
    results then add (group_ring, group_count, group_resolved,
    group_errors, and the tick's resolved and missed scores per group, (S,
    G) int32 each)."""
    (ring, ring_count, pool, pool_count, mean, sigma, scale, peak, left, due, q, resolved,
     errors, dropped, usage, mon_count, active) = _numpy(
        ring, ring_count, pool, pool_count, mean, sigma, scale, peak, left, due, q,
        resolved, errors, dropped, usage, mon_count, active)
    cap, pcap = ring.shape[2], pool.shape[1]
    use = np.concatenate([usage[..., 0], usage[..., 1]], -1)
    act = (left > 0) & active[:, None]
    peak = np.where(act, fmax(peak, use), peak)
    left = (left - act).astype(np.int32)
    fire = act & (left == 0)
    ok = fire & (_tiled(mon_count) == due)
    dropped = (dropped + (fire & ~ok).sum(-1)).astype(np.int32)
    s = ((peak - mean) / fmax(sigma, np.float32(1e-6))).astype(np.float32)
    n_ok = ok.sum(-1).astype(np.int32)
    for m in range(ring.shape[0]):
        rows = np.nonzero(ok[m])[0]
        ring[m, rows, ring_count[m, rows] % cap] = s[m, rows]
        if pool_on:
            k = np.arange(rows.size)
            w = k >= rows.size - pcap
            pool[m, (pool_count[m] + k[w]) % pcap] = s[m, rows[w]]
    ring_count = (ring_count + ok).astype(np.int32)
    if pool_on:
        pool_count = (pool_count + n_ok).astype(np.int32)
    bound = fma_f32(*_tensors(scale, sigma, mean)).numpy()
    err = ok & (peak > bound)
    resolved = (resolved + n_ok).astype(np.int32)
    errors = (errors + err.sum(-1)).astype(np.int32)
    if adaptive:
        rate = err.sum(-1).astype(np.float32) / np.maximum(n_ok, 1).astype(np.float32)
        step = fma_f32(torch.from_numpy(rate - np.float32(budget)), gamma,
                       torch.from_numpy(q)).numpy()
        qn = np.minimum(np.maximum(step, np.float32(q_min)), np.float32(q_max))
        q = np.where(n_ok > 0, qn, q).astype(np.float32)
    out = _tensors(ring, ring_count, pool, pool_count, peak, left, q, resolved, errors,
                   dropped)
    if groups is None:
        return out
    gring, gcount, group, gres, gerr = _numpy(*groups)
    S, G, gcap = gring.shape
    d_res = np.zeros((S, G), np.int32)
    d_err = np.zeros((S, G), np.int32)
    for m in range(S):
        for g in range(G):
            rows = np.nonzero(ok[m] & (group[m] == g))[0]
            k = np.arange(rows.size)
            w = k >= rows.size - gcap
            gring[m, g, (gcount[m, g] + k[w]) % gcap] = s[m, rows[w]]
            d_res[m, g] = rows.size
            d_err[m, g] = err[m, rows].sum()
    return out + _tensors(gring, (gcount + d_res).astype(np.int32),
                          (gres + d_res).astype(np.int32), (gerr + d_err).astype(np.int32),
                          d_res, d_err)


def row_groups(slot_gid, tenant, C: int):
    """(S, 2*A*C) int32: the tenant id of the app in each series row's slot
    (rows r and A*C + r are slot ``r // C``'s), -1 for an empty slot.  The
    id is kept as the trace holds it, as the reference's rows record it:
    where a tenant's quantile or group ring is read, an id of T or more
    reads tenant T - 1's (the reference's gathers clamp it), a negative
    one none."""
    slot_gid, tenant = _numpy(slot_gid, tenant)
    ten = np.where(slot_gid >= 0,
                   np.take_along_axis(tenant, np.maximum(slot_gid, 0), 1), -1)
    rows = np.repeat(ten, C, axis=1)
    return np.concatenate([rows, rows], 1).astype(np.int32)


def credit_quantiles(credit, q, *, spread: float, q_min: float, q_max: float):
    """(S, T) f32 per-tenant target quantiles ``clip(fma(spread, 1 - 2 *
    credit, q), q_min, q_max)`` of the credit (S, T) and the members' q
    (S,) (``repro/control/credit.py:46``; XLA contracts it, and ``2 *
    credit`` is exact)."""
    credit, q = _numpy(credit, q)
    lin = (np.float32(1.0) - np.float32(2.0) * credit).astype(np.float32)
    step = fma_f32(torch.from_numpy(lin), spread,
                   torch.from_numpy(np.broadcast_to(q[:, None], credit.shape).copy())).numpy()
    return np.minimum(np.maximum(step, np.float32(q_min)), np.float32(q_max))


def calib_quantiles(ring, ring_count, pool, pool_count, q, fallback, tenancy=None, *,
                    min_scores: int, pool_on: bool):
    """The quantiles the engine's shaping step reads (``online.py:447``):
    each series row's of its circular ring and each member's of its pool
    (where ``pool_on``), at the member's q, ``fallback`` (K2) where a ring
    is empty.  The kernel ranks only the rows holding ``min_scores``
    scores, the others unread; here every row is computed.  Returns (raw
    (S, R), raw_pool (S,)).

    ``tenancy``, the per-tenant tier, is None or (credit (S, T) f32 or
    None, tenant (S, N) int32, slot_gid (S, A) int32, group_ring (S, T,
    gcap), group_count (S, T), spread, q_min, q_max): with a credit, each
    tenant's q is :func:`credit_quantiles`' and a series row of a
    tenant's slot (:func:`row_groups`) takes its tenant's; the group
    rings' quantiles at their tenant's q are returned third, (S, T)."""
    ring, ring_count, pool, pool_count, q = _numpy(ring, ring_count, pool, pool_count, q)
    S, R, cap = ring.shape
    fb = np.full(S, np.float32(fallback))
    q_rows = np.repeat(q, R)
    if tenancy is not None:
        credit, tenant, slot_gid, gring, gcount, spread, q_min, q_max = tenancy
        T = gring.shape[1]
        qt = (np.repeat(q, T).reshape(S, T) if credit is None
              else credit_quantiles(credit, torch.from_numpy(q), spread=spread, q_min=q_min,
                                    q_max=q_max))
        if credit is not None:
            grp = row_groups(slot_gid, tenant, ring_count.shape[1] // 2 // slot_gid.shape[1])
            q_rows = np.where(grp >= 0, np.take_along_axis(qt, np.clip(grp, 0, T - 1), 1),
                              q[:, None]).reshape(-1).astype(np.float32)
    raw = conformal_scale(*_tensors(ring.reshape(S * R, cap), ring_count.reshape(-1), q_rows,
                                    np.repeat(fb, R)), rolled=False).reshape(S, R)
    raw_pool = (conformal_scale(*_tensors(pool, pool_count, q, fb), rolled=False) if pool_on
                else torch.from_numpy(fb))
    if tenancy is None:
        return raw, raw_pool
    gring, gcount = _numpy(gring, gcount)
    raw_group = conformal_scale(*_tensors(gring.reshape(S * T, -1), gcount.reshape(-1),
                                          qt.reshape(-1).astype(np.float32),
                                          np.repeat(fb, T)), rolled=False).reshape(S, T)
    return raw, raw_pool, raw_group


def calib_begin(ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count, c_mean,
                c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n, tenancy=None, *,
                cap: int, pcap: int, min_scores: int, pool_on: bool, horizon: int,
                fallback: float):
    """The rest of the engine's shaping step per member
    (``online.py:447,413``): each series row's scale, its quantile in
    ``raw`` once it holds ``min_scores`` scores (of a ring of ``cap``),
    else the member's pool quantile ``raw_pool`` when the pool is on and
    holds ``min_scores`` (of ``pcap``), else ``fallback`` (K2); then
    ``calib_begin``: the rows of the monitor rows in ``deploy`` (S, M)
    bool register ``mean``, ``sigma = sqrt(max(var, 0))`` and the scale
    where no prediction is pending (``left == 0``): ``peak`` -inf,
    ``left`` ``horizon``, ``due`` ``mon_count + horizon``; ``scale_sum``
    adds the deployed rows' scales summed in XLA's tree (:func:`xla_sum`),
    ``scale_n`` their count.  Returns (scale (S, R), mean, sigma, scale,
    peak, left, due, scale_sum, scale_n) of the state.

    ``tenancy``, the per-tenant tier, is None or (tenant (S, N) int32,
    slot_gid (S, A) int32, group_count (S, T) int32, raw_group (S, T) the
    group rings' quantiles, group (S, R) int32, gcap): a young row of a
    tenant's slot (:func:`row_groups`) whose group ring holds
    ``min_scores`` takes the group's quantile (the pool's or K2 where the
    ring is empty) before the pool's, and a registered row records its
    tenant in ``group``, returned last."""
    (ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count, c_mean, c_sigma,
     c_scale, c_peak, c_left, c_due, scale_sum, scale_n) = _numpy(
        ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count, c_mean, c_sigma,
        c_scale, c_peak, c_left, c_due, scale_sum, scale_n)
    fb = np.full(raw.shape[0], np.float32(fallback))
    if pool_on:
        fb = np.where(np.minimum(pool_count, pcap) >= min_scores, raw_pool, fb)
    fb_rows = np.broadcast_to(fb[:, None], raw.shape)
    if tenancy is not None:
        tenant, slot_gid, gcount, raw_group, group, gcap = tenancy
        gcount, raw_group, group = _numpy(gcount, raw_group, group)
        grp = row_groups(slot_gid, tenant, raw.shape[1] // 2 // slot_gid.shape[1])
        gc = np.clip(grp, 0, gcount.shape[1] - 1)
        gq = np.where(gcount == 0, fb[:, None], raw_group)
        warm = (grp >= 0) & (np.take_along_axis(np.minimum(gcount, gcap), gc, 1) >= min_scores)
        fb_rows = np.where(warm, np.take_along_axis(gq, gc, 1), fb_rows)
    scale = np.where(np.minimum(ring_count, cap) < min_scores, fb_rows, raw)
    dep = _tiled(deploy)
    m = dep & (c_left == 0)
    sigma = np.sqrt(fmax(var, np.float32(0.0)))
    tree = xla_sum(np.where(dep, scale, np.float32(0.0)).T)
    out = _tensors(scale, np.where(m, mean, c_mean), np.where(m, sigma, c_sigma),
                   np.where(m, scale, c_scale), np.where(m, np.float32(-np.inf), c_peak),
                   np.where(m, np.int32(horizon), c_left).astype(np.int32),
                   np.where(m, _tiled(mon_count) + np.int32(horizon), c_due).astype(np.int32),
                   _add_nan_x86(tree, scale_sum),
                   (scale_n + dep.sum(-1)).astype(np.int32))
    if tenancy is None:
        return out
    return out + _tensors(np.where(m, grp, group).astype(np.int32))


def calib_scales(ring, ring_count, pool, pool_count, q, fallback, deploy, mean, var,
                 mon_count, c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum,
                 scale_n, tenancy=None, *, min_scores: int, pool_on: bool, horizon: int):
    """The device engine's calibrated shaping step (``calib_scales``, then
    ``calib_begin``, ``online.py:447,413``): :func:`calib_quantiles`, then
    :func:`calib_begin`.  Returns what that returns.  ``tenancy``, the
    per-tenant tier, is None or (credit (S, T) f32 or None, tenant (S, N),
    slot_gid (S, A), group_ring (S, T, gcap), group_count (S, T), group
    (S, R), spread, q_min, q_max)."""
    if tenancy is None:
        raw, raw_pool = calib_quantiles(ring, ring_count, pool, pool_count, q, fallback,
                                        min_scores=min_scores, pool_on=pool_on)
        return calib_begin(ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count,
                           c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n,
                           cap=ring.shape[2], pcap=pool.shape[1], min_scores=min_scores,
                           pool_on=pool_on, horizon=horizon, fallback=fallback)
    credit, tenant, slot_gid, gring, gcount, group, spread, q_min, q_max = tenancy
    raw, raw_pool, raw_group = calib_quantiles(
        ring, ring_count, pool, pool_count, q, fallback,
        (credit, tenant, slot_gid, gring, gcount, spread, q_min, q_max),
        min_scores=min_scores, pool_on=pool_on)
    return calib_begin(ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count,
                       c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n,
                       (tenant, slot_gid, gcount, raw_group, group, gring.shape[2]),
                       cap=ring.shape[2], pcap=pool.shape[1], min_scores=min_scores,
                       pool_on=pool_on, horizon=horizon, fallback=fallback)


# ----------------------------------------------------------------------
# the control plane's tick: the work of the CUDA kernel in control.cu
# ----------------------------------------------------------------------

def _tenant_counts(tenant, mask, T):
    """(S, T) int32 count of the apps in ``mask`` (S, N) per tenant; an id
    outside [0, T) counts for none (the reference's one-hot sum)."""
    mask = mask & (tenant >= 0) & (tenant < T)
    return np.stack([np.bincount(tenant[s][mask[s]], minlength=T)[:T]
                     for s in range(tenant.shape[0])]).astype(np.int32)


def control_tick(credit, throttled, completed, failed, share_sum, active_ticks, done0, done,
                 queued0, queued, conflict, d_res, d_err, tenant, slot_gid, alloc, host_cap,
                 weights, *, credit_on: bool, gate_on: bool, gamma: float, floor: float,
                 slack: float):
    """The control plane's step of a tick per member (``repro/sim/step.py:
    778-887``, phase 6's gate with the events of phases 2-5).

    The tenant state ``credit`` and ``share_sum`` (S, T) f32, ``throttled``,
    ``completed``, ``failed``, ``active_ticks`` (S, T) int32.  The tick's
    events as masks over the apps (S, N) bool: completions are ``done &
    ~done0``; failures the optimistic ``conflict`` (or None) and the OOM
    kills, ``queued & ~queued0``; ``d_res`` and ``d_err`` (S, T) int32 the
    tick's resolved and missed conformal scores per tenant (or None).
    ``queued`` is the queue at admission, ``tenant`` (S, N) int32 the
    trace's column, ``slot_gid`` (S, A) and ``alloc`` (S, A, C, 2) the slot
    table, ``host_cap`` (H, 2), ``weights`` (T,) f32.

    Good events are completions and covered scores, bad ones failures and
    missed scores.  ``credit_on``: the credit steps to ``clip(fma(gamma,
    target - credit, credit), floor, 1)`` (target the good share, the
    credit itself without events; XLA contracts the step).  Each tenant's
    allocation is summed over its slots (components in order, slots in
    XLA's tree), its share ``max_r(alloc_r * (1 / max(cap_r, 1e-9))) *
    (1 / w)`` (XLA turns a division by a constant into a product by its
    reciprocal; cap the hosts' capacities summed in order); a tenant is
    active with a share or a queued app; ``gate_on``: eligible unless
    active with ``share > fma(slack, credit, mean)`` (contracted; ``mean``
    the active tenants' shares summed in XLA's tree over their count;
    ``mean + slack`` with the credit off), else every tenant.  Returns the new credit, throttled (+ the queued apps of
    ineligible tenants), completed, failed, share_sum (+ the share where
    active), active_ticks and the eligibility (S, T) bool."""
    (credit, throttled, completed, failed, share_sum, active_ticks, done0, done, queued0,
     queued, tenant, slot_gid, alloc, cap, weights) = _numpy(
        credit, throttled, completed, failed, share_sum, active_ticks, done0, done,
        queued0, queued, tenant, slot_gid, alloc, host_cap, weights)
    S, T = credit.shape
    comp_t = _tenant_counts(tenant, done & ~done0, T)
    fail_t = _tenant_counts(tenant, queued & ~queued0, T)
    if conflict is not None:
        fail_t = fail_t + _tenant_counts(tenant, conflict.numpy(), T)
    good, bad = comp_t.copy(), fail_t.copy()
    if d_res is not None:
        d_res, d_err = _numpy(d_res, d_err)
        good += d_res - d_err
        bad += d_err
    if credit_on:
        g, b = good.astype(np.float32), bad.astype(np.float32)
        tot = g + b
        target = np.where(tot > 0, g / np.maximum(tot, np.float32(1.0)), credit)
        step = fma_f32(torch.from_numpy((target - credit).astype(np.float32)), gamma,
                       torch.from_numpy(credit)).numpy()
        credit = np.minimum(np.maximum(step, np.float32(floor)), np.float32(1.0))
    cap_sum = np.zeros(2, np.float32)
    for h in range(cap.shape[0]):
        cap_sum = (cap_sum + cap[h]).astype(np.float32)
    rcap = (np.float32(1.0) / np.maximum(cap_sum, np.float32(1e-9))).astype(np.float32)
    rw = (np.float32(1.0) / weights).astype(np.float32)
    share = np.zeros((S, T), np.float32)
    for s in range(S):
        rowsum = xla_sum(np.moveaxis(alloc[s], 1, 0), ftz=True)       # (A, 2)
        ten = np.where(slot_gid[s] >= 0, tenant[s][np.maximum(slot_gid[s], 0)], -1)
        oh = ten[:, None] == np.arange(T)[None, :]
        alloc_t = xla_sum(np.where(oh[:, :, None], rowsum[:, None, :], np.float32(0.0)),
                          ftz=True)
        norm = mul_xla(alloc_t, rcap[None, :])
        share[s] = mul_xla(fmax(norm[:, 0], norm[:, 1]), rw)
    queued_t = _tenant_counts(tenant, queued, T)
    active = (share > 0) | (queued_t > 0)
    counted = mul_xla(share, active)
    if gate_on:
        n = active.sum(-1)
        tot = xla_sum(counted.T, ftz=True)
        mean = np.where(n > 0, div_xla(tot, np.maximum(n, 1)), np.float32(0.0))
        if credit_on:
            bound = fma_f32(torch.full((S, T), float(np.float32(slack))),
                            torch.from_numpy(credit), torch.from_numpy(
                                np.broadcast_to(mean[:, None], (S, T)).copy())).numpy()
        else:
            bound = add_xla(mean[:, None], slack)
        elig = ~active | (share <= bound)
    else:
        elig = np.ones((S, T), bool)
    return _tensors(credit.astype(np.float32),
                    (throttled + np.where(elig, 0, queued_t)).astype(np.int32),
                    (completed + comp_t).astype(np.int32), (failed + fail_t).astype(np.int32),
                    add_xla(share_sum, counted), (active_ticks + active).astype(np.int32), elig)


# ----------------------------------------------------------------------
# the telemetry rings' tick: the work of the CUDA kernel in obs.cu
# ----------------------------------------------------------------------

def obs_tick(cursor, f32, i32, lead_ring, active, usage, demand, queued, q_admit, counters,
             counters0, tenancy, tenancy0, calib, calib0, lead=None):
    """One tick of the telemetry rings per member (``repro/sim/step.py:
    757-770,822,880-881,901-920``): the tick's thirteen channels, written
    at column ``cursor % R`` where the member is ``active``.

    The rings ``cursor`` (S,) int32, ``f32`` (S, 5, R), ``i32`` (S, 8, R)
    and ``lead_ring`` (S, R) int32 or None, in ``repro_torch.obs.rings``'s
    order.  ``active`` (S,) bool.  ``usage`` (S, A, C, 2) f32 the tick's
    usage after the OOM handler, ``demand`` (S, A, C, 2) the shaped
    demand table (None under the baseline policy); each summed over (A,
    C) in the order of XLA:CPU's compiled sum (:func:`xla_table_sum`:
    32-slot windows, each serial from 0 or in vector lanes, a tree and a
    scalar tail, as LLVM vectorised it for the shape), the gap the
    demand's sum minus the usage's (:func:`sub_xla`).
    ``queued`` (S, N) the queue at the end of the tick, ``q_admit`` the
    queue before admission: ``queue`` counts the one, ``admitted`` the
    apps of the other that left it.  ``counters`` and ``counters0`` the
    four (S,) int32 counters ``oom_kills``, ``failure_events``,
    ``full_preemptions``, ``partial_preemptions`` now and at the tick's
    entry.  ``tenancy`` the tenant ``(credit, throttled, active_ticks)``
    after the control step and ``tenancy0`` its ``(throttled,
    active_ticks)`` before it, (S, T) each, or None: ``throttled`` is the
    sum of the throttled counts' deltas, ``credit`` the mean credit over
    the tenants active this tick (``control/device.py::credit_mean``: the
    sum of ``credit * active`` in XLA's tree, over their count, in XLA's
    arithmetic).
    ``calib`` the calibration's ``(resolved, errors)`` now and ``calib0``
    at entry, (S,) int32 each, or None.  ``lead`` (S,) int32 (or 0) is
    written into ``lead_ring``.  Channels whose feature is off are 0.
    Returns the new ``(cursor, f32, i32, lead_ring)``."""
    cur, f, i, act, use, q, qa = _numpy(cursor, f32, i32, active, usage, queued, q_admit)
    S, A, C = use.shape[:3]
    R = f.shape[-1]
    cnt = [x.numpy().astype(np.int64) for x in counters]
    cnt0 = [x.numpy().astype(np.int64) for x in counters0]
    dem = None if demand is None else demand.numpy()
    lr = None if lead_ring is None else lead_ring.numpy().copy()
    lv = np.zeros(S, np.int32) if lead is None else lead.numpy()
    zero = np.float32(0.0)
    for s in range(S):
        if not act[s]:
            continue
        used = xla_table_sum(use[s])
        gap = np.zeros(2, np.float32)
        if dem is not None:
            gap = sub_xla(xla_table_sum(dem[s]), used)
        credit = zero
        throttled = 0
        if tenancy is not None:
            cr, th, at = (x.numpy()[s] for x in tenancy)
            th0, at0 = (x.numpy()[s] for x in tenancy0)
            throttled = int((th.astype(np.int64) - th0).sum())
            on = at > at0
            n = int(on.sum())
            tot = xla_sum(mul_xla(cr, on)[:, None], ftz=True)[0]
            credit = div_xla(tot, n) if n > 0 else zero
        res = err = 0
        if calib is not None:
            res, err = (int(x.numpy()[s]) - int(x0.numpy()[s]) for x, x0 in zip(calib, calib0))
        col = cur[s] % R
        f[s, :, col] = [used[0], used[1], gap[0], gap[1], credit]
        i[s, :, col] = [int(q[s].sum()), cnt[0][s] - cnt0[0][s], cnt[1][s] - cnt0[1][s],
                        cnt[2][s] + cnt[3][s] - cnt0[2][s] - cnt0[3][s],
                        int((qa[s] & ~q[s]).sum()), throttled, res, err]
        if lr is not None:
            lr[s, col] = lv[s]
        cur[s] += 1
    return (*_tensors(cur, f, i), None if lr is None else torch.from_numpy(lr))
