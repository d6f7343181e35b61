"""Device dispatch for the port's kernels (counterpart of
``repro.kernels.ops``).

The tensor's device decides: a CUDA tensor goes to the hand-written
kernel, a CPU tensor to the plain PyTorch version.  There is no switch
that sends a CUDA tensor to the plain version.
"""
from __future__ import annotations

import torch

from repro_torch.kernels import arima_forecast as _ar
from repro_torch.kernels import calib as _cb
from repro_torch.kernels import control as _ct
from repro_torch.kernels import flash_attention as _fa
from repro_torch.kernels import fma as _fm
from repro_torch.kernels import gp_forecast as _gf
from repro_torch.kernels import gp_gram as _gg
from repro_torch.kernels import leap as _lp
from repro_torch.kernels import obs as _ob
from repro_torch.kernels import ref
from repro_torch.kernels import sched as _sc
from repro_torch.kernels import shaper as _sh


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


def gram_bwd(grad: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
             lengthscale: torch.Tensor, sigma_f: torch.Tensor, *,
             kind: str = "exp") -> tuple[torch.Tensor, torch.Tensor]:
    """The gradient of ``sum(grad * gram(xa, xb, ...))`` with respect to
    the per-series ``(lengthscale, sigma_f)``: ``(d_ell, d_sf)``, each
    ``(B,)``, for ``grad (B,M,N)``.  On the card one launch of the Gram
    gradient kernel."""
    return _route("gram_bwd", _gg.gram_bwd, ref.gram_bwd, xa,
                  (grad, xa, xb, lengthscale, sigma_f, kind))


def gp_fit_forecast(X: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                    hist: torch.Tensor, T: int, horizon: int, cfg,
                    ready: torch.Tensor | None = None):
    """The GP's evidence loop, fit and iterated horizon per series, in
    standardized units: X (B,N,D) patterns, y (B,N) targets, row_valid
    (B,N), hist (B,D-1) the last D-1 values, T the window length, cfg a
    ``GPConfig`` -> (mean, var, log_params), ``(B, horizon)`` twice and
    ``(B, 3)``.  ``ready`` (B,) bool, on X's device: only the series it
    marks are computed, the others are zeros.  On the card one kernel
    launch, which reads the mask itself; a call it cannot take raises."""
    if X.device.type == "cuda":
        return _gf.gp_fit_forecast(X.contiguous(), y.contiguous(),
                                   row_valid.contiguous(), hist.contiguous(),
                                   T, horizon, cfg,
                                   None if ready is None else ready.contiguous())
    if X.device.type == "cpu":
        return ref.gp_fit_forecast(X, y, row_valid, hist, T, horizon, cfg, ready)
    raise ValueError(f"no gp_fit_forecast implementation for device {X.device}")


def arima_forecast(windows: torch.Tensor, valid: torch.Tensor, horizon: int, cfg,
                   ready: torch.Tensor | None = None):
    """ARIMA forecasts of ``(B, T)`` windows with ``valid`` samples,
    ``horizon`` steps ahead, for an ``ARIMAConfig`` ``cfg``: ``(mean,
    var)``, ``(B, horizon)`` each; see ``ref.arima_select``.  ``ready``
    (B,) bool, on the windows' device: only the series it marks are
    computed, the others are zeros.  On the card one kernel launch, which
    reads the mask itself; a call it cannot take raises."""
    return _route("arima_forecast", _ar.arima_forecast, ref.arima_forecast, windows,
                  (windows, valid, horizon, cfg, ready))


def attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
              causal: bool = True, sm_scale: float | None = None) -> torch.Tensor:
    """Multi-head (GQA) attention. q: (B,Hq,S,D), k/v: (B,Hkv,T,D).

    Queries are aligned to the END of the key sequence (decode semantics:
    q_offset = T - S), which also covers self-attention (T == S).  The
    CUDA kernel masks any S, T and D itself, so it takes every shape the
    TPU wrapper padded or sent to the reference."""
    D = q.shape[3]
    if sm_scale is None:
        sm_scale = 1.0 / (D ** 0.5)
    if q.device.type == "cuda":
        return _fa.flash_attention(q.contiguous(), k.contiguous(), v.contiguous(),
                                   causal=causal, sm_scale=sm_scale,
                                   q_offset=k.shape[2] - q.shape[2])
    if q.device.type == "cpu":
        return ref.attention(q, k, v, causal=causal, sm_scale=sm_scale)
    raise ValueError(f"no attention implementation for device {q.device}")


def _route(name: str, kernel, plain, t: torch.Tensor, args):
    if t.device.type == "cuda":
        return kernel(*(a.contiguous() if isinstance(a, torch.Tensor) else a
                        for a in args))
    if t.device.type == "cpu":
        return plain(*args)
    raise ValueError(f"no {name} implementation for device {t.device}")


def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA:CPU's fused
    multiply-add gives it, subnormal inputs and tiny results flushed to
    zero as XLA:CPU does; ``b`` a tensor that broadcasts or a scalar taken
    as float32.  On the card one kernel launch."""
    if a.device.type == "cuda":
        return _fm.fma_f32(a, b, c)
    if a.device.type == "cpu":
        return ref.fma_f32(a, b, c)
    raise ValueError(f"no fma_f32 implementation for device {a.device}")


def pessimistic_pass(valid, dem, core, el, host, order, free0):
    """Algorithm 1's sequential pass over the processing order, per
    member: ``(remove_pos (S,A), kill_pos (S,A,C), free (S,H,2))``; see
    ``ref.pessimistic_pass``.  On the card one kernel launch."""
    return _route("pessimistic_pass", _sh.pessimistic_pass, ref.pessimistic_pass,
                  valid, (valid, dem, core, el, host, order, free0))


def resolve_oom(*args):
    """The OS OOM handler per member; arguments and results as
    ``ref.resolve_oom``.  On the card one kernel launch."""
    return _route("resolve_oom", _sc.resolve_oom, ref.resolve_oom, args[0], args)


def admit_queued(*args):
    """FIFO admission per member, gated per tenant when the control
    plane's ``tenant``, ``elig`` and ``admitted`` follow; arguments and
    results as ``ref.admit_queued``.  On the card one kernel launch."""
    return _route("admit_queued", _sc.admit_queued, ref.admit_queued, args[0], args)


def place_missing_elastic(*args):
    """Elastic re-placement per member; arguments and results as
    ``ref.place_missing_elastic``.  On the card one kernel launch."""
    return _route("place_missing_elastic", _sc.place_missing_elastic,
                  ref.place_missing_elastic, args[0], args)


def leap_skip(slot_gid, queued, arrived, submit, done, t, left, tick, calib_left=None):
    """The idle ticks each member skips before its next real tick, and its
    clock after them: ``(t, lead)``; see ``ref.leap_skip``.  ``calib_left``
    (S, R), the calibration state's ticks to each pending score, holds a
    member with a pending score.  On the card one kernel launch, which
    reads nothing back."""
    return _route("leap_skip", _lp.leap_skip, ref.leap_skip, slot_gid,
                  (slot_gid, queued, arrived, submit, done, t, left, tick, calib_left))


def conformal_scale(scores, counts, q, fallback, *, rolled: bool):
    """The conformal quantile of each ``(B, cap)`` score ring, q and
    fallback ``(G,)`` per group of rows; see ``ref.conformal_scale``.  On
    the card one kernel launch."""
    return _route("conformal_scale", _cb.conformal_scale, ref.conformal_scale, scores,
                  (scores, counts, q, fallback, rolled))


def _calib_kw(cfg) -> dict:
    return dict(pool_on=cfg.pool, adaptive=cfg.adaptive, gamma=cfg.gamma,
                budget=cfg.budget, q_min=cfg.q_min, q_max=cfg.q_max)


def calib_observe(ring, ring_count, pool, pool_count, mean, sigma, scale, peak, left, due,
                  q, resolved, errors, dropped, usage, mon_count, active, cfg, groups=None):
    """One tick of the calibration's outstanding predictions for a
    ``CalibrationConfig`` ``cfg``, with the per-tenant tier ``groups`` or
    None; see ``ref.calib_observe``.  On the card one kernel launch."""
    kw = _calib_kw(cfg)
    if groups is not None:
        groups = tuple(g.contiguous() for g in groups)
    return _route("calib_observe", lambda *a: _cb.calib_observe(*a, **kw),
                  lambda *a: ref.calib_observe(*a, **kw), ring,
                  (ring, ring_count, pool, pool_count, mean, sigma, scale, peak, left, due,
                   q, resolved, errors, dropped, usage, mon_count, active, groups))


def calib_scales(ring, ring_count, pool, pool_count, q, fallback, cfg, deploy, mean, var,
                 mon_count, horizon, c_mean, c_sigma, c_scale, c_peak, c_left, c_due,
                 scale_sum, scale_n, tenancy=None):
    """The device engine's calibrated shaping step (the fallback
    hierarchy's scales, then ``calib_begin``), with the per-tenant tier
    ``tenancy`` or None; see ``ref.calib_scales``.  On the card two
    launches, ``conformal_scale`` over the warm rings, the pools and the
    group rings, then ``calib_begin``."""
    kw = dict(min_scores=cfg.min_scores, pool_on=cfg.pool, horizon=horizon)
    if tenancy is not None:
        tenancy = tuple(x.contiguous() if isinstance(x, torch.Tensor) else x for x in tenancy)
    return _route("calib_scales", lambda *a: _cb.calib_scales(*a, **kw),
                  lambda *a: ref.calib_scales(*a, **kw), ring,
                  (ring, ring_count, pool, pool_count, q, fallback, deploy, mean, var,
                   mon_count, c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum,
                   scale_n, tenancy))


def control_tick(*args, **kw):
    """The control plane's step of a tick per member: the credit, the
    shares, the gate and the counters; arguments and results as
    ``ref.control_tick``.  On the card one kernel launch."""
    return _route("control_tick", lambda *a: _ct.control_tick(*a, **kw),
                  lambda *a: ref.control_tick(*a, **kw), args[0], args)


def obs_tick(cursor, f32, i32, lead_ring, active, usage, demand, queued, q_admit, counters,
             counters0, tenancy, tenancy0, calib, calib0, lead=None):
    """The telemetry rings' tick per member: the tick's thirteen channels
    written at ``cursor % R`` where the member is active; arguments and
    results as ``ref.obs_tick``.  On the card one kernel launch."""
    def cont(x):
        if isinstance(x, tuple):
            return tuple(cont(y) for y in x)
        return x.contiguous() if isinstance(x, torch.Tensor) else x
    args = (cursor, f32, i32, lead_ring, active, usage, demand, queued, q_admit, counters,
            counters0, tenancy, tenancy0, calib, calib0, lead)
    if cursor.device.type == "cuda":
        return _ob.obs_tick(*cont(args))
    if cursor.device.type == "cpu":
        return ref.obs_tick(*args)
    raise ValueError(f"no obs_tick implementation for device {cursor.device}")
