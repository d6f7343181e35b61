"""Online calibration loop of the simulation engines (counterpart of
``repro/core/uncertainty/online.py``).

Every monitored component series, one per (slot, resource) in the order
of the engines' forecast batch (CPU rows ``0 .. M-1``, then MEM rows
``M .. 2M-1``), has at most one outstanding prediction, the deployed
upper bound ``mean + scale * sigma`` of its peak over the horizon.  The
prediction resolves ``horizon`` ticks later with the score

    s = (max_{k <= h} y_{t+k} - mean_t) / sigma_t,

pushed into the series' ring and the fleet pool, unless a monitor reset
(admission, eviction, preemption) broke the series' sample count in
between.

Two forms, as in the reference:

  * :class:`OnlineCalibrator`, numpy state for the host engine, whose
    quantiles run on the engine's device (``ScoreBuffer.scales``);
  * :class:`CalibState` with :func:`calib_init`, :func:`calib_observe`,
    :func:`calib_scales_begin` and :func:`calib_report`, tensors with a
    leading member axis S for the device engine.  Rings
    are circular (written at ``count % capacity``, unwritten cells
    ``+inf``).  On the card :func:`calib_observe` is one launch of the
    CUDA kernel ``calib_observe`` (``kernels/csrc/calib.cu``) and
    :func:`calib_scales_begin`, the device engine's shaping step, one
    launch of ``conformal_scale`` (the quantiles) and one of
    ``calib_begin`` (the fallback hierarchy and the registration of the
    deployed predictions); none reads anything back, so a captured CUDA
    graph holds them.

With the control plane on, both forms add the per-group (tenant) tier:
each resolved score also enters the ring of the tenant that owned its
slot when the bound was deployed, and a young series falls back to its
tenant's quantile (once warm) before the pool's; each tenant's target
quantile moves with its credit (:func:`calib_scales_begin`'s
``tenancy``).  On the card the tier adds no launch: the three kernels
take it.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.uncertainty.adaptive import QuantileController
from repro_torch.core.uncertainty.conformal import CalibrationConfig, ScoreBuffer
from repro_torch.kernels import ops as kops

__all__ = ["OnlineCalibrator", "CalibState", "calib_init", "calib_observe",
           "calib_observe_groups", "calib_scales_begin", "calib_report", "calib_group_report"]


class OnlineCalibrator:
    """Per-series online split-conformal calibration for the host engine,
    a copy of the reference's (numpy state; ``n_groups > 0`` adds the
    per-group tier).  The quantiles run on ``device``.  ``observe`` takes
    the monitor's per-slot sample counts (length ``n_series / 2``) and
    tiles them."""

    def __init__(self, n_series: int, horizon: int, fallback: float,
                 cfg: CalibrationConfig, *, n_groups: int = 0,
                 device: str | torch.device = "cuda"):
        self.cfg = cfg
        self.horizon = int(horizon)
        self.fallback = float(fallback)
        self.scores = ScoreBuffer(n_series, cfg.capacity, device=device)
        # fleet-wide pooled ring: the middle tier of the fallback
        # hierarchy (series ring -> pool -> K2) for young series
        self.pooled = (ScoreBuffer(1, cfg.pool_capacity, device=device)
                       if cfg.pool else None)
        # per-group rings (series -> group -> pool -> K2)
        self.groups = (ScoreBuffer(n_groups, cfg.group_capacity, device=device)
                       if n_groups > 0 else None)
        self._group = np.full((n_series,), -1, np.int64)
        self.group_resolved = np.zeros(max(n_groups, 0), np.int64)
        self.group_errors = np.zeros(max(n_groups, 0), np.int64)
        self.controller = QuantileController(cfg) if cfg.adaptive else None
        z = lambda dt: np.zeros((n_series,), dt)  # noqa: E731
        self._mean, self._sigma, self._scale = z(np.float32), z(np.float32), z(np.float32)
        self._peak = z(np.float32)      # running max of realized usage
        self._left = z(np.int64)        # ticks to resolution; 0 = idle
        self._due = z(np.int64)         # expected monitor count at resolution
        self.resolved = 0
        self.errors = 0
        self.dropped = 0                # invalidated by a series reset
        self._scale_sum = 0.0
        self._scale_n = 0

    @property
    def q(self) -> float:
        return self.controller.q if self.controller is not None else self.cfg.q

    def observe(self, usage: np.ndarray, mon_count: np.ndarray) -> None:
        """Advance outstanding predictions with this tick's usage, (n_series,)
        CPU rows then MEM rows; ``mon_count`` (n_series/2,).  Once a tick,
        after monitor sampling and before shaping."""
        act = self._left > 0
        if not act.any():
            return
        np.maximum(self._peak, usage, where=act, out=self._peak)
        self._left[act] -= 1
        fire = act & (self._left == 0)
        if not fire.any():
            return
        counts = np.concatenate([mon_count, mon_count])
        ok = fire & (counts == self._due)
        self.dropped += int(fire.sum() - ok.sum())
        rows = np.nonzero(ok)[0]
        if rows.size == 0:
            return
        sig = np.maximum(self._sigma[rows], 1e-6)
        s = (self._peak[rows] - self._mean[rows]) / sig
        self.scores.push(rows, s.astype(np.float32))
        if self.pooled is not None:
            self.pooled.push_many(0, s.astype(np.float32))
        err = self._peak[rows] > (self._mean[rows]
                                  + self._scale[rows] * self._sigma[rows])
        if self.groups is not None:
            g = self._group[rows]
            valid = g >= 0
            for gg in np.unique(g[valid]):
                self.groups.push_many(int(gg), s[g == gg].astype(np.float32))
            np.add.at(self.group_resolved, g[valid], 1)
            np.add.at(self.group_errors, g[valid], err[valid])
        self.resolved += rows.size
        self.errors += int(err.sum())
        if self.controller is not None:
            self.controller.update(err)

    def begin(self, rows: np.ndarray, mean: np.ndarray, sigma: np.ndarray,
              scale: np.ndarray, mon_count: np.ndarray,
              groups: np.ndarray | None = None) -> None:
        """Register deployed predictions for ``rows``; rows with an
        outstanding prediction keep it (horizon-stride sampling).
        ``mon_count`` and ``groups`` are per row."""
        free = self._left[rows] == 0
        r = rows[free]
        if r.size == 0:
            return
        self._mean[r] = mean[free]
        self._sigma[r] = sigma[free]
        self._scale[r] = scale[free]
        self._peak[r] = -np.inf
        self._left[r] = self.horizon
        self._due[r] = mon_count[free] + self.horizon
        if self.groups is not None and groups is not None:
            self._group[r] = groups[free]

    def scales(self, rows: np.ndarray, groups: np.ndarray | None = None,
               q: np.ndarray | float | None = None) -> np.ndarray:
        """Calibrated sigma multipliers for ``rows``: the series' own
        quantile once ``min_scores`` accumulated, else the row's warm
        group's, else the warm pool's, else the K2 fallback.  ``q``
        overrides the target level per row."""
        qv = self.q if q is None else q
        out = self.scores.scales(rows, qv, self.fallback)
        young = self.scores.n(rows) < self.cfg.min_scores
        if young.any():
            fb = self.fallback
            if (self.pooled is not None
                    and int(self.pooled.n(np.asarray([0]))[0]) >= self.cfg.min_scores):
                fb = float(self.pooled.scales(np.asarray([0]), self.q, self.fallback)[0])
            fbv = np.full(rows.shape[0], fb, np.float32)
            if self.groups is not None and groups is not None:
                gc = np.maximum(groups, 0)
                warm = (groups >= 0) & (self.groups.n(gc) >= self.cfg.min_scores)
                gq = self.groups.scales(gc, qv, fbv)
                fbv = np.where(warm, gq, fbv)
            out[young] = fbv[young]
        self._scale_sum += float(out.sum())
        self._scale_n += rows.size
        return out

    def report(self) -> dict:
        """JSON-ready summary block (``SimResults.calibration``)."""
        live = np.minimum(self.scores.count, self.scores.capacity)
        return {
            "q_target": round(float(self.q), 4),
            "q_initial": self.cfg.q,
            "adaptive": bool(self.cfg.adaptive),
            "budget": self.cfg.budget,
            "resolved": int(self.resolved),
            "miscovered": int(self.errors),
            "coverage": (round(1.0 - self.errors / self.resolved, 4)
                         if self.resolved else None),
            "dropped": int(self.dropped),
            "scores_recorded": int(self.scores.count.sum()),
            "series_warm": int((live >= self.cfg.min_scores).sum()),
            "pool_warm": bool(
                self.pooled is not None
                and int(self.pooled.n(np.asarray([0]))[0]) >= self.cfg.min_scores),
            "mean_scale": (round(self._scale_sum / self._scale_n, 4)
                           if self._scale_n else None),
        }

    def group_report(self) -> dict | None:
        """Per-group resolution and coverage block, or None."""
        if self.groups is None:
            return None
        res, err = self.group_resolved, self.group_errors
        live = np.minimum(self.groups.count, self.groups.capacity)
        return {
            "resolved": res.tolist(),
            "miscovered": err.tolist(),
            "coverage": [(round(1.0 - e / r, 4) if r else None)
                         for r, e in zip(res.tolist(), err.tolist())],
            "warm": (live >= self.cfg.min_scores).astype(int).tolist(),
        }


# ----------------------------------------------------------------------
# the device engine's calibration state
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class CalibState:
    """Calibration state of the device engine, ``(S, ...)`` per field:
    S members, R = 2*A*C series rows a member (CPU rows, then MEM rows),
    float32 and int32 as the reference's."""

    ring: torch.Tensor        # (S, R, capacity) f32, unwritten cells +inf
    ring_count: torch.Tensor  # (S, R) i32 scores ever pushed per series
    pool: torch.Tensor        # (S, pool_capacity) f32 fleet-pooled ring
    pool_count: torch.Tensor  # (S,) i32
    # one outstanding prediction per series
    mean: torch.Tensor        # (S, R) f32
    sigma: torch.Tensor       # (S, R) f32
    scale: torch.Tensor       # (S, R) f32 deployed sigma multiplier
    peak: torch.Tensor        # (S, R) f32 running max of realized usage
    left: torch.Tensor        # (S, R) i32 ticks to resolution; 0 = idle
    due: torch.Tensor         # (S, R) i32 expected monitor count at resolution
    # adaptive set-point and telemetry counters
    q: torch.Tensor           # (S,) f32
    resolved: torch.Tensor    # (S,) i32
    errors: torch.Tensor      # (S,) i32
    dropped: torch.Tensor     # (S,) i32 invalidated by a series reset
    scale_sum: torch.Tensor   # (S,) f32
    scale_n: torch.Tensor     # (S,) i32
    # the per-group (tenant) tier, None without the control plane
    group_ring: torch.Tensor | None = None      # (S, G, group_capacity) f32
    group_count: torch.Tensor | None = None     # (S, G) i32
    group: torch.Tensor | None = None           # (S, R) i32 deploy group, -1 idle
    group_resolved: torch.Tensor | None = None  # (S, G) i32
    group_errors: torch.Tensor | None = None    # (S, G) i32


GROUP_TIER = ("group_ring", "group_count", "group", "group_resolved", "group_errors")


def calib_init(n_series: int, cfg: CalibrationConfig, batch: int, device,
               n_groups: int = 0) -> CalibState:
    """Fresh state for ``batch`` members of ``n_series`` rows;
    ``n_groups > 0`` adds the per-group tier."""
    S = batch
    f32, i32 = torch.float32, torch.int32

    def z(*shape, dtype):
        return torch.zeros((S,) + shape, dtype=dtype, device=device)

    q0 = float(np.clip(cfg.q, cfg.q_min, cfg.q_max) if cfg.adaptive else cfg.q)
    groups = {}
    if n_groups > 0:
        groups = dict(
            group_ring=torch.full((S, n_groups, cfg.group_capacity), float("inf"),
                                  dtype=f32, device=device),
            group_count=z(n_groups, dtype=i32),
            group=torch.full((S, n_series), -1, dtype=i32, device=device),
            group_resolved=z(n_groups, dtype=i32), group_errors=z(n_groups, dtype=i32))
    return CalibState(
        ring=torch.full((S, n_series, cfg.capacity), float("inf"), dtype=f32, device=device),
        ring_count=z(n_series, dtype=i32),
        pool=torch.full((S, cfg.pool_capacity), float("inf"), dtype=f32, device=device),
        pool_count=z(dtype=i32),
        mean=z(n_series, dtype=f32), sigma=z(n_series, dtype=f32),
        scale=z(n_series, dtype=f32), peak=z(n_series, dtype=f32),
        left=z(n_series, dtype=i32), due=z(n_series, dtype=i32),
        q=torch.full((S,), float(np.float32(q0)), dtype=f32, device=device),
        resolved=z(dtype=i32), errors=z(dtype=i32), dropped=z(dtype=i32),
        scale_sum=z(dtype=f32), scale_n=z(dtype=i32), **groups)


def calib_observe(st: CalibState, usage: torch.Tensor, mon_count: torch.Tensor,
                  cfg: CalibrationConfig, active: torch.Tensor) -> CalibState:
    """Advance outstanding predictions with this tick's usage.

    ``usage`` (S, M, 2) is each monitor row's realized (cpu, mem) usage,
    series row r < M its cpu and M + r its mem; ``mon_count`` (S, M) the
    monitor's sample counts; ``active`` (S,) bool gates the whole update
    per member (a member whose apps are all done ages nothing).  A
    prediction resolves when its ``left`` reaches 0 and scores only if the
    series' count is the one it was due at; the scores of one tick enter
    the pool in row order, the last ``pool_capacity`` of them when more
    resolve.  Where XLA contracts ``mean + scale * sigma`` and the
    adaptive ``q + gamma * (err_rate - budget)``, both are rounded once.
    With the per-group tier each resolved row's score also enters its
    deploy group's ring (the group's scores in row order, the last
    ``group_capacity`` of them when more resolve).  On the card one kernel
    launch."""
    return calib_observe_groups(st, usage, mon_count, cfg, active)[0]


def calib_observe_groups(st: CalibState, usage: torch.Tensor, mon_count: torch.Tensor,
                         cfg: CalibrationConfig, active: torch.Tensor
                         ) -> tuple[CalibState, tuple | None]:
    """:func:`calib_observe`, returning the state and, with the per-group
    tier, the tick's resolved and missed scores per group ((S, G), (S, G))
    int32 (what the control plane's credit counts), else None: the
    kernel's outputs, so the tick needs no copy of the old counters."""
    groups = (None if st.group_ring is None else
              (st.group_ring, st.group_count, st.group, st.group_resolved, st.group_errors))
    out = kops.calib_observe(
        st.ring, st.ring_count, st.pool, st.pool_count, st.mean, st.sigma, st.scale,
        st.peak, st.left, st.due, st.q, st.resolved, st.errors, st.dropped,
        usage, mon_count, active, cfg, groups)
    (ring, ring_count, pool, pool_count, peak, left, q, resolved, errors, dropped) = out[:10]
    st = dataclasses.replace(st, ring=ring, ring_count=ring_count, pool=pool,
                             pool_count=pool_count, peak=peak, left=left, q=q,
                             resolved=resolved, errors=errors, dropped=dropped)
    if groups is None:
        return st, None
    group_ring, group_count, group_resolved, group_errors, d_res, d_err = out[10:]
    return dataclasses.replace(st, group_ring=group_ring, group_count=group_count,
                               group_resolved=group_resolved,
                               group_errors=group_errors), (d_res, d_err)


def calib_scales_begin(st: CalibState, cfg: CalibrationConfig, fallback: float,
                       deploy: torch.Tensor, mean: torch.Tensor, var: torch.Tensor,
                       mon_count: torch.Tensor, horizon: int, tenancy=None):
    """The device engine's calibrated shaping step: the reference's
    ``calib_scales``, then its ``calib_begin`` with ``sigma = sqrt(max(var,
    0))``, as one step (``kernels/ref.py::calib_scales``).

    ``deploy`` (S, M) marks the monitor rows past the grace period (both
    of a row's series deploy), ``mean`` and ``var`` (S, R) are the
    forecast peaks and their variances, ``mon_count`` (S, M).  Returns
    (scale (S, R), the state after ``calib_begin``).  On the card two
    kernel launches, ``conformal_scale`` and ``calib_begin``, which read
    nothing back.

    ``tenancy`` (the control plane, with the per-group tier): (credit (S,
    T) f32 or None without the credit, tenant (S, N) int32, slot_gid (S,
    A) int32, ``TenancyConfig``).  The rows of a tenant's slot fall back
    to the tenant's warm ring before the pool and register the tenant as
    their group; with the credit, the tenant's rows and ring take its
    quantile ``clip(q + q_spread * (1 - 2 * credit), q_min, q_max)``."""
    tier = None
    if tenancy is not None:
        credit, tenant, slot_gid, tcfg = tenancy
        tier = (credit, tenant, slot_gid, st.group_ring, st.group_count, st.group,
                tcfg.q_spread, cfg.q_min, cfg.q_max)
    out = kops.calib_scales(
        st.ring, st.ring_count, st.pool, st.pool_count, st.q, fallback, cfg,
        deploy, mean, var, mon_count, horizon, st.mean, st.sigma, st.scale, st.peak,
        st.left, st.due, st.scale_sum, st.scale_n, tier)
    scale, mean_, sigma_, scale_, peak, left, due, scale_sum, scale_n = out[:9]
    st = dataclasses.replace(st, mean=mean_, sigma=sigma_, scale=scale_, peak=peak,
                             left=left, due=due, scale_sum=scale_sum, scale_n=scale_n)
    if tier is not None:
        st = dataclasses.replace(st, group=out[9])
    return scale, st


def calib_report(state: dict, cfg: CalibrationConfig) -> dict:
    """One member's final state, its fields as numpy arrays, as the
    telemetry block of :meth:`OnlineCalibrator.report`."""
    ring_count = np.asarray(state["ring_count"])
    live = np.minimum(ring_count, np.asarray(state["ring"]).shape[-1])
    resolved = int(state["resolved"])
    errors = int(state["errors"])
    scale_n = int(state["scale_n"])
    return {
        "q_target": round(float(state["q"]), 4),
        "q_initial": cfg.q,
        "adaptive": bool(cfg.adaptive),
        "budget": cfg.budget,
        "resolved": resolved,
        "miscovered": errors,
        "coverage": round(1.0 - errors / resolved, 4) if resolved else None,
        "dropped": int(state["dropped"]),
        "scores_recorded": int(ring_count.sum()),
        "series_warm": int((live >= cfg.min_scores).sum()),
        "pool_warm": bool(cfg.pool and int(np.minimum(
            np.asarray(state["pool_count"]), np.asarray(state["pool"]).shape[-1]))
            >= cfg.min_scores),
        "mean_scale": round(float(state["scale_sum"]) / scale_n, 4) if scale_n else None,
    }


def calib_group_report(state: dict, cfg: CalibrationConfig) -> dict | None:
    """One member's per-group block from its final state's fields (numpy,
    ``group_*`` among them), as :meth:`OnlineCalibrator.group_report`; None
    without the tier."""
    if state.get("group_ring") is None:
        return None
    res = np.asarray(state["group_resolved"])
    err = np.asarray(state["group_errors"])
    live = np.minimum(np.asarray(state["group_count"]), np.asarray(state["group_ring"]).shape[-1])
    return {
        "resolved": res.tolist(),
        "miscovered": err.tolist(),
        "coverage": [(round(1.0 - e / r, 4) if r else None)
                     for r, e in zip(res.tolist(), err.tolist())],
        "warm": (live >= cfg.min_scores).astype(int).tolist(),
    }
