"""Online split-conformal calibration of forecast upper bounds
(counterpart of ``repro/core/uncertainty/conformal.py``).

Eq. 9's dynamic term adds ``K2`` predictive standard deviations to the
forecast peak, a band whose nominal coverage holds only while the
residuals are Gaussian.  Split-conformal calibration keeps a ring of
sigma-normalized residual scores per series, ``s = (y - mean) / sigma``,
and replaces ``K2`` by the ``ceil((n + 1) q)``-th order statistic of
the recorded scores: a distribution-free ``mean + q_hat * sigma`` upper
bound.

The rings are host numpy (:class:`ScoreBuffer`, rolled on push) or, in
the device engine, tensors written circularly
(:mod:`repro_torch.core.uncertainty.online`); the order statistic of
every row is one launch of ``ops.conformal_scale`` on the caller's
device (the CUDA kernel ``kernels/csrc/calib.cu`` on the card, its plain
version on the CPU).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.core.uncertainty.scoring import (gaussian_quantile_scale,
                                                  sigma_from_var)
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops

__all__ = ["CalibrationConfig", "conformal_scale", "conformal_scale_ring",
           "ScoreBuffer", "ConformalForecaster"]


@dataclasses.dataclass(frozen=True)
class CalibrationConfig:
    """Conformal-safeguard configuration (``SimConfig.calibration``), the
    reference's fields and defaults.

    ``enabled=False`` keeps Eq. 9 as it is; enabled, its dynamic term is
    ``q_hat(q) * sigma``.  ``adaptive`` servo-controls ``q`` so that the
    realized miscoverage tracks ``budget``.  Young series (fewer than
    ``min_scores``) fall back to the fleet pool's quantile (``pool``),
    then to ``K2``.  ``group_capacity`` sizes the per-tenant tier, which
    only the control plane allocates."""

    enabled: bool = False
    q: float = 0.9          # target upper quantile (coverage set-point)
    capacity: int = 128     # per-series score-ring capacity
    min_scores: int = 16    # below this, fall back down the hierarchy
    pool: bool = True       # fleet-wide pooled ring for young series
    pool_capacity: int = 1024
    group_capacity: int = 256
    adaptive: bool = False  # tune q online against the failure budget
    budget: float = 0.1     # target miscoverage (failure-rate budget)
    gamma: float = 0.05     # ACI step size of the adaptive controller
    q_min: float = 0.5      # adaptive controller clamp
    q_max: float = 0.995


def _per_row(x, rows: int, device) -> torch.Tensor:
    """A scalar or ``(rows,)`` value as a ``(rows,)`` float32 tensor."""
    t = torch.as_tensor(np.array(x, np.float32) if not isinstance(x, torch.Tensor) else x,
                        dtype=torch.float32, device=device)
    return t.expand(rows).contiguous() if t.dim() == 0 else t.contiguous()


def conformal_scale(scores: torch.Tensor, counts: torch.Tensor, q,
                    fallback) -> torch.Tensor:
    """Split-conformal quantile of rolled score rings.

    scores ``(B, capacity)`` float32, newest last (only the trailing
    ``min(count, capacity)`` cells are live); counts ``(B,)``; q and
    fallback scalars or ``(B,)``.  Returns ``(B,)`` ``q_hat``: the
    ``ceil((n + 1) q)``-th order statistic of the live scores (clipped
    to the sample maximum), ``fallback`` where a row has no score."""
    B = scores.shape[0]
    return kops.conformal_scale(scores, counts.to(torch.int32),
                                _per_row(q, B, scores.device),
                                _per_row(fallback, B, scores.device), rolled=True)


def conformal_scale_ring(scores: torch.Tensor, counts: torch.Tensor, q,
                         fallback) -> torch.Tensor:
    """:func:`conformal_scale` for circular rings (the device engine's
    layout): scores written at ``count % capacity``, unwritten cells
    ``+inf``, so no cell is masked; the live window holds the same scores
    as a rolled ring, hence the same quantiles."""
    B = scores.shape[0]
    return kops.conformal_scale(scores, counts.to(torch.int32),
                                _per_row(q, B, scores.device),
                                _per_row(fallback, B, scores.device), rolled=False)


class ScoreBuffer:
    """Per-series nonconformity-score rings on the host: a dense
    ``(series, capacity)`` float32 table rolled on push, whose
    :meth:`scales` runs one ``ops.conformal_scale`` over any subset of
    rows on ``device``."""

    def __init__(self, n_series: int, capacity: int, *,
                 device: str | torch.device = "cuda"):
        self.capacity = capacity
        self.device = resolve_device(device)
        self.buf = np.zeros((n_series, capacity), np.float32)
        self.count = np.zeros((n_series,), np.int64)

    def push(self, rows: np.ndarray, scores: np.ndarray) -> None:
        """Append one score for each series in ``rows`` (unique rows)."""
        self.buf[rows] = np.roll(self.buf[rows], -1, axis=1)
        self.buf[rows, -1] = scores
        self.count[rows] += 1

    def push_many(self, row: int, scores: np.ndarray) -> None:
        """Append a batch of scores to one series' ring."""
        k = min(scores.shape[0], self.capacity)
        if k == 0:
            return
        self.buf[row] = np.roll(self.buf[row], -k)
        self.buf[row, -k:] = scores[-k:]
        self.count[row] += scores.shape[0]

    def n(self, rows: np.ndarray) -> np.ndarray:
        return np.minimum(self.count[rows], self.capacity)

    def scales(self, rows: np.ndarray, q, fallback) -> np.ndarray:
        """Calibrated ``q_hat`` per row, ``fallback`` where a row is
        empty; a writable numpy array."""
        if rows.size == 0:
            return np.zeros(0, np.float32)
        dev = self.device
        out = conformal_scale(torch.from_numpy(self.buf[rows]).to(dev),
                              torch.from_numpy(self.count[rows]).to(dev),
                              np.broadcast_to(np.asarray(q, np.float32), rows.shape),
                              np.broadcast_to(np.asarray(fallback, np.float32), rows.shape))
        return out.cpu().numpy().copy()


class ConformalForecaster:
    """Any forecaster with ``forecast(window, horizon, *, valid)`` wrapped
    in online split-conformal calibration, one series at a time:
    ``forecast`` passes through and records the 1-step prediction,
    ``observe`` scores it against the realized value, and ``upper`` is
    ``mean + q_hat(q) * sigma`` (the Gaussian ``z(q)`` until
    ``min_scores`` scores have accumulated)."""

    def __init__(self, base, cfg: CalibrationConfig = CalibrationConfig(),
                 n_series: int = 1, *, device: str | torch.device = "cuda"):
        self.base = base
        self.cfg = cfg
        self.scores = ScoreBuffer(n_series, cfg.capacity, device=device)
        self._pend_mean = np.zeros((n_series,), np.float32)
        self._pend_sigma = np.ones((n_series,), np.float32)
        self._has_pend = np.zeros((n_series,), bool)

    def forecast(self, window, horizon: int, *, series: int = 0, valid=None):
        fc = self.base.forecast(window, horizon, valid=valid)
        self._pend_mean[series] = float(fc.mean[0])
        self._pend_sigma[series] = max(float(sigma_from_var(fc.var)[0]), 1e-9)
        self._has_pend[series] = True
        return fc

    def observe(self, y: float, *, series: int = 0) -> float | None:
        """Score the outstanding 1-step prediction; returns the score."""
        if not self._has_pend[series]:
            return None
        s = (float(y) - self._pend_mean[series]) / self._pend_sigma[series]
        self.scores.push(np.asarray([series]), np.asarray([s], np.float32))
        self._has_pend[series] = False
        return s

    def scale(self, *, series: int = 0, q: float | None = None) -> float:
        """Calibrated sigma multiplier (Gaussian z until ``min_scores``)."""
        q = self.cfg.q if q is None else q
        gauss = float(gaussian_quantile_scale(q))
        rows = np.asarray([series])
        if int(self.scores.n(rows)[0]) < self.cfg.min_scores:
            return gauss
        return float(self.scores.scales(rows, q, gauss)[0])

    def upper(self, fc, *, series: int = 0, q: float | None = None):
        """Distribution-free upper band: ``mean + q_hat(q) * sigma``."""
        return fc.mean + self.scale(series=series, q=q) * sigma_from_var(fc.var)
