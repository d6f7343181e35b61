"""Per-scenario diagnostics: sampled utilization series and rolling
forecast-error reports.

Counterpart of ``repro/sim/scenarios/diagnostics.py``.  The paper's
Fig. 2 evaluates forecast error on ~6000 memory series from one cluster;
with pluggable scenarios the same question becomes per-regime: *how
learnable is this workload family for each forecaster?*
``sample_usage_series`` draws component utilization series straight
from a :class:`Trace`'s ground-truth profiles (the exact curves the
simulator will realize, the reference's numpy draws call for call), and
``forecast_error_report`` runs batched one-step-ahead rolling forecasts
over them, returning the error quartiles + |z| calibration the sweep
attaches to ``BENCH_sweep.json`` next to each scenario's paper metrics.

The GP and ARIMA forecasts are one ``forecast_batch(wins, 1, device=...)``
call each: on the card one ``gp_fit_forecast`` or ``arima_forecast``
launch, whose horizon is a runtime argument, so the reference's cache of
jitted one-step functions has no counterpart.  The coverage report's
conformal quantile is one ``ScoreBuffer.scales`` call per level (one
``conformal_scale`` launch on the card).

Only :mod:`repro_torch.core` is imported — no engine dependency, so
the diagnostics are bit-neutral to simulation results by construction.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.sim.scenarios.schema import MEM, Trace

__all__ = ["sample_usage_series", "rolling_errors", "forecast_error_report",
           "rolling_forecasts", "coverage_report", "forecast_reports"]

#: Gaussian nominal coverage of the paper's K2 = 3 sigma band, Phi(3), as
#: the reference computes it (``jax.scipy.stats.norm.cdf(3.0)``, float32):
#: the float64 value rounded to float32 is that result's bits
K2_NOMINAL = float(np.float32(0.5 * math.erfc(-3.0 / math.sqrt(2.0))))


def sample_usage_series(trace: Trace, n_series: int, length: int,
                        seed: int, resource: int = MEM,
                        noise: float = 0.01) -> np.ndarray:
    """(n_series, length) utilization series sampled from the trace's
    component profiles, full-lifetime, at uniform progress spacing."""
    rng = np.random.RandomState(seed)
    req = trace.cpu_req if resource == 0 else trace.mem_req
    gids, comps = np.nonzero(req > 0)
    if gids.size == 0:
        raise ValueError("trace has no components to sample")
    pick = rng.randint(0, gids.size, n_series)
    prog = np.linspace(0.0, 1.0, length, dtype=np.float32)
    out = np.empty((n_series, length), np.float32)
    for i, k in enumerate(pick):
        gid, c = gids[k], comps[k]
        u = trace.usage(np.full(length, gid), prog)[np.arange(length), c,
                                                    resource]
        out[i] = u + rng.normal(0.0, noise * req[gid, c], length)
    return out


def _make_model(forecaster: str, gp=None, arima=None):
    from repro_torch.core.forecast import (ARIMAConfig, ARIMAForecaster, GPConfig,
                                           GPForecaster)
    if forecaster == "gp":
        return GPForecaster(gp or GPConfig())
    if forecaster == "arima":
        return ARIMAForecaster(arima or ARIMAConfig())
    raise ValueError(f"no diagnostic model for forecaster {forecaster!r}")


def rolling_forecasts(forecaster: str, series: np.ndarray, window: int,
                      n_eval: int, gp=None, arima=None, *,
                      device: str | torch.device = "cuda"):
    """Batched one-step-ahead rolling forecasts over sampled series, the
    GP or ARIMA on ``device``.

    Returns ``(mean, sd, tgts)``, numpy, each of shape
    ``(n_eval * n_series,)``, grouped by evaluation start (block ``i``
    holds every series at start ``i`` — the split exploited by
    :func:`coverage_report`).
    """
    dev = resolve_device(device)
    T = series.shape[1]
    starts = np.linspace(0, T - window - 1, n_eval).astype(int)
    wins = np.concatenate([series[:, s:s + window] for s in starts])
    tgts = np.concatenate([series[:, s + window] for s in starts])

    if forecaster == "persist":
        mean = wins[:, -1]
        sd = np.sqrt(wins.var(axis=1) + 1e-6)
    else:
        model = _make_model(forecaster, gp=gp, arima=arima)
        fc = model.forecast_batch(wins, 1, device=dev)
        mean = fc.mean[:, 0].cpu().numpy()
        sd = np.sqrt(np.maximum(fc.var[:, 0].cpu().numpy(), 1e-12))
    return mean, sd, tgts


def rolling_errors(forecaster: str, series: np.ndarray, window: int,
                   n_eval: int, gp=None, arima=None, *,
                   device: str | torch.device = "cuda"):
    """Batched one-step-ahead rolling forecasts -> (rel_errors, |z|)."""
    mean, sd, tgts = rolling_forecasts(forecaster, series, window, n_eval,
                                       gp=gp, arima=arima, device=device)
    scale = np.maximum(np.abs(tgts), 1e-3)
    rel = (mean - tgts) / scale
    z = np.abs(mean - tgts) / np.maximum(sd, 1e-9)
    return rel, z


def _error_block(forecaster: str, mean, sd, tgts, *, window: int,
                 n_series: int, n_eval: int) -> dict:
    """Error-quartile record from an existing rolling-forecast pass."""
    scale = np.maximum(np.abs(tgts), 1e-3)
    rel = (mean - tgts) / scale
    z = np.abs(mean - tgts) / np.maximum(sd, 1e-9)
    q25, q50, q75 = np.percentile(np.abs(rel), [25, 50, 75])
    return {
        "forecaster": forecaster,
        "n_series": int(n_series),
        "n_eval": int(n_eval),
        "window": int(window),
        "abs_rel_err_q25": float(q25),
        "abs_rel_err_median": float(q50),
        "abs_rel_err_q75": float(q75),
        "abs_rel_err_mean": float(np.abs(rel).mean()),
        "median_abs_z": float(np.median(z)),
    }


def forecast_error_report(trace: Trace, forecaster: str, *,
                          window: int = 24, n_series: int = 16,
                          n_eval: int = 4, seed: int = 0,
                          gp=None, arima=None,
                          device: str | torch.device = "cuda") -> dict | None:
    """One forecast-error record for (trace, forecaster); None for
    forecasters with nothing to diagnose (oracle is error-free)."""
    if forecaster == "oracle":
        return None
    length = window + max(n_eval, 2) + 8
    series = sample_usage_series(trace, n_series, length, seed)
    mean, sd, tgts = rolling_forecasts(forecaster, series, window, n_eval,
                                       gp=gp, arima=arima, device=device)
    return _error_block(forecaster, mean, sd, tgts, window=window,
                        n_series=n_series, n_eval=n_eval)


def coverage_report(trace: Trace, forecaster: str, *,
                    window: int = 24, n_series: int = 16,
                    n_eval: int = 8, seed: int = 0,
                    q_levels: tuple = (0.8, 0.9, 0.95),
                    gp=None, arima=None,
                    device: str | torch.device = "cuda") -> dict | None:
    """Calibration diagnostics: Gaussian vs conformal bands per regime.

    Split-conformal evaluation on the trace's ground-truth profiles:
    rolling one-step forecasts are split by SERIES into a *calibration*
    half (whose sigma-normalized residual scores feed the conformal
    quantile — pooled across series, the engine's group tier) and an
    *evaluation* half, on which both band constructions are scored at
    each nominal level:

      * empirical coverage vs nominal (the trustworthiness gap);
      * pinball loss (proper: penalizes mis-placed bands at equal q);
      * Gaussian CRPS of the raw predictive distribution;
      * coverage of the paper's K2 = 3 sigma-band vs ITS Gaussian
        nominal (the Eq. 9 trustworthiness check).

    The split is across series, not time: series are drawn iid from the
    trace's components, so exchangeability — and with it the conformal
    coverage guarantee — holds between the halves (a temporal split
    would not be exchangeable on ramping profiles).

    Pure diagnostics — like :func:`forecast_error_report` it never
    touches the engines, so simulation results stay bit-identical.
    """
    if forecaster == "oracle":
        return None
    n_eval = max(n_eval, 4)
    n_series = max(n_series, 4)
    length = window + n_eval + 8
    series = sample_usage_series(trace, n_series, length, seed)
    mean, sd, tgts = rolling_forecasts(forecaster, series, window, n_eval,
                                       gp=gp, arima=arima, device=device)
    return _coverage_block(forecaster, mean, sd, tgts, window=window,
                           n_series=n_series, n_eval=n_eval,
                           q_levels=q_levels, device=device)


def _coverage_block(forecaster: str, mean, sd, tgts, *, window: int,
                    n_series: int, n_eval: int, q_levels: tuple,
                    device: str | torch.device = "cuda") -> dict:
    """Gaussian-vs-conformal band scoring from an existing pass, on
    ``device``."""
    from repro_torch.core.uncertainty import (ScoreBuffer, crps_gaussian,
                                              empirical_coverage,
                                              gaussian_quantile_scale,
                                              pinball_loss)

    dev = resolve_device(device)
    # rows are grouped by start, series-major within each block: row
    # (start_i, series_j) sits at  start_i * n_series + series_j
    cal_mask = np.tile(np.arange(n_series) < n_series // 2, n_eval)
    scores = ((tgts[cal_mask] - mean[cal_mask])
              / np.maximum(sd[cal_mask], 1e-9)).astype(np.float32)
    n_cal = scores.shape[0]
    ring = ScoreBuffer(1, n_cal, device=dev)
    ring.push_many(0, scores)
    ev = ~cal_mask

    def f32(x):
        return torch.as_tensor(np.asarray(x, np.float32), device=dev)

    y, m, s = f32(tgts[ev]), f32(mean[ev]), f32(sd[ev])

    levels = []
    for q in q_levels:
        zg = float(gaussian_quantile_scale(q))
        zc = float(ring.scales(np.asarray([0]), q, zg)[0])
        up_g, up_c = m + zg * s, m + zc * s
        levels.append({
            "q": float(q),
            "gaussian_scale": round(zg, 4),
            "conformal_scale": round(zc, 4),
            "gaussian_coverage": round(float(empirical_coverage(y, up_g)), 4),
            "conformal_coverage": round(float(empirical_coverage(y, up_c)), 4),
            "gaussian_pinball": float(pinball_loss(y, up_g, q)),
            "conformal_pinball": float(pinball_loss(y, up_c, q)),
        })
    # the paper's K2 = 3 band, scored against its own Gaussian nominal
    # (3-sigma ~ 0.99865): the gap is the Eq. 9 trustworthiness deficit
    k2_cov = float(empirical_coverage(y, m + 3.0 * s))
    return {
        "forecaster": forecaster,
        "window": int(window),
        "n_series": int(n_series),
        "n_eval": int(n_eval),
        "n_calib_scores": int(n_cal),
        "crps_gaussian": float(crps_gaussian(y, m, s ** 2)),
        "k2_nominal": round(K2_NOMINAL, 5),
        "k2_coverage": round(k2_cov, 5),
        "levels": levels,
    }


def forecast_reports(trace: Trace, forecaster: str, *,
                     window: int = 24, n_series: int = 16,
                     n_eval: int | None = None, seed: int = 0,
                     coverage: bool = True,
                     q_levels: tuple = (0.8, 0.9, 0.95),
                     gp=None, arima=None,
                     device: str | torch.device = "cuda"
                     ) -> tuple[dict | None, dict | None]:
    """(forecast-error report, coverage report) from ONE shared pass.

    The sweep needs both diagnostics per (scenario, forecaster) pair;
    run separately they each sample series and roll forecasts — the
    expensive part — over the same trace.  This runs a single
    ``rolling_forecasts`` pass at the coverage report's (larger)
    evaluation length and derives both records from it.  ``coverage=
    False`` skips the conformal block AND drops back to the error
    report's shorter evaluation length, so grids that sweep no
    calibration pay nothing for it.  Returns ``(None, None)`` for the
    oracle.
    """
    if forecaster == "oracle":
        return None, None
    if n_eval is None:
        n_eval = 8 if coverage else 4    # each report's standalone default
    n_eval = max(n_eval, 4) if coverage else n_eval
    n_series = max(n_series, 4) if coverage else n_series
    length = window + (n_eval if coverage else max(n_eval, 2)) + 8
    series = sample_usage_series(trace, n_series, length, seed)
    mean, sd, tgts = rolling_forecasts(forecaster, series, window, n_eval,
                                       gp=gp, arima=arima, device=device)
    err = _error_block(forecaster, mean, sd, tgts, window=window,
                       n_series=n_series, n_eval=n_eval)
    cov = None
    if coverage:
        cov = _coverage_block(forecaster, mean, sd, tgts, window=window,
                              n_series=n_series, n_eval=n_eval,
                              q_levels=q_levels, device=device)
    return err, cov
