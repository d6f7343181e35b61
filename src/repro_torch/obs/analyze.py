"""Streaming telemetry analysis: detectors over drained ring histories.

The telemetry rings record 13 per-tick channels (``SimResults.obs``) but
nothing consumed them — a coverage drift or an OOM burst in a large
sweep was invisible unless a human grepped histories.  This module
turns histories into *detections*: every detector is vectorized NumPy
over the post-drain ``field -> (T,)`` arrays, so the fused tick is
untouched and obs-off / obs-on bit-identity holds unchanged.

Detectors (each returns a :class:`Detection`):

  * :func:`ewma_detect` — EWMA control chart: residuals of the series
    against its exponentially-weighted mean, scaled by a robust (MAD)
    sigma estimated on the warmup prefix.  Catches level shifts in
    utilization / queue-depth / demand-gap channels.
  * :func:`cusum_detect` — two-sided standardized CUSUM.  The
    recursion ``S[t] = max(0, S[t-1] + z[t] - k)`` is computed in
    closed form as a cumulative sum minus its running minimum, so the
    whole chart is two ``np.cumsum`` calls.  Catches slow drifts the
    EWMA chart's per-tick residual misses.
  * :func:`burst_detect` — rolling-window event-count burst on the
    oom / fail / preempt counter channels.
  * :func:`coverage_drift_detect` — rolling realized conformal
    coverage vs the nominal quantile with a binomial-sigma band
    (under-coverage is the alarm direction: the safeguard is supposed
    to *hold* nominal).
  * :func:`burn_rate_detect` — SRE-style multi-window SLO burn rate:
    the bad-event fraction of a short AND a long trailing window must
    both exceed ``threshold`` times the error budget (the short window
    makes the alert fast, the long window keeps it from flapping).

Alarm indices are tick coordinates into the drained history, so the
dashboard can highlight the exact windows on the sparklines.

A copy of ``repro/obs/analyze.py``.
"""
from __future__ import annotations

import dataclasses
import math

import numpy as np

__all__ = ["Detection", "ewma", "rolling_sum", "ewma_detect",
           "cusum_detect", "burst_detect", "coverage_drift_detect",
           "burn_rate_detect"]


@dataclasses.dataclass
class Detection:
    """One detector's verdict over one channel's history.

    ``fired`` iff any tick alarmed; ``first_tick`` / ``last_tick``
    bound the alarm region (tick coordinates into the drained
    history); ``peak_stat`` is the detector statistic's maximum —
    comparable against ``threshold`` in the same unit (sigmas for
    ewma/cusum/coverage, events for burst, budget multiples for burn).
    """

    detector: str
    channel: str
    fired: bool
    threshold: float
    peak_stat: float = 0.0
    n_ticks: int = 0          # ticks analyzed
    n_alarms: int = 0         # ticks past threshold
    first_tick: int | None = None
    last_tick: int | None = None

    def to_dict(self) -> dict:
        d = dataclasses.asdict(self)
        d["peak_stat"] = round(float(d["peak_stat"]), 4)
        d["threshold"] = round(float(d["threshold"]), 4)
        return d


def _finish(det: Detection, stat: np.ndarray, ticks: np.ndarray,
            threshold: float) -> Detection:
    """Fill a Detection from per-tick statistic values and their tick
    coordinates (``stat`` and ``ticks`` are parallel arrays)."""
    det.n_alarms = int((stat > threshold).sum())
    det.peak_stat = float(stat.max()) if stat.size else 0.0
    if det.n_alarms:
        hit = ticks[stat > threshold]
        det.fired = True
        det.first_tick = int(hit[0])
        det.last_tick = int(hit[-1])
    return det


def ewma(x: np.ndarray, alpha: float = 0.2) -> np.ndarray:
    """Exponentially-weighted moving average, exact and loop-free.

    Within a block, ``y[i] = d^(i+1) y_prev + a d^i cumsum(d^-j x[j])``
    (``d = 1 - alpha``); the block length is capped so ``d^-j`` stays
    finite, which keeps the closed form numerically exact while doing
    per-block vector work instead of a per-tick Python loop.
    """
    if not 0.0 < alpha <= 1.0:
        raise ValueError(f"alpha must be in (0, 1], got {alpha}")
    x = np.asarray(x, np.float64)
    out = np.empty(x.size)
    if x.size == 0:
        return out
    d = 1.0 - alpha
    if d == 0.0:
        return x.copy()
    block = max(8, min(512, int(650.0 / max(-math.log(d), 1e-3))))
    out[0] = prev = x[0]
    i = 1
    while i < x.size:
        xs = x[i:i + block]
        n = xs.size
        j = np.arange(n)
        y = d ** (j + 1) * prev + alpha * d ** j * np.cumsum(d ** -j * xs)
        out[i:i + n] = y
        prev = y[-1]
        i += n
    return out


def rolling_sum(x: np.ndarray, window: int) -> np.ndarray:
    """Trailing-window sums: element ``i`` covers ticks
    ``[i, i + window)`` — length ``T - window + 1``."""
    if window < 1:
        raise ValueError("window must be >= 1")
    x = np.asarray(x, np.float64)
    c = np.concatenate([[0.0], np.cumsum(x)])
    return c[window:] - c[:-window]


def _robust_sigma(r: np.ndarray) -> float:
    """MAD-based sigma (1.4826 * median absolute deviation)."""
    if r.size == 0:
        return 0.0
    return 1.4826 * float(np.median(np.abs(r - np.median(r))))


def ewma_detect(x, *, threshold: float = 8.0, alpha: float = 0.2,
                warmup: int = 64, channel: str = "") -> Detection:
    """EWMA control chart: alarm where the one-step residual
    ``|x[t] - ewma(x)[t-1]|`` exceeds ``threshold`` robust sigmas.

    Sigma is the MAD of the warmup-prefix residuals, floored by a
    fraction of the whole series' residual MAD (so a dead-flat warmup
    on an integer channel does not turn single-count noise into
    alarms) and by an absolute epsilon scaled to the series magnitude.
    """
    det = Detection("ewma", channel, False, threshold)
    x = np.asarray(x, np.float64)
    det.n_ticks = x.size
    if x.size < 2 * warmup:
        return det
    resid = x[1:] - ewma(x, alpha)[:-1]
    eps = 1e-9 + 1e-3 * float(np.mean(np.abs(x)))
    sigma = max(_robust_sigma(resid[:warmup]),
                0.25 * _robust_sigma(resid), eps)
    z = np.abs(resid[warmup:]) / sigma
    ticks = np.arange(warmup + 1, x.size)
    return _finish(det, z, ticks, threshold)


def cusum_detect(x, *, threshold: float = 10.0, drift: float = 0.5,
                 warmup: int = 64, channel: str = "") -> Detection:
    """Two-sided standardized CUSUM changepoint chart.

    ``x`` is standardized against the warmup prefix (robust location /
    scale); the one-sided statistic ``S[t] = max(0, S[t-1] + z[t] -
    drift)`` equals ``cumsum(z - drift)`` minus its running minimum,
    so both sides are vectorized exactly.  ``threshold`` and ``drift``
    are in sigmas.
    """
    det = Detection("cusum", channel, False, threshold)
    x = np.asarray(x, np.float64)
    det.n_ticks = x.size
    if x.size < 2 * warmup:
        return det
    base = x[:warmup]
    eps = 1e-9 + 1e-3 * float(np.mean(np.abs(x)))
    sigma = max(_robust_sigma(base), 0.25 * _robust_sigma(x), eps)
    z = (x - float(np.median(base))) / sigma
    up = np.cumsum(z - drift)
    s_up = up - np.minimum.accumulate(np.concatenate([[0.0], up]))[1:]
    dn = np.cumsum(-z - drift)
    s_dn = dn - np.minimum.accumulate(np.concatenate([[0.0], dn]))[1:]
    stat = np.maximum(s_up, s_dn)[warmup:]
    ticks = np.arange(warmup, x.size)
    return _finish(det, stat, ticks, threshold)


def burst_detect(x, *, threshold: float = 8.0, window: int = 16,
                 channel: str = "") -> Detection:
    """Event burst: alarm where the trailing ``window``-tick event
    count exceeds ``threshold`` (strictly).  Alarm ticks are the
    window END, so a burst is reported no later than ``window - 1``
    ticks after its last contributing event."""
    det = Detection("burst", channel, False, threshold)
    x = np.asarray(x, np.float64)
    det.n_ticks = x.size
    if x.size < window:
        return det
    s = rolling_sum(x, window)
    ticks = np.arange(window - 1, x.size)
    return _finish(det, s, ticks, threshold)


def coverage_drift_detect(resolved, errors, *, nominal: float = 0.9,
                          threshold: float = 4.0, window: int = 256,
                          min_resolved: int = 64,
                          channel: str = "coverage") -> Detection:
    """Conformal coverage drift: rolling realized coverage vs the
    nominal quantile, standardized by the binomial sigma
    ``sqrt(q (1-q) / n)`` of the window's resolved count.

    Alarms on UNDER-coverage only (realized below nominal): the
    calibrated safeguard's contract is to hold nominal, and
    over-coverage merely means conservative shaping.  Windows with
    fewer than ``min_resolved`` resolutions are skipped — early ticks
    resolve nothing while forecasts are still outstanding.
    """
    det = Detection("coverage", channel, False, threshold)
    resolved = np.asarray(resolved, np.float64)
    errors = np.asarray(errors, np.float64)
    det.n_ticks = resolved.size
    if resolved.size < window:
        window = max(int(resolved.size), 1)
    if resolved.size == 0:
        return det
    rs = rolling_sum(resolved, window)
    es = rolling_sum(errors, window)
    n = np.maximum(rs, 1.0)
    cov = 1.0 - es / n
    z = (nominal - cov) / np.sqrt(nominal * (1.0 - nominal) / n)
    valid = rs >= min_resolved
    ticks = np.arange(window - 1, resolved.size)
    return _finish(det, z[valid], ticks[valid], threshold)


def burn_rate_detect(bad, exposure, *, budget: float = 0.05,
                     threshold: float = 4.0, window: int = 64,
                     long_window: int = 512,
                     channel: str = "slo_burn") -> Detection:
    """Multi-window SLO burn rate (SRE style).

    ``burn(w) = (bad events / exposure events in the trailing window)
    / budget``; a tick alarms when BOTH the short and the long window
    burn above ``threshold``.  The short window bounds detection
    latency; the long window stops a single bad tick from paging.
    Windows longer than the run are clamped to it (short runs still
    evaluate, over their whole length).
    """
    det = Detection("burn", channel, False, threshold)
    bad = np.asarray(bad, np.float64)
    exposure = np.asarray(exposure, np.float64)
    det.n_ticks = bad.size
    if budget <= 0:
        raise ValueError("budget must be positive")
    long_window = min(long_window, bad.size) or 1
    window = min(window, long_window)
    if bad.size < long_window or long_window < 1:
        return det
    bs = rolling_sum(bad, window)
    es = np.maximum(rolling_sum(exposure, window), 1.0)
    bl = rolling_sum(bad, long_window)
    el = np.maximum(rolling_sum(exposure, long_window), 1.0)
    # align both windows on their shared END tick
    off = long_window - window
    burn_s = (bs[off:] / es[off:]) / budget
    burn_l = (bl / el) / budget
    stat = np.minimum(burn_s, burn_l)    # both windows must burn
    ticks = np.arange(long_window - 1, bad.size)
    return _finish(det, stat, ticks, threshold)
