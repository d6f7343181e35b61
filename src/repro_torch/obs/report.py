"""Telemetry reports: turn drained rings / collected counters into the
compact summaries that sweep cells, manifests, and BENCH artifacts carry.

A copy of ``repro/obs/report.py``.
"""
from __future__ import annotations

import numpy as np

__all__ = ["bucketed_row_overhead", "masked_row_overhead",
           "obs_summary", "compact_history"]


def masked_row_overhead(rows: dict) -> float:
    """Padded-vs-compact forecast cost ratio from ``forecast_rows``
    telemetry: the batch rows a padded forecaster evaluates across the
    ticks that actually invoked the model, over the rows that were
    genuinely ready.  >1 means masked rows are being paid for; the
    BENCH_engine ``gp`` block reports this as ``masked_row_overhead``
    (~6.7x on the tiny GP cell — ROADMAP item 3's ragged-batch target).
    """
    return (rows["rows_batch"] * rows["ticks_forecasting"]
            / max(rows["rows_ready"], 1))


def bucketed_row_overhead(rows: dict) -> float:
    """Computed-vs-ready forecast cost ratio under ragged bucketing:
    the rows the model ACTUALLY evaluated (``rows_bucketed`` — passes x
    bucket batch; equal to the full padded cost when un-bucketed) over
    the rows that were genuinely ready.  The bucketed scan path targets
    <= 2x where the padded batch pays ~6.7x (the BENCH_engine ``gp``
    block asserts this)."""
    return rows.get("rows_bucketed", 0) / max(rows["rows_ready"], 1)


def obs_summary(history: dict) -> dict:
    """Collapse one member's drained ring history (``SimResults.obs``)
    into scalar telemetry for sweep-cell records and manifests.

    Event rings (oom/fail/preempt/admitted/throttled/cov_*) are per-tick
    deltas, so their SUM is the run total; level rings (used/queue/gap/
    credit) report means and peaks.
    """
    t = int(history["queue"].shape[0]) if history else 0
    if t == 0:
        return {"ticks": 0}
    out = {"ticks": t}
    for name in ("oom", "fail", "preempt", "admitted", "throttled",
                 "cov_resolved", "cov_errors"):
        out[f"{name}_total"] = int(history[name].sum())
    for name in ("used_cpu", "used_mem", "gap_cpu", "gap_mem", "credit"):
        out[f"{name}_mean"] = float(history[name].mean())
    out["queue_mean"] = float(history["queue"].mean())
    out["queue_peak"] = int(history["queue"].max())
    out["gap_cpu_peak"] = float(history["gap_cpu"].max(initial=0.0))
    res = out["cov_resolved_total"]
    # guard the zero-resolved case explicitly: a short run that never
    # resolves a forecast must omit the key rather than divide by zero
    # and leak NaN into the cell summary / manifest
    if res > 0:
        out["coverage"] = round(1.0 - out["cov_errors_total"] / res, 4)
    return out


def compact_history(history: dict, max_points: int = 512) -> dict:
    """Downsample a drained history for artifact embedding (dashboard
    sparklines): every channel is bucketed to at most ``max_points``.

    Event channels (per-tick deltas) SUM within each bucket so run
    totals survive the downsampling exactly; level channels take the
    bucket MEAN.  The stride is recorded so alert tick coordinates map
    onto bucket indices (``tick // stride``).
    """
    if not history:
        return {"ticks": 0, "stride": 1, "channels": {}}
    t = int(next(iter(history.values())).shape[0])
    stride = max(1, -(-t // max_points))        # ceil div
    n = -(-t // stride)
    event = {"oom", "fail", "preempt", "admitted", "throttled",
             "cov_resolved", "cov_errors"}
    channels = {}
    for name, x in history.items():
        x = np.asarray(x, np.float64)
        pad = np.full(n * stride, np.nan)
        pad[:t] = x
        buckets = pad.reshape(n, stride)
        if name in event:
            y = np.nansum(buckets, axis=1)
        else:
            y = np.nanmean(buckets, axis=1)
        channels[name] = [round(float(v), 4) for v in y]
    return {"ticks": t, "stride": stride, "channels": channels}
