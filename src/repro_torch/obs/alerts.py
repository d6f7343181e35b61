"""Alert rules over drained telemetry: the watchdog the sweep runs.

``repro_torch.obs.analyze`` turns ring histories into detections; this module
decides which detections *matter*.  An :class:`AlertRule` binds one
detector to one channel with a threshold and severity; the sweep driver
evaluates the rule set per cell (post-drain — the fused tick never sees
any of this) and threads fired alerts into:

  * the per-cell ``obs`` summary block (``rec["obs"]["alerts"]``),
  * the run manifest (an un-hashed ``alerts`` extra, so manifest
    verification is unaffected),
  * the global :data:`repro_torch.obs.metrics.REGISTRY`
    (``alerts.fired{rule,severity}`` labeled counters),
  * a JSONL alert log next to the metrics export
    (:func:`write_alert_log`),
  * the rendered dashboard (``repro_torch.obs.dashboard`` highlights each
    alert's tick window on the channel's sparkline).

Rule thresholds in :data:`DEFAULT_RULES` were tuned against measured
baselines (google / flashcrowd scenario cells at CI scale, 50-300
ticks): the quiet google cells fire nothing, an injected OOM burst or
forced coverage drift fires within its rule window — the reference's
benchmarks/obs.py asserts exactly that as BENCH_obs criteria.

A copy of ``repro/obs/alerts.py``, with the port's own
``control/config.py`` SLO classes and budget.
"""
from __future__ import annotations

import dataclasses
import json
import time

import numpy as np

from repro_torch.control.config import SLO_BUDGET, SLO_CLASSES
from repro_torch.obs.analyze import (Detection, burn_rate_detect, burst_detect,
                               coverage_drift_detect, cusum_detect,
                               ewma_detect)
from repro_torch.obs.metrics import REGISTRY

__all__ = ["AlertRule", "DEFAULT_RULES", "SEVERITIES", "evaluate_rules",
           "run_rule", "write_alert_log"]

#: Severity ladder, weakest first.  ``page`` is the "wake a human"
#: tier; the dashboard renders it as critical.
SEVERITIES = ("info", "warn", "page")

_DETECTORS = ("ewma", "cusum", "burst", "coverage", "burn", "tenant_burn")


@dataclasses.dataclass(frozen=True)
class AlertRule:
    """One watchdog rule: a detector bound to a channel.

    ``channel`` names a ring field for ewma/cusum/burst; the derived
    channels are ``coverage`` (cov_resolved + cov_errors rings) and
    ``slo_burn`` (bad = fail + oom, exposure = admitted).  Zero-valued
    window fields mean "use the detector default".  Frozen + hashable,
    like every config object in this repo, so rule sets can live in
    frozen sweep configs.
    """

    name: str
    channel: str
    detector: str
    threshold: float
    severity: str = "warn"
    window: int = 0          # burst / coverage / short burn window
    long_window: int = 0     # burn only
    warmup: int = 0          # ewma / cusum
    budget: float = 0.0      # burn / tenant_burn (0 -> SLO_BUDGET default)

    def __post_init__(self):
        if self.detector not in _DETECTORS:
            raise ValueError(f"unknown detector {self.detector!r}; "
                             f"expected one of {_DETECTORS}")
        if self.severity not in SEVERITIES:
            raise ValueError(f"unknown severity {self.severity!r}; "
                             f"expected one of {SEVERITIES}")


#: The stock rule set the sweep driver evaluates when none is given.
#: Thresholds carry margin over measured quiet-cell statistics (e.g.
#: flashcrowd's natural failure ramp peaks at 7 events / 16 ticks, so
#: the failure-burst threshold sits at 12; the google queue channel's
#: EWMA residual peaks at ~11 sigmas during its backlog drain, so the
#: queue rule sits at 20).  The shift rules use EWMA charts rather
#: than CUSUM: CI-scale runs ramp up and drain down by design, and a
#: CUSUM chart integrates that trend into a guaranteed false alarm —
#: the EWMA mean tracks slow ramps and alarms only on abrupt jumps.
#: CUSUM stays available for stationary channels via custom rules.
#: Warmups are sized for CI-scale runs (50+ ticks).
DEFAULT_RULES = (
    AlertRule("oom-burst", "oom", "burst", threshold=8.0,
              severity="page", window=16),
    AlertRule("failure-burst", "fail", "burst", threshold=12.0,
              severity="page", window=16),
    AlertRule("preempt-burst", "preempt", "burst", threshold=24.0,
              severity="warn", window=16),
    AlertRule("queue-shift", "queue", "ewma", threshold=20.0,
              severity="warn", warmup=24),
    AlertRule("gap-cpu-shift", "gap_cpu", "ewma", threshold=10.0,
              severity="warn", warmup=24),
    AlertRule("util-cpu-shift", "used_cpu", "ewma", threshold=12.0,
              severity="info", warmup=24),
    AlertRule("coverage-drift", "coverage", "coverage", threshold=4.0,
              severity="page", window=128),
    AlertRule("slo-burn", "slo_burn", "burn", threshold=4.0,
              severity="page", window=32, long_window=128, budget=0.05),
    AlertRule("tenant-slo-burn", "slo_burn", "tenant_burn",
              threshold=4.0, severity="warn"),
)


def run_rule(rule: AlertRule, history: dict, *,
             nominal_q: float = 0.9) -> Detection | None:
    """Evaluate one rule against a drained history.

    Returns ``None`` when the rule's channel is absent from the
    history (tenancy channels on a tenancy-off run still exist as
    zeros, so in practice only malformed histories skip).
    """
    if rule.detector == "coverage":
        if "cov_resolved" not in history:
            return None
        return coverage_drift_detect(
            history["cov_resolved"], history["cov_errors"],
            nominal=nominal_q, threshold=rule.threshold,
            window=rule.window or 256, min_resolved=32,
            channel="coverage")
    if rule.detector == "burn":
        if "fail" not in history or "admitted" not in history:
            return None
        bad = (np.asarray(history["fail"], np.float64)
               + np.asarray(history["oom"], np.float64))
        return burn_rate_detect(
            bad, history["admitted"],
            budget=rule.budget or SLO_BUDGET[0],
            threshold=rule.threshold, window=rule.window or 64,
            long_window=rule.long_window or 512, channel="slo_burn")
    x = history.get(rule.channel)
    if x is None:
        return None
    if rule.detector == "burst":
        return burst_detect(x, threshold=rule.threshold,
                            window=rule.window or 16,
                            channel=rule.channel)
    if rule.detector == "cusum":
        return cusum_detect(x, threshold=rule.threshold,
                            warmup=rule.warmup or 64,
                            channel=rule.channel)
    if rule.detector == "ewma":
        return ewma_detect(x, threshold=rule.threshold,
                           warmup=rule.warmup or 64,
                           channel=rule.channel)
    return None


def _tenant_burn_alerts(rule: AlertRule, tenancy: dict) -> list[dict]:
    """Per-tenant run-level SLO burn from the tenancy summary block.

    The rings are cluster-aggregate, so per-tenant attribution uses the
    run-level ``slo_met_frac`` per tenant: ``burn = (1 - met) /
    budget(class)``.  Tenants with no completions (NaN met-fraction)
    are skipped — no evidence, no page.
    """
    fired = []
    met = tenancy.get("slo_met_frac", [])
    classes = tenancy.get("slo_class", [0] * len(met))
    for t, m in enumerate(met):
        if m is None or (isinstance(m, float) and np.isnan(m)):
            continue
        cls = int(classes[t]) if t < len(classes) else 0
        budget = rule.budget or SLO_BUDGET[cls]
        burn = (1.0 - float(m)) / budget
        if burn > rule.threshold:
            fired.append({
                "rule": rule.name, "channel": "slo_burn",
                "detector": "tenant_burn", "severity": rule.severity,
                "threshold": round(rule.threshold, 4),
                "peak_stat": round(burn, 4),
                "tenant": t, "slo_class": SLO_CLASSES[cls],
                "n_alarms": 1, "first_tick": None, "last_tick": None,
            })
    return fired


def evaluate_rules(history: dict, rules=DEFAULT_RULES, *,
                   nominal_q: float = 0.9, tenancy: dict | None = None,
                   registry=REGISTRY) -> list[dict]:
    """Evaluate a rule set against one cell's drained history.

    Returns the FIRED alerts as typed records (rule / channel /
    detector / severity / threshold / peak_stat / tick window), ready
    for the manifest and the JSONL log.  Each fired alert increments
    the labeled ``alerts.fired{rule,severity}`` counter; the
    ``alerts.evaluated`` counter ticks per rule regardless, so "zero
    alerts" is distinguishable from "watchdog never ran".
    """
    fired: list[dict] = []
    for rule in rules:
        if rule.detector == "tenant_burn":
            if tenancy:
                hits = _tenant_burn_alerts(rule, tenancy)
                if registry is not None:
                    registry.counter("alerts.evaluated").inc()
                fired.extend(hits)
            continue
        det = run_rule(rule, history, nominal_q=nominal_q)
        if det is None:
            continue
        if registry is not None:
            registry.counter("alerts.evaluated").inc()
        if det.fired:
            rec = det.to_dict()
            rec["rule"] = rule.name
            rec["severity"] = rule.severity
            fired.append(rec)
    if registry is not None:
        for rec in fired:
            registry.counter("alerts.fired", rule=rec["rule"],
                             severity=rec["severity"]).inc()
    return fired


def write_alert_log(path: str, alerts: list[dict], *, cell: str = "",
                    run_id: str = "") -> None:
    """Append fired alerts as JSONL, one record per alert (the same
    append-only convention as ``MetricsRegistry.write_jsonl`` — sweep
    reruns accumulate, nothing is overwritten)."""
    if not alerts:
        return
    with open(path, "a") as f:
        for rec in alerts:
            line = {"ts": time.time(), "cell": cell, "run_id": run_id,
                    **rec}
            f.write(json.dumps(line, sort_keys=True) + "\n")
