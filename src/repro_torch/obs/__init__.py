"""repro_torch.obs — the observability plane (counterpart of ``repro.obs``).

Spans device and host:

  * :mod:`repro_torch.obs.rings` — the device engine's per-tick telemetry
    rings (``ObsState``, absent when disabled), one ``ops.obs_tick``
    launch a tick, drained at chunk boundaries;
  * :mod:`repro_torch.obs.trace` — host span tracing to Chrome
    trace-event / Perfetto JSON;
  * :mod:`repro_torch.obs.metrics` — process metrics registry (counters /
    gauges / histograms) with JSONL + Prometheus-textfile export;
  * :mod:`repro_torch.obs.timing` — the shared benchmark timers;
  * :mod:`repro_torch.obs.manifest` — run manifests with round-trippable
    config hashes;
  * :mod:`repro_torch.obs.report` — ring-history and forecast-rows
    summaries;
  * :mod:`repro_torch.obs.analyze` — vectorized post-drain detectors
    (EWMA / CUSUM / burst / coverage-drift / SLO burn-rate) over ring
    histories;
  * :mod:`repro_torch.obs.alerts` — the alert-rule watchdog;
  * :mod:`repro_torch.obs.dashboard` — stdlib-only static HTML report
    from run artifacts.

Every module but the rings is a stdlib/numpy copy of the reference's.
Nothing here imports ``repro_torch.sim`` (the simulation imports us).
"""
from repro_torch.obs.alerts import DEFAULT_RULES, AlertRule, evaluate_rules, write_alert_log
from repro_torch.obs.analyze import (Detection, burn_rate_detect, burst_detect,
                                     coverage_drift_detect, cusum_detect, ewma_detect)
from repro_torch.obs.config import ObsConfig
from repro_torch.obs.dashboard import render_dashboard
from repro_torch.obs.manifest import (build_manifest, cell_hash, config_hash, load_manifest,
                                      write_manifest)
from repro_torch.obs.metrics import REGISTRY, MetricsRegistry
from repro_torch.obs.report import (bucketed_row_overhead, compact_history,
                                    masked_row_overhead, obs_summary)
from repro_torch.obs.timing import best_of, time_us
from repro_torch.obs.trace import Tracer, current_tracer, span, tracing, validate_trace

__all__ = [
    "ObsConfig",
    "REGISTRY", "MetricsRegistry",
    "Tracer", "span", "tracing", "current_tracer", "validate_trace",
    "best_of", "time_us",
    "config_hash", "cell_hash", "build_manifest", "write_manifest",
    "load_manifest",
    "masked_row_overhead", "bucketed_row_overhead",
    "obs_summary", "compact_history",
    "Detection", "ewma_detect", "cusum_detect", "burst_detect",
    "coverage_drift_detect", "burn_rate_detect",
    "AlertRule", "DEFAULT_RULES", "evaluate_rules", "write_alert_log",
    "render_dashboard",
]
