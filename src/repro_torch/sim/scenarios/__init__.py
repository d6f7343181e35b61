"""Workload sources for the simulator (counterpart of
``repro.sim.scenarios``): the canonical :class:`Trace` schema, the
scenario registry, the four parametric families beyond the paper's
Google-shaped workload (``families``: diurnal, flashcrowd, heavytail,
colocated), the CSV/Parquet trace-replay adapter (``replay``), the
family fitted to a replayed trace (``fitting``), streamed ingestion in a
bounded device window (``stream``) and the per-scenario forecast
diagnostics (``diagnostics``).

    from repro_torch.sim.scenarios import build_trace, make_config
    tr = build_trace(make_config("flashcrowd", n_apps=200, seed=1))
"""
from repro_torch.sim.scenarios import families as _families          # noqa: F401
from repro_torch.sim.scenarios import replay as _replay              # noqa: F401
from repro_torch.sim.scenarios.diagnostics import (coverage_report, forecast_error_report,
                                                   forecast_reports, sample_usage_series)
from repro_torch.sim.scenarios.families import (ColocatedConfig, DiurnalConfig,
                                                FlashcrowdConfig, HeavytailConfig)
from repro_torch.sim.scenarios.fitting import FittedConfig, fit_trace
from repro_torch.sim.scenarios.registry import (ScenarioSpec, build_trace, get,
                                                make_config, register,
                                                scenario_names, scenario_of)
from repro_torch.sim.scenarios.replay import ReplayConfig, load_trace, save_trace
from repro_torch.sim.scenarios.schema import (SEGMENTS, SLO_CLASSES, Trace,
                                              TraceValidationError, sort_by_submit)
from repro_torch.sim.scenarios.stream import StreamConfig, run_sim_stream

__all__ = [
    "SEGMENTS", "SLO_CLASSES", "Trace", "TraceValidationError", "sort_by_submit",
    "ScenarioSpec", "register", "get", "scenario_names", "scenario_of",
    "make_config", "build_trace",
    "DiurnalConfig", "FlashcrowdConfig", "HeavytailConfig",
    "ColocatedConfig", "ReplayConfig", "load_trace", "save_trace",
    "FittedConfig", "fit_trace", "StreamConfig", "run_sim_stream",
    "coverage_report", "forecast_error_report", "forecast_reports",
    "sample_usage_series",
]
