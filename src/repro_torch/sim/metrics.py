"""Simulation metrics (paper §4.1): turnaround, resource slack, failures.

A copy of ``repro/sim/metrics.py`` (numpy only): the sweep's
aggregation over seeds (``aggregate_summaries``), the workload-shape
statistics it attaches per scenario (``trace_stats``) and
``SimResults``, with the calibration, tenancy and telemetry-ring blocks,
plus the engines' wall times.
"""
from __future__ import annotations

import dataclasses

import numpy as np

CPU, MEM = 0, 1

# summary keys the sweep aggregates across seeds (paper's Fig. 3-4 axes:
# turnaround, failures, slack / utilization)
AGGREGATE_KEYS = (
    "turnaround_mean", "turnaround_median", "turnaround_p95",
    "slack_cpu_mean", "slack_mem_mean", "util_cpu_mean", "util_mem_mean",
    "failed_frac", "failure_events", "oom_kills",
    "full_preemptions", "partial_preemptions", "completed", "sim_hours",
)


def aggregate_summaries(summaries: list[dict],
                        keys: tuple = AGGREGATE_KEYS) -> dict:
    """Mean + median of each metric across per-seed ``summary()`` dicts."""
    out: dict = {"n_seeds": len(summaries)}
    for k in keys:
        vals = np.asarray([s[k] for s in summaries], np.float64)
        out[k] = float(np.mean(vals))
        out[k + "_median"] = float(np.median(vals))
    return out


def trace_stats(trace) -> dict:
    """Workload-shape statistics of a Trace — the sweep attaches these
    per scenario so BENCH artifacts are self-describing (a reader can
    see WHAT regime produced each metric block)."""
    exists = trace.cpu_req > 0
    return {
        "n_apps": int(trace.n_apps),
        "max_components": int(trace.max_components),
        "elastic_frac": float(trace.is_elastic.mean()),
        "jumpy_frac": float(trace.is_jumpy.mean()),
        "mean_components": float(exists.sum(1).mean()),
        "elastic_comp_frac": float((exists & ~trace.is_core).sum()
                                   / max(exists.sum(), 1)),
        "runtime_mean_s": float(trace.runtime.mean()),
        "runtime_p95_s": float(np.percentile(trace.runtime, 95)),
        "arrival_makespan_h": float(trace.submit[-1] / 3600.0),
        "mem_req_mean_gb": float(trace.mem_req[exists].mean()),
        "mem_req_p95_gb": float(np.percentile(trace.mem_req[exists], 95)),
        "mean_level": float(trace.levels[exists].mean()),
    }


@dataclasses.dataclass
class SimResults:
    n_apps: int
    turnaround: dict = dataclasses.field(default_factory=dict)   # gid -> s
    failed_apps: set = dataclasses.field(default_factory=set)
    failure_events: int = 0          # uncontrolled (OS OOM) kills
    oom_kills: int = 0
    full_preemptions: int = 0        # controlled (Algorithm 1) app preemptions
    partial_preemptions: int = 0     # elastic-component preemptions
    # per-tick series
    slack_cpu: list = dataclasses.field(default_factory=list)
    slack_mem: list = dataclasses.field(default_factory=list)
    util_cpu: list = dataclasses.field(default_factory=list)
    util_mem: list = dataclasses.field(default_factory=list)
    n_running: list = dataclasses.field(default_factory=list)
    sim_time: float = 0.0
    # wall seconds per engine phase ("forecast", "policy", "total") and the
    # tick count; NOT part of summary(), which the parity tests compare
    timings: dict = dataclasses.field(default_factory=dict)
    # forecast-load telemetry of the device engine (rows past the grace
    # period vs the rows the model computed); not part of summary()
    forecast_rows: dict | None = None
    # online conformal-calibration telemetry, filled only when
    # SimConfig.calibration is enabled (and part of summary() then)
    calibration: dict | None = None
    # per-tenant fairness / SLO / credit block, filled only when
    # SimConfig.control is enabled (and part of summary() then)
    tenancy: dict | None = None
    # drained per-tick telemetry rings (repro_torch.obs.rings): field ->
    # (T,) arrays, filled by the device engine only when SimConfig.obs is
    # enabled; NOT part of summary()
    obs: dict | None = None

    def record_completion(self, gid: int, submit: float, t: float) -> None:
        self.turnaround[int(gid)] = float(t - submit)

    def record_failure(self, gid: int) -> None:
        self.failed_apps.add(int(gid))
        self.failure_events += 1

    def record_tick(self, t: float, cluster, usage: np.ndarray) -> None:
        run = cluster.running_slots()
        self.n_running.append(len(run))
        cap = cluster.host_cap.sum(0)
        used = usage.sum((0, 1))
        alloc = cluster.alloc.sum((0, 1))
        self.util_cpu.append(used[CPU] / cap[CPU])
        self.util_mem.append(used[MEM] / cap[MEM])
        # slack: (allocated - used) / allocated, cluster-aggregate (paper
        # §4.1: % allocated vs % actually used)
        self.slack_cpu.append(
            float((alloc[CPU] - used[CPU]) / alloc[CPU]) if alloc[CPU] > 0 else 0.0)
        self.slack_mem.append(
            float((alloc[MEM] - used[MEM]) / alloc[MEM]) if alloc[MEM] > 0 else 0.0)

    def finalize(self, t: float) -> None:
        self.sim_time = float(t)

    # ------------------------------------------------------------------
    def summary(self) -> dict:
        ta = np.asarray(list(self.turnaround.values()), np.float64)
        out = {
            "completed": len(self.turnaround),
            "n_apps": self.n_apps,
            "sim_hours": self.sim_time / 3600.0,
            "turnaround_mean": float(ta.mean()) if ta.size else float("nan"),
            "turnaround_median": float(np.median(ta)) if ta.size else float("nan"),
            "turnaround_p95": float(np.percentile(ta, 95)) if ta.size else float("nan"),
            "slack_cpu_mean": float(np.mean(self.slack_cpu)) if self.slack_cpu else float("nan"),
            "slack_mem_mean": float(np.mean(self.slack_mem)) if self.slack_mem else float("nan"),
            "util_cpu_mean": float(np.mean(self.util_cpu)) if self.util_cpu else float("nan"),
            "util_mem_mean": float(np.mean(self.util_mem)) if self.util_mem else float("nan"),
            "failed_frac": len(self.failed_apps) / max(self.n_apps, 1),
            "failure_events": self.failure_events,
            "oom_kills": self.oom_kills,
            "full_preemptions": self.full_preemptions,
            "partial_preemptions": self.partial_preemptions,
        }
        if self.calibration is not None:
            out["calibration"] = self.calibration
        if self.tenancy is not None:
            out["tenancy"] = self.tenancy
        return out
