"""Device-resident simulation state (the scan engine's slot table).

Counterpart of ``repro/sim/state.py``.  The host engine
(:mod:`repro_torch.sim.engine`) keeps cluster state in numpy; the device
engine (:mod:`repro_torch.sim.step`) keeps the same padded slot table as
tensors on the card, so a whole chunk of ticks runs without reading
anything back:

  * :class:`DeviceTrace` — the immutable workload columns, uploaded once
    per run;
  * :class:`SimState`    — everything that evolves per tick: slot table,
    monitor rings, FIFO-queue membership, per-app telemetry, counters,
    with calibration on the conformal score rings
    (:class:`~repro_torch.core.uncertainty.CalibState`) and with the
    control plane on the tenant counters
    (:class:`~repro_torch.control.TenantState`);
  * :class:`TickMetrics` — the per-tick outputs, stacked on the device
    and read at chunk boundaries;
  * :func:`drain_results` — folds one member's final state and metrics
    into :class:`~repro_torch.sim.metrics.SimResults`.

Every tensor carries a leading member axis S where the reference adds a
``vmap`` axis for seed cohorts: a solo run has S = 1, a cohort stacks
its members, and every phase and kernel treats members independently.
Integer state is int32 as in the reference.  ``calib`` is ``None``
unless calibration is on, ``tenancy`` unless the control plane is (and
``calib`` then has the per-tenant tier), ``obs`` (the telemetry rings,
:class:`~repro_torch.obs.rings.ObsState`) unless ``SimConfig.obs`` is.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.control import TenantState, control_init, tenancy_summary
from repro_torch.core.uncertainty import (CalibState, calib_group_report, calib_init,
                                          calib_report)
from repro_torch.obs.rings import ObsState, obs_init
from repro_torch.sim.metrics import SimResults

CPU, MEM = 0, 1


def round_up(n: int, multiple: int) -> int:
    """Smallest multiple of ``multiple`` that is >= ``n``."""
    return -(-n // multiple) * multiple


@dataclasses.dataclass(frozen=True)
class DeviceTrace:
    """Immutable workload columns on the device, (S, ...) per field.

    Mirrors :class:`~repro_torch.sim.scenarios.schema.Trace`; ``exists``
    is precomputed (``cpu_req > 0``) because every tick needs it."""

    submit: torch.Tensor     # (S, N) f32 nondecreasing arrival times
    runtime: torch.Tensor    # (S, N) f32 base runtime
    cpu_req: torch.Tensor    # (S, N, C) f32 per-component reservation
    mem_req: torch.Tensor    # (S, N, C) f32
    is_core: torch.Tensor    # (S, N, C) bool
    is_jumpy: torch.Tensor   # (S, N) bool
    levels: torch.Tensor     # (S, N, C, SEGMENTS, 2) f32 utilization knots
    exists: torch.Tensor     # (S, N, C) bool == cpu_req > 0
    tenant: torch.Tensor     # (S, N) i32
    gid: torch.Tensor        # (S, N) i32 global app id (the row index of a
    #                          materialized trace; a streamed window's rows
    #                          hold apps of any id, free rows 0)

    @classmethod
    def from_columns(cls, device, **cols) -> "DeviceTrace":
        """One member's trace from its numpy columns, ``gid`` among them
        (``sim/scenarios/stream.py``'s window); ``exists`` is derived."""
        dt = dict(submit=np.float32, runtime=np.float32, cpu_req=np.float32,
                  mem_req=np.float32, is_core=bool, is_jumpy=bool, levels=np.float32,
                  tenant=np.int32, gid=np.int32)

        def col(x, t):
            return torch.from_numpy(np.ascontiguousarray(x, t)[None]).to(device)
        return cls(exists=col(cols["cpu_req"] > 0, bool),
                   **{k: col(cols[k], t) for k, t in dt.items()})

    @classmethod
    def from_traces(cls, wls, device) -> "DeviceTrace":
        """Stack traces of one shape on the host, one upload per field."""
        wls = list(wls)

        def col(f, dt):
            return torch.from_numpy(np.stack([np.asarray(f(w), dt) for w in wls])
                                    ).to(device)
        return cls(
            submit=col(lambda w: w.submit, np.float32),
            runtime=col(lambda w: w.runtime, np.float32),
            cpu_req=col(lambda w: w.cpu_req, np.float32),
            mem_req=col(lambda w: w.mem_req, np.float32),
            is_core=col(lambda w: w.is_core, bool),
            is_jumpy=col(lambda w: w.is_jumpy, bool),
            levels=col(lambda w: w.levels, np.float32),
            exists=col(lambda w: w.cpu_req > 0, bool),
            tenant=col(lambda w: w.tenant, np.int32),
            gid=col(lambda w: np.arange(len(np.asarray(w.submit))), np.int32))


@dataclasses.dataclass(frozen=True)
class SimState:
    """Everything that evolves per tick.  A = slot-table apps, C =
    components, N = trace apps, W = monitor window; monitor rows are flat
    ``slot * C + comp`` exactly like the host monitor."""

    # cluster slot table
    slot_gid: torch.Tensor       # (S, A) i32, -1 = empty
    work_done: torch.Tensor      # (S, A) f32
    comp_running: torch.Tensor   # (S, A, C) bool
    comp_host: torch.Tensor      # (S, A, C) i32
    alloc: torch.Tensor          # (S, A, C, 2) f32
    alive_since: torch.Tensor    # (S, A, C) f32
    # monitor rings
    mon_buf: torch.Tensor        # (S, A*C, W, 2) f32, oldest first
    mon_count: torch.Tensor      # (S, A*C) i32 samples seen per row
    # application lifecycle (the FIFO queue is the `queued` mask, ordered
    # by (submit, gid) ascending)
    arrived: torch.Tensor        # (S, N) bool
    queued: torch.Tensor         # (S, N) bool
    done: torch.Tensor           # (S, N) bool
    failed: torch.Tensor         # (S, N) bool — ever OOM/conflict-failed
    finish_t: torch.Tensor       # (S, N) f32 completion time (0 until done)
    saved_work: torch.Tensor     # (S, N) f32 checkpointed progress
    has_saved: torch.Tensor      # (S, N) bool
    # counters / clock
    t: torch.Tensor              # (S,) f32 sim time
    failure_events: torch.Tensor       # (S,) i32
    oom_kills: torch.Tensor            # (S,) i32
    full_preemptions: torch.Tensor     # (S,) i32
    partial_preemptions: torch.Tensor  # (S,) i32
    # conformal calibration rings (None when calibration is off)
    calib: CalibState | None = None
    # tenant counters (None when the control plane is off)
    tenancy: TenantState | None = None
    # per-tick telemetry rings (None when SimConfig.obs is off)
    obs: ObsState | None = None


def init_state(cfg, n_apps: int, max_components: int, batch: int,
               device) -> SimState:
    """Fresh state for ``batch`` simulations of ``cfg`` on ``device``."""
    A, C, N, W, S = (cfg.cluster.max_running_apps, max_components, n_apps,
                     cfg.window, batch)

    def z(*shape, dtype):
        return torch.zeros((S,) + shape, dtype=dtype, device=device)

    i32, f32, b = torch.int32, torch.float32, torch.bool
    ctl = cfg.control.enabled
    calib = None
    if cfg.calibration.enabled and cfg.forecaster != "oracle":
        calib = calib_init(2 * A * C, cfg.calibration, S, device,
                           n_groups=cfg.control.max_tenants if ctl else 0)
    return SimState(
        slot_gid=torch.full((S, A), -1, dtype=i32, device=device),
        work_done=z(A, dtype=f32), comp_running=z(A, C, dtype=b),
        comp_host=z(A, C, dtype=i32), alloc=z(A, C, 2, dtype=f32),
        alive_since=z(A, C, dtype=f32),
        mon_buf=z(A * C, W, 2, dtype=f32), mon_count=z(A * C, dtype=i32),
        arrived=z(N, dtype=b), queued=z(N, dtype=b), done=z(N, dtype=b),
        failed=z(N, dtype=b), finish_t=z(N, dtype=f32),
        saved_work=z(N, dtype=f32), has_saved=z(N, dtype=b),
        t=z(dtype=f32), failure_events=z(dtype=i32), oom_kills=z(dtype=i32),
        full_preemptions=z(dtype=i32), partial_preemptions=z(dtype=i32), calib=calib,
        tenancy=control_init(cfg.control, S, device) if ctl else None,
        obs=obs_init(cfg.obs, S, cfg.leap, device) if cfg.obs.enabled else None)


@dataclasses.dataclass(frozen=True)
class TickMetrics:
    """Per-tick outputs, (S,) each; ``valid`` masks ticks after every app
    of a member is done (the tick body is then a no-op).  Raw sums, not
    ratios: utilization and slack divide on the host at drain time."""

    valid: torch.Tensor          # bool — this tick actually executed
    n_running: torch.Tensor      # i32
    used_cpu: torch.Tensor       # f32 cluster-total instantaneous usage
    used_mem: torch.Tensor       # f32
    alloc_cpu: torch.Tensor      # f32 cluster-total committed allocation
    alloc_mem: torch.Tensor      # f32
    forecast_rows: torch.Tensor       # i32 rows past the grace period
    forecast_rows_done: torch.Tensor  # i32 rows the forecast model computed
    # idle ticks a leap step skipped just before its tick (0 on uniform
    # ticks); drain_results re-expands each step into ``lead`` all-zero
    # ticks, then the executed tick when ``valid``
    lead: torch.Tensor                # i32


def drain_results(cfg, wl, state: dict, metrics: dict, obs: dict | None = None
                  ) -> SimResults:
    """Fold one member's final state and per-step metrics into
    ``SimResults``.  ``state`` and ``metrics`` map field names to numpy
    arrays of that member (metrics with a leading step axis; the
    calibration and tenant states' fields as ``calib.<name>`` and
    ``tenancy.<name>``).  ``obs`` is the member's drained ring history
    (``field -> (T,)``, :class:`~repro_torch.obs.rings.RingDrain`),
    attached to ``SimResults.obs`` as it is.

    Each step stands for ``lead`` skipped idle ticks (all-zero metrics:
    the cluster and the queue were empty) followed by its own tick when
    ``valid``, re-expanded here as the reference's drain does; on uniform
    ticks ``lead`` is 0 and this is plain ``valid`` masking."""
    res = SimResults(n_apps=int(wl.n_apps))
    valid = np.asarray(metrics["valid"], bool)
    reps = np.asarray(metrics["lead"], np.int64) + valid
    pos = np.cumsum(reps) - 1
    T = int(reps.sum())

    def kept(name):
        x = np.asarray(metrics[name])
        out = np.zeros(T, x.dtype)
        out[pos[valid]] = x[valid]
        return out

    res.n_running = [int(v) for v in kept("n_running")]
    H = cfg.cluster.n_hosts
    cap_cpu = np.float32(H) * np.float32(cfg.cluster.host_cpu)
    cap_mem = np.float32(H) * np.float32(cfg.cluster.host_mem)
    used_c, used_m = kept("used_cpu"), kept("used_mem")
    alloc_c, alloc_m = kept("alloc_cpu"), kept("alloc_mem")
    res.util_cpu = list(used_c / cap_cpu)
    res.util_mem = list(used_m / cap_mem)
    res.slack_cpu = [float((a - u) / a) if a > 0 else 0.0
                     for a, u in zip(alloc_c, used_c)]
    res.slack_mem = [float((a - u) / a) if a > 0 else 0.0
                     for a, u in zip(alloc_m, used_m)]

    done = np.asarray(state["done"], bool)
    # float32 subtraction, as the reference's drain
    finish = np.asarray(state["finish_t"], np.float32)
    submit0 = np.asarray(wl.submit, np.float32)
    for gid in np.nonzero(done)[0]:
        res.turnaround[int(gid)] = float(finish[gid] - submit0[gid])
    res.failed_apps = {int(g) for g in np.nonzero(np.asarray(state["failed"]))[0]}
    if cfg.policy != "baseline" and cfg.forecaster != "oracle":
        rows = kept("forecast_rows")
        res.forecast_rows = {
            "rows_ready": int(rows.sum()),
            "rows_batch": 2 * int(np.asarray(state["mon_count"]).shape[-1]),
            "rows_bucketed": int(kept("forecast_rows_done").sum()),
            "ticks_forecasting": int((rows > 0).sum()),
            "ticks": T,
        }
    res.failure_events = int(state["failure_events"])
    res.oom_kills = int(state["oom_kills"])
    res.full_preemptions = int(state["full_preemptions"])
    res.partial_preemptions = int(state["partial_preemptions"])
    calib = {k[len("calib."):]: v for k, v in state.items() if k.startswith("calib.")}
    if calib:
        res.calibration = calib_report(calib, cfg.calibration)
        groups = calib_group_report(calib, cfg.calibration)
        if groups is not None:
            res.calibration["groups"] = groups
    tenancy = {k[len("tenancy."):]: v for k, v in state.items() if k.startswith("tenancy.")}
    if tenancy:
        res.tenancy = tenancy_summary(cfg.control, wl, res.turnaround, res.failed_apps,
                                      tenancy)
    if obs is not None:
        res.obs = obs
    res.finalize(float(state["t"]))
    return res
