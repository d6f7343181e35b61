"""Fused device-resident tick: the device engine (paper §4 at fleet scale).

Counterpart of ``repro/sim/step.py``.  One tick of the simulation —
progress -> monitor sample -> forecast -> safeguard -> shaping policy
(Algorithm 1) -> OS OOM -> FIFO admission -> elastic re-placement — as
one function over the device state (:mod:`repro_torch.sim.state`).  The
reference traces a chunk of ticks (a ``lax.scan`` over its tick) into
one jitted XLA program, cached by config and shapes.  Here a chunk is
:func:`_chunk_program`, a Python loop of :func:`fused_tick` calls that
only enqueue work on the state's device; on the card it is captured once
as a CUDA graph and replayed for every chunk (:class:`_ChunkGraphs`,
cached by the same key), and the host reads back only at chunk
boundaries (the chunk's metrics and whether every app is done).  Nothing
inside a chunk waits for the device on that path (GP or persist or
oracle forecasts, pessimistic or baseline policy): the reference's
sequential loops — Algorithm 1's pass and the scheduler's three
event-bounded ``lax.while_loop``s — are CUDA kernels
(``kernels/csrc/{shaper,sched}.cu``) that take the whole batch of
members per launch.  The optimistic policy reads its loop condition on
the host, so its chunks run eagerly on the card (:func:`_captures`), as
every chunk does on the CPU.

Semantics follow the reference's ``fused_tick`` phase for phase, and the
port is checked against it (not against the host engine: the two
reference engines sum floats in different orders and break FIFO ties
differently, ``repro/sim/step.py:12-20``).  Where XLA:CPU contracts an
``a * b + c`` into one fused multiply-add, the port rounds once too
(:func:`_fma`, one kernel launch on the card).  The contracts of
``repro/sim/step.py:22-31`` hold:

  * CHUNK INVARIANCE — ticks after every app of a member is done change
    nothing but are masked out of the metrics (``TickMetrics.valid``),
    and the last chunk is cut to ``max_ticks`` exactly, so chunk=1 and
    chunk=32 give identical results;
  * COHORT EQUIVALENCE — a cohort is one batch with a leading member
    axis; every phase treats members independently, each kernel gives
    each member its own block or warp, and the metric sums are taken in
    float64, exact for these values in any order, so each member's
    results equal its solo run.

With ``forecast_bucket`` (the default) the gp forecast runs over the
ready monitor rows only (:func:`_bucketed_forecast`): the GP program
takes the full batch and a device mask of the ready rows and skips the
others, so one launch per tick covers any number of ready rows and a
captured graph never changes.
The bucket the reference would choose at each chunk boundary
(:func:`_pick_bucket`) is a device scalar that ``_drive_chunks`` writes before
the chunk runs; it decides only the ``rows_bucketed`` count.

With ``leap`` each step of a chunk first skips its member's provably
idle ticks (:func:`fused_leap`; the skip is ``kernels/csrc/leap.cu``,
which reads and writes the clock and the tick budget on the device), so
a chunk is a fixed number of steps over a variable number of ticks, and
:func:`_drive_chunks_leap` runs it.  The ARIMA forecaster is bucketed
as the GP is: one ``kernels/csrc/arima_forecast.cu`` launch a tick over
the ready rows.

With ``calibration`` enabled (and a forecaster other than oracle) the
state carries the conformal score rings (``SimState.calib``): after
monitor sampling one ``calib_observe`` launch resolves the predictions
that come due; the safeguard's scales are one ``conformal_scale`` launch
(the quantiles of the warm rings and the pools) and one ``calib_begin``
launch (the fallback hierarchy and the registration of the deployed
predictions), all three in ``kernels/csrc/calib.cu``, so a calibrated
chunk is one captured graph too.  Leap holds its skip while a score is
pending.

With the control plane on (``control.enabled``) the state carries the
tenant counters (``SimState.tenancy``) and the calibration's per-tenant
tier: ``calib_observe`` also scores each resolution into its tenant's
ring and returns the tick's per-tenant resolutions; the shaping step's
quantiles take each tenant's credit-modulated level; at phase 6 one
``control_tick`` launch (``kernels/csrc/control.cu``) folds the tick's
completions, failures and resolutions into the credit, forms the wDRF
shares and the admission gate and updates the counters, and
``admit_queued`` takes its heads among the eligible tenants' apps only.
Nothing of it reads the device, so the chunk stays one captured graph.

With the telemetry rings on (``obs.enabled``) the state carries them
(``SimState.obs``, :mod:`repro_torch.obs.rings`): each tick ends with one
``obs_tick`` launch (``kernels/csrc/obs.cu``) that writes its thirteen
channels from the state and the tick's entry values; a leap step cut by
its budget mid-skip writes the tail column with plain tensor operations.
The drivers drain the rings at every chunk boundary, after the replay
and before the next, with one copy to the host (``RingDrain``).  They
also keep the reference's instrumentation: the ``chunk`` and
``ring_drain`` spans, the ``forecast.bucket_chunks`` and
``forecast.bucket_occupancy`` series where the bucket is picked, and
``scan.compile_s``, observed with each graph's capture and
instantiation (on the CPU, with the first chunk of each program key).
The reference's ``scan.bucket_cache_entries`` gauge counts its jitted
programs, one a bucket; here one graph serves every bucket, so there is
no such gauge.

A streamed workload (``sim/scenarios/stream.py``: a ``StreamConfig``)
runs in a bounded window of the trace (:func:`_run_stream`): the window's
columns and the lifecycle of its rows live in the chunk program's static
tensors, and at each chunk boundary where the window changes the host
copies the new columns and the re-keyed lifecycle into them (``copy_``,
nothing re-pointed: a graph reads those very addresses).  A window that
grows is a program of the new W, on the card a new graph entry, and the
run's state moves into it.  :func:`run_fleet_shard` runs a fleet of
members that differ in their workload only as one cohort batch on one
device.
"""
from __future__ import annotations

import contextlib
import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.forecast import peak_over_horizon
from repro_torch.core.forecast.base import persistence_peak
from repro_torch.core.shaper import (POLICIES, ShapeDecision, ShapeProblem,
                                     shaped_demand, shaped_demand_scaled)
from repro_torch.core.shaper.pessimistic import gather_rows as _rows
from repro_torch.core.shaper.safeguard import clip_request
from repro_torch.control.device import device_weights
from repro_torch.core.uncertainty import calib_observe_groups, calib_scales_begin
from repro_torch.device import resolve_device
from repro_torch.kernels import nvcc
from repro_torch.kernels import ops as kops
from repro_torch.obs.metrics import REGISTRY
from repro_torch.obs.rings import RING_FIELDS, ObsState, RingDrain, obs_record
from repro_torch.obs.trace import span
from repro_torch.sim.engine import _check_ported, _make_model, check_tenants
from repro_torch.sim.metrics import SimResults
from repro_torch.sim.scenarios.registry import build_trace
from repro_torch.sim.scenarios.stream import _LIFE, StreamConfig, run_sim_stream
from repro_torch.sim.state import (CPU, MEM, DeviceTrace, SimState, TickMetrics,
                                   drain_results, init_state)

__all__ = ["fused_tick", "fused_leap", "run_sim_scan", "run_cohort_scan",
           "run_fleet_shard"]


# ----------------------------------------------------------------------
# small pure helpers over the slot table; (S, ...) throughout
# ----------------------------------------------------------------------

def _fma(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """``a * b + c`` rounded once to float32, as XLA:CPU compiles it (a
    fused multiply-add): ``ops.fma_f32``, one kernel launch on the card."""
    return kops.fma_f32(a, b, c)


def _gid(st: SimState) -> torch.Tensor:
    return torch.clamp_min(st.slot_gid, 0).long()


def _per_comp(mask: torch.Tensor, C: int) -> torch.Tensor:
    """(S, A) slot mask -> (S, A*C) flat monitor-row mask."""
    return mask[:, :, None].expand(-1, -1, C).reshape(mask.shape[0], -1)


def _to_apps(gid: torch.Tensor, mask: torch.Tensor, N: int) -> torch.Tensor:
    """(S, N) app mask of the slots in ``mask`` (a one-hot reduction:
    each app occupies at most one slot)."""
    apps = torch.arange(N, device=gid.device)
    return ((apps == gid[:, :, None]) & mask[:, :, None]).any(1)


def _progress_rate(tr: DeviceTrace, st: SimState) -> torch.Tensor:
    """(S, A) work/second: (1 + running elastic) / (1 + n_elastic) when
    the full core set runs, 0 otherwise."""
    gid = _gid(st)
    is_core = _rows(tr.is_core, gid)
    exists = _rows(tr.exists, gid)
    core_ok = (is_core & st.comp_running).sum(-1) == is_core.sum(-1)
    n_el = (exists & ~is_core).sum(-1)
    n_run_el = (st.comp_running & ~is_core).sum(-1)
    rate = core_ok * (1.0 + n_run_el) / (1.0 + n_el)
    return torch.where(st.slot_gid >= 0, rate, 0.0).float()


def _usage_at(tr: DeviceTrace, st: SimState, prog: torch.Tensor) -> torch.Tensor:
    """(S, A, C, 2) usage of running components at per-slot progress
    ``prog``: the two knots that matter, interpolated."""
    S, A, C = st.comp_running.shape
    SEG = tr.levels.shape[3]
    gid = _gid(st)
    x = torch.clamp(prog, 0.0, 1.0) * (SEG - 1)
    s0 = torch.clamp_max(x.to(torch.int32), SEG - 2)
    frac = x - s0.float()
    si = torch.arange(S, device=gid.device)[:, None, None]
    ci = torch.arange(C, device=gid.device)[None, None, :]
    k0 = s0.long()[:, :, None]
    lv0 = tr.levels[si, gid[:, :, None], ci, k0]                  # (S, A, C, 2)
    lv1 = tr.levels[si, gid[:, :, None], ci, k0 + 1]
    out = _fma(lv1 - lv0, frac[:, :, None, None], lv0)
    out = torch.where(_rows(tr.is_jumpy, gid)[:, :, None, None], lv0, out)
    req = torch.stack([_rows(tr.cpu_req, gid), _rows(tr.mem_req, gid)], -1)
    run = (st.slot_gid >= 0)[:, :, None] & st.comp_running
    return out * req * run[..., None]


def _mon_reset(st: SimState, rows: torch.Tensor) -> SimState:
    """Zero the monitor rings of the flat rows in ``rows``, once per tick
    for every phase's resets (the rings are read only while shaping, and
    every resetting event leaves its rows not running there)."""
    return dataclasses.replace(
        st, mon_buf=torch.where(rows[:, :, None, None], 0.0, st.mon_buf),
        mon_count=torch.where(rows, 0, st.mon_count))


def _evict_slots(st: SimState, m: torch.Tensor) -> SimState:
    """Evict the apps of the slots in the (S, A) mask ``m``."""
    return dataclasses.replace(
        st, slot_gid=torch.where(m, -1, st.slot_gid),
        comp_running=st.comp_running & ~m[:, :, None],
        alloc=torch.where(m[:, :, None, None], 0.0, st.alloc),
        work_done=torch.where(m, 0.0, st.work_done))


# ----------------------------------------------------------------------
# tick phases
# ----------------------------------------------------------------------

def _completions(tr: DeviceTrace, st: SimState, t: torch.Tensor,
                 tick: float) -> tuple[SimState, torch.Tensor]:
    """Progress every slot one tick and evict finished apps.  Returns
    the monitor rows to reset (applied once at the end of the tick)."""
    C = st.comp_running.shape[2]
    N = tr.submit.shape[1]
    work = _fma(_progress_rate(tr, st), tick, st.work_done)
    gid = _gid(st)
    fin = (st.slot_gid >= 0) & (work >= _rows(tr.runtime, gid))
    fin_app = _to_apps(gid, fin, N)
    st = dataclasses.replace(
        st, work_done=work, done=st.done | fin_app,
        finish_t=torch.where(fin_app, torch.maximum(st.finish_t, t[:, None]),
                             st.finish_t))
    return _evict_slots(st, fin), _per_comp(fin, C)


def _record_monitor(st: SimState, usage: torch.Tensor) -> SimState:
    """Append one sample per running component to its ring."""
    S, AC = st.mon_count.shape
    m = ((st.slot_gid >= 0)[:, :, None] & st.comp_running).reshape(S, AC)
    new = usage.reshape(S, AC, 1, 2)
    shifted = torch.cat([st.mon_buf[:, :, 1:], new], dim=2)
    return dataclasses.replace(
        st, mon_buf=torch.where(m[:, :, None, None], shifted, st.mon_buf),
        mon_count=st.mon_count + m)


def _oracle_peaks(tr: DeviceTrace, st: SimState, horizon: int,
                  tick: float) -> torch.Tensor:
    """(S, A, C, 2) true future peak usage over the horizon."""
    rate = _progress_rate(tr, st)
    runtime = _rows(tr.runtime, _gid(st))
    peaks = torch.zeros_like(st.alloc)
    for k in range(1, horizon + 1):
        prog = torch.clamp(_fma(rate, np.float32(tick * k), st.work_done) / runtime,
                           0.0, 1.0)
        peaks = torch.maximum(peaks, _usage_at(tr, st, prog))
    return peaks


# smallest forecast bucket, in monitor rows per resource, as the
# reference's (the model's rows are counted in passes of 2 * bucket)
_BUCKET_MIN = 8


def _bucketed(cfg) -> bool:
    """Does this config route forecasts through the bucketed path?"""
    return (cfg.forecast_bucket and cfg.policy != "baseline"
            and cfg.forecaster in ("gp", "arima"))


def _pick_bucket(cfg, st: SimState) -> int | None:
    """The reference's per-chunk bucket: the smallest power of two (at
    least ``_BUCKET_MIN``) covering the largest ready-row count over the
    members now, read on the host at the chunk boundary; ``None`` (the
    full batch) when it would cover the whole table.  It decides only how
    the rows the model computes are counted, never a result."""
    S, AC = st.mon_count.shape
    run = ((st.slot_gid >= 0)[:, :, None] & st.comp_running).reshape(S, AC)
    n = int((run & (st.mon_count >= cfg.grace)).sum(-1).max())
    b = _BUCKET_MIN
    while b < n:
        b *= 2
    if b >= AC:
        return None
    REGISTRY.counter("forecast.bucket_chunks", bucket=str(2 * b)).inc()
    REGISTRY.histogram("forecast.bucket_occupancy", bucket=str(2 * b)).observe(n / b)
    return b


def _bucketed_forecast(cfg, model, flat_w: torch.Tensor, flat_v: torch.Tensor,
                       ready: torch.Tensor, bucket: torch.Tensor):
    """gp or arima forecast over the READY monitor rows only: the counterpart of the
    reference's ``_bucketed_forecast``.

    The model takes the full ``(S * 2*A*C, W)`` batch, so the shapes never
    change, and a device mask of the ready rows (each member's CPU rows,
    then its MEM rows), and computes only those.  Rows never interact, so
    every ready row's (mean, var) is the full-batch path's to the bit.
    Non-ready rows carry no forecast, and the caller masks them.

    Returns (mean, var), each ``(S * 2*A*C,)``, and the rows the
    reference's passes compute, ``ceil(n_ready / bucket) * 2 * bucket``
    per member, with ``bucket`` the chunk's (a 0-d int32 device tensor;
    the whole table is bucket = A*C)."""
    S, AC = ready.shape
    fc = model.forecast_batch(flat_w, cfg.horizon, valid=flat_v,
                              ready=ready[:, None, :].expand(S, 2, AC).reshape(-1),
                              device=flat_w.device)
    mean, var = (x.float() for x in peak_over_horizon(fc))
    n = ready.sum(-1)
    return mean, var, ((n - 1).div(bucket, rounding_mode="floor") + 1).mul(2 * bucket).int()


def _shaped_demands(cfg, model, tr: DeviceTrace, st: SimState, tick: float,
                    bucket: torch.Tensor | None = None):
    """(S, A, C, 2) shaped demand table, the state (its calibration
    updated), the forecast rows past the grace period this tick and the
    rows the forecast model computed.

    Running components default to their reservation; components past the
    grace period get ``clip(peak + beta, 0, request)``, with the
    calibrated scale in place of K2 when calibration is on (the rows past
    the grace period then register their predictions).  Bucketed
    (:func:`_bucketed`), the gp or arima forecast runs over the ready rows only,
    and ``bucket`` is the chunk's bucket, a 0-d int32 device tensor.
    Otherwise it runs over every monitor row and non-ready rows are
    masked afterwards (the reference skips the model on ticks with no
    ready row; the masked rows are never read, so the results are the
    same)."""
    S, A, C = st.comp_running.shape
    AC = A * C
    gid = _gid(st)
    run = (st.slot_gid >= 0)[:, :, None] & st.comp_running
    req = torch.stack([_rows(tr.cpu_req, gid), _rows(tr.mem_req, gid)], -1)
    demand = torch.where(run[..., None], req, 0.0)
    zero = torch.zeros((S,), dtype=torch.int32, device=req.device)

    if cfg.forecaster == "oracle":
        # Eq. 9 with variance 0: XLA folds the dynamic term away and
        # contracts peak + k1 * request into one fused multiply-add
        peaks = _oracle_peaks(tr, st, cfg.horizon, tick)
        shaped = _fma(req, np.float32(cfg.safeguard.k1), peaks)
        shaped = clip_request(shaped, req)
        return torch.where(run[..., None], shaped, demand), st, zero, zero

    W = st.mon_buf.shape[2]
    ready = run.reshape(S, AC) & (st.mon_count >= cfg.grace)
    wins = torch.cat([st.mon_buf[..., CPU], st.mon_buf[..., MEM]], 1)  # (S, 2AC, W)
    age = torch.arange(W, device=req.device)
    vrow = age >= (W - torch.clamp_max(st.mon_count, W))[:, :, None]
    valid = torch.cat([vrow, vrow], 1)
    flat_w, flat_v = wins.reshape(-1, W), valid.reshape(-1, W)
    fc_done = zero
    if cfg.forecaster == "persist":
        mean, var = persistence_peak(flat_w, flat_v)
    elif _bucketed(cfg):
        mean, var, fc_done = _bucketed_forecast(cfg, model, flat_w, flat_v, ready, bucket)
    else:
        fc = model.forecast_batch(flat_w, cfg.horizon, valid=flat_v, device=req.device)
        mean, var = (x.float() for x in peak_over_horizon(fc))
        fc_done = torch.where(ready.any(-1), 2 * AC, 0).int()
    req_rows = torch.cat([req[..., CPU].reshape(S, AC), req[..., MEM].reshape(S, AC)], 1)
    mean, var = mean.reshape(S, 2 * AC), var.reshape(S, 2 * AC)
    if st.calib is None:
        shaped = shaped_demand(mean, req_rows, var, cfg.safeguard)
    else:
        tenancy = None
        if st.tenancy is not None:
            # rows pool by the tenant of their slot, at the quantile of
            # its credit before this tick's update
            tenancy = (st.tenancy.credit if cfg.control.credit else None, tr.tenant,
                       st.slot_gid, cfg.control)
        scale, calib = calib_scales_begin(st.calib, cfg.calibration, cfg.safeguard.k2,
                                          ready, mean, var, st.mon_count, cfg.horizon,
                                          tenancy)
        shaped = shaped_demand_scaled(mean, req_rows, var, cfg.safeguard.k1, scale,
                                      k1_folded=True)
        st = dataclasses.replace(st, calib=calib)
    rows = torch.where(torch.cat([ready, ready], 1), shaped, 0.0)
    shaped_tbl = torch.stack([rows[:, :AC].reshape(S, A, C),
                              rows[:, AC:].reshape(S, A, C)], -1)
    fc_rows = (2 * ready.sum(-1)).int()
    return (torch.where(ready.reshape(S, A, C, 1), shaped_tbl, demand), st, fc_rows,
            fc_done)


def _shape_problem(tr: DeviceTrace, st: SimState, demand: torch.Tensor,
                   t: torch.Tensor, host_cap: torch.Tensor) -> ShapeProblem:
    """The policy's input: running apps in FIFO order (submit ascending,
    the slot on ties, as the reference's stable ``jnp.argsort``)."""
    S, A = st.slot_gid.shape
    gid = _gid(st)
    app_exists = st.slot_gid >= 0
    key = _rows(tr.submit, gid) + torch.where(app_exists, 0.0, 1e18)
    fifo = torch.argsort(key, dim=-1, stable=True)
    slots = torch.arange(A, device=key.device)
    order = torch.where(slots < app_exists.sum(-1, keepdim=True), fifo, -1)
    H = host_cap.shape[0]
    return ShapeProblem(
        host_cpu=host_cap[:, CPU].expand(S, H), host_mem=host_cap[:, MEM].expand(S, H),
        app_exists=app_exists, app_order=order, comp_exists=st.comp_running,
        comp_core=_rows(tr.is_core, gid) & app_exists[:, :, None],
        comp_host=st.comp_host, comp_cpu=demand[..., CPU], comp_mem=demand[..., MEM],
        comp_alive=t[:, None, None] - st.alive_since)


def _decide(policy: str, prob: ShapeProblem) -> ShapeDecision:
    """The policy over every member: pessimistic takes the batch in one
    pass, optimistic runs member by member."""
    if policy == "pessimistic":
        return POLICIES[policy](prob)
    names = [f.name for f in dataclasses.fields(ShapeProblem)]
    per = [POLICIES[policy](ShapeProblem(**{n: getattr(prob, n)[s] for n in names}))
           for s in range(prob.app_exists.shape[0])]
    return ShapeDecision(**{f.name: torch.stack([getattr(d, f.name) for d in per])
                            for f in dataclasses.fields(ShapeDecision)})


def _apply_decision(cfg, tr: DeviceTrace, st: SimState, dec: ShapeDecision,
                    usage: torch.Tensor):
    """Kills and resizes from a decision.  Returns (state, usage,
    conflict_failed (S, N), monitor resets (S, A*C)); conflict_failed are
    the optimistic policy's uncontrolled failures."""
    C = st.comp_running.shape[2]
    N = tr.submit.shape[1]
    exists = st.slot_gid >= 0
    gid = _gid(st)
    kills = dec.kill_app & exists
    n_kills = kills.sum(-1).int()
    slot_of = (torch.arange(N, device=gid.device) == gid[:, :, None]) & kills[:, :, None]
    kgids = slot_of.any(1)                                          # (S, N)
    if not cfg.work_lost_on_kill:
        saved = torch.where(slot_of, st.work_done[:, :, None], 0.0).sum(1)
        st = dataclasses.replace(
            st, saved_work=torch.where(kgids, saved, st.saved_work),
            has_saved=st.has_saved | kgids)
    usage = torch.where(kills[:, :, None, None], 0.0, usage)
    if cfg.policy == "optimistic":
        # optimistic-concurrency conflict: an UNCONTROLLED failure
        conflict = kgids
        st = dataclasses.replace(st, failure_events=st.failure_events + n_kills)
    else:
        conflict = torch.zeros_like(kgids)
        st = dataclasses.replace(st, queued=st.queued | kgids,
                                 full_preemptions=st.full_preemptions + n_kills)
    st = _evict_slots(st, kills)
    kc = dec.kill_comp & exists[:, :, None] & st.comp_running
    usage = torch.where(kc[..., None], 0.0, usage)
    live = st.comp_running & ~kc
    st = dataclasses.replace(
        st, comp_running=live,
        partial_preemptions=st.partial_preemptions + kc.sum((1, 2)).int(),
        alloc=torch.stack([torch.where(live, dec.alloc_cpu, 0.0),
                           torch.where(live, dec.alloc_mem, 0.0)], -1))
    return st, usage, conflict, _per_comp(kills, C) | kc.reshape(kc.shape[0], -1)


def _resolve_oom(tr: DeviceTrace, st: SimState, usage: torch.Tensor,
                 host_cap: torch.Tensor):
    """The OS OOM handler (``kops.resolve_oom``): returns (state, usage,
    monitor resets)."""
    (slot_gid, work_done, run, alloc, usage, failed, queued, oom, fail, part,
     resets) = kops.resolve_oom(st.slot_gid, st.work_done, st.comp_running,
                                st.comp_host, st.alloc, usage, st.failed, st.queued,
                                st.oom_kills, st.failure_events,
                                st.partial_preemptions, tr.is_core, host_cap)
    st = dataclasses.replace(st, slot_gid=slot_gid, work_done=work_done,
                             comp_running=run, alloc=alloc, failed=failed,
                             queued=queued, oom_kills=oom, failure_events=fail,
                             partial_preemptions=part)
    return st, usage, resets


def _admit_queued(cfg, tr: DeviceTrace, st: SimState, t: torch.Tensor,
                  host_cap: torch.Tensor, elig: torch.Tensor | None = None
                  ) -> tuple[SimState, torch.Tensor]:
    """FIFO admission (``kops.admit_queued``), its heads among the apps of
    the tenants ``elig`` (S, T) marks when the control plane gates it:
    returns (state, monitor resets)."""
    gate = () if elig is None else (tr.tenant, elig, st.tenancy.admitted)
    out = kops.admit_queued(tr.submit, tr.gid, tr.cpu_req, tr.mem_req, tr.exists,
                            tr.is_core, st.slot_gid, st.work_done, st.comp_running,
                            st.comp_host, st.alloc, st.alive_since, st.queued, st.has_saved,
                            st.saved_work, t, host_cap, not cfg.work_lost_on_kill, *gate)
    (slot_gid, work_done, run, host, alloc, alive, queued, has_saved, resets) = out[:9]
    st = dataclasses.replace(st, slot_gid=slot_gid, work_done=work_done, comp_running=run,
                             comp_host=host, alloc=alloc, alive_since=alive, queued=queued,
                             has_saved=has_saved)
    if elig is not None:
        st = dataclasses.replace(st, tenancy=dataclasses.replace(st.tenancy,
                                                                 admitted=out[9]))
    return st, resets


# the wDRF weights by (TenancyConfig, device): _run makes them before any
# chunk runs (their copy to the card waits for the host), and the chunks,
# captured or not, read them
_WEIGHTS: dict = {}


def _weights(cfg, device) -> torch.Tensor:
    key = (cfg.control, device)
    if key not in _WEIGHTS:
        _WEIGHTS[key] = device_weights(cfg.control, device)
    return _WEIGHTS[key]


def _control(cfg, tr: DeviceTrace, st: SimState, done0: torch.Tensor, queued0: torch.Tensor,
             conflict: torch.Tensor | None, resolved, host_cap: torch.Tensor):
    """The control plane's step (``kops.control_tick``): the tick's events
    (completions since ``done0``, the optimistic ``conflict``s, the OOM
    kills queued since ``queued0``, the per-tenant conformal
    ``resolved`` pair or None) fold into the credit, then the shares, the
    gate and the counters.  Returns (state, the tenants' eligibility (S,
    T))."""
    ten, c = st.tenancy, cfg.control
    d_res, d_err = (None, None) if resolved is None else resolved
    (credit, throttled, completed, failed, share_sum, active_ticks,
     elig) = kops.control_tick(ten.credit, ten.throttled, ten.completed, ten.failed,
                               ten.share_sum, ten.active_ticks, done0, st.done, queued0,
                               st.queued, conflict, d_res, d_err, tr.tenant, st.slot_gid,
                               st.alloc, host_cap, _weights(cfg, host_cap.device),
                               credit_on=c.credit, gate_on=c.gate, gamma=c.credit_gamma,
                               floor=c.credit_floor, slack=c.slack)
    return dataclasses.replace(st, tenancy=dataclasses.replace(
        ten, credit=credit, throttled=throttled, completed=completed, failed=failed,
        share_sum=share_sum, active_ticks=active_ticks)), elig


def _place_missing_elastic(tr: DeviceTrace, st: SimState, t: torch.Tensor,
                           host_cap: torch.Tensor) -> SimState:
    """Elastic re-placement (``kops.place_missing_elastic``)."""
    run, host, alloc, alive = kops.place_missing_elastic(
        tr.cpu_req, tr.mem_req, tr.exists, tr.is_core, st.slot_gid, st.comp_running,
        st.comp_host, st.alloc, st.alive_since, t, host_cap)
    return dataclasses.replace(st, comp_running=run, comp_host=host, alloc=alloc,
                               alive_since=alive)


# ----------------------------------------------------------------------
# the fused tick
# ----------------------------------------------------------------------

def host_capacity(cfg, device) -> torch.Tensor:
    """(H, 2) per-host (cpu, mem) capacity."""
    c = cfg.cluster
    return torch.tensor([[c.host_cpu, c.host_mem]], dtype=torch.float32
                        ).expand(c.n_hosts, 2).contiguous().to(device)


def fused_tick(cfg, model, tr: DeviceTrace, st: SimState, host_cap: torch.Tensor,
               bucket: torch.Tensor | None = None, lead: torch.Tensor | None = None
               ) -> tuple[SimState, TickMetrics]:
    """One simulation tick for every member, in the phase order of the
    host engine's loop body.  A member whose apps are all done only keeps
    its clock (every phase is a no-op on it) and its metrics are marked
    not ``valid``.  ``bucket``: the chunk's forecast bucket, a 0-d int32
    device tensor that the bucketed forecast (:func:`_bucketed`) reads and
    needs; other configs ignore it.  ``lead`` (S,) int32: the idle ticks a
    leap step skipped before this tick, which the telemetry rings record
    beside it (0 when None).

    With the rings on (``st.obs``) the tick keeps its entry values of the
    counters it turns into deltas (references, not copies: every phase
    returns new tensors) and ends with one ``ops.obs_tick`` launch."""
    tick = cfg.cluster.tick
    active = ~st.done.all(-1)
    t = st.t + float(np.float32(tick))
    entry = st           # the telemetry rings' entry-of-tick values

    # 1. arrivals
    new = ~st.arrived & (tr.submit <= t[:, None])
    st = dataclasses.replace(st, arrived=st.arrived | new, queued=st.queued | new)

    # 2. progress + completions (monitor resets accumulate across phases
    # and apply once at the end of the tick)
    done0 = st.done
    st, resets = _completions(tr, st, t, tick)

    # 3. monitor sampling
    prog = torch.clamp(st.work_done / _rows(tr.runtime, _gid(st)), 0.0, 1.0)
    usage = _usage_at(tr, st, prog)
    st = _record_monitor(st, usage)
    resolved = None       # the tick's conformal resolutions per tenant
    if st.calib is not None:
        S, AC = st.mon_count.shape
        calib, resolved = calib_observe_groups(st.calib, usage.reshape(S, AC, 2),
                                               st.mon_count, cfg.calibration, active)
        st = dataclasses.replace(st, calib=calib)

    # 4. shaping (the baseline policy never shapes)
    zero = fc_rows = fc_done = torch.zeros_like(st.oom_kills)
    conflict = demand = None
    if cfg.policy != "baseline":
        demand, st, fc_rows, fc_done = _shaped_demands(cfg, model, tr, st, tick, bucket)
        dec = _decide(cfg.policy, _shape_problem(tr, st, demand, t, host_cap))
        st, usage, conflict, resets4 = _apply_decision(cfg, tr, st, dec, usage)
        st = dataclasses.replace(st, failed=st.failed | conflict,
                                 queued=st.queued | conflict)
        resets = resets | resets4

    # 5. OS OOM (uncontrolled failures): failed apps are requeued
    queued0 = st.queued
    st, usage, resets5 = _resolve_oom(tr, st, usage, host_cap)

    # 6. scheduler: the control plane's gate, FIFO admission, elastic
    # re-placement
    elig = None
    ten0 = st.tenancy
    if st.tenancy is not None:
        st, elig = _control(cfg, tr, st, done0, queued0,
                            conflict if cfg.policy == "optimistic" else None, resolved,
                            host_cap)
    q_admit = st.queued
    st, resets6 = _admit_queued(cfg, tr, st, t, host_cap, elig)
    st = _place_missing_elastic(tr, st, t, host_cap)
    st = _mon_reset(st, resets | resets5 | resets6)

    # 7. metrics: raw sums, divided on the host at drain time; summed in
    # float64, which holds a sum of float32 values exactly unless their
    # magnitudes span more than ~29 binary orders, so the order of the
    # sum does not show in the float32 result
    used = usage.double().sum((1, 2)).float()
    alloc = torch.where(st.comp_running[..., None], st.alloc, 0.0
                        ).double().sum((1, 2)).float()
    metrics = TickMetrics(
        valid=active, n_running=(st.slot_gid >= 0).sum(-1).int(),
        used_cpu=used[:, CPU], used_mem=used[:, MEM],
        alloc_cpu=alloc[:, CPU], alloc_mem=alloc[:, MEM],
        forecast_rows=fc_rows, forecast_rows_done=fc_done, lead=zero)
    if st.obs is not None:
        st = _record_obs(st, entry, ten0, active, usage, demand, q_admit, lead)
    return dataclasses.replace(st, t=torch.where(active, t, st.t)), metrics


_COUNTERS = ("oom_kills", "failure_events", "full_preemptions", "partial_preemptions")


def _record_obs(st: SimState, entry: SimState, ten0, active: torch.Tensor,
                usage: torch.Tensor, demand: torch.Tensor | None, q_admit: torch.Tensor,
                lead: torch.Tensor | None) -> SimState:
    """The telemetry rings' write of a tick (``ops.obs_tick``), from the
    end-of-tick state ``st``, the entry-of-tick state ``entry``, the
    tenant state before the control step ``ten0``, the tick's usage, its
    shaped demand (None under the baseline policy) and the queue before
    admission ``q_admit``."""
    o = st.obs
    tenancy = tenancy0 = calib = calib0 = None
    if st.tenancy is not None:
        tenancy = (st.tenancy.credit, st.tenancy.throttled, st.tenancy.active_ticks)
        tenancy0 = (ten0.throttled, ten0.active_ticks)
    if st.calib is not None:
        calib = (st.calib.resolved, st.calib.errors)
        calib0 = (entry.calib.resolved, entry.calib.errors)
    cursor, f32, i32, lead_ring = kops.obs_tick(
        o.cursor, o.f32, o.i32, o.lead, active, usage, demand, st.queued, q_admit,
        tuple(getattr(st, n) for n in _COUNTERS), tuple(getattr(entry, n) for n in _COUNTERS),
        tenancy, tenancy0, calib, calib0, lead)
    return dataclasses.replace(st, obs=ObsState(cursor=cursor, f32=f32, i32=i32,
                                                lead=lead_ring))


def fused_leap(cfg, model, tr: DeviceTrace, st: SimState, host_cap: torch.Tensor,
               left: torch.Tensor, bucket: torch.Tensor | None = None
               ) -> tuple[SimState, torch.Tensor, TickMetrics]:
    """One leap step for every member: skip its run of provably idle
    ticks, then execute one :func:`fused_tick` (the counterpart of the
    reference's ``fused_leap``).

    The skip is ``ops.leap_skip`` (one kernel launch on the card, which
    reads nothing back): while the cluster and the queue are empty, no
    calibration score is pending and the next arrival lies beyond ``t +
    tick``, the clock advances by the
    uniform engine's own float32 additions, so every later tick sees the
    uniform engine's clock to the bit.  ``left`` (S,) int32 is each
    member's remaining tick budget; it caps the skip and gates the tick,
    which always executes and is kept only where the member is not done
    and has budget left after the skip (``run``), field by field.  A
    member that is done or out of budget is a no-op.  Returns (state,
    ``left - lead - run``, metrics), the metrics' ``lead`` holding the
    ticks skipped."""
    t, lead = kops.leap_skip(st.slot_gid, st.queued, st.arrived, tr.submit, st.done,
                             st.t, left, cfg.cluster.tick,
                             None if st.calib is None else st.calib.left)
    st = dataclasses.replace(st, t=t)
    # left - lead > 0 implies left > 0: the reference's `active` gate
    run = ~st.done.all(-1) & (left - lead > 0)
    st2, m = fused_tick(cfg, model, tr, st, host_cap, bucket, lead)
    new = _tensors(st2)
    kept = {name: old if new[name] is old else torch.where(
                run.view(-1, *(1,) * (old.dim() - 1)), new[name], old)
            for name, old in _tensors(st).items()}
    m = dataclasses.replace(m, valid=m.valid & run, lead=lead)
    st = _replace(st, kept)
    if st.obs is not None:
        # out of budget mid-skip: the skipped ticks still happened, one
        # zero column stands for them
        st = dataclasses.replace(st, obs=obs_record(
            st.obs, ~run & (lead > 0), {name: 0 for name, _ in RING_FIELDS}, lead=lead - 1))
    return st, left - lead - run.int(), m


# ----------------------------------------------------------------------
# chunk drivers
# ----------------------------------------------------------------------

_METRICS = [f.name for f in dataclasses.fields(TickMetrics)]


def _tensors(obj, prefix: str = "") -> dict[str, torch.Tensor]:
    """Every tensor of a state or trace by name, those of a nested state
    (``SimState.calib``) as ``calib.<field>``; fields that are None (not
    ported, or off) are left out."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out.update(_tensors(v, f"{prefix}{f.name}."))
        elif v is not None:
            out[prefix + f.name] = v
    return out


def _replace(obj, tensors: dict[str, torch.Tensor]):
    """``obj`` with its tensors taken from ``tensors``, named as
    :func:`_tensors` names them."""
    kw = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            kw[f.name] = _replace(v, {k[len(f.name) + 1:]: t for k, t in tensors.items()
                                      if k.startswith(f.name + ".")})
        elif v is not None:
            kw[f.name] = tensors[f.name]
    return dataclasses.replace(obj, **kw)


def _chunk_program(cfg, model, tr: DeviceTrace, st: SimState, size: int,
                   host_cap: torch.Tensor, bucket: torch.Tensor | None = None,
                   left: torch.Tensor | None = None) -> dict[str, torch.Tensor]:
    """``size`` ticks (leap steps when ``cfg.leap``) from the state held in
    ``st``'s tensors, written back into them (``copy_``, field by field),
    without reading anything back: the counterpart of the reference's
    ``_chunk_body``.  Returns the chunk's metrics stacked ``(S, size)``
    per ``TickMetrics`` field.  On the card this is what one CUDA graph
    holds (:class:`_ChunkGraphs`); on the CPU, and for the optimistic
    policy, it runs as it stands.  ``bucket`` is read on the device at
    every tick, so one program serves every bucket.  Under leap ``left``
    (S,) int32, each member's remaining tick budget, is one more state
    tensor that the steps read and that is written back."""
    cur, metrics, lft = st, [], left
    for _ in range(size):
        if cfg.leap:
            cur, lft, m = fused_leap(cfg, model, tr, cur, host_cap, lft, bucket)
        else:
            cur, m = fused_tick(cfg, model, tr, cur, host_cap, bucket)
        metrics.append(m)
    final = _tensors(cur)
    for name, dst in _tensors(st).items():
        dst.copy_(final[name])
    if cfg.leap:
        left.copy_(lft)
    return {f: torch.stack([getattr(m, f) for m in metrics], -1) for f in _METRICS}


def _captures(cfg, device: torch.device) -> bool:
    """Whether a chunk runs as a captured CUDA graph: on the card, except
    under the optimistic policy, whose conflict loop reads its condition
    on the host at every iteration (``core/shaper/optimistic.py``, via
    :func:`_decide`) and so cannot be captured.  Decided from the config
    and the device before anything is launched."""
    return device.type == "cuda" and cfg.policy != "optimistic"


def _cfg_key(cfg) -> tuple:
    """Everything the captured program depends on besides shapes: the
    fields of the reference's ``_cfg_key`` (``repro/sim/step.py``), which
    the port's config has all of.  Not the workload, nor ``max_ticks``:
    runs of other seeds, scenarios and lengths share one entry."""
    return (cfg.cluster, cfg.policy, cfg.forecaster, cfg.safeguard,
            cfg.calibration, cfg.control, cfg.obs, cfg.window, cfg.grace,
            cfg.horizon, cfg.gp, cfg.arima, cfg.work_lost_on_kill,
            cfg.leap, cfg.forecast_bucket)


@contextlib.contextmanager
def _sync_errors():
    """Raise on any operation that waits for the card (nothing may, while
    a graph is captured)."""
    prev = torch.cuda.get_sync_debug_mode()
    torch.cuda.set_sync_debug_mode("error")
    try:
        yield
    finally:
        torch.cuda.set_sync_debug_mode(prev)


def _clone(obj):
    """A copy of a state or trace whose tensors are copies."""
    return _replace(obj, {k: v.clone() for k, v in _tensors(obj).items()})


@dataclasses.dataclass(eq=False)
class _Graph:
    """One captured chunk program and what its replays need."""

    graph: torch.cuda.CUDAGraph
    metrics: dict[str, torch.Tensor]   # the chunk's metrics, rewritten by each replay
    launches: dict                     # kernel wrapper -> its launches in the graph
    capture_s: float                   # host seconds of the capture
    instantiate_s: float               # host seconds to end the capture and instantiate
    replays: int = 0


class _ChunkGraphs:
    """The device engine's chunk as captured CUDA graphs, for one config,
    chunk size, shape and device: static copies of the trace, the host
    capacities, the state, the forecast bucket and, under leap, the tick
    budgets ``left``, and one graph per chunk size (the full chunk and
    the last one cut to ``max_ticks``, at most two; under leap every chunk
    runs in full, so one; the bucket is read on the device, so every
    bucket replays the same graph), sharing one memory pool.  The two
    graphs' temporaries may overlap, which is safe because replays run one at a
    time on one stream and each replay's metrics are read before the
    next replay.  One run at a time uses an entry.

    A graph's nodes are released once it is instantiated unless
    ``keep_nodes`` is set before the capture, for a caller that reads
    them (``torch.cuda.CUDAGraph.raw_cuda_graph``)."""

    keep_nodes = False

    def __init__(self, cfg, model, tr: DeviceTrace, st: SimState,
                 host_cap: torch.Tensor, chunk: int):
        self.cfg, self.model, self.chunk = cfg, model, chunk
        self.tr = _clone(tr)
        self.st = _clone(st)
        self.host_cap = host_cap.clone()
        self.device = host_cap.device
        self.bucket = _full_bucket(st)
        self.left = torch.zeros_like(st.oom_kills) if cfg.leap else None
        self.pool = torch.cuda.graph_pool_handle()
        self.stream = torch.cuda.Stream(self.device)
        self.graphs: dict[int, _Graph] = {}
        # warm-up before any capture: one eager tick (leap step) on a
        # clone of the state, on the capture's stream, builds and loads
        # every kernel's library, runs each one-time set-up (nvcc.prepare)
        # and fills the allocator; its launches run, and count
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        with torch.cuda.stream(self.stream):
            _chunk_program(cfg, model, self.tr, _clone(self.st), 1, self.host_cap, self.bucket,
                           None if self.left is None else self.left.clone())
        torch.cuda.synchronize(self.device)

    def load(self, tr: DeviceTrace, st: SimState, host_cap: torch.Tensor) -> None:
        """Copy a run's trace, initial state and capacities in."""
        for src, dst in ((tr, self.tr), (st, self.st)):
            got = _tensors(src)
            for name, x in _tensors(dst).items():
                x.copy_(got[name])
        self.host_cap.copy_(host_cap)

    def _capture(self, size: int) -> _Graph:
        if size != self.chunk:     # at most one cut chunk besides the full one
            for other in [n for n in self.graphs if n != self.chunk]:
                del self.graphs[other]
        graph = torch.cuda.CUDAGraph(keep_graph=self.keep_nodes)
        before = {fn: fn.launches for fn in nvcc.COUNTED}
        self.stream.wait_stream(torch.cuda.current_stream(self.device))
        t0 = time.perf_counter()
        with torch.cuda.stream(self.stream):
            graph.capture_begin(pool=self.pool)
            try:
                with _sync_errors():
                    metrics = _chunk_program(self.cfg, self.model, self.tr, self.st,
                                             size, self.host_cap, self.bucket, self.left)
                t1 = time.perf_counter()
            finally:
                # ends the capture and, unless the nodes are kept,
                # instantiates the graph and releases its nodes
                graph.capture_end()
        if self.keep_nodes:
            graph.instantiate()
        t2 = time.perf_counter()
        torch.cuda.current_stream(self.device).wait_stream(self.stream)
        # the capture ran nothing: take back what the wrappers counted,
        # and add it at every replay instead
        launches = {fn: fn.launches - n for fn, n in before.items() if fn.launches != n}
        for fn, n in before.items():
            fn.launches = n
        g = self.graphs[size] = _Graph(graph, metrics, launches, t1 - t0, t2 - t1)
        REGISTRY.histogram("scan.compile_s").observe(t2 - t0)
        return g

    def run(self, size: int) -> dict[str, torch.Tensor]:
        """One chunk of ``size`` ticks from the static state: a replay of
        its graph, captured at its first use.  Returns the chunk's
        metrics (static tensors, valid until the next replay)."""
        g = self.graphs.get(size) or self._capture(size)
        g.graph.replay()
        g.replays += 1
        for fn, n in g.launches.items():
            fn.launches += n
        return g.metrics


# captured chunks by (config key, chunk, shapes, device), least recently
# used first; bounded as the reference bounds its trace uploads
# (_TRACE_CACHE_MAX), since each entry holds its trace, state and graph
# pool on the card
_GRAPHS: dict = {}
_GRAPHS_MAX = 16


def _entry_key(cfg, tr: DeviceTrace, st: SimState, chunk: int, device) -> tuple:
    """A chunk program's key: the config's, the chunk, the shapes and the
    device."""
    S, A, C = st.comp_running.shape
    shapes = (S, A, C, tr.submit.shape[1], st.mon_buf.shape[2], tr.levels.shape[3])
    return (_cfg_key(cfg), chunk, shapes, device)


def _graph_entry(cfg, model, tr: DeviceTrace, st: SimState, chunk: int,
                 host_cap: torch.Tensor) -> _ChunkGraphs:
    """The cached entry for this run, its static tensors loaded with the
    run's trace, initial state and capacities; made (and warmed up) at
    the first run of its key."""
    key = _entry_key(cfg, tr, st, chunk, host_cap.device)
    entry = _GRAPHS.pop(key, None)
    if entry is None:
        while len(_GRAPHS) >= _GRAPHS_MAX:
            _GRAPHS.pop(next(iter(_GRAPHS)))
        entry = _ChunkGraphs(cfg, model, tr, st, host_cap, chunk)
    else:
        entry.load(tr, st, host_cap)
    _GRAPHS[key] = entry           # (re)inserted as the most recently used
    return entry


def _full_bucket(st: SimState) -> torch.Tensor:
    """A forecast-bucket scalar on the state's device set to the whole
    table (A*C rows per resource), what ``_pick_bucket``'s None means."""
    return torch.tensor(st.mon_count.shape[1], dtype=torch.int32,
                        device=st.mon_count.device)


def _program(cfg, model, tr, st, chunk: int, host_cap):
    """Where a run's chunks run: on the card (:func:`_captures`) the cached
    graph entry, whose static tensors then hold the trace, state and
    capacities; else None and the run's own tensors.  Returns (entry,
    trace, state, capacities, forecast-bucket scalar)."""
    if not _captures(cfg, host_cap.device):
        return None, tr, st, host_cap, _full_bucket(st)
    g = _graph_entry(cfg, model, tr, st, chunk, host_cap)
    return g, g.tr, g.st, g.host_cap, g.bucket


def _ring_drain(cfg, chunk: int, st: SimState) -> RingDrain | None:
    """The run's ring drain (None with the rings off); the rings are
    drained once a chunk, so a chunk must fit in them."""
    if st.obs is None:
        return None
    if chunk > cfg.obs.ring:
        raise ValueError(
            f"chunk={chunk} exceeds the telemetry ring capacity "
            f"{cfg.obs.ring}: rings are drained once per chunk, so "
            "undrained ticks would be overwritten (raise "
            "SimConfig.obs.ring or shrink the chunk)")
    return RingDrain()


# the keys of the eager chunk programs run in this process: on the CPU a
# key's first chunk stands for the first call the reference compiles
_EAGER_SEEN: set = set()


def _run_chunk(cfg, model, graphs, tr, st, size: int, host_cap, bucket, left=None):
    """One chunk, enqueued without reading anything back: a replay of its
    graph, or the eager program, whose first chunk of a key is observed in
    ``scan.compile_s`` as a graph's capture is.  Wrapped in the
    ``chunk`` span.  Returns the chunk's metrics."""
    with span("chunk", cat="execute", args={"ticks": size}):
        if graphs is not None:
            return graphs.run(size)
        key = _entry_key(cfg, tr, st, size, host_cap.device)
        t0 = time.perf_counter()
        ms = _chunk_program(cfg, model, tr, st, size, host_cap, bucket, left)
        if key not in _EAGER_SEEN:
            _EAGER_SEEN.add(key)
            REGISTRY.histogram("scan.compile_s").observe(time.perf_counter() - t0)
        return ms


def _write_bucket(cfg, st: SimState, bucket: torch.Tensor) -> None:
    """At a chunk boundary, bucketed configs only: write the bucket
    ``_pick_bucket`` chooses to the device scalar the chunk reads."""
    if _bucketed(cfg):
        b = _pick_bucket(cfg, st)
        bucket.fill_(st.mon_count.shape[1] if b is None else b)


def _drain(drain: RingDrain | None, st: SimState) -> None:
    """Drain the rings at a chunk boundary (the ``ring_drain`` span): one
    copy of the state's rings to the host, after the chunk's replay and
    before the next."""
    if drain is not None:
        with span("ring_drain", cat="drain"):
            drain.drain(st.obs)


def _drive_chunks(cfg, model, tr, st, chunk: int, host_cap):
    """Run chunks until every member is done or ``max_ticks`` is spent
    (the last chunk cut to the remaining ticks).  Returns the final
    state, the per-member metrics as numpy ``(S, ticks)`` arrays, the
    number of ticks driven and the ring drain (None with the rings off).
    Bucketed, the bucket is re-chosen at every chunk boundary, as the
    reference's ``_drive_chunks`` does, and written to the device before
    the chunk runs."""
    graphs, tr, st, host_cap, bucket = _program(cfg, model, tr, st, chunk, host_cap)
    drain = _ring_drain(cfg, chunk, st)
    parts = []
    remaining = cfg.max_ticks
    while remaining > 0:
        size = min(chunk, remaining)
        _write_bucket(cfg, st, bucket)
        ms = _run_chunk(cfg, model, graphs, tr, st, size, host_cap, bucket)
        # the chunk boundary: the one place the host reads the device
        parts.append({f: ms[f].cpu().numpy() for f in _METRICS})
        remaining -= size
        _drain(drain, st)
        if bool(st.done.all()):
            break
    metrics = {f: np.concatenate([p[f] for p in parts], -1) for f in _METRICS}
    return st, metrics, cfg.max_ticks - remaining, drain


def _drive_chunks_leap(cfg, model, tr, st, chunk: int, host_cap):
    """Run leap chunks (the reference's ``_drive_chunks_leap``): a leap step
    covers a variable number of ticks, so ``max_ticks`` cannot be kept by
    cutting the last chunk; each member's budget ``left`` (seeded with
    ``max_ticks``) is part of the chunk's state instead, and every chunk
    runs its full ``chunk`` steps (one graph).  Runs until every member
    is done or out of budget, both read at the chunk boundary only; the
    bucket is re-chosen there and the rings drained as in
    :func:`_drive_chunks`.  Returns what that returns, the ticks being the
    most any member covered."""
    graphs, tr, st, host_cap, bucket = _program(cfg, model, tr, st, chunk, host_cap)
    drain = _ring_drain(cfg, chunk, st)
    left = graphs.left if graphs is not None else torch.empty_like(st.oom_kills)
    left.fill_(cfg.max_ticks)
    parts = []
    while True:
        _write_bucket(cfg, st, bucket)
        ms = _run_chunk(cfg, model, graphs, tr, st, chunk, host_cap, bucket, left)
        parts.append({f: ms[f].cpu().numpy() for f in _METRICS})
        _drain(drain, st)
        if bool((st.done.all(-1) | (left <= 0)).all()):
            break
    metrics = {f: np.concatenate([p[f] for p in parts], -1) for f in _METRICS}
    return st, metrics, cfg.max_ticks - int(left.min()), drain


def _run(cfgs, wls, chunk: int, dev: torch.device) -> list[SimResults]:
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    cfg = cfgs[0]
    for c, w in zip(cfgs, wls):
        check_tenants(c, w)
    t0 = time.perf_counter()
    tr = DeviceTrace.from_traces(wls, dev)
    st = init_state(cfg, wls[0].n_apps, wls[0].max_components, len(wls), dev)
    host_cap = host_capacity(cfg, dev)
    if cfg.control.enabled:
        _weights(cfg, host_cap.device)
    drive = _drive_chunks_leap if cfg.leap else _drive_chunks
    st, metrics, ticks, drain = drive(cfg, _make_model(cfg), tr, st, chunk, host_cap)
    return _drain_members(cfgs, wls, st, metrics, ticks, drain, t0)


def _drain_members(cfgs, wls, st: SimState, metrics: dict, ticks: int,
                   drain: RingDrain | None, t0: float, finalize=None) -> list[SimResults]:
    """Each member's results from the run's final state and metrics, with
    ``SimResults.timings`` (wall seconds since ``t0``, ticks, members,
    steps).  ``finalize`` maps a member's numpy state before the drain (a
    streamed run's global lifecycle)."""
    # the rings are drained already
    state = {k: v.cpu().numpy() for k, v in _tensors(dataclasses.replace(st, obs=None)).items()}
    seconds = time.perf_counter() - t0
    out = []
    for i, (c, w) in enumerate(zip(cfgs, wls)):
        member = {k: v[i] for k, v in state.items()}
        res = drain_results(c, w, member if finalize is None else finalize(member),
                            {k: v[i] for k, v in metrics.items()},
                            obs=None if drain is None else drain.history(i))
        res.timings = dict(total=seconds, ticks=ticks, members=len(wls),
                           steps=metrics["valid"].shape[-1])
        out.append(res)
    return out


# ----------------------------------------------------------------------
# streamed workloads: a bounded window of the trace (sim/scenarios/stream.py)
# ----------------------------------------------------------------------

def _refill(cfg, model, win, prog, chunk: int, size: int):
    """A streamed run's chunk boundary: ``win.refill`` harvests, loads and
    re-keys the window on the host; where that changed it, the window's
    columns and the re-keyed lifecycle go into the program's own tensors
    (``copy_``); where the window grew, the run moves to a program of the
    new W (``_program``: on the card a graph entry, made and warmed up at
    its first use, whose static tensors take a copy of the state).
    ``prog`` is ``_program``'s tuple; returns it (the same or the new one)
    and the leap budget cap."""
    graphs, tr, st, host_cap, bucket = prog
    new, changed, cap = win.refill(st, t0=float(st.t[0]), tick=cfg.cluster.tick, size=size,
                                   leap=cfg.leap, chunk=chunk)
    if not changed:
        return prog, cap
    window = win.device_trace(st.t.device)
    if win.W != tr.submit.shape[1]:
        return _program(cfg, model, window, new, chunk, host_cap), cap
    got = _tensors(window)
    for name, x in _tensors(tr).items():
        x.copy_(got[name])
    for name in _LIFE:
        getattr(st, name).copy_(getattr(new, name))
    return prog, cap


def _stream_chunks(cfg, model, win, prog, chunk: int):
    """:func:`_drive_chunks` over a streamed window: the window refilled
    at every boundary before the bucket is chosen, and the run ended when
    the stream is exhausted and every loaded app is done (or at
    ``max_ticks``).  Returns (program, metrics, ticks driven, ring drain)."""
    drain = _ring_drain(cfg, chunk, prog[2])
    parts = []
    remaining = cfg.max_ticks
    while remaining > 0:
        size = min(chunk, remaining)
        prog, _ = _refill(cfg, model, win, prog, chunk, size)
        graphs, tr, st, host_cap, bucket = prog
        _write_bucket(cfg, st, bucket)
        ms = _run_chunk(cfg, model, graphs, tr, st, size, host_cap, bucket)
        parts.append({f: ms[f].cpu().numpy() for f in _METRICS})
        remaining -= size
        _drain(drain, st)
        if win.exhausted and bool(st.done.all()):
            break
    metrics = {f: np.concatenate([p[f] for p in parts], -1) for f in _METRICS}
    return prog, metrics, cfg.max_ticks - remaining, drain


def _stream_chunks_leap(cfg, model, win, prog, chunk: int):
    """:func:`_drive_chunks_leap` over a streamed window: before every
    chunk the budget ``left`` is filled with the run's remaining ticks,
    capped at the float32 tick count to the first unloaded arrival, and
    what the chunk spent is read back after it (the reference's stream
    loop).  Returns what :func:`_stream_chunks` returns."""
    drain = _ring_drain(cfg, chunk, prog[2])
    parts = []
    budget = cfg.max_ticks
    eager_left = torch.empty_like(prog[2].oom_kills)    # where no graph holds the budget
    while budget > 0:
        prog, cap = _refill(cfg, model, win, prog, chunk, chunk)
        graphs, tr, st, host_cap, bucket = prog
        _write_bucket(cfg, st, bucket)
        left = eager_left if graphs is None else graphs.left
        n = budget if cap is None else min(budget, cap)
        left.fill_(n)
        ms = _run_chunk(cfg, model, graphs, tr, st, chunk, host_cap, bucket, left)
        parts.append({f: ms[f].cpu().numpy() for f in _METRICS})
        budget -= n - int(left[0])
        _drain(drain, st)
        if win.exhausted and bool(st.done.all()):
            break
    metrics = {f: np.concatenate([p[f] for p in parts], -1) for f in _METRICS}
    return prog, metrics, cfg.max_ticks - budget, drain


def _run_stream(cfg, wl, win, chunk: int, dev: torch.device) -> SimResults:
    """One streamed run (``stream.run_sim_stream``): the window's program,
    its chunks, and the drain over the global lifecycle."""
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    check_tenants(cfg, wl)
    t0 = time.perf_counter()
    host_cap = host_capacity(cfg, dev)
    if cfg.control.enabled:
        _weights(cfg, host_cap.device)
    model = _make_model(cfg)
    st = win.seal_free(init_state(cfg, win.W, win.C, 1, dev))
    prog = _program(cfg, model, win.device_trace(dev), st, chunk, host_cap)
    drive = _stream_chunks_leap if cfg.leap else _stream_chunks
    prog, metrics, ticks, drain = drive(cfg, model, win, prog, chunk)
    return _drain_members([cfg], [wl], prog[2], metrics, ticks, drain, t0, win.finalize)[0]


def run_sim_scan(cfg, wl=None, *, chunk: int = 32,
                 device: str | torch.device = "cuda") -> SimResults:
    """Run one simulation on the device engine, ``chunk`` ticks between
    host reads; the results do not depend on ``chunk``.

    ``wl`` overrides the trace that ``cfg.workload`` would build.
    ``device`` is where the whole tick runs: CUDA unless the caller asks
    for the CPU, and asking for CUDA without a card raises.  On the card
    each chunk is a replayed CUDA graph, captured by the first run of its
    config, chunk and shapes in the process (that run also pays the
    capture); later runs, of any seed, capture nothing.
    With ``cfg.leap`` each step first skips the member's provably idle
    ticks (:func:`fused_leap`); the results equal the uniform ticks' to
    the bit.  ``SimResults.timings`` holds the run's wall seconds, the
    ticks driven (under leap the most any member covered) and the steps
    driven (chunks x chunk; the ticks on uniform runs)."""
    dev = resolve_device(device)
    _check_ported(cfg)
    if isinstance(cfg.workload, StreamConfig):
        # streamed ingestion: a bounded window, rows re-keyed at chunk
        # boundaries (equal to the materialized run, bit for bit)
        return run_sim_stream(cfg, wl, chunk=chunk, device=dev)
    wl = wl if wl is not None else build_trace(cfg.workload)
    return _run([cfg], [wl], chunk, dev)[0]


def run_cohort_scan(cfg, seeds, *, chunk: int = 32,
                    device: str | torch.device = "cuda", wls=None) -> list[SimResults]:
    """Run a seed cohort as one batch: the members' traces and states are
    stacked on a leading axis and every tick and kernel launch covers
    the whole cohort.  Each member's results equal its
    :func:`run_sim_scan` solo run.  The traces must agree in shape."""
    dev = resolve_device(device)
    _check_ported(cfg)
    seeds = list(seeds)
    if not seeds:
        return []
    cfgs = [dataclasses.replace(cfg, workload=dataclasses.replace(cfg.workload,
                                                                  seed=int(s)))
            for s in seeds]
    if wls is None:
        wls = [build_trace(c.workload) for c in cfgs]
    if isinstance(cfg.workload, StreamConfig):
        # each streamed member keeps its own window: solo streamed runs,
        # each equal to its solo run
        return [run_sim_stream(c, w, chunk=chunk, device=dev) for c, w in zip(cfgs, wls)]
    shapes = {(int(w.n_apps), int(w.max_components)) for w in wls}
    if len(shapes) != 1:
        raise ValueError(f"cohort traces disagree on shape: {shapes}")
    return _run(cfgs, list(wls), chunk, dev)


def device_count(device: torch.device) -> int:
    """Devices a fleet's mesh could span: the visible CUDA cards for a
    CUDA ``device``, 1 on the CPU."""
    return max(1, torch.cuda.device_count()) if device.type == "cuda" else 1


def run_fleet_shard(cfg, seeds=None, *, chunk: int = 32, wls=None, cfgs=None, mesh=None,
                    device: str | torch.device = "cuda") -> list[SimResults]:
    """Run a fleet of simulations that differ in their workload only
    (seed or scenario: trace data) as one cohort batch on one device.

    The counterpart of the reference's ``run_fleet_shard``, which lays the
    cohort axis across a device mesh.  Members are ``seeds`` (expanded
    against ``cfg`` as :func:`run_cohort_scan` does) or explicit ``cfgs``
    that agree with ``cfg`` on everything but ``workload``.  ``mesh`` is
    None (every visible device) or a device count; a mesh wider than the
    visible devices raises ``ValueError``, and one of two or more devices
    ``NotImplementedError``: the port runs a fleet on one device.  Each
    member's results equal its solo run, except ``forecast_rows
    ["rows_bucketed"]``, which counts the cohort's bucket (its largest
    member's, as the reference's cohort).  Streamed members run solo,
    each in its own window."""
    dev = resolve_device(device)
    _check_ported(cfg)
    if cfgs is None:
        if seeds is None:
            raise ValueError("pass seeds or cfgs")
        cfgs = [dataclasses.replace(cfg, workload=dataclasses.replace(cfg.workload,
                                                                      seed=int(s)))
                for s in seeds]
    cfgs = list(cfgs)
    if not cfgs:
        return []
    for i, c in enumerate(cfgs):
        if dataclasses.replace(c, workload=cfg.workload) != cfg:
            raise ValueError(
                f"fleet member {i} differs from the base config beyond its workload "
                "(policy/forecaster/safeguard/... are static in the fleet's program)")
    visible = device_count(dev)
    m = visible if mesh is None else int(mesh)
    if not 1 <= m <= visible:
        raise ValueError(f"mesh of {m} devices: {visible} visible")
    if m > 1:
        raise NotImplementedError(
            f"a fleet over {m} devices: the port runs a fleet on one device (mesh=1)")
    if wls is None:
        wls = [build_trace(c.workload) for c in cfgs]
    if any(isinstance(c.workload, StreamConfig) for c in cfgs):
        return [run_sim_scan(c, w, chunk=chunk, device=dev) for c, w in zip(cfgs, wls)]
    shapes = {(int(w.n_apps), int(w.max_components)) for w in wls}
    if len(shapes) != 1:
        raise ValueError(f"fleet traces disagree on shape: {shapes}")
    return _run(cfgs, list(wls), chunk, dev)
