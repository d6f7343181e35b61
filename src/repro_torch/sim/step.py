"""Fused device-resident tick: the device engine (paper §4 at fleet scale).

Counterpart of ``repro/sim/step.py``.  One tick of the simulation —
progress -> monitor sample -> forecast -> safeguard -> shaping policy
(Algorithm 1) -> OS OOM -> FIFO admission -> elastic re-placement — as
one function over the device state (:mod:`repro_torch.sim.state`).  The
reference traces it into one XLA program and runs ``lax.scan`` over
chunks of ticks; here a chunk is a Python loop of :func:`fused_tick`
calls that only enqueue work on the state's device, and the host reads
back only at chunk boundaries (the chunk's metrics and whether every app
is done).  On the card nothing inside a chunk waits for the device on
the default path (GP or persist or oracle forecasts, pessimistic or
baseline policy): the reference's sequential loops — Algorithm 1's pass
and the scheduler's three event-bounded ``lax.while_loop``s — are CUDA
kernels (``kernels/csrc/{shaper,sched}.cu``) that take the whole batch
of members per launch.  The optimistic policy still reads its loop
condition on the host.

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

Not ported, and refused: ARIMA, calibration, the control plane, the
telemetry rings, leap ticks and streamed workloads; ``run_fleet_shard``.
The forecast always runs over the full ``2 * A * C``-row batch, which is
the reference's ``forecast_bucket=False`` program (its bucketed path is
held bit-identical to that one by ``tests/test_scan_engine.py``).
"""
from __future__ import annotations

import dataclasses
import time

import numpy as np
import torch

from repro_torch.core.forecast import GPForecaster, peak_over_horizon
from repro_torch.core.forecast.base import persistence_peak
from repro_torch.core.shaper import (POLICIES, ShapeDecision, ShapeProblem,
                                     shaped_demand)
from repro_torch.core.shaper.pessimistic import gather_rows as _rows
from repro_torch.device import resolve_device
from repro_torch.kernels import ops as kops
from repro_torch.sim.engine import _check_ported
from repro_torch.sim.metrics import SimResults
from repro_torch.sim.scenarios.registry import build_trace
from repro_torch.sim.state import (CPU, MEM, DeviceTrace, SimState, TickMetrics,
                                   drain_results, init_state)

__all__ = ["fused_tick", "run_sim_scan", "run_cohort_scan"]


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


def _shaped_demands(cfg, model, tr: DeviceTrace, st: SimState, tick: float):
    """(S, A, C, 2) shaped demand table, the forecast rows past the grace
    period this tick and the rows the forecast model computed.

    Running components default to their reservation; components past the
    grace period get ``clip(peak + beta, 0, request)``.  The gp forecast
    always runs over every monitor row and non-ready rows are masked
    afterwards (the reference skips the model on ticks with no ready row;
    the masked rows are never read, so the results are the same)."""
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
        shaped = torch.minimum(torch.clamp_min(shaped, 0.0), req)
        return torch.where(run[..., None], shaped, demand), zero, zero

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
    else:
        fc = model.forecast_batch(flat_w, cfg.horizon, valid=flat_v, device=req.device)
        mean, var = (x.float() for x in peak_over_horizon(fc))
        fc_done = torch.where(ready.any(-1), 2 * AC, 0).int()
    req_rows = torch.cat([req[..., CPU].reshape(S, AC), req[..., MEM].reshape(S, AC)], 1)
    shaped = shaped_demand(mean.reshape(S, 2 * AC), req_rows, var.reshape(S, 2 * AC),
                           cfg.safeguard)
    rows = torch.where(torch.cat([ready, ready], 1), shaped, 0.0)
    shaped_tbl = torch.stack([rows[:, :AC].reshape(S, A, C),
                              rows[:, AC:].reshape(S, A, C)], -1)
    fc_rows = (2 * ready.sum(-1)).int()
    return (torch.where(ready.reshape(S, A, C, 1), shaped_tbl, demand), fc_rows,
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
                  host_cap: torch.Tensor) -> tuple[SimState, torch.Tensor]:
    """FIFO admission (``kops.admit_queued``): returns (state, monitor
    resets)."""
    (slot_gid, work_done, run, host, alloc, alive, queued, has_saved,
     resets) = kops.admit_queued(tr.submit, tr.gid, tr.cpu_req, tr.mem_req,
                                 tr.exists, tr.is_core, st.slot_gid, st.work_done,
                                 st.comp_running, st.comp_host, st.alloc,
                                 st.alive_since, st.queued, st.has_saved,
                                 st.saved_work, t, host_cap,
                                 not cfg.work_lost_on_kill)
    return dataclasses.replace(st, slot_gid=slot_gid, work_done=work_done,
                               comp_running=run, comp_host=host, alloc=alloc,
                               alive_since=alive, queued=queued,
                               has_saved=has_saved), resets


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


def fused_tick(cfg, model, tr: DeviceTrace, st: SimState,
               host_cap: torch.Tensor) -> tuple[SimState, TickMetrics]:
    """One simulation tick for every member, in the phase order of the
    host engine's loop body.  A member whose apps are all done only keeps
    its clock (every phase is a no-op on it) and its metrics are marked
    not ``valid``."""
    tick = cfg.cluster.tick
    active = ~st.done.all(-1)
    t = st.t + float(np.float32(tick))

    # 1. arrivals
    new = ~st.arrived & (tr.submit <= t[:, None])
    st = dataclasses.replace(st, arrived=st.arrived | new, queued=st.queued | new)

    # 2. progress + completions (monitor resets accumulate across phases
    # and apply once at the end of the tick)
    st, resets = _completions(tr, st, t, tick)

    # 3. monitor sampling
    prog = torch.clamp(st.work_done / _rows(tr.runtime, _gid(st)), 0.0, 1.0)
    usage = _usage_at(tr, st, prog)
    st = _record_monitor(st, usage)

    # 4. shaping (the baseline policy never shapes)
    fc_rows = fc_done = torch.zeros_like(st.oom_kills)
    if cfg.policy != "baseline":
        demand, fc_rows, fc_done = _shaped_demands(cfg, model, tr, st, tick)
        dec = _decide(cfg.policy, _shape_problem(tr, st, demand, t, host_cap))
        st, usage, conflict, resets4 = _apply_decision(cfg, tr, st, dec, usage)
        st = dataclasses.replace(st, failed=st.failed | conflict,
                                 queued=st.queued | conflict)
        resets = resets | resets4

    # 5. OS OOM (uncontrolled failures): failed apps are requeued
    st, usage, resets5 = _resolve_oom(tr, st, usage, host_cap)

    # 6. scheduler: FIFO admission + elastic re-placement
    st, resets6 = _admit_queued(cfg, tr, st, t, host_cap)
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
        forecast_rows=fc_rows, forecast_rows_done=fc_done)
    return dataclasses.replace(st, t=torch.where(active, t, st.t)), metrics


# ----------------------------------------------------------------------
# chunk drivers
# ----------------------------------------------------------------------

def _make_model(cfg):
    return GPForecaster(cfg.gp) if cfg.forecaster == "gp" else None


def _check_scan(cfg) -> None:
    _check_ported(cfg)
    if cfg.obs.enabled:
        raise NotImplementedError("the device engine's telemetry rings are not ported yet")
    if cfg.leap:
        raise NotImplementedError("leap ticks are not ported yet")
    if type(cfg.workload).__name__ == "StreamConfig":
        raise NotImplementedError("streamed workloads are not ported yet")


def _run_chunk(cfg, model, tr, st, size: int, host_cap):
    """``size`` ticks, enqueued without reading anything back."""
    metrics = []
    for _ in range(size):
        st, m = fused_tick(cfg, model, tr, st, host_cap)
        metrics.append(m)
    return st, metrics


_METRICS = [f.name for f in dataclasses.fields(TickMetrics)]


def _drive_chunks(cfg, model, tr, st, chunk: int, host_cap):
    """Run chunks until every member is done or ``max_ticks`` is spent
    (the last chunk cut to the remaining ticks).  Returns the final
    state, the per-member metrics as numpy ``(S, ticks)`` arrays and the
    number of ticks driven."""
    parts = []
    remaining = cfg.max_ticks
    while remaining > 0:
        size = min(chunk, remaining)
        st, ms = _run_chunk(cfg, model, tr, st, size, host_cap)
        # the chunk boundary: the one place the host reads the device
        parts.append({f: torch.stack([getattr(m, f) for m in ms], -1).cpu().numpy()
                      for f in _METRICS})
        remaining -= size
        if bool(st.done.all()):
            break
    metrics = {f: np.concatenate([p[f] for p in parts], -1) for f in _METRICS}
    return st, metrics, cfg.max_ticks - remaining


def _run(cfgs, wls, chunk: int, dev: torch.device) -> list[SimResults]:
    if chunk < 1:
        raise ValueError(f"chunk={chunk} must be >= 1")
    cfg = cfgs[0]
    t0 = time.perf_counter()
    tr = DeviceTrace.from_traces(wls, dev)
    st = init_state(cfg, wls[0].n_apps, wls[0].max_components, len(wls), dev)
    st, metrics, ticks = _drive_chunks(cfg, _make_model(cfg), tr, st, chunk,
                                       host_capacity(cfg, dev))
    state = {f.name: getattr(st, f.name).cpu().numpy()
             for f in dataclasses.fields(SimState) if getattr(st, f.name) is not None}
    seconds = time.perf_counter() - t0
    out = []
    for i, (c, w) in enumerate(zip(cfgs, wls)):
        res = drain_results(c, w, {k: v[i] for k, v in state.items()},
                            {k: v[i] for k, v in metrics.items()})
        res.timings = dict(total=seconds, ticks=ticks, members=len(wls))
        out.append(res)
    return out


def run_sim_scan(cfg, wl=None, *, chunk: int = 32,
                 device: str | torch.device = "cuda") -> SimResults:
    """Run one simulation on the device engine, ``chunk`` ticks between
    host reads; the results do not depend on ``chunk``.

    ``wl`` overrides the trace that ``cfg.workload`` would build.
    ``device`` is where the whole tick runs: CUDA unless the caller asks
    for the CPU, and asking for CUDA without a card raises.
    ``SimResults.timings`` holds the run's wall seconds and the ticks
    driven."""
    dev = resolve_device(device)
    _check_scan(cfg)
    wl = wl if wl is not None else build_trace(cfg.workload)
    return _run([cfg], [wl], chunk, dev)[0]


def run_cohort_scan(cfg, seeds, *, chunk: int = 32,
                    device: str | torch.device = "cuda", wls=None) -> list[SimResults]:
    """Run a seed cohort as one batch: the members' traces and states are
    stacked on a leading axis and every tick and kernel launch covers
    the whole cohort.  Each member's results equal its
    :func:`run_sim_scan` solo run.  The traces must agree in shape."""
    dev = resolve_device(device)
    _check_scan(cfg)
    seeds = list(seeds)
    if not seeds:
        return []
    cfgs = [dataclasses.replace(cfg, workload=dataclasses.replace(cfg.workload,
                                                                  seed=int(s)))
            for s in seeds]
    if wls is None:
        wls = [build_trace(c.workload) for c in cfgs]
    shapes = {(int(w.n_apps), int(w.max_components)) for w in wls}
    if len(shapes) != 1:
        raise ValueError(f"cohort traces disagree on shape: {shapes}")
    return _run(cfgs, list(wls), chunk, dev)
