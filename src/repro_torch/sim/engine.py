"""Simulation engine (paper §4): FIFO scheduler + monitor + forecast +
resource shaper, advanced in 60 s monitoring ticks.

Counterpart of the reference's vectorized host engine
(``repro/sim/engine.py``).  Per tick:

  1. arrivals enter the FIFO queue (priority = ORIGINAL submit time);
  2. running apps progress (elastic rate model), completions recorded;
  3. the monitor samples per-component CPU/memory usage;
  4. past the grace period, the forecaster predicts each component's
     future peak utilization and its variance, the safeguard (Eq. 9)
     turns it into a shaped demand, and the shaping policy (baseline /
     optimistic / pessimistic Algorithm 1) computes allocations and
     preemptions;
  5. the OS OOM handler fires for any host whose true usage exceeds
     capacity (the uncontrolled-failure channel);
  6. the scheduler admits queued apps into freed capacity and re-places
     missing elastic components.

The cluster, monitor and queue stay numpy on the host, as in the
reference.  The forecast, the safeguard and the shaping policy run on
the engine's ``device`` — the CUDA card unless the caller asks for the
CPU.  Given the same forecasts, every decision equals the reference's.

With ``SimConfig.calibration`` enabled (and a forecaster other than
oracle), Eq. 9's dynamic term uses a per-series conformal quantile of
sigma-normalized residual scores instead of K2
(:class:`~repro_torch.core.uncertainty.OnlineCalibrator`): each tick's
deployed bounds are scored ``horizon`` ticks later, and the calibrated
scales are one ``ops.conformal_scale`` launch on the engine's device.

With ``SimConfig.control`` enabled, the multi-tenant control plane
(:mod:`repro_torch.control`) accounts every completion, failure and
conformal resolution to its tenant; at admission a weighted
dominant-resource-fairness gate decides which tenants may admit this
tick, and the FIFO head is taken among their apps only.  With
calibration on as well, scores also pool per tenant (the series ->
tenant -> fleet -> K2 hierarchy) and each tenant's target quantile moves
with its credit.  ``obs``, ``leap`` and ``forecast_bucket`` configure the
reference's device engine; the host engine ignores them, as the
reference's does.
"""
from __future__ import annotations

import bisect
import dataclasses
import time

import numpy as np
import torch

from repro_torch.control import HostControl, TenancyConfig, tenancy_summary
from repro_torch.core.forecast import (ARIMAConfig, ARIMAForecaster, GPConfig,
                                      GPForecaster, peak_over_horizon)
from repro_torch.core.monitor import Monitor
from repro_torch.core.shaper import (POLICIES, SafeguardConfig, ShapeProblem,
                                     shaped_demand, shaped_demand_scaled)
from repro_torch.core.uncertainty import (CalibrationConfig, OnlineCalibrator,
                                          bucket_pow2, sigma_from_var_np)
from repro_torch.device import resolve_device
from repro_torch.obs.config import ObsConfig
from repro_torch.sim.cluster import CPU, MEM, Cluster, ClusterConfig
from repro_torch.sim.metrics import SimResults
from repro_torch.sim.scenarios.registry import build_trace
from repro_torch.sim.workload import Workload, WorkloadConfig


@dataclasses.dataclass(frozen=True)
class SimConfig:
    cluster: ClusterConfig = ClusterConfig()
    workload: WorkloadConfig = WorkloadConfig()
    policy: str = "pessimistic"          # baseline | optimistic | pessimistic
    forecaster: str = "gp"               # oracle | gp | arima | persist
    safeguard: SafeguardConfig = SafeguardConfig()
    calibration: CalibrationConfig = CalibrationConfig()   # conformal safeguard
    control: TenancyConfig = TenancyConfig()   # multi-tenant control plane
    obs: ObsConfig = ObsConfig()         # device telemetry rings (device engine only)
    window: int = 24                     # monitor window (ticks)
    grace: int = 10                      # grace period (paper §5: 10 min)
    horizon: int = 3                     # forecast look-ahead (ticks)
    gp: GPConfig = GPConfig(history=10, max_patterns=10, opt_steps=10)
    arima: ARIMAConfig = ARIMAConfig()
    max_ticks: int = 100_000
    work_lost_on_kill: bool = True       # kill primitive loses all work
    leap: bool = False                   # device engine only
    forecast_bucket: bool = True         # device engine only


def _check_ported(cfg: SimConfig) -> None:
    if cfg.forecaster not in ("gp", "arima", "persist", "oracle"):
        raise ValueError(f"unknown forecaster {cfg.forecaster!r} "
                         "(expected oracle | gp | arima | persist)")
    if cfg.policy not in POLICIES:
        raise ValueError(f"unknown policy {cfg.policy!r} "
                         f"(expected one of {tuple(POLICIES)})")


def _make_model(cfg: SimConfig):
    """The forecast model of ``cfg`` (None for persist and oracle, which
    the engines compute inline)."""
    if cfg.forecaster == "gp":
        return GPForecaster(cfg.gp)
    if cfg.forecaster == "arima":
        return ARIMAForecaster(cfg.arima)
    return None


def forecast_peaks(model, horizon: int, windows: np.ndarray, valid: np.ndarray,
                   device: torch.device):
    """Pad (n, W) windows to a power-of-two bucket, forecast them on
    ``device`` and return each row's (peak mean, its variance) as numpy.
    Row i's result depends only on row i, so the padding changes no real
    row; it keeps the kernels at the few batch shapes of the reference."""
    n, width = windows.shape
    b = bucket_pow2(n)
    wpad = np.zeros((b, width), np.float32)
    vpad = np.zeros((b, width), bool)
    wpad[:n], vpad[:n] = windows, valid
    peak, pvar = peak_over_horizon(
        model.forecast_batch(wpad, horizon, valid=vpad, device=device))
    return peak[:n].cpu().numpy(), pvar[:n].cpu().numpy()


class _BatchedForecaster:
    """The engine's default forecast client: ``(windows, valid) -> (mean,
    var)`` over ``(n, W)`` numpy windows."""

    def __init__(self, cfg: SimConfig, device: torch.device):
        self.cfg = cfg
        self.device = device
        self._model = _make_model(cfg)

    def __call__(self, windows: np.ndarray, valid: np.ndarray):
        if self.cfg.forecaster == "persist":
            mean = windows[:, -1]
            var = windows.var(axis=1, where=valid) + 1e-6
            return mean, var
        return forecast_peaks(self._model, self.cfg.horizon, windows, valid,
                              self.device)


def _oracle_peaks(cluster: Cluster, wl: Workload, horizon: int,
                  tick: float) -> np.ndarray:
    """(A, C, 2) true future peak usage over the horizon (variance 0)."""
    A, C = cluster.A, cluster.C
    out = np.zeros((A, C, 2), np.float32)
    run = cluster.running_slots()
    if run.size == 0:
        return out
    gids = cluster.slot_gid[run]
    rate = cluster.progress_rate(wl)[run]
    peaks = np.zeros((run.size, C, 2), np.float32)
    for k in range(1, horizon + 1):
        prog = np.clip((cluster.work_done[run] + rate * tick * k)
                       / wl.runtime[gids], 0.0, 1.0)
        u = wl.usage(gids, prog) * cluster.comp_running[run][:, :, None]
        peaks = np.maximum(peaks, u)
    out[run] = peaks
    return out


def _f32(x, device: torch.device) -> torch.Tensor:
    """A numpy input as float32 on ``device``, as the reference's
    ``jnp.asarray`` with x64 off makes it."""
    return torch.as_tensor(np.array(x, dtype=np.float32), device=device)


def _shaped_demand(peak, req, var, sg: SafeguardConfig,
                   device: torch.device) -> np.ndarray:
    """Eq. 9 on ``device`` over numpy inputs."""
    return shaped_demand(_f32(peak, device), _f32(req, device), _f32(var, device),
                         sg).cpu().numpy()


def _shaped_demand_scaled(peak, req, var, k1: float, scale,
                          device: torch.device) -> np.ndarray:
    """Eq. 9 with calibrated sigma multipliers on ``device`` over numpy
    inputs; ``k1`` is an argument of the reference's compiled function,
    so its contraction is never folded."""
    return shaped_demand_scaled(_f32(peak, device), _f32(req, device), _f32(var, device),
                                k1, _f32(scale, device)).cpu().numpy()


class _PhaseClock:
    """Wall seconds per engine phase.  On a CUDA device it synchronises at
    each split, so a phase's time includes the device work it queued."""

    def __init__(self, device: torch.device):
        self.sync = (torch.cuda.synchronize if device.type == "cuda"
                     else (lambda: None))
        self.seconds = {"forecast": 0.0, "policy": 0.0}

    def timed(self, phase: str, fn):
        def run(*args):
            self.sync()
            t0 = time.perf_counter()
            out = fn(*args)
            self.sync()
            self.seconds[phase] += time.perf_counter() - t0
            return out
        return run


def _shape_decisions(cfg: SimConfig, cl: Cluster, wl: Workload, mon: Monitor,
                     fc, policy_fn, submit0: np.ndarray, run: np.ndarray,
                     t: float, tick: float, device: torch.device, calib=None,
                     ctl: HostControl | None = None):
    """Forecast -> safeguard -> Algorithm 1 for one tick; with a calibrator
    the safeguard takes its scales and registers the deployed bounds, per
    tenant with the control plane ``ctl``.  Returns numpy (kill_app,
    kill_comp, alloc_cpu, alloc_mem)."""
    A, C = cl.A, cl.C
    gids = cl.slot_gid[run]
    req = np.stack([wl.cpu_req[gids], wl.mem_req[gids]], -1)  # (n,C,2)
    running = cl.comp_running[run]
    demand = np.where(running[:, :, None], req, 0.0).astype(np.float32)

    if cfg.forecaster == "oracle":
        # perfect information needs no training history: the grace
        # period (paper §5) exists only for statistical models
        peaks = _oracle_peaks(cl, wl, cfg.horizon, tick)[run]
        var = np.zeros_like(peaks)
        shaped = _shaped_demand(peaks, req, var, cfg.safeguard, device)
        demand = np.where(running[:, :, None], shaped, demand)
    else:
        rc = np.nonzero(running)
        mslots = run[rc[0]] * C + rc[1]
        ready = mon.ready(mslots, cfg.grace)
        if ready.any():
            sel = np.nonzero(ready)[0]
            wins, vmask = mon.windows(mslots[sel])
            n = sel.size
            wflat = np.concatenate([wins[:, :, CPU], wins[:, :, MEM]])
            vflat = np.concatenate([vmask, vmask])
            mean, var = fc(wflat, vflat)
            reqs = req[rc[0][sel], rc[1][sel]]     # (n, 2)
            if calib is None:
                for r, off in ((CPU, 0), (MEM, n)):
                    demand[rc[0][sel], rc[1][sel], r] = _shaped_demand(
                        mean[off:off + n], reqs[:, r], var[off:off + n],
                        cfg.safeguard, device)
            else:
                # conformal safeguard: the calibrated scale of each row
                # (the batch layout: CPU rows, then MEM rows) replaces K2
                M = mon.count.shape[0]
                rows = np.concatenate([mslots[sel], M + mslots[sel]])
                groups, q_rows = None, None
                if ctl is not None:
                    # rows pool by the tenant owning the slot, at its
                    # credit's quantile (the previous tick's credit: the
                    # control update runs at admission)
                    tg = wl.tenant[cl.slot_gid[run[rc[0][sel]]]]
                    groups = np.concatenate([tg, tg])
                    qg = ctl.q_groups(calib.q, cfg.calibration.q_min,
                                      cfg.calibration.q_max)
                    q_rows = qg[groups]
                scale = calib.scales(rows, groups=groups, q=q_rows)
                for r, off in ((CPU, 0), (MEM, n)):
                    demand[rc[0][sel], rc[1][sel], r] = _shaped_demand_scaled(
                        mean[off:off + n], reqs[:, r], var[off:off + n],
                        cfg.safeguard.k1, scale[off:off + n], device)
                sigma = sigma_from_var_np(var).astype(np.float32)
                counts = np.concatenate([mon.count[mslots[sel]]] * 2)
                calib.begin(rows, mean.astype(np.float32), sigma,
                            scale.astype(np.float32), counts, groups=groups)

    # build the fixed-size ShapeProblem over ALL slots
    dem_full = np.zeros((A, C, 2), np.float32)
    dem_full[run] = demand
    app_exists = cl.slot_gid >= 0
    order = np.full((A,), -1, np.int64)
    fifo = np.argsort(submit0[np.maximum(cl.slot_gid, 0)]
                      + np.where(app_exists, 0, 1e18))
    order[:run.size] = fifo[:run.size]

    def t_(x, dtype):
        return torch.as_tensor(x, dtype=dtype, device=device)

    prob = ShapeProblem(
        host_cpu=t_(cl.host_cap[:, CPU], torch.float32),
        host_mem=t_(cl.host_cap[:, MEM], torch.float32),
        app_exists=t_(app_exists, torch.bool),
        app_order=t_(order, torch.int64),
        comp_exists=t_(cl.comp_running, torch.bool),
        comp_core=t_(wl.is_core[np.maximum(cl.slot_gid, 0)]
                     & app_exists[:, None], torch.bool),
        comp_host=t_(cl.comp_host, torch.int64),
        comp_cpu=t_(dem_full[:, :, CPU], torch.float32),
        comp_mem=t_(dem_full[:, :, MEM], torch.float32),
        comp_alive=t_(t - cl.alive_since, torch.float32),
    )
    dec = policy_fn(prob)
    return (dec.kill_app.cpu().numpy(), dec.kill_comp.cpu().numpy(),
            dec.alloc_cpu.cpu().numpy(), dec.alloc_mem.cpu().numpy())


def check_tenants(cfg: SimConfig, wl: Workload) -> None:
    """With the control plane on, refuse a trace with more tenants than
    ``control.max_tenants`` (the width of the tenant counters)."""
    if cfg.control.enabled and wl.n_tenants > cfg.control.max_tenants:
        raise ValueError(f"trace has {wl.n_tenants} tenants > control.max_tenants="
                         f"{cfg.control.max_tenants}")


def _host_control(cfg: SimConfig, wl: Workload) -> HostControl | None:
    """The run's tenant accounting, or None with the control plane off."""
    check_tenants(cfg, wl)
    return HostControl(cfg.control) if cfg.control.enabled else None


def _gate(cfg: SimConfig, hc: HostControl | None, cl: Cluster, wl: Workload,
          queue: list) -> np.ndarray | None:
    """The admission gate's per-tenant eligibility (None with the control
    plane off), from each tenant's allocation over the running slots and
    its queued apps."""
    if hc is None:
        return None
    T = cfg.control.max_tenants
    alloc_t = np.zeros((T, 2), np.float32)
    run = cl.running_slots()
    if run.size:
        np.add.at(alloc_t, wl.tenant[cl.slot_gid[run]], cl.alloc[run].sum(1))
    queued_t = np.bincount(wl.tenant[[g for _, g in queue]], minlength=T)
    return hc.gate(alloc_t, cl.host_cap.sum(0), queued_t)


def run_sim(cfg: SimConfig, wl: Workload | None = None, *, forecast_fn=None,
            device: str | torch.device = "cuda") -> SimResults:
    """Run one simulation to completion (or ``cfg.max_ticks``).

    ``forecast_fn(windows, valid) -> (mean, var)`` overrides the default
    forecast client (numpy in, numpy out); the sweep driver passes a
    cross-sim batching client here, and a client with an ``idle()``
    method is called once on each tick that requested no forecast.  ``wl`` overrides the trace
    that ``cfg.workload`` would build.  ``device`` is where forecasts,
    the safeguard and the policy run: CUDA unless the caller asks for
    the CPU, and asking for CUDA without a card raises.

    ``SimResults.timings`` holds the wall seconds spent in the forecast
    and in the policy, the whole run's seconds and the tick count.
    """
    dev = resolve_device(device)
    _check_ported(cfg)
    wl = wl if wl is not None else build_trace(cfg.workload)
    N, C = wl.n_apps, wl.max_components
    cl = Cluster(cfg.cluster, C)
    A = cl.A
    mon = Monitor(slots=A * C, window=cfg.window)
    clock = _PhaseClock(dev)
    client = forecast_fn if forecast_fn is not None else _BatchedForecaster(cfg, dev)
    # per-tick "no request" signal for the sweep's batcher: a client with
    # an ``idle`` method is told of every tick that requested no forecast
    # (grace period, empty cluster, baseline policy), so a batch round
    # stops waiting for it.  The calls are counted on the client itself,
    # apart from the phase clock's timing
    idle_fn = getattr(client, "idle", None)
    fc_calls = [0]
    if idle_fn is not None:
        def client(windows, valid, _inner=client):
            fc_calls[0] += 1
            return _inner(windows, valid)
    fc = clock.timed("forecast", client)
    policy_fn = clock.timed("policy", POLICIES[cfg.policy])
    res = SimResults(n_apps=N)
    tick = cfg.cluster.tick
    all_comps = np.arange(C)[None, :]     # broadcast helper for mon resets
    hc = _host_control(cfg, wl)
    # online conformal calibration (oracle forecasts are exact: there is
    # no residual distribution to calibrate); with the control plane on,
    # scores also pool per tenant
    calib = None
    if cfg.calibration.enabled and cfg.forecaster != "oracle":
        calib = OnlineCalibrator(n_series=2 * A * C, horizon=cfg.horizon,
                                 fallback=cfg.safeguard.k2, cfg=cfg.calibration,
                                 n_groups=cfg.control.max_tenants if hc is not None else 0,
                                 device=dev)

    queue: list[tuple[float, int]] = []   # (original submit, gid) sorted
    arrived = 0
    done = np.zeros((N,), bool)
    submit0 = wl.submit.copy()            # original submit (priority key)
    # preempt-to-checkpoint mode (work_lost_on_kill=False): a preempted
    # app resumes from its last saved progress instead of restarting
    saved_work: dict[int, float] = {}

    def requeue(gid: int):
        bisect.insort(queue, (float(submit0[gid]), gid))

    t0 = time.perf_counter()
    t = 0.0
    ticks = 0
    for step in range(cfg.max_ticks):
        if done.all():
            break
        t += tick
        ticks += 1

        # 1. arrivals ---------------------------------------------------
        while arrived < N and wl.submit[arrived] <= t:
            requeue(arrived)
            arrived += 1

        # 2. progress + completions (array scan over the slot table) ------
        rate = cl.progress_rate(wl)
        cl.work_done += rate * tick
        run = cl.running_slots()
        fin = run[cl.work_done[run] >= wl.runtime[cl.slot_gid[run]]]
        if fin.size:
            mon.reset_slot((fin[:, None] * C + all_comps).ravel())
            fin_gids = cl.evict_apps(fin)
            done[fin_gids] = True
            for gid in fin_gids:
                res.record_completion(int(gid), submit0[gid], t)
            if hc is not None:
                hc.note_completed(wl.tenant[fin_gids])

        # 3. monitor sampling --------------------------------------------
        usage = cl.usage_now(wl)
        run = cl.running_slots()
        if run.size:
            rc = np.nonzero(cl.comp_running[run])  # (slot_i, c)
            mslots = run[rc[0]] * C + rc[1]
            mon.record(mslots, usage[run][rc][:, CPU], usage[run][rc][:, MEM])
        if calib is not None:
            if hc is not None:
                gr0, ge0 = calib.group_resolved.copy(), calib.group_errors.copy()
            calib.observe(np.concatenate([usage[:, :, CPU].ravel(),
                                          usage[:, :, MEM].ravel()]), mon.count)
            if hc is not None:
                # covered and missed resolutions feed the tenant credit
                derr = calib.group_errors - ge0
                hc.note_calib(calib.group_resolved - gr0 - derr, derr)

        # 4. shaping ------------------------------------------------------
        # two kill channels (paper §4.2): controlled preemptions
        # (Algorithm 1) vs uncontrolled OS OOM kills (the "application
        # failures" of Figs. 3-4)
        preempted_this_tick: list[int] = []
        oom_failed_this_tick: list[int] = []
        calls_before = fc_calls[0]
        if cfg.policy != "baseline" and run.size:
            kill_app, kill_comp, alloc_cpu, alloc_mem = _shape_decisions(
                cfg, cl, wl, mon, fc, policy_fn, submit0, run, t, tick, dev, calib, hc)

            kills = np.nonzero(kill_app & (cl.slot_gid >= 0))[0]
            if kills.size:
                if not cfg.work_lost_on_kill:
                    for gid0, wd in zip(cl.slot_gid[kills],
                                        cl.work_done[kills]):
                        saved_work[int(gid0)] = float(wd)
                kgids = cl.evict_apps(kills)
                usage[kills] = 0.0
                mon.reset_slot((kills[:, None] * C + all_comps).ravel())
                if cfg.policy == "optimistic":
                    # optimistic-concurrency conflict: an UNCONTROLLED failure
                    oom_failed_this_tick.extend(int(g) for g in kgids)
                else:
                    preempted_this_tick.extend(int(g) for g in kgids)
                    res.full_preemptions += kills.size
            ks, kc = np.nonzero(kill_comp & (cl.slot_gid >= 0)[:, None]
                                & cl.comp_running)
            if ks.size:
                cl.kill_components(ks, kc)
                usage[ks, kc] = 0.0
                mon.reset_slot(ks * C + kc)
                res.partial_preemptions += ks.size
            live = cl.comp_running
            cl.alloc[:, :, CPU] = np.where(live, alloc_cpu, 0.0)
            cl.alloc[:, :, MEM] = np.where(live, alloc_mem, 0.0)
        if idle_fn is not None and fc_calls[0] == calls_before:
            idle_fn()

        # 5. OOM (uncontrolled failures) -----------------------------------
        oom_gids, oom_partial = cl.resolve_oom(wl, usage)
        for gid in oom_gids:
            oom_failed_this_tick.append(gid)
            res.oom_kills += 1
        res.partial_preemptions += len(oom_partial)
        if oom_partial:
            parr = np.asarray(oom_partial, np.int64)
            mon.reset_slot(parr[:, 0] * C + parr[:, 1])

        for gid in oom_failed_this_tick:
            res.record_failure(gid)
        if hc is not None and oom_failed_this_tick:
            hc.note_failed(wl.tenant[np.asarray(oom_failed_this_tick)])
        for gid in oom_failed_this_tick + preempted_this_tick:
            requeue(gid)

        # 6. scheduler: FIFO admission + elastic re-placement --------------
        # with the control plane on, the tick's events first fold into the
        # credit, then the gate decides which tenants may admit
        elig = _gate(cfg, hc, cl, wl, queue)
        while queue:
            if elig is None:
                i0 = 0
            else:
                # the FIFO head among eligible tenants' apps (the queue is
                # sorted by (submit, gid))
                i0 = next((i for i, (_, g) in enumerate(queue)
                           if elig[wl.tenant[g]]), -1)
                if i0 < 0:
                    break
            _, gid = queue[i0]
            slot = cl.admit(gid, wl, t)
            if slot < 0:
                break
            queue.pop(i0)
            if hc is not None:
                hc.note_admitted(int(wl.tenant[gid]))
            if not cfg.work_lost_on_kill and gid in saved_work:
                cl.work_done[slot] = saved_work.pop(gid)  # resume from ckpt
            mon.reset_slot(slot * C + np.arange(C))
        cl.place_missing_elastic(wl, t)

        # 7. metrics -------------------------------------------------------
        res.record_tick(t, cl, usage)

    if calib is not None:
        res.calibration = calib.report()
        groups = calib.group_report()
        if groups is not None:
            res.calibration["groups"] = groups
    if hc is not None:
        res.tenancy = tenancy_summary(cfg.control, wl, res.turnaround,
                                      res.failed_apps, hc.arrays())
    res.finalize(t)
    res.timings = dict(clock.seconds, total=time.perf_counter() - t0,
                       ticks=ticks)
    return res
