"""Parametric scenario families beyond the paper's Google-shaped trace.

A copy of ``repro/sim/scenarios/families.py`` (numpy only): each generator
makes the same ``np.random.RandomState`` calls in the same order, so the
same config gives a bit-identical trace.

Four regimes the paper's single workload (§4.1) does not cover, chosen
to stress different parts of the mechanism (Flex / ADARES evaluate
usage-vs-allocation gap closing across exactly such mixes):

  * ``diurnal``    — tidal service load: arrival rate AND utilization
                     follow a shared day/night cycle, so demand peaks
                     are cluster-wide and phase-correlated (the regime
                     where persistence forecasting looks good and the
                     GP's uncertainty adds little);
  * ``flashcrowd`` — correlated burst arrivals whose utilization spikes
                     together mid-life: the adversarial case for the
                     safeguard's failure control (many under-predicted
                     components ramp at once);
  * ``heavytail``  — Pareto runtimes and memory demands,
                     ML-training-like: most jobs are small, a few are
                     enormous and long, utilization ramps to a high
                     plateau (allocation-shaping upside concentrates in
                     the tail);
  * ``colocated``  — Alibaba-style colocation: long-running
                     latency-critical services (day-peaking) packed
                     with elastic batch jobs (night-peaking), i.e.
                     anti-correlated utilization across the two classes
                     — the canonical over-commit opportunity.

Every family emits the canonical :class:`Trace` and registers in
:mod:`repro_torch.sim.scenarios.registry`; all share the ``n_apps`` /
``max_components`` / ``seed`` scale knobs so the sweep's ``scenario``
axis can swap families while keeping the grid's scale.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.scenarios.registry import register
from repro_torch.sim.scenarios.schema import SEGMENTS, Trace, sort_by_submit

DAY_S = 86_400.0


# ----------------------------------------------------------------------
# shared construction helpers
# ----------------------------------------------------------------------

def _structure(rng, N: int, C: int, is_elastic: np.ndarray,
               max_elastic: int | None = None):
    """Component structure shared by all families: elastic apps get 3
    core components (controller/master/worker) plus k elastic workers;
    rigid apps get 1-2 core components and no elastic."""
    if C < 3:
        raise ValueError(
            f"max_components={C} too small for this scenario family: "
            "elastic apps need 3 core components (controller/master/"
            "worker); use max_components >= 3")
    n_core = np.where(is_elastic, 3, rng.randint(1, 3, N))
    room = np.minimum(C - n_core, max_elastic or C)
    n_elastic = np.where(is_elastic,
                         rng.randint(2, np.maximum(room + 1, 3)), 0)
    n_elastic = np.minimum(n_elastic, room)
    idx = np.arange(C)[None, :]
    exists = idx < (n_core + n_elastic)[:, None]
    is_core = (idx < n_core[:, None]) & exists
    return n_core.astype(np.int64), n_elastic.astype(np.int64), exists, is_core


def _demands(rng, N: int, C: int, exists, is_elastic,
             min_cpu: float, max_cpu: float,
             min_mem: float, max_mem: float):
    """Log-uniform per-component reservations; the coordinator cores of
    elastic apps stay lightweight (same convention as the google family)."""
    idx = np.arange(C)[None, :]
    cpu = np.round(np.exp(rng.uniform(np.log(min_cpu), np.log(max_cpu),
                                      (N, C))) * 4) / 4
    mem = np.exp(rng.uniform(np.log(min_mem), np.log(max_mem), (N, C)))
    light = is_elastic[:, None] & (idx < 2)
    cpu = np.where(light, np.minimum(cpu, 0.5), cpu)
    mem = np.where(light, np.minimum(mem, 2.0), mem)
    cpu_req = np.where(exists, np.maximum(cpu, min_cpu), 0.0)
    mem_req = np.where(exists, np.maximum(mem, min_mem), 0.0)
    return cpu_req.astype(np.float32), mem_req.astype(np.float32)


def _assemble(*, submit, is_elastic, is_jumpy, n_core, n_elastic, runtime,
              cpu_req, mem_req, is_core, levels, cfg,
              tenant=None, slo=None) -> Trace:
    """Sort by submit, cast, mask absent components, validate."""
    N = len(np.asarray(submit))
    cols = sort_by_submit(
        np.asarray(submit, np.float32),
        is_elastic=is_elastic, is_jumpy=is_jumpy, n_core=n_core,
        n_elastic=n_elastic, runtime=np.asarray(runtime, np.float32),
        cpu_req=cpu_req, mem_req=mem_req, is_core=is_core, levels=levels,
        tenant=(np.zeros(N, np.int64) if tenant is None
                else np.asarray(tenant, np.int64)),
        slo=(np.zeros(N, np.int64) if slo is None
             else np.asarray(slo, np.int64)))
    exists = cols["cpu_req"] > 0
    cols["levels"] = np.clip(
        cols["levels"] * exists[:, :, None, None], 0.0, 1.0
    ).astype(np.float32)
    return Trace(cfg=cfg, **cols).validate()


def _tenants(rng, N: int, n_tenants: int, skew: float) -> np.ndarray:
    """Zipf-skewed tenant assignment (tenant 0 is the heaviest).

    Drawn at the very END of each generator's rng stream, and consuming
    NOTHING when ``n_tenants <= 1`` — so every pre-control-plane trace
    (the default single-tenant configs) is bit-identical to the seed
    generators."""
    if n_tenants <= 1:
        return np.zeros(N, np.int64)
    w = (1.0 + np.arange(n_tenants)) ** -float(skew)
    return rng.choice(n_tenants, size=N, p=w / w.sum()).astype(np.int64)


def _phase_profile(submit, runtime, *, day_s: float, peak_shift: float,
                   base: float, amp: float):
    """(N, SEGMENTS) wall-clock-locked day/night utilization curve.

    Segment k of an app maps to absolute time ``submit + runtime*k/(S-1)``
    (full-rate approximation), so co-running apps rise and fall
    *together* — the defining property of tidal load.  ``peak_shift``
    moves the peak within the day (π phase = services vs batch)."""
    frac = np.linspace(0.0, 1.0, SEGMENTS, dtype=np.float64)[None, :]
    t = submit[:, None] + runtime[:, None] * frac
    daylight = 0.5 * (1.0 + np.sin(2 * np.pi * t / day_s - np.pi / 2
                                   + peak_shift))
    return base + amp * daylight


# ----------------------------------------------------------------------
# diurnal — tidal day/night service load
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class DiurnalConfig:
    n_apps: int = 500
    max_components: int = 12
    seed: int = 0
    day_s: float = DAY_S
    arrival_amp: float = 0.85      # day/night arrival-rate modulation
    mean_gap: float = 180.0        # base inter-arrival (s)
    min_runtime: float = 2 * 3600.0
    max_runtime: float = 36 * 3600.0
    elastic_frac: float = 0.5
    night_level: float = 0.18      # utilization trough (fraction of resv)
    day_level: float = 0.95        # utilization crest
    noise: float = 0.04
    jumpy_frac: float = 0.10
    min_cpu: float = 0.25
    max_cpu: float = 2.0
    min_mem: float = 1.0
    max_mem: float = 24.0
    # control plane: Zipf-skewed tenant assignment (1 = single tenant,
    # bit-identical to the pre-tenancy generator)
    n_tenants: int = 1
    tenant_skew: float = 1.0


@register("diurnal", DiurnalConfig,
          doc="tidal service load: arrivals + utilization on a shared "
              "day/night cycle")
def build_diurnal(cfg: DiurnalConfig) -> Trace:
    rng = np.random.RandomState(cfg.seed)
    N, C = cfg.n_apps, cfg.max_components

    # nonhomogeneous arrivals: exponential gaps stretched by the inverse
    # instantaneous rate, so submissions bunch in "daytime"
    submit = np.empty(N)
    t = 0.0
    for i in range(N):
        rate = 1.0 + cfg.arrival_amp * np.sin(2 * np.pi * t / cfg.day_s
                                              - np.pi / 2)
        t += rng.exponential(cfg.mean_gap) / max(rate, 1.0 - cfg.arrival_amp)
        submit[i] = t

    is_elastic = rng.rand(N) < cfg.elastic_frac
    n_core, n_elastic, exists, is_core = _structure(rng, N, C, is_elastic)
    cpu_req, mem_req = _demands(rng, N, C, exists, is_elastic,
                                cfg.min_cpu, cfg.max_cpu,
                                cfg.min_mem, cfg.max_mem)
    runtime = np.exp(rng.uniform(np.log(cfg.min_runtime),
                                 np.log(cfg.max_runtime), N))

    tide = _phase_profile(submit, runtime, day_s=cfg.day_s, peak_shift=0.0,
                          base=cfg.night_level,
                          amp=cfg.day_level - cfg.night_level)
    # per-component amplitude jitter + noise; memory drains slower than
    # CPU at night (heaps do not shrink to the service's idle floor)
    scale = rng.uniform(0.8, 1.0, (N, C, 1, 2))
    lv = tide[:, None, :, None] * scale
    lv[..., 1] = np.maximum(lv[..., 1], 0.5 * tide[:, None, :])
    lv = lv + rng.normal(0.0, cfg.noise, lv.shape)
    levels = np.clip(lv, 0.02, 1.0)

    is_jumpy = rng.rand(N) < cfg.jumpy_frac
    tenant = _tenants(rng, N, cfg.n_tenants, cfg.tenant_skew)
    return _assemble(submit=submit, is_elastic=is_elastic,
                     is_jumpy=is_jumpy,
                     n_core=n_core, n_elastic=n_elastic, runtime=runtime,
                     cpu_req=cpu_req, mem_req=mem_req, is_core=is_core,
                     levels=levels, cfg=cfg, tenant=tenant,
                     slo=np.ones(N, np.int64))   # services: "standard"


# ----------------------------------------------------------------------
# flashcrowd — correlated burst arrivals with synchronized spikes
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class FlashcrowdConfig:
    n_apps: int = 500
    max_components: int = 12
    seed: int = 0
    burst_frac: float = 0.6        # fraction of apps arriving in bursts
    n_events: int = 4              # flash events across the horizon
    event_gap_s: float = 1.5       # inter-arrival inside a burst
    mean_gap: float = 120.0        # background inter-arrival
    min_runtime: float = 180.0
    max_runtime: float = 3600.0    # crowd jobs are short
    bg_max_runtime: float = 4 * 3600.0
    calm_level: float = 0.15       # burst apps idle low ...
    spike_level: float = 0.97      # ... then spike together
    spike_width: int = 8           # segments the spike spans
    elastic_frac: float = 0.4
    jumpy_frac: float = 0.25
    min_cpu: float = 0.25
    max_cpu: float = 2.0
    min_mem: float = 1.0
    max_mem: float = 20.0
    n_tenants: int = 1
    tenant_skew: float = 1.0


@register("flashcrowd", FlashcrowdConfig,
          doc="correlated burst arrivals whose utilization spikes "
              "together (safeguard stress test)")
def build_flashcrowd(cfg: FlashcrowdConfig) -> Trace:
    rng = np.random.RandomState(cfg.seed)
    N, C = cfg.n_apps, cfg.max_components
    n_burst = int(round(N * cfg.burst_frac))
    n_bg = N - n_burst

    # background population: plain Poisson arrivals, google-ish walks
    bg_submit = np.cumsum(rng.exponential(cfg.mean_gap, n_bg))
    horizon = bg_submit[-1] if n_bg else cfg.mean_gap * N

    # flash events: each spawns an equal share of the burst population
    # within seconds, all sharing one spike window in progress-space
    event_t = np.sort(rng.uniform(0.15, 0.85, cfg.n_events)) * horizon
    per_event = np.full(cfg.n_events, n_burst // cfg.n_events)
    per_event[:n_burst % cfg.n_events] += 1
    burst_submit = np.concatenate([
        et + np.cumsum(rng.exponential(cfg.event_gap_s, k))
        for et, k in zip(event_t, per_event)]) if n_burst else np.empty(0)
    event_id = np.repeat(np.arange(cfg.n_events), per_event)

    submit = np.concatenate([bg_submit, burst_submit])
    is_burst = np.zeros(N, bool)
    is_burst[n_bg:] = True

    is_elastic = rng.rand(N) < cfg.elastic_frac
    n_core, n_elastic, exists, is_core = _structure(rng, N, C, is_elastic)
    cpu_req, mem_req = _demands(rng, N, C, exists, is_elastic,
                                cfg.min_cpu, cfg.max_cpu,
                                cfg.min_mem, cfg.max_mem)
    runtime = np.where(
        is_burst,
        np.exp(rng.uniform(np.log(cfg.min_runtime),
                           np.log(cfg.max_runtime), N)),
        np.exp(rng.uniform(np.log(cfg.min_runtime),
                           np.log(cfg.bg_max_runtime), N)))

    # background: bounded random walk (the learnable regime)
    steps = rng.normal(0.0, 0.15, (N, C, SEGMENTS, 2))
    start = rng.uniform(0.15, 0.6, (N, C, 1, 2))
    walk = np.clip(start + np.cumsum(steps, axis=2), 0.08, 1.0)

    # burst apps: calm floor, then every app of an event spikes over the
    # SAME progress window (correlated, unforecastable from history)
    seg = np.arange(SEGMENTS)[None, None, :, None]
    spike_start = rng.randint(SEGMENTS // 4, SEGMENTS // 2, cfg.n_events)
    s0 = np.zeros(N, np.int64)
    s0[n_bg:] = spike_start[event_id]
    in_spike = (seg >= s0[:, None, None, None]) & \
               (seg < s0[:, None, None, None] + cfg.spike_width)
    calm = cfg.calm_level + rng.normal(0.0, 0.03, walk.shape)
    spike = cfg.spike_level + rng.normal(0.0, 0.02, walk.shape)
    burst_lv = np.where(in_spike, spike, calm)
    levels = np.where(is_burst[:, None, None, None], burst_lv, walk)
    levels = np.clip(levels, 0.02, 1.0)

    is_jumpy = rng.rand(N) < cfg.jumpy_frac
    tenant = _tenants(rng, N, cfg.n_tenants, cfg.tenant_skew)
    return _assemble(submit=submit, is_elastic=is_elastic,
                     is_jumpy=is_jumpy,
                     n_core=n_core, n_elastic=n_elastic, runtime=runtime,
                     cpu_req=cpu_req, mem_req=mem_req, is_core=is_core,
                     levels=levels, cfg=cfg, tenant=tenant)


# ----------------------------------------------------------------------
# heavytail — Pareto runtimes/demands, ML-training-like
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class HeavytailConfig:
    n_apps: int = 500
    max_components: int = 12
    seed: int = 0
    mean_gap: float = 90.0
    min_runtime: float = 120.0
    max_runtime: float = 7 * 24 * 3600.0
    runtime_alpha: float = 1.1     # Pareto shape (≈ trace-fit tails)
    min_mem: float = 0.5
    max_mem: float = 96.0
    mem_alpha: float = 1.3
    min_cpu: float = 0.25
    max_cpu: float = 4.0
    elastic_frac: float = 0.2      # gang-scheduled training: mostly rigid
    warmup_segs: int = 4           # ramp-in before the plateau
    plateau: float = 0.92          # steady-state utilization level
    dip_prob: float = 0.06         # checkpoint/GC dips off the plateau
    jumpy_frac: float = 0.15
    n_tenants: int = 1
    tenant_skew: float = 1.0


@register("heavytail", HeavytailConfig,
          doc="Pareto runtimes + memory demands (ML-training-like tail)")
def build_heavytail(cfg: HeavytailConfig) -> Trace:
    rng = np.random.RandomState(cfg.seed)
    N, C = cfg.n_apps, cfg.max_components

    submit = np.cumsum(rng.exponential(cfg.mean_gap, N))
    runtime = np.minimum(cfg.min_runtime * (1.0 + rng.pareto(
        cfg.runtime_alpha, N)), cfg.max_runtime)

    is_elastic = rng.rand(N) < cfg.elastic_frac
    n_core, n_elastic, exists, is_core = _structure(rng, N, C, is_elastic)

    idx = np.arange(C)[None, :]
    cpu = np.round(np.exp(rng.uniform(np.log(cfg.min_cpu),
                                      np.log(cfg.max_cpu), (N, C))) * 4) / 4
    # per-APP Pareto memory scale shared by its components: a big
    # training job is big in every worker
    app_mem = np.minimum(cfg.min_mem * (1.0 + rng.pareto(cfg.mem_alpha, N)),
                         cfg.max_mem)
    mem = app_mem[:, None] * rng.uniform(0.6, 1.0, (N, C))
    light = is_elastic[:, None] & (idx < 2)
    cpu = np.where(light, np.minimum(cpu, 0.5), cpu)
    mem = np.where(light, np.minimum(mem, 2.0), mem)
    cpu_req = np.where(exists, np.maximum(cpu, cfg.min_cpu),
                       0.0).astype(np.float32)
    mem_req = np.where(exists, np.maximum(mem, cfg.min_mem),
                       0.0).astype(np.float32)

    # warm-up ramp to a high plateau, with sporadic dips (checkpoints)
    seg = np.arange(SEGMENTS)[None, None, :, None]
    ramp = np.minimum(seg / max(cfg.warmup_segs, 1), 1.0)
    plateau = cfg.plateau * rng.uniform(0.9, 1.0, (N, C, 1, 2))
    lv = 0.1 + (plateau - 0.1) * ramp
    dips = rng.rand(N, C, SEGMENTS, 2) < cfg.dip_prob
    lv = np.where(dips, rng.uniform(0.3, 0.6, lv.shape), lv)
    levels = np.clip(lv + rng.normal(0.0, 0.03, lv.shape), 0.02, 1.0)

    is_jumpy = rng.rand(N) < cfg.jumpy_frac
    tenant = _tenants(rng, N, cfg.n_tenants, cfg.tenant_skew)
    return _assemble(submit=submit, is_elastic=is_elastic,
                     is_jumpy=is_jumpy,
                     n_core=n_core, n_elastic=n_elastic, runtime=runtime,
                     cpu_req=cpu_req, mem_req=mem_req, is_core=is_core,
                     levels=levels, cfg=cfg, tenant=tenant)


# ----------------------------------------------------------------------
# colocated — batch + latency-critical services, anti-correlated
# ----------------------------------------------------------------------

@dataclasses.dataclass(frozen=True)
class ColocatedConfig:
    n_apps: int = 500
    max_components: int = 12
    seed: int = 0
    service_frac: float = 0.45     # latency-critical long-runners
    day_s: float = DAY_S
    mean_gap: float = 150.0
    svc_min_runtime: float = 12 * 3600.0
    svc_max_runtime: float = 3 * 24 * 3600.0
    batch_min_runtime: float = 600.0
    batch_max_runtime: float = 4 * 3600.0
    svc_night: float = 0.15        # service trough (night)
    svc_day: float = 0.95          # service crest (day)
    batch_night: float = 0.9       # batch crest (night) — anti-correlated
    batch_day: float = 0.35        # batch trough (day)
    noise: float = 0.04
    jumpy_frac: float = 0.10
    min_cpu: float = 0.25
    max_cpu: float = 2.0
    svc_min_mem: float = 4.0
    svc_max_mem: float = 48.0
    batch_min_mem: float = 1.0
    batch_max_mem: float = 16.0
    n_tenants: int = 1
    tenant_skew: float = 1.0


@register("colocated", ColocatedConfig,
          doc="Alibaba-style service + batch mix with anti-correlated "
              "utilization")
def build_colocated(cfg: ColocatedConfig) -> Trace:
    rng = np.random.RandomState(cfg.seed)
    N, C = cfg.n_apps, cfg.max_components

    submit = np.cumsum(rng.exponential(cfg.mean_gap, N))
    is_service = rng.rand(N) < cfg.service_frac
    # services are rigid (fixed replica sets); batch is elastic
    is_elastic = ~is_service
    n_core, n_elastic, exists, is_core = _structure(rng, N, C, is_elastic)

    cpu_req, mem_req = _demands(rng, N, C, exists, is_elastic,
                                cfg.min_cpu, cfg.max_cpu,
                                cfg.batch_min_mem, cfg.batch_max_mem)
    # services reserve the big, day-sized footprints
    svc_mem = np.exp(rng.uniform(np.log(cfg.svc_min_mem),
                                 np.log(cfg.svc_max_mem), (N, C)))
    mem_req = np.where(is_service[:, None] & (cpu_req > 0), svc_mem,
                       mem_req).astype(np.float32)

    runtime = np.where(
        is_service,
        np.exp(rng.uniform(np.log(cfg.svc_min_runtime),
                           np.log(cfg.svc_max_runtime), N)),
        np.exp(rng.uniform(np.log(cfg.batch_min_runtime),
                           np.log(cfg.batch_max_runtime), N)))

    svc = _phase_profile(submit, runtime, day_s=cfg.day_s, peak_shift=0.0,
                         base=cfg.svc_night, amp=cfg.svc_day - cfg.svc_night)
    bat = _phase_profile(submit, runtime, day_s=cfg.day_s,
                         peak_shift=np.pi,    # half a day out of phase
                         base=cfg.batch_day,
                         amp=cfg.batch_night - cfg.batch_day)
    tide = np.where(is_service[:, None], svc, bat)
    scale = rng.uniform(0.85, 1.0, (N, C, 1, 2))
    lv = tide[:, None, :, None] * scale
    lv[..., 1] = np.maximum(lv[..., 1], 0.5 * tide[:, None, :])
    levels = np.clip(lv + rng.normal(0.0, cfg.noise, lv.shape), 0.02, 1.0)

    is_jumpy = rng.rand(N) < cfg.jumpy_frac
    tenant = _tenants(rng, N, cfg.n_tenants, cfg.tenant_skew)
    # latency-critical services buy "premium", batch rides "best-effort"
    slo = np.where(is_service, 2, 0).astype(np.int64)
    return _assemble(submit=submit, is_elastic=is_elastic,
                     is_jumpy=is_jumpy,
                     n_core=n_core, n_elastic=n_elastic, runtime=runtime,
                     cpu_req=cpu_req, mem_req=mem_req, is_core=is_core,
                     levels=levels, cfg=cfg, tenant=tenant, slo=slo)
