"""Arrival-process fitting: distill a replayed trace into a parametric,
sweepable scenario config.

A copy of ``repro/sim/scenarios/fitting.py`` (numpy only): the same trace
gives the same :class:`FittedConfig`, and the same config draws the same
``np.random.RandomState`` calls in the same order, so its trace is
bit-identical.

``fit_trace`` estimates the generative knobs of ANY schema-valid
:class:`Trace` — typically one ingested by the replay adapter from an
Azure/Alibaba-style file — and returns a frozen :class:`FittedConfig`:

  * **arrival process** — exponential inter-arrival at the trace's
    empirical rate (apps/sec over the observed submission span);
  * **lifetime** — lognormal runtime (moments of ``log runtime``);
  * **size** — lognormal per-component CPU/MEM reservations, fitted
    over *existing* components only;
  * **structure** — empirical component-count distribution plus the
    elastic/jumpy population fractions;
  * **utilization profile** — Beta-matched mean/std of the piecewise
    knot levels (per resource), smoothed so the synthetic series stay
    learnable (ramps, not white noise);
  * **tenancy** — tenant count and a Zipf skew fitted by least squares
    on the log-rank/log-share curve.

Because the result is a plain frozen scenario config registered as
``"fitted"``, it drops straight into the sweep grid: fit once, then
sweep ``n_apps`` / ``seed`` / ``rate`` around the measured operating
point — the scale-out story the replay file itself cannot provide.

    cfg = fit_trace(load_trace("azure.csv", preset="azure"))
    big = dataclasses.replace(cfg, n_apps=100_000, seed=7)
    tr  = build_trace(big)
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.scenarios.families import _assemble, _structure, _tenants
from repro_torch.sim.scenarios.registry import register
from repro_torch.sim.scenarios.schema import CPU, MEM, SEGMENTS, Trace

__all__ = ["FittedConfig", "fit_trace"]


@dataclasses.dataclass(frozen=True)
class FittedConfig:
    """Parametric scenario config estimated from a replayed trace.

    Every field is a plain float/int/tuple so the config hashes (sweep
    axes, ``_cfg_key`` compilation caching) and sweeps: ``rate`` scales
    load intensity, ``n_apps`` scales trace length, ``seed`` draws a
    fresh population from the same fitted distributions.
    """
    n_apps: int = 256
    max_components: int = 1
    seed: int = 0
    # arrival process: exponential inter-arrival, apps per second
    rate: float = 1.0 / 300.0
    # lifetime: lognormal over seconds
    runtime_mu: float = 7.0
    runtime_sigma: float = 1.0
    # per-component reservations: lognormal (cores / GB)
    cpu_mu: float = 0.0
    cpu_sigma: float = 0.7
    mem_mu: float = 1.5
    mem_sigma: float = 0.8
    # structure: P(app has k+1 components), k = 0..len-1; population mix
    comp_weights: tuple = (1.0,)
    elastic_frac: float = 0.0
    jumpy_frac: float = 0.0
    # utilization knots: Beta-matched mean/std per resource
    cpu_level_mu: float = 0.5
    cpu_level_sigma: float = 0.2
    mem_level_mu: float = 0.5
    mem_level_sigma: float = 0.15
    # tenancy (carried by the sweep's scenario axis)
    n_tenants: int = 1
    tenant_skew: float = 1.1


def _log_moments(x: np.ndarray, floor: float) -> tuple[float, float]:
    lx = np.log(np.maximum(np.asarray(x, np.float64), floor))
    return float(lx.mean()), float(max(lx.std(), 1e-3))


def _fit_skew(tenant: np.ndarray, n_tenants: int) -> float:
    """Least-squares Zipf exponent of the tenant share-vs-rank curve."""
    counts = np.sort(np.bincount(tenant, minlength=n_tenants))[::-1]
    counts = counts[counts > 0].astype(np.float64)
    if counts.size < 2:
        return 1.1
    lr = np.log(1.0 + np.arange(counts.size))
    lc = np.log(counts)
    slope = np.polyfit(lr, lc, 1)[0]
    return float(np.clip(-slope, 0.0, 4.0))


def fit_trace(trace: Trace, *, n_apps: int = 0, seed: int = 0) -> FittedConfig:
    """Estimate a :class:`FittedConfig` from any schema-valid trace.

    ``n_apps`` defaults to the source trace's length; pass a larger
    value (or ``dataclasses.replace`` later) to scale the synthetic
    population beyond the recording.
    """
    sub = np.asarray(trace.submit, np.float64)
    span = float(sub[-1] - sub[0])
    n = trace.n_apps
    rate = (n - 1) / span if (n > 1 and span > 0) else 1.0 / 300.0

    run_mu, run_sigma = _log_moments(trace.runtime, 1.0)
    exists = np.asarray(trace.cpu_req) > 0
    cpu_mu, cpu_sigma = _log_moments(trace.cpu_req[exists], 0.25)
    mem_mu, mem_sigma = _log_moments(trace.mem_req[exists], 0.05)

    n_comp = exists.sum(1)
    weights = np.bincount(np.maximum(n_comp - 1, 0),
                          minlength=trace.max_components).astype(np.float64)
    weights /= weights.sum()

    lv = np.asarray(trace.levels, np.float64)[exists]   # (k, SEGMENTS, 2)
    cpu_lv, mem_lv = lv[..., CPU].ravel(), lv[..., MEM].ravel()

    n_tenants = trace.n_tenants
    return FittedConfig(
        n_apps=n_apps or n,
        max_components=trace.max_components,
        seed=seed,
        rate=float(rate),
        runtime_mu=run_mu, runtime_sigma=run_sigma,
        cpu_mu=cpu_mu, cpu_sigma=cpu_sigma,
        mem_mu=mem_mu, mem_sigma=mem_sigma,
        comp_weights=tuple(float(round(w, 6)) for w in weights),
        elastic_frac=float(np.mean(trace.is_elastic)),
        jumpy_frac=float(np.mean(trace.is_jumpy)),
        cpu_level_mu=float(cpu_lv.mean()),
        cpu_level_sigma=float(max(cpu_lv.std(), 1e-3)),
        mem_level_mu=float(mem_lv.mean()),
        mem_level_sigma=float(max(mem_lv.std(), 1e-3)),
        n_tenants=n_tenants,
        tenant_skew=(_fit_skew(np.asarray(trace.tenant), n_tenants)
                     if n_tenants > 1 else 1.1),
    )


def _beta_knots(rng, shape, mu: float, sigma: float) -> np.ndarray:
    """Beta-distributed knots matched to (mu, sigma), smoothed along the
    segment axis so profiles ramp rather than jitter (the forecaster
    presupposes learnable series — see ``Trace.usage``)."""
    mu = float(np.clip(mu, 0.02, 0.98))
    var = float(min(sigma, 0.45) ** 2)
    var = min(var, 0.9 * mu * (1.0 - mu))
    k = mu * (1.0 - mu) / max(var, 1e-6) - 1.0
    raw = rng.beta(max(mu * k, 0.05), max((1.0 - mu) * k, 0.05), shape)
    # 5-knot moving average along the last axis (reflect-padded)
    pad = np.concatenate([raw[..., 2:0:-1], raw, raw[..., -2:-4:-1]], -1)
    win = np.lib.stride_tricks.sliding_window_view(pad, 5, axis=-1)
    return np.clip(win.mean(-1), 0.0, 1.0)


@register("fitted", FittedConfig,
          doc="synthetic trace drawn from distributions fitted to a "
              "replayed trace (fit_trace)")
def _build(cfg: FittedConfig) -> Trace:
    rng = np.random.RandomState(cfg.seed)
    N, C = cfg.n_apps, cfg.max_components

    gaps = rng.exponential(1.0 / max(cfg.rate, 1e-9), N)
    submit = np.cumsum(gaps) - gaps[0]
    runtime = np.maximum(
        rng.lognormal(cfg.runtime_mu, cfg.runtime_sigma, N), 1.0)

    is_elastic = (rng.rand(N) < cfg.elastic_frac) & (C >= 3)
    is_jumpy = rng.rand(N) < cfg.jumpy_frac

    if is_elastic.any():
        n_core, n_elastic, exists, is_core = _structure(rng, N, C, is_elastic)
    else:
        w = np.asarray(cfg.comp_weights[:C], np.float64)
        w = w / w.sum() if w.sum() > 0 else np.ones(C) / C
        n_core = 1 + rng.choice(len(w), size=N, p=w)
        n_elastic = np.zeros(N, np.int64)
        idx = np.arange(C)[None, :]
        exists = idx < n_core[:, None]
        is_core = exists
    # rigid rows of a mixed population keep the empirical count mix
    if is_elastic.any() and (~is_elastic).any():
        w = np.asarray(cfg.comp_weights[:C], np.float64)
        w = w / w.sum() if w.sum() > 0 else np.ones(C) / C
        k = 1 + rng.choice(len(w), size=N, p=w)
        n_core = np.where(is_elastic, n_core, np.minimum(k, C))
        idx = np.arange(C)[None, :]
        rigid_exists = idx < n_core[:, None]
        exists = np.where(is_elastic[:, None], exists, rigid_exists)
        is_core = np.where(is_elastic[:, None], is_core, rigid_exists)

    cpu = np.round(rng.lognormal(cfg.cpu_mu, cfg.cpu_sigma, (N, C)) * 4) / 4
    cpu_req = np.where(exists, np.maximum(cpu, 0.25), 0.0).astype(np.float32)
    mem = rng.lognormal(cfg.mem_mu, cfg.mem_sigma, (N, C))
    mem_req = np.where(exists, np.maximum(mem, 0.05), 0.0).astype(np.float32)

    levels = np.zeros((N, C, SEGMENTS, 2), np.float32)
    levels[..., CPU] = _beta_knots(rng, (N, C, SEGMENTS),
                                   cfg.cpu_level_mu, cfg.cpu_level_sigma)
    levels[..., MEM] = _beta_knots(rng, (N, C, SEGMENTS),
                                   cfg.mem_level_mu, cfg.mem_level_sigma)

    tenant = _tenants(rng, N, cfg.n_tenants, cfg.tenant_skew)
    return _assemble(submit=submit, is_elastic=is_elastic, is_jumpy=is_jumpy,
                     n_core=n_core, n_elastic=n_elastic, runtime=runtime,
                     cpu_req=cpu_req, mem_req=mem_req, is_core=is_core,
                     levels=levels, cfg=cfg, tenant=tenant)
