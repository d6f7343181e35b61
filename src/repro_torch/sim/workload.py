"""Google-shaped workload generator (the paper's §4.1 trace statistics).

A copy of ``repro/sim/workload.py`` (numpy only): the same seed gives a
bit-identical trace.

The paper samples 150k batch applications from empirical distributions of
the public Google cluster traces [Reiss'11, Wilkes'11].  Those traces are
not downloadable in this offline environment, so we sample from parametric
families fitted to the *published* characteristics the paper quotes:

  * mix: rigid (TensorFlow-like) and elastic (Spark-like) applications —
    60% / 40% as in the paper's §5.1 workload;
  * components per application: "from a few to tens of thousands" —
    log-uniform, truncated at ``max_components`` for tractability (the
    simulator's tables are O(apps x components));
  * per-component demand: up to 6 CPU cores, few MB to dozens of GB RAM
    (log-uniform 256 MB .. 32 GB);
  * runtime: "a few dozens of seconds to several weeks" — log-uniform
    60 s .. ``max_runtime`` (heavy right tail);
  * inter-arrival: bi-modal — bursts (exponential, fast) mixed with long
    gaps, per the paper's description of the trace empiricals.

Utilization patterns: each component gets a piecewise-constant utilization
profile over SEGMENTS progress segments — a bounded random walk in
[min_level, 1.0] x reservation with occasional spikes toward the
reservation — mimicking the "fluctuating, peak-reserved" behavior the
paper describes (reservations are engineered for peak demand, so the peak
of every profile touches ~the reservation at least once).

It emits the canonical :class:`~repro_torch.sim.scenarios.schema.Trace`
and registers as the ``"google"`` family.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.scenarios.registry import register
from repro_torch.sim.scenarios.schema import SEGMENTS, Trace

#: the engine's name for a trace
Workload = Trace


def _tenants(rng, N: int, n_tenants: int, skew: float) -> np.ndarray:
    """Zipf-skewed tenant assignment (tenant 0 is the heaviest); a copy of
    ``repro/sim/scenarios/families.py:_tenants``.  Consumes nothing from
    ``rng`` when ``n_tenants <= 1``."""
    if n_tenants <= 1:
        return np.zeros(N, np.int64)
    w = (1.0 + np.arange(n_tenants)) ** -float(skew)
    return rng.choice(n_tenants, size=N, p=w / w.sum()).astype(np.int64)


@dataclasses.dataclass(frozen=True)
class WorkloadConfig:
    n_apps: int = 500
    elastic_frac: float = 0.6
    max_components: int = 12       # core + elastic cap per app
    min_runtime: float = 120.0     # seconds
    max_runtime: float = 4 * 3600.0
    mean_burst_gap: float = 12.0   # bimodal inter-arrival: burst mode
    mean_long_gap: float = 600.0   # and long-gap mode
    burst_prob: float = 0.7
    # memory is the binding (finite) resource, as in the paper: the
    # mem:cpu demand ratio sits well above the hosts' 4 GB/core
    min_cpu: float = 0.25
    max_cpu: float = 2.0
    min_mem: float = 1.0           # GB
    max_mem: float = 32.0
    min_level: float = 0.10        # utilization floor (fraction of resv)
    spike_prob: float = 0.08       # per-segment probability of a peak
    jumpy_frac: float = 0.25       # "unpredictable" apps (cf. [66]): step
                                   # changes instead of smooth ramps
    seed: int = 0
    # control plane: Zipf-skewed tenant assignment (1 = single tenant,
    # bit-identical to the pre-tenancy generator)
    n_tenants: int = 1
    tenant_skew: float = 1.0


@register("google", WorkloadConfig,
          doc="the paper's Google-trace-shaped batch workload (§4.1)")
def generate(cfg: WorkloadConfig) -> Trace:
    rng = np.random.RandomState(cfg.seed)
    N, C = cfg.n_apps, cfg.max_components

    # --- arrival process: bimodal bursts + long gaps -------------------
    burst = rng.rand(N) < cfg.burst_prob
    gaps = np.where(burst,
                    rng.exponential(cfg.mean_burst_gap, N),
                    rng.exponential(cfg.mean_long_gap, N))
    submit = np.cumsum(gaps)

    # --- structure ------------------------------------------------------
    is_elastic = rng.rand(N) < cfg.elastic_frac
    # elastic apps (Spark-like): 3 core (controller/master/worker) + k
    # elastic workers carrying the bulk of the demand; rigid apps
    # (TF-like): 1-2 core components, no elastic.  The paper's traces are
    # overwhelmingly elastic-component-heavy (up to tens of thousands of
    # workers per app) — it is this elastic mass that Algorithm 1 evicts
    # first to absorb demand spikes without full preemptions.
    n_core = np.where(is_elastic, 3, rng.randint(1, 3, N))
    room = C - n_core
    n_elastic = np.where(is_elastic, rng.randint(2, np.maximum(room + 1, 3)), 0)
    n_elastic = np.minimum(n_elastic, room)

    idx = np.arange(C)[None, :]
    exists = idx < (n_core + n_elastic)[:, None]
    is_core = idx < n_core[:, None]

    # --- demands ---------------------------------------------------------
    cpu = np.round(np.exp(rng.uniform(np.log(cfg.min_cpu), np.log(cfg.max_cpu),
                                      (N, C))) * 4) / 4
    mem = np.exp(rng.uniform(np.log(cfg.min_mem), np.log(cfg.max_mem), (N, C)))
    # controller/master cores of elastic apps are lightweight coordinators
    light = is_elastic[:, None] & (idx < 2)
    cpu = np.where(light, np.minimum(cpu, 0.5), cpu)
    mem = np.where(light, np.minimum(mem, 2.0), mem)
    cpu_req = np.where(exists, np.maximum(cpu, cfg.min_cpu), 0.0).astype(np.float32)
    mem_req = np.where(exists, np.maximum(mem, cfg.min_mem), 0.0).astype(np.float32)

    # --- runtime (heavy right tail) ---------------------------------------
    runtime = np.exp(rng.uniform(np.log(cfg.min_runtime),
                                 np.log(cfg.max_runtime), N)).astype(np.float32)

    # --- utilization profiles: bounded random walk + spikes ---------------
    steps = rng.normal(0.0, 0.18, (N, C, SEGMENTS, 2))
    start = rng.uniform(cfg.min_level, 0.7, (N, C, 1, 2))
    walk = np.clip(start + np.cumsum(steps, axis=2), cfg.min_level, 1.0)
    spikes = rng.rand(N, C, SEGMENTS, 2) < cfg.spike_prob
    walk = np.where(spikes, rng.uniform(0.9, 1.0, walk.shape), walk)
    # guarantee every profile touches its reservation at least once
    # (reservations are engineered for peak demand — paper §1)
    peak_seg = rng.randint(0, SEGMENTS, (N, C, 1, 2))
    onehot = (np.arange(SEGMENTS)[None, None, :, None] == peak_seg)
    walk = np.where(onehot, np.maximum(walk, rng.uniform(0.92, 1.0, walk.shape)),
                    walk)
    levels = (walk * exists[:, :, None, None]).astype(np.float32)

    is_jumpy = rng.rand(N) < cfg.jumpy_frac
    # tenant draw LAST so n_tenants=1 (no draw) keeps the rng stream —
    # and therefore the whole trace — bit-identical to the seed generator
    tenant = _tenants(rng, N, cfg.n_tenants, cfg.tenant_skew)
    return Trace(submit=submit.astype(np.float32), is_elastic=is_elastic,
                 is_jumpy=is_jumpy,
                 n_core=n_core.astype(np.int64),
                 n_elastic=n_elastic.astype(np.int64),
                 runtime=runtime, cpu_req=cpu_req, mem_req=mem_req,
                 is_core=is_core & exists, levels=levels, cfg=cfg,
                 tenant=tenant).validate()
