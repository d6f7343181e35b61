"""Canonical trace schema consumed by the simulation engine.

A copy of ``repro/sim/scenarios/schema.py`` (numpy only).  A
:class:`Trace` is a column-oriented application table: arrival times,
per-component reservations, rigid/elastic tags and piecewise-linear
utilization profiles.  Every workload source emits this one schema, so
the engines run any of them unchanged.  Ported sources: the
Google-shaped generator in :mod:`repro_torch.sim.workload`, the
parametric families in :mod:`repro_torch.sim.scenarios.families`, the
CSV/Parquet replay adapter in :mod:`repro_torch.sim.scenarios.replay`
and :func:`repro_torch.convert.trace_from_arrays`.

Invariants (checked by :meth:`Trace.validate`):

  * ``submit`` is nondecreasing — the engine's arrival scan pops apps
    in submission order;
  * reservations are nonnegative and CPU/MEM agree on which components
    exist (``cpu_req > 0`` iff ``mem_req > 0``);
  * every app has at least one core component and core components are a
    prefix-consistent subset of existing ones; rigid apps (``is_elastic
    == False``) carry no elastic components;
  * utilization levels live in ``[0, 1]`` (fraction of the reservation
    — usage can never exceed what was reserved) and are zero for absent
    components;
  * tenant ids are nonnegative and SLO classes index ``SLO_CLASSES``.  Both columns are OPTIONAL:
    tenant-less sources back-compat to a single default tenant 0 with
    the ``best-effort`` SLO class (``__post_init__`` normalizes
    ``None`` to zeros), so every pre-control-plane trace still
    validates and runs bit-identically.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np

#: SLO class names, as ``repro_torch/control/config.py`` has them (a
#: copy here keeps the schema free of the control plane's imports)
SLO_CLASSES = ("best-effort", "standard", "premium")

#: number of piecewise-linear utilization knots per component profile
SEGMENTS = 32
CPU, MEM = 0, 1


class TraceValidationError(ValueError):
    """Raised by :meth:`Trace.validate` with every violated invariant."""


@dataclasses.dataclass
class Trace:
    """Column-oriented application table (index = global app id)."""

    submit: np.ndarray        # (N,) seconds, nondecreasing
    is_elastic: np.ndarray    # (N,) bool
    is_jumpy: np.ndarray      # (N,) bool — "unpredictable" class
    n_core: np.ndarray        # (N,) int
    n_elastic: np.ndarray     # (N,) int
    runtime: np.ndarray       # (N,) base runtime (all components running)
    cpu_req: np.ndarray       # (N, C) per-component reservation (0 = absent)
    mem_req: np.ndarray       # (N, C) GB
    is_core: np.ndarray       # (N, C) bool
    levels: np.ndarray        # (N, C, SEGMENTS, 2) utilization fraction
    cfg: Any = None           # the scenario config that built this trace
    tenant: np.ndarray = None  # (N,) int tenant id (None -> all tenant 0)
    slo: np.ndarray = None     # (N,) int index into SLO_CLASSES

    def __post_init__(self):
        # tenant-less back-compat: a trace built without the control
        # plane is a single default tenant on the weakest SLO class
        n = self.submit.shape[0] if isinstance(self.submit, np.ndarray) else 0
        if self.tenant is None:
            self.tenant = np.zeros(n, np.int64)
        if self.slo is None:
            self.slo = np.zeros(n, np.int64)

    @property
    def n_apps(self) -> int:
        return self.submit.shape[0]

    @property
    def max_components(self) -> int:
        return self.cpu_req.shape[1]

    @property
    def n_tenants(self) -> int:
        return int(self.tenant.max()) + 1 if self.tenant.size else 1

    def usage(self, gid: np.ndarray, progress: np.ndarray) -> np.ndarray:
        """(len(gid), C, 2) instantaneous usage at given progress in [0,1].

        Levels are linearly interpolated between segment knots: real
        utilization ramps (allocators grow/shrink heaps over minutes)
        rather than stepping discontinuously — this is what makes the
        series *learnable*, which the paper's Fig. 2 error distributions
        presuppose."""
        x = np.clip(progress, 0.0, 1.0) * (SEGMENTS - 1)
        s0 = np.minimum(x.astype(np.int64), SEGMENTS - 2)
        frac = (x - s0).astype(np.float32)
        ar = np.arange(len(gid))[:, None]
        ac = np.arange(self.max_components)[None, :]
        lv0 = self.levels[gid][ar, ac, s0[:, None], :]
        lv1 = self.levels[gid][ar, ac, s0[:, None] + 1, :]
        lv = lv0 + (lv1 - lv0) * frac[:, None, None]
        # "unpredictable" apps step discontinuously (no ramp to learn from)
        jumpy = self.is_jumpy[gid][:, None, None]
        lv = np.where(jumpy, lv0, lv)
        req = np.stack([self.cpu_req[gid], self.mem_req[gid]], axis=-1)
        return lv * req

    # ------------------------------------------------------------------
    def validate(self) -> "Trace":
        """Check every schema invariant; raise with the full list of
        violations (returns self so builders can ``return tr.validate()``)."""
        p: list[str] = []
        N, C = self.n_apps, self.max_components
        if N < 1:
            raise TraceValidationError("trace has no applications")

        shapes = {"submit": (N,), "is_elastic": (N,), "is_jumpy": (N,),
                  "n_core": (N,), "n_elastic": (N,), "runtime": (N,),
                  "cpu_req": (N, C), "mem_req": (N, C), "is_core": (N, C),
                  "levels": (N, C, SEGMENTS, 2),
                  "tenant": (N,), "slo": (N,)}
        for name, want in shapes.items():
            a = getattr(self, name)
            if not isinstance(a, np.ndarray):
                p.append(f"{name}: not an ndarray")
            elif a.shape != want:
                p.append(f"{name}: shape {a.shape}, want {want}")
        if p:
            raise TraceValidationError("; ".join(p))

        for name in ("submit", "runtime", "cpu_req", "mem_req", "levels"):
            if not np.isfinite(getattr(self, name)).all():
                p.append(f"{name}: non-finite values")
        if (np.diff(self.submit) < 0).any():
            p.append("submit: not nondecreasing (engine pops arrivals "
                     "in submission order)")
        if (self.submit < 0).any():
            p.append("submit: negative times")
        if (self.runtime <= 0).any():
            p.append("runtime: must be positive")

        exists = self.cpu_req > 0
        if ((self.mem_req > 0) != exists).any():
            p.append("cpu_req/mem_req disagree on which components exist")
        if (self.cpu_req < 0).any() or (self.mem_req < 0).any():
            p.append("negative reservations")
        if (self.is_core & ~exists).any():
            p.append("is_core set on absent components")
        if (self.is_core.sum(1) < 1).any():
            p.append("every app needs >= 1 core component (progress "
                     "requires a full core set)")
        if (self.n_core != self.is_core.sum(1)).any():
            p.append("n_core inconsistent with is_core")
        if (self.n_elastic != (exists & ~self.is_core).sum(1)).any():
            p.append("n_elastic inconsistent with existing non-core "
                     "components")
        if (self.n_elastic[~self.is_elastic] != 0).any():
            p.append("rigid apps must carry no elastic components")

        if (self.levels < 0).any() or (self.levels > 1).any():
            p.append("levels: outside [0, 1] (fraction of reservation)")
        if (self.levels[~exists] != 0).any():
            p.append("levels: nonzero for absent components")

        if (self.tenant < 0).any():
            p.append("tenant: negative tenant ids")
        if (self.slo < 0).any() or (self.slo >= len(SLO_CLASSES)).any():
            p.append(f"slo: outside [0, {len(SLO_CLASSES) - 1}] "
                     f"(indexes SLO_CLASSES)")

        if p:
            raise TraceValidationError("; ".join(p))
        return self


def sort_by_submit(submit: np.ndarray, **columns: np.ndarray) -> dict:
    """Stable-sort per-app columns by submission time.

    Generator families that interleave several arrival processes (e.g.
    flashcrowd's background + burst populations) build their columns in
    population order and call this to restore the engine's required
    arrival order.  Returns ``{"submit": sorted, **columns sorted}``.
    """
    order = np.argsort(submit, kind="stable")
    out = {"submit": submit[order]}
    for name, col in columns.items():
        out[name] = col[order]
    return out
