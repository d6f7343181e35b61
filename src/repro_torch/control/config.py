"""Tenancy configuration and the SLO-class constants (a copy of
``repro/control/config.py``).

A leaf module: it imports nothing of the package, so the trace schema
and the engines can use it without cycles.
"""
from __future__ import annotations

import dataclasses

import numpy as np

#: SLO classes a trace may tag apps with, weakest first; ``Trace.slo``
#: holds an index into this tuple.
SLO_CLASSES = ("best-effort", "standard", "premium")

#: Turnaround stretch budget per SLO class: an app meets its SLO when
#: ``turnaround <= stretch * runtime``.
SLO_STRETCH = (8.0, 4.0, 2.0)

#: Error budget per SLO class: the fraction of a tenant's apps allowed to
#: miss their turnaround SLO.
SLO_BUDGET = (0.25, 0.10, 0.02)


@dataclasses.dataclass(frozen=True)
class TenancyConfig:
    """``SimConfig.control``, the multi-tenant control plane.

    Off by default, and off it allocates no tenant state and runs no
    gate: the engines are then exactly what they are without it."""

    enabled: bool = False
    #: width of the tenant axis of the device state; a trace's tenant ids
    #: must be below it
    max_tenants: int = 8
    #: per-tenant wDRF weights, padded with 1.0 up to ``max_tenants``
    #: (empty = unweighted DRF); a tenant's share is its dominant share
    #: divided by its weight
    weights: tuple = ()
    #: admission gate: a tenant whose share exceeds the mean share of the
    #: active tenants by more than ``slack`` admits nothing this tick
    gate: bool = True
    slack: float = 0.10
    #: online credit score, an EMA of good (completions, covered
    #: conformal resolutions) against bad (failures, conflicts,
    #: miscoverage) events; it scales the gate's headroom (``slack *
    #: credit``) and moves each tenant's conformal target quantile
    credit: bool = True
    credit_gamma: float = 0.10
    credit_floor: float = 0.05
    credit_init: float = 0.5
    #: half-width of the credit -> quantile band: credit 0 targets ``q +
    #: q_spread``, credit 1 ``q - q_spread``
    q_spread: float = 0.05


def resolve_weights(cfg: TenancyConfig) -> np.ndarray:
    """``(max_tenants,)`` float32 wDRF weights, 1.0-padded."""
    w = np.ones(cfg.max_tenants, np.float32)
    given = np.asarray(cfg.weights, np.float32)
    if given.size > cfg.max_tenants:
        raise ValueError(f"{given.size} weights for "
                         f"max_tenants={cfg.max_tenants}")
    if np.any(given <= 0):
        raise ValueError("tenant weights must be positive")
    w[:given.size] = given
    return w
