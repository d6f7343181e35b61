"""Observability configuration (the ``SimConfig.obs`` field), a copy of
``repro/obs/config.py``.

Frozen and hashable like every other config block: the device engine's
graph cache keys on it (``repro_torch.sim.step._cfg_key``).
"""
from __future__ import annotations

import dataclasses


@dataclasses.dataclass(frozen=True)
class ObsConfig:
    """The device engine's telemetry rings (:mod:`repro_torch.obs.rings`).

    Disabled by default: ``SimState.obs`` is then None and the tick
    launches nothing for it, so runs with the rings off are the engine
    without them."""

    enabled: bool = False
    # ring capacity in ticks; the chunk drivers drain the rings at every
    # chunk boundary, so it must be >= the chunk size (enforced by
    # repro_torch.sim.step) or undrained ticks would be overwritten
    ring: int = 128
