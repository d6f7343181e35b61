"""Adaptive target-quantile controller: the failure-rate budget as a
set-point (counterpart of ``repro/core/uncertainty/adaptive.py``).

Following adaptive conformal inference (ACI), the level is servoed on
the realized miscoverage stream,

    q_{t+1} = clip(q_t + gamma * (err_t - budget), q_min, q_max),

where ``err_t`` is the fraction of this tick's resolved predictions
whose realized peak exceeded the deployed bound.  A fleet-level scalar,
in float64 Python arithmetic as the reference's.
"""
from __future__ import annotations

import numpy as np

from repro_torch.core.uncertainty.conformal import CalibrationConfig

__all__ = ["QuantileController"]


class QuantileController:
    """ACI-style integrator from miscoverage events to the target q."""

    def __init__(self, cfg: CalibrationConfig):
        self.cfg = cfg
        self.q = float(np.clip(cfg.q, cfg.q_min, cfg.q_max))
        self.steps = 0
        self.errors = 0          # miscoverage events seen
        self.resolved = 0        # predictions resolved

    def update(self, errors: np.ndarray) -> float:
        """Fold one tick's resolved miscoverage indicators (a boolean
        array) into q; an empty array leaves q as it is."""
        n = int(errors.size)
        if n == 0:
            return self.q
        err_rate = float(np.mean(errors))
        self.resolved += n
        self.errors += int(errors.sum())
        self.steps += 1
        self.q = float(np.clip(
            self.q + self.cfg.gamma * (err_rate - self.cfg.budget),
            self.cfg.q_min, self.cfg.q_max))
        return self.q

    @property
    def miscoverage(self) -> float:
        """Lifetime realized miscoverage rate (the budget's read-back)."""
        return self.errors / max(self.resolved, 1)
