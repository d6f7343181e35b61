"""The host engine's tenant accounting (a numpy copy of
``repro/control/host.py``): what :class:`~repro_torch.control.device.
TenantState` is to the device engine, updated in place by
``repro_torch.sim.engine.run_sim``.

Per tick:

1. phases 2-5 call :meth:`note_completed`, :meth:`note_failed` and
   :meth:`note_calib` as events land;
2. shaping (phase 4) reads :meth:`q_groups`, from the previous tick's
   credit;
3. at admission :meth:`gate` folds the tick's events into the credit,
   accrues the share accounting and returns the per-tenant eligibility;
4. the admission loop calls :meth:`note_admitted` for each placed app.

The arithmetic is the reference's float32 numpy, rounded at every
operation (the reference's compiled device tick contracts some of it into
fused multiply-adds; its host engine does not).
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.config import TenancyConfig, resolve_weights
from repro_torch.control.credit import credit_quantile, credit_step
from repro_torch.control.fairness import dominant_shares, gate_mask


class HostControl:
    def __init__(self, cfg: TenancyConfig):
        T = cfg.max_tenants
        self.cfg = cfg
        self.weights = resolve_weights(cfg)
        self.credit = np.full(T, cfg.credit_init, np.float32)
        self.admitted = np.zeros(T, np.int64)
        self.throttled = np.zeros(T, np.int64)
        self.completed = np.zeros(T, np.int64)
        self.failed = np.zeros(T, np.int64)
        self.share_sum = np.zeros(T, np.float32)
        self.active_ticks = np.zeros(T, np.int64)
        self._good = np.zeros(T, np.int64)
        self._bad = np.zeros(T, np.int64)

    def note_completed(self, tenants) -> None:
        np.add.at(self.completed, tenants, 1)
        np.add.at(self._good, tenants, 1)

    def note_failed(self, tenants) -> None:
        """A failure event (optimistic conflict or OOM kill of a core)."""
        np.add.at(self.failed, tenants, 1)
        np.add.at(self._bad, tenants, 1)

    def note_calib(self, covered, miscovered) -> None:
        """The tick's per-tenant conformal resolutions."""
        self._good += np.asarray(covered, np.int64)
        self._bad += np.asarray(miscovered, np.int64)

    def note_admitted(self, tenant: int) -> None:
        self.admitted[tenant] += 1

    def q_groups(self, q: float, q_min: float, q_max: float) -> np.ndarray:
        """Per-tenant conformal target quantile from the current credit."""
        if not self.cfg.credit:
            return np.full(self.cfg.max_tenants, q, np.float32)
        return credit_quantile(self.credit, q, self.cfg.q_spread, q_min, q_max)

    def gate(self, alloc_t: np.ndarray, cap: np.ndarray,
             queued_t: np.ndarray) -> np.ndarray:
        """Fold the tick's events into the credit, accrue the share
        accounting and return the per-tenant admission eligibility:
        ``alloc_t`` (T, R) allocated resources per tenant, ``cap`` (R,) the
        cluster's capacity, ``queued_t`` (T,) queued apps per tenant."""
        cfg = self.cfg
        if cfg.credit:
            self.credit = credit_step(self.credit, self._good, self._bad,
                                      cfg.credit_gamma, cfg.credit_floor)
        self._good[:] = 0
        self._bad[:] = 0
        share = dominant_shares(np.asarray(alloc_t, np.float32),
                                np.asarray(cap, np.float32), self.weights)
        active = (share > 0) | (queued_t > 0)
        self.share_sum += np.float32(share * active)
        self.active_ticks += active
        if cfg.gate:
            slack = (np.float32(cfg.slack) * self.credit
                     if cfg.credit else np.float32(cfg.slack))
            elig = gate_mask(share, active, slack)
        else:
            elig = np.ones(cfg.max_tenants, bool)
        self.throttled += np.where(elig, 0, queued_t).astype(np.int64)
        return elig

    def arrays(self) -> dict:
        return dict(credit=self.credit, admitted=self.admitted,
                    throttled=self.throttled, completed=self.completed,
                    failed=self.failed, share_sum=self.share_sum,
                    active_ticks=self.active_ticks)
