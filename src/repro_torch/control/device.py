"""The device engine's tenant accounting (counterpart of
``repro/control/device.py``): :class:`TenantState`, tensors with a
leading member axis carried through the fused tick, updated once a tick
by the control step (``ops.control_tick``) and the gated admission
(``ops.admit_queued``).  The host engine keeps the same counters in
:class:`~repro_torch.control.host.HostControl`; both drain into
:func:`~repro_torch.control.summary.tenancy_summary`.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.control.config import TenancyConfig, resolve_weights


@dataclasses.dataclass(frozen=True)
class TenantState:
    """Per-tenant counters, ``(S, T)`` each: S members, T =
    ``TenancyConfig.max_tenants``."""

    credit: torch.Tensor        # f32 online credit score in [floor, 1]
    admitted: torch.Tensor      # i32 apps admitted through the gate
    throttled: torch.Tensor     # i32 queued app-ticks held back by the gate
    completed: torch.Tensor     # i32 apps completed
    failed: torch.Tensor        # i32 failure events (conflicts + OOM kills)
    share_sum: torch.Tensor     # f32 sum of the wDRF share over active ticks
    active_ticks: torch.Tensor  # i32 ticks the tenant was running or queued


def control_init(cfg: TenancyConfig, batch: int, device) -> TenantState:
    """Fresh tenant state for ``batch`` members on ``device``."""
    T = cfg.max_tenants

    def zi():
        return torch.zeros((batch, T), dtype=torch.int32, device=device)
    return TenantState(
        credit=torch.full((batch, T), float(np.float32(cfg.credit_init)),
                          dtype=torch.float32, device=device),
        admitted=zi(), throttled=zi(), completed=zi(), failed=zi(),
        share_sum=torch.zeros((batch, T), dtype=torch.float32, device=device),
        active_ticks=zi())


def device_weights(cfg: TenancyConfig, device) -> torch.Tensor:
    """The resolved wDRF weights, ``(T,)`` float32 on ``device``."""
    return torch.from_numpy(resolve_weights(cfg)).to(device)


def credit_mean(credit: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """Mean credit over the active tenants, per member (the telemetry
    rings' ``credit`` series): inactive tenants sit at their initial value
    and would wash the signal out of a plain mean."""
    n = active.sum(-1)
    s = torch.where(active, credit, 0.0).sum(-1)
    return torch.where(n > 0, s / torch.clamp_min(n, 1), torch.zeros_like(s))
