"""The multi-tenant control plane over the simulation engines
(counterpart of ``repro.control``): per-tenant admission in front of the
shaper, as in Flex (Le & Liu, 2020) and the two-stage Mesos work
(Rattihalli et al., 2019).

  * :mod:`~repro_torch.control.config`   — ``TenancyConfig`` (the
    ``SimConfig.control`` field) and the SLO-class constants;
  * :mod:`~repro_torch.control.fairness` — weighted dominant-resource
    shares, Jain's index, the admission gate mask;
  * :mod:`~repro_torch.control.credit`   — the tenant credit score and
    the credit -> conformal quantile mapping;
  * :mod:`~repro_torch.control.device`   — ``TenantState``, the device
    engine's counters;
  * :mod:`~repro_torch.control.host`     — ``HostControl``, the host
    engine's;
  * :mod:`~repro_torch.control.summary`  — the per-tenant results block,
    ``SimResults.tenancy``.
"""
from repro_torch.control.config import (SLO_BUDGET, SLO_CLASSES, SLO_STRETCH,
                                        TenancyConfig, resolve_weights)
from repro_torch.control.credit import credit_quantile, credit_step
from repro_torch.control.device import TenantState, control_init
from repro_torch.control.fairness import dominant_shares, gate_mask, jain_index
from repro_torch.control.host import HostControl
from repro_torch.control.summary import tenancy_summary

__all__ = [
    "SLO_CLASSES", "SLO_STRETCH", "SLO_BUDGET", "TenancyConfig", "resolve_weights",
    "credit_quantile", "credit_step", "TenantState", "control_init",
    "dominant_shares", "gate_mask", "jain_index", "HostControl",
    "tenancy_summary",
]
