"""The per-tenant results block, ``SimResults.tenancy`` (a numpy copy of
``repro/control/summary.py``).

Both engines build it here: the host engine from
``HostControl.arrays()``, the device engine from its ``TenantState``
read back to numpy.  The turnaround and SLO columns come from the trace
and the turnaround dict only, so they are equal across engines by
construction.
"""
from __future__ import annotations

import numpy as np

from repro_torch.control.config import SLO_STRETCH, TenancyConfig
from repro_torch.control.fairness import jain_index


def tenancy_summary(cfg: TenancyConfig, trace, turnaround: dict,
                    failed_apps: set, arrays: dict) -> dict:
    """Per-tenant fairness, SLO, turnaround and credit block.  ``arrays``
    holds the counters (the keys of ``HostControl.arrays``), ``trace`` the
    workload (its ``tenant``, ``slo`` and ``runtime`` columns),
    ``turnaround`` the completed apps' seconds by gid."""
    tenant = np.asarray(trace.tenant, np.int64)
    slo = np.asarray(trace.slo, np.int64)
    Tn = int(tenant.max()) + 1 if tenant.size else 1

    ticks = np.asarray(arrays["active_ticks"], np.int64)[:Tn]
    share_sum = np.asarray(arrays["share_sum"], np.float64)[:Tn]
    mean_share = share_sum / np.maximum(ticks, 1)
    jain = float(jain_index(mean_share, ticks > 0))

    ta_mean = np.full(Tn, np.nan)
    ta_p95 = np.full(Tn, np.nan)
    slo_met = np.full(Tn, np.nan)
    done_t = np.zeros(Tn, np.int64)
    fail_t = np.zeros(Tn, np.int64)
    # majority SLO class per tenant (the key of its error budget)
    slo_class = np.zeros(Tn, np.int64)
    for t in range(Tn):
        codes = slo[tenant == t]
        if codes.size:
            slo_class[t] = int(np.bincount(codes).argmax())
    stretch = np.asarray(SLO_STRETCH)[slo]
    for t in range(Tn):
        gids = [g for g in turnaround if tenant[g] == t]
        done_t[t] = len(gids)
        fail_t[t] = sum(1 for g in failed_apps if tenant[g] == t)
        if gids:
            ta = np.asarray([turnaround[g] for g in gids], np.float64)
            ta_mean[t] = ta.mean()
            ta_p95[t] = np.percentile(ta, 95)
            budget = stretch[gids] * np.asarray(trace.runtime, np.float64)[gids]
            slo_met[t] = float(np.mean(ta <= budget))

    def _fl(a):
        return [round(float(v), 6) for v in a]

    return {
        "n_tenants": Tn,
        "jain_mean_share": round(jain, 6),
        "mean_share": _fl(mean_share),
        "active_ticks": [int(v) for v in ticks],
        "credit": _fl(np.asarray(arrays["credit"], np.float64)[:Tn]),
        "admitted": [int(v) for v in np.asarray(arrays["admitted"])[:Tn]],
        "throttled": [int(v) for v in np.asarray(arrays["throttled"])[:Tn]],
        "completed": [int(v) for v in done_t],
        "failed_apps": [int(v) for v in fail_t],
        "failure_events": [int(v) for v in np.asarray(arrays["failed"])[:Tn]],
        "turnaround_mean": _fl(ta_mean),
        "turnaround_p95": _fl(ta_p95),
        "slo_met_frac": _fl(slo_met),
        "slo_class": [int(v) for v in slo_class],
    }
