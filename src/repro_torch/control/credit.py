"""Online tenant credit score (counterpart of ``repro/control/credit.py``).

An EMA of each tenant's good-against-bad outcome ratio: completions and
covered conformal resolutions raise it, failures (OOM kills, optimistic
conflicts) and miscoverage lower it.  It feeds back twice: the admission
gate's headroom is ``slack * credit``, and :func:`credit_quantile` moves
the tenant's conformal target quantile.  Numpy inputs run the
reference's numpy arithmetic, tensors the same formulas in torch.
"""
from __future__ import annotations

import numpy as np
import torch


def credit_step(credit, good, bad, gamma, floor):
    """One EMA step, ``credit += gamma * (good_ratio - credit)``, clipped to
    ``[floor, 1]``; ``good`` and ``bad`` are the tick's per-tenant event
    counts, and a tenant with no event keeps its credit."""
    if isinstance(credit, torch.Tensor):
        g, b = good.float(), bad.float()
        tot = g + b
        target = torch.where(tot > 0, g / torch.clamp_min(tot, 1.0), credit)
        new = credit + np.float32(gamma) * (target - credit)
        return torch.clamp(new, float(np.float32(floor)), 1.0).float()
    g = good.astype(np.float32)
    b = bad.astype(np.float32)
    tot = g + b
    ratio = g / np.maximum(tot, 1.0)
    target = np.where(tot > 0, ratio, credit)
    new = credit + np.float32(gamma) * (target - credit)
    return np.clip(new, np.float32(floor), np.float32(1.0)).astype(np.float32)


def credit_quantile(credit, q, spread, q_min, q_max):
    """Per-tenant conformal target quantile, linear in credit: credit 0.5
    keeps ``q``, 0 targets ``q + spread`` and 1 ``q - spread``, clipped to
    the calibrator's ``[q_min, q_max]``."""
    if isinstance(credit, torch.Tensor):
        qs = q + np.float32(spread) * (1.0 - 2.0 * credit)
        return torch.clamp(qs, float(np.float32(q_min)), float(np.float32(q_max))).float()
    qs = q + np.float32(spread) * (1.0 - 2.0 * credit)
    return np.clip(qs, np.float32(q_min), np.float32(q_max)).astype(np.float32)
