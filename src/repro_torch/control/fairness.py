"""Weighted dominant-resource fairness (wDRF) accounting (counterpart of
``repro/control/fairness.py``).

Every function takes numpy arrays or torch tensors, as the reference's
take numpy or JAX arrays: numpy inputs run the reference's numpy
arithmetic to the bit, tensors the same formulas in torch with numpy's
type promotions and numpy's sums over the (few) tenants.  The device engine's tick does
not call them: its control step is one kernel (``ops.control_tick``),
which rounds as the reference's compiled tick does.
"""
from __future__ import annotations

import numpy as np
import torch


def _torch(*arrays) -> bool:
    return any(isinstance(a, torch.Tensor) for a in arrays)


def _sum(x: torch.Tensor) -> torch.Tensor:
    """numpy's sum of ``x`` (its order of the float32 additions), as a
    0-d tensor on ``x``'s device: these sums run over a handful of
    tenants, off the engines' device path."""
    return torch.as_tensor(np.sum(x.detach().cpu().numpy()), device=x.device)


def dominant_shares(alloc, cap, weights):
    """Per-tenant weighted dominant share: ``alloc`` (T, R) allocated
    resources per tenant, ``cap`` (R,) the cluster capacity, ``weights``
    (T,) the wDRF weights.  A tenant's dominant share is its largest
    capacity-normalized allocation (DRF); the weight divides it."""
    if _torch(alloc, cap, weights):
        norm = alloc / torch.clamp_min(cap, 1e-9)[None, :]
        return (norm.max(-1).values / weights).float()
    norm = alloc / np.maximum(cap, 1e-9)[None, :]
    return (np.max(norm, axis=-1) / weights).astype(np.float32)


def jain_index(shares, active=None):
    """Jain's fairness index ``(sum x)^2 / (n * sum x^2)`` over the active
    tenants' shares (all by default): 1.0 when they are equal, 1/n when
    one holds everything, and 1.0 with no active tenant or all zero.  On
    tensors it takes numpy's types: float64 once the active count
    multiplies (numpy's integer scalar times a float32 one), float32
    without a mask."""
    if _torch(shares, active):
        x = shares if active is None else shares * active
        num, sq = _sum(x) ** 2, _sum(x * x)
        if active is None:
            den = x.numel() * sq
            ratio = num / torch.clamp_min(den, 1e-30)
        else:
            den = active.sum().double() * sq.double()
            ratio = num.double() / torch.clamp_min(den, 1e-30)
        return torch.where(den > 0, ratio, 1.0)
    x = shares if active is None else shares * active
    n = x.size if active is None else active.sum()
    num = np.sum(x) ** 2
    den = n * np.sum(x * x)
    return np.where(den > 0, num / np.maximum(den, 1e-30), 1.0)


def gate_mask(shares, active, slack):
    """Admission-gate eligibility per tenant: a tenant may admit this
    tick unless its share exceeds the mean share of the active tenants
    (running or queued) by more than ``slack`` (a scalar, or per tenant:
    the credit-scaled headroom).  Inactive tenants are eligible."""
    n = active.sum()
    if _torch(shares, active):
        # numpy's types: a float32 sum over an integer count is float64
        mean = torch.where(n > 0, _sum(shares * active).double() / torch.clamp_min(n, 1),
                           0.0)
        return (~active) | (shares <= mean + slack)
    mean = np.where(n > 0, np.sum(shares * active) / np.maximum(n, 1), 0.0)
    return (~active) | (shares <= mean + slack)
