"""Pessimistic preemption policy — paper Algorithm 1, in PyTorch.

Counterpart of ``repro/core/shaper/pessimistic.py``.  A greedy pass over
running applications in scheduler order:

  * an application's CORE components are fitted first, host by host; if
    any host would go negative the whole application is marked for FULL
    preemption (paper lines 11-21, 34-36);
  * surviving applications then fit their ELASTIC components one at a
    time, oldest-first (sorted by timeAlive, line 25) — a component that
    does not fit is PARTIALLY preempted on its own (lines 26-33, 37-38);
  * every surviving component is resized to its shaped demand.

Core checks use ``< 0`` and elastic checks ``<= 0`` as in the listing.

The reference's ``lax.scan`` over apps with an inner scan over
components becomes a Python loop over apps with the component loop
inside it.  Every decision stays a tensor on the problem's device: the
loop never waits for the device.  The loop skips, by host-side indices
read once per call, the steps that cannot change anything: positions of
``app_order`` that hold no existing app (the engine fills a prefix and
pads with -1) and components that are not elastic.  Each remaining step
is a handful of launches on tensors of a few elements, so on the card
this pass is bound by launch overhead (see PERF.md).
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch


@dataclasses.dataclass(frozen=True)
class ShapeProblem:
    """Fixed-size cluster state handed to a shaping policy.

    A = max apps, C = max components per app, H = hosts.
    Demands are the shaped targets (forecast + beta) per component."""

    host_cpu: torch.Tensor     # (H,) capacity
    host_mem: torch.Tensor     # (H,)
    app_exists: torch.Tensor   # (A,) bool
    app_order: torch.Tensor    # (A,) int64 processing order; padded with -1
    comp_exists: torch.Tensor  # (A, C) bool
    comp_core: torch.Tensor    # (A, C) bool
    comp_host: torch.Tensor    # (A, C) int64 host index (0 if absent)
    comp_cpu: torch.Tensor     # (A, C) shaped cpu demand
    comp_mem: torch.Tensor     # (A, C) shaped mem demand
    comp_alive: torch.Tensor   # (A, C) seconds alive (elastic sort key)


@dataclasses.dataclass(frozen=True)
class ShapeDecision:
    kill_app: torch.Tensor     # (A,) bool — full preemption
    kill_comp: torch.Tensor    # (A, C) bool — partial (elastic) preemption
    alloc_cpu: torch.Tensor    # (A, C) granted allocation (0 for killed)
    alloc_mem: torch.Tensor    # (A, C)
    cpu_free: torch.Tensor     # (H,) remaining after allocation
    mem_free: torch.Tensor     # (H,)


def _scatter_any(index: torch.Tensor, src: torch.Tensor, size: int) -> torch.Tensor:
    """``out[index[i]] |= src[i]`` along axis 0: an OR, so duplicate
    indices (padded rows all point at app 0) cannot overwrite a True."""
    idx = index.reshape(index.shape + (1,) * (src.dim() - 1)).expand(src.shape)
    out = torch.zeros((size,) + tuple(src.shape[1:]), dtype=torch.int32,
                      device=src.device)
    return out.scatter_reduce_(0, idx, src.to(torch.int32), "amax").bool()


def pessimistic_shape(p: ShapeProblem) -> ShapeDecision:
    A, C = p.comp_exists.shape
    H = p.host_cpu.shape[0]
    dev = p.comp_exists.device

    # elastic processing order per app: oldest (largest timeAlive) first;
    # stable, as jnp.argsort is: components placed in the same tick tie
    alive_key = torch.where(p.comp_exists & ~p.comp_core, p.comp_alive,
                            float("-inf"))
    elastic_order = torch.argsort(-alive_key, dim=1, stable=True)   # (A, C)

    # everything the sequential pass reads, gathered into processing order
    a_all = torch.clamp_min(p.app_order, 0)
    valid_all = (p.app_order >= 0) & p.app_exists[a_all]
    exists = p.comp_exists[a_all]
    is_core = p.comp_core[a_all]
    host = p.comp_host[a_all]
    row_dem = torch.stack([p.comp_cpu[a_all], p.comp_mem[a_all]], -1)  # (A,C,2)
    core = exists & is_core
    host_oh = host[:, :, None] == torch.arange(H, device=dev)        # (A,C,H)
    # per-app core demand per host, summed over components in order
    core_dem_all = torch.zeros((A, H, 2), dtype=row_dem.dtype, device=dev)
    for c in range(C):
        core_dem_all = core_dem_all + torch.where(
            (core[:, c, None] & host_oh[:, c])[:, :, None],
            row_dem[:, c, None, :], 0.0)
    order = elastic_order[a_all]                                     # (A, C)
    ord_dem = torch.take_along_dim(row_dem, order[:, :, None], 1)    # (A,C,2)
    ord_el = torch.take_along_dim(exists & ~is_core, order, 1)
    ord_host = torch.take_along_dim(host, order, 1)

    # host-side indices of the steps that can change anything
    rows = np.flatnonzero(valid_all.cpu().numpy()).tolist()
    el_host = ord_el.cpu().numpy()
    host_host = ord_host.cpu().numpy()

    free = torch.stack([p.host_cpu, p.host_mem], -1)                 # (H, 2)
    removes, kills, kill_rc = [], [], []
    for r in rows:
        # ---- core components (lines 11-19): aggregate per-host demand ----
        trial = free - core_dem_all[r]
        remove = (trial < 0.0).any()
        keep = ~remove
        free = torch.where(remove, free, trial)
        removes.append(remove)
        # ---- elastic components (lines 25-33): sequential oldest-first ----
        for j in np.flatnonzero(el_host[r]).tolist():
            h = int(host_host[r, j])
            after = free[h] - ord_dem[r, j]
            kill_c = keep & (after <= 0.0).any()
            free[h] = torch.where(keep ^ kill_c, after, free[h])
            kills.append(kill_c)
            kill_rc.append((r, j))

    # scatter back: kill positions -> component order, processing order ->
    # app-index order
    remove_pos = torch.zeros((A,), dtype=torch.bool, device=dev)
    kill_pos = torch.zeros((A, C), dtype=torch.bool, device=dev)
    if rows:
        remove_pos[torch.tensor(rows, device=dev)] = torch.stack(removes)
    if kills:
        rc = torch.tensor(kill_rc, device=dev)
        kill_pos[rc[:, 0], rc[:, 1]] = torch.stack(kills)
    kill_rows = torch.zeros((A, C), dtype=torch.bool, device=dev).scatter_(
        1, order, kill_pos)
    kill_app = _scatter_any(a_all, remove_pos, A)
    kill_comp = _scatter_any(a_all, kill_rows, A)

    survive = (p.comp_exists & p.app_exists[:, None]
               & ~kill_app[:, None] & ~kill_comp)
    return ShapeDecision(kill_app=kill_app, kill_comp=kill_comp,
                         alloc_cpu=torch.where(survive, p.comp_cpu, 0.0),
                         alloc_mem=torch.where(survive, p.comp_mem, 0.0),
                         cpu_free=free[:, 0], mem_free=free[:, 1])
