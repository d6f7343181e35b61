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

The rows are gathered into processing order with a few batched tensor
operations; the sequential pass itself, the reference's ``lax.scan``
over apps with an inner scan over components, is
``repro_torch.kernels.ops.pessimistic_pass``: one CUDA kernel launch on
the card (``kernels/csrc/shaper.cu``, one block per member with the
member's state staged in shared memory), the plain loop of
``kernels/ref.py`` on the CPU.
Nothing is read back to the host, so on the card a call is a fixed
number of asynchronous launches whatever the number of running apps.
A problem may carry a leading member axis (the device engine's batch of
simulations); the host engine passes one cluster.
"""
from __future__ import annotations

import dataclasses

import torch

from repro_torch.kernels import ops as kops


@dataclasses.dataclass(frozen=True)
class ShapeProblem:
    """Fixed-size cluster state handed to a shaping policy.

    A = max apps, C = max components per app, H = hosts.
    Demands are the shaped targets (forecast + beta) per component."""

    host_cpu: torch.Tensor     # (H,) capacity (every field may carry a
                               #   leading member axis S)
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
    """``out[s, index[s, i]] |= src[s, i]`` along axis 1: an OR, so
    duplicate indices (padded rows all point at app 0) cannot overwrite a
    True."""
    idx = index.reshape(index.shape + (1,) * (src.dim() - 2)).expand(src.shape)
    out = torch.zeros((src.shape[0], size) + tuple(src.shape[2:]), dtype=torch.int32,
                      device=src.device)
    return out.scatter_reduce_(1, idx, src.to(torch.int32), "amax").bool()


def gather_rows(x: torch.Tensor, index: torch.Tensor) -> torch.Tensor:
    """``x[s, index[s, i]]``: member s's rows in the order ``index`` gives."""
    tail = x.shape[2:]
    idx = index.reshape(index.shape + (1,) * len(tail)).expand(index.shape + tail)
    return torch.gather(x, 1, idx)


def pass_inputs(p: ShapeProblem):
    """What the sequential pass reads, gathered into processing order, for
    a problem with a leading member axis: ``(valid, dem, core, el, host,
    order, free0)`` as ``ops.pessimistic_pass`` takes them, and the
    processing order's app indices ``a_all``."""
    # elastic processing order per app: oldest (largest timeAlive) first;
    # stable, as jnp.argsort is: components placed in the same tick tie
    alive_key = torch.where(p.comp_exists & ~p.comp_core, p.comp_alive,
                            float("-inf"))
    elastic_order = torch.argsort(-alive_key, dim=-1, stable=True)  # (S,A,C)
    a_all = torch.clamp_min(p.app_order, 0).long()
    exists = gather_rows(p.comp_exists, a_all)
    is_core = gather_rows(p.comp_core, a_all)
    return ((p.app_order >= 0) & gather_rows(p.app_exists, a_all),
            gather_rows(torch.stack([p.comp_cpu, p.comp_mem], -1), a_all),      # (S,A,C,2)
            exists & is_core, exists & ~is_core,
            gather_rows(p.comp_host, a_all).to(torch.int32),
            gather_rows(elastic_order, a_all).to(torch.int32),
            torch.stack([p.host_cpu, p.host_mem], -1)), a_all             # (S,H,2)


def pessimistic_shape(p: ShapeProblem) -> ShapeDecision:
    """Algorithm 1 over one cluster, or over a batch of clusters when
    every field carries a leading member axis."""
    if p.app_exists.dim() == 1:
        names = [f.name for f in dataclasses.fields(ShapeProblem)]
        d = pessimistic_shape(ShapeProblem(**{n: getattr(p, n)[None] for n in names}))
        return ShapeDecision(**{f.name: getattr(d, f.name)[0]
                                for f in dataclasses.fields(ShapeDecision)})
    A = p.comp_exists.shape[1]
    args, a_all = pass_inputs(p)
    remove_pos, kill_pos, free = kops.pessimistic_pass(*args)

    # scatter back: kill positions -> component order, processing order ->
    # app-index order
    kill_rows = torch.zeros_like(kill_pos).scatter_(-1, args[5].long(), kill_pos)
    kill_app = _scatter_any(a_all, remove_pos, A)
    kill_comp = _scatter_any(a_all, kill_rows, A)

    survive = (p.comp_exists & p.app_exists[..., None]
               & ~kill_app[..., None] & ~kill_comp)
    return ShapeDecision(kill_app=kill_app, kill_comp=kill_comp,
                         alloc_cpu=torch.where(survive, p.comp_cpu, 0.0),
                         alloc_mem=torch.where(survive, p.comp_mem, 0.0),
                         cpu_free=free[..., 0], mem_free=free[..., 1])
