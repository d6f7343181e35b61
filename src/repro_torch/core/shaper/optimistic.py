"""Optimistic reclamation policy (Borg/Omega-style — paper §3.2, §4.2).

Counterpart of ``repro/core/shaper/optimistic.py``.  Every component is
resized to its shaped demand with no coordination; conflicts are
resolved after the fact: while some host's total demand exceeds its
capacity, one application resident on the most over-committed host is
failed (a fixed pseudo-random priority per app, not size- or age-aware).
These kills are the *uncontrolled application failures* of Fig. 3.

The reference's ``lax.while_loop`` becomes a Python loop whose condition
is read on the host each iteration, and ``segment_sum`` becomes
``index_add_``.
"""
from __future__ import annotations

import torch

from repro_torch.core.shaper.baseline import by_host
from repro_torch.core.shaper.pessimistic import ShapeDecision, ShapeProblem


def optimistic_shape(p: ShapeProblem) -> ShapeDecision:
    A, C = p.comp_exists.shape
    H = p.host_cpu.shape[0]
    dev = p.comp_exists.device
    live0 = p.comp_exists & p.app_exists[:, None]

    # per-app, per-host demand footprint: (A, H)
    slot = (torch.arange(A, device=dev)[:, None] * H + p.comp_host).reshape(-1)

    def per_app(x):
        out = torch.zeros((A * H,), dtype=x.dtype, device=dev)
        return out.index_add_(0, slot, torch.where(live0, x, 0.0).reshape(-1)
                              ).reshape(A, H)

    app_cpu_h, app_mem_h = per_app(p.comp_cpu), per_app(p.comp_mem)

    # "unpredictable" OS-style victim choice: a fixed pseudo-random
    # priority per app (the reference's uint32 hash of its index)
    rand_prio = (((torch.arange(A, dtype=torch.int64, device=dev) * 2654435761)
                  % 2**32) >> 8).to(torch.float32)

    kill = ~p.app_exists
    cpu_h, mem_h = app_cpu_h.sum(0), app_mem_h.sum(0)
    while bool(((cpu_h > p.host_cpu + 1e-6) | (mem_h > p.host_mem + 1e-6)).any()):
        # the most-overcommitted host (memory-first, the finite resource)
        h = torch.argmax(torch.maximum(mem_h - p.host_mem,
                                       (cpu_h - p.host_cpu) * 1e-3))
        resident = (app_mem_h[:, h] + app_cpu_h[:, h]) > 0
        victim = torch.argmax(torch.where(kill | ~resident, float("-inf"),
                                          rand_prio))
        kill[victim] = True
        cpu_h = cpu_h - app_cpu_h[victim]
        mem_h = mem_h - app_mem_h[victim]
    kill_app = kill & p.app_exists

    live = live0 & ~kill_app[:, None]
    alloc_cpu = torch.where(live, p.comp_cpu, 0.0)
    alloc_mem = torch.where(live, p.comp_mem, 0.0)
    return ShapeDecision(
        kill_app=kill_app,
        kill_comp=torch.zeros((A, C), dtype=torch.bool, device=dev),
        alloc_cpu=alloc_cpu,
        alloc_mem=alloc_mem,
        cpu_free=p.host_cpu - by_host(alloc_cpu, p.comp_host, H),
        mem_free=p.host_mem - by_host(alloc_mem, p.comp_host, H),
    )
