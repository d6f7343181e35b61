"""Baseline policy: allocation == reservation, never adjusted (paper §4.2).

Counterpart of ``repro/core/shaper/baseline.py``: the reservation-centric
approach of Mesos/YARN; the caller passes reservations in the demand
fields of the ShapeProblem.
"""
from __future__ import annotations

import torch

from repro_torch.core.shaper.pessimistic import ShapeDecision, ShapeProblem


def by_host(x: torch.Tensor, host: torch.Tensor, n_hosts: int) -> torch.Tensor:
    """Sum an (A, C) per-component quantity into (H,) per-host totals
    (``jax.ops.segment_sum`` in the reference)."""
    out = torch.zeros((n_hosts,), dtype=x.dtype, device=x.device)
    return out.index_add_(0, host.reshape(-1), x.reshape(-1))


def baseline_shape(p: ShapeProblem) -> ShapeDecision:
    A, C = p.comp_exists.shape
    H = p.host_cpu.shape[0]
    live = p.comp_exists & p.app_exists[:, None]
    alloc_cpu = torch.where(live, p.comp_cpu, 0.0)
    alloc_mem = torch.where(live, p.comp_mem, 0.0)
    dev = p.comp_exists.device
    return ShapeDecision(
        kill_app=torch.zeros((A,), dtype=torch.bool, device=dev),
        kill_comp=torch.zeros((A, C), dtype=torch.bool, device=dev),
        alloc_cpu=alloc_cpu,
        alloc_mem=alloc_mem,
        cpu_free=p.host_cpu - by_host(alloc_cpu, p.comp_host, H),
        mem_free=p.host_mem - by_host(alloc_mem, p.comp_host, H),
    )
