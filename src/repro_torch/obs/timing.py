"""Shared benchmark timers.

Every benchmark used to carry its own copy of a best-of-N
``time.perf_counter()`` loop (engine / shard / tenancy) or an
average-of-N blocking loop (kernels).  These are THE implementations
now; samples are mirrored into the process :data:`repro_torch.obs.metrics.REGISTRY`
so manifests and bench artifacts can snapshot what was measured.

A copy of ``repro/obs/timing.py``; :func:`time_us` waits for the CUDA
device of its output in place of ``jax.block_until_ready``.
"""
from __future__ import annotations

import time

from repro_torch.obs.metrics import REGISTRY

__all__ = ["best_of", "time_us"]


def best_of(fn, n: int, metric: str | None = None) -> float:
    """Min wall-clock seconds of ``fn()`` over ``n`` runs (the classic
    noise-robust estimator: min is the run with the least interference).

    ``metric`` names a :class:`~repro_torch.obs.metrics.Histogram` that
    receives every individual sample (not just the min)."""
    hist = REGISTRY.histogram(metric) if metric else None
    best = float("inf")
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        if hist is not None:
            hist.observe(dt)
        best = min(best, dt)
    return best


def _wait(out) -> None:
    """Wait for every CUDA device that a tensor of ``out`` (a tensor or a
    tuple or list of them) lies on; CPU results are ready already."""
    import torch  # lazy: repro_torch.obs stays importable without torch

    outs = out if isinstance(out, (tuple, list)) else (out,)
    for d in {x.device for x in outs if isinstance(x, torch.Tensor)}:
        if d.type == "cuda":
            torch.cuda.synchronize(d)


def time_us(fn, *args, iters: int = 5, metric: str | None = None) -> float:
    """Average microseconds per call of a torch computation: one warmup
    call (waited for), then ``iters`` back-to-back calls with a single
    trailing wait for the output's device — the kernel-microbench
    convention."""
    _wait(fn(*args))
    t0 = time.perf_counter()
    for _ in range(iters):
        out = fn(*args)
    _wait(out)
    us = (time.perf_counter() - t0) / iters * 1e6
    if metric:
        REGISTRY.histogram(metric).observe(us)
    return us
