"""CUDA kernels of the device engine's conformal calibration: build, bind
and launch.

``calib_observe`` is one launch a tick (the reference's
``calib_observe``, ``repro/core/uncertainty/online.py:317``);
``conformal_scale`` the conformal quantile of score rings
(``repro/core/uncertainty/conformal.py:83,113``); ``calib_scales``, the
engine's shaping step, launches it once over the series rings and the
pools, then ``calib_begin`` (the fallback hierarchy and the reference's
``calib_begin``), one launch each a tick.  What they compute is defined
by ``ref.calib_observe``, ``ref.conformal_scale`` and
``ref.calib_scales``; the kernels, their bounds and their design are
described in ``csrc/calib.cu``.  Nothing is built when this module is
imported: the first launch builds (or reuses) the library with
:func:`repro_torch.kernels.nvcc.build`.

Each wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current CUDA stream (nothing is read
back, so a CUDA graph can hold them), raises if the launch returned an
error, and counts its launches: ``calib_observe.launches``,
``calib_begin.launches``, and ``conformal_scale.launches`` for both
launches of that kernel.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "calib.cu"

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.calib_observe.argtypes = [ptr] * 27 + [i32] * 6 + [f32] * 4 + [ptr]
        lib.conformal_scale.argtypes = [ptr] * 2 + [i32] * 2 + [ptr] * 2 + [i32] * 2 + [ptr] * 2
        lib.calib_quantiles.argtypes = [ptr] * 5 + [f32] + [ptr] * 2 + [i32] * 6 + [ptr]
        lib.calib_begin.argtypes = [ptr] * 25 + [i32] * 7 + [f32, ptr]
        for fn in (lib.calib_observe, lib.conformal_scale, lib.calib_quantiles,
                   lib.calib_begin):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")
    return t.device


def _state_specs(ring, ring_count, pool, pool_count, q):
    """(S, R, cap, pcap) of a calibration state, with the checks of its
    rings and q."""
    if ring.dim() != 3 or pool.dim() != 2:
        raise ValueError(f"expected ring (S, R, cap) and pool (S, pcap), got "
                         f"{tuple(ring.shape)} and {tuple(pool.shape)}")
    S, R, cap = ring.shape
    pcap = pool.shape[1]
    if S < 1 or R < 2 or R % 2 or cap < 1 or pcap < 1:
        raise ValueError(f"S={S} members, R={R} rows (even), capacities {cap} and {pcap}: "
                         f"the kernels take >= 1 each")
    f32, i32 = torch.float32, torch.int32
    return (S, R, cap, pcap), dict(
        ring=(ring, f32, (S, R, cap)), ring_count=(ring_count, i32, (S, R)),
        pool=(pool, f32, (S, pcap)), pool_count=(pool_count, i32, (S,)), q=(q, f32, (S,)))


@nvcc.counted
def calib_observe(ring, ring_count, pool, pool_count, mean, sigma, scale, peak, left, due,
                  q, resolved, errors, dropped, usage, mon_count, active, *, pool_on: bool,
                  adaptive: bool, gamma: float, budget: float, q_min: float, q_max: float):
    """Launch ``calib_observe``: the arguments and results of
    ``ref.calib_observe``."""
    dev = _device(ring, "calib_observe")
    (S, R, cap, pcap), specs = _state_specs(ring, ring_count, pool, pool_count, q)
    f32, i32 = torch.float32, torch.int32
    M = R // 2
    nvcc.check(dev, **specs, mean=(mean, f32, (S, R)), sigma=(sigma, f32, (S, R)),
               scale=(scale, f32, (S, R)), peak=(peak, f32, (S, R)),
               left=(left, i32, (S, R)), due=(due, i32, (S, R)),
               resolved=(resolved, i32, (S,)), errors=(errors, i32, (S,)),
               dropped=(dropped, i32, (S,)), usage=(usage, f32, (S, M, 2)),
               mon_count=(mon_count, i32, (S, M)), active=(active, torch.bool, (S,)))
    outs = tuple(torch.empty_like(x) for x in (ring, ring_count, pool, pool_count, peak,
                                               left, q, resolved, errors, dropped))
    nvcc.launch(_library().calib_observe, "calib_observe", dev, ring, ring_count, pool,
                pool_count, mean, sigma, scale, peak, left, due, q, resolved, errors, dropped,
                usage, mon_count, active, *outs, S, R, cap, pcap, int(pool_on),
                int(adaptive), *(float(np.float32(x)) for x in (gamma, budget, q_min, q_max)))
    calib_observe.launches += 1
    return outs


@nvcc.counted
def conformal_scale(scores: torch.Tensor, counts: torch.Tensor, q: torch.Tensor,
                    fallback: torch.Tensor, rolled: bool) -> torch.Tensor:
    """Launch ``conformal_scale`` over ``(B, cap)`` rings: the arguments and
    result of ``ref.conformal_scale``."""
    dev = _device(scores, "conformal_scale")
    if scores.dim() != 2 or q.dim() != 1 or q.shape[0] < 1:
        raise ValueError(f"expected scores (B, cap) and q (G,), got {tuple(scores.shape)} "
                         f"and {tuple(q.shape)}")
    B, cap = scores.shape
    G = q.shape[0]
    if cap < 1 or B % G:
        raise ValueError(f"capacity {cap} must be >= 1 and G={G} must divide B={B}")
    f32 = torch.float32
    nvcc.check(dev, scores=(scores, f32, (B, cap)), counts=(counts, torch.int32, (B,)),
               q=(q, f32, (G,)), fallback=(fallback, f32, (G,)))
    out = torch.empty(B, dtype=f32, device=dev)
    nvcc.launch(_library().conformal_scale, "conformal_scale", dev, scores, counts, B, cap,
                q, fallback, G, int(rolled), out)
    conformal_scale.launches += 1
    return out


def calib_scales(ring, ring_count, pool, pool_count, q, fallback, deploy, mean, var,
                 mon_count, c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum,
                 scale_n, *, min_scores: int, pool_on: bool, horizon: int):
    """The engine's shaping step as two launches, :func:`calib_quantiles`
    and :func:`calib_begin`: the arguments and results of
    ``ref.calib_scales``."""
    dev = _device(ring, "calib_scales")
    (S, R, cap, pcap), specs = _state_specs(ring, ring_count, pool, pool_count, q)
    f32, i32 = torch.float32, torch.int32
    M = R // 2
    nvcc.check(dev, **specs, deploy=(deploy, torch.bool, (S, M)), mean=(mean, f32, (S, R)),
               var=(var, f32, (S, R)), mon_count=(mon_count, i32, (S, M)),
               c_mean=(c_mean, f32, (S, R)), c_sigma=(c_sigma, f32, (S, R)),
               c_scale=(c_scale, f32, (S, R)), c_peak=(c_peak, f32, (S, R)),
               c_left=(c_left, i32, (S, R)), c_due=(c_due, i32, (S, R)),
               scale_sum=(scale_sum, f32, (S,)), scale_n=(scale_n, i32, (S,)))
    raw, raw_pool = calib_quantiles(ring, ring_count, pool, pool_count, q, fallback,
                                    min_scores=min_scores, pool_on=pool_on)
    return calib_begin(ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count,
                       c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n,
                       cap=cap, pcap=pcap, min_scores=min_scores, pool_on=pool_on,
                       horizon=horizon, fallback=fallback)


def calib_quantiles(ring, ring_count, pool, pool_count, q, fallback, *, min_scores: int,
                    pool_on: bool):
    """Launch ``conformal_scale`` once over a calibration state's series
    rings and pools (checked by the caller): ``ref.calib_quantiles``'s
    results where the step reads them (the rows of ``min_scores`` scores
    or more, the pool where on; the other entries unwritten)."""
    S, R, cap = ring.shape
    dev = ring.device
    raw = torch.empty((S, R), dtype=torch.float32, device=dev)
    raw_pool = torch.empty(S, dtype=torch.float32, device=dev)
    nvcc.launch(_library().calib_quantiles, "conformal_scale", dev, ring, ring_count, pool,
                pool_count, q, float(np.float32(fallback)), raw, raw_pool, S, R, cap,
                pool.shape[1], int(min_scores), int(pool_on))
    conformal_scale.launches += 1
    return raw, raw_pool


@nvcc.counted
def calib_begin(ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count, c_mean,
                c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n, *, cap: int,
                pcap: int, min_scores: int, pool_on: bool, horizon: int, fallback: float):
    """Launch ``calib_begin`` (inputs checked by the caller): the arguments
    and results of ``ref.calib_begin``."""
    S, R = c_scale.shape
    outs = (torch.empty_like(c_scale),) + tuple(
        torch.empty_like(x) for x in (c_mean, c_sigma, c_scale, c_peak, c_left, c_due,
                                      scale_sum, scale_n))
    nvcc.launch(_library().calib_begin, "calib_begin", c_scale.device, ring_count, pool_count,
                raw, raw_pool, deploy, mean, var, mon_count, c_mean, c_sigma, c_scale, c_peak,
                c_left, c_due, scale_sum, scale_n, *outs, S, R, cap, pcap, int(min_scores),
                int(pool_on), int(horizon), float(np.float32(fallback)))
    calib_begin.launches += 1
    return outs


def reset_launch_counts() -> None:
    calib_observe.launches = 0
    conformal_scale.launches = 0
    calib_begin.launches = 0
