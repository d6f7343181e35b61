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
MAX_GROUPS = 127     # a resolved row's group staged as an int8 (csrc/calib.cu)
# the largest R calib_observe and calib_begin take (csrc/calib.cu kMaxRows:
# every count fits a 16-bit field)
MAX_ROWS = 16384

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.calib_observe.argtypes = [ptr] * 38 + [i32] * 8 + [f32] * 4 + [ptr]
        lib.conformal_scale.argtypes = [ptr] * 2 + [i32] * 2 + [ptr] * 2 + [i32] * 2 + [ptr] * 2
        lib.calib_quantiles.argtypes = ([ptr] * 5 + [f32] + [ptr] * 2 + [i32] * 6 + [ptr] * 6
                                        + [i32] * 5 + [f32] * 3 + [ptr])
        lib.calib_begin.argtypes = [ptr] * 25 + [i32] * 7 + [f32] + [ptr] * 6 + [i32] * 5 + [ptr]
        lib.calib_init.argtypes = []
        for fn in (lib.calib_observe, lib.conformal_scale, lib.calib_quantiles,
                   lib.calib_begin, lib.calib_init):
            fn.restype = i32
        _LIB = lib
    return _LIB


def _device(t: torch.Tensor, name: str) -> torch.device:
    if t.device.type != "cuda":
        raise ValueError(f"{name} takes CUDA tensors, got {t.device}")
    return t.device


def _member_library(device) -> ctypes.CDLL:
    """The library, with the member kernels' shared memory set up on
    ``device`` (``calib_init``, once)."""
    lib = _library()
    nvcc.prepare(lib.calib_init, "calib", device)
    return lib


def _check_rows(R: int, name: str) -> None:
    if R > MAX_ROWS:
        raise ValueError(f"{name}: R={R} series rows; the kernel takes at most {MAX_ROWS} "
                         f"(csrc/calib.cu kMaxRows)")


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
                  q, resolved, errors, dropped, usage, mon_count, active, groups=None, *,
                  pool_on: bool, adaptive: bool, gamma: float, budget: float, q_min: float,
                  q_max: float):
    """Launch ``calib_observe``: the arguments and results of
    ``ref.calib_observe``, with the per-tenant tier ``groups`` or None."""
    dev = _device(ring, "calib_observe")
    (S, R, cap, pcap), specs = _state_specs(ring, ring_count, pool, pool_count, q)
    _check_rows(R, "calib_observe")
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
    tier, tier_outs, G, gcap = (None,) * 5, (), 0, 0
    if groups is not None:
        tier = tuple(groups)
        group_ring, group_count, group, group_resolved, group_errors = tier
        if group_ring.dim() != 3:
            raise ValueError(f"group_ring has shape {tuple(group_ring.shape)}; expected "
                             "(S, G, group_capacity)")
        G, gcap = group_ring.shape[1:]
        if not 1 <= G <= MAX_GROUPS:
            raise ValueError(f"{G} groups: the kernel takes 1..{MAX_GROUPS}")
        nvcc.check(dev, group_ring=(group_ring, f32, (S, G, gcap)),
                   group_count=(group_count, i32, (S, G)), group=(group, i32, (S, R)),
                   group_resolved=(group_resolved, i32, (S, G)),
                   group_errors=(group_errors, i32, (S, G)))
        tier_outs = tuple(torch.empty_like(x) for x in (group_ring, group_count,
                                                        group_resolved, group_errors,
                                                        group_count, group_count))
    nvcc.launch(_member_library(dev).calib_observe, "calib_observe", dev, ring, ring_count, pool,
                pool_count, mean, sigma, scale, peak, left, due, q, resolved, errors, dropped,
                usage, mon_count, active, *tier, *outs,
                *(tier_outs or (None,) * 6), S, R, cap, pcap, int(pool_on), int(adaptive), G,
                gcap, *(float(np.float32(x)) for x in (gamma, budget, q_min, q_max)))
    nvcc.count(calib_observe)
    return outs + tier_outs


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
    nvcc.count(conformal_scale)
    return out


def calib_scales(ring, ring_count, pool, pool_count, q, fallback, deploy, mean, var,
                 mon_count, c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum,
                 scale_n, tenancy=None, *, min_scores: int, pool_on: bool, horizon: int):
    """The engine's shaping step as two launches, :func:`calib_quantiles`
    and :func:`calib_begin`: the arguments and results of
    ``ref.calib_scales``, with the per-tenant tier ``tenancy`` or None."""
    dev = _device(ring, "calib_scales")
    (S, R, cap, pcap), specs = _state_specs(ring, ring_count, pool, pool_count, q)
    _check_rows(R, "calib_scales")
    f32, i32 = torch.float32, torch.int32
    M = R // 2
    nvcc.check(dev, **specs, deploy=(deploy, torch.bool, (S, M)), mean=(mean, f32, (S, R)),
               var=(var, f32, (S, R)), mon_count=(mon_count, i32, (S, M)),
               c_mean=(c_mean, f32, (S, R)), c_sigma=(c_sigma, f32, (S, R)),
               c_scale=(c_scale, f32, (S, R)), c_peak=(c_peak, f32, (S, R)),
               c_left=(c_left, i32, (S, R)), c_due=(c_due, i32, (S, R)),
               scale_sum=(scale_sum, f32, (S,)), scale_n=(scale_n, i32, (S,)))
    qt = bt = None
    if tenancy is not None:
        credit, tenant, slot_gid, group_ring, group_count, group, spread, q_min, q_max = tenancy
        if group_ring.dim() != 3 or slot_gid.dim() != 2 or R % (2 * slot_gid.shape[1]):
            raise ValueError(f"group_ring {tuple(group_ring.shape)} must be (S, T, gcap) and "
                             f"slot_gid {tuple(slot_gid.shape)} (S, A) with 2 * A dividing R={R}")
        T, gcap = group_ring.shape[1:]
        A, N = slot_gid.shape[1], tenant.shape[-1]
        specs = dict(tenant=(tenant, i32, (S, N)), slot_gid=(slot_gid, i32, (S, A)),
                     group_ring=(group_ring, f32, (S, T, gcap)),
                     group_count=(group_count, i32, (S, T)), group=(group, i32, (S, R)))
        if credit is not None:
            specs["credit"] = (credit, f32, (S, T))
        nvcc.check(dev, **specs)
        qt = (credit, tenant, slot_gid, group_ring, group_count, spread, q_min, q_max)
    raw = calib_quantiles(ring, ring_count, pool, pool_count, q, fallback, qt,
                          min_scores=min_scores, pool_on=pool_on)
    if tenancy is not None:
        bt = (tenant, slot_gid, group_count, raw[2], group, gcap)
    return calib_begin(ring_count, pool_count, raw[0], raw[1], deploy, mean, var, mon_count,
                       c_mean, c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n,
                       bt, cap=cap, pcap=pcap, min_scores=min_scores, pool_on=pool_on,
                       horizon=horizon, fallback=fallback)


def calib_quantiles(ring, ring_count, pool, pool_count, q, fallback, tenancy=None, *,
                    min_scores: int, pool_on: bool):
    """Launch ``conformal_scale`` once over a calibration state's series
    rings, pools and, with the per-tenant tier ``tenancy`` (as
    ``ref.calib_quantiles`` takes it), group rings, all checked by the
    caller: ``ref.calib_quantiles``'s results where the step reads them
    (the rows of ``min_scores`` scores or more, the pool where on; the
    other entries unwritten)."""
    S, R, cap = ring.shape
    dev = ring.device
    raw = torch.empty((S, R), dtype=torch.float32, device=dev)
    raw_pool = torch.empty(S, dtype=torch.float32, device=dev)
    groups, raw_group = (None,) * 6 + (0,) * 5 + (0.0,) * 3, ()
    if tenancy is not None:
        credit, tenant, slot_gid, group_ring, group_count, spread, q_min, q_max = tenancy
        T, gcap = group_ring.shape[1:]
        raw_group = (torch.empty((S, T), dtype=torch.float32, device=dev),)
        A = slot_gid.shape[1]
        groups = (group_ring, group_count, raw_group[0], credit, slot_gid, tenant, T, gcap, A,
                  R // 2 // A, tenant.shape[1],
                  *(float(np.float32(x)) for x in (spread, q_min, q_max)))
    nvcc.launch(_library().calib_quantiles, "conformal_scale", dev, ring, ring_count, pool,
                pool_count, q, float(np.float32(fallback)), raw, raw_pool, S, R, cap,
                pool.shape[1], int(min_scores), int(pool_on), *groups)
    nvcc.count(conformal_scale)
    return (raw, raw_pool) + raw_group


@nvcc.counted
def calib_begin(ring_count, pool_count, raw, raw_pool, deploy, mean, var, mon_count, c_mean,
                c_sigma, c_scale, c_peak, c_left, c_due, scale_sum, scale_n, tenancy=None, *,
                cap: int, pcap: int, min_scores: int, pool_on: bool, horizon: int,
                fallback: float):
    """Launch ``calib_begin`` (inputs checked by the caller): the arguments
    and results of ``ref.calib_begin``, with its per-tenant tier
    ``tenancy`` or None."""
    S, R = c_scale.shape
    _check_rows(R, "calib_begin")
    if tenancy is not None:
        tenant, slot_gid, group_count, raw_group, group, gcap = tenancy
        if not 1 <= group_count.shape[1] <= MAX_GROUPS:
            raise ValueError(f"calib_begin: {group_count.shape[1]} tenants; the kernel takes "
                             f"1..{MAX_GROUPS}")
    outs = (torch.empty_like(c_scale),) + tuple(
        torch.empty_like(x) for x in (c_mean, c_sigma, c_scale, c_peak, c_left, c_due,
                                      scale_sum, scale_n))
    groups, o_group = (None,) * 6 + (0,) * 5, ()
    if tenancy is not None:
        o_group = (torch.empty_like(group),)
        A = slot_gid.shape[1]
        groups = (slot_gid, tenant, group_count, raw_group, group, o_group[0], A, R // 2 // A,
                  tenant.shape[1], group_count.shape[1], int(gcap))
    dev = c_scale.device
    nvcc.launch(_member_library(dev).calib_begin, "calib_begin", dev, ring_count, pool_count,
                raw, raw_pool, deploy, mean, var, mon_count, c_mean, c_sigma, c_scale, c_peak,
                c_left, c_due, scale_sum, scale_n, *outs, S, R, cap, pcap, int(min_scores),
                int(pool_on), int(horizon), float(np.float32(fallback)), *groups)
    nvcc.count(calib_begin)
    return outs + o_group


def reset_launch_counts() -> None:
    calib_observe.launches = 0
    conformal_scale.launches = 0
    calib_begin.launches = 0
