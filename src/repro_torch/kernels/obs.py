"""CUDA kernel of the telemetry rings' tick: build, bind and launch.

``obs_tick`` is one launch a tick on the device engine with the rings on
(``SimConfig.obs``): the counterpart of the reference's ring update
(``repro/sim/step.py:757-770,822,880-881,901-920``, some thirty XLA
operations).  What it computes is defined by ``ref.obs_tick``; the
kernel, its bound and its design are described in ``csrc/obs.cu``.
Nothing is built when this module is imported: the first launch builds
(or reuses) the library with :func:`repro_torch.kernels.nvcc.build`.

The wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current CUDA stream (nothing is read
back, so a CUDA graph can hold it), raises if the launch returned an
error, and counts its launches in ``obs_tick.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc, ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "obs.cu"
F32_ROWS, I32_ROWS = 5, 8
SMEM_LIMIT = 47 * 1024   # the staged tables; the kernel's static tables take the rest of 48 KB

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        lib.obs_tick.argtypes = [ctypes.c_void_p] * 31 + [ctypes.c_int] * 7 + [ctypes.c_void_p]
        lib.obs_tick.restype = ctypes.c_int
        lib.obs_tick_smem.argtypes = [ctypes.c_int] * 3
        lib.obs_tick_smem.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


def table_order(A: int, C: int) -> int:
    """XLA:CPU's loop over a window of the (A, C, 2) tables' sums as the
    kernel's ``order`` argument (``csrc/obs.cu``): 0 for a serial sum,
    else the lanes VF | unrolled << 4 | the tree's higher lane first << 5
    | the data first, by component, << 8 (``ref.xla_table_plan`` and
    ``ref.XLA_LANE_ORDER``)."""
    vf, unrolled = ref.xla_table_plan(A, C)
    if not vf:
        return 0
    data_first, hi_first = ref.XLA_LANE_ORDER[(vf, C)]
    return (vf | unrolled << 4 | hi_first << 5
            | sum(int(d) << (8 + c) for c, d in enumerate(data_first)))


@nvcc.counted
def obs_tick(cursor, f32, i32, lead_ring, active, usage, demand, queued, q_admit, counters,
             counters0, tenancy, tenancy0, calib, calib0, lead=None):
    """Launch ``obs_tick`` (one block per member): the arguments and
    results of ``ref.obs_tick``."""
    dev = cursor.device
    if dev.type != "cuda":
        raise ValueError(f"obs_tick takes CUDA tensors, got {dev}")
    S, R = cursor.shape[0], f32.shape[-1]
    if usage.dim() != 4 or queued.dim() != 2:
        raise ValueError(f"expected usage (S, A, C, 2) and queued (S, N), got "
                         f"{tuple(usage.shape)} and {tuple(queued.shape)}")
    A, C, N = usage.shape[1], usage.shape[2], queued.shape[1]
    if not (1 <= A <= 1024 and 1 <= C <= 32):
        raise ValueError(f"A={A} slots of C={C} components: the kernel takes A <= 1024 and "
                         f"C <= 32 (XLA's tree has one level of windows over whole slots)")
    smem = _library().obs_tick_smem(A, C, 1 if demand is None else 2)
    if smem > SMEM_LIMIT:
        raise ValueError(f"A={A} slots of C={C} components: the kernel's staged tables take "
                         f"{smem} B of shared memory, more than {SMEM_LIMIT}")
    if (tenancy is None) != (tenancy0 is None) or (calib is None) != (calib0 is None):
        raise ValueError("tenancy and calib come with their entry values")
    f, i, b = torch.float32, torch.int32, torch.bool
    specs = dict(cursor=(cursor, i, (S,)), f32=(f32, f, (S, F32_ROWS, R)),
                 i32=(i32, i, (S, I32_ROWS, R)), active=(active, b, (S,)),
                 usage=(usage, f, (S, A, C, 2)), queued=(queued, b, (S, N)),
                 q_admit=(q_admit, b, (S, N)))
    for k, (x, x0) in enumerate(zip(counters, counters0)):
        specs.update({f"counter{k}": (x, i, (S,)), f"counter{k}_0": (x0, i, (S,))})
    if lead_ring is not None:
        specs["lead_ring"] = (lead_ring, i, (S, R))
    if demand is not None:
        specs["demand"] = (demand, f, (S, A, C, 2))
    if lead is not None:
        specs["lead"] = (lead, i, (S,))
    T = 0
    if tenancy is not None:
        T = tenancy[0].shape[1]
        if not 1 <= T <= 1024:
            raise ValueError(f"{T} tenants: the kernel takes 1..1024")
        specs.update(credit=(tenancy[0], f, (S, T)), throttled=(tenancy[1], i, (S, T)),
                     active_ticks=(tenancy[2], i, (S, T)), throttled0=(tenancy0[0], i, (S, T)),
                     active_ticks0=(tenancy0[1], i, (S, T)))
    if calib is not None:
        specs.update(resolved=(calib[0], i, (S,)), errors=(calib[1], i, (S,)),
                     resolved0=(calib0[0], i, (S,)), errors0=(calib0[1], i, (S,)))
    nvcc.check(dev, **specs)
    out = (torch.empty_like(cursor), torch.empty_like(f32), torch.empty_like(i32),
           None if lead_ring is None else torch.empty_like(lead_ring))
    if S:
        ten = (None,) * 3 if tenancy is None else tenancy
        ten0 = (None,) * 2 if tenancy0 is None else tenancy0
        cal = (None,) * 2 if calib is None else calib
        cal0 = (None,) * 2 if calib0 is None else calib0
        nvcc.launch(_library().obs_tick, "obs_tick", dev, cursor, f32, i32, lead_ring, active,
                    usage, demand, queued, q_admit, *counters, *counters0, *ten, *ten0, *cal,
                    *cal0, lead, *out, S, A, C, N, T, R, table_order(A, C))
        nvcc.count(obs_tick)
    return out


def reset_launch_counts() -> None:
    obs_tick.launches = 0
