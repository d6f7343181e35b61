"""CUDA kernel of the control plane's tick: build, bind and launch.

``control_tick`` is one launch a tick on the device engine with the
control plane on: the counterpart of the reference's control step
(``repro/sim/step.py:778-887``: the tenant credit, the wDRF shares, the
admission gate and the tenant counters, some thirty XLA operations).
What it computes is defined by ``ref.control_tick``; the kernel, its
bound and its design are described in ``csrc/control.cu``.  Nothing is
built when this module is imported: the first launch builds (or reuses)
the library with :func:`repro_torch.kernels.nvcc.build`.

The wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current CUDA stream (nothing is read
back, so a CUDA graph can hold it), raises if the launch returned an
error, and counts its launches in ``control_tick.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "control.cu"
MAX_TENANTS = 1024
MAX_COMPONENTS = 32   # a slot's components, held in one thread's registers

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.control_tick.argtypes = [ptr] * 25 + [i32] * 8 + [f32] * 3 + [ptr]
        lib.control_tick.restype = i32
        lib.control_tick_smem.argtypes = [i32] * 2
        lib.control_tick_smem.restype = ctypes.c_size_t
        _LIB = lib
    return _LIB


@nvcc.counted
def control_tick(credit, throttled, completed, failed, share_sum, active_ticks, done0, done,
                 queued0, queued, conflict, d_res, d_err, tenant, slot_gid, alloc, host_cap,
                 weights, *, credit_on: bool, gate_on: bool, gamma: float, floor: float,
                 slack: float):
    """Launch ``control_tick`` (one block per member): the arguments and
    results of ``ref.control_tick``; ``conflict`` and the pair ``d_res``,
    ``d_err`` may be None."""
    dev = credit.device
    if dev.type != "cuda":
        raise ValueError(f"control_tick takes CUDA tensors, got {dev}")
    S, T = credit.shape
    N = tenant.shape[1]
    A, C = alloc.shape[1], alloc.shape[2]
    H = host_cap.shape[0]
    if not 1 <= T <= MAX_TENANTS:
        raise ValueError(f"{T} tenants: the kernel takes 1..{MAX_TENANTS}")
    if not (1 <= A <= 1024 and 1 <= C <= MAX_COMPONENTS):
        raise ValueError(f"A={A} slots of C={C} components: the kernel takes A <= 1024 (its "
                         f"tree sums' windows in one level) and C <= {MAX_COMPONENTS}")
    smem = _library().control_tick_smem(T, A)
    if smem > 48 * 1024:
        raise ValueError(f"A={A} slots, T={T} tenants: the kernel's tables take {smem} B of "
                         f"shared memory, more than 48 KB")
    if (d_res is None) != (d_err is None):
        raise ValueError("d_res and d_err come together")
    f32, i32, b = torch.float32, torch.int32, torch.bool
    specs = dict(credit=(credit, f32, (S, T)), throttled=(throttled, i32, (S, T)),
                 completed=(completed, i32, (S, T)), failed=(failed, i32, (S, T)),
                 share_sum=(share_sum, f32, (S, T)), active_ticks=(active_ticks, i32, (S, T)),
                 done0=(done0, b, (S, N)), done=(done, b, (S, N)),
                 queued0=(queued0, b, (S, N)), queued=(queued, b, (S, N)),
                 tenant=(tenant, i32, (S, N)), slot_gid=(slot_gid, i32, (S, A)),
                 alloc=(alloc, f32, (S, A, C, 2)), host_cap=(host_cap, f32, (H, 2)),
                 weights=(weights, f32, (T,)))
    if conflict is not None:
        specs["conflict"] = (conflict, b, (S, N))
    if d_res is not None:
        specs.update(d_res=(d_res, i32, (S, T)), d_err=(d_err, i32, (S, T)))
    nvcc.check(dev, **specs)
    outs = tuple(torch.empty_like(x) for x in (credit, throttled, completed, failed,
                                               share_sum, active_ticks))
    elig = torch.empty((S, T), dtype=b, device=dev)
    if S:
        nvcc.launch(_library().control_tick, "control_tick", dev, credit, throttled,
                    completed, failed, share_sum, active_ticks, done0, done, queued0, queued,
                    conflict, d_res, d_err, tenant, slot_gid, alloc, host_cap, weights, *outs,
                    elig, S, T, N, A, C, H, int(credit_on), int(gate_on),
                    *(float(np.float32(x)) for x in (gamma, floor, slack)))
        nvcc.count(control_tick)
    return (*outs, elig)


def reset_launch_counts() -> None:
    control_tick.launches = 0
