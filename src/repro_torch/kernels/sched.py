"""CUDA kernels of the device engine's scheduler loops: build, bind and
launch.

Three kernels, one launch each per tick for every member of a batch:
``resolve_oom`` (``repro/sim/step.py:472``), ``admit_queued`` (``:554``)
and ``place_missing_elastic`` (``:670``), the counterparts of the
reference's event-bounded ``lax.while_loop``s.  What each computes is
defined by the function of the same name in ``ref.py``; the kernels,
their bound and their design are described in ``csrc/sched.cu``.
Nothing is built when this module is imported: the first launch builds
(or reuses) the library with :func:`repro_torch.kernels.nvcc.build`.

Each wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current CUDA stream, raises if the
launch returned an error, and counts its launches in ``.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched.cu"
MAX_HOSTS = 1024    # the free table and per-host running sums in 48 KB of shared memory
MAX_COMPONENTS = 32  # a slot's components fit one window of the sums' order

_LIB: ctypes.CDLL | None = None
_B, _F32, _I32 = torch.bool, torch.float32, torch.int32


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr, n_int in (("resolve_oom", 24, 5), ("admit_queued", 26, 6),
                                   ("place_missing_elastic", 15, 5)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr]
            fn.restype = i32
        _LIB = lib
    return _LIB


def _dims(comp_running, n_apps_tensor, host_cap):
    S, A, C = comp_running.shape
    N = n_apps_tensor.shape[1]
    H = host_cap.shape[0]
    if comp_running.device.type != "cuda":
        raise ValueError(f"the scheduler kernels take CUDA tensors, got "
                         f"{comp_running.device}")
    if not 1 <= H <= MAX_HOSTS:
        raise ValueError(f"{H} hosts: the kernels take 1..{MAX_HOSTS}")
    if not 1 <= C <= MAX_COMPONENTS or A * C > 2**20:
        raise ValueError(f"A={A} slots of C={C} components: the kernels take "
                         f"C <= {MAX_COMPONENTS} and A * C <= 2**20")
    return S, A, C, N, H


def resolve_oom(slot_gid, work_done, comp_running, comp_host, alloc, usage, failed,
                queued, oom_kills, failure_events, partial_preemptions, is_core,
                host_cap):
    """Launch the OOM kernel; returns what ``ref.resolve_oom`` returns."""
    S, A, C, N, H = _dims(comp_running, failed, host_cap)
    nvcc.check(comp_running.device, slot_gid=(slot_gid, _I32, (S, A)),
               work_done=(work_done, _F32, (S, A)),
               comp_running=(comp_running, _B, (S, A, C)),
               comp_host=(comp_host, _I32, (S, A, C)),
               alloc=(alloc, _F32, (S, A, C, 2)), usage=(usage, _F32, (S, A, C, 2)),
               failed=(failed, _B, (S, N)), queued=(queued, _B, (S, N)),
               oom_kills=(oom_kills, _I32, (S,)),
               failure_events=(failure_events, _I32, (S,)),
               partial_preemptions=(partial_preemptions, _I32, (S,)),
               is_core=(is_core, _B, (S, N, C)), host_cap=(host_cap, _F32, (H, 2)))
    outs = [torch.empty_like(t) for t in (slot_gid, work_done, comp_running, alloc,
                                          usage, failed, queued, oom_kills,
                                          failure_events, partial_preemptions)]
    monreset = torch.empty((S, A * C), dtype=_B, device=comp_running.device)
    if S:
        nvcc.launch(_library().resolve_oom, "resolve_oom", comp_running.device,
                    slot_gid, work_done, comp_running, comp_host, alloc, usage,
                    failed, queued, oom_kills, failure_events, partial_preemptions,
                    is_core, host_cap, *outs, monreset, S, A, C, N, H)
        resolve_oom.launches += 1
    return (*outs, monreset)


def admit_queued(submit, gid, cpu_req, mem_req, exists, is_core, slot_gid,
                 work_done, comp_running, comp_host, alloc, alive_since, queued,
                 has_saved, saved_work, t, host_cap, resume: bool):
    """Launch the admission kernel; returns what ``ref.admit_queued``
    returns."""
    S, A, C, N, H = _dims(comp_running, submit, host_cap)
    nvcc.check(comp_running.device, submit=(submit, _F32, (S, N)),
               gid=(gid, _I32, (S, N)), cpu_req=(cpu_req, _F32, (S, N, C)),
               mem_req=(mem_req, _F32, (S, N, C)), exists=(exists, _B, (S, N, C)),
               is_core=(is_core, _B, (S, N, C)), slot_gid=(slot_gid, _I32, (S, A)),
               work_done=(work_done, _F32, (S, A)),
               comp_running=(comp_running, _B, (S, A, C)),
               comp_host=(comp_host, _I32, (S, A, C)),
               alloc=(alloc, _F32, (S, A, C, 2)),
               alive_since=(alive_since, _F32, (S, A, C)),
               queued=(queued, _B, (S, N)), has_saved=(has_saved, _B, (S, N)),
               saved_work=(saved_work, _F32, (S, N)), t=(t, _F32, (S,)),
               host_cap=(host_cap, _F32, (H, 2)))
    outs = [torch.empty_like(x) for x in (slot_gid, work_done, comp_running,
                                          comp_host, alloc, alive_since, queued,
                                          has_saved)]
    resets = torch.empty((S, A * C), dtype=_B, device=comp_running.device)
    if S:
        nvcc.launch(_library().admit_queued, "admit_queued", comp_running.device,
                    submit, gid, cpu_req, mem_req, exists, is_core, slot_gid,
                    work_done, comp_running, comp_host, alloc, alive_since, queued,
                    has_saved, saved_work, t, host_cap, *outs, resets, S, A, C, N, H,
                    int(resume))
        admit_queued.launches += 1
    return (*outs, resets)


def place_missing_elastic(cpu_req, mem_req, exists, is_core, slot_gid, comp_running,
                          comp_host, alloc, alive_since, t, host_cap):
    """Launch the elastic re-placement kernel; returns what
    ``ref.place_missing_elastic`` returns."""
    S, A, C, N, H = _dims(comp_running, cpu_req, host_cap)
    nvcc.check(comp_running.device, cpu_req=(cpu_req, _F32, (S, N, C)),
               mem_req=(mem_req, _F32, (S, N, C)), exists=(exists, _B, (S, N, C)),
               is_core=(is_core, _B, (S, N, C)), slot_gid=(slot_gid, _I32, (S, A)),
               comp_running=(comp_running, _B, (S, A, C)),
               comp_host=(comp_host, _I32, (S, A, C)),
               alloc=(alloc, _F32, (S, A, C, 2)),
               alive_since=(alive_since, _F32, (S, A, C)), t=(t, _F32, (S,)),
               host_cap=(host_cap, _F32, (H, 2)))
    outs = [torch.empty_like(x) for x in (comp_running, comp_host, alloc, alive_since)]
    if S:
        nvcc.launch(_library().place_missing_elastic, "place_missing_elastic",
                    comp_running.device, cpu_req, mem_req, exists, is_core, slot_gid,
                    comp_running, comp_host, alloc, alive_since, t, host_cap, *outs,
                    S, A, C, N, H)
        place_missing_elastic.launches += 1
    return tuple(outs)


resolve_oom.launches = 0
admit_queued.launches = 0
place_missing_elastic.launches = 0


def reset_launch_counts() -> None:
    resolve_oom.launches = admit_queued.launches = place_missing_elastic.launches = 0
