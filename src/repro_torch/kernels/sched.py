"""CUDA kernels of the device engine's scheduler loops: build, bind and
launch.

Three kernels, one launch each per tick for every member of a batch:
``resolve_oom`` (``repro/sim/step.py:472``), ``admit_queued`` (``:554``;
with the control plane's gate, ``:614``) and ``place_missing_elastic``
(``:670``), the counterparts of the reference's event-bounded
``lax.while_loop``s.  What each computes is
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

from repro_torch.kernels import nvcc, ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "sched.cu"
MAX_HOSTS = 1024    # the placement loops' worst fit: one warp, 32 hosts a lane
MAX_COMPONENTS = 32  # a slot's components fit one window of the sums' order
# Each kernel stages a member's state in one block's shared memory (at
# most 227 KB on sm_90): ~30-40 B per flat row, 8 B per slot, 2-10 B per
# app and 4-8 B per host and window of 32 rows, beside 16 B of alignment
# per region; *_smem_bytes() give the exact figures.
MAX_SMEM = 232448
BLOCK_WARPS = 8     # csrc/sched.cu:kWarps

_LIB: ctypes.CDLL | None = None
_B, _F32, _I32 = torch.bool, torch.float32, torch.int32
KERNELS = ("resolve_oom", "admit_queued", "place_missing_elastic")


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        for name, n_ptr, n_int in zip(KERNELS, (24, 30, 15), (7, 7, 5)):
            fn = getattr(lib, name)
            fn.argtypes = [ptr] * n_ptr + [i32] * n_int + [ptr] * 2   # clocks, stream
            fn.restype = i32
            getattr(lib, f"{name}_init").argtypes = []
            getattr(lib, f"{name}_init").restype = i32
            getattr(lib, f"{name}_smem").argtypes = [i32] * 4
            getattr(lib, f"{name}_smem").restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def _region(n):
    return (n + 31) // 16 * 16


def _sums_bytes(AC, H, V):
    """block_host_sums' two tables (csrc/sched.cu:sums_smem)."""
    windows = -(-AC // 32) if AC > 32 else 1
    return (_region(windows * (H * V + (V > 1)) * 4)
            + _region(-(-windows // 32) * H * V * 4))


def oom_smem_bytes(A: int, C: int, N: int, H: int) -> int:
    """The shared memory one block of resolve_oom takes at (A, C, N, H);
    the arithmetic of ``csrc/sched.cu:oom_smem``."""
    AC = A * C
    padded = AC + AC // 32 + 1
    return (2 * _region(A * 4) + 2 * _region(AC) + _region(AC * 4) + 2 * _region(AC * 8)
            + 2 * _region(N) + 2 * _region(padded * 4) + _sums_bytes(AC, H, 1)
            + _region(H * 4))


def admit_smem_bytes(A: int, C: int, N: int, H: int) -> int:
    """The shared memory one block of admit_queued takes at (A, C, N, H);
    the arithmetic of ``csrc/sched.cu:admit_smem``."""
    AC = A * C
    padded = AC + AC // 32 + 1
    return (2 * _region(A * 4) + 2 * _region(AC) + 2 * _region(AC * 4) + _region(AC * 8)
            + 2 * _region(N) + 2 * _region(N * 4) + _region(padded * 4)
            + _region(padded * 8) + _sums_bytes(AC, H, 2) + _region(H * 8)
            + _region((3 * BLOCK_WARPS + 2) * 4))


def elastic_smem_bytes(A: int, C: int, N: int, H: int) -> int:
    """The shared memory one block of place_missing_elastic takes at (A, C,
    N, H); the arithmetic of ``csrc/sched.cu:elastic_smem``."""
    AC = A * C
    padded = AC + AC // 32 + 1
    return (_region(A * 4) + 2 * _region(AC) + 2 * _region(AC * 4) + 2 * _region(AC * 8)
            + _region(padded * 4) + _region(padded * 8) + _sums_bytes(AC, H, 2)
            + _region(H * 8))


SMEM_BYTES = {"resolve_oom": oom_smem_bytes, "admit_queued": admit_smem_bytes,
              "place_missing_elastic": elastic_smem_bytes}


def _dims(name, comp_running, n_apps_tensor, host_cap):
    """(S, A, C, N, H) of a call of kernel ``name``; raises before any
    launch if the kernel cannot take it."""
    S, A, C = comp_running.shape
    N = n_apps_tensor.shape[1]
    H = host_cap.shape[0]
    if not 1 <= H <= MAX_HOSTS:
        raise ValueError(f"{H} hosts: the kernels take 1..{MAX_HOSTS}")
    if not 1 <= C <= MAX_COMPONENTS or A * C > 2**20:
        raise ValueError(f"A={A} slots of C={C} components: the kernels take "
                         f"C <= {MAX_COMPONENTS} and A * C <= 2**20")
    need = SMEM_BYTES[name](A, C, N, H)
    if need > MAX_SMEM:
        raise ValueError(f"A={A} slots of C={C} components, N={N} apps, H={H} hosts: "
                         f"{name} takes a member's state in {MAX_SMEM} B of shared "
                         f"memory (this one needs {need} B)")
    if comp_running.device.type != "cuda":
        raise ValueError(f"the scheduler kernels take CUDA tensors, got "
                         f"{comp_running.device}")
    return S, A, C, N, H


def _launch(name, device, *args) -> None:
    lib = _library()
    nvcc.prepare(getattr(lib, f"{name}_init"), name, device)
    nvcc.launch(getattr(lib, name), name, device, *args)


def _launch_oom(slot_gid, work_done, comp_running, comp_host, alloc, usage, failed,
                queued, oom_kills, failure_events, partial_preemptions, is_core,
                host_cap, clocks):
    S, A, C, N, H = _dims("resolve_oom", comp_running, failed, host_cap)
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
        _launch("resolve_oom", comp_running.device, slot_gid, work_done, comp_running,
                comp_host, alloc, usage, failed, queued, oom_kills, failure_events,
                partial_preemptions, is_core, host_cap, *outs, monreset, S, A, C, N, H,
                *ref.xla_slot_plan(A, C), clocks)
    return (*outs, monreset)


def _launch_admit(submit, gid, cpu_req, mem_req, exists, is_core, slot_gid, work_done,
                  comp_running, comp_host, alloc, alive_since, queued, has_saved,
                  saved_work, t, host_cap, resume, clocks, tenant=None, elig=None,
                  admitted=None):
    S, A, C, N, H = _dims("admit_queued", comp_running, submit, host_cap)
    gate = {}
    if tenant is not None:
        T = elig.shape[1] if elig.dim() == 2 else 0
        gate = dict(tenant=(tenant, _I32, (S, N)), elig=(elig, _B, (S, T)),
                    admitted=(admitted, _I32, (S, T)))
        if T < 1:
            raise ValueError(f"elig has shape {tuple(elig.shape)}; the gate takes (S, T)")
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
               host_cap=(host_cap, _F32, (H, 2)), **gate)
    outs = [torch.empty_like(x) for x in (slot_gid, work_done, comp_running,
                                          comp_host, alloc, alive_since, queued,
                                          has_saved)]
    resets = torch.empty((S, A * C), dtype=_B, device=comp_running.device)
    counted = () if tenant is None else (torch.empty_like(admitted),)
    if S:
        _launch("admit_queued", comp_running.device, submit, gid, cpu_req, mem_req,
                exists, is_core, slot_gid, work_done, comp_running, comp_host, alloc,
                alive_since, queued, has_saved, saved_work, t, host_cap, *outs, resets,
                tenant, elig, admitted, counted[0] if counted else None,
                S, A, C, N, H, int(resume), elig.shape[1] if counted else 0, clocks)
    return (*outs, resets, *counted)


def _launch_elastic(cpu_req, mem_req, exists, is_core, slot_gid, comp_running,
                    comp_host, alloc, alive_since, t, host_cap, clocks):
    S, A, C, N, H = _dims("place_missing_elastic", comp_running, cpu_req, host_cap)
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
        _launch("place_missing_elastic", comp_running.device, cpu_req, mem_req, exists,
                is_core, slot_gid, comp_running, comp_host, alloc, alive_since, t,
                host_cap, *outs, S, A, C, N, H, clocks)
    return tuple(outs)


@nvcc.counted
def resolve_oom(slot_gid, work_done, comp_running, comp_host, alloc, usage, failed,
                queued, oom_kills, failure_events, partial_preemptions, is_core,
                host_cap):
    """Launch the OOM kernel (one block per member); returns what
    ``ref.resolve_oom`` returns."""
    out = _launch_oom(slot_gid, work_done, comp_running, comp_host, alloc, usage,
                      failed, queued, oom_kills, failure_events, partial_preemptions,
                      is_core, host_cap, None)
    if slot_gid.shape[0]:
        nvcc.count(resolve_oom)
    return out


@nvcc.counted
def admit_queued(submit, gid, cpu_req, mem_req, exists, is_core, slot_gid,
                 work_done, comp_running, comp_host, alloc, alive_since, queued,
                 has_saved, saved_work, t, host_cap, resume: bool, tenant=None, elig=None,
                 admitted=None):
    """Launch the admission kernel (one block per member), gated by the
    control plane when ``tenant``, ``elig`` and ``admitted`` are given;
    returns what ``ref.admit_queued`` returns."""
    out = _launch_admit(submit, gid, cpu_req, mem_req, exists, is_core, slot_gid,
                        work_done, comp_running, comp_host, alloc, alive_since, queued,
                        has_saved, saved_work, t, host_cap, resume, None, tenant, elig,
                        admitted)
    if submit.shape[0]:
        nvcc.count(admit_queued)
    return out


@nvcc.counted
def place_missing_elastic(cpu_req, mem_req, exists, is_core, slot_gid, comp_running,
                          comp_host, alloc, alive_since, t, host_cap):
    """Launch the elastic re-placement kernel (one block per member);
    returns what ``ref.place_missing_elastic`` returns."""
    out = _launch_elastic(cpu_req, mem_req, exists, is_core, slot_gid, comp_running,
                          comp_host, alloc, alive_since, t, host_cap, None)
    if cpu_req.shape[0]:
        nvcc.count(place_missing_elastic)
    return out


def _clocks(args, n):
    return torch.zeros((args[0].shape[0], n), dtype=torch.int64, device=args[0].device)


def oom_phase_cycles(*args) -> torch.Tensor:
    """One launch of the OOM kernel that also stamps ``clock64()`` between
    its phases: ``(S, 4)`` int64 cycles per member of the staging, the
    per-host sums at entry, the victim loop and the write.  A measurement,
    not a launch of the main path: it is not counted."""
    clocks = _clocks(args, 4)
    _launch_oom(*args, clocks)
    return clocks


def admit_phase_cycles(*args) -> torch.Tensor:
    """One uncounted launch of the admission kernel with ``clock64()``
    stamps: ``(S, 5)`` int64 cycles per member of the staging, the head
    searches, the free tables, the placements (each summed over the
    admissions tried) and the write.  The arguments of
    :func:`admit_queued`, the gate's three included where given."""
    clocks = _clocks(args, 5)
    _launch_admit(*args[:18], clocks, *args[18:])
    return clocks


def elastic_phase_cycles(*args) -> torch.Tensor:
    """One uncounted launch of the elastic re-placement kernel with
    ``clock64()`` stamps: ``(S, 5)`` int64 cycles per member of the
    staging, the missing search, the free table, the walk and the write."""
    clocks = _clocks(args, 5)
    _launch_elastic(*args, clocks)
    return clocks


def reset_launch_counts() -> None:
    resolve_oom.launches = admit_queued.launches = place_missing_elastic.launches = 0
