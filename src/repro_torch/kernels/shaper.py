"""CUDA kernel of Algorithm 1's sequential pass (the pessimistic
policy): build, bind and launch.

One launch (one block per member) runs, for every member of a batch,
the greedy pass over the processing order that ``ref.pessimistic_pass``
defines: the counterpart
of the ``lax.scan`` at ``repro/core/shaper/pessimistic.py:117-143``.
The kernel, its bound and its design are described in
``csrc/shaper.cu``.  Nothing is built when this module is imported: the
first launch builds (or reuses) the library with
:func:`repro_torch.kernels.nvcc.build`.

The wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current CUDA stream, raises if the
launch returned an error, and counts its launches in
``pessimistic_pass.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "shaper.cu"
MAX_COMPONENTS = 32  # a row's core demand is summed in order, as XLA sums <= 32
# A member's whole state sits in one block's shared memory (at most 227 KB
# on sm_90): 51 B per (row, component), 10 B per row and 8 B per host,
# beside 16 B of alignment per region; A = 128 rows of C = 12 on H = 50
# hosts take 80,288 B.  smem_bytes() gives the exact figure.
MAX_SMEM = 232448

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        lib.pessimistic_pass.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p] * 2)
        lib.pessimistic_pass.restype = ctypes.c_int
        lib.pessimistic_pass_init.argtypes = []
        lib.pessimistic_pass_init.restype = ctypes.c_int
        lib.pessimistic_pass_smem.argtypes = [ctypes.c_int] * 3
        lib.pessimistic_pass_smem.restype = ctypes.c_longlong
        _LIB = lib
    return _LIB


def smem_bytes(A: int, C: int, H: int) -> int:
    """The shared memory one block takes at (A, C, H); the arithmetic of
    ``csrc/shaper.cu:smem_bytes``."""
    def region(n):
        return (n + 31) // 16 * 16
    AC = A * C
    return (region(A) + region(AC * 8) + 2 * region(AC) + 2 * region(AC * 4)
            + region(H * 8) + region((A + 1) * 8) + region(AC * 16)
            + region((AC + 1) * 16) + region(A) + region(AC) + region(32))


def _launch(valid, dem, core, el, host, order, free0, clocks):
    S, A, C = core.shape
    H = free0.shape[1]
    if H < 1 or not 1 <= C <= MAX_COMPONENTS or smem_bytes(A, C, H) > MAX_SMEM:
        raise ValueError(f"A={A} rows of C={C} components on H={H} hosts: the kernel "
                         f"takes 1..{MAX_COMPONENTS} components, at least one host, "
                         f"and a member's state in {MAX_SMEM} B of shared memory "
                         f"(this one needs {smem_bytes(A, C, H)} B)")
    b, f32, i32 = torch.bool, torch.float32, torch.int32
    nvcc.check(valid.device, valid=(valid, b, (S, A)), dem=(dem, f32, (S, A, C, 2)),
               core=(core, b, (S, A, C)), el=(el, b, (S, A, C)),
               host=(host, i32, (S, A, C)), order=(order, i32, (S, A, C)),
               free0=(free0, f32, (S, H, 2)))
    if valid.device.type != "cuda":
        raise ValueError(f"pessimistic_pass takes CUDA tensors, got {valid.device}")
    remove = torch.empty((S, A), dtype=b, device=valid.device)
    kill = torch.empty((S, A, C), dtype=b, device=valid.device)
    free = torch.empty_like(free0)
    if S:
        lib = _library()
        nvcc.prepare(lib.pessimistic_pass_init, "pessimistic_pass", valid.device)
        nvcc.launch(lib.pessimistic_pass, "pessimistic_pass", valid.device,
                    valid, dem, core, el, host, order, free0, remove, kill, free,
                    S, A, C, H, clocks)
    return remove, kill, free


@nvcc.counted
def pessimistic_pass(valid, dem, core, el, host, order, free0):
    """Launch the kernel: ``(remove_pos (S,A), kill_pos (S,A,C), free
    (S,H,2))`` as ``ref.pessimistic_pass`` returns them."""
    out = _launch(valid, dem, core, el, host, order, free0, None)
    if valid.shape[0]:
        nvcc.count(pessimistic_pass)
    return out


def phase_cycles(valid, dem, core, el, host, order, free0) -> torch.Tensor:
    """One launch that also stamps ``clock64()`` between its phases:
    ``(S, 4)`` int64 cycles per member of staging, the parallel
    precompute, the chain and the write.  A measurement, not a launch of
    the main path: it is not counted."""
    clocks = torch.zeros((valid.shape[0], 4), dtype=torch.int64, device=valid.device)
    _launch(valid, dem, core, el, host, order, free0, clocks)
    return clocks


def reset_launch_counts() -> None:
    pessimistic_pass.launches = 0
