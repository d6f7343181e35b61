"""CUDA kernel of Algorithm 1's sequential pass (the pessimistic
policy): build, bind and launch.

One launch runs, for every member of a batch, the greedy pass over the
processing order that ``ref.pessimistic_pass`` defines: the counterpart
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
MAX_HOSTS = 6144    # the (H, 2) free table in 48 KB of shared memory
MAX_COMPONENTS = 32  # a row's core demand is summed in order, as XLA sums <= 32

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        lib.pessimistic_pass.argtypes = ([ctypes.c_void_p] * 10 + [ctypes.c_int] * 4
                                         + [ctypes.c_void_p])
        lib.pessimistic_pass.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def pessimistic_pass(valid, dem, core, el, host, order, free0):
    """Launch the kernel: ``(remove_pos (S,A), kill_pos (S,A,C), free
    (S,H,2))`` as ``ref.pessimistic_pass`` returns them."""
    S, A, C = core.shape
    H = free0.shape[1]
    if not 1 <= H <= MAX_HOSTS or not 1 <= C <= MAX_COMPONENTS:
        raise ValueError(f"{H} hosts of {C} components: the kernel takes "
                         f"1..{MAX_HOSTS} hosts and 1..{MAX_COMPONENTS} components")
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
        nvcc.launch(_library().pessimistic_pass, "pessimistic_pass", valid.device,
                    valid, dem, core, el, host, order, free0, remove, kill, free,
                    S, A, C, H)
        pessimistic_pass.launches += 1
    return remove, kill, free


pessimistic_pass.launches = 0


def reset_launch_counts() -> None:
    pessimistic_pass.launches = 0
