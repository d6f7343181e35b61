"""CUDA kernel of the device engine's idle-tick skip (leap ticks): build,
bind and launch.

One launch per leap step, one block per member: the counterpart of the
scalar ``lax.while_loop`` in the reference's ``fused_leap``
(``repro/sim/step.py:955-970``).  What it computes is defined by
``ref.leap_skip``; the kernel, its bound and its design are described in
``csrc/leap.cu``.  Nothing is built when this module is imported: the
first launch builds (or reuses) the library with
:func:`repro_torch.kernels.nvcc.build`.

The wrapper checks its tensors, allocates its outputs with
``torch.empty``, launches on the current CUDA stream (it reads nothing
back, so a CUDA graph can hold it), raises if the launch returned an
error, and counts its launches in ``leap_skip.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "leap.cu"

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.leap_skip.argtypes = [ptr] * 8 + [ctypes.c_float] + [ptr] * 2 + [i32] * 4 + [ptr]
        lib.leap_skip.restype = i32
        _LIB = lib
    return _LIB


def _check(slot_gid, queued, arrived, submit, done, t, left) -> tuple[int, int, int]:
    """Validate the kernel's inputs; return (S, A, N)."""
    if slot_gid.dim() != 2 or submit.dim() != 2:
        raise ValueError(f"expected slot_gid (S, A) and submit (S, N), got "
                         f"{tuple(slot_gid.shape)} and {tuple(submit.shape)}")
    S, A = slot_gid.shape
    N = submit.shape[1]
    if S < 1 or A < 1 or N < 1:
        raise ValueError(f"S={S} members, A={A} slots, N={N} apps: the kernel takes >= 1 each")
    if slot_gid.device.type != "cuda":
        raise ValueError(f"leap_skip takes CUDA tensors, got {slot_gid.device}")
    b, f32, i32 = torch.bool, torch.float32, torch.int32
    nvcc.check(slot_gid.device, slot_gid=(slot_gid, i32, (S, A)),
               queued=(queued, b, (S, N)), arrived=(arrived, b, (S, N)),
               submit=(submit, f32, (S, N)), done=(done, b, (S, N)),
               t=(t, f32, (S,)), left=(left, i32, (S,)))
    return S, A, N


def _check_calib(calib_left, S: int, device) -> int:
    """Validate the calibration state's ``left`` (S, R); return R (0 when
    absent)."""
    if calib_left is None:
        return 0
    if calib_left.dim() != 2 or calib_left.shape[1] < 1:
        raise ValueError(f"expected calib_left (S, R), got {tuple(calib_left.shape)}")
    R = calib_left.shape[1]
    nvcc.check(device, calib_left=(calib_left, torch.int32, (S, R)))
    return R


@nvcc.counted
def leap_skip(slot_gid: torch.Tensor, queued: torch.Tensor, arrived: torch.Tensor,
              submit: torch.Tensor, done: torch.Tensor, t: torch.Tensor,
              left: torch.Tensor, tick: float, calib_left: torch.Tensor | None = None
              ) -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the kernel: ``(t, lead)``, each ``(S,)``, as ``ref.leap_skip``
    returns them."""
    S, A, N = _check(slot_gid, queued, arrived, submit, done, t, left)
    R = _check_calib(calib_left, S, slot_gid.device)
    t_out = torch.empty_like(t)
    lead = torch.empty_like(left)
    nvcc.launch(_library().leap_skip, "leap_skip", slot_gid.device, slot_gid, queued,
                arrived, submit, done, t, left, calib_left, float(np.float32(tick)), t_out,
                lead, S, A, N, R)
    nvcc.count(leap_skip)
    return t_out, lead


def reset_launch_counts() -> None:
    leap_skip.launches = 0
