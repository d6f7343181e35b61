"""CUDA kernel of ``a * b + c`` rounded once to float32 (the fused
multiply-add XLA:CPU makes of the reference's expression, subnormals
flushed as XLA:CPU flushes them): build, bind and launch.

The kernel, its bound and its design are described in ``csrc/fma.cu``;
its plain version is ``ref.fma_f32``.  Nothing is built when this module
is imported: the first launch builds (or reuses) the library with
:func:`repro_torch.kernels.nvcc.build`.

The wrapper broadcasts ``a``, ``b`` and ``c`` to one shape of fewer than
2**31 elements and copies only an operand that is not already a
contiguous float32 tensor of that shape; a scalar ``b`` (Python or
numpy) is passed by value as float32.
It allocates the output with ``torch.empty``, launches on the current
CUDA stream, raises if the launch returned an error, and counts its
launches in ``fma_f32.launches``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import numpy as np
import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "fma.cu"

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr = ctypes.c_void_p
        lib.fma_f32.argtypes = [ptr, ptr, ctypes.c_float, ptr, ptr, ctypes.c_int64, ptr]
        lib.fma_f32.restype = ctypes.c_int
        _LIB = lib
    return _LIB


def _operand(name: str, t: torch.Tensor, shape, device) -> torch.Tensor:
    if t.device != device:
        raise ValueError(f"{name} is on {t.device}; all inputs must be on {device}")
    if t.dtype != torch.float32:
        raise TypeError(f"{name} is {t.dtype}; the kernel takes torch.float32")
    return t if t.shape == shape and t.is_contiguous() else t.expand(shape).contiguous()


@nvcc.counted
def fma_f32(a: torch.Tensor, b, c: torch.Tensor) -> torch.Tensor:
    """Launch the kernel: ``a * b + c`` with one rounding, as
    ``ref.fma_f32`` returns it."""
    if a.device.type != "cuda":
        raise ValueError(f"fma_f32 takes CUDA tensors, got {a.device}")
    tensor_b = isinstance(b, torch.Tensor)
    shapes = (a.shape, c.shape, *([b.shape] if tensor_b else []))
    # the engine's calls mostly take operands of one shape: skip the general
    # broadcast (several microseconds of host time) when they do
    shape = a.shape if all(x == a.shape for x in shapes) else torch.broadcast_shapes(*shapes)
    if shape.numel() >= 2**31:
        raise ValueError(f"fma_f32 takes fewer than 2**31 elements, got {shape.numel()}")
    a = _operand("a", a, shape, a.device)
    c = _operand("c", c, shape, a.device)
    b_t = _operand("b", b, shape, a.device) if tensor_b else None
    out = torch.empty(shape, dtype=torch.float32, device=a.device)
    if out.numel():
        nvcc.launch(_library().fma_f32, "fma_f32", a.device, a, b_t,
                    0.0 if tensor_b else float(np.float32(b)), c, out, out.numel())
        nvcc.count(fma_f32)
    return out


def reset_launch_counts() -> None:
    fma_f32.launches = 0
