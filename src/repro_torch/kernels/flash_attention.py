"""CUDA flash-attention kernel: build, bind and launch.

Counterpart of ``repro/kernels/flash_attention.py:flash_attention``, the
Pallas TPU kernel.  The kernel, its bound on the card and its design are
described in ``csrc/flash_attention.cu``; its plain PyTorch version is
``repro_torch.kernels.ref.attention``.

The source is compiled by :func:`repro_torch.kernels.nvcc.build` into a
shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built when this module is imported: the first launch builds
(or reuses) the library.

The wrapper checks its tensors, allocates the output with ``torch.empty``,
launches on the current CUDA stream, raises if the launch returned an
error, and counts its launches in ``flash_attention.launches``.  Unlike
the TPU kernel it needs no padding: any S, T and D <= 128 are masked in
the kernel.  There is no gradient (the JAX package has none either).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "flash_attention.cu"
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.flash_attention_fwd.argtypes = ([ptr] * 4 + [i32] * 6
                                            + [ctypes.c_float] + [i32] * 3 + [ptr])
        lib.flash_attention_fwd.restype = i32
        _LIB = lib
    return _LIB


def _check(q, k, v, causal, q_offset):
    """Validate the kernel's inputs; return (B, Hq, Hkv, S, T, D)."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; q, k and v must be on "
                             f"one CUDA device ({q.device})")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes q, k and v "
                            "all float32 or all bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"shape {tuple(t.shape)}")
        if t.numel() >= 2**31:
            raise ValueError(f"{name} has {t.numel()} elements; the kernel "
                             "takes fewer than 2**31")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or Hq % Hkv != 0 or min(B, Hq, S, T, D) < 1):
        raise ValueError("expected q (B,Hq,S,D), k and v (B,Hkv,T,D) with "
                         f"Hq % Hkv == 0; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}: the kernel keeps at most "
                         f"{MAX_D} output columns per row in registers")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} or Hq={Hq} exceeds the grid's 65535")
    if causal and q_offset < 0:
        raise ValueError(f"causal attention with q_offset={q_offset} < 0 "
                         f"(S={S} queries after T={T} keys): the first rows "
                         "would see no key")
    return B, Hq, Hkv, S, T, D


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int | None = None) -> torch.Tensor:
    """Launch the kernel: q (B,Hq,S,D), k/v (B,Hkv,T,D) -> (B,Hq,S,D) in
    q's dtype.  ``q_offset`` is the position of q's first row among the
    keys (T - S by default); ``sm_scale`` defaults to 1/sqrt(D)."""
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    B, Hq, Hkv, S, T, D = _check(q, k, v, causal, q_offset)
    if sm_scale is None:
        sm_scale = D ** -0.5
    lib = _library()
    out = torch.empty_like(q)
    with torch.cuda.device(q.device):
        stream = torch.cuda.current_stream().cuda_stream
        rc = lib.flash_attention_fwd(
            q.data_ptr(), k.data_ptr(), v.data_ptr(), out.data_ptr(), B, Hq,
            Hkv, S, T, D, float(sm_scale), int(causal), int(q_offset),
            _DTYPES[q.dtype], stream)
    if rc != 0:
        raise RuntimeError(f"flash_attention launch failed: CUDA error {rc}")
    flash_attention.launches += 1
    return out


flash_attention.launches = 0


def reset_launch_counts() -> None:
    flash_attention.launches = 0
