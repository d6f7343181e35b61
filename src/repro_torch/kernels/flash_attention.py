"""CUDA flash-attention kernels: build, bind, route and launch.

Counterparts of ``repro/kernels/flash_attention.py:flash_attention``, the
Pallas TPU kernel.  Two hand-written kernels share its work, and
:func:`route` picks one from the call's dtype, head dim and alignment:

* ``"sm90"`` (``csrc/flash_attention_sm90.cu``): bf16 on the tensor
  cores (wgmma, TMA loads), for bf16 with D % 8 == 0 and 16-byte aligned
  q, k and v, as TMA requires.  It rounds the softmax weights to bf16
  before P·V, as tensor-core flash attention does.
* ``"simt"`` (``csrc/flash_attention.cu``): fp32 arithmetic on the CUDA
  cores, for every other call it takes: fp32 (held to 2e-5, so no TF32)
  and bf16 with D % 8 != 0.

Each source's note gives its bound on the card and its design; the
plain PyTorch version of both is ``repro_torch.kernels.ref.attention``.

Each source is compiled by :func:`repro_torch.kernels.nvcc.build` into a
shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built when this module is imported: the first launch of a
route builds (or reuses) its library.

The wrapper checks its tensors, allocates the output with ``torch.empty``,
launches on the current CUDA stream, raises if the launch returned an
error, and counts its launches in ``flash_attention.launches`` (all
routes) and ``flash_attention.route_launches`` (per route).  Unlike the
TPU kernel it needs no padding: any S, T and D <= 128 are masked in the
kernels.  There is no gradient (the JAX package has none either).
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

CSRC = Path(__file__).resolve().parent / "csrc"
SOURCE = CSRC / "flash_attention.cu"              # the "simt" route
SOURCE_SM90 = CSRC / "flash_attention_sm90.cu"    # the "sm90" route
ROUTES = ("sm90", "simt")
MAX_D = 128
_DTYPES = {torch.float32: 0, torch.bfloat16: 1}

_LIB: ctypes.CDLL | None = None        # the simt library
_LIB_SM90: ctypes.CDLL | None = None   # the sm90 library


def route(dtype: torch.dtype, d: int, aligned: bool = True) -> str:
    """The kernel a CUDA call of this dtype and head dim takes: "sm90"
    for bf16 with D % 8 == 0 whose q, k and v start on 16 bytes (TMA
    needs 16-byte row strides and bases), "simt" for everything else the
    wrapper accepts."""
    if dtype == torch.bfloat16 and d % 8 == 0 and aligned:
        return "sm90"
    return "simt"


def _library(which: str) -> ctypes.CDLL:
    global _LIB, _LIB_SM90
    ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
    if which == "simt" and _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        lib.flash_attention_fwd.argtypes = [ptr] * 4 + [i32] * 6 + [f32] + [i32] * 3 + [ptr]
        lib.flash_attention_fwd.restype = i32
        _LIB = lib
    if which == "sm90" and _LIB_SM90 is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE_SM90).path))
        lib.flash_attention_sm90_fwd.argtypes = [ptr] * 4 + [i32] * 6 + [f32] + [i32] * 2 + [ptr]
        lib.flash_attention_sm90_fwd.restype = i32
        _LIB_SM90 = lib
    return _LIB if which == "simt" else _LIB_SM90


def _check(q, k, v, causal, q_offset):
    """Validate the kernels' inputs; return (B, Hq, Hkv, S, T, D)."""
    dev, dtype = q.device, q.dtype
    if not (dev.type == "cuda" and k.device == dev and v.device == dev
            and dtype in _DTYPES and k.dtype == dtype and v.dtype == dtype
            and q.dim() == k.dim() == v.dim() == 4 and q.is_contiguous()
            and k.is_contiguous() and v.is_contiguous()):
        _refuse(q, k, v)
    if max(q.numel(), k.numel()) >= 2**31:
        raise ValueError("q, k and v must have fewer than 2**31 elements each, got "
                         f"{q.numel()}, {k.numel()}")
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    if (k.shape[0] != B or k.shape[3] != D or v.shape != k.shape
            or Hq % Hkv != 0 or min(B, Hq, S, T, D) < 1):
        raise ValueError("expected q (B,Hq,S,D), k and v (B,Hkv,T,D) with "
                         f"Hq % Hkv == 0; got {tuple(q.shape)}, {tuple(k.shape)}, "
                         f"{tuple(v.shape)}")
    if D > MAX_D:
        raise ValueError(f"head dim {D} > {MAX_D}: the kernels keep at most "
                         f"{MAX_D} output columns per row in registers")
    if B > 65535 or Hq > 65535:
        raise ValueError(f"B={B} or Hq={Hq} exceeds the grid's 65535")
    if causal and q_offset < 0:
        raise ValueError(f"causal attention with q_offset={q_offset} < 0 "
                         f"(S={S} queries after T={T} keys): the first rows "
                         "would see no key")
    return B, Hq, Hkv, S, T, D


def _refuse(q, k, v):
    """Raise for the first of q, k, v that no kernel takes."""
    for name, t in (("q", q), ("k", k), ("v", v)):
        if t.device.type != "cuda" or t.device != q.device:
            raise ValueError(f"{name} is on {t.device}; q, k and v must be on "
                             f"one CUDA device ({q.device})")
        if t.dtype not in _DTYPES or t.dtype != q.dtype:
            raise TypeError(f"{name} is {t.dtype}; the kernels take q, k and v "
                            "all float32 or all bfloat16")
        if t.dim() != 4 or not t.is_contiguous():
            raise ValueError(f"{name} must be a contiguous 4-d tensor, got "
                             f"shape {tuple(t.shape)}")


def flash_attention(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor, *,
                    causal: bool = True, sm_scale: float | None = None,
                    q_offset: int | None = None) -> torch.Tensor:
    """Launch the routed kernel: q (B,Hq,S,D), k/v (B,Hkv,T,D) ->
    (B,Hq,S,D) in q's dtype.  ``q_offset`` is the position of q's first
    row among the keys (T - S by default); ``sm_scale`` defaults to
    1/sqrt(D)."""
    if q_offset is None:
        q_offset = k.shape[2] - q.shape[2]
    shape = _check(q, k, v, causal, q_offset)
    aligned = q.data_ptr() % 16 == 0 and k.data_ptr() % 16 == 0 and v.data_ptr() % 16 == 0
    return _launch(route(q.dtype, shape[-1], aligned), q, k, v, shape, causal,
                   sm_scale, q_offset)


def _launch(which, q, k, v, shape, causal, sm_scale, q_offset):
    """Launch the ``which`` kernel on checked inputs and count it."""
    B, Hq, Hkv, S, T, D = shape
    if sm_scale is None:
        sm_scale = D ** -0.5
    lib = _library(which)
    out = torch.empty_like(q)
    args = (q, k, v, out, B, Hq, Hkv, S, T, D, float(sm_scale), int(causal), int(q_offset))
    if which == "sm90":
        nvcc.launch(lib.flash_attention_sm90_fwd, "flash_attention (sm90)", q.device, *args)
    else:
        nvcc.launch(lib.flash_attention_fwd, "flash_attention (simt)", q.device, *args,
                    _DTYPES[q.dtype])
    nvcc.count(flash_attention)
    flash_attention.route_launches[which] += 1
    return out


flash_attention.launches = 0
flash_attention.route_launches = dict.fromkeys(ROUTES, 0)


def reset_launch_counts() -> None:
    flash_attention.launches = 0
    flash_attention.route_launches = dict.fromkeys(ROUTES, 0)
