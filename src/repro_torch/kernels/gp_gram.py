"""CUDA Gram kernels for the GP forecaster: build, bind and launch.

Counterpart of ``repro/kernels/gp_gram.py:gp_gram``, the Pallas TPU
kernel.  The kernels themselves, their bound on the card and their
design are described in ``csrc/gp_gram.cu``.  Their caller is the GP's
Gram route (``core/forecast/gp.py``), which takes the configurations the
fused GP program cannot.

The source is compiled by :func:`repro_torch.kernels.nvcc.build` into a
shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built when this module is imported: the first launch builds
(or reuses) the library.

Each wrapper checks its tensors, allocates its outputs (and the
gradient's per-tile scratch) with ``torch.empty``, allows the kernels
their shared memory once per device (``gp_gram_init``, through
:func:`nvcc.prepare`, so that a launch captured in a CUDA graph is a
launch only), launches on the current CUDA stream, raises if the launch
returned an error, and counts its launches in ``gram_fwd.launches`` and
``gram_bwd.launches`` (both registered with :func:`nvcc.counted`).
With ``xa`` and ``xb`` the same tensor (the fit's K(X, X)) the kernels
compute the tiles on and above the diagonal only.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels.ref import KINDS

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_gram.cu"

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.gp_gram_fwd.argtypes = [ptr] * 5 + [i32] * 5 + [ptr]
        lib.gp_gram_fwd.restype = i32
        lib.gp_gram_bwd.argtypes = [ptr] * 8 + [i32] * 5 + [ptr]
        lib.gp_gram_bwd.restype = i32
        lib.gp_gram_parts.argtypes = [ptr, ptr] + [i32] * 3
        lib.gp_gram_parts.restype = i32
        lib.gp_gram_init.argtypes = []
        lib.gp_gram_init.restype = i32
        _LIB = lib
    return _LIB


def _check(xa, xb, ell, sf, kind):
    """Validate the kernels' inputs; return (B, M, N, D, kind code)."""
    if kind not in KINDS:
        raise ValueError(f"unknown kernel kind: {kind!r} (expected one of {KINDS})")
    ts = {"xa": xa, "xb": xb, "ell": ell, "sf": sf}
    for name, t in ts.items():
        if t.device.type != "cuda" or t.device != xa.device:
            raise ValueError(f"{name} is on {t.device}; all inputs must be on "
                             f"one CUDA device ({xa.device})")
        if t.dtype != torch.float32:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes float32")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if xa.dim() != 3 or xb.dim() != 3 or ell.dim() != 1 or sf.dim() != 1:
        raise ValueError("expected xa (B,M,D), xb (B,N,D), ell (B,), sf (B,); "
                         f"got {tuple(xa.shape)}, {tuple(xb.shape)}, "
                         f"{tuple(ell.shape)}, {tuple(sf.shape)}")
    B, M, D = xa.shape
    N = xb.shape[1]
    if xb.shape[0] != B or xb.shape[2] != D or ell.shape[0] != B or sf.shape[0] != B:
        raise ValueError("batch or feature sizes disagree: "
                         f"xa {tuple(xa.shape)}, xb {tuple(xb.shape)}, "
                         f"ell {tuple(ell.shape)}, sf {tuple(sf.shape)}")
    if min(B, M, N, D) < 1 or max(B * M * N, B * M * D, B * N * D) >= 2**31:
        raise ValueError(f"sizes B={B} M={M} N={N} D={D} out of the kernel's range")
    return B, M, N, D, KINDS.index(kind)


def _parts(lib, xa, xb, B, M, N, D) -> int:
    """The gradient's partial sums a series (the kernels' own plan: one
    where a block computes a whole series, else one a tile and block); B
    of them must fit one grid."""
    parts = lib.gp_gram_parts(xa.data_ptr(), xb.data_ptr(), M, N, D)
    if B * parts >= 2**31:
        raise ValueError(f"B={B} series of {parts} tiles: too many blocks for one grid")
    return parts


def _prepared(device) -> ctypes.CDLL:
    lib = _library()
    nvcc.prepare(lib.gp_gram_init, "gp_gram", device)
    return lib


@nvcc.counted
def gram_fwd(xa: torch.Tensor, xb: torch.Tensor, ell: torch.Tensor,
             sf: torch.Tensor, kind: str = "exp") -> torch.Tensor:
    """Launch the forward kernel: ``(B,M,D) x (B,N,D) -> (B,M,N)``."""
    B, M, N, D, code = _check(xa, xb, ell, sf, kind)
    lib = _prepared(xa.device)
    _parts(lib, xa, xb, B, M, N, D)
    out = torch.empty((B, M, N), dtype=torch.float32, device=xa.device)
    nvcc.launch(lib.gp_gram_fwd, "gp_gram_fwd", xa.device, xa, xb, ell, sf, out,
                B, M, N, D, code)
    nvcc.count(gram_fwd)
    return out


@nvcc.counted
def gram_bwd(grad: torch.Tensor, xa: torch.Tensor, xb: torch.Tensor,
             ell: torch.Tensor, sf: torch.Tensor,
             kind: str = "exp") -> tuple[torch.Tensor, torch.Tensor]:
    """Launch the backward kernel (and, where a series is computed tile by
    tile, the pass that adds its tiles' sums): ``(d_ell, d_sf)``, each
    ``(B,)``."""
    B, M, N, D, code = _check(xa, xb, ell, sf, kind)
    if (grad.device != xa.device or grad.dtype != torch.float32
            or not grad.is_contiguous() or tuple(grad.shape) != (B, M, N)):
        raise ValueError(f"grad must be a contiguous float32 ({B}, {M}, {N}) "
                         f"tensor on {xa.device}")
    lib = _prepared(xa.device)
    parts = _parts(lib, xa, xb, B, M, N, D)
    d_ell = torch.empty((B,), dtype=torch.float32, device=xa.device)
    d_sf = torch.empty((B,), dtype=torch.float32, device=xa.device)
    part = torch.empty((B * parts * 2 if parts > 1 else 1,), dtype=torch.float32,
                       device=xa.device)
    nvcc.launch(lib.gp_gram_bwd, "gp_gram_bwd", xa.device, grad, xa, xb, ell, sf,
                d_ell, d_sf, part, B, M, N, D, code)
    nvcc.count(gram_bwd)
    return d_ell, d_sf


def reset_launch_counts() -> None:
    gram_fwd.launches = 0
    gram_bwd.launches = 0


class Gram(torch.autograd.Function):
    """The CUDA Gram matrix, differentiable in ``(ell, sf)`` only.

    The GP's evidence loop differentiates the Gram matrix with respect to
    its hyper-parameters alone (``core/forecast/gp.py``); the pattern
    sets ``xa``, ``xb`` get no gradient, and asking for one raises."""

    @staticmethod
    def forward(ctx, xa, xb, ell, sf, kind):
        ctx.save_for_backward(xa, xb, ell, sf)
        ctx.kind = kind
        return gram_fwd(xa, xb, ell, sf, kind)

    @staticmethod
    def backward(ctx, grad):
        if ctx.needs_input_grad[0] or ctx.needs_input_grad[1]:
            raise NotImplementedError(
                "the gp_gram kernel has no gradient with respect to the patterns")
        xa, xb, ell, sf = ctx.saved_tensors
        d_ell, d_sf = gram_bwd(grad.contiguous(), xa, xb, ell, sf, ctx.kind)
        return None, None, d_ell, d_sf, None
