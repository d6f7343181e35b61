"""CUDA kernel of the ARIMA forecaster: build, bind and launch.

One launch forecasts a batch of series: for each, the scale
normalisation, the Hannan-Rissanen fits of every candidate order (two
ridge-regularised least-squares solves each), their AICs, the choice and
the chosen order's k-step recursion and psi-weight variance, what
``ref.arima_select`` computes.  It replaces no Pallas kernel: the
reference's ARIMA is plain JAX (``repro/core/forecast/arima.py:140-212``)
that XLA fuses, and written as plain PyTorch it would put hundreds of
small kernels into every captured tick of the device engine.  The
kernel, its bound and its design are described in
``csrc/arima_forecast.cu``.

The source is compiled by :func:`repro_torch.kernels.nvcc.build` into a
shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built when this module is imported: the first launch builds
(or reuses) the library.

The wrapper checks its tensors and the config, allocates its outputs
with ``torch.empty``, launches on the current CUDA stream (it reads
nothing back, so a CUDA graph can hold it), raises if the launch
returned an error, and counts its launches in ``arima_forecast.launches``.
With ``ready`` (one bool per series, on the card) the kernel runs only
the series it marks and writes zeros for the others; the device engine
passes its forecast-ready monitor rows so.  A call the kernel cannot
take raises a ``ValueError``.
"""
from __future__ import annotations

import ctypes
from pathlib import Path

import torch

from repro_torch.kernels import nvcc

SOURCE = Path(__file__).resolve().parent / "csrc" / "arima_forecast.cu"
# the orders the kernel's registers are laid out for (csrc/arima_forecast.cu)
MAX_P, MAX_Q, MAX_LONG_AR, MAX_D = 3, 2, 6, 1
MAX_T = 256         # samples per window: 22 floats and 5 flags each in a block's shared memory

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32 = ctypes.c_void_p, ctypes.c_int
        lib.arima_forecast.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
        lib.arima_forecast.restype = i32
        _LIB = lib
    return _LIB


def _check(windows, valid, horizon: int, cfg, ready=None) -> tuple[int, int]:
    """Validate the kernel's inputs; return (B, T)."""
    if windows.dim() != 2:
        raise ValueError(f"expected windows (B, T), got {tuple(windows.shape)}")
    B, T = windows.shape
    if not (0 <= cfg.max_p <= MAX_P and 0 <= cfg.max_q <= MAX_Q
            and 0 <= cfg.long_ar <= MAX_LONG_AR and 0 <= cfg.max_d <= MAX_D
            and cfg.max_p + cfg.max_q > 0):
        raise ValueError(f"{cfg}: the kernel takes max_p <= {MAX_P}, max_q <= {MAX_Q}, "
                         f"long_ar <= {MAX_LONG_AR}, max_d <= {MAX_D} and "
                         "max_p + max_q > 0")
    if not (1 <= T <= MAX_T and horizon >= 1 and 1 <= B < 2**31 // max(T, horizon)):
        raise ValueError(f"B={B}, T={T}, horizon={horizon}: the kernel takes "
                         f"1 <= T <= {MAX_T}, horizon >= 1 and B * max(T, horizon) < 2**31")
    if windows.device.type != "cuda":
        raise ValueError(f"arima_forecast takes CUDA tensors, got {windows.device}")
    nvcc.check(windows.device, windows=(windows, torch.float32, (B, T)),
               valid=(valid, torch.bool, (B, T)))
    if ready is not None:
        nvcc.check(windows.device, ready=(ready, torch.bool, (B,)))
    return B, T


@nvcc.counted
def arima_forecast(windows: torch.Tensor, valid: torch.Tensor, horizon: int, cfg,
                   ready: torch.Tensor | None = None):
    """Launch the kernel: ``(mean, var)``, ``(B, horizon)`` each, as
    ``ref.arima_forecast`` returns them."""
    B, T = _check(windows, valid, horizon, cfg, ready)
    mean = torch.empty((B, horizon), dtype=torch.float32, device=windows.device)
    var = torch.empty((B, horizon), dtype=torch.float32, device=windows.device)
    nvcc.launch(_library().arima_forecast, "arima_forecast", windows.device, windows,
                valid, ready, mean, var, B, T, horizon, cfg.max_p, cfg.max_q, cfg.max_d,
                cfg.long_ar)
    nvcc.count(arima_forecast)
    return mean, var


def reset_launch_counts() -> None:
    arima_forecast.launches = 0
