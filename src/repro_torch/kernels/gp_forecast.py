"""CUDA kernel of the GP forecaster's per-series program: build, bind and
launch.

One launch runs, for every series of a batch, the evidence loop (Adam on
the log marginal likelihood with its gradient in closed form), the fit
and the iterated horizon: what ``ref.gp_fit_forecast`` computes with
autograd and batched linear algebra.  On the simulation's main path it
takes the place of the Gram kernels (counterparts of
``repro/kernels/gp_gram.py:gp_gram``) and the ~1,400 launches around
them.  The kernel, its bound and its design are described in
``csrc/gp_forecast.cu``.

The source is compiled by :func:`repro_torch.kernels.nvcc.build` into a
shared library with a plain C interface and loaded with ``ctypes``.
Nothing is built when this module is imported: the first launch builds
(or reuses) the library.

The wrapper checks its tensors, allocates its outputs with
``torch.empty``, allows the kernel its opt-in shared memory once per
device (``gp_forecast_init``, through :func:`nvcc.prepare`, so that a
launch captured in a CUDA graph is a launch only), launches on the
current CUDA stream, raises if the launch returned an error, and counts
its launches in ``gp_fit_forecast.launches``.  A call the kernel cannot
take raises a ``ValueError``.  With ``ready`` (one bool per series, on
the card) the kernel runs only the series it marks; the device engine
passes its forecast-ready monitor rows so.
"""
from __future__ import annotations

import ctypes
import functools
from pathlib import Path

import torch

from repro_torch.kernels import nvcc
from repro_torch.kernels import ref

SOURCE = Path(__file__).resolve().parent / "csrc" / "gp_forecast.cu"
MAX_N = 64          # patterns per series: two rows per lane of a warp
MAX_D = 128         # features per pattern (history + 1)
MAX_STEPS = 256     # Adam steps (the bias corrections ride in the parameters)

_LIB: ctypes.CDLL | None = None


def _library() -> ctypes.CDLL:
    global _LIB
    if _LIB is None:
        lib = ctypes.CDLL(str(nvcc.build(SOURCE).path))
        ptr, i32, f32 = ctypes.c_void_p, ctypes.c_int, ctypes.c_float
        lib.gp_forecast.argtypes = ([ptr] * 7 + [i32] * 7 + [f32] * 2
                                    + [ptr] * 3 + [ptr] + [ptr])
        lib.gp_forecast.restype = i32
        lib.gp_forecast_init.argtypes = []
        lib.gp_forecast_init.restype = i32
        _LIB = lib
    return _LIB


@functools.lru_cache(maxsize=None)
def _host_constants(steps: int):
    """The bias corrections and initial log-params as ctypes float arrays,
    built once per step count."""
    bc1, bc2 = ref.adam_bias_corrections(steps)
    init = torch.log(torch.tensor(ref.GP_INIT, dtype=torch.float32)).tolist()
    arr = ctypes.c_float * max(steps, 1)
    return arr(*bc1), arr(*bc2), (ctypes.c_float * 3)(*init)


def _check(X, y, row_valid, hist, T, horizon, cfg, ready=None):
    """Validate the kernel's inputs; return (B, N, D, kind code)."""
    if cfg.kernel not in ref.KINDS:
        raise ValueError(f"unknown kernel kind: {cfg.kernel!r} "
                         f"(expected one of {ref.KINDS})")
    ts = {"X": X, "y": y, "row_valid": row_valid, "hist": hist}
    for name, t in ts.items():
        if t.device.type != "cuda" or t.device != X.device:
            raise ValueError(f"{name} is on {t.device}; all inputs must be on "
                             f"one CUDA device ({X.device})")
        want = torch.bool if name == "row_valid" else torch.float32
        if t.dtype != want:
            raise TypeError(f"{name} is {t.dtype}; the kernel takes {want}")
        if not t.is_contiguous():
            raise ValueError(f"{name} must be contiguous")
    if X.dim() != 3:
        raise ValueError(f"expected X (B,N,D), got {tuple(X.shape)}")
    B, N, D = X.shape
    if (tuple(y.shape) != (B, N) or tuple(row_valid.shape) != (B, N)
            or tuple(hist.shape) != (B, D - 1)):
        raise ValueError(f"expected y and row_valid ({B}, {N}) and hist ({B}, {D - 1}); "
                         f"got {tuple(y.shape)}, {tuple(row_valid.shape)}, "
                         f"{tuple(hist.shape)}")
    if not (1 <= N <= MAX_N and 2 <= D <= MAX_D):
        raise ValueError(f"N={N} patterns of D={D} features: the kernel takes "
                         f"1 <= N <= {MAX_N} and 2 <= D <= {MAX_D}")
    if not 0 <= cfg.opt_steps <= MAX_STEPS:
        raise ValueError(f"opt_steps={cfg.opt_steps} outside [0, {MAX_STEPS}]")
    if horizon < 1 or T < 1 or B < 1 or B * N * D >= 2**31:
        raise ValueError(f"horizon={horizon}, T={T}, B={B}: out of the kernel's range")
    if ready is not None:
        nvcc.check(X.device, ready=(ready, torch.bool, (B,)))
    return B, N, D, ref.KINDS.index(cfg.kernel)


@nvcc.counted
def gp_fit_forecast(X: torch.Tensor, y: torch.Tensor, row_valid: torch.Tensor,
                    hist: torch.Tensor, T: int, horizon: int, cfg,
                    ready: torch.Tensor | None = None):
    """Launch the kernel: ``(mean, var, log_params)``, ``(B, horizon)``,
    ``(B, horizon)`` and ``(B, 3)``, as ``ref.gp_fit_forecast`` returns.
    ``ready`` (B,) bool on the card: only the series it marks run; the
    others come back zeros."""
    B, N, D, code = _check(X, y, row_valid, hist, T, horizon, cfg, ready)
    lib = _library()
    bc1, bc2, init = _host_constants(cfg.opt_steps)
    mean = torch.empty((B, horizon), dtype=torch.float32, device=X.device)
    var = torch.empty((B, horizon), dtype=torch.float32, device=X.device)
    logp = torch.empty((B, 3), dtype=torch.float32, device=X.device)
    nvcc.prepare(lib.gp_forecast_init, "gp_forecast", X.device)
    nvcc.launch(lib.gp_forecast, "gp_forecast", X.device, X, y, row_valid, hist, mean,
                var, logp, B, N, D, horizon, T, cfg.opt_steps, code, cfg.opt_lr,
                cfg.jitter, bc1, bc2, init, ready)
    nvcc.count(gp_fit_forecast)
    return mean, var, logp


def reset_launch_counts() -> None:
    gp_fit_forecast.launches = 0
