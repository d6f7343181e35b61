"""Variance and quantile helpers shared by the forecasters, the safeguard
and the engine, and the proper scoring metrics of predictive
distributions (counterpart of ``repro/core/uncertainty/scoring.py``):
coverage against the nominal level, pinball loss, Gaussian and
empirical CRPS.
"""
from __future__ import annotations

import math

import numpy as np
import torch

from repro_torch.kernels.ref import fma_f32


def sigma_from_var(var: torch.Tensor) -> torch.Tensor:
    """Predictive standard deviation; the clamp absorbs float32 variances
    that round to tiny negatives without inflating exact zeros.  The root
    is taken in float64 and rounded once, which makes it the correctly
    rounded float32 root that XLA computes (PyTorch's vectorized float32
    root on the CPU is off by an ulp for ~0.6% of inputs)."""
    return torch.sqrt(torch.clamp_min(var, 0.0).double()).to(var.dtype)


def sigma_from_var_np(var: np.ndarray) -> np.ndarray:
    """NumPy twin of :func:`sigma_from_var` for host-side code."""
    return np.sqrt(np.maximum(var, 0.0))


def bucket_pow2(n: int, base: int = 64) -> int:
    """Smallest power-of-two batch bucket >= n (never below ``base``)."""
    b = base
    while b < n:
        b *= 2
    return b


def _fma(a, b, c) -> np.ndarray:
    """``a * b + c`` over float32 arrays, rounded once, as XLA:CPU contracts
    it (``kernels/ref.py::fma_f32``)."""
    a, b, c = (torch.from_numpy(np.array(x, np.float32)) for x in np.broadcast_arrays(a, b, c))
    return fma_f32(a, b, c).numpy()


_F32 = np.float32
_TINY = _F32(2.0**-126)
# Cephes' float32 log, as XLA:CPU emits it (m - 1 on [sqrt(1/2) - 1,
# sqrt(2) - 1], the exponent in two parts)
_LOG_P = (7.0376836292E-2, -1.1514610310E-1, 1.1676998740E-1, -1.2420140846E-1,
          1.4249322787E-1, -1.6668057665E-1, 2.0000714765E-1, -2.4999993993E-1,
          3.3333331174E-1)


def _xla_log(x: np.ndarray) -> np.ndarray:
    """XLA:CPU's float32 natural log (its Cephes polynomial, not correctly
    rounded): the multiply-adds LLVM contracts into fused ones are rounded
    once, the rest as written; subnormal inputs read as zero."""
    x = np.asarray(x, _F32)
    x = np.where(np.abs(x) < _TINY, _F32(0), x)
    bits = np.where(x > _TINY, x, _TINY).view(np.int32)
    m = ((bits & np.int32(-2139095041)) | np.int32(0x3f000000)).view(_F32)
    e = _F32(1) + ((bits >> 23) - 127).astype(_F32)
    low = m < _F32(0.707106781186547524)
    e = e - low.astype(_F32)
    u = (m - _F32(1)) + np.where(low, m, _F32(0))
    u2 = u * u
    u3 = u2 * u
    p = [_F32(c) for c in _LOG_P]
    y = _fma(_fma(u, p[0], p[1]), u, p[2])
    y1 = _fma(_fma(u, p[3], p[4]), u, p[5])
    y2 = _fma(_fma(u, p[6], p[7]), u, p[8])
    y = _fma(_fma(_fma(y, u3, y1), u3, y2), u3, _F32(-2.12194440e-4) * e)
    out = _fma(_F32(0.693359375), e, _fma(_F32(-0.5), u2, u) + y)
    out = np.where(x >= 0, out, _F32(np.nan))
    return np.where(x == 0, _F32(-np.inf), np.where(x == np.inf, _F32(np.inf), out))


# JAX's ndtri (jax/_src/scipy/special.py:_ndtri): Cephes' rational
# approximations, centre (p0, q0), tails (p1, q1) and far tails, z >= 8
# (p2, q2), highest power first
_NDTRI = {
    "p0": (-5.99633501014107895267E1, 9.80010754185999661536E1, -5.66762857469070293439E1,
           1.39312609387279679503E1, -1.23916583867381258016E0),
    "q0": (1.0, 1.95448858338141759834E0, 4.67627912898881538453E0, 8.63602421390890590575E1,
           -2.25462687854119370527E2, 2.00260212380060660359E2, -8.20372256168333339912E1,
           1.59056225126211695515E1, -1.18331621121330003142E0),
    "p1": (4.05544892305962419923E0, 3.15251094599893866154E1, 5.71628192246421288162E1,
           4.40805073893200834700E1, 1.46849561928858024014E1, 2.18663306850790267539E0,
           -1.40256079171354495875E-1, -3.50424626827848203418E-2, -8.57456785154685413611E-4),
    "q1": (1.0, 1.57799883256466749731E1, 4.53907635128879210584E1, 4.13172038254672030440E1,
           1.50425385692907503408E1, 2.50464946208309415979E0, -1.42182922854787788574E-1,
           -3.80806407691578277194E-2, -9.33259480895457427372E-4),
    "p2": (3.23774891776946035970E0, 6.91522889068984211695E0, 3.93881025292474443415E0,
           1.33303460815807542389E0, 2.01485389549179081538E-1, 1.23716634817820021358E-2,
           3.01581553508235416007E-4, 2.65806974686737550832E-6, 6.23974539184983293730E-9),
    "q2": (1.0, 6.02427039364742014255E0, 3.67983563856160859403E0, 1.37702099489081330271E0,
           2.16236993594496635890E-1, 1.34204006088543189037E-2, 3.28014464682127739104E-4,
           2.89247864745380683936E-6, 6.79019408009981274425E-9),
}


def _polyval(name: str, x: np.ndarray) -> np.ndarray:
    """``jnp.polyval``: Horner's steps, each contracted by XLA:CPU into a
    fused multiply-add."""
    y = np.zeros_like(x)
    for c in _NDTRI[name]:
        y = _fma(y, x, _F32(c))
    return y


def ndtri_f32(p) -> np.ndarray:
    """JAX's float32 ``ndtri`` to the bit, as the reference calls it
    eagerly: each operation rounded on its own, except the Horner steps
    of ``jnp.polyval`` and XLA:CPU's log, which are compiled programs
    whose multiply-adds round once; subnormal inputs read as zero."""
    with np.errstate(all="ignore"):
        p = np.asarray(p, _F32)
        p = np.where(np.abs(p) < _TINY, _F32(0), p)
        mcp = np.where(p > _F32(-np.expm1(-2.0)), _F32(1) - p, p)
        s = np.where(mcp == 0, _F32(0.5), mcp)
        w = s - _F32(0.5)
        ww = w * w
        big = (w + (w * ww) * (_polyval("p0", ww) / _polyval("q0", ww))
               ) * -_F32(np.sqrt(2.0 * np.pi))
        z = np.sqrt(_F32(-2.0) * _xla_log(s))
        first = z - _xla_log(z) / z
        iz = _F32(1) / z
        far = first - _polyval("p2", iz) / _polyval("q2", iz) / z
        tail = first - _polyval("p1", iz) / _polyval("q1", iz) / z
        x = np.where(s > _F32(np.exp(-2.0)), big, np.where(z >= _F32(8.0), far, tail))
        x = np.where(p > _F32(1.0 - np.exp(-2.0)), x, -x)
        return np.where(p == 0, _F32(-np.inf), np.where(p == 1, _F32(np.inf), x)
                        ).astype(_F32)


def gaussian_quantile_scale(q) -> torch.Tensor:
    """z such that ``mean + z * sigma`` is the Gaussian q-quantile: the
    reference's float32 value to the bit (:func:`ndtri_f32`)."""
    return torch.from_numpy(np.array(ndtri_f32(q), _F32))


def empirical_coverage(y: torch.Tensor, upper: torch.Tensor,
                       where: torch.Tensor | None = None) -> torch.Tensor:
    """Fraction of outcomes ``y <= upper``; compare against the nominal
    quantile level.  ``where`` masks invalid rows."""
    hit = (y <= upper).float()
    if where is None:
        return hit.mean()
    w = where.float()
    return (hit * w).sum() / torch.clamp_min(w.sum(), 1.0)


def pinball_loss(y: torch.Tensor, pred_q: torch.Tensor, q) -> torch.Tensor:
    """Mean pinball (quantile) loss of predicted q-quantiles: ``u * (q -
    1[u < 0])`` with ``u = y - pred_q``, minimized in expectation by the
    true q-quantile."""
    q = torch.as_tensor(q, dtype=torch.float32, device=y.device)
    u = y - pred_q
    return torch.maximum(q * u, (q - 1.0) * u).mean()


def crps_gaussian(y: torch.Tensor, mean: torch.Tensor, var: torch.Tensor) -> torch.Tensor:
    """Closed-form CRPS of N(mean, var) predictions, averaged over y:
    ``s * (z (2 Phi(z) - 1) + 2 phi(z) - 1/sqrt(pi))``, ``z = (y - m) / s``."""
    sigma = torch.clamp_min(sigma_from_var(var), 1e-9)
    z = (y - mean) / sigma
    phi = torch.exp(-0.5 * z * z) / math.sqrt(2.0 * math.pi)
    cdf = 0.5 * (1.0 + torch.special.erf(z / math.sqrt(2.0)))
    return (sigma * (z * (2.0 * cdf - 1.0) + 2.0 * phi - 1.0 / math.sqrt(math.pi))).mean()


def crps_empirical(y: torch.Tensor, samples: torch.Tensor) -> torch.Tensor:
    """Sample-based CRPS, averaged over y, in the energy form ``E|X - y| -
    0.5 E|X - X'|``; ``samples`` is ``(n,)`` shared by every y or
    ``(batch, n)``."""
    if samples.dim() == 1:
        samples = samples.expand(y.shape[0], samples.shape[0])
    term1 = (samples - y[:, None]).abs().mean(1)
    term2 = (samples[:, :, None] - samples[:, None, :]).abs().mean((1, 2))
    return (term1 - 0.5 * term2).mean()
