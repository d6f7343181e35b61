"""The port's GP forecaster and forecast reductions against the JAX
reference, on windows recorded from a reference simulation."""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forecast import GPForecaster as RefGP
from repro.core.forecast import base as rbase
from repro.core.forecast import gp as rgp
from repro.kernels import ref as jref
from repro.sim import engine as reng
from repro.sim.scenarios.registry import build_trace
from repro_torch.core.forecast import Forecast, GPConfig, GPForecaster, base
from repro_torch.core.forecast import gp as tgp
from repro_torch.kernels import ref as kref
from test_torch_engine import quick_base_config

H = 3          # the engine's horizon
HIST = 10      # the engine's GP history h: rows with h+1 valid points are
               # the first the GP forecasts


def _port_gp(cfg):
    d = dataclasses.asdict(cfg.gp)
    d.pop("impl")
    return GPForecaster(GPConfig(**d))


@pytest.fixture(scope="module")
def recorded():
    """Every (window, valid) batch a reference run forecast, as numpy."""
    cfg = dataclasses.replace(quick_base_config(), forecaster="persist")
    batches = []

    def record(w, v):
        batches.append((w.copy(), v.copy()))
        return w[:, -1], w.var(axis=1, where=v) + 1e-6

    reng.run_sim(cfg, build_trace(cfg.workload), forecast_fn=record)
    W = np.concatenate([w for w, _ in batches])
    V = np.concatenate([v for _, v in batches])
    cfg = dataclasses.replace(cfg, forecaster="gp")
    return cfg, W, V


def _ref_forecast(cfg, W, V):
    fc = jax.jit(lambda w, v: RefGP(cfg.gp).forecast_batch(w, H, valid=v))(W, V)
    return np.asarray(fc.mean), np.asarray(fc.var)


def _assert_close_by_valid_count(W, V, got, want, rows):
    """The parity tolerances, by the number of valid points of a row.

    Rows with >= h+2 valid points: rtol 1e-3 on the mean and 5e-3 on the
    variance.  Rows with exactly h+1 have a single usable pattern row
    (the others carry noise 1e6); there fp32 JAX and fp32 PyTorch are
    each up to a few percent from the float64 answer, so rtol 5e-2.
    A variance below the square of one float32 ulp of the series' level
    is rounding noise (flat windows), hence the per-row atol on it.
    Rows with fewer points take the persistence fallback: equal."""
    (mt, vt), (mj, vj) = got, want
    cnt = V.sum(1)
    level = np.abs(W).max(1, keepdims=True)
    atol_var = (np.finfo(np.float32).eps * level) ** 2
    for sel, rt_m, rt_v in ((cnt >= HIST + 2, 1e-3, 5e-3),
                            (cnt == HIST + 1, 5e-2, 5e-2)):
        s = sel & rows
        assert s.any()
        np.testing.assert_allclose(mt[s], mj[s], rtol=rt_m)
        bad = np.abs(vt[s] - vj[s]) > atol_var[s] + rt_v * np.abs(vj[s])
        assert not bad.any(), (np.flatnonzero(s)[bad.any(1)], vt[s][bad], vj[s][bad])
    few = (cnt <= HIST) & rows
    np.testing.assert_array_equal(mt[few], mj[few])
    np.testing.assert_array_equal(vt[few], vj[few])


def _sq_dists_exact_diagonal(xa, xb):
    """The reference's identity max(|a|^2 + |b|^2 - 2 a.b, 0), with the
    norms and the dot product summed by the same sequential loop, so
    |a|^2 and a.a cancel exactly on the diagonal, as in the port."""
    na = jnp.zeros(xa.shape[:1], xa.dtype)
    nb = jnp.zeros(xb.shape[:1], xb.dtype)
    ab = jnp.zeros((xa.shape[0], xb.shape[0]), xa.dtype)
    for k in range(xa.shape[1]):
        na = na + xa[:, k] * xa[:, k]
        nb = nb + xb[:, k] * xb[:, k]
        ab = ab + xa[:, k, None] * xb[None, :, k]
    return jnp.maximum(na[:, None] + nb[None, :] - 2.0 * ab, 0.0)


def test_forecast_batch_matches_reference_with_exact_diagonal(recorded, monkeypatch):
    """Every recorded row, against the reference with its Gram diagonal
    summed so that it cancels exactly (the one place the port's
    arithmetic is defined differently, see the next test)."""
    cfg, W, V = recorded
    monkeypatch.setattr(jref, "sq_dists", _sq_dists_exact_diagonal)
    want = _ref_forecast(cfg, W, V)
    fc = _port_gp(cfg).forecast_batch(W, H, valid=V, device="cpu")
    _assert_close_by_valid_count(W, V, (fc.mean.numpy(), fc.var.numpy()), want,
                                 np.ones(len(W), bool))


def test_forecast_batch_matches_reference_where_its_diagonal_is_exact(recorded):
    """Against the unmodified reference.  On the CPU the reference sums
    |a|^2 and the dot product a.b in different orders, so for most
    series its Gram diagonal holds rounding noise (r_ii up to ~1e-3
    instead of 0, and far more for near-flat windows); the port's, like
    the exact form, does not.  Where the reference's diagonal is exact
    the two agree within those tolerances; elsewhere about 2% of
    rows move beyond them (ROADMAP queue 3)."""
    cfg, W, V = recorded
    mt, vt = (t.numpy() for t in dataclasses.astuple(
        _port_gp(cfg).forecast_batch(W, H, valid=V, device="cpu")))
    want = _ref_forecast(cfg, W, V)

    def diag_d2(w, v):
        z, _, _ = rgp._standardize(w, v)
        X, _, _ = rgp.build_patterns(z, HIST, cfg.gp.max_patterns)
        return jnp.diagonal(jref.sq_dists(X, X)).max()

    exact = np.asarray(jax.jit(jax.vmap(diag_d2))(W, V)) == 0
    assert exact.sum() >= 100
    _assert_close_by_valid_count(W, V, (mt, vt), want, exact)


def test_row_results_do_not_depend_on_batch(recorded):
    cfg, W, V = recorded
    gp = _port_gp(cfg)
    full = gp.forecast_batch(W[:512], H, valid=V[:512], device="cpu")
    for i in (0, 7, 300, 511):
        one = gp.forecast_batch(W[i:i + 1], H, valid=V[i:i + 1], device="cpu")
        assert torch.equal(one.mean[0], full.mean[i])
        assert torch.equal(one.var[0], full.var[i])


def test_non_pd_evidence_step_stays_finite():
    """A Gram matrix that is not positive definite: the reference's
    Cholesky returns NaN and its zeroed gradient leaves the parameters
    where they were; torch.linalg.cholesky would raise instead."""
    rng = np.random.default_rng(0)
    X = rng.standard_normal((2, 10, 11)).astype(np.float32)
    y = rng.standard_normal((2, 10)).astype(np.float32)
    valid = np.ones((2, 10), bool)
    cfg = GPConfig(opt_steps=3, jitter=-5.0)        # noise < 0: not PD
    lp = torch.log(torch.tensor([[1.0, 1.0, 0.3]] * 2))
    assert torch.isnan(kref.gp_neg_log_marginal(lp, torch.as_tensor(X), torch.as_tensor(y),
                                             torch.as_tensor(valid), cfg)).all()
    p = kref.gp_optimize_evidence(torch.as_tensor(X), torch.as_tensor(y),
                               torch.as_tensor(valid), cfg)
    assert torch.isfinite(p).all()
    rcfg = rgp.GPConfig(opt_steps=3, jitter=-5.0)
    want = np.stack([np.asarray(rgp._optimize_evidence(X[i], y[i], valid[i], rcfg))
                     for i in range(2)])
    np.testing.assert_allclose(p.numpy(), want, rtol=1e-6)
    L = kref.cholesky_nan(torch.as_tensor(-np.eye(3, dtype=np.float32))[None])
    assert torch.isnan(L).all()


def test_non_pd_row_leaves_other_rows_alone(recorded):
    cfg, W, V = recorded
    gp = _port_gp(cfg)
    rows = W[:8].copy()
    rows[3] = np.float32(1e30)         # overflowing patterns: NaN Gram, NaN factor
    mixed = gp.forecast_batch(rows, H, valid=V[:8], device="cpu")
    clean = gp.forecast_batch(W[:8], H, valid=V[:8], device="cpu")
    keep = [i for i in range(8) if i != 3]
    assert torch.equal(mixed.mean[keep], clean.mean[keep])
    assert torch.equal(mixed.var[keep], clean.var[keep])


def test_peak_over_horizon_and_persistence_match_reference():
    rng = np.random.default_rng(2)
    mean = rng.integers(0, 3, (64, H)).astype(np.float32)    # many ties
    var = rng.uniform(0, 1, (64, H)).astype(np.float32)
    got = base.peak_over_horizon(Forecast(torch.as_tensor(mean), torch.as_tensor(var)))
    want = rbase.peak_over_horizon(rbase.Forecast(jnp.asarray(mean), jnp.asarray(var)))
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.numpy(), np.asarray(w))
    w = rng.uniform(0, 4, (64, 24)).astype(np.float32)
    v = rng.uniform(0, 1, (64, 24)) < 0.7
    got = base.persistence_peak(torch.as_tensor(w), torch.as_tensor(v))
    want = rbase.persistence_peak(jnp.asarray(w), jnp.asarray(v))
    for g, r in zip(got, want):
        np.testing.assert_allclose(g.numpy(), np.asarray(r), rtol=1e-6)


def test_forecast_batch_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        GPForecaster().forecast_batch(np.zeros((2, 24), np.float32), H)


@pytest.mark.parametrize("kind", ["exp", "rbf"])
def test_plain_gp_program_fits_the_reference_parameters(recorded, kind, monkeypatch):
    """The fitted log (ell, sf, sn) that ref.gp_fit_forecast returns,
    against the reference's _optimize_evidence on the same patterns (its
    Gram diagonal summed exactly, as in the first test), on every
    recorded window.  The forecasts alone can hide a parameter that went
    astray; fp32 Adam over 10 steps keeps the two within 1e-4 here
    (largest difference seen 4.5e-5)."""
    cfg, W, V = recorded
    monkeypatch.setattr(jref, "sq_dists", _sq_dists_exact_diagonal)
    pcfg = dataclasses.replace(_port_gp(cfg).cfg, kernel=kind)
    rcfg = dataclasses.replace(cfg.gp, kernel=kind)
    X, y, rv, hist, _, _ = tgp.fit_inputs(torch.as_tensor(W), torch.as_tensor(V), pcfg)
    got = kref.gp_fit_forecast(X, y, rv, hist, W.shape[1], H, pcfg)[2]
    want = jax.jit(jax.vmap(lambda a, b, c: rgp._optimize_evidence(a, b, c, rcfg)))(
        X.numpy(), y.numpy(), rv.numpy())
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5, atol=1e-4)
