"""The GP past the fused program's limits: ``GPForecaster`` takes the
Gram route (``core/forecast/gp.py::gram_fit_forecast``) wherever the
fused GP program cannot (more than ``gp_forecast.MAX_N`` patterns, more
than ``MAX_D`` features or ``MAX_STEPS`` Adam steps), on the CPU as on
the card.  Held against the JAX reference's ``GPForecaster`` and
``_optimize_evidence`` at N = 72 and N = 128 patterns, against itself
under a ready mask and in other batches, and inside both port engines
against the reference's engines with the port's forecasts shared.

Inputs are made with numpy from a seed.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forecast import GPForecaster as RefGP
from repro.core.forecast import gp as rgp
from repro.core.forecast.base import Forecast as RForecast
from repro.kernels import ref as jref
from repro.sim import engine as reng
from repro.sim import step as rstep
from repro_torch.core.forecast import GPConfig, GPForecaster
from repro_torch.core.forecast import gp as tgp
from repro_torch.kernels import gp_forecast, gp_gram
from repro_torch.kernels import ops as kops
from repro_torch.kernels import ref as kref
from repro_torch.sim import engine as tengine
from repro_torch.sim import step as tstep
from repro_torch.sim.engine import forecast_peaks
from test_torch_flash_route import CudaStandIn
from test_torch_forecast import _sq_dists_exact_diagonal
from test_torch_step import _assert_summary, _port_inputs
from test_torch_step import SMALL

H = 3   # the engines' horizon
# (history h, patterns N, window T): the repo's examples' small h with N
# past the fused program's 64, and the paper's largest h = 40 with N = 128
# (one of the TPU kernel's 128 x 128 tiles) in the shortest window that
# holds it
LONG = {"h4_n72": (4, 72, 80), "h40_n128": (40, 128, 168)}


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _windows(b, T, h, seed):
    """Usage-like windows with h-1 .. T valid samples (every valid-count
    class of the tolerances: persistence, one pattern row, more)."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(0.5, 4.0, (b, 1))
    w = level * (1 + 0.05 * np.cumsum(rng.standard_normal((b, T)), 1))
    count = rng.integers(h - 1, T + 1, b)
    count[:3] = (h, h + 1, T)
    v = np.arange(T)[None, :] >= (T - count)[:, None]
    return np.where(v, np.clip(w, 0.0, None), 0).astype(np.float32), v


def _cfgs(name, kind, opt_steps=10):
    h, n, _ = LONG[name]
    return (GPConfig(history=h, max_patterns=n, kernel=kind, opt_steps=opt_steps),
            rgp.GPConfig(history=h, max_patterns=n, kernel=kind, opt_steps=opt_steps))


def _assert_close_by_valid_count(h, v, got, want):
    """tests/test_torch_forecast.py's tolerances, for history h: rows with
    >= h+2 valid points rtol 1e-3 (mean) and 5e-3 (variance); exactly h+1
    (one usable pattern row) 5e-2; fewer, the persistence fallback, equal."""
    (mt, vt), (mj, vj) = got, want
    cnt = v.sum(1)
    for sel, rt_m, rt_v in ((cnt >= h + 2, 1e-3, 5e-3), (cnt == h + 1, 5e-2, 5e-2)):
        assert sel.any()
        np.testing.assert_allclose(mt[sel], mj[sel], rtol=rt_m)
        np.testing.assert_allclose(vt[sel], vj[sel], rtol=rt_v)
    few = cnt <= h
    assert few.any()
    np.testing.assert_array_equal(mt[few], mj[few])
    np.testing.assert_array_equal(vt[few], vj[few])


# ----------------------------------------------------------------------
# the route's choice
# ----------------------------------------------------------------------

@pytest.mark.parametrize("h,n,steps,fused", [
    (10, 64, 2, True), (127, 10, 2, True), (4, 10, 256, True),
    (10, 65, 2, False), (128, 10, 2, False), (4, 10, 257, False),
])
def test_route_is_chosen_from_the_config_and_shapes(monkeypatch, h, n, steps, fused):
    """N = 64 patterns, D = 128 features and 256 Adam steps take the fused
    program; N = 65, D = 129 and 257 steps the Gram route (its callees
    monkeypatched, as test_torch_gp_fused.py's
    test_ops_dispatch_runs_the_plain_program_on_the_cpu holds the fused
    path)."""
    called = []
    monkeypatch.setattr(kops, "gp_fit_forecast",
                        lambda *a: called.append("fused") or kref.gp_fit_forecast(*a))
    route = tgp.gram_fit_forecast
    monkeypatch.setattr(tgp, "gram_fit_forecast",
                        lambda *a: called.append("gram") or route(*a))
    cfg = GPConfig(history=h, max_patterns=n, opt_steps=steps)
    assert tgp.fused_takes(cfg, n, h + 1) == fused
    w = np.random.default_rng(1).uniform(0.5, 2.0, (2, h + n)).astype(np.float32)
    fc = GPForecaster(cfg).forecast_batch(w, H, device="cpu")
    assert called == ["fused" if fused else "gram"]
    assert torch.isfinite(fc.mean).all()


def test_gram_route_calls_the_gram_pair_and_never_the_fused_program(monkeypatch):
    """Through kops.gram and kops.gram_bwd (opt_steps + 1 + horizon and
    opt_steps calls), never kops.gp_fit_forecast; and the Gram kernels'
    checks take the route's shapes on CUDA stand-ins (the device engine's
    K(X, X) and a horizon step's cross-Gram), which the fused program's
    refuses."""
    calls = {"gram": 0, "gram_bwd": 0}

    def counted(name, fn):
        def call(*a, **k):
            calls[name] += 1
            return fn(*a, **k)
        return call

    monkeypatch.setattr(kops, "gram", counted("gram", kops.gram))
    monkeypatch.setattr(kops, "gram_bwd", counted("gram_bwd", kops.gram_bwd))
    monkeypatch.setattr(kops, "gp_fit_forecast", lambda *a: pytest.fail("fused program called"))
    cfg, _ = _cfgs("h4_n72", "exp", opt_steps=3)
    w, v = _windows(4, 80, 4, seed=2)
    fc = GPForecaster(cfg).forecast_batch(w, H, valid=v, device="cpu")
    assert calls == {"gram": 3 + 1 + H, "gram_bwd": 3}
    assert torch.isfinite(fc.mean).all()
    f32 = torch.float32
    X = CudaStandIn((3072, 128, 41), f32)
    p = CudaStandIn((3072,), f32)
    assert gp_gram._check(X, X, p, p, "exp") == (3072, 128, 128, 41, 0)
    assert gp_gram._check(CudaStandIn((3072, 1, 41), f32), X, p, p, "rbf") == \
        (3072, 1, 128, 41, 1)
    with pytest.raises(ValueError, match="N=128"):
        gp_forecast._check(X, CudaStandIn((3072, 128), f32),
                           CudaStandIn((3072, 128), torch.bool), CudaStandIn((3072, 40), f32),
                           168, H, GPConfig(history=40, max_patterns=128))


# ----------------------------------------------------------------------
# against the reference
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def reference_fits():
    """The reference's jitted forecast_batch and _optimize_evidence (its
    Gram diagonal summed exactly, as test_torch_forecast.py's stand-in
    does), one compile per (config, kind)."""
    cache = {}

    def get(name, kind, W, V):
        if (name, kind) not in cache:
            _, rcfg = _cfgs(name, kind)
            with pytest.MonkeyPatch.context() as mp:
                mp.setattr(jref, "sq_dists", _sq_dists_exact_diagonal)
                fc = jax.jit(lambda w, v: RefGP(rcfg).forecast_batch(w, H, valid=v))(W, V)
                h, n, T = LONG[name]
                z, _, _ = jax.vmap(rgp._standardize)(jnp.asarray(W), jnp.asarray(V))
                X, y = jax.vmap(lambda r: rgp.build_patterns(r, h, n)[:2])(z)
                tgt = np.arange(T - X.shape[1], T)
                rv = V[:, tgt[:, None] + np.arange(-h, 1)].all(2)
                lp = jax.jit(jax.vmap(lambda a, b, c: rgp._optimize_evidence(a, b, c, rcfg)))(
                    X, y, rv)
            cache[name, kind] = (np.asarray(fc.mean), np.asarray(fc.var), np.asarray(lp))
        return cache[name, kind]
    return get


@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("name", sorted(LONG))
def test_gram_route_matches_reference(reference_fits, name, kind):
    h, n, T = LONG[name]
    W, V = _windows(16, T, h, seed=n)
    want_m, want_v, _ = reference_fits(name, kind, W, V)
    cfg, _ = _cfgs(name, kind)
    fc = GPForecaster(cfg).forecast_batch(W, H, valid=V, device="cpu")
    _assert_close_by_valid_count(h, V, (fc.mean.numpy(), fc.var.numpy()), (want_m, want_v))


@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("name", sorted(LONG))
def test_gram_route_fits_the_reference_parameters(reference_fits, name, kind):
    """The fitted log (ell, sf, sn) of the route's Adam loop against the
    reference's _optimize_evidence on the same patterns.  The route's
    gradient is the closed form, the reference's reverse mode through its
    Cholesky factor; at h = 4 (patterns of 5 features, many close to one
    another, so K is ill-conditioned) the float32 Adam steps carry that
    rounding to 7.9e-4 (exp; largest seen), at h = 40 to 1e-5, hence atol
    2e-3.  The forecasts are held to the usual tolerances above."""
    h, n, T = LONG[name]
    W, V = _windows(16, T, h, seed=n)
    _, _, want = reference_fits(name, kind, W, V)
    cfg, _ = _cfgs(name, kind)
    X, y, rv, _, _, _ = tgp.fit_inputs(torch.as_tensor(W), torch.as_tensor(V), cfg)
    got = tgp._optimize_evidence(X, y, rv, cfg)
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-5, atol=2e-3)


# ----------------------------------------------------------------------
# rows alone
# ----------------------------------------------------------------------

def test_ready_mask_and_batch_leave_a_row_alone():
    """Under a ready mask the unmarked rows are zeros and the marked rows
    equal the unmasked batch bit for bit; a row alone (padded to the
    route's least batch) equals the same row in a batch of 32."""
    cfg, _ = _cfgs("h4_n72", "exp", opt_steps=3)
    w, v = _windows(32, 80, 4, seed=5)
    X, y, rv, hist, _, _ = tgp.fit_inputs(torch.as_tensor(w), torch.as_tensor(v), cfg)
    full = tgp.gram_fit_forecast(X, y, rv, hist, 80, H, cfg)
    ready = torch.as_tensor(np.random.default_rng(6).random(32) < 0.4)
    got = tgp.gram_fit_forecast(X, y, rv, hist, 80, H, cfg, ready)
    for g, f in zip(got, full):
        assert torch.equal(g[ready], f[ready]) and not g[~ready].any()
    gp = GPForecaster(cfg)
    fc = gp.forecast_batch(w, H, valid=v, device="cpu")
    for i in (0, 17, 31):
        one = gp.forecast_batch(w[i:i + 1], H, valid=v[i:i + 1], device="cpu")
        assert torch.equal(one.mean[0], fc.mean[i]) and torch.equal(one.var[0], fc.var[i])


def test_failed_factor_stays_nan_in_its_row_alone():
    cfg, _ = _cfgs("h4_n72", "rbf", opt_steps=3)
    w, v = _windows(8, 80, 4, seed=7)
    v[:] = True
    X, y, rv, hist, _, _ = tgp.fit_inputs(torch.as_tensor(w), torch.as_tensor(v), cfg)
    clean = tgp.gram_fit_forecast(X, y, rv, hist, 80, H, cfg)
    X = X.clone()
    X[3, 10, 2] = float("nan")          # a NaN Gram row: no factor
    got = tgp.gram_fit_forecast(X, y, rv, hist, 80, H, cfg)
    assert torch.isnan(got[0][3]).all() and torch.isnan(got[1][3]).all()
    keep = [i for i in range(8) if i != 3]
    for g, c in zip(got, clean):
        assert torch.equal(g[keep], c[keep])


# ----------------------------------------------------------------------
# both engines
# ----------------------------------------------------------------------

# the engines at a long-pattern GP: N = 72 patterns of h = 4 in windows of
# 80, two Adam steps; SMALL's workload on 12 app slots of 4 components (96
# monitor rows, which the device engine forecasts every tick)
LONG_SMALL = dataclasses.replace(
    SMALL, forecaster="gp", window=80, max_ticks=40,
    cluster=dataclasses.replace(SMALL.cluster, max_running_apps=12),
    workload=dataclasses.replace(SMALL.workload, max_components=4),
    gp=rgp.GPConfig(history=4, max_patterns=72, opt_steps=2))


def _port_model(pcfg):
    return GPForecaster(GPConfig(**{k: v for k, v in dataclasses.asdict(pcfg.gp).items()}))


class _PortGPForReference:
    """The port's GP (its Gram route, on the CPU) as the reference's scan
    engine's forecast model, through a callback."""

    def __init__(self, model):
        self.model = model

    def forecast_batch(self, w, horizon, valid=None):
        shape = jax.ShapeDtypeStruct((w.shape[0], horizon), jnp.float32)

        def run(a, b):
            fc = self.model.forecast_batch(np.array(a), horizon, valid=np.array(b),
                                           device="cpu")
            return fc.mean.numpy(), fc.var.numpy()
        mean, var = jax.pure_callback(run, (shape, shape), w, valid)
        return RForecast(mean=mean, var=var)


def test_host_engine_takes_the_gram_route_as_the_reference_engine_would():
    """The port's host engine with its own GP (the Gram route) against the
    reference's host engine given the same forecasts: equal runs."""
    pcfg, ptr, tr = _port_inputs(LONG_SMALL)
    assert not tgp.fused_takes(pcfg.gp, 72, 5)
    model = _port_model(pcfg)

    def shared(windows, valid):
        return forecast_peaks(model, LONG_SMALL.horizon, windows, valid, torch.device("cpu"))

    want = reng.run_sim(LONG_SMALL, tr, forecast_fn=shared).summary()
    got = tengine.run_sim(pcfg, ptr, device="cpu").summary()
    assert got == want
    assert want["completed"] > 0


def test_device_engine_takes_the_gram_route_as_the_reference_engine_would(monkeypatch):
    """The port's device engine with its own GP (the Gram route over the
    whole batch and a ready mask) against the reference's scan engine
    whose model is the port's GP (over its bucketed ready rows)."""
    pcfg, ptr, wl = _port_inputs(LONG_SMALL)
    monkeypatch.setattr(rstep, "_CHUNK_CACHE", {})
    monkeypatch.setattr(rstep, "_make_model", lambda c: _PortGPForReference(_port_model(pcfg)))
    want = rstep.run_sim_scan(LONG_SMALL, wl)
    got = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    _assert_summary(got.summary(), want.summary())
    assert got.forecast_rows == want.forecast_rows
