"""Conformal calibration in the port (``repro_torch.core.uncertainty``,
both engines' calibrated paths, ``ops.calib_observe``,
``ops.conformal_scale``, ``ops.calib_scales`` and leap's calibration
guard) against the reference's (``repro.core.uncertainty``) on the CPU.

Everything the port computes here is held bit for bit: the quantiles
(an exact element of each ring), the controller (the same float64
arithmetic), the host calibrator (a numpy copy), one device-engine step
from a converted reference state, and whole runs' calibration blocks.
The one tolerance is the per-tick metric sums, as in
``tests/test_torch_step.py`` (the port sums them in float64), and the
CRPS forms (float32 transcendental functions, rtol 1e-5).  Sizes are
small: ``quick_base_config(n_apps=32, n_hosts=2)`` and the reference's
gap-dominated leap cell.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import control as rctl
from repro.core import uncertainty as runc
from repro.core.forecast.base import Forecast as RForecast
from repro.core.shaper.safeguard import shaped_demand_scaled_raw
from repro.sim import engine as reng
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro.sim.scenarios.registry import build_trace
from repro_torch import control as tctl
from repro_torch import convert
from repro_torch.core import uncertainty as tunc
from repro_torch.core.forecast import Forecast as TForecast
from repro_torch.core.shaper import shaped_demand_scaled
from repro_torch.kernels import calib as kcalib
from repro_torch.kernels import ops, ref
from repro_torch.sim import engine as tengine
from repro_torch.sim import step as tstep
from chip_smoke import CALIB_CRAFTED, CALIB_CRAFTED_CFG, calib_crafted, crafted_rings
from test_torch_engine import quick_base_config
from test_torch_leap import GAP, _skip_states
from test_torch_step import (_JaxClient, _one_torch_thread, _shared_client,  # noqa: F401
                             _TorchClient)

BASE = quick_base_config(n_apps=32, n_hosts=2)


def _step_splits(budget):
    """(gamma, q): at an error rate of 1, ``q + gamma * (1 - budget)``
    rounds once to another float32 than rounded twice.  For a fixed
    product the two differ only where its rounded value falls on a tie
    of q's grid, so gamma steps up from 0.05 until it does."""
    d = np.float32(1.0) - np.float32(budget)
    qs = np.linspace(0.6, 0.9, 64, dtype=np.float32)
    g = np.float32(0.05)
    for _ in range(1024):
        once = ref.fma_f32(torch.full((qs.size,), float(d)), g, torch.from_numpy(qs)).numpy()
        hit = np.nonzero(once != (np.float32(g * d) + qs).astype(np.float32))[0]
        if hit.size:
            return float(g), qs[hit[0]], once[hit[0]]
        g = np.nextafter(g, np.float32(1.0))
    raise AssertionError("no gamma found")



GAMMA, Q_SPLIT, Q_NEXT = _step_splits(0.1)
# "conformal" at the reference's defaults; "adaptive" with small rings,
# so that series warm up, rings and the pool wrap, and a tick can
# resolve more scores than the pool holds, and a step size whose
# rounding shows (test_observe_rounds_as_the_fused_tick_contracts)
MODES = {
    "conformal": runc.CalibrationConfig(enabled=True, q=0.9),
    "adaptive": runc.CalibrationConfig(enabled=True, q=0.9, adaptive=True, budget=0.1,
                                       gamma=GAMMA, capacity=8, min_scores=4,
                                       pool_capacity=32),
}
COUNTERS = ("completed", "n_apps", "failure_events", "oom_kills", "full_preemptions",
            "partial_preemptions", "failed_frac", "sim_hours")


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _tcfg(rcfg):
    return tunc.CalibrationConfig(**dataclasses.asdict(rcfg))


def _columns(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr) if f.name != "cfg"}


def _port(cfg, family="google"):
    wl = build_trace(cfg.workload)
    return (convert.sim_config_from_dict(dataclasses.asdict(cfg), workload=family),
            convert.trace_from_arrays(**_columns(wl)), wl)


def _calibrated(mode, **over):
    return dataclasses.replace(BASE, forecaster="persist", calibration=MODES[mode], **over)


def _assert_equal(got, want, *, exact: bool):
    """Summaries equal (the host engines') or outcomes equal and the
    metric means within rtol 1e-6 (the device engines'), and the
    calibration blocks equal."""
    g, w = got.summary(), want.summary()
    assert g.pop("calibration") == w.pop("calibration")
    if exact:
        assert g == w
        return
    for k in COUNTERS:
        assert g[k] == w[k], (k, g[k], w[k])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    assert got.n_running == want.n_running and got.turnaround == want.turnaround


# ----------------------------------------------------------------------
# the quantile: ops.conformal_scale against the reference's sort
# ----------------------------------------------------------------------

# tie-prone values: signed zeros, equal values, infinities and NaN
_TIES = np.array([-1.5, -0.0, 0.0, 0.0, 0.25, 0.25, 2.0, np.inf, -np.inf, np.nan],
                 np.float32)


def _rings(seed, B=64, cap=16, circular=False):
    """Rings of counts 0, young, exactly cap and wrapped, with seeded
    scores, a quarter of the rows drawn from the tie-prone values; a
    circular ring holds +inf in its unwritten cells."""
    rng = np.random.default_rng(seed)
    counts = rng.choice([0, 1, 3, cap - 1, cap, cap + 5, 3 * cap], B).astype(np.int32)
    scores = rng.normal(0, 2, (B, cap)).astype(np.float32)
    ties = rng.random(B) < 0.25
    scores[ties] = rng.choice(_TIES, (int(ties.sum()), cap))
    if circular:
        unwritten = np.arange(cap)[None, :] >= counts[:, None]
        scores[unwritten] = np.inf
    return scores, counts


@pytest.mark.parametrize("circular", [False, True], ids=["rolled", "circular"])
def test_conformal_scale_equals_reference(circular):
    """Per-row and scalar q, per-row fallback, capacities 16 and 128."""
    for seed, cap in ((0, 16), (1, 128)):
        scores, counts = _rings(seed, cap=cap, circular=circular)
        rng = np.random.default_rng(seed + 10)
        q = rng.uniform(0.05, 1.0, scores.shape[0]).astype(np.float32)
        fb = rng.normal(0, 1, scores.shape[0]).astype(np.float32)
        rfn = runc.conformal_scale_ring if circular else runc.conformal_scale
        tfn = tunc.conformal_scale_ring if circular else tunc.conformal_scale
        for qq in (q, np.float32(0.9)):
            want = np.asarray(jax.jit(rfn)(scores, counts, qq, fb))
            got = tfn(torch.from_numpy(scores), torch.from_numpy(counts), qq, fb)
            np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.parametrize("circular", [False, True], ids=["rolled", "circular"])
@pytest.mark.parametrize("cap,rows", [(16, 64), (128, 64), (1024, 5), (2048, 5)],
                         ids=["cap16", "cap128", "cap1024", "cap2048"])
def test_conformal_scale_crafted_rings_equal_reference(cap, rows, circular):
    """chip_smoke.py's crafted rings (tests/test_torch_kernels_hopper.py holds
    the kernel to the plain version on them on the card): ties, -0 beside
    +0, NaNs of four payloads and infinities, counts from 0 past the
    capacity, a q per row with k at 0 and at n - 1; every result's bits."""
    scores, counts, q = crafted_rings(cap + circular, rows, cap, circular=circular)
    rfn = runc.conformal_scale_ring if circular else runc.conformal_scale
    tfn = tunc.conformal_scale_ring if circular else tunc.conformal_scale
    want = np.asarray(jax.jit(rfn)(scores, counts, q, -q))
    got = tfn(torch.from_numpy(scores), torch.from_numpy(counts), q, -q)
    np.testing.assert_array_equal(_bits(got), _bits(want))


def test_conformal_scale_takes_q_per_group_of_rows():
    scores, counts = _rings(2, B=12)
    q = np.array([0.3, 0.9, 0.5], np.float32)
    fb = np.array([1.0, 2.0, 3.0], np.float32)
    got = ops.conformal_scale(*map(torch.from_numpy, (scores, counts, q, fb)), rolled=True)
    want = ref.conformal_scale(*map(torch.from_numpy, (scores, counts, np.repeat(q, 4),
                                                       np.repeat(fb, 4))), rolled=True)
    np.testing.assert_array_equal(_bits(got), _bits(want))


# ----------------------------------------------------------------------
# host-side pieces: ScoreBuffer, QuantileController, ConformalForecaster,
# scoring, OnlineCalibrator
# ----------------------------------------------------------------------

def test_score_buffer_equals_reference():
    rng = np.random.default_rng(3)
    r, t = runc.ScoreBuffer(10, 6), tunc.ScoreBuffer(10, 6, device="cpu")
    for _ in range(12):
        rows = rng.choice(10, rng.integers(1, 6), replace=False)
        s = rng.choice(_TIES[:7], rows.size).astype(np.float32)
        many = rng.normal(0, 1, rng.integers(0, 9)).astype(np.float32)
        row = int(rng.integers(0, 10))
        for buf in (r, t):
            buf.push(rows, s)
            buf.push_many(row, many)
    np.testing.assert_array_equal(t.buf, r.buf)
    np.testing.assert_array_equal(t.count, r.count)
    rows = np.array([0, 3, 3, 9, 5])
    q = np.array([0.5, 0.9, 0.1, 0.99, 0.7], np.float32)
    want = r.scales(rows, q, 2.5)
    got = t.scales(rows, q, 2.5)
    np.testing.assert_array_equal(_bits(got), _bits(want))
    got[0] = 0.0                                   # writable, as the reference's


def test_quantile_controller_equals_reference():
    rng = np.random.default_rng(4)
    cfg = runc.CalibrationConfig(q=0.97, adaptive=True, gamma=0.2, q_max=0.99)
    r, t = runc.QuantileController(cfg), tunc.QuantileController(_tcfg(cfg))
    for _ in range(60):
        err = rng.random(rng.integers(0, 20)) < rng.uniform(0, 0.5)
        assert t.update(err) == r.update(err)
    assert (t.q, t.steps, t.errors, t.resolved, t.miscoverage) == (
        r.q, r.steps, r.errors, r.resolved, r.miscoverage)


def _base_forecast(window, horizon):
    """A deterministic forecast in numpy: the window's last value and its
    variance, the same numbers for both packages."""
    w = np.asarray(window, np.float32)
    return np.full(horizon, w[-1], np.float32), np.full(horizon, w.var(), np.float32)


class _RBase:
    def forecast(self, window, horizon, *, valid=None):
        mean, var = _base_forecast(window, horizon)
        return RForecast(mean=jnp.asarray(mean), var=jnp.asarray(var))


class _TBase:
    def forecast(self, window, horizon, *, valid=None):
        mean, var = _base_forecast(window, horizon)
        return TForecast(mean=torch.from_numpy(mean), var=torch.from_numpy(var))


def test_gaussian_quantile_scale_equals_reference_bits():
    """JAX's float32 ndtri to the bit on a grid of q: both branches of its
    rational approximations (the centre and the tails), both tails, z >= 8
    (q below ~1e-15), subnormal q (read as 0), 0, 1, out of range and
    NaN, as arrays and as eager scalar calls."""
    from repro.core.uncertainty import scoring as rsc
    from repro_torch.core.uncertainty import scoring as tsc
    g = np.random.default_rng(0)
    q = np.concatenate([
        np.linspace(0, 1, 4001), g.uniform(0, 1, 4000),
        10.0 ** g.uniform(-45, -0.1, 4000), 1 - 10.0 ** g.uniform(-7.5, -0.1, 2000),
        [np.exp(-2.0), 1 - np.exp(-2.0), 1e-15, 1e-30, 2e-39, 0.9, 0.1, 0.5, -0.0, -0.5,
         1.5, np.nan]]).astype(np.float32)
    def bits(x):     # NaN as one pattern: the payloads differ
        x = np.asarray(x, np.float32)
        return np.where(np.isnan(x), np.float32(np.nan), x).view(np.int32)

    got = tsc.gaussian_quantile_scale(q).numpy()
    want = np.asarray(rsc.gaussian_quantile_scale(q))
    np.testing.assert_array_equal(bits(got), bits(want))
    assert np.isnan(got).sum() == 3
    z = np.abs(got[np.isfinite(got)])
    assert z.max() > 8 and (z < 1).any() and (got < 0).any() and (got > 0).any()
    for x in q[::97]:
        assert bits(tsc.gaussian_quantile_scale(x)) == bits(rsc.gaussian_quantile_scale(float(x)))
    assert float(tsc.gaussian_quantile_scale(0.9)) == float(rsc.gaussian_quantile_scale(0.9))


def test_conformal_forecaster_equals_reference():
    rng = np.random.default_rng(5)
    cfg = runc.CalibrationConfig(capacity=16, min_scores=4)
    r = runc.ConformalForecaster(_RBase(), cfg, n_series=3)
    t = tunc.ConformalForecaster(_TBase(), _tcfg(cfg), n_series=3, device="cpu")
    y = np.cumsum(rng.standard_t(3, (3, 40)), 1).astype(np.float32)
    for k in range(8, 40):
        for i in range(3):
            rf = r.forecast(y[i, k - 8:k], 3, series=i)
            tf = t.forecast(y[i, k - 8:k], 3, series=i)
            # the calibrated scale, or the Gaussian z before min_scores
            assert t.scale(series=i) == r.scale(series=i)
            np.testing.assert_allclose(t.upper(tf, series=i).numpy(),
                                       np.asarray(r.upper(rf, series=i)), rtol=1e-6)
            assert t.observe(float(y[i, k]), series=i) == r.observe(float(y[i, k]), series=i)
    assert t.observe(0.0, series=0) is None
    np.testing.assert_array_equal(t.scores.buf, r.scores.buf)


def test_scoring_equals_reference():
    rng = np.random.default_rng(6)
    y = rng.normal(0, 1, 500).astype(np.float32)
    upper = rng.normal(0.5, 1, 500).astype(np.float32)
    mean = rng.normal(0, 0.5, 500).astype(np.float32)
    var = rng.uniform(-1e-3, 2, 500).astype(np.float32)
    where = rng.random(500) < 0.7
    samples = rng.normal(0, 1, (500, 9)).astype(np.float32)
    T = torch.from_numpy
    assert float(tunc.empirical_coverage(T(y), T(upper))) == float(
        runc.empirical_coverage(y, upper))
    assert float(tunc.empirical_coverage(T(y), T(upper), T(where))) == float(
        runc.empirical_coverage(y, upper, where))
    np.testing.assert_allclose(float(tunc.pinball_loss(T(y), T(upper), 0.9)),
                               float(runc.pinball_loss(y, upper, 0.9)), rtol=1e-6)
    np.testing.assert_allclose(float(tunc.crps_gaussian(T(y), T(mean), T(var))),
                               float(runc.crps_gaussian(y, mean, var)), rtol=1e-5)
    for s in (samples, samples[0]):
        np.testing.assert_allclose(float(tunc.crps_empirical(T(y), T(s))),
                                   float(runc.crps_empirical(y, s)), rtol=1e-5)


def _calibrator_stream(pkg, cfg, n_groups, seed=7, M=24, ticks=60):
    """A seeded stream through ``pkg.OnlineCalibrator``: monitor counts
    that grow and reset, usage, deployed rows and their groups.  Returns
    every tick's scales and the reports."""
    rng = np.random.default_rng(seed)
    kw = {} if pkg is runc else {"device": "cpu"}
    cal = pkg.OnlineCalibrator(2 * M, horizon=3, fallback=3.0, cfg=cfg, n_groups=n_groups,
                               **kw)
    mon = np.zeros(M, np.int64)
    scales = []
    for _ in range(ticks):
        running = rng.random(M) < 0.8
        mon = np.where(rng.random(M) < 0.05, 0, mon + running)
        cal.observe(rng.gamma(2.0, 1.0, 2 * M).astype(np.float32), mon)
        sel = np.nonzero(running & (mon >= 2))[0]
        rows = np.concatenate([sel, M + sel])
        g = np.tile(rng.integers(-1, 3, sel.size), 2) if n_groups else None
        scale = cal.scales(rows, groups=g)
        cal.begin(rows, rng.uniform(0, 2, rows.size).astype(np.float32),
                  rng.uniform(0, 0.5, rows.size).astype(np.float32),
                  scale.astype(np.float32), np.concatenate([mon[sel]] * 2), groups=g)
        scales.append(scale)
    return scales, cal.report(), cal.group_report()


@pytest.mark.parametrize("n_groups", [0, 3], ids=["fleet", "groups"])
def test_online_calibrator_equals_reference(n_groups):
    cfg = MODES["adaptive"]
    want = _calibrator_stream(runc, cfg, n_groups)
    got = _calibrator_stream(tunc, _tcfg(cfg), n_groups)
    for g, w in zip(got[0], want[0]):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    assert got[1:] == want[1:]
    assert want[1]["series_warm"] > 0 and want[1]["pool_warm"] and want[1]["dropped"] > 0


# ----------------------------------------------------------------------
# the device engine's calibration functions, one step
# ----------------------------------------------------------------------

def _fields(obj) -> dict:
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _crafted_state(rcfg, S=3, M=40, seed=8):
    """A stacked reference CalibState with seeded rings (empty, young,
    full, wrapped, tie-prone), pools, outstanding predictions due now,
    later, or at a count the monitor missed, and counters."""
    rng = np.random.default_rng(seed)
    R, cap, pcap = 2 * M, rcfg.capacity, rcfg.pool_capacity

    def circular(n_rows, cap, counts):
        ring = np.full((n_rows, cap), np.inf, np.float32)
        for r, c in enumerate(counts):
            vals = (rng.choice(_TIES[:7], c) if rng.random() < 0.3
                    else rng.normal(1, 1, c)).astype(np.float32)
            ring[r, np.arange(c) % cap] = vals
        return ring

    counts = rng.choice([0, 2, rcfg.min_scores, cap, cap + 3, 3 * cap], (S, R)).astype(np.int32)
    pool_count = np.array([0, 5, pcap + 7], np.int32)[:S]
    mon = rng.integers(0, 30, (S, M)).astype(np.int32)
    left = rng.choice([0, 1, 1, 2], (S, R)).astype(np.int32)
    due = (np.concatenate([mon, mon], 1) + rng.choice([0, 0, 0, 1], (S, R))).astype(np.int32)
    sigma = rng.choice([0.0, 1e-8, 0.3, 1.2], (S, R)).astype(np.float32)
    st = dict(
        ring=np.stack([circular(R, cap, c) for c in counts]), ring_count=counts,
        pool=np.stack([circular(1, pcap, [c])[0] for c in pool_count]),
        pool_count=pool_count,
        mean=rng.uniform(0, 2, (S, R)).astype(np.float32), sigma=sigma,
        scale=rng.uniform(0.5, 3, (S, R)).astype(np.float32),
        peak=np.where(rng.random((S, R)) < 0.5, -np.inf,
                      rng.uniform(0, 3, (S, R))).astype(np.float32),
        left=left, due=due, q=rng.uniform(0.6, 0.95, S).astype(np.float32),
        resolved=rng.integers(0, 50, S).astype(np.int32),
        errors=rng.integers(0, 5, S).astype(np.int32),
        dropped=rng.integers(0, 5, S).astype(np.int32),
        scale_sum=rng.uniform(0, 9, S).astype(np.float32),
        scale_n=rng.integers(0, 9, S).astype(np.int32))
    usage = rng.uniform(0, 2.5, (S, M, 2)).astype(np.float32)
    return st, usage, mon


def _assert_state(got: tunc.CalibState, want: dict, what: str):
    for name, w in want.items():
        g = getattr(got, name).cpu().numpy()
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(_bits(g), _bits(w), err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(g, w, err_msg=f"{what}: {name}")


def test_one_device_step_equals_reference():
    """calib_observe from a converted reference state, then the engine's
    calib_scales_begin against the reference's calib_scales and
    calib_begin: every field bit-equal, with pool overflow and the
    adaptive step."""
    rcfg = runc.CalibrationConfig(enabled=True, capacity=16, min_scores=4, pool_capacity=8,
                                  adaptive=True)
    pcfg = _tcfg(rcfg)
    st, usage, mon = _crafted_state(rcfg)
    S, M = mon.shape
    active = np.array([True, True, False])
    rst = runc.CalibState(**{k: jnp.asarray(v) for k, v in st.items()})
    rows = np.concatenate([usage[..., 0], usage[..., 1]], 1)
    tiled = np.concatenate([mon, mon], 1)
    want = jax.jit(jax.vmap(lambda s, u, m, a: runc.calib_observe(s, u, m, rcfg, active=a)))(
        rst, rows, tiled, active)
    pst = convert.calib_state_from_arrays(device="cpu", **st)
    got = tunc.calib_observe(pst, torch.from_numpy(usage), torch.from_numpy(mon), pcfg,
                             torch.from_numpy(active))
    _assert_state(got, _fields(want), "calib_observe")
    n_res = np.asarray(want.resolved - rst.resolved)
    assert n_res[0] > rcfg.pool_capacity and n_res[2] == 0          # overflow; inactive
    assert (np.asarray(want.q) != st["q"])[:2].all()                 # the adaptive step

    rscale = np.asarray(jax.jit(jax.vmap(lambda s: runc.calib_scales(s, rcfg, 3.0)))(want))

    rng = np.random.default_rng(9)
    deploy = rng.random((S, M)) < 0.6
    mean = rng.uniform(0, 2, (S, 2 * M)).astype(np.float32)
    var = rng.choice([-1e-7, 0.0, 0.04, 2.5], (S, 2 * M)).astype(np.float32)
    sigma = np.sqrt(np.maximum(var, 0)).astype(np.float32)
    d2 = np.concatenate([deploy, deploy], 1)
    began = jax.jit(jax.vmap(lambda s, d, mu, sg, sc, m: runc.calib_begin(s, d, mu, sg, sc, m, 3)))(
        want, d2, mean, sigma, rscale, tiled)
    T = torch.from_numpy
    fscale, fused = tunc.calib_scales_begin(got, pcfg, 3.0, T(deploy), T(mean), T(var), T(mon), 3)
    np.testing.assert_array_equal(_bits(fscale), _bits(rscale))
    _assert_state(fused, _fields(began), "calib_scales_begin")


def _group_tier(st, S, M, G=3, gcap=8, A=10, N=12, seed=15):
    """The per-tenant tier over a crafted state: group rings (empty, young,
    wrapped), each row's deploy group (-1 for some), counters, and a slot
    table of A slots of M / A components with tenants of N apps and their
    credit: (reference CalibState fields, slot_gid, tenant, credit)."""
    rng = np.random.default_rng(seed)
    R = 2 * M
    gcount = rng.choice([0, 3, gcap, gcap + 5], (S, G)).astype(np.int32)
    ring = np.full((S, G, gcap), np.inf, np.float32)
    for s_ in range(S):
        for g in range(G):
            c = gcount[s_, g]
            ring[s_, g, np.arange(c) % gcap] = rng.normal(1, 1, c).astype(np.float32)
    tier = dict(group_ring=ring, group_count=gcount,
                group=rng.integers(-1, G, (S, R)).astype(np.int32),
                group_resolved=rng.integers(0, 30, (S, G)).astype(np.int32),
                group_errors=rng.integers(0, 5, (S, G)).astype(np.int32))
    slot_gid = np.where(rng.random((S, A)) < 0.8, rng.integers(0, N, (S, A)), -1).astype(np.int32)
    tenant = rng.integers(0, G, (S, N)).astype(np.int32)
    credit = rng.uniform(0.05, 1, (S, G)).astype(np.float32)
    return {**st, **tier}, slot_gid, tenant, credit


def _reference_groups(slot_gid, tenant, C):
    ten = np.where(slot_gid >= 0, np.take_along_axis(tenant, np.maximum(slot_gid, 0), 1), -1)
    g1 = np.repeat(ten, C, axis=1)
    return np.concatenate([g1, g1], 1).astype(np.int32)


def test_group_tier_step_equals_reference():
    """The per-tenant tier: calib_observe from a converted reference state
    with group rings (a group that resolves more scores than its ring
    holds), then the engine's calib_scales_begin with tenancy against the
    reference's calib_scales (series -> group -> pool -> K2, at the
    credit-modulated quantiles) and calib_begin (the rows' groups), every
    field bit for bit, with the credit and without."""
    rcfg = runc.CalibrationConfig(enabled=True, capacity=16, min_scores=4, pool_capacity=8,
                                  adaptive=True, group_capacity=8)
    pcfg = _tcfg(rcfg)
    st, usage, mon = _crafted_state(rcfg)
    S, M = mon.shape
    st, slot_gid, tenant, credit = _group_tier(st, S, M)
    active = np.array([True, True, False])
    rst = runc.CalibState(**{k: jnp.asarray(v) for k, v in st.items()})
    rows = np.concatenate([usage[..., 0], usage[..., 1]], 1)
    tiled = np.concatenate([mon, mon], 1)
    want = jax.jit(jax.vmap(lambda s, u, m, a: runc.calib_observe(s, u, m, rcfg, active=a)))(
        rst, rows, tiled, active)
    pst = convert.calib_state_from_arrays(device="cpu", **st)
    T = torch.from_numpy
    got, (d_res, d_err) = tunc.calib_observe_groups(pst, T(usage), T(mon), pcfg, T(active))
    _assert_state(got, _fields(want), "calib_observe")
    np.testing.assert_array_equal(d_res.numpy(), np.asarray(want.group_resolved)
                                  - st["group_resolved"])
    np.testing.assert_array_equal(d_err.numpy(), np.asarray(want.group_errors)
                                  - st["group_errors"])
    assert (d_res.numpy() > rcfg.group_capacity).any() and d_err.numpy().any()

    rng = np.random.default_rng(16)
    deploy = rng.random((S, M)) < 0.6
    mean = rng.uniform(0, 2, (S, 2 * M)).astype(np.float32)
    var = rng.choice([0.0, 0.04, 2.5], (S, 2 * M)).astype(np.float32)
    sigma = np.sqrt(var).astype(np.float32)
    d2 = np.concatenate([deploy, deploy], 1)
    C = M // slot_gid.shape[1]
    groups = _reference_groups(slot_gid, tenant, C)
    tcfg = tctl.TenancyConfig(enabled=True)
    for with_credit in (True, False):
        if with_credit:
            qt = jax.jit(jax.vmap(lambda c, q: rctl.credit_quantile(
                c, q, tcfg.q_spread, rcfg.q_min, rcfg.q_max)))(credit, want.q)
            q_rows = jnp.where(groups >= 0, jnp.take_along_axis(
                qt, jnp.maximum(groups, 0), 1), want.q[:, None])
            rscale = jax.jit(jax.vmap(lambda s, g, qr, qg: runc.calib_scales(
                s, rcfg, 3.0, groups=g, q_rows=qr, q_groups=qg)))(want, groups, q_rows, qt)
        else:
            rscale = jax.jit(jax.vmap(lambda s, g: runc.calib_scales(s, rcfg, 3.0, groups=g)))(
                want, groups)
        began = jax.jit(jax.vmap(lambda s, d, mu, sg, sc, m, g: runc.calib_begin(
            s, d, mu, sg, sc, m, 3, groups=g)))(want, d2, mean, sigma, rscale, tiled, groups)
        fscale, fused = tunc.calib_scales_begin(
            got, pcfg, 3.0, T(deploy), T(mean), T(var), T(mon), 3,
            (T(credit) if with_credit else None, T(tenant), T(slot_gid), tcfg))
        np.testing.assert_array_equal(_bits(fscale), _bits(rscale))
        _assert_state(fused, _fields(began), f"calib_scales_begin, credit {with_credit}")
    warm = np.minimum(np.asarray(want.group_count), rcfg.group_capacity) >= rcfg.min_scores
    assert warm.any() and (~warm).any()


# the reference's steps at the crafted cases' configuration, jitted once
# for the module (a compile per shape: three widths of G, and 3,000 rows)
CRAFTED_RCFG = runc.CalibrationConfig(enabled=True, q=0.9, adaptive=True, budget=0.1,
                                      **CALIB_CRAFTED_CFG)
CRAFTED_TCFG = tctl.TenancyConfig(enabled=True)
_crafted_observe = jax.jit(jax.vmap(
    lambda s, u, m, a: runc.calib_observe(s, u, m, CRAFTED_RCFG, active=a)))
_crafted_quantiles = jax.jit(jax.vmap(lambda c, q: rctl.credit_quantile(
    c, q, CRAFTED_TCFG.q_spread, CRAFTED_RCFG.q_min, CRAFTED_RCFG.q_max)))
_crafted_scales = jax.jit(jax.vmap(lambda s, g, qr, qg: runc.calib_scales(
    s, CRAFTED_RCFG, 3.0, groups=g, q_rows=qr, q_groups=qg)))
_crafted_begin = jax.jit(jax.vmap(lambda s, d, mu, sg, sc, m, g: runc.calib_begin(
    s, d, mu, sg, sc, m, 3, groups=g)))
# the rows' quantiles as the reference's shaping step gathers them
# (repro/sim/step.py:376): an id of T or more reads tenant T - 1's
_crafted_q_rows = jax.jit(jax.vmap(lambda g, qt, q: jnp.where(g >= 0, qt[jnp.maximum(g, 0)], q)))


@pytest.mark.parametrize("name", CALIB_CRAFTED)
def test_crafted_step_equals_reference(name):
    """chip_smoke.py's crafted cases of calib_observe and calib_begin
    (tests/test_torch_kernels_hopper.py holds the kernels to the plain
    versions on them): the plain versions, through the port's
    calib_observe_groups and calib_scales_begin with the per-tenant tier
    and the credit, against the reference's calib_observe, calib_scales
    and calib_begin, every field bit for bit.  The reference takes its own
    groups (each row's slot's tenant id as the trace holds it) and gathers
    the rows' quantiles as its shaping step does, so that a tenant id of T
    or more reads tenant T - 1's."""
    st, tick, tier, table = calib_crafted(name)
    S, M = tick["mon_count"].shape
    T_ = torch.from_numpy
    full = {**st, **tier}
    full.pop("scale_sum"), full.pop("scale_n")
    full.update(scale_sum=st["scale_sum"], scale_n=st["scale_n"])
    rst = runc.CalibState(**{k: jnp.asarray(v) for k, v in full.items()})
    usage, mon, active = tick["usage"], tick["mon_count"], tick["active"]
    tiled = np.concatenate([mon, mon], 1)
    want = _crafted_observe(rst, np.concatenate([usage[..., 0], usage[..., 1]], 1), tiled,
                            active)
    pcfg = _tcfg(CRAFTED_RCFG)
    pst = convert.calib_state_from_arrays(device="cpu", **full)
    got, (d_res, d_err) = tunc.calib_observe_groups(pst, T_(usage), T_(mon), pcfg, T_(active))
    _assert_state(got, _fields(want), f"calib_observe, {name}")
    np.testing.assert_array_equal(d_res.numpy(), np.asarray(want.group_resolved)
                                  - tier["group_resolved"])
    np.testing.assert_array_equal(d_err.numpy(), np.asarray(want.group_errors)
                                  - tier["group_errors"])

    groups = _reference_groups(table["slot_gid"], table["tenant"],
                               M // table["slot_gid"].shape[1])
    qt = _crafted_quantiles(table["credit"], want.q)
    q_rows = _crafted_q_rows(groups, qt, want.q)
    rscale = _crafted_scales(want, groups, q_rows, qt)
    d2 = np.concatenate([tick["deploy"]] * 2, 1)
    sigma = np.sqrt(np.maximum(tick["var"], np.float32(0))).astype(np.float32)
    began = _crafted_begin(want, d2, tick["fmean"], sigma, rscale, tiled, groups)
    fscale, fused = tunc.calib_scales_begin(
        got, pcfg, 3.0, T_(tick["deploy"]), T_(tick["fmean"]), T_(tick["var"]), T_(mon), 3,
        (T_(table["credit"]), T_(table["tenant"]), T_(table["slot_gid"]), CRAFTED_TCFG))
    np.testing.assert_array_equal(_bits(fscale), _bits(rscale))
    _assert_state(fused, _fields(began), f"calib_scales_begin, {name}")


def _fma_splits(rng, n):
    """(mean, scale, sigma, peak) where ``peak > fma(scale, sigma, mean)``
    but not ``peak > round(round(scale * sigma) + mean)``."""
    scale = rng.uniform(0.5, 4, 40 * n).astype(np.float32)
    sigma = rng.uniform(0.01, 1, 40 * n).astype(np.float32)
    mean = rng.uniform(0.5, 2, 40 * n).astype(np.float32)
    fused = ref.fma_f32(*map(torch.from_numpy, (scale, sigma, mean))).numpy()
    two = (np.float32(scale * sigma) + mean).astype(np.float32)
    keep = np.nonzero(fused < two)[0][:n]
    assert keep.size == n
    return mean[keep], scale[keep], sigma[keep], two[keep]


def test_observe_rounds_as_the_fused_tick_contracts():
    """Inside the reference's compiled tick, ``peak > mean + scale *
    sigma`` and the adaptive ``q + gamma * (err_rate - budget)`` are
    fused multiply-adds.  From a first-tick state whose every prediction
    comes due with a peak between the two roundings (so the error rate is
    1, and more scores resolve than the pool holds) and a q whose step
    rounds differently twice, a chunk of 32 ticks of the reference's
    compiled program leaves the port's state (which rounds once)."""
    cfg = _calibrated("adaptive")
    pcfg, ptr, wl = _port(cfg)
    tr = rstate.DeviceTrace.from_trace(wl)
    st = rstate.init_state(cfg, wl.n_apps, wl.max_components)
    R = st.calib.ring.shape[0]
    mean, scale, sigma, peak = _fma_splits(np.random.default_rng(10), R)
    st = dataclasses.replace(st, calib=dataclasses.replace(
        st.calib, mean=jnp.asarray(mean), scale=jnp.asarray(scale), sigma=jnp.asarray(sigma),
        peak=jnp.asarray(peak), left=jnp.ones(R, jnp.int32), due=jnp.zeros(R, jnp.int32),
        q=jnp.float32(Q_SPLIT)))
    before = {k: v for k, v in _fields(st).items() if k != "calib"}
    before["calib"] = _fields(st.calib)
    ptr = convert.device_trace_from_arrays(device="cpu", **_fields(tr))
    cap = tstep.host_capacity(pcfg, "cpu")
    first, _ = tstep.fused_tick(pcfg, None, ptr, convert.sim_state_from_arrays(
        device="cpu", **before), cap)
    assert int(first.calib.errors) == int(first.calib.resolved) == R > cfg.calibration.pool_capacity
    assert float(first.calib.q) == float(Q_NEXT)
    after, _ = rstep._chunk_fn(cfg, 32, rstep._shapes_key(wl, cfg), False, None)(tr, st)
    pst = convert.sim_state_from_arrays(device="cpu", **before)
    tstep._chunk_program(pcfg, None, ptr, pst, 32, cap)
    want = {k: v[None] for k, v in _fields(after.calib).items()}
    _assert_state(pst.calib, want, "32 ticks")
    assert int(after.calib.resolved) > R


@pytest.mark.parametrize("k1", [0.05, 1.0])
def test_scaled_safeguard_contracts_as_reference(k1):
    """Eq. 9 with calibrated scales: as the host engine's jitted call,
    whose k1 is an argument (fma(k1, request, scale * sigma) at every
    k1), and as the device engine's compiled tick, whose k1 is a
    constant (at k1 = 1, fma(scale, sigma, request))."""
    rng = np.random.default_rng(11)
    n = 20_000
    peak = rng.uniform(0, 2, n).astype(np.float32)
    req = rng.uniform(0.1, 4, n).astype(np.float32)
    var = (rng.uniform(0, 1, n) ** 3).astype(np.float32)
    scale = rng.uniform(-1, 5, n).astype(np.float32)
    T = torch.from_numpy
    host = jax.jit(shaped_demand_scaled_raw)(peak, req, var, np.float32(k1), scale)
    dev = jax.jit(lambda p, r, v, s: shaped_demand_scaled_raw(p, r, v, jnp.float32(k1), s))(
        peak, req, var, scale)
    got_host = shaped_demand_scaled(T(peak), T(req), T(var), k1, T(scale))
    got_dev = shaped_demand_scaled(T(peak), T(req), T(var), k1, T(scale), k1_folded=True)
    np.testing.assert_array_equal(_bits(got_host), _bits(host))
    np.testing.assert_array_equal(_bits(got_dev), _bits(dev))
    assert (k1 == 1) == ((_bits(host) != _bits(dev)).sum() > 10)


# ----------------------------------------------------------------------
# whole runs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", sorted(MODES))
def test_host_engine_equals_reference(mode):
    cfg = _calibrated(mode)
    pcfg, ptr, wl = _port(cfg)
    want = reng.run_sim(cfg, wl)
    _assert_equal(tengine.run_sim(pcfg, ptr, device="cpu"), want, exact=True)
    assert want.calibration["resolved"] > 100 and want.calibration["pool_warm"]


def _shared_peaks(w, v):
    """The host engines' forecast client: ``_shared_client``'s peak over
    the horizon and its variance, per row."""
    mean, var = _shared_client(w, v)
    k = np.argmax(mean, 1)[:, None]
    return np.take_along_axis(mean, k, 1)[:, 0], np.take_along_axis(var, k, 1)[:, 0]


def test_host_engine_gp_with_shared_client_equals_reference():
    cfg = dataclasses.replace(_calibrated("conformal"), forecaster="gp")
    pcfg, ptr, wl = _port(cfg)
    want = reng.run_sim(cfg, wl, forecast_fn=_shared_peaks)
    got = tengine.run_sim(pcfg, ptr, forecast_fn=_shared_peaks, device="cpu")
    _assert_equal(got, want, exact=True)
    assert want.summary()["partial_preemptions"] > 0


def test_device_engine_equals_reference():
    """The device engine against the reference's scan engine (adaptive,
    persist); then chunk 1 against 32, and a cohort against its solo
    runs."""
    cfg = _calibrated("adaptive")
    pcfg, ptr, wl = _port(cfg)
    got = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    _assert_equal(got, rstep.run_sim_scan(cfg, wl), exact=False)
    one = tstep.run_sim_scan(pcfg, ptr, chunk=1, device="cpu")
    assert one.summary() == got.summary() and one.slack_cpu == got.slack_cpu
    cohort = tstep.run_cohort_scan(pcfg, [0, 1], device="cpu")
    assert cohort[0].summary() == got.summary()
    solo = tstep.run_sim_scan(dataclasses.replace(
        pcfg, workload=dataclasses.replace(pcfg.workload, seed=1)), device="cpu")
    assert cohort[1].summary() == solo.summary() != got.summary()
    assert got.calibration["series_warm"] > 0


def test_device_engine_gp_with_shared_client_equals_reference(monkeypatch):
    """Conformal, gp with one forecast client for both engines, over the
    full batch (bucketing changes only the rows no prediction reads, and
    the reference compiles its bucketed loop for twice as long)."""
    cfg = dataclasses.replace(_calibrated("conformal"), forecaster="gp", forecast_bucket=False)
    pcfg, ptr, wl = _port(cfg)
    monkeypatch.setattr(rstep, "_CHUNK_CACHE", {})
    monkeypatch.setattr(rstep, "_make_model", lambda c: _JaxClient())
    monkeypatch.setattr(tstep, "_make_model", lambda c: _TorchClient())
    want = rstep.run_sim_scan(cfg, wl)
    got = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    _assert_equal(got, want, exact=False)
    assert got.forecast_rows == want.forecast_rows


def test_leap_holds_for_pending_scores():
    """Leap with calibration on the gap-dominated cell: equal to the
    uniform ticks and to the reference's leap engine; and the skip holds
    a member whose scores are pending, as the reference's loop does."""
    cfg = dataclasses.replace(GAP, calibration=MODES["adaptive"], grace=2, max_ticks=480)
    pcfg, ptr, wl = _port(cfg, "flashcrowd")
    leap = tstep.run_sim_scan(dataclasses.replace(pcfg, leap=True), ptr, device="cpu")
    uni = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    assert leap.summary() == uni.summary() and leap.n_running == uni.n_running
    _assert_equal(leap, rstep.run_sim_scan(dataclasses.replace(cfg, leap=True), wl),
                  exact=False)
    assert leap.timings["steps"] * 3 < leap.timings["ticks"]
    assert leap.calibration["resolved"] > 0 and leap.calibration["dropped"] > 0

    args = [torch.as_tensor(a) for a in _skip_states(3, 60.0)]
    S = args[0].shape[0]
    free = ops.leap_skip(*args, 60.0)
    pending = torch.zeros((S, 6), dtype=torch.int32)
    pending[::2, 3] = 2
    held = ops.leap_skip(*args, 60.0, pending)
    assert (held[1][::2] == 0).all() and (held[0][::2] == args[5][::2]).all()
    assert (held[1][1::2] == free[1][1::2]).all() and (free[1][::2] > 0).any()


def test_oracle_keeps_calibration_off():
    cfg = dataclasses.replace(_calibrated("conformal"), forecaster="oracle")
    pcfg, ptr, wl = _port(cfg)
    host = tengine.run_sim(pcfg, ptr, device="cpu")
    scan = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    assert host.calibration is None and scan.calibration is None
    assert host.summary() == reng.run_sim(cfg, wl).summary()
    assert "calibration" not in scan.summary()


def test_member_kernels_refuse_rows_past_their_limit():
    """calib_observe and calib_begin take at most calib.MAX_ROWS series
    rows (every count a 16-bit field of the scan) and calib_begin at most
    calib.MAX_GROUPS tenants; their wrappers raise, naming the limit,
    before anything is built or launched."""
    from test_torch_flash_route import CudaStandIn
    R, f32, i32 = kcalib.MAX_ROWS + 2, torch.float32, torch.int32
    ring, pool = CudaStandIn((1, R, 16), f32), CudaStandIn((1, 8), f32)
    with pytest.raises(ValueError, match=f"at most {kcalib.MAX_ROWS}"):
        kcalib.calib_observe(ring, None, pool, *(None,) * 14, pool_on=True, adaptive=True,
                             gamma=0.01, budget=0.1, q_min=0.5, q_max=0.99)
    with pytest.raises(ValueError, match=f"at most {kcalib.MAX_ROWS}"):
        kcalib.calib_scales(ring, None, pool, *(None,) * 15, min_scores=4, pool_on=True,
                            horizon=3)
    kw = dict(cap=16, pcap=8, min_scores=4, pool_on=True, horizon=3, fallback=3.0)
    with pytest.raises(ValueError, match=f"at most {kcalib.MAX_ROWS}"):
        kcalib.calib_begin(*(None,) * 10, CudaStandIn((1, R), f32), *(None,) * 5, **kw)
    R, A, T = 3072, 128, kcalib.MAX_GROUPS + 1
    tenancy = (CudaStandIn((1, 500), i32), CudaStandIn((1, A), i32), CudaStandIn((1, T), i32),
               None, None, 8)
    with pytest.raises(ValueError, match=f"1..{kcalib.MAX_GROUPS}"):
        kcalib.calib_begin(*(None,) * 10, CudaStandIn((1, R), f32), *(None,) * 5, tenancy,
                           **kw)


def test_group_tier_is_refused():
    """The per-group tier came with the control plane: ``calib_init``
    allocates it, and a converted state takes it whole; only a partial
    tier is still refused."""
    st = tunc.calib_init(8, tunc.CalibrationConfig(enabled=True, group_capacity=4), 1, "cpu",
                         n_groups=2)
    assert st.group_ring.shape == (1, 2, 4) and (st.group == -1).all()
    with pytest.raises(ValueError, match="per-group"):
        convert.calib_state_from_arrays(device="cpu", group_ring=np.zeros((2, 4)))


# ----------------------------------------------------------------------
# on the card (``-m gpu``)
# ----------------------------------------------------------------------

def _to(st: tunc.CalibState, device) -> tunc.CalibState:
    return tunc.CalibState(**{f.name: getattr(st, f.name).to(device)
                              for f in dataclasses.fields(st)
                              if getattr(st, f.name) is not None})


@pytest.mark.gpu
def test_kernels_equal_plain_versions():
    """conformal_scale (rolled and circular rings, capacity 128),
    calib_observe, the engine's calib_scales step and leap_skip with
    pending scores, each on the card against its plain version."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for circular in (False, True):
        scores, counts = _rings(12, B=256, cap=128, circular=circular)
        q = np.random.default_rng(13).uniform(0.05, 1, 256).astype(np.float32)
        args = [torch.from_numpy(a) for a in (scores, counts, q, -q)]
        want = ref.conformal_scale(*args, rolled=not circular)
        got = ops.conformal_scale(*(a.cuda() for a in args), rolled=not circular)
        np.testing.assert_array_equal(_bits(got.cpu()), _bits(want))
    rcfg = runc.CalibrationConfig(enabled=True, capacity=16, min_scores=4, pool_capacity=8,
                                  adaptive=True)
    pcfg = _tcfg(rcfg)
    st, usage, mon = _crafted_state(rcfg)
    cpu = convert.calib_state_from_arrays(device="cpu", **st)
    T = torch.from_numpy
    active = torch.tensor([True, True, False])
    want = tunc.calib_observe(cpu, T(usage), T(mon), pcfg, active)
    got = tunc.calib_observe(_to(cpu, "cuda"), T(usage).cuda(), T(mon).cuda(), pcfg,
                             active.cuda())
    _assert_state(got, {k: v.numpy() for k, v in tstep._tensors(want).items()},
                  "calib_observe on the card")
    rng = np.random.default_rng(14)
    deploy = T(rng.random(mon.shape) < 0.6)
    mean = T(rng.uniform(0, 2, usage.shape[:2] + (2,)).reshape(3, -1).astype(np.float32))
    var = T(rng.uniform(-1e-7, 2, mean.shape).astype(np.float32))
    w_scale, w_st = tunc.calib_scales_begin(want, pcfg, 3.0, deploy, mean, var, T(mon), 3)
    g_scale, g_st = tunc.calib_scales_begin(got, pcfg, 3.0, deploy.cuda(), mean.cuda(),
                                            var.cuda(), T(mon).cuda(), 3)
    np.testing.assert_array_equal(_bits(g_scale.cpu()), _bits(w_scale))
    _assert_state(g_st, {k: v.numpy() for k, v in tstep._tensors(w_st).items()},
                  "calib_scales on the card")
    args = [torch.as_tensor(a) for a in _skip_states(3, 60.0)]
    pending = torch.zeros((args[0].shape[0], 6), dtype=torch.int32)
    pending[::2, 3] = 2
    for w, g in zip(ref.leap_skip(*args, 60.0, pending),
                    ops.leap_skip(*(a.cuda() for a in args), 60.0, pending.cuda())):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.gpu
def test_calibrated_run_card_equals_cpu():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pcfg, ptr, _ = _port(_calibrated("adaptive"))
    cpu = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    gpu = tstep.run_sim_scan(pcfg, ptr, device="cuda")
    assert gpu.summary() == cpu.summary() and gpu.slack_cpu == cpu.slack_cpu


@pytest.mark.gpu
def test_group_tier_kernels_equal_plain_versions():
    """The three calibration kernels with the per-tenant tier on the card
    against their plain versions: calib_observe (a group over its ring's
    capacity in one tick, the deltas), then the shaping step's quantiles
    at the credit-modulated levels and calib_begin's fallback and
    registration, with the credit and without; and the engine's group
    rings at their full capacity (256)."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    for gcap in (8, 256):
        rcfg = runc.CalibrationConfig(enabled=True, capacity=16, min_scores=4,
                                      pool_capacity=8, adaptive=True, group_capacity=gcap)
        pcfg = _tcfg(rcfg)
        st, usage, mon = _crafted_state(rcfg)
        S, M = mon.shape
        st, slot_gid, tenant, credit = _group_tier(st, S, M, gcap=gcap)
        cpu = convert.calib_state_from_arrays(device="cpu", **st)
        T = torch.from_numpy
        active = torch.tensor([True, True, False])
        want, wd = tunc.calib_observe_groups(cpu, T(usage), T(mon), pcfg, active)
        got, gd = tunc.calib_observe_groups(_to(cpu, "cuda"), T(usage).cuda(), T(mon).cuda(),
                                            pcfg, active.cuda())
        _assert_state(got, {k: v.numpy() for k, v in tstep._tensors(want).items()},
                      "calib_observe on the card")
        for g, w in zip(gd, wd):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
        rng = np.random.default_rng(17)
        deploy = T(rng.random(mon.shape) < 0.6)
        mean = T(rng.uniform(0, 2, (S, 2 * M)).astype(np.float32))
        var = T(rng.uniform(-1e-7, 2, (S, 2 * M)).astype(np.float32))
        tcfg = tctl.TenancyConfig(enabled=True)
        for cr in (T(credit), None):
            w_scale, w_st = tunc.calib_scales_begin(want, pcfg, 3.0, deploy, mean, var, T(mon),
                                                    3, (cr, T(tenant), T(slot_gid), tcfg))
            g_scale, g_st = tunc.calib_scales_begin(
                got, pcfg, 3.0, deploy.cuda(), mean.cuda(), var.cuda(), T(mon).cuda(), 3,
                (None if cr is None else cr.cuda(), T(tenant).cuda(), T(slot_gid).cuda(),
                 tcfg))
            np.testing.assert_array_equal(_bits(g_scale.cpu()), _bits(w_scale))
            _assert_state(g_st, {k: v.numpy() for k, v in tstep._tensors(w_st).items()},
                          "calib_scales with the tier on the card")
