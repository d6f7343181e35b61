"""The port's device engine (``repro_torch.sim.step``) against the
reference's scan engine (``repro.sim.step``) on the CPU, and its own
contracts: chunk invariance, cohort equivalence, refused switches.

The reference and the port are compared phase for phase: one fused tick
from the same converted mid-run state must leave the same next state,
and whole runs the same discrete outcomes (completions, failures,
preemptions, OOM kills) with turnaround and utilisation allclose.  The
per-tick metric sums are the one float the port takes in another order
(exact float64 sums where XLA sums float32 in a tree), so they agree to
rtol 1e-6 and are held to it.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import SUBNORMAL_ROWS, TINY, tiny_triples
from repro.core.forecast.base import Forecast as RForecast
from repro.obs import REGISTRY as RREGISTRY
from repro.sim import SimConfig
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro.sim.scenarios import families as rfam
from repro.sim.scenarios.registry import build_trace
from repro_torch import convert
from repro_torch.core.forecast import Forecast as TForecast
from repro_torch.core.forecast import GPConfig
from repro_torch.kernels import ops as kops
from repro_torch.obs import REGISTRY as TREGISTRY
from repro_torch.sim import ClusterConfig, WorkloadConfig
from repro_torch.sim import SimConfig as TSimConfig
from repro_torch.sim import step as tstep
from test_torch_engine import quick_base_config

COUNTERS = ("completed", "n_apps", "failure_events", "oom_kills", "full_preemptions",
            "partial_preemptions", "failed_frac", "sim_hours")
SMALL = quick_base_config(n_apps=24, n_hosts=3)


@pytest.fixture(scope="module", autouse=True)
def _one_torch_thread():
    """Run the port's CPU code on one torch thread.  Its tensors are
    small, and beside other busy processes torch's thread pool waits far
    longer than it computes: on 8 cores with 6 busy processes, the plain
    ARIMA at 256 rows takes 1.8 s a call on 8 threads and 93 ms on one;
    the full-width oracle run below took 656 s in a whole run of the
    suite on 6 processes (alone: 77 s on 8 threads, 53 s on one).  The
    leap and ARIMA test files import it."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def _columns(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr) if f.name != "cfg"}


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _port_inputs(cfg):
    wl = build_trace(cfg.workload)
    return (convert.sim_config_from_dict(dataclasses.asdict(cfg)),
            convert.trace_from_arrays(**_columns(wl)), wl)


def _assert_summary(got: dict, want: dict):
    for k in COUNTERS:
        assert got[k] == want[k], (k, got[k], want[k])
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


# ----------------------------------------------------------------------
# one tick
# ----------------------------------------------------------------------

@pytest.mark.parametrize("forecaster", ["persist", "oracle"])
def test_fused_tick_equals_reference(forecaster):
    """From the reference's state at ticks 10, 20, ..., 50 of a saturated
    run, one tick in both packages leaves the same next state, and the
    same metrics."""
    cfg = dataclasses.replace(quick_base_config(), forecaster=forecaster)
    pcfg, _, wl = _port_inputs(cfg)
    tr = rstate.DeviceTrace.from_trace(wl)
    st = rstate.init_state(cfg, wl.n_apps, wl.max_components)
    fn = rstep._chunk_fn(cfg, 1, rstep._shapes_key(wl, cfg), False, None)
    ptr = convert.device_trace_from_arrays(device="cpu", **_fields(tr))
    cap = tstep.host_capacity(pcfg, "cpu")
    events = 0
    for k in range(51):
        before = _fields(st)          # numpy copies: the chunk step donates its state
        st, m = fn(tr, st)
        if k % 10 or not k:
            continue
        pst, pm = tstep.fused_tick(pcfg, None, ptr,
                                   convert.sim_state_from_arrays(device="cpu", **before),
                                   cap)
        for name, want in _fields(st).items():
            np.testing.assert_array_equal(getattr(pst, name).numpy()[0], want, err_msg=name)
        for f in dataclasses.fields(pm):
            got, want = getattr(pm, f.name).numpy()[0], np.asarray(getattr(m, f.name))[0]
            if want.dtype.kind == "f":
                np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=f.name)
            else:
                np.testing.assert_array_equal(got, want, err_msg=f.name)
        events += int((before["slot_gid"] != _fields(st)["slot_gid"]).sum())
    assert events > 0


# ----------------------------------------------------------------------
# whole runs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["pessimistic", "optimistic", "baseline"])
@pytest.mark.parametrize("forecaster", ["persist", "oracle"])
def test_run_sim_scan_equals_reference(forecaster, policy):
    cfg = dataclasses.replace(SMALL, forecaster=forecaster, policy=policy)
    pcfg, ptr, wl = _port_inputs(cfg)
    _assert_summary(tstep.run_sim_scan(pcfg, ptr, device="cpu").summary(),
                    rstep.run_sim_scan(cfg, wl).summary())


def test_flashcrowd_run_equals_reference_scan_engine():
    """A small flashcrowd cell to completion on the port's device engine
    on the CPU and on the reference's scan engine, converted with
    ``sim_config_from_dict(..., workload="flashcrowd")``: the same
    discrete outcomes and per-tick series.  Its shapes and config are
    SMALL's with oracle forecasts, so the reference's compiled chunk is
    the one the run above built."""
    wl = rfam.FlashcrowdConfig(n_apps=24, max_components=8, n_events=2, seed=1)
    cfg = dataclasses.replace(SMALL, forecaster="oracle", workload=wl)
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(cfg), workload="flashcrowd")
    assert type(pcfg.workload).__name__ == "FlashcrowdConfig"
    want = rstep.run_sim_scan(cfg)
    got = tstep.run_sim_scan(pcfg, device="cpu")
    _assert_summary(got.summary(), want.summary())
    assert got.n_running == want.n_running and got.turnaround == want.turnaround
    np.testing.assert_allclose(got.util_mem, want.util_mem, rtol=1e-6)
    assert want.summary()["completed"] == 24 and max(want.n_running) > 8


def test_k1_of_one_equals_reference():
    """A whole run with Eq. 9's k1 = 1 (the reservation as the floor),
    where XLA contracts k2 * sigma + request instead of k1 * request +
    dyn: the same summary.  (The two contractions differ in the last bit
    of ~8% of the demands, which on this config flips no decision; the
    bits are held in tests/test_torch_shaper.py's "random k1=1" case.)"""
    from repro.core.shaper.safeguard import SafeguardConfig
    cfg = dataclasses.replace(quick_base_config(), forecaster="persist",
                              safeguard=SafeguardConfig(k1=1.0, k2=3.0))
    pcfg, ptr, wl = _port_inputs(cfg)
    _assert_summary(tstep.run_sim_scan(pcfg, ptr, device="cpu").summary(),
                    rstep.run_sim_scan(cfg, wl).summary())


def test_preempt_to_checkpoint_equals_reference():
    """work_lost_on_kill=False: preempted apps resume from saved work."""
    cfg = dataclasses.replace(quick_base_config(), forecaster="persist",
                              work_lost_on_kill=False)
    pcfg, ptr, wl = _port_inputs(cfg)
    want = rstep.run_sim_scan(cfg, wl).summary()
    _assert_summary(tstep.run_sim_scan(pcfg, ptr, device="cpu").summary(), want)
    assert want["full_preemptions"] > 0


def test_full_width_oracle_equals_reference():
    """The repo's default SimConfig at full width (500 apps, 50 hosts,
    A=128, C=12) to completion with oracle forecasts."""
    cfg = SimConfig(forecaster="oracle")
    pcfg, ptr, wl = _port_inputs(cfg)
    want = rstep.run_sim_scan(cfg, wl).summary()
    res = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    _assert_summary(res.summary(), want)
    assert want["completed"] == 500 and res.timings["ticks"] > 1000


def _shared_client(w: np.ndarray, v: np.ndarray, horizon: int = 3):
    """A deterministic numpy forecast client: the masked window mean
    drifting by the last step's change, with the masked variance."""
    wf = v.astype(np.float32)
    cnt = np.maximum(wf.sum(1), 1.0)
    mu = (w * wf).sum(1) / cnt
    step = (w[:, -1] - w[:, -2]) * v[:, -2]
    k = np.arange(1, horizon + 1, dtype=np.float32)
    mean = (mu[:, None] + step[:, None] * k).astype(np.float32)
    var = np.repeat(((w - mu[:, None]) ** 2 * wf).sum(1, keepdims=True) / cnt[:, None]
                    + 1e-3, horizon, 1).astype(np.float32)
    return mean, var


class _JaxClient:
    def forecast_batch(self, w, horizon, valid=None):
        shape = jax.ShapeDtypeStruct((w.shape[0], horizon), jnp.float32)
        mean, var = jax.pure_callback(
            lambda a, b: _shared_client(np.asarray(a), np.asarray(b), horizon),
            (shape, shape), w, valid)
        return RForecast(mean=mean, var=var)


class _TorchClient:
    """The shared client for the port; ``ready`` (the bucketed path's
    ready rows) leaves every row computed, as each row's forecast depends
    on that row only."""

    def forecast_batch(self, w, horizon, *, valid, device, ready=None):
        mean, var = _shared_client(w.cpu().numpy(), valid.cpu().numpy(), horizon)
        return TForecast(mean=torch.as_tensor(mean, device=device),
                         var=torch.as_tensor(var, device=device))


@pytest.mark.parametrize("bucket", [False, True], ids=["full_batch", "bucketed"])
def test_gp_path_with_shared_client_equals_reference(monkeypatch, bucket):
    """The gp path (model over all 2*A*C rows, or over the ready rows in
    the reference's buckets; masking, telemetry) with one forecast client
    for both engines: everything downstream of the forecast must
    reproduce the reference's run, ``forecast_rows`` in full."""
    cfg = dataclasses.replace(quick_base_config(), forecaster="gp", forecast_bucket=bucket)
    pcfg, ptr, wl = _port_inputs(cfg)
    monkeypatch.setattr(rstep, "_CHUNK_CACHE", {})
    monkeypatch.setattr(rstep, "_make_model", lambda c: _JaxClient())
    monkeypatch.setattr(tstep, "_make_model", lambda c: _TorchClient())
    r0, t0 = _bucket_metrics(RREGISTRY), _bucket_metrics(TREGISTRY)
    want = rstep.run_sim_scan(cfg, wl)
    got = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    _assert_summary(got.summary(), want.summary())
    assert got.forecast_rows == want.forecast_rows
    assert want.summary()["partial_preemptions"] > 0
    if bucket:      # the queue-3 run: 3,024 rows computed, not the full 36,864
        assert got.forecast_rows["rows_bucketed"] == 3024
        # the bucket telemetry: the chunks of each bucket and its occupancy
        rb, tb = (_bucket_delta(_bucket_metrics(reg), before)
                  for reg, before in ((RREGISTRY, r0), (TREGISTRY, t0)))
        assert tb == rb and sum(n for n, _ in rb.values()) > 0, (tb, rb)


def _bucket_metrics(reg) -> dict:
    """Each bucket's (chunks, occupancy observations, occupancy sum) in a
    metrics registry."""
    snap = reg.snapshot()
    out = {}
    for key, m in snap.items():
        if key.startswith("forecast.bucket_chunks"):
            out.setdefault(m["labels"]["bucket"], [0.0, 0, 0.0])[0] = m["value"]
        elif key.startswith("forecast.bucket_occupancy"):
            out.setdefault(m["labels"]["bucket"], [0.0, 0, 0.0])[1:] = [m["count"], m["sum"]]
    return out


def _bucket_delta(after: dict, before: dict) -> dict:
    """What a run added to each bucket: chunks and occupancy observations,
    the occupancies' sum (a sum of float ratios: rounded to 12 digits)."""
    zero = [0.0, 0, 0.0]
    out = {b: (a[0] - before.get(b, zero)[0], a[1] - before.get(b, zero)[1],
               round(a[2] - before.get(b, zero)[2], 12)) for b, a in after.items()}
    return {b: (int(c), (n, s)) for b, (c, n, s) in out.items() if c or n}


# ----------------------------------------------------------------------
# the port's own contracts
# ----------------------------------------------------------------------

def _series(res):
    return (res.summary(), res.n_running, res.util_cpu, res.util_mem, res.slack_cpu,
            res.slack_mem, res.turnaround, res.failed_apps, res.forecast_rows)


def test_chunk_invariance():
    pcfg, ptr, _ = _port_inputs(dataclasses.replace(quick_base_config(),
                                                    forecaster="persist"))
    runs = [tstep.run_sim_scan(pcfg, ptr, chunk=c, device="cpu") for c in (1, 32)]
    assert _series(runs[0]) == _series(runs[1])
    capped = dataclasses.replace(pcfg, max_ticks=45)
    a, b = (tstep.run_sim_scan(capped, ptr, chunk=c, device="cpu") for c in (1, 32))
    assert _series(a) == _series(b) and a.timings["ticks"] == b.timings["ticks"] == 45


def _gp_small(**over):
    """The port's own GP at a small size: 16 apps of up to 6 components,
    8 running (A*C = 48 rows a resource, so buckets 8, 16, 32 and the
    full table), 12-sample windows, 4 patterns of 4, 2 Adam steps."""
    return dataclasses.replace(TSimConfig(
        cluster=ClusterConfig(n_hosts=3, max_running_apps=8),
        workload=WorkloadConfig(n_apps=16, max_components=6, max_runtime=1800.0,
                                mean_burst_gap=2.0, mean_long_gap=40.0),
        window=12, gp=GPConfig(history=4, max_patterns=4, opt_steps=2), max_ticks=48), **over)


def _results(res):
    """Everything but the forecast rows, which count the buckets chosen."""
    return _series(res)[:-1]


def test_bucketed_forecast_off_is_bit_identical():
    """The counterpart of the reference's test of the same name: the
    bucketed forecast (ready rows only) gives the full batch's results,
    and the full batch counts every row of every forecasting tick."""
    cfg = _gp_small()
    on = tstep.run_sim_scan(cfg, chunk=16, device="cpu")
    off = tstep.run_sim_scan(dataclasses.replace(cfg, forecast_bucket=False), chunk=16,
                             device="cpu")
    assert _results(on) == _results(off)
    fr = off.forecast_rows
    assert fr["rows_bucketed"] == fr["ticks_forecasting"] * fr["rows_batch"]
    assert 0 < on.forecast_rows["rows_bucketed"] < fr["rows_bucketed"]
    assert on.forecast_rows["rows_ready"] == fr["rows_ready"] > 0


def test_bucketed_forecast_chunk_invariance(monkeypatch):
    """The counterpart of the reference's test of the same name: the
    bucket is re-chosen at every chunk boundary, so chunks of 7 and of 32
    run different bucket sequences, and the results are the same."""
    picked = []
    pick = tstep._pick_bucket
    monkeypatch.setattr(tstep, "_pick_bucket", lambda c, st: picked.append(pick(c, st))
                        or picked[-1])
    cfg = _gp_small()
    a = tstep.run_sim_scan(cfg, chunk=7, device="cpu")
    seven, picked[:] = list(picked), []
    b = tstep.run_sim_scan(cfg, chunk=32, device="cpu")
    assert _results(a) == _results(b)
    assert len(set(seven)) > 1 and seven != picked, (seven, picked)
    assert a.forecast_rows["rows_ready"] == b.forecast_rows["rows_ready"]


@pytest.mark.parametrize("forecaster", ["persist", "oracle"])
def test_cohort_equals_solo(forecaster):
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(
        dataclasses.replace(SMALL, forecaster=forecaster)))
    cohort = tstep.run_cohort_scan(pcfg, [0, 1, 2], device="cpu")
    for seed, res in zip([0, 1, 2], cohort):
        solo = tstep.run_sim_scan(dataclasses.replace(
            pcfg, workload=dataclasses.replace(pcfg.workload, seed=seed)), device="cpu")
        assert _series(res) == _series(solo), seed
    assert len({r.summary()["turnaround_mean"] for r in cohort}) == 3
    with pytest.raises(ValueError, match="disagree on shape"):
        tstep.run_cohort_scan(pcfg, [0, 1], device="cpu", wls=[
            build_trace(dataclasses.replace(SMALL.workload, n_apps=n)) for n in (24, 25)])


def test_unported_switches_raise():
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(SMALL))
    # calibration, the control plane, the telemetry rings and streamed
    # workloads are ported: the check takes them (the streamed runs:
    # tests/test_torch_stream.py)
    tstep._check_ported(dataclasses.replace(
        pcfg, calibration=dataclasses.replace(pcfg.calibration, enabled=True),
        control=dataclasses.replace(pcfg.control, enabled=True),
        obs=dataclasses.replace(pcfg.obs, enabled=True)))
    with pytest.raises(ValueError, match="unknown forecaster"):
        tstep.run_sim_scan(dataclasses.replace(pcfg, forecaster="lstm"), device="cpu")

    @dataclasses.dataclass(frozen=True)
    class StreamConfig:      # a look-alike of no registered family
        seed: int = 0

    with pytest.raises(TypeError, match="not a registered"):
        tstep.run_sim_scan(dataclasses.replace(pcfg, workload=StreamConfig()), device="cpu")


def test_run_sim_scan_defaults_to_cuda_and_raises_without_it(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(SMALL))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.run_sim_scan(pcfg)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        tstep.run_cohort_scan(pcfg, [0, 1])


# ----------------------------------------------------------------------
# one rounding for a * b + c (XLA:CPU contracts it into a fused
# multiply-add)
# ----------------------------------------------------------------------

_XLA_FMA = jax.jit(lambda a, b, c: a * b + c)


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _midpoint_triples():
    """(a, b, c, lower_odd): a * b exact in 25 bits on a float32 midpoint,
    c = +-2**-60 far below it, so the float64 sum is the midpoint itself
    and only c says which way the one rounding goes; ``lower_odd`` is the
    last bit of the float32 below the midpoint (ties-to-even goes up when
    it is 1)."""
    k, m = np.meshgrid(np.arange(0, 2**11, 7), np.arange(1, 2**12, 5), indexing="ij")
    a = (1 + k.ravel() * 2.0**-11).astype(np.float32)
    b = (1 + m.ravel() * 2.0**-12).astype(np.float32)
    p = a.astype(np.float64) * b
    q = p * np.where(p < 2, 2.0**24, 2.0**23)         # in half float32 ulps
    mid = (q == np.floor(q)) & (q % 2 == 1)
    a, b, q = a[mid], b[mid], q[mid]
    lower_odd = ((q - 1) / 2 % 2 == 1)
    sign = np.where(np.arange(a.size) % 2 == 0, 1.0, -1.0)
    return a, b, (sign * 2.0**-60).astype(np.float32), lower_odd


def _random_triples(n=100_000, seed=0):
    """Seeded float32 triples in the normal range, c within a few binades
    of a * b so that the sum cancels and rounds in every way.  (Subnormal
    inputs and results near 2**-126, which XLA:CPU flushes to zero, have
    cases of their own: chip_smoke's SUBNORMAL_ROWS and tiny_triples.)"""
    rng = np.random.default_rng(seed)

    def draw(lo, hi):
        return (rng.choice([-1.0, 1.0], n) * rng.uniform(1, 2, n)
                * 2.0 ** rng.integers(lo, hi, n)).astype(np.float32)
    a, b = draw(-8, 8), draw(-8, 8)
    c = (draw(-40, 4) * np.abs(a) * np.abs(b)).astype(np.float32)
    return a, b, c


def _fma_cases():
    one = np.float32(1 + 2**-12)
    yield "counterexample", (np.array([one], np.float32), np.array([one], np.float32),
                             np.array([2**-80], np.float32))
    a, b, c, lower_odd = _midpoint_triples()
    for odd in (False, True):
        for up in (False, True):
            sel = (lower_odd == odd) & ((c > 0) == up)
            yield f"midpoint lower_odd={odd} err>0={up}", (a[sel], b[sel], c[sel])
    yield "random", _random_triples()
    yield "subnormal rows", tuple(np.array(x, np.float32) for x in zip(*SUBNORMAL_ROWS))
    yield "near 2**-126", tiny_triples()


def test_random_triples_cover_both_parities_of_the_float64_sum():
    a, b, c = (x.astype(np.float64) for x in _random_triples())
    p = a * b
    s = p + c
    bp = s - p
    inexact = ((p - (s - bp)) + (c - bp)) != 0
    odd = (s.view(np.int64) & 1) == 1
    assert (inexact & odd).sum() > 1000 and (inexact & ~odd).sum() > 1000


@pytest.mark.parametrize("case", [name for name, _ in _fma_cases()])
def test_fma_equals_xla_fused_multiply_add(case):
    a, b, c = dict(_fma_cases())[case]
    assert a.size > 0
    want = _bits(_XLA_FMA(a, b, c))
    ta, tb, tc = map(torch.as_tensor, (a, b, c))
    np.testing.assert_array_equal(_bits(kops.fma_f32(ta, tb, tc)), want)
    np.testing.assert_array_equal(_bits(tstep._fma(ta, tb, tc)), want)
    if case == "counterexample":
        assert float(kops.fma_f32(ta, tb, tc)[0]).hex() == "0x1.0020020000000p+0"


def test_tiny_triples_flush_and_keep_results_near_2_to_the_minus_126():
    """The near-2**-126 triples hold every way XLA:CPU treats a tiny
    value: results flushed to +0 and -0, results 2**-126 kept (some of
    them below 2**-126 before rounding), subnormal a, b and c."""
    a, b, c = tiny_triples()
    want = np.asarray(_XLA_FMA(a, b, c))
    exact = a.astype(np.float64) * b + c
    assert ((want == 0) & np.signbit(want)).sum() > 1000
    assert ((want == 0) & ~np.signbit(want)).sum() > 1000
    assert (np.abs(want) == np.float32(TINY)).sum() > 1000
    assert ((np.abs(want) == np.float32(TINY)) & (np.abs(exact) < TINY)).sum() > 100
    for x in (a, b, c):
        assert ((x != 0) & (np.abs(x) < TINY)).sum() > 1000


@pytest.mark.parametrize("case", ["subnormal rows", "near 2**-126"])
def test_beta_flushes_subnormals_as_reference(case):
    """Eq. 9's beta, k1 * request + k2 * sigma, on the subnormal cases:
    request = a, k1 = b and a dynamic term equal to c (k2 = +-2**-100,
    var = (|c| * 2**100)**2, both exact), one call per (b, sign of c),
    against the jitted reference beta and, except at k1 = 1, the jitted
    a * b + c (at k1 = 1 XLA drops the multiplication by one and
    contracts k2 * sigma + request instead, so the subnormal c is an
    addend no more)."""
    from repro.core import shaper as rshaper
    from repro_torch.core import shaper as tshaper
    a, b, c = dict(_fma_cases())[case]
    want = _bits(_XLA_FMA(a, b, c))
    var = np.square(np.abs(c).astype(np.float64) * 2.0**100).astype(np.float32)
    assert np.array_equal(np.sqrt(var.astype(np.float64)) * 2.0**-100, np.abs(c))
    groups = 0
    for k1 in np.unique(b):
        for neg in (False, True):
            sel = (b == k1) & (np.signbit(c) == neg)
            if not sel.any():
                continue
            k2 = -(2.0**-100) if neg else 2.0**-100
            got = tshaper.beta(torch.as_tensor(a[sel]), torch.as_tensor(var[sel]),
                               tshaper.SafeguardConfig(float(k1), k2))
            ref_beta = jax.jit(lambda r, v: rshaper.beta(
                r, v, rshaper.SafeguardConfig(float(k1), k2)))(a[sel], var[sel])
            np.testing.assert_array_equal(_bits(got), _bits(ref_beta))
            if k1 != 1:
                np.testing.assert_array_equal(_bits(got), want[sel])
            groups += 1
    assert groups > (1 if case == "subnormal rows" else 30)


def test_fma_scalar_b_is_float32_and_b_broadcasts():
    """A scalar b is taken as float32 (JAX's weak type); a tensor b
    broadcasts against a and c, as at the usage interpolation."""
    a, _, c = _random_triples(4096, seed=1)
    b = 0.1                                  # not a float32: rounds to one first
    want = _bits(jax.jit(lambda a, c: a * b + c)(a, c))
    np.testing.assert_array_equal(
        _bits(tstep._fma(torch.as_tensor(a), b, torch.as_tensor(c))), want)
    a, c = a.reshape(16, 64, 4), c.reshape(16, 64, 4)
    frac = np.random.default_rng(2).random((16, 64, 1)).astype(np.float32)
    np.testing.assert_array_equal(
        _bits(tstep._fma(*map(torch.as_tensor, (a, frac, c)))), _bits(_XLA_FMA(a, frac, c)))


# ----------------------------------------------------------------------
# on the card (``-m gpu``)
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("forecaster", ["persist", "oracle"])
def test_card_equals_cpu(forecaster):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(
        dataclasses.replace(quick_base_config(), forecaster=forecaster)))
    cpu = tstep.run_cohort_scan(pcfg, [0, 1], device="cpu")
    gpu = tstep.run_cohort_scan(pcfg, [0, 1], device="cuda")
    for a, b in zip(gpu, cpu):
        assert _series(a) == _series(b)

@pytest.mark.gpu
def test_fma_kernel_equals_plain_version():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import fma, ref
    for _, (a, b, c) in _fma_cases():
        ta, tb, tc = map(torch.as_tensor, (a, b, c))
        want = _bits(ref.fma_f32(ta, tb, tc))
        got = fma.fma_f32(ta.cuda(), tb.cuda(), tc.cuda())
        np.testing.assert_array_equal(_bits(got.cpu()), want)
        got = fma.fma_f32(ta.cuda(), 0.1, tc.cuda())
        np.testing.assert_array_equal(_bits(got.cpu()), _bits(ref.fma_f32(ta, 0.1, tc)))
