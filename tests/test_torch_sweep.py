"""The port's sweep pieces (``repro_torch.sim.sweep``, ``sim.metrics``,
``sim.scenarios.{fitting,diagnostics}``) against the reference's, on the
CPU.

Grid expansion, aggregation and trace statistics are host Python and
numpy on both sides: equal.  ``fit_trace`` of both replay fixtures gives
the same ``FittedConfig`` field by field, and the fitted family's trace
is bit-equal column by column.  The forecast diagnostics are equal to
rtol 1e-6 for persistence (numpy, then float32 reductions in another
order) and within the row tolerances of the port's forecasters for the
GP and ARIMA.  The batcher is the port's own: leader failure reaches
every follower, the idle signal comes once per idle tick, and a GP cell
run through it equals its solo run bit for bit.  Whole grids against the
reference's ``run_grid``: ``tests/test_torch_sweep_grid.py``.
"""
import dataclasses
import sys
import threading
from pathlib import Path

import jax  # noqa: F401  (every port test file imports both frameworks)
import numpy as np
import pytest
import torch

from repro.sim import SimConfig as RSimConfig
from repro.sim import metrics as rmetrics
from repro.sim import sweep as rsweep
from repro.sim.scenarios import diagnostics as rdiag
from repro.sim.scenarios import fitting as rfit
from repro.sim.scenarios import registry as rreg
from repro.sim.scenarios import replay as rrep
from repro_torch import convert
from repro_torch.kernels import nvcc
from repro_torch.sim import engine as tengine
from repro_torch.sim import metrics as tmetrics
from repro_torch.sim import sweep as tsweep
from repro_torch.sim.scenarios import diagnostics as tdiag
from repro_torch.sim.scenarios import fitting as tfit
from repro_torch.sim.scenarios import registry as treg
from repro_torch.sim.scenarios import replay as trep
from test_torch_engine import reference_config
from test_torch_scenarios import _assert_same_trace
from test_torch_step import _one_torch_thread  # noqa: F401

DATA = Path(__file__).resolve().parent / "data"
FIXTURES = (("alibaba_tiny.csv", "alibaba"), ("azure_tiny.csv", "azure"))
# the diagnostics' tolerance per forecaster.  Persistence is numpy on both
# sides until the coverage block's float32 means, summed in another order.
# The GP's rows agree to rtol 1e-3 (mean) and 5e-3 (variance) on windows
# with every point valid (tests/test_torch_forecast.py), ARIMA's to 1e-4
# of the row's scale (mean) and 1e-3 (variance, tests/test_torch_arima.py);
# the reports are quartiles, medians and means of those rows, so they
# take the variance's bound.  Largest seen (CPU, quick_base_config's
# trace): persist 1.1e-7, GP 5.9e-4 (median |z|), ARIMA 1.2e-6.
DIAG_RTOL = {"persist": 1e-6, "gp": 5e-3, "arima": 1e-3}


def _columns(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr) if f.name != "cfg"}


def _asdict(cfg) -> dict:
    """``dataclasses.asdict`` without the reference GP's ``impl``."""
    d = dataclasses.asdict(cfg)
    d["gp"].pop("impl", None)
    return d


# ----------------------------------------------------------------------
# grid expansion
# ----------------------------------------------------------------------

GRIDS = {
    "cross": dict(axes={"policy": ["baseline", "pessimistic"],
                        "forecaster": ["persist", "oracle"],
                        "safeguard.k1": [0.0, 0.05, 0.25]}, seeds=[0, 1]),
    "zipped": dict(axes={("policy", "forecaster"): [("baseline", "persist"),
                                                     ("pessimistic", "oracle")]},
                   seeds=[3], cells=[{"policy": "optimistic", "forecaster": "oracle"}]),
    "cells_only": dict(cells=[{"policy": "baseline"}, {"safeguard.k2": 1.0}]),
    "no_seeds": dict(axes={"policy": ["pessimistic"]}),
    "modes": dict(axes={"calibration": ["sigma", "conformal", "adaptive"],
                        "tenancy": ["off", "ungated", "wdrf", "credit"],
                        "calibration.q": [0.8]}, seeds=[0]),
    "scenario": dict(axes={"scenario": ["google", "diurnal", "heavytail", "fitted"],
                           "workload.n_apps": [40]}, seeds=[0, 5]),
}


@pytest.mark.parametrize("name", sorted(GRIDS))
def test_expand_grid_equals_reference(name):
    base = tsweep.quick_base_config(n_apps=24, n_hosts=3)
    got = tsweep.expand_grid(base, **GRIDS[name])
    want = rsweep.expand_grid(reference_config(base), **GRIDS[name])
    assert len(got) == len(want) > 0
    for g, w in zip(got, want):
        assert (g.name, g.overrides, g.seed, g.scenario) == \
            (w.name, w.overrides, w.seed, w.scenario)
        assert _asdict(g.cfg) == _asdict(w.cfg)
        assert type(g.cfg.workload).__name__ == type(w.cfg.workload).__name__


@pytest.mark.parametrize("bad, match", [
    (dict(axes={"calibration": ["bogus"]}), "unknown calibration mode"),
    (dict(axes={"tenancy": ["bogus"]}), "unknown tenancy mode"),
    (dict(axes={("policy", "forecaster"): [("baseline",)]}), "expects 2-tuples"),
])
def test_expand_grid_errors_follow_the_reference(bad, match):
    base = tsweep.quick_base_config()
    with pytest.raises(ValueError, match=match):
        tsweep.expand_grid(base, **bad)
    with pytest.raises(ValueError, match=match):
        rsweep.expand_grid(reference_config(base), **bad)


# ----------------------------------------------------------------------
# aggregation and trace statistics
# ----------------------------------------------------------------------

def test_aggregate_summaries_equals_reference():
    rng = np.random.default_rng(7)
    for n in (1, 2, 5):
        summaries = [{k: (float(rng.lognormal(5, 1)) if k.endswith(("mean", "median", "p95",
                                                                    "frac", "hours"))
                          else int(rng.integers(0, 50)))
                      for k in rmetrics.AGGREGATE_KEYS} for _ in range(n)]
        assert tmetrics.AGGREGATE_KEYS == rmetrics.AGGREGATE_KEYS
        assert (tmetrics.aggregate_summaries(summaries)
                == rmetrics.aggregate_summaries(summaries))


@pytest.mark.parametrize("family", ["google", "diurnal", "flashcrowd", "heavytail",
                                    "colocated"])
def test_trace_stats_equals_reference(family):
    want = rreg.build_trace(rreg.make_config(family, n_apps=50, seed=2))
    got = convert.trace_from_arrays(**_columns(want))
    assert tmetrics.trace_stats(got) == rmetrics.trace_stats(want)


# ----------------------------------------------------------------------
# the fitted family
# ----------------------------------------------------------------------

@pytest.mark.parametrize("fixture,preset", FIXTURES)
def test_fit_trace_equals_reference(fixture, preset):
    """Each fixture fitted by both packages: every field of the config
    equal, the fitted family's trace bit-equal at the fixture's length
    and scaled out, and the config carried across by ``convert``."""
    path = str(DATA / fixture)
    want = rfit.fit_trace(rrep.load_trace(path, preset=preset), n_apps=0, seed=0)
    got = tfit.fit_trace(trep.load_trace(path, preset=preset), n_apps=0, seed=0)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    for f in dataclasses.fields(want):
        g, w = getattr(got, f.name), getattr(want, f.name)
        assert type(g) is type(w) and g == w, f.name
    assert isinstance(got.comp_weights, tuple) and hash(got)
    for n_apps, seed in ((0, 0), (500, 3)):
        over = {"seed": seed, **({"n_apps": n_apps} if n_apps else {})}
        _assert_same_trace(treg.build_trace(dataclasses.replace(got, **over)),
                           rreg.build_trace(dataclasses.replace(want, **over)))
    # through the registry and the config converter, from asdict and from JSON
    assert treg.scenario_of(got) == "fitted" and treg.get("fitted").build is tfit._build
    cfg = dataclasses.replace(RSimConfig(), workload=want)
    d = dataclasses.asdict(cfg)
    pcfg = convert.sim_config_from_dict(d, workload="fitted")
    assert pcfg.workload == got
    d["workload"]["comp_weights"] = list(d["workload"]["comp_weights"])
    assert convert.sim_config_from_dict(d, workload="fitted").workload == got
    assert treg.make_config("fitted", base=got, seed=4) == dataclasses.replace(got, seed=4)


# ----------------------------------------------------------------------
# forecast diagnostics
# ----------------------------------------------------------------------

def _leaves(d, path=""):
    if isinstance(d, dict):
        for k, v in d.items():
            yield from _leaves(v, f"{path}.{k}")
    elif isinstance(d, list):
        for i, v in enumerate(d):
            yield from _leaves(v, f"{path}[{i}]")
    else:
        yield path, d


def _worst(got, want, rtol) -> float:
    """Largest relative difference of two records' float leaves, after
    holding the other leaves equal and every float within ``rtol``."""
    g, w = dict(_leaves(got)), dict(_leaves(want))
    assert g.keys() == w.keys()
    worst = 0.0
    for k, b in w.items():
        a = g[k]
        if isinstance(b, float):
            np.testing.assert_allclose(a, b, rtol=rtol, err_msg=k)
            if b:
                worst = max(worst, abs(a - b) / abs(b))
        else:
            assert type(a) is type(b) and a == b, k
    return worst


@pytest.mark.parametrize("forecaster", ["persist", "gp", "arima"])
def test_forecast_reports_equal_reference(forecaster):
    """Both records of ``forecast_reports`` (the error quartiles and the
    Gaussian-vs-conformal coverage) on quick_base_config's trace, with
    and without the coverage block; oracle has none."""
    base = tsweep.quick_base_config()
    rcfg = reference_config(base)
    tr = rreg.build_trace(rcfg.workload)
    ptr = convert.trace_from_arrays(**_columns(tr))
    worst = 0.0
    for coverage in (True, False):
        want = rdiag.forecast_reports(tr, forecaster, window=rcfg.window, coverage=coverage,
                                      gp=rcfg.gp, arima=rcfg.arima)
        got = tdiag.forecast_reports(ptr, forecaster, window=base.window, coverage=coverage,
                                     gp=base.gp, arima=base.arima, device="cpu")
        assert (got[1] is None) == (want[1] is None) == (not coverage)
        worst = max(worst, _worst([r for r in got if r], [r for r in want if r],
                                  DIAG_RTOL[forecaster]))
    print(f"{forecaster}: largest relative difference {worst:.3g} "
          f"(tolerance {DIAG_RTOL[forecaster]})")
    assert tdiag.forecast_reports(ptr, "oracle", device="cpu") == (None, None)
    np.testing.assert_array_equal(tdiag.sample_usage_series(ptr, 5, 30, seed=2),
                                  rdiag.sample_usage_series(tr, 5, 30, seed=2))


def test_k2_nominal_has_the_reference_bits():
    from jax.scipy.stats import norm
    want = np.asarray(norm.cdf(3.0))
    assert want.dtype == np.float32
    assert np.float32(tdiag.K2_NOMINAL).view(np.int32) == want.view(np.int32)
    assert tdiag.K2_NOMINAL == float(want)


def test_diagnostics_default_to_cuda_and_raise_without_it(monkeypatch):
    tr = treg.build_trace(treg.make_config("google", n_apps=8))
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    for fc in ("persist", "gp"):
        with pytest.raises(RuntimeError, match="CUDA"):
            tdiag.forecast_reports(tr, fc)


# ----------------------------------------------------------------------
# the cross-sim forecast batcher
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["leader", "barrier"])
def test_batcher_propagates_leader_failure(monkeypatch, mode):
    """A failing forecast must raise in EVERY participating sim instead of
    deadlocking followers on their never-set events."""
    monkeypatch.setattr(tsweep, "forecast_peaks",
                        lambda *a, **k: (_ for _ in ()).throw(RuntimeError("boom")))
    batcher = tsweep.ForecastBatcher(wait_s=0.05, mode=mode, barrier_timeout_s=0.05)
    cfg = dataclasses.replace(tsweep.quick_base_config(), forecaster="gp")
    clients = [batcher.client(cfg, "cpu") for _ in range(2)]
    wins = np.zeros((2, cfg.window), np.float32)
    val = np.ones((2, cfg.window), bool)
    errs = []

    def call(c):
        try:
            c(wins, val)
        except RuntimeError as e:
            errs.append(str(e))

    threads = [threading.Thread(target=call, args=(c,)) for c in clients]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=10)
    assert not any(t.is_alive() for t in threads), "batcher deadlocked"
    assert errs == ["boom", "boom"]


def test_batcher_clients_by_forecaster():
    batcher = tsweep.ForecastBatcher()
    base = tsweep.quick_base_config()
    assert batcher.client(dataclasses.replace(base, forecaster="oracle"), "cpu") is None
    assert isinstance(batcher.client(dataclasses.replace(base, forecaster="persist"), "cpu"),
                      tengine._BatchedForecaster)
    gp = batcher.client(dataclasses.replace(base, forecaster="gp"), "cpu")
    arima = batcher.client(dataclasses.replace(base, forecaster="arima"), "cpu")
    assert gp._key != arima._key and batcher._clients == {gp._key: 1, arima._key: 1}
    gp.close()
    arima.close()
    with pytest.raises(ValueError, match="unknown batch mode"):
        tsweep.ForecastBatcher(mode="bogus")


class _CountingClient:
    """A forecast client with the batcher's ``idle`` signal, counting
    both."""

    def __init__(self, cfg):
        self.inner = tengine._BatchedForecaster(cfg, torch.device("cpu"))
        self.calls = self.idles = 0

    def __call__(self, windows, valid):
        self.calls += 1
        return self.inner(windows, valid)

    def idle(self):
        self.idles += 1


@pytest.mark.parametrize("policy", ["pessimistic", "baseline"])
def test_idle_signal_once_per_idle_tick(policy):
    """Every tick either forecasts once or signals idle once, and the
    signal changes nothing of the run."""
    cfg = dataclasses.replace(tsweep.quick_base_config(n_apps=24, n_hosts=3),
                              forecaster="persist", policy=policy)
    client = _CountingClient(cfg)
    res = tengine.run_sim(cfg, forecast_fn=client, device="cpu")
    assert client.calls + client.idles == res.timings["ticks"]
    assert client.idles > 0 and (client.calls > 0) == (policy != "baseline")
    assert res.summary() == tengine.run_sim(cfg, device="cpu").summary()


def _same_run(a, b) -> bool:
    return (a.summary() == b.summary() and a.turnaround == b.turnaround
            and a.failed_apps == b.failed_apps and a.util_mem == b.util_mem
            and a.slack_cpu == b.slack_cpu and a.n_running == b.n_running)


@pytest.mark.parametrize("mode", ["leader", "barrier"])
def test_gp_cells_through_the_batcher_equal_solo_runs(mode):
    """Three GP cells (two pessimistic seeds and a baseline cell sharing
    their batch key) on threads through one batcher: each equals its solo
    run bit for bit, and rounds held more than one request."""
    base = dataclasses.replace(tsweep.quick_base_config(n_apps=24, n_hosts=3),
                               forecaster="gp", max_ticks=40)
    cells = [dataclasses.replace(base, workload=dataclasses.replace(base.workload, seed=s),
                                 policy=p)
             for s, p in ((0, "pessimistic"), (1, "pessimistic"), (0, "baseline"))]
    # generous waits: on the CPU a GP tick takes milliseconds, and a round
    # that fires before the other sims arrive holds one request
    batcher = tsweep.ForecastBatcher(mode=mode, wait_s=0.5, barrier_timeout_s=2.0)
    clients = [batcher.client(c, "cpu") for c in cells]
    out = [None] * len(cells)

    def run(i):
        try:
            out[i] = tengine.run_sim(cells[i], forecast_fn=clients[i], device="cpu")
        finally:
            clients[i].close()

    threads = [threading.Thread(target=run, args=(i,)) for i in range(len(cells))]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=120)
    assert not any(t.is_alive() for t in threads)
    for cfg, res in zip(cells, out):
        assert _same_run(res, tengine.run_sim(cfg, device="cpu"))
    assert 0 < batcher.batches < batcher.requests


def test_launch_counts_survive_threads():
    """The host grid's threads add to the kernels' shared launch counts
    through ``nvcc.count``, under its lock: no update is lost, with more
    threads than cores switching every microsecond."""
    def wrapper():
        pass
    wrapper.launches = 0
    n_threads, n_each = 32, 2000

    def launch():
        for _ in range(n_each):
            nvcc.count(wrapper)

    old = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        threads = [threading.Thread(target=launch) for _ in range(n_threads)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
    finally:
        sys.setswitchinterval(old)
    assert not any(t.is_alive() for t in threads)
    assert wrapper.launches == n_threads * n_each
