"""Streamed ingestion (``repro_torch.sim.scenarios.stream``) against the
reference's (``repro.sim.scenarios.stream``) and against the port's own
materialized runs, on the CPU.

The config is the reference test's (``tests/test_replay_scale.py``): the
colocated family at 24 apps and 4 components, 16 slots on 3 hosts, persist
forecasts, chunks of 16 ticks and a window of 8 rows, which grows.  The
streamed runs hold the window's columns and lifecycle in the chunk
program's tensors and copy the new ones in at each boundary, as on the
card (where those tensors are a captured graph's); here every chunk runs
eagerly.  The full-length runs (3,728 ticks) are held to the reference;
the other checks run the first ``SHORT`` ticks, where the window is still
full of apps that have not finished.  One reference compile per program
and window width; the port on one torch thread (``test_torch_step``).
Port against reference as the other device-engine tests hold it
(``test_torch_leap._assert_reference``: every outcome equal, the metric
sums, float64 in the port and float32 trees in the reference, to rtol
1e-6); port against port bit for bit.
"""
import dataclasses

import jax  # noqa: F401  (every port test file imports both frameworks)
import numpy as np
import pytest

from repro.sim import ClusterConfig, SimConfig
from repro.sim import run_sim as ref_run_sim
from repro.sim.scenarios import StreamConfig as RefStream
from repro.sim.scenarios import build_trace as ref_build, make_config
from repro.sim.scenarios import stream as rstream
from repro.sim.step import run_cohort_scan as ref_cohort
from repro.sim.step import run_sim_scan as ref_scan
from repro.sim.sweep import run_grid as ref_grid
from repro_torch import convert
from repro_torch.sim import engine as tengine
from repro_torch.sim import sweep as tsweep
from repro_torch.sim.scenarios import StreamConfig, build_trace
from repro_torch.sim.scenarios import stream as tstream
from repro_torch.sim.step import run_cohort_scan, run_sim_scan
from test_torch_leap import _assert_reference
from test_torch_step import _assert_summary
from test_torch_step import _one_torch_thread  # noqa: F401  (autouse fixture)

WL = make_config("colocated", n_apps=24, max_components=4, seed=5)
BASE = SimConfig(cluster=ClusterConfig(n_hosts=3, max_running_apps=16),
                 workload=WL, policy="pessimistic", forecaster="persist",
                 max_ticks=4000)
SHORT = 600         # ticks of the shorter runs
CHUNK = 16


def _port(cfg, inner="colocated"):
    """The port's config of a reference config (streamed or not)."""
    if isinstance(cfg.workload, RefStream):
        return convert.sim_config_from_dict(dataclasses.asdict(cfg), workload="stream",
                                            inner=inner)
    return convert.sim_config_from_dict(dataclasses.asdict(cfg), workload=inner)


def _port_trace(wl):
    return convert.trace_from_arrays(**{f.name: getattr(wl, f.name)
                                        for f in dataclasses.fields(wl) if f.name != "cfg"})


def _results_equal(a, b) -> bool:
    return (a.summary() == b.summary()
            and a.turnaround == b.turnaround
            and a.failed_apps == b.failed_apps
            and a.util_cpu == b.util_cpu and a.util_mem == b.util_mem
            and a.n_running == b.n_running)


def _same_run(a, b) -> bool:
    """Two runs of the port, bit for bit: every result and series."""
    return (_results_equal(a, b) and a.slack_cpu == b.slack_cpu
            and a.slack_mem == b.slack_mem and a.forecast_rows == b.forecast_rows)


def _short(cfg, **kw):
    return dataclasses.replace(cfg, max_ticks=SHORT, **kw)


@pytest.mark.parametrize("leap", [False, True])
def test_streamed_equals_the_reference(leap):
    cfg = dataclasses.replace(BASE, leap=leap)
    wl = ref_build(WL)
    want_stats, got_stats = {}, {}
    want = rstream.run_sim_stream(cfg, wl, chunk=CHUNK, window=8, stats=want_stats)
    got = tstream.run_sim_stream(_port(cfg), build_trace(_port(cfg).workload), chunk=CHUNK,
                                 window=8, stats=got_stats, device="cpu")
    _assert_reference(got, want)
    assert got_stats == want_stats and got_stats["loaded"] == wl.n_apps
    assert got_stats["grows"] >= 1


@pytest.mark.parametrize("leap", [False, True])
def test_streamed_equals_materialized(leap):
    cfg = _port(_short(BASE, leap=leap))
    wl = build_trace(cfg.workload)
    mat = run_sim_scan(cfg, wl, chunk=CHUNK, device="cpu")
    stats = {}
    got = tstream.run_sim_stream(cfg, wl, chunk=CHUNK, window=8, stats=stats, device="cpu")
    assert _same_run(got, mat)
    assert mat.timings["ticks"] == got.timings["ticks"] == SHORT


def test_a_window_of_two_grows_and_still_equals():
    cfg = _short(BASE)
    want_stats, got_stats = {}, {}
    want = rstream.run_sim_stream(cfg, ref_build(WL), chunk=CHUNK, window=2, stats=want_stats)
    pcfg = _port(cfg)
    wl = build_trace(pcfg.workload)
    got = tstream.run_sim_stream(pcfg, wl, chunk=CHUNK, window=2, stats=got_stats,
                                 device="cpu")
    _assert_reference(got, want)
    assert got_stats == want_stats
    assert got_stats["grows"] >= 1 and got_stats["window_rows"] > 2
    assert _same_run(got, run_sim_scan(pcfg, wl, chunk=CHUNK, device="cpu"))


def test_stream_config_through_scan_and_cohort():
    scfg = _short(BASE, workload=RefStream(inner=WL, window=8))
    pcfg = _port(scfg)
    assert isinstance(pcfg.workload, StreamConfig)
    # run_sim_scan dispatches a StreamConfig to the streamed run
    got = run_sim_scan(pcfg, chunk=CHUNK, device="cpu")
    _assert_reference(got, ref_scan(scfg, chunk=CHUNK))
    assert _same_run(got, run_sim_scan(_port(_short(BASE)), chunk=CHUNK, device="cpu"))
    # a cohort of streamed members runs each solo, in its own window
    seeds = [0, 1]
    cohort = run_cohort_scan(pcfg, seeds, chunk=CHUNK, device="cpu")
    for s, a, b in zip(seeds, cohort, ref_cohort(scfg, seeds, chunk=CHUNK)):
        _assert_reference(a, b)
        solo = dataclasses.replace(
            pcfg, workload=dataclasses.replace(pcfg.workload.inner, seed=s))
        assert _same_run(a, run_sim_scan(solo, chunk=CHUNK, device="cpu")), s


def test_host_engine_materializes_the_stream():
    scfg = _short(BASE, workload=RefStream(inner=WL))
    pcfg = _port(scfg)
    got = tengine.run_sim(pcfg, build_trace(pcfg.workload), device="cpu")
    want = ref_run_sim(scfg, ref_build(scfg.workload))
    assert got.turnaround == want.turnaround and got.summary() == want.summary()
    mat = tengine.run_sim(_port(_short(BASE)), device="cpu")
    assert got.turnaround == mat.turnaround and got.summary() == mat.summary()


def test_run_grid_scan_engine_streams():
    scfg = _short(BASE, workload=RefStream(inner=WL, window=8))
    kw = dict(axes={"policy": ["baseline", "pessimistic"]}, seeds=[0], engine="scan",
              chunk=CHUNK, forecast_diag=False)
    got = tsweep.run_grid(_port(scfg), device="cpu", **kw)
    mat = tsweep.run_grid(_port(_short(BASE)), device="cpu", **kw)
    want = ref_grid(scfg, **kw)
    assert len(got.cells) == len(mat.cells) == len(want.cells) == 2
    for g, m, w in zip(got.cells, mat.cells, want.cells):
        assert g["summary"] == m["summary"], g["name"]
        _assert_summary(g["summary"], w["summary"])


def test_gp_streamed_equals_materialized():
    """The GP program's plain version on the streamed path (port only:
    the GP's decisions agree with the reference's only where ROADMAP
    queue 3 says)."""
    cfg = _port(dataclasses.replace(BASE, forecaster="gp", max_ticks=120))
    wl = build_trace(cfg.workload)
    mat = run_sim_scan(cfg, wl, chunk=CHUNK, device="cpu")
    got = tstream.run_sim_stream(cfg, wl, chunk=CHUNK, window=8, device="cpu")
    assert _same_run(got, mat)
    assert mat.forecast_rows["rows_ready"] > 0


def test_equal_submit_times_break_on_the_global_id():
    """Bursts of apps with one submit time: a streamed window re-keys rows,
    so the FIFO's tie between them must go by app id, as materialized."""
    wl = ref_build(WL)
    sub = np.asarray(wl.submit).copy()
    for lo, hi in ((4, 9), (12, 15), (18, 21)):
        sub[lo:hi] = sub[lo]
    tied = dataclasses.replace(wl, submit=sub)
    assert len(np.unique(sub)) == len(sub) - 8
    cfg = _short(BASE)
    want = rstream.run_sim_stream(cfg, tied, chunk=CHUNK, window=2)
    assert _results_equal(ref_scan(cfg, tied, chunk=CHUNK), want)
    pwl = _port_trace(tied)
    got = tstream.run_sim_stream(_port(cfg), pwl, chunk=CHUNK, window=2, device="cpu")
    _assert_reference(got, want)
    assert _same_run(got, run_sim_scan(_port(cfg), pwl, chunk=CHUNK, device="cpu"))


def _clocks():
    """(t0, tick) at binade edges and half-ulp ties, and past them."""
    out = []
    for tick in (60.0, 0.1, 1.0 / 3.0, 1.0):
        for edge in (2.0**10, 2.0**20, 2.0**23, 2.0**24):
            e = np.float32(edge)
            for t in (e - np.float32(tick), np.nextafter(e, np.float32(0)), e,
                      e - np.float32(3) * np.float32(tick)):
                out.append((float(t), tick))
        out.append((0.0, tick))
    # a half-ulp tie: t + tick lands halfway between two floats
    out.append((float(np.float32(2.0**24)), 1.0))
    out.append((float(np.float32(2.0**23 + 1)), 0.5))
    return out


def test_float32_clock_replay_equals_the_reference():
    for t0, tick in _clocks():
        for n in (0, 1, 3, 40):
            a, b = tstream._f32_ticks(t0, tick, n), rstream._f32_ticks(t0, tick, n)
            assert a.dtype == b.dtype and a.tobytes() == b.tobytes(), (t0, tick, n)
        for k in (0, 1, 2, 5, 100):
            h = float(rstream._f32_ticks(t0, tick, k))
            for hh in (h, float(np.nextafter(np.float32(h), np.float32(np.inf))),
                       float(np.nextafter(np.float32(h), np.float32(-np.inf)))):
                for limit in (0, 3, 200):
                    assert (tstream._ticks_below(t0, tick, hh, limit)
                            == rstream._ticks_below(t0, tick, hh, limit)), (t0, tick, hh)
    assert tstream._LEAP_SCOUT == rstream._LEAP_SCOUT and tstream._LIFE == rstream._LIFE
    assert tstream.auto_window(_port(BASE), 500) == rstream.auto_window(BASE, 500) == 64
