"""Sweep fleets on one device (``repro_torch.sim.shard``,
``repro_torch.sim.step.run_fleet_shard``) against the reference's
(``repro.sim.shard``, ``repro.sim.step.run_fleet_shard``), on the CPU.

The reference's single-device cases (``tests/test_shard.py``), its
``group_fleets`` on the grid of its four-device test (the function needs
no device), and its streamed fleet (``tests/test_replay_scale.py``).  A
fleet of two or more members is one cohort batch: each member equals its
solo run bit for bit, and the cohort's ``rows_bucketed`` is its largest
member's bucket (ROADMAP queue 3).  Port against reference as
``test_torch_leap._assert_reference`` holds it; port against port bit for
bit.
"""
import dataclasses

import jax  # noqa: F401  (every port test file imports both frameworks)
import pytest
import torch

from repro.sim import ClusterConfig, SimConfig, WorkloadConfig
from repro.sim import shard as rshard
from repro.sim import step as rstep
from repro.sim import sweep as rsweep
from repro.sim.scenarios import StreamConfig as RefStream
from repro.sim.scenarios import build_trace as ref_build, make_config
from repro_torch import convert
from repro_torch.sim import shard as tshard
from repro_torch.sim import step as tstep
from repro_torch.sim import sweep as tsweep
from repro_torch.sim.scenarios import build_trace
from test_torch_leap import _assert_reference
from test_torch_step import _assert_summary
from test_torch_step import _one_torch_thread  # noqa: F401  (autouse fixture)
from test_torch_stream import _same_run

WL = WorkloadConfig(n_apps=20, max_components=5, max_runtime=1200.0,
                    mean_burst_gap=4.0, mean_long_gap=60.0, seed=3)
CL = ClusterConfig(n_hosts=3, max_running_apps=12)
BASE = SimConfig(cluster=CL, workload=WL, max_ticks=2500,
                 policy="pessimistic", forecaster="persist")
CHUNK = 16


def _port(cfg, workload="google", inner=None):
    return convert.sim_config_from_dict(dataclasses.asdict(cfg), workload=workload,
                                        inner=inner)


def test_mesh1_matches_cohort_and_the_reference():
    seeds = [0, 1, 2]
    cfg = _port(BASE)
    fleet = tstep.run_fleet_shard(cfg, seeds, chunk=CHUNK, mesh=1, device="cpu")
    cohort = tstep.run_cohort_scan(cfg, seeds, chunk=CHUNK, device="cpu")
    want = rstep.run_fleet_shard(BASE, seeds, chunk=CHUNK, mesh=1)
    assert len(fleet) == len(seeds)
    for s, a, b, w in zip(seeds, fleet, cohort, want):
        assert _same_run(a, b), s
        _assert_reference(a, w)
        solo = dataclasses.replace(cfg, workload=dataclasses.replace(cfg.workload, seed=s))
        assert _same_run(a, tstep.run_sim_scan(solo, chunk=CHUNK, device="cpu")), s


def test_explicit_cfgs_cross_scenario_fleet():
    other = dataclasses.replace(BASE, workload=make_config("flashcrowd", base=WL))
    pbase, pother = _port(BASE), _port(other, "flashcrowd")
    fleet = tstep.run_fleet_shard(pbase, cfgs=[pbase, pother], chunk=CHUNK, mesh=1,
                                  device="cpu")
    want = rstep.run_fleet_shard(BASE, cfgs=[BASE, other], chunk=CHUNK, mesh=1)
    for got, w, solo in zip(fleet, want, (pbase, pother)):
        assert _same_run(got, tstep.run_sim_scan(solo, chunk=CHUNK, device="cpu"))
        _assert_reference(got, w)


def test_fleet_rejects_heterogeneity_shapes_and_wide_meshes(monkeypatch):
    cfg = _port(BASE)
    other = dataclasses.replace(cfg, policy="baseline")
    with pytest.raises(ValueError, match="beyond its workload"):
        tstep.run_fleet_shard(cfg, cfgs=[cfg, other], device="cpu")
    bigger = dataclasses.replace(cfg, workload=dataclasses.replace(
        cfg.workload, seed=1, n_apps=WL.n_apps + 1))
    with pytest.raises(ValueError, match="shape"):
        tstep.run_fleet_shard(cfg, cfgs=[cfg, bigger], device="cpu")
    with pytest.raises(ValueError, match="pass seeds or cfgs"):
        tstep.run_fleet_shard(cfg, device="cpu")
    assert tstep.run_fleet_shard(cfg, [], device="cpu") == []
    # one device visible on the CPU: a mesh of 2 is wider than it
    assert tshard.device_count(torch.device("cpu")) == 1
    with pytest.raises(ValueError, match="visible"):
        tstep.run_fleet_shard(cfg, [0, 1], mesh=2, device="cpu")
    # two visible devices: the port runs a fleet on one
    monkeypatch.setattr(tstep, "device_count", lambda dev: 2)
    with pytest.raises(NotImplementedError, match="one device"):
        tstep.run_fleet_shard(cfg, [0, 1], mesh=2, device="cpu")
    with pytest.raises(NotImplementedError, match="one device"):
        tstep.run_fleet_shard(cfg, [0, 1], device="cpu")


def test_forecast_rows_telemetry():
    res = tstep.run_fleet_shard(_port(BASE), [0, 1], chunk=CHUNK, mesh=1, device="cpu")[0]
    want = rstep.run_fleet_shard(BASE, [0, 1], chunk=CHUNK, mesh=1)[0]
    fr = res.forecast_rows
    A, C = CL.max_running_apps, WL.max_components
    assert fr["rows_batch"] == 2 * A * C
    assert 0 < fr["rows_ready"] <= fr["rows_batch"] * fr["ticks"]
    assert 0 < fr["ticks_forecasting"] <= fr["ticks"]
    assert "forecast_rows" not in res.summary()
    # the cohort's rows_bucketed, as the reference's cohort counts it
    assert fr == want.forecast_rows


def _grid(sweep, base):
    return sweep.expand_grid(base, axes={"scenario": ["google", "flashcrowd"],
                                         "policy": ["baseline", "pessimistic"]},
                             seeds=[0, 1])


def test_group_fleets_groups_the_cells_as_the_reference():
    rbase = rsweep.quick_base_config(n_apps=20, n_hosts=3, seed=0)
    pbase = tsweep.quick_base_config(n_apps=20, n_hosts=3, seed=0)
    rgrid, pgrid = _grid(rsweep, rbase), _grid(tsweep, pbase)
    want = rshard.group_fleets(rgrid, {c.cfg.workload: ref_build(c.cfg.workload)
                                       for c in rgrid})
    got = tshard.group_fleets(pgrid, {c.cfg.workload: build_trace(c.cfg.workload)
                                      for c in pgrid})
    key = [[(c.name, c.seed) for c in f] for f in got]
    assert key == [[(c.name, c.seed) for c in f] for f in want]
    assert sorted(len(f) for f in got) == [4, 4]


def test_run_shard_records_equal_solo_runs_and_the_reference():
    rbase = rsweep.quick_base_config(n_apps=16, n_hosts=3, seed=0)
    pbase = tsweep.quick_base_config(n_apps=16, n_hosts=3, seed=0)
    axes = {"scenario": ["google", "flashcrowd"], "policy": ["pessimistic"],
            "forecaster": ["persist"]}
    rgrid = rsweep.expand_grid(rbase, axes=axes, seeds=[0])
    pgrid = tsweep.expand_grid(pbase, axes=axes, seeds=[0])
    record = lambda cell, res, wall: {"name": cell.name, "summary": res.summary()}  # noqa: E731
    lines = []
    got = tshard.run_shard_records(pgrid, {c.cfg.workload: build_trace(c.cfg.workload)
                                           for c in pgrid}, record, chunk=CHUNK, mesh=1,
                                   log=lines.append, device="cpu")
    want = rshard.run_shard_records(rgrid, {c.cfg.workload: ref_build(c.cfg.workload)
                                            for c in rgrid}, record, chunk=CHUNK, mesh=1)
    assert [r["name"] for r in got] == [r["name"] for r in want] == [c.name for c in pgrid]
    assert len(lines) == 1 and "fleet[2 cells]" in lines[0]
    for r, w, cell in zip(got, want, pgrid):
        _assert_summary(r["summary"], w["summary"])
        solo = tstep.run_sim_scan(cell.cfg, chunk=CHUNK, device="cpu")
        assert r["summary"] == solo.summary(), cell.name


def test_sweep_shard_falls_back_to_scan_on_one_device(capsys):
    pbase = tsweep.quick_base_config(n_apps=20, n_hosts=3, seed=0)
    kw = dict(axes={"policy": ["pessimistic"], "forecaster": ["persist"]}, seeds=[0, 1],
              engine="shard", mesh=4)
    res = tsweep.run_grid(pbase, device="cpu", **kw)
    assert res.engine == "scan" and res.mesh_devices == 0
    assert "falling back" in capsys.readouterr().out
    want = rsweep.run_grid(rsweep.quick_base_config(n_apps=20, n_hosts=3, seed=0), **kw)
    assert want.engine == "scan"
    for g, w in zip(res.cells, want.cells):
        _assert_summary(g["summary"], w["summary"])


def test_streamed_fleet_equals_the_materialized_fleet():
    swl = make_config("colocated", n_apps=24, max_components=4, seed=5)
    base = SimConfig(cluster=ClusterConfig(n_hosts=3, max_running_apps=16), workload=swl,
                     policy="pessimistic", forecaster="persist", max_ticks=600)
    scfg = dataclasses.replace(base, workload=RefStream(inner=swl, window=8))
    seeds = [0, 1]
    mat = tstep.run_fleet_shard(_port(base, "colocated"), seeds, chunk=CHUNK, mesh=1,
                                device="cpu")
    stream = tstep.run_fleet_shard(_port(scfg, "stream", "colocated"), seeds, chunk=CHUNK,
                                   mesh=1, device="cpu")
    want = rstep.run_fleet_shard(scfg, seeds, chunk=CHUNK, mesh=1)
    assert len(mat) == len(stream) == len(seeds)
    for m, s, w in zip(mat, stream, want):
        assert _same_run(m, s)
        _assert_reference(s, w)
