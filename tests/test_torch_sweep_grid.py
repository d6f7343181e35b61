"""Whole sweep grids: the port's ``repro_torch.sim.sweep.run_grid``
against the reference's ``repro.sim.sweep.run_grid`` on the CPU.

``quick_base_config``, two seeds, policy x forecaster over {baseline,
pessimistic} x {persist, oracle}: forecasts that both packages compute
alike, so the grid logic is exactly comparable (the GP's end-to-end
difference from the reference is held by ``test_torch_engine.py`` and
recorded in ROADMAP queue 3).  The host engine against the reference's
(``"vectorized"``); the device engine, with and without the telemetry
rings and through the shard engine's one-device fallback, against the
reference's scan engine with the rings (the reference holds its own
rings-off results equal to rings-on, so one reference run serves the
three).  Counters and discrete outcomes are exact, floats within rtol
1e-6 (the device engines' per-tick metric sums, ``test_torch_step.py``);
only ``wall_s`` and ``forecast_batches`` are left out.  The artifacts
written beside the results (manifest, alert log) carry the reference's
keys.
"""
import dataclasses
import json

import jax  # noqa: F401  (every port test file imports both frameworks)
import numpy as np
import pytest
import torch

from repro.obs import AlertRule as RAlertRule
from repro.sim import sweep as rsweep
from repro_torch.obs import AlertRule as TAlertRule
from repro_torch.sim import sweep as tsweep
from test_torch_engine import reference_config
from test_torch_step import _one_torch_thread  # noqa: F401

AXES = {"policy": ["baseline", "pessimistic"], "forecaster": ["persist", "oracle"]}
SEEDS = [0, 1]
# summary values that count or decide (exact); every other float within 1e-6
EXACT = {"completed", "n_apps", "failure_events", "oom_kills", "full_preemptions",
         "partial_preemptions", "failed_frac", "sim_hours"}
TIMES = ("wall_s", "forecast_batches")
# the stock rules and one that fires on these quiet cells (two or more
# preemptions in 4 ticks), so that the alert records and log are compared
RULE = dict(name="preempt-any", channel="preempt", detector="burst", threshold=1.0,
            severity="info", window=4)
RULES = {rsweep: rsweep.DEFAULT_RULES + (RAlertRule(**RULE),),
         tsweep: tsweep.DEFAULT_RULES + (TAlertRule(**RULE),)}


def _run(pkg, cfg, tmp, **kw):
    out = tmp / "BENCH_sweep.json"
    res = pkg.run_grid(cfg, AXES, seeds=SEEDS, out_path=str(out),
                       alert_log_path=str(tmp / "alerts.jsonl"), alert_rules=RULES[pkg],
                       **kw)
    files = {name: tmp / name for name in
             ("BENCH_sweep.json", "BENCH_sweep.manifest.json", "alerts.jsonl")}
    return res, files


@pytest.fixture(scope="module")
def reference(tmp_path_factory):
    """The reference's host-engine grid and its scan-engine grid with the
    rings, each once for the module (~9 s and ~23 s of its compiles)."""
    cfg = reference_config(tsweep.quick_base_config())
    return {engine: _run(rsweep, cfg, tmp_path_factory.mktemp(f"ref_{engine}"),
                         engine=engine, obs=engine == "scan")
            for engine in ("vectorized", "scan")}


def _close(got, want, path=""):
    """``got`` equals ``want`` leaf by leaf: dicts with the same keys,
    lists of the same length, floats within rtol 1e-6 (NaN equal) unless
    the key is in ``EXACT``, everything else equal."""
    if isinstance(want, dict):
        assert isinstance(got, dict) and got.keys() == want.keys(), \
            (path, sorted(set(got) ^ set(want)))
        for k in want:
            _close(got[k], want[k], f"{path}.{k}")
    elif isinstance(want, list):
        assert isinstance(got, list) and len(got) == len(want), path
        for i, (g, w) in enumerate(zip(got, want)):
            _close(g, w, f"{path}[{i}]")
    elif isinstance(want, float) and path.rsplit(".", 1)[-1] not in EXACT:
        np.testing.assert_allclose(got, want, rtol=1e-6, err_msg=path)
    else:
        assert got == want or (got != got and want != want), (path, got, want)


def _drop(d: dict, keys) -> dict:
    return {k: v for k, v in d.items() if k not in keys}


def _assert_grid_equal(got, want, *, obs: bool):
    """Every record of the results but the wall times and the batch
    count; without the port's rings, the reference's ring blocks aside."""
    g, w = (json.loads(json.dumps(r.to_json())) for r in (got, want))
    assert g.keys() == w.keys()
    w["base"]["gp"].pop("impl")
    if not obs:
        w["base"]["obs"]["enabled"] = False
    for k in w:
        if k in TIMES or k == "engine":
            continue
        if k == "cells":
            assert [c["name"] for c in g[k]] == [c["name"] for c in w[k]]
            for gc, wc in zip(g[k], w[k]):
                wc = _drop(wc, TIMES + (() if obs else ("obs",)))
                _close(_drop(gc, TIMES), wc, f"cells[{gc['name']},{gc['seed']}]")
        elif k == "aggregates":
            _close([_drop(a, TIMES) for a in g[k]], [_drop(a, TIMES) for a in w[k]], k)
        else:
            _close(g[k], w[k], k)
    assert any("turnaround_speedup" in a and a["overrides"]["policy"] == "pessimistic"
               for a in g["aggregates"])


def _key_sets(files) -> dict:
    """The top-level keys of the results and the manifest, and those of
    every alert-log line (None where no alert fired: no log is written)."""
    out = {name: sorted(json.loads(files[name].read_text()))
           for name in ("BENCH_sweep.json", "BENCH_sweep.manifest.json")}
    log = files["alerts.jsonl"]
    out["alerts"] = (sorted({k for line in log.read_text().splitlines()
                             for k in json.loads(line)}) if log.exists() else None)
    return out


def test_host_engine_grid_equals_reference(reference, tmp_path):
    want, want_files = reference["vectorized"]
    got, files = _run(tsweep, tsweep.quick_base_config(), tmp_path, device="cpu")
    _assert_grid_equal(got, want, obs=False)
    assert got.engine == want.engine == "vectorized"
    assert got.forecast_requests == want.forecast_requests == 0
    assert [c["summary"]["completed"] for c in got.cells] == [64] * 8
    assert "forecast_rows" not in got.cells[0] and len(got.forecast_error) == 1
    assert _key_sets(files) == _key_sets(want_files)


@pytest.mark.parametrize("engine,obs", [("scan", False), ("scan", True), ("shard", False)])
def test_device_engine_grid_equals_reference(reference, tmp_path, engine, obs, capsys):
    """The seed cohorts of the device engine: each cell's summary, its
    forecast-row counters and, with the rings, its ring block (scalars,
    compacted histories, alerts) equal the reference's; the shard engine
    falls back to scan on one device, as the reference's does."""
    want, want_files = reference["scan"]
    got, files = _run(tsweep, tsweep.quick_base_config(), tmp_path, device="cpu",
                      engine=engine, obs=obs,
                      dashboard_path=str(tmp_path / "dash.html") if obs else None)
    _assert_grid_equal(got, want, obs=obs)
    assert got.engine == "scan" and got.mesh_devices == want.mesh_devices == 0
    assert all(("obs" in c) == obs for c in got.cells)
    if obs:
        assert _key_sets(files) == _key_sets(want_files)
        assert sum(len(c["obs"]["alerts"]) for c in got.cells) > 0
        assert "<html" in (tmp_path / "dash.html").read_text().lower()
    if engine == "shard":
        assert "falling back to engine=scan" in capsys.readouterr().out


def test_refused_engines_and_devices(monkeypatch):
    base = tsweep.quick_base_config(n_apps=8, n_hosts=2)
    kw = dict(axes={"policy": ["pessimistic"]}, seeds=[0], device="cpu")
    with pytest.raises(ValueError, match="not ported"):
        tsweep.run_grid(base, engine="reference", **kw)
    with pytest.raises(ValueError, match="unknown engine"):
        tsweep.run_grid(base, engine="bogus", **kw)
    with pytest.raises(ValueError, match="empty sweep grid"):
        tsweep._run_grid(base, cells=[], axes=None, seeds=[], device="cpu")
    # two visible cards: the port runs a fleet on one device
    monkeypatch.setattr(tsweep, "device_count", lambda dev: 2)
    with pytest.raises(NotImplementedError, match="one device"):
        tsweep.run_grid(base, engine="shard", **kw)
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="CUDA"):
        tsweep.run_grid(base, axes={"policy": ["pessimistic"]}, seeds=[0])


def test_cli_writes_the_artifacts(tmp_path):
    """``python -m repro_torch.sim.sweep --device cpu`` end to end, small."""
    out = tmp_path / "s.json"
    res = tsweep.main(["--device", "cpu", "--policy", "baseline,pessimistic",
                       "--forecaster", "oracle", "--seeds", "1", "--apps", "12",
                       "--hosts", "2", "--engine", "scan", "--obs", "--out", str(out)])
    data = json.loads(out.read_text())
    assert data["schema"] == 3 and data["engine"] == "scan" and len(data["cells"]) == 2
    assert (tmp_path / "s.manifest.json").exists()
    assert [c["summary"] for c in data["cells"]] == [c["summary"] for c in res.cells]
    assert dataclasses.asdict(tsweep.quick_base_config(12, 2))["workload"]["n_apps"] == 12
