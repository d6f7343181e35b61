"""Batched experiment sweeps over the simulator (paper Figs. 3-4 grids).

Counterpart of ``repro/sim/sweep.py``, with the same names, the same
records and the same ``BENCH_sweep.json`` schema 3.  The paper's
headline results are *grids* — policy x forecaster x safeguard (K1, K2)
x **scenario** x seed.  This module makes that space enumerable in one
process:

  * ``expand_grid``      — cross-product a base ``SimConfig`` with axes
                           (dotted override paths, zipped tuple axes,
                           explicit cells) and seeds.  The special axis
                           key ``"scenario"`` swaps the base workload
                           for another registered family (diurnal,
                           flashcrowd, heavytail, colocated, replay,
                           fitted), carrying over the shared scale knobs
                           (``n_apps``, ``max_components``, ``seed``);
  * ``ForecastBatcher``  — stacks the forecast windows of all
                           concurrently running host-engine sims into one
                           padded batch on the device: one GP program
                           (or ARIMA) launch per round instead of one
                           per sim.  Rows are independent, so results
                           are bit-identical to solo runs;
  * ``run_grid``         — deterministic-per-seed driver that runs every
                           cell, aggregates ``SimResults`` into the
                           paper's metrics (median turnaround speedup vs
                           the SAME scenario's baseline, failure rate,
                           utilization), attaches per-scenario trace
                           statistics and forecast-error diagnostics,
                           and writes a machine-readable
                           ``BENCH_sweep.json``.

Every engine call, batcher client and diagnostic runs on ``device``:
CUDA unless the caller asks for the CPU.  Engines: ``"vectorized"`` is
the host engine ``run_sim`` on a thread pool, the cells sharing the
batcher; ``"scan"`` the device engine, each combo's seed cohort one
``run_cohort_scan`` batch, the combos in sequence (a captured graph
serves one run at a time, so the device engine never runs on threads);
``"shard"`` falls back to ``"scan"`` on one visible device, as the
reference's does, and raises ``NotImplementedError`` on two or more (the
port runs a fleet on one device: ``repro_torch.sim.shard``);
``"reference"`` is refused (the JAX package's frozen seed loop is its own
anchor).

CLI::

    python -m repro_torch.sim.sweep --policy baseline,pessimistic \\
        --forecaster persist,oracle \\
        --scenario google,diurnal,flashcrowd,heavytail,colocated \\
        --seeds 2 --device cpu --out BENCH_sweep.json
"""
from __future__ import annotations

import argparse
import contextlib
import dataclasses
import itertools
import json
import os
import threading
import time
from typing import Any, Mapping, Sequence

import numpy as np
import torch

from repro_torch.device import resolve_device
from repro_torch.obs import (DEFAULT_RULES, REGISTRY, bucketed_row_overhead,
                             build_manifest, compact_history, evaluate_rules,
                             masked_row_overhead, obs_summary, render_dashboard,
                             span, tracing, write_alert_log, write_manifest)
from repro_torch.sim.cluster import ClusterConfig
from repro_torch.sim.engine import (SimConfig, _BatchedForecaster, _make_model,
                                    forecast_peaks, run_sim)
from repro_torch.sim.metrics import aggregate_summaries, trace_stats
from repro_torch.sim.scenarios import build_trace, make_config, scenario_of
from repro_torch.sim.scenarios.diagnostics import forecast_reports
from repro_torch.sim.shard import device_count
from repro_torch.sim.workload import WorkloadConfig

__all__ = ["SweepCell", "SweepResult", "ForecastBatcher", "expand_grid",
           "run_grid", "quick_base_config", "main"]


# ----------------------------------------------------------------------
# grid expansion
# ----------------------------------------------------------------------

def _set_path(cfg: Any, path: str, value: Any) -> Any:
    """Functional update of a dotted field path on nested frozen
    dataclasses, e.g. ``_set_path(cfg, "safeguard.k1", 0.25)``."""
    head, _, rest = path.partition(".")
    if rest:
        return dataclasses.replace(
            cfg, **{head: _set_path(getattr(cfg, head), rest, value)})
    return dataclasses.replace(cfg, **{head: value})


# the "calibration" axis sweeps safeguard *modes* by name: the paper's
# fixed K2-sigma band, the conformal calibrated band, and the adaptive
# (budget-tracking) controller.  Field-level knobs remain reachable via
# dotted paths ("calibration.q", "calibration.budget", ...).
CALIBRATION_MODES: dict[str, dict] = {
    "sigma": dict(enabled=False, adaptive=False),
    "conformal": dict(enabled=True, adaptive=False),
    "adaptive": dict(enabled=True, adaptive=True),
}


# the "tenancy" axis sweeps control-plane *modes* by name: fully off
# (bit-identical to the engines without the control plane),
# accounting-only (shares/credit observed, nobody throttled), the wDRF
# admission gate, and the gate with credit-aware shaping on top.
# Field-level knobs remain reachable via dotted paths ("control.slack", ...).
TENANCY_MODES: dict[str, dict] = {
    "off": dict(enabled=False),
    "ungated": dict(enabled=True, gate=False, credit=False),
    "wdrf": dict(enabled=True, gate=True, credit=False),
    "credit": dict(enabled=True, gate=True, credit=True),
}


def _apply_overrides(cfg: SimConfig, overrides: Mapping[str, Any]) -> SimConfig:
    # "scenario" swaps the whole workload config and must resolve before
    # any "workload.*" field override can land on the new family
    if "scenario" in overrides:
        cfg = dataclasses.replace(
            cfg, workload=make_config(overrides["scenario"],
                                      base=cfg.workload))
    for path, value in overrides.items():
        if path == "scenario":
            continue
        if path == "calibration" and isinstance(value, str):
            if value not in CALIBRATION_MODES:
                raise ValueError(
                    f"unknown calibration mode {value!r} "
                    f"(expected {sorted(CALIBRATION_MODES)})")
            cfg = dataclasses.replace(
                cfg, calibration=dataclasses.replace(
                    cfg.calibration, **CALIBRATION_MODES[value]))
            continue
        if path == "tenancy" and isinstance(value, str):
            if value not in TENANCY_MODES:
                raise ValueError(
                    f"unknown tenancy mode {value!r} "
                    f"(expected {sorted(TENANCY_MODES)})")
            cfg = dataclasses.replace(
                cfg, control=dataclasses.replace(
                    cfg.control, **TENANCY_MODES[value]))
            continue
        cfg = _set_path(cfg, path, value)
    return cfg


def _cell_name(overrides: Mapping[str, Any]) -> str:
    return ",".join(f"{k}={v}" for k, v in overrides.items()) or "base"


@dataclasses.dataclass(frozen=True)
class SweepCell:
    """One (configuration, seed) point of the grid."""

    name: str                  # combo label, shared across seeds
    overrides: dict            # dotted-path -> value, applied to the base
    seed: int
    cfg: SimConfig             # fully resolved (overrides + seed applied)
    scenario: str = "google"   # registry name of cfg.workload's family


def expand_grid(base: SimConfig,
                axes: Mapping[Any, Sequence[Any]] | None = None,
                seeds: Sequence[int] | None = None,
                cells: Sequence[Mapping[str, Any]] | None = None
                ) -> list[SweepCell]:
    """Cross product of ``axes`` (plus explicit ``cells``) x ``seeds``.

    ``axes`` maps an override path to its values.  A key may also be a
    tuple of paths whose values are tuples, zipped together — e.g.
    ``{("policy", "forecaster"): [("baseline", "persist"),
    ("pessimistic", "oracle")]}`` for the paper's paired Fig. 3 axis.
    ``seeds`` replace ``workload.seed``; ``None`` keeps the base seed.
    """
    combos: list[dict] = []
    axis_items = list((axes or {}).items())
    keys = [k if isinstance(k, tuple) else (k,) for k, _ in axis_items]
    # no axes + explicit cells = a cells-only grid (the zero-axis product
    # would otherwise smuggle in a spurious bare-base combo)
    if axis_items or not cells:
        for values in itertools.product(*(v for _, v in axis_items)):
            combo: dict = {}
            for ks, v in zip(keys, values):
                vs = v if isinstance(v, tuple) else (v,)
                if len(ks) != len(vs):
                    raise ValueError(f"axis {ks} expects {len(ks)}-tuples, "
                                     f"got {v!r}")
                combo.update(zip(ks, vs))
            combos.append(combo)
    combos.extend(dict(c) for c in cells or ())

    out = []
    for combo in combos:
        cfg = _apply_overrides(base, combo)
        scen = scenario_of(cfg.workload)
        for seed in (seeds if seeds is not None else (None,)):
            scfg = cfg if seed is None else _set_path(
                cfg, "workload.seed", int(seed))
            out.append(SweepCell(name=_cell_name(combo), overrides=combo,
                                 seed=scfg.workload.seed, cfg=scfg,
                                 scenario=scen))
    return out


# ----------------------------------------------------------------------
# cross-sim forecast batching
# ----------------------------------------------------------------------

class _Request:
    __slots__ = ("windows", "valid", "event", "result")

    def __init__(self, windows: np.ndarray, valid: np.ndarray):
        self.windows = windows
        self.valid = valid
        self.event = threading.Event()
        self.result = None


class ForecastBatcher:
    """Stacks concurrent forecast requests from many sims into one padded
    forecast on the device.

    Sims sharing a forecaster model (same frozen config, horizon, window
    width, device) land in the same batch key.  The first requester of a
    round becomes the leader: it waits until every *registered* sim of
    that key has a request pending (or a timeout elapses — a sim in its
    grace period requests nothing), concatenates the windows, runs ONE
    padded ``forecast_peaks`` (one ``gp_fit_forecast`` or
    ``arima_forecast`` launch on the card), and distributes the row
    slices.  Each row's forecast depends on that row alone, so every sim
    receives bit-identical values to a solo run.

    Two batching modes (results are identical either way — the mode only
    trades wall-clock against batch occupancy):

    * ``leader`` (default): the leader waits at most ``wait_s`` (2 ms) —
      low latency, but heterogeneous grids often fire partial cohorts;
    * ``barrier``: tick-synchronous — the leader waits up to
      ``barrier_timeout_s`` for the FULL registered cohort, so
      homogeneous grids (same forecaster/shape across cells, sims
      ticking in lockstep) batch whole rounds instead of whatever
      arrived within 2 ms.  The generous timeout is a liveness
      safety-net for cells still inside their grace period.

    Sims that tick WITHOUT requesting a forecast (grace period, empty
    cluster, baseline policy) signal it via :meth:`_tick_idle` (the
    engine calls ``client.idle()`` once per such tick): the leader
    counts DISTINCT idle sims toward the cohort, so full-cohort
    detection is exact and idle ticks stop costing the barrier timeout.
    Distinct-per-round counting matters: a non-requesting sim (e.g. a
    baseline-policy cell sharing a gp cohort key) ticks much faster
    than the forecasting sims, and counting its every tick would let
    idle credit accumulate until leaders fire solo batches.  The signal
    is advisory — an over-count merely fires a smaller batch early, and
    results are row-independent either way.
    """

    def __init__(self, wait_s: float = 0.002, mode: str = "leader",
                 barrier_timeout_s: float = 0.25):
        if mode not in ("leader", "barrier"):
            raise ValueError(f"unknown batch mode {mode!r} "
                             "(expected 'leader' or 'barrier')")
        self._wait_s = wait_s if mode == "leader" else barrier_timeout_s
        self.mode = mode
        self._cond = threading.Condition()
        self._pending: dict = {}    # key -> list[_Request] (current round)
        self._clients: dict = {}    # key -> registered sim count
        self._idle: dict = {}       # key -> ids of sims idle this round
        self.batches = 0            # rounds fired (introspection)
        self.requests = 0           # requests served

    def client(self, cfg: SimConfig, device: str | torch.device = "cuda"):
        """forecast_fn for ``run_sim`` on ``device`` (None when the cell
        needs none)."""
        dev = resolve_device(device)
        if cfg.forecaster in ("oracle",):
            return None
        if cfg.forecaster == "persist":
            return _BatchedForecaster(cfg, dev)   # pure NumPy, nothing to batch
        model = _make_model(cfg)
        key = (model, cfg.horizon, cfg.window, dev)
        return _BatcherClient(self, key, model, cfg.horizon, dev)

    # -- internal ------------------------------------------------------
    def _register(self, key):
        with self._cond:
            self._clients[key] = self._clients.get(key, 0) + 1

    def _unregister(self, key):
        with self._cond:
            self._clients[key] -= 1
            self._cond.notify_all()   # a waiting leader may now be complete

    def _tick_idle(self, key, client_id):
        """One registered sim ticked without a forecast request."""
        with self._cond:
            self._idle.setdefault(key, set()).add(client_id)
            self._cond.notify_all()   # the leader's cohort may be complete

    def _forecast(self, key, model, horizon, device, windows, valid):
        req = _Request(windows, valid)
        with self._cond:
            batch = self._pending.setdefault(key, [])
            batch.append(req)
            leader = len(batch) == 1
            if leader:
                deadline = time.monotonic() + self._wait_s
                while (len(batch) + len(self._idle.get(key, ()))
                       < self._clients.get(key, 1)):
                    remaining = deadline - time.monotonic()
                    if remaining <= 0:
                        break
                    self._cond.wait(remaining)
                self._pending[key] = []     # next arrival starts a new round
                self._idle[key] = set()
            else:
                self._cond.notify_all()
        if not leader:
            req.event.wait()
            if isinstance(req.result, BaseException):
                raise req.result
            return req.result

        try:
            rows = np.cumsum([0] + [r.windows.shape[0] for r in batch])
            mean, var = forecast_peaks(
                model, horizon,
                np.concatenate([r.windows for r in batch]),
                np.concatenate([r.valid for r in batch]), device)
        except BaseException as e:
            # wake every follower with the failure — a silent leader death
            # would deadlock their event.wait() and hang the whole sweep
            for r in batch:
                if r is not req:
                    r.result = e
                    r.event.set()
            raise
        with self._cond:
            self.batches += 1
            self.requests += len(batch)
        for r, lo, hi in zip(batch, rows[:-1], rows[1:]):
            r.result = (mean[lo:hi], var[lo:hi])
            if r is not req:
                r.event.set()
        return req.result


class _BatcherClient:
    """Per-sim handle: forwards forecast calls into the shared batcher."""

    def __init__(self, batcher: ForecastBatcher, key, model, horizon: int,
                 device: torch.device):
        self._batcher = batcher
        self._key = key
        self._model = model
        self._horizon = horizon
        self._device = device
        batcher._register(key)

    def __call__(self, windows: np.ndarray, valid: np.ndarray):
        return self._batcher._forecast(self._key, self._model, self._horizon,
                                       self._device, windows, valid)

    def idle(self):
        """Engine signal: this sim's current tick needs no forecast."""
        self._batcher._tick_idle(self._key, id(self))

    def close(self):
        self._batcher._unregister(self._key)


# ----------------------------------------------------------------------
# sweep driver
# ----------------------------------------------------------------------

@dataclasses.dataclass
class SweepResult:
    cells: list[dict]          # one record per (combo, seed) run
    aggregates: list[dict]     # one record per combo (across seeds)
    base: dict                 # base SimConfig snapshot
    wall_s: float
    forecast_batches: int = 0
    forecast_requests: int = 0
    # per-scenario workload statistics (registry name -> trace_stats)
    scenarios: dict = dataclasses.field(default_factory=dict)
    # per-(scenario, forecaster) rolling forecast-error diagnostics
    forecast_error: list = dataclasses.field(default_factory=list)
    # per-(scenario, forecaster) Gaussian-vs-conformal coverage
    # diagnostics (attached when the grid sweeps calibration)
    calibration: list = dataclasses.field(default_factory=list)
    # which engine actually ran the grid; mesh_devices is the mesh width
    # offered to fleets (always 0 here: on one device the shard engine
    # runs as scan, and the port takes no wider mesh)
    engine: str = "vectorized"
    mesh_devices: int = 0

    def to_json(self) -> dict:
        return {
            "schema": 3,
            "engine": self.engine,
            "mesh_devices": self.mesh_devices,
            "base": self.base,
            "cells": self.cells,
            "aggregates": self.aggregates,
            "scenarios": self.scenarios,
            "forecast_error": self.forecast_error,
            "calibration": self.calibration,
            "wall_s": self.wall_s,
            "forecast_batches": self.forecast_batches,
            "forecast_requests": self.forecast_requests,
        }

    def write(self, path: str) -> None:
        with open(path, "w") as f:
            json.dump(self.to_json(), f, indent=1, sort_keys=True)


def _aggregate(cells: list[dict]) -> list[dict]:
    """Group per-seed cell records by combo; add the paper's metrics."""
    by_name: dict[str, list[dict]] = {}
    for c in cells:
        by_name.setdefault(c["name"], []).append(c)
    aggs = []
    for name, group in by_name.items():
        agg = aggregate_summaries([c["summary"] for c in group])
        aggs.append(dict(name=name, overrides=group[0]["overrides"],
                         scenario=group[0]["scenario"],
                         seeds=[c["seed"] for c in group],
                         wall_s=round(sum(c["wall_s"] for c in group), 2),
                         **agg))
    # the speedup denominator is the SAME scenario's baseline: turnaround
    # scales are not comparable across workload regimes.  Baseline ignores
    # the forecaster, so multiple baseline combos are interchangeable —
    # use the first per scenario.
    base_by_scen: dict[str, dict] = {}
    for a in aggs:
        if a["overrides"].get("policy") == "baseline":
            base_by_scen.setdefault(a["scenario"], a)
    for a in aggs:
        b = base_by_scen.get(a["scenario"])
        if b is not None:
            a["turnaround_speedup"] = (b["turnaround_mean"]
                                       / a["turnaround_mean"])
            a["turnaround_speedup_median"] = (
                b["turnaround_mean_median"] / a["turnaround_mean_median"])
    return aggs


def _pinned(device: str | torch.device) -> torch.device:
    """``device`` resolved, a CUDA device with its index made explicit:
    the current CUDA device is per thread, so pool workers are set to it."""
    dev = resolve_device(device)
    if dev.type == "cuda" and dev.index is None:
        dev = torch.device("cuda", torch.cuda.current_device())
    return dev


def _run_grid(base: SimConfig,
              axes: Mapping[Any, Sequence[Any]] | None = None,
              seeds: Sequence[int] | None = None,
              cells: Sequence[Mapping[str, Any]] | None = None,
              *,
              workers: int | None = None,
              engine: str = "vectorized",
              batch_forecasts: bool = True,
              batch_mode: str = "leader",
              barrier_timeout_s: float = 0.25,
              chunk: int = 32,
              mesh: int | None = None,
              out_path: str | None = None,
              expect_completed: bool = False,
              forecast_diag: bool = True,
              alert_rules: Sequence = DEFAULT_RULES,
              device: str | torch.device = "cuda") -> SweepResult:
    """Grid execution body (see :func:`run_grid`, the public wrapper
    that adds telemetry, tracing and manifest writing around this).

    ``engine="vectorized"``: cells run the host engine on a thread pool
    (numpy and the device calls release the GIL, and the forecast
    batcher needs concurrency to stack windows); each cell is
    deterministic per seed regardless of scheduling, because forecast
    rows are computed independently.  On the card the worker threads
    share the device and its default stream, and ``SimResults.timings``
    of a cell (which synchronises the whole device at each phase split)
    includes the other cells' work: it is not a per-cell speed.

    ``engine="scan"`` selects the device engine (``repro_torch.sim.step``):
    no thread pool and no forecast batcher — every cell runs as chunks
    of fused ticks on the device (replayed CUDA graphs on the card), and
    each combo's whole SEED COHORT runs as one ``run_cohort_scan``
    batch, the combos in sequence.  Per-seed results are bit-identical
    to solo ``run_sim_scan`` runs; ``chunk`` sets the ticks executed per
    host read.

    ``engine="shard"`` with one visible device (``mesh`` None = all
    visible, clamped to them) falls back to ``scan``, as the reference's
    does; with two or more it raises ``NotImplementedError``: the port
    runs a fleet on one device (``repro_torch.sim.shard``, whose
    ``run_fleet_shard`` takes ``mesh=1``).
    ``engine="reference"`` raises ``ValueError``.

    ``forecast_diag`` attaches one rolling forecast-error record per
    (scenario, forecaster) pair in the grid — computed on series sampled
    from the scenario's ground-truth profiles, entirely outside the
    engines, so simulation results stay bit-identical either way.
    Grids that sweep calibration (a ``calibration`` axis or any
    calibration-enabled cell) additionally get one Gaussian-vs-conformal
    coverage record per pair (``result.calibration``) — like the
    forecast-error records, these are skipped when ``forecast_diag`` is
    off.

    ``batch_mode`` selects the forecast batcher's cohort policy
    (``"leader"`` = 2 ms leader timeout, ``"barrier"`` =
    tick-synchronous full-cohort rounds for homogeneous grids).
    """
    from concurrent.futures import ThreadPoolExecutor

    dev = _pinned(device)
    grid = expand_grid(base, axes, seeds, cells)
    if not grid:
        raise ValueError("empty sweep grid")
    if engine == "shard":
        # a 1-wide mesh buys nothing over the cohort path.  An
        # over-asking mesh is clamped to the visible devices, NOT an
        # error — the fallback promise covers it
        want = device_count(dev) if mesh is None else int(mesh)
        want = max(1, min(want, device_count(dev)))
        if want >= 2:
            raise NotImplementedError(
                f"engine='shard' over {want} devices: the port runs a fleet on "
                "one device; use engine='scan'")
        print("# engine=shard: single device visible — falling back "
              "to engine=scan")
        engine = "scan"
    if engine == "reference":
        raise ValueError("engine='reference' is the JAX package's frozen seed "
                         "loop and is not ported; use 'vectorized' or 'scan'")
    if engine not in ("vectorized", "scan"):
        raise ValueError(f"unknown engine {engine!r}")
    batcher = (ForecastBatcher(mode=batch_mode,
                               barrier_timeout_s=barrier_timeout_s)
               if batch_forecasts and engine == "vectorized" else None)

    # one trace per unique scenario config: many cells share a
    # (config, seed) point and the engines never mutate a Trace, so
    # generation happens once, serially, and the arrays are shared
    # read-only across threads
    with span("build_traces", cat="build",
              args={"n": len({c.cfg.workload for c in grid})}):
        workloads = {cfg: build_trace(cfg)
                     for cfg in {cell.cfg.workload for cell in grid}}

    def _record(cell: SweepCell, res, wall_s: float) -> dict:
        s = res.summary()
        if expect_completed and s["completed"] != s["n_apps"]:
            raise RuntimeError(
                f"cell {cell.name} seed {cell.seed}: only {s['completed']}"
                f"/{s['n_apps']} apps completed (raise max_ticks?)")
        rec = dict(name=cell.name, overrides=cell.overrides,
                   scenario=cell.scenario, seed=cell.seed, summary=s,
                   wall_s=round(wall_s, 2))
        # telemetry blocks ride OUTSIDE summary (additive schema-3
        # keys): forecast-load counters with the derived masked-rows
        # overhead, and the obs-ring scalars when rings were on
        if res.forecast_rows is not None:
            rec["forecast_rows"] = dict(
                res.forecast_rows,
                masked_row_overhead=round(
                    masked_row_overhead(res.forecast_rows), 2))
            if res.forecast_rows.get("rows_bucketed"):
                # rows the model ACTUALLY computed under the device
                # engine's bucketed forecast vs rows ready
                rec["forecast_rows"]["bucketed_row_overhead"] = round(
                    bucketed_row_overhead(res.forecast_rows), 2)
        if res.obs is not None:
            rec["obs"] = obs_summary(res.obs)
            # downsampled per-channel series for the dashboard
            # sparklines (event channels bucket-SUM so totals survive)
            rec["obs"]["history"] = compact_history(res.obs)
            if alert_rules:
                fired = evaluate_rules(
                    res.obs, alert_rules,
                    nominal_q=cell.cfg.calibration.q,
                    tenancy=res.tenancy)
                for a in fired:
                    a["cell"] = cell.name
                    a["seed"] = cell.seed
                rec["obs"]["alerts"] = fired
        return rec

    def one(cell: SweepCell) -> dict:
        t0 = time.time()
        client = batcher.client(cell.cfg, dev) if batcher else None
        try:
            with span(f"cell:{cell.name}", cat="cell",
                      args={"seed": cell.seed}):
                res = run_sim(cell.cfg, workloads[cell.cfg.workload],
                              forecast_fn=client, device=dev)
        finally:
            if client is not None and hasattr(client, "close"):
                client.close()
        return _record(cell, res, time.time() - t0)

    def scan_records() -> list[dict]:
        """Device-engine driver: one batch per combo's seed cohort
        (serial over combos — the device is the parallel axis, not a
        thread pool)."""
        from repro_torch.sim.step import run_cohort_scan, run_sim_scan
        by_combo: dict[str, list[SweepCell]] = {}
        for cell in grid:
            by_combo.setdefault(cell.name, []).append(cell)
        recs: dict[int, dict] = {}
        for cells_g in by_combo.values():
            base_cfg = cells_g[0].cfg
            seeds_g = [c.seed for c in cells_g]
            # a cohort needs identical configs modulo the workload seed
            strip = lambda c: _set_path(c, "workload.seed", 0)  # noqa: E731
            homogeneous = (len(cells_g) > 1
                           and len(set(seeds_g)) == len(seeds_g)
                           and all(strip(c.cfg) == strip(base_cfg)
                                   for c in cells_g))
            t0 = time.time()
            with span(f"cohort:{cells_g[0].name}", cat="cohort",
                      args={"seeds": len(cells_g),
                            "vmapped": homogeneous}):
                if homogeneous:
                    results = run_cohort_scan(
                        base_cfg, seeds_g, chunk=chunk, device=dev,
                        wls=[workloads[c.cfg.workload] for c in cells_g])
                else:
                    results = [run_sim_scan(c.cfg,
                                            workloads[c.cfg.workload],
                                            chunk=chunk, device=dev)
                               for c in cells_g]
            wall = (time.time() - t0) / len(cells_g)
            for cell, res in zip(cells_g, results):
                recs[id(cell)] = _record(cell, res, wall)
        return [recs[id(cell)] for cell in grid]

    t0 = time.time()
    if engine == "scan":
        records = scan_records()
    else:
        n_workers = workers or min(len(grid), os.cpu_count() or 4)
        if n_workers > 1:
            init = ((lambda: torch.cuda.set_device(dev)) if dev.type == "cuda"
                    else None)
            with ThreadPoolExecutor(max_workers=n_workers,
                                    initializer=init) as pool:
                records = list(pool.map(one, grid))
        else:
            records = [one(c) for c in grid]

    # per-scenario trace statistics + forecast-error diagnostics (one
    # record per (scenario, forecaster-model) pair seen in the grid);
    # grids with any calibration-ENABLED cell also get coverage
    # diagnostics per pair (a sigma-only axis exercises no conformal
    # code, so it pays for none)
    sweeps_cal = any(c.cfg.calibration.enabled for c in grid)
    scen_stats: dict[str, dict] = {}
    diag: list[dict] = []
    cal_diag: list[dict] = []
    seen_diag: set = set()
    with span("diagnostics", cat="diag"):
        for cell in grid:
            tr = workloads[cell.cfg.workload]
            scen_stats.setdefault(cell.scenario, trace_stats(tr))
            if not forecast_diag or cell.cfg.forecaster == "oracle":
                continue
            c = cell.cfg
            model_key = {"gp": c.gp, "arima": c.arima}.get(c.forecaster)
            key = (cell.scenario, c.forecaster, model_key, c.window)
            if key in seen_diag:
                continue
            seen_diag.add(key)
            # ONE shared rolling-forecast pass feeds both reports
            rep, cov = forecast_reports(tr, c.forecaster, window=c.window,
                                        coverage=sweeps_cal,
                                        gp=c.gp, arima=c.arima, device=dev)
            if rep is not None:
                diag.append({"scenario": cell.scenario, **rep})
            if cov is not None:
                cal_diag.append({"scenario": cell.scenario, **cov})

    result = SweepResult(
        cells=records, aggregates=_aggregate(records),
        base=dataclasses.asdict(base), wall_s=round(time.time() - t0, 2),
        forecast_batches=batcher.batches if batcher else 0,
        forecast_requests=batcher.requests if batcher else 0,
        scenarios=scen_stats, forecast_error=diag, calibration=cal_diag,
        engine=engine, mesh_devices=0)
    if out_path:
        result.write(out_path)
    return result


def run_grid(base: SimConfig,
             axes: Mapping[Any, Sequence[Any]] | None = None,
             seeds: Sequence[int] | None = None,
             cells: Sequence[Mapping[str, Any]] | None = None,
             *,
             workers: int | None = None,
             engine: str = "vectorized",
             batch_forecasts: bool = True,
             batch_mode: str = "leader",
             barrier_timeout_s: float = 0.25,
             chunk: int = 32,
             mesh: int | None = None,
             leap: bool = False,
             forecast_bucket: bool = True,
             out_path: str | None = None,
             expect_completed: bool = False,
             forecast_diag: bool = True,
             obs: bool = False,
             trace_path: str | None = None,
             manifest_path: str | None = None,
             alert_rules: Sequence = DEFAULT_RULES,
             alert_log_path: str | None = None,
             dashboard_path: str | None = None,
             device: str | torch.device = "cuda") -> SweepResult:
    """Expand and run a sweep grid on ``device``; aggregate and
    optionally write JSON.

    See :func:`_run_grid` for the execution model (thread-pooled host
    engine, device-engine seed cohorts).  This wrapper adds the
    observability plane (``repro_torch.obs``) around it:

    ``obs=True`` enables the device engine's telemetry rings on every
    cell (``SimConfig.obs``; the host engine ignores the flag): each
    cell record then carries an ``obs`` block of ring-derived scalars,
    and ``SimResults.obs`` the full per-tick histories.  Cells whose
    engine collects forecast-load telemetry (the device engine)
    additionally get a ``forecast_rows`` block with the derived
    ``masked_row_overhead`` and ``bucketed_row_overhead`` (rows the
    model actually computed under the bucketed forecast — see
    ``SimConfig.forecast_bucket``).

    ``leap=True`` sets ``SimConfig.leap`` on every cell: the device
    engine then skips provably-idle tick runs (bursty traces with long
    gaps cost ~the number of non-idle ticks).  Results are bit-identical
    to ``leap=False``; the host engine ignores it.
    ``forecast_bucket=False`` disables the bucketed gp/arima forecast on
    every cell (results are bit-identical either way).

    ``trace_path`` writes a Chrome trace-event / Perfetto JSON covering
    the driver phases (trace build, per-cell runs, per-combo cohorts,
    diagnostics).  The reference's ``scan.bucket_cache_entries`` gauge
    has no counterpart here: one captured graph serves every bucket.

    A run manifest (config hashes, torch and CUDA versions, device
    topology, metrics, artifact paths) is written to ``manifest_path``,
    defaulting to ``<out_path minus .json>.manifest.json`` whenever
    ``out_path`` is set.  The manifest's cell hashes are recomputable
    from its own contents (:func:`repro_torch.obs.load_manifest`
    verifies the round trip).

    Obs-enabled cells are additionally run through the alert watchdog
    (``alert_rules``, default :data:`repro_torch.obs.DEFAULT_RULES`;
    pass an empty tuple to skip): fired alerts land in the per-cell
    ``obs`` block, the manifest's un-hashed ``alerts`` extra, the
    labeled ``alerts.fired{rule,severity}`` REGISTRY counters, and —
    when ``out_path`` or ``alert_log_path`` is set — a JSONL alert log
    next to the results (``<out minus .json>.alerts.jsonl``).

    ``dashboard_path`` renders the self-contained HTML report
    (:func:`repro_torch.obs.render_dashboard`) from the freshly written
    artifacts.
    """
    if obs:
        base = _set_path(base, "obs.enabled", True)
    if leap:
        base = _set_path(base, "leap", True)
    if not forecast_bucket:
        base = _set_path(base, "forecast_bucket", False)
    ctx = (tracing(trace_path) if trace_path is not None
           else contextlib.nullcontext())
    t0 = time.time()
    with ctx:
        result = _run_grid(
            base, axes, seeds, cells, workers=workers, engine=engine,
            batch_forecasts=batch_forecasts, batch_mode=batch_mode,
            barrier_timeout_s=barrier_timeout_s, chunk=chunk, mesh=mesh,
            out_path=out_path, expect_completed=expect_completed,
            forecast_diag=forecast_diag, alert_rules=alert_rules,
            device=device)
    alerts = [a for c in result.cells
              for a in (c.get("obs") or {}).get("alerts", [])]
    if alert_log_path is None and out_path and alerts:
        alert_log_path = (out_path[:-5] if out_path.endswith(".json")
                          else out_path) + ".alerts.jsonl"
    if alert_log_path:
        write_alert_log(alert_log_path, alerts)
    if manifest_path is None and out_path:
        manifest_path = (out_path[:-5] if out_path.endswith(".json")
                         else out_path) + ".manifest.json"
    man = None
    if manifest_path or dashboard_path:
        artifacts = {"results": out_path, "trace": trace_path,
                     "alerts": alert_log_path}
        man = build_manifest(
            base_config=result.base,
            cells=[{"name": c["name"], "scenario": c["scenario"],
                    "seed": c["seed"], "overrides": c["overrides"]}
                   for c in result.cells],
            engine=result.engine,
            artifacts={k: v for k, v in artifacts.items() if v},
            wall_s=time.time() - t0,
            metrics=REGISTRY.snapshot(),
            extra={"mesh_devices": result.mesh_devices, "chunk": chunk,
                   "obs": obs, "alerts": alerts})
    if manifest_path:
        write_manifest(manifest_path, man)
    if dashboard_path:
        # prefer the on-disk manifest so artifact-path resolution gets
        # exercised exactly as it would on a CI artifact download
        render_dashboard(manifest_path or man, dashboard_path,
                         results=None if (manifest_path and out_path)
                         else {"cells": result.cells})
    return result


# ----------------------------------------------------------------------
# CLI
# ----------------------------------------------------------------------

def quick_base_config(n_apps: int = 64, n_hosts: int = 4,
                      max_components: int = 8, seed: int = 0) -> SimConfig:
    """CI-scale base config: saturated little cluster, minutes of load."""
    return SimConfig(
        cluster=ClusterConfig(n_hosts=n_hosts, max_running_apps=48),
        workload=WorkloadConfig(n_apps=n_apps, max_components=max_components,
                                max_runtime=1800.0, mean_burst_gap=2.0,
                                mean_long_gap=40.0, seed=seed),
        max_ticks=20_000)


def _csv(kind):
    return lambda s: [kind(x) for x in s.split(",") if x]


def main(argv: Sequence[str] | None = None) -> SweepResult:
    ap = argparse.ArgumentParser(
        prog="python -m repro_torch.sim.sweep",
        description="Run a policy x forecaster x safeguard sweep grid.")
    ap.add_argument("--policy", type=_csv(str),
                    default=["baseline", "optimistic", "pessimistic"])
    ap.add_argument("--forecaster", type=_csv(str),
                    default=["persist", "oracle"],
                    help="any of: persist,oracle,gp,arima")
    ap.add_argument("--scenario", type=_csv(str), default=None,
                    help="scenario axis, any registered family (e.g. "
                         "google,diurnal,flashcrowd,heavytail,colocated); "
                         "omitted = base workload only")
    ap.add_argument("--k1", type=_csv(float), default=None,
                    help="safeguard K1 axis (e.g. 0.0,0.05,0.25)")
    ap.add_argument("--k2", type=_csv(float), default=None,
                    help="safeguard K2 axis (e.g. 0.0,1.0,3.0)")
    ap.add_argument("--calibration", type=_csv(str), default=None,
                    help="safeguard-mode axis, any of: sigma (Eq. 9 "
                         "K2-band), conformal, adaptive")
    ap.add_argument("--tenancy", type=_csv(str), default=None,
                    help="control-plane mode axis, any of: off, ungated "
                         "(accounting only), wdrf (admission gate), "
                         "credit (gate + credit-aware shaping)")
    ap.add_argument("--tenants", type=int, default=None,
                    help="workload tenant count (workload.n_tenants); "
                         "tenants are Zipf-skewed over apps")
    ap.add_argument("--target-q", type=float, default=None,
                    help="conformal target quantile (calibration.q)")
    ap.add_argument("--budget", type=float, default=None,
                    help="adaptive failure-rate budget "
                         "(calibration.budget, target miscoverage)")
    ap.add_argument("--seeds", type=int, default=2,
                    help="number of workload seeds (0..N-1)")
    ap.add_argument("--apps", type=int, default=64)
    ap.add_argument("--hosts", type=int, default=4)
    ap.add_argument("--components", type=int, default=8)
    ap.add_argument("--workers", type=int, default=None)
    ap.add_argument("--engine", choices=("vectorized", "scan", "shard"),
                    default="vectorized",
                    help="vectorized = host engine on a thread pool; scan = "
                         "the device engine, seed cohorts as one batch; "
                         "shard = scan on one device (the port takes no wider "
                         "mesh)")
    ap.add_argument("--device", default="cuda",
                    help="where the engines run: cuda (default) or cpu")
    ap.add_argument("--chunk", type=int, default=32,
                    help="scan engine: ticks per host read")
    ap.add_argument("--mesh", type=int, default=None,
                    help="shard engine: mesh width in devices (default "
                         "all visible)")
    ap.add_argument("--leap", action="store_true",
                    help="scan engine: event-driven leap ticks (skip "
                         "provably-idle tick runs; bit-identical to "
                         "uniform ticks)")
    ap.add_argument("--no-bucket", action="store_true",
                    help="scan engine: disable the bucketed forecast (run "
                         "gp/arima over the full padded row batch every "
                         "tick)")
    ap.add_argument("--no-batch", action="store_true",
                    help="disable cross-sim forecast batching")
    ap.add_argument("--batch-mode", choices=("leader", "barrier"),
                    default="leader",
                    help="forecast-batcher cohort policy: leader (2 ms "
                         "timeout) or barrier (tick-synchronous full "
                         "cohorts for homogeneous grids)")
    ap.add_argument("--no-diag", action="store_true",
                    help="skip per-scenario forecast-error and coverage "
                         "diagnostics")
    ap.add_argument("--obs", action="store_true",
                    help="enable the device engine's telemetry rings on "
                         "every cell (cell records gain an obs block)")
    ap.add_argument("--trace", default=None, metavar="PATH",
                    help="write a Chrome trace-event JSON of the sweep "
                         "driver phases (open in chrome://tracing or "
                         "ui.perfetto.dev)")
    ap.add_argument("--manifest", default=None, metavar="PATH",
                    help="run-manifest path (default: <out minus "
                         ".json>.manifest.json)")
    ap.add_argument("--dashboard", default=None, metavar="PATH",
                    help="render the self-contained HTML report "
                         "(sparklines, waterfall, fired alerts) to "
                         "PATH after the run")
    ap.add_argument("--alert-log", default=None, metavar="PATH",
                    help="JSONL fired-alert log (default: <out minus "
                         ".json>.alerts.jsonl when any alert fires)")
    ap.add_argument("--no-alerts", action="store_true",
                    help="skip the alert watchdog on obs-enabled cells")
    ap.add_argument("--out", default="BENCH_sweep.json")
    args = ap.parse_args(argv)
    if args.seeds < 1:
        ap.error("--seeds must be >= 1")

    base = quick_base_config(args.apps, args.hosts, args.components)
    if args.target_q is not None:
        base = _set_path(base, "calibration.q", args.target_q)
    if args.budget is not None:
        base = _set_path(base, "calibration.budget", args.budget)
    axes: dict = {}
    if args.scenario:
        axes["scenario"] = args.scenario
    axes.update({"policy": args.policy, "forecaster": args.forecaster})
    if args.k1:
        axes["safeguard.k1"] = args.k1
    if args.k2:
        axes["safeguard.k2"] = args.k2
    if args.calibration:
        axes["calibration"] = args.calibration
    if args.tenants is not None:
        base = _set_path(base, "workload.n_tenants", args.tenants)
    if args.tenancy:
        axes["tenancy"] = args.tenancy
    result = run_grid(base, axes, seeds=range(args.seeds),
                      workers=args.workers, engine=args.engine,
                      batch_forecasts=not args.no_batch,
                      batch_mode=args.batch_mode, chunk=args.chunk,
                      mesh=args.mesh, leap=args.leap,
                      forecast_bucket=not args.no_bucket,
                      forecast_diag=not args.no_diag, out_path=args.out,
                      obs=args.obs, trace_path=args.trace,
                      manifest_path=args.manifest,
                      alert_rules=() if args.no_alerts else DEFAULT_RULES,
                      alert_log_path=args.alert_log,
                      dashboard_path=args.dashboard, device=args.device)

    print(f"# {len(result.cells)} cells in {result.wall_s:.1f}s "
          f"({result.forecast_requests} forecast requests in "
          f"{result.forecast_batches} stacked batches) -> {args.out}")
    print("combo,seeds,turnaround_mean_s,speedup,failed_frac,util_mem")
    for a in result.aggregates:
        speed = a.get("turnaround_speedup", float("nan"))
        print(f"{a['name']},{a['n_seeds']},{a['turnaround_mean']:.0f},"
              f"{speed:.2f},{a['failed_frac']:.3f},"
              f"{a['util_mem_mean']:.3f}")
    for d in result.forecast_error:
        print(f"# forecast_error {d['scenario']}/{d['forecaster']}: "
              f"median_abs_rel={d['abs_rel_err_median']:.3f} "
              f"median_|z|={d['median_abs_z']:.2f}")
    for d in result.calibration:
        lv = next((r for r in d["levels"] if abs(r["q"] - 0.9) < 1e-9),
                  d["levels"][0])
        print(f"# coverage {d['scenario']}/{d['forecaster']} "
              f"q={lv['q']}: gaussian={lv['gaussian_coverage']:.3f} "
              f"conformal={lv['conformal_coverage']:.3f}")
    return result


if __name__ == "__main__":
    main()
