"""Sweep fleets: grid cells grouped by static config, each group one batch.

Counterpart of ``repro/sim/shard.py``.  ``run_grid(engine="scan")`` runs
each combo's seed cohort as one device batch, the combos in sequence.
Sweep cells that share every config field except their workload (seed
and/or scenario: trace data, not program structure) form a *fleet*, and a
fleet runs as one batch (:func:`repro_torch.sim.step.run_fleet_shard`),
its members on the leading axis of every tensor.  The reference lays that
axis across a device mesh; the port runs a fleet on one device, and a
mesh of two or more devices raises ``NotImplementedError``.

Members never interact, so each member's results equal its solo run,
except the cohort's ``forecast_rows["rows_bucketed"]``, which counts the
cohort's forecast bucket (its largest member's, as the reference's).
Cells whose static config is unique in the grid (singleton fleets) run
solo; streamed members run solo, each in its own window.
"""
from __future__ import annotations

import dataclasses
import time
from typing import Sequence

import torch

from repro_torch.device import resolve_device
from repro_torch.obs.trace import span
from repro_torch.sim.step import device_count, run_fleet_shard, run_sim_scan

__all__ = ["device_count", "group_fleets", "run_shard_records"]


def _strip_workload(cfg, ref):
    """``cfg`` with its workload replaced by ``ref``'s: equality of the
    stripped configs is exactly 'may share one batch'."""
    return dataclasses.replace(cfg, workload=ref.workload)


def group_fleets(cells: Sequence, workloads: dict) -> list[list]:
    """Group sweep cells into fleets: members agree on every config field
    except ``workload`` and on the trace shape (a fleet is one batch).
    Order-stable: fleets in first-member grid order, members in grid
    order."""
    ref = cells[0].cfg
    groups: dict = {}
    for cell in cells:
        wl = workloads[cell.cfg.workload]
        key = (_strip_workload(cell.cfg, ref), int(wl.n_apps), int(wl.max_components))
        groups.setdefault(key, []).append(cell)
    return list(groups.values())


def run_shard_records(grid: Sequence, workloads: dict, record, *, chunk: int = 32,
                      mesh: int | None = None, log=None,
                      device: str | torch.device = "cuda") -> list[dict]:
    """Fleet sweep driver: ``record(cell, results, wall_s)`` builds each
    cell's record; a cell's wall time is its fleet's divided by the member
    count.  ``log`` (optional callable) receives one line per fleet.  Each
    fleet runs in the ``fleet:<name>`` span."""
    dev = resolve_device(device)
    recs: dict[int, dict] = {}
    for fleet in group_fleets(grid, workloads):
        base_cfg = fleet[0].cfg
        t0 = time.time()
        with span(f"fleet:{fleet[0].name}", cat="fleet", args={"members": len(fleet)}):
            if len(fleet) == 1:
                # a singleton static config: a solo run
                results = [run_sim_scan(base_cfg, workloads[base_cfg.workload],
                                        chunk=chunk, device=dev)]
            else:
                results = run_fleet_shard(
                    base_cfg, cfgs=[c.cfg for c in fleet],
                    wls=[workloads[c.cfg.workload] for c in fleet],
                    chunk=chunk, mesh=mesh, device=dev)
        wall = (time.time() - t0) / len(fleet)
        if log is not None:
            log(f"fleet[{len(fleet)} cells] {fleet[0].name} "
                f"(+{len(fleet) - 1} more): {wall * len(fleet):.2f}s")
        for cell, res in zip(fleet, results):
            recs[id(cell)] = record(cell, res, wall)
    return [recs[id(cell)] for cell in grid]
