"""Trace replay: ingest real cluster traces (CSV / Parquet) as a Trace.

A copy of ``repro/sim/scenarios/replay.py`` (numpy and the stdlib
``csv``): the same file gives a bit-identical trace.  It mirrors what the
reference's code does, where that differs from what the reference's
property tests ask too: ``_tenant_codes(['7'])`` is ``[7]``, not a
dense ``[0]``, and a trace padded wider than its widest app loads back
at that app's width.

File format — one row per *component*, grouped by application:

    app_id, submit, runtime, is_elastic, is_jumpy, component, is_core,
    cpu_req, mem_req, cpu_levels, mem_levels [, tenant_id, slo_class]

``tenant_id`` / ``slo_class`` are optional (files written before the
control plane load as a single tenant 0, SLO "best-effort"); string
tenant ids are densely re-encoded, ``slo_class`` accepts a class name
or its integer code.
``cpu_levels`` / ``mem_levels`` are ``;``-joined utilization fractions
(of the reservation) sampled anywhere along the component's lifetime —
any length; they are linearly resampled to the engine's ``SEGMENTS``
knots on load.  This keeps the files rectangular (plain CSV, Parquet,
or anything pandas reads) while allowing per-trace sampling rates.

CSV round-trips through the stdlib ``csv`` module — no extra
dependencies.  Parquet requires pandas+pyarrow and degrades to a clear
error when they are absent (they are NOT a hard dependency of the
package).

``save_trace`` writes any :class:`Trace` back out in the same format,
so synthetic scenarios can be exported, edited, and replayed — and the
round-trip is exact for float32 values.
"""
from __future__ import annotations

import csv
import dataclasses
import os
import warnings

import numpy as np

from repro_torch.sim.scenarios.registry import register
from repro_torch.sim.scenarios.schema import (CPU, MEM, SEGMENTS, SLO_CLASSES, Trace,
                                              sort_by_submit)

try:
    import pandas as _pd
except ImportError:                        # pragma: no cover - env-dependent
    _pd = None

# tenant_id / slo_class are OPTIONAL on load (pre-control-plane files
# back-compat to tenant 0, "best-effort"); save_trace always writes them
COLUMNS = ("app_id", "submit", "runtime", "is_elastic", "is_jumpy",
           "component", "is_core", "cpu_req", "mem_req",
           "cpu_levels", "mem_levels", "tenant_id", "slo_class")

# default 5-minute reading cadence of the Azure public VM traces, used
# when a VM has a single reading (no inferable interval)
_AZURE_DT_S = 300.0


def _azure_rows(rows: list[dict]) -> list[dict]:
    """Column-mapping preset for Azure-public-dataset-style VM traces.

    Input: long format, one row per *reading* —

        vmid, timestamp, corecount, memory, avgcpu [, avgmem]

    (``timestamp`` in seconds, ``avgcpu``/``avgmem`` in percent of the
    provisioned ``corecount`` cores / ``memory`` GB, the convention of
    the AzurePublicDataset usage files).  Each VM becomes one rigid
    single-component app: first reading = submission, reading span =
    runtime, utilization series = the readings scaled to fractions
    (resampled to the engine's knots by the normal replay path).  The
    Azure traces carry no memory utilization; absent ``avgmem``, memory
    levels default to a flat 50% of the reservation.
    """
    by_vm: dict = {}
    for r in rows:
        by_vm.setdefault(str(r["vmid"]), []).append(r)
    out = []
    for vmid, rs in by_vm.items():
        rs = sorted(rs, key=lambda r: float(r["timestamp"]))
        ts = np.asarray([float(r["timestamp"]) for r in rs])
        dt = float(np.median(np.diff(ts))) if ts.size > 1 else _AZURE_DT_S
        cpu = [min(max(float(r["avgcpu"]) / 100.0, 0.0), 1.0) for r in rs]

        def mem_level(r):
            # per-reading: blank / missing / NaN cells (the Azure traces
            # carry no memory readings at all) -> flat 50% default
            v = r.get("avgmem")
            if v in ("", None):
                return 0.5
            v = float(v)
            return 0.5 if v != v else min(max(v / 100.0, 0.0), 1.0)

        mem = [mem_level(r) for r in rs]
        out.append({
            "tenant_id": rs[0].get("tenant", 0) or 0,
            "app_id": vmid,
            "submit": ts[0],
            "runtime": max(ts[-1] - ts[0] + dt, dt),
            "is_elastic": 0,
            "is_jumpy": 0,
            "component": 0,
            "is_core": 1,
            "cpu_req": float(rs[0]["corecount"]),
            "mem_req": float(rs[0]["memory"]),
            "cpu_levels": ";".join(str(v) for v in cpu),
            "mem_levels": ";".join(str(v) for v in mem),
        })
    return out


# default sampling cadence of the Alibaba cluster-trace (v2018)
# container_usage readings, used when a container has a single reading
_ALIBABA_DT_S = 10.0


def _alibaba_rows(rows: list[dict]) -> list[dict]:
    """Column-mapping preset for Alibaba-cluster-trace-style containers.

    Input: long format, one row per *reading*, the v2018
    ``container_usage`` columns joined with the container's requested
    resources from ``container_meta`` —

        container_id, time_stamp, cpu_request, mem_size,
        cpu_util_percent [, mem_util_percent]

    (``time_stamp`` in seconds; ``cpu_request`` in the trace's 1/100-
    core units, so 400 = 4 cores; ``mem_size`` in GB;
    ``cpu_util_percent`` / ``mem_util_percent`` in percent of the
    request, the convention of the published trace).  Each container
    becomes one rigid single-component app, mirroring the Azure preset:
    first reading = submission, reading span = runtime, utilization
    series = the percent readings scaled to fractions.  Missing memory
    readings default to a flat 50% of the reservation.
    """
    by_c: dict = {}
    for r in rows:
        by_c.setdefault(str(r["container_id"]), []).append(r)
    out = []
    for cid, rs in by_c.items():
        rs = sorted(rs, key=lambda r: float(r["time_stamp"]))
        ts = np.asarray([float(r["time_stamp"]) for r in rs])
        dt = float(np.median(np.diff(ts))) if ts.size > 1 else _ALIBABA_DT_S

        def frac(r, col):
            v = r.get(col)
            if v in ("", None):
                return 0.5
            v = float(v)
            return 0.5 if v != v else min(max(v / 100.0, 0.0), 1.0)

        out.append({
            "tenant_id": rs[0].get("tenant", 0) or 0,
            "app_id": cid,
            "submit": ts[0],
            "runtime": max(ts[-1] - ts[0] + dt, dt),
            "is_elastic": 0,
            "is_jumpy": 0,
            "component": 0,
            "is_core": 1,
            "cpu_req": float(rs[0]["cpu_request"]) / 100.0,
            "mem_req": float(rs[0]["mem_size"]),
            "cpu_levels": ";".join(str(frac(r, "cpu_util_percent"))
                                   for r in rs),
            "mem_levels": ";".join(str(frac(r, "mem_util_percent"))
                                   for r in rs),
        })
    return out


# preset name -> raw-row transform into the canonical replay columns
PRESETS = {"azure": _azure_rows, "alibaba": _alibaba_rows}


@dataclasses.dataclass(frozen=True)
class ReplayConfig:
    """Scenario config for trace replay.

    ``seed`` exists only so the sweep's seed axis applies uniformly to
    every scenario config; a replayed trace is identical across seeds.
    ``n_apps`` > 0 truncates to the first N applications (by submission
    time); ``max_components`` > 0 overrides the inferred component
    padding (it must cover the widest app).  ``preset`` selects a
    column-mapping for foreign trace formats (currently ``"azure"`` for
    Azure-public-dataset-style VM readings).
    """
    path: str = ""
    n_apps: int = 0
    max_components: int = 0
    seed: int = 0
    preset: str = ""


def _fmt_levels(row: np.ndarray) -> str:
    # no precision cap: format_float_positional defaults to the unique
    # shortest repr, which is what makes the round-trip float32-exact
    return ";".join(np.format_float_positional(v, trim="-") for v in row)


def _parse_levels(s: str) -> np.ndarray:
    vals = np.asarray([float(x) for x in str(s).split(";")], np.float32)
    if vals.size == SEGMENTS:
        return vals
    # linear resample onto the engine's knot grid
    src = np.linspace(0.0, 1.0, vals.size)
    dst = np.linspace(0.0, 1.0, SEGMENTS)
    return np.interp(dst, src, vals).astype(np.float32)


def save_trace(trace: Trace, path: str) -> None:
    """Write a Trace in the replay format (.csv or .parquet)."""
    rows = []
    for gid in range(trace.n_apps):
        for c in range(trace.max_components):
            if trace.cpu_req[gid, c] == 0:
                continue
            rows.append({
                "app_id": gid,
                "submit": float(trace.submit[gid]),
                "runtime": float(trace.runtime[gid]),
                "is_elastic": int(trace.is_elastic[gid]),
                "is_jumpy": int(trace.is_jumpy[gid]),
                "component": c,
                "is_core": int(trace.is_core[gid, c]),
                "cpu_req": float(trace.cpu_req[gid, c]),
                "mem_req": float(trace.mem_req[gid, c]),
                "cpu_levels": _fmt_levels(trace.levels[gid, c, :, CPU]),
                "mem_levels": _fmt_levels(trace.levels[gid, c, :, MEM]),
                "tenant_id": int(trace.tenant[gid]),
                "slo_class": SLO_CLASSES[int(trace.slo[gid])],
            })
    if path.endswith(".parquet"):
        if _pd is None:
            raise RuntimeError("parquet export needs pandas+pyarrow; "
                               "write .csv instead")
        _pd.DataFrame(rows, columns=COLUMNS).to_parquet(path, index=False)
        return
    with open(path, "w", newline="") as f:
        w = csv.DictWriter(f, fieldnames=COLUMNS)
        w.writeheader()
        w.writerows(rows)


def _slo_code(v) -> int:
    """``slo_class`` cell -> integer code: a class name, a numeric
    code, or blank/absent (-> 0, "best-effort")."""
    if v in ("", None) or v != v:           # blank cell or NaN
        return 0
    s = str(v)
    if s in SLO_CLASSES:
        return SLO_CLASSES.index(s)
    return int(float(s))


def _tenant_codes(raw: list) -> np.ndarray:
    """``tenant_id`` cells -> dense integer codes.

    Integer-valued cells pass through; any non-numeric id (string
    tenant names) densely re-encodes ALL ids by sorted unique value,
    so foreign traces can tag tenants symbolically."""
    vals = ["0" if v in ("", None) or v != v else str(v) for v in raw]
    try:
        return np.asarray([int(float(v)) for v in vals], np.int64)
    except ValueError:
        uniq = {v: i for i, v in enumerate(sorted(set(vals)))}
        return np.asarray([uniq[v] for v in vals], np.int64)


# per-app scalar columns that every component row of one app must agree
# on — a conflict means two different applications share an app_id (the
# old loader silently kept the first row's values)
_APP_SCALARS = ("submit", "runtime", "is_elastic", "is_jumpy")


def _check_app(aid: str, rs: list[dict]) -> list[dict]:
    """Validate and canonicalize one app's component rows.

    Rows sort by their declared ``component`` id (the old loader packed
    them in file order, silently re-keying shuffled components);
    duplicate component ids and conflicting per-app scalars raise.
    """
    for col in _APP_SCALARS:
        vals = {float(r[col]) for r in rs}
        if len(vals) > 1:
            raise ValueError(
                f"replay app {aid!r}: component rows disagree on "
                f"{col!r} ({sorted(vals)}) — duplicate app_id reused "
                "for different applications?")
    comps = [int(float(r["component"])) for r in rs]
    if len(set(comps)) != len(comps):
        raise ValueError(f"replay app {aid!r}: duplicate component ids "
                         f"{sorted(comps)}")
    if comps != sorted(comps):
        rs = [r for _, r in sorted(zip(comps, rs), key=lambda p: p[0])]
    return rs


def _read_rows(path: str) -> list[dict]:
    if path.endswith(".parquet"):
        if _pd is None:
            raise RuntimeError(f"cannot read {path}: parquet support needs "
                               "pandas+pyarrow (convert to .csv)")
        return _pd.read_parquet(path).to_dict("records")
    with open(path, newline="") as f:
        return list(csv.DictReader(f))


def load_trace(path: str, n_apps: int = 0, max_components: int = 0,
               cfg: ReplayConfig | None = None,
               preset: str | None = None) -> Trace:
    """Parse a replay file into a schema-valid Trace.

    ``preset`` maps a foreign column layout onto the canonical replay
    columns before parsing — e.g. ``preset="azure"`` ingests Azure-VM-
    trace-style long-format readings (see :data:`PRESETS`).  When not
    given explicitly it defaults to ``cfg.preset``.

    Malformed files are detected rather than silently mangled:
    applications out of submission order stable-sort with a warning
    (duplicate arrival times keep file order); component rows sort by
    their declared ``component`` id; duplicate component ids or
    component rows that disagree on per-app scalars (``submit``,
    ``runtime``, ...) raise ``ValueError``.
    """
    if preset is None and cfg is not None and cfg.preset:
        preset = cfg.preset
    if preset:
        transform = PRESETS.get(preset)
        if transform is None:
            raise ValueError(f"unknown replay preset {preset!r} "
                             f"(available: {sorted(PRESETS)})")
    if not os.path.exists(path):
        raise FileNotFoundError(f"replay trace not found: {path}")
    rows = _read_rows(path)
    if preset:
        rows = transform(rows)
    if not rows:
        raise ValueError(f"replay trace {path} is empty")

    by_app: dict = {}
    for r in rows:
        by_app.setdefault(str(r["app_id"]), []).append(r)
    apps = [_check_app(aid, rs) for aid, rs in by_app.items()]
    subs = [float(rs[0]["submit"]) for rs in apps]
    if any(a > b for a, b in zip(subs, subs[1:])):
        # stable sort: ties (duplicate arrival times) keep file order,
        # so re-saving the sorted trace is a fixed point
        warnings.warn(
            f"replay trace {path}: application rows are not in submission "
            "order; stable-sorting by submit (ties keep file order)",
            stacklevel=2)
    apps.sort(key=lambda rs: float(rs[0]["submit"]))
    if n_apps > 0:
        apps = apps[:n_apps]

    N = len(apps)
    width = max(len(rs) for rs in apps)
    if max_components > 0 and width > max_components:
        raise ValueError(f"app with {width} components exceeds "
                         f"max_components={max_components}")
    C = max_components if max_components > 0 else width

    submit = np.zeros(N, np.float32)
    runtime = np.zeros(N, np.float32)
    is_elastic = np.zeros(N, bool)
    is_jumpy = np.zeros(N, bool)
    cpu_req = np.zeros((N, C), np.float32)
    mem_req = np.zeros((N, C), np.float32)
    is_core = np.zeros((N, C), bool)
    levels = np.zeros((N, C, SEGMENTS, 2), np.float32)
    slo = np.zeros(N, np.int64)
    raw_tenant = []

    for gid, rs in enumerate(apps):
        submit[gid] = float(rs[0]["submit"])
        runtime[gid] = float(rs[0]["runtime"])
        is_elastic[gid] = bool(int(rs[0]["is_elastic"]))
        is_jumpy[gid] = bool(int(rs[0]["is_jumpy"]))
        # tenancy columns are optional: tenant-less files back-compat
        # to a single tenant 0 on the "best-effort" SLO class
        raw_tenant.append(rs[0].get("tenant_id"))
        slo[gid] = _slo_code(rs[0].get("slo_class"))
        # components pack into slots 0..k in file order (slot ids in the
        # padded table are positional, not semantic)
        for c, r in enumerate(rs):
            cpu_req[gid, c] = float(r["cpu_req"])
            mem_req[gid, c] = float(r["mem_req"])
            is_core[gid, c] = bool(int(r["is_core"]))
            levels[gid, c, :, CPU] = _parse_levels(r["cpu_levels"])
            levels[gid, c, :, MEM] = _parse_levels(r["mem_levels"])

    exists = cpu_req > 0
    levels = np.clip(levels * exists[:, :, None, None], 0.0, 1.0)
    cols = sort_by_submit(submit, runtime=runtime, is_elastic=is_elastic,
                          is_jumpy=is_jumpy, cpu_req=cpu_req,
                          mem_req=mem_req, is_core=is_core, levels=levels,
                          tenant=_tenant_codes(raw_tenant), slo=slo)
    exists = cols["cpu_req"] > 0
    return Trace(n_core=cols["is_core"].sum(1).astype(np.int64),
                 n_elastic=(exists & ~cols["is_core"]).sum(1).astype(np.int64),
                 cfg=cfg, **cols).validate()


@register("replay", ReplayConfig,
          doc="replay a recorded CSV/Parquet cluster trace")
def build_replay(cfg: ReplayConfig) -> Trace:
    if not cfg.path:
        raise ValueError("ReplayConfig.path is required "
                         "(e.g. make_config('replay', path='trace.csv'))")
    return load_trace(cfg.path, n_apps=cfg.n_apps,
                      max_components=cfg.max_components, cfg=cfg)
