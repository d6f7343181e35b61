"""Streaming trace ingestion: a long trace replayed in a bounded window.

Counterpart of ``repro/sim/scenarios/stream.py``.  The device engine's
materialized run uploads the whole trace and sizes every per-app tensor
(the :class:`~repro_torch.sim.state.DeviceTrace` columns and the ``(N,)``
lifecycle fields of :class:`~repro_torch.sim.state.SimState`) by the
trace's app count, and the scheduler kernels stage a member's per-app
columns in one block's shared memory, which caps N (``kernels/sched.py``,
``SMEM_BYTES``).  Only the apps that run or wait at a tick matter to it.
So here the host keeps the full trace and the device sees a ``W``-row
window; at every chunk boundary (where the driver reads the device
anyway) completed rows are harvested into host accumulators, freed, and
re-keyed for the next arrivals.

Correctness contract, as the reference's — streamed equals materialized,
bit for bit:

* every per-tick reduction over the app axis is integer, boolean or a
  minimum (one-hot masked sums, the FIFO head, ``all``), so the window
  cannot change a float sum; FIFO ties break on the global app id
  (``DeviceTrace.gid``), never on the row;
* free rows carry an inert sentinel (``submit = +inf``, zero demand,
  ``arrived = done = True``, gid 0) that every phase and kernel ignores;
* arrivals stay exact: the host replays the float32 clock ``t += tick``
  (the device's own IEEE add, :func:`_f32_ticks`) to load every app due
  inside the next chunk; loading early is safe (the device still gates
  arrival on ``submit <= t``);
* while apps remain, one loaded row stays un-arrived past the chunk's
  horizon, so ``active`` and leap's next arrival see the true next app;
* under leap each chunk's tick budget is also capped at the exact float32
  tick count to the first unloaded arrival (:func:`_ticks_below`), so a
  skip never passes an app the device has not seen.

On the card the window lives in the captured graph's static tensors
(``repro_torch.sim.step._run_stream``): a boundary that changes the
window copies its columns and the re-keyed lifecycle into them, and a
window that grows is a new graph entry at the new W, the run's state moved
into it.  ``StreamConfig`` is itself a registered scenario (``"stream"``)
wrapping any inner scenario config, so replay presets and synthetic
families alike stream through ``run_sim_scan``, ``run_cohort_scan``,
``run_fleet_shard`` and ``run_grid(engine="scan")``; the host engine
``run_sim`` materializes the trace through the registry.
"""
from __future__ import annotations

import dataclasses
from typing import Any

import numpy as np
import torch

from repro_torch.obs.metrics import REGISTRY
from repro_torch.sim.scenarios.registry import build_trace, register
from repro_torch.sim.state import DeviceTrace, SimState

__all__ = ["StreamConfig", "StreamWindow", "auto_window", "run_sim_stream"]

# longest idle run (ticks) the host scouts past the loaded horizon per
# chunk under leap; longer gaps split across boundaries, bit for bit, at
# one chunk per _LEAP_SCOUT ticks
_LEAP_SCOUT = 16_384

# SimState's (N,) per-app lifecycle fields, windowed; everything else in
# the state is slot-, tenant- or ring-indexed and survives re-keying
_LIFE = ("arrived", "queued", "done", "failed", "finish_t", "saved_work", "has_saved")


@dataclasses.dataclass(frozen=True)
class StreamConfig:
    """Streaming wrapper around any registered scenario config.

    ``inner`` is the workload streamed (a replay preset, a synthetic
    family, a fitted config).  The builder materializes the inner trace
    on the host; what the stream bounds is the device footprint, which
    scales with ``window`` (concurrency) instead of the task count.
    ``window = 0`` sizes the window from the slot table
    (:func:`auto_window`); ``seed`` overrides the inner config's seed so
    the sweep's seed axis works unchanged."""

    inner: Any
    window: int = 0
    seed: int | None = None


@register("stream", StreamConfig,
          doc="streaming ingestion wrapper: any scenario in a bounded device window")
def _build(cfg: StreamConfig):
    inner = cfg.inner
    if cfg.seed is not None and hasattr(inner, "seed"):
        inner = dataclasses.replace(inner, seed=cfg.seed)
    return dataclasses.replace(build_trace(inner), cfg=cfg)


def auto_window(cfg, n_apps: int) -> int:
    """Power-of-two device window: twice the slot table (queue and
    prefetch headroom over the peak concurrency), at least 64, at most
    the trace."""
    w = 64
    while w < 2 * cfg.cluster.max_running_apps:
        w *= 2
    return min(max(int(n_apps), 1), w)


def _f32_ticks(t0: float, tick: float, n: int) -> np.float32:
    """The clock after ``n`` device ticks: the float32 recurrence
    ``t += tick``, rounded to nearest as the card's add rounds."""
    t = np.float32(t0)
    tk = np.float32(tick)
    for _ in range(n):
        t = np.float32(t + tk)
    return t


def _ticks_below(t0: float, tick: float, h: float, limit: int) -> int:
    """The most ticks (at most ``limit``) executable from ``t0`` with every
    tick's clock below ``h`` under the float32 recurrence: the leap budget
    cap that keeps a skip from crossing an unloaded arrival."""
    t = np.float32(t0)
    tk = np.float32(tick)
    h32 = np.float32(h)
    k = 0
    while k < limit:
        nt = np.float32(t + tk)
        if not nt < h32:
            break
        t = nt
        k += 1
    return k


class StreamWindow:
    """Host-side manager of the bounded device window.

    Owns the full host trace, the ``row -> global app`` map, the free rows
    and the harvested global lifecycle.  :meth:`refill` runs at every
    chunk boundary; :meth:`finalize` puts the global lifecycle into the
    final state for the drain."""

    def __init__(self, wl, window: int):
        self.wl = wl
        self.N = int(wl.n_apps)
        self.C = int(wl.max_components)
        self.W = min(max(int(window), 1), max(self.N, 1))
        # the full trace's columns in their final dtypes, on the host
        self._sub = np.ascontiguousarray(wl.submit, np.float32)
        self._cols = dict(
            runtime=np.ascontiguousarray(wl.runtime, np.float32),
            cpu_req=np.ascontiguousarray(wl.cpu_req, np.float32),
            mem_req=np.ascontiguousarray(wl.mem_req, np.float32),
            is_core=np.ascontiguousarray(wl.is_core, bool),
            is_jumpy=np.ascontiguousarray(wl.is_jumpy, bool),
            levels=np.ascontiguousarray(wl.levels, np.float32),
            tenant=np.ascontiguousarray(wl.tenant, np.int32))
        self.next_load = 0
        self.row_app = np.full(self.W, -1, np.int64)
        self.done_g = np.zeros(self.N, bool)
        self.failed_g = np.zeros(self.N, bool)
        self.finish_g = np.zeros(self.N, np.float32)
        self.peak_rows = 0
        self.grows = 0
        self._alloc_window(self.W)

    # -- window column storage -----------------------------------------

    def _alloc_window(self, W: int) -> None:
        S2 = self._cols["levels"].shape[2:]          # (SEGMENTS, 2)
        self.w_submit = np.full(W, np.inf, np.float32)
        self.w_runtime = np.ones(W, np.float32)
        self.w_cpu = np.zeros((W, self.C), np.float32)
        self.w_mem = np.zeros((W, self.C), np.float32)
        self.w_core = np.zeros((W, self.C), bool)
        self.w_jumpy = np.zeros(W, bool)
        self.w_levels = np.zeros((W, self.C) + S2, np.float32)
        self.w_tenant = np.zeros(W, np.int32)
        self.w_gid = np.zeros(W, np.int32)

    def _grow(self, need_free: int) -> None:
        """Double the window until ``need_free`` rows are free (a grow
        event: the next chunk runs a program of the new W)."""
        old_w, occ = self.W, int((self.row_app >= 0).sum())
        target = occ + need_free        # <= N: occupied + unloaded apps
        W = self.W
        while W < target:
            W *= 2
        W = max(min(W, max(self.N, 1)), target)
        olds = (self.w_submit, self.w_runtime, self.w_cpu, self.w_mem,
                self.w_core, self.w_jumpy, self.w_levels, self.w_tenant,
                self.w_gid)
        old_map = self.row_app
        self._alloc_window(W)
        for old, new in zip(olds, (self.w_submit, self.w_runtime,
                                   self.w_cpu, self.w_mem, self.w_core,
                                   self.w_jumpy, self.w_levels,
                                   self.w_tenant, self.w_gid)):
            new[:old_w] = old
        self.row_app = np.full(W, -1, np.int64)
        self.row_app[:old_w] = old_map
        self.W = W
        self.grows += 1
        REGISTRY.counter("stream.window_grow").inc()
        REGISTRY.gauge("stream.window_rows").set(W)

    def _clear_rows(self, rows: np.ndarray) -> None:
        self.w_submit[rows] = np.inf
        self.w_runtime[rows] = 1.0
        self.w_cpu[rows] = 0.0
        self.w_mem[rows] = 0.0
        self.w_core[rows] = False
        self.w_jumpy[rows] = False
        self.w_levels[rows] = 0.0
        self.w_tenant[rows] = 0
        self.w_gid[rows] = 0

    def _set_rows(self, rows: np.ndarray, apps: np.ndarray) -> None:
        c = self._cols
        self.w_submit[rows] = self._sub[apps]
        self.w_runtime[rows] = c["runtime"][apps]
        self.w_cpu[rows] = c["cpu_req"][apps]
        self.w_mem[rows] = c["mem_req"][apps]
        self.w_core[rows] = c["is_core"][apps]
        self.w_jumpy[rows] = c["is_jumpy"][apps]
        self.w_levels[rows] = c["levels"][apps]
        self.w_tenant[rows] = c["tenant"][apps]
        self.w_gid[rows] = apps.astype(np.int32)

    # -- device views ---------------------------------------------------

    @property
    def exhausted(self) -> bool:
        return self.next_load >= self.N

    def device_trace(self, device) -> DeviceTrace:
        """The window's columns as a one-member trace on ``device``, each
        row's gid its global app id."""
        return DeviceTrace.from_columns(
            device, submit=self.w_submit, runtime=self.w_runtime, cpu_req=self.w_cpu,
            mem_req=self.w_mem, is_core=self.w_core, is_jumpy=self.w_jumpy,
            levels=self.w_levels, tenant=self.w_tenant, gid=self.w_gid)

    def seal_free(self, st: SimState) -> SimState:
        """Mark every unoccupied row with the inert sentinel lifecycle
        (``arrived = done = True``) on a fresh ``init_state``."""
        free = torch.from_numpy(self.row_app < 0)[None].to(st.done.device)
        return dataclasses.replace(st, arrived=st.arrived | free, done=st.done | free)

    # -- the chunk-boundary protocol ------------------------------------

    def refill(self, st: SimState, *, t0: float, tick: float, size: int, leap: bool,
               chunk: int):
        """Harvest, load, re-key.  Returns ``(st, changed, leap_cap)``:
        ``changed`` means the window's columns or lifecycle moved (the
        returned state's ``_LIFE`` fields are new tensors, of the new W if
        the window grew); ``leap_cap`` is the chunk's tick-budget cap
        (None: the stream is exhausted)."""
        done = st.done[0].cpu().numpy()

        # 1. harvest completed rows into the global accumulators
        harv = (self.row_app >= 0) & done[:self.W]
        freed = np.nonzero(harv)[0]
        if freed.size:
            g = self.row_app[freed]
            self.done_g[g] = True
            self.failed_g[g] = st.failed[0].cpu().numpy()[freed]
            self.finish_g[g] = st.finish_t[0].cpu().numpy()[freed]
            self.row_app[freed] = -1
            self._clear_rows(freed)

        # 2. apps due inside the chunk: the float32 clock's bound (a
        # uniform chunk runs exactly `size` ticks; under leap the nominal
        # horizon, and the cap below owns correctness past it)
        t_end = float(_f32_ticks(t0, tick, size))
        beyond = int(np.searchsorted(self._sub, np.float32(t_end), side="right"))
        hi = max(beyond, self.next_load)

        # 3. prefetch invariant: one loaded row un-arrived past the
        # horizon.  Loads are in submit order, so apps in [beyond,
        # next_load) are loaded rows past it; only when that range is
        # empty does one more app need loading
        if hi < self.N and beyond >= self.next_load:
            hi += 1

        # 4. leap budget cap: the float32 tick count to the first
        # unloaded arrival; load the apps that would cap the chunk below
        # its step count, so a chunk always makes min(budget, chunk) ticks
        cap = None
        if leap:
            while hi < self.N:
                cap = _ticks_below(t0, tick, float(self._sub[hi]), _LEAP_SCOUT)
                if cap >= chunk:
                    break
                hi += 1
                cap = None

        # 5. assign due apps to free rows (grow on overflow)
        to_load = np.arange(self.next_load, hi)
        if to_load.size:
            free_rows = np.nonzero(self.row_app < 0)[0]
            if to_load.size > free_rows.size:
                self._grow(to_load.size)
                free_rows = np.nonzero(self.row_app < 0)[0]
            rows = free_rows[:to_load.size]
            self._set_rows(rows, to_load)
            self.row_app[rows] = to_load
            self.next_load = hi

        self.peak_rows = max(self.peak_rows, int((self.row_app >= 0).sum()))
        changed = bool(freed.size) or bool(to_load.size)
        if changed:
            st = self._push_lifecycle(st, freed, to_load)
        return st, changed, cap

    def _push_lifecycle(self, st: SimState, freed: np.ndarray,
                        loaded_apps: np.ndarray) -> SimState:
        """Re-key the (W,) lifecycle fields: freed rows get the inert
        sentinel, loaded rows a virgin lifecycle; grown rows appear as
        sentinel free rows."""
        life = {f: getattr(st, f)[0].cpu().numpy().copy() for f in _LIFE}
        W0 = life["done"].shape[0]
        if self.W > W0:                       # the window grew this refill
            for f, v in life.items():
                pad = np.zeros(self.W - W0, v.dtype)
                if f in ("arrived", "done"):
                    pad[:] = True
                life[f] = np.concatenate([v, pad])
        sentinel = dict(arrived=True, queued=False, done=True, failed=False,
                        finish_t=0.0, saved_work=0.0, has_saved=False)
        virgin = {**sentinel, "arrived": False, "done": False}
        if freed.size:
            for f, v in sentinel.items():
                life[f][freed] = v
        if loaded_apps.size:
            rows = np.nonzero(np.isin(self.row_app, loaded_apps))[0]
            for f, v in virgin.items():
                life[f][rows] = v
        dev = st.done.device
        return dataclasses.replace(
            st, **{f: torch.from_numpy(v)[None].to(dev) for f, v in life.items()})

    # -- final drain ----------------------------------------------------

    def finalize(self, state: dict) -> dict:
        """One member's final state (numpy arrays by field, as
        ``drain_results`` takes it) with the harvested global ``(N,)``
        lifecycle in place of the window's, so the drain (turnaround,
        failed set, tenancy summary) sees every app of the trace."""
        rows = np.nonzero(self.row_app >= 0)[0]
        if rows.size:
            g = self.row_app[rows]
            self.done_g[g] = state["done"][rows]
            self.failed_g[g] = state["failed"][rows]
            self.finish_g[g] = state["finish_t"][rows]
        return {**state, "done": self.done_g.copy(), "failed": self.failed_g.copy(),
                "finish_t": self.finish_g.copy()}

    def stats(self) -> dict:
        return {"window_rows": int(self.W),
                "peak_rows": int(self.peak_rows),
                "grows": int(self.grows),
                "n_apps": int(self.N),
                "loaded": int(self.next_load)}


def run_sim_stream(cfg, wl=None, *, chunk: int = 32, window: int = 0,
                   stats: dict | None = None, device: str | torch.device = "cuda"):
    """Run one simulation with streamed ingestion on the device engine.

    Equal to ``run_sim_scan`` on the materialized trace, bit for bit; the
    device footprint scales with the window (peak concurrency) instead of
    the task count.  ``window`` (else ``cfg.workload.window`` when that is
    a :class:`StreamConfig`, else :func:`auto_window`) sets the initial
    rows; ``stats`` (a dict) receives the window's telemetry: final rows,
    peak occupied rows, grow events, apps and apps loaded.  ``device`` as
    ``run_sim_scan``'s: CUDA unless the caller asks for the CPU; on the
    card every chunk is a replayed CUDA graph."""
    from repro_torch.device import resolve_device
    from repro_torch.sim.step import _run_stream
    dev = resolve_device(device)
    if wl is None:
        wl = build_trace(cfg.workload)
    if not window and isinstance(cfg.workload, StreamConfig):
        window = cfg.workload.window
    win = StreamWindow(wl, window or auto_window(cfg, wl.n_apps))
    res = _run_stream(cfg, wl, win, chunk, dev)
    if stats is not None:
        stats.update(win.stats())
    return res
