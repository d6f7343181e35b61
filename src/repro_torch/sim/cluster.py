"""Cluster state + mechanics for the discrete-event simulation (paper §4.1).

A copy of ``repro/sim/cluster.py`` (numpy only): the engine keeps the
slot table, placement and OOM handling on the host, as the reference's
host engine does.

Default geometry matches the paper: 250 homogeneous machines, 32 cores,
128 GB each (scaled down by configs for CI-speed runs).  The cluster
holds a fixed slot table of running applications (A slots x C components)
— the same padded layout the shaping policies consume — plus the
placement, preemption and OOM mechanics that the engine drives.

OOM semantics: Docker soft limits mean a component may use more than its
allocation while the host has headroom; only when a host's total usage
exceeds its capacity does the "OS" step in and kill — victim order is the
largest (usage - allocation) overage first, the closest analogue of the
kernel badness score, and exactly the "unpredictable, application
agnostic" behavior the paper's pessimistic policy is designed to avoid.
"""
from __future__ import annotations

import dataclasses

import numpy as np

from repro_torch.sim.scenarios.schema import Trace as Workload

CPU, MEM = 0, 1


@dataclasses.dataclass(frozen=True)
class ClusterConfig:
    n_hosts: int = 50
    host_cpu: float = 32.0
    host_mem: float = 128.0
    max_running_apps: int = 128     # slot-table A (padded, JAX-fixed)
    tick: float = 60.0              # monitoring interval (paper: 1 min)


class Cluster:
    def __init__(self, cfg: ClusterConfig, max_components: int):
        self.cfg = cfg
        A, C, H = cfg.max_running_apps, max_components, cfg.n_hosts
        self.A, self.C, self.H = A, C, H
        self.host_cap = np.zeros((H, 2), np.float32)
        self.host_cap[:, CPU] = cfg.host_cpu
        self.host_cap[:, MEM] = cfg.host_mem
        self.slot_gid = np.full((A,), -1, np.int64)
        self.start_time = np.zeros((A,), np.float32)
        self.work_done = np.zeros((A,), np.float32)
        self.comp_running = np.zeros((A, C), bool)
        self.comp_host = np.zeros((A, C), np.int32)
        self.alloc = np.zeros((A, C, 2), np.float32)
        self.alive_since = np.zeros((A, C), np.float32)

    # ------------------------------------------------------------------
    # resource accounting
    # ------------------------------------------------------------------
    def running_slots(self) -> np.ndarray:
        return np.nonzero(self.slot_gid >= 0)[0]

    def free_resources(self) -> np.ndarray:
        """(H, 2) capacity minus committed allocations."""
        used = np.zeros((self.H, 2), np.float32)
        run = self.comp_running
        for r in (CPU, MEM):
            np.add.at(used[:, r], self.comp_host[run],
                      self.alloc[:, :, r][run])
        return self.host_cap - used

    def host_usage(self, usage: np.ndarray) -> np.ndarray:
        """usage: (A, C, 2) instantaneous -> (H, 2) per-host totals."""
        tot = np.zeros((self.H, 2), np.float32)
        run = self.comp_running
        for r in (CPU, MEM):
            np.add.at(tot[:, r], self.comp_host[run], usage[:, :, r][run])
        return tot

    # ------------------------------------------------------------------
    # placement (worst fit = most-free host, for load balance — the
    # paper's cited schedulers re-balance load across hosts [Mercury];
    # first-fit would cram host 0 and manufacture artificial contention)
    # ------------------------------------------------------------------
    def _fit_component(self, free: np.ndarray, cpu: float, mem: float) -> int:
        ok = (free[:, CPU] >= cpu) & (free[:, MEM] >= mem)
        if not ok.any():
            return -1
        score = np.where(ok, free[:, MEM], -np.inf)
        return int(np.argmax(score))

    def admit(self, gid: int, wl: Workload, t: float) -> int:
        """Place an app: all CORE components must fit (else reject);
        elastic components placed best-effort.  Returns slot or -1."""
        empty = np.nonzero(self.slot_gid < 0)[0]
        if empty.size == 0:
            return -1
        slot = int(empty[0])
        free = self.free_resources().copy()
        C = self.C
        placement = np.full((C,), -1, np.int32)
        for c in range(C):
            if wl.cpu_req[gid, c] == 0:
                continue
            if not wl.is_core[gid, c]:
                continue
            h = self._fit_component(free, wl.cpu_req[gid, c], wl.mem_req[gid, c])
            if h < 0:
                return -1  # core does not fit -> stays queued
            placement[c] = h
            free[h, CPU] -= wl.cpu_req[gid, c]
            free[h, MEM] -= wl.mem_req[gid, c]
        for c in range(C):
            if wl.cpu_req[gid, c] == 0 or wl.is_core[gid, c]:
                continue
            h = self._fit_component(free, wl.cpu_req[gid, c], wl.mem_req[gid, c])
            if h >= 0:
                placement[c] = h
                free[h, CPU] -= wl.cpu_req[gid, c]
                free[h, MEM] -= wl.mem_req[gid, c]
        # commit
        self.slot_gid[slot] = gid
        self.start_time[slot] = t
        self.work_done[slot] = 0.0
        placed = placement >= 0
        self.comp_running[slot] = placed
        self.comp_host[slot] = np.maximum(placement, 0)
        self.alloc[slot, :, CPU] = np.where(placed, wl.cpu_req[gid], 0.0)
        self.alloc[slot, :, MEM] = np.where(placed, wl.mem_req[gid], 0.0)
        self.alive_since[slot] = t
        return slot

    def place_missing_elastic(self, wl: Workload, t: float) -> int:
        """Best-effort (re)placement of elastic components at reservation.

        The (slot, component) candidates are found with one array scan
        over the slot table; only the usually-tiny set of actually-missing
        elastic components is walked sequentially (placement is order-
        dependent: each fit consumes free capacity).  Walk order is
        row-major (slot asc, component asc) — identical to the seed's
        nested loops."""
        gid_safe = np.maximum(self.slot_gid, 0)
        missing = ((self.slot_gid >= 0)[:, None]
                   & (wl.cpu_req[gid_safe] > 0)
                   & ~wl.is_core[gid_safe]
                   & ~self.comp_running)
        slots, comps = np.nonzero(missing)
        if slots.size == 0:
            return 0
        placed = 0
        free = self.free_resources().copy()
        for slot, c in zip(slots, comps):
            gid = self.slot_gid[slot]
            h = self._fit_component(free, wl.cpu_req[gid, c],
                                    wl.mem_req[gid, c])
            if h < 0:
                continue
            self.comp_running[slot, c] = True
            self.comp_host[slot, c] = h
            self.alloc[slot, c, CPU] = wl.cpu_req[gid, c]
            self.alloc[slot, c, MEM] = wl.mem_req[gid, c]
            self.alive_since[slot, c] = t
            free[h, CPU] -= wl.cpu_req[gid, c]
            free[h, MEM] -= wl.mem_req[gid, c]
            placed += 1
        return placed

    # ------------------------------------------------------------------
    # preemption primitives
    # ------------------------------------------------------------------
    def kill_component(self, slot: int, c: int) -> None:
        self.comp_running[slot, c] = False
        self.alloc[slot, c] = 0.0

    def kill_components(self, slots: np.ndarray, comps: np.ndarray) -> None:
        """Batched ``kill_component`` over parallel (slot, comp) arrays."""
        self.comp_running[slots, comps] = False
        self.alloc[slots, comps] = 0.0

    def evict_app(self, slot: int) -> int:
        gid = int(self.slot_gid[slot])
        self.slot_gid[slot] = -1
        self.comp_running[slot] = False
        self.alloc[slot] = 0.0
        self.work_done[slot] = 0.0
        return gid

    def evict_apps(self, slots: np.ndarray) -> np.ndarray:
        """Batched ``evict_app``: returns the evicted gids."""
        gids = self.slot_gid[slots].copy()
        self.slot_gid[slots] = -1
        self.comp_running[slots] = False
        self.alloc[slots] = 0.0
        self.work_done[slots] = 0.0
        return gids

    # ------------------------------------------------------------------
    # progress & OOM
    # ------------------------------------------------------------------
    def progress_rate(self, wl: Workload) -> np.ndarray:
        """(A,) work/second.  rate = (1 + running elastic)/(1 + n_elastic);
        a full component set progresses at 1.0 (base runtime)."""
        rate = np.zeros((self.A,), np.float32)
        run = self.running_slots()
        if run.size == 0:
            return rate
        gids = self.slot_gid[run]
        is_core = wl.is_core[gids]
        exists = wl.cpu_req[gids] > 0
        running = self.comp_running[run]
        core_ok = ((is_core & running).sum(1) == is_core.sum(1))
        n_el = (exists & ~is_core).sum(1)
        n_run_el = (running & ~is_core).sum(1)
        rate[run] = core_ok * (1.0 + n_run_el) / (1.0 + n_el)
        return rate

    def progress(self, wl: Workload) -> np.ndarray:
        """(A,) fraction of work completed, for pattern lookup."""
        p = np.zeros((self.A,), np.float32)
        run = self.running_slots()
        if run.size:
            gids = self.slot_gid[run]
            p[run] = np.clip(self.work_done[run] / wl.runtime[gids], 0.0, 1.0)
        return p

    def usage_now(self, wl: Workload) -> np.ndarray:
        """(A, C, 2) instantaneous usage of running components."""
        out = np.zeros((self.A, self.C, 2), np.float32)
        run = self.running_slots()
        if run.size:
            gids = self.slot_gid[run]
            u = wl.usage(gids, self.progress(wl)[run])
            out[run] = u * self.comp_running[run][:, :, None]
        return out

    def resolve_oom(self, wl: Workload, usage: np.ndarray):
        """OS OOM handler: for every over-capacity host, kill components by
        descending (usage - allocation) overage until the host fits.
        Returns (full_kill_slots, partial_kills [(slot, c)]).

        Each victim selection is one array scan over the slot table
        (candidate membership, totals and the argmax are NumPy ops); the
        outer loop runs once per actual kill, i.e. O(events) not
        O(slots x components) Python iterations.  Victim order matches the
        seed's ``sort(reverse=True)`` tuple ordering exactly: largest
        overage first, ties broken by largest slot then largest component
        (``np.nonzero`` is row-major, so the last tied index wins)."""
        full, partial = [], []
        host_tot = self.host_usage(usage)
        over_hosts = np.nonzero(host_tot[:, MEM] > self.host_cap[:, MEM] + 1e-6)[0]
        for h in over_hosts:
            while True:
                on_h = self.comp_running & (self.comp_host == h)
                mem = usage[:, :, MEM]
                vals = mem[on_h]
                # sequential float32 accumulation in row-major order —
                # bit-identical to the seed loop's `tot += usage[...]`
                # (NEP-50: 0.0 + float32 stays float32); a pairwise or
                # float64 sum can flip the near-capacity stop condition
                tot = vals.cumsum(dtype=np.float32)[-1] if vals.size else 0.0
                if tot <= self.host_cap[h, MEM] + 1e-6 or not vals.size:
                    break
                over = np.where(on_h, mem - self.alloc[:, :, MEM], -np.inf)
                cand_s, cand_c = np.nonzero(over == over.max())
                slot, c = int(cand_s[-1]), int(cand_c[-1])
                gid = int(self.slot_gid[slot])
                if wl.is_core[gid, c]:
                    usage[slot] = 0.0
                    self.evict_app(slot)
                    full.append(gid)
                else:
                    usage[slot, c] = 0.0
                    self.kill_component(slot, c)
                    partial.append((slot, c))
        return full, partial
