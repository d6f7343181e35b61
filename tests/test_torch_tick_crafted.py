"""The control plane's and the telemetry rings' step of a device-engine
tick (``ref.control_tick`` and ``ref.obs_tick``, the plain versions of
the ``control_tick`` and ``obs_tick`` kernels) against the reference's
compiled fused tick (``repro.sim.step``) on crafted states, on the CPU.

Each cell is a small config with the control plane and the telemetry
rings on: T tenants of 1, 4, 32, 33 and 1,024, slot tables of A = 20,
37 and 128 (one of XLA's 32-slot windows, two off the windows' grid,
four) of C = 3, 5 and 12 components.  Under the baseline policy a
crafted allocation table reaches the control step as it stands; under
the pessimistic policy (two cells, one of them calibrated, and one at
the main path's widths, A = 128 slots of C = 12 for T = 4 tenants and
300 apps on 50 hosts) the shaped demand, the gate and the conformal
counts reach the rings.  The rings' usage and demand sums follow the
order of XLA:CPU's compiled sum (``ref.xla_table_sum``: serial windows
at C = 5 and 12 and off the windows' grid, 8 vector lanes at A = 128 of
C = 3), which is the host's (``tests/test_torch_table_sum.py``).  From
a reference state a few ticks into its run, each case crafts the state
or the trace, then one tick of the reference's program and of the port
(``tstep.fused_tick``) leave the same next state, every field bit for
bit.  The cases: signed zeros in the allocations, the
usage and the tenants' share sums (a tenant whose slots hold only -0, a
window whose first slot is another tenant's); NaN of two payloads and
+-inf in the tables; values near 2^-126, where XLA:CPU reads and
flushes subnormals as zeros; tenant ids of T and more, and -1, in the
trace; an inactive member; and a ring cursor that wraps.  The
reference's programs are compiled once a cell (about 3 s each, 8 s for
the calibrated one and the main widths' cell), and the port runs on one
torch thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from repro import control as rctl
from repro import obs as robs
from repro.core.uncertainty import CalibrationConfig
from repro.sim import ClusterConfig, SimConfig, WorkloadConfig
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro.sim.scenarios.registry import build_trace
from repro_torch import convert
from repro_torch.sim import step as tstep
from test_torch_control import _assert_state, _fields
from test_torch_step import _one_torch_thread  # noqa: F401

TINY = np.float32(2.0**-126)
NAN_A, NAN_B = np.uint32([0x7FC0DEAD, 0xFFC00001]).view(np.float32)

# name: (tenants T, slots A, components C, apps N, hosts, policy, calibration,
# rings)
CELLS = {"T=4, A=20": (4, 20, 5, 40, 3, "baseline", False, True),
         "T=1, A=37": (1, 37, 3, 60, 4, "baseline", False, True),
         "T=32, A=128": (32, 128, 3, 200, 16, "baseline", False, True),
         "T=1024, A=37": (1024, 37, 3, 60, 4, "baseline", False, True),
         "shaped, T=33, A=37": (33, 37, 3, 60, 4, "pessimistic", False, True),
         "every feature": (4, 20, 5, 40, 3, "pessimistic", True, True),
         "main widths, T=4, A=128, C=12": (4, 128, 12, 300, 50, "pessimistic", False, True)}
CONTROL_CASES = ("seeded", "signed zeros", "nan and inf", "near 2^-126",
                 "tenant ids out of range", "inactive member")
CASES = [(cell, c) for cell in ("T=4, A=20", "T=1, A=37", "T=32, A=128", "T=1024, A=37")
         for c in CONTROL_CASES]
CASES += [(cell, c) for cell in ("shaped, T=33, A=37", "every feature")
          for c in CONTROL_CASES + ("cursor wraps",)]
CASES += [(cell, "cursor wraps") for cell in ("T=4, A=20", "T=1, A=37", "T=32, A=128",
                                               "T=1024, A=37")]
CASES += [("main widths, T=4, A=128, C=12", c) for c in CONTROL_CASES + ("cursor wraps",)]


class _Cell:
    """A cell's config, its reference one-tick program, and its reference
    state at the first tick with at least a third of its slots occupied
    (or tick 60)."""

    def __init__(self, name):
        T, A, C, N, H, policy, calibrated, rings = CELLS[name]
        wl_cfg = WorkloadConfig(n_apps=N, max_components=C, max_runtime=1500.0,
                                mean_burst_gap=2.0, mean_long_gap=20.0, seed=5,
                                n_tenants=min(T, 6))
        self.cfg = SimConfig(
            cluster=ClusterConfig(n_hosts=H, max_running_apps=A), workload=wl_cfg,
            max_ticks=3000, policy=policy, forecaster="persist",
            calibration=CalibrationConfig(enabled=calibrated, adaptive=True),
            control=rctl.TenancyConfig(enabled=True, max_tenants=T),
            obs=robs.ObsConfig(enabled=rings, ring=16))
        self.wl = build_trace(wl_cfg)
        self.tr = rstate.DeviceTrace.from_trace(self.wl)
        self.fn = rstep._chunk_fn(self.cfg, 1, rstep._shapes_key(self.wl, self.cfg), False,
                                  None)
        self.pcfg = convert.sim_config_from_dict(dataclasses.asdict(self.cfg))
        self.cap = tstep.host_capacity(self.pcfg, "cpu")
        st = rstate.init_state(self.cfg, self.wl.n_apps, self.wl.max_components)
        for _ in range(60):
            st, _ = self.fn(self.tr, st)
            if int((np.asarray(st.slot_gid) >= 0).sum()) * 3 >= A:
                break
        self.snap = jax.tree.map(np.array, st)
        self.T, self.A, self.C = T, A, C


_CELLS: dict = {}


def _cell(name) -> _Cell:
    if name not in _CELLS:
        _CELLS[name] = _Cell(name)
    return _CELLS[name]


def _owners(cell, st, tr):
    """Each slot's tenant (-1 empty) under the trace ``tr``."""
    return np.where(st.slot_gid >= 0, np.asarray(tr.tenant)[np.maximum(st.slot_gid, 0)], -1)


def _jumpy(tr, apps, level_cpu, level_mem):
    """The trace with the apps' usage fixed at the given levels (a
    step-change profile reads its first knot; requests of 1, so the usage
    is the level itself, exactly)."""
    levels = np.array(tr.levels)
    levels[apps, :, :, 0] = level_cpu
    levels[apps, :, :, 1] = level_mem
    jumpy, cpu, mem = np.array(tr.is_jumpy), np.array(tr.cpu_req), np.array(tr.mem_req)
    jumpy[apps] = True
    live = cpu[apps] > 0
    cpu[apps] = np.where(live, 1.0, 0.0)
    mem[apps] = np.where(live, 1.0, 0.0)
    return dataclasses.replace(tr, levels=jnp.asarray(levels), is_jumpy=jnp.asarray(jumpy),
                               cpu_req=jnp.asarray(cpu), mem_req=jnp.asarray(mem))


def _craft(cell, case, rng):
    """(reference trace, state) of a crafted case."""
    st, tr = jax.tree.map(np.copy, cell.snap), cell.tr
    run = (st.slot_gid >= 0)[:, None] & st.comp_running            # (A, C)
    live = np.nonzero(st.slot_gid >= 0)[0]
    apps = st.slot_gid[live]
    if case == "signed zeros":
        own = _owners(cell, st, tr)
        neg = own == own[live[0]]            # the first occupied slot's tenant: only -0
        signs = np.where(neg[:, None, None] | (rng.random(st.alloc.shape) < 0.5),
                         np.float32(-0.0), np.float32(0.0))
        st.alloc[...] = np.where(run[:, :, None], signs, st.alloc)
        st.tenancy.share_sum[::2] = np.float32(-0.0)
        tr = _jumpy(tr, apps[::2], np.float32(-0.0), np.float32(0.0))
    elif case == "nan and inf":
        vals = np.array([NAN_A, 1.0, np.inf, NAN_B, -np.inf, 2.0, np.inf, -np.inf],
                        np.float32)
        for k, a in enumerate(live[:8]):
            st.alloc[a, 0, k % 2] = vals[k]
            st.alloc[a, -1, 1 - k % 2] = vals[(k + 3) % 8]
        tr = _jumpy(tr, apps[:2], np.array([NAN_A, np.inf], np.float32)[:, None, None],
                    np.array([-np.inf, NAN_B], np.float32)[:, None, None])
    elif case == "near 2^-126":
        tiny = np.array([TINY * 1.5, -TINY, TINY / 4, -TINY / 8, TINY, TINY * 3], np.float32)
        st.alloc[...] = np.where(run[:, :, None], rng.choice(tiny, st.alloc.shape), st.alloc)
        # the usage: 1.5 * 2^-126 and -2^-126 in the first running app's first
        # components, 0 elsewhere, so that the sum is 2^-127, which XLA:CPU
        # flushes; beside it tiny normal values in the other apps
        lv = np.zeros((len(apps), cell.C, 1), np.float32)
        lv[0, :2, 0] = TINY * 1.5, -TINY
        tr = _jumpy(tr, apps, lv, -lv)
    elif case == "tenant ids out of range":
        ten = np.array(tr.tenant)
        ten[apps[::3]] = cell.T
        ten[apps[1::3]] = -1
        ten[::5] = cell.T + 5
        tr = dataclasses.replace(tr, tenant=jnp.asarray(ten))
    elif case == "inactive member":
        st.done[:] = True
    elif case == "cursor wraps":
        st.obs.cursor[...] = 3 * st.obs.f32.shape[-1] - 1
    elif case != "seeded":
        raise ValueError(case)
    return tr, st


@pytest.mark.parametrize("cell,case", CASES, ids=[f"{c}: {k}" for c, k in CASES])
def test_crafted_tick_equals_reference(cell, case):
    """One tick from a crafted state: the port's fused tick, whose control
    and rings steps are ``ref.control_tick`` and ``ref.obs_tick`` here,
    leaves the reference's next state, every field bit for bit."""
    c = _cell(cell)
    tr, before = _craft(c, case, np.random.default_rng(len(case)))
    want, _ = c.fn(tr, jax.tree.map(jnp.asarray, before))
    ptr = convert.device_trace_from_arrays(device="cpu", **_fields(tr))
    got, _ = tstep.fused_tick(c.pcfg, None, ptr,
                              convert.sim_state_from_arrays(device="cpu", **_fields(before)),
                              c.cap)
    _assert_state(got, _fields(want), f"{cell}: {case}")
