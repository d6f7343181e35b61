"""The device engine's sequential programs against the JAX reference:
Algorithm 1's pass (``ref.pessimistic_pass`` through
``pessimistic_shape``) and the scheduler's event loops
(``ref.resolve_oom``, ``ref.admit_queued``, ``ref.place_missing_elastic``
through the tick helpers of ``repro_torch.sim.step``), on states captured
from reference runs of ``quick_base_config`` and on seeded random tables
built to tie; and the CUDA kernels against those plain versions (card
only, ``-m gpu``).

Decisions are discrete and must be equal; the float tables they leave
behind must agree to rtol 1e-6.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from chip_smoke import EDGE_KINDS, edge_member
from repro.core import shaper as rshaper
from repro.core.shaper import pessimistic_shape_raw
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro.sim.scenarios.registry import build_trace
from repro_torch import convert
from repro_torch.core.shaper import ShapeProblem, pessimistic_shape
from repro_torch.kernels import ops, ref, sched, shaper
from repro_torch.sim import step as tstep
from test_torch_engine import quick_base_config

DECISIONS = ("kill_app", "kill_comp", "alloc_cpu", "alloc_mem", "cpu_free", "mem_free")


def _fields(obj):
    return {f.name: np.asarray(getattr(obj, f.name)) for f in dataclasses.fields(obj)
            if getattr(obj, f.name) is not None}


def _port(rtr, rst):
    return (convert.device_trace_from_arrays(device="cpu", **_fields(rtr)),
            convert.sim_state_from_arrays(device="cpu", **_fields(rst)))


def _cap(H, cpu, mem):
    return np.tile(np.asarray([[cpu, mem]], np.float32), (H, 1))


def _assert_same(got: dict, want: dict):
    """Port tensors (leading member axis 1) against reference arrays."""
    for name, w in want.items():
        g = got[name].numpy()[0]
        w = np.asarray(w)
        if w.dtype.kind == "f":
            np.testing.assert_allclose(g, w, rtol=1e-6, err_msg=name)
        else:
            np.testing.assert_array_equal(g, w, err_msg=name)


# ----------------------------------------------------------------------
# fixtures: reference states and seeded random tables
# ----------------------------------------------------------------------

CAPTURE_TICKS = range(4, 60, 4)


@pytest.fixture(scope="module")
def captured():
    """(cfg, trace, state) at every 4th tick of reference runs of
    quick_base_config: persist forecasts under the pessimistic and the
    optimistic policy (the second over-commits hosts, so the OS OOM
    handler has victims)."""
    out = []
    for policy in ("pessimistic", "optimistic"):
        cfg = dataclasses.replace(quick_base_config(), forecaster="persist", policy=policy)
        wl = build_trace(cfg.workload)
        tr = rstate.DeviceTrace.from_trace(wl)
        st = rstate.init_state(cfg, wl.n_apps, wl.max_components)
        fn = rstep._chunk_fn(cfg, 1, rstep._shapes_key(wl, cfg), False, None)
        for k in range(max(CAPTURE_TICKS) + 1):
            if k in CAPTURE_TICKS:   # a copy: the chunk step donates its state
                out.append((cfg, tr, jax.tree.map(lambda x: jnp.array(x, copy=True), st)))
            st, _ = fn(tr, st)
    return out


def _random_case(seed, A=16, C=4, N=24, H=3):
    """A reference (cfg, DeviceTrace, SimState, usage) whose values come
    from small discrete sets, so that hosts tie on free memory, apps on
    submit time and components on memory overage."""
    rng = np.random.default_rng(seed)
    n_comp = rng.integers(1, C + 1, N)
    n_core = np.minimum(rng.integers(1, 3, N), n_comp)
    idx = np.arange(C)[None, :]
    exists = idx < n_comp[:, None]
    is_core = idx < n_core[:, None]
    cpu_req = np.where(exists, rng.choice([0.5, 1.0, 2.0], (N, C)), 0).astype(np.float32)
    mem_req = np.where(exists, rng.choice([2.0, 4.0, 6.0], (N, C)), 0).astype(np.float32)
    submit = np.sort(rng.integers(0, 6, N) * 10.0).astype(np.float32)
    levels = np.zeros((N, C, 32, 2), np.float32)
    wl = dict(submit=submit, runtime=np.full(N, 600.0, np.float32), cpu_req=cpu_req,
              mem_req=mem_req, is_core=is_core, is_jumpy=np.zeros(N, bool),
              levels=levels, exists=exists, tenant=np.zeros(N, np.int32),
              gid=np.arange(N, dtype=np.int32))
    apps = rng.permutation(N)
    n_slot = rng.integers(A // 2, A + 1)
    slot_gid = np.full(A, -1, np.int32)
    slots = rng.choice(A, n_slot, replace=False)
    slot_gid[slots] = apps[:n_slot]
    g = np.maximum(slot_gid, 0)
    run = (slot_gid >= 0)[:, None] & exists[g] & (is_core[g] | (rng.random((A, C)) < 0.6))
    host = np.where(run, rng.integers(0, H, (A, C)), 0).astype(np.int32)
    alloc = np.stack([cpu_req[g], mem_req[g]], -1) * run[:, :, None]
    alloc = (alloc * rng.choice([0.5, 1.0], (A, C, 1))).astype(np.float32)
    usage = (alloc * rng.choice([1.0, 1.5, 2.0], (A, C, 1))).astype(np.float32)
    queued = np.zeros(N, bool)
    queued[apps[n_slot:]] = rng.random(N - n_slot) < 0.8
    z = lambda *s, dt=np.float32: np.zeros(s, dt)  # noqa: E731
    st = dict(slot_gid=slot_gid, work_done=rng.uniform(0, 300, A).astype(np.float32),
              comp_running=run, comp_host=host, alloc=alloc,
              alive_since=(60.0 * rng.integers(0, 3, (A, C))).astype(np.float32),
              mon_buf=z(A * C, 24, 2), mon_count=z(A * C, dt=np.int32),
              arrived=np.ones(N, bool), queued=queued, done=z(N, dt=bool),
              failed=z(N, dt=bool), finish_t=z(N),
              saved_work=rng.uniform(0, 300, N).astype(np.float32),
              has_saved=rng.random(N) < 0.5, t=np.float32(300.0),
              failure_events=np.int32(0), oom_kills=np.int32(0),
              full_preemptions=np.int32(0), partial_preemptions=np.int32(0))
    rtr = rstate.DeviceTrace(**{k: jnp.asarray(v) for k, v in wl.items()})
    rst = rstate.SimState(**{k: jnp.asarray(v) for k, v in st.items()},
                          calib=None, tenancy=None, obs=None)
    cap = _cap(H, rng.choice([6.0, 8.0]), rng.choice([16.0, 24.0]))
    return rtr, rst, usage, cap


def _cases(captured):
    """Every (trace, state, usage, host_cap) of the captured and random
    fixtures; usage of a captured state is the reference's usage at its
    current progress."""
    usage_at = jax.jit(rstep._usage_at)
    for cfg, tr, st in captured:
        prog = jnp.clip(st.work_done / tr.runtime[jnp.maximum(st.slot_gid, 0)], 0.0, 1.0)
        yield tr, st, np.asarray(usage_at(tr, st, prog)), _cap(
            cfg.cluster.n_hosts, cfg.cluster.host_cpu, cfg.cluster.host_mem)
    for seed in range(24):
        yield _random_case(seed)


# ----------------------------------------------------------------------
# plain versions against the reference
# ----------------------------------------------------------------------

def test_resolve_oom_equals_reference(captured):
    fn = jax.jit(rstep._resolve_oom)
    kills = parts = 0
    for rtr, rst, usage, cap in _cases(captured):
        want_st, want_usage, want_reset = fn(rtr, rst, jnp.asarray(usage), jnp.asarray(cap))
        ptr, pst = _port(rtr, rst)
        got_st, got_usage, got_reset = tstep._resolve_oom(
            ptr, pst, torch.tensor(usage)[None], torch.as_tensor(cap))
        _assert_same({"usage": got_usage, "monreset": got_reset,
                      **{k: getattr(got_st, k) for k in _fields(want_st)}},
                     {"usage": want_usage, "monreset": want_reset, **_fields(want_st)})
        kills += int(want_st.oom_kills)
        parts += int(want_st.partial_preemptions)
    assert kills > 0 and parts > 0, (kills, parts)


def test_oom_victim_ties_pick_the_largest_flat_index():
    """Two components on an over-full host with the same overage: the
    reference kills the one with the larger (slot, component) index."""
    rtr, rst, usage, cap = _random_case(0)
    A, C = np.asarray(rst.comp_running).shape
    fields = _fields(rst)
    fields["comp_running"] = np.zeros((A, C), bool)
    fields["slot_gid"] = np.asarray(fields["slot_gid"]).copy()
    g = np.flatnonzero(np.asarray(rtr.exists).sum(1) >= 2)[:2]
    fields["slot_gid"][:2] = g
    for a in (0, 1):
        fields["comp_running"][a, :2] = np.asarray(rtr.exists)[g[a], :2]
    fields["comp_host"] = np.zeros((A, C), np.int32)
    fields["alloc"] = np.zeros((A, C, 2), np.float32)
    usage = np.zeros((A, C, 2), np.float32)
    usage[:2, :2, 1] = 20.0               # 80 GB on a 24 GB host; four equal overages
    rst = rstate.SimState(**{k: jnp.asarray(v) for k, v in fields.items()},
                          calib=None, tenancy=None, obs=None)
    cap = _cap(3, 8.0, 24.0)
    want_st, want_usage, want_reset = rstep._resolve_oom(
        rtr, rst, jnp.asarray(usage), jnp.asarray(cap))
    ptr, pst = _port(rtr, rst)
    got_st, got_usage, got_reset = tstep._resolve_oom(
        ptr, pst, torch.as_tensor(usage)[None], torch.as_tensor(cap))
    _assert_same({"usage": got_usage, "slot_gid": got_st.slot_gid,
                  "comp_running": got_st.comp_running, "monreset": got_reset},
                 {"usage": want_usage, "slot_gid": want_st.slot_gid,
                  "comp_running": want_st.comp_running, "monreset": want_reset})
    # the first victim is the tied component of the largest flat index
    assert np.asarray(want_usage)[1, 1, 1] == 0.0 and int(want_st.oom_kills
                                                          + want_st.partial_preemptions) > 0


def test_admit_queued_equals_reference(captured):
    for resume in (False, True):
        cfg = dataclasses.replace(quick_base_config(), work_lost_on_kill=not resume)
        fn = jax.jit(lambda tr, st, t, cap: rstep._admit_queued(cfg, tr, st, t, cap))
        admitted = 0
        for rtr, rst, _, cap in _cases(captured):
            t = rst.t + jnp.float32(60.0)
            want_st, want_resets = fn(rtr, rst, t, jnp.asarray(cap))
            ptr, pst = _port(rtr, rst)
            pcfg = convert.sim_config_from_dict(dataclasses.asdict(cfg))
            got_st, got_resets = tstep._admit_queued(
                pcfg, ptr, pst, torch.tensor(np.asarray(t))[None], torch.as_tensor(cap))
            _assert_same({"resets": got_resets,
                          **{k: getattr(got_st, k) for k in _fields(want_st)}},
                         {"resets": want_resets, **_fields(want_st)})
            admitted += int(np.asarray(rst.queued).sum() - np.asarray(want_st.queued).sum())
        assert admitted > 0


def test_place_missing_elastic_equals_reference(captured):
    fn = jax.jit(rstep._place_missing_elastic)
    placed = 0
    for rtr, rst, _, cap in _cases(captured):
        t = rst.t + jnp.float32(60.0)
        want = fn(rtr, rst, t, jnp.asarray(cap))
        ptr, pst = _port(rtr, rst)
        got = tstep._place_missing_elastic(ptr, pst, torch.tensor(np.asarray(t))[None],
                                           torch.as_tensor(cap))
        _assert_same({k: getattr(got, k) for k in _fields(want)}, _fields(want))
        placed += int(np.asarray(want.comp_running).sum() - np.asarray(rst.comp_running).sum())
    assert placed > 0


def _random_problems(seed, S=3, A=24, C=6, H=5):
    """S over-committed clusters as reference ShapeProblem arrays: demands
    and capacities from small discrete sets (hosts and components tie),
    ages from a few values (elastic components tie on age), and the live
    apps in a random order followed by -1 padding."""
    rng = np.random.default_rng(seed)
    out = []
    for _ in range(S):
        app_exists = rng.random(A) < 0.8
        n_comp = rng.integers(1, C + 1, A)
        n_core = np.minimum(rng.integers(1, 4, A), n_comp)
        idx = np.arange(C)[None, :]
        comp_exists = (idx < n_comp[:, None]) & app_exists[:, None]
        live = np.flatnonzero(app_exists)
        order = np.full(A, -1, np.int32)
        order[:live.size] = rng.permutation(live)
        out.append(dict(
            host_cpu=rng.choice([6.0, 8.0], H).astype(np.float32),
            host_mem=rng.choice([24.0, 32.0], H).astype(np.float32),
            app_exists=app_exists, app_order=order, comp_exists=comp_exists,
            comp_core=(idx < n_core[:, None]) & app_exists[:, None],
            comp_host=np.where(comp_exists, rng.integers(0, H, (A, C)), 0).astype(np.int32),
            comp_cpu=np.where(comp_exists, rng.choice([0.5, 1.0, 1.5], (A, C)), 0
                              ).astype(np.float32),
            comp_mem=np.where(comp_exists, rng.choice([1.0, 2.0, 4.0], (A, C)), 0
                              ).astype(np.float32),
            comp_alive=(60.0 * rng.integers(0, 3, (A, C))).astype(np.float32)))
    return out


def test_pessimistic_pass_equals_reference(captured):
    """Algorithm 1 through ``pessimistic_shape`` (``ref.pessimistic_pass``
    on the CPU): on the tick's own problem of each captured state (the
    reference's persist demands and FIFO order), and on batches of three
    random tie-prone clusters, each member against the reference."""
    cfg = captured[0][0]
    cap = jnp.asarray(_cap(cfg.cluster.n_hosts, cfg.cluster.host_cpu, cfg.cluster.host_mem))

    @jax.jit
    def problem(tr, st, t):
        demand, _, _, _ = rstep._shaped_demands(cfg, None, tr, st, 60.0)
        return demand, rstep._shape_problem(cfg, tr, st, demand, t, cap)

    policy = jax.jit(pessimistic_shape_raw)
    for _, tr, st in captured:
        t = st.t + jnp.float32(60.0)
        demand, prob = problem(tr, st, t)
        want = policy(prob)
        ptr, pst = _port(tr, st)
        got = pessimistic_shape(tstep._shape_problem(
            ptr, pst, torch.tensor(np.asarray(demand))[None],
            torch.tensor(np.asarray(t))[None], torch.tensor(np.asarray(cap))))
        _assert_same({f: getattr(got, f) for f in DECISIONS},
                     {f: getattr(want, f) for f in DECISIONS})
    kills = np.zeros(2, int)
    for seed in range(8):
        members = _random_problems(seed)
        got = pessimistic_shape(ShapeProblem(**{
            k: torch.as_tensor(np.stack([m[k] for m in members])) for k in members[0]}))
        for i, m in enumerate(members):
            want = policy(rshaper.ShapeProblem(**{k: jnp.asarray(v) for k, v in m.items()}))
            _assert_same({f: getattr(got, f)[i:i + 1] for f in DECISIONS},
                         {f: getattr(want, f) for f in DECISIONS})
            kills += [int(want.kill_app.sum()), int(want.kill_comp.sum())]
    assert (kills > 0).all(), kills


# ----------------------------------------------------------------------
# edge cases of the block-per-member kernels, plain versions first
# ----------------------------------------------------------------------

def _members_policy(members):
    """The port's pass over a batch of reference problems against the
    reference, member by member; returns the reference decisions."""
    policy = jax.jit(pessimistic_shape_raw)
    got = pessimistic_shape(ShapeProblem(**{
        k: torch.as_tensor(np.stack([m[k] for m in members])) for k in members[0]}))
    wants = []
    for i, m in enumerate(members):
        want = policy(rshaper.ShapeProblem(**{k: jnp.asarray(v) for k, v in m.items()}))
        _assert_same({f: getattr(got, f)[i:i + 1] for f in DECISIONS},
                     {f: getattr(want, f) for f in DECISIONS})
        wants.append(want)
    return wants


@pytest.mark.parametrize("resource", ["host_cpu", "host_mem"])
def test_pessimistic_pass_host_below_zero_removes_every_row(resource):
    """A host already short of cpu or memory fails every app's core test,
    whether or not the app has a component there (the reference tests
    ``free - core_dem < 0`` over all hosts)."""
    for seed in range(4):
        members = _random_problems(seed)
        for m in members[:2]:
            m[resource] = m[resource].copy()
            m[resource][seed % len(m[resource])] = -0.25
        wants = _members_policy(members)
        for m, want in zip(members[:2], wants):
            np.testing.assert_array_equal(np.asarray(want.kill_app), m["app_exists"])
        assert not np.asarray(wants[2].kill_app).all()


@pytest.mark.parametrize("A,C,H", [(7, 5, 3), (13, 3, 4), (32, 12, 2)])
def test_pessimistic_pass_odd_shapes_and_shared_core_hosts(A, C, H):
    """A * C off the kernel's 16-byte vectors, and (on two hosts) apps
    whose core components share a host, so that a row's core demand per
    host is a sum."""
    shared = 0
    for seed in range(6):
        members = _random_problems(seed, A=A, C=C, H=H)
        _members_policy(members)
        for m in members:
            core = m["comp_core"] & m["comp_exists"]
            for a in range(A):
                hosts = m["comp_host"][a][core[a]]
                shared += len(hosts) - len(set(hosts.tolist()))
    assert shared > 0 or H > 2


def _tied(seed, A=13, C=7, N=37, H=3):
    """A reference case where every running component uses 20 GB of
    memory against 4 GB allocated: every host with two of them is over
    its memory and every overage ties (the largest flat index decides)."""
    rtr, rst, usage, cap = _random_case(seed, A=A, C=C, N=N, H=H)
    run = np.asarray(rst.comp_running)
    usage = usage.copy()
    usage[..., 1] = np.where(run, 20.0, 0.0)
    fields = _fields(rst)
    fields["alloc"] = fields["alloc"].copy()
    fields["alloc"][..., 1] = np.where(run, 4.0, 0.0)
    rst = rstate.SimState(**{k: jnp.asarray(v) for k, v in fields.items()},
                          calib=None, tenancy=None, obs=None)
    return rtr, rst, usage, cap


def _edge_case(kind, seed):
    """chip_smoke.edge_member's member (an edge case of admission or
    re-placement) as a reference (DeviceTrace, SimState, usage, host_cap)."""
    m = edge_member(kind, seed)
    N, C = m["exists"].shape
    A = m["slot_gid"].shape[0]
    trace = dict(submit=m["submit"], runtime=np.full(N, 600.0, np.float32),
                 cpu_req=m["cpu_req"], mem_req=m["mem_req"], is_core=m["is_core"],
                 is_jumpy=np.zeros(N, bool), levels=np.zeros((N, C, 32, 2), np.float32),
                 exists=m["exists"], tenant=np.zeros(N, np.int32), gid=m["gid"])
    z = lambda *s, dt=np.float32: np.zeros(s, dt)  # noqa: E731
    st = dict(slot_gid=m["slot_gid"], work_done=m["work_done"],
              comp_running=m["comp_running"], comp_host=m["comp_host"], alloc=m["alloc"],
              alive_since=m["alive_since"], mon_buf=z(A * C, 24, 2),
              mon_count=z(A * C, dt=np.int32), arrived=np.ones(N, bool),
              queued=m["queued"], done=z(N, dt=bool), failed=m["failed"], finish_t=z(N),
              saved_work=m["saved_work"], has_saved=m["has_saved"], t=m["t"],
              failure_events=np.int32(0), oom_kills=np.int32(0),
              full_preemptions=np.int32(0), partial_preemptions=np.int32(0))
    rtr = rstate.DeviceTrace(**{k: jnp.asarray(v) for k, v in trace.items()})
    rst = rstate.SimState(**{k: jnp.asarray(v) for k, v in st.items()},
                          calib=None, tenancy=None, obs=None)
    return rtr, rst, m["usage"], m["host_cap"]


def _cohort(cases):
    """The scheduler kernels' argument tuples for a batch of same-shaped
    reference cases, stacked on the member axis (S = len(cases)), with the
    host capacity of the first."""
    ports = [_port(rtr, rst) for rtr, rst, _, _ in cases]
    cat = lambda get: torch.cat([get(tr, st) for tr, st in ports])  # noqa: E731
    st = lambda f: cat(lambda tr, st: getattr(st, f))  # noqa: E731
    tr = lambda f: cat(lambda tr, st: getattr(tr, f))  # noqa: E731
    cap = torch.as_tensor(cases[0][3])
    usage = torch.stack([torch.as_tensor(np.array(u)) for _, _, u, _ in cases])
    t = st("t") + 60.0
    oom = (st("slot_gid"), st("work_done"), st("comp_running"), st("comp_host"),
           st("alloc"), usage, st("failed"), st("queued"), st("oom_kills"),
           st("failure_events"), st("partial_preemptions"), tr("is_core"), cap)
    adm = (tr("submit"), tr("gid"), tr("cpu_req"), tr("mem_req"), tr("exists"),
           tr("is_core"), st("slot_gid"), st("work_done"), st("comp_running"),
           st("comp_host"), st("alloc"), st("alive_since"), st("queued"),
           st("has_saved"), st("saved_work"), t, cap, True)
    el = (tr("cpu_req"), tr("mem_req"), tr("exists"), tr("is_core"), st("slot_gid"),
          st("comp_running"), st("comp_host"), st("alloc"), st("alive_since"), t, cap)
    return oom, adm, el


def test_resolve_oom_cohort_with_tied_overages_equals_reference():
    """Three members at once (the plain version that the kernel is held
    to), each over its memory on several hosts with every overage tied,
    A * C = 91 and N = 37 off the 16-byte vectors: each member equals the
    reference's OOM handler on it alone."""
    fn = jax.jit(rstep._resolve_oom)
    kills = 0
    for seed in range(4):
        cases = [_tied(3 * seed + i) for i in range(3)]
        oom_args, _, _ = _cohort(cases)
        got = ops.resolve_oom(*oom_args)
        names = ("slot_gid", "work_done", "comp_running", "alloc", "usage", "failed",
                 "queued", "oom_kills", "failure_events", "partial_preemptions",
                 "monreset")
        cap = jnp.asarray(cases[0][3])              # one cluster shape for the batch
        for i, (rtr, rst, usage, _) in enumerate(cases):
            want_st, want_usage, want_reset = fn(rtr, rst, jnp.asarray(usage), cap)
            want = {**_fields(want_st), "usage": want_usage, "monreset": want_reset}
            _assert_same({n: g[i:i + 1] for n, g in zip(names, got)},
                         {n: want[n] for n in names})
            kills += int(want_st.oom_kills) + int(want_st.partial_preemptions)
    assert kills > 0


@pytest.mark.parametrize("seed", range(4))
def test_admission_and_replacement_edge_cases_equal_reference(seed):
    """The three edge members at once (the plain versions that the kernels
    are held to), each against the reference alone: several admissions
    with more empty slots than admissions, then a head whose core does not
    fit, which stops FIFO with apps still queued; an app admitted without
    its elastic component that does not fit; submit ties broken by gid
    (not by row); resume on and off with saved work; missing elastic
    components that fill the hosts part-way through the walk."""
    cases = [_edge_case(kind, seed) for kind in EDGE_KINDS]
    _, adm_args, el_args = _cohort(cases)
    cap = jnp.asarray(cases[0][3])
    adm_names = ("slot_gid", "work_done", "comp_running", "comp_host", "alloc",
                 "alive_since", "queued", "has_saved", "resets")
    el_names = ("comp_running", "comp_host", "alloc", "alive_since")
    place = jax.jit(rstep._place_missing_elastic)
    got_el = ops.place_missing_elastic(*el_args)
    for resume in (False, True):
        cfg = dataclasses.replace(quick_base_config(), work_lost_on_kill=not resume)
        admit = jax.jit(lambda tr, st, t, cap: rstep._admit_queued(cfg, tr, st, t, cap))
        got = ops.admit_queued(*adm_args[:-1], resume)
        for i, (rtr, rst, _, _) in enumerate(cases):
            t = rst.t + jnp.float32(60.0)
            want_st, want_resets = admit(rtr, rst, t, cap)
            want = {**_fields(want_st), "resets": want_resets}
            _assert_same({n: g[i:i + 1] for n, g in zip(adm_names, got)},
                         {n: want[n] for n in adm_names})
            if resume:
                want_el = _fields(place(rtr, rst, t, cap))
                _assert_same({n: g[i:i + 1] for n, g in zip(el_names, got_el)},
                             {n: want_el[n] for n in el_names})
        # what each member was built to show
        q0, q1 = adm_args[12], got[6]
        admitted = (q0 & ~q1).sum(1)
        assert admitted[0] >= 2 and (got[0][0] < 0).any() and q1[0].any()
        A, C = got[2].shape[1:]
        new_slots = got[8][0].view(A, C).any(1)
        apps = got[0][0][new_slots].long()
        assert (adm_args[4][0][apps] & ~got[2][0][new_slots]).any()   # an elastic left out
        gid = adm_args[1][1]
        assert admitted[1] == 2
        assert sorted(gid[q0[1] & ~q1[1]].tolist()) == gid[q0[1]].sort().values[:2].tolist()
        assert admitted[2] == 0
    g = adm_args[6][2].clamp_min(0).long()
    missing = ((adm_args[6][2] >= 0)[:, None] & adm_args[4][2][g] & ~adm_args[5][2][g]
               & ~el_args[5][2])
    placed = (got_el[0][2] & ~el_args[5][2]).sum()
    assert 0 < placed < missing.sum()


def _gate(adm_args, seed, T=4, p=0.5):
    """Seeded tenants of a cohort's apps and the control plane's gate over
    them: (tenant (S, N) int32, elig (S, T) bool, admitted (S, T) int32)."""
    rng = np.random.default_rng(seed)
    S, N = adm_args[0].shape
    return (torch.as_tensor(rng.integers(0, T, (S, N)).astype(np.int32)),
            torch.as_tensor(rng.random((S, T)) < p),
            torch.as_tensor(rng.integers(0, 5, (S, T)).astype(np.int32)))


def _gated_cases():
    """(cases, admission arguments with the gate) of seeded cohorts and of
    the edge members, a gate each: half the tenants eligible, every
    tenant gated, every tenant eligible."""
    cohorts = [[_random_case(3 * seed + i) for i in range(3)] for seed in range(4)]
    cohorts += [[_edge_case(kind, seed) for kind in EDGE_KINDS] for seed in range(2)]
    for k, cases in enumerate(cohorts):
        _, adm, _ = _cohort(cases)
        tenant, elig, admitted = _gate(adm, k)
        for gate in (elig, torch.zeros_like(elig), torch.ones_like(elig)):
            yield cases, adm + (tenant, gate, admitted)


def test_gated_admission_equals_reference():
    """The admission's plain version with the control plane's gate against
    the reference's ``_admit_queued`` with ``elig_app`` (the FIFO head
    among the eligible tenants' apps, ``repro/sim/step.py:614``), the
    admitted counts as its fused tick adds them (``:872-876``); every
    tenant eligible equals the ungated admission, every tenant gated
    admits nothing."""
    cfg = dataclasses.replace(quick_base_config(), work_lost_on_kill=False)
    admit = jax.jit(lambda tr, st, t, cap, e: rstep._admit_queued(cfg, tr, st, t, cap, e))
    names = ("slot_gid", "work_done", "comp_running", "comp_host", "alloc", "alive_since",
             "queued", "has_saved", "resets")
    seen = 0
    for cases, args in _gated_cases():
        got = ops.admit_queued(*args)
        tenant, elig, admitted = args[-3:]
        cap = jnp.asarray(cases[0][3])
        for i, (rtr, rst, _, _) in enumerate(cases):
            ten = tenant[i].numpy()
            rtr = dataclasses.replace(rtr, tenant=jnp.asarray(ten))
            want_st, want_resets = admit(rtr, rst, rst.t + jnp.float32(60.0), cap,
                                         jnp.asarray(elig[i].numpy()[ten]))
            want = {**_fields(want_st), "resets": want_resets}
            _assert_same({n: g[i:i + 1] for n, g in zip(names, got)},
                         {n: want[n] for n in names})
            placed = np.asarray(rst.queued) & ~want["queued"]
            np.testing.assert_array_equal(
                got[9][i].numpy(), admitted[i].numpy() + np.bincount(ten[placed], minlength=4))
            seen += int(placed.sum())
        if not elig.any():
            assert torch.equal(got[6], args[12])
        if elig.all():
            plain = ops.admit_queued(*args[:-3])
            for g, w in zip(got[:9], plain):
                assert torch.equal(g, w)
    assert seen > 0


def test_plain_versions_take_cpu_tensors_only():
    x = torch.zeros((1, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no pessimistic_pass implementation"):
        ops.pessimistic_pass(x, x, x, x, x, x, x)
    with pytest.raises(ValueError, match="no resolve_oom implementation"):
        ops.resolve_oom(x)


def test_block_kernels_refuse_a_member_beyond_shared_memory():
    """The block-per-member kernels (Algorithm 1's pass and the three
    scheduler loops) keep a member's state in one block's shared memory:
    the main path's widths fit, a wider member is refused before anything
    is launched or counted (meta tensors: no data, no device)."""
    assert shaper.smem_bytes(128, 12, 50) == 80288 < shaper.MAX_SMEM
    assert sched.oom_smem_bytes(128, 12, 500, 50) == 58976 < sched.MAX_SMEM
    assert sched.admit_smem_bytes(128, 12, 500, 50) == 73712 < sched.MAX_SMEM
    assert sched.elastic_smem_bytes(128, 12, 500, 50) == 80272 < sched.MAX_SMEM
    m = dict(device="meta")
    A, C, H = 1024, 12, 50
    with pytest.raises(ValueError, match="shared memory"):
        shaper.pessimistic_pass(
            torch.empty((1, A), dtype=torch.bool, **m),
            torch.empty((1, A, C, 2), **m), *(torch.empty((1, A, C), dtype=torch.bool, **m),) * 2,
            *(torch.empty((1, A, C), dtype=torch.int32, **m),) * 2, torch.empty((1, H, 2), **m))
    A, C, H = 1024, 32, 1024
    b, i = dict(dtype=torch.bool, **m), dict(dtype=torch.int32, **m)
    with pytest.raises(ValueError, match="shared memory"):
        sched.resolve_oom(
            torch.empty((1, A), **i), torch.empty((1, A), **m),
            torch.empty((1, A, C), **b), torch.empty((1, A, C), **i),
            *(torch.empty((1, A, C, 2), **m),) * 2, *(torch.empty((1, 500), **b),) * 2,
            *(torch.empty((1,), **i),) * 3, torch.empty((1, 500, C), **b),
            torch.empty((H, 2), **m))
    N = 500
    before = (sched.admit_queued.launches, sched.place_missing_elastic.launches)
    trace = (torch.empty((1, N, C), **m), torch.empty((1, N, C), **m),
             torch.empty((1, N, C), **b), torch.empty((1, N, C), **b))
    table = (torch.empty((1, A), **i), torch.empty((1, A, C), **b),
             torch.empty((1, A, C), **i), torch.empty((1, A, C, 2), **m),
             torch.empty((1, A, C), **m))
    with pytest.raises(ValueError, match="admit_queued takes a member's state in .* shared"):
        sched.admit_queued(torch.empty((1, N), **m), torch.empty((1, N), **i), *trace,
                           table[0], torch.empty((1, A), **m), *table[1:],
                           *(torch.empty((1, N), **b),) * 2, torch.empty((1, N), **m),
                           torch.empty((1,), **m), torch.empty((H, 2), **m), True)
    with pytest.raises(ValueError, match="place_missing_elastic takes a member's state in "):
        sched.place_missing_elastic(*trace, *table, torch.empty((1,), **m),
                                    torch.empty((H, 2), **m))
    assert (sched.admit_queued.launches, sched.place_missing_elastic.launches) == before


# ----------------------------------------------------------------------
# CUDA kernels against the plain versions (card only)
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    return torch.device("cuda")


def _both(fn_kernel, fn_plain, args):
    """Run the kernel on the card and the plain version on the CPU on the
    same inputs; return both results as CPU tensors."""
    got = fn_kernel(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in args))
    torch.cuda.synchronize()
    return [g.cpu() for g in got], fn_plain(*args)


@pytest.mark.gpu
def test_sched_kernels_equal_plain_versions(cuda, captured):
    """Every captured and random case alone, then cohorts of three: seeded
    tables with A * C = 91 and N = 37 off the 16-byte vectors, tables
    over memory with every overage tied, and the admission and
    re-placement edge members."""
    cohorts = [[_random_case(3 * seed + i, A=13, C=7, N=37, H=5) for i in range(3)]
               for seed in range(4)]
    cohorts += [[_tied(3 * seed + i) for i in range(3)] for seed in range(4)]
    cohorts += [[_edge_case(kind, seed) for kind in EDGE_KINDS] for seed in range(4)]
    for oom_args, adm_args, el_args in [_cohort([c]) for c in _cases(captured)] + [
            _cohort(c) for c in cohorts]:
        for kern, plain, args in ((sched.resolve_oom, ref.resolve_oom, oom_args),
                                  (sched.admit_queued, ref.admit_queued, adm_args),
                                  (sched.place_missing_elastic, ref.place_missing_elastic,
                                   el_args)):
            got, want = _both(kern, plain, args)
            for g, w in zip(got, want):
                torch.testing.assert_close(g, w, rtol=0, atol=0)


def _pass_table(seed, S=3, A=64, C=12, H=7, *, negative=False, core_p=0.3):
    """Seeded inputs of Algorithm 1's pass, demands and capacities from
    small sets; ``negative`` puts a host of member 0 below 0 in cpu and
    one of member 1 below 0 in memory."""
    rng = np.random.default_rng(seed)
    core = rng.random((S, A, C)) < core_p
    args = [rng.random((S, A)) < 0.8,
            rng.choice([0.25, 0.5, 1.0, 2.0], (S, A, C, 2)).astype(np.float32), core,
            ~core & (rng.random((S, A, C)) < 0.6),
            rng.integers(0, H, (S, A, C)).astype(np.int32),
            np.argsort(rng.random((S, A, C)), -1).astype(np.int32),
            rng.choice([8.0, 16.0], (S, H, 2)).astype(np.float32)]
    if negative:
        args[-1][0, 0, 0] = -0.5
        args[-1][1, H - 1, 1] = -0.25
    return tuple(torch.as_tensor(x) for x in args)


@pytest.mark.gpu
def test_pessimistic_pass_kernel_equals_plain_version(cuda, captured):
    """Seeded batches of three, then the edge cases: A * C off the 16-byte
    vectors, hosts below 0 before the pass, core components sharing one of
    two hosts."""
    tables = [_pass_table(seed) for seed in range(16)]
    for seed in range(4):
        tables += [_pass_table(seed, A=7, C=5, H=3), _pass_table(seed, A=13, C=3, H=4),
                   _pass_table(seed, negative=True), _pass_table(seed, A=32, H=2, core_p=0.6)]
    for args in tables:
        got, want = _both(shaper.pessimistic_pass, ref.pessimistic_pass, args)
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        if args[-1].min() < 0:
            assert torch.equal(want[0][:2], args[0][:2])   # every valid row removed


@pytest.mark.gpu
def test_gated_admission_kernel_equals_plain_version(cuda):
    """The admission kernel with the control plane's gate against its plain
    version: seeded cohorts and the edge members, half the tenants
    eligible, every tenant gated and every tenant eligible; with the gate
    off (null pointers) the kernel still equals the ungated plain version."""
    for _, args in _gated_cases():
        got, want = _both(sched.admit_queued, ref.admit_queued, args)
        assert len(got) == len(want) == 10
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
        got, want = _both(sched.admit_queued, ref.admit_queued, args[:-3])
        for g, w in zip(got, want):
            torch.testing.assert_close(g, w, rtol=0, atol=0)
