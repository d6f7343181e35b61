"""The observability plane in the port (``repro_torch.obs``: the device
engine's telemetry rings, ``ops.obs_tick`` and the host modules) against
the reference's (``repro.obs``) on the CPU.

Two reference programs are compiled, each the one-tick chunk that both
whole runs (the histories are chunk-invariant) and single ticks share:
the persist config of the reference's own ring tests
(``tests/test_obs.py``) and a calibrated, tenanted config of
``tests/test_torch_control.py``'s size.  Held: whole-run histories,
int channels exactly and float channels bit for bit (the usage and
demand sums in the order of XLA:CPU's compiled sum, ``ref.xla_table_sum``,
shown against the float64 order on crafted values); one fused tick from every
converted reference state of a run, and from crafted states where the
tick has OOM kills, preemptions, admissions and gate throttling, every
field of the next state; the reference's contracts (rings off change
nothing, chunk 1 == 32, cohort == solo, leap == uniform, capacity and
overflow errors); the host modules on seeded inputs; spans and metrics
of traced runs.  The port runs on one torch thread.
"""
import dataclasses
import json

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import control as rctl
from repro import obs as robs
from repro.control.device import credit_mean as r_credit_mean
from repro.core.shaper.safeguard import SafeguardConfig
from repro.core.uncertainty import CalibrationConfig
from repro.obs import rings as rrings
from repro.sim import ClusterConfig, SimConfig, WorkloadConfig
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro.sim.scenarios.registry import build_trace
from repro_torch import convert
from repro_torch import obs as tobs
from repro_torch.kernels import ops, ref
from repro_torch.obs import rings as trings
from repro_torch.sim import state as tstate
from repro_torch.sim import step as tstep
from test_torch_control import _assert_state, _fields
from test_torch_leap import GAP
from test_torch_step import _one_torch_thread  # noqa: F401

WL = WorkloadConfig(n_apps=16, max_components=4, max_runtime=900.0, mean_burst_gap=4.0,
                    mean_long_gap=60.0, seed=3)
OFF = SimConfig(cluster=ClusterConfig(n_hosts=2, max_running_apps=8), workload=WL,
                max_ticks=2000, policy="pessimistic", forecaster="persist")
ON = dataclasses.replace(OFF, obs=robs.ObsConfig(enabled=True))
# the control test's size, with k1 = k2 = 0 so that preemptions happen
TEN = SimConfig(cluster=ClusterConfig(n_hosts=3, max_running_apps=16),
                workload=WorkloadConfig(n_apps=24, max_components=6, max_runtime=1200.0,
                                        mean_burst_gap=4.0, mean_long_gap=60.0, seed=7,
                                        n_tenants=4),
                max_ticks=3000, policy="pessimistic", forecaster="persist",
                safeguard=SafeguardConfig(k1=0.0, k2=0.0),
                calibration=CalibrationConfig(enabled=True, adaptive=True),
                control=rctl.TenancyConfig(enabled=True), obs=robs.ObsConfig(enabled=True))
NAMES = [n for n, _ in rrings.RING_FIELDS]


def _columns(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr) if f.name != "cfg"}


def _port(cfg, family="google"):
    wl = build_trace(cfg.workload)
    return (convert.sim_config_from_dict(dataclasses.asdict(cfg), workload=family),
            convert.trace_from_arrays(**_columns(wl)), wl)


def _same(got: dict, want: dict, what: str = "") -> None:
    """Two histories equal: the same fields, dtypes and bits."""
    assert list(got) == list(want) == NAMES, (what, list(got))
    for k in want:
        g, w = np.asarray(got[k]), np.asarray(want[k])
        assert g.dtype == w.dtype and g.shape == w.shape, (what, k, g.dtype, w.dtype, g.shape,
                                                           w.shape)
        np.testing.assert_array_equal(g.view(np.int32), w.view(np.int32),
                                      err_msg=f"{what}: {k}")


class _Ref:
    """A config's reference: its one-tick program, its whole run and the
    converted inputs of the port."""

    def __init__(self, cfg):
        self.cfg = cfg
        self.pcfg, self.ptr, self.wl = _port(cfg)
        self.tr = rstate.DeviceTrace.from_trace(self.wl)
        self.fn = rstep._chunk_fn(cfg, 1, rstep._shapes_key(self.wl, cfg), False, None)
        self.res = rstep.run_sim_scan(cfg, self.wl, chunk=1)


@pytest.fixture(scope="module")
def persist():
    return _Ref(ON)


@pytest.fixture(scope="module")
def tenanted():
    return _Ref(TEN)


# ----------------------------------------------------------------------
# the rings: absence, identity, invariance
# ----------------------------------------------------------------------

def test_rings_off_are_absent_and_on_change_nothing(persist):
    off = dataclasses.replace(persist.pcfg, obs=tobs.ObsConfig())
    assert tstate.init_state(off, 16, 4, 1, "cpu").obs is None
    r_off = tstep.run_sim_scan(off, persist.ptr, device="cpu")
    assert r_off.obs is None and "obs" not in r_off.summary()
    r_on = tstep.run_sim_scan(persist.pcfg, persist.ptr, device="cpu")
    assert r_on.obs is not None and "obs" not in r_on.summary()
    assert r_on.summary() == r_off.summary() and r_on.turnaround == r_off.turnaround
    assert r_on.util_cpu == r_off.util_cpu


@pytest.mark.parametrize("which", ["persist", "tenanted"])
def test_histories_equal_reference(which, request):
    """Whole runs against the reference's histories, every channel bit for
    bit; the event channels sum to the run's counters.  Persist shaping
    never demands less than the tick's usage, so these runs have no OOM
    kill (and no failure): the crafted ticks below hold those channels."""
    r = request.getfixturevalue(which)
    got = tstep.run_sim_scan(r.pcfg, r.ptr, device="cpu")
    _same(got.obs, r.res.obs, which)
    s = got.summary()
    h = got.obs
    assert int(h["oom"].sum()) == s["oom_kills"]
    assert int(h["preempt"].sum()) == s["full_preemptions"] + s["partial_preemptions"]
    assert int(h["admitted"].sum()) >= s["completed"] > 0
    zero = {k for k in NAMES if not np.any(h[k] != 0)}
    if which == "tenanted":
        assert zero == {"oom", "fail"}, zero
        assert int(h["cov_resolved"].sum()) == got.calibration["resolved"]
        assert int(h["admitted"].sum()) == sum(got.tenancy["admitted"])
        assert int(h["throttled"].sum()) == sum(got.tenancy["throttled"]) > 0
    else:
        assert {"oom", "fail", "throttled", "credit", "cov_resolved", "cov_errors"} <= zero


def test_chunk_invariance_and_cohort(persist, tenanted):
    """Histories at chunk 1 equal those at chunk 32, and a 3-seed cohort's
    each member's solo run."""
    for r in (persist, tenanted):
        one, full = (tstep.run_sim_scan(r.pcfg, r.ptr, chunk=c, device="cpu").obs
                     for c in (1, 32))
        _same(one, full, "chunk")
    cohort = tstep.run_cohort_scan(persist.pcfg, [0, 1, 2], device="cpu")
    for seed, res in zip([0, 1, 2], cohort):
        solo = tstep.run_sim_scan(dataclasses.replace(
            persist.pcfg, workload=dataclasses.replace(persist.pcfg.workload, seed=seed)),
            device="cpu")
        _same(res.obs, solo.obs, f"cohort seed {seed}")
    assert len({len(r.obs["queue"]) for r in cohort}) > 1


@pytest.mark.parametrize("max_ticks", [300, 10])
def test_leap_histories_equal_uniform(max_ticks):
    """The gap-dominated cell with leap steps: the same histories as
    uniform ticks, over its first 300 ticks (two flash events and the
    idle hours between) and with ``max_ticks`` cutting a skip (the tail
    column stands for the skipped ticks)."""
    cfg = dataclasses.replace(GAP, max_ticks=max_ticks, obs=robs.ObsConfig(enabled=True))
    pcfg, ptr, _ = _port(cfg, "flashcrowd")
    uni = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    leap = tstep.run_sim_scan(dataclasses.replace(pcfg, leap=True), ptr, device="cpu")
    _same(leap.obs, uni.obs, "leap")
    assert len(leap.obs["queue"]) == len(uni.util_cpu) == max_ticks
    assert leap.timings["steps"] < max_ticks or max_ticks == 10


def test_ring_capacity_and_overflow(persist):
    small = dataclasses.replace(persist.pcfg, obs=tobs.ObsConfig(enabled=True, ring=8))
    with pytest.raises(ValueError, match="ring capacity"):
        tstep.run_sim_scan(small, persist.ptr, chunk=32, device="cpu")
    obs = trings.obs_init(tobs.ObsConfig(enabled=True, ring=4), 1)
    on = torch.ones(1, dtype=torch.bool)
    for _ in range(5):                      # 5 writes into 4 columns, no drain
        obs = trings.obs_record(obs, on, {name: 1 for name in NAMES})
    with pytest.raises(RuntimeError, match="ring overflow"):
        trings.RingDrain().drain(obs)
    obs = trings.obs_init(tobs.ObsConfig(enabled=True, ring=8), 1)
    vals = {name: 7 for name in NAMES}
    obs = trings.obs_record(obs, on, vals)
    obs = trings.obs_record(obs, ~on, vals)    # an inactive tick records nothing
    drain = trings.RingDrain()
    drain.drain(obs)
    h = drain.history(0)
    assert h["queue"].tolist() == [7] and h["used_cpu"].dtype == np.float32
    assert trings.RingDrain().history(0)["queue"].shape == (0,)


# ----------------------------------------------------------------------
# one tick
# ----------------------------------------------------------------------

def _crafted(snap, rng):
    """A state where every running component sits on host 0, its monitor
    ring holds low samples and every score ring a miss of -3 sigma: the
    calibrated scale turns negative, the shaped demand falls below the
    tick's usage, and the OOM handler fires (with the trace's memory
    requests quadrupled)."""
    c = jax.tree.map(np.copy, snap)
    run = (c.slot_gid >= 0)[:, None] & c.comp_running
    c.comp_host[run] = 0
    rows = run.reshape(-1)
    c.mon_count[rows] = TEN.window
    c.mon_buf[rows] = rng.uniform(0, 0.5, c.mon_buf[rows].shape).astype(np.float32)
    cal = c.calib
    cal.ring[:] = -3.0
    cal.ring_count[:] = cal.ring.shape[-1]
    cal.pool[:] = -3.0
    cal.pool_count[...] = cal.pool.shape[-1]
    cal.group_ring[:] = -3.0
    cal.group_count[:] = cal.group_ring.shape[-1]
    return c


def test_fused_tick_equals_reference(tenanted):
    """From the reference's state at every tick of the tenanted run, one
    port tick leaves the reference's next state, its rings included, every
    field bit for bit; and again from a crafted state at every third
    tick, where the tick kills, preempts and admits."""
    r = tenanted
    ptr = convert.device_trace_from_arrays(device="cpu", **_fields(r.tr))
    spiked = dataclasses.replace(r.tr, mem_req=r.tr.mem_req * 4)
    ptr_spiked = convert.device_trace_from_arrays(device="cpu", **_fields(spiked))
    cap = tstep.host_capacity(r.pcfg, "cpu")
    st = rstate.init_state(r.cfg, r.wl.n_apps, r.wl.max_components)
    rng = np.random.default_rng(0)
    seen = np.zeros(len(NAMES), np.int64)
    for k in range(60):
        snap = jax.tree.map(np.array, st)
        if bool(snap.done.all()):
            break
        cases = [(r.tr, ptr, snap)]
        if k % 3 == 0 and (snap.slot_gid >= 0).any():
            cases.append((spiked, ptr_spiked, _crafted(snap, rng)))
        for tr, pt, before in cases:
            want, _ = r.fn(tr, jax.tree.map(jnp.asarray, before))
            got, _ = tstep.fused_tick(r.pcfg, None, pt,
                                      convert.sim_state_from_arrays(device="cpu",
                                                                    **_fields(before)), cap)
            _assert_state(got, _fields(want), f"tick {k}")
            seen += np.abs(np.concatenate([np.asarray(want.obs.f32)[:, k],
                                           np.asarray(want.obs.i32)[:, k]])) > 0
        st, _ = r.fn(r.tr, jax.tree.map(jnp.asarray, snap))
    ticked = dict(zip(rrings.F32_NAMES + rrings.I32_NAMES, seen))
    assert all(ticked.values()), ticked


def _seeded_tick(seed, S=3, A=48, C=12, N=40, T=4, R=8):
    """Seeded inputs of ``ref.obs_tick``: three members, one inactive, a
    cursor that wraps, a lead ring; usage and demand of mixed magnitudes,
    where the float64 and XLA's float32 orders of the sums differ."""
    g = np.random.default_rng(seed)

    def mixed(shape):
        return (g.uniform(0, 1, shape) * 10.0 ** g.integers(-3, 3, shape)).astype(np.float32)

    def ints(lo, hi, shape):
        return torch.from_numpy(g.integers(lo, hi, shape).astype(np.int32))

    at0 = ints(0, 50, (S, T))
    args = dict(
        cursor=torch.tensor([5, 13, 0], dtype=torch.int32)[:S],
        f32=torch.from_numpy(g.normal(size=(S, 5, R)).astype(np.float32)),
        i32=ints(-9, 9, (S, 8, R)), lead_ring=ints(0, 5, (S, R)),
        active=torch.tensor([True, True, False])[:S],
        usage=torch.from_numpy(mixed((S, A, C, 2))), demand=torch.from_numpy(mixed((S, A, C, 2))),
        queued=torch.from_numpy(g.random((S, N)) < 0.3),
        q_admit=torch.from_numpy(g.random((S, N)) < 0.5),
        counters=tuple(ints(0, 100, (S,)) for _ in range(4)),
        counters0=tuple(ints(0, 50, (S,)) for _ in range(4)),
        tenancy=(torch.from_numpy(g.uniform(0.05, 1, (S, T)).astype(np.float32)),
                 ints(50, 90, (S, T)), at0 + ints(0, 2, (S, T))),
        tenancy0=(ints(0, 50, (S, T)), at0),
        calib=(ints(50, 99, (S,)), ints(20, 40, (S,))),
        calib0=(ints(0, 50, (S,)), ints(0, 20, (S,))),
        lead=ints(0, 7, (S,)))
    return args


def test_ref_obs_tick_equals_obs_record():
    """``ref.obs_tick`` against ``rings.obs_record`` fed the values the
    reference computes (the usage and demand sums by a jitted XLA:CPU
    reduction, the credit by ``repro.control.device.credit_mean``), and
    the port's ``obs_record`` against the reference's.  The sums are
    ``ref.xla_table_sum``'s order, not the float64 order: on these values
    the two differ."""
    a = _seeded_tick(3)
    S, A, C = a["usage"].shape[:3]
    got = ref.obs_tick(**a)
    xsum = jax.jit(lambda u: u.sum((0, 1)))
    vals = {n: [] for n in NAMES}
    differs = 0
    for s in range(S):
        used = np.asarray(xsum(a["usage"][s].numpy()))
        dem = np.asarray(xsum(a["demand"][s].numpy()))
        np.testing.assert_array_equal(used, ref.xla_table_sum(a["usage"][s].numpy()))
        differs += int((a["usage"][s].double().sum((0, 1)).float().numpy() != used).any())
        cr, th, at = (x[s].numpy() for x in a["tenancy"])
        th0, at0 = (x[s].numpy() for x in a["tenancy0"])
        cnt = [int(x[s]) for x in a["counters"]]
        cnt0 = [int(x[s]) for x in a["counters0"]]
        q, qa = a["queued"][s].numpy(), a["q_admit"][s].numpy()
        for n, v in dict(
                used_cpu=used[0], used_mem=used[1], gap_cpu=dem[0] - used[0],
                gap_mem=dem[1] - used[1],
                credit=np.asarray(r_credit_mean(jnp.asarray(cr), jnp.asarray(at > at0))),
                queue=q.sum(), oom=cnt[0] - cnt0[0], fail=cnt[1] - cnt0[1],
                preempt=cnt[2] + cnt[3] - cnt0[2] - cnt0[3], admitted=(qa & ~q).sum(),
                throttled=(th - th0).sum(), cov_resolved=int(a["calib"][0][s] - a["calib0"][0][s]),
                cov_errors=int(a["calib"][1][s] - a["calib0"][1][s])).items():
            vals[n].append(v)
    assert differs > 0
    obs = trings.ObsState(a["cursor"], a["f32"], a["i32"], a["lead_ring"])
    rec = trings.obs_record(obs, a["active"], {
        n: torch.from_numpy(np.asarray(v, np.float32 if n in rrings.F32_NAMES else np.int32))
        for n, v in vals.items()}, lead=a["lead"])
    for g, w in zip(got, (rec.cursor, rec.f32, rec.i32, rec.lead)):
        np.testing.assert_array_equal(g.numpy().view(np.int32), w.numpy().view(np.int32))
    for s in range(S):    # the reference's obs_record, member by member
        r = rrings.obs_record(
            rrings.ObsState(jnp.int32(int(a["cursor"][s])), jnp.asarray(a["f32"][s].numpy()),
                            jnp.asarray(a["i32"][s].numpy()),
                            jnp.asarray(a["lead_ring"][s].numpy())),
            jnp.asarray(bool(a["active"][s])), {n: vals[n][s] for n in NAMES},
            lead=jnp.int32(int(a["lead"][s])))
        for g, w in zip(got, (r.cursor, r.f32, r.i32, r.lead)):
            np.testing.assert_array_equal(g[s].numpy().view(np.int32),
                                          np.asarray(w).view(np.int32))
    assert (got[0] == a["cursor"] + a["active"].int()).all()


def test_obs_tick_without_features():
    """Baseline (no demand), no tenancy, no calibration and no lead ring:
    those channels are 0 and the rest as with them."""
    a = _seeded_tick(4)
    full = ref.obs_tick(**a)
    bare = ref.obs_tick(**dict(a, lead_ring=None, demand=None, tenancy=None, tenancy0=None,
                               calib=None, calib0=None, lead=None))
    assert bare[3] is None
    col = (a["cursor"] % 8).long()
    for s in range(2):
        f, i = bare[1][s, :, col[s]], bare[2][s, :, col[s]]
        assert f[2] == f[3] == f[4] == 0 and (i[5:] == 0).all()
        assert (f[:2] == full[1][s, :2, col[s]]).all() and (i[:5] == full[2][s, :5, col[s]]).all()
    assert (bare[1][2] == a["f32"][2]).all() and bare[0][2] == a["cursor"][2]


def test_convert_obs_state(persist):
    """``sim_state_from_arrays`` takes the reference's rings; a leap
    state's lead ring too."""
    st = rstate.init_state(dataclasses.replace(ON, leap=True), 16, 4)
    pst = convert.sim_state_from_arrays(device="cpu", **_fields(st))
    assert pst.obs.lead.shape == (1, 128) and pst.obs.cursor.shape == (1,)
    assert convert.sim_config_from_dict(dataclasses.asdict(
        dataclasses.replace(ON, obs=robs.ObsConfig(enabled=True, ring=64)))).obs == \
        tobs.ObsConfig(enabled=True, ring=64)


@pytest.mark.gpu
def test_obs_tick_kernel_equals_plain():
    """The CUDA kernel against its plain version on seeded states, with
    every feature and with none."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    from repro_torch.kernels import obs as kobs
    for seed in range(3):
        a = _seeded_tick(seed)
        for kw in ({}, dict(lead_ring=None, demand=None, tenancy=None, tenancy0=None,
                            calib=None, calib0=None, lead=None)):
            args = dict(a, **kw)
            cuda = jax.tree.map(lambda x: x.cuda() if isinstance(x, torch.Tensor) else x,
                                args, is_leaf=lambda x: isinstance(x, torch.Tensor))
            n = kobs.obs_tick.launches
            got = ops.obs_tick(**cuda)
            assert kobs.obs_tick.launches == n + 1
            for g, w in zip(got, ref.obs_tick(**args)):
                if w is None:
                    assert g is None
                else:
                    np.testing.assert_array_equal(g.cpu().numpy().view(np.int32),
                                                  w.numpy().view(np.int32))


# ----------------------------------------------------------------------
# the host modules, on seeded inputs
# ----------------------------------------------------------------------

def _history(seed, t=400):
    g = np.random.default_rng(seed)
    h = {}
    for ch in NAMES:
        if ch in ("oom", "fail", "preempt", "throttled"):
            x = np.zeros(t)
            x[g.integers(0, t - 20):][:10] = g.integers(1, 4)
        elif ch == "cov_resolved":
            x = np.full(t, 8.0)
        elif ch == "cov_errors":
            x = g.binomial(8, 0.1 if seed % 2 else 0.4, t).astype(np.float64)
        elif ch in ("admitted", "queue"):
            x = g.integers(0, 7, t).astype(np.float64)
        else:
            x = 20.0 + g.normal(0.0, 1.0, t)
            x[t // 2:] += 6.0 * (seed % 3)
        h[ch] = x
    return h


@pytest.mark.parametrize("seed", [0, 1, 2, 3])
def test_detectors_rules_and_reports_equal_reference(seed, tenanted):
    for h in (_history(seed), {k: np.asarray(v) for k, v in tenanted.res.obs.items()}):
        for name in ("ewma_detect", "cusum_detect", "burst_detect"):
            for ch in ("used_cpu", "oom", "queue"):
                assert getattr(tobs, name)(h[ch]).to_dict() == \
                    getattr(robs, name)(h[ch]).to_dict(), (name, ch)
        assert tobs.coverage_drift_detect(h["cov_resolved"], h["cov_errors"]).to_dict() == \
            robs.coverage_drift_detect(h["cov_resolved"], h["cov_errors"]).to_dict()
        bad, exp = h["fail"] + h["oom"], h["admitted"] + 1.0
        assert tobs.burn_rate_detect(bad, exp).to_dict() == \
            robs.burn_rate_detect(bad, exp).to_dict()
        treg, rreg = tobs.MetricsRegistry(), robs.MetricsRegistry()
        tenancy = {"tenants": [{"id": t, "slo": s, "failed": f, "completed": 10}
                               for t, (s, f) in enumerate([("gold", 3), ("bronze", 0)])]}
        assert tobs.evaluate_rules(h, registry=treg, tenancy=tenancy) == \
            robs.evaluate_rules(h, registry=rreg, tenancy=tenancy)
        assert treg.snapshot() == rreg.snapshot()
        assert [dataclasses.astuple(r) for r in tobs.DEFAULT_RULES] == \
            [dataclasses.astuple(r) for r in robs.DEFAULT_RULES]
        assert tobs.obs_summary(h) == robs.obs_summary(h)
        assert json.dumps(tobs.compact_history(h, 64)) == \
            json.dumps(robs.compact_history(h, 64))
    rows = {"rows_ready": 90, "rows_batch": 400, "rows_bucketed": 160,
            "ticks_forecasting": 3, "ticks": 5}
    assert tobs.masked_row_overhead(rows) == robs.masked_row_overhead(rows)
    assert tobs.bucketed_row_overhead(rows) == robs.bucketed_row_overhead(rows)


def _registry_ops(reg):
    reg.set_help("sim.ticks", "ticks \"run\"\nper cell")
    reg.counter("sim.ticks").inc(3)
    reg.counter("forecast.bucket_chunks", bucket="16").inc()
    reg.gauge("scan.entries", engine='a"b').set(2.5)
    h = reg.histogram("scan.compile_s", cell="x\\y")
    for v in (0.5, 1.25, float("inf"), 3.0):
        h.observe(v)
    return reg


def test_registry_and_exports_equal_reference(tmp_path):
    t, r = _registry_ops(tobs.MetricsRegistry()), _registry_ops(robs.MetricsRegistry())
    assert t.snapshot() == r.snapshot()
    for reg, name in ((t, "t"), (r, "r")):
        reg.write_jsonl(str(tmp_path / f"{name}.jsonl"), run="a")
        reg.write_textfile(str(tmp_path / f"{name}.prom"))
    lines = [json.loads((tmp_path / f"{n}.jsonl").read_text()) for n in "tr"]
    for rec in lines:
        rec.pop("ts")
    assert lines[0] == lines[1]
    assert (tmp_path / "t.prom").read_text() == (tmp_path / "r.prom").read_text()


def test_hashes_manifest_and_dashboard_equal_reference(tmp_path, tenanted):
    base = dataclasses.asdict(TEN)
    assert tobs.config_hash(base) == robs.config_hash(base)
    assert tobs.config_hash(tobs.ObsConfig(True, 64)) == robs.config_hash(robs.ObsConfig(True, 64))
    h = tobs.config_hash(base)
    over = {"policy": "baseline"}
    assert tobs.cell_hash(h, over, 3) == robs.cell_hash(h, over, 3)
    cells = [{"name": f"c{s}", "overrides": {"forecaster": "persist", "k2": (1.0, 2.0)}, "seed": s}
             for s in range(3)]
    kw = dict(base_config=base, cells=cells, engine="scan", artifacts={"results": "r.json"},
              wall_s=1.5, metrics=_registry_ops(tobs.MetricsRegistry()).snapshot())
    tm, rm = tobs.build_manifest(**kw), robs.build_manifest(**kw)
    assert "torch" in tm["environment"] and "jax" not in tm["environment"]
    assert {k: v for k, v in tm.items() if k != "environment"} == \
        {k: v for k, v in rm.items() if k != "environment"}
    path = str(tmp_path / "m.json")
    tobs.write_manifest(path, tm)
    assert tobs.load_manifest(path) == robs.load_manifest(path) == json.loads(open(path).read())
    tampered = json.loads(open(path).read())
    tampered["cells"][1]["seed"] = 9
    bad = str(tmp_path / "bad.json")
    tobs.write_manifest(bad, tampered)
    for mod in (tobs, robs):
        with pytest.raises(ValueError, match="cell hash mismatch"):
            mod.load_manifest(bad)
    hist = {k: np.asarray(v) for k, v in tenanted.res.obs.items()}
    alerts = robs.evaluate_rules(_history(2), registry=None)
    results = {"cells": [{"name": "c0", "summary": {"completed": 24},
                          "obs": {"history": robs.compact_history(hist), "alerts": alerts}}]}
    with robs.tracing() as tr:
        with robs.span("chunk", cat="execute", args={"ticks": 1}):
            pass
    html = [open(mod.render_dashboard(rm, str(tmp_path / f"{i}.html"), results=results,
                                      trace=tr.to_json(), bench_docs={})).read()
            for i, mod in enumerate((tobs, robs))]
    assert html[0] == html[1] and "<svg" in html[0]


def test_tracer_and_timing():
    with tobs.tracing() as t:
        with tobs.span("chunk", cat="execute", args={"ticks": 2}):
            t.instant("mark")
        with pytest.raises(KeyError):
            with tobs.span("ring_drain", cat="drain"):
                raise KeyError("x")
    doc = t.to_json()
    assert tobs.validate_trace(doc) == [] == robs.validate_trace(doc)
    assert [(e["name"], e.get("args")) for e in doc["traceEvents"]] == [
        ("chunk", {"ticks": 2}), ("mark", None), ("ring_drain", {"error": "KeyError"})]
    assert tobs.span("x") is tobs.span("y")             # the shared no-op, untraced
    assert tobs.best_of(lambda: None, 3, metric="t.best") >= 0.0
    assert tobs.time_us(torch.ones, 4, iters=2, metric="t.us") >= 0.0
    snap = tobs.REGISTRY.snapshot()
    assert snap["t.best"]["count"] == 3 and snap["t.us"]["count"] == 1


def _spans(doc):
    return [(e["name"], e["cat"], e.get("args")) for e in doc["traceEvents"]]


def test_traced_run_and_registry_equal_reference(persist):
    """A traced port run gives the reference's spans (names, categories,
    args, in order), the reference's run being already compiled; the
    first eager chunk of a new program key is observed in
    ``scan.compile_s``."""
    with robs.tracing() as rt:
        rstep.run_sim_scan(ON, persist.wl, chunk=1)
    with tobs.tracing() as tt:
        tstep.run_sim_scan(persist.pcfg, persist.ptr, chunk=1, device="cpu")
    assert _spans(tt.to_json()) == _spans(rt.to_json())
    assert {n for n, _, _ in _spans(tt.to_json())} == {"chunk", "ring_drain"}
    tobs.REGISTRY.clear()
    cfg = dataclasses.replace(persist.pcfg, grace=9)      # a key not run before
    tstep.run_sim_scan(cfg, persist.ptr, chunk=16, device="cpu")
    tstep.run_sim_scan(cfg, persist.ptr, chunk=16, device="cpu")
    assert tobs.REGISTRY.snapshot()["scan.compile_s"]["count"] == 1
