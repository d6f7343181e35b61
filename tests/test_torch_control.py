"""The multi-tenant control plane in the port (``repro_torch.control``, the
tenancy of both engines, ``ops.control_tick``, the gated
``ops.admit_queued`` and the calibration's per-tenant tier) against the
reference's (``repro.control``) on the CPU.

Sizes are the reference's own test's (``tests/test_control.py``): 24
apps of 6 components, 4 tenants, 3 hosts, 16 running apps, persist
forecasts, adaptive calibration, control on.  Held bit for bit: the
formula layer against the reference's numpy path, the host engine's
accounting (a numpy copy) and whole host runs, one fused tick from a
converted reference state (every field, the tenancy and the group tier
included), and crafted ticks where each of the three multiply-adds that
XLA contracts inside the reference's compiled tick decides the outcome:
the credit step, the gate's headroom and the credit-modulated quantile.
Whole device runs are held as the other device-engine tests hold them
(counters exact, metric means to rtol 1e-6), the tenancy and calibration
blocks equal as the summary rounds them.  The reference's compiled
programs are shared through module fixtures, and the port runs on one
torch thread.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro import control as rctl
from repro.core.uncertainty import CalibrationConfig
from repro.sim import ClusterConfig, SimConfig, WorkloadConfig
from repro.sim import engine as reng
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro.sim.scenarios.registry import build_trace
from repro_torch import control as tctl
from repro_torch import convert
from repro_torch.kernels import control as kcontrol
from repro_torch.kernels import ops, ref
from repro_torch.sim import engine as tengine
from repro_torch.sim import step as tstep
from test_torch_step import _one_torch_thread  # noqa: F401

WL = WorkloadConfig(n_apps=24, max_components=6, max_runtime=1200.0, mean_burst_gap=4.0,
                    mean_long_gap=60.0, seed=7, n_tenants=4)
CL = ClusterConfig(n_hosts=3, max_running_apps=16)
BASE = SimConfig(cluster=CL, workload=WL, max_ticks=3000, policy="pessimistic",
                 forecaster="persist",
                 calibration=CalibrationConfig(enabled=True, adaptive=True),
                 control=rctl.TenancyConfig(enabled=True))
COUNTERS = ("completed", "n_apps", "failure_events", "oom_kills", "full_preemptions",
            "partial_preemptions", "failed_frac", "sim_hours")
f32 = np.float32


def _bits(x) -> np.ndarray:
    return np.asarray(x, np.float32).view(np.int32)


def _columns(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr) if f.name != "cfg"}


def _port(cfg):
    wl = build_trace(cfg.workload)
    return (convert.sim_config_from_dict(dataclasses.asdict(cfg)),
            convert.trace_from_arrays(**_columns(wl)), wl)


def _fields(obj) -> dict:
    """A reference state's fields as numpy copies, nested states as dicts."""
    out = {}
    for f in dataclasses.fields(obj):
        v = getattr(obj, f.name)
        if dataclasses.is_dataclass(v):
            out[f.name] = _fields(v)
        elif v is not None:
            out[f.name] = np.array(v)
    return out


def _flat(d: dict, prefix="") -> dict:
    out = {}
    for k, v in d.items():
        out.update(_flat(v, f"{prefix}{k}.") if isinstance(v, dict) else {prefix + k: v})
    return out


def _assert_state(pst, want: dict, what: str):
    """A port state (one member) against a reference state's fields, every
    field bit for bit."""
    got = {k: v.numpy()[0] for k, v in tstep._tensors(pst).items()}
    want = _flat(want)
    assert set(got) == set(want), (what, set(got) ^ set(want))
    for name, w in want.items():
        if w.dtype.kind == "f":
            np.testing.assert_array_equal(_bits(got[name]), _bits(w), err_msg=f"{what}: {name}")
        else:
            np.testing.assert_array_equal(got[name], w, err_msg=f"{what}: {name}")


# ----------------------------------------------------------------------
# the formula layer, the host accounting and the summary
# ----------------------------------------------------------------------

def _formula_inputs(seed, T):
    rng = np.random.default_rng(seed)
    alloc = (rng.uniform(0, 40, (T, 2)) * (rng.random((T, 1)) < 0.8)).astype(np.float32)
    return dict(alloc=alloc, cap=np.asarray([96.0, 384.0], np.float32),
                weights=rng.choice([1.0, 0.5, 2.0, 3.0], T).astype(np.float32),
                active=rng.random(T) < 0.7,
                credit=rng.uniform(0.05, 1.0, T).astype(np.float32),
                good=rng.integers(0, 4, T), bad=rng.integers(0, 3, T))


@pytest.mark.parametrize("kind", ["numpy", "torch"])
@pytest.mark.parametrize("T", [4, 8])
def test_formula_layer_equals_reference(kind, T):
    """dominant_shares, jain_index, gate_mask, credit_step,
    credit_quantile and resolve_weights against the reference's numpy
    path, bit for bit, on numpy arrays and on torch tensors."""
    conv = (lambda a: a) if kind == "numpy" else torch.from_numpy
    back = np.asarray if kind == "numpy" else (lambda t: t.numpy())
    for seed in range(6):
        x = _formula_inputs(seed, T)
        share = rctl.dominant_shares(x["alloc"], x["cap"], x["weights"])
        got = back(tctl.dominant_shares(conv(x["alloc"]), conv(x["cap"]), conv(x["weights"])))
        np.testing.assert_array_equal(_bits(got), _bits(share))
        act = x["active"]
        for slack in (f32(0.1), f32(0.1) * x["credit"]):
            want = rctl.gate_mask(share, act, slack)
            got = back(tctl.gate_mask(conv(share), conv(act), conv(np.asarray(slack))))
            np.testing.assert_array_equal(got, want)
        for a in (None, act):
            want = rctl.jain_index(share, a)
            got = tctl.jain_index(conv(share), None if a is None else conv(a))
            assert _bits(back(got)) == _bits(want)
        cs = rctl.credit_step(x["credit"], x["good"], x["bad"], 0.1, 0.05)
        got = back(tctl.credit_step(conv(x["credit"]), conv(x["good"]), conv(x["bad"]),
                                    0.1, 0.05))
        np.testing.assert_array_equal(_bits(got), _bits(cs))
        qs = rctl.credit_quantile(cs, 0.9, 0.05, 0.5, 0.99)
        np.testing.assert_array_equal(
            _bits(back(tctl.credit_quantile(conv(cs), 0.9, 0.05, 0.5, 0.99))), _bits(qs))
    cfg = rctl.TenancyConfig(max_tenants=T, weights=(2.0, 0.5))
    np.testing.assert_array_equal(tctl.resolve_weights(tctl.TenancyConfig(
        **dataclasses.asdict(cfg))), rctl.resolve_weights(cfg))
    assert tctl.SLO_STRETCH == rctl.SLO_STRETCH and tctl.SLO_CLASSES == rctl.SLO_CLASSES
    assert tctl.SLO_BUDGET == rctl.config.SLO_BUDGET
    with pytest.raises(ValueError, match="positive"):
        tctl.resolve_weights(tctl.TenancyConfig(weights=(1.0, 0.0)))


def test_host_control_equals_reference():
    """HostControl against the reference's on seeded events: notes,
    credit-modulated quantiles, gates and the drained arrays, every tick
    bit for bit, with the credit and the gate each on and off."""
    for credit, gate in ((True, True), (True, False), (False, True)):
        rcfg = rctl.TenancyConfig(enabled=True, credit=credit, gate=gate, weights=(1.0, 2.0))
        want = rctl.HostControl(rcfg)
        got = tctl.HostControl(tctl.TenancyConfig(**dataclasses.asdict(rcfg)))
        rng = np.random.default_rng(3)
        T = rcfg.max_tenants
        for _ in range(40):
            done = rng.integers(0, 4, rng.integers(0, 4))
            fail = rng.integers(0, 4, rng.integers(0, 3))
            cov, mis = rng.integers(0, 5, T), rng.integers(0, 2, T)
            for hc in (want, got):
                hc.note_completed(done)
                hc.note_failed(fail)
                hc.note_calib(cov, mis)
            np.testing.assert_array_equal(_bits(got.q_groups(0.9, 0.5, 0.99)),
                                          _bits(want.q_groups(0.9, 0.5, 0.99)))
            alloc = rng.uniform(0, 30, (T, 2)).astype(np.float32) * (rng.random((T, 1)) < 0.6)
            queued = rng.integers(0, 3, T)
            cap = np.asarray([96.0, 384.0], np.float32)
            np.testing.assert_array_equal(got.gate(alloc, cap, queued),
                                          want.gate(alloc, cap, queued))
            for t in rng.integers(0, T, 2):
                want.note_admitted(int(t))
                got.note_admitted(int(t))
        for k, w in want.arrays().items():
            np.testing.assert_array_equal(got.arrays()[k], w, err_msg=k)
            assert got.arrays()[k].dtype == w.dtype


def test_tenancy_summary_equals_reference():
    wl = build_trace(dataclasses.replace(WL, n_tenants=3))
    rng = np.random.default_rng(5)
    T = 8
    arrays = dict(credit=rng.uniform(0, 1, T).astype(np.float32),
                  admitted=rng.integers(0, 9, T), throttled=rng.integers(0, 9, T),
                  completed=rng.integers(0, 9, T), failed=rng.integers(0, 3, T),
                  share_sum=rng.uniform(0, 5, T).astype(np.float32),
                  active_ticks=rng.integers(0, 30, T))
    arrays["active_ticks"][1] = 0
    turnaround = {int(g): float(rng.uniform(60, 4000)) for g in rng.choice(24, 15, False)}
    failed = {int(g) for g in rng.choice(24, 4, False)}
    cfg = rctl.TenancyConfig(enabled=True)
    want = rctl.tenancy_summary(cfg, wl, turnaround, failed, arrays)
    got = tctl.tenancy_summary(tctl.TenancyConfig(enabled=True), wl, turnaround, failed, arrays)
    assert got == want


# ----------------------------------------------------------------------
# the device engine, one tick
# ----------------------------------------------------------------------

@pytest.fixture(scope="module")
def tick1():
    """The reference's compiled one-tick program for BASE's config and
    shapes (any seed): ``(tr, st) -> (st, metrics)``, donating ``st``."""
    wl = build_trace(WL)
    return rstep._chunk_fn(BASE, 1, rstep._shapes_key(wl, BASE), False, None)


class _Run:
    """A reference run of BASE with ``seed``, stepped tick by tick, and
    the port's one tick from any of its states."""

    def __init__(self, tick1, seed=7):
        cfg = dataclasses.replace(BASE, workload=dataclasses.replace(WL, seed=seed))
        self.pcfg, _, self.wl = _port(cfg)
        self.tr = rstate.DeviceTrace.from_trace(self.wl)
        self.st = rstate.init_state(cfg, self.wl.n_apps, self.wl.max_components)
        self.fn = tick1
        self.ptr = convert.device_trace_from_arrays(device="cpu", **_fields(self.tr))
        self.cap = tstep.host_capacity(self.pcfg, "cpu")
        self.k = 0

    def advance(self, to: int):
        while self.k < to:
            self.st, _ = self.fn(self.tr, self.st)
            self.k += 1
        return _fields(self.st)

    def reference(self, before: dict) -> dict:
        """One reference tick from the state ``before`` (fields)."""
        st = jax.tree.map(jnp.asarray, _to_state(before))
        return _fields(self.fn(self.tr, st)[0])

    def port(self, before: dict, monkeypatch=None):
        """One port tick from ``before``; with ``monkeypatch``, also the
        arguments and results of its control_tick call."""
        seen = {}
        if monkeypatch is not None:
            plain = ops.control_tick

            def spy(*a, **kw):
                seen["args"], seen["out"] = a, plain(*a, **kw)
                return seen["out"]
            monkeypatch.setattr(ops, "control_tick", spy)
        st, _ = tstep.fused_tick(self.pcfg, None, self.ptr,
                                 convert.sim_state_from_arrays(device="cpu", **before), self.cap)
        if monkeypatch is not None:
            monkeypatch.setattr(ops, "control_tick", plain)
        return st, seen


def _to_state(d: dict):
    kw = dict(d)
    kw["calib"] = rstate.CalibState(**d["calib"])
    kw["tenancy"] = rctl.TenantState(**d["tenancy"])
    return rstate.SimState(**kw, obs=None)


def _with(before: dict, **tenancy) -> dict:
    out = dict(before)
    out["tenancy"] = {**before["tenancy"], **tenancy}
    return out


def test_fused_tick_equals_reference(tick1):
    """From the reference's state at ticks 4, 8, ..., 48 of a run, one
    tick in both packages leaves the same next state, every field bit for
    bit, the tenant counters and the calibration's group tier included."""
    run = _Run(tick1)
    seen = 0
    for k in range(4, 52, 4):
        before = run.advance(k)
        want = run.reference(before)
        got, _ = run.port(before)
        _assert_state(got, want, f"tick {k}")
        seen += int((want["tenancy"]["throttled"] != before["tenancy"]["throttled"]).any())
    assert seen > 0 and (want["calib"]["group_count"] > 0).any()


def test_tenant_ids_out_of_range_equal_reference(tick1):
    """A trace whose tenant column holds ids of T and more, and negative
    ones: the reference's compiled tick builds the calibration's groups
    from it itself (its gathers clamp an id of T or more to T - 1 where
    they read a tenant's quantile or its group ring's count and quantile,
    a row records the id as it is, and the group rings and counters drop
    it), and from each of its states one port tick leaves the same next
    state, every field bit for bit: the group rings, their counts,
    group_resolved and group_errors, the rows' groups and their scales
    and quantiles."""
    run = _Run(tick1, seed=8)
    T = BASE.control.max_tenants
    ten = np.array(run.tr.tenant)
    ten[1::4], ten[2::9], ten[3::10] = T, T + 3, -3
    run.tr = dataclasses.replace(run.tr, tenant=jnp.asarray(ten))
    run.ptr = convert.device_trace_from_arrays(device="cpu", **_fields(run.tr))
    for k in range(4, 64, 4):
        before = run.advance(k)
        want = run.reference(before)
        got, _ = run.port(before)
        _assert_state(got, want, f"tick {k}")
    group = want["calib"]["group"]
    assert (group >= T).any() and (group == -3).any() and (want["calib"]["group_count"] > 0).any()


def _events(args) -> tuple[np.ndarray, np.ndarray]:
    """(good, bad) per tenant of one member, from control_tick's arguments."""
    (done0, done, queued0, queued, conflict, d_res, d_err, tenant) = (
        args[6], args[7], args[8], args[9], args[10], args[11], args[12], args[13])
    T = args[0].shape[1]
    ten = tenant[0].numpy()
    comp = np.bincount(ten[(done & ~done0)[0].numpy()], minlength=T)
    fail = np.bincount(ten[(queued & ~queued0)[0].numpy()], minlength=T)
    assert conflict is None
    dr, de = d_res[0].numpy(), d_err[0].numpy()
    return comp + dr - de, fail + de


def _neighbours(x, n=4000):
    return (f32(x).view(np.int32) + np.arange(-n, n, dtype=np.int32)).view(np.float32)


def test_credit_step_contracts_as_the_reference(tick1, monkeypatch):
    """Inside the reference's compiled tick the credit step is
    ``fma(gamma, target - credit, credit)``: from a mid-run state whose
    tenant with events has a credit where that rounds otherwise than
    twice, the port's tick leaves the reference's state."""
    run = _Run(tick1, seed=8)
    gamma = f32(BASE.control.credit_gamma)
    for k in range(8, 60):
        before = run.advance(k)
        _, seen = run.port(before, monkeypatch)
        good, bad = _events(seen["args"])
        for t in np.nonzero(good + bad)[0]:
            g, tot = f32(good[t]), f32(good[t] + bad[t])
            target = f32(g / max(tot, f32(1.0)))
            cs = _neighbours(f32(0.5))
            once = ref.fma_f32(torch.from_numpy((target - cs).astype(np.float32)), gamma,
                               torch.from_numpy(cs)).numpy()
            twice = (cs + (gamma * (target - cs)).astype(np.float32)).astype(np.float32)
            c = cs[np.argmax(once != twice)]
            credit = before["tenancy"]["credit"].copy()
            credit[t] = c
            crafted = _with(before, credit=credit)
            got, seen = run.port(crafted, monkeypatch)
            if not np.array_equal(_events(seen["args"])[0], good):
                continue            # the crafted credit moved an event
            want = run.reference(crafted)
            _assert_state(got, want, f"tick {k}, tenant {t}")
            i = np.argmax(cs == c)
            assert _bits(want["tenancy"]["credit"][t]) == _bits(once[i]) != _bits(twice[i])
            return
    raise AssertionError("no tick with a tenant event found")


def test_gate_contracts_as_the_reference(tick1, monkeypatch):
    """The gate's headroom is ``fma(slack, credit, mean)`` in the
    reference's compiled tick: a tenant with queued apps, no event and a
    credit that puts its share between the two roundings of the bound is
    throttled (or not) as the reference throttles it."""
    run = _Run(tick1, seed=8)
    slack = f32(BASE.control.slack)
    for k in range(8, 60):
        before = run.advance(k)
        _, seen = run.port(before, monkeypatch)
        a = seen["args"]
        good, bad = _events(a)
        # the shares themselves: the plain version's from a zero share_sum
        out = ref.control_tick(*a[:4], torch.zeros_like(a[4]), *a[5:], credit_on=True,
                               gate_on=True, gamma=BASE.control.credit_gamma,
                               floor=BASE.control.credit_floor, slack=BASE.control.slack)
        share = out[4][0].numpy()
        active = (out[5] > a[5])[0].numpy()
        queued = np.bincount(a[13][0].numpy()[a[9][0].numpy()], minlength=share.size)
        n = int(active.sum())
        if n < 2:
            continue
        mean = f32(ref.xla_sum(np.where(active, share, f32(0))[:, None])[0] / f32(n))
        for t in np.nonzero(active & (queued > 0) & (share > mean) & (good + bad == 0))[0]:
            c0 = f32((share[t] - mean) / slack)
            if not 0.06 < c0 < 0.99:
                continue
            cs = _neighbours(c0)
            once = ref.fma_f32(torch.full(cs.shape, float(slack)), torch.from_numpy(cs),
                               torch.full(cs.shape, float(mean))).numpy()
            twice = (mean + (slack * cs).astype(np.float32)).astype(np.float32)
            split = np.nonzero((share[t] <= once) != (share[t] <= twice))[0]
            if not split.size:
                continue
            i = split[0]
            credit = before["tenancy"]["credit"].copy()
            credit[t] = cs[i]
            crafted = _with(before, credit=credit)
            got, _ = run.port(crafted)
            want = run.reference(crafted)
            _assert_state(got, want, f"tick {k}, tenant {t}")
            throttled = want["tenancy"]["throttled"][t] > before["tenancy"]["throttled"][t]
            assert throttled == (not share[t] <= once[i]) != (not share[t] <= twice[i])
            return
    raise AssertionError("no tick with a gate split found")


def test_credit_quantile_contracts_as_the_reference(tick1):
    """A tenant's quantile is ``fma(q_spread, 1 - 2 * credit, q)`` in the
    reference's compiled tick: from a state whose series rings hold 17 to
    31 scores and no prediction is pending, a credit whose quantile lands
    on a rank boundary of one of its deploying rows only when rounded once
    moves that row's scale as the reference moves it."""
    run = _Run(tick1, seed=8)
    before = run.advance(14)
    rng = np.random.default_rng(3)
    calib = dict(before["calib"])
    R, cap = calib["ring"].shape
    counts = np.resize(np.asarray([31, 17, 23, 29], np.int32), R)
    calib["ring"] = np.where(np.arange(cap)[None, :] < counts[:, None],
                             rng.normal(1, 1, (R, cap)), np.inf).astype(np.float32)
    calib["ring_count"] = counts
    calib["left"] = np.zeros_like(calib["left"])     # nothing pending: every ready row deploys
    before = {**before, "calib": calib}
    after, _ = run.port(before)
    q = f32(after.calib.q[0])
    ccfg, tcfg = BASE.calibration, BASE.control
    slot, C = before["slot_gid"], run.wl.max_components
    ten = np.where(slot >= 0, np.asarray(run.wl.tenant)[np.maximum(slot, 0)], -1)
    rows_t = np.concatenate([np.repeat(ten, C)] * 2)
    deploy = np.concatenate([(np.repeat(slot >= 0, C) & before["comp_running"].reshape(-1)
                              & (before["mon_count"] >= BASE.grace))] * 2)
    deploy &= calib["left"] == 0
    spread = f32(tcfg.q_spread)
    for t in range(4):
        for n in sorted(set(counts[deploy & (rows_t == t)].tolist())):
            for m in range(1, n):
                c0 = f32((1 - (f32(m / (n + 1)) - q) / spread) / 2)
                if not 0.06 < c0 < 0.99:
                    continue
                cs = _neighbours(c0, 400_000)
                lin = (f32(1) - f32(2) * cs).astype(np.float32)
                once = np.clip(ref.fma_f32(torch.from_numpy(lin), float(spread),
                                           torch.full(cs.shape, float(q))).numpy(),
                               f32(ccfg.q_min), f32(ccfg.q_max))
                twice = np.clip((q + (spread * lin).astype(np.float32)).astype(np.float32),
                                f32(ccfg.q_min), f32(ccfg.q_max))
                rank = lambda x: np.ceil(((f32(n) + f32(1)) * x).astype(np.float32))  # noqa: E731
                split = np.nonzero(rank(once) != rank(twice))[0]
                if not split.size:
                    continue
                credit = before["tenancy"]["credit"].copy()
                credit[t] = cs[split[0]]
                crafted = _with(before, credit=credit)
                got, _ = run.port(crafted)
                want = run.reference(crafted)
                _assert_state(got, want, f"tenant {t}, {n} scores")
                return
    raise AssertionError("no credit found whose quantile splits a rank")


# ----------------------------------------------------------------------
# whole runs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("calibrated", [True, False])
def test_host_engine_equals_reference(calibrated):
    """The host engine against the reference's: summaries equal, the
    tenancy block and the calibration's per-tenant block included."""
    cfg = BASE if calibrated else dataclasses.replace(BASE, calibration=CalibrationConfig())
    pcfg, ptr, wl = _port(cfg)
    want = reng.run_sim(cfg, wl).summary()
    got = tengine.run_sim(pcfg, ptr, device="cpu").summary()
    assert got == want
    assert sum(want["tenancy"]["throttled"]) > 0
    if calibrated:
        assert sum(want["calibration"]["groups"]["resolved"]) > 0


def test_device_engine_equals_reference():
    """The device engine against the reference's scan engine: counters
    equal, metric means to rtol 1e-6, and the tenancy and calibration
    blocks (credit and mean share as the summary rounds them) equal."""
    pcfg, ptr, wl = _port(BASE)
    want = rstep.run_sim_scan(BASE, wl).summary()
    got = tstep.run_sim_scan(pcfg, ptr, device="cpu").summary()
    assert got.pop("tenancy") == want.pop("tenancy")
    assert got.pop("calibration") == want.pop("calibration")
    for k in COUNTERS:
        assert got[k] == want[k], k
    for k in want:
        np.testing.assert_allclose(got[k], want[k], rtol=1e-6, err_msg=k)


def test_device_engine_contracts():
    """Chunk 1 against 32 (every field of the final state), leap against
    uniform ticks, and a two-seed cohort against its solo runs."""
    pcfg, ptr, _ = _port(BASE)
    runs = {}
    for chunk in (1, 32):
        tr = tstep.DeviceTrace.from_traces([ptr], "cpu")
        st = tstep.init_state(pcfg, ptr.n_apps, ptr.max_components, 1, "cpu")
        runs[chunk] = tstep._drive_chunks(pcfg, None, tr, st, chunk,
                                          tstep.host_capacity(pcfg, "cpu"))[0]
    one, many = (tstep._tensors(runs[c]) for c in (1, 32))
    for name, x in many.items():
        assert torch.equal(one[name], x), name
    solo = tstep.run_sim_scan(pcfg, ptr, device="cpu")
    leap = tstep.run_sim_scan(dataclasses.replace(pcfg, leap=True), ptr, device="cpu")
    assert leap.summary() == solo.summary() and leap.n_running == solo.n_running
    cohort = tstep.run_cohort_scan(pcfg, [7, 8], device="cpu")
    other = tstep.run_sim_scan(dataclasses.replace(
        pcfg, workload=dataclasses.replace(pcfg.workload, seed=8)), device="cpu")
    assert cohort[0].summary() == solo.summary()
    assert cohort[1].summary() == other.summary() != solo.summary()


def test_control_off_has_no_tenancy():
    pcfg, ptr, _ = _port(dataclasses.replace(BASE, control=rctl.TenancyConfig()))
    for res in (tengine.run_sim(pcfg, ptr, device="cpu"),
                tstep.run_sim_scan(pcfg, ptr, device="cpu")):
        s = res.summary()
        assert "tenancy" not in s and "groups" not in s["calibration"]
        assert res.tenancy is None


def test_too_many_tenants_are_refused():
    cfg = dataclasses.replace(BASE, control=rctl.TenancyConfig(enabled=True, max_tenants=2))
    pcfg, ptr, wl = _port(cfg)
    with pytest.raises(ValueError, match="tenants > control.max_tenants=2"):
        reng.run_sim(cfg, wl)
    for run in (tengine.run_sim, tstep.run_sim_scan,
                lambda c, w, **k: tstep.run_cohort_scan(c, [7], wls=[w], **k)):
        with pytest.raises(ValueError, match="tenants > control.max_tenants=2"):
            run(pcfg, ptr, device="cpu")


def test_converted_state_carries_tenancy():
    """sim_state_from_arrays with a tenancy dict and a calibration with its
    group tier, solo and stacked; tenant_state_from_arrays."""
    cfg = BASE
    st = rstate.init_state(cfg, 24, 6)
    fields = _fields(st)
    pst = convert.sim_state_from_arrays(device="cpu", **fields)
    assert pst.tenancy.credit.shape == (1, 8) and pst.calib.group_ring.shape == (1, 8, 256)
    stacked = rstate.init_state(cfg, 24, 6, batch=3)
    ten = convert.tenant_state_from_arrays(device="cpu", **_fields(stacked.tenancy))
    assert ten.admitted.shape == (3, 8) and ten.admitted.dtype == torch.int32
    assert float(ten.credit[0, 0]) == cfg.control.credit_init


def test_control_kernel_takes_cuda_tensors_only():
    """Importing the kernel's module builds nothing; its wrapper refuses a
    CPU tensor (the plain version is ops.control_tick's CPU route) and
    ops refuses a device it has no route for, before any launch."""
    assert kcontrol._LIB is None and kcontrol.control_tick.launches == 0
    x = torch.zeros((1, 4))
    with pytest.raises(ValueError, match="CUDA tensors"):
        kcontrol.control_tick(*(x,) * 18, credit_on=True, gate_on=True, gamma=0.1,
                              floor=0.05, slack=0.1)
    with pytest.raises(ValueError, match="no control_tick implementation"):
        ops.control_tick(x.to("meta"))
    assert kcontrol.control_tick.launches == 0


# ----------------------------------------------------------------------
# on the card (``-m gpu``)
# ----------------------------------------------------------------------

@pytest.mark.gpu
def test_control_tick_kernel_equals_plain_version(tick1, monkeypatch):
    """control_tick on the card against its plain version on the inputs
    of the port's ticks of a run (one member), then three members at once
    with every tenant gated, no event, zero shares and the credit off."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    run = _Run(tick1, seed=8)
    calls = []
    for k in range(4, 40, 3):
        _, seen = run.port(run.advance(k), monkeypatch)
        calls.append(seen["args"])
    kw = dict(credit_on=True, gate_on=True, gamma=0.1, floor=0.05, slack=0.1)
    for args in calls:
        want = ref.control_tick(*args, **kw)
        got = kcontrol.control_tick(*(a.cuda() if isinstance(a, torch.Tensor) else a
                                      for a in args), **kw)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
    # members: the tenant state 0-5, the event masks 6-9, the resolutions
    # 11-12, the trace's tenants and the slot table 13-15
    stacked = [torch.cat([c[i] for c in calls[:3]]) if i not in (10, 16, 17) else c0
               for i, c0 in enumerate(calls[0])]
    stacked[0] = torch.full_like(stacked[0], 0.05)      # every tenant at the floor
    zero = list(stacked)
    zero[15] = torch.zeros_like(stacked[15])            # zero shares
    for args, over in ((stacked, kw), (stacked, dict(kw, credit_on=False)),
                       (stacked, dict(kw, slack=-0.5)),    # every active tenant gated
                       (zero, kw), (zero, dict(kw, gate_on=False))):
        want = ref.control_tick(*args, **over)
        got = kcontrol.control_tick(*(a.cuda() if isinstance(a, torch.Tensor) else a
                                      for a in args), **over)
        for g, w in zip(got, want):
            torch.testing.assert_close(g.cpu(), w, rtol=0, atol=0)
