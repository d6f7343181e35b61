"""Leap ticks on the port's device engine (``repro_torch.sim.step``:
``fused_leap``, ``_drive_chunks_leap``, ``ops.leap_skip``) on the CPU.

A leap step skips its member's provably idle ticks (empty cluster, empty
queue, next arrival beyond the next tick), advancing the clock by the
uniform engine's own float32 additions, then runs one tick.  So a leap
run must equal the uniform run of the same config bit for bit (every
per-tick series re-expanded from the steps' ``lead``), and the
reference's leap engine (``repro.sim.step.run_sim_scan(leap=True)``)
with the tolerance ``tests/test_torch_step.py`` holds the uniform
engines to: discrete outcomes equal, per-tick series allclose at rtol
1e-6 (the port sums the metrics in float64, the reference in a float32
tree).  The sizes are small: the reference's gap-dominated cell and the
scenario families at its shapes.
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from chip_smoke import LEAP_DTYPES, leap_clock_member, leap_clocks, leap_closed_form
from hypothesis import given, settings
from hypothesis import strategies as st

from repro.sim import ClusterConfig, SimConfig
from repro.sim import step as rstep
from repro.sim.scenarios import make_config
from repro.sim.scenarios.registry import build_trace
from repro_torch import convert
from repro_torch.kernels import leap as kleap
from repro_torch.kernels import ops, ref
from repro_torch.sim import step as tstep
from test_torch_flash_route import CudaStandIn
from test_torch_step import _gp_small, _JaxClient, _one_torch_thread, _TorchClient  # noqa: F401

COUNTERS = ("completed", "n_apps", "failure_events", "oom_kills", "full_preemptions",
            "partial_preemptions", "failed_frac", "sim_hours")
# the reference's gap-dominated cell (benchmarks/engine.py:134-141): a few
# background apps hours apart and three flash events of short apps, so
# most ticks have an empty cluster and an empty queue
GAP = SimConfig(
    cluster=ClusterConfig(n_hosts=2, max_running_apps=16),
    workload=make_config("flashcrowd", n_apps=24, max_components=4, seed=0,
                         burst_frac=0.75, n_events=3, event_gap_s=2.0,
                         mean_gap=10_800.0, min_runtime=120.0, max_runtime=600.0,
                         bg_max_runtime=900.0),
    policy="pessimistic", forecaster="persist", max_ticks=20_000)



def _columns(tr):
    return {f.name: getattr(tr, f.name) for f in dataclasses.fields(tr) if f.name != "cfg"}


def _port(cfg, family="google"):
    wl = build_trace(cfg.workload)
    return (convert.sim_config_from_dict(dataclasses.asdict(cfg), workload=family),
            convert.trace_from_arrays(**_columns(wl)), wl)


def _series(res) -> str:
    """Every result of a run, as text: equal text, equal bits (a run
    that completes nothing has NaN turnarounds, which == would refuse)."""
    return repr((res.summary(), res.n_running, res.util_cpu, res.util_mem, res.slack_cpu,
                 res.slack_mem, res.turnaround, sorted(res.failed_apps), res.forecast_rows))


def _assert_reference(got, want):
    """The port's run against the reference's: outcomes equal, the metric
    summaries and utilisation series allclose (rtol 1e-6)."""
    g, w = got.summary(), want.summary()
    for k in COUNTERS:
        assert g[k] == w[k], (k, g[k], w[k])
    for k in w:
        np.testing.assert_allclose(g[k], w[k], rtol=1e-6, err_msg=k)
    assert got.n_running == want.n_running and got.turnaround == want.turnaround
    assert got.failed_apps == want.failed_apps and got.sim_time == want.sim_time
    for name in ("util_cpu", "util_mem"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=1e-6,
                                   err_msg=name)
    # slack = (alloc - used) / alloc in [0, 1]: a difference of two sums
    # each within rtol 1e-6, so held to 2e-6 absolute
    for name in ("slack_cpu", "slack_mem"):
        np.testing.assert_allclose(getattr(got, name), getattr(want, name), rtol=0,
                                   atol=2e-6, err_msg=name)
    assert got.forecast_rows == want.forecast_rows


def _leap(cfg):
    return dataclasses.replace(cfg, leap=True)


# ----------------------------------------------------------------------
# the skip: ops.leap_skip against the reference's loop
# ----------------------------------------------------------------------

@jax.jit
def _reference_loop(slot_gid, queued, arrived, submit, done, t, left, tick):
    """``repro/sim/step.py:955-970`` per member (without the calibration
    guard, whose state the port does not have)."""
    def one(slot_gid, queued, arrived, submit, done, t, left):
        active = ~done.all() & (left > 0)
        idle = active & (slot_gid < 0).all() & ~queued.any()
        next_sub = jnp.min(jnp.where(arrived, jnp.inf, submit))

        def cond(c):
            return idle & (c[1] < left) & (next_sub > c[0] + tick)

        return jax.lax.while_loop(cond, lambda c: (c[0] + tick, c[1] + 1),
                                  (t, jnp.int32(0)))
    return jax.vmap(one)(slot_gid, queued, arrived, submit, done, t, left)


def _skip_states(seed, tick, S=64, A=5, N=9):
    """Seeded members: empty or busy slot tables, queues, arrivals (all
    arrived: next arrival +inf), done apps, budgets 0, 1, short and long,
    clocks on and off the tick grid, arrivals ~0-60 ticks away."""
    rng = np.random.default_rng(seed)
    slot_gid = np.where(rng.random((S, A)) < 0.1, rng.integers(0, N, (S, A)), -1)
    slot_gid[: S // 2] = -1
    queued = rng.random((S, N)) < 0.05
    queued[: S // 3] = False
    submit = np.sort(rng.uniform(0, 80 * tick, (S, N)), 1).astype(np.float32)
    t = ((rng.integers(0, 20, S) + np.where(rng.random(S) < 0.3, 0.37, 0.0)) * tick
         ).astype(np.float32)
    arrived = submit <= t[:, None]
    arrived[::7] = True
    done = arrived & (rng.random((S, N)) < 0.5)
    done[::11] = True
    left = rng.choice([0, 1, 2, 5, 40, 1000], S).astype(np.int32)
    return (slot_gid.astype(np.int32), queued, arrived, submit, done, t, left)


@pytest.mark.parametrize("tick", [60.0, 0.1, 7.3])
def test_leap_skip_equals_reference_loop(tick):
    args = _skip_states(int(tick * 10), tick)
    want_t, want_lead = _reference_loop(*args, np.float32(tick))
    got_t, got_lead = ops.leap_skip(*map(torch.as_tensor, args), tick)
    np.testing.assert_array_equal(got_lead.numpy(), np.asarray(want_lead))
    np.testing.assert_array_equal(got_t.numpy().view(np.int32),
                                  np.asarray(want_t).view(np.int32))
    lead = np.asarray(want_lead)
    left = args[-1]
    # gaps cut by an arrival, by the budget, and with every app arrived
    assert ((lead > 0) & (lead < left)).sum() > 3
    assert ((lead == left) & (left > 0)).sum() > 3
    assert ((lead == left) & args[2].all(1) & (left > 0)).any()
    assert (lead == 0).sum() > 10


def _one_idle_member(t, tick, next_sub, left):
    """``ref.leap_skip`` (the serial loop) on one idle member: (t, n)."""
    args = leap_clock_member(4, 6, np.float32(t), np.float32(next_sub), left)
    cols = [torch.as_tensor(np.ascontiguousarray(np.asarray(a)[None], dt))
            for a, dt in zip(args, LEAP_DTYPES)]
    t_out, lead = ref.leap_skip(*cols, float(np.float32(tick)))
    return t_out.numpy()[0], int(lead[0])


def _assert_closed_form_is_the_loop(t, tick, next_sub, left):
    want_t, want_n = _one_idle_member(t, tick, next_sub, left)
    got_t, got_n, _ = leap_closed_form(t, tick, next_sub, left)
    assert got_n == want_n, (t, tick, next_sub, left)
    assert np.float32(got_t).view(np.int32) == np.float32(want_t).view(np.int32), (
        t, tick, next_sub, left, got_t, want_t)


@pytest.mark.parametrize("name,t,tick,next_sub,left", leap_clocks(),
                         ids=[c[0] for c in leap_clocks()])
def test_leap_closed_form_equals_serial_loop_on_crafted_clocks(name, t, tick, next_sub, left):
    """The kernel's count, transcribed step by step (``chip_smoke.
    leap_closed_form``, as ``csrc/leap.cu::skip`` takes it), against the
    plain version's serial loop on the crafted clocks that ``chip_smoke.py``
    phase 3 runs on the card: the skipped ticks and the clock's bits."""
    _assert_closed_form_is_the_loop(t, tick, next_sub, left)


_F32 = st.floats(width=32, allow_nan=False, allow_infinity=False)


@st.composite
def _clocks(draw):
    """(t, tick, next arrival, budget): t across the binades (0, subnormal,
    up to 2^40, binade edges), ticks of 60, 0.1, 1/3, 1e-3, any positive
    float32 and half-ulp ties of t's binade, the next arrival +inf, on the
    tick grid, just off it or anywhere, budgets 0 to 20,000."""
    e = draw(st.integers(-149, 40))
    t = np.float32(draw(st.sampled_from([0.0, 2.0**e, 2.0**(e + 1) * (1 - 2.0**-24),
                                         draw(st.floats(2.0**e, 2.0**(e + 1)))])))
    kind = draw(st.sampled_from(["fixed", "any", "tie"]))
    if kind == "fixed":
        tick = np.float32(draw(st.sampled_from([60.0, 0.1, 1 / 3, 1e-3])))
    elif kind == "any":
        tick = np.float32(draw(_F32.filter(lambda x: x > 0)))
    else:                        # (m + 1/2) ulps of t's binade
        ulp = 2.0 ** (max(int(np.float32(t).view(np.uint32)) >> 23, 1) - 150)
        tick = np.float32((draw(st.integers(0, 40)) + 0.5) * ulp)
    if not np.isfinite(tick) or tick <= 0:
        tick = np.float32(60.0)
    left = draw(st.sampled_from([0, 1, 2, 225, 20_000]) | st.integers(0, 20_000))
    k = draw(st.integers(0, 25_000))
    next_sub = draw(st.sampled_from([
        np.inf, np.float32(t + np.float64(k) * tick),
        np.nextafter(np.float32(t + np.float64(k) * tick), np.float32(np.inf)),
        np.nextafter(np.float32(t + np.float64(k) * tick), np.float32(-np.inf))]) | _F32)
    return t, tick, np.float32(next_sub), left


@settings(max_examples=300, deadline=None)
@given(_clocks())
def test_leap_closed_form_equals_serial_loop(clock):
    """The kernel's closed-form count against ``ref.leap_skip``'s serial
    loop, bit for bit on the clock and exactly on the ticks skipped, over
    drawn clocks, ticks, arrivals and budgets."""
    _assert_closed_form_is_the_loop(*clock)


def _stand_ins(S=3, A=5, N=9, **over):
    specs = dict(slot_gid=((S, A), torch.int32), queued=((S, N), torch.bool),
                 arrived=((S, N), torch.bool), submit=((S, N), torch.float32),
                 done=((S, N), torch.bool), t=((S,), torch.float32),
                 left=((S,), torch.int32))
    return {k: over.get(k, CudaStandIn(shape, dtype)) for k, (shape, dtype) in specs.items()}


@pytest.mark.parametrize("bad, error, match", [
    ({}, None, None),
    ({"slot_gid": CudaStandIn((3, 5), torch.int32, device="cpu")}, ValueError, "CUDA"),
    ({"left": CudaStandIn((3,), torch.float32)}, TypeError, "int32"),
    ({"queued": CudaStandIn((3, 10), torch.bool)}, ValueError, "queued has shape"),
    ({"t": CudaStandIn((4,), torch.float32)}, ValueError, "t has shape"),
    ({"done": CudaStandIn((3, 9), torch.bool, device="cuda:1")}, ValueError, "done is on"),
    ({"submit": CudaStandIn((3, 9), torch.float32, contiguous=False)}, ValueError,
     "contiguous"),
], ids=["ok", "cpu", "left-dtype", "queued-shape", "t-shape", "other-card", "strided"])
def test_leap_skip_kernel_checks_its_inputs(bad, error, match):
    """The kernel's wrapper holds each tensor to its device, dtype and
    shape before anything is launched (CUDA stand-ins: no card needed)."""
    args = _stand_ins(**bad)
    if error is None:
        assert kleap._check(*args.values()) == (3, 5, 9)
        return
    with pytest.raises(error, match=match):
        kleap._check(*args.values())


def test_leap_skip_dispatch_takes_cpu_and_cuda_only():
    x = torch.zeros((1, 2), dtype=torch.bool, device="meta")
    with pytest.raises(ValueError, match="no leap_skip implementation"):
        ops.leap_skip(x, x, x, x, x, x, x, 60.0)


# ----------------------------------------------------------------------
# whole runs
# ----------------------------------------------------------------------

@pytest.mark.parametrize("family", ["google", "diurnal", "flashcrowd", "heavytail",
                                    "colocated"])
def test_leap_equals_uniform_every_family(family):
    """Each scenario family at the gap cell's shapes (24 apps of up to 4
    components, 2 hosts; so the reference compiles one leap program for
    this file's persist runs), capped at 100 ticks: leap ≡ uniform in the
    port bit for bit, and the reference's leap run."""
    cfg = dataclasses.replace(GAP, max_ticks=100, workload=make_config(
        family, base=GAP.workload, seed=3))
    pcfg, ptr, wl = _port(cfg, family)
    uni = tstep.run_sim_scan(pcfg, ptr, chunk=32, device="cpu")
    leap = tstep.run_sim_scan(_leap(pcfg), ptr, chunk=32, device="cpu")
    assert _series(leap) == _series(uni)
    _assert_reference(leap, rstep.run_sim_scan(_leap(cfg), wl, chunk=32))


def test_gap_cell_to_completion_equals_reference():
    """The gap-dominated cell to completion: most ticks are skipped, and
    the run equals the reference's leap run; chunk 1 ≡ chunk 32 over its
    first 300 ticks, which the uniform engine also runs."""
    pcfg, ptr, wl = _port(GAP, "flashcrowd")
    leap = tstep.run_sim_scan(_leap(pcfg), ptr, chunk=32, device="cpu")
    _assert_reference(leap, rstep.run_sim_scan(_leap(GAP), wl, chunk=32))
    assert leap.summary()["completed"] == 24
    assert leap.timings["steps"] * 5 < leap.timings["ticks"] == len(leap.util_cpu)
    cut = dataclasses.replace(pcfg, max_ticks=300)
    one, full = (tstep.run_sim_scan(_leap(cut), ptr, chunk=c, device="cpu") for c in (1, 32))
    assert _series(one) == _series(full) == _series(
        tstep.run_sim_scan(cut, ptr, chunk=32, device="cpu"))
    assert len(one.util_cpu) == 300 and one.timings["steps"] < 100


def test_budget_runs_out_mid_gap():
    """max_ticks = 10, which runs out inside the first idle gap: exactly
    10 ticks of history, as the uniform run and the reference's leap run
    (the counterpart of its test_leap_max_ticks_truncation_matches_uniform)."""
    cfg = dataclasses.replace(GAP, max_ticks=10)
    pcfg, ptr, wl = _port(cfg, "flashcrowd")
    uni = tstep.run_sim_scan(pcfg, ptr, chunk=32, device="cpu")
    leap = tstep.run_sim_scan(_leap(pcfg), ptr, chunk=32, device="cpu")
    assert _series(leap) == _series(uni)
    assert len(leap.util_cpu) == 10 and leap.timings["steps"] == 32
    _assert_reference(leap, rstep.run_sim_scan(_leap(cfg), wl, chunk=32))


def test_cohort_equals_solo_runs():
    """Three seeds of the gap cell as one cohort: members skip different
    spans and finish at different steps (a finished or spent member is a
    no-op), and each equals its solo run and the reference's."""
    cfg = dataclasses.replace(GAP, max_ticks=400)
    pcfg = convert.sim_config_from_dict(dataclasses.asdict(cfg), workload="flashcrowd")
    seeds = [0, 1, 2]
    cohort = tstep.run_cohort_scan(_leap(pcfg), seeds, chunk=32, device="cpu")
    for seed, res in zip(seeds, cohort):
        solo = _leap(dataclasses.replace(pcfg, workload=dataclasses.replace(
            pcfg.workload, seed=seed)))
        assert _series(res) == _series(tstep.run_sim_scan(solo, chunk=32, device="cpu"))
        _assert_reference(res, rstep.run_sim_scan(_leap(dataclasses.replace(
            cfg, workload=dataclasses.replace(cfg.workload, seed=seed))), chunk=32))
    assert len({r.timings["steps"] for r in cohort}) == 1
    assert len({len(r.util_cpu) for r in cohort}) == 1
    assert len({r.summary()["completed"] for r in cohort}) > 1


def test_leap_with_bucketed_gp_equals_uniform_full_batch(monkeypatch):
    """Leap with the bucketed gp forecast against uniform ticks over the
    full batch: the port's own GP (16 apps, 48 monitor rows a resource),
    bit for bit; and with one forecast client shared by both packages
    (the GP itself is held to the reference in tests/test_torch_gp_fused.py),
    the gap cell with a grace period of 3 samples (its apps run 2-15
    ticks) to completion, bucketed, against the reference's leap run."""
    cfg = _gp_small()
    fast = tstep.run_sim_scan(_leap(cfg), chunk=16, device="cpu")
    plain = tstep.run_sim_scan(dataclasses.replace(cfg, forecast_bucket=False), chunk=16,
                               device="cpu")
    assert _series(dataclasses.replace(fast, forecast_rows=None)) == _series(
        dataclasses.replace(plain, forecast_rows=None))
    assert 0 < fast.forecast_rows["rows_bucketed"] < plain.forecast_rows["rows_bucketed"]
    gcfg = dataclasses.replace(GAP, forecaster="gp", grace=3)
    pcfg, ptr, wl = _port(gcfg, "flashcrowd")
    monkeypatch.setattr(rstep, "_CHUNK_CACHE", {})
    monkeypatch.setattr(rstep, "_make_model", lambda c: _JaxClient())
    monkeypatch.setattr(tstep, "_make_model", lambda c: _TorchClient())
    got = tstep.run_sim_scan(_leap(pcfg), ptr, chunk=32, device="cpu")
    # the reference's leap run over the full batch (its own tests hold its
    # bucketed runs to that bit for bit; one program to compile)
    want = rstep.run_sim_scan(_leap(dataclasses.replace(gcfg, forecast_bucket=False)), wl,
                              chunk=32)
    _assert_reference(dataclasses.replace(got, forecast_rows=None),
                      dataclasses.replace(want, forecast_rows=None))
    assert got.forecast_rows["rows_ready"] == want.forecast_rows["rows_ready"] > 0
    assert got.timings["steps"] * 5 < got.timings["ticks"]


# ----------------------------------------------------------------------
# on the card (``-m gpu``)
# ----------------------------------------------------------------------

@pytest.mark.gpu
@pytest.mark.parametrize("tick", [60.0, 0.1])
def test_leap_skip_kernel_equals_plain_version(tick):
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    args = [torch.as_tensor(a) for a in _skip_states(3, tick)]
    want = ref.leap_skip(*args, tick)
    got = kleap.leap_skip(*(a.cuda() for a in args), tick)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy(), w.numpy())


@pytest.mark.gpu
def test_leap_graphs_equal_uniform_graphs_on_the_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    pcfg, ptr, _ = _port(GAP, "flashcrowd")
    leap = tstep.run_sim_scan(_leap(pcfg), ptr, device="cuda")
    uni = tstep.run_sim_scan(pcfg, ptr, device="cuda")
    assert _series(leap) == _series(uni)
