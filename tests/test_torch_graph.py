"""The device engine's chunk as one captured CUDA graph
(``repro_torch.sim.step._ChunkGraphs``), the port's counterpart of the
reference's jitted ``lax.scan`` chunk (``repro.sim.step._chunk_fn``).

On the CPU: which runs capture (the predicate), the cache key against
the reference's, that the CPU never builds a graph, and the chunk
program itself against a loop of ``fused_tick``.  On the card (``-m
gpu``): every replay equals the eager loop of ``fused_tick`` from the
same state, bit for bit, at every chunk boundary, also with a forecast
bucket that changes at every boundary; the bucketed forecast equals the
full batch; a second run captures nothing; the launch counts equal
replays times the launches captured; the optimistic policy (eager on
the card) equals the CPU.
"""
import dataclasses

import numpy as np
import pytest
import torch

from chip_smoke import graph_nodes, graph_vs_eager, wrapper_nodes
from repro.sim import SimConfig as RSimConfig
from repro.sim import step as rstep
from repro_torch import convert
from repro_torch.core.forecast import GPConfig
from repro_torch.core.shaper import SafeguardConfig
from repro_torch.kernels import nvcc
from repro_torch.sim import ClusterConfig, SimConfig, WorkloadConfig
from repro_torch.sim import step as tstep
from repro_torch.sim.scenarios.registry import build_trace
from repro_torch.sim.state import DeviceTrace, init_state


def _small(**over) -> SimConfig:
    """The port's twin of ``repro.sim.sweep.quick_base_config``: a
    saturated little cluster, with apps arriving from the first tick."""
    return dataclasses.replace(SimConfig(
        cluster=ClusterConfig(n_hosts=4, max_running_apps=48),
        workload=WorkloadConfig(n_apps=64, max_components=8, max_runtime=1800.0,
                                mean_burst_gap=2.0, mean_long_gap=40.0),
        max_ticks=45), **over)


def _setup(cfg, seeds, dev):
    wls = [build_trace(dataclasses.replace(cfg.workload, seed=s)) for s in seeds]
    tr = DeviceTrace.from_traces(wls, dev)
    st = init_state(cfg, wls[0].n_apps, wls[0].max_components, len(wls), dev)
    return tr, st, tstep.host_capacity(cfg, dev)


def _bits(x: torch.Tensor) -> np.ndarray:
    """Bit patterns, so that -0.0 and NaN payloads count."""
    x = x.detach().cpu()
    return (x.view(torch.int32) if x.dtype == torch.float32 else x).numpy()


def _assert_equal(got: dict, want: dict, where: str):
    assert got.keys() == want.keys()
    for k in want:
        np.testing.assert_array_equal(_bits(got[k]), _bits(want[k]), err_msg=f"{where}: {k}")


# ----------------------------------------------------------------------
# on the CPU
# ----------------------------------------------------------------------

@pytest.mark.parametrize("policy", ["pessimistic", "baseline", "optimistic"])
@pytest.mark.parametrize("forecaster", ["gp", "persist", "oracle"])
def test_captures_on_the_card_except_optimistic(policy, forecaster):
    cfg = SimConfig(policy=policy, forecaster=forecaster)
    assert not tstep._captures(cfg, torch.device("cpu"))
    assert tstep._captures(cfg, torch.device("cuda")) == (policy != "optimistic")
    assert tstep._captures(cfg, torch.device("cuda", 0)) == (policy != "optimistic")
    assert tstep._captures(SimConfig(), torch.device("cuda"))


def test_cfg_key_follows_the_reference():
    """Equal across seeds, workloads and run lengths; different for every
    knob the captured program bakes in; and for each change, the
    reference's key changes too, or neither does."""
    rbase = RSimConfig()
    changes = {
        "seed": lambda c: dataclasses.replace(c, workload=dataclasses.replace(c.workload,
                                                                              seed=7)),
        "workload": lambda c: dataclasses.replace(c, workload=dataclasses.replace(
            c.workload, n_apps=40, n_tenants=3, elastic_frac=0.3)),
        "max_ticks": lambda c: dataclasses.replace(c, max_ticks=45),
        "tick": lambda c: dataclasses.replace(c, cluster=dataclasses.replace(c.cluster,
                                                                             tick=30.0)),
        "k1": lambda c: dataclasses.replace(c, safeguard=dataclasses.replace(c.safeguard,
                                                                             k1=0.1)),
        "k2": lambda c: dataclasses.replace(c, safeguard=dataclasses.replace(c.safeguard,
                                                                             k2=2.0)),
        "grace": lambda c: dataclasses.replace(c, grace=5),
        "horizon": lambda c: dataclasses.replace(c, horizon=4),
        "gp": lambda c: dataclasses.replace(c, gp=dataclasses.replace(c.gp, opt_steps=12)),
        "gp kernel": lambda c: dataclasses.replace(c, gp=dataclasses.replace(c.gp,
                                                                             kernel="rbf")),
        "work_lost_on_kill": lambda c: dataclasses.replace(c, work_lost_on_kill=False),
        "policy": lambda c: dataclasses.replace(c, policy="baseline"),
        "forecaster": lambda c: dataclasses.replace(c, forecaster="persist"),
    }
    same = {"seed", "workload", "max_ticks"}
    pbase = convert.sim_config_from_dict(dataclasses.asdict(rbase))
    assert len(tstep._cfg_key(pbase)) == len(rstep._cfg_key(rbase))
    hash(tstep._cfg_key(pbase))
    for name, change in changes.items():
        rcfg = change(rbase)
        pcfg = convert.sim_config_from_dict(dataclasses.asdict(rcfg))
        equal = tstep._cfg_key(pcfg) == tstep._cfg_key(pbase)
        assert equal == (name in same), name
        assert equal == (rstep._cfg_key(rcfg) == rstep._cfg_key(rbase)), name
    assert tstep._cfg_key(_small()) == tstep._cfg_key(_small(max_ticks=7))
    assert tstep._cfg_key(SimConfig(safeguard=SafeguardConfig(k1=0.05))) == \
        tstep._cfg_key(SimConfig())
    assert tstep._cfg_key(SimConfig(gp=GPConfig(history=10, max_patterns=10,
                                                opt_steps=11))) != tstep._cfg_key(SimConfig())


def test_the_cpu_builds_no_graph(monkeypatch):
    class NoGraph:
        def __init__(self, *a, **k):
            raise AssertionError("a CUDA graph was constructed on the CPU path")

    monkeypatch.setattr(torch.cuda, "CUDAGraph", NoGraph)
    monkeypatch.setattr(torch.cuda, "graph_pool_handle", NoGraph)
    n = len(tstep._GRAPHS)
    for policy in ("pessimistic", "optimistic"):
        cfg = _small(max_ticks=12, forecaster="persist", policy=policy)
        tstep.run_sim_scan(cfg, chunk=5, device="cpu")
        tstep.run_cohort_scan(cfg, [0, 1], chunk=5, device="cpu")
    assert len(tstep._GRAPHS) == n


@pytest.mark.parametrize("forecaster", ["persist", "oracle"])
def test_chunk_program_equals_tick_loop_and_writes_the_state_back(forecaster):
    """What the card captures, run eagerly: the final state lands in the
    tensors it was given, and the metrics are the ticks' stacked."""
    cfg = _small(forecaster=forecaster)
    tr, st, cap = _setup(cfg, [0, 1], "cpu")
    held = tstep._tensors(st)
    ptrs = {k: v.data_ptr() for k, v in held.items()}
    eager = dataclasses.replace(st, **{k: v.clone() for k, v in held.items()})
    ms = []
    for _ in range(20):
        eager, m = tstep.fused_tick(cfg, None, tr, eager, cap)
        ms.append(m)
    for size in (13, 7):
        out = tstep._chunk_program(cfg, None, tr, st, size, cap)
        assert {k: v.shape for k, v in out.items()} == {k: (2, size) for k in tstep._METRICS}
        first = 0 if size == 13 else 13
        _assert_equal(out, {f: torch.stack([getattr(m, f) for m in ms[first:first + size]],
                                           -1) for f in tstep._METRICS}, f"chunk of {size}")
    assert {k: v.data_ptr() for k, v in tstep._tensors(st).items()} == ptrs
    _assert_equal(tstep._tensors(st), tstep._tensors(eager), "state after 20 ticks")
    assert int(st.arrived.sum()) > 0 and float(st.t[0]) == 20 * 60.0


# ----------------------------------------------------------------------
# on the card (``-m gpu``)
# ----------------------------------------------------------------------

def _need_card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _graph_vs_eager(cfg, seeds, chunk, buckets=None):
    """chip_smoke's check over the config's ``max_ticks``: one graph entry
    driven chunk by chunk beside the eager fused_tick loop from the same
    initial state, every field and metric equal at every chunk boundary.
    Returns the entry."""
    entry, _ = graph_vs_eager(tstep, cfg, seeds, cfg.max_ticks, chunk, buckets)
    assert bool(entry.st.arrived.any())
    return entry


@pytest.mark.gpu
@pytest.mark.parametrize("seeds", [(0,), (0, 1, 2)], ids=["solo", "cohort3"])
@pytest.mark.parametrize("chunk", [1, 7, 32])
@pytest.mark.parametrize("forecaster,policy", [("gp", "pessimistic"),
                                               ("persist", "pessimistic"),
                                               ("oracle", "pessimistic"),
                                               ("persist", "baseline")])
def test_graph_replay_equals_eager_ticks(forecaster, policy, chunk, seeds):
    _need_card()
    cfg = _small(forecaster=forecaster, policy=policy)
    entry = _graph_vs_eager(cfg, seeds, chunk)
    sizes = {chunk} | ({cfg.max_ticks % chunk} if cfg.max_ticks % chunk else set())
    assert set(entry.graphs) == sizes
    assert all(g.replays >= 1 for g in entry.graphs.values())


@pytest.mark.gpu
@pytest.mark.parametrize("seeds", [(0,), (0, 1, 2)], ids=["solo", "cohort3"])
def test_graph_replay_equals_eager_with_changing_buckets(seeds):
    """The bucketed gp forecast with a bucket that changes at every chunk
    boundary (below the ready count, above it, the full table): one
    graph per chunk size replays them all, equal to the eager loop."""
    _need_card()
    cfg = _small(max_ticks=6 * 7 + 3)
    entry = _graph_vs_eager(cfg, seeds, 7, buckets=(8, None, 64, 16, 8, 32, 128))
    assert set(entry.graphs) == {7, 3}
    assert len(tstep._GRAPHS) <= tstep._GRAPHS_MAX


@pytest.mark.gpu
def test_bucketed_equals_full_batch_on_the_card():
    _need_card()
    cfg = _small(max_ticks=160)
    on = tstep.run_cohort_scan(cfg, [0, 1], chunk=16, device="cuda")
    off = tstep.run_cohort_scan(dataclasses.replace(cfg, forecast_bucket=False), [0, 1],
                                chunk=16, device="cuda")
    for a, b in zip(on, off):
        assert a.summary() == b.summary()
        assert (a.n_running, a.util_cpu, a.util_mem, a.turnaround, a.failed_apps) == \
            (b.n_running, b.util_cpu, b.util_mem, b.turnaround, b.failed_apps)
        fa, fb = a.forecast_rows, b.forecast_rows
        assert fa["rows_ready"] == fb["rows_ready"] > 0
        assert fa["rows_bucketed"] < fb["rows_bucketed"]


@pytest.mark.gpu
def test_second_run_captures_nothing_and_counts_replays(monkeypatch):
    _need_card()
    # the census below reads the graphs' nodes; a fresh cache captures
    # them with their nodes kept
    monkeypatch.setattr(tstep._ChunkGraphs, "keep_nodes", True)
    monkeypatch.setattr(tstep, "_GRAPHS", {})
    cfg = _small()
    _graph_vs_eager(cfg, (0,), 7)
    tr, st, cap = _setup(cfg, (5,), "cuda")
    key_before = set(tstep._GRAPHS)
    entry = tstep._graph_entry(cfg, tstep._make_model(cfg), tr, st, 7, cap)
    graphs = dict(entry.graphs)
    replays = {n: g.replays for n, g in graphs.items()}
    counts = {fn: fn.launches for fn in nvcc.COUNTED}
    res = tstep.run_sim_scan(dataclasses.replace(
        cfg, workload=dataclasses.replace(cfg.workload, seed=5)), chunk=7, device="cuda")
    assert set(tstep._GRAPHS) == key_before
    # the same graph objects: nothing captured
    assert entry.graphs.keys() == graphs.keys()
    assert all(entry.graphs[n] is g for n, g in graphs.items())
    ran = {n: g.replays - replays[n] for n, g in graphs.items()}
    assert sum(n * r for n, r in ran.items()) == res.timings["ticks"] and ran[7] >= 1
    for fn in nvcc.COUNTED:
        want = sum(ran[n] * g.launches.get(fn, 0) for n, g in graphs.items())
        assert fn.launches - counts[fn] == want, fn.__name__
    per_tick = {fn.__name__: graphs[7].launches.get(fn, 0) / 7 for fn in nvcc.COUNTED}
    # what the capture counted is what libcuda holds in the graph
    for n, g in graphs.items():
        assert wrapper_nodes(graph_nodes(g.graph)[1]) == \
            {fn.__name__: g.launches.get(fn, 0) for fn in nvcc.COUNTED}, n
    for name in ("pessimistic_pass", "resolve_oom", "admit_queued", "place_missing_elastic",
                 "gp_fit_forecast"):
        assert per_tick[name] == 1, per_tick
    assert per_tick["fma_f32"] >= 1 and per_tick["fma_f32"] == int(per_tick["fma_f32"])
    # the same seed through the same entry, replay by replay, equals the
    # eager loop
    assert _graph_vs_eager(dataclasses.replace(
        cfg, workload=dataclasses.replace(cfg.workload, seed=5)), (5,), 7) is entry


@pytest.mark.gpu
def test_optimistic_on_the_card_equals_the_cpu():
    _need_card()
    cfg = _small(policy="optimistic", forecaster="persist", max_ticks=400)
    n = len(tstep._GRAPHS)
    gpu = tstep.run_cohort_scan(cfg, [0, 1], device="cuda")
    cpu = tstep.run_cohort_scan(cfg, [0, 1], device="cpu")
    assert len(tstep._GRAPHS) == n             # eager on the card: nothing cached
    for a, b in zip(gpu, cpu):
        assert a.summary() == b.summary()
        assert (a.n_running, a.util_mem, a.turnaround, a.failed_apps) == \
            (b.n_running, b.util_mem, b.turnaround, b.failed_apps)
    assert any(r.summary()["failure_events"] > 0 for r in cpu)
