#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout (one
``nvcc`` per source, all at once), checks each against its plain version
on the card, and drives the port's main paths through their public entry
points:

  * the default simulation on the host engine (``run_sim(SimConfig())``:
    GP forecaster, pessimistic policy, 500 apps, 50 hosts) with a cap on
    its ticks, after checking the GP and small runs on the card against
    the CPU; each forecasting tick launches the fused GP program once,
    each shaping tick Algorithm 1's kernel once, the Gram kernels never;
  * the same simulation on the device engine (``run_sim_scan(SimConfig())``)
    to completion, each chunk a replayed CUDA graph, captured and
    replayed under ``torch.cuda.set_sync_debug_mode("error")``, with one
    launch per tick of the GP program, Algorithm 1's pass and the three
    scheduler kernels (OOM, admission, elastic re-placement) and the same
    number of launches every tick of the one-rounding ``a*b + c`` kernel
    (replays x the launches each graph holds), after the full-width
    oracle run on the card (graphs) against the CPU (eager).  Its
    forecasts are bucketed: the GP program runs over the ready rows
    only, their mask read on the card, and the run is held bit for
    bit to the same run over the full batch (``forecast_bucket=False``),
    both profiled for the GP program's share.  Then the graphs against
    the eager ticks on the card, bit for bit at every chunk boundary
    (135 ticks, so that the full and the cut chunk's graphs both run;
    buckets that change at every boundary; a 3-seed cohort), and both
    timed in turns;
  * the four scenario families (diurnal, flashcrowd, heavytail,
    colocated) at their default 500 apps and the replay of the two
    fixtures in tests/data on the device engine, gp and oracle, the
    oracle runs card against CPU;
  * leap ticks on the device engine (phase 5e): google and the four
    families at 500 apps and the reference's gap-dominated cell to
    completion, leap graphs bit for bit against uniform graphs, the gap
    cell timed in turns, the idle-tick skip kernel counted against its
    graph's nodes; and the ARIMA forecaster (phase 5f) on both engines,
    one launch per forecasting tick, 160 device-engine ticks card
    against CPU; the GP's first 320 device-engine ticks card against CPU
    (phase 4c, a finding where they differ);
  * conformal calibration (phase 5g): SimConfig(calibration=
    CalibrationConfig(enabled=True, q=0.9, adaptive=True, budget=0.1)) on
    the device engine to completion through replayed graphs, one
    calib_observe, conformal_scale and calib_begin launch a tick counted
    against the graphs' kernel nodes, the same with adaptive=False,
    ticks/s against the uncalibrated run in turns and kernels a tick
    with and without calibration; the host engine capped at 240 ticks;
    heavytail at 500 apps for 320 ticks; card against CPU with persist
    over 160 ticks (equal, else the phase fails) and with the GP over 96
    (a finding where they differ);
  * the multi-tenant control plane (phase 5h): SimConfig(workload=
    WorkloadConfig(n_tenants=4), control=TenancyConfig(enabled=True),
    calibration as phase 5g's) on the device engine to completion through
    replayed graphs, one control_tick launch a tick counted against the
    graphs' kernel nodes, kernels a tick and ticks/s in turns against the
    same run with the control plane off; the host engine capped at 240
    ticks; card against CPU with persist over 160 ticks (equal, else the
    phase fails) and with the GP over 96 (a finding); the reference's two
    tenancy cells (benchmarks/tenancy.py: fairness in its ungated, wdrf
    and credit modes, per-tenant coverage), their Jain indices and
    coverage printed beside the reference's criteria;
  * the telemetry rings (phase 5i): SimConfig(obs=ObsConfig(enabled=
    True)) on the device engine to completion through replayed graphs,
    one obs_tick launch a tick counted against the graphs' kernel nodes,
    the run equal to the rings off, kernels a tick and ticks/s in turns
    against it, the histories' event channels against the run's
    counters; phase 5h's tenanted path with the rings (its tenant and
    calibration counters equal to the histories' sums); the gap cell's
    leap histories against uniform ones; 160 tenanted persist ticks card
    against CPU, histories included (equal, else the phase fails);
  * the sweep driver (phase 5j): run_grid(SimConfig(), policy x 2 seeds,
    engine="scan", obs=True), two seed cohorts to completion, each cell
    equal to its solo run_sim_scan (summaries, series, forecast rows,
    ring histories), the results' keys the schema-3 set, the manifest
    and dashboard written; the GP host grid (policy x calibration x 2
    seeds, MAIN_PATH_TICKS ticks) on the thread pool through the
    forecast batcher, each cell equal to its solo run_sim, fewer batches
    than requests and one gp_fit_forecast launch a batch, then without
    the batcher; the family fitted to the Alibaba fixture at 500 apps;
    the GP's and ARIMA's forecast diagnostics card against CPU;
  * streamed ingestion and fleets (phase 5k): SimConfig() with its
    workload streamed (StreamConfig, the default window of 256 rows)
    to completion through replayed graphs, bit for bit the materialized
    run, its captures by window width and a second run counted against
    the graphs' kernel nodes, ticks/s of both in turns; a window of 16
    that grows (a new graph at each width); the gap cell's leap streamed
    in a window of 8; 20,000 tasks of the reference replay bench's
    Alibaba-shaped trace through a window of at most 256 rows, every task
    done, ticks/s and tasks/s (its materialized run of 100,000 tasks
    cannot launch: the admission kernel's shared memory), its 1,500-task
    slice streamed against materialized, uniform and leap; a google +
    flashcrowd fleet through run_fleet_shard(mesh=1), each member its
    solo run;
  * the GP past the fused program's 64 patterns (phase 5l): LONG_GP (h =
    40, N = 128 patterns, windows of 168) takes the Gram route, 14 Gram
    forward and 10 gradient launches a forecast: forecast_batch on 512
    seeded windows card against CPU, both kinds, a ready mask, a row
    alone, a failed factor; the host engine capped at 240 ticks (its
    first 48 card against CPU); the device engine capped at 240 ticks
    through graphs, the Gram launches counted against the graphs' nodes,
    ticks/s, peak memory and the device time split into the Gram pair,
    cuSOLVER/cuBLAS and the rest;
  * Whisper-large-v3 serving at full width (random weights from a seeded
    generator on the card): 8 requests of 1,500 frames prefilled with 448
    teacher-forced tokens through the tensor-core flash kernel (bf16,
    route "sm90"), then 16 greedy cached decode steps, after checking a
    smoke-width Whisper on the card against the same parameters on the
    CPU; then the same prefill in fp32, whose decoder self-attention
    takes the CUDA-core flash kernel (route "simt").

Before the paths it checks every kernel against its plain version on the
card: the Gram pair (GRAM_SHAPES: also K(X, X) at the Gram route's width
as one tensor, whose diagonal must be one float, sf^2 under rbf, and the
gradient twice, bit for bit), the fused GP program (on 512 seeded windows with a
row whose factor fails and padded all-invalid rows, "exp" and "rbf";
with a ready mask in device memory, none, some and all per member, and
at the device engine's 3,072 rows),
both flash routes on every shape of FLASH_SHAPES, the ``a*b + c`` kernel
bit for bit (a counterexample to two roundings, float32 midpoints, 10^5
seeded triples, the engine's shapes; scalar and tensor b, aligned and
not), and the device engine's four
kernels on full-width states captured from the port's own CPU runs,
seeded tie-prone tables and edge cases (three members, A * C and N off
the 16-byte vectors, a host below 0 before the pass, tied OOM victims,
admissions until a head does not fit, submit ties broken by gid,
missing elastic components that fill the hosts; every output equal),
the OOM handler on host totals crafted onto capacity + 1e-6 at the
shapes whose total XLA:CPU sums in vector lanes, the idle-tick skip on
seeded and edge members (and members whose calibration scores are
pending), the scheduler kernels, the skip, control_tick and obs_tick on
a streamed window's re-keyed and free rows, the ARIMA kernel on 3,072 seeded
windows and on the crafted windows of ARIMA_CRAFTED (an order that is
not fitted winning, the fitted one winning, the fallback's edge, holes,
constant and signed-zero windows, every and no row ready, other orders,
40 samples), conformal_scale on crafted rings (crafted_rings: ties, +-0,
NaN payloads, +-inf, k at 0 and n - 1, capacities 16 to 2,048 on the
warp's and the block's paths, the engine's launch with the per-tenant
tier), and the calibration's three kernels (calib_observe;
conformal_scale, generic and in the engine's shaping step with
calib_begin) on seeded full-width members, counts from 0 to past the
capacity, a tick that resolves more scores than the pool holds, ties,
signed zeros and NaN, the pool or the adaptive step off, a 3-member
cohort, 20 and 40 rows and a capacity of 256, each bit for bit; and the
control plane's kernels: control_tick on seeded full-width members (T =
1, 4 and 8, a tenant with no event, conflicts, weights, every tenant
gated, zero shares, the credit or the gate off, a 3-member cohort), the
admission kernel with the gate on every admission case (T = 1, 4, 8;
every tenant gated, every tenant eligible) and the calibration kernels'
per-tenant tier (full width, T = 4 and 8, credit on and off, a 3-member
cohort), each bit for bit; and the rings' kernel, obs_tick, on seeded
full-width members with every feature and with none, T = 1, 4 and 8,
a 3-member cohort with an inactive member and wrapping cursors, and
slot counts off the 32-slot windows, bit for bit.
It then times each kernel against its plain version, its bound and,
where one PyTorch call computes the same function, that call; the
device engine's kernels also by their device and host time per call
and their phases' cycles.  Every phase raises on failure.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Each phase ends with its seconds.  The last line of standard output is
``{"ok": true, "device": ...}``; the line before it lists each kernel's
launches on its main path, error, times and bound.  Without a CUDA
device, or without the repository's ``src/`` beside it, the script fails
and prints no result.
"""
from __future__ import annotations

import collections
import concurrent.futures
import ctypes
import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

MAIN_PATH_TICKS = 240      # cap on the default simulation's ticks
RTOL, ATOL = 2e-5, 2e-6    # Gram kernels vs plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM, fp32 outside the tensor cores
BF16_FLOP_PER_S = 989e12   # H100 SXM, bf16 on the tensor cores, dense

# flash kernel vs plain version: fp32 to rounding (the sums run in another
# order), bf16 to a few ulp of the output (both round one fp32 result)
FLASH_TOL = {"float32": 2e-5, "bfloat16": 2e-2}
# (b, hq, hkv, s, t, d, causal): GQA groups 1/2/4/8, S < 8, a decode
# prefixes S < T (q_offset > 0), S and T off the kernels' tiles (32/64
# for simt, 64 for sm90), D of 16, 20, 24, 32, 64, 72 and 128 (D = 20
# takes the simt route in bf16 too), non-causal (also S > T), and the
# Whisper decoder's shape; the same list as tests/test_torch_kernels.py
FLASH_SHAPES = [
    (1, 1, 1, 32, 32, 16, True), (2, 4, 2, 64, 64, 32, True),
    (1, 8, 1, 128, 128, 64, True), (2, 8, 8, 100, 100, 64, True),
    (2, 8, 4, 100, 100, 64, True), (2, 8, 2, 100, 100, 64, True),
    (2, 4, 2, 3, 3, 64, True), (2, 4, 2, 1, 77, 64, True),
    (1, 4, 2, 32, 128, 32, True), (2, 4, 4, 100, 300, 64, True),
    (2, 4, 4, 48, 48, 24, True), (1, 4, 2, 70, 70, 16, True),
    (1, 4, 2, 70, 70, 128, True), (1, 2, 2, 33, 65, 16, False),
    (1, 2, 2, 64, 100, 32, False), (1, 2, 1, 100, 50, 64, False),
    (1, 8, 1, 200, 200, 128, True), (2, 8, 2, 17, 300, 32, True),
    (1, 4, 4, 129, 129, 64, True), (1, 4, 2, 65, 65, 32, True),
    (1, 4, 2, 130, 130, 20, True), (1, 2, 2, 300, 140, 128, False),
    (1, 4, 1, 96, 160, 72, True), (1, 8, 4, 64, 1000, 16, True),
    (8, 20, 20, 448, 448, 64, True),
]
FLASH_PATH_SHAPE = (8, 20, 20, 448, 448, 64, True)

WHISPER = "whisper-large-v3"
REQUESTS = 8               # requests per prefill batch
FRAMES = 1500              # Whisper's 30 s audio context (see PERF.md)
DECODE_STEPS = 16          # greedy cached steps after the prefill
SMOKE_GREEDY_STEPS = 8     # greedy steps of the card-vs-CPU check
# smoke Whisper, fp32, card vs CPU: cuBLAS and the CPU sum in other orders
WHISPER_RTOL, WHISPER_ATOL = 1e-4, 1e-5


_PHASE: list = []     # the phase running: its heading and its start on the host clock


def log(*a):
    """Print a line; a phase's heading ("== ...") first closes the phase
    before it with its seconds."""
    if a and str(a[0]).startswith("== "):
        end_phase()
        _PHASE[:] = [str(a[0]).split(".")[0][3:], time.perf_counter()]
    print(*a, flush=True)


def end_phase() -> None:
    if _PHASE:
        print(f"   phase {_PHASE[0]}: {time.perf_counter() - _PHASE[1]:.1f} s", flush=True)
        _PHASE.clear()


def nvidia_smi() -> str:
    out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, timeout=60, check=True)
    return out.stdout.strip().splitlines()[0]


def cuda_time_ms(fn, iters=200, warmup=20) -> float:
    import torch
    for _ in range(warmup):
        fn()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def graph_us(fn, n=50, replays=5) -> float:
    """Device microseconds per call of ``fn``: ``n`` calls captured in one
    CUDA graph and replayed between CUDA events, so the host's cost per
    call (checks, ctypes, enqueue) is out of the way."""
    import torch
    fn()
    torch.cuda.synchronize()
    graph, stream = torch.cuda.CUDAGraph(), torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        graph.capture_begin()
        for _ in range(n):
            fn()
        graph.capture_end()
    torch.cuda.current_stream().wait_stream(stream)
    graph.replay()
    start, end = (torch.cuda.Event(enable_timing=True) for _ in range(2))
    torch.cuda.synchronize()
    start.record()
    for _ in range(replays):
        graph.replay()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / (replays * n) * 1e3


def inputs(b, m, n, d, dev, *, same, seed):
    """Seeded (xa, xb, ell, sf, grad).  ``same`` makes xa the first m rows
    of xb, as the GP's fit (X against X) and horizon steps do; with m ==
    n, xa is xb itself, the one tensor the Gram route passes for K(X, X)
    (the kernels' symmetric path)."""
    import torch
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((b, n, d)).astype(np.float32)
    xa = xb[:, :m] if same else rng.standard_normal((b, m, d)).astype(np.float32)
    ell = rng.uniform(0.3, 3.0, b).astype(np.float32)
    sf = rng.uniform(0.3, 3.0, b).astype(np.float32)
    g = rng.standard_normal((b, m, n)).astype(np.float32)
    out = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
           for a in (xa, xb, ell, sf, g)]
    if same and m == n:
        out[0] = out[1]
    return out


# (b, m, n, d, same) of the Gram pair's checks: the fused program's old
# main path (B series of 10 x 11 patterns against themselves and one
# query against them), the reference's test shapes, then the Gram route's:
# K(X, X) and a horizon step's cross-Gram at LONG_GP's width (128 patterns
# of 41), tiles with ragged edges on both paths, D past one staged chunk
# of 44 features, a single entry; and K(X, X) too large for a block a
# series (the symmetric tile path)
GRAM_SHAPES = ([(b, m, 10, 11, True) for b in (128, 256, 512) for m in (10, 1)]
               + [(3, m, n, d, False) for m, n, d in
                  [(1, 1, 1), (7, 5, 3), (10, 10, 11), (40, 40, 41), (128, 128, 128),
                   (130, 60, 17)]]
               + [(256, 128, 128, 41, True), (256, 1, 128, 41, False),
                  (3, 130, 129, 17, False), (3, 130, 130, 17, True), (3, 72, 200, 200, False),
                  (1, 1, 1, 1, False), (2, 200, 200, 100, True)])


def check_kernels(gp_gram, ref, dev) -> dict:
    """Forward and backward kernels against the plain versions on
    GRAM_SHAPES, both kinds; every diagonal entry of K(X, X) the same
    float, sf^2 exactly under rbf; two runs of the gradient equal bit for
    bit.  Returns the largest absolute error of each kernel."""
    import torch
    err = {"gp_gram_fwd": 0.0, "gp_gram_bwd": 0.0}
    for kind in ("exp", "rbf"):
        for i, (b, m, n, d, same) in enumerate(GRAM_SHAPES):
            xa, xb, ell, sf, g = inputs(b, m, n, d, dev, same=same, seed=i)
            K = gp_gram.gram_fwd(xa, xb, ell, sf, kind)
            d_ell, d_sf = gp_gram.gram_bwd(g, xa, xb, ell, sf, kind)
            again = gp_gram.gram_bwd(g, xa, xb, ell, sf, kind)
            torch.cuda.synchronize()
            K_ref = ref.gram(xa, xb, ell, sf, kind)
            torch.testing.assert_close(K, K_ref, rtol=RTOL, atol=ATOL)
            # a per-series sum of m*n terms: atol grows with the count
            w_ell, w_sf = ref.gram_bwd(g, xa, xb, ell, sf, kind)
            for got, want in ((d_ell, w_ell), (d_sf, w_sf)):
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * m * n)
            for got, rerun in zip((d_ell, d_sf), again):
                assert torch.equal(got.view(torch.int32), rerun.view(torch.int32)), \
                    (kind, b, m, n, d)
            note = ""
            if same and m == n:
                diag = torch.diagonal(K, dim1=1, dim2=2)
                assert torch.equal(diag, diag[:, :1].expand_as(diag)), (kind, b, m, n, d)
                if kind == "rbf":
                    assert torch.equal(diag[:, 0], sf * sf), (b, m, n, d)
                note = (", K(X, X) one tensor: each series' diagonal one float"
                        + (" = sf^2" if kind == "rbf" else ""))
            err["gp_gram_fwd"] = max(err["gp_gram_fwd"],
                                     (K - K_ref).abs().max().item())
            err["gp_gram_bwd"] = max(err["gp_gram_bwd"],
                                     (d_ell - w_ell).abs().max().item(),
                                     (d_sf - w_sf).abs().max().item())
            log(f"  {kind} B={b} ({m}x{d})·({n}x{d}) ok, gradient twice bit for bit{note}")
    return err


def seeded_windows(n=512, width=24, seed=0):
    """Usage-like monitor windows: random walks around a level, some flat,
    with 10..24 valid samples (the engine forecasts from 10) and zeros in
    the cells not yet observed."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(0.1, 8.0, (n, 1))
    walk = level * (1 + 0.08 * np.cumsum(rng.standard_normal((n, width)), 1))
    flat = rng.random(n) < 0.1
    walk[flat] = level[flat]
    w = np.clip(walk, 0.0, None).astype(np.float32)
    count = rng.integers(10, width + 1, n)
    valid = np.arange(width)[None, :] >= (width - count)[:, None]
    return np.where(valid, w, 0).astype(np.float32), valid


def assert_gp_close(mg, vg, mc, vc, w, cnt, what, h=10, mean_sd=0.0) -> int:
    """The GP tolerances of tests/test_torch_forecast.py by a row's valid
    count, for history h: >= h+2 valid rtol 1e-3 on the mean and 5e-3 on
    the variance, h+1 valid 5e-2, <= h valid (persistence) equal; a
    variance below the square of one float32 ulp of the row's level is
    rounding noise.  A NaN must be NaN in both.  With ``mean_sd`` a mean
    beyond its rtol passes within mean_sd of the row's predictive standard
    deviation (the CPU's): returns how many such rows there were."""
    nan_g, nan_c = np.isnan(mg) | np.isnan(vg), np.isnan(mc) | np.isnan(vc)
    if (nan_g != nan_c).any():
        raise AssertionError(f"{what}: NaN in {np.flatnonzero((nan_g != nan_c).any(1))}")
    atol_var = (np.finfo(np.float32).eps * np.abs(w).max(1, keepdims=True)) ** 2
    by_sd = 0
    for sel, rt_m, rt_v in ((cnt >= h + 2, 1e-3, 5e-3), (cnt == h + 1, 5e-2, 5e-2),
                            (cnt <= h, 0.0, 0.0)):
        beyond = np.abs(mg - mc) > rt_m * np.abs(mc)
        bad_m = beyond & ((np.abs(mg - mc) > mean_sd * np.sqrt(np.abs(vc))) | (rt_m == 0))
        by_sd += int((sel & beyond.any(1) & ~bad_m.any(1)).sum())
        bad_v = np.abs(vg - vc) > atol_var + rt_v * np.abs(vc)
        bad = sel & (bad_m | bad_v).any(1)
        if bad.any():
            for i in np.flatnonzero(bad)[:8]:
                log(f"  {what} row {i} ({cnt[i]} valid): mean {mg[i]} vs {mc[i]}, "
                    f"var {vg[i]} vs {vc[i]}")
            raise AssertionError(f"{what} disagrees on {bad.sum()} of {sel.sum()} rows")
    return by_sd


def mean_sd_reading(mg, mc, vc, cnt, h) -> float:
    """The largest |card - CPU| over the CPU's predictive sd among the
    means beyond assert_gp_close's rtol (rows of h + 1 or more valid): what
    its ``mean_sd`` limit is held against; 0 where none is beyond."""
    rt = np.where(cnt >= h + 2, 1e-3, 5e-2)[:, None]
    beyond = (np.abs(mg - mc) > rt * np.abs(mc)) & (cnt >= h + 1)[:, None]
    ratio = np.abs(mg - mc) / np.sqrt(np.abs(vc))
    return float(ratio[beyond].max()) if beyond.any() else 0.0


def check_gp(GPForecaster, GPConfig) -> None:
    """forecast_batch on the card against the port on the CPU, with the
    tolerances of tests/test_torch_forecast.py."""
    gp = GPForecaster(GPConfig(history=10, max_patterns=10, opt_steps=10))
    w, v = seeded_windows()
    fc_gpu = gp.forecast_batch(w, 3, valid=v, device="cuda")
    fc_cpu = gp.forecast_batch(w, 3, valid=v, device="cpu")
    mg, vg = fc_gpu.mean.cpu().numpy(), fc_gpu.var.cpu().numpy()
    mc, vc = fc_cpu.mean.numpy(), fc_cpu.var.numpy()
    assert mg.shape == (512, 3) and np.isfinite(mg).all() and np.isfinite(vg).all()
    assert_gp_close(mg, vg, mc, vc, w, v.sum(1), "GP on the card vs the CPU")
    log(f"  GP forecast_batch cuda vs cpu: 512 rows within tolerance "
        f"(max rel mean err {np.max(np.abs(mg - mc) / np.maximum(np.abs(mc), 1e-6)):.3g})")


GP_CFG = dict(history=10, max_patterns=10, opt_steps=10)   # SimConfig().gp


def gp_batch(GPConfig, dev, kind="exp", **over):
    """The fused GP program's inputs as forecast_batch builds them: the
    512 seeded windows, then one window whose patterns hold a NaN (its
    factor is not positive definite) and 15 all-invalid padded rows, as
    the engine pads a batch.  Returns (cfg, windows, valid, the kernel's
    inputs, mu, sd)."""
    import torch
    from repro_torch.core.forecast import gp as G
    cfg = GPConfig(kernel=kind, **{**GP_CFG, **over})
    w, v = seeded_windows()
    full = int(np.flatnonzero(v.all(1))[0])
    w = np.concatenate([w, w[full:full + 1], np.zeros((15, w.shape[1]), np.float32)])
    v = np.concatenate([v, v[full:full + 1], np.zeros((15, v.shape[1]), bool)])
    wt, vt = torch.as_tensor(w, device=dev), torch.as_tensor(v, device=dev)
    X, y, rv, hist, mu, sd = G.fit_inputs(wt, vt, cfg)
    X = X.clone()
    X[512, 4, 3] = float("nan")
    args = [t.contiguous() for t in (X, y, rv, hist)] + [w.shape[1]]
    return cfg, w, v, args, mu, sd


def check_gp_kernel(gp_forecast, ref, GPConfig, dev) -> float:
    """The fused GP program against ref.gp_fit_forecast on the card, for
    both kinds, on gp_batch's rows, and on a batch where every factor with
    a valid row is not positive definite (jitter -5); returns the largest
    absolute error of the forecasts over rows both give finite."""
    import torch
    from repro_torch.core.forecast import gp as G
    worst = 0.0
    for kind, over in (("exp", {}), ("rbf", {}), ("exp", dict(jitter=-5.0, opt_steps=3))):
        cfg, w, v, args, mu, sd = gp_batch(GPConfig, dev, kind, **over)
        n0 = gp_forecast.gp_fit_forecast.launches
        got = gp_forecast.gp_fit_forecast(*args, 3, cfg)
        torch.cuda.synchronize()
        assert gp_forecast.gp_fit_forecast.launches == n0 + 1
        want = ref.gp_fit_forecast(*args, 3, cfg)
        assert all(g.shape == r.shape for g, r in zip(got, want))
        wt, vt = torch.as_tensor(w, device=dev), torch.as_tensor(v, device=dev)
        fg = G.finish(got[0], got[1], wt, vt, mu, sd, cfg)
        fc = G.finish(want[0], want[1], wt, vt, mu, sd, cfg)
        mg, vg, mc, vc = (t.cpu().numpy() for t in (fg.mean, fg.var, fc.mean, fc.var))
        what = f"gp_fit_forecast {kind}{' jitter -5' if over else ''}"
        assert_gp_close(mg, vg, mc, vc, w, v.sum(1), what)
        fin = np.isfinite(mc)
        err = float(np.abs(mg - mc)[fin].max()) if fin.any() else 0.0
        worst = max(worst, err)
        pad = got[0][513:], got[1][513:]
        assert all(torch.isfinite(t).all() for t in pad), pad
        lp_err = (got[2] - want[2]).abs()
        log(f"  {what}: {len(w)} rows within tolerance ({int(np.isnan(mc).any(1).sum())} "
            f"NaN in both), max abs forecast err {err:.3g}; log-params max abs diff "
            f"{lp_err.max().item():.3g}, median {lp_err.median().item():.3g}; padded rows "
            f"finite (mean max abs diff {(got[0][513:] - want[0][513:]).abs().max().item():.3g})")
    worst = max(worst, check_gp_ready(gp_forecast, ref, GPConfig, dev))
    return worst


def app_mask(n_ready, seed, A=128, C=12):
    """(A*C,) bool ready rows as the device engine's table holds them: the
    leading components of whole app slots (row a*C + c), slots drawn in a
    seeded order, until ``n_ready`` rows are marked."""
    rng = np.random.default_rng(seed)
    mask = np.zeros(A * C, bool)
    for a in rng.permutation(A):
        k = min(int(rng.integers(1, C + 1)), n_ready - int(mask.sum()))
        if k <= 0:
            break
        mask[a * C:a * C + k] = True
    return mask


def gp_mask_err(gp_forecast, ref, cfg, args, w, v, mu, sd, ready, what, full=None) -> float:
    """The fused GP program with the ready mask ``ready`` (a bool tensor on
    the card) against its plain version given the same mask: one launch;
    the unmarked series zeros on both sides; the marked ones by check_gp's
    tolerances after G.finish, and, where ``full`` (the kernel's outputs
    without a mask) is given, equal to it bit for bit (a warp computes
    its series alone).  Returns the largest absolute forecast error."""
    import torch
    from repro_torch.core.forecast import gp as G
    n0 = gp_forecast.gp_fit_forecast.launches
    got = gp_forecast.gp_fit_forecast(*args, 3, cfg, ready)
    torch.cuda.synchronize()
    assert gp_forecast.gp_fit_forecast.launches == n0 + 1
    want = ref.gp_fit_forecast(*args, 3, cfg, ready)
    for g, p in zip(got, want):
        assert not g[~ready].any() and not p[~ready].any(), what
    if full is not None:
        for g, f in zip(got, full):
            assert torch.equal(g[ready].view(torch.int32), f[ready].view(torch.int32)), what
    rows = ready.nonzero()[:, 0].cpu().numpy()
    if not rows.size:
        return 0.0
    wt, vt = torch.as_tensor(w, device=ready.device), torch.as_tensor(v, device=ready.device)
    fg = G.finish(got[0], got[1], wt, vt, mu, sd, cfg)
    fc = G.finish(want[0], want[1], wt, vt, mu, sd, cfg)
    mg, vg, mc, vc = (t.cpu().numpy()[rows] for t in (fg.mean, fg.var, fc.mean, fc.var))
    assert_gp_close(mg, vg, mc, vc, w[rows], v[rows].sum(1), what)
    fin = np.isfinite(mc)
    return float(np.abs(mg - mc)[fin].max()) if fin.any() else 0.0


def main_path_gp(GPConfig, dev):
    """The GP program's inputs at the device engine's shape: 2 x A x C =
    3,072 seeded windows of one member (its CPU rows, then its MEM rows).
    Returns (cfg, windows, valid, the kernel's inputs, mu, sd)."""
    import torch
    from repro_torch.core.forecast import gp as G
    cfg = GPConfig(**GP_CFG)
    w, v = seeded_windows(n=3072, seed=1)
    X, y, rv, hist, mu, sd = G.fit_inputs(torch.as_tensor(w, device=dev),
                                          torch.as_tensor(v, device=dev), cfg)
    return cfg, w, v, [t.contiguous() for t in (X, y, rv, hist)] + [w.shape[1]], mu, sd


def check_gp_ready(gp_forecast, ref, GPConfig, dev) -> float:
    """The fused GP program with a ready mask in device memory, as the
    device engine launches it: gp_batch's 528 rows as a cohort of three
    176-row members, none, some and all ready per member; then the
    engine's own shape, 3,072 rows of one member with the leading
    components of whole app slots ready (app_mask, the same rows of
    both resources).  Marked series equal the kernel without a mask bit
    for bit, the others are zeros, and the plain version with the same
    mask agrees by check_gp's tolerances.  Returns the largest absolute
    forecast error against it."""
    import torch
    rng = np.random.default_rng(7)
    cfg, w, v, args, mu, sd = gp_batch(GPConfig, dev)
    full = gp_forecast.gp_fit_forecast(*args, 3, cfg)
    members = {"none": np.zeros(528, bool), "all": np.ones(528, bool),
               "some": np.concatenate([rng.random(176) < 0.3, np.zeros(176, bool),
                                       np.ones(176, bool)])}
    worst = 0.0
    for what, mask in members.items():
        ready = torch.as_tensor(mask, device=dev)
        worst = max(worst, gp_mask_err(gp_forecast, ref, cfg, args, w, v, mu, sd, ready,
                                       f"ready mask {what}", full))
    cfg, w, v, args, mu, sd = main_path_gp(GPConfig, dev)
    full = gp_forecast.gp_fit_forecast(*args, 3, cfg)
    half = app_mask(73, seed=3)
    ready = torch.as_tensor(np.concatenate([half, half]), device=dev)
    err = gp_mask_err(gp_forecast, ref, cfg, args, w, v, mu, sd, ready,
                      "ready mask, 3,072 rows", full)
    log(f"  gp_fit_forecast with a ready mask (528 rows as 3 x 176; none, some, all): "
        f"marked series == the kernel without a mask bit for bit, the rest zeros; "
        f"against the plain version with the same mask max abs err {worst:.3g}; "
        f"3,072 rows, {int(ready.sum())} ready (whole app slots): the same, max abs "
        f"err {err:.3g}")
    return max(worst, err)


def check_small_runs(run_sim, SimConfig, ClusterConfig, WorkloadConfig) -> None:
    """The engine on the card against itself on the CPU at a small size:
    equal summaries without the GP (decisions are discrete and the
    safeguard is exact); with the GP, the same completions and turnaround
    within 1% (fp32 conditioning, as in tests/test_torch_engine.py)."""
    base = SimConfig(
        cluster=ClusterConfig(n_hosts=4, max_running_apps=48),
        workload=WorkloadConfig(n_apps=64, max_components=8, max_runtime=1800.0,
                                mean_burst_gap=2.0, mean_long_gap=40.0, seed=0),
        max_ticks=20_000)
    for fc in ("persist", "oracle", "gp"):
        cfg = dataclasses.replace(base, forecaster=fc)
        a = run_sim(cfg, device="cuda").summary()
        b = run_sim(cfg, device="cpu").summary()
        if fc == "gp":
            assert a["completed"] == b["completed"], (a, b)
            assert abs(a["turnaround_mean"] / b["turnaround_mean"] - 1) < 1e-2, (a, b)
        else:
            assert a == b, (fc, a, b)
        log(f"  small run {fc}: cuda agrees with cpu "
            f"(completed {a['completed']}, turnaround_mean {a['turnaround_mean']:.6g} "
            f"vs {b['turnaround_mean']:.6g})")


# (B, M, N, D) of the Gram pair's timings: the device engine's K(X, X) at
# LONG_GP's width, a horizon step's cross-Gram there, a host-engine bucket,
# and the fused program's old main-path shape
GRAM_TIMED = ((3072, 128, 128, 41), (3072, 1, 128, 41), (256, 128, 128, 41), (512, 10, 10, 11))


def gram_bound(B, M, N, D, same=False) -> dict:
    """The least time the card could take for the Gram pair at (B, M, N,
    D): inputs read once, outputs written once, over 3.35 TB/s, against
    the operations over fp32's peak.  ``same``: xa is xb (K(X, X), M ==
    N), so X is read once and only the entries on and above the diagonal
    need computing (the rest are their mirror images).  Returns each
    kernel's bound, what bounds it, its bytes and its operations."""
    pairs = B * M * N
    work = B * N * (N + 1) // 2 if same else pairs    # entries computed
    rows = B * N if same else B * (M + N)             # rows read, norms summed
    # |a|^2, |b|^2, a.b: 2 flops per term; then d2, sqrt, divide, exp, scale
    fwd_flops = 2 * D * (work + rows) + 8 * work
    fwd_bytes = 4 * (rows * D + 2 * B + pairs)
    bwd_flops = fwd_flops + 6 * work
    bwd_bytes = 4 * (pairs + rows * D + 2 * B + 2 * B)
    out = {}
    for name, flops, nbytes in (("gp_gram_fwd", fwd_flops, fwd_bytes),
                                ("gp_gram_bwd", bwd_flops, bwd_bytes)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        out[name] = dict(bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops)
    return out


def time_kernels(gp_gram, ref, dev, others=()) -> dict:
    """Kernel and plain-version times at each shape of GRAM_TIMED (K(X, X)
    as the Gram route passes it: xa the same tensor as xb), each beside its
    bound (gram_bound: for K(X, X), X read once and the upper triangle).
    ``others`` are (label, module) pairs of other packages' Gram modules,
    timed in turns with this one on the same inputs: plain, kernel, the
    others, the others, kernel, plain.  A
    kernel's time is device time a launch (graph_us: 50 launches in a CUDA
    graph, replayed); the plain version's CUDA events over a few calls.
    Returns the device engine's shape's numbers by kernel name (ms), the
    others' under "label:name", and every shape's under "name@B,M,N,D"."""
    out = {}
    for B, M, N, D in GRAM_TIMED:
        xa, xb, ell, sf, g = inputs(B, M, N, D, dev, same=M == N, seed=99)
        bound = gram_bound(B, M, N, D, same=M == N)
        for name in ("gp_gram_fwd", "gp_gram_bwd"):
            def call(mod, name=name):
                if name == "gp_gram_fwd":
                    return lambda: mod.gram_fwd(xa, xb, ell, sf, "exp")
                return lambda: mod.gram_bwd(g, xa, xb, ell, sf, "exp")
            plain = (lambda: ref.gram(xa, xb, ell, sf, "exp")) if name == "gp_gram_fwd" \
                else (lambda: ref.gram_bwd(g, xa, xb, ell, sf, "exp"))
            p1 = cuda_time_ms(plain, iters=3, warmup=1)
            k1 = graph_us(call(gp_gram)) / 1e3
            o1 = [graph_us(call(m)) / 1e3 for _, m in others]
            o2 = [graph_us(call(m)) / 1e3 for _, m in others]
            k2 = graph_us(call(gp_gram)) / 1e3
            p2 = cuda_time_ms(plain, iters=3, warmup=1)
            b = bound[name]
            shape = (B, M, N, D)
            row = dict(ms=min(k1, k2), plain_ms=min(p1, p2), **b)
            out[f"{name}@{','.join(map(str, shape))}"] = row
            if shape == GRAM_TIMED[0]:
                out[name] = row
            for (label, _), a, c in zip(others, o1, o2):
                out[f"{label}:{name}@{','.join(map(str, shape))}"] = dict(ms=min(a, c), **b)
            log(f"  {name} {shape}: kernel {k1 * 1e3:.3f}/{k2 * 1e3:.3f} us device"
                + "".join(f", {label} {a * 1e3:.3f}/{c * 1e3:.3f} us"
                          for (label, _), a, c in zip(others, o1, o2))
                + f", plain {p1:.5f}/{p2:.5f} ms, bound {b['bound_ms'] * 1e3:.3f} us "
                f"({b['bound_by']}: {b['bytes']} B, {b['flops']} flop; kernel at "
                f"{b['bound_ms'] / min(k1, k2):.1%} of it)")
    return out


# LONG_GP: the GP past the fused program's 64 patterns (the paper's largest
# h = 40, N = 128 patterns, windows of 168 = h + N samples), which takes the
# Gram route; everything else SimConfig()'s
LONG_GP = dict(history=40, max_patterns=128, opt_steps=10)
LONG_WINDOW = 168
LONG_TICKS = 240          # cap on phase 5l's runs


def long_gp(SimConfig, GPConfig, **over):
    return SimConfig(window=LONG_WINDOW, gp=GPConfig(**LONG_GP), **over)


# device kernels of the cuSOLVER and cuBLAS calls (Cholesky, triangular
# solves, products), by name
LIBRARY_KERNELS = re.compile(r"potrf|trsm|gemm|gemv|xmma|syrk|cublas|cusolver|"
                             r"offsetPointerArray|trsv")


def gram_route_split(step, ticks, warm=True) -> dict:
    """``ticks`` ticks of the device engine at LONG_GP under torch.profiler
    (after a warm-up run of as many, which captures the chunk's graph):
    device ms a tick split into the Gram forward, the Gram gradient, the
    cuSOLVER and cuBLAS kernels and the rest, with each group's share and the device's busy share of the
    wall."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.core.forecast import GPConfig
    from repro_torch.sim import SimConfig
    cfg = long_gp(SimConfig, GPConfig, max_ticks=ticks)
    if warm:
        step.run_sim_scan(cfg, device="cuda")
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t = time.perf_counter()
        step.run_sim_scan(cfg, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
    groups = dict.fromkeys(("gram forward", "gram gradient", "cuSOLVER/cuBLAS", "rest"), 0.0)
    for e in prof.key_averages():
        if e.device_type != DeviceType.CUDA or e.self_device_time_total <= 0:
            continue
        name = ("gram forward" if "gram_fwd_" in e.key else
                "gram gradient" if "gram_bwd_" in e.key or "gram_tile_sums" in e.key else
                "cuSOLVER/cuBLAS" if LIBRARY_KERNELS.search(e.key) else "rest")
        groups[name] += e.self_device_time_total
    busy = sum(groups.values())
    return {"ms_per_tick": {k: round(v / 1e3 / ticks, 4) for k, v in groups.items()},
            "share": {k: round(v / max(busy, 1e-9), 4) for k, v in groups.items()},
            "busy": round(busy / 1e6 / wall, 4), "wall_ms_per_tick": round(wall / ticks * 1e3, 3)}


LONG_MEAN_SD = 1e-3   # phase 5l: a mean beyond rtol 1e-3 passes within 1e-3 of its sd
LONG_TILED_ROWS = (1024, 2048, 3072)   # 5l (a): batches a row's bits must not depend on
LONG_CPU_TICKS = 48   # the host engine's run at LONG_GP held card against CPU


def long_windows(n=512, seed=0):
    """Monitor windows of LONG_WINDOW samples as seeded_windows makes them
    (random walks around a level, some flat, clipped at 0), with 41 (h + 1,
    the GP's first counting forecast) to LONG_WINDOW valid."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(0.1, 8.0, (n, 1))
    walk = level * (1 + 0.08 * np.cumsum(rng.standard_normal((n, LONG_WINDOW)), 1))
    flat = rng.random(n) < 0.1
    walk[flat] = level[flat]
    w = np.clip(walk, 0.0, None).astype(np.float32)
    count = rng.integers(LONG_GP["history"] + 1, LONG_WINDOW + 1, n)
    valid = np.arange(LONG_WINDOW)[None, :] >= (LONG_WINDOW - count)[:, None]
    return np.where(valid, w, 0).astype(np.float32), valid


def gram_launches(gp_gram, gp_forecast) -> dict:
    return {"gram_fwd": gp_gram.gram_fwd.launches, "gram_bwd": gp_gram.gram_bwd.launches,
            "gp_fit_forecast": gp_forecast.gp_fit_forecast.launches}


def check_long_forecast(GPForecaster, GPConfig, gp_gram, gp_forecast) -> None:
    """Phase 5l (a): forecast_batch at LONG_GP on the card, both kinds: 14
    Gram forward and 10 gradient launches a call (opt_steps + 1 + horizon,
    opt_steps), no fused-program launch; against the CPU by check_gp's
    tolerances at h = 40 (a mean beyond its rtol passes within
    LONG_MEAN_SD of the row's predictive sd: how many, printed); a ready
    mask (the route's unmarked rows zeros, its marked rows and the
    forecasts of the marked rows bit for bit the unmasked batch's); row 0
    alone bit for bit row 0 of the batch, and every row of the batch
    tiled to LONG_TILED_ROWS (up to the device engine's 3,072) bit for bit
    its row of the 512; a window whose factor is not positive definite NaN
    in its row alone."""
    import torch
    from repro_torch.core.forecast import gp as G
    w, v = long_windows()
    wt, vt = torch.as_tensor(w, device="cuda"), torch.as_tensor(v, device="cuda")
    steps, H = LONG_GP["opt_steps"], 3
    for kind in ("exp", "rbf"):
        cfg = GPConfig(kernel=kind, **LONG_GP)
        gp = GPForecaster(cfg)
        for m in (gp_gram, gp_forecast):
            m.reset_launch_counts()
        fc = gp.forecast_batch(wt, H, valid=vt, device="cuda")
        torch.cuda.synchronize()
        got = gram_launches(gp_gram, gp_forecast)
        assert got == {"gram_fwd": steps + 1 + H, "gram_bwd": steps, "gp_fit_forecast": 0}, got
        t = time.perf_counter()
        fcpu = gp.forecast_batch(w, H, valid=v, device="cpu")
        t_cpu = time.perf_counter() - t
        mg, vg = fc.mean.cpu().numpy(), fc.var.cpu().numpy()
        mc, vc = fcpu.mean.numpy(), fcpu.var.numpy()
        assert mg.shape == (512, H) and np.isfinite(mg).all() and np.isfinite(vg).all()
        by_sd = assert_gp_close(mg, vg, mc, vc, w, v.sum(1), f"LONG_GP {kind} card vs CPU",
                                h=LONG_GP["history"], mean_sd=LONG_MEAN_SD)
        rel = np.abs(mg - mc) / np.maximum(np.abs(mc), 1e-30)
        by = mean_sd_reading(mg, mc, vc, v.sum(1), LONG_GP["history"])
        log(f"  (a) {kind}: launches a call {got}; 512 rows card vs CPU within check_gp's "
            f"tolerances at h = 40 (max rel mean err {rel.max():.3g}; {by_sd} rows beyond "
            f"rtol 1e-3 on the mean and within {LONG_MEAN_SD} of their sd, the largest "
            f"{by:.3g} sd); cpu {t_cpu:.2f} s")
        if by_sd:
            log(f"  FINDING LONG_GP {kind}: {by_sd} of 512 means beyond check_gp's rtol 1e-3 "
                f"card vs CPU, each within {LONG_MEAN_SD} of its predictive sd")
    # the ready mask, row independence, a failed factor (exp)
    cfg = GPConfig(**LONG_GP)
    gp = GPForecaster(cfg)
    full = gp.forecast_batch(wt, H, valid=vt, device="cuda")
    ready = torch.as_tensor(np.random.default_rng(8).random(512) < 0.4, device="cuda")
    marked = gp.forecast_batch(wt, H, valid=vt, ready=ready, device="cuda")
    X, y, rv, hist, _, _ = G.fit_inputs(wt, vt, cfg)
    route = G.gram_fit_forecast(X, y, rv, hist, LONG_WINDOW, H, cfg)
    masked = G.gram_fit_forecast(X, y, rv, hist, LONG_WINDOW, H, cfg, ready)
    for a, b in zip(masked, route):
        assert torch.equal(a[ready].view(torch.int32), b[ready].view(torch.int32))
        assert not a[~ready].any()
    for a, b in ((marked.mean, full.mean), (marked.var, full.var)):
        assert torch.equal(a[ready].view(torch.int32), b[ready].view(torch.int32))
    one = gp.forecast_batch(wt[:1], H, valid=vt[:1], device="cuda")
    assert torch.equal(one.mean[0].view(torch.int32), full.mean[0].view(torch.int32))
    assert torch.equal(one.var[0].view(torch.int32), full.var[0].view(torch.int32))
    # the host engine's larger buckets and the device engine's batch: the
    # 512 windows tiled, each row bit for bit its row of the 512
    for rows in LONG_TILED_ROWS:
        tiled = gp.forecast_batch(wt.repeat(rows // 512, 1), H, valid=vt.repeat(rows // 512, 1),
                                  device="cuda")
        for a, b in ((tiled.mean, full.mean), (tiled.var, full.var)):
            assert torch.equal(a.view(-1, 512, H).view(torch.int32),
                               b.expand(rows // 512, 512, H).view(torch.int32)), rows
    bad = X.clone()
    bad[7, 20, 3] = float("nan")
    failed = G.gram_fit_forecast(bad, y, rv, hist, LONG_WINDOW, H, cfg)
    keep = torch.arange(512, device="cuda") != 7
    assert torch.isnan(failed[0][7]).all() and torch.isnan(failed[1][7]).all()
    for a, b in zip(failed, route):
        assert torch.equal(a[keep].view(torch.int32), b[keep].view(torch.int32))
    log(f"  (a) ready mask ({int(ready.sum())} of 512 marked): the route's unmarked rows "
        f"zeros, marked rows and forecasts bit for bit the unmasked batch's; row 0 alone == "
        f"row 0 of the batch bit for bit; the 512 tiled to {LONG_TILED_ROWS} rows: every row "
        f"bit for bit its row of the 512; a NaN pattern's row NaN, the other 511 unchanged")


def run_long_gp(step, SimConfig, GPConfig, GPForecaster, run_sim, gp_gram, gp_forecast,
                shaper, sched, fma) -> dict:
    """Phase 5l: the GP past the fused program's 64 patterns (LONG_GP: h =
    40, N = 128, windows of 168; SimConfig()'s cluster and workload), which
    takes the Gram route.  (a) check_long_forecast.  (b) The host engine
    capped at LONG_TICKS: ticks/s, the forecast's share of a tick, Gram
    launches against forecasting ticks x (14, 10); its first LONG_CPU_TICKS
    ticks card against CPU (equal, or the first difference printed as a
    FINDING, as phase 4c's GP run).  (c) The device engine capped at
    LONG_TICKS through graphs (every chunk sync-free), after a run that
    captures them: the census of the Gram launches against replays x the
    graphs' kernel nodes, ticks/s, peak memory, and the device time of
    GRAM_SPLIT_TICKS ticks split into the Gram pair, cuSOLVER/cuBLAS and the
    rest.  Counts are set to 0 just before each run and read just after.
    Returns the device engine's launches of the Gram pair."""
    import torch
    steps = {}
    t0 = time.perf_counter()
    check_long_forecast(GPForecaster, GPConfig, gp_gram, gp_forecast)
    steps["a"] = round(time.perf_counter() - t0, 1)

    # (b) the host engine
    t0 = time.perf_counter()
    cfg = long_gp(SimConfig, GPConfig, max_ticks=LONG_TICKS)
    calls = count_calls(GPForecaster, "forecast_batch")
    for m in (gp_gram, gp_forecast, shaper, sched, fma):
        m.reset_launch_counts()
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    res = run_sim(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = gram_launches(gp_gram, gp_forecast)
    fc_ticks = calls.stop()
    tm = res.timings
    ticks = tm["ticks"]
    per = LONG_GP["opt_steps"] + 1 + 3, LONG_GP["opt_steps"]
    log(f"  (b) run_sim(LONG_GP) capped at {LONG_TICKS} ticks: {ticks} ticks in "
        f"{tm['total']:.3f} s, {ticks / tm['total']:.3f} ticks/s; per tick forecast "
        f"{tm['forecast'] / ticks * 1e3:.3f} ms ({tm['forecast'] / tm['total']:.1%} of the "
        f"tick), policy {tm['policy'] / ticks * 1e3:.3f} ms; launches {launches} in {fc_ticks} "
        f"forecasting ticks; max memory allocated {torch.cuda.max_memory_allocated()} B; "
        f"summary {json.dumps(res.summary())}")
    assert ticks == LONG_TICKS and fc_ticks > 0, (ticks, fc_ticks)
    assert launches == {"gram_fwd": fc_ticks * per[0], "gram_bwd": fc_ticks * per[1],
                        "gp_fit_forecast": 0}, (launches, fc_ticks)
    card_vs_cpu(step, long_gp(SimConfig, GPConfig, max_ticks=LONG_CPU_TICKS),
                f"host engine, LONG_GP, first {LONG_CPU_TICKS} ticks", strict=False,
                engine=run_sim)
    steps["b"] = round(time.perf_counter() - t0, 1)

    # (c) the device engine
    t0 = time.perf_counter()
    guard = strict_chunks(step)
    try:
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        t = time.perf_counter()
        step.run_sim_scan(cfg, device="cuda")            # captures the chunk's graphs
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t
        peak_warm = torch.cuda.max_memory_allocated()
        entry = find_entry(step, cfg)
        torch.cuda.reset_peak_memory_stats()
        res, wall, scan, census = census_run(
            step, lambda: step.run_sim_scan(cfg, device="cuda"), cfg,
            cfg.cluster.max_running_apps, cfg.workload.max_components,
            (gp_gram, gp_forecast, shaper, sched, fma),
            lambda: gram_launches(gp_gram, gp_forecast))
        peak = torch.cuda.max_memory_allocated()
    finally:
        guard.stop()
    ticks = res.timings["ticks"]
    for line in describe_graphs(entry):
        log(f"  (c) graph {line}")
    log(f"  (c) run_sim_scan(LONG_GP) capped at {LONG_TICKS} ticks through graphs (the "
        f"warm-up run that captured them {t_warm:.3f} s, max memory allocated {peak_warm} B with "
        f"the graphs' pools; every chunk sync-free): {ticks} ticks in {wall:.3f} s, "
        f"{ticks / wall:.3f} ticks/s; launches {scan} = replays x kernel nodes {census}; max "
        f"memory allocated in the replayed run {peak} B; forecast rows {res.forecast_rows}; "
        f"summary {json.dumps(res.summary())}")
    assert ticks == LONG_TICKS, ticks
    assert scan == census and scan["gp_fit_forecast"] == 0, (scan, census)
    assert scan["gram_fwd"] == ticks * per[0] and scan["gram_bwd"] == ticks * per[1], scan
    split = gram_route_split(step, GRAM_SPLIT_TICKS, warm=False)
    log(f"  (c) device time of {GRAM_SPLIT_TICKS} ticks under torch.profiler: "
        f"{json.dumps(split)}")
    steps["c"] = round(time.perf_counter() - t0, 1)
    log(f"  phase 5l seconds by step: {json.dumps(steps)}")
    return {"gp_gram_fwd": scan["gram_fwd"], "gp_gram_bwd": scan["gram_bwd"]}


GRAM_SPLIT_TICKS = 32   # device-engine ticks of the Gram route's device-time split


def gp_flops(B, N, D, steps, H) -> int:
    """Operations the fused GP program's function needs for B series of N
    patterns of D features, counted for what it must compute, not as the
    kernel happens to compute it: each row's norm once and a dot product
    per unordered pair (K is symmetric); per factor (steps + 1 of them) the
    kernel values of the symmetric half and a Cholesky factor (N^3 / 3);
    per Adam step the two solves for alpha, L^-1 (N^3 / 3), the symmetric
    half of G = 0.5 (L^-T diag(m) L^-1 - alpha alpha^T) (N^3 / 3) and its
    three weighted sums, and the Adam update of three parameters; per
    horizon step the query's norm and kernel row, the mean, a solve and the
    variance."""
    half = N * (N + 1) // 2
    dist = 2 * N * D + half * (2 * D + 4)
    fact = 4 * half + N + N ** 3 // 3
    grad = 2 * N * N + 2 * (N ** 3 // 3) + half + 6 * half + 3 * 12
    horizon = 2 * D + 2 * N * D + 4 * N + 2 * N + N * N + 2 * N
    return B * (dist + (steps + 1) * fact + steps * grad + H * horizon)


def time_gp_kernel(gp_forecast, ref, GPConfig, dev, ready) -> tuple[dict, float]:
    """The fused GP program against its plain version on the card, in
    turns, with its device time per launch and its bound: inputs read
    once and outputs written once over 3.35 TB/s, against gp_flops over
    fp32's peak.  At B = 512 seeded windows (N = 10 patterns of D = 11,
    10 Adam steps, horizon 3), all of them run; at 2 x A x C = 3,072
    rows of one member, all of them run (the full batch's launch); and,
    where ``ready`` ((A*C,) bool, a member's ready rows) is given, as the
    device engine launches it on the main path: the 3,072 rows with
    those rows of both resources marked, the plain version given the
    same mask and held to the kernel (gp_mask_err), and the bound
    counting the rows that run (their inputs read, every output
    written).  Returns the last case's times and the mask's error."""
    import torch
    cfg, w, v, args, _, _ = gp_batch(GPConfig, dev)
    args = [a[:512] if hasattr(a, "shape") else a for a in args]
    X, y, rv, hist, T = args
    B, N, D = X.shape
    H = 3
    cfg, w2, v2, full, mu2, sd2 = main_path_gp(GPConfig, dev)
    full = full[:4]
    cases = [("B=512", B, B, (X, y, rv, hist), None),
             ("3072 rows, all run", 3072, 3072, full, None)]
    err = 0.0
    if ready is not None:
        mask = torch.as_tensor(np.concatenate([ready, ready]), device=dev)
        err = gp_mask_err(gp_forecast, ref, cfg, full + [T], w2, v2, mu2, sd2, mask,
                          "main path ready mask")
        cases.append((f"main path: 3072 rows with a ready mask "
                      f"(max abs err against the plain version {err:.3g})", 3072,
                      int(mask.sum()), full, mask))
    out = {}
    for what, B_all, n_run, a, mask in cases:
        extra = () if mask is None else (mask,)
        kern = lambda: gp_forecast.gp_fit_forecast(*a, T, H, cfg, *extra)  # noqa: E731
        plain = lambda: ref.gp_fit_forecast(*a, T, H, cfg, *extra)  # noqa: E731
        nbytes = (4 * n_run * (N * D + N + D - 1) + n_run * N + 4 * B_all * (2 * H + 3)
                  + B_all * len(extra))
        flops = gp_flops(n_run, N, D, cfg.opt_steps, H)
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        p1 = cuda_time_ms(plain, iters=10, warmup=2)
        k1, k2 = (cuda_time_ms(kern, iters=200, warmup=10) for _ in range(2))
        p2 = cuda_time_ms(plain, iters=10, warmup=2)
        dev_us = device_us_per_call(kern, "gp_forecast_kernel")
        host_us = host_us_per_call(kern)
        log(f"  gp_fit_forecast {what} ({n_run} series run, N={N} D={D}): kernel "
            f"{k1:.5f}/{k2:.5f} ms, plain {p1:.5f}/{p2:.5f} ms; device "
            f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} per launch "
            f"(torch.profiler), host {host_us:.3f} us per call; bound "
            f"{max(t_bytes, t_ops) * 1e3:.3f} us ({nbytes} B -> {t_bytes * 1e3:.3f} us, "
            f"{flops} flop -> {t_ops * 1e3:.3f} us)")
        out = {"gp_fit_forecast": dict(
            ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=max(t_bytes, t_ops),
            bound_by="bytes" if t_bytes >= t_ops else "operations")}
    return out, err


def gp_launches_per_batch(GPForecaster, GPConfig, forecast_peaks) -> tuple[int, int]:
    """Kernel launches of one forecast of the engine (forecast_peaks over
    512 seeded windows: the GP, the peak over the horizon and the copies
    back), counted by torch.profiler: (host launch calls, device kernels)."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    gp = GPForecaster(GPConfig(**GP_CFG))
    w, v = seeded_windows()
    dev = torch.device("cuda")
    forecast_peaks(gp, 3, w, v, dev)
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        forecast_peaks(gp, 3, w, v, dev)
        torch.cuda.synchronize()
    ka = prof.key_averages()
    host = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    kernels = sum(e.count for e in ka if e.device_type == DeviceType.CUDA
                  and "Memcpy" not in e.key and "Memset" not in e.key)
    return host, kernels


def flash_inputs(b, hq, hkv, s, t, d, dtype, dev, seed):
    """Seeded q (b,hq,s,d), k and v (b,hkv,t,d) on the card."""
    import torch
    rng = np.random.default_rng(seed)
    return [torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                            device=dev).to(getattr(torch, dtype))
            for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d))]


def check_flash(flash_attention, ref, dev) -> dict:
    """The flash kernels against the plain version on every shape of
    FLASH_SHAPES in fp32 and bf16, each call on the route that
    ``route`` names; returns the largest absolute error per route."""
    import torch
    worst = dict.fromkeys(flash_attention.ROUTES, 0.0)
    for dtype, tol in FLASH_TOL.items():
        for i, (b, hq, hkv, s, t, d, causal) in enumerate(FLASH_SHAPES):
            q, k, v = flash_inputs(b, hq, hkv, s, t, d, dtype, dev, seed=i)
            which = flash_attention.route(q.dtype, d)
            before = dict(flash_attention.flash_attention.route_launches)
            got = flash_attention.flash_attention(q, k, v, causal=causal)
            torch.cuda.synchronize()
            after = flash_attention.flash_attention.route_launches
            assert {r: after[r] - before[r] for r in after} == {
                r: int(r == which) for r in after}, (which, before, after)
            want = ref.attention(q, k, v, causal=causal)
            assert got.dtype == q.dtype and got.shape == q.shape
            torch.testing.assert_close(got.float(), want.float(), rtol=tol, atol=tol)
            e = (got.float() - want.float()).abs().max().item()
            worst[which] = max(worst[which], e)
            log(f"  flash {dtype} q{(b, hq, s, d)} kv{(hkv, t)} "
                f"{'causal' if causal else 'full'} [{which}]: max abs err {e:.3g} ok")
    return worst


def check_whisper_smoke(flash_attention) -> None:
    """Smoke-width Whisper (fp32, "flash"): the same parameters and inputs
    on the card and on the CPU give teacher-forced logits within
    tolerance, one kernel launch per decoder layer on the card, and equal
    greedy cached tokens."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models import whisper as W
    from repro_torch.serve import whisper_decode_step_fn
    cfg = dataclasses.replace(get_config(WHISPER, smoke=True), attn_impl="flash")
    cpu = W.init_whisper(cfg, generator=torch.Generator().manual_seed(0), device="cpu")
    gpu = tree_to(cpu, "cuda")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((2, 24, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, cfg.dec_len))
    out = {}
    for name, params, dev in (("cpu", cpu, "cpu"), ("cuda", gpu, "cuda")):
        enc = W.encode(params, torch.as_tensor(frames, device=dev), cfg)
        n0 = flash_attention.flash_attention.launches
        logits, _ = W.decode(params, torch.as_tensor(toks, device=dev), enc, cfg)
        launched = flash_attention.flash_attention.launches - n0
        assert launched == (cfg.dec_layers if dev == "cuda" else 0), launched
        caches = W.init_dec_caches(cfg, 2, cfg.dec_len, device=dev)
        tok = torch.zeros((2, 1), dtype=torch.long, device=dev)
        greedy = []
        for _ in range(SMOKE_GREEDY_STEPS):
            step_logits, caches = whisper_decode_step_fn(params, cfg, tok, enc, caches)
            tok = step_logits.argmax(-1)[:, None]
            greedy.append(tok[:, 0].tolist())
        out[name] = (logits.cpu(), greedy)
    torch.testing.assert_close(out["cuda"][0], out["cpu"][0],
                               rtol=WHISPER_RTOL, atol=WHISPER_ATOL)
    assert out["cuda"][1] == out["cpu"][1], (out["cuda"][1], out["cpu"][1])
    e = (out["cuda"][0] - out["cpu"][0]).abs().max().item()
    log(f"  teacher-forced logits {tuple(out['cpu'][0].shape)}: max abs err {e:.3g} "
        f"(rtol {WHISPER_RTOL}, atol {WHISPER_ATOL}); {cfg.dec_layers} kernel launches; "
        f"{SMOKE_GREEDY_STEPS} greedy cached tokens equal: {out['cpu'][1]}")


def tree_to(tree, dev):
    if isinstance(tree, dict):
        return {k: tree_to(v, dev) for k, v in tree.items()}
    if isinstance(tree, list):
        return [tree_to(v, dev) for v in tree]
    return tree.to(dev)


def run_whisper(flash_attention) -> int:
    """Whisper-large-v3 at full width on the card: REQUESTS requests of
    FRAMES frames through whisper_prefill_fn ("flash"), then DECODE_STEPS
    greedy cached steps.  Counts are set to 0 just before the prefill and
    read after the decode; returns the flash kernel's launches."""
    import torch
    from repro_torch.kernels import gp_gram
    from repro_torch.models import get_config
    from repro_torch.models import whisper as W
    from repro_torch.serve import whisper_decode_step_fn, whisper_prefill_fn
    cfg = dataclasses.replace(get_config(WHISPER), attn_impl="flash")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = W.init_whisper(cfg, generator=gen, device="cuda")
    frames = torch.randn((REQUESTS, FRAMES, cfg.d_model), generator=gen,
                         device="cuda").to(cfg.dtype)
    torch.cuda.synchronize()
    n_params = sum(t.numel() for t in tree_leaves(params))
    log(f"  {n_params} parameters ({cfg.dtype}) drawn on the card in "
        f"{time.perf_counter() - t0:.2f} s; {REQUESTS} requests x {FRAMES} frames, "
        f"dec_len {cfg.dec_len}, {DECODE_STEPS} greedy steps")

    def prefill():
        torch.cuda.synchronize()
        t = time.perf_counter()
        enc, last = whisper_prefill_fn(params, cfg, frames)
        torch.cuda.synchronize()
        return enc, last, time.perf_counter() - t

    prefill()   # warm-up: cuBLAS handles, allocator
    flash_attention.reset_launch_counts()
    gp_gram.reset_launch_counts()
    enc, last, t_prefill = prefill()
    n_prefill = flash_attention.flash_attention.launches
    caches = W.init_dec_caches(cfg, REQUESTS, cfg.dec_len, device="cuda")
    tok = last.argmax(-1)[:, None]
    tokens = []
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(DECODE_STEPS):
        logits, caches = whisper_decode_step_fn(params, cfg, tok, enc, caches)
        tok = logits.argmax(-1)[:, None]
        tokens.append(tok)
    torch.cuda.synchronize()
    t_decode = time.perf_counter() - t
    launches = flash_attention.flash_attention.launches
    routes = flash_attention.flash_attention.route_launches
    assert (gp_gram.gram_fwd.launches, gp_gram.gram_bwd.launches) == (0, 0)
    assert n_prefill == launches == cfg.dec_layers, (n_prefill, launches)
    assert routes == {"sm90": cfg.dec_layers, "simt": 0}, routes
    assert last.shape == (REQUESTS, cfg.vocab) and torch.isfinite(last).all()
    assert torch.isfinite(logits).all() and caches.length.tolist() == [DECODE_STEPS] * cfg.dec_layers
    peak = torch.cuda.max_memory_allocated()
    again = [prefill()[2] for _ in range(2)]
    log(f"  prefill: {t_prefill * 1e3:.3f} ms ({REQUESTS / t_prefill:.3f} requests/s); "
        f"two more: {again[0] * 1e3:.3f}, {again[1] * 1e3:.3f} ms; "
        f"{n_prefill} flash launches, all on the sm90 route")
    log(f"  decode: {DECODE_STEPS} steps in {t_decode * 1e3:.3f} ms "
        f"({t_decode / DECODE_STEPS * 1e3:.3f} ms/step, "
        f"{REQUESTS * DECODE_STEPS / t_decode:.3f} tokens/s); 0 flash launches")
    log(f"  greedy tokens of request 0: {[int(x[0]) for x in tokens]}")
    log(f"  max memory allocated {peak} B")

    # the same prefill with the plain masked attention in the decoder: the
    # two differ by bf16 rounding (the plain path rounds the softmax
    # weights to bf16 before P.V), which 32 bf16 layers carry on, so the
    # bf16 tolerance is held against the logits' scale
    _, last_ref = whisper_prefill_fn(params, dataclasses.replace(cfg, attn_impl="ref"),
                                     frames)
    a, b = last.float(), last_ref.float()
    diff = (a - b).abs()
    rel = (diff.norm() / b.norm()).item()
    log(f"  prefill logits flash vs ref: max abs {diff.max().item():.4g}, "
        f"max |logit| {b.abs().max().item():.4g}, relative L2 {rel:.4g}, "
        f"argmax equal {(a.argmax(-1) == b.argmax(-1)).float().mean().item():.4g}")
    tol = FLASH_TOL["bfloat16"]
    assert rel <= tol and diff.max().item() <= tol * b.abs().max().item(), (rel, diff.max())
    return launches


def run_whisper_fp32(flash_attention) -> int:
    """The same prefill at full width in fp32 (``dtype=torch.float32``),
    the path of the simt route: the decoder's self-attention takes the
    CUDA-core kernel, which keeps fp32 to 2e-5.  Counts are set to 0 just
    before the prefill and read after; returns the simt launches."""
    import torch
    from repro_torch.models import get_config
    from repro_torch.models import whisper as W
    from repro_torch.serve import whisper_prefill_fn
    cfg = dataclasses.replace(get_config(WHISPER), attn_impl="flash",
                              dtype=torch.float32)
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = W.init_whisper(cfg, generator=gen, device="cuda")
    frames = torch.randn((REQUESTS, FRAMES, cfg.d_model), generator=gen,
                         device="cuda")
    whisper_prefill_fn(params, cfg, frames)   # warm-up
    torch.cuda.synchronize()
    flash_attention.reset_launch_counts()
    t = time.perf_counter()
    _, last = whisper_prefill_fn(params, cfg, frames)
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    routes = flash_attention.flash_attention.route_launches
    assert routes == {"sm90": 0, "simt": cfg.dec_layers}, routes
    assert last.shape == (REQUESTS, cfg.vocab) and torch.isfinite(last).all()
    log(f"  fp32 prefill: {t * 1e3:.3f} ms; {routes['simt']} flash launches, all on "
        f"the simt route")
    return routes["simt"]


class count_calls:
    """Count calls of ``owner.name`` (or ``owner[name]`` for a dict) until
    ``stop()``, which restores it and returns the count."""

    def __init__(self, owner, name):
        self.owner, self.name, self.n = owner, name, 0
        self.orig = owner[name] if isinstance(owner, dict) else getattr(owner, name)

        def counted(*a, **k):
            self.n += 1
            return self.orig(*a, **k)
        self._set(counted)

    def _set(self, fn):
        if isinstance(self.owner, dict):
            self.owner[self.name] = fn
        else:
            setattr(self.owner, self.name, fn)

    def stop(self) -> int:
        self._set(self.orig)
        return self.n


def tree_leaves(tree):
    if isinstance(tree, dict):
        return [x for v in tree.values() for x in tree_leaves(v)]
    if isinstance(tree, list):
        return [x for v in tree for x in tree_leaves(v)]
    return [tree]


def device_us_per_call(fn, kernel: str = "", n: int = 20):
    """Device time per call of ``fn`` in the kernels whose names contain
    ``kernel`` (all of them by default), from torch.profiler over n
    calls; with ``kernel`` named, per launch of it (each timed call
    launches it once); None if the trace shows no such kernel."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        for _ in range(n):
            fn()
        torch.cuda.synchronize()
    hits = [e for e in prof.key_averages()
            if e.device_type == DeviceType.CUDA and kernel in e.key and e.count]
    if not hits:
        return None
    # per launch of the named kernel over the launches the trace holds (a
    # profiler run after others in one process may drop some of them)
    return sum(e.self_device_time_total for e in hits) / (
        sum(e.count for e in hits) if kernel else n)


def host_us_per_call(fn, n: int = 200) -> float:
    """Host time per call of ``fn`` (checks, ctypes, tensor maps, enqueue):
    the host clock over n calls that the card has not yet finished."""
    import torch
    torch.cuda.synchronize()
    t = time.perf_counter()
    for _ in range(n):
        fn()
    t = time.perf_counter() - t
    torch.cuda.synchronize()
    return t / n * 1e6


def time_flash(flash_attention, ref, dev) -> dict:
    """Both flash kernels at the Whisper decoder's shape, each on its own
    route: sm90 in bf16, simt in fp32; beside each, the plain version and
    F.scaled_dot_product_attention (the library yardstick, timed here
    only) in the same dtype, in turns, and in bf16 also the simt kernel
    that the sm90 one replaces there.  The bound: q, k, v read once and o
    written once over 3.35 TB/s, against 4 * B * H * D flops per causal
    (query, key) pair over the peak of the arithmetic the kernel does
    (bf16 tensor cores for sm90; fp32 CUDA cores for simt, no TF32)."""
    import torch.nn.functional as F
    b, hq, hkv, s, t, d, causal = FLASH_PATH_SHAPE
    pairs = sum(min(t, t - s + i + 1) for i in range(s)) if causal else s * t
    flops = 4 * b * hq * d * pairs
    out = {}
    for name, which, dtype, peak, kernel in (
            ("flash_attention", "sm90", "bfloat16", BF16_FLOP_PER_S,
             "flash_fwd_sm90_kernel"),
            ("flash_attention_simt", "simt", "float32", FP32_FLOP_PER_S,
             "flash_fwd_kernel")):
        q, k, v = flash_inputs(b, hq, hkv, s, t, d, dtype, dev, seed=7)
        assert flash_attention.route(q.dtype, d) == which
        nbytes = (2 * q.numel() + k.numel() + v.numel()) * q.element_size()
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / peak * 1e3
        kern = lambda: flash_attention.flash_attention(q, k, v, causal=causal)  # noqa: E731
        plain = lambda: ref.attention(q, k, v, causal=causal)  # noqa: E731
        lib = lambda: F.scaled_dot_product_attention(q, k, v, is_causal=causal)  # noqa: E731
        fns = {"plain": plain, "kernel": kern, "sdpa": lib}
        if which == "sm90":   # the parent's kernel on the same bf16 call
            shape = flash_attention._check(q, k, v, causal, t - s)
            fns["simt bf16"] = lambda: flash_attention._launch(  # noqa: E731
                "simt", q, k, v, shape, causal, None, t - s)
        order = list(fns) + list(fns)[::-1]
        ms = {key: [] for key in fns}
        for key in order:
            ms[key].append(cuda_time_ms(fns[key], iters=50, warmup=5))
        host_us = host_us_per_call(kern)
        dev_us = device_us_per_call(kern, kernel)
        lib_dev_us = device_us_per_call(lib)
        lib_err = (lib().float() - plain().float()).abs().max().item()
        times = "; ".join(f"{key} {'/'.join(f'{x:.5f}' for x in v)} ms"
                          for key, v in ms.items())
        log(f"  {name} {FLASH_PATH_SHAPE} {dtype}: {times}; device "
            f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} per launch, "
            f"sdpa {'not measured' if lib_dev_us is None else f'{lib_dev_us:.3f} us'} "
            f"per call (torch.profiler); host {host_us:.3f} us per call; sdpa max abs err vs "
            f"plain {lib_err:.3g}; bound {max(t_bytes, t_ops) * 1e3:.3f} us "
            f"({nbytes} B -> {t_bytes * 1e3:.3f} us, {flops} flop -> "
            f"{t_ops * 1e3:.3f} us)")
        out[name] = dict(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
                         library_ms=min(ms["sdpa"]), bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations")
    return out


# ----------------------------------------------------------------------
# a * b + c with one rounding (XLA:CPU's fused multiply-add)
# ----------------------------------------------------------------------

def fma_cases():
    """(name, a, b, c) as CPU tensors: the counterexample to two roundings
    ((1+2**-12)**2 + 2**-80), products on a float32 midpoint with c =
    +-2**-60 below them (only c says which way the one rounding goes),
    10^5 seeded normal-range triples whose sums cancel, the usage
    interpolation's shape (b broadcast over (1, 128, 12, 2)), the
    subnormal rows and 10^5 triples near +-2**-126 (what XLA:CPU flushes)
    and the safeguard's shape (a scalar b over 3,072 rows)."""
    import torch
    rng = np.random.default_rng(0)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x, np.float32))  # noqa: E731
    one = np.float32(1 + 2**-12)
    yield "counterexample", t([one]), t([one]), t([2.0**-80])
    k, m = np.meshgrid(np.arange(0, 2**11, 7), np.arange(1, 2**12, 5), indexing="ij")
    a = (1 + k.ravel() * 2.0**-11).astype(np.float32)
    b = (1 + m.ravel() * 2.0**-12).astype(np.float32)
    q = a.astype(np.float64) * b
    q = q * np.where(q < 2, 2.0**24, 2.0**23)
    mid = (q == np.floor(q)) & (q % 2 == 1)
    sign = np.where(np.arange(int(mid.sum())) % 2 == 0, 1.0, -1.0)
    yield "midpoints", t(a[mid]), t(b[mid]), t(sign * 2.0**-60)

    def draw(n, lo, hi):
        return (rng.choice([-1.0, 1.0], n) * rng.uniform(1, 2, n)
                * 2.0 ** rng.integers(lo, hi, n)).astype(np.float32)
    a, b = draw(100_000, -8, 8), draw(100_000, -8, 8)
    yield "random", t(a), t(b), t(draw(100_000, -40, 4) * np.abs(a) * np.abs(b))
    lv = rng.uniform(0, 8, (2, 1, 128, 12, 2)).astype(np.float32)
    yield "usage interpolation", t(lv[1] - lv[0]), t(rng.random((1, 128, 1, 1))), t(lv[0])
    yield "subnormal rows", *(t(x) for x in zip(*SUBNORMAL_ROWS))
    yield "near 2**-126", *(t(x) for x in tiny_triples())
    yield "safeguard", t(rng.uniform(0.01, 64, (1, 3072))), 0.05, t(rng.uniform(0, 2, (1, 3072)))


TINY = 2.0**-126   # the least normal float32
# (a, b, c) where XLA:CPU's flushing shows (tests/test_torch_step.py holds
# ops.fma_f32 to XLA on them): subnormal products flushed to +0 and -0,
# 2**-126 - 2**-150 flushed, a subnormal c read as 0, a subnormal product
# inside a normal result kept, and exact values (2**25 - k) * 2**-151 for
# k = 1 (a tie that rounds up to 2**-126: kept), 3 and 2 (flushed), -1
# (kept, negative)
SUBNORMAL_ROWS = ((2.0**-70, 1.5 * 2.0**-70, 0.0), (-2.0**-70, 1.5 * 2.0**-70, 0.0),
                  (1 - 2.0**-24, TINY, 0.0), (TINY, 1.0, -2.0**-127),
                  (2.0**-100, 2.0**-30, TINY),
                  (18631 * 2.0**-75, 1801 * 2.0**-76, 0.0),
                  (479 * 2.0**-75, 70051 * 2.0**-76, 0.0),
                  (8190 * 2.0**-75, 4097 * 2.0**-76, 0.0),
                  (8283 * 2.0**-75, -4051 * 2.0**-76, 0.0))


def tiny_triples(n=100_000, seed=0):
    """Seeded float32 triples whose exact a * b + c lies within a few ulp
    of +-2**-126, both signs: b from 16 values (one of them subnormal, so
    that Eq. 9's beta can take it as its scalar k1), c from a set of
    zeros, normals near 2**-126 and subnormals (each with at most 12
    significant bits, so that beta's dynamic term can carry it exactly),
    a = (target - c) / b rounded to float32; 5% of the a replaced by
    subnormals."""
    rng = np.random.default_rng(seed)
    ks = (rng.uniform(1, 2, 16) * 2.0 ** rng.integers(-24, 4, 16)).astype(np.float32)
    ks[:2] = 1.0, 3 * 2.0**-140
    b = ks[rng.integers(0, len(ks), n)]
    mags = np.array([0.0, TINY, 2 * TINY, 3 * TINY, 5 * 2.0**-125, 2.0**-149,
                     3 * 2.0**-149, 1023 * 2.0**-149, 2047 * 2.0**-138])
    c = (rng.choice([-1.0, 1.0], n) * rng.choice(mags, n)).astype(np.float32)
    target = rng.choice([-1.0, 1.0], n) * TINY * (1 + rng.integers(-6, 7, n) * 2.0**-23)
    a = ((target - c.astype(np.float64)) / b.astype(np.float64)).astype(np.float32)
    sub = rng.random(n) < 0.05
    a[sub] = (rng.choice([-1.0, 1.0], sub.sum()) * rng.integers(1, 2**23, sub.sum())
              * 2.0**-149).astype(np.float32)
    return a, b, c


def fma_variants(name, a, b, c):
    """(name, a, b, c, shift): each case as given and, where it is
    one-dimensional, from its second element on (on the card a view 4
    bytes into the upload: pointers off 16 bytes) and with its first b
    as a scalar (the other template instance)."""
    import torch
    yield name, a, b, c, 0
    if a.dim() == 1 and a.numel() > 1:
        yield f"{name}, off 16 B", a, b, c, 1
    if isinstance(b, torch.Tensor):
        yield f"{name}, scalar b", a, float(b.reshape(-1)[0]), c, 0


def check_fma(fma, ref) -> float:
    """The fma kernel on the card against its plain version on the CPU:
    every bit equal, signs of zeros included, on every case of
    fma_cases and its variants (both template instances, aligned and
    unaligned pointers)."""
    import torch
    for case in fma_cases():
        for name, a, b, c, shift in fma_variants(*case):
            cut = [x[shift:] if isinstance(x, torch.Tensor) else x for x in (a, b, c)]
            on_card = [x.cuda()[shift:] if isinstance(x, torch.Tensor) else x
                       for x in (a, b, c)]
            got = fma.fma_f32(*on_card)
            torch.cuda.synchronize()
            want = ref.fma_f32(*cut)
            if not torch.equal(got.cpu().view(torch.int32), want.view(torch.int32)):
                bad = (got.cpu() != want).nonzero()[:5].tolist()
                raise AssertionError(f"fma_f32 {name}: kernel differs from plain at {bad}")
            log(f"  fma_f32 {name} {tuple(want.shape)}: kernel == plain, bit for bit")
    return 0.0


def time_fma(fma, ref) -> dict:
    """The fma kernel at the safeguard's shape (3,072 rows, a scalar b),
    in turns with its plain version on the card and torch.add(c, a,
    alpha=b) (one PyTorch call computing c + b * a, the library yardstick,
    timed here only), with the device time per call of both (the kernels
    compared, not their wrappers) and the kernel's host time per call.
    The bound:
    a and c read and the output written once over 3.35 TB/s, against two
    flops per element over fp32's peak."""
    import torch
    *_, (_, a, b, c) = fma_cases()
    a, c = a.cuda(), c.cuda()
    kern = lambda: fma.fma_f32(a, b, c)  # noqa: E731
    plain = lambda: ref.fma_f32(a, b, c)  # noqa: E731
    lib = lambda: torch.add(c, a, alpha=float(np.float32(b)))  # noqa: E731
    fns = {"kernel": kern, "plain": plain, "torch.add": lib}
    ms = {k: [] for k in fns}
    for k in list(fns) + list(fns)[::-1]:
        ms[k].append(cuda_time_ms(fns[k], iters=200, warmup=10))
    dev_us = device_us_per_call(kern, "fma_f32")
    lib_dev_us = device_us_per_call(lib)
    host_us = host_us_per_call(kern)
    same = torch.equal(lib().view(torch.int32), kern().view(torch.int32))
    n = a.numel()
    nbytes, flops = 3 * 4 * n, 2 * n
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = flops / FP32_FLOP_PER_S * 1e3
    times = "; ".join(f"{k} {'/'.join(f'{x:.5f}' for x in v)} ms" for k, v in ms.items())
    log(f"  fma_f32 (1, {n}), scalar b: {times}; device "
        f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} per launch, "
        f"torch.add {'not measured' if lib_dev_us is None else f'{lib_dev_us:.3f} us'} "
        f"per call (torch.profiler); host {host_us:.3f} us per call; torch.add's bits "
        f"{'equal' if same else 'differ'}; "
        f"bound {max(t_bytes, t_ops) * 1e3:.4f} us ({nbytes} B, {flops} flop)")
    return {"fma_f32": dict(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
                            library_ms=min(ms["torch.add"]), bound_ms=max(t_bytes, t_ops),
                            bound_by="bytes" if t_bytes >= t_ops else "operations")}


# ----------------------------------------------------------------------
# the device engine (run_sim_scan) and its kernels
# ----------------------------------------------------------------------

SCAN_KERNELS = ("pessimistic_pass", "resolve_oom", "admit_queued", "place_missing_elastic")
SCAN_REPLACES = {"pessimistic_pass": "src/repro/core/shaper/pessimistic.py:117",
                 "resolve_oom": "src/repro/sim/step.py:472",
                 "admit_queued": "src/repro/sim/step.py:554",
                 "place_missing_elastic": "src/repro/sim/step.py:670"}
SCAN_SOURCES = {"pessimistic_pass": "src/repro_torch/kernels/csrc/shaper.cu",
                **{k: "src/repro_torch/kernels/csrc/sched.cu" for k in SCAN_KERNELS[1:]}}
CAPTURE_TICKS = range(40, 400, 40)
TICK_200 = CAPTURE_TICKS.index(200)   # the pessimistic tick-200 state's case
OOM_HOST_MEM = 16.0        # GB per host where resolve_oom is timed with victims


def scan_kernel_pairs(shaper, sched, ref) -> dict:
    """Each device-engine kernel's wrapper and its plain version, by name."""
    return {name: (getattr(shaper if name == "pessimistic_pass" else sched, name),
                   getattr(ref, name)) for name in SCAN_KERNELS}


def capture_states(step, SimConfig, policy):
    """The port's own device engine on the CPU at full width (SimConfig(),
    oracle forecasts), tick by tick; returns (trace, state, host_cap) at
    CAPTURE_TICKS, and the arguments of the tick's own call of
    admit_queued and of place_missing_elastic that held the most events
    (admissions, placed components) over those ticks: a state at the
    start of a tick has nothing to admit or re-place, since each tick
    admits its arrivals and re-places what its policy killed.  Under the
    optimistic policy hosts are over-committed, so the OOM handler finds
    victims."""
    import torch
    from repro_torch.kernels import ops, ref
    from repro_torch.sim.scenarios.registry import build_trace
    from repro_torch.sim.state import DeviceTrace, init_state
    cfg = SimConfig(forecaster="oracle", policy=policy)
    wl = build_trace(cfg.workload)
    tr = DeviceTrace.from_traces([wl], "cpu")
    st = init_state(cfg, wl.n_apps, wl.max_components, 1, "cpu")
    cap = step.host_capacity(cfg, "cpu")
    out, busiest = [], {}

    def recording(name):
        def call(*args):
            res = getattr(ref, name)(*args)
            n = scan_events(name, args, res)
            if n > busiest.get(name, (0,))[0]:
                busiest[name] = (n, args)
            return res
        return call
    saved = {name: getattr(ops, name) for name in ("admit_queued", "place_missing_elastic")}
    try:
        for name in saved:
            setattr(ops, name, recording(name))
        with torch.no_grad():
            for k in range(max(CAPTURE_TICKS) + 1):
                if k in CAPTURE_TICKS:
                    out.append((cfg, tr, st, cap))
                st, _ = step.fused_tick(cfg, None, tr, st, cap)
    finally:
        for name, fn in saved.items():
            setattr(ops, name, fn)
    return out, {name: args for name, (_, args) in busiest.items()}


def random_tables(seed, S=3, A=16, C=4, N=24, H=3):
    """Seeded slot tables for the scheduler kernels (numpy, then CPU
    tensors), S members, values from small sets so that hosts tie on free
    memory, apps on submit time and components on memory overage."""
    import torch
    rng = np.random.default_rng(seed)
    idx = np.arange(C)
    n_comp = rng.integers(1, C + 1, (S, N))
    exists = idx < n_comp[..., None]
    is_core = idx < np.minimum(rng.integers(1, 3, (S, N)), n_comp)[..., None]
    cpu_req = np.where(exists, rng.choice([0.5, 1.0, 2.0], (S, N, C)), 0).astype(np.float32)
    mem_req = np.where(exists, rng.choice([2.0, 4.0, 6.0], (S, N, C)), 0).astype(np.float32)
    slot_gid = np.full((S, A), -1, np.int32)
    queued = np.zeros((S, N), bool)
    for s in range(S):
        apps = rng.permutation(N)
        n = rng.integers(A // 2, A + 1)
        slot_gid[s, rng.choice(A, n, replace=False)] = apps[:n]
        queued[s, apps[n:]] = rng.random(N - n) < 0.8
    g = np.maximum(slot_gid, 0)
    take = lambda x: np.take_along_axis(x, g[..., None], 1)  # noqa: E731
    run = ((slot_gid >= 0)[..., None] & take(exists)
           & (take(is_core) | (rng.random((S, A, C)) < 0.6)))
    alloc = (np.stack([take(cpu_req), take(mem_req)], -1) * run[..., None]
             * rng.choice([0.5, 1.0], (S, A, C, 1))).astype(np.float32)
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))  # noqa: E731
    return dict(
        submit=t(np.sort(rng.integers(0, 6, (S, N)) * 10.0, 1).astype(np.float32)),
        gid=t(np.tile(np.arange(N, dtype=np.int32), (S, 1))), cpu_req=t(cpu_req),
        mem_req=t(mem_req), exists=t(exists), is_core=t(is_core), slot_gid=t(slot_gid),
        work_done=t(rng.uniform(0, 300, (S, A)).astype(np.float32)), comp_running=t(run),
        comp_host=t(np.where(run, rng.integers(0, H, (S, A, C)), 0).astype(np.int32)),
        alloc=t(alloc), usage=t((alloc * rng.choice([1.0, 1.5, 2.0], (S, A, C, 1)))
                                .astype(np.float32)),
        alive_since=t((60.0 * rng.integers(0, 3, (S, A, C))).astype(np.float32)),
        queued=t(queued), failed=t(np.zeros((S, N), bool)),
        has_saved=t(rng.random((S, N)) < 0.5),
        saved_work=t(rng.uniform(0, 300, (S, N)).astype(np.float32)),
        t=t(np.full(S, 300.0, np.float32)),
        counters=[t(np.zeros(S, np.int32)) for _ in range(3)],
        host_cap=t(np.tile(np.float32([[rng.choice([6.0, 8.0]), rng.choice([16.0, 24.0])]]),
                           (H, 1))))


EDGE_KINDS = ("admissions", "gid ties", "missing elastics")


def edge_member(kind, seed, A=13, C=7, N=37, H=4):
    """One member's scheduler state (numpy) built for an edge case of
    admission or elastic re-placement, A * C = 91 and N = 37 off the
    16-byte vectors, hosts of (8 cpu, 24 GB), apps' gid a permutation of
    their rows (tests/test_torch_sched.py holds the plain versions to the
    reference on them):

      "admissions"        3 running apps, 10 empty slots; the FIFO
                          queue's 2nd head has an elastic component of
                          30 GB (it cannot fit: the app is admitted
                          without it), its 5th a core component of 40 GB
                          (FIFO stops there, with apps queued behind it);
      "gid ties"          2 empty slots and 10 queued apps, all submitted
                          at once: the two of least gid are admitted;
      "missing elastics"  13 running apps with most elastic components
                          not running, each asking 4 GB: the walk fills
                          the hosts part-way and places no more."""
    rng = np.random.default_rng([seed, EDGE_KINDS.index(kind)])
    idx = np.arange(C)
    n_comp = rng.integers(3, C + 1, N)
    exists = idx < n_comp[:, None]
    is_core = idx < rng.integers(1, 3, N)[:, None]
    cpu_req = np.where(exists, rng.choice([0.25, 0.5], (N, C)), 0).astype(np.float32)
    mem_req = np.where(exists, rng.choice([1.0, 2.0], (N, C)), 0).astype(np.float32)
    gid = rng.permutation(N).astype(np.int32)
    submit = np.sort(rng.integers(0, 4, N) * 10.0).astype(np.float32)
    apps = rng.permutation(N)
    queued = np.zeros(N, bool)
    p_elastic = 0.8
    if kind == "admissions":
        running, q = apps[:3], apps[3:]
        fifo = q[np.lexsort((gid[q], submit[q]))]
        mem_req[fifo[1], n_comp[fifo[1]] - 1] = 30.0
        mem_req[fifo[4], 0] = 40.0
    elif kind == "gid ties":
        running, q = apps[:A - 2], apps[A - 2:A + 8]
        submit[q] = 20.0
    else:
        running, q = apps[:A], apps[:0]
        p_elastic = 0.3
        mem_req = np.where(is_core, mem_req, 4.0 * exists).astype(np.float32)
    queued[q] = True
    slot_gid = np.full(A, -1, np.int32)
    slot_gid[rng.choice(A, len(running), replace=False)] = running
    g = np.maximum(slot_gid, 0)
    run = (slot_gid >= 0)[:, None] & exists[g] & (is_core[g] | (rng.random((A, C)) < p_elastic))
    alloc = (np.stack([cpu_req[g], mem_req[g]], -1) * run[..., None]).astype(np.float32)
    return dict(
        submit=submit, gid=gid, cpu_req=cpu_req, mem_req=mem_req, exists=exists,
        is_core=is_core, slot_gid=slot_gid,
        work_done=rng.uniform(0, 300, A).astype(np.float32), comp_running=run,
        comp_host=np.where(run, rng.integers(0, H, (A, C)), 0).astype(np.int32),
        alloc=alloc, usage=alloc.copy(),
        alive_since=(60.0 * rng.integers(0, 3, (A, C))).astype(np.float32),
        queued=queued, failed=np.zeros(N, bool), has_saved=rng.random(N) < 0.5,
        saved_work=rng.uniform(0, 300, N).astype(np.float32), t=np.float32(300.0),
        host_cap=np.tile(np.float32([[8.0, 24.0]]), (H, 1)))


def edge_tables(seed):
    """The three edge members of edge_member as one batch (S = 3) in
    random_tables' layout."""
    import torch
    members = [edge_member(kind, seed) for kind in EDGE_KINDS]
    d = {k: torch.as_tensor(np.stack([m[k] for m in members]))
         for k in members[0] if k != "host_cap"}
    d["host_cap"] = torch.as_tensor(members[0]["host_cap"])
    d["counters"] = [torch.zeros(3, dtype=torch.int32) for _ in range(3)]
    return d


def scan_kernel_cases(step, SimConfig):
    """Every kernel's argument tuples (CPU tensors): the full-width states
    captured under the pessimistic and the optimistic policy (the pass on
    the tick's own problem, the scheduler loops on its state with the usage
    at its progress), 16 seeded random tables of three members each, the
    edge cases, and last the busiest captured calls of admission and
    re-placement."""
    import torch
    from repro_torch.core.shaper import pessimistic as P
    cases = {k: [] for k in SCAN_KERNELS}
    calls = []
    for policy in ("pessimistic", "optimistic"):
        states, busiest = capture_states(step, SimConfig, policy)
        calls += busiest.items()
        for cfg, tr, st, cap in states:
            t = st.t + 60.0
            usage = step._usage_at(tr, st, torch.clamp(
                st.work_done / step._rows(tr.runtime, step._gid(st)), 0.0, 1.0))
            demand, *_ = step._shaped_demands(cfg, None, tr, st, 60.0)
            cases["pessimistic_pass"].append(
                P.pass_inputs(step._shape_problem(tr, st, demand, t, cap))[0])
            d = dict(submit=tr.submit, gid=tr.gid, cpu_req=tr.cpu_req, mem_req=tr.mem_req,
                     exists=tr.exists, is_core=tr.is_core, usage=usage, t=t, host_cap=cap,
                     counters=[st.oom_kills, st.failure_events, st.partial_preemptions],
                     **{f: getattr(st, f) for f in (
                         "slot_gid", "work_done", "comp_running", "comp_host", "alloc",
                         "alive_since", "queued", "failed", "has_saved", "saved_work")})
            add_sched_cases(cases, d)
    for seed in range(16):
        add_sched_cases(cases, random_tables(seed))
        cases["pessimistic_pass"].append(pass_table(seed))
    # edge cases of the block-per-member kernels: three members each; A * C
    # and N off the 16-byte vectors; hosts over memory with every overage
    # tied; admissions until a head does not fit, gid ties, missing elastic
    # components that fill the hosts; a host short of cpu (member 0) or
    # memory (member 1) before the pass, which removes every valid row;
    # core components sharing hosts; a streamed window's re-keyed rows
    # and free rows
    for seed in range(4):
        add_sched_cases(cases, random_tables(seed, A=13, C=7, N=37, H=5))
        add_sched_cases(cases, tied_oom_table(seed))
        add_sched_cases(cases, edge_tables(seed))
        add_sched_cases(cases, window_tables(seed))
        cases["pessimistic_pass"] += [pass_table(seed, A=7, C=5, H=3),
                                      pass_table(seed, A=13, C=3, H=4),
                                      pass_table(seed, negative=True),
                                      pass_table(seed, A=32, H=2, core_p=0.6)]
    # host totals on capacity + 1e-6 in XLA:CPU's order of each shape
    cases["resolve_oom"] += [oom_total_table(C, A=A) for A, C in OOM_TOTAL_SHAPES]
    # no captured call re-places anything (no policy kill or OOM victim
    # leaves an elastic component missing at these widths): the
    # pessimistic tick-200 state with the running elastic components of
    # every other slot stopped, as partial preemptions leave them
    calls.append(("place_missing_elastic",
                  stop_elastics(cases["place_missing_elastic"][TICK_200])))
    for name, args in calls:
        cases[name].append(args)
    return cases


def stop_elastics(args):
    """place_missing_elastic's arguments with the running elastic
    components of the even slots stopped (not running, nothing allocated)."""
    import torch
    cpu_req, mem_req, exists, is_core, slot_gid, run, host, alloc, alive, t, cap = args
    S, A, C = run.shape
    g = slot_gid.clamp_min(0).long()[..., None].expand(S, A, C)
    even = (torch.arange(A) % 2 == 0)[None, :, None]
    stop = run & ~torch.gather(is_core, 1, g) & even
    return (cpu_req, mem_req, exists, is_core, slot_gid, run & ~stop, host,
            alloc * ~stop[..., None], alive, t, cap)


def pass_table(seed, S=3, A=64, C=12, H=7, *, negative=False, core_p=0.3):
    """Seeded inputs of Algorithm 1's pass (CPU tensors): demands and
    capacities from small sets, so that decisions tie.  ``negative`` puts
    one host of member 0 below 0 in cpu and one of member 1 below 0 in
    memory."""
    import torch
    rng = np.random.default_rng(seed)
    core = rng.random((S, A, C)) < core_p
    args = [rng.random((S, A)) < 0.8,
            rng.choice([0.25, 0.5, 1.0, 2.0], (S, A, C, 2)).astype(np.float32), core,
            ~core & (rng.random((S, A, C)) < 0.6),
            rng.integers(0, H, (S, A, C)).astype(np.int32),
            np.argsort(rng.random((S, A, C)), -1).astype(np.int32),
            rng.choice([8.0, 16.0], (S, H, 2)).astype(np.float32)]
    free0 = args[-1]
    if negative:
        free0[0, 0, 0] = -0.5
        free0[1, H - 1, 1] = -0.25
    return tuple(torch.as_tensor(x) for x in args)


def tied_oom_table(seed):
    """random_tables with every running component at 20 GB of memory use
    against 4 GB allocated: each host with two of them is over its
    memory, and every overage ties, so the largest flat index decides."""
    import torch
    d = random_tables(seed, A=13, C=7, N=37, H=3)
    run = d["comp_running"]
    for k, v in (("usage", 20.0), ("alloc", 4.0)):
        d[k] = d[k].clone()
        d[k][..., 1] = torch.where(run, v, 0.0)
    return d


def _parent_slot_sum(x):
    """An (A, C) table's sum in whole-slot windows of 32, each in order
    (the serial order every (A, C) shape took before the plan of
    ``ref.xla_slot_plan``): the crafted OOM totals are held against it."""
    from repro_torch.kernels import ref
    A = x.shape[0]
    if A <= ref.TREE_WINDOW:
        return np.cumsum(x.reshape(-1), dtype=np.float32)[-1]
    padded = -(-A // ref.TREE_WINDOW) * ref.TREE_WINDOW
    lo = (padded - A) // 2
    parts = [np.cumsum(x[max(j - lo, 0):min(j + ref.TREE_WINDOW - lo, A)].reshape(-1),
                       dtype=np.float32)[-1] for j in range(0, padded, ref.TREE_WINDOW)]
    return np.cumsum(np.float32(parts), dtype=np.float32)[-1]


OOM_TOTAL_CAP = 24.0   # GB of memory per host in the crafted OOM totals


def oom_total_table(C, A=128, N=160, H=4, seed=0):
    """resolve_oom's arguments (CPU tensors, one member) whose host 0 has
    every running component and a memory total within an ulp or two of
    its capacity + 1e-6, at the reference's (A, C): the entry's column
    sums (``ref.xla_sum``) put the host over, and where XLA:CPU sums the
    loop's total in vector lanes (``ref.xla_slot_plan``: C = 3 at A =
    128), the lanes and the serial order decide the first kill
    differently; at C = 12 both orders are the serial one.  Searched over
    seeded draws, the largest component nudged a quarter of the total's
    ulp at a time."""
    import torch
    from repro_torch.kernels import ref
    rng = np.random.default_rng(seed)
    lim = np.float32(OOM_TOTAL_CAP) + np.float32(1e-6)
    run = np.ones((A, C), bool)
    vectorised = ref.xla_slot_plan(A, C)[0] > 0
    quarter = np.float32(np.spacing(lim) / 4)
    for _ in range(400):
        mem = rng.uniform(0.5, 1.5, (A, C)) * 2.0 ** rng.integers(-8, 1, (A, C))
        mem = (mem / mem.sum() * OOM_TOTAL_CAP).astype(np.float32)
        big = int(np.argmax(mem))
        mem.flat[big] += np.float32(float(lim) - mem.sum(dtype=np.float64))
        for _ in range(64):
            over0 = ref.xla_sum(mem.reshape(-1, 1))[0] > lim
            xla, serial = ref.xla_slot_sum(mem) > lim, _parent_slot_sum(mem) > lim
            if over0 and (xla != serial if vectorised else xla):
                break
            up = not over0 or not (xla or serial) or not vectorised
            mem.flat[big] += quarter if up else -quarter
        else:
            continue
        break
    else:
        raise AssertionError(f"no crafted OOM total at A = {A}, C = {C}")
    usage = np.stack([mem, mem], -1).astype(np.float32)
    alloc = (usage * np.float32(0.5)).astype(np.float32)
    slot_gid = np.arange(A, dtype=np.int32)
    is_core = np.zeros((N, C), bool)
    is_core[:, 0] = rng.random(N) < 0.5
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))[None]  # noqa: E731
    return (t(slot_gid), t(np.full(A, 60.0, np.float32)), t(run),
            t(np.zeros((A, C), np.int32)), t(alloc), t(usage), t(np.zeros(N, bool)),
            t(np.zeros(N, bool)), *(torch.zeros(1, dtype=torch.int32) for _ in range(3)),
            t(is_core),
            torch.as_tensor(np.tile(np.float32([[64.0, OOM_TOTAL_CAP]]), (H, 1))))


# (A, C) of the crafted OOM totals: the main path's serial shape, and
# shapes whose loop total XLA:CPU sums in 8 or 4 lanes, with and without
# a scalar slot (ref.xla_slot_plan)
OOM_TOTAL_SHAPES = ((128, 3), (128, 12), (127, 3), (20, 4), (16, 2), (128, 8), (95, 5))


def window_tables(seed, S=3, A=16, C=4, N=24, H=3):
    """random_tables as a streamed window holds them: the apps' rows in a
    seeded order (submit times no longer sorted), each row's gid a global
    id far from its row, and about a third of the rows that no slot
    holds free, with the window's inert sentinel (submit +inf, no demand,
    gid 0, not queued, failed or saved)."""
    import torch
    d = random_tables(seed, S, A, C, N, H)
    rng = np.random.default_rng(1000 + seed)
    out = dict(d)
    app_cols = ("submit", "cpu_req", "mem_req", "exists", "is_core", "queued", "failed",
                "has_saved", "saved_work")
    slot_gid = d["slot_gid"].numpy().copy()
    gid = np.zeros((S, N), np.int32)
    cols = {k: d[k].numpy().copy() for k in app_cols}
    for s in range(S):
        perm = rng.permutation(N)                     # row r holds app perm[r]
        inv = np.argsort(perm)
        for k in app_cols:
            cols[k][s] = cols[k][s][perm]
        # global ids in the apps' order, so ties on submit go as materialized
        gid[s] = np.sort(rng.choice(10 * N, N, replace=False))[perm]
        held = slot_gid[s] >= 0
        slot_gid[s, held] = inv[slot_gid[s, held]]
        free = ~np.isin(np.arange(N), slot_gid[s]) & (rng.random(N) < 0.35)
        cols["submit"][s, free] = np.inf
        for k in ("cpu_req", "mem_req", "saved_work"):
            cols[k][s, free] = 0
        for k in ("exists", "is_core", "queued", "failed", "has_saved"):
            cols[k][s, free] = False
        gid[s, free] = 0
    t = lambda x: torch.as_tensor(np.ascontiguousarray(x))  # noqa: E731
    out.update({k: t(v) for k, v in cols.items()})
    out.update(gid=t(gid), slot_gid=t(slot_gid))
    return out


def add_sched_cases(cases, d):
    cases["resolve_oom"].append((
        d["slot_gid"], d["work_done"], d["comp_running"], d["comp_host"], d["alloc"],
        d["usage"], d["failed"], d["queued"], *d["counters"], d["is_core"], d["host_cap"]))
    for resume in (False, True):
        cases["admit_queued"].append((
            d["submit"], d["gid"], d["cpu_req"], d["mem_req"], d["exists"], d["is_core"],
            d["slot_gid"], d["work_done"], d["comp_running"], d["comp_host"], d["alloc"],
            d["alive_since"], d["queued"], d["has_saved"], d["saved_work"], d["t"],
            d["host_cap"], resume))
    cases["place_missing_elastic"].append((
        d["cpu_req"], d["mem_req"], d["exists"], d["is_core"], d["slot_gid"],
        d["comp_running"], d["comp_host"], d["alloc"], d["alive_since"], d["t"],
        d["host_cap"]))


def scan_events(name, args, outs) -> int:
    """The events a kernel's plain outputs hold: the pass's removals and
    kills, the OOM handler's victims, admissions, placements."""
    if name == "pessimistic_pass":
        return int(outs[0].sum() + outs[1].sum())
    if name == "resolve_oom":
        return int((outs[7] - args[8]).sum() + (outs[9] - args[10]).sum())
    if name == "admit_queued":
        return int(args[12].sum() - outs[6].sum())
    return int(outs[0].sum() - args[5].sum())


def check_scan_kernels(fns, cases) -> tuple[dict, dict]:
    """Each kernel on the card against its plain version on the CPU on the
    same inputs: every output equal (the same float operations in the same
    order).  Returns the largest absolute error per kernel and the events
    the cases hold (kills, admissions, placements)."""
    import torch
    err = dict.fromkeys(SCAN_KERNELS, 0.0)
    events = dict.fromkeys(SCAN_KERNELS, 0)
    for name, (kern, plain) in fns.items():
        for args in cases[name]:
            cpu = [a.contiguous() if isinstance(a, torch.Tensor) else a for a in args]
            got = kern(*(a.cuda() if isinstance(a, torch.Tensor) else a for a in cpu))
            torch.cuda.synchronize()
            want = plain(*cpu)
            for g, w in zip(got, want):
                g = g.cpu()
                if not torch.equal(g, w):
                    bad = (g != w).nonzero()[:5].tolist()
                    raise AssertionError(f"{name}: output {tuple(w.shape)} differs at {bad}")
                if w.is_floating_point():
                    err[name] = max(err[name], (g - w).abs().max().item() if w.numel() else 0.0)
            events[name] += scan_events(name, cpu, want)
        log(f"  {name}: {len(cases[name])} cases, kernel == plain version; "
            f"{events[name]} events")
    assert all(v > 0 for v in events.values()), events
    return err, events


class strict_chunks:
    """Run every chunk of the device engine (a replay of its graph,
    with the capture where it has none yet, or the chunk program run
    eagerly) under torch.cuda.set_sync_debug_mode("error"): anything
    inside a chunk that waits for the card raises.  Wraps
    ``_ChunkGraphs.run`` and ``_chunk_program``; a chunk program run
    by a capture inside ``run`` is not counted again."""

    def __init__(self, step):
        self.step, self.chunks, self.depth = step, 0, 0
        self.run, self.program = step._ChunkGraphs.run, step._chunk_program

        def strict(fn):
            def chunk(*a, **k):
                self.chunks += self.depth == 0
                self.depth += 1
                try:
                    with step._sync_errors():
                        return fn(*a, **k)
                finally:
                    self.depth -= 1
            return chunk
        step._ChunkGraphs.run = strict(self.run)
        step._chunk_program = strict(self.program)

    def stop(self) -> int:
        self.step._ChunkGraphs.run = self.run
        self.step._chunk_program = self.program
        return self.chunks


class record_runs:
    """Keep, until ``stop()``, what each ``step._drive_chunks`` (or
    ``_drive_chunks_leap``) call returned (its per-tick or per-step
    metrics), the bucket ``step._pick_bucket`` chose at each chunk
    boundary (None: the full table) and the first member's ready rows
    there ((A*C,) bool, on the host)."""

    def __init__(self, step):
        self.step, self.metrics, self.buckets, self.ready = step, [], [], []
        self.drive, self.pick = step._drive_chunks, step._pick_bucket
        self.drive_leap = step._drive_chunks_leap

        def recorded(fn):
            def drive(*a, **k):
                out = fn(*a, **k)
                self.metrics.append(out[1])
                return out
            return drive
        drive = recorded(self.drive)
        step._drive_chunks_leap = recorded(self.drive_leap)

        def pick(cfg, st):
            S, AC = st.mon_count.shape
            run = ((st.slot_gid >= 0)[:, :, None] & st.comp_running).reshape(S, AC)
            self.ready.append((run & (st.mon_count >= cfg.grace))[0].cpu().numpy())
            self.buckets.append(self.pick(cfg, st))
            return self.buckets[-1]
        step._drive_chunks, step._pick_bucket = drive, pick

    def stop(self):
        self.step._drive_chunks, self.step._pick_bucket = self.drive, self.pick
        self.step._drive_chunks_leap = self.drive_leap
        return self


def scan_launch_counts(gp_forecast, shaper, sched, fma) -> dict:
    return {"pessimistic_pass": shaper.pessimistic_pass.launches,
            "resolve_oom": sched.resolve_oom.launches,
            "admit_queued": sched.admit_queued.launches,
            "place_missing_elastic": sched.place_missing_elastic.launches,
            "gp_fit_forecast": gp_forecast.gp_fit_forecast.launches,
            "fma_f32": fma.fma_f32.launches}


# CUgraphNodeType
NODE_TYPES = {0: "kernel", 1: "memcpy", 2: "memset", 3: "host", 4: "child graph", 5: "empty",
              6: "wait event", 7: "event record", 10: "mem alloc", 11: "mem free"}

# the kernel each counted wrapper of the device engine (nvcc.COUNTED)
# launches, by the name of its function in the CUDA source
KERNEL_OF = {"gram_fwd": "gram_fwd_", "gram_bwd": "gram_bwd_",
             "pessimistic_pass": "pessimistic_pass_kernel", "resolve_oom": "resolve_oom_kernel",
             "admit_queued": "admit_queued_kernel",
             "place_missing_elastic": "place_missing_elastic_kernel",
             "gp_fit_forecast": "gp_forecast_kernel", "fma_f32": "fma_f32_kernel",
             "leap_skip": "leap_skip_kernel", "arima_forecast": "arima_forecast_kernel",
             "calib_observe": "calib_observe_kernel", "conformal_scale": "conformal_scale_kernel",
             "calib_begin": "calib_begin_kernel", "control_tick": "control_tick_kernel",
             "obs_tick": "obs_tick_kernel"}


class KernelNodeParams(ctypes.Structure):
    """CUDA_KERNEL_NODE_PARAMS_v2 of cuda.h."""
    _fields_ = [("func", ctypes.c_void_p),
                *[(f, ctypes.c_uint) for f in ("gridDimX", "gridDimY", "gridDimZ", "blockDimX",
                                               "blockDimY", "blockDimZ", "sharedMemBytes")],
                ("kernelParams", ctypes.c_void_p), ("extra", ctypes.c_void_p),
                ("kern", ctypes.c_void_p), ("ctx", ctypes.c_void_p)]


def libcuda():
    """libcuda (CUDA's lower-level API) through ctypes, with the graph
    queries declared."""
    import torch
    torch.cuda.init()
    lib = ctypes.CDLL("libcuda.so.1")
    ptr, out = ctypes.c_void_p, ctypes.POINTER
    for name, args in (("cuGraphGetNodes", [ptr, ptr, out(ctypes.c_size_t)]),
                       ("cuGraphNodeGetType", [ptr, out(ctypes.c_int)]),
                       ("cuGraphKernelNodeGetParams_v2", [ptr, out(KernelNodeParams)]),
                       ("cuFuncGetName", [out(ctypes.c_char_p), ptr]),
                       ("cuKernelGetName", [out(ctypes.c_char_p), ptr])):
        fn = getattr(lib, name)
        fn.argtypes, fn.restype = args, ctypes.c_int
    return lib


def graph_nodes(graph) -> tuple[dict, dict]:
    """The nodes of a CUDA graph captured with keep_graph=True, as the
    libcuda holds them (cuGraphGetNodes on raw_cuda_graph()): their count
    by type, and the kernel nodes' count by the (mangled) name of the
    function each launches (cuGraphKernelNodeGetParams, then
    cuFuncGetName, or cuKernelGetName where the node holds a library
    kernel; a node neither names is counted as unnamed)."""
    lib = libcuda()
    g = ctypes.c_void_p(graph.raw_cuda_graph())
    n = ctypes.c_size_t(0)
    assert lib.cuGraphGetNodes(g, None, ctypes.byref(n)) == 0
    nodes = (ctypes.c_void_p * n.value)()
    assert lib.cuGraphGetNodes(g, nodes, ctypes.byref(n)) == 0
    kinds: dict = {}
    names: dict = {}
    for node in nodes:
        node, t = ctypes.c_void_p(node), ctypes.c_int(-1)
        assert lib.cuGraphNodeGetType(node, ctypes.byref(t)) == 0
        kind = NODE_TYPES.get(t.value, f"type {t.value}")
        kinds[kind] = kinds.get(kind, 0) + 1
        if kind == "kernel":
            prm, name = KernelNodeParams(), ctypes.c_char_p()
            rc = lib.cuGraphKernelNodeGetParams_v2(node, ctypes.byref(prm))
            assert rc == 0, f"cuGraphKernelNodeGetParams: CUresult {rc}"
            rc = lib.cuFuncGetName(ctypes.byref(name), prm.func) if prm.func else -1
            if rc != 0:      # a library kernel (CUkernel), in kern or cast into func
                rc = lib.cuKernelGetName(ctypes.byref(name), prm.kern or prm.func)
            key = name.value.decode() if rc == 0 and name.value else f"unnamed (CUresult {rc})"
            names[key] = names.get(key, 0) + 1
    return kinds, names


def wrapper_nodes(names: dict) -> dict:
    """Kernel nodes per counted wrapper: those whose function is its
    kernel (KERNEL_OF), from graph_nodes' count by name."""
    return {w: sum(n for name, n in names.items() if kernel in name)
            for w, kernel in KERNEL_OF.items()}


def describe_graphs(entry) -> list[str]:
    """One line per graph of a device-engine entry: its chunk size, nodes
    by type, kernels per tick, capture and instantiate seconds, replays."""
    lines = []
    for size, g in sorted(entry.graphs.items()):
        nodes, names = graph_nodes(g.graph)
        per_tick = {w: n / size for w, n in wrapper_nodes(names).items()}
        unnamed = sum(n for k, n in names.items() if k.startswith("unnamed"))
        lines.append(f"chunk of {size}: {sum(nodes.values())} nodes {nodes}, "
                     f"{nodes.get('kernel', 0) / size:.3f} kernels per tick (the port's, by "
                     f"wrapper: {per_tick}; {unnamed} kernel nodes unnamed); capture "
                     f"{g.capture_s:.3f} s, instantiate {g.instantiate_s:.3f} s; "
                     f"{g.replays} replays")
    return lines


PROFILE_TICKS = 640   # the device-engine window profiled for the GP program's share


def run_series(res) -> tuple:
    """A run's summary (as JSON, so that a NaN mean of no completion
    compares equal) and per-tick series, for equality."""
    return (json.dumps(res.summary()), res.n_running, res.util_cpu, res.util_mem, res.slack_cpu,
            res.slack_mem, res.turnaround, res.failed_apps)


def runs_of(xs) -> str:
    """A sequence as runs, 'value xcount', in order."""
    out = []
    for x in xs:
        if out and out[-1][0] == x:
            out[-1][1] += 1
        else:
            out.append([x, 1])
    return ", ".join(f"{'full' if x is None else x} x{n}" for x, n in out)


def series_per_launch(metrics) -> tuple[float, int, int]:
    """The series the GP program computes per launch (it launches every
    tick) over a solo run's ticks: 2 x the tick's ready rows, from the
    per-tick forecast rows; (mean, min, max)."""
    rows = np.asarray(metrics["forecast_rows"][0])
    return float(rows.mean()), int(rows.min()), int(rows.max())


def gp_profile(step, cfg, ticks=PROFILE_TICKS, kernel="gp_forecast_kernel", also=()) -> dict:
    """The first ``ticks`` ticks of ``cfg`` on the device engine (its graph
    captured before) under torch.profiler: the forecast kernel's (the GP
    program's unless ``kernel`` names another) device time per launch,
    its launches, its share of all kernel time, the device's busy share
    of the wall, and the series per launch in the window; under
    ``others`` the same three for each kernel named in ``also``."""
    import torch
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile
    run = dataclasses.replace(cfg, max_ticks=ticks)
    torch.cuda.synchronize()
    rec = record_runs(step)
    try:
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t = time.perf_counter()
            step.run_sim_scan(run, device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
    finally:
        rec.stop()
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and e.self_device_time_total > 0]
    busy = sum(e.self_device_time_total for e in kernels)

    def stats(name):
        hits = [e for e in kernels if name in e.key]
        us, n = sum(e.self_device_time_total for e in hits), sum(e.count for e in hits)
        return dict(us_per_launch=us / max(n, 1), launches=n, share=us / max(busy, 1e-9))
    mean, lo, hi = series_per_launch(rec.metrics[0])
    return dict(stats(kernel), busy=busy / 1e6 / wall, ms_per_tick=wall / ticks * 1e3,
                series=(mean, lo, hi), others={name: stats(name) for name in also})


def run_scan_main(step, SimConfig, gp_forecast, shaper, sched, fma) -> tuple[dict, np.ndarray,
                                                                             dict]:
    """The device engine's main path: run_sim_scan(SimConfig()) on the card
    to completion (GP with bucketed forecasts, pessimistic, full width)
    through replayed CUDA graphs, every chunk sync-free (capture and
    replay), each of the five sim kernels launched once per tick and the
    fma kernel the same number of times every tick, counted as replays x
    the launches each graph's capture counted, and held against replays
    x the graph's own kernel nodes of each wrapper's kernel
    (graph_nodes).  A 64-tick run of the same config first warms up and
    captures the graph (the cache is emptied before it).  Counts are set
    to 0 just before the main run and read just after.  The bucket is
    re-chosen at every chunk boundary and replays the one graph.

    Then the same run with forecast_bucket=False (the full batch, its own
    graph entry) on the card: summaries, per-tick series and rows_ready
    bit for bit, with fewer rows_bucketed; the graph cache within its
    bound; and both profiled over their first PROFILE_TICKS ticks for the
    GP program's time per launch, series per launch and share of device
    time.  Returns the main run's launch counts, the ready rows at the
    chunk boundary whose count is nearest the mean the GP program ran per
    launch (half its series: the same rows of both resources), and the
    main run's summary."""
    import torch
    guard = strict_chunks(step)
    try:
        step._GRAPHS.clear()
        t = time.perf_counter()
        step.run_sim_scan(SimConfig(max_ticks=64), device="cuda")
        torch.cuda.synchronize()
        t_warm = time.perf_counter() - t
        (entry,) = step._GRAPHS.values()
        replays = {n: g.replays for n, g in entry.graphs.items()}
        rec = record_runs(step)
        for m in (gp_forecast, shaper, sched, fma):
            m.reset_launch_counts()
        c0 = guard.chunks
        try:
            t = time.perf_counter()
            res = step.run_sim_scan(SimConfig(), device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        finally:
            rec.stop()
        launches = scan_launch_counts(gp_forecast, shaper, sched, fma)
        chunks = guard.chunks - c0
        # the full batch: its own entry, captured by a 64-tick run first
        step.run_sim_scan(SimConfig(forecast_bucket=False, max_ticks=64), device="cuda")
        torch.cuda.synchronize()
        t_full = time.perf_counter()
        full = step.run_sim_scan(SimConfig(forecast_bucket=False), device="cuda")
        torch.cuda.synchronize()
        t_full = time.perf_counter() - t_full
    finally:
        guard.stop()
    ticks = res.timings["ticks"]
    summary = res.summary()
    ran = {n: g.replays - replays.get(n, 0) for n, g in entry.graphs.items()}
    log(f"  warm-up and capture: run_sim_scan(SimConfig(max_ticks=64)) {t_warm:.3f} s")
    for line in describe_graphs(entry):
        log(f"  graph {line}")
    log(f"  {ticks} ticks ({len(res.n_running)} executed before the last app finished) "
        f"in {chunks} chunks ({ran} replays), {t:.3f} s: {ticks / t:.3f} ticks/s, "
        f"{t / ticks * 1e3:.4f} ms per tick; every chunk sync-free; max memory allocated "
        f"{torch.cuda.max_memory_allocated()} B")
    log(f"  bucket per chunk (rows a resource; full = the whole table): "
        f"{runs_of(rec.buckets)}")
    mean, lo, hi = series_per_launch(rec.metrics[0])
    log(f"  GP program series per launch: mean {mean:.3f}, min {lo}, max {hi} "
        f"(of {res.forecast_rows['rows_batch']} in the full batch)")
    log(f"  kernel launches {launches}")
    log(f"  summary {json.dumps(summary)}")
    log(f"  forecast rows {res.forecast_rows}")
    fma_per_tick = launches["fma_f32"] / ticks
    log(f"  fma_f32: {fma_per_tick} launches per tick")
    assert len(entry.graphs) == 1 and sum(n * r for n, r in ran.items()) == ticks, ran
    assert len(rec.buckets) == chunks and len(set(rec.buckets)) > 1, rec.buckets
    # the counts against the graphs themselves: replays x the kernel nodes
    # of each wrapper's kernel that libcuda holds in the graph replayed
    nodes = {size: wrapper_nodes(graph_nodes(entry.graphs[size].graph)[1]) for size in ran}
    in_graphs = {k: sum(r * nodes[size][k] for size, r in ran.items()) for k in launches}
    log(f"  kernel nodes replayed, by wrapper {in_graphs}")
    assert launches == in_graphs, (launches, in_graphs)
    assert all(n == ticks for k, n in launches.items() if k != "fma_f32"), (launches, ticks)
    assert fma_per_tick >= 1 and fma_per_tick == int(fma_per_tick), launches
    assert summary["completed"] == 500, summary
    for k in ("util_cpu_mean", "util_mem_mean", "slack_cpu_mean", "slack_mem_mean"):
        assert np.isfinite(summary[k]), (k, summary[k])

    fr, ff = res.forecast_rows, full.forecast_rows
    log(f"  forecast_bucket=False on the card: {full.timings['ticks']} ticks in "
        f"{t_full:.3f} s: {full.timings['ticks'] / t_full:.3f} ticks/s (bucketed "
        f"{ticks / t:.3f}); forecast rows {ff}")
    assert run_series(res) == run_series(full), "bucketed != full batch on the card"
    assert (fr["rows_ready"], fr["ticks_forecasting"], fr["ticks"]) == \
        (ff["rows_ready"], ff["ticks_forecasting"], ff["ticks"]), (fr, ff)
    assert fr["rows_bucketed"] < ff["rows_bucketed"], (fr, ff)
    log("  bucketed == full batch on the card: summaries, per-tick series, turnaround, "
        "failed apps and rows_ready bit for bit; rows_bucketed "
        f"{fr['rows_bucketed']} < {ff['rows_bucketed']}")
    # the cache: one entry per config (the full batch is a config of its
    # own), each at most two graphs, whatever the buckets
    sizes = {len(e.graphs) for e in step._GRAPHS.values()}
    log(f"  graph cache: {len(step._GRAPHS)} entries (bound {step._GRAPHS_MAX}), "
        f"graphs per entry {sorted(sizes)} (bound 2: the full and the cut chunk)")
    assert len(step._GRAPHS) == 2 <= step._GRAPHS_MAX and max(sizes) <= 2, sizes
    for name, cfg in (("bucketed", SimConfig()), ("full batch", SimConfig(forecast_bucket=False))):
        p = gp_profile(step, cfg)
        log(f"  {name}, first {PROFILE_TICKS} ticks under torch.profiler: GP program "
            f"{p['us_per_launch']:.3f} us per launch over {p['launches']} launches, "
            f"{p['share']:.2%} of device time; series per launch mean {p['series'][0]:.3f}, "
            f"min {p['series'][1]}, max {p['series'][2]}; device busy {p['busy']:.2%} of "
            f"the wall, {p['ms_per_tick']:.4f} ms per tick")
    near = min(rec.ready, key=lambda r: abs(2 * int(r.sum()) - mean))
    log(f"  ready rows kept for phase 8: {int(near.sum())} a resource, at a chunk boundary")
    return launches, near, summary


def _bits(x):
    import torch
    return x.view(torch.int32) if x.dtype == torch.float32 else x


def graph_vs_eager(step, cfg, seeds, ticks, chunk=32, buckets=None):
    """Replays of the device engine's graph entry for ``cfg`` against the
    eager loop of fused_tick on the card from the same initial state:
    every SimState field and metric equal, bit for bit, at every chunk
    boundary over ``ticks`` ticks.  Bucketed, each chunk's bucket is the
    one ``_drive_chunks`` picks at the boundary, or the next of ``buckets``
    (cycled; None is the full table) where given, written to the entry's
    scalar and to the eager loop's alike.  Returns the entry and the
    buckets used."""
    import torch
    from repro_torch.sim.scenarios.registry import build_trace
    from repro_torch.sim.state import DeviceTrace, init_state
    wls = [build_trace(dataclasses.replace(cfg.workload, seed=s)) for s in seeds]
    tr = DeviceTrace.from_traces(wls, "cuda")
    st = init_state(cfg, wls[0].n_apps, wls[0].max_components, len(wls), "cuda")
    cap = step.host_capacity(cfg, "cuda")
    model = step._make_model(cfg)
    entry = step._graph_entry(cfg, model, tr, st, chunk, cap)
    bucket, used = step._full_bucket(st), []
    eager, done = st, 0
    while done < ticks:
        size = min(chunk, ticks - done)
        if step._bucketed(cfg):
            b = (buckets[len(used) % len(buckets)] if buckets
                 else step._pick_bucket(cfg, entry.st))
            for scalar in (entry.bucket, bucket):
                scalar.fill_(st.mon_count.shape[1] if b is None else b)
            used.append(b)
        got = {k: v.clone() for k, v in entry.run(size).items()}
        ms = []
        for _ in range(size):
            eager, m = step.fused_tick(cfg, model, tr, eager, cap, bucket)
            ms.append(m)
        done += size
        want = {f: torch.stack([getattr(m, f) for m in ms], -1) for f in step._METRICS}
        for what, a, b in (("metric", got, want),
                           ("state", step._tensors(entry.st), step._tensors(eager))):
            for k in b:
                if not torch.equal(_bits(a[k]), _bits(b[k])):
                    raise AssertionError(f"graph != eager: {what} {k} at tick {done} "
                                         f"(seeds {seeds})")
    log(f"  seeds {list(seeds)}, {ticks} ticks in chunks of {chunk}"
        + (f", buckets {runs_of(used)}" if used else "") + ": graph == eager at "
        f"every chunk boundary, every state field and metric bit for bit; "
        f"{int(eager.done.sum())} apps done, {int(eager.arrived.sum())} arrived")
    return entry, used


def time_graph_vs_eager(step, cfg, ticks=640, chunk=32) -> dict:
    """Ticks/s of the first ``ticks`` ticks of ``cfg`` from its initial
    state, driven chunk by chunk as run_sim_scan drives them (the
    metrics and the done flags read at each boundary), eagerly (the chunk
    program) and by replays, in turns: eager, graph, graph, eager.  Each
    replay is bracketed by CUDA events, so the replays' span and its
    share of the wall are measured too (the span holds the gaps between
    the graph's kernels, so it is not their kernel time)."""
    import torch
    from repro_torch.sim.scenarios.registry import build_trace
    from repro_torch.sim.state import DeviceTrace, init_state
    wl = build_trace(cfg.workload)
    tr = DeviceTrace.from_traces([wl], "cuda")
    st0 = init_state(cfg, wl.n_apps, wl.max_components, 1, "cuda")
    cap = step.host_capacity(cfg, "cuda")
    model = step._make_model(cfg)
    entry = step._graph_entry(cfg, model, tr, st0, chunk, cap)

    def boundary(ms, st):
        for f in step._METRICS:
            ms[f].cpu()
        return bool(st.done.all())

    def eager():
        st = step._clone(st0)
        torch.cuda.synchronize()
        t = time.perf_counter()
        for _ in range(ticks // chunk):
            boundary(step._chunk_program(cfg, model, tr, st, chunk, cap, entry.bucket), st)
        torch.cuda.synchronize()
        return time.perf_counter() - t, None

    def graph():
        entry.load(tr, st0, cap)
        events = [(torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True))
                  for _ in range(ticks // chunk)]
        torch.cuda.synchronize()
        t = time.perf_counter()
        for a, b in events:
            a.record()
            ms = entry.run(chunk)
            b.record()
            boundary(ms, entry.st)
        torch.cuda.synchronize()
        return time.perf_counter() - t, sum(a.elapsed_time(b) for a, b in events) / 1e3

    runs = {"eager": [], "graph": []}
    for name in ("eager", "graph", "graph", "eager"):
        runs[name].append((eager if name == "eager" else graph)())
    for name, rs in runs.items():
        log(f"  {name}: " + "; ".join(
            f"{ticks / t:.3f} ticks/s ({t / ticks * 1e3:.4f} ms per tick)"
            + ("" if d is None else f", replay span {d / ticks * 1e3:.4f} ms per tick "
               f"= {d / t:.2%} of the wall") for t, d in rs))
    return {name: [ticks / t for t, _ in rs] for name, rs in runs.items()}


def check_graphs(step, SimConfig) -> None:
    """Phase 5c: the graphs against the eager ticks on the card at full
    width, then the two timed in turns."""
    cfg = SimConfig()
    entry, used = graph_vs_eager(step, cfg, (0,), 4 * 32 + 7)
    assert set(entry.graphs) == {32, 7}, set(entry.graphs)
    assert len(set(used)) > 1, used
    for line in describe_graphs(entry):
        log(f"  graph {line}")
    # buckets that change at every boundary, below the ready count (extra
    # passes counted) and above it, through the same two graphs
    entry, used = graph_vs_eager(step, cfg, (1,), 6 * 32 + 7,
                                 buckets=(8, None, 64, 16, 512, 8, 256))
    assert set(entry.graphs) == {32, 7} and len(set(used)) == 6, (set(entry.graphs), used)
    cohort, _ = graph_vs_eager(step, cfg, (0, 1, 2), 64)
    for line in describe_graphs(cohort):
        log(f"  cohort graph {line}")
    time_graph_vs_eager(step, cfg)


FAMILY_TICKS = 320    # cap on each scenario family's device-engine runs
FAMILIES = ("diurnal", "flashcrowd", "heavytail", "colocated")


def run_families(step, scenarios, SimConfig, gp_forecast) -> None:
    """Phase 5d: the four parametric families at their default size (500
    apps of up to 12 components, as google) and the replay of both
    fixtures in tests/data, through run_sim_scan on the card for up to
    FAMILY_TICKS ticks: with gp forecasts (bucketed), one GP program
    launch per tick and finite series, every chunk sync-free; and with
    oracle forecasts, card (graphs) against CPU (eager), summaries and
    per-tick series equal, as phase 4b."""
    import torch
    data = Path(__file__).resolve().parent / "tests" / "data"
    cells = [(name, scenarios.make_config(name)) for name in FAMILIES]
    cells += [(f"replay {p}", scenarios.ReplayConfig(path=str(data / f"{p}_tiny.csv"), preset=p))
              for p in ("alibaba", "azure")]
    guard = strict_chunks(step)
    try:
        for name, wl in cells:
            tr = scenarios.build_trace(wl)
            cfg = SimConfig(workload=wl, max_ticks=FAMILY_TICKS)
            n0 = gp_forecast.gp_fit_forecast.launches
            entries = set(map(id, step._GRAPHS.values()))
            t = time.perf_counter()
            res = step.run_sim_scan(cfg, device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            ticks = res.timings["ticks"]
            # a new entry (new shapes) runs one eager warm-up tick first
            new = sum(id(e) not in entries for e in step._GRAPHS.values())
            launches = gp_forecast.gp_fit_forecast.launches - n0
            assert launches == ticks + new, (name, launches, ticks, new)
            assert all(np.isfinite(res.util_mem)) and max(res.n_running) > 0, name
            ocfg = dataclasses.replace(cfg, forecaster="oracle")
            t_o = time.perf_counter()
            a = step.run_sim_scan(ocfg, device="cuda")
            t_o = time.perf_counter() - t_o
            b = step.run_sim_scan(ocfg, device="cpu")
            assert run_series(a) == run_series(b), f"{name}: oracle card != cpu"
            s = res.summary()
            log(f"  {name}: {tr.n_apps} apps x {tr.max_components} components; gp "
                f"{ticks} ticks in {t:.3f} s ({ticks / t:.3f} ticks/s, capture included "
                f"where the shapes are new), {launches} GP launches ({new} in a warm-up "
                f"tick), completed "
                f"{s['completed']}, forecast rows {res.forecast_rows}; oracle card == cpu "
                f"over {a.timings['ticks']} ticks (card {t_o:.3f} s), completed "
                f"{a.summary()['completed']}")
    finally:
        chunks = guard.stop()
    log(f"  {chunks} chunks on the card and the CPU, every one sync-free")


# ----------------------------------------------------------------------
# leap ticks (the idle-tick skip) and the ARIMA forecaster
# ----------------------------------------------------------------------

LEAP_DTYPES = (np.int32, bool, bool, np.float32, bool, np.float32, np.int32)
ARIMA_CPU_TICKS = 160   # the ARIMA device-engine run held card against CPU
GP_CPU_TICKS = 320      # the GP device-engine run held card against CPU


def gap_config(SimConfig, ClusterConfig, scenarios, **over):
    """The reference's gap-dominated cell (benchmarks/engine.py:134-141): a
    few background apps hours apart and three flash events of short apps,
    so most ticks have an empty cluster and an empty queue."""
    return SimConfig(
        cluster=ClusterConfig(n_hosts=2, max_running_apps=16),
        workload=scenarios.make_config(
            "flashcrowd", n_apps=24, max_components=4, seed=0, burst_frac=0.75, n_events=3,
            event_gap_s=2.0, mean_gap=10_800.0, min_runtime=120.0, max_runtime=600.0,
            bg_max_runtime=900.0),
        policy="pessimistic", forecaster="persist", max_ticks=20_000, **over)


def leap_member(A, N, tick, *, gap, left, t0=600.1, busy=False, queued=False,
                all_arrived=False, all_done=False):
    """One member's (slot_gid, queued, arrived, submit, done, t, left): ten
    apps arrived and done by t0, the next arriving ``gap`` ticks and a
    half later, the rest after it; optionally a busy slot, a queued app,
    every app arrived (next arrival +inf), every app done."""
    submit = np.concatenate([np.linspace(0, t0 - 1, 10), t0 + (gap + 0.5) * tick
                             + np.arange(N - 10) * 7 * tick]).astype(np.float32)
    arrived = np.arange(N) < 10
    arrived |= all_arrived
    done = np.arange(N) < 10
    if all_arrived:
        done |= np.arange(N) < N - 1        # one app left, neither queued nor running
    done |= all_done
    slot = np.full(A, -1)
    if busy:
        slot[3] = 11
    q = np.zeros(N, bool)
    q[12] = queued
    return slot, q, arrived, submit, done, np.float32(t0), left


LEAP_OPS_PER_PASS = 16   # a pass of the closed-form count: its adds, compares, products, divisions


def leap_closed_form(t, tick, next_sub, left) -> tuple[np.float32, int, int]:
    """leap_skip's count for one idle member, step by step as
    ``csrc/leap.cu::skip`` takes it (one float32 binade at a time; the
    argument is in that file's header): the new clock, the ticks skipped
    and the passes of the loop."""
    f32 = np.float32
    t, tick, next_sub = f32(t), f32(tick), f32(next_sub)
    n = passes = 0
    jumps = bool(tick > 0) and bool(np.isfinite(tick))
    with np.errstate(over="ignore", invalid="ignore"):
        while n < left:
            passes += 1
            bits = int(np.array(t).view(np.uint32))
            e = bits >> 23
            if jumps and 1 <= e <= 254:             # t > 0 and normal
                K = (bits & 0x7FFFFF) | 0x800000
                dr = float(tick) * 2.0 ** (150 - e)    # tick / ulp(t), exact
                if dr < 2.0**24:
                    m = np.floor(dr)
                    if not (dr - m == 0.5 and K & 1):
                        d = int(np.rint(dr))
                        if d == 0:                    # the clock never moves
                            if next_sub > t:
                                n = left
                            break
                        kbin = (0xFFFFFF - K) // d
                        ns = int(np.array(next_sub).view(np.uint32))
                        karr = 0
                        if next_sub > t:
                            karr = kbin if ns >> 23 > e else (((ns & 0x7FFFFF) | 0x800000)
                                                              - K - 1) // d
                        j = min(left - n, kbin, karr)
                        K += j * d
                        n += j
                        t = np.array((e << 23) | (K & 0x7FFFFF), np.uint32).view(f32)[()]
                        if n >= left:
                            break
            nt = f32(t + tick)                        # the reference's own step
            if not next_sub > nt:
                break
            if nt == t:
                n = left
                break
            t = nt
            n += 1
    return t, n, passes


def leap_clocks():
    """(name, t, tick, next arrival, budget) of the crafted idle members:
    clocks across binades and at their edges, ticks of 60, 0.1, 1/3 and
    1e-3, half-ulp ties from even and odd significands, a clock so large
    that t + tick rounds back to t, t = 0, subnormal and negative clocks,
    the next arrival on the tick grid, just past it and at +inf, budgets
    of 0 to 20,000."""
    f32, inf = np.float32, float("inf")
    u20 = 2.0**-3                             # the ulp of [2^20, 2^21)
    out = [("t = 0, tick 60, 20,000 ticks", 0.0, 60.0, inf, 20_000),
           ("t = 600.1, tick 60, 20,000 ticks", 600.1, 60.0, inf, 20_000),
           ("t = 600.1, tick 0.1, 20,000 ticks", 600.1, 0.1, inf, 20_000),
           ("t = 3, tick 1/3, 20,000 ticks", 3.0, 1 / 3, inf, 20_000),
           ("t = 1e-3, tick 1e-3, 20,000 ticks", 1e-3, 1e-3, inf, 20_000),
           ("t = 2^30, tick 60: t + tick == t", 2.0**30, 60.0, inf, 20_000),
           ("t = 2^30, tick 60, next arrival at t", 2.0**30, 60.0, 2.0**30, 20_000),
           ("a tie from an even significand", 2.0**20, 1.5 * u20, inf, 5_000),
           ("a tie from an odd significand", 2.0**20 + u20, 2.5 * u20, inf, 5_000),
           ("a half-ulp tick from an odd significand: one step", 2.0**20 + u20, 0.5 * u20,
            inf, 100),
           ("a half-ulp tick from an even significand: the clock stays", 2.0**20, 0.5 * u20,
            2.0**21, 100),
           ("t at a binade's top", 2.0**24 - 1, 1.0, inf, 300),
           ("subnormal clock and tick", 2.0**-140, 2.0**-142, inf, 600),
           ("a negative clock", -3600.0, 60.0, 1e9, 500),
           ("the next arrival on the tick grid", 600.0, 60.0, 600.0 + 225 * 60.0, 20_000),
           ("the next arrival just past the grid", 600.0, 60.0,
            float(np.nextafter(f32(600.0 + 225 * 60.0), f32(inf))), 20_000),
           ("budget 0", 600.0, 60.0, inf, 0), ("budget 1", 600.0, 60.0, inf, 1)]
    return [(name, f32(t), f32(tick), f32(ns), left) for name, t, tick, ns, left in out]


def leap_clock_member(A, N, t, next_sub, left):
    """An idle member's leap_skip inputs with clock ``t`` and the next
    arrival at ``next_sub``: empty slots and queue, apps 0..N-2 arrived and
    done, app N-1 not done (arrived when ``next_sub`` is +inf, else
    arriving then)."""
    slot = np.full(A, -1)
    arrived = np.arange(N) < N - 1
    arrived[-1] = np.isinf(next_sub)
    submit = np.linspace(0, 1, N).astype(np.float32)
    submit[-1] = next_sub
    return slot, np.zeros(N, bool), arrived, submit, np.arange(N) < N - 1, t, left


def window_leap_members(rng, A, W=256, S=16, tick=60.0):
    """leap_skip's inputs as a streamed window of W rows holds them: the
    loaded apps in rows of a seeded order (submit times unsorted), the
    free rows' sentinel (submit +inf, arrived and done, not queued); half
    the members idle with their next arrival a few ticks on, a quarter
    with every loaded app arrived."""
    slot = np.full((S, A), -1)
    slot[S // 2:, :3] = rng.integers(0, W, (S - S // 2, 3))
    t = (rng.integers(10, 400, S) + np.where(rng.random(S) < 0.3, 0.37, 0.0)) * tick
    submit = t[:, None] + rng.uniform(-300, 40, (S, W)) * tick
    arrived = submit <= t[:, None]
    done = arrived & (rng.random((S, W)) < 0.9)
    done[:S // 4] |= arrived[:S // 4]
    arrived[:S // 4] = True
    free = rng.random((S, W)) < 0.4
    free &= ~np.any(np.arange(W)[None, :, None] == slot[:, None, :], -1)
    submit = np.where(free, np.inf, submit).astype(np.float32)
    arrived, done = arrived | free, done | free
    queued = np.zeros((S, W), bool)
    left = rng.choice([1, 5, 40, 1000], S)
    return slot, queued, arrived, submit, done, t, left


def leap_cases(A=128, N=500):
    """(name, (slot_gid, queued, arrived, submit, done, t, left), tick, the
    leads expected or None): seeded members at the main path's widths,
    edge members, and the crafted clocks of ``leap_clocks`` (a case per
    tick), whose leads are the closed form's."""
    cases = []
    rng = np.random.default_rng(0)
    for tick in (60.0, 0.1):
        S = 64
        slot = np.where(rng.random((S, A)) < 0.01, rng.integers(0, N, (S, A)), -1)
        slot[: S // 2] = -1
        queued = rng.random((S, N)) < 0.002
        queued[: S // 3] = False
        submit = np.sort(rng.uniform(0, 4 * N * tick, (S, N)), 1)
        t = (rng.integers(0, 4 * N, S) + np.where(rng.random(S) < 0.3, 0.37, 0.0)) * tick
        arrived = submit <= t[:, None]
        arrived[::7] = True
        done = arrived & (rng.random((S, N)) < 0.7)
        done[::11] = True
        left = rng.choice([0, 1, 2, 5, 40, 1000], S)
        cases.append((f"64 seeded members, tick {tick:g}",
                      (slot, queued, arrived, submit, done, t, left), tick, None))
    cases.append(("a streamed window: rows re-keyed, free rows",
                  window_leap_members(rng, A), 60.0, None))
    for name, members, leads in (
            ("every app arrived (next arrival +inf), budgets 7 and 1000",
             [dict(gap=20, left=7, all_arrived=True), dict(gap=20, left=1000, all_arrived=True)],
             [7, 1000]),
            ("budgets 0 and 1", [dict(gap=20, left=0), dict(gap=20, left=1)], [0, 1]),
            ("budget out mid-gap", [dict(gap=20, left=5)], [5]),
            ("a 3-member cohort: a gap, a busy slot, every app done",
             [dict(gap=12, left=1000), dict(gap=12, left=1000, busy=True),
              dict(gap=12, left=1000, all_done=True)], [12, 0, 0]),
            ("a queued app", [dict(gap=12, left=1000, queued=True)], [0])):
        cols = list(zip(*(leap_member(A, N, 60.0, **m) for m in members)))
        cases.append((name, tuple(np.stack(c) for c in cols), 60.0, leads))
    by_tick: dict = {}
    for _, t, tick, ns, left in leap_clocks():
        by_tick.setdefault(float(tick), []).append((t, tick, ns, left))
    for tick, clocks in by_tick.items():
        cols = list(zip(*(leap_clock_member(A, N, t, ns, left) for t, _, ns, left in clocks)))
        leads = [leap_closed_form(*c)[1] for c in clocks]
        cases.append((f"crafted clocks, tick {tick!r}", tuple(np.stack(c) for c in cols), tick,
                      leads))
    return cases


def check_leap(leap, ref) -> float:
    """Phase 3: the idle-tick skip kernel against ref.leap_skip on the
    card, bit for bit (the clock as int32 bits, the skipped ticks)."""
    import torch
    for name, args, tick, leads in leap_cases():
        cpu = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in zip(args, LEAP_DTYPES)]
        want = ref.leap_skip(*cpu, tick)
        got = [g.cpu() for g in leap.leap_skip(*(a.cuda() for a in cpu), tick)]
        assert torch.equal(got[0].view(torch.int32), want[0].view(torch.int32)), name
        assert torch.equal(got[1], want[1]), name
        if leads is not None:
            assert got[1].tolist() == leads, (name, got[1].tolist(), leads)
        log(f"  leap_skip, {name}: kernel == plain bit for bit; skipped ticks "
            f"{got[1].tolist() if leads else f'{int(got[1].sum())} over {len(got[1])} members'}")
    return 0.0


def arima_windows(n=3072, T=24, seed=0):
    """(n, T) seeded windows and valid masks: random walks, constants,
    trends, sines, AR(1) series and noise at several scales, a third of
    them young (their first samples not seen yet)."""
    rng = np.random.default_rng(seed)
    t = np.arange(T)
    ar = np.zeros((n, T))
    for k in range(1, T):
        ar[:, k] = rng.uniform(-0.9, 0.9, n) * ar[:, k - 1] + rng.normal(size=n)
    kinds = np.stack([np.cumsum(rng.normal(size=(n, T)), 1),
                      np.repeat(rng.uniform(0, 4, (n, 1)), T, 1),
                      rng.uniform(-1, 1, (n, 1)) * t + rng.normal(scale=0.1, size=(n, T)),
                      rng.uniform(1, 3, (n, 1)) * np.sin(t / rng.uniform(2, 5, (n, 1)))
                      + rng.uniform(0, 6, (n, 1)),
                      ar, rng.uniform(0, 3, (n, T))])
    w = (kinds[np.arange(n) % 6, np.arange(n)] * 10.0 ** rng.integers(-2, 3, (n, 1)))
    v = np.ones((n, T), bool)
    young = rng.integers(1, T - 3, n)
    v[np.arange(T)[None, :] < np.where(np.arange(n) % 3 == 0, young, 0)[:, None]] = False
    w[~v] = 0.0
    return w.astype(np.float32), v


def check_arima(arima_forecast, ref, ARIMAConfig) -> float:
    """Phase 3: the ARIMA kernel against ref.arima_forecast on the card
    (the plain version's torch ops on the same CUDA tensors), on 3,072
    seeded windows without a mask and with a third of the rows ready:
    every output bit equal (the kernel makes the plain version's IEEE
    operations in its order; both logarithms are CUDA's double log);
    the maximum absolute error is printed."""
    import torch
    w, v = arima_windows()
    tw, tv = torch.as_tensor(w).cuda(), torch.as_tensor(v).cuda()
    ready = torch.as_tensor(np.random.default_rng(1).random(len(w)) < 1 / 3).cuda()
    err = 0.0
    for name, mask in (("no mask", None), (f"{int(ready.sum())} ready", ready)):
        got = arima_forecast.arima_forecast(tw, tv, 3, ARIMAConfig(), mask)
        want = ref.arima_forecast(tw, tv, 3, ARIMAConfig(), mask)
        torch.cuda.synchronize()
        e = max(float((g - r).abs().max()) for g, r in zip(got, want))
        same = all(torch.equal(g.view(torch.int32), r.view(torch.int32))
                   for g, r in zip(got, want))
        log(f"  arima_forecast, 3,072 windows, {name}: max abs error {e:.3e} "
            f"({'every bit equal' if same else 'bits differ'})")
        assert same, name
        if mask is not None:
            assert not any(g[~mask].any() for g in got), "unmarked rows not zero"
        err = max(err, e)
    best = ref.arima_select(tw, tv, 3, ARIMAConfig())[2].cpu()
    log(f"  orders chosen (candidate index: rows): "
        f"{dict(sorted(collections.Counter(best.tolist()).items()))}")
    return err


# crafted ARIMA cases (name: config overrides), held kernel against plain
# on the card (phase 3, tests/test_torch_kernels_hopper.py) and, those at
# the default orders and T = 24, plain against the reference on the CPU
# (tests/test_torch_arima.py)
ARIMA_CRAFTED = {
    "white noise (an order that is not fitted wins)": {},
    "near-deterministic sines and AR(2) (the fitted order wins)": {},
    "valid counts at the fallback's edge (9 to 12 of 24, some with holes)": {},
    "scattered holes in the valid masks": {},
    "constant, zero and -0 windows": {},
    "every row ready": {},
    "no row ready": {},
    "no MA lags (max_q = 0: no stage-1 fit)": {"max_q": 0},
    "small orders (max_p = 1, max_q = 1, max_d = 0, long_ar = 3)": {
        "max_p": 1, "max_q": 1, "max_d": 0, "long_ar": 3},
    "MA only (max_p = 0)": {"max_p": 0},
    "windows of 40 samples (two ballots of samples)": {},
}


def arima_crafted(name, n=256, seed=11):
    """Crafted case ``name`` of ARIMA_CRAFTED: (windows (n, T) float32,
    valid (n, T) bool, ready (n,) bool or None)."""
    rng = np.random.default_rng(seed + list(ARIMA_CRAFTED).index(name))
    T = 40 if name.startswith("windows of 40") else 24
    t = np.arange(T)
    scale = 10.0 ** rng.integers(-2, 4, (n, 1))
    w = rng.normal(size=(n, T)) * scale + rng.uniform(-5, 5, (n, 1)) * scale
    v = np.ones((n, T), bool)
    ready = None
    sines = (rng.uniform(1, 3, (n, 1)) * np.sin(t / rng.uniform(2, 6, (n, 1))
                                                + rng.uniform(0, 6, (n, 1))))
    ar = np.zeros((n, T))
    ar[:, :2] = rng.normal(size=(n, 2))
    for k in range(2, T):
        ar[:, k] = 1.6 * ar[:, k - 1] - 0.8 * ar[:, k - 2]
    smooth = (np.where(np.arange(n)[:, None] % 2 == 0, sines, ar)
              + rng.normal(scale=1e-4, size=(n, T))) * scale
    if name.startswith("near-deterministic"):
        w = smooth
    elif ARIMA_CRAFTED[name] or T != 24:       # other orders or widths: half of each
        w = np.where(np.arange(n)[:, None] % 4 < 2, w, smooth)
    elif name.startswith("valid counts"):
        keep = rng.choice([0, 1, 9, 10, 11, 12], n)
        for i in range(n):
            cells = (np.arange(T - keep[i], T) if i % 2 == 0
                     else rng.choice(T, keep[i], replace=False))
            v[i] = False
            v[i, cells] = True
    elif name.startswith("scattered holes"):
        v = rng.random((n, T)) > rng.choice([0.05, 0.2, 0.4], (n, 1))
    elif name.startswith("constant"):
        w = np.repeat(rng.choice([0.0, -0.0, 1.0, -3.5, 1e6], (n, 1)), T, 1)
        w[::4, ::3] = -0.0
    elif name == "every row ready":
        ready = np.ones(n, bool)
    elif name == "no row ready":
        ready = np.zeros(n, bool)
    w = np.where(v, w, 0.0).astype(np.float32)
    return w, v, ready


def check_arima_crafted(arima_forecast, ref, ARIMAConfig) -> None:
    """Phase 3: the ARIMA kernel against its plain version on the card on
    every crafted case of ARIMA_CRAFTED, every output bit equal; prints
    which orders won (candidate index: rows)."""
    import torch
    for name, over in ARIMA_CRAFTED.items():
        w, v, ready = arima_crafted(name)
        cfg = ARIMAConfig(**over)
        tw, tv = torch.as_tensor(w).cuda(), torch.as_tensor(v).cuda()
        mask = None if ready is None else torch.as_tensor(ready).cuda()
        got = arima_forecast.arima_forecast(tw, tv, 3, cfg, mask)
        want = ref.arima_forecast(tw, tv, 3, cfg, mask)
        assert all(_same(g, r) for g, r in zip(got, want)), f"arima_forecast, {name}"
        best = ref.arima_select(tw, tv, 3, cfg)[2].cpu()
        log(f"  arima_forecast, {name}: kernel == plain, every bit; orders chosen "
            f"{dict(sorted(collections.Counter(best.tolist()).items()))}")


DECISIONS = ("completed", "failure_events", "oom_kills", "full_preemptions",
             "partial_preemptions")
SERIES = ("util_cpu", "util_mem", "slack_cpu", "slack_mem")


def card_vs_cpu(step, cfg, what, *, strict: bool, engine=None):
    """One device-engine run (``engine(cfg, device=...)`` where given: the
    host engine's run_sim) on the card (graphs) and on the CPU (eager):
    equal summaries and per-tick series, or what differs: whether the
    decisions are equal (occupancy every tick, turnarounds, failed apps,
    the event counters), and the first tick where they or a float series
    differ, with the series' largest relative difference.  ``strict``
    runs must be equal (the oracle's, and ARIMA's, whose kernel gives
    its plain version's bits: decisions are discrete, the safeguard
    exact, the metric sums exact float64 sums), and a difference fails
    the phase; otherwise it is printed as a finding (the GP's forecasts
    come from the card's kernel and from the plain version, whose float
    sums may differ in the last bits).  Returns the card's run."""
    engine = step.run_sim_scan if engine is None else engine
    t = time.perf_counter()
    a = engine(cfg, device="cuda")
    t_gpu = time.perf_counter() - t
    t = time.perf_counter()
    b = engine(cfg, device="cpu")
    t_cpu = time.perf_counter() - t
    sa, sb = a.summary(), b.summary()
    if run_series(a) == run_series(b):
        log(f"  {what}: card == cpu over {a.timings['ticks']} ticks, summaries and per-tick "
            f"series (card {t_gpu:.3f} s, cpu {t_cpu:.3f} s); summary {json.dumps(sa)}")
        return a
    same = (a.n_running == b.n_running and a.turnaround == b.turnaround
            and a.failed_apps == b.failed_apps and all(sa[k] == sb[k] for k in DECISIONS))
    occupancy = next((k for k, (x, y) in enumerate(zip(a.n_running, b.n_running)) if x != y),
                     None)
    firsts, rel = {}, {}
    for name in SERIES:
        x, y = np.asarray(getattr(a, name)), np.asarray(getattr(b, name))
        n = min(len(x), len(y))
        d = np.nonzero(x[:n] != y[:n])[0]
        if len(d):
            firsts[name] = int(d[0])
            rel[name] = float(np.max(np.abs(x[:n] - y[:n]) / np.maximum(np.abs(y[:n]), 1e-30)))
    diff = {k: (sa[k], sb[k]) for k in sa if json.dumps(sa[k]) != json.dumps(sb[k])}
    decisions = ("equal (occupancy, turnarounds, failed apps, event counters)" if same
                 else "differ")
    finding = (f"{what}: card != cpu over {a.timings['ticks']} ticks; decisions {decisions}"
               f"; first tick of different occupancy {occupancy}; series that differ, from tick "
               f"{json.dumps(firsts)}, largest relative difference {json.dumps(rel)}; summary "
               f"differences (card, cpu) {json.dumps(diff)} "
               f"(card {t_gpu:.3f} s, cpu {t_cpu:.3f} s)")
    assert not strict, finding
    log(f"  FINDING {finding}")
    return a


def find_entry(step, cfg):
    """The graph entry of ``cfg``'s config key at the 32-tick chunk, for a
    solo run of its workload's shapes."""
    wl = cfg.workload
    (entry,) = [e for k, e in step._GRAPHS.items()
                if k[0] == step._cfg_key(cfg) and k[1] == 32
                and k[2][:4] == (1, cfg.cluster.max_running_apps, wl.max_components,
                                 wl.n_apps)]
    return entry


def graph_census(entry, replays_before, launches) -> dict:
    """Replays since ``replays_before`` x each counted wrapper's kernel
    nodes in the graph replayed (phase 5b's census), for the wrappers in
    ``launches``."""
    ran = {n: g.replays - replays_before.get(n, 0) for n, g in entry.graphs.items()}
    nodes = {n: wrapper_nodes(graph_nodes(entry.graphs[n].graph)[1]) for n, r in ran.items()
             if r}
    return {k: sum(r * nodes[n][k] for n, r in ran.items() if r) for k in launches}


def kernels_per_step(entry) -> float:
    """Kernel nodes per tick (per leap step under leap) of an entry's
    full-chunk graph."""
    nodes, _ = graph_nodes(entry.graphs[32].graph)
    return nodes.get("kernel", 0) / 32


def run_leap(step, scenarios, SimConfig, ClusterConfig, leap) -> tuple[int, dict]:
    """Phase 5e: leap ticks on the card through replayed graphs, bit for
    bit against uniform ticks: google and the four parametric families at
    their default 500 apps (gp), capped at FAMILY_TICKS, and the gap cell
    to completion, timed in turns (leap, uniform, uniform, leap) after
    both are captured.  Prints ticks/s (simulated ticks over the wall),
    the share of ticks skipped and the kernels a leap step holds against
    a uniform tick's.  The gap cell's last leap run is leap's main path:
    leap_skip's count is set to 0 just before it and read just after,
    and held to replays x its kernel nodes.  Returns that count and the
    gap cell's longest idle state for phase 8."""
    import torch
    guard = strict_chunks(step)
    rec = record_runs(step)
    try:
        cells = [("google", SimConfig(max_ticks=FAMILY_TICKS))]
        cells += [(n, SimConfig(workload=scenarios.make_config(n), max_ticks=FAMILY_TICKS))
                  for n in FAMILIES]
        for name, cfg in cells:
            out = {}
            for mode, c in (("uniform", cfg), ("leap", dataclasses.replace(cfg, leap=True))):
                t = time.perf_counter()
                out[mode] = step.run_sim_scan(c, device="cuda")
                torch.cuda.synchronize()
                out[mode].timings["wall"] = time.perf_counter() - t
            u, lp = out["uniform"], out["leap"]
            assert run_series(u) == run_series(lp), f"{name}: leap != uniform on the card"
            assert u.forecast_rows["rows_ready"] == lp.forecast_rows["rows_ready"], name
            lead = int(rec.metrics[-1]["lead"].sum())
            ticks = len(lp.n_running)
            log(f"  {name}: leap == uniform on the card over {ticks} ticks (series, "
                f"summaries, rows_ready); {lp.timings['steps']} leap steps, {lead} ticks "
                f"skipped ({lead / ticks:.2%}); uniform {ticks / u.timings['wall']:.3f}, leap "
                f"{ticks / lp.timings['wall']:.3f} ticks/s (captures included)")
        gap = gap_config(SimConfig, ClusterConfig, scenarios)
        lgap = dataclasses.replace(gap, leap=True)
        u0 = step.run_sim_scan(gap, device="cuda")
        l0 = step.run_sim_scan(lgap, device="cuda")
        assert run_series(u0) == run_series(l0), "gap cell: leap != uniform on the card"
        ticks = len(l0.n_running)
        lead = int(rec.metrics[-1]["lead"].sum())
        lentry, uentry = find_entry(step, lgap), find_entry(step, gap)
        walls = {"uniform": [], "leap": []}
        for mode in ("leap", "uniform", "uniform", "leap"):
            if mode == "leap" and walls["leap"]:
                before = {n: g.replays for n, g in lentry.graphs.items()}
                leap.reset_launch_counts()
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = step.run_sim_scan(lgap if mode == "leap" else gap, device="cuda")
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t)
            assert run_series(res) == run_series(u0), mode
        launches = leap.leap_skip.launches
        in_graph = graph_census(lentry, before, {"leap_skip": launches})["leap_skip"]
        steps = l0.timings["steps"]
    finally:
        rec.stop()
        chunks = guard.stop()
    k_leap, k_uni = kernels_per_step(lentry), kernels_per_step(uentry)
    log(f"  gap cell (24 apps x 4, 2 hosts, persist): leap == uniform on the card to "
        f"completion, {ticks} ticks, {l0.summary()['completed']} apps completed; {steps} "
        f"leap steps, {lead} ticks skipped ({lead / ticks:.2%})")
    log("  gap cell ticks/s in turns (leap, uniform, uniform, leap): " + "; ".join(
        f"{m} " + ", ".join(f"{ticks / w:.3f}" for w in ws) for m, ws in walls.items())
        + f"; leap / uniform {min(walls['uniform']) / min(walls['leap']):.3f}x")
    for line in describe_graphs(lentry):
        log(f"  leap graph {line}")
    log(f"  kernels per leap step {k_leap:.3f} against {k_uni:.3f} per uniform tick "
        f"(+{k_leap - k_uni:.3f}: the skip, the run gate, the budget and the per-field "
        f"where); leap_skip launches {launches} in the last leap run = replays x kernel "
        f"nodes {in_graph} = its steps {steps}; {chunks} chunks sync-free")
    assert launches == in_graph == steps, (launches, in_graph, steps)
    assert lead > ticks // 2, (lead, ticks)
    return launches, {"steps": steps, "ticks": ticks, "kernels_per_step": k_leap,
                      "kernels_per_tick": k_uni}


def gap_idle_state(scenarios, SimConfig, ClusterConfig):
    """The gap cell's longest idle stretch as leap_skip's inputs (S = 1):
    every app before the longest gap between arrivals arrived and done,
    the clock on the tick grid past the last of them, a budget of
    max_ticks; returns (args on the host, tick, the gap in ticks)."""
    cfg = gap_config(SimConfig, ClusterConfig, scenarios)
    tr = scenarios.build_trace(cfg.workload)
    submit = np.asarray(tr.submit, np.float32)
    k = int(np.argmax(np.diff(submit)))
    tick = cfg.cluster.tick
    t = np.float32(np.ceil(submit[k] / tick) * tick)
    arrived = submit <= t
    args = (np.full((1, cfg.cluster.max_running_apps), -1, np.int32),
            np.zeros((1, len(submit)), bool), arrived[None], submit[None], arrived[None],
            np.array([t], np.float32), np.array([cfg.max_ticks], np.int32))
    return args, tick, float((submit[k + 1] - t) / tick)


def run_arima(step, SimConfig, run_sim, ARIMAForecaster, arima_forecast, shaper, sched,
              fma, gp_forecast, gp_summary) -> tuple[int, np.ndarray]:
    """Phase 5f: the ARIMA forecaster on both engines on the card.  The host
    engine, run_sim(SimConfig(forecaster="arima")) capped at
    MAIN_PATH_TICKS: one arima_forecast launch per forecasting tick.
    The device engine, run_sim_scan(SimConfig(forecaster="arima")) to
    completion through replayed graphs (a 64-tick run captures first):
    one launch a tick of arima_forecast and of the four sim kernels, the
    counts (set to 0 just before, read just after) equal to replays x
    each wrapper's kernel nodes, every chunk sync-free; then its first
    ARIMA_CPU_TICKS ticks card against CPU.  Returns the device run's
    arima_forecast launches and the ready rows at the chunk boundary
    nearest its mean ready count, for phase 8."""
    import torch
    cfg = SimConfig(forecaster="arima", max_ticks=MAIN_PATH_TICKS)
    calls = count_calls(ARIMAForecaster, "forecast_batch")
    arima_forecast.reset_launch_counts()
    t = time.perf_counter()
    res = run_sim(cfg, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    fc_ticks = calls.stop()
    n = arima_forecast.arima_forecast.launches
    tm = res.timings
    log(f"  host engine, {tm['ticks']} ticks in {t:.3f} s ({tm['ticks'] / t:.3f} ticks/s; "
        f"forecast {tm['forecast'] / tm['ticks'] * 1e3:.3f} ms a tick): {n} arima_forecast "
        f"launches in {fc_ticks} forecasting ticks; summary {json.dumps(res.summary())}")
    assert fc_ticks > 0 and n == fc_ticks and tm["ticks"] == MAIN_PATH_TICKS, (n, fc_ticks)
    for k in ("util_cpu_mean", "util_mem_mean", "slack_cpu_mean", "slack_mem_mean"):
        assert np.isfinite(res.summary()[k]), k

    mods = (gp_forecast, shaper, sched, fma, arima_forecast)
    guard = strict_chunks(step)
    try:
        step.run_sim_scan(SimConfig(forecaster="arima", max_ticks=64), device="cuda")
        entry = find_entry(step, SimConfig(forecaster="arima"))
        before = {k: g.replays for k, g in entry.graphs.items()}
        rec = record_runs(step)
        for m in mods:
            m.reset_launch_counts()
        c0 = guard.chunks
        try:
            t = time.perf_counter()
            res = step.run_sim_scan(SimConfig(forecaster="arima"), device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter() - t
        finally:
            rec.stop()
        launches = dict(scan_launch_counts(gp_forecast, shaper, sched, fma),
                        arima_forecast=arima_forecast.arima_forecast.launches)
        chunks = guard.chunks - c0
    finally:
        guard.stop()
    in_graphs = graph_census(entry, before, launches)
    ticks = res.timings["ticks"]
    s = res.summary()
    log(f"  device engine, {ticks} ticks in {chunks} chunks, {t:.3f} s: {ticks / t:.3f} "
        f"ticks/s; kernel launches {launches} = replays x kernel nodes {in_graphs}; "
        f"forecast rows {res.forecast_rows}")
    log(f"  summary {json.dumps(s)}")
    log("  against the GP run of phase 5b (arima, gp): " + ", ".join(
        f"{k} ({s[k]:.4g}, {gp_summary[k]:.4g})" for k in
        ("turnaround_mean", "failed_frac", "oom_kills", "util_mem_mean", "slack_mem_mean")))
    assert launches == in_graphs, (launches, in_graphs)
    assert launches["arima_forecast"] == ticks and launches["gp_fit_forecast"] == 0, launches
    assert all(launches[k] == ticks for k in SCAN_KERNELS), launches
    assert s["completed"] == 500 and np.isfinite(s["util_mem_mean"]), s
    p = gp_profile(step, SimConfig(forecaster="arima"), kernel="arima_forecast_kernel")
    log(f"  first {PROFILE_TICKS} ticks under torch.profiler: arima_forecast "
        f"{p['us_per_launch']:.3f} us per launch over {p['launches']} launches, "
        f"{p['share']:.2%} of device time; series per launch mean {p['series'][0]:.3f}; device "
        f"busy {p['busy']:.2%} of the wall, {p['ms_per_tick']:.4f} ms per tick")
    mean, _, _ = series_per_launch(rec.metrics[0])
    near = min(rec.ready, key=lambda r: abs(2 * int(r.sum()) - mean))
    card_vs_cpu(step, SimConfig(forecaster="arima", max_ticks=ARIMA_CPU_TICKS),
                f"ARIMA, first {ARIMA_CPU_TICKS} ticks", strict=True)
    return launches["arima_forecast"], near


def time_leap(leap, ref, state) -> dict:
    """leap_skip on the gap cell's longest idle stretch (S = 1, A = 16,
    N = 24), kernel by CUDA events against the plain version (numpy on
    the host) in turns, with its device and host time per call.  The
    bound: the inputs read once and the outputs written once over
    3.35 TB/s, against the closed-form count's operations
    (LEAP_OPS_PER_PASS a pass of its loop, ``leap_closed_form``'s passes
    on these inputs) over fp32's peak; the count runs on one thread, so
    the card cannot reach either."""
    import torch
    args, tick, gap = state
    cpu = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in zip(args, LEAP_DTYPES)]
    gpu = [a.cuda() for a in cpu]
    lead = int(ref.leap_skip(*cpu, tick)[1][0])

    def host_ms():
        t = time.perf_counter()
        for _ in range(20):
            ref.leap_skip(*cpu, tick)
        return (time.perf_counter() - t) / 20 * 1e3
    kern = lambda: leap.leap_skip(*gpu, tick)  # noqa: E731
    p1 = host_ms()
    k1, k2 = (cuda_time_ms(kern, iters=200, warmup=10) for _ in range(2))
    p2 = host_ms()
    dev_us = device_us_per_call(kern, "leap_skip_kernel")
    host_us = host_us_per_call(kern)
    nbytes = _nbytes(*cpu) + 8
    next_sub = np.where(args[2][0], np.float32(np.inf), args[3][0]).min()
    passes = leap_closed_form(args[5][0], tick, next_sub, int(args[6][0]))[2]
    ops = LEAP_OPS_PER_PASS * passes
    t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
    t_ops = ops / FP32_FLOP_PER_S * 1e3
    log(f"  leap_skip (the gap cell's longest idle stretch, {lead} ticks skipped of a "
        f"{gap:.1f}-tick gap, {passes} passes of the count): kernel {k1:.5f}/{k2:.5f} ms, "
        f"plain (numpy on the host) {p1:.5f}/{p2:.5f} ms; device "
        f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} per launch, "
        f"host {host_us:.3f} us per call; bound {max(t_bytes, t_ops) * 1e3:.6f} us "
        f"({nbytes} B, {ops} operations)")
    return {"leap_skip": dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                              bound_ms=max(t_bytes, t_ops), library_ms=None,
                              bound_by="bytes" if t_bytes >= t_ops else "operations")}


def arima_flops(valid, ready, cfg, H=3) -> int:
    """The operations the ARIMA function needs on these inputs (not those
    a kernel's loops make), from the valid masks of the ready series.  A series with enough samples: the
    normalisation and first difference (10 a sample and 4); for each d,
    the stage-1 long AR over its in-sample rows (the upper triangle and
    right-hand side of the 7 x 7 normal equations, a product and a sum
    each a row, the ridge, an LU solve) and the innovations of those
    rows; the one real stage-2 fit of that d, the order (max_p, d, max_q)
    (its 6 x 6 normal equations over its rows, the ridge, an LU solve,
    the residuals and their squares summed, the AIC); the other orders'
    AIC of n = 1, sigma^2 = 1e-10 (a log, a product, a sum: their stage-2
    rows are empty whatever the data); the argmin over the candidates;
    the winner's recursion and psi weights over the horizon.  A series
    with too few samples: its count and the last-value fallback."""
    P, Q, M = cfg.max_p, cfg.max_q, cfg.long_ar
    K = (cfg.max_d + 1) * ((P + 1) * (Q + 1) - 1)
    n1, n2 = M + 1, 1 + P + Q

    def lu(n):
        return sum((n - k - 1) * (1 + 2 * (n - k - 1) + 2) for k in range(n)) + n * n + n

    v = np.asarray(valid, bool)[np.asarray(ready, bool)]
    T = v.shape[1]
    fit = v.sum(1) >= M + P + 2
    v = v[fit]
    t = np.arange(T)
    total = len(v) * (10 * T + 4 + 2 * K + H * (2 * (P + Q) + 2 * P + 14))
    for d in range(cfg.max_d + 1):
        zm = v.copy() if d == 0 else np.concatenate(
            [np.zeros((len(v), 1), bool), v[:, 1:] & v[:, :-1]], 1)
        rows1 = zm & (t >= M)
        rows2 = zm & (t >= P) & (t >= Q) & (np.roll(rows1, 1, 1) if Q else True)
        r1, r2 = rows1.sum(1), rows2.sum(1)
        total += (r1 * (n1 * (n1 + 1) + 2 * n1 + 2 * n1 + 1) + n1 + lu(n1)).sum()
        total += (r2 * (n2 * (n2 + 1) + 2 * n2 + 2 * n2 + 1 + 2) + n2 + lu(n2) + 4).sum()
        total += len(v) * 3 * ((P + 1) * (Q + 1) - 2)
    return int(total + (len(fit) - len(v)) * (T + 4))


def time_arima(arima_forecast, ref, ARIMAConfig, ready_rows) -> tuple[dict, float]:
    """arima_forecast at the device engine's shape (3,072 seeded windows of
    24 samples) with the ready rows that the main ARIMA run held at a
    chunk boundary (both resources' rows), kernel by CUDA events against
    the plain version on the card in turns, with its device and host
    time per call; checked against the plain version there.  The bound:
    the larger of the bytes (the ready windows and masks read once, every
    output row written once) over 3.35 TB/s and arima_flops over fp32's
    peak.  Returns the timings and the error."""
    import torch
    w, v = arima_windows(seed=2)
    ready = torch.as_tensor(np.concatenate([ready_rows, ready_rows])).cuda()
    tw, tv = torch.as_tensor(w).cuda(), torch.as_tensor(v).cuda()
    cfg = ARIMAConfig()
    kern = lambda: arima_forecast.arima_forecast(tw, tv, 3, cfg, ready)  # noqa: E731
    plain = lambda: ref.arima_forecast(tw, tv, 3, cfg, ready)  # noqa: E731
    got, want = kern(), plain()
    torch.cuda.synchronize()
    err = max(float((g - r).abs().max()) for g, r in zip(got, want))
    assert all(torch.equal(g, r) for g, r in zip(got, want)), "arima_forecast != plain"
    ms = {"kernel": [], "plain": []}
    for k in ("kernel", "plain", "plain", "kernel"):
        ms[k].append(cuda_time_ms(kern if k == "kernel" else plain,
                                  iters=200 if k == "kernel" else 5,
                                  warmup=10 if k == "kernel" else 1))
    dev_us = device_us_per_call(kern, "arima_forecast_kernel")
    host_us = host_us_per_call(kern)
    r = ready.cpu().numpy()
    nbytes = int(r.sum()) * w.shape[1] * 5 + len(w) * (1 + 2 * 3 * 4)
    flops = arima_flops(v, r, cfg)
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S * 1e3, flops / FP32_FLOP_PER_S * 1e3
    log(f"  arima_forecast (3,072 windows, {int(r.sum())} ready as the main run held them): "
        f"kernel {'/'.join(f'{x:.5f}' for x in ms['kernel'])} ms, plain (torch on the card) "
        f"{'/'.join(f'{x:.3f}' for x in ms['plain'])} ms; device "
        f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} per launch, host "
        f"{host_us:.3f} us per call; max abs error {err:.3e}; bound "
        f"{max(t_bytes, t_ops) * 1e3:.4f} us ({nbytes} B, {flops} flop)")
    return {"arima_forecast": dict(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]),
                                   bound_ms=max(t_bytes, t_ops), library_ms=None,
                                   bound_by="bytes" if t_bytes >= t_ops else "operations")}, err


# ----------------------------------------------------------------------
# conformal calibration: calib_observe and conformal_scale
# ----------------------------------------------------------------------

CALIB_CPU_TICKS = 160   # the calibrated persist run held card against CPU
CALIB_GP_CPU_TICKS = 96   # the calibrated GP run held card against CPU (a finding)
CALIB_PROFILE_TICKS = 160   # the calibrated run's window under torch.profiler
# tie-prone scores: signed zeros, equal values, infinities and NaN
CALIB_TIES = np.array([-1.5, -0.0, 0.0, 0.0, 0.25, 0.25, 2.0, np.inf, -np.inf, np.nan],
                      np.float32)


def calib_config(CalibrationConfig, **over):
    """Phase 5g's calibration: conformal at q = 0.9, adaptive against a
    budget of 0.1, the reference's other defaults."""
    return CalibrationConfig(**{"enabled": True, "q": 0.9, "adaptive": True, "budget": 0.1,
                                **over})


def score_rings(rng, rows, cap, counts, *, ties=0.25, circular=True):
    """(rows, cap) float32 rings holding ``counts`` scores each: seeded
    normal scores, a share of the rows drawn from CALIB_TIES; circular
    rings (the device engine's) hold +inf in their unwritten cells."""
    ring = rng.normal(0.5, 1.5, (rows, cap)).astype(np.float32)
    tie = rng.random(rows) < ties
    ring[tie] = rng.choice(CALIB_TIES, (int(tie.sum()), cap))
    if circular:
        ring[np.arange(cap)[None, :] >= np.asarray(counts)[:, None]] = np.inf
    return ring


def calib_state(seed, S=1, M=1536, cap=128, pcap=1024, *, warm=False, due_share=0.35):
    """A seeded calibration state at the engine's widths (S members of R =
    2M rows; M = A*C = 1,536 at full width) as the CalibState fields in
    numpy, with this tick's usage (S, M, 2), monitor counts (S, M), and a
    deploy mask, forecast means and variances for the shaping step.
    Counts 0, below min_scores, exactly the capacity and above it (all
    above when ``warm``); about ``due_share`` of the rows come due with
    the count they are due at (more than the pool holds), some at
    another count (dropped)."""
    rng = np.random.default_rng(seed)
    R = 2 * M
    choices = [cap, cap + 1, 3 * cap + 5] if warm else [0, 3, 15, 16, cap, cap + 1, 3 * cap + 5]
    counts = rng.choice(choices, (S, R)).astype(np.int32)
    pool_count = rng.choice([0, 9, pcap, 5 * pcap + 3] if not warm else [5 * pcap + 3],
                            S).astype(np.int32)
    mon = rng.integers(0, 200, (S, M)).astype(np.int32)
    due = np.concatenate([mon, mon], 1) + (rng.random((S, R)) < 0.2).astype(np.int32)
    left = np.where(rng.random((S, R)) < due_share, 1, rng.choice([0, 2, 3], (S, R)))
    st = dict(
        ring=np.stack([score_rings(rng, R, cap, c) for c in counts]), ring_count=counts,
        pool=np.stack([score_rings(rng, 1, pcap, [c])[0] for c in pool_count]),
        pool_count=pool_count,
        mean=rng.uniform(0, 4, (S, R)).astype(np.float32),
        sigma=rng.choice([0.0, 1e-8, 0.05, 0.7], (S, R)).astype(np.float32),
        scale=rng.uniform(0.5, 4, (S, R)).astype(np.float32),
        peak=np.where(rng.random((S, R)) < 0.3, -np.inf,
                      rng.uniform(0, 5, (S, R))).astype(np.float32),
        left=left.astype(np.int32), due=due.astype(np.int32),
        q=rng.uniform(0.6, 0.95, S).astype(np.float32),
        resolved=rng.integers(0, 9999, S).astype(np.int32),
        errors=rng.integers(0, 999, S).astype(np.int32),
        dropped=rng.integers(0, 999, S).astype(np.int32),
        scale_sum=rng.uniform(0, 9999, S).astype(np.float32),
        scale_n=rng.integers(0, 9999, S).astype(np.int32))
    tick = dict(usage=rng.uniform(0, 6, (S, M, 2)).astype(np.float32), mon_count=mon,
                active=np.arange(S) != 2, deploy=rng.random((S, M)) < 0.5,
                fmean=rng.uniform(0, 4, (S, R)).astype(np.float32),
                var=rng.choice([-1e-7, 0.0, 0.01, 3.0], (S, R)).astype(np.float32))
    return st, tick


CALIB_STATE = ("ring", "ring_count", "pool", "pool_count", "mean", "sigma", "scale", "peak",
               "left", "due", "q", "resolved", "errors", "dropped")
OBSERVE_OUT = ("ring", "ring_count", "pool", "pool_count", "peak", "left", "q", "resolved",
               "errors", "dropped")
BEGIN_STATE = ("mean", "sigma", "scale", "peak", "left", "due", "scale_sum", "scale_n")


def observe_args(st, tick, dev):
    import torch
    return [torch.as_tensor(st[k]).to(dev) for k in CALIB_STATE] + [
        torch.as_tensor(tick[k]).to(dev) for k in ("usage", "mon_count", "active")]


def scales_args(st, tick, dev, k2=3.0):
    import torch
    T = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    return ([T(st[k]) for k in ("ring", "ring_count", "pool", "pool_count", "q")] + [k2]
            + [T(tick[k]) for k in ("deploy", "fmean", "var", "mon_count")]
            + [T(st[k]) for k in BEGIN_STATE])


def calib_cases(CalibrationConfig):
    """(name, state, tick, config) of phase 3: seeded full-width members,
    warm and young; a tick resolving more scores than the pool holds; the
    pool off; adaptive off; a 3-member cohort (one of them done)."""
    cfg = calib_config(CalibrationConfig)
    cases = []
    for seed, warm in ((0, False), (1, True)):
        st, tick = calib_state(seed, warm=warm)
        cases.append((f"full width (3,072 rows), seed {seed}, "
                      f"{'warm rings' if warm else 'counts 0 to 3 x capacity'}", st, tick, cfg))
    st, tick = calib_state(2, due_share=0.9)
    cases.append(("full width, 90% of the rows due (more than the pool's 1,024)", st, tick, cfg))
    cases.append(("the pool off, adaptive off", *calib_state(3),
                  calib_config(CalibrationConfig, pool=False, adaptive=False)))
    small = calib_config(CalibrationConfig, capacity=16, pool_capacity=8, min_scores=4)
    cases.append(("a 3-member cohort (the third done), capacity 16, pool 8",
                  *calib_state(4, S=3, M=200, cap=16, pcap=8), small))
    for M in (10, 20):   # R = 20: one sequential sum; R = 40: windows offset by 12
        cases.append((f"R = {2 * M} rows, 2 members", *calib_state(5 + M, S=2, M=M, cap=16,
                                                                  pcap=8), small))
    cases.append(("capacity 256 (two blocks a row)", *calib_state(9, M=512, cap=256),
                  calib_config(CalibrationConfig, capacity=256)))
    return cases


def _same(got, want) -> bool:
    import torch
    g, w = got.cpu(), want.cpu()
    if g.dtype == torch.float32:
        g, w = g.view(torch.int32), w.view(torch.int32)
    return torch.equal(g, w)


def check_calib(calib, ref, CalibrationConfig) -> dict:
    """Phase 3: calib_observe and conformal_scale (its generic launch on
    rolled and circular rings, and the engine's shaping step) against
    their plain versions on the card, every output bit for bit."""
    import torch
    kw = lambda c: dict(pool_on=c.pool, adaptive=c.adaptive, gamma=c.gamma,  # noqa: E731
                        budget=c.budget, q_min=c.q_min, q_max=c.q_max)
    for name, st, tick, cfg in calib_cases(CalibrationConfig):
        cpu = observe_args(st, tick, "cpu")
        want = ref.calib_observe(*cpu, **kw(cfg))
        got = calib.calib_observe(*(a.cuda() for a in cpu), **kw(cfg))
        for k, g, w in zip(OBSERVE_OUT, got, want):
            assert _same(g, w), f"calib_observe, {name}: {k} differs"
        n_res = (want[7] - cpu[11]).tolist()
        skw = dict(min_scores=cfg.min_scores, pool_on=cfg.pool, horizon=3)
        cpu = scales_args(st, tick, "cpu")
        want2 = ref.calib_scales(*cpu, **skw)
        got2 = calib.calib_scales(*(a.cuda() if isinstance(a, torch.Tensor) else a
                                    for a in cpu), **skw)
        for k, g, w in zip(("scale",) + BEGIN_STATE, got2, want2):
            assert _same(g, w), f"calib_scales, {name}: {k} differs"
        young = int((np.minimum(st["ring_count"], st["ring"].shape[2]) < cfg.min_scores).sum())
        log(f"  calib_observe and the engine's step (conformal_scale, calib_begin), {name}: "
            f"kernels == plain, "
            f"every output bit for bit; resolved {n_res}, young rows {young}")
    rng = np.random.default_rng(5)
    for circular in (True, False):
        for cap, rows in ((128, 3072), (1024, 6)):
            counts = rng.choice([0, 1, 15, 16, cap - 1, cap, cap + 1, 7 * cap], rows).astype(
                np.int32)
            ring = score_rings(rng, rows, cap, counts, ties=0.5, circular=circular)
            q = rng.uniform(0.05, 1.0, rows).astype(np.float32)
            args = [torch.as_tensor(x) for x in (ring, counts, q, -q)]
            want = ref.conformal_scale(*args, rolled=not circular)
            got = calib.conformal_scale(*(a.cuda() for a in args), rolled=not circular)
            assert _same(got, want), f"conformal_scale, capacity {cap}"
            log(f"  conformal_scale, {rows} {'circular' if circular else 'rolled'} rings of "
                f"{cap} (counts 0 to 7 x capacity, half of the rows tie-prone: +-0, equal "
                f"values, +-inf, NaN): kernel == plain bit for bit")
    return {"calib_observe": 0.0, "conformal_scale": 0.0, "calib_begin": 0.0}


# float32 values where the selection's tie rule shows, as bits: -0, +0,
# 0.25, -1.5, +inf, -inf and quiet NaNs of four payloads (one negative)
NAN_PAYLOADS = np.array([0x7FC00000, 0x7FC0DEAD, 0xFFC00001, 0x7FFFFFFF], np.uint32)
# NaN payloads whose pairs XLA:CPU and numpy resolve apart: quiet and
# signalling, of either sign
TWO_NANS = np.array([0x7FC0DEAD, 0xFFC00001, 0x7F800BAD, 0xFF80BEEF], np.uint32)
SCALE_TIES = np.concatenate([np.array([0x80000000, 0, 0x3E800000, 0xBFC00000, 0x7F800000,
                                       0xFF800000], np.uint32), NAN_PAYLOADS]).view(np.float32)
# (capacity, rows) of the crafted generic launches: the warp path's
# smallest, the engine's series rings and its largest ring, the pool, and
# a capacity above the warp path
SCALE_CRAFTED = ((16, 64), (128, 3072), (512, 64), (1024, 16), (2048, 8))


def crafted_rings(seed, rows, cap, *, circular, min_scores=16):
    """(scores (rows, cap) f32, counts (rows,) i32, q (rows,) f32): rows
    cycling through seeded normal scores, SCALE_TIES drawn cell by cell,
    one such value in every cell, signed zeros only, and NaN payloads with
    +inf and two numbers; counts 0, 1, 2, min_scores - 1 and min_scores,
    cap - 1, cap, cap + 1 and 3 cap + 5; q seeded in [0.05, 1), a fifth of
    the rows at 0 or 1e-7 (k = 0) or at 0.99999994 or 1 (k = n - 1).  A
    circular ring holds +inf in its unwritten cells."""
    rng = np.random.default_rng(seed)
    kind = (np.arange(rows) % 5)[:, None]
    mixed = np.concatenate([NAN_PAYLOADS.view(np.float32),
                            np.array([np.inf, 1.0, -2.0], np.float32)])
    scores = np.select(
        [kind == 1, kind == 2, kind == 3, kind == 4],
        [rng.choice(SCALE_TIES, (rows, cap)),
         np.repeat(rng.choice(SCALE_TIES, (rows, 1)), cap, 1),
         rng.choice(SCALE_TIES[:2], (rows, cap)), rng.choice(mixed, (rows, cap))],
        rng.normal(0.5, 1.5, (rows, cap)).astype(np.float32))
    counts = rng.choice([0, 1, 2, max(min_scores - 1, 0), min_scores, cap - 1, cap, cap + 1,
                         3 * cap + 5], rows).astype(np.int32)
    if circular:
        scores[np.arange(cap)[None, :] >= counts[:, None]] = np.inf
    q = rng.uniform(0.05, 1.0, rows).astype(np.float32)
    edge = rng.random(rows) < 0.2
    q[edge] = rng.choice(np.array([0.0, 1e-7, 0.99999994, 1.0], np.float32), int(edge.sum()))
    return scores, counts, q


def scale_crafted_quantiles(seed=30, A=128, C=12, T=4, cap=128, pcap=1024, gcap=256,
                            min_scores=16):
    """The engine's quantile launch on crafted rings: (arguments of
    calib_quantiles with the per-tenant tier, as CPU tensors; min_scores):
    one member's 3,072 series rings of 128, its pool of 1,024 and T group
    rings of 256 from crafted_rings, the slot table and the credit."""
    import torch
    rng = np.random.default_rng(seed)
    R = 2 * A * C
    ring, counts, _ = crafted_rings(seed, R, cap, circular=True, min_scores=min_scores)
    pool, _, _ = crafted_rings(seed + 1, 5, pcap, circular=False)
    gring, gcount, _ = crafted_rings(seed + 2, T, gcap, circular=True, min_scores=min_scores)
    gcount[0] = 3 * gcap + 5
    tenancy = (torch.as_tensor(rng.uniform(0.0, 1.0, (1, T)).astype(np.float32)),
               torch.as_tensor(rng.integers(0, T, (1, 500)).astype(np.int32)),
               torch.as_tensor(np.where(rng.random((1, A)) < 0.8, rng.integers(0, 500, (1, A)),
                                        -1).astype(np.int32)),
               torch.as_tensor(gring[None]), torch.as_tensor(gcount[None]), 0.05, 0.5, 0.99)
    args = [torch.as_tensor(x) for x in (ring[None], counts[None], pool[:1],
                                         np.array([5 * pcap + 3], np.int32),
                                         np.array([0.9], np.float32))]
    return args + [3.0, tenancy], min_scores


def check_scale_crafted(calib, ref) -> None:
    """Phase 3: conformal_scale against its plain version on the card on
    crafted rings (crafted_rings): its generic launch at each capacity of
    SCALE_CRAFTED, rolled and circular, with a q per row and a q per four
    rows; and the engine's launch with the per-tenant tier (the series
    rings, the pool and the group rings at their tenants' credit-moved q),
    its results where the step reads them.  Every bit equal."""
    import torch
    for cap, rows in SCALE_CRAFTED:
        for circular in (True, False):
            scores, counts, q = crafted_rings(cap + circular, rows, cap, circular=circular)
            for qg in (q, q[::4]):
                args = [torch.as_tensor(x) for x in (scores, counts, qg, -qg)]
                want = ref.conformal_scale(*args, rolled=not circular)
                got = calib.conformal_scale(*(a.cuda() for a in args), rolled=not circular)
                assert _same(got, want), f"conformal_scale, crafted rings of {cap}"
            log(f"  conformal_scale, {rows} crafted {'circular' if circular else 'rolled'} "
                f"rings of {cap} (ties, +-0, NaN payloads, +-inf; k at 0 and n - 1; a q per "
                f"row and per four rows): kernel == plain bit for bit")
    args, min_scores = scale_crafted_quantiles()
    kw = dict(min_scores=min_scores, pool_on=True)
    want = ref.calib_quantiles(*args, **kw)
    to = lambda a: a.cuda() if isinstance(a, torch.Tensor) else a  # noqa: E731
    got = calib.calib_quantiles(*(to(a) for a in args[:-1]), tuple(to(a) for a in args[-1]),
                                **kw)
    read = (args[1] >= min_scores, torch.ones(1, dtype=torch.bool), args[-1][4] >= min_scores)
    for name, g, w, r in zip(("series", "pool", "group"), got, want, read):
        assert _same(g.cpu()[r], w[r]), f"calib_quantiles, crafted {name} rings"
    log(f"  conformal_scale as the engine launches it, crafted rings (3,072 series of 128, "
        f"{int(read[0].sum())} read; the pool of 1,024; {int(read[2].sum())} of 4 group rings of "
        f"256 at their tenants' q): kernel == plain bit for bit")


def calib_leap_cases(A=128, N=500, R=3072):
    """leap_skip with the calibration state's pending scores: idle members
    whose scores are pending are held (0 skipped), the others skip as
    without calibration."""
    members = [dict(gap=12, left=1000)] * 3 + [dict(gap=12, left=1000, busy=True)]
    cols = list(zip(*(leap_member(A, N, 60.0, **m) for m in members)))
    pending = np.zeros((4, R), np.int32)
    pending[0, 7] = 1
    pending[1, R - 1] = 3
    return tuple(np.stack(c) for c in cols), pending, [0, 0, 12, 0]


def check_leap_calib(leap, ref) -> None:
    import torch
    args, pending, leads = calib_leap_cases()
    cpu = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in zip(args, LEAP_DTYPES)]
    p = torch.as_tensor(pending)
    want = ref.leap_skip(*cpu, 60.0, p)
    got = [g.cpu() for g in leap.leap_skip(*(a.cuda() for a in cpu), 60.0, p.cuda())]
    assert all(_same(g, w) for g, w in zip(got, want)) and got[1].tolist() == leads, got
    log(f"  leap_skip with pending calibration scores (members 0 and 1 pending, 2 not, 3 "
        f"busy): kernel == plain bit for bit; skipped ticks {got[1].tolist()}")


def _changed_bits(new, old) -> int:
    """The bytes of the entries an update changes, compared bit by bit
    (a NaN left as it was is unchanged)."""
    import torch
    if new.dtype == torch.float32:
        new, old = new.view(torch.int32), old.view(torch.int32)
    return _changed_bytes(new, old)


def calib_launches(calib) -> dict:
    return {"calib_observe": calib.calib_observe.launches,
            "conformal_scale": calib.conformal_scale.launches,
            "calib_begin": calib.calib_begin.launches}


def run_calibrated(step, scenarios, SimConfig, CalibrationConfig, run_sim, calib):
    """Phase 5g: the default simulation with conformal calibration
    (q = 0.9, adaptive against a 0.1 budget) on the card.  The device
    engine to completion through replayed graphs (a 64-tick run captures
    first), every chunk sync-free, one calib_observe, conformal_scale and
    calib_begin launch a tick, the counts (set to 0 just before the run,
    read just after) equal to replays x each kernel's nodes; the
    same with adaptive=False; ticks/s against the uncalibrated run in
    turns and kernels a tick with and without calibration; the host
    engine capped at MAIN_PATH_TICKS; heavytail at 500 apps for
    FAMILY_TICKS; persist card against CPU over CALIB_CPU_TICKS (any
    difference fails), then GP over CALIB_GP_CPU_TICKS, printed as a
    finding where they differ.  Prints the seconds of each step.
    Returns the main run's launch counts."""
    import torch
    ccfg = calib_config(CalibrationConfig)
    cal = SimConfig(calibration=ccfg)
    guard = strict_chunks(step)
    out = {}
    steps, t_step = {}, [time.perf_counter()]

    def done(what):
        t = time.perf_counter()
        steps[what] = round(t - t_step[0], 1)
        t_step[0] = t
    try:
        for name, cfg in (("adaptive", cal),
                          ("adaptive=False", SimConfig(calibration=dataclasses.replace(
                              ccfg, adaptive=False)))):
            step.run_sim_scan(dataclasses.replace(cfg, max_ticks=64), device="cuda")
            entry = find_entry(step, cfg)
            before = {k: g.replays for k, g in entry.graphs.items()}
            calib.reset_launch_counts()
            c0 = guard.chunks
            t = time.perf_counter()
            res = step.run_sim_scan(cfg, device="cuda")
            torch.cuda.synchronize()
            t = time.perf_counter() - t
            launches = calib_launches(calib)
            in_graphs = graph_census(entry, before, launches)
            ticks = res.timings["ticks"]
            s = res.summary()
            log(f"  device engine, {name}: {ticks} ticks in {guard.chunks - c0} chunks "
                f"(sync-free), {t:.3f} s: {ticks / t:.3f} ticks/s (capture before); launches "
                f"{launches} = replays x kernel nodes {in_graphs}")
            log(f"    calibration {json.dumps(s['calibration'])}")
            log(f"    summary {json.dumps({k: v for k, v in s.items() if k != 'calibration'})}")
            assert launches == in_graphs and all(n == ticks for n in launches.values()), (
                launches, in_graphs, ticks)
            assert s["completed"] == 500 and s["calibration"]["resolved"] > 0, s
            for k in ("util_cpu_mean", "util_mem_mean", "slack_cpu_mean", "slack_mem_mean"):
                assert np.isfinite(s[k]), (k, s[k])
            out.setdefault("launches", launches)
            done(f"device, {name}")
        uentry, centry = find_entry(step, SimConfig()), find_entry(step, cal)
        walls = {"calibrated": [], "uncalibrated": []}
        for mode in ("calibrated", "uncalibrated", "uncalibrated", "calibrated"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            res = step.run_sim_scan(cal if mode == "calibrated" else SimConfig(), device="cuda")
            torch.cuda.synchronize()
            walls[mode].append(res.timings["ticks"] / (time.perf_counter() - t))
        k_cal, k_uni = kernels_per_step(centry), kernels_per_step(uentry)
        log("  device engine ticks/s in turns (calibrated, uncalibrated, uncalibrated, "
            "calibrated): " + "; ".join(f"{m} " + ", ".join(f"{x:.3f}" for x in xs)
                                        for m, xs in walls.items())
            + f"; kernels a tick {k_cal:.3f} calibrated against {k_uni:.3f} "
            f"(+{k_cal - k_uni:.3f})")
        done("turns")
        for line in describe_graphs(centry):
            log(f"  calibrated graph {line}")
        names = [f"{k}_kernel" for k in ("calib_observe", "conformal_scale", "calib_begin")]
        p = gp_profile(step, cal, ticks=CALIB_PROFILE_TICKS, also=names)
        log(f"  first {CALIB_PROFILE_TICKS} ticks under torch.profiler: " + ", ".join(
            f"{k[:-7]} {v['us_per_launch']:.3f} us per launch over {v['launches']} launches, "
            f"{v['share']:.2%} of device time" for k, v in p["others"].items())
            + f" (GP program {p['us_per_launch']:.3f} us, {p['share']:.2%}); device busy "
            f"{p['busy']:.2%} of the wall, {p['ms_per_tick']:.4f} ms per tick")
        done("profile")
        heavy = SimConfig(workload=scenarios.make_config("heavytail"), calibration=ccfg,
                          max_ticks=FAMILY_TICKS)
        t = time.perf_counter()
        res = step.run_sim_scan(heavy, device="cuda")
        torch.cuda.synchronize()
        log(f"  heavytail (500 apps), {res.timings['ticks']} ticks in "
            f"{time.perf_counter() - t:.3f} s (capture included): calibration "
            f"{json.dumps(res.calibration)}")
        assert res.calibration["resolved"] > 0, res.calibration
        done("heavytail")
    finally:
        guard.stop()
    calib.reset_launch_counts()
    hcfg = dataclasses.replace(cal, max_ticks=MAIN_PATH_TICKS)
    t = time.perf_counter()
    res = run_sim(hcfg, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    tm = res.timings
    log(f"  host engine, {tm['ticks']} ticks in {t:.3f} s ({tm['ticks'] / t:.3f} ticks/s): "
        f"launches {calib_launches(calib)} (conformal_scale: a series launch per shaping "
        f"tick, a pool launch where young rows take the warm pool); calibration "
        f"{json.dumps(res.calibration)}")
    assert calib.conformal_scale.launches > 0 and calib.calib_observe.launches == 0
    assert tm["ticks"] == MAIN_PATH_TICKS and res.calibration["resolved"] > 0, res.calibration
    done("host engine")
    card_vs_cpu(step, SimConfig(forecaster="persist", calibration=ccfg,
                                max_ticks=CALIB_CPU_TICKS),
                f"calibrated persist, first {CALIB_CPU_TICKS} ticks", strict=True)
    done("persist card vs cpu")
    card_vs_cpu(step, dataclasses.replace(cal, max_ticks=CALIB_GP_CPU_TICKS),
                f"calibrated GP, first {CALIB_GP_CPU_TICKS} ticks", strict=False)
    done("gp card vs cpu")
    log(f"  phase 5g seconds by step: {json.dumps(steps)}")
    out["walls"] = walls
    return out["launches"]


def time_calib(calib, ref, CalibrationConfig) -> tuple[dict, float]:
    """Phase 8: calib_observe, conformal_scale and calib_begin at the
    device engine's 3,072 rows, each kernel by CUDA events against its
    plain version (numpy on the host) in turns, with its device time per
    launch (torch.profiler) and host time per call.  conformal_scale as
    the engine launches it (the series rings and the pool) on warm rings,
    every row ranked, and its generic launch on the same rings beside
    torch.sort + gather and torch.kthvalue (one PyTorch call computing
    the same order statistic where every ring is full and q one value,
    as here).  The bound: the bytes each function needs on these inputs
    over 3.35 TB/s, the reads that decide, each once, and the entries it
    changes (as scan_bound_bytes counts a state update; fresh outputs in
    full): calib_observe reads each row's left, peak and usage where it
    ages, due and the monitor count where it comes due, mean, sigma,
    scale and count where it resolves; conformal_scale each ranked ring
    row, the counts and the pool; calib_begin the counts, the quantiles
    a row takes, the deploy mask and left, and what the registered rows
    take.  Their comparisons (a selection needs ~cap a row) would take
    far less at fp32's peak.  Returns the timings and the largest error
    against the plain versions."""
    import torch
    cfg = calib_config(CalibrationConfig)
    okw = dict(pool_on=cfg.pool, adaptive=cfg.adaptive, gamma=cfg.gamma, budget=cfg.budget,
               q_min=cfg.q_min, q_max=cfg.q_max)
    st, tick = calib_state(7, warm=True)
    ocpu = observe_args(st, tick, "cpu")
    scpu = scales_args(st, tick, "cpu")
    ogpu = [a.cuda() for a in ocpu]
    sgpu = [a.cuda() if isinstance(a, torch.Tensor) else a for a in scpu]
    R, cap = st["ring"].shape[1:]
    pcap = st["pool"].shape[1]
    qkw = dict(min_scores=cfg.min_scores, pool_on=cfg.pool)
    bkw = dict(cap=cap, pcap=pcap, horizon=3, fallback=3.0, **qkw)
    raw, raw_pool = calib.calib_quantiles(*sgpu[:6], **qkw)
    begin_args = lambda dev: [sgpu[1].to(dev), sgpu[3].to(dev), raw.to(dev),  # noqa: E731
                              raw_pool.to(dev)] + [a.to(dev) for a in sgpu[6:]]
    bgpu, bcpu = begin_args("cuda"), begin_args("cpu")
    kerns = {"calib_observe": (lambda: calib.calib_observe(*ogpu, **okw),
                               lambda: ref.calib_observe(*ocpu, **okw)),
             "conformal_scale": (lambda: calib.calib_quantiles(*sgpu[:6], **qkw),
                                 lambda: ref.calib_quantiles(*scpu[:6], **qkw)),
             "calib_begin": (lambda: calib.calib_begin(*bgpu, **bkw),
                             lambda: ref.calib_begin(*bcpu, **bkw))}
    # the bytes each needs on these inputs
    wo, wb = ref.calib_observe(*ocpu, **okw), ref.calib_begin(*bcpu, **bkw)
    ages, fire = st["left"][0] > 0, st["left"][0] == 1
    res_rows = int((wo[7] - ocpu[11]).sum())
    warm = np.minimum(st["ring_count"][0], cap) >= cfg.min_scores
    m_rows = int((np.concatenate([tick["deploy"]] * 2, 1)[0] & (st["left"][0] == 0)).sum())
    bounds = {
        "calib_observe": (R * 4 + int(ages.sum()) * 8 + int(fire.sum()) * 8 + res_rows * 16
                          + 4 * 6 + sum(_changed_bits(n, o) for n, o in zip(
                              wo, [ocpu[CALIB_STATE.index(k)] for k in OBSERVE_OUT]))),
        "conformal_scale": int(warm.sum()) * (cap + 1) * 4 + R * 4 + (pcap + 1) * 4 + 8,
        "calib_begin": (R * 4 + 8 + int(warm.sum()) * 4 + 4 + R // 2 + R * 4 + m_rows * 8
                        + R // 2 * 4 + 8 + _nbytes(wb[0])
                        + sum(_changed_bits(n, o) for n, o in zip(wb[1:], scpu[10:])))}

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    out, err = {}, 0.0
    for name, (kern, plain) in kerns.items():
        got, want = kern(), plain()
        torch.cuda.synchronize()
        if name == "conformal_scale":     # the entries the step reads
            got, want = (got[0][0][torch.as_tensor(warm).cuda()], got[1]), (
                want[0][0][torch.as_tensor(warm)], want[1])
        assert all(_same(g, w) for g, w in zip(got, want)), f"{name} != plain"
        err = max(err, max(float((g.cpu().double() - w.double()).abs().nan_to_num().max())
                           for g, w in zip(got, want) if g.numel()))
        ms = {"kernel": [], "plain": []}
        for k in ("kernel", "plain", "plain", "kernel"):
            ms[k].append(cuda_time_ms(kern, iters=200, warmup=10) if k == "kernel"
                         else host_ms(plain))
        dev_us = [graph_us(kern) for _ in range(2)]
        host_us = host_us_per_call(kern)
        bound = bounds[name] / HBM_BYTES_PER_S * 1e3
        out[name] = dict(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]), bound_ms=bound,
                         bound_by="bytes", library_ms=None)
        what = {"calib_observe": f"{res_rows} resolving",
                "conformal_scale": f"{int(warm.sum())} ranked and the pool",
                "calib_begin": f"{m_rows} registered"}[name]
        log(f"  {name} (3,072 rows, {what}): kernel "
            f"{'/'.join(f'{x:.5f}' for x in ms['kernel'])} ms a call back to back, plain "
            f"(numpy on the host) {'/'.join(f'{x:.3f}' for x in ms['plain'])} ms; device "
            f"{'/'.join(f'{x:.3f}' for x in dev_us)} us a launch (50 launches in a CUDA "
            f"graph, replayed), host {host_us:.3f} us per call; bound {bound * 1e3:.4f} us "
            f"({bounds[name]} B)")
    # what the engine's quantile launch spends where: every series young
    # (only the pool ranked), the pool off (only the warm series)
    young = [a.clone() if i == 1 else a for i, a in enumerate(sgpu[:6])]
    young[1].zero_()
    parts = {"the pool alone (every series young)": graph_us(
                 lambda: calib.calib_quantiles(*young, **qkw)),
             "the 3,072 warm series alone (the pool off)": graph_us(
                 lambda: calib.calib_quantiles(*sgpu[:6], min_scores=cfg.min_scores,
                                               pool_on=False))}
    log("  conformal_scale, the engine's launch by part: " + ", ".join(
        f"{k} {v:.3f} us" for k, v in parts.items()))
    # the generic launch on the same rings against torch's sort + gather and kthvalue
    ring = sgpu[0][0]
    full = torch.full((R,), 3 * cap, dtype=torch.int32, device="cuda")
    q = sgpu[4].expand(R).contiguous()
    fb = torch.zeros_like(q)
    k = int(np.ceil(np.float32(cap + 1) * np.float32(st["q"][0]))) - 1
    idx = torch.full((R, 1), k, device="cuda")
    gen = lambda: calib.conformal_scale(ring, full, q, fb, False)  # noqa: E731
    srt = lambda: torch.sort(ring, dim=1, stable=True)[0].gather(1, idx)  # noqa: E731
    kth = lambda: torch.kthvalue(ring, k + 1, dim=1)[0]  # noqa: E731
    same = bool(torch.equal(gen().view(torch.int32), srt()[:, 0].view(torch.int32)))
    t = {n: [] for n in ("kernel", "sort+gather", "kthvalue")}
    for n in ("kernel", "sort+gather", "kthvalue", "kthvalue", "sort+gather", "kernel"):
        t[n].append(cuda_time_ms({"kernel": gen, "sort+gather": srt, "kthvalue": kth}[n],
                                 iters=200, warmup=10))
    dev = {n: round(graph_us(f), 3) for n, f in
           (("kernel", gen), ("sort+gather", srt), ("kthvalue", kth))}
    log(f"  conformal_scale's generic launch on the same 3,072 full rings: kernel "
        f"{'/'.join(f'{x:.5f}' for x in t['kernel'])} ms; torch.sort + gather "
        f"{'/'.join(f'{x:.5f}' for x in t['sort+gather'])} ms; torch.kthvalue "
        f"{'/'.join(f'{x:.5f}' for x in t['kthvalue'])} ms (its k for every row: all full, "
        f"one q); device us a call (CUDA graph) {json.dumps(dev)}; kernel == sort + "
        f"gather, bit for bit: {same}")
    out["conformal_scale"]["library_ms"] = min(t["kthvalue"])
    return out, err


# ----------------------------------------------------------------------
# the multi-tenant control plane: control_tick, the gated admission and
# the calibration's per-tenant tier
# ----------------------------------------------------------------------

CONTROL_CPU_TICKS = 160      # the tenanted persist run held card against CPU
CONTROL_GP_CPU_TICKS = 96    # the tenanted GP run held card against CPU (a finding)
CONTROL_KW = dict(credit_on=True, gate_on=True, gamma=0.1, floor=0.05, slack=0.1)
JAIN_WDRF, JAIN_UNGATED, COVERAGE_TOL = 0.9, 0.8, 0.03   # benchmarks/tenancy.py's criteria


def control_member(rng, T, *, N=500, A=128, C=12, events=True, zero=False,
                   conflicts=False):
    """One member's control_tick inputs at the engine's widths (numpy, in
    ref.control_tick's order up to the slot table): tenants of N apps
    drawn from T, the tick's completions, OOM kills and (optimistic)
    conflicts, queued apps, per-tenant conformal resolutions, A slots of C
    components holding seeded allocations (all zero with ``zero``); the
    last tenant (T > 1) has no event."""
    tenant = rng.integers(0, T, N).astype(np.int32)
    quiet = (tenant == T - 1) if T > 1 else np.zeros(N, bool)
    p = 0.05 if events else 0.0
    done0 = rng.random(N) < 0.3
    done = done0 | (~quiet & (rng.random(N) < p))
    queued0 = ~done & (rng.random(N) < 0.2)
    queued = queued0 | (~done & ~quiet & (rng.random(N) < p))
    conflict = (~done & ~queued & ~quiet & (rng.random(N) < p)) if conflicts else None
    slot_gid = np.where(rng.random(A) < 0.8, rng.choice(N, A, replace=False), -1).astype(
        np.int32)
    alloc = (rng.choice([0.0, 0.25, 0.5, 1.0, 2.0, 4.0], (A, C, 2))
             * (slot_gid >= 0)[:, None, None] * (not zero)).astype(np.float32)
    d_res = np.where(np.arange(T) == T - 1 if T > 1 else False, 0,
                     rng.integers(0, 40, T) if events else 0).astype(np.int32)
    d_err = rng.integers(0, d_res + 1).astype(np.int32)
    state = [rng.uniform(0.05, 1, T).astype(np.float32)] + [
        rng.integers(0, 50, T).astype(np.int32) for _ in range(3)] + [
        rng.uniform(0, 40, T).astype(np.float32), rng.integers(0, 300, T).astype(np.int32)]
    return state + [done0, done, queued0, queued, conflict, d_res, d_err, tenant, slot_gid,
                    alloc]


def control_case(members, T, H=50, weights=None):
    """control_tick's arguments (CPU tensors) for ``members`` stacked on
    the member axis, the engine's host capacities and the wDRF weights."""
    import torch
    cols = []
    for i in range(len(members[0])):
        col = [m[i] for m in members]
        cols.append(None if col[0] is None else torch.as_tensor(np.stack(col)))
    cap = torch.tensor([[32.0, 128.0]]).expand(H, 2).contiguous()
    w = torch.ones(T) if weights is None else torch.as_tensor(weights, dtype=torch.float32)
    return cols + [cap, w]


def control_cases():
    """(name, args, kw) of phase 3's control_tick checks: seeded full-width
    members with T = 1, 4 and 8, a tenant with no event in each; the
    optimistic policy's conflicts; non-unit weights; every active tenant
    gated (a negative slack); zero shares; the credit off; the gate off;
    a 3-member cohort; a streamed window's free rows."""
    rng = np.random.default_rng(24)
    cases = [(f"full width, T = {T}", control_case([control_member(rng, T)], T), CONTROL_KW)
             for T in (1, 4, 8)]
    cases += [
        ("T = 8 with optimistic conflicts",
         control_case([control_member(rng, 8, conflicts=True)], 8), CONTROL_KW),
        ("T = 8, weights 0.5 to 3",
         control_case([control_member(rng, 8)], 8, weights=rng.choice([0.5, 1, 2, 3], 8)),
         CONTROL_KW),
        ("T = 4, every active tenant gated (slack -1)",
         control_case([control_member(rng, 4)], 4), dict(CONTROL_KW, slack=-1.0)),
        ("T = 4, zero shares", control_case([control_member(rng, 4, zero=True)], 4),
         CONTROL_KW),
        ("T = 4, no event", control_case([control_member(rng, 4, events=False)], 4),
         CONTROL_KW),
        ("T = 8, the credit off", control_case([control_member(rng, 8)], 8),
         dict(CONTROL_KW, credit_on=False)),
        ("T = 8, the gate off", control_case([control_member(rng, 8)], 8),
         dict(CONTROL_KW, gate_on=False)),
        ("a 3-member cohort, T = 4",
         control_case([control_member(rng, 4, zero=i == 1) for i in range(3)], 4),
         CONTROL_KW),
        ("T = 4, a streamed window's free rows",
         control_case([window_control_member(rng, 4)], 4), CONTROL_KW)]
    return cases


def window_control_member(rng, T, W=256):
    """control_member over a streamed window of W rows, two in five that no
    slot holds free with the window's sentinel: done before and after the
    tick, never queued, tenant 0."""
    m = control_member(rng, T, N=W)
    done0, done, queued0, queued, conflict, d_res, d_err, tenant, slot_gid, alloc = m[6:]
    free = (rng.random(W) < 0.4) & ~np.isin(np.arange(W), slot_gid)
    return m[:6] + [done0 | free, done | free, queued0 & ~free, queued & ~free, conflict,
                    d_res, d_err, np.where(free, 0, tenant).astype(np.int32), slot_gid, alloc]


TINY_VALUES = np.float32([1.5 * TINY, -TINY, TINY / 4, -TINY / 8, TINY, 3 * TINY, 0.75 * TINY])
TWO_NAN_VALUES = np.concatenate([TWO_NANS.view(np.float32), np.float32([np.inf, -np.inf])])
CONTROL_CRAFTED = ("signed zeros", "NaN and inf", "near 2^-126", "tenant ids out of range",
                   "T = 1", "T = 32", "T = 33", "T = 1024, A = 37", "A = 20, C = 7, N = 61",
                   "A = 37, C = 5", "a cohort with an idle member")


def control_crafted(name):
    """control_tick's arguments (CPU tensors) and keywords of crafted case
    ``name``: the engine's widths (A = 128 slots of C = 12, N = 500, T = 4)
    unless the name says otherwise; allocations of signed zeros (a tenant
    whose slots hold only -0), NaNs of the TWO_NANS payloads and +-inf, or
    values near 2^-126 (subnormal and tiny normal ones, and a share_sum
    among them); tenant ids of T, T + 5, -1 and -7 in the trace; T of 1,
    32 (the warps' votes), 33 and 1,024 (match groups and the block's
    mean); A of 20 (one window), 37 (two windows, C odd: 8-byte loads) and
    a cohort whose middle member has no slot and no event."""
    rng = np.random.default_rng(60 + CONTROL_CRAFTED.index(name))
    T = {"T = 1": 1, "T = 32": 32, "T = 33": 33, "T = 1024, A = 37": 1024}.get(name, 4)
    shape = {"T = 1024, A = 37": dict(A=37, C=3), "A = 20, C = 7, N = 61": dict(A=20, C=7, N=61),
             "A = 37, C = 5": dict(A=37, C=5)}.get(name, {})
    members = [control_member(rng, T, **shape)]
    if name == "a cohort with an idle member":
        members = [control_member(rng, T), control_member(rng, T, events=False, zero=True),
                   control_member(rng, T)]
        members[1][14][:] = -1               # no slot occupied
    for m in members:
        share_sum, tenant, slot_gid, alloc = m[4], m[13], m[14], m[15]
        occupied = slot_gid >= 0
        if name == "signed zeros":
            own = np.where(occupied, tenant[np.maximum(slot_gid, 0)], -1)
            neg = own == own[np.argmax(occupied)]
            signs = np.where(neg[:, None, None] | (rng.random(alloc.shape) < 0.5),
                             np.float32(-0.0), np.float32(0.0))
            alloc[...] = np.where(occupied[:, None, None], signs, alloc)
            share_sum[::2] = -0.0
        elif name == "NaN and inf":
            hit = occupied[:, None, None] & (rng.random(alloc.shape) < 0.05)
            alloc[...] = np.where(hit, rng.choice(TWO_NAN_VALUES, alloc.shape), alloc)
            share_sum[1] = TWO_NANS.view(np.float32)[2]
        elif name == "near 2^-126":
            alloc[...] = np.where(occupied[:, None, None], rng.choice(TINY_VALUES, alloc.shape),
                                  alloc)
            share_sum[:] = rng.choice(TINY_VALUES, share_sum.shape)
        elif name == "tenant ids out of range":
            tenant[::7], tenant[1::11], tenant[2::13], tenant[3::17] = T, T + 5, -1, -7
    return control_case(members, T), CONTROL_KW


def check_control(control, ref) -> float:
    """Phase 3: control_tick on the card against its plain version, every
    output bit for bit: the seeded cases and CONTROL_CRAFTED."""
    crafted = [(f"crafted case {n!r}", *control_crafted(n)) for n in CONTROL_CRAFTED]
    for name, args, kw in control_cases() + crafted:
        want = ref.control_tick(*args, **kw)
        got = control.control_tick(*(a.cuda() if a is not None else None for a in args), **kw)
        for k, g, w in zip(("credit", "throttled", "completed", "failed", "share_sum",
                            "active_ticks", "elig"), got, want):
            assert _same(g, w), f"control_tick, {name}: {k} differs"
        log(f"  control_tick, {name}: kernel == plain, every output bit for bit; eligible "
            f"{want[6].sum(1).tolist()} of {want[6].shape[1]}, throttled "
            f"{(want[1] - args[1]).sum().item()}, credit moved "
            f"{int((want[0] != args[0]).sum())}")
    return 0.0


def gate_args(rng, args, T, mode="half"):
    """The gate's three arguments for an admission case of S members:
    seeded tenants of its apps from T, the eligible tenants (half, none or
    all), seeded admitted counts."""
    import torch
    S, N = args[0].shape
    elig = {"half": rng.random((S, T)) < 0.5, "none": np.zeros((S, T), bool),
            "all": np.ones((S, T), bool)}[mode]
    return (torch.as_tensor(rng.integers(0, T, (S, N)).astype(np.int32)),
            torch.as_tensor(elig), torch.as_tensor(rng.integers(0, 9, (S, T)).astype(np.int32)))


def check_gated_admit(sched, ref, cases) -> float:
    """Phase 3: the admission kernel with the control plane's gate against
    its plain version on every admission case of the scan kernels'
    checks (full-width captured states, seeded tables, edge members),
    T = 1, 4 and 8 in turn, half the tenants eligible; every tenant gated
    and every tenant eligible on the captured states; every output bit for
    bit, the admitted counts included."""
    import torch
    rng = np.random.default_rng(25)
    admitted = n = 0
    for i, args in enumerate(cases["admit_queued"]):
        modes = ["half"] + (["none", "all"] if args[0].shape[1] == 500 and i % 4 == 0 else [])
        for mode in modes:
            gate = gate_args(rng, args, (1, 4, 8)[i % 3], mode)
            cpu = tuple(args) + gate
            want = ref.admit_queued(*cpu)
            got = sched.admit_queued(*(a.cuda() if isinstance(a, torch.Tensor) else a
                                       for a in cpu))
            for k, (g, w) in enumerate(zip(got, want)):
                assert _same(g, w), f"gated admit_queued, case {i} ({mode}): output {k} differs"
            if mode == "none":
                assert torch.equal(want[6], args[12]), "a gated tenant admitted"
            admitted += int((want[9] - gate[2]).sum())
            n += 1
    log(f"  admit_queued with the gate: {n} cases, kernel == plain, every output bit for bit "
        f"(the admitted counts too); {admitted} admissions")
    assert admitted > 0
    return 0.0


def calib_tier(rng, st, T, *, gcap=256, A=128, N=500):
    """The per-tenant tier over a phase-3 calibration state (S members of R
    rows): group rings of T tenants (counts 0 to 3 x gcap), each row's
    deploy group (-1 for a fifth), counters; and the slot table it reads,
    A slots of R / 2A components with tenants of N apps, and the credit."""
    S, R = st["ring_count"].shape
    counts = rng.choice([0, 5, 16, gcap, gcap + 7, 3 * gcap], (S, T)).astype(np.int32)
    tier = dict(group_ring=np.stack([score_rings(rng, T, gcap, c) for c in counts]),
                group_count=counts,
                group=np.where(rng.random((S, R)) < 0.2, -1,
                               rng.integers(0, T, (S, R))).astype(np.int32),
                group_resolved=rng.integers(0, 999, (S, T)).astype(np.int32),
                group_errors=rng.integers(0, 99, (S, T)).astype(np.int32))
    table = dict(slot_gid=np.where(rng.random((S, A)) < 0.8, rng.integers(0, N, (S, A)),
                                   -1).astype(np.int32),
                 tenant=rng.integers(0, T, (S, N)).astype(np.int32),
                 credit=rng.uniform(0.05, 1, (S, T)).astype(np.float32))
    return tier, table


TIER = ("group_ring", "group_count", "group", "group_resolved", "group_errors")


def tier_args(st, tick, tier, table, dev, *, credit=True, spread=0.05, cfg=None):
    """(observe's arguments with the tier, calib_scales' with it) on dev."""
    import torch
    T_ = lambda x: torch.as_tensor(x).to(dev)  # noqa: E731
    obs = observe_args(st, tick, dev) + [tuple(T_(tier[k]) for k in TIER)]
    scales = scales_args(st, tick, dev) + [(
        T_(table["credit"]) if credit else None, T_(table["tenant"]), T_(table["slot_gid"]),
        T_(tier["group_ring"]), T_(tier["group_count"]), T_(tier["group"]), spread,
        cfg.q_min, cfg.q_max)]
    return obs, scales


def tier_cases(CalibrationConfig):
    """(name, state, tick, tier, slot table, config) of phase 3's checks of
    the calibration's per-tenant tier."""
    cfg = calib_config(CalibrationConfig)
    rng = np.random.default_rng(26)
    cases = []
    for seed, warm, T in ((0, False, 4), (1, True, 8), (2, False, 8)):
        st, tick = calib_state(20 + seed, warm=warm, due_share=0.9 if seed == 2 else 0.35)
        cases.append((f"full width (3,072 rows), T = {T}, "
                      f"{'warm' if warm else 'counts 0 to 3 x capacity'}"
                      f"{', 90% of the rows due' if seed == 2 else ''}",
                      st, tick, *calib_tier(rng, st, T), cfg))
    small = calib_config(CalibrationConfig, capacity=16, pool_capacity=8, min_scores=4,
                         group_capacity=8)
    st, tick = calib_state(23, S=3, M=200, cap=16, pcap=8)
    cases.append(("a 3-member cohort (the third done), capacity 16, group rings of 8",
                  st, tick, *calib_tier(rng, st, 4, gcap=8, A=50, N=60), small))
    return cases


def check_calib_tier(calib, ref, CalibrationConfig) -> float:
    """Phase 3: the three calibration kernels with the per-tenant tier
    against their plain versions: calib_observe (the group rings, their
    counts and the tick's per-tenant deltas) and the engine's shaping step
    (the quantiles at the credit-modulated levels, the series -> group ->
    pool -> K2 fallback, the rows' groups), with the credit and without,
    every output bit for bit."""
    import torch
    kw = lambda c: dict(pool_on=c.pool, adaptive=c.adaptive, gamma=c.gamma,  # noqa: E731
                        budget=c.budget, q_min=c.q_min, q_max=c.q_max)
    for name, st, tick, tier, table, cfg in tier_cases(CalibrationConfig):
        for credit in (True, False):
            ocpu, scpu = tier_args(st, tick, tier, table, "cpu", credit=credit, cfg=cfg)
            want = ref.calib_observe(*ocpu, **kw(cfg))
            got = calib.calib_observe(*(a.cuda() for a in ocpu[:-1]),
                                      tuple(a.cuda() for a in ocpu[-1]), **kw(cfg))
            assert len(got) == len(want) == 16
            for k, (g, w) in enumerate(zip(got, want)):
                assert _same(g, w), f"calib_observe with the tier, {name}: output {k} differs"
            skw = dict(min_scores=cfg.min_scores, pool_on=cfg.pool, horizon=3)
            want2 = ref.calib_scales(*scpu, **skw)
            to = lambda a: a.cuda() if isinstance(a, torch.Tensor) else a  # noqa: E731
            got2 = calib.calib_scales(*(to(a) for a in scpu[:-1]),
                                      tuple(to(a) for a in scpu[-1]), **skw)
            assert len(got2) == len(want2) == 10
            for k, (g, w) in enumerate(zip(got2, want2)):
                assert _same(g, w), f"calib_scales with the tier, {name}: output {k} differs"
        warm = (np.minimum(tier["group_count"], tier["group_ring"].shape[2])
                >= cfg.min_scores)
        log(f"  calib_observe, conformal_scale and calib_begin with the per-tenant tier, "
            f"{name}: kernels == plain, every output bit for bit (credit on and off); "
            f"resolved per tenant {want[14].tolist()}, warm group rings {int(warm.sum())}")
    return 0.0


# crafted cases of calib_observe and calib_begin (through calib_scales),
# held kernel against plain on the card (phase 3,
# tests/test_torch_kernels_hopper.py) and the plain versions against the
# reference's on the CPU (tests/test_torch_calibration.py): 3 members of
# 200 rows (XLA's windows then start 12 rows before row 0), or of 3,000
# (4 rows before; three rows a thread of calib_observe's block)
CALIB_CRAFTED = ("200 rows", "3,000 rows", "every row resolves", "no row resolves",
                 "more than pcap and gcap resolve", "NaN, -0 and +-inf", "two NaN payloads",
                 "inactive middle member", "G = 1", "G = 127", "ids out of range")
CALIB_CRAFTED_CFG = dict(capacity=16, pool_capacity=8, min_scores=4, group_capacity=8)


def calib_crafted(name):
    """Crafted case ``name`` of CALIB_CRAFTED: (state, tick, tier, slot
    table) as calib_state and calib_tier give them (S = 3 members of R =
    2M rows, capacities of CALIB_CRAFTED_CFG, T = 4 groups, A slots of 4
    or 12 components, 60 apps), then changed: every row due now at the count
    it is due at, or none (rows age, or come due at another count); most
    rows of group 0 and 90% of them due; rings, pool and group rings from
    crafted_rings (ties, +-0, NaN payloads, +-inf, counts 0 to 3 cap + 5;
    member 0's first window of scales +inf and -inf), peaks, means,
    sigmas and variances among NaN payloads, -0 and +-inf, usage among -0
    and +-inf, deployed rows 90% (in the other cases every score is
    finite); the same with peaks and usage among TWO_NANS' payloads in
    either order, and each member's scale_sum one of them, where the
    deployed scales' sum is a NaN too;
    the middle member inactive;
    T = 1 or 127; group ids -1, -3 and >= T and tenant ids outside [0, T)."""
    M, A = (1500, 125) if name == "3,000 rows" else (100, 25)
    S, R = 3, 2 * M
    seed = 40 + CALIB_CRAFTED.index(name)
    rng = np.random.default_rng(seed)
    T = {"G = 1": 1, "G = 127": 127}.get(name, 4)
    cap, pcap, gcap = (CALIB_CRAFTED_CFG[k] for k in ("capacity", "pool_capacity",
                                                       "group_capacity"))
    st, tick = calib_state(seed, S=S, M=M, cap=cap, pcap=pcap,
                           due_share=0.9 if name.startswith("more than") else 0.35)
    tier, table = calib_tier(rng, st, T, gcap=gcap, A=A, N=60)
    for ring, count in ((st["ring"], st["ring_count"]), (st["pool"], st["pool_count"]),
                        (tier["group_ring"], tier["group_count"])):
        # finite scores, so that the deployed scales' sum shows XLA's order
        odd = (np.arange(ring.shape[-1]) < count[..., None]) & ~np.isfinite(ring)
        ring[odd] = rng.normal(0.5, 1.5, int(odd.sum())).astype(np.float32)
    mon2 = np.concatenate([tick["mon_count"]] * 2, 1)
    if name == "every row resolves":
        st["left"][:] = 1
        st["due"][:] = mon2
        tick["active"][:] = True
    elif name == "no row resolves":
        st["left"] = rng.choice([0, 1, 2, 3], (S, R)).astype(np.int32)
        st["due"] = (mon2 + 1).astype(np.int32)
    elif name.startswith("more than"):
        tier["group"] = np.where(rng.random((S, R)) < 0.8, 0, tier["group"]).astype(np.int32)
    elif name in ("NaN, -0 and +-inf", "two NaN payloads"):
        odd = np.concatenate([NAN_PAYLOADS.view(np.float32),
                              np.array([-0.0, 0.0, np.inf, -np.inf], np.float32)])
        ring, counts, _ = crafted_rings(seed, S * R, cap, circular=True,
                                        min_scores=CALIB_CRAFTED_CFG["min_scores"])
        # member 0's first window (rows 0 .. 19): +inf and -inf scales, so
        # that its sum is inf - inf, x86's default NaN
        ring[:20] = np.repeat(np.array([np.inf, -np.inf], np.float32), 10)[:, None]
        counts[:20] = cap
        tick["deploy"] = rng.random(tick["deploy"].shape) < 0.9
        tick["deploy"][0, :20] = True
        st["ring"], st["ring_count"] = ring.reshape(S, R, cap), counts.reshape(S, R)
        pool, _, _ = crafted_rings(seed + 1, S, pcap, circular=True)
        st["pool"] = pool
        gring, gcount, _ = crafted_rings(seed + 2, S * T, gcap, circular=True, min_scores=4)
        tier["group_ring"], tier["group_count"] = gring.reshape(S, T, gcap), gcount.reshape(S, T)

        def sprinkle(x, share, values=odd):
            hit = rng.random(x.shape) < share
            return np.where(hit, rng.choice(values, x.shape), x).astype(np.float32)
        for k, share in (("peak", 0.4), ("mean", 0.2), ("sigma", 0.1), ("scale", 0.1)):
            st[k] = sprinkle(st[k], share)
        tick["usage"] = sprinkle(tick["usage"], 0.1, odd[len(NAN_PAYLOADS):])
        tick["var"] = sprinkle(tick["var"], 0.1)
        if name == "two NaN payloads":
            nans = TWO_NANS.view(np.float32)
            st["peak"] = sprinkle(st["peak"], 0.5, nans)
            tick["usage"] = sprinkle(tick["usage"], 0.5, nans)
            st["left"] = np.where(rng.random((S, R)) < 0.5, 2, st["left"]).astype(np.int32)
            st["scale_sum"] = nans[:S].copy()
    elif name == "inactive middle member":
        tick["active"] = np.array([True, False, True])
    elif name == "ids out of range":
        tier["group"] = rng.choice(np.array([-1, -3, 0, 1, 2, 3, T, T + 2, 127], np.int32),
                                   (S, R))
        table["tenant"] = rng.choice(np.array([-2, -1, 0, 1, 2, 3, T, T + 5], np.int32),
                                     table["tenant"].shape)
    return st, tick, tier, table


def calib_crafted_outputs(name, calib, ref, CalibrationConfig):
    """Crafted case ``name`` through calib_observe and calib_scales (the
    quantiles, then calib_begin), without the tier and with it (credit on
    and off), kernels on the card and plain versions: yields (what, got,
    want) for every output."""
    import torch
    cfg = calib_config(CalibrationConfig, **CALIB_CRAFTED_CFG)
    st, tick, tier, table = calib_crafted(name)
    okw = dict(pool_on=cfg.pool, adaptive=cfg.adaptive, gamma=cfg.gamma, budget=cfg.budget,
               q_min=cfg.q_min, q_max=cfg.q_max)
    skw = dict(min_scores=cfg.min_scores, pool_on=cfg.pool, horizon=3)
    to = lambda a: a.cuda() if isinstance(a, torch.Tensor) else a  # noqa: E731
    for mode in ("no tier", "tier, credit on", "tier, credit off"):
        if mode == "no tier":
            ocpu, scpu = observe_args(st, tick, "cpu"), scales_args(st, tick, "cpu")
            ogpu, sgpu = [to(a) for a in ocpu], [to(a) for a in scpu]
        else:
            ocpu, scpu = tier_args(st, tick, tier, table, "cpu", credit=mode.endswith("on"),
                                   cfg=cfg)
            ogpu = [to(a) for a in ocpu[:-1]] + [tuple(to(a) for a in ocpu[-1])]
            sgpu = [to(a) for a in scpu[:-1]] + [tuple(to(a) for a in scpu[-1])]
        want, got = ref.calib_observe(*ocpu, **okw), calib.calib_observe(*ogpu, **okw)
        for k, (g, w) in enumerate(zip(got, want)):
            yield f"{name}, {mode}: calib_observe output {k}", g, w
        want, got = ref.calib_scales(*scpu, **skw), calib.calib_scales(*sgpu, **skw)
        for k, (g, w) in enumerate(zip(got, want)):
            yield f"{name}, {mode}: calib_scales output {k}", g, w


def check_calib_crafted(calib, ref, CalibrationConfig) -> None:
    """Phase 3: calib_observe and calib_begin (through calib_scales) against
    their plain versions on every crafted case of CALIB_CRAFTED, without
    the per-tenant tier and with it, credit on and off: every output bit
    for bit."""
    for name in CALIB_CRAFTED:
        n = 0
        for what, got, want in calib_crafted_outputs(name, calib, ref, CalibrationConfig):
            assert _same(got, want), f"{what} differs"
            n += 1
        log(f"  calib_observe and calib_scales, crafted case {name!r}: {n} outputs, "
            f"kernels == plain bit for bit")


def tenancy_config(SimConfig, WorkloadConfig, TenancyConfig, CalibrationConfig, **over):
    """Phase 5h's full-width path: 500 apps of 4 tenants, the control plane
    on, conformal calibration as phase 5g's."""
    return SimConfig(workload=WorkloadConfig(n_tenants=4),
                     control=TenancyConfig(enabled=True),
                     calibration=calib_config(CalibrationConfig), **over)


def control_launches(control, calib, sched) -> dict:
    return {"control_tick": control.control_tick.launches,
            "admit_queued": sched.admit_queued.launches, **calib_launches(calib)}


def tenancy_cells(step, scenarios, SimConfig, ClusterConfig, TenancyConfig,
                  CalibrationConfig) -> None:
    """The reference's own tenancy cells (benchmarks/tenancy.py) at their
    sizes on the device engine: the fairness cell in its ungated, wdrf and
    credit modes and the coverage cell, their Jain indices and per-tenant
    coverage printed beside the reference's criteria (findings, not
    gates); every app completes."""
    import torch
    wl = scenarios.make_config("colocated", n_apps=128, max_components=4, n_tenants=4,
                               tenant_skew=1.0, seed=1, mean_gap=5.0, svc_min_runtime=1800.0,
                               svc_max_runtime=7200.0, batch_min_runtime=900.0,
                               batch_max_runtime=3600.0)
    base = SimConfig(cluster=ClusterConfig(n_hosts=3, max_running_apps=24), workload=wl,
                     policy="baseline", max_ticks=20000)
    modes = {"ungated": TenancyConfig(enabled=True, gate=False, credit=False),
             "wdrf": TenancyConfig(enabled=True, gate=True, credit=False, slack=0.02),
             "credit": TenancyConfig(enabled=True, gate=True, credit=True, slack=0.02)}
    jain = {}
    for name, ctl in modes.items():
        t = time.perf_counter()
        res = step.run_sim_scan(dataclasses.replace(base, control=ctl), device="cuda")
        torch.cuda.synchronize()
        ten = res.tenancy
        jain[name] = ten["jain_mean_share"]
        log(f"  fairness cell (colocated, 128 apps, 4 tenants, skew 1.0, 3 hosts, 24 slots, "
            f"baseline), {name}: {res.timings['ticks']} ticks in {time.perf_counter() - t:.3f} "
            f"s (capture included); Jain {ten['jain_mean_share']}, mean share "
            f"{ten['mean_share']}, throttled {ten['throttled']}, completed "
            f"{sum(ten['completed'])}, turnaround mean {ten['turnaround_mean']}")
        assert sum(ten["completed"]) == 128, f"{name}: the gate must defer work, not lose it"
    log(f"  FINDING fairness cell: Jain wdrf {jain['wdrf']} (the reference's criterion >= "
        f"{JAIN_WDRF}: {jain['wdrf'] >= JAIN_WDRF}), ungated {jain['ungated']} (< "
        f"{JAIN_UNGATED}: {jain['ungated'] < JAIN_UNGATED}), credit {jain['credit']}")
    cal = CalibrationConfig(enabled=True, adaptive=True)
    wl = scenarios.make_config("heavytail", n_apps=128, max_components=6, n_tenants=2,
                               tenant_skew=0.0, seed=0, mean_gap=20.0, max_runtime=14400.0)
    cfg = SimConfig(cluster=ClusterConfig(n_hosts=4, max_running_apps=32), workload=wl,
                    policy="pessimistic", forecaster="persist", max_ticks=40000,
                    calibration=cal, control=TenancyConfig(enabled=True))
    t = time.perf_counter()
    res = step.run_sim_scan(cfg, device="cuda")
    torch.cuda.synchronize()
    groups = res.calibration["groups"]
    covs = [c for c in groups["coverage"] if c is not None]
    dev = max(abs(c - (1 - cal.budget)) for c in covs)
    log(f"  coverage cell (heavytail, 128 apps, 2 tenants, persist, adaptive calibration): "
        f"{res.timings['ticks']} ticks in {time.perf_counter() - t:.3f} s (capture "
        f"included); completed {res.summary()['completed']}, q_target "
        f"{res.calibration['q_target']}, resolved {groups['resolved'][:2]}")
    log(f"  FINDING coverage cell: per-tenant coverage {covs} against the nominal "
        f"{1 - cal.budget:.2f}, largest deviation {dev:.4f} (the reference's criterion <= "
        f"{COVERAGE_TOL}: {dev <= COVERAGE_TOL})")
    assert res.summary()["completed"] == 128, res.summary()


def run_tenancy(step, scenarios, SimConfig, WorkloadConfig, ClusterConfig, TenancyConfig,
                CalibrationConfig, run_sim, control, calib, sched) -> dict:
    """Phase 5h: the multi-tenant control plane on the card.  The
    full-width tenanted, calibrated path (tenancy_config) on the device
    engine to completion through replayed graphs (a 64-tick run captures
    first), every chunk sync-free, one control_tick launch a tick and the
    admission and calibration kernels once a tick, the counts (set to 0
    just before the run, read just after) equal to replays x each kernel's
    nodes; kernels a tick and ticks/s in turns against the same run with
    the control plane off (the same trace but its tenant column: the
    tenant draw comes last); the host engine capped at MAIN_PATH_TICKS;
    persist card against CPU over CONTROL_CPU_TICKS (any difference
    fails), GP over CONTROL_GP_CPU_TICKS (a finding); then the reference's
    tenancy cells (tenancy_cells).  Prints the seconds of each step.
    Returns the main run's launch counts."""
    import torch
    cfg = tenancy_config(SimConfig, WorkloadConfig, TenancyConfig, CalibrationConfig)
    off = dataclasses.replace(cfg, control=TenancyConfig())
    guard = strict_chunks(step)
    steps, t_step = {}, [time.perf_counter()]

    def done(what):
        t = time.perf_counter()
        steps[what] = round(t - t_step[0], 1)
        t_step[0] = t
    try:
        step.run_sim_scan(dataclasses.replace(cfg, max_ticks=64), device="cuda")
        entry = find_entry(step, cfg)
        before = {k: g.replays for k, g in entry.graphs.items()}
        for m in (control, calib, sched):
            m.reset_launch_counts()
        c0 = guard.chunks
        t = time.perf_counter()
        res = step.run_sim_scan(cfg, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        launches = control_launches(control, calib, sched)
        in_graphs = graph_census(entry, before, launches)
        ticks = res.timings["ticks"]
        s = res.summary()
        log(f"  device engine, control on: {ticks} ticks in {guard.chunks - c0} chunks "
            f"(sync-free), {t:.3f} s: {ticks / t:.3f} ticks/s (capture before); launches "
            f"{launches} = replays x kernel nodes {in_graphs}")
        log(f"    tenancy {json.dumps(s['tenancy'])}")
        log(f"    calibration {json.dumps(s['calibration'])}")
        log(f"    summary {json.dumps({k: v for k, v in s.items() if k not in ('tenancy', 'calibration')})}")
        assert launches == in_graphs and all(n == ticks for n in launches.values()), (
            launches, in_graphs, ticks)
        assert s["completed"] == 500 and s["calibration"]["resolved"] > 0, s
        assert sum(s["tenancy"]["completed"]) == 500 and "groups" in s["calibration"], s
        for k in ("util_cpu_mean", "util_mem_mean", "slack_cpu_mean", "slack_mem_mean"):
            assert np.isfinite(s[k]), (k, s[k])
        done("device, control on")
        roff = step.run_sim_scan(off, device="cuda")
        oentry = find_entry(step, off)
        walls = {"control on": [], "control off": []}
        for mode in ("control on", "control off", "control off", "control on"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = step.run_sim_scan(cfg if mode == "control on" else off, device="cuda")
            torch.cuda.synchronize()
            walls[mode].append(r.timings["ticks"] / (time.perf_counter() - t))
        k_on, k_off = kernels_per_step(entry), kernels_per_step(oentry)
        log("  device engine ticks/s in turns (on, off, off, on): " + "; ".join(
            f"{m} " + ", ".join(f"{x:.3f}" for x in xs) for m, xs in walls.items())
            + f"; kernels a tick {k_on:.3f} with the control plane against {k_off:.3f} "
            f"without (+{k_on - k_off:.3f}); the run without it: {roff.timings['ticks']} "
            f"ticks, {roff.summary()['completed']} completed")
        for line in describe_graphs(entry):
            log(f"  control graph {line}")
        done("turns")
    finally:
        guard.stop()
    for m in (control, calib):
        m.reset_launch_counts()
    hcfg = dataclasses.replace(cfg, max_ticks=MAIN_PATH_TICKS)
    t = time.perf_counter()
    res = run_sim(hcfg, device="cuda")
    torch.cuda.synchronize()
    t = time.perf_counter() - t
    tm = res.timings
    log(f"  host engine, {tm['ticks']} ticks in {t:.3f} s ({tm['ticks'] / t:.3f} ticks/s): "
        f"control_tick launches {control.control_tick.launches} (the host engine's control "
        f"plane is numpy), conformal_scale {calib.conformal_scale.launches}; tenancy "
        f"{json.dumps(res.tenancy)}; groups {json.dumps(res.calibration['groups'])}")
    assert control.control_tick.launches == 0 and calib.conformal_scale.launches > 0
    assert tm["ticks"] == MAIN_PATH_TICKS and res.tenancy is not None, tm
    done("host engine")
    card_vs_cpu(step, dataclasses.replace(cfg, forecaster="persist", max_ticks=CONTROL_CPU_TICKS),
                f"tenanted calibrated persist, first {CONTROL_CPU_TICKS} ticks", strict=True)
    done("persist card vs cpu")
    card_vs_cpu(step, dataclasses.replace(cfg, max_ticks=CONTROL_GP_CPU_TICKS),
                f"tenanted calibrated GP, first {CONTROL_GP_CPU_TICKS} ticks", strict=False)
    done("gp card vs cpu")
    tenancy_cells(step, scenarios, SimConfig, ClusterConfig, TenancyConfig, CalibrationConfig)
    done("tenancy cells")
    log(f"  phase 5h seconds by step: {json.dumps(steps)}")
    return {"control_tick": launches["control_tick"]}


def control_bound_bytes(args, outs) -> int:
    """The bytes control_tick needs on one case: each input read once (the
    app columns, the occupied slots' allocations, the per-tenant state, the
    capacities and weights) and each output written once."""
    (credit, throttled, completed, failed, share_sum, active_ticks, done0, done, queued0,
     queued, conflict, d_res, d_err, tenant, slot_gid, alloc, cap, w) = args
    occupied = int((slot_gid >= 0).sum())
    reads = _nbytes(credit, throttled, completed, failed, share_sum, active_ticks, done0,
                    done, queued0, queued, tenant, slot_gid, cap, w)
    reads += _nbytes(*(x for x in (conflict, d_res, d_err) if x is not None))
    reads += occupied * alloc.shape[2] * 2 * alloc.element_size()
    return reads + _nbytes(*outs)


def time_calib_tier(calib, ref, CalibrationConfig, rng) -> dict:
    """calib_observe, calib_begin and the shaping step's two launches
    (calib_scales) on the full-width warm state with the per-tenant tier
    (T = 4, group rings of 256), each beside the same launch without it:
    device us a call (a CUDA graph of 50, twice each), in turns; and the
    bounds of calib_observe and calib_begin with the tier, in bytes as
    time_calib counts them, with the tier's own: the groups of the
    resolved rows, the group counters and the group ring cells a tick
    changes (observe); the slot table and tenants of the occupied slots,
    the group rings' counts and quantiles, the groups registered (begin).
    Returns the device us by name and the bounds in bytes."""
    import torch
    cfg = calib_config(CalibrationConfig)
    st, tick = calib_state(7, warm=True)
    tier, table = calib_tier(rng, st, 4)
    ocpu, scpu = tier_args(st, tick, tier, table, "cpu", cfg=cfg)
    to = lambda a: a.cuda() if isinstance(a, torch.Tensor) else a  # noqa: E731
    og = [to(a) for a in ocpu[:-1]] + [tuple(to(a) for a in ocpu[-1])]
    sg = [to(a) for a in scpu[:-1]] + [tuple(to(a) for a in scpu[-1])]
    okw = dict(pool_on=cfg.pool, adaptive=cfg.adaptive, gamma=cfg.gamma, budget=cfg.budget,
               q_min=cfg.q_min, q_max=cfg.q_max)
    skw = dict(min_scores=cfg.min_scores, pool_on=cfg.pool, horizon=3)
    R, cap = st["ring"].shape[1:]
    pcap, gcap = st["pool"].shape[1], tier["group_ring"].shape[2]
    credit, tenant, slot_gid, gring, gcount, group = sg[-1][:6]
    qt = (credit, tenant, slot_gid, gring, gcount) + sg[-1][6:]
    raw = calib.calib_quantiles(*sg[:6], qt, min_scores=cfg.min_scores, pool_on=cfg.pool)
    bkw = dict(cap=cap, pcap=pcap, horizon=3, fallback=3.0, min_scores=cfg.min_scores,
               pool_on=cfg.pool)
    bargs = [sg[1], sg[3], raw[0], raw[1]] + sg[6:-1]
    btier = (tenant, slot_gid, gcount, raw[2], group, gcap)
    pairs = {"calib_observe": (lambda: calib.calib_observe(*og, **okw),
                               lambda: calib.calib_observe(*og[:-1], **okw)),
             "calib_begin": (lambda: calib.calib_begin(*bargs, btier, **bkw),
                             lambda: calib.calib_begin(*bargs, **bkw)),
             "calib_scales (conformal_scale + calib_begin)": (
                 lambda: calib.calib_scales(*sg, **skw),
                 lambda: calib.calib_scales(*sg[:-1], **skw))}
    out = {}
    for name, (with_tier, without) in pairs.items():
        us = {"tier": [], "no tier": []}
        for k in ("tier", "no tier", "no tier", "tier"):
            us[k].append(graph_us(with_tier if k == "tier" else without))
        out[name] = us
        log(f"  {name} at 3,072 warm rows, T = 4 (group rings of 256): device "
            + "; ".join(f"{k} {'/'.join(f'{x:.3f}' for x in v)} us a call (CUDA graph)"
                        for k, v in us.items()))
    # the bytes each needs with the tier on these inputs
    wo = ref.calib_observe(*ocpu, **okw)
    bcpu = [a.cpu() if isinstance(a, torch.Tensor) else a for a in bargs]
    wb = ref.calib_begin(*bcpu, tuple(a.cpu() if isinstance(a, torch.Tensor) else a
                                      for a in btier), **bkw)
    ages, fire = st["left"][0] > 0, st["left"][0] == 1
    res_rows = int((wo[7] - ocpu[11]).sum())
    warm = np.minimum(st["ring_count"][0], cap) >= cfg.min_scores
    m_rows = int((np.concatenate([tick["deploy"]] * 2, 1)[0] & (st["left"][0] == 0)).sum())
    T = tier["group_count"].shape[1]
    observe = (R * 4 + int(ages.sum()) * 8 + int(fire.sum()) * 8 + res_rows * 20 + 4 * 6
               + 3 * T * 4 + _nbytes(wo[14], wo[15]) + sum(
                   _changed_bits(n, o) for n, o in zip(
                       wo[:14], [ocpu[CALIB_STATE.index(k)] for k in OBSERVE_OUT]
                       + [ocpu[-1][0], ocpu[-1][1], ocpu[-1][3], ocpu[-1][4]])))
    occupied = int((table["slot_gid"][0] >= 0).sum())
    begin = (R * 4 + 8 + int(warm.sum()) * 4 + 4 + R // 2 + R * 4 + m_rows * 8 + R // 2 * 4
             + 8 + _nbytes(wb[0]) + slot_gid.numel() * 4 + occupied * 4 + 2 * T * 4
             + sum(_changed_bits(n, o) for n, o in zip(wb[1:], bcpu[8:16] + [btier[4].cpu()])))
    bounds = {"calib_observe": observe, "calib_begin": begin}
    log("  bounds with the tier (T = 4): " + ", ".join(
        f"{k} {v} B, {v / HBM_BYTES_PER_S * 1e6:.4f} us" for k, v in bounds.items()))
    return {"us": out, "bound_bytes": bounds}


def time_control(control, ref, sched, cases, calib, CalibrationConfig) -> tuple[dict, float]:
    """Phase 8: control_tick at the main path's widths (one member of 500
    apps of T = 4 tenants, 128 slots of 12 components, 50 hosts), kernel by
    CUDA events against its plain version (numpy on the host) in turns,
    its device time per launch (a CUDA graph of 50 launches) and host time
    per call, beside its bound (control_bound_bytes over 3.35 TB/s); the
    admission kernel on the busiest full-width captured admission with
    and without the gate, in turns; and the three calibration kernels
    with the per-tenant tier on the full-width warm state (T = 4), each
    beside the same launch without it.  Returns the timings and the
    largest error of control_tick against its plain version."""
    import torch
    rng = np.random.default_rng(27)
    args = control_case([control_member(rng, 4)], 4)
    gpu = [a.cuda() if a is not None else None for a in args]
    kern = lambda: control.control_tick(*gpu, **CONTROL_KW)  # noqa: E731
    plain = lambda: ref.control_tick(*args, **CONTROL_KW)  # noqa: E731
    want = plain()
    got = kern()
    assert all(_same(g, w) for g, w in zip(got, want))

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    ms = {"kernel": [], "plain": []}
    for k in ("kernel", "plain", "plain", "kernel"):
        ms[k].append(cuda_time_ms(kern, iters=200, warmup=10) if k == "kernel"
                     else host_ms(plain))
    dev_us = [graph_us(kern) for _ in range(2)]
    host_us = host_us_per_call(kern)
    nbytes = control_bound_bytes(args, want)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  control_tick (500 apps, T = 4, 128 slots of 12, 50 hosts): kernel "
        f"{'/'.join(f'{x:.5f}' for x in ms['kernel'])} ms a call back to back, plain (numpy "
        f"on the host) {'/'.join(f'{x:.3f}' for x in ms['plain'])} ms; device "
        f"{'/'.join(f'{x:.3f}' for x in dev_us)} us a launch (50 launches in a CUDA graph, "
        f"replayed), host {host_us:.3f} us per call; bound {bound * 1e3:.4f} us ({nbytes} B)")
    out = {"control_tick": dict(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]), bound_ms=bound,
                                bound_by="bytes", library_ms=None)}
    # the admission with and without the gate, on the busiest captured call
    n, busiest = max(((scan_events("admit_queued", a, ref.admit_queued(*a)), a)
                      for a in cases["admit_queued"] if a[0].shape[0] == 1),
                     key=lambda x: x[0])
    gate = gate_args(rng, busiest, 4, "all")
    agpu = [a.cuda() if isinstance(a, torch.Tensor) else a for a in busiest]
    ggpu = agpu + [g.cuda() for g in gate]
    runs = {"ungated": lambda: sched.admit_queued(*agpu),
            "gated (every tenant eligible)": lambda: sched.admit_queued(*ggpu)}
    t = {k: [] for k in runs}
    for k in list(runs) + list(runs)[::-1]:
        t[k].append(cuda_time_ms(runs[k], iters=200, warmup=10))
    dev = {k: round(graph_us(f), 3) for k, f in runs.items()}
    log(f"  admit_queued, full-width captured call with {n} admissions: " + "; ".join(
        f"{k} {'/'.join(f'{x:.5f}' for x in v)} ms" for k, v in t.items())
        + f"; device us a launch (CUDA graph) {json.dumps(dev)}")
    time_calib_tier(calib, ref, CalibrationConfig, rng)
    return out, 0.0


OBS_CPU_TICKS = 160   # the tenanted calibrated persist run with the rings, card against CPU
OBS_OFF = dict(lead_ring=None, demand=None, tenancy=None, tenancy0=None, calib=None,
               calib0=None, lead=None)


def obs_case(rng, S=1, *, A=128, C=12, N=500, T=4, R=128, inactive=(), cursors=None):
    """obs_tick's arguments (CPU tensors, ref.obs_tick's keywords) for S
    members at the engine's widths: usage and shaped demand of mixed
    magnitudes over the occupied slots (the orders of their sums
    matter), the queue before and after admission, the counters now and
    at the tick's entry, T tenants' state after and before the control
    step, the calibration's counts, a lead ring and lead; the members in
    ``inactive`` inactive."""
    import torch

    def ints(lo, hi, shape):
        return torch.from_numpy(rng.integers(lo, hi, shape).astype(np.int32))

    def table():
        occ = rng.random((S, A, 1, 1)) < 0.8
        x = rng.uniform(0, 1, (S, A, C, 2)) * 10.0 ** rng.integers(-3, 3, (S, A, C, 2))
        return torch.from_numpy((x * occ).astype(np.float32))

    at0 = ints(0, 500, (S, T))
    queued = torch.from_numpy(rng.random((S, N)) < 0.2)
    cursor = (ints(0, 4 * R, (S,)) if cursors is None
              else torch.tensor(cursors, dtype=torch.int32))
    return dict(
        cursor=cursor, f32=torch.from_numpy(rng.normal(size=(S, 5, R)).astype(np.float32)),
        i32=ints(-9, 9, (S, 8, R)), lead_ring=ints(0, 30, (S, R)),
        active=torch.tensor([i not in inactive for i in range(S)]),
        usage=table(), demand=table(), queued=queued,
        q_admit=queued | torch.from_numpy(rng.random((S, N)) < 0.02),
        counters=tuple(ints(100, 200, (S,)) for _ in range(4)),
        counters0=tuple(ints(0, 100, (S,)) for _ in range(4)),
        tenancy=(torch.from_numpy(rng.uniform(0.05, 1, (S, T)).astype(np.float32)),
                 ints(50, 90, (S, T)), at0 + ints(0, 2, (S, T))),
        tenancy0=(ints(0, 50, (S, T)), at0),
        calib=(ints(900, 999, (S,)), ints(90, 99, (S,))),
        calib0=(ints(0, 900, (S,)), ints(0, 90, (S,))), lead=ints(0, 30, (S,)))


def _obs_cuda(args):
    return {k: (tuple(x.cuda() for x in v) if isinstance(v, tuple)
                else None if v is None else v.cuda()) for k, v in args.items()}


def obs_cases():
    """(name, args) of phase 3's obs_tick checks: a full-width member with
    every feature (demand, T = 4 tenants, calibration, a leap lead) and
    with none (the baseline policy: no demand); the default path's
    features (demand only); T = 8 and T = 1; a 3-member cohort with an
    inactive member and a cursor that wraps; A = 37 slots of 5 (off the
    32-slot windows) and A = 20 (one window); a streamed window's free
    rows."""
    import torch
    rng = np.random.default_rng(25)
    default = {k: v for k, v in OBS_OFF.items() if k != "demand"}
    cases = [("full width, every feature", obs_case(rng)),
             ("full width, no feature", dict(obs_case(rng), **OBS_OFF)),
             ("full width, the default path (demand only)", dict(obs_case(rng), **default)),
             ("T = 8", obs_case(rng, T=8)), ("T = 1", obs_case(rng, T=1)),
             ("a 3-member cohort, one inactive, cursors 5, 128, 1000",
              obs_case(rng, 3, inactive=(1,), cursors=[5, 128, 1000])),
             ("A = 37 of C = 5, N = 61", obs_case(rng, 2, A=37, C=5, N=61, R=16)),
             ("A = 20 of C = 7", obs_case(rng, 2, A=20, C=7, N=33, R=8))]
    # a streamed window of 256 rows, two in five free (never queued)
    window = obs_case(rng, 2, N=256)
    free = torch.from_numpy(rng.random((2, 256)) < 0.4)
    window.update(queued=window["queued"] & ~free, q_admit=window["q_admit"] & ~free)
    cases.append(("a streamed window's free rows", window))
    return cases


OBS_CRAFTED = ("signed zeros", "NaN and inf", "near 2^-126", "T = 1", "T = 32", "T = 33",
               "T = 1024", "A = 20, C = 7, N = 61", "A = 37, C = 6", "A = 37, C = 5",
               "a cohort: an inactive member, a cursor that wraps")


def obs_crafted(name):
    """obs_tick's arguments (CPU tensors, keywords) of crafted case
    ``name``: the engine's widths with every feature (A = 128 slots of C =
    12, N = 500, T = 4) unless the name says otherwise; tables of signed
    zeros, with NaNs of the TWO_NANS payloads and +-inf, or of values near
    2^-126 whose sums pass below it (and credits among them); T of 1, 32,
    33 and 1,024 (the credit mean's tree of two windows and more); A of 20
    and 37 with C odd (the tables staged by plain loads) and even (a bulk
    copy a window of 19 and of 18 slots); a cohort with an inactive
    member and cursors that wrap."""
    import torch
    rng = np.random.default_rng(70 + OBS_CRAFTED.index(name))
    kw = {"T = 1": dict(T=1), "T = 32": dict(T=32), "T = 33": dict(T=33),
          "T = 1024": dict(T=1024), "A = 20, C = 7, N = 61": dict(A=20, C=7, N=61, R=8),
          "A = 37, C = 6": dict(A=37, C=6, R=16), "A = 37, C = 5": dict(A=37, C=5, R=16),
          "a cohort: an inactive member, a cursor that wraps": dict(
              S=3, inactive=(1,), cursors=[127, 6, 255])}.get(name, {})
    args = obs_case(rng, **kw)
    use, dem = args["usage"].numpy(), args["demand"].numpy()
    if name == "signed zeros":
        for x in (use, dem):
            x[...] = np.where(rng.random(x.shape) < 0.5, np.float32(-0.0), np.float32(0.0))
    elif name == "NaN and inf":
        for x in (use, dem):
            hit = rng.random(x.shape) < 0.01
            x[...] = np.where(hit, rng.choice(TWO_NAN_VALUES, x.shape), x)
        args["tenancy"][0][0, 1] = float(TWO_NANS.view(np.float32)[0])
    elif name == "near 2^-126":
        for x in (use, dem):
            x[...] = np.where(x != 0, rng.choice(TINY_VALUES, x.shape), x)
        args["tenancy"][0][0, :] = torch.from_numpy(rng.choice(TINY_VALUES, args["tenancy"][0].shape[1]))
    return args


# (A, C) of the crafted tables on the card: XLA:CPU's serial windows (C
# of 1, 5 and 12, A padded off the 32-slot grid) and each of its
# vectorised loops (ref.xla_table_plan): 8 lanes at A = 17, 64, 128 and
# 256, 4 lanes at A = 20 and 95, unrolled at A = 8.
TABLE_SHAPES = ((20, 1), (20, 2), (20, 3), (20, 4), (17, 3), (8, 2), (37, 3), (37, 5),
                (64, 2), (64, 4), (95, 3), (128, 3), (128, 12), (256, 1), (256, 4))


def crafted_tables(A, C, seed=0) -> np.ndarray:
    """(10, A, C, 2) float32 tables whose sums over (A, C) show XLA:CPU's
    order: mixed magnitudes; -0 in slot 0; every entry -0; -0 but a +0
    first; NaNs of the TWO_NANS payloads (two quiet, two signalling) and
    +-inf in 2%, 20% and 90% of the entries (so that two NaNs meet in a
    lane, in the tree and in the tail); values near 2^-126, which XLA:CPU
    reads and flushes as zeros; a signalling NaN first."""
    rng = np.random.default_rng(seed * 1000 + A * 40 + C)
    base = (rng.uniform(0, 1, (A, C, 2)) * 10.0 ** rng.integers(-3, 3, (A, C, 2))
            ).astype(np.float32)
    out = [base, base.copy(), np.full_like(base, -0.0), np.full_like(base, -0.0)]
    out[1][0] = -0.0
    out[3][0, 0] = 0.0
    for p in (0.02, 0.2, 0.9):
        x = base.copy()
        hit = rng.random(x.shape) < p
        x[hit] = rng.choice(TWO_NAN_VALUES, int(hit.sum()))
        out.append(x)
    out.append(np.where(rng.random(base.shape) < 0.7,
                        rng.choice(TINY_VALUES, base.shape), 0).astype(np.float32))
    x = base.copy()
    x[0, 0] = TWO_NANS.view(np.float32)[2]
    out.append(x)
    return np.stack(out)


def obs_table_case(A, C):
    """obs_tick's arguments with every feature, one member a crafted table
    of ``crafted_tables(A, C)`` as its usage and the next as its demand."""
    import torch
    tabs = crafted_tables(A, C)
    S = len(tabs)
    args = obs_case(np.random.default_rng(A * 40 + C), S, A=A, C=C, N=40, R=8)
    args["usage"] = torch.from_numpy(tabs)
    args["demand"] = torch.from_numpy(np.roll(tabs, 1, axis=0).copy())
    return args


def check_obs(obs_kernel, ref) -> float:
    """Phase 3: obs_tick on the card against its plain version, every
    output bit for bit, one launch a call: the seeded cases, OBS_CRAFTED
    and the crafted tables at TABLE_SHAPES."""
    crafted = [(f"crafted case {n!r}", obs_crafted(n)) for n in OBS_CRAFTED]
    crafted += [(f"crafted tables, A = {A}, C = {C}", obs_table_case(A, C))
                for A, C in TABLE_SHAPES]
    for name, args in obs_cases() + crafted:
        want = ref.obs_tick(**args)
        n = obs_kernel.obs_tick.launches
        got = obs_kernel.obs_tick(**_obs_cuda(args))
        assert obs_kernel.obs_tick.launches == n + 1
        for k, g, w in zip(("cursor", "f32", "i32", "lead_ring"), got, want):
            assert (g is None) == (w is None), f"obs_tick, {name}: {k}"
            assert g is None or _same(g, w), f"obs_tick, {name}: {k} differs"
        log(f"  obs_tick, {name}: kernel == plain, every output bit for bit; cursors "
            f"{want[0].tolist()}")
    obs_kernel.reset_launch_counts()
    return 0.0


def obs_bound_bytes(args, outs) -> int:
    """The bytes obs_tick needs on one case: each input read once (the two
    (A, C, 2) tables, the queue masks, the rings, the counters and the
    tenant and calibration state) and each output (the rings) written
    once."""
    ins = [v for v in args.values() if v is not None]
    flat = [x for v in ins for x in (v if isinstance(v, tuple) else (v,))]
    return _nbytes(*flat) + _nbytes(*(o for o in outs if o is not None))


def _histories_equal(a, b) -> bool:
    return list(a) == list(b) and all(
        a[k].dtype == b[k].dtype and np.array_equal(a[k].view(np.int32), b[k].view(np.int32))
        for k in a)


def run_obs(step, scenarios, SimConfig, WorkloadConfig, ClusterConfig, TenancyConfig,
            CalibrationConfig, ObsConfig, obs_kernel) -> int:
    """Phase 5i: the telemetry rings on the card.  SimConfig(obs=
    ObsConfig(enabled=True)) on the device engine to completion through
    replayed graphs (a 64-tick run captures first), every chunk
    sync-free, its summary and series equal to the rings-off run's; one
    obs_tick launch a tick, the count (set to 0 just before the run, read
    just after) equal to replays x its nodes; kernels a tick and ticks/s
    in turns against the rings off; the history's event channels against
    the run's counters.  Then phase 5h's tenanted, calibrated path with
    the rings (every channel live; equal to it without them, its tenant
    and calibration counters equal to the histories' sums), the gap cell's
    leap histories against uniform ones, and OBS_CPU_TICKS ticks of the
    tenanted persist path card against CPU, histories included (any
    difference fails).  Prints the seconds of each step.  Returns the main
    run's obs_tick launches."""
    import torch
    on, off = SimConfig(obs=ObsConfig(enabled=True)), SimConfig()
    guard = strict_chunks(step)
    steps, t_step = {}, [time.perf_counter()]

    def done(what):
        t = time.perf_counter()
        steps[what] = round(t - t_step[0], 1)
        t_step[0] = t
    try:
        step.run_sim_scan(dataclasses.replace(on, max_ticks=64), device="cuda")
        entry = find_entry(step, on)
        before = {k: g.replays for k, g in entry.graphs.items()}
        obs_kernel.reset_launch_counts()
        c0 = guard.chunks
        t = time.perf_counter()
        res = step.run_sim_scan(on, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        launches = obs_kernel.obs_tick.launches
        in_graphs = graph_census(entry, before, {"obs_tick": launches})["obs_tick"]
        ticks = res.timings["ticks"]
        s, h = res.summary(), res.obs
        log(f"  device engine, rings on: {ticks} ticks in {guard.chunks - c0} chunks "
            f"(sync-free), {t:.3f} s: {ticks / t:.3f} ticks/s (capture before); obs_tick "
            f"launches {launches} = replays x kernel nodes {in_graphs}")
        totals = {k: (float(v.sum()) if v.dtype == np.float32 else int(v.sum()))
                  for k, v in h.items()}
        log(f"    history totals over {len(h['queue'])} ticks {json.dumps(totals)}")
        assert launches == in_graphs == ticks, (launches, in_graphs, ticks)
        roff = step.run_sim_scan(off, device="cuda")
        assert run_series(res) == run_series(roff), "the rings changed the run"
        assert len(h["queue"]) == len(res.n_running) and res.obs is not None
        assert totals["oom"] == s["oom_kills"] and totals["fail"] == s["failure_events"]
        assert totals["preempt"] == s["full_preemptions"] + s["partial_preemptions"], totals
        assert totals["admitted"] >= s["completed"] == 500, (totals, s)
        assert h["queue"].min() >= 0 and np.all(h["used_mem"] <= 50 * 128.0 * (1 + 1e-6))
        done("device, rings on")
        oentry = find_entry(step, off)
        walls = {"rings on": [], "rings off": []}
        for mode in ("rings on", "rings off", "rings off", "rings on"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = step.run_sim_scan(on if mode == "rings on" else off, device="cuda")
            torch.cuda.synchronize()
            walls[mode].append(r.timings["ticks"] / (time.perf_counter() - t))
        k_on, k_off = kernels_per_step(entry), kernels_per_step(oentry)
        log("  device engine ticks/s in turns (on, off, off, on): " + "; ".join(
            f"{m} " + ", ".join(f"{x:.3f}" for x in xs) for m, xs in walls.items())
            + f"; kernels a tick {k_on:.3f} with the rings against {k_off:.3f} without "
            f"(+{k_on - k_off:.3f})")
        assert k_on - k_off == 1.0, (k_on, k_off)
        for line in describe_graphs(entry):
            log(f"  rings graph {line}")
        done("turns")
        tcfg = tenancy_config(SimConfig, WorkloadConfig, TenancyConfig, CalibrationConfig,
                              obs=ObsConfig(enabled=True))
        toff = dataclasses.replace(tcfg, obs=ObsConfig())
        step.run_sim_scan(dataclasses.replace(tcfg, max_ticks=64), device="cuda")
        tentry = find_entry(step, tcfg)
        before = {k: g.replays for k, g in tentry.graphs.items()}
        obs_kernel.reset_launch_counts()
        tres = step.run_sim_scan(tcfg, device="cuda")
        tl = obs_kernel.obs_tick.launches
        tin = graph_census(tentry, before, {"obs_tick": tl})["obs_tick"]
        th, ts = tres.obs, tres.summary()
        zero = [k for k, v in th.items() if not np.any(v != 0)]
        log(f"  tenanted calibrated, rings on: {tres.timings['ticks']} ticks, obs_tick "
            f"launches {tl} = replays x kernel nodes {tin}; channels never nonzero {zero}; "
            f"admitted {int(th['admitted'].sum())}, throttled {int(th['throttled'].sum())}, "
            f"resolved {int(th['cov_resolved'].sum())}, credit mean "
            f"{float(th['credit'].mean()):.6f}; kernels a tick {kernels_per_step(tentry):.3f}")
        assert tl == tin == tres.timings["ticks"], (tl, tin)
        assert run_series(tres) == run_series(step.run_sim_scan(toff, device="cuda"))
        assert int(th["admitted"].sum()) == sum(ts["tenancy"]["admitted"])
        assert int(th["throttled"].sum()) == sum(ts["tenancy"]["throttled"])
        assert int(th["cov_resolved"].sum()) == ts["calibration"]["resolved"]
        assert int(th["cov_errors"].sum()) == ts["calibration"]["miscovered"]
        done("tenanted")
        gap = gap_config(SimConfig, ClusterConfig, scenarios, obs=ObsConfig(enabled=True))
        u, lp = (step.run_sim_scan(c, device="cuda")
                 for c in (gap, dataclasses.replace(gap, leap=True)))
        assert _histories_equal(lp.obs, u.obs) and run_series(lp) == run_series(u)
        log(f"  gap cell: leap histories == uniform on the card over {len(u.obs['queue'])} "
            f"ticks ({lp.timings['steps']} leap steps)")
        done("gap cell")
    finally:
        guard.stop()
    pcfg = dataclasses.replace(tcfg, forecaster="persist", max_ticks=OBS_CPU_TICKS)
    a = step.run_sim_scan(pcfg, device="cuda")
    b = step.run_sim_scan(pcfg, device="cpu")
    same = {k: bool(np.array_equal(a.obs[k].view(np.int32), b.obs[k].view(np.int32)))
            for k in a.obs}
    assert run_series(a) == run_series(b) and all(same.values()), (
        "tenanted persist with the rings: card != cpu", same)
    log(f"  tenanted calibrated persist with the rings, first {OBS_CPU_TICKS} ticks: card == "
        f"cpu, summaries, series and every history bit for bit")
    done("card vs cpu")
    log(f"  phase 5i seconds by step: {json.dumps(steps)}")
    return launches


# ----------------------------------------------------------------------
# the sweep driver (phase 5j)
# ----------------------------------------------------------------------

# the schema-3 keys of BENCH_sweep.json (repro/sim/sweep.py:387-401)
SWEEP_KEYS = ("aggregates", "base", "calibration", "cells", "engine", "forecast_batches",
              "forecast_error", "forecast_requests", "mesh_devices", "scenarios", "schema",
              "wall_s")
# the forecast diagnostics, card against CPU: the GP's rows agree to rtol
# 1e-3 (mean) and 5e-3 (variance), ARIMA's to 1e-4 of the row's scale and
# 1e-3 (tests/test_torch_sweep.py's DIAG_RTOL, from the forecasters' tests)
DIAG_RTOL = {"gp": 5e-3, "arima": 1e-3}
SWEEP_POLICIES = ("baseline", "pessimistic")
SWEEP_SEEDS = (0, 1)


class record_calls(count_calls):
    """:class:`count_calls` that also keeps each call's arguments and
    result, ``(args, kwargs, result)``; safe from several threads (a list
    append)."""

    def __init__(self, owner, name):
        super().__init__(owner, name)
        self.calls = []
        inner = self.orig

        def recorded(*a, **k):
            self.n += 1
            out = inner(*a, **k)
            self.calls.append((a, k, out))
            return out
        self._set(recorded)


def _report_diff(got, want, rtol, path="") -> float:
    """Hold two diagnostic records equal but their floats, those within
    ``rtol``; return the largest relative difference of the floats."""
    if isinstance(want, dict):
        assert got.keys() == want.keys(), path
        return max([_report_diff(got[k], want[k], rtol, f"{path}.{k}") for k in want] or [0.0])
    if isinstance(want, list):
        assert len(got) == len(want), path
        return max([_report_diff(g, w, rtol, f"{path}[{i}]")
                    for i, (g, w) in enumerate(zip(got, want))] or [0.0])
    if isinstance(want, float):
        assert abs(got - want) <= rtol * abs(want), (path, got, want)
        return abs(got - want) / abs(want) if want else 0.0
    assert got == want, (path, got, want)
    return 0.0


def run_sweep(step, scenarios, SimConfig, ObsConfig, GPForecaster, gp_forecast, calib,
              smi) -> dict:
    """Phase 5j: the sweep driver on the card, at SimConfig()'s full width.

    The scan grid: run_grid(SimConfig(), policy x 2 seeds, engine="scan",
    obs=True), two seed cohorts to completion, every chunk sync-free;
    each cell's summary, series, forecast rows and ring histories equal
    to its solo run_sim_scan on the card, but the rows the bucketed
    forecast ran (the cohort's bucket covers its largest member); the results, manifest and
    dashboard written to a temporary directory, the results' keys the
    schema-3 set.  The host grid: policy x calibration (sigma,
    conformal) x 2 seeds of the GP at MAIN_PATH_TICKS ticks on the
    thread pool with the batcher (barrier mode: the grid is homogeneous),
    each cell equal to its solo run_sim on the card, fewer batches than
    requests and one gp_fit_forecast
    launch a batch; then again without the batcher.  The fitted family
    of the Alibaba fixture at 500 apps on the device engine for
    FAMILY_TICKS ticks, and the GP's and ARIMA's forecast diagnostics
    card against CPU within DIAG_RTOL.  Prints the walls, ticks per
    second and rows per launch beside the card's name and power limit,
    and returns the launch counts of the new paths."""
    import tempfile

    import torch
    from repro_torch.obs import load_manifest
    from repro_torch.sim import sweep
    from repro_torch.sim.scenarios import diagnostics
    steps, t_step = {}, [time.perf_counter()]

    def done(what):
        t = time.perf_counter()
        steps[what] = round(t - t_step[0], 1)
        t_step[0] = t

    on = SimConfig(obs=ObsConfig(enabled=True))
    launches = {}
    guard = strict_chunks(step)
    try:
        # solo runs first: seed 0 of each policy captures its graph, seed 1 is timed clean
        solo = {}
        for p in SWEEP_POLICIES:
            for s in SWEEP_SEEDS:
                cfg = dataclasses.replace(on, policy=p,
                                          workload=dataclasses.replace(on.workload, seed=s))
                torch.cuda.synchronize()
                t = time.perf_counter()
                r = step.run_sim_scan(cfg, device="cuda")
                torch.cuda.synchronize()
                solo[(p, s)] = (r, time.perf_counter() - t)
        done("solo scan runs")
        rec = record_calls(step, "run_cohort_scan")
        gp_forecast.reset_launch_counts()
        calib.reset_launch_counts()
        with tempfile.TemporaryDirectory() as tmp:
            out = Path(tmp) / "BENCH_sweep.json"
            t = time.perf_counter()
            res = sweep.run_grid(SimConfig(), {"policy": list(SWEEP_POLICIES)},
                                 seeds=list(SWEEP_SEEDS), engine="scan", obs=True,
                                 out_path=str(out), dashboard_path=str(Path(tmp) / "dash.html"),
                                 device="cuda")
            torch.cuda.synchronize()
            wall = time.perf_counter() - t
            rec.stop()
            data = json.loads(out.read_text())
            assert tuple(sorted(data)) == SWEEP_KEYS, sorted(data)
            assert data["schema"] == 3 and data["engine"] == "scan" and len(data["cells"]) == 4
            man = load_manifest(str(Path(tmp) / "BENCH_sweep.manifest.json"))
            assert len(man["cells"]) == 4 and (Path(tmp) / "dash.html").stat().st_size > 0
            alerts = sum(len(c["obs"]["alerts"]) for c in data["cells"])
        launches["scan grid"] = {"gp_fit_forecast": gp_forecast.gp_fit_forecast.launches,
                                 "conformal_scale": calib.conformal_scale.launches}
        got = {}
        for (cfg, seeds, *_), _, results in rec.calls:
            assert list(seeds) == list(SWEEP_SEEDS)       # each combo one cohort
            got.update({(cfg.policy, s): r for s, r in zip(seeds, results)})
        ticks, bucketed = {}, {}
        for key, (r, _) in solo.items():
            g = got[key]
            assert run_series(g) == run_series(r), f"scan grid cell {key} != its solo run"
            # rows_bucketed counts the rows the model ran: a cohort's bucket
            # covers its members' largest ready count (as the reference's,
            # repro/sim/step.py:1137-1140), so a member's is at least its solo's
            fg, fs = dict(g.forecast_rows or {}), dict(r.forecast_rows or {})
            bucketed[key] = (fg.pop("rows_bucketed", None), fs.pop("rows_bucketed", None))
            assert fg == fs and (bucketed[key][0] or 0) >= (bucketed[key][1] or 0), (
                key, g.forecast_rows, r.forecast_rows)
            assert _histories_equal(g.obs, r.obs), key
            ticks[key] = len(r.n_running)
        for c in res.cells:
            assert c["summary"] == solo[(c["overrides"]["policy"], c["seed"])][0].summary()
            assert c["summary"]["completed"] == 500, c["summary"]
        done("scan grid, checked")
        # the same grid again, its graphs captured: the cohorts' own seconds
        rec = record_calls(step, "run_cohort_scan")
        t = time.perf_counter()
        sweep.run_grid(SimConfig(), {"policy": list(SWEEP_POLICIES)}, seeds=list(SWEEP_SEEDS),
                       engine="scan", obs=True, forecast_diag=False, device="cuda")
        torch.cuda.synchronize()
        wall2 = time.perf_counter() - t
        rec.stop()
        done("scan grid, timed")
        rates = []
        for (cfg, *_), _, results in rec.calls:
            sec = results[0].timings["total"]
            member = [len(r.n_running) / sec for r in results]
            r1, w1 = solo[(cfg.policy, SWEEP_SEEDS[-1])]
            rates.append(f"{cfg.policy}: cohort of {len(results)} {sec:.3f} s, "
                         + ", ".join(f"{x:.3f}" for x in member)
                         + f" ticks/s a member ({sum(member):.3f} in all) against solo "
                         f"{len(r1.n_running) / w1:.3f}")
        log(f"  FINDING scan grid (SimConfig(), policy x 2 seeds, rings on; {smi}): wall "
            f"{wall:.3f} s with its captures and diagnostics, {wall2:.3f} s captured and "
            f"without them; " + "; ".join(rates) + f"; {alerts} alerts; launches "
            f"{json.dumps(launches['scan grid'])}; cells == solo run_sim_scan (summaries, "
            f"series, forecast rows but rows_bucketed, ring histories); rows_bucketed "
            f"(cohort member, solo) " + ", ".join(f"{p}/{sd} {b}" for (p, sd), b in
                                                  bucketed.items()))

        # the fitted family of the Alibaba fixture, at 500 apps
        data_dir = Path(__file__).resolve().parent / "tests" / "data"
        fit = scenarios.fit_trace(scenarios.load_trace(str(data_dir / "alibaba_tiny.csv"),
                                                       preset="alibaba"), n_apps=500)
        fcfg = SimConfig(workload=fit, max_ticks=FAMILY_TICKS)
        t = time.perf_counter()
        fr = step.run_sim_scan(fcfg, device="cuda")
        torch.cuda.synchronize()
        t = time.perf_counter() - t
        assert all(np.isfinite(fr.util_mem)) and max(fr.n_running) > 0
        log(f"  fitted family (alibaba fixture, 500 apps x {fit.max_components} components, "
            f"rate {fit.rate:.6g}/s, elastic {fit.elastic_frac:.3f}): {fr.timings['ticks']} "
            f"ticks in {t:.3f} s with its capture, completed {fr.summary()['completed']}, "
            f"forecast rows {fr.forecast_rows}")
        done("fitted family")
    finally:
        guard.stop()

    # the host grid on the thread pool, through the batcher
    hcfg = SimConfig(max_ticks=MAIN_PATH_TICKS)
    axes = {"policy": list(SWEEP_POLICIES), "calibration": ["sigma", "conformal"]}
    walls, rows = {}, {}
    for batched in (True, False):
        runs = record_calls(sweep, "run_sim")
        fc = record_calls(GPForecaster, "forecast_batch")
        gp_forecast.reset_launch_counts()
        calib.reset_launch_counts()
        t = time.perf_counter()
        hres = sweep.run_grid(hcfg, axes, seeds=list(SWEEP_SEEDS), engine="vectorized",
                              batch_forecasts=batched, batch_mode="barrier",
                              forecast_diag=False, device="cuda")
        torch.cuda.synchronize()
        walls[batched] = time.perf_counter() - t
        runs.stop()
        fc.stop()
        n_gp = gp_forecast.gp_fit_forecast.launches
        # rows a launch: padded to the power-of-two bucket, and those with a window
        rows[batched] = (sum(a[1].shape[0] for a, _, _ in fc.calls) / max(n_gp, 1),
                         sum(int(np.asarray(k["valid"]).any(1).sum()) for _, k, _ in fc.calls)
                         / max(n_gp, 1))
        if batched:
            launches["host grid"] = {"gp_fit_forecast": n_gp,
                                     "conformal_scale": calib.conformal_scale.launches}
            assert 0 < hres.forecast_batches < hres.forecast_requests, (
                hres.forecast_batches, hres.forecast_requests)
            assert n_gp == hres.forecast_batches == fc.n, (n_gp, hres.forecast_batches, fc.n)
            batches = (hres.forecast_batches, hres.forecast_requests)
            cells = {a[0]: out for a, _, out in runs.calls}
            summaries = [c["summary"] for c in hres.cells]
        else:
            assert [c["summary"] for c in hres.cells] == summaries
            assert hres.forecast_batches == 0 and n_gp == fc.n
    done("host grid, both")
    assert len(cells) == 8
    for cfg, g in cells.items():
        r = sweep.run_sim(cfg, device="cuda")
        assert run_series(g) == run_series(r), f"host grid cell {cfg.policy}/" \
            f"{cfg.calibration.enabled}/{cfg.workload.seed} != its solo run_sim"
    done("host grid, solo runs")
    log(f"  FINDING host grid (SimConfig(max_ticks={MAIN_PATH_TICKS}), GP, policy x "
        f"calibration (sigma, conformal) x 2 seeds, 8 cells on the thread pool; {smi}): wall "
        f"{walls[True]:.3f} s with the batcher, barrier mode ({batches[1]} requests in "
        f"{batches[0]} batches; "
        f"rows a gp_fit_forecast launch {rows[True][1]:.1f}, {rows[True][0]:.1f} padded), "
        f"{walls[False]:.3f} s with batch_forecasts=False ({rows[False][1]:.1f} rows a launch, "
        f"{rows[False][0]:.1f} padded); launches "
        f"{json.dumps(launches['host grid'])}; every cell == its solo run_sim bit for bit")

    # the forecast diagnostics, card against CPU
    tr = scenarios.build_trace(SimConfig().workload)
    worst = {}
    for name in ("gp", "arima"):
        calib.reset_launch_counts()
        a = diagnostics.forecast_reports(tr, name, gp=SimConfig().gp, arima=SimConfig().arima,
                                         device="cuda")
        n_cs = calib.conformal_scale.launches
        b = diagnostics.forecast_reports(tr, name, gp=SimConfig().gp, arima=SimConfig().arima,
                                         device="cpu")
        worst[name] = _report_diff(list(a), list(b), DIAG_RTOL[name])
        assert n_cs == 3, n_cs      # one conformal_scale launch a coverage level
        log(f"  {name} diagnostics card vs CPU: largest relative difference "
            f"{worst[name]:.3g} (tolerance {DIAG_RTOL[name]}); median |rel err| "
            f"{a[0]['abs_rel_err_median']:.6f} (cpu {b[0]['abs_rel_err_median']:.6f}), "
            f"coverage at q=0.9 {a[1]['levels'][1]['conformal_coverage']} conformal, "
            f"{a[1]['levels'][1]['gaussian_coverage']} gaussian")
    done("diagnostics")
    log(f"  phase 5j seconds by step: {json.dumps(steps)}")
    return launches


# ----------------------------------------------------------------------
# streamed ingestion and fleets (phase 5k)
# ----------------------------------------------------------------------

STREAM_TASKS = 20_000      # the reference replay bench's quick size (benchmarks/replay.py:107)
STREAM_SLICE = 1_500       # its identity slice (SLICE_APPS)
FLEET_TICKS = 320          # each fleet member's ticks (as phase 5d's families)
GROW_WINDOW = 16           # phase 5k(b)'s first window, below SimConfig()'s peak rows
SIM_KERNELS = ("pessimistic_pass", "resolve_oom", "admit_queued", "place_missing_elastic",
               "gp_fit_forecast")


def synthetic_alibaba(FittedConfig, n_apps: int, seed: int = 0):
    """The reference replay bench's Alibaba-container-shaped trace
    (benchmarks/replay.py:46-69, copied): rigid single-component
    containers, lognormal sizes and lifetimes, ~55%-utilized CPU
    reservations, arriving at 24 concurrent containers by Little's law
    against 32 slots."""
    import math
    mean_life = 480.0 * math.exp(0.4 ** 2 / 2)     # lognormal mean, s
    return FittedConfig(
        n_apps=n_apps, max_components=1, seed=seed, rate=24.0 / mean_life,
        runtime_mu=math.log(480.0), runtime_sigma=0.4, cpu_mu=math.log(2.0), cpu_sigma=0.5,
        mem_mu=math.log(4.0), mem_sigma=0.7, comp_weights=(1.0,),
        cpu_level_mu=0.55, cpu_level_sigma=0.22, mem_level_mu=0.60, mem_level_sigma=0.10)


def replay_bench_config(SimConfig, ClusterConfig, workload, **over):
    """The reference replay bench's cluster (benchmarks/replay.py:72-78):
    8 hosts, 32 slots, persist, pessimistic."""
    return SimConfig(cluster=ClusterConfig(n_hosts=8, max_running_apps=32), workload=workload,
                     policy="pessimistic", forecaster="persist", max_ticks=200_000, **over)


class capture_log:
    """Record, until ``stop()``, each graph the device engine captures: its
    entry's trace rows (a streamed window's W), members and chunk size."""

    def __init__(self, step):
        self.step, self.caps = step, []
        self.capture = step._ChunkGraphs._capture

        def capture(entry, size):
            self.caps.append((entry.tr.submit.shape[1], entry.tr.submit.shape[0], size))
            return self.capture(entry, size)
        step._ChunkGraphs._capture = capture

    def take(self) -> list:
        out, self.caps = self.caps, []
        return out

    def stop(self):
        self.step._ChunkGraphs._capture = self.capture


def by_width(caps) -> str:
    """Captures by the window's rows, as 'W: n'."""
    return ", ".join(f"W {w}: {n}" for w, n in sorted(collections.Counter(c[0] for c in caps)
                                                        .items()))


def stream_entries(step, cfg, A, C):
    """The graph entries of ``cfg``'s key at the 32-tick chunk for one
    member of A slots of C components, any trace rows."""
    return {k: e for k, e in step._GRAPHS.items()
            if k[0] == step._cfg_key(cfg) and k[1] == 32 and k[2][:3] == (1, A, C)}


def census_run(step, run, cfg, A, C, mods, launches_of):
    """``run()`` with every kernel count set to 0 just before and read just
    after, held to the replays of the graph entries of ``cfg`` (A, C) x
    each wrapper's kernel nodes: no entry may be made inside (a new entry's
    warm-up tick would launch outside its graph).  Returns the result,
    its wall seconds, the counts and the census."""
    import torch
    entries = stream_entries(step, cfg, A, C)
    before = {k: {n: g.replays for n, g in e.graphs.items()} for k, e in entries.items()}
    keys = set(step._GRAPHS)
    for m in mods:
        m.reset_launch_counts()
    torch.cuda.synchronize()
    t = time.perf_counter()
    res = run()
    torch.cuda.synchronize()
    wall = time.perf_counter() - t
    launches = launches_of()
    assert set(step._GRAPHS) == keys, "a graph entry was made inside the census run"
    census = dict.fromkeys(launches, 0)
    for k, e in entries.items():
        for w, n in graph_census(e, before[k], launches).items():
            census[w] += n
    return res, wall, launches, census


def run_stream(step, scenarios, SimConfig, ClusterConfig, sched, leap, mods,
               launches_of) -> None:
    """Phase 5k: streamed ingestion and fleets on the card.

    (a) ``SimConfig()`` with its workload streamed (``StreamConfig``, the
    default window: 256 rows against 500 apps) to completion through
    replayed graphs, equal to the materialized run bit for bit (summaries,
    per-tick series, turnaround, failed apps, forecast rows); its captures
    by window width; a second streamed run with every count set to 0 just
    before, one launch a tick of each sim kernel, counted against the
    graphs' kernel nodes; ticks/s of both in turns.  (b) A window of
    GROW_WINDOW rows that grows, equal to the materialized run; the leap
    gap cell streamed in a window of 8 against materialized, bit for bit,
    leap_skip's launches = replays x its nodes = the leap steps.  (c) The reference
    replay bench's Alibaba-shaped trace of STREAM_TASKS tasks (A = 32, 8
    hosts, persist, window 64, chunk 32): every task loaded and done,
    ticks/s and tasks/s, peak rows, grows and captures; why the
    materialized run of 100,000 cannot launch; its STREAM_SLICE-task
    slice streamed against materialized, uniform and leap, bit for bit.
    (d) ``run_fleet_shard(mesh=1)`` over google and flashcrowd at 500 apps
    for FLEET_TICKS ticks: each member equal to its solo run (the
    cohort's rows_bucketed aside)."""
    import torch
    from repro_torch.sim.scenarios.stream import StreamConfig, run_sim_stream
    guard = strict_chunks(step)
    caps = capture_log(step)
    steps = {}
    try:
        # (a) the default simulation, streamed
        t0 = time.perf_counter()
        base = SimConfig()
        scfg = SimConfig(workload=StreamConfig(inner=base.workload))
        caps.take()
        stats = {}
        first = run_sim_stream(scfg, stats=stats, device="cuda")
        first_caps = caps.take()
        mat = step.run_sim_scan(base, device="cuda")
        assert run_series(first) == run_series(mat), "streamed != materialized (default)"
        assert first.forecast_rows == mat.forecast_rows, (first.forecast_rows, mat.forecast_rows)
        res, t_s, launches, census = census_run(
            step, lambda: step.run_sim_scan(scfg, device="cuda"), base, 128, 12, mods,
            launches_of)
        ticks = res.timings["ticks"]
        assert run_series(res) == run_series(mat), "streamed != materialized (census run)"
        assert launches == census, (launches, census)
        assert all(launches[k] == ticks for k in SIM_KERNELS), (launches, ticks)
        walls = {"materialized": [], "streamed": [t_s]}
        for mode in ("materialized", "streamed", "materialized"):
            torch.cuda.synchronize()
            t = time.perf_counter()
            r = step.run_sim_scan(base if mode == "materialized" else scfg, device="cuda")
            torch.cuda.synchronize()
            walls[mode].append(time.perf_counter() - t)
            assert run_series(r) == run_series(mat), mode
        by_rows = {k[2][3]: e for k, e in stream_entries(step, base, 128, 12).items()}
        w256, w500 = by_rows[stats["window_rows"]], by_rows[500]
        log(f"  (a) SimConfig() streamed (window {stats}) == materialized on the card: "
            f"{ticks} ticks, {res.summary()['completed']} apps completed; summaries, per-tick "
            f"series, turnaround, failed apps and forecast rows bit for bit")
        log(f"  (a) captures of the first streamed run: {len(first_caps)} ({by_width(first_caps)})"
            f"; the census run made none")
        log("  (a) ticks/s in turns (streamed, materialized, streamed, materialized): "
            + "; ".join(f"{m} " + ", ".join(f"{ticks / w:.3f}" for w in ws)
                        for m, ws in walls.items()))
        log(f"  (a) kernels a tick in the W = {stats['window_rows']} graph "
            f"{kernels_per_step(w256):.3f} (materialized, N = 500: "
            f"{kernels_per_step(w500):.3f}); launches {launches} = replays x kernel nodes "
            f"{census}; one a tick of each sim kernel")
        steps["a"] = round(time.perf_counter() - t0, 1)

        # (b) a window that grows (the default run's peak is ~52 rows, so it
        # starts at 16); leap on the gap cell
        t0 = time.perf_counter()
        caps.take()
        sg = {}
        rg = run_sim_stream(SimConfig(workload=StreamConfig(inner=base.workload,
                                                            window=GROW_WINDOW)),
                            stats=sg, device="cuda")
        capsg = caps.take()
        assert run_series(rg) == run_series(mat), f"window {GROW_WINDOW} != materialized"
        assert rg.forecast_rows == mat.forecast_rows
        assert sg["grows"] >= 1, sg
        log(f"  (b) window {GROW_WINDOW} grown to {sg['window_rows']} ({sg['grows']} grows, "
            f"peak {sg['peak_rows']} rows) == materialized; captures {len(capsg)} "
            f"({by_width(capsg)})")
        gap = gap_config(SimConfig, ClusterConfig, scenarios)
        lgap = dataclasses.replace(gap, leap=True)
        slgap = dataclasses.replace(lgap, workload=StreamConfig(inner=gap.workload, window=8))
        lm = step.run_sim_scan(lgap, device="cuda")
        caps.take()
        gstats = {}
        ls = run_sim_stream(slgap, stats=gstats, device="cuda")
        assert run_series(ls) == run_series(lm), "gap cell: streamed leap != materialized"
        res, _, gl, gcensus = census_run(
            step, lambda: step.run_sim_scan(slgap, device="cuda"), lgap, 16, 4, [leap],
            lambda: {"leap_skip": leap.leap_skip.launches})
        assert run_series(res) == run_series(lm)
        assert gl == gcensus and gl["leap_skip"] == res.timings["steps"], (gl, gcensus,
                                                                           res.timings)
        log(f"  (b) gap cell, leap, streamed in a window of 8 ({gstats}) == materialized "
            f"over {len(lm.n_running)} ticks; leap steps {res.timings['steps']} (materialized "
            f"{lm.timings['steps']}); leap_skip launches {gl['leap_skip']} = replays x kernel "
            f"nodes {gcensus['leap_skip']} = steps; captures {by_width(caps.take())}")
        steps["b"] = round(time.perf_counter() - t0, 1)

        # (c) a trace the card cannot hold whole
        t0 = time.perf_counter()
        fit = synthetic_alibaba(scenarios.FittedConfig, STREAM_TASKS)
        wl = scenarios.build_trace(fit)
        cfg = replay_bench_config(SimConfig, ClusterConfig, fit)
        caps.take()
        cs = {}
        run_sim_stream(cfg, wl, chunk=32, window=64, stats=cs, device="cuda")
        ccaps = caps.take()
        torch.cuda.synchronize()
        t = time.perf_counter()
        cs = {}
        big = run_sim_stream(cfg, wl, chunk=32, window=64, stats=cs, device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t
        n = big.timings["ticks"]
        assert cs["loaded"] == STREAM_TASKS and big.summary()["completed"] == STREAM_TASKS, \
            (cs, big.summary())
        assert cs["window_rows"] <= 256, cs
        need = sched.SMEM_BYTES["admit_queued"](32, 1, 100_000, 8)
        log(f"  (c) {STREAM_TASKS} Alibaba-shaped tasks (A = 32, 8 hosts, persist, window 64, "
            f"chunk 32): {n} ticks in {wall:.3f} s, {n / wall:.3f} ticks/s, "
            f"{STREAM_TASKS / wall:.1f} tasks/s; every task loaded and done; window {cs}; "
            f"captures {len(ccaps)} ({by_width(ccaps)})")
        log(f"  (c) the materialized run of 100,000 such tasks: admit_queued would take {need} B "
            f"of shared memory a block against MAX_SMEM {sched.MAX_SMEM} B: it cannot launch")
        assert need > sched.MAX_SMEM, need
        sl = synthetic_alibaba(scenarios.FittedConfig, STREAM_SLICE)
        swl = scenarios.build_trace(sl)
        scfg = replay_bench_config(SimConfig, ClusterConfig, sl)
        for mode, c in (("uniform", scfg), ("leap", dataclasses.replace(scfg, leap=True))):
            m = step.run_sim_scan(c, swl, chunk=32, device="cuda")
            st = {}
            r = run_sim_stream(c, swl, chunk=32, window=64, stats=st, device="cuda")
            assert run_series(r) == run_series(m), f"{STREAM_SLICE}-task slice, {mode}"
            log(f"  (c) the {STREAM_SLICE}-task slice, {mode}: streamed ({st}) == materialized "
                f"over {len(m.n_running)} ticks")
        steps["c"] = round(time.perf_counter() - t0, 1)

        # (d) a cross-scenario fleet on one card
        t0 = time.perf_counter()
        g = SimConfig(max_ticks=FLEET_TICKS)
        f = SimConfig(workload=scenarios.make_config("flashcrowd"), max_ticks=FLEET_TICKS)
        fleet = step.run_fleet_shard(g, cfgs=[g, f], mesh=1, device="cuda")
        for name, c, got in (("google", g, fleet[0]), ("flashcrowd", f, fleet[1])):
            solo = step.run_sim_scan(c, device="cuda")
            assert run_series(got) == run_series(solo), f"fleet member {name} != its solo run"
            fr, sr = got.forecast_rows, solo.forecast_rows
            assert {k: v for k, v in fr.items() if k != "rows_bucketed"} == \
                {k: v for k, v in sr.items() if k != "rows_bucketed"}, (fr, sr)
            assert fr["rows_bucketed"] >= sr["rows_bucketed"], (fr, sr)
            log(f"  (d) fleet member {name} == its solo run over {len(solo.n_running)} ticks "
                f"(rows_bucketed {fr['rows_bucketed']}, the cohort's bucket; solo "
                f"{sr['rows_bucketed']})")
        steps["d"] = round(time.perf_counter() - t0, 1)
    finally:
        caps.stop()
        chunks = guard.stop()
    log(f"  {chunks} chunks sync-free; phase 5k seconds by step: {json.dumps(steps)}")


def time_obs(obs_kernel, ref) -> dict:
    """Phase 8: obs_tick at the main path's widths (one member, 128 slots
    of 12, 500 apps, R = 128; the default path's inputs: the shaped
    demand, no tenancy, calibration or lead), kernel by CUDA events
    against its plain version (numpy on the host) in turns, its device
    time per launch (a CUDA graph of 50 launches) and host time per call,
    beside its bound (obs_bound_bytes over 3.35 TB/s); then the device
    time with every feature (T = 4, calibration, lead)."""
    rng = np.random.default_rng(26)
    full = obs_case(rng)
    args = dict(full, **{k: v for k, v in OBS_OFF.items() if k != "demand"})   # the default path
    gpu = _obs_cuda(args)
    kern = lambda: obs_kernel.obs_tick(**gpu)  # noqa: E731
    plain = lambda: ref.obs_tick(**args)  # noqa: E731
    want = plain()
    assert all(_same(g, w) for g, w in zip(kern()[:3], want[:3]))

    def host_ms(fn):
        t0 = time.perf_counter()
        fn()
        return (time.perf_counter() - t0) * 1e3
    ms = {"kernel": [], "plain": []}
    for k in ("kernel", "plain", "plain", "kernel"):
        ms[k].append(cuda_time_ms(kern, iters=200, warmup=10) if k == "kernel"
                     else host_ms(plain))
    dev_us = [graph_us(kern) for _ in range(2)]
    host_us = host_us_per_call(kern)
    fgpu = _obs_cuda(full)
    full_us = [graph_us(lambda: obs_kernel.obs_tick(**fgpu)) for _ in range(2)]
    nbytes = obs_bound_bytes(args, want)
    bound = nbytes / HBM_BYTES_PER_S * 1e3
    log(f"  obs_tick (128 slots of 12, 500 apps, R = 128, the default path's inputs): kernel "
        f"{'/'.join(f'{x:.5f}' for x in ms['kernel'])} ms a call back to back, plain (numpy "
        f"on the host) {'/'.join(f'{x:.3f}' for x in ms['plain'])} ms; device "
        f"{'/'.join(f'{x:.3f}' for x in dev_us)} us a launch (50 launches in a CUDA graph, "
        f"replayed), host {host_us:.3f} us per call; bound {bound * 1e3:.4f} us ({nbytes} B); "
        f"every feature (T = 4, calibration, lead) {'/'.join(f'{x:.3f}' for x in full_us)} us "
        f"device")
    obs_kernel.reset_launch_counts()
    return {"obs_tick": dict(ms=min(ms["kernel"]), plain_ms=min(ms["plain"]), bound_ms=bound,
                             bound_by="bytes", library_ms=None)}


def _clone(x):
    import torch
    if isinstance(x, tuple):
        return tuple(_clone(v) for v in x)
    return x.clone() if isinstance(x, torch.Tensor) else x


def captured_args(step, cfg, name):
    """The arguments of ``ops.<name>`` (control_tick or obs_tick) at one tick
    of ``cfg``'s full-width run on the card, eager tick by tick with
    persist forecasts: the tick whose occupied slots are nearest the run's
    mean (control_tick's slot table as the kernel reads it; the slot table
    at the end of the tick for obs_tick, the tick's last phase).  Returns
    (args, kwargs, a note of the tick and the occupancy)."""
    import torch
    from repro_torch.kernels import ops
    from repro_torch.sim.scenarios.registry import build_trace
    from repro_torch.sim.state import DeviceTrace, init_state
    cfg = dataclasses.replace(cfg, forecaster="persist")
    wl = build_trace(cfg.workload)
    dev = torch.device("cuda")
    tr = DeviceTrace.from_traces([wl], dev)
    st = init_state(cfg, wl.n_apps, wl.max_components, 1, dev)
    cap = step.host_capacity(cfg, dev)
    plain, seen, occupied = getattr(ops, name), [], []

    def spy(*args, **kw):
        seen.append((_clone(args), _clone(kw)))
        if name == "control_tick":
            occupied.append(int((args[14] >= 0).sum()))
        return plain(*args, **kw)
    setattr(ops, name, spy)
    try:
        with torch.no_grad():
            while not bool(st.done.all()):
                st, _ = step.fused_tick(cfg, None, tr, st, cap)
                if name != "control_tick":
                    occupied.append(int((st.slot_gid >= 0).sum()))
    finally:
        setattr(ops, name, plain)
    mean = float(np.mean(occupied))
    k = int(np.argmin(np.abs(np.asarray(occupied) - mean)))
    A = st.slot_gid.shape[1]
    note = (f"tick {k} of the {len(occupied)}-tick run (persist), {occupied[k]} of {A} slots "
            f"occupied (the run's mean {mean:.1f}, max {max(occupied)}; the synthetic case "
            f"{0.8 * A:.0f})")
    return seen[k][0], seen[k][1], note


def _nbytes(*ts) -> int:
    return sum(t.numel() * t.element_size() for t in ts)


def _changed_bytes(new, old) -> int:
    """The bytes of the entries an update changes: what a version that
    updates its state in place must write."""
    return int((new != old).sum()) * new.element_size()


def scan_bound_bytes(name, args, outs) -> int:
    """The bytes the function needs on one case: what it must read to
    decide, each once, and the entries it changes, each written once (a
    fresh output is written in full).  The reads depend on the data, so
    they are counted from the case and its plain outputs: the rows the
    pass visits, the heads admission tries, the missing components, the
    hosts over their memory and their victims."""
    import torch
    if name == "pessimistic_pass":
        valid, dem, core, el, host, order, free0 = args
        row = _nbytes(dem[0, 0], core[0, 0], el[0, 0], host[0, 0], order[0, 0])
        return _nbytes(valid, free0) + int(valid.sum()) * row + _nbytes(*outs)
    if name == "resolve_oom":
        slot_gid, _, run, host, alloc, usage, *_, is_core, cap = args
        mem = usage[..., 1]
        on = run[..., None] & (host[..., None] == torch.arange(cap.shape[0]))
        over = (mem.double()[..., None] * on).sum((1, 2)) > cap[:, 1].double() + 1e-6
        on_over = (on & over[:, None, None, :]).any(-1)
        victims = int((outs[7] - args[8]).sum() + (outs[9] - args[10]).sum())
        reads = (_nbytes(mem, run, host, cap[:, 1])
                 + int(on_over.sum()) * alloc.element_size()      # their overage
                 + victims * (slot_gid.element_size() + is_core.element_size()))
        pairs = ((0, 0), (1, 1), (2, 2), (3, 4), (4, 5), (5, 6), (6, 7), (7, 8), (8, 9),
                 (9, 10))
        return (reads + sum(_changed_bytes(outs[o], args[i]) for o, i in pairs)
                + _nbytes(outs[10]))
    if name == "admit_queued":
        (submit, gid, cpu_req, mem_req, exists, is_core, slot_gid, _, run, host, alloc,
         _, queued, has_saved, saved_work, t, cap, resume) = args
        admitted = int(queued.sum() - outs[6].sum())
        refused = int((outs[6].any(1) & (outs[0] < 0).any(1)).sum())
        head = _nbytes(cpu_req[0, 0], mem_req[0, 0], exists[0, 0], is_core[0, 0])
        if resume:
            head += _nbytes(has_saved[0, 0], saved_work[0, 0])
        reads = (_nbytes(submit, gid, queued, slot_gid, run, host, alloc, t, cap)
                 + (admitted + refused) * head)
        return (reads + sum(_changed_bytes(outs[o], args[o + 6]) for o in range(8))
                + _nbytes(outs[8]))
    cpu_req, mem_req, exists, is_core, slot_gid, run, host, alloc, _, t, cap = args
    S, A, C = run.shape
    occupied = slot_gid >= 0
    g = slot_gid.clamp_min(0).long()[..., None].expand(S, A, C)
    missing = (occupied[..., None] & torch.gather(exists, 1, g)
               & ~torch.gather(is_core, 1, g) & ~run)
    members = int(missing.any(-1).any(-1).sum())
    reads = (_nbytes(slot_gid, run)
             + int(occupied.sum()) * C * (exists.element_size() + is_core.element_size())
             + members * (_nbytes(host[0], alloc[0], cap) + t.element_size())
             + int(missing.sum()) * (cpu_req.element_size() + mem_req.element_size()))
    return reads + sum(_changed_bytes(outs[o], args[o + 5]) for o in range(4))


def time_scan_kernels(fns, cases, shaper, sched) -> dict:
    """The four kernels at the main path's shapes (a full-width state
    captured at tick 200 of the pessimistic run: S = 1, A = 128, C = 12,
    H = 50, N = 500), kernel by CUDA events against the plain version (a
    loop over numpy on the host) by the host clock, in turns.  Beside each:
    its device time per launch (torch.profiler) and its host time per call
    (checks, ctypes, enqueue); once a kernel's device time falls below its
    wrapper's host cost, CUDA events timed back to back time the wrapper.
    resolve_oom is timed again with victims: no state of the default
    config puts a host over its 128 GB (memory runs at ~10% of the
    cluster), so the captured optimistic state at tick 200 runs on hosts
    of 16 GB there (OOM_HOST_MEM: 19 victims, 2 of them core);
    admit_queued and place_missing_elastic again on the full-width case
    with the most admissions (a tick's own call, captured) and placed
    components (the tick-200 state with elastic components stopped).  The kernels that
    stamp them also report the clock64() cycles of their phases.  The bound: the bytes each function
    needs on that state (scan_bound_bytes) over 3.35 TB/s; their
    operations are a few thousand additions and comparisons."""
    import torch
    pick = {"pessimistic_pass": TICK_200, "resolve_oom": TICK_200,
            "admit_queued": 2 * TICK_200, "place_missing_elastic": TICK_200}
    *oom, cap = cases["resolve_oom"][len(CAPTURE_TICKS) + pick["resolve_oom"]]
    cap = cap.clone()
    cap[:, 1] = OOM_HOST_MEM
    victims_case = (*oom, cap)
    victims = scan_events("resolve_oom", victims_case, fns["resolve_oom"][1](*victims_case))
    timed = [(name, cases[name][pick[name]], "tick 200") for name in fns]
    timed.append(("resolve_oom", victims_case, f"optimistic tick 200 on {OOM_HOST_MEM:g} GB "
                                               f"hosts, {victims} victims"))
    # admission and re-placement where they have events: the full-width
    # case (S = 1) with the most admissions (a tick's own call, captured)
    # and placed components (the tick-200 state with elastics stopped)
    for name, what in (("admit_queued", "admissions"),
                       ("place_missing_elastic", "placed components")):
        plain = fns[name][1]
        n, busiest = max(((scan_events(name, a, plain(*a)), a) for a in cases[name]
                          if a[0].shape[0] == 1), key=lambda x: x[0])
        timed.append((name, busiest, f"full-width case with {n} {what}"))
    # (a kernel of an older checkout, timed by profile_port.py --src, has no stamps)
    event_phases = ("stage", "search", "free table", "placement", "write")
    phase_fns = {"pessimistic_pass": (getattr(shaper, "phase_cycles", None),
                                      ("stage", "precompute", "chain", "write")),
                 "resolve_oom": (getattr(sched, "oom_phase_cycles", None),
                                 ("stage", "per-host sums", "victim loop", "write")),
                 "admit_queued": (getattr(sched, "admit_phase_cycles", None), event_phases),
                 "place_missing_elastic": (getattr(sched, "elastic_phase_cycles", None),
                                           event_phases)}
    log(f"  nvidia-smi clocks.sm, clocks.max.sm: {smi_clocks()}")
    out = {}
    for i, (name, cpu, where) in enumerate(timed):
        kern, plain = fns[name]
        gpu = [a.cuda() if isinstance(a, torch.Tensor) else a for a in cpu]
        kern(*gpu)
        torch.cuda.synchronize()
        nbytes = scan_bound_bytes(name, cpu, plain(*cpu))

        def host_ms():
            t = time.perf_counter()
            for _ in range(5):
                plain(*cpu)
            return (time.perf_counter() - t) / 5 * 1e3
        p1 = host_ms()
        k1, k2 = (cuda_time_ms(lambda: kern(*gpu), iters=200, warmup=10) for _ in range(2))
        p2 = host_ms()
        dev_us = device_us_per_call(lambda: kern(*gpu), f"{name}_kernel")
        host_us = host_us_per_call(lambda: kern(*gpu))
        bound = nbytes / HBM_BYTES_PER_S * 1e3
        events = scan_events(name, cpu, plain(*cpu))
        per = (f", {dev_us / events:.3f} us per event ({events})"
               if dev_us is not None and events else "")
        log(f"  {name} ({where}): kernel {k1:.5f}/{k2:.5f} ms, plain (numpy on the host) "
            f"{p1:.5f}/{p2:.5f} ms; device "
            f"{'not measured' if dev_us is None else f'{dev_us:.3f} us'} per launch "
            f"(torch.profiler){per}, host {host_us:.3f} us per call; bound "
            f"{bound * 1e3:.4f} us ({nbytes} B needed)")
        fn, phases = phase_fns.get(name, (None, ()))
        if fn is not None:
            cyc = [min(c) for c in zip(*(fn(*gpu)[0].tolist() for _ in range(20)))]
            log("    clock64 cycles by phase (min of 20 launches): " + ", ".join(
                f"{ph} {c} ({c / max(sum(cyc), 1):.1%})" for ph, c in zip(phases, cyc)))
        if i < len(fns):
            out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2), bound_ms=bound,
                             bound_by="bytes", library_ms=None)
    return out


def smi_clocks() -> str:
    return subprocess.run(["nvidia-smi", "--query-gpu=clocks.sm,clocks.max.sm",
                           "--format=csv,noheader"], capture_output=True, text=True,
                          timeout=60).stdout.strip()


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.forecast import (ARIMAConfig, ARIMAForecaster, GPConfig,
                                           GPForecaster)
    from repro_torch.core import shaper as core_shaper
    from repro_torch.control import TenancyConfig
    from repro_torch.core.uncertainty import CalibrationConfig
    from repro_torch.kernels import (arima_forecast, calib, control, flash_attention, fma,
                                     gp_forecast, gp_gram, leap, nvcc, ref, sched, shaper)
    from repro_torch.kernels import obs as obs_kernel
    from repro_torch.obs import ObsConfig
    from repro_torch.sim import ClusterConfig, SimConfig, WorkloadConfig, run_sim
    from repro_torch.sim import scenarios, step
    from repro_torch.sim.engine import forecast_peaks

    # full fp32 everywhere: the GP's numbers must not go through TF32; bf16
    # GEMMs keep every partial sum in fp32, as the reference's dots do
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== 1. environment")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device {kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; tf32 off; nvidia-smi: {smi}")

    log("== 2. build (one nvcc per source, all at once)")
    sources = (gp_gram.SOURCE, flash_attention.SOURCE, flash_attention.SOURCE_SM90,
               gp_forecast.SOURCE, shaper.SOURCE, sched.SOURCE, fma.SOURCE, leap.SOURCE,
               arima_forecast.SOURCE, calib.SOURCE, control.SOURCE, obs_kernel.SOURCE)
    with concurrent.futures.ThreadPoolExecutor(len(sources)) as pool:
        builds = list(pool.map(nvcc.build, sources))
    for b in builds:
        log(f"built {b.path.name} in {b.seconds:.2f} s")
        for line in b.log.splitlines():
            if re.search(r"registers|spill|Compiling entry|smem|arn", line):
                log("  ptxas: " + line.strip())
    # the tensor-core kernel must really issue wgmma and TMA loads
    sass = nvcc.sass(builds[2].path)
    counts = {op: len(re.findall(rf"\b{op}\b", sass)) for op in ("HGMMA", "UTMALDG")}
    log(f"  {builds[2].path.name} SASS: {counts}")
    assert all(n > 0 for n in counts.values()), counts
    # the wrappers size a block's shared memory as the kernels carve it
    for A, C, N, H in ((128, 12, 500, 50), (64, 12, 100, 7), (7, 5, 24, 3), (13, 7, 37, 5)):
        assert shaper.smem_bytes(A, C, H) == shaper._library().pessimistic_pass_smem(A, C, H)
        for name, fn in sched.SMEM_BYTES.items():
            assert fn(A, C, N, H) == getattr(sched._library(), f"{name}_smem")(A, C, N, H)
    log(f"  shared memory per block at A=128, C=12, N=500, H=50: pessimistic_pass "
        f"{shaper.smem_bytes(128, 12, 50)} B, " + ", ".join(
            f"{name} {fn(128, 12, 500, 50)} B" for name, fn in sched.SMEM_BYTES.items()))

    log("== 3. kernel checks (kernel vs plain on the card)")
    err = check_kernels(gp_gram, ref, dev)
    err["gp_fit_forecast"] = check_gp_kernel(gp_forecast, ref, GPConfig, dev)
    flash_err = check_flash(flash_attention, ref, dev)
    err["flash_attention"] = flash_err["sm90"]
    err["flash_attention_simt"] = flash_err["simt"]
    err["fma_f32"] = check_fma(fma, ref)
    scan_cases = scan_kernel_cases(step, SimConfig)
    scan_fns = scan_kernel_pairs(shaper, sched, ref)
    err.update(check_scan_kernels(scan_fns, scan_cases)[0])
    err["leap_skip"] = check_leap(leap, ref)
    check_leap_calib(leap, ref)
    err["arima_forecast"] = check_arima(arima_forecast, ref, ARIMAConfig)
    check_arima_crafted(arima_forecast, ref, ARIMAConfig)
    err.update(check_calib(calib, ref, CalibrationConfig))
    check_scale_crafted(calib, ref)
    err["control_tick"] = check_control(control, ref)
    check_gated_admit(sched, ref, scan_cases)
    check_calib_tier(calib, ref, CalibrationConfig)
    check_calib_crafted(calib, ref, CalibrationConfig)
    err["obs_tick"] = check_obs(obs_kernel, ref)
    log(f"  max abs error: {err}")

    log("== 4. GP check (card vs CPU)")
    check_gp(GPForecaster, GPConfig)
    check_small_runs(run_sim, SimConfig, ClusterConfig, WorkloadConfig)
    log("== 4b. the device engine at full width, card (graphs) vs CPU (eager): "
        "run_sim_scan(SimConfig(forecaster='oracle'))")
    res = card_vs_cpu(step, SimConfig(forecaster="oracle"), "full-width oracle run", strict=True)
    assert res.summary()["completed"] == 500, res.summary()
    log(f"== 4c. the GP on the device engine, card (graphs) vs CPU (eager): "
        f"run_sim_scan(SimConfig(max_ticks={GP_CPU_TICKS}))")
    card_vs_cpu(step, SimConfig(max_ticks=GP_CPU_TICKS), f"GP, first {GP_CPU_TICKS} ticks",
                strict=False)

    log("== 5. main path: run_sim(SimConfig(), device='cuda')")
    cfg = SimConfig(max_ticks=MAIN_PATH_TICKS)
    log(f"  500 apps, 50 hosts, A={cfg.cluster.max_running_apps}, "
        f"C={cfg.workload.max_components}, {cfg.forecaster}, {cfg.policy}; "
        f"max_ticks capped at {MAIN_PATH_TICKS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    calls = count_calls(GPForecaster, "forecast_batch")
    policy_calls = count_calls(core_shaper.POLICIES, "pessimistic")
    for m in (gp_gram, gp_forecast, flash_attention, shaper, sched, fma):
        m.reset_launch_counts()
    res = run_sim(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = {"gp_gram_fwd": gp_gram.gram_fwd.launches,
                "gp_gram_bwd": gp_gram.gram_bwd.launches,
                "gp_fit_forecast": gp_forecast.gp_fit_forecast.launches}
    fc_ticks = calls.stop()
    shaping_ticks = policy_calls.stop()
    tm = res.timings
    summary = res.summary()
    ticks = tm["ticks"]
    host = tm["total"] - tm["forecast"] - tm["policy"]
    log(f"  ticks {ticks} in {tm['total']:.3f} s: {ticks / tm['total']:.3f} ticks/s")
    log(f"  per tick: forecast {tm['forecast'] / ticks * 1e3:.3f} ms, "
        f"policy {tm['policy'] / ticks * 1e3:.3f} ms, host {host / ticks * 1e3:.3f} ms")
    log(f"  summary {json.dumps(summary)}")
    log(f"  max memory allocated {torch.cuda.max_memory_allocated()} B")
    host_launches, dev_kernels = gp_launches_per_batch(GPForecaster, GPConfig,
                                                       forecast_peaks)
    log(f"  kernel launches {launches} in {fc_ticks} forecasting ticks; "
        f"{shaper.pessimistic_pass.launches} pessimistic_pass launches in {shaping_ticks} "
        f"shaping ticks; {fma.fma_f32.launches} fma_f32 launches (the safeguard); "
        f"one forecast of 512 windows under torch.profiler: "
        f"{host_launches} host launch calls, {dev_kernels} device kernels")
    assert shaping_ticks > 0 and shaper.pessimistic_pass.launches == shaping_ticks
    assert sched.resolve_oom.launches == 0     # the host engine's loops stay numpy
    assert ticks == MAIN_PATH_TICKS, ticks
    assert fc_ticks > 0 and launches["gp_fit_forecast"] == fc_ticks, (launches, fc_ticks)
    assert launches["gp_gram_fwd"] == launches["gp_gram_bwd"] == 0, launches
    assert flash_attention.flash_attention.launches == 0
    assert max(res.n_running) <= cfg.cluster.max_running_apps
    for k in ("util_cpu_mean", "util_mem_mean", "slack_cpu_mean", "slack_mem_mean"):
        assert np.isfinite(summary[k]), (k, summary[k])
    assert 0 < summary["util_mem_mean"] <= 1, summary

    log("== 5b. main path: run_sim_scan(SimConfig(), device='cuda'), the device engine, "
        "to completion through replayed CUDA graphs, forecasts bucketed; then the full "
        "batch")
    # the node census reads each captured graph's nodes
    step._ChunkGraphs.keep_nodes = True
    scan_launches, gp_ready, gp_summary = run_scan_main(step, SimConfig, gp_forecast, shaper,
                                                        sched, fma)
    log("== 5c. the device engine's graphs against its eager ticks on the card "
        "(SimConfig(): 135 ticks solo, 64 ticks of a 3-seed cohort), then both timed")
    check_graphs(step, SimConfig)
    log(f"== 5d. the scenario families at full width and the replay fixtures on the "
        f"device engine (gp, {FAMILY_TICKS} ticks at most), oracle card vs CPU")
    run_families(step, scenarios, SimConfig, gp_forecast)
    log(f"== 5e. leap ticks on the card: the families at full width ({FAMILY_TICKS} ticks at "
        f"most) and the gap-dominated cell to completion, leap graphs against uniform graphs")
    leap_launches, _ = run_leap(step, scenarios, SimConfig, ClusterConfig, leap)
    log("== 5f. the ARIMA forecaster: run_sim(SimConfig(forecaster='arima')) capped at "
        f"{MAIN_PATH_TICKS} ticks, run_sim_scan(SimConfig(forecaster='arima')) to completion")
    arima_launches, arima_ready = run_arima(step, SimConfig, run_sim, ARIMAForecaster,
                                            arima_forecast, shaper, sched, fma, gp_forecast,
                                            gp_summary)
    log("== 5g. conformal calibration: run_sim_scan(SimConfig(calibration=CalibrationConfig("
        "enabled=True, q=0.9, adaptive=True, budget=0.1))) to completion, adaptive=False, "
        f"the host engine capped at {MAIN_PATH_TICKS} ticks, heavytail, card vs CPU")
    calib_main = run_calibrated(step, scenarios, SimConfig, CalibrationConfig, run_sim, calib)
    log("== 5h. the multi-tenant control plane: run_sim_scan(SimConfig(workload=WorkloadConfig("
        "n_tenants=4), control=TenancyConfig(enabled=True), calibration=CalibrationConfig("
        "enabled=True, q=0.9, adaptive=True, budget=0.1))) to completion, against control off, "
        f"the host engine capped at {MAIN_PATH_TICKS} ticks, card vs CPU, the reference's "
        "tenancy cells")
    control_main = run_tenancy(step, scenarios, SimConfig, WorkloadConfig, ClusterConfig,
                               TenancyConfig, CalibrationConfig, run_sim, control, calib, sched)
    log("== 5i. the telemetry rings: run_sim_scan(SimConfig(obs=ObsConfig(enabled=True))) to "
        "completion against the rings off, phase 5h's tenanted path with the rings, the gap "
        f"cell's leap histories, {OBS_CPU_TICKS} tenanted persist ticks card vs CPU")
    obs_main = run_obs(step, scenarios, SimConfig, WorkloadConfig, ClusterConfig, TenancyConfig,
                       CalibrationConfig, ObsConfig, obs_kernel)
    log("== 5j. the sweep driver: run_grid(SimConfig(), policy x 2 seeds, engine='scan', "
        f"obs=True) against solo runs, the GP host grid (policy x calibration x 2 seeds, "
        f"{MAIN_PATH_TICKS} ticks) through the forecast batcher and without it, the fitted "
        "family, the forecast diagnostics card vs CPU")
    sweep_launches = run_sweep(step, scenarios, SimConfig, ObsConfig, GPForecaster, gp_forecast,
                               calib, smi)
    log(f"  launches on the sweep's paths: {json.dumps(sweep_launches)}")
    log("== 5k. streamed ingestion and fleets: SimConfig() streamed in its default window "
        f"and in one of {GROW_WINDOW} that grows, against materialized; the gap cell's leap "
        "streamed; "
        f"{STREAM_TASKS} Alibaba-shaped tasks through a bounded window; run_fleet_shard over "
        "google and flashcrowd")
    run_stream(step, scenarios, SimConfig, ClusterConfig, sched, leap,
               (gp_forecast, shaper, sched, fma),
               lambda: scan_launch_counts(gp_forecast, shaper, sched, fma))

    log("== 5l. the GP past the fused program's 64 patterns (LONG_GP: h = 40, N = 128, windows "
        f"of {LONG_WINDOW}), the Gram route: forecast_batch card vs CPU, run_sim capped at "
        f"{LONG_TICKS} ticks (its first {LONG_CPU_TICKS} card vs CPU), run_sim_scan capped at "
        f"{LONG_TICKS} ticks through graphs")
    long_launches = run_long_gp(step, SimConfig, GPConfig, GPForecaster, run_sim, gp_gram,
                                gp_forecast, shaper, sched, fma)

    log("== 6. Whisper, smoke widths, fp32: the card against the CPU")
    check_whisper_smoke(flash_attention)

    log(f"== 7. main path: {WHISPER} serving at full width on the card")
    whisper_launches = run_whisper(flash_attention)
    log(f"== 7b. {WHISPER} prefill at full width in fp32 (the simt route's path)")
    simt_launches = run_whisper_fp32(flash_attention)

    log("== 8. kernel timings (CUDA events; Gram at GRAM_TIMED's four shapes, exp, device time "
        "in graphs; flash at the Whisper decoder's shape)")
    times = time_kernels(gp_gram, ref, dev)
    gp_times, gp_err = time_gp_kernel(gp_forecast, ref, GPConfig, dev, gp_ready)
    times.update(gp_times)
    err["gp_fit_forecast"] = max(err["gp_fit_forecast"], gp_err)
    times.update(time_flash(flash_attention, ref, dev))
    times.update(time_scan_kernels(scan_fns, scan_cases, shaper, sched))
    times.update(time_fma(fma, ref))
    times.update(time_leap(leap, ref, gap_idle_state(scenarios, SimConfig, ClusterConfig)))
    arima_times, arima_err = time_arima(arima_forecast, ref, ARIMAConfig, arima_ready)
    times.update(arima_times)
    err["arima_forecast"] = max(err["arima_forecast"], arima_err)
    calib_times, calib_err = time_calib(calib, ref, CalibrationConfig)
    times.update(calib_times)
    for k in calib_times:
        err[k] = max(err[k], calib_err)
    control_times, control_err = time_control(control, ref, sched, scan_cases, calib,
                                              CalibrationConfig)
    times.update(control_times)
    err["control_tick"] = max(err["control_tick"], control_err)
    times.update(time_obs(obs_kernel, ref))
    log(f"  gp_gram library_ms: null - no single PyTorch call computes the Gram "
        f"matrix (torch.cdist gives distances only) or its (ell, sf) gradient")
    end_phase()
    log(f"total {time.perf_counter() - t_start:.1f} s")

    launches["flash_attention"] = whisper_launches
    launches["flash_attention_simt"] = simt_launches
    # the GP program's launches and times are the device engine's (its
    # bucketed launch); the host engine's were asserted in phase 5
    launches.update({k: scan_launches[k] for k in SCAN_KERNELS + ("fma_f32", "gp_fit_forecast")})
    launches["leap_skip"] = leap_launches           # the gap cell's leap run (phase 5e)
    launches["arima_forecast"] = arima_launches     # run_sim_scan's ARIMA run (phase 5f)
    launches.update(calib_main)                     # the calibrated run (phase 5g)
    launches.update(control_main)                   # the tenanted run (phase 5h)
    launches["obs_tick"] = obs_main                 # the rings' run (phase 5i)
    launches.update(long_launches)                  # the Gram route's device engine (5l)
    replaces = {"gp_gram_fwd": "src/repro/kernels/gp_gram.py:75",
                "gp_gram_bwd": "src/repro/kernels/gp_gram.py:75",
                "gp_fit_forecast": "src/repro/kernels/gp_gram.py:75",
                "flash_attention": "src/repro/kernels/flash_attention.py:110",
                "flash_attention_simt": "src/repro/kernels/flash_attention.py:110",
                "fma_f32": "src/repro/sim/step.py:114",
                "leap_skip": "src/repro/sim/step.py:955",
                "arima_forecast": "src/repro/core/forecast/arima.py:140",
                "calib_observe": "src/repro/core/uncertainty/online.py:317",
                "conformal_scale": "src/repro/core/uncertainty/conformal.py:113",
                "calib_begin": "src/repro/core/uncertainty/online.py:413",
                "control_tick": "src/repro/sim/step.py:778",
                "obs_tick": "src/repro/sim/step.py:901",
                **SCAN_REPLACES}
    sources = {"gp_gram_fwd": "src/repro_torch/kernels/csrc/gp_gram.cu",
               "gp_gram_bwd": "src/repro_torch/kernels/csrc/gp_gram.cu",
               "gp_fit_forecast": "src/repro_torch/kernels/csrc/gp_forecast.cu",
               "flash_attention": "src/repro_torch/kernels/csrc/flash_attention_sm90.cu",
               "flash_attention_simt": "src/repro_torch/kernels/csrc/flash_attention.cu",
               "fma_f32": "src/repro_torch/kernels/csrc/fma.cu",
               "leap_skip": "src/repro_torch/kernels/csrc/leap.cu",
               "arima_forecast": "src/repro_torch/kernels/csrc/arima_forecast.cu",
               "calib_observe": "src/repro_torch/kernels/csrc/calib.cu",
               "conformal_scale": "src/repro_torch/kernels/csrc/calib.cu",
               "calib_begin": "src/repro_torch/kernels/csrc/calib.cu",
               "control_tick": "src/repro_torch/kernels/csrc/control.cu",
               "obs_tick": "src/repro_torch/kernels/csrc/obs.cu",
               **SCAN_SOURCES}
    log(smi)   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": sources[name],
         "replaces": replaces[name],
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": times[name].get("library_ms")}
        for name in ("gp_gram_fwd", "gp_gram_bwd", "gp_fit_forecast",
                     "flash_attention", "flash_attention_simt") + SCAN_KERNELS
        + ("fma_f32", "leap_skip", "arima_forecast", "calib_observe", "conformal_scale",
           "calib_begin", "control_tick", "obs_tick")]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
