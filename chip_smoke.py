#!/usr/bin/env python3
"""Smoke test of the PyTorch port on one CUDA card.

Builds the port's CUDA kernels from the sources in this checkout, checks
each against its plain PyTorch version on the card, checks the GP
forecaster on the card against the same forecaster on the CPU, drives
the default simulation (``run_sim(SimConfig())``: GP forecaster,
pessimistic policy, 500 apps, 50 hosts) through the port's public entry
point with a cap on its ticks, and times each kernel against its plain
version and its bound.  Every phase raises on failure.

Run from the repository root with no arguments:

    python3 chip_smoke.py

The last line of standard output is ``{"ok": true, "device": ...}``; the
line before it lists each kernel's launches on the main path, error,
times and bound.  Without a CUDA device, or without the repository's
``src/`` beside it, the script fails and prints no result.
"""
from __future__ import annotations

import dataclasses
import json
import re
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

MAIN_PATH_TICKS = 240      # cap on the default simulation's ticks
RTOL, ATOL = 2e-5, 2e-6    # kernel vs plain version
HBM_BYTES_PER_S = 3.35e12  # H100 SXM, NVIDIA data sheet
FP32_FLOP_PER_S = 67e12    # H100 SXM, fp32 outside the tensor cores


def log(*a):
    print(*a, flush=True)


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


def inputs(b, m, n, d, dev, *, same, seed):
    """Seeded (xa, xb, ell, sf, grad).  ``same`` makes xa the first m rows
    of xb, as the GP's fit (X against X) and horizon steps do."""
    import torch
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((b, n, d)).astype(np.float32)
    xa = xb[:, :m] if same else rng.standard_normal((b, m, d)).astype(np.float32)
    ell = rng.uniform(0.3, 3.0, b).astype(np.float32)
    sf = rng.uniform(0.3, 3.0, b).astype(np.float32)
    g = rng.standard_normal((b, m, n)).astype(np.float32)
    return [torch.as_tensor(np.ascontiguousarray(a), device=dev)
            for a in (xa, xb, ell, sf, g)]


def check_kernels(gp_gram, ref, dev) -> dict:
    """Forward and backward kernels against the plain versions; returns
    the largest absolute error of each."""
    import torch
    shapes = [(b, m, 10, 11, True) for b in (128, 256, 512) for m in (10, 1)]
    shapes += [(3, m, n, d, False) for m, n, d in
               [(1, 1, 1), (7, 5, 3), (10, 10, 11), (40, 40, 41),
                (128, 128, 128), (130, 60, 17)]]
    err = {"gp_gram_fwd": 0.0, "gp_gram_bwd": 0.0}
    for kind in ("exp", "rbf"):
        for i, (b, m, n, d, same) in enumerate(shapes):
            xa, xb, ell, sf, g = inputs(b, m, n, d, dev, same=same, seed=i)
            K = gp_gram.gram_fwd(xa, xb, ell, sf, kind)
            d_ell, d_sf = gp_gram.gram_bwd(g, xa, xb, ell, sf, kind)
            torch.cuda.synchronize()
            K_ref = ref.gram(xa, xb, ell, sf, kind)
            torch.testing.assert_close(K, K_ref, rtol=RTOL, atol=ATOL)
            # a per-series sum of m*n terms: atol grows with the count
            w_ell, w_sf = ref.gram_bwd(g, xa, xb, ell, sf, kind)
            for got, want in ((d_ell, w_ell), (d_sf, w_sf)):
                torch.testing.assert_close(got, want, rtol=RTOL, atol=ATOL * m * n)
            err["gp_gram_fwd"] = max(err["gp_gram_fwd"],
                                     (K - K_ref).abs().max().item())
            err["gp_gram_bwd"] = max(err["gp_gram_bwd"],
                                     (d_ell - w_ell).abs().max().item(),
                                     (d_sf - w_sf).abs().max().item())
            log(f"  {kind} B={b} ({m}x{d})·({n}x{d}) ok")
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
    cnt = v.sum(1)
    atol_var = (np.finfo(np.float32).eps * np.abs(w).max(1, keepdims=True)) ** 2
    for sel, rt_m, rt_v in ((cnt >= 12, 1e-3, 5e-3), (cnt == 11, 5e-2, 5e-2),
                            (cnt <= 10, 0.0, 0.0)):
        bad_m = np.abs(mg - mc) > rt_m * np.abs(mc)
        bad_v = np.abs(vg - vc) > atol_var + rt_v * np.abs(vc)
        bad = sel & (bad_m | bad_v).any(1)
        if bad.any():
            for i in np.flatnonzero(bad)[:8]:
                log(f"  GP row {i} ({cnt[i]} valid): mean {mg[i]} vs {mc[i]}, "
                    f"var {vg[i]} vs {vc[i]}")
            raise AssertionError(f"GP on the card disagrees with the CPU on "
                                 f"{bad.sum()} of {sel.sum()} rows")
    log(f"  GP forecast_batch cuda vs cpu: 512 rows within tolerance "
        f"(max rel mean err {np.max(np.abs(mg - mc) / np.maximum(np.abs(mc), 1e-6)):.3g})")


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


def time_kernels(gp_gram, ref, dev) -> dict:
    """Kernel and plain-version times at the main path's largest batch,
    B = 512 series of (10 x 11) patterns against themselves, with the
    least time the card could take: inputs read once, outputs written
    once, over 3.35 TB/s, against the operations over fp32's peak."""
    B, M, N, D = 512, 10, 10, 11
    xa, xb, ell, sf, g = inputs(B, M, N, D, dev, same=True, seed=99)
    pairs = B * M * N
    # |a|^2, |b|^2, a.b: 2 flops per term; then d2, sqrt, divide, exp, scale
    fwd_flops = 2 * D * (pairs + B * (M + N)) + 8 * pairs
    fwd_bytes = 4 * (B * M * D + B * N * D + 2 * B + pairs)
    bwd_flops = fwd_flops + 6 * pairs
    bwd_bytes = 4 * (pairs + B * M * D + B * N * D + 2 * B + 2 * B)
    out = {}
    for name, kern, plain, flops, nbytes in (
            ("gp_gram_fwd",
             lambda: gp_gram.gram_fwd(xa, xb, ell, sf, "exp"),
             lambda: ref.gram(xa, xb, ell, sf, "exp"), fwd_flops, fwd_bytes),
            ("gp_gram_bwd",
             lambda: gp_gram.gram_bwd(g, xa, xb, ell, sf, "exp"),
             lambda: ref.gram_bwd(g, xa, xb, ell, sf, "exp"), bwd_flops, bwd_bytes)):
        t_bytes = nbytes / HBM_BYTES_PER_S * 1e3
        t_ops = flops / FP32_FLOP_PER_S * 1e3
        # plain, kernel, kernel, plain: the pair's order cannot favour one
        p1, k1, k2, p2 = (cuda_time_ms(f) for f in (plain, kern, kern, plain))
        out[name] = dict(ms=min(k1, k2), plain_ms=min(p1, p2),
                         bound_ms=max(t_bytes, t_ops),
                         bound_by="bytes" if t_bytes >= t_ops else "operations",
                         bytes=nbytes, flops=flops)
        log(f"  {name}: kernel {k1:.5f}/{k2:.5f} ms, plain {p1:.5f}/{p2:.5f} ms, "
            f"bound {max(t_bytes, t_ops) * 1e3:.3f} us ({nbytes} B, {flops} flop)")
    return out


def main() -> int:
    import torch
    if not torch.cuda.is_available():
        print("chip_smoke: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.core.forecast import GPConfig, GPForecaster
    from repro_torch.kernels import gp_gram, ref
    from repro_torch.sim import ClusterConfig, SimConfig, WorkloadConfig, run_sim

    # full fp32 everywhere: the GP's numbers must not go through TF32
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    dev = torch.device("cuda")
    t_start = time.perf_counter()

    log("== 1. environment")
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    smi = nvidia_smi()
    log(f"device {kind} x{count}, torch {torch.__version__}, CUDA {torch.version.cuda}, "
        f"python {sys.version.split()[0]}; tf32 off; nvidia-smi: {smi}")

    log("== 2. build")
    b = gp_gram.build()
    log(f"built {b.path.name} in {b.seconds:.2f} s")
    for line in b.log.splitlines():
        if re.search(r"registers|spill|Compiling entry", line):
            log("  ptxas: " + line.strip())

    log("== 3. kernel checks (kernel vs plain on the card)")
    err = check_kernels(gp_gram, ref, dev)
    log(f"  max abs error: {err}")

    log("== 4. GP check (card vs CPU)")
    check_gp(GPForecaster, GPConfig)
    check_small_runs(run_sim, SimConfig, ClusterConfig, WorkloadConfig)

    log("== 5. main path: run_sim(SimConfig(), device='cuda')")
    cfg = SimConfig(max_ticks=MAIN_PATH_TICKS)
    log(f"  500 apps, 50 hosts, A={cfg.cluster.max_running_apps}, "
        f"C={cfg.workload.max_components}, {cfg.forecaster}, {cfg.policy}; "
        f"max_ticks capped at {MAIN_PATH_TICKS}")
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    gp_gram.reset_launch_counts()
    res = run_sim(cfg, device="cuda")
    torch.cuda.synchronize()
    launches = {"gp_gram_fwd": gp_gram.gram_fwd.launches,
                "gp_gram_bwd": gp_gram.gram_bwd.launches}
    tm = res.timings
    summary = res.summary()
    ticks = tm["ticks"]
    host = tm["total"] - tm["forecast"] - tm["policy"]
    log(f"  ticks {ticks} in {tm['total']:.3f} s: {ticks / tm['total']:.3f} ticks/s")
    log(f"  per tick: forecast {tm['forecast'] / ticks * 1e3:.3f} ms, "
        f"policy {tm['policy'] / ticks * 1e3:.3f} ms, host {host / ticks * 1e3:.3f} ms")
    log(f"  summary {json.dumps(summary)}")
    log(f"  max memory allocated {torch.cuda.max_memory_allocated()} B")
    log(f"  kernel launches {launches}")
    assert ticks == MAIN_PATH_TICKS, ticks
    assert all(n > 0 for n in launches.values()), launches
    assert launches["gp_gram_fwd"] == 14 * launches["gp_gram_bwd"] // 10, launches
    assert max(res.n_running) <= cfg.cluster.max_running_apps
    for k in ("util_cpu_mean", "util_mem_mean", "slack_cpu_mean", "slack_mem_mean"):
        assert np.isfinite(summary[k]), (k, summary[k])
    assert 0 < summary["util_mem_mean"] <= 1, summary

    log("== 6. kernel timings (CUDA events, B=512, exp)")
    times = time_kernels(gp_gram, ref, dev)
    log(f"  library_ms: null - no single PyTorch call computes the Gram matrix "
        f"(torch.cdist gives distances only) or its (ell, sf) gradient")
    log(f"total {time.perf_counter() - t_start:.1f} s")

    src = "src/repro_torch/kernels/csrc/gp_gram.cu"
    log(smi)   # the card's name and power limit, as nvidia-smi prints them
    log(json.dumps({"kernels": [
        {"name": name, "route": "cuda", "source": src,
         "replaces": "src/repro/kernels/gp_gram.py:75",
         "launches": launches[name], "max_abs_err": err[name],
         "ms": times[name]["ms"], "plain_ms": times[name]["plain_ms"],
         "bound_ms": times[name]["bound_ms"], "bound_by": times[name]["bound_by"],
         "library_ms": None}
        for name in ("gp_gram_fwd", "gp_gram_bwd")]}))
    log(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind,
                                           "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
