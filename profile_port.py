#!/usr/bin/env python3
"""Where the PyTorch port's main paths spend their time on one CUDA card.

``--path sim`` (the default) runs the default simulation
(``run_sim(SimConfig())``, GP + pessimistic, full width) for a capped
number of ticks under ``torch.profiler`` and prints the device's busy
share (summed kernel time over wall time), the device time by kind (the
fused GP program ``gp_forecast_kernel`` is the "GP program" group), the
operators that take the most device time and the most host time, and
the Gram kernels' device time per launch at the main path's largest
batch (chip_smoke.py's phase 8 times the GP program alone).

``--path scan`` runs the device engine (``run_sim_scan(SimConfig())``,
full width, each chunk a replayed CUDA graph) for its first SCAN_TICKS
ticks under the profiler after a warm-up that captures the graph, with
the forecasts bucketed (the default) and then over the full batch
(``forecast_bucket=False``), and prints for each the busy share, the host's launch calls per tick (kernel and
graph launches), the kernels per tick the graph holds
(``cuGraphGetNodes``), and the device time by kind, with Algorithm
1's pass, the three scheduler kernels and the GP program as groups of
their own.  It then counts, for the default (GP) and the persist
forecaster, the launches per tick made inside the code that copies
XLA:CPU's rounding (``step._fma``, ``base._sum_rows``, ``safeguard.beta``
and ``safeguard.sigma_from_var``, each run under a profiler range): a
run from an empty graph cache, whose warm-up tick and captured chunk
issue every launch from Python once, divided by the ticks so issued.

``--path kernels`` checks and times the device engine's four kernels
alone, as ``chip_smoke.py`` phase 8 does (device and host time per call
at the tick-200 states, resolve_oom also with victims, admission and
elastic re-placement also on the full-width cases with the most events,
and the phase cycles of the kernels that stamp them), then times the
``a*b + c`` kernel beside ``torch.add``'s device time, and the GP
program as ``--path gp`` does.  ``--path gp`` times the GP program alone
(its registers and spills as ptxas reports them; at 512 and 3,072
series, and, where the package's wrapper takes a ready mask, over 3,072
rows of which GP_SERIES run, the leading components of whole app slots).  With ``--src
DIR`` it takes the package from another checkout's ``src`` (a parent
commit unpacked with ``git archive``), so that two commits' kernels are
timed on one card in one call.

``--path gram`` is the Gram pair that the GP's Gram route launches: its
ptxas lines; with ``--src DIR`` the Gram module of the package under DIR
(a parent unpacked with ``git archive``, loaded from its file beside this
checkout's package) held beside this one, the forward bit for bit to it
and the gradient within the plain version's tolerance at every shape of
``chip_smoke.GRAM_SHAPES``, both kinds; both timed in turns at
``chip_smoke.GRAM_TIMED``'s four shapes (device time in graphs, beside the
bound); both at K(X, X) of 3,072 x 128 patterns against the features D
(``gram_by_features``); the forward with and without its stores
(``gram_without_stores``); what phase 5l's card-vs-CPU check reads with the
pair as it is and with deliberately wrong ones (``gram_margin``); then
GRAM_TICKS device-engine ticks at ``chip_smoke.LONG_GP`` under the
profiler, split into the Gram forward, the Gram gradient,
cuSOLVER/cuBLAS and the rest.

``--path control`` prints ``control_tick``'s ptxas lines and the
``clock64()`` cycles of member 0's block from the kernel's start to each
phase mark (staging, apps, slots, windows, capacities, mean and final in
the earlier design, by the lines CONTROL_MARKS names; the
``// phase:`` comments of a source that has them) and between marks, from
a stamped build (``stamped_member``); then times the control plane's
kernels alone, as ``chip_smoke.py`` phase 8 does: ``control_tick`` at the
main path's widths against its plain version and its bound, the
admission kernel with and without the gate, and the calibration kernels
with and without the per-tenant tier; then ``control_tick`` on the
arguments of the tick of the tenanted run (phase 5h's config, persist
forecasts, eager on the card: ``chip_smoke.captured_args``) whose
occupied slots are nearest the run's mean.  ``--path obs`` does the same
for ``obs_tick``: its cycles by phase (ring copy, staging, apps, windows,
tail and writes in the earlier design; OBS_MARKS) on the default path's inputs
and with every feature, its times as phase 8 takes them, and its time on
the rings run's captured tick (``SimConfig(obs=ObsConfig(enabled=True))``).
Both take the package under ``--src`` (one that has the kernel), so that
two versions are timed on one card in one call, in turns.

``--path leap`` prints ``leap_skip``'s ptxas lines and times it on the gap
cell's longest idle stretch (S = 1, A = 16, N = 24) with the next arrival
moved so that 1, 225 (as it is) and 20,000 ticks are skipped (LEAP_STRETCHES),
each launch first checked against the plain version bit for bit: device
microseconds a launch over a CUDA graph of 50 launches, twice, and
torch.profiler's.  With ``--src`` it times another package's kernel, so that
two versions are timed in one call, in turns.

``--path arima`` times the ARIMA kernel alone at the device engine's
shape (3,072 windows of 24, ARIMA_READY monitor rows ready, both
resources: 122 series) as ``chip_smoke.py`` phase 8 does, after its
registers and spills as ptxas reports them and the ``clock64()`` cycles
of one ready series by phase (normalisation, stage 1, stage 2,
residuals and AIC, recursion) from a build of the source with stamps
put before each phase's first line; ``--path calib`` the calibration
kernels as phase 8 does (``conformal_scale`` as the engine launches it,
at 3,072 warm rows and the pool, and beside ``torch.kthvalue``), after
their ptxas lines and the member kernels' ``clock64()`` cycles by phase
(``calib_observe``: staging, scan, writes; ``calib_begin``: staging, tree)
from a stamped build (``stamped_calib``); then ``calib_observe``,
``calib_begin`` and the shaping step with the per-tenant tier beside the
same launches without it.  Both take the package under ``--src`` too.

``--path whisper`` does the same for Whisper-large-v3 serving at full
width (random weights): one prefill of 8 requests x 1,500 frames with
``attn_impl="flash"``, then 4 greedy cached decode steps, each profiled
on its own, with the device time summed by kind of kernel.

Run from the repository root:

    python3 profile_port.py [--path sim|scan|kernels|gp|gram|control|obs|leap|arima|calib|whisper]
        [--src DIR]

Without a CUDA device it exits with an error and prints nothing else.
"""
from __future__ import annotations

import argparse
import dataclasses
import json
import re
import sys
import time
from pathlib import Path

PROFILED_TICKS = 120
SCAN_TICKS = 640       # 20 chunks of 32 ticks
KERNEL_LAUNCH_KEYS = ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC",
                      "cuLaunchKernelEx")
LAUNCH_KEYS = KERNEL_LAUNCH_KEYS + ("cudaGraphLaunch", "cuGraphLaunch")   # host launch calls
COPY_TICKS = 32        # the run that attributes launches to the copies: one captured chunk
# the device engine's code that rounds as XLA:CPU does (module, function)
XLA_COPIES = (("repro_torch.sim.step", "_fma"),
              ("repro_torch.core.forecast.base", "_sum_rows"),
              ("repro_torch.core.shaper.safeguard", "beta"),
              ("repro_torch.core.shaper.safeguard", "sigma_from_var"))


def _dev_us(e) -> float:
    return e.self_device_time_total


# device-time groups of the simulation's profile, by kernel name
SIM_KINDS = (("GP program", ("gp_forecast_kernel",)),
             ("Gram kernels", ("gram_fwd_kernel", "gram_bwd_kernel")),
             ("copy / cast", ("copy", "cast", "Copy", "Memcpy", "Memset")),
             ("elementwise", ("elementwise", "vectorized", "where", "unrolled")),
             ("reduction", ("reduce", "Reduce")))

# device-time groups of the device engine's profile, by kernel name
SCAN_KINDS = (("pessimistic_pass", ("pessimistic_pass_kernel",)),
              ("resolve_oom", ("resolve_oom_kernel",)),
              ("fma_f32", ("fma_f32",)),
              ("admit_queued", ("admit_queued_kernel",)),
              ("place_missing_elastic", ("place_missing_elastic_kernel",)),
              ("GP program", ("gp_forecast_kernel",)),
              ("sort", ("sort", "Sort", "radix")),
              ("index / gather / scatter", ("index", "gather", "scatter", "Index")),
              ("copy / cast", ("copy", "cast", "Copy", "Memcpy", "Memset")),
              ("elementwise", ("elementwise", "vectorized", "where", "unrolled")),
              ("reduction", ("reduce", "Reduce")))

# device-time groups of the Whisper profile, by kernel name
KINDS = (("flash kernel", ("flash_fwd_kernel", "flash_fwd_sm90_kernel")),
         ("GEMM", ("gemm", "xmma", "cutlass", "sm90_", "ampere_")),
         ("softmax", ("softmax",)),
         ("copy / cast", ("copy", "cast", "Copy", "Memcpy")),
         ("elementwise / masked_fill", ("elementwise", "vectorized", "masked_fill",
                                        "where", "unrolled")),
         ("reduction (LayerNorm, argmax)", ("reduce", "Reduce", "norm")))


def _kind(name: str, kinds=KINDS) -> str:
    for kind, keys in kinds:
        if any(k in name for k in keys):
            return kind
    return "other"


def _report(prof, wall: float, title: str, top: int = 12, kinds=KINDS) -> None:
    from torch.autograd import DeviceType
    kernels = [e for e in prof.key_averages()
               if e.device_type == DeviceType.CUDA and _dev_us(e) > 0]
    dev = sum(_dev_us(e) for e in kernels) / 1e6
    print(f"{title}: wall {wall * 1e3:.3f} ms, device busy {dev * 1e3:.3f} ms "
          f"= {dev / wall:.2%} of wall")
    by_kind: dict[str, float] = {}
    for e in kernels:
        kind = _kind(e.key, kinds)
        by_kind[kind] = by_kind.get(kind, 0.0) + _dev_us(e) / 1e3
    for kind, ms in sorted(by_kind.items(), key=lambda kv: -kv[1]):
        print(f"  {ms:10.3f} ms  {ms / (dev * 1e3):7.2%}  {kind}")
    print("  top kernels by device time:")
    for e in sorted(kernels, key=_dev_us, reverse=True)[:top]:
        print(f"  {_dev_us(e) / 1e3:10.3f} ms  {e.count:6d} launches  {e.key[:100]}")


def profile_whisper() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.models import get_config
    from repro_torch.models import whisper as W
    from repro_torch.serve import whisper_decode_step_fn, whisper_prefill_fn

    torch.backends.cuda.matmul.allow_bf16_reduced_precision_reduction = False
    cfg = dataclasses.replace(get_config("whisper-large-v3"), attn_impl="flash")
    gen = torch.Generator(device="cuda").manual_seed(0)
    params = W.init_whisper(cfg, generator=gen, device="cuda")
    frames = torch.randn((8, 1500, cfg.d_model), generator=gen, device="cuda")
    whisper_prefill_fn(params, cfg, frames)                  # build + warm-up
    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        enc, last = whisper_prefill_fn(params, cfg, frames)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, wall, "prefill, 8 x 1,500 frames + 448 tokens", top=15)
    caches = W.init_dec_caches(cfg, 8, cfg.dec_len, device="cuda")
    tok = last.argmax(-1)[:, None]
    _, caches = whisper_decode_step_fn(params, cfg, tok, enc, caches)  # warm-up
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(4):
            logits, caches = whisper_decode_step_fn(params, cfg, tok, enc, caches)
            tok = logits.argmax(-1)[:, None]
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    _report(prof, wall, "4 greedy cached decode steps, 8 requests")
    n_launch = sum(e.count for e in prof.key_averages()
                   if e.key in ("cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC"))
    print(f"  host kernel launches in the 4 steps: {n_launch}")
    return 0


def _in_range(fn, tag):
    from torch.profiler import record_function

    def ranged(*a, **k):
        with record_function(tag):
            return fn(*a, **k)
    return ranged


def copy_launches(cfg) -> tuple[int, int, dict]:
    """Run the device engine on ``cfg`` from an empty graph cache under
    the profiler with every function of XLA_COPIES in a range of its own;
    returns (ticks issued from Python: the warm-up tick and the captured
    ones, the kernel launches they issued, those launches by the
    innermost copy they were made in)."""
    import importlib
    import torch
    from torch.profiler import ProfilerActivity, profile
    from repro_torch.sim import run_sim_scan, step
    saved, issued = [], [0]
    for mod_name, name in XLA_COPIES:
        mod = importlib.import_module(mod_name)
        saved.append((mod, name, getattr(mod, name)))
        setattr(mod, name, _in_range(getattr(mod, name), f"xla_copy:{name}"))
    tick = step.fused_tick

    def counted_tick(*a, **k):
        issued[0] += 1
        return tick(*a, **k)
    step.fused_tick = counted_tick
    step._GRAPHS.clear()
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            run_sim_scan(cfg, device="cuda")
            torch.cuda.synchronize()
    finally:
        step.fused_tick = tick
        for mod, name, fn in saved:
            setattr(mod, name, fn)
    total, by_copy = 0, {}
    for e in prof.events():
        if e.name not in KERNEL_LAUNCH_KEYS:
            continue
        total += 1
        p = e.cpu_parent
        while p is not None and not p.name.startswith("xla_copy:"):
            p = p.cpu_parent
        if p is not None:
            key = p.name.split(":", 1)[1]
            by_copy[key] = by_copy.get(key, 0) + 1
    return issued[0], total, by_copy


def profile_scan() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    import chip_smoke
    from repro_torch.kernels import gp_forecast, sched, shaper
    from repro_torch.sim import SimConfig, run_sim_scan, step

    print(f"nvidia-smi: {chip_smoke.nvidia_smi()}")
    step._ChunkGraphs.keep_nodes = True      # the kernels per tick are counted from the nodes
    for name, cfg in (("bucketed", SimConfig()),
                      ("full batch", SimConfig(forecast_bucket=False))):
        step._GRAPHS.clear()
        run_sim_scan(dataclasses.replace(cfg, max_ticks=64), device="cuda")  # warm-up, capture
        (entry,) = step._GRAPHS.values()
        for line in chip_smoke.describe_graphs(entry):
            print(f"graph {line}")
        for m in (gp_forecast, shaper, sched):
            m.reset_launch_counts()
        torch.cuda.synchronize()
        rec = chip_smoke.record_runs(step)
        try:
            with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
                t0 = time.perf_counter()
                res = run_sim_scan(dataclasses.replace(cfg, max_ticks=SCAN_TICKS),
                                   device="cuda")
                torch.cuda.synchronize()
                wall = time.perf_counter() - t0
        finally:
            rec.stop()
        ka = prof.key_averages()
        ticks = res.timings["ticks"]
        mean, lo, hi = chip_smoke.series_per_launch(rec.metrics[0])
        print(f"device engine, {name}, {ticks} ticks under the profiler: "
              f"{shaper.pessimistic_pass.launches} pessimistic_pass, "
              f"{sched.resolve_oom.launches} resolve_oom, {sched.admit_queued.launches} "
              f"admit_queued, {sched.place_missing_elastic.launches} place_missing_elastic, "
              f"{gp_forecast.gp_fit_forecast.launches} GP program launches (replays x "
              f"captured), {mean:.3f} series per GP launch (min {lo}, max {hi}); buckets "
              f"{chip_smoke.runs_of(rec.buckets) or 'none'}")
        _report(prof, wall, f"device engine, {name}, {ticks} ticks", kinds=SCAN_KINDS,
                top=15)
        gp = [e for e in ka if "gp_forecast_kernel" in e.key and _dev_us(e) > 0]
        if gp:
            n = sum(e.count for e in gp)
            print(f"  GP program: {sum(_dev_us(e) for e in gp) / n:.3f} us per launch "
                  f"over {n} launches")
        calls = {k: sum(e.count for e in ka if e.key == k) for k in LAUNCH_KEYS}
        n_launch = sum(calls.values())
        kernels = sum(chip_smoke.graph_nodes(g.graph)[0].get("kernel", 0) / n
                      for n, g in entry.graphs.items()) / len(entry.graphs)
        print(f"  host launch calls: {n_launch} ({n_launch / ticks:.4f} per tick: "
              + ", ".join(f"{k} {v}" for k, v in calls.items() if v)
              + f"); kernels per tick in the graph: {kernels:.3f}; "
              f"wall {wall / ticks * 1e3:.4f} ms per tick")
        print("top operators by host time (self):")
        for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]:
            print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  {e.count:8d} calls  "
                  f"{e.key[:90]}")
    for forecaster in ("gp", "persist"):
        issued, total, by_copy = copy_launches(
            SimConfig(forecaster=forecaster, max_ticks=COPY_TICKS))
        n = sum(by_copy.values())
        per = ", ".join(f"{k} {v / issued:.1f}" for k, v in sorted(by_copy.items()))
        print(f"XLA:CPU rounding copies, {forecaster}, {issued} ticks issued from Python "
              f"(warm-up and capture): {n / issued:.1f} of {total / issued:.1f} kernel "
              f"launches per tick ({per or 'none attributed'})")
    return 0


GP_SERIES = 146    # series per GP launch, the mean over the first 640 ticks of SimConfig()


def profile_gp() -> int:
    """The GP program alone: its registers and spills, and its times at
    512 and 3,072 series and (a package whose wrapper takes a ready mask)
    over 3,072 rows of which GP_SERIES run."""
    import inspect
    import torch
    import chip_smoke
    from repro_torch.core.forecast import GPConfig
    from repro_torch.kernels import gp_forecast, nvcc, ref
    print(f"package {Path(gp_forecast.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    for line in nvcc.build(gp_forecast.SOURCE).log.splitlines():
        if "registers" in line or "spill" in line:
            print(f"  gp_forecast ptxas: {line.strip()}")
    masked = "ready" in inspect.signature(gp_forecast.gp_fit_forecast).parameters
    chip_smoke.time_gp_kernel(gp_forecast, ref, GPConfig, torch.device("cuda"),
                              chip_smoke.app_mask(GP_SERIES // 2, seed=3) if masked else None)
    return 0


def profile_gram(src: Path) -> int:
    """The Gram pair: its ptxas lines; where ``src`` holds another
    package, that package's Gram module (loaded from its file) beside this
    checkout's: the forward bit for bit to it and the gradient within the
    plain version's tolerance at every shape of chip_smoke.GRAM_SHAPES,
    both kinds; the timings of chip_smoke.time_kernels in turns;
    gram_by_features; gram_without_stores; gram_margin; then the
    device-time split of GRAM_TICKS device-engine ticks at LONG_GP
    (chip_smoke.gram_route_split)."""
    import importlib.util
    import torch
    import chip_smoke
    from repro_torch.kernels import gp_gram, nvcc, ref
    from repro_torch.sim import step
    dev = torch.device("cuda")
    print(f"package {Path(gp_gram.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    others = []
    theirs = src.resolve() / "repro_torch" / "kernels" / "gp_gram.py"
    if theirs != Path(gp_gram.__file__).resolve():
        spec = importlib.util.spec_from_file_location("gp_gram_of_src", theirs)
        mod = importlib.util.module_from_spec(spec)
        spec.loader.exec_module(mod)
        # nvcc.prepare keys a set-up by name, so this package's would stand
        # in for the other library's opt-in shared memory: call it here
        lib = mod._library()
        if hasattr(lib, "gp_gram_init") and lib.gp_gram_init() != 0:
            raise RuntimeError("--src gp_gram_init failed")
        others.append(("--src", mod))
    for label, mod in [("this", gp_gram)] + others:
        for line in nvcc.build(mod.SOURCE).log.splitlines():
            if re.search(r"registers|spill|Compiling entry", line):
                print(f"  {label} ptxas: {line.strip()}")
    for label, mod in others:
        worst = 0.0
        for kind in ("exp", "rbf"):
            for i, (b, m, n, d, same) in enumerate(chip_smoke.GRAM_SHAPES):
                xa, xb, ell, sf, g = chip_smoke.inputs(b, m, n, d, dev, same=same, seed=i)
                K, K_o = (x.gram_fwd(xa, xb, ell, sf, kind) for x in (gp_gram, mod))
                assert torch.equal(K.view(torch.int32), K_o.view(torch.int32)), \
                    (label, kind, b, m, n, d)
                got, want = (x.gram_bwd(g, xa, xb, ell, sf, kind) for x in (gp_gram, mod))
                for a, c in zip(got, want):
                    torch.testing.assert_close(a, c, rtol=chip_smoke.RTOL,
                                               atol=chip_smoke.ATOL * m * n)
                    worst = max(worst, (a - c).abs().max().item())
        print(f"  forward == {label}'s bit for bit at all {len(chip_smoke.GRAM_SHAPES)} "
              f"shapes, both kinds; gradient within the plain version's tolerance of "
              f"{label}'s (max abs diff {worst:.3g})")
    chip_smoke.time_kernels(gp_gram, ref, dev, others)
    gram_by_features(gp_gram, dev)
    gram_without_stores(gp_gram, nvcc, dev)
    gram_margin()
    split = chip_smoke.gram_route_split(step, GRAM_TICKS)
    print(f"  device engine at LONG_GP, {GRAM_TICKS} ticks under torch.profiler: "
          f"{json.dumps(split)}")
    return 0


GRAM_TICKS = 32    # device-engine ticks of the Gram route's split


GRAM_FEATURES = (1, 11, 21, 31, 41)   # D of gram_by_features (4 blocks an SM at each)


def gram_by_features(gp_gram, dev) -> None:
    """Device µs of both kernels at K(X, X) of the device engine's 3,072
    series of 128 patterns against the features D (GRAM_FEATURES): the
    slope is what a feature's dot-product terms cost, the intercept what
    an entry costs whatever D is (its sqrt, divide, exp and store, and each
    block's staging, transpose and norms)."""
    import numpy as np
    import chip_smoke
    rows = []
    for D in GRAM_FEATURES:
        xa, xb, ell, sf, g = chip_smoke.inputs(3072, 128, 128, D, dev, same=True, seed=7)
        fwd = min(chip_smoke.graph_us(lambda: gp_gram.gram_fwd(xa, xb, ell, sf, "exp"))
                  for _ in range(2))
        bwd = min(chip_smoke.graph_us(lambda: gp_gram.gram_bwd(g, xa, xb, ell, sf, "exp"))
                  for _ in range(2))
        rows.append((D, fwd, bwd))
        print(f"  K(X, X) of (3072, 128, 128, {D}): forward {fwd:.3f} us, gradient {bwd:.3f} us "
              f"device (exp)")
    d, f, b = (np.array(c, float) for c in zip(*rows))
    for name, t in (("forward", f), ("gradient", b)):
        slope, icpt = np.polyfit(d, t, 1)
        print(f"  {name}: {slope:.3f} us a feature + {icpt:.3f} us (least squares over D = "
              f"{GRAM_FEATURES})")


# the forward's stores on its block-a-series path, in its source
GRAM_STORES = ("      store4x4(K, N, r0, c0, mi, nj, v, vec);\n"
               "      if (mirror) store4x4_t(K, N, r0, c0, mi, nj, v, vec);\n")


def gram_without_stores(gp_gram, nvcc, dev) -> None:
    """The forward at K(X, X) of 3,072 x 128 patterns (D = 41 and 1) in
    turns with a build of its source whose block-a-series path stores
    nothing (GRAM_STORES behind a test that no entry passes, so that the
    arithmetic stays): what the arithmetic, the staging and the norms cost
    alone, and what the stores add to them."""
    import tempfile
    import chip_smoke
    text = gp_gram.SOURCE.read_text()
    if GRAM_STORES not in text:
        raise RuntimeError("the series path's stores moved: update GRAM_STORES")
    text = text.replace(GRAM_STORES, "      if (v[0][0] == 12345.f && v[3][3] == 54321.f) {\n"
                        + GRAM_STORES + "      }\n")
    cases = {D: chip_smoke.inputs(3072, 128, 128, D, dev, same=True, seed=3) for D in (41, 1)}

    def fwd(D):
        xa, xb, ell, sf, _ = cases[D]
        return chip_smoke.graph_us(lambda: gp_gram.gram_fwd(xa, xb, ell, sf, "exp"))

    real = {D: [fwd(D)] for D in cases}
    with tempfile.TemporaryDirectory() as tmp, kernel_variant(gp_gram, nvcc, text, Path(tmp)):
        bare = {D: [fwd(D), fwd(D)] for D in cases}
    for D in cases:
        real[D].append(fwd(D))
        print(f"  forward at K(X, X) of (3072, 128, 128, {D}): "
              f"{'/'.join(f'{t:.3f}' for t in real[D])} us device with its stores, "
              f"{'/'.join(f'{t:.3f}' for t in bare[D])} without (in turns)")


def gram_margin(dev="cuda") -> None:
    """What phase 5l's card-vs-CPU check reads at LONG_GP (exp, the 512
    windows of chip_smoke.long_windows) with the Gram pair as it is and
    with deliberately wrong ones: K rounded to bfloat16, and K at a
    lengthscale 2^-10 and 2^-7 too large (a forward kernel off by ~0.1% and
    ~0.8% in its divide).  For each: the rows beyond rtol 1e-3 on the mean, the largest
    |card - CPU| over the CPU's predictive sd among them
    (chip_smoke.mean_sd_reading) against chip_smoke.LONG_MEAN_SD, NaN rows,
    and whether chip_smoke.assert_gp_close passes.  ``dev``: where the
    route runs against the CPU."""
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core.forecast import GPConfig, GPForecaster
    from repro_torch.kernels import ops
    w, v = chip_smoke.long_windows()
    gp = GPForecaster(GPConfig(**chip_smoke.LONG_GP))
    h, H = chip_smoke.LONG_GP["history"], 3
    cpu = gp.forecast_batch(w, H, valid=v, device="cpu")
    mc, vc = cpu.mean.numpy(), cpu.var.numpy()
    sound = ops.gram

    def bf16(xa, xb, ell, sf, kind="exp"):
        return sound(xa, xb, ell, sf, kind=kind).bfloat16().float()

    def long_ell(e):
        return lambda xa, xb, ell, sf, kind="exp": sound(xa, xb, ell * (1 + 2.0 ** -e), sf,
                                                        kind=kind)

    wt, vt = torch.as_tensor(w, device=dev), torch.as_tensor(v, device=dev)
    for label, gram in (("as it is", sound), ("K in bfloat16", bf16),
                        ("lengthscale x (1 + 2^-10)", long_ell(10)),
                        ("lengthscale x (1 + 2^-7)", long_ell(7))):
        ops.gram = gram
        try:
            fc = gp.forecast_batch(wt, H, valid=vt, device=dev)
        finally:
            ops.gram = sound
        mg, vg = fc.mean.cpu().numpy(), fc.var.cpu().numpy()
        cnt = v.sum(1)
        beyond = int(((np.abs(mg - mc) > 1e-3 * np.abs(mc)) & (cnt >= h + 2)[:, None])
                     .any(1).sum())
        try:
            chip_smoke.assert_gp_close(mg, vg, mc, vc, w, cnt, label, h=h,
                                       mean_sd=chip_smoke.LONG_MEAN_SD)
            verdict = "passes"
        except AssertionError as e:
            verdict = f"fails ({e})"
        print(f"  margin of 5l's check, {label}: {beyond} of {len(w)} rows beyond rtol 1e-3 on "
              f"the mean, the largest {chip_smoke.mean_sd_reading(mg, mc, vc, cnt, h):.3g} "
              f"sd against the limit {chip_smoke.LONG_MEAN_SD}; "
              f"{int(np.isnan(mg).any(1).sum())} NaN rows; the check {verdict}")


def profile_kernels() -> int:
    import chip_smoke
    from repro_torch.kernels import fma, ref, sched, shaper
    from repro_torch.sim import SimConfig, step
    print(f"package {Path(shaper.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    cases = chip_smoke.scan_kernel_cases(step, SimConfig)
    fns = chip_smoke.scan_kernel_pairs(shaper, sched, ref)
    chip_smoke.check_scan_kernels(fns, cases)
    chip_smoke.time_scan_kernels(fns, cases, shaper, sched)
    chip_smoke.time_fma(fma, ref)
    return profile_gp()


def profile_control() -> int:
    """control_tick's cycles by phase from a stamped build, then the
    control plane's kernels as chip_smoke.py phase 8 times them, then
    control_tick on the argument of a tick captured from the tenanted
    run (member_times)."""
    import tempfile
    import numpy as np
    import chip_smoke
    from repro_torch.control import TenancyConfig
    from repro_torch.core.uncertainty import CalibrationConfig
    from repro_torch.kernels import calib, control, nvcc, ref, sched
    from repro_torch.sim import SimConfig, WorkloadConfig, step
    print(f"package {Path(control.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    for line in _ptxas(nvcc.build(control.SOURCE).log, "control_tick_kernel"):
        print(f"  control_tick ptxas: {line}")
    gpu = [a.cuda() if a is not None else None
           for a in chip_smoke.control_case([chip_smoke.control_member(
               np.random.default_rng(27), 4)], 4)]
    with tempfile.TemporaryDirectory() as tmp:
        member_phase_cycles(control, nvcc, Path(tmp), "control_tick", CONTROL_MARKS,
                            lambda: control.control_tick(*gpu, **chip_smoke.CONTROL_KW))
    cases = chip_smoke.scan_kernel_cases(step, SimConfig)
    chip_smoke.time_control(control, ref, sched, cases, calib, CalibrationConfig)
    cfg = chip_smoke.tenancy_config(SimConfig, WorkloadConfig, TenancyConfig, CalibrationConfig)
    args, kw, note = chip_smoke.captured_args(step, cfg, "control_tick")
    member_times("control_tick", lambda: control.control_tick(*args, **kw), note)
    return 0


def profile_obs() -> int:
    """obs_tick's cycles by phase from a stamped build (the default path's
    inputs), then its times as chip_smoke.py phase 8 takes them (the
    default path's inputs, and every feature), then on the arguments of a
    tick captured from the rings run (member_times)."""
    import tempfile
    import numpy as np
    import chip_smoke
    from repro_torch.kernels import nvcc, ref
    from repro_torch.kernels import obs as obs_kernel
    from repro_torch.obs import ObsConfig
    from repro_torch.sim import SimConfig, step
    print(f"package {Path(obs_kernel.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    for line in _ptxas(nvcc.build(obs_kernel.SOURCE).log, "obs_tick_kernel"):
        print(f"  obs_tick ptxas: {line}")
    full = chip_smoke.obs_case(np.random.default_rng(26))
    default = dict(full, **{k: v for k, v in chip_smoke.OBS_OFF.items() if k != "demand"})
    gpu = {"default path": chip_smoke._obs_cuda(default),
           "every feature": chip_smoke._obs_cuda(full)}
    with tempfile.TemporaryDirectory() as tmp:
        for what, a in gpu.items():
            member_phase_cycles(obs_kernel, nvcc, Path(tmp) / what.replace(" ", "_"),
                                "obs_tick", OBS_MARKS, lambda: obs_kernel.obs_tick(**a),
                                what)
    chip_smoke.time_obs(obs_kernel, ref)
    args, kw, note = chip_smoke.captured_args(step, SimConfig(obs=ObsConfig(enabled=True)),
                                              "obs_tick")
    member_times("obs_tick", lambda: obs_kernel.obs_tick(*args, **kw), note)
    return 0


LEAP_STRETCHES = (1, 225, 20_000)   # skipped ticks of the timed leap_skip launches


def leap_stretch(state, ticks: int):
    """The gap cell's longest idle stretch (``chip_smoke.gap_idle_state``:
    S = 1, A = 16, N = 24, 225 ticks skipped) as leap_skip's inputs, with
    the next arrival moved so that ``ticks`` are skipped: 1.5 ticks ahead
    for 1, as it is for 225, every app arrived and a budget of 20,000 for
    20,000."""
    import numpy as np
    args, tick, _ = state
    slot, queued, arrived, submit, done, t, left = (np.array(a) for a in args)
    if ticks == 20_000:
        arrived[...] = True
        left[...] = 20_000
    elif ticks == 1:
        k = int(np.argmin(np.where(arrived, np.inf, submit)))
        submit[0, k] = np.float32(t[0] + 1.5 * tick)
    return (slot, queued, arrived, submit, done, t, left), tick


def profile_leap() -> int:
    """leap_skip alone: its ptxas lines, then its device time at stretches
    of LEAP_STRETCHES skipped ticks (each first checked against the plain
    version bit for bit): CUDA events over a graph of 50 launches, twice,
    and torch.profiler's device time a launch."""
    import numpy as np
    import chip_smoke
    import torch
    from repro_torch.kernels import leap, nvcc, ref
    from repro_torch.sim import ClusterConfig, SimConfig, scenarios
    print(f"package {Path(leap.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    for line in _ptxas(nvcc.build(leap.SOURCE).log, "leap_skip_kernel"):
        print(f"  leap_skip ptxas: {line}")
    state = chip_smoke.gap_idle_state(scenarios, SimConfig, ClusterConfig)
    for ticks in LEAP_STRETCHES:
        args, tick = leap_stretch(state, ticks)
        cpu = [torch.as_tensor(np.ascontiguousarray(a, dt))
               for a, dt in zip(args, chip_smoke.LEAP_DTYPES)]
        gpu = [a.cuda() for a in cpu]
        want = ref.leap_skip(*cpu, tick)
        got = leap.leap_skip(*gpu, tick)
        assert int(want[1][0]) == ticks, (ticks, want)
        assert all(torch.equal(g.cpu().view(torch.int32), w.view(torch.int32))
                   for g, w in zip(got, want)), ticks
        us = [chip_smoke.graph_us(lambda: leap.leap_skip(*gpu, tick)) for _ in range(2)]
        prof = chip_smoke.device_us_per_call(lambda: leap.leap_skip(*gpu, tick),
                                             "leap_skip_kernel")
        print(f"  leap_skip, {ticks} ticks skipped: {'/'.join(f'{x:.3f}' for x in us)} us "
              f"device a launch (50 launches in a CUDA graph, replayed); torch.profiler "
              f"{'not measured' if prof is None else f'{prof:.3f} us'} a launch")
    return 0


# The marks of the member kernels' clock64() stamps.  A source with
# "// phase: NAME" comments takes a stamp before each (its last named
# "end"); the earlier designs, which have none, take one before each of
# these lines and one after their last statement (the second item).
CONTROL_MARKS = ((("  for (int t = tid; t < 3 * T; t += kThreads) comp[t] = 0;", "staging"),
                  ("  // the apps: the tick's events and the queue, per tenant", "apps"),
                  ("  // the slots: tenant and allocation summed over the components", "slots"),
                  ("  // each tenant's slots in XLA's tree: a thread per (tenant, resource,",
                   "windows"),
                  ("  float cap0 = 0.f, cap1 = 0.f;", "capacities"),
                  ("  if (tid == 0) {", "mean"),
                  ("  // a thread per tenant: the credit, the gate and the counters", "final")),
                 "    p.o_elig[i] = elig;\n  }\n")
OBS_MARKS = ((("  // the rings, copied to the outputs", "ring copy"),
              ("  // the tables, staged", "staging"),
              ("  // the queue and the admissions", "apps"),
              ("  // a warp a window, a lane per (table, resource): its slots and their",
               "windows"),
              ("  // meanwhile the last thread (in a warp without a window while nw < 8)",
               "tail"),
              ("  float sums[2][2] = {{0.f, 0.f}, {0.f, 0.f}};", "writes")),
             "  p.o_cursor[s] = p.cursor[s] + 1;\n")
# the latest of block 0's warps (their first lanes, and the block's last
# thread) to reach a mark
MEMBER_STAMP = ("if (blockIdx.x == 0 && (threadIdx.x % 32 == 0 || threadIdx.x == blockDim.x "
                "- 1)) atomicMax(&stamp_cyc[{i}], static_cast<unsigned long long>(clock64()));\n")


def stamped_member(source: str, name: str, marks) -> tuple[str, list[str]]:
    """A member kernel's source with clock64() stamps of member 0's block at
    each mark (MEMBER_STAMP) and ``{name}_stamps(out, reset)`` to read
    them; and the marks' names."""
    lines = source.splitlines(keepends=True)
    out, names = [], []
    if any("// phase: " in line for line in lines):
        for line in lines:
            m = re.search(r"// phase: (.+)$", line)
            if m:
                out.append(MEMBER_STAMP.format(i=len(names)))
                names.append(m.group(1).strip())
            out.append(line)
    else:
        pending = list(marks[0])
        for line in lines:
            if pending and pending[0][0] in line:
                out.append(MEMBER_STAMP.format(i=len(names)))
                names.append(pending.pop(0)[1])
            out.append(line)
        if pending or marks[1] not in source:
            raise ValueError(f"{name}: a phase mark was not found")
        out = ["".join(out).replace(marks[1], marks[1] + MEMBER_STAMP.format(i=len(names)))]
        names.append("end")
    n = len(names)
    text = "".join(out).replace("namespace {", f"__device__ unsigned long long stamp_cyc[{n}];\n"
                                "namespace {", 1)
    return text + (
        f'extern "C" int {name}_stamps(void* out, int reset) {{\n'
        f'  unsigned long long zero[{n}] = {{}};\n'
        '  return static_cast<int>(reset ? cudaMemcpyToSymbol(stamp_cyc, zero, sizeof zero)\n'
        '                                : cudaMemcpyFromSymbol(out, stamp_cyc, sizeof zero));\n'
        '}\n'), names


def member_phase_cycles(module, nvcc, tmp: Path, name: str, marks, fn, what="") -> None:
    """Member 0's clock64 cycles from the earliest mark to each mark, in
    the order they are reached (min over 20 launches of ``fn``), from a
    stamped build of ``module``'s source (kernel_variant).  A mark is the
    latest of the block's warps to reach it, so where warps run apart the
    marks of each warp's own work tell when it ended."""
    import ctypes
    import torch
    text, names = stamped_member(module.SOURCE.read_text(), name, marks)
    with kernel_variant(module, nvcc, text, tmp) as lib:
        read = getattr(lib, f"{name}_stamps")
        read.argtypes = [ctypes.c_void_p, ctypes.c_int]
        stamps = (ctypes.c_ulonglong * len(names))()
        at = [float("inf")] * len(names)
        for _ in range(20):
            if read(None, 1) != 0:
                raise RuntimeError(f"{name}_stamps failed")
            fn()
            torch.cuda.synchronize()
            if read(stamps, 0) != 0:
                raise RuntimeError(f"{name}_stamps failed")
            t0 = min(x for x in stamps if x)
            at = [min(a, stamps[i] - t0) if stamps[i] else a for i, a in enumerate(at)]
    order = sorted(range(len(names)), key=lambda i: at[i])
    print(f"  {name} clock64 cycles of member 0's block{', ' + what if what else ''} (min "
          f"of 20 launches) from the earliest mark to each: " + ", ".join(
              f"{names[i]} {at[i]}" for i in order))


def member_times(name: str, fn, note: str) -> None:
    """Device us a launch of ``fn`` (a CUDA graph of 50 launches, twice) on
    a captured tick's arguments."""
    import chip_smoke
    us = [chip_smoke.graph_us(fn) for _ in range(2)]
    print(f"  {name} on {note}: {'/'.join(f'{x:.3f}' for x in us)} us device a launch "
          f"(50 launches in a CUDA graph, replayed)")


ARIMA_READY = 61   # monitor rows ready (x2 resources), the main ARIMA run's mean

ARIMA_PHASES = ("normalisation", "stage 1", "stage 2", "residuals and AIC", "recursion")
# the first line of each phase of csrc/arima_forecast.cu and the stamp it
# takes: in this design, whose two stages are passes of one loop (the
# pass, `stage`, picks the stamp), and in the earlier one (a lane a
# candidate order); a last stamp follows the recursion
ARIMA_MARKS = ((("// phase: normalisation", "0"), ("// phase: stage 1 or 2", "stage"),
                ("// phase: residuals", "3"), ("// phase: recursion", "4")),
               (("// scale normalisation", "0"), ("// stage 1: the long AR", "1"),
                ("// stage 2: z on", "2"), ("float ssq = 0.f, r_last", "3"),
                ("// the chosen order's k-step", "4")))
ARIMA_END = "    vo[j] = at_least(mul(mul(sig2, cs2), sd2), 1e-9f);\n  }\n"
STAMP = ("if (s == {s}) atomicMax(&stamp_cyc[{i}], "
         "static_cast<unsigned long long>(clock64()));\n")


def stamped_arima(source: str, series: int) -> str:
    """The ARIMA kernel's source with clock64() stamps of series ``series``
    (the latest of its threads to reach each phase's first line, and the
    end of its recursion) and ``arima_stamps(out, reset)`` to read them."""
    marks = next((m for m in ARIMA_MARKS if m[0][0] in source), None)
    if marks is None or ARIMA_END not in source:
        raise ValueError("the ARIMA source has none of the phase marks of ARIMA_MARKS")
    out, k = [], 0
    for line in source.splitlines(keepends=True):
        if k < len(marks) and marks[k][0] in line:
            out.append(STAMP.format(s=series, i=marks[k][1]))
            k += 1
        out.append(line)
    if k < len(marks):
        raise ValueError(f"the phase mark {marks[k][0]!r} was not found")
    n = len(ARIMA_PHASES) + 1
    text = "".join(out).replace(ARIMA_END, ARIMA_END + STAMP.format(s=series, i=n - 1))
    text = text.replace("namespace {", f"__device__ unsigned long long stamp_cyc[{n}];\n"
                        "namespace {", 1)
    return text + (
        'extern "C" int arima_stamps(void* out, int reset) {\n'
        f'  unsigned long long zero[{n}] = {{}};\n'
        '  return static_cast<int>(reset ? cudaMemcpyToSymbol(stamp_cyc, zero, sizeof zero)\n'
        '                                : cudaMemcpyFromSymbol(out, stamp_cyc, sizeof zero));\n'
        '}\n')


def _ptxas(log: str, kernel: str) -> list[str]:
    """ptxas's lines of one kernel from an nvcc -Xptxas -v log."""
    lines, on = [], False
    for line in log.splitlines():
        if "Compiling entry function" in line:
            on = kernel in line
        elif on and re.search(r"registers|spill|smem", line):
            lines.append(line.strip())
    return lines


def profile_arima() -> int:
    """The ARIMA kernel alone: ptxas's registers and spills, one ready
    series' cycles by phase (min over 20 launches), then its times."""
    import ctypes
    import tempfile
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core.forecast import ARIMAConfig
    from repro_torch.kernels import arima_forecast, nvcc, ref
    print(f"package {Path(arima_forecast.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    for line in _ptxas(nvcc.build(arima_forecast.SOURCE).log, "arima_forecast_kernel"):
        print(f"  arima_forecast ptxas: {line}")
    cfg = ARIMAConfig()
    w, v = chip_smoke.arima_windows(seed=2)
    ready = np.concatenate([chip_smoke.app_mask(ARIMA_READY, seed=3)] * 2)
    fit = ready & (v.sum(1) >= cfg.long_ar + cfg.max_p + 2)
    series = int(np.nonzero(fit)[0][0])
    with tempfile.TemporaryDirectory() as tmp:
        src = Path(tmp) / "arima_forecast.cu"
        src.write_text(stamped_arima(arima_forecast.SOURCE.read_text(), series))
        lib = ctypes.CDLL(str(nvcc.build(src).path))
    ptr, i32 = ctypes.c_void_p, ctypes.c_int
    lib.arima_forecast.argtypes = [ptr] * 5 + [i32] * 7 + [ptr]
    lib.arima_stamps.argtypes = [ptr, i32]
    dev = torch.device("cuda")
    tw, tv, tr = (torch.as_tensor(x).to(dev) for x in (w, v, ready))
    B, T = w.shape
    mean, var = (torch.empty((B, 3), device=dev) for _ in range(2))
    n = len(ARIMA_PHASES) + 1
    stamps = (ctypes.c_ulonglong * n)()
    best = [float("inf")] * (n - 1)

    def read_stamps(out, reset):
        rc = lib.arima_stamps(out, reset)
        if rc != 0:
            raise RuntimeError(f"arima_stamps failed: CUDA error {rc}")

    for _ in range(20):
        read_stamps(None, 1)
        nvcc.launch(lib.arima_forecast, "arima_forecast", dev, tw, tv, tr, mean, var, B, T, 3,
                    cfg.max_p, cfg.max_q, cfg.max_d, cfg.long_ar)
        torch.cuda.synchronize()
        read_stamps(stamps, 0)
        best = [min(b, stamps[i + 1] - stamps[i]) for i, b in enumerate(best)]
    print(f"  clock64 cycles of series {series} by phase (min of 20 launches): " + ", ".join(
        f"{name} {c}" for name, c in zip(ARIMA_PHASES, best)) + f"; total {sum(best)}")
    chip_smoke.time_arima(arima_forecast, ref, ARIMAConfig, ready[:len(ready) // 2])
    return 0


CALIB_PHASES = ("observe: staging", "observe: scan", "observe: writes",
                "begin: staging", "begin: tree")
# the line each stamp of csrc/calib.cu goes before (in the order of the
# source; the stamps' indices: observe 0-3, calib_begin 4-6): in this
# design, and in the earlier one (tiles of 1,024 rows ranked by ballots,
# whose ranks and writes are one phase, "scan"; its "writes" the counters)
CALIB_MARKS = ((("// phase: staging", 0), ("// phase: scan", 1), ("// phase: writes", 2),
                ("// phase: end", 3), ("// phase: begin staging", 4), ("// phase: tree", 5),
                ("// phase: begin end", 6)),
               (("  int n_ok = 0, n_err = 0, n_drop = 0;", 0),
                ("  n_ok = __reduce_add_sync(0xffffffffu, n_ok);", 1),
                ("  for (int g = tid; g < p.G; g += kThreads) {", 2),
                ("  if (tid != 0) return;", 3), ("  int n_dep = 0;", 4),
                ("  const int half = (R + kWindow - 1) / kWindow + 1;", 5),
                ("    p.o_scale_n[g] = p.scale_n[g] + deployed;", 6)))
CALIB_STAMP = ("if (blockIdx.x == 0 && blockIdx.y == 0 && threadIdx.x % 32 == 0) "
               "atomicMax(&stamp_cyc[{i}], static_cast<unsigned long long>(clock64()));\n")


def stamped_calib(source: str) -> str:
    """calib.cu with clock64() stamps of the first block of member 0 of
    calib_observe and calib_begin (the latest of its warps' first lanes to
    reach each phase's first line, and each kernel's end) and
    ``calib_stamps(out, reset)`` to read them."""
    marks = next((m for m in CALIB_MARKS if m[0][0] in source), None)
    if marks is None:
        raise ValueError("the calibration source has none of the phase marks of CALIB_MARKS")
    out, k = [], 0
    for line in source.splitlines(keepends=True):
        if k < len(marks) and marks[k][0] in line:
            out.append(CALIB_STAMP.format(i=marks[k][1]))
            k += 1
        out.append(line)
    if k < len(marks):
        raise ValueError(f"the phase mark {marks[k][0]!r} was not found")
    n = len(marks)
    text = "".join(out).replace("namespace {", f"__device__ unsigned long long stamp_cyc[{n}];\n"
                                "namespace {", 1)
    return text + (
        'extern "C" int calib_stamps(void* out, int reset) {\n'
        f'  unsigned long long zero[{n}] = {{}};\n'
        '  return static_cast<int>(reset ? cudaMemcpyToSymbol(stamp_cyc, zero, sizeof zero)\n'
        '                                : cudaMemcpyFromSymbol(out, stamp_cyc, sizeof zero));\n'
        '}\n')


class kernel_variant:
    """A kernel module's wrappers on a library built from ``text`` (a
    variant of its source, its headers beside it) inside the ``with``; the
    module's own library after it."""

    def __init__(self, module, nvcc, text: str, tmp: Path):
        self.module, self.nvcc = module, nvcc
        tmp.mkdir(parents=True, exist_ok=True)
        for h in module.SOURCE.parent.glob("*.cuh"):
            (tmp / h.name).write_bytes(h.read_bytes())
        self.source = tmp / module.SOURCE.name
        self.source.write_text(text)

    def _swap(self, source):
        self.module._LIB = None
        self.module.SOURCE = source
        self.nvcc._PREPARED.discard((self.module.SOURCE.stem, 0))

    def __enter__(self):
        self.saved = self.module.SOURCE
        self._swap(self.source)
        return self.module._library()

    def __exit__(self, *exc):
        self._swap(self.saved)


def calib_phase_cycles(calib, nvcc, tmp: Path, args) -> None:
    """The member's clock64 cycles by phase, min over 20 launches of each
    kernel, without the tier and with it (T = 4), from a stamped build of
    the package's source."""
    import ctypes
    import torch
    with kernel_variant(calib, nvcc, stamped_calib(calib.SOURCE.read_text()), tmp) as lib:
        lib.calib_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
        n = 7
        stamps = (ctypes.c_ulonglong * n)()

        def stamped(fn):
            best = [float("inf")] * n
            for _ in range(20):
                if lib.calib_stamps(None, 1) != 0:
                    raise RuntimeError("calib_stamps failed")
                fn()
                torch.cuda.synchronize()
                if lib.calib_stamps(stamps, 0) != 0:
                    raise RuntimeError("calib_stamps failed")
                best = [min(b, stamps[i + 1] - stamps[i]) if i not in (3, 6) else b
                        for i, b in enumerate(best)]
            return best
        for tier in ("no tier", "tier"):
            obs, begin = args[tier]
            c = [stamped(obs)[i] for i in (0, 1, 2)] + [stamped(begin)[i] for i in (4, 5)]
            print(f"  clock64 cycles of member 0's first block by phase, {tier} (min of "
                  f"20 launches): " + ", ".join(f"{p} {x}" for p, x in zip(CALIB_PHASES, c)))


def profile_calib() -> int:
    """The calibration kernels alone, as chip_smoke.py phase 8 times them,
    after ptxas's lines of each and the member kernels' cycles by phase;
    then calib_observe, calib_begin and calib_scales with the per-tenant
    tier and without it (chip_smoke.time_calib_tier)."""
    import tempfile
    import numpy as np
    import torch
    import chip_smoke
    from repro_torch.core.uncertainty import CalibrationConfig
    from repro_torch.kernels import calib, nvcc, ref
    print(f"package {Path(calib.__file__).resolve().parents[2]}; nvidia-smi: "
          f"{chip_smoke.nvidia_smi()}")
    log = nvcc.build(calib.SOURCE).log
    for kernel in ("calib_observe_kernel", "conformal_scale_kernel", "calib_begin_kernel"):
        for line in _ptxas(log, kernel):
            print(f"  {kernel} ptxas: {line}")
    # the full-width warm state, with the tier and without it
    cfg = chip_smoke.calib_config(CalibrationConfig)
    st, tick = chip_smoke.calib_state(7, warm=True)
    tier, table = chip_smoke.calib_tier(np.random.default_rng(27), st, 4)
    ocpu, scpu = chip_smoke.tier_args(st, tick, tier, table, "cpu", cfg=cfg)
    to = lambda a: a.cuda() if isinstance(a, torch.Tensor) else a  # noqa: E731
    og = [to(a) for a in ocpu[:-1]] + [tuple(to(a) for a in ocpu[-1])]
    sg = [to(a) for a in scpu[:-1]] + [tuple(to(a) for a in scpu[-1])]
    okw = dict(pool_on=cfg.pool, adaptive=cfg.adaptive, gamma=cfg.gamma, budget=cfg.budget,
               q_min=cfg.q_min, q_max=cfg.q_max)
    cap, pcap = st["ring"].shape[2], st["pool"].shape[1]
    bkw = dict(cap=cap, pcap=pcap, horizon=3, fallback=3.0, min_scores=cfg.min_scores,
               pool_on=cfg.pool)
    credit, tenant, slot_gid, gring, gcount, group = sg[-1][:6]
    raw = calib.calib_quantiles(*sg[:6], (credit, tenant, slot_gid, gring, gcount)
                                + sg[-1][6:], min_scores=cfg.min_scores, pool_on=cfg.pool)
    bargs = [sg[1], sg[3], raw[0], raw[1]] + sg[6:-1]
    btier = (tenant, slot_gid, gcount, raw[2], group, tier["group_ring"].shape[2])
    kernels = {"no tier": (lambda: calib.calib_observe(*og[:-1], **okw),
                           lambda: calib.calib_begin(*bargs, **bkw)),
               "tier": (lambda: calib.calib_observe(*og, **okw),
                        lambda: calib.calib_begin(*bargs, btier, **bkw))}
    with tempfile.TemporaryDirectory() as tmp:
        calib_phase_cycles(calib, nvcc, Path(tmp) / "stamped", kernels)
        chip_smoke.time_calib(calib, ref, CalibrationConfig)
        chip_smoke.time_calib_tier(calib, ref, CalibrationConfig, np.random.default_rng(27))
    return 0


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    here = Path(__file__).resolve().parent
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--path", choices=("sim", "scan", "kernels", "gp", "gram", "control",
                                       "obs", "leap", "arima", "calib", "whisper"),
                    default="sim")
    ap.add_argument("--src", type=Path, default=here / "src",
                    help="the directory that holds the repro_torch package")
    args = ap.parse_args()
    if not torch.cuda.is_available():
        print("profile_port: torch sees no CUDA device", file=sys.stderr)
        return 2
    # --path gram runs this checkout's package and loads only the Gram
    # module of the one under --src beside it
    sys.path[:0] = [str((here / "src" if args.path == "gram" else args.src).resolve()),
                    str(here)]
    from repro_torch.kernels import gp_forecast, gp_gram
    from repro_torch.sim import SimConfig, run_sim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    if args.path == "whisper":
        return profile_whisper()
    if args.path == "scan":
        return profile_scan()
    if args.path == "kernels":
        return profile_kernels()
    if args.path == "gp":
        return profile_gp()
    if args.path == "gram":
        return profile_gram(args.src)
    if args.path == "control":
        return profile_control()
    if args.path == "obs":
        return profile_obs()
    if args.path == "leap":
        return profile_leap()
    if args.path == "arima":
        return profile_arima()
    if args.path == "calib":
        return profile_calib()
    run_sim(SimConfig(max_ticks=20), device="cuda")          # build + warm-up
    gp_forecast.reset_launch_counts()

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run_sim(SimConfig(max_ticks=PROFILED_TICKS), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    tm = res.timings
    print(f"main path, {PROFILED_TICKS} ticks under the profiler: forecast "
          f"{tm['forecast']:.3f} s, policy {tm['policy']:.3f} s; "
          f"{gp_forecast.gp_fit_forecast.launches} GP program launches")
    _report(prof, wall, f"main path, {PROFILED_TICKS} ticks", kinds=SIM_KINDS)
    n_launch = sum(e.count for e in ka if e.key in (
        "cudaLaunchKernel", "cuLaunchKernel", "cudaLaunchKernelExC", "cuLaunchKernelEx"))
    print(f"  host kernel launches: {n_launch} ({n_launch / PROFILED_TICKS:.1f} per tick)")
    print("top operators by device time (self):")
    for e in sorted(ka, key=_dev_us, reverse=True)[:12]:
        print(f"  {_dev_us(e) / 1e3:10.3f} ms  {e.count:8d} calls  {e.key[:90]}")
    print("top operators by host time (self):")
    for e in sorted(ka, key=lambda e: e.self_cpu_time_total, reverse=True)[:15]:
        print(f"  {e.self_cpu_time_total / 1e3:10.3f} ms  {e.count:8d} calls  {e.key[:90]}")

    # the Gram kernels alone at B = 512 series of (10 x 11) patterns
    g = torch.Generator(device="cuda").manual_seed(0)
    x = torch.randn((512, 10, 11), device="cuda", generator=g)
    ell = torch.rand((512,), device="cuda", generator=g) + 0.5
    sf = torch.rand((512,), device="cuda", generator=g) + 0.5
    grad = torch.randn((512, 10, 10), device="cuda", generator=g)
    n = 200
    torch.cuda.synchronize()
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        for _ in range(n):
            gp_gram.gram_fwd(x, x, ell, sf)
            gp_gram.gram_bwd(grad, x, x, ell, sf)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    for e in prof.key_averages():
        if "gram_fwd_kernel" in e.key or "gram_bwd_kernel" in e.key:
            print(f"{e.key[-40:]}: {_dev_us(e) / e.count:.3f} us device time per launch "
                  f"({e.count} launches)")
    print(f"wrapper calls: {wall / (2 * n) * 1e6:.3f} us per call on the host clock")

    return 0


if __name__ == "__main__":
    sys.exit(main())
