#!/usr/bin/env python3
"""Where the PyTorch port's main path spends its time on one CUDA card.

Runs the default simulation (``run_sim(SimConfig())``, GP + pessimistic,
full width) for a capped number of ticks under ``torch.profiler`` and
prints the device's busy share (summed kernel time over wall time), the
operators that take the most device time and the most host time, and
the Gram kernels' device time per launch at the main path's largest
batch.  Run from the repository root:

    python3 profile_port.py

Without a CUDA device it exits with an error and prints nothing else.
"""
from __future__ import annotations

import sys
import time
from pathlib import Path

PROFILED_TICKS = 120


def _dev_us(e) -> float:
    return e.self_device_time_total


def main() -> int:
    import torch
    from torch.profiler import ProfilerActivity, profile
    if not torch.cuda.is_available():
        print("profile_port: torch sees no CUDA device", file=sys.stderr)
        return 2
    sys.path.insert(0, str(Path(__file__).resolve().parent / "src"))
    from repro_torch.kernels import gp_gram
    from repro_torch.sim import SimConfig, run_sim

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(torch.cuda.get_device_name(0), torch.__version__, torch.version.cuda)
    run_sim(SimConfig(max_ticks=20), device="cuda")          # build + warm-up

    acts = [ProfilerActivity.CPU, ProfilerActivity.CUDA]
    with profile(activities=acts) as prof:
        t0 = time.perf_counter()
        res = run_sim(SimConfig(max_ticks=PROFILED_TICKS), device="cuda")
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    ka = prof.key_averages()
    dev = sum(_dev_us(e) for e in ka) / 1e6
    tm = res.timings
    print(f"main path, {PROFILED_TICKS} ticks under the profiler: wall {wall:.3f} s, "
          f"forecast {tm['forecast']:.3f} s, policy {tm['policy']:.3f} s; "
          f"device busy {dev:.4f} s = {dev / wall:.2%} of wall")
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
