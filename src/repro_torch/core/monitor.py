"""Resource monitor — fixed-window utilization time series per component.

A copy of ``repro/core/monitor.py``: host-side numpy ring buffers that
hand the forecasters a dense (slots, W) array plus validity masks,
oldest-first.  Sampling is I/O, not compute, so it stays on the host.
"""
from __future__ import annotations

import numpy as np

N_RES = 2          # 0 = cpu, 1 = mem
CPU, MEM = 0, 1


class Monitor:
    def __init__(self, slots: int, window: int):
        self.window = window
        self.buf = np.zeros((slots, window, N_RES), np.float32)
        self.count = np.zeros((slots,), np.int64)   # samples seen per slot

    def reset_slot(self, slot) -> None:
        self.buf[slot] = 0.0
        self.count[slot] = 0

    def record(self, slots: np.ndarray, cpu: np.ndarray,
               mem: np.ndarray) -> None:
        """Append one sample for each slot in ``slots`` (vectorized)."""
        self.buf[slots] = np.roll(self.buf[slots], -1, axis=1)
        self.buf[slots, -1, CPU] = cpu
        self.buf[slots, -1, MEM] = mem
        self.count[slots] += 1

    def windows(self, slots: np.ndarray):
        """(windows, valid): (n, W, 2) float32 and (n, W) bool, oldest-first."""
        w = self.buf[slots]
        age = np.arange(self.window)[None, :]  # 0 = oldest cell
        valid = age >= (self.window - np.minimum(self.count[slots], self.window))[:, None]
        return w, valid

    def ready(self, slots: np.ndarray, grace: int) -> np.ndarray:
        """Grace period (paper §5): shape only after ``grace`` samples."""
        return self.count[slots] >= grace
