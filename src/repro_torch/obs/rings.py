"""The device engine's telemetry rings: per-tick series written inside
the fused tick and drained by the host at chunk boundaries (counterpart
of ``repro/obs/rings.py``).

:class:`ObsState` rides in ``SimState.obs``; each tick one
``ops.obs_tick`` launch (``kernels/csrc/obs.cu``) writes the tick's
thirteen channels at column ``cursor % R``, gated on the member being
active; :class:`RingDrain` turns the chunk-boundary snapshots into
contiguous per-member histories.  The reference's two invariants hold:

  * STRUCTURAL ABSENCE — ``SimState.obs`` is None when
    ``SimConfig.obs.enabled`` is off, and the tick launches nothing for
    it;
  * CHUNK INVARIANCE — the rings record raw per-tick sums and event
    deltas, never ratios, and writes are gated on the tick's ``active``
    mask as ``TickMetrics.valid`` is, so histories are the same for any
    chunk size.

The channels are packed into one float32 and one int32 table of shape
``(S, F, R)``, in the reference's order; :meth:`RingDrain.history` still
returns a ``field name -> (T,)`` mapping.
"""
from __future__ import annotations

import dataclasses

import numpy as np
import torch

from repro_torch.obs.config import ObsConfig

# ring fields: (name, dtype), all raw sums or deltas
RING_FIELDS = (
    ("used_cpu", torch.float32),      # cluster-total instantaneous usage
    ("used_mem", torch.float32),
    ("queue", torch.int32),           # apps waiting in the FIFO queue
    ("gap_cpu", torch.float32),       # shaped-demand sum - usage sum
    ("gap_mem", torch.float32),       # (0 under the baseline policy)
    ("oom", torch.int32),             # OOM kills this tick
    ("fail", torch.int32),            # uncontrolled failure events
    ("preempt", torch.int32),         # full + partial preemptions
    ("admitted", torch.int32),        # apps admitted from the queue
    ("throttled", torch.int32),       # gate-held queued app-ticks (tenancy)
    ("credit", torch.float32),        # mean credit of active tenants
    ("cov_resolved", torch.int32),    # conformal predictions resolved
    ("cov_errors", torch.int32),      # ... of which miscovered
)

F32_NAMES = tuple(n for n, dt in RING_FIELDS if dt == torch.float32)
I32_NAMES = tuple(n for n, dt in RING_FIELDS if dt == torch.int32)
_NP = {torch.float32: np.float32, torch.int32: np.int32}


@dataclasses.dataclass(frozen=True)
class ObsState:
    """Per-member telemetry rings.  ``cursor`` counts the ticks recorded
    (monotone); tick ``k`` lives at column ``k % R`` until drained."""

    cursor: torch.Tensor    # (S,) i32
    f32: torch.Tensor       # (S, len(F32_NAMES), R) f32, rows in F32_NAMES order
    i32: torch.Tensor       # (S, len(I32_NAMES), R) i32, rows in I32_NAMES order
    # leap only (None otherwise): the idle ticks skipped just before the
    # tick recorded at each column; they are all-zero on every channel,
    # so RingDrain re-expands them into zero columns
    lead: torch.Tensor | None = None


def obs_init(cfg: ObsConfig, batch: int, leap: bool = False, device="cpu") -> ObsState:
    """Fresh rings for ``batch`` members on ``device``."""
    R = int(cfg.ring)
    return ObsState(
        cursor=torch.zeros(batch, dtype=torch.int32, device=device),
        f32=torch.zeros((batch, len(F32_NAMES), R), dtype=torch.float32, device=device),
        i32=torch.zeros((batch, len(I32_NAMES), R), dtype=torch.int32, device=device),
        lead=torch.zeros((batch, R), dtype=torch.int32, device=device) if leap else None)


def obs_record(obs: ObsState, active: torch.Tensor, values: dict,
               lead: torch.Tensor | None = None) -> ObsState:
    """Write one tick's ``values`` (field name -> (S,) tensor, or a Python
    number for every member) at ``cursor % R`` where ``active`` (S,)
    holds, and ``lead`` (S,) (or 0) beside it when the state has a lead
    ring: the reference's ``obs_record`` as plain tensor operations,
    which read nothing back."""
    S, _, R = obs.f32.shape
    dev = obs.f32.device
    oh = (torch.arange(R, device=dev) == (obs.cursor % R)[:, None]) & active[:, None]

    def col(name, dtype):
        v = values[name]
        if isinstance(v, torch.Tensor):
            return v.to(dtype).expand(S)
        return torch.full((S,), v, dtype=dtype, device=dev)

    vf = torch.stack([col(n, torch.float32) for n in F32_NAMES], 1)
    vi = torch.stack([col(n, torch.int32) for n in I32_NAMES], 1)
    lead_ring = obs.lead
    if lead_ring is not None:
        lv = torch.zeros_like(obs.cursor) if lead is None else lead.to(torch.int32)
        lead_ring = torch.where(oh, lv[:, None], obs.lead)
    return ObsState(cursor=obs.cursor + active.int(),
                    f32=torch.where(oh[:, None, :], vf[:, :, None], obs.f32),
                    i32=torch.where(oh[:, None, :], vi[:, :, None], obs.i32),
                    lead=lead_ring)


def _host(obs: ObsState) -> tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray | None]:
    """The rings as numpy arrays, with one copy from their device: the
    tables' bits and the cursor (and lead) packed into one int32 tensor."""
    S, nf, R = obs.f32.shape
    parts = [obs.cursor[:, None], obs.f32.view(torch.int32).reshape(S, -1),
             obs.i32.reshape(S, -1)]
    if obs.lead is not None:
        parts.append(obs.lead)
    flat = torch.cat(parts, 1).cpu().numpy()
    ni = obs.i32.shape[1]
    cur = flat[:, 0].astype(np.int64)
    f32 = flat[:, 1:1 + nf * R].copy().view(np.float32).reshape(S, nf, R)
    i32 = flat[:, 1 + nf * R:1 + (nf + ni) * R].reshape(S, ni, R)
    lead = flat[:, 1 + (nf + ni) * R:].astype(np.int64) if obs.lead is not None else None
    return cur, f32, i32, lead


class RingDrain:
    """Host-side accumulator: chunk-boundary ``ObsState`` snapshots ->
    contiguous per-tick histories (the reference's ``RingDrain``).

    Keeps a drained count per member (members finish at different ticks,
    so their cursors diverge) and unrolls the ring's modular indexing.
    The chunk drivers keep ``chunk <= ring``, so no undrained tick is ever
    overwritten; a violation raises."""

    def __init__(self):
        self._drained: np.ndarray | None = None
        self._parts: list[dict] | None = None

    def drain(self, obs: ObsState) -> None:
        """Take the ticks recorded since the last drain, with one copy of
        the rings to the host."""
        cur, f32, i32, lead = _host(obs)
        R = f32.shape[-1]
        if self._parts is None:
            self._drained = np.zeros_like(cur)
            self._parts = [{name: [] for name, _ in RING_FIELDS} for _ in range(cur.size)]
        for m in range(cur.size):
            n = int(cur[m] - self._drained[m])
            if n == 0:
                continue
            if n > R:
                raise RuntimeError(
                    f"obs ring overflow: {n} ticks written since the "
                    f"last drain exceeds capacity {R} (keep chunk <= "
                    "SimConfig.obs.ring)")
            idx = (self._drained[m] + np.arange(n)) % R
            pos = None
            if lead is not None:
                # leap: each column stands for its `lead` skipped
                # (all-zero) ticks followed by the recorded tick
                reps = lead[m, idx] + 1
                pos = np.cumsum(reps) - 1
                n = int(reps.sum())
            for table, names in ((f32, F32_NAMES), (i32, I32_NAMES)):
                for j, name in enumerate(names):
                    col = table[m, j, idx]
                    if pos is not None:
                        out = np.zeros(n, col.dtype)
                        out[pos] = col
                        col = out
                    self._parts[m][name].append(col)
        self._drained = cur.copy()

    def history(self, member: int = 0) -> dict:
        """``field -> (T,) array`` of per-tick values for one member (T =
        the member's executed tick count)."""
        if self._parts is None:
            return {name: np.zeros((0,), _NP[dt]) for name, dt in RING_FIELDS}
        p = self._parts[member]
        return {name: (np.concatenate(p[name]) if p[name] else np.zeros((0,), _NP[dt]))
                for name, dt in RING_FIELDS}
