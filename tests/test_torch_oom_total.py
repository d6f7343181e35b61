"""The OOM handler's per-host memory total in XLA:CPU's compiled order.

The reference sums ``jnp.where(on_h, mem, 0.0).sum()`` over the (A, C)
slot table at every step of its victim loop (``repro/sim/step.py:502``).
XLA:CPU reduces it in windows of 32 whole slots (one reduce fused with
the select at A <= 32) whose kernels LLVM vectorises across the slots
at C of 2 to 8 for some A (``ref.xla_slot_plan``).  ``ref.xla_slot_sum``
is held to the jitted total, which compiles to the handler's own kernel,
on tables that show the order, and ``ref.resolve_oom`` to the reference's
jitted ``_resolve_oom`` on ``chip_smoke.oom_total_table``'s crafted
states (``OOM_TOTAL_SHAPES``): host 0's total within an ulp or two of its
capacity + 1e-6, where the shape's lanes (C = 3 at A = 128 among them)
and the serial order decide the first kill differently.  The CUDA kernel
takes the same plan; on the card ``chip_smoke.py`` phase 3 holds it to
the plain version on these states.
"""
from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from chip_smoke import OOM_TOTAL_CAP, OOM_TOTAL_SHAPES, _parent_slot_sum, oom_total_table
from repro.sim import state as rstate
from repro.sim import step as rstep
from repro_torch.kernels import ops, ref

# the handler's total as a standalone program: it compiles to the
# handler's own kernel (the select fused into the reduce over A <= 32,
# a reduce-window over its output above)
_TOTAL = jax.jit(lambda usage, run, host, h:
                 jnp.where(run & (host == h), usage[:, :, 1], 0.0).sum())


def _tables(A, C, seed=0):
    """(usage, running, host) of mixed magnitudes, some components off
    host 0 or not running."""
    rng = np.random.default_rng(seed * 1000 + A * 40 + C)
    for _ in range(6):
        u = (rng.uniform(0, 1, (A, C, 2)) * 2.0 ** rng.integers(-12, 12, (A, C, 2))
             ).astype(np.float32)
        yield u, rng.random((A, C)) >= 0.3, (rng.random((A, C)) < 0.2).astype(np.int32)


@pytest.mark.parametrize("A", [2, 4, 8, 16, 20, 24, 28, 29, 32, 37, 63, 95, 128, 160])
def test_slot_sum_equals_the_compiled_sum(A):
    for C in (1, 2, 3, 4, 5, 6, 7, 8, 9, 12):
        for u, run, host in _tables(A, C):
            want = np.asarray(_TOTAL(u, run, host, jnp.int32(0)))
            got = ref.xla_slot_sum(np.where(run & (host == 0), u[..., 1], np.float32(0)))
            assert got == want, (A, C, ref.xla_slot_plan(A, C))


def test_slot_plan_reads_the_dump():
    # the plans read from the dumped kernels (jax 0.9.0, AVX-512)
    assert ref.xla_slot_plan(128, 3) == (8, 0)
    assert ref.xla_slot_plan(128, 12) == (0, 0)
    assert ref.xla_slot_plan(127, 3) == (4, 1)
    assert ref.xla_slot_plan(16, 4) == (8, 1)
    assert ref.xla_slot_plan(20, 4) == (4, 1)
    assert ref.xla_slot_plan(20, 6) == (4, 0)
    assert ref.xla_slot_plan(4, 3) == (4, 0)
    assert ref.xla_slot_plan(50, 3) == (0, 0)


def _reference(args):
    """The reference's (trace, state, usage, host_cap) of resolve_oom's
    arguments (one member)."""
    (slot_gid, work_done, run, host, alloc, usage, failed, queued, oom, fail, part,
     is_core, cap) = (np.asarray(a[0]) if a.dim() and a is not args[-1] else np.asarray(a)
                      for a in args)
    N, C = is_core.shape
    A = slot_gid.shape[0]
    f32 = jnp.float32
    tr = rstate.DeviceTrace(
        submit=jnp.zeros(N, f32), runtime=jnp.ones(N, f32), cpu_req=jnp.ones((N, C), f32),
        mem_req=jnp.ones((N, C), f32), is_core=jnp.asarray(is_core),
        is_jumpy=jnp.zeros(N, bool), levels=jnp.zeros((N, C, 4, 2), f32),
        exists=jnp.ones((N, C), bool), tenant=jnp.zeros(N, jnp.int32),
        gid=jnp.arange(N, dtype=jnp.int32))
    z = jnp.zeros
    st = rstate.SimState(
        slot_gid=jnp.asarray(slot_gid), work_done=jnp.asarray(work_done),
        comp_running=jnp.asarray(run), comp_host=jnp.asarray(host), alloc=jnp.asarray(alloc),
        alive_since=z((A, C), f32), mon_buf=z((A * C, 4, 2), f32),
        mon_count=z(A * C, jnp.int32), arrived=jnp.ones(N, bool), queued=jnp.asarray(queued),
        done=z(N, bool), failed=jnp.asarray(failed), finish_t=z(N, f32),
        saved_work=z(N, f32), has_saved=z(N, bool), t=jnp.float32(60.0),
        failure_events=jnp.int32(fail), oom_kills=jnp.int32(oom),
        full_preemptions=jnp.int32(0), partial_preemptions=jnp.int32(part),
        calib=None, tenancy=None, obs=None)
    return tr, st, jnp.asarray(usage), jnp.asarray(cap)


@pytest.mark.parametrize("A,C", OOM_TOTAL_SHAPES)
def test_crafted_total_equals_the_reference(A, C):
    args = oom_total_table(C, A=A)
    mem = args[5][0, ..., 1].numpy()
    lim = np.float32(OOM_TOTAL_CAP) + np.float32(1e-6)
    assert ref.xla_sum(mem.reshape(-1, 1))[0] > lim            # the host is over at entry
    if ref.xla_slot_plan(A, C)[0]:
        # the serial order and the compiled lanes disagree on the first kill
        assert (_parent_slot_sum(mem) > lim) != (ref.xla_slot_sum(mem) > lim)
    want_st, want_usage, want_reset = jax.jit(rstep._resolve_oom)(*_reference(args))
    got = ops.resolve_oom(*args)
    want = (want_st.slot_gid, want_st.work_done, want_st.comp_running, want_st.alloc,
            want_usage, want_st.failed, want_st.queued, want_st.oom_kills,
            want_st.failure_events, want_st.partial_preemptions, want_reset)
    names = ("slot_gid", "work_done", "comp_running", "alloc", "usage", "failed", "queued",
             "oom_kills", "failure_events", "partial_preemptions", "monreset")
    for name, g, w in zip(names, got, want):
        np.testing.assert_array_equal(g[0].numpy(), np.asarray(w), err_msg=name)
