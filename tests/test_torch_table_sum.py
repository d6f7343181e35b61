"""``ref.xla_table_sum``, the order in which the reference's compiled tick
sums an (A, C, 2) slot table over its slots and components (the rings'
usage and shaped-demand sums, ``repro/sim/step.py:822,892``), against
XLA:CPU's compiled ``x.sum((0, 1))`` on the same table, bit for bit.

A standalone ``jax.jit(lambda x: x.sum((0, 1)))`` compiles to the fused
tick's own kernels for these sums (the same HLO, reduce-window and
reduce, and the same LLVM IR after optimisation, compared in the dumps
``XLA_FLAGS=--xla_dump_to=DIR`` gives), so each shape costs one small
compile.  The order is the host's: LLVM's loop vectoriser chooses lanes
and the register allocator the operands' order by the target, which is
the host CPU (the IR's function attributes name only
``"prefer-vector-width"="256"``).  Read on x86-64 with fma, avx2,
avx512f, avx512dq, avx512cd, avx512bw, avx512vl, avx512vbmi,
avx512_vnni, avx512_bf16 and avx512_fp16 (an Intel Xeon), jax 0.9.0;
on another host the reference may sum in another order.  The shapes: A of 20, 37, 64, 128 and 256 slots (one
window, two off the 32-slot grid, whole windows) by C of 1, 2, 3, 4, 5,
12 and 32 components: serial windows, 8 and 4 vector lanes
(``ref.xla_table_plan``).  The tables (``chip_smoke.crafted_tables``):
mixed magnitudes, -0 in slot 0 and everywhere, NaNs of two quiet and two
signalling payloads and +-inf at three densities, values near 2^-126,
a signalling NaN first.
"""
import jax
import numpy as np
import pytest
from chip_smoke import crafted_tables

from repro_torch.kernels import obs, ref

SLOTS = (20, 37, 64, 128, 256)
COMPONENTS = (1, 2, 3, 4, 5, 12, 32)
_SUM = jax.jit(lambda x: x.sum((0, 1)))


@pytest.mark.parametrize("C", COMPONENTS)
@pytest.mark.parametrize("A", SLOTS)
def test_table_sum_equals_compiled_sum(A, C):
    for k, table in enumerate(crafted_tables(A, C)):
        want = np.asarray(_SUM(table)).view(np.uint32)
        got = ref.xla_table_sum(table).view(np.uint32)
        np.testing.assert_array_equal(got, want, err_msg=f"table {k}, plan "
                                      f"{ref.xla_table_plan(A, C)}")


def test_table_plan_covers_the_engines_range():
    """Every (A, C) the obs_tick kernel takes (A <= 1,024, C <= 32) has a
    plan: serial, or lanes that the lane orders know."""
    for A in range(1, 1025):
        for C in range(1, 33):
            vf, unrolled = ref.xla_table_plan(A, C)
            assert vf == 0 or (vf, C) in ref.XLA_LANE_ORDER, (A, C)
            assert not unrolled or (C == 2 and A == vf)


@pytest.mark.parametrize("A,C,order", [
    (128, 12, 0), (37, 3, 0), (128, 3, 8 | 1 << 5 | 0b111 << 8), (64, 2, 8),
    (20, 4, 4 | 0b0111 << 8), (95, 3, 4 | 0b010 << 8), (8, 2, 8 | 1 << 4), (1, 1, 0)],
    ids=lambda v: str(v))
def test_obs_kernel_order_packs_the_plan(A, C, order):
    """The ``order`` the obs_tick wrapper passes the kernel: the plan's
    lanes, the unrolled loop, the tree's higher lane first and the data
    first by component, packed as ``csrc/obs.cu`` reads them."""
    assert obs.table_order(A, C) == order
