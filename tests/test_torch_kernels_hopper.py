"""The redesigned ``arima_forecast``, ``conformal_scale``, ``calib_observe``
and ``calib_begin`` kernels against their plain versions on the card, bit
for bit, on the crafted cases that ``chip_smoke.py`` phase 3 also runs:
ARIMA windows where an order that is not fitted wins the AIC, where the
fitted order wins, valid counts at the fallback's edge, holes, constant and
signed-zero windows, every and no row ready, other orders and 40-sample
windows; score rings with ties, -0 beside +0, NaNs of four payloads and
infinities, k at 0 and at n - 1, young rows, rolled and circular rings at
capacities 16 to 2,048 (the warp's and the block's selections), and the
engine's launch with the per-tenant tier; and calibration steps
(CALIB_CRAFTED) of 200 and 3,000 rows, every row or none resolving, more
than the pool and a group ring hold, NaN, -0 and +-inf among the scores
and the deployed scales, an inactive member, 1 and 127 groups, and group
and tenant ids out of range, two NaN payloads in a max and in an add,
without the tier and with it; the control plane's and the rings' ticks
(CONTROL_CRAFTED, OBS_CRAFTED): signed zeros, NaN and +-inf and values
near 2^-126 in the tables, tenant ids out of range, 1 to 1,024 tenants,
slot tables off XLA's 32-slot windows, an idle or inactive member and a
ring cursor that wraps; the rings' usage and demand tables of
``chip_smoke.crafted_tables`` at TABLE_SHAPES, whose sums take each of
XLA:CPU's orders (serial windows, 8 and 4 vector lanes, the unrolled
loop) with NaNs of four payloads, signed zeros and values near 2^-126;
and ``leap_skip`` on the crafted clocks of ``chip_smoke.leap_clocks``
(binade edges, half-ulp ties, t + tick == t, t = 0, subnormal and
negative clocks, budgets to 20,000) and the seeded members.

Every test needs a CUDA device and skips without one; the file imports
no JAX.  Run on the card with ``python -m pytest -m gpu
tests/test_torch_kernels_hopper.py``.
"""
import numpy as np
import pytest
import torch

from chip_smoke import (ARIMA_CRAFTED, CALIB_CRAFTED, CONTROL_CRAFTED, LEAP_DTYPES,
                        OBS_CRAFTED, SCALE_CRAFTED, TABLE_SHAPES, arima_crafted,
                        calib_crafted_outputs, control_crafted, crafted_rings, leap_cases,
                        obs_crafted, obs_table_case, scale_crafted_quantiles)
from repro_torch.core.forecast import ARIMAConfig
from repro_torch.core.uncertainty import CalibrationConfig
from repro_torch.kernels import arima_forecast as karima
from repro_torch.kernels import calib, control, ref
from repro_torch.kernels import leap as kleap
from repro_torch.kernels import obs as kobs

H = 3


def _card():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")


def _bits(x: torch.Tensor) -> np.ndarray:
    return x.detach().cpu().contiguous().view(torch.int32).numpy()


@pytest.mark.gpu
@pytest.mark.parametrize("name", list(ARIMA_CRAFTED))
def test_arima_kernel_equals_plain_on_crafted_windows(name):
    _card()
    w, v, ready = arima_crafted(name)
    cfg = ARIMAConfig(**ARIMA_CRAFTED[name])
    tw, tv = torch.as_tensor(w).cuda(), torch.as_tensor(v).cuda()
    mask = None if ready is None else torch.as_tensor(ready).cuda()
    got = karima.arima_forecast(tw, tv, H, cfg, mask)
    want = ref.arima_forecast(tw, tv, H, cfg, mask)
    for g, r in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(r))


@pytest.mark.gpu
@pytest.mark.parametrize("circular", [True, False], ids=["circular", "rolled"])
@pytest.mark.parametrize("cap,rows", SCALE_CRAFTED, ids=[f"cap{c}" for c, _ in SCALE_CRAFTED])
def test_conformal_scale_equals_plain_on_crafted_rings(cap, rows, circular):
    _card()
    scores, counts, q = crafted_rings(cap + circular, rows, cap, circular=circular)
    for qg in (q, q[::4]):                     # a q per row, and per four rows
        args = [torch.as_tensor(x) for x in (scores, counts, qg, -qg)]
        want = ref.conformal_scale(*args, rolled=not circular)
        got = calib.conformal_scale(*(a.cuda() for a in args), rolled=not circular)
        np.testing.assert_array_equal(_bits(got), _bits(want))


@pytest.mark.gpu
def test_engine_quantiles_with_tier_equal_plain_on_crafted_rings():
    """The series rings, the pool and the group rings in one launch, each
    group ring and each series row of a tenant's slot at the tenant's
    credit-moved q; compared where the engine's step reads them."""
    _card()
    args, min_scores = scale_crafted_quantiles()
    kw = dict(min_scores=min_scores, pool_on=True)
    want = ref.calib_quantiles(*args, **kw)
    to = lambda a: a.cuda() if isinstance(a, torch.Tensor) else a  # noqa: E731
    got = calib.calib_quantiles(*(to(a) for a in args[:-1]), tuple(to(a) for a in args[-1]),
                                **kw)
    read = (args[1] >= min_scores, torch.ones(1, dtype=torch.bool), args[-1][4] >= min_scores)
    for g, w, r in zip(got, want, read):
        np.testing.assert_array_equal(_bits(g.cpu()[r]), _bits(w[r]))


@pytest.mark.gpu
@pytest.mark.parametrize("name", CALIB_CRAFTED)
def test_calib_observe_and_begin_equal_plain_on_crafted_cases(name):
    """calib_observe and calib_scales (the quantiles, then calib_begin)
    without the per-tenant tier and with it, credit on and off: every
    output bit for bit."""
    _card()
    for what, got, want in calib_crafted_outputs(name, calib, ref, CalibrationConfig):
        np.testing.assert_array_equal(_bits(got), _bits(want), err_msg=what)


@pytest.mark.gpu
@pytest.mark.parametrize("name", CONTROL_CRAFTED)
def test_control_tick_equals_plain_on_crafted_cases(name):
    _card()
    args, kw = control_crafted(name)
    want = ref.control_tick(*args, **kw)
    got = control.control_tick(*(a.cuda() if a is not None else None for a in args), **kw)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(g.cpu().numpy().view(np.uint8), w.numpy().view(np.uint8))


@pytest.mark.gpu
@pytest.mark.parametrize("name", OBS_CRAFTED)
def test_obs_tick_equals_plain_on_crafted_cases(name):
    _card()
    args = obs_crafted(name)
    want = ref.obs_tick(**args)
    got = kobs.obs_tick(**{k: (tuple(x.cuda() for x in v) if isinstance(v, tuple)
                               else None if v is None else v.cuda()) for k, v in args.items()})
    for g, w in zip(got, want):
        assert (g is None) == (w is None)
        if g is not None:
            np.testing.assert_array_equal(_bits(g), _bits(w))


@pytest.mark.gpu
@pytest.mark.parametrize("A,C", TABLE_SHAPES, ids=[f"A{a}-C{c}" for a, c in TABLE_SHAPES])
def test_obs_tick_equals_plain_on_crafted_tables(A, C):
    _card()
    args = obs_table_case(A, C)
    want = ref.obs_tick(**args)
    got = kobs.obs_tick(**{k: (tuple(x.cuda() for x in v) if isinstance(v, tuple)
                               else None if v is None else v.cuda()) for k, v in args.items()})
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))


_LEAP = leap_cases()


@pytest.mark.gpu
@pytest.mark.parametrize("case", range(len(_LEAP)), ids=[c[0] for c in _LEAP])
def test_leap_skip_equals_plain_on_crafted_clocks(case):
    _card()
    name, cols, tick, leads = _LEAP[case]
    cpu = [torch.as_tensor(np.ascontiguousarray(a, dt)) for a, dt in zip(cols, LEAP_DTYPES)]
    want = ref.leap_skip(*cpu, tick)
    got = kleap.leap_skip(*(a.cuda() for a in cpu), tick)
    for g, w in zip(got, want):
        np.testing.assert_array_equal(_bits(g), _bits(w))
    if leads is not None:
        assert got[1].tolist() == leads
