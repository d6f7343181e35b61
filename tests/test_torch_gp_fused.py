"""The GP's fused per-series program (``ops.gp_fit_forecast``): the
closed-form gradient its CUDA kernel computes, written out in PyTorch
(``ref.gp_evidence_grad``), against autograd of the loss the reference
differentiates with ``jax.grad``; dispatch and the kernel wrapper's
checks on the CPU; and, on the card only (``-m gpu``), the kernel against
its plain version.

Inputs are made with numpy from a seed.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core.forecast import gp as rgp
from repro_torch.core.forecast import GPConfig, GPForecaster
from repro_torch.core.forecast import gp as tgp
from repro_torch.kernels import gp_forecast, ops, ref
from test_torch_flash_route import CudaStandIn

N, D = 10, 11          # the default simulation's GP: h = 10 patterns of 11


def _masks(kind: str, b: int, rng) -> np.ndarray:
    """(b, N) pattern-row masks: a suffix (as a young series' windows give),
    rows valid in no prefix or suffix, none valid (a padded bucket row), or
    all valid."""
    if kind == "suffix":
        first = rng.integers(0, N, b)
        return np.arange(N)[None, :] >= first[:, None]
    if kind == "scattered":
        m = rng.random((b, N)) < 0.6
        m[:, 0], m[:, 1] = True, False          # never a prefix or a suffix
        return m
    if kind == "none":
        return np.zeros((b, N), bool)
    return np.ones((b, N), bool)


def _problem(b, seed):
    rng = np.random.default_rng(seed)
    X = rng.standard_normal((b, N, D)).astype(np.float32)
    y = rng.standard_normal((b, N)).astype(np.float32)
    lp = rng.uniform(-1.5, 1.0, (b, 3)).astype(np.float32)
    return rng, torch.as_tensor(X), torch.as_tensor(y), torch.as_tensor(lp)


def _autograd(lp, X, y, valid, cfg):
    p = lp.clone().requires_grad_(True)
    (g,) = torch.autograd.grad(ref.gp_neg_log_marginal(p, X, y, valid, cfg).sum(), p)
    return g


@pytest.mark.parametrize("mask", ["suffix", "scattered", "none", "all"])
@pytest.mark.parametrize("kind", ["exp", "rbf"])
def test_closed_form_gradient_matches_autograd(kind, mask):
    rng, X, y, lp = _problem(16, seed=len(mask) + 7 * len(kind))
    valid = torch.as_tensor(_masks(mask, 16, rng))
    cfg = GPConfig(kernel=kind)
    got = ref.gp_evidence_grad(lp, X, y, valid, cfg)
    want = _autograd(lp, X, y, valid, cfg)
    assert torch.isfinite(want).all()
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("kind", ["exp", "rbf"])
def test_closed_form_gradient_of_a_non_pd_factor(kind):
    """A factor that is not positive definite: both gradients are NaN or
    zero in each entry, so the step that zeroes non-finite entries leaves
    the parameters as autograd's would; the other rows are untouched."""
    rng, X, y, lp = _problem(6, seed=3)
    valid = torch.as_tensor(_masks("suffix", 6, rng))
    valid[2] = True
    X[2, 4, 3] = float("nan")                    # NaN Gram row: no factor
    cfg = GPConfig(kernel=kind)
    got = ref.gp_evidence_grad(lp, X, y, valid, cfg)
    want = _autograd(lp, X, y, valid, cfg)
    assert not torch.isfinite(got[2]).any()
    zero = torch.where(torch.isfinite(want[2]), want[2], 0.0)
    assert torch.equal(zero, torch.zeros(3))
    keep = [0, 1, 3, 4, 5]
    torch.testing.assert_close(got[keep], want[keep], rtol=1e-4,
                               atol=1e-4 * want[keep].abs().max().item())
    # a negative jitter: the factors with sf^2 + sn^2 < 5 on a valid row
    # fail; after the zeroing both gradients agree everywhere
    cfg = GPConfig(kernel=kind, jitter=-5.0)
    got = ref.gp_evidence_grad(lp, X, y, valid, cfg)
    want = _autograd(lp, X, y, valid, cfg)
    failed = ~torch.isfinite(got).any(1)
    assert failed.sum() >= 3
    got, want = (torch.where(torch.isfinite(g), g, 0.0) for g in (got, want))
    assert torch.equal(want[failed], torch.zeros(int(failed.sum()), 3))
    torch.testing.assert_close(got, want, rtol=1e-4, atol=1e-4 * want.abs().max().item())


@pytest.mark.parametrize("kind", ["exp", "rbf"])
def test_closed_form_gradient_matches_jax(kind):
    """The same gradient against jax.grad of the reference's loss, one
    series at a time, with the Gram matrix's noisy diagonal avoided by
    taking X's rows far apart (the reference's diagonal then agrees)."""
    rng, X, y, lp = _problem(4, seed=11)
    X = X * 4.0
    valid = torch.as_tensor(_masks("scattered", 4, rng))
    got = ref.gp_evidence_grad(lp, X, y, valid, GPConfig(kernel=kind)).numpy()
    for i in range(4):
        want = jax.grad(rgp._neg_log_marginal)(
            jnp.asarray(lp[i].numpy()), jnp.asarray(X[i].numpy()), jnp.asarray(y[i].numpy()),
            jnp.asarray(valid[i].numpy()), kind, 1e-5, "jnp")
        np.testing.assert_allclose(got[i], np.asarray(want), rtol=2e-3,
                                   atol=2e-3 * np.abs(want).max())


def test_ops_dispatch_runs_the_plain_program_on_the_cpu():
    rng = np.random.default_rng(5)
    w = rng.uniform(0.5, 2.0, (8, 24)).astype(np.float32)
    cfg = GPConfig(history=10, max_patterns=10, opt_steps=4)
    wt, vt = torch.as_tensor(w), torch.ones((8, 24), dtype=torch.bool)
    X, y, rv, hist, _, _ = tgp.fit_inputs(wt, vt, cfg)
    got = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    want = ref.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    for g, r in zip(got, want):
        assert torch.equal(g, r)
    assert [tuple(t.shape) for t in got] == [(8, 3), (8, 3), (8, 3)]
    with pytest.raises(ValueError, match="device"):
        ops.gp_fit_forecast(X.to("meta"), y.to("meta"), rv.to("meta"),
                            hist.to("meta"), 24, 3, cfg)


# ready masks of a cohort of three members with 8 series each, as the
# device engine builds them: none, some (a different pattern per member)
# and all ready
READY_MASKS = {"none": [0] * 24,
               "some": [1, 0, 0, 1, 1, 0, 0, 0] + [0] * 8 + [1, 1, 1, 0, 1, 1, 1, 1],
               "all": [1] * 24}


@pytest.mark.parametrize("mask", list(READY_MASKS.values()), ids=list(READY_MASKS))
def test_ready_mask_runs_only_the_marked_series(mask):
    """A ready mask on the CPU: the series it marks equal the program
    without a mask bit for bit, in ``ops.gp_fit_forecast`` (where every
    other series comes back zeros, as the kernel writes them) and in
    ``forecast_batch``."""
    rng = np.random.default_rng(11)
    w = rng.uniform(0.5, 2.0, (24, 24)).astype(np.float32)
    v = np.ones((24, 24), bool)
    v[::5, :12] = False
    cfg = GPConfig(history=10, max_patterns=10, opt_steps=3)
    run = torch.tensor(mask, dtype=torch.bool)
    X, y, rv, hist, _, _ = tgp.fit_inputs(torch.as_tensor(w), torch.as_tensor(v), cfg)
    full = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    got = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg, ready=run)
    gp = GPForecaster(cfg)
    fc_full = gp.forecast_batch(w, 3, valid=v, device="cpu")
    fc = gp.forecast_batch(w, 3, valid=v, ready=run, device="cpu")
    for g, f in zip(got, full):
        assert torch.equal(g[run], f[run]) and not g[~run].any()
    for g, f in ((fc.mean, fc_full.mean), (fc.var, fc_full.var)):
        assert torch.equal(g[run], f[run])


def test_wrapper_check_takes_a_ready_mask():
    a = _stand_ins()
    args = (a["X"], a["y"], a["row_valid"], a["hist"], 24, 3, GPConfig())
    assert gp_forecast._check(*args, CudaStandIn((512,), torch.bool)) == (512, N, D, 0)
    with pytest.raises(ValueError, match="shape"):
        gp_forecast._check(*args, CudaStandIn((511,), torch.bool))
    with pytest.raises(TypeError, match="bool"):
        gp_forecast._check(*args, CudaStandIn((512,), torch.int32))
    with pytest.raises(ValueError, match="on cpu"):
        gp_forecast._check(*args, CudaStandIn((512,), torch.bool, device="cpu"))


def test_forecast_batch_refuses_cuda_without_a_card(monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="no CUDA device"):
        GPForecaster(GPConfig(opt_steps=2)).forecast_batch(
            np.ones((2, 24), np.float32), 3, device="cuda")


def _stand_ins(b=512, n=N, d=D, **over):
    shapes = {"X": (b, n, d), "y": (b, n), "row_valid": (b, n), "hist": (b, d - 1)}
    out = {k: CudaStandIn(s, torch.bool if k == "row_valid" else torch.float32)
           for k, s in shapes.items()}
    out.update(over)
    return out


@pytest.mark.parametrize("n,d", [(10, 11), (1, 2), (20, 21), (40, 41), (64, 128)])
def test_wrapper_check_takes_every_documented_size(n, d):
    a = _stand_ins(n=n, d=d)
    got = gp_forecast._check(a["X"], a["y"], a["row_valid"], a["hist"], 24, 3,
                             GPConfig(history=d - 1, max_patterns=n))
    assert got == (512, n, d, 0)


@pytest.mark.parametrize("over,cfg,err,match", [
    ({"X": CudaStandIn((512, N, D), torch.float32, device="cpu")}, {}, ValueError, "CUDA"),
    ({"y": CudaStandIn((512, N), torch.float64)}, {}, TypeError, "float32"),
    ({"row_valid": CudaStandIn((512, N), torch.float32)}, {}, TypeError, "bool"),
    ({"hist": CudaStandIn((512, D - 1), torch.float32, contiguous=False)}, {}, ValueError,
      "contiguous"),
    ({"hist": CudaStandIn((512, D), torch.float32)}, {}, ValueError, "hist"),
    ({"X": CudaStandIn((512, 65, D), torch.float32), "y": CudaStandIn((512, 65), torch.float32),
      "row_valid": CudaStandIn((512, 65), torch.bool)}, {}, ValueError, "N=65"),
    ({}, {"opt_steps": 257}, ValueError, "opt_steps"),
    ({}, {"kernel": "matern"}, ValueError, "kind"),
])
def test_wrapper_check_refuses_what_the_kernel_cannot_take(over, cfg, err, match):
    a = _stand_ins(**over)
    with pytest.raises(err, match=match):
        gp_forecast._check(a["X"], a["y"], a["row_valid"], a["hist"], 24, 3,
                           GPConfig(**cfg))


def test_wrapper_refuses_cpu_tensors_before_building():
    x = torch.zeros((2, N, D))
    with pytest.raises(ValueError, match="CUDA"):
        gp_forecast.gp_fit_forecast(x, x[:, :, 0], x[:, :, 0] > 0, x[:, 0, 1:], 24, 3,
                                    GPConfig())
    assert gp_forecast._LIB is None and gp_forecast.gp_fit_forecast.launches == 0


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    return torch.device("cuda")


def _windows(b, seed):
    """Usage-like windows with 10..24 valid samples, and two all-invalid
    padded rows."""
    rng = np.random.default_rng(seed)
    level = rng.uniform(0.1, 8.0, (b, 1))
    w = np.clip(level * (1 + 0.08 * np.cumsum(rng.standard_normal((b, 24)), 1)), 0, None)
    count = rng.integers(10, 25, b)
    v = np.arange(24)[None, :] >= (24 - count)[:, None]
    v[-2:] = False
    return np.where(v, w, 0).astype(np.float32), v


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("b", [1, 64, 512])
def test_cuda_gp_program_matches_plain(cuda, kind, b):
    w, v = _windows(max(b, 3), seed=b)
    w, v = w[:b], v[:b]
    cfg = GPConfig(history=10, max_patterns=10, opt_steps=10, kernel=kind)
    wt, vt = torch.as_tensor(w, device=cuda), torch.as_tensor(v, device=cuda)
    X, y, rv, hist, mu, sd = tgp.fit_inputs(wt, vt, cfg)
    n0 = gp_forecast.gp_fit_forecast.launches
    got = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    torch.cuda.synchronize()
    assert gp_forecast.gp_fit_forecast.launches == n0 + 1
    want = ref.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    fg, fc = (tgp.finish(m, s, wt, vt, mu, sd, cfg) for m, s, _ in (got, want))
    cnt = v.sum(1)
    rich = torch.as_tensor(cnt >= 12, device=cuda)
    if rich.any():
        torch.testing.assert_close(fg.mean[rich], fc.mean[rich], rtol=1e-3, atol=0)
        torch.testing.assert_close(fg.var[rich], fc.var[rich], rtol=5e-3, atol=1e-9)
    few = torch.as_tensor(cnt <= 10, device=cuda)
    assert torch.equal(fg.mean[few], fc.mean[few]) and torch.equal(fg.var[few], fc.var[few])
    assert torch.isfinite(got[0]).all() and torch.isfinite(got[1]).all()


@pytest.mark.gpu
def test_cuda_gp_program_with_a_ready_mask_matches_itself_and_plain(cuda):
    """A ready mask on the card (none, some, all per member of a cohort of
    three 192-series members): the kernel's marked series are its own
    results without a mask, bit for bit (a warp computes its series
    alone), the others zeros; and it agrees with the plain version with
    the same mask as the full batch does."""
    w, v = _windows(576, seed=3)
    cfg = GPConfig(history=10, max_patterns=10, opt_steps=10)
    wt, vt = torch.as_tensor(w, device=cuda), torch.as_tensor(v, device=cuda)
    X, y, rv, hist, mu, sd = tgp.fit_inputs(wt, vt, cfg)
    full = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    rng = np.random.default_rng(5)
    for what, mask in (("none", np.zeros(576, bool)), ("all", np.ones(576, bool)),
                       ("some", np.concatenate([rng.random(192) < 0.3, np.zeros(192, bool),
                                                rng.random(192) < 0.9]))):
        run = torch.as_tensor(mask, device=cuda)
        n0 = gp_forecast.gp_fit_forecast.launches
        got = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg, ready=run)
        torch.cuda.synchronize()
        assert gp_forecast.gp_fit_forecast.launches == n0 + 1
        want = ref.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg, ready=run)
        for g, f, p in zip(got, full, want):
            assert torch.equal(g[run].view(torch.int32), f[run].view(torch.int32)), what
            assert not g[~run].any(), what
            assert not p[~run].any(), what
        fg, fc = (tgp.finish(m, s, wt, vt, mu, sd, cfg) for m, s, _ in (got, want))
        rich = run & torch.as_tensor(v.sum(1) >= 12, device=cuda)
        if rich.any():
            torch.testing.assert_close(fg.mean[rich], fc.mean[rich], rtol=1e-3, atol=0)
            torch.testing.assert_close(fg.var[rich], fc.var[rich], rtol=5e-3, atol=1e-9)


@pytest.mark.gpu
def test_cuda_gp_program_keeps_a_failed_factor_nan(cuda):
    w, v = _windows(8, seed=2)
    v[:6] = True
    cfg = GPConfig(history=10, max_patterns=10, opt_steps=3)
    wt, vt = torch.as_tensor(w, device=cuda), torch.as_tensor(v, device=cuda)
    X, y, rv, hist, _, _ = tgp.fit_inputs(wt, vt, cfg)
    X = X.clone()
    X[1, 4, 3] = float("nan")
    got = ops.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    want = ref.gp_fit_forecast(X, y, rv, hist, 24, 3, cfg)
    assert torch.isnan(got[0][1]).all() and torch.isnan(want[0][1]).all()
    # its parameters never move: every gradient entry was non-finite
    torch.testing.assert_close(got[2][1], want[2][1], rtol=0, atol=0)
    keep = [0, 2, 3, 4, 5]
    torch.testing.assert_close(got[0][keep], want[0][keep], rtol=1e-3, atol=1e-5)
