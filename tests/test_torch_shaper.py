"""The port's shaping policies and safeguard against the JAX reference:
decisions are discrete, so they must be equal exactly."""
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.core import shaper as rshaper
from repro_torch.core import shaper as tshaper

FIELDS = ("kill_app", "kill_comp", "alloc_cpu", "alloc_mem", "cpu_free", "mem_free")


def _problem(seed, A=24, C=6, H=5):
    """A random over-committed cluster: about 80% of the app slots live,
    1-3 core components per app, components placed on random hosts, ages
    drawn from a few values (so components tie), and app_order holding
    the live apps in a random order followed by -1 padding."""
    rng = np.random.default_rng(seed)
    app_exists = rng.random(A) < 0.8
    n_comp = rng.integers(1, C + 1, A)
    n_core = np.minimum(rng.integers(1, 4, A), n_comp)
    idx = np.arange(C)[None, :]
    comp_exists = (idx < n_comp[:, None]) & app_exists[:, None]
    comp_core = (idx < n_core[:, None]) & app_exists[:, None]
    live = np.flatnonzero(app_exists)
    order = np.full(A, -1, np.int64)
    order[:live.size] = rng.permutation(live)
    if seed % 3 == 2:     # a dead app and a gap inside the order
        order[1] = np.flatnonzero(~app_exists)[0] if (~app_exists).any() else -1
        order[3] = -1
    return dict(
        host_cpu=rng.uniform(6.0, 12.0, H).astype(np.float32),
        host_mem=rng.uniform(20.0, 48.0, H).astype(np.float32),
        app_exists=app_exists,
        app_order=order,
        comp_exists=comp_exists,
        comp_core=comp_core,
        comp_host=np.where(comp_exists, rng.integers(0, H, (A, C)), 0).astype(np.int32),
        comp_cpu=np.where(comp_exists, rng.uniform(0.25, 2.0, (A, C)), 0).astype(np.float32),
        comp_mem=np.where(comp_exists, rng.uniform(0.5, 8.0, (A, C)), 0).astype(np.float32),
        comp_alive=(60.0 * rng.integers(0, 4, (A, C))).astype(np.float32),
    )


def _ref(p):
    return rshaper.ShapeProblem(**{k: jnp.asarray(v) for k, v in p.items()})


def _port(p):
    dtypes = {"app_order": torch.int64, "comp_host": torch.int64}
    return tshaper.ShapeProblem(**{k: torch.as_tensor(v, dtype=dtypes.get(k))
                                   for k, v in p.items()})


@pytest.mark.parametrize("policy", ["pessimistic", "optimistic", "baseline"])
@pytest.mark.parametrize("seed", range(8))
def test_policy_decisions_equal_reference(policy, seed):
    p = _problem(seed)
    want = rshaper.POLICIES[policy](_ref(p))
    got = tshaper.POLICIES[policy](_port(p))
    for f in FIELDS:
        np.testing.assert_array_equal(getattr(got, f).numpy(),
                                      np.asarray(getattr(want, f)), err_msg=f)


def test_fixtures_exercise_every_decision():
    kills = np.zeros(3, int)
    for seed in range(8):
        d = tshaper.pessimistic_shape(_port(_problem(seed)))
        o = tshaper.optimistic_shape(_port(_problem(seed)))
        kills += [int(d.kill_app.sum()), int(d.kill_comp.sum()), int(o.kill_app.sum())]
    assert (kills > 0).all(), kills


@pytest.mark.parametrize("k1,k2", [(0.05, 3.0), (0.0, 0.0), (0.25, 1.0)])
def test_shaped_demand_equals_reference(k1, k2):
    rng = np.random.default_rng(7)
    peak = rng.uniform(-1.0, 6.0, (64, 8)).astype(np.float32)
    req = rng.uniform(0.5, 5.0, (64, 8)).astype(np.float32)
    var = rng.uniform(-1e-3, 2.0, (64, 8)).astype(np.float32)
    want = rshaper.shaped_demand(peak, req, var, rshaper.SafeguardConfig(k1, k2))
    got = tshaper.shaped_demand(*map(torch.as_tensor, (peak, req, var)),
                                tshaper.SafeguardConfig(k1, k2))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def _beta_cases():
    """(request, var, k1, k2) on which one rounding of k1 * request + the
    dynamic term differs from two: the counterexample (1+2**-12)**2 +
    2**-80; requests whose product with k1 lands on a float32 midpoint
    (25 bits), with a dynamic term of +-2**-60 far below it, the float32
    below the midpoint even and odd; and seeded random inputs, also at
    k1 = 1."""
    one = float(np.float32(1 + 2**-12))
    yield "counterexample", (np.array([one], np.float32), np.array([2.0**-80], np.float32),
                             one, 2.0**-40)
    k1 = float(np.float32(1 + 1365 * 2.0**-12))
    req = (1 + np.arange(0, 2**11) * 2.0**-11).astype(np.float32)
    q = req.astype(np.float64) * k1
    q = q * np.where(q < 2, 2.0**24, 2.0**23)
    mid = (q == np.floor(q)) & (q % 2 == 1)
    lower_odd = (q - 1) / 2 % 2 == 1
    var = np.full(req.shape, 2.0**-60, np.float32)     # sigma 2**-30
    for odd in (False, True):
        sel = mid & (lower_odd == odd)
        for k2 in (2.0**-30, -(2.0**-30)):
            yield f"midpoint lower_odd={odd} k2={k2:+.0e}", (req[sel], var[sel], k1, k2)
    rng = np.random.default_rng(11)
    yield "random", (rng.uniform(0.01, 64.0, 100_000).astype(np.float32),
                     rng.uniform(-1e-3, 4.0, 100_000).astype(np.float32),
                     float(rng.uniform(0, 1)), float(rng.uniform(0, 4)))
    # k1 = 1: XLA drops the multiplication and contracts k2 * sigma + request
    yield "random k1=1", (rng.uniform(0.01, 64.0, 100_000).astype(np.float32),
                          rng.uniform(-1e-3, 4.0, 100_000).astype(np.float32), 1.0, 3.0)


@pytest.mark.parametrize("case", [name for name, _ in _beta_cases()])
def test_beta_rounds_once_as_reference(case):
    """Eq. 9's beta against the jitted reference bit for bit, where XLA
    contracts k1 * request + k2 * sigma into one fused multiply-add."""
    import jax

    req, var, k1, k2 = dict(_beta_cases())[case]
    assert req.size > 0
    want = jax.jit(lambda r, v: rshaper.beta(r, v, rshaper.SafeguardConfig(k1, k2)))(req, var)
    got = tshaper.beta(torch.as_tensor(req), torch.as_tensor(var),
                       tshaper.SafeguardConfig(k1, k2))
    np.testing.assert_array_equal(got.numpy().view(np.int32),
                                  np.asarray(want).view(np.int32))
    if case == "counterexample":
        assert float(got[0]).hex() == "0x1.0020020000000p+0"
