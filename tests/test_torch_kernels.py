"""The port's Gram matrix against the JAX reference (CPU), and the CUDA
kernels (Gram, flash attention) against their plain PyTorch versions
(card only, ``-m gpu``; the flash kernel's CPU parity tests are in
``test_torch_attention.py``).

Inputs are made with numpy from a seed and handed to both frameworks.
"""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro_torch.kernels import flash_attention, gp_gram, ops, ref

# the shapes of tests/test_kernels.py::test_gram_matches_ref, then the GP's
# Gram route at h = 40, N = 128: K(X, X) and a horizon step's cross-Gram
SHAPES = [(1, 1, 1), (7, 5, 3), (10, 10, 11), (40, 40, 41), (128, 128, 128),
          (130, 60, 17), (128, 128, 41), (1, 128, 41)]
# (b, m, n, d, same) of the Gram route on the card (chip_smoke.py phase 3):
# K(X, X) (one tensor: the kernels' symmetric path) and a cross-Gram at
# LONG_GP's width, ragged tiles, D past one staged chunk, one entry, and a
# K(X, X) too large for a block a series
ROUTE_SHAPES = [(256, 128, 128, 41, True), (256, 1, 128, 41, False), (3, 130, 129, 17, False),
                (3, 130, 130, 17, True), (3, 72, 200, 200, False), (1, 1, 1, 1, False),
                (2, 200, 200, 100, True)]
# the main path's shapes: B series of (10 x 11) patterns against
# themselves (fit) and one (1 x 11) query against them (horizon steps)
MAIN_PATH = [(b, m) for b in (128, 256, 512) for m in (10, 1)]


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.device("cuda")


def _pair(m, n, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((m, d)).astype(np.float32),
            rng.standard_normal((n, d)).astype(np.float32))


def _t(x):
    return torch.as_tensor(x)[None]


def _hyper(b, seed=1):
    rng = np.random.default_rng(seed)
    return (rng.uniform(0.3, 3.0, b).astype(np.float32),
            rng.uniform(0.3, 3.0, b).astype(np.float32))


@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_gram_matches_reference(kind, m, n, d):
    xa, xb = _pair(m, n, d)
    got = ref.gram(_t(xa), _t(xb), torch.tensor([0.7]), torch.tensor([1.3]),
                   kind=kind)[0].numpy()
    want = np.asarray(jref.gram(jnp.asarray(xa), jnp.asarray(xb), 0.7, 1.3,
                                kind=kind))
    pallas = np.asarray(jops.gram(jnp.asarray(xa), jnp.asarray(xb), 0.7, 1.3,
                                  kind=kind, impl="pallas"))
    np.testing.assert_allclose(got, want, rtol=2e-5, atol=2e-6)
    np.testing.assert_allclose(got, pallas, rtol=2e-5, atol=2e-6)


@pytest.mark.parametrize("kind", ["exp", "rbf"])
def test_gram_properties(kind):
    x, _ = _pair(12, 1, 5)
    K = ops.gram(_t(x), _t(x), torch.tensor([1.0]), torch.tensor([2.0]),
                 kind=kind)[0].numpy()
    np.testing.assert_allclose(K, K.T, atol=1e-5)          # symmetry
    # diag = sf^2 within the reference's own tolerance for the identity
    np.testing.assert_allclose(np.diag(K), 4.0, rtol=3e-3)
    assert (K > 0).all() and (K <= 4.0 + 1e-4).all()


@pytest.mark.parametrize("kind", ["exp", "rbf"])
def test_gram_batched_equals_per_series(kind):
    rng = np.random.default_rng(3)
    xa = torch.as_tensor(rng.standard_normal((6, 10, 11)).astype(np.float32))
    xb = torch.as_tensor(rng.standard_normal((6, 9, 11)).astype(np.float32))
    ell, sf = map(torch.as_tensor, _hyper(6))
    K = ops.gram(xa, xb, ell, sf, kind=kind)
    for b in range(6):
        Kb = ops.gram(xa[b:b + 1], xb[b:b + 1], ell[b:b + 1], sf[b:b + 1],
                      kind=kind)
        assert torch.equal(K[b], Kb[0])


@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("m,n,d", [(10, 10, 11), (1, 10, 11), (7, 5, 3), (128, 128, 41),
                                   (1, 128, 41)])
def test_gram_grad_matches_jax(kind, m, n, d):
    """Autograd (d_ell, d_sf) of the CPU path, and the analytic form the
    backward kernel computes, against jax.grad of the reference."""
    xa, xb = _pair(m, n, d, seed=4)
    G = np.random.default_rng(5).standard_normal((m, n)).astype(np.float32)

    def loss(ell, sf):
        return jnp.sum(jnp.asarray(G) * jref.gram(jnp.asarray(xa), jnp.asarray(xb),
                                                  ell, sf, kind=kind))

    want = np.asarray(jax.grad(loss, argnums=(0, 1))(jnp.float32(0.8),
                                                    jnp.float32(1.4)))
    ell = torch.tensor([0.8], requires_grad=True)
    sf = torch.tensor([1.4], requires_grad=True)
    (ops.gram(_t(xa), _t(xb), ell, sf, kind=kind) * _t(G)).sum().backward()
    got = np.array([ell.grad[0].item(), sf.grad[0].item()])
    np.testing.assert_allclose(got, want, rtol=1e-4, atol=1e-5)
    d_ell, d_sf = ref.gram_bwd(_t(G), _t(xa), _t(xb), torch.tensor([0.8]),
                               torch.tensor([1.4]), kind=kind)
    np.testing.assert_allclose([d_ell[0].item(), d_sf[0].item()], got,
                               rtol=1e-5, atol=1e-6)


def test_wrappers_refuse_cpu_tensors_and_bad_kinds():
    x = torch.zeros((1, 2, 3))
    p = torch.ones((1,))
    with pytest.raises(ValueError, match="CUDA"):
        gp_gram.gram_fwd(x, x, p, p)
    with pytest.raises(ValueError, match="kind"):
        ref.gram(x, x, p, p, kind="matern")
    with pytest.raises(ValueError, match="device"):
        ops.gram(x.to("meta"), x.to("meta"), p, p)


# ----------------------------------------------------------------------
# on the card
# ----------------------------------------------------------------------

def _cuda_inputs(b, m, n, d, dev, same=False, seed=0, one=False):
    """Seeded (xa, xb, ell, sf, G); ``one`` (with same and m == n) passes
    xb itself as xa, as the Gram route does for K(X, X)."""
    rng = np.random.default_rng(seed)
    xb = rng.standard_normal((b, n, d)).astype(np.float32)
    xa = xb[:, :m] if same else rng.standard_normal((b, m, d)).astype(np.float32)
    ell, sf = _hyper(b, seed + 1)
    G = rng.standard_normal((b, m, n)).astype(np.float32)
    out = [torch.as_tensor(np.ascontiguousarray(a), device=dev)
           for a in (xa, xb, ell, sf, G)]
    if one and same and m == n:
        out[0] = out[1]
    return out


def _check_on_card(xa, xb, ell, sf, G, kind):
    n0, n1 = gp_gram.gram_fwd.launches, gp_gram.gram_bwd.launches
    K = gp_gram.gram_fwd(xa, xb, ell, sf, kind)
    d_ell, d_sf = gp_gram.gram_bwd(G, xa, xb, ell, sf, kind)
    torch.cuda.synchronize()
    assert (gp_gram.gram_fwd.launches, gp_gram.gram_bwd.launches) == (n0 + 1, n1 + 1)
    torch.testing.assert_close(K, ref.gram(xa, xb, ell, sf, kind),
                               rtol=2e-5, atol=2e-6)
    w_ell, w_sf = ref.gram_bwd(G, xa, xb, ell, sf, kind)
    # per-series sums: block reduction vs PyTorch's reduction order
    torch.testing.assert_close(d_ell, w_ell, rtol=2e-5, atol=2e-6 * G[0].numel())
    torch.testing.assert_close(d_sf, w_sf, rtol=2e-5, atol=2e-6 * G[0].numel())


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("b,m", MAIN_PATH)
def test_cuda_kernels_match_plain_on_main_path_shapes(cuda, kind, b, m):
    _check_on_card(*_cuda_inputs(b, m, 10, 11, cuda, same=True), kind)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("m,n,d", SHAPES)
def test_cuda_kernels_match_plain_on_reference_shapes(cuda, kind, m, n, d):
    _check_on_card(*_cuda_inputs(3, m, n, d, cuda), kind)


@pytest.mark.gpu
@pytest.mark.parametrize("kind", ["exp", "rbf"])
@pytest.mark.parametrize("b,m,n,d,same", ROUTE_SHAPES)
def test_cuda_kernels_match_plain_on_route_shapes(cuda, kind, b, m, n, d, same):
    """The Gram route's shapes: the kernels against their plain versions;
    each series' diagonal of K(X, X) one float (sf^2 exactly under rbf);
    two runs of the gradient equal bit for bit."""
    xa, xb, ell, sf, G = _cuda_inputs(b, m, n, d, cuda, same=same, one=True)
    _check_on_card(xa, xb, ell, sf, G, kind)
    first = gp_gram.gram_bwd(G, xa, xb, ell, sf, kind)
    again = gp_gram.gram_bwd(G, xa, xb, ell, sf, kind)
    for a, c in zip(first, again):
        assert torch.equal(a.view(torch.int32), c.view(torch.int32))
    if same and m == n:
        diag = torch.diagonal(gp_gram.gram_fwd(xa, xb, ell, sf, kind), dim1=1, dim2=2)
        assert torch.equal(diag, diag[:, :1].expand_as(diag))
        if kind == "rbf":
            assert torch.equal(diag[:, 0], sf * sf)


@pytest.mark.gpu
def test_cuda_autograd_goes_through_kernels(cuda):
    xa, xb, ell, sf, G = _cuda_inputs(64, 10, 10, 11, cuda, same=True)
    ell.requires_grad_(True)
    sf.requires_grad_(True)
    n0, n1 = gp_gram.gram_fwd.launches, gp_gram.gram_bwd.launches
    (ops.gram(xa, xb, ell, sf) * G).sum().backward()
    assert (gp_gram.gram_fwd.launches, gp_gram.gram_bwd.launches) == (n0 + 1, n1 + 1)
    w_ell, w_sf = ref.gram_bwd(G, xa, xb, ell.detach(), sf.detach())
    torch.testing.assert_close(ell.grad, w_ell, rtol=2e-5, atol=2e-4)
    torch.testing.assert_close(sf.grad, w_sf, rtol=2e-5, atol=2e-4)


# (b, hq, hkv, s, t, d, causal): GQA groups 1/2/4/8, S < 8, decode
# prefixes S < T (q_offset > 0), S and T off the kernels' tiles (32/64 for
# simt, 64 for sm90), D of 16, 20, 24, 32, 64, 72 and 128 (D = 20 takes
# the simt route in bf16 too), non-causal (also S > T), and the Whisper
# decoder's (8, 20, 448, 64)
FLASH_SHAPES = [
    (1, 1, 1, 32, 32, 16, True), (2, 4, 2, 64, 64, 32, True),
    (1, 8, 1, 128, 128, 64, True), (2, 8, 8, 100, 100, 64, True),
    (2, 8, 4, 100, 100, 64, True), (2, 8, 2, 100, 100, 64, True),
    (2, 4, 2, 3, 3, 64, True), (2, 4, 2, 1, 77, 64, True),
    (1, 4, 2, 32, 128, 32, True), (2, 4, 4, 100, 300, 64, True),
    (2, 4, 4, 48, 48, 24, True), (1, 4, 2, 70, 70, 16, True),
    (1, 4, 2, 70, 70, 128, True), (1, 2, 2, 33, 65, 16, False),
    (1, 2, 2, 64, 100, 32, False), (1, 2, 1, 100, 50, 64, False),
    (1, 8, 1, 200, 200, 128, True), (2, 8, 2, 17, 300, 32, True),
    (1, 4, 4, 129, 129, 64, True), (1, 4, 2, 65, 65, 32, True),
    (1, 4, 2, 130, 130, 20, True), (1, 2, 2, 300, 140, 128, False),
    (1, 4, 1, 96, 160, 72, True), (1, 8, 4, 64, 1000, 16, True),
    (8, 20, 20, 448, 448, 64, True),
]
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}


@pytest.mark.gpu
@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", FLASH_SHAPES)
def test_cuda_flash_attention_matches_plain(cuda, dtype, b, hq, hkv, s, t, d, causal):
    rng = np.random.default_rng(s * t + d)
    q, k, v = (torch.as_tensor(rng.standard_normal(shape).astype(np.float32),
                               device=cuda).to(dtype)
               for shape in ((b, hq, s, d), (b, hkv, t, d), (b, hkv, t, d)))
    n0 = flash_attention.flash_attention.launches
    r0 = dict(flash_attention.flash_attention.route_launches)
    got = ops.attention(q, k, v, causal=causal)
    torch.cuda.synchronize()
    which = "sm90" if dtype == torch.bfloat16 and d % 8 == 0 else "simt"
    assert flash_attention.flash_attention.launches == n0 + 1
    assert flash_attention.flash_attention.route_launches == {
        r: r0[r] + (r == which) for r in r0}
    assert got.dtype == dtype and got.shape == q.shape
    tol = FLASH_TOL[dtype]
    torch.testing.assert_close(got.float(), ref.attention(q, k, v, causal=causal).float(),
                               rtol=tol, atol=tol)


@pytest.mark.gpu
def test_cuda_flash_attention_misaligned_bf16_takes_simt(cuda):
    """A bf16 view whose data starts off a 16-byte boundary cannot be
    described to TMA: it takes the CUDA-core kernel, and agrees."""
    rng = np.random.default_rng(11)
    shape = (1, 4, 70, 64)
    flat = torch.as_tensor(rng.standard_normal(3 * np.prod(shape) + 4).astype(np.float32),
                           device=cuda).to(torch.bfloat16)
    q, k, v = (flat[4 + i * int(np.prod(shape)):][:int(np.prod(shape))].view(shape)
               for i in range(3))
    assert q.data_ptr() % 16 == 8 and q.is_contiguous()
    r0 = dict(flash_attention.flash_attention.route_launches)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.route_launches == {
        "sm90": r0["sm90"], "simt": r0["simt"] + 1}
    torch.testing.assert_close(got.float(), ref.attention(q, k, v).float(),
                               rtol=2e-2, atol=2e-2)


@pytest.mark.gpu
@pytest.mark.parametrize("d", [64, 20])
def test_cuda_flash_attention_fp32_off_16_bytes_takes_4_byte_copies(cuda, d):
    """fp32 q, k and v whose rows do not start on 16 bytes: the CUDA-core
    kernel loads them with 4-byte copies and stores o element by element."""
    rng = np.random.default_rng(d)
    shape = (2, 4, 100, d)
    n = int(np.prod(shape))
    flat = torch.as_tensor(rng.standard_normal(3 * n + 1).astype(np.float32), device=cuda)
    q, k, v = (flat[1 + i * n:][:n].view(shape) for i in range(3))
    assert q.data_ptr() % 16 == 4 and q.is_contiguous()
    r0 = dict(flash_attention.flash_attention.route_launches)
    got = flash_attention.flash_attention(q, k, v, causal=True)
    torch.cuda.synchronize()
    assert flash_attention.flash_attention.route_launches == {
        "sm90": r0["sm90"], "simt": r0["simt"] + 1}
    torch.testing.assert_close(got, ref.attention(q, k, v), rtol=2e-5, atol=2e-5)


@pytest.mark.gpu
def test_cuda_flash_attention_refuses_what_it_cannot_compute(cuda):
    q = torch.zeros((1, 2, 8, 16), device=cuda)
    with pytest.raises(ValueError, match="q_offset"):
        ops.attention(q, q[:, :, :4], q[:, :, :4], causal=True)   # S > T
    with pytest.raises(ValueError, match="head dim"):
        flash_attention.flash_attention(*(torch.zeros((1, 1, 8, 130), device=cuda),) * 3)
    with pytest.raises(TypeError):
        flash_attention.flash_attention(*(q.half(),) * 3)
