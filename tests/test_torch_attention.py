"""The port's attention against the JAX reference (CPU): the flash
kernel's plain version against ``repro.kernels.ref.attention`` and the
Pallas kernel in interpret mode, the masked plain attention of the model
code, and ``attend``'s routing to the kernel.

Inputs are made with numpy from a seed and handed to both frameworks
(bf16 inputs are rounded from the same fp32 values by both).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.kernels import ops as jops
from repro.kernels import ref as jref
from repro.models import attention as JA
from repro.models import get_config as jget_config
from repro.models import whisper as JW
from repro_torch import convert
from repro_torch.kernels import flash_attention as fa
from repro_torch.kernels import ops, ref
from repro_torch.models import attention as A
from repro_torch.models import get_config
from repro_torch.models import whisper as W

DTYPES = {"float32": (jnp.float32, torch.float32, 2e-5),
          "bfloat16": (jnp.bfloat16, torch.bfloat16, 2e-2)}

# (b, hq, hkv, s, t, d, causal): the cases of tests/test_kernels.py —
# causal sweeps, padded S/T and odd D, a decode prefix, non-causal, and
# GQA groups 1, 2 and 4
CASES = [
    (1, 1, 1, 32, 32, 16, True),
    (2, 4, 2, 64, 64, 32, True),
    (1, 8, 1, 128, 128, 64, True),
    (2, 4, 4, 48, 48, 24, True),     # padded: S, T not tile multiples, D=24
    (1, 4, 2, 32, 128, 32, True),    # decode prefix: S < T
    (1, 2, 2, 64, 64, 32, False),    # non-causal
    (1, 4, 4, 32, 32, 16, True),     # group 1
    (1, 4, 2, 32, 32, 16, True),     # group 2
    (1, 4, 1, 32, 32, 16, True),     # group 4
]


def _qkv(b, hq, hkv, s, t, d, seed=0):
    rng = np.random.default_rng(seed)
    return (rng.standard_normal((b, hq, s, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32),
            rng.standard_normal((b, hkv, t, d)).astype(np.float32))


def _both(arrays, dtype):
    jdt, tdt, _ = DTYPES[dtype]
    return ([jnp.asarray(a, jdt) for a in arrays],
            [torch.as_tensor(a).to(tdt) for a in arrays])


def _np(x):
    return x.float().numpy() if isinstance(x, torch.Tensor) else np.float32(x)


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("b,hq,hkv,s,t,d,causal", CASES)
def test_plain_attention_matches_reference_and_pallas(dtype, b, hq, hkv, s, t,
                                                      d, causal):
    (jq, jk, jv), (q, k, v) = _both(_qkv(b, hq, hkv, s, t, d), dtype)
    tol = DTYPES[dtype][2]
    got = ref.attention(q, k, v, causal=causal)
    assert got.dtype == q.dtype and got.shape == q.shape
    want = jref.attention(jq, jk, jv, causal=causal)
    pallas = jops.attention(jq, jk, jv, causal=causal, impl="pallas", bq=32, bk=32)
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(got), _np(pallas), rtol=tol, atol=tol)
    # on a CPU tensor the dispatch takes the plain version, bit for bit
    assert torch.equal(ops.attention(q, k, v, causal=causal), got)


def test_plain_attention_explicit_scale_and_short_queries():
    """sm_scale is passed through, and S < 8 (which the TPU wrapper sent
    to the reference) is computed by the same function."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 4, 2, 3, 40, 16, seed=1), "float32")
    got = ops.attention(q, k, v, causal=True, sm_scale=0.3)
    want = jops.attention(jq, jk, jv, causal=True, sm_scale=0.3, impl="pallas")
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_kernel_wrapper_refuses_cpu_tensors_and_bad_shapes():
    q = torch.zeros((1, 2, 4, 8))
    with pytest.raises(ValueError, match="CUDA"):
        fa.flash_attention(q, q, q)
    with pytest.raises(ValueError, match="device"):
        ops.attention(q.to("meta"), q.to("meta"), q.to("meta"))
    assert fa.flash_attention.launches == 0


@pytest.mark.parametrize("dtype", sorted(DTYPES))
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("kv_len,window", [(20, 0), (20, 5), (32, 7), (9, 0)])
def test_masked_ref_attention_matches_reference(dtype, causal, kv_len, window):
    """A partly filled cache (kv_len < T) and a sliding window, GQA group 2."""
    (jq, jk, jv), (q, k, v) = _both(_qkv(2, 4, 2, 4, 32, 16, seed=2), dtype)
    tol = DTYPES[dtype][2]
    got = A._masked_ref_attention(q, k, v, causal=causal, window=window,
                                  kv_len=kv_len, sm_scale=0.25)
    want = JA._masked_ref_attention(jq, jk, jv, causal=causal, window=window,
                                    kv_len=jnp.asarray(kv_len, jnp.int32),
                                    sm_scale=0.25)
    assert got.dtype == q.dtype
    np.testing.assert_allclose(_np(got), _np(want), rtol=tol, atol=tol)


# ----------------------------------------------------------------------
# routing: which calls reach the kernel
# ----------------------------------------------------------------------

def _count_routes(monkeypatch, module, plain):
    calls = []

    def counting(q, k, v, *, causal=True, sm_scale=None, **_):
        calls.append(tuple(q.shape))
        return plain(q, k, v, causal=causal, sm_scale=sm_scale)

    monkeypatch.setattr(module.kops, "attention", counting)
    return calls


@pytest.mark.parametrize("impl", ["ref", "flash", "auto"])
def test_attend_routes_like_the_reference(monkeypatch, impl):
    """Per path (encoder, teacher-forced decoder, two cached steps), the
    calls that reach the kernel's dispatch in the port and in JAX (scan
    unrolled by disable_jit, so each layer counts)."""
    jcfg = dataclasses.replace(jget_config("whisper-large-v3", smoke=True),
                               attn_impl=impl)
    cfg = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                              attn_impl=impl)
    jparams = JW.init_whisper(jax.random.PRNGKey(0), jcfg)
    params = convert.whisper_params_from_arrays(
        jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(3)
    frames = rng.standard_normal((2, 12, cfg.d_model)).astype(np.float32)
    toks = rng.integers(0, cfg.vocab, (2, cfg.dec_len))
    jcalls = _count_routes(monkeypatch, JA, jref.attention)
    calls = _count_routes(monkeypatch, A, ref.attention)

    def counts(run):
        j0, p0 = len(jcalls), len(calls)
        run()
        return len(jcalls) - j0, len(calls) - p0

    with jax.disable_jit():
        jenc = JW.encode(jparams, jnp.asarray(frames), jcfg)
        enc = W.encode(params, torch.as_tensor(frames), cfg)
        routes = {"encode": counts(lambda: (JW.encode(jparams, jnp.asarray(frames), jcfg),
                                            W.encode(params, torch.as_tensor(frames), cfg))),
                  "teacher_forced": counts(lambda: (
                      JW.decode(jparams, jnp.asarray(toks), jenc, jcfg),
                      W.decode(params, torch.as_tensor(toks), enc, cfg)))}
        jca = JW.init_dec_caches(jcfg, 2, cfg.dec_len)
        ca = W.init_dec_caches(cfg, 2, cfg.dec_len, device="cpu")

        def two_steps():
            nonlocal jca, ca
            for t in range(2):
                _, jca = JW.decode(jparams, jnp.asarray(toks[:, t:t + 1]), jenc,
                                   jcfg, jca)
                _, ca = W.decode(params, torch.as_tensor(toks[:, t:t + 1]), enc,
                                 cfg, ca)

        routes["cached"] = counts(two_steps)
    n = cfg.dec_layers if impl in ("flash", "auto") else 0
    assert routes == {"encode": (0, 0), "teacher_forced": (n, n),
                      "cached": (0, 0)}
    assert all(shape == (2, cfg.n_heads, cfg.dec_len, cfg.dh) for shape in calls)


# ----------------------------------------------------------------------
# the attention block: projections, cache, cross-attention, KV padding
# ----------------------------------------------------------------------

@pytest.mark.parametrize("mode", ["self", "causal_flash", "cache", "cross", "pad_kv"])
def test_attention_block_matches_reference(mode):
    """attention_block without RoPE (Whisper's use): full self-attention,
    causal through the flash route, a cache prefilled with 5 tokens then
    3 more, cross-attention through kv_override, and KV heads replicated
    by pad_kv_heads."""
    jcfg = jget_config("whisper-large-v3", smoke=True)
    jcfg = dataclasses.replace(jcfg, attn_impl="flash" if mode == "causal_flash" else "ref",
                               pad_kv_heads=4 if mode == "pad_kv" else 0)
    cfg = dataclasses.replace(get_config("whisper-large-v3", smoke=True),
                              attn_impl=jcfg.attn_impl, pad_kv_heads=jcfg.pad_kv_heads)
    jp = JA.init_attention(jax.random.PRNGKey(1), jcfg)
    p = {k: torch.as_tensor(np.array(v)) for k, v in jp.items()}
    rng = np.random.default_rng(4)
    x = rng.standard_normal((2, 8, cfg.d_model)).astype(np.float32)
    enc = rng.standard_normal((2, 11, cfg.d_model)).astype(np.float32)
    pos = np.arange(8)
    kw = dict(causal=mode != "self", rope=False)
    if mode == "cross":
        kw.update(causal=False)
        got, _ = A.attention_block(p, torch.as_tensor(x), cfg, positions=torch.as_tensor(pos),
                                   kv_override=(torch.as_tensor(enc),) * 2, **kw)
        want, _ = JA.attention_block(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos),
                                     kv_override=(jnp.asarray(enc),) * 2, **kw)
    elif mode == "cache":
        ca = A.init_cache(cfg, 2, 16)
        jca = JA.init_cache(jcfg, 2, 16)
        for lo, hi in ((0, 5), (5, 8)):
            got, ca = A.attention_block(p, torch.as_tensor(x[:, lo:hi]), cfg,
                                        positions=torch.as_tensor(pos[lo:hi]), cache=ca, **kw)
            want, jca = JA.attention_block(jp, jnp.asarray(x[:, lo:hi]), jcfg,
                                           positions=jnp.asarray(pos[lo:hi]), cache=jca, **kw)
        assert int(ca.length) == int(jca.length) == 8
        np.testing.assert_allclose(ca.v.numpy(), np.asarray(jca.v), rtol=2e-5, atol=2e-5)
    else:
        got, _ = A.attention_block(p, torch.as_tensor(x), cfg, positions=torch.as_tensor(pos),
                                   **kw)
        want, _ = JA.attention_block(jp, jnp.asarray(x), jcfg, positions=jnp.asarray(pos), **kw)
    np.testing.assert_allclose(_np(got), _np(want), rtol=2e-5, atol=2e-5)


def test_init_cache_and_rope_refusal():
    cfg = get_config("whisper-large-v3", smoke=True)
    jc = JA.init_cache(jget_config("whisper-large-v3", smoke=True), 3, 10)
    c = A.init_cache(cfg, 3, 10)
    assert tuple(c.k.shape) == jc.k.shape and c.k.dtype == torch.float32
    assert c.length.shape == () and int(c.length) == 0
    x = torch.zeros((1, 2, cfg.d_model))
    p = A.init_attention(cfg)
    with pytest.raises(NotImplementedError, match="RoPE"):
        A.attention_block(p, x, cfg, positions=torch.arange(2))
