"""The port's Whisper against the JAX reference (CPU, smoke widths, fp32):
the same parameters (JAX's ``init_whisper`` through ``convert``) and the
same numpy inputs give the same encoder states, teacher-forced logits
(the flash path with JAX's Pallas kernel in interpret mode, and the plain
path), prefill and greedy cached tokens.  The full-width config is
checked field by field and shape by shape without allocating it.

Tolerances: fp32 on both sides over two layers; the sums run in other
orders (XLA:CPU against PyTorch's CPU GEMMs), so values agree to a few
ulp of their size: rtol 1e-4, atol 1e-5 (logits are O(1)).
"""
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from repro.models import get_config as jget_config
from repro.models import whisper as JW
from repro.serve.engine import whisper_decode_step_fn as jstep
from repro_torch import convert
from repro_torch.models import get_config
from repro_torch.models import whisper as W
from repro_torch.serve import whisper_decode_step_fn, whisper_prefill_fn

ARCH = "whisper-large-v3"
RTOL, ATOL = 1e-4, 1e-5
B, FRAMES = 2, 24


@pytest.fixture(scope="module")
def model():
    jcfg = jget_config(ARCH, smoke=True)
    jparams = JW.init_whisper(jax.random.PRNGKey(0), jcfg)
    params = convert.whisper_params_from_arrays(
        jax.tree.map(np.asarray, jparams), device="cpu")
    rng = np.random.default_rng(0)
    frames = rng.standard_normal((B, FRAMES, jcfg.d_model)).astype(np.float32)
    toks = rng.integers(0, jcfg.vocab, (B, jcfg.dec_len))
    return jcfg, jparams, params, frames, toks


def _cfgs(jcfg, impl):
    return (dataclasses.replace(jcfg, attn_impl=impl),
            dataclasses.replace(get_config(ARCH, smoke=True), attn_impl=impl))


def _close(got, want):
    np.testing.assert_allclose(got.float().numpy(), np.float32(want),
                               rtol=RTOL, atol=ATOL)


@pytest.mark.parametrize("smoke", [False, True])
def test_config_matches_reference(smoke):
    j = dataclasses.asdict(jget_config(ARCH, smoke=smoke))
    p = dataclasses.asdict(get_config(ARCH, smoke=smoke))
    assert str(jnp.dtype(j.pop("dtype"))) == str(p.pop("dtype")).removeprefix("torch.")
    assert p == j


def test_unported_arch_raises():
    with pytest.raises(NotImplementedError, match="not ported"):
        get_config("glm4-9b")
    with pytest.raises(KeyError):
        get_config("no-such-model")


def test_full_width_parameter_shapes_match_reference():
    """whisper-large-v3 at full width: every leaf's shape and dtype against
    ``jax.eval_shape(init_whisper)``, on the meta device (nothing is
    allocated on either side)."""
    jcfg, cfg = jget_config(ARCH), get_config(ARCH)
    jshapes = jax.eval_shape(lambda: JW.init_whisper(jax.random.PRNGKey(0), jcfg))
    params = W.init_whisper(cfg, device="meta")
    want = {}
    for path, leaf in jax.tree_util.tree_leaves_with_path(jshapes):
        keys = tuple(k.key for k in path)
        if keys[0].endswith("_blocks"):
            for i in range(leaf.shape[0]):
                want[(keys[0], i) + keys[1:]] = (leaf.shape[1:], str(leaf.dtype))
        else:
            want[keys] = (leaf.shape, str(leaf.dtype))
    got = {}
    for name, sub in params.items():
        if name.endswith("_blocks"):
            for i, block in enumerate(sub):
                for part, leaves in block.items():
                    for leaf_name, t in leaves.items():
                        got[(name, i, part, leaf_name)] = t
        elif isinstance(sub, dict):
            got.update({(name, k): t for k, t in sub.items()})
        else:
            got[(name,)] = sub
    assert all(t.device.type == "meta" for t in got.values())
    assert {k: (tuple(t.shape), str(t.dtype).removeprefix("torch."))
            for k, t in got.items()} == want
    n = sum(t.numel() for t in got.values())
    assert 1.55e9 < n < 1.65e9, n


def test_encode_matches_reference(model):
    jcfg, jparams, params, frames, _ = model
    jc, c = _cfgs(jcfg, "ref")
    _close(W.encode(params, torch.as_tensor(frames), c),
           JW.encode(jparams, jnp.asarray(frames), jc))


@pytest.mark.parametrize("impl", ["ref", "flash"])
def test_teacher_forced_logits_match_reference(model, impl):
    """"flash" runs JAX's Pallas kernel in interpret mode and the port's
    plain version on the CPU; "ref" the masked plain attention in both."""
    jcfg, jparams, params, frames, toks = model
    jc, c = _cfgs(jcfg, impl)
    jenc = JW.encode(jparams, jnp.asarray(frames), jc)
    enc = W.encode(params, torch.as_tensor(frames), c)
    jlogits, jca = JW.decode(jparams, jnp.asarray(toks), jenc, jc)
    logits, ca = W.decode(params, torch.as_tensor(toks), enc, c)
    assert ca is None and jca is None
    assert logits.shape == (B, c.dec_len, c.vocab)
    _close(logits, jlogits)


def test_prefill_matches_reference(model):
    """whisper_prefill_fn against the reference's Whisper prefill cell:
    encode, then the teacher-forced decoder over dec_len zero tokens."""
    jcfg, jparams, params, frames, _ = model
    jc, c = _cfgs(jcfg, "flash")
    jenc = JW.encode(jparams, jnp.asarray(frames), jc)
    jlogits, _ = JW.decode(jparams, jnp.zeros((B, jc.dec_len), jnp.int32), jenc, jc)
    enc, last = whisper_prefill_fn(params, c, torch.as_tensor(frames))
    assert last.shape == (B, c.vocab)
    _close(enc, jenc)
    _close(last, jlogits[:, -1])


def test_greedy_cached_decode_matches_reference(model):
    """Eight greedy steps from a zero start token on an empty cache: the
    same tokens at every step, logits within tolerance."""
    jcfg, jparams, params, frames, _ = model
    jc, c = _cfgs(jcfg, "flash")
    jenc = JW.encode(jparams, jnp.asarray(frames), jc)
    enc = W.encode(params, torch.as_tensor(frames), c)
    jca = JW.init_dec_caches(jc, B, jc.dec_len)
    ca = W.init_dec_caches(c, B, c.dec_len, device="cpu")
    jtok = jnp.zeros((B, 1), jnp.int32)
    tok = torch.zeros((B, 1), dtype=torch.long)
    for step in range(8):
        jlogits, jca = jstep(jparams, jc, jtok, jenc, jca)
        logits, ca = whisper_decode_step_fn(params, c, tok, enc, ca)
        _close(logits, jlogits)
        jtok = jnp.argmax(jlogits, -1)[:, None].astype(jnp.int32)
        tok = logits.argmax(-1)[:, None]
        assert tok.numpy().tolist() == np.asarray(jtok).tolist(), step
        assert ca.length.tolist() == [step + 1] * c.dec_layers
    np.testing.assert_allclose(ca.k.numpy(), np.asarray(jca.k), rtol=RTOL, atol=ATOL)


def test_cached_decode_equals_teacher_forced(model):
    """The serving contract inside the port: feeding tokens one at a time
    through the cache gives the teacher-forced logits (flash path)."""
    jcfg, _, params, frames, toks = model
    _, c = _cfgs(jcfg, "flash")
    enc = W.encode(params, torch.as_tensor(frames), c)
    full, _ = W.decode(params, torch.as_tensor(toks), enc, c)
    ca = W.init_dec_caches(c, B, c.dec_len, device="cpu")
    for t in range(c.dec_len):
        logits, ca = whisper_decode_step_fn(params, c, torch.as_tensor(toks[:, t:t + 1]),
                                            enc, ca)
        torch.testing.assert_close(logits, full[:, t], rtol=RTOL, atol=ATOL)


def test_convert_raises_on_missing_or_leftover_leaves(model):
    jcfg, jparams, *_ = model
    tree = jax.tree.map(np.asarray, jparams)
    del tree["dec_blocks"]["mlp"]["up"]
    with pytest.raises(KeyError, match="dec_blocks.mlp.up"):
        convert.whisper_params_from_arrays(tree, device="cpu")
    tree = jax.tree.map(np.asarray, jparams)
    tree["enc_ln"]["gain"] = np.ones(jcfg.d_model, np.float32)
    with pytest.raises(KeyError, match="enc_ln.gain"):
        convert.whisper_params_from_arrays(tree, device="cpu")


def test_convert_keeps_bfloat16():
    jcfg = dataclasses.replace(jget_config(ARCH, smoke=True), dtype=jnp.bfloat16)
    jparams = JW.init_whisper(jax.random.PRNGKey(1), jcfg)
    params = convert.whisper_params_from_arrays(
        jax.tree.map(np.asarray, jparams), device="cpu")
    w = params["dec_blocks"][1]["cross_attn"]["wq"]
    assert w.dtype == torch.bfloat16
    np.testing.assert_array_equal(
        w.float().numpy(), np.asarray(jparams["dec_blocks"]["cross_attn"]["wq"][1],
                                      np.float32))
    assert params["enc_ln"]["scale"].dtype == torch.float32
