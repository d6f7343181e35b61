"""Whisper-style encoder-decoder backbone (counterpart of
``repro.models.whisper``).

As in the reference, the conv/mel frontend is a stub: the encoder takes
precomputed frame embeddings (B, S_frames, d_model).  The backbone:
sinusoidal positions, a pre-LN bidirectional encoder, and a decoder with
causal self-attention, cross-attention to the encoder output and GELU
MLPs (whisper-large-v3: 32 encoder + 32 decoder layers, d=1280, 20
heads).

Parameters are nested dicts of tensors.  Where the reference stacks the
layers on a leading axis for ``lax.scan``, the port keeps a list of
per-layer dicts and loops over it (``repro_torch.convert`` unstacks).
"""
from __future__ import annotations

import math

import torch

from repro_torch.device import resolve_device
from repro_torch.models import attention as A
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


def sinusoids(length: int, d: int, *, device="cpu") -> torch.Tensor:
    """(length, d) fp32 positions: ``[sin, cos]`` concatenated, not
    interleaved."""
    t = torch.arange(length, dtype=torch.float32, device=device)[:, None]
    inv = torch.exp(-math.log(10000.0)
                    * torch.arange(0, d, 2, dtype=torch.float32, device=device) / d)
    ang = t * inv[None, :]
    return torch.cat([torch.sin(ang), torch.cos(ang)], dim=-1)


def _init_enc_block(cfg: ModelConfig, kw: dict) -> dict:
    dev = kw["device"]
    return {
        "ln1": L.init_layernorm(cfg.d_model, device=dev),
        "attn": A.init_attention(cfg, **kw),
        "ln2": L.init_layernorm(cfg.d_model, device=dev),
        "mlp": L.init_gelu_mlp(cfg.d_model, cfg.d_ff, cfg.dtype, **kw),
    }


def _init_dec_block(cfg: ModelConfig, kw: dict) -> dict:
    dev = kw["device"]
    return {
        "ln1": L.init_layernorm(cfg.d_model, device=dev),
        "self_attn": A.init_attention(cfg, **kw),
        "ln_x": L.init_layernorm(cfg.d_model, device=dev),
        "cross_attn": A.init_attention(cfg, **kw),
        "ln2": L.init_layernorm(cfg.d_model, device=dev),
        "mlp": L.init_gelu_mlp(cfg.d_model, cfg.d_ff, cfg.dtype, **kw),
    }


def init_whisper(cfg: ModelConfig, *, generator: torch.Generator | None = None,
                 device="cuda") -> dict:
    """Random parameters with the reference's shapes, dtypes and scales,
    drawn from ``generator`` (which must live on ``device``; None uses the
    device's default generator, and ``device="meta"`` allocates nothing)."""
    kw = dict(generator=generator, device=resolve_device(device))
    n_dec = cfg.dec_layers or cfg.n_layers
    return {
        "enc_blocks": [_init_enc_block(cfg, kw) for _ in range(cfg.n_layers)],
        "enc_ln": L.init_layernorm(cfg.d_model, device=kw["device"]),
        "tok_embed": L.init_embedding(cfg.vocab, cfg.d_model, cfg.dtype, **kw),
        "dec_blocks": [_init_dec_block(cfg, kw) for _ in range(n_dec)],
        "dec_ln": L.init_layernorm(cfg.d_model, device=kw["device"]),
        "lm_head": L.init_linear(cfg.d_model, cfg.vocab, cfg.dtype, **kw),
    }


def encode(params: dict, frames: torch.Tensor, cfg: ModelConfig) -> torch.Tensor:
    """frames: (B, S, d_model) stub frontend output -> encoder states."""
    x = frames.to(cfg.dtype)
    x = x + sinusoids(x.shape[1], cfg.d_model, device=x.device).to(cfg.dtype)
    pos = torch.arange(x.shape[1], device=x.device)
    for lp in params["enc_blocks"]:
        h = L.layer_norm(x, lp["ln1"], cfg.norm_eps)
        out, _ = A.attention_block(lp["attn"], h, cfg, positions=pos,
                                   causal=False, rope=False)
        x = x + out
        h = L.layer_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.gelu_mlp(lp["mlp"], h)
    return L.layer_norm(x, params["enc_ln"], cfg.norm_eps)


def init_dec_caches(cfg: ModelConfig, batch: int, max_len: int, *,
                    device="cuda") -> A.KVCache:
    """Per-layer self-attention caches stacked on a leading layer axis."""
    dev = resolve_device(device)
    n = cfg.dec_layers or cfg.n_layers
    shape = (n, batch, cfg.n_kv, max_len, cfg.dh)
    return A.KVCache(k=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                     v=torch.zeros(shape, dtype=cfg.dtype, device=dev),
                     length=torch.zeros((n,), dtype=torch.int32, device=dev))


def decode(params: dict, tokens: torch.Tensor, enc_out: torch.Tensor,
           cfg: ModelConfig, caches: A.KVCache | None = None):
    """Teacher-forced (caches=None) or incremental decoder pass.

    Returns (logits (B, S, vocab), new caches or None).  With caches, each
    layer's K/V are written into ``caches`` in place."""
    x = params["tok_embed"][tokens]
    S = x.shape[1]
    base = caches.length[0] if caches is not None else 0
    pos_emb = sinusoids(cfg.dec_len, cfg.d_model, device=x.device).to(cfg.dtype)
    pos_idx = base + torch.arange(S, device=x.device)
    x = x + pos_emb[torch.clamp(pos_idx, 0, cfg.dec_len - 1)]

    lengths = []
    for i, lp in enumerate(params["dec_blocks"]):
        ca = (None if caches is None else
              A.KVCache(caches.k[i], caches.v[i], caches.length[i]))
        h = L.layer_norm(x, lp["ln1"], cfg.norm_eps)
        out, new_ca = A.attention_block(lp["self_attn"], h, cfg,
                                        positions=pos_idx, causal=True,
                                        rope=False, cache=ca)
        if new_ca is not None:
            lengths.append(new_ca.length)
        x = x + out
        h = L.layer_norm(x, lp["ln_x"], cfg.norm_eps)
        out, _ = A.attention_block(lp["cross_attn"], h, cfg,
                                   positions=pos_idx, causal=False,
                                   rope=False, kv_override=(enc_out, enc_out))
        x = x + out
        h = L.layer_norm(x, lp["ln2"], cfg.norm_eps)
        x = x + L.gelu_mlp(lp["mlp"], h)

    new_caches = None
    if caches is not None:
        new_caches = A.KVCache(caches.k, caches.v, torch.stack(lengths))
    x = L.layer_norm(x, params["dec_ln"], cfg.norm_eps)
    return L.matmul(x, params["lm_head"]), new_caches
