"""Serving steps for Whisper (counterpart of ``repro.serve.engine``; the
language-model steps wait for their slice).

``whisper_prefill_fn`` is what the reference's Whisper prefill cell
lowers (``repro/launch/specs.py``): encode the frames, then one
teacher-forced decoder pass over ``dec_len`` start tokens, whose causal
self-attention is the flash kernel's caller.  ``whisper_decode_step_fn``
serves one token per request against the decoder's KV caches.
"""
from __future__ import annotations

import torch

from repro_torch.models import whisper as W
from repro_torch.models.config import ModelConfig


def whisper_prefill_fn(params, cfg: ModelConfig, frames: torch.Tensor):
    """frames: (B, S_frames, d_model) -> (encoder states, last-position
    logits (B, vocab)) of the teacher-forced pass over ``dec_len`` zero
    tokens."""
    enc = W.encode(params, frames, cfg)
    toks = torch.zeros((frames.shape[0], cfg.dec_len), dtype=torch.long,
                       device=frames.device)
    logits, _ = W.decode(params, toks, enc, cfg)
    return enc, logits[:, -1]


def whisper_decode_step_fn(params, cfg: ModelConfig, token: torch.Tensor,
                           enc_out: torch.Tensor, caches):
    """token: (B, 1) -> (logits (B, vocab), caches advanced by one)."""
    logits, caches = W.decode(params, token, enc_out, cfg, caches)
    return logits[:, -1], caches
