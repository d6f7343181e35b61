"""Multi-head attention with a KV cache and kernel dispatch (counterpart
of ``repro.models.attention``; the part Whisper uses, without RoPE).

Two execution paths share one parameter layout:
  * teacher-forced / prefill: full-sequence attention, dispatched to the
    flash kernel when ``cfg.attn_impl`` asks for it and the call is
    eligible (``attend``), the plain masked attention otherwise;
  * decode: queries against a KV cache.  The reference threads caches
    functionally; here a step writes its K/V into the cache tensors in
    place (no copy of the whole cache per step) and returns a
    ``KVCache`` with the new length over the same tensors.
"""
from __future__ import annotations

from typing import NamedTuple

import torch

from repro_torch.kernels import ops as kops
from repro_torch.models import layers as L
from repro_torch.models.config import ModelConfig


class KVCache(NamedTuple):
    k: torch.Tensor        # (B, n_kv, T, dh), or (layers, B, n_kv, T, dh)
    v: torch.Tensor        # (B, n_kv, T, dh), or (layers, B, n_kv, T, dh)
    length: torch.Tensor   # () int32 valid prefix length, or (layers,)


def init_attention(cfg: ModelConfig, *, generator=None, device="cpu") -> dict:
    d = cfg.d_model
    kw = dict(generator=generator, device=device)
    return {
        "wq": L.init_linear(d, cfg.q_dim, cfg.dtype, **kw),
        "wk": L.init_linear(d, cfg.kv_dim, cfg.dtype, **kw),
        "wv": L.init_linear(d, cfg.kv_dim, cfg.dtype, **kw),
        "wo": L.init_linear(cfg.q_dim, d, cfg.dtype, **kw),
    }


def init_cache(cfg: ModelConfig, batch: int, max_len: int, dtype=None, *,
               device="cpu") -> KVCache:
    dtype = dtype or cfg.dtype
    shape = (batch, cfg.kv_heads_eff, max_len, cfg.dh)
    return KVCache(k=torch.zeros(shape, dtype=dtype, device=device),
                   v=torch.zeros(shape, dtype=dtype, device=device),
                   length=torch.zeros((), dtype=torch.int32, device=device))


def _split_heads(x: torch.Tensor, n: int, dh: int) -> torch.Tensor:
    B, S, _ = x.shape
    return x.reshape(B, S, n, dh).transpose(1, 2)


def _merge_heads(x: torch.Tensor) -> torch.Tensor:
    B, H, S, dh = x.shape
    return x.transpose(1, 2).reshape(B, S, H * dh)


def _masked_ref_attention(q, k, v, *, causal, window, kv_len, sm_scale):
    """Plain attention with optional sliding window and cache-length mask.

    q: (B,Hq,S,D); k/v: (B,Hkv,T,D).  kv_len masks keys >= kv_len
    (decode with a partially filled cache).  Queries align to the END of
    the valid prefix: qpos = kv_len - S + i.

    GQA-native: q is reshaped to (B, Hkv, group, S, D) against K/V
    directly.  As in the reference, the logits are fp32 products of the
    input values, masked with -1e30 (not -inf), and the softmax weights
    are cast to v's dtype before P·V, which accumulates in fp32.
    """
    B, Hq, S, D = q.shape
    Hkv, T = k.shape[1], k.shape[2]
    group = Hq // Hkv
    qg = q.reshape(B, Hkv, group, S, D).float()
    kf = k.float()[:, :, None]
    logits = torch.matmul(qg, kf.transpose(-1, -2)) * sm_scale
    # kv_len and window are ints or tensors on q's device (a cache length,
    # a per-layer window); 0 = full attention.  Neither is copied to the
    # card here: a host-to-device copy would stall the stream.
    kpos = torch.arange(T, device=q.device)[None, :]
    qpos = (kv_len - S) + torch.arange(S, device=q.device)[:, None]
    mask = kpos < kv_len
    if causal:
        mask = mask & (kpos <= qpos)
    mask = mask & ((window <= 0) | (kpos > qpos - window))
    logits = logits.masked_fill(~mask, -1e30)
    w = torch.softmax(logits, dim=-1)
    out = torch.matmul(w.to(v.dtype).float(), v.float()[:, :, None])
    return out.reshape(B, Hq, S, D).to(q.dtype)


def attend(q: torch.Tensor, k: torch.Tensor, v: torch.Tensor,
           cfg: ModelConfig, *, causal: bool, window=0,
           kv_len: torch.Tensor | int | None = None) -> torch.Tensor:
    """Dispatch: the flash kernel when eligible, plain attention else.

    Eligible, as in the reference: ``attn_impl`` "flash" or "auto", a
    static ``window == 0``, no cache length, causal, and at least 8
    queries.  ``kops.attention`` then picks the CUDA kernel for a CUDA
    tensor and the plain version for a CPU tensor."""
    sm_scale = cfg.dh ** -0.5
    full_len = kv_len is None
    static_no_window = isinstance(window, int) and window == 0
    if (cfg.attn_impl in ("flash", "auto") and static_no_window and full_len
            and causal and q.shape[2] >= 8):
        return kops.attention(q, k, v, causal=True, sm_scale=sm_scale)
    if kv_len is None:
        kv_len = k.shape[2]
    return _masked_ref_attention(q, k, v, causal=causal, window=window,
                                 kv_len=kv_len, sm_scale=sm_scale)


def attention_block(p: dict, x: torch.Tensor, cfg: ModelConfig, *,
                    positions: torch.Tensor, causal: bool = True,
                    window=0, rope: bool = True,
                    cache: KVCache | None = None,
                    kv_override: tuple[torch.Tensor, torch.Tensor] | None = None,
                    ) -> tuple[torch.Tensor, KVCache | None]:
    """Full attention sub-block: projections + attend + output.

    With ``cache``: writes this call's K/V at cache.length (in place) and
    attends against the valid prefix (decode or incremental prefill).
    ``kv_override`` supplies external K/V inputs (cross-attention).
    ``positions`` feed RoPE, which is not ported: ``rope=True`` without
    ``kv_override`` raises.
    """
    if rope and kv_override is None:
        raise NotImplementedError("RoPE is not ported yet; pass rope=False")
    B, S, _ = x.shape
    q = _split_heads(L.matmul(x, p["wq"]), cfg.n_heads, cfg.dh)
    xkv = x if kv_override is None else kv_override[0]
    k = _split_heads(L.matmul(xkv, p["wk"]), cfg.n_kv, cfg.dh)
    v = _split_heads(L.matmul(xkv, p["wv"]), cfg.n_kv, cfg.dh)
    if cfg.pad_kv_heads and cfg.pad_kv_heads > cfg.n_kv:
        # replicate KV heads (n_kv | pad | n_heads): attention-identical
        rep = cfg.pad_kv_heads // cfg.n_kv
        k = k.repeat_interleave(rep, dim=1)
        v = v.repeat_interleave(rep, dim=1)

    new_cache = None
    if cache is not None:
        T = cache.k.shape[2]
        # the reference's dynamic_update_slice clamps the start so the
        # slice fits; the same clamp keeps the write inside the cache
        start = torch.clamp(cache.length, 0, T - S)
        idx = start + torch.arange(S, device=x.device)
        cache.k.index_copy_(2, idx, k.to(cache.k.dtype))
        cache.v.index_copy_(2, idx, v.to(cache.v.dtype))
        kv_len = cache.length + S
        new_cache = KVCache(k=cache.k, v=cache.v, length=kv_len)
        out = attend(q, cache.k, cache.v, cfg, causal=causal, window=window,
                     kv_len=kv_len)
    else:
        out = attend(q, k, v, cfg, causal=causal, window=window)

    return L.matmul(_merge_heads(out), p["wo"]), new_cache
