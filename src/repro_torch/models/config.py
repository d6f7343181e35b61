"""Unified model configuration (counterpart of ``repro.models.config``).

The same fields and derived sizes as the reference; ``dtype`` is a torch
dtype.  Only the configurations in ``repro_torch.models.registry.PORTED``
have a model behind them so far."""
from __future__ import annotations

import dataclasses
from typing import Any

import torch


@dataclasses.dataclass(frozen=True)
class ModelConfig:
    name: str
    family: str                  # dense | moe | hybrid | ssm | audio | vlm
    n_layers: int
    d_model: int
    n_heads: int
    n_kv: int
    d_ff: int                    # dense MLP width (0 = no dense MLP)
    vocab: int
    head_dim: int = 0            # 0 -> d_model // n_heads

    # MoE
    n_experts: int = 0
    top_k: int = 0
    expert_ff: int = 0
    capacity_factor: float = 1.25

    # SSM / hybrid (Hymba, xLSTM)
    ssm_state: int = 0
    conv_kernel: int = 4
    window: int = 0              # sliding-window attention (0 = full)
    global_every: int = 0        # hybrid: every k-th layer uses full attn
    slstm_every: int = 0         # xLSTM: every k-th layer is sLSTM

    # encoder-decoder (Whisper)
    encdec: bool = False
    dec_layers: int = 0
    dec_len: int = 448

    # VLM stub frontend
    n_img_tokens: int = 0

    # numerics / implementation
    dtype: Any = torch.bfloat16
    rope_theta: float = 10_000.0
    norm_eps: float = 1e-5
    attn_impl: str = "ref"       # "ref" (plain) | "flash" (kernel) | "auto"
    remat: str = "dots"          # none | dots | full
    scan_layers: bool = True
    # perf variants of the reference's launch specs
    pad_kv_heads: int = 0        # replicate KV heads to this count so the
                                 # cache shards across a TP axis > n_kv
    mlstm_chunk: int = 0         # chunkwise-parallel mLSTM chunk (0 = scan)

    @property
    def dh(self) -> int:
        return self.head_dim or self.d_model // self.n_heads

    @property
    def q_dim(self) -> int:
        return self.n_heads * self.dh

    @property
    def kv_dim(self) -> int:
        return self.n_kv * self.dh

    @property
    def kv_heads_eff(self) -> int:
        """KV heads materialized in the cache (after replication pad)."""
        return self.pad_kv_heads or self.n_kv

    @property
    def is_moe(self) -> bool:
        return self.n_experts > 0

    @property
    def subquadratic(self) -> bool:
        """True iff decode state does not grow linearly in an unbounded
        attention window (the long_500k eligibility test)."""
        return self.family in ("ssm", "hybrid")

    def n_params(self) -> int:
        """Approximate parameter count (embeddings + blocks)."""
        d, dh = self.d_model, self.dh
        emb = self.vocab * d * 2  # in + lm_head (untied)
        per = 0
        per += d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d  # attn
        if self.d_ff:
            per += 3 * d * self.d_ff                                  # swiglu
        if self.is_moe:
            per += d * self.n_experts
            per += self.n_experts * 3 * d * self.expert_ff
        if self.family == "hybrid":
            per += 2 * d * self.d_model + self.d_model * (2 * self.ssm_state)
        per += 2 * d                                                  # norms
        n = emb + self.n_layers * per
        if self.encdec:
            n += self.dec_layers * (per + d * self.q_dim * 2)         # cross
        return n

    def n_active_params(self) -> int:
        """Active parameters per token (MoE: only top_k experts count)."""
        if not self.is_moe:
            return self.n_params()
        d = self.d_model
        per_dense = (d * self.q_dim + 2 * d * self.kv_dim + self.q_dim * d
                     + d * self.n_experts + 2 * d)
        per_active = self.top_k * 3 * d * self.expert_ff
        return (self.vocab * d * 2
                + self.n_layers * (per_dense + per_active))


def smoke_config(cfg: ModelConfig) -> ModelConfig:
    """Reduced same-family config for CPU smoke tests: 2 layers, narrow
    widths, tiny vocab — exercises the identical code paths."""
    return dataclasses.replace(
        cfg,
        n_layers=2,
        dec_layers=min(cfg.dec_layers, 2),
        d_model=64,
        n_heads=4,
        n_kv=max(1, min(cfg.n_kv, 2)),
        head_dim=16,
        d_ff=128 if cfg.d_ff else 0,
        vocab=256,
        n_experts=min(cfg.n_experts, 8),
        top_k=min(cfg.top_k, 2),
        expert_ff=64 if cfg.expert_ff else 0,
        ssm_state=min(cfg.ssm_state, 8),
        slstm_every=min(cfg.slstm_every, 2),
        window=min(cfg.window, 16) if cfg.window else 0,
        n_img_tokens=min(cfg.n_img_tokens, 8),
        dec_len=16,
        dtype=torch.float32,
        remat="none",
    )
