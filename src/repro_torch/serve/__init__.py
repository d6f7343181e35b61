"""Serving substrate (counterpart of ``repro.serve``): Whisper prefill
and cached decode steps."""
from repro_torch.serve.engine import whisper_decode_step_fn, whisper_prefill_fn

__all__ = ["whisper_prefill_fn", "whisper_decode_step_fn"]
