"""Model zoo (counterpart of ``repro.models``): configs and the model
families ported so far (Whisper)."""
from repro_torch.models.config import ModelConfig, smoke_config
from repro_torch.models.registry import ARCHS, PORTED, get_config

__all__ = ["ModelConfig", "smoke_config", "ARCHS", "PORTED", "get_config"]
