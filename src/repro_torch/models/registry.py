"""name -> config resolution (counterpart of ``repro.models.registry``).

``ARCHS`` lists every architecture the reference has; ``PORTED`` the
ones with a config and a model in the port so far.
"""
from __future__ import annotations

import importlib

from repro_torch.models.config import ModelConfig, smoke_config

ARCHS = [
    "phi-3-vision-4.2b",
    "codeqwen1.5-7b",
    "glm4-9b",
    "granite-3-8b",
    "internlm2-1.8b",
    "olmoe-1b-7b",
    "granite-moe-1b-a400m",
    "hymba-1.5b",
    "xlstm-1.3b",
    "whisper-large-v3",
]
PORTED = ["whisper-large-v3"]


def _module(name: str):
    mod = name.replace("-", "_").replace(".", "_")
    return importlib.import_module(f"repro_torch.configs.{mod}")


def get_config(name: str, *, smoke: bool = False) -> ModelConfig:
    if name not in ARCHS:
        raise KeyError(f"unknown architecture {name!r} (expected one of {ARCHS})")
    if name not in PORTED:
        raise NotImplementedError(f"{name} is not ported yet (ported: {PORTED})")
    cfg = _module(name).CONFIG
    return smoke_config(cfg) if smoke else cfg
