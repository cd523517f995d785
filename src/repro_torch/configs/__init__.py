"""Architecture registry of the port: ``get_config(arch_id)``.

Only the archs whose families the port serves are here; any other arch
id of the JAX package raises ``KeyError`` (ROADMAP queue 1, item 16).
"""
from __future__ import annotations

import importlib

from .base import (AttnConfig, EncoderConfig, MambaConfig, MLAConfig,
                   ModelConfig, MoEConfig, VisionConfig)

ARCHS = ("deepseek-v2-lite-16b", "llama-3.2-vision-11b", "llama3-8b",
         "mamba2-130m", "qwen3-0.6b", "qwen3-4b", "qwen3-moe-30b-a3b",
         "stablelm-3b", "whisper-medium")

__all__ = ["ARCHS", "AttnConfig", "EncoderConfig", "MLAConfig",
           "MambaConfig", "ModelConfig", "MoEConfig", "VisionConfig",
           "get_config", "get_smoke_config"]


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"arch {arch!r} is not ported yet (ROADMAP queue 1, "
                       f"item 16); the port serves {ARCHS}")
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family for CPU tests."""
    return _module(arch).smoke()
