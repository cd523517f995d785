"""Architecture registry of the port: ``get_config(arch_id)``.

The JAX package's ten archs, every family of it (dense, moe, ssm,
hybrid, vlm, audio); any other id raises ``KeyError``.
"""
from __future__ import annotations

import importlib

from .base import (AttnConfig, EncoderConfig, MambaConfig, MLAConfig,
                   ModelConfig, MoEConfig, VisionConfig)

ARCHS = ("deepseek-v2-lite-16b", "jamba-1.5-large-398b",
         "llama-3.2-vision-11b", "llama3-8b", "mamba2-130m", "qwen3-0.6b",
         "qwen3-4b", "qwen3-moe-30b-a3b", "stablelm-3b", "whisper-medium")

__all__ = ["ARCHS", "AttnConfig", "EncoderConfig", "MLAConfig",
           "MambaConfig", "ModelConfig", "MoEConfig", "VisionConfig",
           "get_config", "get_smoke_config"]


def _module(arch: str):
    if arch not in ARCHS:
        raise KeyError(f"unknown arch {arch!r}; available: {ARCHS}")
    name = arch.replace("-", "_").replace(".", "_")
    return importlib.import_module(f".{name}", __package__)


def get_config(arch: str) -> ModelConfig:
    return _module(arch).CONFIG


def get_smoke_config(arch: str) -> ModelConfig:
    """Reduced variant of the same family for CPU tests."""
    return _module(arch).smoke()
