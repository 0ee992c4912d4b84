"""Config registry of the port: the paper's two CNNs, the dense LM and
the two mixture-of-experts LMs.

``get_config(name)`` returns the published configuration;
``get_smoke(name)`` a reduced same-family one for CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import ModelConfig, MoEConfig, OrigamiConfig

PAPER_MODELS = ("vgg16", "vgg19")
ARCHS = ("smollm_135m", "qwen3_moe_235b", "arctic_480b")
ALIASES = {"vgg-16": "vgg16", "vgg-19": "vgg19",
           "smollm-135m": "smollm_135m",
           "qwen3-moe-235b-a22b": "qwen3_moe_235b",
           "arctic-480b": "arctic_480b"}


def _module(name: str):
    name = ALIASES.get(name, name)
    if name not in PAPER_MODELS + ARCHS:
        raise KeyError(f"unknown model {name!r}; the port carries "
                       f"{PAPER_MODELS + ARCHS}")
    return importlib.import_module(f"repro_torch.configs.{name}")


def get_config(name: str) -> ModelConfig:
    return _module(name).CONFIG


def get_smoke(name: str) -> ModelConfig:
    return _module(name).smoke_config()


__all__ = ["ARCHS", "PAPER_MODELS", "ModelConfig", "MoEConfig",
           "OrigamiConfig", "get_config", "get_smoke"]
