"""Config registry of the port: the paper's two CNNs, the dense LMs (GQA
and, for MiniCPM3, latent attention), the two mixture-of-experts LMs, the
hybrid Zamba2 (Mamba2 with a shared attention block), the recurrent
xLSTM, and the cross-attention families: Llama-3.2-Vision (gated image
blocks over patch embeddings) and the encoder-decoder Whisper.

``get_config(name)`` returns the published configuration;
``get_smoke(name)`` a reduced same-family one for CPU tests.
"""
from __future__ import annotations

import importlib

from repro_torch.configs.base import (MLAConfig, ModelConfig, MoEConfig,
                                      OrigamiConfig, SSMConfig)

PAPER_MODELS = ("vgg16", "vgg19")
ARCHS = ("qwen2_5_14b", "yi_9b", "minicpm3_4b", "smollm_135m",
         "qwen3_moe_235b", "arctic_480b", "zamba2_1_2b", "xlstm_1_3b",
         "llama3_2_vision_11b", "whisper_small")
ALIASES = {"vgg-16": "vgg16", "vgg-19": "vgg19",
           "qwen2.5-14b": "qwen2_5_14b", "yi-9b": "yi_9b",
           "minicpm3-4b": "minicpm3_4b", "smollm-135m": "smollm_135m",
           "qwen3-moe-235b-a22b": "qwen3_moe_235b",
           "arctic-480b": "arctic_480b", "zamba2-1.2b": "zamba2_1_2b",
           "xlstm-1.3b": "xlstm_1_3b",
           "llama-3.2-vision-11b": "llama3_2_vision_11b",
           "whisper-small": "whisper_small"}


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


__all__ = ["ARCHS", "PAPER_MODELS", "MLAConfig", "ModelConfig", "MoEConfig",
           "OrigamiConfig", "SSMConfig", "get_config", "get_smoke"]
