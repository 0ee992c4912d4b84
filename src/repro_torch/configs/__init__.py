"""Config registry of the port: the paper's two CNNs, the dense LMs (GQA
and, for MiniCPM3, latent attention), the two mixture-of-experts LMs, the
hybrid Zamba2 (Mamba2 with a shared attention block), the recurrent
xLSTM, and the cross-attention families: Llama-3.2-Vision (gated image
blocks over patch embeddings) and the encoder-decoder Whisper.

``get_config(name)`` returns the published configuration;
``get_smoke(name)`` a reduced same-family one for CPU tests;
``applicable_shapes(name)`` the shape cells of an arch and
``SKIPPED_CELLS`` those left out by design, as the reference's (the
dry-run, launch/dryrun.py, walks them).
"""
from __future__ import annotations

import importlib

from typing import List

from repro_torch.configs.base import (SHAPES, MLAConfig, MeshConfig,
                                      ModelConfig, MoEConfig, OrigamiConfig,
                                      ShapeConfig, SSMConfig, TrainConfig)

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


def applicable_shapes(name: str) -> List[str]:
    """The shape cells of an arch: long_500k only for the sub-quadratic
    (SSM and hybrid) families."""
    shapes = ["train_4k", "prefill_32k", "decode_32k"]
    if get_config(name).family in ("ssm", "hybrid"):
        shapes.append("long_500k")
    return shapes


SKIPPED_CELLS = [
    (a, "long_500k", "pure full-attention arch; no sub-quadratic variant in "
     "published config")
    for a in ARCHS
    if get_config(a).family not in ("ssm", "hybrid")
]

__all__ = ["ARCHS", "PAPER_MODELS", "SHAPES", "SKIPPED_CELLS", "MLAConfig",
           "MeshConfig", "ModelConfig", "MoEConfig", "OrigamiConfig",
           "SSMConfig", "ShapeConfig", "TrainConfig", "applicable_shapes",
           "get_config", "get_smoke"]
