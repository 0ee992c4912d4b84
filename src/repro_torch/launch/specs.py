"""Abstract input specs per (arch x shape) cell.

Port of ``repro/launch/specs.py``: the reference's ``ShapeDtypeStruct``
trees are tensors on the ``meta`` device here, with the same shapes and
dtypes, and nothing is allocated: parameters from
``models/model.py:abstract_params``, AdamW state from ``adamw.init`` over
them, caches from ``init_caches`` on ``meta``. The frontend stubs of the
audio and vlm archs provide frame and patch embeddings, as the
reference's. The dry-run (launch/dryrun.py) lays these out on a mesh.
"""
from __future__ import annotations

from typing import Any, Dict, Tuple

import torch

from repro_torch.configs.base import ModelConfig, ShapeConfig, TrainConfig
from repro_torch.models import model as M
from repro_torch.optim import adamw

META = torch.device("meta")


def abstract_batch(cfg: ModelConfig, shape: ShapeConfig,
                   seq_len: int = None) -> Dict[str, torch.Tensor]:
    B = shape.global_batch
    S = seq_len if seq_len is not None else shape.seq_len
    batch = {"tokens": torch.empty((B, S), dtype=torch.int32, device=META)}
    dt = M.torch_dtype(cfg.dtype)
    if cfg.family == "audio":
        batch["frames"] = torch.empty((B, cfg.encoder_seq_len, cfg.d_model),
                                      dtype=dt, device=META)
    if cfg.family == "vlm":
        batch["patches"] = torch.empty((B, cfg.vision_seq_len, cfg.d_model),
                                       dtype=dt, device=META)
    return batch


def abstract_caches(cfg: ModelConfig, shape: ShapeConfig):
    return M.init_caches(cfg, shape.global_batch, shape.seq_len, device=META)


def input_specs(cfg: ModelConfig, shape: ShapeConfig,
                tcfg: TrainConfig = None) -> Tuple[str, Tuple[Any, ...]]:
    """Returns (step_kind, abstract argument tuple) for the cell."""
    params = M.abstract_params(cfg)
    if shape.kind == "train":
        tcfg = tcfg or TrainConfig()
        return "train", (params, adamw.init(params, tcfg),
                         abstract_batch(cfg, shape))
    if shape.kind == "prefill":
        return "prefill", (params, abstract_batch(cfg, shape))
    # decode: one new token against a seq_len-sized cache
    token = torch.empty((shape.global_batch, 1), dtype=torch.int32,
                        device=META)
    pos = torch.empty((), dtype=torch.int32, device=META)
    return "decode", (params, token, abstract_caches(cfg, shape), pos)
