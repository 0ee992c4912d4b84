"""VGG-16/19 (the paper's evaluation models), NHWC, PyTorch.

Port of ``repro/models/vgg.py``. ``vgg_forward(..., capture=k)`` also
returns the feature map after layer ``k`` (1-based, the paper's layer
numbering). ``params_from_numpy`` carries the reference's
``{"l0": {"w", "b"}, ...}`` numpy parameters across to torch tensors on a
device, and ``params_to_numpy`` back.
"""
from __future__ import annotations

from typing import Dict, List, Optional, Tuple

import numpy as np
import torch

from repro_torch.configs.base import ModelConfig
from repro_torch.models import layers as L


def _parse(spec: str) -> Tuple[str, int]:
    for prefix in ("conv", "fc"):
        if spec.startswith(prefix):
            return prefix, int(spec[len(prefix):])
    return spec, 0


def layer_kind(cfg: ModelConfig, i: int) -> Tuple[str, int]:
    """(kind, width) of layer ``i`` — "conv" | "pool" | "fc" | "logits"."""
    return _parse(cfg.cnn_layers[i])


def feature_shapes(cfg: ModelConfig) -> List[Tuple[int, ...]]:
    """Shape (H, W, C), or (features,) once flat, entering each layer."""
    h = w = cfg.image_size
    c = cfg.image_channels
    shapes = []
    flat = None
    for spec in cfg.cnn_layers:
        kind, n = _parse(spec)
        shapes.append((h, w, c) if flat is None else (flat,))
        if kind == "conv":
            c = n
        elif kind == "pool":
            h, w = h // 2, w // 2
        elif kind == "fc":
            flat = n
        elif kind == "logits":
            flat = cfg.num_classes
    return shapes


def vgg_defs(cfg: ModelConfig) -> Dict[str, Dict[str, L.ParamDef]]:
    h = w = cfg.image_size
    c = cfg.image_channels
    defs = {}
    flat = None
    for i, spec in enumerate(cfg.cnn_layers):
        kind, n = _parse(spec)
        if kind == "conv":
            defs[f"l{i}"] = L.conv_def(c, n)
            c = n
        elif kind == "pool":
            h, w = h // 2, w // 2
        elif kind in ("fc", "logits"):
            d_out = n if kind == "fc" else cfg.num_classes
            flat_in = flat if flat is not None else h * w * c
            defs[f"l{i}"] = L.dense_def(flat_in, d_out, bias=True)
            flat = d_out
        else:
            raise ValueError(spec)
    return defs


def init_params(cfg: ModelConfig, seed: int, device="cuda"):
    """Random parameters from a seeded ``torch.Generator`` on ``device``."""
    gen = torch.Generator(device=device)
    gen.manual_seed(seed)
    return L.init_params(vgg_defs(cfg), gen, device=device)


def params_from_numpy(tree, device="cuda"):
    """Reference numpy parameters {"l0": {"w", "b"}, ...} -> tensors."""
    return {layer: {name: torch.from_numpy(np.array(v)).to(device)
                    for name, v in leaves.items()}
            for layer, leaves in tree.items()}


def params_to_numpy(params):
    """Tensors -> numpy arrays of the same tree (for the reference)."""
    return {layer: {name: v.detach().cpu().numpy()
                    for name, v in leaves.items()}
            for layer, leaves in params.items()}


def apply_layer(params, x: torch.Tensor, cfg: ModelConfig, i: int):
    kind, _ = _parse(cfg.cnn_layers[i])
    if kind == "conv":
        return torch.relu(L.conv2d(params[f"l{i}"], x))
    if kind == "pool":
        return L.maxpool2d(x)
    if x.dim() > 2:
        x = x.reshape(x.shape[0], -1)
    if kind == "fc":
        return torch.relu(L.dense(params[f"l{i}"], x))
    if kind == "logits":
        return L.dense(params[f"l{i}"], x)
    raise ValueError(kind)


def apply_layer_range(params, x: torch.Tensor, cfg: ModelConfig, lo: int,
                      hi: int):
    for i in range(lo, hi):
        x = apply_layer(params, x, cfg, i)
    return x


def layer_program(cfg: ModelConfig):
    """(prologue, segment, epilogue) — the CNN layer iterator the plan
    interpreter walks (core/plan.py:program_for)."""
    def prologue(params, batch):
        return batch["images"], None

    def segment(params, x, lo, hi, memory=None):
        return apply_layer_range(params, x, cfg, lo, hi)

    def epilogue(params, x, batch, memory=None):
        return x

    return prologue, segment, epilogue


def blinded_op_records(params, cfg: ModelConfig, layer_ids, batch_size: int):
    """Static blinded-op records for BlindedLayerCache.from_records: conv
    layers give their im2col shape (t = B*H*W, d_in = kh*kw*cin) with the
    raw HWIO weight; fc/logits layers give (t = B, d_in, d_out)."""
    shapes = feature_shapes(cfg)
    records = []
    for i in layer_ids:
        kind, _ = _parse(cfg.cnn_layers[i])
        w = params[f"l{i}"]["w"]
        if kind == "conv":
            h, wd, _c = shapes[i]
            kh, kw, cin, cout = w.shape
            records.append({"kind": "conv", "w": w,
                            "t": batch_size * h * wd,
                            "d_in": kh * kw * cin, "d_out": cout})
        elif kind in ("fc", "logits"):
            d_in, d_out = w.shape
            records.append({"kind": "dense", "w": w, "t": batch_size,
                            "d_in": d_in, "d_out": d_out})
        else:
            raise ValueError(f"layer {i} ({kind}) has no blinded op")
    return records


def vgg_forward(params, images: torch.Tensor, cfg: ModelConfig,
                capture: Optional[int] = None):
    """images: (B, H, W, C). capture: 1-based layer index to also return."""
    x = images
    captured = None
    for i in range(len(cfg.cnn_layers)):
        x = apply_layer(params, x, cfg, i)
        if capture is not None and i == capture - 1:
            captured = x
    return (x, captured) if capture is not None else x
