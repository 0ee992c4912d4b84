"""Base layers of the CNN path: plain functions over parameter dicts.

Port of the dense / conv / pool part of ``repro/models/layers.py``. Public
layouts are the reference's: NHWC activations, HWIO conv weights,
(d_in, d_out) dense weights. ``dense_impl`` / ``conv_impl`` are the
override hooks through which the Origami executor routes tier-1 linear ops
into the Slalom protocol (core/origami.py).
"""
from __future__ import annotations

import contextlib
import math
from typing import Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str                      # "scaled" (normal / sqrt(fan_in)) | "zeros"


def init_params(defs: Dict[str, Dict[str, ParamDef]],
                generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32):
    """Materialize a {layer: {name: ParamDef}} tree with ``generator`` (on
    ``device``): "scaled" leaves are normal / sqrt(fan_in), where fan_in is
    the product of all but the last dim; "zeros" leaves are zero."""
    out = {}
    for layer in sorted(defs):
        out[layer] = {}
        for name in sorted(defs[layer]):
            d = defs[layer][name]
            if d.init == "zeros":
                out[layer][name] = torch.zeros(d.shape, dtype=dtype,
                                               device=device)
                continue
            fan_in = max(math.prod(d.shape[:-1]), 1)
            out[layer][name] = (torch.randn(d.shape, generator=generator,
                                            dtype=torch.float32, device=device)
                                / math.sqrt(fan_in)).to(dtype)
    return out


def dense_def(d_in: int, d_out: int, bias: bool = False):
    d = {"w": ParamDef((d_in, d_out), "scaled")}
    if bias:
        d["b"] = ParamDef((d_out,), "zeros")
    return d


def conv_def(c_in: int, c_out: int, k: int = 3):
    return {"w": ParamDef((k, k, c_in, c_out), "scaled"),
            "b": ParamDef((c_out,), "zeros")}


# Override point: the Origami executor installs the Slalom blinded-offload
# protocol here while running tier-1 (core/origami.py).
_DENSE_IMPL = None
_CONV_IMPL = None


@contextlib.contextmanager
def dense_impl(fn):
    global _DENSE_IMPL
    prev, _DENSE_IMPL = _DENSE_IMPL, fn
    try:
        yield
    finally:
        _DENSE_IMPL = prev


@contextlib.contextmanager
def conv_impl(fn):
    global _CONV_IMPL
    prev, _CONV_IMPL = _CONV_IMPL, fn
    try:
        yield
    finally:
        _CONV_IMPL = prev


def dense(p, x: torch.Tensor) -> torch.Tensor:
    if _DENSE_IMPL is not None:
        return _DENSE_IMPL(p, x)
    y = x @ p["w"].to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def conv2d(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of NHWC ``x`` with an HWIO weight (odd kernel)."""
    if _CONV_IMPL is not None:
        return _CONV_IMPL(p, x, stride)
    assert stride == 1, "SAME padding is implemented for stride 1"
    w = p["w"].to(x.dtype)
    y = F.conv2d(x.permute(0, 3, 1, 2), w.permute(3, 2, 0, 1),
                 padding="same")
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def maxpool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k / stride k VALID max pool of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def set_exact_float(device: Optional[torch.device]) -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card:
    cuDNN's TF32 default would put about 1e-3 relative error into tier-2."""
    if device is not None and torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
