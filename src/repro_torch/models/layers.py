"""Base layers: plain functions over parameter dicts.

Port of ``repro/models/layers.py``: the dense / conv / pool part the CNN
path runs and the LM part (RMS/layer norm in float32, embedding, the
activations, rotary and sinusoidal position embeddings), the
cross-entropy loss, ``param_count`` and ``init_params_keyed``, the
reference's initializer driven by a jax-style key, and ``param_specs``,
which turns the same definition tree into a ``PartitionSpec`` tree by
logical-to-mesh rules (parallel/sharding.py). The stacking axes
("layers", and "experts" of a MoE bank) stay out of a leaf's fan-in, and
a leaf's own dtype (the float32 norms, MoE router and Mamba2 ``A_log``,
``D`` and ``dt_bias``) survives the model dtype. ``conv2d`` pads as XLA's
SAME does for any stride and kernel size.
Public layouts are the reference's: NHWC activations, HWIO conv weights,
(d_in, d_out) dense weights, (..., seq, heads, head_dim) rope inputs.
``dense_impl`` / ``conv_impl`` are the override hooks through which the
Origami executor routes tier-1 linear ops into the Slalom protocol
(core/origami.py).
"""
from __future__ import annotations

import contextlib
import math
from typing import Any, Dict, NamedTuple, Optional, Tuple

import torch
import torch.nn.functional as F

from repro_torch.core import prng
from repro_torch.core.tree import tree_leaves, tree_map
from repro_torch.parallel import act_sharding as ash

# stacking axes: not part of a leaf's fan-in
_STACK_AXES = ("layers", "experts")


class ParamDef(NamedTuple):
    shape: Tuple[int, ...]
    init: str                      # normal | zeros | ones | embed | scaled
    axes: Tuple[Optional[str], ...] = ()   # logical axis name per dim
    dtype: Any = None              # overrides the model dtype (f32 norms)


def is_def(x) -> bool:
    return isinstance(x, ParamDef)


def _fan_in(d: ParamDef) -> int:
    """Product of the non-output dims, stacking axes excluded (the
    reference's rule); a 1-D leaf's fan-in is its length."""
    if len(d.shape) <= 1:
        return max(d.shape[-1] if d.shape else 1, 1)
    axes = d.axes or (None,) * len(d.shape)
    n = 1
    for dim, ax in zip(d.shape[:-1], axes[:-1]):
        if ax not in _STACK_AXES:
            n *= dim
    return max(n, 1)


def init_params(defs, generator: torch.Generator, device="cuda",
                dtype: torch.dtype = torch.float32):
    """Materialize a nested {name: ... ParamDef} tree with ``generator``
    (on ``device``), walking keys in sorted order: "zeros"/"ones" are
    constant, "normal"/"embed" are normal * 0.02, "scaled" is normal /
    sqrt(fan_in). A leaf's own ``dtype`` overrides ``dtype``."""
    if is_def(defs):
        d = defs
        dt = d.dtype or dtype
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(d.shape, dtype=dt, device=device)
        z = torch.randn(d.shape, generator=generator, dtype=torch.float32,
                        device=device)
        if d.init == "scaled":
            return (z / math.sqrt(_fan_in(d))).to(dt)
        if d.init in ("normal", "embed"):
            return (z * 0.02).to(dt)
        raise ValueError(f"unknown init {d.init!r}")
    return {name: init_params(defs[name], generator, device, dtype)
            for name in sorted(defs)}


def init_params_keyed(key, defs, dtype: torch.dtype = torch.float32,
                      device="cuda"):
    """The reference's ``init_params(key, defs, dtype)``: ``prng.split``
    gives one key per leaf in flatten order (dict keys sorted), and
    "zeros"/"ones" leaves use up theirs too; the others are
    ``prng.normal`` times 0.02 ("normal", "embed") or 1/sqrt(fan_in)
    ("scaled"), cast to the leaf's dtype. The same key gives the
    reference's parameters, to the few ulps ``prng.normal`` allows."""
    keys = iter(prng.split(key, max(len(tree_leaves(defs)), 1)))

    def build(d):
        k = next(keys)
        dt = d.dtype or dtype
        if d.init in ("zeros", "ones"):
            fill = torch.zeros if d.init == "zeros" else torch.ones
            return fill(d.shape, dtype=dt, device=device)
        scale = {"normal": 0.02, "embed": 0.02,
                 "scaled": 1.0 / math.sqrt(_fan_in(d))}[d.init]
        return (prng.normal(k, d.shape, device=device) * scale).to(dt)

    return tree_map(build, defs)


class PartitionSpec(tuple):
    """The mesh axes of each dim of a tensor: a mesh axis name, a tuple of
    them (the dim sharded over both, the first major) or None
    (replicated). A tuple, so it equals the reference's
    ``jax.sharding.PartitionSpec`` of the same entries."""

    def __new__(cls, *entries):
        return super().__new__(cls, entries)

    def __repr__(self):
        return f"PartitionSpec{tuple.__repr__(self)}"


def _mesh_axes(m) -> Tuple[str, ...]:
    """A rule's or spec entry's mesh axes as a tuple."""
    return tuple(m) if isinstance(m, (tuple, list)) else (m,) if m else ()


def resolve_spec(shape, logical, rules, axis_sizes=None) -> PartitionSpec:
    """The spec of a tensor of ``shape`` whose dims carry the ``logical``
    axis names, under logical->mesh ``rules``: a mesh axis goes to the
    first dim that asks for it, and with ``axis_sizes`` given a dim its
    axes do not divide stays replicated."""
    used = set()
    out = []
    for dim, a in zip(shape, logical):
        m = rules.get(a) if a else None
        ms = _mesh_axes(m)
        if any(x in used for x in ms):
            out.append(None)
            continue
        if axis_sizes is not None and ms:
            total = math.prod(axis_sizes.get(x, 1) for x in ms)
            if total == 0 or dim % total != 0:
                out.append(None)
                continue
        used.update(ms)
        out.append(m)
    return PartitionSpec(*out)


def param_specs(defs, rules: Dict[str, Any],
                axis_sizes: Optional[Dict[str, int]] = None):
    """ParamDef tree -> PartitionSpec tree under logical->mesh ``rules``
    (the reference's conflict rules, ``resolve_spec``): when two logical
    axes of one leaf map to one mesh axis (a MoE bank's ("experts",
    "embed", "ffn") with experts and ffn on "model"), the first keeps it;
    a dim its mesh axes do not divide (xLSTM's 4/3 projections) is
    replicated."""
    return tree_map(lambda d: resolve_spec(d.shape, d.axes, rules,
                                           axis_sizes), defs)


def param_count(defs) -> int:
    """Elements of every leaf of a definition tree (nothing allocated)."""
    return sum(math.prod(d.shape) for d in tree_leaves(defs))


def dense_def(d_in: int, d_out: int, axes=("embed", "ffn"),
              bias: bool = False):
    d = {"w": ParamDef((d_in, d_out), "scaled", tuple(axes))}
    if bias:
        d["b"] = ParamDef((d_out,), "zeros", (axes[1],))
    return d


def conv_def(c_in: int, c_out: int, k: int = 3):
    return {"w": ParamDef((k, k, c_in, c_out), "scaled",
                          (None, None, None, "ffn")),
            "b": ParamDef((c_out,), "zeros", ("ffn",))}


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
    y = x @ ash.for_product(p["w"]).to(x.dtype)
    if "b" in p:
        y = y + p["b"].to(x.dtype)
    return y


def _same_pads(size: int, k: int, stride: int) -> Tuple[int, int]:
    """XLA's SAME padding of one spatial dim: ceil(size / stride) outputs,
    the total pad split with the smaller half before."""
    out = -(-size // stride)
    total = max((out - 1) * stride + k - size, 0)
    return total // 2, total - total // 2


def conv2d(p, x: torch.Tensor, stride: int = 1) -> torch.Tensor:
    """SAME convolution of NHWC ``x`` with an HWIO weight, XLA's padding
    for any stride and kernel size."""
    if _CONV_IMPL is not None:
        return _CONV_IMPL(p, x, stride)
    w = p["w"].to(x.dtype)
    kh, kw = w.shape[0], w.shape[1]
    xc = x.permute(0, 3, 1, 2)
    wc = w.permute(3, 2, 0, 1)
    if stride == 1 and kh % 2 == 1 and kw % 2 == 1:
        y = F.conv2d(xc, wc, padding="same")
    else:
        top, bottom = _same_pads(x.shape[1], kh, stride)
        left, right = _same_pads(x.shape[2], kw, stride)
        y = F.conv2d(F.pad(xc, (left, right, top, bottom)), wc,
                     stride=stride)
    return y.permute(0, 2, 3, 1) + p["b"].to(x.dtype)


def norm_def(dim: int, kind: str) -> Dict[str, ParamDef]:
    d = {"scale": ParamDef((dim,), "ones", ("embed",), torch.float32)}
    if kind == "layernorm":
        d["bias"] = ParamDef((dim,), "zeros", ("embed",), torch.float32)
    return d


def apply_norm(p, x: torch.Tensor, kind: str, eps: float = 1e-6):
    """RMS or layer norm over the last dim, computed in float32 and cast
    back to ``x.dtype``."""
    xf = ash.complete(x).to(torch.float32)
    if kind == "rmsnorm":
        y = xf * torch.rsqrt(torch.mean(xf * xf, dim=-1, keepdim=True) + eps)
    else:
        mu = torch.mean(xf, dim=-1, keepdim=True)
        var = torch.mean(torch.square(xf - mu), dim=-1, keepdim=True)
        y = (xf - mu) * torch.rsqrt(var + eps)
    y = y * p["scale"]
    if "bias" in p:
        y = y + p["bias"]
    return y.to(x.dtype)


def embed_def(vocab: int, dim: int) -> Dict[str, ParamDef]:
    return {"table": ParamDef((vocab, dim), "embed", ("vocab", "embed"))}


def embed_lookup(p, ids: torch.Tensor) -> torch.Tensor:
    return ash.for_product(p["table"])[ids]


def activation(name: str):
    """The reference's activations; its gelu is jax.nn.gelu's default,
    the tanh approximation."""
    return {"silu": F.silu,
            "gelu": lambda x: F.gelu(x, approximate="tanh"),
            "relu": torch.relu}[name]


def rope_freqs(head_dim: int, theta: float, device=None) -> torch.Tensor:
    return 1.0 / (theta ** (torch.arange(0, head_dim, 2, dtype=torch.float32,
                                         device=device) / head_dim))


def apply_rope(x: torch.Tensor, positions: torch.Tensor,
               theta: float) -> torch.Tensor:
    """x: (..., seq, heads, head_dim); positions: (..., seq)."""
    hd = x.shape[-1]
    freqs = rope_freqs(hd, theta, device=x.device)
    ang = positions[..., :, None].to(torch.float32) * freqs
    cos = torch.cos(ang)[..., :, None, :]          # broadcast over heads
    sin = torch.sin(ang)[..., :, None, :]
    x1, x2 = torch.chunk(x.to(torch.float32), 2, dim=-1)
    out = torch.cat([x1 * cos - x2 * sin, x1 * sin + x2 * cos], dim=-1)
    return out.to(x.dtype)


def sinusoidal_positions(seq: int, dim: int, device=None) -> torch.Tensor:
    """(seq, dim) float32: sin at the even columns, cos at the odd ones."""
    pos = torch.arange(seq, dtype=torch.float32, device=device)[:, None]
    div = torch.exp(torch.arange(0, dim, 2, dtype=torch.float32,
                                 device=device) * (-math.log(10000.0) / dim))
    pe = torch.zeros((seq, dim), dtype=torch.float32, device=device)
    pe[:, 0::2] = torch.sin(pos * div)
    pe[:, 1::2] = torch.cos(pos * div)
    return pe


def maxpool2d(x: torch.Tensor, k: int = 2) -> torch.Tensor:
    """k x k / stride k VALID max pool of NHWC ``x``."""
    return F.max_pool2d(x.permute(0, 3, 1, 2), k, k).permute(0, 2, 3, 1)


def cross_entropy(logits: torch.Tensor, labels: torch.Tensor,
                  vocab_size: int) -> torch.Tensor:
    """Mean cross-entropy; ``logits`` may be over a padded vocab, whose
    pad columns are masked with -1e9."""
    logits = logits.to(torch.float32)
    if logits.shape[-1] > vocab_size:
        pad = logits.shape[-1] - vocab_size
        mask = torch.cat([
            torch.zeros(vocab_size, dtype=torch.float32,
                        device=logits.device),
            torch.full((pad,), -1e9, dtype=torch.float32,
                       device=logits.device)])
        logits = logits + mask
    lse = torch.logsumexp(logits, dim=-1)
    iota = torch.arange(logits.shape[-1], device=logits.device)
    ll = torch.sum(torch.where(iota == labels[..., None], logits, 0.0),
                   dim=-1)
    return torch.mean(lse - ll)


def set_exact_float(device: Optional[torch.device]) -> None:
    """Keep float32 convolutions and matmuls in full float32 on the card:
    cuDNN's TF32 default would put about 1e-3 relative error into tier-2."""
    if device is not None and torch.device(device).type == "cuda":
        torch.backends.cudnn.allow_tf32 = False
        torch.backends.cuda.matmul.allow_tf32 = False
