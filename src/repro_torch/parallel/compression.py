"""Gradient compression: int8 quantization with error feedback.

Port of ``repro/parallel/compression.py`` on tensors and nested dicts of
tensors (core/tree.py). For a cross-pod gradient reduction the
inter-pod link, not the intra-pod one, is the bottleneck, so gradients
travel int8-quantized (4x fewer bytes than float32) and the quantization
residual is carried into the next step (error feedback), which keeps
SGD/Adam convergence unchanged to first order (Karimireddy et al. 2019).
Per-tensor absmax scales travel beside them. The arithmetic is the
reference's, operation for operation, so the results are bit-equal.

``compressed_psum`` is the int8 all-reduce over one axis of a device
mesh (launch/mesh.py): each rank quantizes its own tensor, the int8
values are summed as int32 and the scales reduced by max over that
axis's process group, and the sum is dequantized with the max scale, the
reference's ``psum``/``pmax`` inside ``shard_map``.
"""
from __future__ import annotations

from typing import Any, Tuple

import torch

from repro_torch.core.tree import tree_map
from repro_torch.parallel import act_sharding as ash


def quantize_int8(x: torch.Tensor) -> Tuple[torch.Tensor, torch.Tensor]:
    xf = x.to(torch.float32)
    scale = torch.clamp_min(torch.max(torch.abs(xf)), 1e-12) / 127.0
    q = torch.clamp(torch.round(xf / scale), -127, 127).to(torch.int8)
    return q, scale


def dequantize_int8(q: torch.Tensor, scale: torch.Tensor) -> torch.Tensor:
    return q.to(torch.float32) * scale


def compress_decompress(x: torch.Tensor) -> torch.Tensor:
    """The quantization round trip (what the wire sees)."""
    q, s = quantize_int8(x)
    return dequantize_int8(q, s)


def apply_error_feedback(grads: Any, residual: Any) -> Tuple[Any, Any]:
    """grads, residual -> (compressed grads, new residual).

    compressed = Q(g + r);  r' = (g + r) - compressed.
    """
    def one(g, r):
        gf = g.to(torch.float32) + r
        c = compress_decompress(gf)
        return c.to(g.dtype), gf - c

    out = tree_map(one, grads, residual)
    return tree_map(lambda t: t[0], out), tree_map(lambda t: t[1], out)


def init_residual(grads_like: Any) -> Any:
    return tree_map(lambda g: torch.zeros(g.shape, dtype=torch.float32,
                                          device=g.device), grads_like)


def compressed_psum(x: torch.Tensor, axis_name: str,
                    mesh=None) -> torch.Tensor:
    """int8 all-reduce of each rank's ``x`` over mesh axis ``axis_name``
    of ``mesh`` (default: the mesh of the active ``activation_rules``):
    quantize locally, sum int32, dequantize with the max scale
    (conservative)."""
    import torch.distributed as dist
    mesh = mesh if mesh is not None else ash.current_mesh()
    if mesh is None:
        raise ValueError("compressed_psum needs a mesh: pass mesh= or run "
                         "under activation_rules(..., mesh=)")
    group = mesh.get_group(axis_name)
    q, s = quantize_int8(x)
    total = q.to(torch.int32)
    smax = s.clone()
    dist.all_reduce(total, op=dist.ReduceOp.SUM, group=group)
    dist.all_reduce(smax, op=dist.ReduceOp.MAX, group=group)
    return total.to(torch.float32) * smax
