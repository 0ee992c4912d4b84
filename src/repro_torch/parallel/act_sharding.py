"""Logical activation-sharding constraints (MaxText-style rules).

Port of ``repro/parallel/act_sharding.py``. Model code calls
``constrain(x, "batch", "seq", "vocab")`` at the reference's points; under
an active ``activation_rules`` context (the trainer and the dry-run set it
around a step on a mesh) a DTensor is redistributed to the placements the
rules map those logical axes to, with the conflict rules of
``layers.param_specs`` (the first dim wins a mesh axis; a dim whose size
the mapped axes do not divide stays replicated). On a plain tensor, or
with no rules active, it is a no-op, as on the reference's single device.

Where the reference's ``with_sharding_constraint`` leaves a reduction to
GSPMD, ``redistribute`` performs it: a ``Partial`` activation (the output
of a matmul over a sharded contraction) is reduced here.

GSPMD also lays out each product's operands from the whole program;
DTensor picks each op's layout alone, and left to itself it shards a
product's contraction and reduces partial sums over the sequence. Two
more marks in the model code give it the layouts GSPMD would choose:
``for_product`` on a weight before its product (layers.dense, the
embedding and the tied head) gathers it over the mesh axes the rules
split the batch and sequence over (fully sharded data parallel: the
"embed" dim of a train plan's weights is sharded over "data") and keeps
its tensor-parallel shards; ``complete`` on a norm's input sums its
partial sums once, where DTensor would reduce a copy for the statistics
and carry the partial sums on into the next product.

The model code's other DTensor cases use four helpers: ``unflatten_last``
(a flat dim split into heads, gathered first when its shards do not
divide them), ``local_pointwise`` (an elementwise op DTensor has no
strategy for, run on local shards), ``batch_placements`` (the layout of
a ``local_map`` over each rank's own batch rows), ``write_at`` (a
decode step's write into a cache sharded over the sequence, on each
rank's local shard) and ``shard_start`` (where a rank's shard begins:
the context-parallel flash's query offset, ``write_at``'s row).
"""
from __future__ import annotations

import contextlib
from typing import Any, Dict, Optional

import torch

from repro_torch.models import layers as L

_RULES: Optional[Dict[str, Any]] = None
_AXIS_SIZES: Optional[Dict[str, int]] = None
_MESH = None


@contextlib.contextmanager
def activation_rules(rules: Dict[str, Any],
                     axis_sizes: Optional[Dict[str, int]] = None,
                     mesh=None):
    """Rules (and the mesh's axis sizes) for ``constrain``; ``mesh``, the
    mesh the step runs on, for the callers that reduce over one of its
    axes (parallel/compression.py)."""
    global _RULES, _AXIS_SIZES, _MESH
    prev = (_RULES, _AXIS_SIZES, _MESH)
    _RULES, _AXIS_SIZES, _MESH = rules, axis_sizes, mesh
    try:
        yield
    finally:
        _RULES, _AXIS_SIZES, _MESH = prev


def is_dtensor(x) -> bool:
    # a plain tensor's type is torch.Tensor: no import on the hot paths
    if type(x) is torch.Tensor:
        return False
    from torch.distributed.tensor import DTensor
    return isinstance(x, DTensor)


def current_rules() -> Optional[Dict[str, Any]]:
    return _RULES


def current_mesh():
    return _MESH


def constrain(x, *logical: Optional[str]):
    """``x`` laid out by the active logical rules: a DTensor is
    redistributed to their placements; anything else, or any tensor with
    no rules active, comes back as it is."""
    if _RULES is None or not is_dtensor(x):
        return x
    from repro_torch.parallel.sharding import placements_of
    spec = L.resolve_spec(x.shape, logical, _RULES, _AXIS_SIZES)
    mesh = x.device_mesh
    want = placements_of(spec, mesh.mesh_dim_names)
    if tuple(x.placements) == want:
        return x
    return _dense_local(x.redistribute(mesh, want))


class _PinGrad(torch.autograd.Function):
    """The identity; its backward lays the gradient out as the forward's
    value was (``pin_grad``)."""

    @staticmethod
    def forward(ctx, x):
        ctx.placements = tuple(x.placements)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        if tuple(g.placements) != ctx.placements:
            g = g.redistribute(g.device_mesh, ctx.placements)
        return g


def pin_grad(x):
    """``x`` whose gradient comes back in ``x``'s own layout: DTensor may
    hand a product's output gradient on sharded over the sequence, where
    flattening the tokens for the weight's gradient leaves a strided
    shard that a matmul cannot take under fake tensors. A plain tensor
    comes back as it is."""
    if not is_dtensor(x):
        return x
    return _PinGrad.apply(x)


def _dense_local(x):
    """``x`` with a contiguous local shard. Gathering a dim sharded
    unevenly (Whisper's 1500 frames over 16 ranks) pads the shards and
    narrows the result, which leaves a strided local tensor that a later
    view of it (a matmul's flattening) cannot take; such a shard is
    copied."""
    if x._local_tensor.is_contiguous():
        return x
    from torch.distributed.tensor import DTensor
    return DTensor.from_local(x.to_local().contiguous(), x.device_mesh,
                              x.placements, run_check=False, shape=x.shape,
                              stride=x.stride())


def for_product(w):
    """A weight laid out for its product with the activations (module
    docstring): a DTensor is replicated over the mesh axes of the active
    rules' "batch" and "seq" entries; anything else, or any tensor with
    no rules active, comes back as it is."""
    if _RULES is None or not is_dtensor(w):
        return w
    from torch.distributed.tensor import Replicate
    axes = L._mesh_axes(_RULES.get("batch")) + L._mesh_axes(_RULES.get("seq"))
    names = w.device_mesh.mesh_dim_names
    want = tuple(Replicate() if n in axes else pl
                 for n, pl in zip(names, w.placements))
    if tuple(w.placements) == want:
        return w
    return w.redistribute(w.device_mesh, want)


def complete(x):
    """``x`` with its partial sums (a row-parallel product's output)
    summed over the mesh, its shards kept; anything else as it is."""
    pl = getattr(x, "placements", None)
    if pl is None or not any(q.is_partial() for q in pl):
        return x
    from torch.distributed.tensor import Replicate
    return x.redistribute(x.device_mesh, [Replicate() if q.is_partial()
                                          else q for q in pl])


def unflatten_last(x, shape):
    """``x`` (..., prod(shape)) viewed as (..., *shape). A DTensor whose
    last dim is sharded over mesh dims that do not divide ``shape[0]``
    (SmolLM's 3 KV heads over 2 ranks, xLSTM's 4 heads over 16) is first
    replicated over them: a view cannot split a shard unevenly."""
    if is_dtensor(x):
        from torch.distributed.tensor import Replicate, Shard
        last = x.dim() - 1
        mesh = x.device_mesh
        over = [i for i, pl in enumerate(x.placements) if pl == Shard(last)]
        n = 1
        for i in over:
            n *= mesh.shape[i]
        if shape[0] % n:
            x = x.redistribute(mesh, [Replicate() if i in over else pl
                                      for i, pl in enumerate(x.placements)])
    return x.reshape(tuple(x.shape[:-1]) + tuple(shape))


def local_pointwise(fn, x):
    """An elementwise ``fn`` of a DTensor ``x`` run on each rank's local
    shard through ``local_map`` (forward and backward), for an op DTensor
    has no strategy for: partial sums are reduced first, and a dim whose
    shards would be uneven is gathered."""
    from torch.distributed.tensor import Replicate
    from torch.distributed.tensor.experimental import local_map
    mesh = x.device_mesh
    ways = {}
    for i, pl in enumerate(x.placements):
        if pl.is_shard():
            ways[pl.dim] = ways.get(pl.dim, 1) * mesh.shape[i]
    place = tuple(Replicate() if pl.is_partial() or (
        pl.is_shard() and x.shape[pl.dim] % ways[pl.dim]) else pl
        for pl in x.placements)
    return local_map(fn, out_placements=(place,), in_placements=(place,),
                     device_mesh=mesh, redistribute_inputs=True)(x)


def write_at(cache, at, new, dim: int = 1):
    """``cache.index_copy_(dim, at, new)`` in place (``at`` a one-element
    long tensor, ``new`` of size 1 along ``dim``); returns ``cache``. On a
    DTensor cache each rank writes its local shard at ``at`` less the
    shard's offset along ``dim``, and a rank whose shard does not hold
    ``at`` writes its own row back: the cache keeps its placements.
    (DTensor's own ``index_copy_`` relabels a cache sharded over the
    sequence as sharded over its next dim, leaving a local shard that no
    longer matches its placements.)"""
    if not is_dtensor(cache):
        return cache.index_copy_(dim, at, new)
    from torch.distributed.tensor import DTensor, Replicate
    mesh = cache.device_mesh
    want = tuple(Replicate() if pl.is_partial()
                 or (pl.is_shard() and pl.dim == dim) else pl
                 for pl in cache.placements)
    if is_dtensor(new):
        new = new.redistribute(mesh, want)
    else:
        new = DTensor.from_local(new, mesh, [Replicate()] * mesh.ndim,
                                 run_check=False).redistribute(mesh, want)
    if is_dtensor(at):
        at = at.full_tensor()
    local = cache.to_local()
    start = shard_start(cache.shape[dim], cache.placements, mesh, dim)
    n = local.shape[dim]
    if n == 0:           # a shard past the cache's end holds no row
        return cache
    at = at - start
    inside = (at >= 0) & (at < n)
    at = at.clamp(0, n - 1)
    local.index_copy_(dim, at, torch.where(inside, new.to_local(),
                                           local.index_select(dim, at)))
    return cache


def shard_start(size: int, placements, mesh, dim: int) -> int:
    """The global index of this rank's first element along ``dim`` (of
    ``size``) of a DTensor laid out by ``placements`` on ``mesh``: its
    shard's start, mesh dim by mesh dim in placement order (torch.chunk's
    split, as DTensor's Shard)."""
    start, coord = 0, mesh.get_coordinate()
    for i, pl in enumerate(placements):
        if pl.is_shard() and pl.dim == dim:
            chunk = -(-size // mesh.size(i))
            lo = min(coord[i] * chunk, size)
            size, start = min(size - lo, chunk), start + lo
    return start


def batch_placements(mesh, rows: int, dim: int = 0):
    """DTensor placements that shard ``dim`` (of ``rows`` rows) over the
    active rules' batch axes when they divide it, and replicate
    everything else."""
    from torch.distributed.tensor import Replicate, Shard
    names = mesh.mesh_dim_names
    batch = [a for a in L._mesh_axes((_RULES or {}).get("batch"))
             if a in names]
    n = 1
    for a in batch:
        n *= mesh.shape[names.index(a)]
    split = rows % n == 0
    return tuple(Shard(dim) if a in batch and split else Replicate()
                 for a in names)
