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
    return x.redistribute(mesh, want)


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
