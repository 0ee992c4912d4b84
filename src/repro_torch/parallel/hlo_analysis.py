"""Per-device step analysis: collective bytes, matmul operations, traffic.

The torch counterpart of ``repro/parallel/hlo_analysis.py``. The port has
no HLO: a step is eager PyTorch over DTensors, and DTensor turns each op
on a sharded tensor into ops on each rank's local shards plus the
collectives its redistributions need. ``analyze_step(fn, *args)`` runs a
step once under a dispatch mode that sees exactly those local ops (it
steps aside for DTensor-level ops, so DTensor dispatches them to the local
shards and the mode sees what one rank executes) and counts:

1. **Collective traffic**: the result bytes of every functional collective
   a rank runs, under the reference's kind names (``all_reduce`` ->
   "all-reduce", ``all_gather_into_tensor`` -> "all-gather",
   ``reduce_scatter_tensor`` -> "reduce-scatter", ``all_to_all_single``
   -> "all-to-all"). On a ``cpu`` mesh DTensor reshards one sharded dim
   to another by an all-gather and a chunk (gloo has no all-to-all), so
   such a reshard counts as an all-gather there.
2. **Matmul operations** (``dot_flops``): every matmul-class op of
   ``torch.utils.flop_counter``'s registry, at the local shapes. Counting
   at the DTensor level would give global products (PyTorch's
   ``FlopCounterMode`` does). Elementwise operations are not counted, the
   reference's matmul convention.
3. **Traffic** (``hbm_bytes``): the reference's proxy, twice the result
   bytes of every op that makes a tensor (views and waits are free);
   ``flash_bytes`` the part made inside the attention's plain version
   (the kernel keeps those tiles on chip).
4. **Peak** (``peak_bytes``): the most bytes of tensors made by the step
   alive at once, freed when Python drops them (arguments not included).

DTensor derives each op's global output shape by running the op on fake
global-shape tensors; those runs are not the rank's work and are not
counted. They are told apart by wrapping the one place DTensor makes
them, ``ShardingPropagator._propagate_tensor_meta_non_cached``
(``torch.distributed.tensor._sharding_prop``): a private name of
PyTorch, which a release may rename; the analysis then fails with an
``AttributeError`` naming it. The attention's local call marks itself
with ``flash_region()`` (models/attention.py), which counts its made
tensors as ``flash_bytes``.

Python loops execute every layer, so there is no loop body counted once
and ``trip_counts`` has no counterpart: it stays empty. The reference's ``_shape_bytes``/``_shape_dims`` parse HLO text types and have
no counterpart either: the mode reads each tensor's shape and dtype.
"""
from __future__ import annotations

import contextlib
import weakref
from dataclasses import dataclass, field
from typing import Dict, List

import torch
from torch.utils._python_dispatch import TorchDispatchMode
from torch.utils._pytree import tree_leaves

KINDS = {"all_reduce": "all-reduce", "all_reduce_coalesced": "all-reduce",
         "all_gather_into_tensor": "all-gather",
         "all_gather_into_tensor_coalesced": "all-gather",
         "reduce_scatter_tensor": "reduce-scatter",
         "reduce_scatter_tensor_coalesced": "reduce-scatter",
         "all_to_all_single": "all-to-all",
         "shard_dim_alltoall": "all-to-all"}
_FREE = ("wait_tensor", "detach", "alias", "lift_fresh", "_local_scalar_dense",
         "device", "layout", "dim", "sym_size", "sym_stride", "sym_numel",
         "sym_storage_offset", "is_same_size")


@dataclass
class HLOStats:
    bytes_by_kind: Dict[str, float] = field(default_factory=dict)
    count_by_kind: Dict[str, int] = field(default_factory=dict)
    dot_flops: float = 0.0
    hbm_bytes: float = 0.0       # twice the result bytes of every made tensor
    # traffic made inside the attention's plain version (score and context
    # tiles), which the flash kernel keeps on chip
    flash_bytes: float = 0.0
    # no counterpart: every Python loop trip runs and is counted (module
    # docstring); kept empty for the reference's record
    trip_counts: List[int] = field(default_factory=list)
    peak_bytes: float = 0.0
    ops: int = 0

    @property
    def total_collective_bytes(self) -> float:
        return sum(self.bytes_by_kind.values())

    def add_coll(self, kind: str, nbytes: float, mult: float = 1.0):
        self.bytes_by_kind[kind] = self.bytes_by_kind.get(kind, 0.0) \
            + nbytes * mult
        self.count_by_kind[kind] = self.count_by_kind.get(kind, 0) + 1


def _nbytes(t: torch.Tensor) -> int:
    return t.numel() * t.element_size()


class _Counter(TorchDispatchMode):
    """Counts one rank's local ops into ``stats`` (module docstring)."""

    def __init__(self, stats: HLOStats):
        super().__init__()
        self.stats = stats
        self.shadow = 0            # inside DTensor's global-shape inference
        self.live = 0

    def __torch_dispatch__(self, func, types, args=(), kwargs=None):
        kwargs = kwargs or {}
        from torch.distributed.tensor import DTensor
        if any(issubclass(t, DTensor) for t in types):
            return NotImplemented
        out = func(*args, **kwargs)
        if self.shadow:
            return out
        st = self.stats
        st.ops += 1
        name = func._overloadpacket.__name__
        ns = func.namespace
        if ns == "_c10d_functional" or ns == "_dtensor":
            if name in KINDS:
                st.add_coll(KINDS[name], sum(
                    _nbytes(t) for t in tree_leaves(out)
                    if isinstance(t, torch.Tensor)))
            return out
        from torch.utils.flop_counter import flop_registry
        packet = func._overloadpacket
        if packet in flop_registry:
            st.dot_flops += float(flop_registry[packet](*args, **kwargs,
                                                        out_val=out))
        if name in _FREE or func.is_view or func._schema.is_mutable:
            return out
        made = [t for t in tree_leaves(out) if isinstance(t, torch.Tensor)]
        n = sum(_nbytes(t) for t in made)
        st.hbm_bytes += 2.0 * n
        if _FLASH_DEPTH[0]:
            st.flash_bytes += 2.0 * n
        for t in made:
            self._track(t)
        return out

    def _track(self, t: torch.Tensor):
        n = _nbytes(t)
        self.live += n
        self.stats.peak_bytes = max(self.stats.peak_bytes, self.live)

        def free(counter=weakref.ref(self), n=n):
            c = counter()
            if c is not None:
                c.live -= n
        weakref.finalize(t, free)


_FLASH_DEPTH = [0]               # open flash_region() contexts


@contextlib.contextmanager
def flash_region():
    """Marks the attention's local call: what ``analyze_step`` sees made
    inside it counts also as ``flash_bytes``. Costs one increment when no
    analysis runs."""
    _FLASH_DEPTH[0] += 1
    try:
        yield
    finally:
        _FLASH_DEPTH[0] -= 1


def analyze_step(fn, *args, **kwargs) -> HLOStats:
    """Run ``fn(*args, **kwargs)`` once and count what one rank executes
    (module docstring). The result of ``fn`` is dropped."""
    from torch.distributed.tensor._sharding_prop import ShardingPropagator
    stats = HLOStats()
    counter = _Counter(stats)
    name = "_propagate_tensor_meta_non_cached"
    inner = getattr(ShardingPropagator, name)

    def shadowed(*a, **k):
        counter.shadow += 1
        try:
            return inner(*a, **k)
        finally:
            counter.shadow -= 1

    setattr(ShardingPropagator, name, shadowed)
    try:
        with counter:
            out = fn(*args, **kwargs)
            del out
    finally:
        setattr(ShardingPropagator, name, inner)
    return stats
