"""Sharding plans: logical-axis rules -> PartitionSpec / NamedSharding trees.

Port of ``repro/parallel/sharding.py`` onto ``torch.distributed``'s
``DeviceMesh`` and DTensor. Rules map the logical axes declared on every
ParamDef (models/layers.py) to mesh axes. Two presets:

- TRAIN: 2-D param sharding, FSDP over "data" (the ``embed`` logical axis)
  x TP over "model" (``ffn``/``heads_flat``/``vocab``/``experts``).
  Optimizer moments inherit the param spec.
- SERVE: TP over "model"; weights replicated over "data" for dense archs;
  MoE banks additionally shard ``ffn`` over "data".

Batch/cache specs per shape handle the special cells: ``long_500k`` has
global_batch=1, so the KV/seq dimension shards over ("data","model")
instead of the batch (sequence-parallel decode).

A sharding is ``NamedSharding(mesh, spec)``; its ``placements`` are the
DTensor placements of a tensor laid out by it: each mesh dim is
``Shard(d)`` for the tensor dim ``d`` whose spec entry names it, else
``Replicate()``. A tuple entry ("pod", "data") shards one tensor dim over
both mesh dims, the first major, as JAX does; DTensor shards a dim held by
several mesh dims in mesh order, so such an entry must list its axes in
mesh order. ``local_shape`` is the spec arithmetic of a shard's shape.
"""
from __future__ import annotations

import math
from dataclasses import dataclass
from typing import Any, Dict, Tuple

from torch.distributed.tensor import Replicate, Shard

from repro_torch.configs.base import MeshConfig, ModelConfig, ShapeConfig
from repro_torch.core.tree import tree_map
from repro_torch.models import layers as L
from repro_torch.models.layers import PartitionSpec as P


def train_rules(cfg: ModelConfig, mesh_cfg: MeshConfig) -> Dict[str, Any]:
    return {
        "embed": "data",          # FSDP axis
        "ffn": "model",
        "heads_flat": "model",
        "kv_flat": "model",
        "vocab": "model",
        "experts": "model",
        "lora": "model",
        "layers": None,
    }


def serve_rules(cfg: ModelConfig, mesh_cfg: MeshConfig) -> Dict[str, Any]:
    rules = {
        "embed": None,
        "ffn": "model",
        "heads_flat": "model",
        "kv_flat": "model",
        "vocab": "model",
        "experts": "model",
        "lora": "model",
        "layers": None,
    }
    if cfg.moe is not None:
        # expert banks too large to replicate over "data": shard their ffn
        # dim over data instead of model (experts already take "model")
        rules["ffn"] = "data"
    return rules


def placements_of(spec, mesh_dim_names) -> Tuple[Any, ...]:
    """DTensor placements, one a mesh dim, of a tensor laid out by
    ``spec`` over a mesh with ``mesh_dim_names``."""
    out = []
    for name in mesh_dim_names:
        dims = [d for d, e in enumerate(spec) if name in L._mesh_axes(e)]
        out.append(Shard(dims[0]) if dims else Replicate())
    for d, e in enumerate(spec):
        axes = L._mesh_axes(e)
        order = [mesh_dim_names.index(a) for a in axes if a in mesh_dim_names]
        if order != sorted(order):
            raise ValueError(f"spec entry {e!r} of dim {d} lists its mesh "
                             f"axes out of the mesh's order "
                             f"{tuple(mesh_dim_names)}")
    return tuple(out)


def local_shape(shape, spec, axis_sizes: Dict[str, int]) -> Tuple[int, ...]:
    """The shape of one shard of a tensor of ``shape`` laid out by
    ``spec`` on a mesh of ``axis_sizes`` (dims the spec shards divide)."""
    spec = tuple(spec) + (None,) * (len(shape) - len(spec))
    return tuple(dim // math.prod(axis_sizes.get(a, 1)
                                  for a in L._mesh_axes(e))
                 for dim, e in zip(shape, spec))


@dataclass(frozen=True)
class NamedSharding:
    mesh: Any                     # a DeviceMesh
    spec: P

    @property
    def placements(self):
        return placements_of(self.spec, self.mesh.mesh_dim_names)

    def shard_shape(self, shape) -> Tuple[int, ...]:
        return local_shape(shape, self.spec, mesh_axis_sizes(self.mesh))


def mesh_axis_sizes(mesh) -> Dict[str, int]:
    return dict(zip(mesh.mesh_dim_names, mesh.shape))


def is_sharding(x) -> bool:
    return isinstance(x, NamedSharding)


@dataclass
class ShardingPlan:
    mesh: Any                              # a DeviceMesh
    rules: Dict[str, Any]
    batch_axes: Tuple[str, ...]            # mesh axes sharding global batch
    seq_axes: Tuple[str, ...] = ()         # axes sharding seq (batch==1)

    @property
    def act_rules(self) -> Dict[str, Any]:
        """Logical activation axes -> mesh axes (parallel/act_sharding)."""
        return {
            "batch": self.batch_axes or None,
            "seq": self.seq_axes or None,
            # context-parallel attention: query seq over the model axis
            "flash_seq": self.seq_axes or "model",
            "vocab": "model",
            "embed_act": None,
            "ffn_act": "model",
            "heads_act": "model",
        }

    @property
    def axis_sizes(self) -> Dict[str, int]:
        return mesh_axis_sizes(self.mesh)

    def spec_tree(self, defs):
        return L.param_specs(defs, self.rules, self.axis_sizes)

    def param_shardings(self, cfg: ModelConfig):
        from repro_torch.models import model as M
        return tree_map(lambda s: NamedSharding(self.mesh, s),
                        self.spec_tree(M.model_defs(cfg)))

    def named(self, *spec) -> NamedSharding:
        return NamedSharding(self.mesh, P(*spec))

    # -- batches -------------------------------------------------------------
    def token_sharding(self) -> NamedSharding:
        b = self.batch_axes if self.batch_axes else None
        return self.named(b, None)

    def batch_shardings(self, cfg: ModelConfig, kind: str):
        b = self.batch_axes if self.batch_axes else None
        out = {"tokens": self.named(b, None)}
        if cfg.family == "audio":
            out["frames"] = self.named(b, None, "model")
        if cfg.family == "vlm":
            out["patches"] = self.named(b, None, "model")
        return out

    # -- caches (mirror models/model.py:init_caches leaf for leaf) -----------
    def cache_shardings(self, cfg: ModelConfig):
        from repro_torch.models.attention import KVCache
        b = self.batch_axes if self.batch_axes else None
        s = self.seq_axes if self.seq_axes else ("model",)
        fam = cfg.family

        def kv_spec():
            return KVCache(k=self.named(None, b, s, None, None),
                           v=self.named(None, b, s, None, None))

        if fam in ("dense", "moe"):
            if cfg.attention == "mla":
                return KVCache(k=self.named(None, b, s, None), v=None)
            return kv_spec()
        if fam == "hybrid":
            from repro_torch.models.ssm import Mamba2State
            state = Mamba2State(
                ssm=(self.named(None, None, b, "model", None, None),
                     self.named(None, None, b, "model", None)),
                conv=self.named(None, None, b, None, "model"))
            out = {"main": state, "shared": kv_spec()}
            if cfg.num_layers % cfg.hybrid_attn_every:
                out["tail"] = Mamba2State(
                    ssm=(self.named(None, b, "model", None, None),
                         self.named(None, b, "model", None)),
                    conv=self.named(None, b, None, "model"))
            return out
        if fam == "ssm":
            # xlstm has only 4 heads: shard the (large) per-head feature
            # dim over "model" instead of the head dim
            from repro_torch.models.ssm import MLSTMState, SLSTMState
            return {
                "mlstm": MLSTMState(
                    C=self.named(None, None, b, None, "model", None),
                    n=self.named(None, None, b, None, "model"),
                    m=self.named(None, None, b, None),
                    conv=self.named(None, None, b, None, "model")),
                "slstm": SLSTMState(
                    c=self.named(None, b, None, "model"),
                    n=self.named(None, b, None, "model"),
                    h=self.named(None, b, None, "model"),
                    m=self.named(None, b, None)),
            }
        if fam == "audio":
            return {"self": kv_spec(),
                    "cross_k": self.named(None, b, None, None, None),
                    "cross_v": self.named(None, b, None, None, None)}
        if fam == "vlm":
            return {"self": KVCache(
                        k=self.named(None, None, b, s, None, None),
                        v=self.named(None, None, b, s, None, None)),
                    "cross_k": self.named(None, b, None, None, None),
                    "cross_v": self.named(None, b, None, None, None)}
        raise ValueError(fam)

    # -- optimizer -----------------------------------------------------------
    def opt_shardings(self, cfg: ModelConfig):
        from repro_torch.optim.adamw import AdamWState
        pspec = self.param_shardings(cfg)
        return AdamWState(step=self.named(), mu=pspec, nu=pspec)


def sanitize_shardings(shardings, abstract, axis_sizes: Dict[str, int]):
    """Drop mesh axes whose size does not divide the corresponding dim and
    de-duplicate repeated axes: the catch-all guard applied to every
    dry-run argument tree. ``abstract`` holds a tensor (or anything with a
    ``shape``) where ``shardings`` holds a NamedSharding."""
    def fix(sh, a):
        used = set()
        out = []
        spec = tuple(sh.spec) + (None,) * (len(a.shape) - len(sh.spec))
        for dim, ax in zip(a.shape, spec):
            axes = L._mesh_axes(ax)
            n = math.prod(axis_sizes.get(x, 1) for x in axes)
            if not axes or dim % n != 0 or any(x in used for x in axes):
                out.append(None)
            else:
                used.update(axes)
                out.append(ax)
        return NamedSharding(sh.mesh, P(*out))

    def walk(sh, a):
        if is_sharding(sh):
            return fix(sh, a)
        if isinstance(sh, dict):
            return {k: walk(v, a[k]) for k, v in sh.items()}
        if isinstance(sh, tuple):
            items = [walk(s, x) for s, x in zip(sh, a)]
            return type(sh)(*items) if hasattr(sh, "_fields") \
                else tuple(items)
        return sh

    return walk(shardings, abstract)


def make_plan(cfg: ModelConfig, shape: ShapeConfig, mesh,
              mesh_cfg: MeshConfig, mode: str) -> ShardingPlan:
    """mode: 'train' | 'serve'."""
    rules = (train_rules if mode == "train" else serve_rules)(cfg, mesh_cfg)
    data_axes = ("pod", "data") if mesh_cfg.multi_pod else ("data",)
    n_data = 1
    for a, n in zip(mesh_cfg.axes, mesh_cfg.shape):
        if a in data_axes:
            n_data *= n
    if shape.global_batch >= n_data and shape.global_batch % n_data == 0:
        batch_axes: Tuple[str, ...] = data_axes
        seq_axes: Tuple[str, ...] = ()
    elif shape.global_batch == 1:
        batch_axes = ()
        seq_axes = data_axes + ("model",)
    else:
        # batch smaller than data axes: shard over "data" only if divisible
        batch_axes = ("data",) if shape.global_batch % 16 == 0 else ()
        seq_axes = ()
    return ShardingPlan(mesh=mesh, rules=rules, batch_axes=batch_axes,
                        seq_axes=seq_axes)


def distribute(tree, shardings):
    """Each tensor of ``tree`` as a DTensor laid out by the NamedSharding
    at its place in ``shardings``. Every rank must hold the same full
    tensor: each keeps its own shard and no rank sends."""
    from torch.distributed.tensor import distribute_tensor

    def walk(t, sh):
        if is_sharding(sh):
            return distribute_tensor(t, sh.mesh, sh.placements,
                                     src_data_rank=None)
        if isinstance(t, dict):
            return {k: walk(t[k], sh[k]) for k in t}
        if isinstance(t, tuple):
            items = [walk(x, s) for x, s in zip(t, sh)]
            return type(t)(*items) if hasattr(t, "_fields") else tuple(items)
        return t

    return walk(tree, shardings)


__all__ = ["NamedSharding", "ShardingPlan", "distribute", "local_shape",
           "make_plan", "mesh_axis_sizes", "placements_of",
           "sanitize_shardings", "serve_rules", "train_rules"]
