"""The port's sharding plans and abstract specs against the JAX reference,
in this process (neither side needs a mesh for the plans' arithmetic).

- the reference's sharding tests on the port (first dim wins a mesh axis,
  a dim its axes do not divide stays replicated, tuple axes, the spec
  tree's structure, ``constrain`` a no-op without rules);
- for every arch, train and serve rules, at {"data": 16, "model": 16} and
  {"pod": 2, "data": 16, "model": 16}: ``param_specs`` tuple-equal to the
  reference's, every leaf's local shard shape equal to the reference's
  spec arithmetic, and ``make_plan``'s batch and sequence axes and
  activation rules equal for every ``SHAPES`` entry;
- ``cache_shardings`` and ``sanitize_shardings`` against the reference's
  (the cache trees leaf for leaf);
- DTensor placements of specs (tuple entries in mesh order);
- ``input_specs``' shapes and dtypes equal to the reference's
  ``ShapeDtypeStruct``s for every arch and shape, on the ``meta``
  device.
"""
import math

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
from jax.sharding import PartitionSpec as JP  # noqa: E402

from repro.configs import SHAPES as JSHAPES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs.base import MeshConfig as JMeshConfig  # noqa: E402
from repro.launch import specs as JSP  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.parallel import sharding as JS  # noqa: E402
from repro_torch.configs import ARCHS, SHAPES, get_config  # noqa: E402
from repro_torch.configs.base import MeshConfig  # noqa: E402
from repro_torch.core.tree import tree_leaves  # noqa: E402
from repro_torch.launch import specs as SP  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.parallel import act_sharding as ash  # noqa: E402
from repro_torch.parallel import sharding as SH  # noqa: E402

MESHES = {"pod1": {"data": 16, "model": 16},
          "pod2": {"pod": 2, "data": 16, "model": 16}}
MODES = ("train", "serve")


class _Mesh:
    """The axis names and sizes of a mesh, which is all a plan's spec
    arithmetic reads (no process group)."""

    def __init__(self, sizes):
        self.mesh_dim_names = tuple(sizes)
        self.shape = tuple(sizes.values())


def _jleaves(tree):
    return jax.tree.leaves(tree, is_leaf=lambda x: isinstance(x, JP))


def test_spec_dedup_first_wins():
    defs = {"w": L.ParamDef((8, 16, 32), "scaled",
                            ("experts", "embed", "ffn"))}
    rules = {"experts": "model", "embed": "data", "ffn": "model"}
    assert L.param_specs(defs, rules)["w"] == JP("model", "data", None)
    assert L.param_specs(defs, rules)["w"] == ("model", "data", None)


def test_spec_divisibility_fallback():
    defs = {"w": L.ParamDef((6, 2728, 2048), "scaled",
                            ("layers", "ffn", "embed"))}
    rules = {"layers": None, "ffn": "model", "embed": "data"}
    specs = L.param_specs(defs, rules, {"model": 16, "data": 16})
    assert specs["w"] == JP(None, None, "data")      # 2728 % 16 != 0


def test_spec_tuple_axes():
    defs = {"w": L.ParamDef((32, 64), "scaled", ("embed", "ffn"))}
    rules = {"embed": ("pod", "data"), "ffn": "model"}
    specs = L.param_specs(defs, rules, {"pod": 2, "data": 16, "model": 16})
    assert specs["w"] == JP(("pod", "data"), "model")
    assert repr(specs["w"]) == "PartitionSpec(('pod', 'data'), 'model')"


def _rules(mode, arch, multi_pod):
    fn, jfn = ((SH.train_rules, JS.train_rules) if mode == "train"
               else (SH.serve_rules, JS.serve_rules))
    return (fn(get_config(arch), MeshConfig(multi_pod=multi_pod)),
            jfn(jget_config(arch), JMeshConfig(multi_pod=multi_pod)))


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("mode", MODES)
@pytest.mark.parametrize("arch", ARCHS)
def test_param_specs_and_shards_match_reference(arch, mode, mesh):
    sizes = MESHES[mesh]
    rules, jrules = _rules(mode, arch, mesh == "pod2")
    assert rules == jrules
    defs, jdefs = M.model_defs(get_config(arch)), JM.model_defs(
        jget_config(arch))
    specs = tree_leaves(L.param_specs(defs, rules, sizes))
    jspecs = _jleaves(JL.param_specs(jdefs, jrules, sizes))
    shapes = [d.shape for d in tree_leaves(defs)]
    assert len(specs) == len(jspecs) == len(shapes)
    for s, j, shape in zip(specs, jspecs, shapes):
        assert s == j and tuple(s) == tuple(j), (arch, shape, s, j)
        # the reference's spec arithmetic: each dim over the product of
        # its axes' sizes
        want = tuple(dim // math.prod(sizes[a] for a in (
            e if isinstance(e, tuple) else (e,))) if e else dim
            for dim, e in zip(shape, tuple(j) + (None,) * len(shape)))
        assert SH.local_shape(shape, s, sizes) == want


@pytest.mark.parametrize("mesh", MESHES)
@pytest.mark.parametrize("arch", ARCHS)
def test_plans_match_reference(arch, mesh):
    mp = mesh == "pod2"
    for name, shape in SHAPES.items():
        for mode in MODES:
            plan = SH.make_plan(get_config(arch), shape, None,
                                MeshConfig(multi_pod=mp), mode)
            jplan = JS.make_plan(jget_config(arch), JSHAPES[name], None,
                                 JMeshConfig(multi_pod=mp), mode)
            assert plan.batch_axes == jplan.batch_axes, (name, mode)
            assert plan.seq_axes == jplan.seq_axes, (name, mode)
            assert plan.act_rules == jplan.act_rules, (name, mode)


def _tensors(tree):
    """Leaves in the reference's flatten order: dict keys sorted, a
    (named) tuple's items in order, None an empty subtree."""
    if isinstance(tree, dict):
        return [t for k in sorted(tree) for t in _tensors(tree[k])]
    if isinstance(tree, tuple) and not isinstance(tree, L.PartitionSpec):
        return [t for x in tree for t in _tensors(x)]
    return [] if tree is None else [tree]


@pytest.mark.parametrize("arch", ARCHS)
def test_cache_shardings_match_reference(arch):
    """The decode cells' cache shardings, leaf for leaf in the port's own
    cache trees, on both production meshes (the reference's ``named``
    replaced by its spec: the plan's arithmetic needs no mesh)."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    for mesh, sizes in MESHES.items():
        mp = mesh == "pod2"
        for name in ("decode_32k", "long_500k"):
            plan = SH.make_plan(cfg, SHAPES[name], _Mesh(sizes),
                                MeshConfig(multi_pod=mp), "serve")
            jplan = JS.make_plan(jcfg, JSHAPES[name], None,
                                 JMeshConfig(multi_pod=mp), "serve")
            jplan.named = lambda *spec: JP(*spec)
            got = _tensors(plan.cache_shardings(cfg))
            want = _jleaves(jplan.cache_shardings(jcfg))
            assert [s.spec for s in got] == want, (arch, name)
            caches = _tensors(SP.abstract_caches(cfg, SHAPES[name]))
            assert len(caches) == len(got)
            for sh, c in zip(got, caches):
                assert len(sh.spec) == c.dim(), (arch, name, sh.spec)


def test_sanitize_shardings_drops_what_does_not_divide():
    plan = SH.make_plan(get_config("smollm_135m"), SHAPES["train_4k"],
                        _Mesh(MESHES["pod2"]), MeshConfig(multi_pod=True),
                        "train")
    sh = {"a": plan.named(("pod", "data"), "model"),
          "b": (plan.named("model", "model"), None),
          "c": plan.named("data")}
    shapes = {"a": torch.empty(64, 48, device="meta"),
              "b": (torch.empty(32, 32, device="meta"), None),
              "c": torch.empty(24, 4, device="meta")}
    out = SH.sanitize_shardings(sh, shapes, plan.axis_sizes)
    assert out["a"].spec == JP(("pod", "data"), "model")
    assert out["b"][0].spec == JP("model", None) and out["b"][1] is None
    assert out["c"].spec == JP(None, None)


def test_placements_of_specs():
    from torch.distributed.tensor import Replicate, Shard
    names = ("pod", "data", "model")
    assert SH.placements_of(L.PartitionSpec(("pod", "data"), "model"),
                            names) == (Shard(0), Shard(0), Shard(1))
    assert SH.placements_of(L.PartitionSpec(None, "data"), names) == (
        Replicate(), Shard(1), Replicate())
    with pytest.raises(ValueError, match="mesh's order"):
        SH.placements_of(L.PartitionSpec(("data", "pod")), names)


def test_constrain_is_a_noop_without_rules_or_dtensors():
    x = torch.ones((4, 4))
    assert ash.constrain(x, "batch", "seq") is x
    with ash.activation_rules({"batch": "data"}):
        assert ash.current_rules() == {"batch": "data"}
        assert ash.constrain(x, "batch", "seq") is x
    assert ash.current_rules() is None


def _like(t, j):
    assert tuple(t.shape) == tuple(j.shape), (t.shape, j.shape)
    assert str(t.dtype).split(".")[-1] == str(j.dtype), (t.dtype, j.dtype)
    assert t.device.type == "meta"


@pytest.mark.parametrize("arch", ARCHS)
def test_input_specs_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    for name in SHAPES:
        kind, args = SP.input_specs(cfg, SHAPES[name])
        jkind, jargs = JSP.input_specs(jcfg, JSHAPES[name])
        assert kind == jkind
        got = _tensors(args)
        want = jax.tree.leaves(jargs)
        assert len(got) == len(want), (name, len(got), len(want))
        for t, j in zip(got, want):
            _like(t, j)


def test_abstract_params_allocate_nothing():
    cfg = get_config("arctic_480b")
    params = M.abstract_params(cfg)
    leaves = tree_leaves(params)
    assert all(t.device.type == "meta" for t in leaves)
    assert sum(t.numel() for t in leaves) == M.count_params_analytic(cfg)
    np.testing.assert_equal(
        [tuple(t.shape) for t in leaves],
        [tuple(a.shape) for a in jax.tree.leaves(JM.abstract_params(
            jget_config("arctic_480b")))])
