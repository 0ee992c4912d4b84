"""The port's plan IR constructors (``from_string``, ``make_mixed``,
``make_vopen``, ``classify_legacy`` and the ``PlacementPlan`` properties)
against the JAX reference, and mixed and verified-open plans executed
end to end on the CPU.

Digests, placement strings and exposed boundaries must be equal. Through
``OrigamiExecutor.infer`` the tier-1 boundary is bit-equal to the
reference's eager run (``infer(jit=False)``) and the integrity report and
telemetry equal; the logits pass float tier-2, whose summation order
differs between torch and XLA, and are held to atol 1e-4 * max|ref|.
"""
import dataclasses
import itertools

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.core import integrity as JIG  # noqa: E402
from repro.core import plan as JPL  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core import plan as TPL  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime.faults import DishonestDevice, FaultSpec  # noqa: E402


def _np_params(cfg, seed):
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in V.vgg_defs(cfg).items():
        w = leaves["w"].shape
        out[layer] = {
            "w": (rng.normal(size=w) / np.sqrt(np.prod(w[:-1]))).astype(
                np.float32),
            "b": (rng.normal(size=leaves["b"].shape) * 0.1).astype(np.float32)}
    return out


@pytest.fixture(scope="module")
def vgg():
    cfg, jcfg = get_smoke("vgg16"), jget_smoke("vgg16")
    npp = _np_params(cfg, seed=3)
    x = (np.random.default_rng(4).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)) * 0.5).astype(np.float32)
    return cfg, jcfg, npp, x


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


def _same(tplan, jplan):
    assert tplan.digest == jplan.digest
    assert tplan.placement_string == jplan.placement_string
    assert tplan.exposed_boundaries() == jplan.exposed_boundaries()
    assert tplan.num_blinded == jplan.num_blinded
    assert tplan.has_blinded == jplan.has_blinded
    assert tplan.has_offload == jplan.has_offload
    assert tplan.has_step_policies == jplan.has_step_policies
    assert tplan.summary() == jplan.summary()
    assert TPL.classify_legacy(tplan) == JPL.classify_legacy(jplan)
    assert [(s.layer_id, s.precompute_slot) for s in tplan.steps] == \
        [(s.layer_id, s.precompute_slot) for s in jplan.steps]


# every 3-letter prefix over the placement alphabet, open tail
_SPECS = ["".join(p) for p in itertools.product("oebv", repeat=3)]


@pytest.mark.parametrize("prefix", _SPECS[::3])
def test_from_string_matches_reference(vgg, prefix):
    cfg, jcfg, _, _ = vgg
    spec = prefix + "o" * (len(cfg.cnn_layers) - 3)
    tplan, jplan = TPL.from_string(cfg, spec), JPL.from_string(jcfg, spec)
    _same(tplan, jplan)
    # the string round-trips the plan's identity
    assert TPL.from_string(cfg, tplan.placement_string,
                           boundary=tplan.boundary).digest == tplan.digest


@pytest.mark.parametrize("boundary,prefix", [(None, None), (3, 1), (3, 0),
                                              (6, 2), (8, 4)])
def test_make_mixed_matches_reference(vgg, boundary, prefix):
    cfg, jcfg, _, _ = vgg
    _same(TPL.make_mixed(cfg, boundary, prefix),
          JPL.make_mixed(jcfg, boundary, prefix))


@pytest.mark.parametrize("boundary,k", [(None, None), (2, 1), (5, 2)])
def test_make_vopen_matches_reference(vgg, boundary, k):
    cfg, jcfg, _, _ = vgg
    tv = None if k is None else TIG.IntegrityPolicy.full(k)
    jv = None if k is None else JIG.IntegrityPolicy.full(k)
    _same(TPL.make_vopen(cfg, boundary, tv), JPL.make_vopen(jcfg, boundary,
                                                            jv))


@pytest.mark.parametrize("mode", TPL.LEGACY_MODES)
@pytest.mark.parametrize("partition", [0, 3, 8])
def test_classify_legacy_round_trips_every_mode(vgg, mode, partition):
    cfg, jcfg, _, _ = vgg
    tplan = TPL.compile_mode(cfg, mode, partition)
    _same(tplan, JPL.compile_mode(jcfg, mode, partition))
    got = TPL.classify_legacy(tplan)
    assert got is not None
    # the classified shape compiles back to the same placements
    again = TPL.compile_mode(cfg, got[0], got[1])
    assert again.placement_string == tplan.placement_string
    assert again.boundary == tplan.boundary


def test_verified_open_rejected_for_lm_families():
    cfg, jcfg = get_smoke("smollm_135m"), jget_smoke("smollm_135m")
    for pl, c in ((TPL, cfg), (JPL, jcfg)):
        with pytest.raises(pl.ScanExclusion):
            pl.make_vopen(c)
        with pytest.raises(pl.ScanExclusion):
            pl.from_string(c, "b" + "v" * (c.num_layers - 1), boundary=1)
    n = cfg.num_layers
    assert TPL.from_string(cfg, "b" * n).digest == \
        JPL.from_string(jcfg, "b" * n).digest


def _pair(vgg, tplan, jplan, **kw):
    cfg, jcfg, npp, _ = vgg
    jkw = dict(kw)
    tkw = dict(kw)
    if "integrity" in kw:
        jkw["integrity"] = JIG.IntegrityPolicy(*kw["integrity"])
        tkw["integrity"] = TIG.IntegrityPolicy(*kw["integrity"])
    jex = JEx(jcfg, jax.tree.map(jnp.asarray, npp), plan=jplan, **jkw)
    tex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"), plan=tplan,
                          device="cpu", **tkw)
    return jex, tex


def _run_both(jex, tex, x, seed):
    key = jax.random.PRNGKey(seed)
    je = jex.infer({"images": jnp.asarray(x)}, session_key=key, jit=False)
    tr = tex.infer({"images": x}, session_key=np.asarray(key))
    np.testing.assert_array_equal(tr.boundary.numpy(), np.asarray(je.boundary))
    _close(tr.logits.numpy(), np.asarray(je.logits))
    for f in ("checked", "failed", "corrupted"):
        np.testing.assert_array_equal(getattr(tr.integrity, f).numpy(),
                                      np.asarray(getattr(je.integrity, f)))
    assert dataclasses.asdict(tr.telemetry) == dataclasses.asdict(
        je.telemetry)
    return tr


@pytest.mark.parametrize("precompute", [False, True])
def test_mixed_plan_boundary_bit_equal_to_reference(vgg, precompute):
    cfg, jcfg, _, x = vgg
    jex, tex = _pair(vgg, TPL.make_mixed(cfg), JPL.make_mixed(jcfg),
                     precompute=precompute, integrity=("full", 0.25, 2))
    tr = _run_both(jex, tex, x, seed=11)
    assert tr.integrity.n_checked == tr.integrity.n_ops == \
        len(TPL.make_mixed(cfg).cache_ops) > 0
    # the enclave recompute of the same plan is bit-identical
    rt = tex.infer({"images": x}, trusted=True)
    np.testing.assert_array_equal(rt.boundary.numpy(), tr.boundary.numpy())
    np.testing.assert_array_equal(rt.logits.numpy(), tr.logits.numpy())


@pytest.mark.parametrize("precompute", [False, True])
def test_vopen_plan_boundary_bit_equal_to_reference(vgg, precompute):
    cfg, jcfg, _, x = vgg
    tplan, jplan = TPL.make_vopen(cfg), JPL.make_vopen(jcfg)
    jex, tex = _pair(vgg, tplan, jplan, precompute=precompute,
                     integrity=("full", 0.25, 1))
    tr = _run_both(jex, tex, x, seed=12)
    n_ops = len(tplan.cache_ops)
    assert tr.integrity.n_checked == n_ops and tr.integrity.ok
    rt = tex.infer({"images": x}, trusted=True)
    np.testing.assert_array_equal(rt.boundary.numpy(), tr.boundary.numpy())


def test_verified_open_only_plan_detects_dishonest_device(vgg):
    cfg, _, npp, x = vgg
    n = len(cfg.cnn_layers)
    plan = TPL.from_string(cfg, "".join(
        "v" if lin else "o" for lin in TPL.linear_layers(cfg)), boundary=0)
    assert plan.num_blinded == 0 and plan.has_step_policies
    ex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"), plan=plan,
                         fault=DishonestDevice(FaultSpec("bit_flip")),
                         device="cpu")
    r = ex.infer({"images": x}, session_key=np.asarray(
        jax.random.PRNGKey(9)))
    assert r.integrity.n_checked == sum(TPL.linear_layers(cfg)) < n
    assert r.integrity.n_corrupted > 0
    assert r.integrity.n_failed == r.integrity.n_corrupted


def test_digest_distinguishes_plans_and_policies(vgg):
    cfg, _, _, _ = vgg
    plans = [TPL.make_mixed(cfg), TPL.make_vopen(cfg),
             TPL.make_vopen(cfg, verify=TIG.IntegrityPolicy.full(2)),
             TPL.compile_mode(cfg, "origami"), TPL.compile_mode(cfg, "split")]
    assert len({p.digest for p in plans}) == len(plans)
