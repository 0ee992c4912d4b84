"""The port's Origami executor against the JAX reference on the VGG-16 and
VGG-19 smoke configs, on the CPU.

Tier-1 is field arithmetic plus IEEE-rounded float32 elementwise ops, so
the tier-1 boundary is bit-equal to the reference's eager run
(``infer(jit=False)``). The reference's jitted CPU run contracts the
dequantize multiply and the bias add into one fused multiply-add, so it
differs from both in the last bit; the logits go through float tier-2,
whose summation order differs between torch and XLA, and are held to
atol 1e-4 * max|ref|.
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core.origami import MODES, OrigamiExecutor  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402


def _np_params(cfg, seed):
    """Scaled-normal weights and random biases (the reference initializes
    biases to zero, which would hide bias-add rounding)."""
    rng = np.random.default_rng(seed)
    out = {}
    for layer, leaves in V.vgg_defs(cfg).items():
        w = leaves["w"].shape
        out[layer] = {
            "w": (rng.normal(size=w) / np.sqrt(np.prod(w[:-1]))).astype(
                np.float32),
            "b": (rng.normal(size=leaves["b"].shape) * 0.1).astype(np.float32)}
    return out


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())


@pytest.fixture(scope="module", params=["vgg16", "vgg19"])
def model(request):
    name = request.param
    cfg, jcfg = get_smoke(name), jget_smoke(name)
    npp = _np_params(cfg, seed=len(name))
    x = (np.random.default_rng(1).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)) * 0.5).astype(np.float32)
    return cfg, jcfg, npp, x


def _pair(model, **kw):
    cfg, jcfg, npp, _ = model
    jkw = {k: v for k, v in kw.items() if k != "integrity"}
    tkw = dict(jkw)
    if "integrity" in kw:
        jkw["integrity"] = JIG.IntegrityPolicy(*kw["integrity"])
        tkw["integrity"] = TIG.IntegrityPolicy(*kw["integrity"])
    jex = JEx(jcfg, jax.tree.map(jnp.asarray, npp), **jkw)
    tex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"),
                          device="cpu", **tkw)
    return jex, tex


def test_origami_boundary_bit_equal_and_report_equal(model):
    _, _, _, x = model
    jex, tex = _pair(model, mode="origami", precompute=True,
                     integrity=("full", 0.25, 2))
    key = jax.random.PRNGKey(7)
    je = jex.infer({"images": jnp.asarray(x)}, session_key=key, jit=False)
    jj = jex.infer({"images": jnp.asarray(x)}, session_key=key)
    tr = tex.infer({"images": x}, session_key=np.asarray(key))
    np.testing.assert_array_equal(tr.boundary.numpy(), np.asarray(je.boundary))
    _close(tr.boundary.numpy(), np.asarray(jj.boundary))
    _close(tr.logits.numpy(), np.asarray(je.logits))
    _close(tr.logits.numpy(), np.asarray(jj.logits))
    for f in ("checked", "failed", "corrupted"):
        np.testing.assert_array_equal(getattr(tr.integrity, f).numpy(),
                                      np.asarray(getattr(je.integrity, f)))
    assert tr.integrity.n_checked == tr.integrity.n_ops == 2
    assert dataclasses.asdict(tr.telemetry) == dataclasses.asdict(
        je.telemetry)
    assert tr.telemetry.enclave_matmuls == 0          # precompute cache on
    assert tr.telemetry.device_matmuls == tr.telemetry.calls


def test_trusted_recompute_bit_equal_to_blinded(model):
    _, _, _, x = model
    _, tex = _pair(model, mode="origami", precompute=True,
                   integrity=("full", 0.25, 1))
    blinded = tex.infer({"images": x}, session_key=np.asarray(
        jax.random.PRNGKey(3)))
    trusted = tex.infer({"images": x}, trusted=True)
    assert trusted.trusted and tex.telemetry.trusted_matmuls == 2
    np.testing.assert_array_equal(trusted.boundary.numpy(),
                                  blinded.boundary.numpy())
    np.testing.assert_array_equal(trusted.logits.numpy(),
                                  blinded.logits.numpy())


@pytest.mark.parametrize("mode", MODES)
def test_every_mode_matches_reference(model, mode):
    cfg, _, npp, x = model
    jex, tex = _pair(model, mode=mode)
    key = jax.random.PRNGKey(2)
    je = jex.infer({"images": jnp.asarray(x)}, session_key=key, jit=False)
    tr = tex.infer({"images": x}, session_key=np.asarray(key))
    assert tex.partition == jex.partition
    if mode in ("origami", "slalom"):
        np.testing.assert_array_equal(tr.boundary.numpy(),
                                      np.asarray(je.boundary))
    else:
        _close(tr.boundary.numpy(), np.asarray(je.boundary))
    _close(tr.logits.numpy(), np.asarray(je.logits))
    assert dataclasses.asdict(tr.telemetry) == dataclasses.asdict(
        je.telemetry)
    ref = tex.reference({"images": x}).numpy()
    rel = np.abs(tr.logits.numpy() - ref).max() / np.abs(ref).max()
    assert rel < 0.05, rel


def test_verified_open_plan_matches_reference(model):
    """Blinded tier-1 and verified-open tier-2 (zero pads, Freivalds
    checks on every open linear layer) through the precompute cache."""
    from repro.core import plan as JPL
    from repro_torch.core import plan as TPL
    cfg, jcfg, npp, x = model
    p = cfg.origami.tier1_layers
    n = len(cfg.cnn_layers)
    linear = TPL.linear_layers(cfg)
    placements = ["blinded"] * p + ["open"] * (n - p)
    jplan = JPL.make_vopen(jcfg)
    tplan = TPL.make_plan(cfg, placements, boundary=p, label="vopen",
                          integrity={i: TIG.IntegrityPolicy.full(1)
                                     for i in range(p, n) if linear[i]})
    assert tplan.digest == jplan.digest
    jex = JEx(jcfg, jax.tree.map(jnp.asarray, npp), plan=jplan,
              precompute=True)
    tex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"), plan=tplan,
                          precompute=True, device="cpu")
    key = jax.random.PRNGKey(6)
    je = jex.infer({"images": jnp.asarray(x)}, session_key=key, jit=False)
    tr = tex.infer({"images": x}, session_key=np.asarray(key))
    np.testing.assert_array_equal(tr.boundary.numpy(), np.asarray(je.boundary))
    _close(tr.logits.numpy(), np.asarray(je.logits))
    np.testing.assert_array_equal(tr.integrity.checked.numpy(),
                                  np.asarray(je.integrity.checked))
    assert tr.integrity.n_checked == sum(linear[p:]) and tr.integrity.ok
    assert dataclasses.asdict(tr.telemetry) == dataclasses.asdict(
        je.telemetry)


def test_vgg_forward_capture_matches_reference(model):
    from repro.models import vgg as JV
    cfg, jcfg, npp, x = model
    jl, jc = JV.vgg_forward(jax.tree.map(jnp.asarray, npp), jnp.asarray(x),
                            jcfg, capture=3)
    tl, tc = V.vgg_forward(V.params_from_numpy(npp, "cpu"),
                           torch.from_numpy(x), cfg, capture=3)
    _close(tc.numpy(), np.asarray(jc))
    _close(tl.numpy(), np.asarray(jl))
    back = V.params_to_numpy(V.params_from_numpy(npp, "cpu"))
    for layer in npp:
        for name in npp[layer]:
            np.testing.assert_array_equal(back[layer][name], npp[layer][name])
    assert [tuple(s) for s in V.feature_shapes(cfg)] == \
        [tuple(s) for s in JV.feature_shapes(jcfg)]


def test_cuda_request_without_card_raises(model):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    cfg, _, npp, _ = model
    with pytest.raises(RuntimeError, match="CUDA"):
        OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"))
