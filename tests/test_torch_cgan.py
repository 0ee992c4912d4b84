"""The port's c-GAN adversary (``privacy/cgan.py``) and its SAME
convolution (``models/layers.conv2d``) against the reference on the CPU.

Weights and inputs are drawn with numpy and carried across. The
convolutions sum in another order in torch than in XLA, so:

- a convolution is held to rtol 1e-5 of itself plus atol 1e-5 of the
  output's largest magnitude;
- a forward pass, a loss and a gradient are held to rtol 1e-4 plus atol
  1e-4 of the largest magnitude of the tensor compared (a few layers of
  float32 rounding, and the gradient sums over the batch and the pixels);
- one D+G step with AdamW is held there too in its losses and moments
  (which carry the clipped gradients). Adam's first step moves a weight by lr * g / (|g| + 1e-8), at
  most lr (2e-4): where the reference's gradient is at least 1e-4 of its
  leaf's largest, that is sign(g) to within rounding and the updated
  weight is held to atol 1e-6; where it is smaller, the step's size rests
  on the gradient's last digits and the weight is held to the bound lr.
"""
import math

import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.configs.base import TrainConfig as JTrainConfig  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import vgg as JV  # noqa: E402
from repro.optim import adamw as JA  # noqa: E402
from repro.privacy import cgan as JC  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import TrainConfig  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.optim import adamw as TA  # noqa: E402
from repro_torch.privacy import cgan as TC  # noqa: E402
from repro_torch.privacy import reconstruct as TR  # noqa: E402


def _close(got, want, rtol=1e-4, err_msg=""):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else got
    want = np.asarray(want)
    np.testing.assert_allclose(got, want, rtol=rtol,
                               atol=rtol * float(np.abs(want).max()),
                               err_msg=err_msg)


def _tree_np(defs, rng):
    """Random weights for a def tree (numpy, nonzero biases)."""
    if JL.is_def(defs) or L.is_def(defs):
        fan = math.prod(defs.shape[:-1]) if len(defs.shape) > 1 else 1
        return (rng.standard_normal(defs.shape)
                / math.sqrt(fan)).astype(np.float32)
    return {k: _tree_np(v, rng) for k, v in defs.items()}


def _torch(tree):
    if isinstance(tree, dict):
        return {k: _torch(v) for k, v in tree.items()}
    return torch.from_numpy(np.array(tree))


def _jax(tree):
    if isinstance(tree, dict):
        return {k: _jax(v) for k, v in tree.items()}
    return jnp.asarray(tree)


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.detach().numpy()}
    return {prefix: np.asarray(tree)}


def _close_trees(got, want, what):
    g, w = _flat(got), _flat(want)
    assert sorted(g) == sorted(w), what
    for k in w:
        _close(g[k], w[k], err_msg=f"{what} {k}")


def _close_update(got, want, grad, lr, what):
    g, w, gr = _flat(got), _flat(want), _flat(grad)
    for k in w:
        big = np.abs(gr[k]) >= 1e-4 * np.abs(gr[k]).max()
        gap = np.abs(g[k] - w[k])
        assert gap[big].max(initial=0) <= 1e-6, (what, k, gap[big].max())
        assert gap.max() <= lr, (what, k, gap.max())


# -- the SAME convolution -----------------------------------------------------

@pytest.mark.parametrize("k", [3, 4])
@pytest.mark.parametrize("stride", [1, 2])
@pytest.mark.parametrize("h", [7, 16])
def test_conv2d_same_matches_lax_conv(k, stride, h):
    rng = np.random.default_rng(100 * k + 10 * stride + h)
    x = rng.standard_normal((2, h, h + 3, 5)).astype(np.float32)
    p = {"w": rng.standard_normal((k, k, 5, 6)).astype(np.float32),
         "b": rng.standard_normal((6,)).astype(np.float32)}
    got = L.conv2d(_torch(p), torch.from_numpy(x), stride=stride)
    want = JL.conv2d(_jax(p), jnp.asarray(x), stride=stride)
    assert tuple(got.shape) == want.shape
    assert want.shape[1] == -(-h // stride)
    _close(got, want, rtol=1e-5)


@pytest.mark.parametrize("size,out", [(4, 8), (8, 4), (7, 2), (1, 2),
                                      (8, 12), (5, 6)])
def test_resize_nearest_matches_jax(size, out):
    x = np.arange(2 * size * size * 3, dtype=np.float32).reshape(
        2, size, size, 3)
    got = TC.resize_nearest(torch.from_numpy(x), out, out)
    want = jax.image.resize(jnp.asarray(x), (2, out, out, 3), "nearest")
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


@pytest.mark.parametrize("size,out", [(4, 8), (1, 2), (3, 12), (5, 6)])
def test_resize_nearest_gradient_matches_jax(size, out):
    """The backward of the resize (a sum over each output's source, by
    ``expand`` for whole factors) equals jax's, bit for bit."""
    rng = np.random.default_rng(size * 13 + out)
    x = rng.standard_normal((2, size, size, 3)).astype(np.float32)
    g = rng.standard_normal((2, out, out, 3)).astype(np.float32)
    xt = torch.from_numpy(x).requires_grad_(True)
    (got,) = torch.autograd.grad(TC.resize_nearest(xt, out, out),
                                 xt, torch.from_numpy(g))
    _, vjp = jax.vjp(lambda a: jax.image.resize(a, (2, out, out, 3),
                                                "nearest"), jnp.asarray(x))
    (want,) = vjp(jnp.asarray(g))
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))


# -- defs and metas -----------------------------------------------------------

def _boundaries(cfg):
    """(feat_hw, feat_c) after each candidate layer 1..n-1."""
    shapes = V.feature_shapes(cfg)
    out = []
    for layer in range(1, len(cfg.cnn_layers)):
        s = shapes[layer]
        out.append((s[0], s[2]) if len(s) == 3 else (1, s[0]))
    return out


def _def_tuples(defs):
    return {k: tuple(tuple(x) if isinstance(x, tuple) else x for x in d)
            for k, d in _flat_defs(defs).items()}


def _flat_defs(defs, prefix=""):
    if JL.is_def(defs) or L.is_def(defs):
        return {prefix: defs}
    out = {}
    for k in sorted(defs):
        out.update(_flat_defs(defs[k], f"{prefix}/{k}"))
    return out


@pytest.mark.parametrize("model", ["smoke", "vgg16"])
def test_defs_and_metas_match_reference(model):
    cfg = get_smoke("vgg16") if model == "smoke" else get_config("vgg16")
    jcfg = jget_smoke("vgg16") if model == "smoke" else jget_config("vgg16")
    bounds = _boundaries(cfg)
    assert len(bounds) == len(jcfg.cnn_layers) - 1
    for hw, c in bounds:
        for name in ("generator_defs", "discriminator_defs"):
            tdefs, tmeta = getattr(TC, name)(hw, c, cfg.image_size)
            jdefs, jmeta = getattr(JC, name)(hw, c, jcfg.image_size)
            assert tmeta == jmeta, (name, hw, c)
            assert _def_tuples(tdefs) == _def_tuples(jdefs), (name, hw, c)


def test_feature_shapes_are_the_references():
    """The boundaries above are the reference's VGG feature shapes."""
    cfg, jcfg = get_config("vgg16"), jget_config("vgg16")
    assert [tuple(s) for s in V.feature_shapes(cfg)] == \
        [tuple(s) for s in JV.feature_shapes(jcfg)]


# -- applies, losses and gradients --------------------------------------------

# (feat_hw, feat_c, img_size): a conv boundary with one downsample, a
# smaller map, an fc-like 1x1 condition
GAN_CASES = [(8, 4, 16), (4, 5, 16), (1, 6, 16)]
# the discriminator also aligns a condition map that its downsampling does
# not reach exactly (8 -> 12)
DISC_CASES = GAN_CASES + [(8, 4, 24)]


def _gan(case, seed):
    hw, c, img = case
    rng = np.random.default_rng(seed)
    g_defs, meta_g = JC.generator_defs(hw, c, img)
    d_defs, meta_d = JC.discriminator_defs(hw, c, img)
    gp, dp = _tree_np(g_defs, rng), _tree_np(d_defs, rng)
    feat = rng.standard_normal((3, hw, hw, c)).astype(np.float32)
    real = rng.random((3, img, img, 3)).astype(np.float32)
    return gp, dp, meta_g, meta_d, feat, real


@pytest.mark.parametrize("case", GAN_CASES, ids=str)
def test_generator_apply_matches_reference(case):
    gp, _, meta_g, _, feat, _ = _gan(case, 1)
    got = TC.generator_apply(_torch(gp), torch.from_numpy(feat), meta_g)
    want = JC.generator_apply(_jax(gp), jnp.asarray(feat), meta_g)
    assert tuple(got.shape) == want.shape == (3, case[2], case[2], 3)
    _close(got, want)


@pytest.mark.parametrize("case", DISC_CASES, ids=str)
def test_discriminator_apply_matches_reference(case):
    hw, c, img = case
    rng = np.random.default_rng(2)
    d_defs, meta_d = JC.discriminator_defs(hw, c, img)
    dp = _tree_np(d_defs, rng)
    img_x = rng.random((3, img, img, 3)).astype(np.float32)
    feat = rng.standard_normal((3, hw, hw, c)).astype(np.float32)
    got = TC.discriminator_apply(_torch(dp), torch.from_numpy(img_x),
                                 torch.from_numpy(feat), meta_d)
    want = JC.discriminator_apply(_jax(dp), jnp.asarray(img_x),
                                  jnp.asarray(feat), meta_d)
    assert tuple(got.shape) == want.shape == (3,)
    _close(got, want)


def test_bce_logits_matches_reference():
    x = np.linspace(-30, 30, 101, dtype=np.float32)
    for target in (0.0, 1.0):
        _close(TC.bce_logits(torch.from_numpy(x), target),
               JC.bce_logits(jnp.asarray(x), target), rtol=1e-6)


@pytest.mark.parametrize("case", GAN_CASES, ids=str)
def test_losses_and_gradients_match_reference(case):
    gp, dp, meta_g, meta_d, feat, real = _gan(case, 3)
    tfeat, treal = torch.from_numpy(feat), torch.from_numpy(real)
    jfeat, jreal = jnp.asarray(feat), jnp.asarray(real)

    dl, dgrad = TR._value_and_grad(
        lambda d_: TC.d_loss_fn(d_, _torch(gp), tfeat, treal, meta_g,
                                meta_d), _torch(dp))
    jdl, jdgrad = jax.value_and_grad(
        lambda d_: JC.d_loss_fn(d_, _jax(gp), jfeat, jreal, meta_g,
                                meta_d))(_jax(dp))
    _close(dl, jdl)
    _close_trees(dgrad, jdgrad, "d grad")

    gl, ggrad = TR._value_and_grad(
        lambda g_: TC.g_loss_fn(g_, _torch(dp), tfeat, treal, meta_g,
                                meta_d)[0], _torch(gp))
    (jgl, _), jggrad = jax.value_and_grad(
        lambda g_: JC.g_loss_fn(g_, _jax(dp), jfeat, jreal, meta_g, meta_d),
        has_aux=True)(_jax(gp))
    _close(gl, jgl)
    _close_trees(ggrad, jggrad, "g grad")


def test_d_loss_does_not_reach_the_generator():
    """The fake image enters D's loss detached (the reference's
    stop_gradient): the generator's weights get no gradient from it."""
    gp, dp, meta_g, meta_d, feat, real = _gan(GAN_CASES[0], 4)
    live = {k: {n: v.requires_grad_(True) for n, v in leaf.items()}
            for k, leaf in _torch(gp).items()}
    loss = TC.d_loss_fn(_torch(dp), live, torch.from_numpy(feat),
                        torch.from_numpy(real), meta_g, meta_d)
    assert not loss.requires_grad


def test_one_adversary_step_matches_reference():
    """One D+G step of the port's ``reconstruct.adversary_step`` from the
    same parameters as the reference's ``step_fn`` body (jitted as it runs
    it): D's loss and update with the current G, G's loss with the updated
    D, each with its own AdamW state. The gradients are held through both
    moments of both networks: after one step each is (1 - b) times the
    clipped gradient or its square."""
    gp, dp, meta_g, meta_d, feat, real = _gan(GAN_CASES[0], 5)
    lr = 2e-4
    kw = dict(learning_rate=lr, warmup_steps=0, total_steps=10,
              weight_decay=0.0, grad_clip=1.0, b1=0.5, b2=0.999)
    tcfg, jcfg = TrainConfig(**kw), JTrainConfig(**kw)

    @jax.jit
    def jstep(gp, dp, g_opt, d_opt, feat, real):
        dl, dgrad = jax.value_and_grad(
            lambda d_: JC.d_loss_fn(d_, gp, feat, real, meta_g, meta_d)
        )(dp)
        dp2, d_opt2, _ = JA.update(dgrad, d_opt, dp, jcfg, jnp.float32(lr))
        (gl, _), ggrad = jax.value_and_grad(
            lambda g_: JC.g_loss_fn(g_, dp2, feat, real, meta_g, meta_d),
            has_aux=True)(gp)
        gp2, g_opt2, _ = JA.update(ggrad, g_opt, gp, jcfg, jnp.float32(lr))
        return gp2, dp2, g_opt2, d_opt2, gl, dl, dgrad, ggrad

    jgp, jdp = _jax(gp), _jax(dp)
    jout = jstep(jgp, jdp, JA.init(jgp, jcfg), JA.init(jdp, jcfg),
                 jnp.asarray(feat), jnp.asarray(real))

    tgp, tdp = _torch(gp), _torch(dp)
    tfeat, treal = torch.from_numpy(feat), torch.from_numpy(real)
    gp2, dp2, g_opt2, d_opt2, gl, dl = TR.adversary_step(
        tgp, tdp, TA.init(tgp, tcfg), TA.init(tdp, tcfg), tfeat, treal,
        meta_g, meta_d, tcfg, lr)

    jgp2, jdp2, jg_opt2, jd_opt2, jgl, jdl, jdgrad, jggrad = jout
    _close(dl, jdl)
    _close(gl, jgl)
    _close_update(dp2, jdp2, jdgrad, lr, "updated D")
    _close_update(gp2, jgp2, jggrad, lr, "updated G")
    _close_trees(d_opt2.mu, jd_opt2.mu, "D first moment")
    _close_trees(d_opt2.nu, jd_opt2.nu, "D second moment")
    _close_trees(g_opt2.mu, jg_opt2.mu, "G first moment")
    _close_trees(g_opt2.nu, jg_opt2.nu, "G second moment")
    assert int(g_opt2.step) == int(d_opt2.step) == int(jg_opt2.step) == 1
