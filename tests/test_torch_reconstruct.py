"""The port's keyed initializer and normal draws, ``collect_features``,
``partition_search`` (Algorithm 1) and ``token_recovery_probe``
(``privacy/reconstruct.py``) against the reference on the CPU;
``train_adversary`` is held to the reference in
tests/test_torch_adversary.py.

Tolerances, each measured on the CPU:

- ``prng.normal`` and ``init_params_keyed``: within 4 ulps of jax
  (``normal``'s erfinv goes through torch's log1p, not XLA's; 99% of the
  draws are bit-equal and the largest gap seen is 3 ulps);
- ``collect_features``: rtol 1e-4 plus atol 1e-4 of the largest magnitude
  (float convolutions summed in another order);
- ``partition_search``: the same partition and the same layers in the same
  order, under the reference test's stubbed SSIM schedule;
- ``token_recovery_probe``: the tokens bit-equal, the accuracies within
  0.02 (10 of 512 evaluated tokens).
"""
import numpy as np
import pytest
import torch

torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.privacy import cgan as JC  # noqa: E402
from repro.privacy import reconstruct as JR  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.privacy import cgan as TC  # noqa: E402
from repro_torch.privacy import reconstruct as TR  # noqa: E402
from repro_torch.privacy.data import make_batch  # noqa: E402

ACC_TOL = 0.02


def _flat(tree, prefix=""):
    if isinstance(tree, dict):
        out = {}
        for k in sorted(tree):
            out.update(_flat(tree[k], f"{prefix}/{k}"))
        return out
    if isinstance(tree, torch.Tensor):
        return {prefix: tree.numpy()}
    return {prefix: np.asarray(tree)}


@pytest.fixture(scope="module")
def smoke_vgg():
    """Smoke VGG-16 weights from the reference's initializer (jitted) as
    numpy, and the smoke configs of both packages."""
    jcfg = jget_smoke("vgg16")
    jp = jax.jit(lambda k: JM.init_params(jcfg, k))(jax.random.PRNGKey(0))
    return jax.tree.map(np.asarray, jp), get_smoke("vgg16"), jcfg


@pytest.mark.parametrize("seed,shape", [(0, (100_000,)), (3, (3, 3, 64, 64)),
                                        (7, (5, 35, 2)), (11, ())])
def test_normal_matches_jax(seed, shape):
    got = prng.normal(prng.PRNGKey(seed), shape).numpy()
    want = np.asarray(jax.random.normal(jax.random.PRNGKey(seed), shape,
                                        jnp.float32))
    assert got.shape == want.shape and got.dtype == want.dtype
    np.testing.assert_array_max_ulp(got, want, maxulp=4)
    if got.size > 1000:
        assert (got == want).mean() > 0.95


@pytest.mark.parametrize("which", ["vgg_smoke", "generator", "discriminator"])
def test_init_params_keyed_matches_reference(which):
    if which == "vgg_smoke":
        defs = V.vgg_defs(get_smoke("vgg16"))
        jdefs = JM.model_defs(jget_smoke("vgg16"))
    else:
        fn = "generator_defs" if which == "generator" else \
            "discriminator_defs"
        defs, _ = getattr(TC, fn)(8, 16, 32)
        jdefs, _ = getattr(JC, fn)(8, 16, 32)
    kg, kd = prng.split(prng.PRNGKey(0))
    jkg, jkd = jax.random.split(jax.random.PRNGKey(0))
    got = _flat(L.init_params_keyed(kd, defs, torch.float32, "cpu"))
    want = _flat(jax.jit(lambda k: JL.init_params(k, jdefs, jnp.float32))(
        jkd))
    assert sorted(got) == sorted(want)
    for k in want:
        assert got[k].dtype == want[k].dtype, k
        np.testing.assert_array_max_ulp(got[k], want[k], maxulp=4)
        if k.endswith("/b"):                 # zeros that used up a key
            assert not got[k].any(), k


@pytest.mark.parametrize("layer", range(1, 8))
def test_collect_features_matches_reference(smoke_vgg, layer):
    np_params, cfg, jcfg = smoke_vgg
    images = make_batch(100, 4, cfg.image_size)
    got = TR.collect_features(V.params_from_numpy(np_params, "cpu"),
                              torch.from_numpy(images), cfg, layer)
    want = np.asarray(JR.collect_features(np_params, jnp.asarray(images),
                                          jcfg, layer))
    assert tuple(got.shape) == want.shape and want.ndim == 4
    assert not got.requires_grad
    np.testing.assert_allclose(got.numpy(), want, rtol=1e-4,
                               atol=1e-4 * float(np.abs(want).max()))


def test_partition_search_matches_reference(monkeypatch):
    """Algorithm 1 with the reference test's stubbed schedule (paper Fig.
    8: high, high, low, HIGH again, low, low, low), run through both
    packages."""
    schedule = {1: 0.8, 2: 0.7, 3: 0.2, 4: 0.6, 5: 0.2, 6: 0.15, 7: 0.1}

    def fake(report):
        def train(params, cfg_, layer, **kw):
            return report(layer=layer, ssim=schedule.get(layer, 0.05),
                          g_loss=0, d_loss=0, steps=kw["steps"])
        return train

    monkeypatch.setattr(JR, "train_adversary", fake(JR.AdversaryReport))
    monkeypatch.setattr(TR, "train_adversary", fake(TR.AdversaryReport))
    for kw in (dict(max_layer=7), dict(max_layer=7, verify_depth=1),
               dict(threshold=0.1), dict(max_layer=4)):
        jp, jreps = JR.partition_search(None, jget_smoke("vgg16"), **kw)
        tp, treps = TR.partition_search(None, get_smoke("vgg16"), **kw)
        assert tp == jp, kw
        assert [r.layer for r in treps] == [r.layer for r in jreps], kw
    p, reports = TR.partition_search(None, get_smoke("vgg16"),
                                     threshold=0.35, max_layer=7)
    assert p == 5 and {3, 4, 5, 6, 7} <= {r.layer for r in reports}


def test_partition_search_shares_one_image_cache(monkeypatch):
    """Every layer of a walk trains on the one image cache: a fresh one by
    default, the caller's when given."""
    caches = []

    def train(params, cfg_, layer, **kw):
        caches.append(kw["image_cache"])
        return TR.AdversaryReport(layer=layer, ssim=0.9, g_loss=0,
                                  d_loss=0, steps=kw["steps"])

    monkeypatch.setattr(TR, "train_adversary", train)
    TR.partition_search(None, get_smoke("vgg16"), max_layer=4)
    assert len(caches) == 4 and isinstance(caches[0], dict)
    assert all(c is caches[0] for c in caches)
    mine = {}
    caches.clear()
    TR.partition_search(None, get_smoke("vgg16"), max_layer=3,
                        image_cache=mine)
    assert len(caches) == 3 and all(c is mine for c in caches)


def test_image_cache_draws_each_batch_once():
    cache = {}
    a = TR._images(7, 3, 16, torch.device("cpu"), cache)
    b = TR._images(7, 3, 16, torch.device("cpu"), cache)
    assert a is b and len(cache) == 1
    np.testing.assert_array_equal(a.numpy(), make_batch(7, 3, 16))
    c = TR._images(7, 3, 16, torch.device("cpu"))
    assert c is not a and torch.equal(c, a)


def test_train_adversary_same_with_image_cache(smoke_vgg):
    """A run on cached images is the run on fresh draws: a first run fills
    the cache, a second reads it, and all three reports agree exactly."""
    np_params, cfg, _ = smoke_vgg
    params = V.params_from_numpy(np_params, "cpu")
    kw = dict(steps=2, batch=2, n_eval=4, device="cpu")
    plain = TR.train_adversary(params, cfg, 2, **kw)
    cache = {}
    fill = TR.train_adversary(params, cfg, 2, image_cache=cache, **kw)
    n = len(cache)
    again = TR.train_adversary(params, cfg, 2, image_cache=cache, **kw)
    assert n == 4 and len(cache) == n       # probe, 2 steps, held-out
    for rep in (fill, again):
        assert (rep.ssim, rep.g_loss, rep.d_loss) == \
            (plain.ssim, plain.g_loss, plain.d_loss)


def _probe_both(t_fn, j_fn, vocab, d):
    seen_t, seen_j = [], []

    def tb(t):
        seen_t.append(t.numpy().copy())
        return t_fn(t)

    def jb(t):
        seen_j.append(np.asarray(t))
        return j_fn(t)

    kw = dict(steps=80, batch=8, seq=16)
    got = TR.token_recovery_probe(tb, vocab, d, device="cpu", **kw)
    want = JR.token_recovery_probe(jb, vocab, d, **kw)
    assert len(seen_t) == len(seen_j) == 81
    for a, b in zip(seen_t, seen_j):
        assert a.dtype == b.dtype == np.int32
        np.testing.assert_array_equal(a, b)
    return got, want


def test_token_recovery_probe_on_identity():
    """A boundary that IS the embedding is recoverable (the reference
    test's case)."""
    vocab, d = 64, 32
    emb = np.array(jax.random.normal(jax.random.PRNGKey(0), (vocab, d)))
    temb = torch.from_numpy(emb)
    got, want = _probe_both(lambda t: temb[t.long()],
                            lambda t: jnp.asarray(emb)[t], vocab, d)
    assert abs(got - want) <= ACC_TOL, (got, want)
    assert got > 0.9


def test_token_recovery_probe_on_noise():
    """Random noise independent of the tokens is not recoverable (the
    reference test's case; the port's noise is ``prng.normal``)."""
    vocab, d = 64, 32
    got, want = _probe_both(
        lambda t: prng.normal(prng.PRNGKey(1), tuple(t.shape) + (d,)),
        lambda t: jax.random.normal(jax.random.PRNGKey(1), t.shape + (d,)),
        vocab, d)
    assert abs(got - want) <= ACC_TOL, (got, want)
    assert got < 0.2


def test_cross_entropy_masks_the_padded_vocab():
    rng = np.random.default_rng(5)
    logits = rng.standard_normal((3, 4, 10)).astype(np.float32)
    labels = rng.integers(0, 7, (3, 4)).astype(np.int32)
    for vocab in (7, 10):
        got = float(L.cross_entropy(torch.from_numpy(logits),
                                    torch.from_numpy(labels), vocab))
        want = float(JL.cross_entropy(jnp.asarray(logits),
                                      jnp.asarray(labels), vocab))
        assert got == pytest.approx(want, rel=1e-6)
