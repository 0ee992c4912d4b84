"""The port's sealed serving (runtime/serving.py) against the JAX
reference's server on the VGG-16 and VGG-19 smoke configs, on the CPU.

The logits go through float tier-2, whose summation order differs between
torch and XLA, so they are held to atol 1e-4 * max|ref|; the sealed
channel itself is bit-equal (tests/test_torch_sealing.py).
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
from repro.core import sealing as jseal  # noqa: E402
from repro.runtime import serving as jserve  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core import sealing as tseal  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime import serving as tserve  # noqa: E402


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


def test_serve_batch_matches_reference_server(model):
    """Requests sealed once, served by both servers; each response opens
    under either package and carries the same logits (to tier-2
    tolerance); the tampered request is rejected by both."""
    cfg, jcfg, npp, x = model
    jsrv = jserve.PrivateInferenceServer(
        jcfg, jax.tree.map(jnp.asarray, npp), max_batch=4,
        integrity=JIG.IntegrityPolicy.full(2))
    tsrv = tserve.PrivateInferenceServer(
        cfg, V.params_from_numpy(npp, "cpu"), max_batch=4,
        integrity=TIG.IntegrityPolicy.full(2), device="cpu")
    assert dataclasses.asdict(tsrv.attest()) == dataclasses.asdict(
        jsrv.attest())
    rng = np.random.default_rng(5)
    keys = [rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
            for _ in range(3)]
    imgs = [x[0], x[1], x[0] * 0.25]
    treqs, jreqs = [], []
    for rid, (k, img) in enumerate(zip(keys, imgs)):
        box = tsrv.client_seal(k, img, rid + 2 ** 33)
        jbox = jsrv.client_seal(k, img, rid + 2 ** 33)
        np.testing.assert_array_equal(box.ciphertext.numpy(),
                                      np.asarray(jbox.ciphertext))
        treqs.append(tserve.Request(rid, box, img.shape, k))
        jreqs.append(jserve.Request(rid, jbox, img.shape, k))
    bad = treqs[1].box.ciphertext.clone()
    bad.view(-1)[5] ^= 4
    treqs[1] = dataclasses.replace(treqs[1],
                                   box=treqs[1].box._replace(ciphertext=bad))
    jreqs[1] = dataclasses.replace(jreqs[1], box=jreqs[1].box._replace(
        ciphertext=jnp.asarray(bad.numpy().astype(np.uint32))))
    tres, jres = tsrv.serve_batch(treqs), jsrv.serve_batch(jreqs)
    assert [r.ok for r in tres] == [r.ok for r in jres] == [True, False, True]
    assert tres[1].error == jres[1].error == "mac_failed"
    for i in (0, 2):
        tl = tsrv.client_open(keys[i], tres[i].box, (cfg.num_classes,))
        jl = jsrv.client_open(keys[i], jres[i].box, (cfg.num_classes,))
        _close(tl, np.asarray(jl))
        # the port's response opens under the reference's client
        jbox = jseal.SealedBox(
            jnp.asarray(tres[i].box.ciphertext.numpy().astype(np.uint32)),
            jnp.asarray(tres[i].box.nonce), jnp.asarray(tres[i].box.mac,
                                                        jnp.uint32))
        np.testing.assert_array_equal(
            jsrv.client_open(keys[i], jbox, (cfg.num_classes,)), tl)
    assert tsrv.batches == 1 and tsrv.processed == 2
    with pytest.raises(ValueError, match="max_batch"):
        tsrv.serve_batch(treqs + treqs)
    assert tsrv.serve_batch([treqs[1]])[0].error == "mac_failed"
    assert tsrv.batches == 1
    with pytest.raises(ValueError, match="MAC"):
        tsrv.client_open(keys[0], tseal.SealedBox(
            tres[0].box.ciphertext, tres[0].box.nonce, tres[0].box.mac ^ 1),
            (cfg.num_classes,))


def test_failed_check_retries_then_recomputes(model, monkeypatch):
    """The recovery ladder: a batch whose Freivalds check fails is re-run
    under a fresh session, then recomputed in the enclave; the response
    still carries the honest logits, flagged."""
    cfg, _, npp, x = model
    tex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"),
                          precompute=True, device="cpu",
                          integrity=TIG.IntegrityPolicy.full(1))
    honest = tex.infer({"images": x[:1]}, session_key=np.asarray(
        jax.random.PRNGKey(4))).logits.numpy()
    real_infer, calls = tex.infer, []

    def dishonest(batch, session_key=None, trusted=False):
        res = real_infer(batch, session_key=session_key, trusted=trusted)
        calls.append((bytes(np.asarray(session_key, np.uint32)), trusted))
        if not trusted:                 # every device answer "fails"
            res.integrity.failed[0] = True
        return res

    monkeypatch.setattr(tex, "infer", dishonest)
    key = np.random.default_rng(0).integers(0, 2 ** 32 - 1, (2,), np.uint32)
    req = tserve.Request(1, tserve.PrivateInferenceServer.client_seal(
        key, x[0], 1), x[0].shape, key)
    boxes, n_valid, pad, integ = tserve.execute_sealed_batch(
        tex, [req], max_batch=4,
        session_key=np.asarray(jax.random.PRNGKey(9), np.uint32))
    assert (n_valid, pad) == (1, 0)
    assert integ.retried and integ.recomputed and integ.flagged
    assert integ.checks == 4 and integ.failures == 2   # 2 ops x 2 tries
    assert [t for _, t in calls] == [False, False, True]
    assert calls[0][0] != calls[1][0]          # fresh pads for the retry
    out = tserve.PrivateInferenceServer.client_open(key, boxes[0],
                                                    (cfg.num_classes,))
    np.testing.assert_array_equal(out, honest[0])
