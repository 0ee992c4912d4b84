"""The port's sealed channel, attestation and plan digest against the JAX
reference: same ciphertext, same MAC, boxes open across the two packages,
same Quote and plan digest for the same weights and plan."""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import attestation as jatt  # noqa: E402
from repro.core import integrity as jig  # noqa: E402
from repro.core import plan as jplan  # noqa: E402
from repro.core import sealing as jseal  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import attestation as tatt  # noqa: E402
from repro_torch.core import integrity as tig  # noqa: E402
from repro_torch.core import plan as tplan  # noqa: E402
from repro_torch.core import sealing as tseal  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402


def _to_jax_box(box):
    return jseal.SealedBox(
        ciphertext=jnp.asarray(box.ciphertext.numpy().astype(np.uint32)),
        nonce=jnp.asarray(box.nonce, jnp.uint32),
        mac=jnp.asarray(box.mac, jnp.uint32))


def _to_torch_box(box):
    return tseal.SealedBox(
        ciphertext=torch.from_numpy(
            np.asarray(box.ciphertext).astype(np.int64)),
        nonce=np.asarray(box.nonce, np.uint32), mac=int(box.mac))


@pytest.mark.parametrize("shape,nonce", [((4, 8), [1, 2]),
                                         ((3,), [7, 0, 0xEE]),
                                         ((32, 32, 3), [2 ** 32 - 1, 5]),
                                         ((10,), [0, 0])])
def test_seal_bit_equal_and_opens_across(shape, nonce, rng):
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    x = rng.normal(size=shape).astype(np.float32)
    jbox = jseal.seal(jnp.asarray(key), jnp.asarray(x),
                      jnp.asarray(nonce, jnp.uint32))
    tbox = tseal.seal(key, torch.from_numpy(x), np.asarray(nonce, np.uint32))
    np.testing.assert_array_equal(tbox.ciphertext.numpy(),
                                  np.asarray(jbox.ciphertext).astype(np.int64))
    assert tbox.mac == int(jbox.mac)
    # a box sealed by one package opens under the other
    pt, ok = tseal.unseal(key, _to_torch_box(jbox), shape)
    assert ok
    np.testing.assert_array_equal(pt.numpy(), x)
    pt, ok = jseal.unseal(jnp.asarray(key), _to_jax_box(tbox), shape)
    assert bool(ok)
    np.testing.assert_array_equal(np.asarray(pt), x)


@pytest.mark.parametrize("field", ["ciphertext", "nonce", "mac", "key"])
def test_tampering_fails_mac(field, rng):
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    x = torch.from_numpy(rng.normal(size=(4, 8)).astype(np.float32))
    box = tseal.seal(key, x, np.asarray([1, 2, 0xEE], np.uint32))
    if field == "ciphertext":
        ct = box.ciphertext.clone()
        ct[0, 0] ^= 1
        box = box._replace(ciphertext=ct)
    elif field == "nonce":
        box = box._replace(nonce=np.asarray([3, 2, 0xEE], np.uint32))
    elif field == "mac":
        box = box._replace(mac=box.mac ^ 1)
    else:
        key = key ^ np.uint32(1)
    pt, ok = tseal.unseal(key, box, (4, 8))
    assert not ok
    stripped = box._replace(nonce=box.nonce[:2])     # drop the direction tag
    assert not tseal.unseal(key, stripped, (4, 8))[1]


def _np_params(cfg, seed=0):
    rng = np.random.default_rng(seed)
    return {layer: {k: rng.normal(size=d.shape).astype(np.float32)
                    for k, d in leaves.items()}
            for layer, leaves in V.vgg_defs(cfg).items()}


def test_quote_equal_for_same_weights_and_plan():
    jcfg, cfg = jget_smoke("vgg16"), get_smoke("vgg16")
    assert cfg.to_json() == jcfg.to_json()
    npp = _np_params(cfg)
    jparams = jax.tree.map(jnp.asarray, npp)
    tparams = V.params_from_numpy(npp, device="cpu")
    for mode in ("origami", "slalom"):
        jp = jplan.compile_mode(jcfg, mode)
        tp = tplan.compile_mode(cfg, mode)
        jq = jatt.measure_enclave(jcfg, jparams, jp.boundary,
                                  plan_digest=jp.digest)
        tq = tatt.measure_enclave(cfg, tparams, tp.boundary,
                                  plan_digest=tp.digest)
        assert dataclasses.asdict(tq) == dataclasses.asdict(jq)
        assert tatt.verify_quote(tq, tatt.Quote(**dataclasses.asdict(jq)))
    # sensitive to the partition and to the weights
    q = tatt.measure_enclave(cfg, tparams, 3)
    assert not tatt.verify_quote(q, tatt.measure_enclave(cfg, tparams, 4))
    tparams["l0"]["b"] = tparams["l0"]["b"] + 1.0
    assert (tatt.measure_enclave(cfg, tparams, 3).measurement
            != q.measurement)


@pytest.mark.parametrize("name", ["vgg16", "vgg19"])
def test_plan_digest_and_segments_match(name):
    jcfg, cfg = jget_smoke(name), get_smoke(name)
    n = len(cfg.cnn_layers)
    for mode in jplan.LEGACY_MODES:
        for part in (None, 1, 2):
            jp = jplan.compile_mode(jcfg, mode, part)
            tp = tplan.compile_mode(cfg, mode, part)
            assert tp.digest == jp.digest, (mode, part)
            assert [(s.lo, s.hi, s.regime) for s in tp.segments] == \
                [(s.lo, s.hi, s.regime) for s in jp.segments]
            assert [s.precompute_slot for s in tp.steps] == \
                [s.precompute_slot for s in jp.steps]
    placements = ["blinded", "enclave"] + ["open"] * (n - 2)
    jp = jplan.make_plan(jcfg, placements,
                         integrity={0: jig.IntegrityPolicy.full(2),
                                    n - 1: jig.IntegrityPolicy.sampled(0.5)})
    tp = tplan.make_plan(cfg, placements,
                         integrity={0: tig.IntegrityPolicy.full(2),
                                    n - 1: tig.IntegrityPolicy.sampled(0.5)})
    assert tp.digest == jp.digest and tp.boundary == jp.boundary
    assert [(s.lo, s.hi, s.regime) for s in tp.segments] == \
        [(s.lo, s.hi, s.regime) for s in jp.segments]
    assert [s.layer_id for s in tp.cache_ops] == \
        [s.layer_id for s in jp.cache_ops]
