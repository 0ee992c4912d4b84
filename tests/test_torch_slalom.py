"""The Slalom protocol of the port (core/slalom.py, core/precompute.py,
core/integrity.py) bit-for-bit against the JAX reference, on the CPU.

The reference runs eagerly here (op by op, as its tests call these
functions), where every float op is IEEE-rounded as in the port."""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.core import blinding as JB  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core import precompute as JPC  # noqa: E402
from repro.core import slalom as JS  # noqa: E402
from repro_torch.core import blinding as TB  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core import precompute as TPC  # noqa: E402
from repro_torch.core import slalom as TS  # noqa: E402
from repro_torch.kernels.limb_matmul.ref import P  # noqa: E402

POLICIES = {"off": (JIG.IntegrityPolicy.off(), TIG.IntegrityPolicy.off()),
            "full2": (JIG.IntegrityPolicy.full(2), TIG.IntegrityPolicy.full(2)),
            "sampled": (JIG.IntegrityPolicy.sampled(0.5),
                        TIG.IntegrityPolicy.sampled(0.5))}


def _t(a):
    return torch.from_numpy(np.array(a))


@pytest.fixture(scope="module")
def conv_case():
    rng = np.random.default_rng(11)
    x = (rng.normal(size=(2, 12, 12, 5)) * 0.5).astype(np.float32)
    w = (rng.normal(size=(3, 3, 5, 8)) / np.sqrt(45)).astype(np.float32)
    b = (rng.normal(size=(8,)) * 0.1).astype(np.float32)
    return x, w, b


def _log(entries):
    return [tuple(bool(v) for v in e) for e in entries]


def test_extract_patches_matches_reference_order(conv_case):
    x, w, _ = conv_case
    jcols, jhw = JS.extract_patches(jnp.asarray(x), 3, 3)
    tcols, thw = TS.extract_patches(_t(x), 3, 3)
    assert tuple(thw) == tuple(jhw)
    np.testing.assert_array_equal(tcols.numpy(), np.asarray(jcols))
    np.testing.assert_array_equal(TS.conv_weight_cols(_t(w)).numpy(),
                                  np.asarray(JS.conv_weight_cols(
                                      jnp.asarray(w))))


def test_quantize_weight_bit_equal(conv_case):
    _, w, _ = conv_case
    jq, js = JB.quantize_weight(jnp.asarray(w), JB.BlindingSpec())
    tq, ts = TB.quantize_weight(_t(w), TB.BlindingSpec())
    np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
    assert ts.item() == float(js)


@pytest.mark.parametrize("policy", list(POLICIES))
@pytest.mark.parametrize("layer", ["conv", "dense"])
def test_blinded_op_bit_equal_live(conv_case, policy, layer):
    """The live path: pads, factors, fold vectors and sampling decisions
    drawn on the request, all from the same session key."""
    x, w, b = conv_case
    jpol, tpol = POLICIES[policy]
    key = jax.random.PRNGKey(21)
    jctx = JS.SlalomContext(key, integrity=jpol)
    tctx = TS.SlalomContext(np.asarray(key), integrity=tpol)
    if layer == "conv":
        jy = JS.blinded_conv2d(jctx, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                               jnp.asarray(x))
        ty = TS.blinded_conv2d(tctx, {"w": _t(w), "b": _t(b)}, _t(x))
    else:
        xf = x.reshape(2, -1)[:, :40]
        wd = w.reshape(45, 8)[:40]
        jy = JS.blinded_dense(jctx, {"w": jnp.asarray(wd), "b": jnp.asarray(b)},
                              jnp.asarray(xf))
        ty = TS.blinded_dense(tctx, {"w": _t(wd), "b": _t(b)}, _t(xf))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert dataclasses.asdict(tctx.telemetry) == dataclasses.asdict(
        jctx.telemetry)
    assert _log(tctx.integrity_log) == _log(jctx.integrity_log)


def test_sampled_decisions_match_reference():
    pol_j, pol_t = POLICIES["sampled"]
    for seed in range(4):
        key = jax.random.PRNGKey(seed)
        for op in range(6):
            for step in (0, 3):
                assert TIG.decide(pol_t, np.asarray(key), op, step) == bool(
                    JIG.decide(pol_j, key, op, step))


def test_trusted_bit_equal_to_reference_and_to_blinded(conv_case):
    x, w, b = conv_case
    p_t = {"w": _t(w), "b": _t(b)}
    jctx = JS.SlalomContext(jax.random.PRNGKey(0), trusted=True)
    jy = JS.blinded_conv2d(jctx, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x))
    tctx = TS.SlalomContext(np.asarray(jax.random.PRNGKey(0)), trusted=True)
    ty = TS.blinded_conv2d(tctx, p_t, _t(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert dataclasses.asdict(tctx.telemetry) == dataclasses.asdict(
        jctx.telemetry)
    blinded = TS.blinded_conv2d(TS.SlalomContext(np.asarray(
        jax.random.PRNGKey(77))), p_t, _t(x))
    np.testing.assert_array_equal(ty.numpy(), blinded.numpy())


def _records(w, t, kind="conv"):
    return [{"kind": kind, "w": w, "t": t, "d_in": 45, "d_out": 8}]


def test_cache_factors_bit_equal_and_cached_equals_live(conv_case):
    x, w, b = conv_case
    key = jax.random.PRNGKey(5)
    t = x.shape[0] * x.shape[1] * x.shape[2]
    jcache = JPC.BlindedLayerCache.from_records(
        _records(jnp.asarray(w), t) * 2, JB.BlindingSpec(),
        integrity=JIG.IntegrityPolicy.full(2))
    tcache = TPC.BlindedLayerCache.from_records(
        _records(_t(w), t) * 2, TB.BlindingSpec(),
        integrity=TIG.IntegrityPolicy.full(2))
    jf = jcache.session_factors(key)
    tf = tcache.session_factors(np.asarray(key))
    for je, te in zip(jf, tf):
        for name in ("r", "u", "s", "ws", "w_q"):
            np.testing.assert_array_equal(te[name].numpy(),
                                          np.asarray(je[name]), err_msg=name)
        np.testing.assert_array_equal(te["w_limbs"][:, :45].numpy(),
                                      np.asarray(je["w_limbs"])[:, :45, :8])
    assert (tcache.factor_matmuls, tcache.fold_matmuls) == (2, 2)
    # the cached request issues no factor matmul and matches the live one
    p = {"w": _t(w), "b": _t(b)}
    cached = TS.SlalomContext(np.asarray(key), factors=tcache.take(
        np.asarray(key)), integrity=TIG.IntegrityPolicy.full(2))
    live = TS.SlalomContext(np.asarray(key),
                            integrity=TIG.IntegrityPolicy.full(2))
    yc = TS.blinded_conv2d(cached, p, _t(x))
    yl = TS.blinded_conv2d(live, p, _t(x))
    np.testing.assert_array_equal(yc.numpy(), yl.numpy())
    assert cached.telemetry.enclave_matmuls == 0
    assert cached.telemetry.fold_matmuls == 0
    assert live.telemetry.enclave_matmuls == 1
    assert cached.telemetry.device_matmuls == cached.telemetry.calls == 1


def test_prefetch_take_and_eviction(conv_case):
    _, w, _ = conv_case
    cache = TPC.BlindedLayerCache.from_records(_records(_t(w), 16),
                                               TB.BlindingSpec())
    keys = [np.asarray(jax.random.PRNGKey(i)) for i in range(3)]
    for k in keys:
        cache.prefetch(k)
    assert not cache.prefetched(keys[0])          # evicted (MAX_PREFETCHED)
    assert cache.prefetched(keys[1]) and cache.prefetched(keys[2])
    before = cache.factor_matmuls
    cache.take(keys[2])
    assert cache.factor_matmuls == before and not cache.prefetched(keys[2])


def test_verified_open_bit_equal(conv_case):
    x, w, b = conv_case
    jctx = JS.SlalomContext(jax.random.PRNGKey(3),
                            integrity=JIG.IntegrityPolicy.full(1),
                            unblinded=True)
    tctx = TS.SlalomContext(np.asarray(jax.random.PRNGKey(3)),
                            integrity=TIG.IntegrityPolicy.full(1),
                            unblinded=True)
    jy = JS.blinded_conv2d(jctx, {"w": jnp.asarray(w), "b": jnp.asarray(b)},
                           jnp.asarray(x))
    ty = TS.blinded_conv2d(tctx, {"w": _t(w), "b": _t(b)}, _t(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
    assert tctx.telemetry.enclave_matmuls == 0
    assert _log(tctx.integrity_log) == [(True, False, False)]


def test_fold_check_rejects_one_changed_element(rng):
    t, d_in, d_out = 64, 45, 8
    x = rng.integers(0, P, (t, d_in), dtype=np.int64)
    w = rng.integers(0, P, (d_in, d_out), dtype=np.int64)
    y = (x @ w) % P
    key = np.asarray(jax.random.PRNGKey(1))
    s = TIG.fold_stream(key, 0, 0, d_out, 2)
    ws = _t((w @ s.numpy().astype(np.int64)) % P).to(torch.int32)
    xt, yt = _t(x).to(torch.int32), _t(y).to(torch.int32)
    assert bool(TIG.fold_check(yt, xt, s, ws))
    bad = yt.clone()
    bad[17, 3] = (bad[17, 3] + 1) % P
    assert not bool(TIG.fold_check(bad, xt, s, ws))
    checked, failed = TIG.checked_pair(bad, xt, s, ws, will_check=True)
    assert bool(checked) and bool(failed)
    checked, failed = TIG.checked_pair(bad, xt, s, ws, will_check=False)
    assert not bool(checked) and not bool(failed)
    js = np.asarray(JIG.fold_stream(jax.random.PRNGKey(1), 0, 0, d_out, 2))
    np.testing.assert_array_equal(s.numpy(), js)


@pytest.mark.parametrize("trusted", [False, True])
def test_reciprocal_scaling_at_quantization_ties(trusted):
    """Activations whose x * (1/absmax) and x / absmax round to different
    quantization steps: both packages scale by the reciprocal."""
    x = np.float32(2.7) * np.ones((2, 16), np.float32)
    x.reshape(-1)[1:9] = [-2.6419923305511475, -2.6103515625,
                          -2.5365235805511475, -2.5048828125,
                          -2.4310548305511475, 0.1, -0.7, 1.3]
    w = (np.random.default_rng(2).normal(size=(16, 4)) / 4).astype(np.float32)
    key = jax.random.PRNGKey(8)
    jctx = JS.SlalomContext(key, trusted=trusted)
    tctx = TS.SlalomContext(np.asarray(key), trusted=trusted)
    jy = JS.blinded_dense(jctx, {"w": jnp.asarray(w)}, jnp.asarray(x))
    ty = TS.blinded_dense(tctx, {"w": _t(w)}, _t(x))
    np.testing.assert_array_equal(ty.numpy(), np.asarray(jy))
