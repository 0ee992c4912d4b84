"""Freivalds verification under a dishonest device, on both data paths of
the port, and the serving recovery ladder — against the JAX reference on
the VGG-16 smoke config, on the CPU.

The tier-1 boundary and the IntegrityReport are held bit-for-bit against
the reference's eager run (``infer(jit=False)``); the logits go through
float tier-2, whose summation order differs between torch and XLA, and are
held to rtol 1e-5 and atol 1e-5 * max|ref| (a stale replay blows the
boundary up, so the logits' scale varies by orders of magnitude between
fault kinds).
"""
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
from repro.runtime import faults as JF  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime.faults import (KINDS, DishonestDevice,  # noqa: E402
                                        FaultSpec)
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request, execute_sealed_batch)

KEY = prng.PRNGKey(7)


def _np_params(cfg, seed):
    """Scaled-normal weights and random biases."""
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
    cfg = get_smoke("vgg16")
    npp = _np_params(cfg, seed=16)
    x = (np.random.default_rng(3).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)) * 0.5).astype(np.float32)
    return cfg, npp, x


def _ex(vgg, **kw):
    cfg, npp, _ = vgg
    kw.setdefault("precompute", True)
    return OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"),
                           mode="origami", device="cpu", **kw)


@pytest.fixture(scope="module")
def honest_logits(vgg):
    return _ex(vgg).infer({"images": vgg[2]}, session_key=KEY).logits.numpy()


def _report(rep):
    return tuple(np.asarray(getattr(rep, f)).tolist()
                 for f in ("checked", "failed", "corrupted"))


@pytest.mark.parametrize("kind", KINDS)
@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_fault_kind_matches_reference_and_is_detected(vgg, impl, kind):
    """Full verification flags exactly the corrupted ops, on both data
    paths, bit-equal to the reference's run; the adaptive adversary finds
    no unverified op to corrupt."""
    cfg, npp, x = vgg
    jex = JEx(jget_smoke("vgg16"), jax.tree.map(jnp.asarray, npp),
              mode="origami", impl=impl, precompute=True,
              integrity=JIG.IntegrityPolicy.full(2),
              fault=JF.DishonestDevice(JF.FaultSpec(kind)))
    je = jex.infer({"images": jnp.asarray(x)}, session_key=jnp.asarray(KEY),
                   jit=False)
    tr = _ex(vgg, impl=impl, integrity=IntegrityPolicy.full(2),
             fault=DishonestDevice(FaultSpec(kind))).infer(
        {"images": x}, session_key=KEY)
    np.testing.assert_array_equal(tr.boundary.numpy(), np.asarray(je.boundary))
    assert _report(tr.integrity) == _report(je.integrity)
    want = np.asarray(je.logits)
    np.testing.assert_allclose(tr.logits.numpy(), want, rtol=1e-5,
                               atol=1e-5 * np.abs(want).max())
    rep = tr.integrity
    assert rep.n_ops == 2 and rep.n_checked == 2
    np.testing.assert_array_equal(rep.failed.numpy(), rep.corrupted.numpy())
    if kind == "adaptive":
        assert rep.n_corrupted == 0 and rep.ok
    else:
        assert rep.n_corrupted == 2 and rep.n_failed == 2


@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_injector_with_policy_off_logs_ground_truth_only(vgg, impl):
    """An injector under the "off" policy still logs one entry per op:
    corrupted, never checked — the reference's report exactly."""
    cfg, npp, x = vgg
    jex = JEx(jget_smoke("vgg16"), jax.tree.map(jnp.asarray, npp),
              mode="origami", impl=impl, precompute=True,
              fault=JF.DishonestDevice(JF.FaultSpec("adaptive")))
    je = jex.infer({"images": jnp.asarray(x)}, session_key=jnp.asarray(KEY),
                   jit=False)
    tr = _ex(vgg, impl=impl, fault=DishonestDevice(
        FaultSpec("adaptive"))).infer({"images": x}, session_key=KEY)
    np.testing.assert_array_equal(tr.boundary.numpy(), np.asarray(je.boundary))
    assert _report(tr.integrity) == _report(je.integrity)
    assert tr.integrity.n_corrupted == 2 and tr.integrity.n_checked == 0


def test_unfused_honest_matches_reference_and_trusted(vgg):
    """The honest unfused path: boundary bit-equal to the reference; the
    enclave recompute (which divides, like the unfused blind) is bit-equal
    to the blinded run."""
    cfg, npp, x = vgg
    jex = JEx(jget_smoke("vgg16"), jax.tree.map(jnp.asarray, npp),
              mode="origami", impl="unfused",
              integrity=JIG.IntegrityPolicy.full(1))
    je = jex.infer({"images": jnp.asarray(x)}, session_key=jnp.asarray(KEY),
                   jit=False)
    ex = _ex(vgg, impl="unfused", precompute=False,
             integrity=IntegrityPolicy.full(1))
    tr = ex.infer({"images": x}, session_key=KEY)
    np.testing.assert_array_equal(tr.boundary.numpy(), np.asarray(je.boundary))
    assert _report(tr.integrity) == _report(je.integrity)
    assert tr.integrity.ok and tr.integrity.n_checked == 2
    trusted = ex.infer({"images": x}, trusted=True)
    np.testing.assert_array_equal(trusted.boundary.numpy(),
                                  tr.boundary.numpy())
    np.testing.assert_array_equal(trusted.logits.numpy(), tr.logits.numpy())


@pytest.mark.parametrize("policy", [IntegrityPolicy.full(1),
                                    IntegrityPolicy.full(2),
                                    IntegrityPolicy.sampled(0.5, 1)])
def test_honest_device_never_flagged_across_seeds(vgg, honest_logits,
                                                  policy):
    ex = _ex(vgg, integrity=policy)
    for seed in range(6):
        r = ex.infer({"images": vgg[2]}, session_key=prng.PRNGKey(40 + seed))
        assert r.integrity.n_failed == 0 and r.integrity.n_corrupted == 0
    r7 = ex.infer({"images": vgg[2]}, session_key=KEY)
    np.testing.assert_array_equal(r7.logits.numpy(), honest_logits)


def test_sampled_detection_rate_at_least_expected(vgg):
    rate = 0.5
    ex = _ex(vgg, integrity=IntegrityPolicy.sampled(rate),
             fault=DishonestDevice(FaultSpec("bit_flip")))
    checked = corrupted = detected = 0
    for seed in range(12):              # 24 ops
        rep = ex.infer({"images": vgg[2]},
                       session_key=prng.PRNGKey(60 + seed)).integrity
        checked += rep.n_checked
        corrupted += rep.n_corrupted
        detected += rep.n_failed
    assert corrupted == 24
    assert 0 < checked < 24
    assert detected == checked
    assert detected / corrupted >= rate - 0.25


def test_adaptive_adversary_evades_sampling_but_not_full(vgg):
    ex = _ex(vgg, integrity=IntegrityPolicy.sampled(0.5),
             fault=DishonestDevice(FaultSpec("adaptive")))
    corrupted = detected = 0
    for seed in range(8):
        rep = ex.infer({"images": vgg[2]},
                       session_key=prng.PRNGKey(80 + seed)).integrity
        corrupted += rep.n_corrupted
        detected += rep.n_failed
    assert corrupted > 0 and detected == 0
    full = _ex(vgg, integrity=IntegrityPolicy.full(1),
               fault=DishonestDevice(FaultSpec("adaptive")))
    for seed in range(4):
        rep = full.infer({"images": vgg[2]},
                         session_key=prng.PRNGKey(80 + seed)).integrity
        assert rep.n_corrupted == 0 and rep.ok


def _request(cfg, rid, rng):
    img = (rng.normal(size=(cfg.image_size, cfg.image_size, 3)) * 0.5
           ).astype(np.float32)
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, img, rid)
    return Request(rid=rid, box=box, shape=img.shape, session_key=key), key


def _open(cfg, key, box):
    return PrivateInferenceServer.client_open(key, box, (cfg.num_classes,))


@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_serve_batch_recovers_bit_exact(vgg, impl):
    """A persistent stale replay: the check fails, the device retry fails,
    the enclave recomputes; the client opens logits bit-equal to an
    honest server's."""
    cfg, npp, _ = vgg
    params = V.params_from_numpy(npp, "cpu")
    honest = PrivateInferenceServer(cfg, params, max_batch=4, impl=impl,
                                    device="cpu")
    faulty = PrivateInferenceServer(
        cfg, params, max_batch=4, impl=impl, device="cpu",
        integrity=IntegrityPolicy.full(2),
        fault=DishonestDevice(FaultSpec("stale")))
    rng = np.random.default_rng(9)
    reqs, keys = zip(*[_request(cfg, i, rng) for i in range(4)])
    want = honest.serve_batch(list(reqs))
    got = faulty.serve_batch(list(reqs))
    tot = faulty.integrity_totals
    assert tot.failures == tot.corrupted == 4 and tot.checks == 4
    assert tot.retries == 1 and tot.recomputes == 1
    assert honest.integrity_totals.failures == 0
    for w, g, k in zip(want, got, keys):
        assert g.ok and g.flagged and not w.flagged
        np.testing.assert_array_equal(_open(cfg, k, g.box),
                                      _open(cfg, k, w.box))


def test_transient_fault_clears_on_device_retry(vgg):
    """A fault gated per session (prob < 1) clears on the fresh-session
    retry drawn from a callable: no enclave recompute, bit-exact."""
    cfg, npp, _ = vgg
    ex = _ex(vgg, integrity=IntegrityPolicy.full(1),
             fault=DishonestDevice(FaultSpec("bit_flip", prob=0.4)))
    bad = good = None
    for seed in range(5000, 5040):
        k = prng.PRNGKey(seed)
        n = ex.infer({"images": vgg[2]}, session_key=k).integrity.n_corrupted
        if n > 0 and bad is None:
            bad = k
        if n == 0 and good is None:
            good = k
        if bad is not None and good is not None:
            break
    assert bad is not None and good is not None
    sessions = iter([bad, good])
    rng = np.random.default_rng(12)
    reqs, keys = zip(*[_request(cfg, i, rng) for i in range(2)])
    boxes, n_valid, _, integ = execute_sealed_batch(
        ex, list(reqs), max_batch=2, session_key=lambda: next(sessions))
    assert n_valid == 2
    assert integ.failures > 0 and integ.retried and not integ.recomputed
    honest = PrivateInferenceServer(cfg, V.params_from_numpy(npp, "cpu"),
                                    max_batch=2, device="cpu")
    want = honest.serve_batch(list(reqs))
    for w, box, k in zip(want, boxes, keys):
        np.testing.assert_array_equal(_open(cfg, k, box),
                                      _open(cfg, k, w.box))


def test_trusted_dispatch_skips_the_device(vgg):
    cfg, npp, _ = vgg
    ex = _ex(vgg, integrity=IntegrityPolicy.full(1),
             fault=DishonestDevice(FaultSpec("stale")))
    rng = np.random.default_rng(13)
    reqs, keys = zip(*[_request(cfg, i, rng) for i in range(2)])
    boxes, n_valid, _, integ = execute_sealed_batch(
        ex, list(reqs), max_batch=2, session_key=KEY, trusted=True)
    assert n_valid == 2 and integ.trusted and integ.checks == 0
    assert not integ.flagged
    no_retry = execute_sealed_batch(ex, list(reqs), max_batch=2,
                                    session_key=KEY, retry_device=False)[3]
    assert no_retry.failures > 0 and not no_retry.retried
    assert no_retry.recomputed
