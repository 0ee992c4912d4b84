"""The port's multi-device offload plane (parallel/offload_sharding.py,
runtime/devices.py, runtime/straggler.py, the plan's ShardPolicy) on the
VGG-16 smoke config, on the CPU, with simulated slots.

Held bit-for-bit: the plane's result against the pool-less executor, and
the tier-1 boundary and every ShardReport counter against the JAX plane
run with hedging off on the same inputs (hedging races real wall clocks,
so its decisions are checked on the port alone).
"""
import dataclasses
import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core import plan as JPL  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.parallel import offload_sharding as JOS  # noqa: E402
from repro.runtime import devices as JD  # noqa: E402
from repro.runtime import faults as JF  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import blinding as TB  # noqa: E402
from repro_torch.core import integrity as TIG  # noqa: E402
from repro_torch.core import plan as PL  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.kernels.limb_matmul.ops import field_matmul  # noqa: E402
from repro_torch.kernels.limb_matmul.ref import P  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.parallel.offload_sharding import (  # noqa: E402
    LivenessConfig, OffloadPlane, additive_shares, row_spans)
from repro_torch.runtime.devices import (BREAKER_CLOSED,  # noqa: E402
                                         BREAKER_OPEN, DeviceHealthConfig,
                                         DevicePool)
from repro_torch.runtime.faults import (DishonestDevice,  # noqa: E402
                                        FaultSpec, LivenessSpec,
                                        UnresponsiveDevice)
from repro_torch.runtime.straggler import (StepWatchdog,  # noqa: E402
                                           WatchdogConfig)

KEY = prng.PRNGKey(7)


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
    cfg = get_smoke("vgg16")
    npp = _np_params(cfg, seed=21)
    x = (np.random.default_rng(5).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)) * 0.5).astype(np.float32)
    return cfg, npp, {"images": x}


def _ex(vgg, pool=None, **kw):
    cfg, npp, _ = vgg
    kw.setdefault("mode", "origami")
    kw.setdefault("precompute", True)
    return OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"),
                           devices=pool, device="cpu", **kw)


@pytest.fixture(scope="module")
def ref_logits(vgg):
    return _ex(vgg).infer(vgg[2], session_key=KEY).logits.numpy()


def _bad_pool(n=2, **health):
    bad = DishonestDevice(FaultSpec("bit_flip"))
    return DevicePool(n, faults={n - 1: bad},
                      health=DeviceHealthConfig(**health) if health else None)


# ---------------------------------------------------------------------------
# against the JAX plane (hedging off)
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("faulty", [False, True])
@pytest.mark.parametrize("shard", ["rows", "shares"])
@pytest.mark.parametrize("impl", ["fused", "unfused"])
def test_plane_matches_reference_plane(vgg, impl, shard, faulty):
    cfg, npp, batch = vgg
    jfaults = {1: JF.DishonestDevice(JF.FaultSpec("bit_flip"))}
    jpool = JD.DevicePool(2, faults=jfaults if faulty else None)
    tpool = _bad_pool() if faulty else DevicePool(2)
    jex = JEx(jget_smoke("vgg16"), jax.tree.map(jnp.asarray, npp),
              mode="origami", impl=impl, precompute=True,
              integrity=JIG.IntegrityPolicy.full(2), devices=jpool,
              shard=shard, hedging=False)
    tex = _ex(vgg, tpool, impl=impl, integrity=TIG.IntegrityPolicy.full(2),
              shard=shard, hedging=False)
    try:
        for it in range(3):
            key = prng.fold_in(KEY, it)
            je = jex.infer({"images": jnp.asarray(batch["images"])},
                           session_key=jnp.asarray(key))
            tr = tex.infer(batch, session_key=key)
            np.testing.assert_array_equal(tr.boundary.numpy(),
                                          np.asarray(je.boundary))
            want = np.asarray(je.logits)
            np.testing.assert_allclose(tr.logits.numpy(), want, rtol=1e-5,
                                       atol=1e-5 * np.abs(want).max())
            assert dataclasses.asdict(tr.sharding) == dataclasses.asdict(
                je.sharding)
            assert tr.integrity.ok and tr.integrity.n_checked == 2
            assert [s.quarantined for s in tpool.slots] == [
                s.quarantined for s in jpool.slots]
        assert tex.cache.shards == 2
    finally:
        jpool.close()
        tpool.close()


# ---------------------------------------------------------------------------
# bit-exactness against the pool-less executor
# ---------------------------------------------------------------------------

@pytest.mark.parametrize("shard", ["rows", "shares"])
def test_two_device_bit_exact(vgg, ref_logits, shard):
    pool = DevicePool(2)
    ex = _ex(vgg, pool, shard=shard)
    r = ex.infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r.logits.numpy(), ref_logits)
    n_ops = r.sharding.ops
    assert n_ops == 2
    assert r.sharding.dispatches == r.sharding.checks == 2 * n_ops
    assert r.sharding.failures == 0
    assert ex.cache is not None and ex.cache.shards == 2
    pool.close()


def test_live_factor_path_bit_exact(vgg, ref_logits):
    pool = DevicePool(2)
    r = _ex(vgg, pool, precompute=False).infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r.logits.numpy(), ref_logits)
    pool.close()


def test_unfused_pool_bit_exact(vgg):
    want = _ex(vgg, impl="unfused").infer(vgg[2], session_key=KEY)
    pool = DevicePool(2)
    got = _ex(vgg, pool, impl="unfused").infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(got.logits.numpy(), want.logits.numpy())
    pool.close()


def test_more_devices_than_rows_bit_exact(vgg):
    """The fc ops have t = batch (2) < 4 shards: empty shards are skipped."""
    want = _ex(vgg, mode="slalom").infer(vgg[2], session_key=KEY)
    pool = DevicePool(4)
    got = _ex(vgg, pool, mode="slalom").infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(got.logits.numpy(), want.logits.numpy())
    pool.close()


# ---------------------------------------------------------------------------
# shard-local detection, single-shard retry, per-device health
# ---------------------------------------------------------------------------

def test_dishonest_device_shard_local_recovery(vgg, ref_logits):
    pool = _bad_pool(quarantine_after=100)
    r = _ex(vgg, pool).infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r.logits.numpy(), ref_logits)
    sh = r.sharding
    assert sh.failures == sh.ops == sh.retries
    assert sh.enclave_shards == 0
    assert sh.dispatches == 2 * sh.ops + sh.retries
    assert r.integrity.ok and sh.flagged
    assert pool.slots[1].verify_failures == sh.failures
    assert pool.slots[0].verify_failures == 0
    pool.close()


def test_shares_mode_never_moves_a_share(vgg, ref_logits):
    pool = _bad_pool(quarantine_after=100)
    r = _ex(vgg, pool, shard="shares").infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r.logits.numpy(), ref_logits)
    sh = r.sharding
    assert sh.failures == sh.ops and sh.retries == 0
    assert sh.enclave_shards == sh.failures
    assert pool.slots[0].dispatches == sh.ops
    pool.close()


def test_per_device_quarantine_keeps_healthy_serving(vgg):
    pool = _bad_pool(quarantine_after=2, probation_after=10 ** 6)
    ex = _ex(vgg, pool)
    ex.infer(vgg[2], session_key=KEY)
    assert pool.slots[1].quarantined and not pool.slots[0].quarantined
    before = pool.slots[1].dispatches
    key = prng.fold_in(KEY, 1)
    r = ex.infer(vgg[2], session_key=key)
    want = _ex(vgg).infer(vgg[2], session_key=key).logits.numpy()
    np.testing.assert_array_equal(r.logits.numpy(), want)
    assert r.sharding.failures == 0 and r.sharding.enclave_shards == 0
    assert pool.slots[1].dispatches == before
    pool.close()


def test_probation_restores_healed_device(vgg):
    pool = _bad_pool(quarantine_after=1, probation_after=1)
    ex = _ex(vgg, pool)
    ex.infer(vgg[2], session_key=KEY)
    assert pool.slots[1].quarantined
    pool.slots[1].fault = None                    # the fault heals
    r = ex.infer(vgg[2], session_key=prng.fold_in(KEY, 2))
    assert r.sharding.probes >= 1
    assert pool.slots[1].restores == 1 and not pool.slots[1].quarantined
    assert pool.n_healthy() == 2
    pool.close()


def test_all_devices_quarantined_enclave_fallback(vgg, ref_logits):
    pool = _bad_pool(1, quarantine_after=1, probation_after=10 ** 6)
    ex = _ex(vgg, pool)
    r = ex.infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r.logits.numpy(), ref_logits)
    assert r.sharding.enclave_shards >= 1
    r2 = ex.infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r2.logits.numpy(), ref_logits)
    assert r2.sharding.dispatches == 0
    pool.close()


def test_inert_pool_on_an_offload_free_plan(vgg):
    pool = DevicePool(2)
    ex = _ex(vgg, pool, mode="enclave")
    assert not ex._plane_live
    r = ex.infer(vgg[2], session_key=KEY)
    assert r.sharding is None and pool.dispatches == 0
    pool.close()


def test_serving_counts_shard_recovery(vgg):
    """A pool behind the sealed-batch primitive: shard failures flag the
    batch but never trigger the batch-level retry."""
    from repro_torch.runtime.serving import (PrivateInferenceServer, Request,
                                             execute_sealed_batch)
    cfg = vgg[0]
    ex = _ex(vgg, _bad_pool(quarantine_after=100),
             integrity=TIG.IntegrityPolicy.full(1))
    rng = np.random.default_rng(2)
    reqs = []
    for rid in range(2):
        img = vgg[2]["images"][rid]
        key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
        reqs.append(Request(rid, PrivateInferenceServer.client_seal(
            key, img, rid), img.shape, key))
    _, n_valid, _, integ = execute_sealed_batch(ex, reqs, max_batch=2,
                                                session_key=KEY)
    assert n_valid == 2 and integ.flagged
    assert integ.shard_failures == integ.shard_retries == 2
    assert integ.shard_checks == 6 and integ.failures == 0
    assert not integ.retried and not integ.recomputed
    ex.plane.pool.close()


# ---------------------------------------------------------------------------
# hedging and the liveness ladder (plane level, small operands)
# ---------------------------------------------------------------------------

def _operands(t=32, d_in=16, d_out=16):
    x = TB.blinding_stream(prng.fold_in(KEY, 1), (t, d_in))
    w = TB.blinding_stream(prng.fold_in(KEY, 2), (d_in, d_out))
    return x, w, field_matmul(x, w)


def test_straggler_hedging_duplicates_and_wins():
    x, w, want = _operands()
    pool = DevicePool(4, sim_delay_s={3: 0.30})
    plane = OffloadPlane(pool, mode="rows", hedging=True)
    for i in range(3):                        # warm the watchdog window
        plane.matmul(x, w, session_key=prng.fold_in(KEY, 10 + i), op_index=0)
    got = plane.matmul(x, w, session_key=prng.fold_in(KEY, 99), op_index=0)
    assert torch.equal(got, want)
    assert plane.totals.hedges >= 1 and plane.totals.failures == 0
    pool.close()


def test_hedging_off_never_duplicates():
    x, w, _ = _operands()
    pool = DevicePool(2, sim_delay_s={1: 0.15})
    plane = OffloadPlane(pool, mode="rows", hedging=False)
    for i in range(4):
        plane.matmul(x, w, session_key=prng.fold_in(KEY, 20 + i), op_index=0)
    assert plane.totals.hedges == 0
    assert plane.totals.dispatches == plane.totals.checks
    pool.close()


def test_plane_contains_crashes_and_breaker_cycles():
    x, w, want = _operands()
    pool = DevicePool(2, health=DeviceHealthConfig(breaker_after=2,
                                                   breaker_cooldown=2))
    plane = OffloadPlane(pool, mode="rows", hedging=False,
                         liveness=LivenessConfig(timeout_floor_s=0.1,
                                                 cold_timeout_s=1.0))
    slot = pool.slots[0]
    slot.liveness = UnresponsiveDevice(LivenessSpec("crash"))
    for op in range(4):
        assert torch.equal(plane.matmul(x, w, session_key=prng.PRNGKey(op),
                                        op_index=op), want)
    assert plane.totals.crashes >= 2 and plane.totals.backoffs >= 1
    assert slot.breaker == BREAKER_OPEN and pool.n_available() == 1
    slot.liveness = None                       # the fault clears
    for op in range(4, 12):
        assert torch.equal(plane.matmul(x, w, session_key=prng.PRNGKey(op),
                                        op_index=op), want)
        if slot.breaker == BREAKER_CLOSED:
            break
    assert slot.breaker == BREAKER_CLOSED and slot.breaker_closes == 1
    assert plane.totals.breaker_probes >= 1 and pool.n_available() == 2
    pool.close()


def test_plane_times_out_hung_device_and_abandons_queue():
    x, w, want = _operands()
    pool = DevicePool(2, health=DeviceHealthConfig(breaker_after=1))
    plane = OffloadPlane(pool, mode="rows", hedging=False,
                         liveness=LivenessConfig(timeout_floor_s=0.1,
                                                 cold_timeout_s=0.5))
    slot = pool.slots[1]
    slot.liveness = UnresponsiveDevice(LivenessSpec("hang"))
    assert torch.equal(plane.matmul(x, w, session_key=KEY, op_index=0), want)
    assert plane.totals.timeouts >= 1 and slot.abandons >= 1
    assert slot.breaker == BREAKER_OPEN
    slot.liveness = None
    pool.close()


def test_single_crashing_device_falls_back_to_enclave():
    x, w, want = _operands()
    pool = DevicePool(1)
    plane = OffloadPlane(pool, mode="rows", hedging=False,
                         liveness=LivenessConfig(backoff_max_s=0.02))
    pool.slots[0].liveness = UnresponsiveDevice(LivenessSpec("crash"))
    assert torch.equal(plane.matmul(x, w, session_key=KEY, op_index=0), want)
    assert plane.totals.enclave_shards >= 1 and plane.totals.crashes >= 1
    pool.close()


def test_brownout_inflates_latency_without_indictment():
    x, w, _ = _operands()
    pool = DevicePool(2)
    plane = OffloadPlane(pool, mode="rows", hedging=False,
                         liveness=LivenessConfig(timeout_floor_s=1.0))
    pool.slots[0].liveness = UnresponsiveDevice(
        LivenessSpec("brownout", delay_s=0.05))
    for op in range(3):
        plane.matmul(x, w, session_key=prng.PRNGKey(op), op_index=op)
    assert plane.totals.crashes == 0 and plane.totals.timeouts == 0
    assert pool.slots[0].breaker == BREAKER_CLOSED
    assert pool.slots[0].ewma_latency_s >= 0.04
    pool.close()


# ---------------------------------------------------------------------------
# pool health state machine, shard geometry, watchdog, plan IR
# ---------------------------------------------------------------------------

def test_row_spans_match_reference():
    for t in (1, 2, 5, 17, 64):
        for n in (1, 2, 3, 4, 8):
            assert row_spans(t, n) == JOS.row_spans(t, n)


@pytest.mark.parametrize("n", [2, 3, 4])
def test_additive_shares_match_reference_and_reconstruct(n):
    x = TB.blinding_stream(prng.fold_in(KEY, 9), (6, 8))
    shares = additive_shares(x, KEY, op_index=1, step=0, n=n)
    want = JOS.additive_shares(jnp.asarray(x.numpy()), jnp.asarray(KEY),
                               op_index=1, step=0, n=n)
    for a, b in zip(shares, want):
        np.testing.assert_array_equal(a.numpy(), np.asarray(b))
    acc = shares[0]
    for s in shares[1:]:
        acc = torch.remainder(acc + s, P)
    assert torch.equal(acc, x)
    assert all(not torch.equal(s, x) for s in shares)


def test_shard_fold_stream_matches_reference():
    for shard in range(3):
        got = TIG.shard_fold_stream(KEY, 2, 0, shard, 8, 2)
        want = JIG.shard_fold_stream(jnp.asarray(KEY), 2, 0, shard, 8, 2)
        np.testing.assert_array_equal(got.numpy(), np.asarray(want))


def test_healthy_prefers_fast_ewma_and_unmeasured_first():
    pool = DevicePool(3)
    pool.record_success(pool.slots[0], 0.5)
    pool.record_success(pool.slots[2], 0.1)
    assert [s.index for s in pool.healthy()] == [1, 2, 0]
    assert [s.index for s in pool.healthy(group=(0, 2))] == [2, 0]
    pool.close()


def test_quarantine_probation_cycle():
    pool = DevicePool(2, health=DeviceHealthConfig(quarantine_after=2,
                                                   probation_after=2))
    bad, good = pool.slots[1], pool.slots[0]
    pool.record_failure(bad)
    pool.record_success(good, 0.1)
    assert not bad.quarantined
    pool.record_failure(bad)
    assert bad.quarantined and bad.quarantines == 1
    assert [s.index for s in pool.healthy()] == [0]
    pool.begin_dispatch()
    assert pool.probe_candidate() is None
    pool.begin_dispatch()
    assert pool.probe_candidate() is bad
    pool.record_probe(bad)
    pool.record_failure(bad)                      # dirty probe: re-benched
    assert bad.quarantined and not bad.probation
    pool.begin_dispatch()
    pool.begin_dispatch()
    pool.record_probe(bad)
    pool.record_success(bad, 0.2)                 # clean probe: restored
    assert not bad.quarantined and bad.restores == 1 and bad.probes == 2
    pool.record_latency(good, 0.25)
    assert good.ewma_latency_s == pytest.approx(0.75 * 0.1 + 0.25 * 0.25)
    snap = pool.snapshot()
    assert snap["size"] == 2 and snap["slots"][0]["name"] == "sim:0"
    pool.close()


def test_from_torch_needs_a_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="CUDA"):
        DevicePool.from_torch()


def test_watchdog_deadline_uses_median():
    wd = StepWatchdog(WatchdogConfig(deadline_factor=2.0, warmup_steps=4))
    assert wd.deadline(cold=1.5) == 1.5
    for dt in (0.1, 0.2, 0.3, 0.4):
        wd.start_step(now=0.0)
        assert not wd.end_step(now=dt)
    assert wd.p50 == pytest.approx(0.25)
    assert wd.deadline() == pytest.approx(0.5)
    assert wd.deadline(factor=8.0, floor=3.0) == 3.0
    wd.start_step(now=0.0)
    assert wd.end_step(now=0.6) and wd.flagged_steps == 1


def test_shard_policy_digest_and_segments_match_reference(vgg):
    cfg = vgg[0]
    jcfg = jget_smoke("vgg16")
    p = cfg.origami.tier1_layers
    n = PL.num_blocks(cfg)
    places = ["blinded"] * p + ["open"] * (n - p)
    for shard in ({0: ("shares", None)},
                  {i: ("rows", (0,)) for i in range(p)},
                  {1: ("rows", (1, 0)), 0: ("shares", None)}):
        tp = PL.make_plan(cfg, places, boundary=p, shard={
            i: PL.ShardPolicy(*v) for i, v in shard.items()})
        jp = JPL.make_plan(jcfg, places, boundary=p, shard={
            i: JPL.ShardPolicy(*v) for i, v in shard.items()})
        assert tp.digest == jp.digest
        assert [(s.lo, s.hi, s.regime) for s in tp.segments] == [
            (s.lo, s.hi, s.regime) for s in jp.segments]
    plain = PL.make_plan(cfg, places, boundary=p)
    assert plain.digest == PL.compile_mode(cfg, "origami").digest
    sharded = PL.make_plan(cfg, places, boundary=p,
                           shard={0: PL.ShardPolicy("shares")})
    assert sharded.digest != plain.digest
    segs = [s for s in sharded.segments if s.regime == "blinded"]
    assert len(segs) == 2 and segs[0].shard == PL.ShardPolicy("shares")
    assert segs[1].shard is None


def test_shard_policy_device_group_restriction(vgg, ref_logits):
    cfg = vgg[0]
    p = cfg.origami.tier1_layers
    n = PL.num_blocks(cfg)
    plan = PL.make_plan(
        cfg, ["blinded"] * p + ["open"] * (n - p), boundary=p,
        shard={i: PL.ShardPolicy("rows", devices=(0,)) for i in range(p)})
    pool = DevicePool(2)
    r = _ex(vgg, pool, plan=plan).infer(vgg[2], session_key=KEY)
    np.testing.assert_array_equal(r.logits.numpy(), ref_logits)
    assert pool.slots[0].dispatches > 0 and pool.slots[1].dispatches == 0
    pool.close()


def test_pool_close_releases_a_parked_worker():
    pool = DevicePool(1)
    slot = pool.slots[0]
    parked = threading.Event()

    def park(_slot):
        parked.set()
        _slot.cancel.wait()
        return "released"

    fut = slot.submit(park)
    assert parked.wait(timeout=10)
    pool.close()
    assert fut.result(timeout=10) == "released"
