"""The port's chaos harness (``runtime/chaos.py``) and the engine under it,
on the CPU: the schedule language against the reference's parser, the
controller's arming of each layer, and the engine degrading to
enclave-only serving, recovering and staying bit-exact, then closing with
every future resolved and no thread of its own left alive. The cases of
the reference's ``tests/test_chaos.py`` that test only the injectors or
the plane are in ``test_torch_faults.py`` and ``test_torch_offload.py``.
"""
import threading
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.core import sealing as jseal  # noqa: E402
from repro.runtime import chaos as JC  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.parallel.offload_sharding import LivenessConfig  # noqa: E402
from repro_torch.privacy.data import make_batch  # noqa: E402
from repro_torch.runtime.chaos import (ChaosController,  # noqa: E402
                                       ChaosSchedule, RefillChaos)
from repro_torch.runtime.devices import (BREAKER_CLOSED,  # noqa: E402
                                         DeviceHealthConfig, DevicePool)
from repro_torch.runtime.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)
from repro_torch.runtime.sessions import SessionPool  # noqa: E402

DRILL = "dev0.crash@1-2,dev1.hang@1-2,refill@7-8,seal@10"


@pytest.fixture(scope="module")
def vgg():
    cfg = get_smoke("vgg16")
    return cfg, V.init_params(cfg, 0, device="cpu")


def _request(cfg, rid, rng):
    img = make_batch(rid, 1, cfg.image_size)[0]
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, img, rid)
    return Request(rid=rid, box=box, shape=img.shape, session_key=key), key


# -- the schedule language ----------------------------------------------------

@pytest.mark.parametrize("text", [
    DRILL, "dev0.crash@1", "refill@0-3, seal@2", "dev3.flaky@5-9",
    "dev1.brownout@0,dev0.hang@0-1,seal@4,refill@4"])
def test_schedule_parse_equals_reference(text):
    got, want = ChaosSchedule.parse(text), JC.ChaosSchedule.parse(text)
    assert str(got) == str(want)
    assert got.horizon == want.horizon
    assert ([tuple(vars(e).values()) for e in got.events]
            == [tuple(vars(e).values()) for e in want.events])


def test_schedule_parse_round_trip():
    sched = ChaosSchedule.parse(DRILL)
    assert str(sched) == DRILL
    assert len(sched.events) == 4
    assert sched.horizon == 11
    dev0 = sched.events[0]
    assert (dev0.layer, dev0.device, dev0.kind) == ("device", 0, "crash")
    assert dev0.active(1) and dev0.active(2)
    assert not dev0.active(0) and not dev0.active(3)
    seal = sched.events[3]
    assert seal.start == seal.stop == 10


@pytest.mark.parametrize("bad", [
    "dev0.fliparoo@1", "crash@1", "dev0.crash", "refill@", "dev0.crash@2-",
    "", " , ", "devx.hang@1"])
def test_schedule_rejects_garbage_like_reference(bad):
    with pytest.raises(ValueError):
        JC.ChaosSchedule.parse(bad)
    with pytest.raises(ValueError):
        ChaosSchedule.parse(bad)


def test_schedule_rejects_inverted_window():
    with pytest.raises(AssertionError):
        JC.ChaosSchedule.parse("dev0.crash@5-2")
    with pytest.raises(AssertionError):
        ChaosSchedule.parse("dev0.crash@5-2")


# -- the controller -------------------------------------------------------------

def test_refill_chaos_contained_and_counted():
    pool = SessionPool(None, depth=2, background=False)
    chaos = ChaosController(ChaosSchedule.parse("refill@0-1"), sessions=pool)
    chaos.on_batch(0)
    assert pool.refill_fault is not None
    pool.prime()
    assert pool.stats()["refill_errors"] == 2
    assert chaos.refill_faults == 2
    chaos.on_batch(2)
    assert pool.refill_fault is None
    pool.acquire()
    pool.prime()
    assert pool.stats()["refill_errors"] == 2
    pool.close()


def test_refill_fault_hook_raises_refill_chaos():
    pool = SessionPool(None, depth=1, background=False)
    chaos = ChaosController(ChaosSchedule.parse("refill@0"), sessions=pool)
    chaos.on_batch(0)
    with pytest.raises(RefillChaos):
        pool.refill_fault(0)
    pool.close()


def test_controller_arms_and_disarms_device_injectors():
    pool = DevicePool(2)
    chaos = ChaosController(ChaosSchedule.parse("dev1.crash@2-3"), pool=pool)
    try:
        chaos.on_batch(0)
        assert pool.slots[1].liveness is None
        chaos.on_batch(2)
        inj = pool.slots[1].liveness
        assert inj is not None and inj.spec.kind == "crash"
        chaos.on_batch(3)
        assert pool.slots[1].liveness is inj
        chaos.on_batch(4)
        assert pool.slots[1].liveness is None
        assert [(b, a) for b, _, a in chaos.log] == [(2, "arm"),
                                                     (4, "disarm")]
    finally:
        pool.close()


def test_controller_seal_window_flips_macs_like_reference(vgg, rng):
    """The port's flip of the int MAC equals the reference's flip of its
    uint32 MAC on the same sealed box, and the enclave rejects it."""
    cfg, _ = vgg
    req, key = _request(cfg, 0, rng)
    jreq = JS.Request(0, jseal.SealedBox(
        jax.numpy.asarray(req.box.ciphertext.numpy().astype(np.uint32)),
        jax.numpy.asarray(req.box.nonce),
        jax.numpy.asarray(req.box.mac, jax.numpy.uint32)), req.shape, key)
    mac0 = req.box.mac
    chaos, jchaos = (ChaosController(ChaosSchedule.parse("seal@1")),
                     JC.ChaosController(JC.ChaosSchedule.parse("seal@1")))
    for c, r in ((chaos, req), (jchaos, jreq)):
        c.on_batch(0, requests=[r])
    assert req.box.mac == mac0
    for c, r in ((chaos, req), (jchaos, jreq)):
        c.on_batch(1, requests=[r])
    assert req.box.mac == mac0 ^ 1 == int(jreq.box.mac)
    assert chaos.seal_corruptions == jchaos.seal_corruptions == 1
    with pytest.raises(ValueError, match="MAC"):
        PrivateInferenceServer.client_open(key, req.box, req.shape)
    chaos.quiesce()
    assert not chaos.snapshot()["armed"]


# -- the engine under a schedule -------------------------------------------------

def test_engine_degrades_recovers_and_stays_bit_exact(vgg, rng):
    cfg, params = vgg
    per = 2
    schedule = ChaosSchedule.parse("dev0.crash@1,dev1.hang@1,seal@3")
    n_batches = schedule.horizon + 5
    reqs, keys = zip(*[_request(cfg, i, rng)
                       for i in range(per * n_batches)])
    key_by_rid = {r.rid: k for r, k in zip(reqs, keys)}
    # the healthy pool-less oracle first: chaos corrupts seal-window boxes
    # in flight, and the oracle must see the pristine requests
    oracle = PrivateInferenceServer(cfg, params, mode="origami",
                                    max_batch=per, device="cpu")
    want = {}
    for j in range(n_batches):
        for r in oracle.serve_batch(list(reqs[per * j:per * (j + 1)])):
            want[r.rid] = PrivateInferenceServer.client_open(
                key_by_rid[r.rid], r.box, (cfg.num_classes,))
    pool = DevicePool(2, health=DeviceHealthConfig(breaker_after=2,
                                                   breaker_cooldown=2))
    chaos = ChaosController(schedule)
    engine = ServingEngine(EngineConfig(max_batch=per, max_wait_ms=50.0))
    timeline = []
    try:
        engine.register_model("vgg16", cfg, params, mode="origami",
                              devices=pool, shard="rows",
                              liveness=LivenessConfig(cold_timeout_s=2.0),
                              chaos=chaos, device="cpu")
        for j in range(n_batches):
            futs = [engine.submit("vgg16", r)
                    for r in reqs[per * j:per * (j + 1)]]
            resps = [f.result(timeout=120) for f in futs]
            degraded = engine.snapshot()["models"]["vgg16"]["degraded"]
            timeline.append((j, resps, degraded))
    finally:
        snap = engine.snapshot()
        engine.close()

    assert chaos.batch == n_batches - 1
    for j, resps, _ in timeline:
        for resp in resps:
            if j == 3:
                assert not resp.ok and resp.error == "mac_failed", (j, resp)
            else:
                assert resp.ok and resp.error is None, (j, resp)
                np.testing.assert_array_equal(
                    PrivateInferenceServer.client_open(
                        key_by_rid[resp.rid], resp.box, (cfg.num_classes,)),
                    want[resp.rid])
    liv = snap["liveness"]
    assert liv["degradations"] >= 1 and liv["recoveries"] >= 1
    assert liv["shard_crashes"] >= 1 and liv["shard_timeouts"] >= 1
    assert not snap["models"]["vgg16"]["degraded"]
    assert any(d for _, _, d in timeline) and not timeline[-1][2]
    slots = snap["devices"]["vgg16"]["pool"]["slots"]
    assert all(s["available"] for s in slots)
    assert all(s["breaker"] == BREAKER_CLOSED for s in slots)
    assert all(s["breaker_opens"] >= 1 for s in slots)
    assert all(not s["quarantined"] for s in slots)


def test_engine_refill_window_counted(vgg, rng):
    """A refill window makes the pool's prefetches raise: the engine keeps
    serving (factors drawn on the request path) and counts them."""
    cfg, params = vgg
    chaos = ChaosController(ChaosSchedule.parse("refill@1-2"))
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=20.0))
    try:
        entry = engine.register_model("vgg16", cfg, params, chaos=chaos,
                                      device="cpu")
        for j in range(4):
            reqs = [_request(cfg, 10 * j + i, rng)[0] for i in range(2)]
            got = [f.result(timeout=120)
                   for f in [engine.submit("vgg16", r) for r in reqs]]
            assert all(r.ok for r in got)
            if j in (1, 2):
                deadline = time.monotonic() + 10
                while (chaos.refill_faults == 0
                       and time.monotonic() < deadline):
                    time.sleep(0.02)
        snap = engine.snapshot()
    finally:
        engine.close()
    assert chaos.refill_faults > 0
    assert snap["refill_errors"] == entry.pool.stats()["refill_errors"] > 0
    assert [a for _, _, a in chaos.log] == ["arm", "disarm"]


# -- draining shutdown ------------------------------------------------------------

_OWNED_PREFIXES = ("offload-dev", "session-pool-refill",
                   "serving-engine-batcher", "serving-engine-device")


def _owned_threads():
    return [t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(_OWNED_PREFIXES)]


def test_close_drains_in_flight_sharded_batches(vgg, rng):
    cfg, params = vgg
    before = {id(t) for t in _owned_threads()}
    pool = DevicePool(2)
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=20.0))
    engine.register_model("vgg16", cfg, params, mode="origami",
                          devices=pool, shard="rows", device="cpu")
    reqs = [_request(cfg, 100 + i, rng)[0] for i in range(6)]
    futures = [engine.submit("vgg16", r) for r in reqs]
    engine.close()                              # at once: work in flight
    for f in futures:
        assert f.done()
        resp = f.result(timeout=0)
        assert resp.ok or resp.error == "shutdown", resp
    assert any(f.result(timeout=0).ok for f in futures)
    snap = engine.snapshot()
    assert (snap["completed"] + snap["liveness"]["shutdown_drops"]
            >= len(reqs))
    deadline = time.monotonic() + 10
    while time.monotonic() < deadline:
        orphans = [t for t in _owned_threads() if id(t) not in before]
        if not orphans:
            break
        time.sleep(0.05)
    assert not orphans, f"threads alive after close: {orphans}"
    engine.close()                              # idempotent
    late = engine.submit("vgg16", _request(cfg, 999, rng)[0])
    resp = late.result(timeout=5)
    assert not resp.ok and resp.error == "shutdown"
