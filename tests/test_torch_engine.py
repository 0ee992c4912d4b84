"""The port's serving engine (``runtime/engine.py``) on the CPU: the cases
of the reference's ``tests/test_engine.py`` (the LM case is in
``test_torch_lm_serving.py``; the pure session-pool cases are in
``test_torch_sessions_pool.py``), its engine cases of ``test_aot.py``,
``test_observability.py`` and ``test_profiling.py``, and the engine against
the JAX engine.

The JAX-engine comparison is exact: both engines serve the same sealed
requests, in the same batches, with weights from the reference's
``init_params`` and session keys from pools of one root, under the
"slalom" plan, in which every linear op is field arithmetic (the
"origami" plan's float tier-2 sums in another order in torch than in XLA,
and the reference's jitted trace fuses a bias add into the dequantize,
which is exact only for the zero biases ``init_params`` gives). Response
ciphertexts, MACs and the snapshot counters are held equal.
"""
import json
import re
import threading
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import engine as JE  # noqa: E402
from repro.runtime import serving as JS  # noqa: E402
from repro.runtime import sessions as JSS  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import plan as PL  # noqa: E402
from repro_torch.core import tracing  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.core.tracing import Tracer  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.privacy.data import make_batch  # noqa: E402
from repro_torch.runtime.devices import (DeviceHealthConfig,  # noqa: E402
                                         DevicePool)
from repro_torch.runtime.engine import (EngineConfig, EngineStats,  # noqa: E402
                                        ServingEngine)
from repro_torch.runtime.faults import DishonestDevice, FaultSpec  # noqa: E402
from repro_torch.runtime import serving as TS  # noqa: E402
from repro_torch.runtime.profiling import PHASES, FlightRecorder  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)
from repro_torch.runtime.sessions import SessionPool  # noqa: E402

TIMEOUT = 120


@pytest.fixture(scope="module")
def zoo():
    cfg16, cfg19 = get_smoke("vgg16"), get_smoke("vgg19")
    return {"vgg16": (cfg16, V.init_params(cfg16, 0, device="cpu")),
            "vgg19": (cfg19, V.init_params(cfg19, 1, device="cpu"))}


def _request(cfg, rid, rng):
    img = make_batch(rid, 1, cfg.image_size)[0]
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, img, rid)
    return Request(rid=rid, box=box, shape=img.shape, session_key=key), key


def _engine(cfg=None, **kw):
    return ServingEngine(cfg or EngineConfig(**kw))


def _open(cfg, key, resp):
    return PrivateInferenceServer.client_open(key, resp.box,
                                              (cfg.num_classes,))


def test_engine_bit_identical_to_legacy_server(zoo, rng):
    cfg, params = zoo["vgg16"]
    reqs, keys = zip(*[_request(cfg, i, rng) for i in range(8)])
    legacy = PrivateInferenceServer(cfg, params, mode="origami", max_batch=4,
                                    device="cpu")
    want = []
    for i in range(0, 8, 4):
        want += legacy.serve_batch(list(reqs[i:i + 4]))
    engine = _engine(max_batch=4, max_wait_ms=500.0)
    try:
        engine.register_model("vgg16", cfg, params, device="cpu")
        got = [f.result(timeout=TIMEOUT)
               for f in [engine.submit("vgg16", r) for r in reqs]]
    finally:
        engine.close()
    assert all(r.ok for r in got)
    for w, g in zip(want, got):
        np.testing.assert_array_equal(_open(cfg, keys[w.rid], w),
                                      _open(cfg, keys[g.rid], g))


def test_out_of_order_completion_mixed_models(zoo, rng):
    """A later model's full bucket completes before an earlier partial
    bucket that waits for its max_wait timer."""
    engine = _engine(max_batch=4, max_wait_ms=2000.0)
    try:
        for name, (cfg, params) in zoo.items():
            engine.register_model(name, cfg, params, device="cpu")
        cfg16, cfg19 = zoo["vgg16"][0], zoo["vgg19"][0]
        warm16 = [_request(cfg16, 900 + i, rng)[0] for i in range(4)]
        warm19 = [_request(cfg19, 950 + i, rng)[0] for i in range(4)]
        reqs16 = [_request(cfg16, 10 + i, rng)[0] for i in range(2)]
        reqs19 = [_request(cfg19, 20 + i, rng)[0] for i in range(4)]
        [f.result(timeout=TIMEOUT)
         for f in ([engine.submit("vgg16", r) for r in warm16]
                   + [engine.submit("vgg19", r) for r in warm19])]
        mark = len(engine.completion_order)
        f16 = [engine.submit("vgg16", r) for r in reqs16]
        f19 = [engine.submit("vgg19", r) for r in reqs19]
        got = [f.result(timeout=TIMEOUT) for f in f16 + f19]
        assert all(r.ok for r in got)
        order = list(engine.completion_order)[mark:]
        assert [m for m, _ in order[:4]] == ["vgg19"] * 4, order
        assert {m for m, _ in order[4:]} == {"vgg16"}, order
    finally:
        engine.close()


def test_admission_control_rejects_over_capacity(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=4, max_wait_ms=50.0, max_queue=2)
    try:
        engine.register_model("vgg16", cfg, params, device="cpu")
        reqs = [_request(cfg, 50 + i, rng)[0] for i in range(6)]
        got = [f.result(timeout=TIMEOUT)
               for f in [engine.submit("vgg16", r) for r in reqs]]
        assert engine.stats.rejected >= 1
        rejected = [r for r in got if not r.ok]
        assert rejected and all(r.box is None and r.error == "rejected"
                                for r in rejected)
    finally:
        engine.close()


def test_unknown_model_rejected(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=2, max_wait_ms=10.0)
    try:
        engine.register_model("vgg16", cfg, params, device="cpu")
        resp = engine.submit("resnet50", _request(cfg, 60, rng)[0]).result(
            timeout=10)
        assert not resp.ok and engine.stats.rejected == 1
    finally:
        engine.close()


def test_expired_deadline_never_reaches_executor(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=4, max_wait_ms=80.0)
    try:
        entry = engine.register_model("vgg16", cfg, params, device="cpu")
        fut = engine.submit("vgg16", _request(cfg, 70, rng)[0],
                            deadline_s=1e-4)
        time.sleep(0.02)
        resp = fut.result(timeout=60)
        assert not resp.ok and resp.error == "deadline_exceeded"
        assert engine.stats.expired == 1
        assert engine.stats.batches == 0
        assert entry.pool.consumed == 0
    finally:
        engine.close()


# -- quarantine probation (models without a DevicePool) ----------------------

def test_probation_restores_clean_backend(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=2, max_wait_ms=20.0, probation_after=2)
    try:
        entry = engine.register_model("vgg16", cfg, params, device="cpu",
                                      integrity=IntegrityPolicy.full(1))
        entry.quarantined = True
        entry.trusted_streak = 2
        resp = engine.submit("vgg16", _request(cfg, 300, rng)[0]).result(
            timeout=TIMEOUT)
        assert resp.ok and not resp.flagged
        assert not entry.quarantined
        assert entry.probations == 1 and entry.restores == 1
        snap = engine.snapshot()
        assert snap["integrity"]["probations"] == 1
        assert snap["integrity"]["probation_restores"] == 1
        assert snap["models"]["vgg16"]["restores"] == 1
    finally:
        engine.close()


def test_probation_rebenches_dishonest_backend(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=2, max_wait_ms=20.0, probation_after=2)
    try:
        entry = engine.register_model(
            "vgg16", cfg, params, device="cpu",
            integrity=IntegrityPolicy.full(1),
            fault=DishonestDevice(FaultSpec("bit_flip")))
        entry.quarantined = True
        entry.trusted_streak = 2
        resp = engine.submit("vgg16", _request(cfg, 310, rng)[0]).result(
            timeout=TIMEOUT)
        assert resp.ok and resp.flagged
        assert entry.quarantined
        assert entry.probations == 1 and entry.restores == 0
        assert entry.trusted_streak == 0
        snap = engine.snapshot()
        assert snap["integrity"]["probations"] == 1
        assert snap["integrity"]["probation_restores"] == 0
        assert snap["integrity"]["recomputes"] == 1
    finally:
        engine.close()


def test_sampled_policy_never_probes(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=2, max_wait_ms=20.0, probation_after=1)
    try:
        entry = engine.register_model("vgg16", cfg, params, device="cpu",
                                      integrity=IntegrityPolicy.sampled(0.5))
        entry.quarantined = True
        entry.trusted_streak = 10
        resp = engine.submit("vgg16", _request(cfg, 315, rng)[0]).result(
            timeout=TIMEOUT)
        assert resp.ok
        assert entry.quarantined and entry.probations == 0
        assert engine.stats.trusted_batches == 1
    finally:
        engine.close()


def test_trusted_streak_counts_toward_probation(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=2, max_wait_ms=20.0, probation_after=5)
    try:
        entry = engine.register_model("vgg16", cfg, params, device="cpu")
        entry.quarantined = True
        resp = engine.submit("vgg16", _request(cfg, 320, rng)[0]).result(
            timeout=TIMEOUT)
        assert resp.ok
        assert entry.trusted_streak == 1
        assert entry.quarantined and entry.probations == 0
        assert engine.stats.trusted_batches == 1
    finally:
        engine.close()


def test_consecutive_failures_quarantine_the_model(zoo, rng):
    """``quarantine_after`` flagged batches in a row bench the backend:
    the next batch runs trusted, and every response stays correct."""
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=1, max_wait_ms=5.0, quarantine_after=2)
    try:
        entry = engine.register_model(
            "vgg16", cfg, params, device="cpu",
            integrity=IntegrityPolicy.full(1),
            fault=DishonestDevice(FaultSpec("bit_flip")))
        got = [engine.submit("vgg16", _request(cfg, 330 + i, rng)[0]).result(
            timeout=TIMEOUT) for i in range(3)]
        assert [r.flagged for r in got] == [True, True, False]
        assert all(r.ok for r in got)
        assert entry.quarantined and entry.integrity_failures == 2
        snap = engine.snapshot()
        assert snap["integrity"]["quarantines"] == 1
        assert snap["integrity"]["trusted_batches"] == 1
        assert snap["integrity"]["recomputes"] == 2
    finally:
        engine.close()


def test_sharded_model_quarantines_device_not_model(zoo, rng):
    cfg, params = zoo["vgg16"]
    pool = DevicePool(2, faults={1: DishonestDevice(FaultSpec("bit_flip"))},
                      health=DeviceHealthConfig(quarantine_after=1,
                                                probation_after=10 ** 6))
    engine = _engine(max_batch=2, max_wait_ms=20.0)
    try:
        entry = engine.register_model("vgg16", cfg, params, devices=pool,
                                      device="cpu")
        resp = engine.submit("vgg16", _request(cfg, 340, rng)[0]).result(
            timeout=TIMEOUT)
        assert resp.ok and resp.flagged
        assert not entry.quarantined
        assert pool.slots[1].quarantined and not pool.slots[0].quarantined
        snap = engine.snapshot()
        assert snap["integrity"]["shard_failures"] >= 1
        assert snap["integrity"]["shard_retries"] >= 1
        assert snap["integrity"]["recomputes"] == 0
        devs = snap["devices"]["vgg16"]["pool"]["slots"]
        assert devs[1]["quarantined"] and not devs[0]["quarantined"]
        assert not snap["models"]["vgg16"]["quarantined"]
    finally:
        engine.close()


def test_session_pool_refills_executor_cache(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=2, max_wait_ms=20.0, session_pool_depth=3)
    try:
        entry = engine.register_model("vgg16", cfg, params, device="cpu")
        reqs = [_request(cfg, 80 + i, rng)[0] for i in range(2)]
        [f.result(timeout=TIMEOUT)
         for f in [engine.submit("vgg16", r) for r in reqs]]
        assert entry.executor.cache is not None
        entry.pool.prime()
        assert entry.pool.ready() >= 1
        assert entry.pool.stats()["refilled"] >= 1
    finally:
        engine.close()


# -- the pipeline: two stages or one, the same bits ---------------------------

def _serve_waves(engine, name, waves):
    out = []
    for wave in waves:
        futures = [engine.submit(name, r) for r in wave]
        engine.flush()
        out += [f.result(timeout=TIMEOUT) for f in futures]
    return out


def test_serial_dispatch_bit_identical_to_pipeline(zoo, rng):
    cfg, params = zoo["vgg16"]
    reqs = [_request(cfg, 400 + i, rng)[0] for i in range(7)]
    root = np.asarray([11, 22], np.uint32)
    runs = {}
    for pipeline in (True, False):
        engine = _engine(max_batch=4, max_wait_ms=60_000.0,
                         pipeline=pipeline)
        try:
            ex = OrigamiExecutor(cfg, params, precompute=True,
                                 integrity=IntegrityPolicy.full(2),
                                 device="cpu")
            engine.register_executor("vgg16", ex,
                                     pool=SessionPool(ex, root=root))
            runs[pipeline] = _serve_waves(engine, "vgg16",
                                          (reqs[:4], reqs[4:6], reqs[6:]))
            snap = engine.snapshot()
        finally:
            engine.close()
        assert snap["batches"] == 3 and snap["buckets"] == {
            4: {"batches": 1}, 2: {"batches": 1}, 1: {"batches": 1}}
    for a, b in zip(runs[True], runs[False]):
        assert a.ok and b.ok
        assert torch.equal(a.box.ciphertext, b.box.ciphertext)
        assert a.box.mac == b.box.mac


# -- against the JAX engine ---------------------------------------------------

@pytest.fixture(scope="module")
def jax_vs_port():
    jcfg, cfg = jget_smoke("vgg16"), get_smoke("vgg16")
    jparams = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jparams)
    root = np.asarray(jax.random.PRNGKey(1234), np.uint32)
    rng = np.random.default_rng(0)
    imgs = [make_batch(i, 1, cfg.image_size)[0] for i in range(9)]
    keys = [rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
            for _ in range(9)]
    out = {}
    for side in ("jax", "port"):
        if side == "jax":
            ex = JEx(jcfg, jparams, mode="slalom", precompute=True,
                     integrity=JIG.IntegrityPolicy.full(2))
            engine = JE.ServingEngine(JE.EngineConfig(max_batch=4,
                                                      max_wait_ms=60_000.0))
            pool, S = JSS.SessionPool(ex, root=root), JS
            flip = np.uint32(1)
        else:
            ex = OrigamiExecutor(cfg, V.params_from_numpy(npp, "cpu"),
                                 mode="slalom", precompute=True,
                                 integrity=IntegrityPolicy.full(2),
                                 device="cpu")
            engine = ServingEngine(EngineConfig(max_batch=4,
                                                max_wait_ms=60_000.0))
            pool, S = SessionPool(ex, root=root), TS
            flip = 1
        reqs = [S.Request(i, S.PrivateInferenceServer.client_seal(k, im, i),
                          im.shape, k)
                for i, (k, im) in enumerate(zip(keys, imgs))]
        box = reqs[5].box                     # tampered in flight
        reqs[5].box = box._replace(mac=box.mac ^ flip)
        try:
            engine.register_executor("vgg16", ex, pool=pool)
            resps = _serve_waves(engine, "vgg16",
                                 (reqs[0:4], reqs[4:8], reqs[8:9]))
            snap = engine.snapshot()
        finally:
            engine.close()
        out[side] = (resps, snap)
    return out


def test_port_engine_responses_equal_jax_engine(jax_vs_port):
    jresps, _ = jax_vs_port["jax"]
    tresps, _ = jax_vs_port["port"]
    assert [r.ok for r in tresps] == [r.ok for r in jresps] == [
        True] * 5 + [False] + [True] * 3
    assert tresps[5].error == jresps[5].error == "mac_failed"
    for j, t in zip(jresps, tresps):
        assert j.rid == t.rid
        if j.box is None:
            continue
        np.testing.assert_array_equal(
            t.box.ciphertext.numpy(),
            np.asarray(j.box.ciphertext).astype(np.int64))
        np.testing.assert_array_equal(t.box.nonce, np.asarray(j.box.nonce))
        assert t.box.mac == int(j.box.mac)


def test_port_engine_counters_equal_jax_engine(jax_vs_port):
    _, jsnap = jax_vs_port["jax"]
    _, tsnap = jax_vs_port["port"]
    for k in ("submitted", "completed", "rejected", "expired",
              "mac_failures", "batches", "padded_slots", "batched_requests",
              "buckets", "integrity", "liveness"):
        assert tsnap[k] == jsnap[k], k
    assert tsnap["batches"] == 3 and tsnap["padded_slots"] == 1
    assert tsnap["integrity"]["verify_checks"] > 0
    for k in ("consumed", "reuse_checked", "refill_errors"):
        assert (tsnap["sessions"]["vgg16"][k]
                == jsnap["sessions"]["vgg16"][k]), k
    assert tsnap["models"]["vgg16"] == jsnap["models"]["vgg16"]
    assert set(tsnap) == set(jsnap)
    tcount = tsnap["metrics"]["counters"]
    jcount = jsnap["metrics"]["counters"]
    for name in jcount:
        if name.startswith(("engine.", "integrity.", "shard.", "liveness.")):
            assert tcount[name] == jcount[name], name


# -- compile-once serving ----------------------------------------------------

def test_concurrent_register_builds_each_bucket_once(zoo):
    """Two models sharing one plan digest and weights, registered at once
    with warm-up: the shared CompileCache builds each (digest, kind,
    bucket) once and the losing thread memo-hits every signature."""
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=4, aot_warm=True)
    errs = []

    def register(name):
        try:
            engine.register_model(name, cfg, params, device="cpu")
        except Exception as e:  # noqa: BLE001 — surfaced below
            errs.append(e)

    try:
        ts = [threading.Thread(target=register, args=(n,))
              for n in ("vgg16-a", "vgg16-b")]
        [t.start() for t in ts]
        [t.join(timeout=TIMEOUT) for t in ts]
        assert not any(t.is_alive() for t in ts)
        assert not errs, errs
        c = engine.aot.counters
        assert c["compiles"] == 6 and c["memo_hits"] == 6, c
        assert engine.aot.request_compile_seconds == 0.0
    finally:
        engine.close()


def test_mixed_shape_submits_build_each_bucket_once(zoo, rng):
    cfg, params = zoo["vgg16"]
    engine = _engine(max_batch=4, max_wait_ms=500.0)
    try:
        engine.register_model("vgg16", cfg, params, device="cpu")
        reqs = [_request(cfg, i, rng)[0] for i in range(9)]
        for wave in (reqs[0:4], reqs[4:5], reqs[5:9]):
            got = [f.result(timeout=TIMEOUT)
                   for f in [engine.submit("vgg16", r) for r in wave]]
            assert all(r.ok for r in got)
        assert engine.aot.counters["compiles"] == 2, engine.aot.counters
        snap = engine.snapshot()
        assert set(snap["buckets"]) == {1, 4}
        assert snap["buckets"][4]["batches"] == 2
        assert snap["aot"]["persistent"] is False
    finally:
        engine.close()


def test_compile_cache_dir_raises(tmp_path):
    with pytest.raises(NotImplementedError, match="serialized"):
        ServingEngine(EngineConfig(compile_cache_dir=str(tmp_path)))


# -- observability -----------------------------------------------------------

def test_engine_stats_concurrent_hammer():
    stats = EngineStats()
    n_threads, iters = 8, 400

    def worker():
        for _ in range(iters):
            stats.inc("submitted")
            stats.inc_many(batches=1, batched_requests=2, padded_slots=1)
            with stats.lock:
                stats.inc("completed")
                stats.inc("verify_checks", 3)
            stats.record_done(0.01)

    threads = [threading.Thread(target=worker) for _ in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join(timeout=60)
    assert not any(t.is_alive() for t in threads)
    total = n_threads * iters
    assert stats.submitted == total
    assert stats.batches == total
    assert stats.batched_requests == 2 * total
    assert stats.padded_slots == total
    assert stats.completed == 2 * total
    assert stats.verify_checks == 3 * total
    assert len(stats.latencies) == min(total, EngineStats.LAT_WINDOW)
    assert stats.lock is stats.registry.lock


def test_engine_stats_counter_names_match_reference():
    assert EngineStats.COUNTERS == JE.EngineStats.COUNTERS


SENTINEL = 0.98765432


@pytest.fixture(scope="module")
def traced_run():
    """One request through a blinded + enclave + verified-open plan
    (``bbevvooo``) under full verification, row-sharded over 2 simulated
    devices with device 1 flipping bits."""
    cfg = get_smoke("vgg16")
    params = V.init_params(cfg, 0, device="cpu")
    tracer = Tracer()
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=20.0),
                           tracer=tracer)
    try:
        entry = engine.register_model(
            "vgg16", cfg, params, device="cpu",
            placement=PL.from_string(cfg, "bbevvooo",
                                     verify=IntegrityPolicy.full(1)),
            integrity=IntegrityPolicy.full(1),
            devices=DevicePool(2, faults={1: DishonestDevice(
                FaultSpec("bit_flip"))}),
            shard="rows")
        img = np.full((cfg.image_size, cfg.image_size, 3), SENTINEL,
                      np.float32)
        key = np.array([0xDEADBEEF, 0x12345678], dtype=np.uint32)
        box = PrivateInferenceServer.client_seal(key, img, 7)
        resp = engine.submit("vgg16", Request(
            rid=7, box=box, shape=img.shape, session_key=key)).result(
            timeout=TIMEOUT)
        assert resp.ok, resp.error
        logits = PrivateInferenceServer.client_open(key, resp.box,
                                                    (cfg.num_classes,))
        snap = engine.snapshot()
        issued = [np.frombuffer(kb, np.uint32).copy()
                  for kb in entry.pool._issued]
        factors = entry.executor.cache.session_factors(issued[0])
        tele = entry.executor.telemetry_blinded
        tele_cut = {"blinded_bytes": tele.blinded_bytes,
                    "offloaded_flops": tele.offloaded_flops}
    finally:
        engine.close()
    return {"tracer": tracer, "snap": snap, "client_key": key, "img": img,
            "logits": logits, "issued": issued, "factors": factors,
            "tele": tele_cut}


def test_span_tree_connected_and_complete(traced_run):
    tr = traced_run["tracer"]
    spans = tr.spans()
    roots = tr.roots()
    assert len(roots) == 1 and roots[0].name == "request"
    root = roots[0]
    by_id = tr.by_id()
    for s in spans:
        cur, hops = s, 0
        while cur.parent_id is not None:
            cur = by_id[cur.parent_id]
            hops += 1
            assert hops < 50
        assert cur.span_id == root.span_id, f"{s.name} detached from root"
        assert s.trace_id == root.trace_id
    assert [s.name for s in spans if s.t1 is None] == []
    required = {"request", "queue", "batch", "unseal", "session.acquire",
                "infer", "plan.segment", "op.blinded", "shard.matmul",
                "shard.dispatch", "verify", "seal", "kernel.limb_matmul",
                "kernel.fold"}
    names = {s.name for s in spans}
    assert required <= names, required - names
    dispatches = [s for s in spans if s.name == "shard.dispatch"]
    assert {"verify_failed", "verified"} <= {s.attrs.get("outcome")
                                              for s in dispatches}
    assert "retry" in {s.attrs.get("attempt") for s in dispatches}
    ops = [s for s in spans if s.name == "op.blinded"]
    assert any(s.attrs.get("verified_open") for s in ops)
    assert any(not s.attrs.get("verified_open") for s in ops)
    for s in spans:
        assert s.t0 >= root.t0 - 1e-6
        assert s.t1 <= root.t1 + 1e-6


def test_trace_exports_valid_chrome_json(traced_run, tmp_path):
    tr = traced_run["tracer"]
    out = tmp_path / "trace.json"
    n = tr.dump_chrome(out)
    doc = json.loads(out.read_text())
    ev = doc["traceEvents"]
    assert len(ev) == n
    xs = [e for e in ev if e["ph"] == "X"]
    assert len(xs) == len(tr.spans())
    for e in xs:
        assert e["dur"] >= 0 and e["ts"] >= 0
        assert {"trace_id", "span_id", "parent_id"} <= set(e["args"])
        assert e["cat"] in tracing.KINDS
    assert doc["otherData"]["dropped_spans"] == 0
    outl = tmp_path / "trace.jsonl"
    assert tr.dump_jsonl(outl) == len(tr.spans())
    lines = [json.loads(ln) for ln in outl.read_text().splitlines()]
    assert {ln["name"] for ln in lines} == {s.name for s in tr.spans()}


def _secret_texts(key, logits, extra_keys=()):
    texts = [f"{SENTINEL:.8f}"[:9]]
    for k in list(extra_keys) + [key]:
        texts += [str(int(w)) for w in k if int(w) > 10 ** 6]
    for v in np.asarray(logits).ravel():
        if abs(v) > 1e-3:
            texts.append(np.format_float_positional(v, precision=6,
                                                    trim="-"))
    return texts


def _assert_no_text(texts, blob, where):
    for ft in texts:
        pat = re.compile(rf"(?<![\d.]){re.escape(ft)}(?![\d.])")
        assert not pat.search(blob), f"secret {ft!r} leaked into {where}"


def test_serialized_trace_carries_no_secret_material(traced_run):
    tr = traced_run["tracer"]
    blob_text = (json.dumps(tr.to_chrome()) + "\n"
                 + "\n".join(json.dumps(s.as_dict()) for s in tr.spans()))
    blob = blob_text.encode()
    forbidden = [traced_run["client_key"].tobytes(),
                 traced_run["img"].tobytes()[:4096],
                 traced_run["logits"].tobytes()]
    forbidden += [k.tobytes() for k in traced_run["issued"]]
    texts = _secret_texts(traced_run["client_key"], traced_run["logits"],
                          traced_run["issued"])
    for e in traced_run["factors"]:
        r = e.get("r")
        if r is not None:
            flat = np.asarray(r).ravel()
            forbidden.append(flat.tobytes()[:4096])
            texts += [str(int(v)) for v in flat[:64] if int(v) > 10 ** 6][:16]
    for fb in forbidden:
        assert fb not in blob
    _assert_no_text(texts, blob_text, "the trace")


def test_registry_agrees_with_legacy_surfaces(traced_run):
    snap = traced_run["snap"]
    metrics = snap["metrics"]
    c, g = metrics["counters"], metrics["gauges"]
    integ = snap["integrity"]
    assert c["integrity.verify_checks"] == integ["verify_checks"]
    assert c["shard.checks"] == integ["shard_checks"] > 0
    assert c["shard.failures"] == integ["shard_failures"] > 0
    assert c["shard.retries"] == integ["shard_retries"] > 0
    assert c["engine.submitted"] == snap["submitted"] == 1
    assert c["engine.completed"] == snap["completed"] == 1
    assert c["engine.batches"] == snap["batches"]
    tele = traced_run["tele"]
    assert g["model.vgg16.telemetry.blinded_bytes"] == \
        tele["blinded_bytes"] > 0
    assert g["model.vgg16.telemetry.offloaded_flops"] == \
        tele["offloaded_flops"]
    shard = snap["devices"]["vgg16"]["totals"]
    assert g["model.vgg16.shard.checks"] == shard["checks"]
    assert g["model.vgg16.shard.failures"] == shard["failures"]
    assert metrics["histograms"]["engine.latency_s"]["count"] == 1


def test_device_and_watchdog_gauges_exported(traced_run):
    snap = traced_run["snap"]
    g = snap["metrics"]["gauges"]
    slots = snap["devices"]["vgg16"]["pool"]["slots"]
    for idx, slot in enumerate(slots):
        pre = f"device.vgg16.{idx}"
        assert g[f"{pre}.dispatches"] == slot["dispatches"]
        assert g[f"{pre}.quarantined"] == int(slot["quarantined"])
        assert g[f"{pre}.breaker_state"] in (0, 1, 2)
    assert g["device.vgg16.1.verify_failures"] >= 1
    assert g["device.vgg16.0.verify_failures"] == 0
    assert g["device.vgg16.0.quarantined"] == 0
    wd = snap["devices"]["vgg16"]["watchdog"]
    assert g["model.vgg16.shard.watchdog.p50_s"] == wd["p50_s"]
    assert g["model.vgg16.shard.watchdog.samples"] == wd["samples"]
    assert g["model.vgg16.shard.watchdog.dispatch_timeout_s"] == \
        wd["dispatch_timeout_s"] > 0
    if wd["hedge_deadline_s"] is not None:
        assert g["model.vgg16.shard.watchdog.hedge_deadline_s"] == \
            wd["hedge_deadline_s"]
    assert "engine.watchdog.p50_s" in g


# -- the quarantine post-mortem bundle ---------------------------------------

QSENTINEL = 0.91827364


@pytest.fixture(scope="module")
def quarantine_bundle(tmp_path_factory):
    """A bit-flipping device under full verification with
    ``quarantine_after=1``: the first flagged batch quarantines the model
    and dumps a post-mortem bundle."""
    out_dir = tmp_path_factory.mktemp("postmortem")
    cfg = get_smoke("vgg16")
    params = V.init_params(cfg, 0, device="cpu")
    tracer = Tracer(kernel_spans=False)
    rec = FlightRecorder(out_dir=str(out_dir), min_interval_s=0.0)
    engine = ServingEngine(
        EngineConfig(max_batch=2, max_wait_ms=20.0, quarantine_after=1),
        tracer=tracer, recorder=rec)
    try:
        entry = engine.register_model(
            "vgg16", cfg, params, mode="origami", device="cpu",
            integrity=IntegrityPolicy.full(1),
            fault=DishonestDevice(FaultSpec("bit_flip")))
        img = np.full((cfg.image_size, cfg.image_size, 3), QSENTINEL,
                      np.float32)
        key = np.array([0xFEEDC0DE, 0x87654321], dtype=np.uint32)
        box = PrivateInferenceServer.client_seal(key, img, 3)
        resp = engine.submit("vgg16", Request(
            rid=3, box=box, shape=img.shape, session_key=key)).result(
            timeout=TIMEOUT)
        assert resp.ok, resp.error
        logits = PrivateInferenceServer.client_open(key, resp.box,
                                                    (cfg.num_classes,))
        snap = engine.snapshot()
    finally:
        engine.close()
    return {"snap": snap, "entry": entry, "out_dir": out_dir,
            "recorder": rec, "img": img, "key": key, "logits": logits}


def test_quarantine_dumps_postmortem_bundle(quarantine_bundle):
    snap = quarantine_bundle["snap"]
    assert snap["models"]["vgg16"]["quarantined"]
    assert snap["integrity"]["quarantines"] == 1
    names = [f.name for f in
             sorted(quarantine_bundle["out_dir"].glob("*.json"))]
    assert any("quarantine" in n for n in names), names
    assert any("verify_failure" in n for n in names), names
    bundle = quarantine_bundle["recorder"].last_bundle
    assert bundle["trigger"] in ("quarantine", "verify_failure")
    assert bundle["metrics"]["counter_delta"]
    assert any(s["name"] == "request" for s in bundle["spans"])
    assert snap["flight_recorder"]["dumps"] == len(names)


def test_postmortem_bundle_carries_no_secret_material(quarantine_bundle):
    blobs = [(f.name, f.read_text()) for f in
             sorted(quarantine_bundle["out_dir"].glob("*.json"))]
    assert blobs
    key = quarantine_bundle["key"]
    texts = [f"{QSENTINEL:.8f}"[:9]] + _secret_texts(
        key, quarantine_bundle["logits"])[1:]
    for name, text in blobs:
        raw = text.encode()
        assert key.tobytes() not in raw
        assert quarantine_bundle["img"].tobytes()[:4096] not in raw
        _assert_no_text(texts, text, name)


def test_engine_snapshot_phases_decompose_wall(quarantine_bundle):
    phases = quarantine_bundle["snap"]["phases"]
    assert phases["requests"] == 1
    assert set(phases["taxonomy"]) == set(PHASES)
    (key, prof), = phases["profiles"].items()
    model, digest, bucket = key.split("|")
    assert model == "vgg16"
    assert digest == quarantine_bundle["entry"].executor.plan.digest[:12]
    assert prof["critical_sum_s"] == pytest.approx(prof["wall_s"], rel=1e-6)
    assert prof["critical_s"]["unseal"] > 0
    assert prof["critical_s"]["seal"] > 0
