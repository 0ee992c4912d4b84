"""``PrivateInferenceServer.serve`` (through the engine) and the serving
launcher ``repro_torch.launch.serve`` on the CPU at the smoke size: the
legacy loop, the mixed-model engine cross-checked against synchronous
servers, and the chaos drill each exit cleanly, and the memory-only
compile cache refuses ``--compile-cache-dir``."""
import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.launch import serve as jserve  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.launch import serve  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.privacy.data import make_batch  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)

_OWNED_PREFIXES = ("offload-dev", "session-pool-refill",
                   "serving-engine-batcher", "serving-engine-device")


def _owned_threads():
    return {t for t in threading.enumerate()
            if t.is_alive() and t.name.startswith(_OWNED_PREFIXES)}


@pytest.fixture(scope="module")
def server():
    cfg = get_smoke("vgg16")
    srv = PrivateInferenceServer(cfg, V.init_params(cfg, 0, device="cpu"),
                                 max_batch=4, device="cpu")
    yield cfg, srv
    srv.close()


def _request(cfg, rid, rng):
    img = make_batch(rid, 1, cfg.image_size)[0]
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, img, rid)
    return Request(rid=rid, box=box, shape=img.shape, session_key=key), key


def test_duplicate_rids_all_served(server, rng):
    """Duplicate rids get real answers: the engine would reject a rid in
    flight, so ``serve`` submits them in waves."""
    cfg, srv = server
    req, key = _request(cfg, 77, rng)
    responses = srv.serve([req, req])
    assert [r.rid for r in responses] == [77, 77]
    assert all(r.ok for r in responses)
    a, b = (PrivateInferenceServer.client_open(key, r.box, (cfg.num_classes,))
            for r in responses)
    np.testing.assert_array_equal(a, b)


def test_serve_returns_request_order_equal_to_serve_batch(server, rng):
    cfg, srv = server
    reqs, keys = zip(*[_request(cfg, 200 + i, rng) for i in range(6)])
    bad = reqs[2].box.ciphertext.clone()
    bad.view(-1)[0] ^= 1
    reqs = list(reqs)
    reqs[2] = Request(reqs[2].rid, reqs[2].box._replace(ciphertext=bad),
                      reqs[2].shape, reqs[2].session_key)
    got = srv.serve(reqs)
    assert [r.rid for r in got] == [r.rid for r in reqs]
    assert [r.ok for r in got] == [True, True, False, True, True, True]
    assert got[2].error == "mac_failed"
    want = srv.serve_batch(reqs[:4]) + srv.serve_batch(reqs[4:])
    for k, g, w in zip(keys, got, want):
        if g.ok:
            np.testing.assert_array_equal(
                PrivateInferenceServer.client_open(k, g.box,
                                                   (cfg.num_classes,)),
                PrivateInferenceServer.client_open(k, w.box,
                                                   (cfg.num_classes,)))


def test_engine_is_lazy_shared_and_closed(rng):
    cfg = get_smoke("vgg16")
    before = _owned_threads()
    srv = PrivateInferenceServer(cfg, V.init_params(cfg, 0, device="cpu"),
                                 max_batch=2, device="cpu")
    try:
        assert srv._engine is None
        engine = srv.engine
        assert srv.engine is engine
        assert engine.models["default"].executor is srv.executor
        assert engine.cfg.max_batch == 2
        assert engine.cfg.max_queue == 1_000_000_000
        assert srv.serve([_request(cfg, 5, rng)[0]])[0].ok
    finally:
        srv.close()
    assert srv._engine is None
    assert not (_owned_threads() - before)
    srv.close()                                 # idempotent


def test_default_chaos_schedule_equals_reference():
    assert serve.DEFAULT_CHAOS == jserve.DEFAULT_CHAOS


def _main(capsys, *argv):
    serve.main(["--smoke", "--device", "cpu", *argv])
    return capsys.readouterr().out


def test_main_legacy_loop(capsys):
    out = _main(capsys, "--requests", "8")
    assert "[serve] 8/8 ok" in out
    assert "attested enclave" in out


def test_main_engine_bit_identical(capsys, tmp_path):
    before = _owned_threads()
    metrics = tmp_path / "metrics.json"
    out = _main(capsys, "--engine", "--aot-warm", "--requests", "16",
                "--metrics-out", str(metrics))
    assert "[engine] 16/16 ok" in out
    assert "bit-identical vs legacy: OK" in out
    assert "out_of_order=True" in out
    assert "request_compile_s=0.00" in out
    assert metrics.is_file()
    assert not (_owned_threads() - before)


def test_main_chaos_drill(capsys):
    before = _owned_threads()
    out = _main(capsys, "--engine", "--models", "vgg16", "--devices", "2",
                "--chaos", "--batch", "2", "--chaos-margin", "6",
                "--chaos-pace", "0")
    assert "[chaos] OK" in out, out
    assert "FAIL" not in out
    assert not (_owned_threads() - before)


def test_compile_cache_dir_is_refused(capsys, tmp_path):
    with pytest.raises(SystemExit) as exc:
        serve.main(["--smoke", "--device", "cpu", "--engine",
                    "--compile-cache-dir", str(tmp_path)])
    assert exc.value.code == 2
    assert "--compile-cache-dir" in capsys.readouterr().err
