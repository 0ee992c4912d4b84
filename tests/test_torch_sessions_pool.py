"""The port's ``SessionPool`` (``runtime/sessions.py``) against the JAX
reference on the CPU: for the same root both pools hand out bit-equal keys
in the same order; the reuse guard, the refill thread, its fault hook and
the counters behave as the reference's; and a pool feeding a port executor
keeps every bucket's factors prefetched, with served results bit-equal to
the executor's own live run."""
import threading
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

from repro.runtime import sessions as JSS  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime import sessions as TSS  # noqa: E402


@pytest.mark.parametrize("seed", [0, 7, 2 ** 33 + 5, 2 ** 64 - 1])
def test_fresh_root_matches_reference(seed):
    np.testing.assert_array_equal(TSS.fresh_root(seed),
                                  np.asarray(JSS.fresh_root(seed)))


def test_unseeded_roots_differ():
    assert not np.array_equal(TSS.fresh_root(), TSS.fresh_root())


@pytest.mark.parametrize("depth", [1, 3])
def test_keys_bit_equal_to_reference(depth):
    root = TSS.fresh_root(1234)
    tpool = TSS.SessionPool(None, depth=depth, root=root, background=False)
    jpool = JSS.SessionPool(None, depth=depth, root=jax.numpy.asarray(root),
                            background=False)
    for _ in range(3):
        tpool.prime()
        jpool.prime()
        for _ in range(depth + 1):
            np.testing.assert_array_equal(tpool.acquire(),
                                          np.asarray(jpool.acquire()))
    assert tpool.stats() == jpool.stats()
    tpool.close()
    jpool.close()


def test_reuse_guard_trips_like_the_reference():
    for mod in (TSS, JSS):
        pool = mod.SessionPool(None, depth=2, background=False)
        pool.acquire()
        pool._head = 0                        # a counter rollback
        with pytest.raises(mod.SessionReuseError):
            pool.acquire()
        assert pool.stats()["reuse_checked"] == 2
        pool.close()


def test_acquire_outruns_refill():
    pool = TSS.SessionPool(None, depth=2, background=False)
    keys = [pool.acquire().tobytes() for _ in range(7)]
    assert len(set(keys)) == 7
    assert pool._next == pool._head == 7
    pool.prime()
    more = [pool.acquire().tobytes() for _ in range(4)]
    assert len(set(keys + more)) == 11
    assert pool.stats()["consumed"] == 11
    pool.close()


def test_concurrent_acquire_never_reuses():
    pool = TSS.SessionPool(None, depth=4)     # background refill on
    n_threads, per_thread = 8, 25
    out, errors = [None] * n_threads, []

    def worker(i):
        try:
            out[i] = [pool.acquire().tobytes() for _ in range(per_thread)]
        except Exception as exc:  # noqa: BLE001 — surfaced below
            errors.append(exc)

    threads = [threading.Thread(target=worker, args=(i,))
               for i in range(n_threads)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    assert not errors, errors
    assert len({k for ks in out for k in ks}) == n_threads * per_thread
    s = pool.stats()
    assert s["consumed"] == s["reuse_checked"] == n_threads * per_thread
    pool.close()


@pytest.fixture(scope="module")
def executor():
    cfg = get_smoke("vgg16")
    ex = OrigamiExecutor(cfg, V.init_params(cfg, 0, device="cpu"),
                         precompute=True, integrity=IntegrityPolicy.full(2),
                         device="cpu")
    x = torch.rand((2, cfg.image_size, cfg.image_size, 3),
                   generator=torch.Generator().manual_seed(3))
    return cfg, ex, {"images": x}


def test_pool_refills_every_bucket_cache(executor):
    cfg, ex, batch = executor
    ex.build_cache(batch)
    ex.build_cache({"images": batch["images"][:1]})
    pool = TSS.SessionPool(ex, depth=3, background=False)
    pool.prime()
    assert pool.ready() == 3
    assert all(c.prefetched(pool._key_for(0)) for c in ex._caches.values())
    key = pool.acquire()
    assert pool.stats()["misses"] == 0
    got = ex.infer(batch, session_key=key)
    live = OrigamiExecutor(ex.cfg, ex.params, integrity=ex.integrity,
                           device="cpu").infer(batch, session_key=key)
    assert torch.equal(got.logits, live.logits)
    assert torch.equal(got.boundary, live.boundary)
    assert got.integrity.ok and got.integrity.n_checked > 0
    pool.close()


def test_refill_fault_is_contained(executor):
    cfg, ex, batch = executor
    ex.build_cache(batch)

    def fault(counter):
        if counter == 2:
            raise RuntimeError("scripted refill failure")

    pool = TSS.SessionPool(ex, depth=4, refill_fault=fault,
                           background=False)
    pool.prime()
    keys = [pool.acquire() for _ in range(4)]
    s = pool.stats()
    assert s["refill_errors"] == 1 and s["refilled"] == 3, s
    assert s["misses"] == 1, s                # the failed session's
    # the failed session still serves: its factors are drawn on first use
    res = ex.infer(batch, session_key=keys[2])
    assert res.integrity.ok
    pool.close()


def test_close_drops_unissued_prefetched_sets(executor):
    cfg, ex, batch = executor
    ex.build_cache(batch)
    pool = TSS.SessionPool(ex, depth=3, background=False)
    pool.prime()
    key = pool.acquire()
    assert pool.ready() == 2
    pool.close()
    assert pool.ready() == 0
    assert ex.cache.prefetched(key)           # issued: still to be taken
    assert not any(ex.cache.prefetched(pool._key_for(c)) for c in (1, 2))
    assert ex.infer(batch, session_key=key).integrity.ok


def test_refill_thread_prefetches_ahead(executor):
    cfg, ex, batch = executor
    ex.build_cache(batch)
    pool = TSS.SessionPool(ex, depth=2)
    deadline = time.monotonic() + 60.0
    while pool.ready() < 2 and time.monotonic() < deadline:
        time.sleep(0.01)
    assert pool.ready() == 2
    pool.acquire()
    pool.close()
    s = pool.stats()
    assert s["misses"] == 0 and s["refill_errors"] == 0, s
    assert s["refilled"] >= 2


def test_acquire_stream_binds_a_token_ring():
    pool = TSS.SessionPool(None, depth=1, background=False)
    key, ring = pool.acquire_stream(None)
    assert ring is None and key.shape == (2,)
    pool.close()
