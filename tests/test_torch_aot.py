"""The port's compile-once executable cache (``runtime/aot.py``) and the
executor's AOT hooks (``attach_aot``, ``warm_aot``) against the JAX
reference, on the CPU.

The bucket ladder, shape signatures and the cache's counters under races
equal the reference's. On the CPU an executable is the eager step itself,
so an executable's result equals the eager one bit for bit, and the
counters count exactly as on the card: one build per (trace kind, plan
digest, bucket), none on the request path after ``warm_aot``. Executors
whose step depends on host-side values per request (a plane, an injected
fault, live factors, a sampled policy) stay eager.
"""
import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")

import repro.core  # noqa: E402,F401  (before kernels: circular import)
from repro.runtime import aot as JA  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import tracing  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.core.prng import PRNGKey  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime import aot as TA  # noqa: E402
from repro_torch.runtime.devices import DevicePool  # noqa: E402
from repro_torch.runtime.faults import DishonestDevice, FaultSpec  # noqa: E402
from repro_torch.runtime.observability import MetricsRegistry  # noqa: E402


@pytest.mark.parametrize("max_batch", [1, 4, 6, 8])
def test_bucket_ladder_matches_reference(max_batch):
    assert TA.bucket_ladder(max_batch) == JA.bucket_ladder(max_batch)
    for n in range(1, max_batch + 1):
        assert TA.bucket_for(n, max_batch) == JA.bucket_for(n, max_batch)
    for bad in (0, max_batch + 1):
        with pytest.raises(AssertionError):
            TA.bucket_for(bad, max_batch)


_TREES = [
    {"x": np.zeros((2, 3), np.int32)},
    ({"images": np.zeros((4, 8, 8, 3), np.float32)},
     np.zeros(2, np.uint32), None),
    [np.zeros((5,), np.int8), 3, {"b": np.ones((1, 2), np.float32),
                                  "a": np.ones(3, bool)}],
]


@pytest.mark.parametrize("tree", _TREES, ids=range(len(_TREES)))
def test_shape_signature_matches_reference(tree):
    assert TA.shape_signature(tree) == JA.shape_signature(tree)


def test_shape_signature_of_tensors_names_their_dtype():
    t = {"images": torch.zeros((4, 8, 8, 3)), "k": torch.zeros(2,
                                                               dtype=torch.int32)}
    n = {"images": np.zeros((4, 8, 8, 3), np.float32),
         "k": np.zeros(2, np.int32)}
    assert TA.shape_signature(t) == JA.shape_signature(n)


def test_entry_key_separates_kind_shape_and_plan():
    cache = TA.CompileCache()
    a = torch.zeros((4, 8))
    b = torch.zeros((2, 8))
    k = cache.entry_key("digest0", "blinded", (a,))
    assert k != cache.entry_key("digest0", "trusted", (a,))
    assert k != cache.entry_key("digest0", "blinded", (b,))
    assert k != cache.entry_key("digest1", "blinded", (a,))
    assert k == cache.entry_key("digest0", "blinded", (a,))
    assert TA.code_version() == TA.code_version()
    assert len(TA.code_version()) == 16


def test_compile_once_exactly_once_under_races():
    results = {}
    for mod in (TA, JA):
        cache = mod.CompileCache()
        built = []

        def build():
            built.append(1)
            return "exe"

        out = []

        def worker():
            out.append(cache.compile_once("k", build))

        ts = [threading.Thread(target=worker) for _ in range(8)]
        [t.start() for t in ts]
        [t.join() for t in ts]
        assert len(built) == 1
        assert sum(fresh for _, fresh in out) == 1
        results[mod] = dict(cache.counters)
    assert results[TA] == results[JA]
    assert results[TA]["compiles"] == 1 and results[TA]["memo_hits"] == 7


def test_counters_land_in_the_registry():
    reg = MetricsRegistry()
    cache = TA.CompileCache(registry=reg)
    with cache.warmup_scope():
        assert cache.in_warmup
        cache.compile_once("a", lambda: 1)
    cache.compile_once("b", lambda: 2)
    cache.compile_once("a", lambda: 3)
    cache.record_fallback()
    snap = reg.snapshot()
    assert snap["counters"] == {"aot.compiles": 2, "aot.memo_hits": 1,
                                "aot.exec_fallbacks": 1}
    assert snap["gauges"]["aot.compile_seconds"] >= \
        snap["gauges"]["aot.request_compile_seconds"] >= 0.0
    st = cache.stats()
    assert st["persistent"] is False and st["compiles"] == 2


def test_disk_tier_is_not_ported(tmp_path):
    with pytest.raises(NotImplementedError, match="serialized"):
        TA.CompileCache(cache_dir=str(tmp_path))


@pytest.fixture(scope="module")
def vgg():
    cfg = get_smoke("vgg16")
    params = V.init_params(cfg, 0, device="cpu")
    x = torch.rand((4, cfg.image_size, cfg.image_size, 3),
                   generator=torch.Generator().manual_seed(1))
    return cfg, params, x


def _executor(vgg, **kw):
    cfg, params, _ = vgg
    kw.setdefault("precompute", True)
    kw.setdefault("integrity", IntegrityPolicy.full(2))
    return OrigamiExecutor(cfg, params, device="cpu", **kw)


def test_warm_aot_builds_every_bucket_once(vgg):
    cfg, _, x = vgg
    ex = _executor(vgg)
    cache = TA.CompileCache()
    ex.attach_aot(cache)
    tracer = tracing.Tracer()
    with tracing.activate(tracer):
        n = ex.warm_aot("images", x.shape[1:], TA.bucket_ladder(4))
    assert n == 6 and cache.counters["compiles"] == 6
    assert [s.name for s in tracer.spans()].count("compile.aot") == 6
    assert set(ex._caches) == {ex._batch_key({"images": x[:b]})
                               for b in (1, 2, 4)}
    # requests after the warm-up build nothing and are not first calls
    for b in (4, 1, 2):
        batch = {"images": x[:b]}
        key = PRNGKey(10 + b)
        with tracing.activate(tracer):
            with tracer.span("infer", "infer") as sp:
                got = ex.infer(batch, key)
        assert sp.attrs["first_call"] is False
        want = ex.infer(batch, key, jit=False)
        assert torch.equal(got.logits, want.logits)
        assert torch.equal(got.boundary, want.boundary)
        assert torch.equal(got.integrity.checked, want.integrity.checked)
        assert got.integrity.ok and got.integrity.n_checked > 0
    tr = ex.infer(batch, trusted=True)        # the last bucket's batch
    assert torch.equal(tr.logits, got.logits)
    st = cache.stats()
    assert st["compiles"] == 6 and st["request_compile_seconds"] == 0.0
    assert st["exec_fallbacks"] == 0


def test_request_path_build_is_counted_and_stamped(vgg):
    _, _, x = vgg
    ex = _executor(vgg)
    cache = TA.CompileCache()
    ex.attach_aot(cache)
    tracer = tracing.Tracer()
    stamps = []
    for seed in (1, 2):
        with tracing.activate(tracer):
            with tracer.span("infer", "infer") as sp:
                ex.infer({"images": x}, PRNGKey(seed))
        stamps.append(sp.attrs["first_call"])
    assert stamps == [True, False]
    assert cache.counters["compiles"] == 1
    assert cache.counters["memo_hits"] == 0   # the executor's own memo
    assert cache.request_compile_seconds > 0.0


def test_executors_sharing_weights_share_executables(vgg):
    _, _, x = vgg
    cache = TA.CompileCache()
    a, b = _executor(vgg), _executor(vgg)
    for ex in (a, b):
        ex.attach_aot(cache)
        ex.warm_aot("images", x.shape[1:], (4,))
    assert cache.counters["compiles"] == 2
    assert cache.counters["memo_hits"] == 2
    # other weights: their own executables
    cfg, params, _ = vgg
    other = OrigamiExecutor(cfg, V.init_params(cfg, 1, device="cpu"),
                            precompute=True,
                            integrity=IntegrityPolicy.full(2), device="cpu")
    other.attach_aot(cache)
    other.warm_aot("images", x.shape[1:], (4,))
    assert cache.counters["compiles"] == 4


def test_failing_executable_falls_back_to_the_eager_step(vgg):
    _, _, x = vgg
    ex = _executor(vgg)
    cache = TA.CompileCache()
    ex.attach_aot(cache)
    ex.warm_aot("images", x.shape[1:], (4,))
    sig = (False, ex.plan.digest, ex._shapes({"images": x}))

    def broken(*args):
        raise RuntimeError("executable no longer loads")

    ex._executables = {**ex._executables, sig: broken}
    key = PRNGKey(5)
    got = ex.infer({"images": x}, key)
    want = ex.infer({"images": x}, key, jit=False)
    assert torch.equal(got.logits, want.logits)
    assert cache.counters["exec_fallbacks"] == 1
    assert sig not in ex._executables


@pytest.mark.parametrize("case", ["plane", "fault"])
def test_eager_only_executors_warm_nothing(vgg, case):
    _, _, x = vgg
    if case == "plane":
        pool = DevicePool(2)
        ex = _executor(vgg, devices=pool, hedging=False)
    else:
        pool = None
        ex = _executor(vgg, fault=DishonestDevice(FaultSpec("bit_flip")))
    cache = TA.CompileCache()
    ex.attach_aot(cache)
    try:
        assert ex.warm_aot("images", x.shape[1:], (1, 2, 4)) == 0
        res = ex.infer({"images": x}, PRNGKey(3))
        ex.infer({"images": x}, trusted=True)
        assert cache.counters["compiles"] == 0
        if case == "fault":
            assert res.integrity.n_failed == res.integrity.n_corrupted > 0
    finally:
        if pool is not None:
            pool.close()


@pytest.mark.parametrize("kw", [{"precompute": False},
                                {"integrity": IntegrityPolicy.sampled(0.5)}],
                         ids=["live-factors", "sampled"])
def test_key_dependent_blinded_steps_stay_eager(vgg, kw):
    """A blinded step that derives pads or check decisions from the
    session key on the host cannot be captured once for every session:
    only its trusted trace is built."""
    _, _, x = vgg
    ex = _executor(vgg, **kw)
    cache = TA.CompileCache()
    ex.attach_aot(cache)
    assert ex.warm_aot("images", x.shape[1:], (4,)) == 1
    assert list(ex._executables) == [(True, ex.plan.digest,
                                      ex._shapes({"images": x}))]
    a = ex.infer({"images": x}, PRNGKey(1))
    b = ex.infer({"images": x}, PRNGKey(2))
    assert cache.counters["compiles"] == 1
    assert not torch.equal(a.integrity.checked, torch.ones(0, dtype=bool))
    assert torch.allclose(a.logits, b.logits, atol=0.05 * float(
        a.logits.abs().max()))


def test_warm_aot_needs_a_cache(vgg):
    _, _, x = vgg
    with pytest.raises(AssertionError, match="attach_aot"):
        _executor(vgg).warm_aot("images", x.shape[1:], (1,))
