"""The port's private decode (smollm_135m smoke config) against the JAX
reference on the CPU: decode plans and their digests, the private prompt
pass and token steps against the reference's eager run (``jit=False``)
on the same parameters and tokens, private against trusted bit for bit,
ring-fed against live factors, a dishonest device, the token-slot
ring's guards, sampling at a temperature and ``generate_origami``.

Tier-1 field arithmetic is exact, so the first blinded op's output is
bit-equal across the frameworks, and so are the factor streams and the
integrity reports; the bf16 float layers around it differ by a few ulps
(see tests/test_torch_lm.py), so logits are held to atol 3e-2 * max|ref|.
Tokens are compared teacher-forced: greedy tokens on random weights may
legitimately diverge between the frameworks. Where whole streams are
compared (sampling, ``generate_origami``), the seeds are ones on which no
bf16 rounding flips a pick; the draws themselves are bit-equal
(tests/test_torch_prng.py).
"""
import threading
import time

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.slalom as JSL  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core import plan as JPL  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
import repro_torch.core.slalom as SL  # noqa: E402
from repro_torch.configs import get_config, get_smoke  # noqa: E402
from repro_torch.core import integrity as IG  # noqa: E402
from repro_torch.core import plan as PL  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402
from repro_torch.runtime.faults import (KINDS, DishonestDevice,  # noqa: E402
                                        FaultSpec)
from repro_torch.runtime.sessions import (SlotReuseError,  # noqa: E402
                                          TokenSlotRing)

LOGIT_TOL = 3e-2
SESSION = 9
STEPS = 2                       # teacher-forced decode steps held to the
                                # reference (its eager steps are slow)


def _close(got, want):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


def _f32(t):
    return t.to(torch.float32).numpy()


class _FirstFused:
    """Records the output of the first fused blinded matmul of a run."""

    def __init__(self, module):
        self.module, self.first = module, None
        self.inner = module.fused_blinded_matmul

    def __call__(self, *a, **kw):
        y = self.inner(*a, **kw)
        if self.first is None:
            self.first = np.array(y, np.float32)
        return y

    def __enter__(self):
        self.module.fused_blinded_matmul = self
        return self

    def __exit__(self, *exc):
        self.module.fused_blinded_matmul = self.inner


def _report(rep):
    return tuple(np.asarray(a, bool).tolist()
                 for a in (rep.checked, rep.failed, rep.corrupted))


@pytest.fixture(scope="module")
def smollm():
    cfg, jcfg = get_smoke("smollm_135m"), jget_smoke("smollm_135m")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    return cfg, jcfg, jp, params, prompt


@pytest.fixture(scope="module")
def reference_run(smollm):
    """The reference's eager prompt pass and STEPS greedy token steps
    under full(k=2) verification: logits, tokens, reports and the first
    blinded op's output."""
    _, jcfg, jp, _, prompt = smollm
    ex = JEx(jcfg, jp, "origami", integrity=JIG.IntegrityPolicy.full(k=2))
    ex.attach_decode_plan(max_steps=STEPS + 1)
    key = jax.random.PRNGKey(SESSION)
    S0 = prompt.shape[1]
    with _FirstFused(JSL) as rec:
        logits, caches, rep = ex.prefill_session(
            jnp.asarray(prompt), key, max_seq=S0 + STEPS + 1, jit=False)
    out = {"logits": [np.asarray(logits[:, -1], np.float32)],
           "reports": [_report(rep)], "first": rec.first, "tokens": [],
           "digest": ex.dplan.digest}
    for t in range(S0, S0 + STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out["tokens"].append(np.asarray(tok))
        logits, caches, rep = ex.decode_once(tok, caches, t, key, None,
                                             jit=False)
        out["logits"].append(np.asarray(logits[:, -1], np.float32))
        out["reports"].append(_report(rep))
    return out


def _executor(cfg, params, **kw):
    kw.setdefault("integrity", IG.IntegrityPolicy.full(k=2))
    ex = OrigamiExecutor(cfg, params, "origami", device="cpu", **kw)
    ex.attach_decode_plan(max_steps=STEPS + 1)
    return ex


@pytest.mark.parametrize("getter", ["smoke", "full"])
@pytest.mark.parametrize("policy", [None, ("full", 0.25, 2),
                                    ("sampled", 0.5, 1)])
@pytest.mark.parametrize("mode,partition", [("origami", None),
                                            ("slalom", None),
                                            ("origami", 2)])
def test_decode_plan_digest_matches_reference(getter, policy, mode,
                                              partition):
    get, jget = ((get_smoke, jget_smoke) if getter == "smoke"
                 else (get_config, jget_config))
    cfg, jcfg = get("smollm_135m"), jget("smollm_135m")
    plan = PL.compile_mode(cfg, mode, partition)
    jplan = JPL.compile_mode(jcfg, mode, partition)
    assert plan.digest == jplan.digest
    assert plan.cache_ops == () and PL.linear_layers(cfg) is None
    pol = IG.IntegrityPolicy(*policy) if policy else None
    jpol = JIG.IntegrityPolicy(*policy) if policy else None
    dp = PL.make_decode_plan(cfg, plan, max_steps=16, integrity=pol)
    jdp = JPL.make_decode_plan(jcfg, jplan, max_steps=16, integrity=jpol)
    assert dp.digest == jdp.digest
    assert dp.summary() == jdp.summary()
    assert dp.has_offload == jdp.has_offload
    assert dp.has_verification == jdp.has_verification


def test_scan_exclusion_for_other_families():
    with pytest.raises(PL.ScanExclusion, match="feed-forward family"):
        PL.make_decode_plan(get_smoke("vgg16"), max_steps=4)
    moe = get_smoke("smollm_135m").replace(family="moe")
    with pytest.raises(PL.ScanExclusion, match="expert weights"):
        PL.make_decode_plan(moe, max_steps=4)
    assert issubclass(PL.ScanExclusion, ValueError)
    # a per-step policy cannot bind in the LM forward trace (both packages)
    cfg, jcfg = get_smoke("smollm_135m"), jget_smoke("smollm_135m")
    with pytest.raises(PL.ScanExclusion):
        PL.make_plan(cfg, ["blinded"] + ["open"] * 3,
                     integrity={2: IG.IntegrityPolicy.full(1)})
    with pytest.raises(JPL.ScanExclusion):
        JPL.make_plan(jcfg, ["blinded"] + ["open"] * 3,
                      integrity={2: JIG.IntegrityPolicy.full(1)})


def test_private_decode_matches_reference_eager_run(smollm, reference_run):
    """The port's prompt pass and token steps, teacher-forced on the
    reference's tokens: first blinded op bit-equal, reports equal, logits
    within the bf16 tolerance, the decode plan's digest equal."""
    cfg, _, _, params, prompt = smollm
    ex = _executor(cfg, params)
    assert ex.dplan.digest == reference_run["digest"]
    key = prng.PRNGKey(SESSION)
    S0 = prompt.shape[1]
    with _FirstFused(SL) as rec:
        logits, caches, rep = ex.prefill_session(prompt, key,
                                                 max_seq=S0 + STEPS + 1)
    np.testing.assert_array_equal(rec.first, reference_run["first"])
    got_logits, got_reports = [_f32(logits[:, -1])], [_report(rep)]
    for i, t in enumerate(range(S0, S0 + STEPS)):
        tok = torch.tensor(reference_run["tokens"][i], dtype=torch.long)
        logits, caches, rep = ex.decode_once(tok, caches, t, key)
        got_logits.append(_f32(logits[:, -1]))
        got_reports.append(_report(rep))
    assert got_reports == reference_run["reports"]
    assert all(all(r[0]) and not any(r[1]) for r in got_reports)
    for got, want in zip(got_logits, reference_run["logits"]):
        _close(got, want)


def test_private_generate_bit_exact_vs_trusted(smollm):
    cfg, _, _, params, prompt = smollm
    kw = dict(max_new_tokens=5, integrity=IG.IntegrityPolicy.full(k=2),
              session_key=prng.PRNGKey(SESSION), device="cpu")
    priv = G.private_generate(params, prompt, cfg, **kw)
    oracle = G.private_generate(params, prompt, cfg, trusted=True, **kw)
    assert torch.equal(priv.tokens, oracle.tokens)
    assert torch.equal(priv.logits, oracle.logits)
    assert priv.logits.shape == (2, 5, cfg.padded_vocab)
    n_ops = 7 * cfg.origami.tier1_layers * (1 + priv.decode_steps)
    assert priv.integrity.n_ops == priv.integrity.n_checked == n_ops
    assert priv.integrity.ok and priv.integrity.n_corrupted == 0
    assert priv.telemetry.device_matmuls > 0
    assert priv.telemetry.verify_ops == priv.telemetry.device_matmuls
    assert oracle.telemetry.device_matmuls == 0
    assert oracle.telemetry.trusted_matmuls > 0
    assert oracle.ring is None and oracle.integrity.n_ops == 0
    assert priv.ring["consumed"] == priv.decode_steps == 4
    assert priv.ring["refill_errors"] == 0
    assert priv.plan_digest == oracle.plan_digest
    # sampling at a temperature replays in the oracle too
    hot = G.private_generate(params, prompt, cfg, temperature=0.5, **kw)
    hot_oracle = G.private_generate(params, prompt, cfg, temperature=0.5,
                                    trusted=True, **kw)
    assert torch.equal(hot.tokens, hot_oracle.tokens)
    assert torch.equal(hot.logits, hot_oracle.logits)


def test_ring_fed_step_bit_exact_vs_live(smollm):
    cfg, _, _, params, prompt = smollm
    ex = _executor(cfg, params)
    key = prng.PRNGKey(3)
    S0 = prompt.shape[1]
    logits, caches, _ = ex.prefill_session(prompt, key, max_seq=S0 + 2)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    live_caches = A.KVCache(caches.k.clone(), caches.v.clone())
    ring = TokenSlotRing(ex.decode_cache(2), key, lo=S0, depth=2,
                         background=False)
    try:
        y_ring, c_ring, rep_ring = ex.decode_once(tok, caches, S0, key,
                                                  ring.take(S0))
    finally:
        ring.close()
    y_live, c_live, rep_live = ex.decode_once(tok, live_caches, S0, key)
    assert torch.equal(y_ring, y_live)
    assert torch.equal(c_ring.k, c_live.k) and torch.equal(c_ring.v, c_live.v)
    assert _report(rep_ring) == _report(rep_live)
    assert rep_ring.n_checked == 7 and rep_ring.ok


def test_decode_factors_bit_equal_to_reference_cache(smollm):
    """The port's decode cache (weights, records) and a session's token
    slot equal the reference's bit for bit."""
    cfg, jcfg, jp, params, _ = smollm
    pol = IG.IntegrityPolicy.full(k=2)
    cache = _executor(cfg, params).decode_cache(2)
    jex = JEx(jcfg, jp, "origami", integrity=JIG.IntegrityPolicy.full(k=2))
    jex.attach_decode_plan(max_steps=STEPS + 1)
    jcache = jex.decode_cache(2)
    assert len(cache.layers) == len(jcache.layers) == 7
    for lyr, jlyr in zip(cache.layers, jcache.layers):
        assert (lyr.t, lyr.d_in, lyr.d_out) == (jlyr.t, jlyr.d_in, jlyr.d_out)
        np.testing.assert_array_equal(lyr.w_q.numpy(), np.asarray(jlyr.w_q))
        assert lyr.policy == pol and not lyr.unblinded
    slot = cache.session_factors(prng.PRNGKey(4), step=7)
    jslot = jcache.session_factors(jax.random.PRNGKey(4), step=7)
    for e, je in zip(slot, jslot):
        for name in ("r", "u", "s", "ws"):
            np.testing.assert_array_equal(e[name].numpy(),
                                          np.asarray(je[name]))


@pytest.mark.parametrize("kind", KINDS)
def test_dishonest_device_detected(smollm, kind):
    cfg, _, _, params, prompt = smollm
    ex = _executor(cfg, params, fault=DishonestDevice(FaultSpec(kind)))
    res = G.private_generate(params, prompt, cfg, max_new_tokens=3,
                             session_key=prng.PRNGKey(4), executor=ex)
    rep = res.integrity
    assert torch.equal(rep.failed, rep.corrupted)
    assert rep.n_checked == rep.n_ops == 21
    if kind == "adaptive":      # corrupts only ops it predicts unchecked
        assert rep.n_corrupted == 0 and rep.ok
    else:
        assert rep.n_failed > 0 and not rep.ok


def test_sampled_private_generate_matches_reference(smollm):
    """Temperature 0.8: the same sampling and session keys draw the same
    tokens as the reference's private_generate (its jitted run)."""
    cfg, jcfg, jp, params, prompt = smollm
    kw = dict(max_new_tokens=4, temperature=0.8)
    want = JG.private_generate(
        jp, jnp.asarray(prompt), jcfg, integrity=JIG.IntegrityPolicy.full(k=2),
        session_key=jax.random.PRNGKey(SESSION), key=jax.random.PRNGKey(4),
        **kw)
    got = G.private_generate(
        params, prompt, cfg, integrity=IG.IntegrityPolicy.full(k=2),
        session_key=prng.PRNGKey(SESSION), key=prng.PRNGKey(4),
        device="cpu", **kw)
    np.testing.assert_array_equal(got.tokens.numpy(),
                                  np.asarray(want.tokens))
    assert got.integrity.n_checked == np.asarray(want.integrity.checked).sum()


def test_generate_origami_matches_reference(smollm):
    """The reference's tests/test_generate.py seeds (prompt from
    PRNGKey(1), cut to 2 tokens: the reference's eager steps are slow):
    the same tokens, and one count per runtime op (the reference counts
    one per traced call of its scanned step, which at the smoke config's
    one tier-1 layer is the same)."""
    cfg, jcfg, jp, params, _ = smollm
    prompt = jax.random.randint(jax.random.PRNGKey(1), (1, 2), 0,
                                jcfg.vocab_size)
    want = JG.generate_origami(jp, prompt, jcfg, max_new_tokens=2)
    got = G.generate_origami(params, np.asarray(prompt), cfg,
                             max_new_tokens=2, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    p = cfg.origami.tier1_layers
    steps = 2 + 2 - 1
    assert got.telemetry.calls == got.telemetry.device_matmuls == 7 * p * steps
    assert want.telemetry.calls == 7 * steps
    deep = G.generate_origami(params, np.asarray(prompt), cfg, partition=3,
                              max_new_tokens=2, device="cpu")
    assert deep.telemetry.calls == 7 * 3 * steps


def _cache(smollm, integrity=None):
    cfg, _, _, params, _ = smollm
    ex = OrigamiExecutor(cfg, params, "origami", integrity=integrity,
                         device="cpu")
    ex.attach_decode_plan(max_steps=256)
    return ex.decode_cache(2)


def test_ring_reuse_guard_and_refusal_after_close(smollm):
    ring = TokenSlotRing(_cache(smollm), prng.PRNGKey(5), lo=3, depth=4)
    try:
        first = ring.take(3)
        assert first and all("r" in e for e in first)
        with pytest.raises(SlotReuseError):
            ring.take(3)
        ring.take(7)                 # out of order is fine; reuse is not
        with pytest.raises(SlotReuseError):
            ring.take(7)
        assert ring.stats()["consumed"] == 2
    finally:
        ring.close()
    with pytest.raises(RuntimeError, match="closed"):
        ring.take(9)


def test_ring_refill_thread_prefetches_and_outrun_is_counted(smollm):
    cache = _cache(smollm)
    ring = TokenSlotRing(cache, prng.PRNGKey(6), lo=0, depth=3)
    try:
        deadline = time.monotonic() + 30
        while ring.ready() < 3 and time.monotonic() < deadline:
            time.sleep(0.01)
        assert ring.ready() == 3
        for t in range(12):
            assert len(ring.take(t)) == len(cache.layers)
        st = ring.stats()
        assert st["consumed"] == 12 and st["refill_errors"] == 0
        assert st["refilled"] + st["misses"] >= 12 - st["depth"]
    finally:
        ring.close()
    assert not any(t.name == "token-slot-refill" and t.is_alive()
                   for t in threading.enumerate())


def test_ring_take_waits_for_the_draw_in_flight(smollm):
    """A take of the token the refill thread is drawing waits for that draw
    instead of drawing the slot a second time (no miss, no stray copy left
    in the cache to evict a future slot)."""
    cache = _cache(smollm)
    started, release = threading.Event(), threading.Event()

    def hold(token):
        if token == 0:
            started.set()
            release.wait(30)

    key = prng.PRNGKey(7)
    ring = TokenSlotRing(cache, key, depth=1, refill_fault=hold)
    try:
        assert started.wait(30)
        threading.Timer(0.2, release.set).start()
        assert len(ring.take(0)) == len(cache.layers)
        st = ring.stats()
        assert st["misses"] == 0 and st["refill_errors"] == 0
        assert st["refilled"] >= 1
        assert not cache.prefetched(key, step=0)
    finally:
        release.set()
        ring.close()


def test_ring_refill_fault_contained(smollm):
    calls = {"n": 0}

    def fault(token):
        calls["n"] += 1
        raise RuntimeError("scripted refill failure")

    ring = TokenSlotRing(_cache(smollm), prng.PRNGKey(8), depth=2,
                         refill_fault=fault)
    try:
        for t in range(6):
            assert ring.take(t)
        st = ring.stats()
        assert st["consumed"] == 6 and st["misses"] == 6
        assert st["refill_errors"] >= 1 and calls["n"] >= 1
    finally:
        ring.close()
