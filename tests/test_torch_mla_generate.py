"""The port's private decode over Multi-head Latent Attention (MiniCPM3-4B
smoke config) and over a QKV bias (Qwen2.5-14B smoke config) against the
JAX reference on the CPU, as tests/test_torch_generate.py holds SmolLM's.

MLA caches the latent (no ``v``), and its absorbed token step reads
``wkv_b``'s weight directly in float32 (not through ``layers.dense``):
a tier-1 block blinds 8 ops in the prompt pass (``wq_a``, ``wq_b``,
``wkv_a``, ``wkv_b``, ``wo``, gate, up, down) and 7 in a token step
(``wkv_b`` drops out). Tier-1 field arithmetic is exact, so the first
blinded op's output is bit-equal across the frameworks, and so are the
integrity reports; the bf16 float layers around it differ by a few ulps,
so logits are held to atol 3e-2 * max|ref| (tests/test_torch_lm.py).
Tokens are compared teacher-forced, except ``generate_origami``'s, on a
seed whose top two logits stay apart by a pinned margin.

The reference's eager prompt pass and first token step take some 45 s
on one CPU worker (most of it compiling op by op), so one reference run
serves the module and the partition stays p = 1.
"""
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core.slalom as JSL  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core import integrity as JIG  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
import repro_torch.core.slalom as SL  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as IG  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402
from repro_torch.runtime.aot import CompileCache, EagerStep  # noqa: E402
from repro_torch.runtime.faults import DishonestDevice, FaultSpec  # noqa: E402
from repro_torch.runtime.sessions import TokenSlotRing  # noqa: E402

LOGIT_TOL = 3e-2
SESSION = 9
STEPS = 2                       # teacher-forced token steps held to the
                                # reference (its eager steps are slow)
PROMPT_OPS, STEP_OPS = 8, 7     # blinded ops of a tier-1 MLA block
# generate_origami at the reference test's seeds: the smallest gap between
# the top two logits of a picked token over the port's run, four bf16 ulps
# at |logit| ~2.8 (pinned: a change that moves it is a change of the
# function, and a smaller gap would make the pick a near-tie)
ORIGAMI_MARGIN = 0.0625


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


def _models(arch, biases=False):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    if biases:
        # the reference's init zeroes the QKV biases: draw them instead
        rng = np.random.default_rng(11)
        attn = dict(jp["blocks"]["attn"])
        for name in ("wq", "wk", "wv"):
            b = attn[name]["b"]
            attn[name] = {**attn[name], "b": jnp.asarray(
                0.5 * rng.normal(size=b.shape), b.dtype)}
        jp = {**jp, "blocks": {**jp["blocks"], "attn": attn}}
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    prompt = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (1, 6)).astype(np.int32)
    return cfg, jcfg, jp, params, prompt


@pytest.fixture(scope="module")
def minicpm():
    return _models("minicpm3_4b")


@pytest.fixture(scope="module")
def reference_run(minicpm):
    """The reference's eager prompt pass and STEPS greedy token steps
    under full(k=2): logits, tokens, reports, the first blinded op's
    output and the decode cache's weight material."""
    _, jcfg, jp, _, prompt = minicpm
    ex = JEx(jcfg, jp, "origami", integrity=JIG.IntegrityPolicy.full(k=2))
    ex.attach_decode_plan(max_steps=STEPS + 1)
    key = jax.random.PRNGKey(SESSION)
    S0 = prompt.shape[1]
    with _FirstFused(JSL) as rec:
        logits, caches, rep = ex.prefill_session(
            jnp.asarray(prompt), key, max_seq=S0 + STEPS + 1, jit=False)
    out = {"logits": [np.asarray(logits[:, -1], np.float32)],
           "reports": [_report(rep)], "first": rec.first, "tokens": [],
           "digest": ex.dplan.digest, "cache_k_shape": caches.k.shape,
           "cache_v": caches.v}
    for t in range(S0, S0 + STEPS):
        tok = jnp.argmax(logits[:, -1], axis=-1).astype(jnp.int32)[:, None]
        out["tokens"].append(np.asarray(tok))
        logits, caches, rep = ex.decode_once(tok, caches, t, key, None,
                                             jit=False)
        out["logits"].append(np.asarray(logits[:, -1], np.float32))
        out["reports"].append(_report(rep))
    cache = ex.decode_cache(prompt.shape[0])
    out["w_q"] = [np.asarray(lyr.w_q) for lyr in cache.layers]
    out["slot"] = [{n: np.asarray(e[n]) for n in ("r", "u", "s", "ws")}
                   for e in cache.session_factors(jax.random.PRNGKey(4),
                                                  step=7)]
    return out


def _executor(cfg, params, **kw):
    kw.setdefault("integrity", IG.IntegrityPolicy.full(k=2))
    ex = OrigamiExecutor(cfg, params, "origami", device="cpu", **kw)
    ex.attach_decode_plan(max_steps=STEPS + 1)
    return ex


def test_private_decode_matches_reference_eager_run(minicpm, reference_run):
    """The prompt pass and token steps, teacher-forced on the reference's
    tokens: first blinded op bit-equal, reports equal (8 ops in the
    prompt pass, 7 a token step), logits within the bf16 tolerance, the
    latent cache's layout the reference's."""
    cfg, _, _, params, prompt = minicpm
    ex = _executor(cfg, params)
    assert ex.dplan.digest == reference_run["digest"]
    key = prng.PRNGKey(SESSION)
    S0 = prompt.shape[1]
    with _FirstFused(SL) as rec:
        logits, caches, rep = ex.prefill_session(prompt, key,
                                                 max_seq=S0 + STEPS + 1)
    np.testing.assert_array_equal(rec.first, reference_run["first"])
    assert caches.v is None and reference_run["cache_v"] is None
    assert tuple(caches.k.shape) == tuple(reference_run["cache_k_shape"])
    got_logits, got_reports = [_f32(logits[:, -1])], [_report(rep)]
    for i, t in enumerate(range(S0, S0 + STEPS)):
        tok = torch.tensor(reference_run["tokens"][i], dtype=torch.long)
        logits, caches, rep = ex.decode_once(tok, caches, t, key)
        got_logits.append(_f32(logits[:, -1]))
        got_reports.append(_report(rep))
    assert got_reports == reference_run["reports"]
    p = cfg.origami.tier1_layers
    assert [len(r[0]) for r in got_reports] == [PROMPT_OPS * p] + \
        [STEP_OPS * p] * STEPS
    assert all(all(r[0]) and not any(r[1]) for r in got_reports)
    for got, want in zip(got_logits, reference_run["logits"]):
        _close(got, want)


def test_decode_records_leave_out_wkv_b(minicpm, reference_run):
    """The token step's records are one traced step's dense calls: wq_a,
    wq_b, wkv_a, wo, gate, up, down (the absorbed step reads wkv_b in the
    enclave); weights and a session's slot bit-equal to the reference's."""
    cfg, _, _, params, prompt = minicpm
    cache = _executor(cfg, params).decode_cache(prompt.shape[0])
    m, d, H = cfg.mla, cfg.d_model, cfg.num_heads
    qk = m.qk_nope_head_dim + m.qk_rope_head_dim
    want = [(d, m.q_lora_rank), (m.q_lora_rank, H * qk),
            (d, m.kv_lora_rank + m.qk_rope_head_dim), (H * m.v_head_dim, d),
            (d, cfg.d_ff), (d, cfg.d_ff), (cfg.d_ff, d)]
    assert [(lyr.d_in, lyr.d_out) for lyr in cache.layers] == want
    assert all(lyr.t == prompt.shape[0] for lyr in cache.layers)
    for lyr, w_q in zip(cache.layers, reference_run["w_q"]):
        np.testing.assert_array_equal(lyr.w_q.numpy(), w_q)
    slot = cache.session_factors(prng.PRNGKey(4), step=7)
    for e, je in zip(slot, reference_run["slot"]):
        for name in ("r", "u", "s", "ws"):
            np.testing.assert_array_equal(e[name].numpy(), je[name])


def test_private_generate_bit_exact_vs_trusted(minicpm):
    cfg, _, _, params, prompt = minicpm
    kw = dict(max_new_tokens=4, integrity=IG.IntegrityPolicy.full(k=2),
              session_key=prng.PRNGKey(SESSION), device="cpu")
    priv = G.private_generate(params, prompt, cfg, **kw)
    oracle = G.private_generate(params, prompt, cfg, trusted=True, **kw)
    assert torch.equal(priv.tokens, oracle.tokens)
    assert torch.equal(priv.logits, oracle.logits)
    assert priv.logits.shape == (1, 4, cfg.padded_vocab)
    p = cfg.origami.tier1_layers
    n_ops = PROMPT_OPS * p + STEP_OPS * p * priv.decode_steps
    assert priv.integrity.n_ops == priv.integrity.n_checked == n_ops
    assert priv.integrity.ok and priv.integrity.n_corrupted == 0
    assert priv.telemetry.device_matmuls == STEP_OPS * p
    assert oracle.telemetry.device_matmuls == 0
    assert oracle.telemetry.trusted_matmuls == STEP_OPS * p
    assert priv.ring["consumed"] == priv.decode_steps == 3
    assert priv.ring["refill_errors"] == 0


def test_ring_fed_step_bit_exact_vs_live(minicpm):
    cfg, _, _, params, prompt = minicpm
    ex = _executor(cfg, params)
    key = prng.PRNGKey(3)
    S0 = prompt.shape[1]
    logits, caches, _ = ex.prefill_session(prompt, key, max_seq=S0 + 2)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    live = A.KVCache(caches.k.clone(), None)
    ring = TokenSlotRing(ex.decode_cache(1), key, lo=S0, depth=2,
                         background=False)
    try:
        y_ring, c_ring, rep_ring = ex.decode_once(tok, caches, S0, key,
                                                  ring.take(S0))
    finally:
        ring.close()
    y_live, c_live, rep_live = ex.decode_once(tok, live, S0, key)
    assert torch.equal(y_ring, y_live)
    assert torch.equal(c_ring.k, c_live.k) and c_ring.v is c_live.v is None
    assert _report(rep_ring) == _report(rep_live)
    assert rep_ring.n_checked == STEP_OPS and rep_ring.ok


def test_compile_cache_step_equals_eager(minicpm):
    """``warm_decode_aot`` builds the trusted prompt pass and both token
    steps over the latent cache; on the CPU an executable is the eager
    step, and the slot-fed step through it equals ``jit=False``."""
    cfg, _, _, params, prompt = minicpm
    ex = _executor(cfg, params)
    cc = CompileCache()
    ex.attach_aot(cc)
    S0 = prompt.shape[1]
    assert ex.warm_decode_aot(1, S0, S0 + 2) == 3
    assert cc.stats()["compiles"] == 3
    assert all(isinstance(e, EagerStep) for e in ex._executables.values())
    key = prng.PRNGKey(5)
    logits, caches, _ = ex.prefill_session(prompt, key, max_seq=S0 + 2,
                                           jit=False)
    tok = torch.argmax(logits[:, -1:], dim=-1)
    slot = ex.decode_cache(1).session_factors(key, S0)
    a = ex.decode_once(tok, A.KVCache(caches.k.clone(), None), S0, key, slot,
                       jit=False)
    b = ex.decode_once(tok, A.KVCache(caches.k.clone(), None), S0, key, slot)
    assert torch.equal(a[0], b[0]) and torch.equal(a[1].k, b[1].k)
    assert b[1].v is None and _report(a[2]) == _report(b[2])
    assert cc.stats()["compiles"] == 3 and cc.stats()["exec_fallbacks"] == 0


def test_dishonest_device_detected(minicpm):
    cfg, _, _, params, prompt = minicpm
    ex = _executor(cfg, params, fault=DishonestDevice(FaultSpec("bit_flip")))
    res = G.private_generate(params, prompt, cfg, max_new_tokens=3,
                             session_key=prng.PRNGKey(4), executor=ex)
    rep = res.integrity
    assert torch.equal(rep.failed, rep.corrupted)
    p = cfg.origami.tier1_layers
    assert rep.n_checked == rep.n_ops == (PROMPT_OPS + 2 * STEP_OPS) * p
    assert rep.n_failed == rep.n_ops and not rep.ok


def test_generate_origami_matches_reference(minicpm, monkeypatch):
    """The reference's tests/test_generate.py seeds (prompt from
    PRNGKey(1), cut to 2 tokens): the same tokens, 7 counts a step (the
    token step's ops), and no near-tie on the port's picks."""
    cfg, jcfg, jp, params, _ = minicpm
    prompt = jax.random.randint(jax.random.PRNGKey(1), (1, 2), 0,
                                jcfg.vocab_size)
    want = JG.generate_origami(jp, prompt, jcfg, max_new_tokens=2)
    seen = []
    sample = G._sample

    def recording(logits, *a):
        seen.append(logits.to(torch.float32))
        return sample(logits, *a)

    monkeypatch.setattr(G, "_sample", recording)
    got = G.generate_origami(params, np.asarray(prompt), cfg,
                             max_new_tokens=2, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    steps = 2 + 2 - 1
    p = cfg.origami.tier1_layers
    assert got.telemetry.calls == got.telemetry.device_matmuls == \
        STEP_OPS * p * steps
    assert want.telemetry.calls == STEP_OPS * steps
    picks = torch.stack(seen[1:])[..., :cfg.vocab_size]  # the new tokens'
    top2 = torch.topk(picks, 2, dim=-1).values
    assert float((top2[..., 0] - top2[..., 1]).min()) >= ORIGAMI_MARGIN


@pytest.fixture(scope="module")
def qwen_biased():
    return _models("qwen2_5_14b", biases=True)


def test_qkv_bias_prompt_pass_matches_reference(qwen_biased):
    """Qwen2.5 with non-zero QKV biases in both trees: the private prompt
    pass against the reference's eager run (the first blinded op
    bit-equal, the reports equal, the logits within the bf16 tolerance),
    and private == trusted bit for bit."""
    cfg, jcfg, jp, params, prompt = qwen_biased
    b = params["blocks"]["attn"]["wk"]["b"]
    assert b.dtype == torch.bfloat16 and float(b.abs().max()) > 0.5
    S0 = prompt.shape[1]
    jex = JEx(jcfg, jp, "origami", integrity=JIG.IntegrityPolicy.full(k=2))
    jex.attach_decode_plan(max_steps=2)
    with _FirstFused(JSL) as jrec:
        jlogits, _, jrep = jex.prefill_session(
            jnp.asarray(prompt), jax.random.PRNGKey(SESSION),
            max_seq=S0 + 2, jit=False)
    ex = _executor(cfg, params)
    key = prng.PRNGKey(SESSION)
    with _FirstFused(SL) as rec:
        logits, _, rep = ex.prefill_session(prompt, key, max_seq=S0 + 2)
    np.testing.assert_array_equal(rec.first, jrec.first)
    assert _report(rep) == _report(jrep)
    assert rep.n_checked == 7 * cfg.origami.tier1_layers and rep.ok
    _close(_f32(logits[:, -1]), np.asarray(jlogits[:, -1], np.float32))
    trusted, _, _ = ex.prefill_session(prompt, key, max_seq=S0 + 2,
                                       trusted=True)
    assert torch.equal(logits, trusted)
