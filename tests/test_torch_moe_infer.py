"""The port's mixture-of-experts LM paths (Qwen3-MoE and Arctic smoke
configs) against the JAX reference on the CPU: the per-op blinded LM
forward, ``generate_origami``, open ``generate``, the engine's sealed LM
requests, and the refusal of the decode-plan paths.

The reference has no per-op MoE forward: its LM forward scans the blocks
(one pad per traced projection, no checks; pinned below), and its per-op
prompt pass (``prefill_session``) needs a decode plan, which refuses MoE.
So the port's counts are held to the per-op formula: 4 ops a tier-1
block (the attention projections; the experts and the router run in the
enclave, as in the reference), 7 for Arctic (its dense-residual FFN goes
through ``layers.dense`` too). Its first blinded op (key ``(session, 0,
0)`` in both) is bit-equal to the reference's first fused call of
``infer(jit=False)`` at p = 1, where the scan holds one block. Blinding
cancels exactly, so blinded logits equal trusted ones bit for bit;
against the reference's float layers (bf16) logits are held to atol
3e-2 * max|ref|, the tolerance of tests/test_torch_generate.py, and open
generation is compared teacher-forced. ``generate_origami``'s whole
stream is compared on a seed whose greedy picks lead by a pinned margin,
so a near-tie can neither pass as a fault nor hide one.
"""
import dataclasses

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
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import aot as AOT  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402
from repro_torch.runtime.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)

LOGIT_TOL = 3e-2
SESSION = 11
PINNED_P = 2          # the reference's scanned counts are pinned at p = 2
# ops a tier-1 block: q, k, v, o; Arctic adds its dense residual's three
OPS_PER_BLOCK = {"qwen3_moe_235b": 4, "arctic_480b": 7}
# generate_origami's stream: a prompt from PRNGKey(ORIGAMI_SEED) of
# ORIGAMI_PROMPT tokens, ORIGAMI_NEW new ones; at this seed every greedy
# pick of the reference's float forward leads the runner-up by more than
# ORIGAMI_MARGIN x max|logits| (0.085 on Qwen3-MoE, 0.177 on Arctic),
# above the bf16 tolerance
ORIGAMI_SEED, ORIGAMI_PROMPT, ORIGAMI_NEW = 2, 2, 2
ORIGAMI_MARGIN = 0.06
TIMEOUT = 120


class _FirstFusedCallback:
    """Records the output of the reference's first fused blinded matmul of
    a run. Its forward scans the blocks, so the op runs traced: a debug
    callback hands the value over when it is computed; traced call 0 is
    block 0's first projection."""

    def __init__(self):
        self.inner = JSL.fused_blinded_matmul
        self.calls, self.first = 0, None

    def __call__(self, *a, **kw):
        y = self.inner(*a, **kw)
        if self.calls == 0:
            jax.debug.callback(self._store, y)
        self.calls += 1
        return y

    def _store(self, v):
        if self.first is None:
            self.first = np.array(v, np.float32)

    def __enter__(self):
        JSL.fused_blinded_matmul = self
        return self

    def __exit__(self, *exc):
        JSL.fused_blinded_matmul = self.inner


class _FirstFused:
    """Records the output of the port's first fused blinded matmul."""

    def __init__(self):
        self.inner, self.first = SL.fused_blinded_matmul, None

    def __call__(self, *a, **kw):
        y = self.inner(*a, **kw)
        if self.first is None:
            self.first = np.array(y, np.float32)
        return y

    def __enter__(self):
        SL.fused_blinded_matmul = self
        return self

    def __exit__(self, *exc):
        SL.fused_blinded_matmul = self.inner


def _f32(t):
    return t.to(torch.float32).numpy()


def _close(got, want):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


@pytest.fixture(scope="module", params=["qwen3_moe_235b", "arctic_480b"])
def moe_lm(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    return arch, cfg, jcfg, jp, params, tokens


@pytest.fixture(scope="module")
def reference(moe_lm):
    """The reference's jitted LM forward at p = 2 under full(k=2), and the
    first fused op of its eager (``jit=False``) forward at p = 1."""
    _, _, jcfg, jp, _, tokens = moe_lm
    ex = JEx(jcfg, jp, "origami", partition=PINNED_P,
             integrity=JIG.IntegrityPolicy.full(k=2))
    res = ex.infer({"tokens": jnp.asarray(tokens)},
                   session_key=jax.random.PRNGKey(SESSION))
    out = {"logits": np.asarray(res.logits, np.float32),
           "n_ops": res.integrity.n_ops,
           "telemetry": dataclasses.asdict(ex.telemetry_blinded)}
    eager = JEx(jcfg, jp, "origami", partition=1,
                integrity=JIG.IntegrityPolicy.full(k=2))
    with _FirstFusedCallback() as rec:
        eager.infer({"tokens": jnp.asarray(tokens)},
                    session_key=jax.random.PRNGKey(SESSION), jit=False)
        jax.effects_barrier()
    out["first"] = rec.first
    return out


def _executor(cfg, params, partition, **kw):
    kw.setdefault("integrity", IG.IntegrityPolicy.full(k=2))
    return OrigamiExecutor(cfg, params, "origami", partition, device="cpu",
                           **kw)


def test_reference_forward_scans_its_blinded_blocks(moe_lm, reference):
    """The reference's scanned forward: two blinded blocks count as one
    traced call a projection, and none is checked."""
    arch = moe_lm[0]
    tele = reference["telemetry"]
    assert tele["calls"] == tele["device_matmuls"] == OPS_PER_BLOCK[arch]
    assert tele["verify_ops"] == 0 and reference["n_ops"] == 0


@pytest.mark.parametrize("partition", [1, PINNED_P])
def test_moe_infer_blinded_equals_trusted(moe_lm, partition):
    arch, cfg, _, _, params, tokens = moe_lm
    ex = _executor(cfg, params, partition)
    key = prng.PRNGKey(SESSION)
    blinded = ex.infer({"tokens": tokens}, key)
    trusted = ex.infer({"tokens": tokens}, key, trusted=True)
    assert blinded.logits.shape == (2, 8, cfg.padded_vocab)
    assert torch.equal(blinded.logits, trusted.logits)
    n_ops = OPS_PER_BLOCK[arch] * partition
    rep, tele = blinded.integrity, blinded.telemetry
    assert rep.n_ops == rep.n_checked == n_ops and rep.ok
    assert tele.calls == tele.device_matmuls == tele.verify_ops == n_ops
    assert trusted.integrity.n_ops == 0
    assert trusted.telemetry.trusted_matmuls == n_ops


def test_moe_infer_matches_reference_logits(moe_lm, reference):
    _, cfg, jcfg, jp, params, tokens = moe_lm
    ex = _executor(cfg, params, PINNED_P)
    _close(_f32(ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION)).logits),
           reference["logits"])
    # the float oracle agrees with the reference's float forward too
    _close(_f32(ex.reference({"tokens": tokens})),
           JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg).logits)


def test_first_blinded_op_bit_equal_to_reference(moe_lm, reference):
    _, cfg, _, _, params, tokens = moe_lm
    ex = _executor(cfg, params, 1)
    with _FirstFused() as rec:
        ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION))
    assert reference["first"] is not None
    np.testing.assert_array_equal(rec.first, reference["first"])


def test_moe_infer_executables(moe_lm):
    """Under a CompileCache the trusted forward runs an executable (a CUDA
    graph on the card) and the blinded one stays eager; both bit-equal to
    the eager trusted step."""
    _, cfg, _, _, params, tokens = moe_lm
    ex = _executor(cfg, params, PINNED_P)
    ex.attach_aot(AOT.CompileCache())
    key = prng.PRNGKey(SESSION)
    assert ex._graphable(True) and not ex._graphable(False)
    trusted = ex.infer({"tokens": tokens}, key, trusted=True)
    blinded = ex.infer({"tokens": tokens}, key)
    eager = ex.infer({"tokens": tokens}, key, trusted=True, jit=False)
    assert ex._aot.counters["compiles"] == 1
    assert torch.equal(trusted.logits, eager.logits)
    assert torch.equal(blinded.logits, eager.logits)


def test_decode_plan_paths_refuse_moe(moe_lm):
    """private_generate, attach_decode_plan and GenerateExecutor raise
    ScanExclusion with the reference's reason."""
    _, cfg, jcfg, jp, params, tokens = moe_lm
    with pytest.raises(JPL.ScanExclusion) as want:
        JG.private_generate(jp, jnp.asarray(tokens), jcfg, max_new_tokens=2)
    reason = PL._DECODE_EXCLUSIONS["moe"]
    assert reason == JPL._DECODE_EXCLUSIONS["moe"] and reason in str(
        want.value)
    ex = _executor(cfg, params, 1)
    for call in (lambda: ex.attach_decode_plan(),
                 lambda: G.private_generate(params, tokens, cfg,
                                            max_new_tokens=2, device="cpu"),
                 lambda: G.GenerateExecutor(cfg, params, prompt_len=8,
                                            max_new_tokens=2, device="cpu")):
        with pytest.raises(PL.ScanExclusion) as got:
            call()
        assert str(want.value).startswith(str(got.value))
    assert ex.dplan is None


def test_generate_origami_matches_reference(moe_lm):
    """One telemetry count per runtime op, and on Qwen3-MoE the same tokens
    as the reference's stream, at a seed whose picks lead by the pinned
    margin (the reference counts one per traced call of its scanned step,
    which at the smoke configs' one tier-1 block is the same). The
    reference's eager steps take ~13 s a stream, so Arctic's stream is
    held to the port's own float forward instead: the same picks."""
    arch, cfg, jcfg, jp, params, _ = moe_lm
    prompt = jax.random.randint(jax.random.PRNGKey(ORIGAMI_SEED),
                                (1, ORIGAMI_PROMPT), 0, jcfg.vocab_size)
    got = G.generate_origami(params, np.asarray(prompt), cfg,
                             max_new_tokens=ORIGAMI_NEW, device="cpu")
    steps = ORIGAMI_PROMPT + ORIGAMI_NEW - 1
    n = OPS_PER_BLOCK[arch]
    assert got.telemetry.calls == got.telemetry.device_matmuls == n * steps
    deep = G.generate_origami(params, np.asarray(prompt), cfg, partition=2,
                              max_new_tokens=ORIGAMI_NEW, device="cpu")
    assert deep.telemetry.calls == n * 2 * steps
    stream = jnp.asarray(got.tokens.numpy())
    logits = np.asarray(JM.forward(jp, {"tokens": stream}, jcfg).logits,
                        np.float32)[0, ORIGAMI_PROMPT - 1:-1,
                                    :jcfg.vocab_size]
    top = -np.sort(-logits, axis=-1)
    margin = (top[:, 0] - top[:, 1]).min() / np.abs(logits).max()
    assert margin > ORIGAMI_MARGIN, margin
    np.testing.assert_array_equal(np.argmax(logits, axis=-1),
                                  got.tokens.numpy()[0, ORIGAMI_PROMPT:])
    if arch == "qwen3_moe_235b":
        want = JG.generate_origami(jp, prompt, jcfg,
                                   max_new_tokens=ORIGAMI_NEW)
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))
        assert want.telemetry.calls == n * steps


def test_open_generate_teacher_forced(moe_lm):
    """Open generate, its stream fed back to both packages' prefill and
    token steps (the functions the reference's generate runs): each step's
    logits within the bf16 tolerance, and the port's tokens the greedy
    picks of its own steps."""
    _, cfg, jcfg, jp, params, tokens = moe_lm
    new = 3
    prompt = tokens[:, :4]
    out = G.generate(params, prompt, cfg, max_new_tokens=new, device="cpu")
    stream = out.tokens.numpy()
    assert stream.shape == (2, 4 + new)
    np.testing.assert_array_equal(stream[:, :4], prompt)
    total = 4 + new
    with torch.no_grad():
        logits, caches = M.prefill(params, {"tokens": torch.from_numpy(
            prompt).long()}, cfg, max_seq=total)
        got = [logits[:, -1]]
        for t in range(4, total - 1):
            logits, caches = M.decode_step(
                params, torch.from_numpy(stream[:, t:t + 1]).long(), caches,
                t, cfg)
            got.append(logits[:, 0])
    jlogits, jcaches = JM.prefill(jp, {"tokens": jnp.asarray(prompt)}, jcfg,
                                  max_seq=total)
    want = [jlogits[:, -1]]
    for t in range(4, total - 1):
        jlogits, jcaches = JM.decode_step(
            jp, jnp.asarray(stream[:, t:t + 1]), jcaches, jnp.int32(t), jcfg)
        want.append(jlogits[:, 0])
    for i, (g, w) in enumerate(zip(got, want)):
        _close(_f32(g), w)
        picks = torch.argmax(g[:, :cfg.vocab_size].float(), dim=-1).numpy()
        np.testing.assert_array_equal(picks, stream[:, 4 + i])


def _lm_request(cfg, rid, seq, rng):
    toks = rng.integers(0, cfg.vocab_size, size=(seq,)).astype(np.float32)
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, toks, rid)
    return (Request(rid=rid, box=box, shape=toks.shape, session_key=key),
            key, toks)


def test_engine_serves_sealed_moe_requests(moe_lm, rng):
    """A MoE LM in the engine (``input_key="tokens"``): two sequence
    lengths in two buckets, each response opening to (S, padded vocab),
    bit-equal to the trusted forward of its padded batch."""
    _, cfg, _, _, params, _ = moe_lm
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=150.0))
    entry = engine.register_model("moe", cfg, params, input_key="tokens",
                                  input_dtype="int32",
                                  integrity=IG.IntegrityPolicy.full(k=2),
                                  device="cpu")
    reqs = ([_lm_request(cfg, 30 + i, 8, rng) for i in range(2)]
            + [_lm_request(cfg, 40, 16, rng)])
    try:
        futs = [engine.submit("moe", r) for r, _, _ in reqs]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        assert all(r.ok for r in got), [r.error for r in got]
        assert engine.stats.batches >= 2
    finally:
        engine.close()
    ex = entry.executor
    short = ex.infer({"tokens": np.stack([t for _, _, t in reqs[:2]])},
                     trusted=True).logits.to(torch.float32)
    long_ = ex.infer({"tokens": reqs[2][2][None]},
                     trusted=True).logits.to(torch.float32)
    for (_, key, toks), resp, w in zip(reqs, got,
                                       [short[0], short[1], long_[0]]):
        lg = PrivateInferenceServer.client_open(
            key, resp.box, (len(toks), cfg.padded_vocab))
        np.testing.assert_array_equal(lg, w.numpy())


class _Routes:
    """The router logits and experts of every ``moe._route`` call while
    entered, one (tokens, E) and one (tokens, k) tensor a call (a forward
    routes once a block)."""

    def __init__(self):
        from repro_torch.models import moe
        self.module, self.inner = moe, moe._route
        self.logits, self.experts = [], []

    def __call__(self, p, x, cfg):
        w, e, aux = self.inner(p, x, cfg)
        self.logits.append((x.float() @ p["router"]["w"]).reshape(
            -1, cfg.moe.num_experts))
        self.experts.append(e.reshape(-1, e.shape[-1]))
        return w, e, aux

    def __enter__(self):
        self.module._route = self
        return self

    def __exit__(self, *exc):
        self.module._route = self.inner


def test_tier1_quantization_flips_near_tied_routing():
    """Qwen3-MoE's routing (128 experts, top-8) at width 256, 6 blocks, p =
    4: the tier-1 ops' 8-bit activations (the protocol's quantization, the
    same arithmetic as the reference's, op for op) move the block-1 router
    logits by a few percent, and the 8th and 9th choices lie so close that
    many token rows route differently from the float forward, the rule
    rather than the exception; a flip in block 1 keeps most of the row's
    experts (a near-tie), and the trusted recompute routes exactly as the
    blinded run. (Groups of 4 tokens at capacity 8 drop nothing here; at
    4 x 1024 tokens a flip also moves its group's drops, PERF.md.)"""
    full = get_config("qwen3_moe_235b")
    cfg = full.replace(num_layers=6, d_model=256, num_heads=4,
                       num_kv_heads=2, head_dim=64, vocab_size=1024,
                       moe=dataclasses.replace(full.moe, d_ff_expert=64))
    params = M.init_params(cfg, 0, device="cpu")
    tokens = np.random.default_rng(60).integers(0, cfg.vocab_size, (2, 64))
    key = prng.PRNGKey(SESSION)
    ex = _executor(cfg, params, 4)
    runs = {}
    for name, call in (
            ("blinded", lambda: ex.infer({"tokens": tokens}, key)),
            ("trusted", lambda: ex.infer({"tokens": tokens}, key,
                                         trusted=True)),
            ("float", lambda: OrigamiExecutor(
                cfg, params, "split", 4, device="cpu").infer(
                    {"tokens": tokens}))):
        with _Routes() as rec:
            call()
        runs[name] = rec
    for b, t in zip(runs["blinded"].experts, runs["trusted"].experts):
        assert torch.equal(b, t)
    z_b, z_f = runs["blinded"].logits[0], runs["float"].logits[0]
    assert float((z_b - z_f).abs().max() / z_f.abs().max()) < 0.25
    differ = torch.zeros(128, dtype=torch.bool)
    for i, (b, f) in enumerate(zip(runs["blinded"].experts[:4],
                                   runs["float"].experts[:4])):
        kept = (b[:, :, None] == f[:, None, :]).any(-1).sum(-1)
        if i == 0:
            assert int(kept.min()) >= 5, kept.min()
        differ |= kept < 8
    assert differ.float().mean() > 0.1, differ.float().mean()
