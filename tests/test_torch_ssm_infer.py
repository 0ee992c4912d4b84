"""The port's hybrid (Zamba2) and SSM (xLSTM) families end to end against
the JAX reference on the CPU, at the smoke configs, with the reference's
``init_params`` carried over by ``params_from_numpy``: the LM forward,
decode against forward, open ``generate`` with its recurrent prompt pass,
the per-op blinded LM forward ``infer``, one sealed engine request, and
the refusals of the private decode paths.

The reference has no per-op forward for these families: its blocks run
under ``lax.scan``, so each projection of a scanned tier-1 segment is
traced once, blinded with one pad, and its check is dropped (ROADMAP
Queue 3). Its counts are pinned below (at p = 1: 2 calls for Zamba2's
``in_proj``/``out_proj``, 4 for xLSTM's ``w_up``, gates and ``w_down``,
0 checked). The port walks the blocks one by one and draws a fresh pad
for each runtime op: 2 ops a tier-1 Mamba2 block, 4 a tier-1 mLSTM block,
6 for Zamba2's shared attention block when a tier-1 range completes its
group, 3 for an sLSTM block, every one checked. Its first blinded op (key
``(session, 0, 0)`` in both) is bit-equal to the reference's first fused
call of ``infer(jit=False)`` at p = 1, where the scan holds one block.

Tolerances. In float32 (the smoke configs with ``dtype="float32"``) the
port's logits are held to the reference's at 1e-4 x max|ref|, and open
generation to the reference's tokens. In bf16, the configs' dtype, the
two packages round at different points from the first block on: XLA:CPU's
exp and logistic are polynomial approximations, so its bf16 silu differs
from torch's by an ulp on some elements, and matmuls accumulate in other
orders; the recurrences carry these ulps from block to block (a 1% gap
after the first Mamba2 block of the smoke Zamba2, 4.5-6.5% of the logits'
norm after its 6 blocks). So bf16 logits are held at a relative
Frobenius error of 0.1, and those of the blinded forward at 0.2: its 8-bit
tier-1 quantization turns an ulp that crosses a rounding boundary into a
step of 1/256 of the scale (the measured gap: 0.12 on Zamba2). The
reference's jitted prompt loop contracts multiply-adds into FMAs (ROADMAP
Queue 3), so the prompt pass's float32 logits are held to it at 1e-3 x
max|ref| (measured 1.8e-4). Decode is held to the teacher-forced forward at
the reference's 0.06 (tests/test_ssm.py); the blinding cancels exactly,
so blinded logits equal trusted ones bit for bit.
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
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as IG  # noqa: E402
from repro_torch.core import plan as PL  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402
from repro_torch.runtime.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)

F32_TOL = 1e-4
BF16_REL = 0.1
INFER_REL = 0.2
JIT_TOL = 1e-3
DECODE_TOL = 0.06
SESSION = 11
TIMEOUT = 120
# blinded ops a tier-1 block: Zamba2's in_proj and out_proj; xLSTM's
# mLSTM w_up, w_igate, w_fgate and w_down
OPS_PER_BLOCK = {"zamba2_1_2b": 2, "xlstm_1_3b": 4}
SHARED_OPS = 6          # Zamba2's shared block: q, k, v, o, w_up, w_down
SLSTM_OPS = 3           # an sLSTM block: w_gates, w_up, w_down
# the reference's scanned forward at p = 1: one traced call a projection
REF_CALLS = {"zamba2_1_2b": 2, "xlstm_1_3b": 4}
# open generate: the prompt and the new tokens
GEN_PROMPT, GEN_NEW = 6, 3


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


def _close(got, want, tol=F32_TOL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _rel(got, want, bound=BF16_REL):
    got, want = np.asarray(got, np.float32), np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    rel = np.linalg.norm(got - want) / np.linalg.norm(want)
    assert rel < bound, rel


def _carried(cfg, jcfg, seed=0):
    jp = JM.init_params(jcfg, jax.random.PRNGKey(seed))
    return jp, M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")


@pytest.fixture(scope="module", params=["zamba2_1_2b", "xlstm_1_3b"])
def f32_lm(request):
    """The smoke config in float32 and the reference's float32 weights."""
    arch = request.param
    cfg = get_smoke(arch).replace(dtype="float32")
    jcfg = jget_smoke(arch).replace(dtype="float32")
    jp, params = _carried(cfg, jcfg)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return arch, cfg, jcfg, jp, params, tokens


@pytest.fixture(scope="module", params=["zamba2_1_2b", "xlstm_1_3b"])
def ssm_lm(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jp, params = _carried(cfg, jcfg)
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 32)).astype(np.int32)
    return arch, cfg, jcfg, jp, params, tokens


@pytest.fixture(scope="module")
def reference(ssm_lm):
    """The reference's float forward, and its eager (``jit=False``) LM
    forward at p = 1 under full(k=2) with the first fused op recorded."""
    _, _, jcfg, jp, _, tokens = ssm_lm
    batch = {"tokens": jnp.asarray(tokens)}
    ex = JEx(jcfg, jp, "origami", partition=1,
             integrity=JIG.IntegrityPolicy.full(k=2))
    with _FirstFusedCallback() as rec:
        res = ex.infer(batch, session_key=jax.random.PRNGKey(SESSION),
                       jit=False)
        jax.effects_barrier()
    return {"forward": np.asarray(JM.forward(jp, batch, jcfg).logits,
                                  np.float32),
            "logits": np.asarray(res.logits, np.float32),
            "n_ops": res.integrity.n_ops,
            "telemetry": dataclasses.asdict(ex.telemetry_blinded),
            "first": rec.first}


def _executor(cfg, params, partition, **kw):
    kw.setdefault("integrity", IG.IntegrityPolicy.full(k=2))
    return OrigamiExecutor(cfg, params, "origami", partition, device="cpu",
                           **kw)


def _ops(arch, cfg, partition):
    """The port's blinded ops of a tier-1 range [0, partition)."""
    if arch == "zamba2_1_2b":
        e = cfg.hybrid_attn_every
        return (OPS_PER_BLOCK[arch] * partition
                + SHARED_OPS * min(partition // e, cfg.num_layers // e))
    e = cfg.ssm.slstm_every
    n_slstm = partition // e
    return (OPS_PER_BLOCK[arch] * (partition - n_slstm)
            + SLSTM_OPS * n_slstm)


def test_defs_nest_as_the_reference(ssm_lm):
    """``lm_defs`` stacks the blocks twice as the reference does, and the
    carried weights land in the port's tree in their definitions' dtypes
    (Mamba2's A_log, D and dt_bias float32)."""
    arch, cfg, jcfg, jp, params, _ = ssm_lm
    defs = M.lm_defs(cfg)
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == len(jax.tree.leaves(
        jax.tree.map(lambda t: t, params)))
    for path, leaf in flat:
        node, d = params, defs
        for k in path:
            node, d = node[k.key], d[k.key]
        assert tuple(node.shape) == leaf.shape, path
        assert (node.dtype == torch.float32) == (leaf.dtype == jnp.float32)
        np.testing.assert_array_equal(_f32(node), np.asarray(leaf,
                                                             np.float32))
    if arch == "zamba2_1_2b":
        e = cfg.hybrid_attn_every
        lead = (cfg.num_layers // e, e)
        assert tuple(params["mamba_main"]["mamba"]["A_log"].shape) == lead + (
            cfg.ssm.num_ssm_heads,)
        assert "mamba_tail" not in params and "shared_attn" in params
    else:
        e = cfg.ssm.slstm_every
        lead = (cfg.num_layers // e, e - 1)
        assert tuple(params["mlstm_groups"]["mlstm"]["wq"].shape[:2]) == lead
        assert tuple(params["slstm_groups"]["slstm"]["r_gates"].shape[:1]) \
            == (cfg.num_layers // e,)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg)


def _forward(params, tokens, cfg):
    with torch.no_grad():
        return M.forward(params, {"tokens": torch.from_numpy(tokens).long()},
                         cfg).logits


def test_forward_matches_reference(ssm_lm, reference):
    """bf16, the configs' dtype: within the relative bound."""
    _, cfg, _, _, params, tokens = ssm_lm
    got = _forward(params, tokens, cfg)
    assert got.shape == (2, 32, cfg.padded_vocab)
    _rel(_f32(got), reference["forward"])


def test_forward_matches_reference_in_float32(f32_lm):
    _, cfg, jcfg, jp, params, tokens = f32_lm
    want = JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg).logits
    _close(_f32(_forward(params, tokens, cfg)), want)


def test_decode_matches_forward(ssm_lm):
    """Step by step through ``decode_step`` (the state updated in place)
    against the teacher-forced forward, at the reference's bound (its test
    holds its own decode to its own forward, as this one does)."""
    _, cfg, _, _, params, tokens = ssm_lm
    T = 16
    caches = M.init_caches(cfg, 2, T, device="cpu")
    outs = []
    with torch.no_grad():
        for t in range(T):
            logits, caches = M.decode_step(
                params, torch.from_numpy(tokens[:, t:t + 1]).long(), caches,
                t, cfg)
            outs.append(_f32(logits[:, 0]))
    full = _f32(_forward(params, tokens[:, :T], cfg))
    np.testing.assert_allclose(np.stack(outs, 1), full, rtol=DECODE_TOL,
                               atol=DECODE_TOL)


def test_open_generate_matches_reference(f32_lm):
    """Open generate with the recurrent prompt pass (float32): the
    reference's tokens on the same prompt, and the prompt pass's logits
    those of the reference's jitted prompt loop."""
    _, cfg, jcfg, jp, params, tokens = f32_lm
    prompt = tokens[:, :GEN_PROMPT]
    got = G.generate(params, prompt, cfg, max_new_tokens=GEN_NEW,
                     device="cpu")
    want = JG.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=GEN_NEW)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    with torch.no_grad():
        logits, _ = G.prefill_recurrent(
            params, torch.from_numpy(prompt).long(),
            M.init_caches(cfg, 2, GEN_PROMPT, device="cpu"), cfg)
    jlogits, _ = JG._jit_prefill_recurrent(jcfg, GEN_PROMPT)(
        jp, jnp.asarray(prompt), JM.init_caches(jcfg, 2, GEN_PROMPT))
    _close(_f32(logits), jlogits, JIT_TOL)


def test_reference_forward_scans_its_blinded_blocks(ssm_lm, reference):
    """The reference's scanned forward at p = 1: one traced call a
    projection, none checked (ROADMAP Queue 3)."""
    arch = ssm_lm[0]
    tele = reference["telemetry"]
    assert tele["calls"] == tele["device_matmuls"] == REF_CALLS[arch]
    assert tele["verify_ops"] == 0 and reference["n_ops"] == 0


@pytest.mark.parametrize("partition", [1, 3, 4])
def test_infer_blinded_equals_trusted(ssm_lm, partition):
    """Every tier-1 op checked and passing, blinded == trusted bit for bit.
    p = 3 covers Zamba2's first group (its shared block blinded); p = 4
    covers xLSTM's first sLSTM block."""
    arch, cfg, _, _, params, tokens = ssm_lm
    ex = _executor(cfg, params, partition)
    key = prng.PRNGKey(SESSION)
    blinded = ex.infer({"tokens": tokens}, key)
    trusted = ex.infer({"tokens": tokens}, key, trusted=True)
    assert blinded.logits.shape == (2, 32, cfg.padded_vocab)
    assert torch.equal(blinded.logits, trusted.logits)
    n_ops = _ops(arch, cfg, partition)
    rep, tele = blinded.integrity, blinded.telemetry
    assert rep.n_ops == rep.n_checked == n_ops and rep.ok
    assert tele.calls == tele.device_matmuls == tele.verify_ops == n_ops
    assert trusted.integrity.n_ops == 0
    assert trusted.telemetry.trusted_matmuls == n_ops


def test_infer_counts_2p_and_4p_at_the_configs_partition():
    """At the published configs' p = 3 the port counts 2p ops for Zamba2
    and 4p for xLSTM (the reference: 0 checked; pinned above)."""
    for arch in ("zamba2_1_2b", "xlstm_1_3b"):
        from repro_torch.configs import get_config
        full = get_config(arch)
        p = full.origami.tier1_layers
        assert p == 3
        assert _ops(arch, full, p) == OPS_PER_BLOCK[arch] * p


def test_infer_matches_reference_logits(ssm_lm, reference):
    _, cfg, _, _, params, tokens = ssm_lm
    ex = _executor(cfg, params, 1)
    _rel(_f32(ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION)).logits),
         reference["logits"], INFER_REL)
    _rel(_f32(ex.reference({"tokens": tokens})), reference["forward"])


def test_first_blinded_op_bit_equal_to_reference(ssm_lm, reference):
    _, cfg, _, _, params, tokens = ssm_lm
    ex = _executor(cfg, params, 1)
    with _FirstFused() as rec:
        ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION))
    assert reference["first"] is not None
    np.testing.assert_array_equal(rec.first, reference["first"])


def test_bit_flip_caught_op_by_op(ssm_lm):
    from repro_torch.runtime.faults import DishonestDevice, FaultSpec
    arch, cfg, _, _, params, tokens = ssm_lm
    ex = _executor(cfg, params, 2,
                   fault=DishonestDevice(FaultSpec("bit_flip")))
    rep = ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION)).integrity
    assert torch.equal(rep.failed, rep.corrupted)
    assert rep.n_failed == rep.n_corrupted == _ops(arch, cfg, 2)


def test_zamba2_with_a_mamba_tail():
    """7 layers at every 3: two groups and a tail of one block (float32);
    forward against the reference, decode against forward, and infer over
    the tail (p = 7: 7 blocks and both shared blocks blinded)."""
    cfg = get_smoke("zamba2_1_2b").replace(num_layers=7, dtype="float32")
    jcfg = jget_smoke("zamba2_1_2b").replace(num_layers=7, dtype="float32")
    jp, params = _carried(cfg, jcfg, seed=3)
    assert tuple(params["mamba_tail"]["norm"]["scale"].shape) == (
        1, cfg.d_model)
    tokens = np.random.default_rng(4).integers(0, cfg.vocab_size, (1, 16))
    want = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(tokens)},
                                 jcfg).logits, np.float32)
    with torch.no_grad():
        got = _f32(M.forward(params, {"tokens": torch.from_numpy(tokens)},
                             cfg).logits)
        caches = M.init_caches(cfg, 1, 16, device="cpu")
        assert caches["tail"].conv.shape[0] == 1
        outs = []
        for t in range(16):
            logits, caches = M.decode_step(
                params, torch.from_numpy(tokens[:, t:t + 1]), caches, t, cfg)
            outs.append(_f32(logits[:, 0]))
    _close(got, want)
    np.testing.assert_allclose(np.stack(outs, 1), want, rtol=DECODE_TOL,
                               atol=DECODE_TOL)
    ex = _executor(cfg, params, 7)
    res = ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION))
    assert res.integrity.n_checked == 7 * 2 + 2 * SHARED_OPS
    assert torch.equal(res.logits, ex.infer({"tokens": tokens},
                                            prng.PRNGKey(SESSION),
                                            trusted=True).logits)


def test_sinusoidal_positions_without_attention_or_rope():
    """The reference adds sinusoidal positions when ``attention == "none"``
    and ``rope_theta == 0``: an xLSTM variant with RoPE off (float32),
    forward and a decode step's embedding against the reference."""
    cfg = get_smoke("xlstm_1_3b").replace(rope_theta=0.0, dtype="float32")
    jcfg = jget_smoke("xlstm_1_3b").replace(rope_theta=0.0, dtype="float32")
    jp, params = _carried(cfg, jcfg, seed=5)
    tokens = np.random.default_rng(6).integers(0, cfg.vocab_size, (1, 16))
    want = JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg).logits
    with torch.no_grad():
        got = M.forward(params, {"tokens": torch.from_numpy(tokens)},
                        cfg).logits
        emb = M.embed_tokens_at(params, torch.from_numpy(tokens[:, 5:6]), 5,
                                cfg)
        plain = M.embed_tokens_at(
            params, torch.from_numpy(tokens[:, 5:6]), 5,
            cfg.replace(rope_theta=10000.0))
    _close(_f32(got), want)
    jemb = JM.embed_tokens_at(jp, jnp.asarray(tokens[:, 5:6]), jnp.int32(5),
                              jcfg)
    _close(_f32(emb), jemb)
    assert not torch.equal(emb, plain)


def _lm_request(cfg, rid, seq, rng):
    toks = rng.integers(0, cfg.vocab_size, size=(seq,)).astype(np.float32)
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, toks, rid)
    return (Request(rid=rid, box=box, shape=toks.shape, session_key=key),
            key, toks)


def test_engine_serves_a_sealed_request(ssm_lm, rng):
    """One sealed request through the engine (``input_key="tokens"``,
    full(k=2)): the response opens to (S, padded vocab), bit-equal to the
    trusted forward of its batch."""
    _, cfg, _, _, params, _ = ssm_lm
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=50.0))
    entry = engine.register_model("ssm", cfg, params, input_key="tokens",
                                  input_dtype="int32",
                                  integrity=IG.IntegrityPolicy.full(k=2),
                                  device="cpu")
    req, key, toks = _lm_request(cfg, 50, 32, rng)
    try:
        resp = engine.submit("ssm", req).result(timeout=TIMEOUT)
        assert resp.ok, resp.error
    finally:
        engine.close()
    want = entry.executor.infer({"tokens": toks[None]},
                                trusted=True).logits.to(torch.float32)
    lg = PrivateInferenceServer.client_open(key, resp.box,
                                            (32, cfg.padded_vocab))
    np.testing.assert_array_equal(lg, want[0].numpy())


def test_private_decode_paths_refuse_the_recurrent_families(ssm_lm):
    """private_generate, attach_decode_plan and GenerateExecutor raise
    ScanExclusion with the reference's reason; generate_origami refuses
    as the reference's assertion does."""
    arch, cfg, jcfg, jp, params, tokens = ssm_lm
    with pytest.raises(JPL.ScanExclusion) as want:
        JG.private_generate(jp, jnp.asarray(tokens), jcfg, max_new_tokens=2)
    reason = PL._DECODE_EXCLUSIONS[cfg.family]
    assert reason == JPL._DECODE_EXCLUSIONS[cfg.family]
    assert reason in str(want.value)
    ex = _executor(cfg, params, 1)
    for call in (lambda: ex.attach_decode_plan(),
                 lambda: PL.make_decode_plan(cfg, max_steps=2),
                 lambda: G.private_generate(params, tokens, cfg,
                                            max_new_tokens=2, device="cpu"),
                 lambda: G.GenerateExecutor(cfg, params, prompt_len=8,
                                            max_new_tokens=2, device="cpu")):
        with pytest.raises(PL.ScanExclusion) as got:
            call()
        assert str(want.value).startswith(str(got.value))
    assert ex.dplan is None
    with pytest.raises(AssertionError):
        JG.generate_origami(jp, jnp.asarray(tokens[:, :2]), jcfg,
                            max_new_tokens=1)
    with pytest.raises(AssertionError):
        G.generate_origami(params, tokens[:, :2], cfg, max_new_tokens=1,
                           device="cpu")
    with pytest.raises(NotImplementedError):
        M.prefill(params, {"tokens": torch.from_numpy(tokens)}, cfg)


def test_chunk_rule_holds_the_length_to_the_chunk():
    """A prompt longer than a chunk must be a multiple of it (the
    reference's assertion, kept): the smoke Zamba2 (chunk 32) runs 64
    tokens and refuses 40, as the reference does; shorter prompts run as
    one chunk of their own length."""
    cfg, jcfg = get_smoke("zamba2_1_2b"), jget_smoke("zamba2_1_2b")
    params = M.init_params(cfg, 0, device="cpu")
    for S_len in (8, 64):
        toks = torch.zeros((1, S_len), dtype=torch.long)
        assert _forward(params, toks.numpy(), cfg).shape[1] == S_len
    toks = np.zeros((1, 40), np.int32)
    with pytest.raises(AssertionError):
        _forward(params, toks, cfg)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    with pytest.raises(AssertionError):
        JM.forward(jp, {"tokens": jnp.asarray(toks)}, jcfg)
