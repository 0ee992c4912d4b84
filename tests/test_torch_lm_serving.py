"""The port's LM serving through its engine on the CPU (smollm_135m smoke
config): the reference's engine LM bucket case
(``tests/test_engine.py::test_lm_mixed_shape_buckets_complete_independently``),
its token-stream case
(``tests/test_private_generate.py::test_engine_serves_token_streams``) and
the engine's hooks for a generate executor (``request_shape``,
``response_elems``, ``attested_digest``).

Blinding cancels exactly, so a served response is held bit for bit: the
LM logits to the trusted forward of the same padded batch, the token
streams to ``private_generate(trusted=True)`` on the same padded batch
with the executor's fixed sampling key.
"""
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.integrity import IntegrityPolicy  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402
from repro_torch.runtime.engine import EngineConfig, ServingEngine  # noqa: E402
from repro_torch.runtime.serving import (PrivateInferenceServer,  # noqa: E402
                                         Request)

TIMEOUT = 120


@pytest.fixture(scope="module")
def smollm():
    cfg = get_smoke("smollm_135m")
    return cfg, M.init_params(cfg, 2, device="cpu")


def _lm_request(cfg, rid, seq, rng):
    toks = rng.integers(0, cfg.vocab_size, size=(seq,)).astype(np.float32)
    key = rng.integers(0, 2 ** 32 - 1, size=(2,), dtype=np.uint32)
    box = PrivateInferenceServer.client_seal(key, toks, rid)
    return (Request(rid=rid, box=box, shape=toks.shape, session_key=key),
            key, toks)


def test_lm_mixed_shape_buckets_complete_independently(smollm, rng):
    """Two sequence lengths land in two (model, shape) buckets that pad and
    dispatch independently; each response opens to (S, padded vocab),
    bit-equal to the trusted forward of its padded batch."""
    cfg, params = smollm
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=150.0))
    entry = engine.register_model("lm", cfg, params, input_key="tokens",
                                  input_dtype="int32", device="cpu")
    reqs = ([_lm_request(cfg, 30 + i, 8, rng) for i in range(2)]
            + [_lm_request(cfg, 40, 16, rng)])
    try:
        futs = [engine.submit("lm", r) for r, _, _ in reqs]
        got = [f.result(timeout=TIMEOUT) for f in futs]
        assert all(r.ok for r in got)
        assert engine.stats.batches >= 2       # two buckets, two dispatches
    finally:
        engine.close()
    ex = entry.executor
    short = ex.infer({"tokens": np.stack([t for _, _, t in reqs[:2]])},
                     trusted=True).logits.to(torch.float32)
    long_ = ex.infer({"tokens": reqs[2][2][None]},
                     trusted=True).logits.to(torch.float32)
    want = [short[0], short[1], long_[0]]
    for (_, key, toks), resp, w in zip(reqs, got, want):
        lg = PrivateInferenceServer.client_open(
            key, resp.box, (len(toks), cfg.padded_vocab))
        assert np.isfinite(lg).all()
        np.testing.assert_array_equal(lg, w.numpy())


def _serve_streams(engine, name, cfg, prompt_len, new, rng, n=4):
    futs, keys, prompts = [], [], []
    for rid in range(n):
        req, key, toks = _lm_request(cfg, rid, prompt_len, rng)
        futs.append(engine.submit(name, req))
        keys.append(key)
        prompts.append(toks.astype(np.int64))
    outs = []
    for f, key in zip(futs, keys):
        resp = f.result(timeout=TIMEOUT)
        assert resp.ok, resp
        out = PrivateInferenceServer.client_open(key, resp.box,
                                                 (prompt_len + new,))
        outs.append(out.astype(np.int64))
    return np.stack(prompts), np.stack(outs)


def test_engine_serves_token_streams(smollm, rng):
    """GenerateExecutor through the batcher: sealed prompts in, sealed
    whole sequences out, bit-equal to the trusted oracle on the same
    padded batch."""
    cfg, params = smollm
    prompt_len, new = 6, 4
    ex = G.GenerateExecutor(cfg, params, prompt_len=prompt_len,
                            max_new_tokens=new,
                            integrity=IntegrityPolicy.full(k=2),
                            device="cpu")
    assert ex.attested_digest == ex.dplan.digest != ex.plan.digest
    engine = ServingEngine(EngineConfig(max_batch=4, max_wait_ms=50.0))
    engine.register_executor("smollm-gen", ex, input_key="tokens",
                             input_dtype="int32")
    assert engine.attest("smollm-gen").plan_digest == ex.dplan.digest
    try:
        prompts, outs = _serve_streams(engine, "smollm-gen", cfg,
                                       prompt_len, new, rng)
    finally:
        engine.close()
    oracle = G.private_generate(params, prompts, cfg, max_new_tokens=new,
                                trusted=True, executor=ex,
                                key=prng.PRNGKey(0))
    np.testing.assert_array_equal(outs, oracle.tokens.numpy())
    np.testing.assert_array_equal(outs[:, :prompt_len], prompts)
    assert engine.stats.completed == 4


def test_engine_warms_a_generate_executor(smollm, rng):
    """``warm`` reads the executor's ``request_shape`` and
    ``response_elems``: every bucket's trusted prompt pass and both token
    steps are built at registration (the blinded prompt pass draws live
    pads and stays eager), and no request builds one. Sampling at
    temperature 0.8 replays in the trusted oracle."""
    cfg, params = smollm
    prompt_len, new = 5, 3
    ex = G.GenerateExecutor(cfg, params, prompt_len=prompt_len,
                            max_new_tokens=new, temperature=0.8,
                            integrity=IntegrityPolicy.full(k=2),
                            device="cpu")
    assert ex.request_shape == (prompt_len,)
    assert ex.response_elems == prompt_len + new
    engine = ServingEngine(EngineConfig(max_batch=2, max_wait_ms=50.0,
                                        aot_warm=True))
    engine.register_executor("gen", ex, input_key="tokens",
                             input_dtype="int32")
    assert engine.aot.counters["compiles"] == 2 * 3      # buckets 1 and 2
    assert set(ex._decode_caches) == {1, 2}
    try:
        prompts, outs = _serve_streams(engine, "gen", cfg, prompt_len, new,
                                       rng, n=2)
    finally:
        engine.close()
    assert engine.aot.counters["compiles"] == 6
    assert engine.aot.request_compile_seconds == 0.0
    oracle = G.private_generate(params, prompts, cfg, max_new_tokens=new,
                                temperature=0.8, trusted=True, executor=ex,
                                key=prng.PRNGKey(0))
    np.testing.assert_array_equal(outs, oracle.tokens.numpy())
