"""The port's LM forward ``OrigamiExecutor.infer`` (smollm_135m smoke config,
4 layers, d 96) against the JAX reference on the CPU, and the token step
whose position is a tensor.

The reference's LM forward walks its blocks under ``lax.scan``, so each
projection of a blinded segment is traced once for all the segment's
layers: one pad per projection, no verification, one count per traced
call (pinned below). The port blinds every runtime op with its own key
``(session, op, 0)``, the keys of the reference's own per-op prompt pass
(``prefill_session(jit=False)``), and checks each: its telemetry and
``IntegrityReport`` equal that pass's on the same tokens and plan, and
the first blinded op's output is bit-equal to it. The blinding cancels
exactly, so blinded logits equal trusted ones bit for bit; against the
reference's float layers (bf16) logits are held to atol 3e-2 * max|ref|,
the tolerance of tests/test_torch_generate.py.
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
from repro.core.attestation import measure_enclave as jmeasure  # noqa: E402
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime.devices import DevicePool as JDevicePool  # noqa: E402
import repro_torch.core.slalom as SL  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as IG  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.attestation import measure_enclave  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import aot as AOT  # noqa: E402
from repro_torch.runtime.devices import DevicePool  # noqa: E402
from repro_torch.runtime.faults import DishonestDevice, FaultSpec  # noqa: E402

LOGIT_TOL = 3e-2
SESSION = 11
PINNED_P = 3          # the reference's scanned counts are pinned at p = 3
COUNTED_P = 2         # the per-op prompt pass (eager, slow) runs at p = 2


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


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.fixture(scope="module")
def smollm():
    cfg, jcfg = get_smoke("smollm_135m"), jget_smoke("smollm_135m")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, 8)).astype(np.int32)
    return cfg, jcfg, jp, params, tokens


@pytest.fixture(scope="module")
def reference_forward(smollm):
    """The reference's jitted LM forward at p = 3 under full(k=2)."""
    _, jcfg, jp, _, tokens = smollm
    ex = JEx(jcfg, jp, "origami", partition=PINNED_P,
             integrity=JIG.IntegrityPolicy.full(k=2))
    res = ex.infer({"tokens": jnp.asarray(tokens)},
                   session_key=jax.random.PRNGKey(SESSION))
    return {"logits": np.asarray(res.logits, np.float32),
            "n_ops": res.integrity.n_ops,
            "telemetry": dataclasses.asdict(ex.telemetry_blinded)}


@pytest.fixture(scope="module")
def reference_prompt_pass(smollm):
    """The reference's eager per-op prompt pass at p = 2: telemetry,
    report and the first blinded op's output."""
    _, jcfg, jp, _, tokens = smollm
    ex = JEx(jcfg, jp, "origami", partition=COUNTED_P,
             integrity=JIG.IntegrityPolicy.full(k=2))
    ex.attach_decode_plan(max_steps=2)
    with _FirstFused(JSL) as rec:
        _, _, rep = ex.prefill_session(
            jnp.asarray(tokens), jax.random.PRNGKey(SESSION),
            max_seq=tokens.shape[1], jit=False)
    return {"report": _report(rep), "first": rec.first,
            "telemetry": dataclasses.asdict(ex.telemetry_blinded)}


def _executor(cfg, params, partition, **kw):
    kw.setdefault("integrity", IG.IntegrityPolicy.full(k=2))
    return OrigamiExecutor(cfg, params, "origami", partition, device="cpu",
                           **kw)


def test_reference_forward_scans_its_blinded_layers(reference_forward):
    """The reference's fault the port does not copy: three blinded layers
    of 7 projections count as 7 traced calls, and none is checked."""
    tele = reference_forward["telemetry"]
    assert tele["calls"] == tele["device_matmuls"] == 7
    assert tele["fold_matmuls"] == 7 and tele["verify_ops"] == 0
    assert reference_forward["n_ops"] == 0


@pytest.mark.parametrize("mode,partition", [("origami", PINNED_P),
                                            ("origami", 1), ("slalom", None),
                                            ("split", PINNED_P)])
def test_lm_infer_blinded_equals_trusted(smollm, mode, partition):
    cfg, _, _, params, tokens = smollm
    ex = OrigamiExecutor(cfg, params, mode, partition,
                         integrity=IG.IntegrityPolicy.full(k=2), device="cpu")
    key = prng.PRNGKey(SESSION)
    blinded = ex.infer({"tokens": tokens}, key)
    trusted = ex.infer({"tokens": tokens}, key, trusted=True)
    assert blinded.logits.shape == (2, 8, cfg.padded_vocab)
    assert torch.equal(blinded.logits, trusted.logits)
    rep = blinded.integrity
    n_ops = 7 * ex.plan.num_blinded
    assert rep.n_ops == rep.n_checked == blinded.telemetry.calls == n_ops
    assert rep.ok and trusted.integrity.n_ops == 0
    assert trusted.telemetry.trusted_matmuls == blinded.telemetry.calls


def test_lm_infer_matches_reference_logits(smollm, reference_forward):
    cfg, _, _, params, tokens = smollm
    ex = _executor(cfg, params, PINNED_P)
    got = _f32(ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION)).logits)
    want = reference_forward["logits"]
    assert got.shape == want.shape
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())
    # the float oracle agrees with the reference's float forward too
    _, jcfg, jp, _, _ = smollm
    ref = _f32(ex.reference({"tokens": tokens}))
    jref = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg)
                      .logits, np.float32)
    np.testing.assert_allclose(ref, jref, rtol=0,
                               atol=LOGIT_TOL * np.abs(jref).max())


def test_lm_infer_counts_equal_reference_prompt_pass(smollm,
                                                     reference_prompt_pass):
    """Per-op keys and checks: the port's forward blinds and counts as the
    reference's per-op prompt pass does, not as its scanned forward."""
    cfg, _, _, params, tokens = smollm
    ex = _executor(cfg, params, COUNTED_P)
    with _FirstFused(SL) as rec:
        res = ex.infer({"tokens": tokens}, prng.PRNGKey(SESSION))
    np.testing.assert_array_equal(rec.first, reference_prompt_pass["first"])
    assert _report(res.integrity) == reference_prompt_pass["report"]
    assert res.integrity.n_checked == 7 * COUNTED_P
    assert (dataclasses.asdict(res.telemetry)
            == reference_prompt_pass["telemetry"])


def test_lm_infer_catches_a_dishonest_device(smollm):
    cfg, _, _, params, tokens = smollm
    honest = _executor(cfg, params, PINNED_P)
    bad = _executor(cfg, params, PINNED_P,
                    fault=DishonestDevice(FaultSpec("bit_flip")))
    key = prng.PRNGKey(SESSION)
    rep = bad.infer({"tokens": tokens}, key).integrity
    assert rep.n_ops == rep.n_corrupted == rep.n_failed == 7 * PINNED_P
    assert torch.equal(rep.failed, rep.corrupted)
    assert honest.infer({"tokens": tokens}, key).integrity.ok


def test_lm_executor_with_device_pool(smollm):
    """The reference accepts a pool for an LM and leaves its plane idle:
    the same logits and report as an executor without one."""
    cfg, _, _, params, tokens = smollm
    key = prng.PRNGKey(SESSION)
    plain = _executor(cfg, params, PINNED_P).infer({"tokens": tokens}, key)
    pooled_ex = _executor(cfg, params, PINNED_P, devices=DevicePool(2))
    assert pooled_ex.plane is not None and not pooled_ex._plane_live
    pooled = pooled_ex.infer({"tokens": tokens}, key)
    assert pooled.sharding is None
    assert torch.equal(pooled.logits, plain.logits)
    assert torch.equal(pooled.boundary, plain.boundary)
    assert _report(pooled.integrity) == _report(plain.integrity)
    _, jcfg, jp, _, _ = smollm
    jex = JEx(jcfg, jp, "origami", partition=PINNED_P,
              devices=JDevicePool(2))
    assert jex.plane is not None and not jex._plane_live


def test_lm_infer_executables(smollm):
    """Under a CompileCache the trusted forward runs an executable and the
    blinded one (live pads, no cache slots) stays eager; both bit-equal to
    the eager steps."""
    cfg, _, _, params, tokens = smollm
    ex = _executor(cfg, params, PINNED_P)
    cache = AOT.CompileCache()
    ex.attach_aot(cache)
    key = prng.PRNGKey(SESSION)
    assert ex._graphable(True) and not ex._graphable(False)
    trusted = ex.infer({"tokens": tokens}, key, trusted=True)
    blinded = ex.infer({"tokens": tokens}, key)
    assert cache.counters["compiles"] == 1
    eager = ex.infer({"tokens": tokens}, key, trusted=True, jit=False)
    assert torch.equal(trusted.logits, eager.logits)
    assert torch.equal(blinded.logits, eager.logits)
    assert ex.warm_aot("tokens", (8,), (2,), dtype=torch.long) == 1
    assert cache.counters["compiles"] == 1


def test_token_step_at_a_tensor_position(smollm):
    """A token step whose position is a 0-dim tensor (what a CUDA graph
    replays) is bit-equal to the int-position step, through the model
    and through the executor's executable (EagerStep on the CPU)."""
    cfg, _, _, params, tokens = smollm
    t = torch.from_numpy(tokens).long()
    S0, total = 5, 8
    _, caches = M.prefill(params, {"tokens": t[:, :S0]}, cfg, max_seq=total)
    c_int = A.KVCache(caches.k.clone(), caches.v.clone())
    c_ten = A.KVCache(caches.k.clone(), caches.v.clone())
    for pos in range(S0, total):
        a, c_int = M.decode_step(params, t[:, pos:pos + 1], c_int, pos, cfg)
        b, c_ten = M.decode_step(params, t[:, pos:pos + 1], c_ten,
                                 torch.tensor(pos), cfg)
        assert torch.equal(a, b)
    assert torch.equal(c_int.k, c_ten.k) and torch.equal(c_int.v, c_ten.v)

    ex = _executor(cfg, params, 1)
    ex.attach_decode_plan(max_steps=4)
    key = prng.PRNGKey(SESSION)
    _, pre, _ = ex.prefill_session(t[:, :S0], key, max_seq=total)
    slot = ex.decode_cache(2).session_factors(key, S0)
    tok = t[:, S0:S0 + 1]
    eager = ex.decode_once(tok, A.KVCache(pre.k.clone(), pre.v.clone()), S0,
                           key, slot)
    ex.attach_aot(AOT.CompileCache())
    run = ex.decode_once(tok, A.KVCache(pre.k.clone(), pre.v.clone()), S0,
                         key, slot)
    assert isinstance(next(iter(ex._executables.values())), AOT.EagerStep)
    assert torch.equal(run[0], eager[0])
    assert torch.equal(run[1].k, eager[1].k)
    assert _report(run[2]) == _report(eager[2])


def test_lm_quote_matches_reference(smollm):
    """The enclave measurement of bf16 LM weights (their raw bytes) equals
    the reference's, plan digest included."""
    cfg, jcfg, jp, params, _ = smollm
    ex = _executor(cfg, params, PINNED_P)
    jex = JEx(jcfg, jp, "origami", partition=PINNED_P)
    got = measure_enclave(cfg, ex.params, PINNED_P,
                          plan_digest=ex.plan.digest)
    want = jmeasure(jcfg, jp, PINNED_P, plan_digest=jex.plan.digest)
    assert dataclasses.asdict(got) == dataclasses.asdict(want)
