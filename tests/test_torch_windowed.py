"""Sliding-window attention and query offsets in the port against the JAX
reference on the CPU, on the same numpy inputs.

- ``sdpa`` with ``window`` and ``q_offset``, causal and not, in bf16 and
  float32, at Sq == Skv, Sq < Skv and a ragged key length (the reference
  pads 263 keys to 384 and masks the padding), against the reference's
  naive core (``sdpa(..., cost_mode=True)``): float32 at 2e-5, bf16 at
  2e-2, the flash tolerances of tests/test_torch_flash.py;
- ``cost_mode`` against the reference's, in ``sdpa`` and the LM forward;
- the reference's flash core dropping ``q_offset`` (ROADMAP Queue 3);
- the refusal of a row that sees no key; ``FlashAttention`` (the
  training path) with a window or an offset against ``jax.vjp`` of the
  reference's ``sdpa``;
- ``decode_splits`` sized by the band of keys the rows see;
- a windowed SmolLM at smoke width (4 blocks, window 3 against 8-token
  prompts) through ``forward``, ``OrigamiExecutor.infer`` (the first
  blinded op bit-equal, report and telemetry equal to the reference's
  per-op prompt pass, blinded == trusted in logits and tier-1 boundary)
  ``private_generate`` and open ``generate`` (tokens equal to the
  reference's);
- ``BlindedLayerCache``'s ``num_layers``, ``weight_bytes`` (but the limb
  planes' padding, each package's own) and ``clear_prefetch`` against the
  reference's on VGG-16's smoke cache.
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
from repro.core.origami import OrigamiExecutor as JEx  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
import repro_torch.core.slalom as SL  # noqa: E402
from repro_torch.configs import get_smoke  # noqa: E402
from repro_torch.core import integrity as IG  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.core.origami import OrigamiExecutor  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    DECODE_MIN_KEYS, band, decode_splits)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import vgg as V  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2
LOGIT_TOL = 3e-2
SESSION = 11
WINDOW = 3
PROMPT = (2, 8)
NEW = 4
DTYPES = {"float32": (torch.float32, jnp.float32, F32_TOL),
          "bf16": (torch.bfloat16, jnp.bfloat16, BF16_TOL)}
# (name, Sq, Skv): one query block of the keys, fewer queries than keys,
# and a key length with no tile divisor >= 64 past 256 (the reference pads
# and masks it)
SHAPES = (("square", 40, 40), ("short", 12, 76), ("ragged", 24, 263))


def _cases():
    out = []
    for name, Sq, Skv in SHAPES:
        offsets = sorted({0, Skv - Sq})
        for window in (1, 5, 16, 100):
            for off in offsets:
                for causal in (True, False):
                    for dt in DTYPES:
                        out.append(pytest.param(
                            Sq, Skv, window, off, causal, dt,
                            id=f"{name}-w{window}-off{off}-"
                               f"{'causal' if causal else 'full'}-{dt}"))
    return out


def _qkv(rng, B, Sq, Skv, H, KH, D):
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


def _f32(t):
    return t.to(torch.float32).numpy()


@pytest.mark.parametrize("Sq,Skv,window,q_offset,causal,dt", _cases())
def test_sdpa_window_and_offset_match_reference_naive_core(
        Sq, Skv, window, q_offset, causal, dt):
    tdt, jdt, tol = DTYPES[dt]
    q, k, v = _qkv(np.random.default_rng(Sq + Skv + window), 2, Sq, Skv, 4,
                   2, 32)
    got = A.sdpa(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=causal,
                 q_offset=q_offset, window=window)
    want = np.asarray(JA.sdpa(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                              causal=causal, q_offset=q_offset,
                              window=window, cost_mode=True), np.float32)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(_f32(got), want, rtol=tol, atol=tol)
    # the window binds: the last row differs from the causal one's
    if causal and window < Sq + q_offset:
        full = A.sdpa(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=True,
                      q_offset=q_offset)
        assert not torch.equal(got[:, -1], full[:, -1])


@pytest.mark.parametrize("window", [0, 50])
def test_cost_mode_matches_reference(window):
    """At a shape the reference serves with its flash core (128 queries
    against 256 keys in 64-row chunks), ``cost_mode`` runs both naive
    cores; the port's is its plain version."""
    q, k, v = _qkv(np.random.default_rng(window), 1, 128, 128, 4, 2, 32)
    got = A.sdpa(_t(q), _t(k), _t(v), causal=True, window=window,
                 cost_mode=True)
    want = np.asarray(JA.sdpa(_j(q), _j(k), _j(v), causal=True,
                              window=window, cost_mode=True))
    np.testing.assert_allclose(got.numpy(), want, rtol=F32_TOL, atol=F32_TOL)
    flash = A.sdpa(_t(q), _t(k), _t(v), causal=True, window=window)
    np.testing.assert_allclose(got.numpy(), flash.numpy(), rtol=F32_TOL,
                               atol=F32_TOL)


def test_reference_flash_core_drops_q_offset():
    """The reference's fault the port does not copy: its flash core takes
    ``q_offset`` and never passes it on (``_flash_core``), so at a
    flashable shape ``sdpa(q_offset=o)`` is the unoffset result. The port
    follows the naive core."""
    q, k, v = _qkv(np.random.default_rng(3), 1, 128, 256, 4, 2, 32)
    kw = dict(causal=True, q_chunk=64, kv_chunk=64)
    j_flash = np.asarray(JA.sdpa(_j(q), _j(k), _j(v), q_offset=128, **kw))
    j_unoffset = np.asarray(JA.sdpa(_j(q), _j(k), _j(v), **kw))
    j_naive = np.asarray(JA.sdpa(_j(q), _j(k), _j(v), q_offset=128,
                                 causal=True, cost_mode=True))
    np.testing.assert_allclose(j_flash, j_unoffset, rtol=F32_TOL,
                               atol=F32_TOL)
    assert np.abs(j_flash - j_naive).max() > 0.1
    got = A.sdpa(_t(q), _t(k), _t(v), causal=True, q_offset=128).numpy()
    np.testing.assert_allclose(got, j_naive, rtol=F32_TOL, atol=F32_TOL)


def test_rows_without_keys_are_refused():
    """An offset that puts the last row ``window`` or more past the last
    key: the reference's naive core returns NaN there; the port refuses
    the call, with and without ``cost_mode``."""
    q, k, v = _qkv(np.random.default_rng(4), 1, 4, 16, 2, 2, 32)
    want = np.asarray(JA.sdpa(_j(q), _j(k), _j(v), causal=True, q_offset=15,
                              window=3, cost_mode=True))
    assert np.isnan(want[:, -1]).all() and np.isfinite(want[:, 0]).all()
    for cost_mode in (False, True):
        with pytest.raises(ValueError, match="sees none"):
            A.sdpa(_t(q), _t(k), _t(v), causal=True, q_offset=15, window=3,
                   cost_mode=cost_mode)
    with pytest.raises(ValueError, match=">= 0"):
        A.sdpa(_t(q), _t(k), _t(v), causal=True, q_offset=-1)
    # without causal neither the offset nor the window applies
    full = A.sdpa(_t(q), _t(k), _t(v), causal=False, q_offset=20, window=4)
    np.testing.assert_allclose(
        full.numpy(), np.asarray(JA.sdpa(_j(q), _j(k), _j(v), causal=False,
                                         cost_mode=True)),
        rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("kw", [{"window": 4}, {"q_offset": 2}])
def test_flash_attention_refuses_a_window_with_a_gradient(kw):
    """The calls the training path once refused (a window or an offset
    with a gradient) now train: ``sdpa`` and ``FlashAttention`` give the
    gradients of ``jax.vjp`` of the reference's ``sdpa`` (its naive core
    at this shape) through the plain backward on the CPU, and the
    forward without a gradient is the same function."""
    q, k, v = _qkv(np.random.default_rng(6), 1, 8, 8, 4, 2, 32)
    dout = np.random.default_rng(7).normal(size=q.shape).astype(np.float32)
    _, vjp = jax.vjp(lambda a, b, c: JA.sdpa(a, b, c, causal=True, **kw),
                     _j(q), _j(k), _j(v))
    want = [np.asarray(g) for g in vjp(_j(dout))]
    for call in (lambda a, b, c: A.sdpa(a, b, c, causal=True, **kw),
                 lambda a, b, c: A.FlashAttention.apply(
                     a, b, c, True, kw.get("window", 0),
                     kw.get("q_offset", 0))):
        qkv = [_t(x).requires_grad_(True) for x in (q, k, v)]
        out = call(*qkv)
        out.backward(_t(dout))
        for x, w in zip(qkv, want):
            np.testing.assert_allclose(x.grad.numpy(), w, rtol=F32_TOL,
                                       atol=F32_TOL)
    with torch.no_grad():
        np.testing.assert_array_equal(
            A.sdpa(_t(q), _t(k), _t(v), causal=True, **kw).numpy(),
            out.detach().numpy())


@pytest.mark.parametrize("Sq,Skv,causal,off,window", [
    (4, 1024, True, 1020, 256), (1, 1601, False, 0, 0), (4, 300, True, 0, 0),
    (1, 4096, True, 4095, 100), (2, 900, True, 898, 0)])
def test_decode_splits_cover_the_band(Sq, Skv, causal, off, window):
    lo, hi = band(Sq, Skv, causal, off, window)
    n = decode_splits(4, Sq, Skv, 9, 3, torch.bfloat16, causal=causal,
                      q_offset=off, window=window)
    chunk = -(-(hi - lo) // n)
    assert n >= 1 and (n - 1) * chunk < hi - lo <= n * chunk
    assert n == 1 or chunk >= DECODE_MIN_KEYS
    rows = torch.arange(Sq) + off
    if causal:
        seen = (rows[:, None] >= torch.arange(Skv)[None, :])
        if window:
            seen &= (rows[:, None] - torch.arange(Skv)[None, :]) < window
    else:
        seen = torch.ones(Sq, Skv, dtype=torch.bool)
    cols = seen.any(0).nonzero()[:, 0]
    assert (lo, hi) == (int(cols[0]), int(cols[-1]) + 1)
    assert decode_splits(4, Sq, Skv, 9, 3, torch.float32, causal=causal,
                         q_offset=off, window=window) == 0


# -- a windowed SmolLM at smoke width ---------------------------------------

@pytest.fixture(scope="module")
def windowed():
    cfg = dataclasses.replace(get_smoke("smollm_135m"), attention="windowed",
                              window_size=WINDOW)
    jcfg = dataclasses.replace(jget_smoke("smollm_135m"),
                               attention="windowed", window_size=WINDOW)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(2).integers(
        0, cfg.vocab_size, PROMPT).astype(np.int32)
    return cfg, jcfg, jp, params, tokens


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


def _close(got, want):
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=LOGIT_TOL * np.abs(want).max())


@pytest.mark.parametrize("cost_mode", [False, True])
def test_windowed_forward_matches_reference(windowed, cost_mode):
    cfg, jcfg, jp, params, tokens = windowed
    got = _f32(M.forward(params, {"tokens": torch.from_numpy(tokens)}, cfg,
                         cost_mode=cost_mode).logits)
    want = np.asarray(JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                                 cost_mode=cost_mode).logits, np.float32)
    _close(got, want)
    causal = dataclasses.replace(cfg, attention="gqa", window_size=0)
    unwindowed = _f32(M.forward(params, {"tokens": torch.from_numpy(tokens)},
                                causal).logits)
    assert np.abs(unwindowed - got)[:, WINDOW:].max() > 1e-3
    np.testing.assert_array_equal(unwindowed[:, :WINDOW], got[:, :WINDOW])


def test_windowed_infer_matches_reference_prompt_pass(windowed):
    """``infer`` at p = 2 under full(k=2): the first blinded op bit-equal
    to the reference's per-op prompt pass, report and telemetry equal,
    blinded == trusted in logits and tier-1 boundary, logits within the
    bf16 tolerance of the reference's."""
    cfg, jcfg, jp, params, tokens = windowed
    jex = JEx(jcfg, jp, "origami", partition=2,
              integrity=JIG.IntegrityPolicy.full(k=2))
    jex.attach_decode_plan(max_steps=2)
    with _FirstFused(JSL) as jrec:
        jlogits, _, jrep = jex.prefill_session(
            jnp.asarray(tokens), jax.random.PRNGKey(SESSION),
            max_seq=tokens.shape[1], jit=False)
    ex = OrigamiExecutor(cfg, params, "origami", 2, device="cpu",
                         integrity=IG.IntegrityPolicy.full(k=2))
    key = prng.PRNGKey(SESSION)
    with _FirstFused(SL) as rec:
        res = ex.infer({"tokens": tokens}, key)
    np.testing.assert_array_equal(rec.first, jrec.first)
    assert _report(res.integrity) == _report(jrep)
    assert res.integrity.ok and res.integrity.n_checked == 7 * 2
    assert (dataclasses.asdict(res.telemetry)
            == dataclasses.asdict(jex.telemetry_blinded))
    trusted = ex.infer({"tokens": tokens}, key, trusted=True)
    assert torch.equal(res.logits, trusted.logits)
    assert torch.equal(res.boundary, trusted.boundary)
    _close(_f32(res.logits[:, -1]), np.asarray(jlogits[:, -1], np.float32))


def test_windowed_private_generate_matches_reference(windowed):
    """Greedy ``private_generate`` past the window (8-token prompts, 4
    new, window 3): the reference's tokens, private == trusted."""
    cfg, jcfg, jp, params, tokens = windowed
    want = JG.private_generate(
        jp, jnp.asarray(tokens), jcfg, max_new_tokens=NEW,
        integrity=JIG.IntegrityPolicy.full(k=2),
        session_key=jax.random.PRNGKey(SESSION))
    kw = dict(max_new_tokens=NEW, integrity=IG.IntegrityPolicy.full(k=2),
              session_key=prng.PRNGKey(SESSION), device="cpu")
    got = G.private_generate(params, tokens, cfg, **kw)
    oracle = G.private_generate(params, tokens, cfg, trusted=True, **kw)
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))
    assert torch.equal(got.tokens, oracle.tokens)
    assert torch.equal(got.logits, oracle.logits)
    assert got.integrity.ok
    assert got.integrity.n_checked == 7 * cfg.origami.tier1_layers * NEW


def test_windowed_open_generate_matches_reference(windowed):
    """Open greedy ``generate`` past the window: the reference's tokens."""
    cfg, jcfg, jp, params, tokens = windowed
    want = JG.generate(jp, jnp.asarray(tokens), jcfg, max_new_tokens=NEW)
    got = G.generate(params, tokens, cfg, max_new_tokens=NEW, device="cpu")
    np.testing.assert_array_equal(got.tokens.numpy(), np.asarray(want.tokens))


# -- BlindedLayerCache's leftovers -------------------------------------------

def test_blinded_layer_cache_sizes_match_reference():
    from repro.core.origami import OrigamiExecutor as JVEx
    cfg, jcfg = get_smoke("vgg16"), jget_smoke("vgg16")
    rng = np.random.default_rng(3)
    npp = {layer: {"w": (rng.normal(size=leaves["w"].shape) * 0.1).astype(
                       np.float32),
                   "b": np.zeros(leaves["b"].shape, np.float32)}
           for layer, leaves in V.vgg_defs(cfg).items()}
    x = np.zeros((2, cfg.image_size, cfg.image_size, 3), np.float32)
    jex = JVEx(jcfg, jax.tree.map(jnp.asarray, npp), "origami",
               precompute=True)
    jcache = jex.build_cache({"images": jnp.asarray(x)})
    ex = OrigamiExecutor(cfg, jax.tree.map(torch.from_numpy, npp), "origami",
                         precompute=True, device="cpu")
    cache = ex.build_cache({"images": torch.from_numpy(x)})
    assert cache.num_layers == jcache.num_layers > 0
    # the limb planes are padded to each package's own block plan (the
    # reference's to its TPU tiles, 3 x Kp x Np; the port's to 3 x Kp x
    # d_out): the rest of the footprint, w_q and the scales, is the same
    limbs = sum(lyr.w_limbs.numel() for lyr in cache.layers)
    jlimbs = sum(lyr.w_limbs.size for lyr in jcache.layers)
    assert cache.weight_bytes() - limbs == jcache.weight_bytes() - jlimbs
    assert all(lyr.w_limbs.shape[2] == lyr.d_out for lyr in cache.layers)
    key = prng.PRNGKey(5)
    cache.prefetch(key)
    cache.prefetch(key, 1)
    assert cache.prefetched(key) and cache.prefetched(key, 1)
    cache.clear_prefetch()
    assert not cache.prefetched(key) and not cache.prefetched(key, 1)
    before = cache.factor_matmuls
    cache.take(key)                    # computed on the spot again
    assert cache.factor_matmuls == before + cache.num_layers
