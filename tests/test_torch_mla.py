"""The port's Multi-head Latent Attention (MiniCPM3-4B) and the three
configs of its slice (Yi-9B, Qwen2.5-14B, MiniCPM3-4B) against the JAX
reference on the CPU, on the same numpy inputs and weights.

- ``_mla_qkv``, ``_mla_expand_kv``, ``mla_forward``, ``mla_prefill`` and
  ``mla_decode`` (absorbed and not) on the MiniCPM3 smoke config: float32
  at rtol 1e-5 (both sides compute in float32, in other summation orders;
  the atol is 1e-5 of the largest reference value, for entries near 0),
  bf16 at 3e-2 * max|ref| (bf16 rounds at other places in the two
  frameworks, see tests/test_torch_lm.py);
- the reference's own MLA tests (tests/test_attention.py) rerun on the
  port;
- the flash plain version and ``sdpa`` at MLA's value width apart from
  the query width, (48, 32) and (96, 64), against the reference's
  ``sdpa`` on both of its cores (the plain core for 64 queries, the
  chunked online softmax for 1024): float32 at 2e-5, bf16 at 2e-2 (the
  tolerances of tests/test_torch_flash.py);
- the MiniCPM3 smoke LM's forward, prefill and teacher-forced decode
  against the reference's (bf16, 3e-2 * max|ref|);
- ``to_json``, ``measure_enclave``, ``count_params_analytic``,
  ``tier1_cache_bytes`` and the cache layout of the three configs, full
  and smoke, equal to the reference's.
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import ALIASES as JALIASES  # noqa: E402
from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core.attestation import measure_enclave as jmeasure  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import MLAConfig  # noqa: E402
from repro_torch.core.attestation import measure_enclave  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    HEAD_DIMS, flash_attention_plain)
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402

ARCH = "minicpm3_4b"
SLICE = ("yi_9b", "qwen2_5_14b", "minicpm3_4b")
F32_RTOL = 1e-5
BF16_TOL = 3e-2
FLASH_TOL = {torch.float32: 2e-5, torch.bfloat16: 2e-2}
DTYPES = [(torch.float32, jnp.float32), (torch.bfloat16, jnp.bfloat16)]


def _close(got, want, tdt):
    got = got.to(torch.float32).numpy() if isinstance(got, torch.Tensor) \
        else np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    scale = np.abs(want).max()
    if tdt == torch.float32:
        np.testing.assert_allclose(got, want, rtol=F32_RTOL,
                                   atol=F32_RTOL * scale)
    else:
        np.testing.assert_allclose(got, want, rtol=0, atol=BF16_TOL * scale)


def _mla_params(cfg, tdt, jdt, seed=0):
    """One MLA layer's weights drawn with numpy (weights 1/sqrt(fan_in),
    norm scales 1 + 0.1 N(0, 1)) as the reference's jnp tree and the
    port's tensors, each in its definition's dtype."""
    rng = np.random.default_rng(seed)

    def leaf(d):
        if len(d.shape) == 1:
            a = 1.0 + 0.1 * rng.normal(size=d.shape)
        else:
            a = rng.normal(size=d.shape) / np.sqrt(d.shape[0])
        a = a.astype(np.float32)
        if d.dtype is not None:            # the float32 norm scales
            return jnp.asarray(a), torch.from_numpy(a)
        return jnp.asarray(a, jdt), torch.from_numpy(a).to(tdt)

    defs = A.mla_defs(cfg)
    pairs = {k: {n: leaf(d) for n, d in sub.items()} for k, sub in
             defs.items()}
    jp = {k: {n: v[0] for n, v in sub.items()} for k, sub in pairs.items()}
    tp = {k: {n: v[1] for n, v in sub.items()} for k, sub in pairs.items()}
    return jp, tp


def _x(shape, seed=1):
    return np.random.default_rng(seed).normal(size=shape).astype(np.float32)


@pytest.fixture(scope="module")
def cfgs():
    return get_smoke(ARCH), jget_smoke(ARCH)


@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_mla_qkv_and_expand_kv_match_reference(cfgs, tdt, jdt):
    cfg, jcfg = cfgs
    jp, tp = _mla_params(cfg, tdt, jdt)
    x = _x((2, 7, cfg.d_model))
    pos = np.arange(7)[None, :] + 2
    got = A._mla_qkv(tp, torch.from_numpy(x).to(tdt), cfg,
                     torch.from_numpy(pos))
    want = JA._mla_qkv(jp, jnp.asarray(x, jdt), jcfg, jnp.asarray(pos))
    m = cfg.mla
    shapes = [(2, 7, 4, m.qk_nope_head_dim), (2, 7, 4, m.qk_rope_head_dim),
              (2, 7, m.kv_lora_rank), (2, 7, m.qk_rope_head_dim)]
    for g, w, shape in zip(got, want, shapes):
        assert tuple(g.shape) == shape and g.dtype == tdt
        _close(g, w, tdt)
    k, v = A._mla_expand_kv(tp, got[2], got[3], cfg)
    jk, jv = JA._mla_expand_kv(jp, want[2], want[3], jcfg)
    assert k.shape == (2, 7, 4, m.qk_nope_head_dim + m.qk_rope_head_dim)
    assert v.shape == (2, 7, 4, m.v_head_dim)
    _close(k, jk, tdt)
    _close(v, jv, tdt)


@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_mla_forward_and_prefill_match_reference(cfgs, tdt, jdt):
    cfg, jcfg = cfgs
    jp, tp = _mla_params(cfg, tdt, jdt, seed=2)
    x = _x((2, 9, cfg.d_model), seed=3)
    xt, xj = torch.from_numpy(x).to(tdt), jnp.asarray(x, jdt)
    y = A.mla_forward(tp, xt, cfg)
    _close(y, JA.mla_forward(jp, xj, jcfg), tdt)
    yp, cache = A.mla_prefill(tp, xt, cfg)
    jyp, jcache = JA.mla_prefill(jp, xj, jcfg)
    assert cache.v is None and jcache.v is None
    m = cfg.mla
    assert cache.k.shape == (2, 9, m.kv_lora_rank + m.qk_rope_head_dim)
    assert torch.equal(yp, y)
    _close(yp, jyp, tdt)
    _close(cache.k, jcache.k, tdt)


@pytest.mark.parametrize("absorbed", [True, False])
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_mla_decode_matches_reference(cfgs, tdt, jdt, absorbed):
    cfg, jcfg = cfgs
    jp, tp = _mla_params(cfg, tdt, jdt, seed=4)
    m = cfg.mla
    S, pos = 10, 6
    x = _x((2, 1, cfg.d_model), seed=5)
    ck = 0.5 * _x((2, S, m.kv_lora_rank + m.qk_rope_head_dim), seed=6)
    cache = A.KVCache(torch.from_numpy(ck).to(tdt), None)
    y, out = A.mla_decode(tp, torch.from_numpy(x).to(tdt), cache, pos, cfg,
                          absorbed=absorbed)
    jy, jout = JA.mla_decode(jp, jnp.asarray(x, jdt),
                             JA.KVCache(jnp.asarray(ck, jdt), None),
                             jnp.int32(pos), jcfg, absorbed=absorbed)
    assert out is cache and out.v is None     # written in place
    assert y.dtype == tdt and y.shape == (2, 1, cfg.d_model)
    _close(y, jy, tdt)
    _close(out.k, jout.k, tdt)


def test_mla_absorbed_decode_matches_naive():
    """The reference's test_mla_absorbed_decode_matches_naive on the port:
    the weight-absorbed step equals the expanded one (bf16 weights,
    float32 activations)."""
    cfg = get_smoke(ARCH)
    params = M.init_params(cfg, 0, device="cpu")
    B, T = 1, 6
    x = torch.from_numpy(_x((B, 1, cfg.d_model), seed=1))
    blk = params["blocks"]["attn"]
    blk = {k: {n: t[0] for n, t in sub.items()} for k, sub in blk.items()}
    m = cfg.mla
    width = m.kv_lora_rank + m.qk_rope_head_dim
    ck = torch.from_numpy(_x((B, T, width), seed=2)) * 0.1
    y_abs, _ = A.mla_decode(blk, x, A.KVCache(ck.clone(), None), T - 1, cfg,
                            absorbed=True)
    y_nav, _ = A.mla_decode(blk, x, A.KVCache(ck.clone(), None), T - 1, cfg,
                            absorbed=False)
    np.testing.assert_allclose(y_abs.float().numpy(), y_nav.float().numpy(),
                               rtol=5e-2, atol=5e-2)


def test_mla_forward_matches_prefill():
    """The reference's test_mla_forward_matches_prefill on the port."""
    cfg = get_smoke(ARCH)
    params = M.init_params(cfg, 0, device="cpu")
    tokens = torch.from_numpy(np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 10)))
    full = M.forward(params, {"tokens": tokens}, cfg).logits
    last, caches = M.prefill(params, {"tokens": tokens}, cfg)
    assert caches.v is None
    np.testing.assert_allclose(last[:, 0].float().numpy(),
                               full[:, -1].float().numpy(), rtol=0.05,
                               atol=0.05)


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("D,Dv", [(48, 32), (96, 64)])
@pytest.mark.parametrize("tdt,jdt", DTYPES)
def test_sdpa_value_width_matches_reference(S, D, Dv, tdt, jdt):
    """S = 64 takes the reference's plain core, S = 1024 its chunked
    online softmax; the port's sdpa (the kernel's plain version on the
    CPU) is one function for both. The scale is 1/sqrt(D), the output
    takes v's width."""
    assert (D, Dv) in HEAD_DIMS
    rng = np.random.default_rng(S + D)
    B, H = 1, 4
    q = rng.normal(size=(B, S, H, D)).astype(np.float32)
    k = rng.normal(size=(B, S, H, D)).astype(np.float32)
    v = rng.normal(size=(B, S, H, Dv)).astype(np.float32)
    tq, tk, tv = (torch.from_numpy(a).to(tdt) for a in (q, k, v))
    got = A.sdpa(tq, tk, tv, causal=True)
    want = np.asarray(JA.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                              causal=True), np.float32)
    assert got.dtype == tdt and got.shape == (B, S, H, Dv)
    tol = FLASH_TOL[tdt]
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    plain = flash_attention_plain(tq, tk, tv, causal=False)
    jplain = np.asarray(JA.sdpa(*(jnp.asarray(a, jdt) for a in (q, k, v)),
                                causal=False), np.float32)
    np.testing.assert_allclose(plain.float().numpy(), jplain, rtol=tol,
                               atol=tol)


def test_sdpa_of_a_strided_value_view():
    """MLA's v is a view of the wkv_b projection: the plain version takes
    it as it is."""
    rng = np.random.default_rng(7)
    q = torch.from_numpy(rng.normal(size=(2, 12, 4, 48)).astype(np.float32))
    kv = torch.from_numpy(rng.normal(size=(2, 12, 4, 64)).astype(np.float32))
    k = torch.cat([kv[..., :32], q[..., :16]], dim=-1)
    v = kv[..., 32:]
    assert not v.is_contiguous()
    got = A.sdpa(q, k, v)
    np.testing.assert_array_equal(got.numpy(),
                                  A.sdpa(q, k, v.contiguous()).numpy())


@pytest.fixture(scope="module")
def mla_lm():
    cfg, jcfg = get_smoke(ARCH), jget_smoke(ARCH)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    return cfg, jcfg, jp, params, tokens


def test_params_tree_carries_the_latent_norms(mla_lm):
    cfg, _, jp, params, _ = mla_lm
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    # embed, final norm, lm head; ln1, ln2; five attention weights and the
    # two latent norms; three MLP weights
    assert len(flat) == 3 + 2 + 7 + 3
    for path, leaf in flat:
        got = params
        for p in path:
            got = got[p.key]
        assert tuple(got.shape) == leaf.shape
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(leaf, np.float32))
    attn = params["blocks"]["attn"]
    assert attn["q_norm"]["scale"].dtype == torch.float32
    assert attn["kv_norm"]["scale"].shape == (4, cfg.mla.kv_lora_rank)


def test_lm_forward_prefill_decode_match_reference(mla_lm):
    cfg, jcfg, jp, params, tokens = mla_lm
    t = torch.from_numpy(tokens).long()
    got = M.forward(params, {"tokens": t}, cfg).logits
    want = JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg).logits
    _close(got, want, torch.bfloat16)
    S0, new = tokens.shape[1], 3
    got, caches = M.prefill(params, {"tokens": t}, cfg, max_seq=S0 + new)
    want, jcaches = JM.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                               max_seq=S0 + new)
    assert caches.v is None and jcaches.v is None
    assert caches.k.shape == jcaches.k.shape and caches.k.dtype == \
        torch.bfloat16
    _close(got, want, torch.bfloat16)
    _close(caches.k, jcaches.k, torch.bfloat16)
    feed = np.random.default_rng(2).integers(0, cfg.vocab_size,
                                             (2, new)).astype(np.int32)
    for i in range(new):
        tok = feed[:, i:i + 1]
        got, caches = M.decode_step(params, torch.from_numpy(tok).long(),
                                    caches, S0 + i, cfg)
        want, jcaches = JM.decode_step(jp, jnp.asarray(tok), jcaches,
                                       jnp.int32(S0 + i), jcfg)
        _close(got, want, torch.bfloat16)
    _close(caches.k, jcaches.k, torch.bfloat16)


@pytest.mark.parametrize("arch", SLICE)
def test_config_json_and_aliases_match_reference(arch):
    for get, jget in ((get_smoke, jget_smoke), (get_config, jget_config)):
        cfg, jcfg = get(arch), jget(arch)
        assert cfg.to_json() == jcfg.to_json()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.padded_vocab == jcfg.padded_vocab
    aliases = {k: v for k, v in JALIASES.items() if v == arch}
    assert aliases and all(ALIASES[k] == v for k, v in aliases.items())
    assert all(get_config(k) is get_config(arch) for k in aliases)


def test_mla_config_nests_as_the_reference():
    cfg = get_config(ARCH)
    assert isinstance(cfg.mla, MLAConfig)
    assert dataclasses.asdict(cfg)["mla"] == dataclasses.asdict(
        jget_config(ARCH))["mla"]
    assert [f.name for f in dataclasses.fields(MLAConfig)] == [
        f.name for f in dataclasses.fields(type(jget_config(ARCH).mla))]
    assert MLAConfig() == cfg.mla            # the defaults are MiniCPM3's
    assert get_config("yi_9b").mla is None


# the parameter counts of the published configs (the reference's
# count_params_analytic), from the definitions alone
PARAMS = {"yi_9b": 8_829_407_232, "qwen2_5_14b": 14_770_033_664,
          "minicpm3_4b": 4_262_025_728}


@pytest.mark.parametrize("arch", SLICE)
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg) \
        == PARAMS[arch]
    smoke, jsmoke = get_smoke(arch), jget_smoke(arch)
    assert M.count_params_analytic(smoke) == JM.count_params_analytic(jsmoke)


@pytest.mark.parametrize("arch", SLICE)
def test_measure_enclave_matches_reference(arch):
    """The measurement of the smoke model's bf16 weights (norms float32)
    under the smoke and under the published config: the config JSON, the
    partition and every leaf's bytes."""
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    rng = np.random.default_rng(3)

    def walk(defs):
        if L.is_def(defs):
            a = rng.normal(size=defs.shape).astype(np.float32)
            return jnp.asarray(a, jnp.dtype(str(defs.dtype or cfg.dtype)
                                             .removeprefix("torch.")))
        return {k: walk(defs[k]) for k in defs}

    jp = walk(M.model_defs(cfg))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    for c, jc in ((cfg, jcfg), (get_config(arch), jget_config(arch))):
        p = c.origami.tier1_layers
        got = measure_enclave(c, params, p, plan_digest="d")
        want = jmeasure(jc, jp, p, plan_digest="d")
        assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("arch", SLICE)
def test_caches_and_tier1_bytes_match_reference(arch):
    for get, jget in ((get_smoke, jget_smoke), (get_config, jget_config)):
        cfg, jcfg = get(arch), jget(arch)
        for batch, seq, p in ((4, 1040, None), (1, 64, 2)):
            assert (G.tier1_cache_bytes(cfg, batch, seq, p)
                    == JG.tier1_cache_bytes(jcfg, batch, seq, p))
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    caches = M.init_caches(cfg, 2, 12, device="cpu")
    jcaches = JM.init_caches(jcfg, 2, 12)
    assert caches.k.shape == jcaches.k.shape
    assert (caches.v is None) == (jcaches.v is None) == (arch == ARCH)
    if caches.v is not None:
        assert caches.v.shape == jcaches.v.shape
    nbytes = sum(t.numel() * t.element_size() for t in caches
                 if t is not None)
    p = cfg.origami.tier1_layers
    assert nbytes * p // cfg.num_layers == G.tier1_cache_bytes(cfg, 2, 12)
