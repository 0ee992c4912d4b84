"""The port's cross-attention families against the JAX reference on the CPU:
Whisper-small (audio: an encoder, and decoder blocks with cross-attention
to its output) and Llama-3.2-Vision-11B (vlm: self blocks, and a gated
cross block over patch embeddings closing every group), at their smoke
configs, with the reference's ``init_params`` carried over by
``params_from_numpy``: ``cross_kv``, ``cross_attn_forward`` (also float32
memory against bf16 queries, which ``sdpa`` promotes) and
``cross_attn_cached``, each Whisper block and each VLM cross block;
``lm_defs``, the parameter counts, ``forward``, ``prefill`` /
``prefill_vlm`` and ``decode_step``, ``init_caches``; and open
``generate``'s refusal beside the reference's ``KeyError``.

The cross blocks' ``attn_gate`` and ``mlp_gate`` are zero at init, which
would multiply the cross-attention and its MLP by tanh(0) = 0: every test
sets them to non-zero values in both trees first.

Tolerances. In float32 every output is held to the reference's at 1e-4 x
max|ref|. In bf16, the configs' dtype, the two packages round at
different points (XLA:CPU's bf16 gelu, silu and exp are polynomial
approximations an ulp away from torch's on some elements; matmuls sum in
other orders), so bf16 outputs are held at a relative Frobenius error of
0.05 (measured: up to 0.012 for the smoke Llama-3.2-Vision's logits,
0.007 for Whisper's). Decode is held to the reference's decode at the same
bounds.

The reference's ``prefill_vlm`` pads its stacked self caches, (groups,
every - 1, B, S, KH, D), along dim 2, which is the batch and not the
sequence (ROADMAP Queue 3); the port pads the sequence. Its decode is
held to the reference's decode on the reference's prefill caches built
without that pad (``max_seq`` equal to the batch, so nothing is padded)
and padded along the sequence here.
"""
import dataclasses

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.core.attestation import measure_enclave as jmeasure  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import transformer as JT  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke  # noqa: E402
from repro_torch.core.attestation import measure_enclave  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import transformer as T  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402

F32_TOL = 1e-4
BF16_REL = 0.05
ARCHS = ("whisper_small", "llama3_2_vision_11b")
DTYPES = ("float32", "bfloat16")
# the full configs' parameter counts (the reference's)
FULL_COUNTS = {"llama3_2_vision_11b": 9_775_157_264,
               "whisper_small": 238_187_520}
B, S, S0 = 2, 16, 12          # batch, tokens, prompt of the decode tests
GATES = (0.7, -0.4)           # attn_gate, mlp_gate of every cross block


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _check(got, want, dtype):
    """float32: within 1e-4 x max|ref|; bf16: relative Frobenius 0.05."""
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    if dtype == "float32":
        np.testing.assert_allclose(got, want, rtol=0,
                                   atol=F32_TOL * np.abs(want).max())
    else:
        rel = np.linalg.norm(got - want) / np.linalg.norm(want)
        assert rel < BF16_REL, rel


def _memory_key(cfg):
    return "frames" if cfg.family == "audio" else "patches"


def _memory_len(cfg):
    return (cfg.encoder_seq_len if cfg.family == "audio"
            else cfg.vision_seq_len)


def _set_gates(jp):
    """Non-zero cross-block gates in the reference's tree (vlm)."""
    if "cross_groups" not in jp:
        return jp
    cg = dict(jp["cross_groups"])
    for name, g in zip(("attn_gate", "mlp_gate"), GATES):
        cg[name] = jnp.full_like(cg[name], g)
    return {**jp, "cross_groups": cg}


@pytest.fixture(scope="module", params=[(a, d) for a in ARCHS
                                        for d in DTYPES],
                ids=lambda p: f"{p[0]}-{p[1]}")
def model(request):
    """(arch, dtype, cfg, jcfg, reference params, port params, numpy
    batch): tokens (2, 16) and the memory from N(0, 0.1^2), as the
    reference's tests draw it."""
    arch, dtype = request.param
    cfg = get_smoke(arch).replace(dtype=dtype)
    jcfg = jget_smoke(arch).replace(dtype=dtype)
    jp = _set_gates(JM.init_params(jcfg, jax.random.PRNGKey(0)))
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    rng = np.random.default_rng(2)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (B, S)),
             _memory_key(cfg): (rng.standard_normal(
                 (B, _memory_len(cfg), cfg.d_model)) * 0.1).astype(
                     np.float32)}
    return arch, dtype, cfg, jcfg, jp, params, batch


def _jbatch(batch):
    return {k: jnp.asarray(v.astype(np.int32) if k == "tokens" else v)
            for k, v in batch.items()}


def _tbatch(batch):
    return {k: torch.from_numpy(np.array(v)).long() if k == "tokens"
            else torch.from_numpy(np.array(v)) for k, v in batch.items()}


def _block(jtree, tree, *index):
    """One block's parameters out of both stacked trees."""
    return (jax.tree.map(lambda a: a[index], jtree),
            T.layer_params(tree, index) if len(index) == 1
            else M._block(tree, *index))


def _xattn(model):
    """A cross-attention's parameters in both trees: Whisper's first
    decoder block's, or the VLM's first cross block's."""
    _, _, cfg, _, jp, params, _ = model
    if cfg.family == "audio":
        jb, tb = _block(jp["dec_blocks"], params["dec_blocks"], 0)
    else:
        jb, tb = _block(jp["cross_groups"], params["cross_groups"], 0)
    return jb["xattn"], tb["xattn"]


def _hidden(cfg, n, seed, dtype):
    x = (np.random.default_rng(seed).standard_normal(
        (B, n, cfg.d_model))).astype(np.float32)
    return jnp.asarray(x).astype(jnp.dtype(dtype)), \
        torch.from_numpy(x).to(M.torch_dtype(dtype))


def test_cross_kv(model):
    _, dtype, cfg, _, _, _, _ = model
    jx, tx = _xattn(model)
    jm, tm = _hidden(cfg, _memory_len(cfg), 3, dtype)
    jk, jv = JA.cross_kv(jx, jm, cfg)
    with torch.no_grad():
        k, v = A.cross_kv(tx, tm, cfg)
    assert k.dtype == tm.dtype
    _check(k, jk, dtype)
    _check(v, jv, dtype)


def test_cross_attn_forward(model):
    _, dtype, cfg, _, _, _, _ = model
    jx, tx = _xattn(model)
    jq, tq = _hidden(cfg, S, 4, dtype)
    jm, tm = _hidden(cfg, _memory_len(cfg), 5, dtype)
    want = JA.cross_attn_forward(jx, jq, jm, cfg)
    with torch.no_grad():
        got = A.cross_attn_forward(tx, tq, tm, cfg)
    assert got.dtype == tq.dtype
    _check(got, want, dtype)


def test_cross_attn_forward_float32_memory_against_bf16_queries(model):
    """The VLM's forward hands float32 patches to bf16 queries: k and v
    come out float32 and ``sdpa`` computes in float32, the output in the
    queries' dtype, as the reference's (the weights in either dtype: a
    projection casts them to its input's)."""
    _, _, cfg, _, _, _, _ = model
    jx, tx = _xattn(model)
    jq, tq = _hidden(cfg, S, 6, "bfloat16")
    jm, tm = _hidden(cfg, _memory_len(cfg), 7, "float32")
    want = JA.cross_attn_forward(jx, jq, jm, cfg)
    with torch.no_grad():
        k, _ = A.cross_kv(tx, tm, cfg)
        got = A.cross_attn_forward(tx, tq, tm, cfg)
    assert k.dtype == torch.float32 and got.dtype == torch.bfloat16
    assert want.dtype == jnp.bfloat16
    _check(got, want, "bfloat16")


def test_sdpa_promotes_mixed_dtypes():
    """bf16 queries against float32 keys and values, non-causal, a ragged
    key length: float32 arithmetic, the output bf16 (the reference's
    ``sdpa``, which pads 1601 keys to a tile multiple and masks them)."""
    rng = np.random.default_rng(8)
    q = rng.standard_normal((2, 8, 4, 32)).astype(np.float32)
    k, v = (rng.standard_normal((2, 300, 2, 32)).astype(np.float32)
            for _ in range(2))
    jq = jnp.asarray(q).astype(jnp.bfloat16)
    want = JA.sdpa(jq, jnp.asarray(k), jnp.asarray(v), causal=False)
    got = A.sdpa(torch.from_numpy(q).bfloat16(), torch.from_numpy(k),
                 torch.from_numpy(v), causal=False)
    assert got.dtype == torch.bfloat16
    _check(got, want, "bfloat16")
    np.testing.assert_allclose(_np(got), _np(want), rtol=0, atol=2 ** -7)


def test_cross_attn_cached(model):
    """A decode step's query against bf16 cross K/V (the caches' dtype)."""
    _, dtype, cfg, _, _, _, _ = model
    jx, tx = _xattn(model)
    jq, tq = _hidden(cfg, 1, 9, dtype)
    jm, tm = _hidden(cfg, _memory_len(cfg), 10, dtype)
    jk, jv = JA.cross_kv(jx, jm, cfg)
    jk, jv = jk.astype(jnp.bfloat16), jv.astype(jnp.bfloat16)
    want = JA.cross_attn_cached(jx, jq, jk, jv, cfg)
    with torch.no_grad():
        k, v = A.cross_kv(tx, tm, cfg)
        got = A.cross_attn_cached(tx, tq, k.bfloat16(), v.bfloat16(), cfg)
    _check(got, want, dtype)


def test_blocks(model):
    """Whisper's encoder block and its decoder block's forward, prefill
    and decode; the VLM's cross block, forward and against cached K/V."""
    _, dtype, cfg, _, jp, params, _ = model
    jx, tx = _hidden(cfg, S, 11, dtype)
    jm, tm = _hidden(cfg, _memory_len(cfg), 12, dtype)
    with torch.no_grad():
        if cfg.family == "vlm":
            jb, tb = _block(jp["cross_groups"], params["cross_groups"], 0)
            _check(T.vlm_cross_block_fwd(tb, tx, tm, cfg),
                   JT.vlm_cross_block_fwd(jb, jx, jm, cfg), dtype)
            jk, jv = JA.cross_kv(jb["xattn"], jm, cfg)
            k, v = A.cross_kv(tb["xattn"], tm, cfg)
            _check(T.vlm_cross_block_cached(tb, tx[:, :1], k, v, cfg),
                   JT.vlm_cross_block_cached(jb, jx[:, :1], jk, jv, cfg),
                   dtype)
            return
        jb, tb = _block(jp["enc_blocks"], params["enc_blocks"], 0)
        _check(T.encoder_block_fwd(tb, tm, cfg),
               JT.encoder_block_fwd(jb, jm, cfg), dtype)
        jb, tb = _block(jp["dec_blocks"], params["dec_blocks"], 1)
        _check(T.cross_decoder_block_fwd(tb, tx, tm, cfg),
               JT.cross_decoder_block_fwd(jb, jx, jm, cfg), dtype)
        got, cache = T.cross_decoder_block_prefill(tb, tx[:, :S0], tm, cfg)
        want, jcache = JT.cross_decoder_block_prefill(jb, jx[:, :S0], jm,
                                                      cfg)
        _check(got, want, dtype)
        _check(cache.k, jcache.k, dtype)
        _check(cache.v, jcache.v, dtype)
        # one decode step at position S0 against the prefill's cache
        pad = ((0, 0), (0, 4), (0, 0), (0, 0))
        jc = JA.KVCache(jnp.pad(jcache.k, pad), jnp.pad(jcache.v, pad))
        tc = A.KVCache(torch.nn.functional.pad(cache.k, (0, 0, 0, 0, 0, 4)),
                       torch.nn.functional.pad(cache.v, (0, 0, 0, 0, 0, 4)))
        jk, jv = JA.cross_kv(jb["xattn"], jm, cfg)
        k, v = A.cross_kv(tb["xattn"], tm, cfg)
        want, jc = JT.cross_decoder_block_decode(
            jb, jx[:, S0:S0 + 1], jk, jv, jc, jnp.int32(S0), cfg)
        got, tc = T.cross_decoder_block_decode(
            tb, tx[:, S0:S0 + 1], k, v, tc, S0, cfg)
        _check(got, want, dtype)
        _check(tc.k, jc.k, dtype)


def test_lm_defs_equal_the_reference(model):
    """Every leaf's name, shape and dtype (the gates and norms float32)."""
    _, _, cfg, jcfg, jp, params, _ = model
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    n = 0
    for path, leaf in flat:
        node = params
        for key in path:
            node = node[key.key]
        assert tuple(node.shape) == leaf.shape, path
        assert (node.dtype == torch.float32) == (leaf.dtype == jnp.float32), \
            path
        np.testing.assert_array_equal(_np(node), _np(leaf))
        n += 1
    assert n == len(jax.tree.leaves(jp)) == sum(
        1 for _ in _leaves(params))
    defs, jdefs = M.lm_defs(cfg), JT.lm_defs(jcfg)
    assert sorted(defs) == sorted(jdefs)
    if cfg.family == "vlm":
        assert params["cross_groups"]["attn_gate"].dtype == torch.float32
        assert tuple(params["self_groups"]["attn"]["wq"]["w"].shape[:2]) == (
            cfg.num_layers // cfg.cross_attn_every, cfg.cross_attn_every - 1)


def _leaves(tree):
    if isinstance(tree, dict):
        for k in tree:
            yield from _leaves(tree[k])
    else:
        yield tree


@pytest.mark.parametrize("arch", ARCHS)
def test_full_configs_and_counts(arch):
    """The published configs: JSON, aliases, the padded vocabulary and the parameter counts equal the
    reference's."""
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert cfg.to_json() == jcfg.to_json()
    assert get_smoke(arch).to_json() == jget_smoke(arch).to_json()
    assert get_config(cfg.name) is cfg and ALIASES[cfg.name] == arch
    assert M.count_params_analytic(cfg) == FULL_COUNTS[arch] \
        == JM.count_params_analytic(jcfg)
    if arch == "whisper_small":
        assert cfg.padded_vocab == 51968 and cfg.tie_embeddings
        assert cfg.rope_theta == 0.0


def test_measure_enclave_matches_reference(model):
    """The measurement of the smoke weights (the gates and norms float32)
    under the smoke config: its JSON, the partition and every leaf's
    bytes."""
    _, _, cfg, jcfg, jp, params, _ = model
    p = cfg.origami.tier1_layers
    got = measure_enclave(cfg, params, p, plan_digest="d")
    want = jmeasure(jcfg, jp, p, plan_digest="d")
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


def test_forward(model):
    _, dtype, cfg, jcfg, jp, params, batch = model
    want = JM.forward(jp, _jbatch(batch), jcfg).logits
    with torch.no_grad():
        got = M.forward(params, _tbatch(batch), cfg).logits
    assert got.shape == (B, S, cfg.padded_vocab)
    _check(got, want, dtype)


def test_forward_sees_the_memory(model):
    """The memory moves the logits (the gates are non-zero)."""
    _, _, cfg, _, _, params, batch = model
    other = dict(batch)
    key = _memory_key(cfg)
    other[key] = batch[key][::-1].copy()
    with torch.no_grad():
        a = M.forward(params, _tbatch(batch), cfg).logits
        b = M.forward(params, _tbatch(other), cfg).logits
    assert not torch.equal(a[0], b[0])


def _ref_prefill(jp, jb, jcfg):
    """The reference's prompt pass with caches of ``S`` positions: for the
    VLM ``max_seq`` = the batch (its pad, along the batch, does nothing),
    then the self caches padded along the sequence."""
    if jcfg.family == "audio":
        return JM.prefill(jp, jb, jcfg, max_seq=S)
    logits, caches = JM.prefill_vlm(jp, jb, jcfg, max_seq=B)
    pad = [(0, 0)] * 3 + [(0, S - S0), (0, 0), (0, 0)]
    return logits, {**caches, "self": jax.tree.map(
        lambda c: jnp.pad(c, pad), caches["self"])}


def test_prefill_and_decode(model):
    """The prompt pass on 12 tokens, then four decode steps fed the rest:
    each step's logits and the caches against the reference's."""
    _, dtype, cfg, jcfg, jp, params, batch = model
    jb, tb = _jbatch(batch), _tbatch(batch)
    jb["tokens"], tb["tokens"] = jb["tokens"][:, :S0], tb["tokens"][:, :S0]
    jl, jc = _ref_prefill(jp, jb, jcfg)
    with torch.no_grad():
        fill = M.prefill if cfg.family == "audio" else M.prefill_vlm
        tl, tc = fill(params, tb, cfg, max_seq=S)
    _check(tl, jl, dtype)
    assert tc["self"].k.shape == jc["self"].k.shape
    assert tc["cross_k"].dtype == tc["self"].k.dtype == torch.bfloat16
    # the caches are bf16 in either model dtype
    _check(tc["cross_k"], jc["cross_k"], "bfloat16")
    _check(tc["self"].v, jc["self"].v, "bfloat16")
    tokens = batch["tokens"]
    for t in range(S0, S):
        tok = tokens[:, t:t + 1]
        jl, jc = JM.decode_step(jp, jnp.asarray(tok.astype(np.int32)), jc,
                                jnp.int32(t), jcfg)
        with torch.no_grad():
            tl, tc2 = M.decode_step(params, torch.from_numpy(tok).long(), tc,
                                    t, cfg)
        assert tc2 is tc                      # written in place
        _check(tl, jl, dtype)
    _check(tc["self"].k, jc["self"].k, "bfloat16")


def test_reference_prefill_vlm_pads_the_batch_axis():
    """The fault this port does not copy: the reference's ``prefill_vlm``
    grows dim 2 of its (groups, every - 1, B, S, KH, D) self caches, the
    batch, to ``max_seq``."""
    jcfg = jget_smoke("llama3_2_vision_11b")
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    jb = {"tokens": jnp.zeros((B, S0), jnp.int32),
          "patches": jnp.zeros((B, jcfg.vision_seq_len, jcfg.d_model))}
    _, jc = JM.prefill_vlm(jp, jb, jcfg, max_seq=S)
    assert jc["self"].k.shape[2:4] == (S, S0)
    cfg = get_smoke("llama3_2_vision_11b")
    params = M.params_from_numpy(jax.tree.map(np.asarray, jp), cfg, "cpu")
    with torch.no_grad():
        _, tc = M.prefill_vlm(params, _tbatch(
            {k: np.asarray(v) for k, v in jb.items()}), cfg, max_seq=S)
    assert tuple(tc["self"].k.shape[2:4]) == (B, S)


@pytest.mark.parametrize("arch", ARCHS)
def test_init_caches_structure(arch):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jc = JM.init_caches(jcfg, B, S)
    tc = M.init_caches(cfg, B, S, device="cpu")
    assert sorted(tc) == sorted(jc)
    assert isinstance(tc["self"], A.KVCache)
    for name in ("cross_k", "cross_v"):
        assert tuple(tc[name].shape) == jc[name].shape
        assert tc[name].dtype == torch.bfloat16
    for got, want in zip(tc["self"], jc["self"]):
        assert tuple(got.shape) == want.shape and not got.any()


@pytest.mark.parametrize("arch", ARCHS)
def test_generate_refuses_as_the_reference_fails(arch):
    """The reference's open ``generate`` hands its prompt pass only the
    tokens and fails with ``KeyError`` on the memory; the port's refuses
    with that reason. ``generate_origami`` and private decode refuse as
    the reference's do."""
    from repro_torch.core import plan as PL
    from repro.core import plan as JPL
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    key = G.MEMORY_KEYS[cfg.family]
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    prompt = np.zeros((1, 4), np.int32)
    with pytest.raises(KeyError) as want:
        JG.generate(jp, jnp.asarray(prompt), jcfg, max_new_tokens=1)
    assert want.value.args == (key,)
    with pytest.raises(NotImplementedError, match=f"KeyError on '{key}'"):
        G.generate({}, prompt, cfg, max_new_tokens=1, device="cpu")
    with pytest.raises(AssertionError):
        JG.generate_origami(jp, jnp.asarray(prompt), jcfg, max_new_tokens=1)
    with pytest.raises(AssertionError):
        G.generate_origami({}, prompt, cfg, max_new_tokens=1, device="cpu")
    with pytest.raises(JPL.ScanExclusion) as jexc:
        JPL.make_decode_plan(jcfg, max_steps=2)
    with pytest.raises(PL.ScanExclusion) as exc:
        PL.make_decode_plan(cfg, max_steps=2)
    assert str(jexc.value).startswith(str(exc.value))
