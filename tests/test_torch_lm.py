"""The port's dense GQA LMs (the smollm_135m, yi_9b and qwen2_5_14b smoke
configs, bf16) against the JAX reference on the CPU, on the same
parameters and token ids.

Both sides run bf16 activations with float32 norms, rope and attention
statistics, but round in other places (XLA fuses elementwise chains,
torch rounds each op) and sum in other orders, so hidden states differ by
a few bf16 ulps a layer. Logits are held to atol 3e-2 * max|ref| (about
eight bf16 ulps of the largest logit after four layers); the layer
functions in bf16 (rope, norms) to one bf16 ulp of their output (2^-8
relative), in float32 to 1e-5 (transcendentals and the mean's summation
order differ by a few float32 ulps).
"""
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.configs import get_config as jget_config  # noqa: E402
from repro.configs import get_smoke as jget_smoke  # noqa: E402
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke  # noqa: E402
from repro_torch.core import prng  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402

LOGIT_TOL = 3e-2
ULP = 2.0 ** -8


def _close(got, want, tol=LOGIT_TOL):
    got = np.asarray(got, np.float32)
    want = np.asarray(want, np.float32)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * np.abs(want).max())


def _f32(t):
    return t.to(torch.float32).numpy()


# the dense GQA configs and their parameter trees' leaf counts: embed,
# final norm, 9 block leaves, lm_head unless the embeddings are tied, and
# Qwen2.5's three QKV biases
LMS = {"smollm_135m": 11, "yi_9b": 12, "qwen2_5_14b": 15}


@pytest.fixture(scope="module", params=list(LMS))
def lm(request):
    arch = request.param
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    jp = JM.init_params(jcfg, jax.random.PRNGKey(0))
    npp = jax.tree.map(np.asarray, jp)
    params = M.params_from_numpy(npp, cfg, "cpu")
    tokens = np.random.default_rng(1).integers(
        0, cfg.vocab_size, (2, 6)).astype(np.int32)
    return cfg, jcfg, jp, params, tokens


def test_config_json_and_properties_match_reference():
    for get, jget in ((get_config, jget_config), (get_smoke, jget_smoke)):
        cfg, jcfg = get("smollm_135m"), jget("smollm_135m")
        assert cfg.to_json() == jcfg.to_json()
        assert cfg.resolved_head_dim == jcfg.resolved_head_dim
        assert cfg.padded_vocab == jcfg.padded_vocab
    assert get_config("smollm-135m") is get_config("smollm_135m")


def test_params_round_trip_and_tree(lm):
    cfg, _, jp, params, _ = lm
    again = M.params_from_numpy(M.params_to_numpy(params), cfg, "cpu")
    flat = jax.tree_util.tree_flatten_with_path(jp)[0]
    assert len(flat) == LMS[ALIASES[cfg.name]]
    for path, leaf in flat:
        keys = [p.key for p in path]
        got, back = params, again
        for k in keys:
            got, back = got[k], back[k]
        assert tuple(got.shape) == leaf.shape, keys
        assert got.dtype == (torch.float32 if leaf.dtype == jnp.float32
                             else torch.bfloat16), keys
        assert torch.equal(got, back), keys
        np.testing.assert_array_equal(_f32(got), np.asarray(leaf, np.float32))


def test_init_params_follows_the_definitions():
    cfg = get_smoke("smollm_135m")
    params = M.init_params(cfg, seed=0, device="cpu")
    blocks = params["blocks"]
    assert blocks["attn"]["wq"]["w"].shape == (4, 96, 96)
    assert blocks["attn"]["wk"]["w"].shape == (4, 96, 32)
    assert blocks["mlp"]["w_down"]["w"].dtype == torch.bfloat16
    assert blocks["ln1"]["scale"].dtype == torch.float32
    assert torch.equal(blocks["ln1"]["scale"], torch.ones(4, 96))
    # "scaled": std 1/sqrt(fan_in), the stacking axis excluded
    std = blocks["mlp"]["w_down"]["w"].float().std().item()
    assert abs(std * np.sqrt(192) - 1) < 0.05, std
    emb = params["embed"]["table"].float().std().item()
    assert abs(emb / 0.02 - 1) < 0.05, emb
    again = M.init_params(cfg, seed=0, device="cpu")
    assert torch.equal(again["embed"]["table"], params["embed"]["table"])


def test_forward_matches_reference(lm):
    cfg, jcfg, jp, params, tokens = lm
    got = M.forward(params, {"tokens": torch.from_numpy(tokens).long()},
                    cfg).logits
    want = JM.forward(jp, {"tokens": jnp.asarray(tokens)}, jcfg).logits
    assert got.dtype == torch.bfloat16
    _close(_f32(got), want)


def test_prefill_then_teacher_forced_decode_matches_reference(lm):
    cfg, jcfg, jp, params, tokens = lm
    S0, new = tokens.shape[1], 4
    feed = np.random.default_rng(2).integers(
        0, cfg.vocab_size, (2, new)).astype(np.int32)
    got, caches = M.prefill(params, {"tokens": torch.from_numpy(tokens)
                                     .long()}, cfg, max_seq=S0 + new)
    want, jcaches = JM.prefill(jp, {"tokens": jnp.asarray(tokens)}, jcfg,
                               max_seq=S0 + new)
    _close(_f32(got), want)
    assert caches.k.shape == jcaches.k.shape
    assert caches.k.dtype == torch.bfloat16
    _close(_f32(caches.k), jcaches.k)
    _close(_f32(caches.v), jcaches.v)
    for i in range(new):
        tok = feed[:, i:i + 1]
        got, caches = M.decode_step(params, torch.from_numpy(tok).long(),
                                    caches, S0 + i, cfg)
        want, jcaches = JM.decode_step(jp, jnp.asarray(tok), jcaches,
                                       jnp.int32(S0 + i), jcfg)
        _close(_f32(got), want)


def test_prefill_then_decode_continues_forward(lm):
    """Decoding the last prompt token against the cache of the rest gives
    the forward's last-position logits (the port against itself)."""
    cfg, _, _, params, tokens = lm
    t = torch.from_numpy(tokens).long()
    full = M.forward(params, {"tokens": t}, cfg).logits
    _, caches = M.prefill(params, {"tokens": t[:, :-1]}, cfg,
                          max_seq=t.shape[1])
    step, _ = M.decode_step(params, t[:, -1:], caches, t.shape[1] - 1, cfg)
    _close(_f32(step[:, 0]), _f32(full[:, -1]))


def test_open_generate_matches_reference_first_step(lm):
    cfg, jcfg, jp, params, tokens = lm
    got = G.generate(params, tokens, cfg, max_new_tokens=3, device="cpu")
    want = JG.generate(jp, jnp.asarray(tokens), jcfg, max_new_tokens=3)
    assert got.tokens.shape == (2, 9)
    np.testing.assert_array_equal(got.tokens[:, :6].numpy(), tokens)
    # greedy on random weights may diverge later; the first pick rarely
    # sits within a tolerance of a tie
    np.testing.assert_array_equal(got.tokens[:, 6].numpy(),
                                  np.asarray(want.tokens)[:, 6])
    # sampling: the same key chain draws the same tokens
    for seed in (0, 3):
        got = G.generate(params, tokens, cfg, max_new_tokens=4,
                         temperature=0.7, key=prng.PRNGKey(seed),
                         device="cpu")
        want = JG.generate(jp, jnp.asarray(tokens), jcfg, max_new_tokens=4,
                           temperature=0.7, key=jax.random.PRNGKey(seed))
        np.testing.assert_array_equal(got.tokens.numpy(),
                                      np.asarray(want.tokens))


@pytest.mark.parametrize("shape,theta", [((2, 7, 3, 32), 10000.0),
                                         ((1, 5, 9, 64), 500000.0)])
def test_rope_matches_reference(shape, theta):
    x = np.random.default_rng(7).normal(size=shape).astype(np.float32)
    pos = np.arange(shape[1])[None, :] + 3
    got = L.apply_rope(torch.from_numpy(x), torch.from_numpy(pos), theta)
    want = JL.apply_rope(jnp.asarray(x), jnp.asarray(pos), theta)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    gb = L.apply_rope(torch.from_numpy(x).bfloat16(), torch.from_numpy(pos),
                      theta)
    wb = JL.apply_rope(jnp.asarray(x, jnp.bfloat16), jnp.asarray(pos), theta)
    _close(_f32(gb), wb, tol=ULP)
    np.testing.assert_allclose(
        L.rope_freqs(shape[-1], theta).numpy(),
        np.asarray(JL.rope_freqs(shape[-1], theta)), rtol=1e-6)


@pytest.mark.parametrize("kind", ["rmsnorm", "layernorm"])
def test_norm_matches_reference(kind):
    rng = np.random.default_rng(8)
    x = (rng.normal(size=(2, 5, 96)) * 3).astype(np.float32)
    p = {"scale": rng.normal(size=(96,)).astype(np.float32),
         "bias": rng.normal(size=(96,)).astype(np.float32)}
    if kind == "rmsnorm":
        del p["bias"]
    assert set(L.norm_def(96, kind)) == set(p)
    tp = {k: torch.from_numpy(v) for k, v in p.items()}
    jp = {k: jnp.asarray(v) for k, v in p.items()}
    got = L.apply_norm(tp, torch.from_numpy(x), kind)
    want = JL.apply_norm(jp, jnp.asarray(x), kind)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), rtol=1e-5,
                               atol=1e-5)
    gb = L.apply_norm(tp, torch.from_numpy(x).bfloat16(), kind)
    wb = JL.apply_norm(jp, jnp.asarray(x, jnp.bfloat16), kind)
    assert gb.dtype == torch.bfloat16
    _close(_f32(gb), wb, tol=ULP)


@pytest.mark.parametrize("name", ["silu", "gelu", "relu"])
def test_activation_matches_reference(name):
    x = np.linspace(-6, 6, 97).astype(np.float32)
    got = L.activation(name)(torch.from_numpy(x)).numpy()
    want = np.asarray(JL.activation(name)(jnp.asarray(x)))
    np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6)


def test_tier1_cache_bytes_match_reference():
    cfg, jcfg = get_config("smollm_135m"), jget_config("smollm_135m")
    for batch, seq, p in ((4, 1040, None), (1, 64, 5)):
        assert (G.tier1_cache_bytes(cfg, batch, seq, p)
                == JG.tier1_cache_bytes(jcfg, batch, seq, p))
