"""The port's state-space blocks (models/ssm.py) against the JAX reference
(``repro.models.ssm``) on the CPU: the same numpy inputs through both;
and the two configs of the slice (Zamba2-1.2B, xLSTM-1.3B): their JSON,
aliases, ``SSMConfig``, parameter counts, enclave measurement and decode
state layouts against the reference's.

Tolerances. Where the reference's own tests state one it is used: 2e-3
for the chunked recurrence (5e-3 normalized) and 1e-5 for the conv cache
(tests/test_ssm.py). The blocks in float32 are held to 1e-4 relative to
the output's largest magnitude (einsum and cumsum orders differ between
XLA and torch; the mLSTM stabilizer is a closed form here, a tree of
max-plus pairs there); in bf16, the model dtype, to 3e-2 of it (the
tolerance of tests/test_torch_generate.py: a value rounded to bf16 at a
different point moves by an ulp of 2^-8). The stabilizer alone is held
to 1e-5 of its largest magnitude (its terms grow with the sequence).
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
from repro.models import layers as JL  # noqa: E402
from repro.models import model as JM  # noqa: E402
from repro.models import ssm as JS  # noqa: E402
from repro.runtime import generate as JG  # noqa: E402
from repro_torch.configs import ALIASES, get_config, get_smoke  # noqa: E402
from repro_torch.configs.base import SSMConfig  # noqa: E402
from repro_torch.core.attestation import measure_enclave  # noqa: E402
from repro_torch.models import layers as L  # noqa: E402
from repro_torch.models import model as M  # noqa: E402
from repro_torch.models import ssm as S  # noqa: E402
from repro_torch.runtime import generate as G  # noqa: E402

F32_TOL = 1e-4
BF16_TOL = 3e-2
_DT = {"float32": (torch.float32, jnp.float32),
       "bfloat16": (torch.bfloat16, jnp.bfloat16)}


def _np(x):
    if isinstance(x, torch.Tensor):
        return x.detach().to(torch.float32).numpy()
    return np.asarray(x, np.float32)


def _close(got, want, tol):
    got, want = _np(got), _np(want)
    assert got.shape == want.shape, (got.shape, want.shape)
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=tol * max(np.abs(want).max(), 1e-30))


def _recurrence_inputs(seed, Bsz, T, H, dk, dv, decay=1.0):
    rng = np.random.default_rng(seed)
    q, k = (rng.normal(size=(Bsz, T, H, dk)).astype(np.float32)
            for _ in range(2))
    v = rng.normal(size=(Bsz, T, H, dv)).astype(np.float32)
    log_a = (-np.abs(rng.normal(size=(Bsz, T, H))) * decay).astype(np.float32)
    b = np.abs(rng.normal(size=(Bsz, T, H))).astype(np.float32)
    return q, k, v, log_a, b


@pytest.mark.parametrize("Bsz,H,T,chunk", [(1, 1, 8, 8), (2, 3, 32, 8),
                                           (3, 2, 16, 32), (2, 4, 64, 16)])
@pytest.mark.parametrize("normalize", [False, True])
def test_chunked_linear_recurrence_matches_reference(Bsz, H, T, chunk,
                                                     normalize):
    """y and the final state (C, n), plain and normalized (the mLSTM's
    form, with a per-position floor)."""
    args = _recurrence_inputs(T * 10 + H, Bsz, T, H, 4, 6,
                              decay=0.1 if normalize else 1.0)
    floor = (np.exp(-np.abs(np.random.default_rng(T).normal(
        size=(Bsz, T, H)))).astype(np.float32) if normalize else None)
    kw = dict(chunk=chunk, normalize=normalize)
    y, (C, n) = S.chunked_linear_recurrence(
        *map(torch.from_numpy, args), den_floor=None if floor is None
        else torch.from_numpy(floor), **kw)
    jy, (jC, jn) = JS.chunked_linear_recurrence(
        *map(jnp.asarray, args), den_floor=None if floor is None
        else jnp.asarray(floor), **kw)
    tol = 5e-3 if normalize else 2e-3
    np.testing.assert_allclose(_np(y), _np(jy), rtol=tol, atol=tol)
    np.testing.assert_allclose(_np(C), _np(jC), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(n), _np(jn), rtol=2e-3, atol=2e-3)


def test_chunked_recurrence_asserts_chunk_divides_length():
    args = _recurrence_inputs(0, 1, 24, 1, 4, 4)
    with pytest.raises(AssertionError):
        S.chunked_linear_recurrence(*map(torch.from_numpy, args), chunk=16)


def test_chunked_recurrence_carries_an_initial_state():
    """Two halves with the state carried equal one pass over the whole."""
    q, k, v, log_a, b = map(torch.from_numpy,
                            _recurrence_inputs(5, 2, 32, 2, 4, 6))
    y, state = S.chunked_linear_recurrence(q, k, v, log_a, b, chunk=8)
    y1, st1 = S.chunked_linear_recurrence(q[:, :16], k[:, :16], v[:, :16],
                                          log_a[:, :16], b[:, :16], chunk=8)
    y2, st2 = S.chunked_linear_recurrence(q[:, 16:], k[:, 16:], v[:, 16:],
                                          log_a[:, 16:], b[:, 16:], chunk=8,
                                          init_state=st1)
    np.testing.assert_allclose(_np(torch.cat([y1, y2], 1)), _np(y),
                               rtol=2e-3, atol=2e-3)
    for a, b_ in zip(st2, state):
        np.testing.assert_allclose(_np(a), _np(b_), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("normalize", [False, True])
def test_linear_recurrence_step_matches_chunked(normalize):
    """``linear_recurrence_step`` repeated T times: its outputs and final
    state equal the chunked form's, the port's and the reference's."""
    Bsz, T, H, dk, dv = 2, 16, 2, 4, 6
    args = _recurrence_inputs(7, Bsz, T, H, dk, dv, decay=0.1)
    q, k, v, log_a, b = map(torch.from_numpy, args)
    state = (torch.zeros((Bsz, H, dk, dv)), torch.zeros((Bsz, H, dk)))
    jstate = (jnp.zeros((Bsz, H, dk, dv)), jnp.zeros((Bsz, H, dk)))
    ys, jys = [], []
    for t in range(T):
        y, state = S.linear_recurrence_step(
            q[:, t], k[:, t], v[:, t], torch.exp(log_a[:, t]), b[:, t],
            state, normalize=normalize)
        jy, jstate = JS.linear_recurrence_step(
            *(jnp.asarray(a[:, t]) for a in args[:3]),
            jnp.exp(jnp.asarray(args[3][:, t])), jnp.asarray(args[4][:, t]),
            jstate, normalize=normalize)
        ys.append(y)
        jys.append(jy)
    for a, b_ in zip(state, jstate):
        _close(a, b_, F32_TOL)
    _close(torch.stack(ys, 1), np.stack([_np(a) for a in jys], 1), F32_TOL)
    yc, (Cc, nc) = S.chunked_linear_recurrence(q, k, v, log_a, b, chunk=8,
                                               normalize=normalize)
    tol = 5e-3 if normalize else 2e-3
    np.testing.assert_allclose(_np(torch.stack(ys, 1)), _np(yc), rtol=tol,
                               atol=tol)
    np.testing.assert_allclose(_np(state[0]), _np(Cc), rtol=2e-3, atol=2e-3)
    np.testing.assert_allclose(_np(state[1]), _np(nc), rtol=2e-3, atol=2e-3)


@pytest.mark.parametrize("K", [1, 4])
def test_causal_conv1d_matches_reference(K):
    rng = np.random.default_rng(K)
    w = rng.normal(size=(K, 6)).astype(np.float32)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    y, cache = S.causal_conv1d(torch.from_numpy(w), torch.from_numpy(x))
    jy, jcache = JS.causal_conv1d(jnp.asarray(w), jnp.asarray(x))
    np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache), _np(jcache), rtol=1e-5, atol=1e-5)


def test_causal_conv1d_cache_matches_reference():
    """Token by token through the cache, as decode runs it: the same
    outputs as the full conv and as the reference's steps."""
    rng = np.random.default_rng(3)
    w = rng.normal(size=(4, 6)).astype(np.float32)
    x = rng.normal(size=(2, 12, 6)).astype(np.float32)
    full, _ = S.causal_conv1d(torch.from_numpy(w), torch.from_numpy(x))
    cache, jcache = torch.zeros((2, 3, 6)), jnp.zeros((2, 3, 6))
    outs = []
    for t in range(12):
        y, cache = S.causal_conv1d(torch.from_numpy(w),
                                   torch.from_numpy(x[:, t:t + 1]),
                                   cache=cache)
        jy, jcache = JS.causal_conv1d(jnp.asarray(w),
                                      jnp.asarray(x[:, t:t + 1]),
                                      cache=jcache)
        np.testing.assert_allclose(_np(y), _np(jy), rtol=1e-5, atol=1e-5)
        outs.append(y[:, 0])
    np.testing.assert_allclose(_np(torch.stack(outs, 1)), _np(full),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(_np(cache), _np(jcache), rtol=1e-5, atol=1e-5)


@pytest.mark.parametrize("S_len,m0_scale", [(1, 0.0), (37, 0.0), (256, 3.0)])
def test_stabilizer_scan_matches_associative_scan(S_len, m0_scale):
    """The closed form (cumsum + cummax) against the reference's
    ``lax.associative_scan`` and a sequential oracle."""
    rng = np.random.default_rng(S_len)
    f_log = -np.abs(rng.normal(size=(2, S_len, 3))).astype(np.float32)
    i_log = (2 * rng.normal(size=(2, S_len, 3))).astype(np.float32)
    m0 = (m0_scale * rng.normal(size=(2, 3))).astype(np.float32)
    got = S._stabilizer_scan(*map(torch.from_numpy, (f_log, i_log, m0)))
    want = JS._stabilizer_scan(*map(jnp.asarray, (f_log, i_log, m0)))
    _close(got, want, 1e-5)
    m, seq = m0.astype(np.float64), []
    for t in range(S_len):
        m = np.maximum(m + f_log[:, t], i_log[:, t])
        seq.append(m)
    _close(got, np.stack(seq, 1), 1e-5)


# -- the blocks at the smoke widths -------------------------------------------

def _block_params(defs, seed, dtype):
    """The reference's initializer for a block's definitions (JAX ParamDefs)
    -> (the reference's arrays, the port's tensors in each leaf's dtype)."""
    jp = JL.init_params(jax.random.PRNGKey(seed), defs, dtype[1])

    def walk(node, d):
        if JL.is_def(d):
            dt = torch.float32 if d.dtype is not None else dtype[0]
            return torch.from_numpy(np.array(node, np.float32)).to(dt)
        return {k: walk(node[k], d[k]) for k in d}
    return jp, walk(jp, defs)


def _input(shape, seed, dtype):
    x = np.random.default_rng(seed).normal(size=shape).astype(np.float32)
    return (torch.from_numpy(x).to(dtype[0]),
            jnp.asarray(x).astype(dtype[1]))


def _port_defs_carry_dtypes(port_defs, ref_defs):
    """The port's definitions have the reference's shapes and float32
    leaves."""
    def walk(a, b):
        if JL.is_def(b):
            assert tuple(a.shape) == tuple(b.shape), (a, b)
            assert (a.dtype is None) == (b.dtype is None), (a, b)
            return
        assert sorted(a) == sorted(b)
        for k in b:
            walk(a[k], b[k])
    walk(port_defs, ref_defs)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mamba2_forward_and_decode_match_reference(dtype):
    cfg, jcfg = get_smoke("zamba2_1_2b"), jget_smoke("zamba2_1_2b")
    dt, tol = _DT[dtype], F32_TOL if dtype == "float32" else BF16_TOL
    defs = JS.mamba2_defs(jcfg)
    _port_defs_carry_dtypes(S.mamba2_defs(cfg), defs)
    jp, p = _block_params(defs, 1, dt)
    x, jx = _input((2, 64, cfg.d_model), 2, dt)       # 2 chunks of 32
    _close(S.mamba2_forward(p, x, cfg), JS.mamba2_forward(jp, jx, jcfg), tol)
    state = S.mamba2_init_state(cfg, 2, device="cpu")
    jstate = JS.mamba2_init_state(jcfg, 2)
    for t in range(4):
        y, state = S.mamba2_decode(p, x[:, t:t + 1], state, cfg)
        jy, jstate = JS.mamba2_decode(jp, jx[:, t:t + 1], jstate, jcfg)
        _close(y, jy, tol)
    _close(state.ssm[0], jstate.ssm[0], tol)
    _close(state.conv, jstate.conv, tol)
    assert state.conv.dtype == dt[0]


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_mlstm_forward_and_decode_match_reference(dtype):
    cfg, jcfg = get_smoke("xlstm_1_3b"), jget_smoke("xlstm_1_3b")
    dt, tol = _DT[dtype], F32_TOL if dtype == "float32" else BF16_TOL
    defs = JS.mlstm_defs(jcfg)
    _port_defs_carry_dtypes(S.mlstm_defs(cfg), defs)
    jp, p = _block_params(defs, 3, dt)
    # the gates' biases are zero at init: draw them, so the bias path counts
    for g in ("w_igate", "w_fgate"):
        b = np.random.default_rng(len(g)).normal(
            size=p[g]["b"].shape).astype(np.float32)
        p[g]["b"] = torch.from_numpy(b).to(dt[0])
        jp[g]["b"] = jnp.asarray(b).astype(dt[1])
    x, jx = _input((2, 48, cfg.d_model), 4, dt)       # 3 chunks of 16
    _close(S.mlstm_forward(p, x, cfg), JS.mlstm_forward(jp, jx, jcfg), tol)
    state = S.mlstm_init_state(cfg, 2, device="cpu")
    jstate = JS.mlstm_init_state(jcfg, 2)
    for t in range(4):
        y, state = S.mlstm_decode(p, x[:, t:t + 1], state, cfg)
        jy, jstate = JS.mlstm_decode(jp, jx[:, t:t + 1], jstate, jcfg)
        _close(y, jy, tol)
    for a, b_ in zip(state, jstate):
        _close(a, b_, tol)


@pytest.mark.parametrize("dtype", ["float32", "bfloat16"])
def test_slstm_forward_with_carried_state_matches_reference(dtype):
    """Two calls, the second from the first's state (decode runs the sLSTM
    this way, one token a call)."""
    cfg, jcfg = get_smoke("xlstm_1_3b"), jget_smoke("xlstm_1_3b")
    dt, tol = _DT[dtype], F32_TOL if dtype == "float32" else BF16_TOL
    defs = JS.slstm_defs(jcfg)
    _port_defs_carry_dtypes(S.slstm_defs(cfg), defs)
    jp, p = _block_params(defs, 5, dt)
    b = np.random.default_rng(6).normal(
        size=p["w_gates"]["b"].shape).astype(np.float32)
    p["w_gates"]["b"] = torch.from_numpy(b).to(dt[0])
    jp["w_gates"]["b"] = jnp.asarray(b).astype(dt[1])
    x, jx = _input((2, 12, cfg.d_model), 7, dt)
    y1, st = S.slstm_forward(p, x[:, :9], cfg)
    jy1, jst = JS.slstm_forward(jp, jx[:, :9], jcfg)
    _close(y1, jy1, tol)
    y2, st = S.slstm_forward(p, x[:, 9:], cfg, state=st)
    jy2, jst = JS.slstm_forward(jp, jx[:, 9:], jcfg, state=jst)
    _close(y2, jy2, tol)
    for a, b_ in zip(st, jst):
        _close(a, b_, tol)
    init = S.slstm_init_state(cfg, 2, device="cpu")
    for a, b_ in zip(init, JS.slstm_init_state(jcfg, 2)):
        assert tuple(a.shape) == b_.shape and not a.any()


SLICE = ("zamba2_1_2b", "xlstm_1_3b")
# the parameter counts of the published configs (the reference's
# count_params_analytic), from the definitions alone
PARAMS = {"zamba2_1_2b": 1_153_536_128, "xlstm_1_3b": 1_986_863_440}


@pytest.mark.parametrize("arch", SLICE)
def test_dims_match_reference(arch):
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    for c, j in ((cfg, jcfg), (get_config(arch), jget_config(arch))):
        if c.family == "hybrid":
            assert S.mamba2_dims(c) == JS.mamba2_dims(j)
        else:
            assert S.mlstm_dims(c) == JS.mlstm_dims(j)
            assert S.slstm_dims(c) == JS.slstm_dims(j)


def test_softplus_and_log_sigmoid_match_jax():
    x = np.concatenate([np.linspace(-40, 40, 801),
                        [-1e4, -88.0, 0.0, 88.0, 1e4]]).astype(np.float32)
    np.testing.assert_allclose(_np(S.softplus(torch.from_numpy(x))),
                               _np(jax.nn.softplus(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    np.testing.assert_allclose(_np(S.log_sigmoid(torch.from_numpy(x))),
                               _np(jax.nn.log_sigmoid(jnp.asarray(x))),
                               rtol=1e-6, atol=1e-7)
    assert L.activation("gelu")(torch.tensor([1.0])).item() == pytest.approx(
        float(jax.nn.gelu(jnp.float32(1.0))), abs=1e-6)


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


def test_ssm_config_nests_as_the_reference():
    cfg = get_config("zamba2_1_2b")
    assert isinstance(cfg.ssm, SSMConfig)
    assert [f.name for f in dataclasses.fields(SSMConfig)] == [
        f.name for f in dataclasses.fields(type(jget_config(
            "zamba2_1_2b").ssm))]
    assert dataclasses.asdict(SSMConfig()) == dataclasses.asdict(
        type(jget_config("zamba2_1_2b").ssm)())
    assert get_config("yi_9b").ssm is None


@pytest.mark.parametrize("arch", SLICE)
def test_param_counts_match_reference(arch):
    cfg, jcfg = get_config(arch), jget_config(arch)
    assert M.count_params_analytic(cfg) == JM.count_params_analytic(jcfg) \
        == PARAMS[arch]
    smoke, jsmoke = get_smoke(arch), jget_smoke(arch)
    assert M.count_params_analytic(smoke) == JM.count_params_analytic(jsmoke)


@pytest.mark.parametrize("arch", SLICE)
def test_measure_enclave_matches_reference(arch):
    """The measurement of the smoke model's weights (bf16; norms and
    Mamba2's A_log, D, dt_bias float32) under the smoke and under the
    published config: the config JSON, the partition and every leaf's
    bytes."""
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
def test_init_caches_and_tier1_bytes_match_reference(arch):
    """The decode state of the smoke model: the reference's tree (Mamba2,
    mLSTM and sLSTM states stacked as the blocks, Zamba2's shared KV cache
    one a group), leaf for leaf in shape and dtype, all zero."""
    cfg, jcfg = get_smoke(arch), jget_smoke(arch)
    caches = M.init_caches(cfg, 2, 12, device="cpu")
    jcaches = JM.init_caches(jcfg, 2, 12)
    assert sorted(caches) == sorted(jcaches)
    got = jax.tree.leaves(jax.tree.map(
        lambda t: t, caches, is_leaf=lambda t: isinstance(t, torch.Tensor)),
        is_leaf=lambda t: isinstance(t, torch.Tensor))
    want = jax.tree.leaves(jcaches)
    assert [tuple(t.shape) for t in got] == [w.shape for w in want]
    assert [str(t.dtype).removeprefix("torch.") for t in got] == [
        str(w.dtype) for w in want]
    assert not any(t.any() for t in got)
    for c, jc in ((cfg, jcfg), (get_config(arch), jget_config(arch))):
        assert (G.tier1_cache_bytes(c, 4, 1040)
                == JG.tier1_cache_bytes(jc, 4, 1040))
