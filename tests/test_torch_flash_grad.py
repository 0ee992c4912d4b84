"""The port's attention gradient against the JAX reference on the CPU, on
the same numpy inputs.

Training differentiates ``sdpa`` through ``attention.FlashAttention``,
whose backward is ``flash_attention_bwd`` (on the CPU its plain version,
the materialized float32 formula). The reference differentiates its
attention core, a custom-VJP FlashAttention-2 (``_flash_core``) or the
plain softmax (``_naive_core``), with ``jax.vjp``:

- the port's (dq, dk, dv) against both reference cores, causal or not, G 1
  and 3, the (q/k, v) width pairs (32, 32), (64, 64) and (48, 32), and a
  ragged key length (the reference pads the keys and masks ``kv_len``;
  the port attends the unpadded keys): float32 within 1e-5 relative
  Frobenius (both sides sum in float32, in other orders);
- bf16 within a relative Frobenius of ``BF16_REL`` per gradient: each
  gradient is rounded to bf16 once (2^-9 relative), and the port's
  backward takes Drow = rowsum(dO * O) from the forward's bf16 output
  where the reference keeps its float32 one, an error of the same order
  that dS = P (dP - Drow) carries into dq and dk;
- the plain forward's log-sum-exp against ``_flash_fwd_core``'s within
  1e-5;
- the Function is entered only when grad is enabled and an input needs
  it; mixed dtypes (bf16 queries, float32 keys and values) promote as the
  reference's ``sdpa`` does, gradients included.
"""
import math

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd,
    flash_attention_plain)
from repro_torch.models import attention as A  # noqa: E402

F32_REL = 1e-5
BF16_REL = 8e-3
PAIRS = ((32, 32), (64, 64), (48, 32))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _inputs(seed, B, Sq, Skv, H, KH, D, Dv):
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dv)).astype(np.float32),
            rng.normal(size=(B, Sq, H, Dv)).astype(np.float32))


def _port_grads(q, k, v, dout, causal, dtype=torch.float32):
    """(out, dq, dk, dv) of the port's sdpa as float32 numpy."""
    qt, kt, vt = (torch.from_numpy(a).to(dtype).requires_grad_(True)
                  for a in (q, k, v))
    out = A.sdpa(qt, kt, vt, causal=causal)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    grads = torch.autograd.grad(out, (qt, kt, vt),
                                torch.from_numpy(dout).to(dtype))
    return [t.detach().to(torch.float32).numpy() for t in (out,) + grads]


def _ref_grads(q, k, v, dout, causal, core, kv_len=0, dtype=jnp.float32):
    """(out, dq, dk, dv) of the reference core through ``jax.vjp``; with
    ``kv_len`` the keys past it are padding the core masks."""
    B, Sq, H, D = q.shape
    KH = k.shape[2]
    G = H // KH
    scale = 1.0 / math.sqrt(D)

    def fn(qq, kk, vv):
        q5 = qq.reshape(B, Sq, KH, G, D)
        if core == "flash":
            o = JA._flash_core(q5, kk, vv, causal=causal, q_offset=0,
                               scale=scale, kv_chunk=16, q_chunk=16,
                               kv_len=kv_len)
        else:
            o = JA._naive_core(q5, kk, vv, causal=causal, q_offset=0,
                               scale=scale, kv_len=kv_len)
        return o.reshape(B, Sq, H, -1).astype(qq.dtype)

    out, vjp = jax.vjp(fn, *(jnp.asarray(a, dtype) for a in (q, k, v)))
    grads = vjp(jnp.asarray(dout, dtype))
    return [np.asarray(t.astype(jnp.float32)) for t in (out,) + tuple(grads)]


@pytest.mark.parametrize("core", ["flash", "naive"])
@pytest.mark.parametrize("D,Dv", PAIRS)
@pytest.mark.parametrize("H,KH", [(3, 3), (6, 2)])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_match_reference_cores(core, D, Dv, H, KH, causal):
    q, k, v, dout = _inputs(D + 7 * H + causal, 2, 48, 48, H, KH, D, Dv)
    got = _port_grads(q, k, v, dout, causal)
    want = _ref_grads(q, k, v, dout, causal, core)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= F32_REL, (name, _rel(g, w))


@pytest.mark.parametrize("core", ["flash", "naive"])
@pytest.mark.parametrize("causal", [True, False])
def test_grads_ragged_keys_match_reference_kv_len(core, causal):
    """The reference pads 40 keys to 48 and masks ``kv_len`` 40; the port
    attends the 40 keys (its kernel masks a ragged length itself)."""
    kv_len = 40
    q, k, v, dout = _inputs(11 + causal, 2, 48, 48, 6, 2, 64, 64)
    k[:, kv_len:] = 0.0
    v[:, kv_len:] = 0.0
    got = _port_grads(q, k[:, :kv_len], v[:, :kv_len], dout, causal)
    want = _ref_grads(q, k, v, dout, causal, core, kv_len=kv_len)
    np.testing.assert_array_equal(want[2][:, kv_len:], 0.0)
    np.testing.assert_array_equal(want[3][:, kv_len:], 0.0)
    want[2], want[3] = want[2][:, :kv_len], want[3][:, :kv_len]
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= F32_REL, (name, _rel(g, w))


@pytest.mark.parametrize("D,Dv", PAIRS)
@pytest.mark.parametrize("causal", [True, False])
def test_bf16_grads_within_bound(D, Dv, causal):
    q, k, v, dout = _inputs(D + causal, 2, 64, 64, 6, 2, D, Dv)
    got = _port_grads(q, k, v, dout, causal, torch.bfloat16)
    want = _ref_grads(q, k, v, dout, causal, "flash", dtype=jnp.bfloat16)
    for name, g, w in zip(("out", "dq", "dk", "dv"), got, want):
        assert _rel(g, w) <= BF16_REL, (name, _rel(g, w))


@pytest.mark.parametrize("D,Dv", PAIRS)
@pytest.mark.parametrize("causal", [True, False])
def test_plain_lse_matches_flash_fwd_core(D, Dv, causal):
    B, S, H, KH = 2, 64, 6, 3
    q, k, v, _ = _inputs(3 * D + causal, B, S, S, H, KH, D, Dv)
    out, lse = flash_attention_plain(torch.from_numpy(q), torch.from_numpy(k),
                                     torch.from_numpy(v), causal=causal,
                                     return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (B, S, H)
    jout, jlse = JA._flash_fwd_core(
        jnp.asarray(q).reshape(B, S, KH, H // KH, D), jnp.asarray(k),
        jnp.asarray(v), causal=causal, scale=1.0 / math.sqrt(D),
        kv_chunk=16, q_chunk=32)
    np.testing.assert_allclose(lse.numpy(),
                               np.asarray(jlse).reshape(B, S, H),
                               rtol=1e-5, atol=1e-5)
    np.testing.assert_allclose(out.numpy(),
                               np.asarray(jout).reshape(B, S, H, Dv),
                               rtol=1e-5, atol=1e-5)
    # the forward's output is the same with or without the lse
    assert torch.equal(out, flash_attention_fwd(
        torch.from_numpy(q), torch.from_numpy(k), torch.from_numpy(v),
        causal=causal))


def test_bwd_wrapper_takes_plain_version_on_cpu():
    q, k, v, dout = (torch.from_numpy(a) for a in
                     _inputs(5, 1, 20, 20, 4, 2, 32, 32))
    out, lse = flash_attention_fwd(q, k, v, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, dout)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout)
    for g, w in zip(got, want):
        assert torch.equal(g, w)
    # the plain backward is the formula, equal to autograd of the plain
    # forward
    qg, kg, vg = (t.clone().requires_grad_(True) for t in (q, k, v))
    auto = torch.autograd.grad(flash_attention_plain(qg, kg, vg), (qg, kg, vg),
                               dout)
    for g, w in zip(got, auto):
        assert _rel(g.numpy(), w.numpy()) <= F32_REL


def test_function_only_when_grad_is_needed():
    q, k, v, _ = (torch.from_numpy(a) for a in
                  _inputs(6, 1, 16, 16, 4, 2, 32, 32))
    assert A.sdpa(q, k, v).grad_fn is None
    qg = q.clone().requires_grad_(True)
    with torch.no_grad():
        assert A.sdpa(qg, k, v).grad_fn is None
    out = A.sdpa(qg, k, v)
    assert type(out.grad_fn).__name__ == "FlashAttentionBackward"
    assert torch.equal(out, A.sdpa(q, k, v))


def test_mixed_dtype_grads_match_reference_sdpa():
    """bf16 queries against float32 keys and values (the VLM's patches):
    both promote to float32 and cast the output to bf16."""
    q, k, v, dout = _inputs(9, 2, 40, 56, 6, 2, 64, 64)
    qt = torch.from_numpy(q).to(torch.bfloat16).requires_grad_(True)
    kt, vt = (torch.from_numpy(a).requires_grad_(True) for a in (k, v))
    out = A.sdpa(qt, kt, vt, causal=False)
    assert out.dtype == torch.bfloat16
    got = torch.autograd.grad(out, (qt, kt, vt),
                              torch.from_numpy(dout).to(torch.bfloat16))
    assert [g.dtype for g in got] == [torch.bfloat16, torch.float32,
                                      torch.float32]

    def fn(qq, kk, vv):
        return JA.sdpa(qq, kk, vv, causal=False)

    jout, vjp = jax.vjp(fn, jnp.asarray(q, jnp.bfloat16), jnp.asarray(k),
                        jnp.asarray(v))
    want = vjp(jnp.asarray(dout, jnp.bfloat16))
    assert _rel(out.float().detach().numpy(),
                np.asarray(jout.astype(jnp.float32))) <= BF16_REL
    for g, w in zip(got, want):
        assert _rel(g.float().numpy(), np.asarray(w.astype(jnp.float32))) \
            <= BF16_REL
