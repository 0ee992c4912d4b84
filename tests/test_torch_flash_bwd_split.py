"""The arithmetic of the bf16 flash backward kernel, modelled on the CPU.

On the card the bf16 backward (``csrc/flash_attention_bwd.cu``) computes
S, dP, dV, dK and dQ on the tensor cores: products of bf16 values summed in
float32. P and dS enter dV = P^T dO, dK = dS^T Q and dQ = dS K in two bf16
parts, hi = bf16(x) and lo = bf16(x - hi), and each gradient is rounded to
bf16 once, at its store. ``_model_bwd`` repeats those roundings in plain
torch (every bf16 product is exact in float32, so a float32 einsum of the
parts is the kernel's arithmetic up to the order of its sums), and on
numpy inputs from a seed this file holds it:

- within the card gate's 8e-3 (relative Frobenius, each gradient) of the
  port's plain backward (``flash_attention_bwd_plain``) and of ``jax.vjp``
  of the reference's custom-VJP ``_flash_core`` in bf16;
- against the exact gradient (the plain formula on the same values with no
  rounding): the split model's error is the final bf16 rounding's alone,
  as large as the plain version's, and it differs from the plain version
  by final-rounding flips only;
- beside it the single-part model (P and dS in one bf16 part), whose error
  is recorded in the test report (the junit XML's properties) and lies
  above 1e-3 of the plain version: the reason the kernel ships the split.
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
    flash_attention_bwd_plain, flash_attention_plain)

GATE = 8e-3            # chip_smoke.py's BWD_REL_TOL in bf16
FLIPS = 5e-4           # split model vs the plain version: final-rounding flips
SINGLE_FLOOR = 1e-3    # the single part's error above which the split ships
LOG2E = 1.4426950408889634
# (B, Sq, Skv, H, KH, D, Dv, causal)
CASES = [(2, 64, 64, 6, 2, 64, 64, True),
         (2, 64, 64, 6, 2, 64, 64, False),
         (2, 80, 80, 4, 4, 48, 32, True),
         (1, 48, 80, 4, 1, 32, 32, False)]


def _np(t):
    return (t.float().numpy() if isinstance(t, torch.Tensor)
            else np.asarray(t)).astype(np.float64)


def _rel(got, want):
    got, want = _np(got), _np(want)
    return float(np.linalg.norm(got - want)
                 / max(np.linalg.norm(want), 1e-30))


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


def _parts(x, split):
    hi = _bf16(x)
    return (hi, _bf16(x - hi)) if split else (hi,)


def _model_bwd(q, k, v, out, lse, dout, causal, split=True):
    """(dq, dk, dv) in bf16 with the kernel's roundings: S and dP from bf16
    operands, P = exp2(S scale log2e - lse log2e), dS = P (dP - Drow)
    scale in float32; P^T and dS^T (dS) into dV and dK (dQ) in two bf16
    parts, or one when ``split`` is false; one bf16 rounding a gradient."""
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    scale = 1.0 / math.sqrt(D)
    qr = q.float().reshape(B, Sq, KH, G, D)
    do = dout.float().reshape(B, Sq, KH, G, Dv)
    kk, vv = k.float(), v.float()
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, kk)
    sl2 = torch.tensor(scale, dtype=torch.float32) * LOG2E
    p = torch.exp2(s * sl2 - lse.reshape(B, Sq, KH, G, 1) * LOG2E)
    if causal:
        seen = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        p = torch.where(seen[None, :, None, None, :], p, 0.0)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", do, vv)
    drow = (do * out.float().reshape(B, Sq, KH, G, Dv)).sum(-1)
    ds = p * (dp - drow[..., None]) * scale
    dv = sum(torch.einsum("bqhgk,bqhgd->bkhd", x, do)
             for x in _parts(p, split))
    dk = sum(torch.einsum("bqhgk,bqhgd->bkhd", x, qr)
             for x in _parts(ds, split))
    dq = sum(torch.einsum("bqhgk,bkhd->bqhgd", x, kk)
             for x in _parts(ds, split))
    return (dq.reshape(B, Sq, H, D).to(torch.bfloat16),
            dk.to(torch.bfloat16), dv.to(torch.bfloat16))


def _inputs(case):
    B, Sq, Skv, H, KH, D, Dv, causal = case
    rng = np.random.default_rng(Sq + 3 * D + causal)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, Dv),
                        (B, Sq, H, Dv))]
    q, k, v, dout = (torch.from_numpy(a).to(torch.bfloat16) for a in arrays)
    out, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    return arrays, (q, k, v, out, lse, dout), causal


def _reference_bf16(arrays, causal):
    """(dq, dk, dv) of ``jax.vjp`` of the reference's ``_flash_core`` in
    bf16, as float32 numpy."""
    q, k, v, dout = arrays
    B, Sq, H, D = q.shape
    KH = k.shape[2]

    def fn(qq, kk, vv):
        o = JA._flash_core(qq.reshape(B, Sq, KH, H // KH, D), kk, vv,
                           causal=causal, q_offset=0,
                           scale=1.0 / math.sqrt(D), kv_chunk=16,
                           q_chunk=16, kv_len=0)
        return o.reshape(B, Sq, H, -1).astype(qq.dtype)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a, jnp.bfloat16) for a in (q, k, v)))
    return [np.asarray(g.astype(jnp.float32))
            for g in vjp(jnp.asarray(dout, jnp.bfloat16))]


@pytest.mark.parametrize("case", CASES)
def test_split_model_within_gate_of_plain_and_reference(case):
    arrays, res, causal = _inputs(case)
    got = _model_bwd(*res, causal)
    plain = flash_attention_bwd_plain(*res, causal=causal)
    ref = _reference_bf16(arrays, causal)
    for name, g, p, r in zip(("dq", "dk", "dv"), got, plain, ref):
        assert g.dtype == torch.bfloat16
        assert _rel(g, p) <= GATE, (name, _rel(g, p))
        assert _rel(g, r) <= GATE, (name, _rel(g, r))


@pytest.mark.parametrize("case", CASES)
def test_split_error_is_the_final_rounding(case, request):
    """Against the exact gradient the split model errs as much as the plain
    version, whose only rounding is the gradient's bf16 store; the two
    differ by final-rounding flips."""
    _, res, causal = _inputs(case)
    q, k, v, out, lse, dout = res
    exact = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(),
                                      causal=causal)
    got = _model_bwd(*res, causal)
    plain = flash_attention_bwd_plain(*res, causal=causal)
    for name, g, p, e in zip(("dq", "dk", "dv"), got, plain, exact):
        request.node.user_properties.append((f"split_{name}_vs_exact",
                                             _rel(g, e)))
        assert _rel(g, e) <= 1.02 * _rel(p, e), (name, _rel(g, e),
                                                  _rel(p, e))
        assert _rel(g, p) <= FLIPS, (name, _rel(g, p))


@pytest.mark.parametrize("case", CASES)
def test_single_part_error_is_why_the_split_ships(case, request):
    """P and dS in one bf16 part put a 2^-9 relative error on every term:
    the gradients then lie more than 1e-3 from the plain version, and
    further from the exact gradient than the split's."""
    _, res, causal = _inputs(case)
    q, k, v, out, lse, dout = res
    exact = flash_attention_bwd_plain(q.float(), k.float(), v.float(),
                                      out.float(), lse, dout.float(),
                                      causal=causal)
    plain = flash_attention_bwd_plain(*res, causal=causal)
    split = _model_bwd(*res, causal)
    single = _model_bwd(*res, causal, split=False)
    for name, s1, s2, p, e in zip(("dq", "dk", "dv"), single, split, plain,
                                  exact):
        request.node.user_properties += [
            (f"single_{name}_vs_plain", _rel(s1, p)),
            (f"split_{name}_vs_plain", _rel(s2, p))]
        assert _rel(s1, p) > SINGLE_FLOOR, (name, _rel(s1, p))
        assert _rel(s1, p) <= GATE, (name, _rel(s1, p))
        assert _rel(s1, e) > 1.2 * _rel(s2, e), (name, _rel(s1, e),
                                                 _rel(s2, e))
