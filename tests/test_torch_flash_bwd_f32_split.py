"""The arithmetic of the float32 flash backward kernel, modelled on the CPU.

On the card the float32 backward (``csrc/flash_attention_bwd_f32.cu``)
computes S, dP, dV, dK and dQ on the tensor cores in 3xTF32: every operand
x enters as big = tf32(x) and small = tf32(x - big) (``cvt.rna``), and each
product is three tf32 products, small x big + big x small + big x big, with
float32 sums. The tensor cores' float32 sums are not rounded to nearest, so
the kernel keeps every chain short: each two k-steps of S and dP, each
16-query chunk's contribution to dV and dK and each key tile's to dQ are
summed from zero and merged into the running float32 sum by one rounded
add. ``_model``
repeats those roundings in plain torch: the splits of Q, K, V, dO, P and
dS; each tensor-core step (eight exact products added to the accumulator)
rounded toward zero; the merges, the probabilities and dS in float32, in
the kernel's order. On numpy inputs from a seed this file holds it:

- within a quarter of the card gates (relative Frobenius 1e-5 and max abs
  1e-5 of each gradient's largest magnitude, ``chip_smoke.py``'s float32
  ``BWD_REL_TOL`` and ``BWD_ABS_TOL``) of the port's plain backward
  (``flash_attention_bwd_plain``) and of ``jax.vjp`` of the reference's
  custom-VJP ``_flash_core`` in float32;
- beside it the forms the kernel does not ship, each error recorded in the
  test report (the junit XML's properties): one chain (every product of a
  gradient added into one running tensor-core sum, as the first float32
  forward did) and two bf16 parts (hi = bf16(x), lo = bf16(x - hi), 16
  significant bits), both further from the exact gradient than the
  kernel's form.
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

REL_GATE, ABS_GATE = 1e-5, 1e-5   # chip_smoke.py's float32 backward gates
QUARTER = 0.25
LOG2E = 1.4426950408889634
# (B, Sq, Skv, H, KH, D, Dv, causal, q in bf16 values)
CASES = [
    (1, 96, 96, 6, 2, 64, 64, True, False),        # causal, GQA
    (1, 64, 64, 4, 2, 128, 128, True, False),      # causal, D 128
    (1, 80, 80, 2, 2, 96, 64, True, False),        # MLA's (96, 64)
    (1, 48, 70, 4, 1, 64, 64, False, False),       # ragged, Sq != Skv
    (1, 70, 40, 4, 2, 32, 32, True, False),        # causal, Sq > Skv
    (1, 64, 100, 8, 2, 128, 128, False, True),     # the VLM: bf16 q, f32 k/v
]
IDS = ["causal-gqa", "causal-d128", "mla-96-64", "ragged-48x70",
       "causal-70x40", "vlm-bf16-q"]


def _tf32(x):
    """Round to tf32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest,
    ties away from zero (on the int32 view: add half of the dropped 13
    bits' weight, clear them)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1fff).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# form: (part rounding, a tensor-core step's depth, chains short)
FORMS = {"3xtf32": (_tf32, 8, True), "one_chain": (_tf32, 8, False),
         "bf16_split": (_bf16, 16, True)}


def _parts(x, rnd):
    big = rnd(x)
    return big, rnd(x - big)


def _toward_zero(x):
    """float64 -> float32 rounded toward zero."""
    f = x.to(torch.float32)
    over = f.double().abs() > x.abs()
    return torch.where(over, torch.nextafter(f, torch.zeros_like(f)), f)


def _add(acc, step):
    """One tensor-core step: the exact sum of its products added to the
    float32 accumulator, rounded toward zero."""
    return _toward_zero(acc.double() + step)


def _pad(x, dim, n):
    pad = -x.shape[dim] % n
    if not pad:
        return x
    shape = list(x.shape)
    shape[dim] = pad
    return torch.cat([x, x.new_zeros(shape)], dim)


def _scores(a, b, eq, rnd, depth, short):
    """The product a b over the last axis of both in three parts a step of
    ``depth`` (small x big, big x small, big x big), each two steps summed
    from zero and merged by one rounded add (``short``), or all in one
    chain; float32."""
    (ab, as_), (bb, bs) = _parts(a, rnd), _parts(b, rnd)
    width = a.shape[-1]
    total = torch.einsum(eq, a[..., :1], b[..., :1]).zero_()
    fresh = total.clone()
    for i, k0 in enumerate(range(0, width, depth)):
        sl = slice(k0, k0 + depth)
        for x, y in ((as_, bb), (ab, bs), (ab, bb)):
            term = torch.einsum(eq, x[..., sl].double(), y[..., sl].double())
            fresh = _add(fresh, term)
        if short and i % 2 == 1:
            total, fresh = total + fresh, torch.zeros_like(fresh)
    return total + fresh if short else fresh


def _merged(a, b, eq, axes, chunk, depth, rnd, short, groups=1):
    """sum over a's and b's ``axes`` (of a length that ``chunk`` divides)
    of a b as the kernel's dV / dK / dQ: each chunk's three products a step
    of ``depth`` summed from zero and merged by one rounded add into the
    running sum of its group (chunk c into group c % groups; the groups
    added in order at the end), or, not ``short``, every step into the
    group's running sum."""
    (ab, as_), (bb, bs) = _parts(a, rnd), _parts(b, rnd)
    sums = None
    for c, c0 in enumerate(range(0, a.shape[axes[0]], chunk)):
        fresh = None
        for k0 in range(c0, c0 + chunk, depth):
            idx = [[slice(None)] * t.ndim for t in (a, b)]
            for i, ax in zip(idx, axes):
                i[ax] = slice(k0, k0 + depth)
            for x, y in ((as_, bb), (ab, bs), (ab, bb)):
                term = torch.einsum(eq, x[tuple(idx[0])].double(),
                                    y[tuple(idx[1])].double())
                if sums is None:
                    sums = [torch.zeros(term.shape) for _ in range(groups)]
                if short:
                    fresh = _add(torch.zeros(term.shape) if fresh is None
                                 else fresh, term)
                else:
                    sums[c % groups] = _add(sums[c % groups], term)
        if short:
            sums[c % groups] = sums[c % groups] + fresh
    total = sums[0]
    for s in sums[1:]:
        total = total + s
    return total


def _model(q, k, v, out, lse, dout, causal, form="3xtf32"):
    """(dq, dk, dv) in float32 with the kernel's roundings (``FORMS``)."""
    rnd, depth, short = FORMS[form]
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    wide = D + Dv > 192
    # the kernel's chunks: pass 2 16 queries (two groups up to D + Dv 192),
    # pass 3 tiles of 32 keys (16 at D 128); zero rows past the ends
    n = 32
    qr = _pad(q.reshape(B, Sq, KH, G, D), 1, n)
    do = _pad(dout.reshape(B, Sq, KH, G, Dv), 1, n)
    kk, vv = _pad(k, 1, n), _pad(v, 1, n)
    Sp, Kp = qr.shape[1], kk.shape[1]
    scale = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32)
    sl2 = scale * torch.tensor(LOG2E, dtype=torch.float32)
    l2 = _pad((lse.reshape(B, Sq, KH, G) * torch.tensor(
        LOG2E, dtype=torch.float32)), 1, n)
    drow = _pad((dout * out).sum(-1).reshape(B, Sq, KH, G), 1, n)
    qpos, kpos = torch.arange(Sp)[:, None], torch.arange(Kp)[None, :]
    seen = (qpos < Sq) & (kpos < Skv)
    if causal:
        seen &= qpos >= kpos
    seen = seen[None, :, None, None, :]

    def probs(s, dp):
        x = (s.double() * sl2.double() - l2[..., None].double()).float()
        p = torch.where(seen, torch.exp2(x), 0.0)
        return p, p * (dp - drow[..., None]) * scale

    # pass 2: S^T = K Q^T and dP^T = V dO^T (K and V the A operands)
    eq_s = "bkhd,bqhgd->bqhgk"
    p, ds = probs(_scores(kk, qr, eq_s, rnd, depth, short),
                  _scores(vv, do, eq_s, rnd, depth, short))
    groups = 1 if wide else 2
    pt = p.permute(0, 3, 1, 2, 4).reshape(B, G * Sp, KH, Kp)   # heads outer
    dst = ds.permute(0, 3, 1, 2, 4).reshape(B, G * Sp, KH, Kp)
    dv = _merged(pt, do.permute(0, 3, 1, 2, 4).reshape(B, G * Sp, KH, Dv),
                 "bqhk,bqhd->bkhd", (1, 1), 16, depth, rnd, short, groups)
    dk = _merged(dst, qr.permute(0, 3, 1, 2, 4).reshape(B, G * Sp, KH, D),
                 "bqhk,bqhd->bkhd", (1, 1), 16, depth, rnd, short, groups)
    # pass 3: S = Q K^T and dP = dO V^T (Q and dO the A operands)
    eq_s = "bqhgd,bkhd->bqhgk"
    _, ds = probs(_scores(qr, kk, eq_s, rnd, depth, short),
                  _scores(do, vv, eq_s, rnd, depth, short))
    dq = _merged(ds, kk, "bqhgk,bkhd->bqhgd", (4, 1), 16 if wide else 32,
                 depth, rnd, short)
    return (dq[:, :Sq].reshape(B, Sq, H, D), dk[:, :Skv], dv[:, :Skv])


def _inputs(case):
    B, Sq, Skv, H, KH, D, Dv, causal, bf16_q = case
    rng = np.random.default_rng(Sq + 7 * Skv + D + causal)
    arrays = [rng.normal(size=s).astype(np.float32)
              for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, Dv),
                        (B, Sq, H, Dv))]
    if bf16_q:      # bf16 queries promoted against float32 memory
        arrays[0] = _bf16(torch.from_numpy(arrays[0])).numpy()
    q, k, v, dout = (torch.from_numpy(a) for a in arrays)
    out, lse = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    return arrays, (q, k, v, out, lse, dout), causal


def _reference(arrays, causal):
    """(dq, dk, dv) of ``jax.vjp`` of the reference's ``_flash_core`` in
    float32."""
    q, k, v, dout = arrays
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]

    def fn(qq, kk, vv):
        o = JA._flash_core(qq.reshape(B, Sq, KH, H // KH, D), kk, vv,
                           causal=causal, q_offset=0,
                           scale=1.0 / math.sqrt(D),
                           kv_chunk=JA._best_chunk(Skv, 16),
                           q_chunk=JA._best_chunk(Sq, 16), kv_len=0)
        return o.reshape(B, Sq, H, -1)

    _, vjp = jax.vjp(fn, *(jnp.asarray(a) for a in (q, k, v)))
    return [torch.from_numpy(np.array(g)) for g in vjp(jnp.asarray(dout))]


def _exact(arrays, causal):
    """(dq, dk, dv) of the same attention in float64."""
    q, k, v, dout = (torch.from_numpy(a).double() for a in arrays)
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qr = q.reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k) / math.sqrt(D)
    if causal:
        seen = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        s = s.masked_fill(~seen[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, -1)
    do = dout.reshape(B, Sq, KH, H // KH, -1)
    dp = torch.einsum("bqhgd,bkhd->bqhgk", do, v)
    ds = p * (dp - (p * dp).sum(-1, keepdim=True)) / math.sqrt(D)
    return (torch.einsum("bqhgk,bkhd->bqhgd", ds, k).reshape(B, Sq, H, D),
            torch.einsum("bqhgk,bqhgd->bkhd", ds, qr),
            torch.einsum("bqhgk,bqhgd->bkhd", p, do))


def _errors(got, want):
    """[(relative Frobenius, max abs over the largest |want|)] of each
    gradient."""
    out = []
    for g, w in zip(got, want):
        g, w = g.double(), w.double()
        out.append((((g - w).norm() / w.norm()).item(),
                    ((g - w).abs().max() / w.abs().max()).item()))
    return out


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_within_a_quarter_gate_of_plain_and_reference(case, request):
    """The margin on which the kernel ships 3xTF32 with short chains: a
    quarter of each card gate, against the plain backward and against the
    reference's custom VJP."""
    arrays, res, causal = _inputs(case)
    got = _model(*res, causal)
    for g, t in zip(got, res[:3]):
        assert g.dtype == torch.float32 and g.shape == t.shape
    for name, want in (("plain", flash_attention_bwd_plain(*res,
                                                           causal=causal)),
                       ("reference", _reference(arrays, causal))):
        for grad, (rel, ab) in zip(("dq", "dk", "dv"), _errors(got, want)):
            request.node.user_properties += [
                (f"3xtf32_{grad}_vs_{name}_rel", rel),
                (f"3xtf32_{grad}_vs_{name}_max_abs", ab)]
            assert rel <= QUARTER * REL_GATE and ab <= QUARTER * ABS_GATE, (
                name, grad, rel, ab)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_other_forms_err_more(case, request):
    """One chain a gradient and two bf16 parts, each recorded beside the
    kernel's form: both lie further from the exact gradient (the same
    formula in float64) than 3xTF32 with short chains, in every gradient."""
    arrays, res, causal = _inputs(case)
    exact = _exact(arrays, causal)
    plain = flash_attention_bwd_plain(*res, causal=causal)
    ship = _errors(_model(*res, causal), exact)
    for form in ("one_chain", "bf16_split"):
        got = _model(*res, causal, form)
        for grad, (rel, ab), (rel_p, ab_p), (rel_s, _) in zip(
                ("dq", "dk", "dv"), _errors(got, exact), _errors(got, plain),
                ship):
            request.node.user_properties += [
                (f"{form}_{grad}_vs_plain_rel", rel_p),
                (f"{form}_{grad}_vs_plain_max_abs", ab_p),
                (f"{form}_{grad}_vs_exact_rel", rel)]
            assert rel > rel_s, (form, grad, rel, rel_s)
