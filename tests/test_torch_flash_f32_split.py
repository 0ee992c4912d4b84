"""The arithmetic of the float32 flash forward kernel, modelled on the CPU.

On the card the float32 forward (``csrc/flash_attention_f32.cu``) computes
S = Q K^T and O = P V on the tensor cores in 3xTF32: every operand x enters
as two tf32 values, big = tf32(x) and small = tf32(x - big) (``cvt.rna``:
10 mantissa bits, to nearest, ties away from zero), and each product is
three tf32 products, small x big + big x small + big x big, with float32
sums. P = exp2(S scale log2e - m) and the row sums stay float32. ``_model``
repeats those roundings in plain torch (a product of two tf32 values is
exact in float32, so a float32 einsum of the parts is the kernel's
arithmetic up to the order of its sums and its online rescaling), and on
numpy inputs from a seed this file holds it:

- within the card gates (2e-5 max abs, 1e-4 relative Frobenius, the lse
  within 1e-5) of the port's plain version (``flash_attention_plain``) and
  of the reference: its ``mha_ref`` and its flash core's lse
  (``repro.models.attention._flash_fwd_core``);
- within a quarter of each gate of the plain version and of the exact
  result (the same formula in float64): the margin on which the kernel
  ships this form;
- beside it the forms it does not ship, each error recorded in the test
  report (the junit XML's properties): one tf32 or one bf16 part, past the
  2e-5 gate at every case; and two bf16 parts (hi = bf16(x), lo = bf16(x -
  hi), three products at twice the tf32 rate), which hold 16 significant
  bits, so at the causal cases, whose first rows are one key's value, the
  output errs past a quarter of the max abs gate.
"""
import math

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ref import mha_ref as jmha_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_plain)

ABS_GATE, REL_GATE, LSE_GATE = 2e-5, 1e-4, 1e-5   # chip_smoke.py's float32
QUARTER = 0.25
LOG2E = 1.4426950408889634
NEG = -1e30
# (B, Sq, Skv, H, KH, D, Dv, causal, q in bf16 values)
CASES = [
    (2, 64, 64, 6, 2, 64, 64, True, False),        # causal, GQA
    (1, 64, 64, 4, 2, 128, 128, True, False),      # causal, D 128
    (1, 48, 80, 4, 1, 32, 32, False, False),       # non-causal, Sq != Skv
    (2, 1, 70, 8, 2, 128, 128, False, False),      # one query (decode)
    (1, 80, 80, 4, 4, 96, 64, True, False),        # MLA's (96, 64)
    (1, 64, 100, 8, 2, 128, 128, False, True),     # the VLM: bf16 q, f32 k/v
]
IDS = ["causal", "causal-d128", "ragged-48x80", "one-query", "mla-96-64",
       "vlm-bf16-q"]


def _tf32(x):
    """Round to tf32 as ``cvt.rna.tf32.f32``: 10 mantissa bits, to nearest,
    ties away from zero (on the int32 view: add half of the dropped 13
    bits' weight, clear them)."""
    b = x.contiguous().view(torch.int32)
    return ((b + 0x1000) & ~0x1fff).view(torch.float32)


def _bf16(x):
    return x.to(torch.bfloat16).to(torch.float32)


# form: (rounding, in two parts)
FORMS = {"3xtf32": (_tf32, True), "bf16_split": (_bf16, True),
         "tf32": (_tf32, False), "bf16": (_bf16, False)}


def _product(eq, a, b, form):
    """The einsum of a and b as the form's products: one, or small x big +
    big x small + big x big, summed in float32."""
    rnd, split = FORMS[form]
    ab, bb = rnd(a), rnd(b)
    if not split:
        return torch.einsum(eq, ab, bb)
    a_s, b_s = rnd(a - ab), rnd(b - bb)
    return (torch.einsum(eq, a_s, bb) + torch.einsum(eq, ab, b_s)
            + torch.einsum(eq, ab, bb))


def _model(q, k, v, causal, form="3xtf32"):
    """(out, lse) with the kernel's roundings: S from the form's products,
    the scores scaled by scale log2e in float32, masked to -1e30, P =
    exp2(x - max), its row sum l, O from P's and V's products over l, the
    lse m ln 2 + log l."""
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    qr = q.reshape(B, Sq, KH, H // KH, D)
    s = _product("bqhgd,bkhd->bqhgk", qr, k, form)
    sl2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) * LOG2E
    x = s * sl2
    if causal:
        seen = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        x = torch.where(seen[None, :, None, None, :], x, NEG)
    m = x.amax(-1, keepdim=True)
    p = torch.exp2(x - m)
    l = p.sum(-1, keepdim=True)
    o = _product("bqhgk,bkhd->bqhgd", p, v, form) / l
    lse = m[..., 0] * math.log(2.0) + torch.log(l[..., 0])
    return o.reshape(B, Sq, H, Dv), lse.reshape(B, Sq, H)


def _exact(q, k, v, causal):
    """(out, lse) of the same formula in float64."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    qr = q.double().reshape(B, Sq, KH, H // KH, D)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qr, k.double()) / math.sqrt(D)
    if causal:
        seen = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        s = s.masked_fill(~seen[None, :, None, None, :], float("-inf"))
    o = torch.einsum("bqhgk,bkhd->bqhgd", torch.softmax(s, -1), v.double())
    return o.reshape(B, Sq, H, -1), torch.logsumexp(s, -1).reshape(B, Sq, H)


def _inputs(case):
    B, Sq, Skv, H, KH, D, Dv, causal, bf16_q = case
    rng = np.random.default_rng(Sq + 7 * Skv + D + causal)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, Dv)))
    if bf16_q:      # bf16 queries promoted against float32 memory
        q = _bf16(torch.from_numpy(q)).numpy()
    return (q, k, v), causal


def _errors(got, want):
    """(max abs, relative Frobenius, lse max abs) of (out, lse) pairs."""
    o, lse = (t.double() for t in got)
    wo, wl = (torch.from_numpy(np.array(t, np.float64)) for t in want)
    return ((o - wo).abs().max().item(),
            ((o - wo).norm() / wo.norm()).item(),
            (lse - wl).abs().max().item())


def _reference(arrays, causal):
    """(out, lse) of the reference: ``mha_ref`` and its flash core's lse."""
    q, k, v = arrays
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    out = np.asarray(jmha_ref(*(jnp.asarray(a) for a in arrays),
                              causal=causal))
    _, lse = JA._flash_fwd_core(
        jnp.asarray(q).reshape(B, Sq, KH, H // KH, D), jnp.asarray(k),
        jnp.asarray(v), causal=causal, scale=1.0 / math.sqrt(D),
        kv_chunk=16 if Skv % 16 == 0 else Skv,
        q_chunk=16 if Sq % 16 == 0 else Sq)
    return out, np.asarray(lse).reshape(B, Sq, H)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_model_within_gates_of_plain_and_reference(case, request):
    arrays, causal = _inputs(case)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = _model(q, k, v, causal)
    assert got[0].dtype == torch.float32 and got[0].shape == (
        q.shape[:3] + (v.shape[-1],))
    for name, want in (
            ("plain", flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)),
            ("reference", _reference(arrays, causal))):
        err, rel, lse = _errors(got, want)
        request.node.user_properties += [(f"3xtf32_vs_{name}_max_abs", err),
                                         (f"3xtf32_vs_{name}_lse", lse)]
        assert err <= ABS_GATE and rel <= REL_GATE and lse <= LSE_GATE, (
            name, err, rel, lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_split_model_within_a_quarter_gate(case, request):
    """The margin on which 3xTF32 ships: a quarter of each gate, against
    the plain version and against the exact result."""
    arrays, causal = _inputs(case)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    got = _model(q, k, v, causal)
    for name, want in (
            ("plain", flash_attention_plain(q, k, v, causal=causal,
                                            return_lse=True)),
            ("exact", _exact(q, k, v, causal))):
        err, rel, lse = _errors(got, want)
        request.node.user_properties += [(f"3xtf32_vs_{name}_rel", rel)]
        assert (err <= QUARTER * ABS_GATE and rel <= QUARTER * REL_GATE
                and lse <= QUARTER * LSE_GATE), (name, err, rel, lse)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_one_part_forms_miss_the_gate(case, request):
    """One tf32 part (2^-11 relative a term) or one bf16 part (2^-9) puts
    the output past the 2e-5 gate: the reason the kernel splits."""
    arrays, causal = _inputs(case)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    plain = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    for form in ("tf32", "bf16"):
        err, rel, lse = _errors(_model(q, k, v, causal, form), plain)
        request.node.user_properties += [(f"{form}_vs_plain_max_abs", err),
                                         (f"{form}_vs_plain_rel", rel),
                                         (f"{form}_vs_plain_lse", lse)]
        assert err > ABS_GATE, (form, err)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_bf16_split_misses_a_quarter_gate_when_causal(case, request):
    """Two bf16 parts carry 16 significant bits: a causal block's first rows
    are one or a few keys' values, so their output keeps an error of ~2^-17
    |v|, past a quarter of the max abs gate (and the scores' past a quarter
    of the lse gate), where 3xTF32 stays inside. Elsewhere recorded only."""
    arrays, causal = _inputs(case)
    q, k, v = (torch.from_numpy(a) for a in arrays)
    plain = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    err, rel, lse = _errors(_model(q, k, v, causal, "bf16_split"), plain)
    request.node.user_properties += [("bf16_split_vs_plain_max_abs", err),
                                     ("bf16_split_vs_plain_rel", rel),
                                     ("bf16_split_vs_plain_lse", lse)]
    if causal:
        assert err > QUARTER * ABS_GATE and lse > QUARTER * LSE_GATE, (err,
                                                                        lse)
    tf32_err = _errors(_model(q, k, v, causal), plain)[0]
    assert tf32_err < err, (tf32_err, err)
