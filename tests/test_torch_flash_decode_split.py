"""The arithmetic of the bf16 flash forward's split-KV decode route, modelled
on the CPU.

On the card a bf16 call with at most ``DECODE_ROWS`` query rows a KV head
(Sq * G) takes ``csrc/flash_attention_decode.cu``: the keys are cut into
``decode_splits(...)`` splits of c = ceil(Skv / splits) keys; each split
gives every row its float32 (m, l, acc) (m the largest visible score in the
exp2 domain, l the sum of exp2(s - m), acc the unnormalised P V with P in
two bf16 parts, hi = bf16(P) and lo = bf16(P - hi), as the tensor cores
take it, and m = -1e30, l = 0, acc = 0 where the row sees no key of the
split); a second pass merges the splits in split order (M = max m, weights
exp2(m - M)) and rounds the output to bf16 once. ``_model`` repeats that
arithmetic in plain torch (a product of two bf16 values is exact in
float32, so float32 einsums are the kernel's arithmetic up to the order of
its sums). On numpy inputs from a seed this file holds it:

- within the card gates (chip_smoke.py's ``CROSS_FLASH_CASES``): 2e-2 max
  abs against the port's plain version (``flash_attention_plain``, bf16 out)
  and against the reference's Pallas kernel in interpret mode at Sq 1 (its
  tiling needs Skv <= 512 here, one key block) or, at the value width 64
  against q/k 96, the reference's ``mha_ref``; 8e-3 relative Frobenius
  against the exact result (float64); the lse within 1e-5 (``LSE_TOL``) of
  the plain version's and of the reference flash core's;
- before its one bf16 rounding, within 1e-5 relative Frobenius of the exact
  result: float32 sums and P's 16 significant bits, so the route's error is
  the output's rounding;
- empty trailing splits (Skv smaller than the split count gives) and rows
  that see no key of a split (causal, Sq > 1) change nothing beyond float32
  reordering (1e-6 relative against one split);
- the witness of the relative gate: the same arithmetic with each split's
  keys past its end in its last 32-key tile left unmasked (zero-filled, as
  the kernel's copies leave them) fails it.

``decode_splits`` itself is tested too: it reads shapes only, every split
holds a key, and it gives 0 (the prefill route) exactly for float32 or more
than 16 rows a KV head.
"""
import math

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro.kernels.flash_attention.ops import flash_attention  # noqa: E402
from repro.kernels.flash_attention.ref import mha_ref as jmha_ref  # noqa: E402
from repro.models import attention as JA  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    DECODE_CTAS, DECODE_MIN_KEYS, DECODE_ROWS, decode_splits,
    flash_attention_fwd, flash_attention_plain)

ABS_GATE, REL_GATE, LSE_GATE = 2e-2, 8e-3, 1e-5    # the card's bf16 gates
FLOAT_GATE = 1e-5     # before the bf16 rounding: float32 sums only
REORDER_GATE = 1e-6   # split counts compared: float32 reordering only
LOG2E = 1.4426950408889634
LN2 = 0.6931471805599453
NEG = -1e30
TILE = 32             # the kernel's keys a tile (the witness's padding)

# (B, Sq, Skv, H, KH, D, Dv, causal)
CASES = [
    (2, 1, 161, 4, 4, 64, 64, False),        # G 1, ragged
    (2, 1, 150, 8, 2, 128, 128, False),      # G 4, D 128, ragged
    (1, 1, 512, 16, 2, 128, 128, False),     # G 8, one reference key block
    (2, 1, 300, 8, 2, 64, 64, True),         # causal at one query
    (2, 1, 161, 8, 8, 96, 64, False),        # MLA's (96, 64)
    (1, 4, 100, 16, 4, 64, 64, True),        # Sq 4 G 4: the route's edge
    (2, 3, 40, 6, 2, 128, 128, True),        # causal, Sq 3, Skv < a split
]
IDS = ["g1-161", "g4-d128-150", "g8-512", "causal-one-query", "mla-96-64",
       "edge-16-rows", "causal-sq3"]
# the decode shapes of chip_smoke.py (plain version only: Skv past 512)
MAIN = [
    (4, 1, 1601, 32, 8, 128, 128, False),    # the VLM's cross decode
    (4, 1, 1500, 12, 12, 64, 64, False),     # Whisper's
    (4, 1, 1024, 32, 4, 128, 128, False),    # G 8 at D 128 (Yi's heads)
]


def _inputs(case, seed):
    B, Sq, Skv, H, KH, D, Dv, _ = case
    rng = np.random.default_rng(seed)
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, Dv)).astype(np.float32))


def _bf16(a):
    return torch.from_numpy(a).to(torch.bfloat16)


def _model(q, k, v, causal, splits, unmask_tail=False):
    """(bf16 output, the float32 output before its rounding, float32 lse)
    of the split pass and the combine on bf16 q, k, v. ``unmask_tail``:
    the fault the relative gate is held against (each split's keys past its
    end in its last tile of ``TILE`` keys, zero rows in the kernel's
    copies, seen)."""
    B, Sq, H, D = q.shape
    Skv, KH, Dv = k.shape[1], k.shape[2], v.shape[-1]
    G = H // KH
    qf = q.float().reshape(B, Sq, KH, G, D)
    kf, vf = k.float(), v.float()
    seen = torch.ones((Sq, Skv), dtype=torch.bool)
    if causal:
        seen = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
    sl2 = torch.tensor(1.0 / math.sqrt(D), dtype=torch.float32) \
        * torch.tensor(LOG2E, dtype=torch.float32)
    s = torch.einsum("bqhgd,bkhd->bqhgk", qf, kf) * sl2
    mask = seen[None, :, None, None, :]
    s = torch.where(mask, s, torch.tensor(NEG))
    chunk = -(-Skv // splits)
    parts = []                                   # (m, l, acc) a split
    for i in range(splits):
        lo, hi = min(i * chunk, Skv), min((i + 1) * chunk, Skv)
        ss, ms, vs = s[..., lo:hi], mask[..., lo:hi], vf[:, lo:hi]
        pad = -(hi - lo) % TILE if unmask_tail else 0
        if pad:
            ss = torch.cat([ss, ss.new_zeros(ss.shape[:-1] + (pad,))], -1)
            ms = torch.cat([ms, ms.new_ones(ms.shape[:-1] + (pad,))], -1)
            vs = torch.cat([vs, vs.new_zeros((B, pad, KH, Dv))], 1)
        m = (ss.amax(dim=-1) if ss.shape[-1]
             else torch.full((B, Sq, KH, G), NEG))
        p = torch.where(ms, torch.exp2(ss - m[..., None]), torch.tensor(0.0))
        hi = p.to(torch.bfloat16).float()
        lo = (p - hi).to(torch.bfloat16).float()
        acc = (torch.einsum("bqhgk,bkhd->bqhgd", hi, vs)
               + torch.einsum("bqhgk,bkhd->bqhgd", lo, vs))
        parts.append((m, p.sum(dim=-1), acc))
    M = torch.stack([m for m, _, _ in parts]).amax(dim=0)
    L = torch.zeros_like(M)
    O = torch.zeros((B, Sq, KH, G, Dv))
    for m, l, acc in parts:                      # in split order
        w = torch.exp2(m - M)
        L = L + w * l
        O = O + w[..., None] * acc
    out32 = (O * (1.0 / torch.clamp(L, min=1e-30))[..., None]).reshape(
        B, Sq, H, Dv)
    lse = (M * LN2 + torch.log(torch.clamp(L, min=1e-30))).reshape(B, Sq, H)
    return out32.to(torch.bfloat16), out32, lse


def _exact(q, k, v, causal):
    """The attention of the bf16 values in float64."""
    B, Sq, H, D = q.shape
    Skv, KH = k.shape[1], k.shape[2]
    G = H // KH
    s = torch.einsum("bqhgd,bkhd->bqhgk",
                     q.double().reshape(B, Sq, KH, G, D), k.double())
    s = s / math.sqrt(D)
    if causal:
        seen = torch.arange(Sq)[:, None] >= torch.arange(Skv)[None, :]
        s = s.masked_fill(~seen[None, :, None, None, :], float("-inf"))
    p = torch.softmax(s, dim=-1)
    out = torch.einsum("bqhgk,bkhd->bqhgd", p, v.double())
    return out.reshape(B, Sq, H, v.shape[-1])


def _rel(got, exact):
    return ((got.double() - exact).norm() / exact.norm()).item()


def _splits(case):
    """The kernel's split count: causal, over the band of keys the rows
    see (keys past the last row's position are in no split)."""
    B, Sq, Skv, H, KH = case[:5]
    return decode_splits(B, Sq, Skv, H, KH, torch.bfloat16, causal=case[-1])


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_within_the_card_gates(case):
    causal = case[-1]
    q, k, v = (_bf16(a) for a in _inputs(case, sum(case[:7])))
    splits = _splits(case)
    assert splits >= 1
    got, got32, lse = _model(q, k, v, causal, splits)
    plain, plain_lse = flash_attention_plain(q, k, v, causal=causal,
                                             return_lse=True)
    exact = _exact(q, k, v, causal)
    assert (got.float() - plain.float()).abs().max().item() <= ABS_GATE
    assert _rel(got, exact) <= REL_GATE
    assert _rel(got32, exact) <= FLOAT_GATE
    assert (lse - plain_lse).abs().max().item() <= LSE_GATE
    # the wrapper on a CPU tensor is the plain version, on either route
    assert torch.equal(flash_attention_fwd(q, k, v, causal=causal), plain)


@pytest.mark.parametrize("case", CASES, ids=IDS)
def test_model_matches_the_reference(case):
    """Against the reference: its Pallas kernel in interpret mode at one
    query and D = Dv (else its ``mha_ref``), and its flash core's lse."""
    B, Sq, Skv, H, KH, D, Dv, causal = case
    qn, kn, vn = _inputs(case, sum(case[:7]) + 1)
    q, k, v = _bf16(qn), _bf16(kn), _bf16(vn)
    got, _, lse = _model(q, k, v, causal, _splits(case))
    jq, jk, jv = (jnp.asarray(a, jnp.bfloat16) for a in (qn, kn, vn))
    if Sq == 1 and D == Dv:
        want = flash_attention(jq, jk, jv, causal=causal, impl="interpret")
    else:
        want = jmha_ref(jq, jk, jv, causal=causal)
    want = torch.from_numpy(np.array(want, np.float32))
    assert (got.float() - want).abs().max().item() <= ABS_GATE
    _, jlse = JA._flash_fwd_core(
        jq.reshape(B, Sq, KH, H // KH, D), jk, jv, causal=causal,
        scale=1.0 / math.sqrt(D), kv_chunk=Skv, q_chunk=Sq)
    jlse = torch.from_numpy(np.array(jlse, np.float32)).reshape(B, Sq, H)
    assert (lse - jlse).abs().max().item() <= LSE_GATE


@pytest.mark.parametrize("case", MAIN, ids=["vlm", "whisper", "g8-d128"])
def test_model_at_the_decode_shapes(case):
    """The route's split counts at chip_smoke.py's decode shapes (8, 5 and
    16 splits) against the plain version and the exact result."""
    q, k, v = (_bf16(a) for a in _inputs(case, case[2]))
    splits = _splits(case)
    assert splits == {1601: 8, 1500: 5, 1024: 16}[case[2]]
    got, got32, lse = _model(q, k, v, False, splits)
    plain, plain_lse = flash_attention_plain(q, k, v, causal=False,
                                             return_lse=True)
    exact = _exact(q, k, v, False)
    assert (got.float() - plain.float()).abs().max().item() <= ABS_GATE
    assert _rel(got, exact) <= REL_GATE
    assert _rel(got32, exact) <= FLOAT_GATE
    assert (lse - plain_lse).abs().max().item() <= LSE_GATE


@pytest.mark.parametrize("Sq,Skv,H,KH,causal,splits", [
    (1, 5, 4, 1, False, 4),      # chunk 2: the fourth split is empty
    (1, 1, 8, 2, False, 3),      # one key: two empty splits
    (4, 4, 16, 4, True, 4),      # causal: rows that see no key of a split
    (2, 9, 6, 3, True, 6),       # both
])
def test_empty_splits_change_nothing(Sq, Skv, H, KH, causal, splits):
    case = (2, Sq, Skv, H, KH, 64, 64, causal)
    q, k, v = (_bf16(a) for a in _inputs(case, Skv + splits))
    _, one32, one_lse = _model(q, k, v, causal, 1)
    _, got32, lse = _model(q, k, v, causal, splits)
    assert _rel(got32, one32.double()) <= REORDER_GATE
    assert (lse - one_lse).abs().max().item() <= LSE_GATE
    assert _rel(got32, _exact(q, k, v, causal)) <= FLOAT_GATE


@pytest.mark.parametrize("Skv", [161, 150, 1601, 1500])
def test_unmasked_tail_fails_the_relative_gate(Skv):
    """The fault the relative gate is for: each split's keys past its end
    in its last tile (zero rows) left unmasked scale every output by ~Skv /
    (Skv + the pads)."""
    case = (2, 1, Skv, 8, 2, 64, 64, False)
    q, k, v = (_bf16(a) for a in _inputs(case, Skv))
    bad, _, _ = _model(q, k, v, False, _splits(case), unmask_tail=True)
    assert _rel(bad, _exact(q, k, v, False)) > REL_GATE


def test_decode_splits_reads_shapes_only():
    """The same shapes give the same count whatever else holds (no card,
    no tensor is read)."""
    shapes = (4, 1, 1601, 32, 8, torch.bfloat16)
    assert decode_splits(*shapes) == decode_splits(*shapes) == 8
    assert decode_splits(B=4, Sq=1, Skv=1601, H=32, KH=8,
                         dtype=torch.bfloat16) == 8


@pytest.mark.parametrize("B,KH", [(1, 1), (1, 8), (4, 8), (4, 12), (2, 40),
                                  (64, 8), (300, 1)])
def test_every_split_holds_a_key(B, KH):
    for Skv in list(range(1, 300)) + [511, 512, 513, 1000, 1500, 1601, 4096,
                                      32768, 100003]:
        n = decode_splits(B, 1, Skv, KH, KH, torch.bfloat16)
        chunk = -(-Skv // n)
        assert 1 <= n and (n - 1) * chunk < Skv, (Skv, n)
        # at least DECODE_MIN_KEYS keys a split where there are two or more;
        # no more split CTAs than DECODE_CTAS
        assert n == 1 or Skv // n >= DECODE_MIN_KEYS
        assert n <= max(1, DECODE_CTAS // (B * KH))


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_decode_splits_is_zero_exactly_off_the_route(dtype):
    for Sq in (1, 2, 3, 4, 5, 8, 16, 17, 64):
        for G in (1, 2, 3, 4, 5, 8, 16):
            n = decode_splits(2, Sq, 700, 8 * G, 8, dtype)
            on_route = dtype == torch.bfloat16 and Sq * G <= DECODE_ROWS
            assert (n > 0) == on_route, (Sq, G, n)
