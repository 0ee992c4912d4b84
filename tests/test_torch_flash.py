"""The port's flash-attention plain version and attention functions against
the JAX reference on the CPU, on the same numpy inputs.

- ``flash_attention_plain`` (the kernel's plain version, which the wrapper
  takes for CPU tensors) against the reference's Pallas kernel in interpret
  mode and against ``mha_ref``, at the shapes of the reference's own kernel
  tests: float32 at 2e-5 (the reference's tolerance: both sides compute in
  float32, in other summation orders), bf16 at 2e-2 (one bf16 rounding of
  the output, 2^-8 relative, on values of order 1);
- ``sdpa`` against the reference's on both of its cores (the plain one
  for short sequences, the chunked online softmax above 512 queries);
- ``decode_sdpa`` against the reference's;
- head width 128 (Qwen3-MoE and Arctic) with 16 and 7 query heads a KV
  head: the plain version against the interpret-mode kernel and
  ``mha_ref``, ``sdpa`` against the reference's on both cores.
"""
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
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.flash_attention.ref import mha_ref  # noqa: E402
from repro_torch.models import attention as A  # noqa: E402

F32_TOL = 2e-5
BF16_TOL = 2e-2


def _qkv(rng, B, Sq, Skv, H, KH, D):
    return (rng.normal(size=(B, Sq, H, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32),
            rng.normal(size=(B, Skv, KH, D)).astype(np.float32))


def _t(a, dtype=torch.float32):
    return torch.from_numpy(a).to(dtype)


def _j(a, dtype=jnp.float32):
    return jnp.asarray(a, dtype)


@pytest.mark.parametrize("B,S,H,KH,D", [
    (2, 256, 8, 2, 64),      # GQA 4:1
    (1, 512, 4, 4, 128),     # MHA
    (2, 128, 6, 3, 32),      # odd head count
])
def test_plain_matches_interpret_kernel_and_mha_ref(B, S, H, KH, D):
    q, k, v = _qkv(np.random.default_rng(S + H), B, S, S, H, KH, D)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=True).numpy()
    kern = np.asarray(flash_attention(_j(q), _j(k), _j(v), causal=True,
                                      bq=64, bk=64, impl="interpret"))
    want = np.asarray(jmha_ref(_j(q), _j(k), _j(v), causal=True))
    np.testing.assert_allclose(got, kern, rtol=F32_TOL, atol=F32_TOL)
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, F32_TOL),
    (torch.bfloat16, jnp.bfloat16, BF16_TOL)])
def test_plain_dtypes(tdt, jdt, tol):
    q, k, v = _qkv(np.random.default_rng(3), 1, 128, 128, 4, 2, 64)
    got = flash_attention_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt))
    assert got.dtype == tdt
    want = np.asarray(flash_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                                      causal=True, bq=64, bk=64,
                                      impl="interpret"), np.float32)
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want, rtol=tol,
                               atol=tol)


def test_plain_non_causal():
    q, k, v = _qkv(np.random.default_rng(4), 1, 128, 128, 2, 2, 32)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=False).numpy()
    want = np.asarray(flash_attention(_j(q), _j(k), _j(v), causal=False,
                                      bq=64, bk=64, impl="interpret"))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


@pytest.mark.parametrize("Sq,Skv,causal", [(6, 6, True), (1000, 1000, True),
                                           (6, 70, False), (37, 37, False)])
def test_plain_ragged_gqa_matches_mha_ref(Sq, Skv, causal):
    """Lengths no tile divides (the kernel masks them; the TPU kernel
    asserted divisibility, so the oracle is the reference's mha_ref)."""
    q, k, v = _qkv(np.random.default_rng(Sq), 2, Sq, Skv, 9, 3, 64)
    got = flash_attention_plain(_t(q), _t(k), _t(v), causal=causal).numpy()
    want = np.asarray(jmha_ref(_j(q), _j(k), _j(v), causal=causal))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)


def test_wrapper_takes_plain_version_on_cpu():
    q, k, v = _qkv(np.random.default_rng(5), 1, 10, 10, 3, 1, 32)
    before = dict(KB.LAUNCHES)
    got = flash_attention_fwd(_t(q), _t(k), _t(v), causal=True)
    assert torch.equal(got, flash_attention_plain(_t(q), _t(k), _t(v)))
    assert KB.LAUNCHES == before          # no kernel launch on the CPU
    assert "flash_attention" in KB.KERNELS


@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, F32_TOL),
    (torch.bfloat16, jnp.bfloat16, BF16_TOL)])
def test_sdpa_matches_reference_on_both_cores(S, tdt, jdt, tol):
    """S = 64 takes the reference's plain core, S = 1024 its chunked
    online softmax (512-query chunks); both are the port's one function."""
    q, k, v = _qkv(np.random.default_rng(S), 1, S, S, 9, 3, 64)
    got = A.sdpa(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=True)
    want = np.asarray(JA.sdpa(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                              causal=True), np.float32)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=tol, atol=tol)


# (B, S, H, KH) at head width 128: G = 16 (Qwen3-MoE's 64 / 4 heads, cut
# to one KV head) and G = 7 (Arctic's 56 / 8, cut to two)
D128_HEADS = [(1, 128, 16, 1), (2, 128, 14, 2)]


@pytest.mark.parametrize("B,S,H,KH", D128_HEADS)
@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, F32_TOL),
    (torch.bfloat16, jnp.bfloat16, BF16_TOL)])
def test_plain_head_dim_128_matches_interpret_kernel(B, S, H, KH, causal,
                                                     tdt, jdt, tol):
    q, k, v = _qkv(np.random.default_rng(H + KH), B, S, S, H, KH, 128)
    got = flash_attention_plain(_t(q, tdt), _t(k, tdt), _t(v, tdt),
                                causal=causal)
    assert got.dtype == tdt and got.shape == (B, S, H, 128)
    kern = np.asarray(flash_attention(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                                      causal=causal, bq=64, bk=64,
                                      impl="interpret"), np.float32)
    want = np.asarray(jmha_ref(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                               causal=causal), np.float32)
    got = got.to(torch.float32).numpy()
    np.testing.assert_allclose(got, kern, rtol=tol, atol=tol)
    np.testing.assert_allclose(got, want, rtol=tol, atol=tol)


@pytest.mark.parametrize("B,H,KH", [(b, h, kh) for b, _, h, kh in D128_HEADS])
@pytest.mark.parametrize("S", [64, 1024])
@pytest.mark.parametrize("tdt,jdt,tol", [
    (torch.float32, jnp.float32, F32_TOL),
    (torch.bfloat16, jnp.bfloat16, BF16_TOL)])
def test_sdpa_head_dim_128_matches_reference(B, H, KH, S, tdt, jdt, tol):
    q, k, v = _qkv(np.random.default_rng(S + H), B, S, S, H, KH, 128)
    got = A.sdpa(_t(q, tdt), _t(k, tdt), _t(v, tdt), causal=True)
    want = np.asarray(JA.sdpa(_j(q, jdt), _j(k, jdt), _j(v, jdt),
                              causal=True), np.float32)
    assert got.dtype == tdt and got.shape == q.shape
    np.testing.assert_allclose(got.to(torch.float32).numpy(), want,
                               rtol=tol, atol=tol)


@pytest.mark.parametrize("pos,window", [(0, 0), (5, 0), (11, 0), (9, 4)])
def test_decode_sdpa_matches_reference(pos, window):
    rng = np.random.default_rng(pos + window)
    q = rng.normal(size=(2, 1, 9, 64)).astype(np.float32)
    ck = rng.normal(size=(2, 12, 3, 64)).astype(np.float32)
    cv = rng.normal(size=(2, 12, 3, 64)).astype(np.float32)
    got = A.decode_sdpa(_t(q), _t(ck), _t(cv), pos, window=window).numpy()
    want = np.asarray(JA.decode_sdpa(_j(q), _j(ck), _j(cv), jnp.int32(pos),
                                     window=window))
    np.testing.assert_allclose(got, want, rtol=F32_TOL, atol=F32_TOL)
