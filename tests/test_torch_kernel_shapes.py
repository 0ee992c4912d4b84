"""The plain versions of the tensor-core kernels against the JAX package on
the CPU, at the shapes those kernels serve on the main path.

- ``limb_matmul_planes_plain`` bit-for-bit against
  ``repro.kernels.limb_matmul.ref.field_matmul_ref`` and an int64 oracle at
  the SmolLM-135M tier-1 shapes (the widest decode factor 4x576x1536, the
  fold material 1536x576x2) and at a shape off every tile edge
  (129x96x65), on random field elements and on the field's extremes (the
  digits -128 and 127, the largest group sums);
- ``limb_matmul_planes_fused_plain`` bit-for-bit against the reference's
  ``limb_matmul_planes_fused`` (Pallas, interpret mode) and an int64 oracle
  with the same epilogue in numpy, at the SmolLM-135M decode op
  (4x576x1536) and off every tile edge (129x96x65), random and extreme,
  and for u drawn over the whole int32 range (the epilogue's sum wraps in
  int32 as the reference's does);
- ``limb_fold_planes_plain`` bit-for-bit against the reference's
  ``field_fold`` and an int64 oracle at the SmolLM-135M decode check
  (4x2112x2: [y | x] of the gate/up op, k = 2) and a VGG-16 width off the
  kernel's 128-row tile (129x704x2), random and extreme;
- ``flash_attention_plain`` against ``repro.kernels.flash_attention.ref.
  mha_ref`` at head dims 32 and 64, bf16 (2e-2: one bf16 rounding of the
  output on values of order 1) and float32 (2e-5: float32 on both sides,
  other summation orders), ragged lengths, Sq > Skv and Sq = 1.

The CUDA kernels are held against these plain versions on the card
(tests/test_torch_cuda.py, chip_smoke.py).
"""
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (the reference's ops need core first)
from repro.kernels.flash_attention.ref import mha_ref as jmha_ref  # noqa: E402
from repro.kernels.limb_matmul import ops as jops  # noqa: E402
from repro.kernels.limb_matmul import ref as jref  # noqa: E402
from repro.kernels.limb_matmul.limb_matmul import (  # noqa: E402
    limb_matmul_planes_fused as jlimb_matmul_planes_fused)
from repro_torch.kernels.flash_attention.flash_attention import (  # noqa: E402
    flash_attention_fwd, flash_attention_plain)
from repro_torch.kernels.limb_matmul import ops as tops  # noqa: E402
from repro_torch.kernels.limb_matmul.fold import (  # noqa: E402
    limb_fold_planes, limb_fold_planes_plain)
from repro_torch.kernels.limb_matmul.limb_matmul import (  # noqa: E402
    limb_matmul_planes, limb_matmul_planes_fused,
    limb_matmul_planes_fused_plain, limb_matmul_planes_plain)

P, HALF = jref.P, jref.HALF
# field elements whose balanced digits hit -128 and 127
EXTREMES = np.asarray([0, 1, P - 1, HALF, HALF + 1, P - 2, 128, P - 128,
                       32768, P - 32768], np.int32)


def _field(rng, shape, kind):
    if kind == "extreme":
        return rng.choice(EXTREMES, size=shape)
    return rng.integers(0, P, shape, dtype=np.int32)


@pytest.mark.parametrize("kind", ["random", "extreme"])
@pytest.mark.parametrize("M,K,N", [(4, 576, 1536),     # decode factor
                                   (1536, 576, 2),     # fold material ws
                                   (129, 96, 65)])     # off every tile edge
def test_limb_matmul_plain_matches_reference_and_int64(M, K, N, kind):
    rng = np.random.default_rng(M * 31 + K + N)
    x, w = _field(rng, (M, K), kind), _field(rng, (K, N), kind)
    Kp = tops.block_plan(M, K, N)[4]
    xl = tops.field_planes(torch.from_numpy(x), Kp)
    wl = tops.encode_weight_planes(torch.from_numpy(w))
    got = limb_matmul_planes_plain(xl, wl).numpy()
    oracle = (x.astype(np.int64) @ w.astype(np.int64)) % P
    np.testing.assert_array_equal(got, oracle)
    np.testing.assert_array_equal(
        got, np.asarray(jref.field_matmul_ref(jnp.asarray(x), jnp.asarray(w))))
    # a CPU tensor takes the plain version through the wrapper
    np.testing.assert_array_equal(limb_matmul_planes(xl, wl).numpy(), got)


def _oracle(x, w):
    return (x.astype(np.int64) @ w.astype(np.int64)) % P


@pytest.mark.parametrize("kind", ["random", "extreme"])
@pytest.mark.parametrize("M,K,N", [(4, 576, 1536),     # decode op (gate/up)
                                   (129, 96, 65)])     # off every tile edge
def test_fused_plain_matches_reference_and_int64(M, K, N, kind):
    rng = np.random.default_rng(M * 17 + K + N)
    x, w = _field(rng, (M, K), kind), _field(rng, (K, N), kind)
    u = _field(rng, (M, N), kind)
    scale = np.float32(3.1e-6)
    Kp = tops.block_plan(M, K, N)[4]
    xl = tops.field_planes(torch.from_numpy(x), Kp)
    wl = tops.encode_weight_planes(torch.from_numpy(w))
    ut, st = torch.from_numpy(u), torch.tensor(scale)
    got = limb_matmul_planes_fused_plain(xl, wl, ut, st).numpy()
    assert got.dtype == np.float32 and got.shape == (M, N)
    # the epilogue in numpy: signed((acc - u) mod p), one f32 multiply
    d = (_oracle(x, w) - u) % P
    s = np.where(d > HALF, d - P, d).astype(np.float32)
    np.testing.assert_array_equal(got, s * scale)
    # the reference's Pallas kernel on the same planes (one block: the
    # shapes are its exact fit)
    want = jlimb_matmul_planes_fused(
        jnp.asarray(xl.numpy()), jnp.asarray(wl.numpy()), jnp.asarray(u),
        jnp.full((1, 1), scale, jnp.float32), bm=M, bn=min(N, 256), bk=Kp,
        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    # a CPU tensor takes the plain version through the wrapper
    np.testing.assert_array_equal(
        limb_matmul_planes_fused(xl, wl, ut, st).numpy(), got)


# u past the field: the int32 extremes, values near them and near p
U_EXTREMES = np.asarray([-2 ** 31, -2 ** 31 + 1, -1, 0, P - 1, P, P + 1,
                         2 ** 31 - P, 2 ** 31 - P - 1, 2 ** 31 - 1,
                         -P, -P - 1], np.int64).astype(np.int32)


def wrapped_epilogue(acc, u, scale):
    """The reference's epilogue in numpy: mod(acc - u + p, p) with the sum
    wrapping in int32, signed, one f32 multiply."""
    d = (acc.astype(np.int64) - u.astype(np.int64) + P + 2 ** 31) \
        % 2 ** 32 - 2 ** 31
    d = d % P
    s = np.where(d > HALF, d - P, d).astype(np.float32)
    return s * np.float32(scale)


@pytest.mark.parametrize("u_kind", ["int32", "extreme"])
@pytest.mark.parametrize("M,K,N", [(4, 96, 128), (129, 96, 65)])
def test_fused_plain_matches_reference_for_any_int32_u(M, K, N, u_kind):
    """The fused epilogue reduces any int32 u exactly as the reference's
    ``jnp.mod(acc - u + P, P)`` in int32, wraparound included."""
    rng = np.random.default_rng(M * 5 + N)
    x, w = _field(rng, (M, K), "random"), _field(rng, (K, N), "random")
    if u_kind == "int32":
        u = rng.integers(-2 ** 31, 2 ** 31, (M, N), dtype=np.int64).astype(
            np.int32)
    else:
        u = rng.choice(U_EXTREMES, size=(M, N))
    scale = np.float32(3.1e-6)
    Kp = tops.block_plan(M, K, N)[4]
    xl = tops.field_planes(torch.from_numpy(x), Kp)
    wl = tops.encode_weight_planes(torch.from_numpy(w))
    ut, st = torch.from_numpy(u), torch.tensor(scale)
    got = limb_matmul_planes_fused_plain(xl, wl, ut, st).numpy()
    np.testing.assert_array_equal(got, wrapped_epilogue(_oracle(x, w), u,
                                                        scale))
    want = jlimb_matmul_planes_fused(
        jnp.asarray(xl.numpy()), jnp.asarray(wl.numpy()), jnp.asarray(u),
        jnp.full((1, 1), scale, jnp.float32), bm=M, bn=min(N, 256), bk=Kp,
        interpret=True)
    np.testing.assert_array_equal(got, np.asarray(want))
    if u_kind == "extreme":
        # near -2^31 the int32 sum wraps: an unwrapped (acc - u) mod p
        # would differ there
        naive = (_oracle(x, w) - u.astype(np.int64)) % P
        assert not np.array_equal(
            got, np.where(naive > HALF, naive - P, naive).astype(np.float32)
            * scale)


@pytest.mark.parametrize("kind", ["random", "extreme"])
@pytest.mark.parametrize("M,Kf,kf", [(4, 2112, 2),     # decode check
                                     (129, 704, 2)])   # VGG width, ragged
def test_fold_plain_matches_reference_and_int64(M, Kf, kf, kind):
    rng = np.random.default_rng(M * 13 + Kf + kf)
    y, s = _field(rng, (M, Kf), kind), _field(rng, (Kf, kf), kind)
    yl = tops.field_planes(torch.from_numpy(y), Kf)
    sl = tops.encode_weight_planes(torch.from_numpy(s))
    got = limb_fold_planes_plain(yl, sl).numpy()
    np.testing.assert_array_equal(got, _oracle(y, s))
    np.testing.assert_array_equal(
        got, np.asarray(jops.field_fold(jnp.asarray(y), jnp.asarray(s))))
    # a CPU tensor takes the plain version through the wrapper
    np.testing.assert_array_equal(limb_fold_planes(yl, sl).numpy(), got)


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal", [
    (2, 100, 100, 6, 3, 32, True),       # D 32, ragged
    (1, 130, 130, 9, 3, 64, True),       # smollm heads, ragged
    (1, 70, 40, 4, 2, 64, True),         # causal, Sq > Skv
    (2, 1, 50, 9, 3, 64, True),          # Sq = 1
    (2, 37, 90, 4, 1, 32, False),        # non-causal, one KV head
])
def test_flash_plain_matches_reference(dtype, tol, B, Sq, Skv, H, KH, D,
                                       causal):
    rng = np.random.default_rng(Sq * 13 + Skv + D)
    q, k, v = (rng.normal(size=s).astype(np.float32)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))
    jdtype = jnp.float32 if dtype == torch.float32 else jnp.bfloat16
    want = np.asarray(jmha_ref(*(jnp.asarray(a, jdtype) for a in (q, k, v)),
                               causal=causal).astype(jnp.float32))
    tq, tk, tv = (torch.from_numpy(a).to(dtype) for a in (q, k, v))
    got = flash_attention_plain(tq, tk, tv, causal=causal)
    assert got.dtype == dtype and got.shape == (B, Sq, H, D)
    np.testing.assert_allclose(got.float().numpy(), want, rtol=tol, atol=tol)
    # a CPU tensor takes the plain version through the wrapper
    assert torch.equal(flash_attention_fwd(tq, tk, tv, causal=causal), got)
