"""Field arithmetic of the port (kernels/limb_matmul, kernels/blind) held
bit-for-bit against the JAX reference and an int64 oracle, on the CPU.

On the CPU every kernel wrapper takes its plain PyTorch version; the CUDA
kernels themselves are held against those plain versions on the card
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
from repro.kernels.blind import ref as jblind  # noqa: E402
from repro.kernels.blind.blind import blind_encode_pallas  # noqa: E402
from repro.kernels.limb_matmul import ops as jops  # noqa: E402
from repro.kernels.limb_matmul import ref as jref  # noqa: E402
from repro_torch.kernels.blind import ref as tblind  # noqa: E402
from repro_torch.kernels.blind.blind import blind_encode  # noqa: E402
from repro_torch.kernels.limb_matmul import ops as tops  # noqa: E402
from repro_torch.kernels.limb_matmul import ref as tref  # noqa: E402

P, HALF = tref.P, tref.HALF
EXTREMES = np.asarray([0, 1, P - 1, HALF, HALF + 1, P - 2, 2], np.int32)


def _t(a):
    return torch.from_numpy(np.array(a))


def _oracle(x, w):
    return ((x.astype(np.int64) @ w.astype(np.int64)) % P).astype(np.int32)


def test_constants_match_reference():
    assert (tref.P, tref.HALF) == (jref.P, jref.HALF)
    for s, c in enumerate(tref.POW256):
        assert c == pow(256, s, P)


@pytest.mark.parametrize("fn", ["to_signed", "from_signed", "to_limbs",
                                "from_limbs_roundtrip"])
def test_limb_encoding_bit_equal(fn, rng):
    field = np.concatenate([EXTREMES, rng.integers(0, P, 50_000,
                                                   dtype=np.int32)])
    signed = np.concatenate([np.asarray([0, 1, -1, HALF, -HALF, 128, -129,
                                         32767, -32768], np.int32),
                             rng.integers(-HALF, HALF + 1, 50_000,
                                          dtype=np.int32)])
    if fn == "to_signed":
        got = tref.to_signed(_t(field)).numpy()
        want = np.asarray(jref.to_signed(jnp.asarray(field)))
        np.testing.assert_array_equal(
            got, np.where(field > HALF, field.astype(np.int64) - P, field))
    elif fn == "from_signed":
        got = tref.from_signed(_t(signed)).numpy()
        want = np.asarray(jref.from_signed(jnp.asarray(signed)))
        np.testing.assert_array_equal(got, signed.astype(np.int64) % P)
    elif fn == "to_limbs":
        got = tref.to_limbs(_t(signed)).numpy()
        want = np.asarray(jref.to_limbs(jnp.asarray(signed)))
        assert got.dtype == np.int8
    else:
        got = tref.from_limbs(tref.to_limbs(_t(signed))).numpy()
        want = signed
    np.testing.assert_array_equal(got, want)


def test_limb_roundtrip_bulk(rng):
    s = rng.integers(-HALF, HALF + 1, size=(200_000,), dtype=np.int32)
    np.testing.assert_array_equal(tref.from_limbs(tref.to_limbs(_t(s))).numpy(),
                                  s)


def test_mod_mul_pow256_and_add_sub(rng):
    y = np.concatenate([EXTREMES, rng.integers(0, P, 1000, dtype=np.int32)])
    z = rng.integers(0, P, y.shape, dtype=np.int32)
    for k in range(5):
        got = tref.mod_mul_pow256(_t(y), k).numpy()
        np.testing.assert_array_equal(
            got, np.asarray(jref.mod_mul_pow256(jnp.asarray(y), k)))
        np.testing.assert_array_equal(got, (y.astype(np.int64) * 256 ** k) % P)
    np.testing.assert_array_equal(
        tref.field_add(_t(y), _t(z)).numpy(),
        np.asarray(jref.field_add(jnp.asarray(y), jnp.asarray(z))))
    np.testing.assert_array_equal(
        tref.field_sub(_t(y), _t(z)).numpy(),
        np.asarray(jref.field_sub(jnp.asarray(y), jnp.asarray(z))))


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (7, 5, 7), (33, 300, 9),
                                   (16, 2000, 4)])
def test_field_matmul_ref_bit_equal(M, K, N, rng):
    """K = 2000 is past the reference's float32-exact bound (it switches to
    int dots there); the port's float64 products are exact either way."""
    x = rng.integers(0, P, (M, K), dtype=np.int32)
    w = rng.integers(0, P, (K, N), dtype=np.int32)
    got = tref.field_matmul_ref(_t(x), _t(w)).numpy()
    np.testing.assert_array_equal(
        got, np.asarray(jref.field_matmul_ref(jnp.asarray(x), jnp.asarray(w))))
    np.testing.assert_array_equal(got, _oracle(x, w))


def test_extreme_field_values():
    x = np.asarray([[0, 1, P - 1, HALF, HALF + 1]], np.int32)
    w = np.asarray([[P - 1], [1], [P - 1], [HALF], [2]], np.int32)
    np.testing.assert_array_equal(tops.field_matmul(_t(x), _t(w)).numpy(),
                                  _oracle(x, w))


@pytest.mark.parametrize("k_bits", [6, 8, 12])
def test_blind_oracles_bit_equal(k_bits, rng):
    x = (rng.normal(size=(37, 300)) * 3).astype(np.float32)
    x[0, :6] = [0.5 / 2 ** k_bits, 1.5 / 2 ** k_bits, -2.5 / 2 ** k_bits,
                1e9, -1e9, 0.0]                    # ties and clipping
    r = rng.integers(0, P, x.shape, dtype=np.int32)
    jx, jr = jnp.asarray(x), jnp.asarray(r)
    np.testing.assert_array_equal(tblind.quantize(_t(x), k_bits).numpy(),
                                  np.asarray(jblind.quantize(jx, k_bits)))
    np.testing.assert_array_equal(tblind.blind_ref(_t(x), _t(r), k_bits).numpy(),
                                  np.asarray(jblind.blind_ref(jx, jr, k_bits)))
    y = rng.integers(0, P, x.shape, dtype=np.int32)
    np.testing.assert_array_equal(
        tblind.unblind_ref(_t(y), _t(r), k_bits + 7).numpy(),
        np.asarray(jblind.unblind_ref(jnp.asarray(y), jr, k_bits + 7)))
    inv = np.float32(1.0 / 2.7)
    np.testing.assert_array_equal(
        tblind.blind_encode_ref(_t(x), _t(r), torch.tensor(inv), k_bits).numpy(),
        np.asarray(jblind.blind_encode_ref(jx, jr, inv, k_bits)))


def test_blind_encode_matches_pallas_interpret(rng):
    """The wrapper's plain version against the TPU kernel itself, run in
    Pallas interpret mode (small shape: interpretation is slow)."""
    M, K = 300, 72
    x = (rng.normal(size=(M, K)) * 3).astype(np.float32)
    r = rng.integers(0, P, (M, K), dtype=np.int32)
    inv = np.float32(1.0 / 2.7)
    want = np.asarray(blind_encode_pallas(
        jnp.asarray(x), jnp.asarray(r), jnp.asarray(inv).reshape(1, 1), 8,
        bm=M, bk=K, interpret=True))
    got = blind_encode(_t(x), _t(r), torch.tensor(inv), 8, 96)
    assert tuple(got.shape) == (3, M, 96)
    np.testing.assert_array_equal(got[:, :, :K].numpy(), want)
    assert not got[:, :, K:].any()


def test_block_plan_pads_only_k():
    for M, K, N in [(1, 27, 64), (200704, 576, 64), (5, 1152, 128)]:
        bm, bn, bk, Mp, Kp, Np = tops.block_plan(M, K, N)
        assert (Mp, Np) == (M, N) and Kp % bk == 0 and K <= Kp < K + bk
        assert tops.block_plan(7, K, N)[3:] == (7, Kp, N)


def test_encode_weight_planes_match_reference(rng):
    w = rng.integers(0, P, (27, 64), dtype=np.int32)
    got = tops.encode_weight_planes(_t(w)).numpy()
    want = np.asarray(jops.encode_weight_planes(jnp.asarray(w)))
    assert got.shape == (3, 32, 64)
    np.testing.assert_array_equal(got[:, :27], want[:, :27, :64])
    assert not got[:, 27:].any()


@pytest.mark.parametrize("M,K,N", [(300, 72, 8), (256, 1152, 64)])
def test_field_matmul_bit_equal(M, K, N, rng):
    x = rng.integers(0, P, (M, K), dtype=np.int32)
    w = rng.integers(0, P, (K, N), dtype=np.int32)
    got = tops.field_matmul(_t(x), _t(w)).numpy()
    np.testing.assert_array_equal(got, np.asarray(jops.field_matmul(
        jnp.asarray(x), jnp.asarray(w), impl="ref")))
    np.testing.assert_array_equal(got, _oracle(x, w))


@pytest.mark.parametrize("M,K,N", [(300, 72, 8), (256, 1152, 64)])
def test_fused_blinded_matmul_bit_equal(M, K, N, rng):
    """The fused chain (blind_encode + fused limb matmul) against the
    reference's fused op; the small shape also against interpreted Pallas."""
    x = rng.normal(size=(M, K)).astype(np.float32)
    r = rng.integers(0, P, (M, K), dtype=np.int32)
    w_q = np.asarray(jref.from_signed(jnp.asarray(
        rng.integers(-128, 128, (K, N)), jnp.int32)))
    u = _oracle(r, w_q)
    inv, scale = np.float32(0.5), np.float32(1e-4)
    got = tops.fused_blinded_matmul(
        _t(x), _t(r), tops.encode_weight_planes(_t(w_q)), _t(u),
        torch.tensor(inv), torch.tensor(scale), k_bits=8).numpy()
    jargs = (jnp.asarray(x), jnp.asarray(r),
             jops.encode_weight_planes(jnp.asarray(w_q)), jnp.asarray(u),
             jnp.float32(inv), jnp.float32(scale))
    impls = ("ref", "interpret") if M * K < 50_000 else ("ref",)
    for impl in impls:
        want = np.asarray(jops.fused_blinded_matmul(
            *jargs, k_bits=8, k_out_bits=15, impl=impl))
        np.testing.assert_array_equal(got, want, err_msg=impl)


@pytest.mark.parametrize("M,K,kf", [(16, 8, 1), (256, 1024, 2),
                                    (300, 1100, 1), (40, 70, 6)])
def test_field_fold_bit_equal(M, K, kf, rng):
    y = rng.integers(0, P, (M, K), dtype=np.int32)
    s = rng.integers(0, P, (K, kf), dtype=np.int32)
    got = tops.field_fold(_t(y), _t(s)).numpy()
    np.testing.assert_array_equal(got, _oracle(y, s))
    np.testing.assert_array_equal(got, np.asarray(jops.field_fold(
        jnp.asarray(y), jnp.asarray(s), impl="ref")))
