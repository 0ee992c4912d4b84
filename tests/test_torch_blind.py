"""The port's blind / unblind ops (kernels/blind) against the JAX reference,
on the CPU, where a wrapper takes its kernel's plain version.

Field results are held bit-for-bit; the unblinded floats too (the
dequantize divides by a power of two, which is exact). Above 2^16 elements
the reference's ops run its Pallas kernels in interpret mode.
"""
import sys
import threading

import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

import repro.core  # noqa: E402,F401  (imports before the kernel ops)
from repro.kernels.blind import ops as jops  # noqa: E402
from repro.kernels.blind import ref as jref  # noqa: E402
from repro_torch.core import blinding as TB  # noqa: E402
from repro_torch.kernels import build as KB  # noqa: E402
from repro_torch.kernels.blind import blind as K  # noqa: E402
from repro_torch.kernels.limb_matmul.ref import HALF, P  # noqa: E402

K_ACT, K_OUT = 8, 15
EDGE_FIELD = np.array([0, 1, P - 1, HALF, HALF + 1, HALF - 1, P - 2],
                      np.int32)


def _edge_x(k_bits):
    """Activations whose scaled values hit 0, exact half-way points (both
    rounding directions), the clip edges and far beyond them."""
    s = 2.0 ** -k_bits
    v = np.array([0.0, -0.0, 0.5 * s, 1.5 * s, 2.5 * s, -0.5 * s, -1.5 * s,
                  -2.5 * s, (HALF - 0.5) * s, (HALF + 0.5) * s, HALF * s,
                  -HALF * s, -(HALF + 0.5) * s, (HALF + 7) * s,
                  -(HALF + 7) * s, 1e30, -1e30, 3.0e38, 0.49999997 * s],
                 np.float32)
    return v


def _case(shape, seed):
    rng = np.random.default_rng(seed)
    x = (rng.normal(size=shape) * 3.0).astype(np.float32)
    r = rng.integers(0, P, size=shape, dtype=np.int32)
    return x, r


@pytest.mark.parametrize("shape", [(7,), (33, 5), (3, 5, 7), (2, 3, 4, 5),
                                   (300, 260)])
def test_blind_bit_equal_to_reference(shape):
    x, r = _case(shape, seed=len(shape) * 13 + shape[0])
    x.reshape(-1)[:min(x.size, 19)] = _edge_x(K_ACT)[:min(x.size, 19)]
    r.reshape(-1)[:min(r.size, 7)] = EDGE_FIELD[:min(r.size, 7)]
    got = K.blind(torch.from_numpy(x), torch.from_numpy(r), K_ACT)
    assert got.dtype == torch.int32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.blind_ref(jnp.asarray(x), jnp.asarray(r), K_ACT)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.blind(jnp.asarray(x), jnp.asarray(r), K_ACT)))


@pytest.mark.parametrize("shape", [(7,), (33, 5), (3, 5, 7), (2, 3, 4, 5),
                                   (300, 260)])
def test_unblind_bit_equal_to_reference(shape):
    rng = np.random.default_rng(shape[0] + 5)
    y = rng.integers(0, P, size=shape, dtype=np.int32)
    u = rng.integers(0, P, size=shape, dtype=np.int32)
    n = min(y.size, len(EDGE_FIELD) ** 2)
    yy, uu = np.meshgrid(EDGE_FIELD, EDGE_FIELD)
    y.reshape(-1)[:n] = yy.reshape(-1)[:n]
    u.reshape(-1)[:n] = uu.reshape(-1)[:n]
    got = K.unblind(torch.from_numpy(y), torch.from_numpy(u), K_OUT)
    assert got.dtype == torch.float32 and tuple(got.shape) == shape
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jref.unblind_ref(jnp.asarray(y), jnp.asarray(u), K_OUT)))
    np.testing.assert_array_equal(got.numpy(), np.asarray(
        jops.unblind(jnp.asarray(y), jnp.asarray(u), K_OUT)))


def test_blind_edges_and_round_trip():
    """Half-way points round to even, the clip edges hold, and an unblind
    with u = r (zero weight product) recovers the clipped quantization."""
    x = _edge_x(K_ACT)
    r = np.zeros_like(x, dtype=np.int32)
    b = K.blind(torch.from_numpy(x), torch.from_numpy(r), K_ACT).numpy()
    signed = np.where(b > HALF, b - P, b)
    assert list(signed[:8]) == [0, 0, 0, 2, 2, 0, -2, -2]
    assert signed[8] == HALF and signed[9] == HALF and signed[10] == HALF
    assert signed[11] == -HALF and signed[12] == -HALF
    assert signed[15] == HALF and signed[16] == -HALF
    back = K.unblind(torch.from_numpy(b), torch.from_numpy(r), K_ACT)
    np.testing.assert_array_equal(back.numpy(),
                                  signed.astype(np.float32) / 2 ** K_ACT)


def test_blinding_layer_matches_reference():
    """core/blinding's blind_activations / unblind_result with the spec's
    scales, against the reference's."""
    from repro.core import blinding as JB
    x, r = _case((64, 48), seed=3)
    spec_t, spec_j = TB.BlindingSpec(), JB.BlindingSpec()
    got = TB.blind_activations(torch.from_numpy(x), torch.from_numpy(r),
                               spec_t)
    want = JB.blind_activations(jnp.asarray(x), jnp.asarray(r), spec_j)
    np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    u = np.random.default_rng(4).integers(0, P, (64, 48), dtype=np.int32)
    got_u = TB.unblind_result(got, torch.from_numpy(u), spec_t)
    want_u = JB.unblind_result(want, jnp.asarray(u), spec_j)
    np.testing.assert_array_equal(got_u.numpy(), np.asarray(want_u))


@pytest.mark.parametrize("dtype", ["bfloat16", "float16"])
def test_unblind_result_out_dtype_matches_reference(dtype):
    """unblind_result's narrower output dtype: dequantized in float32, then
    cast, as the reference does (bit-equal after the cast)."""
    from repro.core import blinding as JB
    rng = np.random.default_rng(11)
    y = rng.integers(0, P, (40, 24), dtype=np.int32)
    u = rng.integers(0, P, (40, 24), dtype=np.int32)
    got = TB.unblind_result(torch.from_numpy(y), torch.from_numpy(u),
                            TB.BlindingSpec(), getattr(torch, dtype))
    want = JB.unblind_result(jnp.asarray(y), jnp.asarray(u),
                             JB.BlindingSpec(), getattr(jnp, dtype))
    assert got.dtype == getattr(torch, dtype)
    np.testing.assert_array_equal(got.float().numpy(),
                                  np.asarray(want.astype(jnp.float32)))


def test_plain_versions_are_the_oracles():
    x, r = _case((5, 9), seed=8)
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    np.testing.assert_array_equal(K.blind(xt, rt, K_ACT).numpy(),
                                  K.blind_plain(xt, rt, K_ACT).numpy())
    np.testing.assert_array_equal(K.unblind(rt, rt.flip(0), K_OUT).numpy(),
                                  K.unblind_plain(rt, rt.flip(0),
                                                  K_OUT).numpy())


def test_wrapper_rejects_devices_without_a_kernel():
    x = torch.zeros(4, device="meta")
    with pytest.raises(ValueError, match="no kernel"):
        K.blind(x, torch.zeros(4, dtype=torch.int32, device="meta"), K_ACT)


def test_launch_counter_is_exact_under_threads():
    """Slot workers count launches concurrently; no update may be lost."""
    names = ("blind", "unblind")
    KB.reset_launches()
    interval = sys.getswitchinterval()
    sys.setswitchinterval(1e-6)
    try:
        def hammer():
            for _ in range(2000):
                for name in names:
                    KB.count_launch(name)
        threads = [threading.Thread(target=hammer) for _ in range(16)]
        for t in threads:
            t.start()
        for t in threads:
            t.join(timeout=60)
        assert not any(t.is_alive() for t in threads)
    finally:
        sys.setswitchinterval(interval)
    assert all(KB.LAUNCHES[name] == 16 * 2000 for name in names)
    KB.reset_launches()
    assert set(KB.LAUNCHES) == set(KB.KERNELS) and not any(
        KB.LAUNCHES.values())
