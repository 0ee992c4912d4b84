"""The port's CUDA kernels on the card, held bit-for-bit against their plain
PyTorch versions and an int64 oracle, and the executor on the card against
the port on the CPU.

Every test here needs an NVIDIA GPU with nvcc; without one they skip.
Run on the card with:

    PYTHONPATH=src python -m pytest -q -m cuda tests/test_torch_cuda.py

This file imports no JAX (the machine with the card has none).
"""
import numpy as np
import pytest
import torch

from repro_torch.kernels import build as KB
from repro_torch.kernels.blind.blind import (blind, blind_encode,
                                             blind_encode_plain, blind_plain,
                                             unblind, unblind_plain)
from repro_torch.kernels.limb_matmul import ops
from repro_torch.kernels.limb_matmul import ref
from repro_torch.kernels.limb_matmul.fold import (limb_fold_planes,
                                                  limb_fold_planes_plain)
from repro_torch.kernels.limb_matmul.limb_matmul import (
    limb_matmul_planes, limb_matmul_planes_fused,
    limb_matmul_planes_fused_plain, limb_matmul_planes_plain)

pytestmark = pytest.mark.cuda


@pytest.fixture(scope="module")
def dev():
    if not torch.cuda.is_available():
        pytest.skip("needs an NVIDIA GPU (the kernels have no CPU mode)")
    KB.lib()                                   # build once for the module
    return torch.device("cuda")


def _oracle(x, w):
    return (x.astype(np.int64) @ w.astype(np.int64)) % ref.P


def _field(rng, shape):
    return torch.from_numpy(rng.integers(0, ref.P, shape, dtype=np.int32))


@pytest.mark.parametrize("M,K,N", [(1, 1, 1), (300, 72, 8), (257, 27, 64),
                                   (130, 576, 130), (64, 1152, 128),
                                   (4, 576, 1536),       # smollm decode u
                                   (1536, 576, 2),       # smollm ws
                                   (4097, 576, 1536),    # off the tile edges
                                   (129, 96, 65)])
def test_limb_matmul_matches_plain_and_int64(dev, M, K, N):
    rng = np.random.default_rng(M * 7 + K)
    x, w = _field(rng, (M, K)), _field(rng, (K, N))
    Kp = ops.block_plan(M, K, N)[4]
    xl, wl = ops.field_planes(x, Kp).to(dev), ops.encode_weight_planes(w).to(dev)
    before = KB.LAUNCHES["limb_matmul"]
    got = limb_matmul_planes(xl, wl)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["limb_matmul"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  limb_matmul_planes_plain(xl, wl).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(x.numpy(), w.numpy()))


def test_limb_matmul_extreme_digits(dev):
    """All-(-128) digit planes give the largest group sums the int32
    accumulators see; K = 40,000 crosses one mod-p reduction."""
    M, K, N = 65, 40000, 3
    xl = torch.full((3, M, K), -128, dtype=torch.int8, device=dev)
    wl = torch.full((3, K, N), -128, dtype=torch.int8, device=dev)
    np.testing.assert_array_equal(limb_matmul_planes(xl, wl).cpu().numpy(),
                                  limb_matmul_planes_plain(xl, wl).cpu().numpy())


def test_limb_matmul_extreme_digits_wide(dev):
    """The same extreme digits across whole tiles (N >= 64) with ragged
    edges: every accumulator of a block at its largest group sums."""
    M, K, N = 130, 40000, 72
    xl = torch.full((3, M, K), -128, dtype=torch.int8, device=dev)
    wl = torch.full((3, K, N), -128, dtype=torch.int8, device=dev)
    np.testing.assert_array_equal(limb_matmul_planes(xl, wl).cpu().numpy(),
                                  limb_matmul_planes_plain(xl, wl).cpu().numpy())


def _digits(kind, shape, rng):
    """Limb planes of the extreme digits: all -128 (the largest group sums)
    or a mix of -128 and 127."""
    if kind == "-128":
        return np.full(shape, -128, np.int8)
    return rng.choice(np.array([-128, 127], np.int8), size=shape)


def _from_digits(planes):
    """The int64 values of (3, ...) limb planes: l0 + 256 l1 + 65536 l2,
    canonical or not."""
    p = planes.astype(np.int64)
    return p[0] + 256 * p[1] + 65536 * p[2]


def _fused_oracle(acc, u, scale):
    """The fused epilogue in numpy on an exact field product."""
    d = (acc - u.astype(np.int64)) % ref.P
    s = np.where(d > ref.HALF, d - ref.P, d).astype(np.float32)
    return s * np.float32(scale)


@pytest.mark.parametrize("kind", ["-128", "mixed"])
def test_fused_extreme_digits_wide(dev, kind):
    """The fused kernel at the extreme digits across whole tiles (N >= 64)
    with ragged edges and K = 40,000 (one mod-p reduction of the group
    sums): bit-equal to its plain version and the int64 oracle."""
    M, K, N = 130, 40000, 72
    rng = np.random.default_rng(41)
    xd, wd = _digits(kind, (3, M, K), rng), _digits(kind, (3, K, N), rng)
    u = _field(rng, (M, N))
    scale = torch.tensor(3.1e-6)
    xl, wl = torch.from_numpy(xd).to(dev), torch.from_numpy(wd).to(dev)
    got = limb_matmul_planes_fused(xl, wl, u.to(dev), scale.to(dev)).cpu()
    np.testing.assert_array_equal(
        got.numpy(), limb_matmul_planes_fused_plain(
            xl, wl, u.to(dev), scale.to(dev)).cpu().numpy())
    acc = (_from_digits(xd) @ _from_digits(wd)) % ref.P
    np.testing.assert_array_equal(got.numpy(),
                                  _fused_oracle(acc, u.numpy(), 3.1e-6))


@pytest.mark.parametrize("kf", [2, 5])
@pytest.mark.parametrize("kind", ["-128", "mixed"])
@pytest.mark.parametrize("M", [130,        # the few-row tiles
                               16897])     # the 64-row tiles: more of them
                                           # than two an H100 SM, ragged
def test_fold_extreme_digits_past_reduction(dev, M, kind, kf):
    """The fold at the extreme digits past 32,768 k (one mod-p reduction)
    on both of its tilings: bit-equal to its plain version, and to the
    int64 oracle on the first and last 64 rows; kf = 5 takes two
    launches."""
    Kp = 32800
    gen = torch.Generator(device=dev)
    gen.manual_seed(M + kf)

    def digits(shape):
        if kind == "-128":
            return torch.full(shape, -128, dtype=torch.int8, device=dev)
        bits = torch.randint(0, 2, shape, generator=gen, device=dev,
                             dtype=torch.int8).bool()
        return torch.where(bits, torch.tensor(127, dtype=torch.int8,
                                              device=dev),
                           torch.tensor(-128, dtype=torch.int8, device=dev))

    yl, sl = digits((3, M, Kp)), digits((3, Kp, kf))
    got = limb_fold_planes(yl, sl)
    assert torch.equal(got, limb_fold_planes_plain(yl, sl))
    rows = np.r_[0:64, M - 64:M]
    want = (_from_digits(yl[:, rows].cpu().numpy())
            @ _from_digits(sl.cpu().numpy())) % ref.P
    np.testing.assert_array_equal(got[rows].cpu().numpy(), want)


@pytest.mark.parametrize("M,K,N", [(1, 27, 1), (4, 576, 1536),
                                   (129, 96, 65), (200, 40, 7),
                                   (4097, 576, 130)])
def test_fused_off_tile_edges(dev, M, K, N):
    """The fused kernel off every edge of its 64x64 tile, at M = 1 and the
    decode's 4 rows: bit-equal to its plain version and the int64 oracle,
    one launch."""
    rng = np.random.default_rng(M + 3 * N)
    x, w, u = _field(rng, (M, K)), _field(rng, (K, N)), _field(rng, (M, N))
    Kp = ops.block_plan(M, K, N)[4]
    xl, wl = ops.field_planes(x, Kp).to(dev), ops.encode_weight_planes(w).to(dev)
    scale = torch.tensor(2.7e-5, device=dev)
    before = KB.LAUNCHES["limb_matmul_fused"]
    got = limb_matmul_planes_fused(xl, wl, u.to(dev), scale)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["limb_matmul_fused"] == before + 1
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        limb_matmul_planes_fused_plain(xl, wl, u.to(dev), scale).cpu().numpy())
    np.testing.assert_array_equal(
        got.cpu().numpy(),
        _fused_oracle(_oracle(x.numpy(), w.numpy()), u.numpy(), 2.7e-5))


@pytest.mark.parametrize("M,Kf,kf", [(1, 32, 1), (4, 2112, 2), (129, 704, 3),
                                     (257, 96, 4), (130, 640, 5),
                                     (16897, 96, 2), (17000, 704, 3)])
def test_fold_off_tile_edges(dev, M, Kf, kf):
    """The fold off its tiles (16 rows for few rows, 64 rows from 16,896
    rows on an H100), at M = 1 and the decode's 4 rows, for kf = 1..5
    (the padded n8 tile, and two launches at kf = 5): bit-equal to its
    plain version and the int64 oracle."""
    rng = np.random.default_rng(M * 5 + kf)
    y, s = _field(rng, (M, Kf)), _field(rng, (Kf, kf))
    yl = ops.field_planes(y, Kf).to(dev)
    sl = ops.encode_weight_planes(s).to(dev)
    before = KB.LAUNCHES["limb_fold"]
    got = limb_fold_planes(yl, sl)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["limb_fold"] == before + (kf + 3) // 4
    np.testing.assert_array_equal(
        got.cpu().numpy(), limb_fold_planes_plain(yl, sl).cpu().numpy())
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  _oracle(y.numpy(), s.numpy()))


def test_limb_matmul_unaligned_planes(dev):
    """Planes that do not start on 16 bytes are copied, not refused."""
    rng = np.random.default_rng(5)
    x, w = _field(rng, (70, 64)), _field(rng, (64, 9))
    xl = ops.field_planes(x, 64).to(dev)
    buf = torch.empty(xl.numel() + 1, dtype=torch.int8, device=dev)
    shifted = buf[1:].view(xl.shape)
    shifted.copy_(xl)
    wl = ops.encode_weight_planes(w).to(dev)
    np.testing.assert_array_equal(limb_matmul_planes(shifted, wl).cpu().numpy(),
                                  _oracle(x.numpy(), w.numpy()))


def test_tensor_core_kernels_in_sass(dev):
    """The built library's SASS: the flash forward kernels (bf16 and
    float32) and the backward's dK/dV and dQ passes (bf16 and float32)
    issue HMMA/HGMMA and the limb kernels (plain, fused, fold) IMMA/IGMMA
    with no IDP (dp4a), and all copy their tiles with cp.async (LDGSTS) or
    TMA (UTMALDG), so none can quietly go back to the CUDA cores; the
    float32 forward's and backward's CUDA-core kernels are gone. The bf16
    decode route's split pass (every pair, causal and not; HMMA and
    cp.async) and combine pass (every value width) exist, use no local
    memory (no LDL/STL) and load with 128-bit LDG or cp.async."""
    import re
    import subprocess
    sass = subprocess.run([KB.cuda_tool("cuobjdump"), "-sass", str(KB.build())],
                          capture_output=True, text=True, check=True).stdout
    bodies = {}
    for part in re.split(r"\n\s*Function : ", sass)[1:]:
        name, _, body = part.partition("\n")
        bodies[name.strip()] = body
    flash = [b for n, b in bodies.items()
             if any(k in n for k in ("flash_fwd_bf16_mma_kernel",
                                     "flash_fwd_f32_mma_kernel"))]
    assert not any(k in n for n in bodies
                   for k in ("flash_fwd_f32_kernel", "flash_bwd_dkdv_kernel",
                             "flash_bwd_dq_kernel"))
    bwd = [b for n, b in bodies.items()
           if any(k in n for k in ("flash_bwd_dkdv_mma_kernel",
                                   "flash_bwd_dq_mma_kernel",
                                   "flash_bwd_dkdv_f32_mma_kernel",
                                   "flash_bwd_dq_f32_mma_kernel"))]
    limb = [b for n, b in bodies.items()
            if any(k in n for k in ("limb_matmul_mma_kernel",
                                    "limb_matmul_fused_mma_kernel",
                                    "limb_fold_mma_kernel"))]
    # flash: the (q/k, v) width pairs (32, 32), (64, 64), (128, 128),
    # (96, 64) and (48, 32), in the forward (bf16 and float32) non-causal,
    # causal and causal with a window, and in each of the backward's two
    # passes (bf16 and float32) causal and not; the fold has two tilings,
    # one kernel each
    assert len(flash) == 30 and len(bwd) == 40 and len(limb) == 4, \
        sorted(bodies)
    for body in flash + bwd:
        assert re.search(r"\bHG?MMA\b", body)
        assert re.search(r"\b(LDGSTS|UTMALDG)\b", body)
    for body in limb:
        assert re.search(r"\bIG?MMA\b", body)
        assert re.search(r"\b(LDGSTS|UTMALDG)\b", body)
        assert not re.search(r"\bIDP", body)
    split = [b for n, b in bodies.items()
             if "flash_fwd_decode_split_kernel" in n]
    combine = [b for n, b in bodies.items()
               if "flash_fwd_decode_combine_kernel" in n]
    # the five (q/k, v) pairs, causal and not; the value widths 32, 64, 128
    assert len(split) == 10 and len(combine) == 3, sorted(bodies)
    for body in split + combine:
        assert not re.search(r"\b(LDL|STL)\b", body)
        assert re.search(r"\bLDG(\.\w+)*\.128\b|\bLDGSTS\b", body)
    for body in split:
        assert re.search(r"\bLDGSTS\b", body)
        assert re.search(r"\bHG?MMA\b", body)


@pytest.mark.parametrize("M,K,N", [(300, 72, 8), (200, 27, 64),
                                   (96, 1152, 128)])
def test_fused_chain_matches_plain(dev, M, K, N):
    rng = np.random.default_rng(K)
    x = torch.from_numpy(rng.normal(size=(M, K)).astype(np.float32)).to(dev)
    r = _field(rng, (M, K)).to(dev)
    w_q = ref.from_signed(torch.from_numpy(
        rng.integers(-128, 128, (K, N), dtype=np.int32))).to(dev)
    u = ops.field_matmul(r, w_q)
    inv = torch.tensor(0.5, device=dev)
    scale = torch.tensor(1e-4, device=dev)
    Kp = ops.block_plan(M, K, N)[4]
    xl = blind_encode(x, r, inv, 8, Kp)
    np.testing.assert_array_equal(
        xl.cpu().numpy(), blind_encode_plain(x, r, inv, 8, Kp).cpu().numpy())
    wl = ops.encode_weight_planes(w_q)
    got = limb_matmul_planes_fused(xl, wl, u, scale)
    want = limb_matmul_planes_fused_plain(xl, wl, u, scale)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


def test_blind_encode_rounds_half_to_even(dev):
    # x * inv * 2^8 lands exactly on .5 steps: rintf must round to even
    x = (torch.arange(-8, 9, dtype=torch.float32) + 0.5) / 256
    x = x.reshape(1, -1).to(dev)
    r = torch.zeros_like(x, dtype=torch.int32)
    inv = torch.tensor(1.0, device=dev)
    got = blind_encode(x, r, inv, 8, 32)
    want = blind_encode_plain(x, r, inv, 8, 32)
    np.testing.assert_array_equal(got.cpu().numpy(), want.cpu().numpy())


@pytest.mark.parametrize("M,K,kf", [(1, 5, 1), (333, 640, 2), (50, 100, 5)])
def test_fold_matches_plain_and_int64(dev, M, K, kf):
    rng = np.random.default_rng(M + kf)
    x, s = _field(rng, (M, K)), _field(rng, (K, kf))
    got = ops.field_fold(x.to(dev), s.to(dev))
    np.testing.assert_array_equal(got.cpu().numpy(), _oracle(x.numpy(), s.numpy()))
    Kp = ops.block_plan(M, K, kf)[4]
    xl, sl = ops.field_planes(x, Kp).to(dev), ops.encode_weight_planes(s).to(dev)
    np.testing.assert_array_equal(limb_fold_planes(xl, sl).cpu().numpy(),
                                  limb_fold_planes_plain(xl, sl).cpu().numpy())


def test_wrappers_reject_bad_operands(dev):
    xl = torch.zeros((3, 4, 30), dtype=torch.int8, device=dev)   # Kp % 32
    wl = torch.zeros((3, 30, 4), dtype=torch.int8, device=dev)
    with pytest.raises(ValueError):
        limb_matmul_planes(xl, wl)
    with pytest.raises(TypeError):
        blind_encode(torch.zeros((2, 3), dtype=torch.float64, device=dev),
                     torch.zeros((2, 3), dtype=torch.int32, device=dev),
                     torch.tensor(1.0, device=dev), 8, 32)


def test_executor_on_card_matches_cpu(dev):
    """The tier-1 boundary on the card is bit-equal to the port on the CPU;
    the logits agree to float32 tier-2 tolerance."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.core.prng import PRNGKey
    from repro_torch.models import vgg as V
    cfg = get_smoke("vgg16")
    params = V.init_params(cfg, 0, device="cpu")
    x = torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))
    out = {}
    for d in ("cpu", "cuda"):
        ex = OrigamiExecutor(cfg, params, mode="origami", precompute=True,
                             integrity=IntegrityPolicy.full(k=2), device=d)
        out[d] = ex.infer({"images": x}, session_key=PRNGKey(5))
    np.testing.assert_array_equal(out["cuda"].boundary.cpu().numpy(),
                                  out["cpu"].boundary.numpy())
    ref_logits = out["cpu"].logits.numpy()
    np.testing.assert_allclose(out["cuda"].logits.cpu().numpy(), ref_logits,
                               rtol=0, atol=1e-4 * np.abs(ref_logits).max())
    assert out["cuda"].integrity.n_checked == 2
    assert out["cuda"].integrity.n_failed == 0


EDGE_FIELD = [0, 1, ref.P - 1, ref.HALF, ref.HALF + 1, ref.HALF - 1]


@pytest.mark.parametrize("shape", [(1,), (3,), (257, 27), (5, 7, 9),
                                   (4096, 576), (1001, 64)])
def test_blind_matches_plain(dev, shape):
    """Random and edge inputs (half-way points, clip edges, field edges);
    the vector path and, for odd sizes, the scalar tail."""
    rng = np.random.default_rng(shape[0])
    x = (rng.normal(size=shape) * 4.0).astype(np.float32)
    s = 2.0 ** -8
    edge = np.array([0.5 * s, 1.5 * s, 2.5 * s, -0.5 * s, -2.5 * s,
                     (ref.HALF + 0.5) * s, -(ref.HALF + 0.5) * s, 1e30,
                     -1e30, 0.0], np.float32)
    x.reshape(-1)[:min(x.size, edge.size)] = edge[:min(x.size, edge.size)]
    r = rng.integers(0, ref.P, size=shape, dtype=np.int32)
    r.reshape(-1)[:min(r.size, 6)] = EDGE_FIELD[:min(r.size, 6)]
    xt, rt = torch.from_numpy(x), torch.from_numpy(r)
    before = KB.LAUNCHES["blind"]
    got = blind(xt.to(dev), rt.to(dev), 8)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["blind"] == before + 1
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  blind_plain(xt, rt, 8).numpy())
    np.testing.assert_array_equal(got.cpu().numpy(), blind_plain(
        xt.to(dev), rt.to(dev), 8).cpu().numpy())


@pytest.mark.parametrize("shape", [(1,), (3,), (257, 64), (5, 7, 9),
                                   (4096, 128)])
def test_unblind_matches_plain(dev, shape):
    rng = np.random.default_rng(shape[0] + 1)
    y = rng.integers(0, ref.P, size=shape, dtype=np.int32)
    u = rng.integers(0, ref.P, size=shape, dtype=np.int32)
    yy, uu = np.meshgrid(EDGE_FIELD, EDGE_FIELD)
    n = min(y.size, yy.size)
    y.reshape(-1)[:n] = yy.reshape(-1)[:n]
    u.reshape(-1)[:n] = uu.reshape(-1)[:n]
    yt, ut = torch.from_numpy(y), torch.from_numpy(u)
    got = unblind(yt.to(dev), ut.to(dev), 15)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  unblind_plain(yt, ut, 15).numpy())


def test_blind_unaligned_views_take_the_scalar_path(dev):
    """Operands that start 4 bytes into an allocation are not 16-byte
    aligned: the kernel takes its scalar loop and agrees all the same."""
    rng = np.random.default_rng(2)
    x = torch.from_numpy(rng.normal(size=(1031,)).astype(np.float32)).to(dev)
    r = torch.from_numpy(rng.integers(0, ref.P, (1031,),
                                      dtype=np.int32)).to(dev)
    got = blind(x[1:], r[1:], 8)
    np.testing.assert_array_equal(got.cpu().numpy(),
                                  blind_plain(x[1:], r[1:], 8).cpu().numpy())
    y = unblind(got[1:], r[2:], 15)
    np.testing.assert_array_equal(
        y.cpu().numpy(), unblind_plain(got[1:], r[2:], 15).cpu().numpy())


def test_unfused_blinded_dense_on_card_matches_cpu(dev):
    """One unfused blinded op (blind, limb matmul, unblind, blinded-domain
    Freivalds check) on the card is bit-equal to the same op on the CPU."""
    from repro_torch.core import slalom as S
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.prng import PRNGKey
    rng = np.random.default_rng(6)
    x = torch.from_numpy(rng.normal(size=(64, 72)).astype(np.float32))
    w = torch.from_numpy((rng.normal(size=(72, 16)) / 8).astype(np.float32))
    b = torch.from_numpy((rng.normal(size=(16,)) * 0.1).astype(np.float32))
    out, logs = {}, {}
    for d in ("cpu", "cuda"):
        ctx = S.SlalomContext(PRNGKey(3), impl="unfused",
                              integrity=IntegrityPolicy.full(2))
        before = dict(KB.LAUNCHES)
        out[d] = S.blinded_dense(ctx, {"w": w.to(d), "b": b.to(d)}, x.to(d))
        logs[d] = [tuple(bool(v) for v in e) for e in ctx.integrity_log]
        if d == "cuda":
            torch.cuda.synchronize()
            for name in ("blind", "unblind", "limb_matmul", "limb_fold"):
                assert KB.LAUNCHES[name] > before[name], name
    np.testing.assert_array_equal(out["cuda"].cpu().numpy(),
                                  out["cpu"].numpy())
    assert logs["cuda"] == logs["cpu"] == [(True, False, False)]


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal", [
    (4, 1024, 1024, 9, 3, 64, True),      # the smollm prefill shape
    (2, 6, 6, 9, 3, 64, True),            # a smoke prompt
    (1, 1000, 1000, 4, 4, 64, True),      # MHA, ragged
    (2, 130, 130, 6, 3, 32, False),       # non-causal, ragged
    (1, 37, 200, 8, 1, 64, False),        # one KV head, Sq != Skv
    (1, 200, 70, 8, 2, 64, True),         # causal, Sq > Skv
    (2, 100, 100, 6, 3, 32, True),        # D 32, causal, ragged
    (3, 1, 1, 9, 3, 64, True),            # Sq = 1
    (2, 1, 50, 9, 3, 64, True),           # Sq = 1 against 50 keys
    (4, 1024, 1024, 64, 4, 128, True),    # the Qwen3-MoE prefill shape
    (4, 1024, 1024, 64, 4, 128, False),   # D 128, non-causal
    (4, 1000, 1000, 64, 4, 128, True),    # D 128, ragged
    (2, 130, 130, 14, 2, 128, False),     # D 128, G = 7, ragged
    (1, 200, 70, 16, 1, 128, True),       # D 128, causal, Sq > Skv
    (2, 1, 50, 16, 2, 128, True),         # D 128, Sq = 1
    (4, 1024, 1024, 32, 4, 128, True),    # the Yi-9B prefill shape, G = 8
    (4, 1024, 1024, 40, 8, 128, True),    # the Qwen2.5-14B prefill, G = 5
    (2, 1000, 1000, 40, 8, 128, False),   # G = 5 (one head a CTA), ragged
    (1, 200, 70, 5, 1, 128, True),        # G = 5, causal, Sq > Skv
    (1, 1024, 1601, 32, 8, 128, False),   # the VLM's cross attention
    # the bf16 decode route (Sq * G <= 16 rows a KV head)
    (4, 1, 1601, 32, 8, 128, False),      # the VLM's cross decode, G 4
    (4, 1, 1500, 12, 12, 64, False),      # Whisper's cross decode, G 1
    (2, 4, 300, 16, 4, 64, False),        # Sq 4 at G 4: the route's edge
    (2, 4, 300, 16, 4, 128, True),        # ... causal
    (2, 5, 300, 16, 4, 64, False),        # Sq 5 at G 4: past it (prefill)
    (3, 1, 1, 8, 2, 64, False),           # one key
])
def test_flash_attention_matches_plain(dev, dtype, tol, B, Sq, Skv, H, KH,
                                       D, causal):
    """The kernel against its plain version (float32 matmuls, TF32 off) on
    the card: 2e-5 in float32, 2e-2 in bf16 (the reference's tolerances);
    bf16 calls of at most 16 query rows a KV head take the decode route."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq * 7 + H)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dev, dtype) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                         (B, Skv, KH, D)))
    before = KB.LAUNCHES["flash_attention"]
    got = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == q.shape
    want = flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    # deterministic: a second launch is bit-equal
    assert torch.equal(got, flash_attention_fwd(q, k, v, causal=causal))


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal", [
    (1, 1024, 1601, 32, 8, 128, 128, False),   # the VLM's cross attention
    (4, 1, 1601, 32, 8, 128, 128, False),      # ... at one query (decode)
    (2, 256, 256, 40, 40, 96, 64, True),       # MLA's (96, 64)
    (1, 130, 70, 6, 2, 48, 32, True),          # its smoke widths, Sq > Skv
    (2, 100, 100, 6, 3, 32, 32, True),         # D 32, ragged
    (1, 37, 200, 8, 1, 64, 64, False),         # one KV head, Sq != Skv
])
def test_flash_attention_float32_lse_matches_plain(dev, B, Sq, Skv, H, KH, D,
                                                   Dv, causal):
    """The float32 kernel (3xTF32 on the tensor cores) with its lse: the
    output within 2e-5 of the plain version (float32 matmuls, TF32 off)
    and 1e-4 in relative Frobenius, the lse within 1e-5, the output the
    same with and without the lse, two launches bit-equal."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + 3 * Skv + D)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dev) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                  (B, Skv, KH, Dv)))
    before = KB.LAUNCHES["flash_attention"]
    got, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] == before + 1
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    assert (got - want).abs().max().item() <= 2e-5
    assert ((got - want).norm() / want.norm()).item() <= 1e-4
    assert (lse - want_lse).abs().max().item() <= 1e-5
    assert torch.equal(got, flash_attention_fwd(q, k, v, causal=causal))
    assert torch.equal(lse, flash_attention_fwd(q, k, v, causal=causal,
                                                return_lse=True)[1])


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("D,Dv", [(96, 64), (48, 32)])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,causal", [
    (4, 1024, 1024, 40, 40, True),        # the MiniCPM3 prefill shape
    (2, 32, 32, 40, 40, True),            # its generate_origami prompt
    (2, 256, 256, 40, 40, False),         # non-causal
    (1, 1000, 1000, 8, 8, True),          # ragged
    (2, 130, 70, 6, 2, True),             # GQA, causal, Sq > Skv
    (2, 1, 50, 4, 4, True),               # Sq = 1
    (4, 1, 161, 16, 4, False),            # Sq = 1 at G 4, ragged
])
def test_flash_attention_value_width_matches_plain(dev, dtype, tol, D, Dv, B,
                                                   Sq, Skv, H, KH, causal):
    """MLA's value width apart from the query width: the output takes v's
    width, the scores 1/sqrt(D); the kernel against its plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq * 7 + H + D)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dev, dtype) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                         (B, Skv, KH, Dv)))
    before = KB.LAUNCHES["flash_attention"]
    got = flash_attention_fwd(q, k, v, causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] == before + 1
    assert got.dtype == dtype and got.shape == (B, Sq, H, Dv)
    want = flash_attention_plain(q, k, v, causal=causal)
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               want.float().cpu().numpy(), rtol=tol, atol=tol)
    assert torch.equal(got, flash_attention_fwd(q, k, v, causal=causal))


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("nope,rope,dv", [(64, 32, 64), (32, 16, 32)])
def test_flash_attention_mla_split_kv_views(dev, dtype, tol, nope, rope, dv):
    """MLA's v is a view of the wkv_b projection (nope + v wide a head):
    it goes into the kernel as it is, strided, with k and q built by
    concatenation as ``models/attention.py`` builds them."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    B, S, H = 2, 130, 8
    rng = np.random.default_rng(nope + dv)
    kv = torch.from_numpy(rng.normal(size=(B, S, H, nope + dv)).astype(
        np.float32)).to(dev, dtype)
    k_nope, v = torch.split(kv, [nope, dv], dim=-1)
    k_rope = torch.from_numpy(rng.normal(size=(B, S, 1, rope)).astype(
        np.float32)).to(dev, dtype).expand(B, S, H, rope)
    k = torch.cat([k_nope, k_rope], dim=-1)
    q = torch.from_numpy(rng.normal(size=(B, S, H, nope + rope)).astype(
        np.float32)).to(dev, dtype)
    assert not v.is_contiguous() and v.stride(2) == nope + dv
    before = KB.LAUNCHES["flash_attention"]
    got = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               flash_attention_plain(q, k, v).float().cpu()
                               .numpy(), rtol=tol, atol=tol)
    assert torch.equal(got, flash_attention_fwd(q, k, v.contiguous()))


# (B, Sq, Skv, H, KH, D, Dv, causal) of bf16 decode-route calls
DECODE_CASES = [
    (4, 1, 1601, 32, 8, 128, 128, False),    # the VLM's cross decode
    (4, 1, 1500, 12, 12, 64, 64, False),     # Whisper's
    (4, 1, 1024, 32, 4, 128, 128, False),    # G 8 at D 128 (Yi's heads)
    (2, 1, 161, 16, 4, 96, 64, False),       # MLA's widths, ragged
    (2, 1, 70, 8, 8, 48, 32, True),          # its smoke widths, causal
    (2, 2, 300, 24, 3, 32, 32, True),        # Sq 2 at G 8, causal
]


def _decode_inputs(dev, case, seed):
    B, Sq, Skv, H, KH, D, Dv, _ = case
    rng = np.random.default_rng(seed)
    return tuple(torch.from_numpy(rng.normal(size=s).astype(np.float32))
                 .to(dev, torch.bfloat16)
                 for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, Dv)))


@pytest.mark.parametrize("case", DECODE_CASES)
def test_flash_attention_decode_lse_matches_plain(dev, case):
    """The decode route with its lse: the output within 2e-2 of the plain
    version and 8e-3 relative Frobenius of the float32 result, the lse
    within 1e-5 (chip_smoke.py's gates), the output the same with and
    without the lse, two launches bit-equal, one launch counted."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    causal = case[-1]
    torch.backends.cuda.matmul.allow_tf32 = False
    q, k, v = _decode_inputs(dev, case, case[2] + case[4])
    n, (got, lse) = _counted(lambda: flash_attention_fwd(
        q, k, v, causal=causal, return_lse=True))
    assert n["flash_attention"] == 1 and sum(n.values()) == 1, n
    want, want_lse = flash_attention_plain(q, k, v, causal=causal,
                                           return_lse=True)
    exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                  causal=causal)
    assert (got.float() - want.float()).abs().max().item() <= 2e-2
    assert ((got.float() - exact).norm() / exact.norm()).item() <= 8e-3
    assert (lse - want_lse).abs().max().item() <= 1e-5
    assert torch.equal(got, flash_attention_fwd(q, k, v, causal=causal))
    assert torch.equal(lse, flash_attention_fwd(q, k, v, causal=causal,
                                                return_lse=True)[1])


def test_flash_attention_routes_by_rows_a_kv_head(dev):
    """The profiler's kernel names: bf16 calls of at most 16 query rows a
    KV head run the decode route's split and combine passes and nothing
    else; past 16 rows, and in float32, the prefill kernels run."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    decode = {"flash_fwd_decode_split_kernel",
              "flash_fwd_decode_combine_kernel"}
    for case, dtype, want in (
            ((4, 1, 1601, 32, 8, 128, 128, False), torch.bfloat16, decode),
            ((2, 4, 300, 16, 4, 64, 64, True), torch.bfloat16, decode),
            ((2, 5, 300, 16, 4, 64, 64, False), torch.bfloat16,
             {"flash_fwd_bf16_mma_kernel"}),
            ((2, 1, 300, 40, 2, 64, 64, False), torch.bfloat16,
             {"flash_fwd_bf16_mma_kernel"}),
            ((4, 1, 1601, 32, 8, 128, 128, False), torch.float32,
             {"flash_fwd_f32_mma_kernel"})):
        q, k, v = (t.to(dtype) for t in _decode_inputs(dev, case, 5))
        flash_attention_fwd(q, k, v, causal=case[-1])
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            flash_attention_fwd(q, k, v, causal=case[-1])
            torch.cuda.synchronize()
        names = {ev.key for ev in prof.key_averages()}
        ran = {w for w in ("flash_fwd_decode_split_kernel",
                           "flash_fwd_decode_combine_kernel",
                           "flash_fwd_bf16_mma_kernel",
                           "flash_fwd_f32_mma_kernel")
               if any(w in name for name in names)}
        assert ran == want, (case, dtype, sorted(names))


DECODE_PASSES = {"flash_fwd_decode_split_kernel",
                 "flash_fwd_decode_combine_kernel"}
# (B, Sq, Skv, H, KH, D, dtype, q_offset, window, the route's kernels):
# windowed causal calls on each forward route: the bf16 prefill kernel
# (an unaligned window), the float32 kernel (an offset, Sq < Skv), and the
# decode route (Sq x G <= 16 rows a KV head) at the end of the keys
WINDOW_CASES = (
    (2, 300, 300, 9, 3, 64, torch.bfloat16, 0, 100,
     {"flash_fwd_bf16_mma_kernel"}),
    (2, 200, 260, 8, 2, 128, torch.float32, 60, 37,
     {"flash_fwd_f32_mma_kernel"}),
    (4, 4, 1024, 9, 3, 64, torch.bfloat16, 1020, 256, DECODE_PASSES),
    (1, 7, 700, 16, 8, 64, torch.bfloat16, 693, 100, DECODE_PASSES),
)


@pytest.mark.parametrize("case", WINDOW_CASES,
                         ids=[f"{c[6]}-{c[1]}x{c[2]}-w{c[8]}"
                              for c in WINDOW_CASES])
def test_windowed_sdpa_runs_the_forward_kernels(dev, case, monkeypatch):
    """``sdpa`` with a window and a query offset on the card: one flash
    launch, within the flash gates of the plain version (max abs, and
    relative Frobenius against its float32 result), two launches
    bit-equal, and under the profiler its route's kernels and no other
    kernel (no plain version, no library call)."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_plain)
    from repro_torch.models import attention as A
    B, Sq, Skv, H, KH, D, dtype, off, win, kernels = case
    gen = torch.Generator(device=dev)
    gen.manual_seed(Sq + win)
    q, k, v = (torch.randn(s, generator=gen, device=dev, dtype=dtype)
               for s in ((B, Sq, H, D), (B, Skv, KH, D), (B, Skv, KH, D)))

    def refuse(*a, **kw):
        raise AssertionError("sdpa ran the plain version on the card")

    monkeypatch.setattr(A, "flash_attention_plain", refuse)
    n, got = _counted(lambda: A.sdpa(q, k, v, causal=True, q_offset=off,
                                     window=win))
    assert n["flash_attention"] == 1 and sum(n.values()) == 1, n
    monkeypatch.setattr(torch.backends.cuda.matmul, "allow_tf32", False)
    want = flash_attention_plain(q, k, v, causal=True, q_offset=off,
                                 window=win)
    tol = 2e-2 if dtype == torch.bfloat16 else 2e-5
    assert (got.float() - want.float()).abs().max().item() <= tol
    # and within the relative Frobenius bound of the float32 result
    exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                  causal=True, q_offset=off, window=win)
    rel = ((got.float() - exact).norm() / exact.norm()).item()
    assert rel <= (8e-3 if dtype == torch.bfloat16 else 1e-4), rel
    assert torch.equal(got, A.sdpa(q, k, v, causal=True, q_offset=off,
                                   window=win))
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        A.sdpa(q, k, v, causal=True, q_offset=off, window=win)
        torch.cuda.synchronize()
    ran = {ev.key for ev in prof.key_averages()
           if getattr(ev, "device_time_total", 0) > 0}
    assert ran and all(any(w in name for w in kernels) for name in ran), ran
    assert all(any(w in name for name in ran) for w in kernels), ran


def test_flash_attention_decode_replays_in_a_graph(dev):
    """A decode call captured in a CUDA graph (its workspace from the
    graph's pool) replays bit-equal to the eager call, and on new queries
    copied into the captured input to the eager call on them."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd)
    case = DECODE_CASES[0]
    q, k, v = _decode_inputs(dev, case, 11)
    q2 = _decode_inputs(dev, case, 12)[0]
    eager, eager2 = (flash_attention_fwd(t, k, v, causal=False)
                     for t in (q, q2))
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):
        flash_attention_fwd(q, k, v, causal=False)
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        out = flash_attention_fwd(q, k, v, causal=False)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager)
    q.copy_(q2)
    graph.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, eager2)


def test_flash_attention_rejects_unbuilt_width_pairs(dev):
    """A (q/k, v) width pair the kernel was not built for raises; nothing
    falls back to the plain version."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        HEAD_DIMS, flash_attention_fwd)
    rng = np.random.default_rng(3)

    def t(*shape):
        return torch.from_numpy(rng.normal(size=shape).astype(
            np.float32)).to(dev, torch.bfloat16)

    before = KB.LAUNCHES["flash_attention"]
    for D, Dv in ((96, 96), (64, 32), (96, 32), (128, 64), (48, 64)):
        assert (D, Dv) not in HEAD_DIMS
        with pytest.raises(ValueError, match="built"):
            flash_attention_fwd(t(1, 8, 4, D), t(1, 8, 4, D), t(1, 8, 4, Dv))
    with pytest.raises(ValueError):                  # v's keys differ
        flash_attention_fwd(t(1, 8, 4, 96), t(1, 8, 4, 96), t(1, 9, 4, 64))
    assert KB.LAUNCHES["flash_attention"] == before


def test_flash_attention_strided_views_and_rejects(dev):
    """Projection views (unit-stride last dim) go in as they are; bad
    operands raise instead of launching."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    rng = np.random.default_rng(9)
    qkv = torch.from_numpy(rng.normal(size=(2, 50, 15, 32)).astype(
        np.float32)).to(dev)
    q, k, v = qkv[:, :, :9], qkv[:, :, 9:12], qkv[:, :, 12:]
    np.testing.assert_allclose(
        flash_attention_fwd(q, k, v).cpu().numpy(),
        flash_attention_plain(q, k, v).cpu().numpy(), rtol=2e-5, atol=2e-5)
    with pytest.raises(TypeError):
        flash_attention_fwd(q.double(), k.double(), v.double())
    with pytest.raises(ValueError):
        flash_attention_fwd(q[..., :16].contiguous(), k[..., :16].contiguous(),
                            v[..., :16].contiguous())         # D = 16


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
def test_flash_attention_misaligned_views(dev, dtype, tol):
    """Views whose start or row strides are not multiples of 16 bytes are
    copied by the wrapper and still go through the kernel."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    B, S, H, KH, D = 2, 77, 6, 2, 64
    rng = np.random.default_rng(17)
    row = H * D + 1                        # an odd row stride
    base = torch.from_numpy(rng.normal(size=B * S * row + 1).astype(
        np.float32)).to(dev, dtype)
    q = base[1:].as_strided((B, S, H, D), (S * row, row, D, 1))
    k, v = (torch.from_numpy(rng.normal(size=(B, S, KH, D)).astype(
        np.float32)).to(dev, dtype) for _ in range(2))
    k = torch.cat([k.new_zeros(1), k.flatten()])[1:].view(B, S, KH, D)
    before = KB.LAUNCHES["flash_attention"]
    got = flash_attention_fwd(q, k, v)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] == before + 1
    np.testing.assert_allclose(got.float().cpu().numpy(),
                               flash_attention_plain(q, k, v).float().cpu()
                               .numpy(), rtol=tol, atol=tol)


@pytest.mark.parametrize("arch", ["smollm_135m", "yi_9b", "minicpm3_4b"])
def test_private_generate_on_card(dev, arch):
    """Smoke private decode on the card: private and trusted bit-equal,
    every op checked, the prefill attention through the kernel (MiniCPM3:
    q/k 48 against v 32), logits within the bf16 tolerance (3e-2 of the
    largest) of the same run on the CPU."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.prng import PRNGKey
    from repro_torch.models import model as M
    from repro_torch.runtime.generate import private_generate
    cfg = get_smoke(arch)
    params = M.init_params(cfg, 0, device="cpu")
    prompt = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 6))
    kw = dict(max_new_tokens=4, integrity=IntegrityPolicy.full(k=2),
              session_key=PRNGKey(9))
    before = KB.LAUNCHES["flash_attention"]
    priv = private_generate(params, prompt, cfg, device="cuda", **kw)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] == before + cfg.num_layers
    oracle = private_generate(params, prompt, cfg, device="cuda",
                              trusted=True, **kw)
    assert torch.equal(priv.logits, oracle.logits)
    assert torch.equal(priv.tokens, oracle.tokens)
    assert priv.integrity.n_checked == priv.integrity.n_ops > 0
    assert priv.integrity.ok
    cpu = private_generate(params, prompt, cfg, device="cpu", **kw)
    first = cpu.logits[:, 0].float().numpy()
    np.testing.assert_allclose(priv.logits[:, 0].float().cpu().numpy(), first,
                               rtol=0, atol=3e-2 * np.abs(first).max())


def _second_card():
    if torch.cuda.device_count() < 2:
        pytest.skip("needs two NVIDIA GPUs")


def test_tensor_core_kernels_on_every_card(dev):
    """The tensor-core kernels (limb matmul, fused, fold, flash) take more
    shared memory than a launch gets by default, a limit each card keeps
    for itself: every card runs them, with another card current, as the
    first card does."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    _second_card()
    n = torch.cuda.device_count()
    rng = np.random.default_rng(23)
    x, w = _field(rng, (130, 576)), _field(rng, (576, 130))
    Kp = ops.block_plan(130, 576, 130)[4]
    xl, wl = ops.field_planes(x, Kp), ops.encode_weight_planes(w)
    acc = _oracle(x.numpy(), w.numpy())
    u, scale = _field(rng, (130, 130)), torch.tensor(3.1e-6)
    # the fold on both of its tilings: 16-row and 64-row tiles
    y, s = _field(rng, (17000, 704)), _field(rng, (704, 2))
    yl, sl = ops.field_planes(y, 704), ops.encode_weight_planes(s)
    fold_want = _oracle(y.numpy(), s.numpy())
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(torch.bfloat16) for s in ((2, 100, 6, 64), (2, 100, 3, 64),
                                             (2, 100, 3, 64)))
    first = flash_attention_fwd(q.to(dev), k.to(dev), v.to(dev)).cpu()
    np.testing.assert_allclose(
        first.float().numpy(),
        flash_attention_plain(q, k, v).float().numpy(), rtol=2e-2, atol=2e-2)
    for i in range(n):
        card = torch.device("cuda", i)
        with torch.cuda.device((i + 1) % n):
            got = limb_matmul_planes(xl.to(card), wl.to(card))
            fused = limb_matmul_planes_fused(xl.to(card), wl.to(card),
                                             u.to(card), scale.to(card))
            fold = limb_fold_planes(yl.to(card), sl.to(card))
            few = limb_fold_planes(yl[:, :300].contiguous().to(card),
                                   sl.to(card))
            att = flash_attention_fwd(q.to(card), k.to(card), v.to(card))
        assert got.device == fused.device == fold.device == att.device == card
        np.testing.assert_array_equal(got.cpu().numpy(), acc)
        np.testing.assert_array_equal(fused.cpu().numpy(),
                                      _fused_oracle(acc, u.numpy(), 3.1e-6))
        np.testing.assert_array_equal(fold.cpu().numpy(), fold_want)
        np.testing.assert_array_equal(few.cpu().numpy(), fold_want[:300])
        assert torch.equal(att.cpu(), first)


def test_offload_plane_over_every_card(dev):
    """DevicePool.from_torch: one slot per card, each shard launched on its
    slot's card. No dispatch crashes into the enclave's hands, every shard
    is checked, and the logits equal the pool-less executor's."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.core.prng import PRNGKey
    from repro_torch.models import vgg as V
    from repro_torch.runtime.devices import DevicePool
    _second_card()
    cfg = get_smoke("vgg16")
    params = V.init_params(cfg, 0, device="cpu")
    batch = {"images": torch.from_numpy(np.random.default_rng(1).normal(
        size=(2, cfg.image_size, cfg.image_size, 3)).astype(np.float32))}
    kw = dict(mode="origami", precompute=True,
              integrity=IntegrityPolicy.full(k=2), device="cuda")
    want = OrigamiExecutor(cfg, params, **kw).infer(
        batch, session_key=PRNGKey(5)).logits
    pool = DevicePool.from_torch()
    try:
        ex = OrigamiExecutor(cfg, params, devices=pool, shard="rows",
                             hedging=False, **kw)
        before = KB.LAUNCHES["limb_matmul"]
        res = ex.infer(batch, session_key=PRNGKey(5))
        assert KB.LAUNCHES["limb_matmul"] > before
        assert res.sharding.crashes == res.sharding.timeouts == 0, \
            res.sharding
        assert res.sharding.checks == res.sharding.dispatches > 0
        assert res.sharding.enclave_shards == 0, res.sharding
        assert res.integrity.ok
        assert torch.equal(res.logits, want)
    finally:
        pool.close()


# -- the fused epilogue for any int32 u ---------------------------------------

def _wrapped_epilogue(acc, u, scale):
    """The reference's epilogue in numpy: mod(acc - u + p, p) with the sum
    wrapping in int32, signed, one f32 multiply."""
    d = (acc.astype(np.int64) - u.astype(np.int64) + ref.P + 2 ** 31) \
        % 2 ** 32 - 2 ** 31
    d = d % ref.P
    s = np.where(d > ref.HALF, d - ref.P, d).astype(np.float32)
    return s * np.float32(scale)


@pytest.mark.parametrize("u_kind", ["int32", "extreme"])
@pytest.mark.parametrize("M,K,N", [(130, 576, 72), (4, 576, 1536)])
def test_fused_kernel_any_int32_u(dev, M, K, N, u_kind):
    rng = np.random.default_rng(M + N)
    x, w = _field(rng, (M, K)), _field(rng, (K, N))
    if u_kind == "int32":
        u = rng.integers(-2 ** 31, 2 ** 31, (M, N), dtype=np.int64)
    else:
        u = rng.choice(np.asarray([-2 ** 31, -2 ** 31 + 1, -1, 0, ref.P - 1,
                                   ref.P, ref.P + 1, 2 ** 31 - ref.P,
                                   2 ** 31 - 1, -ref.P], np.int64),
                       size=(M, N))
    u = torch.from_numpy(u.astype(np.int32))
    Kp = ops.block_plan(M, K, N)[4]
    xl = ops.field_planes(x, Kp).to(dev)
    wl = ops.encode_weight_planes(w).to(dev)
    scale = torch.tensor(3.1e-6, device=dev)
    got = limb_matmul_planes_fused(xl, wl, u.to(dev), scale).cpu()
    np.testing.assert_array_equal(
        got.numpy(), limb_matmul_planes_fused_plain(
            xl, wl, u.to(dev), scale).cpu().numpy())
    np.testing.assert_array_equal(
        got.numpy(), _wrapped_epilogue(_oracle(x.numpy(), w.numpy()),
                                       u.numpy(), 3.1e-6))


# -- CUDA-graph executables (runtime/aot.py) ----------------------------------

def _graph_executor(d, **kw):
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.models import vgg as V
    cfg = get_smoke("vgg16")
    kw.setdefault("precompute", True)
    kw.setdefault("integrity", IntegrityPolicy.full(k=2))
    return OrigamiExecutor(cfg, V.init_params(cfg, 0, device="cpu"),
                           device=d, **kw)


def _equal(a, b):
    return (torch.equal(a.logits, b.logits)
            and torch.equal(a.boundary, b.boundary)
            and all(torch.equal(getattr(a.integrity, f),
                                getattr(b.integrity, f))
                    for f in ("checked", "failed", "corrupted")))


def _counted(fn):
    torch.cuda.synchronize()
    before = dict(KB.LAUNCHES)
    out = fn()
    torch.cuda.synchronize()
    return {k: KB.LAUNCHES[k] - before[k] for k in KB.KERNELS}, out


@pytest.mark.parametrize("plan_kind", ["origami", "mixed", "vopen"])
def test_graph_replay_matches_eager(dev, plan_kind):
    """Every bucket's blinded and trusted graphs replay bit-equal to the
    eager step for fresh sessions, credit the eager step's launches, and
    the trusted replay equals the blinded one (the enclave recompute)."""
    from repro_torch.core import plan as PL
    from repro_torch.core.prng import PRNGKey
    from repro_torch.runtime.aot import CompileCache, GraphStep
    ex = _graph_executor(dev)
    if plan_kind != "origami":
        maker = PL.make_mixed if plan_kind == "mixed" else PL.make_vopen
        ex = _graph_executor(dev, plan=maker(ex.cfg))
    cache = CompileCache()
    ex.attach_aot(cache)
    shape = (ex.cfg.image_size, ex.cfg.image_size, 3)
    assert ex.warm_aot("images", shape, (1, 2)) == 4
    assert all(isinstance(e, GraphStep) for e in ex._executables.values())
    for b, seed in ((2, 3), (1, 4), (2, 5)):
        x = torch.from_numpy(np.random.default_rng(seed).normal(
            size=(b,) + shape).astype(np.float32))
        # both draw the session's factors on the request path
        batch, key = {"images": x}, PRNGKey(seed)
        eager_n, eager = _counted(lambda: ex.infer(batch, key, jit=False))
        replay_n, replay = _counted(lambda: ex.infer(batch, key))
        assert _equal(replay, eager)
        assert replay_n == eager_n and replay_n["limb_matmul_fused"] > 0
        assert replay.integrity.ok and replay.integrity.n_checked > 0
        trusted = ex.infer(batch, trusted=True)
        assert torch.equal(trusted.boundary, replay.boundary)
    st = cache.stats()
    assert st["compiles"] == 4 and st["request_compile_seconds"] == 0.0
    assert st["exec_fallbacks"] == 0


def test_graph_replay_under_threads(dev):
    """Concurrent replays of one signature from several threads: each
    caller gets its own session's result (the step's lock holds the copy-in,
    the replay and the copy-out together)."""
    import threading
    from repro_torch.core.prng import PRNGKey
    from repro_torch.runtime.aot import CompileCache
    ex = _graph_executor(dev)
    ex.attach_aot(CompileCache())
    shape = (ex.cfg.image_size, ex.cfg.image_size, 3)
    ex.warm_aot("images", shape, (2,), trusted_too=False)
    xs = [torch.from_numpy(np.random.default_rng(10 + i).normal(
        size=(2,) + shape).astype(np.float32)) for i in range(4)]
    want = [ex.infer({"images": x}, PRNGKey(i), jit=False).logits
            for i, x in enumerate(xs)]
    got = [None] * 4

    def run(i):
        got[i] = ex.infer({"images": xs[i]}, PRNGKey(i)).logits

    threads = [threading.Thread(target=run, args=(i,)) for i in range(4)]
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    torch.cuda.synchronize()
    assert all(torch.equal(g, w) for g, w in zip(got, want))


def test_capture_records_no_kernel_span_and_counts_on_replay(dev):
    """A synchronize inside a capture is illegal: profiled_kernel records
    nothing while a stream is captured, and the captured launch counts
    only when the graph replays."""
    from repro_torch.core import tracing
    rng = np.random.default_rng(7)
    x, w = _field(rng, (64, 96)).to(dev), _field(rng, (96, 32)).to(dev)
    want = ops.field_matmul(x, w)
    tr = tracing.Tracer()
    g = torch.cuda.CUDAGraph()
    with tracing.activate(tr):
        side = torch.cuda.Stream()
        side.wait_stream(torch.cuda.current_stream())
        with torch.cuda.stream(side):
            ops.field_matmul(x, w)           # warm on a side stream
        torch.cuda.current_stream().wait_stream(side)
        before = KB.LAUNCHES["limb_matmul"]
        with KB.recording_launches() as record:
            with torch.cuda.graph(g, capture_error_mode="thread_local"):
                out = ops.field_matmul(x, w)
        assert KB.LAUNCHES["limb_matmul"] == before
    assert record["limb_matmul"] == 1
    assert [s.name for s in tr.spans()].count("kernel.limb_matmul") == 1
    g.replay()
    torch.cuda.synchronize()
    assert torch.equal(out, want)


def _smoke_lm(dev, arch="smollm_135m"):
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.models import model as M
    cfg = get_smoke(arch)
    params = M.init_params(cfg, 0, device="cpu")
    ex = OrigamiExecutor(cfg, params, "origami", 2,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 8))
    return cfg, params, ex, tokens


def test_lm_infer_on_card(dev):
    """The LM forward on the card: blinded == trusted bit for bit, every
    op checked, the attention through the flash kernel, logits within
    the bf16 tolerance of the same run on the CPU."""
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    cfg, params, ex, tokens = _smoke_lm(dev)
    n, blinded = _counted(lambda: ex.infer({"tokens": tokens}))
    trusted = ex.infer({"tokens": tokens}, trusted=True)
    assert torch.equal(blinded.logits, trusted.logits)
    assert blinded.integrity.n_checked == blinded.integrity.n_ops == 14
    assert blinded.integrity.ok
    assert n["flash_attention"] == cfg.num_layers
    assert n["blind_encode"] == n["limb_matmul_fused"] == n["limb_fold"] == 14
    cpu = OrigamiExecutor(cfg, params, "origami", 2,
                          integrity=IntegrityPolicy.full(k=2), device="cpu")
    want = cpu.infer({"tokens": tokens}).logits.float().numpy()
    np.testing.assert_allclose(blinded.logits.float().cpu().numpy(), want,
                               rtol=0, atol=3e-2 * np.abs(want).max())


def _clone_caches(caches):
    from repro_torch.models.attention import KVCache
    return KVCache(caches.k.clone(),
                   None if caches.v is None else caches.v.clone())


@pytest.mark.parametrize("arch", ["smollm_135m", "minicpm3_4b"])
def test_decode_graphs_replay_bit_equal(dev, arch):
    """warm_decode_aot captures the trusted prompt pass and the slot-fed
    and trusted token steps; each replay is bit-equal to the eager step
    in logits, caches and report, credits the same launches, and serves
    another position than the one it was captured at (MiniCPM3: over the
    latent cache, whose v is None)."""
    from repro_torch.core.prng import PRNGKey
    from repro_torch.runtime.aot import CompileCache, GraphStep
    cfg, params, ex, tokens = _smoke_lm(dev, arch)
    ex.attach_decode_plan(max_steps=4)
    cache = CompileCache()
    ex.attach_aot(cache)
    S0, total = 6, 10
    assert ex.warm_decode_aot(2, S0, total) == 3
    assert all(isinstance(e, GraphStep) for e in ex._executables.values())
    prompt = torch.from_numpy(tokens[:, :S0]).to(dev)
    key = PRNGKey(5)
    for trusted in (False, True):
        eager = ex.prefill_session(prompt, key, max_seq=total,
                                   trusted=trusted, jit=False)
        run = ex.prefill_session(prompt, key, max_seq=total, trusted=trusted)
        assert torch.equal(run[0], eager[0])
        assert torch.equal(run[1].k, eager[1].k)
        caches = eager[1]
        for pos in (S0, S0 + 1):
            tok = torch.from_numpy(tokens[:, pos:pos + 1]).to(dev)
            slot = (None if trusted
                    else ex.decode_cache(2).session_factors(key, pos))
            c0 = _clone_caches(caches)
            ne, a = _counted(lambda: ex.decode_once(
                tok, c0, pos, key, slot, trusted=trusted, jit=False))
            c1 = _clone_caches(caches)
            nr, b = _counted(lambda: ex.decode_once(
                tok, c1, pos, key, slot, trusted=trusted))
            assert torch.equal(a[0], b[0])
            assert torch.equal(a[1].k, b[1].k)
            assert (a[1].v is None and b[1].v is None) or torch.equal(
                a[1].v, b[1].v)
            for f in ("checked", "failed", "corrupted"):
                assert torch.equal(getattr(a[2], f), getattr(b[2], f))
            assert ne == nr
            caches = b[1]
    st = cache.stats()
    assert st["compiles"] == 3 and st["exec_fallbacks"] == 0


def test_categorical_on_card_matches_cpu(dev):
    from repro_torch.core import prng
    logits = torch.from_numpy(np.random.default_rng(3).normal(
        size=(4, 49152)).astype(np.float32) * 3.0)
    for seed in range(8):
        key = prng.fold_in(prng.PRNGKey(seed), 1)
        want = prng.categorical(key, logits)
        got = prng.categorical(key, logits.to(dev))
        assert torch.equal(got.cpu(), want)
        np.testing.assert_array_equal(
            prng.uniform(key, (1000,), 1e-30, 1e3, device=dev).cpu().numpy(),
            prng.uniform(key, (1000,), 1e-30, 1e3).numpy())


@pytest.mark.parametrize("dispatch", ["gshard", "sorted", "sorted_grouped"])
def test_moe_forward_on_card(dev, dispatch):
    """The MoE layer (Qwen3-MoE smoke widths, bf16) on the card: no value
    read back to the host (sync debug mode "error"), two runs bit-equal,
    within the bf16 tolerance of the same layer on the CPU."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.models import layers as L
    from repro_torch.models import moe as MOE
    cfg = get_smoke("qwen3_moe_235b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe, dispatch=dispatch))
    gen = torch.Generator().manual_seed(0)
    params = L.init_params(MOE.moe_defs(cfg), gen, device="cpu",
                           dtype=torch.bfloat16)
    x = torch.from_numpy(np.random.default_rng(2).normal(
        size=(2, 64, cfg.d_model)).astype(np.float32)).to(torch.bfloat16)
    on_card = {k: (v.to(dev) if isinstance(v, torch.Tensor)
                   else {kk: vv.to(dev) for kk, vv in v.items()})
               for k, v in params.items()}
    xd = x.to(dev)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode("error")
    try:
        y, aux = MOE.moe_forward(on_card, xd, cfg)
        y2, aux2 = MOE.moe_forward(on_card, xd, cfg)
    finally:
        torch.cuda.set_sync_debug_mode(0)
    assert torch.equal(y, y2) and torch.equal(aux, aux2)
    want, want_aux = MOE.moe_forward(params, x, cfg)
    w = want.float().numpy()
    np.testing.assert_allclose(y.float().cpu().numpy(), w, rtol=0,
                               atol=3e-2 * np.abs(w).max())
    np.testing.assert_allclose(float(aux), float(want_aux), rtol=1e-4)


def test_moe_infer_on_card(dev):
    """The Qwen3-MoE smoke LM forward on the card: blinded == trusted bit
    for bit, 4 ops a tier-1 block checked, the attention (head width 32)
    through the flash kernel; the trusted forward captured as a CUDA graph
    replays bit-equal to the eager one."""
    import dataclasses
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.models import model as M
    from repro_torch.runtime import aot as AOT
    cfg = get_smoke("qwen3_moe_235b")
    cfg = cfg.replace(moe=dataclasses.replace(cfg.moe,
                                              dispatch="sorted_grouped"))
    params = M.init_params(cfg, 0, device="cpu")
    ex = OrigamiExecutor(cfg, params, "origami", 2,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    n, blinded = _counted(lambda: ex.infer({"tokens": tokens}))
    trusted = ex.infer({"tokens": tokens}, trusted=True)
    assert torch.equal(blinded.logits, trusted.logits)
    assert blinded.integrity.n_checked == blinded.integrity.n_ops == 8
    assert blinded.integrity.ok
    assert n["flash_attention"] == cfg.num_layers
    assert n["blind_encode"] == n["limb_matmul_fused"] == n["limb_fold"] == 8
    ex.attach_aot(AOT.CompileCache())
    replay = ex.infer({"tokens": tokens}, trusted=True)
    assert isinstance(next(iter(ex._executables.values())), AOT.GraphStep)
    assert torch.equal(replay.logits, trusted.logits)


@pytest.mark.parametrize("M,K,N", [(4096, 4096, 4),     # xLSTM's gates
                                   (4, 4096, 4),
                                   (4096, 2048, 8384),  # Zamba2's in_proj
                                   (64, 2048, 8384)])
def test_field_kernels_at_the_ssm_shapes(dev, M, K, N):
    """The three field-product kernels at the narrowest N (4) and the
    widest (8384) any path gives them, with the op's fold ([y | x] of
    N + K digits, k = 2): bit-equal to their plain versions, one launch
    each."""
    gen = torch.Generator(device=dev)
    gen.manual_seed(M + N)

    def field(rows, cols):
        return torch.randint(0, ref.P, (rows, cols), generator=gen,
                             device=dev, dtype=torch.int32)

    x, w, u = field(M, K), field(K, N), field(M, N)
    Kp = ops.block_plan(M, K, N)[4]
    xl, wl = ops.field_planes(x, Kp), ops.encode_weight_planes(w)
    scale = torch.tensor(3.1e-6, device=dev)
    sl = ops.encode_weight_planes(field(N + K, 2))
    fl = ops.field_planes(field(M, N + K), sl.shape[1])
    for name, fn, plain in (
            ("limb_matmul", lambda: limb_matmul_planes(xl, wl),
             lambda: limb_matmul_planes_plain(xl, wl)),
            ("limb_matmul_fused",
             lambda: limb_matmul_planes_fused(xl, wl, u, scale),
             lambda: limb_matmul_planes_fused_plain(xl, wl, u, scale)),
            ("limb_fold", lambda: limb_fold_planes(fl, sl),
             lambda: limb_fold_planes_plain(fl, sl))):
        n, got = _counted(fn)
        assert n[name] == 1 and sum(n.values()) == 1, n
        assert torch.equal(got, plain()), name


@pytest.mark.parametrize("dtype,tol", [(torch.float32, 2e-5),
                                       (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("B,S", [(4, 1024), (2, 32), (1, 128), (2, 1000)])
def test_flash_attention_one_query_head_a_kv_head_at_d64(dev, dtype, tol, B,
                                                        S):
    """Zamba2's shared attention: 32 query heads over 32 KV heads of 64
    (G 1), causal, at its prefill and engine shapes and ragged: within
    the tolerance of the plain version, one launch, deterministic."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    gen = torch.Generator(device=dev)
    gen.manual_seed(B * S)
    q, k, v = (torch.randn((B, S, 32, 64), generator=gen, device=dev,
                           dtype=dtype) for _ in range(3))
    torch.backends.cuda.matmul.allow_tf32 = False
    n, got = _counted(lambda: flash_attention_fwd(q, k, v, causal=True))
    assert n["flash_attention"] == 1
    want = flash_attention_plain(q, k, v, causal=True)
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, flash_attention_fwd(q, k, v, causal=True))


@pytest.mark.parametrize("arch,ops_", [("zamba2_1_2b", 6 * 2 + 2 * 6),
                                       ("xlstm_1_3b", 3 * 4 + 3)])
def test_ssm_infer_and_decode_on_card(dev, arch, ops_):
    """The smoke Zamba2 and xLSTM on the card at p = 6 and 4 (both groups'
    shared blocks, an sLSTM block blinded): blinded == trusted bit for bit,
    every op checked; Zamba2's shared block through the flash kernel once
    a group, xLSTM with no flash launch; the float32 forward within 1e-4
    of the CPU's; decode within 0.06 of the card's forward."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.models import model as M
    cfg = get_smoke(arch)
    p = 6 if arch == "zamba2_1_2b" else 4
    params = M.init_params(cfg, 0, device="cpu")
    ex = OrigamiExecutor(cfg, params, "origami", p,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    tokens = np.random.default_rng(1).integers(0, cfg.vocab_size, (2, 32))
    n, blinded = _counted(lambda: ex.infer({"tokens": tokens}))
    trusted = ex.infer({"tokens": tokens}, trusted=True)
    assert torch.equal(blinded.logits, trusted.logits)
    rep = blinded.integrity
    assert rep.n_checked == rep.n_ops == ops_ and rep.ok
    groups = (cfg.num_layers // cfg.hybrid_attn_every
              if arch == "zamba2_1_2b" else 0)
    assert n["flash_attention"] == groups
    assert n["blind_encode"] == n["limb_matmul_fused"] == ops_
    f32 = cfg.replace(dtype="float32")
    p32 = M.init_params(f32, 0, device="cpu")
    toks = torch.from_numpy(tokens)
    with torch.no_grad():
        want = M.forward(p32, {"tokens": toks}, f32).logits.numpy()
        got = M.forward(OrigamiExecutor(f32, p32, "open", 0,
                                        device=dev).params,
                        {"tokens": toks.to(dev)}, f32).logits.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    full = ex.reference({"tokens": tokens}).float()
    caches = M.init_caches(cfg, 2, 16, device=dev)
    with torch.no_grad():
        for t in range(16):
            logits, caches = M.decode_step(ex.params, toks[:, t:t + 1].to(dev),
                                           caches, t, cfg)
            np.testing.assert_allclose(
                logits[:, 0].float().cpu().numpy(),
                full[:, t].cpu().numpy(), rtol=0.06, atol=0.06)


@pytest.mark.parametrize("arch", ["zamba2_1_2b", "xlstm_1_3b"])
def test_recurrent_step_replay_matches_eager(dev, arch):
    """The recurrent prompt pass through one captured decode step
    (``RecurrentStep``, a CUDA graph) bit-equal to the eager pass in the
    last logits and every state leaf, and ``generate`` (which replays the
    step for the new tokens too) the greedy continuation of it."""
    from repro_torch.configs import get_smoke
    from repro_torch.models import model as M
    from repro_torch.runtime import aot as AOT
    from repro_torch.runtime import generate as G
    cfg = get_smoke(arch)
    params = M.init_params(cfg, 0, device=dev)
    prompt = torch.from_numpy(np.random.default_rng(3).integers(
        0, cfg.vocab_size, (2, 12))).to(dev)

    def leaves(tree):
        if isinstance(tree, torch.Tensor):
            return [tree]
        if isinstance(tree, dict):
            return [t for k in sorted(tree) for t in leaves(tree[k])]
        return [t for v in tree for t in leaves(v)]

    with torch.no_grad():
        eager_caches = M.init_caches(cfg, 2, 16, device=dev)
        eager, eager_caches = G.prefill_recurrent(params, prompt,
                                                  eager_caches, cfg)
        caches = M.init_caches(cfg, 2, 16, device=dev)
        step = G.RecurrentStep(params, caches, cfg, 2, dev)
        assert isinstance(step.step, AOT.GraphStep)
        got, caches = G.prefill_recurrent(params, prompt, caches, cfg, step)
    assert torch.equal(got, eager)
    for a, b in zip(leaves(caches), leaves(eager_caches)):
        assert torch.equal(a, b)
    out = G.generate(params, prompt, cfg, max_new_tokens=4, device=dev)
    assert torch.equal(out.tokens[:, :12], prompt)
    assert torch.equal(out.tokens[:, 12],
                       torch.argmax(eager[:, 0, :cfg.vocab_size].float(), -1))


# the cross-attention slice's attention shapes at reduced batch: (B, Sq,
# Skv, H, KH, D, causal, dtype)
CROSS_FLASH_SHAPES = [
    (1, 1024, 1024, 32, 8, 128, True, torch.bfloat16),   # VLM self, G 4
    (1, 1024, 1601, 32, 8, 128, False, torch.float32),   # VLM cross, forward
    (1, 1024, 1601, 32, 8, 128, False, torch.bfloat16),  # ... prefill_vlm
    (2, 1, 1601, 32, 8, 128, False, torch.bfloat16),     # VLM cross, decode
    (1, 1500, 1500, 12, 12, 64, False, torch.bfloat16),  # Whisper encoder
    (1, 448, 448, 12, 12, 64, True, torch.bfloat16),     # Whisper self
    (1, 448, 1500, 12, 12, 64, False, torch.bfloat16),   # Whisper cross
    (2, 1, 1500, 12, 12, 64, False, torch.bfloat16),     # ... at decode
]


@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,causal,dtype", CROSS_FLASH_SHAPES)
def test_flash_attention_at_the_cross_attention_shapes(dev, B, Sq, Skv, H, KH,
                                                       D, causal, dtype):
    """Llama-3.2-Vision's and Whisper's attention: the ragged key lengths
    1601 and 1500, non-causal with Sq != Skv, one query at decode, G 4 at
    D 128 and G 1 at D 64: within the plain version's tolerance (2e-5
    float32, 2e-2 bf16), one launch, deterministic. An absolute 2e-2 is
    half a typical output over ~1500 keys, so each is also held within a
    relative Frobenius error of the plain float32 result (1e-4 float32,
    8e-3 bf16) that the last partial key tile's zero-filled keys, left
    unmasked, would exceed; that fault (the plain version over keys
    zero-padded to a multiple of 64) is shown failing the bound."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    torch.backends.cuda.matmul.allow_tf32 = False
    gen = torch.Generator(device=dev)
    gen.manual_seed(Sq * 7 + Skv)
    q = torch.randn((B, Sq, H, D), generator=gen, device=dev, dtype=dtype)
    k, v = (torch.randn((B, Skv, KH, D), generator=gen, device=dev,
                        dtype=dtype) for _ in range(2))
    n, got = _counted(lambda: flash_attention_fwd(q, k, v, causal=causal))
    assert n["flash_attention"] == 1 and sum(n.values()) == 1
    assert got.dtype == dtype and tuple(got.shape) == (B, Sq, H, D)
    want = flash_attention_plain(q, k, v, causal=causal)
    tol = 2e-5 if dtype == torch.float32 else 2e-2
    assert (got.float() - want.float()).abs().max().item() <= tol
    assert torch.equal(got, flash_attention_fwd(q, k, v, causal=causal))
    exact = flash_attention_plain(q.float(), k.float(), v.float(),
                                  causal=causal)

    def rel(out):
        return ((out.float() - exact).norm() / exact.norm()).item()

    rel_tol = 1e-4 if dtype == torch.float32 else 8e-3
    assert rel(got) <= rel_tol
    pad = -Skv % 64
    if pad and not causal:
        kp, vp = (torch.cat([t, t.new_zeros((B, pad, KH, D))], dim=1)
                  for t in (k, v))
        assert rel(flash_attention_plain(q, kp, vp, causal=False)) > rel_tol


def test_sdpa_mixed_dtypes_launch_the_float32_kernel(dev, monkeypatch):
    """bf16 queries against float32 keys and values (the VLM's forward over
    float32 patches): ``sdpa`` launches the flash kernel once on float32
    operands, never the plain version, and returns bf16 within the
    plain version's float32 result rounded to bf16."""
    from repro_torch.kernels.flash_attention import flash_attention as FA
    from repro_torch.models import attention as A
    gen = torch.Generator(device=dev)
    gen.manual_seed(5)
    q = torch.randn((2, 64, 32, 128), generator=gen, device=dev,
                    dtype=torch.bfloat16)
    k, v = (torch.randn((2, 1601, 8, 128), generator=gen, device=dev)
            for _ in range(2))
    seen = []
    inner = FA.flash_attention_fwd

    def spy(q_, k_, v_, **kw):
        seen.append((q_.dtype, k_.dtype, v_.dtype))
        return inner(q_, k_, v_, **kw)

    def no_plain(*a, **kw):
        raise AssertionError("the plain version ran on the card")

    monkeypatch.setattr(A, "flash_attention_fwd", spy)
    monkeypatch.setattr(FA, "flash_attention_plain", no_plain)
    n, got = _counted(lambda: A.sdpa(q, k, v, causal=False))
    monkeypatch.undo()
    assert seen == [(torch.float32,) * 3]
    assert n["flash_attention"] == 1 and sum(n.values()) == 1
    assert got.dtype == torch.bfloat16
    want = FA.flash_attention_plain(q.float(), k, v, causal=False)
    assert (got.float() - want).abs().max().item() <= 2e-2
    assert ((got.float() - want).norm() / want.norm()).item() <= 8e-3


@pytest.mark.parametrize("arch", ["whisper_small", "llama3_2_vision_11b"])
def test_cross_infer_and_decode_on_card(dev, arch):
    """The smoke Whisper (p = 2, 12 ops) and Llama-3.2-Vision (p = 5, 35
    ops: its cross block blinded) on the card: blinded == trusted bit for
    bit, every op checked, one flash launch a self and a cross attention;
    the float32 forward within 1e-4 of the CPU's; the prompt pass and
    decode steps within 0.05 of the card's forward (the reference's
    bound, tests/test_attention.py)."""
    from repro_torch.configs import get_smoke
    from repro_torch.core.integrity import IntegrityPolicy
    from repro_torch.core.origami import OrigamiExecutor
    from repro_torch.models import model as M
    cfg = get_smoke(arch)
    p, ops_ = (2, 12) if arch == "whisper_small" else (5, 35)
    rng = np.random.default_rng(1)
    key = "frames" if cfg.family == "audio" else "patches"
    mem_len = (cfg.encoder_seq_len if cfg.family == "audio"
               else cfg.vision_seq_len)
    batch = {"tokens": rng.integers(0, cfg.vocab_size, (2, 16)),
             key: (rng.standard_normal((2, mem_len, cfg.d_model))
                   * 0.1).astype(np.float32)}
    params = M.init_params(cfg, 0, device="cpu")
    if cfg.family == "vlm":
        params["cross_groups"]["attn_gate"].fill_(0.7)
        params["cross_groups"]["mlp_gate"].fill_(-0.4)
    ex = OrigamiExecutor(cfg, params, "origami", p,
                         integrity=IntegrityPolicy.full(k=2), device=dev)
    n, blinded = _counted(lambda: ex.infer(batch))
    trusted = ex.infer(batch, trusted=True)
    assert torch.equal(blinded.logits, trusted.logits)
    rep = blinded.integrity
    assert rep.n_checked == rep.n_ops == ops_ and rep.ok
    assert n["blind_encode"] == n["limb_matmul_fused"] == ops_
    # audio: encoder, decoder self and cross; vlm: each block's attention
    assert n["flash_attention"] == (3 * cfg.num_layers if cfg.family == "audio"
                                    else cfg.num_layers)
    f32 = cfg.replace(dtype="float32")
    p32 = M.init_params(f32, 0, device="cpu")
    tb = {k: torch.from_numpy(v) for k, v in batch.items()}
    with torch.no_grad():
        want = M.forward(p32, tb, f32).logits.numpy()
        got = M.forward(OrigamiExecutor(f32, p32, "open", 0,
                                        device=dev).params,
                        {k: v.to(dev) for k, v in tb.items()},
                        f32).logits.cpu().numpy()
    np.testing.assert_allclose(got, want, rtol=0,
                               atol=1e-4 * np.abs(want).max())
    full = ex.reference(batch).float().cpu().numpy()
    prompt = {k: v.to(dev) for k, v in tb.items()}
    prompt["tokens"] = prompt["tokens"][:, :12]
    fill = M.prefill if cfg.family == "audio" else M.prefill_vlm
    with torch.no_grad():
        logits, caches = fill(ex.params, prompt, cfg, max_seq=16)
        np.testing.assert_allclose(logits[:, 0].float().cpu().numpy(),
                                   full[:, 11], rtol=0.05, atol=0.05)
        for t in range(12, 16):
            logits, caches = M.decode_step(
                ex.params, tb["tokens"][:, t:t + 1].to(dev), caches, t, cfg)
            np.testing.assert_allclose(
                logits[:, 0].float().cpu().numpy(), full[:, t], rtol=0.05,
                atol=0.05)


def _rel_frobenius(got, want):
    return ((got.float() - want.float()).norm()
            / want.float().norm().clamp_min(1e-30)).item()


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,causal", [
    (2, 256, 256, 9, 3, 64, 64, True),     # SmolLM's heads, causal
    (2, 256, 256, 9, 3, 64, 64, False),
    (2, 200, 200, 4, 4, 64, 64, True),     # G 1, ragged
    (2, 6, 6, 9, 3, 64, 64, True),         # one partial tile
    (1, 130, 130, 16, 2, 128, 128, True),  # D 128, G 8, ragged
    (1, 100, 100, 8, 8, 96, 64, True),     # MLA (96, 64)
    (1, 70, 70, 4, 4, 48, 32, False),      # the MLA smoke widths
    (2, 90, 90, 6, 3, 32, 32, True),       # D 32
    (1, 200, 70, 8, 2, 64, 64, True),      # causal, Sq > Skv
    (1, 37, 200, 8, 1, 64, 64, False),     # Sq < Skv
    (1, 1024, 1601, 32, 8, 128, 128, False),   # the VLM's cross attention
])
def test_flash_attention_bwd_matches_plain(dev, dtype, rel_tol, B, Sq, Skv,
                                           H, KH, D, Dv, causal):
    """The backward kernel against its plain version (float32 matmuls,
    TF32 off) on the same residuals: each gradient within a relative
    Frobenius 1e-5 (float32) / 8e-3 (bf16), launched once a call, two
    launches bit-equal (no atomics)."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq * 3 + H + D)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(dev, dtype) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                               (B, Skv, KH, Dv),
                                               (B, Sq, H, Dv)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    before = KB.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    for g, w, t in zip(got, want, (q, k, v)):
        assert g.dtype == dtype and g.shape == t.shape
        assert _rel_frobenius(g, w) <= rel_tol
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("causal", [True, False])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv", [
    (2, 200, 200, 6, 2, 64, 64),       # SmolLM's width, G 3, ragged
    (1, 150, 150, 8, 4, 32, 32),
    (1, 130, 150, 8, 2, 128, 128),     # D 128, Sq != Skv
    (1, 100, 100, 4, 4, 96, 64),       # MLA (96, 64)
    (1, 70, 90, 4, 4, 48, 32),         # the MLA smoke widths
    (1, 37, 6, 3, 1, 64, 64),          # Sq > Skv, one partial key tile
])
def test_flash_attention_bwd_float32_matches_plain(dev, B, Sq, Skv, H, KH, D,
                                                   Dv, causal):
    """The float32 backward (3xTF32 on the tensor cores) at every built
    pair, causal and not, ragged: each gradient within chip_smoke.py's
    gates of the plain version (relative Frobenius 1e-5, max abs 1e-5 of
    its largest magnitude), one launch a call, two launches bit-equal."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + 7 * Skv + D + causal)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(dev) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                        (B, Skv, KH, Dv), (B, Sq, H, Dv)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    before = KB.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=causal)
    for g, w in zip(got, want):
        assert g.dtype == torch.float32 and g.shape == w.shape
        assert _rel_frobenius(g, w) <= 1e-5
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


def test_flash_attention_bwd_float32_vlm_cross(dev):
    """The float32 backward at the VLM's cross attention (1024 queries
    against 1601 float32 patches, 32/8 heads of 128, non-causal) with
    queries that hold bf16 values (bf16 queries promoted against the float32
    patches): chip_smoke.py's gates, bit-equal relaunches."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_bwd_plain, flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(1601)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(dev) for s in ((1, 1024, 32, 128), (1, 1601, 8, 128),
                                        (1, 1601, 8, 128), (1, 1024, 32, 128)))
    q = q.to(torch.bfloat16).float()
    out, lse = flash_attention_fwd(q, k, v, causal=False, return_lse=True)
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, causal=False)
    for g, w in zip(got, want):
        assert _rel_frobenius(g, w) <= 1e-5
        assert (g - w).abs().max().item() <= 1e-5 * w.abs().max().item()
    again = flash_attention_bwd(q, k, v, out, lse, dout, causal=False)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype,rel_tol", [(torch.float32, 1e-5),
                                           (torch.bfloat16, 8e-3)])
@pytest.mark.parametrize("B,Sq,Skv,H,KH,D,Dv,q_offset,window", [
    (2, 256, 256, 9, 3, 64, 64, 0, 100),       # SmolLM's heads, unaligned
    (2, 256, 256, 9, 3, 64, 64, 0, 64),        # one tile's width
    (2, 200, 200, 4, 4, 64, 64, 0, 3),         # three keys a row
    (1, 64, 256, 9, 3, 64, 64, 192, 0),        # an offset shard, causal
    (1, 64, 256, 9, 3, 64, 64, 192, 70),       # ... windowed: keys no row sees
    (1, 130, 300, 16, 2, 128, 128, 170, 90),   # D 128, G 8, ragged
    (1, 100, 100, 8, 8, 96, 64, 0, 33),        # MLA (96, 64)
    (1, 70, 90, 4, 4, 48, 32, 20, 17),         # the MLA smoke widths
    (2, 90, 90, 6, 3, 32, 32, 0, 200),         # D 32, a window past Sq
    (1, 6, 50, 8, 1, 64, 64, 44, 3),           # one partial tile
])
def test_flash_attention_bwd_windowed_matches_plain(dev, dtype, rel_tol, B, Sq,
                                                    Skv, H, KH, D, Dv,
                                                    q_offset, window):
    """The windowed instantiations of the backward (a window, a query
    offset or both) against the plain backward at the same band: each
    gradient within chip_smoke.py's gates, one launch a call, two launches
    bit-equal, zero dk and dv at keys no row sees."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        band, flash_attention_bwd, flash_attention_bwd_plain,
        flash_attention_fwd)
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(Sq + 5 * Skv + D + window + q_offset)
    q, k, v, dout = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
                     .to(dev, dtype) for s in ((B, Sq, H, D), (B, Skv, KH, D),
                                               (B, Skv, KH, Dv),
                                               (B, Sq, H, Dv)))
    kw = dict(causal=True, q_offset=q_offset, window=window)
    out, lse = flash_attention_fwd(q, k, v, return_lse=True, **kw)
    before = KB.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd_plain(q, k, v, out, lse, dout, **kw)
    for g, w in zip(got, want):
        assert g.dtype == dtype and g.shape == w.shape
        assert _rel_frobenius(g, w) <= rel_tol
        abs_tol = 1e-5 if dtype == torch.float32 else 2e-2
        assert (g.float() - w.float()).abs().max().item() <= \
            abs_tol * w.float().abs().max().item()
    lo, hi = band(Sq, Skv, True, q_offset, window)
    for g in got[1:]:
        assert not g[:, :lo].any() and not g[:, hi:].any()
    again = flash_attention_bwd(q, k, v, out, lse, dout, **kw)
    assert all(torch.equal(a, b) for a, b in zip(got, again))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("D,Dv,H,KH,causal", [(64, 64, 9, 3, True),
                                              (128, 128, 8, 2, False),
                                              (96, 64, 4, 4, True)])
def test_flash_attention_lse_output(dev, dtype, D, Dv, H, KH, causal):
    """The forward's lse within 1e-5 of the plain one; its output
    bit-equal with and without the lse."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_fwd, flash_attention_plain)
    rng = np.random.default_rng(D + H)
    q, k, v = (torch.from_numpy(rng.normal(size=s).astype(np.float32))
               .to(dev, dtype) for s in ((2, 150, H, D), (2, 150, KH, D),
                                         (2, 150, KH, Dv)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    assert lse.dtype == torch.float32 and lse.shape == (2, 150, H)
    assert torch.equal(out, flash_attention_fwd(q, k, v, causal=causal))
    _, want = flash_attention_plain(q, k, v, causal=causal, return_lse=True)
    assert (lse - want).abs().max().item() <= 1e-5


@pytest.mark.parametrize("causal", [True, False])
def test_flash_attention_bwd_misaligned_bf16_views(dev, causal):
    """bf16 q, k, v and dout that start 2 bytes past a 16-byte boundary
    (the kernel copies rows in 16-byte chunks): the wrapper copies them,
    and the gradients equal those of aligned copies bit for bit."""
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    rng = np.random.default_rng(17 + causal)

    def shifted(shape):
        n = int(np.prod(shape))
        flat = torch.from_numpy(rng.normal(size=n + 1).astype(np.float32))
        t = flat.to(dev, torch.bfloat16)[1:].view(shape)
        assert t.data_ptr() % 16 == 2
        return t

    q, k, v, dout = (shifted(s) for s in ((2, 130, 6, 64), (2, 130, 2, 64),
                                          (2, 130, 2, 64), (2, 130, 6, 64)))
    out, lse = flash_attention_fwd(q, k, v, causal=causal, return_lse=True)
    before = KB.LAUNCHES["flash_attention_bwd"]
    got = flash_attention_bwd(q, k, v, out, lse, dout, causal=causal)
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention_bwd"] == before + 1
    want = flash_attention_bwd(*(t.clone() for t in (q, k, v, out, lse,
                                                     dout)), causal=causal)
    assert all(torch.equal(a, b) for a, b in zip(got, want))


def test_flash_attention_bwd_rejects(dev):
    from repro_torch.kernels.flash_attention.flash_attention import (
        flash_attention_bwd, flash_attention_fwd)
    q = torch.randn((1, 8, 4, 64), device=dev)
    out, lse = flash_attention_fwd(q, q, q, return_lse=True)
    before = KB.LAUNCHES["flash_attention_bwd"]
    with pytest.raises(ValueError):
        flash_attention_bwd(q, q, q, out, lse[..., :2], out)
    with pytest.raises(ValueError):
        t = torch.randn((1, 8, 4, 16), device=dev)
        flash_attention_bwd(t, t, t, t, lse, t)        # D 16 is not built
    assert KB.LAUNCHES["flash_attention_bwd"] == before


def test_train_step_on_card_matches_cpu(dev):
    """A smoke SmolLM train step in float32 on the card: its gradients
    within 1e-4 (relative Frobenius a leaf) of the same gradients on the
    CPU (the kernels against their plain versions), 2 flash forward and 1
    backward launch a layer (remat), and the step repeats bit for bit.
    The parameters after an Adam step are not compared: its first update
    is sign(g) lr, which flips where |g| is below the two devices'
    rounding."""
    from repro_torch.configs import get_smoke
    from repro_torch.configs.base import TrainConfig
    from repro_torch.core.tree import tree_leaves, tree_map
    from repro_torch.launch import steps as S
    from repro_torch.launch.train import init_train_state
    torch.backends.cuda.matmul.allow_tf32 = False
    cfg = get_smoke("smollm_135m").replace(dtype="float32")
    tcfg = TrainConfig(learning_rate=1e-3, warmup_steps=1, total_steps=10)
    params, opt = init_train_state(cfg, tcfg, "cpu")
    tokens = torch.from_numpy(np.random.default_rng(0).integers(
        0, cfg.vocab_size, (4, 64)).astype(np.int32))
    g_cpu, ce_cpu = S.loss_grads(params, {"tokens": tokens}, cfg)
    gp = tree_map(lambda t: t.to(dev), params)
    g_card, ce_card = S.loss_grads(gp, {"tokens": tokens.to(dev)}, cfg)
    assert abs(float(ce_card) - float(ce_cpu)) <= 1e-5
    for a, b in zip(tree_leaves(g_card), tree_leaves(g_cpu)):
        assert _rel_frobenius(a.cpu(), b) <= 1e-4
    gopt = type(opt)(opt.step.to(dev), tree_map(lambda t: t.to(dev), opt.mu),
                     tree_map(lambda t: t.to(dev), opt.nu))
    step = S.make_train_step(cfg, tcfg)
    before = dict(KB.LAUNCHES)
    p_card, _, _ = step(gp, gopt, {"tokens": tokens.to(dev)})
    torch.cuda.synchronize()
    assert KB.LAUNCHES["flash_attention"] - before["flash_attention"] == \
        2 * cfg.num_layers
    assert KB.LAUNCHES["flash_attention_bwd"] - \
        before["flash_attention_bwd"] == cfg.num_layers
    p_again, _, _ = step(gp, gopt, {"tokens": tokens.to(dev)})
    assert all(torch.equal(a, b) for a, b in zip(tree_leaves(p_card),
                                                 tree_leaves(p_again)))


def test_train_adversary_repeats_on_card(dev):
    """The c-GAN adversary on the card gives the same SSIM and losses on
    every run (cuDNN's deterministic algorithms, upsampling without
    atomics), and leaves cuDNN's flags as it found them."""
    from repro_torch.configs import get_smoke
    from repro_torch.core import prng
    from repro_torch.models import layers as L
    from repro_torch.models import vgg as V
    from repro_torch.privacy import reconstruct as R
    cfg = get_smoke("vgg16")
    params = L.init_params_keyed(prng.PRNGKey(0), V.vgg_defs(cfg),
                                 torch.float32, "cpu")
    flags = (torch.backends.cudnn.deterministic,
             torch.backends.cudnn.benchmark)
    kw = dict(steps=12, batch=8, n_eval=16, device=dev)
    a = R.train_adversary(params, cfg, 1, **kw)
    b = R.train_adversary(params, cfg, 1, **kw)
    assert (a.ssim, a.g_loss, a.d_loss) == (b.ssim, b.g_loss, b.d_loss)
    assert np.isfinite([a.ssim, a.g_loss, a.d_loss]).all()
    assert (torch.backends.cudnn.deterministic,
            torch.backends.cudnn.benchmark) == flags
