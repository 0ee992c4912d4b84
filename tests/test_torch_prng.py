"""The port's threefry generator (core/prng.py) is bit-equal to jax.random
under the installed jax."""
import numpy as np
import pytest
import torch

# one intra-op thread: the suite runs in several worker processes at once
torch.set_num_threads(1)

jax = pytest.importorskip("jax")
import jax.numpy as jnp  # noqa: E402

from repro_torch.core import prng  # noqa: E402

P = (1 << 23) - 15
SEEDS = [0, 1, 42, 2 ** 31 - 1, 2 ** 31 + 5, 2 ** 32 - 1]
SHAPES = [(1,), (2,), (5,), (3, 7), (1001,), (4, 1, 33)]


def _keys():
    """(jax key, port key) pairs: fresh seeds and derived keys."""
    out = []
    for seed in SEEDS:
        jk = jax.random.PRNGKey(seed)
        out.append((jk, prng.PRNGKey(seed)))
    jk = jax.random.fold_in(jax.random.PRNGKey(9), 0xFA17)
    out.append((jk, np.asarray(jk)))
    return out


def test_counter_layout_matches_installed_jax():
    """The port draws in the partitionable counter layout; the reference's
    streams are only comparable when jax uses it too."""
    assert bool(jax.config.jax_threefry_partitionable) == prng.PARTITIONABLE


@pytest.mark.parametrize("seed", SEEDS)
def test_prngkey(seed):
    np.testing.assert_array_equal(prng.PRNGKey(seed),
                                  np.asarray(jax.random.PRNGKey(seed)))


@pytest.mark.parametrize("data", [0, 1, 7, 0x5ECC, 0xFA17, 2 ** 31,
                                  2 ** 32 - 1])
def test_fold_in_and_split(data):
    for jk, tk in _keys():
        np.testing.assert_array_equal(
            prng.fold_in(tk, data), np.asarray(jax.random.fold_in(jk, data)))
    jk, tk = _keys()[2]
    for num in (2, 3):
        for a, b in zip(prng.split(tk, num), jax.random.split(jk, num)):
            np.testing.assert_array_equal(a, np.asarray(b))


@pytest.mark.parametrize("shape", SHAPES)
def test_bits(shape):
    for jk, tk in _keys():
        want = np.asarray(jax.random.bits(jk, shape, jnp.uint32))
        got = prng.bits(tk, shape)
        assert got.dtype == torch.int64 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want.astype(np.int64))


@pytest.mark.parametrize("shape", SHAPES)
@pytest.mark.parametrize("lo,hi", [(0, P), (0, 1000), (3, 2 ** 16 - 7),
                                   (0, 2 ** 31 - 1)])
def test_randint(shape, lo, hi):
    for jk, tk in _keys():
        want = np.asarray(jax.random.randint(jk, shape, lo, hi,
                                             dtype=jnp.int32))
        got = prng.randint(tk, shape, lo, hi)
        assert got.dtype == torch.int32
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [()] + SHAPES)
def test_uniform(shape):
    for jk, tk in _keys():
        want = np.asarray(jax.random.uniform(jk, shape))
        got = prng.uniform(tk, shape)
        assert got.dtype == torch.float32 and tuple(got.shape) == shape
        np.testing.assert_array_equal(got.numpy(), want)


def test_mul32_wraps_like_uint32(rng):
    a = rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64)
    b = rng.integers(0, 2 ** 32, 10_000, dtype=np.uint64)
    want = (a.astype(np.uint32) * b.astype(np.uint32)).astype(np.int64)
    got = prng.mul32(torch.from_numpy(a.astype(np.int64)),
                     torch.from_numpy(b.astype(np.int64)))
    np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("lo,hi", [(0, 23), (0, 2), (1, 2), (1, 7),
                                   (0, 64), (1, 64), (0, 200_704),
                                   (1, 200_704), (0, 2 ** 16 + 3)])
def test_scalar_draws_of_the_fault_injector(lo, hi):
    """The fault injector's draws: scalar ``()`` shapes over small spans
    and row counts, from keys split three ways."""
    for jk, tk in _keys():
        jsub = jax.random.split(jax.random.fold_in(jk, 1), 3)
        tsub = prng.split(prng.fold_in(tk, 1), 3)
        for a, b in zip(tsub, jsub):
            np.testing.assert_array_equal(a, np.asarray(b))
            got = prng.randint(a, (), lo, hi)
            assert got.dtype == torch.int32 and got.shape == ()
            assert int(got) == int(jax.random.randint(b, (), lo, hi,
                                                      dtype=jnp.int32))
            bits = prng.bits(a, ())
            assert bits.shape == ()
            assert int(bits) == int(jax.random.bits(b, (), jnp.uint32))


TINY = float(np.finfo(np.float32).tiny)
BOUNDS = [(0.0, 1.0), (TINY, 1.0), (-3.5, 2.25), (0.1, 0.7), (-1e3, 1e-3),
          (1e-30, 1e3)]
# torch's float32 log and XLA:CPU's may differ in the last ulp; the noise
# -log(-log(u)) is held to jax within GUMBEL_ULPS ulps of max(|g|, 1)
GUMBEL_ULPS = 4


@pytest.mark.parametrize("lo,hi", BOUNDS)
def test_uniform_with_bounds(lo, hi):
    """jax rounds ``f * (hi - lo) + lo`` once (XLA:CPU fuses it into an
    FMA); the port's float64 round-to-odd gives the same bits."""
    for jk, tk in _keys():
        for shape in ((), (1001,), (4, 1, 33)):
            want = np.asarray(jax.random.uniform(jk, shape, minval=lo,
                                                 maxval=hi))
            got = prng.uniform(tk, shape, lo, hi)
            assert got.dtype == torch.float32 and tuple(got.shape) == shape
            np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape", [(7,), (4, 512), (2, 49152)])
def test_gumbel_within_ulps(shape):
    for jk, tk in _keys():
        want = np.asarray(jax.random.gumbel(jk, shape))
        got = prng.gumbel(tk, shape).numpy()
        ulp = np.spacing(np.maximum(np.abs(want), 1.0).astype(np.float32))
        assert (np.abs(got - want) <= GUMBEL_ULPS * ulp).all()


@pytest.mark.parametrize("temperature", [0.5, 0.8, 1.0, 2.0])
@pytest.mark.parametrize("shape,axis", [((4, 1000), -1), ((3, 49152), -1),
                                        ((2, 64, 5), 1)])
def test_categorical_matches_jax(temperature, shape, axis):
    logits = (np.random.default_rng(len(shape) + int(temperature * 10))
              .normal(size=shape).astype(np.float32) * 3.0)
    for jk, tk in _keys():
        scaled = logits / np.float32(temperature)
        want = np.asarray(jax.random.categorical(jk, jnp.asarray(scaled),
                                                 axis=axis))
        got = prng.categorical(tk, torch.from_numpy(scaled), axis=axis)
        np.testing.assert_array_equal(got.numpy(), want)


@pytest.mark.parametrize("shape,chunk", [
    ((100_003,), 8192), ((7, 5, 300), 333), ((62, 40, 96), 40_000),
    ((), 3)])
def test_normal_in_counter_ranges_bit_equal_to_one_draw(shape, chunk,
                                                        monkeypatch):
    """``normal`` draws a large leaf in counter ranges: the same bits as one
    draw over the whole stream, whatever the range's size."""
    for _, tk in _keys():
        monkeypatch.setattr(prng, "NORMAL_CHUNK", 1 << 40)
        whole = prng.normal(tk, shape)
        monkeypatch.setattr(prng, "NORMAL_CHUNK", chunk)
        got = prng.normal(tk, shape)
        assert got.shape == whole.shape
        assert torch.equal(got, whole)
