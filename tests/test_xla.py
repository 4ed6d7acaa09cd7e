"""XLA codec: bit-equality vs golden, roundtrip, and stage-level checks
(the reference's cross-backend bit-equality ladder,
codec_profile_test.inl:100-141,514-729, adapted to backend=XLA)."""

import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from ndzip_jax import codec_xla, format as fmt, golden
from ndzip_jax.ops import bitops, u64pair

RNG = np.random.default_rng(4242)


def make_data(shape, dtype):
    data = RNG.standard_normal(shape).astype(dtype)
    flat = data.reshape(-1)
    if flat.size > 300:
        flat[:70] = 0
        flat[200:300] = flat[199]
    return data


# ------------------------------------------------------------ stage equality

@pytest.mark.parametrize("dims", [1, 2, 3])
def test_transform_u32_matches_golden(dims):
    blocks = RNG.integers(0, 2**32, size=(3, fmt.HC_SIZE), dtype=np.uint32)
    expect = golden.block_transform(blocks, dims)
    fwd = jax.jit(codec_xla.block_transform_u32, static_argnums=1)
    bwd = jax.jit(codec_xla.inverse_block_transform_u32, static_argnums=1)
    got = np.asarray(fwd(jnp.asarray(blocks), dims))
    assert np.array_equal(got, expect)
    inv = np.asarray(bwd(jnp.asarray(got), dims))
    assert np.array_equal(inv, blocks)


@pytest.mark.parametrize("dims", [1, 2, 3])
def test_transform_pair_matches_golden(dims):
    blocks = RNG.integers(0, 2**64, size=(2, fmt.HC_SIZE), dtype=np.uint64)
    expect = golden.block_transform(blocks, dims)
    lo, hi = u64pair.split(blocks)
    fwd = jax.jit(codec_xla.block_transform_pair, static_argnums=2)
    bwd = jax.jit(codec_xla.inverse_block_transform_pair, static_argnums=2)
    glo, ghi = fwd(jnp.asarray(lo), jnp.asarray(hi), dims)
    got = u64pair.join(np.asarray(glo), np.asarray(ghi))
    assert np.array_equal(got, expect)
    ilo, ihi = bwd(glo, ghi, dims)
    back = u64pair.join(np.asarray(ilo), np.asarray(ihi))
    assert np.array_equal(back, blocks)


def test_transpose_bits_jnp_matches_numpy():
    x = RNG.integers(0, 2**32, size=(7, 32), dtype=np.uint32)
    a = bitops.transpose_bits(x, np)
    b = np.asarray(jax.jit(functools.partial(bitops.transpose_bits, xp=jnp))(jnp.asarray(x)))
    assert np.array_equal(a, b)


def test_u64pair_cumsum_jnp():
    x = RNG.integers(0, 2**64, size=(4, 100), dtype=np.uint64)
    lo, hi = u64pair.split(x)
    clo, chi = jax.jit(lambda a, b: u64pair.cumsum(a, b, 1, jnp))(jnp.asarray(lo), jnp.asarray(hi))
    expect = np.cumsum(x, axis=1, dtype=np.uint64)
    assert np.array_equal(u64pair.join(np.asarray(clo), np.asarray(chi)), expect)


# ------------------------------------------------------------ full streams

SHAPES = [
    ((4096,), np.float32),
    ((2**16 + 37,), np.float32),
    ((100,), np.float32),
    ((70, 65), np.float32),
    ((256, 192), np.float32),
    ((17, 16, 20), np.float32),
    ((48, 32, 33), np.float32),
    ((4097,), np.float64),
    ((65, 64), np.float64),
    ((33, 32, 48), np.float64),
]


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_xla_stream_matches_golden(shape, dtype):
    data = make_data(shape, dtype)
    g_stream, g_len = golden.compress(data)
    x_stream, x_len = codec_xla.compress(data)
    assert x_len == g_len
    assert x_stream.tobytes() == g_stream.tobytes()


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_xla_decodes_golden_stream(shape, dtype):
    data = make_data(shape, dtype)
    g_stream, _ = golden.compress(data)
    out = codec_xla.decompress(g_stream, shape, dtype)
    wdt = np.uint64 if dtype == np.float64 else np.uint32
    assert np.array_equal(out.view(wdt), data.view(wdt))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_xla_special_values(dtype):
    odd = np.array([np.nan, np.inf, -np.inf, -0.0, 0.0, 1e-42, -1e-300 if dtype == np.float64 else -1e-42],
                   dtype=dtype)
    data = np.tile(odd, 1200)[: 4096 + 13].astype(dtype)
    stream, _ = codec_xla.compress(data)
    g_stream, _ = golden.compress(data)
    assert stream.tobytes() == g_stream.tobytes()
    out = codec_xla.decompress(stream, data.shape, dtype)
    wdt = np.uint64 if dtype == np.float64 else np.uint32
    assert np.array_equal(out.view(wdt), data.view(wdt))


def test_xla_all_zero():
    data = np.zeros((64, 128), dtype=np.float32)
    stream, length = codec_xla.compress(data)
    assert length == 2 + 2 * 128
    out = codec_xla.decompress(stream, (64, 128), np.float32)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("shape", [(1,), (63, 63)])
def test_xla_zero_hypercubes(shape):
    data = make_data(shape, np.float32)
    stream, _ = codec_xla.compress(data)
    g_stream, _ = golden.compress(data)
    assert stream.tobytes() == g_stream.tobytes()
    out = codec_xla.decompress(stream, shape, np.float32)
    assert np.array_equal(out, data)
