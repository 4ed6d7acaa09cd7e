"""Seeded fuzz: random shapes (borders, tiny and degenerate extents) x
random sparsity patterns, checked bit-exactly against the golden codec
through the public API's device codec.  The analog of the reference's
randomized per-profile property tests (codec_profile_test.inl:37-96),
widened across shape space."""

import numpy as np
import pytest

import ndzip_jax
from ndzip_jax import golden

RNG = np.random.default_rng(1234)


def _random_shape(rng, dims):
    if dims == 1:
        n = int(rng.integers(1, 5)) * 4096 + int(rng.integers(0, 300))
        return (n,)
    if dims == 2:
        return (int(rng.integers(1, 4)) * 64 + int(rng.integers(0, 70)),
                int(rng.integers(1, 9)) * 64 + int(rng.integers(0, 70)))
    return tuple(int(rng.integers(1, 4)) * 16 + int(rng.integers(0, 18))
                 for _ in range(3))


def _random_data(rng, shape, dtype):
    n = int(np.prod(shape))
    style = rng.integers(0, 4)
    if style == 0:      # smooth (high compression)
        data = np.sin(np.arange(n) * 1e-3).astype(dtype)
    elif style == 1:    # random (incompressible)
        data = rng.standard_normal(n).astype(dtype)
    elif style == 2:    # mostly zero with random spikes
        data = np.zeros(n, dtype)
        idx = rng.integers(0, n, max(1, n // 50))
        data[idx] = rng.standard_normal(idx.size)
    else:               # constant runs
        data = np.repeat(rng.standard_normal(max(1, n // 97 + 1)),
                         97)[:n].astype(dtype)
    return data.reshape(shape)


CASES = [(d, dt, s) for s in range(2) for d in (1, 2, 3)
         for dt in (np.float32, np.float64)]


PADDED_SHAPES = [
    # block grid with an odd minor axis and borders on every axis, 2D and 3D
    ((200, 27 * 64 + 13), np.float32),
    ((17, 33, 15 * 16 + 9), np.float32),
    ((130, 27 * 64 + 5), np.float64),
]


@pytest.mark.parametrize("shape,dtype", PADDED_SHAPES)
def test_padded_tile_decode_bit_exact(shape, dtype):
    rng = np.random.default_rng(7)
    data = _random_data(rng, shape, dtype)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl and s.tobytes() == g.tobytes(), f"{shape}: stream mismatch"
    out = ndzip_jax.decompress(g, shape, dtype)
    wdt = np.uint64 if dtype == np.float64 else np.uint32
    assert np.array_equal(out.view(wdt), data.view(wdt)), f"{shape}"


@pytest.mark.parametrize("dims,dtype,seed", CASES)
def test_fuzz_round_trip_bit_exact(dims, dtype, seed):
    rng = np.random.default_rng(1000 * seed + dims)
    shape = _random_shape(rng, dims)
    data = _random_data(rng, shape, dtype)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl, f"{shape} {dtype}: length {l} != {gl}"
    assert s.tobytes() == g.tobytes(), f"{shape} {dtype}: stream mismatch"
    out = ndzip_jax.decompress(g, shape, dtype)
    wdt = np.uint64 if dtype == np.float64 else np.uint32
    assert np.array_equal(out.view(wdt), data.view(wdt)), f"{shape} {dtype}"


# ------------------------------------------------------- parallel-layer fuzz

SHARD_CASES = [(d, dt, s) for s in range(2) for d in (1, 2)
               for dt in (np.float32, np.float64)]


@pytest.mark.parametrize("dims,dtype,seed", SHARD_CASES)
def test_fuzz_sharded_round_trip(dims, dtype, seed):
    """Random shapes x random mesh sizes through the sharded layer
    (uneven shard padding, sub-stream slicing), bit-exact vs golden."""
    import jax

    from ndzip_jax.parallel import compress_sharded, decompress_sharded, \
        make_mesh

    rng = np.random.default_rng(7000 + 100 * seed + dims)
    devs = jax.devices()
    if len(devs) < 2:
        pytest.skip("needs multiple devices")
    n_dev = int(rng.integers(2, min(8, len(devs)) + 1))
    mesh = make_mesh(devs[:n_dev])
    for _ in range(3):
        shape = _random_shape(rng, dims)
        if golden and np.prod([s // (4096 if dims == 1 else 64)
                               for s in shape]).astype(int) == 0:
            continue  # all-border: sharded layer rejects by contract
        data = _random_data(rng, shape, dtype)
        try:
            stream, length = compress_sharded(data, mesh)
        except ValueError:
            continue  # no whole blocks to shard
        expect, elen = golden.compress(data)
        assert length == elen and stream.tobytes() == expect.tobytes(), \
            f"{shape} x {n_dev} shards: stream mismatch"
        out = decompress_sharded(stream, shape, dtype, mesh)
        wdt = np.uint64 if dtype == np.float64 else np.uint32
        assert np.array_equal(out.view(wdt), data.view(wdt)), \
            f"{shape} x {n_dev} shards: decode mismatch"
