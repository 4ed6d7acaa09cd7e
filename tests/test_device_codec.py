"""The device codec through the public API (``ndzip_jax.compress`` /
``decompress`` with backend "auto", which is the XLA codec): streams
byte-equal to golden, bit-exact decodes of golden streams, and the border
box copies against the element-index reference."""

import jax.numpy as jnp
import numpy as np
import pytest

import ndzip_jax
from ndzip_jax import codec_xla, golden

RNG = np.random.default_rng(11)

SHAPES = [
    ((4096 * 8,), "1d"),
    ((4096 * 8 + 100,), "1d border"),
    ((128, 192), "2d"),
    ((32, 32, 33), "3d border"),
    ((128, 512), "2d tiled fast path"),
    ((130, 513), "2d tiled + border"),
    ((16, 32, 128), "3d tiled fast path"),
    ((17, 32, 129), "3d tiled + border"),
]


def make_data(shape):
    data = RNG.standard_normal(shape).astype(np.float32)
    flat = data.reshape(-1)
    flat[:200] = 0
    flat[300:340] = flat[299]
    return data


@pytest.mark.parametrize("shape,label", SHAPES)
def test_encode_matches_golden(shape, label):
    data = make_data(shape)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl
    assert s.tobytes() == g.tobytes()


@pytest.mark.parametrize("shape,label", SHAPES)
def test_decodes_golden(shape, label):
    data = make_data(shape)
    g, _ = golden.compress(data)
    out = ndzip_jax.decompress(g, shape, np.float32)
    assert np.array_equal(out.view(np.uint32), data.view(np.uint32))


def test_all_zero_blocks():
    data = np.zeros((4096 * 8,), np.float32)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl and s.tobytes() == g.tobytes()
    out = ndzip_jax.decompress(s, data.shape, np.float32)
    assert np.array_equal(out, data)


SHAPES64 = [
    ((4096 * 8,), "1d"),
    ((4096 * 3 + 1,), "1d border, odd block count"),
    ((128, 70), "2d border"),
    ((16, 32, 32), "3d"),
    ((128, 512), "2d tiled fast path"),
    ((17, 16, 128), "3d tiled + axis-0 border"),
]


def make_data64(shape):
    data = RNG.standard_normal(shape)
    flat = data.reshape(-1)
    flat[:200] = 0
    flat[300:340] = flat[299]
    return data


@pytest.mark.parametrize("shape,label", SHAPES64)
def test_fp64_encode_matches_golden(shape, label):
    data = make_data64(shape)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl
    assert s.tobytes() == g.tobytes()


@pytest.mark.parametrize("shape,label", SHAPES64)
def test_fp64_decodes_golden(shape, label):
    data = make_data64(shape)
    g, _ = golden.compress(data)
    out = ndzip_jax.decompress(g, shape, np.float64)
    assert np.array_equal(out.view(np.uint64), data.view(np.uint64))


def test_fp64_all_zero_blocks():
    data = np.zeros((4096 * 8,), np.float64)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl and s.tobytes() == g.tobytes()
    out = ndzip_jax.decompress(s, data.shape, np.float64)
    assert np.array_equal(out, data)


# Shapes users run, cut down: unaligned 2D (the CESM 1800x3600 field at
# 1/10 and 1/8), 3D with a border on one axis only, exactly one block,
# one block + 1, and all-border grids (no whole block at all).
EXTRA = [
    ((180, 360), np.float32, "cesm / 10"),
    ((225, 450), np.float32, "cesm / 8"),
    ((180, 360), np.float64, "cesm / 10 fp64"),
    ((40, 32, 32), np.float32, "3d border on axis 0 only"),
    ((32, 40, 32), np.float32, "3d border on axis 1 only"),
    ((32, 32, 40), np.float32, "3d border on axis 2 only"),
    ((16, 16, 24), np.float64, "3d fp64 border on axis 2 only"),
    ((4096,), np.float32, "1d one block"),
    ((4097,), np.float32, "1d one block + 1"),
    ((4096,), np.float64, "1d fp64 one block"),
    ((64, 64), np.float32, "2d one block"),
    ((65, 64), np.float32, "2d one block + 1 row"),
    ((16, 16, 16), np.float64, "3d fp64 one block"),
    ((16, 16, 17), np.float32, "3d one block + 1"),
    ((4095,), np.float32, "1d all-border"),
    ((63, 200), np.float32, "2d all-border"),
    ((15, 40, 40), np.float64, "3d fp64 all-border"),
]


def make_field(shape, dtype):
    n = int(np.prod(shape))
    data = (np.sin(np.arange(n) * 1e-2) + 1e-4 * RNG.standard_normal(n)).astype(dtype)
    data[: n // 3] = 0
    return data.reshape(shape)


@pytest.mark.parametrize("shape,dtype,label", EXTRA)
def test_stream_matches_golden_extra(shape, dtype, label):
    data = make_field(shape, dtype)
    g, gl = golden.compress(data)
    s, l = ndzip_jax.compress(data)
    assert l == gl and s.tobytes() == g.tobytes()


@pytest.mark.parametrize("shape,dtype,label", EXTRA)
def test_decodes_golden_extra(shape, dtype, label):
    data = make_field(shape, dtype)
    g, _ = golden.compress(data)
    out = ndzip_jax.decompress(g, shape, dtype)
    wdt = np.uint64 if dtype == np.float64 else np.uint32
    assert np.array_equal(out.view(wdt), data.view(wdt))


# ------------------------------------------------------ border box copies

BORDERS = [
    ((4096 * 2,), "1d aligned"),
    ((4096 * 2 + 77,), "1d border"),
    ((100,), "1d all-border"),
    ((128, 130), "2d border on axis 1"),
    ((130, 128), "2d border on axis 0"),
    ((130, 131), "2d border on both axes"),
    ((20, 300), "2d all-border"),
    ((33, 32, 32), "3d border on axis 0"),
    ((32, 33, 32), "3d border on axis 1"),
    ((32, 32, 33), "3d border on axis 2"),
    ((33, 34, 35), "3d border on every axis"),
    ((10, 40, 40), "3d all-border"),
]


def _words(shape):
    return RNG.integers(0, 2**32, shape, dtype=np.uint32)


@pytest.mark.parametrize("shape,label", BORDERS)
def test_border_take_matches_element_indices(shape, label):
    words = _words(shape)
    expect = words.reshape(-1)[codec_xla._border_indices(shape)]
    got = np.asarray(codec_xla._border_take(jnp.asarray(words), shape))
    assert np.array_equal(got, expect)


@pytest.mark.parametrize("shape,label", BORDERS)
def test_border_place_matches_element_indices(shape, label):
    idx = codec_xla._border_indices(shape)
    base = _words(shape)
    bv = _words((idx.size,))
    expect = base.copy().reshape(-1)
    expect[idx] = bv
    got = np.asarray(codec_xla._border_place(jnp.asarray(base), jnp.asarray(bv), shape))
    assert np.array_equal(got.reshape(-1), expect)
