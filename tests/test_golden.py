"""Golden (numpy) codec tests: property tests and bit-equality vs the naive
scalar spec encoder.  Test ladder mirrors the reference strategy
(/root/reference/src/test/codec_generic_test.cc, codec_profile_test.inl)."""

import numpy as np
import pytest

from ndzip_jax import format as fmt
from ndzip_jax import golden
from ndzip_jax.ops import bitops

from scalar_spec import compress as scalar_compress, transpose_bits as scalar_transpose

RNG = np.random.default_rng(1234)


def rand_words(size, dtype):
    bits = np.dtype(dtype).itemsize * 8
    return RNG.integers(0, 2**bits, size=size, dtype=dtype)


def random_data(shape, dtype):
    if np.dtype(dtype) == np.float32:
        return RNG.standard_normal(shape, dtype=np.float32)
    return RNG.standard_normal(shape, dtype=np.float64)


# ---------------------------------------------------------------- bit ops

@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_rotate_roundtrip(dtype):
    x = rand_words(1000, dtype)
    assert np.array_equal(bitops.rotate_right_1(bitops.rotate_left_1(x)), x)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_complement_involution(dtype):
    x = rand_words(1000, dtype)
    assert np.array_equal(bitops.complement_negative(bitops.complement_negative(x)), x)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_transpose_involution(dtype):
    bits = np.dtype(dtype).itemsize * 8
    x = rand_words((17, bits), dtype)
    tt = bitops.transpose_bits(bitops.transpose_bits(x))
    assert np.array_equal(tt, x)


@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_transpose_matches_scalar(dtype):
    bits = np.dtype(dtype).itemsize * 8
    x = rand_words((3, bits), dtype)
    t = bitops.transpose_bits(x)
    for row_in, row_out in zip(x, t):
        expect = scalar_transpose([int(v) for v in row_in], bits)
        assert [int(v) for v in row_out] == expect


def test_transpose_pair32_matches_u64():
    x = RNG.integers(0, 2**64, size=(5, 64), dtype=np.uint64)
    hi = (x >> np.uint64(32)).astype(np.uint32)
    lo = (x & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    t = bitops.transpose_bits(x)
    thi, tlo = bitops.transpose_bits_pair32(hi, lo)
    recombined = (thi.astype(np.uint64) << np.uint64(32)) | tlo.astype(np.uint64)
    assert np.array_equal(recombined, t)


def test_popcount():
    x = rand_words(1000, np.uint32)
    expect = np.array([bin(int(v)).count("1") for v in x])
    assert np.array_equal(bitops.popcount_np(x), expect)
    y = RNG.integers(0, 2**64, size=1000, dtype=np.uint64)
    expect = np.array([bin(int(v)).count("1") for v in y])
    assert np.array_equal(bitops.popcount_np(y), expect)


# ---------------------------------------------------------------- transform

@pytest.mark.parametrize("dims", [1, 2, 3])
@pytest.mark.parametrize("dtype", [np.uint32, np.uint64])
def test_block_transform_reversible(dims, dtype):
    bits = np.dtype(dtype).itemsize * 8
    blocks = rand_words((4, fmt.HC_SIZE), dtype)
    fwd = golden.block_transform(blocks, dims)
    inv = golden.inverse_block_transform(fwd, dims)
    assert np.array_equal(inv, blocks)


# ---------------------------------------------------------------- format

def test_border_slices_2d():
    # 70x70 with side 64: 64 row-tails of 6 plus one bottom band of 6*70
    slices = fmt.border_slices((70, 70))
    assert len(slices) == 65
    assert slices[0] == (64, 6)
    assert slices[63] == (63 * 70 + 64, 6)
    assert slices[64] == (64 * 70, 6 * 70)
    total = sum(c for _, c in slices)
    assert total == 70 * 70 - 64 * 64 == fmt.border_element_count((70, 70))


def test_border_slices_all_border():
    assert fmt.border_slices((100,)) == [(0, 100)]
    assert fmt.border_slices((10, 100)) == [(0, 1000)]


def test_border_slices_none():
    assert fmt.border_slices((4096,)) == []
    assert fmt.border_slices((128, 64)) == []


def test_header_words():
    assert fmt.header_words(5, 32) == 5
    assert fmt.header_words(5, 64) == 3  # 20 bytes -> 24 bytes -> 3 u64
    assert fmt.header_u32_words(5, 64) == 6
    assert fmt.header_words(4, 64) == 2


def test_gather_scatter_blocks_roundtrip():
    w = rand_words((70, 130), np.uint32)
    blocks = golden.gather_blocks(w)
    assert blocks.shape == (2, 4096)
    # first block must equal the top-left 64x64 tile, row-major
    assert np.array_equal(blocks[0], w[:64, :64].reshape(-1))
    assert np.array_equal(blocks[1], w[:64, 64:128].reshape(-1))
    back = golden.scatter_blocks(blocks, (70, 130), np.uint32)
    assert np.array_equal(back[:64, :64], w[:64, :64])
    assert np.array_equal(back[:64, 64:128], w[:64, 64:128])


# ---------------------------------------------------------------- roundtrip

SHAPES = [
    ((4096,), "1d exact"),
    ((4097,), "1d border 1"),
    ((8192,), "1d two blocks"),
    ((12288 + 17,), "1d three blocks + border"),
    ((100,), "1d all border"),
    ((64, 64), "2d exact"),
    ((70, 70), "2d borders both axes"),
    ((64, 130), "2d border minor"),
    ((130, 64), "2d border major"),
    ((16, 16, 16), "3d exact"),
    ((17, 18, 19), "3d borders"),
    ((32, 16, 33), "3d mixed"),
    ((5, 5, 5), "3d all border"),
]


@pytest.mark.parametrize("shape,label", SHAPES)
@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_golden_roundtrip(shape, label, dtype):
    data = random_data(shape, dtype)
    stream, length = golden.compress(data)
    wb = fmt.word_bits_for_dtype(dtype)
    assert length == stream.size * 4 // (wb // 8)
    assert length <= fmt.compressed_bound_words(shape, wb)
    out = golden.decompress(stream, shape, dtype)
    assert out.dtype == np.dtype(dtype)
    assert np.array_equal(out.view(np.uint32 if wb == 32 else np.uint64),
                          data.view(np.uint32 if wb == 32 else np.uint64))


@pytest.mark.parametrize("dtype", [np.float32, np.float64])
def test_golden_roundtrip_zero_first_chunk(dtype):
    # regression input from codec_profile_test.inl:49-50: an all-zero first
    # chunk exercises the zero-head fast path
    dims = 1
    side = fmt.SIDE_LENGTH[dims]
    data = random_data((4 * side - 1,), dtype)
    data[: fmt.word_bits_for_dtype(dtype)] = 0
    stream, _ = golden.compress(data)
    out = golden.decompress(stream, data.shape, dtype)
    assert np.array_equal(out, data)


def test_golden_roundtrip_all_zero():
    data = np.zeros((2, 64, 64), dtype=np.float32).reshape(64, 128)
    stream, length = golden.compress(data)
    # 2 blocks: header 2 words + 2 * 128 heads, no body, no border
    assert length == 2 + 2 * 128
    out = golden.decompress(stream, (64, 128), np.float32)
    assert np.array_equal(out, data)


@pytest.mark.parametrize("shape", [(0,), (1,), (63, 63), (4095,)])
def test_golden_zero_hypercubes(shape):
    # codec_profile_test.inl:1045-1082 edge cases
    data = random_data(shape, np.float32)
    stream, _ = golden.compress(data)
    out = golden.decompress(stream, shape, np.float32)
    assert np.array_equal(out, data)


# ------------------------------------------------- vs scalar spec encoder

SCALAR_SHAPES = [
    ((4096,), np.float32),
    ((4100,), np.float32),
    ((70, 65), np.float32),
    ((17, 16, 20), np.float32),
    ((4097,), np.float64),
    ((65, 64), np.float64),
    ((16, 17, 16), np.float64),
]


@pytest.mark.parametrize("shape,dtype", SCALAR_SHAPES)
def test_golden_matches_scalar_spec(shape, dtype):
    data = random_data(shape, dtype)
    # plant zero regions to exercise zero-word compaction
    flat = data.reshape(-1)
    flat[:70] = 0
    flat[200:300] = flat[199]
    expect = scalar_compress(data)
    got, _ = golden.compress(data)
    assert got.tobytes() == expect.tobytes()
