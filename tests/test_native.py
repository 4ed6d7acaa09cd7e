"""Native C++ codec: bit-equality vs the golden codec and multithreaded
determinism (reference strategy: cross-backend identical streams,
codec_profile_test.inl:952-1043)."""

import numpy as np
import pytest

from ndzip_jax import format as fmt
from ndzip_jax import golden, native

if not native.available():
    pytest.skip("native codec unavailable", allow_module_level=True)

RNG = np.random.default_rng(99)

SHAPES = [
    ((4096,), np.float32),
    ((2**18 + 37,), np.float32),
    ((100,), np.float32),
    ((70, 65), np.float32),
    ((256, 256), np.float32),
    ((17, 16, 20), np.float32),
    ((48, 32, 33), np.float32),
    ((4097,), np.float64),
    ((65, 64), np.float64),
    ((33, 32, 48), np.float64),
]


def make_data(shape, dtype):
    data = RNG.standard_normal(shape).astype(dtype)
    flat = data.reshape(-1)
    if flat.size > 300:
        flat[:70] = 0
        flat[200:300] = flat[199]
    return data


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_native_stream_matches_golden(shape, dtype):
    data = make_data(shape, dtype)
    g_stream, g_len = golden.compress(data)
    n_stream, n_len = native.compress(data)
    assert n_len == g_len
    assert n_stream.tobytes() == g_stream.tobytes()


@pytest.mark.parametrize("shape,dtype", SHAPES)
def test_native_roundtrip(shape, dtype):
    data = make_data(shape, dtype)
    stream, _ = native.compress(data)
    out = native.decompress(stream, shape, dtype)
    assert np.array_equal(
        out.view(np.uint64 if dtype == np.float64 else np.uint32),
        data.view(np.uint64 if dtype == np.float64 else np.uint32))


def test_native_decodes_golden_and_vice_versa():
    data = make_data((70, 130), np.float32)
    g_stream, _ = golden.compress(data)
    out = native.decompress(g_stream, data.shape, np.float32)
    assert np.array_equal(out, data)
    n_stream, _ = native.compress(data)
    out2 = golden.decompress(n_stream, data.shape, np.float32)
    assert np.array_equal(out2, data)


@pytest.mark.parametrize("threads", [2, 4, 8])
def test_native_multithreaded_bit_identical(threads):
    # openmp-compressor analog: stream must equal the serial stream
    # (cpu_codec.inl:714-743 ordering invariant)
    data = RNG.standard_normal(2**20 + 133).astype(np.float32)
    serial, slen = native.compress(data, threads=1)
    mt, mlen = native.compress(data, threads=threads)
    assert mlen == slen
    assert mt.tobytes() == serial.tobytes()
    out = native.decompress(mt, data.shape, np.float32, threads=threads)
    assert np.array_equal(out, data)


def test_native_zero_hypercube_shapes():
    for shape in [(1,), (63, 63), (4095,)]:
        data = RNG.standard_normal(shape).astype(np.float32)
        stream, n = native.compress(data)
        out = native.decompress(stream, shape, np.float32)
        assert np.array_equal(out, data)


def test_native_bound_matches_format():
    for shape, wb in [((4097,), 32), ((70, 65), 64), ((17, 18, 19), 32)]:
        import ctypes

        lib = native._load()
        arr = (ctypes.c_uint64 * len(shape))(*shape)
        assert lib.ndzip_compressed_bound_words(wb, len(shape), arr) == \
            fmt.compressed_bound_words(shape, wb)


def test_portable_path_matches_avx512(tmp_path):
    """The codec has two compiled chunk-codec paths (AVX-512 mask-register
    kernels and the portable butterfly).  The default build picks one at
    compile time; this builds the *other* configuration and asserts both
    emit identical streams, so the fallback stays regression-tested on
    AVX-512 hosts (and vice versa)."""
    import ctypes
    import os
    import subprocess

    alt = tmp_path / "libndzip_cpu_noavx512.so"
    cmd = [os.environ.get("CXX", "g++"), "-O3", "-march=native",
           "-mno-avx512f", "-funroll-loops", "-std=c++17", "-shared",
           "-fPIC", str(native._SRC), "-o", str(alt)]
    res = subprocess.run(cmd, capture_output=True, text=True)
    if res.returncode != 0:
        pytest.skip(f"cannot build alt codec: {res.stderr[:300]}")
    lib = ctypes.CDLL(str(alt))
    lib.ndzip_compress.restype = ctypes.c_size_t
    lib.ndzip_compress.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int]
    lib.ndzip_decompress.restype = ctypes.c_size_t
    lib.ndzip_decompress.argtypes = [
        ctypes.c_int, ctypes.c_int, ctypes.c_void_p, ctypes.c_void_p,
        ctypes.c_void_p, ctypes.c_int]
    for shape, dtype in [((2**16 + 37,), np.float32), ((70, 65), np.float32),
                         ((4097,), np.float64), ((33, 32, 48), np.float64)]:
        data = make_data(shape, dtype)
        stream, n = native.compress(data)  # default build
        wb = 64 if dtype == np.float64 else 32
        bound = fmt.compressed_bound_words(shape, wb)
        wdt = np.uint64 if wb == 64 else np.uint32
        alt_stream = np.zeros(bound, wdt)
        arr = (ctypes.c_uint64 * len(shape))(*shape)
        got = lib.ndzip_compress(
            wb, len(shape), arr,
            np.ascontiguousarray(data).ctypes.data_as(ctypes.c_void_p),
            alt_stream.ctypes.data_as(ctypes.c_void_p), 1)
        assert got == n
        assert alt_stream[:n].view(np.uint32).tobytes() == \
            stream[:n * (wb // 32)].tobytes()
        out = np.empty(shape, dtype)
        lib.ndzip_decompress(
            wb, len(shape), arr,
            alt_stream.ctypes.data_as(ctypes.c_void_p),
            out.ctypes.data_as(ctypes.c_void_p), 1)
        assert np.array_equal(out.view(wdt), data.view(wdt))
