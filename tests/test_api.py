"""Public-API surface tests: factories, offloader, requirements
(reference surface: include/ndzip/ndzip.hh:228-269, offload.hh:8-71)."""

import numpy as np
import pytest

from ndzip_jax import api


def test_unknown_backend_raises():
    with pytest.raises(ValueError, match="unknown backend"):
        api.make_compressor(np.float32, 1, backend="cuda")


def test_dtype_and_dims_validation():
    with pytest.raises(ValueError):
        api.make_compressor(np.int8, 1, backend="golden")
    with pytest.raises(ValueError):
        api.make_compressor(np.float32, 4, backend="golden")
    comp = api.make_compressor(np.float32, 2, backend="golden")
    with pytest.raises(ValueError, match="dimensionality"):
        comp.compress(np.zeros(16, np.float32))
    with pytest.raises(ValueError, match="dtype"):
        comp.compress(np.zeros((4, 4), np.float64))


def test_requirements_accumulate_and_validate():
    req = api.CompressorRequirements((4096,), (8192,))
    assert req.max_num_hypercubes == 2
    req.include((4096 * 5,))
    assert req.max_num_hypercubes == 5
    with pytest.raises(ValueError, match="dimensionality"):
        req.include((64, 64))


def test_requirements_precompile_xla():
    shape = (4096 * 2 + 7,)
    req = api.CompressorRequirements(shape)
    comp = api.make_compressor(np.float32, 1, backend="xla", requirements=req)
    data = np.sin(np.arange(shape[0], dtype=np.float32))
    stream, words = comp.compress(data)
    dec = api.make_decompressor(np.float32, 1, backend="xla")
    out = dec.decompress(stream, shape)
    assert np.array_equal(out, data)


def test_offloader_round_trip_and_timing():
    data = np.sin(np.arange(4096 * 3 + 5, dtype=np.float32))
    off = api.make_offloader("golden", np.float32, 1)
    stream, words = off.compress(data)
    assert off.timing.compress_ns > 0
    out = off.decompress(stream, data.shape)
    assert off.timing.decompress_ns > 0
    assert np.array_equal(out, data)
    assert off.compressed_length_bound(data.shape) >= words


def test_offloader_backend_resolution():
    off = api.make_offloader("auto", np.float64, 2)
    assert off.backend == "xla"
    data = np.ones((70, 66), np.float64)
    stream, _ = off.compress(data)
    assert np.array_equal(off.decompress(stream, data.shape), data)


def test_device_api_roundtrip_fp32():
    """compress_device/decompress_device keep data on-device end to end
    (cuda.hh:10-41 analog) and the stream is bit-identical to golden."""
    import jax
    import jax.numpy as jnp

    from ndzip_jax import format as fmt, golden

    data = np.sin(np.arange(4096 * 2 + 9, dtype=np.float32) * 0.01)
    dev = jnp.asarray(data)
    stream, length = api.compress_device(dev)
    assert isinstance(stream, jax.Array) and isinstance(length, jax.Array)
    g, gl = golden.compress(data)
    assert int(length) == gl
    assert np.asarray(stream[: int(length)]).tobytes() == g.tobytes()

    out = api.decompress_device(stream, data.shape, np.float32)
    assert isinstance(out, jax.Array)
    assert out.dtype == jnp.float32
    assert np.array_equal(np.asarray(out), data)

    # compress_device's buffer is decode-ready as it is: exactly the
    # decoder's bound, so the round trip needs no device reallocation
    assert stream.shape[0] == fmt.compressed_bound_u32(data.shape, 32)

    # short (exact-length) streams are padded on the device
    out2 = api.decompress_device(stream[: int(length)], data.shape)
    assert isinstance(out2, jax.Array)
    assert np.array_equal(np.asarray(out2), data)


def test_device_api_roundtrip_fp64_planes():
    import jax.numpy as jnp

    from ndzip_jax import golden
    from ndzip_jax.ops import u64pair

    data = np.cos(np.arange(4160, dtype=np.float64).reshape(65, 64))
    lo, hi = u64pair.split(data.view(np.uint64))
    stream, length = api.compress_device((jnp.asarray(lo), jnp.asarray(hi)))
    g, gl = golden.compress(data)
    assert np.asarray(stream[: int(length)]).tobytes() == g.tobytes()

    out_lo, out_hi = api.decompress_device(stream, data.shape, np.float64)
    got = u64pair.join(np.asarray(out_lo), np.asarray(out_hi)).view(np.float64)
    assert np.array_equal(got.reshape(data.shape), data)


def test_device_api_rejects_bad_dtype():
    import jax.numpy as jnp

    with pytest.raises(ValueError, match="device compress"):
        api.compress_device(jnp.zeros(4096, jnp.int8))


def test_offloader_device_timing_mode():
    """timing_mode='device' stages input first and fences the jitted codec
    (offload.hh:16-24 kernel_duration semantics)."""
    from ndzip_jax import golden

    data = np.sin(np.arange(4096 * 2 + 3, dtype=np.float32))
    g, gl = golden.compress(data)
    off = api.Offloader(np.float32, 1, backend="xla", timing_mode="device")
    stream, words = off.compress(data)
    assert off.timing.compress_ns > 0
    assert words == gl and stream.tobytes() == g.tobytes()
    out = off.decompress(stream, data.shape)
    assert off.timing.decompress_ns > 0
    assert np.array_equal(out, data)

    # host backends silently fall back to wall timing
    off_host = api.Offloader(np.float32, 1, backend="golden", timing_mode="device")
    assert off_host.timing_mode == "wall"

    with pytest.raises(ValueError, match="timing_mode"):
        api.Offloader(np.float32, 1, timing_mode="events")


def test_offloader_measure_chained():
    data = np.sin(np.arange(4096 * 2, dtype=np.float32))
    off = api.Offloader(np.float32, 1, backend="xla")
    timing = off.measure(data, chains=(2, 10))
    assert timing.compress_ns > 0 and timing.decompress_ns > 0

    off_host = api.Offloader(np.float32, 1, backend="golden")
    with pytest.raises(ValueError, match="jitted backend"):
        off_host.measure(data)


def test_backend_env_override_and_probe(monkeypatch):
    """backend="auto" honors NDZIP_BACKEND, explicit backends bypass
    it, and auto resolves to the device codec."""
    monkeypatch.setenv("NDZIP_BACKEND", "golden")
    assert api._resolve_backend("auto") == "golden"
    monkeypatch.delenv("NDZIP_BACKEND")
    assert api._resolve_backend("cpu") == "cpu"
    assert api._resolve_backend("auto") == "xla"


def test_sharded_backend_roundtrip():
    """api/CLI backend 'sharded': block-parallel over all visible devices,
    byte-identical streams."""
    import numpy as np

    from ndzip_jax import api, golden

    data = np.sin(np.arange(4096 * 9 + 7) * 1e-3).astype(np.float32)
    c = api.make_compressor(np.float32, 1, "sharded")
    d = api.make_decompressor(np.float32, 1, "sharded")
    stream, words = c.compress(data)
    g, gl = golden.compress(data)
    assert words == gl and stream.tobytes() == g.tobytes()
    out = d.decompress(stream, data.shape)
    assert np.array_equal(out, data)


# ------------------------------------------------------ backend resolution

def test_auto_resolves_to_xla(monkeypatch):
    monkeypatch.delenv("NDZIP_BACKEND", raising=False)
    assert api.make_compressor(np.float32, 1).__class__.__name__ == "_XlaCompressor"
    assert api.make_offloader("auto", np.float32, 3).backend == "xla"


@pytest.mark.parametrize("factory", [api.make_compressor, api.make_decompressor])
def test_pallas_backend_rejected(factory):
    with pytest.raises(ValueError, match="unknown backend 'pallas'"):
        factory(np.float32, 1, backend="pallas")


def test_pallas_rejected_by_cli(capsys):
    from ndzip_jax import cli

    with pytest.raises(SystemExit):
        cli.build_parser().parse_args(["-n", "4096", "-e", "pallas"])
    assert "invalid choice: 'pallas'" in capsys.readouterr().err


def test_jax_init_failure_raises(monkeypatch):
    """A JAX that cannot start makes "auto" raise; it never degrades to
    a host codec."""
    import jax

    def broken():
        raise RuntimeError("Unable to initialize backend 'cuda'")

    monkeypatch.delenv("NDZIP_BACKEND", raising=False)
    monkeypatch.setattr(jax, "default_backend", broken)
    with pytest.raises(RuntimeError, match="Unable to initialize"):
        api._resolve_backend("auto")
    with pytest.raises(RuntimeError, match="Unable to initialize"):
        api.make_offloader("auto", np.float32, 1)
    assert api._resolve_backend("golden") == "golden"


# ------------------------------------------------ device API, every profile

PROFILES = [
    ((4096 * 3,), np.float32, "fp32 1d aligned"),
    ((4096 * 3 + 11,), np.float32, "fp32 1d bordered"),
    ((128, 192), np.float32, "fp32 2d aligned"),
    ((130, 197), np.float32, "fp32 2d bordered"),
    ((32, 32, 48), np.float32, "fp32 3d aligned"),
    ((33, 34, 49), np.float32, "fp32 3d bordered"),
    ((4096 * 2,), np.float64, "fp64 1d aligned"),
    ((4096 * 2 + 5,), np.float64, "fp64 1d bordered"),
    ((64, 128), np.float64, "fp64 2d aligned"),
    ((66, 129), np.float64, "fp64 2d bordered"),
    ((16, 32, 16), np.float64, "fp64 3d aligned"),
    ((17, 33, 18), np.float64, "fp64 3d bordered"),
]


def _profile_data(shape, dtype):
    rng = np.random.default_rng(sum(shape))
    n = int(np.prod(shape))
    data = np.sin(np.arange(n) * 3e-3) + 1e-3 * rng.standard_normal(n)
    data[: n // 4] = 0
    return data.astype(dtype).reshape(shape)


@pytest.mark.parametrize("shape,dtype,label", PROFILES)
def test_device_api_profiles(shape, dtype, label):
    import jax
    import jax.numpy as jnp

    from ndzip_jax import golden
    from ndzip_jax.ops import u64pair

    data = _profile_data(shape, dtype)
    g, _ = golden.compress(data)
    if dtype == np.float64:
        arg = tuple(jnp.asarray(p) for p in u64pair.split(data.view(np.uint64)))
    else:
        arg = jnp.asarray(data)
    stream, length = api.compress_device(arg)
    assert np.asarray(stream[: int(length)]).tobytes() == g.tobytes()
    out = api.decompress_device(stream[: int(length)], shape, dtype)
    for leaf in jax.tree_util.tree_leaves(out):
        assert isinstance(leaf, jax.Array) and leaf.shape == shape
    if dtype == np.float64:
        words = u64pair.join(np.asarray(out[0]), np.asarray(out[1]))
        assert np.array_equal(words, data.view(np.uint64))
    else:
        assert np.array_equal(np.asarray(out).view(np.uint32), data.view(np.uint32))


@pytest.mark.parametrize("shape,dtype,label", PROFILES[1::2])
def test_offloader_device_timing_profiles(shape, dtype, label):
    from ndzip_jax import golden

    data = _profile_data(shape, dtype)
    g, gl = golden.compress(data)
    off = api.Offloader(dtype, len(shape), backend="xla", timing_mode="device")
    stream, words = off.compress(data)
    assert off.timing.compress_ns > 0
    assert words == gl and stream.tobytes() == g.tobytes()
    out = off.decompress(stream, shape)
    assert off.timing.decompress_ns > 0
    assert out.dtype == dtype and out.tobytes() == data.tobytes()
