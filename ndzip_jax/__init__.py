"""ndzip_jax — a JAX lossless compressor for 1-3D float32/float64
scientific data, implementing the ndzip stream format (celerity/ndzip).

Backends:
  * ``golden``      — vectorized numpy reference (bit-exactness oracle)
  * ``native``      — C++ serial / multi-threaded CPU codec (ctypes)
  * ``codec_xla``   — the jitted device codec (GPU; CPU in the tests)
  * ``parallel``    — the device codec block-parallel over a device mesh
All backends produce bit-identical streams.
"""

from . import format  # noqa: F401
from .format import Profile, profile_for, compressed_bound_words, num_hypercubes  # noqa: F401

__version__ = "0.1.0"


def compress(data, backend="auto", **kwargs):
    """Compress a 1-3D float32/float64 numpy/JAX array; returns
    (stream_uint32, length_words)."""
    from .api import make_offloader

    return make_offloader(backend, data.dtype, data.ndim, **kwargs).compress(data)


def decompress(stream, shape, dtype, backend="auto", **kwargs):
    """Decompress a uint32 stream into an array of ``shape``/``dtype``."""
    from .api import make_offloader

    return make_offloader(backend, dtype, len(shape), **kwargs).decompress(stream, shape)


def compress_device(data):
    """Device-resident compress of a jax.Array: returns (stream u32
    jax.Array, length i32 scalar) without the data ever leaving the
    device.  The analog of the reference's cuda_compressor
    (include/ndzip/cuda.hh:10-41); see api.compress_device."""
    from .api import compress_device as f

    return f(data)


def decompress_device(stream, shape, dtype="float32"):
    """Device-resident decompress (cuda.hh:28-41 analog); see
    api.decompress_device."""
    from .api import decompress_device as f

    return f(stream, shape, dtype)
