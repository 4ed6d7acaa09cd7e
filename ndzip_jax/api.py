"""Public API: compressor / decompressor / offloader objects and factories.

Mirrors the reference public surface (include/ndzip/ndzip.hh:228-269 and
include/ndzip/offload.hh:8-71):

  * ``Compressor`` / ``Decompressor`` — stateful per-(dtype, dims) codec
    objects (analog of ``compressor<T>`` / ``decompressor<T>``).
  * ``make_compressor(dtype, dims, backend, threads)`` — factory
    (``make_compressor`` / ``make_decompressor``, ndzip.hh:249-253).
  * ``Offloader`` — round-trip host-pointer interface that also reports the
    device kernel duration in nanoseconds (``offloader<T>::compress(...,
    kernel_duration)``, offload.hh:16-24).
  * ``CompressorRequirements`` — accumulates the maximum block count over
    multiple shapes so device codecs can pre-build/compile once
    (ndzip.hh:255-269).

Backends: "golden" (numpy oracle), "cpu" (native C++), "xla" (the jitted
device codec), "sharded" (the device codec block-parallel over every
visible device) and "auto" ("xla", the device codec on JAX's default
platform).  All emit bit-identical streams.
"""

from __future__ import annotations

import os
import time
from dataclasses import dataclass

import numpy as np

from . import format as fmt
from . import utils


class CompressorRequirements:
    """ndzip.hh:255-269 — accumulate max #hypercubes over planned shapes."""

    def __init__(self, *shapes):
        self.dims = None
        self.max_num_hypercubes = 0
        self.shapes = []
        for s in shapes:
            self.include(s)

    def include(self, shape):
        shape = tuple(shape)
        fmt.validate_shape(shape)
        if self.dims is None:
            self.dims = len(shape)
        elif self.dims != len(shape):
            raise ValueError("all shapes in requirements must share dimensionality")
        self.shapes.append(shape)
        self.max_num_hypercubes = max(self.max_num_hypercubes, fmt.num_hypercubes(shape))
        return self


@dataclass
class KernelTiming:
    """Most recent device-kernel duration (ns); -1 when not measured."""

    compress_ns: int = -1
    decompress_ns: int = -1


def _require_dtype_dims(dtype, dims):
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    if not 1 <= dims <= fmt.MAX_DIMENSIONALITY:
        raise ValueError(f"dims must be 1..{fmt.MAX_DIMENSIONALITY}")
    return dtype, wb


class Compressor:
    def __init__(self, dtype, dims):
        self.dtype, self.word_bits = _require_dtype_dims(dtype, dims)
        self.dims = dims

    def _check(self, data):
        if data.ndim != self.dims:
            raise ValueError(
                f"data dimensionality {data.ndim} does not match compressor dimensionality {self.dims}")
        if np.dtype(data.dtype) != self.dtype:
            raise ValueError(f"data dtype {data.dtype} != compressor dtype {self.dtype}")

    def compress(self, data) -> tuple[np.ndarray, int]:
        raise NotImplementedError


class Decompressor:
    def __init__(self, dtype, dims):
        self.dtype, self.word_bits = _require_dtype_dims(dtype, dims)
        self.dims = dims

    def decompress(self, stream, shape) -> np.ndarray:
        raise NotImplementedError


class _GoldenCompressor(Compressor):
    def compress(self, data):
        from . import golden

        data = np.ascontiguousarray(data)
        self._check(data)
        return golden.compress(data)


class _GoldenDecompressor(Decompressor):
    def decompress(self, stream, shape):
        from . import golden

        return golden.decompress(np.asarray(stream), tuple(shape), self.dtype)


class _NativeCompressor(Compressor):
    def __init__(self, dtype, dims, threads=1):
        super().__init__(dtype, dims)
        self.threads = threads

    def compress(self, data):
        from . import native

        data = np.ascontiguousarray(data)
        self._check(data)
        return native.compress(data, threads=self.threads)


class _NativeDecompressor(Decompressor):
    def __init__(self, dtype, dims, threads=1):
        super().__init__(dtype, dims)
        self.threads = threads

    def decompress(self, stream, shape):
        from . import native

        return native.decompress(np.asarray(stream), tuple(shape), self.dtype,
                                 threads=self.threads)


class _XlaCompressor(Compressor):
    def compress(self, data):
        from . import codec_xla

        data = np.ascontiguousarray(data)
        self._check(data)
        return codec_xla.compress(data)


class _XlaDecompressor(Decompressor):
    def decompress(self, stream, shape):
        from . import codec_xla

        return codec_xla.decompress(np.asarray(stream), tuple(shape), self.dtype)


def _resolve_backend(backend: str) -> str:
    """``auto`` means the device codec.  Its platform is initialised here, so
    a JAX that cannot start raises instead of silently turning into a host
    codec; the host codecs stay reachable by name."""
    if backend == "auto":
        backend = os.environ.get("NDZIP_BACKEND", "auto")
    if backend != "auto":
        return backend
    import jax

    jax.default_backend()
    return "xla"


class _ShardedCompressor(Compressor):
    """Single-host multi-device backend: block-parallel shard_map over every
    visible device (parallel/sharded.py); the stream is byte-identical to
    every single-device backend.  Shapes with no whole hypercube block
    (all-border) are rejected — use a single-device backend for those."""

    def compress(self, data):
        from .parallel import sharded

        data = np.ascontiguousarray(data)
        self._check(data)
        return sharded.compress_sharded(data, sharded.make_mesh())


class _ShardedDecompressor(Decompressor):
    def decompress(self, stream, shape):
        from .parallel import sharded

        return sharded.decompress_sharded(
            np.asarray(stream), tuple(shape), self.dtype, sharded.make_mesh())


_COMPRESSORS = {
    "golden": _GoldenCompressor,
    "cpu": _NativeCompressor,
    "native": _NativeCompressor,
    "xla": _XlaCompressor,
    "sharded": _ShardedCompressor,
}
_DECOMPRESSORS = {
    "golden": _GoldenDecompressor,
    "cpu": _NativeDecompressor,
    "native": _NativeDecompressor,
    "xla": _XlaDecompressor,
    "sharded": _ShardedDecompressor,
}


def _precompile(backend: str, dtype, requirements: "CompressorRequirements"):
    """The jit-world meaning of compressor_requirements (ndzip.hh:255-269):
    where the reference pre-sizes GPU scratch buffers for the largest
    planned input, the device codec pre-compiles its per-shape programs so
    the first real compress call does not pay the trace + XLA compile."""
    if backend != "xla":
        return
    from . import codec_xla

    wb = fmt.word_bits_for_dtype(dtype)
    for shape in requirements.shapes:
        zero = np.zeros(shape, dtype)
        stream, _ = codec_xla.compress(zero)
        codec_xla.decompress(stream, shape, dtype)


def make_compressor(dtype, dims, backend="auto", threads=1, requirements=None) -> Compressor:
    backend = _resolve_backend(backend)
    cls = _COMPRESSORS.get(backend)
    if cls is None:
        raise ValueError(f"unknown backend {backend!r}; options: {sorted(_COMPRESSORS)}")
    if requirements is not None:
        _precompile(backend, dtype, requirements)
    if cls is _NativeCompressor:
        return cls(dtype, dims, threads=threads)
    return cls(dtype, dims)


def make_decompressor(dtype, dims, backend="auto", threads=1) -> Decompressor:
    backend = _resolve_backend(backend)
    cls = _DECOMPRESSORS.get(backend)
    if cls is None:
        raise ValueError(f"unknown backend {backend!r}; options: {sorted(_DECOMPRESSORS)}")
    if cls is _NativeDecompressor:
        return cls(dtype, dims, threads=threads)
    return cls(dtype, dims)


def compress_device(data):
    """Device-resident compress, the analog of the reference's
    device-pointer compressors (cuda.hh:10-41): input, stream and length
    never leave the device, so a JAX program can compress an array it
    already holds there (e.g. before a transfer or a checkpoint write).

    ``data``: a float32/uint32 ``jax.Array`` of 1-3 dims, or a ``(lo, hi)``
    tuple of uint32 plane arrays for fp64 payloads (see ops/u64pair for
    host-side splitting).

    Returns ``(stream, length)``: ``stream`` is a u32 device buffer of
    ``format.compressed_bound_u32`` words that ``decompress_device`` takes
    as it is, ``length`` a device int32 scalar of occupied u32 words.
    ``stream[:length]`` is byte-identical to every other backend's
    output."""
    from . import codec_xla

    if isinstance(data, tuple):
        lo, hi = data
        if lo.dtype != np.uint32 or hi.dtype != np.uint32 or lo.shape != hi.shape:
            raise ValueError("fp64 device compress takes (lo, hi) uint32 planes "
                             "of one shape")
        fmt.validate_shape(lo.shape)
        return codec_xla.encode_fn(tuple(lo.shape), 64)(lo, hi)
    if data.dtype not in (np.float32, np.uint32):
        raise ValueError(
            f"device compress supports float32/uint32 arrays or (lo, hi) "
            f"uint32 plane tuples, got {data.dtype}")
    fmt.validate_shape(data.shape)
    return codec_xla.encode_fn(tuple(data.shape), 32)(data)


def decompress_device(stream, shape, dtype=np.float32):
    """Device-resident decompress (cuda.hh:28-41 analog).  ``stream`` is a
    u32 device array holding the compressed chunk from word 0;
    ``compress_device``'s buffer is taken as it is, and shorter buffers
    (e.g. ``stream[:length]``) are zero-padded on the device first.
    Returns a ``jax.Array`` of ``shape``: float32/uint32 for 32-bit dtypes,
    a ``(lo, hi)`` uint32 plane tuple for fp64."""
    import jax
    import jax.numpy as jnp

    from . import codec_xla

    shape = tuple(shape)
    fmt.validate_shape(shape)
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    out = codec_xla.decode_fn(shape, wb)(codec_xla.pad_stream(stream, shape, wb))
    if dtype == np.float32:
        out = jax.lax.bitcast_convert_type(out, jnp.float32)
    return out


class Offloader:
    """Host-array in/out round-trip interface with kernel timing
    (offload.hh:8-71).

    ``timing_mode`` selects what ``timing`` reports after each call:

    * ``"wall"`` (default) — wall time of the codec call including host
      staging and dispatch (cheapest; matches round-1 behavior).
    * ``"device"`` — the reference's ``kernel_duration`` semantics
      (offload.hh:16-24, cuda_codec.inl:687-704): the input is staged to
      the device and fenced FIRST, then the jitted codec is timed between
      ``block_until_ready`` fences — host<->device transfer excluded,
      one dispatch included.  Only meaningful for the jitted backend
      (xla); host backends fall back to wall time.

    ``measure(data)`` runs the two-point chained-loop protocol (the
    bench.py device-timing method: two fori_loop chain lengths, slope of
    the best-of-3 wall times) for dispatch-free device numbers, filling
    ``timing`` with the result."""

    def __init__(self, dtype, dims, backend="auto", threads=1,
                 timing_mode="wall"):
        if timing_mode not in ("wall", "device"):
            raise ValueError("timing_mode must be 'wall' or 'device'")
        self.backend = _resolve_backend(backend)
        self._comp = make_compressor(dtype, dims, self.backend, threads)
        self._dec = make_decompressor(dtype, dims, self.backend, threads)
        self.dtype = self._comp.dtype
        self.dims = dims
        self.timing = KernelTiming()
        self.timing_mode = timing_mode if self.backend == "xla" else "wall"

    def compress(self, data) -> tuple[np.ndarray, int]:
        if self.timing_mode == "device":
            return self._compress_device_timed(data)
        t0 = time.perf_counter_ns()
        stream, words = self._comp.compress(data)
        self.timing.compress_ns = time.perf_counter_ns() - t0
        return stream, words

    def decompress(self, stream, shape) -> np.ndarray:
        if self.timing_mode == "device":
            return self._decompress_device_timed(stream, shape)
        t0 = time.perf_counter_ns()
        out = self._dec.decompress(stream, shape)
        self.timing.decompress_ns = time.perf_counter_ns() - t0
        return out

    # -- device-fenced timing (timing_mode="device") ------------------

    def _stage_words(self, data):
        import jax.numpy as jnp

        from .ops import u64pair

        data = np.ascontiguousarray(data)
        self._comp._check(data)
        if self._comp.word_bits == 64:
            lo, hi = u64pair.split(data.view(np.uint64))
            return (jnp.asarray(lo), jnp.asarray(hi))
        return jnp.asarray(data.view(np.uint32))

    def _compress_device_timed(self, data):
        dev = self._stage_words(data)
        stream, length = None, None

        def run(d):
            nonlocal stream, length
            stream, length = compress_device(d)
            return stream

        self.timing.compress_ns = utils.device_time_ns(run, dev)
        length = int(length)
        words = length // (self._comp.word_bits // 32)
        return np.asarray(stream[:length]), words

    def _decompress_device_timed(self, stream, shape):
        import jax.numpy as jnp

        from . import codec_xla
        from .ops import u64pair

        shape = tuple(shape)
        wb = self._comp.word_bits
        # pre-pad on the host so buffer growth never lands in the timing
        padded = np.zeros(fmt.compressed_bound_u32(shape, wb), np.uint32)
        padded[: np.asarray(stream).size] = stream
        fn = codec_xla.decode_fn(shape, wb)
        dev = jnp.asarray(padded)
        out = None

        def run(s):
            nonlocal out
            out = fn(s)
            return out

        self.timing.decompress_ns = utils.device_time_ns(run, dev)
        if wb == 64:
            return u64pair.join(np.asarray(out[0]), np.asarray(out[1])).view(
                self.dtype).reshape(shape)
        return np.asarray(out).view(self.dtype).reshape(shape)

    # -- chained-loop measurement (dispatch-free device time) ---------

    def measure(self, data, chains=(10, 50)) -> KernelTiming:
        """Fill ``timing`` with chained-loop device durations for one
        compress and one decompress of ``data`` (jitted backend only):
        each chain folds the codec N times inside one fori_loop dispatch,
        and the per-call time is the slope between the two chain lengths —
        no host-sync or dispatch overhead in the figure, the protocol
        of bench.py and ubench.py."""
        if self.backend != "xla":
            raise ValueError("measure() requires the jitted backend (xla)")
        from . import benchmark as _bench

        comp_ns, dec_ns = _bench.chained_device_times(data, chains=chains)
        self.timing.compress_ns = comp_ns
        self.timing.decompress_ns = dec_ns
        return self.timing

    def compressed_length_bound(self, shape) -> int:
        return fmt.compressed_bound_words(tuple(shape), self._comp.word_bits)


def make_offloader(backend, dtype, dims, threads: int = 1, **kwargs) -> Offloader:
    return Offloader(dtype, dims, backend=backend, threads=threads, **kwargs)
