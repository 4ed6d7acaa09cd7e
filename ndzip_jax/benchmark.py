"""Benchmark harness — the JAX port of the reference's benchmark
driver (/root/reference/src/benchmark/benchmark.cc).

Reproduces the reference's measurement methodology exactly:

* Dataset registry: CSV lines ``name;float|double;d0 [d1 [d2]]`` naming raw
  little-endian ``.f32``/``.f64`` dumps relative to the CSV's directory
  (benchmark.cc:102-125, docs/benchmarking.md:20-34).  ``--synthetic``
  generates the BASELINE.json config set in a temp dir instead.
* Repetition protocol: one warm-up rep, then reps until the accumulated
  time reaches ``--min-time`` (default 1 s), at least ``--min-reps``, at
  most ``--max-reps`` = 100 (benchmark.cc:128-136,193-228).
* Cache trashing between host-codec reps: a 256 MiB buffer walk so CPU
  timings aren't flattered by residency (benchmark.cc:147-156).
* Device timing for the GPU codec: N invocations chained inside one jitted
  fori_loop, synced once and divided by N — the analog of CUDA-event
  kernel timing, excluding host<->device transfer (benchmark.cc:331-341).
* Correctness gate: every algorithm round-trips and the output is compared
  bit-exactly against the input on every benchmark run
  (benchmark.cc:263-265,346).
* Output CSV: ``dataset;data type;dimensions;algorithm;tunable;number of
  threads;compression times (microseconds);decompression times
  (microseconds);uncompressed bytes;compressed bytes`` with comma-joined
  rep lists (benchmark.cc:1332-1337) — parseable by the reference's
  plot_benchmark.py and vice versa.

Third-party competitors (benchmark.cc:1196-1253 builds 18 of them from
vendored submodules; no pip installs are possible in this image, so we
integrate everything importable plus a native reimplementation): memcpy,
zlib/deflate, lzma, bz2, zstd, fpc (native C++, see
native/competitors.cc), and auto-activating fpzip/zfp/blosc2 wrappers
that skip gracefully while those packages are absent.
"""

from __future__ import annotations

import argparse
import os
import sys
import tempfile
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

from . import format as fmt

MAX_REPS_DEFAULT = 100
CACHE_TRASH_BYTES = 256 * 1024 * 1024  # benchmark.cc:147


@dataclass
class Dataset:
    name: str
    path: Path
    dtype: np.dtype
    shape: tuple

    def load(self) -> np.ndarray:
        data = np.fromfile(self.path, dtype=self.dtype)
        n = int(np.prod(self.shape))
        if data.size != n:
            raise ValueError(
                f"{self.path}: has {data.size} elements, metadata says {n}")
        return data.reshape(self.shape)


def read_dataset_registry(csv_path: Path) -> list[Dataset]:
    """Parse the reference's metadata CSV (benchmark.cc:102-125)."""
    out = []
    base = csv_path.parent
    for line in csv_path.read_text().splitlines():
        line = line.strip()
        if not line or line.startswith("#"):
            continue
        parts = [p.strip() for p in line.split(";")]
        if len(parts) != 3:
            raise ValueError(f"malformed dataset line: {line!r}")
        name, typ, dims_s = parts
        dtype = np.dtype(np.float32 if typ == "float" else np.float64)
        if typ not in ("float", "double"):
            raise ValueError(f"bad data type {typ!r} in line {line!r}")
        shape = tuple(int(x) for x in dims_s.split())
        out.append(Dataset(name, base / name, dtype, shape))
    return out


def make_synthetic(tmpdir: Path) -> list[Dataset]:
    """Generate the BASELINE.json benchmark configs as raw dumps.  Each
    family mimics a reference-suite data class: a smooth 1D signal, a
    CESM-like 2D field smooth along BOTH axes, a 3D scalar field, an fp64
    random walk (the FPC/GFC home turf), and a mostly-zero 3D field
    (exercises zero-word elimination).  Each dataset draws from its own
    seeded rng so content is deterministic regardless of which files
    already exist on disk."""

    def smooth1d(shape, dt, rng):
        t = np.arange(shape[0], dtype=np.float64) * 1e-4
        return (np.sin(t) + 0.001 * rng.standard_normal(shape[0])).astype(dt)

    def field2d(shape, dt, rng):
        y = np.linspace(0, 11.0, shape[0])[:, None]
        x = np.linspace(0, 7.0, shape[1])[None, :]
        f = (np.sin(y) * np.cos(x) + 0.3 * np.sin(3.1 * y + 0.5 * x)
             + 0.002 * rng.standard_normal(shape))
        return f.astype(dt)

    def field3d(shape, dt, rng):
        z = np.linspace(0, 5.0, shape[0])[:, None, None]
        y = np.linspace(0, 4.0, shape[1])[None, :, None]
        x = np.linspace(0, 6.0, shape[2])[None, None, :]
        f = (np.sin(z) * np.sin(y) * np.cos(x)
             + 0.2 * np.cos(2.7 * z * y * 0.1 + x)
             + 0.002 * rng.standard_normal(shape))
        return f.astype(dt)

    def walk1d(shape, dt, rng):
        return np.cumsum(rng.standard_normal(shape[0]) * 1e-3).astype(dt)

    def sparse3d(shape, dt, rng):
        f = field3d(shape, np.float64, rng)
        mask = rng.random(shape) < 0.05
        return (f * mask).astype(dt)

    specs = [
        ("sin1d.f32", np.float32, (2**24,), smooth1d),
        ("grid2d.f32", np.float32, (1800, 3600), field2d),
        ("cube3d.f64", np.float64, (256, 256, 256), field3d),
        ("walk1d.f64", np.float64, (2**23,), walk1d),
        ("sparse3d.f32", np.float32, (128, 128, 256), sparse3d),
    ]
    tmpdir.mkdir(parents=True, exist_ok=True)
    sets = []
    for i, (name, dt, shape, gen) in enumerate(specs):
        path = tmpdir / name
        nbytes = int(np.prod(shape)) * np.dtype(dt).itemsize
        if not path.exists() or path.stat().st_size != nbytes:
            gen(shape, dt, np.random.default_rng(i)).tofile(path)
        sets.append(Dataset(name, path, np.dtype(dt), shape))
    return sets


# ------------------------------------------------------------------ timing


class _CacheTrasher:
    """Touch 256 MiB between reps so host timings include cold cache
    effects (benchmark.cc:147-156)."""

    def __init__(self):
        self._buf = None

    def trash(self):
        if self._buf is None:
            self._buf = np.ones(CACHE_TRASH_BYTES // 8, dtype=np.int64)
        self._buf += 1


_TRASHER = _CacheTrasher()


def _rep_loop(fn, min_time: float, min_reps: int, max_reps: int,
              trash_cache: bool) -> list[float]:
    """Reference rep protocol (benchmark.cc:193-228): warm-up + timed reps."""
    fn()  # warm-up (also triggers any jit compile)
    times = []
    total = 0.0
    while len(times) < max_reps and (total < min_time or len(times) < min_reps):
        if trash_cache:
            _TRASHER.trash()
        t0 = time.perf_counter()
        fn()
        dt = time.perf_counter() - t0
        times.append(dt)
        total += dt
    return times


# ------------------------------------------------------------------ algorithms


@dataclass
class BenchResult:
    algorithm: str
    tunable: int
    threads: int
    comp_times: list[float]
    decomp_times: list[float]
    uncompressed_bytes: int
    compressed_bytes: int


class Algorithm:
    name = "?"
    tunables = (1,)
    threaded = False  # True: sweep the -T thread list (parallel algorithms)

    def available(self, dataset: Dataset) -> bool:
        return True

    def run(self, data: np.ndarray, tunable: int, threads: int,
            min_time: float, min_reps: int, max_reps: int) -> BenchResult:
        raise NotImplementedError


class _ByteCodecAlgorithm(Algorithm):
    """Generic byte-stream compressor benched on the raw array bytes."""

    trash_cache = True

    def _compress(self, buf: bytes, tunable: int) -> bytes:
        raise NotImplementedError

    def _decompress(self, comp: bytes, out_len: int) -> bytes:
        raise NotImplementedError

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        buf = data.tobytes()
        comp = self._compress(buf, tunable)
        out = self._decompress(comp, len(buf))
        assert out == buf, f"{self.name}: round-trip failed"
        comp_times = _rep_loop(lambda: self._compress(buf, tunable),
                               min_time, min_reps, max_reps, self.trash_cache)
        decomp_times = _rep_loop(lambda: self._decompress(comp, len(buf)),
                                 min_time, min_reps, max_reps, self.trash_cache)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, len(buf), len(comp))


class MemcpyAlgorithm(Algorithm):
    """Upper-bound baseline (benchmark.cc memcpy integration)."""

    name = "memcpy"

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        src = np.frombuffer(data.tobytes(), dtype=np.uint8)
        dst = np.empty_like(src)

        def do():
            np.copyto(dst, src)

        do()
        assert dst.tobytes() == src.tobytes()
        comp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, src.nbytes, src.nbytes)


class MemcpyMtAlgorithm(Algorithm):
    """Threaded memcpy baseline (benchmark.cc "memcpy-mt"): the DRAM
    bandwidth ceiling with -T threads.  np.copyto on large slices releases
    the GIL, so plain Python threads scale the copy."""

    name = "memcpy-mt"
    threaded = True

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import threading

        src = np.frombuffer(data.tobytes(), dtype=np.uint8)
        dst = np.empty_like(src)
        t = max(1, threads)
        cuts = [src.nbytes * i // t for i in range(t + 1)]

        def do():
            ts = [threading.Thread(
                target=np.copyto,
                args=(dst[cuts[i]:cuts[i + 1]], src[cuts[i]:cuts[i + 1]]))
                for i in range(t)]
            for th in ts:
                th.start()
            for th in ts:
                th.join()

        do()
        assert dst.tobytes() == src.tobytes()
        comp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(do, min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, t, comp_times,
                           decomp_times, src.nbytes, src.nbytes)


class ZlibAlgorithm(_ByteCodecAlgorithm):
    name = "deflate"
    tunables = (1, 9)

    def _compress(self, buf, tunable):
        import zlib

        return zlib.compress(buf, tunable)

    def _decompress(self, comp, out_len):
        import zlib

        return zlib.decompress(comp)


class LzmaAlgorithm(_ByteCodecAlgorithm):
    name = "lzma"
    tunables = (1,)

    def _compress(self, buf, tunable):
        import lzma

        return lzma.compress(buf, preset=tunable)

    def _decompress(self, comp, out_len):
        import lzma

        return lzma.decompress(comp)


class Bz2Algorithm(_ByteCodecAlgorithm):
    name = "bzip2"
    tunables = (1,)

    def _compress(self, buf, tunable):
        import bz2

        return bz2.compress(buf, tunable)

    def _decompress(self, comp, out_len):
        import bz2

        return bz2.decompress(comp)


class ZstdAlgorithm(_ByteCodecAlgorithm):
    name = "zstd"
    tunables = (1, 19)

    def available(self, dataset):
        try:
            import zstandard  # noqa: F401

            return True
        except ImportError:
            return False

    def _compress(self, buf, tunable):
        import zstandard

        return zstandard.ZstdCompressor(level=tunable).compress(buf)

    def _decompress(self, comp, out_len):
        import zstandard

        return zstandard.ZstdDecompressor().decompress(comp, max_output_size=out_len)


class FpcAlgorithm(Algorithm):
    """FPC double-precision predictive compressor (native C++
    reimplementation, native/competitors.cc) — the first of the
    reference's domain-compressor competitors (benchmark.cc:1196-1253
    "fpc").  Tunable = log2 of the predictor table entries, matching the
    FPC level sweep (the reference benches its default level)."""

    name = "fpc"
    tunables = (16,)

    def available(self, dataset):
        if np.dtype(dataset.dtype) != np.float64:
            return False  # FPC is a double-precision algorithm
        from . import competitors

        return competitors.fpc_available()

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.fpc_compress(flat, tunable)
        out = competitors.fpc_decompress(comp, flat.size, tunable)
        assert np.array_equal(out.view(np.uint64), flat.view(np.uint64)), \
            "fpc: round-trip failed"
        # pad + allocate outside the rep loop: only the codec is timed
        padded, dst = competitors.pad_stream(comp), np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.fpc_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.fpc_decompress(padded, flat.size, tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class PfpcAlgorithm(Algorithm):
    """pFPC: chunk-parallel FPC over std::thread (native/competitors.cc),
    following the pFPC design vendored by the reference (benchmark.cc
    "pfpc").  Sweeps the -T thread list like ndzip-cpu; tunable = log2
    predictor table entries, as for fpc."""

    name = "pfpc"
    tunables = (16,)
    threaded = True

    def available(self, dataset):
        if np.dtype(dataset.dtype) != np.float64:
            return False  # FPC is a double-precision algorithm
        from . import competitors

        return competitors.fpc_available()

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.pfpc_compress(flat, tunable, threads)
        out = competitors.pfpc_decompress(comp, flat.size, tunable)
        assert np.array_equal(out.view(np.uint64), flat.view(np.uint64)), \
            "pfpc: round-trip failed"
        padded, dst = competitors.pad_stream(comp), np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.pfpc_compress(flat, tunable, threads),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.pfpc_decompress(padded, flat.size, tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class CascadedAlgorithm(Algorithm):
    """Cascaded RLE/delta/bit-pack scheme (nvCOMP Cascaded), serial CPU
    reimplementation (native/competitors.cc; reference: benchmark.cc
    "nvcomp-cascaded").  Tunable 0 auto-tunes the (R, D, bp) grid like
    the reference's selector; 101 is nvCOMP's non-auto default."""

    name = "cascaded"
    tunables = (0,)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.cascaded_compress(flat, tunable)
        out = competitors.cascaded_decompress(comp, flat.size, flat.dtype)
        wdt = np.uint64 if flat.dtype == np.float64 else np.uint32
        assert np.array_equal(out.view(wdt), flat.view(wdt)), \
            "cascaded: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.cascaded_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.cascaded_decompress(cbuf, flat.size,
                                                    flat.dtype, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class GfcAlgorithm(Algorithm):
    """GFC double compressor, serial CPU reimplementation of the CUDA
    competitor (native/competitors.cc; reference: benchmark.cc "gfc").
    Double-precision only; tunable = dimensionality (default 1)."""

    name = "gfc"
    tunables = (1,)

    def available(self, dataset):
        if np.dtype(dataset.dtype) != np.float64:
            return False  # GFC is a double-precision algorithm
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.gfc_compress(flat, tunable)
        out = competitors.gfc_decompress(comp, flat.size, tunable)
        assert np.array_equal(out.view(np.uint64), flat.view(np.uint64)), \
            "gfc: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.gfc_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.gfc_decompress(cbuf, flat.size, tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class MpcAlgorithm(Algorithm):
    """MPC massively-parallel compressor pipeline, serial CPU
    reimplementation (native/competitors.cc; reference: benchmark.cc
    "mpc", a CUDA competitor run at dimensionality 1).  Handles fp32 and
    fp64; tunable = the dim-stride (the reference benches dim=1)."""

    name = "mpc"
    tunables = (1,)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        flat = np.ascontiguousarray(data).reshape(-1)
        comp = competitors.mpc_compress(flat, tunable)
        out = competitors.mpc_decompress(comp, flat.size, flat.dtype, tunable)
        wdt = np.uint64 if flat.dtype == np.float64 else np.uint32
        assert np.array_equal(out.view(wdt), flat.view(wdt)), \
            "mpc: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint32)
        dst = np.empty_like(flat)
        comp_times = _rep_loop(
            lambda: competitors.mpc_compress(flat, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.mpc_decompress(cbuf, flat.size, flat.dtype,
                                               tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class Lz4Algorithm(Algorithm):
    """LZ4 block format (own native implementation, native/competitors.cc;
    reference: benchmark.cc "lz4" and "nvcomp:lz4" — no LZ4 library exists
    in this image)."""

    name = "lz4"
    tunables = (1,)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        buf = data.tobytes()
        comp = competitors.lz4_compress(buf)
        out = competitors.lz4_decompress(comp, len(buf))
        assert out.tobytes() == buf, "lz4: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty(len(buf), np.uint8)
        comp_times = _rep_loop(
            lambda: competitors.lz4_compress(buf),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.lz4_decompress(cbuf, len(buf), dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class SpdpAlgorithm(Algorithm):
    """SPDP synthesized byte-pipeline compressor (native C++
    reimplementation, native/competitors.cc; reference: benchmark.cc
    "spdp", tunable sweep 1..9 with default 5).  Dimensionality- and
    dtype-agnostic: runs on the raw array bytes for fp32 and fp64
    alike, exactly like the author code."""

    name = "spdp"
    tunables = (1, 9)

    def available(self, dataset):
        from . import competitors

        return competitors.fpc_available()  # same shared library

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import competitors

        buf = data.tobytes()
        comp = competitors.spdp_compress(buf, tunable)
        out = competitors.spdp_decompress(comp, len(buf), tunable)
        assert out.tobytes() == buf, "spdp: round-trip failed"
        cbuf = np.frombuffer(comp, np.uint8)
        dst = np.empty(len(buf), np.uint8)
        comp_times = _rep_loop(
            lambda: competitors.spdp_compress(buf, tunable),
            min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(
            lambda: competitors.spdp_decompress(cbuf, len(buf), tunable, dst),
            min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class FpzipAlgorithm(Algorithm):
    """fpzip via the pip package, when installed (not in this image —
    available() probes and skips; reference: benchmark.cc "fpzip")."""

    name = "fpzip"

    def available(self, dataset):
        try:
            import fpzip  # noqa: F401

            return True
        except ImportError:
            return False

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import fpzip

        comp = fpzip.compress(data, precision=0)
        out = fpzip.decompress(comp)[tuple(slice(0, s) for s in data.shape)]
        assert np.array_equal(out.reshape(data.shape).view(np.uint8),
                              data.view(np.uint8)), "fpzip: round-trip failed"
        comp_times = _rep_loop(lambda: fpzip.compress(data, precision=0),
                               min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(lambda: fpzip.decompress(comp),
                                 min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class ZfpAlgorithm(Algorithm):
    """zfp lossless via zfpy, when installed (not in this image;
    reference: benchmark.cc "zfp")."""

    name = "zfp"

    def available(self, dataset):
        try:
            import zfpy  # noqa: F401

            return True
        except ImportError:
            return False

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import zfpy

        comp = zfpy.compress_numpy(data)
        out = zfpy.decompress_numpy(comp)
        assert np.array_equal(out.view(np.uint8), data.view(np.uint8)), \
            "zfp: round-trip failed"
        comp_times = _rep_loop(lambda: zfpy.compress_numpy(data),
                               min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(lambda: zfpy.decompress_numpy(comp),
                                 min_time, min_reps, max_reps, True)
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, len(comp))


class Blosc2Algorithm(_ByteCodecAlgorithm):
    """blosc2 (shuffle + lz4/zstd), when installed (not in this image)."""

    name = "blosc2"
    tunables = (5,)

    def available(self, dataset):
        try:
            import blosc2  # noqa: F401

            self._typesize = np.dtype(dataset.dtype).itemsize
            return True
        except ImportError:
            return False

    def _compress(self, buf, tunable):
        import blosc2

        return blosc2.compress(buf, typesize=getattr(self, "_typesize", 8),
                               clevel=tunable)

    def _decompress(self, comp, out_len):
        import blosc2

        return blosc2.decompress(comp)


class NdzipHostAlgorithm(Algorithm):
    """ndzip host backends: golden (numpy), cpu (native C++, 1..N threads),
    xla (jit on the default platform, host-timed)."""

    def __init__(self, backend: str):
        self.backend = backend
        self.name = f"ndzip-{backend}"
        self.threaded = backend == "cpu"

    def available(self, dataset):
        if self.backend == "cpu":
            from . import native

            return native.available()
        return True

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        from . import api

        comp = api.make_compressor(data.dtype, data.ndim, self.backend, threads)
        dec = api.make_decompressor(data.dtype, data.ndim, self.backend, threads)
        stream, words = comp.compress(data)
        out = dec.decompress(stream, data.shape)
        assert np.array_equal(
            out.view(np.uint8).reshape(-1), data.view(np.uint8).reshape(-1)), \
            f"{self.name}: round-trip failed"
        comp_times = _rep_loop(lambda: comp.compress(data),
                               min_time, min_reps, max_reps, True)
        decomp_times = _rep_loop(lambda: dec.decompress(stream, data.shape),
                                 min_time, min_reps, max_reps, True)
        word_bytes = fmt.word_bits_for_dtype(data.dtype) // 8
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, words * word_bytes)


class NdzipGpuAlgorithm(Algorithm):
    """ndzip's device codec on the GPU, device-time measured: CHAIN
    invocations chained in one jitted fori_loop (inputs perturbed per
    iteration so XLA cannot CSE), one sync, divide by CHAIN — the analog of
    the reference's CUDA-event timing (benchmark.cc:331-341)."""

    name = "ndzip-gpu"
    CHAIN = 10

    def available(self, dataset):
        import jax

        return jax.default_backend() == "gpu"

    def run(self, data, tunable, threads, min_time, min_reps, max_reps):
        import jax

        from . import codec_xla

        shape = tuple(data.shape)
        enc_loop, dec_loop, dev_in, stream_dev, length = _chained_loops(
            data, self.CHAIN)
        # correctness gate: bit-exact round trip (benchmark.cc:263-265)
        out = codec_xla.decompress(np.asarray(stream_dev[:length]), shape,
                                   data.dtype)
        assert np.array_equal(out.view(np.uint8).reshape(-1),
                              data.view(np.uint8).reshape(-1)), \
            "ndzip-gpu: round-trip failed"

        comp_times = [t / self.CHAIN for t in _rep_loop(
            lambda: jax.block_until_ready(enc_loop(dev_in)), min_time, min_reps,
            max_reps, False)]
        decomp_times = [t / self.CHAIN for t in _rep_loop(
            lambda: jax.block_until_ready(dec_loop(stream_dev)), min_time,
            min_reps, max_reps, False)]
        return BenchResult(self.name, tunable, threads, comp_times,
                           decomp_times, data.nbytes, length * 4)


def _chained_loops(data, chain):
    """Jitted loops folding the device codec ``chain`` times into one
    dispatch, for ``data``'s shape: returns (enc_loop, dec_loop, dev_in,
    stream_dev, length_u32).  ``enc_loop(dev_in)`` and
    ``dec_loop(stream_dev)`` return the last iteration's whole output:
    the loop body is one program for every iteration, so each iteration
    computes all of it (consuming one element instead would let XLA slice
    the decode down to the blocks that element needs).  Inputs are
    perturbed per iteration so XLA cannot hoist the call."""
    import jax
    import jax.numpy as jnp

    from . import codec_xla
    from .ops import u64pair

    data = np.ascontiguousarray(data)
    shape = tuple(data.shape)
    wb = fmt.word_bits_for_dtype(data.dtype)
    if wb == 32:
        dev_in = (jnp.asarray(data.view(np.uint32)),)
    else:
        lo, hi = u64pair.split(data.view(np.uint64))
        dev_in = (jnp.asarray(lo), jnp.asarray(hi))
    enc = codec_xla.encode_fn(shape, wb)
    dec = codec_xla.decode_fn(shape, wb)
    stream_dev, length = enc(*dev_in)

    def zeros_like_result(fn, *args):
        return jax.tree_util.tree_map(
            lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(fn, *args))

    @jax.jit
    def enc_loop(ins):
        def body(i, _):
            return enc(*(w ^ i.astype(jnp.uint32) for w in ins))
        return jax.lax.fori_loop(0, chain, body, zeros_like_result(enc, *ins))

    @jax.jit
    def dec_loop(s):
        def body(i, carry):
            s_ = jax.lax.dynamic_update_slice(
                carry[0], i.astype(jnp.uint32)[None], (s.shape[0] - 1,))
            return s_, dec(s_)
        return jax.lax.fori_loop(0, chain, body, (s, zeros_like_result(dec, s)))[1]

    return enc_loop, dec_loop, dev_in, stream_dev, int(length)


def chained_device_times(data, chains=(10, 50)) -> tuple[int, int]:
    """Dispatch-free device durations (ns) for one compress and one
    decompress of ``data`` on the device codec: fold the codec N times
    inside one fori_loop dispatch for each chain length in ``chains``, take
    best-of-3 wall times, and return the slope between the two lengths —
    the two-point protocol bench.py uses, surfaced for
    api.Offloader.measure()."""

    import jax

    def best_of_3(fn, arg):
        jax.block_until_ready(fn(arg))  # compile + warm
        best = float("inf")
        for _ in range(3):
            t0 = time.perf_counter_ns()
            jax.block_until_ready(fn(arg))
            best = min(best, time.perf_counter_ns() - t0)
        return best

    c1, c2 = chains
    e1, d1, dev_in, stream_dev, _ = _chained_loops(data, c1)
    e2, d2, _, _, _ = _chained_loops(data, c2)
    enc_ns = (best_of_3(e2, dev_in) - best_of_3(e1, dev_in)) // (c2 - c1)
    dec_ns = (best_of_3(d2, stream_dev) - best_of_3(d1, stream_dev)) // (c2 - c1)
    return int(enc_ns), int(dec_ns)


def default_algorithms() -> dict[str, Algorithm]:
    algos = [
        MemcpyAlgorithm(),
        MemcpyMtAlgorithm(),
        ZlibAlgorithm(),
        LzmaAlgorithm(),
        Bz2Algorithm(),
        ZstdAlgorithm(),
        FpcAlgorithm(),
        PfpcAlgorithm(),
        SpdpAlgorithm(),
        Lz4Algorithm(),
        MpcAlgorithm(),
        GfcAlgorithm(),
        CascadedAlgorithm(),
        FpzipAlgorithm(),
        ZfpAlgorithm(),
        Blosc2Algorithm(),
        NdzipHostAlgorithm("golden"),
        NdzipHostAlgorithm("cpu"),
        NdzipHostAlgorithm("xla"),
        NdzipGpuAlgorithm(),
    ]
    return {a.name: a for a in algos}


# ------------------------------------------------------------------ driver


CSV_HEADER = ("dataset;data type;dimensions;algorithm;tunable;"
              "number of threads;compression times (microseconds);"
              "decompression times (microseconds);"
              "uncompressed bytes;compressed bytes")


def format_row(ds: Dataset, r: BenchResult) -> str:
    """benchmark.cc:1332-1337 CSV row format: `;`-separated fields, rep-time
    lists joined with `,` (benchmark.cc:1335) so the reference's
    plot_benchmark.py parses this CSV unchanged (and vice versa)."""
    fmt_times = lambda ts: ",".join(str(round(t * 1e6)) for t in ts)
    typ = "float" if ds.dtype == np.float32 else "double"
    return ";".join([
        ds.name, typ, str(len(ds.shape)), r.algorithm, str(r.tunable),
        str(r.threads), fmt_times(r.comp_times), fmt_times(r.decomp_times),
        str(r.uncompressed_bytes), str(r.compressed_bytes)])


def benchmark_file(ds: Dataset, algorithms: dict[str, Algorithm],
                   threads_list: list[int], min_time: float, min_reps: int,
                   max_reps: int, out=sys.stdout):
    data = ds.load()
    for name, algo in algorithms.items():
        if not algo.available(ds):
            print(f"# {name}: not available, skipped", file=sys.stderr)
            continue
        thread_opts = threads_list if algo.threaded else [1]
        for threads in thread_opts:
            for tunable in algo.tunables:
                try:
                    r = algo.run(data, tunable, threads, min_time,
                                 min_reps, max_reps)
                except Exception as e:  # report and continue, like the ref
                    print(f"# {name} failed on {ds.name}: {e}", file=sys.stderr)
                    continue
                print(format_row(ds, r), file=out)
                out.flush()


def main(argv=None):
    p = argparse.ArgumentParser(
        description="ndzip benchmark (reference: src/benchmark/benchmark.cc)")
    p.add_argument("metadata", nargs="?", help="dataset registry CSV")
    p.add_argument("--synthetic", action="store_true",
                   help="generate + bench the BASELINE.json synthetic configs")
    p.add_argument("-a", "--algorithms", nargs="*", default=None,
                   help="subset of algorithms to run")
    p.add_argument("-r", "--min-reps", type=int, default=1)
    p.add_argument("-R", "--max-reps", type=int, default=MAX_REPS_DEFAULT)
    p.add_argument("-t", "--min-time", type=float, default=1.0)
    p.add_argument("-T", "--threads", type=int, nargs="*", default=[1])
    args = p.parse_args(argv)

    if args.synthetic:
        datasets = make_synthetic(Path(os.environ.get(
            "NDZIP_BENCH_DIR",
            os.path.join(tempfile.gettempdir(), "ndzip_bench"))))
    elif args.metadata:
        datasets = read_dataset_registry(Path(args.metadata))
    else:
        p.error("either a metadata CSV or --synthetic is required")

    algorithms = default_algorithms()
    if args.algorithms:
        unknown = set(args.algorithms) - set(algorithms)
        if unknown:
            p.error(f"unknown algorithms: {sorted(unknown)}; "
                    f"available: {sorted(algorithms)}")
        algorithms = {k: v for k, v in algorithms.items() if k in args.algorithms}

    print(CSV_HEADER)
    for ds in datasets:
        benchmark_file(ds, algorithms, args.threads, args.min_time,
                       args.min_reps, args.max_reps)
    return 0


if __name__ == "__main__":
    sys.exit(main())
