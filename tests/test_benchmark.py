"""Benchmark harness tests: registry parsing, rep protocol, CSV output
format, plot-tool round-trip (reference: src/benchmark/benchmark.cc and
plot_benchmark.py)."""

import io
import os

import numpy as np
import pytest

from ndzip_jax import benchmark as bm
from ndzip_jax import plot_benchmark as pb


@pytest.fixture
def registry(tmp_path):
    rng = np.random.default_rng(0)
    d1 = np.sin(np.arange(4096 * 3 + 5, dtype=np.float32) * 1e-3)
    d1.tofile(tmp_path / "a.f32")
    d2 = rng.standard_normal((70, 66)).astype(np.float64)
    d2.tofile(tmp_path / "b.f64")
    meta = tmp_path / "meta.csv"
    meta.write_text("a.f32;float;12293\nb.f64;double;70 66\n")
    return meta


def test_registry_parse(registry):
    sets = bm.read_dataset_registry(registry)
    assert [d.name for d in sets] == ["a.f32", "b.f64"]
    assert sets[0].dtype == np.float32 and sets[0].shape == (12293,)
    assert sets[1].dtype == np.float64 and sets[1].shape == (70, 66)
    data = sets[1].load()
    assert data.shape == (70, 66)


def test_registry_rejects_bad_lines(tmp_path):
    meta = tmp_path / "meta.csv"
    meta.write_text("a.f32;float\n")
    with pytest.raises(ValueError):
        bm.read_dataset_registry(meta)
    meta.write_text("a.f32;quad;16\n")
    with pytest.raises(ValueError):
        bm.read_dataset_registry(meta)


def test_rep_protocol_counts():
    calls = []
    times = bm._rep_loop(lambda: calls.append(1), min_time=0.0,
                         min_reps=3, max_reps=10, trash_cache=False)
    # warm-up + min_reps timed reps
    assert len(times) == 3 and len(calls) == 4

    times = bm._rep_loop(lambda: None, min_time=1e9, min_reps=1,
                         max_reps=5, trash_cache=False)
    assert len(times) == 5  # max_reps cap


def test_benchmark_file_round_trips_and_formats(registry):
    sets = bm.read_dataset_registry(registry)
    algos = {k: v for k, v in bm.default_algorithms().items()
             if k in ("memcpy", "deflate", "ndzip-golden")}
    out = io.StringIO()
    for ds in sets:
        bm.benchmark_file(ds, algos, [1], min_time=0.0, min_reps=1,
                          max_reps=2, out=out)
    rows = out.getvalue().strip().splitlines()
    # memcpy + deflate x2 tunables + golden, per dataset
    assert len(rows) == 8
    cols = rows[0].split(";")
    assert cols[0] == "a.f32" and cols[1] == "float" and cols[2] == "1"


def test_plot_tool_reads_harness_output(registry, tmp_path):
    sets = bm.read_dataset_registry(registry)
    algos = {k: v for k, v in bm.default_algorithms().items()
             if k in ("memcpy", "ndzip-golden")}
    out = io.StringIO()
    out.write(bm.CSV_HEADER + "\n")
    for ds in sets:
        bm.benchmark_file(ds, algos, [1], min_time=0.0, min_reps=2,
                          max_reps=3, out=out)
    out.seek(0)
    rows = pb.read_rows(out)
    assert len(rows) == 4
    assert all(len(r.comp_times) >= 2 for r in rows)
    table = pb.summarize(rows)
    assert len(table) == 2
    golden = [t for t in table if t[0].startswith("ndzip-golden")][0]
    assert 0.0 < golden[2] < 1.0  # compression ratio
    buf = io.StringIO()
    pb.print_table(table, out=buf)
    assert "ndzip-golden" in buf.getvalue()


def test_reference_plot_script_parses_harness_csv(registry, tmp_path):
    """Cross-ecosystem interop: the REFERENCE's own plot_benchmark.py
    (run as a subprocess from /root/reference, headless) parses this
    harness's CSV and prints its throughput/ratio tables — the
    cross-parseability VERDICT asked for (benchmark.cc:1335 comma-joined
    rep lists inside ;-separated columns)."""
    import pathlib
    import subprocess
    import sys

    ref = pathlib.Path("/root/reference/src/benchmark/plot_benchmark.py")
    if not ref.exists():
        pytest.skip("reference checkout not mounted")
    pytest.importorskip("scipy")
    pytest.importorskip("tabulate")
    pytest.importorskip("matplotlib")

    sets = bm.read_dataset_registry(registry)
    algos = {k: v for k, v in bm.default_algorithms().items()
             if k in ("memcpy", "ndzip-golden")}
    csv_path = tmp_path / "results.csv"
    with open(csv_path, "w") as out:
        out.write(bm.CSV_HEADER + "\n")
        for ds in sets:
            bm.benchmark_file(ds, algos, [1], min_time=0.0, min_reps=2,
                              max_reps=3, out=out)
    env = dict(os.environ, MPLBACKEND="Agg")
    res = subprocess.run([sys.executable, str(ref), str(csv_path)],
                         capture_output=True, text=True, env=env,
                         timeout=300)
    assert res.returncode == 0, res.stderr
    assert "ndzip-golden" in res.stdout and "memcpy" in res.stdout
    # both data types' tables appear (float from a.f32, double from b.f64)
    assert "(float)" in res.stdout and "(double)" in res.stdout


def test_fpc_competitor_roundtrip(registry):
    """The native FPC reimplementation (native/competitors.cc) round-trips
    bit-exactly and registers as a double-only benchmark algorithm."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(5)
    for d in (np.cumsum(rng.standard_normal(10_001)),
              np.zeros(513), rng.standard_normal(1)):
        comp = competitors.fpc_compress(d)
        out = competitors.fpc_decompress(comp, d.size)
        assert np.array_equal(out.view(np.uint64),
                              np.ascontiguousarray(d).view(np.uint64))

    algo = bm.FpcAlgorithm()
    sets = bm.read_dataset_registry(registry)
    f32, f64 = sets
    assert not algo.available(f32)   # FPC is double-precision only
    assert algo.available(f64)
    r = algo.run(f64.load(), 16, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_pfpc_competitor_roundtrip(registry):
    """Chunk-parallel FPC round-trips bit-exactly for any thread count
    (including thread counts that do not divide the value count), decodes
    streams from a different thread count, and sweeps -T in the registry."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(6)
    data = np.cumsum(rng.standard_normal(32_003))
    serial = competitors.fpc_compress(data)
    for threads in (1, 2, 3, 7):
        comp = competitors.pfpc_compress(data, threads=threads)
        out = competitors.pfpc_decompress(comp, data.size)
        assert np.array_equal(out.view(np.uint64), data.view(np.uint64))
        # chunking costs a little ratio vs serial FPC, never an order
        assert len(comp) < len(serial) * 1.1 + 64
    for d in (np.zeros(513), rng.standard_normal(1), rng.standard_normal(0)):
        comp = competitors.pfpc_compress(d, threads=4)
        out = competitors.pfpc_decompress(comp, d.size)
        assert np.array_equal(out.view(np.uint64),
                              np.ascontiguousarray(d).view(np.uint64))

    algo = bm.PfpcAlgorithm()
    assert algo.threaded  # sweeps the -T list like ndzip-cpu
    sets = bm.read_dataset_registry(registry)
    f32, f64 = sets
    assert not algo.available(f32)
    assert algo.available(f64)
    r = algo.run(f64.load(), 16, 2, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.threads == 2


def test_spdp_competitor_roundtrip(registry):
    """The native SPDP reimplementation (native/competitors.cc) round-trips
    any byte stream and registers for both data types (SPDP is
    dtype-agnostic, unlike FPC)."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(7)
    cases = [
        np.sin(np.arange(10_001, dtype=np.float32) * 1e-3).tobytes(),
        np.cumsum(rng.standard_normal(9_173)).tobytes(),
        bytes(513), rng.integers(0, 256, 7, np.uint8).tobytes(), b"",
    ]
    for level in (1, 5, 9):
        for buf in cases:
            comp = competitors.spdp_compress(buf, level)
            out = competitors.spdp_decompress(comp, len(buf), level)
            assert out.tobytes() == buf

    algo = bm.SpdpAlgorithm()
    sets = bm.read_dataset_registry(registry)
    f32, f64 = sets
    assert algo.available(f32) and algo.available(f64)
    r = algo.run(f64.load(), 5, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_lz4_competitor_roundtrip(registry):
    """The native LZ4 block-format implementation round-trips arbitrary
    byte streams (long runs exercise self-overlapping match copies and
    run-length extension bytes) and registers for both data types."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(9)
    cases = [
        b"", b"a", b"x" * 12, b"x" * 100_000, b"ab" * 70_000,
        bytes(range(256)) * 50, rng.integers(0, 256, 1 << 18, np.uint8).tobytes(),
        np.sin(np.arange(1 << 16, dtype=np.float32) * 1e-3).tobytes(),
        b"z" * (15 + 255 * 3 + 7),
    ]
    for buf in cases:
        comp = competitors.lz4_compress(buf)
        out = competitors.lz4_decompress(comp, len(buf))
        assert out.tobytes() == buf
    # corrupted stream fails cleanly, not UB: truncate mid-sequence
    comp = competitors.lz4_compress(b"x" * 1000)
    with pytest.raises(RuntimeError):
        competitors.lz4_decompress(comp[: len(comp) - 1], 1000)

    algo = bm.Lz4Algorithm()
    sets = bm.read_dataset_registry(registry)
    assert algo.available(sets[0]) and algo.available(sets[1])
    r = algo.run(sets[0].load(), 1, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_mpc_competitor_roundtrip(registry):
    """The native MPC reimplementation (LnVs|BIT|LVs|ZE pipeline,
    native/competitors.cc) round-trips bit-exactly for fp32 and fp64 at
    several dim strides and registers for both data types."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(10)
    cases = [
        np.sin(np.arange(100_003, dtype=np.float32) * 1e-3),
        np.cumsum(rng.standard_normal(65_537)),
        np.zeros(1024, np.float32), rng.standard_normal(1),
        np.zeros(0, np.float64),
    ]
    for dim in (1, 2, 32):
        for d in cases:
            comp = competitors.mpc_compress(d, dim)
            out = competitors.mpc_decompress(comp, d.size, d.dtype, dim)
            wdt = np.uint64 if d.dtype == np.float64 else np.uint32
            assert np.array_equal(out.view(wdt), d.reshape(-1).view(wdt))

    algo = bm.MpcAlgorithm()
    sets = bm.read_dataset_registry(registry)
    assert algo.available(sets[0]) and algo.available(sets[1])
    for ds in sets:
        r = algo.run(ds.load(), 1, 1, min_time=0.0, min_reps=1, max_reps=2)
        assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_gfc_competitor_roundtrip(registry):
    """The native GFC reimplementation (sign/lead-zero-byte nibble codes,
    native/competitors.cc) round-trips bit-exactly — including NaN/Inf/
    denormal payloads — and registers as a double-only algorithm."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(11)
    cases = [
        np.cumsum(rng.standard_normal(100_003)),
        np.zeros(1024), rng.standard_normal(1), np.zeros(0),
        -np.abs(np.cumsum(rng.standard_normal(5000))),
        np.array([np.nan, np.inf, -np.inf, -0.0, 5e-324]),
    ]
    for dim in (1, 3, 32):
        for d in cases:
            comp = competitors.gfc_compress(d, dim)
            out = competitors.gfc_decompress(comp, d.size, dim)
            assert np.array_equal(out.view(np.uint64),
                                  d.reshape(-1).view(np.uint64))

    algo = bm.GfcAlgorithm()
    sets = bm.read_dataset_registry(registry)
    f32, f64 = sets
    assert not algo.available(f32)  # GFC is double-precision only
    assert algo.available(f64)
    r = algo.run(f64.load(), 1, 1, min_time=0.0, min_reps=1, max_reps=2)
    assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_cascaded_competitor_roundtrip(registry):
    """The native Cascaded-scheme reimplementation (RLE/delta/bit-pack
    cascade, native/competitors.cc) round-trips bit-exactly for fp32 and
    fp64 under auto-tune and forced configs, and registers for both
    data types."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(12)
    cases = [
        np.sin(np.arange(50_003, dtype=np.float32) * 1e-3),
        np.cumsum(rng.standard_normal(30_011)),
        np.zeros(4096, np.float32),
        np.repeat(rng.standard_normal(100),
                  rng.integers(1, 50, 100)).astype(np.float32),
        rng.standard_normal(1), np.zeros(0, np.float32),
    ]
    for cfg in (0, 101, 1, 111, 221):
        for d in cases:
            comp = competitors.cascaded_compress(d, cfg)
            out = competitors.cascaded_decompress(comp, d.size, d.dtype)
            wdt = np.uint64 if d.dtype == np.float64 else np.uint32
            assert np.array_equal(out.view(wdt), d.reshape(-1).view(wdt))
    # run-heavy data compresses hard; smooth float data does not (the
    # published Cascaded-on-floats behavior the reference reproduces)
    runs = competitors.cascaded_compress(cases[3], 0)
    assert len(runs) < cases[3].nbytes * 0.2

    algo = bm.CascadedAlgorithm()
    sets = bm.read_dataset_registry(registry)
    assert algo.available(sets[0]) and algo.available(sets[1])
    for ds in sets:
        r = algo.run(ds.load(), 0, 1, min_time=0.0, min_reps=1, max_reps=2)
        assert r.compressed_bytes > 0 and r.comp_times and r.decomp_times


def test_spdp_payload_matches_author_code(tmp_path):
    """The reimplementation must be the *same algorithm*, not merely a
    round-tripping one: per-chunk payload sizes are compared against the
    author sources vendored by the reference (contrib/spdp/SPDP_11.c),
    compiled here as a test oracle.  Containers differ (ours: u32 size
    table; theirs: level byte + interleaved length headers), so payload
    bytes are compared net of framing."""
    import ctypes
    import shutil
    import subprocess

    from ndzip_jax import competitors

    src = "/root/reference/contrib/spdp/SPDP_11.c"
    if not os.path.exists(src) or shutil.which("gcc") is None:
        pytest.skip("reference SPDP sources or gcc unavailable")
    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    drv = tmp_path / "drv.c"
    drv.write_text(
        '#include "SPDP_11.h"\n#include <stddef.h>\n'
        "size_t oc(const void *i, size_t n, void *o, int l) "
        "{ return SPDP_Compress_Memory(i, n, o, l); }\n")
    lib = tmp_path / "oracle.so"
    subprocess.run(
        ["gcc", "-O2", "-shared", "-fPIC", "-I", os.path.dirname(src),
         str(drv), src, "-o", str(lib)], check=True, capture_output=True)
    oracle = ctypes.CDLL(str(lib))
    oracle.oc.restype = ctypes.c_size_t
    oracle.oc.argtypes = [ctypes.c_void_p, ctypes.c_size_t, ctypes.c_void_p,
                          ctypes.c_int]

    rng = np.random.default_rng(8)
    cases = [
        np.sin(np.arange(50_000, dtype=np.float32) * 1e-3).tobytes(),
        np.cumsum(rng.standard_normal(20_011)).tobytes(),
        bytes(4096), rng.integers(0, 4, 100_003, np.uint8).tobytes(),
    ]
    for level in (1, 5, 9):
        for buf in cases:
            n = len(buf)
            src_arr = np.frombuffer(buf, np.uint8)
            out = np.empty(2 * n + 1024, np.uint8)
            ref_total = oracle.oc(src_arr.ctypes.data, n, out.ctypes.data,
                                  level)
            nchunks = (n + (1 << 23) - 1) >> 23
            mine = competitors.spdp_compress(buf, level)
            assert len(mine) - 4 * nchunks == ref_total - 1 - 8 * nchunks


def test_optional_pip_competitors_skip_gracefully(registry):
    """fpzip/zfp/blosc2 wrappers must report unavailable (not raise) when
    the packages are absent — and this image has none of them."""
    sets = bm.read_dataset_registry(registry)
    for algo in (bm.FpzipAlgorithm(), bm.ZfpAlgorithm(), bm.Blosc2Algorithm()):
        assert isinstance(algo.available(sets[0]), bool)


def test_csv_times_comma_joined(registry):
    """benchmark.cc:1335 — rep-time lists are comma-joined, unquoted."""
    ds = bm.read_dataset_registry(registry)[0]
    r = bm.BenchResult("x", 1, 1, [1e-6, 2e-6], [3e-6], 8, 4)
    row = bm.format_row(ds, r)
    assert ";1,2;" in row and '"' not in row


def test_synthetic_generator(tmp_path):
    sets = bm.make_synthetic(tmp_path / "s")
    assert len(sets) == 5
    # files exist and sizes match metadata; both dtypes and all dims appear
    for ds in sets:
        n = int(np.prod(ds.shape))
        assert ds.path.stat().st_size == n * ds.dtype.itemsize
    assert {ds.dtype.name for ds in sets} == {"float32", "float64"}
    assert {len(ds.shape) for ds in sets} == {1, 2, 3}
    # deterministic regardless of which files already exist: delete one,
    # regenerate, content unchanged
    victim = sets[3]
    before = victim.path.read_bytes()[:4096]
    victim.path.unlink()
    sets2 = bm.make_synthetic(tmp_path / "s")
    assert sets2[3].path.read_bytes()[:4096] == before


def test_native_competitor_decoders_survive_corruption():
    """Truncated and bit-flipped streams must fail cleanly (RuntimeError
    from the -1 status) or decode to garbage — never crash: every native
    decoder bounds-checks its reads (native/competitors.cc)."""
    from ndzip_jax import competitors

    if not competitors.fpc_available():
        pytest.skip("no C++ toolchain for the competitor build")
    rng = np.random.default_rng(13)
    f32 = np.sin(np.arange(9_173, dtype=np.float32) * 1e-3)
    f64 = np.cumsum(rng.standard_normal(7_001))

    def mutations(comp):
        yield comp[: len(comp) // 2]          # truncate
        yield comp[:7]                        # near-empty
        arr = bytearray(comp)
        for pos in rng.integers(0, len(arr), 32):
            arr[pos] ^= 0xFF
        yield bytes(arr)                      # bit flips

    codecs = [
        (competitors.spdp_compress(f32.tobytes()),
         lambda c: competitors.spdp_decompress(c, f32.nbytes)),
        (competitors.lz4_compress(f32.tobytes()),
         lambda c: competitors.lz4_decompress(c, f32.nbytes)),
        (competitors.mpc_compress(f32),
         lambda c: competitors.mpc_decompress(c, f32.size, np.float32)),
        (competitors.mpc_compress(f64),
         lambda c: competitors.mpc_decompress(c, f64.size, np.float64)),
        (competitors.gfc_compress(f64),
         lambda c: competitors.gfc_decompress(c, f64.size)),
        (competitors.cascaded_compress(f32),
         lambda c: competitors.cascaded_decompress(c, f32.size, np.float32)),
        (competitors.fpc_compress(f64),
         lambda c: competitors.fpc_decompress(c, f64.size)),
    ]
    for comp, dec in codecs:
        for bad in mutations(comp):
            try:
                dec(bad)
            except RuntimeError:
                pass  # clean failure is the expected outcome
