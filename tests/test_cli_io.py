"""CLI + IO layer tests (reference: compress.cc multi-chunk stream
handling, io library round-trips)."""

import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

from ndzip_jax import api, cli, format as fmt, golden
from ndzip_jax import io as ndz_io

RNG = np.random.default_rng(77)
REPO = Path(__file__).resolve().parent.parent


def run_cli(args, stdin: bytes = b"") -> tuple[int, bytes, str]:
    res = subprocess.run(
        [sys.executable, "-m", "ndzip_jax.cli", *args],
        input=stdin, capture_output=True, cwd=REPO)
    return res.returncode, res.stdout, res.stderr.decode()


@pytest.mark.parametrize("backend", ["golden", "cpu"])
def test_cli_roundtrip_files(tmp_path, backend):
    data = RNG.standard_normal((70, 65)).astype(np.float32)
    raw = tmp_path / "in.f32"
    raw.write_bytes(data.tobytes())
    comp = tmp_path / "out.ndz"
    back = tmp_path / "back.f32"

    rc, _, err = run_cli(["-n", "70", "65", "-t", "float", "-e", backend,
                          "-i", str(raw), "-o", str(comp)])
    assert rc == 0, err
    assert "ratio" in err

    expect, _ = golden.compress(data)
    assert comp.read_bytes() == expect.tobytes()

    rc, _, err = run_cli(["-d", "-n", "70", "65", "-t", "float", "-e", backend,
                          "-i", str(comp), "-o", str(back)])
    assert rc == 0, err
    assert back.read_bytes() == data.tobytes()


def test_cli_stdin_stdout_multichunk():
    # 3 arrays of 4097 floats in one stream (compress.cc:17-86)
    datas = [RNG.standard_normal(4097).astype(np.float32) for _ in range(3)]
    raw = b"".join(d.tobytes() for d in datas)
    rc, compressed, err = run_cli(["-n", "4097", "-t", "float", "-e", "golden"], stdin=raw)
    assert rc == 0, err
    expect = b"".join(golden.compress(d)[0].tobytes() for d in datas)
    assert compressed == expect

    rc, decompressed, err = run_cli(["-d", "-n", "4097", "-t", "float", "-e", "golden"],
                                    stdin=compressed)
    assert rc == 0, err
    assert decompressed == raw


def test_cli_double_no_mmap(tmp_path):
    data = RNG.standard_normal((65, 64)).astype(np.float64)
    raw = tmp_path / "in.f64"
    raw.write_bytes(data.tobytes())
    comp = tmp_path / "c.ndz"
    rc, _, err = run_cli(["-n", "65", "64", "-t", "double", "-e", "golden", "--no-mmap",
                          "-i", str(raw), "-o", str(comp)])
    assert rc == 0, err
    expect, _ = golden.compress(data)
    assert comp.read_bytes() == expect.tobytes()


def test_cli_rejects_bad_dims():
    rc, _, err = run_cli(["-n", "2", "2", "2", "2", "-t", "float"], stdin=b"")
    assert rc != 0
    assert "dimension" in err


def test_cli_truncated_input(tmp_path):
    raw = tmp_path / "in.f32"
    raw.write_bytes(b"\0" * 10)  # not a whole 4096-element chunk
    rc, _, err = run_cli(["-n", "4096", "-t", "float", "-e", "golden", "-i", str(raw)])
    assert rc != 0
    assert "end of input" in err or "error" in err


def test_mmap_output_stream_grow_truncate(tmp_path):
    """io.cc:178-246 — grow-mapped output: over-allocating get_write_buffer
    followed by a shorter commit_chunk must leave the file at the exact
    committed size, across multiple variable-size chunks."""
    path = tmp_path / "out.bin"
    out = ndz_io.MmapOutputStream(str(path))
    chunks = [b"a" * 1000, b"bc" * 7, b"z"]
    for c in chunks:
        buf = out.get_write_buffer(len(c) + 4096)  # over-allocate
        assert path.stat().st_size >= len(c)       # file grown before write
        buf[: len(c)] = c
        buf.release()
        out.commit_chunk(len(c))
        assert path.stat().st_size == sum(map(len, chunks[: chunks.index(c) + 1]))
    out.close()
    assert path.read_bytes() == b"".join(chunks)

    # repeated get_write_buffer without an intervening commit must honor
    # max_chunk_size each time (the reference grows on every call,
    # io.cc:199-211), not hand back the previous request's remainder
    path3 = tmp_path / "out3.bin"
    out3 = ndz_io.MmapOutputStream(str(path3))
    small = out3.get_write_buffer(100)
    assert len(small) >= 100
    small.release()
    big = out3.get_write_buffer(5000)
    assert len(big) >= 5000
    big[:5000] = b"x" * 5000
    big.release()
    out3.commit_chunk(5000)
    out3.close()
    assert path3.read_bytes() == b"x" * 5000

    # write_chunk convenience wrapper drives the same grow/commit protocol
    path2 = tmp_path / "out2.bin"
    out2 = ndz_io.MmapOutputStream(str(path2))
    out2.write_chunk(np.arange(7, dtype=np.uint32))
    out2.write_chunk(b"")
    out2.write_chunk(b"tail")
    out2.close()
    assert path2.read_bytes() == np.arange(7, dtype=np.uint32).tobytes() + b"tail"


def test_warm_cli(tmp_path, monkeypatch):
    """python -m ndzip_jax.warm populates a persistent compile cache for
    the requested shapes; --cache-dir sets JAX_COMPILATION_CACHE_DIR."""
    import jax

    from ndzip_jax import utils, warm

    cache = tmp_path / "cache"
    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", True)
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "unused")
    try:
        assert warm.run(["--shapes", "4224", "--dtype", "float",
                         "--cache-dir", str(cache)]) == 0
        assert os.environ["JAX_COMPILATION_CACHE_DIR"] == str(cache)
        assert any(cache.iterdir())
    finally:
        monkeypatch.undo()
        utils.enable_compilation_cache()
        jax.config.update("jax_enable_compilation_cache", enabled)
    with pytest.raises(SystemExit):
        warm.build_parser().parse_args(["--shapes", "bad"])
    # invalid shapes are skipped with a nonzero exit
    assert warm.run(["--shapes", "2x2x2x2"]) == 1


def test_compressed_chunk_bytes():
    data = RNG.standard_normal((70, 65)).astype(np.float32)
    stream, words = golden.compress(data)
    blob = stream.tobytes() + b"junkjunk"
    got = ndz_io.compressed_chunk_bytes(memoryview(blob), (70, 65), np.float32)
    assert got == words * 4

    data64 = RNG.standard_normal((65, 64)).astype(np.float64)
    stream64, words64 = golden.compress(data64)
    got = ndz_io.compressed_chunk_bytes(memoryview(stream64.tobytes()), (65, 64), np.float64)
    assert got == words64 * 8


def test_offloader_api():
    data = RNG.standard_normal(4097).astype(np.float32)
    off = api.make_offloader("golden", np.float32, 1)
    stream, words = off.compress(data)
    assert off.timing.compress_ns > 0
    out = off.decompress(stream, data.shape)
    assert off.timing.decompress_ns > 0
    assert np.array_equal(out, data)
    assert off.compressed_length_bound(data.shape) == fmt.compressed_bound_words((4097,), 32)


def test_compressor_requirements():
    req = api.CompressorRequirements((4096,), (8192,))
    assert req.max_num_hypercubes == 2
    with pytest.raises(ValueError):
        req.include((64, 64))


def test_api_dtype_mismatch():
    comp = api.make_compressor(np.float32, 1, "golden")
    with pytest.raises(ValueError):
        comp.compress(RNG.standard_normal(10))  # float64 into float32 compressor
    with pytest.raises(ValueError):
        comp.compress(RNG.standard_normal((4, 4)).astype(np.float32))  # wrong dims
