"""bench.py and its timing loops on the CPU: it refuses to measure without a
GPU, its cells are seeded, and the chained loops compute the codec's whole
output on every iteration."""

import os
import subprocess
import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
from ndzip_jax import benchmark, codec_xla, golden  # noqa: E402


def test_refuses_without_gpu(capsys):
    with pytest.raises(SystemExit, match="measures the GPU"):
        bench.describe_devices()
    assert "platform=cpu" in capsys.readouterr().out


def test_main_exits_nonzero_without_gpu():
    res = subprocess.run([sys.executable, "bench.py"], cwd=REPO, capture_output=True,
                         text=True, timeout=300, env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode != 0
    assert "{" not in res.stdout


def test_cells_are_seeded():
    a, b = bench.make_cell("cesm"), bench.make_cell("cesm")
    assert a.shape == (1800, 3600) and a.dtype == np.float32
    assert a.tobytes() == b.tobytes()


def test_bench_cell_checks_and_reports(monkeypatch, capsys):
    monkeypatch.setitem(bench.CELLS, "tiny", lambda rng: rng.standard_normal(
        (64, 65)).astype(np.float32))
    row = bench.bench_cell("tiny")
    _, words = golden.compress(bench.make_cell("tiny"))
    assert row["ratio"] == words * 4 / (64 * 65 * 4)
    assert row["compress_gbps"] > 0 and row["decompress_gbps"] > 0
    assert "cell tiny:" in capsys.readouterr().out


@pytest.mark.parametrize("shape,dtype", [((4096 * 2 + 3,), np.float32),
                                         ((20, 16, 17), np.float64)])
def test_chained_loops_return_the_whole_last_output(shape, dtype):
    data = np.sin(np.arange(int(np.prod(shape))) * 1e-2).astype(dtype).reshape(shape)
    chain = 3
    enc_loop, dec_loop, dev_in, stream, _ = benchmark._chained_loops(data, chain)
    wb = 64 if dtype == np.float64 else 32
    last = tuple(w ^ jnp.uint32(chain - 1) for w in dev_in)
    expect_stream, expect_len = codec_xla.encode_fn(shape, wb)(*last)
    got_stream, got_len = enc_loop(dev_in)
    assert int(got_len) == int(expect_len)
    assert np.array_equal(np.asarray(got_stream), np.asarray(expect_stream))

    s_last = jax.lax.dynamic_update_slice(
        stream, jnp.uint32(chain - 1)[None], (stream.shape[0] - 1,))
    expect = codec_xla.decode_fn(shape, wb)(s_last)
    got = dec_loop(stream)
    for g, e in zip(jax.tree_util.tree_leaves(got), jax.tree_util.tree_leaves(expect)):
        assert np.array_equal(np.asarray(g), np.asarray(e))
