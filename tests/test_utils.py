"""Observability utilities (the NDZIP_VERBOSE-analog surface,
reference: common.hh:630-633, sycl_bits.hh:38-55)."""

import os
from pathlib import Path

import numpy as np
import pytest

from ndzip_jax import utils


def test_verbose_gate(monkeypatch, capsys):
    utils.verbose.cache_clear()
    monkeypatch.setenv("NDZIP_VERBOSE", "1")
    assert utils.verbose() is True
    utils.log("hello")
    assert "[ndzip] hello" in capsys.readouterr().err

    utils.verbose.cache_clear()
    monkeypatch.setenv("NDZIP_VERBOSE", "0")
    assert utils.verbose() is False
    utils.log("quiet")
    assert capsys.readouterr().err == ""
    utils.verbose.cache_clear()


def test_trace_prints_under_verbose(monkeypatch, capsys):
    utils.verbose.cache_clear()
    monkeypatch.setenv("NDZIP_VERBOSE", "1")
    with utils.trace("unit-test-region"):
        pass
    err = capsys.readouterr().err
    assert "[profile] unit-test-region" in err and "ms" in err
    utils.verbose.cache_clear()


def test_device_time_ns():
    import jax.numpy as jnp

    x = jnp.asarray(np.arange(1024, dtype=np.float32))
    ns = utils.device_time_ns(lambda a: a * 2, x)
    assert ns > 0


@pytest.fixture
def cache_env(monkeypatch):
    """Lets a test move and use the compile cache; puts it back afterwards."""
    import jax

    enabled = jax.config.jax_enable_compilation_cache
    jax.config.update("jax_enable_compilation_cache", True)
    yield monkeypatch
    monkeypatch.undo()
    utils.enable_compilation_cache()
    jax.config.update("jax_enable_compilation_cache", enabled)


def test_compilation_cache(tmp_path, cache_env):
    import jax
    import jax.numpy as jnp

    cache = tmp_path / "xla-cache"
    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", str(cache))
    got = utils.enable_compilation_cache()
    assert got == str(cache)
    assert jax.config.jax_compilation_cache_dir == str(cache)
    # jitted programs still run, and compile into the new directory
    assert int(jax.jit(lambda a: a * 3 + 1)(jnp.int32(5))) == 16
    assert cache.is_dir() and any(cache.iterdir())


def test_compilation_cache_env_var_sets_nothing_else(tmp_path, cache_env):
    import jax

    cache_env.setenv("JAX_COMPILATION_CACHE_DIR", str(tmp_path / "c"))
    for _ in range(2):
        assert utils.enable_compilation_cache() == str(tmp_path / "c")
        assert jax.config.jax_compilation_cache_dir == str(tmp_path / "c")
    assert not (tmp_path / "c").exists() or (tmp_path / "c").is_dir()
    assert utils.CACHE_DIR != str(tmp_path / "c")


def test_compilation_cache_default_is_one_fixed_path_in_the_checkout(cache_env):
    import jax

    cache_env.delenv("JAX_COMPILATION_CACHE_DIR", raising=False)
    first = utils.enable_compilation_cache()
    second = utils.enable_compilation_cache()
    assert first == second == utils.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == utils.CACHE_DIR
    repo = Path(__file__).resolve().parent.parent
    assert Path(first) == repo / ".jax_cache"
    assert ".jax_cache/" in (repo / ".gitignore").read_text().split()


def test_device_codec_import_enables_the_cache():
    import jax

    from ndzip_jax import codec_xla  # noqa: F401

    expect = os.environ.get("JAX_COMPILATION_CACHE_DIR") or utils.CACHE_DIR
    assert jax.config.jax_compilation_cache_dir == expect
    assert jax.config.jax_persistent_cache_min_compile_time_secs == 0.0


def test_device_op_times_needs_a_device_plane(tmp_path):
    import jax
    import jax.numpy as jnp

    with pytest.raises(ValueError, match="no trace"):
        utils.device_op_times(str(tmp_path))
    with utils.profiler_trace(str(tmp_path)):
        jax.block_until_ready(jax.jit(lambda a: a + 1)(jnp.ones(8)))
    # a CPU run has host planes only: there is no device time to report
    with pytest.raises(ValueError, match="no device plane"):
        utils.device_op_times(str(tmp_path))
