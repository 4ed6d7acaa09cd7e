"""Observability and configuration utilities.

The reference gates diagnostic output behind the ``NDZIP_VERBOSE`` env var
(common.hh:630-633) and threads per-kernel timings through SYCL profiling
events (sycl_bits.hh:38-55) / CUDA events (cuda_bits.cuh:252-259).  The
JAX equivalents:

* ``verbose()`` — ``NDZIP_VERBOSE`` env gate, cached at first call.
* ``log(...)`` — stderr logger active only under verbose.
* ``trace(label)`` — context manager that both annotates the JAX profiler
  trace (visible in TensorBoard/Perfetto captures) and, under verbose,
  prints ``[profile] <label> <ms>`` wall timings like the reference's
  ``submit_and_profile``.
* ``device_time_ns(fn, *args)`` — device-only duration of a jitted
  callable, measured by block_until_ready fencing (the host-side analog of
  ``kernel_duration``; see bench.py for the chained-loop variant that
  amortizes host sync overhead).
* ``profiler_trace(dir)`` — capture a full XLA profiler trace for offline
  analysis (the deep-dive analog of the reference's NDZIP_VERBOSE kernel
  dumps); ``device_op_times(dir)`` reduces it to device time per XLA op.
* ``enable_compilation_cache()`` — persistent XLA compilation cache for
  the codec's jitted programs, enabled when the device codec is imported:
  ``$JAX_COMPILATION_CACHE_DIR`` when set, else ``CACHE_DIR``.
"""

from __future__ import annotations

import contextlib
import functools
import os
import sys
import time

# One fixed directory inside the checkout: the cache path is part of what
# JAX's cache is keyed on, so a path that moved would never hit.
CACHE_DIR = os.path.join(
    os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__)))),
    ".jax_cache")


@functools.lru_cache(maxsize=1)
def verbose() -> bool:
    """common.hh:630-633 — cached env-var gate."""
    v = os.environ.get("NDZIP_VERBOSE", "")
    return v not in ("", "0", "false", "no")


def log(*args):
    if verbose():
        print("[ndzip]", *args, file=sys.stderr)


@contextlib.contextmanager
def trace(label: str):
    """Annotate the JAX profiler trace and print wall time under verbose
    (the analog of submit_and_profile, sycl_bits.hh:46-55)."""
    try:
        import jax.profiler

        ctx = jax.profiler.TraceAnnotation(label)
    except Exception:  # profiler unavailable (e.g. no jax)
        ctx = contextlib.nullcontext()
    t0 = time.perf_counter()
    with ctx:
        yield
    if verbose():
        ms = (time.perf_counter() - t0) * 1e3
        print(f"[profile] {label} {ms:.3f} ms", file=sys.stderr)


def device_time_ns(fn, *args) -> int:
    """Wall duration of fn(*args) fenced by block_until_ready on inputs and
    outputs — device time plus one dispatch, the per-call analog of the
    offloader's kernel_duration out-param (ndzip.hh:271).  One un-timed
    warm-up call first, so a fresh shape's jit trace + compile never lands
    in the reported duration."""
    import jax

    jax.block_until_ready(fn(*args))
    jax.block_until_ready(args)
    t0 = time.perf_counter_ns()
    out = fn(*args)
    jax.block_until_ready(out)
    return time.perf_counter_ns() - t0


def enable_compilation_cache() -> str:
    """Point JAX's persistent compilation cache at
    ``$JAX_COMPILATION_CACHE_DIR`` when it is set, else at ``CACHE_DIR``, so
    the codec's compiles are paid once per checkout rather than once per
    process.  The reference ships AOT-compiled kernels and has no such cost
    (cuda_factory.cu); the persistent cache is the JIT-world equivalent.
    Returns the cache directory."""
    import jax

    path = os.environ.get("JAX_COMPILATION_CACHE_DIR") or CACHE_DIR
    if jax.config.jax_compilation_cache_dir != path:
        from jax.experimental.compilation_cache import compilation_cache

        jax.config.update("jax_compilation_cache_dir", path)
        compilation_cache.reset_cache()  # re-open at the new path
        log("compilation cache at", path)
    # the codec's programs compile in seconds or less; cache every one
    jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.0)
    return path


def gpu_name_power() -> str:
    """The cards' name and power limit as ``nvidia-smi`` reports them
    (one line per card), to print beside every device number: a card set
    below its maximum power runs slower under load."""
    import subprocess

    return subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        check=True, capture_output=True, text=True, timeout=60).stdout.strip()


@contextlib.contextmanager
def profiler_trace(log_dir: str):
    """Capture an XLA profiler trace (TensorBoard format) around a region."""
    import jax.profiler

    jax.profiler.start_trace(log_dir)
    try:
        yield
    finally:
        jax.profiler.stop_trace()


def device_op_times(log_dir: str) -> dict:
    """Device time (ns) per kernel, summed over the newest trace that
    ``profiler_trace(log_dir)`` wrote: the events of each device plane's
    "XLA Ops" line where the trace has one, else of its stream lines (a
    GPU trace names each event after the kernel XLA emitted).  Raises
    ValueError when the trace holds no device plane (a CPU run)."""
    import glob

    import jax.profiler

    paths = glob.glob(os.path.join(log_dir, "**", "*.xplane.pb"), recursive=True)
    if not paths:
        raise ValueError(f"no trace under {log_dir}")
    data = jax.profiler.ProfileData.from_file(max(paths, key=os.path.getmtime))
    devices = [p for p in data.planes if p.name.startswith("/device:")]
    if not devices:
        raise ValueError("trace has no device plane")
    times: dict = {}
    for plane in devices:
        lines = [ln for ln in plane.lines if ln.name == "XLA Ops"] or [
            ln for ln in plane.lines if ln.name.startswith("Stream")]
        for line in lines:
            for ev in line.events:
                times[ev.name] = times.get(ev.name, 0) + int(ev.duration_ns)
    return times
