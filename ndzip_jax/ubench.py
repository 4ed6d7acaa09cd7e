"""Per-stage codec microbenchmarks — the port of the reference's GPU
microbench suite (src/sycl_ubench/: scan variants, block load, forward/
inverse transform, chunk transpose, compaction, decode).

Each stage is timed device-only by chaining invocations inside one jitted
fori_loop (inputs perturbed per iteration so XLA cannot hoist the
computation) at two chain lengths; the per-rep time is the slope, which
cancels the fixed host-sync cost — the analog of the reference's
SYCL-profiling-event timing (ubench.hh:15-55).

Usage:  python -m ndzip_jax.ubench [--mb 64] [--dims 1] [--stages a b c]
Output: one line per stage with ms/rep and effective GB/s of the stage's
uncompressed working set.
"""

from __future__ import annotations

import argparse
import sys
import time

import numpy as np

from . import format as fmt

CHAIN = (10, 50)


def _timed_loop(make_loop, *args) -> float:
    """Time chained executions at two chain lengths; the slope is the pure
    per-rep device time (fixed sync cost cancels)."""
    import jax

    times = []
    for reps in CHAIN:
        loop = make_loop(reps)
        jax.block_until_ready(loop(*args))  # compile + warm-up
        t0 = time.perf_counter()
        jax.block_until_ready(loop(*args))
        times.append(time.perf_counter() - t0)
    return (times[1] - times[0]) / (CHAIN[1] - CHAIN[0])


def _chain_u32(fn):
    """Build a jitted-loop factory chaining fn over uint32 arrays.  The loop
    returns the last iteration's whole output, so every iteration computes
    all of it (one program serves every iteration)."""
    import jax
    import jax.numpy as jnp

    def make(reps):
        @jax.jit
        def loop(*arrs):
            def body(i, _):
                return fn(*(a ^ i.astype(jnp.uint32) for a in arrs))
            init = jax.tree_util.tree_map(
                lambda a: jnp.zeros(a.shape, a.dtype), jax.eval_shape(fn, *arrs))
            return jax.lax.fori_loop(0, reps, body, init)
        return loop

    return make


def stage_benchmarks(shape, dims):
    """Yield (name, bytes_touched, run() -> s/rep) for every codec stage."""
    import jax.numpy as jnp

    from . import codec_xla

    rng = np.random.default_rng(0)
    n = int(np.prod(shape))
    data = (np.sin(np.arange(n, dtype=np.float32) * 1e-4)
            + 0.001 * rng.standard_normal(n).astype(np.float32)).reshape(shape)
    words = jnp.asarray(data.view(np.uint32))
    nbytes = data.nbytes
    num_hc = fmt.num_hypercubes(shape)
    # host-side gather for stage inputs (not timed)
    blocks = jnp.asarray(np.asarray(codec_xla._gather_blocks(words, shape)))
    blk_bytes = blocks.size * 4

    # each stage in isolation, the way sycl_codec_ubench.inl:34-198 does
    yield ("gather_blocks", nbytes,
           lambda: _timed_loop(_chain_u32(
               lambda w: codec_xla._gather_blocks(w.reshape(shape), shape)), words.reshape(-1)))
    yield ("forward_transform", blk_bytes,
           lambda: _timed_loop(_chain_u32(
               lambda b: codec_xla.block_transform_u32(b, dims)), blocks))
    yield ("inverse_transform", blk_bytes,
           lambda: _timed_loop(_chain_u32(
               lambda b: codec_xla.inverse_block_transform_u32(b, dims)), blocks))
    yield ("bit_transpose", blk_bytes,
           lambda: _timed_loop(_chain_u32(
               lambda b: codec_xla.bitops.transpose_bits(
                   b.reshape(-1, fmt.HC_SIZE // 32, 32), jnp)), blocks))
    yield ("scatter_blocks", nbytes,
           lambda: _timed_loop(_chain_u32(
               lambda b: codec_xla._scatter_blocks(
                   b[:num_hc], shape, jnp.zeros(n, jnp.uint32))), blocks))

    # the whole codec, one program per direction
    encode = codec_xla.encode_fn(shape, 32)
    yield ("encode", nbytes,
           lambda: _timed_loop(_chain_u32(
               lambda w: encode(w.reshape(shape))), words.reshape(-1)))
    stream, length = encode(words)
    decode = codec_xla.decode_fn(shape, 32)
    yield ("decode", nbytes,
           lambda: _timed_loop(_chain_u32(decode), stream))


def main(argv=None):
    p = argparse.ArgumentParser(description="ndzip per-stage microbench")
    p.add_argument("--mb", type=float, default=64.0,
                   help="uncompressed working set in MiB")
    p.add_argument("--dims", type=int, default=1, choices=(1, 2, 3))
    p.add_argument("--stages", nargs="*", default=None,
                   help="substring filters on stage names")
    args = p.parse_args(argv)

    n = int(args.mb * (1 << 20)) // 4
    if args.dims == 1:
        shape = (n,)
    elif args.dims == 2:
        s = int(np.sqrt(n)) // 64 * 64
        shape = (s, s)
    else:
        s = int(round(n ** (1 / 3))) // 16 * 16
        shape = (s, s, s)

    import jax

    print(f"# shape={shape} dims={args.dims} chain={CHAIN} "
          f"device={jax.devices()[0].device_kind}", file=sys.stderr)
    for name, nbytes, run in stage_benchmarks(shape, args.dims):
        if args.stages and not any(f in name for f in args.stages):
            continue
        sec = run()
        print(f"{name:<28} {sec * 1e3:>9.3f} ms/rep  {nbytes / sec / 1e9:>8.2f} GB/s")
    return 0


if __name__ == "__main__":
    sys.exit(main())
