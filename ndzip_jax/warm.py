"""Compile-cache warming tool — the deployment answer to JIT compile cost.

The reference ships AOT-compiled kernels (cuda_factory.cu) and pays no
first-call compile; the jitted device codec compiles once per fresh
(shape, dtype).  This tool fills JAX's persistent compilation cache
(``$JAX_COMPILATION_CACHE_DIR``, else the checkout's ``.jax_cache``; see
``utils.enable_compilation_cache``) for a planned set of shapes, so
production processes load the compiled programs instead of compiling:

    python -m ndzip_jax.warm --shapes 1073741824 512x512x512 --dtype float double

Each (shape, dtype) warms both encode and decode.
"""

from __future__ import annotations

import argparse
import os
import sys
import time


def _parse_shape(s: str) -> tuple:
    try:
        return tuple(int(x) for x in s.replace(",", "x").split("x") if x)
    except ValueError:
        raise argparse.ArgumentTypeError(f"bad shape {s!r}; use e.g. 512x512x512")


def build_parser() -> argparse.ArgumentParser:
    p = argparse.ArgumentParser(
        prog="ndzip-warm",
        description="pre-populate the persistent compile cache for planned shapes")
    p.add_argument("--shapes", nargs="+", type=_parse_shape, required=True,
                   metavar="DxDxD", help="array extents, e.g. 16777216 1800x3600")
    p.add_argument("--dtype", nargs="+", choices=["float", "double"],
                   default=["float"], help="dtypes to warm (default: float)")
    p.add_argument("--cache-dir", default=None,
                   help="cache directory (sets JAX_COMPILATION_CACHE_DIR)")
    return p


def run(argv=None) -> int:
    args = build_parser().parse_args(argv)
    if args.cache_dir:
        os.environ["JAX_COMPILATION_CACHE_DIR"] = args.cache_dir

    import jax
    import numpy as np

    from . import codec_xla, format as fmt, utils

    cache = utils.enable_compilation_cache()
    print(f"warming the xla codec on {jax.default_backend()} into {cache}",
          file=sys.stderr)
    rc = 0
    for shape in args.shapes:
        for tname in args.dtype:
            dtype = np.float32 if tname == "float" else np.float64
            try:
                fmt.validate_shape(shape)
            except ValueError as e:
                print(f"skip {shape} {tname}: {e}", file=sys.stderr)
                rc = 1
                continue
            t0 = time.perf_counter()
            data = np.zeros(shape, dtype)
            stream, _ = codec_xla.compress(data)
            t1 = time.perf_counter()
            out = codec_xla.decompress(stream, shape, dtype)
            t2 = time.perf_counter()
            ok = np.array_equal(out.view(np.uint8).reshape(-1),
                                data.view(np.uint8).reshape(-1))
            print(f"warmed {'x'.join(map(str, shape))} {tname}: "
                  f"encode {t1 - t0:.1f}s decode {t2 - t1:.1f}s"
                  f"{'' if ok else '  ROUND-TRIP MISMATCH'}", file=sys.stderr)
            if not ok:
                rc = 1
    return rc


def main():
    sys.exit(run())


if __name__ == "__main__":
    main()
