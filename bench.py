#!/usr/bin/env python
"""Headline benchmark: device throughput of the ndzip codec on one GPU.

Runs six cells through the device codec (``codec_xla``): fp32 1D 2^24,
fp64 1D 2^23, the CESM-shaped fp32 1800x3600, fp32 256^3, fp64 512^3
(1 GiB) and fp32 512x512x2048 (2 GiB).  Before a cell is timed, its stream
is compared byte for byte with ``golden.py`` and decoded bit-exactly, as
the reference's harness does on every run (benchmark.cc:263-265).

Timing is device-only: N codec calls chained inside one jitted fori_loop
(each iteration's input depends on the loop index, so XLA cannot hoist or
CSE the call), timed at two chain lengths; the per-call time is the slope,
which cancels the fixed dispatch and sync cost
(``benchmark.chained_device_times``, the analog of the reference's
CUDA-event timing, benchmark.cc:331-341).

Earlier lines name the device: JAX's platform, device_kind and device
count, and the cards' nvidia-smi name and power limit.  The last line is
one JSON object.  Exits nonzero when the platform is not ``gpu`` or when
any cell fails.
"""

import json
import sys

import numpy as np

CHAINS = (10, 50)


def _cube(shape, span, dtype, rng):
    axes = [np.linspace(0, s, n, dtype=np.float64) for n, s in zip(shape, span)]
    field = (np.sin(axes[0][:, None, None]) * np.cos(axes[1][None, :, None])
             * np.sin(axes[2][None, None, :] * 2)).astype(dtype)
    field += 0.001 * rng.standard_normal(shape, dtype=dtype)
    return field


def _fp32_1d(rng):
    n = 2**24
    return (np.sin(np.arange(n, dtype=np.float32) * 1e-4)
            + 0.001 * rng.standard_normal(n, dtype=np.float32))


def _fp64_1d(rng):
    n = 2**23
    return np.sin(np.arange(n, dtype=np.float64) * 1e-4) + 0.001 * rng.standard_normal(n)


def _cesm(rng):
    y = np.linspace(0, 11.0, 1800, dtype=np.float64)[:, None]
    x = np.linspace(0, 7.0, 3600, dtype=np.float64)[None, :]
    return (np.sin(y) * np.cos(x)
            + 0.001 * rng.standard_normal((1800, 3600))).astype(np.float32)


# name -> seeded generator; every cell draws from its own default_rng(0)
CELLS = {
    "fp32_1d": _fp32_1d,
    "fp64": _fp64_1d,
    "cesm": _cesm,
    "cube3d": lambda rng: _cube((256, 256, 256), (5.0, 5.0, 5.0), np.float32, rng),
    "fp64_512cube": lambda rng: _cube((512, 512, 512), (9.0, 9.0, 9.0), np.float64, rng),
    "fp32_2gib_3d": lambda rng: _cube((512, 512, 2048), (9.0, 9.0, 4.0), np.float32, rng),
}


def make_cell(name: str) -> np.ndarray:
    return CELLS[name](np.random.default_rng(0))


def describe_devices() -> dict:
    """Print and return what the numbers are measured on."""
    import jax

    from ndzip_jax import utils

    devs = jax.devices()
    dev = {"platform": devs[0].platform, "kind": devs[0].device_kind,
           "count": len(devs)}
    print(f"device: platform={dev['platform']} kind={dev['kind']} "
          f"count={dev['count']}", flush=True)
    if dev["platform"] != "gpu":
        raise SystemExit(f"bench.py measures the GPU; JAX's platform is "
                         f"{dev['platform']!r}")
    dev["nvidia_smi"] = utils.gpu_name_power()
    print(f"nvidia-smi: {dev['nvidia_smi']}", flush=True)
    return dev


def bench_cell(name: str) -> dict:
    from ndzip_jax import codec_xla, golden
    from ndzip_jax.benchmark import chained_device_times

    data = make_cell(name)
    stream, words = codec_xla.compress(data)
    expect, expect_words = golden.compress(data)
    if words != expect_words or stream.tobytes() != expect.tobytes():
        raise AssertionError(f"{name}: stream differs from golden.py")
    out = codec_xla.decompress(stream, data.shape, data.dtype)
    if out.tobytes() != data.tobytes():
        raise AssertionError(f"{name}: decode is not bit-exact")
    enc_ns, dec_ns = chained_device_times(data, CHAINS)
    row = {"shape": list(data.shape), "dtype": data.dtype.name,
           "compress_gbps": data.nbytes / enc_ns,
           "decompress_gbps": data.nbytes / dec_ns,
           "ratio": words * data.itemsize / data.nbytes}
    print(f"cell {name}: {json.dumps(row)}", flush=True)
    return row


def main() -> int:
    device = describe_devices()
    cells = {name: bench_cell(name) for name in CELLS}
    print(json.dumps({
        "metric": "fp32 1D 2^24 decompression throughput (one GPU, device time)",
        "value": cells["fp32_1d"]["decompress_gbps"],
        "unit": "GB/s",
        "extra": {"device": device, "chains": list(CHAINS), "cells": cells},
    }), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
