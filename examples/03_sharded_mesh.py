"""Multi-device compression over a jax.sharding.Mesh — the scale-out
layer the reference (a single-device codec) does not have.  The
block-index space is sharded with shard_map: every device encodes its
contiguous block range with the same block codec as the single-device
path, one tiny length collective crosses the mesh, and the assembled
stream is bit-exact vs the serial encoder.

This script builds an 8-device *virtual CPU* mesh so it runs anywhere
(`__graft_entry__.dryrun_multichip` checks the same path; on GPUs the
identical code runs over the physical mesh — see
ndzip_jax/parallel/multihost.py for the multi-process tier).
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import ndzip_jax  # noqa: E402
from ndzip_jax.parallel import sharded  # noqa: E402

print("devices:", len(jax.devices()))
mesh = sharded.make_mesh()  # 1-axis mesh over all visible devices

# A 3D fp32 field, grid-aligned along the sharded (major) axis.
z, y, x = np.mgrid[0:128, 0:32, 0:64].astype(np.float32)
data = (np.sin(z * 0.1) + np.cos(y * 0.2) * np.sin(x * 0.05)).astype(np.float32)

stream, words = sharded.compress_sharded(data, mesh)
serial, serial_words = ndzip_jax.compress(data, backend="golden")
assert words == serial_words
assert np.asarray(stream)[:words].tobytes() == serial[:serial_words].tobytes()
print(f"sharded stream ≡ serial stream ({words} words, "
      f"ratio {4 * words / data.nbytes:.3f})")

out = sharded.decompress_sharded(np.asarray(stream)[:words], data.shape,
                                 np.float32, mesh)
assert np.array_equal(np.asarray(out), data)
print("sharded decode OK — every device decoded its block range")

# fp64 works the same way; streams stay (lo, hi) u32 pairs on device.
d64 = np.cumsum(np.random.default_rng(0).standard_normal(128 * 32 * 16)
                ).reshape(128, 32, 16)  # grid major axis divisible by 8
s64, w64 = sharded.compress_sharded(d64, mesh)
g64, gw64 = ndzip_jax.compress(d64, backend="golden")
# streams are u32 arrays; lengths count u64 stream words -> 2 u32 each
assert w64 == gw64
assert np.asarray(s64)[: 2 * w64].tobytes() == g64[: 2 * gw64].tobytes()
print("fp64 sharded stream ≡ serial stream")
