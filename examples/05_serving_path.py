"""Device-resident scale-out ("serving path"): the payload never leaves
the mesh.  A training step that writes or reads compressed checkpoint /
dataset shards wants the codec to consume and produce mesh-sharded
``jax.Array``s — not host numpy — so compress_sharded_device /
decompress_sharded_device do interior slicing, per-shard encode/decode,
stream assembly and border scatter all under jit on the devices.

Runs anywhere on an 8-device virtual CPU mesh; the same code runs over a
mesh of GPUs unchanged.
"""

import sys
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_num_cpu_devices", 8)

import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
from ndzip_jax import golden  # noqa: E402
from ndzip_jax.parallel import (  # noqa: E402
    compress_sharded_device,
    decompress_sharded_device,
    make_mesh,
)

mesh = make_mesh()
print("mesh:", mesh)

# a "model state" the program already holds on the mesh (uneven rows on
# purpose: 7 block-rows over 8 devices — trailing shards are zero-padded
# internally and dropped at assembly)
shape = (4096 * 7 + 17,)
rng = np.random.default_rng(0)
state = (np.sin(np.arange(shape[0]) * 1e-4)
         + 0.001 * rng.standard_normal(shape)).astype(np.float32)
state_dev = jnp.asarray(state)

# ---- compress on the mesh: stream + length are device arrays
stream_dev, length_dev = compress_sharded_device(state_dev, mesh)
length = int(length_dev)
expect, elen = golden.compress(state)
assert length == elen and np.asarray(stream_dev[:length]).tobytes() == \
    expect.tobytes(), "device stream != serial codec bytes"
print(f"compressed on-mesh: {length * 4} bytes "
      f"(ratio {length * 4 / state.nbytes:.3f}), bit-exact vs serial codec")

# ---- decompress back to a mesh-sharded jax.Array: the device stream is
# split into per-shard sub-streams ON DEVICE, offset table included
out_dev = decompress_sharded_device(stream_dev[:length], shape,
                                    np.float32, mesh)
assert isinstance(out_dev, jax.Array)
print("decoded sharding devices:", len(out_dev.sharding.device_set))
assert np.array_equal(np.asarray(out_dev).view(np.uint32),
                      state.view(np.uint32))
print("OK: round trip bit-exact; payload stayed on the mesh end-to-end")
