"""Device-resident compression: the data is a jax.Array the program
already holds on the device, and the compressed stream stays there —
the workflow of the reference's `cuda_compressor` over device pointers
(/root/reference/include/ndzip/cuda.hh:10-41).  Typical use: compress a
shard right before a transfer or a host checkpoint write.

Runs on JAX's default platform (the GPU where there is one; the CPU
otherwise, with the same bytes at CPU speed).

Also shown: the Offloader's kernel timing — `timing_mode="device"` fences
staging first and times only the jitted codec (the reference's
`kernel_duration`, offload.hh:16-24), and `measure()` runs the two-point
chained-loop protocol for dispatch-free device numbers.
"""

import sys
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import ndzip_jax  # noqa: E402
from ndzip_jax import api  # noqa: E402

data = np.sin(np.arange(2**20, dtype=np.float32) * 1e-4)

# --- jax.Array in, jax.Array out: nothing leaves the device ---------------
dev = jnp.asarray(data)
stream_dev, length = ndzip_jax.compress_device(dev)
print("stream device:", stream_dev.device, " length words:", int(length))
back = ndzip_jax.decompress_device(stream_dev, data.shape)
assert isinstance(back, jax.Array)
assert np.array_equal(np.asarray(back), data)
print("device round-trip OK")

# --- host-array Offloader with device-fenced kernel timing ---------------
off = api.Offloader(np.float32, dims=1, backend="xla", timing_mode="device")
stream, words = off.compress(data)
print(f"compress: {4 * words / data.nbytes:.3f} ratio, "
      f"{off.timing.compress_ns / 1e6:.2f} ms kernel time "
      f"(staging/dispatch-fenced, one dispatch included)")
out = off.decompress(stream[:words], data.shape)
assert np.array_equal(out, data)
print(f"decompress: {off.timing.decompress_ns / 1e6:.2f} ms kernel time")

# --- dispatch-free numbers: two-point chained-loop slope ------------------
t = off.measure(data)
gbps_c = data.nbytes / max(t.compress_ns, 1)
gbps_d = data.nbytes / max(t.decompress_ns, 1)
print(f"measure(): compress {gbps_c:.2f} GB/s, decompress {gbps_d:.2f} GB/s "
      f"(device time on {jax.devices()[0].platform})")
print("OK")
