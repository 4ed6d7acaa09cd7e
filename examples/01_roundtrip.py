"""Basic host-side usage: compress/decompress numpy arrays, pick backends,
and drive the CLI — the workflow of the reference's `compress` tool
(/root/reference/src/compress/compress.cc).

Runs anywhere: forces the CPU platform; every backend emits bit-identical
streams, so what you see here is byte-for-byte what the GPU path produces.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

sys.path.insert(0, str(Path(__file__).resolve().parent.parent))
import ndzip_jax  # noqa: E402

# A CESM-like 2D field: smooth in both axes, fp32.
y, x = np.mgrid[0:180, 0:360].astype(np.float32)
data = (np.sin(y * 0.05) * np.cos(x * 0.03)).astype(np.float32)

# --- one-call API (backend="auto" is the device codec, "xla") -------------
stream, words = ndzip_jax.compress(data)
out = ndzip_jax.decompress(stream, data.shape, np.float32)
assert np.array_equal(out, data)
print(f"shape {data.shape}  ratio {4 * words / data.nbytes:.3f}  "
      f"({words} stream words)")

# --- every backend, same bytes ------------------------------------------
streams = {}
for backend in ("golden", "cpu", "xla"):
    s, n = ndzip_jax.compress(data, backend=backend)
    streams[backend] = np.asarray(s)[:n].tobytes()
assert len(set(streams.values())) == 1
print("golden == cpu == xla stream bytes:", len(streams["cpu"]), "bytes")

# --- reusable compressor objects (amortize jit/plan setup) ---------------
from ndzip_jax import api  # noqa: E402

comp = api.make_compressor(np.float32, dims=2, backend="cpu", threads=4)
dec = api.make_decompressor(np.float32, dims=2, backend="cpu")
s, n = comp.compress(data)
assert np.array_equal(dec.decompress(s, data.shape), data)
print("multithreaded CPU backend round-trip OK")

# --- the CLI, exactly like the reference's `compress` binary -------------
with tempfile.TemporaryDirectory() as td:
    raw = Path(td) / "field.f32"
    packed = Path(td) / "field.ndz"
    back = Path(td) / "back.f32"
    data.tofile(raw)
    subprocess.run([sys.executable, "-m", "ndzip_jax.cli", "-e", "cpu",
                    "-t", "float", "-n", "180", "360",
                    "-i", str(raw), "-o", str(packed)], check=True)
    subprocess.run([sys.executable, "-m", "ndzip_jax.cli", "-d", "-e", "cpu",
                    "-t", "float", "-n", "180", "360",
                    "-i", str(packed), "-o", str(back)], check=True)
    assert np.array_equal(np.fromfile(back, np.float32).reshape(data.shape),
                          data)
    print(f"CLI round-trip OK ({packed.stat().st_size} compressed bytes)")
