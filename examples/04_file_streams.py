"""File and pipe workflows: multi-chunk compressed files, memory-mapped
output, stdin/stdout piping, and the compile-cache warmer — the
reference's io library + compress-tool workflows
(/root/reference/src/io/io.cc, src/compress/compress.cc:17-86).

Forces the CPU platform/backend so it runs anywhere.
"""

import subprocess
import sys
import tempfile
from pathlib import Path

import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

rng = np.random.default_rng(3)
shape = (70, 130)   # not block-aligned: exercises border paths
chunk = np.cumsum(rng.standard_normal(np.prod(shape))
                  ).astype(np.float32).reshape(shape)

with tempfile.TemporaryDirectory() as td:
    td = Path(td)

    # --- a file holding THREE arrays of the same extent ------------------
    raw = td / "stack.f32"
    with open(raw, "wb") as f:
        for k in range(3):
            (chunk * (k + 1)).tofile(f)

    packed = td / "stack.ndz"
    subprocess.run([sys.executable, "-m", "ndzip_jax.cli", "-e", "cpu",
                    "-t", "float", "-n", "70", "130",
                    "-i", str(raw), "-o", str(packed)],
                   check=True, cwd=REPO)

    back = td / "back.f32"
    subprocess.run([sys.executable, "-m", "ndzip_jax.cli", "-d", "-e", "cpu",
                    "-t", "float", "-n", "70", "130",
                    "-i", str(packed), "-o", str(back)],
                   check=True, cwd=REPO)
    assert back.read_bytes() == raw.read_bytes()
    print(f"3-chunk file round-trip OK "
          f"({raw.stat().st_size} -> {packed.stat().st_size} bytes)")

    # --- pipes: compress stdin -> stdout (no seekable files needed) ------
    comp = subprocess.run(
        [sys.executable, "-m", "ndzip_jax.cli", "-e", "cpu",
         "-t", "float", "-n", "70", "130"],
        input=raw.read_bytes(), capture_output=True, check=True, cwd=REPO)
    deco = subprocess.run(
        [sys.executable, "-m", "ndzip_jax.cli", "-d", "-e", "cpu",
         "-t", "float", "-n", "70", "130"],
        input=comp.stdout, capture_output=True, check=True, cwd=REPO)
    assert deco.stdout == raw.read_bytes()
    print("stdin->stdout pipe round-trip OK")

    # --- the io layer directly: mmap input, ftruncate-grow mmap output ---
    from ndzip_jax import io as ndz_io

    src = ndz_io.open_input(str(raw), use_mmap=True)
    dst = ndz_io.open_output(str(td / "copy.f32"), use_mmap=True)
    for piece in src.read_exact(chunk.nbytes):
        dst.write_chunk(np.frombuffer(piece, np.uint8))
    src.close()
    dst.close()
    assert (td / "copy.f32").read_bytes() == raw.read_bytes()
    print("mmap input -> grow-mapped output copy OK")

print("""
Pre-populate the persistent compile cache so the first production call
loads compiled programs instead of compiling them:

    python -m ndzip_jax.warm --shapes 16777216 1800x3600 --dtype float
""")
