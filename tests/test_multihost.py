"""Multi-host layer tests: spawn real multi-process JAX (CPU, gloo
collectives) on one machine and assert the assembled stream is
bit-identical to the serial golden stream.  The reference has no
multi-node tests at all (SURVEY.md §4) — this coverage is new work."""

import os
import socket
import subprocess
import sys
import textwrap
from pathlib import Path

import numpy as np
import pytest

from ndzip_jax import golden

REPO = Path(__file__).resolve().parent.parent

WORKER = textwrap.dedent("""
    import os, sys
    pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
    tmp = sys.argv[4]; case = sys.argv[5]
    os.environ["JAX_PLATFORMS"] = "cpu"
    sys.path.insert(0, {repo!r})
    import numpy as np
    from ndzip_jax.parallel import multihost

    multihost.init(f"localhost:{{port}}", nproc, pid, platform="cpu")
    import jax
    assert jax.process_count() == nproc, jax.process_count()

    if case == "f32_2d":
        shape, dtype = (nproc * 128, 200), np.float32
    elif case == "f64_3d":
        shape, dtype = (nproc * 32, 33, 35), np.float64
    elif case == "f32_2d_localmesh":
        # 2 local devices per process: decompress_multihost must shard the
        # slab decode over the process-local mesh (every device busy)
        shape, dtype = (nproc * 128, 200), np.float32
        import jax
        assert jax.local_device_count() == 2, jax.local_device_count()
    elif case == "f32_2d_uneven":
        # 3 block-rows per slab over 2 local devices: padded-shard encode
        # (trailing shard carries a zero block-row dropped at assembly)
        shape, dtype = (nproc * 192, 200), np.float32
        import jax
        assert jax.local_device_count() == 2, jax.local_device_count()
    else:
        raise SystemExit(f"unknown case {{case}}")

    rng = np.random.default_rng(7)
    full = rng.standard_normal(shape).astype(dtype)
    full.reshape(-1)[:500] = 0
    rows = shape[0] // nproc
    slab = full[pid * rows : (pid + 1) * rows]

    shard = multihost.compress_multihost(slab)
    stream = multihost.gather_stream(shard)
    path = os.path.join(tmp, "mh_stream.bin")
    n = multihost.compress_to_file(slab, path)
    out_slab = multihost.decompress_multihost(
        np.fromfile(path, np.uint32), shape, dtype)
    assert np.array_equal(out_slab.view(np.uint8), slab.view(np.uint8)), \
        f"proc {{pid}}: decompress_multihost mismatch"
    out_slab2 = multihost.decompress_from_file(path, shape, dtype)
    assert np.array_equal(out_slab2.view(np.uint8), slab.view(np.uint8)), \
        f"proc {{pid}}: decompress_from_file mismatch"

    if pid == 0:
        np.save(os.path.join(tmp, "gathered.npy"), stream)
        np.save(os.path.join(tmp, "full.npy"), full)
    print(f"proc {{pid}} OK", flush=True)
""").format(repo=str(REPO))


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


@pytest.mark.parametrize("case,nproc", [
    ("f32_2d", 2), ("f64_3d", 2), ("f32_2d", 4), ("f32_2d_localmesh", 2),
    ("f32_2d_uneven", 2)])
def test_multihost_bit_exact(tmp_path, case, nproc):
    port = _free_port()
    script = tmp_path / "worker.py"
    script.write_text(WORKER)
    env = dict(os.environ)
    env.pop("XLA_FLAGS", None)
    # localmesh: multiple devices per process so the slab decode shards
    # over the process-local mesh (parallel/multihost.py decode routing)
    env["JAX_NUM_CPU_DEVICES"] = (
        "2" if case.endswith(("localmesh", "uneven")) else "1")
    procs = [
        subprocess.Popen(
            [sys.executable, str(script), str(i), str(nproc), str(port),
             str(tmp_path), case],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, env=env)
        for i in range(nproc)
    ]
    outs = [p.communicate(timeout=300)[0].decode() for p in procs]
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out[-3000:]}"

    gathered = np.load(tmp_path / "gathered.npy")
    full = np.load(tmp_path / "full.npy")
    expect, _ = golden.compress(full)
    assert gathered.tobytes() == expect.tobytes(), \
        "multihost stream is not bit-identical to the serial stream"
    file_stream = np.fromfile(tmp_path / "mh_stream.bin", np.uint32)
    assert file_stream.tobytes() == expect.tobytes(), \
        "compress_to_file stream differs"
