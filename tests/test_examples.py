"""The examples/ walkthroughs must stay runnable — they are the documented
user workflows (examples/README.md maps each to a reference workflow)."""

import os
import subprocess
import sys
from pathlib import Path

import pytest

REPO = Path(__file__).resolve().parent.parent


@pytest.mark.parametrize("script", ["01_roundtrip.py", "02_device_resident.py",
                                    "03_sharded_mesh.py", "04_file_streams.py",
                                    "05_serving_path.py"])
def test_example_runs(script):
    res = subprocess.run(
        [sys.executable, str(REPO / "examples" / script)],
        capture_output=True, text=True, timeout=600, cwd=REPO,
        env={**os.environ, "JAX_PLATFORMS": "cpu"})
    assert res.returncode == 0, res.stderr
    assert "OK" in res.stdout
