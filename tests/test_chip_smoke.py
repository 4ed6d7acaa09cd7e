"""chip_smoke.py on the CPU: it refuses to run without a GPU, its last
line carries exactly the contract's keys, and its phase functions run
bit-exact at reduced shapes (the four-card phase on 4 of the 8 virtual
devices)."""

import contextlib
import io
import json
import os
import shutil
import subprocess
import sys
from pathlib import Path

import jax
import numpy as np
import pytest

REPO = Path(__file__).resolve().parent.parent
sys.path.insert(0, str(REPO))

import bench  # noqa: E402
import chip_smoke  # noqa: E402

RNG = np.random.default_rng(91)


def _field(shape, dtype):
    n = int(np.prod(shape))
    data = np.sin(np.arange(n) * 1e-3) + 1e-3 * RNG.standard_normal(n)
    data = data.astype(dtype).reshape(shape)
    data.reshape(-1)[:100] = 0
    return data


CELLS = {
    "fp32_1d": _field((4096 * 3 + 5,), np.float32),
    "fp64": _field((4096 * 2 + 9,), np.float64),
    "cesm": _field((130, 200), np.float32),
    "cube3d": _field((32, 32, 48), np.float32),
    "fp64_cube": _field((32, 16, 17), np.float64),
}


@pytest.fixture(scope="module")
def host_phase():
    out = io.StringIO()
    with contextlib.redirect_stdout(out):
        streams = chip_smoke.phase_host_api(CELLS)
    return streams, out.getvalue()


@pytest.fixture
def streams(host_phase):
    return host_phase[0]


def _run(args, cwd):
    return subprocess.run([sys.executable, *args], cwd=cwd, capture_output=True,
                          text=True, timeout=300,
                          env={**os.environ, "JAX_PLATFORMS": "cpu"})


@pytest.mark.parametrize("cards", ["1", "4"])
def test_refuses_without_gpu(cards):
    res = _run(["chip_smoke.py", "--cards", cards], REPO)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout
    assert "not 'gpu'" in res.stderr


def test_fails_outside_the_repo(tmp_path):
    shutil.copy(REPO / "chip_smoke.py", tmp_path / "chip_smoke.py")
    res = _run(["chip_smoke.py"], tmp_path)
    assert res.returncode != 0
    assert '"ok"' not in res.stdout


@pytest.mark.parametrize("count", [1, 4])
def test_ok_line_has_exactly_the_contract_keys(count):
    line = chip_smoke.ok_line("gpu", "NVIDIA H100 80GB HBM3", count)
    assert "\n" not in line
    assert json.loads(line) == {"ok": True, "device": {
        "platform": "gpu", "kind": "NVIDIA H100 80GB HBM3", "count": count}}


def test_cells_are_bench_cells():
    names = (set(chip_smoke.ONE_CARD_CELLS) | set(chip_smoke.DEVICE_CELLS)
             | set(chip_smoke.FOUR_CARD_CELLS))
    assert names <= set(bench.CELLS)
    assert set(chip_smoke.ONE_CARD_CELLS) == set(bench.CELLS)


def test_host_api_phase_matches_golden(host_phase):
    from ndzip_jax import golden

    streams, out = host_phase
    for name, data in CELLS.items():
        expect, _ = golden.compress(data)
        assert streams[name].tobytes() == expect.tobytes(), name
    assert out.count("phase host_api") == len(CELLS)
    assert "encode_peak_bytes=" in out and "decode_cold_s=" in out


def test_device_phase(streams, capsys):
    chip_smoke.phase_device({n: CELLS[n] for n in ("fp32_1d", "fp64_cube")},
                            streams, platform="cpu")
    assert capsys.readouterr().out.count("phase device") == 2


def test_device_phase_checks_the_platform(streams):
    with pytest.raises(AssertionError, match="expected gpu"):
        chip_smoke.phase_device({"fp32_1d": CELLS["fp32_1d"]}, streams)


def test_offloader_phase(streams, capsys):
    chip_smoke.phase_offloader("fp32_1d", CELLS["fp32_1d"], streams["fp32_1d"],
                               "card, 700.00 W")
    out = capsys.readouterr().out
    assert "measure_decompress_ns=" in out and "700.00 W" in out


def test_cli_phase(streams, capsys):
    chip_smoke.phase_cli("cesm", CELLS["cesm"], streams["cesm"])
    assert "phase cli cesm" in capsys.readouterr().out


def test_sharded_backend_phase(streams, capsys):
    chip_smoke.phase_sharded_backend("cube3d", CELLS["cube3d"], streams["cube3d"])
    assert "phase sharded cube3d" in capsys.readouterr().out


def test_four_card_phase(capsys):
    cells = {"fp32_3d": _field((64, 32, 48), np.float32),
             "fp64_3d": _field((32, 16, 16), np.float64)}
    chip_smoke.phase_four_cards(cells, jax.devices()[:4], platform="cpu")
    out = capsys.readouterr().out
    assert out.count("phase four_cards") == 2 and "devices=4" in out


def test_phase_rejects_a_wrong_stream(streams):
    bad = streams["cesm"].copy()
    bad[-1] ^= 1
    with pytest.raises(AssertionError, match="bytes differ"):
        chip_smoke.phase_cli("cesm", CELLS["cesm"], bad)
