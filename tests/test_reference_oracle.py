"""Bit-equality tests against the upstream reference serial codec, built
on the fly from /root/reference (skipped when the reference checkout is
not present).  This is the strongest oracle: our streams must be
byte-identical to ndzip's CPU encoder and decodable by its decoder."""

import subprocess
from pathlib import Path

import numpy as np
import pytest

from ndzip_jax import golden

REF = Path("/root/reference")

DRIVER_SRC = r"""
#include <cassert>
#include <cstdio>
#include <cstdlib>
#include <cstring>
#include <string>
#include <vector>

#include <ndzip/ndzip.hh>
#include "cpu_codec.inl"

namespace ndzip::detail::cpu {
template class serial_compressor<profile<float, 1>>;
template class serial_compressor<profile<float, 2>>;
template class serial_compressor<profile<float, 3>>;
template class serial_compressor<profile<double, 1>>;
template class serial_compressor<profile<double, 2>>;
template class serial_compressor<profile<double, 3>>;
template class serial_decompressor<profile<float, 1>>;
template class serial_decompressor<profile<float, 2>>;
template class serial_decompressor<profile<float, 3>>;
template class serial_decompressor<profile<double, 1>>;
template class serial_decompressor<profile<double, 2>>;
template class serial_decompressor<profile<double, 3>>;
}

using namespace ndzip;

template<typename T, int Dims>
static int run(bool decompress, const std::vector<size_t>& dims) {
    extent size(Dims);
    size_t n = 1;
    for (int d = 0; d < Dims; ++d) { size[d] = dims[d]; n *= dims[d]; }
    using bits = detail::bits_type<T>;
    if (!decompress) {
        std::vector<T> data(n);
        if (fread(data.data(), sizeof(T), n, stdin) != n) return 2;
        std::vector<bits> stream(compressed_length_bound<T>(size));
        detail::cpu::serial_compressor<detail::profile<T, Dims>> comp;
        auto len = comp.compress(data.data(), size, stream.data());
        fwrite(stream.data(), sizeof(bits), len, stdout);
    } else {
        std::vector<bits> stream;
        bits buf[4096]; size_t got;
        while ((got = fread(buf, sizeof(bits), 4096, stdin)) > 0)
            stream.insert(stream.end(), buf, buf + got);
        std::vector<T> data(n);
        detail::cpu::serial_decompressor<detail::profile<T, Dims>> dec;
        dec.decompress(stream.data(), data.data(), size);
        fwrite(data.data(), sizeof(T), n, stdout);
    }
    return 0;
}

int main(int argc, char** argv) {
    if (argc < 4) return 1;
    bool dec = argv[1][0] == 'd';
    bool dbl = std::string(argv[2]) == "double";
    std::vector<size_t> dims;
    for (int i = 3; i < argc; ++i) dims.push_back(strtoull(argv[i], nullptr, 10));
    int nd = (int)dims.size();
    if (dbl) {
        if (nd == 1) return run<double,1>(dec, dims);
        if (nd == 2) return run<double,2>(dec, dims);
        if (nd == 3) return run<double,3>(dec, dims);
    } else {
        if (nd == 1) return run<float,1>(dec, dims);
        if (nd == 2) return run<float,2>(dec, dims);
        if (nd == 3) return run<float,3>(dec, dims);
    }
    return 1;
}
"""


@pytest.fixture(scope="session")
def oracle():
    if not REF.exists():
        pytest.skip("/root/reference not mounted")
    build = Path("/tmp/ndzip_ref_oracle")
    build.mkdir(exist_ok=True)
    binary = build / "ref_oracle"
    src = build / "ref_oracle.cc"
    stale = not src.exists() or src.read_text() != DRIVER_SRC
    if not binary.exists() or stale:
        src.write_text(DRIVER_SRC)
        cmd = [
            "g++", "-O2", "-std=c++17",
            f"-I{REF}/include", f"-I{REF}/src/ndzip",
            "-o", str(binary), str(src), str(REF / "src/ndzip/common.cc"),
        ]
        res = subprocess.run(cmd, capture_output=True, text=True)
        if res.returncode != 0:
            pytest.skip(f"cannot build reference oracle: {res.stderr[:500]}")
    return binary


CASES = [
    ((4096,), np.float32),
    ((2**18 + 37,), np.float32),
    ((70, 65), np.float32),
    ((128, 192), np.float32),
    ((48, 32, 33), np.float32),
    ((4097,), np.float64),
    ((65, 64), np.float64),
    ((33, 32, 48), np.float64),
]


@pytest.mark.parametrize("shape,dtype", CASES)
def test_golden_bitexact_vs_reference(oracle, shape, dtype):
    rng = np.random.default_rng(sum(shape))
    data = rng.standard_normal(shape).astype(dtype)
    data.reshape(-1)[:100] = 0
    tname = "float" if dtype == np.float32 else "double"
    args = [str(oracle), "c", tname] + [str(s) for s in shape]
    ref_stream = subprocess.run(args, input=data.tobytes(), capture_output=True).stdout
    mine, _ = golden.compress(data)
    assert mine.tobytes() == ref_stream

    args = [str(oracle), "d", tname] + [str(s) for s in shape]
    ref_decoded = subprocess.run(args, input=mine.tobytes(), capture_output=True).stdout
    assert ref_decoded == data.tobytes()
