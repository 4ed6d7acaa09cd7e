"""A deliberately naive, scalar, from-the-spec ndzip encoder used ONLY as an
independent cross-check of the vectorized golden codec in tests.  Slow; keep
inputs small.  Mirrors /root/reference/src/ndzip/cpu_codec.inl:580-659
semantics directly."""

from __future__ import annotations

import numpy as np

from ndzip_jax import format as fmt


def _rotl1(v: int, bits: int) -> int:
    mask = (1 << bits) - 1
    return ((v << 1) | (v >> (bits - 1))) & mask


def _complement_negative(v: int, bits: int) -> int:
    if v >> (bits - 1):
        return v ^ ((1 << (bits - 1)) - 1)
    return v


def _block_transform_step(x: list[int], base: int, n: int, s: int, bits: int):
    mask = (1 << bits) - 1
    b = x[base]
    for i in range(1, n):
        a = b
        b = x[base + i * s]
        x[base + i * s] = (b - a) & mask


def block_transform(cube: list[int], dims: int, n: int, bits: int):
    for i in range(len(cube)):
        cube[i] = _rotl1(cube[i], bits)
    if dims == 1:
        _block_transform_step(cube, 0, n, 1, bits)
    elif dims == 2:
        for i in range(0, n * n, n):
            _block_transform_step(cube, i, n, 1, bits)
        for i in range(n):
            _block_transform_step(cube, i, n, n, bits)
    elif dims == 3:
        for i in range(0, n * n * n, n * n):
            for j in range(n):
                _block_transform_step(cube, i + j, n, n, bits)
        for i in range(0, n * n * n, n):
            _block_transform_step(cube, i, n, 1, bits)
        for i in range(n * n):
            _block_transform_step(cube, i, n, n * n, bits)
    for i in range(len(cube)):
        cube[i] = _complement_negative(cube[i], bits)


def transpose_bits(vs: list[int], bits: int) -> list[int]:
    out = []
    for i in range(bits):
        w = 0
        for j in range(bits):
            w |= ((vs[j] >> (bits - 1 - i)) & 1) << (bits - 1 - j)
        out.append(w)
    return out


def zero_bit_encode(cube: list[int], bits: int) -> tuple[list[int], list[int]]:
    """Returns (heads, body) word lists for one block."""
    heads, body = [], []
    for off in range(0, len(cube), bits):
        chunk = cube[off : off + bits]
        zero_map = 0
        for w in chunk:
            zero_map |= w
        heads.append(zero_map)
        if zero_map:
            for w in transpose_bits(chunk, bits):
                if w:
                    body.append(w)
    return heads, body


def compress(data: np.ndarray) -> np.ndarray:
    """Returns the stream as a uint32 array (byte-identical layout)."""
    words = data.view(np.uint32 if data.dtype == np.float32 else np.uint64)
    bits = words.dtype.itemsize * 8
    dims = words.ndim
    side = fmt.SIDE_LENGTH[dims]
    num_hc = fmt.num_hypercubes(words.shape)

    header: list[int] = []
    stream_words: list[int] = []
    offset = 0
    for origin in fmt.hypercube_origins(words.shape):
        sl = tuple(slice(o, o + side) for o in origin)
        cube = [int(v) for v in np.asarray(words[sl]).reshape(-1)]
        block_transform(cube, dims, side, bits)
        heads, body = zero_bit_encode(cube, bits)
        offset += len(heads) + len(body)
        header.append(offset)
        stream_words += heads + body

    out = bytearray()
    for h in header:
        out += int(h).to_bytes(4, "little")
    while len(out) % (bits // 8):
        out += b"\0"
    for w in stream_words:
        out += int(w).to_bytes(bits // 8, "little")
    flat = words.reshape(-1)
    for off, cnt in fmt.border_slices(words.shape):
        out += flat[off : off + cnt].tobytes()
    return np.frombuffer(bytes(out), dtype=np.uint32)
