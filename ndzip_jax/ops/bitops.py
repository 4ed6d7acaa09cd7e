"""Word-level bit operations of the ndzip format, written once against the
numpy array API so that the identical code runs under numpy (golden codec)
and jax.numpy (XLA codec).  Pass the array module as ``xp``.

Semantics mirror /root/reference/src/ndzip/common.hh:436-449 (rotate,
complement-negative) and src/ndzip/cpu_codec.inl:355-363 (bit transpose).
The bit transpose is implemented as the 5/6-round mask-and-shift butterfly
network (classic 32x32 bit-matrix transpose) instead of the reference's
movemask/unpack SIMD sequences — the network vectorizes over an arbitrary
batch of chunks, which is the natural formulation for a batched array
program.
"""

from __future__ import annotations

import numpy as np


def _const(xp, value, dtype):
    return xp.asarray(value, dtype=dtype)


def rotate_left_1(x, xp=np):
    """(v << 1) | (v >> (bits-1)) — common.hh:436-439."""
    bits = x.dtype.itemsize * 8
    one = _const(xp, 1, x.dtype)
    hi = _const(xp, bits - 1, x.dtype)
    return (x << one) | (x >> hi)


def rotate_right_1(x, xp=np):
    """common.hh:441-444."""
    bits = x.dtype.itemsize * 8
    one = _const(xp, 1, x.dtype)
    hi = _const(xp, bits - 1, x.dtype)
    return (x >> one) | (x << hi)


def complement_negative(x, xp=np):
    """If the sign bit is set, flip all non-sign bits (common.hh:446-449).
    An involution."""
    bits = x.dtype.itemsize * 8
    sign = (x >> _const(xp, bits - 1, x.dtype)) != 0
    mask = _const(xp, (1 << (bits - 1)) - 1, x.dtype)
    return xp.where(sign, x ^ mask, x)


def _transpose_masks(bits: int) -> list[tuple[int, int]]:
    """(j, mask) pairs of the butterfly transpose network, j descending."""
    out = []
    j = bits // 2
    m = (1 << (bits // 2)) - 1
    while j:
        out.append((j, m))
        j >>= 1
        if j:
            m = m ^ ((m << j) & ((1 << bits) - 1))
    return out


_MASKS32 = _transpose_masks(32)
_MASKS64 = _transpose_masks(64)


def transpose_bits(chunks, xp=np):
    """Bit-matrix transpose of each chunk.

    ``chunks`` has shape (..., W) where W = word bits (32 or 64) and dtype
    uint{W}.  Word j of a chunk is row j of a WxW bit matrix in MSB-first
    column order; the result is the transposed matrix in the same
    convention:  out[..., i] bit (W-1-j)  ==  in[..., j] bit (W-1-i).

    Matches transpose_bits_trivial (cpu_codec.inl:355-363) bit-for-bit and
    is an involution (codec_generic_test.cc:65-81).
    """
    bits = chunks.dtype.itemsize * 8
    assert chunks.shape[-1] == bits, (chunks.shape, bits)
    masks = _MASKS32 if bits == 32 else _MASKS64
    lead = chunks.shape[:-1]
    a = chunks
    for j, m in masks:
        a = a.reshape(lead + (bits // (2 * j), 2, j))
        upper = a[..., 0, :]
        lower = a[..., 1, :]
        jj = _const(xp, j, chunks.dtype)
        mm = _const(xp, m, chunks.dtype)
        t = (upper ^ (lower >> jj)) & mm
        upper = upper ^ t
        lower = lower ^ (t << jj)
        a = xp.stack([upper, lower], axis=-2)
    return a.reshape(lead + (bits,))


def transpose_bits_pair32(hi, lo, xp=np):
    """64x64 bit transpose where each 64-bit word is represented as two
    uint32 planes (hi = bits 63..32, lo = bits 31..0).

    ``hi``/``lo`` have shape (..., 64): word j of the chunk split into
    halves.  Returns (out_hi, out_lo) with the same shapes, matching
    transpose_bits on the recombined uint64 values.  This is the 64-bit
    formulation without uint64 on the device: four independent 32x32
    transposes of the quadrants, mirroring how the reference assembles the
    64-bit transpose from 32-bit registers (cuda_codec.inl:236-264).
    """
    assert hi.shape[-1] == 64 and lo.shape[-1] == 64
    t_hh = transpose_bits(hi[..., :32], xp)  # rows 0..31,  cols 63..32
    t_hl = transpose_bits(hi[..., 32:], xp)  # rows 32..63, cols 63..32
    t_lh = transpose_bits(lo[..., :32], xp)  # rows 0..31,  cols 31..0
    t_ll = transpose_bits(lo[..., 32:], xp)  # rows 32..63, cols 31..0
    # out word i (i < 32): bits 63..32 come from hi rows 0..31 col 63-i -> t_hh
    #                      bits 31..0  come from hi rows 32..63         -> t_hl
    # out word i (i >= 32): from lo planes.
    out_hi = xp.concatenate([t_hh, t_lh], axis=-1)
    out_lo = xp.concatenate([t_hl, t_ll], axis=-1)
    return out_hi, out_lo


def popcount_np(x: np.ndarray) -> np.ndarray:
    """Vectorized popcount for numpy uint arrays."""
    bits = x.dtype.itemsize * 8
    x = x.copy()
    if bits == 32:
        m1, m2, m4 = np.uint32(0x55555555), np.uint32(0x33333333), np.uint32(0x0F0F0F0F)
        x = x - ((x >> np.uint32(1)) & m1)
        x = (x & m2) + ((x >> np.uint32(2)) & m2)
        x = (x + (x >> np.uint32(4))) & m4
        return ((x * np.uint32(0x01010101)) >> np.uint32(24)).astype(np.int32)
    else:
        m1 = np.uint64(0x5555555555555555)
        m2 = np.uint64(0x3333333333333333)
        m4 = np.uint64(0x0F0F0F0F0F0F0F0F)
        x = x - ((x >> np.uint64(1)) & m1)
        x = (x & m2) + ((x >> np.uint64(2)) & m2)
        x = (x + (x >> np.uint64(4))) & m4
        return ((x * np.uint64(0x0101010101010101)) >> np.uint64(56)).astype(np.int32)
