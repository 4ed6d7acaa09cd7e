"""uint64 arithmetic emulated as (lo, hi) uint32 pairs.

JAX exposes uint64 only under the process-wide ``jax_enable_x64`` flag, so
the float64 code path represents every 64-bit stream word as two uint32
lanes (little-endian order: lo at the lower u32 address, matching the
on-disk byte layout).  All ops below are elementwise over arbitrary shapes
and work with numpy or jax.numpy (pass ``xp``).
"""

from __future__ import annotations

import numpy as np


def _c(xp, v):
    return xp.asarray(v, dtype=xp.uint32)


def split(words_u64, xp=np):
    """uint64 array -> (lo, hi) uint32 arrays (host-side helper)."""
    lo = (words_u64 & np.uint64(0xFFFFFFFF)).astype(np.uint32)
    hi = (words_u64 >> np.uint64(32)).astype(np.uint32)
    return lo, hi


def join(lo, hi):
    """(lo, hi) -> uint64 (host-side helper)."""
    return (np.asarray(hi, dtype=np.uint64) << np.uint64(32)) | np.asarray(lo, dtype=np.uint64)


def add(a_lo, a_hi, b_lo, b_hi, xp=np):
    lo = a_lo + b_lo
    carry = (lo < a_lo).astype(a_lo.dtype)
    hi = a_hi + b_hi + carry
    return lo, hi


def sub(a_lo, a_hi, b_lo, b_hi, xp=np):
    lo = a_lo - b_lo
    borrow = (a_lo < b_lo).astype(a_lo.dtype)
    hi = a_hi - b_hi - borrow
    return lo, hi


def rotl1(lo, hi, xp=np):
    one = _c(xp, 1)
    t31 = _c(xp, 31)
    new_hi = (hi << one) | (lo >> t31)
    new_lo = (lo << one) | (hi >> t31)
    return new_lo, new_hi


def rotr1(lo, hi, xp=np):
    one = _c(xp, 1)
    t31 = _c(xp, 31)
    new_lo = (lo >> one) | (hi << t31)
    new_hi = (hi >> one) | (lo << t31)
    return new_lo, new_hi


def complement_negative(lo, hi, xp=np):
    sign = (hi >> _c(xp, 31)) != 0
    lo2 = xp.where(sign, lo ^ _c(xp, 0xFFFFFFFF), lo)
    hi2 = xp.where(sign, hi ^ _c(xp, 0x7FFFFFFF), hi)
    return lo2, hi2


def cumsum(lo, hi, axis, xp=np):
    """Wrapping 64-bit cumulative sum along ``axis`` over pair planes."""
    if xp is np:
        w = join(lo, hi)
        w = np.cumsum(w, axis=axis, dtype=np.uint64)
        return split(w)
    import jax

    def combine(a, b):
        lo_, hi_ = add(a[0], a[1], b[0], b[1], xp)
        return (lo_, hi_)

    lo_out, hi_out = jax.lax.associative_scan(combine, (lo, hi), axis=axis)
    return lo_out, hi_out


def is_nonzero(lo, hi, xp=np):
    return (lo | hi) != 0
