"""Pure-XLA (jax.numpy) implementation of the ndzip codec.

Everything is jit-compiled with static shapes: the grid of hypercubes is
processed as one batched tensor program (blocks are independent, reference
§parallelism: cpu_codec.inl:700-887, cuda_codec.inl:401-428), zero-word
compaction is a masked prefix-sum + scatter, and the offset table is a
``cumsum`` (the XLA analog of the reference's hierarchical_inclusive_scan,
cuda_bits.cuh:266-333).

float64 never touches 64-bit integers on device: every 64-bit word is a
(lo, hi) uint32 pair (ops/u64pair.py), and the 64x64 bit transpose is four
32x32 transposes (ops/bitops.py::transpose_bits_pair32), mirroring the
reference's 32-bit-register formulation (cuda_codec.inl:236-264).

Device-level entry points (jitted, device in/out, padded static shapes):
  * ``encode_fn(shape, word_bits)``  -> fn(words...) -> (stream_padded, length_u32)
  * ``decode_fn(shape, word_bits)``  -> fn(stream_padded) -> words...
Host-level convenience: ``compress`` / ``decompress`` (numpy in/out).
"""

from __future__ import annotations

import functools

import jax
import jax.numpy as jnp
import numpy as np

from . import format as fmt
from .ops import bitops, u64pair
from .utils import enable_compilation_cache

enable_compilation_cache()

# ------------------------------------------------------------------ geometry


def _grid_info(shape):
    dims = len(shape)
    side = fmt.SIDE_LENGTH[dims]
    grid = fmt.grid_shape(shape)
    nb = int(np.prod(grid)) if dims else 0
    return dims, side, grid, nb


def _border_indices(shape) -> np.ndarray:
    """Flat element indices of border elements, in stream order (static)."""
    slices = fmt.border_slices(shape)
    if not slices:
        return np.zeros(0, dtype=np.int64)
    return np.concatenate(
        [np.arange(off, off + cnt, dtype=np.int64) for off, cnt in slices])


def _cat_parts(parts, dtype):
    if not parts:
        return jnp.zeros(0, dtype)
    return parts[0] if len(parts) == 1 else jnp.concatenate(parts)


def _border_take(words, shape):
    """Border values of the shaped array ``words`` in stream order
    (common.hh:245-282), as at most ``dims`` static-slice box copies
    instead of an element-granularity gather.

    border_slices' recursion visits, per leading index p, the innermost
    bordered axis' runs first and the next axis' run after, so the border
    decomposes into at most ``dims`` axis-aligned boxes whose values
    interleave regularly per p."""
    dims = len(shape)
    side = fmt.SIDE_LENGTH[dims]
    if any(s < side for s in shape):
        return words.reshape(-1)            # whole array is border
    b = tuple(s // side * side for s in shape)
    if dims == 1:
        return words[b[0]:]
    if dims == 2:
        (s0, s1), (b0, b1) = shape, b
        parts = []
        if b1 < s1:
            parts.append(words[:b0, b1:].reshape(-1))
        if b0 < s0:
            parts.append(words[b0:, :].reshape(-1))
        return _cat_parts(parts, words.dtype)
    (s0, s1, s2), (b0, b1, b2) = shape, b
    parts_p = []                            # per-p interleaved segments
    if b2 < s2:
        parts_p.append(words[:b0, :b1, b2:].reshape(b0, -1))
    if b1 < s1:
        parts_p.append(words[:b0, b1:, :].reshape(b0, -1))
    parts = []
    if parts_p:
        pp = (parts_p[0] if len(parts_p) == 1
              else jnp.concatenate(parts_p, axis=1))
        parts.append(pp.reshape(-1))
    if b0 < s0:
        parts.append(words[b0:].reshape(-1))
    return _cat_parts(parts, words.dtype)


def _border_place(arr, bv, shape):
    """Inverse of _border_take: place the stream-order border vector ``bv``
    into the shaped array ``arr`` with at most ``dims`` static-origin
    dynamic_update_slices instead of an N-D point scatter."""
    dims = len(shape)
    side = fmt.SIDE_LENGTH[dims]
    if any(s < side for s in shape):
        return bv.reshape(shape)
    b = tuple(s // side * side for s in shape)
    if dims == 1:
        if b[0] == shape[0]:
            return arr
        return jax.lax.dynamic_update_slice(arr, bv, (b[0],))
    if dims == 2:
        (s0, s1), (b0, b1) = shape, b
        pos = 0
        if b1 < s1:
            w = s1 - b1
            arr = jax.lax.dynamic_update_slice(
                arr, bv[: b0 * w].reshape(b0, w), (0, b1))
            pos = b0 * w
        if b0 < s0:
            arr = jax.lax.dynamic_update_slice(
                arr, bv[pos:].reshape(s0 - b0, s1), (b0, 0))
        return arr
    (s0, s1, s2), (b0, b1, b2) = shape, b
    wA = b1 * (s2 - b2)
    wB = (s1 - b1) * s2
    per_p = wA + wB
    pos = b0 * per_p
    if per_p:
        V = bv[:pos].reshape(b0, per_p)
        if wA:
            arr = jax.lax.dynamic_update_slice(
                arr, V[:, :wA].reshape(b0, b1, s2 - b2), (0, 0, b2))
        if wB:
            arr = jax.lax.dynamic_update_slice(
                arr, V[:, wA:].reshape(b0, s1 - b1, s2), (0, b1, 0))
    if b0 < s0:
        arr = jax.lax.dynamic_update_slice(
            arr, bv[pos:].reshape(s0 - b0, s1, s2), (b0, 0, 0))
    return arr


def _gather_blocks(words, shape):
    """(full shape) -> (nb, 4096) in canonical block order; pure reshapes."""
    dims, side, grid, nb = _grid_info(shape)
    interior = words[tuple(slice(0, g * side) for g in grid)]
    split_shape = tuple(x for g in grid for x in (g, side))
    arr = interior.reshape(split_shape)
    perm = tuple(range(0, 2 * dims, 2)) + tuple(range(1, 2 * dims, 2))
    return arr.transpose(perm).reshape(nb, fmt.HC_SIZE)


def _scatter_blocks(blocks, shape, flat_words):
    """Write decoded blocks into flat_words (1D, full size); returns updated."""
    dims, side, grid, nb = _grid_info(shape)
    arr = blocks.reshape(grid + (side,) * dims)
    inv_perm = []
    for d in range(dims):
        inv_perm += [d, dims + d]
    interior = arr.transpose(inv_perm).reshape(tuple(g * side for g in grid))
    full = flat_words.reshape(shape)
    full = full.at[tuple(slice(0, g * side) for g in grid)].set(interior)
    return full.reshape(-1)


# ------------------------------------------------------------------ transform


def _diff_axis(x, ax):
    n = x.shape[ax]
    head = jax.lax.slice_in_dim(x, 0, 1, axis=ax)
    a = jax.lax.slice_in_dim(x, 1, n, axis=ax)
    b = jax.lax.slice_in_dim(x, 0, n - 1, axis=ax)
    return jnp.concatenate([head, a - b], axis=ax)


def _diff_axis_pair(lo, hi, ax):
    n = lo.shape[ax]
    sl = lambda v, s, e: jax.lax.slice_in_dim(v, s, e, axis=ax)
    d_lo, d_hi = u64pair.sub(sl(lo, 1, n), sl(hi, 1, n), sl(lo, 0, n - 1), sl(hi, 0, n - 1), jnp)
    return (
        jnp.concatenate([sl(lo, 0, 1), d_lo], axis=ax),
        jnp.concatenate([sl(hi, 0, 1), d_hi], axis=ax),
    )


def block_transform_u32(blocks, dims):
    side = fmt.SIDE_LENGTH[dims]
    x = bitops.rotate_left_1(blocks, jnp)
    x = x.reshape((-1,) + (side,) * dims)
    for axis in fmt.FORWARD_AXIS_ORDER[dims]:
        x = _diff_axis(x, axis + 1)
    x = x.reshape(-1, fmt.HC_SIZE)
    return bitops.complement_negative(x, jnp)


def inverse_block_transform_u32(blocks, dims):
    side = fmt.SIDE_LENGTH[dims]
    x = bitops.complement_negative(blocks, jnp)
    x = x.reshape((-1,) + (side,) * dims)
    for axis in reversed(fmt.FORWARD_AXIS_ORDER[dims]):
        x = jnp.cumsum(x, axis=axis + 1, dtype=x.dtype)
    x = x.reshape(-1, fmt.HC_SIZE)
    return bitops.rotate_right_1(x, jnp)


def block_transform_pair(lo, hi, dims):
    side = fmt.SIDE_LENGTH[dims]
    lo, hi = u64pair.rotl1(lo, hi, jnp)
    lo = lo.reshape((-1,) + (side,) * dims)
    hi = hi.reshape((-1,) + (side,) * dims)
    for axis in fmt.FORWARD_AXIS_ORDER[dims]:
        lo, hi = _diff_axis_pair(lo, hi, axis + 1)
    lo = lo.reshape(-1, fmt.HC_SIZE)
    hi = hi.reshape(-1, fmt.HC_SIZE)
    return u64pair.complement_negative(lo, hi, jnp)


def inverse_block_transform_pair(lo, hi, dims):
    side = fmt.SIDE_LENGTH[dims]
    lo, hi = u64pair.complement_negative(lo, hi, jnp)
    lo = lo.reshape((-1,) + (side,) * dims)
    hi = hi.reshape((-1,) + (side,) * dims)
    for axis in reversed(fmt.FORWARD_AXIS_ORDER[dims]):
        lo, hi = u64pair.cumsum(lo, hi, axis + 1, jnp)
    lo = lo.reshape(-1, fmt.HC_SIZE)
    hi = hi.reshape(-1, fmt.HC_SIZE)
    return u64pair.rotr1(lo, hi, jnp)


def _or_reduce(x, axis):
    return jax.lax.reduce(x, x.dtype.type(0), jax.lax.bitwise_or, (axis,))


# ------------------------------------------------------------------ encode


def _encode_fp32(words, shape):
    words = jax.lax.bitcast_convert_type(words, jnp.uint32)  # float32 or uint32
    dims, side, grid, nb = _grid_info(shape)
    num_hc = nb
    header_u32 = fmt.header_u32_words(num_hc, 32)
    bound = fmt.compressed_bound_u32(shape, 32)
    border_idx = _border_indices(shape)
    flat_in = words.reshape(-1)

    out = jnp.zeros(bound, dtype=jnp.uint32)
    body_total = jnp.int32(0)

    if num_hc:
        blocks = _gather_blocks(words, shape)
        t = block_transform_u32(blocks, dims)
        chunks = t.reshape(nb, fmt.HC_SIZE // 32, 32)
        heads = _or_reduce(chunks, 2)
        transposed = bitops.transpose_bits(chunks, jnp)
        body = transposed.reshape(nb, fmt.HC_SIZE)
        dense = jnp.concatenate([heads, body], axis=1)
        valid = jnp.concatenate(
            [jnp.ones(heads.shape, dtype=bool), body != 0], axis=1)
        lengths = valid.sum(axis=1, dtype=jnp.int32)
        offsets_after = jnp.cumsum(lengths, dtype=jnp.int32)
        body_total = offsets_after[-1]

        out = out.at[:num_hc].set(offsets_after.astype(jnp.uint32))
        flat = dense.reshape(-1)
        fvalid = valid.reshape(-1)
        dest = jnp.cumsum(fvalid.astype(jnp.int32)) - 1 + header_u32
        dest = jnp.where(fvalid, dest, bound)
        out = out.at[dest].set(flat, mode="drop", unique_indices=True)

    if border_idx.size:
        border_vals = flat_in[jnp.asarray(border_idx)]
        out = jax.lax.dynamic_update_slice(out, border_vals, (header_u32 + body_total,))

    length_u32 = header_u32 + body_total + border_idx.size
    return out, length_u32


def _encode_fp64(lo, hi, shape):
    dims, side, grid, nb = _grid_info(shape)
    num_hc = nb
    header_u32 = fmt.header_u32_words(num_hc, 64)
    bound = fmt.compressed_bound_u32(shape, 64)
    border_idx = _border_indices(shape)
    heads_n = fmt.HC_SIZE // 64

    out = jnp.zeros(bound, dtype=jnp.uint32)
    body_total = jnp.int32(0)  # in u64 words

    if num_hc:
        b_lo = _gather_blocks(lo, shape)
        b_hi = _gather_blocks(hi, shape)
        t_lo, t_hi = block_transform_pair(b_lo, b_hi, dims)
        c_lo = t_lo.reshape(nb, heads_n, 64)
        c_hi = t_hi.reshape(nb, heads_n, 64)
        heads_lo = _or_reduce(c_lo, 2)
        heads_hi = _or_reduce(c_hi, 2)
        tt_hi, tt_lo = bitops.transpose_bits_pair32(c_hi, c_lo, jnp)
        body_lo = tt_lo.reshape(nb, fmt.HC_SIZE)
        body_hi = tt_hi.reshape(nb, fmt.HC_SIZE)
        dense_lo = jnp.concatenate([heads_lo, body_lo], axis=1)
        dense_hi = jnp.concatenate([heads_hi, body_hi], axis=1)
        valid = jnp.concatenate(
            [jnp.ones((nb, heads_n), dtype=bool), (body_lo | body_hi) != 0], axis=1)
        lengths = valid.sum(axis=1, dtype=jnp.int32)
        offsets_after = jnp.cumsum(lengths, dtype=jnp.int32)
        body_total = offsets_after[-1]

        out = out.at[:num_hc].set(offsets_after.astype(jnp.uint32))
        # interleave (lo, hi) pairs into u32 stream positions
        flat = jnp.stack([dense_lo, dense_hi], axis=-1).reshape(-1)
        fvalid = jnp.repeat(valid.reshape(-1), 2)
        word_dest = jnp.cumsum(valid.reshape(-1).astype(jnp.int32)) - 1
        dest_u32 = header_u32 + 2 * jnp.repeat(word_dest, 2) + jnp.tile(
            jnp.arange(2, dtype=jnp.int32), word_dest.shape[0])
        dest_u32 = jnp.where(fvalid, dest_u32, bound)
        out = out.at[dest_u32].set(flat, mode="drop", unique_indices=True)

    if border_idx.size:
        bi = jnp.asarray(border_idx)
        border_vals = jnp.stack(
            [lo.reshape(-1)[bi], hi.reshape(-1)[bi]], axis=-1).reshape(-1)
        out = jax.lax.dynamic_update_slice(
            out, border_vals, (header_u32 + 2 * body_total,))

    length_u32 = header_u32 + 2 * body_total + 2 * border_idx.size
    return out, length_u32


# ------------------------------------------------------------------ decode


def _decode_fp32(stream, shape):
    dims, side, grid, nb = _grid_info(shape)
    num_hc = nb
    header_u32 = fmt.header_u32_words(num_hc, 32)
    bound = fmt.compressed_bound_u32(shape, 32)
    border_idx = _border_indices(shape)
    total = int(np.prod(shape))
    heads_n = fmt.HC_SIZE // 32
    win = heads_n + fmt.HC_SIZE

    flat = jnp.zeros(total, dtype=jnp.uint32)
    body_total = jnp.int32(0)

    if num_hc:
        offsets = jax.lax.bitcast_convert_type(stream[:num_hc], jnp.int32)
        starts = jnp.concatenate([jnp.zeros(1, jnp.int32), offsets[:-1]])
        body_total = offsets[-1]
        idx = header_u32 + starts[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]
        idx = jnp.minimum(idx, bound - 1)
        windows = stream[idx]

        heads = windows[:, :heads_n]
        shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
        present = ((heads[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)).astype(jnp.int32)
        ranks = jnp.cumsum(present, axis=2) - present
        counts = present.sum(axis=2)
        chunk_starts = heads_n + jnp.cumsum(counts, axis=1) - counts
        src = chunk_starts[:, :, None] + ranks
        gathered = jnp.take_along_axis(windows, src.reshape(num_hc, -1), axis=1)
        transposed = jnp.where(
            present.astype(bool), gathered.reshape(num_hc, heads_n, 32), jnp.uint32(0))
        chunks = bitops.transpose_bits(transposed, jnp)
        blocks = inverse_block_transform_u32(chunks.reshape(num_hc, fmt.HC_SIZE), dims)
        flat = _scatter_blocks(blocks, shape, flat)

    if border_idx.size:
        border_vals = jax.lax.dynamic_slice(
            stream, (header_u32 + body_total,), (border_idx.size,))
        flat = flat.at[jnp.asarray(border_idx)].set(border_vals)

    return flat.reshape(shape)


def _decode_fp64(stream, shape):
    dims, side, grid, nb = _grid_info(shape)
    num_hc = nb
    header_u32 = fmt.header_u32_words(num_hc, 64)
    bound = fmt.compressed_bound_u32(shape, 64)
    border_idx = _border_indices(shape)
    total = int(np.prod(shape))
    heads_n = fmt.HC_SIZE // 64
    win = heads_n + fmt.HC_SIZE  # in u64 words

    flat_lo = jnp.zeros(total, dtype=jnp.uint32)
    flat_hi = jnp.zeros(total, dtype=jnp.uint32)
    body_total = jnp.int32(0)  # u64 words

    if num_hc:
        offsets = jax.lax.bitcast_convert_type(stream[:num_hc], jnp.int32)
        starts = jnp.concatenate([jnp.zeros(1, jnp.int32), offsets[:-1]])
        body_total = offsets[-1]
        widx = starts[:, None] + jnp.arange(win, dtype=jnp.int32)[None, :]
        lo_idx = jnp.minimum(header_u32 + 2 * widx, bound - 1)
        win_lo = stream[lo_idx]
        win_hi = stream[jnp.minimum(lo_idx + 1, bound - 1)]

        heads_lo = win_lo[:, :heads_n]
        heads_hi = win_hi[:, :heads_n]
        shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
        bits_hi = ((heads_hi[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1))
        bits_lo = ((heads_lo[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1))
        # present[i] for word i of chunk: i<32 from hi plane, i>=32 from lo
        present = jnp.concatenate([bits_hi, bits_lo], axis=2).astype(jnp.int32)
        ranks = jnp.cumsum(present, axis=2) - present
        counts = present.sum(axis=2)
        chunk_starts = heads_n + jnp.cumsum(counts, axis=1) - counts
        src = (chunk_starts[:, :, None] + ranks).reshape(num_hc, -1)
        g_lo = jnp.take_along_axis(win_lo, src, axis=1).reshape(num_hc, heads_n, 64)
        g_hi = jnp.take_along_axis(win_hi, src, axis=1).reshape(num_hc, heads_n, 64)
        pb = present.astype(bool).reshape(num_hc, heads_n, 64)
        tt_lo = jnp.where(pb, g_lo, jnp.uint32(0))
        tt_hi = jnp.where(pb, g_hi, jnp.uint32(0))
        c_hi, c_lo = bitops.transpose_bits_pair32(tt_hi, tt_lo, jnp)
        b_lo, b_hi = inverse_block_transform_pair(
            c_lo.reshape(num_hc, fmt.HC_SIZE), c_hi.reshape(num_hc, fmt.HC_SIZE), dims)
        flat_lo = _scatter_blocks(b_lo, shape, flat_lo)
        flat_hi = _scatter_blocks(b_hi, shape, flat_hi)

    if border_idx.size:
        border_vals = jax.lax.dynamic_slice(
            stream, (header_u32 + 2 * body_total,), (2 * border_idx.size,))
        pairs = border_vals.reshape(-1, 2)
        bi = jnp.asarray(border_idx)
        flat_lo = flat_lo.at[bi].set(pairs[:, 0])
        flat_hi = flat_hi.at[bi].set(pairs[:, 1])

    return flat_lo.reshape(shape), flat_hi.reshape(shape)


# ------------------------------------------------------------------ jit entry


@functools.lru_cache(maxsize=None)
def encode_fn(shape: tuple, word_bits: int):
    """Jitted device encoder for a fixed shape.

    word_bits=32: fn(words) -> (stream_padded_u32, length_u32), where
                  words is a float32 or uint32 array of ``shape``
    word_bits=64: fn(lo_u32, hi_u32) -> (stream_padded_u32, length_u32)

    The stream buffer holds ``format.compressed_bound_u32(shape, word_bits)``
    words, which is what ``decode_fn`` takes; ``length_u32`` is an int32
    scalar counting the occupied u32 words.
    """
    if word_bits == 32:
        return jax.jit(lambda w: _encode_fp32(w, shape))
    return jax.jit(lambda lo, hi: _encode_fp64(lo, hi, shape))


@functools.lru_cache(maxsize=None)
def decode_fn(shape: tuple, word_bits: int):
    """Jitted device decoder: fn(stream_padded_u32) -> words (u32) or (lo, hi).

    The stream holds at least ``format.compressed_bound_u32(shape,
    word_bits)`` words (see ``pad_stream``); the words past its length are
    never read into the output."""
    if word_bits == 32:
        return jax.jit(lambda s: _decode_fp32(s, shape))
    return jax.jit(lambda s: _decode_fp64(s, shape))


@functools.partial(jax.jit, static_argnums=1)
def _pad_stream(stream, size):
    return jnp.concatenate([stream, jnp.zeros(size - stream.shape[0], jnp.uint32)])


def pad_stream(stream, shape, word_bits):
    """Zero-pad a device stream shorter than the decoder's bound, on the
    device; longer streams pass through unchanged."""
    bound = fmt.compressed_bound_u32(tuple(shape), word_bits)
    if stream.shape[0] >= bound:
        return stream
    return _pad_stream(stream, bound)


# ------------------------------------------------------------------ host API


def compress(data: np.ndarray) -> tuple[np.ndarray, int]:
    """numpy in/out convenience wrapper; returns (uint32 stream, words)."""
    data = np.ascontiguousarray(data)
    fmt.validate_shape(data.shape)
    wb = fmt.word_bits_for_dtype(data.dtype)
    shape = data.shape
    if wb == 32:
        words = jnp.asarray(data.view(np.uint32))
        padded, length = encode_fn(shape, 32)(words)
    else:
        lo, hi = u64pair.split(data.view(np.uint64))
        padded, length = encode_fn(shape, 64)(jnp.asarray(lo), jnp.asarray(hi))
    length = int(length)
    stream = np.asarray(padded[:length])
    return stream, length * 32 // wb


def decompress(stream: np.ndarray, shape, dtype) -> np.ndarray:
    shape = tuple(shape)
    fmt.validate_shape(shape)
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    bound = fmt.compressed_bound_u32(shape, wb)
    padded = np.zeros(bound, dtype=np.uint32)
    padded[: stream.size] = stream
    if wb == 32:
        words = decode_fn(shape, 32)(jnp.asarray(padded))
        return np.asarray(words).view(dtype)
    lo, hi = decode_fn(shape, 64)(jnp.asarray(padded))
    return u64pair.join(np.asarray(lo), np.asarray(hi)).view(dtype)
