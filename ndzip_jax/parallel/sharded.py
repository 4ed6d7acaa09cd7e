"""Multi-device block-parallel encode/decode over a jax.sharding.Mesh.

The reference is single-device (SURVEY.md §2.12); this layer is the
distributed design it lacks:

* Hypercube blocks are independent, so the block-grid's major axis is
  sharded across devices (``shard_map`` over a 1D mesh).  Shards own
  contiguous block ranges, so the canonical stream order is preserved.
* Each shard encodes its blocks locally (the same block codec as the
  single-device path) and returns (header entries, padded body).
* Per-shard body lengths are all-gathered (one tiny collective — the
  distributed analog of the reference's device-wide offset scan,
  cuda_bits.cuh:266-333); an exclusive scan gives each shard's global body
  offset; header entries are rebased by that offset.
* Assembly into ONE bit-exact stream happens on the devices with a
  ppermute ring (each device keeps one slab of the stream), or shard by
  shard on the host for file output.

Borders are global-array property and tiny; they are gathered outside the
shard_map.  The resulting stream is byte-identical to the single-device /
reference CPU stream.
"""

from __future__ import annotations

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from .. import codec_xla, format as fmt
from ..ops import bitops, u64pair

AXIS = "blocks"


def make_mesh(devices=None, axis_name: str = AXIS) -> Mesh:
    devices = jax.devices() if devices is None else devices
    return Mesh(np.asarray(devices), (axis_name,))


def _shard_grid(shape, n_shards):
    """Split the block-grid's major axis into n_shards contiguous
    block-row ranges.  When grid[0] is not divisible by n_shards the
    trailing shard(s) are padded with zero blocks so every shard presents
    the same local shape to ``shard_map`` (the reference handles arbitrary
    1-3D extents on every backend, common.hh:245-317; padding keeps that
    property for the distributed layer — padded blocks' header entries and
    body words are dropped at assembly).

    Returns (per_shard, rows_pb, real) where per_shard is padded blocks
    per shard, rows_pb is padded block-rows per shard and real[k] is the
    number of real (non-pad) blocks shard k owns."""
    grid = fmt.grid_shape(shape)
    num_hc = fmt.num_hypercubes(shape)
    if not grid or num_hc == 0:
        raise ValueError(
            f"shape {shape} has no whole hypercube blocks to shard; "
            "all-border grids must use a single-device codec")
    rows_pb = -(-grid[0] // n_shards)
    blocks_per_row = num_hc // grid[0]
    per_shard = rows_pb * blocks_per_row
    real = [max(0, min(grid[0] - k * rows_pb, rows_pb)) * blocks_per_row
            for k in range(n_shards)]
    return per_shard, rows_pb, real


def _pad_block_rows(w, pad_rows):
    """Append pad_rows zero rows along axis 0 (zero-padded trailing shard
    blocks for uneven grids; used by both parallel layers)."""
    if pad_rows == 0:
        return w
    return np.concatenate(
        [w, np.zeros((pad_rows,) + w.shape[1:], w.dtype)], axis=0)


def _masked_span_copy(dst, dst_base, src, src_base, src_len):
    """Copy the overlap of the global word span [src_base, src_base+src_len)
    (whose values are ``src``) into ``dst``, which represents the global span
    [dst_base, dst_base+len(dst)).  Both bases may be traced scalars; the
    copy is a shifted dynamic_slice + select, so it stays O(len(dst)+len(src))
    with no data-dependent shapes — the building block of the ppermute-ring
    stream assembly (each device only ever materializes its own slab and one
    in-flight shard buffer, never the whole stream)."""
    S = dst.shape[0]
    L = src.shape[0]
    shift = jnp.clip(dst_base - src_base, -S, L).astype(jnp.int32)
    padded = jnp.concatenate(
        [jnp.zeros(S, src.dtype), src, jnp.zeros(S, src.dtype)])
    vals = jax.lax.dynamic_slice(padded, (S + shift,), (S,))
    pos = jnp.arange(S, dtype=jnp.int32) + dst_base
    mask = (pos >= src_base) & (pos < src_base + src_len)
    return jnp.where(mask, vals, dst)


def _ring_shift(x, axis, n):
    """One ring step: every device passes ``x`` to its successor."""
    return jax.lax.ppermute(x, axis, [(i, (i + 1) % n) for i in range(n)])


def _local_encode_parts(words_local, local_shape, dims, wb):
    """Encode one shard's blocks; returns (entries u32 (local_hc,),
    body_padded u32, body_len i32).  Body contains only hypercube bodies
    (no header, no border)."""
    local_hc = fmt.num_hypercubes(local_shape)
    if wb == 32:
        blocks = codec_xla._gather_blocks(words_local, local_shape)
        dense, valid, lengths = _encode_blocks_xla32(blocks, dims)
    else:
        lo, hi = words_local
        b_lo = codec_xla._gather_blocks(lo, local_shape)
        b_hi = codec_xla._gather_blocks(hi, local_shape)
        dense, valid, lengths = _encode_blocks_xla64(b_lo, b_hi, dims)
    offsets_after = jnp.cumsum(lengths, dtype=jnp.int32)
    body_len = offsets_after[-1]

    bound = local_hc * fmt.Profile(wb, dims).compressed_block_length_bound
    bound_u32 = bound * (wb // 32)
    flat = dense.reshape(-1)
    fvalid = valid.reshape(-1)
    dest = jnp.cumsum(fvalid.astype(jnp.int32)) - 1
    if wb == 64:
        dest = 2 * jnp.repeat(dest, 2) + jnp.tile(
            jnp.arange(2, dtype=jnp.int32), dest.shape[0])
        fvalid = jnp.repeat(fvalid, 2)
        flat = dense.reshape(-1)  # (lo, hi) pairs interleaved by the caller
    dest = jnp.where(fvalid, dest, bound_u32)
    body = jnp.zeros(bound_u32, jnp.uint32).at[dest].set(
        flat, mode="drop", unique_indices=True)
    return offsets_after.astype(jnp.uint32), body, body_len * (wb // 32)


def _encode_blocks_xla32(blocks, dims):
    nb = blocks.shape[0]
    t = codec_xla.block_transform_u32(blocks, dims)
    chunks = t.reshape(nb, fmt.HC_SIZE // 32, 32)
    heads = jax.lax.reduce(chunks, jnp.uint32(0), jax.lax.bitwise_or, (2,))
    transposed = bitops.transpose_bits(chunks, jnp)
    body = transposed.reshape(nb, fmt.HC_SIZE)
    dense = jnp.concatenate([heads, body], axis=1)
    valid = jnp.concatenate([jnp.ones(heads.shape, bool), body != 0], axis=1)
    lengths = valid.sum(axis=1, dtype=jnp.int32)
    return dense, valid, lengths


def _encode_blocks_xla64(b_lo, b_hi, dims):
    nb = b_lo.shape[0]
    heads_n = fmt.HC_SIZE // 64
    t_lo, t_hi = codec_xla.block_transform_pair(b_lo, b_hi, dims)
    c_lo = t_lo.reshape(nb, heads_n, 64)
    c_hi = t_hi.reshape(nb, heads_n, 64)
    heads_lo = jax.lax.reduce(c_lo, jnp.uint32(0), jax.lax.bitwise_or, (2,))
    heads_hi = jax.lax.reduce(c_hi, jnp.uint32(0), jax.lax.bitwise_or, (2,))
    tt_hi, tt_lo = bitops.transpose_bits_pair32(c_hi, c_lo, jnp)
    body_lo = tt_lo.reshape(nb, fmt.HC_SIZE)
    body_hi = tt_hi.reshape(nb, fmt.HC_SIZE)
    dense_lo = jnp.concatenate([heads_lo, body_lo], axis=1)
    dense_hi = jnp.concatenate([heads_hi, body_hi], axis=1)
    valid = jnp.concatenate(
        [jnp.ones((nb, heads_n), bool), (body_lo | body_hi) != 0], axis=1)
    lengths = valid.sum(axis=1, dtype=jnp.int32)
    dense = jnp.stack([dense_lo, dense_hi], axis=-1)  # interleaved pairs
    return dense, valid, lengths


def compress_sharded(data, mesh: Mesh):
    """Compress a numpy/JAX array block-parallel over ``mesh``; returns
    (stream uint32 np.ndarray, length_words).  Bit-identical to the serial
    stream."""
    from jax import shard_map

    data = np.ascontiguousarray(data) if isinstance(data, np.ndarray) else data
    shape = tuple(data.shape)
    fmt.validate_shape(shape)
    dtype = np.dtype(data.dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    dims = len(shape)
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    num_hc = fmt.num_hypercubes(shape)
    per_shard, rows_pb, real = _shard_grid(shape, n)
    side = fmt.SIDE_LENGTH[dims]
    grid = fmt.grid_shape(shape)
    rows_per_shard = rows_pb * side
    pad_rows = rows_pb * n * side - grid[0] * side  # zero block-rows appended

    # interior region, sharded along axis 0; borders handled globally
    interior = tuple(slice(0, g * side) for g in grid)
    local_shape = (rows_per_shard,) + tuple(g * side for g in grid[1:])
    bound_local_u32 = per_shard * fmt.Profile(wb, dims).compressed_block_length_bound * (wb // 32)

    shard_fn = _encode_shard_fn(local_shape, dims, wb)

    if dtype == np.float32:
        host_words = (_pad_block_rows(
            np.ascontiguousarray(data).view(np.uint32)[interior], pad_rows),)
    else:
        w64 = np.ascontiguousarray(data).view(np.uint64)[interior]
        lo, hi = u64pair.split(np.ascontiguousarray(w64))
        host_words = (_pad_block_rows(lo, pad_rows),
                      _pad_block_rows(hi, pad_rows))

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(tuple(P(axis) for _ in host_words),),
        out_specs=(P(axis), P(axis)))

    sharded_in = tuple(
        jax.device_put(w, NamedSharding(mesh, P(axis))) for w in host_words)
    entries, bodies = jax.jit(mapped)(sharded_in)

    # global assembly (host side — the stream is a host artifact).  Padded
    # blocks sit after each shard's real blocks, so dropping them is a
    # truncation: take real[k] header entries and the body words up to the
    # last real block's cumulative offset.
    entries = np.asarray(entries).reshape(n, per_shard)
    bodies = np.asarray(bodies).reshape(n, bound_local_u32)

    word_u32 = wb // 32
    real_wlens = np.asarray(
        [int(entries[k][real[k] - 1]) if real[k] else 0 for k in range(n)],
        np.int64)
    shard_word_offsets = np.concatenate([[0], np.cumsum(real_wlens)[:-1]])
    header = np.concatenate(
        [entries[k][: real[k]] + np.uint32(shard_word_offsets[k])
         for k in range(n) if real[k]])

    header_u32 = fmt.header_u32_words(num_hc, wb)
    parts = [np.zeros(header_u32, np.uint32)]
    parts[0][:num_hc] = header
    for k in range(n):
        parts.append(bodies[k][: real_wlens[k] * word_u32])
    flat = (np.ascontiguousarray(data).view(
        np.uint32 if wb == 32 else np.uint64)).reshape(-1)
    for off, cnt in fmt.border_slices(shape):
        seg = np.ascontiguousarray(flat[off : off + cnt])
        parts.append(seg.view(np.uint32))
    stream = np.concatenate(parts)
    return stream, stream.size // word_u32


# --------------------------------------------------------------- shared cores
#
# The device-resident entry points are jitted per static configuration and
# memoized here — jax.jit caches by function identity, so rebuilding the
# closures each call would re-trace/re-compile every step of a serving loop.
_JIT_CACHE: dict = {}


def _mesh_key(mesh: Mesh):
    return (tuple(mesh.axis_names), tuple(d.id for d in mesh.devices.flat))


def _encode_shard_fn(local_shape, dims, wb):
    """Per-shard encode body shared by every sharded-compress flavor
    (host, device-resident, multihost)."""

    def shard_fn(words):
        if wb == 32:
            entries, body, _ = _local_encode_parts(
                words[0].reshape(local_shape), local_shape, dims, wb)
        else:
            entries, body, _ = _local_encode_parts(
                (words[0].reshape(local_shape), words[1].reshape(local_shape)),
                local_shape, dims, wb)
        return entries, body

    return shard_fn


def compress_sharded_device(data, mesh: Mesh):
    """Device-resident block-parallel compress: input, per-shard encode and
    stream assembly all stay on the mesh — the scale-out analog of
    ``api.compress_device`` (cuda.hh:10-41) for compressing an array a JAX
    program already holds sharded (e.g. before a transfer or a checkpoint
    write).

    ``data``: a float32/uint32 ``jax.Array`` (any sharding; resharded to
    the block axis under jit) or a ``(lo, hi)`` uint32 plane tuple for
    fp64 payloads (see ops/u64pair).

    Returns ``(stream, length)`` device arrays.  ``length`` counts
    **uint32 words** (the stream array's own unit, matching
    ``api.compress_device``; the host-path ``compress_sharded`` returns
    profile words — u64 counts for fp64).  ``stream[:length]`` is
    byte-identical to every other backend's output; words past ``length``
    are zero.  The jitted program is cached per (shape, dtype, mesh)."""
    if isinstance(data, tuple):
        lo, hi = data
        if lo.dtype != jnp.uint32 or hi.dtype != jnp.uint32:
            raise ValueError(
                "fp64 sharded device compress takes (lo, hi) uint32 planes")
        shape = tuple(lo.shape)
        wb = 64
        words_in = (lo, hi)
    else:
        shape = tuple(data.shape)
        if data.dtype == jnp.float32:
            data = jax.lax.bitcast_convert_type(data, jnp.uint32)
        elif data.dtype != jnp.uint32:
            raise ValueError(
                f"sharded device compress supports float32/uint32 arrays or "
                f"(lo, hi) uint32 plane tuples, got {data.dtype}")
        wb = 32
        words_in = (data,)
    fmt.validate_shape(shape)

    key = ("enc_dev", shape, wb, _mesh_key(mesh))
    run = _JIT_CACHE.get(key)
    if run is None:
        run = _build_compress_device_ring(shape, wb, mesh, len(words_in))
        _JIT_CACHE[key] = run
    return run(words_in)


def _build_compress_device_ring(shape, wb, mesh, nwords):
    """Device-resident sharded compress with O(shard)-per-device assembly.

    A dynamic_update_slice assembly would let GSPMD hold the whole output
    stream (and O(total) temps) on every device.  Here the output stream is
    born sharded: device d owns slab d of n equal slabs, and the per-shard
    bodies circulate once around the ring (``ppermute``, n-1 hops — the
    same traffic as a ring all-gather) while every device copies each
    passing body's overlap with its own slab.  Per-device footprint: one slab + one in-flight body
    bound + the (tiny) replicated header — never the full stream.  The
    distributed analog of the reference's offset-table random access
    guarantee that nobody materializes the whole stream at once
    (cuda_codec.inl:290-297)."""
    from jax import shard_map

    dims = len(shape)
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    num_hc = fmt.num_hypercubes(shape)
    per_shard, rows_pb, real = _shard_grid(shape, n)
    side = fmt.SIDE_LENGTH[dims]
    grid = fmt.grid_shape(shape)
    rows_per_shard = rows_pb * side
    pad_rows = rows_pb * n * side - grid[0] * side
    interior_shape = tuple(g * side for g in grid)
    local_shape = (rows_per_shard,) + interior_shape[1:]
    word_u32 = wb // 32
    header_u32 = fmt.header_u32_words(num_hc, wb)
    bound_u32 = fmt.compressed_bound_u32(shape, wb)
    bcnt = fmt.border_element_count(shape)
    bw = bcnt * word_u32
    # one slab per device; n*S covers the stream bound (header+bodies+border)
    S = -(-bound_u32 // (n * 128)) * 128
    real_arr = jnp.asarray(real, jnp.int32)

    def shard_fn(words, bv):
        if wb == 32:
            entries, body, _ = _local_encode_parts(
                words[0].reshape(local_shape), local_shape, dims, wb)
        else:
            entries, body, _ = _local_encode_parts(
                (words[0].reshape(local_shape), words[1].reshape(local_shape)),
                local_shape, dims, wb)
        my = jax.lax.axis_index(axis)
        rk = real_arr[my]
        wlen = jnp.where(  # this shard's real body length, profile words
            rk > 0,
            jax.lax.bitcast_convert_type(
                entries[jnp.clip(rk - 1, 0, per_shard - 1)], jnp.int32),
            jnp.int32(0))
        lens = jax.lax.all_gather(wlen, axis)          # (n,), tiny
        cum = jnp.cumsum(lens) - lens                  # exclusive offsets
        # header: all real entries rebased by their shard's global offset —
        # O(num_hc) replicated (~0.1% of the data), static shapes via real[]
        ents_all = jax.lax.all_gather(entries, axis)   # (n, per_shard)
        hdr = jnp.concatenate(
            [ents_all[k, : real[k]] + cum[k].astype(jnp.uint32)
             for k in range(n) if real[k]])
        if header_u32 > num_hc:
            hdr = jnp.concatenate(
                [hdr, jnp.zeros(header_u32 - num_hc, jnp.uint32)])
        total = cum[n - 1] + lens[n - 1]

        myA = my * S
        slab = jnp.zeros(S, jnp.uint32)
        slab = _masked_span_copy(slab, myA, hdr, jnp.int32(0), header_u32)

        def step(s, carry):
            slab, bj = carry
            j = (my - s) % n
            start = header_u32 + cum[j] * word_u32
            ln = lens[j] * word_u32
            slab = jax.lax.cond(
                (start < myA + S) & (start + ln > myA),
                lambda sl: _masked_span_copy(sl, myA, bj, start, ln),
                lambda sl: sl, slab)
            return slab, _ring_shift(bj, axis, n)

        slab, _ = jax.lax.fori_loop(0, n, step, (slab, body))
        if bcnt:
            slab = _masked_span_copy(
                slab, myA, bv, header_u32 + total * word_u32, bw)
        return slab, wlen[None]

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(tuple(P(axis) for _ in range(nwords)), P()),
        out_specs=(P(axis), P(axis)))
    sh = NamedSharding(mesh, P(axis))

    @jax.jit
    def run(words):
        ws = []
        for w in words:
            wi = jax.lax.slice(w, (0,) * dims, interior_shape)
            if pad_rows:
                wi = jnp.concatenate(
                    [wi, jnp.zeros((pad_rows,) + interior_shape[1:],
                                   jnp.uint32)], axis=0)
            ws.append(jax.lax.with_sharding_constraint(wi, sh))
        if bcnt:
            if wb == 32:
                bv = codec_xla._border_take(words[0], shape)
            else:
                bl = codec_xla._border_take(words[0], shape)
                bh = codec_xla._border_take(words[1], shape)
                bv = jnp.stack([bl, bh], axis=-1).reshape(-1)
        else:
            bv = jnp.zeros(1, jnp.uint32)
        slabs, wlens = mapped(tuple(ws), bv)
        total = wlens.reshape(-1).sum()
        length = header_u32 + total * word_u32 + bw
        return slabs.reshape(-1), length

    return run


def _decode_setup(shape, dtype, mesh):
    """Static decode configuration + the shard_map'ed per-shard decode
    (memoized per (shape, dtype, mesh)).  Returns a context namespace;
    ``ctx.jit_mapped(subs, starts)`` runs the decode on (n, bound_local)
    sub-streams and (n, per_shard) rebased starts."""
    from types import SimpleNamespace

    from jax import shard_map

    key = ("dec", tuple(shape), str(np.dtype(dtype)), _mesh_key(mesh))
    ctx = _JIT_CACHE.get(key)
    if ctx is not None:
        return ctx

    shape = tuple(shape)
    wb = fmt.word_bits_for_dtype(np.dtype(dtype))
    dims = len(shape)
    n = mesh.devices.size
    axis = mesh.axis_names[0]
    num_hc = fmt.num_hypercubes(shape)
    per_shard, rows_pb, real = _shard_grid(shape, n)
    side = fmt.SIDE_LENGTH[dims]
    grid = fmt.grid_shape(shape)
    rows_per_shard = rows_pb * side
    local_shape = (rows_per_shard,) + tuple(g * side for g in grid[1:])
    word_u32 = wb // 32
    header_u32 = fmt.header_u32_words(num_hc, wb)
    bound_local = (per_shard * fmt.Profile(wb, dims).compressed_block_length_bound
                   * word_u32)
    heads_n = fmt.HC_SIZE // wb
    win = heads_n + fmt.HC_SIZE  # words per block window

    def shard_fn(sub, starts_local):
        sub = sub.reshape(-1)
        starts_local = starts_local.reshape(-1)
        # decode each local block's window from the shard-local sub-stream
        if wb == 32:
            idx = starts_local[:, None] + jnp.arange(win, dtype=jnp.int32)
            idx = jnp.minimum(idx, bound_local - 1)
            blocks = _decode_windows_xla32(sub[idx], dims)
            words = codec_xla._scatter_blocks(
                blocks, local_shape, jnp.zeros(int(np.prod(local_shape)), jnp.uint32))
            return words.reshape(local_shape)
        widx = starts_local[:, None] + jnp.arange(win, dtype=jnp.int32)
        lo_idx = jnp.minimum(2 * widx, bound_local - 1)
        win_lo = sub[lo_idx]
        win_hi = sub[jnp.minimum(lo_idx + 1, bound_local - 1)]
        b_lo, b_hi = _decode_windows_xla64(win_lo, win_hi, dims)
        z = jnp.zeros(int(np.prod(local_shape)), jnp.uint32)
        lo = codec_xla._scatter_blocks(b_lo, local_shape, z)
        hi = codec_xla._scatter_blocks(b_hi, local_shape, z)
        return jnp.stack([lo.reshape(local_shape), hi.reshape(local_shape)], axis=-1)

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(P(axis), P(axis)),
        out_specs=P(axis))

    ctx = SimpleNamespace(
        shard_body=shard_fn,
        mapped=mapped, jit_mapped=jax.jit(mapped), wb=wb, dims=dims, n=n,
        num_hc=num_hc, per_shard=per_shard, real=real, grid=grid, side=side,
        rows_per_shard=rows_per_shard, word_u32=word_u32,
        header_u32=header_u32, bound_local=bound_local, sub_sh=NamedSharding(
            mesh, P(axis)))
    _JIT_CACHE[key] = ctx
    return ctx


def _decode_shards(stream, shape, dtype, mesh: Mesh):
    """Host-stream decode core: slice per-shard sub-streams on the host,
    run the shard_map decode, return (out_local, offsets, header_u32)
    where out_local is the global device array in padded-shard layout
    ((n*rows_per_shard,) + interior trailing dims [+ (2,) for fp64])."""
    shape = tuple(shape)
    stream = np.asarray(stream)
    num_hc = fmt.num_hypercubes(shape)
    offsets = stream[:num_hc].astype(np.int64)
    ctx = _decode_setup(shape, dtype, mesh)

    # per-shard sub-streams: shard k's body span rebased to word offset 0,
    # zero-padded to the static per-shard bound, plus rebased local start
    # offsets.  Padded blocks
    # (uneven grids) reuse the last real block's start; their decoded
    # output is dropped at assembly.
    subs = np.zeros((ctx.n, ctx.bound_local), np.uint32)
    starts_all = np.zeros((ctx.n, ctx.per_shard), np.int32)
    for k in range(ctx.n):
        rk = ctx.real[k]
        if rk == 0:
            continue
        lo = k * ctx.per_shard  # earlier shards are all full -> exact
        base = int(offsets[lo - 1]) if lo else 0
        end = int(offsets[lo + rk - 1])
        starts_all[k, 1:rk] = offsets[lo : lo + rk - 1] - base
        starts_all[k, rk:] = starts_all[k, rk - 1]
        span = (end - base) * ctx.word_u32
        subs[k, :span] = stream[ctx.header_u32 + base * ctx.word_u32
                                : ctx.header_u32 + end * ctx.word_u32]

    out_local = ctx.jit_mapped(
        jax.device_put(subs, ctx.sub_sh), jax.device_put(starts_all, ctx.sub_sh))
    return out_local, offsets, ctx.header_u32


def decompress_sharded(stream, shape, dtype, mesh: Mesh):
    """Block-parallel decode to a HOST array: each shard random-accesses
    ONLY its own block range.  The offset table (stream header) is sliced
    on the host into per-shard rebased sub-streams — the distributed
    analog of the reference's random block access via header offsets
    (cuda_codec.inl:290-297) — so every device holds O(its shard) of the
    compressed stream, never a replica of the whole."""
    shape = tuple(shape)
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    n = mesh.devices.size
    stream = np.asarray(stream)
    out_local, offsets, header_u32 = _decode_shards(stream, shape, dtype, mesh)

    num_hc = fmt.num_hypercubes(shape)
    _, rows_pb, _ = _shard_grid(shape, n)
    side = fmt.SIDE_LENGTH[len(shape)]
    grid = fmt.grid_shape(shape)
    rows_per_shard = rows_pb * side

    # assemble on host: interior (padded shard rows dropped) + border
    word_dt = np.uint32 if wb == 32 else np.uint64
    words = np.zeros(shape, dtype=word_dt)
    interior = tuple(slice(0, g * side) for g in grid)
    int_rows = grid[0] * side
    trailing = tuple(g * side for g in grid[1:])
    if wb == 32:
        words[interior] = np.asarray(out_local).reshape(
            (n * rows_per_shard,) + trailing)[:int_rows]
    else:
        pairs = np.asarray(out_local).reshape(
            (n * rows_per_shard,) + trailing + (2,))[:int_rows]
        words[interior] = u64pair.join(pairs[..., 0], pairs[..., 1])

    body_total = int(offsets[-1]) if num_hc else 0
    bpos = header_u32 + body_total * (wb // 32)
    flat = words.reshape(-1)
    for off, cnt in fmt.border_slices(shape):
        chunk = stream[bpos : bpos + cnt * (wb // 32)]
        flat[off : off + cnt] = np.ascontiguousarray(chunk).view(word_dt)
        bpos += cnt * (wb // 32)
    return flat.reshape(shape).view(dtype)


def decompress_sharded_device(stream, shape, dtype, mesh: Mesh):
    """Block-parallel decode whose OUTPUT STAYS ON THE MESH — the serving
    path: a consumer (e.g. a training step reading compressed checkpoint
    or dataset shards) gets a ``jax.Array`` sharded over ``mesh``'s axis
    with no host round-trip of the decoded bytes.

    When ``stream`` is a ``jax.Array`` the compressed payload stays on
    device too: it is split into slabs over the mesh, and every device
    reads the offset table and its own sub-stream from them under jit.
    numpy streams are sliced on the host as in ``decompress_sharded``.
    The jitted program is cached per (shape, dtype, mesh, stream length).

    Returns a uint32/float32 array of ``shape`` for 32-bit dtypes, or a
    ``(lo, hi)`` uint32 plane tuple for fp64 (join on host via ops.u64pair
    when needed)."""
    shape = tuple(shape)
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    num_hc = fmt.num_hypercubes(shape)
    ctx = _decode_setup(shape, dtype, mesh)

    if isinstance(stream, jax.Array):
        key = ("dec_dev", shape, str(dtype), _mesh_key(mesh),
               int(stream.shape[0]))
        run = _JIT_CACHE.get(key)
        if run is None:
            run = _build_decompress_device_ring(
                shape, dtype, mesh, ctx, int(stream.shape[0]))
            _JIT_CACHE[key] = run
        out = run(stream)
    else:
        stream = np.asarray(stream)
        out_local, offsets, header_u32 = _decode_shards(
            stream, shape, dtype, mesh)
        body_total = int(offsets[-1]) if num_hc else 0
        bpos = header_u32 + body_total * ctx.word_u32
        bcnt = fmt.border_element_count(shape)
        border_u32 = stream[bpos : bpos + bcnt * ctx.word_u32]
        akey = ("dec_asm", shape, str(dtype), _mesh_key(mesh))
        assemble = _JIT_CACHE.get(akey)
        if assemble is None:
            assemble = _build_assemble(shape, dtype, mesh, ctx)
            _JIT_CACHE[akey] = assemble
        out = assemble(out_local, jnp.asarray(border_u32))
    if wb == 32 and dtype == np.float32:
        out = jax.lax.bitcast_convert_type(out, jnp.float32)
    return out


def _build_assemble(shape, dtype, mesh, ctx):
    """Jitted device-side final assembly: padded-shard interior rows ->
    the true array shape, plus the (tiny) border scatter."""
    import functools

    dims = len(shape)
    wb = ctx.wb
    n = ctx.n
    axis = mesh.axis_names[0]
    int_rows = ctx.grid[0] * ctx.side
    trailing = tuple(g * ctx.side for g in ctx.grid[1:])
    bcnt = fmt.border_element_count(shape)

    # jit out_shardings need dim-0 divisibility; for ragged shapes let
    # GSPMD place the output (still mesh-distributed, partial last shard)
    jit_kw = {}
    if shape[0] % n == 0:
        out_sh = NamedSharding(mesh, P(axis))
        jit_kw["out_shardings"] = (out_sh, out_sh) if wb == 64 else out_sh

    @functools.partial(jax.jit, **jit_kw)
    def assemble(ol, bv):
        origin = (0,) * dims
        if wb == 32:
            interior = ol.reshape(
                (n * ctx.rows_per_shard,) + trailing)[:int_rows]
            full = jnp.zeros(shape, jnp.uint32)
            full = jax.lax.dynamic_update_slice(full, interior, origin)
            if bcnt:
                full = codec_xla._border_place(full, bv, shape)
            return full
        pairs = ol.reshape(
            (n * ctx.rows_per_shard,) + trailing + (2,))[:int_rows]
        flo = jax.lax.dynamic_update_slice(
            jnp.zeros(shape, jnp.uint32), pairs[..., 0], origin)
        fhi = jax.lax.dynamic_update_slice(
            jnp.zeros(shape, jnp.uint32), pairs[..., 1], origin)
        if bcnt:
            bp = bv.reshape(-1, 2)
            flo = codec_xla._border_place(flo, bp[:, 0], shape)
            fhi = codec_xla._border_place(fhi, bp[:, 1], shape)
        return flo, fhi

    return assemble


def _build_decompress_device_ring(shape, dtype, mesh, ctx, stream_len):
    """Device-stream sharded decode with O(shard)-per-device sub-stream
    extraction.

    Dynamic-slicing every shard's sub-stream from the full stream would
    make GSPMD materialize the stream on every device.  Here it stays in
    n equal slabs; the slabs circulate once around the ring and each
    device copies the overlap of each passing slab with its own needed
    span [its body offset, + bound_local) — so a device only ever holds
    one slab + its own sub-stream window.  Only the offset table
    (``num_hc`` words, ~0.1% of the data) is replicated.  Border words are
    recovered with one psum of each device's slab overlap with the border
    span."""
    from jax import shard_map

    dims = len(shape)
    wb = ctx.wb
    n = ctx.n
    axis = mesh.axis_names[0]
    num_hc = ctx.num_hc
    per_shard, real = ctx.per_shard, ctx.real
    word_u32, header_u32 = ctx.word_u32, ctx.header_u32
    bound_local = ctx.bound_local
    bcnt = fmt.border_element_count(shape)
    bw = bcnt * word_u32
    S = -(-stream_len // (n * 128)) * 128
    real_arr = jnp.asarray(real, jnp.int32)
    ext_n = n * per_shard + 1  # off_ext length (all dynamic indexing in-bounds)

    def shard_fn(slab):
        slab = slab.reshape(-1)  # (S,)
        my = jax.lax.axis_index(axis)
        # Recover the offset table from the sharded slabs with ONE
        # header-sized psum (each device contributes its slab's overlap
        # with the header span; spans are disjoint so sum == value).
        # Slicing the sharded stream outside the shard_map instead makes
        # GSPMD all-gather the WHOLE stream per device — the exact
        # O(total) footprint this path exists to avoid.
        hdr_part = _masked_span_copy(
            jnp.zeros(num_hc, jnp.uint32), jnp.int32(0), slab,
            my * S, jnp.int32(S))
        hdr = jax.lax.psum(hdr_part, axis)
        offsets = jax.lax.bitcast_convert_type(hdr, jnp.int32)
        off_ext = jnp.concatenate([jnp.zeros(1, jnp.int32), offsets])
        if ext_n > num_hc + 1:
            off_ext = jnp.concatenate(
                [off_ext,
                 jnp.broadcast_to(off_ext[num_hc], (ext_n - num_hc - 1,))])
        lo = my * per_shard
        window = jax.lax.dynamic_slice(off_ext, (lo,), (per_shard,))
        base = window[0]  # == off_ext[lo] == offsets[lo-1] (0 for shard 0)
        sr = window - base  # sr[i] = local start of block i (sr[0] == 0)
        rk = real_arr[my]
        fill = sr[jnp.clip(rk - 1, 0, per_shard - 1)]
        starts = jnp.where(jnp.arange(per_shard) < rk, sr, fill)

        my_start = header_u32 + base * word_u32
        # device-varying from the start: the ring cond's pass-through
        # branch must type-match the copy branch under check_vma
        sub = jax.lax.pcast(
            jnp.zeros(bound_local, jnp.uint32), axis, to="varying")

        def step(s, carry):
            sub, sj = carry
            j = (my - s) % n
            jA = j * S
            sub = jax.lax.cond(
                (jA < my_start + bound_local) & (jA + S > my_start),
                lambda sb: _masked_span_copy(sb, my_start, sj, jA, S),
                lambda sb: sb, sub)
            return sub, _ring_shift(sj, axis, n)

        sub, _ = jax.lax.fori_loop(0, n, step, (sub, slab))
        out = ctx.shard_body(sub, starts)
        if bcnt:
            body_total = off_ext[num_hc]
            bstart = header_u32 + body_total * word_u32
            part = _masked_span_copy(
                jnp.zeros(bw, jnp.uint32), bstart, slab, my * S, S)
            bv = jax.lax.psum(part, axis)
            return out, bv
        return out

    out_specs = (P(axis), P()) if bcnt else P(axis)
    mapped = shard_map(
        shard_fn, mesh=mesh, in_specs=(P(axis),), out_specs=out_specs)
    sh = NamedSharding(mesh, P(axis))
    assemble = _build_assemble(shape, dtype, mesh, ctx)

    @jax.jit
    def run(stream_dev):
        s = stream_dev
        if stream_len < n * S:
            s = jnp.concatenate(
                [s, jnp.zeros(n * S - stream_len, jnp.uint32)])
        s = jax.lax.with_sharding_constraint(s, sh)
        if bcnt:
            out_local, bv = mapped(s)
        else:
            out_local = mapped(s)
            bv = jnp.zeros(0, jnp.uint32)
        return assemble(out_local, bv)

    return run


def _decode_windows_xla32(windows, dims):
    nb = windows.shape[0]
    heads_n = fmt.HC_SIZE // 32
    heads = windows[:, :heads_n]
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    present = ((heads[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)).astype(jnp.int32)
    ranks = jnp.cumsum(present, axis=2) - present
    counts = present.sum(axis=2)
    chunk_starts = heads_n + jnp.cumsum(counts, axis=1) - counts
    src = chunk_starts[:, :, None] + ranks
    gathered = jnp.take_along_axis(windows, src.reshape(nb, -1), axis=1)
    transposed = jnp.where(
        present.astype(bool), gathered.reshape(nb, heads_n, 32), jnp.uint32(0))
    chunks = bitops.transpose_bits(transposed, jnp)
    return codec_xla.inverse_block_transform_u32(chunks.reshape(nb, fmt.HC_SIZE), dims)


def _decode_windows_xla64(win_lo, win_hi, dims):
    nb = win_lo.shape[0]
    heads_n = fmt.HC_SIZE // 64
    heads_lo = win_lo[:, :heads_n]
    heads_hi = win_hi[:, :heads_n]
    shifts = jnp.arange(31, -1, -1, dtype=jnp.uint32)
    bits_hi = (heads_hi[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    bits_lo = (heads_lo[:, :, None] >> shifts[None, None, :]) & jnp.uint32(1)
    present = jnp.concatenate([bits_hi, bits_lo], axis=2).astype(jnp.int32)
    ranks = jnp.cumsum(present, axis=2) - present
    counts = present.sum(axis=2)
    chunk_starts = heads_n + jnp.cumsum(counts, axis=1) - counts
    src = (chunk_starts[:, :, None] + ranks).reshape(nb, -1)
    g_lo = jnp.take_along_axis(win_lo, src, axis=1).reshape(nb, heads_n, 64)
    g_hi = jnp.take_along_axis(win_hi, src, axis=1).reshape(nb, heads_n, 64)
    pb = present.astype(bool).reshape(nb, heads_n, 64)
    tt_lo = jnp.where(pb, g_lo, jnp.uint32(0))
    tt_hi = jnp.where(pb, g_hi, jnp.uint32(0))
    c_hi, c_lo = bitops.transpose_bits_pair32(tt_hi, tt_lo, jnp)
    return codec_xla.inverse_block_transform_pair(
        c_lo.reshape(nb, fmt.HC_SIZE), c_hi.reshape(nb, fmt.HC_SIZE), dims)
