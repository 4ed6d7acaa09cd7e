"""Multi-host block-parallel compression.

The reference is single-process (SURVEY.md §2.12); this subsystem is the
distributed design it lacks.  Design:

* Every process owns a contiguous slab of the global grid along axis 0
  (`local_rows = global_rows / num_processes`, block-aligned), the usual
  HPC row decomposition.  The block-grid's major axis is therefore sharded
  process-contiguously: canonical stream order == process order.
* ``jax.make_array_from_process_local_data`` assembles the logically
  global array; ``shard_map`` over the global mesh runs the same per-shard
  encode as the single-host layer (parallel/sharded.py), so every device —
  across hosts — encodes its own block range on host-local data.
* The only cross-host communication is a ~num_processes-word exchange of
  per-shard body lengths (``multihost_utils.process_allgather``)
  — the distributed analog of the reference's device-wide offset scan
  (cuda_bits.cuh:266-333).  An exclusive scan of those lengths gives each
  shard's global body offset; header entries are rebased locally.
* Stream assembly is write-in-place: every process knows the absolute
  byte ranges of its header entries, body span and border span, so hosts
  either pwrite their slices into a shared file (``write_to_file``) or
  gather to process 0 (``gather_stream``).  The result is bit-identical
  to the serial stream.

Border layout note: with axis 0 block-aligned per process, the global
border runs (format.border_slices) are ordered by leading index and are
therefore process-contiguous — each process's slab borders form one
contiguous span of the global border region, at offset
``sum(border_count of earlier slabs)``.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .. import format as fmt
from ..ops import u64pair
from . import sharded


def init(coordinator_address: str, num_processes: int, process_id: int,
         platform: str | None = None):
    """jax.distributed bring-up, optionally pinned to ``platform`` (the
    tests run it on CPU processes with gloo collectives)."""
    import jax

    if platform == "cpu":
        jax.config.update("jax_cpu_collectives_implementation", "gloo")
    jax.distributed.initialize(coordinator_address, num_processes=num_processes,
                               process_id=process_id)
    if platform is not None:
        jax.config.update("jax_platforms", platform)


def global_mesh(axis_name: str = sharded.AXIS):
    import jax
    from jax.sharding import Mesh

    return Mesh(np.asarray(jax.devices()), (axis_name,))


@dataclass
class ShardStream:
    """One process's slice of the global compressed stream, plus the
    placement metadata to assemble the byte-exact whole."""

    process_id: int
    num_processes: int
    header_entries: np.ndarray   # uint32, rebased to global body offsets
    entry_offset: int            # index of this process's first header entry
    num_hc_global: int
    header_u32: int              # global header length in u32 words
    body_u32: np.ndarray         # this process's body words (u32 units)
    body_offset_u32: int         # u32 offset of the body span (incl. header)
    border_u32: np.ndarray       # this process's border words (u32 units)
    border_offset_u32: int       # u32 offset of the border span
    total_u32: int               # total global stream length in u32 words

    def write_to_file(self, path: str):
        """Write this shard's slices at their absolute offsets (shared or
        local filesystem).  Process 0 should have created/truncated the
        file to 4*total_u32 bytes first (see compress_to_file)."""
        with open(path, "r+b") as f:
            f.seek(4 * self.entry_offset)
            f.write(self.header_entries.tobytes())
            f.seek(4 * self.body_offset_u32)
            f.write(self.body_u32.tobytes())
            f.seek(4 * self.border_offset_u32)
            f.write(self.border_u32.tobytes())


def _split_words(data: np.ndarray, wb: int):
    if wb == 32:
        return (np.ascontiguousarray(data).view(np.uint32),)
    lo, hi = u64pair.split(np.ascontiguousarray(data).view(np.uint64))
    return (lo, hi)


def compress_multihost(local_slab: np.ndarray, mesh=None) -> ShardStream:
    """Compress a globally row-partitioned grid; every process passes its
    own slab (equal shapes, axis 0 block-aligned).  Returns this process's
    ShardStream.  Collective: must be called by all processes."""
    import jax
    from jax.experimental import multihost_utils
    from jax import shard_map
    from jax.sharding import NamedSharding, PartitionSpec as P

    if mesh is None:
        mesh = global_mesh()
    nproc = jax.process_count()
    n_dev = mesh.devices.size
    axis = mesh.axis_names[0]

    local_slab = np.ascontiguousarray(local_slab)
    local_shape = tuple(local_slab.shape)
    dims = len(local_shape)
    side = fmt.SIDE_LENGTH[dims]
    dtype = np.dtype(local_slab.dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    word_u32 = wb // 32

    global_shape = (local_shape[0] * nproc,) + local_shape[1:]
    grid = fmt.grid_shape(global_shape)
    if local_shape[0] % side != 0:
        raise ValueError(
            f"local slab axis 0 ({local_shape[0]}) must be a multiple of the "
            f"block side length {side} so processes own whole block rows")
    if fmt.num_hypercubes(global_shape) == 0:
        raise ValueError(
            f"global shape {global_shape} has no whole hypercube blocks "
            f"(every axis must reach the side length {side}); all-border "
            "grids must use a single-host codec (api.make_compressor)")
    if n_dev % nproc != 0:
        raise ValueError(
            f"{n_dev} devices over {nproc} processes: unequal local device "
            "counts are not supported")
    num_hc = fmt.num_hypercubes(global_shape)
    header_u32 = fmt.header_u32_words(num_hc, wb)

    # Split each process's slab over its local devices; when the slab's
    # block-rows don't divide, pad the slab with zero block-rows so every
    # device presents the same local shape (padded blocks' entries/bodies
    # are dropped at assembly — same scheme as parallel/sharded.py).
    d = n_dev // nproc
    L = local_shape[0] // side           # block-rows per slab
    L_pad = -(-L // d) * d
    bpr = num_hc // grid[0]              # blocks per block-row
    rows_pb = L_pad // d                 # padded block-rows per shard
    per_shard = rows_pb * bpr
    real_per_j = [max(0, min(L - j * rows_pb, rows_pb)) * bpr
                  for j in range(d)]     # real blocks of local shard j

    # interior region of the local slab (axis 0 is block-aligned; borders
    # exist only along trailing axes + none on axis 0 within the slab)
    interior = tuple(slice(0, s // side * side) for s in local_shape)
    shard_local_shape = (rows_pb * side,) + tuple(g * side for g in grid[1:])

    pad_rows = (L_pad - L) * side
    host_words = tuple(sharded._pad_block_rows(w, pad_rows)
                       for w in _split_words(local_slab[interior], wb))

    shard_fn = sharded._encode_shard_fn(shard_local_shape, dims, wb)

    sharding = NamedSharding(mesh, P(axis))
    global_in = tuple(
        jax.make_array_from_process_local_data(sharding, w.reshape(-1, *w.shape[1:]))
        for w in host_words)

    mapped = shard_map(
        shard_fn, mesh=mesh,
        in_specs=(tuple(P(axis) for _ in global_in),),
        out_specs=(P(axis), P(axis)))
    entries_g, bodies_g = jax.jit(mapped)(global_in)

    # local (addressable) results, in global shard order
    ent_local = {  # shard index -> numpy
        _shard_index(mesh, s): np.asarray(s.data).reshape(-1)
        for s in entries_g.addressable_shards}
    body_local = {
        _shard_index(mesh, s): np.asarray(s.data).reshape(-1)
        for s in bodies_g.addressable_shards}

    # real (non-pad) body lengths in u32 units, host-derived from the
    # last real block's cumulative offset
    my_shards = sorted(ent_local)

    def _real(k):
        return real_per_j[k % d]

    blen_local = np.asarray(
        [int(ent_local[k][_real(k) - 1]) * word_u32 if _real(k) else 0
         for k in my_shards], np.int64)

    # cross-host exchange: per-shard body lengths (u32 units) -> global offsets
    all_blens = multihost_utils.process_allgather(blen_local).reshape(-1)
    shard_body_off = np.concatenate([[0], np.cumsum(all_blens)[:-1]])

    # assemble this process's contiguous spans (padded blocks dropped)
    first = my_shards[0]
    entries_parts, body_parts = [], []
    for k in my_shards:
        rk = _real(k)
        if rk == 0:
            continue
        entries_parts.append(
            ent_local[k][:rk] + np.uint32(shard_body_off[k] // word_u32))
        body_parts.append(body_local[k][: all_blens[k]])
    header_entries = (np.concatenate(entries_parts) if entries_parts
                      else np.zeros(0, np.uint32))
    body = np.concatenate(body_parts) if body_parts else np.zeros(0, np.uint32)

    # border span: per-slab borders are process-contiguous (module note)
    border_local = _slab_border_words(local_slab, wb)
    slab_border_u32 = border_local.size  # identical across processes
    body_total_u32 = int(np.cumsum(all_blens)[-1])
    border_base = header_u32 + body_total_u32
    pid = jax.process_index()

    return ShardStream(
        process_id=pid,
        num_processes=nproc,
        header_entries=header_entries.astype(np.uint32),
        entry_offset=pid * L * bpr,
        num_hc_global=num_hc,
        header_u32=header_u32,
        body_u32=body,
        body_offset_u32=int(header_u32 + shard_body_off[first]),
        border_u32=border_local,
        border_offset_u32=int(border_base + pid * slab_border_u32),
        total_u32=int(border_base + nproc * slab_border_u32),
    )


def _shard_index(mesh, s) -> int:
    return int(np.where((mesh.devices == s.device).reshape(-1))[0][0])


def _slab_border_words(local_slab: np.ndarray, wb: int) -> np.ndarray:
    flat = np.ascontiguousarray(local_slab).view(
        np.uint32 if wb == 32 else np.uint64).reshape(-1)
    parts = [np.ascontiguousarray(flat[off : off + cnt]).view(np.uint32)
             for off, cnt in fmt.border_slices(tuple(local_slab.shape))]
    if not parts:
        return np.zeros(0, np.uint32)
    return np.concatenate(parts)


def gather_stream(shard: ShardStream) -> np.ndarray | None:
    """All-gather every process's spans to process 0 and assemble the full
    stream (returns None on other processes).  For tests and small files;
    production paths should use write_to_file on a shared filesystem."""
    import jax
    from jax.experimental import multihost_utils

    def _allgather_var(arr: np.ndarray) -> list[np.ndarray]:
        sizes = multihost_utils.process_allgather(
            np.array([arr.size], np.int64)).reshape(-1)
        m = int(sizes.max()) if sizes.size else 0
        padded = np.zeros(m, np.uint32)
        padded[: arr.size] = arr
        all_p = multihost_utils.process_allgather(padded)
        return [all_p[i][: sizes[i]] for i in range(len(sizes))]

    ents = _allgather_var(shard.header_entries)
    bodies = _allgather_var(shard.body_u32)
    borders = _allgather_var(shard.border_u32)
    offs = multihost_utils.process_allgather(np.array(
        [shard.entry_offset, shard.body_offset_u32, shard.border_offset_u32],
        np.int64))
    if jax.process_index() != 0:
        return None
    out = np.zeros(shard.total_u32, np.uint32)
    for p in range(shard.num_processes):
        eo, bo, ro = (int(x) for x in offs[p])
        out[eo : eo + ents[p].size] = ents[p]
        out[bo : bo + bodies[p].size] = bodies[p]
        out[ro : ro + borders[p].size] = borders[p]
    return out


def compress_to_file(local_slab: np.ndarray, path: str, mesh=None) -> int:
    """Collective: compress and write one bit-exact stream file; returns
    total length in u32 words.  Requires `path` on a filesystem visible to
    all processes."""
    import jax
    from jax.experimental import multihost_utils

    shard = compress_multihost(local_slab, mesh)
    if jax.process_index() == 0:
        with open(path, "wb") as f:
            f.truncate(4 * shard.total_u32)
    multihost_utils.sync_global_devices("ndzip:file_created")
    shard.write_to_file(path)
    multihost_utils.sync_global_devices("ndzip:file_written")
    return shard.total_u32


def decompress_from_file(path: str, global_shape, dtype, mesh=None):
    """Collective: decode this process's slab straight from a stream file
    with O(shard) IO — the read-side analog of ``write_to_file``.  The
    file is memory-mapped, so each process faults in only the pages its
    header span, body span and border span touch (the offset table gives
    random access, like the reference's block-offset reads,
    cuda_codec.inl:290-297); no process materializes the whole stream."""
    stream = np.memmap(path, dtype=np.uint32, mode="r")
    return decompress_multihost(stream, global_shape, dtype, mesh)


def decompress_multihost(stream: np.ndarray, global_shape, dtype,
                         mesh=None) -> np.ndarray:
    """Collective: every process passes the full stream (e.g. read from a
    shared file) and receives its own slab (rows
    [pid*rows/nproc, (pid+1)*rows/nproc)) of the decoded grid."""
    import jax

    if mesh is None:
        mesh = global_mesh()
    nproc = jax.process_count()
    pid = jax.process_index()
    global_shape = tuple(global_shape)
    dims = len(global_shape)
    side = fmt.SIDE_LENGTH[dims]
    dtype = np.dtype(dtype)
    wb = fmt.word_bits_for_dtype(dtype)
    word_u32 = wb // 32
    if global_shape[0] % (nproc * side) != 0:
        raise ValueError("global axis 0 must divide into block-aligned slabs")
    if fmt.num_hypercubes(global_shape) == 0:
        raise ValueError(
            f"global shape {global_shape} has no whole hypercube blocks; "
            "all-border grids must use a single-host codec "
            "(api.make_decompressor)")
    local_rows = global_shape[0] // nproc
    local_shape = (local_rows,) + global_shape[1:]

    num_hc = fmt.num_hypercubes(global_shape)
    header_u32 = fmt.header_u32_words(num_hc, wb)
    grid = fmt.grid_shape(global_shape)
    hc_per_proc = num_hc // nproc

    stream = np.asarray(stream)
    offsets = stream[:num_hc].astype(np.int64)
    body_total = int(offsets[-1]) if num_hc else 0

    # this process's block range and rebased sub-stream
    lo_hc = pid * hc_per_proc
    hi_hc = lo_hc + hc_per_proc
    base = int(offsets[lo_hc - 1]) if lo_hc else 0
    sub_entries = (offsets[lo_hc:hi_hc] - base).astype(np.uint32)
    body_lo = header_u32 + base * word_u32
    body_hi = header_u32 + int(offsets[hi_hc - 1]) * word_u32

    local_num_hc = hc_per_proc
    sub_header_u32 = fmt.header_u32_words(local_num_hc, wb)
    sub_interior = (grid[0] // nproc * side,) + tuple(g * side for g in grid[1:])

    # local border span (process-contiguous global border region)
    border_per_slab = fmt.border_element_count(local_shape) * word_u32
    border_base = header_u32 + body_total * word_u32 + pid * border_per_slab

    sub_stream = np.zeros(sub_header_u32 + (body_hi - body_lo) + border_per_slab,
                          np.uint32)
    sub_stream[:local_num_hc] = sub_entries
    sub_stream[sub_header_u32 : sub_header_u32 + body_hi - body_lo] = \
        stream[body_lo:body_hi]
    sub_stream[sub_header_u32 + body_hi - body_lo :] = \
        stream[border_base : border_base + border_per_slab]

    # decode the slab on every process-local device: shard the slab's block
    # rows over a mesh of this process's addressable devices (a
    # single-device decode would idle the others during the decompression
    # half of a round trip).  Falls
    # back to one device only when the slab's block grid cannot split.
    local_devs = jax.local_devices()
    if len(local_devs) > 1 and fmt.num_hypercubes(local_shape) > 0:
        local_mesh = sharded.make_mesh(local_devs)
        return sharded.decompress_sharded(
            sub_stream, local_shape, dtype, local_mesh)
    from .. import api

    dec = api.make_decompressor(dtype, dims, "auto")
    return dec.decompress(sub_stream, local_shape)
