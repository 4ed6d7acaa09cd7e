#!/usr/bin/env python
"""Smoke test of the ndzip codec on the GPU, through the entry points a
user calls, at the sizes users run.

    python chip_smoke.py             # one card: every phase below
    python chip_smoke.py --cards 4   # four cards: the sharded phase only

Every stream is compared byte for byte with ``golden.py``, the numpy
executable spec that tests/test_reference_oracle.py holds bit-equal to the
reference's own CPU codec, and every decode must be bit-exact: the codec
is integer-only, so no tolerance applies.

One card runs five phases on bench.py's seeded cells:
  host_api     ``ndzip_jax.compress``/``decompress`` with backend "auto"
               on all six cells (fp32 1D 2^24 ... fp32 512x512x2048);
  device       ``compress_device``/``decompress_device`` on arrays already
               on the card (fp32 1D 2^24, fp64 512^3 as u32 planes);
  offloader    ``Offloader(..., "xla", timing_mode="device")`` and
               ``measure()`` on fp32 1D 2^24;
  cli          ``cli.run`` in this process on the 1800x3600 field;
  sharded      backend "sharded" on the one-card mesh, fp32 256^3.
Four cards run ``compress_sharded``/``decompress_sharded`` and their
device-resident pair on a 4-device mesh, for fp32 512x512x2048 and fp64
512^3, against the one-card stream.

Each phase prints a line with its cold (first-call) and warm seconds, the
peak device bytes of its compiled programs (``memory_analysis()``) and the
persistent compile-cache hits it saw.  The last line is
``{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}``;
any failure, or a platform other than ``gpu``, ends the script nonzero
without it.
"""

import argparse
import json
import os
import sys
import tempfile
import time

import numpy as np

ONE_CARD_CELLS = ("fp32_1d", "fp64", "cesm", "cube3d", "fp64_512cube",
                  "fp32_2gib_3d")
DEVICE_CELLS = ("fp32_1d", "fp64_512cube")
FOUR_CARD_CELLS = ("fp32_2gib_3d", "fp64_512cube")

_CACHE_HITS = [0]


def _count_cache_hits(event, **_):
    if event == "/jax/compilation_cache/cache_hits":
        _CACHE_HITS[0] += 1


def _timed(fn, *args):
    import jax

    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    return out, time.perf_counter() - t0


def _peak_bytes(jitted, *args) -> int:
    """Peak device bytes of the compiled program for these arguments."""
    import jax

    avals = jax.tree_util.tree_map(
        lambda a: jax.ShapeDtypeStruct(a.shape, a.dtype), args)
    m = jitted.lower(*avals).compile().memory_analysis()
    return (m.argument_size_in_bytes + m.output_size_in_bytes
            + m.temp_size_in_bytes - m.alias_size_in_bytes)


def _on_platform(arrays, platform):
    import jax

    for a in jax.tree_util.tree_leaves(arrays):
        if not isinstance(a, jax.Array):
            raise AssertionError(f"expected a jax.Array, got {type(a).__name__}")
        got = {d.platform for d in a.devices()}
        if got != {platform}:
            raise AssertionError(f"array on {got}, expected {platform}")


def _same_bytes(what, got, expect):
    if np.asarray(got).tobytes() != np.asarray(expect).tobytes():
        raise AssertionError(f"{what}: bytes differ")


def _report(phase, name, **fields):
    parts = [f"{k}={v}" for k, v in fields.items()]
    print(f"phase {phase} {name} " + " ".join(parts) + f" cache_hits={_CACHE_HITS[0]}",
          flush=True)


def _planes(data):
    from ndzip_jax.ops import u64pair

    return u64pair.split(np.ascontiguousarray(data).view(np.uint64))


def _word_avals(data):
    """Shapes of the device codec's inputs for ``data`` (u32 words or planes)."""
    import jax

    word = jax.ShapeDtypeStruct(data.shape, np.uint32)
    return (word, word) if data.dtype == np.float64 else (word,)


def phase_host_api(cells) -> dict:
    """ndzip_jax.compress/decompress with backend "auto"; returns the
    streams by cell name."""
    import jax

    import ndzip_jax
    from ndzip_jax import api, codec_xla, format as fmt, golden

    streams = {}
    for name, data in cells.items():
        backend = api.make_offloader("auto", data.dtype, data.ndim).backend
        if backend != "xla":
            raise AssertionError(f"auto resolved to {backend!r}, expected 'xla'")
        expect, expect_words = golden.compress(data)
        (stream, words), enc_cold = _timed(ndzip_jax.compress, data)
        if words != expect_words:
            raise AssertionError(f"{name}: {words} words, golden {expect_words}")
        _same_bytes(f"{name} stream vs golden", stream, expect)
        _, enc_warm = _timed(ndzip_jax.compress, data)
        out, dec_cold = _timed(ndzip_jax.decompress, stream, data.shape, data.dtype)
        _same_bytes(f"{name} decode", out, data)
        _, dec_warm = _timed(ndzip_jax.decompress, stream, data.shape, data.dtype)
        wb = fmt.word_bits_for_dtype(data.dtype)
        bound = jax.ShapeDtypeStruct((fmt.compressed_bound_u32(data.shape, wb),),
                                     np.uint32)
        _report("host_api", name, shape=data.shape, dtype=data.dtype.name,
                ratio=f"{words * data.itemsize / data.nbytes:.4f}",
                encode_cold_s=f"{enc_cold:.3f}", encode_warm_s=f"{enc_warm:.4f}",
                encode_peak_bytes=_peak_bytes(codec_xla.encode_fn(data.shape, wb),
                                              *_word_avals(data)),
                decode_cold_s=f"{dec_cold:.3f}", decode_warm_s=f"{dec_warm:.4f}",
                decode_peak_bytes=_peak_bytes(codec_xla.decode_fn(data.shape, wb), bound),
                stream="golden", decode="bit-exact")
        streams[name] = stream
    return streams


def phase_device(cells, streams, platform="gpu"):
    """compress_device/decompress_device on arrays already on the device;
    streams must equal the host path's."""
    import jax

    import ndzip_jax
    from ndzip_jax import codec_xla, format as fmt
    from ndzip_jax.ops import u64pair

    for name, data in cells.items():
        shape, wb = data.shape, fmt.word_bits_for_dtype(data.dtype)
        if wb == 64:
            arg = tuple(jax.device_put(p) for p in _planes(data))
        else:
            arg = jax.device_put(data)
        _on_platform(arg, platform)
        (stream, length), enc_cold = _timed(ndzip_jax.compress_device, arg)
        _, enc_warm = _timed(ndzip_jax.compress_device, arg)
        _on_platform((stream, length), platform)
        n = int(length)
        _same_bytes(f"{name} device stream vs host stream", stream[:n], streams[name])
        out, dec_cold = _timed(ndzip_jax.decompress_device, stream, shape, data.dtype)
        _, dec_warm = _timed(ndzip_jax.decompress_device, stream, shape, data.dtype)
        _on_platform(out, platform)
        if wb == 64:
            words = u64pair.join(np.asarray(out[0]), np.asarray(out[1]))
        else:
            words = np.asarray(out)
            if out.dtype != np.float32:
                raise AssertionError(f"{name}: decoded dtype {out.dtype}")
        _same_bytes(f"{name} device decode", words, data)
        args = arg if wb == 64 else (arg,)
        _report("device", name, shape=shape, dtype=data.dtype.name,
                encode_cold_s=f"{enc_cold:.3f}", encode_warm_s=f"{enc_warm:.4f}",
                encode_peak_bytes=_peak_bytes(codec_xla.encode_fn(shape, wb), *args),
                decode_cold_s=f"{dec_cold:.3f}", decode_warm_s=f"{dec_warm:.4f}",
                decode_peak_bytes=_peak_bytes(codec_xla.decode_fn(shape, wb), stream),
                stream="host", decode="bit-exact")


def phase_offloader(name, data, stream, card):
    """Offloader with device timing, and its chained-loop measure()."""
    from ndzip_jax import api

    off = api.Offloader(data.dtype, data.ndim, "xla", timing_mode="device")
    got, _ = off.compress(data)
    fenced_compress_ns = off.timing.compress_ns
    _same_bytes(f"{name} offloader stream", got, stream)
    out = off.decompress(got, data.shape)
    fenced_decompress_ns = off.timing.decompress_ns
    _same_bytes(f"{name} offloader decode", out, data)
    t = off.measure(data)
    _report("offloader", name, fenced_compress_ns=fenced_compress_ns,
            fenced_decompress_ns=fenced_decompress_ns,
            measure_compress_ns=t.compress_ns, measure_decompress_ns=t.decompress_ns,
            card=repr(card), stream="host", decode="bit-exact")


def phase_cli(name, data, stream):
    """cli.run in this process: compress, then decompress, a raw file."""
    from ndzip_jax import cli

    typ = "float" if data.dtype == np.float32 else "double"
    extent = [str(s) for s in data.shape]
    with tempfile.TemporaryDirectory() as tmp:
        raw, comp, back = (os.path.join(tmp, f) for f in ("in.raw", "out.ndz", "back.raw"))
        data.tofile(raw)
        t0 = time.perf_counter()
        if cli.run(["-n", *extent, "-t", typ, "-i", raw, "-o", comp]) != 0:
            raise AssertionError("cli compress failed")
        t1 = time.perf_counter()
        if cli.run(["-d", "-n", *extent, "-t", typ, "-i", comp, "-o", back]) != 0:
            raise AssertionError("cli decompress failed")
        t2 = time.perf_counter()
        with open(comp, "rb") as f:
            _same_bytes(f"{name} cli stream", np.frombuffer(f.read(), np.uint8),
                        np.asarray(stream).view(np.uint8))
        with open(back, "rb") as f:
            _same_bytes(f"{name} cli decode", np.frombuffer(f.read(), np.uint8),
                        data.view(np.uint8).reshape(-1))
    _report("cli", name, compress_s=f"{t1 - t0:.3f}", decompress_s=f"{t2 - t1:.3f}",
            stream="host", decode="bit-exact")


def phase_sharded_backend(name, data, stream):
    """backend="sharded" over every visible device (one card: a 1-device mesh)."""
    import jax

    from ndzip_jax import api

    comp = api.make_compressor(data.dtype, data.ndim, "sharded")
    dec = api.make_decompressor(data.dtype, data.ndim, "sharded")
    (got, _), enc_cold = _timed(comp.compress, data)
    _, enc_warm = _timed(comp.compress, data)
    _same_bytes(f"{name} sharded stream", got, stream)
    out, dec_cold = _timed(dec.decompress, got, data.shape)
    _, dec_warm = _timed(dec.decompress, got, data.shape)
    _same_bytes(f"{name} sharded decode", out, data)
    _report("sharded", name, devices=len(jax.devices()),
            encode_cold_s=f"{enc_cold:.3f}", encode_warm_s=f"{enc_warm:.4f}",
            decode_cold_s=f"{dec_cold:.3f}", decode_warm_s=f"{dec_warm:.4f}",
            stream="host", decode="bit-exact")


def phase_four_cards(cells, devices, platform="gpu"):
    """The sharded engine on a mesh of ``devices``: host and
    device-resident pairs, against the one-device XLA stream."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ndzip_jax import codec_xla
    from ndzip_jax.ops import u64pair
    from ndzip_jax.parallel import (compress_sharded, compress_sharded_device,
                                    decompress_sharded, decompress_sharded_device,
                                    make_mesh)
    from ndzip_jax.parallel.sharded import AXIS

    mesh = make_mesh(devices)
    sharding = NamedSharding(mesh, P(AXIS))
    for name, data in cells.items():
        expect, expect_words = codec_xla.compress(data)
        (stream, words), enc_cold = _timed(compress_sharded, data, mesh)
        _, enc_warm = _timed(compress_sharded, data, mesh)
        if words != expect_words:
            raise AssertionError(f"{name}: sharded {words} words, one device {expect_words}")
        _same_bytes(f"{name} sharded stream", stream, expect)
        out, dec_cold = _timed(decompress_sharded, stream, data.shape, data.dtype, mesh)
        _, dec_warm = _timed(decompress_sharded, stream, data.shape, data.dtype, mesh)
        _same_bytes(f"{name} sharded decode", out, data)

        if data.dtype == np.float64:
            arg = tuple(jax.device_put(p, sharding) for p in _planes(data))
        else:
            arg = jax.device_put(data, sharding)
        _on_platform(arg, platform)
        (sdev, ldev), denc_cold = _timed(compress_sharded_device, arg, mesh)
        _, denc_warm = _timed(compress_sharded_device, arg, mesh)
        _on_platform((sdev, ldev), platform)
        n = int(ldev)
        _same_bytes(f"{name} device-resident sharded stream", sdev[:n], expect)
        odev, ddec_cold = _timed(decompress_sharded_device, sdev, data.shape,
                                 data.dtype, mesh)
        _, ddec_warm = _timed(decompress_sharded_device, sdev, data.shape,
                              data.dtype, mesh)
        _on_platform(odev, platform)
        if data.dtype == np.float64:
            words_out = u64pair.join(np.asarray(odev[0]), np.asarray(odev[1]))
        else:
            words_out = np.asarray(odev)
        _same_bytes(f"{name} device-resident sharded decode", words_out, data)
        _report("four_cards", name, devices=len(devices), shape=data.shape,
                dtype=data.dtype.name,
                encode_cold_s=f"{enc_cold:.3f}", encode_warm_s=f"{enc_warm:.4f}",
                decode_cold_s=f"{dec_cold:.3f}", decode_warm_s=f"{dec_warm:.4f}",
                device_encode_cold_s=f"{denc_cold:.3f}",
                device_encode_warm_s=f"{denc_warm:.4f}",
                device_decode_cold_s=f"{ddec_cold:.3f}",
                device_decode_warm_s=f"{ddec_warm:.4f}",
                stream="one-device", decode="bit-exact")


def ok_line(platform, kind, count) -> str:
    return json.dumps({"ok": True, "device": {
        "platform": platform, "kind": kind, "count": count}})


def main(argv=None) -> int:
    p = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    p.add_argument("--cards", type=int, choices=(1, 4), default=1,
                   help="1: every one-card phase; 4: the four-card phase only")
    args = p.parse_args(argv)

    import jax

    if jax.default_backend() != "gpu":
        raise SystemExit(f"chip_smoke: JAX's platform is {jax.default_backend()!r}, "
                         "not 'gpu'")
    devices = jax.devices()[: args.cards]
    if len(devices) < args.cards:
        raise SystemExit(f"chip_smoke: {args.cards} cards asked, "
                         f"{len(jax.devices())} present")

    from jax import monitoring

    import bench
    from ndzip_jax import utils

    cache = utils.enable_compilation_cache()
    monitoring.register_event_listener(_count_cache_hits)
    card = utils.gpu_name_power()
    kind = devices[0].device_kind
    print(f"device: platform=gpu kind={kind} count={len(devices)} "
          f"compile_cache={cache}", flush=True)

    if args.cards == 4:
        phase_four_cards({n: bench.make_cell(n) for n in FOUR_CARD_CELLS}, devices)
    else:
        cells = {n: bench.make_cell(n) for n in ONE_CARD_CELLS}
        streams = phase_host_api(cells)
        phase_device({n: cells[n] for n in DEVICE_CELLS}, streams)
        phase_offloader("fp32_1d", cells["fp32_1d"], streams["fp32_1d"], card)
        phase_cli("cesm", cells["cesm"], streams["cesm"])
        phase_sharded_backend("cube3d", cells["cube3d"], streams["cube3d"])

    print(f"nvidia-smi: {card}", flush=True)
    print(ok_line("gpu", kind, len(devices)), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
