// Benchmark-only competitor codecs: FPC and pFPC.
//
// Reimplementation of the FPC predictive compressor for IEEE doubles from
// the published algorithm description (Burtscher & Ratanaworabhan, "FPC: A
// High-Speed Compressor for Double-Precision Floating-Point Data", IEEE
// Trans. Computers 58(1), 2009): an FCM and a DFCM hash-table predictor
// race per value, the better prediction is XOR'd with the actual bits, and
// the residual is stored as (4-bit code | leading-zero-byte count) plus the
// non-zero low bytes.  The reference benchmark links the author sources as
// a vendored submodule (/root/reference/src/benchmark/benchmark.cc:1196-1253
// "fpc"); this file is an independent implementation — the container byte
// layout is ours, since only the speed/ratio character matters for the
// competitor measurement, not stream interchange.
//
// C ABI (ctypes-friendly, see ndzip_jax/competitors.py):
//   fpc_bound(n)                       -> worst-case compressed bytes
//   fpc_compress(in, n, out, level)    -> compressed bytes written
//   fpc_decompress(in, clen, out, n, level) -> values decoded (n on success)
// `level` is the log2 of the predictor-table entry count (FPC's table-size
// tunable; the paper sweeps 10..26).
//
// pFPC (Burtscher & Ratanaworabhan, "pFPC: A Parallel Compressor for
// Floating-Point Data", DCC 2009) parallelizes FPC by splitting the value
// stream into chunks compressed by independent predictor states, one
// thread per chunk group.  The reference benchmark vendors the author
// sources ("pfpc", benchmark.cc:1196-1253); here the same FPC core runs
// over `threads` contiguous chunks under std::thread, with a small
// chunk-table container of our own design (interchange does not matter
// for the competitor measurement, speed/ratio character does):
//   pfpc_bound(n, threads)             -> worst-case compressed bytes
//   pfpc_compress(in, n, out, level, threads)  -> bytes written
//   pfpc_decompress(in, clen, out, n, level)   -> values decoded
// (the thread count is recorded in the stream, so decompression spawns
// the encoder's layout regardless of the caller's machine).
//
// SPDP (Claggett, Azimi & Burtscher, "SPDP: An Automatically Synthesized
// Lossless Compression Algorithm for Floating-Point Data", DCC 2018) is a
// dimensionality-agnostic byte-stream pipeline that works on both fp32 and
// fp64 data; the reference benchmark vendors the author sources
// (benchmark.cc "spdp").  This is an independent implementation of the
// published three-stage pipeline — (1) 32-bit word delta at distance 2,
// (2) stride-8 byte transpose fused with a byte delta, (3) a hash-predicted
// match/run back-end over the residual bytes — with our own container
// (per-chunk size table instead of interleaved length headers; interchange
// does not matter for a competitor measurement, speed/ratio character does):
//   spdp_bound(n)                        -> worst-case compressed bytes
//   spdp_compress(in, n, out, level)     -> compressed bytes written
//   spdp_decompress(in, clen, out, n, level) -> bytes decoded (n on success)
// `level` 0..9 scales the back-end hash table (1 << (level + 9) entries,
// capped at 2^18), the published tunable.

#include <algorithm>
#include <cstdint>
#include <cstring>
#include <thread>
#include <vector>

namespace {

inline int leading_zero_bytes(uint64_t x) {
    if (x == 0) return 8;
    return __builtin_clzll(x) >> 3;
}

struct predictor_state {
    std::vector<uint64_t> fcm, dfcm;
    uint64_t fhash = 0, dhash = 0, last = 0, mask;

    explicit predictor_state(int level)
        : fcm(size_t(1) << level, 0), dfcm(size_t(1) << level, 0),
          mask((uint64_t(1) << level) - 1) {}

    // Returns both predictions for the NEXT value, then call advance(v).
    inline void predict(uint64_t &pf, uint64_t &pd) const {
        pf = fcm[fhash];
        pd = dfcm[dhash] + last;
    }

    inline void advance(uint64_t v) {
        fcm[fhash] = v;
        fhash = ((fhash << 6) ^ (v >> 48)) & mask;
        uint64_t d = v - last;
        dfcm[dhash] = d;
        dhash = ((dhash << 2) ^ (d >> 40)) & mask;
        last = v;
    }
};

}  // namespace

extern "C" {

size_t fpc_bound(size_t n) {
    // 4-bit code per value (packed in pairs) + up to 8 residual bytes each.
    return (n + 1) / 2 + n * 8 + 16;
}

size_t fpc_compress(const double *in, size_t n, uint8_t *out, int level) {
    if (level < 1 || level > 28) return (size_t)-1;
    predictor_state st(level);
    size_t ncodes = (n + 1) / 2;
    uint8_t *codes = out;
    uint8_t *data = out + ncodes;
    std::memset(codes, 0, ncodes);
    size_t dpos = 0;
    for (size_t i = 0; i < n; i++) {
        uint64_t v;
        std::memcpy(&v, in + i, 8);
        uint64_t pf, pd;
        st.predict(pf, pd);
        st.advance(v);
        uint64_t xf = v ^ pf, xd = v ^ pd;
        int use_d = xd < xf;
        uint64_t r = use_d ? xd : xf;
        int z = leading_zero_bytes(r);
        // 3-bit zero-byte field: 0..6 literal, 7 means all 8 bytes zero
        // (a 7-byte-zero residual downgrades to 6, writing 2 bytes — the
        // same rarely-taken-bucket folding the paper applies to z == 4).
        if (z == 7) z = 6;
        int zfield = (z == 8) ? 7 : z;
        codes[i >> 1] |= uint8_t(((use_d << 3) | zfield) << ((i & 1) * 4));
        int nres = (z == 8) ? 0 : 8 - z;
        // one unaligned 8-byte store, advance by the live byte count
        // (fpc_bound leaves room for the overhang)
        std::memcpy(data + dpos, &r, 8);
        dpos += nres;
    }
    return ncodes + dpos;
}

size_t fpc_decompress(const uint8_t *in, size_t comp_len, double *out,
                      size_t n, int level) {
    if (level < 1 || level > 28) return (size_t)-1;
    predictor_state st(level);
    size_t ncodes = (n + 1) / 2;
    if (comp_len < ncodes) return (size_t)-1;
    const uint8_t *codes = in;
    const uint8_t *data = in + ncodes;
    size_t dpos = 0, dmax = comp_len - ncodes;
    for (size_t i = 0; i < n; i++) {
        int code = (codes[i >> 1] >> ((i & 1) * 4)) & 0xf;
        int use_d = code >> 3;
        int zfield = code & 7;
        int nres = (zfield == 7) ? 0 : 8 - zfield;
        if (dpos + nres > dmax) return (size_t)-1;
        // one unaligned 8-byte load masked to the live bytes (the encoder's
        // bound guarantees 8 readable bytes past every residual start)
        uint64_t r;
        std::memcpy(&r, data + dpos, 8);
        r &= (nres == 8) ? ~uint64_t(0) : ((uint64_t(1) << (8 * nres)) - 1);
        dpos += nres;
        uint64_t pf, pd;
        st.predict(pf, pd);
        uint64_t v = r ^ (use_d ? pd : pf);
        st.advance(v);
        std::memcpy(out + i, &v, 8);
    }
    return n;
}

// --- pFPC: chunk-parallel FPC ---------------------------------------------
//
// Stream layout: u64 nchunks | u64 chunk_vals | u64 comp_bytes[nchunks] |
// concatenated per-chunk FPC streams (each self-contained: fresh predictor
// tables, so chunks decode independently and in parallel).

static inline size_t pfpc_chunk_vals(size_t n, int threads) {
    if (threads < 1) threads = 1;
    size_t c = (n + size_t(threads) - 1) / size_t(threads);
    return c ? c : 1;
}

size_t pfpc_bound(size_t n, int threads) {
    size_t cv = pfpc_chunk_vals(n, threads);
    size_t nchunks = n ? (n + cv - 1) / cv : 0;
    return 16 + nchunks * 8 + nchunks * fpc_bound(cv);
}

size_t pfpc_compress(const double *in, size_t n, uint8_t *out, int level,
                     int threads) {
    if (level < 1 || level > 28) return (size_t)-1;
    size_t cv = pfpc_chunk_vals(n, threads);
    size_t nchunks = n ? (n + cv - 1) / cv : 0;
    uint64_t hdr[2] = {nchunks, cv};
    std::memcpy(out, hdr, 16);
    uint64_t *table = reinterpret_cast<uint64_t *>(out + 16);
    uint8_t *streams = out + 16 + nchunks * 8;
    size_t slot = fpc_bound(cv);  // scratch stride before compaction
    std::vector<std::thread> pool;
    pool.reserve(nchunks);
    for (size_t c = 0; c < nchunks; c++) {
        pool.emplace_back([=]() {
            size_t lo = c * cv;
            size_t cn = (lo + cv <= n) ? cv : n - lo;
            table[c] = fpc_compress(in + lo, cn, streams + c * slot, level);
        });
    }
    for (auto &t : pool) t.join();
    // compact the per-chunk streams tight (serial memmove; bandwidth-bound)
    size_t pos = 0;
    for (size_t c = 0; c < nchunks; c++) {
        if (table[c] == (uint64_t)-1) return (size_t)-1;
        std::memmove(streams + pos, streams + c * slot, table[c]);
        pos += table[c];
    }
    return 16 + nchunks * 8 + pos;
}

size_t pfpc_decompress(const uint8_t *in, size_t comp_len, double *out,
                       size_t n, int level) {
    if (level < 1 || level > 28) return (size_t)-1;
    if (comp_len < 16) return (size_t)-1;
    uint64_t hdr[2];
    std::memcpy(hdr, in, 16);
    size_t nchunks = hdr[0], cv = hdr[1];
    if (cv == 0 || nchunks != (n ? (n + cv - 1) / cv : 0)) return (size_t)-1;
    if (comp_len < 16 + nchunks * 8) return (size_t)-1;
    const uint64_t *table = reinterpret_cast<const uint64_t *>(in + 16);
    const uint8_t *streams = in + 16 + nchunks * 8;
    size_t avail = comp_len - 16 - nchunks * 8;
    std::vector<size_t> offs(nchunks + 1, 0);
    for (size_t c = 0; c < nchunks; c++) offs[c + 1] = offs[c] + table[c];
    if (offs[nchunks] > avail) return (size_t)-1;
    std::vector<size_t> got(nchunks, 0);
    std::vector<std::thread> pool;
    pool.reserve(nchunks);
    for (size_t c = 0; c < nchunks; c++) {
        pool.emplace_back([=, &offs, &got]() {
            size_t lo = c * cv;
            size_t cn = (lo + cv <= n) ? cv : n - lo;
            got[c] = fpc_decompress(streams + offs[c], table[c], out + lo,
                                    cn, level);
        });
    }
    for (auto &t : pool) t.join();
    for (size_t c = 0; c < nchunks; c++) {
        size_t lo = c * cv;
        size_t cn = (lo + cv <= n) ? cv : n - lo;
        if (got[c] != cn) return (size_t)-1;
    }
    return n;
}

}  // extern "C"

// --- LZ4 block format -------------------------------------------------------
//
// The reference benchmarks LZ4 both directly and through nvCOMP
// (benchmark.cc "lz4" / "nvcomp:lz4"); no LZ4 library exists in this
// image, so this is an independent implementation of the public LZ4
// block format (token | literal-run | offset | match-run sequences,
// min-match 4, 64 KiB window, last-5-literals rule) with a greedy
// 4-byte-hash matcher — the classic fast-level strategy:
//   lz4_bound(n)                      -> worst-case compressed bytes
//   lz4_compress(in, n, out)          -> compressed bytes written
//   lz4_decompress(in, clen, out, n)  -> bytes decoded (n on success)

namespace {

inline uint32_t lz4_hash4(uint32_t v) {
    return (v * 2654435761u) >> 19;  // 13-bit table
}

}  // namespace

extern "C" {

size_t lz4_bound(size_t n) {
    return n + n / 255 + 32;
}

size_t lz4_compress(const uint8_t *in, size_t n, uint8_t *out) {
    size_t op = 0, anchor = 0;
    std::vector<uint32_t> table(size_t(1) << 13, 0);  // stores pos + 1
    // Matches must start before n-12 and may extend to n-5 (spec's
    // end-of-block rules); everything past the last match is literals.
    size_t match_start_limit = n >= 12 ? n - 12 : 0;
    size_t match_end_limit = n >= 5 ? n - 5 : 0;
    size_t ip = 0;
    while (ip < match_start_limit) {
        uint32_t seq;
        std::memcpy(&seq, in + ip, 4);
        uint32_t h = lz4_hash4(seq);
        size_t cand = table[h];
        table[h] = uint32_t(ip + 1);
        uint32_t cv = 0;
        if (cand && ip + 1 - cand <= 65535 &&
            (std::memcpy(&cv, in + cand - 1, 4), cv == seq)) {
            size_t mpos = cand - 1;
            size_t mlen = 4;
            while (ip + mlen < match_end_limit &&
                   in[mpos + mlen] == in[ip + mlen])
                mlen++;
            size_t lit = ip - anchor;
            uint8_t *token = out + op++;
            if (lit >= 15) {
                *token = 15 << 4;
                size_t rest = lit - 15;
                while (rest >= 255) { out[op++] = 255; rest -= 255; }
                out[op++] = uint8_t(rest);
            } else {
                *token = uint8_t(lit << 4);
            }
            std::memcpy(out + op, in + anchor, lit);
            op += lit;
            uint16_t off = uint16_t(ip - mpos);
            std::memcpy(out + op, &off, 2);
            op += 2;
            size_t mex = mlen - 4;
            if (mex >= 15) {
                *token |= 15;
                size_t rest = mex - 15;
                while (rest >= 255) { out[op++] = 255; rest -= 255; }
                out[op++] = uint8_t(rest);
            } else {
                *token |= uint8_t(mex);
            }
            ip += mlen;
            anchor = ip;
        } else {
            ip++;
        }
    }
    // terminal literal run
    size_t lit = n - anchor;
    uint8_t *token = out + op++;
    if (lit >= 15) {
        *token = 15 << 4;
        size_t rest = lit - 15;
        while (rest >= 255) { out[op++] = 255; rest -= 255; }
        out[op++] = uint8_t(rest);
    } else {
        *token = uint8_t(lit << 4);
    }
    std::memcpy(out + op, in + anchor, lit);
    op += lit;
    return op;
}

size_t lz4_decompress(const uint8_t *in, size_t clen, uint8_t *out,
                      size_t n) {
    size_t ip = 0, op = 0;
    while (ip < clen) {
        uint8_t token = in[ip++];
        size_t lit = token >> 4;
        if (lit == 15) {
            uint8_t b;
            do {
                if (ip >= clen) return (size_t)-1;
                b = in[ip++];
                lit += b;
            } while (b == 255);
        }
        if (ip + lit > clen || op + lit > n) return (size_t)-1;
        std::memcpy(out + op, in + ip, lit);
        ip += lit;
        op += lit;
        if (ip >= clen) break;  // terminal sequence carries no match
        if (ip + 2 > clen) return (size_t)-1;
        uint16_t off;
        std::memcpy(&off, in + ip, 2);
        ip += 2;
        if (off == 0 || off > op) return (size_t)-1;
        size_t mlen = (token & 15) + 4;
        if ((token & 15) == 15) {
            uint8_t b;
            do {
                if (ip >= clen) return (size_t)-1;
                b = in[ip++];
                mlen += b;
            } while (b == 255);
        }
        if (op + mlen > n) return (size_t)-1;
        // byte-wise copy: offsets < mlen self-overlap by design
        for (size_t i = 0; i < mlen; i++) out[op + i] = out[op - off + i];
        op += mlen;
    }
    return op;
}

}  // extern "C"

// --- MPC: massively parallel compressor (CPU reimplementation) --------------
//
// MPC (Yang, Mukka, Hesaaraki & Burtscher, "MPC: A Massively Parallel
// Compression Algorithm for Scientific Data", CLUSTER 2015) is the
// LnVs|BIT|LVs|ZE pipeline the reference benchmarks as a CUDA competitor
// (benchmark.cc "mpc", dimensionality 1): per 1024-value subchunk, a
// dim-stride value delta, a 32x32 (fp32) / 64x64 (fp64) bit transpose per
// warp-group, a lag-1 delta over the transposed words, and zero-word
// elimination into a ballot bitmap plus compacted nonzero words.  This is
// an independent serial implementation of that pipeline with our own
// container (u32 header [dim, n_lo, n_hi], input zero-padded to a whole
// subchunk; the author kernel's inter-block busy-wait offset relay is a
// GPU scheduling artifact with no bitstream meaning):
//   mpc_bound32(n) / mpc_bound64(n)           -> worst-case words
//   mpc_compress32/64(in, n, out, dim)        -> words written
//   mpc_decompress32/64(in, clen, out, n, dim) -> values decoded
// `dim` (1..32) is the published tunable; the reference benches dim = 1.

namespace {

constexpr size_t MPC_SUB = 1024;

// bit-matrix transpose, MSB-first orientation (butterfly); MPC's warp
// transpose is the LSB-first flip, obtained by reversing in and out.
template <typename B> inline void mpc_butterfly(B* a) {
    constexpr int W = int(sizeof(B) * 8);
    B m = B(~B{0}) >> (W / 2);
    for (int j = W / 2; j; j >>= 1) {
        for (int k = 0; k < W; k = (k + j + 1) & ~j) {
            B t = B(a[k] ^ (a[k + j] >> j)) & m;
            a[k] = B(a[k] ^ t);
            a[k + j] = B(a[k + j] ^ (t << j));
        }
        if (j > 1) m = B(m ^ (m << (j >> 1)));
    }
}

template <typename B> inline void mpc_transpose_group(B* a) {
    constexpr int W = int(sizeof(B) * 8);
    std::reverse(a, a + W);
    mpc_butterfly(a);
    std::reverse(a, a + W);
}

template <typename B>
size_t mpc_compress_impl(const B* in, size_t n, uint32_t* out32, int dim) {
    if (dim < 1 || dim > 32) return (size_t)-1;
    constexpr int W = int(sizeof(B) * 8);
    size_t np = (n + MPC_SUB - 1) / MPC_SUB * MPC_SUB;
    size_t nbm = np / W;  // one B-width bitmap word per W values
    out32[0] = uint32_t(dim);
    out32[1] = uint32_t(n & 0xffffffffu);
    out32[2] = uint32_t(n >> 32);
    out32[3] = 0;  // alignment pad: keep the emitted stream deterministic
    B* bitmaps = reinterpret_cast<B*>(out32 + 4);
    B* body = bitmaps + nbm;
    size_t wpos = 0;
    std::vector<B> w(MPC_SUB);
    for (size_t base = 0; base < np; base += MPC_SUB) {
        size_t live = std::min(MPC_SUB, n > base ? n - base : 0);
        std::memcpy(w.data(), in + base, live * sizeof(B));
        std::memset(w.data() + live, 0, (MPC_SUB - live) * sizeof(B));
        for (size_t i = MPC_SUB - 1; i >= size_t(dim); --i)
            w[i] = B(w[i] - w[i - dim]);
        for (size_t g = 0; g < MPC_SUB; g += W) mpc_transpose_group(w.data() + g);
        for (size_t i = MPC_SUB - 1; i >= 1; --i) w[i] = B(w[i] - w[i - 1]);
        for (size_t g = 0; g < MPC_SUB; g += W) {
            B bm = 0;
            for (int l = 0; l < W; ++l)
                if (w[g + l] != 0) bm |= B{1} << l;
            bitmaps[(base + g) / W] = bm;
            for (int l = 0; l < W; ++l)
                if (w[g + l] != 0) body[wpos++] = w[g + l];
        }
    }
    // words written, in u32 units
    return 4 + (nbm + wpos) * (sizeof(B) / 4);
}

template <typename B>
size_t mpc_decompress_impl(const uint32_t* in32, size_t clen32, B* out,
                           size_t n, int dim) {
    if (dim < 1 || dim > 32) return (size_t)-1;
    constexpr int W = int(sizeof(B) * 8);
    size_t np = (n + MPC_SUB - 1) / MPC_SUB * MPC_SUB;
    size_t nbm = np / W;
    if (clen32 < 4 + nbm * (sizeof(B) / 4)) return (size_t)-1;
    if (in32[0] != uint32_t(dim)) return (size_t)-1;
    if ((uint64_t(in32[2]) << 32 | in32[1]) != n) return (size_t)-1;
    const B* bitmaps = reinterpret_cast<const B*>(in32 + 4);
    const B* body = bitmaps + nbm;
    size_t body_max = (clen32 - 4) / (sizeof(B) / 4) - nbm;
    size_t rpos = 0;
    std::vector<B> w(MPC_SUB);
    for (size_t base = 0; base < np; base += MPC_SUB) {
        for (size_t g = 0; g < MPC_SUB; g += W) {
            B bm = bitmaps[(base + g) / W];
            for (int l = 0; l < W; ++l) {
                if ((bm >> l) & B{1}) {
                    if (rpos >= body_max) return (size_t)-1;
                    w[g + l] = body[rpos++];
                } else {
                    w[g + l] = 0;
                }
            }
        }
        for (size_t i = 1; i < MPC_SUB; ++i) w[i] = B(w[i] + w[i - 1]);
        for (size_t g = 0; g < MPC_SUB; g += W) mpc_transpose_group(w.data() + g);
        for (size_t i = dim; i < MPC_SUB; ++i) w[i] = B(w[i] + w[i - dim]);
        size_t live = std::min(MPC_SUB, n > base ? n - base : 0);
        std::memcpy(out + base, w.data(), live * sizeof(B));
    }
    return n;
}

}  // namespace

extern "C" {

size_t mpc_bound32(size_t n) {
    size_t np = (n + MPC_SUB - 1) / MPC_SUB * MPC_SUB;
    return 4 + np / 32 + np + 16;
}

size_t mpc_bound64(size_t n) {
    size_t np = (n + MPC_SUB - 1) / MPC_SUB * MPC_SUB;
    return 4 + (np / 64 + np) * 2 + 16;
}

size_t mpc_compress32(const uint32_t* in, size_t n, uint32_t* out, int dim) {
    return mpc_compress_impl<uint32_t>(in, n, out, dim);
}

size_t mpc_decompress32(const uint32_t* in, size_t clen, uint32_t* out,
                        size_t n, int dim) {
    return mpc_decompress_impl<uint32_t>(in, clen, out, n, dim);
}

size_t mpc_compress64(const uint64_t* in, size_t n, uint32_t* out, int dim) {
    return mpc_compress_impl<uint64_t>(in, n, out, dim);
}

size_t mpc_decompress64(const uint32_t* in, size_t clen, uint64_t* out,
                        size_t n, int dim) {
    return mpc_decompress_impl<uint64_t>(in, clen, out, n, dim);
}

}  // extern "C"

// --- GFC: GPU float compressor for doubles (CPU reimplementation) ----------
//
// GFC (O'Neil & Burtscher, "Floating-Point Data Compression at 75 Gb/s on
// a GPU", GPGPU-4 2011) is a doubles-only CUDA competitor the reference
// benchmarks as "gfc" (benchmark.cc:1225).  Per 32-value subchunk each
// value is predicted by the last same-phase (mod dim) value of the
// previous subchunk; the residual is sign-magnitude coded as a half-byte
// (sign bit | adjusted significant-byte count, with count 2 folded into 3
// so the nibble spans 0..7 for up to 8 bytes) followed by the magnitude's
// significant bytes LSB-first.  Independent serial implementation, own
// container (u32 header [dim, n_lo, n_hi], input zero-padded to a whole
// subchunk; the author's chunk cut table is a GPU work-division artifact):
//   gfc_bound(n)                          -> worst-case bytes
//   gfc_compress(in, n, out, dim)         -> bytes written
//   gfc_decompress(in, clen, out, n, dim) -> values decoded
// `dim` (1..32) is the published dimensionality tunable; default 1.

namespace {

constexpr size_t GFC_SUB = 32;

inline int gfc_byte_count(uint64_t mag) {
    if (mag == 0) return 0;
    int b = 8 - (__builtin_clzll(mag) >> 3);
    return b == 2 ? 3 : b;  // 6 lead-zero bytes fold into the 5-byte code
}

}  // namespace

extern "C" {

size_t gfc_bound(size_t n) {
    size_t np = (n + GFC_SUB - 1) / GFC_SUB * GFC_SUB;
    return 12 + np / 2 + np * 8 + 16;
}

size_t gfc_compress(const double* in, size_t n, uint8_t* out, int dim) {
    if (dim < 1 || dim > 32) return (size_t)-1;
    size_t np = (n + GFC_SUB - 1) / GFC_SUB * GFC_SUB;
    uint32_t hdr[3] = {uint32_t(dim), uint32_t(n & 0xffffffffu),
                       uint32_t(n >> 32)};
    std::memcpy(out, hdr, 12);
    size_t off = 12;
    std::vector<uint64_t> w(np, 0);
    std::memcpy(w.data(), in, n * sizeof(double));
    for (size_t base = 0; base < np; base += GFC_SUB) {
        uint8_t* codes = out + off;
        std::memset(codes, 0, GFC_SUB / 2);
        size_t dpos = off + GFC_SUB / 2;
        for (size_t l = 0; l < GFC_SUB; ++l) {
            uint64_t pred = base == 0 ? 0 : w[base - dim + (l % dim)];
            uint64_t diff = w[base + l] - pred;
            int sign = int(diff >> 63);
            uint64_t mag = sign ? ~diff + 1 : diff;
            int bc = gfc_byte_count(mag);
            for (int b = 0; b < bc; ++b) {
                out[dpos++] = uint8_t(mag);
                mag >>= 8;
            }
            int code = (sign << 3) | (bc >= 3 ? bc - 1 : bc);
            codes[l >> 1] |= uint8_t(code << ((l & 1) * 4));
        }
        off = dpos;
    }
    return off;
}

size_t gfc_decompress(const uint8_t* in, size_t clen, double* out, size_t n,
                      int dim) {
    if (dim < 1 || dim > 32) return (size_t)-1;
    if (clen < 12) return (size_t)-1;
    uint32_t hdr[3];
    std::memcpy(hdr, in, 12);
    if (hdr[0] != uint32_t(dim) ||
        (uint64_t(hdr[2]) << 32 | hdr[1]) != n)
        return (size_t)-1;
    size_t np = (n + GFC_SUB - 1) / GFC_SUB * GFC_SUB;
    std::vector<uint64_t> w(np, 0);
    size_t off = 12;
    for (size_t base = 0; base < np; base += GFC_SUB) {
        if (off + GFC_SUB / 2 > clen) return (size_t)-1;
        const uint8_t* codes = in + off;
        size_t dpos = off + GFC_SUB / 2;
        for (size_t l = 0; l < GFC_SUB; ++l) {
            int code = (codes[l >> 1] >> ((l & 1) * 4)) & 0xf;
            int c = code & 7;
            int bc = c <= 1 ? c : c + 1;
            if (dpos + bc > clen) return (size_t)-1;
            uint64_t mag = 0;
            for (int b = bc - 1; b >= 0; --b) mag = (mag << 8) | in[dpos + b];
            dpos += bc;
            uint64_t diff = (code & 8) ? ~mag + 1 : mag;
            uint64_t pred = base == 0 ? 0 : w[base - dim + (l % dim)];
            w[base + l] = pred + diff;
        }
        off = dpos;
    }
    std::memcpy(out, w.data(), n * sizeof(double));
    return n;
}

}  // extern "C"

// --- Cascaded (nvCOMP scheme): RLE / delta / bit-pack layers ----------------
//
// The reference benchmarks nvCOMP's Cascaded compressor ("nvcomp-cascaded",
// benchmark.cc:1033-1057) configured as {num_RLEs, num_deltas, use_bp} —
// default {1,0,1}, or an auto-tune sweep that picks the smallest output.
// nvCOMP itself is CUDA-only (and an empty submodule stub in the reference
// checkout); this is an independent serial implementation of the published
// scheme: R layers of run-length splitting (values/run-lengths), D delta
// layers, and frame-of-reference bit-packing of every residual array, with
// our own recursive container.  Elements are the value's integer bits
// (u32 for fp32, u64 for fp64, as the reference configures NVCOMP_TYPE):
//   ncc_bound(n_elems, elem_bytes)            -> worst-case bytes
//   ncc_compress(in, n, elem_bytes, out, cfg) -> bytes written
//   ncc_decompress(in, clen, out, n, elem_bytes) -> values decoded
// cfg: 0 auto-tunes over the (R,D,bp) grid like the reference's selector;
// otherwise cfg = R*100 + D*10 + bp (e.g. 101 = nvCOMP's default).

namespace {

struct NccSink {
    std::vector<uint8_t> v;
    void bytes(const void* p, size_t n) {
        const uint8_t* b = static_cast<const uint8_t*>(p);
        v.insert(v.end(), b, b + n);
    }
    void u8(uint8_t x) { v.push_back(x); }
    void u64(uint64_t x) { bytes(&x, 8); }
};

struct NccSrc {
    const uint8_t* p;
    size_t len, pos = 0;
    bool bytes(void* out, size_t n) {
        if (pos + n > len) return false;
        std::memcpy(out, p + pos, n);
        pos += n;
        return true;
    }
    bool u8(uint8_t& x) { return bytes(&x, 1); }
    bool u64(uint64_t& x) { return bytes(&x, 8); }
};

void ncc_bitpack(const std::vector<uint64_t>& x, NccSink& out) {
    out.u64(x.size());
    if (x.empty()) return;
    int64_t mn = INT64_MAX, mx = INT64_MIN;
    for (uint64_t u : x) {
        int64_t s = int64_t(u);
        mn = std::min(mn, s);
        mx = std::max(mx, s);
    }
    uint64_t range = uint64_t(mx) - uint64_t(mn);
    int bits = range ? 64 - __builtin_clzll(range) : 0;
    out.u8(uint8_t(bits));
    out.u64(uint64_t(mn));
    uint64_t acc = 0;
    int fill = 0;
    for (uint64_t u : x) {
        uint64_t d = u - uint64_t(mn);
        if (bits == 64) {
            out.u64(d);
            continue;
        }
        acc |= d << fill;
        fill += bits;
        if (fill >= 64) {
            out.u64(acc);
            fill -= 64;
            acc = fill ? d >> (bits - fill) : 0;
        }
    }
    if (bits != 64 && fill) out.u64(acc);
}

bool ncc_bitunpack(NccSrc& in, std::vector<uint64_t>& x) {
    uint64_t n;
    if (!in.u64(n)) return false;
    x.assign(size_t(n), 0);
    if (!n) return true;
    uint8_t bits;
    uint64_t mn;
    if (!in.u8(bits) || !in.u64(mn)) return false;
    if (bits > 64) return false;
    if (bits == 64) {
        for (size_t i = 0; i < n; ++i)
            if (!in.u64(x[i])) return false;
        for (size_t i = 0; i < n; ++i) x[i] += mn;
        return true;
    }
    if (bits == 0) {
        for (size_t i = 0; i < n; ++i) x[i] = mn;
        return true;
    }
    // positional extraction over the contiguous packed words (value i
    // occupies bits [i*bits, i*bits+bits) LSB-first)
    size_t nwords = (n * size_t(bits) + 63) / 64;
    if (in.pos + nwords * 8 > in.len) return false;
    const uint8_t* base = in.p + in.pos;
    in.pos += nwords * 8;
    uint64_t mask = ~uint64_t(0) >> (64 - bits);
    for (size_t i = 0; i < n; ++i) {
        size_t bitpos = i * size_t(bits);
        size_t w0 = bitpos >> 6;
        int shift = int(bitpos & 63);
        uint64_t lo, hi = 0;
        std::memcpy(&lo, base + w0 * 8, 8);
        uint64_t v = lo >> shift;
        if (shift + bits > 64) {
            std::memcpy(&hi, base + (w0 + 1) * 8, 8);
            v |= hi << (64 - shift);
        }
        x[i] = (v & mask) + mn;
    }
    return true;
}

void ncc_encode_node(std::vector<uint64_t> x, int R, int D, int bp,
                     NccSink& out) {
    if (R > 0) {
        std::vector<uint64_t> vals, runs;
        size_t i = 0;
        while (i < x.size()) {
            size_t j = i + 1;
            while (j < x.size() && x[j] == x[i]) ++j;
            vals.push_back(x[i]);
            runs.push_back(uint64_t(j - i));
            i = j;
        }
        ncc_encode_node(std::move(vals), R - 1, D, bp, out);
        ncc_encode_node(std::move(runs), 0, D, bp, out);
        return;
    }
    for (int d = 0; d < D; ++d)
        for (size_t i = x.size(); i-- > 1;) x[i] -= x[i - 1];
    if (bp) {
        ncc_bitpack(x, out);
    } else {
        out.u64(x.size());
        out.u8(65);  // sentinel: raw 8-byte words, no packing
        for (uint64_t u : x) out.u64(u);
    }
}

bool ncc_decode_node(NccSrc& in, int R, int D, int bp,
                     std::vector<uint64_t>& x) {
    if (R > 0) {
        std::vector<uint64_t> vals, runs;
        if (!ncc_decode_node(in, R - 1, D, bp, vals)) return false;
        if (!ncc_decode_node(in, 0, D, bp, runs)) return false;
        if (runs.size() != vals.size()) return false;
        x.clear();
        for (size_t i = 0; i < vals.size(); ++i) {
            if (runs[i] == 0 ||
                x.size() + runs[i] > (uint64_t(1) << 33))  // corrupt-input cap
                return false;
            x.insert(x.end(), size_t(runs[i]), vals[i]);
        }
        return true;
    }
    if (bp) {
        if (!ncc_bitunpack(in, x)) return false;
    } else {
        uint64_t n;
        uint8_t sentinel;
        if (!in.u64(n) || !in.u8(sentinel) || sentinel != 65) return false;
        x.assign(size_t(n), 0);
        for (size_t i = 0; i < n; ++i)
            if (!in.u64(x[i])) return false;
    }
    for (int d = 0; d < D; ++d)
        for (size_t i = 1; i < x.size(); ++i) x[i] += x[i - 1];
    return true;
}

size_t ncc_emit(const std::vector<uint64_t>& x, int R, int D, int bp,
                std::vector<uint8_t>& buf) {
    NccSink sink;
    ncc_encode_node(x, R, D, bp, sink);
    buf = std::move(sink.v);
    return buf.size();
}

}  // namespace

extern "C" {

size_t ncc_bound(size_t n, int elem_bytes) {
    // leaves store 8-byte words internally regardless of elem width; the
    // raw fallback is 8n + headers, and adversarial runs-leaves under
    // forced configs can exceed that — ncc_compress additionally checks
    // this capacity and fails rather than overflowing.
    (void)elem_bytes;
    return 64 + n * 12;
}

size_t ncc_compress(const void* in, size_t n, int elem_bytes, uint8_t* out,
                    int cfg) {
    const size_t cap = ncc_bound(n, elem_bytes);
    if (elem_bytes != 4 && elem_bytes != 8) return (size_t)-1;
    std::vector<uint64_t> x(n);
    if (elem_bytes == 4) {
        const uint32_t* p = static_cast<const uint32_t*>(in);
        for (size_t i = 0; i < n; ++i) x[i] = p[i];
    } else {
        std::memcpy(x.data(), in, n * 8);
    }
    static const int kGrid[] = {1, 11, 21, 101, 111, 121, 211, 221, 0};
    std::vector<uint8_t> best, cur;
    int best_cfg = -1;
    if (cfg == 0) {
        for (int c : kGrid) {
            int R = c / 100, D = c / 10 % 10, bp = c % 10;
            ncc_emit(x, R, D, bp, cur);
            if (best_cfg < 0 || cur.size() < best.size()) {
                best = cur;
                best_cfg = c;
            }
        }
    } else {
        best_cfg = cfg;
        ncc_emit(x, cfg / 100, cfg / 10 % 10, cfg % 10, best);
    }
    if (16 + best.size() > cap) return (size_t)-1;  // forced-cfg blowup
    uint32_t hdr[4] = {uint32_t(best_cfg), uint32_t(elem_bytes),
                       uint32_t(n & 0xffffffffu), uint32_t(n >> 32)};
    std::memcpy(out, hdr, 16);
    std::memcpy(out + 16, best.data(), best.size());
    return 16 + best.size();
}

size_t ncc_decompress(const uint8_t* in, size_t clen, void* out, size_t n,
                      int elem_bytes) {
    if (clen < 16) return (size_t)-1;
    uint32_t hdr[4];
    std::memcpy(hdr, in, 16);
    int cfg = int(hdr[0]);
    if (int(hdr[1]) != elem_bytes ||
        (uint64_t(hdr[3]) << 32 | hdr[2]) != n)
        return (size_t)-1;
    NccSrc src{in + 16, clen - 16};
    std::vector<uint64_t> x;
    if (!ncc_decode_node(src, cfg / 100, cfg / 10 % 10, cfg % 10, x))
        return (size_t)-1;
    if (x.size() != n) return (size_t)-1;
    if (elem_bytes == 4) {
        uint32_t* p = static_cast<uint32_t*>(out);
        for (size_t i = 0; i < n; ++i) p[i] = uint32_t(x[i]);
    } else {
        std::memcpy(out, x.data(), n * 8);
    }
    return n;
}

}  // extern "C"

// --- SPDP: synthesized byte-pipeline compressor ----------------------------
//
// Stream layout: u32 comp_bytes[nchunks] | concatenated per-chunk payloads,
// 8 MiB raw bytes per chunk with fresh pipeline state (the published
// block protocol), nchunks derived from the caller-supplied length.

namespace {

constexpr size_t SPDP_CHUNK = size_t(1) << 23;

inline size_t spdp_table_entries(int level) {
    if (level < 0) level = 0;
    if (level > 9) level = 9;
    size_t e = size_t(1) << (level + 9);
    return e > (size_t(1) << 18) ? (size_t(1) << 18) : e;
}

// Stage 1: 32-bit word delta at distance 2 (trailing non-word bytes pass
// through), then stage 2: stride-8 byte transpose fused with a byte delta
// whose predecessor runs across stripe boundaries.  src -> dst, len bytes.
void spdp_front_fwd(const uint8_t *src, uint8_t *dst, size_t len,
                    std::vector<uint8_t> &tmp) {
    tmp.resize(len);
    size_t nw = len / 4;
    uint32_t p2 = 0, p1 = 0;
    for (size_t i = 0; i < nw; i++) {
        uint32_t cur;
        std::memcpy(&cur, src + 4 * i, 4);
        uint32_t res = cur - p2;
        std::memcpy(tmp.data() + 4 * i, &res, 4);
        p2 = p1;
        p1 = cur;
    }
    for (size_t i = nw * 4; i < len; i++) tmp[i] = src[i];
    size_t w = 0;
    uint8_t prev = 0;
    for (size_t d = 0; d < 8; d++) {
        for (size_t r = d; r < len; r += 8) {
            dst[w++] = uint8_t(tmp[r] - prev);
            prev = tmp[r];
        }
    }
}

void spdp_front_inv(const uint8_t *src, uint8_t *dst, size_t len,
                    std::vector<uint8_t> &tmp) {
    tmp.resize(len);
    size_t r = 0;
    uint8_t acc = 0;
    for (size_t d = 0; d < 8; d++) {
        for (size_t w = d; w < len; w += 8) {
            acc = uint8_t(acc + src[r++]);
            tmp[w] = acc;
        }
    }
    size_t nw = len / 4;
    uint32_t p2 = 0, p1 = 0;
    for (size_t i = 0; i < nw; i++) {
        uint32_t res, cur;
        std::memcpy(&res, tmp.data() + 4 * i, 4);
        cur = res + p2;
        std::memcpy(dst + 4 * i, &cur, 4);
        p2 = p1;
        p1 = cur;
    }
    for (size_t i = nw * 4; i < len; i++) dst[i] = tmp[i];
}

// Stage 3 back-end: a table keyed by a shift-2/XOR history hash maps to the
// last position seen in that context; when the 6 bytes behind the predicted
// position match the 6 bytes behind the cursor, a run byte counting forward
// matches precedes the (always emitted) literal.  Encoder and decoder must
// advance the hash/table state identically per consumed byte.
struct spdp_hash {
    std::vector<uint32_t> last;
    uint32_t hist = 0, mask;

    explicit spdp_hash(int level)
        : last(spdp_table_entries(level), 0),
          mask(uint32_t(spdp_table_entries(level)) - 1) {}

    inline void step(uint8_t b, size_t pos) {
        last[hist] = uint32_t(pos);
        hist = ((hist << 2) ^ b) & mask;
    }
};

size_t spdp_back_fwd(const uint8_t *src, size_t len, uint8_t *dst,
                     int level) {
    spdp_hash h(level);
    size_t r = 0, w = 0;
    while (r < len) {
        size_t p = h.last[h.hist];
        if (p >= 6 && std::memcmp(src + p - 6, src + r - 6, 6) == 0) {
            uint8_t run = 0;
            while (run < 255 && r + 1 < len && src[r] == src[p]) {
                h.step(src[r], r);
                r++;
                p++;
                run++;
            }
            dst[w++] = run;
        }
        h.step(src[r], r);
        dst[w++] = src[r];
        r++;
    }
    return w;
}

size_t spdp_back_inv(const uint8_t *src, size_t clen, uint8_t *dst,
                     size_t max_out, int level) {
    spdp_hash h(level);
    size_t r = 0, w = 0;
    while (r < clen) {
        size_t p = h.last[h.hist];
        if (p >= 6 && std::memcmp(dst + p - 6, dst + w - 6, 6) == 0) {
            uint8_t run = src[r++];
            if (w + run > max_out || r >= clen) return (size_t)-1;
            for (uint8_t j = 0; j < run; j++) {
                uint8_t b = dst[w] = dst[p];
                h.step(b, w);
                w++;
                p++;
            }
        }
        if (w >= max_out) return (size_t)-1;
        uint8_t b = dst[w] = src[r++];
        h.step(b, w);
        w++;
    }
    return w;
}

}  // namespace

extern "C" {

size_t spdp_bound(size_t n) {
    size_t nchunks = (n + SPDP_CHUNK - 1) / SPDP_CHUNK;
    return nchunks * 4 + 2 * n + 64;
}

size_t spdp_compress(const uint8_t *in, size_t n, uint8_t *out, int level) {
    size_t nchunks = (n + SPDP_CHUNK - 1) / SPDP_CHUNK;
    uint8_t *payload = out + nchunks * 4;
    size_t wpos = 0;
    std::vector<uint8_t> front(std::min(n, SPDP_CHUNK)), tmp;
    for (size_t c = 0; c < nchunks; c++) {
        size_t lo = c * SPDP_CHUNK;
        size_t len = (lo + SPDP_CHUNK <= n) ? SPDP_CHUNK : n - lo;
        spdp_front_fwd(in + lo, front.data(), len, tmp);
        size_t csize = spdp_back_fwd(front.data(), len, payload + wpos, level);
        uint32_t rec = uint32_t(csize);
        std::memcpy(out + c * 4, &rec, 4);
        wpos += csize;
    }
    return nchunks * 4 + wpos;
}

size_t spdp_decompress(const uint8_t *in, size_t comp_len, uint8_t *out,
                       size_t n, int level) {
    size_t nchunks = (n + SPDP_CHUNK - 1) / SPDP_CHUNK;
    if (comp_len < nchunks * 4) return (size_t)-1;
    const uint8_t *payload = in + nchunks * 4;
    size_t avail = comp_len - nchunks * 4;
    size_t rpos = 0;
    std::vector<uint8_t> front(std::min(n, SPDP_CHUNK)), tmp;
    for (size_t c = 0; c < nchunks; c++) {
        size_t lo = c * SPDP_CHUNK;
        size_t len = (lo + SPDP_CHUNK <= n) ? SPDP_CHUNK : n - lo;
        uint32_t csize;
        std::memcpy(&csize, in + c * 4, 4);
        if (rpos + csize > avail) return (size_t)-1;
        size_t got = spdp_back_inv(payload + rpos, csize, front.data(), len,
                                   level);
        if (got != len) return (size_t)-1;
        spdp_front_inv(front.data(), out + lo, len, tmp);
        rpos += csize;
    }
    return n;
}

}  // extern "C"
