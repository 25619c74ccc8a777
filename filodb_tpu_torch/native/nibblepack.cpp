// NibblePack codec — native implementation of the interchange bit format
// (reference: memory/src/main/scala/filodb.memory/format/NibblePack.scala:12,
// spec doc/compression.md "Predictive NibblePacking"; bit-compatible with
// filodb_tpu/memory/nibblepack.py, which is the behavioral oracle).
//
// This is the ⚙ "native layer" SURVEY §2.1 calls for: the per-sample encode
// loops on the ingest/flush hot path run here instead of the Python
// interpreter. Exposed as a plain C ABI for ctypes (no pybind11 in the
// image); all little-endian (TPU hosts are x86/ARM LE).
//
// Build: g++ -O3 -shared -fPIC -o _nibblepack.so nibblepack.cpp
// (done on demand by filodb_tpu/native/__init__.py).

#include <cstdint>
#include <cstring>

namespace {

inline int nlz64(uint64_t x) { return x ? __builtin_clzll(x) : 64; }
inline int ntz64(uint64_t x) { return x ? __builtin_ctzll(x) : 64; }

struct Writer {
    uint8_t* p;
    long pos;
};

// NibblePack.scala:105 pack8 — one 8-word group.
void pack8(const uint64_t* words, Writer& w) {
    uint8_t bitmask = 0;
    for (int i = 0; i < 8; i++)
        if (words[i]) bitmask |= (uint8_t)(1u << i);
    w.p[w.pos++] = bitmask;
    if (!bitmask) return;

    int min_lz = 64, min_tz = 64;
    for (int i = 0; i < 8; i++) {
        uint64_t v = words[i];
        int lz = nlz64(v), tz = ntz64(v);
        if (lz < min_lz) min_lz = lz;
        if (tz < min_tz) min_tz = tz;
    }
    int trailing_nibbles = min_tz / 4;
    int num_nibbles = 16 - min_lz / 4 - trailing_nibbles;
    w.p[w.pos++] =
        (uint8_t)(((num_nibbles - 1) << 4) | trailing_nibbles);

    int trailing_shift = trailing_nibbles * 4;
    int num_bits = num_nibbles * 4;
    uint64_t out_word = 0;
    int bit_cursor = 0;   // always in [0, 63]
    for (int i = 0; i < 8; i++) {
        uint64_t v = words[i];
        if (!v) continue;
        int remaining = 64 - bit_cursor;
        uint64_t shifted = v >> trailing_shift;
        out_word |= shifted << bit_cursor;
        if (remaining <= num_bits) {
            std::memcpy(w.p + w.pos, &out_word, 8);
            w.pos += 8;
            out_word = (remaining < num_bits) ? (shifted >> remaining) : 0;
        }
        bit_cursor = (bit_cursor + num_bits) % 64;
    }
    if (bit_cursor > 0) {
        int nb = (bit_cursor + 7) / 8;
        std::memcpy(w.p + w.pos, &out_word, nb);
        w.pos += nb;
    }
}

// NibblePack.scala:373 unpack8. Returns new pos, or -1 on short input.
inline uint64_t read_word(const uint8_t* buf, long n, long idx) {
    uint64_t v = 0;
    long take = (idx + 8 <= n) ? 8 : (idx < n ? n - idx : 0);
    if (take > 0) std::memcpy(&v, buf + idx, (size_t)take);
    return v;
}

long unpack8(const uint8_t* buf, long n, long pos, uint64_t* out) {
    if (pos >= n) return -1;
    uint8_t bitmask = buf[pos];
    if (!bitmask) {
        for (int i = 0; i < 8; i++) out[i] = 0;
        return pos + 1;
    }
    if (pos + 1 >= n) return -1;
    uint8_t nib = buf[pos + 1];
    int num_bits = ((nib >> 4) + 1) * 4;
    int trailing_zeroes = (nib & 0x0F) * 4;   // <= 60
    long total_bytes =
        2 + (num_bits * __builtin_popcount(bitmask) + 7) / 8;
    uint64_t mask =
        (num_bits >= 64) ? ~0ULL : ((1ULL << num_bits) - 1);
    long buf_index = pos + 2;
    int bit_cursor = 0;
    uint64_t in_word = read_word(buf, n, buf_index);
    buf_index += 8;
    for (int bit = 0; bit < 8; bit++) {
        if (bitmask & (1u << bit)) {
            int remaining = 64 - bit_cursor;
            uint64_t out_word = (in_word >> bit_cursor) & mask;
            if (remaining <= num_bits && (buf_index - pos) < total_bytes) {
                if (buf_index < n) {
                    in_word = read_word(buf, n, buf_index);
                    buf_index += 8;
                    if (remaining < num_bits)
                        out_word |= (in_word << remaining) & mask;
                } else {
                    return -1;
                }
            }
            out[bit] = out_word << trailing_zeroes;
            bit_cursor = (bit_cursor + num_bits) % 64;
        } else {
            out[bit] = 0;
        }
    }
    return pos + total_bytes;
}

}  // namespace

extern "C" {

// Each packer returns bytes written. Caller sizes `out` for the worst
// case: ceil(n/8) groups * 66 bytes (+8 for the doubles header).

long np_pack_non_increasing(const uint64_t* vals, long n, uint8_t* out) {
    Writer w{out, 0};
    uint64_t group[8];
    long i = 0;
    for (; i + 8 <= n; i += 8) {
        std::memcpy(group, vals + i, 64);
        pack8(group, w);
    }
    if (i < n) {
        for (int j = 0; j < 8; j++)
            group[j] = (i + j < n) ? vals[i + j] : 0;
        pack8(group, w);
    }
    return w.pos;
}

// NibblePack.scala:37 packDelta (negative deltas clamp to 0).
long np_pack_delta(const int64_t* vals, long n, uint8_t* out) {
    Writer w{out, 0};
    uint64_t group[8];
    int64_t last = 0;
    int k = 0;
    for (long i = 0; i < n; i++) {
        int64_t v = vals[i];
        group[k] = (v >= last) ? (uint64_t)(v - last) : 0;
        last = v;
        if (++k == 8) { pack8(group, w); k = 0; }
    }
    if (k) {
        for (; k < 8; k++) group[k] = 0;
        pack8(group, w);
    }
    return w.pos;
}

// NibblePack.scala:70 packDoubles: first value raw LE, rest XOR deltas.
long np_pack_doubles(const double* vals, long n, uint8_t* out) {
    if (n <= 0) return -1;
    Writer w{out, 0};
    std::memcpy(w.p, vals, 8);
    w.pos = 8;
    uint64_t group[8];
    uint64_t last;
    std::memcpy(&last, vals, 8);
    int k = 0;
    for (long i = 1; i < n; i++) {
        uint64_t b;
        std::memcpy(&b, vals + i, 8);
        group[k] = b ^ last;
        last = b;
        if (++k == 8) { pack8(group, w); k = 0; }
    }
    if (k) {
        for (; k < 8; k++) group[k] = 0;
        pack8(group, w);
    }
    return w.pos;
}

// Raw u64 words out. Returns new position, or -1 on short input.
long np_unpack_words(const uint8_t* buf, long buflen, long pos, long n,
                     uint64_t* out) {
    uint64_t group[8];
    long left = n;
    uint64_t* o = out;
    while (left > 0) {
        pos = unpack8(buf, buflen, pos, group);
        if (pos < 0) return -1;
        long take = left < 8 ? left : 8;
        std::memcpy(o, group, (size_t)take * 8);
        o += take;
        left -= take;
    }
    return pos;
}

// DeltaSink (NibblePack.scala:205): running sum of deltas.
long np_unpack_delta(const uint8_t* buf, long buflen, long pos, long n,
                     int64_t* out) {
    uint64_t group[8];
    int64_t acc = 0;
    long left = n, oi = 0;
    while (left > 0) {
        pos = unpack8(buf, buflen, pos, group);
        if (pos < 0) return -1;
        long take = left < 8 ? left : 8;
        for (long j = 0; j < take; j++) {
            acc += (int64_t)group[j];
            out[oi++] = acc;
        }
        left -= take;
    }
    return pos;
}

// DoubleXORSink (NibblePack.scala:225/:352): first raw, rest XOR chain.
long np_unpack_double_xor(const uint8_t* buf, long buflen, long pos,
                          long n, double* out) {
    if (n <= 0 || buflen - pos < 8) return -1;
    uint64_t bits;
    std::memcpy(&bits, buf + pos, 8);
    pos += 8;
    std::memcpy(out, &bits, 8);
    uint64_t group[8];
    long left = n - 1, oi = 1;
    while (left > 0) {
        pos = unpack8(buf, buflen, pos, group);
        if (pos < 0) return -1;
        long take = left < 8 ? left : 8;
        for (long j = 0; j < take; j++) {
            bits ^= group[j];
            std::memcpy(out + oi, &bits, 8);
            oi++;
        }
        left -= take;
    }
    return pos;
}

}  // extern "C"
