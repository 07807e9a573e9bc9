// Host codec of elasticsearch_tpu_torch: varint/zigzag integer compression,
// delta coding for sorted postings, and CRC32 for blob section checksums.
// A copy of the JAX package's native/codec.cpp: both packages encode the
// same bytes, so a store blob written by either loads in the other.
//
// Reference counterpart: Lucene's on-disk codecs used by the Java reference
// (oal.store.DataOutput#writeVInt / ForUtil PForDelta postings blocks) and
// the translog checksum (org.elasticsearch.index.translog's
// BufferedChecksumStreamOutput, CRC32). This is the hot byte-bashing path
// that does not belong in Python; device scoring never touches it.
//
// C ABI only — bound from Python with ctypes (no pybind11 in this image).
// All sizes are uint64. Encode buffers must be >= 10*n bytes (worst case
// one varint per value). Decoders are hardened against truncated input:
// they stop and return the count decoded so far, never read past `len`.

#include <cstdint>
#include <cstddef>

extern "C" {

// ---------------------------------------------------------------------------
// CRC32 (IEEE 802.3 polynomial, same as zlib.crc32 — the Java reference's
// java.util.zip.CRC32). Table generated at first use.
// ---------------------------------------------------------------------------

static uint32_t crc_table[256];
static bool crc_ready = false;

static void crc_init() {
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[i] = c;
    }
    crc_ready = true;
}

uint32_t et_crc32(const uint8_t* buf, uint64_t len, uint32_t seed) {
    if (!crc_ready) crc_init();
    uint32_t c = seed ^ 0xFFFFFFFFu;
    for (uint64_t i = 0; i < len; i++)
        c = crc_table[(c ^ buf[i]) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

// ---------------------------------------------------------------------------
// zigzag varint (LEB128) for int64 — Lucene writeVLong/zigzag equivalents
// ---------------------------------------------------------------------------

static inline uint64_t zigzag(int64_t v) {
    return (static_cast<uint64_t>(v) << 1) ^ static_cast<uint64_t>(v >> 63);
}

static inline int64_t unzigzag(uint64_t u) {
    return static_cast<int64_t>(u >> 1) ^ -static_cast<int64_t>(u & 1);
}

static inline uint8_t* put_varint(uint8_t* out, uint64_t u) {
    while (u >= 0x80) {
        *out++ = static_cast<uint8_t>(u) | 0x80;
        u >>= 7;
    }
    *out++ = static_cast<uint8_t>(u);
    return out;
}

// returns bytes written
uint64_t et_vbyte_encode(const int64_t* in, uint64_t n, uint8_t* out) {
    uint8_t* p = out;
    for (uint64_t i = 0; i < n; i++)
        p = put_varint(p, zigzag(in[i]));
    return static_cast<uint64_t>(p - out);
}

// returns values decoded (stops at max_n or on truncated input)
uint64_t et_vbyte_decode(const uint8_t* in, uint64_t len, int64_t* out,
                         uint64_t max_n) {
    const uint8_t* p = in;
    const uint8_t* end = in + len;
    uint64_t count = 0;
    while (count < max_n && p < end) {
        uint64_t u = 0;
        int shift = 0;
        bool done = false;
        while (p < end && shift < 64) {
            uint8_t b = *p++;
            u |= static_cast<uint64_t>(b & 0x7F) << shift;
            if (!(b & 0x80)) { done = true; break; }
            shift += 7;
        }
        if (!done) break;  // truncated varint: stop cleanly
        out[count++] = unzigzag(u);
    }
    return count;
}

// ---------------------------------------------------------------------------
// delta coding for sorted sequences (postings doc ids): first value as-is,
// then gaps — gaps are small, so varints shrink hard (the PForDelta idea
// without the SIMD block layout; block packing is the R3 upgrade)
// ---------------------------------------------------------------------------

uint64_t et_delta_encode(const int64_t* in, uint64_t n, uint8_t* out) {
    uint8_t* p = out;
    int64_t prev = 0;
    for (uint64_t i = 0; i < n; i++) {
        p = put_varint(p, zigzag(in[i] - prev));
        prev = in[i];
    }
    return static_cast<uint64_t>(p - out);
}

uint64_t et_delta_decode(const uint8_t* in, uint64_t len, int64_t* out,
                         uint64_t max_n) {
    uint64_t n = et_vbyte_decode(in, len, out, max_n);
    int64_t prev = 0;
    for (uint64_t i = 0; i < n; i++) {
        prev += out[i];
        out[i] = prev;
    }
    return n;
}

}  // extern "C"
