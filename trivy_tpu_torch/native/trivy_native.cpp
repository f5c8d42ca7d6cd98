// Host-side native helpers of the port, loaded through ctypes by
// trivy_tpu_torch/native/__init__.py:
//
//   - fnv1a64_batch: the detector's join keys, hash64(source + "\0" +
//     name), for the keys it has not hashed before (detect/engine.py);
//   - lower_pack_chunks: lowercasing + fixed-size overlapped chunking of
//     secret-scan candidate files into the [B, L] uint8 rows the shift-or
//     kernel scans (ops/ac.py pack_chunks; the reference lowercases per
//     rule per file, pkg/fanal/secret/scanner.go:170);
//   - contains_lower: a case-insensitive substring test.
//
// Build: c++ -O3 -shared -fPIC -std=c++17, on first use, by the loader.
// No dependencies beyond the C++ standard library.

#include <cstdint>
#include <cstring>

extern "C" {

// Hash n byte strings (concatenated in `data`, string i spanning
// [offsets[i], offsets[i+1])) with FNV-1a 64-bit into out[n].
void fnv1a64_batch(const uint8_t* data, const int64_t* offsets, int64_t n,
                   uint64_t* out) {
    const uint64_t kOffset = 0xCBF29CE484222325ULL;
    const uint64_t kPrime = 0x100000001B3ULL;
    for (int64_t i = 0; i < n; ++i) {
        uint64_t h = kOffset;
        const uint8_t* p = data + offsets[i];
        const uint8_t* end = data + offsets[i + 1];
        for (; p != end; ++p) {
            h ^= static_cast<uint64_t>(*p);
            h *= kPrime;
        }
        out[i] = h;
    }
}

// Lowercase `len` bytes of `data` and pack them into chunks of
// `chunk_len` with `overlap` bytes of overlap (stride chunk_len -
// overlap), zero-padding the tail. `out` must hold max_chunks*chunk_len
// bytes. Returns the number of chunks written via n_chunks.
void lower_pack_chunks(const uint8_t* data, int64_t len, int32_t chunk_len,
                       int32_t overlap, uint8_t* out, int32_t max_chunks,
                       int32_t* n_chunks) {
    int32_t stride = chunk_len - overlap;
    if (stride < 1) stride = 1;
    int32_t count = 0;
    for (int64_t off = 0; off < len && count < max_chunks; off += stride) {
        // Skip the final stride only when the previous chunk really
        // covers the remaining tail: it spans [off - stride, off -
        // stride + chunk_len), which reaches chunk_len - stride past
        // `off` — equal to `overlap` only while the stride is
        // unclamped (overlap >= chunk_len clamps it to 1).
        if (off > 0 && len - off <= chunk_len - stride) break;
        int64_t piece = len - off;
        if (piece > chunk_len) piece = chunk_len;
        uint8_t* dst = out + static_cast<int64_t>(count) * chunk_len;
        for (int64_t j = 0; j < piece; ++j) {
            uint8_t c = data[off + j];
            dst[j] = (c >= 'A' && c <= 'Z') ? c + 32 : c;
        }
        if (piece < chunk_len) {
            memset(dst + piece, 0, chunk_len - piece);
        }
        ++count;
        if (off + chunk_len >= len) break;
    }
    *n_chunks = count;
}

// Case-insensitive memmem: returns 1 if needle (already lowercase)
// occurs in haystack (lowercased on the fly).
int32_t contains_lower(const uint8_t* hay, int64_t hay_len,
                       const uint8_t* needle, int64_t needle_len) {
    if (needle_len == 0) return 1;
    if (needle_len > hay_len) return 0;
    uint8_t first = needle[0];
    for (int64_t i = 0; i + needle_len <= hay_len; ++i) {
        uint8_t c = hay[i];
        if (c >= 'A' && c <= 'Z') c += 32;
        if (c != first) continue;
        int64_t j = 1;
        for (; j < needle_len; ++j) {
            uint8_t h = hay[i + j];
            if (h >= 'A' && h <= 'Z') h += 32;
            if (h != needle[j]) break;
        }
        if (j == needle_len) return 1;
    }
    return 0;
}

}  // extern "C"
