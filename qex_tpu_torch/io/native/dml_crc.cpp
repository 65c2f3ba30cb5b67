// Host DML checksum codec for SciDAC lattice I/O (a copy of the JAX
// package's io/native/dml_crc.cpp; the port carries its own so that it
// loads nothing of that package).
//
// Per-site CRC32 over the binary payload combined with the QIO
// rank-rotation rule
//     suma ^= rotl32(crc_r, r % 29);  sumb ^= rotl32(crc_r, r % 31).
//
// A host checksum, not a device kernel.  Built on first use by
// qex_tpu_torch/io/native.py with
//     g++ -O3 -shared -fPIC dml_crc.cpp -o build/qex_tpu_torch/libdmlcrc-<hash>.so
// and reached through ctypes.

#include <cstdint>
#include <cstddef>

namespace {

uint32_t crc_table[8][256];
bool table_init = false;

void init_table() {
    if (table_init) return;
    for (uint32_t i = 0; i < 256; i++) {
        uint32_t c = i;
        for (int k = 0; k < 8; k++)
            c = (c & 1) ? 0xEDB88320u ^ (c >> 1) : c >> 1;
        crc_table[0][i] = c;
    }
    // slice-by-8 tables
    for (int t = 1; t < 8; t++)
        for (uint32_t i = 0; i < 256; i++)
            crc_table[t][i] = crc_table[0][crc_table[t - 1][i] & 0xFF]
                              ^ (crc_table[t - 1][i] >> 8);
    table_init = true;
}

inline uint32_t crc32_slice8(const uint8_t* p, size_t n) {
    uint32_t c = 0xFFFFFFFFu;
    while (n >= 8) {
        c ^= (uint32_t)p[0] | ((uint32_t)p[1] << 8)
             | ((uint32_t)p[2] << 16) | ((uint32_t)p[3] << 24);
        uint32_t hi = (uint32_t)p[4] | ((uint32_t)p[5] << 8)
                      | ((uint32_t)p[6] << 16) | ((uint32_t)p[7] << 24);
        c = crc_table[7][c & 0xFF] ^ crc_table[6][(c >> 8) & 0xFF]
            ^ crc_table[5][(c >> 16) & 0xFF] ^ crc_table[4][c >> 24]
            ^ crc_table[3][hi & 0xFF] ^ crc_table[2][(hi >> 8) & 0xFF]
            ^ crc_table[1][(hi >> 16) & 0xFF] ^ crc_table[0][hi >> 24];
        p += 8;
        n -= 8;
    }
    while (n--) c = crc_table[0][(c ^ *p++) & 0xFF] ^ (c >> 8);
    return c ^ 0xFFFFFFFFu;
}

inline uint32_t rotl32(uint32_t x, unsigned k) {
    k &= 31;
    return k ? (x << k) | (x >> (32 - k)) : x;
}

}  // namespace

extern "C" {

// data: nsites x bytes_per_site contiguous payload (big-endian already,
// checksums are byte-order agnostic by definition).
// out[0] = suma, out[1] = sumb.
void dml_checksum(const uint8_t* data, uint64_t nsites,
                  uint64_t bytes_per_site, uint64_t rank0,
                  uint32_t* out) {
    init_table();
    uint32_t suma = 0, sumb = 0;
    for (uint64_t r = 0; r < nsites; r++) {
        uint32_t c = crc32_slice8(data + r * bytes_per_site,
                                  bytes_per_site);
        uint64_t g = rank0 + r;
        suma ^= rotl32(c, (unsigned)(g % 29));
        sumb ^= rotl32(c, (unsigned)(g % 31));
    }
    out[0] = suma;
    out[1] = sumb;
}

// Per-site crc32s (for partial/streamed combining).
void site_crc32(const uint8_t* data, uint64_t nsites,
                uint64_t bytes_per_site, uint32_t* out) {
    init_table();
    for (uint64_t r = 0; r < nsites; r++)
        out[r] = crc32_slice8(data + r * bytes_per_site, bytes_per_site);
}

// In-place 32/64-bit byte swap (the endian conversion of
// parallelIo.nim swapEndian32/64).
void byteswap(uint8_t* data, uint64_t n, uint32_t width) {
    if (width == 4) {
        for (uint64_t i = 0; i < n; i += 4) {
            uint8_t a = data[i], b = data[i + 1];
            data[i] = data[i + 3]; data[i + 1] = data[i + 2];
            data[i + 2] = b; data[i + 3] = a;
        }
    } else if (width == 8) {
        for (uint64_t i = 0; i < n; i += 8) {
            for (int k = 0; k < 4; k++) {
                uint8_t t = data[i + k];
                data[i + k] = data[i + 7 - k];
                data[i + 7 - k] = t;
            }
        }
    }
}

}  // extern "C"
