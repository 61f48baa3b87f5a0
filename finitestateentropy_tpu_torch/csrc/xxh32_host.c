/* One-shot XXH32 on the host: the frame checksum of io/frame.py.
 *
 * The public XXH32 algorithm (xxHash specification, XXH32): four lane
 * accumulators over 16-byte stripes, then the 4-byte and 1-byte tails and
 * the avalanche.  Built with the system C compiler by utils/xxhash32.py at
 * its first hash and loaded with ctypes; it needs no CUDA and no torch.
 * Words are read little-endian with memcpy, so any alignment is fine.
 */
#include <stddef.h>
#include <stdint.h>
#include <string.h>

#define P1 2654435761u
#define P2 2246822519u
#define P3 3266489917u
#define P4 668265263u
#define P5 374761393u

static inline uint32_t rotl32(uint32_t x, int r) { return (x << r) | (x >> (32 - r)); }

static inline uint32_t read32(const uint8_t *p) {
    uint32_t w;
    memcpy(&w, p, 4);
#if defined(__BYTE_ORDER__) && __BYTE_ORDER__ == __ORDER_BIG_ENDIAN__
    w = __builtin_bswap32(w);
#endif
    return w;
}

static inline uint32_t round32(uint32_t acc, uint32_t w) {
    return rotl32(acc + w * P2, 13) * P1;
}

uint32_t xxh32(const uint8_t *p, size_t n, uint32_t seed) {
    const uint8_t *end = p + n;
    uint32_t h;
    if (n >= 16) {
        const uint8_t *limit = end - 16;
        uint32_t v1 = seed + P1 + P2, v2 = seed + P2, v3 = seed, v4 = seed - P1;
        do {
            v1 = round32(v1, read32(p));
            v2 = round32(v2, read32(p + 4));
            v3 = round32(v3, read32(p + 8));
            v4 = round32(v4, read32(p + 12));
            p += 16;
        } while (p <= limit);
        h = rotl32(v1, 1) + rotl32(v2, 7) + rotl32(v3, 12) + rotl32(v4, 18);
    } else {
        h = seed + P5;
    }
    h += (uint32_t)n;
    for (; end - p >= 4; p += 4)
        h = rotl32(h + read32(p) * P3, 17) * P4;
    for (; p < end; p++)
        h = rotl32(h + *p * P5, 11) * P1;
    h ^= h >> 15;
    h *= P2;
    h ^= h >> 13;
    h *= P3;
    h ^= h >> 16;
    return h;
}
