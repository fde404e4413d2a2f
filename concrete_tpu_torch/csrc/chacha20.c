/* ChaCha20-based cryptographically secure PRNG (RFC 8439 block function).
 *
 * Native counterpart of the reference's concrete-csprng
 * (backends/concrete-cpu/implementation/src/c_api/csprng.rs, which wraps a
 * ChaCha-based software RNG): fills buffers from a 256-bit seed + 96-bit
 * nonce + 32-bit block counter.  Built as a shared library, bound via
 * ctypes from concrete_tpu/utils/csprng.py.
 */

#include <stdint.h>
#include <string.h>

#define ROTL32(v, c) (((v) << (c)) | ((v) >> (32 - (c))))

#define QR(a, b, c, d)                  \
    a += b; d ^= a; d = ROTL32(d, 16);  \
    c += d; b ^= c; b = ROTL32(b, 12);  \
    a += b; d ^= a; d = ROTL32(d, 8);   \
    c += d; b ^= c; b = ROTL32(b, 7);

static void chacha20_block(const uint32_t key[8], uint32_t counter,
                           const uint32_t nonce[3], uint32_t out[16]) {
    uint32_t s[16];
    s[0] = 0x61707865u; s[1] = 0x3320646eu;
    s[2] = 0x79622d32u; s[3] = 0x6b206574u;
    for (int i = 0; i < 8; i++) s[4 + i] = key[i];
    s[12] = counter;
    s[13] = nonce[0]; s[14] = nonce[1]; s[15] = nonce[2];
    uint32_t x[16];
    memcpy(x, s, sizeof(x));
    for (int round = 0; round < 10; round++) {
        QR(x[0], x[4], x[8], x[12])
        QR(x[1], x[5], x[9], x[13])
        QR(x[2], x[6], x[10], x[14])
        QR(x[3], x[7], x[11], x[15])
        QR(x[0], x[5], x[10], x[15])
        QR(x[1], x[6], x[11], x[12])
        QR(x[2], x[7], x[8], x[13])
        QR(x[3], x[4], x[9], x[14])
    }
    for (int i = 0; i < 16; i++) out[i] = x[i] + s[i];
}

/* Fill `n_bytes` of output from the keystream starting at block `counter`.
 * Returns the next unused counter value. */
uint32_t chacha20_fill(const uint8_t key[32], uint32_t counter,
                       const uint8_t nonce[12], uint8_t *out,
                       uint64_t n_bytes) {
    uint32_t k[8], nc[3], block[16];
    memcpy(k, key, 32);
    memcpy(nc, nonce, 12);
    uint64_t off = 0;
    while (off < n_bytes) {
        chacha20_block(k, counter++, nc, block);
        uint64_t take = n_bytes - off < 64 ? n_bytes - off : 64;
        memcpy(out + off, block, take);
        off += take;
    }
    return counter;
}
