// The reference's keyed SHA-256 on the device, shared by the hash kernels
// (sha256.cu) and the fused VDPF eval kernel (vdpf_eval.cu).
//
// Device counterpart of fss_tpu_torch/hash/sha256.py: hash64 is
// SHA-256(key || msg) over 80 bytes (two blocks, length 640 bits); xor_hash
// is SHA-256(key || SetLsb(a, lsb) || b) over 48 bytes (one block, length
// 384 bits) for lsb 0 and 1. Lanes are little-endian and SHA-256's words
// big-endian, so every lane is byte-swapped on the way in and out
// (__byte_perm, one PRMT each).
//
// A round is 14 sm_90 instructions (Sigma0 and Sigma1 three funnel shifts
// and a LOP3 each, Ch and Maj a LOP3 each, 4 IADD3s) and a scheduled word
// 10, so a compression is 64 x 14 + 48 x 10 + 8 = 1,384, less what the key
// and the padding fold away. The 64 rounds are fully unrolled:
// the schedule is a 16-word window updated in place (the JAX package's
// rolled form), every window index is a compile-time constant, and the
// window stays in registers. K lives in constant memory: every lane of a
// warp reads the same K[t], which the constant cache broadcasts, and with
// t constant it is an immediate operand of the add.

#pragma once

#include <cstdint>

namespace fss {

static __constant__ uint32_t kSha256K[64] = {
    0x428a2f98u, 0x71374491u, 0xb5c0fbcfu, 0xe9b5dba5u, 0x3956c25bu,
    0x59f111f1u, 0x923f82a4u, 0xab1c5ed5u, 0xd807aa98u, 0x12835b01u,
    0x243185beu, 0x550c7dc3u, 0x72be5d74u, 0x80deb1feu, 0x9bdc06a7u,
    0xc19bf174u, 0xe49b69c1u, 0xefbe4786u, 0x0fc19dc6u, 0x240ca1ccu,
    0x2de92c6fu, 0x4a7484aau, 0x5cb0a9dcu, 0x76f988dau, 0x983e5152u,
    0xa831c66du, 0xb00327c8u, 0xbf597fc7u, 0xc6e00bf3u, 0xd5a79147u,
    0x06ca6351u, 0x14292967u, 0x27b70a85u, 0x2e1b2138u, 0x4d2c6dfcu,
    0x53380d13u, 0x650a7354u, 0x766a0abbu, 0x81c2c92eu, 0x92722c85u,
    0xa2bfe8a1u, 0xa81a664bu, 0xc24b8b70u, 0xc76c51a3u, 0xd192e819u,
    0xd6990624u, 0xf40e3585u, 0x106aa070u, 0x19a4c116u, 0x1e376c08u,
    0x2748774cu, 0x34b0bcb5u, 0x391c0cb3u, 0x4ed8aa4au, 0x5b9cca4fu,
    0x682e6ff3u, 0x748f82eeu, 0x78a5636fu, 0x84c87814u, 0x8cc70208u,
    0x90befffau, 0xa4506cebu, 0xbef9a3f7u, 0xc67178f2u};

__device__ __forceinline__ uint32_t sha256_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ uint32_t bswap32(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123);
}

__device__ __forceinline__ void sha256_init(uint32_t st[8]) {
  st[0] = 0x6A09E667u; st[1] = 0xBB67AE85u;
  st[2] = 0x3C6EF372u; st[3] = 0xA54FF53Au;
  st[4] = 0x510E527Fu; st[5] = 0x9B05688Cu;
  st[6] = 0x1F83D9ABu; st[7] = 0x5BE0CD19u;
}

// st += the compression of the 16 big-endian words w. `w` is clobbered.
__device__ __forceinline__ void sha256_compress(uint32_t st[8],
                                                uint32_t w[16]) {
  uint32_t a = st[0], b = st[1], c = st[2], d = st[3];
  uint32_t e = st[4], f = st[5], g = st[6], h = st[7];
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    const int j = t & 15;
    if (t >= 16) {  // W[t] over W[t - 16]
      const uint32_t w1 = w[(t + 1) & 15], w14 = w[(t + 14) & 15];
      w[j] += (sha256_rotr(w1, 7) ^ sha256_rotr(w1, 18) ^ (w1 >> 3)) +
              w[(t + 9) & 15] +
              (sha256_rotr(w14, 17) ^ sha256_rotr(w14, 19) ^ (w14 >> 10));
    }
    const uint32_t t1 =
        h + (sha256_rotr(e, 6) ^ sha256_rotr(e, 11) ^ sha256_rotr(e, 25)) +
        ((e & f) ^ (~e & g)) + kSha256K[t] + w[j];
    const uint32_t t2 =
        (sha256_rotr(a, 2) ^ sha256_rotr(a, 13) ^ sha256_rotr(a, 22)) +
        ((a & b) ^ (a & c) ^ (b & c));
    h = g; g = f; f = e; e = d + t1;
    d = c; c = b; b = a; a = t1 + t2;
  }
  st[0] += a; st[1] += b; st[2] += c; st[3] += d;
  st[4] += e; st[5] += f; st[6] += g; st[7] += h;
}

// H'(msg) = SHA-256(key || msg): key 4 lanes, msg 16 lanes -> out 8 lanes.
__device__ __forceinline__ void sha256_hash64(const uint32_t key[4],
                                              const uint32_t msg[16],
                                              uint32_t out[8]) {
  uint32_t st[8];
  sha256_init(st);
  uint32_t w[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bswap32(key[i]);
#pragma unroll
  for (int i = 0; i < 12; ++i) w[4 + i] = bswap32(msg[i]);
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 4; ++i) w[i] = bswap32(msg[12 + i]);
  w[4] = 0x80000000u;
#pragma unroll
  for (int i = 5; i < 15; ++i) w[i] = 0u;
  w[15] = 640u;
  sha256_compress(st, w);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = bswap32(st[i]);
}

// H(a, b): SHA-256(key || SetLsb(a, lsb) || b) for lsb 0 (out[0..7]) and
// 1 (out[8..15]).
__device__ __forceinline__ void sha256_xor_hash(const uint32_t key[4],
                                                const uint32_t a[4],
                                                const uint32_t b[4],
                                                uint32_t out[16]) {
#pragma unroll
  for (int lsb = 0; lsb < 2; ++lsb) {
    uint32_t st[8];
    sha256_init(st);
    uint32_t w[16] = {bswap32(key[0]), bswap32(key[1]), bswap32(key[2]),
                      bswap32(key[3]), bswap32(a[0]), bswap32(a[1]),
                      bswap32(a[2]), bswap32((a[3] & ~1u) | (uint32_t)lsb),
                      bswap32(b[0]), bswap32(b[1]), bswap32(b[2]),
                      bswap32(b[3]), 0x80000000u, 0u, 0u, 384u};
    sha256_compress(st, w);
#pragma unroll
    for (int i = 0; i < 8; ++i) out[8 * lsb + i] = bswap32(st[i]);
  }
}

}  // namespace fss
