// The reference's keyed BLAKE3 compression on the device, shared by the
// hash kernels (blake3.cu) and the fused VDPF eval kernel (vdpf_eval.cu).
//
// Device counterpart of fss_tpu_torch/hash/blake3.py (compress_words): the
// state is iv | IV0 | 0, 0, block_len, flags 0x1B (counter 0); seven rounds
// of four column and four diagonal G mixes; the message is permuted
// between rounds; the output is v[i] ^ v[i + 8] for i < 8.
//
// A G mix is 12 sm_90 instructions (4 IADD3s, as a + b + m is one, 4
// xors, 4 rotates), so a compression is 7 x 8 x 12 = 672 plus 8 output
// xors, less what the constant words fold away. The rounds are fully
// unrolled and the permutation is written out word by word, so every
// message index is a compile-time constant and the 16 state and 16
// message words stay in registers: an array indexed at run time would go
// to local memory. Each rotate is one funnel shift.

#pragma once

#include <cstdint>

namespace fss {

constexpr uint32_t kBlake3Flags = 0x1Bu;  // CHUNK_START|CHUNK_END|ROOT|KEYED

__device__ __forceinline__ uint32_t blake3_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

__device__ __forceinline__ void blake3_g(uint32_t& a, uint32_t& b,
                                         uint32_t& c, uint32_t& d,
                                         uint32_t x, uint32_t y) {
  a = a + b + x; d = blake3_rotr(d ^ a, 16);
  c = c + d;     b = blake3_rotr(b ^ c, 12);
  a = a + b + y; d = blake3_rotr(d ^ a, 8);
  c = c + d;     b = blake3_rotr(b ^ c, 7);
}

__device__ __forceinline__ void blake3_round(uint32_t v[16],
                                             const uint32_t m[16]) {
  blake3_g(v[0], v[4], v[8], v[12], m[0], m[1]);
  blake3_g(v[1], v[5], v[9], v[13], m[2], m[3]);
  blake3_g(v[2], v[6], v[10], v[14], m[4], m[5]);
  blake3_g(v[3], v[7], v[11], v[15], m[6], m[7]);
  blake3_g(v[0], v[5], v[10], v[15], m[8], m[9]);
  blake3_g(v[1], v[6], v[11], v[12], m[10], m[11]);
  blake3_g(v[2], v[7], v[8], v[13], m[12], m[13]);
  blake3_g(v[3], v[4], v[9], v[14], m[14], m[15]);
}

// m[i] <- m[PERM[i]], PERM = (2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9,
// 14, 15, 8): register renames once the rounds are unrolled.
__device__ __forceinline__ void blake3_permute(uint32_t m[16]) {
  const uint32_t t0 = m[2], t1 = m[6], t2 = m[3], t3 = m[10];
  const uint32_t t4 = m[7], t5 = m[0], t6 = m[4], t7 = m[13];
  const uint32_t t8 = m[1], t9 = m[11], t10 = m[12], t11 = m[5];
  const uint32_t t12 = m[9], t13 = m[14], t14 = m[15], t15 = m[8];
  m[0] = t0; m[1] = t1; m[2] = t2; m[3] = t3;
  m[4] = t4; m[5] = t5; m[6] = t6; m[7] = t7;
  m[8] = t8; m[9] = t9; m[10] = t10; m[11] = t11;
  m[12] = t12; m[13] = t13; m[14] = t14; m[15] = t15;
}

// out[0..7] = the first 8 output words of Compress(iv, m, block_len).
// `m` is clobbered.
__device__ __forceinline__ void blake3_compress(const uint32_t iv[8],
                                                uint32_t m[16],
                                                uint32_t block_len,
                                                uint32_t out[8]) {
  uint32_t v[16] = {iv[0], iv[1], iv[2], iv[3], iv[4], iv[5], iv[6], iv[7],
                    0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au,
                    0u, 0u, block_len, kBlake3Flags};
#pragma unroll
  for (int r = 0; r < 7; ++r) {
    blake3_round(v, m);
    if (r < 6) blake3_permute(m);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = v[i] ^ v[i + 8];
}

// H(a, b): two compressions of (a with lane 3's LSB 0, then 1) || b, padded
// to 64 bytes, block_len 32. out[0..7] from LSB 0, out[8..15] from LSB 1.
__device__ __forceinline__ void blake3_xor_hash(const uint32_t iv[8],
                                                const uint32_t a[4],
                                                const uint32_t b[4],
                                                uint32_t out[16]) {
#pragma unroll
  for (int lsb = 0; lsb < 2; ++lsb) {
    uint32_t m[16] = {a[0], a[1], a[2], (a[3] & ~1u) | (uint32_t)lsb,
                      b[0], b[1], b[2], b[3], 0u, 0u, 0u, 0u, 0u, 0u, 0u, 0u};
    blake3_compress(iv, m, 32u, out + 8 * lsb);
  }
}

}  // namespace fss
