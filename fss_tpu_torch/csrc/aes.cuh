// AES-128-MMO on the device: out = AES_k(seed) ^ seed, one block per thread,
// shared by every kernel that runs the AES PRG (through prg.cuh).
//
// Device counterpart of fss_tpu_torch/prg/aes.py, and of the T-table form
// of fss_tpu/prg/aes.py (the reference's aes128_mmo_soft.cuh): the seed's
// lanes are byte-swapped into the big-endian state words, then 9 rounds of
// 16 Te0 lookups with the rotations, the S-box round, the swap back and the
// XOR with the seed.
//
// The two tables (Te0, and the S-box stored as 32-bit words, 2 KB in all)
// live in shared memory. Every thread of a block takes part in filling them
// (aes_load_tables) before any thread leaves, so kernels call it before
// their `if (k >= batch) return;`. The round keys are kernel parameters
// (AesPrg in prg.cuh): the rounds are fully unrolled, so every state word
// and round-key index is a compile-time constant, the state stays in
// registers and each round key is a constant-bank operand.
//
// Cost of one block: 160 lookups into Te0 and 16 into the S-box (LDS), and
// per lookup a byte extraction and, for 3 of 4, a rotation; the lookups'
// random indices into one 256-word table meet ~3-4 ways of bank conflict
// per warp (one table per rotation, or a table per bank, is later work).

#pragma once

#include <cstdint>

namespace fss {

__device__ const uint8_t kAesSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

// The block's tables: allocated only in kernels that reference them.
__shared__ uint32_t aes_te0[256];
__shared__ uint32_t aes_sbox[256];

// Every thread of the block calls this once, before any thread returns.
__device__ __forceinline__ void aes_load_tables() {
  for (int i = threadIdx.x; i < 256; i += blockDim.x) {
    const uint32_t s = kAesSbox[i];
    const uint32_t x2 = ((s << 1) ^ ((s >> 7) * 0x1Bu)) & 0xFFu;
    aes_te0[i] = (x2 << 24) | (s << 16) | (s << 8) | (s ^ x2);
    aes_sbox[i] = s;
  }
  __syncthreads();
}

__device__ __forceinline__ uint32_t aes_bswap(uint32_t x) {
  return __byte_perm(x, 0u, 0x0123);
}

__device__ __forceinline__ uint32_t aes_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// Byte b (0 = least significant) of x, zero-extended: one PRMT.
template <int b>
__device__ __forceinline__ uint32_t aes_byte(uint32_t x) {
  return __byte_perm(x, 0u, 0x4440 | b);
}

// One T-table round: output word i from state words i, i+1, i+2, i+3.
__device__ __forceinline__ uint32_t aes_t_word(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               uint32_t k) {
  return aes_te0[aes_byte<3>(a)] ^ aes_rotr(aes_te0[aes_byte<2>(b)], 8) ^
         aes_rotr(aes_te0[aes_byte<1>(c)], 16) ^
         aes_rotr(aes_te0[aes_byte<0>(d)], 24) ^ k;
}

// The final round's word i: SubBytes, ShiftRows, AddRoundKey.
__device__ __forceinline__ uint32_t aes_s_word(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               uint32_t k) {
  return ((aes_sbox[aes_byte<3>(a)] << 24) |
          (aes_sbox[aes_byte<2>(b)] << 16) | (aes_sbox[aes_byte<1>(c)] << 8) |
          aes_sbox[aes_byte<0>(d)]) ^
         k;
}

// out = AES_rk(seed) ^ seed over the seed's 4 lanes; rk: the 44 big-endian
// round-key words. `out` may alias `seed`.
__device__ __forceinline__ void aes_mmo(const uint32_t (&rk)[44],
                                        const uint32_t seed[4],
                                        uint32_t out[4]) {
  const uint32_t x0 = seed[0], x1 = seed[1], x2 = seed[2], x3 = seed[3];
  uint32_t s0 = aes_bswap(x0) ^ rk[0], s1 = aes_bswap(x1) ^ rk[1];
  uint32_t s2 = aes_bswap(x2) ^ rk[2], s3 = aes_bswap(x3) ^ rk[3];
#pragma unroll
  for (int r = 1; r < 10; ++r) {
    const uint32_t t0 = aes_t_word(s0, s1, s2, s3, rk[4 * r]);
    const uint32_t t1 = aes_t_word(s1, s2, s3, s0, rk[4 * r + 1]);
    const uint32_t t2 = aes_t_word(s2, s3, s0, s1, rk[4 * r + 2]);
    const uint32_t t3 = aes_t_word(s3, s0, s1, s2, rk[4 * r + 3]);
    s0 = t0; s1 = t1; s2 = t2; s3 = t3;
  }
  out[0] = aes_bswap(aes_s_word(s0, s1, s2, s3, rk[40])) ^ x0;
  out[1] = aes_bswap(aes_s_word(s1, s2, s3, s0, rk[41])) ^ x1;
  out[2] = aes_bswap(aes_s_word(s2, s3, s0, s1, rk[42])) ^ x2;
  out[3] = aes_bswap(aes_s_word(s3, s0, s1, s2, rk[43])) ^ x3;
}

}  // namespace fss
