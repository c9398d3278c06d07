// One block of the reference's nonstandard ChaCha PRG at mul=2, shared by
// the DPF kernels (dpf_eval.cu, dpf_gen.cu, dpf_eval_all.cu), at mul=4
// (chacha4 below), shared by the DCF kernels, and at mul=1 (chacha1), the
// CCR hash of the Half-Tree kernels.
//
// Device counterpart of fss_tpu_torch/prg/chacha.py (chacha_prg_words with
// mul=2): state = "expand 16-byte k" | seed | seed | 0, 0, nonce; after
// `rounds` rounds the left output is row0 ^ const and the right output is
// row1 ^ seed (feed-forward by XOR against the inputs, not by addition).
//
// A quarter-round is 12 32-bit integer ops (4 adds, 4 xors, 4 rotates);
// each rotate is one funnel shift (SHF), so one 20-round block costs 960
// ALU ops on 16 state words that stay in registers.

#pragma once

#include <cstdint>

namespace fss {

__device__ __forceinline__ uint32_t rotl(uint32_t x, int n) {
  return __funnelshift_l(x, x, n);
}

__device__ __forceinline__ void quarter_round(uint32_t& a, uint32_t& b,
                                              uint32_t& c, uint32_t& d) {
  a += b; d = rotl(d ^ a, 16);
  c += d; b = rotl(b ^ c, 12);
  a += b; d = rotl(d ^ a, 8);
  c += d; b = rotl(b ^ c, 7);
}

constexpr uint32_t kC0 = 0x61707865u, kC1 = 0x3120646Eu,
                   kC2 = 0x79622D36u, kC3 = 0x6B206574u;

// (left, right) = PRG(seed); `left` and `right` may alias `seed`.
__device__ __forceinline__ void chacha2(const uint32_t seed[4], uint32_t n0,
                                        uint32_t n1, int rounds,
                                        uint32_t left[4], uint32_t right[4]) {
  const uint32_t k0 = seed[0], k1 = seed[1], k2 = seed[2], k3 = seed[3];
  uint32_t x0 = kC0, x1 = kC1, x2 = kC2, x3 = kC3;
  uint32_t x4 = k0, x5 = k1, x6 = k2, x7 = k3;
  uint32_t x8 = k0, x9 = k1, x10 = k2, x11 = k3;
  uint32_t x12 = 0u, x13 = 0u, x14 = n0, x15 = n1;
  for (int i = 0; i < rounds; i += 2) {
    quarter_round(x0, x4, x8, x12);
    quarter_round(x1, x5, x9, x13);
    quarter_round(x2, x6, x10, x14);
    quarter_round(x3, x7, x11, x15);
    quarter_round(x0, x5, x10, x15);
    quarter_round(x1, x6, x11, x12);
    quarter_round(x2, x7, x8, x13);
    quarter_round(x3, x4, x9, x14);
  }
  left[0] = x0 ^ kC0; left[1] = x1 ^ kC1;
  left[2] = x2 ^ kC2; left[3] = x3 ^ kC3;
  right[0] = x4 ^ k0; right[1] = x5 ^ k1;
  right[2] = x6 ^ k2; right[3] = x7 ^ k3;
}

// The mul=1 block of the Half-Tree kernels (ht_eval.cu, ht_gen.cu,
// ht_eval_all.cu): the same "expand 16-byte k" state as mul=2, and its only
// output is chacha2's right one, row1 ^ seed. The same 960 ALU ops: the
// left output's four XORs are dead and the compiler drops them. `out` may
// alias `seed`.
__device__ __forceinline__ void chacha1(const uint32_t seed[4], uint32_t n0,
                                        uint32_t n1, int rounds,
                                        uint32_t out[4]) {
  uint32_t unused[4];
  chacha2(seed, n0, n1, rounds, unused, out);
}

// "expand 32-byte k": row 0 at mul=4.
constexpr uint32_t kD0 = 0x61707865u, kD1 = 0x3320646Eu,
                   kD2 = 0x79622D32u, kD3 = 0x6B206574u;

// The mul=4 block of the DCF kernels (dcf_eval.cu, dcf_gen.cu,
// dcf_eval_all.cu): state = "expand 32-byte k" | seed | seed | 0, 0, nonce;
// out[0] = row0 ^ const, out[1] = row1 ^ seed, out[2] = row2 ^ seed,
// out[3] = row3 ^ {0, 0, n0, n1}. The same 960 ALU ops as chacha2: the two
// extra outputs are XORs of rows the rounds compute anyway.
__device__ __forceinline__ void chacha4(const uint32_t seed[4], uint32_t n0,
                                        uint32_t n1, int rounds,
                                        uint32_t out[4][4]) {
  const uint32_t k0 = seed[0], k1 = seed[1], k2 = seed[2], k3 = seed[3];
  uint32_t x0 = kD0, x1 = kD1, x2 = kD2, x3 = kD3;
  uint32_t x4 = k0, x5 = k1, x6 = k2, x7 = k3;
  uint32_t x8 = k0, x9 = k1, x10 = k2, x11 = k3;
  uint32_t x12 = 0u, x13 = 0u, x14 = n0, x15 = n1;
  for (int i = 0; i < rounds; i += 2) {
    quarter_round(x0, x4, x8, x12);
    quarter_round(x1, x5, x9, x13);
    quarter_round(x2, x6, x10, x14);
    quarter_round(x3, x7, x11, x15);
    quarter_round(x0, x5, x10, x15);
    quarter_round(x1, x6, x11, x12);
    quarter_round(x2, x7, x8, x13);
    quarter_round(x3, x4, x9, x14);
  }
  out[0][0] = x0 ^ kD0; out[0][1] = x1 ^ kD1;
  out[0][2] = x2 ^ kD2; out[0][3] = x3 ^ kD3;
  out[1][0] = x4 ^ k0; out[1][1] = x5 ^ k1;
  out[1][2] = x6 ^ k2; out[1][3] = x7 ^ k3;
  out[2][0] = x8 ^ k0; out[2][1] = x9 ^ k1;
  out[2][2] = x10 ^ k2; out[2][3] = x11 ^ k3;
  out[3][0] = x12; out[3][1] = x13;
  out[3][2] = x14 ^ n0; out[3][3] = x15 ^ n1;
}

}  // namespace fss
