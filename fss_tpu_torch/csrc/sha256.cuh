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
// What bounds it on the H100: instruction issue. A round is 14 sm_90
// instructions (Sigma0 and Sigma1 three funnel shifts and a LOP3 each, Ch
// and Maj a LOP3 each, 4 IADD3s) and a scheduled word 10 (two sigmas of 4,
// 2 IADD3s). SHF, LOP3, IADD3 and PRMT issue only to a scheduler's ALU
// pipe, 16 lanes wide: a warp instruction every 2 clocks. IMAD issues to
// the FMA pipe, but the measurements (scripts/torch_hash_variants.py, PERF.md)
// show that IMADs still cost issue time: a two-term IMAD in place of a
// three-term IADD3 pays only where ALU-pipe instructions are the many.
//
// Two forms live here. sha256_compress (vdpf_eval.cu's XorHash) keeps the
// first: plain adds, K in constant memory, the schedule a 16-word window
// updated in place, every index a compile-time constant so the window
// stays in registers. The H' kernels and B-12 (sha256.cu) use the
// second: sha256_k makes K[t] a compile-time constant, so K[t] + W[t]
// folds wherever W[t] is padding; the key's work is done once on the host
// (Sha256Key: the state after block 1's rounds 0..3, which read the key
// alone, and the key's terms of W[16..19]); and an Add policy makes
// the sums: IADD3s (PlainAdd), IMADs (FmaAdd: a * one + b, with one a
// kernel argument equal to 1, which ptxas cannot fold back into an IADD3)
// or both (MixedAdd). sha256_schedule computes a window word from the
// terms that vary and takes the others' sum from its caller, so the same
// code serves a block with padding, a block with the key, and the chain's
// block 1, whose point-only terms its producer warp adds up.

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

// ---------------------------------------------------------------------------
// The H' kernels' form (sha256.cu).

// K[t] as a compile-time constant once t is (the rounds are unrolled).
__host__ __device__ constexpr uint32_t sha256_k(int t) {
  constexpr uint32_t k[64] = {
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
  return k[t];
}

__host__ __device__ constexpr uint32_t sha256_h0(int i) {
  constexpr uint32_t h[8] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                             0xA54FF53Au, 0x510E527Fu, 0x9B05688Cu,
                             0x1F83D9ABu, 0x5BE0CD19u};
  return h[i];
}

// The second block's padding after 16 message bytes (H' hashes 80): word i
// of the block, for i >= 4.
__host__ __device__ constexpr uint32_t sha256_pad80(int i) {
  return i == 4 ? 0x80000000u : i == 15 ? 640u : 0u;
}

// A key's launch constants, computed on the host by sha256_key.
struct Sha256Key {
  uint32_t mid[8];  // a..h after block 1's rounds 0..3 (W[0..3] = the key)
  uint32_t kc[4];   // the key's terms of W[16..19]
  uint32_t w[4];    // W[0..3]: the key's lanes, byte-swapped
  uint32_t one;     // 1, FmaAdd's multiplier
};

inline uint32_t sha256_rotr_host(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

inline Sha256Key sha256_key(uint32_t k0, uint32_t k1, uint32_t k2,
                            uint32_t k3) {
  Sha256Key k{};
  const uint32_t lanes[4] = {k0, k1, k2, k3};
  for (int i = 0; i < 4; ++i) k.w[i] = __builtin_bswap32(lanes[i]);
  uint32_t v[8];
  for (int i = 0; i < 8; ++i) v[i] = sha256_h0(i);
  for (int t = 0; t < 4; ++t) {
    const uint32_t e = v[4], a = v[0];
    const uint32_t t1 = v[7] + sha256_k(t) + k.w[t] +
                        (sha256_rotr_host(e, 6) ^ sha256_rotr_host(e, 11) ^
                         sha256_rotr_host(e, 25)) +
                        ((e & v[5]) ^ (~e & v[6]));
    const uint32_t t2 = (sha256_rotr_host(a, 2) ^ sha256_rotr_host(a, 13) ^
                         sha256_rotr_host(a, 22)) +
                        ((a & v[1]) ^ (a & v[2]) ^ (v[1] & v[2]));
    for (int i = 7; i > 0; --i) v[i] = v[i - 1];
    v[4] += t1;
    v[0] = t1 + t2;
  }
  for (int i = 0; i < 8; ++i) k.mid[i] = v[i];
  auto s0 = [](uint32_t x) {
    return sha256_rotr_host(x, 7) ^ sha256_rotr_host(x, 18) ^ (x >> 3);
  };
  k.kc[0] = k.w[0] + s0(k.w[1]);
  k.kc[1] = k.w[1] + s0(k.w[2]);
  k.kc[2] = k.w[2] + s0(k.w[3]);
  k.kc[3] = k.w[3];
  k.one = 1;
  return k;
}

// a + b as a * one + b: one IMAD, on the FMA pipe. `one` is 1 at run time,
// so ptxas cannot turn it back into an IADD3.
__device__ __forceinline__ uint32_t fma_add(uint32_t a, uint32_t b,
                                            uint32_t one) {
  uint32_t d;
  asm("mad.lo.u32 %0, %1, %2, %3;" : "=r"(d) : "r"(a), "r"(one), "r"(b));
  return d;
}

// How the H' kernels add: add(a, b) and add3(a, b, c). Every one is made
// as Add{key.one}.
// PlainAdd leaves them to ptxas: IADD3s, on the ALU pipe.
struct PlainAdd {
  uint32_t one;
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return a + b;
  }
  __device__ __forceinline__ uint32_t add3(uint32_t a, uint32_t b,
                                           uint32_t c) const {
    return a + b + c;
  }
};

// FmaAdd: every add an IMAD (a three-term sum two), on the FMA pipe.
struct FmaAdd {
  uint32_t one;
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return fma_add(a, b, one);
  }
  __device__ __forceinline__ uint32_t add3(uint32_t a, uint32_t b,
                                           uint32_t c) const {
    return fma_add(fma_add(a, b, one), c, one);
  }
};

// MixedAdd: two-term sums as IMADs, three-term ones as one IADD3.
struct MixedAdd {
  uint32_t one;
  __device__ __forceinline__ uint32_t add(uint32_t a, uint32_t b) const {
    return fma_add(a, b, one);
  }
  __device__ __forceinline__ uint32_t add3(uint32_t a, uint32_t b,
                                           uint32_t c) const {
    return a + b + c;
  }
};

__device__ __forceinline__ uint32_t sha256_sigma0(uint32_t x) {
  return sha256_rotr(x, 7) ^ sha256_rotr(x, 18) ^ (x >> 3);
}

__device__ __forceinline__ uint32_t sha256_sigma1(uint32_t x) {
  return sha256_rotr(x, 17) ^ sha256_rotr(x, 19) ^ (x >> 10);
}

// One round on v = (a..h), kw = K[t] + W[t]: 6 SHF, 4 LOP3 and four sums
// (two of two terms, two of three). Sigma1(e), the latest term, is added
// last.
template <class Add>
__device__ __forceinline__ void sha256_round(uint32_t (&v)[8], uint32_t kw,
                                             Add op) {
  const uint32_t a = v[0], b = v[1], c = v[2], d = v[3];
  const uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
  const uint32_t s1 = sha256_rotr(e, 6) ^ sha256_rotr(e, 11) ^
                      sha256_rotr(e, 25);
  const uint32_t ch = (e & f) ^ (~e & g);
  const uint32_t s0 = sha256_rotr(a, 2) ^ sha256_rotr(a, 13) ^
                      sha256_rotr(a, 22);
  const uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
  const uint32_t t1 = op.add(op.add3(h, kw, ch), s1);
  v[7] = g; v[6] = f; v[5] = e; v[4] = op.add(d, t1);
  v[3] = c; v[2] = b; v[1] = a; v[0] = op.add3(t1, maj, s0);
}

// W[t] (t >= 16) into the window w (w[i & 15] = W[i]) from the terms whose
// word index i has skip(i) false, plus `extra`, the sum of the others
// (or nothing where has_extra is false). The caller unrolls t, so every
// test folds.
template <class Add, class Skip>
__device__ __forceinline__ void sha256_schedule(uint32_t (&w)[16], int t,
                                                Skip skip, bool has_extra,
                                                uint32_t extra, Add op) {
  uint32_t x[5];  // the terms, sigma1(W[t - 2]), the latest, last
  int k = 0;
  if (has_extra) x[k++] = extra;
  if (!skip(t - 16)) x[k++] = w[t & 15];
  if (!skip(t - 7)) x[k++] = w[(t - 7) & 15];
  if (!skip(t - 15)) x[k++] = sha256_sigma0(w[(t - 15) & 15]);
  if (!skip(t - 2)) x[k++] = sha256_sigma1(w[(t - 2) & 15]);
  w[t & 15] = k == 1   ? x[0]
              : k == 2 ? op.add(x[0], x[1])
              : k == 3 ? op.add3(x[0], x[1], x[2])
              : k == 4 ? op.add(op.add3(x[0], x[1], x[2]), x[3])
                       : op.add3(op.add3(x[0], x[1], x[2]), x[3], x[4]);
}

// W[t] (t >= 16) of the second block of H', whose W[0..3] are the
// message's last 16 bytes and W[4..15] the padding: the padding's terms
// fold into one constant.
template <class Add>
__device__ __forceinline__ void sha256_schedule80(uint32_t (&w)[16], int t,
                                                  Add op) {
  auto padding = [](int i) { return i >= 4 && i < 16; };
  uint32_t pad = 0;
  if (padding(t - 16)) pad += w[t & 15];
  if (padding(t - 7)) pad += w[(t - 7) & 15];
  if (padding(t - 15)) pad += sha256_sigma0(w[(t - 15) & 15]);
  if (padding(t - 2)) pad += sha256_sigma1(w[(t - 2) & 15]);
  sha256_schedule(w, t, padding, pad != 0u, pad, op);
}

// The window of the second block of H' before its schedule: x (big-endian
// W[0..3]) and the padding.
__device__ __forceinline__ void sha256_window80(uint32_t (&w)[16],
                                                const uint32_t (&x)[4]) {
#pragma unroll
  for (int i = 0; i < 16; ++i) w[i] = i < 4 ? x[i] : sha256_pad80(i);
}

// Block 2 of H' on the state st (block 1's digest), W[0..3] = x;
// st += the compression. The rounds add with op, the schedule with sop.
template <class Add, class SAdd>
__device__ __forceinline__ void sha256_block2(uint32_t (&st)[8],
                                              const uint32_t (&x)[4],
                                              Add op, SAdd sop) {
  uint32_t v[8], w[16];
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = st[i];
  sha256_window80(w, x);
#pragma unroll
  for (int t = 0; t < 64; ++t) {
    if (t >= 16) sha256_schedule80(w, t, sop);
    const uint32_t kw = (t >= 4 && t < 16) ? sha256_k(t) + sha256_pad80(t)
                                           : op.add(w[t & 15], sha256_k(t));
    sha256_round(v, kw, op);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = op.add(st[i], v[i]);
}

// H'(msg) = SHA-256(key || msg) from the key's launch constants: msg 16
// little-endian lanes -> out 8 lanes. The rounds add with op, the
// schedule with sop.
template <class Add, class SAdd>
__device__ __forceinline__ void sha256_hash64_mid(const Sha256Key& key,
                                                  const uint32_t (&m)[16],
                                                  uint32_t (&out)[8],
                                                  Add op, SAdd sop) {
  uint32_t v[8], w[16] = {};  // W[0..3], the key's, only through kc
#pragma unroll
  for (int i = 0; i < 8; ++i) v[i] = key.mid[i];
#pragma unroll
  for (int t = 4; t < 16; ++t) {
    w[t] = bswap32(m[t - 4]);
    sha256_round(v, op.add(w[t], sha256_k(t)), op);
  }
#pragma unroll
  for (int t = 16; t < 64; ++t) {
    sha256_schedule(w, t, [](int i) { return i < 4; }, t < 20,
                    t < 20 ? key.kc[t - 16] : 0u, sop);
    sha256_round(v, op.add(w[t & 15], sha256_k(t)), op);
  }
  uint32_t st[8], x[4];
#pragma unroll
  for (int i = 0; i < 8; ++i) st[i] = v[i] + sha256_h0(i);
#pragma unroll
  for (int i = 0; i < 4; ++i) x[i] = bswap32(m[12 + i]);
  sha256_block2(st, x, op, sop);
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = bswap32(st[i]);
}

// ---------------------------------------------------------------------------
// The XorHash from the key's midstate (B-12, sha256.cu). The block is
// W[0..3] the key, W[4..7] SetLsb(a, lsb), W[8..11] b, W[12..15] the
// padding of 48 bytes. The domain bit is W[7]'s bit 24 (lane 3's LSB,
// byte-swapped), so the two compressions share the key's rounds (the
// midstate), rounds 4..6, round 7 up to its t1 (t1 of lsb 1 is t1 of lsb 0
// plus 2^24), and W[16..21], which W[7] does not reach.

__host__ __device__ constexpr uint32_t sha256_rotr_c(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

__host__ __device__ constexpr uint32_t sha256_sigma0_c(uint32_t x) {
  return sha256_rotr_c(x, 7) ^ sha256_rotr_c(x, 18) ^ (x >> 3);
}

__host__ __device__ constexpr uint32_t sha256_sigma1_c(uint32_t x) {
  return sha256_rotr_c(x, 17) ^ sha256_rotr_c(x, 19) ^ (x >> 10);
}

constexpr uint32_t kSha256DomainBit = 0x01000000u;  // W[7] of lsb 1

// Whether the XorHash's word i (< 16) is a compile-time constant: the
// padding.
__host__ __device__ constexpr bool xor_const_word(int i) { return i >= 12; }

// The value of a constant word.
__host__ __device__ constexpr uint32_t xor_const_value(int i) {
  return i == 12 ? 0x80000000u : i == 15 ? 384u : 0u;
}

// The constant terms of W[t] (t >= 16), summed.
__host__ __device__ constexpr uint32_t xor_const_terms(int t) {
  uint32_t s = 0;
  if (t - 16 < 16 && xor_const_word(t - 16)) s += xor_const_value(t - 16);
  if (t - 7 < 16 && xor_const_word(t - 7)) s += xor_const_value(t - 7);
  if (t - 15 < 16 && xor_const_word(t - 15))
    s += sha256_sigma0_c(xor_const_value(t - 15));
  if (t - 2 < 16 && xor_const_word(t - 2))
    s += sha256_sigma1_c(xor_const_value(t - 2));
  return s;
}

// W[t] (t >= 16) into the window: the row words' terms from w, the key's
// from key.kc, the constants' folded.
template <class Add>
__device__ __forceinline__ void xor_schedule(uint32_t (&w)[16], int t,
                                             const Sha256Key& key, Add op) {
  const uint32_t c = xor_const_terms(t);
  const bool has_key = t < 20;
  const uint32_t extra = has_key ? (c ? key.kc[t - 16] + c : key.kc[t - 16])
                                 : c;
  sha256_schedule(
      w, t,
      [](int i) { return i < 4 || (i < 16 && xor_const_word(i)); },
      has_key || c != 0u, extra, op);
}

// K[t] + W[t] for t < 16.
template <class Add>
__device__ __forceinline__ uint32_t xor_kw(const uint32_t (&w)[16], int t,
                                           Add op) {
  return xor_const_word(t) ? sha256_k(t) + xor_const_value(t)
                           : op.add(w[t & 15], sha256_k(t));
}

// Rounds t0..63 on v, W[t] in the window from t0 on (W[16..t0) already in
// it).
template <class Add, class SAdd>
__device__ __forceinline__ void xor_rounds(uint32_t (&v)[8],
                                           uint32_t (&w)[16], int t0,
                                           const Sha256Key& key, Add op,
                                           SAdd sop) {
#pragma unroll
  for (int t = 4; t < 64; ++t) {
    if (t < t0) continue;
    if (t >= 16) xor_schedule(w, t, key, sop);
    sha256_round(v, t < 16 ? xor_kw(w, t, op)
                           : op.add(w[t & 15], sha256_k(t)), op);
  }
}

// H(a, b) from the key's launch constants: out[0..7] of lsb 0, out[8..15]
// of lsb 1 (lanes, little-endian). kShared runs the two compressions'
// common prefix once; without it each runs from the midstate.
template <bool kShared, class Add, class SAdd>
__device__ __forceinline__ void sha256_xor_hash_mid(const Sha256Key& key,
                                                    const uint32_t (&a)[4],
                                                    const uint32_t (&b)[4],
                                                    uint32_t (&out)[16],
                                                    Add op, SAdd sop) {
  uint32_t w[16] = {};  // W[0..3], the key's, only through kc
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    w[4 + i] = bswap32(i == 3 ? a[3] & ~1u : a[i]);
    w[8 + i] = bswap32(b[i]);
  }
  uint32_t st[2][8];
  if constexpr (kShared) {
    uint32_t v[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = key.mid[i];
#pragma unroll
    for (int t = 4; t < 7; ++t) sha256_round(v, xor_kw(w, t, op), op);
    // Round 7 up to t1, then each compression's t1.
    const uint32_t e = v[4], f = v[5], g = v[6], h = v[7];
    const uint32_t s1 = sha256_rotr(e, 6) ^ sha256_rotr(e, 11) ^
                        sha256_rotr(e, 25);
    const uint32_t ch = (e & f) ^ (~e & g);
    const uint32_t s0 = sha256_rotr(v[0], 2) ^ sha256_rotr(v[0], 13) ^
                        sha256_rotr(v[0], 22);
    const uint32_t maj = (v[0] & v[1]) ^ (v[0] & v[2]) ^ (v[1] & v[2]);
    const uint32_t t1 =
        op.add(op.add3(h, xor_kw(w, 7, op), ch), s1);
    // W[16..21] and K[t] + W[t] for t = 8..21: shared.
#pragma unroll
    for (int t = 16; t < 22; ++t) xor_schedule(w, t, key, sop);
    uint32_t kw[14];
#pragma unroll
    for (int t = 8; t < 22; ++t)
      kw[t - 8] = t < 16 ? xor_kw(w, t, op) : op.add(w[t & 15], sha256_k(t));
#pragma unroll
    for (int lsb = 0; lsb < 2; ++lsb) {
      const uint32_t t1l = lsb ? t1 + kSha256DomainBit : t1;
      uint32_t vl[8] = {op.add3(t1l, maj, s0), v[0], v[1], v[2],
                        op.add(v[3], t1l), e, f, g};
      uint32_t wl[16];
#pragma unroll
      for (int i = 0; i < 16; ++i) wl[i] = w[i];
      if (lsb) wl[7] = w[7] | kSha256DomainBit;
#pragma unroll
      for (int t = 8; t < 22; ++t) sha256_round(vl, kw[t - 8], op);
      xor_rounds(vl, wl, 22, key, op, sop);
#pragma unroll
      for (int i = 0; i < 8; ++i) st[lsb][i] = vl[i];
    }
  } else {
#pragma unroll
    for (int lsb = 0; lsb < 2; ++lsb) {
      uint32_t vl[8], wl[16];
#pragma unroll
      for (int i = 0; i < 8; ++i) vl[i] = key.mid[i];
#pragma unroll
      for (int i = 0; i < 16; ++i) wl[i] = w[i];
      if (lsb) wl[7] = w[7] | kSha256DomainBit;
      xor_rounds(vl, wl, 4, key, op, sop);
#pragma unroll
      for (int i = 0; i < 8; ++i) st[lsb][i] = vl[i];
    }
  }
#pragma unroll
  for (int lsb = 0; lsb < 2; ++lsb)
#pragma unroll
    for (int i = 0; i < 8; ++i)
      out[8 * lsb + i] = bswap32(op.add(st[lsb][i], sha256_h0(i)));
}

}  // namespace fss
