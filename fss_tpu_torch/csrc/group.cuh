// The output groups on the device: 128-bit lane arithmetic and the exact
// group operations of DCF Gen's levels (dcf_gen.cu) and of the DPF, DCF and
// Half-Tree EvalAll kernels' leaf finalize (dpf_eval_all.cu,
// dcf_eval_all.cu, ht_eval_all.cu: leaf_share).
//
// Device counterpart of fss_tpu_torch/groups.py. A value is 4 little-endian
// uint32 lanes. Every group of the port falls in one of five kinds, which
// are also the five value-accumulator modes of the DCF Eval and EvalAll
// kernels (dcf_acc.cuh); ops/dcf_cuda.py:group_mode maps a group to its
// kind and :gen_params to the (mask, mod) pair below.
//
//   kXor       Bytes: add = XOR, neg = identity.
//   kWrap      Uint, bits <= 64, mod 0 or a power of two: from_block masks
//              the lanes to the value width (bits, or log2 mod), add and
//              neg wrap at that width.
//   kMod64     Uint, bits <= 64, any other mod: from_block masks to bits
//              and reduces mod m (64-bit %), add and neg are mod m.
//   kMod128    Uint(128, mod = 2^k <= 2^127): the clamped encoding (value
//              bits 96..126 in word-3 bits 1..31); from_block decodes
//              (w3 >> 1) and masks to k bits, into_block re-encodes
//              (w3 << 1), add and neg wrap at k bits.
//   kMod128np  Uint(128, mod m < 2^127 not a power of two): decode, then
//              reduce the 127-bit value mod m by long division; add and
//              neg are mod m.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fss {

enum Mode : int { kXor = 0, kWrap = 1, kMod64 = 2, kMod128 = 3, kMod128np = 4 };

// mask: the value bits from_block keeps (kWrap, kMod64, kMod128); mod: the
// modulus lanes (kMod64, kMod128np).
struct Group {
  uint32_t mask[4];
  uint32_t mod[4];
};

// a += b over 4 lanes, wrapping at 2^128.
__device__ __forceinline__ void add128(uint32_t a[4], const uint32_t b[4]) {
  asm("add.cc.u32 %0, %0, %4;\n\t"
      "addc.cc.u32 %1, %1, %5;\n\t"
      "addc.cc.u32 %2, %2, %6;\n\t"
      "addc.u32 %3, %3, %7;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
}

// a -= b over 4 lanes, wrapping at 2^128.
__device__ __forceinline__ void sub128(uint32_t a[4], const uint32_t b[4]) {
  asm("sub.cc.u32 %0, %0, %4;\n\t"
      "subc.cc.u32 %1, %1, %5;\n\t"
      "subc.cc.u32 %2, %2, %6;\n\t"
      "subc.u32 %3, %3, %7;"
      : "+r"(a[0]), "+r"(a[1]), "+r"(a[2]), "+r"(a[3])
      : "r"(b[0]), "r"(b[1]), "r"(b[2]), "r"(b[3]));
}

__device__ __forceinline__ bool ge128(const uint32_t a[4],
                                      const uint32_t b[4]) {
#pragma unroll
  for (int w = 3; w >= 0; --w) {
    if (a[w] != b[w]) return a[w] > b[w];
  }
  return true;
}

__device__ __forceinline__ bool is_zero128(const uint32_t a[4]) {
  return (a[0] | a[1] | a[2] | a[3]) == 0u;
}

__device__ __forceinline__ uint64_t lo64(const uint32_t a[4]) {
  return (uint64_t)a[0] | ((uint64_t)a[1] << 32);
}

__device__ __forceinline__ void set_lo64(uint32_t a[4], uint64_t x) {
  a[0] = (uint32_t)x; a[1] = (uint32_t)(x >> 32); a[2] = 0u; a[3] = 0u;
}

// x + y mod m for x, y < m <= 2^64: one conditional subtract.
__device__ __forceinline__ uint64_t add_mod64(uint64_t x, uint64_t y,
                                              uint64_t m) {
  const uint64_t s = x + y;
  return (s < x || s >= m) ? s - m : s;
}

// (hi, v) <<= 1 as one 256-bit value: bit 127 of v moves into hi.
__device__ __forceinline__ void shl1_into(uint32_t hi[4], uint32_t v[4]) {
  hi[3] = (hi[3] << 1) | (hi[2] >> 31);
  hi[2] = (hi[2] << 1) | (hi[1] >> 31);
  hi[1] = (hi[1] << 1) | (hi[0] >> 31);
  hi[0] = (hi[0] << 1) | (v[3] >> 31);
  v[3] = (v[3] << 1) | (v[2] >> 31);
  v[2] = (v[2] << 1) | (v[1] >> 31);
  v[1] = (v[1] << 1) | (v[0] >> 31);
  v[0] <<= 1;
}

// v = v mod m for v < 2^127, m < 2^127: MSB-first shift-subtract, the
// remainder r < m taking one bit of v per step (so 2r + 1 < 2^128).
__device__ __forceinline__ void mod_reduce127(uint32_t v[4],
                                              const uint32_t m[4]) {
  uint32_t r[4] = {0u, 0u, 0u, 0u};
  uint32_t z[4] = {0u, 0u, 0u, 0u};
  shl1_into(z, v);  // bit 126 to the top; z stays 0
  for (int i = 0; i < 127; ++i) {
    shl1_into(r, v);
    if (ge128(r, m)) sub128(r, m);
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) v[w] = r[w];
}

// v = x mod m for x < 2^135 in 5 words (the DCF's exact kMod128np sum,
// dcf_acc.cuh), m < 2^127: MSB-first shift-subtract over bits 134..0, the
// remainder r < m taking one bit of x per step (so 2r + 1 < 2^128).
__device__ __forceinline__ void mod_reduce160(const uint32_t x[5],
                                              const uint32_t m[4],
                                              uint32_t v[4]) {
  // Bits 134..0 of x to the top of a 160-bit window.
  uint32_t a[5] = {x[0] << 25, (x[1] << 25) | (x[0] >> 7),
                   (x[2] << 25) | (x[1] >> 7), (x[3] << 25) | (x[2] >> 7),
                   (x[4] << 25) | (x[3] >> 7)};
  uint32_t r[4] = {0u, 0u, 0u, 0u};
  for (int i = 0; i < 135; ++i) {
    r[3] = (r[3] << 1) | (r[2] >> 31);
    r[2] = (r[2] << 1) | (r[1] >> 31);
    r[1] = (r[1] << 1) | (r[0] >> 31);
    r[0] = (r[0] << 1) | (a[4] >> 31);
    a[4] = (a[4] << 1) | (a[3] >> 31);
    a[3] = (a[3] << 1) | (a[2] >> 31);
    a[2] = (a[2] << 1) | (a[1] >> 31);
    a[1] = (a[1] << 1) | (a[0] >> 31);
    a[0] <<= 1;
    if (ge128(r, m)) sub128(r, m);
  }
#pragma unroll
  for (int w = 0; w < 4; ++w) v[w] = r[w];
}

// A block -> a group value, in place.
template <int M>
__device__ __forceinline__ void from_block(const Group& g, uint32_t v[4]) {
  if (M == kMod128 || M == kMod128np) v[3] >>= 1;
  if (M == kWrap || M == kMod64 || M == kMod128) {
#pragma unroll
    for (int w = 0; w < 4; ++w) v[w] &= g.mask[w];
  }
  if (M == kMod64) set_lo64(v, lo64(v) % lo64(g.mod));
  if (M == kMod128np) mod_reduce127(v, g.mod);
}

// A group value -> its block, in place.
template <int M>
__device__ __forceinline__ void into_block(uint32_t v[4]) {
  if (M == kMod128 || M == kMod128np) v[3] <<= 1;
}

// a = a + b in the group.
template <int M>
__device__ __forceinline__ void gadd(const Group& g, uint32_t a[4],
                                     const uint32_t b[4]) {
  if (M == kXor) {
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] ^= b[w];
  } else if (M == kWrap || M == kMod128) {
    add128(a, b);
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] &= g.mask[w];
  } else if (M == kMod64) {
    set_lo64(a, add_mod64(lo64(a), lo64(b), lo64(g.mod)));
  } else {  // kMod128np: a, b < m < 2^127, so a + b does not wrap
    add128(a, b);
    if (ge128(a, g.mod)) sub128(a, g.mod);
  }
}

// a = -a in the group.
template <int M>
__device__ __forceinline__ void gneg(const Group& g, uint32_t a[4]) {
  if (M == kXor) return;
  if (M == kWrap || M == kMod128) {
    uint32_t z[4] = {0u, 0u, 0u, 0u};
    sub128(z, a);
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] = z[w] & g.mask[w];
  } else if (M == kMod64) {
    const uint64_t x = lo64(a);
    set_lo64(a, x == 0 ? 0 : lo64(g.mod) - x);
  } else if (!is_zero128(a)) {  // kMod128np
    uint32_t d[4] = {g.mod[0], g.mod[1], g.mod[2], g.mod[3]};
    sub128(d, a);
#pragma unroll
    for (int w = 0; w < 4; ++w) a[w] = d[w];
  }
}

// The DPF's share of a leaf v (the seed or Half-Tree high part, its t or
// low bit in the clamped bit): y = +-(from_block(seed) (+ oc where t)),
// negated for party 1, as a block; oc = from_block(ocw).
template <int M>
__device__ __forceinline__ int4 leaf_share(const Group& g, const uint4& v,
                                           const uint32_t oc[4],
                                           uint32_t party) {
  uint32_t y[4] = {v.x, v.y, v.z, v.w & ~1u};
  from_block<M>(g, y);
  if (v.w & 1u) gadd<M>(g, y, oc);
  if (party) gneg<M>(g, y);
  into_block<M>(y);
  return make_int4((int)y[0], (int)y[1], (int)y[2], (int)y[3]);
}

}  // namespace fss
