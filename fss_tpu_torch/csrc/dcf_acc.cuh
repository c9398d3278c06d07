// The DCF value accumulator of the Eval and EvalAll kernels (dcf_eval.cu,
// dcf_eval_all.cu), one mode per group kind (group.cuh).
//
// Counterpart of the accumulator in fss_tpu/ops/dcf_pallas.py (module
// docstring and _make_kernel's acc / vfix). Each level adds two raw
// contributions, the chosen child's value block and the masked value CW,
// both with the clamped bit clear. The accumulator holds a raw sum that the
// finalize (ops/dcf_cuda.py:acc_to_value) turns into a group value once:
//
//   kXor       XOR of the blocks.
//   kWrap      128-bit wrapping sum; every width the group keeps divides
//              2^128, so masking once at the finalize equals per-step adds.
//   kMod64     each contribution masked to the group's bits first, so the
//              128-bit sum is the exact integer sum (< 2^(bits+8)).
//   kMod128    each contribution masked (clamped bit) and decoded
//              (w3 >> 1); 128-bit wrapping sum of the decoded values.
//   kMod128np  as kMod128, but summed exactly in 5 words (160 bits): at
//              most 2 * 128 terms below 2^127 stay below 2^135.
//
// Party negation distributes over the sum, so it is left to the finalize,
// which acc_value starts: the raw sum -> its group value (the device form of
// fss_tpu_torch/ops/dcf_cuda.py:acc_to_value). dcf_share is the whole
// finalize of one leaf (ops/dcf_cuda.py:finalize), the epilogue of both
// kernels.

#pragma once

#include <cstdint>

#include "group.cuh"

namespace fss {

template <int M>
struct Acc {
  static constexpr int kWords = M == kMod128np ? 5 : 4;
};

// Mask, and for 128-bit groups decode, one contribution (in place).
template <int M>
__device__ __forceinline__ void vfix(uint32_t c[4], const uint32_t vmask[4]) {
  if (M == kMod64 || M == kMod128 || M == kMod128np) {
#pragma unroll
    for (int w = 0; w < 4; ++w) c[w] &= vmask[w];
  }
  if (M == kMod128 || M == kMod128np) c[3] >>= 1;
}

// acc += c (c already through vfix).
template <int M>
__device__ __forceinline__ void acc_add(uint32_t acc[Acc<M>::kWords],
                                        const uint32_t c[4]) {
  if (M == kXor) {
#pragma unroll
    for (int w = 0; w < 4; ++w) acc[w] ^= c[w];
  } else if (M == kMod128np) {
    asm("add.cc.u32 %0, %0, %5;\n\t"
        "addc.cc.u32 %1, %1, %6;\n\t"
        "addc.cc.u32 %2, %2, %7;\n\t"
        "addc.cc.u32 %3, %3, %8;\n\t"
        "addc.u32 %4, %4, 0;"
        : "+r"(acc[0]), "+r"(acc[1]), "+r"(acc[2]), "+r"(acc[3]),
          "+r"(acc[4])
        : "r"(c[0]), "r"(c[1]), "r"(c[2]), "r"(c[3]));
  } else {
    add128(acc, c);
  }
}

// acc += vfix(c): one contribution, masked and decoded, added.
template <int M>
__device__ __forceinline__ void accumulate(uint32_t acc[Acc<M>::kWords],
                                           uint32_t c[4],
                                           const uint32_t vmask[4]) {
  vfix<M>(c, vmask);
  acc_add<M>(acc, c);
}

// v = the group value of the raw accumulator `acc` (g: group.cuh's mask and
// modulus of the group).
template <int M>
__device__ __forceinline__ void acc_value(const Group& g,
                                          const uint32_t acc[Acc<M>::kWords],
                                          uint32_t v[4]) {
  if constexpr (M == kMod128np) {
    mod_reduce160(acc, g.mod, v);  // the exact sum, below 2^135
  } else {
#pragma unroll
    for (int w = 0; w < 4; ++w) v[w] = acc[w];
    if constexpr (M == kWrap || M == kMod128) {  // decoded already
#pragma unroll
      for (int w = 0; w < 4; ++w) v[w] &= g.mask[w];
    } else if constexpr (M == kMod64) {
      // The exact sum, below 2^(bits+8) <= 2^72: (hi 2^64 + lo) mod m with
      // 2^64 mod m folded in by double-and-add over hi's 8 bits.
      const uint64_t m = lo64(g.mod);
      const uint64_t c = (0ull - m) % m;
      uint64_t h = 0;
      for (int bit = 7; bit >= 0; --bit) {
        h = add_mod64(h, h, m);
        if ((v[2] >> bit) & 1u) h = add_mod64(h, c, m);
      }
      set_lo64(v, add_mod64(lo64(v) % m, h, m));
    }
  }
}

// The share of a leaf with final seed s (clamped bit clear), control bit t
// and raw accumulator acc, as a block:
//   y = +-(acc_value(acc) + from_block(s) (+ vl where t)),
// negated for party 1; vl = from_block(v_last), v_last the final value CW
// (cws row n words 4-7), read only where t is set.
template <int M>
__device__ __forceinline__ int4 dcf_share(const Group& g,
                                          const uint32_t acc[Acc<M>::kWords],
                                          const uint32_t s[4], uint32_t t,
                                          const uint32_t vl[4],
                                          uint32_t party) {
  uint32_t y[4];
  acc_value<M>(g, acc, y);
  uint32_t term[4] = {s[0], s[1], s[2], s[3]};
  from_block<M>(g, term);
  if (t) gadd<M>(g, term, vl);
  gadd<M>(g, y, term);
  if (party) gneg<M>(g, y);
  into_block<M>(y);
  return make_int4((int)y[0], (int)y[1], (int)y[2], (int)y[3]);
}

}  // namespace fss
