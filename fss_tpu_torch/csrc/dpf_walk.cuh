// One key's DPF tree walk in registers, shared by the DPF eval kernel
// (dpf_eval.cu) and the fused VDPF eval kernel (vdpf_eval.cu), as
// fss_tpu/ops/vdpf_pallas.py's fused kernel calls dpf_pallas.walk.
//
// Per level: the PRG's mul=2 pair of the seed (ChaCha or AES-MMO,
// prg.cuh), the control bits taken from the LSB of word 3 of each child and
// cleared, the level's correction word XORed in under the mask (0 - t),
// and the child chosen by bit (in_bits-1-i) of x, read from lane
// (pos >> 5) so domains of 33..128 bits take x as 4 lanes.
// The cw is addressed through two strides (level, word), so the caller
// points `key` at wire rows, packed planes or one broadcast key.

#pragma once

#include <cstdint>

#include "prg.cuh"

namespace fss {

// s: the root seed with the clamped bit clear, in; the leaf seed, out.
// t: the party. Returns the leaf's control bit.
template <class Prg>
__device__ __forceinline__ uint32_t dpf_walk(const Prg& prg, uint32_t s[4],
                                             uint32_t t,
                                             const uint32_t* __restrict__ key,
                                             int64_t cw_ls, int64_t cw_ws,
                                             const uint32_t* __restrict__ x,
                                             int in_bits) {
  for (int i = 0; i < in_bits; ++i) {
    uint32_t l[4], r[4];
    prg.expand2(s, l, r);
    const uint32_t* c = key + i * cw_ls;
    const uint32_t tm = 0u - t;
    const uint32_t c3 = __ldg(c + 3 * cw_ws);
    const uint32_t m0 = __ldg(c) & tm;
    const uint32_t m1 = __ldg(c + cw_ws) & tm;
    const uint32_t m2 = __ldg(c + 2 * cw_ws) & tm;
    const uint32_t m3 = c3 & ~1u & tm;
    const uint32_t tl = (l[3] & 1u) ^ (t & c3 & 1u);
    const uint32_t tr = (r[3] & 1u) ^ (t & __ldg(c + 4 * cw_ws) & 1u);
    const int pos = in_bits - 1 - i;
    const bool bit = (__ldg(x + (pos >> 5)) >> (pos & 31)) & 1u;
    s[0] = (bit ? r[0] : l[0]) ^ m0;
    s[1] = (bit ? r[1] : l[1]) ^ m1;
    s[2] = (bit ? r[2] : l[2]) ^ m2;
    s[3] = ((bit ? r[3] : l[3]) & ~1u) ^ m3;
    t = bit ? tr : tl;
  }
  return t;
}

}  // namespace fss
