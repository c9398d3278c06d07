// The two parties of a Gen kernel's key (dpf_gen.cu, dcf_gen.cu): one
// thread runs both (P = 2), or each of two neighbouring lanes runs one
// (P = 1), party = lane & 1. With one party a thread, the pair trades what
// the correction words need of the other party (its off-path child, its
// control bits) through __shfl_xor_sync, and splits the key's stores. That
// halves the PRG blocks and the registers a thread holds and doubles the
// warps that hide the AES lookups' latency.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "prg.cuh"

namespace fss {

template <int P>
struct Parties {
  static_assert(P == 1 || P == 2, "a thread runs one party or both");
  int64_t key;    // the key of this thread
  int me;         // P = 1: this lane's party; P = 2: 0
  unsigned mask;  // P = 1: the warp's lanes whose key is in the batch

  // Every thread of the warp, before any returns: thread `tid`'s key and
  // party.
  __device__ static Parties of(int64_t tid, int64_t batch) {
    Parties q{P == 2 ? tid : tid >> 1, P == 2 ? 0 : (int)(tid & 1), 0u};
    if constexpr (P == 1) q.mask = __ballot_sync(0xFFFFFFFFu, q.key < batch);
    return q;
  }

  // The party of this thread's p-th state.
  __device__ int party(int p) const { return P == 2 ? p : me; }

  // Whether this thread stores the part of the key's output that party q's
  // lane owns.
  __device__ bool stores(int q) const { return P == 2 || me == q; }

  // Party 0's and party 1's 4-word values, from this thread's x[0..P).
  __device__ void both(uint32_t x[P][4], uint32_t x0[4],
                       uint32_t x1[4]) const {
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      if constexpr (P == 2) {
        x0[w] = x[0][w];
        x1[w] = x[1][w];
      } else {
        const uint32_t y = __shfl_xor_sync(mask, x[0][w], 1);
        x0[w] = me ? y : x[0][w];
        x1[w] = me ? x[0][w] : y;
      }
    }
  }

  // The same for a word of bits.
  __device__ void both(uint32_t x[P], uint32_t& x0,
                       uint32_t& x1) const {
    if constexpr (P == 2) {
      x0 = x[0];
      x1 = x[1];
    } else {
      const uint32_t y = __shfl_xor_sync(mask, x[0], 1);
      x0 = me ? y : x[0];
      x1 = me ? x[0] : y;
    }
  }
};

// Per PRG, the parties a Gen kernel's thread runs (P above) and the threads
// of its CTA: with AES one party a thread in 256-thread CTAs, with ChaCha
// both in 128 (PERF.md section 6 has the measurements).
template <class Prg>
constexpr int kGenParties = 2;
template <int MUL, class T>
constexpr int kGenParties<AesPrg<MUL, T>> = 1;
template <class Prg>
constexpr int kGenThreads = 128;
template <int MUL, class T>
constexpr int kGenThreads<AesPrg<MUL, T>> = 256;

}  // namespace fss
