// The VDMPF's routing on the card: the small-domain PRP (a 4-round Feistel
// network with AES-128 as its round function, cycle-walked into its domain)
// and Cuckoo hashing's Locate. One thread a point holds all kappa hash
// functions' values of that point: y = PRP_sigma(x + n k) over the domain
// D = n kappa, bucket = y / b_rt, index = y % b_rt. The reference's
// BatchEval also drops a k whose (bucket, index) some k' < k already has;
// that never happens here: the kappa values x + n k of one point are
// distinct and the PRP is a bijection on [0, D), so their (bucket, index)
// pairs are distinct too, and no dup flag is kept. The second entry runs
// the same body with kappa 1 and writes y alone: the whole permutation over
// x = 0..D-1 (the PRP's permutation table) or the PRP of given points.
//
// Replaces XLA glue, no Pallas kernel: fss_tpu/prp/feistel.py
// (Aes128Feistel.permu, :151, permu_lanes, :201) and the Locate part of
// fss_tpu/schemes/vdmpf.py:route (:118-205). On the TPU, domains up to 2^22
// are a table computed on the host with AES-NI and gathered, and wider ones
// a while_loop of table-gather AES over every lane; the division by b_rt an
// m_rt-way compare-accumulate. Here a value is one unsigned __int128, so the
// narrow domains (halves of up to 32 bits) and the wide ones (up to 64)
// take one path; the division is exact shift-subtract over the bits of the
// largest bucket (6 steps at m_rt = 53).
//
// Semantics, bit for bit those of the reference's aes128_feistel.cuh:
// b = ceil(log2 D), half = (b + 1) / 2; round r's AES key is sigma with r
// XORed into byte 0 (the host passes the four schedules, prg.cuh's PrgArg
// with four keys); the round function is AES of the 16 little-endian bytes
// of the right half, read back little-endian and masked to `half` bits;
// four rounds, each XORing it into the left half and swapping; the output
// is (left << half) | right, permuted again while it is >= D.
//
// AES is aes.cuh's: AesPrg<4, Tables>::from byte-swaps the schedules the way
// aes_mmo expects, and AES(x) = aes_mmo(x) ^ x. Bound on the H100: the
// round functions' table lookups, 160 a block, 4 blocks a pass, with the
// expected passes of the cycle walk 2^(2 half) / D < 4; the bytes (x in,
// bucket and index out) are a small fraction. The tables are
// AesTables<32, 1> (32 KB a CTA): at the bench's 16,414 points (128 CTAs of
// 128 threads, about one an SM) the fill of <32, 2>'s 64 KB would cost about
// as much as the lookups it saves.

#include <cuda_runtime.h>

#include <cstdint>

#include "prg.cuh"

namespace {

using AesTables = fss::AesTables<32, 1>;
using Prp = fss::AesPrg<4, AesTables>;
using u128 = unsigned __int128;

constexpr int kThreads = 128;

// What a launch permutes and how it divides, as 64-bit halves.
struct Walk {
  uint64_t dom_lo, dom_hi;      // the PRP's domain D
  uint64_t step_lo, step_hi;    // n: hash function k permutes x + n k
  uint64_t bsize_lo, bsize_hi;  // b_rt
  int half;                     // bits of each Feistel half, 1..64
  int qbits;                    // bits of the largest bucket, (D - 1) / b_rt
  int kappa;                    // hash functions a point (1 to permute)
};

__device__ __forceinline__ u128 wide(uint64_t lo, uint64_t hi) {
  return (u128)hi << 64 | lo;
}

// One pass of the network over v < 2^(2 half); the halves fit 64 bits.
__device__ __forceinline__ u128 feistel_pass(const Prp& prp, u128 v,
                                             int half, uint64_t mask) {
  uint64_t left = (uint64_t)(v >> half) & mask;
  uint64_t right = (uint64_t)v & mask;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t in[4] = {(uint32_t)right, (uint32_t)(right >> 32), 0u,
                            0u};
    uint32_t out[4];
    fss::aes_mmo<AesTables>(prp.rk[r], in, out);
    const uint64_t f =
        ((uint64_t)(out[1] ^ in[1]) << 32 | (out[0] ^ in[0])) & mask;
    const uint64_t next = left ^ f;
    left = right;
    right = next;
  }
  return (u128)left << half | right;
}

// The PRP of v < D: passes until the value lands below D. All ones for
// v >= D, unwalked.
__device__ __forceinline__ u128 permute(const Prp& prp, u128 v, u128 dom,
                                        int half, uint64_t mask) {
  if (v >= dom) return ~(u128)0;
  do {
    v = feistel_pass(prp, v, half, mask);
  } while (v >= dom);
  return v;
}

// rem / b for a quotient below 2^qbits; rem becomes the remainder.
__device__ __forceinline__ uint32_t divide(u128& rem, u128 b, int qbits) {
  uint32_t q = 0;
  for (int i = qbits - 1; i >= 0; --i) {
    const u128 c = b << i;
    if (rem >= c) {
      rem -= c;
      q |= 1u << i;
    }
  }
  return q;
}

__device__ __forceinline__ void store(uint32_t* out, int64_t e, u128 v,
                                      int lanes) {
  if (lanes == 1) {
    out[e] = (uint32_t)v;
    return;
  }
  reinterpret_cast<uint4*>(out)[e] =
      make_uint4((uint32_t)v, (uint32_t)(v >> 32), (uint32_t)(v >> 64),
                 (uint32_t)(v >> 96));
}

// xs: [count] words (x_lanes 1), [count, 4] lanes (4), or none (0: x is
// the thread's index). kRoute: bucket and index [count, kappa]; else y
// into `index` ([count] words or [count, 4] lanes, index_lanes).
template <bool kRoute>
__global__ void __launch_bounds__(kThreads)
    feistel_kernel(const uint32_t* __restrict__ xs, int x_lanes,
                   int64_t count, const Walk w, int32_t* __restrict__ bucket,
                   uint32_t* __restrict__ index, int index_lanes,
                   const Prp prp) {
  prp.init();  // before any thread leaves: the shared tables
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  u128 x = (u128)(uint64_t)i;
  if (x_lanes == 1) {
    x = __ldg(xs + i);
  } else if (x_lanes == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xs) + i);
    x = (u128)v.w << 96 | (u128)v.z << 64 | (u128)v.y << 32 | v.x;
  }
  const u128 dom = wide(w.dom_lo, w.dom_hi);
  const uint64_t mask = w.half >= 64 ? ~0ull : (1ull << w.half) - 1;
  if constexpr (!kRoute) {
    store(index, i, permute(prp, x, dom, w.half, mask), index_lanes);
  } else {
    const u128 step = wide(w.step_lo, w.step_hi);
    const u128 bsize = wide(w.bsize_lo, w.bsize_hi);
    u128 v = x;
    for (int k = 0; k < w.kappa; ++k, v += step) {
      u128 rem = permute(prp, v, dom, w.half, mask);
      const uint32_t b = v >= dom ? ~0u : divide(rem, bsize, w.qbits);
      const int64_t e = i * w.kappa + k;
      bucket[e] = (int32_t)b;
      store(index, e, rem, index_lanes);
    }
  }
}

template <bool kRoute>
int launch(const void* xs, int x_lanes, int64_t count, const Walk& w,
           void* bucket, void* index, int index_lanes, const void* prg,
           void* stream) {
  if (count <= 0) return 0;
  const fss::PrgArg& a = *static_cast<const fss::PrgArg*>(prg);
  if (a.kind != fss::kPrgAes || w.half < 1 || w.half > 64 ||
      (x_lanes != 0 && x_lanes != 1 && x_lanes != 4) ||
      (index_lanes != 1 && index_lanes != 4) || w.kappa < 1 || w.qbits < 0 ||
      w.qbits > 32)
    return (int)cudaErrorInvalidValue;
  const unsigned blocks = (unsigned)((count + kThreads - 1) / kThreads);
  return fss::launch_kernel<Prp>(
      feistel_kernel<kRoute>, blocks, kThreads, (cudaStream_t)stream,
      (const uint32_t*)xs, x_lanes, count, w, (int32_t*)bucket,
      (uint32_t*)index, index_lanes, Prp::from(a));
}

}  // namespace

// Locate for `count` points: xs [count] words (x_lanes 1) or [count, 4]
// lanes (4); bucket [count, kappa] int32, index [count, kappa] words
// (index_lanes 1) or [count, kappa, 4] lanes (4).
// The PRP's domain D and the step n as 64-bit halves; qbits: the bit length
// of (D - 1) / b_rt. prg: a host fss::PrgArg with the 4 round keys.
extern "C" int fss_feistel_route(const void* xs, int x_lanes, int64_t count,
                                 int kappa, uint64_t dom_lo, uint64_t dom_hi,
                                 uint64_t step_lo, uint64_t step_hi,
                                 uint64_t bsize_lo, uint64_t bsize_hi,
                                 int half, int qbits, void* bucket,
                                 void* index, int index_lanes,
                                 const void* prg, void* stream) {
  const Walk w{dom_lo, dom_hi, step_lo, step_hi, bsize_lo, bsize_hi,
               half,   qbits,  kappa};
  return launch<true>(xs, x_lanes, count, w, bucket, index, index_lanes, prg,
                      stream);
}

// y = PRP(x) for `count` points: xs as above, or null (x_lanes 0) for x =
// 0..count-1; y [count] words (y_lanes 1) or [count, 4] lanes (4).
extern "C" int fss_feistel_permute(const void* xs, int x_lanes,
                                   int64_t count, uint64_t dom_lo,
                                   uint64_t dom_hi, int half, void* y,
                                   int y_lanes, const void* prg,
                                   void* stream) {
  const Walk w{dom_lo, dom_hi, 0, 0, 0, 0, half, 0, 1};
  return launch<false>(xs, x_lanes, count, w, nullptr, y, y_lanes, prg,
                       stream);
}
