// The Feistel route kernel's first design (one thread a point, its kappa
// walks one after another, every value an unsigned __int128, the four
// Feistel rounds and their four AES blocks unrolled), kept beside
// fss_tpu_torch/csrc/feistel.cu for scripts/torch_feistel_variants.py. It
// has the same two C entry points and writes the same bytes. With the
// choices below at their defaults it is that first design; the variants
// script patches them:
//
//   kUnrollRounds  false: `#pragma unroll 1` on the four Feistel rounds,
//                  round r's key picked by index, so the pass holds one
//                  AES block's code where it held four;
//   kNarrow64      true: a value is one uint64_t where 2 half <= 64 (the
//                  division too), unsigned __int128 only above.
//
// Semantics as in csrc/feistel.cu.

#include <cuda_runtime.h>

#include <cstdint>

#include "prg.cuh"

namespace {

constexpr bool kUnrollRounds = true;
constexpr bool kNarrow64 = false;

using AesTables = fss::AesTables<32, 1>;
using Prp = fss::AesPrg<4, AesTables>;
using u128 = unsigned __int128;

constexpr int kThreads = 128;

struct Walk {
  uint64_t dom_lo, dom_hi;
  uint64_t step_lo, step_hi;
  uint64_t bsize_lo, bsize_hi;
  int half;
  int qbits;
  int kappa;
};

__device__ __forceinline__ u128 wide(uint64_t lo, uint64_t hi) {
  return (u128)hi << 64 | lo;
}

__device__ __forceinline__ void round_fn(const Prp& prp, int r,
                                         uint64_t& left, uint64_t& right,
                                         uint64_t mask) {
  const uint32_t in[4] = {(uint32_t)right, (uint32_t)(right >> 32), 0u, 0u};
  uint32_t out[4];
  fss::aes_mmo<AesTables>(prp.rk[r], in, out);
  const uint64_t f =
      ((uint64_t)(out[1] ^ in[1]) << 32 | (out[0] ^ in[0])) & mask;
  const uint64_t next = left ^ f;
  left = right;
  right = next;
}

template <class V>
__device__ __forceinline__ V feistel_pass(const Prp& prp, V v, int half,
                                          uint64_t mask) {
  uint64_t left = (uint64_t)(v >> half) & mask;
  uint64_t right = (uint64_t)v & mask;
  if constexpr (kUnrollRounds) {
#pragma unroll
    for (int r = 0; r < 4; ++r) round_fn(prp, r, left, right, mask);
  } else {
#pragma unroll 1
    for (int r = 0; r < 4; ++r) round_fn(prp, r, left, right, mask);
  }
  return (V)left << half | right;
}

// The PRP of v <= last (the domain's last value) as V; all ones above.
template <class V>
__device__ __forceinline__ u128 permute(const Prp& prp, u128 v, u128 last,
                                        int half, uint64_t mask) {
  if (v > last) return ~(u128)0;
  V x = (V)v;
  do {
    x = feistel_pass<V>(prp, x, half, mask);
  } while (x > (V)last);
  return x;
}

template <class V>
__device__ __forceinline__ uint32_t divide(u128& rem128, u128 b128,
                                           int qbits) {
  V rem = (V)rem128;
  const V b = (V)b128;
  uint32_t q = 0;
  for (int i = qbits - 1; i >= 0; --i) {
    const V c = b << i;
    if (rem >= c) {
      rem -= c;
      q |= 1u << i;
    }
  }
  rem128 = rem;
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

template <class V, bool kRoute>
__global__ void __launch_bounds__(kThreads)
    feistel_kernel(const uint32_t* __restrict__ xs, int x_lanes,
                   int64_t count, const Walk w, int32_t* __restrict__ bucket,
                   uint32_t* __restrict__ index, int index_lanes,
                   const Prp prp) {
  prp.init();
  const int64_t i = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  u128 x = (u128)(uint64_t)i;
  if (x_lanes == 1) {
    x = __ldg(xs + i);
  } else if (x_lanes == 4) {
    const uint4 v = __ldg(reinterpret_cast<const uint4*>(xs) + i);
    x = (u128)v.w << 96 | (u128)v.z << 64 | (u128)v.y << 32 | v.x;
  }
  const u128 last = wide(w.dom_lo, w.dom_hi) - 1;
  const uint64_t mask = w.half >= 64 ? ~0ull : (1ull << w.half) - 1;
  if constexpr (!kRoute) {
    store(index, i, permute<V>(prp, x, last, w.half, mask), index_lanes);
  } else {
    const u128 step = wide(w.step_lo, w.step_hi);
    const u128 bsize = wide(w.bsize_lo, w.bsize_hi);
    u128 v = x;
    for (int k = 0; k < w.kappa; ++k, v += step) {
      u128 rem = permute<V>(prp, v, last, w.half, mask);
      const uint32_t b = v > last ? ~0u : divide<V>(rem, bsize, w.qbits);
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
  if (kNarrow64 && 2 * w.half <= 64)
    return fss::launch_kernel<Prp>(
        feistel_kernel<uint64_t, kRoute>, blocks, kThreads,
        (cudaStream_t)stream, (const uint32_t*)xs, x_lanes, count, w,
        (int32_t*)bucket, (uint32_t*)index, index_lanes, Prp::from(a));
  return fss::launch_kernel<Prp>(
      feistel_kernel<u128, kRoute>, blocks, kThreads, (cudaStream_t)stream,
      (const uint32_t*)xs, x_lanes, count, w, (int32_t*)bucket,
      (uint32_t*)index, index_lanes, Prp::from(a));
}

}  // namespace

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

extern "C" int fss_feistel_permute(const void* xs, int x_lanes,
                                   int64_t count, uint64_t dom_lo,
                                   uint64_t dom_hi, int half, void* y,
                                   int y_lanes, const void* prg,
                                   void* stream) {
  const Walk w{dom_lo, dom_hi, 0, 0, 0, 0, half, 0, 1};
  return launch<false>(xs, x_lanes, count, w, nullptr, y, y_lanes, prg,
                       stream);
}
