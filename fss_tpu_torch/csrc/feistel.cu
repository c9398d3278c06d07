// The VDMPF's routing on the card: the small-domain PRP (a 4-round Feistel
// network with AES-128 as its round function, cycle-walked into its domain)
// and Cuckoo hashing's Locate. A point x has kappa values x + n k, k <
// kappa, each permuted over the domain D = n kappa: y = PRP_sigma(x + n k),
// bucket = y / b_rt, index = y % b_rt, written at e = i kappa + k for point
// i. The reference's BatchEval also drops a k whose (bucket, index) some
// k' < k already has; that never happens here: the kappa values of one
// point are distinct and the PRP is a bijection on [0, D), so their
// (bucket, index) pairs are distinct too, and no dup flag is kept. The
// second entry runs the same body with kappa 1 and writes y alone: the
// whole permutation over x = 0..D-1 (the PRP's permutation table) or the
// PRP of given points.
//
// Replaces XLA glue, no Pallas kernel: fss_tpu/prp/feistel.py
// (Aes128Feistel.permu, :151, permu_lanes, :201) and the Locate part of
// fss_tpu/schemes/vdmpf.py:route (:118-205). On the TPU, domains up to 2^22
// are a table computed on the host with AES-NI and gathered, and wider ones
// a while_loop of table-gather AES over every lane; the division by b_rt an
// m_rt-way compare-accumulate.
//
// Semantics, bit for bit those of the reference's aes128_feistel.cuh:
// b = ceil(log2 D), half = (b + 1) / 2; round r's AES key is sigma with r
// XORed into byte 0 (the host passes the four schedules, prg.cuh's PrgArg
// with four keys); the round function is AES of the 16 little-endian bytes
// of the right half, read back little-endian and masked to `half` bits;
// four rounds, each XORing it into the left half and swapping; the output
// is (left << half) | right, permuted again while it is >= D. A value at or
// above D (a point at or above the domain) is not walked: bucket -1 and an
// index (or y) of all ones.
//
// Bound on the H100: the bytes (x in, bucket and index out), far below
// a launch's own cost; the AES work is at most the four round functions
// over every right half (4 2^half blocks), and a walk's pass is four
// dependent round functions, 2^(2 half) / D passes a value on average
// (4/3 at the VDMPF bench's D = 3 * 2^16). But a walk's passes are
// geometric and one value's passes are one dependent chain: at the bench
// the longest of 49,242 walks is 10 passes, and a lone warp's pass of
// four dependent AES blocks takes ~2.2 us, so a kernel that walks with AES
// cannot end before ~26 us whatever its grid. The design:
//
//   one thread a value, not a point: e = i kappa + k, no loop over kappa;
//     a CTA owns a contiguous slice of the values;
//   the round functions tabulated where half <= kTabHalf (the bench's 9):
//     each CTA computes the four round functions over every right half
//     (4 2^half entries, four independent AES blocks a thread) into
//     shared memory, and a pass is four dependent lookups; `plan` takes
//     this path where the table's AES is at most twice what the CTA's
//     walks would take; each thread then walks its values of the slice
//     to the end, one after another (walk);
//   elsewhere a pass is four AES blocks, and every pass the CTA compacts
//     the values that walk on into its first threads and fills the rest
//     from its slice (walk_compact: one ballot and one shared atomicAdd a
//     warp, two barriers a pass), so a long walk soon has a scheduler to
//     itself (a quarter faster than `walk` at half 12; its barriers cost
//     the tabulated passes more than they save);
//   a 64-bit value where 2 half <= 64 (the division too), whose round
//     function keeps AES's word 0: the last round computes that word
//     alone, 148 lookups a block; unsigned __int128 only above, where it
//     keeps words 0 and 1 (152);
//   the four Feistel rounds unrolled, their keys constant-bank operands
//     of the __grid_constant__ parameter (no local copy).
//   The division by b_rt is exact shift-subtract over the bits of the
//   largest bucket (6 steps at m_rt = 53), once a value.
//
// The AES tables are AesTables<32, 2> (64 KB a CTA) and a CTA has
// kThreads threads, one CTA an SM once the values outnumber the grid's
// threads; scripts/torch_feistel_variants.py times the other choices
// (patched here) and the first design (scripts/feistel_designs.cu).

#include <cuda_runtime.h>

#include <algorithm>
#include <cmath>
#include <cstdint>

#include "prg.cuh"

namespace {

using AesTables = fss::AesTables<32, 2>;
constexpr int kThreads = 512;
constexpr int kTabHalf = 10;

using Prp = fss::AesPrg<4, AesTables>;
using u128 = unsigned __int128;

// What a launch permutes and how it divides, as 64-bit halves.
struct Walk {
  uint64_t dom_lo, dom_hi;      // the PRP's domain D
  uint64_t step_lo, step_hi;    // n: hash function k permutes x + n k
  uint64_t bsize_lo, bsize_hi;  // b_rt
  int half;                     // bits of each Feistel half, 1..64
  int qbits;                    // bits of the largest bucket, (D - 1) / b_rt
  int kappa;                    // hash functions a point (1 to permute)
  int tab;                      // 1: the round functions tabulated (plan)
};

__device__ __forceinline__ u128 wide(uint64_t lo, uint64_t hi) {
  return (u128)hi << 64 | lo;
}

// A round function of the right half: AES of its 16 little-endian bytes
// (aes_mmo's output XOR the input), words 0 to kOut - 1 kept (1: the half
// has at most 32 bits), masked to `half` bits.
template <int kOut>
__device__ __forceinline__ uint64_t round_fn(const uint32_t (&rk)[44],
                                             uint64_t right, uint64_t mask) {
  const uint32_t in[4] = {(uint32_t)right,
                          kOut > 1 ? (uint32_t)(right >> 32) : 0u, 0u, 0u};
  uint32_t out[kOut];
  fss::aes_mmo<AesTables, kOut>(rk, in, out);
  uint64_t f = out[0] ^ in[0];
  if constexpr (kOut > 1) f |= (uint64_t)(out[1] ^ in[1]) << 32;
  return f & mask;
}

// One pass of the network over v < 2^(2 half) as V: uint64_t for half <=
// 32, unsigned __int128 above.
template <class V>
__device__ __forceinline__ V feistel_pass(const Prp& prp, V v, int half,
                                          uint64_t mask) {
  uint64_t left = (uint64_t)(v >> half) & mask;
  uint64_t right = (uint64_t)v & mask;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint64_t next =
        left ^ round_fn<sizeof(V) == 8 ? 1 : 2>(prp.rk[r], right, mask);
    left = right;
    right = next;
  }
  return (V)left << half | right;
}

// One pass over v < 2^(2 half), half <= kTabHalf, with round r's function
// looked up at ftab[r 2^half + right].
__device__ __forceinline__ uint64_t feistel_pass_tab(const uint32_t* ftab,
                                                     uint64_t v, int half,
                                                     uint32_t mask) {
  uint32_t left = (uint32_t)(v >> half) & mask, right = (uint32_t)v & mask;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const uint32_t next = left ^ ftab[(r << half) | right];
    left = right;
    right = next;
  }
  return (uint64_t)left << half | right;
}

// rem / b for a quotient below 2^qbits; rem becomes the remainder.
template <class V>
__device__ __forceinline__ uint32_t divide(V& rem, V b, int qbits) {
  uint32_t q = 0;
  for (int i = qbits - 1; i >= 0; --i) {
    const V c = b << i;
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

// The CTA's `len` values: each thread walks values threadIdx.x,
// threadIdx.x + kThreads, ... to the end. take(j, v) loads value j into v
// and says whether it is walked; pass(v) is one pass of the network;
// put(j, y) writes the value that landed at y <= last.
template <class V, class Take, class Pass, class Put>
__device__ __forceinline__ void walk(int len, V last, Take take, Pass pass,
                                     Put put) {
  for (int j = threadIdx.x; j < len; j += kThreads) {
    V v = 0;
    if (!take(j, v)) continue;
    do {
      v = pass(v);
    } while (v > last);
    put(j, v);
  }
}

// This warp's lanes that have `pred` get consecutive slots from the shared
// counter: one atomicAdd by a leader, the base by __shfl_sync.
__device__ __forceinline__ int warp_slot(bool pred, int* counter) {
  const unsigned want = __ballot_sync(~0u, pred);
  if (want == 0) return 0;
  const unsigned lane = threadIdx.x % 32;
  const int leader = __ffs(want) - 1;
  int base = 0;
  if (lane == leader) base = atomicAdd(counter, __popc(want));
  base = __shfl_sync(~0u, base, leader);
  return base + __popc(want & ((1u << lane) - 1));
}

// walk's values, compacted every pass: the values that walk on sit in
// threads [0, held) and the slice's next values in the threads after
// them, so only ceil(busy / 32) warps run a pass.
template <class V, class Take, class Pass, class Put>
__device__ __forceinline__ void walk_compact(int len, V last, Take take,
                                             Pass pass, Put put) {
  __shared__ int next;        // the slice's next unwalked value
  __shared__ int carried[2];  // values walking on into pass p + 1, by p % 2
  __shared__ int pool_j[kThreads];
  __shared__ V pool_v[kThreads];
  if (threadIdx.x == 0) {
    next = 0;
    carried[0] = carried[1] = 0;
  }
  __syncthreads();
  for (int p = 0;; ++p) {
    const int held = carried[(p + 1) % 2], base = next;
    if (held == 0 && base >= len) break;  // the same in every thread
    int j = 0;
    V v = 0;
    bool busy = false;
    if ((int)threadIdx.x < held) {
      j = pool_j[threadIdx.x];
      v = pool_v[threadIdx.x];
      busy = true;
    } else {
      j = base + (int)threadIdx.x - held;
      if (j < len) busy = take(j, v);
    }
    if (threadIdx.x == 0) carried[p % 2] = 0;
    __syncthreads();  // the pool and `next` read, carried[p % 2] zeroed
    if (threadIdx.x == 0) next = min(len, base + kThreads - held);
    if (busy) {
      v = pass(v);
      if (v <= last) {
        put(j, v);
        busy = false;
      }
    }
    const int slot = warp_slot(busy, &carried[p % 2]);
    if (busy) {
      pool_j[slot] = j;
      pool_v[slot] = v;
    }
    __syncthreads();  // the pool, `next` and carried[p % 2] written
  }
}

// xs: [count] words (x_lanes 1), [count, 4] lanes (4), or none (0: x is
// the point's index); `total` = count * kappa values, CTA c walking
// [c slice, (c + 1) slice). kRoute: bucket and index [count, kappa]; else
// y into `index` ([count] words or [count, 4] lanes, index_lanes).
template <class V, bool kRoute>
__global__ void __launch_bounds__(kThreads)
    feistel_kernel(const uint32_t* __restrict__ xs, int x_lanes,
                   int64_t total, int slice, const Walk w,
                   int32_t* __restrict__ bucket,
                   uint32_t* __restrict__ index, int index_lanes,
                   const __grid_constant__ Prp prp) {
  constexpr bool kTab = sizeof(V) == 8;
  __shared__ uint32_t ftab[kTab ? 4 << kTabHalf : 1];
  prp.init();  // every thread, then a barrier
  const uint64_t mask = w.half >= 64 ? ~0ull : (1ull << w.half) - 1;
  if constexpr (kTab) {
    if (w.tab) {  // the four round functions over every right half
      for (int x = threadIdx.x; x < 1 << w.half; x += kThreads) {
#pragma unroll
        for (int r = 0; r < 4; ++r)  // four independent AES blocks
          ftab[r << w.half | x] = (uint32_t)round_fn<1>(prp.rk[r], x, mask);
      }
      __syncthreads();
    }
  }
  const int64_t lo = (int64_t)blockIdx.x * slice;
  const int len = total - lo < slice ? (int)(total - lo) : slice;
  const u128 last = wide(w.dom_lo, w.dom_hi) - 1;
  const u128 step = wide(w.step_lo, w.step_hi);

  // Value j of the slice into v; false (and written at once) if it is at
  // or above D.
  const auto take = [&](int j, V& v) {
    const int64_t e = lo + j;
    uint64_t i = (uint64_t)e, k = 0;
    if (w.kappa > 1) {
      i = (uint64_t)e / (uint32_t)w.kappa;
      k = (uint64_t)e - i * (uint32_t)w.kappa;
    }
    u128 x = i;
    if (x_lanes == 1) {
      x = __ldg(xs + i);
    } else if (x_lanes == 4) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(xs) + i);
      x = (u128)q.w << 96 | (u128)q.z << 64 | (u128)q.y << 32 | q.x;
    }
    x += step * k;
    if (x <= last) {
      v = (V)x;
      return true;
    }
    if constexpr (kRoute) bucket[e] = -1;
    store(index, e, ~(u128)0, index_lanes);
    return false;
  };
  // Value j's y < D: bucket y / b_rt and index y % b_rt, or y alone.
  const auto put = [&](int j, V y) {
    const int64_t e = lo + j;
    if constexpr (kRoute) {
      bucket[e] =
          (int32_t)divide<V>(y, (V)wide(w.bsize_lo, w.bsize_hi), w.qbits);
    }
    store(index, e, y, index_lanes);
  };
  if constexpr (kTab) {
    if (w.tab) {  // a pass is four lookups
      walk<V>(len, (V)last, take,
              [&](V v) {
                return feistel_pass_tab(ftab, v, w.half, (uint32_t)mask);
              },
              put);
      return;
    }
  }
  walk_compact<V>(len, (V)last, take,  // a pass is four AES blocks
                  [&](V v) { return feistel_pass<V>(prp, v, w.half, mask); },
                  put);
}

// The SMs of the current device, asked once a device.
int sm_count() {
  static int sms[64] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= 64) return 132;
  if (sms[dev] == 0) {
    int n = 0;
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    sms[dev] = n > 0 ? n : 132;
  }
  return sms[dev];
}

// A launch over `total` values: CTAs, values a CTA's slice, threads a CTA,
// and whether the round functions are tabulated: where half <= kTabHalf
// and the table's 4 2^half AES blocks are at most twice those a CTA's
// walks are expected to take (4 2^(2 half) / D a value).
void plan(int64_t total, const Walk& w, int64_t out[4]) {
  const int64_t ctas = sm_count();
  const int64_t slice = std::max<int64_t>(kThreads, (total + ctas - 1) / ctas);
  out[0] = (total + slice - 1) / slice;
  out[1] = slice;
  out[2] = kThreads;
  const double dom = std::ldexp((double)w.dom_hi, 64) + (double)w.dom_lo;
  const double walks = std::min(total, slice) * 4 *
                       std::ldexp(1.0, 2 * w.half) / dom;
  out[3] = w.half <= kTabHalf && std::ldexp(4.0, w.half) <= 2 * walks;
}

template <bool kRoute>
int launch(const void* xs, int x_lanes, int64_t total, const Walk& w,
           void* bucket, void* index, int index_lanes, const void* prg,
           void* stream) {
  if (total <= 0) return 0;
  const fss::PrgArg& a = *static_cast<const fss::PrgArg*>(prg);
  if (a.kind != fss::kPrgAes || w.half < 1 || w.half > 64 ||
      (x_lanes != 0 && x_lanes != 1 && x_lanes != 4) ||
      (index_lanes != 1 && index_lanes != 4) || w.kappa < 1 || w.qbits < 0 ||
      w.qbits > 32)
    return (int)cudaErrorInvalidValue;
  int64_t g[4];
  plan(total, w, g);
  if (g[0] > 0x7fffffff || g[1] > (1 << 30)) return (int)cudaErrorInvalidValue;
  Walk wt = w;
  wt.tab = (int)g[3];
  const auto go = [&](auto kernel) {
    return fss::launch_kernel<Prp>(
        kernel, (unsigned)g[0], kThreads, (cudaStream_t)stream,
        (const uint32_t*)xs, x_lanes, total, (int)g[1], wt, (int32_t*)bucket,
        (uint32_t*)index, index_lanes, Prp::from(a));
  };
  return 2 * w.half <= 64 ? go(&feistel_kernel<uint64_t, kRoute>)
                          : go(&feistel_kernel<u128, kRoute>);
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
  return launch<true>(xs, x_lanes, count * kappa, w, bucket, index,
                      index_lanes, prg, stream);
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

// The plan of a launch over `total` values of a PRP over D = dom with
// halves of `half` bits, on the current device (out: CTAs, values a CTA,
// threads a CTA, 1 if the round functions are tabulated); returns the
// CUDA error.
extern "C" int fss_feistel_plan(int64_t total, uint64_t dom_lo,
                                uint64_t dom_hi, int half, int64_t* out) {
  const Walk w{dom_lo, dom_hi, 0, 0, 0, 0, half, 0, 1};
  plan(total, w, out);
  return (int)cudaGetLastError();
}
