// The Half-Tree point Eval kernel (csrc/ht_eval.cu) with every design
// choice that scripts/torch_ht_eval_variants.py measures as a constant at
// the top: the AES tables' layout, wire rows through a Tensor Memory
// Accelerator ring or loads a level, the ring's slots, keys a thread, the
// threads of a CTA that walk keys, and x loaded once or once a level. The
// script builds copies of csrc/ with this file in place of ht_eval.cu (the
// same C entry point, fss_ht_eval), its constants patched, and holds each
// byte-exact against the plain version before timing it. Not built by the
// package: csrc/ht_eval.cu is the design chosen from these measurements
// (PERF.md section 6), one 16-byte load of a row a level in 1024-thread
// CTAs; the TMA ring measured slower in every configuration.
//
// With kAesTmaRows, the TMA copies each level's rows of the CTA's keys, a
// box of 4 words x the CTA's key threads, into a ring of kRing slots in
// shared memory (a full and an empty mbarrier a slot, as csrc/ring.cuh's
// chains); a producer warp beside the key threads keeps the ring filled,
// and a thread reads its row with one 16-byte shared load. A broadcast key
// (key stride 0) takes the load path. The copies need a 16-byte aligned
// cws, which ops/ht_cuda.py hands the kernel. The tensor map comes from
// cuTensorMapEncodeTiled, looked up with cudaGetDriverEntryPoint (no
// -lcuda).

#include <cuda.h>
#include <cuda_runtime.h>

#include "prg.cuh"
#include "ring.cuh"

namespace {

// The design's choices with AES (PERF.md section 6 has the measurements;
// scripts/torch_ht_eval_variants.py times the alternatives): the tables'
// layout (aes.cuh), wire rows through the TMA ring or one 16-byte load a
// level, the ring's slots, keys a thread (interleaved: their blocks' lookups
// independent), the threads of a CTA that walk keys, and x loaded once or
// once a level. ChaCha, ALU-bound, keeps four 4-byte loads of a row and x
// once a level in 128-thread CTAs (HtDesign below): with the 16-byte loads
// it measured 4% slower.
using AesTables = fss::AesTables<32, 2>;
constexpr bool kAesTmaRows = true;
constexpr int kRing = 3;
constexpr int kAesKeys = 1;
constexpr int kAesThreads = 128;
constexpr bool kAesXOnce = true;

template <class Prg>
struct HtDesign {
  static constexpr bool kTma = false, kWide = false, kXOnce = false;
  static constexpr int kKeys = 1, kThreads = 128;
};
template <int MUL, class T>
struct HtDesign<fss::AesPrg<MUL, T>> {
  static constexpr bool kTma = kAesTmaRows, kWide = true,
                        kXOnce = kAesXOnce;
  static constexpr int kKeys = kAesKeys, kThreads = kAesThreads;
};

// Threads a CTA launches: with the TMA rows one producer warp beside those
// that walk keys.
template <class Prg, bool kTma>
constexpr int kHtThreads = HtDesign<Prg>::kThreads + (kTma ? 32 : 0);

// Dynamic shared memory a CTA takes: the PRG's tables and, with the TMA
// rows, the ring (128-byte aligned after them).
template <class Prg, bool kTma>
constexpr size_t kHtSmem =
    fss::kPrgSmem<Prg> +
    (kTma ? 128 + (size_t)kRing * HtDesign<Prg>::kKeys *
                      HtDesign<Prg>::kThreads * 16
          : 0);

static_assert(kRing >= 2, "the ring keeps at least one level in flight");
static_assert(kAesThreads % 32 == 0 && (!kAesTmaRows || kAesThreads <= 256),
              "a TMA box holds at most 256 rows");

__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar,
                                               uint32_t bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(
          fss::smem(bar)),
      "r"(bytes)
      : "memory");
}

// The box at (word c0, key c1) of `map` into shared memory at dst, its
// bytes counted on `bar`.
__device__ __forceinline__ void tma_box(void* dst, const CUtensorMap* map,
                                        uint64_t* bar, int c0, int c1) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx::"
      "bytes [%0], [%1, {%3, %4}], [%2];" ::"r"(fss::smem(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(fss::smem(bar)), "r"(c0),
      "r"(c1)
      : "memory");
}

// kTma: wire rows through the ring (`rows` a tensor map over cws as
// [B, in_bits * 8] words, filled by the CTA's last warp); else loads of
// the row a level (HtDesign<Prg>::kWide: one 16-byte load, else four).
template <class Prg, bool kTma>
__global__ void ht_eval_kernel(const uint32_t* __restrict__ seeds,
                               int64_t seed_ks,
                               const uint32_t* __restrict__ cws,
                               int64_t cw_ks,
                               const __grid_constant__ CUtensorMap rows,
                               const uint32_t* __restrict__ xs, int64_t x_ks,
                               int4* __restrict__ high,
                               int32_t* __restrict__ low, int64_t batch,
                               int in_bits, int party, uint32_t hk0,
                               uint32_t hk1, uint32_t hk2, uint32_t hk3,
                               const Prg prg) {
  using D = HtDesign<Prg>;
  constexpr int K = D::kKeys, T = D::kThreads;
  constexpr int kSlot = K * T * 4;  // words of a ring slot: K boxes
  __shared__ uint64_t full[kRing], empty[kRing];
  const int tid = threadIdx.x;
  const int64_t base = (int64_t)blockIdx.x * T * K;
  uint32_t* ring = nullptr;
  if constexpr (kTma) {
    if (tid == 0) {
      for (int s = 0; s < kRing; ++s) {
        fss::mbar_init(&full[s], 1);
        fss::mbar_init(&empty[s], T / 32);
      }
      asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
    }
    ring = reinterpret_cast<uint32_t*>(
        (reinterpret_cast<uintptr_t>(fss::aes_smem) + fss::kPrgSmem<Prg> +
         127) & ~uintptr_t{127});
  }
  prg.init();  // before any thread leaves: AES fills its shared tables (and
               // its barrier publishes the ring's mbarriers)
  if constexpr (kTma) {
    if (tid >= T) {  // the producer warp: one lane fills the ring
      if (tid == T) {
        for (int lv = 0; lv < in_bits; ++lv) {
          const int s = lv % kRing;
          if (lv >= kRing) fss::mbar_wait(&empty[s], (lv / kRing - 1) & 1);
          mbar_expect_tx(&full[s], kSlot * 4);
#pragma unroll
          for (int j = 0; j < K; ++j)
            tma_box(ring + s * kSlot + j * T * 4, &rows, &full[s], 8 * lv,
                    (int)(base + j * T));
        }
        // Leave once the last copy has landed.
        const int lv = in_bits - 1;
        fss::mbar_wait(&full[lv % kRing], (lv / kRing) & 1);
      }
      return;
    }
  } else {
    if (base + tid >= batch) return;
  }

  // Key j of this thread: base + j * T + tid (neighbouring lanes on
  // neighbouring keys); a key past the batch reads the last key's inputs
  // and stores nothing (with TMA every thread takes part in every level).
  const uint32_t* key[K];
  const uint32_t* x[K];
  uint32_t node[K][4], xl[K][4];
  bool active[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const int64_t k0 = base + j * T + tid;
    active[j] = k0 < batch;
    const int64_t k = active[j] ? k0 : batch - 1;
    const uint32_t* sp = seeds + k * seed_ks;
    node[j][0] = __ldg(sp);
    node[j][1] = __ldg(sp + 1);
    node[j][2] = __ldg(sp + 2);
    node[j][3] = (__ldg(sp + 3) & ~1u) | (uint32_t)party;
    key[j] = cws + k * cw_ks;
    x[j] = xs + k * x_ks;
    if constexpr (D::kXOnce) {
      xl[j][0] = __ldg(x[j]);
#pragma unroll
      for (int w = 1; w < 4; ++w)
        xl[j][w] = x_ks == 4 ? __ldg(x[j] + w) : 0u;
    }
  }

  // Bit (in_bits-1-i) of key j's x: from its lanes in registers, or loaded.
  auto x_bit = [&](int j, int pos) -> uint32_t {
    uint32_t lane;
    if constexpr (D::kXOnce) {
      const int l = pos >> 5;
      lane = l == 0   ? xl[j][0]
             : l == 1 ? xl[j][1]
             : l == 2 ? xl[j][2]
                      : xl[j][3];
    } else {
      lane = __ldg(x[j] + (pos >> 5));
    }
    return (lane >> (pos & 31)) & 1u;
  };
  // Words 0..3 of row i of key j: from the ring (after its full barrier),
  // one 16-byte load, or four 4-byte ones.
  auto row = [&](int i, int j) -> uint4 {
    if constexpr (kTma) {
      return *reinterpret_cast<const uint4*>(ring + (i % kRing) * kSlot +
                                             (j * T + tid) * 4);
    } else if constexpr (D::kWide) {
      return __ldg(reinterpret_cast<const uint4*>(key[j] + i * 8));
    } else {
      const uint32_t* c = key[j] + i * 8;
      return make_uint4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3));
    }
  };

  for (int i = 0; i < in_bits - 1; ++i) {
    const int pos = in_bits - 1 - i;
    uint32_t h[K][4], tm[K], xm[K];
#pragma unroll
    for (int j = 0; j < K; ++j) {
      tm[j] = 0u - (node[j][3] & 1u);
      xm[j] = 0u - x_bit(j, pos);
      h[j][0] = node[j][0] ^ hk0;
      h[j][1] = node[j][1] ^ hk1;
      h[j][2] = node[j][2] ^ hk2;
      h[j][3] = node[j][3] ^ hk3;
    }
#pragma unroll
    for (int j = 0; j < K; ++j) prg.expand1(h[j], h[j]);
    if constexpr (kTma) fss::mbar_wait(&full[i % kRing], (i / kRing) & 1);
#pragma unroll
    for (int j = 0; j < K; ++j) {
      const uint4 c = row(i, j);
      node[j][0] = h[j][0] ^ (node[j][0] & xm[j]) ^ (c.x & tm[j]);
      node[j][1] = h[j][1] ^ (node[j][1] & xm[j]) ^ (c.y & tm[j]);
      node[j][2] = h[j][2] ^ (node[j][2] & xm[j]) ^ (c.z & tm[j]);
      node[j][3] = h[j][3] ^ (node[j][3] & xm[j]) ^ (c.w & tm[j]);
    }
    if constexpr (kTma) {  // the warp is done with the slot
      __syncwarp();
      if ((tid & 31) == 0) fss::mbar_arrive(&empty[i % kRing]);
    }
  }

  const int last = in_bits - 1;
  uint32_t h[K][4], t[K], xn[K];
#pragma unroll
  for (int j = 0; j < K; ++j) {
    t[j] = node[j][3] & 1u;
    xn[j] = x_bit(j, 0);
    h[j][0] = node[j][0] ^ hk0;
    h[j][1] = node[j][1] ^ hk1;
    h[j][2] = node[j][2] ^ hk2;
    h[j][3] = ((node[j][3] & ~1u) | xn[j]) ^ hk3;
  }
#pragma unroll
  for (int j = 0; j < K; ++j) prg.expand1(h[j], h[j]);
  if constexpr (kTma) fss::mbar_wait(&full[last % kRing], (last / kRing) & 1);
#pragma unroll
  for (int j = 0; j < K; ++j) {
    const uint4 c = row(last, j);
    const uint32_t tm = 0u - t[j];
    const uint32_t lcw =
        xn[j] ? (__ldg(key[j] + last * 8 + 4) & 1u) : (c.w & 1u);
    const int64_t k = base + j * T + tid;
    if (active[j]) {
      high[k] = make_int4((int)(h[j][0] ^ (c.x & tm)),
                          (int)(h[j][1] ^ (c.y & tm)),
                          (int)(h[j][2] ^ (c.z & tm)),
                          (int)((h[j][3] ^ (c.w & tm)) & ~1u));
      low[k] = (int32_t)((h[j][3] & 1u) ^ (t[j] & lcw));
    }
  }
}

// cuTensorMapEncodeTiled, looked up at run time (no -lcuda).
using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType,
                                 cuuint32_t, void*, const cuuint64_t*,
                                 const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave,
                                 CUtensorMapSwizzle, CUtensorMapL2promotion,
                                 CUtensorMapFloatOOBfill);

EncodeTiled encode_tiled() {
  static EncodeTiled fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult q;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion(
        "cuTensorMapEncodeTiled", &p, 12000, cudaEnableDefault, &q);
#else
    const cudaError_t e = cudaGetDriverEntryPoint(
        "cuTensorMapEncodeTiled", &p, cudaEnableDefault, &q);
#endif
    if (e == cudaSuccess && q == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<EncodeTiled>(p);
  }
  return fn;
}

// The wire rows [batch, in_bits, 8] as [batch, in_bits * 8] words, boxes of
// 4 words x `box` keys; 0 or a CUDA error.
int encode_rows(CUtensorMap* map, const void* cws, int64_t batch,
                int in_bits, int box) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return (int)cudaErrorNotSupported;
  const cuuint64_t dims[2] = {(cuuint64_t)in_bits * 8, (cuuint64_t)batch};
  const cuuint64_t strides[1] = {(cuuint64_t)in_bits * 32};
  const cuuint32_t boxes[2] = {4, (cuuint32_t)box};
  const cuuint32_t steps[2] = {1, 1};
  const CUresult r = encode(
      map, CU_TENSOR_MAP_DATA_TYPE_UINT32, 2, const_cast<void*>(cws), dims,
      strides, boxes, steps, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_NONE,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
  return r == CUDA_SUCCESS ? 0 : (int)cudaErrorInvalidValue;
}

template <class Prg, bool kTma>
int launch(const Prg& p, const void* seeds, int64_t seed_ks, const void* cws,
           int64_t cw_ks, const void* xs, int64_t x_ks, void* high,
           void* low, int64_t batch, int in_bits, int party, uint32_t hk0,
           uint32_t hk1, uint32_t hk2, uint32_t hk3, cudaStream_t stream) {
  constexpr int T = HtDesign<Prg>::kThreads, K = HtDesign<Prg>::kKeys;
  constexpr int threads = kHtThreads<Prg, kTma>;
  CUtensorMap map{};
  if constexpr (kTma) {
    const int rc = encode_rows(&map, cws, batch, in_bits, T);
    if (rc != 0) return rc;
  }
  constexpr size_t smem = kHtSmem<Prg, kTma>;
  auto kernel = ht_eval_kernel<Prg, kTma>;
  const int rc = fss::allow_smem(kernel, smem);
  if (rc != 0) return rc;
  const unsigned blocks = (unsigned)((batch + T * K - 1) / (T * K));
  kernel<<<blocks, threads, smem, stream>>>(
      (const uint32_t*)seeds, seed_ks, (const uint32_t*)cws, cw_ks, map,
      (const uint32_t*)xs, x_ks, (int4*)high, (int32_t*)low, batch, in_bits,
      party, hk0, hk1, hk2, hk3, p);
  return (int)cudaGetLastError();
}

}  // namespace

// seeds: [B, 4] (seed_ks = 4) or one broadcast seed (seed_ks = 0).
// cws: row i of key k at cws[k * cw_ks + i * 8] (words 0..4 read), 16-byte
// aligned; cw_ks = in_bits * 8 (wire rows [B, in_bits, 8]) or 0 (one key).
// xs: x lanes of key k at xs[k * x_ks] (x_ks 1 or 4); lane (pos >> 5) must
// exist.
// high: [B, 4] leaves (clamped bit clear); low: [B] their low bits.
// hk0..hk3: the CCR hash key.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 1 key).
extern "C" int fss_ht_eval(const void* seeds, int64_t seed_ks,
                           const void* cws, int64_t cw_ks, const void* xs,
                           int64_t x_ks, void* high, void* low,
                           int64_t batch, int in_bits, int party,
                           uint32_t hk0, uint32_t hk1, uint32_t hk2,
                           uint32_t hk3, const void* prg, void* stream) {
  if (batch <= 0) return 0;
  if (!fss::aligned16(cws)) return (int)cudaErrorMisalignedAddress;
  return fss::with_prg<1, AesTables>(prg, [&](auto p) {
    using Prg = decltype(p);
    if (HtDesign<Prg>::kTma && cw_ks != 0)
      return launch<Prg, HtDesign<Prg>::kTma>(
          p, seeds, seed_ks, cws, cw_ks, xs, x_ks, high, low, batch, in_bits,
          party, hk0, hk1, hk2, hk3, (cudaStream_t)stream);
    return launch<Prg, false>(p, seeds, seed_ks, cws, cw_ks, xs, x_ks, high,
                              low, batch, in_bits, party, hk0, hk1, hk2, hk3,
                              (cudaStream_t)stream);
  });
}
