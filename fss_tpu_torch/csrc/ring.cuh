// The flat proof chains' ring protocol (blake3.cu, sha256.cu): a producer
// warp fills slots of a ring in shared memory with each point's chain-free
// work ahead of the lanes that carry pi. Each slot has a full and an empty
// mbarrier, one phase a use: the producer lane that owns a slot waits on
// its empty barrier (after the slot's first use), fills it and arrives on
// its full barrier; the chain lanes wait on the full barrier, read the
// slot and arrive on the empty one. A producer lane owns one slot, so it
// never gets two phases ahead of the chain.

#pragma once

#include <cstdint>

namespace fss {

__device__ __forceinline__ uint32_t smem(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, uint32_t count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;" ::"r"(smem(bar)),
               "r"(count)
               : "memory");
}

// Arrive (release): this thread's earlier shared-memory reads and writes
// happen before the phase completes.
__device__ __forceinline__ void mbar_arrive(uint64_t* bar) {
  asm volatile(
      "{\n\t.reg .b64 st;\n\t"
      "mbarrier.arrive.shared::cta.b64 st, [%0];\n\t}" ::"r"(smem(bar))
      : "memory");
}

// Wait (acquire) until the phase of parity `parity` has completed; the
// thread may be suspended until then.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  asm volatile(
      "{\n\t.reg .pred done;\n\t"
      "WAIT:\n\t"
      "mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n\t"
      "@!done bra WAIT;\n\t}" ::"r"(smem(bar)),
      "r"(parity)
      : "memory");
}

// Whether the phase of parity `parity` has completed (acquire if so),
// without waiting: a chain lane asks a few rounds ahead of the words it
// needs, so the answer's latency hides behind them.
__device__ __forceinline__ bool mbar_test(uint64_t* bar, uint32_t parity) {
  uint32_t done;
  asm volatile(
      "{\n\t.reg .pred p;\n\t"
      "mbarrier.test_wait.parity.shared::cta.b64 p, [%1], %2;\n\t"
      "selp.u32 %0, 1, 0, p;\n\t}"
      : "=r"(done)
      : "r"(smem(bar)), "r"(parity)
      : "memory");
  return done != 0;
}

__device__ __forceinline__ void store4(uint32_t* dst, const uint32_t* src) {
  *reinterpret_cast<uint4*>(dst) = make_uint4(src[0], src[1], src[2], src[3]);
}

__device__ __forceinline__ void load4(uint32_t* dst, const uint32_t* src) {
  const uint4 q = *reinterpret_cast<const uint4*>(src);
  dst[0] = q.x, dst[1] = q.y, dst[2] = q.z, dst[3] = q.w;
}

// The 16 lanes of row p: four 16-byte loads, or 16 4-byte ones.
template <bool kAligned>
__device__ __forceinline__ void load_row(const uint32_t* __restrict__ p,
                                         uint32_t (&m)[16]) {
  if constexpr (kAligned) {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const uint4 q = __ldg(reinterpret_cast<const uint4*>(p) + i);
      m[4 * i] = q.x, m[4 * i + 1] = q.y, m[4 * i + 2] = q.z,
      m[4 * i + 3] = q.w;
    }
  } else {
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = __ldg(p + i);
  }
}

inline bool aligned16(const void* p) { return (uintptr_t)p % 16 == 0; }

}  // namespace fss
