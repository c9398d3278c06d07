// Batched Half-Tree DPF point evaluation: one thread per key walks the n-1
// hash levels and the last-level conversion in registers.
//
// Replaces fss_tpu/ops/ht_pallas.py:eval_packed (_make_kernel) with the ChaCha
// PRG and fss_tpu/ops/aes_pallas.py:ht_eval_packed (_make_ht_eval_kernel) with
// AES-128-MMO, as a template over the PRG (prg.cuh). Per level: one mul=1 block
// of hash_key ^ node (the whole node, its control bit t in the clamped bit
// included), then
//   node = h ^ (x_bit ? node : 0) ^ (t ? cw : 0)
// over all 128 bits: the CW's own low bit is part of it, and the new t is
// whatever lands in bit 0. The level-i bit is bit (in_bits-1-i) of x, from
// lane (pos >> 5), so 33..128-bit domains take x as 4 lanes. The last level
// hashes the node with its clamped bit replaced by x_n (bit 0 of lane 0) and
// corrects it with the last key row: high = clear_lsb(h) ^ (t ? HCW : 0),
// low = lsb(h) ^ (t & LCW_{x_n}), LCW_0 in the low bit of word 3 and LCW_1 in
// word 4. The group finalize stays in torch glue.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A key costs
// in_bits ChaCha blocks of 960 ops against 16 bytes of cw read a level; at 2^20
// keys x 16 levels that is ~1.6e10 ops (~0.48 ms at 128 lanes x 132 SMs x 1.98
// GHz) but ~0.3 GB (~0.09 ms at 3.35 TB/s). With AES: one block of 160
// shared-memory lookups a level, ~2.7e9 LDS (~0.32 ms at 32 a clock x 132 SMs x
// 1.98 GHz; the tables' layout keeps them free of bank conflicts).
//
// What the design does about the AES bound (PERF.md section 6 has the
// measurements; scripts/torch_ht_eval_variants.py times the alternatives,
// from scripts/ht_eval_designs.cu). Global loads take the same L1/shared-
// memory data path as the table lookups, one wavefront for each 128-byte
// line a warp's load touches. The keys are wire rows [B, n, 8] (key stride
// n * 32 bytes), so a level's row is a different line for each of a warp's
// 32 keys: read as four 4-byte loads it costs ~128 wavefronts a warp-level
// beside the block's 160 lookups. Here it is one 16-byte load (the wrapper
// hands the kernel a 16-byte aligned cws), ~32, and x's lanes are loaded
// once, not once a level (a level takes its x bit and t before the block,
// so a load of x waits behind the block). The tables are 32 copies of Te0 and of Te2 (one
// PRMT an address, one rotation a round word: ~340 ALU-pipe instructions a
// block against <32, 1>'s ~500), 64 KB a CTA, so the CTA is 1024 threads
// and two of them fill an SM (64 warps) to hide the lookups' latency. A
// broadcast key (key stride 0) has every lane read the same 16 bytes. With
// ChaCha (ALU-bound) a row stays four 4-byte loads and x is loaded a level,
// in 128-thread CTAs, as before: with the 16-byte load B-7 measured 4%
// slower (HtDesign). The node and the ChaCha state stay in registers; the
// hash key and the nonce or round keys are kernel arguments, so a new key
// needs no rebuild.

#include <cuda_runtime.h>

#include "prg.cuh"
#include "ring.cuh"

namespace {

using AesTables = fss::AesTables<32, 2>;

// Per PRG: the row as one 16-byte load with x's lanes held in registers
// (kWide), and the CTA's threads. Two AES CTAs fill an SM while the kernel
// takes at most 32 registers (ptxas: 32, chip_smoke.py phase 2); a
// __launch_bounds__ that forces it costs AES a spill and ChaCha registers.
template <class Prg>
struct HtDesign {
  static constexpr bool kWide = false;
  static constexpr int kThreads = 128;
};
template <int MUL, class T>
struct HtDesign<fss::AesPrg<MUL, T>> {
  static constexpr bool kWide = true;
  static constexpr int kThreads = 1024;
};

template <class Prg>
__global__ void ht_eval_kernel(const uint32_t* __restrict__ seeds,
                               int64_t seed_ks,
                               const uint32_t* __restrict__ cws,
                               int64_t cw_ks,
                               const uint32_t* __restrict__ xs, int64_t x_ks,
                               int4* __restrict__ high,
                               int32_t* __restrict__ low, int64_t batch,
                               int in_bits, int party, uint32_t hk0,
                               uint32_t hk1, uint32_t hk2, uint32_t hk3,
                               const Prg prg) {
  constexpr bool kWide = HtDesign<Prg>::kWide;
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t* sp = seeds + k * seed_ks;
  uint32_t node[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                      (__ldg(sp + 3) & ~1u) | (uint32_t)party};
  const uint32_t* key = cws + k * cw_ks;
  const uint32_t* x = xs + k * x_ks;
  uint32_t xl[4] = {};
  if constexpr (kWide) {
    xl[0] = __ldg(x);
    if (x_ks == 4) {
      xl[1] = __ldg(x + 1);
      xl[2] = __ldg(x + 2);
      xl[3] = __ldg(x + 3);
    }
  }
  // Bit `pos` of x; words 0..3 of row i.
  auto x_bit = [&](int pos) -> uint32_t {
    uint32_t lane;
    if constexpr (kWide) {
      const int l = pos >> 5;
      lane = l == 0 ? xl[0] : l == 1 ? xl[1] : l == 2 ? xl[2] : xl[3];
    } else {
      lane = __ldg(x + (pos >> 5));
    }
    return (lane >> (pos & 31)) & 1u;
  };
  auto row = [&](int i) -> uint4 {
    const uint32_t* c = key + i * 8;
    if constexpr (kWide) {
      return __ldg(reinterpret_cast<const uint4*>(c));
    } else {
      return make_uint4(__ldg(c), __ldg(c + 1), __ldg(c + 2), __ldg(c + 3));
    }
  };

  for (int i = 0; i < in_bits - 1; ++i) {
    const uint32_t tm = 0u - (node[3] & 1u);
    const uint32_t xm = 0u - x_bit(in_bits - 1 - i);
    uint32_t h[4] = {node[0] ^ hk0, node[1] ^ hk1, node[2] ^ hk2,
                     node[3] ^ hk3};
    prg.expand1(h, h);
    const uint4 c = row(i);
    node[0] = h[0] ^ (node[0] & xm) ^ (c.x & tm);
    node[1] = h[1] ^ (node[1] & xm) ^ (c.y & tm);
    node[2] = h[2] ^ (node[2] & xm) ^ (c.z & tm);
    node[3] = h[3] ^ (node[3] & xm) ^ (c.w & tm);
  }

  const int last = in_bits - 1;
  const uint32_t t = node[3] & 1u, tm = 0u - t;
  const uint32_t xn = x_bit(0);
  uint32_t h[4] = {node[0] ^ hk0, node[1] ^ hk1, node[2] ^ hk2,
                   ((node[3] & ~1u) | xn) ^ hk3};
  prg.expand1(h, h);
  const uint4 c = row(last);
  const uint32_t lcw = xn ? (__ldg(key + last * 8 + 4) & 1u) : (c.w & 1u);
  high[k] = make_int4((int)(h[0] ^ (c.x & tm)), (int)(h[1] ^ (c.y & tm)),
                      (int)(h[2] ^ (c.z & tm)),
                      (int)((h[3] ^ (c.w & tm)) & ~1u));
  low[k] = (int32_t)((h[3] & 1u) ^ (t & lcw));
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
    constexpr int threads = HtDesign<Prg>::kThreads;
    return fss::launch_kernel<Prg>(
        ht_eval_kernel<Prg>, (unsigned)((batch + threads - 1) / threads),
        threads, (cudaStream_t)stream, (const uint32_t*)seeds, seed_ks,
        (const uint32_t*)cws, cw_ks, (const uint32_t*)xs, x_ks, (int4*)high,
        (int32_t*)low, batch, in_bits, party, hk0, hk1, hk2, hk3, p);
  });
}
