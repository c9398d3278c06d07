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
// whatever lands in bit 0. The level-i bit is bit (in_bits-1-i) of x, read
// from lane (pos >> 5), so 33..128-bit domains take x as 4 lanes. The last
// level hashes the node with its clamped bit replaced by x_n (bit 0 of lane
// 0) and corrects it with the last key row: high = clear_lsb(h) ^
// (t ? HCW : 0), low = lsb(h) ^ (t & LCW_{x_n}), LCW_0 in the low bit of
// word 3 and LCW_1 in word 4. The group finalize stays in torch glue.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A key costs
// in_bits ChaCha blocks of 960 ops against 16 bytes of cw read a level; at 2^20
// keys x 16 levels that is ~1.6e10 ops (~0.48 ms at 128 lanes x 132 SMs x 1.98
// GHz) but ~0.3 GB (~0.09 ms at 3.35 TB/s). With AES: one block of 160
// shared-memory lookups a level, ~2.7e9 LDS (~0.32 ms at 32 a clock x 132 SMs x
// 1.98 GHz; AesTables below keeps them free of bank conflicts). The node and
// the 16-word ChaCha state stay in registers for the whole walk; the hash key
// and the nonce are kernel arguments, not compile-time constants as on the TPU,
// so a new key needs no rebuild. Keys are wire rows [B, n, 8] read in place
// (key stride n * 8) or one broadcast key (key stride 0).

#include <cuda_runtime.h>

#include "prg.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 1>;

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
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t* sp = seeds + k * seed_ks;
  uint32_t node[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                      (__ldg(sp + 3) & ~1u) | (uint32_t)party};
  const uint32_t* key = cws + k * cw_ks;
  const uint32_t* x = xs + k * x_ks;

  for (int i = 0; i < in_bits - 1; ++i) {
    const uint32_t tm = 0u - (node[3] & 1u);
    const int pos = in_bits - 1 - i;
    const uint32_t xm = 0u - ((__ldg(x + (pos >> 5)) >> (pos & 31)) & 1u);
    uint32_t h[4] = {node[0] ^ hk0, node[1] ^ hk1, node[2] ^ hk2,
                     node[3] ^ hk3};
    prg.expand1(h, h);
    const uint32_t* c = key + i * 8;
#pragma unroll
    for (int w = 0; w < 4; ++w)
      node[w] = h[w] ^ (node[w] & xm) ^ (__ldg(c + w) & tm);
  }

  const uint32_t t = node[3] & 1u, tm = 0u - t;
  const uint32_t xn = __ldg(x) & 1u;
  uint32_t h[4] = {node[0] ^ hk0, node[1] ^ hk1, node[2] ^ hk2,
                   ((node[3] & ~1u) | xn) ^ hk3};
  prg.expand1(h, h);
  const uint32_t* c = key + (in_bits - 1) * 8;
  const uint32_t c3 = __ldg(c + 3);
  const uint32_t lcw = xn ? (__ldg(c + 4) & 1u) : (c3 & 1u);
  high[k] = make_int4((int)(h[0] ^ (__ldg(c) & tm)),
                      (int)(h[1] ^ (__ldg(c + 1) & tm)),
                      (int)(h[2] ^ (__ldg(c + 2) & tm)),
                      (int)((h[3] ^ (c3 & tm)) & ~1u));
  low[k] = (int32_t)((h[3] & 1u) ^ (t & lcw));
}

}  // namespace

// seeds: [B, 4] (seed_ks = 4) or one broadcast seed (seed_ks = 0).
// cws: row i of key k at cws[k * cw_ks + i * 8] (words 0..4 read).
// xs: x lanes of key k at xs[k * x_ks]; lane (pos >> 5) must exist.
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
  const int threads = 128;
  const int64_t blocks = (batch + threads - 1) / threads;
  return fss::with_prg<1, AesTables>(prg, [&](auto p) {
    return fss::launch_kernel<decltype(p)>(
        ht_eval_kernel<decltype(p)>, (unsigned)blocks, threads,
        (cudaStream_t)stream, (const uint32_t*)seeds, seed_ks,
        (const uint32_t*)cws, cw_ks, (const uint32_t*)xs, x_ks, (int4*)high,
        (int32_t*)low, batch, in_bits, party, hk0, hk1, hk2, hk3, p);
  });
}
