// Batched Half-Tree DPF key generation: one thread per key runs both
// parties' nodes down the path to alpha.
//
// Replaces fss_tpu/ops/ht_pallas.py:gen_packed (_make_gen_kernel) with the
// ChaCha PRG; with AES-128-MMO it is the card's AES Half-Tree Gen, which the
// JAX package runs as XLA (a template over the PRG, prg.cuh). Nodes start
// as SetLsb(s0, 0) and SetLsb(s1, 1). Per level (the reference's corrected
// formulas, docs/design.md "Half-Tree correction words"): one mul=1 block
// of hash_key ^ node per party, the CW
//   cw = h0 ^ h1 ^ (!a_bit ? node0 ^ node1 : 0)
// over all 128 bits, and each party's node = h ^ (a_bit ? node : 0) ^
// (t ? cw : 0). The last level hashes each node with its clamped bit set to
// 0 and to 1 (4 blocks): HCW from the !a_n hashes, LCW_0 = low0_0 ^ low1_0
// ^ a_n ^ 1, LCW_1 = low0_1 ^ low1_1 ^ a_n, and the parties' leaves in the
// alpha direction corrected under their own t. Unlike the TPU kernel, every
// in_bits 1..128 runs here and alpha may be 4 lanes: bit (in_bits-1-i) is
// read from lane (pos >> 5), a_n is bit 0 of lane 0.
//
// The kernel writes whole wire rows [B, n, 8]: rows 0..n-2 hold the CW in
// words 0-3, row n-1 holds SetLsb(HCW, LCW_0) in words 0-3 and LCW_1 in
// word 4, every other word 0. Given betas and the group it ends with the
// group-typed output CW [B, 4], as dpf_gen.cu does (the group kind a
// template parameter, group.cuh): +-(beta - s0 + s1) with s0, s1 the two
// leaves with their clamped bits clear, negated when leaf 1's low bit (t1)
// is set, as schemes/half_tree_dpf.py:output_cw computes it, so
// HalfTreeDpf.gen_batch is one launch (the JAX package runs it as XLA glue
// after its kernel, fss_tpu/ops/ht_pallas.py:gen_batch). Without betas it
// writes the two leaves [B, 4] instead.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. 2 (n-1) + 4
// ChaCha blocks of 960 ops a key against 32 bytes a row written; at 2^20 keys x
// 16 bits, ~3.4e10 ops (~1.02 ms at 128 lanes x 132 SMs x 1.98 GHz) against
// ~0.6 GB (~0.18 ms at 3.35 TB/s). With AES the same blocks do 160
// shared-memory lookups each, ~5.7e9 LDS (~0.68 ms at 32 a clock x 132 SMs x
// 1.98 GHz; AesTables below keeps them free of bank conflicts). Both nodes and
// the ChaCha state stay in registers; each row goes out as two 16-byte stores.

#include <cuda_runtime.h>

#include "group.cuh"
#include "prg.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

template <class Prg>
__device__ __forceinline__ void ccr_hash(const Prg& prg,
                                         const uint32_t node[4],
                                         uint32_t lsb_clear, uint32_t lsb_set,
                                         const uint32_t hk[4],
                                         uint32_t out[4]) {
  // H(hash_key ^ node'), node' = node with word 3 as (w3 & lsb_clear) |
  // lsb_set.
  out[0] = node[0] ^ hk[0];
  out[1] = node[1] ^ hk[1];
  out[2] = node[2] ^ hk[2];
  out[3] = ((node[3] & lsb_clear) | lsb_set) ^ hk[3];
  prg.expand1(out, out);
}

template <int M, class Prg>
__global__ void ht_gen_kernel(const uint32_t* __restrict__ seeds,
                              const uint32_t* __restrict__ alphas,
                              int64_t a_ks,
                              const uint32_t* __restrict__ betas,
                              int4* __restrict__ cws,
                              int4* __restrict__ leaf0,
                              int4* __restrict__ leaf1,
                              int4* __restrict__ ocw, int64_t batch,
                              int in_bits, uint32_t hk0, uint32_t hk1,
                              uint32_t hk2, uint32_t hk3, fss::Group g,
                              const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t hk[4] = {hk0, hk1, hk2, hk3};
  const uint32_t* sp = seeds + k * 8;
  uint32_t m0[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                    __ldg(sp + 3) & ~1u};
  uint32_t m1[4] = {__ldg(sp + 4), __ldg(sp + 5), __ldg(sp + 6),
                    __ldg(sp + 7) | 1u};
  const uint32_t* a = alphas + k * a_ks;
  int4* row = cws + k * in_bits * 2;

  for (int i = 0; i < in_bits - 1; ++i) {
    uint32_t h0[4], h1[4];
    ccr_hash(prg, m0, ~0u, 0u, hk, h0);
    ccr_hash(prg, m1, ~0u, 0u, hk, h1);
    const int pos = in_bits - 1 - i;
    const uint32_t ab = (__ldg(a + (pos >> 5)) >> (pos & 31)) & 1u;
    const uint32_t nam = ab - 1u;  // all ones where a_bit is 0
    const uint32_t am = 0u - ab;
    const uint32_t t0m = 0u - (m0[3] & 1u), t1m = 0u - (m1[3] & 1u);
    uint32_t cw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      cw[w] = h0[w] ^ h1[w] ^ ((m0[w] ^ m1[w]) & nam);
      m0[w] = h0[w] ^ (m0[w] & am) ^ (cw[w] & t0m);
      m1[w] = h1[w] ^ (m1[w] & am) ^ (cw[w] & t1m);
    }
    row[2 * i] = make_int4((int)cw[0], (int)cw[1], (int)cw[2], (int)cw[3]);
    row[2 * i + 1] = make_int4(0, 0, 0, 0);
  }

  // Last level: four sigma-hashes.
  const uint32_t an = __ldg(a) & 1u, anm = 0u - an;
  const uint32_t t0m = 0u - (m0[3] & 1u), t1m = 0u - (m1[3] & 1u);
  uint32_t h00[4], h01[4], h10[4], h11[4];
  ccr_hash(prg, m0, ~1u, 0u, hk, h00);
  ccr_hash(prg, m0, ~1u, 1u, hk, h01);
  ccr_hash(prg, m1, ~1u, 0u, hk, h10);
  ccr_hash(prg, m1, ~1u, 1u, hk, h11);
  const uint32_t lcw0 = (h00[3] ^ h10[3] ^ an ^ 1u) & 1u;
  const uint32_t lcw1 = (h01[3] ^ h11[3] ^ an) & 1u;
  uint32_t hcw[4], l0[4], l1[4];
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    // HCW from the !a_n hashes: the 0-hashes where a_n is 1.
    const uint32_t hs0 = h00[w] ^ h10[w], hs1 = h01[w] ^ h11[w];
    hcw[w] = hs1 ^ (anm & (hs0 ^ hs1));
    l0[w] = h00[w] ^ (anm & (h00[w] ^ h01[w]));
    l1[w] = h10[w] ^ (anm & (h10[w] ^ h11[w]));
  }
  hcw[3] &= ~1u;
  const uint32_t lcw_an = an ? lcw1 : lcw0;
  row[2 * (in_bits - 1)] = make_int4((int)hcw[0], (int)hcw[1], (int)hcw[2],
                                     (int)(hcw[3] | lcw0));
  row[2 * (in_bits - 1) + 1] = make_int4((int)lcw1, 0, 0, 0);
  const uint32_t lc[4] = {hcw[0], hcw[1], hcw[2], hcw[3] | lcw_an};
#pragma unroll
  for (int w = 0; w < 4; ++w) {
    l0[w] ^= lc[w] & t0m;
    l1[w] ^= lc[w] & t1m;
  }
  if (betas == nullptr) {
    leaf0[k] = make_int4((int)l0[0], (int)l0[1], (int)l0[2], (int)l0[3]);
    leaf1[k] = make_int4((int)l1[0], (int)l1[1], (int)l1[2], (int)l1[3]);
    return;
  }
  // v = beta - s0 + s1 in the group, negated when t1.
  const uint32_t t1 = l1[3] & 1u;
  l0[3] &= ~1u;
  l1[3] &= ~1u;
  const uint32_t* bp = betas + k * 4;
  uint32_t v[4] = {__ldg(bp), __ldg(bp + 1), __ldg(bp + 2),
                   __ldg(bp + 3) & ~1u};
  fss::from_block<M>(g, v);
  fss::from_block<M>(g, l0);
  fss::from_block<M>(g, l1);
  fss::gneg<M>(g, l0);
  fss::gadd<M>(g, v, l0);
  fss::gadd<M>(g, v, l1);
  if (t1) fss::gneg<M>(g, v);
  fss::into_block<M>(v);
  ocw[k] = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
}

}  // namespace

// seeds: [B, 2, 4]; alphas: lanes of key k at alphas[k * a_ks] (a_ks = 1
// for [B] with in_bits <= 32, 4 for [B, 4]).
// betas: [B, 4] (clamped bit ignored), or null for no output CW.
// cws: [B, in_bits, 8] wire rows, written whole.
// leaf0, leaf1: [B, 4] the parties' corrected alpha-direction leaves,
// written without betas; ocw: [B, 4] the output CW, written with them.
// mode: fss::Mode of the group; mask0..3 and mod0..3: fss::Group
// (groups.gen_params).
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 1 key).
extern "C" int fss_ht_gen(const void* seeds, const void* alphas,
                          int64_t a_ks, const void* betas, void* cws,
                          void* leaf0, void* leaf1, void* ocw,
                          int64_t batch, int in_bits, uint32_t hk0,
                          uint32_t hk1, uint32_t hk2, uint32_t hk3, int mode,
                          uint32_t mask0, uint32_t mask1, uint32_t mask2,
                          uint32_t mask3, uint32_t mod0, uint32_t mod1,
                          uint32_t mod2, uint32_t mod3, const void* prg,
                          void* stream) {
  if (batch <= 0) return 0;
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  const int threads = 128;
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<1, AesTables>(prg, [&](auto p) {
    using Prg = decltype(p);
#define FSS_HT_GEN(M)                                                       \
  return fss::launch_kernel<Prg>(                                           \
      ht_gen_kernel<M, Prg>, blocks, threads, st, (const uint32_t*)seeds,   \
      (const uint32_t*)alphas, a_ks, (const uint32_t*)betas, (int4*)cws,    \
      (int4*)leaf0, (int4*)leaf1, (int4*)ocw, batch, in_bits, hk0, hk1,     \
      hk2, hk3, g, p)
    switch (mode) {
      case fss::kXor: FSS_HT_GEN(fss::kXor);
      case fss::kWrap: FSS_HT_GEN(fss::kWrap);
      case fss::kMod64: FSS_HT_GEN(fss::kMod64);
      case fss::kMod128: FSS_HT_GEN(fss::kMod128);
      case fss::kMod128np: FSS_HT_GEN(fss::kMod128np);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_HT_GEN
  });
}
