// Half-Tree DPF full-domain evaluation (EvalAll) of one key in two launches:
// the tree from the root to the leaves, the conversion level and the leaves'
// group finalize.
//
// Replaces fss_tpu/ops/eval_all_pallas.py:ht_eval_all (_make_ht_kernel) and
// the finalize of fss_tpu/schemes/half_tree_dpf.py:eval_all with the ChaCha
// PRG; with AES-128-MMO it is the card's AES Half-Tree EvalAll, which the JAX
// package runs as XLA (a template over the PRG, prg.cuh). A node is the whole
// 128-bit Half-Tree node, its control bit t in the clamped bit (LSB of word
// 3). A doubling level costs one mul=1 block a node:
//   left = H(hash_key ^ node) ^ (t ? cw : 0),  right = left ^ node,
// every XOR over all 128 bits (the parent's t bit and the CW's low bit
// included). The conversion level, the domain's last, hashes each node twice,
// its clamped bit set to sigma = 0 and 1, and makes both leaves of it: high =
// clear_lsb(h) ^ (t ? HCW : 0), low = lsb(h) ^ (t & LCW_sigma), packed as one
// node with low in the clamped bit. The key rows are uniform loads (every
// thread of the launch reads the same bytes), the counterpart of the TPU
// kernel's SMEM cw table.
//
// The plan is the DPF's (subtree.cuh): the top launch expands the first k
// levels and writes the 2^k subtree roots (kNodes); the body launch's CTA q
// expands root q breadth-first in shared memory, its last level the
// conversion, and its epilogue writes each leaf's share once,
// y = +-(from_block(high) (+ from_block(ocw) where low)) in the group
// (group.cuh: leaf_share, any of the five kinds). At in_bits = 1 the one
// launch is the conversion alone.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A domain of
// 2^n leaves needs 2^(n-1) - 1 doubling blocks and 2^n conversion blocks of 960
// ops, 1.5x a DPF's ChaCha work for the same domain; at n = 24 that is ~2.4e10
// ops (~0.72 ms at 128 lanes x 132 SMs x 1.98 GHz) against 2^24 x 16 bytes of
// shares (~0.08 ms at 3.35 TB/s). With AES the same blocks do 160 shared-memory
// lookups each, ~4.0e9 LDS at n = 24 (~0.48 ms at 32 a clock x 132 SMs x 1.98
// GHz; AesTables below keeps them free of bank conflicts, at the front of the
// dynamic shared memory). Only the shares reach device memory. The doubling's
// hash and the conversion's two go through one PRG call site, a loop of one or
// two iterations that is not unrolled, so ptxas sees one AES body a kernel.

#include <cuda_runtime.h>

#include "group.cuh"
#include "prg.cuh"
#include "subtree.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

// The epilogue besides the shares of the five group kinds (fss::Mode).
constexpr int kNodes = 5;  // nodes, the next launch's roots

template <int E, class Prg>
struct HtTree {
  using Node = uint4;
  const Prg& prg;
  uint4* nodes;  // shared memory
  const uint32_t* __restrict__ cws;
  int64_t cw_ls;
  int4* __restrict__ out;
  int64_t base;   // the subtree's first leaf
  int convert;    // the launch's conversion level, -1 for none
  uint32_t hk[4];
  uint32_t party;
  fss::Group g;
  uint32_t oc[4];  // from_block(ocw)

  __device__ __forceinline__ Node load(int j) const { return nodes[j]; }
  __device__ __forceinline__ void store(int j, const Node& v) const {
    nodes[j] = v;
  }

  // A doubling level: l = H(hk ^ p) ^ (t ? cw : 0), r = l ^ p. The
  // conversion: l and r are the leaves of sigma = 0 and 1, each H(hk ^
  // (p with sigma in its clamped bit)) ^ (t ? cw_sigma : 0), where cw_0 is
  // the row's SetLsb(HCW, LCW_0) and cw_1 is HCW with LCW_1 as its low bit.
  __device__ __forceinline__ void expand(int lvl, const Node& p, Node& l,
                                         Node& r) const {
    const uint32_t* c = cws + lvl * cw_ls;
    const uint32_t c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    const uint32_t c3 = __ldg(c + 3);
    const bool conv = lvl == convert;
    const uint32_t c3_1 = conv ? (c3 & ~1u) | (__ldg(c + 4) & 1u) : 0u;
    const uint32_t tm = 0u - (p.w & 1u);
    const uint32_t w3 = conv ? p.w & ~1u : p.w;
#pragma unroll 1
    for (uint32_t sigma = 0; sigma <= (uint32_t)conv; ++sigma) {
      uint32_t h[4] = {p.x ^ hk[0], p.y ^ hk[1], p.z ^ hk[2],
                       (w3 | sigma) ^ hk[3]};
      prg.expand1(h, h);
      const Node a = make_uint4(h[0] ^ (c0 & tm), h[1] ^ (c1 & tm),
                                h[2] ^ (c2 & tm),
                                h[3] ^ ((sigma ? c3_1 : c3) & tm));
      if (sigma) {
        r = a;
      } else {
        l = a;
      }
    }
    if (!conv) r = make_uint4(l.x ^ p.x, l.y ^ p.y, l.z ^ p.z, l.w ^ p.w);
  }

  __device__ __forceinline__ void leaves(int j, const Node& l,
                                         const Node& r) const {
    const int64_t i = base + 2 * j;
    if constexpr (E == kNodes) {
      reinterpret_cast<uint4*>(out)[i] = l;
      reinterpret_cast<uint4*>(out)[i + 1] = r;
    } else {
      out[i] = fss::leaf_share<E>(g, l, oc, party);
      out[i + 1] = fss::leaf_share<E>(g, r, oc, party);
    }
  }
};

template <int E, class Prg>
__global__ void __launch_bounds__(256)
    ht_eval_all_kernel(const uint32_t* __restrict__ s0,
                       const uint4* __restrict__ roots,
                       const uint32_t* __restrict__ cws, int64_t cw_ls,
                       int4* __restrict__ out,
                       const uint32_t* __restrict__ ocw, int walk, int b,
                       uint32_t party, uint4 hk, fss::Group g,
                       const Prg prg) {
  extern __shared__ uint4 smem[];
  prg.init();  // AES fills its shared tables; every thread, then a barrier
  uint4* nodes = smem + fss::kPrgSmem<Prg> / sizeof(uint4);
  HtTree<E, Prg> tree{prg, nodes, cws, cw_ls, out,
                      (int64_t)blockIdx.x << b,
                      E == kNodes ? -1 : walk + b - 1,
                      {hk.x, hk.y, hk.z, hk.w}, party, g, {0u, 0u, 0u, 0u}};
  if constexpr (E != kNodes) {
#pragma unroll
    for (int w = 0; w < 4; ++w) tree.oc[w] = __ldg(ocw + w);
    fss::from_block<E>(g, tree.oc);
  }
  if (threadIdx.x == 0) {
    nodes[0] = roots != nullptr
                   ? roots[blockIdx.x]
                   : make_uint4(__ldg(s0), __ldg(s0 + 1), __ldg(s0 + 2),
                                (__ldg(s0 + 3) & ~1u) | party);
  }
  __syncthreads();
  fss::subtree_levels(tree, walk + b, walk);
}

template <int E, class Prg>
int launch(const void* s0, const void* roots, const void* cws, int64_t cw_ls,
           void* out, const void* ocw, int grid_log2, int b, int party,
           uint4 hk, const fss::Group& g, const Prg& prg,
           cudaStream_t stream) {
  auto kernel = ht_eval_all_kernel<E, Prg>;
  const size_t smem = fss::kPrgSmem<Prg> + (sizeof(uint4) << (b - 1));
  const int rc = fss::subtree_plan(kernel, grid_log2, b, smem);
  if (rc != 0) return rc;
  kernel<<<1u << grid_log2, fss::subtree_threads(b), smem, stream>>>(
      (const uint32_t*)s0, (const uint4*)roots, (const uint32_t*)cws, cw_ls,
      (int4*)out, (const uint32_t*)ocw, roots != nullptr ? 0 : grid_log2, b,
      (uint32_t)party, hk, g, prg);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the plan: 2^grid_log2 CTAs, each expanding b (1..12) levels
// below its root: roots[q] ([2^grid_log2, 4] nodes) when roots is not null,
// else the party's root seed s0 [4] (its clamped bit set to the party)
// walked grid_log2 levels down. cws: row i of the launch's levels at
// cws[i * cw_ls] (words 0..3; the walk's rows first; the conversion row's
// word 4 is LCW_1). epilogue: fss::Mode -> the launch's last level is the
// conversion and out [2^(grid_log2 + b), 4] gets the shares of the group of
// that kind (mask0..3 and mod0..3: fss::Group) under the output CW ocw [4]
// (a device pointer, so the call needs no read of the key on the host);
// kNodes -> out gets the nodes, the next launch's roots. hk0..hk3: the CCR
// hash key. prg: a host fss::PrgArg (ChaCha or AES-MMO with 1 key).
extern "C" int fss_ht_eval_all(const void* s0, const void* roots,
                               const void* cws, int64_t cw_ls, void* out,
                               const void* ocw, int grid_log2, int b,
                               int party, int epilogue, uint32_t hk0,
                               uint32_t hk1, uint32_t hk2, uint32_t hk3,
                               uint32_t mask0, uint32_t mask1, uint32_t mask2,
                               uint32_t mask3, uint32_t mod0, uint32_t mod1,
                               uint32_t mod2, uint32_t mod3, const void* prg,
                               void* stream) {
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  const uint4 hk = make_uint4(hk0, hk1, hk2, hk3);
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<1, AesTables>(prg, [&](auto p) {
#define FSS_HT_EVAL_ALL(E) \
  launch<E>(s0, roots, cws, cw_ls, out, ocw, grid_log2, b, party, hk, g, p, st)
    switch (epilogue) {
      case fss::kXor: return FSS_HT_EVAL_ALL(fss::kXor);
      case fss::kWrap: return FSS_HT_EVAL_ALL(fss::kWrap);
      case fss::kMod64: return FSS_HT_EVAL_ALL(fss::kMod64);
      case fss::kMod128: return FSS_HT_EVAL_ALL(fss::kMod128);
      case fss::kMod128np: return FSS_HT_EVAL_ALL(fss::kMod128np);
      case kNodes: return FSS_HT_EVAL_ALL(kNodes);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_HT_EVAL_ALL
  });
}
