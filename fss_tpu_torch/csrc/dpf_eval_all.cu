// DPF full-domain evaluation (EvalAll) of one key in two launches: the tree
// from the root to the leaves, and the leaves' group finalize.
//
// Replaces fss_tpu/ops/eval_all_pallas.py:_expand_packed (_make_kernel) and
// the finalize of fss_tpu/schemes/dpf.py:eval_all with the ChaCha PRG; with
// AES-128-MMO it is the card's AES EvalAll, which the JAX package runs as XLA
// (a template over the PRG, prg.cuh). A node is (s, t) packed, the control
// bit in the clamped bit (LSB of word 3). Per node: the PRG's mul=2 pair, the
// level's correction word XORed into both children under the mask (0 - t),
// the children's t bits corrected with tl_cw / tr_cw. The cw rows are uniform
// loads (every thread of the launch reads the same 20 bytes a level), the
// counterpart of the TPU kernel's SMEM cw table.
//
// The plan (subtree.cuh): the top launch expands the first k levels and
// writes the 2^k subtree roots (kNodes); the body launch's CTA q expands root
// q breadth-first in shared memory, and its epilogue writes each leaf once,
// either
//   the share y = +-(from_block(s) (+ from_block(ocw) where t)) in the group
//   (group.cuh: leaf_share; any of the five kinds), ocw = cws row n words
//   0-3, or
//   the seed with the clamped bit clear and t as its own [2^n] plane, which
//   the VDPF hashes (kSeeds, ops/eval_all_cuda.py:expand_leaves).
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A domain of
// 2^n leaves needs 2^n - 1 ChaCha blocks of 960 ops; at n = 24 that is ~1.6e10
// ops (~0.48 ms at 128 lanes x 132 SMs x 1.98 GHz) against 2^24 x 16 bytes of
// shares (~0.08 ms at 3.35 TB/s). With AES: 2 (2^n - 1) blocks of 160
// shared-memory lookups, ~5.4e9 LDS at n = 24 (~0.64 ms at 32 a clock x 132 SMs
// x 1.98 GHz; AesTables below keeps them free of bank conflicts, its 64 KB at
// the front of the dynamic shared memory). Only the leaves reach device memory,
// and the finalize costs a few ALU ops a leaf for every group but the 128-bit
// one with a modulus that is not a power of two (a 127-step long division a
// leaf).

#include <cuda_runtime.h>

#include "group.cuh"
#include "prg.cuh"
#include "subtree.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

// The epilogues besides the shares of the five group kinds (fss::Mode).
constexpr int kSeeds = 5;  // seeds with the clamped bit clear, t apart
constexpr int kNodes = 6;  // packed nodes, the next launch's roots

template <int E, class Prg>
struct DpfTree {
  using Node = uint4;
  const Prg& prg;
  uint4* nodes;  // shared memory
  const uint32_t* __restrict__ cws;
  int64_t cw_ls;
  int4* __restrict__ out;
  int32_t* __restrict__ t_out;
  int64_t base;  // the subtree's first leaf
  uint32_t party;
  fss::Group g;
  uint32_t oc[4];  // from_block(ocw)

  __device__ __forceinline__ Node load(int j) const { return nodes[j]; }
  __device__ __forceinline__ void store(int j, const Node& v) const {
    nodes[j] = v;
  }

  __device__ __forceinline__ void expand(int lvl, const Node& p, Node& l,
                                         Node& r) const {
    const uint32_t* c = cws + lvl * cw_ls;
    const uint32_t c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    const uint32_t c3 = __ldg(c + 3), c4 = __ldg(c + 4);
    const uint32_t t = p.w & 1u, tm = 0u - t;
    const uint32_t s[4] = {p.x, p.y, p.z, p.w & ~1u};
    uint32_t a[4], b[4];
    prg.expand2(s, a, b);
    const uint32_t cw3 = c3 & ~1u;
    const uint32_t tl = (a[3] & 1u) ^ (t & c3 & 1u);
    const uint32_t tr = (b[3] & 1u) ^ (t & c4 & 1u);
    l = make_uint4(a[0] ^ (c0 & tm), a[1] ^ (c1 & tm), a[2] ^ (c2 & tm),
                   ((a[3] ^ (cw3 & tm)) & ~1u) | tl);
    r = make_uint4(b[0] ^ (c0 & tm), b[1] ^ (c1 & tm), b[2] ^ (c2 & tm),
                   ((b[3] ^ (cw3 & tm)) & ~1u) | tr);
  }

  __device__ __forceinline__ void leaves(int j, const Node& l,
                                         const Node& r) const {
    const int64_t i = base + 2 * j;
    if constexpr (E == kNodes) {
      reinterpret_cast<uint4*>(out)[i] = l;
      reinterpret_cast<uint4*>(out)[i + 1] = r;
    } else if constexpr (E == kSeeds) {
      out[i] = make_int4((int)l.x, (int)l.y, (int)l.z, (int)(l.w & ~1u));
      out[i + 1] =
          make_int4((int)r.x, (int)r.y, (int)r.z, (int)(r.w & ~1u));
      *reinterpret_cast<int2*>(t_out + i) =
          make_int2((int)(l.w & 1u), (int)(r.w & 1u));
    } else {
      out[i] = fss::leaf_share<E>(g, l, oc, party);
      out[i + 1] = fss::leaf_share<E>(g, r, oc, party);
    }
  }
};

template <int E, class Prg>
__global__ void __launch_bounds__(256)
    dpf_eval_all_kernel(const uint32_t* __restrict__ s0,
                        const uint4* __restrict__ roots,
                        const uint32_t* __restrict__ cws, int64_t cw_ls,
                        int4* __restrict__ out, int32_t* __restrict__ t_out,
                        int walk, int b, uint32_t party, fss::Group g,
                        const Prg prg) {
  extern __shared__ uint4 smem[];
  prg.init();  // AES fills its shared tables; every thread, then a barrier
  uint4* nodes = smem + fss::kPrgSmem<Prg> / sizeof(uint4);
  DpfTree<E, Prg> tree{prg, nodes, cws, cw_ls, out, t_out,
                       (int64_t)blockIdx.x << b, party, g, {0u, 0u, 0u, 0u}};
  if constexpr (E < kSeeds) {
    const uint32_t* o = cws + (walk + b) * cw_ls;
#pragma unroll
    for (int w = 0; w < 4; ++w) tree.oc[w] = __ldg(o + w);
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
           void* out, void* t_out, int grid_log2, int b, int party,
           const fss::Group& g, const Prg& prg, cudaStream_t stream) {
  auto kernel = dpf_eval_all_kernel<E, Prg>;
  const size_t smem = fss::kPrgSmem<Prg> + (sizeof(uint4) << (b - 1));
  const int rc = fss::subtree_plan(kernel, grid_log2, b, smem);
  if (rc != 0) return rc;
  kernel<<<1u << grid_log2, fss::subtree_threads(b), smem, stream>>>(
      (const uint32_t*)s0, (const uint4*)roots, (const uint32_t*)cws, cw_ls,
      (int4*)out, (int32_t*)t_out, roots != nullptr ? 0 : grid_log2, b,
      (uint32_t)party, g, prg);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the plan: 2^grid_log2 CTAs, each expanding b (1..12) levels
// below its root: roots[q] ([2^grid_log2, 4] packed nodes) when roots is not
// null, else the party's root seed s0 [4] walked grid_log2 levels down.
// cws: row i of the launch's levels at cws[i * cw_ls] (words 0..4; the walk's
// rows first), then the output CW (words 0..3) for the shares.
// epilogue: fss::Mode -> out [2^(grid_log2 + b), 4] gets the shares of the
// group of that kind (mask0..3 and mod0..3: fss::Group); kSeeds -> out gets
// the leaf seeds with the clamped bit clear and t_out their t bits; kNodes
// -> out gets the packed nodes, the next launch's roots.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 2 keys).
extern "C" int fss_dpf_eval_all(const void* s0, const void* roots,
                                const void* cws, int64_t cw_ls, void* out,
                                void* t_out, int grid_log2, int b, int party,
                                int epilogue, uint32_t mask0, uint32_t mask1,
                                uint32_t mask2, uint32_t mask3, uint32_t mod0,
                                uint32_t mod1, uint32_t mod2, uint32_t mod3,
                                const void* prg, void* stream) {
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<2, AesTables>(prg, [&](auto p) {
#define FSS_DPF_EVAL_ALL(E)                                                 \
  launch<E>(s0, roots, cws, cw_ls, out, t_out, grid_log2, b, party, g, p, \
            st)
    switch (epilogue) {
      case fss::kXor: return FSS_DPF_EVAL_ALL(fss::kXor);
      case fss::kWrap: return FSS_DPF_EVAL_ALL(fss::kWrap);
      case fss::kMod64: return FSS_DPF_EVAL_ALL(fss::kMod64);
      case fss::kMod128: return FSS_DPF_EVAL_ALL(fss::kMod128);
      case fss::kMod128np: return FSS_DPF_EVAL_ALL(fss::kMod128np);
      case kSeeds: return FSS_DPF_EVAL_ALL(kSeeds);
      case kNodes: return FSS_DPF_EVAL_ALL(kNodes);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_DPF_EVAL_ALL
  });
}
