// DCF full-domain evaluation (EvalAll) of one key in two launches: the tree
// from the root to the leaves, the value accumulator along every path, and
// the leaves' group finalize.
//
// Replaces fss_tpu/ops/eval_all_pallas.py:dcf_eval_all (_make_dcf_kernel) and
// the finalize of fss_tpu/schemes/dcf.py:eval_all with the ChaCha PRG; with
// AES-128-MMO it is the card's AES DCF EvalAll, which the JAX package runs as
// XLA (a template over the PRG, prg.cuh). A node is (s || t) packed, the
// control bit in the clamped bit, plus the raw accumulator of the path to it
// (dcf_acc.cuh). Per node: the PRG's mul=4 blocks give (s_l, v_l, s_r, v_r);
// the seed CW (row words 0-3) is XORed into both children under (0 - t) and
// their t bits corrected with tl_cw / tr_cw; each child's accumulator is the
// parent's plus its own value block and the masked value CW (row words 4-7),
// clamped bits clear: the same sum dcf_eval.cu forms along one path. The TPU
// kernel covered Bytes and wrapping Uint only; this one takes all five group
// kinds. The cw rows are uniform loads (every thread of the launch reads the
// same 32 bytes a level), the counterpart of the TPU kernel's SMEM cw table.
//
// The plan (subtree.cuh): the top launch expands the first k levels and
// writes the 2^k subtree roots and their accumulators; the body launch's CTA
// q expands root q breadth-first in shared memory, accumulators beside the
// seeds, and its epilogue writes each leaf's share once:
//   y = +-(acc_value(acc) + from_block(s) (+ from_block(v_last) where t)),
// v_last = cws row n words 4-7, in the group (dcf_acc.cuh: dcf_share, which
// dcf_eval.cu's shares epilogue runs too). Which
// of the two epilogues runs is a kernel argument, not a template parameter,
// so the source builds 10 kernels, not 20.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A domain of
// 2^n leaves needs 2^n - 1 ChaCha blocks of 960 ops; at n = 24 that is ~1.6e10
// ops (~0.48 ms at 128 lanes x 132 SMs x 1.98 GHz) against 2^24 x 16 bytes of
// shares (~0.08 ms at 3.35 TB/s). With AES: 4 (2^n - 1) blocks of 160
// shared-memory lookups, ~1.1e10 LDS at n = 24 (~1.3 ms at 32 a clock x 132 SMs
// x 1.98 GHz; AesTables below keeps them free of bank conflicts, its 64 KB at
// the front of the dynamic shared memory). A node takes 32 bytes of shared
// memory (36 with the 5-word accumulator), so a CTA of b = 12 levels holds
// 64-72 KB and an SM three such CTAs; the accumulators never reach device
// memory.

#include <cuda_runtime.h>

#include "dcf_acc.cuh"
#include "group.cuh"
#include "prg.cuh"
#include "subtree.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

template <int M>
struct DcfNode {
  uint4 s;
  uint32_t acc[fss::Acc<M>::kWords];
};

template <int M, class Prg>
struct DcfTree {
  static constexpr int kAcc = fss::Acc<M>::kWords;
  using Node = DcfNode<M>;
  const Prg& prg;
  uint4* seeds;   // shared memory: [cap] seeds,
  uint32_t* acc;  // then [kAcc][cap] accumulator words
  int cap;
  const uint32_t* __restrict__ cws;
  int64_t cw_ls;
  int4* __restrict__ out;
  uint32_t* __restrict__ acc_out;  // not null: write nodes, not shares
  int64_t base;  // the subtree's first leaf
  uint32_t party;
  fss::Group g;
  uint32_t vmask[4];
  uint32_t vl[4];  // from_block(v_last)

  __device__ __forceinline__ Node load(int j) const {
    Node v;
    v.s = seeds[j];
#pragma unroll
    for (int w = 0; w < kAcc; ++w) v.acc[w] = acc[w * cap + j];
    return v;
  }

  __device__ __forceinline__ void store(int j, const Node& v) const {
    seeds[j] = v.s;
#pragma unroll
    for (int w = 0; w < kAcc; ++w) acc[w * cap + j] = v.acc[w];
  }

  __device__ __forceinline__ void expand(int lvl, const Node& p, Node& l,
                                         Node& r) const {
    const uint32_t* c = cws + lvl * cw_ls;
    uint32_t cw[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) cw[w] = __ldg(c + w);
    const uint32_t t = p.s.w & 1u, tm = 0u - t;
    const uint32_t s[4] = {p.s.x, p.s.y, p.s.z, p.s.w & ~1u};
    uint32_t o[4][4];
    prg.expand4(s, o);

    uint32_t vcm[4] = {cw[4] & tm, cw[5] & tm, cw[6] & tm, cw[7] & ~1u & tm};
    fss::vfix<M>(vcm, vmask);
#pragma unroll
    for (int w = 0; w < kAcc; ++w) l.acc[w] = r.acc[w] = p.acc[w];
    o[1][3] &= ~1u;
    o[3][3] &= ~1u;
    fss::accumulate<M>(l.acc, o[1], vmask);
    fss::acc_add<M>(l.acc, vcm);
    fss::accumulate<M>(r.acc, o[3], vmask);
    fss::acc_add<M>(r.acc, vcm);

    const uint32_t cw3 = cw[3] & ~1u;
    const uint32_t tl = (o[0][3] & 1u) ^ (t & cw[3] & 1u);
    const uint32_t tr = (o[2][3] & 1u) ^ (t & cw[7] & 1u);
    l.s = make_uint4(o[0][0] ^ (cw[0] & tm), o[0][1] ^ (cw[1] & tm),
                     o[0][2] ^ (cw[2] & tm),
                     ((o[0][3] ^ (cw3 & tm)) & ~1u) | tl);
    r.s = make_uint4(o[2][0] ^ (cw[0] & tm), o[2][1] ^ (cw[1] & tm),
                     o[2][2] ^ (cw[2] & tm),
                     ((o[2][3] ^ (cw3 & tm)) & ~1u) | tr);
  }

  __device__ __forceinline__ int4 share(const Node& v) const {
    const uint32_t s[4] = {v.s.x, v.s.y, v.s.z, v.s.w & ~1u};
    return fss::dcf_share<M>(g, v.acc, s, v.s.w & 1u, vl, party);
  }

  __device__ __forceinline__ void leaves(int j, const Node& l,
                                         const Node& r) const {
    const int64_t i = base + 2 * j;
    if (acc_out != nullptr) {
      reinterpret_cast<uint4*>(out)[i] = l.s;
      reinterpret_cast<uint4*>(out)[i + 1] = r.s;
#pragma unroll
      for (int w = 0; w < kAcc; ++w) {
        acc_out[i * kAcc + w] = l.acc[w];
        acc_out[(i + 1) * kAcc + w] = r.acc[w];
      }
    } else {
      out[i] = share(l);
      out[i + 1] = share(r);
    }
  }
};

template <int M, class Prg>
__global__ void __launch_bounds__(256)
    dcf_eval_all_kernel(const uint32_t* __restrict__ s0,
                        const uint4* __restrict__ roots,
                        const uint32_t* __restrict__ roots_acc,
                        const uint32_t* __restrict__ cws, int64_t cw_ls,
                        int4* __restrict__ out, uint32_t* __restrict__ acc_out,
                        int walk, int b, uint32_t party, uint4 vmask4,
                        fss::Group g, const Prg prg) {
  constexpr int kAcc = fss::Acc<M>::kWords;
  extern __shared__ uint4 smem_all[];
  prg.init();  // AES fills its shared tables; every thread, then a barrier
  uint4* smem = smem_all + fss::kPrgSmem<Prg> / sizeof(uint4);
  const int cap = 1 << (b - 1);
  DcfTree<M, Prg> tree{prg, smem, reinterpret_cast<uint32_t*>(smem + cap),
                       cap, cws, cw_ls, out, acc_out,
                       (int64_t)blockIdx.x << b, party, g,
                       {vmask4.x, vmask4.y, vmask4.z, vmask4.w},
                       {0u, 0u, 0u, 0u}};
  if (acc_out == nullptr) {
    const uint32_t* v_last = cws + (walk + b) * cw_ls + 4;
#pragma unroll
    for (int w = 0; w < 4; ++w) tree.vl[w] = __ldg(v_last + w);
    fss::from_block<M>(g, tree.vl);
  }
  if (threadIdx.x == 0) {
    const int64_t q = blockIdx.x;
    smem[0] = roots != nullptr
                  ? roots[q]
                  : make_uint4(__ldg(s0), __ldg(s0 + 1), __ldg(s0 + 2),
                               (__ldg(s0 + 3) & ~1u) | party);
#pragma unroll
    for (int w = 0; w < kAcc; ++w)
      tree.acc[w * cap] = roots != nullptr ? roots_acc[q * kAcc + w] : 0u;
  }
  __syncthreads();
  fss::subtree_levels(tree, walk + b, walk);
}

template <int M, class Prg>
int launch(const void* s0, const void* roots, const void* roots_acc,
           const void* cws, int64_t cw_ls, void* out, void* acc_out,
           int grid_log2, int b, int party, uint4 vmask, const fss::Group& g,
           const Prg& prg, cudaStream_t stream) {
  auto kernel = dcf_eval_all_kernel<M, Prg>;
  const size_t smem = fss::kPrgSmem<Prg> +
                      ((sizeof(uint4) + 4 * fss::Acc<M>::kWords) << (b - 1));
  const int rc = fss::subtree_plan(kernel, grid_log2, b, smem);
  if (rc != 0) return rc;
  kernel<<<1u << grid_log2, fss::subtree_threads(b), smem, stream>>>(
      (const uint32_t*)s0, (const uint4*)roots, (const uint32_t*)roots_acc,
      (const uint32_t*)cws, cw_ls, (int4*)out, (uint32_t*)acc_out,
      roots != nullptr ? 0 : grid_log2, b, (uint32_t)party, vmask, g, prg);
  return (int)cudaGetLastError();
}

}  // namespace

// One launch of the plan: 2^grid_log2 CTAs, each expanding b (1..12) levels
// below its root: roots[q] ([2^grid_log2, 4] packed nodes) and roots_acc[q]
// ([2^grid_log2, 4 or 5] accumulators) when roots is not null, else the
// party's root seed s0 [4] walked grid_log2 levels down. cws: row i of the
// launch's levels at cws[i * cw_ls] (words 0..7; the walk's rows first),
// then the final value CW (words 4..7) for the shares.
// acc_out: null -> out [2^(grid_log2 + b), 4] gets the shares; else out gets
// the packed nodes and acc_out [2^(grid_log2 + b), 4 or 5] their
// accumulators, the next launch's roots.
// mode: fss::Mode of the group; vmask0..3: the contribution mask of
// kMod64 / kMod128* (ops/dcf_cuda.py:value_mask); mask0..3 and mod0..3:
// fss::Group (ops/dcf_cuda.py:gen_params).
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 4 keys).
extern "C" int fss_dcf_eval_all(const void* s0, const void* roots,
                                const void* roots_acc, const void* cws,
                                int64_t cw_ls, void* out, void* acc_out,
                                int grid_log2, int b, int party, int mode,
                                uint32_t vmask0, uint32_t vmask1,
                                uint32_t vmask2, uint32_t vmask3,
                                uint32_t mask0, uint32_t mask1,
                                uint32_t mask2, uint32_t mask3, uint32_t mod0,
                                uint32_t mod1, uint32_t mod2, uint32_t mod3,
                                const void* prg, void* stream) {
  const uint4 vmask = make_uint4(vmask0, vmask1, vmask2, vmask3);
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<4, AesTables>(prg, [&](auto p) {
#define FSS_DCF_EVAL_ALL(M)                                              \
  launch<M>(s0, roots, roots_acc, cws, cw_ls, out, acc_out, grid_log2, b, \
            party, vmask, g, p, st)
    switch (mode) {
      case fss::kXor: return FSS_DCF_EVAL_ALL(fss::kXor);
      case fss::kWrap: return FSS_DCF_EVAL_ALL(fss::kWrap);
      case fss::kMod64: return FSS_DCF_EVAL_ALL(fss::kMod64);
      case fss::kMod128: return FSS_DCF_EVAL_ALL(fss::kMod128);
      case fss::kMod128np: return FSS_DCF_EVAL_ALL(fss::kMod128np);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_DCF_EVAL_ALL
  });
}
