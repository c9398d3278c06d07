// The plan of the DPF, DCF and Half-Tree EvalAll kernels (dpf_eval_all.cu,
// dcf_eval_all.cu, ht_eval_all.cu): two launches a domain (one at in_bits =
// 1), one CTA a subtree.
//
// A domain of 2^n leaves is cut at depth k = n - b into 2^k subtrees of b
// levels (b = min(12, ceil(n / 2)), fss_tpu_torch/ops/eval_all_cuda.py:
// subtree_levels and plan). The body launch runs 2^k CTAs, CTA q expanding
// subtree root q, and its epilogue writes the finished leaves
// [q << b, (q + 1) << b). The top launch makes those roots: its 2^(k - t)
// CTAs (t = subtree_levels(k)) each walk k - t levels from the root to
// their own root, one node a level, taking the child that bit
// (walk - 1 - level) of q selects, then expand t levels, and its epilogue
// writes the 2^k roots (with the DCF's accumulators) to a scratch buffer,
// 64-144 KB at n = 24. Each CTA expands breadth-first, in place in shared
// memory; no other level touches device memory, and the PRG block appears
// once, in the node step, whichever level a thread is at.
//
// The body's CTAs could walk to their roots themselves and save the top
// launch, but that measured 10-17% slower with ChaCha and 3-5% with AES at
// n = 24 on the H100 (scripts/torch_eval_all_variants.py, PERF.md): a
// wave's CTAs start together, so their one-thread walks leave the SMs
// idle, where the top launch runs those levels across many threads.
//
// At the narrow top of each subtree (1, 2, 4, ... nodes a level) the other
// CTAs resident on the SM keep its schedulers busy: with 256 threads and at
// most 72 KB of shared memory a CTA, an SM holds 3-6 of them. 512 threads a
// CTA measured 1-11% slower at n = 24; 128 within 3% either way at n = 24,
// but 13-16% faster with ChaCha at n = 20 (PERF.md).
//
// In place: level lvl holds its W nodes at [0, W); the children of node j go
// to 2j and 2j + 1. Chunks of blockDim.x parents run from the last to the
// first, each read into registers, expanded, and written back only after a
// barrier, so no child overwrites a parent another thread has yet to read; the
// largest layer kept is the leaves' parents, 2^(b-1) nodes.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "prg.cuh"

namespace fss {

constexpr int kMaxSubtreeLevels = 12;

// Threads of a CTA that expands `b` levels: the widest layer it expands
// (2^(b-1) parents), at least a warp and at most 256.
inline int subtree_threads(int b) {
  const int w = 1 << (b - 1);
  return w < 32 ? 32 : (w > 256 ? 256 : w);
}

// The level loop of one CTA over levels [0, n), the first k of them the walk
// (k = 0 when the CTA's root comes from the top launch).
// Tree supplies the node type and its steps:
//   Node load(int j)                     node j of the current layer;
//   void store(int j, const Node&)       node j of the next layer;
//   void expand(int lvl, const Node&, Node& l, Node& r)   one PRG step;
//   void leaves(int j, const Node& l, const Node& r)      the epilogue of
//                                        leaves 2j, 2j + 1 of the subtree.
// The caller has stored the root at node 0 and synchronised.
template <class Tree>
__device__ __forceinline__ void subtree_levels(Tree& tree, int n, int k) {
  const int threads = blockDim.x;
  const int tid = threadIdx.x;
  const int64_t q = blockIdx.x;
  for (int lvl = 0; lvl < n; ++lvl) {
    const bool walk = lvl < k, last = lvl == n - 1;
    const int width = walk ? 1 : 1 << (lvl - k);
    for (int c = (width - 1) / threads; c >= 0; --c) {
      const int j = c * threads + tid;
      const bool active = j < width;
      typename Tree::Node l, r;
      if (active) {
        tree.expand(lvl, tree.load(j), l, r);
        if (last) tree.leaves(j, l, r);
      }
      if (last) continue;
      __syncthreads();
      if (active) {
        if (walk) {  // a branch, not `bit ? r : l`, keeps l, r in registers
          if ((q >> (k - 1 - lvl)) & 1) {
            tree.store(0, r);
          } else {
            tree.store(0, l);
          }
        } else {
          tree.store(2 * j, l);
          tree.store(2 * j + 1, r);
        }
      }
    }
    if (!last) __syncthreads();
  }
}

// Checks a launch's plan (2^grid_log2 CTAs of b levels) and sets the
// kernel's dynamic shared memory limit where the subtree (and the PRG's
// tables) need more than the default 48 KB.
template <class Kernel>
int subtree_plan(Kernel kernel, int grid_log2, int b, size_t smem) {
  if (b < 1 || b > kMaxSubtreeLevels || grid_log2 < 0 || grid_log2 > 30)
    return (int)cudaErrorInvalidValue;
  return allow_smem(kernel, smem);
}

}  // namespace fss
