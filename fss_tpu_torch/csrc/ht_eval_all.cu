// Half-Tree DPF full-domain expansion (EvalAll): one thread per node
// expands it by L = 1..3 levels in registers and writes its 2^L
// descendants in x order.
//
// Replaces fss_tpu/ops/eval_all_pallas.py:ht_eval_all (_make_ht_kernel)
// with the ChaCha PRG; with AES-128-MMO it is the card's AES Half-Tree
// EvalAll, which the JAX package runs as XLA (a template over the PRG,
// prg.cuh). A doubling level costs one mul=1 block a node:
//   left = H(hash_key ^ node) ^ (t ? cw : 0),  right = left ^ node,
// with t the node's clamped bit and every XOR over all 128 bits (the
// parent's t bit and the CW's low bit included). The conversion level
// (FINAL) hashes each node twice, with its clamped bit set to sigma = 0
// and 1, and writes 2 leaves a node: high = clear_lsb(h) ^ (t ? HCW : 0)
// with the clamped bit clear, low = lsb(h) ^ (t & LCW_sigma). The L key
// rows are read as uniform loads (every thread of the launch reads the
// same bytes), the counterpart of the TPU kernel's SMEM cw table.
//
// The caller runs the whole tree through this kernel, root first, in launches
// of up to 3 levels (1 with AES, fss::kMaxLevels in prg.cuh); the conversion is
// the last level of the last launch, so in_bits = 1 is one launch of the
// conversion alone.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A domain of
// 2^n leaves needs 2^(n-1) - 1 doubling blocks and 2^n conversion blocks of 960
// ops, 1.5x a DPF's ChaCha work for the same domain; at n = 24 that is ~2.4e10
// ops (~0.72 ms at 128 lanes x 132 SMs x 1.98 GHz) against 2^24 x 20 bytes of
// leaves (~0.1 ms at 3.35 TB/s). With AES the same blocks do 160 shared-memory
// lookups each, ~4.0e9 LDS at n = 24 (~0.48 ms at 32 a clock x 132 SMs x 1.98
// GHz; AesTables below keeps them free of bank conflicts). With L a template
// parameter the 2^L nodes are registers, and a final launch stores its leaves
// as they are converted, so it holds only its 2^(L-1) parents.

#include <cuda_runtime.h>

#include "prg.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 1>;

template <int L, bool FINAL, class Prg>
__global__ void ht_expand_kernel(const uint32_t* __restrict__ roots,
                                 const uint32_t* __restrict__ cw_rows,
                                 int64_t cw_ls, int4* __restrict__ out,
                                 int32_t* __restrict__ low_out,
                                 int64_t count, uint32_t hk0, uint32_t hk1,
                                 uint32_t hk2, uint32_t hk3, const Prg prg) {
  constexpr int D = FINAL ? L - 1 : L;  // doubling levels
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  uint32_t node[1 << D][4];
#pragma unroll
  for (int w = 0; w < 4; ++w) node[0][w] = __ldg(roots + r * 4 + w);

#pragma unroll
  for (int lvl = 0; lvl < D; ++lvl) {
    const uint32_t* c = cw_rows + lvl * cw_ls;
    const uint32_t c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    const uint32_t c3 = __ldg(c + 3);
    // Backwards, so children 2j, 2j+1 never overwrite an unexpanded node.
#pragma unroll
    for (int j = (1 << lvl) - 1; j >= 0; --j) {
      const uint32_t tm = 0u - (node[j][3] & 1u);
      uint32_t h[4] = {node[j][0] ^ hk0, node[j][1] ^ hk1, node[j][2] ^ hk2,
                       node[j][3] ^ hk3};
      prg.expand1(h, h);
      const uint32_t left[4] = {h[0] ^ (c0 & tm), h[1] ^ (c1 & tm),
                                h[2] ^ (c2 & tm), h[3] ^ (c3 & tm)};
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        node[2 * j + 1][w] = left[w] ^ node[j][w];
        node[2 * j][w] = left[w];
      }
    }
  }

  const int64_t base = r << L;
  if constexpr (FINAL) {
    const uint32_t* c = cw_rows + (L - 1) * cw_ls;
    const uint32_t hcw0 = __ldg(c), hcw1 = __ldg(c + 1), hcw2 = __ldg(c + 2);
    const uint32_t c3 = __ldg(c + 3);
    const uint32_t lcw[2] = {c3 & 1u, __ldg(c + 4) & 1u};
    const uint32_t hcw3 = c3 & ~1u;
#pragma unroll
    for (int j = 0; j < (1 << D); ++j) {
      const uint32_t t = node[j][3] & 1u, tm = 0u - t;
#pragma unroll
      for (uint32_t sigma = 0; sigma < 2; ++sigma) {
        uint32_t h[4] = {node[j][0] ^ hk0, node[j][1] ^ hk1,
                         node[j][2] ^ hk2,
                         ((node[j][3] & ~1u) | sigma) ^ hk3};
        prg.expand1(h, h);
        out[base + 2 * j + sigma] = make_int4(
            (int)(h[0] ^ (hcw0 & tm)), (int)(h[1] ^ (hcw1 & tm)),
            (int)(h[2] ^ (hcw2 & tm)), (int)((h[3] & ~1u) ^ (hcw3 & tm)));
        low_out[base + 2 * j + sigma] = (int32_t)((h[3] & 1u) ^
                                                  (t & lcw[sigma]));
      }
    }
  } else {
#pragma unroll
    for (int j = 0; j < (1 << L); ++j)
      out[base + j] = make_int4((int)node[j][0], (int)node[j][1],
                                (int)node[j][2], (int)node[j][3]);
  }
}

}  // namespace

// roots: [count, 4] nodes; cw_rows: `levels` key rows, row i at
// cw_rows[i * cw_ls] (words 0..4 read). final == 0: every row is a doubling
// level and out gets the nodes [count << levels, 4]. final != 0: the last
// row is the conversion level; out gets the leaves' high parts
// [count << levels, 4] (clamped bit clear) and low [count << levels] their
// low bits. hk0..hk3: the CCR hash key.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 1 key).
extern "C" int fss_ht_expand(const void* roots, const void* cw_rows,
                             int64_t cw_ls, void* out, void* low,
                             int64_t count, int levels, int final,
                             uint32_t hk0, uint32_t hk1, uint32_t hk2,
                             uint32_t hk3, const void* prg, void* stream) {
  if (count <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* in = (const uint32_t*)roots;
  const uint32_t* cw = (const uint32_t*)cw_rows;
  return fss::with_prg<1, AesTables>(prg, [&](auto p) {
    using Prg = decltype(p);
    if (levels < 1 || levels > fss::kMaxLevels<Prg>)
      return (int)cudaErrorInvalidValue;
    auto kernel = final ? ht_expand_kernel<1, true, Prg>
                        : ht_expand_kernel<1, false, Prg>;
    if constexpr (fss::kMaxLevels<Prg> == 3) {
      if (levels == 2)
        kernel = final ? ht_expand_kernel<2, true, Prg>
                       : ht_expand_kernel<2, false, Prg>;
      if (levels == 3)
        kernel = final ? ht_expand_kernel<3, true, Prg>
                       : ht_expand_kernel<3, false, Prg>;
    }
    return fss::launch_kernel<Prg>(kernel, blocks, threads, st, in, cw, cw_ls,
                                   (int4*)out, (int32_t*)low, count, hk0, hk1,
                                   hk2, hk3, p);
  });
}
