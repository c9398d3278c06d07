// DPF full-domain expansion (EvalAll): one thread per node expands it by
// L = 1..3 tree levels in registers and writes its 2^L descendants in x
// order.
//
// Replaces fss_tpu/ops/eval_all_pallas.py:_expand_packed (_make_kernel)
// with the ChaCha PRG; with AES-128-MMO it is the card's AES EvalAll, which
// the JAX package runs as XLA (a template over the PRG, prg.cuh).
// Nodes are packed (s, t): the control bit rides in the clamped bit (LSB
// of word 3). Per node: the PRG's mul=2 pair, the level's correction word XORed
// into both children under the mask (0 - t), the children's t bits
// corrected with tl_cw / tr_cw. The L cw rows are read as uniform loads
// (every thread of the launch reads the same 40..120 bytes), the
// counterpart of the TPU kernel's SMEM cw table.
//
// The caller runs the whole tree through this kernel, root first, in launches
// of up to 3 levels (1 with AES, fss::kMaxLevels in prg.cuh); the last launch
// writes the seeds with the clamped bit cleared and the t bits as a separate
// [N] plane, the layout the group finalize reads.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A domain of
// 2^n leaves needs 2^n - 1 ChaCha blocks of 960 ops; at n = 24 that is ~1.6e10
// ops (~0.48 ms at 128 lanes x 132 SMs x 1.98 GHz) against 2^24 x 20 bytes of
// leaves (~0.1 ms at 3.35 TB/s). With AES: 2 (2^n - 1) blocks of 176
// shared-memory lookups, ~5.9e9 LDS at n = 24 (~0.71 ms at 32 a clock x 132 SMs
// x 1.98 GHz before bank conflicts). Expanding 3 levels per launch in registers
// cuts the intermediate levels' traffic to 1/8 of the leaves' and keeps every
// node's ChaCha state in registers; with L fixed at compile time the 2^L nodes
// are registers, not local memory.

#include <cuda_runtime.h>

#include "prg.cuh"

namespace {

template <int L, class Prg>
__global__ void dpf_expand_kernel(const uint32_t* __restrict__ roots,
                                  const uint32_t* __restrict__ cw_rows,
                                  int64_t cw_ls, int4* __restrict__ out,
                                  int32_t* __restrict__ t_out, int64_t count,
                                  const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  uint32_t node[1 << L][4];
#pragma unroll
  for (int w = 0; w < 4; ++w) node[0][w] = __ldg(roots + r * 4 + w);

#pragma unroll
  for (int lvl = 0; lvl < L; ++lvl) {
    const uint32_t* c = cw_rows + lvl * cw_ls;
    const uint32_t c0 = __ldg(c), c1 = __ldg(c + 1), c2 = __ldg(c + 2);
    const uint32_t c3 = __ldg(c + 3), c4 = __ldg(c + 4);
    const uint32_t tl_cw = c3 & 1u, cw3 = c3 & ~1u, tr_cw = c4 & 1u;
    // Backwards, so children 2j, 2j+1 never overwrite an unexpanded node.
#pragma unroll
    for (int j = (1 << lvl) - 1; j >= 0; --j) {
      const uint32_t t = node[j][3] & 1u;
      const uint32_t s[4] = {node[j][0], node[j][1], node[j][2],
                             node[j][3] & ~1u};
      uint32_t l[4], q[4];
      prg.expand2(s, l, q);
      const uint32_t tm = 0u - t;
      const uint32_t ltv = (l[3] & 1u) ^ (t & tl_cw);
      const uint32_t rtv = (q[3] & 1u) ^ (t & tr_cw);
      node[2 * j][0] = l[0] ^ (c0 & tm);
      node[2 * j][1] = l[1] ^ (c1 & tm);
      node[2 * j][2] = l[2] ^ (c2 & tm);
      node[2 * j][3] = ((l[3] ^ (cw3 & tm)) & ~1u) | ltv;
      node[2 * j + 1][0] = q[0] ^ (c0 & tm);
      node[2 * j + 1][1] = q[1] ^ (c1 & tm);
      node[2 * j + 1][2] = q[2] ^ (c2 & tm);
      node[2 * j + 1][3] = ((q[3] ^ (cw3 & tm)) & ~1u) | rtv;
    }
  }

  const int64_t base = r << L;
#pragma unroll
  for (int j = 0; j < (1 << L); ++j) {
    uint32_t w3 = node[j][3];
    if (t_out != nullptr) {
      t_out[base + j] = (int32_t)(w3 & 1u);
      w3 &= ~1u;
    }
    out[base + j] = make_int4((int)node[j][0], (int)node[j][1],
                              (int)node[j][2], (int)w3);
  }
}

}  // namespace

// roots: [count, 4] packed nodes; cw_rows: `levels` cw rows, row i at
// cw_rows[i * cw_ls] (words 0..4 read). out: [count << levels, 4].
// t_out: null -> out keeps t in the clamped bit; else out's clamped bits
// are cleared and t goes to t_out [count << levels].
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 2 keys).
extern "C" int fss_dpf_expand(const void* roots, const void* cw_rows,
                              int64_t cw_ls, void* out, void* t_out,
                              int64_t count, int levels, const void* prg,
                              void* stream) {
  if (count <= 0) return 0;
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  const uint32_t* in = (const uint32_t*)roots;
  const uint32_t* cw = (const uint32_t*)cw_rows;
  return fss::with_prg<2>(prg, [&](auto p) {
    using Prg = decltype(p);
    if (levels < 1 || levels > fss::kMaxLevels<Prg>)
      return (int)cudaErrorInvalidValue;
    auto kernel = dpf_expand_kernel<1, Prg>;
    if constexpr (fss::kMaxLevels<Prg> == 3) {
      if (levels == 2) kernel = dpf_expand_kernel<2, Prg>;
      if (levels == 3) kernel = dpf_expand_kernel<3, Prg>;
    }
    kernel<<<blocks, threads, 0, st>>>(in, cw, cw_ls, (int4*)out,
                                       (int32_t*)t_out, count, p);
    return (int)cudaGetLastError();
  });
}
