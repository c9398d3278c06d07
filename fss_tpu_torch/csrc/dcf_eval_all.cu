// DCF full-domain expansion (EvalAll): one thread per node expands it by
// L = 1..3 tree levels in registers, threading the value accumulator, and
// writes its 2^L descendants in x order.
//
// Replaces fss_tpu/ops/eval_all_pallas.py:dcf_eval_all (_make_dcf_kernel) with
// the ChaCha PRG; with AES-128-MMO it is the card's AES DCF EvalAll, which the
// JAX package runs as XLA (a template over the PRG, prg.cuh). A node is (s ||
// t) packed, the control bit in the clamped bit, plus the raw accumulator of
// the path to it (dcf_acc.cuh). Per node: the PRG's mul=4 blocks give (s_l,
// v_l, s_r, v_r); the seed CW (row words 0-3) is XORed into both children under
// (0 - t) and their t bits corrected with tl_cw / tr_cw; each child's
// accumulator is the parent's plus its own value block and the masked value CW
// (row words 4-7), clamped bits clear: the same sum dcf_eval.cu forms along one
// path. The TPU kernel covered Bytes and wrapping Uint only; this one takes all
// five accumulator modes, so every group's EvalAll runs here. The L cw rows are
// uniform loads (every thread of the launch reads the same 32..96 bytes), the
// counterpart of the TPU kernel's SMEM cw table.
//
// The caller runs the whole tree through this kernel, root first, in launches
// of up to 3 levels (1 with AES, fss::kMaxLevels in prg.cuh); the last launch
// writes the seeds with the clamped bit cleared and the t bits as a separate
// [N] plane, the layout the finalize reads.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A domain of
// 2^n leaves needs 2^n - 1 ChaCha blocks of 960 ops; at n = 24 that is ~1.6e10
// ops (~0.48 ms at 128 lanes x 132 SMs x 1.98 GHz) against 2^24 x 36 bytes of
// leaves (~0.18 ms at 3.35 TB/s). With AES: 4 (2^n - 1) blocks of 176
// shared-memory lookups, ~1.2e10 LDS at n = 24 (~1.4 ms at 32 a clock x 132 SMs
// x 1.98 GHz before bank conflicts). With L a template parameter the 2^L nodes
// and accumulators are registers, not local memory: at L = 3 and the 5-word
// mode that is 8 x 9 words beside the 16-word ChaCha state.

#include <cuda_runtime.h>

#include "prg.cuh"
#include "dcf_acc.cuh"

namespace {

template <int L, int M, class Prg>
__global__ void dcf_expand_kernel(const uint32_t* __restrict__ roots,
                                  const uint32_t* __restrict__ acc_in,
                                  const uint32_t* __restrict__ cw_rows,
                                  int64_t cw_ls, int4* __restrict__ out,
                                  uint32_t* __restrict__ acc_out,
                                  int32_t* __restrict__ t_out, int64_t count,
                                  uint4 vmask4, const Prg prg) {
  constexpr int kAcc = fss::Acc<M>::kWords;
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t r = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (r >= count) return;
  const uint32_t vmask[4] = {vmask4.x, vmask4.y, vmask4.z, vmask4.w};
  uint32_t node[1 << L][4];
  uint32_t acc[1 << L][kAcc];
#pragma unroll
  for (int w = 0; w < 4; ++w) node[0][w] = __ldg(roots + r * 4 + w);
#pragma unroll
  for (int w = 0; w < kAcc; ++w) acc[0][w] = __ldg(acc_in + r * kAcc + w);

#pragma unroll
  for (int lvl = 0; lvl < L; ++lvl) {
    const uint32_t* c = cw_rows + lvl * cw_ls;
    uint32_t cw[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) cw[w] = __ldg(c + w);
    const uint32_t tl_cw = cw[3] & 1u, cw3 = cw[3] & ~1u, tr_cw = cw[7] & 1u;
    // Backwards, so children 2j, 2j+1 never overwrite an unexpanded node.
#pragma unroll
    for (int j = (1 << lvl) - 1; j >= 0; --j) {
      const uint32_t t = node[j][3] & 1u;
      const uint32_t s[4] = {node[j][0], node[j][1], node[j][2],
                             node[j][3] & ~1u};
      uint32_t o[4][4];
      prg.expand4(s, o);
      const uint32_t tm = 0u - t;

      uint32_t vcm[4] = {cw[4] & tm, cw[5] & tm, cw[6] & tm,
                         cw[7] & ~1u & tm};
      fss::vfix<M>(vcm, vmask);
      uint32_t al[kAcc], ar[kAcc];
#pragma unroll
      for (int w = 0; w < kAcc; ++w) al[w] = ar[w] = acc[j][w];
      o[1][3] &= ~1u;
      o[3][3] &= ~1u;
      fss::accumulate<M>(al, o[1], vmask);
      fss::acc_add<M>(al, vcm);
      fss::accumulate<M>(ar, o[3], vmask);
      fss::acc_add<M>(ar, vcm);

      const uint32_t ltv = (o[0][3] & 1u) ^ (t & tl_cw);
      const uint32_t rtv = (o[2][3] & 1u) ^ (t & tr_cw);
      node[2 * j][0] = o[0][0] ^ (cw[0] & tm);
      node[2 * j][1] = o[0][1] ^ (cw[1] & tm);
      node[2 * j][2] = o[0][2] ^ (cw[2] & tm);
      node[2 * j][3] = ((o[0][3] ^ (cw3 & tm)) & ~1u) | ltv;
      node[2 * j + 1][0] = o[2][0] ^ (cw[0] & tm);
      node[2 * j + 1][1] = o[2][1] ^ (cw[1] & tm);
      node[2 * j + 1][2] = o[2][2] ^ (cw[2] & tm);
      node[2 * j + 1][3] = ((o[2][3] ^ (cw3 & tm)) & ~1u) | rtv;
#pragma unroll
      for (int w = 0; w < kAcc; ++w) {
        acc[2 * j][w] = al[w];
        acc[2 * j + 1][w] = ar[w];
      }
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
#pragma unroll
    for (int w = 0; w < kAcc; ++w) acc_out[(base + j) * kAcc + w] = acc[j][w];
  }
}

template <int L, int M, class Prg>
void launch(const void* roots, const void* acc_in, const void* cw_rows,
            int64_t cw_ls, void* out, void* acc_out, void* t_out,
            int64_t count, uint4 vmask, const Prg& prg, cudaStream_t stream) {
  const int threads = 128;
  const unsigned blocks = (unsigned)((count + threads - 1) / threads);
  dcf_expand_kernel<L, M, Prg><<<blocks, threads, 0, stream>>>(
      (const uint32_t*)roots, (const uint32_t*)acc_in,
      (const uint32_t*)cw_rows, cw_ls, (int4*)out, (uint32_t*)acc_out,
      (int32_t*)t_out, count, vmask, prg);
}

}  // namespace

// roots: [count, 4] packed nodes; acc_in: [count, 5] for kMod128np, else
// [count, 4]; cw_rows: `levels` cw rows, row i at cw_rows[i * cw_ls] (words
// 0..7 read). out: [count << levels, 4]; acc_out: [count << levels, 4 or
// 5]. t_out: null -> out keeps t in the clamped bit; else out's clamped
// bits are cleared and t goes to t_out [count << levels].
// mode: fss::Mode; vmask0..3: the contribution mask of kMod64 / kMod128*.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 4 keys).
extern "C" int fss_dcf_expand(const void* roots, const void* acc_in,
                              const void* cw_rows, int64_t cw_ls, void* out,
                              void* acc_out, void* t_out, int64_t count,
                              int levels, int mode, uint32_t vmask0,
                              uint32_t vmask1, uint32_t vmask2,
                              uint32_t vmask3, const void* prg,
                              void* stream) {
  if (count <= 0) return 0;
  const uint4 vmask = make_uint4(vmask0, vmask1, vmask2, vmask3);
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<4>(prg, [&](auto p) {
    using Prg = decltype(p);
    if (levels < 1 || levels > fss::kMaxLevels<Prg>)
      return (int)cudaErrorInvalidValue;
#define FSS_DCF_EXPAND(L, M)                                               \
  launch<L, M>(roots, acc_in, cw_rows, cw_ls, out, acc_out, t_out, count, \
               vmask, p, st)
#define FSS_DCF_EXPAND_MODES(L)                                 \
  switch (mode) {                                               \
    case fss::kXor: FSS_DCF_EXPAND(L, fss::kXor); break;         \
    case fss::kWrap: FSS_DCF_EXPAND(L, fss::kWrap); break;       \
    case fss::kMod64: FSS_DCF_EXPAND(L, fss::kMod64); break;     \
    case fss::kMod128: FSS_DCF_EXPAND(L, fss::kMod128); break;   \
    case fss::kMod128np: FSS_DCF_EXPAND(L, fss::kMod128np); break; \
    default: return (int)cudaErrorInvalidValue;                 \
  }
    if constexpr (fss::kMaxLevels<Prg> == 1) {
      FSS_DCF_EXPAND_MODES(1)
    } else {
      switch (levels) {
        case 1: FSS_DCF_EXPAND_MODES(1) break;
        case 2: FSS_DCF_EXPAND_MODES(2) break;
        default: FSS_DCF_EXPAND_MODES(3) break;
      }
    }
#undef FSS_DCF_EXPAND_MODES
#undef FSS_DCF_EXPAND
    return (int)cudaGetLastError();
  });
}
