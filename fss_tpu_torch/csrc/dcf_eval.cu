// Batched DCF point evaluation: one thread per key walks every tree level
// in registers and accumulates the path value.
//
// Replaces fss_tpu/ops/dcf_pallas.py:eval_packed (_make_kernel) with the
// ChaCha PRG and fss_tpu/ops/aes_pallas.py:_dcf_eval_call
// (_make_dcf_eval_kernel) with AES-128-MMO, as a template over the PRG
// (prg.cuh); unlike the AES TPU kernel, which took xor and wrap groups, it
// runs all five accumulator modes with either PRG. Per level: the PRG's
// mul=4 blocks of the seed give (s_l, v_l, s_r, v_r); the control
// bits come from the clamped bits of s_l and s_r, which are cleared, as are
// those of v_l and v_r; the seed CW (row words 0-3) is XORed into both
// children under the mask (0 - t); then v += (x ? v_r : v_l) + (t ? v_cw : 0)
// in the group's accumulator mode (dcf_acc.cuh), with v_cw = row words 4-7
// and its clamped bit (tr_cw) clear. The child is chosen by bit
// (in_bits-1-i) of x, read from lane (pos >> 5) so domains of 33..128 bits
// take x as 4 lanes (template parameter kWide: otherwise x is one word).
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A level is
// one 960-op ChaCha block plus ~30 ops of correction, selection and
// accumulation, against 32 bytes of cw read; at 2^20 keys x 16 levels that is
// ~1.6e10 ops (~0.48 ms at 128 lanes x 132 SMs x 1.98 GHz) but ~0.54 GB (~0.16
// ms at 3.35 TB/s). With AES: four blocks of 160 shared-memory lookups a level,
// ~1.1e10 LDS at 2^20 keys x 16 levels (~1.3 ms at 32 a clock x 132 SMs x 1.98
// GHz; AesTables below keeps them free of bank conflicts). As in dpf_eval.cu,
// the ChaCha state, the seed, t and the accumulator stay in registers for the
// whole walk so nothing but the key bytes touches memory. The cw is addressed
// through three strides (level, word, key), so the kernel streams wire rows [B,
// n+1, 8] in place or one broadcast key (key stride 0).
//
// Two epilogues, chosen by a kernel argument (shares null or not), not a
// template parameter, so the source builds 20 kernels, not 40:
//   raw     the accumulator (16 B, 20 for kMod128np), the final seed (16 B)
//           and t (4 B) a key, 36-40 B, for ops/dcf_cuda.py:finalize;
//   shares  the finished share, 16 B a key: dcf_share (dcf_acc.cuh), the
//           epilogue of dcf_eval_all.cu's leaves, with v_last read from the
//           key's row n (words 4-7) where t is set. Its work is ~40 ALU
//           ops a key for wrap and xor groups (~0.2% of a 20-level ChaCha
//           walk's), up to three 127-135-step long divisions for kMod128np.

#include <cuda_runtime.h>

#include "prg.cuh"
#include "dcf_acc.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

template <bool kWide, int M, class Prg>
__global__ void dcf_eval_kernel(const uint32_t* __restrict__ seeds,
                                int64_t seed_ks,
                                const uint32_t* __restrict__ cws,
                                int64_t cw_ls, int64_t cw_ws, int64_t cw_ks,
                                const uint32_t* __restrict__ xs,
                                uint32_t* __restrict__ vo,
                                int4* __restrict__ so,
                                int32_t* __restrict__ t_out,
                                int4* __restrict__ shares, int64_t batch,
                                int in_bits, int party, uint4 vmask4,
                                fss::Group g, const Prg prg) {
  constexpr int kAcc = fss::Acc<M>::kWords;
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t vmask[4] = {vmask4.x, vmask4.y, vmask4.z, vmask4.w};
  const uint32_t* sp = seeds + k * seed_ks;
  uint32_t s[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                   __ldg(sp + 3) & ~1u};
  uint32_t t = (uint32_t)party;
  uint32_t acc[kAcc];
#pragma unroll
  for (int w = 0; w < kAcc; ++w) acc[w] = 0u;
  const uint32_t* key = cws + k * cw_ks;
  const uint32_t* x = xs + k * (kWide ? 4 : 1);
  const uint32_t x0 = kWide ? 0u : __ldg(x);

  for (int i = 0; i < in_bits; ++i) {
    uint32_t o[4][4];
    prg.expand4(s, o);
    const uint32_t* c = key + i * cw_ls;
    uint32_t cw[8];
#pragma unroll
    for (int w = 0; w < 8; ++w) cw[w] = __ldg(c + w * cw_ws);
    const uint32_t tm = 0u - t;
    const uint32_t tl = (o[0][3] & 1u) ^ (t & cw[3] & 1u);
    const uint32_t tr = (o[2][3] & 1u) ^ (t & cw[7] & 1u);
    const int pos = in_bits - 1 - i;
    const bool bit =
        ((kWide ? __ldg(x + (pos >> 5)) : x0) >> (pos & 31)) & 1u;

    // v += (x ? v_r : v_l) + (t ? v_cw : 0), clamped bits clear.
    uint32_t step[4], vcm[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      step[w] = bit ? o[3][w] : o[1][w];
      vcm[w] = cw[4 + w] & tm;
    }
    step[3] &= ~1u;
    vcm[3] &= ~1u;
    fss::accumulate<M>(acc, step, vmask);
    fss::accumulate<M>(acc, vcm, vmask);

#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s[w] = (bit ? o[2][w] : o[0][w]) ^ (cw[w] & tm);
    }
    s[3] &= ~1u;
    t = bit ? tr : tl;
  }
  if (shares != nullptr) {
    uint32_t vl[4] = {0u, 0u, 0u, 0u};
    if (t) {
      const uint32_t* c = key + in_bits * cw_ls + 4 * cw_ws;
#pragma unroll
      for (int w = 0; w < 4; ++w) vl[w] = __ldg(c + w * cw_ws);
      fss::from_block<M>(g, vl);
    }
    shares[k] = fss::dcf_share<M>(g, acc, s, t, vl, (uint32_t)party);
    return;
  }
#pragma unroll
  for (int w = 0; w < kAcc; ++w) vo[k * kAcc + w] = acc[w];
  so[k] = make_int4((int)s[0], (int)s[1], (int)s[2], (int)s[3]);
  t_out[k] = (int32_t)t;
}

template <bool kWide, int M, class Prg>
int launch(const void* seeds, int64_t seed_ks, const void* cws,
            int64_t cw_ls, int64_t cw_ws, int64_t cw_ks, const void* xs,
            void* vo, void* so, void* t_out, void* shares, int64_t batch,
            int in_bits, int party, uint4 vmask, const fss::Group& g,
            const Prg& prg, cudaStream_t stream) {
  const int threads = 128;
  const int64_t blocks = (batch + threads - 1) / threads;
  return fss::launch_kernel<Prg>(
      dcf_eval_kernel<kWide, M, Prg>, (unsigned)blocks, threads, stream,
      (const uint32_t*)seeds, seed_ks, (const uint32_t*)cws, cw_ls, cw_ws,
      cw_ks, (const uint32_t*)xs, (uint32_t*)vo, (int4*)so, (int32_t*)t_out,
      (int4*)shares, batch, in_bits, party, vmask, g, prg);
}

}  // namespace

// seeds: [B, 4] (seed_ks = 4) or one broadcast seed (seed_ks = 0).
// cws: word w of level i of key k at cws[i * cw_ls + w * cw_ws + k * cw_ks].
// xs: [B] words (wide = 0, in_bits <= 32) or [B, 4] lanes (wide = 1).
// mode: fss::Mode; vmask0..3: the contribution mask of kMod64 / kMod128*.
// shares null (raw): vo [B, 5] for kMod128np, else [B, 4]; so [B, 4] final
// seeds (clamped bit clear); t_out [B] control bits.
// shares not null: shares [B, 4] get the party's shares and vo, so, t_out
// are not written; mask0..3 and mod0..3: fss::Group
// (ops/dcf_cuda.py:gen_params), read only then.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 4 keys).
extern "C" int fss_dcf_eval(const void* seeds, int64_t seed_ks,
                            const void* cws, int64_t cw_ls, int64_t cw_ws,
                            int64_t cw_ks, const void* xs, int wide, void* vo,
                            void* so, void* t_out, void* shares,
                            int64_t batch, int in_bits, int party, int mode,
                            uint32_t vmask0, uint32_t vmask1, uint32_t vmask2,
                            uint32_t vmask3, uint32_t mask0, uint32_t mask1,
                            uint32_t mask2, uint32_t mask3, uint32_t mod0,
                            uint32_t mod1, uint32_t mod2, uint32_t mod3,
                            const void* prg, void* stream) {
  if (batch <= 0) return 0;
  const uint4 vmask = make_uint4(vmask0, vmask1, vmask2, vmask3);
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<4, AesTables>(prg, [&](auto p) {
#define FSS_DCF_EVAL(W, M)                                                  \
  return launch<W, M>(seeds, seed_ks, cws, cw_ls, cw_ws, cw_ks, xs, vo, so, \
                      t_out, shares, batch, in_bits, party, vmask, g, p, st)
#define FSS_DCF_EVAL_MODES(W)                           \
  switch (mode) {                                       \
    case fss::kXor: FSS_DCF_EVAL(W, fss::kXor);         \
    case fss::kWrap: FSS_DCF_EVAL(W, fss::kWrap);       \
    case fss::kMod64: FSS_DCF_EVAL(W, fss::kMod64);     \
    case fss::kMod128: FSS_DCF_EVAL(W, fss::kMod128);   \
    case fss::kMod128np: FSS_DCF_EVAL(W, fss::kMod128np); \
    default: return (int)cudaErrorInvalidValue;         \
  }
    if (wide) {
      FSS_DCF_EVAL_MODES(true)
    } else {
      FSS_DCF_EVAL_MODES(false)
    }
#undef FSS_DCF_EVAL_MODES
#undef FSS_DCF_EVAL
  });
}
