// Batched DCF key generation (lt or gt): one thread per key runs both
// parties' seeds down the path to alpha and threads the group value.
//
// Replaces fss_tpu/ops/dcf_pallas.py:gen_packed (_make_gen_kernel) with the
// ChaCha PRG and fss_tpu/ops/aes_pallas.py:dcf_gen_packed
// (_make_dcf_gen_kernel) with AES-128-MMO, as a template over the PRG
// (prg.cuh), and computes the same function as fss_tpu/schemes/dcf.py:gen.
// Per level: two mul=4 expansions, (s_l, v_l, s_r, v_r) per party, clamped bits
// split off the seeds and cleared on the value blocks, which become group
// values (from_block). The seed CW is the XOR of the off-path children;
// the value CW is -v + v1_off - v0_off, plus beta when the off-path side is
// the predicate's side (lt: alpha bit 1, gt: alpha bit 0), negated when
// t1 is set; v then moves by v0_on - v1_on +- v_cw. The row is written as
// {s_cw | tl_cw, into_block(v_cw) | tr_cw}; the last row is
// {0, 0, 0, 0, v_cw_{n+1}} with v_cw_{n+1} = +-(s1 - s0 - v).
//
// Unlike the TPU kernels, which took Bytes and Uint (mod 0, up to 64 bits) with
// 32-bit alphas, this kernel covers every group of the port (group.cuh, the
// group kind a template parameter) and every alpha width (alpha as 4 lanes, bit
// (in_bits-1-i) read from lane (pos >> 5)), so no Gen on the card needs a plain
// path.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. Two 960-op
// ChaCha blocks per level against 32 bytes of key written; at 2^20 keys x 16
// levels, ~3.2e10 ops (~0.96 ms at 128 lanes x 132 SMs x 1.98 GHz) against ~0.6
// GB (~0.18 ms at 3.35 TB/s). With AES: eight blocks of 176 shared-memory
// lookups a level, ~2.4e10 LDS (~2.8 ms at 32 a clock x 132 SMs x 1.98 GHz
// before bank conflicts). Both seeds, both ChaCha outputs and the running value
// stay in registers across levels; each level's row goes out as two 16-byte
// stores.

#include <cuda_runtime.h>

#include "prg.cuh"
#include "group.cuh"

namespace {

template <int M, class Prg>
__global__ void dcf_gen_kernel(const uint32_t* __restrict__ seeds,
                               const uint32_t* __restrict__ alphas,
                               int64_t a_ks,
                               const uint32_t* __restrict__ betas,
                               int4* __restrict__ cws, int64_t batch,
                               int in_bits, int pred_lt, fss::Group g,
                               const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t* sp = seeds + k * 8;
  uint32_t s0[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                    __ldg(sp + 3) & ~1u};
  uint32_t s1[4] = {__ldg(sp + 4), __ldg(sp + 5), __ldg(sp + 6),
                    __ldg(sp + 7) & ~1u};
  uint32_t t0 = 0u, t1 = 1u;
  const uint32_t* bp = betas + k * 4;
  uint32_t b[4] = {__ldg(bp), __ldg(bp + 1), __ldg(bp + 2),
                   __ldg(bp + 3) & ~1u};
  fss::from_block<M>(g, b);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  const uint32_t* a = alphas + k * a_ks;
  int4* row = cws + k * (in_bits + 1) * 2;

  for (int i = 0; i < in_bits; ++i) {
    uint32_t o0[4][4], o1[4][4];
    prg.expand4(s0, o0);
    prg.expand4(s1, o1);
    const uint32_t t0l = o0[0][3] & 1u, t0r = o0[2][3] & 1u;
    const uint32_t t1l = o1[0][3] & 1u, t1r = o1[2][3] & 1u;
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      o0[j][3] &= ~1u;
      o1[j][3] &= ~1u;
    }
    fss::from_block<M>(g, o0[1]);
    fss::from_block<M>(g, o0[3]);
    fss::from_block<M>(g, o1[1]);
    fss::from_block<M>(g, o1[3]);

    const int pos = in_bits - 1 - i;
    const uint32_t ab = (__ldg(a + (pos >> 5)) >> (pos & 31)) & 1u;
    uint32_t s_cw[4], v_cw[4], tmp[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s_cw[w] = ab ? (o0[0][w] ^ o1[0][w]) : (o0[2][w] ^ o1[2][w]);
    }

    // v_cw = -v + v1_off - v0_off (+ beta), negated when t1.
#pragma unroll
    for (int w = 0; w < 4; ++w) v_cw[w] = v[w];
    fss::gneg<M>(g, v_cw);
#pragma unroll
    for (int w = 0; w < 4; ++w) tmp[w] = ab ? o1[1][w] : o1[3][w];
    fss::gadd<M>(g, v_cw, tmp);
#pragma unroll
    for (int w = 0; w < 4; ++w) tmp[w] = ab ? o0[1][w] : o0[3][w];
    fss::gneg<M>(g, tmp);
    fss::gadd<M>(g, v_cw, tmp);
    if (pred_lt ? ab : !ab) fss::gadd<M>(g, v_cw, b);
    if (t1) fss::gneg<M>(g, v_cw);

    // v += v0_on - v1_on +- v_cw.
#pragma unroll
    for (int w = 0; w < 4; ++w) tmp[w] = ab ? o1[3][w] : o1[1][w];
    fss::gneg<M>(g, tmp);
    fss::gadd<M>(g, v, tmp);
#pragma unroll
    for (int w = 0; w < 4; ++w) tmp[w] = ab ? o0[3][w] : o0[1][w];
    fss::gadd<M>(g, v, tmp);
#pragma unroll
    for (int w = 0; w < 4; ++w) tmp[w] = v_cw[w];
    if (t1) fss::gneg<M>(g, tmp);
    fss::gadd<M>(g, v, tmp);

    const uint32_t tl_cw = t0l ^ t1l ^ ab ^ 1u;
    const uint32_t tr_cw = t0r ^ t1r ^ ab;
    fss::into_block<M>(v_cw);
    row[2 * i] = make_int4((int)s_cw[0], (int)s_cw[1], (int)s_cw[2],
                           (int)(s_cw[3] | tl_cw));
    row[2 * i + 1] = make_int4((int)v_cw[0], (int)v_cw[1], (int)v_cw[2],
                               (int)((v_cw[3] & ~1u) | tr_cw));

    const uint32_t tcw = ab ? tr_cw : tl_cw;
    const uint32_t tm0 = 0u - t0, tm1 = 0u - t1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s0[w] = (ab ? o0[2][w] : o0[0][w]) ^ (s_cw[w] & tm0);
      s1[w] = (ab ? o1[2][w] : o1[0][w]) ^ (s_cw[w] & tm1);
    }
    t0 = (ab ? t0r : t0l) ^ (t0 & tcw);
    t1 = (ab ? t1r : t1l) ^ (t1 & tcw);
  }

  // v_cw_{n+1} = s1 - s0 - v, negated when t1.
  fss::from_block<M>(g, s0);
  fss::from_block<M>(g, s1);
  fss::gneg<M>(g, s0);
  fss::gadd<M>(g, s1, s0);
  fss::gneg<M>(g, v);
  fss::gadd<M>(g, s1, v);
  if (t1) fss::gneg<M>(g, s1);
  fss::into_block<M>(s1);
  row[2 * in_bits] = make_int4(0, 0, 0, 0);
  row[2 * in_bits + 1] = make_int4((int)s1[0], (int)s1[1], (int)s1[2],
                                   (int)s1[3]);
}

}  // namespace

// seeds: [B, 2, 4]; alphas: lanes of key k at alphas[k * a_ks] (a_ks = 1
// for [B] with in_bits <= 32, 4 for [B, 4]); betas: [B, 4] (clamped bit
// ignored). cws: [B, in_bits+1, 8] wire rows, every word written.
// mode: fss::Mode of the group; mask0..3 and mod0..3: fss::Group.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 4 keys).
extern "C" int fss_dcf_gen(const void* seeds, const void* alphas,
                           int64_t a_ks, const void* betas, void* cws,
                           int64_t batch, int in_bits, int pred_lt, int mode,
                           uint32_t mask0, uint32_t mask1, uint32_t mask2,
                           uint32_t mask3, uint32_t mod0, uint32_t mod1,
                           uint32_t mod2, uint32_t mod3, const void* prg,
                           void* stream) {
  if (batch <= 0) return 0;
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  const int threads = 128;
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<4>(prg, [&](auto p) {
#define FSS_DCF_GEN(M)                                                    \
  dcf_gen_kernel<M, decltype(p)><<<blocks, threads, 0, st>>>(            \
      (const uint32_t*)seeds, (const uint32_t*)alphas, a_ks,             \
      (const uint32_t*)betas, (int4*)cws, batch, in_bits, pred_lt, g, p)
    switch (mode) {
      case fss::kXor: FSS_DCF_GEN(fss::kXor); break;
      case fss::kWrap: FSS_DCF_GEN(fss::kWrap); break;
      case fss::kMod64: FSS_DCF_GEN(fss::kMod64); break;
      case fss::kMod128: FSS_DCF_GEN(fss::kMod128); break;
      case fss::kMod128np: FSS_DCF_GEN(fss::kMod128np); break;
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_DCF_GEN
    return (int)cudaGetLastError();
  });
}
