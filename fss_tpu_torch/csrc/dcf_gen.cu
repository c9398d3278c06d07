// Batched DCF key generation (lt or gt): both parties' seeds run down the
// path to alpha, threading the group value.
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
// GB (~0.18 ms at 3.35 TB/s); one thread runs a key, both seeds, both ChaCha
// outputs and the running value in registers across levels. With AES: eight
// blocks of 160 shared-memory lookups a level, ~2.1e10 LDS (~2.6 ms at 32 a
// clock x 132 SMs x 1.98 GHz), which the tables' layout (AesTables below)
// keeps free of bank conflicts; the parties a thread runs are kGenParties
// (parties.cuh: with one, two neighbouring lanes run a key and trade the
// off-path seed, the off- and on-path values and the control bits; both
// compute the value CW and the running value). Each level's row goes out as
// two 16-byte stores.

#include <cuda_runtime.h>

#include "group.cuh"
#include "parties.cuh"
#include "prg.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the
// measurements.
using AesTables = fss::AesTables<32, 2>;

template <int M, int P, class Prg>
__global__ void dcf_gen_kernel(const uint32_t* __restrict__ seeds,
                               const uint32_t* __restrict__ alphas,
                               int64_t a_ks,
                               const uint32_t* __restrict__ betas,
                               int4* __restrict__ cws, int64_t batch,
                               int in_bits, int pred_lt, fss::Group g,
                               const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const auto q = fss::Parties<P>::of(
      (int64_t)blockIdx.x * blockDim.x + threadIdx.x, batch);
  const int64_t k = q.key;
  if (k >= batch) return;
  uint32_t s[P][4], t[P];
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const uint32_t* sp = seeds + k * 8 + 4 * q.party(p);
    s[p][0] = __ldg(sp);
    s[p][1] = __ldg(sp + 1);
    s[p][2] = __ldg(sp + 2);
    s[p][3] = __ldg(sp + 3) & ~1u;
    t[p] = (uint32_t)q.party(p);
  }
  const uint32_t* bp = betas + k * 4;
  uint32_t b[4] = {__ldg(bp), __ldg(bp + 1), __ldg(bp + 2),
                   __ldg(bp + 3) & ~1u};
  fss::from_block<M>(g, b);
  uint32_t v[4] = {0u, 0u, 0u, 0u};
  const uint32_t* a = alphas + k * a_ks;
  int4* row = cws + k * (in_bits + 1) * 2;

  for (int i = 0; i < in_bits; ++i) {
    // o[p]: (s_l, v_l, s_r, v_r) of this thread's p-th party.
    uint32_t o[P][4][4], tl[P], tr[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      prg.expand4(s[p], o[p]);
      tl[p] = o[p][0][3] & 1u;
      tr[p] = o[p][2][3] & 1u;
#pragma unroll
      for (int j = 0; j < 4; ++j) o[p][j][3] &= ~1u;
      fss::from_block<M>(g, o[p][1]);
      fss::from_block<M>(g, o[p][3]);
    }

    const int pos = in_bits - 1 - i;
    const uint32_t ab = (__ldg(a + (pos >> 5)) >> (pos & 31)) & 1u;
    // Each party's off-path seed and value, on-path value and bits
    // (tl, tr, t), then both parties' of each.
    uint32_t so[P][4], vo[P][4], vn[P][4], bits[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int w = 0; w < 4; ++w) {
        so[p][w] = ab ? o[p][0][w] : o[p][2][w];
        vo[p][w] = ab ? o[p][1][w] : o[p][3][w];
        vn[p][w] = ab ? o[p][3][w] : o[p][1][w];
      }
      bits[p] = tl[p] | (tr[p] << 1) | (t[p] << 2);
    }
    uint32_t so0[4], so1[4], vo0[4], vo1[4], vn0[4], vn1[4], bits0, bits1;
    q.both(so, so0, so1);
    q.both(vo, vo0, vo1);
    q.both(vn, vn0, vn1);
    q.both(bits, bits0, bits1);
    const uint32_t t1 = bits1 >> 2;
    uint32_t s_cw[4], v_cw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) s_cw[w] = so0[w] ^ so1[w];

    // v_cw = -v + v1_off - v0_off (+ beta), negated when t1.
#pragma unroll
    for (int w = 0; w < 4; ++w) v_cw[w] = v[w];
    fss::gneg<M>(g, v_cw);
    fss::gadd<M>(g, v_cw, vo1);
    fss::gneg<M>(g, vo0);
    fss::gadd<M>(g, v_cw, vo0);
    if (pred_lt ? ab : !ab) fss::gadd<M>(g, v_cw, b);
    if (t1) fss::gneg<M>(g, v_cw);

    // v += v0_on - v1_on +- v_cw.
    fss::gneg<M>(g, vn1);
    fss::gadd<M>(g, v, vn1);
    fss::gadd<M>(g, v, vn0);
    uint32_t tmp[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) tmp[w] = v_cw[w];
    if (t1) fss::gneg<M>(g, tmp);
    fss::gadd<M>(g, v, tmp);

    const uint32_t tl_cw = (bits0 ^ bits1 ^ ab ^ 1u) & 1u;
    const uint32_t tr_cw = (((bits0 ^ bits1) >> 1) ^ ab) & 1u;
    fss::into_block<M>(v_cw);
    if (q.stores(0))
      row[2 * i] = make_int4((int)s_cw[0], (int)s_cw[1], (int)s_cw[2],
                             (int)(s_cw[3] | tl_cw));
    if (q.stores(1))
      row[2 * i + 1] = make_int4((int)v_cw[0], (int)v_cw[1], (int)v_cw[2],
                                 (int)((v_cw[3] & ~1u) | tr_cw));

    const uint32_t tcw = ab ? tr_cw : tl_cw;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t tm = 0u - t[p];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        s[p][w] = (ab ? o[p][2][w] : o[p][0][w]) ^ (s_cw[w] & tm);
      t[p] = (ab ? tr[p] : tl[p]) ^ (t[p] & tcw);
    }
  }

  // v_cw_{n+1} = s1 - s0 - v, negated when t1.
  uint32_t f[P][4], f0[4], f1[4], t0, t1;
#pragma unroll
  for (int p = 0; p < P; ++p) {
#pragma unroll
    for (int w = 0; w < 4; ++w) f[p][w] = s[p][w];
    fss::from_block<M>(g, f[p]);
  }
  q.both(f, f0, f1);
  q.both(t, t0, t1);
  if (q.stores(0)) row[2 * in_bits] = make_int4(0, 0, 0, 0);
  if (q.stores(1)) {
    fss::gneg<M>(g, f0);
    fss::gadd<M>(g, f1, f0);
    fss::gneg<M>(g, v);
    fss::gadd<M>(g, f1, v);
    if (t1) fss::gneg<M>(g, f1);
    fss::into_block<M>(f1);
    row[2 * in_bits + 1] = make_int4((int)f1[0], (int)f1[1], (int)f1[2],
                                     (int)f1[3]);
  }
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
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<4, AesTables>(prg, [&](auto p) {
    using Prg = decltype(p);
    constexpr int P = fss::kGenParties<Prg>, T = fss::kGenThreads<Prg>;
    const unsigned blocks = (unsigned)((batch * (2 / P) + T - 1) / T);
#define FSS_DCF_GEN(M)                                                     \
  return fss::launch_kernel<Prg>(                                          \
      dcf_gen_kernel<M, P, Prg>, blocks, T, st,                     \
      (const uint32_t*)seeds, (const uint32_t*)alphas, a_ks,               \
      (const uint32_t*)betas, (int4*)cws, batch, in_bits, pred_lt, g, p)
    switch (mode) {
      case fss::kXor: FSS_DCF_GEN(fss::kXor);
      case fss::kWrap: FSS_DCF_GEN(fss::kWrap);
      case fss::kMod64: FSS_DCF_GEN(fss::kMod64);
      case fss::kMod128: FSS_DCF_GEN(fss::kMod128);
      case fss::kMod128np: FSS_DCF_GEN(fss::kMod128np);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_DCF_GEN
  });
}
