// Batched BGI DPF key generation: both parties' seeds run down the path to
// alpha, and the kernel ends with the group-typed output CW.
//
// Replaces fss_tpu/ops/dpf_pallas.py:gen_packed (_make_gen_kernel) with the
// ChaCha PRG and fss_tpu/ops/aes_pallas.py:gen_packed (_make_gen_kernel)
// with AES-128-MMO, as a template over the PRG (prg.cuh), and the output-CW
// glue after them (fss_tpu_torch/schemes/dpf.py:output_cw). Per level: two
// mul=2 expansions (one per party), the correction word is the XOR of the
// off-path siblings, tl_cw = t0l^t1l^a^1 and tr_cw = t0r^t1r^a, word 3 of
// the cw row carries s_cw3 | tl_cw and word 4 carries tr_cw; each party
// keeps its on-path child corrected under its own t. Given betas, the
// output CW is +-(beta - s0 + s1) in the group (group.cuh, the group kind a
// template parameter), negated when t1 is set, as schemes/dpf.py:output_cw
// computes it. Unlike the TPU kernels, alpha may be 4 lanes (in_bits > 32):
// bit (in_bits-1-i) is read from lane (pos >> 5), as the eval kernel reads
// x.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. Two 960-op
// ChaCha blocks per level against 20..32 bytes of cw written; at 2^20 keys x 16
// levels, ~3.2e10 ops (~0.96 ms at 128 lanes x 132 SMs x 1.98 GHz) against
// ~0.4-0.6 GB (~0.15 ms at 3.35 TB/s); one thread runs a key, both seeds and
// both states in registers. With AES: four blocks of 160 shared-memory
// lookups a level (aes.cuh), ~1.1e10 LDS at 2^20 keys x 16 levels (~1.3 ms at
// 32 a clock x 132 SMs x 1.98 GHz), which the tables' layout (AesTables
// below) keeps free of bank conflicts; two neighbouring lanes run a key, one
// party each (parties.cuh, kGenParties). The cw is written either as wire
// rows [B, rows, 8] (two 16-byte stores per level, pad words zeroed; with
// rows = n+1 the last row holds the output CW, or zeros without betas; a VDPF
// key has rows = n and no output row) or as packed planes [n, 5, B], where
// neighbouring keys write neighbouring words, and ocw [B, 4] (zeros without
// betas).

#include <cuda_runtime.h>

#include "group.cuh"
#include "parties.cuh"
#include "prg.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the
// measurements.
using AesTables = fss::AesTables<32, 2>;

template <int M, int P, class Prg>
__global__ void dpf_gen_kernel(const uint32_t* __restrict__ seeds,
                               const uint32_t* __restrict__ alphas,
                               int64_t a_ks,
                               const uint32_t* __restrict__ betas,
                               int32_t* __restrict__ cws,
                               int4* __restrict__ ocw, int wire, int rows,
                               int4* __restrict__ s0_out,
                               int4* __restrict__ s1_out,
                               int32_t* __restrict__ t0_out,
                               int32_t* __restrict__ t1_out, int64_t batch,
                               int in_bits, fss::Group g, const Prg prg) {
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
  const uint32_t* a = alphas + k * a_ks;
  int4* row = wire ? reinterpret_cast<int4*>(cws + k * rows * 8) : nullptr;

  for (int i = 0; i < in_bits; ++i) {
    uint32_t l[P][4], r[P][4], tl[P], tr[P];
#pragma unroll
    for (int p = 0; p < P; ++p) {
      prg.expand2(s[p], l[p], r[p]);
      tl[p] = l[p][3] & 1u;
      tr[p] = r[p][3] & 1u;
      l[p][3] &= ~1u;
      r[p][3] &= ~1u;
    }

    const int pos = in_bits - 1 - i;
    const uint32_t ab = (__ldg(a + (pos >> 5)) >> (pos & 31)) & 1u;
    uint32_t off[P][4], off0[4], off1[4], bits[P], bits0, bits1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int w = 0; w < 4; ++w) off[p][w] = ab ? l[p][w] : r[p][w];
      bits[p] = tl[p] | (tr[p] << 1);
    }
    q.both(off, off0, off1);
    q.both(bits, bits0, bits1);
    uint32_t cw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) cw[w] = off0[w] ^ off1[w];
    const uint32_t tl_cw = (bits0 ^ bits1 ^ ab ^ 1u) & 1u;
    const uint32_t tr_cw = ((bits0 ^ bits1) >> 1) ^ ab;

    if (wire) {
      if (q.stores(0))
        row[2 * i] = make_int4((int)cw[0], (int)cw[1], (int)cw[2],
                               (int)(cw[3] | tl_cw));
      if (q.stores(1)) row[2 * i + 1] = make_int4((int)tr_cw, 0, 0, 0);
    } else {
      int32_t* plane = cws + (int64_t)i * 5 * batch + k;
      if (q.stores(0)) {
        plane[0] = (int32_t)cw[0];
        plane[batch] = (int32_t)cw[1];
      }
      if (q.stores(1)) {
        plane[2 * batch] = (int32_t)cw[2];
        plane[3 * batch] = (int32_t)(cw[3] | tl_cw);
        plane[4 * batch] = (int32_t)tr_cw;
      }
    }

    const uint32_t tcw = ab ? tr_cw : tl_cw;
#pragma unroll
    for (int p = 0; p < P; ++p) {
      const uint32_t tm = 0u - t[p];
#pragma unroll
      for (int w = 0; w < 4; ++w)
        s[p][w] = (ab ? r[p][w] : l[p][w]) ^ (cw[w] & tm);
      t[p] = (ab ? tr[p] : tl[p]) ^ (t[p] & tcw);
    }
  }

  if (betas != nullptr) {
    // v = beta - s0 + s1 in the group, negated when t1.
    uint32_t f[P][4], f0[4], f1[4], t0, t1;
#pragma unroll
    for (int p = 0; p < P; ++p) {
#pragma unroll
      for (int w = 0; w < 4; ++w) f[p][w] = s[p][w];
      fss::from_block<M>(g, f[p]);
    }
    q.both(f, f0, f1);
    q.both(t, t0, t1);
    if (q.stores(0)) {
      const uint32_t* bp = betas + k * 4;
      uint32_t v[4] = {__ldg(bp), __ldg(bp + 1), __ldg(bp + 2),
                       __ldg(bp + 3) & ~1u};
      fss::from_block<M>(g, v);
      fss::gneg<M>(g, f0);
      fss::gadd<M>(g, v, f0);
      fss::gadd<M>(g, v, f1);
      if (t1) fss::gneg<M>(g, v);
      fss::into_block<M>(v);
      const int4 o = make_int4((int)v[0], (int)v[1], (int)v[2], (int)v[3]);
      if (wire) {
        row[2 * in_bits] = o;
      } else {
        ocw[k] = o;
      }
    }
    if (wire && q.stores(1)) row[2 * in_bits + 1] = make_int4(0, 0, 0, 0);
  } else if (!wire) {  // the output CW, zero
    if (q.stores(0)) ocw[k] = make_int4(0, 0, 0, 0);
  } else if (rows > in_bits) {  // the output-cw row, zero
    if (q.stores(0)) row[2 * in_bits] = make_int4(0, 0, 0, 0);
    if (q.stores(1)) row[2 * in_bits + 1] = make_int4(0, 0, 0, 0);
  }
#pragma unroll
  for (int p = 0; p < P; ++p) {
    const int4 o = make_int4((int)s[p][0], (int)s[p][1], (int)s[p][2],
                             (int)s[p][3]);
    if (q.party(p)) {
      s1_out[k] = o;
      t1_out[k] = (int32_t)t[p];
    } else {
      s0_out[k] = o;
      t0_out[k] = (int32_t)t[p];
    }
  }
}

}  // namespace

// seeds: [B, 2, 4]; alphas: lanes of key k at alphas[k * a_ks] (a_ks = 1
// for [B] with in_bits <= 32, 4 for [B, 4]).
// betas: [B, 4] (clamped bit ignored), or null for no output CW.
// cws: wire != 0 -> [B, rows, 8] with rows in_bits+1 (DPF; the last row the
// output CW, zero without betas) or in_bits (VDPF, no betas); wire == 0 ->
// planes [in_bits, 5, B], and the output CW into ocw [B, 4] (zero without
// betas).
// s0_out, s1_out: [B, 4] final seeds; t0_out, t1_out: [B] final t bits.
// mode: fss::Mode of the group; mask0..3 and mod0..3: fss::Group
// (ops/dcf_cuda.py:gen_params).
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 2 keys).
extern "C" int fss_dpf_gen(const void* seeds, const void* alphas,
                           int64_t a_ks, const void* betas, void* cws,
                           void* ocw, int wire, int rows, void* s0_out,
                           void* s1_out, void* t0_out, void* t1_out,
                           int64_t batch, int in_bits, int mode,
                           uint32_t mask0, uint32_t mask1, uint32_t mask2,
                           uint32_t mask3, uint32_t mod0, uint32_t mod1,
                           uint32_t mod2, uint32_t mod3, const void* prg,
                           void* stream) {
  if (batch <= 0) return 0;
  const fss::Group g = {{mask0, mask1, mask2, mask3}, {mod0, mod1, mod2, mod3}};
  cudaStream_t st = (cudaStream_t)stream;
  return fss::with_prg<2, AesTables>(prg, [&](auto p) {
    using Prg = decltype(p);
    constexpr int P = fss::kGenParties<Prg>, T = fss::kGenThreads<Prg>;
    const unsigned blocks = (unsigned)((batch * (2 / P) + T - 1) / T);
#define FSS_DPF_GEN(M)                                                      \
  return fss::launch_kernel<Prg>(                                           \
      dpf_gen_kernel<M, P, Prg>, blocks, T, st,                      \
      (const uint32_t*)seeds, (const uint32_t*)alphas, a_ks,                \
      (const uint32_t*)betas, (int32_t*)cws, (int4*)ocw, wire, rows,        \
      (int4*)s0_out, (int4*)s1_out, (int32_t*)t0_out, (int32_t*)t1_out,     \
      batch, in_bits, g, p)
    switch (mode) {
      case fss::kXor: FSS_DPF_GEN(fss::kXor);
      case fss::kWrap: FSS_DPF_GEN(fss::kWrap);
      case fss::kMod64: FSS_DPF_GEN(fss::kMod64);
      case fss::kMod128: FSS_DPF_GEN(fss::kMod128);
      case fss::kMod128np: FSS_DPF_GEN(fss::kMod128np);
      default: return (int)cudaErrorInvalidValue;
    }
#undef FSS_DPF_GEN
  });
}
