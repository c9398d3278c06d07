// Batched BGI DPF key generation: one thread per key runs both parties'
// seeds down the path to alpha.
//
// Replaces fss_tpu/ops/dpf_pallas.py:gen_packed (_make_gen_kernel) with the
// ChaCha PRG and fss_tpu/ops/aes_pallas.py:gen_packed (_make_gen_kernel)
// with AES-128-MMO, as a template over the PRG (prg.cuh). Per level: two
// mul=2 expansions (one per party), the correction word is the XOR of the
// off-path siblings, tl_cw = t0l^t1l^a^1 and tr_cw = t0r^t1r^a, word 3 of
// the cw row carries s_cw3 | tl_cw and word 4 carries tr_cw; each party
// keeps its on-path child corrected under its own t. Unlike the TPU
// kernels, alpha may be 4 lanes (in_bits > 32): bit (in_bits-1-i) is read
// from lane (pos >> 5), as the eval kernel reads x.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. Two 960-op
// ChaCha blocks per level against 20..32 bytes of cw written; at 2^20 keys x 16
// levels, ~3.2e10 ops (~0.96 ms at 128 lanes x 132 SMs x 1.98 GHz) against
// ~0.4-0.6 GB (~0.15 ms at 3.35 TB/s). With AES: four blocks of 176
// shared-memory lookups a level (aes.cuh), ~1.2e10 LDS at 2^20 keys x 16 levels
// (~1.4 ms at 32 a clock x 132 SMs x 1.98 GHz before bank conflicts). Both
// seeds and both states stay in registers across levels. The cw is written
// either as wire rows [B, rows, 8] (two 16-byte stores per level, pad words
// and, with rows = n+1, the output row zeroed so the caller fills only the
// output cw; a VDPF key has rows = n and no output row) or as packed planes [n,
// 5, B], where neighbouring threads write neighbouring words.

#include <cuda_runtime.h>

#include "prg.cuh"

namespace {

template <class Prg>
__global__ void dpf_gen_kernel(const uint32_t* __restrict__ seeds,
                               const uint32_t* __restrict__ alphas,
                               int64_t a_ks, int32_t* __restrict__ cws,
                               int wire, int rows,
                               int4* __restrict__ s0_out,
                               int4* __restrict__ s1_out,
                               int32_t* __restrict__ t0_out,
                               int32_t* __restrict__ t1_out, int64_t batch,
                               int in_bits, const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t* sp = seeds + k * 8;
  uint32_t s0[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                    __ldg(sp + 3) & ~1u};
  uint32_t s1[4] = {__ldg(sp + 4), __ldg(sp + 5), __ldg(sp + 6),
                    __ldg(sp + 7) & ~1u};
  uint32_t t0 = 0u, t1 = 1u;
  const uint32_t* a = alphas + k * a_ks;
  int4* row = wire ? reinterpret_cast<int4*>(cws + k * rows * 8) : nullptr;

  for (int i = 0; i < in_bits; ++i) {
    uint32_t l0[4], r0[4], l1[4], r1[4];
    prg.expand2(s0, l0, r0);
    prg.expand2(s1, l1, r1);
    const uint32_t t0l = l0[3] & 1u, t0r = r0[3] & 1u;
    const uint32_t t1l = l1[3] & 1u, t1r = r1[3] & 1u;
    l0[3] &= ~1u; r0[3] &= ~1u; l1[3] &= ~1u; r1[3] &= ~1u;

    const int pos = in_bits - 1 - i;
    const uint32_t ab = (__ldg(a + (pos >> 5)) >> (pos & 31)) & 1u;
    uint32_t cw[4];
#pragma unroll
    for (int w = 0; w < 4; ++w) cw[w] = ab ? (l0[w] ^ l1[w]) : (r0[w] ^ r1[w]);
    const uint32_t tl_cw = t0l ^ t1l ^ ab ^ 1u;
    const uint32_t tr_cw = t0r ^ t1r ^ ab;

    if (wire) {
      row[2 * i] = make_int4((int)cw[0], (int)cw[1], (int)cw[2],
                             (int)(cw[3] | tl_cw));
      row[2 * i + 1] = make_int4((int)tr_cw, 0, 0, 0);
    } else {
      int32_t* plane = cws + (int64_t)i * 5 * batch + k;
      plane[0] = (int32_t)cw[0];
      plane[batch] = (int32_t)cw[1];
      plane[2 * batch] = (int32_t)cw[2];
      plane[3 * batch] = (int32_t)(cw[3] | tl_cw);
      plane[4 * batch] = (int32_t)tr_cw;
    }

    const uint32_t tcw = ab ? tr_cw : tl_cw;
    const uint32_t tm0 = 0u - t0, tm1 = 0u - t1;
#pragma unroll
    for (int w = 0; w < 4; ++w) {
      s0[w] = (ab ? r0[w] : l0[w]) ^ (cw[w] & tm0);
      s1[w] = (ab ? r1[w] : l1[w]) ^ (cw[w] & tm1);
    }
    t0 = (ab ? t0r : t0l) ^ (t0 & tcw);
    t1 = (ab ? t1r : t1l) ^ (t1 & tcw);
  }
  if (wire && rows > in_bits) {  // the output-cw row, filled by the caller
    row[2 * in_bits] = make_int4(0, 0, 0, 0);
    row[2 * in_bits + 1] = make_int4(0, 0, 0, 0);
  }
  s0_out[k] = make_int4((int)s0[0], (int)s0[1], (int)s0[2], (int)s0[3]);
  s1_out[k] = make_int4((int)s1[0], (int)s1[1], (int)s1[2], (int)s1[3]);
  t0_out[k] = (int32_t)t0;
  t1_out[k] = (int32_t)t1;
}

}  // namespace

// seeds: [B, 2, 4]; alphas: lanes of key k at alphas[k * a_ks] (a_ks = 1
// for [B] with in_bits <= 32, 4 for [B, 4]).
// cws: wire != 0 -> [B, rows, 8] with rows in_bits+1 (DPF) or in_bits
// (VDPF); wire == 0 -> planes [in_bits, 5, B].
// s0_out, s1_out: [B, 4] final seeds; t0_out, t1_out: [B] final t bits.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 2 keys).
extern "C" int fss_dpf_gen(const void* seeds, const void* alphas,
                           int64_t a_ks, void* cws, int wire, int rows,
                           void* s0_out,
                           void* s1_out, void* t0_out, void* t1_out,
                           int64_t batch, int in_bits, const void* prg,
                           void* stream) {
  if (batch <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (batch + threads - 1) / threads;
  return fss::with_prg<2>(prg, [&](auto p) {
    dpf_gen_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
        (const uint32_t*)seeds, (const uint32_t*)alphas, a_ks, (int32_t*)cws,
        wire, rows, (int4*)s0_out, (int4*)s1_out, (int32_t*)t0_out,
        (int32_t*)t1_out, batch, in_bits, p);
    return (int)cudaGetLastError();
  });
}
