// Batched DPF point evaluation: one thread per key walks every tree level
// in registers.
//
// Replaces fss_tpu/ops/dpf_pallas.py:eval_packed (_make_eval_kernel ->
// walk) with the ChaCha PRG, and fss_tpu/ops/aes_pallas.py:eval_packed
// (_make_eval_kernel) with AES-128-MMO: the kernel is a template over the
// PRG (prg.cuh). The walk itself is fss::dpf_walk (dpf_walk.cuh), shared
// with the fused VDPF eval kernel: per level the PRG's mul=2 pair, the
// control bits, the correction word under the mask (0 - t) and the child
// chosen by bit (in_bits-1-i) of x, read from lane (pos >> 5) so domains of
// 33..128 bits take x as 4 lanes.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch. A level
// is one 960-op ChaCha block plus ~20 ops of correction and selection,
// against 20 bytes of cw read; at 2^20 keys x 16 levels that is ~1.6e10 ops
// (~0.48 ms at 128 lanes x 132 SMs x 1.98 GHz) but ~0.38 GB (~0.11 ms at
// 3.35 TB/s). The design keeps the 16-word ChaCha state, the seed and t in
// registers for the whole walk so nothing but the key bytes touches
// memory, and rotates are single funnel shifts.
//
// With AES: shared-memory lookups. A level is two AES blocks of 160 table
// lookups (aes.cuh); at 2^20 keys x 16 levels that is ~5.4e9 LDS (~0.64 ms
// at 32 a clock x 132 SMs x 1.98 GHz with no bank conflicts, which the
// tables' layout, AesTables below, gives). The tables sit in shared
// memory, the round keys in the parameter space, the state in registers.
//
// The cw is addressed through three strides (level, word, key), so the same
// kernel streams wire rows [B, n+1, 8], packed planes [n, 5, B]
// (neighbouring threads read neighbouring words), or one broadcast key (key
// stride 0).

#include <cuda_runtime.h>

#include "dpf_walk.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

template <class Prg>
__global__ void dpf_eval_kernel(const uint32_t* __restrict__ seeds,
                                int64_t seed_ks,
                                const uint32_t* __restrict__ cws,
                                int64_t cw_ls, int64_t cw_ws, int64_t cw_ks,
                                const uint32_t* __restrict__ xs, int64_t x_ks,
                                int4* __restrict__ so,
                                int32_t* __restrict__ t_out, int64_t batch,
                                int in_bits, int party, const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t* sp = seeds + k * seed_ks;
  uint32_t s[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                   __ldg(sp + 3) & ~1u};
  const uint32_t t = fss::dpf_walk(prg, s, (uint32_t)party, cws + k * cw_ks,
                                   cw_ls, cw_ws, xs + k * x_ks, in_bits);
  so[k] = make_int4((int)s[0], (int)s[1], (int)s[2], (int)s[3]);
  t_out[k] = (int32_t)t;
}

}  // namespace

// seeds: [B, 4] (seed_ks = 4) or one broadcast seed (seed_ks = 0).
// cws: word w of level i of key k at cws[i * cw_ls + w * cw_ws + k * cw_ks].
// xs: x lanes of key k at xs[k * x_ks]; lane (pos >> 5) must exist.
// so: [B, 4] final seeds (clamped bit clear); t_out: [B] control bits.
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 2 keys).
extern "C" int fss_dpf_eval(const void* seeds, int64_t seed_ks,
                            const void* cws, int64_t cw_ls, int64_t cw_ws,
                            int64_t cw_ks, const void* xs, int64_t x_ks,
                            void* so, void* t_out, int64_t batch,
                            int in_bits, int party, const void* prg,
                            void* stream) {
  if (batch <= 0) return 0;
  const int threads = 128;
  const int64_t blocks = (batch + threads - 1) / threads;
  return fss::with_prg<2, AesTables>(prg, [&](auto p) {
    return fss::launch_kernel<decltype(p)>(
        dpf_eval_kernel<decltype(p)>, (unsigned)blocks, threads,
        (cudaStream_t)stream, (const uint32_t*)seeds, seed_ks,
        (const uint32_t*)cws, cw_ls, cw_ws, cw_ks, (const uint32_t*)xs, x_ks,
        (int4*)so, (int32_t*)t_out, batch, in_bits, party, p);
  });
}
