// Batched VDPF point evaluation: one thread per key walks the DPF tree and
// hashes (x, leaf seed) in registers.
//
// Replaces fss_tpu/ops/vdpf_pallas.py:fused_eval_packed
// (_make_fused_eval_kernel) with the ChaCha PRG and, with AES-128-MMO,
// fss_tpu/ops/aes_pallas.py:vdpf_eval_points (the AES walk chained with the
// XorHash): the walk is fss::dpf_walk (dpf_walk.cuh, the DPF eval kernel's
// own, a template over the PRG), and the leaf seed goes straight from registers
// into the XorHash H(x, s) = two compressions with lane 3's LSB of x as 0
// and 1. The hash is a template parameter: BLAKE3 (blake3.cuh, keyed with
// 8 IV words) or SHA-256 (sha256.cuh, keyed with 4 words). The outputs are
// those of the TPU kernel: the leaf seed, t and the raw pi [B, 16]; the
// t ? cs : 0 correction and the group finalize are torch glue, as in
// vdpf_pallas.eval_points.
//
// Bound on the H100 with ChaCha: 32-bit ALU instruction dispatch (with AES,
// the walk's 352 shared-memory lookups a level). At 16 levels a key
// does 16 x 960 ChaCha ops plus H's ~1,300 (BLAKE3) or ~2,400 (SHA-256)
// ALU instructions, against ~380 bytes of key, x and outputs. The walk's
// state is dead before the hash's starts, so the two share the registers;
// the key is read in place through strides (wire rows [B, n, 8], the
// VDPF's layout with no output row, or one broadcast key [n, 8]).

#include <cuda_runtime.h>

#include "blake3.cuh"
#include "dpf_walk.cuh"
#include "sha256.cuh"

namespace {

// The AES tables' layout (aes.cuh): PERF.md section 6 has the measurements.
using AesTables = fss::AesTables<32, 2>;

constexpr int kBlake3 = 0;
constexpr int kSha256 = 1;

struct HashKey {
  uint32_t w[8];  // BLAKE3: the IV; SHA-256: the key in w[0..3]
};

template <int kHash, class Prg>
__global__ void vdpf_eval_kernel(const uint32_t* __restrict__ seeds,
                                 int64_t seed_ks,
                                 const uint32_t* __restrict__ cws,
                                 int64_t cw_ks,
                                 const uint32_t* __restrict__ xs,
                                 int64_t x_ks, int4* __restrict__ so,
                                 int32_t* __restrict__ t_out,
                                 int4* __restrict__ pi, int64_t batch,
                                 int in_bits, int party, HashKey hk_arg,
                                 const Prg prg) {
  prg.init();  // before any thread leaves: AES fills its shared tables
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= batch) return;
  const uint32_t* sp = seeds + k * seed_ks;
  uint32_t s[4] = {__ldg(sp), __ldg(sp + 1), __ldg(sp + 2),
                   __ldg(sp + 3) & ~1u};
  const uint32_t* x = xs + k * x_ks;
  const uint32_t t = fss::dpf_walk(prg, s, (uint32_t)party, cws + k * cw_ks,
                                   8, 1, x, in_bits);
  so[k] = make_int4((int)s[0], (int)s[1], (int)s[2], (int)s[3]);
  t_out[k] = (int32_t)t;

  const HashKey hk = hk_arg;
  const uint32_t a[4] = {__ldg(x), x_ks == 4 ? __ldg(x + 1) : 0u,
                         x_ks == 4 ? __ldg(x + 2) : 0u,
                         x_ks == 4 ? __ldg(x + 3) : 0u};
  uint32_t o[16];
  if constexpr (kHash == kBlake3) {
    fss::blake3_xor_hash(hk.w, a, s, o);
  } else {
    fss::sha256_xor_hash(hk.w, a, s, o);
  }
#pragma unroll
  for (int i = 0; i < 4; ++i)
    pi[4 * k + i] = make_int4((int)o[4 * i], (int)o[4 * i + 1],
                              (int)o[4 * i + 2], (int)o[4 * i + 3]);
}

}  // namespace

// seeds: [B, 4] (seed_ks = 4) or one broadcast seed (seed_ks = 0).
// cws: wire rows [B, in_bits, 8] (cw_ks = in_bits * 8) or one broadcast key
// (cw_ks = 0). xs: [B] (x_ks = 1, lanes 1-3 zero) or [B, 4] lanes (x_ks =
// 4); lane (pos >> 5) must exist. hash: 0 BLAKE3 (h0..h7 the IV), 1
// SHA-256 (h0..h3 the key). so: [B, 4] leaf seeds (clamped bit clear);
// t_out: [B] control bits; pi: [B, 4, 4] raw H(x, s).
// prg: a host fss::PrgArg (ChaCha or AES-MMO with 2 keys).
extern "C" int fss_vdpf_eval(const void* seeds, int64_t seed_ks,
                             const void* cws, int64_t cw_ks, const void* xs,
                             int64_t x_ks, void* so, void* t_out, void* pi,
                             int64_t batch, int in_bits, int party, int hash,
                             uint32_t h0, uint32_t h1, uint32_t h2,
                             uint32_t h3, uint32_t h4, uint32_t h5,
                             uint32_t h6, uint32_t h7, const void* prg,
                             void* stream) {
  if (batch <= 0) return 0;
  if (hash != kBlake3 && hash != kSha256) return (int)cudaErrorInvalidValue;
  const int threads = 128;
  const unsigned blocks = (unsigned)((batch + threads - 1) / threads);
  const HashKey hk{{h0, h1, h2, h3, h4, h5, h6, h7}};
  return fss::with_prg<2, AesTables>(prg, [&](auto p) {
    using Prg = decltype(p);
    auto kernel = hash == kBlake3 ? vdpf_eval_kernel<kBlake3, Prg>
                                  : vdpf_eval_kernel<kSha256, Prg>;
    return fss::launch_kernel<Prg>(
        kernel, blocks, threads, (cudaStream_t)stream,
        (const uint32_t*)seeds, seed_ks, (const uint32_t*)cws, cw_ks,
        (const uint32_t*)xs, x_ks, (int4*)so, (int32_t*)t_out, (int4*)pi,
        batch, in_bits, party, hk, p);
  });
}
