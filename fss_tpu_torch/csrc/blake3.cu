// Keyed BLAKE3 over a batch of rows: XorHash H (two compressions a row),
// H' (one compression a row), and the VDPF's flat proof chain.
//
// Replaces fss_tpu/ops/blake3_pallas.py: xor_hash_planes
// (_make_xor_hash_kernel) and hash64_batch (_make_hash64_kernel). The
// chain replaces the JAX package's lax.scan of H' (schemes/vdpf.py:prove),
// which is no Pallas kernel: 2^n dependent hashes, run here by one thread,
// as the reference runs it on one CPU thread.
//
// Bound on the H100: the card does ~10 32-bit ALU ops per byte of HBM
// traffic (3.35e13 ops/s over 3.35e12 B/s). A row of H is ~1,300 ALU
// instructions (two compressions of ~680 that share what the domain bit
// does not reach; chip_smoke.py:hash_alu counts them) against 32 bytes
// read and 64 written (13.5 a byte: ALU dispatch bounds it); a row of H'
// ~680 against 64 bytes read and 32 written (7 a byte: bytes bound it).
// One thread a row keeps the whole state and message in registers
// (blake3.cuh); a row's words are read as 32-bit loads (the inputs may be
// views at any 4-byte offset) and written as 16-byte stores. The IV is a
// kernel argument, copied to registers first: a new key needs no rebuild.

#include <cuda_runtime.h>

#include "blake3.cuh"

namespace {

struct Iv {
  uint32_t w[8];
};

__global__ void blake3_xor_hash_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       int4* __restrict__ out, int64_t n,
                                       Iv iv) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t av[4], bv[4], o[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    av[i] = __ldg(a + 4 * k + i);
    bv[i] = __ldg(b + 4 * k + i);
  }
  const Iv key = iv;
  fss::blake3_xor_hash(key.w, av, bv, o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[4 * k + i] = make_int4((int)o[4 * i], (int)o[4 * i + 1],
                               (int)o[4 * i + 2], (int)o[4 * i + 3]);
}

__global__ void blake3_hash64_kernel(const uint32_t* __restrict__ msg,
                                     int4* __restrict__ out, int64_t n,
                                     Iv iv) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  uint32_t m[16], o[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = __ldg(msg + 16 * k + i);
  const Iv key = iv;
  fss::blake3_compress(key.w, m, 64u, o);
  out[2 * k] = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
  out[2 * k + 1] = make_int4((int)o[4], (int)o[5], (int)o[6], (int)o[7]);
}

// pi = cs; for each row i: pi[0..7] ^= H'(pi ^ pts[i]). One thread.
__global__ void blake3_chain_kernel(const uint32_t* __restrict__ pts,
                                    const uint32_t* __restrict__ cs,
                                    uint32_t* __restrict__ out, int64_t n,
                                    Iv iv) {
  const Iv key = iv;
  uint32_t pi[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pi[i] = __ldg(cs + i);
  for (int64_t r = 0; r < n; ++r) {
    uint32_t m[16], h[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = pi[i] ^ __ldg(pts + 16 * r + i);
    fss::blake3_compress(key.w, m, 64u, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) pi[i] ^= h[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = pi[i];
}

Iv make_iv(uint32_t i0, uint32_t i1, uint32_t i2, uint32_t i3, uint32_t i4,
           uint32_t i5, uint32_t i6, uint32_t i7) {
  return Iv{{i0, i1, i2, i3, i4, i5, i6, i7}};
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// a, b: [n, 4] lanes; out: [n, 4, 4] (16 words a row).
extern "C" int fss_blake3_xor_hash(const void* a, const void* b, void* out,
                                   int64_t n, uint32_t i0, uint32_t i1,
                                   uint32_t i2, uint32_t i3, uint32_t i4,
                                   uint32_t i5, uint32_t i6, uint32_t i7,
                                   void* stream) {
  if (n <= 0) return 0;
  blake3_xor_hash_kernel<<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int4*)out, n,
      make_iv(i0, i1, i2, i3, i4, i5, i6, i7));
  return (int)cudaGetLastError();
}

// msg: [n, 4, 4] (16 words a row); out: [n, 2, 4].
extern "C" int fss_blake3_hash64(const void* msg, void* out, int64_t n,
                                 uint32_t i0, uint32_t i1, uint32_t i2,
                                 uint32_t i3, uint32_t i4, uint32_t i5,
                                 uint32_t i6, uint32_t i7, void* stream) {
  if (n <= 0) return 0;
  blake3_hash64_kernel<<<blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)msg, (int4*)out, n,
      make_iv(i0, i1, i2, i3, i4, i5, i6, i7));
  return (int)cudaGetLastError();
}

// pts: [n, 4, 4]; cs, out: [4, 4]. n may be 0 (out = cs).
extern "C" int fss_blake3_chain(const void* pts, const void* cs, void* out,
                                int64_t n, uint32_t i0, uint32_t i1,
                                uint32_t i2, uint32_t i3, uint32_t i4,
                                uint32_t i5, uint32_t i6, uint32_t i7,
                                void* stream) {
  blake3_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)cs, (uint32_t*)out, n,
      make_iv(i0, i1, i2, i3, i4, i5, i6, i7));
  return (int)cudaGetLastError();
}
