// Keyed SHA-256 over a batch of rows: XorHash H (two compressions a row),
// H' = SHA-256(key || msg) (two compressions a row), and the VDPF's flat
// proof chain.
//
// The XorHash replaces fss_tpu/ops/sha256_pallas.py: xor_hash_planes
// (_make_xor_hash_kernel). H' is the counterpart of Sha256.hash64
// (fss_tpu/hash/sha256.py:144), which the JAX package runs as XLA and no
// Pallas kernel: the SHA-256 proof folds need it on the card as one launch
// a level, not thousands of small torch ops. The chain replaces the JAX
// package's lax.scan of H' (schemes/vdpf.py:prove): 2^n dependent hashes,
// run here by one thread, as the reference runs it on one CPU thread.
//
// Bound on the H100: 32-bit ALU instruction dispatch. A row of H is ~2,400
// instructions (two compressions that share the rounds before the domain
// bit) and a row of H' ~2,640 (two compressions), against 96 bytes of
// traffic (25-27 a byte, against the card's ~10; chip_smoke.py:hash_alu). One thread a row keeps the state and the
// 16-word schedule window in registers (sha256.cuh); lanes are read as
// 32-bit loads (the inputs may be views at any 4-byte offset) and written
// as 16-byte stores. The key is a kernel argument, copied to registers
// first: a new key needs no rebuild.

#include <cuda_runtime.h>

#include "sha256.cuh"

namespace {

struct Key {
  uint32_t w[4];
};

__global__ void sha256_xor_hash_kernel(const uint32_t* __restrict__ a,
                                       const uint32_t* __restrict__ b,
                                       int4* __restrict__ out, int64_t n,
                                       Key key_arg) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const Key key = key_arg;
  uint32_t av[4], bv[4], o[16];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    av[i] = __ldg(a + 4 * k + i);
    bv[i] = __ldg(b + 4 * k + i);
  }
  fss::sha256_xor_hash(key.w, av, bv, o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[4 * k + i] = make_int4((int)o[4 * i], (int)o[4 * i + 1],
                               (int)o[4 * i + 2], (int)o[4 * i + 3]);
}

__global__ void sha256_hash64_kernel(const uint32_t* __restrict__ msg,
                                     int4* __restrict__ out, int64_t n,
                                     Key key_arg) {
  const int64_t k = (int64_t)blockIdx.x * blockDim.x + threadIdx.x;
  if (k >= n) return;
  const Key key = key_arg;
  uint32_t m[16], o[8];
#pragma unroll
  for (int i = 0; i < 16; ++i) m[i] = __ldg(msg + 16 * k + i);
  fss::sha256_hash64(key.w, m, o);
  out[2 * k] = make_int4((int)o[0], (int)o[1], (int)o[2], (int)o[3]);
  out[2 * k + 1] = make_int4((int)o[4], (int)o[5], (int)o[6], (int)o[7]);
}

// pi = cs; for each row i: pi[0..7] ^= H'(pi ^ pts[i]). One thread.
__global__ void sha256_chain_kernel(const uint32_t* __restrict__ pts,
                                    const uint32_t* __restrict__ cs,
                                    uint32_t* __restrict__ out, int64_t n,
                                    Key key_arg) {
  const Key key = key_arg;
  uint32_t pi[16];
#pragma unroll
  for (int i = 0; i < 16; ++i) pi[i] = __ldg(cs + i);
  for (int64_t r = 0; r < n; ++r) {
    uint32_t m[16], h[8];
#pragma unroll
    for (int i = 0; i < 16; ++i) m[i] = pi[i] ^ __ldg(pts + 16 * r + i);
    fss::sha256_hash64(key.w, m, h);
#pragma unroll
    for (int i = 0; i < 8; ++i) pi[i] ^= h[i];
  }
#pragma unroll
  for (int i = 0; i < 16; ++i) out[i] = pi[i];
}

constexpr int kThreads = 128;

unsigned blocks_for(int64_t n) {
  return (unsigned)((n + kThreads - 1) / kThreads);
}

}  // namespace

// a, b: [n, 4] lanes; out: [n, 4, 4] (16 words a row).
extern "C" int fss_sha256_xor_hash(const void* a, const void* b, void* out,
                                   int64_t n, uint32_t k0, uint32_t k1,
                                   uint32_t k2, uint32_t k3, void* stream) {
  if (n <= 0) return 0;
  sha256_xor_hash_kernel<<<blocks_for(n), kThreads, 0,
                           (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int4*)out, n,
      Key{{k0, k1, k2, k3}});
  return (int)cudaGetLastError();
}

// msg: [n, 4, 4] (16 words a row); out: [n, 2, 4].
extern "C" int fss_sha256_hash64(const void* msg, void* out, int64_t n,
                                 uint32_t k0, uint32_t k1, uint32_t k2,
                                 uint32_t k3, void* stream) {
  if (n <= 0) return 0;
  sha256_hash64_kernel<<<blocks_for(n), kThreads, 0,
                         (cudaStream_t)stream>>>(
      (const uint32_t*)msg, (int4*)out, n, Key{{k0, k1, k2, k3}});
  return (int)cudaGetLastError();
}

// pts: [n, 4, 4]; cs, out: [4, 4]. n may be 0 (out = cs).
extern "C" int fss_sha256_chain(const void* pts, const void* cs, void* out,
                                int64_t n, uint32_t k0, uint32_t k1,
                                uint32_t k2, uint32_t k3, void* stream) {
  sha256_chain_kernel<<<1, 1, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)cs, (uint32_t*)out, n,
      Key{{k0, k1, k2, k3}});
  return (int)cudaGetLastError();
}
