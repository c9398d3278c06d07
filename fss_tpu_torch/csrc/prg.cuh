// The kernels' PRGs as template parameters: ChaChaPrg (chacha.cuh) and
// AesPrg<MUL, Tables> (aes.cuh). Each kernel is a template over the PRG type
// and calls:
//
//   prg.init()                 before any thread leaves: AES fills its
//                              shared tables (all threads, then a barrier);
//                              ChaCha does nothing;
//   prg.expand1(s, out)        the mul=1 block (the Half-Tree CCR hash);
//   prg.expand2(s, l, r)       the mul=2 pair (DPF, VDPF);
//   prg.expand4(s, o)          the mul=4 blocks (DCF).
//
// Outputs may alias the seed. A PRG object is a kernel parameter passed by
// value: ChaCha's nonce and rounds, or AES's MUL x 44 round-key words (704
// bytes at most), so a call allocates and copies nothing on the device.
// AES's table layout (aes.cuh: AesTables) is each source's compile-time
// choice: the tables take kPrgSmem bytes at the front of the kernel's
// dynamic shared memory, which every launch adds (launch_kernel, or by
// hand where the kernel has dynamic shared memory of its own).
//
// The host side of every extern "C" entry takes one `const void* prg`
// pointing at a PrgArg in host memory (fss_tpu_torch/_build.py:prg_arg)
// and picks the instantiation with with_prg<MUL, Tables>(prg, launch),
// where `launch` is a generic lambda that launches the kernel for the PRG
// object it is given.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

#include "aes.cuh"
#include "chacha.cuh"

namespace fss {

struct ChaChaPrg {
  uint32_t n0, n1;
  int rounds;

  __device__ __forceinline__ void init() const {}
  __device__ __forceinline__ void expand1(const uint32_t s[4],
                                          uint32_t out[4]) const {
    chacha1(s, n0, n1, rounds, out);
  }
  __device__ __forceinline__ void expand2(const uint32_t s[4], uint32_t l[4],
                                          uint32_t r[4]) const {
    chacha2(s, n0, n1, rounds, l, r);
  }
  __device__ __forceinline__ void expand4(const uint32_t s[4],
                                          uint32_t o[4][4]) const {
    chacha4(s, n0, n1, rounds, o);
  }
};

// The host's PRG argument (fss_tpu_torch/_build.py:prg_arg).
struct PrgArg {
  uint32_t kind;  // kPrgChaCha or kPrgAes
  uint32_t n0, n1, rounds;  // ChaCha
  uint32_t rk[4][44];       // AES: the first MUL keys' round keys
};
constexpr uint32_t kPrgChaCha = 0, kPrgAes = 1;

template <int MUL, class Tables>
struct AesPrg {
  // Big-endian round-key words of each key; words 0-3 and 40-43
  // byte-swapped (aes.cuh: aes_mmo).
  uint32_t rk[MUL][44];

  static AesPrg from(const PrgArg& a) {
    AesPrg p;
    for (int j = 0; j < MUL; ++j)
      for (int w = 0; w < 44; ++w)
        p.rk[j][w] = (w < 4 || w >= 40) ? __builtin_bswap32(a.rk[j][w])
                                        : a.rk[j][w];
    return p;
  }

  __device__ __forceinline__ void init() const { Tables::fill(); }
  __device__ __forceinline__ void expand1(const uint32_t s[4],
                                          uint32_t out[4]) const {
    aes_mmo<Tables>(rk[0], s, out);
  }
  __device__ __forceinline__ void expand2(const uint32_t s[4], uint32_t l[4],
                                          uint32_t r[4]) const {
    static_assert(MUL >= 2, "expand2 needs two keys");
    const uint32_t x[4] = {s[0], s[1], s[2], s[3]};
    aes_mmo<Tables>(rk[0], x, l);
    aes_mmo<Tables>(rk[1], x, r);
  }
  __device__ __forceinline__ void expand4(const uint32_t s[4],
                                          uint32_t o[4][4]) const {
    static_assert(MUL == 4, "expand4 needs four keys");
    const uint32_t x[4] = {s[0], s[1], s[2], s[3]};
#pragma unroll
    for (int j = 0; j < 4; ++j) aes_mmo<Tables>(rk[j], x, o[j]);
  }
};

// Bytes of dynamic shared memory the PRG's tables take at the front of a
// kernel's: 0 for ChaCha.
template <class Prg>
constexpr int kPrgSmem = 0;
template <int MUL, class T>
constexpr int kPrgSmem<AesPrg<MUL, T>> = T::kBytes;

// Lets `kernel` take `smem` bytes of dynamic shared memory where that is
// above the 48 KB default; returns the CUDA error.
template <class Kernel>
int allow_smem(Kernel kernel, size_t smem) {
  if (smem <= 48 * 1024) return 0;
  return (int)cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)smem);
}

// kernel<<<grid, block>>>(args...) with Prg's tables' dynamic shared memory
// (kPrgSmem) on `stream`; returns the launch's CUDA error.
template <class Prg, class... Params, class... Args>
int launch_kernel(void (*kernel)(Params...), unsigned grid, unsigned block,
                  cudaStream_t stream, Args... args) {
  const int rc = allow_smem(kernel, kPrgSmem<Prg>);
  if (rc != 0) return rc;
  kernel<<<grid, block, kPrgSmem<Prg>, stream>>>(args...);
  return (int)cudaGetLastError();
}

// Calls launch(prg object) with the PRG `arg` describes (AES with the table
// layout Tables) and returns what it returns, or cudaErrorInvalidValue for
// an unknown kind.
template <int MUL, class Tables, class Launch>
int with_prg(const void* arg, Launch&& launch) {
  const PrgArg& a = *static_cast<const PrgArg*>(arg);
  if (a.kind == kPrgChaCha) {
    return launch(ChaChaPrg{a.n0, a.n1, (int)a.rounds});
  }
  if (a.kind == kPrgAes) return launch(AesPrg<MUL, Tables>::from(a));
  return (int)cudaErrorInvalidValue;
}

}  // namespace fss
