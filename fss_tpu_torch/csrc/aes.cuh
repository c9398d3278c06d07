// AES-128-MMO on the device: out = AES_k(seed) ^ seed, one block per thread,
// shared by every kernel that runs the AES PRG (through prg.cuh).
//
// Device counterpart of fss_tpu_torch/prg/aes.py, and of the T-table form
// of fss_tpu/prg/aes.py (the reference's aes128_mmo_soft.cuh): 9 rounds of
// 16 Te0 lookups with the rotations, then the S-box round, on big-endian
// state words. The seed's lanes are little-endian; rather than byte-swap
// them in and out, the first and last round keys come byte-swapped
// (AesPrg::from, prg.cuh), the first round indexes the swapped state's
// bytes in the other order and the last round assembles its bytes swapped.
// The round keys are kernel parameters and the rounds fully unrolled, so
// every state word and round-key index is a compile-time constant, the
// state stays in registers and each round key is a constant-bank operand.
//
// The tables live in shared memory. Every thread of a block takes part in
// filling them (fill) before any thread leaves, so kernels call prg.init()
// before their `if (k >= batch) return;`. The final round takes S[i] from
// byte 1 of Te0[i], so there is no S-box table. A warp's 32 random indices
// into one 256-word table would meet ~3-4 ways of bank conflict a lookup,
// so each lane reads its own copy. The layout is a template parameter of
// AesPrg, AesTables<COPIES, TABLES>, each kernel source's compile-time
// choice:
//
//   <32, 1>   32 copies of Te0 (32 KB): entry i of copy c at word
//             i * 32 + c, lane l reads copy l % 32. No conflicts.
//   <32, 2>   32 copies of Te0 and 32 of Te2 = rotr16(Te0) (64 KB): entry
//             i of table j for lane l at byte i * 256 + (32 j + l) * 4. A
//             lookup's address is one PRMT (the state byte into byte 1,
//             the lane's offset into byte 0), and a round word takes one
//             rotation, not three: Te0[a] ^ Te2[c] ^ k ^ rotr8(Te0[b] ^
//             Te2[d]). No conflicts.
//
// Copies live at the front of the kernel's dynamic shared memory (kBytes;
// prg.cuh's kPrgSmem, which every launch adds), filled from the single
// static table. Cost of one block (the model of chip_smoke.py's bounds,
// AES_LDS and AES_ALU, counts the work): 160 lookups, 16 in each of the 9
// T-table rounds and 16 in the last. Per lookup an address of two ALU ops
// (a shift and a LOP3 that masks the byte and ORs the lane's offset), or
// one PRMT with <32, 2>; per round word 3 rotations (1 with <32, 2>) and
// the XORs of 4 entries and the key (two LOP3, three with <32, 2>); the
// last round's bytes join in 3 PRMTs and one LOP3 folds in the key and
// the seed.

#pragma once

#include <cuda_runtime.h>

#include <cstdint>

namespace fss {

__device__ const uint8_t kAesSbox[256] = {
    0x63, 0x7c, 0x77, 0x7b, 0xf2, 0x6b, 0x6f, 0xc5, 0x30, 0x01, 0x67, 0x2b,
    0xfe, 0xd7, 0xab, 0x76, 0xca, 0x82, 0xc9, 0x7d, 0xfa, 0x59, 0x47, 0xf0,
    0xad, 0xd4, 0xa2, 0xaf, 0x9c, 0xa4, 0x72, 0xc0, 0xb7, 0xfd, 0x93, 0x26,
    0x36, 0x3f, 0xf7, 0xcc, 0x34, 0xa5, 0xe5, 0xf1, 0x71, 0xd8, 0x31, 0x15,
    0x04, 0xc7, 0x23, 0xc3, 0x18, 0x96, 0x05, 0x9a, 0x07, 0x12, 0x80, 0xe2,
    0xeb, 0x27, 0xb2, 0x75, 0x09, 0x83, 0x2c, 0x1a, 0x1b, 0x6e, 0x5a, 0xa0,
    0x52, 0x3b, 0xd6, 0xb3, 0x29, 0xe3, 0x2f, 0x84, 0x53, 0xd1, 0x00, 0xed,
    0x20, 0xfc, 0xb1, 0x5b, 0x6a, 0xcb, 0xbe, 0x39, 0x4a, 0x4c, 0x58, 0xcf,
    0xd0, 0xef, 0xaa, 0xfb, 0x43, 0x4d, 0x33, 0x85, 0x45, 0xf9, 0x02, 0x7f,
    0x50, 0x3c, 0x9f, 0xa8, 0x51, 0xa3, 0x40, 0x8f, 0x92, 0x9d, 0x38, 0xf5,
    0xbc, 0xb6, 0xda, 0x21, 0x10, 0xff, 0xf3, 0xd2, 0xcd, 0x0c, 0x13, 0xec,
    0x5f, 0x97, 0x44, 0x17, 0xc4, 0xa7, 0x7e, 0x3d, 0x64, 0x5d, 0x19, 0x73,
    0x60, 0x81, 0x4f, 0xdc, 0x22, 0x2a, 0x90, 0x88, 0x46, 0xee, 0xb8, 0x14,
    0xde, 0x5e, 0x0b, 0xdb, 0xe0, 0x32, 0x3a, 0x0a, 0x49, 0x06, 0x24, 0x5c,
    0xc2, 0xd3, 0xac, 0x62, 0x91, 0x95, 0xe4, 0x79, 0xe7, 0xc8, 0x37, 0x6d,
    0x8d, 0xd5, 0x4e, 0xa9, 0x6c, 0x56, 0xf4, 0xea, 0x65, 0x7a, 0xae, 0x08,
    0xba, 0x78, 0x25, 0x2e, 0x1c, 0xa6, 0xb4, 0xc6, 0xe8, 0xdd, 0x74, 0x1f,
    0x4b, 0xbd, 0x8b, 0x8a, 0x70, 0x3e, 0xb5, 0x66, 0x48, 0x03, 0xf6, 0x0e,
    0x61, 0x35, 0x57, 0xb9, 0x86, 0xc1, 0x1d, 0x9e, 0xe1, 0xf8, 0x98, 0x11,
    0x69, 0xd9, 0x8e, 0x94, 0x9b, 0x1e, 0x87, 0xe9, 0xce, 0x55, 0x28, 0xdf,
    0x8c, 0xa1, 0x89, 0x0d, 0xbf, 0xe6, 0x42, 0x68, 0x41, 0x99, 0x2d, 0x0f,
    0xb0, 0x54, 0xbb, 0x16};

// Te0[i] = (2 S[i], S[i], S[i], 3 S[i]) of AES's T-table form.
__device__ __forceinline__ uint32_t aes_te0_entry(int i) {
  const uint32_t s = kAesSbox[i];
  const uint32_t x2 = ((s << 1) ^ ((s >> 7) * 0x1Bu)) & 0xFFu;
  return (x2 << 24) | (s << 16) | (s << 8) | (s ^ x2);
}

__device__ __forceinline__ uint32_t aes_rotr(uint32_t x, int n) {
  return __funnelshift_r(x, x, n);
}

// The single table, which the copies are filled from.
__shared__ uint32_t aes_te0[256];
// The copies: the front of the kernel's dynamic shared memory.
extern __shared__ uint4 aes_smem[];

template <int COPIES, int TABLES>
struct AesTables {
  static_assert(COPIES == 32 && (TABLES == 1 || TABLES == 2),
                "AesTables: <32, 1> or <32, 2>");
  static constexpr int kTables = TABLES;
  // log2 of the bytes between entries i and i + 1 of a table.
  static constexpr int kShift = TABLES == 1 ? 7 : 8;
  // Dynamic shared memory the tables take.
  static constexpr int kBytes = 256 << kShift;

  // Every thread of the block, then a barrier: the single table, then the
  // copies from it, neighbouring threads storing neighbouring 16 bytes.
  __device__ static void fill() {
    for (int i = threadIdx.x; i < 256; i += blockDim.x)
      aes_te0[i] = aes_te0_entry(i);
    __syncthreads();
    constexpr int kVecs = COPIES * TABLES / 4;  // 16-byte stores an entry
#pragma unroll 4
    for (int j = threadIdx.x; j < 256 * kVecs; j += blockDim.x) {
      const uint32_t e = aes_te0[j / kVecs];
      const uint32_t v = (j % kVecs) * 4 < COPIES ? e : aes_rotr(e, 16);
      aes_smem[j] = make_uint4(v, v, v, v);
    }
    __syncthreads();
  }

  // This thread's byte offset into table j (0: Te0, 1: Te2).
  __device__ static uint32_t offset(int j) {
    return ((threadIdx.x % COPIES) + j * COPIES) * 4u;
  }

  // The entry of byte K of x, in the table at this thread's offset `off`.
  template <int K>
  __device__ static uint32_t load(uint32_t x, uint32_t off) {
    uint32_t a;
    if constexpr (TABLES == 2) {
      a = __byte_perm(x, off, 0x5504 | (K << 4));
    } else if constexpr (K > 0) {
      a = ((x >> (8 * K - kShift)) & (0xFFu << kShift)) | off;
    } else {
      a = ((x << kShift) & (0xFFu << kShift)) | off;
    }
    return *reinterpret_cast<const uint32_t*>(
        reinterpret_cast<const char*>(aes_smem) + a);
  }
};

// One T-table round's output word from state words a, b, c, d and round key
// k: bytes A, B, C, D of them index it (3, 2, 1, 0 for big-endian words;
// 0, 1, 2, 3 for the byte-swapped words of the first round).
template <class T, int A, int B, int C, int D>
__device__ __forceinline__ uint32_t aes_t_word(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               uint32_t k, uint32_t off0,
                                               uint32_t off2) {
  if constexpr (T::kTables == 2) {
    return T::template load<A>(a, off0) ^ T::template load<C>(c, off2) ^ k ^
           aes_rotr(T::template load<B>(b, off0) ^
                        T::template load<D>(d, off2),
                    8);
  } else {
    return T::template load<A>(a, off0) ^
           aes_rotr(T::template load<B>(b, off0), 8) ^
           aes_rotr(T::template load<C>(c, off0), 16) ^
           aes_rotr(T::template load<D>(d, off0), 24) ^ k;
  }
}

// The final round's word (SubBytes, ShiftRows), its bytes assembled in the
// seed's order, XORed with the byte-swapped round key k and the seed word x.
template <class T>
__device__ __forceinline__ uint32_t aes_s_word(uint32_t a, uint32_t b,
                                               uint32_t c, uint32_t d,
                                               uint32_t k, uint32_t x,
                                               uint32_t off0) {
  const uint32_t lo = __byte_perm(T::template load<3>(a, off0),
                                  T::template load<2>(b, off0), 0x0051);
  const uint32_t hi = __byte_perm(T::template load<1>(c, off0),
                                  T::template load<0>(d, off0), 0x5100);
  return __byte_perm(lo, hi, 0x7610) ^ k ^ x;
}

// out = AES_rk(seed) ^ seed over the seed's 4 lanes; rk: the 44 big-endian
// round-key words, words 0-3 and 40-43 byte-swapped. `out` may alias `seed`.
// Only the first kOut words are computed: the last round's lookups of the
// others are skipped (4 lookups a word; the Feistel PRP's wide halves keep
// two).
template <class T, int kOut = 4>
__device__ __forceinline__ void aes_mmo(const uint32_t (&rk)[44],
                                        const uint32_t seed[4],
                                        uint32_t out[kOut]) {
  static_assert(kOut >= 1 && kOut <= 4, "aes_mmo: 1 to 4 output words");
  const uint32_t off0 = T::offset(0), off2 = T::offset(1);
  const uint32_t x0 = seed[0], x1 = seed[1], x2 = seed[2], x3 = seed[3];
  uint32_t s0 = x0 ^ rk[0], s1 = x1 ^ rk[1], s2 = x2 ^ rk[2], s3 = x3 ^ rk[3];
  uint32_t t0 = aes_t_word<T, 0, 1, 2, 3>(s0, s1, s2, s3, rk[4], off0, off2);
  uint32_t t1 = aes_t_word<T, 0, 1, 2, 3>(s1, s2, s3, s0, rk[5], off0, off2);
  uint32_t t2 = aes_t_word<T, 0, 1, 2, 3>(s2, s3, s0, s1, rk[6], off0, off2);
  uint32_t t3 = aes_t_word<T, 0, 1, 2, 3>(s3, s0, s1, s2, rk[7], off0, off2);
  s0 = t0; s1 = t1; s2 = t2; s3 = t3;
#pragma unroll
  for (int r = 2; r < 10; ++r) {
    t0 = aes_t_word<T, 3, 2, 1, 0>(s0, s1, s2, s3, rk[4 * r], off0, off2);
    t1 = aes_t_word<T, 3, 2, 1, 0>(s1, s2, s3, s0, rk[4 * r + 1], off0, off2);
    t2 = aes_t_word<T, 3, 2, 1, 0>(s2, s3, s0, s1, rk[4 * r + 2], off0, off2);
    t3 = aes_t_word<T, 3, 2, 1, 0>(s3, s0, s1, s2, rk[4 * r + 3], off0, off2);
    s0 = t0; s1 = t1; s2 = t2; s3 = t3;
  }
  out[0] = aes_s_word<T>(s0, s1, s2, s3, rk[40], x0, off0);
  if constexpr (kOut > 1)
    out[1] = aes_s_word<T>(s1, s2, s3, s0, rk[41], x1, off0);
  if constexpr (kOut > 2)
    out[2] = aes_s_word<T>(s2, s3, s0, s1, rk[42], x2, off0);
  if constexpr (kOut > 3)
    out[3] = aes_s_word<T>(s3, s0, s1, s2, rk[43], x3, off0);
}

}  // namespace fss
