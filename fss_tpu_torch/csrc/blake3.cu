// Keyed BLAKE3 over a batch of rows: XorHash H (two compressions a row),
// H' (one compression a row), and the VDPF's flat proof chain.
//
// Replaces fss_tpu/ops/blake3_pallas.py: xor_hash_planes
// (_make_xor_hash_kernel) and hash64_batch (_make_hash64_kernel). The
// chain replaces the JAX package's lax.scan of H' (schemes/vdpf.py:prove),
// which is no Pallas kernel: 2^n dependent hashes.
//
// The chain (blake3_chain_kernel): one CTA of two warps, on the ring of
// ring.cuh. What the chain never changes is prepared ahead: the producers
// (warp kProducerWarp; lane l owns ring slot l of kRing and fills it for
// rows l, l + kRing, ...) write each point's pt[0..7] and cs[8..15] ^
// pt[8..15], so the chain lanes never read device memory. The chain
// lanes (lanes 0..kChainLanes - 1 of warp 0) split each compression as
// vectorised BLAKE implementations do: with four lanes, lane j runs column
// G j, then the diagonal G that holds b_j. Between the half-rounds the
// rows a, c and d rotate across the lanes (__shfl_sync, three independent
// shuffles each way); b, the last word a G writes and the first it reads,
// stays, and a, final five steps before b, moves first. A lane issues
// ~170 G instructions a row, not ~680, so the pace is the dependency path:
// 14 half-rounds of 12 dependent ALU instructions, plus the shuffles'
// latency and the row boundary. There lane j holds pi[j] and pi[4 + j]
// and the row's other words of column j; each lane takes the 28 message
// words it reads, in its own order, by shuffles from their holders and a
// select (kShflWords; else through a 64-byte hand-over in shared memory,
// each lane reading its 28 at offsets fixed per lane, within 2% of the
// shuffles: scripts/torch_hash_variants.py).
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
#include "ring.cuh"

namespace {

// The chain's design choices; scripts/torch_hash_variants.py patches
// copies.
constexpr int kChainLanes = 4;      // lanes a compression: 1, 2 or 4
constexpr int kRing = 8;            // the chain's ring slots (<= 32)
constexpr bool kShflWords = true;   // message words by __shfl_sync, else
                                    // through shared memory
constexpr int kProducerWarp = 1;    // the chain lanes are warp 0's

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

// ---------------------------------------------------------------------------
// The chain.

constexpr int kCols = 4 / kChainLanes;  // a chain lane's columns
constexpr uint32_t kLaneMask = (1u << kChainLanes) - 1u;
constexpr int kChainThreads = 32 * (kProducerWarp + 1);
static_assert(kChainLanes == 1 || kChainLanes == 2 || kChainLanes == 4,
              "a compression on 1, 2 or 4 lanes");
static_assert(kRing >= 1 && kRing <= 32, "a producer lane a slot");
static_assert(kProducerWarp > 0, "the chain lanes are warp 0's");
static_assert(!kShflWords || kChainLanes == 4,
              "the shuffle hand-over is written for one column a lane");

// The state's first words of each column c, as launch constants:
// v[c], v[4 + c], v[8 + c], v[12 + c] of iv | IV0 | 0, 0, 64, flags.
struct ChainIv {
  uint32_t v[16];
};

// m_r[p] = m_0[sigma(r, p)]: the message permutation applied r times.
__host__ __device__ constexpr int blake3_sigma(int r, int p) {
  constexpr int perm[16] = {2, 6, 3, 10, 7, 0, 4, 13,
                            1, 11, 12, 5, 9, 14, 15, 8};
  for (int i = 0; i < r; ++i) p = perm[p];
  return p;
}

// The same table, read by a lane whose column is known only at run time.
__constant__ uint8_t kSigma[7][16] = {
    {0, 1, 2, 3, 4, 5, 6, 7, 8, 9, 10, 11, 12, 13, 14, 15},
    {2, 6, 3, 10, 7, 0, 4, 13, 1, 11, 12, 5, 9, 14, 15, 8},
    {3, 4, 10, 12, 13, 2, 7, 14, 6, 5, 9, 0, 11, 15, 8, 1},
    {10, 7, 12, 9, 14, 3, 13, 15, 4, 0, 11, 2, 5, 8, 1, 6},
    {12, 13, 9, 11, 15, 10, 14, 8, 7, 2, 5, 3, 0, 1, 6, 4},
    {9, 14, 11, 5, 8, 12, 15, 1, 13, 3, 0, 10, 2, 6, 4, 7},
    {11, 15, 5, 0, 1, 9, 8, 6, 14, 10, 2, 12, 3, 4, 7, 13}};

// Message position of column c's e-th word of a round: its column G's two
// (e = 0, 1), then those of the diagonal G that holds b_c (e = 2, 3).
__host__ __device__ constexpr int msg_pos(int c, int e) {
  return e < 2 ? 2 * c + e : 8 + 2 * ((c + 3) & 3) + e - 2;
}

// The kinds (word >> 2) of the words the four columns read at (r, e):
// the shuffles the hand-over needs there.
__host__ __device__ constexpr int msg_kinds(int r, int e) {
  int k = 0;
  for (int c = 0; c < 4; ++c) k |= 1 << (blake3_sigma(r, msg_pos(c, e)) >> 2);
  return k;
}

// Where message word i sits in a slot and in the hand-over: by column,
// word 4k + c at 4c + k, so a lane's columns are 16 contiguous bytes each.
__host__ __device__ constexpr int by_column(int i) {
  return 4 * (i & 3) + (i >> 2);
}

// One row's chain-free words, by column (by_column): pt[0..7] and
// cs[8..15] ^ pt[8..15].
struct alignas(16) ChainSlot {
  uint32_t w[16];
};

// Rotates a state row across the lanes: slot q of lane h takes column
// hP + q + S (mod 4) of the row, P = kCols. Its holder is lane h + (q + S)
// / P, slot (q + S) % P: one __shfl_sync where that is another lane.
template <int S>
__device__ __forceinline__ void rotate(uint32_t (&x)[kCols], int h) {
  uint32_t y[kCols];
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int t = q + S, slot = t % kCols, delta = t / kCols;
    y[q] = delta % kChainLanes == 0
               ? x[slot]
               : __shfl_sync(kLaneMask, x[slot], h + delta, kChainLanes);
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) x[q] = y[q];
}

// The shuffle hand-over (kShflWords, one column a lane): message read I =
// 4r + e of the lane, m_0[sig], from its holder, lane sig & 3, which holds
// it as x[sig >> 2]: a shuffle for each kind some lane reads there (a
// compile-time set), then a select.
template <int I = 0>
__device__ __forceinline__ void shfl_words(uint32_t (&m)[7][kCols][4],
                                           const uint32_t (&x)[kCols][4],
                                           const int (&sig)[7][kCols][4]) {
  if constexpr (I < 28) {
    constexpr int r = I / 4, e = I % 4, kinds = msg_kinds(r, e);
    const int i = sig[r][0][e];
    uint32_t word = 0;
    bool first = true;
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      if (!(kinds >> k & 1)) continue;
      const uint32_t got = __shfl_sync(kLaneMask, x[0][k], i, 4);
      word = first || (i >> 2) == k ? got : word;
      first = false;
    }
    m[r][0][e] = word;
    shfl_words<I + 1>(m, x, sig);
  }
}

// Producer lane `lane` (< kRing): rows lane, lane + kRing, ... into slot
// `lane`, each after the chain lanes released the slot's last use.
template <bool kAligned>
__device__ __forceinline__ void chain_producer(
    const uint32_t* __restrict__ pts, const uint32_t* __restrict__ cs,
    int64_t n, ChainSlot& slot, uint64_t* full, uint64_t* empty, int lane) {
  uint32_t c[8];  // cs[8..15]
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = __ldg(cs + 8 + i);
  uint32_t use = 0;
  for (int64_t r = lane; r < n; r += kRing, ++use) {
    if (use > 0) fss::mbar_wait(empty, (use - 1) & 1);
    uint32_t p[16], w[16];
    fss::load_row<kAligned>(pts + 16 * r, p);
#pragma unroll
    for (int i = 0; i < 16; ++i)
      w[by_column(i)] = i < 8 ? p[i] : p[i] ^ c[i - 8];
#pragma unroll
    for (int i = 0; i < 16; i += 4) fss::store4(slot.w + i, w + i);
    fss::mbar_arrive(full);
  }
}

// The chain lanes (lanes 0..kChainLanes - 1 of warp 0; h the lane): pi =
// cs; for each row, pi[0..7] ^= H'(pi ^ pt). Lane h runs columns hP..hP +
// P - 1 (P = kCols) and holds their state words and pi[c], pi[4 + c].
__device__ __forceinline__ void chain_lanes(const uint32_t* __restrict__ cs,
                                            uint32_t* __restrict__ out,
                                            int64_t n, const ChainIv& iv,
                                            const ChainSlot* ring,
                                            uint64_t* full, uint64_t* empty,
                                            uint32_t* hand, int h) {
  uint32_t lo[kCols], hi[kCols];  // pi[c], pi[4 + c]
  uint32_t v0[4][kCols];          // the state's first words
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = kCols * h + q;
    lo[q] = __ldg(cs + c);
    hi[q] = __ldg(cs + 4 + c);
#pragma unroll
    for (int k = 0; k < 4; ++k) v0[k][q] = iv.v[4 * k + c];
  }
  // Where each of the lane's message reads finds its word m_0[i]: i itself
  // for the shuffles, else by_column(i) in the hand-over.
  int sig[7][kCols][4];
  if constexpr (kChainLanes > 1) {
#pragma unroll
    for (int r = 0; r < 7; ++r)
#pragma unroll
      for (int q = 0; q < kCols; ++q)
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int i = kSigma[r][msg_pos(kCols * h + q, e)];
          sig[r][q][e] = kShflWords ? i : by_column(i);
        }
  }
  int slot_i = 0;
  uint32_t phase = 0;
  for (int64_t r = 0; r < n; ++r) {
    fss::mbar_wait(full + slot_i, phase);
    const ChainSlot& s = ring[slot_i];
    // The row's message words m_0[i]: i < 8 pi[i] ^ pt[i], else cs[i] ^
    // pt[i]; each lane holds those of its columns, x[q][k] = m_0[4k + c].
    uint32_t x[kCols][4];
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      fss::load4(x[q], s.w + 4 * (kCols * h + q));
      x[q][0] ^= lo[q];
      x[q][1] ^= hi[q];
    }
    fss::mbar_arrive(empty + slot_i);
    if (++slot_i == kRing) slot_i = 0, phase ^= 1;
    uint32_t m[7][kCols][4];  // the words in the order the lane reads them
    uint32_t mm[16];          // kChainLanes == 1: m_r, permuted each round
    if constexpr (kChainLanes == 1) {
#pragma unroll
      for (int i = 0; i < 16; ++i) mm[i] = x[i & 3][i >> 2];
    } else if constexpr (kShflWords) {
      shfl_words(m, x, sig);
    } else {
      __syncwarp(kLaneMask);  // the last row's reads of hand are done
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        fss::store4(hand + 4 * (kCols * h + q), x[q]);
      __syncwarp(kLaneMask);
#pragma unroll
      for (int rr = 0; rr < 7; ++rr)
#pragma unroll
        for (int q = 0; q < kCols; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[rr][q][e] = hand[sig[rr][q][e]];
    }
    uint32_t a[kCols], b[kCols], c[kCols], d[kCols];
#pragma unroll
    for (int q = 0; q < kCols; ++q)
      a[q] = v0[0][q], b[q] = v0[1][q], c[q] = v0[2][q], d[q] = v0[3][q];
#pragma unroll
    for (int rr = 0; rr < 7; ++rr) {
      if constexpr (kChainLanes == 1) {
#pragma unroll
        for (int q = 0; q < 4; ++q)
#pragma unroll
          for (int e = 0; e < 4; ++e) m[rr][q][e] = mm[msg_pos(q, e)];
        fss::blake3_permute(mm);
      }
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        fss::blake3_g(a[q], b[q], c[q], d[q], m[rr][q][0], m[rr][q][1]);
      // Diagonalize around b, the last word a G writes and the first it
      // reads: a, c and d move, a (final 5 steps early) first.
      rotate<3>(a, h);
      rotate<2>(d, h);
      rotate<1>(c, h);
#pragma unroll
      for (int q = 0; q < kCols; ++q)
        fss::blake3_g(a[q], b[q], c[q], d[q], m[rr][q][2], m[rr][q][3]);
      rotate<1>(a, h);
      rotate<2>(d, h);
      rotate<3>(c, h);
    }
#pragma unroll
    for (int q = 0; q < kCols; ++q) {
      lo[q] ^= a[q] ^ c[q];
      hi[q] ^= b[q] ^ d[q];
    }
  }
#pragma unroll
  for (int q = 0; q < kCols; ++q) {
    const int c = kCols * h + q;
    out[c] = lo[q];
    out[4 + c] = hi[q];
    out[8 + c] = __ldg(cs + 8 + c);
    out[12 + c] = __ldg(cs + 12 + c);
  }
}

template <bool kAligned>
__global__ void __launch_bounds__(kChainThreads, 1)
    blake3_chain_kernel(const uint32_t* __restrict__ pts,
                        const uint32_t* __restrict__ cs,
                        uint32_t* __restrict__ out, int64_t n,
                        const __grid_constant__ ChainIv iv) {
  __shared__ ChainSlot ring[kRing];
  __shared__ uint64_t full[kRing], empty[kRing];
  __shared__ __align__(16) uint32_t hand[kShflWords ? 1 : 16];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      fss::mbar_init(full + i, 1);
      fss::mbar_init(empty + i, kChainLanes);
    }
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kProducerWarp) {
    if (lane < kRing)
      chain_producer<kAligned>(pts, cs, n, ring[lane], full + lane,
                               empty + lane, lane);
  } else if (warp == 0 && lane < kChainLanes) {
    chain_lanes(cs, out, n, iv, ring, full, empty, hand,
                kChainLanes == 1 ? 0 : lane);
  }
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
  const ChainIv iv{{i0, i1, i2, i3, i4, i5, i6, i7, 0x6A09E667u,
                    0xBB67AE85u, 0x3C6EF372u, 0xA54FF53Au, 0u, 0u, 64u,
                    fss::kBlake3Flags}};
  auto kernel = fss::aligned16(pts) ? blake3_chain_kernel<true>
                                    : blake3_chain_kernel<false>;
  kernel<<<1, kChainThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)cs, (uint32_t*)out, n, iv);
  return (int)cudaGetLastError();
}
