// Keyed SHA-256 over a batch of rows: XorHash H (two compressions a row),
// H' = SHA-256(key || msg) (two compressions a row), and the VDPF's flat
// proof chain of H'.
//
// The XorHash replaces fss_tpu/ops/sha256_pallas.py: xor_hash_planes
// (_make_xor_hash_kernel). H' is the counterpart of Sha256.hash64
// (fss_tpu/hash/sha256.py:144), which the JAX package runs as XLA and no
// Pallas kernel: the SHA-256 tree fold needs it on the card as one launch a
// level. The chain replaces the JAX package's lax.scan of H'
// (schemes/vdpf.py:prove): N dependent hashes.
//
// XorHash (sha256_xor_hash_kernel, B-12): one thread a row, bound by ALU
// issue (~2,400 instructions a row against 96 bytes), so only fewer
// instructions a row make it faster. It starts from the key's midstate
// (Sha256Key, as H' does), runs what the two compressions share once (the
// rounds and schedule words the domain bit does not reach:
// sha256.cuh:sha256_xor_hash_mid) and only then forks into lsb 0 and lsb
// 1. K[t] is a compile-time constant (sha256_k); the adds follow XorAdd
// and XorSchedAdd. vdpf_eval.cu keeps sha256_compress.
//
// H' (sha256_hash64_kernel): one thread a row, 128-thread CTAs, bound by
// instruction issue (~3,040 SASS instructions a row against 96 bytes). The
// key's work is launch constants (sha256.cuh: Sha256Key, computed on the
// host by the entry point), so block 1 starts at round 4 and the key's
// schedule terms are one add. The rounds' adds are IMADs on the FMA pipe
// (FmaAdd), the schedule's IADD3s (PlainAdd): of the mixes measured
// (scripts/torch_hash_variants.py) the fastest, ~2,060 ALU-pipe
// instructions a row against ~2,420 with IADD3s alone; every IMAD still
// costs issue time, so the FMA pipe is no free capacity. A row is read as
// four 16-byte loads when the input is 16-byte aligned (else 16 4-byte
// loads) and written as two 16-byte stores.
//
// The chain (sha256_chain_kernel): one CTA, a role a warp. pi[8..15] stays
// cs[8..15] for the whole fold, so of a step's work only block 1's W[4..11]
// = pi[0..7] ^ pt[0..7], what depends on them, and block 2's rounds wait on
// the last step; the rest is prepared ahead:
//   - the producers (warp kProducerWarp): lane l owns ring slot l (kRing
//     slots in shared memory) and fills it for rows l, l + kRing, ...: the
//     point's words 0..7 byte-swapped, K[t] + W[t] for block 1's t =
//     12..15, the sum of the point's and the key's terms of W[16..22] and
//     W[27..31], and all 64 K[t] + W[t] of block 2 (its message words are
//     cs[12..15] ^ pt[12..15] and the padding). A slot is handed over by a
//     full and an empty mbarrier;
//   - the helper (lane 0 of warp kHelperWarp): block 1's W[16..63] once the
//     chain lane has published the step's W[4..11], handed over as K[t] +
//     W[t] for t >= 16 + kSelfWords in kPieces pieces of 4 words, each
//     behind an mbarrier;
//   - the chain lane (lane 0 of warp 0): the rounds from the key's
//     midstate, W[16..16 + kSelfWords) itself (the helper starts when the
//     step does, so these would come late), the rest of block 1's schedule
//     from the helper, each piece asked for (mbar_test) three rounds before
//     it is needed, and block 2's from the ring.
// What bounds it: a lone warp issues about one instruction every two
// clocks, whichever pipe it goes to, so the chain lane's instruction count
// (~2,070 a row, 124 rounds x 14 of them) sets its pace, not its
// dependency chain; IADD3 adds (PlainAdd) are the fewest. The chain lane
// never reads device memory, and the ring is kRing slots whatever N is:
// the kernel needs no scratch in device memory.

#include <cuda_runtime.h>

#include <cstdint>

#include "ring.cuh"
#include "sha256.cuh"

namespace {

using fss::aligned16;
using fss::load4;
using fss::load_row;
using fss::mbar_arrive;
using fss::mbar_init;
using fss::mbar_test;
using fss::mbar_wait;
using fss::store4;

// The design's choices; scripts/torch_hash_variants.py patches copies.
constexpr bool kXorShared = true;    // B-12's compressions' prefix once
using XorAdd = fss::FmaAdd;          // B-12's round adds (sha256.cuh)
using XorSchedAdd = fss::PlainAdd;   // and its schedule's
constexpr int kXorThreads = 128;     // B-12's CTA
using H64Add = fss::FmaAdd;          // hash64's round adds (sha256.cuh)
using H64SchedAdd = fss::PlainAdd;   // and its schedule's
constexpr int kH64Threads = 128;     // sha256_hash64_kernel's CTA
constexpr int kH64Rows = 1;          // its rows a thread
using ChainAdd = fss::PlainAdd;      // the chain lane's and helper's adds
constexpr int kRing = 16;            // the chain's ring slots (<= 32)
constexpr bool kChainHelper = true;  // block 1's schedule on a helper lane
constexpr int kPieces = 10;          // the helper's hand-overs a row
constexpr int kHelperWarp = 1;       // the chain lane is warp 0's lane 0
constexpr int kProducerWarp = 2;
constexpr int kSelfWords = 8;        // W[16..] the chain lane computes itself

// B-12: one thread a row; rows as 16-byte loads where a and b are 16-byte
// aligned.
__device__ __forceinline__ void xor_hash_row(const fss::Sha256Key& key,
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[4],
                                             uint32_t (&o)[16]) {
  fss::sha256_xor_hash_mid<kXorShared>(key, a, b, o, XorAdd{key.one},
                                       XorSchedAdd{key.one});
}

template <bool kAligned>
__global__ void __launch_bounds__(kXorThreads)
    sha256_xor_hash_kernel(const uint32_t* __restrict__ a,
                           const uint32_t* __restrict__ b,
                           int4* __restrict__ out, int64_t n,
                           const __grid_constant__ fss::Sha256Key key) {
  const int64_t k = (int64_t)blockIdx.x * kXorThreads + threadIdx.x;
  if (k >= n) return;
  uint32_t av[4], bv[4], o[16];
  if constexpr (kAligned) {
    const uint4 qa = __ldg(reinterpret_cast<const uint4*>(a) + k);
    const uint4 qb = __ldg(reinterpret_cast<const uint4*>(b) + k);
    av[0] = qa.x, av[1] = qa.y, av[2] = qa.z, av[3] = qa.w;
    bv[0] = qb.x, bv[1] = qb.y, bv[2] = qb.z, bv[3] = qb.w;
  } else {
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      av[i] = __ldg(a + 4 * k + i);
      bv[i] = __ldg(b + 4 * k + i);
    }
  }
  xor_hash_row(key, av, bv, o);
#pragma unroll
  for (int i = 0; i < 4; ++i)
    out[4 * k + i] = make_int4((int)o[4 * i], (int)o[4 * i + 1],
                               (int)o[4 * i + 2], (int)o[4 * i + 3]);
}

template <bool kAligned>
__global__ void __launch_bounds__(kH64Threads)
    sha256_hash64_kernel(const uint32_t* __restrict__ msg,
                         int4* __restrict__ out, int64_t n,
                         const __grid_constant__ fss::Sha256Key key) {
  const int64_t base =
      ((int64_t)blockIdx.x * kH64Threads + threadIdx.x) * kH64Rows;
  if (base >= n) return;
  uint32_t m[kH64Rows][16], o[kH64Rows][8];
#pragma unroll
  for (int j = 0; j < kH64Rows; ++j)  // a row past the end reads the last
    load_row<kAligned>(msg + 16 * (base + j < n ? base + j : n - 1), m[j]);
#pragma unroll
  for (int j = 0; j < kH64Rows; ++j)
    fss::sha256_hash64_mid(key, m[j], o[j], H64Add{key.one},
                           H64SchedAdd{key.one});
#pragma unroll
  for (int j = 0; j < kH64Rows; ++j) {
    if (base + j < n) {
      out[2 * (base + j)] =
          make_int4((int)o[j][0], (int)o[j][1], (int)o[j][2], (int)o[j][3]);
      out[2 * (base + j) + 1] =
          make_int4((int)o[j][4], (int)o[j][5], (int)o[j][6], (int)o[j][7]);
    }
  }
}

// ---------------------------------------------------------------------------
// The chain.

constexpr int kChainThreads =
    32 * (1 + (kHelperWarp > kProducerWarp ? kHelperWarp : kProducerWarp));
// W[16..kOwn) on the chain lane, W[kOwn..63] from the helper.
constexpr int kOwn = kChainHelper ? 16 + kSelfWords : 64;
constexpr int kPieceWords = (64 - kOwn) / kPieces;
constexpr int kAsk = 3;  // rounds between asking for a piece and its use
static_assert(kHelperWarp > 0 && kProducerWarp > 0 &&
                  kHelperWarp != kProducerWarp,
              "one warp a role");
static_assert(kRing >= 1 && kRing <= 32, "a producer lane a slot");
static_assert(kSelfWords % 4 == 0 && kSelfWords < 48 &&
                  (48 - kSelfWords) % (4 * kPieces) == 0,
              "pieces of equal size, whole 16-byte rows");

// Whether block 1's word i does not depend on the chain: words 0..3 (the
// key) and 12..15 (cs[8..11] ^ pt[8..11]).
__host__ __device__ constexpr bool chain_free(int i) {
  return i < 4 || (i >= 12 && i < 16);
}

struct ChainFree {
  __device__ bool operator()(int i) const { return chain_free(i); }
};

// Index into Slot::q of W[t]'s chain-free sum, or -1 where it has none.
__host__ __device__ constexpr int q_index(int t) {
  return t >= 16 && t <= 22 ? t - 16 : t >= 27 && t <= 31 ? t - 20 : -1;
}

// What row r's step needs that does not depend on pi (rows of 16 bytes).
struct alignas(16) Slot {
  uint32_t pt[8];    // the point's lanes 0..7, byte-swapped
  uint32_t kw1[4];   // K[t] + W[t] of block 1, t = 12..15
  uint32_t q[12];    // chain-free terms of W[16..22] and W[27..31]
  uint32_t kw2[64];  // K[t] + W[t] of block 2
};

// The helper's hand-over of one step.
struct alignas(16) HelperBuf {
  uint32_t w[8];    // W[4..11], from the chain lane
  uint32_t kw[48];  // K[t] + W[t] of block 1, t = kOwn..63, from the helper
};

// Producer lane `lane` (< kRing): rows lane, lane + kRing, ... into slot
// `lane`, each after the chain lane released the slot's last use.
template <bool kAligned>
__device__ __forceinline__ void chain_producer(
    const uint32_t* __restrict__ pts, const uint32_t* __restrict__ cs,
    int64_t n, const fss::Sha256Key& key, Slot& slot, uint64_t* full,
    uint64_t* empty, int lane) {
  uint32_t c[8];  // cs[8..15]
#pragma unroll
  for (int i = 0; i < 8; ++i) c[i] = __ldg(cs + 8 + i);
  const fss::PlainAdd op{1u};
  uint32_t use = 0;
  for (int64_t r = lane; r < n; r += kRing, ++use) {
    if (use > 0) mbar_wait(empty, (use - 1) & 1);
    uint32_t p[16];
    load_row<kAligned>(pts + 16 * r, p);
    uint32_t b[16];  // block 1's window: W[0..3] the key, W[12..15]
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      b[i] = key.w[i];
      b[12 + i] = fss::bswap32(c[i] ^ p[8 + i]);
    }
    uint32_t row[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) row[i] = fss::bswap32(p[i]);
    store4(slot.pt, row);
    store4(slot.pt + 4, row + 4);
#pragma unroll
    for (int i = 0; i < 4; ++i) row[i] = b[12 + i] + fss::sha256_k(12 + i);
    store4(slot.kw1, row);
    uint32_t q[12];
#pragma unroll
    for (int t = 16; t < 32; ++t) {
      if (q_index(t) < 0) continue;
      uint32_t s = 0;
      if (chain_free(t - 16)) s += b[t - 16];
      if (chain_free(t - 7)) s += b[t - 7];
      if (chain_free(t - 15)) s += fss::sha256_sigma0(b[t - 15]);
      if (chain_free(t - 2)) s += fss::sha256_sigma1(b[t - 2]);
      q[q_index(t)] = s;
    }
#pragma unroll
    for (int i = 0; i < 12; i += 4) store4(slot.q + i, q + i);
    uint32_t x[4], w[16], kw[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) x[i] = fss::bswap32(c[4 + i] ^ p[12 + i]);
    fss::sha256_window80(w, x);
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      if (t >= 16) fss::sha256_schedule80(w, t, op);
      kw[t & 3] = w[t & 15] + fss::sha256_k(t);
      if ((t & 3) == 3) store4(slot.kw2 + t - 3, kw);
    }
    mbar_arrive(full);
  }
}

// The helper: block 1's W[16..63] of each step from the chain lane's
// W[4..11] and the slot's chain-free sums.
__device__ __forceinline__ void chain_helper(int64_t n, const Slot* ring,
                                             HelperBuf& hb, uint64_t* wbar,
                                             uint64_t* sbar, ChainAdd op) {
  for (int64_t r = 0; r < n; ++r) {
    const uint32_t parity = (uint32_t)(r & 1);
    mbar_wait(wbar, parity);
    const Slot& s = ring[r % kRing];
    uint32_t w[16] = {}, q[12], kw[4];
    load4(w + 4, hb.w);
    load4(w + 8, hb.w + 4);
#pragma unroll
    for (int i = 0; i < 12; i += 4) load4(q + i, s.q + i);
#pragma unroll
    for (int t = 16; t < 64; ++t) {
      fss::sha256_schedule(w, t, ChainFree{}, q_index(t) >= 0,
                           q_index(t) >= 0 ? q[q_index(t)] : 0u, op);
      if (t < kOwn) continue;
      kw[t & 3] = op.add(w[t & 15], fss::sha256_k(t));
      if ((t & 3) == 3) store4(hb.kw + t - 3 - kOwn, kw);
      if ((t - kOwn) % kPieceWords == kPieceWords - 1)
        mbar_arrive(sbar + (t - kOwn) / kPieceWords);
    }
  }
}

// The chain lane: pi = cs; for each row, pi[0..7] ^= H'(pi ^ pt).
__device__ __forceinline__ void chain_lane(const uint32_t* __restrict__ cs,
                                           uint32_t* __restrict__ out,
                                           int64_t n,
                                           const fss::Sha256Key& key,
                                           const Slot* ring, uint64_t* full,
                                           uint64_t* empty, HelperBuf& hb,
                                           uint64_t* wbar, uint64_t* sbar) {
  const ChainAdd op{key.one};
  uint32_t pib[8];  // pi[0..7], byte-swapped
#pragma unroll
  for (int i = 0; i < 8; ++i) pib[i] = fss::bswap32(__ldg(cs + i));
  for (int64_t r = 0; r < n; ++r) {
    const int slot_i = (int)(r % kRing);
    mbar_wait(full + slot_i, (uint32_t)((r / kRing) & 1));
    const Slot& s = ring[slot_i];
    uint32_t v[8], w[16] = {}, kw[4];
    auto round = [&](uint32_t k_plus_w) {
      fss::sha256_round(v, k_plus_w, op);
    };
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = key.mid[i];
    load4(w + 4, s.pt);
    load4(w + 8, s.pt + 4);
#pragma unroll
    for (int i = 0; i < 8; ++i) w[4 + i] ^= pib[i];
    if constexpr (kChainHelper) {
      store4(hb.w, w + 4);
      store4(hb.w + 4, w + 8);
      mbar_arrive(wbar);
    }
#pragma unroll
    for (int t = 4; t < 12; ++t) round(op.add(w[t], fss::sha256_k(t)));
    // Whether the helper's piece starting at round u is in, asked at the
    // end of round u - kAsk - 1.
    bool ready = false;
    auto ask = [&](int u) {
      if (kChainHelper && u >= kOwn && u < 64 && (u - kOwn) % kPieceWords == 0)
        ready = mbar_test(sbar + (u - kOwn) / kPieceWords, (uint32_t)(r & 1));
    };
    load4(kw, s.kw1);
#pragma unroll
    for (int t = 12; t < 16; ++t) {
      round(kw[t - 12]);
      ask(t + 1 + kAsk);
    }
    uint32_t q[12];
    if constexpr (kOwn > 16) {
#pragma unroll
      for (int i = 0; i < 12; i += 4) load4(q + i, s.q + i);
    }
#pragma unroll
    for (int t = 16; t < 64; ++t) {
      if (t < kOwn) {
        fss::sha256_schedule(w, t, ChainFree{}, q_index(t) >= 0,
                             q_index(t) >= 0 ? q[q_index(t)] : 0u, op);
        round(op.add(w[t & 15], fss::sha256_k(t)));
      } else {
        if ((t - kOwn) % kPieceWords == 0 && !ready)
          mbar_wait(sbar + (t - kOwn) / kPieceWords, (uint32_t)(r & 1));
        if ((t & 3) == 0) load4(kw, hb.kw + t - kOwn);
        round(kw[t & 3]);
      }
      ask(t + 1 + kAsk);
    }
    uint32_t st[8];
#pragma unroll
    for (int i = 0; i < 8; ++i) v[i] = st[i] = v[i] + fss::sha256_h0(i);
#pragma unroll
    for (int t = 0; t < 64; ++t) {
      if ((t & 3) == 0) load4(kw, s.kw2 + t);
      round(kw[t & 3]);
    }
    mbar_arrive(empty + slot_i);
#pragma unroll
    for (int i = 0; i < 8; ++i) pib[i] ^= op.add(st[i], v[i]);
  }
#pragma unroll
  for (int i = 0; i < 8; ++i) out[i] = fss::bswap32(pib[i]);
#pragma unroll
  for (int i = 8; i < 16; ++i) out[i] = __ldg(cs + i);
}

template <bool kAligned>
__global__ void __launch_bounds__(kChainThreads, 1)
    sha256_chain_kernel(const uint32_t* __restrict__ pts,
                        const uint32_t* __restrict__ cs,
                        uint32_t* __restrict__ out, int64_t n,
                        const __grid_constant__ fss::Sha256Key key) {
  __shared__ Slot ring[kRing];
  __shared__ HelperBuf hb;
  __shared__ uint64_t full[kRing], empty[kRing], wbar, sbar[kPieces];
  if (threadIdx.x == 0) {
    for (int i = 0; i < kRing; ++i) {
      mbar_init(full + i, 1);
      mbar_init(empty + i, 1);
    }
    mbar_init(&wbar, 1);
    for (int i = 0; i < kPieces; ++i) mbar_init(sbar + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
  }
  __syncthreads();
  const int warp = threadIdx.x / 32, lane = threadIdx.x % 32;
  if (warp == kProducerWarp) {
    if (lane < kRing)
      chain_producer<kAligned>(pts, cs, n, key, ring[lane], full + lane,
                               empty + lane, lane);
  } else if (warp == kHelperWarp) {
    if (kChainHelper && lane == 0)
      chain_helper(n, ring, hb, &wbar, sbar, ChainAdd{key.one});
  } else if (warp == 0 && lane == 0) {
    chain_lane(cs, out, n, key, ring, full, empty, hb, &wbar, sbar);
  }
}

}  // namespace

// a, b: [n, 4] lanes; out: [n, 4, 4] (16 words a row).
extern "C" int fss_sha256_xor_hash(const void* a, const void* b, void* out,
                                   int64_t n, uint32_t k0, uint32_t k1,
                                   uint32_t k2, uint32_t k3, void* stream) {
  if (n <= 0) return 0;
  const fss::Sha256Key key = fss::sha256_key(k0, k1, k2, k3);
  const unsigned blocks = (unsigned)((n + kXorThreads - 1) / kXorThreads);
  auto kernel = aligned16(a) && aligned16(b)
                    ? sha256_xor_hash_kernel<true>
                    : sha256_xor_hash_kernel<false>;
  kernel<<<blocks, kXorThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)a, (const uint32_t*)b, (int4*)out, n, key);
  return (int)cudaGetLastError();
}

// msg: [n, 4, 4] (16 words a row); out: [n, 2, 4].
extern "C" int fss_sha256_hash64(const void* msg, void* out, int64_t n,
                                 uint32_t k0, uint32_t k1, uint32_t k2,
                                 uint32_t k3, void* stream) {
  if (n <= 0) return 0;
  const fss::Sha256Key key = fss::sha256_key(k0, k1, k2, k3);
  const int64_t threads = (n + kH64Rows - 1) / kH64Rows;
  const unsigned blocks = (unsigned)((threads + kH64Threads - 1) /
                                     kH64Threads);
  auto kernel = aligned16(msg) ? sha256_hash64_kernel<true>
                               : sha256_hash64_kernel<false>;
  kernel<<<blocks, kH64Threads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)msg, (int4*)out, n, key);
  return (int)cudaGetLastError();
}

// pts: [n, 4, 4]; cs, out: [4, 4]. n may be 0 (out = cs).
extern "C" int fss_sha256_chain(const void* pts, const void* cs, void* out,
                                int64_t n, uint32_t k0, uint32_t k1,
                                uint32_t k2, uint32_t k3, void* stream) {
  const fss::Sha256Key key = fss::sha256_key(k0, k1, k2, k3);
  auto kernel = aligned16(pts) ? sha256_chain_kernel<true>
                               : sha256_chain_kernel<false>;
  kernel<<<1, kChainThreads, 0, (cudaStream_t)stream>>>(
      (const uint32_t*)pts, (const uint32_t*)cs, (uint32_t*)out, n, key);
  return (int)cudaGetLastError();
}
