// fss_tpu native host engine.
//
// C++ implementations of the host-side hot paths: the ChaCha and
// AES-128-MMO (AES-NI) PRGs, and DPF Gen / Eval / EvalAll with the Bytes
// and Uint output groups. Bit-exact with the JAX implementations (which
// are themselves semantics-parity with the reference CUDA library,
// include/fss/dpf.cuh + prg/chacha.cuh + prg/aes128_mmo_raw.cuh).
//
// Role in the TPU framework: dealer-side key generation on hosts without a
// TPU, an independent bit-exactness oracle for the device kernels, and
// CPU-benchmark parity with the reference's single-core numbers.
//
// Exposed as a plain C ABI; loaded from Python with ctypes
// (fss_tpu_torch/native/__init__.py), compiled on demand and cached — the same
// deploy shape as the reference's JIT-compiled torch extensions
// (fss_crypto/_jit.py).

#include <cstdint>
#include <cstring>
#include <random>
#include <utility>
#include <vector>

#if defined(__AES__) || defined(__x86_64__)
#include <immintrin.h>
#include <wmmintrin.h>
#define FSS_HAVE_AESNI 1
#else
#define FSS_HAVE_AESNI 0
#endif

// VAES-512: one vaesenc on a zmm advances FOUR AES blocks. Only compiled
// when the build host has vaes+avx512 (native/__init__.py probes
// /proc/cpuinfo and passes -DFSS_BUILD_VAES512); the engine is built
// per-host, so no runtime dispatch is needed beyond this.
#if defined(FSS_BUILD_VAES512) && defined(__VAES__) && \
    defined(__AVX512F__)
#define FSS_HAVE_VAES512 1
#else
#define FSS_HAVE_VAES512 0
#endif

namespace {

struct Block {
  uint32_t w[4];
};

inline Block bxor(const Block &a, const Block &b) {
  Block r;
  for (int i = 0; i < 4; ++i) r.w[i] = a.w[i] ^ b.w[i];
  return r;
}

inline uint32_t get_lsb(const Block &b) { return b.w[3] & 1u; }

inline Block set_lsb(Block b, uint32_t bit) {
  b.w[3] = (b.w[3] & ~1u) | (bit & 1u);
  return b;
}

// ---------------------------------------------------------------------------
// ChaCha PRG: the nonstandard single-block variant (prg/chacha.cuh):
// row0 = 16B/32B constant, rows 1-2 = seed twice, row3 = 0,0,nonce;
// feed-forward by XOR against the inputs, per-mul rows only.
// ---------------------------------------------------------------------------

inline uint32_t rotl32(uint32_t x, int n) {
  return (x << n) | (x >> (32 - n));
}

inline void quarter_round(uint32_t &a, uint32_t &b, uint32_t &c,
                          uint32_t &d) {
  a += b; d = rotl32(d ^ a, 16);
  c += d; b = rotl32(b ^ c, 12);
  a += b; d = rotl32(d ^ a, 8);
  c += d; b = rotl32(b ^ c, 7);
}

const uint32_t kConst16[4] = {0x61707865u, 0x3120646Eu, 0x79622D36u,
                              0x6B206574u};
const uint32_t kConst32[4] = {0x61707865u, 0x3320646Eu, 0x79622D32u,
                              0x6B206574u};

#if FSS_HAVE_AESNI
// Single-block ChaCha with the state rows in XMM registers: the column
// round works on whole rows (each lane is one column); the diagonal
// round shuffles rows 1-3 by 1/2/3 lanes and reuses it. 16/8-bit
// rotates ride pshufb. Same nonstandard feed-forward as the scalar path.
inline void chacha_qr_sse(__m128i &a, __m128i &b, __m128i &c, __m128i &d) {
  const __m128i rot16 = _mm_set_epi8(13, 12, 15, 14, 9, 8, 11, 10, 5, 4,
                                     7, 6, 1, 0, 3, 2);
  const __m128i rot8 = _mm_set_epi8(14, 13, 12, 15, 10, 9, 8, 11, 6, 5,
                                    4, 7, 2, 1, 0, 3);
  a = _mm_add_epi32(a, b);
  d = _mm_shuffle_epi8(_mm_xor_si128(d, a), rot16);
  c = _mm_add_epi32(c, d);
  b = _mm_xor_si128(b, c);
  b = _mm_or_si128(_mm_slli_epi32(b, 12), _mm_srli_epi32(b, 20));
  a = _mm_add_epi32(a, b);
  d = _mm_shuffle_epi8(_mm_xor_si128(d, a), rot8);
  c = _mm_add_epi32(c, d);
  b = _mm_xor_si128(b, c);
  b = _mm_or_si128(_mm_slli_epi32(b, 7), _mm_srli_epi32(b, 25));
}

void chacha_prg_sse(const Block &seed, const uint32_t nonce[2], int mul,
                    int rounds, Block out[]) {
  const uint32_t *cst = (mul <= 2) ? kConst16 : kConst32;
  const __m128i r0c = _mm_loadu_si128(
      reinterpret_cast<const __m128i *>(cst));
  const __m128i kv = _mm_loadu_si128(
      reinterpret_cast<const __m128i *>(seed.w));
  const __m128i r3c = _mm_set_epi32((int)nonce[1], (int)nonce[0], 0, 0);
  __m128i r0 = r0c, r1 = kv, r2 = kv, r3 = r3c;
  for (int r = 0; r < rounds / 2; ++r) {
    chacha_qr_sse(r0, r1, r2, r3);
    r1 = _mm_shuffle_epi32(r1, 0x39);  // rows 1-3 left by 1/2/3 lanes
    r2 = _mm_shuffle_epi32(r2, 0x4E);
    r3 = _mm_shuffle_epi32(r3, 0x93);
    chacha_qr_sse(r0, r1, r2, r3);
    r1 = _mm_shuffle_epi32(r1, 0x93);
    r2 = _mm_shuffle_epi32(r2, 0x4E);
    r3 = _mm_shuffle_epi32(r3, 0x39);
  }
  int idx = 0;
  if (mul >= 2) {
    _mm_storeu_si128(reinterpret_cast<__m128i *>(out[idx].w),
                     _mm_xor_si128(r0, r0c));
    ++idx;
  }
  _mm_storeu_si128(reinterpret_cast<__m128i *>(out[idx].w),
                   _mm_xor_si128(r1, kv));
  ++idx;
  if (mul == 4) {
    _mm_storeu_si128(reinterpret_cast<__m128i *>(out[idx].w),
                     _mm_xor_si128(r2, kv));
    ++idx;
    _mm_storeu_si128(reinterpret_cast<__m128i *>(out[idx].w),
                     _mm_xor_si128(r3, r3c));
  }
}
#endif  // FSS_HAVE_AESNI

void chacha_prg(const Block &seed, const uint32_t nonce[2], int mul,
                int rounds, Block out[/*mul*/]) {
#if FSS_HAVE_AESNI
  chacha_prg_sse(seed, nonce, mul, rounds, out);
  return;
#endif
  const uint32_t *cst = (mul <= 2) ? kConst16 : kConst32;
  uint32_t s[16];
  for (int i = 0; i < 4; ++i) s[i] = cst[i];
  for (int i = 0; i < 4; ++i) s[4 + i] = seed.w[i];
  for (int i = 0; i < 4; ++i) s[8 + i] = seed.w[i];
  s[12] = 0; s[13] = 0; s[14] = nonce[0]; s[15] = nonce[1];

  for (int r = 0; r < rounds / 2; ++r) {
    quarter_round(s[0], s[4], s[8], s[12]);
    quarter_round(s[1], s[5], s[9], s[13]);
    quarter_round(s[2], s[6], s[10], s[14]);
    quarter_round(s[3], s[7], s[11], s[15]);
    quarter_round(s[0], s[5], s[10], s[15]);
    quarter_round(s[1], s[6], s[11], s[12]);
    quarter_round(s[2], s[7], s[8], s[13]);
    quarter_round(s[3], s[4], s[9], s[14]);
  }

  // out index 0 = rows 4-7 ^ seed is the *second* output (out1 in the
  // reference ordering); follow the reference's output order exactly:
  // mul=1 -> {row4^seed}; mul=2 -> {row0^const, row4^seed};
  // mul=4 -> + {row8^seed, row12^{0,0,nonce}}.
  int idx = 0;
  if (mul >= 2) {
    for (int i = 0; i < 4; ++i) out[idx].w[i] = s[i] ^ cst[i];
    ++idx;
  }
  for (int i = 0; i < 4; ++i) out[idx].w[i] = s[4 + i] ^ seed.w[i];
  ++idx;
  if (mul == 4) {
    for (int i = 0; i < 4; ++i) out[idx].w[i] = s[8 + i] ^ seed.w[i];
    ++idx;
    out[idx].w[0] = s[12];
    out[idx].w[1] = s[13];
    out[idx].w[2] = s[14] ^ nonce[0];
    out[idx].w[3] = s[15] ^ nonce[1];
  }
}

// ---------------------------------------------------------------------------
// AES-128-MMO PRG via AES-NI: out_i = AES_{k_i}(seed) ^ seed.
// ---------------------------------------------------------------------------

#if FSS_HAVE_AESNI

template <int R>
inline __m128i key_assist(__m128i key) {
  __m128i t = _mm_aeskeygenassist_si128(key, R);
  t = _mm_shuffle_epi32(t, _MM_SHUFFLE(3, 3, 3, 3));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  key = _mm_xor_si128(key, _mm_slli_si128(key, 4));
  return _mm_xor_si128(key, t);
}

struct AesKeySchedule {
  __m128i rk[11];
};

void aes128_expand(const uint8_t key[16], AesKeySchedule &ks) {
  ks.rk[0] = _mm_loadu_si128(reinterpret_cast<const __m128i *>(key));
  ks.rk[1] = key_assist<0x01>(ks.rk[0]);
  ks.rk[2] = key_assist<0x02>(ks.rk[1]);
  ks.rk[3] = key_assist<0x04>(ks.rk[2]);
  ks.rk[4] = key_assist<0x08>(ks.rk[3]);
  ks.rk[5] = key_assist<0x10>(ks.rk[4]);
  ks.rk[6] = key_assist<0x20>(ks.rk[5]);
  ks.rk[7] = key_assist<0x40>(ks.rk[6]);
  ks.rk[8] = key_assist<0x80>(ks.rk[7]);
  ks.rk[9] = key_assist<0x1b>(ks.rk[8]);
  ks.rk[10] = key_assist<0x36>(ks.rk[9]);
}

inline __m128i aes128_encrypt(const AesKeySchedule &ks, __m128i block) {
  block = _mm_xor_si128(block, ks.rk[0]);
  for (int r = 1; r < 10; ++r) block = _mm_aesenc_si128(block, ks.rk[r]);
  return _mm_aesenclast_si128(block, ks.rk[10]);
}

void aes_mmo_prg(const AesKeySchedule *ks, int mul, const Block &seed,
                 Block out[]) {
  __m128i s = _mm_loadu_si128(reinterpret_cast<const __m128i *>(seed.w));
  for (int i = 0; i < mul; ++i) {
    __m128i e = aes128_encrypt(ks[i], s);
    _mm_storeu_si128(reinterpret_cast<__m128i *>(out[i].w),
                     _mm_xor_si128(e, s));
  }
}

#endif  // FSS_HAVE_AESNI

// ---------------------------------------------------------------------------
// PRG dispatch
// ---------------------------------------------------------------------------

struct Prg {
  int kind;  // 0 = chacha, 1 = aes128_mmo
  int mul;
  uint32_t nonce[2];
  int rounds;
#if FSS_HAVE_AESNI
  AesKeySchedule ks[4];
#endif

  void gen(const Block &seed, Block out[]) const {
    if (kind == 0) {
      chacha_prg(seed, nonce, mul, rounds, out);
    } else {
#if FSS_HAVE_AESNI
      aes_mmo_prg(ks, mul, seed, out);
#endif
    }
  }
};

// ---------------------------------------------------------------------------
// Output groups: kind 0 = bytes (XOR), 1 = uint<bits> wrapping,
// bits = 128 means Uint<u128, 2^127> (the only supported 128-bit mod).
// Values are unsigned __int128 built from little-endian lanes.
// ---------------------------------------------------------------------------

typedef unsigned __int128 u128;

struct Group {
  int kind;
  int bits;

  u128 mask() const {
    if (bits >= 128) return ~(u128)0 >> 1;  // 2^127 - 1
    return ((u128)1 << bits) - 1;
  }

  u128 from_block(const Block &b) const {
    u128 v = 0;
    for (int i = 3; i >= 0; --i) v = (v << 32) | b.w[i];
    if (kind == 0) return v;
    if (bits == 128) {
      // Clamped bit sits inside the encoding (group/uint.cuh:58-62).
      u128 hi = (u128)(b.w[3] >> 1) << 96;
      u128 lo = v & (((u128)1 << 96) - 1);
      return (hi | lo) & mask();
    }
    return v & mask();
  }

  void into_block(u128 v, Block &b) const {
    if (kind == 1 && bits == 128) {
      b.w[0] = (uint32_t)v;
      b.w[1] = (uint32_t)(v >> 32);
      b.w[2] = (uint32_t)(v >> 64);
      b.w[3] = (uint32_t)(v >> 96) << 1;  // group/uint.cuh:76-81
      return;
    }
    b.w[0] = (uint32_t)v;
    b.w[1] = (uint32_t)(v >> 32);
    b.w[2] = (uint32_t)(v >> 64);
    b.w[3] = (uint32_t)(v >> 96);
  }

  u128 add(u128 a, u128 b) const {
    if (kind == 0) return a ^ b;
    if (bits == 128) {
      u128 m = ((u128)1 << 127);
      u128 s = a + b;
      if (s >= m) s -= m;
      return s;
    }
    return (a + b) & mask();
  }

  u128 neg(u128 a) const {
    if (kind == 0) return a;
    if (bits == 128) {
      u128 m = ((u128)1 << 127);
      return a == 0 ? 0 : m - a;
    }
    return (u128)(0 - a) & mask();
  }
};

// ---------------------------------------------------------------------------
// DPF (dpf.cuh semantics; independent implementation)
// ---------------------------------------------------------------------------

inline int input_bit(uint64_t lo, uint64_t hi, int in_bits, int level) {
  int pos = in_bits - 1 - level;  // MSB-first walk
  if (pos >= 64) return (int)((hi >> (pos - 64)) & 1u);
  return (int)((lo >> pos) & 1u);
}

#if FSS_HAVE_AESNI
// ---------------------------------------------------------------------------
// Register-resident AES-NI tree walks. The portable scalar walks round-trip
// every Block through memory and branch on the data-dependent (t, x_bit)
// pair; at ~50% mispredict those branches cost more than the AES rounds
// themselves. These variants keep the node in an XMM register for the whole
// walk and replace the selects with mask blends. Outputs are bit-identical
// to the scalar paths (same dpf.cuh / dcf.cuh / half_tree_dpf.cuh
// semantics); the scalar paths remain for non-AES PRGs and non-x86 hosts.
// ---------------------------------------------------------------------------

inline __m128i load_b(const Block &b) {
  return _mm_loadu_si128(reinterpret_cast<const __m128i *>(b.w));
}

inline void store_b(__m128i v, Block &b) {
  _mm_storeu_si128(reinterpret_cast<__m128i *>(b.w), v);
}

// Block.w[3]'s bit 0 (the control bit) is bit 0 of XMM lane 3.
inline uint32_t lsb_of(__m128i v) {
  return (uint32_t)_mm_extract_epi32(v, 3) & 1u;
}

inline __m128i clear_ctl(__m128i v) {
  return _mm_andnot_si128(_mm_set_epi32(1, 0, 0, 0), v);
}

inline __m128i or_ctl(__m128i v, uint32_t bit) {
  return _mm_or_si128(v,
                      _mm_slli_si128(_mm_cvtsi32_si128((int)(bit & 1u)),
                                     12));
}

inline __m128i mask_of(uint32_t bit) {  // 0/1 -> all-zeros / all-ones
  return _mm_set1_epi32(-(int)bit);
}

#if FSS_HAVE_VAES512
inline __m512i bcast_b512(__m128i x) { return _mm512_broadcast_i32x4(x); }

// Per-key 0/1 bits -> a 16-bit dword mask covering each key's lane.
inline __mmask16 lane_mask4(uint32_t b0, uint32_t b1, uint32_t b2,
                            uint32_t b3) {
  return (__mmask16)((b0 * 0xFu) | (b1 * 0xF0u) | (b2 * 0xF00u) |
                     (b3 * 0xF000u));
}
#endif  // FSS_HAVE_VAES512

inline __m128i aes_mmo1(const AesKeySchedule &ks, __m128i x) {
  return _mm_xor_si128(aes128_encrypt(ks, x), x);
}

// Shared BGI walk (dpf.cuh:164-199): final seed (control bit cleared) in
// s_out, final t bit in t_out. Used by dpf_eval and vdpf_eval.
void dpf_walk_aesni(const Prg &prg, int in_bits, int party,
                    const Block &seed, const Block *cws, uint64_t x_lo,
                    uint64_t x_hi, Block &s_out, uint32_t &t_out) {
  __m128i s = clear_ctl(load_b(seed));
  uint32_t t = (uint32_t)party;
  for (int i = 0; i < in_bits; ++i) {
    __m128i l = aes_mmo1(prg.ks[0], s);
    __m128i r = aes_mmo1(prg.ks[1], s);
    __m128i cwa = load_b(cws[2 * i]);
    uint32_t tl = lsb_of(l) ^ (t & lsb_of(cwa));
    uint32_t tr = lsb_of(r) ^ (t & (cws[2 * i + 1].w[0] & 1u));
    __m128i corr = _mm_and_si128(clear_ctl(cwa), mask_of(t));
    l = _mm_xor_si128(clear_ctl(l), corr);
    r = _mm_xor_si128(clear_ctl(r), corr);
    uint32_t xb = (uint32_t)input_bit(x_lo, x_hi, in_bits, i);
    s = _mm_blendv_epi8(l, r, mask_of(xb));
    t = tl ^ ((tl ^ tr) & (0u - xb));
  }
  store_b(s, s_out);
  t_out = t;
}

// Four interleaved BGI walks. One walk is latency-bound: ten dependent
// AESENCs (~4 cycles each) per level while the AES unit could issue 1-2
// per cycle. Walking four instances at once keeps eight independent AES
// chains in flight — this is how the per-eval cost drops below the
// single-chain latency that a one-instance-at-a-time loop can never beat
// (the reference's recursive eval gets the same effect from the CPU's
// out-of-order window across google-benchmark iterations).
void dpf_walk_aesni_x4(const Prg &prg, int in_bits, int party,
                       const Block *const seeds[4],
                       const Block *const cwp[4], const uint64_t xlo[4],
                       const uint64_t xhi[4], Block s_out[4],
                       uint32_t t_out[4]) {
  __m128i s[4];
  uint32_t t[4];
  for (int k = 0; k < 4; ++k) {
    s[k] = clear_ctl(load_b(*seeds[k]));
    t[k] = (uint32_t)party;
  }
  for (int i = 0; i < in_bits; ++i) {
    __m128i l[4], r[4];
    for (int k = 0; k < 4; ++k) {
      l[k] = _mm_xor_si128(s[k], prg.ks[0].rk[0]);
      r[k] = _mm_xor_si128(s[k], prg.ks[1].rk[0]);
    }
    for (int rd = 1; rd < 10; ++rd) {
      for (int k = 0; k < 4; ++k) {
        l[k] = _mm_aesenc_si128(l[k], prg.ks[0].rk[rd]);
        r[k] = _mm_aesenc_si128(r[k], prg.ks[1].rk[rd]);
      }
    }
    for (int k = 0; k < 4; ++k) {
      l[k] = _mm_xor_si128(_mm_aesenclast_si128(l[k], prg.ks[0].rk[10]),
                           s[k]);
      r[k] = _mm_xor_si128(_mm_aesenclast_si128(r[k], prg.ks[1].rk[10]),
                           s[k]);
    }
    for (int k = 0; k < 4; ++k) {
      const Block *cw = cwp[k];
      __m128i cwa = load_b(cw[2 * i]);
      uint32_t tl = lsb_of(l[k]) ^ (t[k] & lsb_of(cwa));
      uint32_t tr = lsb_of(r[k]) ^ (t[k] & (cw[2 * i + 1].w[0] & 1u));
      __m128i corr = _mm_and_si128(clear_ctl(cwa), mask_of(t[k]));
      __m128i ll = _mm_xor_si128(clear_ctl(l[k]), corr);
      __m128i rr = _mm_xor_si128(clear_ctl(r[k]), corr);
      uint32_t xb = (uint32_t)input_bit(xlo[k], xhi[k], in_bits, i);
      s[k] = _mm_blendv_epi8(ll, rr, mask_of(xb));
      t[k] = tl ^ ((tl ^ tr) & (0u - xb));
    }
  }
  for (int k = 0; k < 4; ++k) {
    store_b(s[k], s_out[k]);
    t_out[k] = t[k];
  }
}

#if FSS_HAVE_VAES512
// Eight instance-sliced BGI walks: dpf_walk_aesni_x4's eight xmm AES
// chains collapse onto four vaesenc chains over two zmm seed groups
// (~5.5 aesenc-equivalents per instance-level vs 20 on xmm), with the
// correction/select epilogue running lane-masked. Bit-identical to the
// x4/x1 walkers.
void dpf_walk_vaes8(const Prg &prg, int in_bits, int party,
                    const Block *const seeds[8],
                    const Block *const cwp[8], const uint64_t xlo[8],
                    const uint64_t xhi[8], Block s_out[8],
                    uint32_t t_out[8]) {
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  const __m512i one512 = _mm512_set1_epi32(1);
  __m512i rk0z[11], rk1z[11];
  for (int r = 0; r < 11; ++r) {
    rk0z[r] = bcast_b512(prg.ks[0].rk[r]);
    rk1z[r] = bcast_b512(prg.ks[1].rk[r]);
  }
  __m512i S0 = _mm512_castsi128_si512(clear_ctl(load_b(*seeds[0])));
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(*seeds[1])), 1);
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(*seeds[2])), 2);
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(*seeds[3])), 3);
  __m512i S1 = _mm512_castsi128_si512(clear_ctl(load_b(*seeds[4])));
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(*seeds[5])), 1);
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(*seeds[6])), 2);
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(*seeds[7])), 3);
  uint32_t t[8];
  for (int k = 0; k < 8; ++k) t[k] = (uint32_t)party;
  const bool same_cw =
      cwp[1] == cwp[0] && cwp[2] == cwp[0] && cwp[3] == cwp[0] &&
      cwp[4] == cwp[0] && cwp[5] == cwp[0] && cwp[6] == cwp[0] &&
      cwp[7] == cwp[0];

  for (int i = 0; i < in_bits; ++i) {
    __m512i eL0 = _mm512_xor_si512(S0, rk0z[0]);
    __m512i eR0 = _mm512_xor_si512(S0, rk1z[0]);
    __m512i eL1 = _mm512_xor_si512(S1, rk0z[0]);
    __m512i eR1 = _mm512_xor_si512(S1, rk1z[0]);
    for (int rd = 1; rd < 10; ++rd) {
      eL0 = _mm512_aesenc_epi128(eL0, rk0z[rd]);
      eR0 = _mm512_aesenc_epi128(eR0, rk1z[rd]);
      eL1 = _mm512_aesenc_epi128(eL1, rk0z[rd]);
      eR1 = _mm512_aesenc_epi128(eR1, rk1z[rd]);
    }
    const __m512i L0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eL0, rk0z[10]), S0);
    const __m512i R0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eR0, rk1z[10]), S0);
    const __m512i L1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eL1, rk0z[10]), S1);
    const __m512i R1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eR1, rk1z[10]), S1);

    __m512i cw0, cw1;
    uint32_t trcw[8];
    if (same_cw) {
      cw0 = bcast_b512(load_b(cwp[0][2 * i]));
      cw1 = cw0;
      const uint32_t tb = cwp[0][2 * i + 1].w[0] & 1u;
      for (int k = 0; k < 8; ++k) trcw[k] = tb;
    } else {
      cw0 = _mm512_castsi128_si512(load_b(cwp[0][2 * i]));
      cw0 = _mm512_inserti32x4(cw0, load_b(cwp[1][2 * i]), 1);
      cw0 = _mm512_inserti32x4(cw0, load_b(cwp[2][2 * i]), 2);
      cw0 = _mm512_inserti32x4(cw0, load_b(cwp[3][2 * i]), 3);
      cw1 = _mm512_castsi128_si512(load_b(cwp[4][2 * i]));
      cw1 = _mm512_inserti32x4(cw1, load_b(cwp[5][2 * i]), 1);
      cw1 = _mm512_inserti32x4(cw1, load_b(cwp[6][2 * i]), 2);
      cw1 = _mm512_inserti32x4(cw1, load_b(cwp[7][2 * i]), 3);
      for (int k = 0; k < 8; ++k)
        trcw[k] = cwp[k][2 * i + 1].w[0] & 1u;
    }
    const uint32_t mcw0 = _mm512_test_epi32_mask(cw0, one512);
    const uint32_t mcw1 = _mm512_test_epi32_mask(cw1, one512);
    const uint32_t mL0 = _mm512_test_epi32_mask(L0, one512);
    const uint32_t mR0 = _mm512_test_epi32_mask(R0, one512);
    const uint32_t mL1 = _mm512_test_epi32_mask(L1, one512);
    const uint32_t mR1 = _mm512_test_epi32_mask(R1, one512);

    const __mmask16 t0m = lane_mask4(t[0], t[1], t[2], t[3]);
    const __mmask16 t1m = lane_mask4(t[4], t[5], t[6], t[7]);
    const __m512i corr0 =
        _mm512_maskz_mov_epi32(t0m, _mm512_andnot_si512(ctl512, cw0));
    const __m512i corr1 =
        _mm512_maskz_mov_epi32(t1m, _mm512_andnot_si512(ctl512, cw1));
    const __m512i Lc0 =
        _mm512_xor_si512(_mm512_andnot_si512(ctl512, L0), corr0);
    const __m512i Rc0 =
        _mm512_xor_si512(_mm512_andnot_si512(ctl512, R0), corr0);
    const __m512i Lc1 =
        _mm512_xor_si512(_mm512_andnot_si512(ctl512, L1), corr1);
    const __m512i Rc1 =
        _mm512_xor_si512(_mm512_andnot_si512(ctl512, R1), corr1);

    uint32_t xb[8];
    for (int k = 0; k < 8; ++k) {
      xb[k] = (uint32_t)input_bit(xlo[k], xhi[k], in_bits, i);
      const int p = 4 * (k & 3) + 3;
      const uint32_t mL = k < 4 ? mL0 : mL1;
      const uint32_t mR = k < 4 ? mR0 : mR1;
      const uint32_t mc = k < 4 ? mcw0 : mcw1;
      const uint32_t tl = ((mL >> p) & 1u) ^ (t[k] & ((mc >> p) & 1u));
      const uint32_t tr = ((mR >> p) & 1u) ^ (t[k] & trcw[k]);
      t[k] = tl ^ ((tl ^ tr) & (0u - xb[k]));
    }
    const __mmask16 xb0m = lane_mask4(xb[0], xb[1], xb[2], xb[3]);
    const __mmask16 xb1m = lane_mask4(xb[4], xb[5], xb[6], xb[7]);
    S0 = _mm512_mask_blend_epi32(xb0m, Lc0, Rc0);
    S1 = _mm512_mask_blend_epi32(xb1m, Lc1, Rc1);
  }
  store_b(_mm512_castsi512_si128(S0), s_out[0]);
  store_b(_mm512_extracti32x4_epi32(S0, 1), s_out[1]);
  store_b(_mm512_extracti32x4_epi32(S0, 2), s_out[2]);
  store_b(_mm512_extracti32x4_epi32(S0, 3), s_out[3]);
  store_b(_mm512_castsi512_si128(S1), s_out[4]);
  store_b(_mm512_extracti32x4_epi32(S1, 1), s_out[5]);
  store_b(_mm512_extracti32x4_epi32(S1, 2), s_out[6]);
  store_b(_mm512_extracti32x4_epi32(S1, 3), s_out[7]);
  for (int k = 0; k < 8; ++k) t_out[k] = t[k];
}
#endif  // FSS_HAVE_VAES512

#if FSS_HAVE_VAES512
// Sixteen instance-sliced ChaCha BGI walks: the state is word-major
// (st[j] holds word j of 16 instances), every quarter-round runs
// 16-wide with single-op vprold rotates, and the t bits live in
// __mmask16 registers for the whole walk. Bit-identical to the scalar
// ChaCha walk (prg/chacha.cuh semantics, the nonstandard feed-forward
// variant).
void dpf_walk_chacha16(const Prg &prg, int in_bits, int party,
                       const Block &seed, const Block *cws,
                       const uint64_t xlo[16], const uint64_t xhi[16],
                       Block s_out[16], uint32_t t_out[16]) {
  const int rounds = prg.rounds;
  const __m512i one = _mm512_set1_epi32(1);
  const __m512i notone = _mm512_set1_epi32((int)0xFFFFFFFE);
  __m512i C[4], W[4];
  for (int j = 0; j < 4; ++j)
    C[j] = _mm512_set1_epi32((int)kConst16[j]);
  {
    Block s = seed;
    s.w[3] &= 0xFFFFFFFEu;  // clear_ctl
    for (int j = 0; j < 4; ++j)
      W[j] = _mm512_set1_epi32((int)s.w[j]);
  }
  const __m512i N0 = _mm512_set1_epi32((int)prg.nonce[0]);
  const __m512i N1 = _mm512_set1_epi32((int)prg.nonce[1]);
  const __m512i Z = _mm512_setzero_si512();
  __mmask16 tmsk = party ? (__mmask16)0xFFFF : (__mmask16)0;

#define FSS_CC_QR(a, b, c, d)                                          \
  do {                                                                 \
    st[a] = _mm512_add_epi32(st[a], st[b]);                            \
    st[d] = _mm512_rol_epi32(_mm512_xor_si512(st[d], st[a]), 16);      \
    st[c] = _mm512_add_epi32(st[c], st[d]);                            \
    st[b] = _mm512_rol_epi32(_mm512_xor_si512(st[b], st[c]), 12);      \
    st[a] = _mm512_add_epi32(st[a], st[b]);                            \
    st[d] = _mm512_rol_epi32(_mm512_xor_si512(st[d], st[a]), 8);       \
    st[c] = _mm512_add_epi32(st[c], st[d]);                            \
    st[b] = _mm512_rol_epi32(_mm512_xor_si512(st[b], st[c]), 7);       \
  } while (0)

  for (int i = 0; i < in_bits; ++i) {
    __m512i st[16];
    for (int j = 0; j < 4; ++j) {
      st[j] = C[j];
      st[4 + j] = W[j];
      st[8 + j] = W[j];
    }
    st[12] = Z;
    st[13] = Z;
    st[14] = N0;
    st[15] = N1;
    for (int r = 0; r < rounds / 2; ++r) {
      FSS_CC_QR(0, 4, 8, 12);
      FSS_CC_QR(1, 5, 9, 13);
      FSS_CC_QR(2, 6, 10, 14);
      FSS_CC_QR(3, 7, 11, 15);
      FSS_CC_QR(0, 5, 10, 15);
      FSS_CC_QR(1, 6, 11, 12);
      FSS_CC_QR(2, 7, 8, 13);
      FSS_CC_QR(3, 4, 9, 14);
    }
    __m512i L[4], R[4];
    for (int j = 0; j < 4; ++j) {
      L[j] = _mm512_xor_si512(st[j], C[j]);
      R[j] = _mm512_xor_si512(st[4 + j], W[j]);
    }

    const __mmask16 tl_raw = _mm512_test_epi32_mask(L[3], one);
    const __mmask16 tr_raw = _mm512_test_epi32_mask(R[3], one);
    const Block &cwa = cws[2 * i];
    const uint32_t tlcw = cwa.w[3] & 1u;
    const uint32_t trcw = cws[2 * i + 1].w[0] & 1u;
    __m512i corr[4];
    for (int j = 0; j < 3; ++j)
      corr[j] = _mm512_maskz_mov_epi32(
          tmsk, _mm512_set1_epi32((int)cwa.w[j]));
    corr[3] = _mm512_maskz_mov_epi32(
        tmsk, _mm512_set1_epi32((int)(cwa.w[3] & 0xFFFFFFFEu)));
    L[3] = _mm512_and_si512(L[3], notone);
    R[3] = _mm512_and_si512(R[3], notone);

    __mmask16 xm = 0;
    for (int k = 0; k < 16; ++k)
      xm = (__mmask16)(xm |
                       ((uint32_t)input_bit(xlo[k], xhi[k], in_bits, i)
                        << k));
    for (int j = 0; j < 4; ++j)
      W[j] = _mm512_mask_blend_epi32(xm, _mm512_xor_si512(L[j], corr[j]),
                                     _mm512_xor_si512(R[j], corr[j]));
    const __mmask16 tlm =
        tl_raw ^ (tlcw ? tmsk : (__mmask16)0);
    const __mmask16 trm =
        tr_raw ^ (trcw ? tmsk : (__mmask16)0);
    tmsk = (__mmask16)(tlm ^ ((tlm ^ trm) & xm));
  }
#undef FSS_CC_QR

  alignas(64) uint32_t wbuf[4][16];
  for (int j = 0; j < 4; ++j)
    _mm512_store_si512(wbuf[j], W[j]);
  for (int k = 0; k < 16; ++k) {
    for (int j = 0; j < 4; ++j) s_out[k].w[j] = wbuf[j][k];
    t_out[k] = (tmsk >> k) & 1u;
  }
}
#endif  // FSS_HAVE_VAES512

// One breadth-first DPF level over ys[0..m) in place (the level body of
// dpf.cuh:294-341), shared by dpf_eval_all / vdpf_eval_all / grotto.
void dpf_expand_level_aesni_x1(const Prg &prg, Block *ys, uint64_t m,
                               const Block &cw_row0, uint32_t tr_cw_bit) {
  __m128i cwa = load_b(cw_row0);
  __m128i scw = clear_ctl(cwa);
  uint32_t tl_cw = lsb_of(cwa);
  uint32_t tr_cw = tr_cw_bit & 1u;
  for (uint64_t j = m; j-- > 0;) {
    __m128i node = load_b(ys[j]);
    uint32_t t = lsb_of(node);
    __m128i s = clear_ctl(node);
    __m128i l = aes_mmo1(prg.ks[0], s);
    __m128i r = aes_mmo1(prg.ks[1], s);
    uint32_t tl = lsb_of(l) ^ (t & tl_cw);
    uint32_t tr = lsb_of(r) ^ (t & tr_cw);
    __m128i corr = _mm_and_si128(scw, mask_of(t));
    store_b(or_ctl(_mm_xor_si128(clear_ctl(l), corr), tl), ys[2 * j]);
    store_b(or_ctl(_mm_xor_si128(clear_ctl(r), corr), tr),
            ys[2 * j + 1]);
  }
}
#endif  // FSS_HAVE_AESNI

#if FSS_HAVE_VAES512
// Node-sliced VAES-512 level body: 8 nodes per iteration ride four
// vaesenc chains (two schedules x two node quads); children are
// re-interleaved with two cross-register qword permutes per quad.
// Bit-identical to the x1 loop above.
void dpf_expand_level_vaes(const Prg &prg, Block *ys, uint64_t m,
                           const Block &cw_row0, uint32_t tr_cw_bit) {
  const __m512i ctl512 = _mm512_broadcast_i32x4(_mm_set_epi32(1, 0, 0,
                                                              0));
  const __m512i one512 = _mm512_set1_epi32(1);
  __m512i rk0z[11], rk1z[11];
  for (int r = 0; r < 11; ++r) {
    rk0z[r] = _mm512_broadcast_i32x4(prg.ks[0].rk[r]);
    rk1z[r] = _mm512_broadcast_i32x4(prg.ks[1].rk[r]);
  }
  const __m128i cwa = load_b(cw_row0);
  const __m512i scwz = _mm512_broadcast_i32x4(clear_ctl(cwa));
  const uint32_t tl_cw = lsb_of(cwa);
  const uint32_t tr_cw = tr_cw_bit & 1u;
  const __m512i idxA =
      _mm512_set_epi64(11, 10, 3, 2, 9, 8, 1, 0);
  const __m512i idxB =
      _mm512_set_epi64(15, 14, 7, 6, 13, 12, 5, 4);

  uint64_t j = m;
  while (j >= 8) {
    j -= 8;
    const __m512i n0 = _mm512_loadu_si512(ys + j);
    const __m512i n1 = _mm512_loadu_si512(ys + j + 4);
    const uint32_t tm0 = _mm512_test_epi32_mask(n0, one512);
    const uint32_t tm1 = _mm512_test_epi32_mask(n1, one512);
    const __m512i s0 = _mm512_andnot_si512(ctl512, n0);
    const __m512i s1 = _mm512_andnot_si512(ctl512, n1);

    __m512i eL0 = _mm512_xor_si512(s0, rk0z[0]);
    __m512i eR0 = _mm512_xor_si512(s0, rk1z[0]);
    __m512i eL1 = _mm512_xor_si512(s1, rk0z[0]);
    __m512i eR1 = _mm512_xor_si512(s1, rk1z[0]);
    for (int rd = 1; rd < 10; ++rd) {
      eL0 = _mm512_aesenc_epi128(eL0, rk0z[rd]);
      eR0 = _mm512_aesenc_epi128(eR0, rk1z[rd]);
      eL1 = _mm512_aesenc_epi128(eL1, rk0z[rd]);
      eR1 = _mm512_aesenc_epi128(eR1, rk1z[rd]);
    }
    const __m512i L0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eL0, rk0z[10]), s0);
    const __m512i R0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eR0, rk1z[10]), s0);
    const __m512i L1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eL1, rk0z[10]), s1);
    const __m512i R1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(eR1, rk1z[10]), s1);

    const uint32_t mL0 = _mm512_test_epi32_mask(L0, one512);
    const uint32_t mR0 = _mm512_test_epi32_mask(R0, one512);
    const uint32_t mL1 = _mm512_test_epi32_mask(L1, one512);
    const uint32_t mR1 = _mm512_test_epi32_mask(R1, one512);

    // Per-node t bits / correction masks and output control bits.
    uint32_t t_b[8], tlb[8], trb[8];
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * k + 3;
      t_b[k] = (tm0 >> p) & 1u;
      t_b[4 + k] = (tm1 >> p) & 1u;
      tlb[k] = ((mL0 >> p) & 1u) ^ (t_b[k] & tl_cw);
      trb[k] = ((mR0 >> p) & 1u) ^ (t_b[k] & tr_cw);
      tlb[4 + k] = ((mL1 >> p) & 1u) ^ (t_b[4 + k] & tl_cw);
      trb[4 + k] = ((mR1 >> p) & 1u) ^ (t_b[4 + k] & tr_cw);
    }
    const __mmask16 t0l_lanes =
        lane_mask4(t_b[0], t_b[1], t_b[2], t_b[3]);
    const __mmask16 t1l_lanes =
        lane_mask4(t_b[4], t_b[5], t_b[6], t_b[7]);
    const __m512i corr0 = _mm512_maskz_mov_epi32(t0l_lanes, scwz);
    const __m512i corr1 = _mm512_maskz_mov_epi32(t1l_lanes, scwz);

    const __mmask16 ctl_pos = (__mmask16)0x8888;
    const __mmask16 tl0m =
        lane_mask4(tlb[0], tlb[1], tlb[2], tlb[3]) & ctl_pos;
    const __mmask16 tr0m =
        lane_mask4(trb[0], trb[1], trb[2], trb[3]) & ctl_pos;
    const __mmask16 tl1m =
        lane_mask4(tlb[4], tlb[5], tlb[6], tlb[7]) & ctl_pos;
    const __mmask16 tr1m =
        lane_mask4(trb[4], trb[5], trb[6], trb[7]) & ctl_pos;

    __m512i l0 = _mm512_xor_si512(_mm512_andnot_si512(ctl512, L0),
                                  corr0);
    __m512i r0 = _mm512_xor_si512(_mm512_andnot_si512(ctl512, R0),
                                  corr0);
    __m512i l1 = _mm512_xor_si512(_mm512_andnot_si512(ctl512, L1),
                                  corr1);
    __m512i r1 = _mm512_xor_si512(_mm512_andnot_si512(ctl512, R1),
                                  corr1);
    l0 = _mm512_mask_or_epi32(l0, tl0m, l0, one512);
    r0 = _mm512_mask_or_epi32(r0, tr0m, r0, one512);
    l1 = _mm512_mask_or_epi32(l1, tl1m, l1, one512);
    r1 = _mm512_mask_or_epi32(r1, tr1m, r1, one512);

    _mm512_storeu_si512(ys + 2 * j,
                        _mm512_permutex2var_epi64(l0, idxA, r0));
    _mm512_storeu_si512(ys + 2 * j + 4,
                        _mm512_permutex2var_epi64(l0, idxB, r0));
    _mm512_storeu_si512(ys + 2 * j + 8,
                        _mm512_permutex2var_epi64(l1, idxA, r1));
    _mm512_storeu_si512(ys + 2 * j + 12,
                        _mm512_permutex2var_epi64(l1, idxB, r1));
  }
  if (j) dpf_expand_level_aesni_x1(prg, ys, j, cw_row0, tr_cw_bit);
}

// Vectorized final leaf conversion for EvalAll: packed (s, t) nodes ->
// group shares, 4 leaves per zmm (with an optional second vs stream for
// DCF's threaded values). The scalar conversion pass costs as much as
// the whole tree expansion at 2^20 (~6.5 ns/leaf vs ~5.7 ns/node), so
// EvalAll's second half lives here. Covers Bytes (XOR group, full
// 128-bit lanes) and Uint<=64 (64-bit value lanes); other groups return
// false and the caller keeps its scalar loop.
bool convert_leaves_vaes(const Group &grp, int party, const Block &ocw_b,
                         u128 ocw, Block *ys, const Block *vs,
                         uint64_t n, bool vs_packed64 = false) {
  if (n < 4 || (n & 3u)) return false;
  const __m512i one512 = _mm512_set1_epi32(1);
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  if (grp.kind == 0) {
    const __m512i ocwz = bcast_b512(load_b(ocw_b));
    for (uint64_t j = 0; j < n; j += 4) {
      const __m512i node = _mm512_loadu_si512(ys + j);
      const uint32_t tm = _mm512_test_epi32_mask(node, one512);
      const __mmask16 tl =
          lane_mask4((tm >> 3) & 1u, (tm >> 7) & 1u, (tm >> 11) & 1u,
                     (tm >> 15) & 1u);
      const __m512i corr = _mm512_maskz_mov_epi32(tl, ocwz);
      __m512i out = _mm512_xor_si512(_mm512_andnot_si512(ctl512, node),
                                     corr);
      if (vs) out = _mm512_xor_si512(out, _mm512_loadu_si512(vs + j));
      _mm512_storeu_si512(ys + j, out);
    }
    return true;
  }
  if (grp.kind == 1 && grp.bits <= 64) {
    const uint64_t vmask =
        grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
    const __m256i vmaskv = _mm256_set1_epi64x((long long)vmask);
    const __m256i ocwv =
        _mm256_set1_epi64x((long long)(uint64_t)ocw);
    const __m256i zero256 = _mm256_setzero_si256();
    const __m512i loq_idx = _mm512_set_epi64(0, 0, 0, 0, 6, 4, 2, 0);
    const __m512i spread_idx = _mm512_set_epi64(0, 3, 0, 2, 0, 1, 0, 0);
    for (uint64_t j = 0; j < n; j += 4) {
      const __m512i node = _mm512_loadu_si512(ys + j);
      const uint32_t tm = _mm512_test_epi32_mask(node, one512);
      const __mmask8 t8 =
          (__mmask8)(((tm >> 3) & 1u) | (((tm >> 7) & 1u) << 1) |
                     (((tm >> 11) & 1u) << 2) |
                     (((tm >> 15) & 1u) << 3));
      __m256i v = _mm256_and_si256(
          _mm512_castsi512_si256(
              _mm512_permutexvar_epi64(loq_idx, node)),
          vmaskv);
      v = _mm256_mask_add_epi64(v, t8, v, ocwv);
      if (party) v = _mm256_sub_epi64(zero256, v);
      if (vs) {
        const __m256i vv =
            vs_packed64
                ? _mm256_loadu_si256(
                      (const __m256i *)((const uint64_t *)vs + j))
                : _mm512_castsi512_si256(_mm512_permutexvar_epi64(
                      loq_idx, _mm512_loadu_si512(vs + j)));
        v = _mm256_add_epi64(v, vv);
      }
      v = _mm256_and_si256(v, vmaskv);
      _mm512_storeu_si512(
          ys + j,
          _mm512_maskz_permutexvar_epi64(
              (__mmask8)0x55, spread_idx, _mm512_castsi256_si512(v)));
    }
    return true;
  }
  return false;
}
#endif  // FSS_HAVE_VAES512

#if FSS_HAVE_AESNI
inline void dpf_expand_level_aesni(const Prg &prg, Block *ys, uint64_t m,
                                   const Block &cw_row0,
                                   uint32_t tr_cw_bit) {
#if FSS_HAVE_VAES512
  dpf_expand_level_vaes(prg, ys, m, cw_row0, tr_cw_bit);
#else
  dpf_expand_level_aesni_x1(prg, ys, m, cw_row0, tr_cw_bit);
#endif
}
#endif  // FSS_HAVE_AESNI

#if FSS_HAVE_AESNI
// Register-resident Gen, K keys interleaved: each key's two party
// expansions are four independent AES chains per level (4K chains in
// flight — K=2 saturates the AES unit), and every (alpha_bit, t) select
// is a mask blend (alpha bits are uniformly random -> ~50% mispredict
// as branches). Bit-identical to the scalar path (dpf.cuh:93-153).
template <int K>
void dpf_gen_aesni_k(const Prg &prg, const Group &grp, int in_bits,
                     const Block *s0s /* K x 2 seeds */,
                     const uint64_t *a_lo, const uint64_t *a_hi,
                     const Block *betas /* K */,
                     Block *const cwsk[K]) {
  __m128i s0[K], s1[K];
  uint32_t t0[K], t1[K];
  for (int k = 0; k < K; ++k) {
    s0[k] = clear_ctl(load_b(s0s[2 * k]));
    s1[k] = clear_ctl(load_b(s0s[2 * k + 1]));
    t0[k] = 0;
    t1[k] = 1;
  }
  for (int i = 0; i < in_bits; ++i) {
    __m128i a0[K], b0[K], a1[K], b1[K];
    for (int k = 0; k < K; ++k) {
      a0[k] = _mm_xor_si128(s0[k], prg.ks[0].rk[0]);
      b0[k] = _mm_xor_si128(s0[k], prg.ks[1].rk[0]);
      a1[k] = _mm_xor_si128(s1[k], prg.ks[0].rk[0]);
      b1[k] = _mm_xor_si128(s1[k], prg.ks[1].rk[0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int k = 0; k < K; ++k) {
        a0[k] = _mm_aesenc_si128(a0[k], prg.ks[0].rk[rd]);
        b0[k] = _mm_aesenc_si128(b0[k], prg.ks[1].rk[rd]);
        a1[k] = _mm_aesenc_si128(a1[k], prg.ks[0].rk[rd]);
        b1[k] = _mm_aesenc_si128(b1[k], prg.ks[1].rk[rd]);
      }
    for (int k = 0; k < K; ++k) {
      __m128i o0l = _mm_xor_si128(
          _mm_aesenclast_si128(a0[k], prg.ks[0].rk[10]), s0[k]);
      __m128i o0r = _mm_xor_si128(
          _mm_aesenclast_si128(b0[k], prg.ks[1].rk[10]), s0[k]);
      __m128i o1l = _mm_xor_si128(
          _mm_aesenclast_si128(a1[k], prg.ks[0].rk[10]), s1[k]);
      __m128i o1r = _mm_xor_si128(
          _mm_aesenclast_si128(b1[k], prg.ks[1].rk[10]), s1[k]);
      uint32_t t0l = lsb_of(o0l), t0r = lsb_of(o0r);
      uint32_t t1l = lsb_of(o1l), t1r = lsb_of(o1r);
      uint32_t ab =
          (uint32_t)input_bit(a_lo[k], a_hi ? a_hi[k] : 0, in_bits, i);
      __m128i abm = mask_of(ab);
      __m128i s0l = clear_ctl(o0l), s0r = clear_ctl(o0r);
      __m128i s1l = clear_ctl(o1l), s1r = clear_ctl(o1r);
      __m128i s_cw = _mm_blendv_epi8(_mm_xor_si128(s0r, s1r),
                                     _mm_xor_si128(s0l, s1l), abm);
      uint32_t tl_cw = t0l ^ t1l ^ ab ^ 1u;
      uint32_t tr_cw = t0r ^ t1r ^ ab;
      __m128i keep0 = _mm_blendv_epi8(s0l, s0r, abm);
      __m128i keep1 = _mm_blendv_epi8(s1l, s1r, abm);
      uint32_t tk0 = t0l ^ ((t0l ^ t0r) & (0u - ab));
      uint32_t tk1 = t1l ^ ((t1l ^ t1r) & (0u - ab));
      uint32_t tcw = tl_cw ^ ((tl_cw ^ tr_cw) & (0u - ab));
      s0[k] = _mm_xor_si128(keep0, _mm_and_si128(s_cw, mask_of(t0[k])));
      s1[k] = _mm_xor_si128(keep1, _mm_and_si128(s_cw, mask_of(t1[k])));
      t0[k] = tk0 ^ (t0[k] & tcw);
      t1[k] = tk1 ^ (t1[k] & tcw);
      store_b(or_ctl(s_cw, tl_cw), cwsk[k][2 * i]);
      cwsk[k][2 * i + 1].w[0] = tr_cw;
      cwsk[k][2 * i + 1].w[1] = cwsk[k][2 * i + 1].w[2] =
          cwsk[k][2 * i + 1].w[3] = 0;
    }
  }
  for (int k = 0; k < K; ++k) {
    Block s0b, s1b;
    store_b(s0[k], s0b);
    store_b(s1[k], s1b);
    u128 v = grp.add(grp.add(grp.from_block(set_lsb(betas[k], 0)),
                             grp.neg(grp.from_block(s0b))),
                     grp.from_block(s1b));
    if (t1[k] & 1u) v = grp.neg(v);
    grp.into_block(v, cwsk[k][2 * in_bits]);
    cwsk[k][2 * in_bits + 1].w[0] = cwsk[k][2 * in_bits + 1].w[1] = 0;
    cwsk[k][2 * in_bits + 1].w[2] = cwsk[k][2 * in_bits + 1].w[3] = 0;
  }
}

void dpf_gen_aesni(const Prg &prg, const Group &grp, int in_bits,
                   const Block s0s[2], uint64_t a_lo, uint64_t a_hi,
                   const Block &beta, Block *cws) {
  Block *const cwsk[1] = {cws};
  dpf_gen_aesni_k<1>(prg, grp, in_bits, s0s, &a_lo, &a_hi, &beta, cwsk);
}
#endif  // FSS_HAVE_AESNI

#if FSS_HAVE_VAES512
// Key-sliced VAES-512 Gen: four keys ride the four 128-bit lanes of a
// zmm, so each of the four MMO expansions per level is ONE vaesenc
// chain (40 aesenc-equivalents per level for 4 keys vs 160 on xmm), and
// the entire CW epilogue runs 4-keys-wide under AVX-512 lane masks.
// Bit-identical to dpf_gen_aesni_k (dpf.cuh:93-153 semantics).
// Shared 4-key key-sliced BGI gen walk (the level loop of DPF and VDPF
// Gen is identical, dpf.cuh:93-139 / vdpf.cuh:97-133): writes the cw
// rows and leaves the final seeds/t bits in S0/S1/t0b/t1b.
void dpf_gen_walk_vaes4(const Prg &prg, int in_bits,
                        const Block *s0s /* 4 x 2 seeds */,
                        const uint64_t *a_lo, const uint64_t *a_hi,
                        Block *const cwsk[4], __m512i &S0_out,
                        __m512i &S1_out, uint32_t t0b[4],
                        uint32_t t1b[4]) {
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  __m512i rk0z[11], rk1z[11];
  for (int r = 0; r < 11; ++r) {
    rk0z[r] = bcast_b512(prg.ks[0].rk[r]);
    rk1z[r] = bcast_b512(prg.ks[1].rk[r]);
  }
  __m512i S0 = _mm512_castsi128_si512(clear_ctl(load_b(s0s[0])));
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(s0s[2])), 1);
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(s0s[4])), 2);
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(s0s[6])), 3);
  __m512i S1 = _mm512_castsi128_si512(clear_ctl(load_b(s0s[1])));
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(s0s[3])), 1);
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(s0s[5])), 2);
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(s0s[7])), 3);
  for (int k = 0; k < 4; ++k) {
    t0b[k] = 0;
    t1b[k] = 1;
  }

  for (int i = 0; i < in_bits; ++i) {
    __m512i e0l = _mm512_xor_si512(S0, rk0z[0]);
    __m512i e0r = _mm512_xor_si512(S0, rk1z[0]);
    __m512i e1l = _mm512_xor_si512(S1, rk0z[0]);
    __m512i e1r = _mm512_xor_si512(S1, rk1z[0]);
    for (int rd = 1; rd < 10; ++rd) {
      e0l = _mm512_aesenc_epi128(e0l, rk0z[rd]);
      e0r = _mm512_aesenc_epi128(e0r, rk1z[rd]);
      e1l = _mm512_aesenc_epi128(e1l, rk0z[rd]);
      e1r = _mm512_aesenc_epi128(e1r, rk1z[rd]);
    }
    const __m512i o0l =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e0l, rk0z[10]), S0);
    const __m512i o0r =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e0r, rk1z[10]), S0);
    const __m512i o1l =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e1l, rk0z[10]), S1);
    const __m512i o1r =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e1r, rk1z[10]), S1);

    // Control bits live in dword 4k+3 of each lane.
    const __m512i one512 = _mm512_set1_epi32(1);
    uint32_t m0l = _mm512_test_epi32_mask(o0l, one512);
    uint32_t m0r = _mm512_test_epi32_mask(o0r, one512);
    uint32_t m1l = _mm512_test_epi32_mask(o1l, one512);
    uint32_t m1r = _mm512_test_epi32_mask(o1r, one512);

    uint32_t ab[4], tlcw[4], trcw[4];
    for (int k = 0; k < 4; ++k)
      ab[k] = (uint32_t)input_bit(a_lo[k], a_hi ? a_hi[k] : 0, in_bits,
                                  i);
    const __mmask16 abm = lane_mask4(ab[0], ab[1], ab[2], ab[3]);

    const __m512i s0l = _mm512_andnot_si512(ctl512, o0l);
    const __m512i s0r = _mm512_andnot_si512(ctl512, o0r);
    const __m512i s1l = _mm512_andnot_si512(ctl512, o1l);
    const __m512i s1r = _mm512_andnot_si512(ctl512, o1r);
    // mask set -> second operand: ab=1 picks the L xor / the R child.
    const __m512i s_cw = _mm512_mask_blend_epi32(
        abm, _mm512_xor_si512(s0r, s1r), _mm512_xor_si512(s0l, s1l));
    const __m512i keep0 = _mm512_mask_blend_epi32(abm, s0l, s0r);
    const __m512i keep1 = _mm512_mask_blend_epi32(abm, s1l, s1r);

    // Seed correction uses the PRE-update t bits.
    const __mmask16 t0m_old =
        lane_mask4(t0b[0], t0b[1], t0b[2], t0b[3]);
    const __mmask16 t1m_old =
        lane_mask4(t1b[0], t1b[1], t1b[2], t1b[3]);
    S0 = _mm512_mask_xor_epi32(keep0, t0m_old, keep0, s_cw);
    S1 = _mm512_mask_xor_epi32(keep1, t1m_old, keep1, s_cw);

    for (int k = 0; k < 4; ++k) {
      const int p = 4 * k + 3;
      const uint32_t t0l = (m0l >> p) & 1u, t0r = (m0r >> p) & 1u;
      const uint32_t t1l = (m1l >> p) & 1u, t1r = (m1r >> p) & 1u;
      tlcw[k] = t0l ^ t1l ^ ab[k] ^ 1u;
      trcw[k] = t0r ^ t1r ^ ab[k];
      const uint32_t tk0 = ab[k] ? t0r : t0l;
      const uint32_t tk1 = ab[k] ? t1r : t1l;
      const uint32_t tcw = ab[k] ? trcw[k] : tlcw[k];
      t0b[k] = tk0 ^ (t0b[k] & tcw);
      t1b[k] = tk1 ^ (t1b[k] & tcw);
    }

    // Row 0 = s_cw with tl_cw in the control bit; row 1 = {tr_cw,0,0,0}.
    const __mmask16 tlm =
        lane_mask4(tlcw[0], tlcw[1], tlcw[2], tlcw[3]) &
        (__mmask16)0x8888;
    const __m512i row0 = _mm512_mask_or_epi32(s_cw, tlm, s_cw, one512);
    store_b(_mm512_castsi512_si128(row0), cwsk[0][2 * i]);
    store_b(_mm512_extracti32x4_epi32(row0, 1), cwsk[1][2 * i]);
    store_b(_mm512_extracti32x4_epi32(row0, 2), cwsk[2][2 * i]);
    store_b(_mm512_extracti32x4_epi32(row0, 3), cwsk[3][2 * i]);
    for (int k = 0; k < 4; ++k)
      store_b(_mm_cvtsi32_si128((int)trcw[k]), cwsk[k][2 * i + 1]);
  }
  S0_out = S0;
  S1_out = S1;
}

void dpf_gen_vaes4(const Prg &prg, const Group &grp, int in_bits,
                   const Block *s0s /* 4 x 2 seeds */,
                   const uint64_t *a_lo, const uint64_t *a_hi,
                   const Block *betas /* 4 */, Block *const cwsk[4]) {
  __m512i S0, S1;
  uint32_t t0b[4], t1b[4];
  dpf_gen_walk_vaes4(prg, in_bits, s0s, a_lo, a_hi, cwsk, S0, S1, t0b,
                     t1b);
  // Leaf conversion, per key (dpf.cuh:140-152 semantics), identical to
  // the xmm path's epilogue.
  Block s0f[4], s1f[4];
  store_b(_mm512_castsi512_si128(S0), s0f[0]);
  store_b(_mm512_extracti32x4_epi32(S0, 1), s0f[1]);
  store_b(_mm512_extracti32x4_epi32(S0, 2), s0f[2]);
  store_b(_mm512_extracti32x4_epi32(S0, 3), s0f[3]);
  store_b(_mm512_castsi512_si128(S1), s1f[0]);
  store_b(_mm512_extracti32x4_epi32(S1, 1), s1f[1]);
  store_b(_mm512_extracti32x4_epi32(S1, 2), s1f[2]);
  store_b(_mm512_extracti32x4_epi32(S1, 3), s1f[3]);
  for (int k = 0; k < 4; ++k) {
    u128 v = grp.add(grp.add(grp.from_block(set_lsb(betas[k], 0)),
                             grp.neg(grp.from_block(s0f[k]))),
                     grp.from_block(s1f[k]));
    if (t1b[k] & 1u) v = grp.neg(v);
    grp.into_block(v, cwsk[k][2 * in_bits]);
    cwsk[k][2 * in_bits + 1].w[0] = cwsk[k][2 * in_bits + 1].w[1] = 0;
    cwsk[k][2 * in_bits + 1].w[2] = cwsk[k][2 * in_bits + 1].w[3] = 0;
  }
}
#endif  // FSS_HAVE_VAES512

void dpf_gen(const Prg &prg, const Group &grp, int in_bits,
             const Block s0s[2], uint64_t a_lo, uint64_t a_hi,
             const Block &beta, Block *cws /* (in_bits+1) x 2 blocks */) {
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
    dpf_gen_aesni(prg, grp, in_bits, s0s, a_lo, a_hi, beta, cws);
    return;
  }
#endif
  Block s0 = set_lsb(s0s[0], 0), s1 = set_lsb(s0s[1], 0);
  uint32_t t0 = 0, t1 = 1;
  Block b_buf = set_lsb(beta, 0);

  for (int i = 0; i < in_bits; ++i) {
    Block o0[2], o1[2];
    prg.gen(s0, o0);
    prg.gen(s1, o1);
    uint32_t t0l = get_lsb(o0[0]), t0r = get_lsb(o0[1]);
    uint32_t t1l = get_lsb(o1[0]), t1r = get_lsb(o1[1]);
    Block s0l = set_lsb(o0[0], 0), s0r = set_lsb(o0[1], 0);
    Block s1l = set_lsb(o1[0], 0), s1r = set_lsb(o1[1], 0);

    int ab = input_bit(a_lo, a_hi, in_bits, i);
    Block s_cw = ab ? bxor(s0l, s1l) : bxor(s0r, s1r);
    uint32_t tl_cw = t0l ^ t1l ^ (uint32_t)ab ^ 1u;
    uint32_t tr_cw = t0r ^ t1r ^ (uint32_t)ab;

    Block keep0 = ab ? s0r : s0l;
    Block keep1 = ab ? s1r : s1l;
    uint32_t tk0 = ab ? t0r : t0l;
    uint32_t tk1 = ab ? t1r : t1l;
    uint32_t tcw = ab ? tr_cw : tl_cw;

    s0 = t0 ? bxor(keep0, s_cw) : keep0;
    s1 = t1 ? bxor(keep1, s_cw) : keep1;
    t0 = tk0 ^ (t0 & tcw);
    t1 = tk1 ^ (t1 & tcw);

    cws[2 * i] = set_lsb(s_cw, tl_cw);
    cws[2 * i + 1].w[0] = tr_cw;
    cws[2 * i + 1].w[1] = cws[2 * i + 1].w[2] = cws[2 * i + 1].w[3] = 0;
  }

  u128 v = grp.add(grp.add(grp.from_block(b_buf),
                           grp.neg(grp.from_block(s0))),
                   grp.from_block(s1));
  if (t1 & 1u) v = grp.neg(v);
  grp.into_block(v, cws[2 * in_bits]);
  cws[2 * in_bits + 1].w[0] = cws[2 * in_bits + 1].w[1] = 0;
  cws[2 * in_bits + 1].w[2] = cws[2 * in_bits + 1].w[3] = 0;
}

void dpf_eval(const Prg &prg, const Group &grp, int in_bits, int party,
              const Block &seed, const Block *cws, uint64_t x_lo,
              uint64_t x_hi, Block &y_out) {
  Block s = set_lsb(seed, 0);
  uint32_t t = (uint32_t)party;
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
    dpf_walk_aesni(prg, in_bits, party, seed, cws, x_lo, x_hi, s, t);
  } else
#endif
  for (int i = 0; i < in_bits; ++i) {
    Block o[2];
    prg.gen(s, o);
    uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[1]);
    Block sl = set_lsb(o[0], 0), sr = set_lsb(o[1], 0);
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = cws[2 * i + 1].w[0] & 1u;
    if (t) {
      sl = bxor(sl, s_cw);
      sr = bxor(sr, s_cw);
      tl ^= tl_cw;
      tr ^= tr_cw;
    }
    int xb = input_bit(x_lo, x_hi, in_bits, i);
    s = xb ? sr : sl;
    t = xb ? tr : tl;
  }
  u128 y = grp.from_block(s);
  if (t) y = grp.add(y, grp.from_block(cws[2 * in_bits]));
  if (party) y = grp.neg(y);
  grp.into_block(y, y_out);
}

void dpf_eval_all(const Prg &prg, const Group &grp, int in_bits, int party,
                  const Block &seed, const Block *cws, Block *ys) {
  // Breadth-first in-place expansion: level i occupies ys[0 .. 2^i), each
  // entry the packed (s, t) node, expanded back-to-front to stay in place.
  ys[0] = set_lsb(set_lsb(seed, 0), (uint32_t)party);
  for (int i = 0; i < in_bits; ++i) {
    uint64_t m = 1ull << i;
#if FSS_HAVE_AESNI
    if (prg.kind == 1) {
      dpf_expand_level_aesni(prg, ys, m, cws[2 * i],
                             cws[2 * i + 1].w[0]);
      continue;
    }
#endif
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = cws[2 * i + 1].w[0] & 1u;
    for (uint64_t j = m; j-- > 0;) {
      Block node = ys[j];
      uint32_t t = get_lsb(node);
      Block s = set_lsb(node, 0);
      Block o[2];
      prg.gen(s, o);
      uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[1]);
      Block sl = set_lsb(o[0], 0), sr = set_lsb(o[1], 0);
      if (t) {
        sl = bxor(sl, s_cw);
        sr = bxor(sr, s_cw);
        tl ^= tl_cw;
        tr ^= tr_cw;
      }
      ys[2 * j] = set_lsb(sl, tl);
      ys[2 * j + 1] = set_lsb(sr, tr);
    }
  }
  u128 ocw = grp.from_block(cws[2 * in_bits]);
  uint64_t n = 1ull << in_bits;
#if FSS_HAVE_VAES512
  if (convert_leaves_vaes(grp, party, cws[2 * in_bits], ocw, ys, nullptr,
                          n))
    return;
#endif
  for (uint64_t j = 0; j < n; ++j) {
    uint32_t t = get_lsb(ys[j]);
    u128 y = grp.from_block(set_lsb(ys[j], 0));
    y = grp.add(y, t ? ocw : (u128)0);  // t is random: cmov, not branch
    if (party) y = grp.neg(y);
    grp.into_block(y, ys[j]);
  }
}

// ---------------------------------------------------------------------------
// DCF (dcf.cuh semantics; value-threaded comparison tree)
// ---------------------------------------------------------------------------

#if FSS_HAVE_AESNI
// Fully register-resident DCF Gen for Uint groups <= 64 bits: seeds in
// XMM, the value chain in one uint64, every random-bit select a blend.
void dcf_gen_aesni_u64(const Prg &prg, const Group &grp, int in_bits,
                       int pred_lt, const Block s0s[2], uint64_t a_lo,
                       uint64_t a_hi, const Block &beta, Block *cws) {
  __m128i s0 = clear_ctl(load_b(s0s[0]));
  __m128i s1 = clear_ctl(load_b(s0s[1]));
  uint32_t t0 = 0, t1 = 1;
  const uint64_t vmask =
      grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
  const uint64_t bval64 = (uint64_t)grp.from_block(set_lsb(beta, 0));
  uint64_t v64 = 0;
  for (int i = 0; i < in_bits; ++i) {
    __m128i e[8];
    for (int m = 0; m < 4; ++m) {
      e[m] = _mm_xor_si128(s0, prg.ks[m].rk[0]);
      e[4 + m] = _mm_xor_si128(s1, prg.ks[m].rk[0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int m = 0; m < 4; ++m) {
        e[m] = _mm_aesenc_si128(e[m], prg.ks[m].rk[rd]);
        e[4 + m] = _mm_aesenc_si128(e[4 + m], prg.ks[m].rk[rd]);
      }
    __m128i o0[4], o1[4];
    for (int m = 0; m < 4; ++m) {
      o0[m] = _mm_xor_si128(
          _mm_aesenclast_si128(e[m], prg.ks[m].rk[10]), s0);
      o1[m] = _mm_xor_si128(
          _mm_aesenclast_si128(e[4 + m], prg.ks[m].rk[10]), s1);
    }
    uint32_t t0l = lsb_of(o0[0]), t0r = lsb_of(o0[2]);
    uint32_t t1l = lsb_of(o1[0]), t1r = lsb_of(o1[2]);
    uint32_t ab = (uint32_t)input_bit(a_lo, a_hi, in_bits, i);
    __m128i abm = mask_of(ab);
    __m128i s0l = clear_ctl(o0[0]), s0r = clear_ctl(o0[2]);
    __m128i s1l = clear_ctl(o1[0]), s1r = clear_ctl(o1[2]);
    __m128i s_cw = _mm_blendv_epi8(_mm_xor_si128(s0r, s1r),
                                   _mm_xor_si128(s0l, s1l), abm);
    __m128i keep0 = _mm_blendv_epi8(s0l, s0r, abm);
    __m128i keep1 = _mm_blendv_epi8(s1l, s1r, abm);

    uint64_t v0l = ((uint64_t)_mm_cvtsi128_si64(o0[1])) & vmask;
    uint64_t v0r = ((uint64_t)_mm_cvtsi128_si64(o0[3])) & vmask;
    uint64_t v1l = ((uint64_t)_mm_cvtsi128_si64(o1[1])) & vmask;
    uint64_t v1r = ((uint64_t)_mm_cvtsi128_si64(o1[3])) & vmask;
    uint64_t v1_off = ab ? v1l : v1r;
    uint64_t v0_off = ab ? v0l : v0r;
    uint64_t v_cw64 = ((0ull - v64) + v1_off + (0ull - v0_off)) & vmask;
    uint32_t add_b = pred_lt ? ab : (ab ^ 1u);
    v_cw64 = (v_cw64 + (add_b ? bval64 : 0ull)) & vmask;
    v_cw64 = t1 ? ((0ull - v_cw64) & vmask) : v_cw64;
    uint64_t v1_on = ab ? v1r : v1l;
    uint64_t v0_on = ab ? v0r : v0l;
    v64 = (v64 + (0ull - v1_on) + v0_on) & vmask;
    v64 = (v64 + (t1 ? ((0ull - v_cw64) & vmask) : v_cw64)) & vmask;

    uint32_t tl_cw = t0l ^ t1l ^ ab ^ 1u;
    uint32_t tr_cw = t0r ^ t1r ^ ab;
    uint32_t tk0 = t0l ^ ((t0l ^ t0r) & ab);
    uint32_t tk1 = t1l ^ ((t1l ^ t1r) & ab);
    uint32_t tcw = tl_cw ^ ((tl_cw ^ tr_cw) & ab);
    s0 = _mm_xor_si128(keep0, _mm_and_si128(s_cw, mask_of(t0)));
    s1 = _mm_xor_si128(keep1, _mm_and_si128(s_cw, mask_of(t1)));
    t0 = tk0 ^ (t0 & tcw);
    t1 = tk1 ^ (t1 & tcw);

    store_b(or_ctl(s_cw, tl_cw), cws[2 * i]);
    cws[2 * i + 1].w[0] = (uint32_t)v_cw64;
    cws[2 * i + 1].w[1] = (uint32_t)(v_cw64 >> 32);
    cws[2 * i + 1].w[2] = 0;
    cws[2 * i + 1].w[3] = tr_cw & 1u;
  }
  Block s0b, s1b;
  store_b(s0, s0b);
  store_b(s1, s1b);
  uint64_t lo0 = ((uint64_t)s0b.w[0] | ((uint64_t)s0b.w[1] << 32));
  uint64_t lo1 = ((uint64_t)s1b.w[0] | ((uint64_t)s1b.w[1] << 32));
  uint64_t v_last = ((lo1 & vmask) + (0ull - (lo0 & vmask)) +
                     (0ull - v64)) & vmask;
  if (t1) v_last = (0ull - v_last) & vmask;
  cws[2 * in_bits].w[0] = cws[2 * in_bits].w[1] = 0;
  cws[2 * in_bits].w[2] = cws[2 * in_bits].w[3] = 0;
  cws[2 * in_bits + 1].w[0] = (uint32_t)v_last;
  cws[2 * in_bits + 1].w[1] = (uint32_t)(v_last >> 32);
  cws[2 * in_bits + 1].w[2] = cws[2 * in_bits + 1].w[3] = 0;
}
#endif  // FSS_HAVE_AESNI

#if FSS_HAVE_VAES512
// Key-sliced VAES-512 DCF Gen (Uint groups <= 64 bits): four keys per
// zmm lane; the eight AES chains per level (4 schedules x 2 parties)
// become eight vaesenc chains over 4 keys, the seed/CW epilogue runs
// lane-masked, and the value lane runs 4-wide in 64-bit AVX-512 lanes.
// Bit-identical to dcf_gen_aesni_u64 (dcf.cuh gen semantics).
void dcf_gen_vaes4(const Prg &prg, const Group &grp, int in_bits,
                   int pred_lt, const Block *s0s /* 4 x 2 */,
                   const uint64_t *a_lo, const uint64_t *a_hi,
                   const Block *betas /* 4 */, Block *const cwsk[4]) {
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  const __m512i one512 = _mm512_set1_epi32(1);
  alignas(64) __m512i rkz[4][11];
  for (int m = 0; m < 4; ++m)
    for (int r = 0; r < 11; ++r) rkz[m][r] = bcast_b512(prg.ks[m].rk[r]);

  __m512i S0 = _mm512_castsi128_si512(clear_ctl(load_b(s0s[0])));
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(s0s[2])), 1);
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(s0s[4])), 2);
  S0 = _mm512_inserti32x4(S0, clear_ctl(load_b(s0s[6])), 3);
  __m512i S1 = _mm512_castsi128_si512(clear_ctl(load_b(s0s[1])));
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(s0s[3])), 1);
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(s0s[5])), 2);
  S1 = _mm512_inserti32x4(S1, clear_ctl(load_b(s0s[7])), 3);
  uint32_t t0b[4] = {0, 0, 0, 0}, t1b[4] = {1, 1, 1, 1};

  const uint64_t vmask_s =
      grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
  const __m256i vmaskv = _mm256_set1_epi64x((long long)vmask_s);
  const __m256i zero256 = _mm256_setzero_si256();
  __m256i bvalv = _mm256_set_epi64x(
      (long long)(uint64_t)grp.from_block(set_lsb(betas[3], 0)),
      (long long)(uint64_t)grp.from_block(set_lsb(betas[2], 0)),
      (long long)(uint64_t)grp.from_block(set_lsb(betas[1], 0)),
      (long long)(uint64_t)grp.from_block(set_lsb(betas[0], 0)));
  __m256i v64v = zero256;
  // Compress each 128-bit lane's low qword into a 4 x u64 ymm.
  const __m512i loq_idx = _mm512_set_epi64(0, 0, 0, 0, 6, 4, 2, 0);

  for (int i = 0; i < in_bits; ++i) {
    __m512i e[8];
    for (int m = 0; m < 4; ++m) {
      e[m] = _mm512_xor_si512(S0, rkz[m][0]);
      e[4 + m] = _mm512_xor_si512(S1, rkz[m][0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int m = 0; m < 4; ++m) {
        e[m] = _mm512_aesenc_epi128(e[m], rkz[m][rd]);
        e[4 + m] = _mm512_aesenc_epi128(e[4 + m], rkz[m][rd]);
      }
    __m512i o0[4], o1[4];
    for (int m = 0; m < 4; ++m) {
      o0[m] = _mm512_xor_si512(
          _mm512_aesenclast_epi128(e[m], rkz[m][10]), S0);
      o1[m] = _mm512_xor_si512(
          _mm512_aesenclast_epi128(e[4 + m], rkz[m][10]), S1);
    }

    const uint32_t m0l = _mm512_test_epi32_mask(o0[0], one512);
    const uint32_t m0r = _mm512_test_epi32_mask(o0[2], one512);
    const uint32_t m1l = _mm512_test_epi32_mask(o1[0], one512);
    const uint32_t m1r = _mm512_test_epi32_mask(o1[2], one512);
    uint32_t ab[4];
    for (int k = 0; k < 4; ++k)
      ab[k] = (uint32_t)input_bit(a_lo[k], a_hi ? a_hi[k] : 0, in_bits,
                                  i);
    const __mmask16 abm = lane_mask4(ab[0], ab[1], ab[2], ab[3]);
    const __mmask8 ab8 = (__mmask8)((ab[0]) | (ab[1] << 1) |
                                    (ab[2] << 2) | (ab[3] << 3));
    const __mmask8 t18 = (__mmask8)((t1b[0] & 1u) | ((t1b[1] & 1u) << 1) |
                                    ((t1b[2] & 1u) << 2) |
                                    ((t1b[3] & 1u) << 3));

    const __m512i s0l = _mm512_andnot_si512(ctl512, o0[0]);
    const __m512i s0r = _mm512_andnot_si512(ctl512, o0[2]);
    const __m512i s1l = _mm512_andnot_si512(ctl512, o1[0]);
    const __m512i s1r = _mm512_andnot_si512(ctl512, o1[2]);
    const __m512i s_cw = _mm512_mask_blend_epi32(
        abm, _mm512_xor_si512(s0r, s1r), _mm512_xor_si512(s0l, s1l));
    const __m512i keep0 = _mm512_mask_blend_epi32(abm, s0l, s0r);
    const __m512i keep1 = _mm512_mask_blend_epi32(abm, s1l, s1r);
    const __mmask16 t0m_old =
        lane_mask4(t0b[0], t0b[1], t0b[2], t0b[3]);
    const __mmask16 t1m_old =
        lane_mask4(t1b[0], t1b[1], t1b[2], t1b[3]);
    S0 = _mm512_mask_xor_epi32(keep0, t0m_old, keep0, s_cw);
    S1 = _mm512_mask_xor_epi32(keep1, t1m_old, keep1, s_cw);

    // Value lane, 4 keys wide (low qword of the mul-4 outputs 1 and 3).
    const __m256i v0l = _mm256_and_si256(
        _mm512_castsi512_si256(_mm512_permutexvar_epi64(loq_idx, o0[1])),
        vmaskv);
    const __m256i v0r = _mm256_and_si256(
        _mm512_castsi512_si256(_mm512_permutexvar_epi64(loq_idx, o0[3])),
        vmaskv);
    const __m256i v1l = _mm256_and_si256(
        _mm512_castsi512_si256(_mm512_permutexvar_epi64(loq_idx, o1[1])),
        vmaskv);
    const __m256i v1r = _mm256_and_si256(
        _mm512_castsi512_si256(_mm512_permutexvar_epi64(loq_idx, o1[3])),
        vmaskv);
    const __m256i v1_off = _mm256_mask_blend_epi64(ab8, v1r, v1l);
    const __m256i v0_off = _mm256_mask_blend_epi64(ab8, v0r, v0l);
    __m256i v_cw = _mm256_add_epi64(
        _mm256_sub_epi64(v1_off, v0_off),
        _mm256_sub_epi64(zero256, v64v));
    const __mmask8 addb8 =
        pred_lt ? ab8 : (__mmask8)(ab8 ^ (__mmask8)0xF);
    v_cw = _mm256_mask_add_epi64(v_cw, addb8, v_cw, bvalv);
    v_cw = _mm256_mask_sub_epi64(v_cw, t18, zero256, v_cw);
    v_cw = _mm256_and_si256(v_cw, vmaskv);
    const __m256i v1_on = _mm256_mask_blend_epi64(ab8, v1l, v1r);
    const __m256i v0_on = _mm256_mask_blend_epi64(ab8, v0l, v0r);
    v64v = _mm256_add_epi64(v64v, _mm256_sub_epi64(v0_on, v1_on));
    const __m256i v_cw_t = _mm256_mask_sub_epi64(v_cw, t18, zero256,
                                                 v_cw);
    v64v = _mm256_and_si256(_mm256_add_epi64(v64v, v_cw_t), vmaskv);

    uint32_t tlcw[4], trcw[4];
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * k + 3;
      const uint32_t t0l = (m0l >> p) & 1u, t0r = (m0r >> p) & 1u;
      const uint32_t t1l = (m1l >> p) & 1u, t1r = (m1r >> p) & 1u;
      tlcw[k] = t0l ^ t1l ^ ab[k] ^ 1u;
      trcw[k] = t0r ^ t1r ^ ab[k];
      const uint32_t tk0 = ab[k] ? t0r : t0l;
      const uint32_t tk1 = ab[k] ? t1r : t1l;
      const uint32_t tcw = ab[k] ? trcw[k] : tlcw[k];
      t0b[k] = tk0 ^ (t0b[k] & tcw);
      t1b[k] = tk1 ^ (t1b[k] & tcw);
    }

    const __mmask16 tlm =
        lane_mask4(tlcw[0], tlcw[1], tlcw[2], tlcw[3]) &
        (__mmask16)0x8888;
    const __m512i row0 = _mm512_mask_or_epi32(s_cw, tlm, s_cw, one512);
    store_b(_mm512_castsi512_si128(row0), cwsk[0][2 * i]);
    store_b(_mm512_extracti32x4_epi32(row0, 1), cwsk[1][2 * i]);
    store_b(_mm512_extracti32x4_epi32(row0, 2), cwsk[2][2 * i]);
    store_b(_mm512_extracti32x4_epi32(row0, 3), cwsk[3][2 * i]);
    alignas(32) uint64_t vcw_s[4];
    _mm256_store_si256(reinterpret_cast<__m256i *>(vcw_s), v_cw);
    for (int k = 0; k < 4; ++k) {
      cwsk[k][2 * i + 1].w[0] = (uint32_t)vcw_s[k];
      cwsk[k][2 * i + 1].w[1] = (uint32_t)(vcw_s[k] >> 32);
      cwsk[k][2 * i + 1].w[2] = 0;
      cwsk[k][2 * i + 1].w[3] = trcw[k] & 1u;
    }
  }

  Block s0f[4], s1f[4];
  store_b(_mm512_castsi512_si128(S0), s0f[0]);
  store_b(_mm512_extracti32x4_epi32(S0, 1), s0f[1]);
  store_b(_mm512_extracti32x4_epi32(S0, 2), s0f[2]);
  store_b(_mm512_extracti32x4_epi32(S0, 3), s0f[3]);
  store_b(_mm512_castsi512_si128(S1), s1f[0]);
  store_b(_mm512_extracti32x4_epi32(S1, 1), s1f[1]);
  store_b(_mm512_extracti32x4_epi32(S1, 2), s1f[2]);
  store_b(_mm512_extracti32x4_epi32(S1, 3), s1f[3]);
  alignas(32) uint64_t v64_s[4];
  _mm256_store_si256(reinterpret_cast<__m256i *>(v64_s), v64v);
  for (int k = 0; k < 4; ++k) {
    const uint64_t lo0 =
        ((uint64_t)s0f[k].w[0] | ((uint64_t)s0f[k].w[1] << 32));
    const uint64_t lo1 =
        ((uint64_t)s1f[k].w[0] | ((uint64_t)s1f[k].w[1] << 32));
    uint64_t v_last = ((lo1 & vmask_s) + (0ull - (lo0 & vmask_s)) +
                       (0ull - v64_s[k])) & vmask_s;
    if (t1b[k]) v_last = (0ull - v_last) & vmask_s;
    cwsk[k][2 * in_bits].w[0] = cwsk[k][2 * in_bits].w[1] = 0;
    cwsk[k][2 * in_bits].w[2] = cwsk[k][2 * in_bits].w[3] = 0;
    cwsk[k][2 * in_bits + 1].w[0] = (uint32_t)v_last;
    cwsk[k][2 * in_bits + 1].w[1] = (uint32_t)(v_last >> 32);
    cwsk[k][2 * in_bits + 1].w[2] = cwsk[k][2 * in_bits + 1].w[3] = 0;
  }
}
#endif  // FSS_HAVE_VAES512

void dcf_gen(const Prg &prg, const Group &grp, int in_bits, int pred_lt,
             const Block s0s[2], uint64_t a_lo, uint64_t a_hi,
             const Block &beta, Block *cws /* (in_bits+1) x 2 blocks */) {
#if FSS_HAVE_AESNI
  if (prg.kind == 1 && grp.kind == 1 && grp.bits <= 64) {
    dcf_gen_aesni_u64(prg, grp, in_bits, pred_lt, s0s, a_lo, a_hi, beta,
                      cws);
    return;
  }
#endif
  Block s0 = set_lsb(s0s[0], 0), s1 = set_lsb(s0s[1], 0);
  uint32_t t0 = 0, t1 = 1;
  u128 b_val = grp.from_block(set_lsb(beta, 0));
  u128 v = 0;
  // Uint groups <= 64 bits: run the whole value chain in one uint64
  // (mod-2^bits sums mask once at the end of each chain).
  const bool u64fast = (grp.kind == 1 && grp.bits <= 64);
  const uint64_t vmask =
      grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
  const uint64_t bval64 = (uint64_t)b_val;
  uint64_t v64 = 0;

  for (int i = 0; i < in_bits; ++i) {
    Block o0[4], o1[4];
#if FSS_HAVE_AESNI
    if (prg.kind == 1) {
      // Both parties' mul=4 expansions: eight independent AES chains.
      __m128i sv0 = load_b(s0), sv1 = load_b(s1);
      __m128i e[8];
      for (int m = 0; m < 4; ++m) {
        e[m] = _mm_xor_si128(sv0, prg.ks[m].rk[0]);
        e[4 + m] = _mm_xor_si128(sv1, prg.ks[m].rk[0]);
      }
      for (int rd = 1; rd < 10; ++rd)
        for (int m = 0; m < 4; ++m) {
          e[m] = _mm_aesenc_si128(e[m], prg.ks[m].rk[rd]);
          e[4 + m] = _mm_aesenc_si128(e[4 + m], prg.ks[m].rk[rd]);
        }
      for (int m = 0; m < 4; ++m) {
        store_b(_mm_xor_si128(
                    _mm_aesenclast_si128(e[m], prg.ks[m].rk[10]), sv0),
                o0[m]);
        store_b(_mm_xor_si128(
                    _mm_aesenclast_si128(e[4 + m], prg.ks[m].rk[10]),
                    sv1),
                o1[m]);
      }
    } else {
      prg.gen(s0, o0);
      prg.gen(s1, o1);
    }
#else
    prg.gen(s0, o0);
    prg.gen(s1, o1);
#endif
    uint32_t t0l = get_lsb(o0[0]), t0r = get_lsb(o0[2]);
    uint32_t t1l = get_lsb(o1[0]), t1r = get_lsb(o1[2]);
    Block s0l = set_lsb(o0[0], 0), s0r = set_lsb(o0[2], 0);
    Block s1l = set_lsb(o1[0], 0), s1r = set_lsb(o1[2], 0);
    // Branchless level epilogue: ab and the control bits are uniformly
    // random, so data-dependent branches here mispredict ~50% — selects
    // are XOR-mask blends / cmov ternaries instead.
    uint32_t ab = (uint32_t)input_bit(a_lo, a_hi, in_bits, i);
    uint32_t abm = 0u - ab;
    Block s_cw, keep0, keep1;
    for (int w = 0; w < 4; ++w) {
      uint32_t cl = s0l.w[w] ^ s1l.w[w], cr = s0r.w[w] ^ s1r.w[w];
      s_cw.w[w] = cr ^ ((cl ^ cr) & abm);
      keep0.w[w] = s0l.w[w] ^ ((s0l.w[w] ^ s0r.w[w]) & abm);
      keep1.w[w] = s1l.w[w] ^ ((s1l.w[w] ^ s1r.w[w]) & abm);
    }

    uint32_t add_b = pred_lt ? ab : (ab ^ 1u);
    Block v_row;
    if (u64fast) {
      auto lo64 = [](const Block &b) {
        return (uint64_t)b.w[0] | ((uint64_t)b.w[1] << 32);
      };
      uint64_t v0l = lo64(o0[1]) & vmask, v0r = lo64(o0[3]) & vmask;
      uint64_t v1l = lo64(o1[1]) & vmask, v1r = lo64(o1[3]) & vmask;
      uint64_t v1_off = ab ? v1l : v1r;
      uint64_t v0_off = ab ? v0l : v0r;
      uint64_t v_cw64 =
          ((0ull - v64) + v1_off + (0ull - v0_off)) & vmask;
      v_cw64 = (v_cw64 + (add_b ? bval64 : 0ull)) & vmask;
      v_cw64 = t1 ? ((0ull - v_cw64) & vmask) : v_cw64;
      uint64_t v1_on = ab ? v1r : v1l;
      uint64_t v0_on = ab ? v0r : v0l;
      v64 = (v64 + (0ull - v1_on) + v0_on) & vmask;
      v64 = (v64 + (t1 ? ((0ull - v_cw64) & vmask) : v_cw64)) & vmask;
      v_row.w[0] = (uint32_t)v_cw64;
      v_row.w[1] = (uint32_t)(v_cw64 >> 32);
      v_row.w[2] = v_row.w[3] = 0;
    } else {
      u128 v0l = grp.from_block(set_lsb(o0[1], 0));
      u128 v0r = grp.from_block(set_lsb(o0[3], 0));
      u128 v1l = grp.from_block(set_lsb(o1[1], 0));
      u128 v1r = grp.from_block(set_lsb(o1[3], 0));
      u128 v1_off = ab ? v1l : v1r;
      u128 v0_off = ab ? v0l : v0r;
      u128 v_cw = grp.add(grp.add(grp.neg(v), v1_off), grp.neg(v0_off));
      v_cw = grp.add(v_cw, add_b ? b_val : (u128)0);
      v_cw = t1 ? grp.neg(v_cw) : v_cw;
      u128 v1_on = ab ? v1r : v1l;
      u128 v0_on = ab ? v0r : v0l;
      v = grp.add(grp.add(v, grp.neg(v1_on)), v0_on);
      v = grp.add(v, t1 ? grp.neg(v_cw) : v_cw);
      grp.into_block(v_cw, v_row);
    }

    uint32_t tl_cw = t0l ^ t1l ^ ab ^ 1u;
    uint32_t tr_cw = t0r ^ t1r ^ ab;

    uint32_t tk0 = t0l ^ ((t0l ^ t0r) & ab);
    uint32_t tk1 = t1l ^ ((t1l ^ t1r) & ab);
    uint32_t tcw = tl_cw ^ ((tl_cw ^ tr_cw) & ab);

    uint32_t t0m = 0u - t0, t1m = 0u - t1;
    for (int w = 0; w < 4; ++w) {
      s0.w[w] = keep0.w[w] ^ (s_cw.w[w] & t0m);
      s1.w[w] = keep1.w[w] ^ (s_cw.w[w] & t1m);
    }
    t0 = tk0 ^ (t0 & tcw);
    t1 = tk1 ^ (t1 & tcw);

    cws[2 * i] = set_lsb(s_cw, tl_cw);
    cws[2 * i + 1] = set_lsb(v_row, tr_cw);
  }
  if (u64fast) v = (u128)v64;

  u128 v_last = grp.add(grp.add(grp.from_block(s1),
                                grp.neg(grp.from_block(s0))),
                        grp.neg(v));
  if (t1) v_last = grp.neg(v_last);
  cws[2 * in_bits].w[0] = cws[2 * in_bits].w[1] = 0;
  cws[2 * in_bits].w[2] = cws[2 * in_bits].w[3] = 0;
  grp.into_block(v_last, cws[2 * in_bits + 1]);
}

#if FSS_HAVE_AESNI
// DCF walk with register-resident seeds; the u128 value chain stays
// scalar (it is off the AES critical path). dcf.cuh:205-276 semantics.
void dcf_eval_aesni(const Prg &prg, const Group &grp, int in_bits,
                    int party, const Block &seed, const Block *cws,
                    uint64_t x_lo, uint64_t x_hi, Block &y_out) {
  __m128i s = clear_ctl(load_b(seed));
  uint32_t t = (uint32_t)party;
  u128 v = 0;
  for (int i = 0; i < in_bits; ++i) {
    __m128i o0 = aes_mmo1(prg.ks[0], s);
    __m128i o1 = aes_mmo1(prg.ks[1], s);
    __m128i o2 = aes_mmo1(prg.ks[2], s);
    __m128i o3 = aes_mmo1(prg.ks[3], s);
    __m128i cwa = load_b(cws[2 * i]);
    const Block &cwb = cws[2 * i + 1];
    uint32_t tl = lsb_of(o0) ^ (t & lsb_of(cwa));
    uint32_t tr = lsb_of(o2) ^ (t & (cwb.w[3] & 1u));
    __m128i corr = _mm_and_si128(clear_ctl(cwa), mask_of(t));
    __m128i sl = _mm_xor_si128(clear_ctl(o0), corr);
    __m128i sr = _mm_xor_si128(clear_ctl(o2), corr);
    uint32_t xb = (uint32_t)input_bit(x_lo, x_hi, in_bits, i);
    Block vb;
    store_b(clear_ctl(_mm_blendv_epi8(o1, o3, mask_of(xb))), vb);
    u128 v_step = grp.from_block(vb);
    if (t) {
      Block vcw_b = set_lsb(cwb, 0);
      v_step = grp.add(v_step, grp.from_block(vcw_b));
    }
    if (party) v_step = grp.neg(v_step);
    v = grp.add(v, v_step);
    s = _mm_blendv_epi8(sl, sr, mask_of(xb));
    t = tl ^ ((tl ^ tr) & (0u - xb));
  }
  Block sb;
  store_b(s, sb);
  u128 term = grp.from_block(sb);
  if (t) term = grp.add(term, grp.from_block(cws[2 * in_bits + 1]));
  if (party) term = grp.neg(term);
  grp.into_block(grp.add(v, term), y_out);
}
// Two interleaved DCF walks: each walk already carries four independent
// AES chains per level, so two walks (eight chains) saturate the unit.
void dcf_eval_aesni_x2(const Prg &prg, const Group &grp, int in_bits,
                       int party, const Block &seed, const Block *cws,
                       const uint64_t xlo[2], const uint64_t xhi[2],
                       Block y_out[2]) {
  __m128i s[2];
  uint32_t t[2];
  u128 v[2] = {0, 0};
  for (int k = 0; k < 2; ++k) {
    s[k] = clear_ctl(load_b(seed));
    t[k] = (uint32_t)party;
  }
  for (int i = 0; i < in_bits; ++i) {
    __m128i o[2][4];
    for (int m = 0; m < 4; ++m)
      for (int k = 0; k < 2; ++k)
        o[k][m] = _mm_xor_si128(s[k], prg.ks[m].rk[0]);
    for (int rd = 1; rd < 10; ++rd)
      for (int m = 0; m < 4; ++m)
        for (int k = 0; k < 2; ++k)
          o[k][m] = _mm_aesenc_si128(o[k][m], prg.ks[m].rk[rd]);
    for (int m = 0; m < 4; ++m)
      for (int k = 0; k < 2; ++k)
        o[k][m] = _mm_xor_si128(
            _mm_aesenclast_si128(o[k][m], prg.ks[m].rk[10]), s[k]);
    __m128i cwa = load_b(cws[2 * i]);
    const Block &cwb = cws[2 * i + 1];
    Block vcw_b = set_lsb(cwb, 0);
    u128 vcwv = grp.from_block(vcw_b);
    for (int k = 0; k < 2; ++k) {
      uint32_t tl = lsb_of(o[k][0]) ^ (t[k] & lsb_of(cwa));
      uint32_t tr = lsb_of(o[k][2]) ^ (t[k] & (cwb.w[3] & 1u));
      __m128i corr = _mm_and_si128(clear_ctl(cwa), mask_of(t[k]));
      __m128i sl = _mm_xor_si128(clear_ctl(o[k][0]), corr);
      __m128i sr = _mm_xor_si128(clear_ctl(o[k][2]), corr);
      uint32_t xb = (uint32_t)input_bit(xlo[k], xhi[k], in_bits, i);
      Block vb;
      store_b(clear_ctl(_mm_blendv_epi8(o[k][1], o[k][3], mask_of(xb))),
              vb);
      u128 v_step = grp.from_block(vb);
      v_step = grp.add(v_step, t[k] ? vcwv : (u128)0);
      if (party) v_step = grp.neg(v_step);
      v[k] = grp.add(v[k], v_step);
      s[k] = _mm_blendv_epi8(sl, sr, mask_of(xb));
      t[k] = tl ^ ((tl ^ tr) & (0u - xb));
    }
  }
  for (int k = 0; k < 2; ++k) {
    Block sb;
    store_b(s[k], sb);
    u128 term = grp.from_block(sb);
    if (t[k]) term = grp.add(term, grp.from_block(cws[2 * in_bits + 1]));
    if (party) term = grp.neg(term);
    grp.into_block(grp.add(v[k], term), y_out[k]);
  }
}
#if FSS_HAVE_VAES512
// Four instance-sliced DCF walks (Uint groups <= 64 bits): the four
// schedule chains become four vaesenc chains over 4 instances, the
// value lane runs 4-wide in 64-bit AVX-512 lanes. Bit-identical to
// dcf_eval_aesni_x2.
void dcf_eval_vaes4(const Prg &prg, const Group &grp, int in_bits,
                    int party, const Block &seed, const Block *cws,
                    const uint64_t xlo[4], const uint64_t xhi[4],
                    Block y_out[4]) {
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  const __m512i one512 = _mm512_set1_epi32(1);
  __m512i rkz[4][11];
  for (int m = 0; m < 4; ++m)
    for (int r = 0; r < 11; ++r) rkz[m][r] = bcast_b512(prg.ks[m].rk[r]);
  const bool bytes = grp.kind == 0;
  const uint64_t vmask =
      grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
  const __m256i vmaskv = _mm256_set1_epi64x((long long)vmask);
  const __m256i zero256 = _mm256_setzero_si256();
  const __m512i loq_idx = _mm512_set_epi64(0, 0, 0, 0, 6, 4, 2, 0);
  __m512i S = bcast_b512(clear_ctl(load_b(seed)));
  uint32_t t[4];
  for (int k = 0; k < 4; ++k) t[k] = (uint32_t)party;
  __m256i v256 = zero256;
  __m512i v512 = _mm512_setzero_si512();  // Bytes: 4 XOR value lanes

  for (int i = 0; i < in_bits; ++i) {
    __m512i e0 = _mm512_xor_si512(S, rkz[0][0]);
    __m512i e1 = _mm512_xor_si512(S, rkz[1][0]);
    __m512i e2 = _mm512_xor_si512(S, rkz[2][0]);
    __m512i e3 = _mm512_xor_si512(S, rkz[3][0]);
    for (int rd = 1; rd < 10; ++rd) {
      e0 = _mm512_aesenc_epi128(e0, rkz[0][rd]);
      e1 = _mm512_aesenc_epi128(e1, rkz[1][rd]);
      e2 = _mm512_aesenc_epi128(e2, rkz[2][rd]);
      e3 = _mm512_aesenc_epi128(e3, rkz[3][rd]);
    }
    const __m512i o0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e0, rkz[0][10]), S);
    const __m512i o1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e1, rkz[1][10]), S);
    const __m512i o2 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e2, rkz[2][10]), S);
    const __m512i o3 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e3, rkz[3][10]), S);

    const __m128i cwa = load_b(cws[2 * i]);
    const Block &cwb = cws[2 * i + 1];
    const uint32_t tlcw = lsb_of(cwa);
    const uint32_t trcw = cwb.w[3] & 1u;
    const uint64_t vcw64 =
        ((uint64_t)cwb.w[0] | ((uint64_t)cwb.w[1] << 32)) & vmask;
    const __m256i vcwv = _mm256_set1_epi64x((long long)vcw64);
    const __m512i cwz = bcast_b512(cwa);

    const uint32_t ml = _mm512_test_epi32_mask(o0, one512);
    const uint32_t mr = _mm512_test_epi32_mask(o2, one512);
    uint32_t xb[4];
    for (int k = 0; k < 4; ++k)
      xb[k] = (uint32_t)input_bit(xlo[k], xhi[k], in_bits, i);
    const __mmask16 tm = lane_mask4(t[0], t[1], t[2], t[3]);
    const __mmask16 xbm = lane_mask4(xb[0], xb[1], xb[2], xb[3]);
    const __mmask8 t8 = (__mmask8)(t[0] | (t[1] << 1) | (t[2] << 2) |
                                   (t[3] << 3));
    const __m512i corr =
        _mm512_maskz_mov_epi32(tm, _mm512_andnot_si512(ctl512, cwz));
    const __m512i sl =
        _mm512_xor_si512(_mm512_andnot_si512(ctl512, o0), corr);
    const __m512i sr =
        _mm512_xor_si512(_mm512_andnot_si512(ctl512, o2), corr);

    const __m512i vsel = _mm512_mask_blend_epi32(xbm, o1, o3);
    if (bytes) {
      const __m512i vcwz = bcast_b512(clear_ctl(load_b(cwb)));
      const __m512i corrv = _mm512_maskz_mov_epi32(tm, vcwz);
      v512 = _mm512_xor_si512(
          v512, _mm512_xor_si512(_mm512_andnot_si512(ctl512, vsel),
                                 corrv));
    } else {
      __m256i vq = _mm256_and_si256(
          _mm512_castsi512_si256(
              _mm512_permutexvar_epi64(loq_idx, vsel)),
          vmaskv);
      vq = _mm256_mask_add_epi64(vq, t8, vq, vcwv);
      if (party) vq = _mm256_sub_epi64(zero256, vq);
      v256 = _mm256_add_epi64(v256, vq);
    }

    S = _mm512_mask_blend_epi32(xbm, sl, sr);
    for (int k = 0; k < 4; ++k) {
      const int p = 4 * k + 3;
      const uint32_t tl = ((ml >> p) & 1u) ^ (t[k] & tlcw);
      const uint32_t tr = ((mr >> p) & 1u) ^ (t[k] & trcw);
      t[k] = tl ^ ((tl ^ tr) & (0u - xb[k]));
    }
  }

  Block sf[4];
  store_b(_mm512_castsi512_si128(S), sf[0]);
  store_b(_mm512_extracti32x4_epi32(S, 1), sf[1]);
  store_b(_mm512_extracti32x4_epi32(S, 2), sf[2]);
  store_b(_mm512_extracti32x4_epi32(S, 3), sf[3]);
  if (bytes) {
    const __mmask16 tlm = lane_mask4(t[0], t[1], t[2], t[3]);
    const __m512i vlz = bcast_b512(load_b(cws[2 * in_bits + 1]));
    __m512i term = _mm512_xor_si512(
        _mm512_loadu_si512(sf), _mm512_maskz_mov_epi32(tlm, vlz));
    term = _mm512_xor_si512(term, v512);
    _mm512_storeu_si512(y_out, term);
    return;
  }
  alignas(32) uint64_t v_s[4];
  _mm256_store_si256(reinterpret_cast<__m256i *>(v_s), v256);
  for (int k = 0; k < 4; ++k) {
    u128 term = grp.from_block(sf[k]);
    if (t[k]) term = grp.add(term, grp.from_block(cws[2 * in_bits + 1]));
    if (party) term = grp.neg(term);
    grp.into_block(grp.add((u128)(v_s[k] & vmask), term), y_out[k]);
  }
}
#endif  // FSS_HAVE_VAES512
#endif  // FSS_HAVE_AESNI

void dcf_eval(const Prg &prg, const Group &grp, int in_bits, int party,
              const Block &seed, const Block *cws, uint64_t x_lo,
              uint64_t x_hi, Block &y_out) {
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
    dcf_eval_aesni(prg, grp, in_bits, party, seed, cws, x_lo, x_hi,
                   y_out);
    return;
  }
#endif
  Block s = set_lsb(seed, 0);
  uint32_t t = (uint32_t)party;
  u128 v = 0;
  for (int i = 0; i < in_bits; ++i) {
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = get_lsb(cws[2 * i + 1]);
    u128 v_cw = grp.from_block(set_lsb(cws[2 * i + 1], 0));

    Block o[4];
    prg.gen(s, o);
    uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[2]);
    Block sl = set_lsb(o[0], 0), sr = set_lsb(o[2], 0);
    u128 vl = grp.from_block(set_lsb(o[1], 0));
    u128 vr = grp.from_block(set_lsb(o[3], 0));
    if (t) {
      sl = bxor(sl, s_cw);
      sr = bxor(sr, s_cw);
      tl ^= tl_cw;
      tr ^= tr_cw;
    }
    int xb = input_bit(x_lo, x_hi, in_bits, i);
    u128 v_step = xb ? vr : vl;
    if (t) v_step = grp.add(v_step, v_cw);
    if (party) v_step = grp.neg(v_step);
    v = grp.add(v, v_step);
    s = xb ? sr : sl;
    t = xb ? tr : tl;
  }
  u128 term = grp.from_block(s);
  if (t) term = grp.add(term, grp.from_block(cws[2 * in_bits + 1]));
  if (party) term = grp.neg(term);
  grp.into_block(grp.add(v, term), y_out);
}

void dcf_eval_all(const Prg &prg, const Group &grp, int in_bits,
                  int party, const Block &seed, const Block *cws,
                  Block *ys, Block *vs /* scratch 2^in_bits */) {
  // Breadth-first in-place expansion with value threading
  // (dcf.cuh:294-385): ys holds packed (s,t), vs the running value.
  // For Uint groups <= 64 bits on the AES-NI path the value scratch is
  // PACKED uint64 (one qword per node, half the traffic of Block rows
  // and no compress/spread shuffles in the level body); every consumer
  // below branches on `packed64`.
  bool packed64 = false;
  uint64_t *vs64 = reinterpret_cast<uint64_t *>(vs);
#if FSS_HAVE_AESNI
  packed64 = prg.kind == 1 && grp.kind == 1 && grp.bits <= 64;
#endif
  ys[0] = set_lsb(set_lsb(seed, 0), (uint32_t)party);
  std::memset(vs[0].w, 0, 16);
  for (int i = 0; i < in_bits; ++i) {
    uint64_t m = 1ull << i;
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = get_lsb(cws[2 * i + 1]);
    u128 v_cw = grp.from_block(set_lsb(cws[2 * i + 1], 0));
#if FSS_HAVE_AESNI
    if (prg.kind == 1) {
      // AES-in-register level body; value math branchless (the t branch
      // mispredicts ~50% over random control bits). Uint groups <= 64
      // bits keep the running value in one uint64 instead of the
      // generic u128 Block round trip.
      const __m128i scw = clear_ctl(load_b(cws[2 * i]));
      const bool u64fast = packed64;
      const uint64_t vmask =
          grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
      const uint64_t vcw64 = (uint64_t)v_cw;
      uint64_t j_start = m;
#if FSS_HAVE_VAES512
      if ((u64fast || grp.kind == 0) && m >= 4) {
        // Node-sliced VAES-512 level: 4 nodes ride the four chains (one
        // per schedule); seed children re-interleave with qword
        // permutes, the value lane runs 4-wide in 64-bit AVX-512 lanes
        // (Uint<=64) or as full 128-bit XOR lanes (Bytes).
        const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
        const __m512i one512 = _mm512_set1_epi32(1);
        __m512i rkz[4][11];
        for (int mm = 0; mm < 4; ++mm)
          for (int r = 0; r < 11; ++r)
            rkz[mm][r] = bcast_b512(prg.ks[mm].rk[r]);
        const __m512i scwz = bcast_b512(scw);
        const __m256i vmaskv = _mm256_set1_epi64x((long long)vmask);
        const __m256i vcwv = _mm256_set1_epi64x((long long)vcw64);
        const __m256i zero256 = _mm256_setzero_si256();
        const __m512i loq_idx = _mm512_set_epi64(0, 0, 0, 0, 6, 4, 2, 0);
        // [a0 b0 a1 b1 a2 b2 a3 b3] from the low halves of two zmm.
        const __m512i inter_idx = _mm512_set_epi64(11, 3, 10, 2, 9, 1, 8,
                                                   0);
        const __m512i idxA = _mm512_set_epi64(11, 10, 3, 2, 9, 8, 1, 0);
        const __m512i idxB = _mm512_set_epi64(15, 14, 7, 6, 13, 12, 5,
                                              4);
        const __m512i vcwz =
            bcast_b512(clear_ctl(load_b(cws[2 * i + 1])));
        uint64_t j = m;
        while (j >= 4) {
          j -= 4;
          const __m512i node = _mm512_loadu_si512(ys + j);
          const uint32_t tm = _mm512_test_epi32_mask(node, one512);
          const __m512i sn = _mm512_andnot_si512(ctl512, node);
          __m512i e0 = _mm512_xor_si512(sn, rkz[0][0]);
          __m512i e1 = _mm512_xor_si512(sn, rkz[1][0]);
          __m512i e2 = _mm512_xor_si512(sn, rkz[2][0]);
          __m512i e3 = _mm512_xor_si512(sn, rkz[3][0]);
          for (int rd = 1; rd < 10; ++rd) {
            e0 = _mm512_aesenc_epi128(e0, rkz[0][rd]);
            e1 = _mm512_aesenc_epi128(e1, rkz[1][rd]);
            e2 = _mm512_aesenc_epi128(e2, rkz[2][rd]);
            e3 = _mm512_aesenc_epi128(e3, rkz[3][rd]);
          }
          const __m512i o0 = _mm512_xor_si512(
              _mm512_aesenclast_epi128(e0, rkz[0][10]), sn);
          const __m512i o1 = _mm512_xor_si512(
              _mm512_aesenclast_epi128(e1, rkz[1][10]), sn);
          const __m512i o2 = _mm512_xor_si512(
              _mm512_aesenclast_epi128(e2, rkz[2][10]), sn);
          const __m512i o3 = _mm512_xor_si512(
              _mm512_aesenclast_epi128(e3, rkz[3][10]), sn);

          const uint32_t ml = _mm512_test_epi32_mask(o0, one512);
          const uint32_t mr = _mm512_test_epi32_mask(o2, one512);
          uint32_t t_k[4], tl_k[4], tr_k[4];
          for (int k = 0; k < 4; ++k) {
            const int p = 4 * k + 3;
            t_k[k] = (tm >> p) & 1u;
            tl_k[k] = ((ml >> p) & 1u) ^ (t_k[k] & tl_cw);
            tr_k[k] = ((mr >> p) & 1u) ^ (t_k[k] & tr_cw);
          }
          const __mmask16 t_lanes =
              lane_mask4(t_k[0], t_k[1], t_k[2], t_k[3]);
          const __mmask8 t8 =
              (__mmask8)(t_k[0] | (t_k[1] << 1) | (t_k[2] << 2) |
                         (t_k[3] << 3));
          const __m512i corr = _mm512_maskz_mov_epi32(t_lanes, scwz);
          const __mmask16 ctl_pos = (__mmask16)0x8888;
          const __mmask16 tlm =
              lane_mask4(tl_k[0], tl_k[1], tl_k[2], tl_k[3]) & ctl_pos;
          const __mmask16 trm =
              lane_mask4(tr_k[0], tr_k[1], tr_k[2], tr_k[3]) & ctl_pos;
          __m512i l = _mm512_xor_si512(_mm512_andnot_si512(ctl512, o0),
                                       corr);
          __m512i r = _mm512_xor_si512(_mm512_andnot_si512(ctl512, o2),
                                       corr);
          l = _mm512_mask_or_epi32(l, tlm, l, one512);
          r = _mm512_mask_or_epi32(r, trm, r, one512);
          _mm512_storeu_si512(ys + 2 * j,
                              _mm512_permutex2var_epi64(l, idxA, r));
          _mm512_storeu_si512(ys + 2 * j + 4,
                              _mm512_permutex2var_epi64(l, idxB, r));

          if (!u64fast) {  // Bytes: XOR value lanes, full 128-bit
            const __m512i vsz = _mm512_loadu_si512(vs + j);
            const __m512i corrv =
                _mm512_maskz_mov_epi32(t_lanes, vcwz);
            const __m512i vlz = _mm512_xor_si512(
                vsz, _mm512_xor_si512(
                         _mm512_andnot_si512(ctl512, o1), corrv));
            const __m512i vrz = _mm512_xor_si512(
                vsz, _mm512_xor_si512(
                         _mm512_andnot_si512(ctl512, o3), corrv));
            _mm512_storeu_si512(
                vs + 2 * j, _mm512_permutex2var_epi64(vlz, idxA, vrz));
            _mm512_storeu_si512(
                vs + 2 * j + 4,
                _mm512_permutex2var_epi64(vlz, idxB, vrz));
            continue;
          }
          const __m256i v64v =
              _mm256_loadu_si256((const __m256i *)(vs64 + j));
          __m256i vl = _mm256_and_si256(
              _mm512_castsi512_si256(
                  _mm512_permutexvar_epi64(loq_idx, o1)),
              vmaskv);
          __m256i vr = _mm256_and_si256(
              _mm512_castsi512_si256(
                  _mm512_permutexvar_epi64(loq_idx, o3)),
              vmaskv);
          vl = _mm256_mask_add_epi64(vl, t8, vl, vcwv);
          vr = _mm256_mask_add_epi64(vr, t8, vr, vcwv);
          if (party) {
            vl = _mm256_sub_epi64(zero256, vl);
            vr = _mm256_sub_epi64(zero256, vr);
          }
          const __m256i nl = _mm256_and_si256(_mm256_add_epi64(v64v, vl),
                                              vmaskv);
          const __m256i nr = _mm256_and_si256(_mm256_add_epi64(v64v, vr),
                                              vmaskv);
          _mm512_storeu_si512(
              vs64 + 2 * j,
              _mm512_permutex2var_epi64(_mm512_castsi256_si512(nl),
                                        inter_idx,
                                        _mm512_castsi256_si512(nr)));
        }
        j_start = j;
      }
#endif
      for (uint64_t j = j_start; j-- > 0;) {
        __m128i node = load_b(ys[j]);
        uint32_t t = lsb_of(node);
        __m128i sn = clear_ctl(node);
        __m128i o0 = _mm_xor_si128(sn, prg.ks[0].rk[0]);
        __m128i o1 = _mm_xor_si128(sn, prg.ks[1].rk[0]);
        __m128i o2 = _mm_xor_si128(sn, prg.ks[2].rk[0]);
        __m128i o3 = _mm_xor_si128(sn, prg.ks[3].rk[0]);
        for (int rd = 1; rd < 10; ++rd) {
          o0 = _mm_aesenc_si128(o0, prg.ks[0].rk[rd]);
          o1 = _mm_aesenc_si128(o1, prg.ks[1].rk[rd]);
          o2 = _mm_aesenc_si128(o2, prg.ks[2].rk[rd]);
          o3 = _mm_aesenc_si128(o3, prg.ks[3].rk[rd]);
        }
        o0 = _mm_xor_si128(_mm_aesenclast_si128(o0, prg.ks[0].rk[10]),
                           sn);
        o1 = _mm_xor_si128(_mm_aesenclast_si128(o1, prg.ks[1].rk[10]),
                           sn);
        o2 = _mm_xor_si128(_mm_aesenclast_si128(o2, prg.ks[2].rk[10]),
                           sn);
        o3 = _mm_xor_si128(_mm_aesenclast_si128(o3, prg.ks[3].rk[10]),
                           sn);
        uint32_t tl = lsb_of(o0) ^ (t & tl_cw);
        uint32_t tr = lsb_of(o2) ^ (t & tr_cw);
        __m128i corr = _mm_and_si128(scw, mask_of(t));
        store_b(or_ctl(_mm_xor_si128(clear_ctl(o0), corr), tl),
                ys[2 * j]);
        store_b(or_ctl(_mm_xor_si128(clear_ctl(o2), corr), tr),
                ys[2 * j + 1]);
        if (u64fast) {
          // set_lsb/clear_ctl only touch w[3]; low 64 bits unaffected.
          uint64_t v64 = vs64[j];
          uint64_t vl64 = ((uint64_t)_mm_cvtsi128_si64(o1)) & vmask;
          uint64_t vr64 = ((uint64_t)_mm_cvtsi128_si64(o3)) & vmask;
          uint64_t addv = t ? vcw64 : 0ull;
          vl64 = (vl64 + addv) & vmask;
          vr64 = (vr64 + addv) & vmask;
          if (party) {
            vl64 = (0ull - vl64) & vmask;
            vr64 = (0ull - vr64) & vmask;
          }
          vs64[2 * j] = (v64 + vl64) & vmask;
          vs64[2 * j + 1] = (v64 + vr64) & vmask;
        } else {
          u128 v = grp.from_block(vs[j]);
          Block vlb, vrb;
          store_b(clear_ctl(o1), vlb);
          store_b(clear_ctl(o3), vrb);
          u128 vl = grp.from_block(vlb);
          u128 vr = grp.from_block(vrb);
          u128 addv = t ? v_cw : (u128)0;
          vl = grp.add(vl, addv);
          vr = grp.add(vr, addv);
          if (party) {
            vl = grp.neg(vl);
            vr = grp.neg(vr);
          }
          grp.into_block(grp.add(v, vl), vs[2 * j]);
          grp.into_block(grp.add(v, vr), vs[2 * j + 1]);
        }
      }
      continue;
    }
#endif
    for (uint64_t j = m; j-- > 0;) {
      Block node = ys[j];
      u128 v = grp.from_block(vs[j]);
      uint32_t t = get_lsb(node);
      Block sn = set_lsb(node, 0);
      Block o[4];
      prg.gen(sn, o);
      uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[2]);
      Block sl = set_lsb(o[0], 0), sr = set_lsb(o[2], 0);
      u128 vl = grp.from_block(set_lsb(o[1], 0));
      u128 vr = grp.from_block(set_lsb(o[3], 0));
      if (t) {
        sl = bxor(sl, s_cw);
        sr = bxor(sr, s_cw);
        tl ^= tl_cw;
        tr ^= tr_cw;
        vl = grp.add(vl, v_cw);
        vr = grp.add(vr, v_cw);
      }
      if (party) {
        vl = grp.neg(vl);
        vr = grp.neg(vr);
      }
      ys[2 * j] = set_lsb(sl, tl);
      ys[2 * j + 1] = set_lsb(sr, tr);
      grp.into_block(grp.add(v, vl), vs[2 * j]);
      grp.into_block(grp.add(v, vr), vs[2 * j + 1]);
    }
  }
  u128 v_last = grp.from_block(cws[2 * in_bits + 1]);
  uint64_t n = 1ull << in_bits;
#if FSS_HAVE_VAES512
  if (convert_leaves_vaes(grp, party, cws[2 * in_bits + 1], v_last, ys,
                          vs, n, packed64))
    return;
#endif
  for (uint64_t j = 0; j < n; ++j) {
    uint32_t t = get_lsb(ys[j]);
    u128 term = grp.from_block(set_lsb(ys[j], 0));
    term = grp.add(term, t ? v_last : (u128)0);
    if (party) term = grp.neg(term);
    u128 vj = packed64 ? (u128)vs64[j] : grp.from_block(vs[j]);
    grp.into_block(grp.add(vj, term), ys[j]);
  }
}

// ---------------------------------------------------------------------------
// Half-Tree DPF (half_tree_dpf.cuh semantics; mul=1 CCR hash H(k ^ x))
// ---------------------------------------------------------------------------

struct HtCtx {
  const Prg *prg;
  Block hash_key;

  Block hash(const Block &x) const {
    Block out[1];
    prg->gen(bxor(hash_key, x), out);
    return out[0];
  }
};

#if FSS_HAVE_AESNI
// Register-resident Half-Tree Gen, K keys interleaved: each key's two
// CCR chains stay in XMM (2K AES chains in flight per level — K=1 is
// latency-bound at 2 chains, K>=2 hides the aesenc latency), selects as
// mask blends (half_tree_dpf.cuh:68-169 semantics, bit-exact with the
// scalar path below).
template <int K>
void ht_gen_aesni_k(const HtCtx &ht, const Group &grp, int in_bits,
                    const Block *s0s /* K x 2 seeds */,
                    const uint64_t *a_lo, const uint64_t *a_hi,
                    const Block *betas /* K */, Block *const cwsk[K],
                    Block *ocws /* K */) {
  const AesKeySchedule &ks = ht.prg->ks[0];
  const __m128i hk = load_b(ht.hash_key);
  __m128i n0[K], n1[K];
  for (int k = 0; k < K; ++k) {
    n0[k] = clear_ctl(load_b(s0s[2 * k]));
    n1[k] = or_ctl(clear_ctl(load_b(s0s[2 * k + 1])), 1);
  }
  for (int i = 0; i < in_bits - 1; ++i) {
    __m128i v0[K], v1[K], e0[K], e1[K];
    for (int k = 0; k < K; ++k) {
      v0[k] = _mm_xor_si128(n0[k], hk);
      v1[k] = _mm_xor_si128(n1[k], hk);
      e0[k] = _mm_xor_si128(v0[k], ks.rk[0]);
      e1[k] = _mm_xor_si128(v1[k], ks.rk[0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int k = 0; k < K; ++k) {
        e0[k] = _mm_aesenc_si128(e0[k], ks.rk[rd]);
        e1[k] = _mm_aesenc_si128(e1[k], ks.rk[rd]);
      }
    for (int k = 0; k < K; ++k) {
      __m128i h0 =
          _mm_xor_si128(_mm_aesenclast_si128(e0[k], ks.rk[10]), v0[k]);
      __m128i h1 =
          _mm_xor_si128(_mm_aesenclast_si128(e1[k], ks.rk[10]), v1[k]);
      uint32_t ab =
          (uint32_t)input_bit(a_lo[k], a_hi ? a_hi[k] : 0, in_bits, i);
      uint32_t t0 = lsb_of(n0[k]), t1 = lsb_of(n1[k]);
      __m128i cw = _mm_xor_si128(
          _mm_xor_si128(h0, h1),
          _mm_and_si128(_mm_xor_si128(n0[k], n1[k]), mask_of(ab ^ 1u)));
      store_b(cw, cwsk[k][2 * i]);
      std::memset(cwsk[k][2 * i + 1].w, 0, 16);
      __m128i abm = mask_of(ab);
      n0[k] = _mm_xor_si128(
          h0, _mm_xor_si128(_mm_and_si128(n0[k], abm),
                            _mm_and_si128(cw, mask_of(t0))));
      n1[k] = _mm_xor_si128(
          h1, _mm_xor_si128(_mm_and_si128(n1[k], abm),
                            _mm_and_si128(cw, mask_of(t1))));
    }
  }

  __m128i hh[4 * K];
  {
    __m128i vv[4 * K], ee[4 * K];
    for (int k = 0; k < K; ++k) {
      __m128i nb[4] = {clear_ctl(n0[k]), or_ctl(clear_ctl(n0[k]), 1),
                       clear_ctl(n1[k]), or_ctl(clear_ctl(n1[k]), 1)};
      for (int j = 0; j < 4; ++j) {
        vv[4 * k + j] = _mm_xor_si128(nb[j], hk);
        ee[4 * k + j] = _mm_xor_si128(vv[4 * k + j], ks.rk[0]);
      }
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int j = 0; j < 4 * K; ++j)
        ee[j] = _mm_aesenc_si128(ee[j], ks.rk[rd]);
    for (int j = 0; j < 4 * K; ++j)
      hh[j] = _mm_xor_si128(_mm_aesenclast_si128(ee[j], ks.rk[10]),
                            vv[j]);
  }
  for (int k = 0; k < K; ++k) {
    uint32_t a_n =
        (uint32_t)input_bit(a_lo[k], a_hi ? a_hi[k] : 0, in_bits,
                            in_bits - 1);
    uint32_t t0 = lsb_of(n0[k]), t1 = lsb_of(n1[k]);
    const __m128i h0_0 = hh[4 * k], h0_1 = hh[4 * k + 1];
    const __m128i h1_0 = hh[4 * k + 2], h1_1 = hh[4 * k + 3];
    __m128i anm = mask_of(a_n);
    __m128i hcw = _mm_blendv_epi8(
        clear_ctl(_mm_xor_si128(h0_1, h1_1)),
        clear_ctl(_mm_xor_si128(h0_0, h1_0)), anm);
    uint32_t lcw_0 = lsb_of(h0_0) ^ lsb_of(h1_0) ^ (a_n ^ 1u);
    uint32_t lcw_1 = lsb_of(h0_1) ^ lsb_of(h1_1) ^ a_n;
    store_b(or_ctl(hcw, lcw_0), cwsk[k][2 * (in_bits - 1)]);
    std::memset(cwsk[k][2 * (in_bits - 1) + 1].w, 0, 16);
    cwsk[k][2 * (in_bits - 1) + 1].w[0] = lcw_1;

    __m128i leaf0 = _mm_blendv_epi8(h0_0, h0_1, anm);
    __m128i leaf1 = _mm_blendv_epi8(h1_0, h1_1, anm);
    uint32_t lcw_an = a_n ? lcw_1 : lcw_0;
    __m128i leaf_cw = or_ctl(hcw, lcw_an);
    leaf0 = _mm_xor_si128(leaf0, _mm_and_si128(leaf_cw, mask_of(t0)));
    leaf1 = _mm_xor_si128(leaf1, _mm_and_si128(leaf_cw, mask_of(t1)));
    Block l0b, l1b;
    store_b(leaf0, l0b);
    store_b(leaf1, l1b);
    Block b_buf = set_lsb(betas[k], 0);
    u128 v = grp.add(grp.add(grp.from_block(b_buf),
                             grp.neg(grp.from_block(set_lsb(l0b, 0)))),
                     grp.from_block(set_lsb(l1b, 0)));
    if (get_lsb(l1b)) v = grp.neg(v);
    grp.into_block(v, ocws[k]);
  }
}

void ht_gen_aesni(const HtCtx &ht, const Group &grp, int in_bits,
                  const Block s0s[2], uint64_t a_lo, uint64_t a_hi,
                  const Block &beta, Block *cws, Block &ocw) {
  Block *const cwsk[1] = {cws};
  ht_gen_aesni_k<1>(ht, grp, in_bits, s0s, &a_lo, &a_hi, &beta, cwsk,
                    &ocw);
}

#if FSS_HAVE_VAES512
// Key-sliced VAES-512 Half-Tree Gen: four keys in the four lanes of a
// zmm; the two CCR chains per level become two vaesenc chains and the
// node/CW updates run 4-keys-wide. Bit-identical to ht_gen_aesni_k.
void ht_gen_vaes4(const HtCtx &ht, const Group &grp, int in_bits,
                  const Block *s0s /* 4 x 2 seeds */,
                  const uint64_t *a_lo, const Block *betas /* 4 */,
                  Block *const cwsk[4], Block *ocws /* 4 */) {
  const AesKeySchedule &ks = ht.prg->ks[0];
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  const __m512i one512 = _mm512_set1_epi32(1);
  const __m512i hkz = bcast_b512(load_b(ht.hash_key));
  __m512i rkz[11];
  for (int r = 0; r < 11; ++r) rkz[r] = bcast_b512(ks.rk[r]);

  __m512i N0 = _mm512_castsi128_si512(clear_ctl(load_b(s0s[0])));
  N0 = _mm512_inserti32x4(N0, clear_ctl(load_b(s0s[2])), 1);
  N0 = _mm512_inserti32x4(N0, clear_ctl(load_b(s0s[4])), 2);
  N0 = _mm512_inserti32x4(N0, clear_ctl(load_b(s0s[6])), 3);
  __m512i N1 = _mm512_castsi128_si512(clear_ctl(load_b(s0s[1])));
  N1 = _mm512_inserti32x4(N1, clear_ctl(load_b(s0s[3])), 1);
  N1 = _mm512_inserti32x4(N1, clear_ctl(load_b(s0s[5])), 2);
  N1 = _mm512_inserti32x4(N1, clear_ctl(load_b(s0s[7])), 3);
  N1 = _mm512_or_si512(N1, ctl512);  // party-1 seed carries t=1

  for (int i = 0; i < in_bits - 1; ++i) {
    const __m512i v0 = _mm512_xor_si512(N0, hkz);
    const __m512i v1 = _mm512_xor_si512(N1, hkz);
    __m512i e0 = _mm512_xor_si512(v0, rkz[0]);
    __m512i e1 = _mm512_xor_si512(v1, rkz[0]);
    for (int rd = 1; rd < 10; ++rd) {
      e0 = _mm512_aesenc_epi128(e0, rkz[rd]);
      e1 = _mm512_aesenc_epi128(e1, rkz[rd]);
    }
    const __m512i h0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e0, rkz[10]), v0);
    const __m512i h1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e1, rkz[10]), v1);

    const uint32_t m0 = _mm512_test_epi32_mask(N0, one512);
    const uint32_t m1 = _mm512_test_epi32_mask(N1, one512);
    uint32_t ab[4];
    for (int k = 0; k < 4; ++k)
      ab[k] = (uint32_t)input_bit(a_lo[k], 0, in_bits, i);
    const __mmask16 abm = lane_mask4(ab[0], ab[1], ab[2], ab[3]);
    const __mmask16 nabm = abm ^ (__mmask16)0xFFFF;
    const __mmask16 t0m = lane_mask4((m0 >> 3) & 1u, (m0 >> 7) & 1u,
                                     (m0 >> 11) & 1u, (m0 >> 15) & 1u);
    const __mmask16 t1m = lane_mask4((m1 >> 3) & 1u, (m1 >> 7) & 1u,
                                     (m1 >> 11) & 1u, (m1 >> 15) & 1u);

    const __m512i cwz = _mm512_xor_si512(
        _mm512_xor_si512(h0, h1),
        _mm512_maskz_mov_epi32(nabm, _mm512_xor_si512(N0, N1)));
    store_b(_mm512_castsi512_si128(cwz), cwsk[0][2 * i]);
    store_b(_mm512_extracti32x4_epi32(cwz, 1), cwsk[1][2 * i]);
    store_b(_mm512_extracti32x4_epi32(cwz, 2), cwsk[2][2 * i]);
    store_b(_mm512_extracti32x4_epi32(cwz, 3), cwsk[3][2 * i]);
    for (int k = 0; k < 4; ++k)
      std::memset(cwsk[k][2 * i + 1].w, 0, 16);

    const __m512i keep0 = _mm512_maskz_mov_epi32(abm, N0);
    const __m512i keep1 = _mm512_maskz_mov_epi32(abm, N1);
    __m512i n0n = _mm512_xor_si512(h0, keep0);
    __m512i n1n = _mm512_xor_si512(h1, keep1);
    N0 = _mm512_mask_xor_epi32(n0n, t0m, n0n, cwz);
    N1 = _mm512_mask_xor_epi32(n1n, t1m, n1n, cwz);
  }

  // Last level: 4 hashes per key = 4 key-sliced chains, then the scalar
  // tail per key (identical to ht_gen_aesni_k's).
  __m512i nb[4], vv[4], ee[4], hhz[4];
  nb[0] = _mm512_andnot_si512(ctl512, N0);
  nb[1] = _mm512_or_si512(nb[0], ctl512);
  nb[2] = _mm512_andnot_si512(ctl512, N1);
  nb[3] = _mm512_or_si512(nb[2], ctl512);
  for (int j = 0; j < 4; ++j) {
    vv[j] = _mm512_xor_si512(nb[j], hkz);
    ee[j] = _mm512_xor_si512(vv[j], rkz[0]);
  }
  for (int rd = 1; rd < 10; ++rd)
    for (int j = 0; j < 4; ++j)
      ee[j] = _mm512_aesenc_epi128(ee[j], rkz[rd]);
  for (int j = 0; j < 4; ++j)
    hhz[j] = _mm512_xor_si512(_mm512_aesenclast_epi128(ee[j], rkz[10]),
                              vv[j]);

  const uint32_t m0f = _mm512_test_epi32_mask(N0, one512);
  const uint32_t m1f = _mm512_test_epi32_mask(N1, one512);
  for (int k = 0; k < 4; ++k) {
    __m128i hh[4];
    switch (k) {
      case 0:
        for (int j = 0; j < 4; ++j)
          hh[j] = _mm512_castsi512_si128(hhz[j]);
        break;
      case 1:
        for (int j = 0; j < 4; ++j)
          hh[j] = _mm512_extracti32x4_epi32(hhz[j], 1);
        break;
      case 2:
        for (int j = 0; j < 4; ++j)
          hh[j] = _mm512_extracti32x4_epi32(hhz[j], 2);
        break;
      default:
        for (int j = 0; j < 4; ++j)
          hh[j] = _mm512_extracti32x4_epi32(hhz[j], 3);
    }
    const uint32_t a_n =
        (uint32_t)input_bit(a_lo[k], 0, in_bits, in_bits - 1);
    const uint32_t t0 = (m0f >> (4 * k + 3)) & 1u;
    const uint32_t t1 = (m1f >> (4 * k + 3)) & 1u;
    const __m128i h0_0 = hh[0], h0_1 = hh[1], h1_0 = hh[2], h1_1 = hh[3];
    __m128i anm = mask_of(a_n);
    __m128i hcw = _mm_blendv_epi8(
        clear_ctl(_mm_xor_si128(h0_1, h1_1)),
        clear_ctl(_mm_xor_si128(h0_0, h1_0)), anm);
    uint32_t lcw_0 = lsb_of(h0_0) ^ lsb_of(h1_0) ^ (a_n ^ 1u);
    uint32_t lcw_1 = lsb_of(h0_1) ^ lsb_of(h1_1) ^ a_n;
    store_b(or_ctl(hcw, lcw_0), cwsk[k][2 * (in_bits - 1)]);
    std::memset(cwsk[k][2 * (in_bits - 1) + 1].w, 0, 16);
    cwsk[k][2 * (in_bits - 1) + 1].w[0] = lcw_1;

    __m128i leaf0 = _mm_blendv_epi8(h0_0, h0_1, anm);
    __m128i leaf1 = _mm_blendv_epi8(h1_0, h1_1, anm);
    uint32_t lcw_an = a_n ? lcw_1 : lcw_0;
    __m128i leaf_cw = or_ctl(hcw, lcw_an);
    leaf0 = _mm_xor_si128(leaf0, _mm_and_si128(leaf_cw, mask_of(t0)));
    leaf1 = _mm_xor_si128(leaf1, _mm_and_si128(leaf_cw, mask_of(t1)));
    Block l0b, l1b;
    store_b(leaf0, l0b);
    store_b(leaf1, l1b);
    Block b_buf = set_lsb(betas[k], 0);
    u128 v = grp.add(grp.add(grp.from_block(b_buf),
                             grp.neg(grp.from_block(set_lsb(l0b, 0)))),
                     grp.from_block(set_lsb(l1b, 0)));
    if (get_lsb(l1b)) v = grp.neg(v);
    grp.into_block(v, ocws[k]);
  }
}
#endif  // FSS_HAVE_VAES512
#endif  // FSS_HAVE_AESNI

void ht_gen(const HtCtx &ht, const Group &grp, int in_bits,
            const Block s0s[2], uint64_t a_lo, uint64_t a_hi,
            const Block &beta, Block *cws /* in_bits x 2 blocks */,
            Block &ocw) {
#if FSS_HAVE_AESNI
  if (ht.prg->kind == 1) {
    ht_gen_aesni(ht, grp, in_bits, s0s, a_lo, a_hi, beta, cws, ocw);
    return;
  }
#endif
  Block b_buf = set_lsb(beta, 0);
  Block n0 = set_lsb(s0s[0], 0);
  Block n1 = set_lsb(s0s[1], 1);

  for (int i = 0; i < in_bits - 1; ++i) {
    Block h0, h1;
#if FSS_HAVE_AESNI
    if (ht.prg->kind == 1) {
      // Two CCR hashes per level: interleave the AES chains.
      const AesKeySchedule &ks = ht.prg->ks[0];
      __m128i hk = load_b(ht.hash_key);
      __m128i v0 = _mm_xor_si128(load_b(n0), hk);
      __m128i v1 = _mm_xor_si128(load_b(n1), hk);
      __m128i e0 = _mm_xor_si128(v0, ks.rk[0]);
      __m128i e1 = _mm_xor_si128(v1, ks.rk[0]);
      for (int rd = 1; rd < 10; ++rd) {
        e0 = _mm_aesenc_si128(e0, ks.rk[rd]);
        e1 = _mm_aesenc_si128(e1, ks.rk[rd]);
      }
      store_b(_mm_xor_si128(_mm_aesenclast_si128(e0, ks.rk[10]), v0),
              h0);
      store_b(_mm_xor_si128(_mm_aesenclast_si128(e1, ks.rk[10]), v1),
              h1);
    } else {
      h0 = ht.hash(n0);
      h1 = ht.hash(n1);
    }
#else
    h0 = ht.hash(n0);
    h1 = ht.hash(n1);
#endif
    // Branchless epilogue (alpha/control bits are random; branches here
    // mispredict ~50%).
    uint32_t ab = (uint32_t)input_bit(a_lo, a_hi, in_bits, i);
    uint32_t nabm = 0u - (ab ^ 1u);
    uint32_t t0 = get_lsb(n0), t1 = get_lsb(n1);
    uint32_t abm = 0u - ab, t0m = 0u - t0, t1m = 0u - t1;
    Block cw;
    for (int w = 0; w < 4; ++w)
      cw.w[w] = h0.w[w] ^ h1.w[w] ^ ((n0.w[w] ^ n1.w[w]) & nabm);
    cws[2 * i] = cw;
    std::memset(cws[2 * i + 1].w, 0, 16);
    Block nn0, nn1;
    for (int w = 0; w < 4; ++w) {
      nn0.w[w] = h0.w[w] ^ (n0.w[w] & abm) ^ (cw.w[w] & t0m);
      nn1.w[w] = h1.w[w] ^ (n1.w[w] & abm) ^ (cw.w[w] & t1m);
    }
    n0 = nn0;
    n1 = nn1;
  }

  int a_n = input_bit(a_lo, a_hi, in_bits, in_bits - 1);
  uint32_t t0 = get_lsb(n0), t1 = get_lsb(n1);
  Block h0_0, h0_1, h1_0, h1_1;
#if FSS_HAVE_AESNI
  if (ht.prg->kind == 1) {  // 4 sigma-hashes: interleave the chains
    const AesKeySchedule &ks = ht.prg->ks[0];
    __m128i hk = load_b(ht.hash_key);
    Block nb[4] = {set_lsb(n0, 0), set_lsb(n0, 1), set_lsb(n1, 0),
                   set_lsb(n1, 1)};
    Block *outp[4] = {&h0_0, &h0_1, &h1_0, &h1_1};
    __m128i vv[4], ee[4];
    for (int k = 0; k < 4; ++k) {
      vv[k] = _mm_xor_si128(load_b(nb[k]), hk);
      ee[k] = _mm_xor_si128(vv[k], ks.rk[0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int k = 0; k < 4; ++k)
        ee[k] = _mm_aesenc_si128(ee[k], ks.rk[rd]);
    for (int k = 0; k < 4; ++k)
      store_b(_mm_xor_si128(_mm_aesenclast_si128(ee[k], ks.rk[10]),
                            vv[k]),
              *outp[k]);
  } else {
    h0_0 = ht.hash(set_lsb(n0, 0));
    h0_1 = ht.hash(set_lsb(n0, 1));
    h1_0 = ht.hash(set_lsb(n1, 0));
    h1_1 = ht.hash(set_lsb(n1, 1));
  }
#else
  h0_0 = ht.hash(set_lsb(n0, 0));
  h0_1 = ht.hash(set_lsb(n0, 1));
  h1_0 = ht.hash(set_lsb(n1, 0));
  h1_1 = ht.hash(set_lsb(n1, 1));
#endif
  Block hcw = a_n ? bxor(set_lsb(h0_0, 0), set_lsb(h1_0, 0))
                  : bxor(set_lsb(h0_1, 0), set_lsb(h1_1, 0));
  uint32_t lcw_0 = get_lsb(h0_0) ^ get_lsb(h1_0) ^ (uint32_t)(!a_n);
  uint32_t lcw_1 = get_lsb(h0_1) ^ get_lsb(h1_1) ^ (uint32_t)a_n;
  cws[2 * (in_bits - 1)] = set_lsb(hcw, lcw_0);
  std::memset(cws[2 * (in_bits - 1) + 1].w, 0, 16);
  cws[2 * (in_bits - 1) + 1].w[0] = lcw_1;

  Block leaf0 = a_n ? h0_1 : h0_0;
  Block leaf1 = a_n ? h1_1 : h1_0;
  uint32_t lcw_an = a_n ? lcw_1 : lcw_0;
  Block leaf_cw = set_lsb(hcw, lcw_an);
  if (t0) leaf0 = bxor(leaf0, leaf_cw);
  if (t1) leaf1 = bxor(leaf1, leaf_cw);
  u128 v = grp.add(grp.add(grp.from_block(b_buf),
                           grp.neg(grp.from_block(set_lsb(leaf0, 0)))),
                   grp.from_block(set_lsb(leaf1, 0)));
  if (get_lsb(leaf1)) v = grp.neg(v);
  grp.into_block(v, ocw);
}

#if FSS_HAVE_AESNI
// Register-resident CCR walk: one AES-MMO latency chain per level with
// branchless CW application (half_tree_dpf.cuh:182-226 semantics).
void ht_eval_aesni(const HtCtx &ht, const Group &grp, int in_bits,
                   int party, const Block &s0, const Block *cws,
                   const Block &ocw, uint64_t x_lo, uint64_t x_hi,
                   Block &y_out) {
  const __m128i hk = load_b(ht.hash_key);
  __m128i node = or_ctl(clear_ctl(load_b(s0)), (uint32_t)party);
  for (int i = 0; i < in_bits - 1; ++i) {
    uint32_t t = lsb_of(node);
    __m128i x = _mm_xor_si128(node, hk);
    __m128i h = aes_mmo1(ht.prg->ks[0], x);
    uint32_t xb = (uint32_t)input_bit(x_lo, x_hi, in_bits, i);
    __m128i m = _mm_xor_si128(h, _mm_and_si128(node, mask_of(xb)));
    node = _mm_xor_si128(
        m, _mm_and_si128(load_b(cws[2 * i]), mask_of(t)));
  }
  uint32_t x_n = (uint32_t)input_bit(x_lo, x_hi, in_bits, in_bits - 1);
  uint32_t t = lsb_of(node);
  __m128i ns = or_ctl(clear_ctl(node), x_n);
  __m128i h = aes_mmo1(ht.prg->ks[0], _mm_xor_si128(ns, hk));
  const Block &last = cws[2 * (in_bits - 1)];
  __m128i hcw = clear_ctl(load_b(last));
  uint32_t lcw_xn = x_n ? (cws[2 * (in_bits - 1) + 1].w[0] & 1u)
                        : (last.w[3] & 1u);
  uint32_t low = lsb_of(h) ^ (t & lcw_xn);
  __m128i high = _mm_xor_si128(clear_ctl(h),
                               _mm_and_si128(hcw, mask_of(t)));
  Block hb;
  store_b(high, hb);
  u128 y = grp.from_block(hb);
  if (low) y = grp.add(y, grp.from_block(ocw));
  if (party) y = grp.neg(y);
  grp.into_block(y, y_out);
}

// Four interleaved CCR walks (same rationale as dpf_walk_aesni_x4: one
// walk is a single AES latency chain; four keep the pipe full).
void ht_eval_aesni_x4(const HtCtx &ht, const Group &grp, int in_bits,
                      int party, const Block &s0, const Block *cws,
                      const Block &ocw, const uint64_t xlo[4],
                      const uint64_t xhi[4], Block y_out[4]) {
  const __m128i hk = load_b(ht.hash_key);
  const AesKeySchedule &ks = ht.prg->ks[0];
  __m128i n[4];
  for (int k = 0; k < 4; ++k)
    n[k] = or_ctl(clear_ctl(load_b(s0)), (uint32_t)party);
  for (int i = 0; i < in_bits - 1; ++i) {
    const __m128i cw = load_b(cws[2 * i]);
    uint32_t t[4];
    __m128i v[4], e[4];
    for (int k = 0; k < 4; ++k) {
      t[k] = lsb_of(n[k]);
      v[k] = _mm_xor_si128(n[k], hk);
      e[k] = _mm_xor_si128(v[k], ks.rk[0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int k = 0; k < 4; ++k)
        e[k] = _mm_aesenc_si128(e[k], ks.rk[rd]);
    for (int k = 0; k < 4; ++k) {
      __m128i h = _mm_xor_si128(_mm_aesenclast_si128(e[k], ks.rk[10]),
                                v[k]);
      uint32_t xb = (uint32_t)input_bit(xlo[k], xhi[k], in_bits, i);
      __m128i m = _mm_xor_si128(h, _mm_and_si128(n[k], mask_of(xb)));
      n[k] = _mm_xor_si128(m, _mm_and_si128(cw, mask_of(t[k])));
    }
  }
  const Block &last = cws[2 * (in_bits - 1)];
  const __m128i hcw = clear_ctl(load_b(last));
  const uint32_t lcw0 = last.w[3] & 1u;
  const uint32_t lcw1 = cws[2 * (in_bits - 1) + 1].w[0] & 1u;
  for (int k = 0; k < 4; ++k) {
    uint32_t x_n =
        (uint32_t)input_bit(xlo[k], xhi[k], in_bits, in_bits - 1);
    uint32_t t = lsb_of(n[k]);
    __m128i ns = or_ctl(clear_ctl(n[k]), x_n);
    __m128i h = aes_mmo1(ks, _mm_xor_si128(ns, hk));
    uint32_t lcw_xn = x_n ? lcw1 : lcw0;
    uint32_t low = lsb_of(h) ^ (t & lcw_xn);
    __m128i high = _mm_xor_si128(clear_ctl(h),
                                 _mm_and_si128(hcw, mask_of(t)));
    Block hb;
    store_b(high, hb);
    u128 y = grp.from_block(hb);
    if (low) y = grp.add(y, grp.from_block(ocw));
    if (party) y = grp.neg(y);
    grp.into_block(y, y_out[k]);
  }
}

#if FSS_HAVE_VAES512
// Sixteen instance-sliced CCR walks: four vaesenc chains of four
// instances each (one AES block per level per instance). Bit-identical
// to ht_eval_aesni_x4.
void ht_eval_vaes16(const HtCtx &ht, const Group &grp, int in_bits,
                    int party, const Block &s0, const Block *cws,
                    const Block &ocw, const uint64_t xlo[16],
                    const uint64_t xhi[16], Block y_out[16]) {
  const __m512i hkz = bcast_b512(load_b(ht.hash_key));
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  const __m512i one512 = _mm512_set1_epi32(1);
  const AesKeySchedule &ks = ht.prg->ks[0];
  __m512i rkz[11];
  for (int r = 0; r < 11; ++r) rkz[r] = bcast_b512(ks.rk[r]);
  const __m128i seed128 =
      or_ctl(clear_ctl(load_b(s0)), (uint32_t)party);
  __m512i N[4];
  for (int g = 0; g < 4; ++g) N[g] = bcast_b512(seed128);

  for (int i = 0; i < in_bits - 1; ++i) {
    const __m512i cwz = bcast_b512(load_b(cws[2 * i]));
    uint32_t tmask[4];
    __m512i V[4], E[4];
    for (int g = 0; g < 4; ++g) {
      tmask[g] = _mm512_test_epi32_mask(N[g], one512);
      V[g] = _mm512_xor_si512(N[g], hkz);
      E[g] = _mm512_xor_si512(V[g], rkz[0]);
    }
    for (int rd = 1; rd < 10; ++rd)
      for (int g = 0; g < 4; ++g)
        E[g] = _mm512_aesenc_epi128(E[g], rkz[rd]);
    for (int g = 0; g < 4; ++g) {
      const __m512i H = _mm512_xor_si512(
          _mm512_aesenclast_epi128(E[g], rkz[10]), V[g]);
      uint32_t xb[4];
      for (int k = 0; k < 4; ++k)
        xb[k] = (uint32_t)input_bit(xlo[4 * g + k], xhi[4 * g + k],
                                    in_bits, i);
      const __mmask16 xbm = lane_mask4(xb[0], xb[1], xb[2], xb[3]);
      const int p3 = 3;
      const __mmask16 tm = lane_mask4(
          (tmask[g] >> p3) & 1u, (tmask[g] >> (p3 + 4)) & 1u,
          (tmask[g] >> (p3 + 8)) & 1u, (tmask[g] >> (p3 + 12)) & 1u);
      const __m512i M =
          _mm512_xor_si512(H, _mm512_maskz_mov_epi32(xbm, N[g]));
      N[g] = _mm512_xor_si512(M, _mm512_maskz_mov_epi32(tm, cwz));
    }
  }

  // Last level: one more hash per instance, then the scalar finalize.
  const Block &last = cws[2 * (in_bits - 1)];
  const __m128i hcw = clear_ctl(load_b(last));
  const uint32_t lcw0 = last.w[3] & 1u;
  const uint32_t lcw1 = cws[2 * (in_bits - 1) + 1].w[0] & 1u;
  for (int g = 0; g < 4; ++g) {
    uint32_t x_n[4];
    for (int k = 0; k < 4; ++k)
      x_n[k] = (uint32_t)input_bit(xlo[4 * g + k], xhi[4 * g + k],
                                   in_bits, in_bits - 1);
    const uint32_t tmask = _mm512_test_epi32_mask(N[g], one512);
    const __mmask16 xnm =
        lane_mask4(x_n[0], x_n[1], x_n[2], x_n[3]) & (__mmask16)0x8888;
    const __m512i NS = _mm512_mask_or_epi32(
        _mm512_andnot_si512(ctl512, N[g]), xnm,
        _mm512_andnot_si512(ctl512, N[g]), one512);
    const __m512i V = _mm512_xor_si512(NS, hkz);
    __m512i E = _mm512_xor_si512(V, rkz[0]);
    for (int rd = 1; rd < 10; ++rd)
      E = _mm512_aesenc_epi128(E, rkz[rd]);
    const __m512i H =
        _mm512_xor_si512(_mm512_aesenclast_epi128(E, rkz[10]), V);
    __m128i hl[4];
    hl[0] = _mm512_castsi512_si128(H);
    hl[1] = _mm512_extracti32x4_epi32(H, 1);
    hl[2] = _mm512_extracti32x4_epi32(H, 2);
    hl[3] = _mm512_extracti32x4_epi32(H, 3);
    for (int k = 0; k < 4; ++k) {
      const uint32_t t = (tmask >> (4 * k + 3)) & 1u;
      const uint32_t lcw_xn = x_n[k] ? lcw1 : lcw0;
      const uint32_t low = lsb_of(hl[k]) ^ (t & lcw_xn);
      const __m128i high = _mm_xor_si128(
          clear_ctl(hl[k]), _mm_and_si128(hcw, mask_of(t)));
      Block hb;
      store_b(high, hb);
      u128 y = grp.from_block(hb);
      if (low) y = grp.add(y, grp.from_block(ocw));
      if (party) y = grp.neg(y);
      grp.into_block(y, y_out[4 * g + k]);
    }
  }
}
#endif  // FSS_HAVE_VAES512

// Phase-1 level expansion of ht_eval_all, AES in registers.
void ht_expand_level_aesni_x1(const HtCtx &ht, Block *ys, uint64_t m,
                              const Block &cw) {
  const __m128i hk = load_b(ht.hash_key);
  const __m128i cwv = load_b(cw);
  for (uint64_t j = m; j-- > 0;) {
    __m128i node = load_b(ys[j]);
    uint32_t t = lsb_of(node);
    __m128i h = aes_mmo1(ht.prg->ks[0], _mm_xor_si128(node, hk));
    __m128i left = _mm_xor_si128(h, _mm_and_si128(cwv, mask_of(t)));
    store_b(left, ys[2 * j]);
    store_b(_mm_xor_si128(left, node), ys[2 * j + 1]);
  }
}

#if FSS_HAVE_VAES512
// Node-sliced VAES-512 Half-Tree level: 8 nodes per iteration on two
// vaesenc chains; children re-interleave with qword permutes.
// Bit-identical to the x1 loop above.
void ht_expand_level_vaes(const HtCtx &ht, Block *ys, uint64_t m,
                          const Block &cw) {
  const __m512i one512 = _mm512_set1_epi32(1);
  const __m512i hkz = bcast_b512(load_b(ht.hash_key));
  const __m512i cwz = bcast_b512(load_b(cw));
  __m512i rkz[11];
  for (int r = 0; r < 11; ++r)
    rkz[r] = bcast_b512(ht.prg->ks[0].rk[r]);
  const __m512i idxA = _mm512_set_epi64(11, 10, 3, 2, 9, 8, 1, 0);
  const __m512i idxB = _mm512_set_epi64(15, 14, 7, 6, 13, 12, 5, 4);

  uint64_t j = m;
  while (j >= 8) {
    j -= 8;
    const __m512i n0 = _mm512_loadu_si512(ys + j);
    const __m512i n1 = _mm512_loadu_si512(ys + j + 4);
    const uint32_t tm0 = _mm512_test_epi32_mask(n0, one512);
    const uint32_t tm1 = _mm512_test_epi32_mask(n1, one512);
    const __m512i v0 = _mm512_xor_si512(n0, hkz);
    const __m512i v1 = _mm512_xor_si512(n1, hkz);
    __m512i e0 = _mm512_xor_si512(v0, rkz[0]);
    __m512i e1 = _mm512_xor_si512(v1, rkz[0]);
    for (int rd = 1; rd < 10; ++rd) {
      e0 = _mm512_aesenc_epi128(e0, rkz[rd]);
      e1 = _mm512_aesenc_epi128(e1, rkz[rd]);
    }
    const __m512i h0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e0, rkz[10]), v0);
    const __m512i h1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e1, rkz[10]), v1);
    const __mmask16 t0l = lane_mask4((tm0 >> 3) & 1u, (tm0 >> 7) & 1u,
                                     (tm0 >> 11) & 1u, (tm0 >> 15) & 1u);
    const __mmask16 t1l = lane_mask4((tm1 >> 3) & 1u, (tm1 >> 7) & 1u,
                                     (tm1 >> 11) & 1u, (tm1 >> 15) & 1u);
    const __m512i l0 =
        _mm512_xor_si512(h0, _mm512_maskz_mov_epi32(t0l, cwz));
    const __m512i l1 =
        _mm512_xor_si512(h1, _mm512_maskz_mov_epi32(t1l, cwz));
    const __m512i r0 = _mm512_xor_si512(l0, n0);
    const __m512i r1 = _mm512_xor_si512(l1, n1);
    _mm512_storeu_si512(ys + 2 * j,
                        _mm512_permutex2var_epi64(l0, idxA, r0));
    _mm512_storeu_si512(ys + 2 * j + 4,
                        _mm512_permutex2var_epi64(l0, idxB, r0));
    _mm512_storeu_si512(ys + 2 * j + 8,
                        _mm512_permutex2var_epi64(l1, idxA, r1));
    _mm512_storeu_si512(ys + 2 * j + 12,
                        _mm512_permutex2var_epi64(l1, idxB, r1));
  }
  if (j) ht_expand_level_aesni_x1(ht, ys, j, cw);
}

// Vectorized HT last-level conversion: 4 nodes per iteration, the two
// per-node CCR hashes (x_n = 0, 1) as two 4-wide VAES chains, the
// group conversion fused in-register (the scalar loop's per-leaf hash +
// u128 round trip was ~85% of HT EvalAll's wall time at 2^20). Covers
// Bytes and Uint<=64; returns false for other groups.
bool ht_last_level_vaes(const HtCtx &ht, const Group &grp, int party,
                        const Block &hcw, uint32_t lcw0, uint32_t lcw1,
                        const Block &ocw_b, u128 ocw, Block *ys,
                        uint64_t half) {
  if (half < 4 || (half & 3u)) return false;
  const bool bytes = grp.kind == 0;
  const bool u64f = grp.kind == 1 && grp.bits <= 64;
  if (!bytes && !u64f) return false;
  const __m512i one512 = _mm512_set1_epi32(1);
  const __m512i ctl512 = bcast_b512(_mm_set_epi32(1, 0, 0, 0));
  const __m512i hkz = bcast_b512(load_b(ht.hash_key));
  const __m512i hcwz = bcast_b512(load_b(hcw));  // ctl already clear
  __m512i rkz[11];
  for (int r = 0; r < 11; ++r)
    rkz[r] = bcast_b512(ht.prg->ks[0].rk[r]);
  const uint64_t vmask =
      grp.bits >= 64 ? ~0ull : ((1ull << grp.bits) - 1);
  const __m256i vmaskv = _mm256_set1_epi64x((long long)vmask);
  const __m256i ocwv = _mm256_set1_epi64x((long long)(uint64_t)ocw);
  const __m256i zero256 = _mm256_setzero_si256();
  const __m512i loq_idx = _mm512_set_epi64(0, 0, 0, 0, 6, 4, 2, 0);
  const __m512i ileave0 = _mm512_set_epi64(0, 9, 0, 1, 0, 8, 0, 0);
  const __m512i ileave1 = _mm512_set_epi64(0, 11, 0, 3, 0, 10, 0, 2);
  const __m512i ocwz = bcast_b512(load_b(ocw_b));
  const __m512i idxA = _mm512_set_epi64(11, 10, 3, 2, 9, 8, 1, 0);
  const __m512i idxB = _mm512_set_epi64(15, 14, 7, 6, 13, 12, 5, 4);

  uint64_t j = half;
  while (j >= 4) {
    j -= 4;
    const __m512i node = _mm512_loadu_si512(ys + j);
    const uint32_t tm = _mm512_test_epi32_mask(node, one512);
    uint32_t t_k[4];
    for (int k = 0; k < 4; ++k) t_k[k] = (tm >> (4 * k + 3)) & 1u;
    const __m512i base = _mm512_andnot_si512(ctl512, node);
    const __m512i v0 = _mm512_xor_si512(base, hkz);
    const __m512i v1 =
        _mm512_xor_si512(_mm512_or_si512(base, ctl512), hkz);
    __m512i e0 = _mm512_xor_si512(v0, rkz[0]);
    __m512i e1 = _mm512_xor_si512(v1, rkz[0]);
    for (int rd = 1; rd < 10; ++rd) {
      e0 = _mm512_aesenc_epi128(e0, rkz[rd]);
      e1 = _mm512_aesenc_epi128(e1, rkz[rd]);
    }
    const __m512i h0 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e0, rkz[10]), v0);
    const __m512i h1 =
        _mm512_xor_si512(_mm512_aesenclast_epi128(e1, rkz[10]), v1);
    const __mmask16 tl = lane_mask4(t_k[0], t_k[1], t_k[2], t_k[3]);
    const __m512i corr = _mm512_maskz_mov_epi32(tl, hcwz);
    const __m512i hi0 =
        _mm512_andnot_si512(ctl512, _mm512_xor_si512(h0, corr));
    const __m512i hi1 =
        _mm512_andnot_si512(ctl512, _mm512_xor_si512(h1, corr));
    const uint32_t m0 = _mm512_test_epi32_mask(h0, one512);
    const uint32_t m1 = _mm512_test_epi32_mask(h1, one512);
    uint32_t lo0[4], lo1[4];
    for (int k = 0; k < 4; ++k) {
      lo0[k] = ((m0 >> (4 * k + 3)) & 1u) ^ (t_k[k] & lcw0);
      lo1[k] = ((m1 >> (4 * k + 3)) & 1u) ^ (t_k[k] & lcw1);
    }
    if (bytes) {
      const __mmask16 l0m = lane_mask4(lo0[0], lo0[1], lo0[2], lo0[3]);
      const __mmask16 l1m = lane_mask4(lo1[0], lo1[1], lo1[2], lo1[3]);
      const __m512i y0 =
          _mm512_xor_si512(hi0, _mm512_maskz_mov_epi32(l0m, ocwz));
      const __m512i y1 =
          _mm512_xor_si512(hi1, _mm512_maskz_mov_epi32(l1m, ocwz));
      _mm512_storeu_si512(ys + 2 * j,
                          _mm512_permutex2var_epi64(y0, idxA, y1));
      _mm512_storeu_si512(ys + 2 * j + 4,
                          _mm512_permutex2var_epi64(y0, idxB, y1));
    } else {
      const __mmask8 lo0m =
          (__mmask8)(lo0[0] | (lo0[1] << 1) | (lo0[2] << 2) |
                     (lo0[3] << 3));
      const __mmask8 lo1m =
          (__mmask8)(lo1[0] | (lo1[1] << 1) | (lo1[2] << 2) |
                     (lo1[3] << 3));
      __m256i a = _mm256_and_si256(
          _mm512_castsi512_si256(
              _mm512_permutexvar_epi64(loq_idx, hi0)),
          vmaskv);
      __m256i b = _mm256_and_si256(
          _mm512_castsi512_si256(
              _mm512_permutexvar_epi64(loq_idx, hi1)),
          vmaskv);
      a = _mm256_mask_add_epi64(a, lo0m, a, ocwv);
      b = _mm256_mask_add_epi64(b, lo1m, b, ocwv);
      if (party) {
        a = _mm256_sub_epi64(zero256, a);
        b = _mm256_sub_epi64(zero256, b);
      }
      a = _mm256_and_si256(a, vmaskv);
      b = _mm256_and_si256(b, vmaskv);
      const __m512i az = _mm512_castsi256_si512(a);
      const __m512i bz = _mm512_castsi256_si512(b);
      _mm512_storeu_si512(
          ys + 2 * j,
          _mm512_maskz_permutex2var_epi64((__mmask8)0x55, az, ileave0,
                                          bz));
      _mm512_storeu_si512(
          ys + 2 * j + 4,
          _mm512_maskz_permutex2var_epi64((__mmask8)0x55, az, ileave1,
                                          bz));
    }
  }
  return true;
}
#endif  // FSS_HAVE_VAES512

inline void ht_expand_level_aesni(const HtCtx &ht, Block *ys, uint64_t m,
                                  const Block &cw) {
#if FSS_HAVE_VAES512
  ht_expand_level_vaes(ht, ys, m, cw);
#else
  ht_expand_level_aesni_x1(ht, ys, m, cw);
#endif
}
#endif  // FSS_HAVE_AESNI

void ht_eval(const HtCtx &ht, const Group &grp, int in_bits, int party,
             const Block &s0, const Block *cws, const Block &ocw,
             uint64_t x_lo, uint64_t x_hi, Block &y_out) {
#if FSS_HAVE_AESNI
  if (ht.prg->kind == 1) {
    ht_eval_aesni(ht, grp, in_bits, party, s0, cws, ocw, x_lo, x_hi,
                  y_out);
    return;
  }
#endif
  Block node = set_lsb(s0, (uint32_t)party);
  for (int i = 0; i < in_bits - 1; ++i) {
    int xb = input_bit(x_lo, x_hi, in_bits, i);
    uint32_t t = get_lsb(node);
    Block h = ht.hash(node);
    Block m = xb ? bxor(h, node) : h;
    node = t ? bxor(m, cws[2 * i]) : m;
  }
  int x_n = input_bit(x_lo, x_hi, in_bits, in_bits - 1);
  uint32_t t = get_lsb(node);
  Block h = ht.hash(set_lsb(node, (uint32_t)x_n));
  const Block &last = cws[2 * (in_bits - 1)];
  Block hcw = set_lsb(last, 0);
  uint32_t lcw_xn = x_n ? (cws[2 * (in_bits - 1) + 1].w[0] & 1u)
                        : get_lsb(last);
  Block high = set_lsb(h, 0);
  uint32_t low = get_lsb(h);
  if (t) {
    high = bxor(high, hcw);
    low ^= lcw_xn;
  }
  u128 y = grp.from_block(high);
  if (low) y = grp.add(y, grp.from_block(ocw));
  if (party) y = grp.neg(y);
  grp.into_block(y, y_out);
}

void ht_eval_all(const HtCtx &ht, const Group &grp, int in_bits, int party,
                 const Block &s0, const Block *cws, const Block &ocw,
                 Block *ys) {
  // Phase 1: breadth-first expand to level n-1 (2^(n-1) nodes, t in the
  // LSB of each node), in place back-to-front; the left child shares its
  // parent's hash with the right (half_tree_dpf.cuh:241-276 semantics,
  // flattened like dpf_eval_all above).
  ys[0] = set_lsb(s0, (uint32_t)party);
  for (int i = 0; i < in_bits - 1; ++i) {
    uint64_t m = 1ull << i;
    const Block &cw = cws[2 * i];
#if FSS_HAVE_AESNI
    if (ht.prg->kind == 1) {
      ht_expand_level_aesni(ht, ys, m, cw);
      continue;
    }
#endif
    for (uint64_t j = m; j-- > 0;) {
      Block node = ys[j];
      uint32_t t = get_lsb(node);
      Block h = ht.hash(node);
      Block left = t ? bxor(h, cw) : h;
      ys[2 * j] = left;
      ys[2 * j + 1] = bxor(left, node);
    }
  }
  // Phase 2: backward in-place last-level conversion, 2 leaves per node.
  const Block &last = cws[2 * (in_bits - 1)];
  Block hcw = set_lsb(last, 0);
  uint32_t lcw0 = get_lsb(last);
  uint32_t lcw1 = cws[2 * (in_bits - 1) + 1].w[0] & 1u;
  u128 ocwv = grp.from_block(ocw);
  uint64_t half = 1ull << (in_bits - 1);
#if FSS_HAVE_VAES512
  if (ht.prg->kind == 1 &&
      ht_last_level_vaes(ht, grp, party, hcw, lcw0, lcw1, ocw, ocwv, ys,
                         half))
    return;
#endif
  for (uint64_t j = half; j-- > 0;) {
    Block node = ys[j];
    uint32_t t = get_lsb(node);
    for (int x_n = 1; x_n >= 0; --x_n) {
      Block h = ht.hash(set_lsb(node, (uint32_t)x_n));
      uint32_t tm = 0u - t;
      Block high;
      for (int w = 0; w < 4; ++w) high.w[w] = h.w[w] ^ (hcw.w[w] & tm);
      high.w[3] &= ~1u;
      uint32_t low = (get_lsb(h) ^ (t & (x_n ? lcw1 : lcw0))) & 1u;
      u128 y = grp.from_block(high);
      y = grp.add(y, low ? ocwv : (u128)0);
      if (party) y = grp.neg(y);
      grp.into_block(y, ys[2 * j + x_n]);
    }
  }
}

// ---------------------------------------------------------------------------
// SHA-256 (FIPS 180-4) and BLAKE3 single compression — the keyed hashes
// of hash/sha256.cuh and hash/blake3.cuh.
// ---------------------------------------------------------------------------

const uint32_t kSha256K[64] = {
    0x428a2f98, 0x71374491, 0xb5c0fbcf, 0xe9b5dba5, 0x3956c25b, 0x59f111f1,
    0x923f82a4, 0xab1c5ed5, 0xd807aa98, 0x12835b01, 0x243185be, 0x550c7dc3,
    0x72be5d74, 0x80deb1fe, 0x9bdc06a7, 0xc19bf174, 0xe49b69c1, 0xefbe4786,
    0x0fc19dc6, 0x240ca1cc, 0x2de92c6f, 0x4a7484aa, 0x5cb0a9dc, 0x76f988da,
    0x983e5152, 0xa831c66d, 0xb00327c8, 0xbf597fc7, 0xc6e00bf3, 0xd5a79147,
    0x06ca6351, 0x14292967, 0x27b70a85, 0x2e1b2138, 0x4d2c6dfc, 0x53380d13,
    0x650a7354, 0x766a0abb, 0x81c2c92e, 0x92722c85, 0xa2bfe8a1, 0xa81a664b,
    0xc24b8b70, 0xc76c51a3, 0xd192e819, 0xd6990624, 0xf40e3585, 0x106aa070,
    0x19a4c116, 0x1e376c08, 0x2748774c, 0x34b0bcb5, 0x391c0cb3, 0x4ed8aa4a,
    0x5b9cca4f, 0x682e6ff3, 0x748f82ee, 0x78a5636f, 0x84c87814, 0x8cc70208,
    0x90befffa, 0xa4506ceb, 0xbef9a3f7, 0xc67178f2};

inline uint32_t rotr32(uint32_t x, int n) {
  return (x >> n) | (x << (32 - n));
}

#if defined(__x86_64__)
// SHA-NI compression (one 64B block). Same FIPS 180-4 math as the scalar
// path below; the schedule recurrence is expressed in the extension's
// native 4-word groups: X[g+4] = msg2(msg1(X[g], X[g+1]) +
// alignr(X[g+3], X[g+2], 4), X[g+3]). Runtime-dispatched so the binary
// stays portable to pre-SHA hosts.
__attribute__((target("sha,sse4.1")))
void sha256_block_shani(uint32_t h[8], const uint8_t *p) {
  const __m128i kBswap =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i tmp =
      _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&h[0]), 0xB1);
  __m128i st1 =
      _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&h[4]), 0x1B);
  __m128i st0 = _mm_alignr_epi8(tmp, st1, 8);     // ABEF
  st1 = _mm_blend_epi16(st1, tmp, 0xF0);          // CDGH
  const __m128i abef_save = st0;
  const __m128i cdgh_save = st1;

  __m128i w[4];
  for (int g = 0; g < 4; ++g)
    w[g] = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(p + 16 * g)),
        kBswap);

  for (int g = 0; g < 16; ++g) {
    __m128i msg = _mm_add_epi32(
        w[g & 3],
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(
            &kSha256K[4 * g])));
    st1 = _mm_sha256rnds2_epu32(st1, st0, msg);
    msg = _mm_shuffle_epi32(msg, 0x0E);
    st0 = _mm_sha256rnds2_epu32(st0, st1, msg);
    if (g < 12) {
      __m128i t = _mm_alignr_epi8(w[(g + 3) & 3], w[(g + 2) & 3], 4);
      w[g & 3] = _mm_sha256msg2_epu32(
          _mm_add_epi32(_mm_sha256msg1_epu32(w[g & 3], w[(g + 1) & 3]),
                        t),
          w[(g + 3) & 3]);
    }
  }

  st0 = _mm_add_epi32(st0, abef_save);
  st1 = _mm_add_epi32(st1, cdgh_save);
  tmp = _mm_shuffle_epi32(st0, 0x1B);             // FEBA
  st1 = _mm_shuffle_epi32(st1, 0xB1);             // DCHG
  st0 = _mm_blend_epi16(tmp, st1, 0xF0);          // DCBA
  st1 = _mm_alignr_epi8(st1, tmp, 8);             // HGFE
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&h[0]), st0);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&h[4]), st1);
}

// Two INDEPENDENT blocks interleaved: sha256rnds2 is a long dependent
// chain within one block (~64 rounds at ~4-cycle latency each pair), so
// a second in-flight block rides in the chain's latency shadow nearly
// for free. Bit-identical to two sha256_block_shani calls.
__attribute__((target("sha,sse4.1")))
void sha256_block_shani_x2(uint32_t ha[8], const uint8_t *pa,
                           uint32_t hb[8], const uint8_t *pb) {
  const __m128i kBswap =
      _mm_set_epi64x(0x0c0d0e0f08090a0bULL, 0x0405060700010203ULL);
  __m128i tA =
      _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&ha[0]), 0xB1);
  __m128i a1 =
      _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&ha[4]), 0x1B);
  __m128i a0 = _mm_alignr_epi8(tA, a1, 8);
  a1 = _mm_blend_epi16(a1, tA, 0xF0);
  __m128i tB =
      _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&hb[0]), 0xB1);
  __m128i b1 =
      _mm_shuffle_epi32(_mm_loadu_si128((const __m128i *)&hb[4]), 0x1B);
  __m128i b0 = _mm_alignr_epi8(tB, b1, 8);
  b1 = _mm_blend_epi16(b1, tB, 0xF0);
  const __m128i a0s = a0, a1s = a1, b0s = b0, b1s = b1;

  __m128i wa[4], wb[4];
  for (int g = 0; g < 4; ++g) {
    wa[g] = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(pa + 16 * g)),
        kBswap);
    wb[g] = _mm_shuffle_epi8(
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(pb + 16 * g)),
        kBswap);
  }
  for (int g = 0; g < 16; ++g) {
    const __m128i k = _mm_loadu_si128(
        reinterpret_cast<const __m128i *>(&kSha256K[4 * g]));
    __m128i ma = _mm_add_epi32(wa[g & 3], k);
    __m128i mb = _mm_add_epi32(wb[g & 3], k);
    a1 = _mm_sha256rnds2_epu32(a1, a0, ma);
    b1 = _mm_sha256rnds2_epu32(b1, b0, mb);
    ma = _mm_shuffle_epi32(ma, 0x0E);
    mb = _mm_shuffle_epi32(mb, 0x0E);
    a0 = _mm_sha256rnds2_epu32(a0, a1, ma);
    b0 = _mm_sha256rnds2_epu32(b0, b1, mb);
    if (g < 12) {
      __m128i ta = _mm_alignr_epi8(wa[(g + 3) & 3], wa[(g + 2) & 3], 4);
      wa[g & 3] = _mm_sha256msg2_epu32(
          _mm_add_epi32(_mm_sha256msg1_epu32(wa[g & 3], wa[(g + 1) & 3]),
                        ta),
          wa[(g + 3) & 3]);
      __m128i tb = _mm_alignr_epi8(wb[(g + 3) & 3], wb[(g + 2) & 3], 4);
      wb[g & 3] = _mm_sha256msg2_epu32(
          _mm_add_epi32(_mm_sha256msg1_epu32(wb[g & 3], wb[(g + 1) & 3]),
                        tb),
          wb[(g + 3) & 3]);
    }
  }
  a0 = _mm_add_epi32(a0, a0s);
  a1 = _mm_add_epi32(a1, a1s);
  b0 = _mm_add_epi32(b0, b0s);
  b1 = _mm_add_epi32(b1, b1s);
  tA = _mm_shuffle_epi32(a0, 0x1B);
  a1 = _mm_shuffle_epi32(a1, 0xB1);
  a0 = _mm_blend_epi16(tA, a1, 0xF0);
  a1 = _mm_alignr_epi8(a1, tA, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&ha[0]), a0);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&ha[4]), a1);
  tB = _mm_shuffle_epi32(b0, 0x1B);
  b1 = _mm_shuffle_epi32(b1, 0xB1);
  b0 = _mm_blend_epi16(tB, b1, 0xF0);
  b1 = _mm_alignr_epi8(b1, tB, 8);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&hb[0]), b0);
  _mm_storeu_si128(reinterpret_cast<__m128i *>(&hb[4]), b1);
}
#endif  // __x86_64__

void sha256_block(uint32_t h[8], const uint8_t *p) {
#if defined(__x86_64__)
  static const bool kShani = __builtin_cpu_supports("sha") != 0;
  if (kShani) {
    sha256_block_shani(h, p);
    return;
  }
#endif
  uint32_t w[64];
  for (int i = 0; i < 16; ++i)
    w[i] = ((uint32_t)p[4 * i] << 24) | ((uint32_t)p[4 * i + 1] << 16) |
           ((uint32_t)p[4 * i + 2] << 8) | (uint32_t)p[4 * i + 3];
  for (int i = 16; i < 64; ++i) {
    uint32_t s0 = rotr32(w[i - 15], 7) ^ rotr32(w[i - 15], 18) ^
                  (w[i - 15] >> 3);
    uint32_t s1 = rotr32(w[i - 2], 17) ^ rotr32(w[i - 2], 19) ^
                  (w[i - 2] >> 10);
    w[i] = w[i - 16] + s0 + w[i - 7] + s1;
  }
  uint32_t a = h[0], b = h[1], c = h[2], d = h[3];
  uint32_t e = h[4], f = h[5], g = h[6], hh = h[7];
  for (int i = 0; i < 64; ++i) {
    uint32_t s1 = rotr32(e, 6) ^ rotr32(e, 11) ^ rotr32(e, 25);
    uint32_t ch = (e & f) ^ (~e & g);
    uint32_t t1 = hh + s1 + ch + kSha256K[i] + w[i];
    uint32_t s0 = rotr32(a, 2) ^ rotr32(a, 13) ^ rotr32(a, 22);
    uint32_t maj = (a & b) ^ (a & c) ^ (b & c);
    uint32_t t2 = s0 + maj;
    hh = g; g = f; f = e; e = d + t1; d = c; c = b; b = a; a = t1 + t2;
  }
  h[0] += a; h[1] += b; h[2] += c; h[3] += d;
  h[4] += e; h[5] += f; h[6] += g; h[7] += hh;
}

void sha256_digest(const uint8_t *data, size_t n, uint8_t out[32]) {
  uint32_t h[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372, 0xa54ff53a,
                   0x510e527f, 0x9b05688c, 0x1f83d9ab, 0x5be0cd19};
  size_t full = n / 64;
  for (size_t i = 0; i < full; ++i) sha256_block(h, data + 64 * i);
  uint8_t tail[128];
  size_t rem = n - 64 * full;
  std::memset(tail, 0, sizeof(tail));
  std::memcpy(tail, data + 64 * full, rem);
  tail[rem] = 0x80;
  size_t tail_len = (rem + 9 <= 64) ? 64 : 128;
  uint64_t bits = (uint64_t)n * 8;
  for (int i = 0; i < 8; ++i)
    tail[tail_len - 1 - i] = (uint8_t)(bits >> (8 * i));
  sha256_block(h, tail);
  if (tail_len == 128) sha256_block(h, tail + 64);
  for (int i = 0; i < 8; ++i) {
    out[4 * i] = (uint8_t)(h[i] >> 24);
    out[4 * i + 1] = (uint8_t)(h[i] >> 16);
    out[4 * i + 2] = (uint8_t)(h[i] >> 8);
    out[4 * i + 3] = (uint8_t)h[i];
  }
}

// BLAKE3 single compression, counter 0, flags 0x1B (KEYED_HASH |
// CHUNK_START | CHUNK_END | ROOT), custom 32B IV (blake3.cuh:100-149).
const uint32_t kBlake3Iv0[4] = {0x6A09E667u, 0xBB67AE85u, 0x3C6EF372u,
                                0xA54FF53Au};
const int kBlake3Perm[16] = {2, 6, 3, 10, 7, 0, 4, 13,
                             1, 11, 12, 5, 9, 14, 15, 8};

inline void blake3_g(uint32_t *v, int a, int b, int c, int d, uint32_t x,
                     uint32_t y) {
  v[a] = v[a] + v[b] + x;
  v[d] = rotr32(v[d] ^ v[a], 16);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 12);
  v[a] = v[a] + v[b] + y;
  v[d] = rotr32(v[d] ^ v[a], 8);
  v[c] = v[c] + v[d];
  v[b] = rotr32(v[b] ^ v[c], 7);
}

// Per-round message index schedule (kSched[r][i] = which input word
// feeds slot i in round r) — replaces physically permuting the 64B
// message block every round (2 copies/round in the hot Prove chain).
struct Blake3Sched {
  uint8_t s[7][16];
  Blake3Sched() {
    for (int i = 0; i < 16; ++i) s[0][i] = (uint8_t)i;
    for (int r = 1; r < 7; ++r)
      for (int i = 0; i < 16; ++i)
        s[r][i] = s[r - 1][kBlake3Perm[i]];
  }
};

#if FSS_HAVE_AESNI
// Variable rotates: AVX-512VL's VPRORD is one op on the critical path
// where the shift/shift/or fallback is three.
#if FSS_HAVE_VAES512
#define FSS_B3_ROR12(x) _mm_ror_epi32((x), 12)
#define FSS_B3_ROR7(x) _mm_ror_epi32((x), 7)
#else
#define FSS_B3_ROR12(x) \
  _mm_or_si128(_mm_srli_epi32((x), 12), _mm_slli_epi32((x), 20))
#define FSS_B3_ROR7(x) \
  _mm_or_si128(_mm_srli_epi32((x), 7), _mm_slli_epi32((x), 25))
#endif

// Row-vectorized 7-round core (the standard BLAKE2s/BLAKE3 SSE shape):
// the four column Gs (then the four diagonal Gs after lane rotations)
// run in one xmm row each; rotates by 16/8 are byte shuffles.
// Bit-identical to the scalar rounds in blake3_compress's fallback.
inline void blake3_rounds_sse(__m128i &a, __m128i &b, __m128i &c,
                              __m128i &d, const uint32_t *m,
                              const Blake3Sched &sched) {
  const __m128i r16 = _mm_set_epi8(13, 12, 15, 14, 9, 8, 11, 10, 5, 4,
                                   7, 6, 1, 0, 3, 2);
  const __m128i r8 = _mm_set_epi8(12, 15, 14, 13, 8, 11, 10, 9, 4, 7, 6,
                                  5, 0, 3, 2, 1);
  for (int r = 0; r < 7; ++r) {
    const uint8_t *sc = sched.s[r];
    __m128i mx = _mm_set_epi32((int)m[sc[6]], (int)m[sc[4]],
                               (int)m[sc[2]], (int)m[sc[0]]);
    __m128i my = _mm_set_epi32((int)m[sc[7]], (int)m[sc[5]],
                               (int)m[sc[3]], (int)m[sc[1]]);
    a = _mm_add_epi32(_mm_add_epi32(a, b), mx);
    d = _mm_shuffle_epi8(_mm_xor_si128(d, a), r16);
    c = _mm_add_epi32(c, d);
    b = _mm_xor_si128(b, c);
    b = FSS_B3_ROR12(b);
    a = _mm_add_epi32(_mm_add_epi32(a, b), my);
    d = _mm_shuffle_epi8(_mm_xor_si128(d, a), r8);
    c = _mm_add_epi32(c, d);
    b = _mm_xor_si128(b, c);
    b = FSS_B3_ROR7(b);
    // Diagonalize: lane k of each row then holds diagonal G_k's state.
    b = _mm_shuffle_epi32(b, _MM_SHUFFLE(0, 3, 2, 1));
    c = _mm_shuffle_epi32(c, _MM_SHUFFLE(1, 0, 3, 2));
    d = _mm_shuffle_epi32(d, _MM_SHUFFLE(2, 1, 0, 3));
    mx = _mm_set_epi32((int)m[sc[14]], (int)m[sc[12]], (int)m[sc[10]],
                       (int)m[sc[8]]);
    my = _mm_set_epi32((int)m[sc[15]], (int)m[sc[13]], (int)m[sc[11]],
                       (int)m[sc[9]]);
    a = _mm_add_epi32(_mm_add_epi32(a, b), mx);
    d = _mm_shuffle_epi8(_mm_xor_si128(d, a), r16);
    c = _mm_add_epi32(c, d);
    b = _mm_xor_si128(b, c);
    b = FSS_B3_ROR12(b);
    a = _mm_add_epi32(_mm_add_epi32(a, b), my);
    d = _mm_shuffle_epi8(_mm_xor_si128(d, a), r8);
    c = _mm_add_epi32(c, d);
    b = _mm_xor_si128(b, c);
    b = FSS_B3_ROR7(b);
    b = _mm_shuffle_epi32(b, _MM_SHUFFLE(2, 1, 0, 3));
    c = _mm_shuffle_epi32(c, _MM_SHUFFLE(1, 0, 3, 2));
    d = _mm_shuffle_epi32(d, _MM_SHUFFLE(0, 3, 2, 1));
  }
}
#endif  // FSS_HAVE_AESNI

void blake3_compress(const uint32_t iv[8], const uint32_t m_in[16],
                     uint32_t block_len, uint32_t out[16]) {
  static const Blake3Sched kSched;
#if FSS_HAVE_AESNI
  __m128i a = _mm_loadu_si128(reinterpret_cast<const __m128i *>(iv));
  __m128i b = _mm_loadu_si128(reinterpret_cast<const __m128i *>(iv + 4));
  __m128i c =
      _mm_loadu_si128(reinterpret_cast<const __m128i *>(kBlake3Iv0));
  __m128i d = _mm_set_epi32(0x1B, (int)block_len, 0, 0);
  blake3_rounds_sse(a, b, c, d, m_in, kSched);
  __m128i *o = reinterpret_cast<__m128i *>(out);
  _mm_storeu_si128(o, _mm_xor_si128(a, c));
  _mm_storeu_si128(o + 1, _mm_xor_si128(b, d));
  _mm_storeu_si128(
      o + 2,
      _mm_xor_si128(c, _mm_loadu_si128(
                           reinterpret_cast<const __m128i *>(iv))));
  _mm_storeu_si128(
      o + 3,
      _mm_xor_si128(d, _mm_loadu_si128(
                           reinterpret_cast<const __m128i *>(iv + 4))));
#else
  uint32_t v[16], m[16];
  for (int i = 0; i < 8; ++i) v[i] = iv[i];
  for (int i = 0; i < 4; ++i) v[8 + i] = kBlake3Iv0[i];
  v[12] = 0; v[13] = 0; v[14] = block_len; v[15] = 0x1B;
  std::memcpy(m, m_in, sizeof(m));
  for (int r = 0; r < 7; ++r) {
    const uint8_t *sc = kSched.s[r];
    blake3_g(v, 0, 4, 8, 12, m[sc[0]], m[sc[1]]);
    blake3_g(v, 1, 5, 9, 13, m[sc[2]], m[sc[3]]);
    blake3_g(v, 2, 6, 10, 14, m[sc[4]], m[sc[5]]);
    blake3_g(v, 3, 7, 11, 15, m[sc[6]], m[sc[7]]);
    blake3_g(v, 0, 5, 10, 15, m[sc[8]], m[sc[9]]);
    blake3_g(v, 1, 6, 11, 12, m[sc[10]], m[sc[11]]);
    blake3_g(v, 2, 7, 8, 13, m[sc[12]], m[sc[13]]);
    blake3_g(v, 3, 4, 9, 14, m[sc[14]], m[sc[15]]);
  }
  for (int i = 0; i < 8; ++i) out[i] = v[i] ^ v[i + 8];
  for (int i = 0; i < 8; ++i) out[8 + i] = v[8 + i] ^ iv[i];
#endif
}

// Keyed hash dispatch: Hashable (64B -> 32B) + XorHashable ((x,s) -> 64B).
struct Hash {
  int kind;  // 0 = sha256 (16B key), 1 = blake3 (32B iv)
  Block key;
  uint32_t iv[8];

  void hash64(const Block msg[4], Block out[2]) const {
    if (kind == 0) {
      uint8_t buf[80], d[32];
      std::memcpy(buf, &key, 16);
      std::memcpy(buf + 16, msg, 64);
      sha256_digest(buf, 80, d);
      std::memcpy(out, d, 32);
    } else {
      uint32_t o[16];
      blake3_compress(iv, reinterpret_cast<const uint32_t *>(msg), 64, o);
      std::memcpy(out, o, 32);
    }
  }

  void xor_hash(const Block &x, const Block &s, Block out[4]) const {
    if (kind == 0) {
      // Two 48B keyed digests with x's LSB as separator
      // (hash/sha256.cuh:69-89).
      uint8_t buf[48], d[32];
      std::memcpy(buf, &key, 16);
      std::memcpy(buf + 32, &s, 16);
      Block x0 = set_lsb(x, 0);
      std::memcpy(buf + 16, &x0, 16);
      sha256_digest(buf, 48, d);
      std::memcpy(out, d, 32);
      Block x1 = set_lsb(x, 1);
      std::memcpy(buf + 16, &x1, 16);
      sha256_digest(buf, 48, d);
      std::memcpy(out + 2, d, 32);
    } else {
      // Two 32B-padded compressions (hash/blake3.cuh:160-171).
      uint32_t m[16], o[16];
      std::memset(m, 0, sizeof(m));
      Block x0 = set_lsb(x, 0);
      std::memcpy(m, &x0, 16);
      std::memcpy(m + 4, &s, 16);
      blake3_compress(iv, m, 32, o);
      std::memcpy(out, o, 32);
      Block x1 = set_lsb(x, 1);
      std::memcpy(m, &x1, 16);
      blake3_compress(iv, m, 32, o);
      std::memcpy(out + 2, o, 32);
    }
  }
};

inline Block pack_input(uint64_t lo, uint64_t hi) {
  Block b;
  b.w[0] = (uint32_t)lo;
  b.w[1] = (uint32_t)(lo >> 32);
  b.w[2] = (uint32_t)hi;
  b.w[3] = (uint32_t)(hi >> 32);
  return b;
}

// ---------------------------------------------------------------------------
// VDPF (vdpf.cuh semantics: in_bits cw rows + 64B check seed + ocw)
// ---------------------------------------------------------------------------

#if FSS_HAVE_VAES512
// Key-sliced VDPF Gen: the shared 4-key BGI walk (identical to DPF's,
// vdpf.cuh:97-133) + the VDPF epilogue — per-key check-seed hashes
// (xor_hash at alpha over both final seeds; SHA-256 configs interleave
// the four one-block digests through sha256_block_shani_x2), fail
// flags, and the +-(beta - s0 + s1) ocw.
void vdpf_gen_vaes4(const Prg &prg, const Hash &xh, const Group &grp,
                    int in_bits, const Block *s0s /* 4 x 2 */,
                    const uint64_t *a_lo, const Block *betas,
                    Block *const cwsk[4], Block csk[4][4], Block ocwk[4],
                    int fails[4]) {
  __m512i S0, S1;
  uint32_t t0b[4], t1b[4];
  dpf_gen_walk_vaes4(prg, in_bits, s0s, a_lo, nullptr, cwsk, S0, S1,
                     t0b, t1b);
  Block s0f[4], s1f[4];
  store_b(_mm512_castsi512_si128(S0), s0f[0]);
  store_b(_mm512_extracti32x4_epi32(S0, 1), s0f[1]);
  store_b(_mm512_extracti32x4_epi32(S0, 2), s0f[2]);
  store_b(_mm512_extracti32x4_epi32(S0, 3), s0f[3]);
  store_b(_mm512_castsi512_si128(S1), s1f[0]);
  store_b(_mm512_extracti32x4_epi32(S1, 1), s1f[1]);
  store_b(_mm512_extracti32x4_epi32(S1, 2), s1f[2]);
  store_b(_mm512_extracti32x4_epi32(S1, 3), s1f[3]);

  static const bool kShani = __builtin_cpu_supports("sha") != 0;
  static const uint32_t kIv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                  0xa54ff53a, 0x510e527f, 0x9b05688c,
                                  0x1f83d9ab, 0x5be0cd19};
  for (int k = 0; k < 4; ++k) {
    const Block a_buf = pack_input(a_lo[k], 0);
    Block pt0[4], pt1[4];
    if (xh.kind == 0 && kShani) {
      // Four independent one-block digests -> two interleaved pairs.
      const Block x0 = set_lsb(a_buf, 0), x1 = set_lsb(a_buf, 1);
      uint8_t b00[64], b01[64], b10[64], b11[64];
      uint8_t *bs[4] = {b00, b01, b10, b11};
      const Block *xsel[2] = {&x0, &x1};
      for (int q = 0; q < 4; ++q) {
        std::memset(bs[q], 0, 64);
        std::memcpy(bs[q], &xh.key, 16);
        std::memcpy(bs[q] + 16, xsel[q & 1], 16);
        std::memcpy(bs[q] + 32, q < 2 ? &s0f[k] : &s1f[k], 16);
        bs[q][48] = 0x80;
        bs[q][62] = 0x01;
        bs[q][63] = 0x80;
      }
      uint32_t h00[8], h01[8], h10[8], h11[8];
      std::memcpy(h00, kIv, 32);
      std::memcpy(h01, kIv, 32);
      std::memcpy(h10, kIv, 32);
      std::memcpy(h11, kIv, 32);
      sha256_block_shani_x2(h00, b00, h10, b10);
      sha256_block_shani_x2(h01, b01, h11, b11);
      uint32_t *p0 = reinterpret_cast<uint32_t *>(pt0);
      uint32_t *p1 = reinterpret_cast<uint32_t *>(pt1);
      for (int i = 0; i < 8; ++i) {
        p0[i] = __builtin_bswap32(h00[i]);
        p0[8 + i] = __builtin_bswap32(h01[i]);
        p1[i] = __builtin_bswap32(h10[i]);
        p1[8 + i] = __builtin_bswap32(h11[i]);
      }
    } else {
      xh.xor_hash(a_buf, s0f[k], pt0);
      xh.xor_hash(a_buf, s1f[k], pt1);
    }
    for (int i = 0; i < 4; ++i) csk[k][i] = bxor(pt0[i], pt1[i]);

    fails[k] = (t0b[k] == t1b[k]) ? 1 : 0;
    u128 v = grp.add(grp.add(grp.from_block(set_lsb(betas[k], 0)),
                             grp.neg(grp.from_block(s0f[k]))),
                     grp.from_block(s1f[k]));
    if (t1b[k] & 1u) v = grp.neg(v);
    grp.into_block(v, ocwk[k]);
  }
}
#endif  // FSS_HAVE_VAES512

int vdpf_gen(const Prg &prg, const Hash &xh, const Group &grp, int in_bits,
             const Block s0s[2], uint64_t a_lo, uint64_t a_hi,
             const Block &beta, Block *cws, Block cs[4], Block &ocw) {
  Block s0 = set_lsb(s0s[0], 0), s1 = set_lsb(s0s[1], 0);
  uint32_t t0 = 0, t1 = 1;
  Block b_buf = set_lsb(beta, 0);

  for (int i = 0; i < in_bits; ++i) {
    Block o0[2], o1[2];
    prg.gen(s0, o0);
    prg.gen(s1, o1);
    uint32_t t0l = get_lsb(o0[0]), t0r = get_lsb(o0[1]);
    uint32_t t1l = get_lsb(o1[0]), t1r = get_lsb(o1[1]);
    Block s0l = set_lsb(o0[0], 0), s0r = set_lsb(o0[1], 0);
    Block s1l = set_lsb(o1[0], 0), s1r = set_lsb(o1[1], 0);

    int ab = input_bit(a_lo, a_hi, in_bits, i);
    Block s_cw = ab ? bxor(s0l, s1l) : bxor(s0r, s1r);
    uint32_t tl_cw = t0l ^ t1l ^ (uint32_t)ab ^ 1u;
    uint32_t tr_cw = t0r ^ t1r ^ (uint32_t)ab;

    Block keep0 = ab ? s0r : s0l;
    Block keep1 = ab ? s1r : s1l;
    uint32_t tk0 = ab ? t0r : t0l;
    uint32_t tk1 = ab ? t1r : t1l;
    uint32_t tcw = ab ? tr_cw : tl_cw;

    s0 = t0 ? bxor(keep0, s_cw) : keep0;
    s1 = t1 ? bxor(keep1, s_cw) : keep1;
    t0 = tk0 ^ (t0 & tcw);
    t1 = tk1 ^ (t1 & tcw);

    cws[2 * i] = set_lsb(s_cw, tl_cw);
    cws[2 * i + 1].w[0] = tr_cw;
    cws[2 * i + 1].w[1] = cws[2 * i + 1].w[2] = cws[2 * i + 1].w[3] = 0;
  }

  Block a_buf = pack_input(a_lo, a_hi);
  Block pt0[4], pt1[4];
  xh.xor_hash(a_buf, s0, pt0);
  xh.xor_hash(a_buf, s1, pt1);
  for (int i = 0; i < 4; ++i) cs[i] = bxor(pt0[i], pt1[i]);

  if (t0 == t1) return 1;

  u128 v = grp.add(grp.add(grp.from_block(b_buf),
                           grp.neg(grp.from_block(s0))),
                   grp.from_block(s1));
  if (t1 & 1u) v = grp.neg(v);
  grp.into_block(v, ocw);
  return 0;
}

void vdpf_eval(const Prg &prg, const Hash &xh, const Group &grp,
               int in_bits, int party, const Block &seed, const Block *cws,
               const Block cs[4], const Block &ocw, uint64_t x_lo,
               uint64_t x_hi, Block &y_out, Block pi_tilde[4]) {
  Block s = set_lsb(seed, 0);
  uint32_t t = (uint32_t)party;
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
    dpf_walk_aesni(prg, in_bits, party, seed, cws, x_lo, x_hi, s, t);
  } else
#endif
  for (int i = 0; i < in_bits; ++i) {
    Block o[2];
    prg.gen(s, o);
    uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[1]);
    Block sl = set_lsb(o[0], 0), sr = set_lsb(o[1], 0);
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = cws[2 * i + 1].w[0] & 1u;
    if (t) {
      sl = bxor(sl, s_cw);
      sr = bxor(sr, s_cw);
      tl ^= tl_cw;
      tr ^= tr_cw;
    }
    int xb = input_bit(x_lo, x_hi, in_bits, i);
    s = xb ? sr : sl;
    t = xb ? tr : tl;
  }
  u128 y = grp.from_block(s);
  if (t) y = grp.add(y, grp.from_block(ocw));
  if (party) y = grp.neg(y);
  grp.into_block(y, y_out);

  xh.xor_hash(pack_input(x_lo, x_hi), s, pi_tilde);
  if (t)
    for (int i = 0; i < 4; ++i) pi_tilde[i] = bxor(pi_tilde[i], cs[i]);
}

void vdpf_fold_step(const Hash &h, Block pi[4], const Block pt[4]) {
  Block hin[4], ho[2];
  for (int i = 0; i < 4; ++i) hin[i] = bxor(pi[i], pt[i]);
  h.hash64(hin, ho);
  pi[0] = bxor(pi[0], ho[0]);
  pi[1] = bxor(pi[1], ho[1]);
}

void vdpf_prove(const Hash &h, const Block *pts, int64_t n,
                const Block cs[4], Block pi[4]) {
#if FSS_HAVE_AESNI
  if (h.kind == 1) {
    // Latency-tuned BLAKE3 fold: the chain state (pi rows 0-1; rows 2-3
    // stay cs) and the compress input rows live in xmm registers across
    // steps — no hin/out staging buffers or dispatch per fold.
    static const Blake3Sched kSched;
    const __m128i iva =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(h.iv));
    const __m128i ivb =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(h.iv + 4));
    const __m128i c0 =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(kBlake3Iv0));
    const __m128i d0 = _mm_set_epi32(0x1B, 64, 0, 0);
    __m128i pi0 =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(cs[0].w));
    __m128i pi1 =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(cs[1].w));
    const __m128i cs2 =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(cs[2].w));
    const __m128i cs3 =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(cs[3].w));
    alignas(16) uint32_t m[16];
    for (int64_t j = 0; j < n; ++j) {
      const __m128i *pt =
          reinterpret_cast<const __m128i *>(pts + 4 * j);
      _mm_store_si128(reinterpret_cast<__m128i *>(m),
                      _mm_xor_si128(pi0, _mm_loadu_si128(pt)));
      _mm_store_si128(reinterpret_cast<__m128i *>(m + 4),
                      _mm_xor_si128(pi1, _mm_loadu_si128(pt + 1)));
      _mm_store_si128(reinterpret_cast<__m128i *>(m + 8),
                      _mm_xor_si128(cs2, _mm_loadu_si128(pt + 2)));
      _mm_store_si128(reinterpret_cast<__m128i *>(m + 12),
                      _mm_xor_si128(cs3, _mm_loadu_si128(pt + 3)));
      __m128i a = iva, b = ivb, c = c0, d = d0;
      blake3_rounds_sse(a, b, c, d, m, kSched);
      pi0 = _mm_xor_si128(pi0, _mm_xor_si128(a, c));
      pi1 = _mm_xor_si128(pi1, _mm_xor_si128(b, d));
    }
    _mm_storeu_si128(reinterpret_cast<__m128i *>(pi[0].w), pi0);
    _mm_storeu_si128(reinterpret_cast<__m128i *>(pi[1].w), pi1);
    pi[2] = cs[2];
    pi[3] = cs[3];
    return;
  }
#endif
  for (int i = 0; i < 4; ++i) pi[i] = cs[i];
  for (int64_t j = 0; j < n; ++j) vdpf_fold_step(h, pi, pts + 4 * j);
}

#if defined(__x86_64__)
// SHA-256-specialized output/proof pass for vdpf_eval_all. The proof
// chain is 2^n x two *dependent* compressions (hash/sha256.cuh 80-byte
// keyed digest, pi feeds the next block) — the serial floor of the
// whole pass — while each leaf's two xor-hash digests (one padded 64B
// block each) are independent. Pairing each chain block with one
// xor-hash block in sha256_block_shani_x2 hides the independent work in
// the chain's latency shadow. Bit-identical to the generic loop below;
// caller must have pi pre-initialized to cs.
void vdpf_leafpass_sha(const Hash &xh, const Hash &hh, const Group &grp,
                       int party, const Block cs[4], const Block &ocw,
                       Block *ys, uint64_t n, Block pi[4]) {
  static const uint32_t kIv[8] = {0x6a09e667, 0xbb67ae85, 0x3c6ef372,
                                  0xa54ff53a, 0x510e527f, 0x9b05688c,
                                  0x1f83d9ab, 0x5be0cd19};
  u128 ocwv = grp.from_block(ocw);
  // xor-hash blocks: key(16) || set_lsb(x, b)(16) || s(16) || SHA
  // padding for a 48-byte (384-bit) message.
  uint8_t xb0[64], xb1[64];
  std::memset(xb0, 0, 64);
  std::memset(xb1, 0, 64);
  std::memcpy(xb0, &xh.key, 16);
  std::memcpy(xb1, &xh.key, 16);
  xb0[48] = 0x80; xb0[62] = 0x01; xb0[63] = 0x80;
  xb1[48] = 0x80; xb1[62] = 0x01; xb1[63] = 0x80;
  // fold blocks: key(16) || hin[0..47], then hin[48..63] || padding for
  // an 80-byte (640-bit) message.
  uint8_t f1[64], f2[64];
  std::memcpy(f1, &hh.key, 16);
  std::memset(f2, 0, 64);
  f2[16] = 0x80; f2[62] = 0x02; f2[63] = 0x80;

  Block pt_prev[4];
  int have_prev = 0;
  for (uint64_t j = 0; j < n; ++j) {
    const Block node = ys[j];
    const uint32_t t = get_lsb(node);
    const Block s = set_lsb(node, 0);
    u128 y = grp.from_block(s);
    if (t) y = grp.add(y, ocwv);
    if (party) y = grp.neg(y);
    grp.into_block(y, ys[j]);

    const Block xin = pack_input(j, 0);
    const Block x0 = set_lsb(xin, 0), x1 = set_lsb(xin, 1);
    std::memcpy(xb0 + 16, &x0, 16);
    std::memcpy(xb0 + 32, &s, 16);
    std::memcpy(xb1 + 16, &x1, 16);
    std::memcpy(xb1 + 32, &s, 16);
    uint32_t h0[8], h1[8];
    std::memcpy(h0, kIv, 32);
    std::memcpy(h1, kIv, 32);
    if (have_prev) {
      Block hin[4];
      for (int i = 0; i < 4; ++i) hin[i] = bxor(pi[i], pt_prev[i]);
      std::memcpy(f1 + 16, hin, 48);
      std::memcpy(f2, reinterpret_cast<const uint8_t *>(hin) + 48, 16);
      uint32_t fh[8];
      std::memcpy(fh, kIv, 32);
      sha256_block_shani_x2(fh, f1, h0, xb0);
      sha256_block_shani_x2(fh, f2, h1, xb1);
      for (int i = 0; i < 4; ++i)
        pi[0].w[i] ^= __builtin_bswap32(fh[i]);
      for (int i = 0; i < 4; ++i)
        pi[1].w[i] ^= __builtin_bswap32(fh[4 + i]);
    } else {
      sha256_block_shani_x2(h0, xb0, h1, xb1);
    }
    uint32_t *ptw = reinterpret_cast<uint32_t *>(pt_prev);
    for (int i = 0; i < 8; ++i) {
      ptw[i] = __builtin_bswap32(h0[i]);
      ptw[8 + i] = __builtin_bswap32(h1[i]);
    }
    if (t)
      for (int i = 0; i < 4; ++i) pt_prev[i] = bxor(pt_prev[i], cs[i]);
    have_prev = 1;
  }
  if (have_prev) vdpf_fold_step(hh, pi, pt_prev);
}
#endif  // __x86_64__

void vdpf_eval_all(const Prg &prg, const Hash &xh, const Hash &hh,
                   const Group &grp, int in_bits, int party,
                   const Block &seed, const Block *cws, const Block cs[4],
                   const Block &ocw, Block *ys, Block pi[4]) {
  // Tree phase (packed (s, t) nodes), then the sequential output/proof
  // pass in canonical order (vdpf.cuh:296-344).
  ys[0] = set_lsb(set_lsb(seed, 0), (uint32_t)party);
  for (int i = 0; i < in_bits; ++i) {
    uint64_t m = 1ull << i;
#if FSS_HAVE_AESNI
    if (prg.kind == 1) {
      dpf_expand_level_aesni(prg, ys, m, cws[2 * i],
                             cws[2 * i + 1].w[0]);
      continue;
    }
#endif
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = cws[2 * i + 1].w[0] & 1u;
    for (uint64_t j = m; j-- > 0;) {
      Block node = ys[j];
      uint32_t t = get_lsb(node);
      Block s = set_lsb(node, 0);
      Block o[2];
      prg.gen(s, o);
      uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[1]);
      Block sl = set_lsb(o[0], 0), sr = set_lsb(o[1], 0);
      if (t) {
        sl = bxor(sl, s_cw);
        sr = bxor(sr, s_cw);
        tl ^= tl_cw;
        tr ^= tr_cw;
      }
      ys[2 * j] = set_lsb(sl, tl);
      ys[2 * j + 1] = set_lsb(sr, tr);
    }
  }
  for (int i = 0; i < 4; ++i) pi[i] = cs[i];
  uint64_t n = 1ull << in_bits;
#if defined(__x86_64__)
  static const bool kShani = __builtin_cpu_supports("sha") != 0;
  if (kShani && xh.kind == 0 && hh.kind == 0) {
    vdpf_leafpass_sha(xh, hh, grp, party, cs, ocw, ys, n, pi);
    return;
  }
#endif
  u128 ocwv = grp.from_block(ocw);
  for (uint64_t j = 0; j < n; ++j) {
    uint32_t t = get_lsb(ys[j]);
    Block s = set_lsb(ys[j], 0);
    u128 y = grp.from_block(s);
    if (t) y = grp.add(y, ocwv);
    if (party) y = grp.neg(y);

    Block pt[4];
    xh.xor_hash(pack_input((uint64_t)j, 0), s, pt);
    if (t)
      for (int i = 0; i < 4; ++i) pt[i] = bxor(pt[i], cs[i]);
    vdpf_fold_step(hh, pi, pt);
    grp.into_block(y, ys[j]);
  }
}

// ---------------------------------------------------------------------------
// Grotto DCF (grotto_dcf.cuh semantics: plain-DPF control-bit parity)
// ---------------------------------------------------------------------------

void grotto_expand(const Prg &prg, int in_bits, int party,
                   const Block &seed, const Block *cws, Block *scratch,
                   uint8_t *leaf) {
  // DPF tree expand keeping only leaf control bits.
  scratch[0] = set_lsb(set_lsb(seed, 0), (uint32_t)party);
  for (int i = 0; i < in_bits; ++i) {
    uint64_t m = 1ull << i;
#if FSS_HAVE_AESNI
    if (prg.kind == 1) {
      dpf_expand_level_aesni(prg, scratch, m, cws[2 * i],
                             cws[2 * i + 1].w[0]);
      continue;
    }
#endif
    Block s_cw = set_lsb(cws[2 * i], 0);
    uint32_t tl_cw = get_lsb(cws[2 * i]);
    uint32_t tr_cw = cws[2 * i + 1].w[0] & 1u;
    for (uint64_t j = m; j-- > 0;) {
      Block node = scratch[j];
      uint32_t t = get_lsb(node);
      Block s = set_lsb(node, 0);
      Block o[2];
      prg.gen(s, o);
      uint32_t tl = get_lsb(o[0]), tr = get_lsb(o[1]);
      Block sl = set_lsb(o[0], 0), sr = set_lsb(o[1], 0);
      if (t) {
        sl = bxor(sl, s_cw);
        sr = bxor(sr, s_cw);
        tl ^= tl_cw;
        tr ^= tr_cw;
      }
      scratch[2 * j] = set_lsb(sl, tl);
      scratch[2 * j + 1] = set_lsb(sr, tr);
    }
  }
  uint64_t n = 1ull << in_bits;
  uint64_t j0 = 0;
#if FSS_HAVE_VAES512
  // 16 leaf control bits per iteration: mask-extract the lsb of lane 3
  // of each block across four zmms, one 16-byte expand+store.
  const __m512i one512g = _mm512_set1_epi32(1);
  for (; j0 + 16 <= n; j0 += 16) {
    uint64_t bits = 0;
    for (int q = 0; q < 4; ++q) {
      const uint32_t tm = _mm512_test_epi32_mask(
          _mm512_loadu_si512(scratch + j0 + 4 * q), one512g);
      bits |= (uint64_t)(((tm >> 3) & 1u) | (((tm >> 7) & 1u) << 1) |
                         (((tm >> 11) & 1u) << 2) |
                         (((tm >> 15) & 1u) << 3))
              << (4 * q);
    }
    _mm_storeu_si128(
        reinterpret_cast<__m128i *>(leaf + j0),
        _mm_maskz_set1_epi8((__mmask16)bits, 1));
  }
#endif
  for (uint64_t j = j0; j < n; ++j)
    leaf[j] = (uint8_t)get_lsb(scratch[j]);
}

void grotto_preprocess(const Prg &prg, int in_bits, int party,
                       const Block &seed, const Block *cws, Block *scratch,
                       uint8_t *pt /* 2N-1 */) {
  uint64_t n = 1ull << in_bits;
  grotto_expand(prg, in_bits, party, seed, cws, scratch, pt + (n - 1));
  uint64_t j = n - 1;
#if FSS_HAVE_VAES512
  // pt[j] = pt[2j+1] ^ pt[2j+2]: adjacent byte pairs at odd offset —
  // xor each 16-bit lane with itself shifted 8, keep the low bytes
  // (VPMOVWB), 32 parents per iteration. Backward chunks stay in-place
  // safe (writes at [j, j+32) never overlap unread [2j+1, ...) for
  // j >= 32).
  while (j >= 64) {
    j -= 32;
    const __m512i a = _mm512_loadu_si512(pt + 2 * j + 1);
    _mm256_storeu_si256(
        reinterpret_cast<__m256i *>(pt + j),
        _mm512_cvtepi16_epi8(
            _mm512_xor_si512(a, _mm512_srli_epi16(a, 8))));
  }
#endif
  while (j-- > 0) pt[j] = pt[2 * j + 1] ^ pt[2 * j + 2];
}

void grotto_eval_tree(const uint8_t *pt, int in_bits, uint64_t x,
                      uint8_t &out) {
  // Prefix-parity query at e = x + 1 (grotto_dcf.cuh:116-135).
  uint64_t n = 1ull << in_bits;
  uint64_t e = (x + 1) & (n - 1);
  if (e == 0) {
    out = pt[0];
    return;
  }
  uint8_t acc = 0;
  uint64_t cur = 0;
  for (int i = 0; i < in_bits; ++i) {
    int e_bit = (int)((e >> (in_bits - 1 - i)) & 1u);
    if (e_bit) {
      acc ^= pt[2 * cur + 1];
      cur = 2 * cur + 2;
    } else {
      cur = 2 * cur + 1;
    }
  }
  out = acc;
}

// Small-domain Feistel PRP core (prp/aes128_feistel.cuh semantics):
// 4-round balanced Feistel with AES-128 round PRF (round index XORed
// into key byte 0) + cycle-walking.
void prp_permu_batch(const uint8_t sigma[16], uint64_t domain,
                     const uint64_t *xs, int64_t n, uint64_t *ys) {
#if FSS_HAVE_AESNI
  int b = 0;
  {
    uint64_t v = domain - 1;
    while (v > 0) {
      v >>= 1;
      ++b;
    }
  }
  int half = (b + 1) / 2;
  uint64_t mask = (half >= 64) ? ~0ull : ((1ull << half) - 1);

  AesKeySchedule ks[4];
  for (int r = 0; r < 4; ++r) {
    uint8_t kb[16];
    std::memcpy(kb, sigma, 16);
    kb[0] ^= (uint8_t)r;
    aes128_expand(kb, ks[r]);
  }

  for (int64_t i = 0; i < n; ++i) {
    uint64_t val = xs[i];
    do {
      uint64_t left = (val >> half) & mask;
      uint64_t right = val & mask;
      for (int r = 0; r < 4; ++r) {
        alignas(16) uint64_t block[2] = {right, 0};
        __m128i e = aes128_encrypt(
            ks[r], _mm_load_si128(reinterpret_cast<__m128i *>(block)));
        _mm_store_si128(reinterpret_cast<__m128i *>(block), e);
        uint64_t f = block[0] & mask;
        left ^= f;
        uint64_t tmp = left;
        left = right;
        right = tmp;
      }
      val = (left << half) | right;
    } while (val >= domain);
    ys[i] = val;
  }
#else
  (void)sigma;
  (void)domain;
  (void)xs;
  (void)n;
  (void)ys;
#endif
}

Prg make_prg(int prg_kind, int mul, const uint32_t nonce[2],
             const uint8_t *aes_keys, int rounds) {
  Prg prg;
  prg.kind = prg_kind;
  prg.mul = mul;
  prg.nonce[0] = nonce ? nonce[0] : 0;
  prg.nonce[1] = nonce ? nonce[1] : 0;
  prg.rounds = rounds;
#if FSS_HAVE_AESNI
  if (prg_kind == 1 && aes_keys) {
    for (int i = 0; i < mul; ++i) aes128_expand(aes_keys + 16 * i, prg.ks[i]);
  }
#endif
  return prg;
}

}  // namespace

// ---------------------------------------------------------------------------
// C ABI
// ---------------------------------------------------------------------------

extern "C" {

int fss_native_has_aesni(void) { return FSS_HAVE_AESNI; }

// PRG one-shot (oracle surface). out: mul*4 uint32.
void fss_prg(int prg_kind, int mul, const uint32_t nonce[2],
             const uint8_t *aes_keys, int rounds, const uint32_t seed[4],
             uint32_t *out) {
  Prg prg = make_prg(prg_kind, mul, nonce, aes_keys, rounds);
  Block s;
  std::memcpy(s.w, seed, 16);
  Block o[4];
  prg.gen(s, o);
  std::memcpy(out, o, 16 * (size_t)mul);
}

// DPF key generation. cws: (in_bits+1)*8 uint32 (row layout parity with
// fss_tpu / fss_crypto).
void fss_dpf_gen(int in_bits, int prg_kind, const uint32_t nonce[2],
                 const uint8_t *aes_keys, int rounds, int group_kind,
                 int group_bits, const uint32_t s0s[8], uint64_t alpha_lo,
                 uint64_t alpha_hi, const uint32_t beta[4], uint32_t *cws) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Block s0s_b[2], beta_b;
  std::memcpy(s0s_b, s0s, 32);
  std::memcpy(beta_b.w, beta, 16);
  dpf_gen(prg, grp, in_bits, s0s_b, alpha_lo, alpha_hi, beta_b,
          reinterpret_cast<Block *>(cws));
}

// Batched key generation: n independent (s0s, alpha, beta) instances.
void fss_dpf_gen_batch(int in_bits, int prg_kind, const uint32_t nonce[2],
                       const uint8_t *aes_keys, int rounds, int group_kind,
                       int group_bits, const uint32_t *s0s_batch,
                       const uint64_t *alphas_lo, const uint64_t *alphas_hi,
                       const uint32_t *betas, int64_t n, uint32_t *cws_out) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  size_t key_stride = (size_t)(in_bits + 1) * 8;
  int64_t i = 0;
#if FSS_HAVE_VAES512
  if (prg.kind == 1) {
    for (; i + 4 <= n; i += 4) {
      Block *const cwsk[4] = {
          reinterpret_cast<Block *>(cws_out + key_stride * i),
          reinterpret_cast<Block *>(cws_out + key_stride * (i + 1)),
          reinterpret_cast<Block *>(cws_out + key_stride * (i + 2)),
          reinterpret_cast<Block *>(cws_out + key_stride * (i + 3))};
      dpf_gen_vaes4(
          prg, grp, in_bits,
          reinterpret_cast<const Block *>(s0s_batch + 8 * i),
          alphas_lo + i, alphas_hi ? alphas_hi + i : nullptr,
          reinterpret_cast<const Block *>(betas + 4 * i), cwsk);
    }
  }
#endif
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
    for (; i + 2 <= n; i += 2) {
      // Alias the caller arrays directly (load_b/store_b are unaligned);
      // no per-key staging copies.
      Block *const cwsk[2] = {
          reinterpret_cast<Block *>(cws_out + key_stride * i),
          reinterpret_cast<Block *>(cws_out + key_stride * (i + 1))};
      dpf_gen_aesni_k<2>(
          prg, grp, in_bits,
          reinterpret_cast<const Block *>(s0s_batch + 8 * i),
          alphas_lo + i, alphas_hi ? alphas_hi + i : nullptr,
          reinterpret_cast<const Block *>(betas + 4 * i), cwsk);
    }
  }
#endif
  for (; i < n; ++i) {
    Block s0s_b[2], beta_b;
    std::memcpy(s0s_b, s0s_batch + 8 * i, 32);
    std::memcpy(beta_b.w, betas + 4 * i, 16);
    dpf_gen(prg, grp, in_bits, s0s_b, alphas_lo[i],
            alphas_hi ? alphas_hi[i] : 0, beta_b,
            reinterpret_cast<Block *>(cws_out + key_stride * i));
  }
}

// Batched point evaluation: n_points inputs against ONE key.
void fss_dpf_eval(int in_bits, int prg_kind, const uint32_t nonce[2],
                  const uint8_t *aes_keys, int rounds, int group_kind,
                  int group_bits, int party, const uint32_t s0[4],
                  const uint32_t *cws, const uint64_t *xs_lo,
                  const uint64_t *xs_hi, int64_t n_points, uint32_t *ys) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Block seed;
  std::memcpy(seed.w, s0, 16);
  const Block *cws_b = reinterpret_cast<const Block *>(cws);
  int64_t i = 0;
#if FSS_HAVE_VAES512
  if (prg.kind == 0) {
    for (; i + 16 <= n_points; i += 16) {
      uint64_t xlo[16], xhi[16];
      for (int k = 0; k < 16; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block sf[16];
      uint32_t tf[16];
      dpf_walk_chacha16(prg, in_bits, party, seed, cws_b, xlo, xhi, sf,
                        tf);
      for (int k = 0; k < 16; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(cws_b[2 * in_bits]));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
      }
    }
  }
#endif
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
#if FSS_HAVE_VAES512
    const Block *seeds8[8] = {&seed, &seed, &seed, &seed,
                              &seed, &seed, &seed, &seed};
    const Block *cwp8[8] = {cws_b, cws_b, cws_b, cws_b,
                            cws_b, cws_b, cws_b, cws_b};
    for (; i + 8 <= n_points; i += 8) {
      uint64_t xlo[8], xhi[8];
      for (int k = 0; k < 8; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block sf[8];
      uint32_t tf[8];
      dpf_walk_vaes8(prg, in_bits, party, seeds8, cwp8, xlo, xhi, sf,
                     tf);
      for (int k = 0; k < 8; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(cws_b[2 * in_bits]));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
      }
    }
#endif
    const Block *seeds[4] = {&seed, &seed, &seed, &seed};
    const Block *cwp[4] = {cws_b, cws_b, cws_b, cws_b};
    for (; i + 4 <= n_points; i += 4) {
      uint64_t xlo[4], xhi[4];
      for (int k = 0; k < 4; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block sf[4];
      uint32_t tf[4];
      dpf_walk_aesni_x4(prg, in_bits, party, seeds, cwp, xlo, xhi, sf,
                        tf);
      for (int k = 0; k < 4; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(cws_b[2 * in_bits]));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
      }
    }
  }
#endif
  for (; i < n_points; ++i) {
    Block y;
    dpf_eval(prg, grp, in_bits, party, seed, cws_b, xs_lo[i],
             xs_hi ? xs_hi[i] : 0, y);
    std::memcpy(ys + 4 * i, y.w, 16);
  }
}

// Batched per-instance evaluation: one (seed, key, x) triple per instance
// (the GPU-bench shape, for CPU throughput benchmarks).
void fss_dpf_eval_batch(int in_bits, int prg_kind, const uint32_t nonce[2],
                        const uint8_t *aes_keys, int rounds, int group_kind,
                        int group_bits, int party, const uint32_t *s0s,
                        const uint32_t *cws_batch, const uint64_t *xs_lo,
                        int64_t n, uint32_t *ys) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  size_t key_stride = (size_t)(in_bits + 1) * 8;
  int64_t i = 0;
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
#if FSS_HAVE_VAES512
    for (; i + 8 <= n; i += 8) {
      const Block *seedp[8];
      const Block *cwp[8];
      uint64_t xlo[8], xhi[8];
      for (int k = 0; k < 8; ++k) {
        seedp[k] =
            reinterpret_cast<const Block *>(s0s + 4 * (i + k));
        cwp[k] = reinterpret_cast<const Block *>(cws_batch +
                                                 key_stride * (i + k));
        xlo[k] = xs_lo[i + k];
        xhi[k] = 0;
      }
      Block sf[8];
      uint32_t tf[8];
      dpf_walk_vaes8(prg, in_bits, party, seedp, cwp, xlo, xhi, sf, tf);
      for (int k = 0; k < 8; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(cwp[k][2 * in_bits]));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
      }
    }
#endif
    for (; i + 4 <= n; i += 4) {
      Block seeds_s[4];
      const Block *seedp[4];
      const Block *cwp[4];
      uint64_t xlo[4], xhi[4];
      for (int k = 0; k < 4; ++k) {
        std::memcpy(seeds_s[k].w, s0s + 4 * (i + k), 16);
        seedp[k] = &seeds_s[k];
        cwp[k] = reinterpret_cast<const Block *>(cws_batch +
                                                 key_stride * (i + k));
        xlo[k] = xs_lo[i + k];
        xhi[k] = 0;
      }
      Block sf[4];
      uint32_t tf[4];
      dpf_walk_aesni_x4(prg, in_bits, party, seedp, cwp, xlo, xhi, sf,
                        tf);
      for (int k = 0; k < 4; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(cwp[k][2 * in_bits]));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
      }
    }
  }
#endif
  for (; i < n; ++i) {
    Block seed;
    std::memcpy(seed.w, s0s + 4 * i, 16);
    Block y;
    dpf_eval(prg, grp, in_bits, party, seed,
             reinterpret_cast<const Block *>(cws_batch + key_stride * i),
             xs_lo[i], 0, y);
    std::memcpy(ys + 4 * i, y.w, 16);
  }
}

// Full-domain evaluation. ys: 2^in_bits * 4 uint32.
void fss_dpf_eval_all(int in_bits, int prg_kind, const uint32_t nonce[2],
                      const uint8_t *aes_keys, int rounds, int group_kind,
                      int group_bits, int party, const uint32_t s0[4],
                      const uint32_t *cws, uint32_t *ys) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Block seed;
  std::memcpy(seed.w, s0, 16);
  dpf_eval_all(prg, grp, in_bits, party, seed,
               reinterpret_cast<const Block *>(cws),
               reinterpret_cast<Block *>(ys));
}

// DCF key generation. cws: (in_bits+1)*8 uint32 (row layout parity).
void fss_dcf_gen(int in_bits, int prg_kind, const uint32_t nonce[2],
                 const uint8_t *aes_keys, int rounds, int group_kind,
                 int group_bits, int pred_lt, const uint32_t s0s[8],
                 uint64_t alpha_lo, uint64_t alpha_hi,
                 const uint32_t beta[4], uint32_t *cws) {
  Prg prg = make_prg(prg_kind, 4, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Block s0s_b[2], beta_b;
  std::memcpy(s0s_b, s0s, 32);
  std::memcpy(beta_b.w, beta, 16);
  dcf_gen(prg, grp, in_bits, pred_lt, s0s_b, alpha_lo, alpha_hi, beta_b,
          reinterpret_cast<Block *>(cws));
}

// Batched DCF point evaluation against ONE key.
void fss_dcf_eval(int in_bits, int prg_kind, const uint32_t nonce[2],
                  const uint8_t *aes_keys, int rounds, int group_kind,
                  int group_bits, int party, const uint32_t s0[4],
                  const uint32_t *cws, const uint64_t *xs_lo,
                  const uint64_t *xs_hi, int64_t n_points, uint32_t *ys) {
  Prg prg = make_prg(prg_kind, 4, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Block seed;
  std::memcpy(seed.w, s0, 16);
  const Block *cws_b = reinterpret_cast<const Block *>(cws);
  int64_t i = 0;
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
#if FSS_HAVE_VAES512
    if ((grp.kind == 1 && grp.bits <= 64) || grp.kind == 0) {
      for (; i + 4 <= n_points; i += 4) {
        uint64_t xlo[4], xhi[4];
        for (int k = 0; k < 4; ++k) {
          xlo[k] = xs_lo[i + k];
          xhi[k] = xs_hi ? xs_hi[i + k] : 0;
        }
        Block yb[4];
        dcf_eval_vaes4(prg, grp, in_bits, party, seed, cws_b, xlo, xhi,
                       yb);
        std::memcpy(ys + 4 * i, yb, 64);
      }
    }
#endif
    for (; i + 2 <= n_points; i += 2) {
      uint64_t xlo[2], xhi[2];
      for (int k = 0; k < 2; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block yb[2];
      dcf_eval_aesni_x2(prg, grp, in_bits, party, seed, cws_b, xlo, xhi,
                        yb);
      std::memcpy(ys + 4 * i, yb, 32);
    }
  }
#endif
  for (; i < n_points; ++i) {
    Block y;
    dcf_eval(prg, grp, in_bits, party, seed, cws_b, xs_lo[i],
             xs_hi ? xs_hi[i] : 0, y);
    std::memcpy(ys + 4 * i, y.w, 16);
  }
}

// DCF full-domain evaluation. ys: 2^in_bits * 4; scratch: same size.
void fss_dcf_eval_all(int in_bits, int prg_kind, const uint32_t nonce[2],
                      const uint8_t *aes_keys, int rounds, int group_kind,
                      int group_bits, int party, const uint32_t s0[4],
                      const uint32_t *cws, uint32_t *ys,
                      uint32_t *scratch) {
  Prg prg = make_prg(prg_kind, 4, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Block seed;
  std::memcpy(seed.w, s0, 16);
  dcf_eval_all(prg, grp, in_bits, party, seed,
               reinterpret_cast<const Block *>(cws),
               reinterpret_cast<Block *>(ys),
               reinterpret_cast<Block *>(scratch));
}

// Half-Tree DPF. cws: in_bits*8 uint32; ocw: 4 uint32.
void fss_ht_gen(int in_bits, int prg_kind, const uint32_t nonce[2],
                const uint8_t *aes_keys, int rounds, int group_kind,
                int group_bits, const uint32_t hash_key[4],
                const uint32_t s0s[8], uint64_t alpha_lo,
                uint64_t alpha_hi, const uint32_t beta[4], uint32_t *cws,
                uint32_t *ocw) {
  Prg prg = make_prg(prg_kind, 1, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  HtCtx ht{&prg, Block()};
  std::memcpy(ht.hash_key.w, hash_key, 16);
  Block s0s_b[2], beta_b, ocw_b;
  std::memcpy(s0s_b, s0s, 32);
  std::memcpy(beta_b.w, beta, 16);
  ht_gen(ht, grp, in_bits, s0s_b, alpha_lo, alpha_hi, beta_b,
         reinterpret_cast<Block *>(cws), ocw_b);
  std::memcpy(ocw, ocw_b.w, 16);
}

void fss_ht_eval(int in_bits, int prg_kind, const uint32_t nonce[2],
                 const uint8_t *aes_keys, int rounds, int group_kind,
                 int group_bits, int party, const uint32_t hash_key[4],
                 const uint32_t s0[4], const uint32_t *cws,
                 const uint32_t ocw[4], const uint64_t *xs_lo,
                 const uint64_t *xs_hi, int64_t n_points, uint32_t *ys) {
  Prg prg = make_prg(prg_kind, 1, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  HtCtx ht{&prg, Block()};
  std::memcpy(ht.hash_key.w, hash_key, 16);
  Block seed, ocw_b;
  std::memcpy(seed.w, s0, 16);
  std::memcpy(ocw_b.w, ocw, 16);
  const Block *cws_b = reinterpret_cast<const Block *>(cws);
  int64_t i = 0;
#if FSS_HAVE_AESNI
  if (prg.kind == 1 && in_bits >= 2) {
#if FSS_HAVE_VAES512
    for (; i + 16 <= n_points; i += 16) {
      uint64_t xlo[16], xhi[16];
      for (int k = 0; k < 16; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block yb[16];
      ht_eval_vaes16(ht, grp, in_bits, party, seed, cws_b, ocw_b, xlo,
                     xhi, yb);
      std::memcpy(ys + 4 * i, yb, 256);
    }
#endif
    for (; i + 4 <= n_points; i += 4) {
      uint64_t xlo[4], xhi[4];
      for (int k = 0; k < 4; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block yb[4];
      ht_eval_aesni_x4(ht, grp, in_bits, party, seed, cws_b, ocw_b, xlo,
                       xhi, yb);
      std::memcpy(ys + 4 * i, yb, 64);
    }
  }
#endif
  for (; i < n_points; ++i) {
    Block y;
    ht_eval(ht, grp, in_bits, party, seed, cws_b, ocw_b, xs_lo[i],
            xs_hi ? xs_hi[i] : 0, y);
    std::memcpy(ys + 4 * i, y.w, 16);
  }
}

// hash_kind: 0 = sha256 (hash_key = 16B), 1 = blake3 (hash_key = 32B iv).
static Hash make_hash(int hash_kind, const uint8_t *hash_key) {
  Hash h;
  h.kind = hash_kind;
  if (hash_kind == 0) {
    std::memcpy(&h.key, hash_key, 16);
  } else {
    std::memcpy(h.iv, hash_key, 32);
  }
  return h;
}

void fss_sha256(const uint8_t *data, int64_t n, uint8_t out[32]) {
  sha256_digest(data, (size_t)n, out);
}

void fss_blake3_compress(const uint32_t iv[8], const uint32_t m[16],
                         uint32_t block_len, uint32_t out[16]) {
  blake3_compress(iv, m, block_len, out);
}

void fss_ht_eval_all(int in_bits, int prg_kind, const uint32_t nonce[2],
                     const uint8_t *aes_keys, int rounds, int group_kind,
                     int group_bits, int party, const uint32_t hash_key[4],
                     const uint32_t s0[4], const uint32_t *cws,
                     const uint32_t ocw[4], uint32_t *ys) {
  Prg prg = make_prg(prg_kind, 1, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  HtCtx ht{&prg, Block{}};
  std::memcpy(ht.hash_key.w, hash_key, 16);
  Block seed, ocwb;
  std::memcpy(seed.w, s0, 16);
  std::memcpy(ocwb.w, ocw, 16);
  ht_eval_all(ht, grp, in_bits, party, seed,
              reinterpret_cast<const Block *>(cws), ocwb,
              reinterpret_cast<Block *>(ys));
}

int fss_vdpf_gen(int in_bits, int prg_kind, const uint32_t nonce[2],
                 const uint8_t *aes_keys, int rounds, int hash_kind,
                 const uint8_t *hash_key, int group_kind, int group_bits,
                 const uint32_t s0s[8], uint64_t a_lo, uint64_t a_hi,
                 const uint32_t beta[4], uint32_t *cws, uint32_t *cs,
                 uint32_t *ocw) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Hash xh = make_hash(hash_kind, hash_key);
  Block seeds[2], betab, ocwb, csb[4];
  std::memcpy(seeds, s0s, 32);
  std::memcpy(betab.w, beta, 16);
  int ret = vdpf_gen(prg, xh, grp, in_bits, seeds, a_lo, a_hi, betab,
                     reinterpret_cast<Block *>(cws), csb, ocwb);
  std::memcpy(cs, csb, 64);
  std::memcpy(ocw, ocwb.w, 16);
  return ret;
}

void fss_vdpf_eval_batch(int in_bits, int prg_kind, const uint32_t nonce[2],
                         const uint8_t *aes_keys, int rounds, int hash_kind,
                         const uint8_t *hash_key, int group_kind,
                         int group_bits, int party, const uint32_t s0[4],
                         const uint32_t *cws, const uint32_t *cs,
                         const uint32_t ocw[4], const uint64_t *xs_lo,
                         const uint64_t *xs_hi, int64_t n, uint32_t *ys,
                         uint32_t *pi_tildes) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Hash xh = make_hash(hash_kind, hash_key);
  Block seed, ocwb, csb[4];
  std::memcpy(seed.w, s0, 16);
  std::memcpy(ocwb.w, ocw, 16);
  std::memcpy(csb, cs, 64);
  const Block *cws_b = reinterpret_cast<const Block *>(cws);
  int64_t i = 0;
#if FSS_HAVE_AESNI
  if (prg.kind == 1) {
#if FSS_HAVE_VAES512
    const Block *seeds8[8] = {&seed, &seed, &seed, &seed,
                              &seed, &seed, &seed, &seed};
    const Block *cwp8[8] = {cws_b, cws_b, cws_b, cws_b,
                            cws_b, cws_b, cws_b, cws_b};
    for (; i + 8 <= n; i += 8) {
      uint64_t xlo[8], xhi[8];
      for (int k = 0; k < 8; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block sf[8];
      uint32_t tf[8];
      dpf_walk_vaes8(prg, in_bits, party, seeds8, cwp8, xlo, xhi, sf,
                     tf);
      for (int k = 0; k < 8; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(ocwb));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
        Block pt[4];
        xh.xor_hash(pack_input(xlo[k], xhi[k]), sf[k], pt);
        if (tf[k])
          for (int j = 0; j < 4; ++j) pt[j] = bxor(pt[j], csb[j]);
        std::memcpy(pi_tildes + 16 * (i + k), pt, 64);
      }
    }
#endif
    const Block *seeds[4] = {&seed, &seed, &seed, &seed};
    const Block *cwp[4] = {cws_b, cws_b, cws_b, cws_b};
    for (; i + 4 <= n; i += 4) {
      uint64_t xlo[4], xhi[4];
      for (int k = 0; k < 4; ++k) {
        xlo[k] = xs_lo[i + k];
        xhi[k] = xs_hi ? xs_hi[i + k] : 0;
      }
      Block sf[4];
      uint32_t tf[4];
      dpf_walk_aesni_x4(prg, in_bits, party, seeds, cwp, xlo, xhi, sf,
                        tf);
      for (int k = 0; k < 4; ++k) {
        u128 y = grp.from_block(sf[k]);
        if (tf[k]) y = grp.add(y, grp.from_block(ocwb));
        if (party) y = grp.neg(y);
        Block yb;
        grp.into_block(y, yb);
        std::memcpy(ys + 4 * (i + k), yb.w, 16);
        Block pt[4];
        xh.xor_hash(pack_input(xlo[k], xhi[k]), sf[k], pt);
        if (tf[k])
          for (int j = 0; j < 4; ++j) pt[j] = bxor(pt[j], csb[j]);
        std::memcpy(pi_tildes + 16 * (i + k), pt, 64);
      }
    }
  }
#endif
  for (; i < n; ++i) {
    Block y, pt[4];
    vdpf_eval(prg, xh, grp, in_bits, party, seed, cws_b, csb, ocwb,
              xs_lo[i], xs_hi ? xs_hi[i] : 0, y, pt);
    std::memcpy(ys + 4 * i, y.w, 16);
    std::memcpy(pi_tildes + 16 * i, pt, 64);
  }
}

void fss_vdpf_prove(int hash_kind, const uint8_t *hash_key,
                    const uint32_t *pi_tildes, int64_t n,
                    const uint32_t *cs, uint32_t *pi) {
  Hash h = make_hash(hash_kind, hash_key);
  Block csb[4], pib[4];
  std::memcpy(csb, cs, 64);
  vdpf_prove(h, reinterpret_cast<const Block *>(pi_tildes), n, csb, pib);
  std::memcpy(pi, pib, 64);
}

void fss_vdpf_prove1_batch(int hash_kind, const uint8_t *hash_key,
                           const uint32_t *pi_tildes, int64_t n,
                           const uint32_t *cs, uint32_t *pis) {
  // n INDEPENDENT single-fold proofs (each pi_j = fold(cs, pi_tilde_j)):
  // the exact iteration the reference's Prove benchmark times
  // (bench_cpu.cu:408-435 resets pi to cs and folds one hash per
  // iteration), as opposed to fss_vdpf_prove's n-deep dependent chain.
  Hash h = make_hash(hash_kind, hash_key);
  Block csb[4];
  std::memcpy(csb, cs, 64);
  const Block *pts = reinterpret_cast<const Block *>(pi_tildes);
#if FSS_HAVE_AESNI
  if (h.kind == 1) {
    static const Blake3Sched kSched;
    const __m128i iva =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(h.iv));
    const __m128i ivb =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(h.iv + 4));
    const __m128i c0 =
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(kBlake3Iv0));
    const __m128i d0 = _mm_set_epi32(0x1B, 64, 0, 0);
    const __m128i csr[4] = {
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(csb[0].w)),
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(csb[1].w)),
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(csb[2].w)),
        _mm_loadu_si128(reinterpret_cast<const __m128i *>(csb[3].w))};
    alignas(16) uint32_t m[16];
    for (int64_t j = 0; j < n; ++j) {
      const __m128i *pt =
          reinterpret_cast<const __m128i *>(pts + 4 * j);
      for (int i = 0; i < 4; ++i)
        _mm_store_si128(
            reinterpret_cast<__m128i *>(m + 4 * i),
            _mm_xor_si128(csr[i], _mm_loadu_si128(pt + i)));
      __m128i a = iva, b = ivb, c = c0, d = d0;
      blake3_rounds_sse(a, b, c, d, m, kSched);
      __m128i *o = reinterpret_cast<__m128i *>(pis + 16 * j);
      _mm_storeu_si128(
          o, _mm_xor_si128(csr[0], _mm_xor_si128(a, c)));
      _mm_storeu_si128(
          o + 1, _mm_xor_si128(csr[1], _mm_xor_si128(b, d)));
      _mm_storeu_si128(o + 2, csr[2]);
      _mm_storeu_si128(o + 3, csr[3]);
    }
    return;
  }
#endif
  for (int64_t j = 0; j < n; ++j) {
    Block pi[4] = {csb[0], csb[1], csb[2], csb[3]};
    vdpf_fold_step(h, pi, pts + 4 * j);
    std::memcpy(pis + 16 * j, pi, 64);
  }
}

void fss_vdpf_eval_all(int in_bits, int prg_kind, const uint32_t nonce[2],
                       const uint8_t *aes_keys, int rounds, int hash_kind,
                       const uint8_t *hash_key, int group_kind,
                       int group_bits, int party, const uint32_t s0[4],
                       const uint32_t *cws, const uint32_t *cs,
                       const uint32_t ocw[4], uint32_t *ys, uint32_t *pi) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Hash h = make_hash(hash_kind, hash_key);
  Block seed, ocwb, csb[4], pib[4];
  std::memcpy(seed.w, s0, 16);
  std::memcpy(ocwb.w, ocw, 16);
  std::memcpy(csb, cs, 64);
  vdpf_eval_all(prg, h, h, grp, in_bits, party, seed,
                reinterpret_cast<const Block *>(cws), csb, ocwb,
                reinterpret_cast<Block *>(ys), pib);
  std::memcpy(pi, pib, 64);
}

void fss_grotto_preprocess(int in_bits, int prg_kind,
                           const uint32_t nonce[2], const uint8_t *aes_keys,
                           int rounds, int party, const uint32_t s0[4],
                           const uint32_t *cws, uint32_t *scratch,
                           uint8_t *pt) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Block seed;
  std::memcpy(seed.w, s0, 16);
  grotto_preprocess(prg, in_bits, party, seed,
                    reinterpret_cast<const Block *>(cws),
                    reinterpret_cast<Block *>(scratch), pt);
}

void fss_grotto_eval_batch(int in_bits, const uint8_t *pt,
                           const uint64_t *xs, int64_t n, uint8_t *out) {
  for (int64_t i = 0; i < n; ++i)
    grotto_eval_tree(pt, in_bits, xs[i], out[i]);
}

// Bit-packed parity tree: 8x smaller than the byte tree (256KB at 2^20 —
// cache-resident), with queries interleaved 16 at a time so the
// per-level dependent loads of independent queries overlap (memory-level
// parallelism). Same query semantics as grotto_eval_tree.
void fss_grotto_pack_tree(const uint8_t *pt, uint64_t n2,
                          uint64_t *packed) {
  uint64_t words = (n2 + 63) / 64;
  for (uint64_t w = 0; w < words; ++w) {
    uint64_t v = 0;
    uint64_t base = w * 64;
    uint64_t lim = n2 - base < 64 ? n2 - base : 64;
    for (uint64_t b = 0; b < lim; ++b)
      v |= (uint64_t)(pt[base + b] & 1u) << b;
    packed[w] = v;
  }
}

void fss_grotto_eval_batch_packed(int in_bits, const uint64_t *packed,
                                  const uint64_t *xs, int64_t n,
                                  uint8_t *out) {
  // The walked node at level k is a pure function of e's bit prefix
  // (level-order index 2^k - 1 + prefix), so every load's address is
  // arithmetic-only — no load depends on a previous load and the CPU
  // overlaps all of them across levels and queries.
  const uint64_t dom = 1ull << in_bits;
  auto bit = [packed](uint64_t j) -> uint8_t {
    return (uint8_t)((packed[j >> 6] >> (j & 63)) & 1u);
  };
  for (int64_t i = 0; i < n; ++i) {
    uint64_t e = (xs[i] + 1) & (dom - 1);
    if (e == 0) {
      out[i] = bit(0);
      continue;
    }
    // The prefix chain is 2 cheap ALU ops/level; deriving each level's
    // prefix independently from e (an extra shift per level) measures
    // ~30% SLOWER — the loads were never chained through it anyway.
    uint8_t acc = 0;
    uint64_t prefix = 0;
    for (int lvl = 0; lvl < in_bits; ++lvl) {
      uint64_t b = (e >> (in_bits - 1 - lvl)) & 1u;
      // Left child of the level-lvl path node: 2^(lvl+1) - 1 + 2*prefix.
      uint64_t left = (2ull << lvl) - 1 + (prefix << 1);
      acc ^= (uint8_t)(b & bit(left));
      prefix = (prefix << 1) | b;
    }
    out[i] = acc;
  }
}

void fss_grotto_eval_all(int in_bits, int prg_kind, const uint32_t nonce[2],
                         const uint8_t *aes_keys, int rounds, int party,
                         const uint32_t s0[4], const uint32_t *cws,
                         uint32_t *scratch, uint8_t *ys) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Block seed;
  std::memcpy(seed.w, s0, 16);
  grotto_expand(prg, in_bits, party, seed,
                reinterpret_cast<const Block *>(cws),
                reinterpret_cast<Block *>(scratch), ys);
  uint64_t n = 1ull << in_bits;
  for (uint64_t j = 1; j < n; ++j) ys[j] = ys[j] ^ ys[j - 1];
}

// Batch PRP API (also used for permutation-table precompute).
void fss_prp_permu_batch(const uint8_t sigma[16], uint64_t domain,
                         const uint64_t *xs, int64_t n, uint64_t *ys) {
  prp_permu_batch(sigma, domain, xs, n, ys);
}

// Batch gen loops for single-core benchmarking (amortize the ctypes
// call overhead, mirroring the reference's per-op Google-Benchmark loops).
void fss_dcf_gen_batch(int in_bits, int prg_kind, const uint32_t nonce[2],
                       const uint8_t *aes_keys, int rounds, int group_kind,
                       int group_bits, int pred_lt, const uint32_t *s0s,
                       const uint64_t *alphas, const uint32_t *betas,
                       int64_t n, uint32_t *cws) {
  Prg prg = make_prg(prg_kind, 4, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  int64_t stride = 8 * (in_bits + 1);
  int64_t i = 0;
#if FSS_HAVE_VAES512
  if (prg.kind == 1 && grp.kind == 1 && grp.bits <= 64) {
    for (; i + 4 <= n; i += 4) {
      Block *const cwsk[4] = {
          reinterpret_cast<Block *>(cws + stride * i),
          reinterpret_cast<Block *>(cws + stride * (i + 1)),
          reinterpret_cast<Block *>(cws + stride * (i + 2)),
          reinterpret_cast<Block *>(cws + stride * (i + 3))};
      dcf_gen_vaes4(prg, grp, in_bits, pred_lt,
                    reinterpret_cast<const Block *>(s0s + 8 * i),
                    alphas + i, nullptr,
                    reinterpret_cast<const Block *>(betas + 4 * i),
                    cwsk);
    }
  }
#endif
  for (; i < n; ++i) {
    Block s0s_b[2], beta_b;
    std::memcpy(s0s_b, s0s + 8 * i, 32);
    std::memcpy(beta_b.w, betas + 4 * i, 16);
    dcf_gen(prg, grp, in_bits, pred_lt, s0s_b, alphas[i], 0, beta_b,
            reinterpret_cast<Block *>(cws + stride * i));
  }
}

void fss_ht_gen_batch(int in_bits, int prg_kind, const uint32_t nonce[2],
                      const uint8_t *aes_keys, int rounds, int group_kind,
                      int group_bits, const uint32_t hash_key[4],
                      const uint32_t *s0s, const uint64_t *alphas,
                      const uint32_t *betas, int64_t n, uint32_t *cws,
                      uint32_t *ocws) {
  Prg prg = make_prg(prg_kind, 1, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  HtCtx ht{&prg, Block()};
  std::memcpy(ht.hash_key.w, hash_key, 16);
  int64_t stride = 8 * in_bits;
  int64_t i = 0;
#if FSS_HAVE_AESNI
  if (prg.kind == 1 && in_bits >= 1) {
    for (; i + 4 <= n; i += 4) {
      // Alias the caller arrays directly (unaligned loads/stores).
      Block *const cwsk[4] = {
          reinterpret_cast<Block *>(cws + stride * i),
          reinterpret_cast<Block *>(cws + stride * (i + 1)),
          reinterpret_cast<Block *>(cws + stride * (i + 2)),
          reinterpret_cast<Block *>(cws + stride * (i + 3))};
#if FSS_HAVE_VAES512
      ht_gen_vaes4(ht, grp, in_bits,
                   reinterpret_cast<const Block *>(s0s + 8 * i),
                   alphas + i,
                   reinterpret_cast<const Block *>(betas + 4 * i),
                   cwsk, reinterpret_cast<Block *>(ocws + 4 * i));
#else
      ht_gen_aesni_k<4>(ht, grp, in_bits,
                        reinterpret_cast<const Block *>(s0s + 8 * i),
                        alphas + i, nullptr,
                        reinterpret_cast<const Block *>(betas + 4 * i),
                        cwsk, reinterpret_cast<Block *>(ocws + 4 * i));
#endif
    }
  }
#endif
  for (; i < n; ++i) {
    Block s0s_b[2], beta_b, ocw_b;
    std::memcpy(s0s_b, s0s + 8 * i, 32);
    std::memcpy(beta_b.w, betas + 4 * i, 16);
    ht_gen(ht, grp, in_bits, s0s_b, alphas[i], 0, beta_b,
           reinterpret_cast<Block *>(cws + stride * i), ocw_b);
    std::memcpy(ocws + 4 * i, ocw_b.w, 16);
  }
}

void fss_vdpf_gen_batch(int in_bits, int prg_kind, const uint32_t nonce[2],
                        const uint8_t *aes_keys, int rounds, int hash_kind,
                        const uint8_t *hash_key, int group_kind,
                        int group_bits, const uint32_t *s0s,
                        const uint64_t *alphas, const uint32_t *betas,
                        int64_t n, uint32_t *cws, uint32_t *cs,
                        uint32_t *ocws, int32_t *fails) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Hash xh = make_hash(hash_kind, hash_key);
  int64_t stride = 8 * in_bits;
  int64_t i = 0;
#if FSS_HAVE_VAES512
  if (prg.kind == 1) {
    for (; i + 4 <= n; i += 4) {
      Block s0s_b[8], beta_b[4], ocw_b[4], cs_b[4][4];
      Block *cwsk[4];
      int f4[4];
      std::memcpy(s0s_b, s0s + 8 * i, 128);
      std::memcpy(beta_b, betas + 4 * i, 64);
      for (int k = 0; k < 4; ++k)
        cwsk[k] = reinterpret_cast<Block *>(cws + stride * (i + k));
      vdpf_gen_vaes4(prg, xh, grp, in_bits, s0s_b, alphas + i, beta_b,
                     cwsk, cs_b, ocw_b, f4);
      for (int k = 0; k < 4; ++k) {
        fails[i + k] = f4[k];
        std::memcpy(cs + 16 * (i + k), cs_b[k], 64);
        std::memcpy(ocws + 4 * (i + k), ocw_b[k].w, 16);
      }
    }
  }
#endif
  for (; i < n; ++i) {
    Block s0s_b[2], beta_b, ocw_b, cs_b[4];
    std::memcpy(s0s_b, s0s + 8 * i, 32);
    std::memcpy(beta_b.w, betas + 4 * i, 16);
    fails[i] = vdpf_gen(prg, xh, grp, in_bits, s0s_b, alphas[i], 0, beta_b,
                        reinterpret_cast<Block *>(cws + stride * i), cs_b,
                        ocw_b);
    std::memcpy(cs + 16 * i, cs_b, 64);
    std::memcpy(ocws + 4 * i, ocw_b.w, 16);
  }
}

// VDMPF key generation (vdmpf.cuh:135-189): Cuckoo placement with the
// reference's std::mt19937(42) eviction stream, then per-bucket inner
// VDPF Gens (empty buckets get the zero function). Returns 0 on success,
// 1 on Cuckoo or inner-Gen failure (caller resamples sigma + seeds).
int fss_vdmpf_gen(int bucket_bits, int prg_kind, const uint32_t nonce[2],
                  const uint8_t *aes_keys, int rounds, int hash_kind,
                  const uint8_t *hash_key, int group_kind, int group_bits,
                  const uint8_t sigma[16], uint64_t n, int m, int m_rt,
                  int b_size, int kappa, const uint32_t *s0s,
                  const uint64_t *alphas, const uint32_t *betas, int t,
                  int ch_retry, uint32_t *cws, uint32_t *cs,
                  uint32_t *ocw) {
  // Gen places with bucket = (y / b_size) % m_rt while BatchEval routes
  // with a plain divide plus a bucket >= m skip; the two agree only when
  // every y < m_rt * b_size, i.e. b_size * m_rt >= n * kappa (the PRP
  // domain). Reject violating callers instead of silently disagreeing.
  if ((uint64_t)b_size * (uint64_t)m_rt < n * (uint64_t)kappa) return 1;

  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Hash xh = make_hash(hash_kind, hash_key);

  // Compact Cuckoo insertion (cuckoo_hash.cuh:154-199).
  std::vector<std::pair<int, int>> table(m_rt, {-1, -1});
  std::mt19937 rng(42);
  for (int omega = 0; omega < t; ++omega) {
    int cur_idx = omega;
    int cur_k = (int)(rng() % (uint32_t)kappa);
    int evictions = 0;
    for (;;) {
      uint64_t val = alphas[cur_idx] + n * (uint64_t)cur_k;
      uint64_t y;
      prp_permu_batch(sigma, n * (uint64_t)kappa, &val, 1, &y);
      int bucket = (int)((y / (uint64_t)b_size) % (uint64_t)m_rt);
      if (table[bucket].first == -1) {
        table[bucket] = {cur_idx, cur_k};
        break;
      }
      int evicted = table[bucket].first;
      table[bucket] = {cur_idx, cur_k};
      cur_idx = evicted;
      cur_k = (int)(rng() % (uint32_t)kappa);
      if (++evictions > ch_retry) return 1;
    }
  }

  for (int i = 0; i < m; ++i) {
    uint64_t a_prime = 0;
    Block b_prime = {};
    if (i < m_rt && table[i].first != -1) {
      int j = table[i].first;
      int k = table[i].second;
      uint64_t val = alphas[j] + n * (uint64_t)k;
      uint64_t y;
      prp_permu_batch(sigma, n * (uint64_t)kappa, &val, 1, &y);
      a_prime = y % (uint64_t)b_size;
      std::memcpy(b_prime.w, betas + 4 * j, 16);
    }
    Block seeds[2], csb[4], ocwb;
    std::memcpy(seeds, s0s + 8 * i, 32);
    int ret = vdpf_gen(prg, xh, grp, bucket_bits, seeds, a_prime, 0,
                       b_prime, reinterpret_cast<Block *>(
                           cws + 8 * bucket_bits * i), csb, ocwb);
    if (ret != 0) return 1;
    std::memcpy(cs + 16 * i, csb, 64);
    std::memcpy(ocw + 4 * i, ocwb.w, 16);
  }
  return 0;
}

// Full VDMPF BatchEval (vdmpf.cuh:202-270): route, dedupe, inner VDPF
// evals, group accumulation, and the reference's two-level proof chain.
// Bucket keys laid out as in the JAX engine: s0 [m,4], cws [m,bb,8],
// cs [m,4,4], ocw [m,4], all uint32.
void fss_vdmpf_batch_eval(int bucket_bits, int prg_kind,
                          const uint32_t nonce[2], const uint8_t *aes_keys,
                          int rounds, int hash_kind,
                          const uint8_t *hash_key, int group_kind,
                          int group_bits, int party,
                          const uint8_t sigma[16], uint64_t n, int m,
                          int b_size, int kappa, const uint32_t *s0,
                          const uint32_t *cws, const uint32_t *cs,
                          const uint32_t *ocw, const uint64_t *xs,
                          int64_t eta, uint32_t *ys, uint32_t *pi_out) {
  Prg prg = make_prg(prg_kind, 2, nonce, aes_keys, rounds);
  Group grp{group_kind, group_bits};
  Hash h = make_hash(hash_kind, hash_key);

  // Route all points; per-bucket lists with (j, omega) dedupe
  // (vdmpf.cuh:213-232).
  std::vector<std::vector<std::pair<uint32_t, int64_t>>> inputs(m);
  for (int64_t omega = 0; omega < eta; ++omega) {
    for (int k = 0; k < kappa; ++k) {
      uint64_t val = xs[omega] + n * (uint64_t)k;
      uint64_t y;
      prp_permu_batch(sigma, n * (uint64_t)kappa, &val, 1, &y);
      int bucket = (int)(y / (uint64_t)b_size);
      if (bucket >= m) continue;
      uint32_t j = (uint32_t)(y % (uint64_t)b_size);
      bool dup = false;
      for (auto &e : inputs[bucket])
        if (e.first == j && e.second == omega) { dup = true; break; }
      if (!dup) inputs[bucket].push_back({j, omega});
    }
  }

  for (int64_t i = 0; i < eta; ++i)
    ys[4 * i] = ys[4 * i + 1] = ys[4 * i + 2] = ys[4 * i + 3] = 0;
  Block pi[4] = {};

  for (int i = 0; i < m; ++i) {
    Block pib[4];
    std::memcpy(pib, cs + 16 * i, 64);
    Block seed;
    std::memcpy(seed.w, s0 + 4 * i, 16);
    Block ocwb;
    std::memcpy(ocwb.w, ocw + 4 * i, 16);
    const Block *bk_cws =
        reinterpret_cast<const Block *>(cws + 8 * bucket_bits * i);
    Block csb[4];
    std::memcpy(csb, cs + 16 * i, 64);
    for (auto &[j, omega] : inputs[i]) {
      Block y, pt[4];
      vdpf_eval(prg, h, grp, bucket_bits, party, seed, bk_cws, csb, ocwb,
                j, 0, y, pt);
      Block cur;
      std::memcpy(cur.w, ys + 4 * omega, 16);
      u128 acc = grp.add(grp.from_block(cur), grp.from_block(y));
      grp.into_block(acc, cur);
      std::memcpy(ys + 4 * omega, cur.w, 16);
      vdpf_fold_step(h, pib, pt);
    }
    vdpf_fold_step(h, pi, pib);
  }
  std::memcpy(pi_out, pi, 64);
}

// VDMPF routing (vdmpf.cuh:213-232): Locate each x under all kappa hash
// functions: y = PRP(sigma, x + n*k) over domain n*kappa; bucket = y / B,
// index = y % B. Output arrays are [eta, kappa], point-major.
void fss_vdmpf_route(const uint8_t sigma[16], uint64_t n, int b_size,
                     int kappa, const uint64_t *xs, int64_t eta,
                     int32_t *bucket, int32_t *index) {
  for (int k = 0; k < kappa; ++k) {
    for (int64_t i = 0; i < eta; ++i) {
      uint64_t val = xs[i] + n * (uint64_t)k;
      uint64_t y;
      prp_permu_batch(sigma, n * (uint64_t)kappa, &val, 1, &y);
      bucket[i * kappa + k] = (int32_t)(y / (uint64_t)b_size);
      index[i * kappa + k] = (int32_t)(y % (uint64_t)b_size);
    }
  }
}

}  // extern "C"
