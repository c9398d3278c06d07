// Two-server PIR's contraction: a server's Q answer shares over one table,
//
//   ans[q][d] = sum_j sel[q][j] * db[j][d]  (mod 2^32),
//
// sel[q] being the server's selector shares of query q (the Uint(32) DPF
// EvalAll's word 0 a leaf) and db the [N, D] table of 32-bit words. The
// selector shares of the two servers add to the one-hot vector of the
// private row, and multiplication distributes over additive shares mod 2^32,
// so the two answers add to db[idx].
//
// Replaces the XLA glue of the JAX package's PIR, `(sel[:, None] *
// db).sum(axis=0, dtype=int32)` (fss_tpu/parallel/mesh.py:129,
// samples/pir_tpu.py:61), one query a pass; no Pallas kernel computes it.
//
// Bound on the H100: the bytes and the multiply-adds about equally at Q =
// 32. The table is read once a launch whatever Q (N * D * 4 bytes; 268 MB
// for 2^20 x 256 B) and each selector word once (Q * N * 4); at Q = 32, D =
// 64 that is 0.120 ms at 3.35 TB/s against 0.128 ms of Q * N * D IMADs at
// 64 an SM a clock x 132 SMs x 1.98 GHz; below Q = 29 the bytes bound it,
// above the IMADs. The selector words sit 16 bytes apart in the EvalAll's
// [N, 4] shares, so the sectors read for them are four times the words used.
//
// Design: each CTA owns a run of 32-row stages of the table and a tile of
// 32 * C columns (C = 2 with 8-byte loads where D is even and the table is
// 8-byte aligned, else 1). Each warp reads its rows of the tile (a row a warp
// at a time, neighbouring lanes on neighbouring words) into registers, one
// stage ahead of the one it multiplies; the stage's Q x 32 selector words go
// to shared memory by cp.async, also a stage ahead, where every lane of the
// warp reads the same four queries with one 16-byte load. Each thread keeps
// Q x C sums in registers; at the end the CTA's warps add theirs in shared
// memory and the CTA adds its tile to the answers with one atomicAdd a word
// (the answers are zeroed first). Addition mod 2^32 is exact in any order.

#include <cuda_runtime.h>
#include <stdint.h>

#include <algorithm>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 32;              // table rows a stage
constexpr int kRowsAWarp = kRows / kWarps;
constexpr int kMaxQueries = 64;

// Words a staged row of selectors takes in shared memory: a multiple of 4
// for the 16-byte loads, and 4 words more than the queries so that
// neighbouring rows start in other banks.
template <int QMAX>
constexpr int kStride = QMAX + 4;

// One 4-byte cp.async into shared memory, zero-filled where !valid.
__device__ __forceinline__ void copy_word(uint32_t* dst, const int32_t* src,
                                          bool valid) {
  const unsigned d = static_cast<unsigned>(__cvta_generic_to_shared(dst));
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(d),
               "l"(src), "r"(valid ? 4 : 0));
}

__device__ __forceinline__ void commit_copies() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Waits until at most one group of copies, the newest, is in flight.
__device__ __forceinline__ void wait_older_copies() {
  asm volatile("cp.async.wait_group 1;\n" ::: "memory");
}

// The selectors of rows row0 .. row0 + kRows - 1 into `staged` [kRows][QMAX
// + 4]: a warp copies 8 rows x 4 queries a step, lane = row + 8 * query, so
// that its stores fall in 32 banks and its loads in four 128-byte runs.
template <int QMAX>
__device__ __forceinline__ void stage_selectors(uint32_t* staged,
                                                const int32_t* sel,
                                                int64_t sel_qs, int64_t sel_js,
                                                int64_t row0, int64_t rows,
                                                int queries) {
  constexpr int kRowSteps = kRows / 8;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
#pragma unroll
  for (int c = warp; c < kRowSteps * (QMAX / 4); c += kWarps) {
    const int r = (c % kRowSteps) * 8 + (lane & 7);
    const int q = (c / kRowSteps) * 4 + (lane >> 3);
    const int64_t j = row0 + r;
    const bool valid = j < rows && q < queries;
    copy_word(staged + r * kStride<QMAX> + q,
              valid ? sel + q * sel_qs + j * sel_js : sel, valid);
  }
}

// C words of a table row from column `col`, zero past the table's edge.
template <int C>
struct Words {
  uint32_t w[C];
};

template <int C>
__device__ __forceinline__ Words<C> load_row(const int32_t* db, int64_t j,
                                             int64_t col, int64_t rows,
                                             int cols) {
  Words<C> x;
  if (j < rows && col < cols) {
    const int32_t* p = db + j * cols + col;
    if constexpr (C == 2) {
      const int2 v = __ldcs(reinterpret_cast<const int2*>(p));
      x.w[0] = static_cast<uint32_t>(v.x);
      x.w[1] = static_cast<uint32_t>(v.y);
    } else {
      x.w[0] = static_cast<uint32_t>(__ldcs(p));
    }
  } else {
#pragma unroll
    for (int c = 0; c < C; ++c) x.w[c] = 0;
  }
  return x;
}

// grid (CTAs along the rows, column tiles); CTA x takes stages
// [x * stages_a_cta, (x + 1) * stages_a_cta) of the table's ceil(rows /
// kRows), column tile y the columns [y * 32 * C, (y + 1) * 32 * C).
// sel: query q's word of row j at sel[q * sel_qs + j * sel_js]; out: the
// [queries, cols] answers, zero on entry.
template <int QMAX, int C>
__global__ void __launch_bounds__(kThreads, 2)
    pir_contract_kernel(const int32_t* __restrict__ sel, int64_t sel_qs,
                        int64_t sel_js, const int32_t* __restrict__ db,
                        int64_t rows, int cols, int queries,
                        int64_t stages_a_cta, uint32_t* __restrict__ out) {
  constexpr int kTile = 32 * C;
  static_assert(QMAX % 4 == 0 && QMAX <= kMaxQueries, "queries");
  // The CTA's reduction reuses the staging buffers.
  static_assert(QMAX * kTile <= 2 * kRows * kStride<QMAX>, "reduction");
  __shared__ __align__(16) uint32_t staged[2][kRows * kStride<QMAX>];

  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int64_t col = static_cast<int64_t>(blockIdx.y) * kTile + lane * C;
  const int64_t total = (rows + kRows - 1) / kRows;
  const int64_t first = static_cast<int64_t>(blockIdx.x) * stages_a_cta;
  const int64_t end =
      first + stages_a_cta < total ? first + stages_a_cta : total;

  uint32_t acc[QMAX][C];
#pragma unroll
  for (int q = 0; q < QMAX; ++q) {
#pragma unroll
    for (int c = 0; c < C; ++c) acc[q][c] = 0;
  }

  Words<C> cur[kRowsAWarp], next[kRowsAWarp];
  stage_selectors<QMAX>(staged[0], sel, sel_qs, sel_js, first * kRows, rows,
                        queries);
  commit_copies();
#pragma unroll
  for (int u = 0; u < kRowsAWarp; ++u) {
    cur[u] = load_row<C>(db, first * kRows + warp + kWarps * u, col, rows,
                         cols);
  }
  int buf = 0;
  for (int64_t s = first; s < end; ++s) {
    if (s + 1 < end) {
      stage_selectors<QMAX>(staged[buf ^ 1], sel, sel_qs, sel_js,
                            (s + 1) * kRows, rows, queries);
#pragma unroll
      for (int u = 0; u < kRowsAWarp; ++u) {
        next[u] = load_row<C>(db, (s + 1) * kRows + warp + kWarps * u, col,
                              rows, cols);
      }
    }
    commit_copies();  // empty on the last stage: the wait stays uniform
    wait_older_copies();
    __syncthreads();
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) {
      const uint4* y = reinterpret_cast<const uint4*>(
          staged[buf] + (warp + kWarps * u) * kStride<QMAX>);
#pragma unroll
      for (int q4 = 0; q4 < QMAX / 4; ++q4) {
        const uint4 v = y[q4];
#pragma unroll
        for (int c = 0; c < C; ++c) {
          acc[4 * q4 + 0][c] += v.x * cur[u].w[c];
          acc[4 * q4 + 1][c] += v.y * cur[u].w[c];
          acc[4 * q4 + 2][c] += v.z * cur[u].w[c];
          acc[4 * q4 + 3][c] += v.w * cur[u].w[c];
        }
      }
    }
    __syncthreads();  // staged[buf] is refilled two stages on
#pragma unroll
    for (int u = 0; u < kRowsAWarp; ++u) cur[u] = next[u];
    buf ^= 1;
  }

  // The warps' sums of the tile, added in shared memory, then to the
  // answers. The loop's last wait and barrier left no copy in flight.
  uint32_t* red = &staged[0][0];
  for (int i = threadIdx.x; i < QMAX * kTile; i += kThreads) red[i] = 0;
  __syncthreads();
#pragma unroll
  for (int q = 0; q < QMAX; ++q) {
    if (q < queries) {
#pragma unroll
      for (int c = 0; c < C; ++c) atomicAdd(&red[q * kTile + lane * C + c],
                                            acc[q][c]);
    }
  }
  __syncthreads();
  for (int i = threadIdx.x; i < queries * kTile; i += kThreads) {
    const int64_t d = static_cast<int64_t>(blockIdx.y) * kTile + i % kTile;
    if (d < cols) atomicAdd(&out[(i / kTile) * static_cast<int64_t>(cols) + d],
                            red[i]);
  }
}

int sm_count() {
  static const int sms = [] {
    int dev = 0, n = 0;
    cudaGetDevice(&dev);
    cudaDeviceGetAttribute(&n, cudaDevAttrMultiProcessorCount, dev);
    return n > 0 ? n : 1;
  }();
  return sms;
}

template <int QMAX, int C>
int launch(const int32_t* sel, int64_t sel_qs, int64_t sel_js,
           const int32_t* db, int64_t rows, int cols, int queries,
           uint32_t* out, cudaStream_t stream) {
  auto kernel = pir_contract_kernel<QMAX, C>;
  static const int resident = [kernel] {
    int n = 0;
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&n, kernel, kThreads, 0);
    return n > 0 ? n : 1;
  }();
  const int64_t tiles = (cols + 32 * C - 1) / (32 * C);
  const int64_t total = (rows + kRows - 1) / kRows;
  // One wave of CTAs over the card, split among the column tiles.
  const int64_t want = static_cast<int64_t>(sm_count()) * resident;
  const int64_t ctas = std::max<int64_t>(1, std::min(total, want / tiles));
  const int64_t stages_a_cta = (total + ctas - 1) / ctas;
  const dim3 grid(static_cast<unsigned>((total + stages_a_cta - 1) /
                                        stages_a_cta),
                  static_cast<unsigned>(tiles));
  kernel<<<grid, kThreads, 0, stream>>>(sel, sel_qs, sel_js, db, rows, cols,
                                        queries, stages_a_cta, out);
  return (int)cudaGetLastError();
}

}  // namespace

// out [queries, cols] int32 answers (uint32 bits) of sel against db [rows,
// cols]; sel_qs, sel_js the selectors' strides in words. wide: cols is even
// and db 8-byte aligned, so that a thread may load two words at once.
extern "C" int fss_pir_contract(const void* sel, int64_t sel_qs,
                                int64_t sel_js, const void* db, int64_t rows,
                                int cols, int queries, int wide, void* out,
                                void* stream) {
  if (rows < 1 || cols < 1 || queries < 1 || queries > kMaxQueries) {
    return (int)cudaErrorInvalidValue;
  }
  cudaStream_t st = (cudaStream_t)stream;
  const cudaError_t rc = cudaMemsetAsync(
      out, 0, static_cast<size_t>(queries) * cols * sizeof(uint32_t), st);
  if (rc != cudaSuccess) return (int)rc;
  const auto* s = static_cast<const int32_t*>(sel);
  const auto* d = static_cast<const int32_t*>(db);
  auto* o = static_cast<uint32_t*>(out);
#define FSS_PIR_CONTRACT(Q, C) \
  launch<Q, C>(s, sel_qs, sel_js, d, rows, cols, queries, o, st)
  if (queries <= 4) {
    return wide ? FSS_PIR_CONTRACT(4, 2) : FSS_PIR_CONTRACT(4, 1);
  }
  if (queries <= 32) {
    return wide ? FSS_PIR_CONTRACT(32, 2) : FSS_PIR_CONTRACT(32, 1);
  }
  return FSS_PIR_CONTRACT(64, 1);  // 64 x 2 sums would not fit the registers
#undef FSS_PIR_CONTRACT
}
