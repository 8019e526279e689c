// Streaming exact top-k similarity search for NVIDIA Hopper (sm_90a).
//
// Replaces multimodalsimilar_tpu/ops/topk.py:_topk_kernel, the Pallas TPU
// kernel launched by pallas_topk. For each query it returns the exact top k
// corpus rows by inner product ("ip") or by squared L2 distance ("l2"),
// with f32-accurate scores, corpus rows at index >= true_n never read,
// ties to the lowest corpus index (FAISS order), k <= 128.
//
// What bounds it on this card: the 2*Q*N*d multiply-adds. Taken at f32
// accuracy on the tensor cores as three TF32 products (tf32x3.cuh), the
// card's fastest f32-accurate route is 495 / 3 = 165 TFLOP/s, so 4,096
// queries against 262,144 x 768 take at least 10.0 ms. A block of 128
// queries turns each corpus byte it stages into 32 multiply-adds, above
// the 25 that 165 TFLOP/s needs per byte at 3.35 TB/s, so large searches
// are bound by operations; a 64-query search is bound by reading the
// corpus once (0.240 ms at 262,144 x 768). The running top-k costs one
// register compare per score plus about k*ln(N/k) insertions per query.
//
// Design. A block is one producer warpgroup and one or two consumer
// warpgroups of 64 queries each (TQ = 64 or 128), walking its corpus range
// in chunks of TN = 128 rows. The (chunk, 32-deep K slice) steps form one
// flat sequence through a ring of 2-4 shared-memory slots (as many as fit
// beside the running lists for this k). The producer copies each slice of
// the queries and of the corpus into its slot with TMA (cp.async where
// rows are not 16-byte aligned), splits the corpus slice into TF32 big and
// small tiles, and marks the slot full; each consumer warpgroup splits its
// queries in registers and takes its [64 x 128] scores with wgmma
// m64n128k8 3xTF32, then releases the slot (tf32x3.cuh). The scores stay
// in registers. Selection from registers: each thread holds the k-th
// value of its 2 query rows and offers only scores above it; a stale
// (lower) threshold only admits more. Survivors go to a per-query buffer
// of 16 slots (an atomic slot count per query), and a warp per query
// inserts them into the query's sorted list in shared memory. Insertion
// ranks by (value desc, index asc), so the order in which survivors
// arrive does not matter and the list is in FAISS order. If a query has
// more than 16 survivors in a chunk (the first chunks), the rest stay
// unoffered in registers and the consumers repeat the offer against the
// refreshed thresholds until every survivor has been offered; meanwhile
// the producer keeps filling the ring. For l2 the squared norms of the
// queries and of the corpus rows come from a one-warp-per-row pre-pass
// into a scratch vector the wrapper owns, and each score is
// -(|q|^2 - 2 q.x + |x|^2). When Q is small the corpus is split over
// gridDim.y so that the blocks fill the card in one wave; each split
// writes its partial lists and a second kernel merges the splits with the
// same insertion rule.
//
// Shared memory: a ring slot is 48 KB (128 queries) or 40 KB (64), the
// lists TQ x k x 8 bytes, the survivor buffers TQ x 128 bytes. 128
// queries: 4 slots up to k = 17, 3 up to k = 65, 2 up to k = 113; beyond
// that, 64 queries with 3 slots. ptxas (printed by chip_smoke.py): 168
// registers at launch with two consumer warpgroups, moved by setmaxnreg
// to 232 for the consumers and 40 for the producer; 207-211 with one; no
// spills.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (multimodalsimilar_tpu_torch/ops/topk.py). The
// kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <math_constants.h>

#include <cstdint>

#include "tf32x3.cuh"

namespace {

using tf32x3::kSlice;

constexpr int kTN = 128;         // corpus rows per chunk (the wgmma's N)
constexpr int kMaxK = 128;
constexpr int kCap = 16;         // survivor slots per query per round
constexpr int kMergeWarps = 8;
constexpr int kBFloats = tf32x3::tile_floats(kTN);
constexpr size_t kSmemMax = 232448;   // 227 KB, the most a block may use
constexpr int kFillIdx = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// A block is kWG warpgroups, each owning 64 queries: TQ = 64 * kWG.
__host__ __device__ constexpr int query_tile(int wg) { return 64 * wg; }
__host__ __device__ constexpr int stage_floats(int wg) {
  return tf32x3::tile_floats(query_tile(wg)) + 2 * kBFloats;
}

// Ring (1024-byte aligned, hence the slack), lists, survivor buffers,
// counts and flags, and one mbarrier per stage.
size_t main_smem(int wg, int stages, int k) {
  const size_t tq = query_tile(wg);
  return 1024 + 8 * static_cast<size_t>(stages) +
         sizeof(float) * (static_cast<size_t>(stages) * stage_floats(wg) +
                          2 * tq * k + 2 * tq * kCap + tq + 4);
}

// The launch configurations, the first that fits is taken: two consumer
// warpgroups (128 queries) with four, three or two ring stages, or one
// (64 queries) with three where the lists of 128 queries leave too little
// room (k > 113).
struct Config {
  int wg, stages;
};
constexpr Config kConfigs[] = {{2, 4}, {2, 3}, {2, 2}, {1, 3}};

Config pick(int k) {
  for (const Config& c : kConfigs)
    if (main_smem(c.wg, c.stages, k) <= kSmemMax) return c;
  return {0, 0};
}

// (v, i) ranks before (w, j): larger value, ties to the lower index.
__device__ __forceinline__ bool before(float v, int i, float w, int j) {
  return v > w || (v == w && i < j);
}

// Insert (v, id) into the warp's sorted list (lv, li) of length k; the
// caller has checked that it ranks before the k-th entry.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float v, int id, int lane) {
  int pos = 0;
  for (int b = 0; b < k; b += 32) {
    const int j = b + lane;
    pos += __popc(__ballot_sync(kFull, j < k && before(lv[j], li[j], v, id)));
  }
  float tv[kMaxK / 32];
  int ti[kMaxK / 32];
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = r * 32 + lane;
    if (j >= pos && j < k - 1) {
      tv[r] = lv[j];
      ti[r] = li[j];
    }
  }
  __syncwarp();
#pragma unroll
  for (int r = 0; r < kMaxK / 32; ++r) {
    const int j = r * 32 + lane;
    if (j >= pos && j < k - 1) {
      lv[j + 1] = tv[r];
      li[j + 1] = ti[r];
    }
  }
  if (lane == 0) {
    lv[pos] = v;
    li[pos] = id;
  }
  __syncwarp();
}

// Offer one candidate per lane (where valid) to the warp's list.
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k,
                                           float v, int id, bool valid,
                                           int lane) {
  unsigned m =
      __ballot_sync(kFull, valid && before(v, id, lv[k - 1], li[k - 1]));
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int cid = __shfl_sync(kFull, id, src);
    if (before(cv, cid, lv[k - 1], li[k - 1]))
      warp_insert(lv, li, k, cv, cid, lane);
  }
}

// One warp per row: out[r] = sum of squares of row r of q (r < n_q) or of
// x (r - n_q), the norms of the l2 scores.
__global__ void __launch_bounds__(kMergeWarps * 32)
sq_norms_kernel(const float* __restrict__ q, const float* __restrict__ x,
                int n_q, int n_x, int d, float* __restrict__ out) {
  const int row = blockIdx.x * kMergeWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= n_q + n_x) return;   // whole warps leave together
  const float* src = row < n_q ? q + static_cast<size_t>(row) * d
                               : x + static_cast<size_t>(row - n_q) * d;
  float s = 0.f;
  for (int c = lane; c < d; c += 32) s = fmaf(src[c], src[c], s);
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
  if (lane == 0) out[row] = s;
}

template <bool kL2, int kWG, int kStages>
__global__ void __launch_bounds__(128 * (kWG + 1), 1)
topk_kernel(const __grid_constant__ CUtensorMap map_q,
            const __grid_constant__ CUtensorMap map_x,
            const float* __restrict__ q, const float* __restrict__ x,
            const float* __restrict__ norms, float* __restrict__ out_v,
            int* __restrict__ out_i, int n_q, int d, int true_n, int k,
            int rows_per_split, int negate, int tma) {
  constexpr int kTQ = query_tile(kWG);
  constexpr int kConsumers = 128 * kWG;     // threads of the consumers
  constexpr int kAll = kConsumers + 128;    // and the producer warpgroup
  constexpr int kStage = stage_floats(kWG);
  extern __shared__ __align__(16) float smem[];
  float* ring = tf32x3::align1024(smem);               // [kStages][stage]
  float* lv = ring + kStages * kStage;                 // [kTQ][k]
  int* li = reinterpret_cast<int*>(lv + kTQ * k);      // [kTQ][k]
  float* bv = reinterpret_cast<float*>(li + kTQ * k);  // [kTQ][kCap]
  int* bi = reinterpret_cast<int*>(bv + kTQ * kCap);   // [kTQ][kCap]
  int* cnt = bi + kTQ * kCap;                          // [kTQ]
  int* more = cnt + kTQ;                               // [kWG][2]
  uint64_t* bars = reinterpret_cast<uint64_t*>(more + 4);  // [kStages]

  const int tid = threadIdx.x;
  const int q0 = blockIdx.x * kTQ;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(true_n, row_begin + rows_per_split);
  const int n_slices = (d + kSlice - 1) / kSlice;
  const int steps = ((row_end - row_begin + kTN - 1) / kTN) * n_slices;

  for (int e = tid; e < kTQ * k; e += kAll) {
    lv[e] = -CUDART_INF_F;
    li[e] = kFillIdx;
  }
  for (int e = tid; e < kTQ; e += kAll) cnt[e] = 0;
  if (tid < 4) more[tid] = 0;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tf32x3::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // -- the producer warpgroup: copies and splits, nothing else ----------
    if constexpr (kWG == 2) tf32x3::regs_dec<40>();
    const int ptid = tid - kConsumers;
    tf32x3::produce<kStages, kWG>(
        steps, tma, bars, 4 * (tf32x3::tile_floats(kTQ) + kBFloats), ptid,
        [&](int st, int slot) {
          const int chunk = st / n_slices;
          const int k0 = (st - chunk * n_slices) * kSlice;
          const int rb = row_begin + chunk * kTN;
          float* a = ring + slot * kStage;
          float* b = a + tf32x3::tile_floats(kTQ);
          if (tma) {
            tf32x3::tma_load(a, &map_q, k0, q0, bars + slot);
            tf32x3::tma_load(b, &map_x, k0, rb, bars + slot);
          } else {
            tf32x3::load_chunks<kTQ, 128>(a, q, q0, n_q, d, k0, ptid);
            tf32x3::load_chunks<kTN, 128>(b, x, rb, row_end, d, k0, ptid);
          }
        },
        [&](int slot) {
          float* b = ring + slot * kStage + tf32x3::tile_floats(kTQ);
          tf32x3::split_chunks<kTN, 128>(b, b + kBFloats, ptid,
                                         [](int, float4) {});
        });
    return;
  }

  // -- the consumer warpgroups: products and selection ----------------------
  if constexpr (kWG == 2) tf32x3::regs_inc<232>();
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int g = lane >> 2;
  const int t = lane & 3;
  const int row0 = 16 * warp;      // this warp's 16 queries of the tile
  // Each consumer warpgroup owns 64 queries: their lists, survivors and
  // syncs are its own, so one warpgroup selects while the other multiplies.
  const int wg = warp / 4;
  const int wg_rows = 64 * wg;
  const int wg_bar = tf32x3::kConsumerBarrier - wg;
  int* wg_more = more + 2 * wg;

  // This thread's scores are query rows row0 + g + 8h against chunk
  // columns 8j + 2t + e, in acc[4j + 2h + e]; bit 4j + 2h + e of a mask.
  float thr[2], qn[2];
  unsigned long long dead_rows = 0;
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    const int r = q0 + row0 + g + 8 * h;
    thr[h] = -CUDART_INF_F;
    qn[h] = (kL2 && r < n_q) ? norms[r] : 0.f;
    if (r >= n_q) dead_rows |= 0x3333333333333333ull << (2 * h);
  }

  float acc[kTN / 2] = {};
  int round = 0;
  int slice = 0;
  int r0 = row_begin;
  for (int s = 0; s < steps; ++s) {
    tf32x3::wait_full<kStages, kWG>(s, wg);
    const float* st = ring + (s % kStages) * kStage;
    const float* b_big = st + tf32x3::tile_floats(kTQ);
    float part[kTN / 2], unused[2] = {};
    tf32x3::slice_product<kTN>(part, unused, st, row0, b_big,
                               b_big + kBFloats, lane);
    tf32x3::release<kStages, kWG>(s);
#pragma unroll
    for (int e = 0; e < kTN / 2; ++e)
      acc[e] = slice == 0 ? part[e] : acc[e] + part[e];
    if (++slice < n_slices) continue;
    slice = 0;

    // -- the chunk's scores are complete: select from registers ----------
    unsigned long long offered = dead_rows;
#pragma unroll
    for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = r0 + 8 * j + 2 * t + e;
        const float xn = (kL2 && col < row_end) ? norms[n_q + col] : 0.f;
#pragma unroll
        for (int h = 0; h < 2; ++h) {
          float& v = acc[4 * j + 2 * h + e];
          if (kL2) v = -(qn[h] - 2.0f * v + xn);
          if (col >= row_end || !(v > -CUDART_INF_F))
            offered |= 1ull << (4 * j + 2 * h + e);
        }
      }
    for (bool first = true;; first = false) {
#pragma unroll
      for (int j = 0; j < kTN / 8; ++j)
#pragma unroll
        for (int h = 0; h < 2; ++h)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int bit = 4 * j + 2 * h + e;
            const float v = acc[bit];
            // round one: strictly above the k-th value, since every
            // listed row has a lower index; later rounds: the k-th may
            // be a row of this chunk with a higher index
            if ((offered >> bit & 1) ||
                !(v > thr[h] || (!first && v == thr[h])))
              continue;
            const int row = row0 + g + 8 * h;
            const int at = atomicAdd(&cnt[row], 1);
            if (at < kCap) {
              bv[row * kCap + at] = v;
              bi[row * kCap + at] = r0 + 8 * j + 2 * t + e;
              offered |= 1ull << bit;
            } else {
              wg_more[round & 1] = 1;
            }
          }
      tf32x3::bar_sync(wg_bar, 128);
      const bool again = wg_more[round & 1] != 0;
      for (int r = wg_rows + warp % 4; r < wg_rows + 64; r += 4) {
        const int n = min(cnt[r], kCap);
        if (n == 0) continue;
        const bool has = lane < n;
        warp_offer(lv + r * k, li + r * k, k,
                   has ? bv[r * kCap + lane] : -CUDART_INF_F,
                   has ? bi[r * kCap + lane] : kFillIdx, has, lane);
        __syncwarp();
        if (lane == 0) cnt[r] = 0;
      }
      if (tid % 128 == 0) wg_more[(round + 1) & 1] = 0;
      tf32x3::bar_sync(wg_bar, 128);
      ++round;
#pragma unroll
      for (int h = 0; h < 2; ++h)
        thr[h] = lv[(row0 + g + 8 * h) * k + k - 1];
      if (!again) break;
    }
    r0 += kTN;
  }

  tf32x3::bar_sync(wg_bar, 128);
  for (int r = wg_rows + warp % 4; r < wg_rows + 64; r += 4) {
    if (q0 + r >= n_q) break;
    const size_t o = (static_cast<size_t>(blockIdx.y) * n_q + q0 + r) * k;
    for (int j = lane; j < k; j += 32) {
      const float v = lv[r * k + j];
      out_v[o + j] = negate ? -v : v;
      out_i[o + j] = li[r * k + j];
    }
  }
}

// One warp per query: fold the splits' partial lists into the final top-k.
__global__ void __launch_bounds__(kMergeWarps * 32)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n_q, int k, int splits,
                  int negate) {
  extern __shared__ float msmem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kMergeWarps + warp;
  if (qi >= n_q) return;                   // warp-uniform
  float* lv = msmem + warp * k;
  int* li = reinterpret_cast<int*>(msmem + kMergeWarps * k) + warp * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = -CUDART_INF_F;
    li[j] = kFillIdx;
  }
  __syncwarp();
  for (int s = 0; s < splits; ++s) {
    const size_t o = (static_cast<size_t>(s) * n_q + qi) * k;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int j = c0 + lane;
      warp_offer(lv, li, k, j < k ? part_v[o + j] : -CUDART_INF_F,
                 j < k ? part_i[o + j] : kFillIdx, j < k, lane);
    }
  }
  const size_t o = static_cast<size_t>(qi) * k;
  for (int j = lane; j < k; j += 32) {
    out_v[o + j] = negate ? -lv[j] : lv[j];
    out_i[o + j] = li[j];
  }
}

struct Args {
  CUtensorMap map_q, map_x;
  const float *q, *x, *norms;
  float* v;
  int* i;
  int n_q, d, true_n, k, rows_per_split, negate, tma;
};

template <bool kL2, int kWG, int kStages>
cudaError_t launch_main(dim3 grid, cudaStream_t st, const Args& a) {
  const cudaError_t err = tf32x3::max_smem_once<
      topk_kernel<kL2, kWG, kStages>>(static_cast<int>(kSmemMax));
  if (err != cudaSuccess) return err;
  const size_t smem = main_smem(kWG, kStages, a.k);
  topk_kernel<kL2, kWG, kStages><<<grid, 128 * (kWG + 1), smem, st>>>(
      a.map_q, a.map_x, a.q, a.x, a.norms, a.v, a.i, a.n_q, a.d, a.true_n,
      a.k, a.rows_per_split, a.negate, a.tma);
  return cudaGetLastError();
}

template <bool kL2>
cudaError_t launch_config(Config c, dim3 grid, cudaStream_t st,
                          const Args& a) {
  if (c.wg == 2 && c.stages == 4) return launch_main<kL2, 2, 4>(grid, st, a);
  if (c.wg == 2 && c.stages == 3) return launch_main<kL2, 2, 3>(grid, st, a);
  if (c.wg == 2) return launch_main<kL2, 2, 2>(grid, st, a);
  return launch_main<kL2, 1, 3>(grid, st, a);
}

}  // namespace

extern "C" {

int mms_topk_max_k() { return kMaxK; }

// Queries per block at this k: 128, or 64 where the lists leave too
// little shared memory for two warpgroups (k > 113).
int mms_topk_query_tile(int k) { return query_tile(pick(k).wg); }

int mms_topk_chunk_rows() { return kTN; }

// queries [n_q, d] and corpus [>= true_n, d] f32 row-major on the device.
// out_v [n_q, k] f32 and out_i [n_q, k] int32. With splits > 1 the corpus
// rows [s * rows_per_split, (s + 1) * rows_per_split) go to split s, whose
// partial lists land in part_v / part_i [splits, n_q, k] before the merge.
// norms: caller-owned scratch of n_q + true_n floats, used for l2 only.
// Returns a cudaError_t: 0 on a clean launch.
int mms_topk(const float* queries, const float* corpus, float* norms,
             float* part_v, int* part_i, float* out_v, int* out_i, int n_q,
             int d, int true_n, int k, int l2, int splits, int rows_per_split,
             void* stream) {
  if (k < 1 || k > kMaxK || n_q < 1 || d < 1 || true_n < 1 || splits < 1 ||
      rows_per_split < 1 || splits > 65535 || (l2 && norms == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const Config c = pick(k);
  const int tq = query_tile(c.wg);
  const bool split = splits > 1;
  Args a{};
  a.q = queries;
  a.x = corpus;
  a.norms = norms;
  a.v = split ? part_v : out_v;
  a.i = split ? part_i : out_i;
  a.n_q = n_q;
  a.d = d;
  a.true_n = true_n;
  a.k = k;
  a.rows_per_split = rows_per_split;
  a.negate = (l2 && !split) ? 1 : 0;
  a.tma = tf32x3::tma_ok(queries, corpus, d);
  if (a.tma &&
      (tf32x3::make_map(&a.map_q, queries, n_q, d, tq) != CUDA_SUCCESS ||
       tf32x3::make_map(&a.map_x, corpus, true_n, d, kTN) != CUDA_SUCCESS))
    return static_cast<int>(cudaErrorInvalidValue);
  if (l2) {
    const int rows = n_q + true_n;
    sq_norms_kernel<<<(rows + kMergeWarps - 1) / kMergeWarps,
                      kMergeWarps * 32, 0, st>>>(queries, corpus, n_q, true_n,
                                                 d, norms);
    const cudaError_t err = cudaGetLastError();
    if (err != cudaSuccess) return static_cast<int>(err);
  }
  const dim3 grid((n_q + tq - 1) / tq, splits);
  cudaError_t err = l2 ? launch_config<true>(c, grid, st, a)
                       : launch_config<false>(c, grid, st, a);
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const size_t msmem = static_cast<size_t>(kMergeWarps) * k *
                       (sizeof(float) + sizeof(int));
  topk_merge_kernel<<<(n_q + kMergeWarps - 1) / kMergeWarps,
                      kMergeWarps * 32, msmem, st>>>(part_v, part_i, out_v,
                                                     out_i, n_q, k, splits,
                                                     l2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
