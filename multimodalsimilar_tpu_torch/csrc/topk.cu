// Streaming exact top-k similarity search for NVIDIA Hopper (sm_90a).
//
// Replaces multimodalsimilar_tpu/ops/topk.py:_topk_kernel, the Pallas TPU
// kernel launched by pallas_topk. For each query it returns the exact top k
// corpus rows by inner product ("ip") or by squared L2 distance ("l2"),
// all math in f32, corpus rows at index >= true_n excluded, ties to the
// lowest corpus index (FAISS order).
//
// What bounds it on this card: the work is 2*Q*N*d f32 FMAs on the CUDA
// cores (no tensor cores, no TF32, so results match the f32 reference):
// at most 67 TFLOP/s on an H100 SXM. A block holding a tile of TQ queries
// turns each corpus byte it loads into TQ/2 flops, so with TQ = 64 the
// kernel is compute-bound rather than HBM-bound (3.35 TB/s) even when the
// corpus does not fit the 50 MB L2. The running top-k costs one compare
// per score plus about k*ln(N/k) insertions per query: noise next to the
// product.
//
// Design. The TPU's sequential corpus grid axis becomes a loop inside each
// block. One block owns TQ = 64 queries and walks its corpus range in
// chunks of TN = 128 rows; each chunk's [TQ, TN] score tile is a register
// tiled SGEMM over d in slices of TK = 32 staged in shared memory (each
// of 256 threads computes 4 queries x 8 rows). The tile then goes to
// shared memory, and each warp folds 8 queries' rows of it into their
// running top-k lists, kept sorted by (value desc, index asc) in shared
// memory. Candidates are offered in ascending corpus index; one enters
// only if it is strictly greater than the current k-th value and is placed
// after existing equal values, which is FAISS order without a sort (the
// invariant of knn.py:_stable_merge). Rows past true_n are never read.
// When Q is small the corpus is split over gridDim.y blocks so the card is
// full; each split writes its partial list and a second kernel merges the
// splits in ascending corpus order with the same insertion rule.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes (multimodalsimilar_tpu_torch/ops/topk.py). The
// kernels launch on the caller's stream and allocate nothing.

#include <cuda_runtime.h>
#include <math_constants.h>

namespace {

constexpr int kTQ = 64;          // queries per block
constexpr int kTN = 128;         // corpus rows per chunk
constexpr int kTK = 32;          // depth of one staged slice
constexpr int kThreads = 256;    // 16 x 16: each thread 4 queries x 8 rows
constexpr int kWarps = kThreads / 32;
constexpr int kMaxK = 128;
constexpr int kStride = kTK + 4;         // staged slices, row-major
constexpr int kSStride = kTN + 4;        // score tile rows
constexpr int kStageFloats = (kTQ + kTN) * kStride;
constexpr int kScoreFloats = kTQ * kSStride;
constexpr int kUnionFloats =
    kScoreFloats > kStageFloats ? kScoreFloats : kStageFloats;
constexpr int kFillIdx = 0x7fffffff;
constexpr unsigned kFull = 0xffffffffu;

// Insert (v, id) into the warp's sorted list (lv, li) of length k; the
// caller has checked v > lv[k - 1]. Equal values stay ahead of v.
__device__ __forceinline__ void warp_insert(float* lv, int* li, int k,
                                            float v, int id, int lane) {
  int pos = 0;
  for (int b = 0; b < k; b += 32) {
    const int j = b + lane;
    pos += __popc(__ballot_sync(kFull, j < k && lv[j] >= v));
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

// Offer one candidate per lane, taken in lane order; thr tracks lv[k - 1].
__device__ __forceinline__ void warp_offer(float* lv, int* li, int k,
                                           float v, int id, float& thr,
                                           int lane) {
  unsigned m = __ballot_sync(kFull, v > thr);
  while (m) {
    const int src = __ffs(m) - 1;
    m &= m - 1;
    const float cv = __shfl_sync(kFull, v, src);
    const int cid = __shfl_sync(kFull, id, src);
    if (cv > thr) {
      warp_insert(lv, li, k, cv, cid, lane);
      thr = lv[k - 1];
    }
  }
}

template <bool kL2>
__global__ void __launch_bounds__(kThreads, 2)
topk_kernel(const float* __restrict__ q, const float* __restrict__ x,
            float* __restrict__ out_v, int* __restrict__ out_i, int n_q,
            int d, int true_n, int k, int rows_per_split, int negate) {
  extern __shared__ float smem[];
  float* As = smem;                        // [kTQ][kStride]
  float* Bs = smem + kTQ * kStride;        // [kTN][kStride]
  float* S = smem;                         // [kTQ][kSStride], aliases As/Bs
  float* qn = smem + kUnionFloats;         // [kTQ]
  float* lv = qn + kTQ;                    // [kTQ][k]
  int* li = reinterpret_cast<int*>(lv + kTQ * k);

  const int tid = threadIdx.x;
  const int lane = tid & 31;
  const int warp = tid >> 5;
  const int tx = tid & 15;                 // rows tx + 16 * j
  const int ty = tid >> 4;                 // queries ty * 4 + i
  const int q0 = blockIdx.x * kTQ;
  const int row_begin = blockIdx.y * rows_per_split;
  const int row_end = min(true_n, row_begin + rows_per_split);

  for (int e = tid; e < kTQ * k; e += kThreads) {
    lv[e] = -CUDART_INF_F;
    li[e] = kFillIdx;
  }
  if (kL2) {
    for (int r = warp; r < kTQ; r += kWarps) {
      float s = 0.f;
      if (q0 + r < n_q) {
        const float* qr = q + static_cast<size_t>(q0 + r) * d;
        for (int c = lane; c < d; c += 32) s = fmaf(qr[c], qr[c], s);
      }
      for (int o = 16; o > 0; o >>= 1) s += __shfl_xor_sync(kFull, s, o);
      if (lane == 0) qn[r] = s;
    }
  }

  for (int r0 = row_begin; r0 < row_end; r0 += kTN) {
    float acc[4][8];
    float xsq[8];
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      xsq[j] = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc[i][j] = 0.f;
    }
    for (int k0 = 0; k0 < d; k0 += kTK) {
      __syncthreads();   // the previous slice / score tile is consumed
      const int c = tid & (kTK - 1);
      const bool in_d = k0 + c < d;
#pragma unroll
      for (int i = 0; i < kTQ * kTK / kThreads; ++i) {
        const int r = (tid >> 5) + i * (kThreads / kTK);
        const int gq = q0 + r;
        As[r * kStride + c] =
            (in_d && gq < n_q) ? q[static_cast<size_t>(gq) * d + k0 + c]
                               : 0.f;
      }
#pragma unroll
      for (int i = 0; i < kTN * kTK / kThreads; ++i) {
        const int r = (tid >> 5) + i * (kThreads / kTK);
        const int gr = r0 + r;
        Bs[r * kStride + c] =
            (in_d && gr < row_end) ? x[static_cast<size_t>(gr) * d + k0 + c]
                                   : 0.f;
      }
      __syncthreads();
#pragma unroll
      for (int kk = 0; kk < kTK; kk += 4) {
        float4 a[4], b[8];
#pragma unroll
        for (int i = 0; i < 4; ++i)
          a[i] = *reinterpret_cast<const float4*>(
              &As[(ty * 4 + i) * kStride + kk]);
#pragma unroll
        for (int j = 0; j < 8; ++j)
          b[j] = *reinterpret_cast<const float4*>(
              &Bs[(tx + 16 * j) * kStride + kk]);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            acc[i][j] = fmaf(a[i].x, b[j].x, acc[i][j]);
            acc[i][j] = fmaf(a[i].y, b[j].y, acc[i][j]);
            acc[i][j] = fmaf(a[i].z, b[j].z, acc[i][j]);
            acc[i][j] = fmaf(a[i].w, b[j].w, acc[i][j]);
          }
        }
        if (kL2) {
#pragma unroll
          for (int j = 0; j < 8; ++j) {
            xsq[j] = fmaf(b[j].x, b[j].x, xsq[j]);
            xsq[j] = fmaf(b[j].y, b[j].y, xsq[j]);
            xsq[j] = fmaf(b[j].z, b[j].z, xsq[j]);
            xsq[j] = fmaf(b[j].w, b[j].w, xsq[j]);
          }
        }
      }
    }
    __syncthreads();     // staged slices are read; the tile may overwrite
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      const int r = ty * 4 + i;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int col = tx + 16 * j;
        float s = acc[i][j];
        if (kL2) s = -(qn[r] - 2.0f * s + xsq[j]);
        S[r * kSStride + col] = (r0 + col < row_end) ? s : -CUDART_INF_F;
      }
    }
    __syncthreads();
    for (int r = warp * (kTQ / kWarps); r < (warp + 1) * (kTQ / kWarps);
         ++r) {
      if (q0 + r >= n_q) break;
      float* rv = lv + r * k;
      int* ri = li + r * k;
      float thr = rv[k - 1];
      for (int c0 = 0; c0 < kTN; c0 += 32)
        warp_offer(rv, ri, k, S[r * kSStride + c0 + lane], r0 + c0 + lane,
                   thr, lane);
    }
  }

  __syncthreads();
  for (int r = warp * (kTQ / kWarps); r < (warp + 1) * (kTQ / kWarps); ++r) {
    if (q0 + r >= n_q) break;
    const size_t o =
        (static_cast<size_t>(blockIdx.y) * n_q + q0 + r) * k;
    for (int j = lane; j < k; j += 32) {
      const float v = lv[r * k + j];
      out_v[o + j] = negate ? -v : v;
      out_i[o + j] = li[r * k + j];
    }
  }
}

// One warp per query: fold the splits' partial lists, in ascending corpus
// order, into the final top-k.
__global__ void __launch_bounds__(kThreads)
topk_merge_kernel(const float* __restrict__ part_v,
                  const int* __restrict__ part_i, float* __restrict__ out_v,
                  int* __restrict__ out_i, int n_q, int k, int splits,
                  int negate) {
  extern __shared__ float smem[];
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int qi = blockIdx.x * kWarps + warp;
  if (qi >= n_q) return;                   // warp-uniform
  float* lv = smem + warp * k;
  int* li = reinterpret_cast<int*>(smem + kWarps * k) + warp * k;
  for (int j = lane; j < k; j += 32) {
    lv[j] = -CUDART_INF_F;
    li[j] = kFillIdx;
  }
  __syncwarp();
  float thr = -CUDART_INF_F;
  for (int s = 0; s < splits; ++s) {
    const size_t o = (static_cast<size_t>(s) * n_q + qi) * k;
    for (int c0 = 0; c0 < k; c0 += 32) {
      const int j = c0 + lane;
      const float v = j < k ? part_v[o + j] : -CUDART_INF_F;
      const int id = j < k ? part_i[o + j] : kFillIdx;
      warp_offer(lv, li, k, v, id, thr, lane);
    }
  }
  const size_t o = static_cast<size_t>(qi) * k;
  for (int j = lane; j < k; j += 32) {
    out_v[o + j] = negate ? -lv[j] : lv[j];
    out_i[o + j] = li[j];
  }
}

template <bool kL2>
cudaError_t launch_main(dim3 grid, size_t smem, cudaStream_t st,
                        const float* q, const float* x, float* v, int* i,
                        int n_q, int d, int true_n, int k, int rows_per_split,
                        int negate) {
  cudaError_t err = cudaFuncSetAttribute(
      topk_kernel<kL2>, cudaFuncAttributeMaxDynamicSharedMemorySize,
      static_cast<int>(smem));
  if (err != cudaSuccess) return err;
  topk_kernel<kL2><<<grid, kThreads, smem, st>>>(q, x, v, i, n_q, d, true_n,
                                                 k, rows_per_split, negate);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

int mms_topk_max_k() { return kMaxK; }

int mms_topk_query_tile() { return kTQ; }

int mms_topk_chunk_rows() { return kTN; }

// queries [n_q, d] and corpus [>= true_n, d] f32 row-major on the device.
// out_v [n_q, k] f32 and out_i [n_q, k] int32. With splits > 1 the corpus
// rows [s * rows_per_split, (s + 1) * rows_per_split) go to split s, whose
// partial lists land in part_v / part_i [splits, n_q, k] before the merge.
// Returns a cudaError_t: 0 on a clean launch.
int mms_topk(const float* queries, const float* corpus, float* part_v,
             int* part_i, float* out_v, int* out_i, int n_q, int d,
             int true_n, int k, int l2, int splits, int rows_per_split,
             void* stream) {
  if (k < 1 || k > kMaxK || n_q < 1 || d < 1 || true_n < 1 || splits < 1 ||
      rows_per_split < 1 || splits > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const size_t smem = (kUnionFloats + kTQ) * sizeof(float) +
                      static_cast<size_t>(kTQ) * k * (sizeof(float) + sizeof(int));
  const dim3 grid((n_q + kTQ - 1) / kTQ, splits);
  const bool split = splits > 1;
  float* v = split ? part_v : out_v;
  int* i = split ? part_i : out_i;
  const int negate = (l2 && !split) ? 1 : 0;
  cudaError_t err =
      l2 ? launch_main<true>(grid, smem, st, queries, corpus, v, i, n_q, d,
                             true_n, k, rows_per_split, negate)
         : launch_main<false>(grid, smem, st, queries, corpus, v, i, n_q, d,
                              true_n, k, rows_per_split, negate);
  if (err != cudaSuccess || !split) return static_cast<int>(err);
  const size_t msmem = static_cast<size_t>(kWarps) * k *
                       (sizeof(float) + sizeof(int));
  topk_merge_kernel<<<(n_q + kWarps - 1) / kWarps, kThreads, msmem, st>>>(
      part_v, part_i, out_v, out_i, n_q, k, splits, l2);
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
