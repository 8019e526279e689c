// Exact top-k selection at any depth k for NVIDIA Hopper (sm_90a).
//
// The large-k route of the exact search (multimodalsimilar_tpu_torch/ops/
// topk.py:topk_select_cuda), taken for k > 128, where csrc/topk.cu's
// register lists stop. The JAX package reaches these depths through XLA,
// not Pallas: retrieval/knn.py:_scan_topk (lax.top_k over the blockwise
// scores, stable merges); its Pallas kernel (ops/topk.py:_topk_kernel)
// serves small k only. The daodian jobs and daemon search at k = len(area),
// len(area) // recent_days and n_c per category group.
//
// Contract (ops/topk.py:topk_plain, for any 1 <= k <= n): for each query
// row the top k of n scores by (value desc, column asc), the FAISS order.
// The wrapper hands over the [n_q, n] f32 products q.x (f32-accurate
// whatever the TF32 flag) of the first true_n corpus rows only, so
// padding rows are never read. For l2 each score is
// -(|q|^2 - 2 q.x + |x|^2), from norms the wrapper computed, and the
// distance is negated back on output.
//
// What bounds it on this card: reading the n_q x n scores once and writing
// the n_q x k results (8 bytes each): bytes, at 3.35 TB/s. The design
// spends shared-memory passes instead, a few per key.
//
// Design. One block per query row: 1,024 threads, or 256 for rows of at
// most 4,096 columns (a category group), four blocks to a multiprocessor
// there. Each score becomes an
// order-preserving uint32 (the sign flipped in, -0.0 made +0.0 so that it
// ties with +0.0 as torch.sort does, every NaN the largest value as
// torch.sort's descending order puts it). A row of at most kChunk = 16,384
// columns is handled whole in shared memory; a longer one in chunks of
// kChunk, whose top keys are merged into a running list (below). For each
// chunk of len columns the m = min(k, len) best are wanted:
// - When m is at most half of len, a radix select finds the m-th key: four
//   passes of 8-bit digit histograms, from the top byte down, each over
//   the keys that match the digits found so far (warp-aggregated shared
//   atomics: scores of one row share their top bytes). Every key above it
//   and the first keys equal to it, in column order, are compacted, in
//   column order, by one block-wide scan. Only those m are sorted.
// - The kept keys are sorted by cub::BlockRadixSort (stable LSD radix, the
//   complemented key ascending, the column as its value) from a blocked
//   arrangement in column order, so equal scores stay in column order.
//   The sort runs at ceil(count / threads) keys a thread, 1 to 16, so a
//   row is padded to a multiple of the block only, never to a power of
//   two.
//   Padding keys are the largest, placed last, so none reaches the first m.
// A row of one chunk writes its first k from shared memory. A longer row
// merges each chunk's m keys with the running top-k, which lives in the
// caller's global scratch (two [n_q, k] uint64 buffers, ping-pong) as the
// ordered value above the complemented column: a total order. The merge
// is by rank: an element's place in the output is its place in its own
// list plus the number of larger keys in the other list (a binary
// search), so every thread places its elements alone. Any n works, among
// them an area that grew through /update.
//
// Built with nvcc into a shared library with a plain C interface and
// called through ctypes. The kernel launches on the caller's stream and
// allocates nothing.

#include <cuda_runtime.h>
#include <stdint.h>

#include <cub/block/block_radix_sort.cuh>
#include <cub/block/block_scan.cuh>

namespace {

constexpr int kMaxItems = 16;                 // keys per thread at most
constexpr int kThreads = 1024;                // a block, as a rule
constexpr int kSmallThreads = 256;            // a block for short rows
constexpr int kChunk = kThreads * kMaxItems;  // columns held at once

template <int kT, int kItems>
using Sort = cub::BlockRadixSort<uint32_t, kT, kItems, uint32_t>;
template <int kT>
using Scan = cub::BlockScan<uint32_t, kT>;

constexpr size_t round16(size_t b) { return (b + 15) / 16 * 16; }
constexpr size_t max_size(size_t a, size_t b) { return a > b ? a : b; }

// A block of kT threads holds kT * kMaxItems columns. Its dynamic shared
// memory: the sort's storage, which outside a sort holds the kept
// columns (and, during a select, the kept keys in its upper half); then
// the chunk's keys.
template <int kT>
struct Layout {
  static constexpr int chunk = kT * kMaxItems;
  static constexpr size_t tmp = round16(max_size(
      sizeof(typename Sort<kT, kMaxItems>::TempStorage),
      chunk * sizeof(uint32_t)));
  static constexpr size_t smem = tmp + chunk * sizeof(uint32_t);
};

__device__ __forceinline__ uint32_t ordered(float s) {
  if (s != s) return 0xFFC00000u;      // every NaN: above +inf
  if (s == 0.0f) s = 0.0f;             // -0.0 ties with +0.0
  const uint32_t u = __float_as_uint(s);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float unordered(uint32_t o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

__device__ __forceinline__ uint64_t key64(uint32_t v, uint32_t col) {
  return (static_cast<uint64_t>(v) << 32) |
         static_cast<uint64_t>(0xFFFFFFFFu - col);
}

// Number of keys in the descending global list a[0, len) larger than x.
__device__ __forceinline__ int count_larger(const uint64_t* a, int len,
                                            uint64_t x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (a[mid] > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// The same over the sorted shared-memory list (vals, cols)[0, len).
__device__ __forceinline__ int count_larger(const uint32_t* vals,
                                            const uint32_t* cols, int len,
                                            uint64_t x) {
  int lo = 0, hi = len;
  while (lo < hi) {
    const int mid = (lo + hi) >> 1;
    if (key64(vals[mid], cols[mid]) > x) lo = mid + 1; else hi = mid;
  }
  return lo;
}

// Radix select over keys vals[0, len): the m best (m * 2 <= len) go, in
// column order, to keys kv[0, m) and columns cols[0, m). kv is the upper
// half of the storage that holds cols, so vals stays intact.
template <int kT>
__device__ void select_top(const uint32_t* vals, int len, int m, int base,
                           uint32_t* cols, uint32_t* kv) {
  __shared__ uint32_t hist[256];
  __shared__ uint32_t found[2];
  __shared__ typename Scan<kT>::TempStorage scan;
  const int lane = threadIdx.x & 31;
  uint32_t prefix = 0, mask = 0, need = static_cast<uint32_t>(m);
  for (int shift = 24; shift >= 0; shift -= 8) {
    for (int b = threadIdx.x; b < 256; b += kT) hist[b] = 0;
    __syncthreads();
    for (int j0 = 0; j0 < len; j0 += kT) {   // warp-uniform trips
      const int j = j0 + threadIdx.x;
      const uint32_t v = j < len ? vals[j] : 0u;
      const bool in = j < len && (v & mask) == prefix;
      const uint32_t bin = in ? (v >> shift) & 255u : 256u;
      const unsigned peers = __match_any_sync(0xFFFFFFFFu, bin);
      if (in && lane == __ffs(peers) - 1)
        atomicAdd(&hist[bin], static_cast<uint32_t>(__popc(peers)));
    }
    __syncthreads();
    if (threadIdx.x < 32) {            // the digit where the count reaches need
      uint32_t c[8], sum = 0;
#pragma unroll
      for (int i = 0; i < 8; ++i) {
        c[i] = hist[255 - 8 * lane - i];
        sum += c[i];
      }
      uint32_t inc = sum;
#pragma unroll
      for (int o = 1; o < 32; o <<= 1) {
        const uint32_t t = __shfl_up_sync(0xFFFFFFFFu, inc, o);
        if (lane >= o) inc += t;
      }
      uint32_t run = inc - sum;
      if (run < need && need <= inc) {
        for (int i = 0; i < 8; ++i) {
          if (run + c[i] >= need) {
            found[0] = 255u - 8u * lane - i;
            found[1] = need - run;
            break;
          }
          run += c[i];
        }
      }
    }
    __syncthreads();
    prefix |= found[0] << shift;
    mask |= 255u << shift;
    need = found[1];                   // still wanted among keys == prefix
  }
  // keep every key above the threshold and the first `need` equal to it:
  // a kept key's place is (#above before it) + min(#equal before it, need)
  const int per = (len + kT - 1) / kT;
  const int lo = min(len, static_cast<int>(threadIdx.x) * per);
  const int hi = min(len, lo + per);
  uint32_t above = 0, equal = 0;
  for (int j = lo; j < hi; ++j) {
    above += vals[j] > prefix;
    equal += vals[j] == prefix;
  }
  uint32_t before;                     // counts < 2^16 each: packed
  Scan<kT>(scan).ExclusiveSum((above << 16) | equal, before);
  above = before >> 16;
  equal = before & 0xFFFFu;
  for (int j = lo; j < hi; ++j) {
    const uint32_t v = vals[j];
    int pos = -1;
    if (v > prefix) {
      pos = above + min(equal, need);
      ++above;
    } else if (v == prefix) {
      if (equal < need) pos = above + equal;
      ++equal;
    }
    if (pos >= 0) {
      kv[pos] = v;
      cols[pos] = static_cast<uint32_t>(base + j);
    }
  }
  __syncthreads();
}

// Sort count (<= kItems * kT) keys, descending and stable, from
// src_v[0, count) with columns src_c (or base + position when src_c is
// null); the first m land in vals[0, m) and cols[0, m).
template <int kT, int kItems>
__device__ void sort_keys(const uint32_t* src_v, const uint32_t* src_c,
                          int base, int count, int m, unsigned char* tmp,
                          uint32_t* vals, uint32_t* cols) {
  uint32_t key[kItems], col[kItems];
#pragma unroll
  for (int i = 0; i < kItems; ++i) {   // blocked: column order
    const int j = static_cast<int>(threadIdx.x) * kItems + i;
    const bool real = j < count;
    key[i] = real ? ~src_v[j] : 0xFFFFFFFFu;   // ascending = value desc
    col[i] = real ? (src_c ? src_c[j] : static_cast<uint32_t>(base + j))
                  : 0xFFFFFFFFu;
  }
  __syncthreads();                     // the storage becomes the sort's
  using Storage = typename Sort<kT, kItems>::TempStorage;
  Sort<kT, kItems>(*reinterpret_cast<Storage*>(tmp))
      .SortBlockedToStriped(key, col);
  __syncthreads();
#pragma unroll
  for (int i = 0; i < kItems; ++i) {   // striped: coalesced
    const int j = i * kT + static_cast<int>(threadIdx.x);
    if (j < m) {
      vals[j] = ~key[i];
      cols[j] = col[i];
    }
  }
  __syncthreads();
}

template <int kT>
__device__ void sort_any(const uint32_t* src_v, const uint32_t* src_c,
                         int base, int count, int m, unsigned char* tmp,
                         uint32_t* vals, uint32_t* cols) {
#define MMS_SORT(I)                                                      \
  case I:                                                                \
    sort_keys<kT, I>(src_v, src_c, base, count, m, tmp, vals, cols);     \
    break;
  switch ((count + kT - 1) / kT) {
    MMS_SORT(1) MMS_SORT(2) MMS_SORT(3) MMS_SORT(4)
    MMS_SORT(5) MMS_SORT(6) MMS_SORT(7) MMS_SORT(8)
    MMS_SORT(9) MMS_SORT(10) MMS_SORT(11) MMS_SORT(12)
    MMS_SORT(13) MMS_SORT(14) MMS_SORT(15) MMS_SORT(16)
    default: break;
  }
#undef MMS_SORT
}

struct Args {
  const float* scores;   // [n_q, n] q.x, row stride n
  const float* qnorm;    // [n_q] |q|^2 (l2 only)
  const float* xnorm;    // [n] |x|^2 (l2 only)
  uint64_t* scratch;     // [2, n_q, k] running lists (n > kChunk only)
  float* out_v;          // [n_q, k]
  int* out_i;            // [n_q, k]
  int n_q, n, k, l2;
};

// One block of kT threads per row; rows longer than Layout<kT>::chunk
// merge through the scratch lists. 64 registers a thread at most.
template <int kT>
__global__ void __launch_bounds__(kT, kThreads / kT) select_rows(Args a) {
  constexpr int kChunkT = Layout<kT>::chunk;
  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* tmp = smem;
  uint32_t* cols = reinterpret_cast<uint32_t*>(smem);
  uint32_t* vals = reinterpret_cast<uint32_t*>(smem + Layout<kT>::tmp);
  const int r = blockIdx.x;
  const float* row = a.scores + static_cast<size_t>(r) * a.n;
  const float qn = a.l2 ? a.qnorm[r] : 0.0f;
  const int n_chunks = (a.n + kChunkT - 1) / kChunkT;
  uint64_t* cur = nullptr;             // running list (n > kChunk only)
  uint64_t* nxt = nullptr;
  if (n_chunks > 1) {
    cur = a.scratch + static_cast<size_t>(r) * a.k;
    nxt = a.scratch + (static_cast<size_t>(a.n_q) + r) * a.k;
  }
  int have = 0;                        // running list length
  for (int c = 0; c < n_chunks; ++c) {
    const int base = c * kChunkT;
    const int len = min(kChunkT, a.n - base);
    for (int j = threadIdx.x; j < len; j += kT) {
      const int col = base + j;
      float s = row[col];
      if (a.l2) s = -(qn - 2.0f * s + a.xnorm[col]);
      vals[j] = ordered(s);
    }
    __syncthreads();
    const int m = min(a.k, len);       // this chunk's sorted prefix
    if (2 * m <= len) {
      uint32_t* kv = cols + kChunkT / 2;
      select_top<kT>(vals, len, m, base, cols, kv);
      sort_any<kT>(kv, cols, base, m, m, tmp, vals, cols);
    } else {
      sort_any<kT>(vals, nullptr, base, len, m, tmp, vals, cols);
    }
    if (n_chunks == 1) {
      for (int j = threadIdx.x; j < a.k; j += kT) {
        const float s = unordered(vals[j]);
        const size_t o = static_cast<size_t>(r) * a.k + j;
        a.out_v[o] = a.l2 ? -s : s;
        a.out_i[o] = static_cast<int>(cols[j]);
      }
      return;
    }
    const int kk = min(a.k, have + m);
    // merge by rank: cur[0, have) and (vals, cols)[0, m) into nxt[0, kk)
    for (int j = threadIdx.x; j < have; j += kT) {
      const uint64_t x = cur[j];
      const int pos = j + count_larger(vals, cols, m, x);
      if (pos < kk) nxt[pos] = x;
    }
    for (int j = threadIdx.x; j < m; j += kT) {
      const uint64_t y = key64(vals[j], cols[j]);
      const int pos = j + count_larger(cur, have, y);
      if (pos < kk) nxt[pos] = y;
    }
    __syncthreads();                   // nxt complete, smem free again
    uint64_t* t = cur; cur = nxt; nxt = t;
    have = kk;
  }
  for (int j = threadIdx.x; j < a.k; j += kT) {
    const uint64_t key = cur[j];
    const float s = unordered(static_cast<uint32_t>(key >> 32));
    const size_t o = static_cast<size_t>(r) * a.k + j;
    a.out_v[o] = a.l2 ? -s : s;
    a.out_i[o] = static_cast<int>(0xFFFFFFFFu - static_cast<uint32_t>(key));
  }
}

}  // namespace

extern "C" {

int mms_select_chunk() { return kChunk; }

// scores [n_q, n] f32 (row stride n), qnorm [n_q] and xnorm [n] for l2
// (else may be null), scratch [2, n_q, k] uint64 when n > kChunk (else
// may be null), out_v [n_q, k] f32, out_i [n_q, k] int32; 1 <= k <= n.
// Returns a cudaError_t: 0 on a clean launch.
int mms_topk_select(const float* scores, const float* qnorm,
                    const float* xnorm, void* scratch, float* out_v,
                    int* out_i, int n_q, int n, int k, int l2,
                    void* stream) {
  if (n_q < 1 || n < 1 || k < 1 || k > n ||
      (l2 && (qnorm == nullptr || xnorm == nullptr)) ||
      (n > kChunk && scratch == nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  Args a{scores, qnorm, xnorm, static_cast<uint64_t*>(scratch), out_v, out_i,
         n_q, n, k, l2};
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  // above 48 KB only once allowed; set on every call (cheap), since the
  // attribute belongs to the current device
  cudaError_t e;
  if (n <= Layout<kSmallThreads>::chunk) {
    // short rows (a category group): four blocks a multiprocessor
    constexpr size_t smem = Layout<kSmallThreads>::smem;
    e = cudaFuncSetAttribute(select_rows<kSmallThreads>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    select_rows<kSmallThreads><<<n_q, kSmallThreads, smem, st>>>(a);
  } else {
    constexpr size_t smem = Layout<kThreads>::smem;
    e = cudaFuncSetAttribute(select_rows<kThreads>,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             static_cast<int>(smem));
    if (e != cudaSuccess) return static_cast<int>(e);
    select_rows<kThreads><<<n_q, kThreads, smem, st>>>(a);
  }
  return static_cast<int>(cudaGetLastError());
}

}  // extern "C"
