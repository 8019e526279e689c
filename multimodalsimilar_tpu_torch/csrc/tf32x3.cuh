// f32-accurate tile products on Hopper's tensor cores ("3xTF32"), and the
// pipeline that feeds them. Included by topk.cu and arcface.cu.
//
// Arithmetic. A TF32 operand keeps 10 of f32's 23 mantissa bits, so one
// TF32 product of unit vectors at d = 768 misses the f32 result by far
// more than the plain versions' tolerances (tests/test_torch_tf32x3.py). Each f32 operand a is split as
//
//   big   = cvt.rna.tf32.f32(a)            (round to nearest, ties away)
//   small = cvt.rna.tf32.f32(a - big)      (a - big is exact: Sterbenz)
//
// and a.b is taken as small_a.big_b + big_a.small_b + big_a.big_b, the
// first two first, accumulated in f32 by the tensor core. The dropped
// small.small term and small's own rounding leave about 2^-22 relative
// per product: f32 accuracy. On small integers small is 0 and every
// partial sum below 2^24 is exact, so exact data stays exact. The tensor
// core's f32 accumulation rounds toward zero; over the 288 products of a
// 768-deep sum that bias adds up where every product has the same sign
// (a row against itself), so each 32-deep slice is summed into a fresh
// partial (12 products) that is added to the total with an ordinary f32
// add, which rounds to nearest.
//
// Instruction. wgmma.mma_async m64nNk8 .tf32 (sm_90a): one warpgroup (4
// warps) multiplies 64 rows of A by N rows of B, 8 deep. A comes from
// registers, in the m16n8k8 fragment layout, so it is split as it is
// loaded, and each element is split once. B comes from shared memory, so
// its split is written there: big in place over the landed f32, small in
// a second tile. (mma.sync m16n8k8 with both splits in registers needs
// about three instructions per product; on an H100 80GB HBM3 at 700 W it
// ran at about a quarter of the TF32 rate.)
//
// Pipeline. One producer warpgroup fills a ring of shared-memory slots,
// one 32-deep K slice of A and of B per slot, and splits B; the consumer
// warpgroups only load A fragments and run wgmma. Named barriers hand each
// slot back and forth, so copies, splits and products of different slices
// overlap. Copies are TMA tensor copies (cp.async.bulk.tensor, one thread,
// completion on an mbarrier) where the rows are 16-byte aligned (d % 4 ==
// 0), else 4-byte cp.async. (On an H100 80GB HBM3 at 700 W, with one
// warpgroup doing all three in turn, or with 16-byte cp.async from a
// producer warpgroup, the copies took as long as the products.)
//
// Layout. A staged tile is kRows x 32 f32 (128 bytes a row) in the 128-byte
// swizzle that both TMA and wgmma use: the 16-byte chunk c of row r sits
// at chunk c ^ (r % 8) of its row. Tiles start 1024-byte aligned. A
// fragment loads then touch 32 distinct banks, and the wgmma descriptor
// of B is the K-major 128-byte-swizzle one: 8-row groups 1024 bytes
// apart, the k-th 8-deep step 32 bytes in. TMA zero-fills rows and
// columns past the tensor's edges; the cp.async path does the same.

#pragma once

#include <cuda.h>
#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

namespace tf32x3 {

constexpr int kSlice = 32;            // K depth of one staged slice

// Floats of a staged tile of n rows.
__host__ __device__ constexpr int tile_floats(int n) { return n * kSlice; }

// Offset of chunk (r, c4) (columns 4 c4 .. 4 c4 + 3 of row r) in a tile.
__device__ __forceinline__ int sw128(int r, int c4) {
  return r * kSlice + ((c4 ^ (r & 7)) << 2);
}

// -- copies -------------------------------------------------------------------

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}

// 4 bytes global -> shared; zero-filled when !pred (src is then unread).
__device__ __forceinline__ void cp_async4(float* dst, const float* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n" ::"r"(
                   smem_addr(dst)),
               "l"(src), "r"(pred ? 4 : 0)
               : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

// Wait until at most N of this thread's committed groups are in flight.
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// The fallback copy (rows not 16-byte aligned): rows [r0, r0 + kRows) x
// columns [k0, k0 + kSlice) of the row-major [*, d] src into a swizzled
// tile, 4 bytes at a time. Thread `tid` of kThreads takes chunks tid,
// tid + kThreads, ...; chunk e is row e / 8, columns 4 (e % 8) .. + 3.
// Rows at or past row_end and columns at or past d land as zeros.
template <int kRows, int kThreads>
__device__ __forceinline__ void load_chunks(float* dst, const float* src,
                                            int r0, int row_end, int d,
                                            int k0, int tid) {
  for (int e = tid; e < kRows * (kSlice / 4); e += kThreads) {
    const int r = e >> 3;
    const int c = k0 + (e & 7) * 4;
    const bool row_ok = r0 + r < row_end;
    const float* g = src + static_cast<size_t>(row_ok ? r0 + r : 0) * d;
    float* o = dst + sw128(r, e & 7);
#pragma unroll
    for (int i = 0; i < 4; ++i)
      cp_async4(o + i, row_ok && c + i < d ? g + c + i : src,
                row_ok && c + i < d);
  }
}

__device__ __forceinline__ void mbar_init(uint64_t* bar, int count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(
                   smem_addr(bar)),
               "r"(count)
               : "memory");
}

__device__ __forceinline__ void mbar_expect(uint64_t* bar, int bytes) {
  asm volatile(
      "mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
          smem_addr(bar)),
      "r"(bytes)
      : "memory");
}

__device__ __forceinline__ void mbar_wait(uint64_t* bar, int parity) {
  asm volatile(
      "{\n.reg .pred P;\nWAIT_%=:\n"
      "mbarrier.try_wait.parity.shared::cta.b64 P, [%0], %1;\n"
      "@!P bra WAIT_%=;\n}\n" ::"r"(smem_addr(bar)),
      "r"(parity)
      : "memory");
}

// TMA: the box at (column k0, row r0) of the 2-D tensor map into dst,
// completing on bar.
__device__ __forceinline__ void tma_load(float* dst, const CUtensorMap* map,
                                         int k0, int r0, uint64_t* bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.mbarrier::complete_tx"
      "::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(smem_addr(dst)),
      "l"(map), "r"(k0), "r"(r0), "r"(smem_addr(bar))
      : "memory");
}

// -- the split ----------------------------------------------------------------

__device__ __forceinline__ void split(float a, unsigned& big,
                                      unsigned& small) {
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(big) : "f"(a));
  const float rest = a - __uint_as_float(big);
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(small) : "f"(rest));
}

// Split a landed B tile of kRows rows: big in place, small into `small`
// at the same offsets. Thread `tid` takes the chunks that load_chunks
// gave it (its own copies in the fallback path; any chunks after a TMA
// wait), chunk tid + i kThreads being row tid / 8 + i kThreads / 8;
// on_chunk(i, v) sees each chunk's f32 values. The eight threads of one
// row cover its 128 bytes, so distinct banks.
template <int kRows, int kThreads, typename F>
__device__ __forceinline__ void split_chunks(float* big, float* small,
                                             int tid, F on_chunk) {
  static_assert(kRows * (kSlice / 4) % kThreads == 0, "whole rounds");
#pragma unroll
  for (int i = 0; i < kRows * (kSlice / 4) / kThreads; ++i) {
    const int e = tid + i * kThreads;
    const int o = sw128(e >> 3, e & 7);
    const float4 v = *reinterpret_cast<const float4*>(big + o);
    on_chunk(i, v);
    uint4 b, s;
    split(v.x, b.x, s.x);
    split(v.y, b.y, s.y);
    split(v.z, b.z, s.z);
    split(v.w, b.w, s.w);
    *reinterpret_cast<uint4*>(big + o) = b;
    *reinterpret_cast<uint4*>(small + o) = s;
  }
}

// -- the ring: one producer warpgroup, kW consumer warpgroups -------------
//
// Slot i of the kStages-slot ring has a named barrier "full" for each
// consumer warpgroup w (id 1 + i kW + w, producer and that warpgroup: 256
// threads), which the producer's threads arrive at once the slot's slice
// is copied and split, and one "empty" barrier (id 1 + kStages kW + i, the
// whole block), which the consumers arrive at once they are done with the
// slot and the producer waits on before refilling it. So a consumer
// warpgroup may run up to kStages - 1 slices ahead of the other. Ids from
// 15 down are left for the consumers' own syncs. With TMA, slot i's copies
// complete on mbarrier i.

__device__ __forceinline__ void bar_sync(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

__device__ __forceinline__ void bar_arrive(int id, int n) {
  asm volatile("bar.arrive %0, %1;\n" ::"r"(id), "r"(n) : "memory");
}

constexpr int kConsumerBarrier = 15;

template <int kStages, int kW>
__device__ __forceinline__ int full_id(int s, int w) {
  return 1 + (s % kStages) * kW + w;
}

template <int kStages, int kW>
__device__ __forceinline__ int empty_id(int s) {
  return 1 + kStages * kW + s % kStages;
}

// The producer warpgroup's whole life (ptid: its thread, 0..127). For each
// step s it copies slice s into slot s % kStages once the consumers have
// released that slot: with TMA, thread 0 posts the byte count on the
// slot's mbarrier and calls `load(s, slot)`; otherwise every thread calls
// it. kStages - 1 steps later it waits for those copies, calls
// `split(slot)`, makes the split visible to wgmma's proxy and marks the
// slot full for every consumer warpgroup.
template <int kStages, int kW, typename Load, typename Split>
__device__ __forceinline__ void produce(int steps, bool tma, uint64_t* bars,
                                        int bytes, int ptid, Load load,
                                        Split split) {
  constexpr int kLag = kStages - 1;
  constexpr int kAll = 128 * (kW + 1);
  for (int s = 0; s < steps + kLag; ++s) {
    const int f = s - kLag;
    if (f >= 0) {
      if (tma)
        mbar_wait(bars + f % kStages, (f / kStages) & 1);
      else if (s < steps)
        cp_async_wait<kLag - 1>();
      else
        cp_async_wait<0>();
      split(f % kStages);
      asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
#pragma unroll
      for (int w = 0; w < kW; ++w) bar_arrive(full_id<kStages, kW>(f, w), 256);
    }
    if (s < steps) {
      if (s >= kStages) bar_sync(empty_id<kStages, kW>(s), kAll);
      if (!tma) {
        load(s, s % kStages);
        cp_async_commit();
      } else if (ptid == 0) {
        mbar_expect(bars + s % kStages, bytes);
        load(s, s % kStages);
      }
    }
  }
  // take the consumers' last releases, so every barrier round completes
  for (int s = steps > kStages ? steps - kStages : 0; s < steps; ++s)
    bar_sync(empty_id<kStages, kW>(s), kAll);
}

// The side of consumer warpgroup w at step s: wait until its slot is
// full ...
template <int kStages, int kW>
__device__ __forceinline__ void wait_full(int s, int w) {
  bar_sync(full_id<kStages, kW>(s, w), 256);
}

// ... and, once done reading it, give it back to the producer.
template <int kStages, int kW>
__device__ __forceinline__ void release(int s) {
  bar_arrive(empty_id<kStages, kW>(s), 128 * (kW + 1));
}

template <int kRegs>
__device__ __forceinline__ void regs_dec() {
  asm volatile("setmaxnreg.dec.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

template <int kRegs>
__device__ __forceinline__ void regs_inc() {
  asm volatile("setmaxnreg.inc.sync.aligned.u32 %0;\n" ::"n"(kRegs));
}

// -- wgmma --------------------------------------------------------------------

// Descriptor of a swizzled B tile (K-major, 128-byte swizzle): 8-row
// groups 1024 bytes apart (stride byte offset); the leading byte offset
// is unused in this mode.
__device__ __forceinline__ uint64_t desc(const float* tile) {
  const uint64_t a = smem_addr(tile);
  return ((a & 0x3FFFF) >> 4) | (1ull << 16) | ((1024ull >> 4) << 32) |
         (1ull << 62);
}

// D[64 x 128] (+)= A[64 x 8] . B[128 x 8]^T on one warpgroup: A from
// registers (each warp its 16 rows, the m16n8k8 A fragment), B from the
// shared-memory tile that desc_b describes; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_n128(float (&d)[64],
                                      const unsigned (&a)[4],
                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %69, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n128k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39, %40, %41, %42, %43, %44, %45, %46, %47, %48, "
      "%49, %50, %51, %52, %53, %54, %55, %56, %57, %58, %59, %60, "
      "%61, %62, %63},  "
      "{%64, %65, %66, %67}, %68, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]), "+f"(d[44]),
        "+f"(d[45]), "+f"(d[46]), "+f"(d[47]), "+f"(d[48]), "+f"(d[49]),
        "+f"(d[50]), "+f"(d[51]), "+f"(d[52]), "+f"(d[53]), "+f"(d[54]),
        "+f"(d[55]), "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

// D[64 x 80] (+)= A[64 x 8] . B[80 x 8]^T on one warpgroup: A from
// registers (each warp its 16 rows, the m16n8k8 A fragment), B from the
// shared-memory tile that desc_b describes; scale_d = 0 overwrites D.
__device__ __forceinline__ void wgmma_n80(float (&d)[40],
                                      const unsigned (&a)[4],
                                      uint64_t desc_b, int scale_d) {
  asm volatile(
      "{\n.reg .pred p;\n"
      "setp.ne.b32 p, %45, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n80k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, "
      "%13, %14, %15, %16, %17, %18, %19, %20, %21, %22, %23, %24, "
      "%25, %26, %27, %28, %29, %30, %31, %32, %33, %34, %35, %36, "
      "%37, %38, %39},  "
      "{%40, %41, %42, %43}, %44, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15]), "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]), "+f"(d[24]),
        "+f"(d[25]), "+f"(d[26]), "+f"(d[27]), "+f"(d[28]), "+f"(d[29]),
        "+f"(d[30]), "+f"(d[31]), "+f"(d[32]), "+f"(d[33]), "+f"(d[34]),
        "+f"(d[35]), "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc_b),
        "r"(scale_d));
}

template <int N>
__device__ __forceinline__ void wgmma_n(float (&d)[N / 2],
                                        const unsigned (&a)[4], uint64_t b,
                                        int scale_d) {
  if constexpr (N == 128)
    wgmma_n128(d, a, b, scale_d);
  else
    wgmma_n80(d, a, b, scale_d);
}

// Ties the compiler to the wgmma's asynchrony: a value named here stays in
// its register up to this point (after the wait), and reads of it come
// after.
template <int M>
__device__ __forceinline__ void hold(float (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+f"(r[i])::"memory");
}

template <int M>
__device__ __forceinline__ void hold(unsigned (&r)[M]) {
#pragma unroll
  for (int i = 0; i < M; ++i) asm volatile("" : "+r"(r[i])::"memory");
}

// One staged slice on one warpgroup: part[64 x N] = A . B^T over kSlice,
// in 3xTF32. a: the swizzled A tile; row0: this warp's first row in it (a
// multiple of 16); b_big / b_small: the split B tiles. sq[h] gains the
// squares of the A values this thread loaded from row row0 + g + 8h (the
// four threads of group g together cover the row). The wgmmas run to
// completion before it returns, so the slot and the fragment registers
// are free afterwards.
template <int N>
__device__ __forceinline__ void slice_product(float (&part)[N / 2],
                                              float (&sq)[2], const float* a,
                                              int row0, const float* b_big,
                                              const float* b_small,
                                              int lane) {
  const int g = lane >> 2;
  const int t = lane & 3;
  // rows row0 + g and row0 + g + 8 both have r % 8 == g
  const float* lo = a + (row0 + g) * kSlice + t;
  const float* hi = lo + 8 * kSlice;
  unsigned ab[kSlice / 8][4], as[kSlice / 8][4];
#pragma unroll
  for (int s = 0; s < kSlice / 8; ++s) {
    const int c0 = ((2 * s) ^ g) << 2;         // columns 8s + t
    const int c1 = ((2 * s + 1) ^ g) << 2;     // columns 8s + t + 4
    const float v[4] = {lo[c0], hi[c0], lo[c1], hi[c1]};
#pragma unroll
    for (int i = 0; i < 4; ++i) split(v[i], ab[s][i], as[s][i]);
    sq[0] = fmaf(v[0], v[0], fmaf(v[2], v[2], sq[0]));
    sq[1] = fmaf(v[1], v[1], fmaf(v[3], v[3], sq[1]));
  }
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
#pragma unroll
  for (int s = 0; s < kSlice / 8; ++s) {
    // K values 8s..8s+7 start 32 bytes further into each 128-byte row
    const uint64_t big = desc(b_big + 8 * s);
    const uint64_t small = desc(b_small + 8 * s);
    wgmma_n<N>(part, as[s], big, s > 0);
    wgmma_n<N>(part, ab[s], small, 1);
    wgmma_n<N>(part, ab[s], big, 1);
  }
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
  hold(part);
#pragma unroll
  for (int s = 0; s < kSlice / 8; ++s) {
    hold(ab[s]);
    hold(as[s]);
  }
}

// Tensor map of a row-major [rows, d] f32 matrix for TMA, boxes of
// box_rows x kSlice with the 128-byte swizzle; elements past the edges
// read as zero. Host side; needs d % 4 == 0 and a 16-byte aligned base.
inline CUresult make_map(CUtensorMap* map, const float* base, int rows,
                         int d, int box_rows) {
  const cuuint64_t dims[2] = {static_cast<cuuint64_t>(d),
                              static_cast<cuuint64_t>(rows)};
  const cuuint64_t strides[1] = {static_cast<cuuint64_t>(d) * 4};
  const cuuint32_t box[2] = {kSlice, static_cast<cuuint32_t>(box_rows)};
  const cuuint32_t step[2] = {1, 1};
  return cuTensorMapEncodeTiled(
      map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 2, const_cast<float*>(base),
      dims, strides, box, step, CU_TENSOR_MAP_INTERLEAVE_NONE,
      CU_TENSOR_MAP_SWIZZLE_128B, CU_TENSOR_MAP_L2_PROMOTION_L2_256B,
      CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE);
}

// True where TMA can read the rows (16-byte aligned base and rows).
inline bool tma_ok(const void* a, const void* b, int d) {
  return d % 4 == 0 && (reinterpret_cast<uintptr_t>(a) |
                        reinterpret_cast<uintptr_t>(b)) % 16 == 0;
}

// cudaFuncSetAttribute(kKernel, max dynamic shared memory) once per kernel
// and device: as a host call before every launch it would sit between the
// launches.
template <auto kKernel>
inline cudaError_t max_smem_once(int bytes) {
  static bool done[64] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess || (dev < 64 && done[dev])) return err;
  err = cudaFuncSetAttribute(kKernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize,
                             bytes);
  if (err == cudaSuccess && dev < 64) done[dev] = true;
  return err;
}

// The first 1024-byte aligned address at or after p (swizzled tiles).
__device__ __forceinline__ float* align1024(void* p) {
  return reinterpret_cast<float*>((reinterpret_cast<uintptr_t>(p) + 1023) &
                                  ~static_cast<uintptr_t>(1023));
}

}  // namespace tf32x3
