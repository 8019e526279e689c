// ArcFace margin logits for NVIDIA Hopper (sm_90a).
//
// Replaces multimodalsimilar_tpu/ops/arcface.py:_arcface_kernel (launched
// by _fused_forward through pl.pallas_call). For x [B, D] f32, W [C, D] f32
// and label [B] int32 (-1 = no target column) it writes the [B, C] f32
// logits
//
//   cos  = (x[r] . W[c]) * rsqrt(max(|x[r]|^2, 1e-24)) * rsqrt(max(|W[c]|^2, 1e-24))
//   sine = sqrt(clip(1 - cos^2, 0, 1)),  phi = cos*cos(m) - sine*sin(m)
//   easy_margin: phi if cos > 0 else cos
//   otherwise:   phi if cos + cos(m) > 0 else cos - sin(m)*m
//   out[r, c] = s * (c == label[r] ? phi : cos)
//
// with m and s passed as float arguments on every launch, so the margin
// curriculum changes nothing but an argument.
//
// Bound on an H100 SXM at the training slice's shape (B=128, C=10,205,
// D=768): 2*B*C*D = 2.01e9 f32 operations at 67 TFLOP/s on the CUDA cores
// take 0.030 ms; the bytes (x, W and the labels read once, the logits
// written once: 4*(B*D + C*D + B*C + B) = 37.0 MB) take 0.011 ms at
// 3.35 TB/s. So the kernel is bound by operations.
//
// Design (a simple, correct first version; TF32, tensor cores, TMA and
// wgmma are for a later redesign):
// 1. inv_norms_kernel: one warp per row of x and of W computes the inverse
//    L2 norm in f32 into a [B + C] scratch vector that the wrapper owns.
// 2. arcface_kernel: a tiled f32 product on the CUDA cores. Each block of
//    256 threads owns a 64 x 64 output tile and walks D in 16-deep slices
//    of x and W staged in shared memory; each thread keeps 4 x 4 sums in
//    registers (rows ty + 16i, columns tx + 16j, so neighbouring threads
//    read neighbouring shared words and write neighbouring columns). The
//    epilogue scales by both inverse norms, applies the margin on the
//    label column and writes each output once. The ragged edges in B, C
//    and D are masked in the loads and the stores; nothing is padded in
//    device memory. The TPU kernel's padded classes and rows do not exist
//    here.

#include <cuda_runtime.h>

#include <cstddef>

namespace {

constexpr int kTile = 64;      // output tile: kTile rows x kTile classes
constexpr int kDepth = 16;     // k-slice staged in shared memory
constexpr int kThreads = 256;  // 16 x 16 threads
constexpr int kPer = 4;        // outputs per thread along each axis
constexpr int kNormWarps = 8;  // rows per block of inv_norms_kernel

static_assert(kPer * 16 == kTile, "16 threads x kPer cover the tile");
static_assert((kTile * kDepth) % kThreads == 0, "whole staging rounds");

__global__ void __launch_bounds__(kNormWarps * 32)
inv_norms_kernel(const float* __restrict__ x, const float* __restrict__ w,
                 int b, int c, int d, float* __restrict__ inv) {
  const int row = blockIdx.x * kNormWarps + threadIdx.x / 32;
  const int lane = threadIdx.x % 32;
  if (row >= b + c) return;  // whole warps leave together
  const float* src = row < b ? x + static_cast<size_t>(row) * d
                             : w + static_cast<size_t>(row - b) * d;
  float acc = 0.f;
  for (int k = lane; k < d; k += 32) {
    const float v = src[k];
    acc = fmaf(v, v, acc);
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, off);
  if (lane == 0) inv[row] = rsqrtf(fmaxf(acc, 1e-24f));
}

__global__ void __launch_bounds__(kThreads)
arcface_kernel(const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ label, const float* __restrict__ inv,
               float* __restrict__ out, int b, int c, int d, float m,
               float s, int easy_margin) {
  // +4 keeps the column stores of one staging round off a single bank
  __shared__ float xs[kDepth][kTile + 4];
  __shared__ float ws[kDepth][kTile + 4];
  const int tx = threadIdx.x % 16;
  const int ty = threadIdx.x / 16;
  const int row0 = blockIdx.y * kTile;
  const int col0 = blockIdx.x * kTile;

  float acc[kPer][kPer];
#pragma unroll
  for (int i = 0; i < kPer; ++i)
#pragma unroll
    for (int j = 0; j < kPer; ++j) acc[i][j] = 0.f;

  for (int k0 = 0; k0 < d; k0 += kDepth) {
#pragma unroll
    for (int i = threadIdx.x; i < kTile * kDepth; i += kThreads) {
      const int r = i / kDepth;
      const int k = i % kDepth;
      const int gk = k0 + k;
      const int gr = row0 + r;
      const int gc = col0 + r;
      xs[k][r] = (gr < b && gk < d) ? x[static_cast<size_t>(gr) * d + gk]
                                    : 0.f;
      ws[k][r] = (gc < c && gk < d) ? w[static_cast<size_t>(gc) * d + gk]
                                    : 0.f;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < kDepth; ++k) {
      float xa[kPer], wb[kPer];
#pragma unroll
      for (int i = 0; i < kPer; ++i) {
        xa[i] = xs[k][ty + 16 * i];
        wb[i] = ws[k][tx + 16 * i];
      }
#pragma unroll
      for (int i = 0; i < kPer; ++i)
#pragma unroll
        for (int j = 0; j < kPer; ++j) acc[i][j] = fmaf(xa[i], wb[j], acc[i][j]);
    }
    __syncthreads();
  }

  const float cos_m = cosf(m);
  const float sin_m = sinf(m);
#pragma unroll
  for (int i = 0; i < kPer; ++i) {
    const int r = row0 + ty + 16 * i;
    if (r >= b) continue;
    const float x_inv = inv[r];
    const int target = label[r];
#pragma unroll
    for (int j = 0; j < kPer; ++j) {
      const int col = col0 + tx + 16 * j;
      if (col >= c) continue;
      const float cosv = acc[i][j] * x_inv * inv[b + col];
      float v = cosv;
      if (col == target) {
        const float sine = sqrtf(fminf(fmaxf(1.f - cosv * cosv, 0.f), 1.f));
        const float phi = cosv * cos_m - sine * sin_m;
        if (easy_margin)
          v = cosv > 0.f ? phi : cosv;
        else
          v = cosv + cos_m > 0.f ? phi : cosv - sin_m * m;
      }
      out[static_cast<size_t>(r) * c + col] = s * v;
    }
  }
}

}  // namespace

extern "C" int mms_arcface_tile() { return kTile; }

// Launches both kernels on `stream`; returns the cudaError_t of the
// launches (0 on success). inv_norms is caller-owned scratch of B + C
// floats.
extern "C" int mms_arcface(const float* x, const float* w, const int* label,
                           float* inv_norms, float* out, int b, int c, int d,
                           float m, float s, int easy_margin, void* stream) {
  if (b <= 0 || c <= 0 || d < 0 || (b + kTile - 1) / kTile > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int rows = b + c;
  inv_norms_kernel<<<(rows + kNormWarps - 1) / kNormWarps, kNormWarps * 32,
                     0, st>>>(x, w, b, c, d, inv_norms);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return static_cast<int>(err);
  const dim3 grid((c + kTile - 1) / kTile, (b + kTile - 1) / kTile);
  arcface_kernel<<<grid, kThreads, 0, st>>>(x, w, label, inv_norms, out, b,
                                            c, d, m, s, easy_margin);
  return static_cast<int>(cudaGetLastError());
}
