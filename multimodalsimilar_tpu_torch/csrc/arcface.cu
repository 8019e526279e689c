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
// D=768): 2*B*C*D = 2.01e9 multiply-adds at f32 accuracy, on the tensor
// cores as three TF32 products (tf32x3.cuh) at 495 / 3 = 165 TFLOP/s,
// take 0.0122 ms; the bytes (x, W and the labels read once, the logits
// written once: 4*(B*D + C*D + B*C + B) = 37.0 MB) take 0.0110 ms at
// 3.35 TB/s. So the kernel is bound by operations, barely: W has to
// stream from memory at close to the full rate while the tensor cores
// work.
//
// Design: one kernel. Each block of three warpgroups (384 threads) owns a
// 128 x 80 output tile (128 rows of x, 80 classes), so B = 128,
// C = 10,205 is 128 blocks, one wave on 132 SMs. It walks D in 32-deep
// slices through a ring of 4 shared-memory slots: the producer warpgroup
// copies each slice of x and W with TMA (cp.async where rows are not
// 16-byte aligned) and splits W into TF32 big and small tiles, while each
// consumer warpgroup multiplies its 64 rows of x by the 80 rows of W with
// wgmma m64n80k8 3xTF32 (f32 accuracy; x split in registers; tf32x3.cuh).
// The sums stay in registers, one partial per slice added in f32: the
// tensor core's accumulation rounds toward zero, and with one running sum
// over all 288 products of D = 768 that bias moved cos by about 7e-6 where
// every product has the same sign (x = +-W rows, cos = +-1), past what the
// sine's steep edge tolerates (H100 80GB HBM3, 700 W). The row norms come
// from the same loads: the producer sums the squares of the W values it
// splits, each consumer thread those of the x values it loads, so no
// pre-pass reads x and W a second time (a separate norm kernel took 16 us
// of 57 on an H100 80GB HBM3 at 700 W). The epilogue scales by both
// inverse norms, applies the margin on the label column, multiplies by s
// and writes each logit once, straight from registers. The ragged edges in B, C and D are
// zero-filled by the copies and masked in the stores; nothing is padded
// in device memory.
//
// ptxas (-Xptxas -v, printed by chip_smoke.py): 168 registers at launch,
// moved by setmaxnreg to 232 for the consumers and 40 for the producer;
// no spills.

#include <cuda_runtime.h>

#include <cstddef>
#include <cstdint>

#include "tf32x3.cuh"

namespace {

using tf32x3::kSlice;

constexpr int kBM = 128;       // rows of x per block: two warpgroups
constexpr int kBN = 80;        // classes per block: the wgmma's N
constexpr int kConsumers = 256;  // two consumer warpgroups
constexpr int kThreads = kConsumers + 128;   // and the producer warpgroup
constexpr int kStages = 4;
constexpr int kAFloats = tf32x3::tile_floats(kBM);
constexpr int kBFloats = tf32x3::tile_floats(kBN);
constexpr int kStageFloats = kAFloats + 2 * kBFloats;
// the ring (1024-byte aligned, hence the slack), one mbarrier a stage and
// the inverse norms of the tile's W rows
constexpr size_t kSmem =
    1024 + sizeof(float) * (kStages * kStageFloats + kBN) + 8 * kStages;
constexpr int kNormBarrier = 3 * kStages + 1;   // W's norms are ready

__global__ void __launch_bounds__(kThreads, 1)
arcface_kernel(const __grid_constant__ CUtensorMap map_x,
               const __grid_constant__ CUtensorMap map_w,
               const float* __restrict__ x, const float* __restrict__ w,
               const int* __restrict__ label, float* __restrict__ out, int b,
               int c, int d, float m, float s, int easy_margin, int tma) {
  extern __shared__ __align__(16) float smem[];
  float* ring = tf32x3::align1024(smem);
  float* w_inv = ring + kStages * kStageFloats;                  // [kBN]
  uint64_t* bars = reinterpret_cast<uint64_t*>(w_inv + kBN);     // [kStages]
  const int tid = threadIdx.x;
  const int brow = blockIdx.y * kBM;
  const int col0 = blockIdx.x * kBN;
  const int steps = (d + kSlice - 1) / kSlice;
  if (tid == 0) {
    for (int i = 0; i < kStages; ++i) tf32x3::mbar_init(bars + i, 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  if (tid >= kConsumers) {
    // -- the producer warpgroup: copies and splits, nothing else ----------
    tf32x3::regs_dec<40>();
    const int ptid = tid - kConsumers;
    // squares of W row ptid / 8 + 16 i, columns 4 (ptid % 8) .. + 3 of
    // each slice: the chunks this thread splits
    constexpr int kRowsPer = kBN * (kSlice / 4) / 128;
    float wsq[kRowsPer] = {};
    tf32x3::produce<kStages, 2>(
        steps, tma, bars, 4 * (kAFloats + kBFloats), ptid,
        [&](int step, int slot) {
          float* st = ring + slot * kStageFloats;
          const int k0 = step * kSlice;
          if (tma) {
            tf32x3::tma_load(st, &map_x, k0, brow, bars + slot);
            tf32x3::tma_load(st + kAFloats, &map_w, k0, col0, bars + slot);
          } else {
            tf32x3::load_chunks<kBM, 128>(st, x, brow, b, d, k0, ptid);
            tf32x3::load_chunks<kBN, 128>(st + kAFloats, w, col0, c, d, k0,
                                          ptid);
          }
        },
        [&](int slot) {
          float* wt = ring + slot * kStageFloats + kAFloats;
          tf32x3::split_chunks<kBN, 128>(
              wt, wt + kBFloats, ptid, [&](int i, float4 v) {
                wsq[i] = fmaf(v.x, v.x, fmaf(v.y, v.y, fmaf(v.z, v.z,
                         fmaf(v.w, v.w, wsq[i]))));
              });
        });
#pragma unroll
    for (int i = 0; i < kRowsPer; ++i) {
      float v = wsq[i];
#pragma unroll
      for (int o = 1; o < 8; o <<= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
      if ((ptid & 7) == 0) w_inv[ptid / 8 + 16 * i] = rsqrtf(fmaxf(v, 1e-24f));
    }
    tf32x3::bar_arrive(kNormBarrier, kThreads);
    return;
  }

  // -- the consumer warpgroups ----------------------------------------------
  tf32x3::regs_inc<232>();
  const int lane = tid & 31;
  const int row0 = 16 * (tid >> 5);    // this warp's 16 rows of the tile
  float acc[kBN / 2] = {};
  float sq[2] = {};      // squares of x rows row0 + g + 8h, a quarter each
  for (int step = 0; step < steps; ++step) {
    tf32x3::wait_full<kStages, 2>(step, tid / 128);
    const float* st = ring + (step % kStages) * kStageFloats;
    const float* w_big = st + kAFloats;
    float part[kBN / 2];
    tf32x3::slice_product<kBN>(part, sq, st, row0, w_big, w_big + kBFloats,
                               lane);
    tf32x3::release<kStages, 2>(step);
#pragma unroll
    for (int e = 0; e < kBN / 2; ++e) acc[e] += part[e];
  }

  // acc[4j + 2h + e] is row row0 + g + 8h, class 8j + 2t + e of the tile
  const float cos_m = cosf(m);
  const float sin_m = sinf(m);
  const int g = lane >> 2;
  const int t = lane & 3;
  tf32x3::bar_sync(kNormBarrier, kThreads);
#pragma unroll
  for (int h = 0; h < 2; ++h) {
    float x_sq = sq[h];
    x_sq += __shfl_xor_sync(0xffffffffu, x_sq, 1);
    x_sq += __shfl_xor_sync(0xffffffffu, x_sq, 2);
    const int r = brow + row0 + g + 8 * h;
    if (r >= b) continue;
    const float x_inv = rsqrtf(fmaxf(x_sq, 1e-24f));
    const int target = label[r];
#pragma unroll
    for (int j = 0; j < kBN / 8; ++j)
#pragma unroll
      for (int e = 0; e < 2; ++e) {
        const int col = col0 + 8 * j + 2 * t + e;
        if (col >= c) continue;
        const float cosv =
            acc[4 * j + 2 * h + e] * x_inv * w_inv[col - col0];
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

extern "C" int mms_arcface_tile_rows() { return kBM; }

extern "C" int mms_arcface_tile_classes() { return kBN; }

// Launches the kernel on `stream`; returns the cudaError_t of the launch
// (0 on success).
extern "C" int mms_arcface(const float* x, const float* w, const int* label,
                           float* out, int b, int c, int d, float m, float s,
                           int easy_margin, void* stream) {
  if (b <= 0 || c <= 0 || d < 0 || (b + kBM - 1) / kBM > 65535)
    return static_cast<int>(cudaErrorInvalidValue);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const cudaError_t err =
      tf32x3::max_smem_once<arcface_kernel>(static_cast<int>(kSmem));
  if (err != cudaSuccess) return static_cast<int>(err);
  CUtensorMap map_x{}, map_w{};
  const int tma = d > 0 && tf32x3::tma_ok(x, w, d);
  if (tma && (tf32x3::make_map(&map_x, x, b, d, kBM) != CUDA_SUCCESS ||
              tf32x3::make_map(&map_w, w, c, d, kBN) != CUDA_SUCCESS))
    return static_cast<int>(cudaErrorInvalidValue);
  const dim3 grid((c + kBN - 1) / kBN, (b + kBM - 1) / kBM);
  arcface_kernel<<<grid, kThreads, kSmem, st>>>(map_x, map_w, x, w, label,
                                                out, b, c, d, m, s,
                                                easy_margin, tma);
  return static_cast<int>(cudaGetLastError());
}
