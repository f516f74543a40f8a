// best_iou_max: the YOLOv3 loss's ignore-mask reduction for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deep_vision_tpu/ops/pallas_ops.py
// `_best_iou_kernel` (:377) behind `best_iou_max` (:402).
//
// Computes, for each image b and prediction i of (B, N, 4) float32 corner
// boxes (x1, y1, x2, y2) against (B, M, 4) float32 corner ground truths
// and a (B, M) float32 mask:
//     out[b, i] = max_j (mask[b, j] > 0 ? iou(pred[b, i], gt[b, j]) : 0)
//     iou = inter / (((area_p + area_g) - inter) + 1e-9)
// with inter = max(min(x2) - max(x1), 0) * max(min(y2) - max(y1), 0) and
// area = max(x2 - x1, 0) * max(y2 - y1, 0), and out = 0 when M == 0.
// Every step is one IEEE round-to-nearest operation (__fsub_rn,
// __fmul_rn, __fadd_rn, __fdiv_rn) in the order the plain PyTorch
// version (ops/best_iou.py best_iou_max_plain) performs them, so nvcc
// contracts nothing into an FMA and the output is bit-identical to it.
// max and min propagate NaN as torch.maximum / torch.minimum / amax do
// (PTX max.NaN / min.NaN; fmaxf alone would drop it), so a NaN
// prediction row scores NaN against an unmasked ground truth and 0 where
// every one is masked (a NaN's payload may differ from the plain
// version's; it is NaN either way).
// Build without --use_fast_math.
//
// Bound: operations.  At the YOLOv3 416x416 scale-0 shape (B=128,
// N=8112, M=100) the kernel reads 20 bytes a prediction and 20 a ground
// truth and writes 4 a prediction, 20.8 MB, about 6.2 us at 3.35 TB/s;
// it evaluates 103.8 M pairs at about 15 float32 operations each (one an
// IEEE division, itself several issued instructions), 1.56 G operations,
// 23 us at the 67 TFLOP/s float32 peak.  A masked pair costs one compare.
//
// Design: the grid is (ceil(N / 256), B).  A block stages up to 256 of
// its image's ground truths at a time in shared memory (box, area and
// mask flag: 24 bytes each), and each of its 256 threads owns one
// prediction: one 16-byte load, its own area once, a loop over the
// staged boxes reading shared memory by broadcast, and one float
// written.  The TPU kernel's transposed (B, 4, M) ground truths, M padded
// to 128 lanes, N padded to 256-row tiles and full-batch blocks were
// Mosaic layout rules and are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kChunk = 256;  // ground truths staged per pass

// torch.maximum / torch.minimum / amax: NaN if either operand is NaN.
// PTX's .NaN variants (sm_80+) do that in one instruction; fmaxf alone
// would drop the NaN, and an isnan test compiles to a branch.
__device__ __forceinline__ float max_nan(float a, float b) {
  float d;
  asm("max.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

__device__ __forceinline__ float min_nan(float a, float b) {
  float d;
  asm("min.NaN.f32 %0, %1, %2;" : "=f"(d) : "f"(a), "f"(b));
  return d;
}

// torch.clamp_min(v, 0): NaN stays NaN.
__device__ __forceinline__ float clamp0(float v) { return max_nan(v, 0.0f); }

__device__ __forceinline__ float box_area(float4 b) {
  return __fmul_rn(clamp0(__fsub_rn(b.z, b.x)), clamp0(__fsub_rn(b.w, b.y)));
}

__global__ void __launch_bounds__(kThreads)
best_iou_max_kernel(const float4* __restrict__ pred,
                    const float4* __restrict__ gt,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int n, int m) {
  __shared__ float4 s_gt[kChunk];
  __shared__ float s_area[kChunk];
  __shared__ int s_on[kChunk];
  const long long image = blockIdx.y;
  const int i = blockIdx.x * kThreads + threadIdx.x;
  const bool live = i < n;
  const float4 p =
      live ? pred[image * n + i] : make_float4(0.f, 0.f, 0.f, 0.f);
  const float area_p = box_area(p);
  float best = m > 0 ? -INFINITY : 0.0f;
  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int count = m - j0 < kChunk ? m - j0 : kChunk;
    __syncthreads();  // every thread is done with the previous chunk
    for (int j = threadIdx.x; j < count; j += kThreads) {
      const long long k = image * m + j0 + j;
      const float4 g = gt[k];
      s_gt[j] = g;
      s_area[j] = box_area(g);
      s_on[j] = mask[k] > 0.0f;
    }
    __syncthreads();
    if (!live) continue;
    for (int j = 0; j < count; ++j) {
      float iou = 0.0f;
      if (s_on[j]) {
        const float4 g = s_gt[j];
        const float w =
            clamp0(__fsub_rn(min_nan(p.z, g.z), max_nan(p.x, g.x)));
        const float h =
            clamp0(__fsub_rn(min_nan(p.w, g.w), max_nan(p.y, g.y)));
        const float inter = __fmul_rn(w, h);
        const float sum = __fadd_rn(area_p, s_area[j]);
        const float denom = __fadd_rn(__fsub_rn(sum, inter), 1e-9f);
        iou = __fdiv_rn(inter, denom);
      }
      best = max_nan(best, iou);
    }
  }
  if (live) out[image * n + i] = best;
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() of the
// launch (0 = cudaSuccess).  `pred` is (batch, n, 4), `gt` (batch, m, 4),
// `mask` (batch, m) and `out` (batch, n), all float32, on the device,
// contiguous, and `pred`/`gt` 16-byte aligned.
int dvt_best_iou_max(const void* pred, const void* gt, const void* mask,
                     void* out, int batch, int n, int m, void* stream) {
  if (batch < 0 || n < 0 || m < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || n == 0) return static_cast<int>(cudaSuccess);
  dim3 grid(static_cast<unsigned int>((n + kThreads - 1) / kThreads),
            static_cast<unsigned int>(batch));
  best_iou_max_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const float4*>(pred), static_cast<const float4*>(gt),
      static_cast<const float*>(mask), static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

const char* dvt_best_iou_max_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
