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
// The output is bit-identical to the plain PyTorch version
// (ops/best_iou.py best_iou_max_plain): every step is one IEEE
// round-to-nearest operation (__fsub_rn, __fmul_rn, __fadd_rn, __fdiv_rn)
// in the plain version's order, so nvcc contracts nothing into an FMA,
// and max / min propagate NaN as torch.maximum / minimum / amax do (PTX
// max.NaN / min.NaN).  A NaN's payload may differ; it is NaN either way.
// Build without --use_fast_math.
//
// Bound: operations.  At the YOLOv3 416x416 scale-0 shape (B=128,
// N=8112, M=100) the kernel reads 20 bytes a prediction and 20 a ground
// truth and writes 4 a prediction, 20.8 MB, about 6.2 us at 3.35 TB/s.
// With 70% of the ground truths unmasked it evaluates 72.7 M pairs at
// 12 float32 operations of the IoU terms (4 NaN-propagating min/max, 2
// sides, 2 clamps, the intersection, 3 adds of the denominator) and 7 of
// the comparison below (2 products, 3 compares, 2 selects), none of
// which can be an FMA: the instruction rate, not the 67 TFLOP/s FMA
// rate, is the floor (PERF.md counts the SASS).  At a COCO-like share
// (7 of 100 unmasked) the bytes bound it.
//
// Design:
// 1. Compaction.  A block stages its image's ground truths 256 at a time:
//    each thread loads one, and a warp ballot plus a scan of the 8 warps'
//    counts writes the unmasked ones, packed, into shared memory (box and
//    area).  Masked pairs cost nothing.  Every IoU is >= +0 or NaN (the
//    sides are clamped with max.NaN, which orders -0 below +0, and the
//    denominator is positive), and a masked ground truth adds an exact
//    +0 to the max, so every result starts at +0; with M = 0 it stays 0.
// 2. One division per prediction.  Round-to-nearest is monotone, so
//    max_j rn(inter_j / den_j) = rn(inter_* / den_*) for the pair * with
//    the largest exact quotient.  Every denominator is >= 1e-9 (the
//    intersection never exceeds either area), so a thread keeps its
//    leader (inter_*, den_*) and a candidate beats it when
//    inter_j * den_* > inter_* * den_j exactly.  The two float32 products
//    decide whenever they differ (rounding is monotone, overflow and
//    underflow included); if they are equal for a pair with inter_j > 0,
//    the float64 products, exact for float32 operands, break the tie (a
//    branch taken on ties only: duplicated or near-identical boxes).
//    The winner is divided once, with __fdiv_rn.
// 3. The non-finite path.  A box is tame when every |coordinate| <= 2^62:
//    then every term of its pairs is finite.  Unmasked ground truths that
//    are not tame are packed from the other end of the staging buffer,
//    and a thread holding a prediction that is not tame, as well as every
//    thread for those ground truths, takes the per-pair path: the IEEE
//    division of every pair and a running max.NaN, merged with the
//    leader's value at the end.  NaN and inf results are the plain
//    version's.
// 4. Register blocking.  Each thread owns R predictions (4, 2 or 1: the
//    launcher takes the largest R that still gives kMinBlocks blocks), so
//    one shared-memory read of a ground truth serves R pairs.  The grid
//    is (ceil(N / (256 R)), B).
// The TPU kernel's transposed (B, 4, M) ground truths, M padded to 128
// lanes, N padded to 256-row tiles and full-batch blocks were Mosaic
// layout rules and are not carried over.

#include <cuda_runtime.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunk = kThreads;  // ground truths staged per pass
// fewest blocks a launch may have before a thread takes fewer predictions
constexpr int kMinBlocks = 512;
// 1: one division per prediction.  0 sends every pair down the per-pair
// path: compaction alone, the design kernel_ab.py measures this one against
constexpr int kDivideOnce = 1;
// |coordinate| <= 2^62 keeps a pair finite: sides <= 2^63, areas and
// intersections <= 2^126, the denominator <= 2^127 + 1e-9
constexpr float kTame = 4.611686018427387904e18f;

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

// false for NaN and inf as well as for huge coordinates
__device__ __forceinline__ bool is_tame(float4 b) {
  return fabsf(b.x) <= kTame && fabsf(b.y) <= kTame &&
         fabsf(b.z) <= kTame && fabsf(b.w) <= kTame;
}

// The pair's intersection and IoU denominator, in the plain order.
__device__ __forceinline__ void pair_terms(float4 p, float area_p, float4 g,
                                           float area_g, float& inter,
                                           float& den) {
  const float w = clamp0(__fsub_rn(min_nan(p.z, g.z), max_nan(p.x, g.x)));
  const float h = clamp0(__fsub_rn(min_nan(p.w, g.w), max_nan(p.y, g.y)));
  inter = __fmul_rn(w, h);
  den = __fadd_rn(__fsub_rn(__fadd_rn(area_p, area_g), inter), 1e-9f);
}

// Today's per-pair IoU, for the non-finite path.
__device__ __forceinline__ float pair_iou(float4 p, float area_p, float4 g,
                                          float area_g) {
  float inter, den;
  pair_terms(p, area_p, g, area_g, inter, den);
  return __fdiv_rn(inter, den);
}

// One pass of a thread's R leaders over `count` staged tame records.
template <int R>
__device__ __forceinline__ void scan_tame(const float4* s_box,
                                          const float* s_area, int count,
                                          const float4 (&p)[R],
                                          const float (&area_p)[R],
                                          float (&lead_inter)[R],
                                          float (&lead_den)[R]) {
  for (int k = 0; k < count; ++k) {
    const float4 g = s_box[k];
    const float area_g = s_area[k];
#pragma unroll
    for (int r = 0; r < R; ++r) {
      float inter, den;
      pair_terms(p[r], area_p[r], g, area_g, inter, den);
      const float a = __fmul_rn(inter, lead_den[r]);
      const float b = __fmul_rn(lead_inter[r], den);
      bool take = a > b;
      if (a == b && inter > 0.0f) {  // a tie of the rounded products
        take = static_cast<double>(inter) * lead_den[r] >
               static_cast<double>(lead_inter[r]) * den;
      }
      lead_inter[r] = take ? inter : lead_inter[r];
      lead_den[r] = take ? den : lead_den[r];
    }
  }
}

template <int R>
__global__ void __launch_bounds__(kThreads)
best_iou_max_kernel(const float4* __restrict__ pred,
                    const float4* __restrict__ gt,
                    const float* __restrict__ mask, float* __restrict__ out,
                    int n, int m) {
  __shared__ float4 s_box[kChunk];
  __shared__ float s_area[kChunk];
  __shared__ int s_count[2 * kWarps];
  const long long image = blockIdx.y;
  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const unsigned below = (1u << lane) - 1u;
  const int first = blockIdx.x * (kThreads * R) + threadIdx.x;

  float4 p[R];
  float area_p[R], lead_inter[R], lead_den[R], wild[R];
  bool all_tame = kDivideOnce != 0;
#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + r * kThreads;
    p[r] = i < n ? pred[image * n + i] : make_float4(0.f, 0.f, 0.f, 0.f);
    area_p[r] = box_area(p[r]);
    lead_inter[r] = 0.0f;  // quotient 0: only inter > 0 can beat it
    lead_den[r] = 1.0f;
    wild[r] = -INFINITY;
    all_tame = all_tame && is_tame(p[r]);
  }

  for (int j0 = 0; j0 < m; j0 += kChunk) {
    const int j = j0 + threadIdx.x;
    bool on_tame = false, on_wild = false;
    float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
    if (j < m) {
      g = gt[image * m + j];
      const bool on = mask[image * m + j] > 0.0f;
      const bool tame = is_tame(g);
      on_tame = on && tame;
      on_wild = on && !tame;
    }
    const unsigned ballot_tame = __ballot_sync(0xffffffffu, on_tame);
    const unsigned ballot_wild = __ballot_sync(0xffffffffu, on_wild);
    __syncthreads();  // every thread is done with the previous chunk
    if (lane == 0) {
      s_count[warp] = __popc(ballot_tame);
      s_count[kWarps + warp] = __popc(ballot_wild);
    }
    __syncthreads();
    int base_tame = 0, base_wild = 0, n_tame = 0, n_wild = 0;
#pragma unroll
    for (int w = 0; w < kWarps; ++w) {
      const int ct = s_count[w], cw = s_count[kWarps + w];
      if (w < warp) {
        base_tame += ct;
        base_wild += cw;
      }
      n_tame += ct;
      n_wild += cw;
    }
    // tame records from the front, the others from the back
    if (on_tame || on_wild) {
      const int k = on_tame
                        ? base_tame + __popc(ballot_tame & below)
                        : kChunk - 1 - base_wild - __popc(ballot_wild & below);
      s_box[k] = g;
      s_area[k] = box_area(g);
    }
    __syncthreads();

    if (all_tame) {
      scan_tame<R>(s_box, s_area, n_tame, p, area_p, lead_inter, lead_den);
    } else {
      for (int k = 0; k < n_tame; ++k) {
        const float4 gk = s_box[k];
        const float area_g = s_area[k];
#pragma unroll
        for (int r = 0; r < R; ++r) {
          wild[r] = max_nan(wild[r], pair_iou(p[r], area_p[r], gk, area_g));
        }
      }
    }
    for (int k = kChunk - n_wild; k < kChunk; ++k) {
      const float4 gk = s_box[k];
      const float area_g = s_area[k];
#pragma unroll
      for (int r = 0; r < R; ++r) {
        wild[r] = max_nan(wild[r], pair_iou(p[r], area_p[r], gk, area_g));
      }
    }
  }

#pragma unroll
  for (int r = 0; r < R; ++r) {
    const int i = first + r * kThreads;
    if (i < n) {
      const float fast = lead_inter[r] > 0.0f
                             ? __fdiv_rn(lead_inter[r], lead_den[r])
                             : 0.0f;
      out[image * n + i] = max_nan(fast, wild[r]);
    }
  }
}

template <int R>
int launch(const void* pred, const void* gt, const void* mask, void* out,
           int batch, int n, int m, cudaStream_t stream) {
  dim3 grid(static_cast<unsigned int>((n + kThreads * R - 1) /
                                      (kThreads * R)),
            static_cast<unsigned int>(batch));
  best_iou_max_kernel<R><<<grid, kThreads, 0, stream>>>(
      static_cast<const float4*>(pred), static_cast<const float4*>(gt),
      static_cast<const float*>(mask), static_cast<float*>(out), n, m);
  return static_cast<int>(cudaGetLastError());
}

long long blocks_for(int batch, int n, int r) {
  return static_cast<long long>(batch) *
         ((n + kThreads * r - 1) / (kThreads * r));
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
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (blocks_for(batch, n, 4) >= kMinBlocks) {
    return launch<4>(pred, gt, mask, out, batch, n, m, st);
  }
  if (blocks_for(batch, n, 2) >= kMinBlocks) {
    return launch<2>(pred, gt, mask, out, batch, n, m, st);
  }
  return launch<1>(pred, gt, mask, out, batch, n, m, st);
}

const char* dvt_best_iou_max_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
