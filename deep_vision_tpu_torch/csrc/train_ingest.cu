// train_ingest: the training input prologue for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deep_vision_tpu/ops/pallas_ops.py
// `_train_ingest_kernel` (:202) behind `train_ingest` (:248).
//
// Computes, per pixel (r, g, b) of a uint8 NHWC batch with C = 3 and the
// pixel's image factors [fb, fc, fs, m] (factors row b, float32):
//     x = u / 255                        each channel
//     x = x * fb                         brightness
//     x = (x - m) * fc + m               contrast about the image mean m
//     gray = (r*0.299 + g*0.587) + b*0.114
//     x = gray + (x - gray) * fs         saturation toward the pixel's gray
//     x = clip(x, 0, 1)
//     out = (x - mean[c]) / std[c]       float32
// Every step is one IEEE round-to-nearest operation (__fdiv_rn,
// __fmul_rn, __fadd_rn, __fsub_rn), in the order the plain PyTorch
// version's separate elementwise ops perform them, so nvcc contracts
// nothing into an FMA and the output is bit-identical to
// ops/train_ingest.py train_ingest_plain.  Build without --use_fast_math.
//
// Bound: memory.  The kernel reads each input byte once (and 16 bytes of
// factors per image) and writes each float32 output once: at B=256,
// 224x224x3 that is 38.5 MB in and 154.1 MB out, about 57.5 us at
// 3.35 TB/s.  It does about 13 float32 operations per output element,
// 7.5 us at the 67 TFLOP/s float32 peak, so bytes bound it.
//
// Design: saturation mixes a pixel's three channels, so each thread
// computes whole pixels.  A block owns 1024 consecutive pixels of one
// image (the grid's y dimension is the image, so a block reads its
// image's four factors once): it copies their 3072 bytes into shared
// memory with coalesced 16-byte loads, each of its 256 threads turns 4
// pixels (12 bytes) into 12 floats in shared memory, and the block writes
// the 12 KB out with coalesced 16-byte stores.  Gray is a per-pixel sum
// in registers.  The TPU kernel's (B*H, W*C) row view, 256-row tiles,
// 128-lane padding and block-diagonal gray matmul were Mosaic/VMEM
// workarounds and are not carried over.  The last, partial block of an
// image, or every block of a batch whose image size is not a multiple of
// 16 bytes, reads and writes global memory a pixel per thread at a time.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 3;
constexpr int kThreads = 256;
constexpr int kPixelsPerThread = 4;
constexpr int kPixelsPerBlock = kThreads * kPixelsPerThread;  // 1024
constexpr int kBytesPerBlock = kPixelsPerBlock * kChannels;   // 3072

struct Consts {
  float mean[kChannels];
  float stdv[kChannels];
};

struct Factors {
  float fb, fc, fs, m;
};

__device__ __forceinline__ float clamp01(float v) {
  // torch.clamp propagates NaN; so does this
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// One pixel: three uint8 channels in, three float32 outputs.
__device__ __forceinline__ void jitter_pixel(const uint8_t* u, float* o,
                                             const Factors& f,
                                             const Consts& k) {
  float x[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float v = __fdiv_rn(static_cast<float>(u[c]), 255.0f);
    v = __fmul_rn(v, f.fb);
    v = __fadd_rn(__fmul_rn(__fsub_rn(v, f.m), f.fc), f.m);
    x[c] = v;
  }
  float gray = __fadd_rn(__fadd_rn(__fmul_rn(x[0], 0.299f),
                                   __fmul_rn(x[1], 0.587f)),
                         __fmul_rn(x[2], 0.114f));
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float v = __fadd_rn(gray, __fmul_rn(__fsub_rn(x[c], gray), f.fs));
    v = clamp01(v);
    o[c] = __fdiv_rn(__fsub_rn(v, k.mean[c]), k.stdv[c]);
  }
}

__global__ void __launch_bounds__(kThreads)
train_ingest_kernel(const uint8_t* __restrict__ x,
                    const float* __restrict__ factors,
                    float* __restrict__ out, long long pixels, Consts k,
                    int vectorized) {
  __shared__ uint4 in_tile[kBytesPerBlock / 16];   // 3 KB
  __shared__ float4 out_tile[kBytesPerBlock / 4];  // 12 KB
  const long long image = blockIdx.y;
  const long long p0 = static_cast<long long>(blockIdx.x) * kPixelsPerBlock;
  const float* fr = factors + image * 4;
  const Factors f{fr[0], fr[1], fr[2], fr[3]};
  const long long base = (image * pixels + p0) * kChannels;
  const uint8_t* src = x + base;
  float* dst = out + base;
  const int t = threadIdx.x;
  if (vectorized && p0 + kPixelsPerBlock <= pixels) {
    if (t < kBytesPerBlock / 16) {
      in_tile[t] = reinterpret_cast<const uint4*>(src)[t];
    }
    __syncthreads();
    const uint8_t* u =
        reinterpret_cast<const uint8_t*>(in_tile) + t * kPixelsPerThread *
                                                        kChannels;
    float* o = reinterpret_cast<float*>(out_tile) + t * kPixelsPerThread *
                                                        kChannels;
    uint32_t words[3];
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      words[j] = reinterpret_cast<const uint32_t*>(u)[j];
    }
    const uint8_t* b = reinterpret_cast<const uint8_t*>(words);
    float v[kPixelsPerThread * kChannels];
#pragma unroll
    for (int p = 0; p < kPixelsPerThread; ++p) {
      jitter_pixel(b + p * kChannels, v + p * kChannels, f, k);
    }
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      reinterpret_cast<float4*>(o)[j] =
          make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
    }
    __syncthreads();
    float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
    for (int j = 0; j < 3; ++j) {
      d4[t + j * kThreads] = out_tile[t + j * kThreads];
    }
    return;
  }
  const long long n = pixels - p0 < kPixelsPerBlock ? pixels - p0
                                                    : kPixelsPerBlock;
  for (long long p = t; p < n; p += kThreads) {
    jitter_pixel(src + p * kChannels, dst + p * kChannels, f, k);
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() of the
// launch (0 = cudaSuccess).  `x` is (batch, pixels, 3) uint8, `factors`
// (batch, 4) float32 and `out` (batch, pixels, 3) float32, all on the
// device and contiguous; `mean` and `stdv` are HOST arrays of 3 floats.
// `vectorized` must be 0 unless `x` and `out` are 16-byte aligned and
// pixels * 3 is a multiple of 16.
int dvt_train_ingest(const void* x, const void* factors, void* out,
                     int batch, long long pixels, const void* mean,
                     const void* stdv, int vectorized, void* stream) {
  if (batch < 0 || pixels < 0 || batch > 65535) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || pixels == 0) return static_cast<int>(cudaSuccess);
  Consts k;
  const float* m = static_cast<const float*>(mean);
  const float* s = static_cast<const float*>(stdv);
  for (int c = 0; c < kChannels; ++c) {
    k.mean[c] = m[c];
    k.stdv[c] = s[c];
  }
  dim3 grid(static_cast<unsigned int>((pixels + kPixelsPerBlock - 1) /
                                      kPixelsPerBlock),
            static_cast<unsigned int>(batch));
  train_ingest_kernel<<<grid, kThreads, 0,
                        static_cast<cudaStream_t>(stream)>>>(
      static_cast<const uint8_t*>(x), static_cast<const float*>(factors),
      static_cast<float*>(out), pixels, k, vectorized);
  return static_cast<int>(cudaGetLastError());
}

const char* dvt_train_ingest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
