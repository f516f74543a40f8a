// serve_ingest: the int8 serving prologue for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel deep_vision_tpu/ops/pallas_ops.py
// `_serve_ingest_kernel` (:77) behind `serve_ingest` (:94).
//
// Computes, per byte of a uint8 NHWC wire batch, with c = index % C:
//     y = (x / 255 - mean[c]) / std[c]
//     quantize: out = int8(clip(rint(y / act_scale), -127, 127))
//     else:     out = y (float32)
// in float32 with IEEE round-to-nearest division (__fdiv_rn, never a
// reciprocal multiply) and rintf (round half to even), so the result is
// bit-identical to the plain PyTorch version and to the JAX reference
// (ops/ingest.py serve_ingest_plain).  Build without --use_fast_math.
//
// Bound: memory.  The kernel reads each input byte once and writes each
// output once: at B=32, 224x224x3 that is 4.8 MB in and 4.8 MB out
// (int8), about 2.9 us at 3.35 TB/s.  At B=1 the launch dominates.
//
// Design: one thread owns 16 contiguous bytes.  When the input is
// 16-byte aligned it loads them as one uint4 and stores 16 int8 as one
// uint4 (or 16 floats as four float4); the channel of each byte follows
// from its flat index, so NHWC needs no reshaping.  Bytes past the last
// whole 16-byte chunk, or every byte of a misaligned input, take the
// scalar path.  Mean and std (at most 4 channels) travel by value in
// the kernel's parameter block.  The TPU kernel's (B*H, W*C) row view
// and 256x128 padding were VMEM tiling artefacts and are not carried
// over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kBytesPerThread = 16;
constexpr int kThreads = 256;

struct NormConsts {
  float mean[kMaxChannels];
  float stdv[kMaxChannels];
};

__device__ __forceinline__ float normalize(uint8_t u, int c,
                                           const NormConsts& k) {
  float x = __fdiv_rn(static_cast<float>(u), 255.0f);
  return __fdiv_rn(__fsub_rn(x, k.mean[c]), k.stdv[c]);
}

__device__ __forceinline__ int8_t quantize(float y, float act_scale) {
  float q = rintf(__fdiv_rn(y, act_scale));
  q = fminf(fmaxf(q, -127.0f), 127.0f);
  return static_cast<int8_t>(q);
}

template <bool kQuantize>
__global__ void serve_ingest_kernel(const uint8_t* __restrict__ x,
                                    void* __restrict__ out, long long n,
                                    int channels, NormConsts k,
                                    float act_scale, int vectorized) {
  long long t = static_cast<long long>(blockIdx.x) * blockDim.x + threadIdx.x;
  long long start = t * kBytesPerThread;
  if (start >= n) return;
  int c = static_cast<int>(start % channels);
  if (vectorized && start + kBytesPerThread <= n) {
    uint4 raw = *reinterpret_cast<const uint4*>(x + start);
    const uint8_t* b = reinterpret_cast<const uint8_t*>(&raw);
    if (kQuantize) {
      uint4 packed;
      int8_t* q = reinterpret_cast<int8_t*>(&packed);
#pragma unroll
      for (int j = 0; j < kBytesPerThread; ++j) {
        q[j] = quantize(normalize(b[j], c, k), act_scale);
        c = (c + 1 == channels) ? 0 : c + 1;
      }
      *reinterpret_cast<uint4*>(static_cast<int8_t*>(out) + start) = packed;
    } else {
      float4 v[kBytesPerThread / 4];
      float* f = reinterpret_cast<float*>(v);
#pragma unroll
      for (int j = 0; j < kBytesPerThread; ++j) {
        f[j] = normalize(b[j], c, k);
        c = (c + 1 == channels) ? 0 : c + 1;
      }
      float4* dst = reinterpret_cast<float4*>(static_cast<float*>(out) + start);
#pragma unroll
      for (int j = 0; j < kBytesPerThread / 4; ++j) dst[j] = v[j];
    }
    return;
  }
  long long end = start + kBytesPerThread < n ? start + kBytesPerThread : n;
  for (long long i = start; i < end; ++i) {
    float y = normalize(x[i], c, k);
    if (kQuantize) {
      static_cast<int8_t*>(out)[i] = quantize(y, act_scale);
    } else {
      static_cast<float*>(out)[i] = y;
    }
    c = (c + 1 == channels) ? 0 : c + 1;
  }
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns cudaGetLastError() of the
// launch (0 = cudaSuccess).  `mean` and `stdv` are HOST arrays of
// `channels` floats; `vectorized` must be 0 unless `x` and `out` are
// 16-byte aligned.
int dvt_serve_ingest(const void* x, void* out, long long n, int channels,
                     const void* mean, const void* stdv, float act_scale,
                     int quantize, int vectorized, void* stream) {
  if (channels < 1 || channels > kMaxChannels || n < 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (n == 0) return static_cast<int>(cudaSuccess);
  NormConsts k;
  const float* m = static_cast<const float*>(mean);
  const float* s = static_cast<const float*>(stdv);
  for (int c = 0; c < kMaxChannels; ++c) {
    k.mean[c] = c < channels ? m[c] : 0.0f;
    k.stdv[c] = c < channels ? s[c] : 1.0f;
  }
  long long chunks = (n + kBytesPerThread - 1) / kBytesPerThread;
  unsigned int blocks =
      static_cast<unsigned int>((chunks + kThreads - 1) / kThreads);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  if (quantize) {
    serve_ingest_kernel<true><<<blocks, kThreads, 0, st>>>(
        xb, out, n, channels, k, act_scale, vectorized);
  } else {
    serve_ingest_kernel<false><<<blocks, kThreads, 0, st>>>(
        xb, out, n, channels, k, act_scale, vectorized);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
