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
// Design: a uint8 input has 256 values a channel, so the arithmetic
// (three IEEE divisions, rint, clamp: about 35 instructions) runs once
// per table entry, not once per byte.
// 1. Each block builds a C x 256 table of outputs in shared memory (int8
//    bytes, or float32 words) with the very `normalize` / `quantize`
//    helpers below and the constants from its parameter block, so every
//    entry is the value the per-byte arithmetic gives, bit for bit.  A
//    thread's first 16-byte loads start before the build, so their
//    latency hides behind it.
// 2. The grid is kBlocksPerSm blocks per SM, so the table is built some
//    500 times and not once per 4 KB, and each thread walks 16-byte
//    chunks in a grid-stride loop (consecutive threads on consecutive
//    chunks, kUnroll loads in flight): one 16-byte load, one table
//    lookup a byte, and one 16-byte store (four for float32).  The
//    channel of a chunk's first byte is (16 q) % C, so NHWC needs no
//    reshaping.  Bytes past the last whole chunk, or every byte of a
//    misaligned input, take a scalar loop over the same table.
// 3. Lookups are byte-wide and may conflict in a bank.  A copy of the
//    int8 table for each lane (C x 8 KB, lane l reading only bank l)
//    removes the conflicts but measured slower on the H100: building
//    the copies costs more than the conflicts do.
// Mean and std (at most 4 channels) travel by value in the kernel's
// parameter block.  The TPU kernel's (B*H, W*C) row view and 256x128
// padding were VMEM tiling artefacts and are not carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxChannels = 4;
constexpr int kThreads = 256;
constexpr int kUnroll = 2;       // 16-byte chunks a thread loads at once
constexpr int kBlocksPerSm = 4;  // grid size, in blocks per SM

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

template <int C, bool kQuantize>
__global__ void __launch_bounds__(kThreads)
serve_ingest_kernel(const uint8_t* __restrict__ x, void* __restrict__ out,
                    long long n, NormConsts k, float act_scale,
                    int vectorized) {
  constexpr int kEntries = C * 256;
  __shared__ __align__(16) uint8_t s_tab8[kQuantize ? kEntries : 4];
  __shared__ __align__(16) float s_tabf[kQuantize ? 1 : kEntries];

  const long long stride = static_cast<long long>(gridDim.x) * kThreads;
  const long long tid =
      static_cast<long long>(blockIdx.x) * kThreads + threadIdx.x;
  const long long chunks = vectorized ? n / 16 : 0;
  // the first chunks are in flight while the table is built
  uint4 raw[kUnroll];
  long long q0 = tid;
#pragma unroll
  for (int u = 0; u < kUnroll; ++u) {
    const long long q = q0 + u * stride;
    if (q < chunks) raw[u] = reinterpret_cast<const uint4*>(x)[q];
  }

  // a compile-time trip count, so a thread's entries build side by side
#pragma unroll
  for (int t = 0; t < (kEntries + kThreads - 1) / kThreads; ++t) {
    const int e = threadIdx.x + t * kThreads;
    if (e >= kEntries) break;
    const float y = normalize(static_cast<uint8_t>(e & 255), e >> 8, k);
    if (kQuantize) {
      s_tab8[e] = static_cast<uint8_t>(quantize(y, act_scale));
    } else {
      s_tabf[e] = y;
    }
  }
  __syncthreads();

  while (q0 < chunks) {
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q >= chunks) break;
      // the table offset of byte j's channel is base[j % C]
      const int phase = static_cast<int>((q * 16) % C);
      uint32_t base[C];
#pragma unroll
      for (int t = 0; t < C; ++t) {
        const int c = phase + t < C ? phase + t : phase + t - C;
        base[t] = static_cast<uint32_t>(c) * 256u;
      }
      const uint32_t in[4] = {raw[u].x, raw[u].y, raw[u].z, raw[u].w};
      if (kQuantize) {
        uint32_t o[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          o[i] = 0;
#pragma unroll
          for (int b = 0; b < 4; ++b) {
            const uint32_t v = (in[i] >> (8 * b)) & 255u;
            o[i] |= static_cast<uint32_t>(s_tab8[base[(4 * i + b) % C] + v])
                    << (8 * b);
          }
        }
        reinterpret_cast<uint4*>(out)[q] = make_uint4(o[0], o[1], o[2], o[3]);
      } else {
        float f[16];
#pragma unroll
        for (int j = 0; j < 16; ++j) {
          f[j] = s_tabf[base[j % C] + ((in[j / 4] >> (8 * (j % 4))) & 255u)];
        }
        float4* dst = reinterpret_cast<float4*>(out) + q * 4;
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          dst[i] = make_float4(f[4 * i], f[4 * i + 1], f[4 * i + 2],
                               f[4 * i + 3]);
        }
      }
    }
    q0 += stride * kUnroll;
#pragma unroll
    for (int u = 0; u < kUnroll; ++u) {
      const long long q = q0 + u * stride;
      if (q < chunks) raw[u] = reinterpret_cast<const uint4*>(x)[q];
    }
  }
  for (long long i = chunks * 16 + tid; i < n; i += stride) {
    const uint32_t e = static_cast<uint32_t>(i % C) * 256u + x[i];
    if (kQuantize) {
      static_cast<uint8_t*>(out)[i] = s_tab8[e];
    } else {
      static_cast<float*>(out)[i] = s_tabf[e];
    }
  }
}

template <int C>
void launch(const uint8_t* x, void* out, long long n, const NormConsts& k,
            float act_scale, int quantize, int vectorized,
            unsigned int blocks, cudaStream_t st) {
  if (quantize) {
    serve_ingest_kernel<C, true><<<blocks, kThreads, 0, st>>>(
        x, out, n, k, act_scale, vectorized);
  } else {
    serve_ingest_kernel<C, false><<<blocks, kThreads, 0, st>>>(
        x, out, n, k, act_scale, vectorized);
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
  int device = 0, sms = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess) {
    err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, device);
  }
  if (err != cudaSuccess) return static_cast<int>(err);
  const long long items = vectorized ? (n + 15) / 16 : n;
  const long long wanted = (items + kThreads - 1) / kThreads;
  const long long most = static_cast<long long>(sms) * kBlocksPerSm;
  const unsigned int blocks =
      static_cast<unsigned int>(wanted < most ? wanted : most);
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  const uint8_t* xb = static_cast<const uint8_t*>(x);
  switch (channels) {
    case 1:
      launch<1>(xb, out, n, k, act_scale, quantize, vectorized, blocks, st);
      break;
    case 2:
      launch<2>(xb, out, n, k, act_scale, quantize, vectorized, blocks, st);
      break;
    case 3:
      launch<3>(xb, out, n, k, act_scale, quantize, vectorized, blocks, st);
      break;
    default:
      launch<4>(xb, out, n, k, act_scale, quantize, vectorized, blocks, st);
      break;
  }
  return static_cast<int>(cudaGetLastError());
}

const char* dvt_cuda_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
