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
// factors per image) and writes each float32 output once: at B=128,
// 299x299x3 that is 34.3 MB in and 137.3 MB out, 51.2 us at 3.35 TB/s.
// It does about 15 float32 operations per output element, 6.8 us at the
// 67 TFLOP/s float32 peak, so bytes bound it.
//
// Design: the batch is one flat run of B*H*W pixels, cut into tiles of
// kTilePixels that ignore image boundaries, so no image has a ragged last
// block, an image size that is no multiple of 16 bytes (299x299x3) is no
// special case, and the batch has no grid limit (64-bit offsets).  A
// block loads a tile into shared memory with coalesced 16-byte loads, a
// thread turns groups of 4 pixels (12 bytes) into 12 floats in shared
// memory, and the block stores the tile with coalesced 16-byte stores;
// eight blocks of 256 threads an SM (at most 32 registers a thread) keep
// enough loads and stores in flight.  Saturation mixes a pixel's three
// channels, so a thread computes whole pixels and gray is a per-pixel
// sum in registers.  A pixel's image is q / (H*W), a 64-bit multiply-high
// and shift by a magic the wrapper computes (ops/train_ingest.py
// division_magic).  When images hold at least a tile (every training
// shape), a tile lies in at most two images, and a channel's first stage
// (u / 255, brightness, contrast) depends only on its byte and its image:
// the block tabulates it for both images with the same operations, so a
// pixel looks its three channels up instead of dividing three times.
// Smaller images of 16 pixels on compute each group directly (a group
// spans at most two images); the batch's ragged tail, and the whole batch
// when a base pointer is not 16-byte aligned (a view such as x[1:]) or
// images hold fewer than 16 pixels, take a per-pixel loop in the same
// kernel.  The two cases are two instantiations (kTable), so the main
// path's registers are its own: only it is held to 32 registers for
// eight blocks an SM (the other would spill under that cap).
//
// A persistent grid that moved the tiles through a shared-memory ring of
// 1-D bulk asynchronous copies (cp.async.bulk on mbarriers, bulk stores)
// ran 5-9% slower than this design on the H100 at 224^2 and 299^2, with
// tiles of 512 to 2048 pixels and 2 to 4 stages (PERF.md), so it is not
// kept.
//
// The TPU kernel's (B*H, W*C) row view, 256-row tiles, 128-lane padding
// and block-diagonal gray matmul were Mosaic/VMEM workarounds and are not
// carried over.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kChannels = 3;
constexpr int kThreads = 256;
// the main path's blocks an SM: 8 of 256 threads need at most 32
// registers a thread
constexpr int kMinBlocks = 8;
constexpr int kTilePixels = 1024;
// pixels a thread computes at once: 3 words of shared memory in, 3 float4
// out
constexpr int kGroupPixels = 4;
// the least image size of the tiled path: a group spans at most two images
constexpr int kMinTiledImage = 16;
constexpr int kTileInBytes = kTilePixels * kChannels;
constexpr int kTileOutBytes = kTilePixels * kChannels * 4;

static_assert(kTilePixels % (kGroupPixels * kThreads) == 0,
              "a tile is whole rounds of groups");
static_assert(kTileInBytes % 16 == 0, "tiles are whole 16-byte words");

struct Params {
  const uint8_t* x;
  const float4* factors;  // (batch, 4): [fb, fc, fs, m]
  float* out;
  long long batch, pixels, total, tiles;
  unsigned long long magic;  // image of q: umulhi(q, magic) >> shift
  int shift;
  unsigned int tail_block;  // the block of the tail's first pixels
  float mean[kChannels];
  float stdv[kChannels];
};

__device__ __forceinline__ long long image_of(long long q, const Params& p) {
  return p.pixels == 1
             ? q
             : static_cast<long long>(
                   __umul64hi(static_cast<unsigned long long>(q), p.magic) >>
                   p.shift);
}

__device__ __forceinline__ float clamp01(float v) {
  // torch.clamp propagates NaN; so does this
  return isnan(v) ? v : fminf(fmaxf(v, 0.0f), 1.0f);
}

// A channel's first stage: brightness and contrast of u / 255.
__device__ __forceinline__ float first_stage(uint32_t u, const float4& f) {
  float v = __fdiv_rn(static_cast<float>(u), 255.0f);
  v = __fmul_rn(v, f.x);
  return __fadd_rn(__fmul_rn(__fsub_rn(v, f.w), f.y), f.w);
}

// A pixel's second stage: saturation toward its gray, clip, normalize.
__device__ __forceinline__ void second_stage(const float* x, float fs,
                                             const Params& k, float* o) {
  float gray = __fadd_rn(__fadd_rn(__fmul_rn(x[0], 0.299f),
                                   __fmul_rn(x[1], 0.587f)),
                         __fmul_rn(x[2], 0.114f));
#pragma unroll
  for (int c = 0; c < kChannels; ++c) {
    float v = __fadd_rn(gray, __fmul_rn(__fsub_rn(x[c], gray), fs));
    v = clamp01(v);
    o[c] = __fdiv_rn(__fsub_rn(v, k.mean[c]), k.stdv[c]);
  }
}

// One pixel: three uint8 channels in, three float32 outputs.
__device__ __forceinline__ void jitter_pixel(const uint8_t* u, float* o,
                                             const float4& f,
                                             const Params& k) {
  float x[kChannels];
#pragma unroll
  for (int c = 0; c < kChannels; ++c) x[c] = first_stage(u[c], f);
  second_stage(x, f.z, k, o);
}

// The factors of the pixels from q on while they lie in at most two
// images: those of q's image, those of the next, and where it starts.
struct Run {
  float4 f0, f1;
  long long next;
};

__device__ __forceinline__ Run run_at(const Params& p, long long q) {
  const long long img = image_of(q, p);
  Run r;
  r.next = (img + 1) * p.pixels;
  r.f0 = __ldg(p.factors + img);
  r.f1 = img + 1 < p.batch ? __ldg(p.factors + img + 1) : r.f0;
  return r;
}

// When images are at least a tile long (kTable), a tile lies in at most
// two, and a channel's first stage depends only on its byte and its
// image: the block tabulates it for both images (the same operations, so
// the same bits) and a pixel looks its channels up.  `tab` is 2 x 256
// floats.
__device__ __forceinline__ void build_table(const Run& r, float* tab) {
  for (int e = threadIdx.x; e < 512; e += kThreads) {
    tab[e] = first_stage(e & 255, e < 256 ? r.f0 : r.f1);
  }
}

// The group of pixels from pixel g of tile `tile` on: bytes from shared
// memory at `in`, floats to shared memory at `o`.
template <bool kTable>
__device__ __forceinline__ void jitter_group(const Params& p, long long tile,
                                             int g, const Run& tile_run,
                                             const float* tab,
                                             const uint8_t* in, float* o) {
  const long long q = tile * kTilePixels + g;
  uint32_t words[kGroupPixels * kChannels / 4];
#pragma unroll
  for (int j = 0; j < kGroupPixels * kChannels / 4; ++j) {
    words[j] = reinterpret_cast<const uint32_t*>(in + g * kChannels)[j];
  }
  const uint8_t* b = reinterpret_cast<const uint8_t*>(words);
  float v[kGroupPixels * kChannels];
  if (kTable) {
    // pixels of the group before the next image starts
    const long long ahead = tile_run.next - q;
    const int split = ahead <= 0 ? 0
                      : ahead >= kGroupPixels ? kGroupPixels
                                              : static_cast<int>(ahead);
#pragma unroll
    for (int i = 0; i < kGroupPixels; ++i) {
      const bool second = i >= split;
      const float* t = tab + (second ? 256 : 0);
      float x[kChannels];
#pragma unroll
      for (int c = 0; c < kChannels; ++c) x[c] = t[b[i * kChannels + c]];
      second_stage(x, second ? tile_run.f1.z : tile_run.f0.z, p,
                   v + i * kChannels);
    }
  } else {
    const Run r = run_at(p, q);
#pragma unroll
    for (int i = 0; i < kGroupPixels; ++i) {
      jitter_pixel(b + i * kChannels, v + i * kChannels,
                   q + i < r.next ? r.f0 : r.f1, p);
    }
  }
#pragma unroll
  for (int j = 0; j < kGroupPixels * kChannels / 4; ++j) {
    reinterpret_cast<float4*>(o + g * kChannels)[j] =
        make_float4(v[4 * j], v[4 * j + 1], v[4 * j + 2], v[4 * j + 3]);
  }
}

// A whole tile: bytes in shared memory at `in`, floats to `o`.
template <bool kTable>
__device__ __forceinline__ void jitter_tile(const Params& p, long long tile,
                                            const Run& tile_run,
                                            const float* tab,
                                            const uint8_t* in, float* o) {
#pragma unroll
  for (int r = 0; r < kTilePixels / (kGroupPixels * kThreads); ++r) {
    jitter_group<kTable>(p, tile,
                         (r * kThreads + threadIdx.x) * kGroupPixels,
                         tile_run, tab, in, o);
  }
}

// kTable: the tiled path with images of at least a tile (the first stage
// looked up), held to kMinBlocks blocks an SM; otherwise images of 16
// pixels on, or none tiled, with the registers they need.
template <bool kTable>
__global__ void __launch_bounds__(kThreads, kTable ? kMinBlocks : 1)
    train_ingest_kernel(const Params p) {
  __shared__ uint4 in_tile[kTileInBytes / 16];
  __shared__ float4 out_tile[kTileOutBytes / 16];
  __shared__ float tab[512];
  const int t = threadIdx.x;
  // the tiles, grid-stride (a block a tile as launched), each read into
  // shared memory with coalesced 16-byte loads and written out with
  // coalesced 16-byte stores
  for (long long tile = blockIdx.x; tile < p.tiles; tile += gridDim.x) {
    const uint4* src =
        reinterpret_cast<const uint4*>(p.x + tile * kTileInBytes);
    for (int j = t; j < kTileInBytes / 16; j += kThreads) {
      in_tile[j] = __ldg(src + j);
    }
    const Run run = run_at(p, tile * kTilePixels);
    if (kTable) build_table(run, tab);
    __syncthreads();
    jitter_tile<kTable>(p, tile, run, tab,
                        reinterpret_cast<const uint8_t*>(in_tile),
                        reinterpret_cast<float*>(out_tile));
    __syncthreads();
    float4* dst = reinterpret_cast<float4*>(p.out + tile * (kTileOutBytes / 4));
    for (int j = t; j < kTileOutBytes / 16; j += kThreads) {
      dst[j] = out_tile[j];
    }
  }
  // per pixel: the tail past the last whole tile (the whole batch when
  // the tiled path is off), a thread a pixel from the first block past
  // the tiles on, so that the tail does not wait behind a tile
  const unsigned int chunk = blockIdx.x >= p.tail_block
                                 ? blockIdx.x - p.tail_block
                                 : blockIdx.x + gridDim.x - p.tail_block;
  for (long long q = p.tiles * kTilePixels +
                     static_cast<long long>(chunk) * kThreads + t;
       q < p.total; q += static_cast<long long>(gridDim.x) * kThreads) {
    const uint8_t* u = p.x + q * kChannels;
    const uint8_t b[kChannels] = {u[0], u[1], u[2]};
    jitter_pixel(b, p.out + q * kChannels, __ldg(p.factors + image_of(q, p)),
                 p);
  }
}

template <bool kTable>
cudaError_t launch(Params p, cudaStream_t stream) {
  // a block a tile, then a thread a pixel of the tail; the loops stride
  // past the grid's 2^31 - 1 blocks
  const long long tail = p.total - p.tiles * kTilePixels;
  const long long work = p.tiles + (tail + kThreads - 1) / kThreads;
  const long long blocks = work < 0x7FFFFFFF ? work : 0x7FFFFFFF;
  p.tail_block = static_cast<unsigned int>(p.tiles % blocks);
  train_ingest_kernel<kTable>
      <<<static_cast<unsigned int>(blocks), kThreads, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// Launches the kernel on `stream` and returns a cudaError_t (0 =
// cudaSuccess).  `x` is (batch, pixels, 3) uint8, `factors` (batch, 4)
// float32 at a 16-byte-aligned address and `out` (batch, pixels, 3)
// float32, all on the device and contiguous; `mean` and `stdv` are HOST
// arrays of 3 floats.  `tiled` may be 1 only if `x` and `out` are 16-byte
// aligned and pixels >= 16; `magic` and `shift` make umulhi(q, magic) >>
// shift equal q / pixels for every q < batch * pixels (ignored when
// pixels is 1).
int dvt_train_ingest(const void* x, const void* factors, void* out,
                     long long batch, long long pixels, const void* mean,
                     const void* stdv, int tiled, unsigned long long magic,
                     int shift, void* stream) {
  if (batch < 0 || pixels < 0 || shift < 0 || shift > 63 ||
      reinterpret_cast<uintptr_t>(factors) % 16 != 0) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  if (batch == 0 || pixels == 0) return static_cast<int>(cudaSuccess);
  if (pixels > (1LL << 60) / batch ||
      (tiled && (pixels < kMinTiledImage ||
                 reinterpret_cast<uintptr_t>(x) % 16 != 0 ||
                 reinterpret_cast<uintptr_t>(out) % 16 != 0))) {
    return static_cast<int>(cudaErrorInvalidValue);
  }
  Params p;
  p.x = static_cast<const uint8_t*>(x);
  p.factors = static_cast<const float4*>(factors);
  p.out = static_cast<float*>(out);
  p.batch = batch;
  p.pixels = pixels;
  p.total = batch * pixels;
  p.tiles = tiled ? p.total / kTilePixels : 0;
  p.magic = magic;
  p.shift = shift;
  const float* m = static_cast<const float*>(mean);
  const float* s = static_cast<const float*>(stdv);
  for (int c = 0; c < kChannels; ++c) {
    p.mean[c] = m[c];
    p.stdv[c] = s[c];
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  return static_cast<int>(p.tiles > 0 && pixels >= kTilePixels
                              ? launch<true>(p, st)
                              : launch<false>(p, st));
}

const char* dvt_train_ingest_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
