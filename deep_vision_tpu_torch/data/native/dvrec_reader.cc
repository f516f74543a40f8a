// The native half of the raw-dvrec read path: one call assembles a whole
// training batch, with positioned reads straight from the shard files and
// the crop and horizontal flip fused into the copy into the caller's
// preallocated (B, S, S, 3) uint8 buffer.  No decode (payloads are raw
// uint8 from `prepare_data --store raw`), no per-image Python, no
// intermediate copy.
//
// Host C++, built by data/native/__init__.py with the machine's C++
// compiler into deep_vision_tpu_torch/_build/ and loaded with ctypes.

#include <cstdint>
#include <cstring>

#include <unistd.h>

extern "C" {

// Assemble one batch of crops from raw-uint8 dvrec payloads.
//   fds:        per-item open file descriptors (shard files)
//   offsets:    per-item payload byte offsets
//   heights/widths: per-item stored image dims (channels fixed at 3)
//   tops/lefts: per-item crop origin (in the flipped image when flip=1)
//   flips:      per-item horizontal-flip flag
//   crop:       output square side S
//   out:        (n, S, S, 3) uint8, C-contiguous
//   scratch:    caller-provided buffer of at least max_payload bytes
// Returns 0 on success, -(i+1) if the read for item i failed or came
// back short (a truncated shard).
int dvrec_assemble_batch(const int32_t* fds, const int64_t* offsets,
                         const int32_t* heights, const int32_t* widths,
                         const int32_t* tops, const int32_t* lefts,
                         const uint8_t* flips, int32_t n, int32_t crop,
                         uint8_t* out, uint8_t* scratch) {
  const int64_t row_out = static_cast<int64_t>(crop) * 3;
  for (int32_t i = 0; i < n; ++i) {
    const int64_t h = heights[i], w = widths[i];
    const int64_t payload = h * w * 3;
    int64_t done = 0;
    while (done < payload) {
      ssize_t got = pread(fds[i], scratch + done, payload - done,
                          offsets[i] + done);
      if (got <= 0) return -(i + 1);
      done += got;
    }
    uint8_t* dst = out + static_cast<int64_t>(i) * crop * row_out;
    const int64_t top = tops[i], left = lefts[i];
    if (!flips[i]) {
      for (int64_t r = 0; r < crop; ++r) {
        const uint8_t* src = scratch + ((top + r) * w + left) * 3;
        memcpy(dst + r * row_out, src, row_out);
      }
    } else {
      // crop coordinates address the FLIPPED image (as
      // transforms.train_transform_u8: flip, then crop): flipped column
      // left+c is stored column w-1-(left+c)
      for (int64_t r = 0; r < crop; ++r) {
        const uint8_t* src_row = scratch + (top + r) * w * 3;
        uint8_t* dst_row = dst + r * row_out;
        for (int64_t c = 0; c < crop; ++c) {
          const uint8_t* px = src_row + (w - 1 - left - c) * 3;
          dst_row[c * 3 + 0] = px[0];
          dst_row[c * 3 + 1] = px[1];
          dst_row[c * 3 + 2] = px[2];
        }
      }
    }
  }
  return 0;
}

}  // extern "C"
