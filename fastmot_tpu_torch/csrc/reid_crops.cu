// The ReID network's input in one launch for Hopper (sm_90a): every box's
// crop of its stream's frame, resized to OSNet's input with half-pixel
// centres, flipped from BGR to RGB and normalised with ImageNet's mean
// and std, written as the [N, oh, ow, 3] float32 tensor OSNet's stem
// reads.
//
// Replaces fastmot_tpu/feature_extractor.py:34-93 crop_resize_batch (two
// bf16 matrix products with float32 sums whose weight matrices hold at
// most two non-zero hat weights a row) and the lines of _extract_core
// (:96-102) before the network: the BGR flip, /255 and the mean and std.
// Neither is a Pallas kernel: both are part of the JAX package's jitted
// extraction program. The plain PyTorch twin is reid_crops_reference in
// fastmot_tpu_torch/ops/reid_crops.py (crop_resize_batch, then the
// normalisation); the wrapper reid_crops there checks the arguments,
// allocates the output and calls the C entry below.
//
// What bounds it on an H100: bytes. It writes oh x ow x 3 floats a crop
// (393 KB at 256 x 128; 25 MB for the main path's 64 crops) and reads
// four taps a pixel of a uint8 frame. So a block is one output row of one
// crop and a thread one pixel (all three channels), each thread's 12
// bytes beside its neighbours', and the taps come through L1 and L2.
//
// Rounding, the plain version's step by step (the build takes
// -fmad=false, so no product is fused into a sum):
//   boxes floored and clamped at 0; w = x2 - x1 + 1 (from the floored
//   corners); us = (j + 0.5) * (1 / ow); xs = clamp(x0 + us * w - 0.5, 0,
//   W - 1); i0 = floor(xs), frac = xs - i0, i1 = min(i0 + 1, W - 1); the
//   weights 1 - frac and frac rounded to bf16 (to nearest, ties to even);
//   the frame's values rounded to bf16 (exact for uint8); a column pass
//   wx0 * a + wx1 * b, rounded to bf16, at the two source rows; the row
//   pass wy0 * t0 + wy1 * t1 in float32; then x * (1 / 255) (torch's CUDA
//   division by a Python scalar, a multiply by the float32 reciprocal),
//   minus the channel's mean, over its std.
// So the output is the plain version's bit for bit, on the card and in
// the tests' host build.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr unsigned kBf16NaN = 0x7FC00000u;   // torch's bf16 NaN, widened

// reid_crops_forward's pointers and ints
enum CropPtr { kFrames, kBoxes, kOut };
enum CropInt { kStreams, kBoxesA, kHeight, kWidth, kOutH, kOutW, kFloatFrame };
enum CropFloat { kInvOutW, kInvOutH };

struct CropParams {
  const void* frames;      // [S, H, W, 3] uint8 or float32
  const float* boxes;      // [S, D, 4] tlbr
  float* out;              // [S * D, oh, ow, 3]
  int streams, boxes_a_stream, height, width, out_h, out_w;
  int float_frame;         // 0: uint8 frames, 1: float32
  float inv_out_w, inv_out_h;
};

// ImageNet's mean and std of RGB channel c in float32, and 1 / 255
__device__ __forceinline__ float mean_of(int c) {
  return c == 0 ? 0.485f : (c == 1 ? 0.456f : 0.406f);
}
__device__ __forceinline__ float std_of(int c) {
  return c == 0 ? 0.229f : (c == 1 ? 0.224f : 0.225f);
}
constexpr float kInv255 = 1.0f / 255.0f;

// float32 -> bf16 -> float32, to nearest with ties to even (torch's
// conversion; NaN to its canonical bf16 NaN)
__device__ __forceinline__ float round_bf16(float x) {
  const unsigned u = __float_as_uint(x);
  if ((u & 0x7FFFFFFFu) > 0x7F800000u) return __uint_as_float(kBf16NaN);
  return __uint_as_float((u + 0x7FFFu + ((u >> 16) & 1u)) & 0xFFFF0000u);
}

// the two taps of a clamped source position and their bf16 weights
struct Taps {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Taps taps(float pos, int n_in) {
  const float f0 = floorf(pos);
  const float frac = pos - f0;
  Taps t;
  // pos lies in [0, n_in - 1]; the clamp keeps a NaN box's reads inside
  // the frame
  const int i0 = static_cast<int>(f0);
  t.i0 = i0 < 0 ? 0 : (i0 > n_in - 1 ? n_in - 1 : i0);
  t.i1 = t.i0 + 1 < n_in - 1 ? t.i0 + 1 : n_in - 1;
  t.w0 = round_bf16(1.0f - frac);
  t.w1 = round_bf16(frac);
  return t;
}

// a source position: clamp(start + u * size - 0.5, 0, n_in - 1)
__device__ __forceinline__ float source_pos(float start, float size,
                                            int k, float inv_out, int n_in) {
  const float u = (static_cast<float>(k) + 0.5f) * inv_out;
  float p = start + u * size;
  p = p - 0.5f;
  const float hi = static_cast<float>(n_in - 1);
  return p < 0.0f ? 0.0f : (p > hi ? hi : p);
}

__device__ __forceinline__ float pixel(const CropParams& p, size_t at) {
  if (p.float_frame)
    return round_bf16(static_cast<const float*>(p.frames)[at]);
  return static_cast<float>(static_cast<const unsigned char*>(p.frames)[at]);
}

// a block an output row (blockIdx.x) of a crop (blockIdx.y), a thread a
// pixel of the row
__global__ void __launch_bounds__(kThreads)
reid_crops_kernel(const CropParams p) {
  const int row = blockIdx.x, n = blockIdx.y;
  const int s = n / p.boxes_a_stream;
  const float* box = p.boxes + static_cast<size_t>(n) * 4;
  // floor, then clamp at 0 (a NaN corner stays NaN, as torch's clamp)
  float b[4];
  for (int k = 0; k < 4; ++k) {
    const float f = floorf(box[k]);
    b[k] = f < 0.0f ? 0.0f : f;
  }
  const float w = b[2] - b[0] + 1.0f;
  const float h = b[3] - b[1] + 1.0f;
  const Taps ty = taps(source_pos(b[1], h, row, p.inv_out_h, p.height),
                       p.height);
  const size_t frame = static_cast<size_t>(s) * p.height * p.width;
  const size_t r0 = (frame + static_cast<size_t>(ty.i0) * p.width) * 3;
  const size_t r1 = (frame + static_cast<size_t>(ty.i1) * p.width) * 3;
  float* out = p.out + ((static_cast<size_t>(n) * p.out_h + row)
                        * p.out_w) * 3;
  for (int j = threadIdx.x; j < p.out_w; j += blockDim.x) {
    const Taps tx = taps(source_pos(b[0], w, j, p.inv_out_w, p.width),
                         p.width);
    const size_t c0 = static_cast<size_t>(tx.i0) * 3;
    const size_t c1 = static_cast<size_t>(tx.i1) * 3;
    float v[3];
    for (int c = 0; c < 3; ++c) {
      float a = tx.w0 * pixel(p, r0 + c0 + c);
      float t0 = a + tx.w1 * pixel(p, r0 + c1 + c);
      a = tx.w0 * pixel(p, r1 + c0 + c);
      float t1 = a + tx.w1 * pixel(p, r1 + c1 + c);
      t0 = round_bf16(t0);
      t1 = round_bf16(t1);
      const float lo = ty.w0 * t0;
      v[c] = lo + ty.w1 * t1;
    }
    // BGR -> RGB, then (x / 255 - mean) / std
    for (int c = 0; c < 3; ++c) {
      const float x = v[2 - c] * kInv255;
      out[3 * j + c] = (x - mean_of(c)) / std_of(c);
    }
  }
}

}  // namespace

extern "C" {

// One call: ints[kStreams] streams of ints[kBoxesA] boxes, frames of
// ints[kHeight] x ints[kWidth], crops of ints[kOutH] x ints[kOutW];
// `ptrs` holds the CropPtr enum's pointers, floats the reciprocals of the
// output's width and height. One launch on `stream`. Returns 0 or the
// first cudaError_t.
int reid_crops_forward(const void* const* ptrs, const int* ints,
                       const float* floats, void* stream) {
  CropParams p = {};
  p.streams = ints[kStreams];
  p.boxes_a_stream = ints[kBoxesA];
  p.height = ints[kHeight];
  p.width = ints[kWidth];
  p.out_h = ints[kOutH];
  p.out_w = ints[kOutW];
  p.float_frame = ints[kFloatFrame];
  p.inv_out_w = floats[kInvOutW];
  p.inv_out_h = floats[kInvOutH];
  const long long crops = static_cast<long long>(p.streams)
      * p.boxes_a_stream;
  if (p.streams < 1 || p.boxes_a_stream < 1 || crops > 65535
      || p.height < 1 || p.width < 1 || p.out_h < 1 || p.out_h > 65535
      || p.out_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k <= kOut; ++k)
    if (!ptrs[k]) return static_cast<int>(cudaErrorInvalidValue);
  p.frames = ptrs[kFrames];
  p.boxes = static_cast<const float*>(ptrs[kBoxes]);
  p.out = static_cast<float*>(const_cast<void*>(ptrs[kOut]));
  const dim3 grid(p.out_h, static_cast<unsigned>(crops));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  reid_crops_kernel<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code the entry returned
const char* reid_crops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
