// The ReID network's input in one launch for Hopper (sm_90a): every box's
// crop of its stream's frame, resized to OSNet's input with half-pixel
// centres, flipped from BGR to RGB and normalised with ImageNet's mean
// and std, written as the [N, oh, ow, 3] tensor OSNet's stem reads: float32,
// or rounded to bf16 where the stem rounds its input to bf16 at once.
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
// What bounds it on an H100: bytes. It writes oh x ow x 3 values a crop
// (393 KB of float32 at 256 x 128; 25 MB for the main path's 64 crops, half
// that in bf16) and reads four taps a pixel of a uint8 frame. Its time,
// though, goes to instructions: some 40 a value, and at 64 crops, a wave
// or two of blocks, to each block's chain of them. So a block is a band of
// output rows of one crop (8, or 16 where the call has many output rows:
// the wrapper picks it, ops/reid_crops.py band_rows, as measured on an
// H100, 8 faster at 64 crops of 256 rows, 16 at 1,024): it floors the box
// once,
// computes the crop's column taps once into shared memory and each row's
// taps once, and, where the band's source rows fit (at most twice the
// band's rows, as a box no taller than twice the output gives), runs the
// column pass once a source row and output column into shared memory in
// bf16, from which each output row's row pass reads its two rows: the main
// path's people, 160 to 240 pixels tall, need 7 to 10 source rows for 8
// output rows, some half the column passes of one a pixel. A taller band
// runs the column pass a pixel, from the frame through L1. A thread takes
// 4 neighbouring pixels of a row, 12 values written as three 16-byte
// stores (three 8-byte stores in bf16) where the row allows it, singly at
// a ragged end or an unaligned row.
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
//   minus the channel's mean, over its std (an IEEE division); in bf16 the
//   result rounded to nearest, ties to even (torch's .to(torch.bfloat16);
//   a NaN, which only a NaN box makes, takes the card's bits or the
//   host's, as torch's conversion does on each).
// So the output is the plain version's bit for bit, on the card and in
// the tests' host build.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 128;
constexpr int kMaxBandRows = 16;  // output rows a block: 8 or this
constexpr int kPixels = 4;        // neighbouring pixels a thread
constexpr int kMaxOutW = 8192;    // the column taps' table in shared memory
// a band's column pass, kept in shared memory as bf16 where its source
// rows fit: at most twice the band's rows, kPassBytes in all
constexpr int kPassBytes = 24576;
constexpr unsigned kBf16NaN = 0x7FC00000u;   // torch's bf16 NaN, widened

// reid_crops_forward's pointers and ints
enum CropPtr { kFrames, kBoxes, kOut };
enum CropInt {
  kStreams, kBoxesA, kHeight, kWidth, kOutH, kOutW, kFloatFrame, kBf16Out,
  kBand
};
enum CropFloat { kInvOutW, kInvOutH };

struct CropParams {
  const void* frames;      // [S, H, W, 3] uint8 or float32
  const float* boxes;      // [S, D, 4] tlbr
  void* out;               // [S * D, oh, ow, 3] float32 or bf16
  int streams, boxes_a_stream, height, width, out_h, out_w;
  int float_frame;         // 0: uint8 frames, 1: float32
  int bf16_out;            // 0: float32 output, 1: bf16
  int band_rows;           // output rows a block, 8 or 16
  int span_cap;            // source rows the column pass keeps
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

// the bf16 bits of x to nearest with ties to even: the card's conversion
// instruction (the same bits but for a NaN's, which only a NaN box makes:
// its values are NaN whatever their bits)
__device__ __forceinline__ unsigned short bf16_bits(float x) {
#if defined(__CUDA_ARCH__)
  unsigned short b;
  asm("cvt.rn.bf16.f32 %0, %1;" : "=h"(b) : "f"(x));
  return b;
#else
  return static_cast<unsigned short>(__float_as_uint(round_bf16(x)) >> 16);
#endif
}

__device__ __forceinline__ float bf16_float(unsigned short b) {
  return __uint_as_float(static_cast<unsigned>(b) << 16);
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
  // pos lies in [0, n_in - 1]; a NaN box's taps are 0 (its values NaN)
  const int i0 = f0 == f0 ? static_cast<int>(f0) : 0;
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

// a source row's values, each rounded to bf16 (exact for uint8)
__device__ __forceinline__ float frame_value(const CropParams& p, size_t at) {
  if (p.float_frame)
    return round_bf16(static_cast<const float*>(p.frames)[at]);
  return static_cast<float>(static_cast<const unsigned char*>(p.frames)[at]);
}

// the column pass of source row `row` (a frame element offset) at the
// taps `tx`: channel c (BGR) rounded to bf16
__device__ __forceinline__ float column_pass(const CropParams& p, size_t row,
                                             const Taps& tx, int c) {
  const size_t c0 = static_cast<size_t>(tx.i0) * 3 + c;
  const size_t c1 = static_cast<size_t>(tx.i1) * 3 + c;
  const float a = tx.w0 * frame_value(p, row + c0);
  return a + tx.w1 * frame_value(p, row + c1);
}

// the row pass, BGR -> RGB and (x / 255 - mean) / std of one pixel from
// its two column-pass values v0, v1 a channel (BGR)
__device__ __forceinline__ void row_pass(const Taps& ty, const float (&v0)[3],
                                         const float (&v1)[3], float* o) {
  float v[3];
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float lo = ty.w0 * v0[c];
    v[c] = lo + ty.w1 * v1[c];
  }
#pragma unroll
  for (int c = 0; c < 3; ++c) {
    const float x = v[2 - c] * kInv255;
    o[c] = (x - mean_of(c)) / std_of(c);
  }
}

// two values' bf16 bits, lo in the low half: the card's conversion
// instruction, whose NaN is torch's CUDA conversion's (0x7FFF; the host
// build's, torch's CPU one, 0x7FC0)
__device__ __forceinline__ unsigned bf16_pair(float lo, float hi) {
#if defined(__CUDA_ARCH__)
  unsigned b;
  asm("cvt.rn.bf16x2.f32 %0, %1, %2;" : "=r"(b) : "f"(hi), "f"(lo));
  return b;
#else
  return (__float_as_uint(round_bf16(lo)) >> 16)
         | (__float_as_uint(round_bf16(hi)) & 0xFFFF0000u);
#endif
}

// the 3 * npix values o of pixels j0 .. of an output row, at element `at`
__device__ __forceinline__ void store_pixels(const CropParams& p, size_t at,
                                             int npix,
                                             const float (&o)[3 * kPixels]) {
  if (p.bf16_out) {
    unsigned short* dst = static_cast<unsigned short*>(p.out) + at;
    if (npix == kPixels && (reinterpret_cast<uintptr_t>(dst) & 7u) == 0) {
      uint2* d2 = reinterpret_cast<uint2*>(dst);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        d2[k] = make_uint2(bf16_pair(o[4 * k], o[4 * k + 1]),
                           bf16_pair(o[4 * k + 2], o[4 * k + 3]));
    } else {
#pragma unroll
      for (int k = 0; k < 3 * kPixels; ++k)
        if (k < 3 * npix) dst[k] = bf16_bits(o[k]);
    }
  } else {
    float* dst = static_cast<float*>(p.out) + at;
    if (npix == kPixels && (reinterpret_cast<uintptr_t>(dst) & 15u) == 0) {
      float4* d4 = reinterpret_cast<float4*>(dst);
#pragma unroll
      for (int k = 0; k < 3; ++k)
        d4[k] = make_float4(o[4 * k], o[4 * k + 1], o[4 * k + 2],
                            o[4 * k + 3]);
    } else {
#pragma unroll
      for (int k = 0; k < 3 * kPixels; ++k)
        if (k < 3 * npix) dst[k] = o[k];
    }
  }
}

// a block a band of band_rows output rows (blockIdx.x) of a crop
// (blockIdx.y); dynamic shared memory: the column taps [ow], the band's
// row taps, then the band's column pass [span][ow][3] in bf16
__global__ void __launch_bounds__(kThreads)
reid_crops_kernel(const CropParams p) {
  extern __shared__ float4 smem_v[];
  Taps* col = reinterpret_cast<Taps*>(smem_v);
  Taps* row_taps = col + p.out_w;
  unsigned short* pass = reinterpret_cast<unsigned short*>(row_taps
                                                           + p.band_rows);
  const int tid = threadIdx.x, nt = blockDim.x;
  const int band = p.band_rows;
  const int n = blockIdx.y, row0 = blockIdx.x * band;
  const int ow = p.out_w, W = p.width, H = p.height;
  const int rows = p.out_h - row0 < band ? p.out_h - row0 : band;
  const int s = n / p.boxes_a_stream;
  const float* box = p.boxes + static_cast<size_t>(n) * 4;
  // floor, then clamp at 0 (a NaN corner stays NaN, as torch's clamp)
  float b[4];
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    const float f = floorf(box[k]);
    b[k] = f < 0.0f ? 0.0f : f;
  }
  const float w = b[2] - b[0] + 1.0f;
  const float h = b[3] - b[1] + 1.0f;
  for (int j = tid; j < ow; j += nt)
    col[j] = taps(source_pos(b[0], w, j, p.inv_out_w, W), W);
  for (int r = tid; r < rows; r += nt)
    row_taps[r] = taps(source_pos(b[1], h, row0 + r, p.inv_out_h, H), H);
  // the band's source rows: the taps are monotone in the output row, so
  // its ends bound them
  const Taps rf = taps(source_pos(b[1], h, row0, p.inv_out_h, H), H);
  const Taps rl = taps(source_pos(b[1], h, row0 + rows - 1, p.inv_out_h,
                                  H), H);
  const int r_lo = rf.i0 < rl.i0 ? rf.i0 : rl.i0;
  const int span = (rf.i1 > rl.i1 ? rf.i1 : rl.i1) - r_lo + 1;
  const bool keep = span <= p.span_cap;
  const size_t frame = static_cast<size_t>(s) * H * W * 3;
  const int groups = (ow + kPixels - 1) / kPixels;
  __syncthreads();
  if (keep) {
    // the column pass once a source row and column, then the row pass
    for (int it = tid; it < span * groups; it += nt) {
      const int sr = it / groups, g = it - sr * groups;
      const size_t row = frame + static_cast<size_t>(r_lo + sr) * W * 3;
      const int j0 = g * kPixels;
#pragma unroll
      for (int q = 0; q < kPixels; ++q) {
        if (j0 + q >= ow) break;
        const Taps tx = col[j0 + q];
        unsigned short* t = pass + (static_cast<size_t>(sr) * ow + j0 + q) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) t[c] = bf16_bits(column_pass(p, row, tx,
                                                                 c));
      }
    }
    __syncthreads();
  }
  for (int it = tid; it < rows * groups; it += nt) {
    const int rb = it / groups, g = it - rb * groups;
    const Taps ty = row_taps[rb];
    const int j0 = g * kPixels;
    const int npix = ow - j0 < kPixels ? ow - j0 : kPixels;
    float o[3 * kPixels];
#pragma unroll
    for (int q = 0; q < kPixels; ++q) {
      if (q >= npix) break;
      float v0[3], v1[3];
      if (keep) {
        const unsigned short* t0 = pass + (static_cast<size_t>(ty.i0 - r_lo)
                                           * ow + j0 + q) * 3;
        const unsigned short* t1 = pass + (static_cast<size_t>(ty.i1 - r_lo)
                                           * ow + j0 + q) * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v0[c] = bf16_float(t0[c]);
          v1[c] = bf16_float(t1[c]);
        }
      } else {
        const Taps tx = col[j0 + q];
        const size_t r0 = frame + static_cast<size_t>(ty.i0) * W * 3;
        const size_t r1 = frame + static_cast<size_t>(ty.i1) * W * 3;
#pragma unroll
        for (int c = 0; c < 3; ++c) {
          v0[c] = bf16_float(bf16_bits(column_pass(p, r0, tx, c)));
          v1[c] = bf16_float(bf16_bits(column_pass(p, r1, tx, c)));
        }
      }
      row_pass(ty, v0, v1, o + 3 * q);
    }
    store_pixels(p, ((static_cast<size_t>(n) * p.out_h + row0 + rb) * ow
                     + j0) * 3, npix, o);
  }
}

}  // namespace

extern "C" {

// One call: ints[kStreams] streams of ints[kBoxesA] boxes, frames of
// ints[kHeight] x ints[kWidth], crops of ints[kOutH] x ints[kOutW], in
// bf16 where ints[kBf16Out], in bands of ints[kBand] output rows (8 or
// 16); `ptrs` holds the CropPtr enum's pointers,
// floats the reciprocals of the output's width and height. One launch on
// `stream`. Returns 0 or the first cudaError_t.
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
  p.bf16_out = ints[kBf16Out];
  p.band_rows = ints[kBand];
  p.inv_out_w = floats[kInvOutW];
  p.inv_out_h = floats[kInvOutH];
  const long long crops = static_cast<long long>(p.streams)
      * p.boxes_a_stream;
  if (p.streams < 1 || p.boxes_a_stream < 1 || crops > 65535
      || p.height < 1 || p.width < 1 || p.out_h < 1 || p.out_w < 1
      || p.out_w > kMaxOutW
      || (p.band_rows != 8 && p.band_rows != kMaxBandRows))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k <= kOut; ++k)
    if (!ptrs[k]) return static_cast<int>(cudaErrorInvalidValue);
  p.frames = ptrs[kFrames];
  p.boxes = static_cast<const float*>(ptrs[kBoxes]);
  p.out = const_cast<void*>(ptrs[kOut]);
  // the column pass keeps as many source rows as kPassBytes holds, at most
  // twice the band's rows (a band taller than that, or an output too
  // wide, reads its rows for each output row)
  const int cap = kPassBytes / (p.out_w * 3 * 2);
  p.span_cap = cap < 2 * p.band_rows ? cap : 2 * p.band_rows;
  const int smem = (p.out_w + p.band_rows) * static_cast<int>(sizeof(Taps))
                   + p.span_cap * p.out_w * 3 * 2;
  if (smem > 48 * 1024) {
    const cudaError_t e = cudaFuncSetAttribute(
        reid_crops_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const dim3 grid((p.out_h + p.band_rows - 1) / p.band_rows,
                  static_cast<unsigned>(crops));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  reid_crops_kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code the entry returned
const char* reid_crops_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
