// A gap frame's preprocess for Hopper (sm_90a): gray, the image pyramid
// and its uint8 rounding, the full-resolution Shi-Tomasi grid candidates
// and the background candidates, for every stream of a call, in one
// launch with no host sync.
//
// Replaces fastmot_tpu/ops/flow_kernels.py:716 _preprocess_jit. That is
// not a Pallas kernel but one jitted XLA program; its plain PyTorch twin
// is preprocess_reference in fastmot_tpu_torch/ops/flow_kernels.py (about
// a hundred eager launches a call); the wrapper preprocess there checks
// the frames, allocates the state as views of one float32 buffer and
// calls flow_preprocess_forward below.
//
// What bounds it on an H100: bytes, in principle. A 1280x720 stream reads
// its 2.76 MB frame and writes the two pyramids (307,100 floats each) and
// the candidates, about 5.4 MB: 1.6 us at 3.35 TB/s. The first design
// (three roles side by side: a full-resolution Shi-Tomasi tile of 32 x
// 64 px, a pyramid tile reading the frame again, the bg tile) reached
// 0.11-0.16 of that: each frame byte fetched about twice as scattered
// single bytes, gray recomputed at every tap, the 3x3 box sums forming 27
// products a pixel where 3 do, and the pyramid's six levels one after
// another behind block barriers, the deep ones on a few threads.
//
// This design reads the frame once and computes each product once:
//
// - frame role: a tile of 64 x 64 frame px (8 x 8 cells of 8 px). It
//   stages gray over the tile and a 2-px halo (68 x 68) in shared memory,
//   the interior from 16-px groups of three 16-byte loads (48 bytes of
//   BGR, the row's and the group's alignment allowing, else byte by
//   byte), a thread's loads all issued before its conversions, gray
//   computed once a staged pixel (a byte to float by the 2^23 trick, not
//   the quarter-rate conversion). Then, behind one barrier, side by side:
//   (a) on five warps, the column pass: a thread walks one run of 32 rows
//   of a column with the gradients and the products of the row below in
//   registers (each product once, but for the rows where a column's runs
//   meet: 68 rows of products for 66), and writes each pixel's column
//   3-sums of ix*ix, iy*iy, ix*iy; (b) on the other three, where the
//   pyramid nests (the opt size is half the frame, the main path's scale
//   of 0.5, so level 0's taps of this tile lie in it), the pyramid's 32 x
//   32 tile of level 0 from the same staged gray, a thread a 2 x 2 quad:
//   its level-1 px in a register, level 2 by two shuffles. Behind a
//   second barrier warp 0 makes levels 3-5 (21 px) by shuffles, and the
//   row pass: a thread a cell row of 8 px sums the column sums left to
//   right, takes the 8 responses and their first maximum, and the cell's
//   8 lanes reduce to its first row-major maximum by shuffles. The frame is
//   read once, plus its halo (68^2 / 64^2 = 1.13).
// - bg role: a tile of 4 x 8 background cells (16 x 32 px of the bg
//   image). It resizes its pixels and a 2-px halo from the frame (gray
//   at each tap, each tapped frame pixel once: at 0.1 the bg reads one
//   frame pixel in 25), then the same column and row passes. The bg
//   image's 3x3 neighbourhoods cross frame tiles, and the state has no
//   room for a bg image, so the bg keeps its own blocks: 20 of a 1280x720
//   stream's 260.
// - pyramid role, only where the pyramid does not nest (another opt size):
//   a 32 x 32 tile of level 0 resized from the frame (gray at each tap),
//   then levels 1-5 as the frame role makes them.
//
// The tile: 64 x 64 px is the least whose level-0 quarter nests down to
// one pixel of level 5, so the pyramid needs no second pass. Its shared
// memory (gray 68 x 72 floats, the column sums 3 x 64 x 67) is 71,296 B,
// so three blocks of 256 threads fit an SM (24 warps, 80 registers): the
// 8-stream call's 2,080 blocks take about five waves of 396. The column
// sums' row pitch of 67 floats puts a warp's 4 cells x 8 rows of the row
// pass on 32 different banks.
//
// What bounds it now (scripts/prof_preprocess.py, thread 0's global timer
// at each phase of every block, H100 at 700 W, 1 / 8 streams of 1280x720):
// a frame block takes 7.5 / 8.8 us, median: staging 2.0 / 2.8, the column
// pass beside levels 0-2 2.8 / 2.8, levels 3-5 0.9 / 1.0, the row pass
// 1.8 / 2.2; the launch 9.9 / 52.9 us. At one stream it is one block's
// chain; at eight the blocks start in about five waves (their start times
// spread over 46 us), so the latency of a block times the waves sets the
// time, at 0.16 / 0.24 of the bytes bound. Measured on the same card and
// slower, at 1 / 8 streams, against 10.1 / 53.0 us: 512 threads a block
// (9.3 / 57.7: two blocks an SM at 64 registers), runs of 16 rows (9.9 /
// 54.3), the column sums in two bands of 32 rows so that four blocks fit
// an SM (11.3 / 54.8: the registers cut to 64 spill), the whole pyramid on
// one warp beside a column pass on seven (10.3 / 57.5: the pyramid warp's
// eight rounds outlast the column pass).
//
// Every loop strides over its items by blockDim.x, and every dependency
// between threads passes a __syncthreads or a warp's shuffle: the result
// does not depend on the block's thread count, a multiple of 32 (the
// tests' host build runs the blocks with 32 or 64 host threads), nor on
// the stream count.
//
// Numerics: the plain version's order of operations, so the two agree bit
// for bit on the CPU (tests/test_torch_flow_preprocess.py). Build with
// -fmad=false (ops/cuda_build.py KERNEL_FLAGS), as the host build runs
// under -ffp-contract=off: gray is (r*0.299 + g*0.587) + b*0.114, each
// product and sum rounded; the 2x2 mean is (a + b) + (c + d) of the two
// rows, times 0.25; the box sums add rows, then columns, left to right;
// the response is 0.5 * ((sxx + syy) - sqrt(max((sxx - syy)^2 +
// 4 sxy^2, 0))). The resizes are resize_bilinear's, F.interpolate's
// bilinear (align_corners False, no antialias): the source coordinate
// fma(in/out, d + 0.5, -0.5) (exact before its one rounding, as the plain
// version takes it in float64), clamped at 0, the right tap clamped; then
// along each row, t = g0 wx0 + g1 wx1, and down the column, t0 wy0 +
// t1 wy1, each product and sum rounded on its own. Rounding
// to uint8 is rint (half to even), as torch.round.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kMaxLevels = 6;     // a kPyrTile tile of level 0 nests to 1 px
constexpr int kPyrTile = 32;
constexpr int kTile = 2 * kPyrTile;   // frame px a side of a frame tile
constexpr int kGroup = 16;        // px of one 48-byte vector load group
constexpr int kCell = 8;          // CELL in ops/flow_kernels.py
constexpr int kBgCell = 4;        // BG_CELL

// flow_preprocess_forward's `ints`, in this order (ops/flow_kernels.py
// preprocess_launch_args lists them): sizes, then the offsets (in floats,
// into `out`) of each level, each uint8 level, the candidates and the bg
// candidates.
enum Int {
  kStreams, kHeight, kWidth, kLevels, kOptH, kOptW, kBgH, kBgW, kOffPyr,
  kOffPyrU8 = kOffPyr + kMaxLevels, kOffCandPts = kOffPyrU8 + kMaxLevels,
  kOffCandScore, kOffBgPts, kOffBgScore, kNumInts
};

struct Params {
  const uint8_t* frames;
  float* out;
  int streams, h, w, levels;
  int lh[kMaxLevels], lw[kMaxLevels];
  int bg_h, bg_w;
  int gh, gw, bg_gh, bg_gw;           // the two candidate grids
  bool nested;                        // level 0 from the frame tiles' gray
  int n_bg_tiles, n_frame_tiles, n_pyr_tiles;
  int bg_tiles_x, frame_tiles_x, pyr_tiles_x;
  long long off_pyr[kMaxLevels], off_u8[kMaxLevels];
  long long off_cand_pts, off_cand_score, off_bg_pts, off_bg_score;
  float bg_scale_x, bg_scale_y;
};

// A Shi-Tomasi tile of kRows x kCols px and cells of kCellPx: its image
// over the tile and a 2-px halo (row pitch kGStride, the tile's first
// column at kGx0, 16-byte aligned), and the column 3-sums of the three
// products over the tile's rows and a 1-px column halo (row pitch
// kCStride; column j is the tile's column j - 1), each of the three a
// block of kRows rows. The column pass walks kSeg rows a thread.
template <int kRows, int kCols, int kCellPx, int kSeg, int kCStride>
struct St {
  static constexpr int kR = kRows, kC = kCols, kCellSize = kCellPx;
  static constexpr int kSegRows = kSeg, kSumPitch = kCStride;
  static constexpr int kGStride = kCols + 8, kGRows = kRows + 4, kGx0 = 4;
  static constexpr int kCCols = kCols + 2;
  static constexpr int kGrayFloats = kGRows * kGStride;
  static constexpr int kSumFloats = 3 * kRows * kCStride;
  static constexpr int kColTasks = kCCols * (kRows / kSeg);
  static constexpr int kCellsX = kCols / kCellPx, kCellsY = kRows / kCellPx;
  static constexpr int kRowTasks = kRows * kCellsX;   // a multiple of 32
};
using FrameSt = St<kTile, kTile, kCell, 32, 67>;
using BgSt = St<4 * kBgCell, 8 * kBgCell, kBgCell, 16, 65>;
// the warps of the frame role's column pass beside the pyramid
constexpr int kColWarps = (FrameSt::kColTasks + 31) / 32;
// the pyramid's level 2 of a tile (8 x 8), for the levels below it
constexpr int kLevelFloats = 64;
constexpr int kSmemFloats =
    FrameSt::kGrayFloats + FrameSt::kSumFloats + kLevelFloats;
constexpr int kSmemBytes = kSmemFloats * 4;
static_assert(BgSt::kGrayFloats + BgSt::kSumFloats <= kSmemFloats, "bg");

// One output coordinate's two taps and weights along an axis of the
// bilinear resize from `in` samples (scale: float32(in) / float32(out))
// (flow_kernels.py _taps)
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ float resize_scale(int in, int out) {
  return static_cast<float>(in) / static_cast<float>(out);
}

__device__ __forceinline__ Tap resize_tap(int d, int in, float scale) {
  Tap t;
  float src = fmaf(scale, static_cast<float>(d) + 0.5f, -0.5f);
  if (src < 0.f) src = 0.f;
  t.i0 = min(static_cast<int>(floorf(src)), in - 1);
  t.w1 = fminf(fmaxf(src - static_cast<float>(t.i0), 0.f), 1.f);
  t.i1 = t.i0 + (t.i0 < in - 1 ? 1 : 0);
  t.w0 = 1.f - t.w1;
  return t;
}

// A byte as a float, exactly, without a conversion instruction (a quarter
// of the float rate): 2^23 + b holds b in its low mantissa bits
__device__ __forceinline__ float byte_float(unsigned b) {
  return __uint_as_float(0x4B000000u | b) - 8388608.f;
}

// OpenCV's BGR2GRAY weights, as the plain version rounds them
__device__ __forceinline__ float gray_of(unsigned b, unsigned g, unsigned r) {
  return (byte_float(r) * 0.299f + byte_float(g) * 0.587f)
      + byte_float(b) * 0.114f;
}
__device__ __forceinline__ float gray_at(const uint8_t* frame, int w, int y,
                                         int x) {
  const uint8_t* q = frame + (static_cast<size_t>(y) * w + x) * 3;
  return gray_of(q[0], q[1], q[2]);
}

// The bilinear mix of the four taps' values, in resize_bilinear's order
__device__ __forceinline__ float bilinear(const Tap& ty, const Tap& tx,
                                          float g00, float g01, float g10,
                                          float g11) {
  const float t0 = g00 * tx.w0 + g01 * tx.w1;
  const float t1 = g10 * tx.w0 + g11 * tx.w1;
  return t0 * ty.w0 + t1 * ty.w1;
}

// The resize of gray at the taps (ty, tx), gray read from the frame
__device__ __forceinline__ float resized_gray(const uint8_t* frame, int w,
                                              const Tap& ty, const Tap& tx) {
  return bilinear(ty, tx, gray_at(frame, w, ty.i0, tx.i0),
                  gray_at(frame, w, ty.i0, tx.i1),
                  gray_at(frame, w, ty.i1, tx.i0),
                  gray_at(frame, w, ty.i1, tx.i1));
}

__device__ __forceinline__ float u8_value(float v) {
  return fminf(fmaxf(rintf(v), 0.f), 255.f);
}

// Gray of a frame tile (rows py0 - 2 .., columns px0 - 2 ..) into g: 16-px
// groups of the interior by three 16-byte loads where the group lies in
// the frame and its address is 16-byte aligned (else byte by byte), the
// 2-px column halo pixel by pixel; 0 outside the frame. A row has as many
// groups as halo pixels (4), and a thread takes two of each at a time,
// every load issued before the first conversion.
__device__ void stage_frame_gray(const uint8_t* frame, int h, int w,
                                 int py0, int px0, float* g) {
  using S = FrameSt;
  constexpr int kPerRow = kTile / kGroup, kTasks = S::kGRows * kPerRow;
  static_assert(kPerRow == 4, "a group and a halo pixel a task");
  const int nt = blockDim.x;
  for (int t0 = threadIdx.x; t0 < kTasks; t0 += 2 * nt) {
    uint4 q[2][3];
    unsigned halo[2][3];
    bool vec[2];
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = t0 + u * nt, lr = t / kPerRow, k = t % kPerRow;
      const int y = py0 - 2 + lr, x0 = px0 + k * kGroup;
      const bool row_in = t < kTasks && y >= 0 && y < h;
      const uint8_t* row = frame + static_cast<size_t>(row_in ? y : 0) * w * 3;
      const uint8_t* src = row + static_cast<size_t>(x0) * 3;
      vec[u] = row_in && x0 + kGroup <= w
          && (reinterpret_cast<uintptr_t>(src) & 15) == 0;
      if (vec[u]) {
        const uint4* s4 = reinterpret_cast<const uint4*>(src);
        q[u][0] = s4[0];
        q[u][1] = s4[1];
        q[u][2] = s4[2];
      }
      const int x = px0 + (k < 2 ? k - 2 : kTile + k - 2);   // the halo's
      const bool halo_in = row_in && x >= 0 && x < w;
      for (int c = 0; c < 3; ++c)
        halo[u][c] = halo_in ? row[static_cast<size_t>(x) * 3 + c] : 0u;
    }
#pragma unroll
    for (int u = 0; u < 2; ++u) {
      const int t = t0 + u * nt, lr = t / kPerRow, k = t % kPerRow;
      if (t >= kTasks) break;
      const int y = py0 - 2 + lr, x0 = px0 + k * kGroup;
      float* gr = g + lr * S::kGStride + S::kGx0;      // column px0
      float v[kGroup];
      if (vec[u]) {
        const unsigned* b = reinterpret_cast<const unsigned*>(q[u]);
        auto byte = [&](int j) { return (b[j >> 2] >> (8 * (j & 3))) & 255u; };
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          v[i] = gray_of(byte(3 * i), byte(3 * i + 1), byte(3 * i + 2));
      } else {
        const bool row_in = y >= 0 && y < h;
#pragma unroll
        for (int i = 0; i < kGroup; ++i)
          v[i] = (row_in && x0 + i < w) ? gray_at(frame, w, y, x0 + i) : 0.f;
      }
      float4* dst = reinterpret_cast<float4*>(gr + k * kGroup);
#pragma unroll
      for (int i = 0; i < kGroup / 4; ++i)
        dst[i] = make_float4(v[4 * i], v[4 * i + 1], v[4 * i + 2],
                             v[4 * i + 3]);
      const int dx = k < 2 ? k - 2 : kTile + k - 2;
      const int x = px0 + dx;
      gr[dx] = (y >= 0 && y < h && x >= 0 && x < w)
          ? gray_of(halo[u][0], halo[u][1], halo[u][2]) : 0.f;
    }
  }
}

// The bg image of a bg tile (rows py0 - 2 .., columns px0 - 2 ..) into g,
// resized from the frame; 0 outside the bg image
__device__ void stage_bg(const Params& p, const uint8_t* frame, int py0,
                         int px0, float* g) {
  using S = BgSt;
  constexpr int kW = S::kC + 4;
  const float sy = resize_scale(p.h, p.bg_h), sx = resize_scale(p.w, p.bg_w);
  for (int t = threadIdx.x; t < S::kGRows * kW; t += blockDim.x) {
    const int lr = t / kW, lc = t % kW;
    const int y = py0 - 2 + lr, x = px0 - 2 + lc;
    g[lr * S::kGStride + S::kGx0 - 2 + lc] =
        (y >= 0 && y < p.bg_h && x >= 0 && x < p.bg_w)
            ? resized_gray(frame, p.w, resize_tap(y, p.h, sy),
                           resize_tap(x, p.w, sx)) : 0.f;
  }
}

// One column of the column pass: the products of tile rows r0 - 1 ..
// r0 + kSegRows (the gradients from gc, gray at tile row r in
// gc[(r + 2) * kGStride]) and their 3-sums into out, kSegRows rows. With
// kRowsIn every row lies in 1 .. img_h - 2, so only the column's own
// flags select.
template <class S, bool kRowsIn>
__device__ __forceinline__ void column_walk(const float* gc, float* out,
                                            int r0, int py0, int img_h,
                                            bool col_in, bool dx_in) {
  constexpr int kG = S::kGStride, kPlane = S::kR * S::kSumPitch;
  auto products = [&](int r, float& xx, float& yy, float& xy) {
    const int y = py0 + r;
    const float* q = gc + (r + 2) * kG;
    const bool gx = kRowsIn ? dx_in : (y >= 0 && y < img_h && dx_in);
    const bool gy = kRowsIn ? col_in : (col_in && y >= 1 && y <= img_h - 2);
    const float ix = gx ? (q[1] - q[-1]) * 0.5f : 0.f;
    const float iy = gy ? (q[kG] - q[-kG]) * 0.5f : 0.f;
    xx = ix * ix;
    yy = iy * iy;
    xy = ix * iy;
  };
  float xx0, yy0, xy0, xx1, yy1, xy1;
  products(r0 - 1, xx0, yy0, xy0);
  products(r0, xx1, yy1, xy1);
#pragma unroll 4
  for (int k = 0; k < S::kSegRows; ++k) {
    float xx2, yy2, xy2;
    products(r0 + k + 1, xx2, yy2, xy2);
    float* o = out + k * S::kSumPitch;
    o[0] = (xx0 + xx1) + xx2;
    o[kPlane] = (yy0 + yy1) + yy2;
    o[2 * kPlane] = (xy0 + xy1) + xy2;
    xx0 = xx1;
    yy0 = yy1;
    xy0 = xy1;
    xx1 = xx2;
    yy1 = yy2;
    xy1 = xy2;
  }
}

// The column pass of a Shi-Tomasi tile whose top left px is (py0, px0) of
// an img_h x img_w image staged in g: each column's 3-sums of ix*ix,
// iy*iy and ix*iy into cs (the gradients 0 at the image's edges and the
// products 0 outside it, as the plain version's padding); the calling
// thread takes tasks t0, t0 + stride, ...
template <class S>
__device__ void column_sums(const float* g, float* cs, int py0, int px0,
                            int img_h, int img_w, int t0, int stride) {
  for (int t = t0; t < S::kColTasks; t += stride) {
    const int j = t % S::kCCols, r0 = (t / S::kCCols) * S::kSegRows;
    const int x = px0 - 1 + j;
    const bool col_in = x >= 0 && x < img_w;
    const bool dx_in = x >= 1 && x <= img_w - 2;
    const float* gc = g + S::kGx0 - 1 + j;
    float* out = cs + r0 * S::kSumPitch + j;
    if (py0 + r0 - 1 >= 1 && py0 + r0 + S::kSegRows <= img_h - 2)
      column_walk<S, true>(gc, out, r0, py0, img_h, col_in, dx_in);
    else
      column_walk<S, false>(gc, out, r0, py0, img_h, col_in, dx_in);
  }
}

// The row pass: each pixel's row 3-sums of the column sums, its response,
// each cell row's first maximum (a thread a cell row), then each cell's
// first row-major maximum over its kCellPx lanes; written as points (x,
// y) / (sx, sy) and scores into pts and score ([gh * gw] row-major cells)
// for the tile's cells (cy0.., cx0..) that the grid holds
template <class S>
__device__ void cell_candidates(const float* cs, int cy0, int cx0, int gh,
                                int gw, float sx, float sy, bool divide,
                                float* pts, float* score) {
  constexpr int kCellPx = S::kCellSize, kPlane = S::kR * S::kSumPitch;
  for (int t = threadIdx.x; t < S::kRowTasks; t += blockDim.x) {
    const int cell = t / kCellPx, rr = t % kCellPx;
    const int cy = cell / S::kCellsX, cx = cell % S::kCellsX;
    const float* a = cs + (cy * kCellPx + rr) * S::kSumPitch + cx * kCellPx;
    float best = 0.f;
    int col = 0;
#pragma unroll
    for (int k = 0; k < kCellPx; ++k) {
      const float sxx = (a[k] + a[k + 1]) + a[k + 2];
      const float syy = (a[kPlane + k] + a[kPlane + k + 1]) + a[kPlane + k + 2];
      const float sxy = (a[2 * kPlane + k] + a[2 * kPlane + k + 1])
          + a[2 * kPlane + k + 2];
      const float d = sxx - syy;
      const float det = sqrtf(fmaxf(d * d + 4.f * (sxy * sxy), 0.f));
      const float resp = 0.5f * ((sxx + syy) - det);
      if (k == 0 || resp > best) {
        best = resp;
        col = k;
      }
    }
    // the cell's lanes: the larger response, on a tie the upper row
    unsigned long long v =
        (static_cast<unsigned long long>(__float_as_uint(best)) << 32)
        | static_cast<unsigned>(rr * kCellPx + col);
#pragma unroll
    for (int m = kCellPx / 2; m > 0; m >>= 1) {
      const unsigned long long o = __shfl_xor_sync(kFull, v, m);
      const float ob = __uint_as_float(static_cast<unsigned>(o >> 32));
      const float vb = __uint_as_float(static_cast<unsigned>(v >> 32));
      if (ob > vb || (ob == vb && static_cast<unsigned>(o)
                                      < static_cast<unsigned>(v)))
        v = o;
    }
    const int gy = cy0 + cy, gx = cx0 + cx;
    if (rr == 0 && gy < gh && gx < gw) {
      const int idx = static_cast<int>(static_cast<unsigned>(v));
      const int c = gy * gw + gx;
      float x = static_cast<float>(gx * kCellPx + idx % kCellPx);
      float y = static_cast<float>(gy * kCellPx + idx / kCellPx);
      if (divide) {
        x = x / sx;
        y = y / sy;
      }
      pts[2 * c] = x;
      pts[2 * c + 1] = y;
      score[c] = __uint_as_float(static_cast<unsigned>(v >> 32));
    }
  }
}

// Level l's value v at (y, x) and its uint8 rounding, if the level holds it
__device__ __forceinline__ void put_level(const Params& p, int s, int l,
                                          int y, int x, float v) {
  if (y >= p.lh[l] || x >= p.lw[l]) return;
  const size_t i = (static_cast<size_t>(s) * p.lh[l] + y) * p.lw[l] + x;
  p.out[p.off_pyr[l] + i] = v;
  p.out[p.off_u8[l] + i] = u8_value(v);
}

__device__ __forceinline__ float mean4(float a, float b, float c, float d) {
  return ((a + b) + (c + d)) * 0.25f;
}

// Levels 0-2 of pyramid tile (ty, tx), level 0 from quad(y, x, v) (the
// 2 x 2 px of level 0 from (y, x), every one of them in range or not): a
// thread a quad, so a level-1 px, and the 2 x 2 level-1 px of a level-2 px
// in lanes (2c, 2c + 1, 16 + 2c, 17 + 2c) of a warp; level 2 also into l2
// (8 x 8) for the levels below it. The calling warps take quads t0, t0 +
// stride, ... (t0 a thread's lane in a whole warp, stride a multiple of 32).
template <class Quad>
__device__ void pyramid_upper(const Params& p, int s, int ty, int tx,
                              const Quad& quad, float* l2, int t0,
                              int stride) {
  constexpr int kQ = kPyrTile / 2;                 // level-1 px a side
  for (int i = t0; i < kQ * kQ; i += stride) {
    const int qy = i / kQ, qx = i % kQ;
    const int y = ty * kPyrTile + 2 * qy, x = tx * kPyrTile + 2 * qx;
    float v[2][2];
    quad(y, x, v);
#pragma unroll
    for (int a = 0; a < 2; ++a)
#pragma unroll
      for (int b = 0; b < 2; ++b) put_level(p, s, 0, y + a, x + b, v[a][b]);
    if (p.levels < 2) continue;
    const float l1 = mean4(v[0][0], v[0][1], v[1][0], v[1][1]);
    put_level(p, s, 1, ty * kQ + qy, tx * kQ + qx, l1);
    if (p.levels < 3) continue;
    const float pair = l1 + __shfl_down_sync(kFull, l1, 1);
    const float below = __shfl_down_sync(kFull, pair, kQ);
    const int lane = i % 32;
    if (lane < kQ && lane % 2 == 0) {
      const int r = i / 32, c = lane / 2;          // level-2 px of the tile
      const float l2v = (pair + below) * 0.25f;
      l2[r * (kQ / 2) + c] = l2v;
      put_level(p, s, 2, ty * (kQ / 2) + r, tx * (kQ / 2) + c, l2v);
    }
  }
}

// ((v + v of the lane `right` on) + the same `below` lanes on) / 4: the 2x2
// mean whose top left lies in this lane
__device__ __forceinline__ float mean_down(float v, int right, int below) {
  const float pair = v + __shfl_down_sync(kFull, v, right);
  return (pair + __shfl_down_sync(kFull, pair, below)) * 0.25f;
}

// Levels 3-5 of pyramid tile (ty, tx) from its level 2 (8 x 8 in l2), on
// the calling warp alone, by shuffles: lane L holds level-2 px L (rows
// 0-3) in a and L + 32 (rows 4-7) in b; each level's px sits in the lane of
// its top-left source
__device__ void pyramid_lower(const Params& p, int s, int ty, int tx,
                              const float* l2) {
  if (p.levels < 4) return;
  const int lane = threadIdx.x % 32, r = lane / 8, c = lane % 8;
  const float a3 = mean_down(l2[lane], 1, 8);       // level-3 rows 0-1
  const float b3 = mean_down(l2[lane + 32], 1, 8);  // rows 2-3
  if (r % 2 == 0 && c % 2 == 0) {
    put_level(p, s, 3, ty * 4 + r / 2, tx * 4 + c / 2, a3);
    put_level(p, s, 3, ty * 4 + 2 + r / 2, tx * 4 + c / 2, b3);
  }
  if (p.levels < 5) return;
  const float a4 = mean_down(a3, 2, 16), b4 = mean_down(b3, 2, 16);
  if (lane == 0 || lane == 4) {
    put_level(p, s, 4, ty * 2, tx * 2 + lane / 4, a4);
    put_level(p, s, 4, ty * 2 + 1, tx * 2 + lane / 4, b4);
  }
  if (p.levels < 6) return;
  const float top = a4 + __shfl_down_sync(kFull, a4, 4);
  const float bottom = b4 + __shfl_down_sync(kFull, b4, 4);
  if (lane == 0) put_level(p, s, 5, ty, tx, (top + bottom) * 0.25f);
}

// A frame tile: gray once, the full-resolution candidates of its cells
// and, where the pyramid nests, its pyramid tile
__device__ void frame_tile(const Params& p, int s, int tile, float* sm) {
  using S = FrameSt;
  const uint8_t* frame = p.frames + static_cast<size_t>(s) * p.h * p.w * 3;
  const int ty = tile / p.frame_tiles_x, tx = tile % p.frame_tiles_x;
  const int py0 = ty * kTile, px0 = tx * kTile;
  float* g = sm;
  float* cs = sm + S::kGrayFloats;
  float* l2 = cs + S::kSumFloats;
  stage_frame_gray(frame, p.h, p.w, py0, px0, g);
  __syncthreads();
  // the column pass on kColWarps warps and the pyramid on the others,
  // side by side, where the block has more (else one after the other)
  const int tid = threadIdx.x, nt = blockDim.x;
  const bool split = p.nested && nt > kColWarps * 32;
  if (!split || tid < kColWarps * 32)
    column_sums<S>(g, cs, py0, px0, p.h, p.w, tid,
                   split ? kColWarps * 32 : nt);
  if (p.nested && (!split || tid >= kColWarps * 32)) {
    // level 0 from the staged gray: its taps lie in the tile (the clamped
    // taps of a quad past the level's edge too)
    const float sy = resize_scale(p.h, p.lh[0]);
    const float sx = resize_scale(p.w, p.lw[0]);
    auto quad = [&](int y, int x, float (&v)[2][2]) {
      const Tap tx0 = resize_tap(x, p.w, sx), tx1 = resize_tap(x + 1, p.w, sx);
#pragma unroll
      for (int a = 0; a < 2; ++a) {
        const Tap ty_ = resize_tap(y + a, p.h, sy);
        const float* r0 = g + (ty_.i0 - py0 + 2) * S::kGStride + S::kGx0 - px0;
        const float* r1 = g + (ty_.i1 - py0 + 2) * S::kGStride + S::kGx0 - px0;
        v[a][0] = bilinear(ty_, tx0, r0[tx0.i0], r0[tx0.i1], r1[tx0.i0],
                           r1[tx0.i1]);
        v[a][1] = bilinear(ty_, tx1, r0[tx1.i0], r0[tx1.i1], r1[tx1.i0],
                           r1[tx1.i1]);
      }
    };
    if (split)
      pyramid_upper(p, s, ty, tx, quad, l2, tid - kColWarps * 32,
                    nt - kColWarps * 32);
    else
      pyramid_upper(p, s, ty, tx, quad, l2, tid, nt);
  }
  __syncthreads();
  if (p.nested && threadIdx.x < 32) pyramid_lower(p, s, ty, tx, l2);
  const size_t n = static_cast<size_t>(p.gh) * p.gw;
  cell_candidates<S>(cs, ty * (kTile / kCell), tx * (kTile / kCell), p.gh,
                     p.gw, 1.f, 1.f, false,
                     p.out + p.off_cand_pts + s * 2 * n,
                     p.out + p.off_cand_score + s * n);
}

// A bg tile: its bg image resized from the frame, then its cells'
// candidates
__device__ void bg_tile(const Params& p, int s, int tile, float* sm) {
  using S = BgSt;
  const uint8_t* frame = p.frames + static_cast<size_t>(s) * p.h * p.w * 3;
  const int ty = tile / p.bg_tiles_x, tx = tile % p.bg_tiles_x;
  const int py0 = ty * S::kR, px0 = tx * S::kC;
  float* g = sm;
  float* cs = sm + S::kGrayFloats;
  stage_bg(p, frame, py0, px0, g);
  __syncthreads();
  column_sums<S>(g, cs, py0, px0, p.bg_h, p.bg_w, threadIdx.x,
                 blockDim.x);
  __syncthreads();
  const size_t n = static_cast<size_t>(p.bg_gh) * p.bg_gw;
  cell_candidates<S>(cs, ty * S::kCellsY, tx * S::kCellsX, p.bg_gh,
                     p.bg_gw, p.bg_scale_x, p.bg_scale_y, true,
                     p.out + p.off_bg_pts + s * 2 * n,
                     p.out + p.off_bg_score + s * n);
}

// A pyramid tile where the pyramid does not nest in the frame tiles:
// level 0 resized from the frame (gray at each tap)
__device__ void pyramid_tile(const Params& p, int s, int tile, float* sm) {
  const uint8_t* frame = p.frames + static_cast<size_t>(s) * p.h * p.w * 3;
  const int ty = tile / p.pyr_tiles_x, tx = tile % p.pyr_tiles_x;
  const float sy = resize_scale(p.h, p.lh[0]);
  const float sx = resize_scale(p.w, p.lw[0]);
  auto quad = [&](int y, int x, float (&v)[2][2]) {
    const Tap tx0 = resize_tap(x, p.w, sx), tx1 = resize_tap(x + 1, p.w, sx);
#pragma unroll
    for (int a = 0; a < 2; ++a) {
      const Tap ty_ = resize_tap(y + a, p.h, sy);
      v[a][0] = resized_gray(frame, p.w, ty_, tx0);
      v[a][1] = resized_gray(frame, p.w, ty_, tx1);
    }
  };
  pyramid_upper(p, s, ty, tx, quad, sm, threadIdx.x, blockDim.x);
  __syncthreads();
  if (threadIdx.x < 32) pyramid_lower(p, s, ty, tx, sm);
}

__global__ void __launch_bounds__(kThreads, 3)
preprocess_kernel(const Params p) {
  extern __shared__ float4 smem[];
  float* sm = reinterpret_cast<float*>(smem);
  const int s = blockIdx.y;
  int b = blockIdx.x;
  if (b < p.n_bg_tiles) {
    bg_tile(p, s, b, sm);
    return;
  }
  b -= p.n_bg_tiles;
  if (b < p.n_frame_tiles) {
    frame_tile(p, s, b, sm);
    return;
  }
  pyramid_tile(p, s, b - p.n_frame_tiles, sm);
}

int ceil_div(int a, int b) { return (a + b - 1) / b; }

}  // namespace

extern "C" {

// One preprocess call for ints[kStreams] streams of ints[kHeight] x
// ints[kWidth] uint8 BGR frames ([S, H, W, 3] at `frames`, device memory):
// writes the levels, their uint8 roundings and both candidate sets at the
// offsets `ints` gives into `out` (float32, device memory); `floats` holds
// the bg scale (x, y) the bg points are divided by. One launch on
// `stream`. Returns 0 or the first cudaError_t.
int flow_preprocess_forward(const uint8_t* frames, float* out,
                            const int* ints, const float* floats,
                            void* stream) {
  Params p = {};
  p.frames = frames;
  p.out = out;
  p.streams = ints[kStreams];
  p.h = ints[kHeight];
  p.w = ints[kWidth];
  p.levels = ints[kLevels];
  p.bg_h = ints[kBgH];
  p.bg_w = ints[kBgW];
  if (p.streams < 1 || p.streams > 65535 || p.h < 1 || p.w < 1
      || p.levels < 1 || p.levels > kMaxLevels || ints[kOptH] < 1
      || ints[kOptW] < 1 || p.bg_h < 1 || p.bg_w < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  p.lh[0] = ints[kOptH];
  p.lw[0] = ints[kOptW];
  for (int l = 1; l < p.levels; ++l) {
    p.lh[l] = p.lh[l - 1] / 2;
    p.lw[l] = p.lw[l - 1] / 2;
    if (p.lh[l] < 1 || p.lw[l] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  for (int l = 0; l < p.levels; ++l) {
    p.off_pyr[l] = ints[kOffPyr + l];
    p.off_u8[l] = ints[kOffPyrU8 + l];
  }
  p.off_cand_pts = ints[kOffCandPts];
  p.off_cand_score = ints[kOffCandScore];
  p.off_bg_pts = ints[kOffBgPts];
  p.off_bg_score = ints[kOffBgScore];
  p.bg_scale_x = floats[0];
  p.bg_scale_y = floats[1];
  p.gh = p.h / kCell;
  p.gw = p.w / kCell;
  p.bg_gh = p.bg_h / kBgCell;
  p.bg_gw = p.bg_w / kBgCell;
  p.bg_tiles_x = ceil_div(p.bg_gw, BgSt::kCellsX);
  p.n_bg_tiles = ceil_div(p.bg_gh, BgSt::kCellsY) * p.bg_tiles_x;
  // at half the frame's size level 0's taps of a frame tile lie in it
  p.nested = p.h == 2 * p.lh[0] && p.w == 2 * p.lw[0];
  const int cells = kTile / kCell;
  const int pyr_y = ceil_div(p.lh[0], kPyrTile);
  const int pyr_x = ceil_div(p.lw[0], kPyrTile);
  if (p.nested) {
    p.frame_tiles_x = pyr_x;
    p.n_frame_tiles = pyr_y * pyr_x;
  } else {
    p.frame_tiles_x = ceil_div(p.gw, cells);
    p.n_frame_tiles = ceil_div(p.gh, cells) * p.frame_tiles_x;
    p.pyr_tiles_x = pyr_x;
    p.n_pyr_tiles = pyr_y * pyr_x;
  }
  static bool smem_set = false;
  if (!smem_set) {
    const cudaError_t e = cudaFuncSetAttribute(
        preprocess_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        kSmemBytes);
    if (e != cudaSuccess) return static_cast<int>(e);
    smem_set = true;
  }
  const dim3 grid(p.n_bg_tiles + p.n_frame_tiles + p.n_pyr_tiles,
                  p.streams);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  preprocess_kernel<<<grid, kThreads, kSmemBytes, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code flow_preprocess_forward returned
const char* flow_preprocess_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
