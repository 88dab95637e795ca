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
// What bounds it on an H100: bytes. A 1280x720 stream reads its 2.76 MB
// frame and writes the two pyramids (307,100 floats each) and the
// candidates, about 5.4 MB: 1.6 us at 3.35 TB/s. The arithmetic (gray,
// the two resizes, the 3x3 gradient sums and the eigenvalue) is a few
// dozen operations a pixel, under a microsecond at the card's float32
// rate. The design keeps every intermediate out of device memory: gray,
// the gradients, the products and the response live in shared memory
// only, and each block reads its part of the frame once (its halo aside).
// One launch, three roles side by side (blockIdx.x; blockIdx.y is the
// stream), the longest first:
//
// - bg role: a tile of 4 x 8 background cells (16 x 32 px of the bg
//   image). It resizes its pixels and a 2-px halo from the frame (gray
//   from BGR at each tap), then the Shi-Tomasi response and the grid, as
//   the full-resolution role does.
// - full-resolution role: a tile of 4 x 8 cells of 8 px (32 x 64 px). It
//   stages gray over the tile and a 2-px halo (36 x 68) in shared memory,
//   then the central differences ix, iy over a 1-px halo, then each
//   pixel's 3x3 box sums of ix*ix, iy*iy, ix*iy and its response, then
//   each cell's first row-major maximum: a thread a cell row, then a
//   thread a cell over its rows.
// - pyramid role: a 32 x 32 tile of level 0 (64 x 64 px of the frame at
//   the flow scale of 0.5), which nests down to one pixel of level 5. It
//   resizes level 0 from the frame, then each level from the one before
//   in shared memory, writing each level and its uint8 rounding. A level
//   keeps floor(h / 2) rows, as downsample2 truncates.
//
// Every loop strides over its items by blockDim.x, and every dependency
// between threads passes a __syncthreads: the result does not depend on
// the block's thread count (the tests' host build runs the blocks with a
// few host threads), nor on the stream count.
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
constexpr int kMaxLevels = 6;     // a kPyrTile tile of level 0 nests to 1 px
constexpr int kPyrTile = 32;
constexpr int kCell = 8;          // CELL in ops/flow_kernels.py
constexpr int kBgCell = 4;        // BG_CELL
constexpr int kTileCellsY = 4;    // a Shi-Tomasi tile's cells, both roles
constexpr int kTileCellsX = 8;

// flow_preprocess_forward's `ints`, in this order (ops/flow_kernels.py
// preprocess_launch_args lists them): sizes, then the offsets (in floats, into `out`) of each level, each uint8 level, the
// candidates and the bg candidates.
enum Int {
  kStreams, kHeight, kWidth, kLevels, kOptH, kOptW, kBgH, kBgW, kOffPyr, kOffPyrU8 = kOffPyr + kMaxLevels,
  kOffCandPts = kOffPyrU8 + kMaxLevels, kOffCandScore, kOffBgPts,
  kOffBgScore, kNumInts
};

struct Params {
  const uint8_t* frames;
  float* out;
  int streams, h, w, levels;
  int lh[kMaxLevels], lw[kMaxLevels];
  int bg_h, bg_w;
  int gh, gw, bg_gh, bg_gw;           // the two candidate grids
  int n_bg_tiles, n_full_tiles, n_pyr_tiles;
  int bg_tiles_x, full_tiles_x, pyr_tiles_x;
  long long off_pyr[kMaxLevels], off_u8[kMaxLevels];
  long long off_cand_pts, off_cand_score, off_bg_pts, off_bg_score;
  float bg_scale_x, bg_scale_y;
};

// One output coordinate's two taps and weights along an axis of the
// bilinear resize from `in` to `out` samples (flow_kernels.py _taps)
struct Tap {
  int i0, i1;
  float w0, w1;
};

__device__ __forceinline__ Tap resize_tap(int d, int in, int out) {
  Tap t;
  const float scale = static_cast<float>(in) / static_cast<float>(out);
  float src = fmaf(scale, static_cast<float>(d) + 0.5f, -0.5f);
  if (src < 0.f) src = 0.f;
  t.i0 = min(static_cast<int>(floorf(src)), in - 1);
  t.w1 = fminf(fmaxf(src - static_cast<float>(t.i0), 0.f), 1.f);
  t.i1 = t.i0 + (t.i0 < in - 1 ? 1 : 0);
  t.w0 = 1.f - t.w1;
  return t;
}

// OpenCV's BGR2GRAY weights, as the plain version rounds them
__device__ __forceinline__ float gray_at(const uint8_t* frame, int w, int y,
                                         int x) {
  const uint8_t* p = frame + (static_cast<size_t>(y) * w + x) * 3;
  return (static_cast<float>(p[2]) * 0.299f
          + static_cast<float>(p[1]) * 0.587f)
      + static_cast<float>(p[0]) * 0.114f;
}

// The resize of gray at output (y, x), gray read from the frame at the
// four taps
__device__ __forceinline__ float resized_gray(const uint8_t* frame, int h,
                                              int w, int out_h, int out_w,
                                              int y, int x) {
  const Tap ty = resize_tap(y, h, out_h);
  const Tap tx = resize_tap(x, w, out_w);
  const float g00 = gray_at(frame, w, ty.i0, tx.i0);
  const float g01 = gray_at(frame, w, ty.i0, tx.i1);
  const float g10 = gray_at(frame, w, ty.i1, tx.i0);
  const float g11 = gray_at(frame, w, ty.i1, tx.i1);
  const float t0 = g00 * tx.w0 + g01 * tx.w1;
  const float t1 = g10 * tx.w0 + g11 * tx.w1;
  return t0 * ty.w0 + t1 * ty.w1;
}

__device__ __forceinline__ float u8_value(float v) {
  return fminf(fmaxf(rintf(v), 0.f), 255.f);
}

// The image a Shi-Tomasi tile reads: gray at full resolution, or the bg
// resize of gray
struct FullSource {
  const uint8_t* frame;
  int w;
  __device__ float operator()(int y, int x) const {
    return gray_at(frame, w, y, x);
  }
};
struct BgSource {
  const uint8_t* frame;
  int h, w, bg_h, bg_w;
  __device__ float operator()(int y, int x) const {
    return resized_gray(frame, h, w, bg_h, bg_w, y, x);
  }
};

// Shared memory of a Shi-Tomasi tile of kRows x kCols px: the image over
// the tile and a 2-px halo, then the gradients over a 1-px halo. The
// response reuses the image's space, the cell rows' maxima the gradients'.
template <int kRows, int kCols>
struct StTile {
  static constexpr int kGw = kCols + 4, kGh = kRows + 4;
  static constexpr int kDw = kCols + 2, kDh = kRows + 2;
  static constexpr int kFloats = kGw * kGh + 2 * kDw * kDh;
};
using FullTile = StTile<kTileCellsY * kCell, kTileCellsX * kCell>;
using BgTile = StTile<kTileCellsY * kBgCell, kTileCellsX * kBgCell>;
constexpr int cmax(int a, int b) { return a > b ? a : b; }
constexpr int kSmemFloats = cmax(cmax(FullTile::kFloats, BgTile::kFloats),
                                 kPyrTile * kPyrTile
                                 + kPyrTile * kPyrTile / 4);

// One tile of Shi-Tomasi responses and its cells' candidates: cells
// (cy0.., cx0..) of `cell` px of an img_h x img_w image, written as points
// (x, y) / (sx, sy) and scores into pts and score ([gh * gw] row-major
// cells of this stream). shi_tomasi_response and grid_candidates of the
// plain version, with the same zeros at the edges: ix is 0 in the first
// and last column, iy in the first and last row, and the box sums pad the
// products with 0 outside the image.
template <int kCellPx, class Source>
__device__ void st_tile(const Source& src, int img_h, int img_w, int cy0,
                        int cx0, int gh, int gw, float sx, float sy,
                        bool divide, float* pts, float* score, float* sm) {
  constexpr int kRows = kTileCellsY * kCellPx, kCols = kTileCellsX * kCellPx;
  using Tile = StTile<kRows, kCols>;
  constexpr int kGw = Tile::kGw, kDw = Tile::kDw;
  float* g = sm;
  float* ix = sm + Tile::kGw * Tile::kGh;
  float* iy = ix + Tile::kDw * Tile::kDh;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int py0 = cy0 * kCellPx, px0 = cx0 * kCellPx;
  for (int i = tid; i < Tile::kGw * Tile::kGh; i += nt) {
    const int y = py0 - 2 + i / kGw, x = px0 - 2 + i % kGw;
    g[i] = (y >= 0 && y < img_h && x >= 0 && x < img_w) ? src(y, x) : 0.f;
  }
  __syncthreads();
  for (int i = tid; i < Tile::kDw * Tile::kDh; i += nt) {
    const int ly = i / kDw, lx = i % kDw;
    const int y = py0 - 1 + ly, x = px0 - 1 + lx;
    const int gi = (ly + 1) * kGw + lx + 1;
    const bool row_in = y >= 0 && y < img_h, col_in = x >= 0 && x < img_w;
    ix[i] = (row_in && x >= 1 && x <= img_w - 2)
        ? (g[gi + 1] - g[gi - 1]) * 0.5f : 0.f;
    iy[i] = (col_in && y >= 1 && y <= img_h - 2)
        ? (g[gi + kGw] - g[gi - kGw]) * 0.5f : 0.f;
  }
  __syncthreads();
  float* resp = g;               // the image is no longer read
  for (int i = tid; i < kRows * kCols; i += nt) {
    const int ly = i / kCols, lx = i % kCols;
    float sxx[3], syy[3], sxy[3];
    for (int c = 0; c < 3; ++c) {
      float xx[3], yy[3], xy[3];
      for (int r = 0; r < 3; ++r) {
        const int di = (ly + r) * kDw + lx + c;
        xx[r] = ix[di] * ix[di];
        yy[r] = iy[di] * iy[di];
        xy[r] = ix[di] * iy[di];
      }
      sxx[c] = (xx[0] + xx[1]) + xx[2];
      syy[c] = (yy[0] + yy[1]) + yy[2];
      sxy[c] = (xy[0] + xy[1]) + xy[2];
    }
    const float a = (sxx[0] + sxx[1]) + sxx[2];
    const float b = (syy[0] + syy[1]) + syy[2];
    const float c = (sxy[0] + sxy[1]) + sxy[2];
    const float d = a - b;
    const float det = sqrtf(fmaxf(d * d + 4.f * (c * c), 0.f));
    resp[i] = 0.5f * ((a + b) - det);
  }
  __syncthreads();
  // each cell row's first maximum, then each cell's over its rows
  constexpr int kTileCells = kTileCellsY * kTileCellsX;
  float* row_best = ix;          // the gradients are no longer read
  int* row_col = reinterpret_cast<int*>(iy);
  for (int i = tid; i < kTileCells * kCellPx; i += nt) {
    const int cell = i / kCellPx, rr = i % kCellPx;
    const float* row = resp + ((cell / kTileCellsX) * kCellPx + rr) * kCols
        + (cell % kTileCellsX) * kCellPx;
    float best = row[0];
    int col = 0;
    for (int k = 1; k < kCellPx; ++k) {
      if (row[k] > best) {
        best = row[k];
        col = k;
      }
    }
    row_best[i] = best;
    row_col[i] = col;
  }
  __syncthreads();
  for (int cell = tid; cell < kTileCells; cell += nt) {
    const int gy = cy0 + cell / kTileCellsX, gx = cx0 + cell % kTileCellsX;
    if (gy >= gh || gx >= gw) continue;
    float best = row_best[cell * kCellPx];
    int rr = 0, col = row_col[cell * kCellPx];
    for (int r = 1; r < kCellPx; ++r) {
      if (row_best[cell * kCellPx + r] > best) {
        best = row_best[cell * kCellPx + r];
        rr = r;
        col = row_col[cell * kCellPx + r];
      }
    }
    const int c = gy * gw + gx;
    float x = static_cast<float>(gx * kCellPx + col);
    float y = static_cast<float>(gy * kCellPx + rr);
    if (divide) {
      x = x / sx;
      y = y / sy;
    }
    pts[2 * c] = x;
    pts[2 * c + 1] = y;
    score[c] = best;
  }
}

// A 32 x 32 tile of level 0 and the tiles of every coarser level nested in
// it, each written as it is and rounded to uint8
__device__ void pyramid_tile(const Params& p, int s, int tile, float* sm) {
  const uint8_t* frame = p.frames + static_cast<size_t>(s) * p.h * p.w * 3;
  const int ty = tile / p.pyr_tiles_x, tx = tile % p.pyr_tiles_x;
  const int tid = threadIdx.x, nt = blockDim.x;
  float* cur = sm;
  float* nxt = sm + kPyrTile * kPyrTile;
  {
    const int h = p.lh[0], w = p.lw[0];
    float* lvl = p.out + p.off_pyr[0] + static_cast<size_t>(s) * h * w;
    float* u8 = p.out + p.off_u8[0] + static_cast<size_t>(s) * h * w;
    for (int i = tid; i < kPyrTile * kPyrTile; i += nt) {
      const int y = ty * kPyrTile + i / kPyrTile;
      const int x = tx * kPyrTile + i % kPyrTile;
      if (y >= h || x >= w) continue;
      const float v = resized_gray(frame, p.h, p.w, h, w, y, x);
      cur[i] = v;
      lvl[static_cast<size_t>(y) * w + x] = v;
      u8[static_cast<size_t>(y) * w + x] = u8_value(v);
    }
  }
  __syncthreads();
  for (int l = 1; l < p.levels; ++l) {
    const int n = kPyrTile >> l, m = 2 * n;        // this level's, the last
    const int h = p.lh[l], w = p.lw[l];
    float* lvl = p.out + p.off_pyr[l] + static_cast<size_t>(s) * h * w;
    float* u8 = p.out + p.off_u8[l] + static_cast<size_t>(s) * h * w;
    for (int i = tid; i < n * n; i += nt) {
      const int ly = i / n, lx = i % n;
      const int y = ty * n + ly, x = tx * n + lx;
      if (y >= h || x >= w) continue;
      const float* top = cur + 2 * ly * m + 2 * lx;
      const float v = ((top[0] + top[1]) + (top[m] + top[m + 1])) * 0.25f;
      nxt[i] = v;
      lvl[static_cast<size_t>(y) * w + x] = v;
      u8[static_cast<size_t>(y) * w + x] = u8_value(v);
    }
    __syncthreads();
    float* t = cur;
    cur = nxt;
    nxt = t;
  }
}

__global__ void __launch_bounds__(kThreads)
preprocess_kernel(const Params p) {
  __shared__ float sm[kSmemFloats];
  const int s = blockIdx.y;
  int b = blockIdx.x;
  const uint8_t* frame = p.frames + static_cast<size_t>(s) * p.h * p.w * 3;
  if (b < p.n_bg_tiles) {
    const BgSource src{frame, p.h, p.w, p.bg_h, p.bg_w};
    const size_t n = static_cast<size_t>(p.bg_gh) * p.bg_gw;
    st_tile<kBgCell>(src, p.bg_h, p.bg_w, (b / p.bg_tiles_x) * kTileCellsY,
                     (b % p.bg_tiles_x) * kTileCellsX, p.bg_gh, p.bg_gw,
                     p.bg_scale_x, p.bg_scale_y, true,
                     p.out + p.off_bg_pts + s * 2 * n,
                     p.out + p.off_bg_score + s * n, sm);
    return;
  }
  b -= p.n_bg_tiles;
  if (b < p.n_full_tiles) {
    const FullSource src{frame, p.w};
    const size_t n = static_cast<size_t>(p.gh) * p.gw;
    st_tile<kCell>(src, p.h, p.w, (b / p.full_tiles_x) * kTileCellsY,
                   (b % p.full_tiles_x) * kTileCellsX, p.gh, p.gw, 1.f, 1.f,
                   false, p.out + p.off_cand_pts + s * 2 * n,
                   p.out + p.off_cand_score + s * n, sm);
    return;
  }
  pyramid_tile(p, s, b - p.n_full_tiles, sm);
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
  p.bg_tiles_x = ceil_div(p.bg_gw, kTileCellsX);
  p.n_bg_tiles = ceil_div(p.bg_gh, kTileCellsY) * p.bg_tiles_x;
  p.full_tiles_x = ceil_div(p.gw, kTileCellsX);
  p.n_full_tiles = ceil_div(p.gh, kTileCellsY) * p.full_tiles_x;
  p.pyr_tiles_x = ceil_div(p.lw[0], kPyrTile);
  p.n_pyr_tiles = ceil_div(p.lh[0], kPyrTile) * p.pyr_tiles_x;
  const dim3 grid(p.n_bg_tiles + p.n_full_tiles + p.n_pyr_tiles,
                  p.streams);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  preprocess_kernel<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code flow_preprocess_forward returned
const char* flow_preprocess_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
