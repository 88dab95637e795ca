// Pyramidal Lucas-Kanade in one CUDA kernel launch for Hopper (sm_90a):
// every level and every Gauss-Newton step of every point, no host sync.
//
// Replaces fastmot_tpu/ops/flow_kernels.py:313 lk_pyramidal. That is not a
// Pallas kernel but a lax.while_loop (:485) that XLA lowers into one device
// program inside the jitted gap chain. Its plain PyTorch twin is
// lk_pyramidal_reference in fastmot_tpu_torch/ops/flow_kernels.py, which
// runs the same loop in lockstep over all points and ends each step in a
// host sync; the wrapper lk_pyramidal there checks the arguments and
// launches this kernel.
//
// What bounds it on an H100. Not bytes and not operations: at the main
// path's 1,792 points a frame (48 tracks x 32 keypoints + 256 background
// points) the taps the points touch (at most both pyramids, 2.5 MB) and
// the arithmetic (about 30 MFLOP for some 60,000 steps) take under a
// microsecond at the card's rates. What sets its time is the serial chain
// of one point: up to 6 levels x (a template pass + 10 dependent steps),
// each step a bilinear window of (win+1)^2 gathered taps followed by three
// 25-term sums, a 2x2 solve and the convergence test (chip_smoke.py phase
// 16 prints the times and the bound).
//
// Design: a tile of kTileLanes (G) lanes a point, 16 points a block. For
// the window of 5 the 25-term sums (row_sum below) are 8 lane partials
// x[k] + x[8+k] + x[16+k] and the serial tail x[24], p_0, ..., p_7, so
// lane k of a tile owns the sum lanes k, k+G, ... (8 / G of them) and the
// window elements in them; every lane also computes element 24. For the
// elements it owns a lane samples the template halo and the step window,
// forms tp, gx, gy, the difference and the products, and its partials;
// eight shuffles within the tile (mask and width of the tile: the tiles
// of a warp run different step counts) hand every lane all partials, and
// every lane adds the same tail in the same order. So all lanes of a tile
// hold the same sums, take the same solve, gate and convergence test, and
// never diverge; lane 0 writes the point's results. At the start of a
// level a tile stages in shared memory the template halo's 8x8 taps and
// the 16x16 taps of the current level around its first window (5 px each
// way), its lanes a column each, coalesced; a step reads its 6x6 window
// from there while it stays inside, from the image otherwise. At one
// stream the 1,792 points fill 112 blocks of the 132 SMs (the one-thread
// design filled 14), and a step's chain is a few elements' samples from
// shared memory, 8 shuffles and 9 adds per sum instead of 36 gathered taps
// and three 25-term sums on one thread. The cost is instructions: a lane
// repeats the point's scalar work (anchor, tails, solve), so a warp spends
// each instruction of it on G times fewer points than the one-thread
// kernel, and where the card is full (8 streams) the tile kernel is the
// slower. G = 8 was kept over G = 4, which halves that repetition but
// lengthens each lane's chain (PERF.md section 6 has both timed). Tensor
// cores, TMA and texture filtering do not apply: the work is 25-term dot
// products and a 2x2 solve, a step reads a 6x6 window (144 B) at a
// data-dependent address, and the texture unit's 8-bit fractional weights
// would not round as the plain version does.
//
// The first design, one thread a point in blocks of 128, stays beside it
// as lk_pyramidal_forward_per_thread, for the calls whose points fill the
// card: the wrapper lk_pyramidal in flow_kernels.py launches it from 80
// points an SM on (lk_design) and the tile kernel below that.
//
// Both run the per-point loop
//
//   v = 0; err = 0; ok = valid
//   for lvl = L-1 .. 0:
//     p = pts * 2^-lvl
//     template halo from prev[lvl] -> gx, gy, G, min-eig gate, det_safe
//     active = valid; steps = 0
//     while active:
//       window at p + v from cur[lvl]; err = mean|diff|
//       step = clamp(G^-1 b, +-win); if gate: v += step
//       steps += 1; active = gate && |step|^2 >= 0.03^2 && steps < iters
//     ok &= gate; if lvl > 0: v *= 2
//   new_pts = pts + v; status = ok && new_pts inside level 0
//
// which gives every point what the lockstep loop gives it: a level of the
// lockstep loop ends only when no point is active, and an active point has
// taken as many steps as there were trips, so the trip cap never stops a
// point before its own step cap does. A point's stream is index / P, and
// level l of stream s starts s*h_l*w_l floats into the level's tensor, so
// a block may hold points of two streams. The taps come from device
// memory (a level is at most 0.9 MB a stream at 1280x720, and the
// pyramids stay in the 50 MB L2); the template, its gradients and the
// point's state stay in registers. The error, the mean |diff| of a
// point's last step, is summed once a level from that step's differences
// in the tile kernel, every step in the one-thread kernel.
//
// Numerics: bit for bit the plain version's float32 arithmetic on the CPU.
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), in the plain
// version's order, and the window sums take the order of PyTorch's CPU sum
// over a contiguous row (row_sum below). The samples keep _sample_halo's
// choices: x and y clamped to [0, w-1.001] and [0, h-1.001], the floor as
// anchor, taps edge-clamped, the blend (1-fy)(1-fx)p00 + (1-fy)fx p01 +
// fy(1-fx)p10 + fy fx p11; central differences x0.5; the gate
// min_eig / win^2 > 1e-4; det > 1e-12 ? det : 1. A sample depends only on
// its anchor, weights and taps, so it is the same whichever lane computes
// it.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 12;   // LK_KERNEL_MAX_LEVELS in flow_kernels.py
constexpr int kThreads = 128;    // the one-thread kernel's block
constexpr int kTileLanes = 8;    // G: a point's lanes
constexpr int kTilePoints = 16;  // points a tile kernel block
constexpr int kTileThreads = kTileLanes * kTilePoints;

struct Levels {
  const float* prev[kMaxLevels];
  const float* cur[kMaxLevels];
  int h[kMaxLevels];
  int w[kMaxLevels];
  float x_max[kMaxLevels];   // float(w - 1.001), the samples' clamp
  float y_max[kMaxLevels];
};

// each result rounded on its own: nvcc would contract a * b + c into an FMA
__device__ __forceinline__ float add(float a, float b) {
  return __fadd_rn(a, b);
}
__device__ __forceinline__ float sub(float a, float b) {
  return __fsub_rn(a, b);
}
__device__ __forceinline__ float mul(float a, float b) {
  return __fmul_rn(a, b);
}

// Sum of x[0..N) in the order of PyTorch's CPU sum over a contiguous row
// (aten/src/ATen/native/cpu/SumKernel.cpp, vectorized_inner_sum): the row
// is read as 8-lane vectors, vector i goes to accumulator i % 4 of each
// full group of four and the rest to accumulator 0, the accumulators are
// folded into the first, and the sum is the scalar tail followed by the 8
// lanes. Exact for rows of fewer than 16 groups (N < 512). Eight lanes are
// what ATen's x86 builds sum in, AVX-512 hosts included (sum_stub has no
// AVX-512 kernel and runs the AVX2 one); a build that sums in other lanes
// is only within the LK tolerance of this kernel, and
// tests/test_torch_lk_kernel.py::test_aten_sums_rows_in_the_kernels_order
// says so.
template <int N>
__device__ __forceinline__ float row_sum(const float (&x)[N]) {
  constexpr int kLanes = 8;
  constexpr int kVecs = N / kLanes;
  constexpr int kGroups = kVecs / 4;
  static_assert(kGroups < 16, "PyTorch cascades rows of 16 groups or more");
  float acc[4][kLanes];
#pragma unroll
  for (int g = 0; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[g][k] = 0.f;
#pragma unroll
  for (int i = 0; i < kGroups; ++i)
#pragma unroll
    for (int g = 0; g < 4; ++g)
#pragma unroll
      for (int k = 0; k < kLanes; ++k)
        acc[g][k] = add(acc[g][k], x[(4 * i + g) * kLanes + k]);
#pragma unroll
  for (int j = 4 * kGroups; j < kVecs; ++j)
#pragma unroll
    for (int k = 0; k < kLanes; ++k)
      acc[0][k] = add(acc[0][k], x[j * kLanes + k]);
#pragma unroll
  for (int g = 1; g < 4; ++g)
#pragma unroll
    for (int k = 0; k < kLanes; ++k) acc[0][k] = add(acc[0][k], acc[g][k]);
  float s = 0.f;
#pragma unroll
  for (int t = kVecs * kLanes; t < N; ++t) s = add(s, x[t]);
#pragma unroll
  for (int k = 0; k < kLanes; ++k) s = add(s, acc[0][k]);
  return s;
}

// Rows and columns [LO, HI) of the bilinear halo around (x, y) of one
// image (h x w floats): out[i][j] = sample(y - half - 1 + LO + i,
// x - half - 1 + LO + j), half = (WIN - 1) / 2. The template takes the
// whole halo (LO = 0, HI = WIN + 2), a step only the window (1, WIN + 1).
template <int WIN, int LO, int HI>
__device__ __forceinline__ void sample(const float* __restrict__ img, int h,
                                       int w, float x_max, float y_max,
                                       float x, float y,
                                       float (&out)[HI - LO][HI - LO]) {
  constexpr int kHalf = (WIN - 1) / 2;
  constexpr int kN = HI - LO;
  x = fminf(fmaxf(x, 0.f), x_max);
  y = fminf(fmaxf(y, 0.f), y_max);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = sub(x, x0), fy = sub(y, y0);
  const float gx = sub(1.f, fx), gy = sub(1.f, fy);
  const float w00 = mul(gy, gx), w01 = mul(gy, fx);
  const float w10 = mul(fy, gx), w11 = mul(fy, fx);
  const int c0 = static_cast<int>(x0) - kHalf - 1 + LO;
  const int r0 = static_cast<int>(y0) - kHalf - 1 + LO;
  int cols[kN + 1];
#pragma unroll
  for (int j = 0; j <= kN; ++j) cols[j] = min(max(c0 + j, 0), w - 1);
  float top[kN + 1], bot[kN + 1];
  const float* row = img + static_cast<int64_t>(min(max(r0, 0), h - 1)) * w;
#pragma unroll
  for (int j = 0; j <= kN; ++j) top[j] = __ldg(row + cols[j]);
#pragma unroll
  for (int i = 0; i < kN; ++i) {
    row = img + static_cast<int64_t>(min(max(r0 + i + 1, 0), h - 1)) * w;
#pragma unroll
    for (int j = 0; j <= kN; ++j) bot[j] = __ldg(row + cols[j]);
#pragma unroll
    for (int j = 0; j < kN; ++j)
      out[i][j] = add(add(add(mul(w00, top[j]), mul(w01, top[j + 1])),
                          mul(w10, bot[j])),
                      mul(w11, bot[j + 1]));
#pragma unroll
    for (int j = 0; j <= kN; ++j) top[j] = bot[j];
  }
}

template <int WIN>
__global__ void __launch_bounds__(kThreads)
lk_per_thread_kernel(const Levels lv, int n_levels,
                     const float2* __restrict__ pts,
                     const uint8_t* __restrict__ valid,
                     float2* __restrict__ new_pts,
                     uint8_t* __restrict__ status, float* __restrict__ err_out,
                     int n_points, int per_stream, int iters) {
  constexpr int kWW = WIN * WIN;
  const int idx = blockIdx.x * kThreads + threadIdx.x;
  if (idx >= n_points) return;
  const int64_t s = idx / per_stream;
  const float2 p0 = pts[idx];
  const bool is_valid = valid[idx] != 0;
  const float eps2 = static_cast<float>(0.03 * 0.03);
  float vx = 0.f, vy = 0.f, err = 0.f;
  bool ok = is_valid;
  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    if (is_valid) {
      const int h = lv.h[lvl], w = lv.w[lvl];
      const int64_t base = s * h * w;
      const float scale = ldexpf(1.f, -lvl);
      const float px = mul(p0.x, scale), py = mul(p0.y, scale);

      // template: the window, its central-difference gradients, G
      float t[WIN + 2][WIN + 2];
      sample<WIN, 0, WIN + 2>(lv.prev[lvl] + base, h, w, lv.x_max[lvl],
                              lv.y_max[lvl], px, py, t);
      float tp[kWW], gx[kWW], gy[kWW], prod[kWW];
#pragma unroll
      for (int i = 0; i < WIN; ++i)
#pragma unroll
        for (int j = 0; j < WIN; ++j) {
          tp[i * WIN + j] = t[i + 1][j + 1];
          gx[i * WIN + j] = mul(0.5f, sub(t[i + 1][j + 2], t[i + 1][j]));
          gy[i * WIN + j] = mul(0.5f, sub(t[i + 2][j + 1], t[i][j + 1]));
        }
#pragma unroll
      for (int k = 0; k < kWW; ++k) prod[k] = mul(gx[k], gx[k]);
      const float gxx = row_sum(prod);
#pragma unroll
      for (int k = 0; k < kWW; ++k) prod[k] = mul(gy[k], gy[k]);
      const float gyy = row_sum(prod);
#pragma unroll
      for (int k = 0; k < kWW; ++k) prod[k] = mul(gx[k], gy[k]);
      const float gxy = row_sum(prod);
      const float det = sub(mul(gxx, gyy), mul(gxy, gxy));
      const float d = sub(gxx, gyy);
      const float q = fmaxf(add(mul(d, d), mul(4.f, mul(gxy, gxy))), 0.f);
      const float min_eig = mul(0.5f, sub(add(gxx, gyy), __fsqrt_rn(q)));
      const bool inv_ok = __fdiv_rn(min_eig, static_cast<float>(kWW)) > 1e-4f;
      const float det_safe = det > 1e-12f ? det : 1.f;

      // Gauss-Newton steps until the step is below 0.03 px or the count
      // cap; a gated point takes one step, for its error, and stays put
      bool active = iters > 0;
      int steps = 0;
      while (active) {
        float c[WIN][WIN];
        sample<WIN, 1, WIN + 1>(lv.cur[lvl] + base, h, w, lv.x_max[lvl],
                                lv.y_max[lvl], add(px, vx), add(py, vy), c);
        float diff[kWW];
#pragma unroll
        for (int i = 0; i < WIN; ++i)
#pragma unroll
          for (int j = 0; j < WIN; ++j)
            diff[i * WIN + j] = sub(tp[i * WIN + j], c[i][j]);
#pragma unroll
        for (int k = 0; k < kWW; ++k) prod[k] = fabsf(diff[k]);
        const float e = __fdiv_rn(row_sum(prod), static_cast<float>(kWW));
#pragma unroll
        for (int k = 0; k < kWW; ++k) prod[k] = mul(diff[k], gx[k]);
        const float bx = row_sum(prod);
#pragma unroll
        for (int k = 0; k < kWW; ++k) prod[k] = mul(diff[k], gy[k]);
        const float by = row_sum(prod);
        const float dx = __fdiv_rn(sub(mul(gyy, bx), mul(gxy, by)), det_safe);
        const float dy = __fdiv_rn(sub(mul(gxx, by), mul(gxy, bx)), det_safe);
        const float sx = fminf(fmaxf(dx, -static_cast<float>(WIN)),
                               static_cast<float>(WIN));
        const float sy = fminf(fmaxf(dy, -static_cast<float>(WIN)),
                               static_cast<float>(WIN));
        err = e;
        if (inv_ok) {
          vx = add(vx, sx);
          vy = add(vy, sy);
        }
        ++steps;
        active = inv_ok && add(mul(sx, sx), mul(sy, sy)) >= eps2
                 && steps < iters;
      }
      ok = ok && inv_ok;
    }
    if (lvl > 0) {
      vx = mul(vx, 2.f);
      vy = mul(vy, 2.f);
    }
  }
  const float nx = add(p0.x, vx), ny = add(p0.y, vy);
  new_pts[idx] = make_float2(nx, ny);
  status[idx] = ok && nx >= 0.f && nx <= static_cast<float>(lv.w[0] - 1)
                && ny >= 0.f && ny <= static_cast<float>(lv.h[0] - 1);
  err_out[idx] = err;
}

// The tile kernel's sampling: the anchor and weights of _sample_halo at
// (x, y), and one sample of its halo, rows and columns counted from the
// halo's corner (y0 - half - 1, x0 - half - 1) as in sample<WIN, 0, ...>:
// from the image (halo_at) or from taps staged in shared memory (blend:
// t[0], t[1], t[stride], t[stride + 1] the four taps).
struct Anchor {
  int r0, c0;
  float w00, w01, w10, w11;
};

template <int WIN>
__device__ __forceinline__ Anchor anchor_at(float x, float y, float x_max,
                                            float y_max) {
  constexpr int kHalf = (WIN - 1) / 2;
  x = fminf(fmaxf(x, 0.f), x_max);
  y = fminf(fmaxf(y, 0.f), y_max);
  const float x0 = floorf(x), y0 = floorf(y);
  const float fx = sub(x, x0), fy = sub(y, y0);
  const float gx = sub(1.f, fx), gy = sub(1.f, fy);
  return {static_cast<int>(y0) - kHalf - 1, static_cast<int>(x0) - kHalf - 1,
          mul(gy, gx), mul(gy, fx), mul(fy, gx), mul(fy, fx)};
}

__device__ __forceinline__ float blend(const float* t, int stride,
                                       const Anchor& an) {
  return add(add(add(mul(an.w00, t[0]), mul(an.w01, t[1])),
                 mul(an.w10, t[stride])),
             mul(an.w11, t[stride + 1]));
}

__device__ __forceinline__ float halo_at(const float* __restrict__ img,
                                         int h, int w, const Anchor& an,
                                         int a, int b) {
  const int cl = min(max(an.c0 + b, 0), w - 1);
  const int cr = min(max(an.c0 + b + 1, 0), w - 1);
  const float* top = img + static_cast<int64_t>(min(max(an.r0 + a, 0),
                                                    h - 1)) * w;
  const float* bot = img + static_cast<int64_t>(min(max(an.r0 + a + 1, 0),
                                                    h - 1)) * w;
  return add(add(add(mul(an.w00, __ldg(top + cl)),
                     mul(an.w01, __ldg(top + cr))),
                 mul(an.w10, __ldg(bot + cl))),
             mul(an.w11, __ldg(bot + cr)));
}

// Copies the kRows x kCols taps img[clamp(r0 + r)][clamp(c0 + c)] into
// out[r * kCols + c], the tile's G lanes a column each in turn.
template <int kRows, int kCols, int G>
__device__ __forceinline__ void stage(const float* __restrict__ img, int h,
                                      int w, int r0, int c0, int lane,
                                      float* out) {
#pragma unroll
  for (int c = 0; c < kCols; c += G) {
    if (c + lane < kCols) {
      const int col = min(max(c0 + c + lane, 0), w - 1);
#pragma unroll
      for (int r = 0; r < kRows; ++r)
        out[r * kCols + c + lane] = __ldg(
            img + static_cast<int64_t>(min(max(r0 + r, 0), h - 1)) * w + col);
    }
  }
}

// row_sum of a window of N < 32 terms spread over a tile of G lanes: slot
// m * kVecs + j of a lane's `own` holds element 8j + lane + mG, `tail` the
// elements 8 kVecs .. N - 1 (on every lane). partials() forms the lane's
// sum lanes' partials as row_sum does, the vectors in order (row_sum then
// adds its three empty accumulators, +0.f each: a partial that starts at
// +0 is never -0, so that is the identity and left out); sum() brings all
// 8 partials to every lane with the tile's shuffles and adds the tail and
// then the partials in order: row_sum's result on every lane of the tile.
template <int G, int N>
struct TileSum {
  static constexpr int kVecs = N / 8;
  static constexpr int kTail = N - 8 * kVecs;
  static constexpr int kPer = 8 / G;
  static constexpr int kOwn = kPer * kVecs;
  static_assert(kVecs < 4, "rows of four vectors or more take row_sum's "
                           "group loop");
  static_assert(kTail > 0, "a window of 8k terms has no tail");

  __device__ static __forceinline__ void partials(const float (&own)[kOwn],
                                                  float (&part)[kPer]) {
#pragma unroll
    for (int m = 0; m < kPer; ++m) {
      float a = 0.f;
#pragma unroll
      for (int j = 0; j < kVecs; ++j) a = add(a, own[m * kVecs + j]);
      part[m] = a;
    }
  }

  __device__ static __forceinline__ float sum_of(const float (&part)[kPer],
                                                 const float (&tail)[kTail],
                                                 unsigned mask) {
    float s = 0.f;
#pragma unroll
    for (int t = 0; t < kTail; ++t) s = add(s, tail[t]);
#pragma unroll
    for (int q = 0; q < 8; ++q)
      s = add(s, __shfl_sync(mask, part[q / G], q % G, G));
    return s;
  }

  __device__ static __forceinline__ float sum(const float (&own)[kOwn],
                                              const float (&tail)[kTail],
                                              unsigned mask) {
    float part[kPer];
    partials(own, part);
    return sum_of(part, tail, mask);
  }
};

// Rows and columns of the current level a tile stages around the first
// window of a level: a step reads its window from there while it lies
// within kMargin px of the first, from the image otherwise.
constexpr int kMargin = 5;

template <int WIN, int G>
__global__ void __launch_bounds__(kTilePoints * G)
lk_tile_kernel(const Levels lv, int n_levels, const float2* __restrict__ pts,
               const uint8_t* __restrict__ valid,
               float2* __restrict__ new_pts, uint8_t* __restrict__ status,
               float* __restrict__ err_out, int n_points, int per_stream,
               int iters) {
  constexpr int kWW = WIN * WIN;
  using Sum = TileSum<G, kWW>;
  constexpr int kOwn = Sum::kOwn, kTail = Sum::kTail, kVecs = Sum::kVecs;
  constexpr int kPer = Sum::kPer;
  constexpr int kFirst = 8 * kVecs;      // the tail's first element
  constexpr int kHalo = WIN + 3;         // template taps a side
  constexpr int kSpan = WIN + 1 + 2 * kMargin;   // staged step taps a side
  // a tile's taps; strides of G mod 32 floats put the tiles of a warp on
  // different banks as their lanes store
  constexpr int kHaloStride = kHalo * kHalo + G;
  constexpr int kSpanStride = kSpan * kSpan + G;
  __shared__ float halo_taps[kTilePoints * kHaloStride];
  __shared__ float span_taps[kTilePoints * kSpanStride];
  const int tile = threadIdx.x / G;
  const int idx = blockIdx.x * kTilePoints + tile;
  if (idx >= n_points) return;     // the whole tile: one point
  const int lane = threadIdx.x % G;
  const unsigned mask = ((1u << G) - 1u) << (threadIdx.x % 32 / G * G);
  float* const ht = halo_taps + tile * kHaloStride;
  float* const st = span_taps + tile * kSpanStride;
  // the owned elements: window row and column, their first taps in the
  // template halo's taps and in a window's
  int ei[kOwn], ej[kOwn], eh[kOwn], es[kOwn];
#pragma unroll
  for (int m = 0; m < kPer; ++m)
#pragma unroll
    for (int j = 0; j < kVecs; ++j) {
      const int k = m * kVecs + j, e = 8 * j + lane + m * G;
      ei[k] = e / WIN;
      ej[k] = e % WIN;
      eh[k] = ei[k] * kHalo + ej[k];
      es[k] = ei[k] * kSpan + ej[k];
    }
  const int64_t s = idx / per_stream;
  const float2 p0 = pts[idx];
  const bool is_valid = valid[idx] != 0;
  const float eps2 = static_cast<float>(0.03 * 0.03);
  float vx = 0.f, vy = 0.f, err = 0.f;
  bool ok = is_valid;
  for (int lvl = n_levels - 1; lvl >= 0; --lvl) {
    if (is_valid) {
      const int h = lv.h[lvl], w = lv.w[lvl];
      const int64_t base = s * h * w;
      const float scale = ldexpf(1.f, -lvl);
      const float px = mul(p0.x, scale), py = mul(p0.y, scale);
      const float* cur = lv.cur[lvl] + base;

      // stage the template halo's taps and the current level around the
      // first window (the lanes of the last level are done reading)
      const Anchor at = anchor_at<WIN>(px, py, lv.x_max[lvl], lv.y_max[lvl]);
      const Anchor a0 = anchor_at<WIN>(add(px, vx), add(py, vy),
                                       lv.x_max[lvl], lv.y_max[lvl]);
      __syncwarp(mask);
      stage<kHalo, kHalo, G>(lv.prev[lvl] + base, h, w, at.r0, at.c0, lane,
                             ht);
      stage<kSpan, kSpan, G>(cur, h, w, a0.r0 + 1 - kMargin,
                             a0.c0 + 1 - kMargin, lane, st);
      __syncwarp(mask);

      // template: the owned window elements, their central-difference
      // gradients, G; halo sample (a, b) is blend(ht + a * kHalo + b)
      const auto tmpl = [&](int o, float& t, float& dx, float& dy) {
        const float* c = ht + o;
        t = blend(c + kHalo + 1, kHalo, at);
        dx = mul(0.5f, sub(blend(c + kHalo + 2, kHalo, at),
                           blend(c + kHalo, kHalo, at)));
        dy = mul(0.5f, sub(blend(c + 2 * kHalo + 1, kHalo, at),
                           blend(c + 1, kHalo, at)));
      };
      float tp[kOwn], gx[kOwn], gy[kOwn], prod[kOwn];
      float tpt[kTail], gxt[kTail], gyt[kTail], prodt[kTail];
#pragma unroll
      for (int k = 0; k < kOwn; ++k) tmpl(eh[k], tp[k], gx[k], gy[k]);
#pragma unroll
      for (int k = 0; k < kTail; ++k)
        tmpl((kFirst + k) / WIN * kHalo + (kFirst + k) % WIN, tpt[k], gxt[k],
             gyt[k]);
#pragma unroll
      for (int k = 0; k < kOwn; ++k) prod[k] = mul(gx[k], gx[k]);
#pragma unroll
      for (int k = 0; k < kTail; ++k) prodt[k] = mul(gxt[k], gxt[k]);
      const float gxx = Sum::sum(prod, prodt, mask);
#pragma unroll
      for (int k = 0; k < kOwn; ++k) prod[k] = mul(gy[k], gy[k]);
#pragma unroll
      for (int k = 0; k < kTail; ++k) prodt[k] = mul(gyt[k], gyt[k]);
      const float gyy = Sum::sum(prod, prodt, mask);
#pragma unroll
      for (int k = 0; k < kOwn; ++k) prod[k] = mul(gx[k], gy[k]);
#pragma unroll
      for (int k = 0; k < kTail; ++k) prodt[k] = mul(gxt[k], gyt[k]);
      const float gxy = Sum::sum(prod, prodt, mask);
      const float det = sub(mul(gxx, gyy), mul(gxy, gxy));
      const float d = sub(gxx, gyy);
      const float q = fmaxf(add(mul(d, d), mul(4.f, mul(gxy, gxy))), 0.f);
      const float min_eig = mul(0.5f, sub(add(gxx, gyy), __fsqrt_rn(q)));
      const bool inv_ok = __fdiv_rn(min_eig, static_cast<float>(kWW)) > 1e-4f;
      const float det_safe = det > 1e-12f ? det : 1.f;

      // Gauss-Newton steps, the whole tile together: every lane holds the
      // same sums, so `active` is the same on every lane. The error is
      // kept from the last step: its |diff| partials, summed after the loop
      bool active = iters > 0;
      int steps = 0;
      float abs_part[kPer], abs_tail[kTail];
      while (active) {
        const Anchor ac = anchor_at<WIN>(add(px, vx), add(py, vy),
                                         lv.x_max[lvl], lv.y_max[lvl]);
        // the window's first tap in the staged taps
        const int dr = ac.r0 - a0.r0 + kMargin, dc = ac.c0 - a0.c0 + kMargin;
        float diff[kOwn], difft[kTail];
        if (dr >= 0 && dr <= 2 * kMargin && dc >= 0 && dc <= 2 * kMargin) {
          const float* c = st + dr * kSpan + dc;
#pragma unroll
          for (int k = 0; k < kOwn; ++k)
            diff[k] = sub(tp[k], blend(c + es[k], kSpan, ac));
#pragma unroll
          for (int k = 0; k < kTail; ++k)
            difft[k] = sub(tpt[k], blend(c + (kFirst + k) / WIN * kSpan
                                         + (kFirst + k) % WIN, kSpan, ac));
        } else {
#pragma unroll
          for (int k = 0; k < kOwn; ++k)
            diff[k] = sub(tp[k], halo_at(cur, h, w, ac, ei[k] + 1, ej[k] + 1));
#pragma unroll
          for (int k = 0; k < kTail; ++k)
            difft[k] = sub(tpt[k], halo_at(cur, h, w, ac,
                                           (kFirst + k) / WIN + 1,
                                           (kFirst + k) % WIN + 1));
        }
#pragma unroll
        for (int k = 0; k < kOwn; ++k) prod[k] = fabsf(diff[k]);
        Sum::partials(prod, abs_part);
#pragma unroll
        for (int k = 0; k < kTail; ++k) abs_tail[k] = fabsf(difft[k]);
#pragma unroll
        for (int k = 0; k < kOwn; ++k) prod[k] = mul(diff[k], gx[k]);
#pragma unroll
        for (int k = 0; k < kTail; ++k) prodt[k] = mul(difft[k], gxt[k]);
        const float bx = Sum::sum(prod, prodt, mask);
#pragma unroll
        for (int k = 0; k < kOwn; ++k) prod[k] = mul(diff[k], gy[k]);
#pragma unroll
        for (int k = 0; k < kTail; ++k) prodt[k] = mul(difft[k], gyt[k]);
        const float by = Sum::sum(prod, prodt, mask);
        const float dx = __fdiv_rn(sub(mul(gyy, bx), mul(gxy, by)), det_safe);
        const float dy = __fdiv_rn(sub(mul(gxx, by), mul(gxy, bx)), det_safe);
        const float sx = fminf(fmaxf(dx, -static_cast<float>(WIN)),
                               static_cast<float>(WIN));
        const float sy = fminf(fmaxf(dy, -static_cast<float>(WIN)),
                               static_cast<float>(WIN));
        if (inv_ok) {
          vx = add(vx, sx);
          vy = add(vy, sy);
        }
        ++steps;
        active = inv_ok && add(mul(sx, sx), mul(sy, sy)) >= eps2
                 && steps < iters;
      }
      if (steps > 0)
        err = __fdiv_rn(Sum::sum_of(abs_part, abs_tail, mask),
                        static_cast<float>(kWW));
      ok = ok && inv_ok;
    }
    if (lvl > 0) {
      vx = mul(vx, 2.f);
      vy = mul(vy, 2.f);
    }
  }
  if (lane != 0) return;
  const float nx = add(p0.x, vx), ny = add(p0.y, vy);
  new_pts[idx] = make_float2(nx, ny);
  status[idx] = ok && nx >= 0.f && nx <= static_cast<float>(lv.w[0] - 1)
                && ny >= 0.f && ny <= static_cast<float>(lv.h[0] - 1);
  err_out[idx] = err;
}

// One call's level table from the C entries' arguments; 0 or a cudaError_t.
int fill_levels(Levels* lv, const void* const* prev, const void* const* cur,
                const int* hw, int n_levels) {
  *lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv->prev[l] = static_cast<const float*>(prev[l]);
    lv->cur[l] = static_cast<const float*>(cur[l]);
    lv->h[l] = hw[2 * l];
    lv->w[l] = hw[2 * l + 1];
    if (lv->h[l] < 1 || lv->w[l] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    lv->x_max[l] = static_cast<float>(lv->w[l] - 1.001);
    lv->y_max[l] = static_cast<float>(lv->h[l] - 1.001);
  }
  return 0;
}

}  // namespace

extern "C" {

// Tracks n_streams x per_stream points (pts [S, P, 2] float32, valid
// [S, P] one byte each) from the previous to the current pyramid: prev[l]
// and cur[l] point at level l's [S, h, w] float32 tensors, finest first,
// with hw = (h_0, w_0, h_1, w_1, ...). Writes new_pts [S, P, 2], status
// [S, P] (one byte) and err [S, P] with one launch of the tile kernel on
// `stream`. Returns 0 or a cudaError_t.
int lk_pyramidal_forward(const void* const* prev, const void* const* cur,
                         const int* hw, int n_levels, const void* pts,
                         const void* valid, void* new_pts, void* status,
                         void* err, int n_streams, int per_stream, int win,
                         int iters, void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_streams < 0
      || per_stream < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(n_streams) * per_stream;
  if (n == 0) return 0;
  if (n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  if (const int code = fill_levels(&lv, prev, cur, hw, n_levels)) return code;
  const dim3 grid(static_cast<unsigned>((n + kTilePoints - 1) / kTilePoints));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pts);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* np = static_cast<float2*>(new_pts);
  auto* st = static_cast<uint8_t*>(status);
  auto* e = static_cast<float*>(err);
  switch (win) {
#define LK_LAUNCH(W)                                                      \
    case W:                                                               \
      lk_tile_kernel<W, kTileLanes><<<grid, kTileThreads, 0, s>>>(        \
          lv, n_levels, p, v, np, st, e, static_cast<int>(n), per_stream, \
          iters);                                                         \
      break;
    // LK_KERNEL_WIN in flow_kernels.py
    LK_LAUNCH(5)
#undef LK_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// lk_pyramidal_forward with the one-thread-a-point kernel: the same
// arguments and results.
int lk_pyramidal_forward_per_thread(const void* const* prev,
                                    const void* const* cur, const int* hw,
                                    int n_levels, const void* pts,
                                    const void* valid, void* new_pts,
                                    void* status, void* err, int n_streams,
                                    int per_stream, int win, int iters,
                                    void* stream) {
  if (n_levels < 1 || n_levels > kMaxLevels || n_streams < 0
      || per_stream < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  const int64_t n = static_cast<int64_t>(n_streams) * per_stream;
  if (n == 0) return 0;
  if (n > INT32_MAX) return static_cast<int>(cudaErrorInvalidValue);
  Levels lv;
  if (const int code = fill_levels(&lv, prev, cur, hw, n_levels)) return code;
  const dim3 grid(static_cast<unsigned>((n + kThreads - 1) / kThreads));
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  const auto* p = static_cast<const float2*>(pts);
  const auto* v = static_cast<const uint8_t*>(valid);
  auto* np = static_cast<float2*>(new_pts);
  auto* st = static_cast<uint8_t*>(status);
  auto* e = static_cast<float*>(err);
  switch (win) {
#define LK_LAUNCH(W)                                                      \
    case W:                                                               \
      lk_per_thread_kernel<W><<<grid, kThreads, 0, s>>>(                 \
          lv, n_levels, p, v, np, st, e, static_cast<int>(n), per_stream, \
          iters);                                                         \
      break;
    // LK_KERNEL_WIN in flow_kernels.py
    LK_LAUNCH(5)
#undef LK_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// G, the lanes of a point in the tile kernel, and its points a block
int lk_tile_lanes() { return kTileLanes; }
int lk_tile_points() { return kTilePoints; }

const char* lk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
