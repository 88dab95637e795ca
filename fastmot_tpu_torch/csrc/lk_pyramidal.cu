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
// microsecond at the card's rates. What sets its time is the serial chain of one point: up to 6 levels x (a
// template pass + 10 dependent steps), each step a bilinear window of
// (win+1)^2 gathered taps followed by three 25-term sums, a 2x2 solve and
// the convergence test. At one stream the points fill 56 warps on 132 SMs,
// one warp an SM or less, so nothing hides that latency (chip_smoke.py
// phase 16 prints the times and the bound).
//
// Design, simple and right first: one thread a point, 128 threads a block,
// one instance for the window of 5 that every config uses (the launch
// switch below gains a case when a config needs another window);
// a point's stream is index / P, and level l of stream s starts s*h_l*w_l
// floats into the level's tensor. Each thread runs the per-point loop
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
// point before its own step cap does. The taps are read straight from
// device memory (a level is at most 0.9 MB a stream at 1280x720, and the
// pyramids stay in the 50 MB L2); the template, its gradients and the
// point's state stay in registers.
//
// Numerics: bit for bit the plain version's float32 arithmetic on the CPU.
// Every product, sum and quotient is rounded on its own (__fmul_rn,
// __fadd_rn, __fdiv_rn, __fsqrt_rn: no FMA contraction), in the plain
// version's order, and the window sums take the order of PyTorch's CPU sum
// over a contiguous row (row_sum below). The samples keep _sample_halo's
// choices: x and y clamped to [0, w-1.001] and [0, h-1.001], the floor as
// anchor, taps edge-clamped, the blend (1-fy)(1-fx)p00 + (1-fy)fx p01 +
// fy(1-fx)p10 + fy fx p11; central differences x0.5; the gate
// min_eig / win^2 > 1e-4; det > 1e-12 ? det : 1.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxLevels = 12;   // LK_KERNEL_MAX_LEVELS in flow_kernels.py
constexpr int kThreads = 128;

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
lk_kernel(const Levels lv, int n_levels, const float2* __restrict__ pts,
          const uint8_t* __restrict__ valid, float2* __restrict__ new_pts,
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

}  // namespace

extern "C" {

// Tracks n_streams x per_stream points (pts [S, P, 2] float32, valid
// [S, P] one byte each) from the previous to the current pyramid: prev[l]
// and cur[l] point at level l's [S, h, w] float32 tensors, finest first,
// with hw = (h_0, w_0, h_1, w_1, ...). Writes new_pts [S, P, 2], status
// [S, P] (one byte) and err [S, P] with one launch on `stream`. Returns 0
// or a cudaError_t.
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
  Levels lv = {};
  for (int l = 0; l < n_levels; ++l) {
    lv.prev[l] = static_cast<const float*>(prev[l]);
    lv.cur[l] = static_cast<const float*>(cur[l]);
    lv.h[l] = hw[2 * l];
    lv.w[l] = hw[2 * l + 1];
    if (lv.h[l] < 1 || lv.w[l] < 1)
      return static_cast<int>(cudaErrorInvalidValue);
    lv.x_max[l] = static_cast<float>(lv.w[l] - 1.001);
    lv.y_max[l] = static_cast<float>(lv.h[l] - 1.001);
  }
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
      lk_kernel<W><<<grid, kThreads, 0, s>>>(lv, n_levels, p, v, np, st, \
                                              e, static_cast<int>(n),     \
                                              per_stream, iters);         \
      break;
    // LK_KERNEL_WIN in flow_kernels.py
    LK_LAUNCH(5)
#undef LK_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

const char* lk_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
