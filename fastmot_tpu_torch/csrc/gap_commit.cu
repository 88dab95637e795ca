// The post-LK half of a gap frame in one CUDA kernel launch for Hopper
// (sm_90a): RANSAC draws, homography RANSAC, per-track similarity RANSAC,
// the Kalman warp/predict/update and the commit, for every stream of a
// call, with no host sync.
//
// Replaces fastmot_tpu/tracker.py:264 _gap_commit_core. That is not a
// Pallas kernel but one jitted XLA program (_gap_commit_kernel, :345)
// built from fastmot_tpu/ops/flow_kernels.py flow_post_core (:859),
// ransac_homography (:556) and ransac_similarity (:625), the Kalman
// filter's batched_warp/predict/update (fastmot_tpu/kalman.py) with the
// unrolled Cholesky of fastmot_tpu/ops/smallmat.py, and jax.random's
// threefry draws. Its plain PyTorch twin is gap_commit_core in
// fastmot_tpu_torch/tracker.py (eager: several hundred launches a call
// and a host sync); the wrapper gap_commit in
// fastmot_tpu_torch/ops/gap_commit.py checks the arguments and launches
// this kernel.
//
// What bounds it on an H100. Not bytes and not operations: a stream moves
// about 0.1 MB and does about 3 MFLOP (256 8x8 solves scored on up to 256
// points, f_cap x 64 similarity hypotheses on 32 points, a Kalman step on
// each track slot), microseconds at the card's rates. What sets its time
// is the chain of dependent steps of one block: the hypotheses, the
// arg-max, two refits whose normal equations are sums over all points,
// the per-track rounds, and the Kalman step of one slot, each ended by a
// barrier. The design keeps every step in one block per stream, its data
// in shared memory, and the launch latency (a few microseconds) the only
// overhead (chip_smoke.py phase 17 prints the times and the bound).
//
// Design: one block of 256 threads a stream (so a stream's result never
// depends on how many streams share the launch, and every sum has one
// fixed order).
//   1. Draws: jax.random's threefry-2x32 (20 rounds) in the
//      jax_threefry_partitionable form: PRNGKey(seed) = (0, seed),
//      fold_in(key, d) = threefry(key, (0, d)), split(key, n)[t] =
//      threefry(key, (0, t)), uniform(key, n)[i] from the bits of
//      threefry(key, (0, i)). Each thread draws the uniforms it uses.
//   2. Homography: the background points, their Hartley normalisation and
//      the stable order of the valid points in shared memory; a thread a
//      hypothesis solves its 8x8 normal equations (+1e-8 I) by the
//      Cholesky-Banachiewicz of smallmat.chol (diagonal clamped at 1e-12)
//      and scores all points; the arg-max is the first index of the
//      largest count; two guarded refits, whose 44 sums over the inliers'
//      DLT rows are a thread a point and a fixed tree over the block; h22
//      normalises.
//   3. Similarity: rounds of 8 tracks, a warp a track and a lane a
//      keypoint; the 64 two-point hypotheses two a lane, the first
//      arg-max, two guarded refits through the 4x4 system (+1e-6 I, the
//      same Cholesky; its 8 sums a fixed tree over the warp's lanes); then
//      the box estimate.
//   4. Kalman and commit: a thread a track slot: the slot's place in
//      forder, the warp by H (closed-form Jacobian, J C J^T over its
//      nonzeros), predict, the update through the 4x4 innovation system
//      (Cholesky), the selection by has_klt, IoS against the frame, and
//      the new state's changed fields and the info vector.
// Only __syncthreads orders the phases: the warps of a block never need
// a shuffle, so the host build of the tests runs a block's threads as host
// threads with one barrier.
//
// Numerics. Build with -fmad=false: every product, sum and quotient is
// rounded on its own, as in the g++ build of the tests under
// -ffp-contract=off, so the two builds agree bit for bit. The plain
// version on the CPU solves through LAPACK (Cholesky, LU) and sums in
// ATen's order, JAX through the unrolled Cholesky in XLA's order: this
// kernel takes JAX's solves and its own fixed sum orders, and agrees with
// both within the tolerances of tests/test_torch_gap_commit.py. Rounding
// is rint (half to even), as torch.round and jnp.round.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // a block: one stream
constexpr int kWarps = kThreads / 32;
constexpr int kHypH = 256;         // HYP_H in flow_kernels.py
constexpr int kHypA = 64;          // HYP_A
constexpr int kKp = 32;            // KP_PER_TRACK
constexpr int kMaxBg = 256;        // BG_KP
constexpr int kMaxFlow = 128;      // MAX_FLOW_TRACKS
constexpr int kLaunchStreams = 256;  // seeds a launch carries by value
constexpr float kReproj2 = 9.f;    // RANSAC_REPROJ ** 2

// The pointers of gap_commit_forward's `ptrs`, in this order (as
// gap_commit_launch_args in ops/gap_commit.py lists them): inputs, then
// the new state's written fields and the info.
enum Ptr {
  kMeans, kCovs, kTlbrs, kValid, kAges, kHits, kLostPending, kInl, kKps,
  kKpv, kInside, kFTlbrs, kFValid, kForder, kAllPrev, kAllCur, kStatus,
  kTrans, kAccCov, kFrameTlbr,
  kOutMeans, kOutCovs, kOutTlbrs, kOutValid, kOutLostPending, kOutInl,
  kOutKps, kOutKpv, kInfo
};
// gap_commit_forward's `ints` and `floats`
enum Int {
  kStreams, kTracks, kFlow, kPoints, kInlierThresh, kConfirmHits, kFrameW,
  kFrameH
};
enum Float {
  kAgePenalty, kStdFactorAcc, kStdOffsetAcc, kStdKltW, kStdKltH,
  kMinStdKltW, kMinStdKltH
};

struct Params {
  const float* means;         // [S, T, 8]
  const float* covs;          // [S, T, 8, 8]
  const float* tlbrs;         // [S, T, 4]
  const uint8_t* valid;       // [S, T]
  const int32_t* ages;        // [S, T]
  const int32_t* hits;        // [S, T]
  const uint8_t* lost_pending;  // [S, T]
  const float* inl;           // [S, T]
  const float* kps;           // [S, T, K, 2]
  const uint8_t* kpv;         // [S, T, K]
  const float* inside;        // [S, F, 4]
  const float* f_tlbrs;       // [S, F, 4]
  const uint8_t* f_valid;     // [S, F]
  const int64_t* forder;      // [S, F]
  const float* all_prev;      // [S, P, 2]
  const float* all_cur;       // [S, P, 2]
  const uint8_t* status;      // [S, P]
  const float* trans;         // [8, 8]
  const float* acc_cov;       // [8, 8]
  const float* frame_tlbr;    // [4], the commit's frame
  float* out_means;
  float* out_covs;
  float* out_tlbrs;
  uint8_t* out_valid;
  uint8_t* out_lost_pending;
  float* out_inl;
  float* out_kps;
  uint8_t* out_kpv;
  float* info;                // [S, 10 + 12 T + 5 n_bg]
  int n_tracks, f_cap, n_points, n_bg, inlier_thresh, confirm_hits;
  float frame_x1, frame_y1;   // the flow's frame: (0, 0, W - 1, H - 1)
  float age_penalty, std_factor_acc, std_offset_acc;
  float std_klt[2], min_std_klt[2];
  uint32_t seeds[kLaunchStreams];
};

// ---------------------------------------------------------------------------
// jax.random: threefry-2x32 and uniform
// ---------------------------------------------------------------------------

__device__ __forceinline__ uint32_t rotl(uint32_t x, int r) {
  return (x << r) | (x >> (32 - r));
}

// threefry-2x32 (20 rounds) of the counter (x1, x2) under the key (k1, k2)
__device__ __forceinline__ void threefry(uint32_t k1, uint32_t k2,
                                         uint32_t x1, uint32_t x2,
                                         uint32_t& o1, uint32_t& o2) {
  const uint32_t ks[3] = {k1, k2, k1 ^ k2 ^ 0x1BD11BDAu};
  const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
  uint32_t a = x1 + ks[0], b = x2 + ks[1];
#pragma unroll
  for (int i = 0; i < 5; ++i) {
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      a += b;
      b = rotl(b, rot[i % 2][j]);
      b ^= a;
    }
    a += ks[(i + 1) % 3];
    b += ks[(i + 2) % 3] + static_cast<uint32_t>(i + 1);
  }
  o1 = a;
  o2 = b;
}

// element i of jax.random.uniform(key, (n,)): float32 in [0, 1)
__device__ __forceinline__ float uniform(uint32_t k1, uint32_t k2,
                                         uint32_t i) {
  uint32_t b1, b2;
  threefry(k1, k2, 0u, i, b1, b2);
  return __uint_as_float(((b1 ^ b2) >> 9) | 0x3F800000u) - 1.f;
}

struct Keys {
  uint32_t h1, h2;   // fold_in(PRNGKey(seed), 0): the homography's draws
  uint32_t a1, a2;   // fold_in(PRNGKey(seed), 1): split per track
};

__device__ __forceinline__ Keys stream_keys(uint32_t seed) {
  Keys k;
  threefry(0u, seed, 0u, 0u, k.h1, k.h2);
  threefry(0u, seed, 0u, 1u, k.a1, k.a2);
  return k;
}

// ---------------------------------------------------------------------------
// Small dense algebra (smallmat.chol_solve's order)
// ---------------------------------------------------------------------------

// Solves a x = b for symmetric positive definite a (its lower triangle is
// read) by the unrolled Cholesky-Banachiewicz with the diagonal clamped
// at 1e-12, then forward and back substitution; x overwrites b.
template <int N>
__device__ __forceinline__ void chol_solve(const float (&a)[N][N],
                                           float (&b)[N]) {
  float l[N][N];
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float s = a[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) s = s - l[i][k] * l[j][k];
      l[i][j] = i == j ? sqrtf(s > 1e-12f ? s : 1e-12f) : s / l[j][j];
    }
#pragma unroll
  for (int i = 0; i < N; ++i) {
    float s = b[i];
#pragma unroll
    for (int k = 0; k < i; ++k) s = s - l[i][k] * b[k];
    b[i] = s / l[i][i];
  }
#pragma unroll
  for (int i = N - 1; i >= 0; --i) {
    float s = b[i];
#pragma unroll
    for (int k = i + 1; k < N; ++k) s = s - l[k][i] * b[k];
    b[i] = s / l[i][i];
  }
}

// c = a @ b for 3x3 row-major matrices
__device__ __forceinline__ void mat3(const float* a, const float* b,
                                     float* c) {
#pragma unroll
  for (int i = 0; i < 3; ++i)
#pragma unroll
    for (int j = 0; j < 3; ++j)
      c[3 * i + j] = a[3 * i] * b[j] + a[3 * i + 1] * b[3 + j]
                     + a[3 * i + 2] * b[6 + j];
}

// the pixel homography t2^-1 @ H @ t1 of the normalised solution h8 (h22
// = 1); t1 and t2inv row-major 3x3
__device__ __forceinline__ void denormalise(const float (&h8)[8],
                                            const float* t1,
                                            const float* t2inv,
                                            float (&out)[9]) {
  float h[9], m[9];
#pragma unroll
  for (int i = 0; i < 8; ++i) h[i] = h8[i];
  h[8] = 1.f;
  mat3(t2inv, h, m);
  mat3(m, t1, out);
}

// squared reprojection error of p -> q under the 3x3 h (_apply_h's 1e-9
// guard on the denominator)
__device__ __forceinline__ float h_err2(const float* h, float2 p,
                                        float2 q) {
  float den = h[6] * p.x + h[7] * p.y + h[8];
  den = fabsf(den) > 1e-9f ? den : 1e-9f;
  const float x = (h[0] * p.x + h[1] * p.y + h[2]) / den;
  const float y = (h[3] * p.x + h[4] * p.y + h[5]) / den;
  const float dx = x - q.x, dy = y - q.y;
  return dx * dx + dy * dy;
}

// element j of the two DLT rows of p -> q (j < 9)
__device__ __forceinline__ float dlt1(float2 p, float2 q, int j) {
  switch (j) {
    case 0: return -p.x;
    case 1: return -p.y;
    case 2: return -1.f;
    case 6: return q.x * p.x;
    case 7: return q.x * p.y;
    case 8: return q.x;
    default: return 0.f;
  }
}
__device__ __forceinline__ float dlt2(float2 p, float2 q, int j) {
  switch (j) {
    case 3: return -p.x;
    case 4: return -p.y;
    case 5: return -1.f;
    case 6: return q.y * p.x;
    case 7: return q.y * p.y;
    case 8: return q.y;
    default: return 0.f;
  }
}

// squared error of the similarity (a, b, tx, ty) on p -> q
__device__ __forceinline__ float sim_err2(const float (&s)[4], float2 p,
                                          float2 q) {
  const float ex = s[0] * p.x - s[1] * p.y + s[2] - q.x;
  const float ey = s[1] * p.x + s[0] * p.y + s[3] - q.y;
  return ex * ex + ey * ey;
}

// ---------------------------------------------------------------------------
// Block reductions: a fixed tree over the block's threads
// ---------------------------------------------------------------------------

// every thread gets the sums of v[0..N) over the block's threads
template <int N>
__device__ __forceinline__ void block_sum(float (&v)[N],
                                          float (*scratch)[kThreads]) {
  const int tid = threadIdx.x;
#pragma unroll
  for (int i = 0; i < N; ++i) scratch[i][tid] = v[i];
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s) {
#pragma unroll
      for (int i = 0; i < N; ++i)
        scratch[i][tid] = scratch[i][tid] + scratch[i][tid + s];
    }
    __syncthreads();
  }
#pragma unroll
  for (int i = 0; i < N; ++i) v[i] = scratch[i][0];
  __syncthreads();
}

// the largest v over the block's threads
__device__ __forceinline__ int block_max(int v, int* scratch) {
  const int tid = threadIdx.x;
  scratch[tid] = v;
  __syncthreads();
  for (int s = kThreads / 2; s > 0; s >>= 1) {
    if (tid < s && scratch[tid + s] > scratch[tid])
      scratch[tid] = scratch[tid + s];
    __syncthreads();
  }
  const int out = scratch[0];
  __syncthreads();
  return out;
}

// ---------------------------------------------------------------------------
// The Kalman step of one slot (kalman.warp, predict, update)
// ---------------------------------------------------------------------------

// the nonzero pattern of the warp's Jacobian: per corner, d p2/d p and
// d v2/d v are Dg(p), d v2/d p the second derivative contracted with v
__device__ __forceinline__ constexpr bool jac_nz(int r, int m) {
  return r < 4 ? (m >> 1) == (r >> 1)
               : (m >> 1) == ((r - 4) >> 1) || (m >> 1) == (r >> 1);
}

// warp mean [8] / cov [8][8] in place by the homography h (h22 taken as 1)
__device__ __forceinline__ void kalman_warp(const float* h, float (&mean)[8],
                                            float (&cov)[8][8]) {
  const float a[2][2] = {{h[0], h[1]}, {h[3], h[4]}};
  const float t[2] = {h[2], h[5]};
  const float c[2] = {h[6], h[7]};
  float jac[8][8];
  float out[8];
#pragma unroll
  for (int k = 0; k < 2; ++k) {          // corner: position 2k, velocity 4+2k
    const float px = mean[2 * k], py = mean[2 * k + 1];
    const float vx = mean[4 + 2 * k], vy = mean[5 + 2 * k];
    const float d1 = px * c[0] + py * c[1] + 1.f;
    const float num[2] = {px * a[0][0] + py * a[0][1] + t[0],
                          px * a[1][0] + py * a[1][1] + t[1]};
    const float cv = vx * c[0] + vy * c[1];
    const float d2 = d1 * d1;
    const float d3 = d2 * d1;
    const float av[2] = {vx * a[0][0] + vy * a[0][1],
                         vx * a[1][0] + vy * a[1][1]};
#pragma unroll
    for (int r = 0; r < 2; ++r) {
      out[2 * k + r] = num[r] / d1;
      out[4 + 2 * k + r] = av[r] / d1 - num[r] * cv / d2;
#pragma unroll
      for (int m = 0; m < 2; ++m) {
        const float dg = a[r][m] / d1 - num[r] * c[m] / d2;
        const float dv = -av[r] * c[m] / d2
                         - cv * (a[r][m] / d2 - 2.f * num[r] * c[m] / d3);
        jac[2 * k + r][2 * k + m] = dg;
        jac[4 + 2 * k + r][4 + 2 * k + m] = dg;
        jac[4 + 2 * k + r][2 * k + m] = dv;
      }
    }
  }
  float jc[8][8];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      float s = 0.f;
      bool first = true;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (jac_nz(r, m)) {
          s = first ? jac[r][m] * cov[m][col] : s + jac[r][m] * cov[m][col];
          first = false;
        }
      jc[r][col] = s;
    }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      float s = 0.f;
      bool first = true;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (jac_nz(col, m)) {
          s = first ? jc[r][m] * jac[col][m] : s + jc[r][m] * jac[col][m];
          first = false;
        }
      cov[r][col] = s;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) mean[i] = out[i];
}

__device__ __forceinline__ float box_w(const float (&m)[8]) {
  return m[2] - m[0] + 1.f;
}
__device__ __forceinline__ float box_h(const float (&m)[8]) {
  return m[3] - m[1] + 1.f;
}

// prediction with size-scaled process noise; trans, acc row-major 8x8
__device__ __forceinline__ void kalman_predict(const Params& p,
                                               const float* trans,
                                               const float* acc,
                                               float (&mean)[8],
                                               float (&cov)[8][8]) {
  const float w = box_w(mean), h = box_h(mean);
  const float std = p.std_factor_acc * (w > h ? w : h) + p.std_offset_acc;
  const float var = std * std;
  float m2[8];
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    float s = 0.f;
#pragma unroll
    for (int j = 0; j < 8; ++j) s = s + mean[j] * trans[8 * i + j];
    m2[i] = s;
  }
  float tc[8][8];
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s = s + trans[8 * i + k] * cov[k][j];
      tc[i][j] = s;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      float s = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) s = s + tc[i][k] * trans[8 * j + k];
      cov[i][j] = s + acc[8 * i + j] * var;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i)
#pragma unroll
    for (int j = 0; j < i; ++j) {
      const float v = 0.5f * (cov[i][j] + cov[j][i]);
      cov[i][j] = v;
      cov[j][i] = v;
    }
#pragma unroll
  for (int i = 0; i < 8; ++i) {
    cov[i][i] = 0.5f * (cov[i][i] + cov[i][i]);
    mean[i] = m2[i];
  }
}

// the correction by a flow measurement z [4] at noise multiplier mult
__device__ __forceinline__ void kalman_update(const Params& p,
                                              const float (&z)[4],
                                              float mult, float (&mean)[8],
                                              float (&cov)[8][8]) {
  const float w = box_w(mean), h = box_h(mean);
  float sw = p.std_klt[0] * w, sh = p.std_klt[1] * h;
  sw = (sw > p.min_std_klt[0] ? sw : p.min_std_klt[0]) * mult;
  sh = (sh > p.min_std_klt[1] ? sh : p.min_std_klt[1]) * mult;
  const float var[4] = {sw * sw, sh * sh, sw * sw, sh * sh};
  float s[4][4];
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) s[i][j] = cov[i][j] + (i == j ? var[i] : 0.f);
  // gain^T [4][8] = S^-1 (cov[:, :4])^T, a column of 8 at a time
  float gain[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float col[4] = {cov[r][0], cov[r][1], cov[r][2], cov[r][3]};
    chol_solve<4>(s, col);
#pragma unroll
    for (int i = 0; i < 4; ++i) gain[r][i] = col[i];
  }
  float innov[4];
#pragma unroll
  for (int i = 0; i < 4; ++i) innov[i] = z[i] - mean[i];
#pragma unroll
  for (int r = 0; r < 8; ++r) {
    float acc = 0.f;
#pragma unroll
    for (int i = 0; i < 4; ++i) acc = acc + gain[r][i] * innov[i];
    mean[r] = mean[r] + acc;
  }
  float gs[8][4];
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < 4; ++i) acc = acc + gain[r][i] * s[i][j];
      gs[r][j] = acc;
    }
#pragma unroll
  for (int r = 0; r < 8; ++r)
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int j = 0; j < 4; ++j) acc = acc + gs[r][j] * gain[c][j];
      cov[r][c] = cov[r][c] - acc;
    }
}

// ---------------------------------------------------------------------------
// The kernel: one block a stream
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
gap_commit_kernel(const Params p) {
  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int s = blockIdx.x;
  const int n_t = p.n_tracks, f_cap = p.f_cap, n_bg = p.n_bg;
  const int n_trk = f_cap * kKp;
  const Keys keys = stream_keys(p.seeds[s]);

  const float2* prev = reinterpret_cast<const float2*>(p.all_prev)
                       + static_cast<int64_t>(s) * p.n_points;
  const float2* cur = reinterpret_cast<const float2*>(p.all_cur)
                      + static_cast<int64_t>(s) * p.n_points;
  const uint8_t* status = p.status + static_cast<int64_t>(s) * p.n_points;
  float* info = p.info + static_cast<int64_t>(s) * (10 + 12 * n_t + 5 * n_bg);

  __shared__ float red[11][kThreads];       // block_sum scratch
  __shared__ int red_i[kThreads];
  __shared__ float2 bp[kMaxBg], bc[kMaxBg];  // background prev / cur
  __shared__ float2 pn[kMaxBg], qn[kMaxBg];  // normalised
  __shared__ uint8_t bv[kMaxBg], b_inl[kMaxBg];
  __shared__ int order[kMaxBg];
  __shared__ float t1[9], t2inv[9], h_best[9], h_ref[9], nrm[44];
  __shared__ float h_norm[9];
  // similarity: a round's 8 tracks, a warp each
  __shared__ float2 tp[kWarps][kKp], tc[kWarps][kKp];
  __shared__ uint8_t mv[kWarps][kKp], s_inl[kWarps][kKp],
      s_new[kWarps][kKp];
  __shared__ int s_ord[kWarps][kKp], hyp_n[kWarps][kHypA];
  __shared__ float hyp[kWarps][kHypA][4];
  // per flow slot
  __shared__ float inside[kMaxFlow][4];
  __shared__ uint8_t f_valid[kMaxFlow];
  __shared__ float est[kMaxFlow][4], ratio[kMaxFlow];
  __shared__ uint8_t est_valid[kMaxFlow];
  __shared__ uint32_t kp_bits[kMaxFlow];
  __shared__ int pos[kThreads];
  __shared__ float trans[64], acc_cov[64];

  // ---- stage the background points, the boxes, the Kalman matrices -------
  if (tid < n_bg) {
    bp[tid] = prev[n_trk + tid];
    bc[tid] = cur[n_trk + tid];
    bv[tid] = status[n_trk + tid];
  }
  if (tid < f_cap) {
    const float* box = p.inside + (static_cast<int64_t>(s) * f_cap + tid) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) inside[tid][j] = box[j];
    f_valid[tid] = p.f_valid[static_cast<int64_t>(s) * f_cap + tid];
  }
  if (tid < 64) {
    trans[tid] = p.trans[tid];
    acc_cov[tid] = p.acc_cov[tid];
  }
  __syncthreads();

  // ---- homography RANSAC ---------------------------------------------------
  const bool own = tid < n_bg;
  const bool valid_pt = own && bv[tid];
  {
    // Hartley normalisation of both point sets over the valid points
    float sums[5] = {valid_pt ? bp[tid].x : 0.f, valid_pt ? bp[tid].y : 0.f,
                     valid_pt ? bc[tid].x : 0.f, valid_pt ? bc[tid].y : 0.f,
                     valid_pt ? 1.f : 0.f};
    block_sum<5>(sums, red);
    const float cnt = sums[4] > 1.f ? sums[4] : 1.f;
    const float mpx = sums[0] / cnt, mpy = sums[1] / cnt;
    const float mqx = sums[2] / cnt, mqy = sums[3] / cnt;
    float dp = 0.f, dq = 0.f;
    if (own) {
      const float ax = bp[tid].x - mpx, ay = bp[tid].y - mpy;
      const float bx = bc[tid].x - mqx, by = bc[tid].y - mqy;
      dp = sqrtf(ax * ax + ay * ay);
      dq = sqrtf(bx * bx + by * by);
    }
    float dsum[2] = {valid_pt ? dp : 0.f, valid_pt ? dq : 0.f};
    block_sum<2>(dsum, red);
    const float mdp = dsum[0] / cnt, mdq = dsum[1] / cnt;
    const float sp = 1.41421356237309515f / (mdp > 1e-6f ? mdp : 1e-6f);
    const float sq = 1.41421356237309515f / (mdq > 1e-6f ? mdq : 1e-6f);
    if (own) {
      pn[tid] = make_float2((bp[tid].x - mpx) * sp, (bp[tid].y - mpy) * sp);
      qn[tid] = make_float2((bc[tid].x - mqx) * sq, (bc[tid].y - mqy) * sq);
    }
    if (tid == 0) {
      const float a[9] = {sp, 0.f, -sp * mpx, 0.f, sp, -sp * mpy,
                          0.f, 0.f, 1.f};
      // t2 is a scale and a translation: its inverse in closed form
      const float b[9] = {1.f / sq, 0.f, mqx, 0.f, 1.f / sq, mqy,
                          0.f, 0.f, 1.f};
#pragma unroll
      for (int i = 0; i < 9; ++i) {
        t1[i] = a[i];
        t2inv[i] = b[i];
      }
    }
    // the valid points first, then the rest, each in index order
    if (own) {
      int before = 0, valid_before = 0;
      for (int k = 0; k < tid; ++k) {
        ++before;
        valid_before += bv[k];
      }
      order[valid_pt ? valid_before
                     : static_cast<int>(sums[4]) + before - valid_before] =
          tid;
    }
    __syncthreads();

    // a hypothesis a thread
    const float cntf = cnt;
    float h_px[9];
    {
      float2 ps[4], qs[4];
#pragma unroll
      for (int j = 0; j < 4; ++j) {
        const float u = uniform(keys.h1, keys.h2, 4u * tid + j);
        const int k = order[static_cast<int>(u * cntf) % n_bg];
        ps[j] = pn[k];
        qs[j] = qn[k];
      }
      // rows: r1 of the four samples, then r2 (flow_kernels._dlt_rows)
      float rows[8][9];
#pragma unroll
      for (int j = 0; j < 4; ++j)
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          rows[j][c] = dlt1(ps[j], qs[j], c);
          rows[4 + j][c] = dlt2(ps[j], qs[j], c);
        }
      float n_mat[8][8], rhs[8];
#pragma unroll
      for (int i = 0; i < 8; ++i) {
#pragma unroll
        for (int j = 0; j <= i; ++j) {
          float acc = 0.f;
#pragma unroll
          for (int r = 0; r < 8; ++r) acc = acc + rows[r][i] * rows[r][j];
          n_mat[i][j] = i == j ? acc + 1e-8f : acc;
        }
        float acc = 0.f;
#pragma unroll
        for (int r = 0; r < 8; ++r) acc = acc + rows[r][i] * rows[r][8];
        rhs[i] = -acc;
      }
      chol_solve<8>(n_mat, rhs);
      denormalise(rhs, t1, t2inv, h_px);
    }
    int score = 0;
#pragma unroll 8
    for (int k = 0; k < n_bg; ++k)
      score += bv[k] && h_err2(h_px, bp[k], bc[k]) < kReproj2;
    // the first hypothesis of the highest count
    const int key = block_max(score * kHypH + (kHypH - 1 - tid), red_i);
    if (tid == kHypH - 1 - key % kHypH) {
#pragma unroll
      for (int i = 0; i < 9; ++i) h_best[i] = h_px[i];
    }
    int n_inl = key / kHypH;
    __syncthreads();
    if (own) b_inl[tid] = valid_pt && h_err2(h_best, bp[tid], bc[tid])
                                      < kReproj2;
    __syncthreads();

    // two guarded refits over the inliers' DLT rows
    for (int it = 0; it < 2; ++it) {
      // the 44 sums of the normal equations over the inliers' DLT rows
      // (N[i][j] for i >= j, then the right-hand side): each thread its
      // point's two rows' products, then fixed trees over the block, 11
      // sums at a time
      float terms[44];
      {
        const bool w = own && b_inl[tid];
        const float2 pp = pn[w ? tid : 0], qq = qn[w ? tid : 0];
        float r1[9], r2[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          r1[c] = w ? dlt1(pp, qq, c) : 0.f;
          r2[c] = w ? dlt2(pp, qq, c) : 0.f;
        }
        int e = 0;
#pragma unroll
        for (int i = 0; i < 8; ++i)
#pragma unroll
          for (int j = 0; j <= i; ++j)
            terms[e++] = r1[i] * r1[j] + r2[i] * r2[j];
#pragma unroll
        for (int i = 0; i < 8; ++i)
          terms[36 + i] = r1[i] * r1[8] + r2[i] * r2[8];
      }
#pragma unroll
      for (int g = 0; g < 4; ++g) {
        float v[11];
#pragma unroll
        for (int k = 0; k < 11; ++k) v[k] = terms[11 * g + k];
        block_sum<11>(v, red);
        if (tid == 0) {
#pragma unroll
          for (int k = 0; k < 11; ++k) nrm[11 * g + k] = v[k];
        }
      }
      __syncthreads();
      if (tid == 0) {
        float n_mat[8][8], rhs[8];
#pragma unroll
        for (int i = 0; i < 8; ++i) {
#pragma unroll
          for (int j = 0; j <= i; ++j) {
            const float v = nrm[i * (i + 1) / 2 + j];
            n_mat[i][j] = i == j ? v + 1e-8f : v;
          }
          rhs[i] = -nrm[36 + i];
        }
        chol_solve<8>(n_mat, rhs);
        float h[9];
        denormalise(rhs, t1, t2inv, h);
#pragma unroll
        for (int i = 0; i < 9; ++i) h_ref[i] = h[i];
      }
      __syncthreads();
      const bool inl_new = valid_pt && h_err2(h_ref, bp[tid], bc[tid])
                                       < kReproj2;
      float c[1] = {inl_new ? 1.f : 0.f};
      block_sum<1>(c, red);
      const int n_new = static_cast<int>(c[0]);
      if (n_new >= n_inl) {     // every thread takes the same branch
        if (own) b_inl[tid] = inl_new;
        if (tid < 9) h_best[tid] = h_ref[tid];
        n_inl = n_new;
      }
      __syncthreads();
    }
    if (tid == 0) {
      const float h22 = h_best[8];
      const float den = fabsf(h22) > 1e-9f ? h22 : 1e-9f;
#pragma unroll
      for (int i = 0; i < 9; ++i) h_norm[i] = h_best[i] / den;
      red_i[0] = sums[4] >= 4.f && n_inl >= p.inlier_thresh;
    }
    __syncthreads();
  }
  const bool h_ok = red_i[0] != 0;
  __syncthreads();   // red_i is scratch again below

  // ---- per-track similarity RANSAC, 8 tracks a round -----------------------
  for (int base = 0; base < f_cap; base += kWarps) {
    const int t = base + warp;
    const bool live = t < f_cap;
    const int pt = t * kKp + lane;
    // matches: status, in the frame, not inside a nearer valid track's box
    if (live) {
      const float2 q = cur[pt];
      bool ok = status[pt] && q.x >= 0.f && q.x <= p.frame_x1 && q.y >= 0.f
                && q.y <= p.frame_y1;
      for (int o = 0; o < t && ok; ++o)
        if (f_valid[o] && q.x >= inside[o][0] && q.x <= inside[o][2]
            && q.y >= inside[o][1] && q.y <= inside[o][3])
          ok = false;
      tp[warp][lane] = prev[pt];
      tc[warp][lane] = q;
      mv[warp][lane] = ok;
    }
    __syncthreads();
    int cnt = 0;
    if (live) {
      int valid_before = 0;
      for (int k = 0; k < kKp; ++k) {
        cnt += mv[warp][k];
        if (k < lane) valid_before += mv[warp][k];
      }
      s_ord[warp][mv[warp][lane] ? valid_before
                                 : cnt + lane - valid_before] = lane;
    }
    __syncthreads();
    uint32_t k1 = 0, k2 = 0;
    if (live) {
      threefry(keys.a1, keys.a2, 0u, static_cast<uint32_t>(t), k1, k2);
      const float cntf = cnt > 1 ? static_cast<float>(cnt) : 1.f;
#pragma unroll
      for (int rep = 0; rep < 2; ++rep) {
        const int hyp_i = lane + 32 * rep;
        const float u0 = uniform(k1, k2, 2u * hyp_i);
        const float u1 = uniform(k1, k2, 2u * hyp_i + 1u);
        const int i0 = s_ord[warp][static_cast<int>(u0 * cntf) % kKp];
        const int i1 = s_ord[warp][static_cast<int>(u1 * cntf) % kKp];
        const float2 p1 = tp[warp][i0], p2 = tp[warp][i1];
        const float2 q1 = tc[warp][i0], q2 = tc[warp][i1];
        const float dpx = p2.x - p1.x, dpy = p2.y - p1.y;
        const float dqx = q2.x - q1.x, dqy = q2.y - q1.y;
        float den = dpx * dpx + dpy * dpy;
        den = den > 1e-9f ? den : 1e-9f;
        float sim[4];
        sim[0] = (dqx * dpx + dqy * dpy) / den;
        sim[1] = (dqy * dpx - dqx * dpy) / den;
        sim[2] = q1.x - (sim[0] * p1.x - sim[1] * p1.y);
        sim[3] = q1.y - (sim[1] * p1.x + sim[0] * p1.y);
        int n = 0;
#pragma unroll 8
        for (int k = 0; k < kKp; ++k)
          n += mv[warp][k] && sim_err2(sim, tp[warp][k], tc[warp][k])
                              < kReproj2;
        hyp_n[warp][hyp_i] = n;
#pragma unroll
        for (int j = 0; j < 4; ++j) hyp[warp][hyp_i][j] = sim[j];
      }
    }
    __syncthreads();
    float sim[4] = {0.f, 0.f, 0.f, 0.f};
    int n_inl = 0;
    if (live) {
      int best = 0;
      for (int h = 1; h < kHypA; ++h)
        if (hyp_n[warp][h] > hyp_n[warp][best]) best = h;
#pragma unroll
      for (int j = 0; j < 4; ++j) sim[j] = hyp[warp][best][j];
      n_inl = hyp_n[warp][best];
      s_inl[warp][lane] = mv[warp][lane]
                          && sim_err2(sim, tp[warp][lane], tc[warp][lane])
                             < kReproj2;
    }
    __syncthreads();
    for (int it = 0; it < 2; ++it) {
      // the 8 sums over the track's inliers: each lane its keypoint's
      // terms, then a fixed tree over the warp's 32 lanes (in the block
      // reduction's scratch, free here)
      if (live) {
        const bool w = s_inl[warp][lane];
        const float2 a = tp[warp][lane], b = tc[warp][lane];
        const float v[8] = {w ? 1.f : 0.f, w ? a.x : 0.f, w ? a.y : 0.f,
                            w ? a.x * a.x + a.y * a.y : 0.f,
                            w ? b.x : 0.f, w ? b.y : 0.f,
                            w ? a.x * b.x + a.y * b.y : 0.f,
                            w ? a.x * b.y - a.y * b.x : 0.f};
#pragma unroll
        for (int i = 0; i < 8; ++i) red[i][tid] = v[i];
      }
      __syncthreads();
      for (int half = 16; half > 0; half >>= 1) {
        if (live && lane < half) {
#pragma unroll
          for (int i = 0; i < 8; ++i)
            red[i][tid] = red[i][tid] + red[i][tid + half];
        }
        __syncthreads();
      }
      float sol[4] = {0.f, 0.f, 0.f, 0.f};
      if (live) {
        const int l0 = warp * 32;
        float sw = red[0][l0];
        const float sx = red[1][l0], sy = red[2][l0], sxx = red[3][l0];
        const float su = red[4][l0], sv = red[5][l0], sxu = red[6][l0];
        const float sxv = red[7][l0];
        sw = sw > 1.f ? sw : 1.f;
        const float m[4][4] = {{sxx + 1e-6f, 0.f, sx, sy},
                               {0.f, sxx + 1e-6f, -sy, sx},
                               {sx, -sy, sw + 1e-6f, 0.f},
                               {sy, sx, 0.f, sw + 1e-6f}};
        sol[0] = sxu;
        sol[1] = sxv;
        sol[2] = su;
        sol[3] = sv;
        chol_solve<4>(m, sol);
        s_new[warp][lane] = mv[warp][lane]
                            && sim_err2(sol, tp[warp][lane], tc[warp][lane])
                               < kReproj2;
      }
      __syncthreads();
      if (live) {
        int n_new = 0;
#pragma unroll 8
        for (int k = 0; k < kKp; ++k) n_new += s_new[warp][k];
        if (n_new >= n_inl) {
#pragma unroll
          for (int j = 0; j < 4; ++j) sim[j] = sol[j];
          n_inl = n_new;
          s_inl[warp][lane] = s_new[warp][lane];
        }
      }
      __syncthreads();
    }
    if (live && lane == 0) {
      const float a = sim[0], b = sim[1];
      float scale = sqrtf(a * a + b * b);
      scale = scale < 0.9f || scale > 1.1f ? 1.f : scale;
      const float* box = p.f_tlbrs + (static_cast<int64_t>(s) * f_cap + t) * 4;
      const float tlx = a * box[0] + -b * box[1] + sim[2];
      const float tly = b * box[0] + a * box[1] + sim[3];
      const float w = (box[2] - box[0] + 1.f) * scale;
      const float h = (box[3] - box[1] + 1.f) * scale;
      const float e[4] = {rintf(tlx), rintf(tly), rintf(tlx + w - 1.f),
                          rintf(tly + h - 1.f)};
      const bool in_frame =
          fminf(e[2], p.frame_x1) >= fmaxf(e[0], 0.f)
          && fminf(e[3], p.frame_y1) >= fmaxf(e[1], 0.f);
      const bool sim_ok = cnt >= 3 && n_inl >= p.inlier_thresh;
      est_valid[t] = f_valid[t] && sim_ok && in_frame
                     && n_inl >= p.inlier_thresh;
#pragma unroll
      for (int j = 0; j < 4; ++j) est[t][j] = e[j];
      ratio[t] = static_cast<float>(n_inl)
                 / static_cast<float>(cnt > 1 ? cnt : 1);
      uint32_t bits = 0;
      for (int k = 0; k < kKp; ++k)
        bits |= static_cast<uint32_t>(s_inl[warp][k] && mv[warp][k]) << k;
      kp_bits[t] = bits;
    }
    __syncthreads();
  }

  // ---- slot scatter, Kalman, commit: a thread a track slot -----------------
  if (tid < n_t) pos[tid] = f_cap;
  __syncthreads();
  if (tid < f_cap) {
    const int64_t slot = p.forder[static_cast<int64_t>(s) * f_cap + tid];
    if (slot >= 0 && slot < n_t) pos[slot] = tid;
  }
  __syncthreads();
  if (tid < n_t) {
    const int64_t i = static_cast<int64_t>(s) * n_t + tid;
    const bool valid = p.valid[i];
    const int age = p.ages[i];
    const bool active = valid && age < 2;
    const bool in_flow = pos[tid] < f_cap && active;
    const int slot = pos[tid] < f_cap - 1 ? pos[tid] : f_cap - 1;
    const bool ev = est_valid[slot];
    const bool has_klt = in_flow && ev;
    const float new_inl = has_klt ? ratio[slot] : p.inl[i];
    const bool kp_clear = in_flow && !ev;
    // keypoints: the flow slot's tracked points and their inlier matches
    const float2* kp_src = in_flow
        ? cur + slot * kKp
        : reinterpret_cast<const float2*>(p.kps) + i * kKp;
    float2* kp_dst = reinterpret_cast<float2*>(p.out_kps) + i * kKp;
    uint32_t kpv = 0;
    for (int k = 0; k < kKp; ++k) {
      kp_dst[k] = kp_src[k];
      const bool v = in_flow ? (kp_bits[slot] >> k) & 1u
                             : p.kpv[i * kKp + k] != 0;
      kpv |= static_cast<uint32_t>(v && !kp_clear) << k;
    }
    const float fage = p.age_penalty * static_cast<float>(age);
    const float mult = (fage > 1.f ? fage : 1.f)
                       / (new_inl > 1e-6f ? new_inl : 1e-6f);

    float mean[8], cov[8][8];
#pragma unroll
    for (int r = 0; r < 8; ++r) {
      mean[r] = p.means[i * 8 + r];
#pragma unroll
      for (int c = 0; c < 8; ++c) cov[r][c] = p.covs[i * 64 + r * 8 + c];
    }
    const float eye[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    kalman_warp(h_ok ? h_norm : eye, mean, cov);
    kalman_predict(p, trans, acc_cov, mean, cov);
    if (has_klt) {
      const float z[4] = {est[slot][0], est[slot][1], est[slot][2],
                          est[slot][3]};
      kalman_update(p, z, mult, mean, cov);
    }
    // as_tlbr, then intersection over self with the frame
    float nb[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) nb[j] = rintf(mean[j]);
    const float* fr = p.frame_tlbr;
    const float iw = fminf(nb[2], fr[2]) - fmaxf(nb[0], fr[0]) + 1.f;
    const float ih = fminf(nb[3], fr[3]) - fmaxf(nb[1], fr[1]) + 1.f;
    const float inter = iw > 0.f && ih > 0.f ? iw * ih : 0.f;
    const float bw = nb[2] - nb[0] + 1.f, bh = nb[3] - nb[1] + 1.f;
    const float area = bw > 0.f && bh > 0.f ? bw * bh : 0.f;
    const float ios = area > 0.f ? inter / area : 0.f;
    const bool lost = valid && ios < 0.5f;
    const bool new_valid = h_ok && valid && !lost;
    const bool new_lp = h_ok && (p.lost_pending[i]
                                 || (lost && p.hits[i] >= p.confirm_hits));
    if (!(h_ok && new_valid)) kpv = 0;

#pragma unroll
    for (int r = 0; r < 8; ++r) {
      p.out_means[i * 8 + r] = mean[r];
#pragma unroll
      for (int c = 0; c < 8; ++c) p.out_covs[i * 64 + r * 8 + c] = cov[r][c];
    }
#pragma unroll
    for (int j = 0; j < 4; ++j)
      p.out_tlbrs[i * 4 + j] = valid ? nb[j] : p.tlbrs[i * 4 + j];
    p.out_valid[i] = new_valid;
    p.out_lost_pending[i] = new_lp;
    p.out_inl[i] = new_inl;
    for (int k = 0; k < kKp; ++k) p.out_kpv[i * kKp + k] = (kpv >> k) & 1u;

    // the info vector (tracker._flat_info's order)
    float* o = info + 10;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[tid * 4 + j] = nb[j];
    o += 4 * n_t;
    o[tid] = lost;
    o += n_t;
    o[tid] = has_klt;
    o += n_t;
#pragma unroll
    for (int j = 0; j < 4; ++j) o[tid * 4 + j] = est[slot][j];
    o += 4 * n_t;
    o[tid] = new_inl;
    o += n_t + 5 * n_bg;
    o[tid] = ev && in_flow;
  }
  if (tid < 10) info[tid] = tid == 0 ? (h_ok ? 1.f : 0.f) : h_norm[tid - 1];
  if (own) {
    float* o = info + 10 + 11 * n_t;
    o[2 * tid] = bp[tid].x;
    o[2 * tid + 1] = bp[tid].y;
    o += 2 * n_bg;
    o[2 * tid] = bc[tid].x;
    o[2 * tid + 1] = bc[tid].y;
    o += 2 * n_bg;
    o[tid] = b_inl[tid] && bv[tid];
  }
}

// the draws of stream blockIdx.x: u_h [HYP_H * 4] then u_a [f_cap, HYP_A *
// 2], as ransac_draws_batch lays them out
__global__ void __launch_bounds__(kThreads)
gap_commit_draws_kernel(const Params p, float* u_h, float* u_a) {
  const int s = blockIdx.x;
  const Keys keys = stream_keys(p.seeds[s]);
  float* uh = u_h + static_cast<int64_t>(s) * kHypH * 4;
  for (int i = threadIdx.x; i < kHypH * 4; i += kThreads)
    uh[i] = uniform(keys.h1, keys.h2, i);
  float* ua = u_a + static_cast<int64_t>(s) * p.f_cap * kHypA * 2;
  for (int t = 0; t < p.f_cap; ++t) {
    uint32_t k1, k2;
    threefry(keys.a1, keys.a2, 0u, static_cast<uint32_t>(t), k1, k2);
    for (int i = threadIdx.x; i < kHypA * 2; i += kThreads)
      ua[t * kHypA * 2 + i] = uniform(k1, k2, i);
  }
}

}  // namespace

extern "C" {

// One call of the gap commit for n_streams streams (ints[kStreams]):
// `ptrs` holds the Ptr enum's device pointers in its order, `ints` and
// `floats` the Int and Float enums' values, `seeds` the streams' uint32
// RANSAC seeds (host memory). Launches one block a stream on `stream`,
// in launches of at most kLaunchStreams streams (the seeds ride in the
// kernel's parameters). Returns 0 or a cudaError_t.
int gap_commit_forward(const void* const* ptrs, const int* ints,
                       const float* floats, const uint32_t* seeds,
                       void* stream) {
  Params p = {};
  const int n_streams = ints[kStreams];
  p.n_tracks = ints[kTracks];
  p.f_cap = ints[kFlow];
  p.n_points = ints[kPoints];
  p.n_bg = p.n_points - p.f_cap * kKp;
  if (n_streams < 0 || p.n_tracks < 1 || p.n_tracks > kThreads
      || p.f_cap < 1 || p.f_cap > kMaxFlow || p.f_cap > p.n_tracks
      || p.n_bg < 1 || p.n_bg > kMaxBg)
    return static_cast<int>(cudaErrorInvalidValue);
  p.inlier_thresh = ints[kInlierThresh];
  p.confirm_hits = ints[kConfirmHits];
  p.frame_x1 = static_cast<float>(ints[kFrameW] - 1);
  p.frame_y1 = static_cast<float>(ints[kFrameH] - 1);
  p.age_penalty = floats[kAgePenalty];
  p.std_factor_acc = floats[kStdFactorAcc];
  p.std_offset_acc = floats[kStdOffsetAcc];
  p.std_klt[0] = floats[kStdKltW];
  p.std_klt[1] = floats[kStdKltH];
  p.min_std_klt[0] = floats[kMinStdKltW];
  p.min_std_klt[1] = floats[kMinStdKltH];
  p.trans = static_cast<const float*>(ptrs[kTrans]);
  p.acc_cov = static_cast<const float*>(ptrs[kAccCov]);
  p.frame_tlbr = static_cast<const float*>(ptrs[kFrameTlbr]);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int64_t n_t = p.n_tracks, f = p.f_cap, n_p = p.n_points;
  const int64_t n_info = 10 + 12 * n_t + 5 * p.n_bg;
  for (int s0 = 0; s0 < n_streams; s0 += kLaunchStreams) {
    const int n = n_streams - s0 < kLaunchStreams ? n_streams - s0
                                                  : kLaunchStreams;
#define AT(name, type, per_stream) \
    (static_cast<type>(const_cast<void*>(ptrs[name])) + s0 * (per_stream))
    p.means = AT(kMeans, const float*, n_t * 8);
    p.covs = AT(kCovs, const float*, n_t * 64);
    p.tlbrs = AT(kTlbrs, const float*, n_t * 4);
    p.valid = AT(kValid, const uint8_t*, n_t);
    p.ages = AT(kAges, const int32_t*, n_t);
    p.hits = AT(kHits, const int32_t*, n_t);
    p.lost_pending = AT(kLostPending, const uint8_t*, n_t);
    p.inl = AT(kInl, const float*, n_t);
    p.kps = AT(kKps, const float*, n_t * kKp * 2);
    p.kpv = AT(kKpv, const uint8_t*, n_t * kKp);
    p.inside = AT(kInside, const float*, f * 4);
    p.f_tlbrs = AT(kFTlbrs, const float*, f * 4);
    p.f_valid = AT(kFValid, const uint8_t*, f);
    p.forder = AT(kForder, const int64_t*, f);
    p.all_prev = AT(kAllPrev, const float*, n_p * 2);
    p.all_cur = AT(kAllCur, const float*, n_p * 2);
    p.status = AT(kStatus, const uint8_t*, n_p);
    p.out_means = AT(kOutMeans, float*, n_t * 8);
    p.out_covs = AT(kOutCovs, float*, n_t * 64);
    p.out_tlbrs = AT(kOutTlbrs, float*, n_t * 4);
    p.out_valid = AT(kOutValid, uint8_t*, n_t);
    p.out_lost_pending = AT(kOutLostPending, uint8_t*, n_t);
    p.out_inl = AT(kOutInl, float*, n_t);
    p.out_kps = AT(kOutKps, float*, n_t * kKp * 2);
    p.out_kpv = AT(kOutKpv, uint8_t*, n_t * kKp);
    p.info = AT(kInfo, float*, n_info);
#undef AT
    for (int i = 0; i < n; ++i) p.seeds[i] = seeds[s0 + i];
    gap_commit_kernel<<<n, kThreads, 0, st>>>(p);
    if (const cudaError_t e = cudaGetLastError())
      return static_cast<int>(e);
  }
  return 0;
}

// The RANSAC draws of n_streams seeds at flow budget f_cap, as the kernel
// draws them: u_h [S, HYP_H, 4] and u_a [S, f_cap, HYP_A, 2] float32
// (device memory). Returns 0 or a cudaError_t.
int gap_commit_draws(const uint32_t* seeds, int n_streams, int f_cap,
                     void* u_h, void* u_a, void* stream) {
  if (n_streams < 0 || f_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  Params p = {};
  p.f_cap = f_cap;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  for (int s0 = 0; s0 < n_streams; s0 += kLaunchStreams) {
    const int n = n_streams - s0 < kLaunchStreams ? n_streams - s0
                                                  : kLaunchStreams;
    for (int i = 0; i < n; ++i) p.seeds[i] = seeds[s0 + i];
    float* uh = static_cast<float*>(u_h)
                + static_cast<int64_t>(s0) * kHypH * 4;
    float* ua = static_cast<float*>(u_a)
                + static_cast<int64_t>(s0) * f_cap * kHypA * 2;
    gap_commit_draws_kernel<<<n, kThreads, 0, st>>>(p, uh, ua);
    if (const cudaError_t e = cudaGetLastError())
      return static_cast<int>(e);
  }
  return 0;
}

const char* gap_commit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
