// The post-LK half of a gap frame for Hopper (sm_90a): RANSAC draws,
// homography RANSAC, per-track similarity RANSAC, the Kalman
// warp/predict/update and the commit, for every stream of a call, in two
// launches on one CUDA stream with no host sync.
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
// fastmot_tpu_torch/ops/gap_commit.py checks the arguments and calls
// gap_commit_forward below.
//
// What bounds it on an H100. Not bytes and not operations: a stream moves
// about 0.1 MB and does about 3 MFLOP, a fraction of a microsecond at the
// card's rates. What sets its time is the chain of dependent steps: draw
// and solve a hypothesis, score it, take the arg-max, refit twice (each
// refit a sum over all points, then a serial 8x8 solve), then the Kalman
// step of a slot, whose 8x8 products are chains of their own; and IEEE
// quotients and roots, which the chain is full of, each take tens of
// cycles. A single block a stream (the first design) ran every step of
// that chain, and every track's similarity fit, one after another on one
// SM. This design keeps to the chain and spreads everything else off it:
//
//   launch 1 (gap_fit_kernel), two roles side by side:
//   - the homography role, kHParts blocks a stream. Each stages the
//     background points, normalises them (Hartley), orders the valid
//     ones first, draws and solves all 256 hypotheses (a thread each:
//     8x8 normal equations + 1e-8 I, the Cholesky-Banachiewicz of
//     smallmat.chol with the diagonal clamped at 1e-12) and scores them
//     on its share of the points: the scores, the chain's longest loop,
//     split kHParts ways. The counts are integers, so the shares add up
//     free of order; counts and hypotheses go to a global scratch.
//   - the similarity role: a warp a track, 8 tracks a block, all of a
//     stream's tracks at once (one round, where the single block took
//     f_cap / 8). A lane a keypoint: the matches, their stable order (a
//     ballot), 64 two-point hypotheses two a lane, the first arg-max (a
//     shuffle reduction of count * 64 + 63 - index), two guarded refits
//     through the 4x4 system (+1e-6 I) whose 8 sums are the 32-lane
//     halving tree as __shfl_down_sync, the box estimate to the scratch.
//     Only __syncwarp orders a track's steps. It reads nothing of the
//     homography.
//   launch 2 (gap_kalman_kernel), the Kalman + commit role: 32 track
//     slots a block, 8 lanes a slot. Before it waits on launch 1 it
//     stages and normalises the background points and loads its slots'
//     means and covariances. Then each block of a stream takes the
//     homography's arg-max (the first hypothesis of the largest summed
//     count) and its two guarded refits, whose 44 normal-equation sums are
//     one pass of the block's halving tree (levels 128, 64, 32 through
//     shared memory, 16 to 1 by shuffles in warp 0) and whose inlier count
//     is __syncthreads_count: every block of the stream gets the same H,
//     with no launch boundary in between. Then lane r of a slot computes
//     row r of the warp's Jacobian and warped mean, of J C J^T over the
//     Jacobian's nonzeros, of predict's F C F^T + Q, of the update's gain
//     (4x4 Cholesky of the innovation) and of the corrected covariance,
//     the rows passing through shared memory between steps; then the
//     selection by has_klt, IoS against the frame, the new state's fields
//     and the info vector.
// The draws are jax.random's threefry-2x32 (20 rounds) in the
// jax_threefry_partitionable form: PRNGKey(seed) = (0, seed), fold_in(key,
// d) = threefry(key, (0, d)), split(key, n)[t] = threefry(key, (0, t)),
// uniform(key, n)[i] from the bits of threefry(key, (0, i)); each thread
// draws the uniforms it uses.
//
// Ordering. Launch 1 lets launch 2 start at once
// (cudaTriggerProgrammaticLaunchCompletion, programmatic dependent
// launch), and launch 2 waits (cudaGridDependencySynchronize) before it
// reads the scratch. Every dependency between blocks is that launch
// boundary: a block never waits on another block of its own launch, so
// the host build of the tests, which runs a launch's blocks one after
// another, computes what the card does. A stream's result does not depend
// on how many streams share the call.
//
// Numerics. Build with -fmad=false: every product, sum and quotient is
// rounded on its own, as in the g++ build of the tests under
// -ffp-contract=off, so the two builds agree bit for bit. Every sum keeps
// the order of the first design (the halving trees pair the same
// elements; an entry of a matrix product sums over k in the same order
// whichever thread computes it), so the outputs equal the first design's
// bit for bit (tests/test_torch_gap_commit.py holds their sha256). The
// plain version on the CPU solves through LAPACK (Cholesky, LU) and sums
// in ATen's order, JAX through the unrolled Cholesky in XLA's order: this
// kernel takes JAX's solves and its own fixed sum orders, and agrees with
// both within the tolerances of tests/test_torch_gap_commit.py. Rounding
// is rint (half to even), as torch.round and jnp.round.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;      // every block
constexpr int kWarps = kThreads / 32;
constexpr int kHypH = 256;         // HYP_H in flow_kernels.py
constexpr int kHypA = 64;          // HYP_A
constexpr int kKp = 32;            // KP_PER_TRACK
constexpr int kMaxBg = 256;        // BG_KP
constexpr int kMaxFlow = 128;      // MAX_FLOW_TRACKS
constexpr int kMaxTracks = 256;    // ops/gap_commit.py KERNEL_MAX_TRACKS
constexpr int kHParts = 16;        // homography blocks a stream
constexpr int kSlotLanes = 8;      // Kalman: lanes a track slot
constexpr int kBlockSlots = kThreads / kSlotLanes;
constexpr int kLaunchStreams = 256;  // seeds a launch carries by value
constexpr float kReproj2 = 9.f;    // RANSAC_REPROJ ** 2
constexpr unsigned kFull = 0xFFFFFFFFu;

// The pointers of gap_commit_forward's `ptrs`, in this order (as
// gap_commit_launch_args in ops/gap_commit.py lists them): inputs, the new
// state's written fields and the info, then the scratch.
enum Ptr {
  kMeans, kCovs, kTlbrs, kValid, kAges, kHits, kLostPending, kInl, kKps,
  kKpv, kInside, kFTlbrs, kFValid, kForder, kAllPrev, kAllCur, kStatus,
  kTrans, kAccCov, kFrameTlbr,
  kOutMeans, kOutCovs, kOutTlbrs, kOutValid, kOutLostPending, kOutInl,
  kOutKps, kOutKpv, kInfo, kScratch
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

// 4-byte words of a stream's scratch: the homography's counts [kHParts]
// [kHypH] and hypotheses [kHypH][9], the similarity's estimates [f_cap][4],
// inlier ratios, validity and inlier bits [f_cap] each
__host__ __device__ inline int scratch_words(int f_cap) {
  return kHParts * kHypH + kHypH * 9 + 7 * f_cap;
}

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
  float* scratch;             // [S, scratch_words(F)]
  int streams;                // in this launch
  int n_tracks, f_cap, n_points, n_bg, inlier_thresh, confirm_hits;
  float frame_x1, frame_y1;   // the flow's frame: (0, 0, W - 1, H - 1)
  float age_penalty, std_factor_acc, std_offset_acc;
  float std_klt[2], min_std_klt[2];
  uint32_t seeds[kLaunchStreams];
};

// a stream's scratch, carved
struct Scratch {
  int* counts;          // [kHParts][kHypH]
  float* hyps;          // [kHypH][9], pixel homographies
  float* est;           // [f_cap][4]
  float* ratio;         // [f_cap]
  int* est_valid;       // [f_cap]
  uint32_t* kp_bits;    // [f_cap]
};

__device__ __forceinline__ Scratch scratch_of(const Params& p, int s) {
  float* base = p.scratch + static_cast<int64_t>(s) * scratch_words(p.f_cap);
  Scratch sc;
  sc.counts = reinterpret_cast<int*>(base);
  sc.hyps = base + kHParts * kHypH;
  sc.est = sc.hyps + kHypH * 9;
  sc.ratio = sc.est + 4 * p.f_cap;
  sc.est_valid = reinterpret_cast<int*>(sc.ratio + p.f_cap);
  sc.kp_bits = reinterpret_cast<uint32_t*>(sc.est_valid + p.f_cap);
  return sc;
}

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

// Solves l l^T x = b for the lower-triangular l by forward and back
// substitution; x overwrites b.
template <int N>
__device__ __forceinline__ void chol_subst(const float (&l)[N][N],
                                           float (&b)[N]) {
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
  chol_subst<N>(l, b);
}

// chol_solve's factor of the 8x8 normal equations (nrm: their 36 lower
// entries row by row, +1e-8 on the diagonal), computed by warp 0 a row a
// lane: column k's root on lane k, then its quotients on the lanes below
// at once, and each entry's sum over k in ascending order, as chol_solve
// takes it, so the same roundings. Lane i < 8 writes row i to l.
__device__ __forceinline__ void chol_factor_rows(const float* nrm,
                                                 float (*l)[8]) {
  const int lane = threadIdx.x % 32, i = lane < 8 ? lane : 7;
  float s[8], row[8];
#pragma unroll
  for (int j = 0; j < 8; ++j) {
    const float v = nrm[i * (i + 1) / 2 + (j <= i ? j : 0)];
    s[j] = i == j ? v + 1e-8f : v;
  }
#pragma unroll
  for (int k = 0; k < 8; ++k) {
    const float root = sqrtf(s[k] > 1e-12f ? s[k] : 1e-12f);
    const float lkk = __shfl_sync(kFull, root, k);
    row[k] = i == k ? lkk : s[k] / lkk;
#pragma unroll
    for (int j = k + 1; j < 8; ++j)
      s[j] = s[j] - row[k] * __shfl_sync(kFull, row[k], j);
  }
  if (lane < 8) {
#pragma unroll
    for (int k = 0; k < 8; ++k) l[i][k] = row[k];
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
// Block reductions: a fixed halving tree over the block's threads
// ---------------------------------------------------------------------------

// The sums of v[0..N) over the block's threads into out[0..N) (shared),
// read by every thread on return: the halving tree that pairs thread t
// with t + h for h = 128, 64, ..., 1. Levels 128 and 64 pass through `red`
// (at level 64 a thread of the upper half writes the column that it alone
// read before); then the 64 partials of each sum go to `red` and sum i's
// level 32 and its levels 16 to 1 (shuffles) run in warp i % 8, so that
// the warps share the tail of many sums.
template <int N>
__device__ __forceinline__ void tree_sum(float (&v)[N],
                                         float (*red)[kThreads / 2],
                                         float* out) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  if (tid >= kThreads / 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][tid - kThreads / 2] = v[i];
  }
  __syncthreads();
  if (tid < kThreads / 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) v[i] = v[i] + red[i][tid];
  }
  if (tid >= kThreads / 4 && tid < kThreads / 2) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][tid] = v[i];
  }
  __syncthreads();
  if (tid < kThreads / 4) {
#pragma unroll
    for (int i = 0; i < N; ++i) red[i][tid] = v[i] + red[i][tid + 64];
  }
  __syncthreads();
  for (int i = warp; i < N; i += kWarps) {
    float x = red[i][lane] + red[i][lane + 32];
#pragma unroll
    for (int h = 16; h > 0; h >>= 1) x = x + __shfl_down_sync(kFull, x, h);
    if (lane == 0) out[i] = x;
  }
  __syncthreads();
}

// ---------------------------------------------------------------------------
// The background points of a stream, normalised (both homography roles)
// ---------------------------------------------------------------------------

struct Background {
  float2 bp[kMaxBg], bc[kMaxBg];   // prev / cur
  float2 pn[kMaxBg], qn[kMaxBg];   // Hartley-normalised
  uint8_t bv[kMaxBg];              // status
  float t1[9], t2inv[9];           // the normalisations
  float sums[8];                   // tree_sum's outputs
};

// Stages stream s's background points and normalises both sets over the
// valid ones (Hartley); returns the count of valid points. `red` holds at
// least 5 rows.
__device__ float stage_background(const Params& p, int s, Background& bg,
                                  float (*red)[kThreads / 2]) {
  const int tid = threadIdx.x, n_bg = p.n_bg;
  const int64_t base = static_cast<int64_t>(s) * p.n_points
                       + p.f_cap * kKp;
  const bool own = tid < n_bg;
  if (own) {
    bg.bp[tid] = reinterpret_cast<const float2*>(p.all_prev)[base + tid];
    bg.bc[tid] = reinterpret_cast<const float2*>(p.all_cur)[base + tid];
    bg.bv[tid] = p.status[base + tid];
  }
  __syncthreads();
  const bool valid_pt = own && bg.bv[tid];
  float sums[5] = {valid_pt ? bg.bp[tid].x : 0.f,
                   valid_pt ? bg.bp[tid].y : 0.f,
                   valid_pt ? bg.bc[tid].x : 0.f,
                   valid_pt ? bg.bc[tid].y : 0.f, valid_pt ? 1.f : 0.f};
  tree_sum<5>(sums, red, bg.sums);
#pragma unroll
  for (int i = 0; i < 5; ++i) sums[i] = bg.sums[i];
  const float cnt = sums[4] > 1.f ? sums[4] : 1.f;
  const float mpx = sums[0] / cnt, mpy = sums[1] / cnt;
  const float mqx = sums[2] / cnt, mqy = sums[3] / cnt;
  float dp = 0.f, dq = 0.f;
  if (own) {
    const float ax = bg.bp[tid].x - mpx, ay = bg.bp[tid].y - mpy;
    const float bx = bg.bc[tid].x - mqx, by = bg.bc[tid].y - mqy;
    dp = sqrtf(ax * ax + ay * ay);
    dq = sqrtf(bx * bx + by * by);
  }
  float dsum[2] = {valid_pt ? dp : 0.f, valid_pt ? dq : 0.f};
  tree_sum<2>(dsum, red, bg.sums + 5);
  dsum[0] = bg.sums[5];
  dsum[1] = bg.sums[6];
  const float mdp = dsum[0] / cnt, mdq = dsum[1] / cnt;
  const float sp = 1.41421356237309515f / (mdp > 1e-6f ? mdp : 1e-6f);
  const float sq = 1.41421356237309515f / (mdq > 1e-6f ? mdq : 1e-6f);
  if (own) {
    bg.pn[tid] = make_float2((bg.bp[tid].x - mpx) * sp,
                             (bg.bp[tid].y - mpy) * sp);
    bg.qn[tid] = make_float2((bg.bc[tid].x - mqx) * sq,
                             (bg.bc[tid].y - mqy) * sq);
  }
  if (tid == 0) {
    const float a[9] = {sp, 0.f, -sp * mpx, 0.f, sp, -sp * mpy,
                        0.f, 0.f, 1.f};
    // t2 is a scale and a translation: its inverse in closed form
    const float b[9] = {1.f / sq, 0.f, mqx, 0.f, 1.f / sq, mqy,
                        0.f, 0.f, 1.f};
#pragma unroll
    for (int i = 0; i < 9; ++i) {
      bg.t1[i] = a[i];
      bg.t2inv[i] = b[i];
    }
  }
  __syncthreads();
  return sums[4];
}

// ---------------------------------------------------------------------------
// The Kalman warp's Jacobian (kalman.warp)
// ---------------------------------------------------------------------------

// the nonzero pattern of the warp's Jacobian: per corner, d p2/d p and
// d v2/d v are Dg(p), d v2/d p the second derivative contracted with v
__device__ __forceinline__ constexpr bool jac_nz(int r, int m) {
  return r < 4 ? (m >> 1) == (r >> 1)
               : (m >> 1) == ((r - 4) >> 1) || (m >> 1) == (r >> 1);
}

// Row r of the warp of mean [8] by the homography h (h22 taken as 1):
// returns the warped mean's entry r and writes row r of the Jacobian
// (zero off its pattern) to jac [8]
__device__ __forceinline__ float warp_row(const float* h,
                                          const float (&mean)[8], int r,
                                          float* jac) {
  const int k = (r & 3) >> 1, i = r & 1;   // corner, coordinate
  const float a[2] = {i ? h[3] : h[0], i ? h[4] : h[1]};   // row i of A
  const float t = i ? h[5] : h[2];
  const float c[2] = {h[6], h[7]};
  const float px = k ? mean[2] : mean[0], py = k ? mean[3] : mean[1];
  const float vx = k ? mean[6] : mean[4], vy = k ? mean[7] : mean[5];
  const float d1 = px * c[0] + py * c[1] + 1.f;
  const float num = px * a[0] + py * a[1] + t;
  const float cv = vx * c[0] + vy * c[1];
  const float d2 = d1 * d1;
  const float d3 = d2 * d1;
  const float av = vx * a[0] + vy * a[1];
#pragma unroll
  for (int m = 0; m < 8; ++m) jac[m] = 0.f;
  // both kinds of row computed, one kept: no branch between the lanes
#pragma unroll
  for (int m = 0; m < 2; ++m) {
    const float dg = a[m] / d1 - num * c[m] / d2;
    const float dv = -av * c[m] / d2
                     - cv * (a[m] / d2 - 2.f * num * c[m] / d3);
    jac[(r < 4 ? 0 : 4) + 2 * k + m] = dg;
    if (r >= 4) jac[2 * k + m] = dv;
  }
  const float position = num / d1, velocity = av / d1 - num * cv / d2;
  return r < 4 ? position : velocity;
}

__device__ __forceinline__ float box_w(const float (&m)[8]) {
  return m[2] - m[0] + 1.f;
}
__device__ __forceinline__ float box_h(const float (&m)[8]) {
  return m[3] - m[1] + 1.f;
}

// ---------------------------------------------------------------------------
// Launch 1, the homography role: its hypotheses, scored on a share of the
// points (block `block` of the role)
// ---------------------------------------------------------------------------

__device__ void homography_block(const Params& p, int block) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int s = block / kHParts, part = block % kHParts;
  const int n_bg = p.n_bg;
  const Keys keys = stream_keys(p.seeds[s]);
  const Scratch sc = scratch_of(p, s);

  __shared__ Background bg;
  __shared__ float red[5][kThreads / 2];
  __shared__ int order[kMaxBg];
  __shared__ int warp_valid[kWarps];
  const float n_valid = stage_background(p, s, bg, red);
  const float cntf = n_valid > 1.f ? n_valid : 1.f;
  const bool own = tid < n_bg;
  const bool valid_pt = own && bg.bv[tid];

  // the valid points first, then the rest, each in index order
  const unsigned ballot = __ballot_sync(kFull, valid_pt);
  if (lane == 0) warp_valid[warp] = __popc(ballot);
  __syncthreads();
  int valid_before = __popc(ballot & ((1u << lane) - 1u));
  for (int w = 0; w < warp; ++w) valid_before += warp_valid[w];
  if (own)
    order[valid_pt ? valid_before
                   : static_cast<int>(n_valid) + tid - valid_before] = tid;
  __syncthreads();

  // a hypothesis a thread
  float h_px[9];
  {
    float2 ps[4], qs[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
      const float u = uniform(keys.h1, keys.h2, 4u * tid + j);
      const int k = order[static_cast<int>(u * cntf) % n_bg];
      ps[j] = bg.pn[k];
      qs[j] = bg.qn[k];
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
    denormalise(rhs, bg.t1, bg.t2inv, h_px);
  }
  if (part == 0) {
#pragma unroll
    for (int i = 0; i < 9; ++i) sc.hyps[tid * 9 + i] = h_px[i];
  }
  // this block's share of the points
  const int share = (n_bg + kHParts - 1) / kHParts;
  const int k1 = part * share + share < n_bg ? part * share + share : n_bg;
  int score = 0;
#pragma unroll 8
  for (int k = part * share; k < k1; ++k)
    score += (bg.bv[k] != 0) & (h_err2(h_px, bg.bp[k], bg.bc[k]) < kReproj2);
  sc.counts[part * kHypH + tid] = score;
}

// ---------------------------------------------------------------------------
// Launch 1, the similarity role: per-track similarity RANSAC, a warp a
// track (block `block` of the role)
// ---------------------------------------------------------------------------

__device__ void similarity_block(const Params& p, int block) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int f_cap = p.f_cap;
  const int blocks = (f_cap + kWarps - 1) / kWarps;
  const int s = block / blocks, first = block % blocks * kWarps;
  const int t = first + warp;

  __shared__ float inside[kMaxFlow][4];
  __shared__ uint8_t f_valid[kMaxFlow];
  __shared__ float2 tp[kWarps][kKp], tc[kWarps][kKp];
  __shared__ int s_ord[kWarps][kKp];
  __shared__ float hyp[kWarps][kHypA][4];
  // the boxes of the tracks before this block's last
  if (tid < f_cap && tid < first + kWarps) {
    const float* box = p.inside + (static_cast<int64_t>(s) * f_cap + tid) * 4;
#pragma unroll
    for (int j = 0; j < 4; ++j) inside[tid][j] = box[j];
    f_valid[tid] = p.f_valid[static_cast<int64_t>(s) * f_cap + tid];
  }
  __syncthreads();

  if (t < f_cap) {
    const Keys keys = stream_keys(p.seeds[s]);
    const int64_t pt = static_cast<int64_t>(s) * p.n_points + t * kKp + lane;
    const float2 a = reinterpret_cast<const float2*>(p.all_prev)[pt];
    const float2 q = reinterpret_cast<const float2*>(p.all_cur)[pt];
    // matches: status, in the frame, not inside a nearer valid track's box
    bool ok = p.status[pt] && q.x >= 0.f && q.x <= p.frame_x1 && q.y >= 0.f
              && q.y <= p.frame_y1;
    for (int o = 0; o < t && ok; ++o)
      if (f_valid[o] && q.x >= inside[o][0] && q.x <= inside[o][2]
          && q.y >= inside[o][1] && q.y <= inside[o][3])
        ok = false;
    tp[warp][lane] = a;
    tc[warp][lane] = q;
    const unsigned mv = __ballot_sync(kFull, ok);
    const int cnt = __popc(mv);
    const int valid_before = __popc(mv & ((1u << lane) - 1u));
    s_ord[warp][ok ? valid_before : cnt + lane - valid_before] = lane;
    __syncwarp();

    // 64 two-point hypotheses, two a lane, each scored on the 32 points
    uint32_t k1, k2;
    threefry(keys.a1, keys.a2, 0u, static_cast<uint32_t>(t), k1, k2);
    const float cntf = cnt > 1 ? static_cast<float>(cnt) : 1.f;
    int key = 0;
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
        n += (mv >> k & 1u) & (sim_err2(sim, tp[warp][k], tc[warp][k])
                               < kReproj2);
#pragma unroll
      for (int j = 0; j < 4; ++j) hyp[warp][hyp_i][j] = sim[j];
      // the first of the highest count: the largest count * 64 + 63 - index
      const int k_i = n * kHypA + (kHypA - 1 - hyp_i);
      key = k_i > key ? k_i : key;
    }
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, off);
      key = other > key ? other : key;
    }
    __syncwarp();
    const int best = kHypA - 1 - key % kHypA;
    float sim[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) sim[j] = hyp[warp][best][j];
    int n_inl = key / kHypA;
    bool inl = ok && sim_err2(sim, a, q) < kReproj2;

    for (int it = 0; it < 2; ++it) {
      // the 8 sums over the track's inliers: each lane its keypoint's
      // terms, then the halving tree over the warp's 32 lanes
      float v[8] = {inl ? 1.f : 0.f, inl ? a.x : 0.f, inl ? a.y : 0.f,
                    inl ? a.x * a.x + a.y * a.y : 0.f,
                    inl ? q.x : 0.f, inl ? q.y : 0.f,
                    inl ? a.x * q.x + a.y * q.y : 0.f,
                    inl ? a.x * q.y - a.y * q.x : 0.f};
#pragma unroll
      for (int h = 16; h > 0; h >>= 1)
#pragma unroll
        for (int i = 0; i < 8; ++i)
          v[i] = v[i] + __shfl_down_sync(kFull, v[i], h);
#pragma unroll
      for (int i = 0; i < 8; ++i) v[i] = __shfl_sync(kFull, v[i], 0);
      const float sw = v[0] > 1.f ? v[0] : 1.f;
      const float sx = v[1], sy = v[2], sxx = v[3];
      const float m[4][4] = {{sxx + 1e-6f, 0.f, sx, sy},
                             {0.f, sxx + 1e-6f, -sy, sx},
                             {sx, -sy, sw + 1e-6f, 0.f},
                             {sy, sx, 0.f, sw + 1e-6f}};
      float sol[4] = {v[6], v[7], v[4], v[5]};
      chol_solve<4>(m, sol);
      const bool inl_new = ok && sim_err2(sol, a, q) < kReproj2;
      const int n_new = __popc(__ballot_sync(kFull, inl_new));
      if (n_new >= n_inl) {     // every lane takes the same branch
#pragma unroll
        for (int j = 0; j < 4; ++j) sim[j] = sol[j];
        n_inl = n_new;
        inl = inl_new;
      }
    }
    const uint32_t bits = __ballot_sync(kFull, inl && ok);
    if (lane == 0) {
      const Scratch sc = scratch_of(p, s);
      const float sa = sim[0], sb = sim[1];
      float scale = sqrtf(sa * sa + sb * sb);
      scale = scale < 0.9f || scale > 1.1f ? 1.f : scale;
      const float* box = p.f_tlbrs + (static_cast<int64_t>(s) * f_cap + t) * 4;
      const float tlx = sa * box[0] + -sb * box[1] + sim[2];
      const float tly = sb * box[0] + sa * box[1] + sim[3];
      const float w = (box[2] - box[0] + 1.f) * scale;
      const float h = (box[3] - box[1] + 1.f) * scale;
      const float e[4] = {rintf(tlx), rintf(tly), rintf(tlx + w - 1.f),
                          rintf(tly + h - 1.f)};
      const bool in_frame =
          fminf(e[2], p.frame_x1) >= fmaxf(e[0], 0.f)
          && fminf(e[3], p.frame_y1) >= fmaxf(e[1], 0.f);
      const bool sim_ok = cnt >= 3 && n_inl >= p.inlier_thresh;
      sc.est_valid[t] = f_valid[t] && sim_ok && in_frame
                        && n_inl >= p.inlier_thresh;
#pragma unroll
      for (int j = 0; j < 4; ++j) sc.est[t * 4 + j] = e[j];
      sc.ratio[t] = static_cast<float>(n_inl)
                    / static_cast<float>(cnt > 1 ? cnt : 1);
      sc.kp_bits[t] = bits;
    }
  }
}

// launch 1: blocks [0, streams * kHParts) take the homography role, the
// rest the similarity role; the Kalman launch may start at once
__global__ void __launch_bounds__(kThreads)
gap_fit_kernel(const Params p) {
  cudaTriggerProgrammaticLaunchCompletion();
  const int homography_blocks = p.streams * kHParts;
  if (static_cast<int>(blockIdx.x) < homography_blocks)
    homography_block(p, blockIdx.x);
  else
    similarity_block(p, blockIdx.x - homography_blocks);
}

// ---------------------------------------------------------------------------
// Launch 2, the Kalman role: the homography's arg-max and refits, then
// Kalman and commit, 32 slots a block, 8 lanes a slot
// ---------------------------------------------------------------------------

__global__ void __launch_bounds__(kThreads, 1)
gap_kalman_kernel(const Params p) {
  const int tid = threadIdx.x, lane = tid % 32, warp = tid / 32;
  const int n_t = p.n_tracks, f_cap = p.f_cap, n_bg = p.n_bg;
  const int blocks = (n_t + kBlockSlots - 1) / kBlockSlots;
  const int block = blockIdx.x;
  const int s = block / blocks, part = block % blocks;
  const int r = tid % kSlotLanes, ls = tid / kSlotLanes;
  const int slot_id = part * kBlockSlots + ls;
  const bool has_slot = slot_id < n_t;
  const int64_t i = static_cast<int64_t>(s) * n_t
                    + (has_slot ? slot_id : n_t - 1);

  __shared__ Background bg;
  // the refits' tree, then the Kalman step's rows of a slot
  __shared__ union {
    float red[44][kThreads / 2];
    struct {
      float jac[kBlockSlots][8][8], out[kBlockSlots][8];
      float gain[kBlockSlots][8][4];
    } k;
  } sm;
  __shared__ uint8_t b_inl[kMaxBg];
  __shared__ int pos[kMaxTracks], warp_max[kWarps], h_ok_s;
  __shared__ float h_best[9], h_ref[9], h_norm[9], nrm[44], lmat[8][8];
  __shared__ float trans[64], acc_cov[64];
  __shared__ float cov_s[kBlockSlots][64], mean_s[kBlockSlots][8];

  // ---- what the inputs give: staging, the normalisation, the slots -------
  if (tid < 64) {
    trans[tid] = p.trans[tid];
    acc_cov[tid] = p.acc_cov[tid];
  }
  if (tid < n_t) pos[tid] = f_cap;
  for (int e = tid; e < kBlockSlots * 64; e += kThreads) {
    const int l = part * kBlockSlots + e / 64;
    const int64_t j = static_cast<int64_t>(s) * n_t + (l < n_t ? l : n_t - 1);
    cov_s[e / 64][e % 64] = p.covs[j * 64 + e % 64];
    if (e < kBlockSlots * 8)
      mean_s[e / 8][e % 8] = p.means[(static_cast<int64_t>(s) * n_t
                                      + (part * kBlockSlots + e / 8 < n_t
                                         ? part * kBlockSlots + e / 8
                                         : n_t - 1)) * 8 + e % 8];
  }
  __syncthreads();
  if (tid < f_cap) {
    const int64_t slot = p.forder[static_cast<int64_t>(s) * f_cap + tid];
    if (slot >= 0 && slot < n_t) pos[slot] = tid;
  }
  const float n_valid = stage_background(p, s, bg, sm.red);
  const bool own = tid < n_bg;
  const bool valid_pt = own && bg.bv[tid];
  // the slot's inputs, and its keypoints' copy, need nothing of launch 1:
  // the flow slot's tracked points or the slot's own, four a lane
  const int slot = has_slot ? slot_id : n_t - 1;
  const bool valid = p.valid[i];
  const int age = p.ages[i];
  const bool active = valid && age < 2;
  const bool in_flow = pos[slot] < f_cap && active;
  const int fslot = pos[slot] < f_cap - 1 ? pos[slot] : f_cap - 1;
  const float inl = p.inl[i];
  const bool lost_pending = p.lost_pending[i];
  const bool confirmed = p.hits[i] >= p.confirm_hits;
  bool kpv[kKp / kSlotLanes];
  {
    const float2* kp_src = in_flow
        ? reinterpret_cast<const float2*>(p.all_cur)
          + static_cast<int64_t>(s) * p.n_points + fslot * kKp
        : reinterpret_cast<const float2*>(p.kps) + i * kKp;
    float2* kp_dst = reinterpret_cast<float2*>(p.out_kps) + i * kKp;
#pragma unroll
    for (int q = 0; q < kKp / kSlotLanes; ++q) {
      const int k = r + kSlotLanes * q;
      if (has_slot) kp_dst[k] = kp_src[k];
      kpv[q] = p.kpv[i * kKp + k] != 0;
    }
  }

  // ---- launch 1 done: the homography's arg-max and refits ----------------
  cudaGridDependencySynchronize();
  const Scratch sc = scratch_of(p, s);
  {
    int score = 0;
#pragma unroll
    for (int q = 0; q < kHParts; ++q) score += sc.counts[q * kHypH + tid];
    // the first hypothesis of the highest count
    int key = score * kHypH + (kHypH - 1 - tid);
#pragma unroll
    for (int off = 16; off > 0; off >>= 1) {
      const int other = __shfl_xor_sync(kFull, key, off);
      key = other > key ? other : key;
    }
    if (lane == 0) warp_max[warp] = key;
    __syncthreads();
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      key = warp_max[w] > key ? warp_max[w] : key;
    if (tid < 9) h_best[tid] = sc.hyps[(kHypH - 1 - key % kHypH) * 9 + tid];
    int n_inl = key / kHypH;
    __syncthreads();
    if (own) b_inl[tid] = valid_pt && h_err2(h_best, bg.bp[tid], bg.bc[tid])
                                      < kReproj2;
    __syncthreads();

    // two guarded refits over the inliers' DLT rows
    for (int it = 0; it < 2; ++it) {
      // the 44 sums of the normal equations over the inliers' DLT rows
      // (N[i][j] for i >= j, then the right-hand side): each thread its
      // point's two rows' products, then the block's halving tree
      float terms[44];
      {
        const bool w = own && b_inl[tid];
        const float2 pp = bg.pn[w ? tid : 0], qq = bg.qn[w ? tid : 0];
        float r1[9], r2[9];
#pragma unroll
        for (int c = 0; c < 9; ++c) {
          r1[c] = w ? dlt1(pp, qq, c) : 0.f;
          r2[c] = w ? dlt2(pp, qq, c) : 0.f;
        }
        int e = 0;
#pragma unroll
        for (int a = 0; a < 8; ++a)
#pragma unroll
          for (int b = 0; b <= a; ++b)
            terms[e++] = r1[a] * r1[b] + r2[a] * r2[b];
#pragma unroll
        for (int a = 0; a < 8; ++a)
          terms[36 + a] = r1[a] * r1[8] + r2[a] * r2[8];
      }
      tree_sum<44>(terms, sm.red, nrm);
      if (tid < 32) chol_factor_rows(nrm, lmat);
      __syncwarp();
      if (tid == 0) {
        float l[8][8], rhs[8];
#pragma unroll
        for (int a = 0; a < 8; ++a) {
#pragma unroll
          for (int b = 0; b <= a; ++b) l[a][b] = lmat[a][b];
          rhs[a] = -nrm[36 + a];
        }
        chol_subst<8>(l, rhs);
        float h[9];
        denormalise(rhs, bg.t1, bg.t2inv, h);
#pragma unroll
        for (int a = 0; a < 9; ++a) h_ref[a] = h[a];
      }
      __syncthreads();
      const bool inl_new = valid_pt && h_err2(h_ref, bg.bp[tid], bg.bc[tid])
                                       < kReproj2;
      const int n_new = __syncthreads_count(inl_new);
      if (n_new >= n_inl) {     // every thread takes the same branch
        if (own) b_inl[tid] = inl_new;
        if (tid < 9) h_best[tid] = h_ref[tid];
        n_inl = n_new;
      }
      __syncthreads();
    }
    if (tid < 9) {
      const float h22 = h_best[8];
      const float den = fabsf(h22) > 1e-9f ? h22 : 1e-9f;
      h_norm[tid] = h_best[tid] / den;
    }
    if (tid == 0) h_ok_s = n_valid >= 4.f && n_inl >= p.inlier_thresh;
    __syncthreads();
  }
  const bool h_ok = h_ok_s != 0;
  float* info = p.info + static_cast<int64_t>(s) * (10 + 12 * n_t + 5 * n_bg);
  if (part == 0) {
    if (tid < 10) info[tid] = tid == 0 ? (h_ok ? 1.f : 0.f) : h_norm[tid - 1];
    if (own) {
      float* o = info + 10 + 11 * n_t;
      o[2 * tid] = bg.bp[tid].x;
      o[2 * tid + 1] = bg.bp[tid].y;
      o += 2 * n_bg;
      o[2 * tid] = bg.bc[tid].x;
      o[2 * tid + 1] = bg.bc[tid].y;
      o += 2 * n_bg;
      o[tid] = b_inl[tid] && bg.bv[tid];
    }
  }

  // ---- Kalman and commit: lane r of a slot computes row r ----------------
  const bool ev = sc.est_valid[fslot] != 0;
  const bool has_klt = in_flow && ev;
  const float new_inl = has_klt ? sc.ratio[fslot] : inl;
  const bool kp_clear = in_flow && !ev;
  const float fage = p.age_penalty * static_cast<float>(age);
  const float mult = (fage > 1.f ? fage : 1.f)
                     / (new_inl > 1e-6f ? new_inl : 1e-6f);
  float* row = cov_s[ls] + r * 8;

  // warp by H: lane r its row of the Jacobian and of the warped mean,
  // then row r of J C J^T over the Jacobian's nonzeros
  float mean[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) mean[q] = mean_s[ls][q];
  {
    const float eye[9] = {1.f, 0.f, 0.f, 0.f, 1.f, 0.f, 0.f, 0.f, 1.f};
    float(*jac)[8] = sm.k.jac[ls];
    sm.k.out[ls][r] = warp_row(h_ok ? h_norm : eye, mean, r, jac[r]);
    __syncwarp();
    // row r's nonzeros, in order: columns 2k and 2k + 1, and for a
    // velocity row also 4 + 2k and 5 + 2k (jac_nz), the same code in
    // every lane
    const int k = (r & 3) >> 1, m0 = 2 * k, m2 = 4 + 2 * k;
    float jc[8], cw[8];
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      const float sum2 = jac[r][m0] * cov_s[ls][m0 * 8 + col]
                         + jac[r][m0 + 1] * cov_s[ls][(m0 + 1) * 8 + col];
      const float sum4 = sum2 + jac[r][m2] * cov_s[ls][m2 * 8 + col]
                         + jac[r][m2 + 1] * cov_s[ls][(m2 + 1) * 8 + col];
      jc[col] = r < 4 ? sum2 : sum4;
    }
#pragma unroll
    for (int col = 0; col < 8; ++col) {
      float acc = 0.f;
      bool first = true;
#pragma unroll
      for (int m = 0; m < 8; ++m)
        if (jac_nz(col, m)) {
          acc = first ? jc[m] * jac[col][m] : acc + jc[m] * jac[col][m];
          first = false;
        }
      cw[col] = acc;
    }
#pragma unroll
    for (int q = 0; q < 8; ++q) mean[q] = sm.k.out[ls][q];
    __syncwarp();
#pragma unroll
    for (int c = 0; c < 8; ++c) row[c] = cw[c];
    __syncwarp();
  }

  // predict with size-scaled process noise: row r of F C F^T + Q, then the
  // symmetrisation
  float cs[8];
  {
    const float w = box_w(mean), h = box_h(mean);
    const float std = p.std_factor_acc * (w > h ? w : h) + p.std_offset_acc;
    const float var = std * std;
    float m2[8];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b) acc = acc + mean[b] * trans[8 * a + b];
      m2[a] = acc;
    }
    float tr[8], cp[8];
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k)
        acc = acc + trans[8 * r + k] * cov_s[ls][k * 8 + b];
      tr[b] = acc;
    }
#pragma unroll
    for (int b = 0; b < 8; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int k = 0; k < 8; ++k) acc = acc + tr[k] * trans[8 * b + k];
      cp[b] = acc + acc_cov[8 * r + b] * var;
    }
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 8; ++b) row[b] = cp[b];
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 8; ++b) cs[b] = 0.5f * (cp[b] + cov_s[ls][b * 8 + r]);
    __syncwarp();
#pragma unroll
    for (int b = 0; b < 8; ++b) row[b] = cs[b];
#pragma unroll
    for (int a = 0; a < 8; ++a) mean[a] = m2[a];
    __syncwarp();
  }

  // the correction by the flow's estimate (computed for every slot, kept
  // where has_klt): row r of the gain through the 4x4 innovation system
  float mu[8], cu[8];
  {
    const float w = box_w(mean), h = box_h(mean);
    float sw = p.std_klt[0] * w, sh = p.std_klt[1] * h;
    sw = (sw > p.min_std_klt[0] ? sw : p.min_std_klt[0]) * mult;
    sh = (sh > p.min_std_klt[1] ? sh : p.min_std_klt[1]) * mult;
    const float var[4] = {sw * sw, sh * sh, sw * sw, sh * sh};
    float s4[4][4];
#pragma unroll
    for (int a = 0; a < 4; ++a)
#pragma unroll
      for (int b = 0; b < 4; ++b)
        s4[a][b] = cov_s[ls][a * 8 + b] + (a == b ? var[a] : 0.f);
    float g[4] = {cs[0], cs[1], cs[2], cs[3]};
    chol_solve<4>(s4, g);
#pragma unroll
    for (int a = 0; a < 4; ++a) sm.k.gain[ls][r][a] = g[a];
    __syncwarp();
    float innov[4];
#pragma unroll
    for (int a = 0; a < 4; ++a) innov[a] = sc.est[fslot * 4 + a] - mean[a];
#pragma unroll
    for (int a = 0; a < 8; ++a) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc = acc + sm.k.gain[ls][a][b] * innov[b];
      mu[a] = mean[a] + acc;
    }
    float gs[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) {
      float acc = 0.f;
#pragma unroll
      for (int a = 0; a < 4; ++a) acc = acc + g[a] * s4[a][b];
      gs[b] = acc;
    }
#pragma unroll
    for (int c = 0; c < 8; ++c) {
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < 4; ++b) acc = acc + gs[b] * sm.k.gain[ls][c][b];
      cu[c] = cs[c] - acc;
    }
  }
#pragma unroll
  for (int a = 0; a < 8; ++a) {
    mean[a] = has_klt ? mu[a] : mean[a];
    cu[a] = has_klt ? cu[a] : cs[a];
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
  const bool new_lp = h_ok && (lost_pending || (lost && confirmed));
  if (!has_slot) return;    // no barrier follows

  // the inlier matches of the flow slot's points, or the slot's own
  // keypoints' validity
  const uint32_t kp_bits = sc.kp_bits[fslot];
#pragma unroll
  for (int q = 0; q < kKp / kSlotLanes; ++q) {
    const int k = r + kSlotLanes * q;
    const bool v = in_flow ? (kp_bits >> k) & 1u : kpv[q];
    p.out_kpv[i * kKp + k] = v && !kp_clear && new_valid;
  }
#pragma unroll
  for (int c = 0; c < 8; ++c) p.out_covs[i * 64 + r * 8 + c] = cu[c];
  if (r != 0) return;
#pragma unroll
  for (int a = 0; a < 8; ++a) p.out_means[i * 8 + a] = mean[a];
#pragma unroll
  for (int j = 0; j < 4; ++j)
    p.out_tlbrs[i * 4 + j] = valid ? nb[j] : p.tlbrs[i * 4 + j];
  p.out_valid[i] = new_valid;
  p.out_lost_pending[i] = new_lp;
  p.out_inl[i] = new_inl;

  // the info vector (tracker._flat_info's order)
  float* o = info + 10;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[slot * 4 + j] = nb[j];
  o += 4 * n_t;
  o[slot] = lost;
  o += n_t;
  o[slot] = has_klt;
  o += n_t;
#pragma unroll
  for (int j = 0; j < 4; ++j) o[slot * 4 + j] = sc.est[fslot * 4 + j];
  o += 4 * n_t;
  o[slot] = new_inl;
  o += n_t + 5 * n_bg;
  o[slot] = ev && in_flow;
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

// one launch of `kernel` on `grid` blocks, after the stream's previous
// launch (or, with `early`, beside it: programmatic dependent launch)
cudaError_t launch(void (*kernel)(Params), int grid, bool early,
                   cudaStream_t st, const Params& p) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = early ? 1 : 0;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cudaError_t e = cudaLaunchKernelEx(&cfg, kernel, p);
  return e != cudaSuccess ? e : cudaGetLastError();
}

}  // namespace

extern "C" {

// 4-byte words of one stream's scratch at flow budget f_cap (the wrapper
// allocates n_streams of them)
int gap_commit_scratch_words(int f_cap) { return scratch_words(f_cap); }

// One call of the gap commit for n_streams streams (ints[kStreams]):
// `ptrs` holds the Ptr enum's device pointers in its order, `ints` and
// `floats` the Int and Float enums' values, `seeds` the streams' uint32
// RANSAC seeds (host memory). Makes, on `stream` and for at most
// kLaunchStreams streams at a time (the seeds ride in the kernels'
// parameters), the two launches: the fits (homography and similarity),
// then Kalman and commit. Returns 0 or the first cudaError_t.
int gap_commit_forward(const void* const* ptrs, const int* ints,
                       const float* floats, const uint32_t* seeds,
                       void* stream) {
  Params p = {};
  const int n_streams = ints[kStreams];
  p.n_tracks = ints[kTracks];
  p.f_cap = ints[kFlow];
  p.n_points = ints[kPoints];
  p.n_bg = p.n_points - p.f_cap * kKp;
  if (n_streams < 0 || p.n_tracks < 1 || p.n_tracks > kMaxTracks
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
  const int sim_blocks = (p.f_cap + kWarps - 1) / kWarps;
  const int kalman_blocks = (p.n_tracks + kBlockSlots - 1) / kBlockSlots;
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
    p.scratch = AT(kScratch, float*, scratch_words(p.f_cap));
#undef AT
    for (int i = 0; i < n; ++i) p.seeds[i] = seeds[s0 + i];
    p.streams = n;
    cudaError_t e = launch(gap_fit_kernel, n * (kHParts + sim_blocks), false,
                           st, p);
    if (e == cudaSuccess)
      e = launch(gap_kalman_kernel, n * kalman_blocks, true, st, p);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  return 0;
}

// The RANSAC draws of n_streams seeds at flow budget f_cap, as the kernels
// draw them: u_h [S, HYP_H, 4] and u_a [S, f_cap, HYP_A, 2] float32
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
