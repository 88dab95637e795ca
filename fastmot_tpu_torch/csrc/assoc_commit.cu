// The association frame's commit for Hopper (sm_90a): the lifecycle
// decisions, the slot and history allocation and the state commit of every
// stream of a call, in two launches with no host sync.
//
// Replaces fastmot_tpu/tracker.py:779 _commit_part, which the JAX package
// runs inside its jitted association program (_assoc_frame_kernel,
// :1068-1108). It is not a Pallas kernel but XLA's fusion of a few hundred
// elementwise, gather, scatter, cumsum and argsort ops on [128]-slot state.
// Its plain PyTorch twin is commit_part in fastmot_tpu_torch/tracker.py
// (eager: a few hundred launches; commit_batch runs it under
// torch.func.vmap for several streams); the wrapper assoc_commit in
// fastmot_tpu_torch/ops/assoc_commit.py checks the arguments and calls
// assoc_commit_forward below.
//
// What bounds it on an H100: neither. A stream moves about 1 MB (the
// tracks', the history's and the detections' 512-wide feature rows, read
// once and written once) and does a few thousand float operations a
// matched track (a 4x4 Cholesky solve and the 8x8 covariance update); the
// card would take well under a microsecond for either. The time is the
// chain of decisions, each of which waits on the last: rectify, then the
// lifecycle, then the free slots' ranks, then the state rows, then the
// history's ranks. So the decisions of a stream are one block
// (assoc_commit_kernel), a thread a row (a track slot, a detection or a
// history slot) in shared memory between barriers, in the plain version's
// order (1-5 below); the block first stages every input it reads but the
// wide rows in shared memory at once (the decisions' fields by 16-byte
// cp.async of every thread, the means and covariances by cp.async.bulk on
// an mbarrier, landing while the decisions run; plain copies where a row
// is not 16-byte aligned), so that no phase waits on a first touch of
// device memory. The matched Kalman updates, a long
// dependent chain, are spread over 8 lanes a slot. The wide rows, which
// only copy and add, are a second launch of many blocks a stream
// (assoc_commit_rows_kernel, 6 below), behind the first by a programmatic
// dependent launch, from a plan the first writes to a scratch buffer:
//
//   1. rectify: each track with a rectify match j is merged into j (j ended
//      before it started) or a duplicate (it takes j's detection, and j
//      loses it); merge_src[j] is the merged track (the last one if two
//      named the same j: the plain scatter's last write, by atomicMax; the
//      finals' greedy matching never names one twice);
//   2. matched / unmatched / retired tracks, the reinstated history rows
//      and the detections they take, the detections that create a track;
//   3. the free slots, the reinstates, the creations and the matched slots
//      ranked by ballots of a warp each (the plain version's cumsum), the
//      first free slots given to the reinstates, then to the creations in
//      detection order; what does not fit is dropped (n_dropped); beside
//      that, the matched Kalman updates (JAX's order: fastmot_tpu/
//      kalman.py:184 update with the unrolled Cholesky of fastmot_tpu/ops/
//      smallmat.py chol_solve4), 8 lanes a matched slot in rank order:
//      each lane factors the projected covariance itself, solves its row
//      of the gain, and takes the other rows' gains by shuffles for its
//      row of the new covariance;
//   4. 8 lanes an unmatched slot (a lane a row of the means and
//      covariances, by 16-byte accesses): the merge's rows, the
//      creations' state; then a thread a slot: the reinstated features'
//      count, the new box, IoS against the frame, the bookkeeping fields
//      and the info vector;
//   5. the history: its allocation order (invalid slots ascending, then
//      the oldest insertion) and, after the save, the eviction ranks are
//      exact stable ranks by comparison counting over its keys, 8 lanes a
//      slot (the plain version's stable argsort and double argsort); the
//      saves' targets, the slots they steal, the evictions beyond
//      history_size;
//   6. the 512-wide rows, a warp a row, 8 rows a block, by 16-byte loads
//      and stores: the tracks' feature sums (the merge's sum, the
//      reinstate's history row, zero for a fresh track, plus the
//      detection's embedding, each add in the plain version's order), the
//      history rows (a saved track's sum again, the others copied), the
//      keypoints.
//
// Numerics. Build with -fmad=false: every product and sum is rounded on its
// own, as in the g++ build of the tests under -ffp-contract=off, so the two
// builds agree bit for bit. Everything but the Kalman update is the plain
// version's arithmetic in its order, so bit for bit; the update solves
// through JAX's Cholesky where the plain version takes LAPACK's LU, so
// means and covariances agree within float32 rounding
// (tests/test_torch_assoc_commit.py states the tolerance); each lane of an
// update computes its row in the order one thread computed it in the
// first design, so the bits did not move. Every loop strides by blockDim.x (or
// its groups of 8 lanes) and takes whole warps, and every loop with a
// shuffle runs the same count on every lane, so a block of 32 or 64
// threads computes what 512 compute (the tests' host build runs such
// blocks). The rows launch reads only what the first launch wrote and the
// inputs, after cudaGridDependencySynchronize, so the host build, which
// runs the launches one after another, computes what the card does.

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;
constexpr int kRowsPerBlock = kThreads / 32;   // the rows launch's
// the decisions' block: 64 groups of 8 lanes, so that a frame's matched
// updates take one round up to 64 matches
constexpr int kDecisionThreads = 512;
constexpr int kMaxRows = 256;    // track slots, detections, history slots
constexpr int kSlotLanes = 8;    // lanes a slot in phases 3 and 4
constexpr unsigned kFull = 0xFFFFFFFFu;

// assoc_commit_forward's pointers, in this order (commit_launch_args in
// ops/assoc_commit.py lists them): the state's 15 fields (tracker.N_STATE
// order), the history's 6, the detections' boxes, labels, valid mask and
// embeddings, the cascade's outputs, the frame box; then the new state's
// 15 fields, the new history's 6 and the info vector
enum Ptr {
  kMeans, kCovs, kTlbrs, kValid, kAges, kHits, kLabels, kStartF, kEndF,
  kLostPending, kInl, kKps, kKpv, kFeatSum, kFeatCount,
  kHistSum, kHistCount, kHLabels, kHValid, kHLru, kHHits,
  kDTlbrs, kDLabels, kDValid, kDEmb,
  kOccluded, kCol4Row, kUDetConf, kReidC4R, kRectC4R, kFrameTlbr,
  kOut,                           // kOut + k: the new state's field k
  kOutHist = kOut + 15,           // kOutHist + k: the new history's
  kInfo = kOutHist + 6,
  kScratch,                       // the wide rows' plan, [S, plan_ints]
  kNumPtrs
};
enum Int {
  kStreams, kTracks, kDets, kHist, kFeat, kKp, kConfirmHits, kMaxAge,
  kHistorySize, kFrameId, kNumInts
};
enum Float {
  kSfDetW, kSfDetH, kMinDetW, kMinDetH, kPosWeight, kVelWeight, kNumFloats
};

// the inputs staged in dynamic shared memory, in this order: (Ptr, bytes
// an element, rows: 0 the slots T, 1 the detections D, 2 the history H, 3
// one row for every stream, elements a row). The decisions' fields come
// first, the means and covariances, which only the updates and the slots
// read, last: they land behind an mbarrier while the decisions run.
enum Staged {
  sTlbrs, sValid, sAges, sHits, sLabels, sStartF, sEndF, sLost, sInl, sFc,
  sCol4Row, sRect, sHc, sHLabels, sHValid, sHLru, sHHits, sReid, sDTlbrs,
  sDLabels, sDValid, sOccluded, sConf, sFrame, sMeans, sCovs, kNumStaged
};
constexpr int kFirstLate = sMeans;   // the fields behind the mbarrier
struct StagedField {
  int ptr, bytes, rows, width;
};
inline StagedField staged_field(int k) {
  const StagedField table[kNumStaged] = {
      {kTlbrs, 4, 0, 4},       {kValid, 1, 0, 1},     {kAges, 4, 0, 1},
      {kHits, 4, 0, 1},        {kLabels, 4, 0, 1},    {kStartF, 4, 0, 1},
      {kEndF, 4, 0, 1},        {kLostPending, 1, 0, 1}, {kInl, 4, 0, 1},
      {kFeatCount, 4, 0, 1},   {kCol4Row, 4, 0, 1},   {kRectC4R, 4, 0, 1},
      {kHistCount, 4, 2, 1},   {kHLabels, 4, 2, 1},   {kHValid, 1, 2, 1},
      {kHLru, 4, 2, 1},        {kHHits, 4, 2, 1},     {kReidC4R, 4, 2, 1},
      {kDTlbrs, 4, 1, 4},      {kDLabels, 4, 1, 1},   {kDValid, 1, 1, 1},
      {kOccluded, 1, 1, 1},    {kUDetConf, 1, 1, 1},  {kFrameTlbr, 4, 3, 4},
      {kMeans, 4, 0, 8},       {kCovs, 4, 0, 64}};
  return table[k];
}

// a field's bytes for one stream
inline int field_bytes(const StagedField& f, int t, int d, int h) {
  const int n = f.rows == 0 ? t : f.rows == 1 ? d : f.rows == 2 ? h : 1;
  return n * f.width * f.bytes;
}

// the dynamic shared memory a block stages its stream's inputs in, each
// field at a 16-byte boundary: its bytes, and each field's offset into
// `off` where given
inline int staged_layout(int t, int d, int h, int* off) {
  int at = 0;
  for (int k = 0; k < kNumStaged; ++k) {
    if (off) off[k] = at;
    at += (field_bytes(staged_field(k), t, d, h) + 15) / 16 * 16;
  }
  return at;
}

struct Params {
  const void* p[kNumPtrs];
  int streams, t, d, h, f, k, confirm_hits, max_age, history_size,
      frame_id;
  float sf_w, sf_h, mn_w, mn_h, pos_w, vel_w;
  // each staged field's first stream's source, bytes from one stream's to
  // the next (0 for the frame box), bytes a stream and offset in the
  // dynamic shared memory, worked out by the C entry
  const unsigned char* f_src[kNumStaged];
  int f_stride[kNumStaged], f_bytes[kNumStaged], f_off[kNumStaged];
};

template <class V>
__device__ __forceinline__ const V* in(const Params& p, int k, size_t off) {
  return static_cast<const V*>(p.p[k]) + off;
}

template <class V>
__device__ __forceinline__ V* out(const Params& p, int k, size_t off) {
  return static_cast<V*>(const_cast<void*>(p.p[k])) + off;
}

// torch.maximum / torch.minimum: NaN if either is
__device__ __forceinline__ float max_nan(float a, float b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a > b ? a : b);
}

__device__ __forceinline__ float min_nan(float a, float b) {
  return (a != a || b != b) ? (a != a ? a : b) : (a < b ? a : b);
}

// row r of the matched Kalman correction of a detector measurement z
// (multiplier 1), fastmot_tpu/kalman.py update's order, on lane r of the
// slot's 8 (`base` the first of them in the warp): the projected
// covariance S and its Cholesky (the diagonal clamped at 1e-12), factored
// by each lane alike; the lane's gain row by forward and back
// substitution; then mean + gain (z - mean) and cov - (gain S) gain^T,
// each sum in ascending order, the other rows' gains by shuffles. m the
// slot's mean and c its covariance (row-major, shared memory); returns row
// r of the new mean in *mr and of the new covariance in crow. Every lane of
// the warp calls it together.
__device__ void kalman_update_row(const Params& p, const float* m,
                                  const float* c, const float* z, int r,
                                  int base, float* mr, float (&crow)[8]) {
  const float w = m[2] - m[0] + 1.f, h = m[3] - m[1] + 1.f;
  const float sw = max_nan(p.sf_w * w, p.mn_w) * 1.f;
  const float sh = max_nan(p.sf_h * h, p.mn_h) * 1.f;
  const float sd[4] = {sw, sh, sw, sh};
  float s[4][4], l[4][4];
#pragma unroll
  for (int a = 0; a < 4; ++a)
#pragma unroll
    for (int b = 0; b < 4; ++b)
      s[a][b] = c[a * 8 + b] + (a == b ? sd[a] * sd[a] : 0.f);
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j <= i; ++j) {
      float v = s[i][j];
#pragma unroll
      for (int k = 0; k < j; ++k) v = v - l[i][k] * l[j][k];
      l[i][j] = i == j ? sqrtf(v > 1e-12f ? v : 1e-12f) : v / l[j][j];
    }
  float c_r[8];
#pragma unroll
  for (int q = 0; q < 8; ++q) c_r[q] = c[r * 8 + q];
  float g[4];
  {
    float x[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float v = c_r[i];
#pragma unroll
      for (int k = 0; k < i; ++k) v = v - l[i][k] * x[k];
      x[i] = v / l[i][i];
    }
#pragma unroll
    for (int i = 3; i >= 0; --i) {
      float v = x[i];
#pragma unroll
      for (int k = i + 1; k < 4; ++k) v = v - l[k][i] * x[k];
      x[i] = v / l[i][i];
    }
#pragma unroll
    for (int i = 0; i < 4; ++i) g[i] = x[i];
  }
  {
    float v = g[0] * (z[0] - m[0]);
#pragma unroll
    for (int a = 1; a < 4; ++a) v = v + g[a] * (z[a] - m[a]);
    *mr = m[r] + v;
  }
  float gs[4];
#pragma unroll
  for (int b = 0; b < 4; ++b) {
    float v = g[0] * s[0][b];
#pragma unroll
    for (int a = 1; a < 4; ++a) v = v + g[a] * s[a][b];
    gs[b] = v;
  }
#pragma unroll
  for (int q = 0; q < 8; ++q) {
    float gq[4];
#pragma unroll
    for (int b = 0; b < 4; ++b) gq[b] = __shfl_sync(kFull, g[b], base + q);
    float v = gs[0] * gq[0];
#pragma unroll
    for (int b = 1; b < 4; ++b) v = v + gs[b] * gq[b];
    crow[q] = c_r[q] - v;
  }
}

// row r of kalman.create of a detection box, in its order
__device__ __forceinline__ void kalman_create_row(const Params& p,
                                                  const float* z, int r,
                                                  float* mr,
                                                  float (&crow)[8]) {
  const float w = z[2] - z[0] + 1.f, h = z[3] - z[1] + 1.f;
  const bool x = (r & 1) == 0;
  const float wh = (x ? 1.f : 0.f) * w + (x ? 0.f : 1.f) * h;
  const float std = max_nan((r < 4 ? p.pos_w : p.vel_w)
                            * (x ? p.sf_w : p.sf_h) * wh,
                            x ? p.mn_w : p.mn_h);
  *mr = r < 4 ? z[r] : 0.f;
#pragma unroll
  for (int q = 0; q < 8; ++q) crow[q] = q == r ? std * std : 0.f;
}

// geometry.ios of a box against the frame
__device__ __forceinline__ float ios_frame(const float* b, const float* fr) {
  const float w0 = min_nan(b[2], fr[2]) - max_nan(b[0], fr[0]) + 1.f;
  const float w1 = min_nan(b[3], fr[3]) - max_nan(b[1], fr[1]) + 1.f;
  const float inter = (w0 > 0.f && w1 > 0.f) ? w0 * w1 : 0.f;
  const float aw = b[2] - b[0] + 1.f, ah = b[3] - b[1] + 1.f;
  const float area = (aw > 0.f && ah > 0.f) ? aw * ah : 0.f;
  return area > 0.f ? inter / area : 0.f;
}

// the exclusive ranks of the set flags among the first n (a warp's
// ballots, the plain version's cumsum - 1 at each set flag); returns
// their count
__device__ int warp_ranks(const unsigned char* flag, int n, int* rank) {
  const int lane = threadIdx.x & 31;
  int base = 0;
  for (int x0 = 0; x0 < n; x0 += 32) {
    const int x = x0 + lane;
    const bool f = x < n && flag[x];
    const unsigned b = __ballot_sync(kFull, f);
    if (x < n) rank[x] = base + __popc(b & ((1u << lane) - 1u));
    base += __popc(b);
  }
  return base;
}

// x's place in the stable ascending order of key[0, n), counted by the 8
// lanes of x's group (lane r the keys y = r mod 8) and summed by shuffles;
// every lane of the warp calls it together
__device__ __forceinline__ int stable_rank8(const float* key, int n, int x,
                                            int r) {
  const float kx = key[x];
  int c = 0;
  for (int y = r; y < n; y += kSlotLanes)
    c += key[y] < kx || (key[y] == kx && y < x);
  c += __shfl_xor_sync(kFull, c, 1);
  c += __shfl_xor_sync(kFull, c, 2);
  return c + __shfl_xor_sync(kFull, c, 4);
}

// the ints of a stream's plan of the wide rows: (the track whose new sum
// the row takes or -1, the merged track, the reinstated history row, the
// absorbed detection, fresh) a track row and a history row, then (the
// keypoints' source row, created) a track row
__host__ __device__ __forceinline__ int plan_ints(int tracks, int hist) {
  return 5 * (tracks + hist) + 2 * tracks;
}

__device__ __forceinline__ bool aligned16(const void* ptr) {
  return (reinterpret_cast<uintptr_t>(ptr) & 15u) == 0;
}

// 8 floats of a row, by two 16-byte accesses where `vec`
__device__ __forceinline__ void load8(const float* src, float (&v)[8],
                                      bool vec) {
  if (vec) {
    const float4 a = reinterpret_cast<const float4*>(src)[0];
    const float4 b = reinterpret_cast<const float4*>(src)[1];
    v[0] = a.x; v[1] = a.y; v[2] = a.z; v[3] = a.w;
    v[4] = b.x; v[5] = b.y; v[6] = b.z; v[7] = b.w;
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) v[k] = src[k];
  }
}

__device__ __forceinline__ void store8(float* dst, const float (&v)[8],
                                       bool vec) {
  if (vec) {
    reinterpret_cast<float4*>(dst)[0] = make_float4(v[0], v[1], v[2], v[3]);
    reinterpret_cast<float4*>(dst)[1] = make_float4(v[4], v[5], v[6], v[7]);
  } else {
#pragma unroll
    for (int k = 0; k < 8; ++k) dst[k] = v[k];
  }
}

// a track's new feature sum, in the plain version's order: its row (plus
// the merged track's), or the reinstated history row, or zero for a fresh
// track; plus the absorbed detection's embedding
struct Sum {
  const float* own;
  const float* merged;      // null: no merge
  const float* reinstated;  // null: no reinstate
  const float* absorbed;    // null: no embedding absorbed
  bool fresh;
};

__device__ __forceinline__ float sum_at(const Sum& s, int f) {
  float v = s.own[f];
  if (s.merged) v = v + s.merged[f];
  if (s.reinstated) v = s.reinstated[f];
  if (s.fresh) v = 0.f;
  if (s.absorbed) v = v + s.absorbed[f];
  return v;
}

// a row of F floats by a warp's lanes: float4 by float4 where `vec`
__device__ __forceinline__ void sum_row(const Sum& s, float* dst, int F,
                                        bool vec, int lane) {
  if (!vec) {
    for (int f = lane; f < F; f += 32) dst[f] = sum_at(s, f);
    return;
  }
  for (int q = lane; q < F / 4; q += 32) {
    const float4 a = reinterpret_cast<const float4*>(s.own)[q];
    float v[4] = {a.x, a.y, a.z, a.w};
    if (s.merged) {
      const float4 b = reinterpret_cast<const float4*>(s.merged)[q];
      v[0] = v[0] + b.x;
      v[1] = v[1] + b.y;
      v[2] = v[2] + b.z;
      v[3] = v[3] + b.w;
    }
    if (s.reinstated) {
      const float4 h = reinterpret_cast<const float4*>(s.reinstated)[q];
      v[0] = h.x;
      v[1] = h.y;
      v[2] = h.z;
      v[3] = h.w;
    }
    if (s.fresh) v[0] = v[1] = v[2] = v[3] = 0.f;
    if (s.absorbed) {
      const float4 e = reinterpret_cast<const float4*>(s.absorbed)[q];
      v[0] = v[0] + e.x;
      v[1] = v[1] + e.y;
      v[2] = v[2] + e.z;
      v[3] = v[3] + e.w;
    }
    reinterpret_cast<float4*>(dst)[q] = make_float4(v[0], v[1], v[2], v[3]);
  }
}

__device__ __forceinline__ void copy_row(const float* src, float* dst, int F,
                                         bool vec, int lane) {
  if (!vec) {
    for (int f = lane; f < F; f += 32) dst[f] = src[f];
    return;
  }
  for (int q = lane; q < F / 4; q += 32)
    reinterpret_cast<float4*>(dst)[q] = reinterpret_cast<const float4*>(src)[q];
}

// ---------------------------------------------------------------------------
// Staging a stream's inputs in shared memory
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
#endif

// Stages stream s's fields into `dyn` at their offsets. The decisions'
// fields go by 16-byte cp.async, every thread its share, all in flight at
// once; the means and covariances (kFirstLate on), where 16-byte aligned,
// by one cp.async.bulk each on the mbarrier `bar`, which thread 0 arms
// (bulk says whether it did; stage_wait waits for them after a barrier). A
// field that is not 16-byte aligned is copied by plain loads, as the host
// build copies every field. The calling thread's cp.async copies are done
// when it returns.
__device__ void stage_inputs(const Params& p, int s, unsigned char* dyn,
                             unsigned long long* bar, int* bulk) {
  const int tid = threadIdx.x, nt = blockDim.x;
  const unsigned char* src[kNumStaged];
  bool aligned[kNumStaged];
#pragma unroll
  for (int k = 0; k < kNumStaged; ++k) {
    src[k] = p.f_src[k] + static_cast<size_t>(s) * p.f_stride[k];
    aligned[k] = (reinterpret_cast<uintptr_t>(src[k]) & 15u) == 0
                 && p.f_bytes[k] % 16 == 0;
  }
#if defined(__CUDA_ARCH__)
  if (tid == 0) {
    unsigned total = 0u;
#pragma unroll
    for (int k = kFirstLate; k < kNumStaged; ++k)
      if (aligned[k]) total += static_cast<unsigned>(p.f_bytes[k]);
    *bulk = total != 0u;
    if (total) {
      const unsigned b = smem_addr(bar);
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(b), "r"(total) : "memory");
#pragma unroll
      for (int k = kFirstLate; k < kNumStaged; ++k)
        if (aligned[k])
          asm volatile(
              "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx"
              "::bytes [%0], [%1], %2, [%3];\n"
              :: "r"(smem_addr(dyn + p.f_off[k])), "l"(src[k]),
                 "r"(p.f_bytes[k]), "r"(b) : "memory");
    }
  }
#else
  (void)bar;
  if (tid == 0) *bulk = 0;
#endif
#pragma unroll
  for (int k = 0; k < kNumStaged; ++k) {
    unsigned char* dst = dyn + p.f_off[k];
    const int bytes = p.f_bytes[k];
#if defined(__CUDA_ARCH__)
    if (aligned[k]) {
      if (k < kFirstLate)
        for (int x = tid; x < bytes / 16; x += nt)
          asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                       :: "r"(smem_addr(dst + 16 * x)),
                          "l"(src[k] + 16 * x) : "memory");
      continue;
    }
#endif
    if ((reinterpret_cast<uintptr_t>(src[k]) & 3u) == 0 && bytes % 4 == 0) {
      const unsigned* s4 = reinterpret_cast<const unsigned*>(src[k]);
      unsigned* d4 = reinterpret_cast<unsigned*>(dst);
      for (int x = tid; x < bytes / 4; x += nt) d4[x] = s4[x];
    } else {
      for (int x = tid; x < bytes; x += nt) dst[x] = src[k][x];
    }
  }
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
               "memory");
#endif
}

// the bulk copies landed (after a barrier that follows stage_inputs)
__device__ __forceinline__ void stage_wait(unsigned long long* bar,
                                           int bulk) {
#if defined(__CUDA_ARCH__)
  if (!bulk) return;
  const unsigned b = smem_addr(bar);
  unsigned done = 0;
  while (!done)
    asm volatile(
        "{\n .reg .pred p;\n"
        " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        " selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done) : "r"(b), "r"(0u) : "memory");
#else
  (void)bar;
  (void)bulk;
#endif
}

__global__ void __launch_bounds__(kDecisionThreads)
assoc_commit_kernel(const Params p) {
  extern __shared__ float4 staged_v[];
  __shared__ int c1[kMaxRows], merge_src[kMaxRows], rect_j[kMaxRows];
  __shared__ unsigned merge_plus1[kMaxRows];
  __shared__ int match_det[kMaxRows], free_rank[kMaxRows];
  __shared__ int free_idx[kMaxRows], reinstate_hist[kMaxRows];
  __shared__ int create_det[kMaxRows], save_rank[kMaxRows];
  __shared__ int new_hits[kMaxRows];
  __shared__ int fsrc[kMaxRows], frh[kMaxRows], fdet[kMaxRows];
  __shared__ float fcount[kMaxRows];
  __shared__ unsigned char merge_cond[kMaxRows], dup[kMaxRows];
  __shared__ unsigned char dup_target[kMaxRows], feat_ok[kMaxRows];
  __shared__ unsigned char keep_unmatched[kMaxRows], retire[kMaxRows];
  __shared__ unsigned char is_free[kMaxRows], save[kMaxRows];
  __shared__ unsigned char fresh[kMaxRows], matched[kMaxRows];
  __shared__ unsigned char taken[kMaxRows], create[kMaxRows];
  __shared__ int c_rank[kMaxRows], m_rank[kMaxRows], upd_slot[kMaxRows];
  __shared__ unsigned char reinst[kMaxRows], h_valid2[kMaxRows];
  __shared__ unsigned char h_valid3[kMaxRows];
  __shared__ int reid_det[kMaxRows], r_rank[kMaxRows], alloc_order[kMaxRows];
  __shared__ int h_src[kMaxRows];
  __shared__ float hkey[kMaxRows];
  __shared__ float new_mean4[kMaxRows][4];   // an updated slot's box part
  __shared__ unsigned long long bar;
  __shared__ int bulk;
  __shared__ int n_free, n_reid, n_create, n_upd, stolen, n_hvalid,
      n_dvalid;

  // the rows launch may start now; it waits for this grid's end before it
  // reads the plan
  cudaTriggerProgrammaticLaunchCompletion();
  const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int warp = tid >> 5, n_warps = nt >> 5;
  const int T = p.t, D = p.d, H = p.h;
  unsigned char* dyn = reinterpret_cast<unsigned char*>(staged_v);
  stage_inputs(p, s, dyn, &bar, &bulk);
  const size_t st = static_cast<size_t>(s) * T,
               sh = static_cast<size_t>(s) * H;
  float* info = out<float>(p, kInfo, static_cast<size_t>(s)
                           * (4 + 90 * static_cast<size_t>(T) + H));
  float* i_match = info + 4;
  float* i_merge = i_match + T;
  float* i_dup = i_merge + T;
  float* i_del = i_dup + T;
  float* i_retire = i_del + T;
  float* i_oof = i_retire + T;
  float* i_hdst = i_oof + T;
  float* i_reinst = i_hdst + T;
  float* i_create = i_reinst + T;
  float* i_ages = i_create + T;
  float* i_hits = i_ages + T;
  float* i_labels = i_hits + T;
  float* i_valid = i_labels + T;
  float* i_featok = i_valid + T;
  float* i_evict = i_featok + T;
  float* i_next = i_evict + H;
  float* i_means = i_next + 4 * T;
  float* i_covs = i_means + 8 * T;
  if (tid == 0) {
    stolen = 0;
    n_hvalid = 0;
  }
  __syncthreads();     // every thread's cp.async copies are in
  // the staged inputs of the stream
#define STAGED(type, k) reinterpret_cast<type*>(dyn + p.f_off[k])
  const unsigned char* valid = STAGED(const unsigned char, sValid);
  const int* hits = STAGED(const int, sHits);
  const int* start_f = STAGED(const int, sStartF);
  const int* end_f = STAGED(const int, sEndF);
  const int* col4row = STAGED(const int, sCol4Row);
  const int* rect = STAGED(const int, sRect);
  const unsigned char* occluded = STAGED(const unsigned char, sOccluded);
  const int* ages = STAGED(const int, sAges);
  const float* hc = STAGED(const float, sHc);
  const int* h_labels = STAGED(const int, sHLabels);
  const unsigned char* hv = STAGED(const unsigned char, sHValid);
  const int* lru = STAGED(const int, sHLru);
  const int* h_hits = STAGED(const int, sHHits);
  const int* labels = STAGED(const int, sLabels);
  const unsigned char* dv = STAGED(const unsigned char, sDValid);

  // ---- 1. rectify: merge or duplicate; the reinstated history rows ------
  for (int i = tid; i < T; i += nt) {
    const int r = rect[i];
    const bool has = r >= 0 && r < T;
    const int j = has ? r : 0;
    const bool mc = has && end_f[j] < start_f[i];
    merge_cond[i] = mc;
    dup[i] = has && !mc;
    rect_j[i] = has ? j : -1;
    c1[i] = (has && !mc) ? col4row[j] : col4row[i];
    reinstate_hist[i] = -1;
    create_det[i] = -1;
    merge_plus1[i] = 0;
    dup_target[i] = 0;
  }
  for (int x = tid; x < D; x += nt) taken[x] = 0;
  {
    const int* reid = STAGED(const int, sReid);
    for (int x = tid; x < H; x += nt) {
      const bool re = reid[x] >= 0 && hv[x] && hc[x] >= 2.f;
      reinst[x] = re;
      reid_det[x] = re ? reid[x] : 0;
      h_src[x] = -1;
    }
  }
  __syncthreads();

  // ---- the scatters: merge_src (the last track naming a target, by
  // atomicMax of its index + 1), the duplicates' targets, the detections
  // reID takes -------------------------------------------------------------
  for (int i = tid; i < T; i += nt) {
    if (merge_cond[i]) atomicMax(&merge_plus1[rect_j[i]], i + 1u);
    if (dup[i]) dup_target[rect_j[i]] = 1;
  }
  for (int y = tid; y < H; y += nt)
    if (reinst[y] && reid_det[y] < D) taken[reid_det[y]] = 1;
  __syncthreads();

  // ---- 2. lifecycle decisions ------------------------------------------
  {
    for (int i = tid; i < T; i += nt) {
      merge_src[i] = static_cast<int>(merge_plus1[i]) - 1;
      const int c2 = dup_target[i] ? -1 : c1[i];
      const bool merged = merge_cond[i];
      const bool mt = c2 >= 0 && c2 < D && valid[i] && !merged;
      const int col = mt ? c2 : -1;
      const bool unmatched = valid[i] && !merged && !mt;
      const bool confirmed = hits[i] >= p.confirm_hits;
      const bool del = unmatched && !confirmed;
      const bool ret = unmatched && confirmed && ages[i] + 1 > p.max_age;
      match_det[i] = col;
      matched[i] = mt;
      feat_ok[i] = mt && !occluded[col];
      keep_unmatched[i] = unmatched && !del && !ret;
      retire[i] = ret;
      is_free[i] = !valid[i] || merged || del || ret;
      i_match[i] = static_cast<float>(col);
      i_merge[i] = static_cast<float>(merge_src[i]);
      i_dup[i] = dup[i] ? 1.f : 0.f;
      i_del[i] = del ? 1.f : 0.f;
      i_retire[i] = ret ? 1.f : 0.f;
    }
    const unsigned char* conf = STAGED(const unsigned char, sConf);
    for (int x = tid; x < D; x += nt)
      create[x] = conf[x] && (occluded[x] || !taken[x]) && dv[x];
  }
  __syncthreads();

  // ---- 3. ranks: the free slots, the reinstates, the creations, the
  // matched slots; the valid detections' count ----------------------------
  if (warp == 0 % n_warps) {
    const int n = warp_ranks(is_free, T, free_rank);
    if ((tid & 31) == 0) n_free = n;
    __syncwarp();
    for (int i = tid & 31; i < T; i += 32)
      if (is_free[i]) free_idx[free_rank[i]] = i;
  }
  if (warp == 1 % n_warps) {
    const int n = warp_ranks(reinst, H, r_rank);
    if ((tid & 31) == 0) n_reid = n;
  }
  if (warp == 2 % n_warps) {
    const int n = warp_ranks(create, D, c_rank);
    if ((tid & 31) == 0) n_create = n;
  }
  if (warp == 3 % n_warps) {
    const int n = warp_ranks(matched, T, m_rank);
    if ((tid & 31) == 0) n_upd = n;
    __syncwarp();
    for (int i = tid & 31; i < T; i += 32)
      if (matched[i]) upd_slot[m_rank[i]] = i;
  }
  if (warp == 4 % n_warps) {
    int n = 0;
    for (int x0 = 0; x0 < D; x0 += 32) {
      const int x = x0 + (tid & 31);
      n += __popc(__ballot_sync(kFull, x < D && dv[x]));
    }
    if ((tid & 31) == 0) n_dvalid = n;
  }
  __syncthreads();
  stage_wait(&bar, bulk);     // the means and covariances
  const int lane = tid & 31, r = tid & (kSlotLanes - 1);
  const int group = tid / kSlotLanes, n_groups = nt / kSlotLanes;
  const float* means = STAGED(const float, sMeans);
  const float* covs = STAGED(const float, sCovs);
  const float* d_tlbrs = STAGED(const float, sDTlbrs);
  float* o_means = out<float>(p, kOut + 0, st * 8);
  float* o_covs = out<float>(p, kOut + 1, st * 64);
  // 16-byte accesses to the new means' and covariances' rows where aligned
  const bool vec_state = aligned16(o_means) && aligned16(o_covs);
  const bool vec_info = aligned16(i_means) && aligned16(i_covs);
  {
    for (int x = tid; x < H; x += nt) {
      const bool ok = reinst[x] && r_rank[x] < n_free;
      if (ok) {
        const int slot = free_idx[r_rank[x]];
        reinstate_hist[slot] = x;
        create_det[slot] = reid_det[x];
      }
      h_valid2[x] = hv[x] && !ok;
    }
    for (int x = tid; x < D; x += nt) {
      const int rk = n_reid + c_rank[x];
      if (create[x] && rk < n_free) create_det[free_idx[rk]] = x;
    }
    // the matched Kalman updates, 8 lanes a slot in rank order; every lane
    // runs every round (the shuffles take the whole warp), a group past
    // the last slot on the last one and writing nothing
    const int n = n_upd;
    for (int k0 = 0; k0 < n; k0 += n_groups) {
      const bool act = k0 + group < n;
      const int i = upd_slot[act ? k0 + group : n - 1];
      const int ms = merge_src[i];
      const int src = ms >= 0 ? ms : i;
      float mr, crow[8];
      kalman_update_row(p, means + src * 8, covs + src * 64,
                        d_tlbrs + match_det[i] * 4, r,
                        lane & ~(kSlotLanes - 1), &mr, crow);
      if (act) {
        o_means[i * 8 + r] = mr;
        i_means[i * 8 + r] = mr;
        store8(o_covs + i * 64 + r * 8, crow, vec_state);
        store8(i_covs + i * 64 + r * 8, crow, vec_info);
        if (r < 4) new_mean4[i][r] = mr;
      }
    }
  }
  __syncthreads();

  // ---- 4. the slots: 8 lanes a slot write the rows of the unmatched
  // slots' means and covariances, then a thread a slot commits it --------
  {
    for (int i = group; i < T; i += n_groups) {
      if (match_det[i] >= 0) continue;   // written with the update
      const int ms = merge_src[i];
      const int src = ms >= 0 ? ms : i;
      const int cd = create_det[i];
      float mr, crow[8];
      if (cd >= 0) {
        kalman_create_row(p, d_tlbrs + cd * 4, r, &mr, crow);
      } else {
        mr = means[src * 8 + r];
        load8(covs + src * 64 + r * 8, crow, true);
      }
      o_means[i * 8 + r] = mr;
      i_means[i * 8 + r] = mr;
      store8(o_covs + i * 64 + r * 8, crow, vec_state);
      store8(i_covs + i * 64 + r * 8, crow, vec_info);
    }
    const float* tlbrs = STAGED(const float, sTlbrs);
    const unsigned char* lost = STAGED(const unsigned char, sLost);
    const float* inl = STAGED(const float, sInl);
    const float* fc = STAGED(const float, sFc);
    const int* d_labels = STAGED(const int, sDLabels);
    const float* frame = STAGED(const float, sFrame);
    float* o_tlbrs = out<float>(p, kOut + 2, st * 4);
    unsigned char* o_valid = out<unsigned char>(p, kOut + 3, st);
    int* o_ages = out<int>(p, kOut + 4, st);
    int* o_hits = out<int>(p, kOut + 5, st);
    int* o_labels = out<int>(p, kOut + 6, st);
    int* o_start = out<int>(p, kOut + 7, st);
    int* o_end = out<int>(p, kOut + 8, st);
    unsigned char* o_lost = out<unsigned char>(p, kOut + 9, st);
    float* o_inl = out<float>(p, kOut + 10, st);
    float* o_fc = out<float>(p, kOut + 14, st);
    for (int i = tid; i < T; i += nt) {
      const int ms = merge_src[i];
      const bool has_merge = ms >= 0;
      const int src = has_merge ? ms : i;
      const int md = match_det[i];
      const bool mm = md >= 0;
      const int cd = create_det[i];
      const bool cr = cd >= 0;
      const int cdet = cr ? cd : 0;
      float box[4], next[4];
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        box[k] = tlbrs[src * 4 + k];
        const float m = mm ? new_mean4[i][k]
                           : cr ? d_tlbrs[cdet * 4 + k] : means[src * 8 + k];
        next[k] = rintf(m);
      }
      float inl_v = inl[src];
      float count = has_merge ? fc[i] + fc[src] : fc[i];
      const int hits_m = has_merge ? hits[i] + hits[src] : hits[i];
      const int rh_raw = reinstate_hist[i];
      const bool re = rh_raw >= 0;
      const int rh = re ? rh_raw : 0;
      if (re) count = hc[rh];
      if (cr) inl_v = 1.f;
      const bool is_fresh = cr && !re;
      if (is_fresh) count = 0.f;
      const bool oof = (mm || cr) && ios_frame(next, frame) < 0.5f;
      const int det_of = mm ? md : cdet;
      const bool upd = (mm && feat_ok[i] && !oof) || (cr && re);
      if (upd) count = count + 1.f;
      if (mm || cr) {
#pragma unroll
        for (int k = 0; k < 4; ++k) box[k] = next[k];
      }
      int nh = mm ? hits_m + 1 : hits_m;
      if (re) nh = h_hits[rh];
      if (is_fresh) nh = 0;
      const int na = (mm || cr) ? 0 : (keep_unmatched[i] ? ages[i] + 1 : ages[i]);
      int nl = cr ? d_labels[cdet] : labels[i];
      if (re) nl = h_labels[rh];
      const bool nv = (mm && !oof) || keep_unmatched[i] || (cr && !oof);
      const bool sv = lost[i] || retire[i]
                      || (oof && nh >= p.confirm_hits);
      // the outputs of the slot
#pragma unroll
      for (int k = 0; k < 4; ++k) {
        o_tlbrs[i * 4 + k] = box[k];
        i_next[i * 4 + k] = next[k];
      }
      o_valid[i] = nv;
      o_ages[i] = na;
      o_hits[i] = nh;
      o_labels[i] = nl;
      o_start[i] = cr ? p.frame_id : start_f[i];
      o_end[i] = (mm || cr) ? p.frame_id : end_f[i];
      o_lost[i] = 0;
      o_inl[i] = inl_v;
      o_fc[i] = count;
      i_oof[i] = oof ? 1.f : 0.f;
      i_reinst[i] = static_cast<float>(rh_raw);
      i_create[i] = static_cast<float>(cd);
      i_ages[i] = static_cast<float>(na);
      i_hits[i] = static_cast<float>(nh);
      i_labels[i] = static_cast<float>(nl);
      i_valid[i] = nv ? 1.f : 0.f;
      i_featok[i] = feat_ok[i] ? 1.f : 0.f;
      // what the wide rows and the history save need
      new_hits[i] = nh;
      fcount[i] = count;
      save[i] = sv;
      fsrc[i] = has_merge ? src : -1;
      frh[i] = re ? rh : -1;
      fresh[i] = is_fresh;
      fdet[i] = upd ? det_of : -1;
    }
    for (int x = tid; x < H; x += nt)
      hkey[x] = h_valid2[x] ? static_cast<float>(lru[x])
                            : -1e9f + static_cast<float>(x);
  }
  __syncthreads();

  // ---- 5. the history: allocation order, saves, evictions ----------------
  // (8 lanes a history slot; every lane runs every round)
  for (int x0 = 0; x0 < H; x0 += n_groups) {
    const int x = x0 + group;
    const int rank = stable_rank8(hkey, H, x < H ? x : H - 1, r);
    if (x < H && r == 0) alloc_order[rank] = x;
  }
  if (warp == 0) warp_ranks(save, T, save_rank);
  __syncthreads();
  for (int i = tid; i < T; i += nt) {
    const int dst = save[i] && save_rank[i] < H ? alloc_order[save_rank[i]]
                                                : -1;
    i_hdst[i] = static_cast<float>(dst);
    if (dst >= 0) {
      h_src[dst] = i;
      if (h_valid2[dst]) atomicAdd(&stolen, 1);
    }
  }
  __syncthreads();
  {
    float* o_hc = out<float>(p, kOutHist + 1, sh);
    int* o_hl = out<int>(p, kOutHist + 2, sh);
    int* o_lru = out<int>(p, kOutHist + 4, sh);
    int* o_hh = out<int>(p, kOutHist + 5, sh);
    for (int x = tid; x < H; x += nt) {
      const int i = h_src[x];
      const bool v = i >= 0 || h_valid2[x];
      const int l = i >= 0 ? p.frame_id : lru[x];
      h_valid3[x] = v;
      o_hc[x] = i >= 0 ? fcount[i] : hc[x];
      o_hl[x] = i >= 0 ? labels[i] : h_labels[x];
      o_lru[x] = l;
      o_hh[x] = i >= 0 ? new_hits[i] : h_hits[x];
      hkey[x] = v ? static_cast<float>(l) : INFINITY;
      if (v) atomicAdd(&n_hvalid, 1);
    }
  }
  __syncthreads();
  {
    unsigned char* o_hv = out<unsigned char>(p, kOutHist + 3, sh);
    const int excess = n_hvalid - p.history_size > 0
                       ? n_hvalid - p.history_size : 0;
    for (int x0 = 0; x0 < H; x0 += n_groups) {
      const int x = x0 + group;
      const int rank = stable_rank8(hkey, H, x < H ? x : H - 1, r);
      if (x >= H || r != 0) continue;
      const bool evict = h_valid3[x] && rank < excess;
      o_hv[x] = h_valid3[x] && !evict;
      i_evict[x] = evict ? 1.f : 0.f;
    }
    if (tid == 0) {
      const int req = n_reid, fr = n_free;
      const int r_ok = req < fr ? req : fr;
      const int room = fr - req > 0 ? fr - req : 0;
      const int c_ok = n_create < room ? n_create : room;
      info[0] = static_cast<float>(p.frame_id);
      info[1] = static_cast<float>((req - r_ok) + (n_create - c_ok));
      info[2] = static_cast<float>(stolen);
      info[3] = static_cast<float>(n_dvalid);
    }
  }
#undef STAGED

  // ---- 6. the plan of the wide rows, for the rows launch ----------------
  {
    int* plan = out<int>(p, kScratch, static_cast<size_t>(s)
                                          * plan_ints(T, H));
    for (int r2 = tid; r2 < T + H; r2 += nt) {
      const int i = r2 < T ? r2 : h_src[r2 - T];
      int* q = plan + 5 * r2;
      q[0] = i;
      q[1] = i >= 0 ? fsrc[i] : -1;
      q[2] = i >= 0 ? frh[i] : -1;
      q[3] = i >= 0 ? fdet[i] : -1;
      q[4] = i >= 0 && fresh[i];
    }
    int* kp = plan + 5 * (T + H);
    for (int i = tid; i < T; i += nt) {
      kp[2 * i] = merge_src[i] >= 0 ? merge_src[i] : i;
      kp[2 * i + 1] = create_det[i] >= 0;
    }
  }
}

// launch 2: the wide rows, a warp a row (kRowsPerBlock rows a block; a
// smaller block's warps take several), 16-byte accesses where the rows
// allow them: the tracks' new feature sums and keypoints, then the
// history's rows (a saved track's sum again, the others copied)
__global__ void __launch_bounds__(kThreads)
assoc_commit_rows_kernel(const Params p) {
  const int s = blockIdx.x, lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5, n_warps = blockDim.x >> 5;
  const int T = p.t, H = p.h, F = p.f, K = p.k;
  const size_t st = static_cast<size_t>(s) * T, sd = static_cast<size_t>(s) * p.d,
               sh = static_cast<size_t>(s) * H;
  const float* fs = in<float>(p, kFeatSum, st * F);
  const float* hs = in<float>(p, kHistSum, sh * F);
  const float* emb = in<float>(p, kDEmb, sd * F);
  float* o_fs = out<float>(p, kOut + 13, st * F);
  float* o_hs = out<float>(p, kOutHist + 0, sh * F);
  const float* kps = in<float>(p, kKps, st * K * 2);
  const unsigned char* kpv = in<unsigned char>(p, kKpv, st * K);
  float* o_kps = out<float>(p, kOut + 11, st * K * 2);
  unsigned char* o_kpv = out<unsigned char>(p, kOut + 12, st * K);
  const bool vec = F % 4 == 0 && aligned16(fs) && aligned16(hs)
                   && aligned16(emb) && aligned16(o_fs) && aligned16(o_hs);
  const int* plan = in<int>(p, kScratch, static_cast<size_t>(s)
                                             * plan_ints(T, H));
  cudaGridDependencySynchronize();
  const int first = blockIdx.y * kRowsPerBlock;
  const int last = min(first + kRowsPerBlock, T + H);
  for (int r = first + warp; r < last; r += n_warps) {
    const int* q = plan + 5 * r;
    const int i = q[0];
    float* dst = r < T ? o_fs + static_cast<size_t>(r) * F
                       : o_hs + static_cast<size_t>(r - T) * F;
    if (i < 0) {                       // a history row kept as it was
      copy_row(hs + static_cast<size_t>(r - T) * F, dst, F, vec, lane);
      continue;
    }
    const Sum sum = {fs + static_cast<size_t>(i) * F,
                     q[1] >= 0 ? fs + static_cast<size_t>(q[1]) * F : nullptr,
                     q[2] >= 0 ? hs + static_cast<size_t>(q[2]) * F : nullptr,
                     q[3] >= 0 ? emb + static_cast<size_t>(q[3]) * F : nullptr,
                     q[4] != 0};
    sum_row(sum, dst, F, vec, lane);
    if (r < T) {
      const int* kp = plan + 5 * (T + H) + 2 * r;
      for (int x = lane; x < K * 2; x += 32)
        o_kps[r * K * 2 + x] = kps[kp[0] * K * 2 + x];
      for (int x = lane; x < K; x += 32)
        o_kpv[r * K + x] = kpv[kp[0] * K + x] && !kp[1];
    }
  }
}

}  // namespace

extern "C" {

// One call of the commit for ints[kStreams] streams: `ptrs` holds the Ptr
// enum's pointers, `ints` the Int enum's values, `floats` the Float
// enum's (the Kalman filter's detector noise and initial weights). Two
// launches on `stream`, the rows launch behind the decisions by a
// programmatic dependent launch. Returns 0 or the first cudaError_t.
int assoc_commit_forward(const void* const* ptrs, const int* ints,
                         const float* floats, void* stream) {
  Params p = {};
  for (int k = 0; k < kNumPtrs; ++k) {
    if (!ptrs[k]) return static_cast<int>(cudaErrorInvalidValue);
    p.p[k] = ptrs[k];
  }
  p.streams = ints[kStreams];
  p.t = ints[kTracks];
  p.d = ints[kDets];
  p.h = ints[kHist];
  p.f = ints[kFeat];
  p.k = ints[kKp];
  p.confirm_hits = ints[kConfirmHits];
  p.max_age = ints[kMaxAge];
  p.history_size = ints[kHistorySize];
  p.frame_id = ints[kFrameId];
  p.sf_w = floats[kSfDetW];
  p.sf_h = floats[kSfDetH];
  p.mn_w = floats[kMinDetW];
  p.mn_h = floats[kMinDetH];
  p.pos_w = floats[kPosWeight];
  p.vel_w = floats[kVelWeight];
  if (p.streams < 1 || p.streams > 65535 || p.t < 1 || p.t > kMaxRows
      || p.d < 1 || p.d > kMaxRows || p.h < 1 || p.h > kMaxRows || p.f < 1
      || p.k < 1)
    return static_cast<int>(cudaErrorInvalidValue);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(p.streams);
  // the staged inputs beside the static shared memory pass 48 KB at the
  // main path's sizes, which a launch takes only once allowed
  for (int k = 0; k < kNumStaged; ++k) {
    const StagedField f = staged_field(k);
    p.f_src[k] = static_cast<const unsigned char*>(p.p[f.ptr]);
    p.f_bytes[k] = field_bytes(f, p.t, p.d, p.h);
    p.f_stride[k] = f.rows == 3 ? 0 : p.f_bytes[k];
  }
  const int smem = staged_layout(p.t, p.d, p.h, p.f_off);
  cudaError_t e = cudaFuncSetAttribute(
      assoc_commit_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  assoc_commit_kernel<<<grid, kDecisionThreads, smem, st>>>(p);
  e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.streams, (p.t + p.h + kRowsPerBlock - 1)
                                    / kRowsPerBlock);
  cfg.blockDim = dim3(kThreads);
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, assoc_commit_rows_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code an entry returned
const char* assoc_commit_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
