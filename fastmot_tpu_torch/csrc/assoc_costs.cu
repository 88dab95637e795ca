// The association frame's costs for Hopper (sm_90a): every cascade
// stage's cost matrix and row mask of every stream in one call of two
// launches, with no host sync.
//
// Replaces fastmot_tpu/tracker.py:560-611 _assoc_costs_core: the tracks'
// and the history's averaged features normalised (_normalized_feats,
// :543), their distances to the detections' embeddings
// (fastmot_tpu/ops/distance.py:49 cdist), the empty mask and its fill, the
// squared Mahalanobis distance of each detection to each track
// (fastmot_tpu/kalman.py:268 batched_maha_distance, in the order of the
// unrolled Cholesky of fastmot_tpu/ops/smallmat.py:102 maha_sq_chol4),
// fuse_motion and the three gates (fastmot_tpu/ops/assignment.py:276,
// 284), the IoU cost (distance.py:68), the IoS occlusion test
// (fastmot_tpu/ops/geometry.py find_occluded) and the row masks. None of
// it is a Pallas kernel: it is one jitted XLA program of the JAX package.
// The plain PyTorch twin is tracker.assoc_costs_reference in
// fastmot_tpu_torch/tracker.py; the wrapper ops/assoc_costs.py
// assoc_costs checks the arguments, allocates the outputs and calls the C
// entry below.
//
// What bounds it on an H100: latency. The work is small (the two
// appearance products, 2 x (T + H) x D x F = 25 MFLOP at T = D = 128,
// H = 64, F = 512, and under 1 MB of reads), so the design spreads a
// stream over blocks, does each row's and each detection's work once, and
// keeps the rest on chip. Two launches, the second behind the first by a
// programmatic dependent launch:
//
//   assoc_prep_kernel, 256 threads a block, a stream's blocks: one block
//   a thread a row for the tracks' masks, col4row0, Cholesky factors
//   (JAX's unrolled order) and projected means and the history's reID
//   mask; blocks of 4 rows (tracks, then history rows), whose features
//   the block copies into shared memory and divides by the count, then a
//   row's 16 threads sum their squares (the 16 partial sums strided by
//   16 and the xor-shuffle tree of the first design), the block divides
//   by the norm, and the 16 threads sum again: the normalised features
//   and |a|^2 go to scratch; blocks of 8 detections: their occlusion
//   (IoS against every other detection, a warp a detection, the division
//   only where boxes meet) and |b|^2 (a thread a detection, every feature
//   in ascending order, from 512-feature chunks the block copies in while
//   the occlusion is tested). It triggers the tile launch at its start.
//   assoc_tile_kernel: a block a tile of 16 rows by 16 detections and a
//   stream, 128 threads, a thread two entries. Before the first launch
//   ends it loads the rows' labels and boxes and its detections' boxes
//   and starts the copies (cp.async) of their embeddings' first four
//   chunks of 128 features; then the rows' normalised features stream in
//   beside them through four buffers in shared memory (all in flight at
//   F = 512) while each thread sums its entries' products (one
//   accumulator an entry, ascending feature order); then each entry's
//   cost in registers: the distance, the empty fill, the Mahalanobis
//   distance from the row's Cholesky factor, fuse_motion and the gates,
//   and the IoU cost.
//
// Rounding. The masks, the occlusion, the IoU cost and the label gate are
// the plain version's bit for bit: each is the same IEEE operations in
// the same order (the build takes -fmad=false, so no product is fused
// into a sum). The appearance distances and the Mahalanobis distance sum
// in another order than cuBLAS's product, torch's norm and cuSOLVER's
// Cholesky, and agree with them within float32 rounding
// (tests/test_torch_assoc_costs.py states the tolerances); the gates that
// read them decide alike except where the value lies within that rounding
// of its threshold.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kThreads = 256;                 // a prep block's
constexpr int kTileThreads = 128;             // a tile block's: 2 entries each
constexpr int kRows = 16;                     // a tile's rows
constexpr int kRowThreads = 16;               // a row's threads in the prep
constexpr int kPrepRows = 4;                  // a prep row block's rows
constexpr int kPrepChunk = 1024;              // features a prep pass stages
constexpr int kCols = 16;                     // a tile's detections
constexpr int kDetBlock = 8;                  // a prep block's detections
constexpr int kDetChunk = 512;                // features a prep chunk
constexpr int kMaxD = 256;                    // detections a stream
constexpr int kChunk = 128;                   // features a staged chunk
constexpr int kChunkStride = kChunk + 4;      // (16-byte rows, no conflicts)
constexpr int kStages = 4;                    // chunks in flight
constexpr int kCholStride = 16;               // a track's factor and mean
constexpr float kInfCost = 1e5f;              // assignment.INF_COST

// assoc_costs_forward's pointers, ints and floats
enum CostPtr {
  kMeans, kCovs, kTlbrs, kTValid, kAges, kHits, kTLabels, kFeatSum,
  kFeatCount, kHistSum, kHistCount, kHLabels, kHValid, kDTlbrs, kDLabels,
  kDValid, kDEmb,
  kTApp, kHApp,        // the appearance distances: null but on the split path
  kCost, kIouCost, kReidCost, kOccluded, kHReidOk, kMasks, kCol4Row,
  kScratch,            // assoc_costs_scratch_words' floats
  kNumPtrs
};
enum CostInt { kStreams, kT, kD, kH, kF, kNDepth, kConfirmHits, kEmbCap,
               kMetric };
enum CostFloat { kOneMinusW, kMotionW, kInvChi, kChi, kMaxAssoc, kIouGate,
                 kFill, kOcclusion, kSfW, kSfH, kMnW, kMnH };

struct CostParams {
  const float* means;            // [S, T, 8]
  const float* covs;             // [S, T, 8, 8]
  const float* tlbrs;            // [S, T, 4]
  const unsigned char* t_valid;  // [S, T]
  const int* ages;               // [S, T]
  const int* hits;               // [S, T]
  const int* t_labels;           // [S, T]
  const float* feat_sum;         // [S, T, F]
  const float* feat_count;       // [S, T]
  const float* hist_sum;         // [S, H, F]
  const float* hist_count;       // [S, H]
  const int* h_labels;           // [S, H]
  const unsigned char* h_valid;  // [S, H]
  const float* d_tlbrs;          // [S, D, 4]
  const int* d_labels;           // [S, D]
  const unsigned char* d_valid;  // [S, D]
  const float* d_emb;            // [S, D, F]
  const float* t_app;            // [S, T, D] given, or null
  const float* h_app;            // [S, H, D] given, or null
  float* cost;                   // [S, T, D]
  float* iou_cost;               // [S, T, D]
  float* reid_cost;              // [S, H, D]
  unsigned char* occluded;       // [S, D]
  unsigned char* h_reid_ok;      // [S, H]
  unsigned char* masks;          // [n_depth + 2, S, T]
  int* col4row;                  // [S, T]
  // scratch, written by the prep launch
  float* feats;                  // [S, T + H, F] normalised (products only)
  float* a2;                     // [S, T + H] their squared norms
  float* chol;                   // [S, T, 16]: the factor's 10, the mean's 4
  float* b2;                     // [S, D] the embeddings' squared norms
  int streams, t, d, h, f, n_depth, confirm_hits, emb_cap, metric;
  float one_minus_w, motion_w, inv_chi, chi, max_assoc, iou_gate, fill;
  float occlusion, sf_w, sf_h, mn_w, mn_h;
};

// the scratch's pieces, in floats: (feats, a2, chol, b2, all), each at a
// 16-byte boundary
struct ScratchLayout {
  size_t feats, a2, chol, b2, words;
};

__host__ __device__ inline size_t round4(size_t n) { return (n + 3) / 4 * 4; }

__host__ __device__ inline ScratchLayout scratch_layout(int s, int t, int d,
                                                        int h, int f,
                                                        bool products) {
  const size_t rows = static_cast<size_t>(s) * (t + h);
  ScratchLayout l;
  l.feats = 0;
  l.a2 = products ? round4(rows * f) : 0;
  l.chol = l.a2 + round4(rows);
  l.b2 = l.chol + static_cast<size_t>(s) * t * kCholStride;
  l.words = l.b2 + round4(static_cast<size_t>(s) * d);
  return l;
}

// geometry.area: (x2 - x1 + 1) (y2 - y1 + 1), 0 unless both are positive
__device__ __forceinline__ float box_area(const float* b) {
  const float w = (b[2] - b[0]) + 1.0f, h = (b[3] - b[1]) + 1.0f;
  return (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
}

// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// geometry._inter_area: the intersection's area with the +1 convention
__device__ __forceinline__ float inter_area(const float* a, const float* b) {
  const float w = (nan_min(a[2], b[2]) - nan_max(a[0], b[0])) + 1.0f;
  const float h = (nan_min(a[3], b[3]) - nan_max(a[1], b[1])) + 1.0f;
  return (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
}

// the sum of a row's 16 threads' values, every one of them gets it
__device__ __forceinline__ float row_sum(float v) {
  for (int o = kRowThreads / 2; o > 0; o >>= 1)
    v += __shfl_xor_sync(0xFFFFFFFFu, v, o);
  return v;
}

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ unsigned smem_addr(const void* ptr) {
  return static_cast<unsigned>(__cvta_generic_to_shared(ptr));
}
#endif

// 4 or 16 bytes into shared memory, asynchronously (copies_done()
// completes them); plain copies in the tests' host build
__device__ __forceinline__ void copy4_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}
__device__ __forceinline__ void copy16_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
#else
  for (int e = 0; e < 4; ++e) dst[e] = src[e];
#endif
}
__device__ __forceinline__ void copies_commit() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.commit_group;\n" ::: "memory");
#endif
}
// every copy group but the newest `Pending` landed
template <int Pending>
__device__ __forceinline__ void copies_wait() {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.wait_group %0;\n" :: "n"(Pending) : "memory");
#endif
}

// the prep launch's factor block of a stream, a thread a row: a track's
// masks, col4row0, Cholesky factor (JAX's unrolled order) and projected
// mean; a history row's reID mask
__device__ void prep_factors(const CostParams& p, int s) {
  const int T = p.t, H = p.h;
  for (int row = threadIdx.x; row < T + H; row += blockDim.x) {
    if (row < T) {
      // the cascade's row masks and col4row0
      const size_t plane = static_cast<size_t>(p.streams) * T;
      const size_t at = static_cast<size_t>(s) * T + row;
      const int age = p.ages[at];
      const bool valid = p.t_valid[at];
      const bool confirmed = p.hits[at] >= p.confirm_hits;
      const int depth = age >= 0 ? age / 2 : -((1 - age) / 2);   // floor
      for (int q = 0; q < p.n_depth; ++q)
        p.masks[q * plane + at] = valid && confirmed && depth == q;
      p.masks[p.n_depth * plane + at] = valid && confirmed && age < 2;
      p.masks[(p.n_depth + 1) * plane + at] = valid && !confirmed;
      p.col4row[at] = -1;
      // the projected mean and the Cholesky factor of the projected
      // covariance, JAX's unrolled order
      const float* m = p.means + at * 8;
      const float* c = p.covs + at * 64;
      const float w = (m[2] - m[0]) + 1.0f, h = (m[3] - m[1]) + 1.0f;
      float sw = p.sf_w * w, sh = p.sf_h * h;
      sw = sw != sw ? sw : (sw < p.mn_w ? p.mn_w : sw);    // torch.clamp
      sh = sh != sh ? sh : (sh < p.mn_h ? p.mn_h : sh);
      const float std[4] = {sw, sh, sw, sh};
      float a[4][4];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j <= i; ++j)
          a[i][j] = c[i * 8 + j] + (i == j ? std[i] * std[i] : 0.0f);
      float l[4][4];
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j <= i; ++j) {
          float v = a[i][j];
          for (int k = 0; k < j; ++k) v = v - l[i][k] * l[j][k];
          if (i == j) {
            l[i][j] = sqrtf(v > 1e-12f ? v : 1e-12f);
          } else {
            l[i][j] = v / l[j][j];
          }
        }
      float* out = p.chol + at * kCholStride;
      int q = 0;
      for (int i = 0; i < 4; ++i)
        for (int j = 0; j <= i; ++j) out[q++] = l[i][j];
      for (int k = 0; k < 4; ++k) out[10 + k] = m[k];
    } else {
      // the history's reID mask
      const size_t at = static_cast<size_t>(s) * H + (row - T);
      p.h_reid_ok[at] = p.h_valid[at] && p.hist_count[at] >= 2.0f;
    }
  }
}

// the prep launch's rows [row0, row0 + kPrepRows) of a stream (tracks,
// then history rows); a row's features by nt / kPrepRows threads
__device__ void prep_rows(const CostParams& p, int s, int row0,
                          bool products) {
  alignas(16) __shared__ float vals[kPrepRows][kPrepChunk];
  __shared__ float denom_r[kPrepRows], div_r[kPrepRows];
  const int T = p.t, H = p.h, F = p.f;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int n_rows = T + H - row0 < kPrepRows ? T + H - row0 : kPrepRows;
  const int per_row = nt / kPrepRows, r_mine = tid / per_row;
  const int k_mine = tid % per_row;
  const bool mine = r_mine < n_rows;
  const int row_mine = row0 + (mine ? r_mine : 0);
  const float* src = row_mine < T
      ? p.feat_sum + (static_cast<size_t>(s) * T + row_mine) * F
      : p.hist_sum + (static_cast<size_t>(s) * H + (row_mine - T)) * F;
  float* out = p.feats + (static_cast<size_t>(s) * (T + H) + row_mine) * F;
  const int chunks = (F + kPrepChunk - 1) / kPrepChunk;
  // (16-byte copies where the rows allow them)
  const bool vec = (F & 3) == 0
      && (reinterpret_cast<uintptr_t>(src) & 15u) == 0;
  auto stage = [&](int k0) {   // a chunk of my row's features, in flight
    const int n = F - k0 < kPrepChunk ? F - k0 : kPrepChunk;
    if (mine && vec) {
      for (int k = 4 * k_mine; k < n; k += 4 * per_row)
        copy16_async(&vals[r_mine][k], src + k0 + k);
    } else if (mine) {
      for (int k = k_mine; k < n; k += per_row)
        copy4_async(&vals[r_mine][k], src + k0 + k);
    }
    copies_commit();
  };
  if (products) stage(0);
  if (products)
    for (int r = tid; r < n_rows; r += nt) {
      const int row = row0 + r;
      const float count = row < T
          ? p.feat_count[static_cast<size_t>(s) * T + row]
          : p.hist_count[static_cast<size_t>(s) * H + (row - T)];
      denom_r[r] = count < 1.0f ? 1.0f : count;   // clamp(min=1)
    }
  if (!products) return;   // (the whole block alike)
  // the averaged features normalised twice, as the first design: a / count
  // (count clamped to 1), over its norm (or 1), and the squared norm of the
  // result. A row's threads divide its features in shared memory; then its
  // 16 summing threads add the squares of the features k = t mod 16 each
  // in ascending order, and the xor tree
  const int warp = tid / 32, r_sum = tid / kRowThreads;
  const int lane = tid % kRowThreads;
  const bool summer = warp < kPrepRows * kRowThreads / 32;   // whole warps
  float sq = 0.0f;
  for (int k0 = 0; k0 < F; k0 += kPrepChunk) {
    const int n = F - k0 < kPrepChunk ? F - k0 : kPrepChunk;
    if (k0 > 0) stage(k0);
    copies_wait<0>();
    __syncthreads();   // the chunk (and denom_r)
    if (mine) {
#pragma unroll 4
      for (int k = k_mine; k < n; k += per_row)
        vals[r_mine][k] = vals[r_mine][k] / denom_r[r_mine];
    }
    __syncthreads();
    if (summer && r_sum < n_rows) {
#pragma unroll 8
      for (int k = lane; k < n; k += kRowThreads) {
        const float a = vals[r_sum][k];
        sq = sq + a * a;
      }
    }
    __syncthreads();   // the chunk is summed
  }
  if (summer) {
    const float norm = sqrtf(row_sum(sq));
    if (lane == 0 && r_sum < n_rows) div_r[r_sum] = norm > 0.0f ? norm : 1.0f;
  }
  __syncthreads();
  float sq2 = 0.0f;
  for (int k0 = 0; k0 < F; k0 += kPrepChunk) {
    const int n = F - k0 < kPrepChunk ? F - k0 : kPrepChunk;
    if (chunks > 1) {   // (one chunk keeps the first pass's quotients)
      stage(k0);
      copies_wait<0>();
      __syncthreads();
    }
    if (mine) {
      const float denom = denom_r[r_mine], div = div_r[r_mine];
#pragma unroll 4
      for (int k = k_mine; k < n; k += per_row) {
        const float a = chunks == 1 ? vals[r_mine][k]
                                    : vals[r_mine][k] / denom;
        const float v = a / div;
        vals[r_mine][k] = v;
        out[k0 + k] = v;
      }
    }
    __syncthreads();
    if (summer && r_sum < n_rows) {
#pragma unroll 8
      for (int k = lane; k < n; k += kRowThreads) {
        const float v = vals[r_sum][k];
        sq2 = sq2 + v * v;
      }
    }
    __syncthreads();   // the chunk is summed
  }
  if (summer) {
    sq2 = row_sum(sq2);
    if (lane == 0 && r_sum < n_rows)
      p.a2[static_cast<size_t>(s) * (T + H) + row0 + r_sum] = sq2;
  }
}

// the prep launch's detections [j0, j0 + 8) of a stream: their occlusion
// and |b|^2
__device__ void prep_dets(const CostParams& p, int s, int j0,
                          bool products) {
  __shared__ float box_d[kMaxD][4];
  __shared__ float area_d[kMaxD];
  __shared__ unsigned char valid_d[kMaxD];
  __shared__ float chunk[kDetBlock][kDetChunk + 1];
  const int D = p.d, F = p.f;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32;
  const int lane32 = tid % 32, warps = nt / 32;
  const int j1 = j0 + kDetBlock < D ? j0 + kDetBlock : D;
  for (int j = tid; j < D; j += nt) {
    const float* b = p.d_tlbrs + (static_cast<size_t>(s) * D + j) * 4;
    for (int q = 0; q < 4; ++q) box_d[j][q] = b[q];
    area_d[j] = box_area(box_d[j]);
    valid_d[j] = p.d_valid[static_cast<size_t>(s) * D + j];
  }
  // the first chunk of the detections' embeddings in flight while the
  // occlusion is tested
  const float* emb = p.d_emb + static_cast<size_t>(s) * D * F;
  auto stage = [&](int k0) {
    const int n = F - k0 < kDetChunk ? F - k0 : kDetChunk;
    for (int q = tid; q < kDetBlock * kDetChunk; q += nt) {
      const int jj = q / kDetChunk, k = q % kDetChunk;
      if (k >= n) continue;
      if (j0 + jj < j1) {
        copy4_async(&chunk[jj][k],
                    emb + static_cast<size_t>(j0 + jj) * F + k0 + k);
      } else {
        chunk[jj][k] = 0.0f;
      }
    }
    copies_commit();
  };
  if (products) stage(0);
  __syncthreads();
  // covered by a valid other at IoS >= thresh (a warp a detection, its
  // lanes the others; the quotient only where the boxes meet or the
  // threshold is not positive), or past the embedding budget
  for (int i = j0 + warp; i < j1; i += warps) {
    bool covered = false;
    for (int u = 0; u < (D + 31) / 32; ++u) {
      const int j = 32 * u + lane32;
      if (j >= D || j == i || !valid_d[j]) continue;
      const float inter = inter_area(box_d[i], box_d[j]);
      if (inter == 0.0f && p.occlusion > 0.0f) continue;   // IoS 0
      const float ios = area_d[i] > 0.0f ? inter / area_d[i] : 0.0f;
      covered = covered || ios >= p.occlusion;
    }
    const bool any = __ballot_sync(0xFFFFFFFFu, covered) != 0;
    if (lane32 == 0)
      p.occluded[static_cast<size_t>(s) * D + i] =
          (any && valid_d[i]) || i >= p.emb_cap;
  }
  if (!products) return;   // (the whole block alike)
  // |b|^2: a thread a detection, every feature in ascending order, from
  // chunks of kDetChunk features of the block's detections staged by the
  // block at once (one chunk at F <= 512)
  float b2 = 0.0f;
  for (int k0 = 0; k0 < F; k0 += kDetChunk) {
    const int n = F - k0 < kDetChunk ? F - k0 : kDetChunk;
    if (k0 > 0) {
      __syncthreads();   // the last chunk is summed
      stage(k0);
    }
    copies_wait<0>();
    __syncthreads();
    if (tid < kDetBlock) {
#pragma unroll 8
      for (int kk = 0; kk < n; ++kk) {
        const float v = chunk[tid][kk];
        b2 = b2 + v * v;
      }
    }
  }
  if (tid < kDetBlock && j0 + tid < j1)
    p.b2[static_cast<size_t>(s) * D + j0 + tid] = b2;
}

// launch 1: a block a stream's factors, 4 of its rows or 8 of its
// detections
__global__ void __launch_bounds__(kThreads)
assoc_prep_kernel(const CostParams p) {
  // the tile launch may start now; it waits for this grid's end before it
  // reads what this one writes
  cudaTriggerProgrammaticLaunchCompletion();
  const int row_blocks = (p.t + p.h + kPrepRows - 1) / kPrepRows;
  const int b = blockIdx.x, s = blockIdx.y;
  const bool products = p.t_app == nullptr;
  if (b == 0) {
    prep_factors(p, s);
  } else if (b <= row_blocks) {
    prep_rows(p, s, (b - 1) * kPrepRows, products);
  } else {
    prep_dets(p, s, (b - 1 - row_blocks) * kDetBlock, products);
  }
}

// the copy of `rows` rows of a chunk of kChunk features from k0 (row i of
// the source at src + i * F, the rows from `first` on, at most `n`) into
// dst [rows][kChunkStride], zeros past F and past `n`; 16-byte copies
// where the rows allow them
__device__ __forceinline__ void stage_chunk(float* dst, const float* src,
                                            int n, int F, int k0, bool vec) {
  const int tid = threadIdx.x, nt = blockDim.x;
  constexpr int kQuads = kChunk / 4;
  for (int q = tid; q < kRows * kQuads; q += nt) {
    const int i = q / kQuads, k = k0 + 4 * (q % kQuads);
    float* d = dst + i * kChunkStride + 4 * (q % kQuads);
    const float* from = src + static_cast<size_t>(i) * F + k;
    if (i < n && vec && k + 4 <= F) {
      copy16_async(d, from);
    } else {
      for (int e = 0; e < 4; ++e) {
        if (i < n && k + e < F) {
          copy4_async(d + e, from + e);
        } else {
          d[e] = 0.0f;
        }
      }
    }
  }
}

// a tile's entry (r, c) of the stream's row `row` and detection `j`:
// `acc` its product
__device__ __forceinline__ void tile_entry(
    const CostParams& p, bool tracks, int s, int r, int row, int c, int j,
    float acc, bool products, const float* a2_r, const float* b2_c,
    const unsigned char* occ_c, const float (*chol_r)[kCholStride],
    const float (*box_c)[4], const float* area_c, const int* label_c,
    const int* label_r, const float (*box_r)[4],
    const unsigned char* empty_r) {
  const int T = p.t, D = p.d, H = p.h;
  const int n_rows = tracks ? T : H;
  const size_t out_row = (static_cast<size_t>(s) * n_rows + row) * D;
  const float* given = tracks ? p.t_app : p.h_app;
  const int row_label = label_r[r];
  float app;
  if (!products) {
    app = given[out_row + j];
  } else if (p.metric == 0) {      // euclidean: |a|^2 + |b|^2 - 2 a.b
    float v = (a2_r[r] + b2_c[c]) - 2.0f * acc;
    v = v != v ? v : (v < 0.0f ? 0.0f : v);
    app = sqrtf(v);
  } else {                         // cosine: 1 - a.b / (|a| |b|)
    const float den = sqrtf(a2_r[r]) * sqrtf(b2_c[c]);
    app = 1.0f - acc / (den > 0.0f ? den : 1.0f);
  }
  const bool label_ok = row_label == label_c[c];
  if (!tracks) {
    p.reid_cost[out_row + j] = label_ok ? app : kInfCost;
    return;
  }
  const float* t_box = box_r[r];
  const float t_area = box_area(t_box);
  const bool empty_row = empty_r[r];
  // the appearance cost, fused with the Mahalanobis distance, gated
  float cost = (empty_row || occ_c[c]) ? p.fill : app;
  const float* l = chol_r[r];
  const float d0 = box_c[c][0] - l[10];
  const float d1 = box_c[c][1] - l[11];
  const float d2 = box_c[c][2] - l[12];
  const float d3 = box_c[c][3] - l[13];
  const float z0 = d0 / l[0];
  const float z1 = (d1 - l[1] * z0) / l[2];
  const float z2 = ((d2 - l[3] * z0) - l[4] * z1) / l[5];
  const float z3 = (((d3 - l[6] * z0) - l[7] * z1) - l[8] * z2) / l[9];
  const float maha = ((z0 * z0 + z1 * z1) + z2 * z2) + z3 * z3;
  const float fused = p.one_minus_w * cost
      + p.motion_w * (maha * p.inv_chi);
  cost = maha > p.chi ? kInfCost : fused;
  cost = (!label_ok || cost > p.max_assoc) ? kInfCost : cost;
  p.cost[out_row + j] = cost;
  // 1 - IoU, gated
  const float inter = inter_area(t_box, box_c[c]);
  const float uni = (t_area + area_c[c]) - inter;
  const float iou = inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
  const float iou_cost = 1.0f - iou;
  p.iou_cost[out_row + j] =
      (!label_ok || iou_cost > p.iou_gate) ? kInfCost : iou_cost;
}

// launch 2: a block a tile of 16 rows (tracks, or history rows) by 16
// detections and a stream, 128 threads: thread (a, b) the entries of rows
// a and a + 8 by detection b (two products a load of the detection's 4
// features, the reads of a quarter warp on distinct banks)
__global__ void __launch_bounds__(kTileThreads)
assoc_tile_kernel(const CostParams p) {
  // kStages stages of [16 rows][kChunkStride] features, then [16
  // detections][kChunkStride] embeddings
  extern __shared__ float smem[];
  __shared__ float box_c[kCols][4];
  __shared__ float area_c[kCols], b2_c[kCols];
  __shared__ int label_c[kCols];
  __shared__ unsigned char occ_c[kCols];
  __shared__ float chol_r[kRows][kCholStride];
  __shared__ float a2_r[kRows];
  __shared__ int label_r[kRows];
  __shared__ float box_r[kRows][4];
  __shared__ unsigned char empty_r[kRows];
  const int T = p.t, D = p.d, H = p.h, F = p.f;
  const int col_tiles = (D + kCols - 1) / kCols;
  const int s = blockIdx.y, tile = blockIdx.x / col_tiles;
  const int c0 = (blockIdx.x % col_tiles) * kCols;
  const int n_cols = D - c0 < kCols ? D - c0 : kCols;
  const int tid = threadIdx.x, nt = blockDim.x;
  const int track_tiles = (T + kRows - 1) / kRows;
  const bool tracks = tile < track_tiles;
  const int row0 = (tracks ? tile : tile - track_tiles) * kRows;
  const int n_rows = tracks ? T : H;
  const int n_tile_rows = n_rows - row0 < kRows ? n_rows - row0 : kRows;
  const bool products = p.t_app == nullptr;
  const int stage = 2 * kRows * kChunkStride;
  const int n_chunks = (F + kChunk - 1) / kChunk;
  // the rows' features and the detections' embeddings, [rows][F] each
  const float* emb = p.d_emb + (static_cast<size_t>(s) * D + c0) * F;
  const float* feats = p.feats
      + (static_cast<size_t>(s) * (T + H) + (tracks ? 0 : T) + row0) * F;
  const bool vec = (F & 3) == 0
      && (reinterpret_cast<uintptr_t>(p.d_emb) & 15u) == 0
      && (reinterpret_cast<uintptr_t>(p.feats) & 15u) == 0;

  // before the prep launch ends: the rows' labels (and the tracks' boxes
  // and empty rows), the detections' boxes and labels, and the copies of
  // their first chunks of embeddings
  for (int x = tid; x < n_tile_rows; x += nt) {
    const size_t at = static_cast<size_t>(s) * n_rows + row0 + x;
    label_r[x] = tracks ? p.t_labels[at] : p.h_labels[at];
    if (tracks) {
      for (int q = 0; q < 4; ++q) box_r[x][q] = p.tlbrs[at * 4 + q];
      empty_r[x] = p.feat_count[at] < 1.0f;
    }
  }
  for (int x = tid; x < n_cols; x += nt) {
    const float* b = p.d_tlbrs + (static_cast<size_t>(s) * D + c0 + x) * 4;
    for (int q = 0; q < 4; ++q) box_c[x][q] = b[q];
    area_c[x] = box_area(box_c[x]);
    label_c[x] = p.d_labels[static_cast<size_t>(s) * D + c0 + x];
  }
  if (products)
    for (int ch = 0; ch < kStages; ++ch) {
      if (ch < n_chunks)
        stage_chunk(smem + ch * stage + kRows * kChunkStride, emb, n_cols, F,
                    ch * kChunk, vec);
      copies_commit();
    }
  cudaGridDependencySynchronize();
  // the prep launch's: the rows' features first (their copies in flight),
  // then the occlusion, |b|^2, |a|^2, the factors
  if (products)
    for (int ch = 0; ch < kStages; ++ch) {
      if (ch < n_chunks)
        stage_chunk(smem + ch * stage, feats, n_tile_rows, F, ch * kChunk,
                    vec);
      copies_commit();
    }
  // (their copies in the newest group, which the last chunk's wait
  // completes; the occlusion's bytes loaded)
  if (products) {
    for (int x = tid; x < n_cols; x += nt)
      copy4_async(&b2_c[x], p.b2 + static_cast<size_t>(s) * D + c0 + x);
    for (int x = tid; x < n_tile_rows; x += nt)
      copy4_async(&a2_r[x], p.a2 + static_cast<size_t>(s) * (T + H)
                  + (tracks ? 0 : T) + row0 + x);
  }
  if (tracks)
    for (int x = tid; x < n_tile_rows * kCholStride; x += nt)
      copy4_async(&chol_r[x / kCholStride][x % kCholStride],
                  p.chol + (static_cast<size_t>(s) * T + row0) * kCholStride
                  + x);
  copies_commit();
  for (int x = tid; x < n_cols; x += nt)
    occ_c[x] = p.occluded[static_cast<size_t>(s) * D + c0 + x];

  // the products, a chunk at a time through kStages stages, the next
  // chunks' copies in flight while one is summed (a copy group a chunk
  // and kind, an empty group where no chunk is left, so that the wait is
  // always for all but the newest kStages - 1); one accumulator an entry,
  // every feature in ascending order
  const int a = tid / kCols % 8, b = tid % kCols;   // (the tile's threads)
  float acc[2] = {0.0f, 0.0f};
  if (products) {
    for (int ch = 0; ch < n_chunks; ++ch) {
      float* cur = smem + (ch % kStages) * stage;
      copies_wait<kStages - 1>();
      __syncthreads();   // the chunk's copies (and zeros) are visible
      if (tid < kTileThreads) {
        const float4* f0 = reinterpret_cast<const float4*>(
            cur + a * kChunkStride);
        const float4* f1 = f0 + 8 * kChunkStride / 4;
        const float4* e = reinterpret_cast<const float4*>(
            cur + (kRows + b) * kChunkStride);
#pragma unroll 4
        for (int q = 0; q < kChunk / 4; ++q) {
          const float4 fa = f0[q], fb = f1[q], eq = e[q];
          acc[0] = acc[0] + fa.x * eq.x;
          acc[1] = acc[1] + fb.x * eq.x;
          acc[0] = acc[0] + fa.y * eq.y;
          acc[1] = acc[1] + fb.y * eq.y;
          acc[0] = acc[0] + fa.z * eq.z;
          acc[1] = acc[1] + fb.z * eq.z;
          acc[0] = acc[0] + fa.w * eq.w;
          acc[1] = acc[1] + fb.w * eq.w;
        }
      }
      __syncthreads();   // the stage is read before it is copied into again
      const int next = ch + kStages;
      if (next < n_chunks) {
        stage_chunk(cur, feats, n_tile_rows, F, next * kChunk, vec);
        stage_chunk(cur + kRows * kChunkStride, emb, n_cols, F,
                    next * kChunk, vec);
      }
      copies_commit();
    }
  }
  copies_wait<0>();
  __syncthreads();   // occ, b2, a2 and the factors are whole
  if (tid >= kTileThreads) return;
  for (int u = 0; u < 2; ++u) {
    const int r = a + 8 * u;
    if (r < n_tile_rows && b < n_cols)
      tile_entry(p, tracks, s, r, row0 + r, b, c0 + b, acc[u], products,
                 a2_r, b2_c, occ_c, chol_r, box_c, area_c, label_c, label_r,
                 box_r, empty_r);
  }
}

}  // namespace

extern "C" {

// The scratch floats of a call (products: the appearance distances are not
// given)
size_t assoc_costs_scratch_words(int s, int t, int d, int h, int f,
                                 int products) {
  return scratch_layout(s, t, d, h, f, products != 0).words;
}

// One call for ints[kStreams] streams of ints[kT] tracks, ints[kH] history
// rows, ints[kD] detections and ints[kF] features: `ptrs` holds the
// CostPtr enum's pointers (kTApp and kHApp both null, or both the given
// appearance distances; kScratch assoc_costs_scratch_words' floats),
// floats the thresholds and weights. Two launches on `stream`, the second
// behind the first by a programmatic dependent launch. Returns 0 or the
// first cudaError_t.
int assoc_costs_forward(const void* const* ptrs, const int* ints,
                        const float* floats, void* stream) {
  CostParams p = {};
  p.streams = ints[kStreams];
  p.t = ints[kT];
  p.d = ints[kD];
  p.h = ints[kH];
  p.f = ints[kF];
  p.n_depth = ints[kNDepth];
  p.confirm_hits = ints[kConfirmHits];
  p.emb_cap = ints[kEmbCap];
  p.metric = ints[kMetric];
  p.one_minus_w = floats[kOneMinusW];
  p.motion_w = floats[kMotionW];
  p.inv_chi = floats[kInvChi];
  p.chi = floats[kChi];
  p.max_assoc = floats[kMaxAssoc];
  p.iou_gate = floats[kIouGate];
  p.fill = floats[kFill];
  p.occlusion = floats[kOcclusion];
  p.sf_w = floats[kSfW];
  p.sf_h = floats[kSfH];
  p.mn_w = floats[kMnW];
  p.mn_h = floats[kMnH];
  const bool given = ptrs[kTApp] != nullptr;
  if (p.streams < 1 || p.streams > 65535 || p.t < 1 || p.h < 1 || p.d < 1
      || p.d > kMaxD || p.f < 1 || p.f > 2048 || p.n_depth < 0
      || (p.metric != 0 && p.metric != 1) || given != (ptrs[kHApp] != nullptr))
    return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q < kNumPtrs; ++q)
    if (!ptrs[q] && q != kTApp && q != kHApp)
      return static_cast<int>(cudaErrorInvalidValue);
  p.means = static_cast<const float*>(ptrs[kMeans]);
  p.covs = static_cast<const float*>(ptrs[kCovs]);
  p.tlbrs = static_cast<const float*>(ptrs[kTlbrs]);
  p.t_valid = static_cast<const unsigned char*>(ptrs[kTValid]);
  p.ages = static_cast<const int*>(ptrs[kAges]);
  p.hits = static_cast<const int*>(ptrs[kHits]);
  p.t_labels = static_cast<const int*>(ptrs[kTLabels]);
  p.feat_sum = static_cast<const float*>(ptrs[kFeatSum]);
  p.feat_count = static_cast<const float*>(ptrs[kFeatCount]);
  p.hist_sum = static_cast<const float*>(ptrs[kHistSum]);
  p.hist_count = static_cast<const float*>(ptrs[kHistCount]);
  p.h_labels = static_cast<const int*>(ptrs[kHLabels]);
  p.h_valid = static_cast<const unsigned char*>(ptrs[kHValid]);
  p.d_tlbrs = static_cast<const float*>(ptrs[kDTlbrs]);
  p.d_labels = static_cast<const int*>(ptrs[kDLabels]);
  p.d_valid = static_cast<const unsigned char*>(ptrs[kDValid]);
  p.d_emb = static_cast<const float*>(ptrs[kDEmb]);
  p.t_app = static_cast<const float*>(ptrs[kTApp]);
  p.h_app = static_cast<const float*>(ptrs[kHApp]);
  p.cost = static_cast<float*>(const_cast<void*>(ptrs[kCost]));
  p.iou_cost = static_cast<float*>(const_cast<void*>(ptrs[kIouCost]));
  p.reid_cost = static_cast<float*>(const_cast<void*>(ptrs[kReidCost]));
  p.occluded = static_cast<unsigned char*>(const_cast<void*>(ptrs[kOccluded]));
  p.h_reid_ok = static_cast<unsigned char*>(const_cast<void*>(ptrs[kHReidOk]));
  p.masks = static_cast<unsigned char*>(const_cast<void*>(ptrs[kMasks]));
  p.col4row = static_cast<int*>(const_cast<void*>(ptrs[kCol4Row]));
  float* scratch = static_cast<float*>(const_cast<void*>(ptrs[kScratch]));
  const ScratchLayout l = scratch_layout(p.streams, p.t, p.d, p.h, p.f,
                                         !given);
  p.feats = scratch + l.feats;
  p.a2 = scratch + l.a2;
  p.chol = scratch + l.chol;
  p.b2 = scratch + l.b2;
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 prep_grid(1 + (p.t + p.h + kPrepRows - 1) / kPrepRows
                       + (p.d + kDetBlock - 1) / kDetBlock, p.streams);
  assoc_prep_kernel<<<prep_grid, kThreads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = given ? 0 : kStages * 2 * kRows * kChunkStride
      * static_cast<int>(sizeof(float));
  e = cudaFuncSetAttribute(
      assoc_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(((p.t + kRows - 1) / kRows + (p.h + kRows - 1) / kRows)
                     * ((p.d + kCols - 1) / kCols), p.streams);
  cfg.blockDim = dim3(kTileThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, assoc_tile_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code the entry returned
const char* assoc_costs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
