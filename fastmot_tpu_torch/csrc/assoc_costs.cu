// The association frame's costs for Hopper (sm_90a): every cascade
// stage's cost matrix and row mask of every stream in one launch, with no
// host sync.
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
// stream over blocks and keeps every intermediate on chip:
//
//   a block a tile of 16 rows (tracks, or history rows) by 32 detections
//   and a stream, 256 threads: 48 blocks a stream at T = D = 128, H = 64.
//   A track tile computes its detections' occlusion (IoS against every
//   other detection, a warp a detection, the division only where boxes
//   meet) into shared memory; the tile's averaged features are normalised
//   in shared memory (16 threads a row, shuffle sums); the products with
//   its detections' embeddings run over chunks of 64 features staged in
//   shared memory transposed (a feature's 32 detections side by side,
//   the next chunk's loads in flight while a chunk is summed), a thread
//   one row and every 16th column, with the embeddings' squared norms
//   summed beside them; then each entry's cost in registers: the
//   distance, the empty fill, the Mahalanobis distance from the row's
//   Cholesky factor (computed once a row in shared memory), fuse_motion
//   and the gates, and the IoU cost. The first row tile of a stream also
//   writes its detections' occlusion; the first block the history's reID
//   mask, the cascade's row masks and col4row0.
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

constexpr int kThreads = 256;
constexpr int kRows = 16;                     // a tile's rows
constexpr int kRowThreads = kThreads / kRows; // 16 threads a row
constexpr int kCols = 32;                     // a tile's detections
constexpr int kThreadCols = kCols / kRowThreads;  // columns a thread
constexpr int kMaxD = 256;                    // detections a stream
constexpr int kChunk = 64;                    // features a staged chunk
constexpr int kChunkStride = kCols + 1;
// a thread's float4s of a chunk in flight, and the features a row's thread
// loads at once
constexpr int kPre = kCols * (kChunk / 4) / kThreads;
constexpr int kBatch = 8;
constexpr float kInfCost = 1e5f;              // assignment.INF_COST

// assoc_costs_forward's pointers, ints and floats
enum CostPtr {
  kMeans, kCovs, kTlbrs, kTValid, kAges, kHits, kTLabels, kFeatSum,
  kFeatCount, kHistSum, kHistCount, kHLabels, kHValid, kDTlbrs, kDLabels,
  kDValid, kDEmb,
  kTApp, kHApp,        // the appearance distances: null but on the split path
  kCost, kIouCost, kReidCost, kOccluded, kHReidOk, kMasks, kCol4Row,
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
  int streams, t, d, h, f, n_depth, confirm_hits, emb_cap, metric;
  float one_minus_w, motion_w, inv_chi, chi, max_assoc, iou_gate, fill;
  float occlusion, sf_w, sf_h, mn_w, mn_h;
};

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

// a block a tile of rows by detections and a stream
__global__ void __launch_bounds__(kThreads)
assoc_costs_kernel(const CostParams p) {
  // the tile's features [kRows][Fp], then a chunk of its detections'
  // embeddings transposed, [kChunk][kCols + 1]
  extern __shared__ float smem[];
  __shared__ float box_d[kMaxD][4];
  __shared__ float area_d[kMaxD];
  __shared__ int label_d[kMaxD];
  __shared__ unsigned char valid_d[kMaxD];
  __shared__ unsigned char occ[kMaxD];
  __shared__ float b2[kMaxD];
  __shared__ float row_a2[kRows];
  __shared__ float chol[kRows][10];      // l00 l10 l11 l20 l21 l22 l30 ..
  __shared__ float proj[kRows][4];
  const int T = p.t, D = p.d, H = p.h, F = p.f;
  const int col_tiles = (D + kCols - 1) / kCols;
  const int s = blockIdx.y, tile = blockIdx.x / col_tiles;
  const int c0 = (blockIdx.x % col_tiles) * kCols;
  const int c1 = c0 + kCols < D ? c0 + kCols : D;
  const int tid = threadIdx.x, nt = blockDim.x, warp = tid / 32;
  const int track_tiles = (T + kRows - 1) / kRows;
  const bool tracks = tile < track_tiles;
  const int row0 = (tracks ? tile : tile - track_tiles) * kRows;
  const int n_rows = tracks ? T : H;
  const bool products = tracks ? p.t_app == nullptr : p.h_app == nullptr;
  const int r = tid / kRowThreads, lane = tid % kRowThreads;
  const int row = row0 + r;
  const bool live = row < n_rows;

  // the first chunk of the tile's embeddings in flight: a thread's
  // float4s of the chunk's kCols x 16, neighbouring threads on a row's
  // neighbouring 16 bytes
  const float* emb = p.d_emb + (static_cast<size_t>(s) * D + c0) * F;
  const int quads = (c1 - c0) * (kChunk / 4);
  float4 pre[kPre];
  auto load_chunk = [&](int k0) {
    for (int u = 0; u < kPre; ++u) {
      const int q = tid + u * nt, j = q / (kChunk / 4);
      const int k = k0 + 4 * (q % (kChunk / 4));
      float4 v = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
      if (q < quads && k < F) {
        const float* e = emb + static_cast<size_t>(j) * F + k;
        if (k + 4 <= F && (F & 3) == 0) {
          v = *reinterpret_cast<const float4*>(e);
        } else {
          v.x = e[0];
          v.y = k + 1 < F ? e[1] : 0.0f;
          v.z = k + 2 < F ? e[2] : 0.0f;
          v.w = k + 3 < F ? e[3] : 0.0f;
        }
      }
      pre[u] = v;
    }
  };
  if (products) load_chunk(0);

  // the detections, and (tracks) the occlusion of the tile's: covered by
  // a valid other at IoS >= thresh (a warp a detection, its lanes the
  // others; the quotient only where the boxes meet or the threshold is
  // not positive), or past the embedding budget
  for (int j = tid; j < D; j += nt) {
    const float* b = p.d_tlbrs + (static_cast<size_t>(s) * D + j) * 4;
    for (int q = 0; q < 4; ++q) box_d[j][q] = b[q];
    area_d[j] = box_area(box_d[j]);
    label_d[j] = p.d_labels[static_cast<size_t>(s) * D + j];
    valid_d[j] = p.d_valid[static_cast<size_t>(s) * D + j];
  }
  __syncthreads();
  if (tracks) {
    const int lane32 = tid % 32, warps = nt / 32;
    for (int i = c0 + warp; i < c1; i += warps) {
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
      if (lane32 == 0) {
        occ[i] = (any && valid_d[i]) || i >= p.emb_cap;
        if (tile == 0) p.occluded[static_cast<size_t>(s) * D + i] = occ[i];
      }
    }
  }
  if (tile == 0 && c0 == 0) {
    // the history's reID mask, the cascade's row masks and col4row0
    for (int i = tid; i < H; i += nt) {
      const size_t at = static_cast<size_t>(s) * H + i;
      p.h_reid_ok[at] = p.h_valid[at] && p.hist_count[at] >= 2.0f;
    }
    const size_t plane = static_cast<size_t>(p.streams) * T;
    for (int i = tid; i < T; i += nt) {
      const size_t at = static_cast<size_t>(s) * T + i;
      const int age = p.ages[at];
      const bool valid = p.t_valid[at];
      const bool confirmed = p.hits[at] >= p.confirm_hits;
      const int depth = age >= 0 ? age / 2 : -((1 - age) / 2);   // floor
      for (int q = 0; q < p.n_depth; ++q)
        p.masks[q * plane + at] = valid && confirmed && depth == q;
      p.masks[p.n_depth * plane + at] = valid && confirmed && age < 2;
      p.masks[(p.n_depth + 1) * plane + at] = valid && !confirmed;
      p.col4row[at] = -1;
    }
  }

  // the tile's rows: (tracks) the projected mean and the Cholesky factor
  // of the projected covariance, JAX's unrolled order
  if (tracks && tid < kRows && row0 + tid < T) {
    const size_t at = static_cast<size_t>(s) * T + row0 + tid;
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
    int q = 0;
    for (int i = 0; i < 4; ++i)
      for (int j = 0; j <= i; ++j) chol[tid][q++] = l[i][j];
    for (int k = 0; k < 4; ++k) proj[tid][k] = m[k];
  }

  // the products: the tile's normalised features against the detections'
  // embeddings, a chunk of 64 features at a time, the next chunk's loads
  // in flight while a chunk is summed; every sum in ascending feature
  // order
  float acc[kThreadCols];
  for (int m = 0; m < kThreadCols; ++m) acc[m] = 0.0f;
  if (products) {
    const int fp = (F + kChunk - 1) / kChunk * kChunk;
    float* feats = smem;
    float* chunk = smem + kRows * fp;
    const int cs = kChunkStride;                 // the chunk's row stride
    const float* src = tracks
        ? p.feat_sum + (static_cast<size_t>(s) * T + row) * F
        : p.hist_sum + (static_cast<size_t>(s) * H + row) * F;
    const float count = live ? (tracks ? p.feat_count : p.hist_count)
        [static_cast<size_t>(s) * n_rows + row] : 1.0f;
    const float denom = count < 1.0f ? 1.0f : count;   // clamp(min=1)
    float sq = 0.0f;
    for (int k0 = lane; k0 < fp; k0 += kRowThreads * kBatch) {
      float v[kBatch];
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + kRowThreads * u;
        v[u] = live && k < F ? src[k] : 0.0f;
      }
      for (int u = 0; u < kBatch; ++u) {
        const int k = k0 + kRowThreads * u;
        if (k >= fp) break;
        const float a = v[u] / denom;
        feats[r * fp + k] = a;
        sq = sq + a * a;
      }
    }
    const float norm = sqrtf(row_sum(sq));
    const float div = norm > 0.0f ? norm : 1.0f;
    float sq2 = 0.0f;
    for (int k = lane; k < fp; k += kRowThreads) {
      const float v = feats[r * fp + k] / div;
      feats[r * fp + k] = v;
      sq2 = sq2 + v * v;
    }
    sq2 = row_sum(sq2);
    if (lane == 0) row_a2[r] = sq2;
    float b2_mine = 0.0f;
    for (int k0 = 0; k0 < fp; k0 += kChunk) {
      __syncthreads();   // the last chunk is read (and the feats written)
      for (int u = 0; u < kPre; ++u) {
        const int q = tid + u * nt;
        if (q >= quads) break;
        const int j = q / (kChunk / 4), kk = 4 * (q % (kChunk / 4));
        chunk[kk * cs + j] = pre[u].x;
        chunk[(kk + 1) * cs + j] = pre[u].y;
        chunk[(kk + 2) * cs + j] = pre[u].z;
        chunk[(kk + 3) * cs + j] = pre[u].w;
      }
      __syncthreads();
      if (k0 + kChunk < fp) load_chunk(k0 + kChunk);
      if (tid < c1 - c0)
        for (int kk = 0; kk < kChunk; ++kk) {
          const float v = chunk[kk * cs + tid];
          b2_mine = b2_mine + v * v;
        }
      const float* fr = feats + r * fp + k0;
#pragma unroll 4
      for (int kk = 0; kk < kChunk; ++kk) {
        const float f = fr[kk];
        const float* ck = chunk + kk * cs + lane;
#pragma unroll
        for (int m = 0; m < kThreadCols; ++m)
          if (c0 + lane + kRowThreads * m < c1)
            acc[m] = acc[m] + f * ck[kRowThreads * m];
      }
    }
    if (tid < c1 - c0) b2[c0 + tid] = b2_mine;
  }
  __syncthreads();   // occ, chol, b2 and row_a2 are whole
  if (!live) return;

  // each entry of the row
  const size_t out_row = (static_cast<size_t>(s) * n_rows + row) * D;
  const float* given = tracks ? p.t_app : p.h_app;
  const int row_label = tracks ? p.t_labels[static_cast<size_t>(s) * T + row]
                               : p.h_labels[static_cast<size_t>(s) * H + row];
  const float* tb = p.tlbrs + (static_cast<size_t>(s) * T + row) * 4;
  float t_box[4] = {0.0f, 0.0f, 0.0f, 0.0f};
  float t_area = 0.0f;
  bool empty_row = false;
  if (tracks) {
    for (int q = 0; q < 4; ++q) t_box[q] = tb[q];
    t_area = box_area(t_box);
    empty_row = p.feat_count[static_cast<size_t>(s) * T + row] < 1.0f;
  }
  for (int m = 0; m < kThreadCols; ++m) {
    const int j = c0 + lane + kRowThreads * m;
    if (j >= c1) break;
    float app;
    if (!products) {
      app = given[out_row + j];
    } else if (p.metric == 0) {      // euclidean: |a|^2 + |b|^2 - 2 a.b
      float v = (row_a2[r] + b2[j]) - 2.0f * acc[m];
      v = v != v ? v : (v < 0.0f ? 0.0f : v);
      app = sqrtf(v);
    } else {                         // cosine: 1 - a.b / (|a| |b|)
      const float den = sqrtf(row_a2[r]) * sqrtf(b2[j]);
      app = 1.0f - acc[m] / (den > 0.0f ? den : 1.0f);
    }
    const bool label_ok = row_label == label_d[j];
    if (!tracks) {
      p.reid_cost[out_row + j] = label_ok ? app : kInfCost;
      continue;
    }
    // the appearance cost, fused with the Mahalanobis distance, gated
    float cost = (empty_row || occ[j]) ? p.fill : app;
    const float* l = chol[r];
    const float d0 = box_d[j][0] - proj[r][0];
    const float d1 = box_d[j][1] - proj[r][1];
    const float d2 = box_d[j][2] - proj[r][2];
    const float d3 = box_d[j][3] - proj[r][3];
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
    const float inter = inter_area(t_box, box_d[j]);
    const float uni = (t_area + area_d[j]) - inter;
    const float iou = inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f)
                                   : 0.0f;
    const float iou_cost = 1.0f - iou;
    p.iou_cost[out_row + j] =
        (!label_ok || iou_cost > p.iou_gate) ? kInfCost : iou_cost;
  }
}

}  // namespace

extern "C" {

// The dynamic shared memory of a call with F features, and 0 on the
// split path (appearance given)
int assoc_costs_smem_bytes(int f, int products) {
  const int fp = (f + kChunk - 1) / kChunk * kChunk;
  return products ? (kRows * fp + kChunk * kChunkStride)
      * static_cast<int>(sizeof(float)) : 0;
}

// One call for ints[kStreams] streams of ints[kT] tracks, ints[kH] history
// rows, ints[kD] detections and ints[kF] features: `ptrs` holds the
// CostPtr enum's pointers (kTApp and kHApp both null, or both the given
// appearance distances), floats the thresholds and weights. One launch on
// `stream`. Returns 0 or the first cudaError_t.
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
  const int smem = assoc_costs_smem_bytes(p.f, !given);
  cudaError_t e = cudaFuncSetAttribute(
      assoc_costs_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const dim3 grid(((p.t + kRows - 1) / kRows + (p.h + kRows - 1) / kRows)
                  * ((p.d + kCols - 1) / kCols), p.streams);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  assoc_costs_kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code the entry returned
const char* assoc_costs_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
