// A gap frame's point assembly for Hopper (sm_90a): the depth order of the
// tracks, corner management and the LK point set, for every stream of a
// call, in two launches with no host sync.
//
// Replaces fastmot_tpu/tracker.py:243 _gap_points_core, which with
// fastmot_tpu/ops/flow_kernels.py:766 flow_points_core is part of the
// jitted gap program (_gap_pre_kernel, fastmot_tpu/tracker.py:333); not a
// Pallas kernel. Its plain PyTorch twin is gap_points_core (one stream) and
// gap_points_batch in fastmot_tpu_torch/tracker.py, eager chains of about a
// hundred launches; the wrapper gap_points in
// fastmot_tpu_torch/ops/gap_points.py checks the arguments, allocates the
// outputs as views of three buffers and calls gap_points_forward below.
//
// What bounds it on an H100: neither bytes nor operations. A stream reads
// the candidates (14,400 points and scores at 1280x720) and writes a few
// thousand points, about 0.2 MB; the box tests are a few million
// comparisons. What sets its time is the chain of dependent steps of one
// track: its owned candidates' count and best score, its threshold, the
// selection of its best 32, their order. The design spreads the tracks
// over blocks and keeps the chain short:
//
//   launch 1 (points_owner_kernel), blocks of 256 items a stream, the
//     candidates and then the bg candidates: each block ranks the tracks
//     by depth (a thread a track counts the keys before it: the stable
//     argsort), clips the first f_cap boxes to the frame in shared memory,
//     keeps the valid ones that reach into its items' extent, and gives
//     each item its owner, the first valid track in depth order whose
//     clipped box holds it (the plain version's cumsum blocking and its
//     background test, in O((C + B) f_cap) tests at most and no [T, C]
//     array). Block 0 of a stream writes the order, the gathered boxes and
//     validity and the clipped boxes.
//   launch 2 (points_select_kernel), a block per (stream, track) and one
//     per stream for the background:
//     - a track's block propagates its 32 keypoints (the [K, T] nearer
//       track test), counts its owned candidates and their best score
//       over the cells its clipped box spans (a candidate lies in its
//       cell), and decides need_detect; only then, and only if it must,
//       selects its new keypoints: the eligible candidates (owned, inside
//       the ellipse of the unclipped box, at least quality_level times
//       the best) ranked by the key (score, then the lower index), their
//       keys staged in shared memory by one pass over the cells (up to
//       1,024; past that each pass reads the cells again), the best 32
//       found by a radix select of 4-bit digits on that 64-bit key (a
//       shared histogram a digit, stopping as soon as the boundary digit
//       holds exactly the places left), gathered, and ordered by counting
//       the larger keys among them;
//     - the background block selects, the same way, the best min(256, B)
//       of the bg candidates that no valid track's clipped box holds (no
//       owner) and that score above 0.01 of the best.
//     Where fewer candidates are eligible than places, the places left
//     take the lowest-index candidates not chosen, in index order, as a
//     stable descending sort puts the -inf slots (their points are kept,
//     invalid).
//
// Every loop strides over its items by blockDim.x, shared counters are
// atomics on integers, and every dependency between threads passes a
// __syncthreads: the result does not depend on the block's thread count
// (the tests' host build runs the blocks with a few host threads) or on
// the order of the atomics, and a stream's result not on the stream count.
//
// Numerics: build with -fmad=false (ops/cuda_build.py KERNEL_FLAGS), as
// the host build runs under -ffp-contract=off, so every product and sum
// rounds on its own as in the plain version: the depth key -y2 +
// float(age) * 1e-3 (+inf for an inactive track), the clip, the ellipse
// ((p - c) / max(semi, 1e-6))^2 summed x then y, <= 1, the quality test
// score >= quality * max(best, 1e-6), need_detect count < density *
// float(area), the background test score > 0.01 * max(max, 1e-6). Box
// tests are inclusive. The outputs equal the plain version's bit for bit.

#include <cuda_runtime.h>

#include <math.h>
#include <stddef.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kKp = 32;            // KP_PER_TRACK
constexpr int kMaxBgKeep = 256;    // BG_KP
constexpr int kMaxFlow = 128;      // MAX_FLOW_TRACKS
constexpr int kMaxTracks = 256;    // ops/gap_points.py KERNEL_MAX_TRACKS
constexpr int kCell = 8;           // CELL
constexpr int kOwnerChunk = 256;   // candidates an owner block tests
constexpr uint8_t kNoOwner = 0xFF;

// The pointers of gap_points_forward's `ptrs`, in this order (as
// gap_points_launch_args in ops/gap_points.py lists them): inputs, the
// outputs, then the scratch (the owners, a byte a candidate and a bg
// candidate).
enum Ptr {
  kTlbrs, kValid, kAges, kKps, kKpv, kCandPts, kCandScore, kBgPts,
  kBgScore, kAllPrev, kAllValid, kInside, kForder, kFTlbrs, kFValid,
  kOwner, kNumPtrs
};
enum Int {
  kStreams, kTracks, kFlow, kCands, kCandCols, kBgCands, kBgKeep, kFrameW,
  kFrameH, kNumInts
};
enum Float { kQuality, kDensity, kNumFloats };

struct Params {
  const float* tlbrs;
  const bool* valid;
  const int* ages;
  const float* kps;
  const bool* kpv;
  const float* cand_pts;
  const float* cand_score;
  const float* bg_pts;
  const float* bg_score;
  float* all_prev;
  bool* all_valid;
  float* inside;
  long long* forder;
  float* f_tlbrs;
  bool* f_valid;
  uint8_t* owner;
  int n_tracks, f_cap, n_cands, cand_cols, n_bg, bg_keep, n_points;
  float frame_x1, frame_y1, quality, density;
};

struct Box {
  float x1, y1, x2, y2;
};

// the four tests combined without branches, so that loops of them unroll
// and pipeline their loads
__device__ __forceinline__ bool in_box(float x, float y, const Box& b) {
  return (x >= b.x1) & (x <= b.x2) & (y >= b.y1) & (y <= b.y2);
}

// torch.maximum / torch.minimum against a finite bound: NaN propagates
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a > b || a != a) ? a : b;
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return (a < b || a != a) ? a : b;
}

// An order-preserving map of float32 to uint32 (larger float, larger key)
__device__ __forceinline__ unsigned ord(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}
__device__ __forceinline__ float unord(unsigned k) {
  return __uint_as_float((k & 0x80000000u) ? (k & 0x7FFFFFFFu) : ~k);
}

// A candidate's selection key: the score, then the lower index
__device__ __forceinline__ unsigned long long sel_key(float score, int c) {
  return (static_cast<unsigned long long>(ord(score)) << 32)
      | (0xFFFFFFFFu - static_cast<unsigned>(c));
}
__device__ __forceinline__ int key_index(unsigned long long key) {
  return static_cast<int>(0xFFFFFFFFu - static_cast<unsigned>(key));
}

// torch.sort's ascending order of a float (NaN last), for the stable rank
__device__ __forceinline__ bool key_less(float a, float b) {
  return a == a && (b != b || a < b);
}
__device__ __forceinline__ bool key_same(float a, float b) {
  return a == b || (a != a && b != b);
}

// The depth key of track i of a stream: near (the larger bottom edge y2)
// first, the younger first on a tie; +inf for an inactive track
__device__ __forceinline__ float depth_key(const Params& p, int s, int i) {
  const size_t t = static_cast<size_t>(s) * p.n_tracks + i;
  const bool active = p.valid[t] && p.ages[t] < 2;
  return active ? -p.tlbrs[4 * t + 3] + static_cast<float>(p.ages[t]) * 1e-3f
                : INFINITY;
}

__global__ void __launch_bounds__(kThreads)
points_owner_kernel(const Params p) {
  __shared__ float keys[kMaxTracks];
  __shared__ int order[kMaxFlow];
  __shared__ Box boxes[kMaxFlow], near_box[kMaxFlow];
  __shared__ bool live[kMaxFlow];
  __shared__ int near_f[kMaxFlow], n_near;
  __shared__ unsigned extent[4];
  const int s = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    n_near = 0;
    extent[0] = extent[1] = ord(INFINITY);
    extent[2] = extent[3] = ord(-INFINITY);
  }
  for (int i = tid; i < p.n_tracks; i += nt) keys[i] = depth_key(p, s, i);
  __syncthreads();
  for (int i = tid; i < p.n_tracks; i += nt) {
    const float k = keys[i];
    int rank = 0;
    for (int j = 0; j < p.n_tracks; ++j)
      rank += key_less(keys[j], k) || (key_same(keys[j], k) && j < i);
    if (rank < p.f_cap) order[rank] = i;
  }
  __syncthreads();
  for (int f = tid; f < p.f_cap; f += nt) {
    const int i = order[f];
    const size_t t = static_cast<size_t>(s) * p.n_tracks + i;
    const float* tl = p.tlbrs + 4 * t;
    const Box b{nan_max(tl[0], 0.f), nan_max(tl[1], 0.f),
                nan_min(tl[2], p.frame_x1), nan_min(tl[3], p.frame_y1)};
    boxes[f] = b;
    live[f] = p.valid[t] && p.ages[t] < 2;
    if (blockIdx.x == 0) {
      const size_t o = static_cast<size_t>(s) * p.f_cap + f;
      p.forder[o] = i;
      p.f_valid[o] = live[f];
      for (int j = 0; j < 4; ++j) p.f_tlbrs[4 * o + j] = tl[j];
      p.inside[4 * o] = b.x1;
      p.inside[4 * o + 1] = b.y1;
      p.inside[4 * o + 2] = b.x2;
      p.inside[4 * o + 3] = b.y2;
    }
  }
  __syncthreads();
  // this block's items: candidates, then the bg candidates after them
  const int c0 = static_cast<int>(blockIdx.x) * kOwnerChunk;
  const int c_end = min(p.n_cands + p.n_bg, c0 + kOwnerChunk);
  const float* pts = p.cand_pts + static_cast<size_t>(s) * p.n_cands * 2;
  const float* bg = p.bg_pts + static_cast<size_t>(s) * p.n_bg * 2;
  auto point = [&](int c) {
    return c < p.n_cands ? pts + 2 * c : bg + 2 * (c - p.n_cands);
  };
  // their extent (a NaN point has no owner), then the live boxes that
  // reach into it: an item takes the least index of those holding it
  unsigned lo_x = ord(INFINITY), lo_y = lo_x, hi_x = ord(-INFINITY);
  unsigned hi_y = hi_x;
  for (int c = c0 + tid; c < c_end; c += nt) {
    const float* q = point(c);
    if (q[0] == q[0] && q[1] == q[1]) {
      lo_x = min(lo_x, ord(q[0]));
      hi_x = max(hi_x, ord(q[0]));
      lo_y = min(lo_y, ord(q[1]));
      hi_y = max(hi_y, ord(q[1]));
    }
  }
  atomicMin(&extent[0], lo_x);
  atomicMin(&extent[1], lo_y);
  atomicMax(&extent[2], hi_x);
  atomicMax(&extent[3], hi_y);
  __syncthreads();
  const Box reach{unord(extent[0]), unord(extent[1]), unord(extent[2]),
                  unord(extent[3])};
  for (int f = tid; f < p.f_cap; f += nt) {
    const Box b = boxes[f];
    if (live[f] & (b.x2 >= reach.x1) & (b.x1 <= reach.x2)
        & (b.y2 >= reach.y1) & (b.y1 <= reach.y2)) {
      const int k = atomicAdd(&n_near, 1);
      near_box[k] = b;
      near_f[k] = f;
    }
  }
  __syncthreads();
  uint8_t* owner = p.owner + static_cast<size_t>(s) * (p.n_cands + p.n_bg);
  const int n = n_near;
  for (int c = c0 + tid; c < c_end; c += nt) {
    const float* q = point(c);
    // every near box tested: the loop carries nothing from one test to
    // the next, so the tests pipeline
    int o = kNoOwner;
#pragma unroll 4
    for (int k = 0; k < n; ++k)
      if (in_box(q[0], q[1], near_box[k])) o = min(o, near_f[k]);
    owner[c] = static_cast<uint8_t>(o);
  }
}

// The shared state of a selection: the eligible keys' count, a digit
// histogram, the key prefix and mask found so far, the places left
struct Select {
  int total, hist[16];
  unsigned long long prefix, mask;
  int need, done, n_sel;
};
// eligible keys a selection keeps in shared memory (the tests' host build
// also runs with a few, so that the passes over the domain run too)
#ifndef GAP_POINTS_STAGE
#define GAP_POINTS_STAGE 1024
#endif
constexpr int kStage = GAP_POINTS_STAGE;

// The best `keep` eligible items of a domain of n (elig(e, &key): whether
// item e is eligible, and its key), by key, into out[0 .. min(keep,
// eligible)) in descending order; returns the count. A first pass over the
// domain stages the eligible keys in `stage` (kStage keys of shared
// memory); where more are eligible, every pass reads the domain again.
// `chosen` holds `keep` keys of shared memory. Every thread calls it.
template <class Elig>
__device__ int select_top(int n, int keep, const Elig& elig, Select& sh,
                          unsigned long long* stage,
                          unsigned long long* chosen, int* out) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    sh.total = sh.n_sel = 0;
    sh.prefix = sh.mask = 0;
    sh.need = keep;
  }
  __syncthreads();
  for (int e = tid; e < n; e += nt) {
    unsigned long long key;
    if (elig(e, &key)) {
      const int slot = atomicAdd(&sh.total, 1);
      if (slot < kStage) stage[slot] = key;
    }
  }
  __syncthreads();
  const int total = sh.total;
  const bool staged = total <= kStage;
  const int m = staged ? total : n;
  auto item = [&](int e, unsigned long long* key) {
    if (staged) {
      *key = stage[e];
      return true;
    }
    return elig(e, key);
  };
  // every eligible item is chosen, or the radix select of the keep-th key
  bool done = total <= keep;
  for (int shift = 60; !done && shift >= 0; shift -= 4) {
    for (int d = tid; d < 16; d += nt) sh.hist[d] = 0;
    __syncthreads();
    const unsigned long long prefix = sh.prefix, mask = sh.mask;
    for (int e = tid; e < m; e += nt) {
      unsigned long long key;
      if (item(e, &key) && (key & mask) == prefix)
        atomicAdd(&sh.hist[(key >> shift) & 15], 1);
    }
    __syncthreads();
    if (tid == 0) {
      int d = 15;
      while (sh.hist[d] < sh.need) sh.need -= sh.hist[d--];
      sh.prefix |= static_cast<unsigned long long>(d) << shift;
      sh.mask |= 15ull << shift;
      sh.done = sh.hist[d] == sh.need;
    }
    __syncthreads();
    done = sh.done;
  }
  // the chosen: every eligible item whose masked key is at least the prefix
  const unsigned long long prefix = sh.prefix, mask = sh.mask;
  for (int e = tid; e < m; e += nt) {
    unsigned long long key;
    if (item(e, &key) && (key & mask) >= prefix)
      chosen[atomicAdd(&sh.n_sel, 1)] = key;
  }
  __syncthreads();
  const int n_sel = sh.n_sel;
  for (int j = tid; j < n_sel; j += nt) {
    int rank = 0;
    for (int k = 0; k < n_sel; ++k) rank += chosen[k] > chosen[j];
    out[rank] = key_index(chosen[j]);
  }
  __syncthreads();
  return n_sel;
}

// The places out[n_sel .. keep) of a selection that found fewer eligible
// items than places: the lowest indices c < n whose item is not eligible,
// in index order (elig_at(c): whether index c is eligible). `flags` holds
// 2 * keep bytes of shared memory. A thread a run of kFillRun indices
// counts its free ones, thread 0 sums the runs before each, and each run's
// thread places its own.
constexpr int kFillRun = 32;
template <class EligAt>
__device__ void fill_rest(int n, int keep, int n_sel, const EligAt& elig_at,
                          uint8_t* flags, int* out) {
  __shared__ int run_base[2 * kMaxBgKeep / kFillRun];
  const int tid = threadIdx.x, nt = blockDim.x;
  const int m = min(n, keep + n_sel);     // the rest lies below
  const int n_runs = (m + kFillRun - 1) / kFillRun;
  for (int c = tid; c < m; c += nt) flags[c] = !elig_at(c);
  __syncthreads();
  for (int r = tid; r < n_runs; r += nt) {
    int free = 0;
    for (int c = r * kFillRun; c < min(m, (r + 1) * kFillRun); ++c)
      free += flags[c];
    run_base[r] = free;
  }
  __syncthreads();
  if (tid == 0) {
    for (int r = 0, base = n_sel; r < n_runs; ++r) {
      const int free = run_base[r];
      run_base[r] = base;
      base += free;
    }
  }
  __syncthreads();
  for (int r = tid; r < n_runs; r += nt) {
    int slot = run_base[r];
    for (int c = r * kFillRun; c < min(m, (r + 1) * kFillRun) && slot < keep;
         ++c)
      if (flags[c]) out[slot++] = c;
  }
  __syncthreads();
}

// A track's block: its keypoints, kept or made anew (boxes and live: the
// stream's clipped boxes and validity in flow order, in shared memory)
__device__ __forceinline__ void track_points(const Params& p, int s, int f,
                                             const Box* boxes,
                                             const bool* live,
                                             unsigned long long* stage) {
  __shared__ int prop[kKp];
  __shared__ int owned;
  __shared__ unsigned best;
  __shared__ Select sh;
  __shared__ unsigned long long chosen[kKp];
  __shared__ int picked[kKp];
  __shared__ uint8_t flags[2 * kKp];
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t o = static_cast<size_t>(s) * p.f_cap + f;
  const int i = static_cast<int>(p.forder[o]);
  const bool valid = live[f];
  const Box box = boxes[f];
  const size_t t = static_cast<size_t>(s) * p.n_tracks + i;
  const float* kps = p.kps + t * kKp * 2;
  const bool* kpv = p.kpv + t * kKp;
  if (tid == 0) {
    owned = 0;
    best = ord(-INFINITY);
  }
  // propagation: a keypoint stays if it is in the box and in no nearer
  // valid track's box
  for (int k = tid; k < kKp; k += nt) {
    const float x = kps[2 * k], y = kps[2 * k + 1];
    bool blocked = false;
#pragma unroll 4
    for (int j = 0; j < f; ++j) blocked |= live[j] & in_box(x, y, boxes[j]);
    prop[k] = valid && kpv[k] && in_box(x, y, box) && !blocked;
  }
  // the cells the clipped box spans (their candidates lie in them)
  const int rows = p.n_cands / p.cand_cols;
  const float inv = 1.f / kCell;
  const int gx0 = static_cast<int>(fminf(fmaxf(floorf(box.x1 * inv), 0.f),
                                         p.cand_cols - 1.f));
  const int gx1 = static_cast<int>(fminf(fmaxf(floorf(box.x2 * inv), 0.f),
                                         p.cand_cols - 1.f));
  const int gy0 = static_cast<int>(fminf(fmaxf(floorf(box.y1 * inv), 0.f),
                                         rows - 1.f));
  const int gy1 = static_cast<int>(fminf(fmaxf(floorf(box.y2 * inv), 0.f),
                                         rows - 1.f));
  const int cols = max(gx1 - gx0 + 1, 0);
  const int n_win = valid ? cols * max(gy1 - gy0 + 1, 0) : 0;
  const float* pts = p.cand_pts + static_cast<size_t>(s) * p.n_cands * 2;
  const float* score = p.cand_score + static_cast<size_t>(s) * p.n_cands;
  const uint8_t* owner = p.owner
      + static_cast<size_t>(s) * (p.n_cands + p.n_bg);
  __syncthreads();
  int my_owned = 0;
  unsigned my_best = ord(-INFINITY);
  for (int e = tid; e < n_win; e += nt) {
    const int c = (gy0 + e / cols) * p.cand_cols + gx0 + e % cols;
    if (owner[c] == f) {
      ++my_owned;
      my_best = max(my_best, ord(score[c]));
    }
  }
  if (my_owned) {
    atomicAdd(&owned, my_owned);
    atomicMax(&best, my_best);
  }
  __syncthreads();
  int n_prop = 0;
  for (int k = 0; k < kKp; ++k) n_prop += prop[k];
  const bool need = static_cast<float>(n_prop)
      < p.density * static_cast<float>(owned * kCell * kCell);
  float* out_pts = p.all_prev + (static_cast<size_t>(s) * p.n_points
                                 + static_cast<size_t>(f) * kKp) * 2;
  bool* out_valid = p.all_valid + static_cast<size_t>(s) * p.n_points
      + static_cast<size_t>(f) * kKp;
  if (!need) {
    for (int k = tid; k < kKp; k += nt) {
      out_pts[2 * k] = kps[2 * k];
      out_pts[2 * k + 1] = kps[2 * k + 1];
      out_valid[k] = prop[k];
    }
    return;
  }
  const float* tl = p.f_tlbrs + 4 * o;
  const float cx = (tl[0] + tl[2]) * 0.5f, cy = (tl[1] + tl[3]) * 0.5f;
  const float ax = fmaxf(((tl[2] - tl[0]) + 1.f) * 0.5f, 1e-6f);
  const float ay = fmaxf(((tl[3] - tl[1]) + 1.f) * 0.5f, 1e-6f);
  const float thr = p.quality * fmaxf(unord(best), 1e-6f);
  auto elig_at = [&](int c) {
    if (owner[c] != f) return false;
    const float rx = (pts[2 * c] - cx) / ax, ry = (pts[2 * c + 1] - cy) / ay;
    return rx * rx + ry * ry <= 1.f && score[c] >= thr;
  };
  auto elig = [&](int e, unsigned long long* key) {
    const int c = (gy0 + e / cols) * p.cand_cols + gx0 + e % cols;
    if (!elig_at(c)) return false;
    *key = sel_key(score[c], c);
    return true;
  };
  const int n_sel = select_top(n_win, kKp, elig, sh, stage, chosen, picked);
  if (n_sel < kKp) fill_rest(p.n_cands, kKp, n_sel, elig_at, flags, picked);
  for (int k = tid; k < kKp; k += nt) {
    const int c = picked[k];
    out_pts[2 * k] = pts[2 * c];
    out_pts[2 * k + 1] = pts[2 * c + 1];
    out_valid[k] = k < n_sel;
  }
}

// A stream's background block: the best bg candidates outside the valid
// tracks' clipped boxes (those the owner pass gave no owner)
__device__ __forceinline__ void bg_points(const Params& p, int s,
                                          unsigned long long* stage) {
  __shared__ unsigned best;
  __shared__ Select sh;
  __shared__ unsigned long long chosen[kMaxBgKeep];
  __shared__ int picked[kMaxBgKeep];
  __shared__ uint8_t flags[2 * kMaxBgKeep];
  const int tid = threadIdx.x, nt = blockDim.x;
  const float* pts = p.bg_pts + static_cast<size_t>(s) * p.n_bg * 2;
  const float* score = p.bg_score + static_cast<size_t>(s) * p.n_bg;
  const uint8_t* owner = p.owner
      + static_cast<size_t>(s) * (p.n_cands + p.n_bg) + p.n_cands;
  if (tid == 0) best = ord(-INFINITY);
  __syncthreads();
  unsigned my_best = ord(-INFINITY);
  for (int b = tid; b < p.n_bg; b += nt) my_best = max(my_best, ord(score[b]));
  atomicMax(&best, my_best);
  __syncthreads();
  const float thr = 0.01f * fmaxf(unord(best), 1e-6f);
  auto elig_at = [&](int b) { return owner[b] == kNoOwner && score[b] > thr; };
  auto elig = [&](int b, unsigned long long* key) {
    if (!elig_at(b)) return false;
    *key = sel_key(score[b], b);
    return true;
  };
  const int n_sel = select_top(p.n_bg, p.bg_keep, elig, sh, stage, chosen,
                               picked);
  if (n_sel < p.bg_keep)
    fill_rest(p.n_bg, p.bg_keep, n_sel, elig_at, flags, picked);
  const size_t base = static_cast<size_t>(s) * p.n_points
      + static_cast<size_t>(p.f_cap) * kKp;
  for (int k = tid; k < p.bg_keep; k += nt) {
    const int b = picked[k];
    p.all_prev[2 * (base + k)] = pts[2 * b];
    p.all_prev[2 * (base + k) + 1] = pts[2 * b + 1];
    p.all_valid[base + k] = k < n_sel;
  }
}

__global__ void __launch_bounds__(kThreads)
points_select_kernel(const Params p) {
  __shared__ Box boxes[kMaxFlow];
  __shared__ bool live[kMaxFlow];
  __shared__ unsigned long long stage[kStage];
  const int s = blockIdx.y;
  for (int f = threadIdx.x; f < p.f_cap; f += blockDim.x) {
    const size_t o = static_cast<size_t>(s) * p.f_cap + f;
    const float* b = p.inside + 4 * o;
    boxes[f] = Box{b[0], b[1], b[2], b[3]};
    live[f] = p.f_valid[o];
  }
  __syncthreads();
  if (static_cast<int>(blockIdx.x) < p.f_cap)
    track_points(p, s, blockIdx.x, boxes, live, stage);
  else
    bg_points(p, s, stage);
}

}  // namespace

extern "C" {

// One call of the point assembly for ints[kStreams] streams: `ptrs` holds
// the Ptr enum's device pointers in its order, `ints` and `floats` the Int
// and Float enums' values. Two launches on `stream`: the owners, then the
// tracks' and the background's points. Returns 0 or the first
// cudaError_t.
int gap_points_forward(const void* const* ptrs, const int* ints,
                       const float* floats, void* stream) {
  Params p = {};
  const int n_streams = ints[kStreams];
  p.n_tracks = ints[kTracks];
  p.f_cap = ints[kFlow];
  p.n_cands = ints[kCands];
  p.cand_cols = ints[kCandCols];
  p.n_bg = ints[kBgCands];
  p.bg_keep = ints[kBgKeep];
  if (n_streams < 1 || n_streams > 65535 || p.n_tracks < 1
      || p.n_tracks > kMaxTracks || p.f_cap < 1 || p.f_cap > kMaxFlow
      || p.f_cap > p.n_tracks || p.n_cands < 1 || p.cand_cols < 1
      || p.n_cands % p.cand_cols || p.n_bg < 1
      || p.bg_keep != min(p.n_bg, kMaxBgKeep))
    return static_cast<int>(cudaErrorInvalidValue);
  p.n_points = p.f_cap * kKp + p.bg_keep;
  p.frame_x1 = static_cast<float>(ints[kFrameW] - 1);
  p.frame_y1 = static_cast<float>(ints[kFrameH] - 1);
  p.quality = floats[kQuality];
  p.density = floats[kDensity];
  p.tlbrs = static_cast<const float*>(ptrs[kTlbrs]);
  p.valid = static_cast<const bool*>(ptrs[kValid]);
  p.ages = static_cast<const int*>(ptrs[kAges]);
  p.kps = static_cast<const float*>(ptrs[kKps]);
  p.kpv = static_cast<const bool*>(ptrs[kKpv]);
  p.cand_pts = static_cast<const float*>(ptrs[kCandPts]);
  p.cand_score = static_cast<const float*>(ptrs[kCandScore]);
  p.bg_pts = static_cast<const float*>(ptrs[kBgPts]);
  p.bg_score = static_cast<const float*>(ptrs[kBgScore]);
  p.all_prev = static_cast<float*>(const_cast<void*>(ptrs[kAllPrev]));
  p.all_valid = static_cast<bool*>(const_cast<void*>(ptrs[kAllValid]));
  p.inside = static_cast<float*>(const_cast<void*>(ptrs[kInside]));
  p.forder = static_cast<long long*>(const_cast<void*>(ptrs[kForder]));
  p.f_tlbrs = static_cast<float*>(const_cast<void*>(ptrs[kFTlbrs]));
  p.f_valid = static_cast<bool*>(const_cast<void*>(ptrs[kFValid]));
  p.owner = static_cast<uint8_t*>(const_cast<void*>(ptrs[kOwner]));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 owner_grid((p.n_cands + p.n_bg + kOwnerChunk - 1) / kOwnerChunk,
                        n_streams);
  points_owner_kernel<<<owner_grid, kThreads, 0, st>>>(p);
  int code = static_cast<int>(cudaGetLastError());
  if (code) return code;
  const dim3 select_grid(p.f_cap + 1, n_streams);
  points_select_kernel<<<select_grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code gap_points_forward returned
const char* gap_points_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
