// A gap frame's point assembly for Hopper (sm_90a): the depth order of the
// tracks, corner management and the LK point set, for every stream of a
// call, in two launches with no host sync, the second a programmatic
// dependent launch of the first.
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
// track: its flow row, its owned candidates' count and best score, its
// threshold, the selection of its best 32, their order. The first design
// ranked the depth order in every block (a thread a track counting
// the keys before it), ran the select launch only after the whole owner
// launch (1 x 48: owner 0-5.5 us, select 7.3-16.1 us), and selected by up
// to 16 radix passes of 4-bit digits, each three barriers and a serial
// 16-bin scan by thread 0 (4.7 us a track, median; scripts/
// prof_gap_points.py). This design:
//
//   launch 1 (points_owner_kernel), blocks of 256 items a stream, the
//     candidates and then the bg candidates. It lets launch 2 start at once
//     (cudaTriggerProgrammaticLaunchCompletion). Each block takes every
//     track's depth key (-y2 + age / 1000, +inf inactive) and slot as one
//     integer, keeps the live flow tracks whose clipped boxes reach into
//     its items' extent, and gives each item its owner: of those holding
//     it, the one of the least key, the first in depth order (the plain
//     version's cumsum blocking and its background test, in O((C + B)
//     f_cap) tests and no [T, C] array), stored as the track's slot. Where
//     every live key lies below +inf and the live tracks fit the flow
//     budget (the main paths), every live track is a flow track and no
//     rank is counted; else a track is one if fewer than f_cap keys
//     precede it.
//   launch 2 (points_select_kernel), blocks of 128 threads, one per
//     (stream, track slot) and one per stream for the background, beside
//     launch 1 until cudaGridDependencySynchronize, which comes only
//     before the first read of an owner:
//     - before it, a slot's block counts the keys below its own (a thread
//       a track: its flow row f), leaves if f >= f_cap, writes its row's
//       order, box and validity, gathers the nearer live tracks' clipped
//       boxes (a warp's ballot places them) and propagates its 32
//       keypoints against them (the [K, T] nearer-track test, a warp a
//       quarter of the boxes); it also loads the scores and ellipse tests
//       of its first two cells a thread of the cells its clipped box spans.
//       The background block takes its candidates' best score, keeping
//       its first two a thread in registers;
//     - after it, one pass over the box's cells (a candidate lies in its
//       cell) counts its owned candidates and their best score and stages
//       the keys of those inside the ellipse of the unclipped box (a warp's
//       ballot places them), up to 1,024 in shared memory (past that each
//       pass reads the cells again); need_detect follows, and only if it
//       holds, the selection: the eligible candidates (at least
//       quality_level times the best) ranked by the 64-bit key (the score's
//       order-preserving bits, then the complemented index, so ties go to
//       the lower index, as the plain version's stable sort), the best 32
//       found by a radix select of 8-bit digits: the first digit starts at
//       the highest bit in which the largest and the smallest eligible key
//       differ; a pass is one shared histogram (a warp's lanes of one digit
//       add once, found by __match_any_sync) and a suffix scan of its 256
//       bins by one warp (8 bins a lane, then a shuffle scan), and the
//       select stops as soon as the boundary digit holds exactly the places
//       left. The chosen are gathered and ordered: a track's 32 by counting
//       the larger keys among them, the background's up to 256 by a
//       counting sort on the first digit and a count within each bin;
//     - the background block selects, the same way, the best min(256, B)
//       of the bg candidates that no valid track's clipped box holds (no
//       owner) and that score above 0.01 of the best.
//     Where fewer candidates are eligible than places, the places left
//     take the lowest-index candidates not chosen, in index order, as a
//     stable descending sort puts the -inf slots (their points are kept,
//     invalid): each thread counts the free indices of its run, a block
//     scan gives each run its first place.
//
// Where the time goes now (scripts/prof_gap_points.py, H100 at 700 W,
// 1 x 48 / 8 x 128, medians of a selecting track's block): its flow row
// and nearer boxes 2.5 / 3.3 us, propagation and the cells ahead 1.4 /
// 2.3, the wait 0.3 / 0.4, the owned count and staging 2.2 / 2.5, the
// selection 3.5 / 3.3, the -inf places and writes 0.7 / 0.9; the owner
// launch 3.2 / 8.3 us; the call 12.9 / 22.4 us. 128 threads a select
// block: at 256 (12.4 / 28.6 us against 14.2 / 25.3 in the same call,
// an earlier form of this design) the register file holds four blocks an
// SM and the 8 x 128 call's 1,032 blocks no longer fit the card at once.
//
// Every loop strides over its items by blockDim.x (a multiple of 32, at
// most the launch's count), shared counters are atomics on integers, and
// every dependency between threads passes a __syncthreads or a warp's
// shuffle, ballot or match: the result does not depend on the block's
// thread count (the tests' host build runs the blocks with 32 or 64 host
// threads) or on the order of the atomics, and a stream's result not on the
// stream count.
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

constexpr int kThreads = 256;      // an owner block
constexpr int kSelectThreads = 128;
constexpr int kSelectWarps = kSelectThreads / 32;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kKp = 32;            // KP_PER_TRACK
constexpr int kMaxBgKeep = 256;    // BG_KP
constexpr int kMaxFlow = 128;      // MAX_FLOW_TRACKS
constexpr int kMaxTracks = 255;    // ops/gap_points.py KERNEL_MAX_TRACKS:
                                   // an owner is a slot below kNoOwner
constexpr int kCell = 8;           // CELL
constexpr int kOwnerChunk = 256;   // candidates an owner block tests
constexpr int kBins = 256;         // an 8-bit digit's
constexpr int kAhead = 2;          // items a thread loads before the owners
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
__device__ __forceinline__ float key_score(unsigned long long key) {
  return unord(static_cast<unsigned>(key >> 32));
}

// The depth key of track i of a stream: near (the larger bottom edge y2)
// first, the younger first on a tie; +inf for an inactive track
__device__ __forceinline__ float depth_key(const Params& p, int s, int i) {
  const size_t t = static_cast<size_t>(s) * p.n_tracks + i;
  const bool active = p.valid[t] && p.ages[t] < 2;
  return active ? -p.tlbrs[4 * t + 3] + static_cast<float>(p.ages[t]) * 1e-3f
                : INFINITY;
}

// Track i's depth key as one integer in torch.sort's ascending order (NaN
// last, -0 as 0), the slot index below it: the stable rank is the count of
// smaller integers
__device__ __forceinline__ unsigned long long rank_key(const Params& p,
                                                       int s, int i) {
  const float k = depth_key(p, s, i);
  const unsigned u = k != k ? 0xFFFFFFFFu : ord(k == 0.f ? 0.f : k);
  return (static_cast<unsigned long long>(u) << 32) | static_cast<unsigned>(i);
}

// Whether track slot t (of all streams' slots) is active
__device__ __forceinline__ bool active(const Params& p, size_t t) {
  return p.valid[t] && p.ages[t] < 2;
}

// Track i's box clipped to the frame
__device__ __forceinline__ Box clipped(const Params& p, const float* tl) {
  return Box{nan_max(tl[0], 0.f), nan_max(tl[1], 0.f),
             nan_min(tl[2], p.frame_x1), nan_min(tl[3], p.frame_y1)};
}

// rank_key of a depth key of +inf at slot 0: the live tracks below it rank
// before every inactive one
constexpr unsigned long long kInfKey = 0xFF80000000000000ull;

__global__ void __launch_bounds__(kThreads)
points_owner_kernel(const Params p) {
  cudaTriggerProgrammaticLaunchCompletion();
  __shared__ unsigned long long keys[kMaxTracks], near_key[kMaxFlow];
  __shared__ bool live[kMaxTracks];
  __shared__ Box near_box[kMaxFlow];
  __shared__ int n_near, n_live, n_low;
  __shared__ unsigned extent[4];
  const int s = blockIdx.y, tid = threadIdx.x, nt = blockDim.x;
  if (tid == 0) {
    n_near = n_live = n_low = 0;
    extent[0] = extent[1] = ord(INFINITY);
    extent[2] = extent[3] = ord(-INFINITY);
  }
  __syncthreads();
  for (int i = tid; i < p.n_tracks; i += nt) {
    keys[i] = rank_key(p, s, i);
    live[i] = active(p, static_cast<size_t>(s) * p.n_tracks + i);
    if (live[i]) {
      atomicAdd(&n_live, 1);
      if (keys[i] < kInfKey) atomicAdd(&n_low, 1);
    }
  }
  // this block's items: candidates, then the bg candidates after them, and
  // their extent (a NaN point has no owner)
  const int c0 = static_cast<int>(blockIdx.x) * kOwnerChunk;
  const int c_end = min(p.n_cands + p.n_bg, c0 + kOwnerChunk);
  const float* pts = p.cand_pts + static_cast<size_t>(s) * p.n_cands * 2;
  const float* bg = p.bg_pts + static_cast<size_t>(s) * p.n_bg * 2;
  auto point = [&](int c) {
    return c < p.n_cands ? pts + 2 * c : bg + 2 * (c - p.n_cands);
  };
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
  // the live flow tracks (depth rank below f_cap): every live one where
  // the live keys all lie below +inf and fit the budget (the main paths),
  // else those fewer than f_cap keys precede
  const bool all_flow = p.n_tracks <= p.f_cap
      || (n_low == n_live && n_live <= p.f_cap);
  const Box reach{unord(extent[0]), unord(extent[1]), unord(extent[2]),
                  unord(extent[3])};
  for (int i = tid; i < p.n_tracks; i += nt) {
    if (!live[i]) continue;
    if (!all_flow) {
      int rank = 0;
      for (int j = 0; j < p.n_tracks; ++j) rank += keys[j] < keys[i];
      if (rank >= p.f_cap) continue;
    }
    const Box b = clipped(p, p.tlbrs + 4 * (static_cast<size_t>(s)
                                            * p.n_tracks + i));
    if ((b.x2 >= reach.x1) & (b.x1 <= reach.x2) & (b.y2 >= reach.y1)
        & (b.y1 <= reach.y2)) {
      const int k = atomicAdd(&n_near, 1);
      near_box[k] = b;
      near_key[k] = keys[i];
    }
  }
  __syncthreads();
  // an item's owner: the nearest of those holding it (the least key), as
  // its slot
  uint8_t* owner = p.owner + static_cast<size_t>(s) * (p.n_cands + p.n_bg);
  const int n = n_near;
  for (int c = c0 + tid; c < c_end; c += nt) {
    const float* q = point(c);
    // every near box tested: the loop carries nothing from one test to
    // the next but the least key, so the tests pipeline
    unsigned long long o = ~0ull;
#pragma unroll 4
    for (int k = 0; k < n; ++k)
      if (in_box(q[0], q[1], near_box[k])) o = min(o, near_key[k]);
    owner[c] = o == ~0ull ? kNoOwner : static_cast<uint8_t>(o);
  }
}

// eligible keys a selection keeps in shared memory (the tests' host build
// also runs with a few, so that the passes over the domain run too)
#ifndef GAP_POINTS_STAGE
#define GAP_POINTS_STAGE 1024
#endif
constexpr int kStage = GAP_POINTS_STAGE;

// The shared state of a select block
struct Shared {
  unsigned long long stage[kStage];   // the staged keys
  unsigned long long chosen[kMaxBgKeep];   // before the selection, the
                                          // depth keys of a track's block
  // the keys in order_chosen's bins: the stage, free by then (or, in a
  // build that stages fewer keys, their own)
  unsigned long long spare[kStage >= kMaxBgKeep ? 1 : kMaxBgKeep];
  int picked[kMaxBgKeep];   // in order_chosen, first each key's bin slot
  int hist[kBins], start[kBins];
  unsigned long long wmax[kSelectWarps], wmin[kSelectWarps];
  int wsum[kSelectWarps], wsum2[kSelectWarps];
  unsigned wbits[kSelectWarps];
  int n_staged, n_sel;
  unsigned long long prefix, mask;
  int need, done;
  __device__ unsigned long long* binned() {
    return kStage >= kMaxBgKeep ? stage : spare;
  }
};

__device__ __forceinline__ int lane_id() { return threadIdx.x % 32; }
__device__ __forceinline__ int warp_id() { return threadIdx.x / 32; }
__device__ __forceinline__ int n_warps() { return blockDim.x / 32; }

// Appends `key` of every lane whose `keep` holds to dst[0 .. kStage) at
// *count (a warp's lanes, all of them calling, in one atomic)
__device__ __forceinline__ void warp_append(bool keep,
                                            unsigned long long key,
                                            unsigned long long* dst,
                                            int* count, int cap) {
  const unsigned bits = __ballot_sync(kFull, keep);
  const int lane = lane_id();
  int base = 0;
  if (lane == 0 && bits) base = atomicAdd(count, __popc(bits));
  base = __shfl_sync(kFull, base, 0);
  const int slot = base + __popc(bits & ((1u << lane) - 1u));
  if (keep && slot < cap) dst[slot] = key;
}

// The sum of v over the block (wsum: kSelectWarps ints of shared memory);
// every thread calls it and gets the sum, and may reuse wsum after its
// next __syncthreads
__device__ int block_sum(int v, int* wsum) {
  for (int m = 16; m > 0; m >>= 1) v += __shfl_xor_sync(kFull, v, m);
  if (lane_id() == 0) wsum[warp_id()] = v;
  __syncthreads();
  int total = 0;
  for (int w = 0; w < n_warps(); ++w) total += wsum[w];
  return total;
}

// The digit of `key` at `shift`
__device__ __forceinline__ int digit(unsigned long long key, int shift) {
  return static_cast<int>((key >> shift) & (kBins - 1));
}

// Each lane's 8 bins of sh.hist (lane * 8 ..) and the keys counted in the
// bins above them (a suffix scan of the lanes' sums): the scan of a radix
// pass and of order_chosen, on one warp
__device__ __forceinline__ int bins_above(const Shared& sh, int (&h)[8]) {
  const int lane = lane_id();
  int sum = 0;
  for (int j = 0; j < 8; ++j) {
    h[j] = sh.hist[8 * lane + j];
    sum += h[j];
  }
  int above = sum;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_down_sync(kFull, above, d);
    if (lane + d < 32) above += v;
  }
  return above - sum;
}

// sh.chosen[0 .. n_sel) (distinct keys) in descending order into sh.picked
// (their indices). A track's 32 (n_sel <= kKp): each key counts the larger
// keys. More (the background's up to 256): a counting sort by the digit at
// `shift` (sh.hist zero on entry; the bins' places by one warp's scan),
// then each key counts the larger keys in its bin, a few instead of 256.
__device__ void order_chosen(int n_sel, int shift, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x;
  if (n_sel <= kKp) {
    if (tid < n_sel) {
      const unsigned long long key = sh.chosen[tid];
      int rank = 0;
      for (int i = 0; i < n_sel; ++i) rank += sh.chosen[i] > key;
      sh.picked[rank] = key_index(key);
    }
    __syncthreads();
    return;
  }
  for (int j = tid; j < n_sel; j += nt)
    sh.picked[j] = atomicAdd(&sh.hist[digit(sh.chosen[j], shift)], 1);
  __syncthreads();
  if (tid < 32) {
    int h[8];
    int above = bins_above(sh, h);
    for (int j = 7; j >= 0; --j) {
      sh.start[8 * tid + j] = above;
      above += h[j];
    }
  }
  __syncthreads();
  for (int j = tid; j < n_sel; j += nt) {
    const unsigned long long key = sh.chosen[j];
    sh.binned()[sh.start[digit(key, shift)] + sh.picked[j]] = key;
  }
  __syncthreads();
  for (int j = tid; j < n_sel; j += nt) {
    const unsigned long long key = sh.chosen[j];
    const int d = digit(key, shift), b0 = sh.start[d], b1 = b0 + sh.hist[d];
    int rank = b0;
    for (int i = b0; i < b1; ++i) rank += sh.binned()[i] > key;
    sh.picked[rank] = key_index(key);
  }
  __syncthreads();
}

// The best `keep` of the m items (item(e, &key): whether item e is
// eligible, and its key), by key, into sh.picked[0 .. min(keep,
// eligible)) in descending order; returns the count. A radix select of
// 8-bit digits from the highest bit in which the eligible keys differ,
// stopping when the boundary digit holds exactly the places left; sh.hist
// must be zero. Every thread calls it.
template <class Item>
__device__ int select_top(int m, int keep, const Item& item, Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = lane_id();
  const int warp0 = tid - lane;
  __syncthreads();                 // the caller's staging and block sums
  // the eligible count and the largest and smallest eligible keys
  unsigned long long hi = 0, lo = ~0ull;
  int count = 0;
  for (int e = tid; e < m; e += nt) {
    unsigned long long key;
    if (item(e, &key)) {
      ++count;
      hi = max(hi, key);
      lo = min(lo, key);
    }
  }
  for (int d = 16; d > 0; d >>= 1) {
    hi = max(hi, __shfl_xor_sync(kFull, hi, d));
    lo = min(lo, __shfl_xor_sync(kFull, lo, d));
  }
  if (lane == 0) {
    sh.wmax[warp_id()] = hi;
    sh.wmin[warp_id()] = lo;
  }
  const int total = block_sum(count, sh.wsum);     // its barrier publishes
  for (int w = 0; w < n_warps(); ++w) {
    hi = max(hi, sh.wmax[w]);
    lo = min(lo, sh.wmin[w]);
  }
  // the first digit: from the highest bit in which the keys differ
  const int top = 63 - __clzll(static_cast<long long>(hi ^ lo));
  const int shift0 = max(top - 7, 0);
  unsigned long long prefix = 0, mask = 0;
  if (total > keep) {
    mask = top == 63 ? 0ull : ~0ull << (top + 1);
    prefix = hi & mask;
    int shift = shift0, need = keep;
    for (bool done = false; !done;) {
      // the histogram of the digit of the keys that match so far
      for (int base = warp0; base < m; base += nt) {
        const int e = base + lane;
        unsigned long long key = 0;
        const bool match = e < m && item(e, &key) && (key & mask) == prefix;
        const int d = match ? digit(key, shift) : kBins + lane;
        const unsigned peers = __match_any_sync(kFull, d);
        if (match && (peers & ((1u << lane) - 1u)) == 0)
          atomicAdd(&sh.hist[d], __popc(peers));
      }
      __syncthreads();
      if (tid < 32) {
        // the boundary bin, found by the lane whose 8 bins hold it
        int h[8];
        int above = bins_above(sh, h);
        for (int j = 0; j < 8; ++j) sh.hist[8 * lane + j] = 0;
        for (int j = 7; j >= 0; --j) {
          if (above < need && above + h[j] >= need) {
            sh.prefix = prefix | (static_cast<unsigned long long>(8 * lane + j)
                                  << shift);
            sh.mask = mask | (255ull << shift);
            sh.need = need - above;
            sh.done = h[j] == need - above;
          }
          above += h[j];
        }
      }
      __syncthreads();
      prefix = sh.prefix;
      mask = sh.mask;
      need = sh.need;
      done = sh.done;
      shift = max(shift - 8, 0);
    }
  }
  // the chosen: every eligible item whose masked key is at least the
  // prefix, then each one's place by the larger keys among them
  if (tid == 0) sh.n_sel = 0;
  __syncthreads();
  for (int base = warp0; base < m; base += nt) {
    const int e = base + lane;
    unsigned long long key = 0;
    const bool chosen = e < m && item(e, &key) && (key & mask) >= prefix;
    warp_append(chosen, key, sh.chosen, &sh.n_sel, kMaxBgKeep);
  }
  __syncthreads();
  const int n_sel = sh.n_sel;
  order_chosen(n_sel, shift0, sh);
  return n_sel;
}

// The places sh.picked[n_sel .. keep) of a selection that found fewer
// eligible items than places: the lowest indices c < n whose item is not
// eligible, in index order (elig_at(c): whether index c is eligible). Each
// thread counts the free indices of its run, a block scan gives each run
// its first place.
template <class EligAt>
__device__ void fill_rest(int n, int keep, int n_sel, const EligAt& elig_at,
                          Shared& sh) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = lane_id();
  const int m = min(n, keep + n_sel);     // the rest lies below
  const int run = (m + nt - 1) / nt;
  const int c0 = min(m, tid * run), c1 = min(m, c0 + run);
  unsigned free_bits = 0;                  // run <= 32: keep + n_sel <= 512
  for (int c = c0; c < c1; ++c) free_bits |= (!elig_at(c)) << (c - c0);
  const int n_free = __popc(free_bits);
  int before = n_free;
  for (int d = 1; d < 32; d <<= 1) {
    const int v = __shfl_up_sync(kFull, before, d);
    if (lane >= d) before += v;
  }
  if (lane == 31) sh.wsum2[warp_id()] = before;
  before -= n_free;
  __syncthreads();
  for (int w = 0; w < warp_id(); ++w) before += sh.wsum2[w];
  for (int slot = n_sel + before; free_bits && slot < keep; ++slot) {
    const int b = __ffs(free_bits) - 1;
    sh.picked[slot] = c0 + b;
    free_bits &= free_bits - 1;
  }
  __syncthreads();
}

// Track slot i's block: its flow row (the count of tracks before it in
// depth order) and, for a flow row, its keypoints, kept or made anew
__device__ void track_points(const Params& p, int s, int i, Shared& sh) {
  __shared__ Box near_box[kMaxFlow];
  __shared__ int n_near, nearer_sum[kSelectWarps];
  __shared__ unsigned best;
  const int tid = threadIdx.x, nt = blockDim.x, lane = lane_id();
  if (tid == 0) {
    best = ord(-INFINITY);
    sh.n_staged = 0;
    n_near = 0;
  }
  for (int d = tid; d < kBins; d += nt) sh.hist[d] = 0;
  __syncthreads();
  const size_t t = static_cast<size_t>(s) * p.n_tracks + i;
  const unsigned long long key = rank_key(p, s, i);
  // the tracks before this one: their count, and the live ones' clipped
  // boxes (the nearer tracks whose boxes block its keypoints)
  int nearer = 0;
  for (int base = tid - lane; base < p.n_tracks; base += nt) {
    const int j = base + lane;
    const size_t u = static_cast<size_t>(s) * p.n_tracks + j;
    const bool before = j < p.n_tracks && rank_key(p, s, j) < key;
    nearer += before;
    const bool blocks = before && active(p, u);
    const unsigned bits = __ballot_sync(kFull, blocks);
    int base_k = 0;
    if (lane == 0 && bits) base_k = atomicAdd(&n_near, __popc(bits));
    const int k = __shfl_sync(kFull, base_k, 0)
        + __popc(bits & ((1u << lane) - 1u));
    if (blocks && k < kMaxFlow) near_box[k] = clipped(p, p.tlbrs + 4 * u);
  }
  const int f = block_sum(nearer, nearer_sum);  // its barrier publishes
  if (f >= p.f_cap) {                           // not a flow row
    cudaGridDependencySynchronize();
    return;
  }
  const bool valid = active(p, t);
  const float* tl = p.tlbrs + 4 * t;
  const Box box = clipped(p, tl);
  const size_t o = static_cast<size_t>(s) * p.f_cap + f;
  if (tid == 0) {
    p.forder[o] = i;
    p.f_valid[o] = valid;
  }
  if (tid < 4) {
    p.f_tlbrs[4 * o + tid] = tl[tid];
    p.inside[4 * o + tid] = tid == 0 ? box.x1 : tid == 1 ? box.y1
                          : tid == 2 ? box.x2 : box.y2;
  }
  const float* kps = p.kps + t * kKp * 2;
  const bool* kpv = p.kpv + t * kKp;
  // propagation: a keypoint stays if it is in the box and in no nearer
  // valid track's box; warp w tests the nearer boxes w, w + warps, ...
  {
    const float x = kps[2 * lane], y = kps[2 * lane + 1];
    bool blocked = false;
    for (int j = warp_id(); j < n_near; j += n_warps())
      blocked |= in_box(x, y, near_box[j]);
    const unsigned bits = __ballot_sync(kFull, blocked);
    if (lane == 0) sh.wbits[warp_id()] = bits;
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
  const float cx = (tl[0] + tl[2]) * 0.5f, cy = (tl[1] + tl[3]) * 0.5f;
  const float ax = fmaxf(((tl[2] - tl[0]) + 1.f) * 0.5f, 1e-6f);
  const float ay = fmaxf(((tl[3] - tl[1]) + 1.f) * 0.5f, 1e-6f);
  auto in_ellipse = [&](int c) {
    const float rx = (pts[2 * c] - cx) / ax, ry = (pts[2 * c + 1] - cy) / ay;
    return rx * rx + ry * ry <= 1.f;
  };
  auto cell = [&](int e) {
    return (gy0 + e / cols) * p.cand_cols + gx0 + e % cols;
  };
  // this thread's first kAhead cells of the box: their scores and ellipse
  // tests before the owners are known
  float ahead_score[kAhead];
  bool ahead_in[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int e = tid + k * nt, c = e < n_win ? cell(e) : 0;
    ahead_score[k] = score[c];
    ahead_in[k] = in_ellipse(c);
  }

  // ---- the owners from here on --------------------------------------------
  cudaGridDependencySynchronize();
  const uint8_t* owner = p.owner
      + static_cast<size_t>(s) * (p.n_cands + p.n_bg);
  int my_owned = 0;
  unsigned my_best = ord(-INFINITY);
  // a cell's owner, then its count, best and staging (every lane of the
  // warp calls it)
  auto visit = [&](int e, bool own, float sc, bool inside) {
    if (own) {
      ++my_owned;
      my_best = max(my_best, ord(sc));
    }
    const bool ell = own && inside;
    warp_append(ell, sel_key(sc, e < n_win ? cell(e) : 0), sh.stage,
                &sh.n_staged, kStage);
  };
  uint8_t ahead_owner[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int e = tid + k * nt;
    ahead_owner[k] = e < n_win ? owner[cell(e)] : kNoOwner;
  }
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (tid - lane + k * nt >= n_win) break;        // the warp's cells end
    visit(tid + k * nt, ahead_owner[k] == i, ahead_score[k], ahead_in[k]);
  }
  for (int base = tid - lane + kAhead * nt; base < n_win; base += nt) {
    const int e = base + lane, c = e < n_win ? cell(e) : 0;
    visit(e, e < n_win && owner[c] == i, score[c], in_ellipse(c));
  }
  for (int d = 16; d > 0; d >>= 1)
    my_best = max(my_best, __shfl_xor_sync(kFull, my_best, d));
  if (lane == 0) atomicMax(&best, my_best);
  const int owned = block_sum(my_owned, sh.wsum);  // its barrier publishes
  unsigned blocked = 0;
  for (int w = 0; w < n_warps(); ++w) blocked |= sh.wbits[w];
  const bool prop = valid && kpv[lane] && in_box(kps[2 * lane],
                                                 kps[2 * lane + 1], box)
      && !((blocked >> lane) & 1u);
  const int n_prop = __popc(__ballot_sync(kFull, prop));
  const bool need = static_cast<float>(n_prop)
      < p.density * static_cast<float>(owned * kCell * kCell);
  float* out_pts = p.all_prev + (static_cast<size_t>(s) * p.n_points
                                 + static_cast<size_t>(f) * kKp) * 2;
  bool* out_valid = p.all_valid + static_cast<size_t>(s) * p.n_points
      + static_cast<size_t>(f) * kKp;
  if (!need) {
    if (tid < kKp) {
      out_pts[2 * tid] = kps[2 * tid];
      out_pts[2 * tid + 1] = kps[2 * tid + 1];
      out_valid[tid] = prop;
    }
    return;
  }
  const float thr = p.quality * fmaxf(unord(best), 1e-6f);
  auto elig_at = [&](int c) {
    return owner[c] == i && in_ellipse(c) && score[c] >= thr;
  };
  int n_sel;
  if (sh.n_staged <= kStage) {
    auto item = [&](int e, unsigned long long* key) {
      *key = sh.stage[e];
      return key_score(*key) >= thr;
    };
    n_sel = select_top(sh.n_staged, kKp, item, sh);
  } else {
    auto item = [&](int e, unsigned long long* key) {
      const int c = cell(e);
      if (!elig_at(c)) return false;
      *key = sel_key(score[c], c);
      return true;
    };
    n_sel = select_top(n_win, kKp, item, sh);
  }
  if (n_sel < kKp) fill_rest(p.n_cands, kKp, n_sel, elig_at, sh);
  if (tid < kKp) {
    const int c = sh.picked[tid];
    out_pts[2 * tid] = pts[2 * c];
    out_pts[2 * tid + 1] = pts[2 * c + 1];
    out_valid[tid] = tid < n_sel;
  }
}

// A stream's background block: the best bg candidates outside the valid
// tracks' clipped boxes (those the owner pass gave no owner)
__device__ void bg_points(const Params& p, int s, Shared& sh) {
  __shared__ unsigned best;
  const int tid = threadIdx.x, nt = blockDim.x, lane = lane_id();
  const float* pts = p.bg_pts + static_cast<size_t>(s) * p.n_bg * 2;
  const float* score = p.bg_score + static_cast<size_t>(s) * p.n_bg;
  if (tid == 0) {
    best = ord(-INFINITY);
    sh.n_staged = 0;
  }
  for (int d = tid; d < kBins; d += nt) sh.hist[d] = 0;
  __syncthreads();
  unsigned my_best = ord(-INFINITY);
  // the scores of this thread's first kAhead candidates stay in registers
  float ahead_score[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int b = tid + k * nt;
    ahead_score[k] = b < p.n_bg ? score[b] : -INFINITY;
    my_best = max(my_best, ord(ahead_score[k]));
  }
  for (int b = tid + kAhead * nt; b < p.n_bg; b += nt)
    my_best = max(my_best, ord(score[b]));
  for (int d = 16; d > 0; d >>= 1)
    my_best = max(my_best, __shfl_xor_sync(kFull, my_best, d));
  if (lane == 0) atomicMax(&best, my_best);
  __syncthreads();
  const float thr = 0.01f * fmaxf(unord(best), 1e-6f);

  // ---- the owners from here on --------------------------------------------
  cudaGridDependencySynchronize();
  const uint8_t* owner = p.owner
      + static_cast<size_t>(s) * (p.n_cands + p.n_bg) + p.n_cands;
  auto elig_at = [&](int b) { return owner[b] == kNoOwner && score[b] > thr; };
  uint8_t ahead_owner[kAhead];
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    const int b = tid + k * nt;
    ahead_owner[k] = b < p.n_bg ? owner[b] : 0;
  }
#pragma unroll
  for (int k = 0; k < kAhead; ++k) {
    if (tid - lane + k * nt >= p.n_bg) break;       // the warp's items end
    const int b = tid + k * nt;
    const bool e = ahead_owner[k] == kNoOwner && ahead_score[k] > thr;
    warp_append(e, sel_key(ahead_score[k], b), sh.stage, &sh.n_staged,
                kStage);
  }
  for (int base = tid - lane + kAhead * nt; base < p.n_bg; base += nt) {
    const int b = base + lane;
    const bool e = b < p.n_bg && elig_at(b);
    warp_append(e, e ? sel_key(score[b], b) : 0, sh.stage, &sh.n_staged,
                kStage);
  }
  __syncthreads();
  int n_sel;
  if (sh.n_staged <= kStage) {
    auto item = [&](int e, unsigned long long* key) {
      *key = sh.stage[e];
      return true;
    };
    n_sel = select_top(sh.n_staged, p.bg_keep, item, sh);
  } else {
    auto item = [&](int b, unsigned long long* key) {
      if (!elig_at(b)) return false;
      *key = sel_key(score[b], b);
      return true;
    };
    n_sel = select_top(p.n_bg, p.bg_keep, item, sh);
  }
  if (n_sel < p.bg_keep) fill_rest(p.n_bg, p.bg_keep, n_sel, elig_at, sh);
  const size_t base = static_cast<size_t>(s) * p.n_points
      + static_cast<size_t>(p.f_cap) * kKp;
  for (int k = tid; k < p.bg_keep; k += nt) {
    const int b = sh.picked[k];
    p.all_prev[2 * (base + k)] = pts[2 * b];
    p.all_prev[2 * (base + k) + 1] = pts[2 * b + 1];
    p.all_valid[base + k] = k < n_sel;
  }
}

__global__ void __launch_bounds__(kSelectThreads)
points_select_kernel(const Params p) {
  __shared__ Shared sh;
  if (static_cast<int>(blockIdx.x) < p.n_tracks)
    track_points(p, blockIdx.y, blockIdx.x, sh);
  else
    bg_points(p, blockIdx.y, sh);
}

}  // namespace

extern "C" {

// One call of the point assembly for ints[kStreams] streams: `ptrs` holds
// the Ptr enum's device pointers in its order, `ints` and `floats` the Int
// and Float enums' values. Two launches on `stream`: the owners, then the
// tracks' and the background's points, a programmatic dependent launch
// that starts beside the first. Returns 0 or the first cudaError_t.
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
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.n_tracks + 1, n_streams);
  cfg.blockDim = dim3(kSelectThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, points_select_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code gap_points_forward returned
const char* gap_points_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
