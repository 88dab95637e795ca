// The detectors' greedy NMS and the SSD's cross-tile merge for Hopper
// (sm_90a), each loop run to its end on the device, with no host sync.
//
// Replaces fastmot_tpu/ops/geometry.py:186 _greedy_suppress (a
// lax.while_loop of suppression waves, :224) as the JAX package's YOLO
// NMS (fastmot_tpu/detector.py nms_mask / diou_nms_mask through
// geometry.py) and the SSD's per-tile NMS run it, and the SSD merge's
// min-label propagation (fastmot_tpu/detector.py:490-511, a lax.while_loop
// to a fixpoint). Neither is a Pallas kernel: both are parts of the
// detectors' jitted XLA programs. Their plain PyTorch twins are
// greedy_suppress_reference in fastmot_tpu_torch/ops/geometry.py and
// merge_labels_reference in fastmot_tpu_torch/ops/nms_waves.py, which loop
// on the host and read a flag back once a wave or a round; the wrappers
// greedy_suppress (geometry.py) and merge_labels (nms_waves.py) check the
// arguments, allocate the outputs and call the C entries below.
//
// What bounds it on an H100: bytes, then latency. The NMS reads an N x N
// float32 overlap matrix (4 MB a problem at N = MAX_RAW = 1,024) once;
// after that a wave is a short chain of barriers over N bits a box. So
// the overlap is read by many blocks at once and kept as bits:
//
//   suppress_pack_kernel, a block a word of 32 rows and a problem: a
//     thread a column j reads the 32 rows' entries of its column
//     (neighbouring threads on neighbouring addresses) and writes the word
//     of `over` bits (overlap > thresh, off the diagonal) of those rows
//     for column j: bits[w][j] bit b = over[32 w + b][j]. The whole matrix
//     is read by N / 32 blocks a problem at once, not by one SM.
//   suppress_waves_kernel, a block a problem, behind the pack launch by a
//     programmatic dependent launch: the scores and the valid mask are
//     loaded while the pack launch runs, then the N x N / 32 words of bits
//     (128 KB at N = 1,024) into shared memory. A wave: each remaining
//     box j tests the remaining boxes that overlap it (its column's words
//     AND the remaining words), and is dominated if one of them comes
//     first in greedy order (a higher score, the lower index on ties:
//     `>` and `==` on the floats, so NaN dominates nothing, as in the
//     plain version); a box that is not dominated joins the wave; a
//     remaining box that a wave box overlaps is suppressed. The words of
//     the remaining, wave and kept boxes are ballots of a warp's lanes;
//     the loop ends on __syncthreads_or of "a box remains".
//   merge_labels_kernel, a block a problem: the edge relation as bits in
//     shared memory (a thread a word of 32 columns of a row, from two
//     16-byte loads), the labels (i for a valid row, n otherwise) in two
//     buffers; a round sets each label to the least of its own and its
//     neighbours', and the loop ends on __syncthreads_or of "a label
//     changed". The fixpoint does not depend on the order of the rounds,
//     so the result is the plain version's whatever the block size.
//
// The YOLO postprocess around the waves (nms_select_forward) replaces the
// rest of fastmot_tpu/detector.py:128 _nms_and_gate: the gates, the
// stable top K of 16,128 decoded rows, their DIoU within labels and the
// final order. Its plain twin is detector.nms_and_gate_reference. What
// bounds it is latency: chains of barriers over a few thousand keys on
// one SM. So the select runs on a cluster of up to 8 blocks a stream (a
// radix select of 11-, 11- and 10-bit digits whose counts are summed
// through distributed shared memory, one cluster barrier a pass); the K
// candidates are placed by rank counting (a key's place is the number of
// keys above it), not sorted; the DIoU and the greedy order are packed
// into dominance bits by many blocks, so that a wave tests a box with a
// few word operations; and the final order ranks by comparison only the
// boxes kept.
//
// The SSD postprocess (ssd_postprocess_forward) replaces the rest of
// fastmot_tpu/detector.py:435 SSDDetector._postprocess_device: the pixel
// boxes and gates, the per-tile NMS (a vmap of _greedy_suppress, :479) and
// the cross-tile IoM merge (:490-511) with its collapse and order. Its
// plain twin is detector.ssd_postprocess_reference. What bounds it is
// latency again, and the pairs: the per-tile NMS is 8 blocks' work, the
// merge one block's, whose M kept rows have M^2 pairs. So the NMS packs
// dominance bits from the boxes as nms_select does, and the merge tests
// only the pairs that a sweep along x leaves (the rows in buckets of
// their left edges by a counting sort), lists the edges it finds and
// joins their components by union-find, with no [n, n] relation in memory
// and no rounds.
//
// Every loop strides by blockDim.x and takes whole warps, so a block of 32
// or 64 threads computes what 1,024 compute (the tests' host build runs
// such blocks, and a cluster's blocks together: tests/cuda_host_shim.py).
// Nothing here rounds: the outputs are the plain versions' bit for bit by
// construction.

#include <cooperative_groups.h>
#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 1024;          // a problem's boxes (MAX_RAW)
constexpr int kMaxWords = kMaxN / 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
// a pack block's columns, 8 threads each
constexpr int kPackCols = 32;
constexpr int kPackThreads = 8 * kPackCols;
// the merge's sweep: the buckets of the kept rows' left edges
constexpr int kSweepBuckets = 256;
// the select launch's blocks a stream (a cluster) at most, and the rows a
// block takes before the cluster grows
constexpr int kSelectCluster = 8;
constexpr int kSelectRows = 256;
// the shared memory a select block may use with its keys in it (else they
// go to scratch, which the card does past 155,104 rows at K = 1,024 and 80
// labels): the file's one build option, which the host build of
// tests/test_torch_nms_select.py sets to 1 to reach the scratch path
#ifndef NMS_SELECT_SMEM_MAX
#define NMS_SELECT_SMEM_MAX (160 * 1024)
#endif

// greedy_suppress_forward's pointers and ints
enum SuppressPtr { kOverlap, kScores, kValid, kBits, kKeep };
enum SuppressInt { kProblems, kBoxes };
// merge_labels_forward's
enum MergePtr { kEdge, kMValid, kLabels };
enum MergeInt { kMProblems, kMRows };

struct SuppressParams {
  const float* overlap;        // [B, N, N]
  const float* scores;         // [B, N]
  const unsigned char* valid;  // [B, N]
  unsigned* bits;              // [B, W, N], written by the pack launch
  unsigned char* keep;         // [B, N], written
  int n, words;
  float thresh;
};

// nms_select_forward's pointers, ints and floats
enum SelectPtr { kDet, kLabelMask, kScaleWh, kOffset, kScratch, kOutTlbr,
                 kOutLabel, kOutConf, kOutValid };
enum SelectInt { kSStreams, kSCandidates, kSKeep, kSLabels, kSOut };
enum SelectFloat { kConfThresh, kNmsThresh, kMaxArea, kMinAr };

struct SelectParams {
  const float* det;                 // [B, N, 7] decoded rows
  const unsigned char* label_mask;  // [L]
  const float* scale_wh;            // [4]
  const float* offset;              // [2]
  // scratch (select_scratch_words): written by the launches
  unsigned* ord;                    // [B, N] the candidates' keys
  long long* c_label;               // [B, K] the selected, in order
  float* c_tlbr;                    // [B, K, 4]
  float* c_obj;                     // [B, K]
  float* c_cls;                     // [B, K]
  unsigned* bits;                   // [B, W, K]
  unsigned char* c_valid;           // [B, K]
  // outputs, [B, M] (and 4)
  float* out_tlbr;
  int* out_label;
  float* out_conf;
  unsigned char* out_valid;
  int n, k, words, labels, m;
  int keys_in_smem;                 // the select's keys in shared memory
  float conf_thresh, nms_thresh, max_area, min_ar;
};

// ssd_postprocess_forward's pointers, ints and floats
enum SsdPtr { kPDet, kPTiles, kPScale, kPMask, kPScratch, kPOutTlbr,
              kPOutLabel, kPOutConf, kPOutKeep };
enum SsdInt { kPTileCount, kPRows, kPLabels, kPOut };
enum SsdFloat { kPConfThresh, kPMaxArea, kPMergeThresh, kPNmsThresh };

struct MergeParams {
  const unsigned char* edge;   // [B, N, N]
  const unsigned char* valid;  // [B, N]
  long long* labels;           // [B, N], written
  int n, words;
};

// a launch's threads for n boxes or rows: whole warps, at most 1,024
inline int threads_for(int n) {
  const int t = (n + 31) / 32 * 32;
  return t < kMaxThreads ? t : kMaxThreads;
}

// box i comes before box j in greedy order
__device__ __forceinline__ bool dominates(const float* score, int i, int j) {
  return score[i] > score[j] || (score[i] == score[j] && i < j);
}

// the waves of one problem to their end, the whole block: `bits` [W][N]
// (bit b of bits[w][j]: box 32 w + b overlaps box j past the threshold;
// with kDominance, and comes before it in greedy order, so that a box
// joins a wave where no remaining box's bit is set in its column, and
// `score` is not read), `score` [N], and the words of the remaining (the
// valid boxes on entry), wave and kept boxes, the last two zero on entry;
// `kept` on return
template <bool kDominance>
__device__ void run_waves(const unsigned* smem_bits, const float* score,
                          unsigned* remaining, unsigned* wave,
                          unsigned* kept, int n, int nw) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int rounds = (n + nt - 1) / nt;   // every lane the same count
  for (;;) {
    int mine = 0;
    for (int j = tid; j < n; j += nt)
      mine |= (remaining[j >> 5] >> (j & 31)) & 1u;
    // a box remains (and every earlier write is visible)
    if (!__syncthreads_or(mine)) break;
    for (int k = 0; k < rounds; ++k) {
      const int j = k * nt + tid;
      bool in_wave = false;
      if (j < n && ((remaining[j >> 5] >> (j & 31)) & 1u)) {
        in_wave = true;
        if (kDominance) {
          unsigned any = 0;
          for (int w = 0; w < nw && !any; ++w)
            any |= smem_bits[w * n + j] & remaining[w];
          in_wave = any == 0;
        } else {
          for (int w = 0; w < nw && in_wave; ++w) {
            unsigned m = smem_bits[w * n + j] & remaining[w];
            while (m) {
              const int i = 32 * w + __ffs(static_cast<int>(m)) - 1;
              m &= m - 1;
              if (dominates(score, i, j)) {
                in_wave = false;
                break;
              }
            }
          }
        }
      }
      const unsigned v = __ballot_sync(kFull, in_wave);
      if (lane == 0 && j < n) wave[j >> 5] = v;
    }
    __syncthreads();   // the wave is whole
    for (int k = 0; k < rounds; ++k) {
      const int j = k * nt + tid;
      const int w0 = j >> 5;
      bool stays = false;
      if (j < n) {
        const bool rem = (remaining[w0] >> (j & 31)) & 1u;
        const bool in_wave = (wave[w0] >> (j & 31)) & 1u;
        stays = rem && !in_wave;
        for (int w = 0; w < nw && stays; ++w)
          if (smem_bits[w * n + j] & wave[w]) stays = false;
      }
      const unsigned v = __ballot_sync(kFull, stays);
      // a warp writes only its own words, which no other warp reads here
      if (lane == 0 && j < n) {
        kept[w0] |= wave[w0];
        remaining[w0] = v;
      }
    }
    __syncthreads();   // every read of the wave is done
    for (int w = tid; w < nw; w += nt) wave[w] = 0;
  }
}

// launch 1: the `over` bits of rows [32 w, 32 w + 32) for every column
__global__ void __launch_bounds__(kMaxThreads)
suppress_pack_kernel(const SuppressParams p) {
  // the waves launch may start now; it waits for this grid's end before
  // it reads the bits
  cudaTriggerProgrammaticLaunchCompletion();
  const int w = blockIdx.x, b = blockIdx.y, n = p.n;
  const float* ov = p.overlap + static_cast<size_t>(b) * n * n;
  unsigned* out = p.bits + (static_cast<size_t>(b) * p.words + w) * n;
  for (int j = threadIdx.x; j < n; j += blockDim.x) {
    unsigned word = 0;
    for (int r = 0; r < 32; ++r) {
      const int i = 32 * w + r;
      if (i < n && i != j && ov[static_cast<size_t>(i) * n + j] > p.thresh)
        word |= 1u << r;
    }
    out[j] = word;
  }
}

// launch 2: the waves of one problem
__global__ void __launch_bounds__(kMaxThreads)
suppress_waves_kernel(const SuppressParams p) {
  extern __shared__ unsigned smem_bits[];   // [W][N], then the scores
  __shared__ unsigned remaining[kMaxWords], wave[kMaxWords], kept[kMaxWords];
  const int b = blockIdx.x, n = p.n, nw = p.words;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  float* score = reinterpret_cast<float*>(smem_bits + nw * n);
  const size_t row = static_cast<size_t>(b) * n;
  // what the pack launch does not write, before waiting on it
  for (int j = tid; j < n; j += nt) score[j] = p.scores[row + j];
  const int rounds = (n + nt - 1) / nt;   // every lane the same count
  for (int k = 0; k < rounds; ++k) {
    const int j = k * nt + tid;
    const unsigned v = __ballot_sync(kFull, j < n && p.valid[row + j]);
    if (lane == 0 && j < n) {
      remaining[j >> 5] = v;
      wave[j >> 5] = 0;
      kept[j >> 5] = 0;
    }
  }
  cudaGridDependencySynchronize();
  const unsigned* bits = p.bits + static_cast<size_t>(b) * nw * n;
  for (int x = tid; x < nw * n; x += nt) smem_bits[x] = bits[x];
  __syncthreads();

  run_waves<false>(smem_bits, score, remaining, wave, kept, n, nw);
  for (int j = tid; j < n; j += nt)
    p.keep[row + j] = (kept[j >> 5] >> (j & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// The YOLO postprocess around the waves (nms_select_forward), three
// launches a call: the select on a cluster of blocks a stream, then the
// dominance bits on many blocks, then the waves and the order on a block a
// stream, each behind the last by a programmatic dependent launch
// ---------------------------------------------------------------------------

// the order of float x among floats as an unsigned (larger is later), -0
// taken as +0 (they compare equal)
__device__ __forceinline__ unsigned order_bits(float x) {
  unsigned u = __float_as_uint(x);
  if (u == 0x80000000u) u = 0;
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

// torch.maximum / torch.minimum: a NaN operand wins
__device__ __forceinline__ float nan_max(float a, float b) {
  return a != a ? a : (b != b ? b : (a > b ? a : b));
}
__device__ __forceinline__ float nan_min(float a, float b) {
  return a != a ? a : (b != b ? b : (a < b ? a : b));
}

// geometry.area of a tlbr box: (x2 - x1 + 1) (y2 - y1 + 1), 0 if either
// is not positive
__device__ __forceinline__ float box_area(const float* t) {
  const float w = (t[2] - t[0]) + 1.0f, h = (t[3] - t[1]) + 1.0f;
  return (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
}

// geometry.diou_matrix's entry [i][j] at beta 0.6, rounded step by step as
// its torch ops round on the card (powf is torch's CUDA pow)
__device__ float diou_entry(const float* a, float area_a, const float* c,
                           float area_c) {
  const float iw = (nan_min(a[2], c[2]) - nan_max(a[0], c[0])) + 1.0f;
  const float ih = (nan_min(a[3], c[3]) - nan_max(a[1], c[1])) + 1.0f;
  const float inter = (iw > 0.0f && ih > 0.0f) ? iw * ih : 0.0f;
  const float uni = (area_a + area_c) - inter;
  const float iou = inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
  const float dx = (a[0] + a[2]) * 0.5f - (c[0] + c[2]) * 0.5f;
  const float dy = (a[1] + a[3]) * 0.5f - (c[1] + c[3]) * 0.5f;
  const float d = dx * dx + dy * dy;
  const float ew = (nan_max(a[2], c[2]) - nan_min(a[0], c[0])) + 1.0f;
  const float eh = (nan_max(a[3], c[3]) - nan_min(a[1], c[1])) + 1.0f;
  float cc = ew * ew + eh * eh;
  cc = cc < 1e-12f ? 1e-12f : cc;
  return iou - powf(d / cc, 0.6f);
}

// the block's threads' exclusive count of `pred` in thread order, and its
// total (every thread gets it); `scan` [33] scratch: the warps' counts,
// then their exclusive sums and the total (by warp 0's shuffles)
__device__ int block_exclusive_count(bool pred, int* scan, int& total) {
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int warps = (static_cast<int>(blockDim.x) + 31) >> 5;
  const unsigned b = __ballot_sync(kFull, pred);
  __syncthreads();   // the last call's readers are done
  if (lane == 0) scan[warp] = __popc(b);
  __syncthreads();
  if (warp == 0) {
    const int c = lane < warps ? scan[lane] : 0;
    int inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += v;
    }
    if (lane < warps) scan[lane] = inc - c;
    if (lane == 31) scan[32] = inc;
  }
  __syncthreads();
  total = scan[32];
  return scan[warp] + __popc(b & ((1u << lane) - 1u));
}

// for each key x of xs[0, nx): the keys y of v[0, n) above it (y > x) or
// below it (y < x), added into out[0, nx) (zero on entry). A warp takes
// 128 of the keys (4 a lane) and a slice of v, its lanes reading one key
// of v at a time (a broadcast, which serves 128 comparisons); the whole
// block, whole warps
template <bool kAbove>
__device__ void count_keys(const unsigned long long* v, int n,
                           const unsigned long long* xs, int nx, int* out) {
  constexpr int kX = 4;   // keys a lane
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int warps = static_cast<int>(blockDim.x) >> 5;
  const int groups = (nx + 32 * kX - 1) / (32 * kX);
  const int parts = groups > 0 && warps / groups > 0 ? warps / groups : 1;
  for (int task = warp; task < groups * parts; task += warps) {
    const int g = task % groups, part = task / groups;
    unsigned long long x[kX];
    int c[kX];
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int at = (g * kX + i) * 32 + lane;
      x[i] = at < nx ? xs[at] : 0ull;
      c[i] = 0;
    }
    const int y0 = static_cast<int>(static_cast<long long>(n) * part / parts);
    const int y1 = static_cast<int>(static_cast<long long>(n) * (part + 1)
                                    / parts);
#pragma unroll 4
    for (int y = y0; y < y1; ++y) {
      const unsigned long long w = v[y];
#pragma unroll
      for (int i = 0; i < kX; ++i) c[i] += kAbove ? w > x[i] : w < x[i];
    }
#pragma unroll
    for (int i = 0; i < kX; ++i) {
      const int at = (g * kX + i) * 32 + lane;
      if (at < nx && c[i]) atomicAdd(&out[at], c[i]);
    }
  }
}

// the select's digits of the 32-bit score keys: 11, 11 and 10 bits from
// the top (the scores' sign, exponent and first mantissa bits in the
// first: few of its bins hold keys, and three passes always suffice)
constexpr int kPasses = 3;
constexpr int kBins = 2048;
constexpr int kLastBins = 1024;   // the last digit's
__device__ __forceinline__ int digit_shift(int q) {
  return q == 0 ? 21 : (q == 1 ? 10 : 0);
}
__device__ __forceinline__ int digit_width(int q) { return q == 2 ? 10 : 11; }
// the select's ints in shared memory: the digit found, the keys above its
// bin, its bin's keys, this block's selected keys
enum SelectVar { kDigit, kAbove, kBin, kMine, kVars = 8 };

// the digit of the K-th largest key among those counted in total[0, nb),
// the whole block: (the digit, the keys in larger digits, the keys in its
// bin) into vars. In descending digit order thread t holds `per`
// consecutive digits; a block scan of the threads' sums (warp shuffles,
// then warp 0 over the warps' sums in `scan` [32]) finds the one holding
// the need-th key
__device__ void find_digit(const int* total, int nb, int need, int* vars,
                           int* scan) {
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5, warps = (nt + 31) >> 5;
  const int per = (nb + nt - 1) / nt;
  int tot = 0;
  for (int q = 0; q < per; ++q) {
    const int at = tid * per + q;
    if (at < nb) tot += total[nb - 1 - at];
  }
  int inc = tot;
  for (int o = 1; o < 32; o <<= 1) {
    const int v = __shfl_up_sync(kFull, inc, o);
    if (lane >= o) inc += v;
  }
  __syncthreads();   // scan is free
  if (lane == 31) scan[warp] = inc;
  __syncthreads();
  if (warp == 0) {
    const int c = lane < warps ? scan[lane] : 0;
    int w_inc = c;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, w_inc, o);
      if (lane >= o) w_inc += v;
    }
    if (lane < warps) scan[lane] = w_inc - c;
  }
  __syncthreads();
  inc += scan[warp];
  int c = inc - tot;
  if (c < need && need <= inc) {
    for (int q = 0; q < per; ++q) {
      const int at = tid * per + q;
      const int cnt = total[nb - 1 - at];
      if (c + cnt >= need) {
        vars[kDigit] = nb - 1 - at;
        vars[kAbove] = c;
        vars[kBin] = cnt;
        break;
      }
      c += cnt;
    }
  }
}

// the select launch's dynamic shared memory, each block's own: the K
// selected keys of the stream (gathered), this block's selected keys, its
// histogram of a pass, the cluster's histogram of each pass (every block
// adds its counts into every block's), then the ranks of the block's share
// of the keys, the ints, a scan's scratch, the label mask, then (where
// they fit) the block's score keys
struct SelectSmem {
  unsigned long long* sel;
  unsigned long long* mine;
  int* hist;     // [kBins]
  int* total;    // [kPasses][kBins]
  int* byrank;   // [kSelectCluster][kLastBins] the last pass's by block
  int* place;    // [K]
  int* vars;     // [kVars]
  int* scan;     // [40]
  unsigned char* mask;
  unsigned* keys;
};

__host__ __device__ inline int round16(int bytes) {
  return (bytes + 15) / 16 * 16;
}

__host__ __device__ inline int select_smem_fixed(int k, int labels) {
  return 16 * k + 4 * ((1 + kPasses) * kBins + kSelectCluster * kLastBins
                       + k + kVars + 40)
      + round16(labels);
}

__device__ SelectSmem carve_select(void* base, int k, int labels) {
  SelectSmem m;
  m.sel = static_cast<unsigned long long*>(base);
  m.mine = m.sel + k;
  m.hist = reinterpret_cast<int*>(m.mine + k);
  m.total = m.hist + kBins;
  m.byrank = m.total + kPasses * kBins;
  m.place = m.byrank + kSelectCluster * kLastBins;
  m.vars = m.place + k;
  m.scan = m.vars + kVars;
  m.mask = reinterpret_cast<unsigned char*>(m.scan + 40);
  m.keys = reinterpret_cast<unsigned*>(m.mask + round16(labels));
  return m;
}

// launch 1: a cluster of C blocks a stream, block r the rows [r S, r S +
// S), S = ceil(N / C). Every candidate's score key: the order bits of its
// gated score (-1 where the confidence or label gate fails), so that a
// larger key comes first in torch's stable descending sort, the lower
// index first among equal keys. The K-th largest key by a radix select
// over the cluster: each pass the blocks count their keys' digits, the
// counts are summed through distributed shared memory (one cluster
// barrier a pass) and every block finds the same digit; the select stops
// where the digit's bin holds just the keys still wanted, or after the
// last digit, when the K-th key's equals are cut by index (an ordered
// count over the blocks). Each block's selected keys, with the
// complemented index below, are gathered into every block; each block
// ranks its share of them by counting the keys above each (count_keys),
// which is each key's place in the descending order, and writes those
// candidates' boxes in pixels, labels, scores and validity there
__global__ void __launch_bounds__(kMaxThreads)
nms_select_kernel(const SelectParams p) {
  // the pack launch may start now; it waits for this grid's end
  cudaTriggerProgrammaticLaunchCompletion();
  extern __shared__ unsigned long long smem_select[];
  cooperative_groups::cluster_group cluster =
      cooperative_groups::this_cluster();
  const int C = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int s = blockIdx.y, n = p.n, k = p.k;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  SelectSmem m = carve_select(smem_select, k, p.labels);
  const int slice = (n + C - 1) / C;
  const int r0 = rank * slice < n ? rank * slice : n;
  const int r1 = r0 + slice < n ? r0 + slice : n;
  if (!p.keys_in_smem) m.keys = p.ord + static_cast<size_t>(s) * n + r0;
  const float* det = p.det + static_cast<size_t>(s) * n * 7;
  const int rounds = (r1 - r0 + nt - 1) / nt;   // every lane the same count
  for (int x = tid; x < p.labels; x += nt) m.mask[x] = p.label_mask[x];
  for (int x = tid; x < (1 + kPasses) * kBins + kSelectCluster * kLastBins;
       x += nt)
    m.hist[x] = 0;
  if (tid < kVars) m.vars[tid] = 0;
  __syncthreads();
  for (int j = r0 + tid; j < r1; j += nt) {
    const float* d = det + static_cast<size_t>(j) * 7;
    const float score = d[4] * d[6];
    const long long label = static_cast<long long>(d[5]);
    const long long at = label < 0 ? 0
        : (label > p.labels - 1 ? p.labels - 1 : label);
    const bool keep = m.mask[at] && score >= p.conf_thresh;
    m.keys[j - r0] = order_bits(keep ? score : -1.0f);
  }
  __syncthreads();   // the keys are whole

  // the radix select of the K-th largest key
  unsigned prefix = 0, high = 0;
  int need = k, stop = 0, q = kPasses;
  if (n > k) {
    // every block's histograms are zero before any block adds to them
    cluster.sync();
    for (q = 0; q < kPasses; ++q) {
      const int shift = digit_shift(q), nb = 1 << digit_width(q);
      for (int r = 0; r < rounds; ++r) {
        const int j = r0 + r * nt + tid;
        const unsigned key = j < r1 ? m.keys[j - r0] : 0u;
        const bool in = j < r1 && (key & high) == prefix;
        const int digit = in ? static_cast<int>((key >> shift) & (nb - 1))
                             : -1;
        const unsigned same = __match_any_sync(kFull, digit);
        if (in && lane == __ffs(static_cast<int>(same)) - 1)
          atomicAdd(&m.hist[digit], __popc(same));
      }
      __syncthreads();
      // this block's counts into every block's histogram of the pass (the
      // last pass's by block, for the cut below)
      const bool last = q == kPasses - 1;
      int* total = m.total + q * kBins;
      for (int x = tid; x < nb; x += nt) {
        const int c = m.hist[x];
        if (c == 0) continue;
        m.hist[x] = 0;
        for (int b = 0; b < C; ++b) {
          if (last) {
            *cluster.map_shared_rank(m.byrank + rank * kLastBins + x, b) = c;
          } else {
            atomicAdd(cluster.map_shared_rank(total + x, b), c);
          }
        }
      }
      cluster.sync();   // every block's counts are in
      if (last) {
        for (int x = tid; x < nb; x += nt) {
          int c = 0;
          for (int b = 0; b < C; ++b) c += m.byrank[b * kLastBins + x];
          total[x] = c;
        }
        __syncthreads();
      }
      find_digit(total, nb, need, m.vars, m.scan);
      __syncthreads();
      prefix |= static_cast<unsigned>(m.vars[kDigit]) << shift;
      high |= static_cast<unsigned>(nb - 1) << shift;
      need -= m.vars[kAbove];
      stop = shift;
      if (m.vars[kBin] == need) break;   // the bin is wanted whole
    }
  }
  // past the last digit, the K-th key's equals are wanted up to `need`,
  // the lowest indices first: those in earlier blocks are counted first
  const bool cut = q == kPasses && n > k;
  int carry = 0;
  if (cut)
    for (int b = 0; b < rank; ++b)
      carry += m.byrank[b * kLastBins + (prefix & (kLastBins - 1))];
  // this block's selected keys, in no order
  for (int r = 0; r < rounds; ++r) {
    const int j = r0 + r * nt + tid;
    const unsigned key = j < r1 ? m.keys[j - r0] : 0u;
    bool take = j < r1;
    if (cut) {
      const bool eq = take && key == prefix;
      int all;
      const int before = block_exclusive_count(eq, m.scan, all);
      take = take && (key > prefix || (eq && carry + before < need));
      carry += all;
    } else if (n > k) {
      take = take && (key >> stop) >= (prefix >> stop);
    }
    const unsigned takers = __ballot_sync(kFull, take);
    int at = 0;
    if (lane == 0 && takers) at = atomicAdd(&m.vars[kMine], __popc(takers));
    at = __shfl_sync(kFull, at, 0);
    if (take)
      m.mine[at + __popc(takers & ((1u << lane) - 1u))] =
          (static_cast<unsigned long long>(key) << 32)
          | static_cast<unsigned>(~j);
  }
  __syncthreads();
  cluster.sync();   // every block's selected keys are compacted
  // every block gathers the stream's K keys, block by block
  int count[kSelectCluster];
#pragma unroll
  for (int b = 0; b < kSelectCluster; ++b)
    count[b] = b < C ? cluster.map_shared_rank(m.vars, b)[kMine] : 0;
  for (int x = tid; x < k; x += nt) {
    int b = 0, at = x;
    while (at >= count[b]) at -= count[b++];
    m.sel[x] = cluster.map_shared_rank(m.mine, b)[at];
  }
  __syncthreads();
  // each key of this block's share of sel: its place, the number of keys
  // above it (all are unique)
  const int q0 = static_cast<int>(static_cast<long long>(k) * rank / C);
  const int q1 = static_cast<int>(static_cast<long long>(k) * (rank + 1) / C);
  for (int x = tid; x < q1 - q0; x += nt) m.place[x] = 0;
  __syncthreads();
  count_keys<true>(m.sel, k, m.sel + q0, q1 - q0, m.place);
  __syncthreads();
  const size_t out0 = static_cast<size_t>(s) * k;
  for (int at = q0 + tid; at < q1; at += nt) {
    const int t = m.place[at - q0];
    const int j = static_cast<int>(~static_cast<unsigned>(m.sel[at]));
    const float* d = det + static_cast<size_t>(j) * 7;
    const float obj = d[4], cls = d[6];
    const float score = obj * cls;
    const long long label = static_cast<long long>(d[5]);
    const long long lab = label < 0 ? 0
        : (label > p.labels - 1 ? p.labels - 1 : label);
    const bool keep = m.mask[lab] && score >= p.conf_thresh;
    // pixels: xy = box * scale - offset, wh = box * scale; tlbr =
    // round(xy, xy + wh - 1)
    const float x = d[0] * p.scale_wh[0] - p.offset[0];
    const float y = d[1] * p.scale_wh[1] - p.offset[1];
    const float w = d[2] * p.scale_wh[2];
    const float h = d[3] * p.scale_wh[3];
    float* box = p.c_tlbr + (out0 + t) * 4;
    box[0] = rintf(x);
    box[1] = rintf(y);
    box[2] = rintf((x + w) - 1.0f);
    box[3] = rintf((y + h) - 1.0f);
    p.c_label[out0 + t] = label;
    p.c_obj[out0 + t] = obj;
    p.c_cls[out0 + t] = cls;
    p.c_valid[out0 + t] = (keep ? score : -1.0f) > 0.0f;
  }
  cluster.sync();   // no block leaves while another reads its memory
}

// diou_entry(a, c) > thresh, the quotients and the power only where the
// IoU exceeds it: the DIoU is the IoU less a power >= 0, so it exceeds no
// threshold the IoU does not (and a NaN IoU goes on to its NaN DIoU)
__device__ bool diou_exceeds(const float* a, float area_a, const float* c,
                             float area_c, float thresh) {
  const float iw = (nan_min(a[2], c[2]) - nan_max(a[0], c[0])) + 1.0f;
  const float ih = (nan_min(a[3], c[3]) - nan_max(a[1], c[1])) + 1.0f;
  const float inter = (iw > 0.0f && ih > 0.0f) ? iw * ih : 0.0f;
  const float uni = (area_a + area_c) - inter;
  const float iou = inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
  if (iou <= thresh) return false;
  return diou_entry(a, area_a, c, area_c) > thresh;
}

// launch 2: the dominance bits from the selected boxes, a block a word of
// 32 rows, kPackCols columns and a stream, a thread 4 rows of a column
// (the column's 8 threads' bits OR-ed in shared memory): bit r of word w
// of column j is set where box i = 32 w + r comes before box j in greedy
// order (a higher objectness, the lower place on ties) and overlaps it
// (the same label, DIoU past the threshold). Among the valid boxes, whose
// objectness is not NaN, the order is total, so a pair's overlap is the
// bit of whichever comes first, and the waves need no other
__global__ void __launch_bounds__(kMaxThreads)
nms_pack_boxes_kernel(const SelectParams p) {
  cudaTriggerProgrammaticLaunchCompletion();
  __shared__ float rows[32][4];
  __shared__ float row_area[32], row_obj[32];
  __shared__ long long row_label[32];
  __shared__ unsigned col_bits[kPackCols];
  const int k = p.k, col_blocks = (k + kPackCols - 1) / kPackCols;
  const int word = blockIdx.x / col_blocks, s = blockIdx.y;
  const int j0 = (blockIdx.x % col_blocks) * kPackCols;
  const int n_cols = k - j0 < kPackCols ? k - j0 : kPackCols;
  const int tid = threadIdx.x, nt = blockDim.x;
  const size_t base = static_cast<size_t>(s) * k;
  for (int c = tid; c < kPackCols; c += nt) col_bits[c] = 0;
  // the select launch's candidates
  cudaGridDependencySynchronize();
  if (tid < 32) {
    const int i = 32 * word + tid;
    if (i < k) {
      for (int q = 0; q < 4; ++q)
        rows[tid][q] = p.c_tlbr[(base + i) * 4 + q];
      row_area[tid] = box_area(rows[tid]);
      row_label[tid] = p.c_label[base + i];
      row_obj[tid] = p.c_obj[base + i];
    }
  }
  __syncthreads();
  for (int item = tid; item < 8 * n_cols; item += nt) {
    const int c = item / 8, r0 = 4 * (item % 8), j = j0 + c;
    float col[4];
    for (int q = 0; q < 4; ++q) col[q] = p.c_tlbr[(base + j) * 4 + q];
    const float col_area = box_area(col);
    const long long col_label = p.c_label[base + j];
    const float col_obj = p.c_obj[base + j];
    unsigned bits = 0;
    for (int r = r0; r < r0 + 4; ++r) {
      const int i = 32 * word + r;
      if (i < k && i != j && row_label[r] == col_label
          && (row_obj[r] > col_obj || (row_obj[r] == col_obj && i < j))
          && diou_exceeds(rows[r], row_area[r], col, col_area, p.nms_thresh))
        bits |= 1u << r;
    }
    if (bits) atomicOr(&col_bits[c], bits);
  }
  __syncthreads();
  unsigned* out = p.bits + (static_cast<size_t>(s) * p.words + word) * k;
  for (int c = tid; c < n_cols; c += nt) out[j0 + c] = col_bits[c];
}

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
#endif

// launch 3: a block a stream. The dominance bits staged by one bulk copy
// (cp.async.bulk on an mbarrier, issued before the validity is read) where
// the address and size allow, else by plain loads; the waves; the area and
// aspect-ratio gates; then the stable ascending order of label * 1e4 -
// score (infinity where a box is not kept) by ranks: a key's place is the
// number of keys before it, the order bits over the place. The keys of
// infinity (every box not kept) keep their places' order, so their ranks
// are a count; only the other keys are compared, with each other. The
// first M places written out
__global__ void __launch_bounds__(kMaxThreads)
nms_order_kernel(const SelectParams p) {
  extern __shared__ unsigned smem_bits[];   // [W][K] the dominance bits
  __shared__ unsigned remaining[kMaxWords], wave[kMaxWords], kept[kMaxWords];
  __shared__ unsigned hi[kMaxN];            // each place's order bits
  __shared__ unsigned long long fin[kMaxN]; // the keys not infinity
  __shared__ int below[kMaxN];               // the keys below each of them
  __shared__ unsigned char final_box[kMaxN];
  __shared__ int scan[33];
  __shared__ int n_fin, n_below;
  __shared__ unsigned long long bar;
  const int s = blockIdx.x, k = p.k, nw = p.words, m = p.m;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const size_t base = static_cast<size_t>(s) * k;
  const unsigned kInfBits = 0xFF800000u;    // order_bits(+inf)
  // the select and pack launches are done
  cudaGridDependencySynchronize();
  const unsigned* stream_bits = p.bits + static_cast<size_t>(s) * nw * k;
  const unsigned bytes = static_cast<unsigned>(nw) * k * 4u;
#if defined(__CUDA_ARCH__)
  const bool bulk = bytes % 16 == 0
      && (reinterpret_cast<uintptr_t>(stream_bits) & 15u) == 0;
  if (bulk && tid == 0) {
    const unsigned b = smem_addr(&bar);
    asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                 : "memory");
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
    asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                 :: "r"(b), "r"(bytes) : "memory");
    asm volatile(
        "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
        " [%0], [%1], %2, [%3];\n"
        :: "r"(smem_addr(smem_bits)), "l"(stream_bits), "r"(bytes), "r"(b)
        : "memory");
  }
  if (!bulk)
    for (int x = tid; x < nw * k; x += nt) smem_bits[x] = stream_bits[x];
#else
  for (int x = tid; x < nw * k; x += nt) smem_bits[x] = stream_bits[x];
#endif
  const int rounds = (k + nt - 1) / nt;   // every lane the same count
  for (int r = 0; r < rounds; ++r) {
    const int j = r * nt + tid;
    const unsigned v = __ballot_sync(kFull, j < k && p.c_valid[base + j]);
    if (lane == 0 && j < k) {
      remaining[j >> 5] = v;
      wave[j >> 5] = 0;
      kept[j >> 5] = 0;
    }
  }
  if (tid == 0) n_fin = n_below = 0;
  __syncthreads();   // (the mbarrier's init too)
#if defined(__CUDA_ARCH__)
  if (bulk) {
    const unsigned b = smem_addr(&bar);
    unsigned done = 0;
    while (!done)
      asm volatile(
          "{\n .reg .pred p;\n"
          " mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
          " selp.u32 %0, 1, 0, p;\n}\n"
          : "=r"(done) : "r"(b), "r"(0u) : "memory");
  }
#endif
  run_waves<true>(smem_bits, nullptr, remaining, wave, kept, k, nw);

  // each place's key: its order bits, infinity where the box is not final
  for (int t = tid; t < k; t += nt) {
    const float* box = p.c_tlbr + (base + t) * 4;
    const float w = (box[2] - box[0]) + 1.0f, h = (box[3] - box[1]) + 1.0f;
    const float area = (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
    const float ar = w > 0.0f ? h / w : 0.0f;
    const bool final = ((kept[t >> 5] >> (t & 31)) & 1u) && area > 0.0f
        && area <= p.max_area && ar >= p.min_ar;
    const float label_key = static_cast<float>(p.c_label[base + t]) * 1e4f;
    const float conf = p.c_obj[base + t] * p.c_cls[base + t];
    const unsigned bits = order_bits(
        final ? label_key - conf : __uint_as_float(0x7F800000u));
    final_box[t] = final;
    hi[t] = bits;
    if (bits != kInfBits) {
      fin[atomicAdd(&n_fin, 1)] =
          (static_cast<unsigned long long>(bits) << 32)
          | static_cast<unsigned>(t);
      if (bits < kInfBits) atomicAdd(&n_below, 1);
    }
  }
  __syncthreads();
  const size_t out0 = static_cast<size_t>(s) * m;
  auto write_out = [&](int r, int t) {
    for (int q = 0; q < 4; ++q)
      p.out_tlbr[(out0 + r) * 4 + q] = p.c_tlbr[(base + t) * 4 + q];
    p.out_label[out0 + r] = static_cast<int>(p.c_label[base + t]);
    p.out_conf[out0 + r] = p.c_obj[base + t] * p.c_cls[base + t];
    p.out_valid[out0 + r] = final_box[t];
  };
  // the keys of infinity: after every smaller key, in their places' order
  int carry = n_below;
  for (int r = 0; r < rounds; ++r) {
    const int t = r * nt + tid;
    const bool inf = t < k && hi[t] == kInfBits;
    int all;
    const int place = carry + block_exclusive_count(inf, scan, all);
    if (inf && place < m) write_out(place, t);
    carry += all;
  }
  const int n_inf = carry - n_below;
  // the others: the keys below them, and every key of infinity before a
  // key above infinity (a NaN's bits)
  const int n_f = n_fin;
  for (int x = tid; x < n_f; x += nt) below[x] = 0;
  __syncthreads();
  count_keys<false>(fin, n_f, fin, n_f, below);
  __syncthreads();
  for (int x = tid; x < n_f; x += nt) {
    const unsigned long long key = fin[x];
    const int place = below[x] + ((key >> 32) > kInfBits ? n_inf : 0);
    if (place < m) write_out(place, static_cast<int>(key & 0xFFFFFFFFu));
  }
}

// the least label of each row's component, a block a problem
__global__ void __launch_bounds__(kMaxThreads)
merge_labels_kernel(const MergeParams p) {
  extern __shared__ unsigned smem_edge[];   // [W][N], then two label rows
  const int b = blockIdx.x, n = p.n, nw = p.words;
  const int tid = threadIdx.x, nt = blockDim.x;
  int* lbl[2] = {reinterpret_cast<int*>(smem_edge + nw * n),
                 reinterpret_cast<int*>(smem_edge + nw * n) + n};
  const unsigned char* edge = p.edge + static_cast<size_t>(b) * n * n;
  const size_t row = static_cast<size_t>(b) * n;
  // a thread a (row, word): word w of row i holds edge[i][32 w + b] at
  // bit b, from two 16-byte loads where the rows allow them
  const bool vec = n % 16 == 0
      && (reinterpret_cast<uintptr_t>(edge) & 15u) == 0;
#pragma unroll 4
  for (int x = tid; x < n * nw; x += nt) {
    const int i = x / nw, w = x % nw, j0 = 32 * w;
    const unsigned char* row = edge + static_cast<size_t>(i) * n + j0;
    unsigned v = 0;
    if (vec && j0 + 32 <= n) {
      const uint4 a = reinterpret_cast<const uint4*>(row)[0];
      const uint4 b = reinterpret_cast<const uint4*>(row)[1];
      const unsigned q[8] = {a.x, a.y, a.z, a.w, b.x, b.y, b.z, b.w};
#pragma unroll
      for (int k = 0; k < 32; ++k)
        v |= static_cast<unsigned>(((q[k >> 2] >> (8 * (k & 3))) & 0xFFu)
                                   != 0) << k;
    } else {
      for (int k = 0; k < 32 && j0 + k < n; ++k)
        v |= static_cast<unsigned>(row[k] != 0) << k;
    }
    smem_edge[w * n + i] = v;
  }
  for (int i = tid; i < n; i += nt) lbl[0][i] = p.valid[row + i] ? i : n;
  int cur = 0;
  for (;;) {
    __syncthreads();   // the labels of the last round are whole
    int changed = 0;
    for (int i = tid; i < n; i += nt) {
      int least = lbl[cur][i];
      for (int w = 0; w < nw; ++w) {
        unsigned m = smem_edge[w * n + i];
        while (m) {
          const int j = 32 * w + __ffs(static_cast<int>(m)) - 1;
          m &= m - 1;
          const int l = lbl[cur][j];
          least = l < least ? l : least;
        }
      }
      changed |= least != lbl[cur][i];
      lbl[cur ^ 1][i] = least;
    }
    cur ^= 1;
    if (!__syncthreads_or(changed)) break;
  }
  for (int i = tid; i < n; i += nt) p.labels[row + i] = lbl[cur][i];
}

// ---------------------------------------------------------------------------
// The SSD postprocess (ssd_postprocess_forward), two launches a call: the
// per-tile NMS a block a tile, then the cross-tile merge and the order on
// one block, behind it by a programmatic dependent launch
// ---------------------------------------------------------------------------

struct SsdParams {
  const float* det;                 // [T, K, 7] decoded rows
  const float* tiles;               // [T, 4] tlbr in region pixels
  const float* scale;               // [2]
  const unsigned char* label_mask;  // [L]
  // scratch (ssd_scratch_words), written by the NMS launch: each row's
  // pixel box, conf, int label and validity after the NMS
  float* r_tlbr;                    // [n, 4]
  float* r_conf;                    // [n]
  int* r_label;                     // [n]
  unsigned char* r_valid;           // [n]
  // outputs, [M] (and 4)
  float* out_tlbr;
  int* out_label;
  float* out_conf;
  unsigned char* out_keep;
  int tiles_n, k, n, labels, m;
  float conf_thresh, max_area, merge_thresh, nms_thresh;
};

// geometry.bbox_ious' entry for boxes a and c, rounded step by step as its
// torch ops round (the +1 convention, 0 where they do not intersect)
__device__ __forceinline__ float iou_entry(const float* a, float area_a,
                                           const float* c, float area_c) {
  const float iw = (nan_min(a[2], c[2]) - nan_max(a[0], c[0])) + 1.0f;
  const float ih = (nan_min(a[3], c[3]) - nan_max(a[1], c[1])) + 1.0f;
  const float inter = (iw > 0.0f && ih > 0.0f) ? iw * ih : 0.0f;
  const float uni = (area_a + area_c) - inter;
  return inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
}

// geometry.iom_matrix's entry for boxes a and c at or above `thresh`: the
// intersection over the smaller area, 0 where that area is not positive;
// the quotient only where the boxes intersect
__device__ __forceinline__ bool iom_at_least(const float* a, float area_a,
                                             const float* c, float area_c,
                                             float thresh) {
  const float iw = (nan_min(a[2], c[2]) - nan_max(a[0], c[0])) + 1.0f;
  const float ih = (nan_min(a[3], c[3]) - nan_max(a[1], c[1])) + 1.0f;
  const float inter = (iw > 0.0f && ih > 0.0f) ? iw * ih : 0.0f;
  const float least = nan_min(area_a, area_c);
  if (!(inter > 0.0f && least > 0.0f)) return 0.0f >= thresh;
  return inter / least >= thresh;
}

// the NMS launch's dynamic shared memory for K rows a tile: the dominance
// bits [W][K], the boxes [K][4], the areas, the confs and the labels [K]
inline int ssd_nms_smem_bytes(int k) {
  return ((k + 31) / 32 * k + 7 * k) * static_cast<int>(sizeof(float));
}

// launch 1: a block a tile. A thread a row: the pixel box, rounded as the
// torch ops round (multiply, add, multiply, half to even), its area and
// the gates (the conf threshold, the label mask at the clamped label, 0 <
// area <= max_area). Then the dominance bits of the tile's valid rows
// straight from the boxes, a thread a quarter of a word of 32 rows and a
// column (OR-ed into the word in shared memory): bit r of word w of
// column j is set where row i = 32 w + r has j's label, comes before j in
// greedy order (a higher conf, the lower index on ties; NaN comes before
// nothing) and overlaps it past the NMS threshold. Among the valid rows,
// whose confs are not NaN, that order is total, so the waves need no
// other bits (run_waves<true>). Each row's box, conf, label and validity
// after the NMS go to scratch
__global__ void __launch_bounds__(kMaxThreads)
ssd_nms_kernel(const SsdParams p) {
  // the merge launch may start now; it waits for this grid's end
  cudaTriggerProgrammaticLaunchCompletion();
  extern __shared__ float smem_ssd_nms[];
  __shared__ unsigned remaining[kMaxWords], wave[kMaxWords], kept[kMaxWords];
  const int t = blockIdx.x, k = p.k, nw = (k + 31) / 32;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  unsigned* bits = reinterpret_cast<unsigned*>(smem_ssd_nms);
  float* box = smem_ssd_nms + nw * k;
  float* area = box + 4 * k;
  float* conf = area + k;
  int* label = reinterpret_cast<int*>(conf + k);
  const float* tile = p.tiles + 4 * t;
  const float tw = (tile[2] - tile[0]) + 1.0f, th = (tile[3] - tile[1]) + 1.0f;
  const float fx[4] = {tw, th, tw, th};
  const float off[4] = {tile[0], tile[1], tile[0], tile[1]};
  const float sc[4] = {p.scale[0], p.scale[1], p.scale[0], p.scale[1]};
  const int rounds = (k + nt - 1) / nt;   // every lane the same count
  for (int r = 0; r < rounds; ++r) {
    const int j = r * nt + tid;
    bool valid = false;
    if (j < k) {
      const float* d = p.det + (static_cast<size_t>(t) * k + j) * 7;
      float* b = box + 4 * j;
      for (int q = 0; q < 4; ++q) b[q] = rintf((d[3 + q] * fx[q] + off[q])
                                               * sc[q]);
      const int lab = static_cast<int>(d[1]);
      const int at = lab < 0 ? 0 : (lab > p.labels - 1 ? p.labels - 1 : lab);
      area[j] = box_area(b);
      conf[j] = d[2];
      label[j] = lab;
      valid = conf[j] >= p.conf_thresh && p.label_mask[at]
          && area[j] > 0.0f && area[j] <= p.max_area;
    }
    const unsigned v = __ballot_sync(kFull, valid);
    if (lane == 0 && j < k) {
      remaining[j >> 5] = v;
      wave[j >> 5] = 0;
      kept[j >> 5] = 0;
    }
  }
  __syncthreads();   // the rows are staged
  for (int x = tid; x < nw * k; x += nt) bits[x] = 0;
  __syncthreads();
  // a thread a quarter of a word (8 rows) and a column; the bits of a row
  // or a column that is not valid are never read
  for (int x = tid; x < 4 * nw * k; x += nt) {
    const int j = x % k, q = (x / k) % 4, w = x / (4 * k);
    unsigned word = 0;
    unsigned rows = (remaining[j >> 5] >> (j & 31)) & 1u
        ? remaining[w] & (0xFFu << (8 * q)) : 0u;
    while (rows) {
      const int i = 32 * w + __ffs(static_cast<int>(rows)) - 1;
      rows &= rows - 1;
      if (i != j && label[i] == label[j]
          && (conf[i] > conf[j] || (conf[i] == conf[j] && i < j))
          && iou_entry(box + 4 * i, area[i], box + 4 * j, area[j])
              > p.nms_thresh)
        word |= 1u << (i & 31);
    }
    if (word) atomicOr(&bits[w * k + j], word);
  }
  __syncthreads();   // the bits are whole
  run_waves<true>(bits, nullptr, remaining, wave, kept, k, nw);
  const size_t row0 = static_cast<size_t>(t) * k;
  for (int j = tid; j < k; j += nt) {
    for (int q = 0; q < 4; ++q) p.r_tlbr[(row0 + j) * 4 + q] = box[4 * j + q];
    p.r_conf[row0 + j] = conf[j];
    p.r_label[row0 + j] = label[j];
    p.r_valid[row0 + j] = (kept[j >> 5] >> (j & 31)) & 1u;
  }
}

// the merge launch's dynamic shared memory for n rows: a region that holds
// the kept rows (M <= n) in the order of their left edges (boxes [n][4],
// areas, tiles, labels, indices and their buckets' least left edges [n])
// and the edges found [6 n], then the collapse's five keys [n], then the
// order's keys and counts [n]; then the kept rows' boxes [n][4], areas,
// confs, labels, tiles, indices and union-find parents [n] and a flag a
// row [n]
__host__ __device__ inline int ssd_region_bytes(int n) {
  return round16(4 * 9 * n + 4 * 6 * n);
}

inline int ssd_merge_smem_bytes(int n) {
  return ssd_region_bytes(n) + 4 * 10 * n + round16(n);
}

// the root of x's tree (the least index of its component once every
// edge is joined); `parent` is changed by other threads meanwhile, each
// change pointing a root at a lesser root
__device__ __forceinline__ int uf_find(volatile int* parent, int x) {
  for (int p = parent[x]; p != x; p = parent[x]) x = p;
  return x;
}

// joins the trees of a and b: the greater root is pointed at the lesser
// by a compare-and-swap that holds only while it is still a root
__device__ void uf_unite(volatile int* parent, int a, int b) {
  for (;;) {
    a = uf_find(parent, a);
    b = uf_find(parent, b);
    if (a == b) return;
    if (a > b) {
      const int c = a;
      a = b;
      b = c;
    }
    if (atomicCAS(const_cast<int*>(parent + b), b, a) == b) return;
  }
}

// the order bits of x with the row below (the least row first among equal
// values when the largest key is taken) or its complement
__device__ __forceinline__ unsigned long long min_key(float x, int a) {
  return ~((static_cast<unsigned long long>(order_bits(x)) << 32)
           | static_cast<unsigned>(a));
}
__device__ __forceinline__ unsigned long long max_key(float x, int a) {
  return (static_cast<unsigned long long>(order_bits(x)) << 32)
      | static_cast<unsigned>(~a);
}
__device__ __forceinline__ int min_row(unsigned long long key) {
  return static_cast<int>(static_cast<unsigned>(~key));
}
__device__ __forceinline__ int max_row(unsigned long long key) {
  return static_cast<int>(~static_cast<unsigned>(key));
}

// launch 2: one block. The rows the NMS kept, compacted in index order
// (their places by the block's count), then copied in the order of their
// left edges' buckets (a counting sort, each bucket's least left edge
// beside its rows). A sweep along x tests each pair once, a warp a row
// against the rows after it up to the first bucket that starts right of
// its box (a pair whose IoM passes a positive threshold intersects, and
// no row of a later bucket can), and lists each edge
// (another tile, the same label, IoM at or above the merge threshold);
// then a thread an edge joins their components by union-find that points
// the greater root at the lesser (an edge past the list's room is joined
// where it is found): each component's root is its
// least member, the fixpoint of the plain version's min-label rounds,
// whatever the order of the joins. Each component is collapsed onto that
// member by 64-bit atomic maxima of keys that order the values and, among
// equal values, put the least row first, which is the member a
// scatter_reduce in index order keeps (the sign of a zero included): the
// least top-left, the greatest bottom-right and the greatest conf, +0
// where none is above 0. The kept rows are placed by counting the float
// keys label * n + index (rounded as the torch ops round) below each
// (count_keys), the others after them in index order; the first M places
// written out
__global__ void __launch_bounds__(kMaxThreads)
ssd_merge_kernel(const SsdParams p) {
  extern __shared__ unsigned long long smem_ssd_merge[];
  __shared__ int scan[33];
  __shared__ int n_edges;
  __shared__ unsigned key_lo, key_hi;   // the kept rows' left edges' range
  __shared__ int bucket_at[kSweepBuckets];
  __shared__ unsigned bucket_lo[kSweepBuckets];
  const int n = p.n, m = p.m;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  unsigned char* region = reinterpret_cast<unsigned char*>(smem_ssd_merge);
  // the kept rows in the order of their left edges' buckets
  float* s_box = reinterpret_cast<float*>(region);   // [n][4]
  float* s_area = s_box + 4 * n;
  int* s_tile = reinterpret_cast<int*>(s_area + n);
  int* s_label = s_tile + n;
  int* s_row = s_label + n;
  unsigned* s_lo = reinterpret_cast<unsigned*>(s_row + n);
  unsigned* edges = s_lo + n;   // [6 n]
  const int edge_cap = 6 * n;
  unsigned long long* keys = smem_ssd_merge;   // [5][n]
  unsigned long long* fin = smem_ssd_merge;    // [n] the order's keys
  int* below = reinterpret_cast<int*>(fin + n);
  float* box = reinterpret_cast<float*>(region + ssd_region_bytes(n));
  float* area = box + 4 * n;
  float* conf = area + n;
  int* label = reinterpret_cast<int*>(conf + n);
  int* tile = label + n;
  int* row = tile + n;
  int* lbl = row + n;
  unsigned char* keep = reinterpret_cast<unsigned char*>(lbl + n);
  // the NMS launch's rows
  cudaGridDependencySynchronize();
  const int rounds = (n + nt - 1) / nt;   // every lane the same count
  int kept = 0;
  if (tid == 0) {
    n_edges = 0;
    key_lo = 0xFFFFFFFFu;
    key_hi = 0;
  }
  for (int x = tid; x < kSweepBuckets; x += nt) {
    bucket_at[x] = 0;
    bucket_lo[x] = 0xFFFFFFFFu;
  }
  for (int r = 0; r < rounds; ++r) {
    const int i = r * nt + tid;
    const bool valid = i < n && p.r_valid[i];
    int all;
    const int at = kept + block_exclusive_count(valid, scan, all);
    if (i < n) keep[i] = 0;
    if (valid) {
      for (int q = 0; q < 4; ++q) box[4 * at + q] = p.r_tlbr[4 * i + q];
      area[at] = box_area(box + 4 * at);
      conf[at] = p.r_conf[i];
      label[at] = p.r_label[i];
      tile[at] = i / p.k;
      row[at] = i;
      lbl[at] = at;
      const unsigned key = order_bits(box[4 * at]);
      atomicMin(&key_lo, key);
      atomicMax(&key_hi, key);
    }
    kept += all;
  }
  const int M = kept;
  __syncthreads();   // the kept rows are staged
  // a counting sort of the rows by bucket of their left edges' order
  // bits (a bucket a monotone function of them), each bucket's least key
  // beside it
  const unsigned long long span = static_cast<unsigned long long>(key_hi)
      - key_lo + 1;
  for (int a = tid; a < M; a += nt) {
    const unsigned key = order_bits(box[4 * a]);
    const int b = static_cast<int>((key - key_lo) * static_cast<
        unsigned long long>(kSweepBuckets) / span);
    atomicAdd(&bucket_at[b], 1);
    atomicMin(&bucket_lo[b], key);
  }
  __syncthreads();
  if (tid < 32) {   // the buckets' starts: a warp's scan of their counts
    constexpr int kPer = kSweepBuckets / 32;
    int c[kPer], sum = 0;
    for (int q = 0; q < kPer; ++q) {
      c[q] = bucket_at[kPer * lane + q];
      sum += c[q];
    }
    int inc = sum;
    for (int o = 1; o < 32; o <<= 1) {
      const int v = __shfl_up_sync(kFull, inc, o);
      if (lane >= o) inc += v;
    }
    int at = inc - sum;
    for (int q = 0; q < kPer; ++q) {
      bucket_at[kPer * lane + q] = at;
      at += c[q];
    }
  }
  __syncthreads();
  for (int a = tid; a < M; a += nt) {
    const unsigned key = order_bits(box[4 * a]);
    const int b = static_cast<int>((key - key_lo) * static_cast<
        unsigned long long>(kSweepBuckets) / span);
    const int at = atomicAdd(&bucket_at[b], 1);
    for (int q = 0; q < 4; ++q) s_box[4 * at + q] = box[4 * a + q];
    s_area[at] = area[a];
    s_tile[at] = tile[a];
    s_label[at] = label[a];
    s_row[at] = a;
    s_lo[at] = bucket_lo[b];
  }
  __syncthreads();   // the rows in the order of their left edges' buckets
  // a warp a row (neighbouring rows, whose edges join the same
  // components, on different warps), its lanes on the rows after it until
  // a bucket starts right of its box
  volatile int* parent = lbl;
  const bool sweep = p.merge_thresh > 0.0f;
  for (int s = tid >> 5; s < M; s += nt >> 5) {
    const float* ba = s_box + 4 * s;
    const float area_a = s_area[s];
    const int tile_a = s_tile[s], label_a = s_label[s], a = s_row[s];
    const unsigned reach = order_bits(ba[2] + 1.0f);
    for (int t0 = s + 1; t0 < M; t0 += 32) {
      const int t = t0 + lane;
      const bool past = t < M && sweep && s_lo[t] > reach;
      if (t < M && !past && s_tile[t] != tile_a && s_label[t] == label_a
          && iom_at_least(ba, area_a, s_box + 4 * t, s_area[t],
                          p.merge_thresh)) {
        const int b = s_row[t];
        const int at = atomicAdd(&n_edges, 1);
        if (at < edge_cap) edges[at] = (static_cast<unsigned>(a) << 16) | b;
        else uf_unite(parent, a, b);
      }
      if (__ballot_sync(kFull, past)) break;
    }
  }
  __syncthreads();   // every edge is listed
  const int listed = n_edges < edge_cap ? n_edges : edge_cap;
  for (int e = tid; e < listed; e += nt)
    uf_unite(parent, static_cast<int>(edges[e] >> 16),
             static_cast<int>(edges[e] & 0xFFFFu));
  __syncthreads();   // every edge is joined
  for (int a = tid; a < M; a += nt) parent[a] = uf_find(parent, a);
  __syncthreads();   // each row's label is its component's least member
  // the collapse
  for (int x = tid; x < 5 * M; x += nt) keys[(x / M) * n + x % M] = 0;
  __syncthreads();
  for (int a = tid; a < M; a += nt) {
    const int c = lbl[a];
    const float* b = box + 4 * a;
    atomicMax(&keys[c], min_key(b[0], a));
    atomicMax(&keys[n + c], min_key(b[1], a));
    atomicMax(&keys[2 * n + c], max_key(b[2], a));
    atomicMax(&keys[3 * n + c], max_key(b[3], a));
    atomicMax(&keys[4 * n + c], max_key(conf[a], a));
  }
  __syncthreads();   // every member's keys are in
  // a component's values, read from its members' rows, replace its least
  // member's own (no other component reads that row)
  for (int a = tid; a < M; a += nt) {
    if (lbl[a] != a) continue;
    const float x1 = box[4 * min_row(keys[a])];
    const float y1 = box[4 * min_row(keys[n + a]) + 1];
    const float x2 = box[4 * max_row(keys[2 * n + a]) + 2];
    const float y2 = box[4 * max_row(keys[3 * n + a]) + 3];
    const float c = conf[max_row(keys[4 * n + a])];
    box[4 * a] = x1;
    box[4 * a + 1] = y1;
    box[4 * a + 2] = x2;
    box[4 * a + 3] = y2;
    conf[a] = c > 0.0f ? c : 0.0f;
    keep[row[a]] = 1;
  }
  // the kept rows' order keys, compacted in row order
  const int reps_rounds = (M + nt - 1) / nt;   // every lane the same count
  int reps = 0;
  for (int r = 0; r < reps_rounds; ++r) {
    const int a = r * nt + tid;
    const bool rep = a < M && lbl[a] == a;
    int all;
    const int at = reps + block_exclusive_count(rep, scan, all);
    if (rep) {
      const float key = static_cast<float>(label[a]) * static_cast<float>(n)
          + static_cast<float>(row[a]);
      fin[at] = (static_cast<unsigned long long>(order_bits(key)) << 32)
          | static_cast<unsigned>(a);
    }
    reps += all;
  }
  for (int x = tid; x < reps; x += nt) below[x] = 0;
  __syncthreads();
  count_keys<false>(fin, reps, fin, reps, below);
  __syncthreads();
  for (int x = tid; x < reps; x += nt) {
    const int at = below[x];
    if (at >= m) continue;
    const int a = static_cast<int>(fin[x] & 0xFFFFFFFFu);
    for (int q = 0; q < 4; ++q) p.out_tlbr[4 * at + q] = box[4 * a + q];
    p.out_label[at] = label[a];
    p.out_conf[at] = conf[a];
    p.out_keep[at] = 1;
  }
  // the other rows after them, in index order
  int carry = reps;
  for (int r = 0; r < rounds; ++r) {
    const int i = r * nt + tid;
    const bool rest = i < n && !keep[i];
    int all;
    const int at = carry + block_exclusive_count(rest, scan, all);
    if (rest && at < m) {
      for (int q = 0; q < 4; ++q) p.out_tlbr[4 * at + q] = 0.0f;
      p.out_label[at] = p.r_label[i];
      p.out_conf[at] = 0.0f;
      p.out_keep[at] = 0;
    }
    carry += all;
  }
}

// the bytes of the waves launch's and the merge's dynamic shared memory
// for n boxes or rows: the bits, then the scores or the two label rows
inline int suppress_smem_bytes(int n) {
  return ((n + 31) / 32 * n + n) * static_cast<int>(sizeof(unsigned));
}

// the scratch of nms_select_forward in 4-byte words, and its pieces'
// offsets: the keys [B, N], then (at an even word) the labels [B, K]
// int64, the boxes [B, K, 4], the two scores [B, K] each, the bits [B, W,
// K] and the validity [B, K] bytes
struct SelectLayout {
  size_t label, tlbr, obj, cls, bits, valid, words;
};

inline SelectLayout select_layout(int b, int n, int k) {
  const size_t bk = static_cast<size_t>(b) * k;
  SelectLayout l;
  l.label = (static_cast<size_t>(b) * n + 1) / 2 * 2;
  l.tlbr = l.label + 2 * bk;
  l.obj = l.tlbr + 4 * bk;
  l.cls = l.obj + bk;
  l.bits = l.cls + bk;
  l.valid = l.bits + static_cast<size_t>((k + 31) / 32) * bk;
  l.words = l.valid + (bk + 3) / 4;
  return l;
}

inline int merge_smem_bytes(int n) {
  return ((n + 31) / 32 * n + 2 * n) * static_cast<int>(sizeof(unsigned));
}

}  // namespace

extern "C" {

// One call of the greedy NMS for ints[kProblems] problems of ints[kBoxes]
// boxes: `ptrs` holds the SuppressPtr enum's pointers (the bits the
// scratch of [B, ceil(N / 32), N] words), floats[0] the threshold. Two
// launches on `stream`, the second behind the first by a programmatic
// dependent launch. Returns 0 or the first cudaError_t.
int greedy_suppress_forward(const void* const* ptrs, const int* ints,
                            const float* floats, void* stream) {
  SuppressParams p = {};
  const int n_problems = ints[kProblems];
  p.n = ints[kBoxes];
  p.words = (p.n + 31) / 32;
  p.thresh = floats[0];
  if (n_problems < 1 || n_problems > 65535 || p.n < 1 || p.n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k <= kKeep; ++k)
    if (!ptrs[k]) return static_cast<int>(cudaErrorInvalidValue);
  p.overlap = static_cast<const float*>(ptrs[kOverlap]);
  p.scores = static_cast<const float*>(ptrs[kScores]);
  p.valid = static_cast<const unsigned char*>(ptrs[kValid]);
  p.bits = static_cast<unsigned*>(const_cast<void*>(ptrs[kBits]));
  p.keep = static_cast<unsigned char*>(const_cast<void*>(ptrs[kKeep]));
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(p.n);
  const dim3 pack_grid(p.words, n_problems);
  suppress_pack_kernel<<<pack_grid, threads, 0, st>>>(p);
  cudaError_t e = cudaGetLastError();
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = suppress_smem_bytes(p.n);
  e = cudaFuncSetAttribute(suppress_waves_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_problems);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = st;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, suppress_waves_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// One call of the merge's label propagation for ints[kMProblems] problems
// of ints[kMRows] rows: `ptrs` holds the MergePtr enum's pointers. One
// launch on `stream`. Returns 0 or the first cudaError_t.
int merge_labels_forward(const void* const* ptrs, const int* ints,
                         void* stream) {
  MergeParams p = {};
  const int n_problems = ints[kMProblems];
  p.n = ints[kMRows];
  p.words = (p.n + 31) / 32;
  if (n_problems < 1 || n_problems > 65535 || p.n < 1 || p.n > kMaxN)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k <= kLabels; ++k)
    if (!ptrs[k]) return static_cast<int>(cudaErrorInvalidValue);
  p.edge = static_cast<const unsigned char*>(ptrs[kEdge]);
  p.valid = static_cast<const unsigned char*>(ptrs[kMValid]);
  p.labels = static_cast<long long*>(const_cast<void*>(ptrs[kLabels]));
  const int smem = merge_smem_bytes(p.n);
  cudaError_t e = cudaFuncSetAttribute(
      merge_labels_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const int threads = threads_for(p.n);
  const dim3 grid(n_problems);
  merge_labels_kernel<<<grid, threads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The scratch words nms_select_forward takes for b streams of n
// candidates of which k enter the NMS
size_t nms_select_scratch_words(int b, int n, int k) {
  return select_layout(b, n, k).words;
}

// One call of the YOLO postprocess after the head decode for
// ints[kSStreams] streams of ints[kSCandidates] decoded rows: the gates
// and the pixel boxes, the stable top ints[kSKeep] by score, their DIoU
// NMS within labels, the area and aspect-ratio gates and the first
// ints[kSOut] in the order of label, then score. `ptrs` holds the
// SelectPtr enum's pointers (the scratch nms_select_scratch_words' words),
// floats the thresholds. Three launches on `stream`, each behind the last
// by a programmatic dependent launch. Returns 0 or the first cudaError_t.
int nms_select_forward(const void* const* ptrs, const int* ints,
                       const float* floats, void* stream) {
  SelectParams p = {};
  const int n_streams = ints[kSStreams];
  p.n = ints[kSCandidates];
  p.k = ints[kSKeep];
  p.labels = ints[kSLabels];
  p.m = ints[kSOut];
  p.words = (p.k + 31) / 32;
  p.conf_thresh = floats[kConfThresh];
  p.nms_thresh = floats[kNmsThresh];
  p.max_area = floats[kMaxArea];
  p.min_ar = floats[kMinAr];
  if (n_streams < 1 || n_streams > 65535 || p.n < 1 || p.k < 1
      || p.k > kMaxN || p.k > p.n || p.labels < 1 || p.m < 1 || p.m > p.k)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q <= kOutValid; ++q)
    if (!ptrs[q]) return static_cast<int>(cudaErrorInvalidValue);
  p.det = static_cast<const float*>(ptrs[kDet]);
  p.label_mask = static_cast<const unsigned char*>(ptrs[kLabelMask]);
  p.scale_wh = static_cast<const float*>(ptrs[kScaleWh]);
  p.offset = static_cast<const float*>(ptrs[kOffset]);
  unsigned* scratch = static_cast<unsigned*>(const_cast<void*>(ptrs[kScratch]));
  const SelectLayout l = select_layout(n_streams, p.n, p.k);
  p.ord = scratch;
  p.c_label = reinterpret_cast<long long*>(scratch + l.label);
  p.c_tlbr = reinterpret_cast<float*>(scratch + l.tlbr);
  p.c_obj = reinterpret_cast<float*>(scratch + l.obj);
  p.c_cls = reinterpret_cast<float*>(scratch + l.cls);
  p.bits = scratch + l.bits;
  p.c_valid = reinterpret_cast<unsigned char*>(scratch + l.valid);
  p.out_tlbr = static_cast<float*>(const_cast<void*>(ptrs[kOutTlbr]));
  p.out_label = static_cast<int*>(const_cast<void*>(ptrs[kOutLabel]));
  p.out_conf = static_cast<float*>(const_cast<void*>(ptrs[kOutConf]));
  p.out_valid = static_cast<unsigned char*>(const_cast<void*>(ptrs[kOutValid]));
  // the select's cluster: a block a kSelectRows rows, at most
  // kSelectCluster; its keys in shared memory where they fit
  const int blocks = (p.n + kSelectRows - 1) / kSelectRows;
  const int cluster = blocks < kSelectCluster ? blocks : kSelectCluster;
  const int slice = (p.n + cluster - 1) / cluster;
  const int fixed = select_smem_fixed(p.k, p.labels);
  p.keys_in_smem = fixed + 4 * slice <= NMS_SELECT_SMEM_MAX;
  const int select_smem = fixed + (p.keys_in_smem ? 4 * slice : 0);
  cudaError_t e = cudaFuncSetAttribute(
      nms_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      select_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute cluster_attr[1];
  cluster_attr[0].id = cudaLaunchAttributeClusterDimension;
  cluster_attr[0].val.clusterDim.x = cluster;
  cluster_attr[0].val.clusterDim.y = 1;
  cluster_attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(cluster, n_streams);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = select_smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = cluster_attr;   // the first launch waits for the stream's work
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_select_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.gridDim = dim3(p.words * ((p.k + kPackCols - 1) / kPackCols),
                     n_streams);
  cfg.blockDim = dim3(kPackThreads);
  cfg.dynamicSmemBytes = 0;
  e = cudaLaunchKernelEx(&cfg, nms_pack_boxes_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = p.words * p.k * static_cast<int>(sizeof(unsigned));
  e = cudaFuncSetAttribute(nms_order_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(n_streams);
  cfg.blockDim = dim3(threads_for(p.k));
  cfg.dynamicSmemBytes = smem;
  e = cudaLaunchKernelEx(&cfg, nms_order_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The scratch words ssd_postprocess_forward takes for n rows: each row's
// pixel box, conf and int label, then its validity bytes
size_t ssd_postprocess_scratch_words(int n) {
  return 6 * static_cast<size_t>(n) + (n + 3) / 4;
}

// One call of the SSD postprocess after the head decode for
// ints[kPTileCount] tiles of ints[kPRows] decoded rows (n = tiles x rows,
// at most kMaxN): the pixel boxes and gates, the per-tile class-aware NMS,
// the cross-tile IoM merge and the first ints[kPOut] (at most n) rows in
// the order of label, then index, the merged rows first. `ptrs` holds the
// SsdPtr enum's pointers (the scratch ssd_postprocess_scratch_words'
// words), floats the thresholds (the NMS threshold in [0, 1], so that no
// pair of different tiles or labels, whose overlap is 0, exceeds it). Two
// launches on `stream`, the second behind the first by a programmatic
// dependent launch. Returns 0 or the first cudaError_t.
int ssd_postprocess_forward(const void* const* ptrs, const int* ints,
                            const float* floats, void* stream) {
  SsdParams p = {};
  p.tiles_n = ints[kPTileCount];
  p.k = ints[kPRows];
  p.labels = ints[kPLabels];
  p.m = ints[kPOut];
  p.conf_thresh = floats[kPConfThresh];
  p.max_area = floats[kPMaxArea];
  p.merge_thresh = floats[kPMergeThresh];
  p.nms_thresh = floats[kPNmsThresh];
  if (p.tiles_n < 1 || p.k < 1 || p.tiles_n > kMaxN / p.k || p.labels < 1
      || !(p.nms_thresh >= 0.0f && p.nms_thresh <= 1.0f))
    return static_cast<int>(cudaErrorInvalidValue);
  p.n = p.tiles_n * p.k;
  if (p.m < 1 || p.m > p.n) return static_cast<int>(cudaErrorInvalidValue);
  for (int q = 0; q <= kPOutKeep; ++q)
    if (!ptrs[q]) return static_cast<int>(cudaErrorInvalidValue);
  p.det = static_cast<const float*>(ptrs[kPDet]);
  p.tiles = static_cast<const float*>(ptrs[kPTiles]);
  p.scale = static_cast<const float*>(ptrs[kPScale]);
  p.label_mask = static_cast<const unsigned char*>(ptrs[kPMask]);
  float* scratch = static_cast<float*>(const_cast<void*>(ptrs[kPScratch]));
  p.r_tlbr = scratch;
  p.r_conf = scratch + 4 * p.n;
  p.r_label = reinterpret_cast<int*>(scratch + 5 * p.n);
  p.r_valid = reinterpret_cast<unsigned char*>(scratch + 6 * p.n);
  p.out_tlbr = static_cast<float*>(const_cast<void*>(ptrs[kPOutTlbr]));
  p.out_label = static_cast<int*>(const_cast<void*>(ptrs[kPOutLabel]));
  p.out_conf = static_cast<float*>(const_cast<void*>(ptrs[kPOutConf]));
  p.out_keep = static_cast<unsigned char*>(const_cast<void*>(ptrs[kPOutKeep]));
  const int nms_smem = ssd_nms_smem_bytes(p.k);
  cudaError_t e = cudaFuncSetAttribute(
      ssd_nms_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, nms_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int merge_smem = ssd_merge_smem_bytes(p.n);
  e = cudaFuncSetAttribute(ssd_merge_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize,
                           merge_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(p.tiles_n);
  cfg.blockDim = dim3(threads_for(4 * ((p.k + 31) / 32) * p.k));
  cfg.dynamicSmemBytes = nms_smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  e = cudaLaunchKernelEx(&cfg, ssd_nms_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  cfg.gridDim = dim3(1);
  cfg.blockDim = dim3(kMaxThreads);   // the sweep's rows over every warp
  cfg.dynamicSmemBytes = merge_smem;
  e = cudaLaunchKernelEx(&cfg, ssd_merge_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code an entry returned
const char* nms_waves_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
