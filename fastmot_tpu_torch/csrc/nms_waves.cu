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
// Every loop strides by blockDim.x and takes whole warps, so a block of 32
// or 64 threads computes what 1,024 compute (the tests' host build runs
// such blocks). Nothing here rounds: the outputs are the plain versions'
// bit for bit by construction.

#include <cuda_runtime.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 1024;          // a problem's boxes (MAX_RAW)
constexpr int kMaxWords = kMaxN / 32;
constexpr int kMaxThreads = 1024;
constexpr unsigned kFull = 0xFFFFFFFFu;
constexpr int kRadixBins = 256;
constexpr int kPackCols = 256;       // a pack block's columns
// the shared memory a select block may stage its keys in
constexpr int kSelectSmemMax = 160 * 1024;

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
// (bit b of bits[w][j]: box 32 w + b overlaps box j past the threshold),
// `score` [N], and the words of the remaining (the valid boxes on entry),
// wave and kept boxes, the last two zero on entry; `kept` on return
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

  run_waves(smem_bits, score, remaining, wave, kept, n, nw);
  for (int j = tid; j < n; j += nt)
    p.keep[row + j] = (kept[j >> 5] >> (j & 31)) & 1u;
}

// ---------------------------------------------------------------------------
// The YOLO postprocess around the waves (nms_select_forward), three
// launches a call, each behind the last by a programmatic dependent launch
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

// sorts v[0 .. n) (n a power of two) by a bitonic network, the whole
// block: ascending, or descending. A step's pairs 32 or more apart swap in
// shared memory between barriers; the steps below 32 of a stage run in a
// warp's registers by shuffles (the block's thread count a multiple of 32,
// so a pair lies in one warp)
__device__ void bitonic_sort(unsigned long long* v, int n, bool descending) {
  const int tid = threadIdx.x, nt = blockDim.x;
  for (int size = 2; size <= n; size <<= 1) {
    int stride = size >> 1;
    for (; stride >= 32; stride >>= 1) {
      __syncthreads();
      for (int i = tid; i < n; i += nt) {
        const int partner = i ^ stride;
        if (partner <= i) continue;
        const bool up = ((i & size) == 0) != descending;
        const unsigned long long a = v[i], b = v[partner];
        if ((a > b) == up) {
          v[i] = b;
          v[partner] = a;
        }
      }
    }
    __syncthreads();
    for (int base = 0; base < n; base += nt) {   // every lane the same count
      const int i = base + tid;
      unsigned long long x = i < n ? v[i] : 0ull;
      const bool up = ((i & size) == 0) != descending;
      for (int st = stride; st > 0; st >>= 1) {
        const unsigned long long y = __shfl_xor_sync(kFull, x, st);
        // the pair's lower index keeps the smaller key going up
        const bool smaller = ((i & st) == 0) == up;
        x = smaller ? (x < y ? x : y) : (x < y ? y : x);
      }
      if (i < n) v[i] = x;
    }
  }
  __syncthreads();
}

inline __host__ __device__ int next_pow2(int n) {
  int p = 1;
  while (p < n) p <<= 1;
  return p;
}

// launch 1: a block a stream. Every candidate's key: a 64-bit word of the
// order bits of its gated score (-1 where the confidence or label gate
// fails) over its complemented index, so that larger keys come first in
// torch's stable descending sort; in shared memory where they fit (the
// label mask always), else in scratch. The radix select of the K-th
// largest key, 8 bits a pass from the top (the score's bytes, then the
// index's), a warp's equal digits counted at once; it stops where the
// digit's bin holds just the keys still wanted. The K keys at or above it
// in a bitonic sort, descending; then each selected candidate's box in
// pixels, label, scores and validity at its place.
__global__ void __launch_bounds__(kMaxThreads)
nms_select_kernel(const SelectParams p) {
  // the pack launch may start now; it waits for this grid's end
  cudaTriggerProgrammaticLaunchCompletion();
  extern __shared__ unsigned smem_select[];   // the label mask, the keys
  __shared__ int hist[kRadixBins];
  __shared__ unsigned long long sel[kMaxN];
  __shared__ unsigned s_digit;
  __shared__ int s_above, s_bin, s_count;
  const int b = blockIdx.x, n = p.n, k = p.k;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  const int warp = tid >> 5;
  const float* det = p.det + static_cast<size_t>(b) * n * 7;
  unsigned char* mask = reinterpret_cast<unsigned char*>(smem_select);
  unsigned* ord = p.keys_in_smem ? smem_select + (p.labels + 3) / 4
                                 : p.ord + static_cast<size_t>(b) * n;
  const int rounds = (n + nt - 1) / nt;   // every lane the same count
  for (int x = tid; x < p.labels; x += nt) mask[x] = p.label_mask[x];
  if (tid == 0) s_count = 0;
  __syncthreads();
  for (int j = tid; j < n; j += nt) {
    const float* d = det + static_cast<size_t>(j) * 7;
    const float score = d[4] * d[6];
    const long long label = static_cast<long long>(d[5]);
    const long long at = label < 0 ? 0
        : (label > p.labels - 1 ? p.labels - 1 : label);
    const bool keep = mask[at] && score >= p.conf_thresh;
    ord[j] = order_bits(keep ? score : -1.0f);
  }
  __syncthreads();   // the keys are whole

  auto key_of = [&](int j) {
    return (static_cast<unsigned long long>(ord[j]) << 32)
        | static_cast<unsigned>(~j);
  };
  // the index's bits above its highest are the complement's ones in
  // every key: the select starts its index passes below them
  int index_bytes = 1;
  while (index_bytes < 4 && (n - 1) >> (8 * index_bytes)) ++index_bytes;
  unsigned long long prefix = 0, high = 0;
  int stop = 0;
  if (n > k) {
    int need = k;
    for (int shift = 56; shift >= 0; shift -= 8) {
      if (shift < 32 && shift >= 8 * index_bytes) {   // all ones here
        prefix |= 0xFFull << shift;
        high |= 0xFFull << shift;
        continue;
      }
      for (int x = tid; x < kRadixBins; x += nt) hist[x] = 0;
      __syncthreads();
      for (int r = 0; r < rounds; ++r) {
        const int j = r * nt + tid;
        const unsigned long long key = j < n ? key_of(j) : 0ull;
        const bool in = j < n && (key & high) == prefix;
        const int digit = in ? static_cast<int>((key >> shift) & 0xFFu) : -1;
        const unsigned same = __match_any_sync(kFull, digit);
        if (in && lane == __ffs(static_cast<int>(same)) - 1)
          atomicAdd(&hist[digit], __popc(same));
      }
      __syncthreads();
      if (warp == 0) {
        // lane l holds bins 255 - 8 l down to 248 - 8 l
        int cnt[8], tot = 0;
        for (int q = 0; q < 8; ++q) {
          cnt[q] = hist[255 - (8 * lane + q)];
          tot += cnt[q];
        }
        int inc = tot;
        for (int o = 1; o < 32; o <<= 1) {
          const int v = __shfl_up_sync(kFull, inc, o);
          if (lane >= o) inc += v;
        }
        int c = inc - tot;
        if (c < need && need <= inc) {
          for (int q = 0; q < 8; ++q) {
            if (c + cnt[q] >= need) {
              s_digit = static_cast<unsigned>(255 - (8 * lane + q));
              s_above = c;
              s_bin = cnt[q];
              break;
            }
            c += cnt[q];
          }
        }
      }
      __syncthreads();
      prefix |= static_cast<unsigned long long>(s_digit) << shift;
      high |= 0xFFull << shift;
      need -= s_above;
      stop = shift;
      const bool done = s_bin == need;   // the bin is wanted whole
      __syncthreads();   // s_digit, s_above and s_bin are read
      if (done) break;
    }
  }
  // the keys at or above the K-th, in no order, then sorted
  for (int j = tid; j < n; j += nt) {
    const unsigned long long key = key_of(j);
    if (n <= k || (key >> stop) >= (prefix >> stop))
      sel[atomicAdd(&s_count, 1)] = key;
  }
  const int p2 = next_pow2(k);
  __syncthreads();
  for (int t = k + tid; t < p2; t += nt) sel[t] = 0ull;   // sorted last
  bitonic_sort(sel, p2, true);

  const size_t out0 = static_cast<size_t>(b) * k;
  for (int t = tid; t < k; t += nt) {
    const int j = static_cast<int>(~static_cast<unsigned>(sel[t]));
    const float* d = det + static_cast<size_t>(j) * 7;
    const float obj = d[4], cls = d[6];
    const float score = obj * cls;
    const long long label = static_cast<long long>(d[5]);
    const long long at = label < 0 ? 0
        : (label > p.labels - 1 ? p.labels - 1 : label);
    const bool keep = mask[at] && score >= p.conf_thresh;
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

// launch 2: the overlap bits from the selected boxes (as
// suppress_pack_kernel, with the DIoU and the same-label test in place of
// a read of the overlap matrix), a block a word of 32 rows, a stretch of
// kPackCols columns and a stream
__global__ void __launch_bounds__(kPackCols)
nms_pack_boxes_kernel(const SelectParams p) {
  cudaTriggerProgrammaticLaunchCompletion();
  __shared__ float rows[32][4];
  __shared__ float row_area[32];
  __shared__ long long row_label[32];
  const int k = p.k, col_blocks = (k + kPackCols - 1) / kPackCols;
  const int word = blockIdx.x / col_blocks, s = blockIdx.y;
  const int j0 = (blockIdx.x % col_blocks) * kPackCols;
  const int j1 = j0 + kPackCols < k ? j0 + kPackCols : k;
  const size_t base = static_cast<size_t>(s) * k;
  // the select launch's candidates
  cudaGridDependencySynchronize();
  if (threadIdx.x < 32) {
    const int i = 32 * word + threadIdx.x;
    if (i < k) {
      for (int q = 0; q < 4; ++q)
        rows[threadIdx.x][q] = p.c_tlbr[(base + i) * 4 + q];
      row_area[threadIdx.x] = box_area(rows[threadIdx.x]);
      row_label[threadIdx.x] = p.c_label[base + i];
    }
  }
  __syncthreads();
  unsigned* out = p.bits + (static_cast<size_t>(s) * p.words + word) * k;
  for (int j = j0 + threadIdx.x; j < j1; j += blockDim.x) {
    float col[4];
    for (int q = 0; q < 4; ++q) col[q] = p.c_tlbr[(base + j) * 4 + q];
    const float col_area = box_area(col);
    const long long col_label = p.c_label[base + j];
    unsigned bits_j = 0;
    for (int r = 0; r < 32; ++r) {
      const int i = 32 * word + r;
      if (i < k && i != j && row_label[r] == col_label
          && diou_exceeds(rows[r], row_area[r], col, col_area, p.nms_thresh))
        bits_j |= 1u << r;
    }
    out[j] = bits_j;
  }
}

// launch 3: a block a stream. The waves from the bits, then the area and
// aspect-ratio gates, then the stable ascending order of label * 1e4 -
// score (infinity where a box is not kept): a bitonic sort of 64-bit keys,
// the order bits over the index; the first M candidates in that order
// written out
__global__ void __launch_bounds__(kMaxThreads)
nms_order_kernel(const SelectParams p) {
  extern __shared__ unsigned smem_bits[];   // [W][K], then the scores
  __shared__ unsigned remaining[kMaxWords], wave[kMaxWords], kept[kMaxWords];
  __shared__ unsigned long long order[kMaxN];
  __shared__ unsigned char final_box[kMaxN];
  const int s = blockIdx.x, k = p.k, nw = p.words;
  const int tid = threadIdx.x, nt = blockDim.x, lane = tid & 31;
  float* score = reinterpret_cast<float*>(smem_bits + nw * k);
  const size_t base = static_cast<size_t>(s) * k;
  // the select and pack launches are done
  cudaGridDependencySynchronize();
  for (int j = tid; j < k; j += nt) score[j] = p.c_obj[base + j];
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
  const unsigned* stream_bits = p.bits + static_cast<size_t>(s) * nw * k;
  for (int x = tid; x < nw * k; x += nt) smem_bits[x] = stream_bits[x];
  __syncthreads();
  run_waves(smem_bits, score, remaining, wave, kept, k, nw);

  const int p2 = next_pow2(k);
  for (int t = tid; t < p2; t += nt) {
    if (t >= k) {
      order[t] = ~0ull;                 // sorted last
      continue;
    }
    const float* box = p.c_tlbr + (base + t) * 4;
    const float w = (box[2] - box[0]) + 1.0f, h = (box[3] - box[1]) + 1.0f;
    const float area = (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
    const float ar = w > 0.0f ? h / w : 0.0f;
    const bool final = ((kept[t >> 5] >> (t & 31)) & 1u) && area > 0.0f
        && area <= p.max_area && ar >= p.min_ar;
    const float label_key = static_cast<float>(p.c_label[base + t]) * 1e4f;
    const float conf = p.c_obj[base + t] * p.c_cls[base + t];
    const float key = final ? label_key - conf : __uint_as_float(0x7F800000u);
    final_box[t] = final;
    order[t] = (static_cast<unsigned long long>(order_bits(key)) << 32)
        | static_cast<unsigned>(t);
  }
  bitonic_sort(order, p2, false);
  const size_t out0 = static_cast<size_t>(s) * p.m;
  for (int r = tid; r < p.m; r += nt) {
    const int t = static_cast<int>(static_cast<unsigned>(order[r]));
    for (int q = 0; q < 4; ++q)
      p.out_tlbr[(out0 + r) * 4 + q] = p.c_tlbr[(base + t) * 4 + q];
    p.out_label[out0 + r] = static_cast<int>(p.c_label[base + t]);
    p.out_conf[out0 + r] = p.c_obj[base + t] * p.c_cls[base + t];
    p.out_valid[out0 + r] = final_box[t];
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
  // the label mask in shared memory, and the keys where they fit
  const int mask_bytes = (p.labels + 3) / 4 * 4;
  p.keys_in_smem = mask_bytes + 4 * p.n <= kSelectSmemMax;
  const int select_smem = mask_bytes + (p.keys_in_smem ? 4 * p.n : 0);
  cudaError_t e = cudaFuncSetAttribute(
      nms_select_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
      select_smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_streams);
  cfg.blockDim = dim3(kMaxThreads);
  cfg.dynamicSmemBytes = select_smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 0;   // the first launch waits for the stream's work
  e = cudaLaunchKernelEx(&cfg, nms_select_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(p.words * ((p.k + kPackCols - 1) / kPackCols),
                     n_streams);
  cfg.blockDim = dim3(threads_for(p.k < kPackCols ? p.k : kPackCols));
  cfg.dynamicSmemBytes = 0;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, nms_pack_boxes_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  const int smem = suppress_smem_bytes(p.k);
  e = cudaFuncSetAttribute(nms_order_kernel,
                           cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cfg.gridDim = dim3(n_streams);
  cfg.dynamicSmemBytes = smem;
  e = cudaLaunchKernelEx(&cfg, nms_order_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code an entry returned
const char* nms_waves_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
