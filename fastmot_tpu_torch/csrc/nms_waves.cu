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
  for (int j = tid; j < n; j += nt)
    p.keep[row + j] = (kept[j >> 5] >> (j & 31)) & 1u;
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

// The message of a code an entry returned
const char* nms_waves_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
