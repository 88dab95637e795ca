// The association frame's solvers for Hopper (sm_90a): the whole auction
// cascade of a frame in one launch, and the greedy matches of its finals in
// another, for every stream of a call, with no host sync.
//
// Replaces fastmot_tpu/ops/assignment.py:36 auction_lap (an epsilon-scaling
// Jacobi auction whose eps phases and bidding rounds are lax.while_loops,
// :216 and :168) as the JAX package's fastmot_tpu/tracker.py:651
// _stages_scan_core runs it (lax.scan over the n_depth + 2 cascade stages),
// and fastmot_tpu/ops/assignment.py:237 greedy_match_arrays (a
// lax.while_loop of global minima) as fastmot_tpu/tracker.py:628
// _finals_core runs it twice. Neither is a Pallas kernel: both are XLA
// programs of the association frame. Their plain PyTorch twins are
// auction_lap_reference, cascade_reference and greedy_match_reference in
// fastmot_tpu_torch/ops/assignment.py, which loop on the host and read a
// flag back once per 8 bidding rounds (the auction) or once per match (the
// greedy); the wrappers cascade_auction, auction_lap, greedy_match and
// greedy_match_arrays there check the arguments, allocate the outputs and
// call cascade_auction_forward and greedy_match_forward below.
//
// What bounds it on an H100: neither bytes nor operations. A stream's two
// cost matrices are 2 x 128 x 128 float32 (128 KB), and a bidding round is
// about 3 n^2 = 49 K float32 operations; the rounds are a chain, each
// waiting on the prices the last one set. So the design keeps a stream's
// whole cascade in one block, its state in shared memory, and spends a
// round on two barriers:
//
//   cascade_auction_kernel, one block of 1,024 threads a stream. For each
//     stage of the stage list (its row mask, which of the two costs, and
//     whether rows matched by an earlier stage sit out):
//     - the stage's padded n x n benefit (n = max(rows, cols) <= 128) is
//       built in shared memory, a warp a row word: the cost clamped to
//       `forbid`, `forbid` where the row or the column is masked or padded,
//       negated, plus bias x the hash noise of the plain version, rounded
//       as it rounds them (-fmad=false); a ballot gives each row's word of
//       finite (allowed) entries;
//     - rows with no allowed entry are pre-assigned to columns with none,
//       the k-th such row to the k-th such column, ascending (the plain
//       version's stable argsort);
//     - each eps phase (0.5, 0.0625, ... while eps >= eps_final) resets the
//       prices, drops the owners that break eps-complementary slackness,
//       and runs Jacobi rounds until every row is assigned or the round
//       cap: a warp takes an unassigned row, a shuffle reduction of one
//       64-bit key (the value's order-preserving bits, then the complemented
//       column) gives its best value and first best column and beside it
//       the second-best value; lane 0 bids (price + (v1 - v2)) + eps into
//       the column's slot by one 64-bit atomicMax of (the bid's
//       order-preserving bits, the complemented row), so the largest bid
//       wins and the smallest row among equal bids, as torch.max and
//       jnp.argmax pick the first; after a barrier a thread a column takes
//       its slot's winner, and a block vote (__syncthreads_or) on the
//       columns left unowned ends the phase;
//     - the pairs on forbidden or padded entries are dropped, and the
//       stage's matches are absorbed: col4row takes them and their
//       detections leave u_det.
//     With one stage and the row4col output, it is auction_lap itself.
//   greedy_match_kernel, one block a (stream, problem): each round a
//     block-wide minimum of (the cost's order-preserving bits, the flat
//     index) over the live entries, a warp's shuffles then one barrier,
//     gives the least cost and the smallest flat index among equal costs
//     (np.argmin); if it is at most max_cost the pair is matched and its
//     row and column die, else the problem is done.
//
// Every loop strides by blockDim.x and takes whole warps, so a block of 32
// or 64 threads computes what 1,024 compute (the tests' host build runs
// such blocks).

#include <cuda_runtime.h>
#include <math.h>

#include <cstdint>

namespace {

constexpr int kMaxN = 128;            // the auction's padded size
constexpr int kMaxWords = kMaxN / 32;
constexpr int kMaxStages = 64;
constexpr int kMaxPhases = 40;
constexpr int kMaxGreedy = 4096;      // a greedy problem's rows or columns
constexpr int kMaxProblems = 4;
constexpr int kThreads = 1024;

// the cascade entry's pointers, ints and floats, in order
enum Ptr {
  kCost0, kCost1, kUDetIn, kCol4RowIn, kUDetOut, kCol4RowOut, kRow4ColOut,
  kRoundsOut, kBidsOut, kMasks
};
enum Int { kStreams, kRows, kCols, kStages, kPhases, kRoundCap, kStageInts };
enum Float { kBias, kForbid };

// the greedy entry's: a problem's pointers and ints, then the next one's
enum GreedyPtr { kGCost, kGRowValid, kGColValid, kGRow4Col, kGCol4Row,
                 kGPtrs };
enum GreedyInt { kGStreams, kGProblems, kGDims };

struct CascadeParams {
  const float* cost[2];
  const unsigned char* mask[kMaxStages];   // null: every row
  int cost_of[kMaxStages];
  int exclude[kMaxStages];
  const unsigned char* u_det_in;           // null: every column
  const int* col4row_in;                   // null: every row unmatched
  unsigned char* u_det_out;                // null: not written
  int* col4row_out;
  int* row4col_out;                        // null: not written
  int* rounds_out;                         // null: not written
  int* bids_out;                           // null: not counted
  int rows, cols, n, words, n_stages, n_phases, round_cap;
  float bias, forbid;
};

struct GreedyProblem {
  const float* cost;
  const unsigned char* row_valid;
  const unsigned char* col_valid;
  int* row4col;
  int* col4row;
  int rows, cols;
  float max_cost;
};

struct GreedyParams {
  GreedyProblem prob[kMaxProblems];
};

// a float's bits, ordered as the floats are (-0 canonicalised to +0 first
// by the callers)
__device__ __forceinline__ unsigned ordered_bits(float f) {
  const unsigned u = __float_as_uint(f);
  return (u & 0x80000000u) ? ~u : (u | 0x80000000u);
}

__device__ __forceinline__ float from_ordered(unsigned o) {
  return __uint_as_float((o & 0x80000000u) ? (o & 0x7FFFFFFFu) : ~o);
}

// the plain version's micro-bias noise: (i * 2654435761 + j * 40503) mod
// 65536 over 65536 (uint32 arithmetic keeps the low 16 bits exact)
__device__ __forceinline__ float bias_noise(int i, int j) {
  const unsigned h = (static_cast<unsigned>(i) * 2654435761u
                      + static_cast<unsigned>(j) * 40503u) & 0xFFFFu;
  return static_cast<float>(h) * (1.0f / 65536.0f);
}

__global__ void __launch_bounds__(kThreads)
cascade_auction_kernel(CascadeParams p) {
  extern __shared__ float benefit[];            // [n][n + 1]
  __shared__ float price[kMaxN], vmax[kMaxN];
  __shared__ int owner[kMaxN], col_of_row[kMaxN], final_c4r[kMaxN];
  __shared__ int dead_row_at[kMaxN], dead_col_at[kMaxN];
  __shared__ unsigned char row_ok[kMaxN], col_ok[kMaxN];
  __shared__ unsigned finite[kMaxN * kMaxWords];
  __shared__ unsigned dead_rows[kMaxWords], dead_cols[kMaxWords];
  __shared__ unsigned long long slot[kMaxN];
  __shared__ int n_bids;

  const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int R = p.rows, C = p.cols, n = p.n, ld = n + 1, W = p.words;

  for (int j = tid; j < n; j += nt) {
    col_ok[j] = j < C && (!p.u_det_in
                          || p.u_det_in[static_cast<size_t>(s) * C + j]);
    slot[j] = 0ull;
  }
  for (int i = tid; i < n; i += nt)
    final_c4r[i] = (i < R && p.col4row_in)
        ? p.col4row_in[static_cast<size_t>(s) * R + i] : -1;
  __syncthreads();

  for (int k = 0; k < p.n_stages; ++k) {
    const float* cost = p.cost[p.cost_of[k]] + static_cast<size_t>(s) * R * C;
    const unsigned char* mask = p.mask[k];
    const bool exclude = p.exclude[k] != 0;
    for (int i = tid; i < n; i += nt)
      row_ok[i] = i < R
          && (!mask || mask[static_cast<size_t>(s) * R + i])
          && (!exclude || final_c4r[i] < 0);
    __syncthreads();

    // the benefit, and each row's words of allowed entries
    for (int t = warp; t < n * W; t += n_warps) {
      const int i = t / W, q = t - i * W, j = q * 32 + lane;
      float v = p.forbid;
      if (j < n) {
        if (row_ok[i] && col_ok[j]) {
          const float c = cost[static_cast<size_t>(i) * C + j];
          v = c > p.forbid ? p.forbid : c;
        }
        benefit[i * ld + j] = -v + p.bias * bias_noise(i, j);
      }
      const unsigned bits = __ballot_sync(0xFFFFFFFFu, j < n && v < p.forbid);
      if (lane == 0) finite[i * W + q] = bits;
    }
    __syncthreads();

    // the rows and columns with no allowed entry, as bit words
    for (int t = warp; t < 2 * W; t += n_warps) {
      const int q = t % W;
      if (t < W) {
        const int i = q * 32 + lane;
        bool live = false;
        if (i < n)
          for (int w = 0; w < W; ++w) live |= finite[i * W + w] != 0u;
        const unsigned dead = __ballot_sync(0xFFFFFFFFu, i < n && !live);
        if (lane == 0) dead_rows[q] = dead;
      } else {
        unsigned any = 0u;
        for (int i = lane; i < n; i += 32) any |= finite[i * W + q];
        for (int off = 16; off > 0; off >>= 1)
          any |= __shfl_xor_sync(0xFFFFFFFFu, any, off);
        const int left = n - q * 32;
        const unsigned in_range = left >= 32 ? 0xFFFFFFFFu
                                             : ((1u << left) - 1u);
        if (lane == 0) dead_cols[q] = ~any & in_range;
      }
    }
    // each row's best benefit (the eps-CS check's, at price 0)
    for (int i = warp; i < n; i += n_warps) {
      float m = -INFINITY;
      for (int j = lane; j < n; j += 32) m = fmaxf(m, benefit[i * ld + j]);
      for (int off = 16; off > 0; off >>= 1)
        m = fmaxf(m, __shfl_xor_sync(0xFFFFFFFFu, m, off));
      if (lane == 0) vmax[i] = m;
    }
    __syncthreads();

    // dead rows onto dead columns, the k-th onto the k-th, ascending
    int n_dead_rows = 0, n_dead_cols = 0;
    for (int w = 0; w < W; ++w) {
      n_dead_rows += __popc(dead_rows[w]);
      n_dead_cols += __popc(dead_cols[w]);
    }
    for (int x = tid; x < n; x += nt) {
      const int q = x >> 5;
      const unsigned below = (1u << (x & 31)) - 1u;
      int rank_r = __popc(dead_rows[q] & below);
      int rank_c = __popc(dead_cols[q] & below);
      for (int w = 0; w < q; ++w) {
        rank_r += __popc(dead_rows[w]);
        rank_c += __popc(dead_cols[w]);
      }
      if (dead_rows[q] >> (x & 31) & 1u) dead_row_at[rank_r] = x;
      if (dead_cols[q] >> (x & 31) & 1u) dead_col_at[rank_c] = x;
    }
    __syncthreads();
    for (int x = tid; x < n; x += nt) {
      const int q = x >> 5;
      const unsigned below = (1u << (x & 31)) - 1u;
      int rank_r = __popc(dead_rows[q] & below);
      int rank_c = __popc(dead_cols[q] & below);
      for (int w = 0; w < q; ++w) {
        rank_r += __popc(dead_rows[w]);
        rank_c += __popc(dead_cols[w]);
      }
      const bool dead_c = dead_cols[q] >> (x & 31) & 1u;
      const bool dead_r = dead_rows[q] >> (x & 31) & 1u;
      owner[x] = (dead_c && rank_c < n_dead_rows) ? dead_row_at[rank_c] : -1;
      col_of_row[x] = (dead_r && rank_r < n_dead_cols) ? dead_col_at[rank_r]
                                                       : -1;
    }
    __syncthreads();

    float eps = 0.5f;
    for (int ph = 0; ph < p.n_phases; ++ph, eps *= 0.125f) {
      // price reset; owners that break eps-CS at price 0 let go
      int open = 0;
      if (tid == 0) n_bids = 0;
      for (int j = tid; j < n; j += nt) {
        price[j] = 0.0f;
        const int i = owner[j];
        if (i >= 0 && !(benefit[i * ld + j] >= vmax[i] - eps)) {
          owner[j] = -1;
          col_of_row[i] = -1;
        }
        open |= owner[j] < 0;
      }
      open = __syncthreads_or(open);
      int rounds = 0;
      while (open && rounds < p.round_cap) {
        // bids: a warp an unassigned row
        for (int i = warp; i < n; i += n_warps) {
          if (col_of_row[i] >= 0) continue;
          unsigned long long best = 0ull;
          float second = -INFINITY;
          for (int j = lane; j < n; j += 32) {
            const float v = (benefit[i * ld + j] - price[j]) + 0.0f;
            const unsigned long long key =
                static_cast<unsigned long long>(ordered_bits(v)) << 32
                | static_cast<unsigned>(~j);
            if (key > best) {
              if (best) second = fmaxf(second, from_ordered(best >> 32));
              best = key;
            } else {
              second = fmaxf(second, v);
            }
          }
          for (int off = 16; off > 0; off >>= 1) {
            const unsigned long long o_best =
                __shfl_xor_sync(0xFFFFFFFFu, best, off);
            const float o_second = __shfl_xor_sync(0xFFFFFFFFu, second, off);
            if (o_best > best) {
              if (best) second = fmaxf(o_second, from_ordered(best >> 32));
              else second = o_second;
              best = o_best;
            } else if (o_best) {
              second = fmaxf(second, from_ordered(o_best >> 32));
            }
          }
          if (lane == 0) {
            const int top1 = static_cast<int>(~static_cast<unsigned>(best));
            const float v1 = from_ordered(static_cast<unsigned>(best >> 32));
            const float v2 = isfinite(second) ? second : v1;
            const float bid = (price[top1] + (v1 - v2)) + eps;
            if (p.bids_out) atomicAdd(&n_bids, 1);
            atomicMax(&slot[top1],
                      static_cast<unsigned long long>(ordered_bits(bid)) << 32
                      | static_cast<unsigned>(~i));
          }
        }
        __syncthreads();
        // each column takes its best bid
        int left = 0;
        for (int j = tid; j < n; j += nt) {
          const unsigned long long b = slot[j];
          if (b) {
            slot[j] = 0ull;
            const int i = static_cast<int>(~static_cast<unsigned>(b));
            const int prev = owner[j];
            if (prev >= 0) col_of_row[prev] = -1;
            col_of_row[i] = j;
            owner[j] = i;
            price[j] = from_ordered(static_cast<unsigned>(b >> 32));
          }
          left |= owner[j] < 0;
        }
        ++rounds;
        open = __syncthreads_or(left);
      }
      const size_t at = (static_cast<size_t>(s) * p.n_stages + k)
          * p.n_phases + ph;
      if (p.rounds_out && tid == 0) p.rounds_out[at] = rounds;
      if (p.bids_out && tid == 0) p.bids_out[at] = n_bids;
    }

    // pairs on forbidden or padded entries dropped; the matches absorbed
    if (p.row4col_out)
      for (int j = tid; j < C; j += nt) {
        const int i = owner[j];
        const bool ok = i >= 0 && (finite[i * W + (j >> 5)] >> (j & 31) & 1u);
        p.row4col_out[static_cast<size_t>(s) * C + j] = ok ? i : -1;
      }
    for (int i = tid; i < R; i += nt) {
      const int j = col_of_row[i];
      if (j >= 0 && (finite[i * W + (j >> 5)] >> (j & 31) & 1u)) {
        final_c4r[i] = j;
        col_ok[j] = 0;
      }
    }
    __syncthreads();
  }

  if (p.u_det_out)
    for (int j = tid; j < C; j += nt)
      p.u_det_out[static_cast<size_t>(s) * C + j] = col_ok[j];
  for (int i = tid; i < R; i += nt)
    p.col4row_out[static_cast<size_t>(s) * R + i] = final_c4r[i];
}

__global__ void __launch_bounds__(kThreads)
greedy_match_kernel(GreedyParams p) {
  __shared__ unsigned char row_live[kMaxGreedy], col_live[kMaxGreedy];
  __shared__ unsigned long long warp_best[2][32];
  const GreedyProblem q = p.prob[blockIdx.y];
  const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int R = q.rows, C = q.cols;
  const float* cost = q.cost + static_cast<size_t>(s) * R * C;
  int* row4col = q.row4col + static_cast<size_t>(s) * C;
  int* col4row = q.col4row + static_cast<size_t>(s) * R;
  for (int i = tid; i < R; i += nt) {
    row_live[i] = q.row_valid[static_cast<size_t>(s) * R + i];
    col4row[i] = -1;
  }
  for (int j = tid; j < C; j += nt) {
    col_live[j] = q.col_valid[static_cast<size_t>(s) * C + j];
    row4col[j] = -1;
  }
  __syncthreads();
  const int total = R * C;
  for (int round = 0;; ++round) {
    unsigned long long best = ~0ull;
    for (int f = tid; f < total; f += nt) {
      const int i = f / C, j = f - i * C;
      if (row_live[i] && col_live[j]) {
        const unsigned long long key =
            static_cast<unsigned long long>(ordered_bits(cost[f] + 0.0f))
            << 32 | static_cast<unsigned>(f);
        best = key < best ? key : best;
      }
    }
    for (int off = 16; off > 0; off >>= 1) {
      const unsigned long long o = __shfl_xor_sync(0xFFFFFFFFu, best, off);
      best = o < best ? o : best;
    }
    if (lane == 0) warp_best[round & 1][warp] = best;
    __syncthreads();
    best = ~0ull;
    for (int w = 0; w < n_warps; ++w) {
      const unsigned long long o = warp_best[round & 1][w];
      best = o < best ? o : best;
    }
    if (best == ~0ull) break;
    if (!(from_ordered(static_cast<unsigned>(best >> 32)) <= q.max_cost))
      break;
    const int f = static_cast<int>(static_cast<unsigned>(best));
    const int i = f / C, j = f - i * C;
    // every thread kills the pair's row and column itself (the same
    // values), so the next round needs no second barrier
    row_live[i] = 0;
    col_live[j] = 0;
    if (tid == 0) {
      row4col[j] = i;
      col4row[i] = j;
    }
  }
}

}  // namespace

extern "C" {

// One call of the cascade for ints[kStreams] streams: `ptrs` holds the Ptr
// enum's device pointers in its order, then a row mask a stage (a null
// pointer: every row); `ints` the Int enum's values, then each stage's
// cost (0 or 1) and then each stage's exclude flag; `floats` the bias and
// forbid. One launch on `stream`. Returns 0 or the first cudaError_t.
int cascade_auction_forward(const void* const* ptrs, const int* ints,
                            const float* floats, void* stream) {
  CascadeParams p = {};
  const int n_streams = ints[kStreams];
  p.rows = ints[kRows];
  p.cols = ints[kCols];
  p.n_stages = ints[kStages];
  p.n_phases = ints[kPhases];
  p.round_cap = ints[kRoundCap];
  p.n = p.rows > p.cols ? p.rows : p.cols;
  p.words = (p.n + 31) / 32;
  if (n_streams < 1 || p.rows < 1 || p.cols < 1 || p.n > kMaxN
      || p.n_stages < 1 || p.n_stages > kMaxStages || p.n_phases < 0
      || p.n_phases > kMaxPhases || p.round_cap < 0)
    return static_cast<int>(cudaErrorInvalidValue);
  p.bias = floats[kBias];
  p.forbid = floats[kForbid];
  p.cost[0] = static_cast<const float*>(ptrs[kCost0]);
  p.cost[1] = static_cast<const float*>(ptrs[kCost1]);
  p.u_det_in = static_cast<const unsigned char*>(ptrs[kUDetIn]);
  p.col4row_in = static_cast<const int*>(ptrs[kCol4RowIn]);
  p.u_det_out = static_cast<unsigned char*>(const_cast<void*>(ptrs[kUDetOut]));
  p.col4row_out = static_cast<int*>(const_cast<void*>(ptrs[kCol4RowOut]));
  p.row4col_out = static_cast<int*>(const_cast<void*>(ptrs[kRow4ColOut]));
  p.rounds_out = static_cast<int*>(const_cast<void*>(ptrs[kRoundsOut]));
  p.bids_out = static_cast<int*>(const_cast<void*>(ptrs[kBidsOut]));
  for (int k = 0; k < p.n_stages; ++k) {
    p.mask[k] = static_cast<const unsigned char*>(ptrs[kMasks + k]);
    p.cost_of[k] = ints[kStageInts + k];
    p.exclude[k] = ints[kStageInts + p.n_stages + k];
    if (p.cost_of[k] < 0 || p.cost_of[k] > 1 || !p.cost[p.cost_of[k]])
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!p.col4row_out) return static_cast<int>(cudaErrorInvalidValue);
  const int smem = p.n * (p.n + 1) * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {    // above the static limit: ask for it
    const cudaError_t e = cudaFuncSetAttribute(
        cascade_auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_streams);
  cascade_auction_kernel<<<grid, kThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One call of the greedy matches for ints[kGStreams] streams and
// ints[kGProblems] problems: `ptrs` holds each problem's GreedyPtr
// pointers in turn, `ints` after the two counts each problem's rows and
// columns, `floats` each problem's max_cost. One launch on `stream`.
// Returns 0 or the first cudaError_t.
int greedy_match_forward(const void* const* ptrs, const int* ints,
                         const float* floats, void* stream) {
  GreedyParams p = {};
  const int n_streams = ints[kGStreams], n_problems = ints[kGProblems];
  if (n_streams < 1 || n_problems < 1 || n_problems > kMaxProblems)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < n_problems; ++k) {
    GreedyProblem& q = p.prob[k];
    const void* const* pk = ptrs + k * kGPtrs;
    q.cost = static_cast<const float*>(pk[kGCost]);
    q.row_valid = static_cast<const unsigned char*>(pk[kGRowValid]);
    q.col_valid = static_cast<const unsigned char*>(pk[kGColValid]);
    q.row4col = static_cast<int*>(const_cast<void*>(pk[kGRow4Col]));
    q.col4row = static_cast<int*>(const_cast<void*>(pk[kGCol4Row]));
    q.rows = ints[kGDims + 2 * k];
    q.cols = ints[kGDims + 2 * k + 1];
    q.max_cost = floats[k];
    if (q.rows < 1 || q.cols < 1 || q.rows > kMaxGreedy
        || q.cols > kMaxGreedy || !q.cost || !q.row_valid || !q.col_valid
        || !q.row4col || !q.col4row)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_streams, n_problems);
  greedy_match_kernel<<<grid, kThreads, 0, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code either entry returned
const char* assoc_solvers_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
