// The association frame's solvers for Hopper (sm_90a): the whole auction
// cascade of a frame in one launch, and the finals of the frame (their masks,
// the rectify cost and both greedy matches) in another, for every stream of
// a call, with no host sync.
//
// Replaces fastmot_tpu/ops/assignment.py:36 auction_lap (an epsilon-scaling
// Jacobi auction whose eps phases and bidding rounds are lax.while_loops,
// :216 and :168) as the JAX package's fastmot_tpu/tracker.py:651
// _stages_scan_core runs it (lax.scan over the n_depth + 2 cascade stages),
// and fastmot_tpu/ops/assignment.py:237 greedy_match_arrays (a
// lax.while_loop of global minima) as fastmot_tpu/tracker.py:628
// _finals_core runs it twice, with the masks and the rectify cost
// (1 - IoU of a track's box and its matched detection's) around them.
// Neither is a Pallas kernel: both are XLA programs of the association
// frame. Their plain PyTorch twins are auction_lap_reference,
// cascade_reference and greedy_match_reference in
// fastmot_tpu_torch/ops/assignment.py and finals_reference in
// fastmot_tpu_torch/tracker.py, which loop on the host and read a flag back
// once per 8 bidding rounds (the auction) or once per match (the greedy);
// the wrappers cascade_auction, auction_lap, greedy_match,
// greedy_match_arrays and greedy_finals there check the arguments, allocate
// the outputs and call the C entries below.
//
// What bounds it on an H100: neither bytes nor operations. A stream's two
// cost matrices are 2 x 128 x 128 float32 (128 KB), and the rounds are a
// chain, each waiting on the prices the last one set; a round is itself a
// chain of dependent instructions on a warp or two, so its latency is the
// cost (scripts/prof_assoc_solvers.py counts its cycles). So the design
// keeps a stream's whole cascade in one block with its state in shared
// memory, sizes each step to the work that is live, and keeps a round's
// chain short:
//
//   cascade_auction_kernel, one block a stream of 1,024 threads.
//     - Both costs are staged into shared memory once, by two bulk copies
//       (cp.async.bulk) completing on an mbarrier (4-byte cp.async where a
//       row is not a 16-byte multiple), while the block turns the stages'
//       row masks, u_det and col4row into bit words and takes each padded
//       row's largest micro-bias noise.
//     - The padded n x n benefit (n = max(rows, cols) <= 128) is written
//       for the stage's live rows only, from the staged cost: -min(cost,
//       forbid) on a live column, -forbid elsewhere, plus bias x the hash
//       noise of the plain version, rounded as it rounds them (-fmad=false);
//       a row with nothing live computes its entry where it is read. Every
//       row and column of the square stays in play, so the dynamics of the
//       dead ones (a live row priced out onto a dead column, the dead row it
//       displaces bidding in turn) are the plain version's.
//     - A stage with no live row (or whose live rows have no entry other
//       than forbid) ends at once when the pre-assignment of the square's
//       all-dead rows survives every eps phase (checked once a launch), with
//       no barrier; otherwise a warp a live row takes its words of allowed
//       entries and its best benefit (the eps-CS check's), and the dead rows
//       are pre-assigned to the dead columns by ranks of bit words.
//     - Each eps phase (0.5, 0.0625, ... while eps >= eps_final) resets the
//       prices and drops the owners that break eps-complementary slackness;
//       then Jacobi rounds until every row is assigned or the round cap. A
//       word of unassigned rows picks the bidders. While two rows or more
//       bid, a round is a warp a bidder, a 64-bit atomicMax into the
//       column's slot, a barrier, a thread a column taking its winner, a
//       barrier. A lone bidder (their number never grows within a phase)
//       always wins, and the owner it displaces bids next: warp 0 runs that
//       chain alone, with a __syncwarp a round and no barrier, while the
//       other warps wait at the phase's end.
//     - A bid is the plain version's: each lane keeps one 64-bit key of its
//       columns (the value's order-preserving bits, then the complemented
//       column) and beside it the second-best value; three warp reductions
//       (redux.sync) give the best value, the first best column and the
//       second-best value; (price + (v1 - v2)) + eps goes into the column's
//       slot as (the bid's order-preserving bits, the complemented row), so
//       the largest bid wins and the smallest row among equal bids.
//     - The pairs on forbidden or padded entries are dropped, and the
//       stage's matches are absorbed: col4row takes them and their
//       detections leave u_det.
//     With one stage and the row4col output, it is auction_lap itself.
//   greedy_match_kernel, one block a (stream, problem): the live costs are
//     staged into shared memory (the rectify cost computed there, in
//     bbox_ious's order of operations, on the finals launch), each live row
//     keeps its least 64-bit key (the cost's order-preserving bits, then the
//     flat index) over its live columns, and warp 0 runs the rounds: the
//     least of the rows' keys is the plain version's argmin (np.argmin: the
//     least cost, the smallest flat index among equal ones); if it is at
//     most max_cost the pair is matched, its row dies, and only the rows
//     whose key sat in its column are scanned again. The finals launch
//     computes the problems' masks itself and waits for the cascade's
//     outputs behind a programmatic dependent launch.
//
// Every loop strides by blockDim.x and takes whole warps, so a block of 32
// or 64 threads computes what 1,024 compute (the tests' host build runs such
// blocks).

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
constexpr int kCascadeThreads = 1024;  // the cascade's launch bound
constexpr int kGreedyThreads = 512;
// a greedy problem whose rows x (columns + 1) floats fit is staged in shared
// memory (the rectify problem always: 128 x 129)
constexpr int kGreedyStage = kMaxN * (kMaxN + 1);
constexpr unsigned kFull = 0xFFFFFFFFu;

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

// the finals entry's
enum FinalsPtr {
  kFTlbrs, kFTValid, kFAges, kFHits, kFDTlbrs, kFDConf, kFReidCost,
  kFHReidOk, kFOccluded, kFUDet, kFCol4Row, kFUDetConfOut, kFReidOut,
  kFRectOut, kFPtrs
};
enum FinalsInt { kFStreams, kFTracks, kFDets, kFHist, kFConfirmHits };
enum FinalsFloat { kFConfThresh, kFMaxReid, kFDupGate };

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
  int* bids_out;                           // null: not written
  int rows, cols, n, words, n_costs, n_stages, n_phases, round_cap;
  float bias, forbid;
};

struct GreedyProblem {
  const float* cost;
  const unsigned char* row_valid;
  const unsigned char* col_valid;
  int* row4col;                            // null: not written
  int* col4row;
  int rows, cols;
  float max_cost;
};

struct FinalsParams {
  const float* tlbrs;                      // [S, T, 4]
  const unsigned char* t_valid;            // [S, T]
  const int* ages;
  const int* hits;
  const float* d_tlbrs;                    // [S, D, 4]
  const float* d_conf;                     // [S, D]
  const float* reid_cost;                  // [S, H, D]
  const unsigned char* h_reid_ok;          // [S, H]
  const unsigned char* occluded;           // [S, D]
  const unsigned char* u_det;              // [S, D]
  const int* col4row;                      // [S, T]
  unsigned char* u_det_conf;               // [S, D], written
  int* reid_c4r;                           // [S, H], written
  int* rect_c4r;                           // [S, T], written
  int tracks, dets, hist, confirm_hits;
  float conf_thresh, max_reid, dup_gate;
};

struct GreedyParams {
  GreedyProblem prob[kMaxProblems];
  FinalsParams fin;
  int finals;                              // 1: the finals' two problems
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
__device__ __forceinline__ unsigned bias_hash(int i, int j) {
  return (static_cast<unsigned>(i) * 2654435761u
          + static_cast<unsigned>(j) * 40503u) & 0xFFFFu;
}

__device__ __forceinline__ float noise_of(unsigned h) {
  return static_cast<float>(h) * (1.0f / 65536.0f);
}

__device__ __forceinline__ unsigned range_bits(int n, int q) {
  const int left = n - q * 32;
  return left >= 32 ? kFull : (left > 0 ? (1u << left) - 1u : 0u);
}

// bit words in shared memory, or their complement within [0, n) (the dead
// rows or columns from the alive ones)
struct Words {
  const unsigned* w;
  int n;
  bool inv;
  __device__ __forceinline__ unsigned operator[](int q) const {
    return inv ? ~w[q] & range_bits(n, q) : w[q];
  }
};

template <class V>
__device__ __forceinline__ bool bit_of(const V& words, int x) {
  return (words[x >> 5] >> (x & 31)) & 1u;
}

// the set bits of `words` below x
template <class V>
__device__ __forceinline__ int rank_of(const V& words, int x) {
  const int q = x >> 5;
  int r = __popc(words[q] & ((1u << (x & 31)) - 1u));
  for (int w = 0; w < q; ++w) r += __popc(words[w]);
  return r;
}

// the k-th set bit of `words` (k < their count)
template <class V>
__device__ __forceinline__ int nth_set(const V& words, int n_words, int k) {
  for (int q = 0; q < n_words; ++q) {
    unsigned w = words[q];
    const int c = __popc(w);
    if (k < c) {
      int base = 0;
      for (int half = 16; half > 0; half >>= 1) {
        const unsigned low = w & ((1u << half) - 1u);
        const int in_low = __popc(low);
        if (k >= in_low) {
          k -= in_low;
          w >>= half;
          base += half;
        } else {
          w = low;
        }
      }
      return q * 32 + base;
    }
    k -= c;
  }
  return -1;
}

template <class V>
__device__ __forceinline__ int count_bits(const V& words, int n_words) {
  int c = 0;
  for (int q = 0; q < n_words; ++q) c += __popc(words[q]);
  return c;
}

// ---------------------------------------------------------------------------
// Staging a stream's costs in shared memory
// ---------------------------------------------------------------------------

#if defined(__CUDA_ARCH__)
__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
#endif

// Starts the copy of `n_src` blocks of `count` floats into dst (back to
// back). bulk: thread 0 arms the mbarrier and issues one cp.async.bulk a
// block (16-byte aligned sources and sizes); else each thread issues
// 4-byte cp.async for its strided share. stage_done() completes it for the
// calling thread; a barrier after it makes the fallback's copies visible to
// the block, and the mbarrier wait comes after that barrier.
__device__ __forceinline__ void stage_issue(float* dst,
                                            const float* const* src,
                                            int n_src, int count,
                                            unsigned long long* bar,
                                            bool bulk) {
  const int tid = threadIdx.x, nt = blockDim.x;
#if defined(__CUDA_ARCH__)
  if (bulk) {
    if (tid == 0) {
      const unsigned b = smem_addr(bar);
      const unsigned bytes = static_cast<unsigned>(count) * 4u;
      asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" :: "r"(b)
                   : "memory");
      asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
      asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n"
                   :: "r"(b), "r"(bytes * n_src) : "memory");
      for (int k = 0; k < n_src; ++k)
        asm volatile(
            "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes"
            " [%0], [%1], %2, [%3];\n"
            :: "r"(smem_addr(dst + k * count)), "l"(src[k]), "r"(bytes),
               "r"(b) : "memory");
    }
  } else {
    for (int k = 0; k < n_src; ++k)
      for (int f = tid; f < count; f += nt)
        asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
                     :: "r"(smem_addr(dst + k * count + f)), "l"(src[k] + f)
                     : "memory");
  }
#else
  (void)bar;
  (void)bulk;
  for (int k = 0; k < n_src; ++k)
    for (int f = tid; f < count; f += nt) dst[k * count + f] = src[k][f];
#endif
}

// one float into shared memory, asynchronously (stage_done completes it)
__device__ __forceinline__ void copy_f32_async(float* dst, const float* src) {
#if defined(__CUDA_ARCH__)
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n"
               :: "r"(smem_addr(dst)), "l"(src) : "memory");
#else
  *dst = *src;
#endif
}

// the calling thread's part of the fallback copies landed
__device__ __forceinline__ void stage_done(bool bulk) {
#if defined(__CUDA_ARCH__)
  if (!bulk)
    asm volatile("cp.async.commit_group;\ncp.async.wait_group 0;\n" :::
                 "memory");
#else
  (void)bulk;
#endif
}

// the bulk copies landed (after a barrier that follows stage_issue)
__device__ __forceinline__ void stage_wait_bulk(unsigned long long* bar,
                                                bool bulk) {
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

// ---------------------------------------------------------------------------
// The cascade
// ---------------------------------------------------------------------------

// A stage's view of the block's shared state: the entry (i, j) of the padded
// benefit, from the stage's table for a live row, computed where it is read
// for a row with nothing live (-forbid + bias x noise: the rows of the
// square that hold no track of the stage's mask, which rarely bid)
struct Stage {
  const float* bene;         // the live rows' benefit, [n][n]
  const unsigned* rows;      // the stage's row mask words
  const unsigned* matched;   // rows matched by an earlier stage
  const float* price;
  int n;
  bool exclude;
  float bias, forbid;

  __device__ __forceinline__ bool row_live(int i) const {
    const unsigned w = rows[i >> 5] & (exclude ? ~matched[i >> 5] : kFull);
    return (w >> (i & 31)) & 1u;
  }
  __device__ __forceinline__ float benefit(int i, int j, bool live) const {
    return live ? bene[i * n + j]
                : -forbid + bias * noise_of(bias_hash(i, j));
  }
};

// A bid of row i, the warp's lanes splitting the columns: the first best
// column and the best and second-best values of benefit - price. Each lane
// scans its columns as the kernel's first design did (a 64-bit key of the
// value's order-preserving bits and the complemented column, the values
// beside the best folded into the second); three warp reductions merge
// them: the best key, then the second best as the largest of the best
// lane's second and the other lanes' bests, which is what the first
// design's shuffle merge gave (tests/test_torch_assoc_solvers.py holds the
// outputs to its OUTPUT_SHA256). The bid (price + (v1 - v2)) + eps and its
// slot key (the bid's order-preserving bits, the complemented row) in every
// lane.
__device__ __forceinline__ unsigned long long row_bid(const Stage& st, int i,
                                                      int lane, float eps,
                                                      int* col, float* bid) {
  unsigned long long best = 0ull;
  float second = -INFINITY;
  const bool live = st.row_live(i);
  for (int j = lane; j < st.n; j += 32) {
    const float v = (st.benefit(i, j, live) - st.price[j]) + 0.0f;
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
  const unsigned hi = static_cast<unsigned>(best >> 32);
  const unsigned lo = static_cast<unsigned>(best);
  const unsigned m_hi = __reduce_max_sync(kFull, hi);
  const unsigned m_lo = __reduce_max_sync(kFull, hi == m_hi ? lo : 0u);
  const bool holder = best != 0ull && hi == m_hi && lo == m_lo;
  const unsigned m2 = __reduce_max_sync(kFull,
                                        holder ? ordered_bits(second) : hi);
  const int top1 = static_cast<int>(~m_lo);
  const float v1 = from_ordered(m_hi);
  const float v2 = m2 ? from_ordered(m2) : -INFINITY;
  const float b = (st.price[top1] + (v1 - (isfinite(v2) ? v2 : v1))) + eps;
  *col = top1;
  *bid = b;
  return static_cast<unsigned long long>(ordered_bits(b)) << 32
      | static_cast<unsigned>(~i);
}

// one block an SM: ptxas then keeps the kernel in 49 registers without a
// spill (left free, it packs two blocks an SM into 32 registers and spills)
__global__ void __launch_bounds__(kCascadeThreads, 1)
cascade_auction_kernel(CascadeParams p) {
  // the stage's benefit table [n][n] (rounded up to 16 bytes), then the
  // costs [n_costs][R][C]
  extern __shared__ float4 smem_v[];
  float* bene = reinterpret_cast<float*>(smem_v);
  float* cost_s = bene + ((p.n * p.n + 3) & ~3);
  __shared__ float price[kMaxN], vmax[kMaxN], zmax[kMaxN];
  __shared__ int owner[kMaxN], final_c4r[kMaxN];
  __shared__ unsigned long long slot[kMaxN];
  __shared__ unsigned finite[kMaxN * kMaxWords];
  __shared__ unsigned stage_rows[kMaxStages * kMaxWords];
  __shared__ unsigned col_ok[kMaxWords], matched[kMaxWords];
  __shared__ unsigned alive_rows[kMaxWords], alive_cols[kMaxWords];
  __shared__ unsigned unassigned[kMaxWords];
  __shared__ unsigned long long bar;

  const int s = blockIdx.x, tid = threadIdx.x, nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  const int R = p.rows, C = p.cols, n = p.n, W = p.words;
  // the finals launch behind this one may start its blocks now; they wait
  // for this grid's end before reading what it writes
  cudaTriggerProgrammaticLaunchCompletion();

  // both costs into shared memory, while the block does the rest of its
  // set-up
  const size_t rc = static_cast<size_t>(R) * C;
  const float* src[2] = {p.cost[0] + s * rc,
                         p.n_costs > 1 ? p.cost[1] + s * rc : nullptr};
  bool bulk = (rc * 4) % 16 == 0;   // (cost_s is 16-byte aligned)
  for (int k = 0; k < p.n_costs; ++k)
    bulk = bulk && (reinterpret_cast<uintptr_t>(src[k]) & 15u) == 0;
  stage_issue(cost_s, src, p.n_costs, static_cast<int>(rc), &bar, bulk);

  // the stages' row masks, u_det and col4row as bit words
  for (int t = warp; t < p.n_stages * W; t += n_warps) {
    const int k = t / W, q = t - k * W, i = q * 32 + lane;
    const unsigned char* m = p.mask[k];
    const bool on = i < R && (!m || m[static_cast<size_t>(s) * R + i]);
    const unsigned bits = __ballot_sync(kFull, on);
    if (lane == 0) stage_rows[k * kMaxWords + q] = bits;
  }
  for (int q = warp; q < W; q += n_warps) {
    const int x = q * 32 + lane;
    const bool open = x < C && (!p.u_det_in
                                || p.u_det_in[static_cast<size_t>(s) * C + x]);
    const int c4r = (x < R && p.col4row_in)
        ? p.col4row_in[static_cast<size_t>(s) * R + x] : -1;
    if (x < n) {
      final_c4r[x] = c4r;
      slot[x] = 0ull;
    }
    const unsigned open_bits = __ballot_sync(kFull, open);
    const unsigned matched_bits = __ballot_sync(kFull, c4r >= 0);
    if (lane == 0) {
      col_ok[q] = open_bits;
      matched[q] = matched_bits;
      alive_rows[q] = alive_cols[q] = unassigned[q] = 0u;
    }
  }
  // each row's largest noise (the benefit of a row with nothing allowed is
  // -forbid + bias x noise, monotone in the hash), and whether the all-dead
  // square's pre-assignment (row i onto column i) survives every phase's
  // eps-CS check
  int ident = 1;
  for (int i = warp; i < n; i += n_warps) {
    unsigned h_max = 0u;
    for (int j = lane; j < n; j += 32) {
      const unsigned h = bias_hash(i, j);
      h_max = h > h_max ? h : h_max;
    }
    h_max = __reduce_max_sync(kFull, h_max);
    if (lane == 0) {
      const float z_max = -p.forbid + p.bias * noise_of(h_max);
      const float z_ii = -p.forbid + p.bias * noise_of(bias_hash(i, i));
      zmax[i] = z_max;
      float eps = 0.5f;
      for (int ph = 0; ph < p.n_phases; ++ph, eps *= 0.125f)
        ident &= z_ii >= z_max - eps;
    }
  }
  stage_done(bulk);
  ident = __syncthreads_and(ident);
  bool staged = false;   // the bulk copies waited for

  for (int k = 0; k < p.n_stages; ++k) {
    Stage st;
    const float* cost = cost_s + p.cost_of[k] * rc;
    st.bene = bene;
    st.rows = stage_rows + k * kMaxWords;
    st.matched = matched;
    st.price = price;
    st.n = n;
    st.exclude = p.exclude[k] != 0;
    st.bias = p.bias;
    st.forbid = p.forbid;
    const size_t out_at = (static_cast<size_t>(s) * p.n_stages + k)
        * p.n_phases;

    // a stage with no live row: the square is all dead, and the
    // pre-assignment of row i onto column i keeps every column in every
    // phase, so no round runs and nothing is matched
    bool any_row = false;
    for (int q = 0; q < W; ++q)
      any_row |= (st.rows[q] & (st.exclude ? ~matched[q] : kFull)) != 0u;
    if (!any_row && ident) {
      if (tid == 0)
        for (int ph = 0; ph < p.n_phases; ++ph) {
          if (p.rounds_out) p.rounds_out[out_at + ph] = 0;
          if (p.bids_out) p.bids_out[out_at + ph] = 0;
        }
      if (p.row4col_out)
        for (int j = tid; j < C; j += nt)
          p.row4col_out[static_cast<size_t>(s) * C + j] = -1;
      continue;
    }

    // a warp a live row: its benefit (-min(cost, forbid) on an open
    // column, -forbid elsewhere, plus bias x noise) into the stage's table,
    // its words of allowed entries, its best benefit, whether it has an
    // entry other than forbid at all (a vote of the block, so that no thread
    // reads a word the next stage may be writing)
    if (!staged) {
      stage_wait_bulk(&bar, bulk);
      staged = true;
    }
    int any_odd = 0;
    for (int i = warp; i < n; i += n_warps) {
      if (!st.row_live(i)) continue;
      float m = -INFINITY;
      unsigned any = 0u, odd = 0u;
      for (int q = 0; q < W; ++q) {
        const int j = q * 32 + lane;
        float v = p.forbid;
        if (j < n) {
          if (bit_of(col_ok, j)) {
            const float c = cost[i * C + j];
            v = c > p.forbid ? p.forbid : c;
          }
          const float b = -v + p.bias * noise_of(bias_hash(i, j));
          bene[i * n + j] = b;
          m = fmaxf(m, b);
        }
        const unsigned fin = __ballot_sync(kFull, j < n && v < p.forbid);
        odd |= __ballot_sync(kFull, j < n && !(v == p.forbid));
        if (lane == 0) {
          finite[i * kMaxWords + q] = fin;
          if (fin) atomicOr(&alive_cols[q], fin);
        }
        any |= fin;
      }
      // fmaxf over the lanes (no lane's m is NaN, nor -0)
      m = from_ordered(__reduce_max_sync(kFull, ordered_bits(m)));
      if (lane == 0) {
        vmax[i] = m;
        if (any) atomicOr(&alive_rows[i >> 5], 1u << (i & 31));
      }
      any_odd |= odd != 0u;
    }
    any_odd = __syncthreads_or(any_odd);

    if (!any_odd && ident) {
      // live rows, but every entry of theirs forbid: as above
      if (tid == 0)
        for (int ph = 0; ph < p.n_phases; ++ph) {
          if (p.rounds_out) p.rounds_out[out_at + ph] = 0;
          if (p.bids_out) p.bids_out[out_at + ph] = 0;
        }
      if (p.row4col_out)
        for (int j = tid; j < C; j += nt)
          p.row4col_out[static_cast<size_t>(s) * C + j] = -1;
      continue;
    }

    // dead rows onto dead columns, the k-th onto the k-th, ascending; phase
    // 0's eps-CS check of those owners (its prices are 0); the rows left
    // unassigned
    const Words dead_r{alive_rows, n, true}, dead_c{alive_cols, n, true};
    const int n_dead_rows = count_bits(dead_r, W);
    const int n_dead_cols = count_bits(dead_c, W);
    for (int x0 = warp * 32; x0 < n; x0 += n_warps * 32) {
      const int x = x0 + lane;
      bool open = false;
      if (x < n) {
        price[x] = 0.0f;
        int own = -1;
        if (bit_of(dead_c, x)) {
          const int r = rank_of(dead_c, x);
          if (r < n_dead_rows) own = nth_set(dead_r, W, r);
        }
        if (own >= 0 && p.n_phases > 0) {
          const float rv = st.row_live(own) ? vmax[own] : zmax[own];
          if (!(st.benefit(own, x, st.row_live(own)) >= rv - 0.5f)) {
            atomicOr(&unassigned[own >> 5], 1u << (own & 31));
            own = -1;
          }
        }
        owner[x] = own;
        open = !bit_of(dead_r, x) || rank_of(dead_r, x) >= n_dead_cols;
      }
      const unsigned open_bits = __ballot_sync(kFull, open);
      if (lane == 0 && open_bits) atomicOr(&unassigned[x0 >> 5], open_bits);
    }
    __syncthreads();

    float eps = 0.5f;
    for (int ph = 0; ph < p.n_phases; ++ph, eps *= 0.125f) {
      if (ph > 0) {
        // price reset; owners that break eps-CS at price 0 let go
        for (int j = tid; j < n; j += nt) {
          price[j] = 0.0f;
          const int i = owner[j];
          if (i >= 0) {
            const bool live = st.row_live(i);
            const float rv = live ? vmax[i] : zmax[i];
            if (!(st.benefit(i, j, live) >= rv - eps)) {
              owner[j] = -1;
              atomicOr(&unassigned[i >> 5], 1u << (i & 31));
            }
          }
        }
        __syncthreads();
      }
      int u = count_bits(unassigned, W);
      int rounds = 0, bids = 0;
      // rounds of two bidders or more: a warp a bidder, a thread a column
      while (u > 1 && rounds < p.round_cap) {
        for (int i = warp; i < n; i += n_warps) {
          if (!bit_of(unassigned, i)) continue;
          int col;
          float bid;
          const unsigned long long key = row_bid(st, i, lane, eps, &col,
                                                 &bid);
          if (lane == 0) atomicMax(&slot[col], key);
        }
        __syncthreads();
        for (int j = tid; j < n; j += nt) {
          const unsigned long long b = slot[j];
          if (b) {
            slot[j] = 0ull;
            const int i = static_cast<int>(~static_cast<unsigned>(b));
            const int prev = owner[j];
            if (prev >= 0) atomicOr(&unassigned[prev >> 5], 1u << (prev & 31));
            atomicAnd(&unassigned[i >> 5], ~(1u << (i & 31)));
            owner[j] = i;
            price[j] = from_ordered(static_cast<unsigned>(b >> 32));
          }
        }
        bids += u;
        ++rounds;
        __syncthreads();
        u = count_bits(unassigned, W);
      }
      // a lone bidder always wins, and the owner it displaces is the next
      // round's lone bidder: warp 0 runs that chain alone, without the
      // words, until a free column is taken or the cap. Every warp has read
      // u before warp 0 changes the words (the first barrier), and all meet
      // at the phase's end before the next reset writes them again.
      if (u == 1 && rounds < p.round_cap) {
        __syncthreads();
        if (warp == 0) {
          int i = nth_set(unassigned, W, 0);
          while (i >= 0 && rounds < p.round_cap) {
            int col;
            float bid;
            row_bid(st, i, lane, eps, &col, &bid);
            const int prev = owner[col];
            __syncwarp();
            if (lane == 0) {
              owner[col] = i;
              price[col] = bid;
            }
            __syncwarp();
            ++bids;
            ++rounds;
            i = prev;
          }
          if (lane < W)
            unassigned[lane] = (i >= 0 && (i >> 5) == lane)
                ? 1u << (i & 31) : 0u;
        }
      }
      __syncthreads();
      if (tid == 0) {
        if (p.rounds_out) p.rounds_out[out_at + ph] = rounds;
        if (p.bids_out) p.bids_out[out_at + ph] = bids;
      }
    }

    // pairs on forbidden or padded entries dropped; the matches absorbed;
    // the stage's scratch words cleared for the next
    for (int j = tid; j < n; j += nt) {
      const int i = owner[j];
      const bool ok = i >= 0 && st.row_live(i)
          && ((finite[i * kMaxWords + (j >> 5)] >> (j & 31)) & 1u);
      if (p.row4col_out && j < C)
        p.row4col_out[static_cast<size_t>(s) * C + j] = ok ? i : -1;
      if (ok) {
        final_c4r[i] = j;
        atomicAnd(&col_ok[j >> 5], ~(1u << (j & 31)));
        atomicOr(&matched[i >> 5], 1u << (i & 31));
      }
    }
    if (tid < W) alive_rows[tid] = alive_cols[tid] = unassigned[tid] = 0u;
    __syncthreads();
  }

  if (!staged) stage_wait_bulk(&bar, bulk);   // no copy outlives the block
  if (p.u_det_out)
    for (int j = tid; j < C; j += nt)
      p.u_det_out[static_cast<size_t>(s) * C + j] = bit_of(col_ok, j);
  for (int i = tid; i < R; i += nt)
    p.col4row_out[static_cast<size_t>(s) * R + i] = final_c4r[i];
}

// ---------------------------------------------------------------------------
// The greedy matches
// ---------------------------------------------------------------------------

// torch.maximum / torch.minimum of two floats (a NaN wins)
__device__ __forceinline__ float nan_max(float a, float b) {
  return (a != a || a > b) ? a : b;
}

__device__ __forceinline__ float nan_min(float a, float b) {
  return (a != a || a < b) ? a : b;
}

// ops/geometry.py's area: (x2 - x1 + 1) (y2 - y1 + 1), 0 when degenerate
__device__ __forceinline__ float box_area(const float* t) {
  const float w = (t[2] - t[0]) + 1.0f, h = (t[3] - t[1]) + 1.0f;
  return (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
}

// 1 - bbox_ious(a, b) in its order of operations (_inter_area, area, the
// union, the guarded quotient), each step rounded on its own
__device__ __forceinline__ float iou_dist(const float* a, const float* b) {
  const float w = (nan_min(a[2], b[2]) - nan_max(a[0], b[0])) + 1.0f;
  const float h = (nan_min(a[3], b[3]) - nan_max(a[1], b[1])) + 1.0f;
  const float inter = (w > 0.0f && h > 0.0f) ? w * h : 0.0f;
  const float uni = (box_area(a) + box_area(b)) - inter;
  const float iou = inter > 0.0f ? inter / (uni > 0.0f ? uni : 1.0f) : 0.0f;
  return 1.0f - iou;
}

__device__ __forceinline__ unsigned long long umin64(unsigned long long a,
                                                     unsigned long long b) {
  return b < a ? b : a;
}

// the least 64-bit key of the warp: the least high word, then the least
// low word beside it
__device__ __forceinline__ unsigned long long warp_min64(unsigned long long v) {
  const unsigned hi = static_cast<unsigned>(v >> 32);
  const unsigned m_hi = __reduce_min_sync(kFull, hi);
  const unsigned m_lo = __reduce_min_sync(
      kFull, hi == m_hi ? static_cast<unsigned>(v) : ~0u);
  return static_cast<unsigned long long>(m_hi) << 32 | m_lo;
}

// row i's least key (cost bits, flat index) over the live columns, the
// warp's lanes splitting them
__device__ __forceinline__ unsigned long long greedy_row_min(
    const float* cost, int ld, const unsigned char* col_live, int i, int C,
    int lane) {
  unsigned long long best = ~0ull;
  for (int j = lane; j < C; j += 32)
    if (col_live[j])
      best = umin64(best,
                    static_cast<unsigned long long>(ordered_bits(
                        cost[static_cast<size_t>(i) * ld + j] + 0.0f)) << 32
                    | static_cast<unsigned>(i * C + j));
  return warp_min64(best);
}

// the least keys of rows[0 .. k) (k <= 4) at once, the warp's lanes
// splitting the columns; lane 0 writes them to row_min
__device__ __forceinline__ void greedy_rows_min(
    const float* cost, int ld, const unsigned char* col_live,
    const int* rows, int k, int C, int lane, unsigned long long* row_min) {
  unsigned long long best[4] = {~0ull, ~0ull, ~0ull, ~0ull};
  for (int j = lane; j < C; j += 32) {
    if (!col_live[j]) continue;
#pragma unroll
    for (int r = 0; r < 4; ++r)
      if (r < k)
        best[r] = umin64(best[r],
                         static_cast<unsigned long long>(ordered_bits(
                             cost[static_cast<size_t>(rows[r]) * ld + j]
                             + 0.0f)) << 32
                         | static_cast<unsigned>(rows[r] * C + j));
  }
#pragma unroll
  for (int r = 0; r < 4; ++r)
    if (r < k) {
      const unsigned long long m = warp_min64(best[r]);
      if (lane == 0) row_min[rows[r]] = m;
    }
}

__global__ void __launch_bounds__(kGreedyThreads)
greedy_match_kernel(GreedyParams p) {
  extern __shared__ float4 staged_v[];   // the staged costs, [R][C + 1]
  float* staged = reinterpret_cast<float*>(staged_v);
  __shared__ unsigned char row_live[kMaxGreedy], col_live[kMaxGreedy];
  __shared__ unsigned long long row_min[kMaxGreedy];
  __shared__ float boxes[2 * kMaxN * 4];            // the finals' rectify boxes
  __shared__ int live_counts[2];

  const int s = blockIdx.x, y = blockIdx.y, tid = threadIdx.x,
            nt = blockDim.x;
  const int lane = tid & 31, warp = tid >> 5, n_warps = nt >> 5;
  if (tid < 2) live_counts[tid] = 0;
  __syncthreads();

  int R, C;
  float max_cost;
  const float* cost = nullptr;   // in shared or device memory
  int ld;
  int* row4col;
  int* col4row;
  bool rect = false;
  if (p.finals) {
    // the finals: wait for the cascade's outputs (programmatic launch)
    cudaGridDependencySynchronize();
    const FinalsParams& f = p.fin;
    const int T = f.tracks, D = f.dets, H = f.hist;
    const size_t st = static_cast<size_t>(s) * T,
                 sd = static_cast<size_t>(s) * D;
    int n_r = 0, n_c = 0;
    if (y == 0) {
      // reID: the history store against the unmatched confident
      // detections that are not occluded
      R = H;
      C = D;
      max_cost = f.max_reid;
      row4col = nullptr;
      col4row = f.reid_c4r + static_cast<size_t>(s) * H;
      for (int h = tid; h < H; h += nt) {
        row_live[h] = f.h_reid_ok[static_cast<size_t>(s) * H + h];
        n_r += row_live[h];
      }
      for (int d = tid; d < D; d += nt) {
        const bool conf = f.u_det[sd + d] && f.d_conf[sd + d] >= f.conf_thresh;
        f.u_det_conf[sd + d] = conf;
        col_live[d] = conf && !f.occluded[sd + d];
        n_c += col_live[d];
      }
      cost = f.reid_cost + static_cast<size_t>(s) * H * D;
      ld = D;
    } else {
      // rectify: active unmatched confirmed tracks against inactive matched
      // ones, through the boxes of their detections
      R = C = T;
      rect = true;
      max_cost = f.dup_gate;
      row4col = nullptr;
      col4row = f.rect_c4r + st;
      for (int i = tid; i < T; i += nt) {
        const int c4r = f.col4row[st + i];
        const bool active = f.ages[st + i] < 2;
        row_live[i] = f.t_valid[st + i] && f.hits[st + i] >= f.confirm_hits
            && active && c4r < 0;
        col_live[i] = c4r >= 0 && !active;
        n_r += row_live[i];
        n_c += col_live[i];
        const float* t = f.tlbrs + (st + i) * 4;
        const float* d = f.d_tlbrs + (sd + (c4r >= 0 ? c4r : 0)) * 4;
        for (int e = 0; e < 4; ++e) {
          boxes[i * 4 + e] = t[e];
          boxes[(kMaxN + i) * 4 + e] = d[e];
        }
      }
      ld = C + 1;
    }
    if (n_r) atomicAdd(&live_counts[0], n_r);
    if (n_c) atomicAdd(&live_counts[1], n_c);
  } else {
    const GreedyProblem& q = p.prob[y];
    R = q.rows;
    C = q.cols;
    max_cost = q.max_cost;
    row4col = q.row4col ? q.row4col + static_cast<size_t>(s) * C : nullptr;
    col4row = q.col4row + static_cast<size_t>(s) * R;
    int n_r = 0, n_c = 0;
    for (int i = tid; i < R; i += nt) {
      row_live[i] = q.row_valid[static_cast<size_t>(s) * R + i];
      n_r += row_live[i];
    }
    for (int j = tid; j < C; j += nt) {
      col_live[j] = q.col_valid[static_cast<size_t>(s) * C + j];
      n_c += col_live[j];
    }
    if (n_r) atomicAdd(&live_counts[0], n_r);
    if (n_c) atomicAdd(&live_counts[1], n_c);
    cost = q.cost + static_cast<size_t>(s) * R * C;
    ld = C;
  }
  for (int i = tid; i < R; i += nt) col4row[i] = -1;
  if (row4col)
    for (int j = tid; j < C; j += nt) row4col[j] = -1;
  __syncthreads();
  if (!live_counts[0] || !live_counts[1]) return;   // nothing to match

  // the live rows' costs into shared memory: the rectify cost computed
  // there, a given cost copied (when it fits; else read where it lies)
  if (rect) {
    for (int t = warp; t < R; t += n_warps) {
      if (!row_live[t]) continue;
      for (int k = lane; k < C; k += 32)
        if (col_live[k])
          staged[t * ld + k] = iou_dist(boxes + t * 4, boxes + (kMaxN + k) * 4);
    }
    cost = staged;
    __syncthreads();
  } else if (R * (C + 1) <= kGreedyStage) {
    for (int t = warp; t < R; t += n_warps) {
      if (!row_live[t]) continue;
      for (int j = lane; j < C; j += 32)
        copy_f32_async(staged + t * (C + 1) + j,
                       cost + static_cast<size_t>(t) * C + j);
    }
    stage_done(false);
    cost = staged;
    ld = C + 1;
    __syncthreads();
  }

  // each live row's least key
  for (int i = warp; i < R; i += n_warps) {
    const unsigned long long m = row_live[i]
        ? greedy_row_min(cost, ld, col_live, i, C, lane) : ~0ull;
    if (lane == 0) row_min[i] = m;
  }
  __syncthreads();
  if (warp != 0) return;

  // the rounds, on warp 0: lane l keeps the least key of rows l, l + 32, ...
  auto lane_min = [&]() {
    unsigned long long m = ~0ull;
    for (int i = lane; i < R; i += 32) m = umin64(m, row_min[i]);
    return m;
  };
  unsigned long long mine = lane_min();
  for (;;) {
    const unsigned long long best = warp_min64(mine);
    if (best == ~0ull) break;
    if (!(from_ordered(static_cast<unsigned>(best >> 32)) <= max_cost)) break;
    const int f = static_cast<int>(static_cast<unsigned>(best));
    const int bi = f / C, bj = f - bi * C;
    if (lane == 0) {
      col4row[bi] = bj;
      if (row4col) row4col[bj] = bi;
      row_min[bi] = ~0ull;
      row_live[bi] = 0;
      col_live[bj] = 0;
    }
    __syncwarp();
    // the rows whose least key sat in column bj, scanned again by the
    // warp four at a time, 128 rows after another: their four words'
    // votes first, then their rescans (a rescan changes only its own row's
    // key, so no vote of a later 128 rows sees it)
    for (int base = 0; base < R; base += kMaxN) {
      unsigned again[kMaxWords];
#pragma unroll
      for (int t = 0; t < kMaxWords; ++t) {
        const int i = base + t * 32 + lane;
        const unsigned long long m = i < R ? row_min[i] : ~0ull;
        again[t] = __ballot_sync(
            kFull, m != ~0ull
            && static_cast<int>(static_cast<unsigned>(m)) - i * C == bj);
      }
#pragma unroll
      for (int t = 0; t < kMaxWords; ++t) {
        while (again[t]) {
          int rows[4] = {0, 0, 0, 0};
          int k = 0;
#pragma unroll
          for (int r = 0; r < 4; ++r)
            if (again[t]) {
              rows[r] = base + t * 32 + __ffs(static_cast<int>(again[t])) - 1;
              again[t] &= again[t] - 1u;
              k = r + 1;
            }
          greedy_rows_min(cost, ld, col_live, rows, k, C, lane, row_min);
        }
      }
    }
    __syncwarp();
    mine = lane_min();
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
  p.n_costs = p.cost[1] ? 2 : 1;
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
    if (p.cost_of[k] < 0 || p.cost_of[k] >= p.n_costs)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  if (!p.cost[0] || !p.col4row_out)
    return static_cast<int>(cudaErrorInvalidValue);
  const int smem = (((p.n * p.n + 3) & ~3) + p.n_costs * p.rows * p.cols)
      * static_cast<int>(sizeof(float));
  if (smem > 48 * 1024) {    // above the static limit: ask for it
    const cudaError_t e = cudaFuncSetAttribute(
        cascade_auction_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
        smem);
    if (e != cudaSuccess) return static_cast<int>(e);
  }
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_streams);
  cascade_auction_kernel<<<grid, kCascadeThreads, smem, st>>>(p);
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
        || !q.col4row)
      return static_cast<int>(cudaErrorInvalidValue);
  }
  const int smem = kGreedyStage * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  const cudaStream_t st = static_cast<cudaStream_t>(stream);
  const dim3 grid(n_streams, n_problems);
  greedy_match_kernel<<<grid, kGreedyThreads, smem, st>>>(p);
  return static_cast<int>(cudaGetLastError());
}

// One call of the finals for ints[kFStreams] streams: the masks of
// tracker.finals_reference, the rectify cost, and both greedy matches, in
// one launch (a block a stream and problem) that may start while the
// launch before it on `stream` runs (programmatic dependent launch) and
// reads its inputs after that launch has ended. `ptrs` holds the FinalsPtr
// enum's pointers, `ints` the FinalsInt enum's values, `floats` the
// FinalsFloat enum's. Returns 0 or the first cudaError_t.
int finals_forward(const void* const* ptrs, const int* ints,
                   const float* floats, void* stream) {
  GreedyParams p = {};
  p.finals = 1;
  FinalsParams& f = p.fin;
  const int n_streams = ints[kFStreams];
  f.tracks = ints[kFTracks];
  f.dets = ints[kFDets];
  f.hist = ints[kFHist];
  f.confirm_hits = ints[kFConfirmHits];
  f.conf_thresh = floats[kFConfThresh];
  f.max_reid = floats[kFMaxReid];
  f.dup_gate = floats[kFDupGate];
  if (n_streams < 1 || f.tracks < 1 || f.tracks > kMaxN || f.dets < 1
      || f.dets > kMaxGreedy || f.hist < 1 || f.hist > kMaxGreedy)
    return static_cast<int>(cudaErrorInvalidValue);
  for (int k = 0; k < kFPtrs; ++k)
    if (!ptrs[k]) return static_cast<int>(cudaErrorInvalidValue);
  f.tlbrs = static_cast<const float*>(ptrs[kFTlbrs]);
  f.t_valid = static_cast<const unsigned char*>(ptrs[kFTValid]);
  f.ages = static_cast<const int*>(ptrs[kFAges]);
  f.hits = static_cast<const int*>(ptrs[kFHits]);
  f.d_tlbrs = static_cast<const float*>(ptrs[kFDTlbrs]);
  f.d_conf = static_cast<const float*>(ptrs[kFDConf]);
  f.reid_cost = static_cast<const float*>(ptrs[kFReidCost]);
  f.h_reid_ok = static_cast<const unsigned char*>(ptrs[kFHReidOk]);
  f.occluded = static_cast<const unsigned char*>(ptrs[kFOccluded]);
  f.u_det = static_cast<const unsigned char*>(ptrs[kFUDet]);
  f.col4row = static_cast<const int*>(ptrs[kFCol4Row]);
  f.u_det_conf = static_cast<unsigned char*>(const_cast<void*>(
      ptrs[kFUDetConfOut]));
  f.reid_c4r = static_cast<int*>(const_cast<void*>(ptrs[kFReidOut]));
  f.rect_c4r = static_cast<int*>(const_cast<void*>(ptrs[kFRectOut]));
  const int smem = kGreedyStage * static_cast<int>(sizeof(float));
  cudaError_t e = cudaFuncSetAttribute(
      greedy_match_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, smem);
  if (e != cudaSuccess) return static_cast<int>(e);
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[0].val.programmaticStreamSerializationAllowed = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(n_streams, 2);
  cfg.blockDim = dim3(kGreedyThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = static_cast<cudaStream_t>(stream);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  e = cudaLaunchKernelEx(&cfg, greedy_match_kernel, p);
  if (e != cudaSuccess) return static_cast<int>(e);
  return static_cast<int>(cudaGetLastError());
}

// The message of a code an entry returned
const char* assoc_solvers_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
