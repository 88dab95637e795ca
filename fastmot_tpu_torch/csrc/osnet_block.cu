// One whole OSNet residual block (OSBlock) in a single CUDA kernel launch,
// designed for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel fastmot_tpu/ops/osnet_block.py:osblock_fused
// (_osblock_kernel). Its plain PyTorch twin, the weight packing and the
// launch plan are in fastmot_tpu_torch/ops/osnet_block.py.
//
// What bounds it on an H100. The block is ~30 dependent small layers over a
// [H*W, mid] plane (mid = 16..32 for OSNet-x0.25): conv1 1x1, four streams of
// 1..4 LiteConvs (1x1, depthwise 3x3, folded BN, ReLU), the aggregation gate
// (a global pool per stream), the gated sum, conv3 1x1 and the identity or
// its downsample 1x1. Read once and written once, the bytes set the bound
// (x in, the output out, the weights: 85.5 MB and 25.5 us for the six x0.25
// blocks at 64 crops); the FLOPs, 77 % of them in the 1x1s, are a quarter of
// it. What costs time is everything between: the dependent passes, their
// barriers, and any intermediate that leaves the SM.
//
// Design:
// - A thread block cluster per crop, one band of `rows` image rows per CTA
//   (cluster size and rows come from the Python launch plan; at 64 crops the
//   x0.25 blocks run 128 CTAs as clusters of 2).
// - The band's planes live in shared memory: y (conv1 output), two
//   ping-pong LiteConv 1x1 outputs za[0], za[1] and the depthwise output zb
//   (bf16, one row of mid channels per pixel, 16-byte chunks XOR-swizzled
//   so that ldmatrix and the 16-byte depthwise loads see no bank conflict),
//   and the f32 gated sum. Nothing but x, the weights and the output
//   touches device memory.
// - The depthwise reads the row above or below its band from the
//   neighbour CTA's za plane through distributed shared memory. Zero
//   padding applies only at the crop's edges. One cluster barrier after
//   each LiteConv 1x1 publishes za; since za ping-pongs, the next write to
//   a za plane comes after the next LiteConv's barrier, by which time every
//   neighbour has finished reading it.
// - The gate's pool: each CTA sums its band per channel in a fixed order,
//   the band sums are added across the cluster in rank order (no atomics:
//   the result is bitwise reproducible), and every CTA computes the same
//   gate. A last cluster barrier keeps every CTA's shared memory alive
//   until its neighbours are done with it.
// - The 1x1 convolutions run on tensor cores: mma.sync m16n8k16 bf16 -> f32,
//   pixels as M, output channels as N, input channels as K (zero-padded to
//   a multiple of 16). A comes from the planes or the staged x by
//   ldmatrix; B comes from the packed weight buffer,
//   which stores each 16x8 tile in fragment order (one 8-byte load a lane).
//   The f32 sums are rounded to bf16 where the plain version rounds.
// - The weights are copied once into shared memory where the plan has room
//   beside the planes (every x0.25 block: 18-76 KB), so no weight load in
//   the dependent chain waits on L2; otherwise (OSNet-x1.0, up to 1.2 MB a
//   block) they are read through L1 from device memory.
// - x is copied into the free planes twice (cp.async, all in flight at
//   once), for conv1 and for conv3's downsample or identity, so the
//   1x1s read it by ldmatrix and no warp waits on device memory in turn.
// - The depthwise 3x3, the folded BN, the gate and the gated sum run in f32
//   on CUDA cores, 8 channels (16 bytes) a thread. The depthwise thread
//   slides a 3x3 window down a run of rows of one column, so it loads each
//   input pixel once, and sums the taps in the plain version's (dy, dx)
//   order with FMAs; the gated sum adds the streams in stream order with
//   the plain version's separate multiply and add.
// - The output leaves through a per-warp staging tile in 16-byte stores.
//
// Rounding points follow the TPU kernel: bf16 after each 1x1 conv, inside
// the folded BN (bf16 multiply, bf16 add), on each LiteConv output and on
// the gated sum before conv3. What differs from the plain version: the f32
// summation order inside each 1x1 (tensor cores) and the pool, and the
// BNs' and the residual's bf16 adds, which round the exact sum once where
// the plain version rounds an f32 sum (the same value unless that f32 sum
// was inexact). The depthwise's FMAs give the plain version's multiply
// then add exactly: the product of two bf16 values is exact in f32.
//
// Layouts: x [B, H, W, C_in] bf16 and out [B, H, W, F] bf16 (NHWC, as the
// JAX package). Weights: `frag`, the 1x1 matrices as bf16 16x8 tiles in
// mma fragment order, and `vec`, the BN scales and shifts (bf16 values held
// as f32), the depthwise taps and the gate in f32 (FragLayout, VecLayout).

#include <cooperative_groups.h>
#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kChunkF = 32;   // output channels per conv3 epilogue chunk
constexpr int kMaxCluster = 8;

// Offsets, in 16x8 tiles of 32 lanes x 4 bf16, of each 1x1 matrix in frag.
// A matrix [K, N] is stored as tiles [N/8][K16/16] (K16: K rounded up to 16).
// LiteConv i's wp is at lite + i * lite_stride. (No arrays: a kernel
// parameter indexed at run time would be copied to local memory.)
struct FragLayout {
  int w1, lite, lite_stride, w3, wd, total;
};

__host__ __device__ inline FragLayout frag_layout(int cin, int features,
                                                  int mid) {
  const int kt_mid = (mid + 15) / 16;
  FragLayout L;
  int o = 0;
  L.w1 = o; o += (mid / 8) * (cin / 16);
  L.lite = o;
  L.lite_stride = (mid / 8) * kt_mid;
  o += 10 * L.lite_stride;
  L.w3 = o; o += (features / 8) * kt_mid;
  if (cin != features) {
    L.wd = o; o += (features / 8) * (cin / 16);
  } else {
    L.wd = -1;
  }
  L.total = o;
  return L;
}

// Float offsets of the vectors in vec; LiteConv i's dw [9][mid], sc [mid]
// and sh [mid] are at lite + i * 11 * mid.
struct VecLayout {
  int sc1, sh1, lite, gw1, gb1, gw2, gb2, sc3, sh3, scd, shd, total;
};

__host__ __device__ inline VecLayout vec_layout(int cin, int features,
                                                int mid, int hid) {
  VecLayout L;
  int o = 0;
  L.sc1 = o; o += mid;
  L.sh1 = o; o += mid;
  L.lite = o; o += 10 * 11 * mid;
  L.gw1 = o; o += mid * hid;
  L.gb1 = o; o += hid;
  L.gw2 = o; o += hid * mid;
  L.gb2 = o; o += mid;
  L.sc3 = o; o += features;
  L.sh3 = o; o += features;
  if (cin != features) {
    L.scd = o; o += features;
    L.shd = o; o += features;
  } else {
    L.scd = L.shd = -1;
  }
  L.total = o;
  return L;
}

// Byte offsets of one CTA's shared memory for a band of `pix` pixels:
// planes y, za[0], za[1], zb (bf16 [pix, mid]) at k * plane, the f32 gated
// sum, the pool's partial sums (later the per-warp output staging tiles),
// the small vectors (band sums [2][mid], pooled, gate [mid], hidden [hid],
// the pool's second-level sums [kThreads])
// and, when the plan stages them (frag_n, vec_n > 0), the weights.
// fastmot_tpu_torch/ops/osnet_block.py:smem_bytes computes the same total.
struct SmemLayout {
  int plane, gacc, red, stage, vec, wfrag, wvec, total;
};

__host__ __device__ inline int round16(int n) { return (n + 15) / 16 * 16; }

__host__ __device__ inline SmemLayout smem_layout(int pix, int mid, int hid,
                                                  int frag_n, int vec_n) {
  SmemLayout S;
  S.plane = pix * mid * 2;
  S.gacc = 4 * S.plane;
  S.red = S.gacc + pix * mid * 4;
  S.stage = S.red;   // the pool's partial sums are dead by the epilogue
  const int red = round16((kThreads / (mid / 8)) * mid * 4);
  const int stage = kWarps * 16 * kChunkF * 2;
  S.vec = S.red + (red > stage ? red : stage);
  S.wfrag = S.vec + round16((5 * mid + hid + kThreads) * 4);
  S.wvec = S.wfrag + frag_n * 2;
  S.total = S.wvec + round16(vec_n * 4);
  return S;
}

// Physical 16-byte chunk of logical chunk `c` in plane row `row`, for rows
// of CH8 chunks: the XOR spreads the 8 rows an ldmatrix (or 8 threads of a
// 16-byte access) touches over the 8 bank groups of 16 bytes.
template <int CH8>
__device__ __forceinline__ int swz(int row, int c) {
  constexpr int low = CH8 & -CH8;
  constexpr int span = low < 8 ? low : 8;
  constexpr int period = 8 / span;
  return c ^ ((row / period) & (span - 1));
}

template <int CH8>
__device__ __forceinline__ unsigned char* chunk_ptr(unsigned char* plane,
                                                    int row, int c) {
  return plane + row * (CH8 * 16) + swz<CH8>(row, c) * 16;
}

__device__ __forceinline__ float2 unpack2(__nv_bfloat162 v) {
  const uint32_t u = *reinterpret_cast<const uint32_t*>(&v);
  return make_float2(__uint_as_float(u << 16), __uint_as_float(u & 0xffff0000u));
}

// Folded inference BN as the TPU kernel computes it in bf16, on a pair of
// channels: bf16(bf16(bf16(acc) * scale) + shift). The product is formed
// in f32 (exact for two bf16 values) and rounded on its own: written as a
// bf16 multiply and add, the compiler fuses the two into one bf16 FMA,
// which rounds once and moves many of a block's outputs off the plain
// version's by a bf16 ulp.
__device__ __forceinline__ __nv_bfloat162 bn2(float acc0, float acc1,
                                              __nv_bfloat162 scale,
                                              __nv_bfloat162 shift) {
  const float2 a = unpack2(__floats2bfloat162_rn(acc0, acc1));
  const float2 s = unpack2(scale);
  return __hadd2(__floats2bfloat162_rn(a.x * s.x, a.y * s.y), shift);
}

__device__ __forceinline__ __nv_bfloat162 relu2(__nv_bfloat162 v) {
  return __hmax2(v, __float2bfloat162_rn(0.f));
}

__device__ __forceinline__ uint32_t bits(__nv_bfloat162 v) {
  return *reinterpret_cast<const uint32_t*>(&v);
}

// The bf16 pair (c, c + 1) of an f32 vector.
__device__ __forceinline__ __nv_bfloat162 pair(const float* v, int c) {
  return __floats2bfloat162_rn(v[c], v[c + 1]);
}

__device__ __forceinline__ uint32_t pack2(float lo, float hi) {
  return bits(__floats2bfloat162_rn(lo, hi));
}

__device__ __forceinline__ void unpack8(const uint4& v, float f[8]) {
  const uint32_t u[4] = {v.x, v.y, v.z, v.w};
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    f[2 * i] = __uint_as_float(u[i] << 16);
    f[2 * i + 1] = __uint_as_float(u[i] & 0xffff0000u);
  }
}

__device__ __forceinline__ uint4 pack8(const float f[8]) {
  return make_uint4(pack2(f[0], f[1]), pack2(f[2], f[3]),
                    pack2(f[4], f[5]), pack2(f[6], f[7]));
}

// d += a (16x16 bf16, row-major) * b (16x8 bf16, column-major), f32.
// Not volatile: it has no side effect, so the compiler may interleave it
// with independent work.
__device__ __forceinline__ void mma_bf16(float d[4], const uint32_t a[4],
                                         const uint2& b) {
  asm(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b.x), "r"(b.y));
}

// A fragment of pixels p0..p0+15, channels 16*kt.. of a plane, by
// ldmatrix. Channels past the plane's MID (MID = 24: the k-step 16..31)
// are zero.
template <int CH8>
__device__ __forceinline__ void load_a_plane(unsigned char* plane, int p0,
                                             int kt, int lane,
                                             uint32_t a[4]) {
  const int row = p0 + (lane & 15);
  int c = 2 * kt + (lane >> 4);
  if (c >= CH8) c = CH8 - 1;
  const uint32_t addr = static_cast<uint32_t>(
      __cvta_generic_to_shared(chunk_ptr<CH8>(plane, row, c)));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
  if (2 * kt + 1 >= CH8) a[2] = a[3] = 0u;
}

// The staged x: rows of n 16-byte chunks (n = cin / 8, known at run time
// only), swizzled as swz does: chunk c of row r is at c ^ ((r >> shift) &
// mask), shift and mask computed once.
struct XTile {
  unsigned char* base;
  int n, shift, mask;
};

__device__ __forceinline__ XTile x_tile(unsigned char* base, int cin) {
  const int n = cin / 8;
  const int low = n & -n;
  const int span = low < 8 ? low : 8;            // 1, 2, 4 or 8
  return {base, n, 3 - (__ffs(span) - 1), span - 1};
}

__device__ __forceinline__ unsigned char* x_ptr(const XTile& xt, int row,
                                                int c) {
  return xt.base + (row * xt.n + (c ^ ((row >> xt.shift) & xt.mask))) * 16;
}

// Copies the band's x [pix, cin] (bf16, contiguous in device memory) into
// shared memory with asynchronous 16-byte copies (cp.async), all in flight
// at once; waits for this thread's copies (the caller then syncs).
__device__ __forceinline__ void stage_x(const __nv_bfloat16* xb,
                                        const XTile& xt, int pix) {
  const uint4* src = reinterpret_cast<const uint4*>(xb);
  for (int i = threadIdx.x; i < pix * xt.n; i += kThreads) {
    const int p = i / xt.n;
    const uint32_t dst = static_cast<uint32_t>(
        __cvta_generic_to_shared(x_ptr(xt, p, i - p * xt.n)));
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16;\n"
                 :: "r"(dst), "l"(src + i) : "memory");
  }
  asm volatile("cp.async.commit_group;\n" ::: "memory");
  asm volatile("cp.async.wait_group 0;\n" ::: "memory");
}

// A fragment of pixels p0..p0+15, channels 16*kt.. of the staged x.
__device__ __forceinline__ void load_a_x(const XTile& xt, int p0, int kt,
                                         int lane, uint32_t a[4]) {
  const uint32_t addr = static_cast<uint32_t>(__cvta_generic_to_shared(
      x_ptr(xt, p0 + (lane & 15), 2 * kt + (lane >> 4))));
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(a[0]), "=r"(a[1]), "=r"(a[2]), "=r"(a[3])
      : "r"(addr));
}

// Stores the bf16 pair (c, c+1) of pixel `row` into a plane.
template <int CH8>
__device__ __forceinline__ void store_pair(unsigned char* plane, int row,
                                           int c, uint32_t v) {
  *reinterpret_cast<uint32_t*>(chunk_ptr<CH8>(plane, row, c >> 3)
                               + (c & 7) * 2) = v;
}

// LiteConv 1x1 (no bias): dst = bf16(src @ wp), both [pix, MID] planes.
template <int MID>
__device__ __forceinline__ void conv_plane(unsigned char* src,
                                           unsigned char* dst,
                                           const uint2* wt,
                                           int mtiles) {
  constexpr int CH8 = MID / 8, KT = (MID + 15) / 16, NT = MID / 8;
  const int lane = threadIdx.x & 31, g = lane >> 2, t = lane & 3;
  for (int mt = threadIdx.x >> 5; mt < mtiles; mt += kWarps) {
    const int p0 = 16 * mt;
    uint32_t a[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) load_a_plane<CH8>(src, p0, kt, lane, a[kt]);
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      float acc[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
      for (int kt = 0; kt < KT; ++kt)
        mma_bf16(acc, a[kt], wt[(nt * KT + kt) * 32 + lane]);
      store_pair<CH8>(dst, p0 + g, 8 * nt + 2 * t, pack2(acc[0], acc[1]));
      store_pair<CH8>(dst, p0 + g + 8, 8 * nt + 2 * t, pack2(acc[2], acc[3]));
    }
  }
}

// One row of a thread's 3x3 window, as loaded: crop row r0 + rr (rr = -1
// or rows: a neighbour CTA's band), columns xc - 1 .. xc + 1, 8 bf16
// channels each; zeros outside the crop (the zero padding).
template <int CH8>
__device__ __forceinline__ void window_row(unsigned char* za,
                                           unsigned char* up,
                                           unsigned char* down, int rr,
                                           int rows, int w, int h, int r0,
                                           int xc, int c8, uint4 dst[3]) {
  const int gy = r0 + rr;
  unsigned char* base = za;
  int q0 = rr * w;
  if (rr < 0) {
    base = up; q0 = (rows - 1) * w;
  } else if (rr >= rows) {
    base = down; q0 = 0;
  }
#pragma unroll
  for (int k = 0; k < 3; ++k) {
    const int nx = xc + k - 1;
    dst[k] = gy >= 0 && gy < h && nx >= 0 && nx < w
        ? *reinterpret_cast<const uint4*>(chunk_ptr<CH8>(base, q0 + nx, c8))
        : make_uint4(0u, 0u, 0u, 0u);
  }
}

// Depthwise 3x3 with zero padding at the crop's edges, folded BN, ReLU:
// zb = relu(bn(sum_t za[p + tap_t] * dw[t])), the taps summed in (dy, dx)
// row-major order. A thread owns one column and 8 channels of a run of
// rows and slides a 3x3 window down it, so each input pixel is loaded
// once a thread, not nine times, and the next row's loads are in flight
// while a row is computed. The rows above and below the band come from
// the neighbour CTAs' za. With `pool`, adds each thread's outputs to
// part[8].
template <int MID>
__device__ __forceinline__ void depthwise(unsigned char* za,
                                          unsigned char* zb,
                                          const float* wl,
                                          int rows, int w, int h, int r0,
                                          bool pool, float part[8]) {
  constexpr int CH8 = MID / 8;
  const int tid = threadIdx.x;
  const int columns = w * CH8;             // (column, chunk) pairs
  const int runs = kThreads / columns;     // runs of rows per column
  const int run_rows = (rows + runs - 1) / runs;
  const int run = tid / columns;
  const int c8 = tid % CH8, xc = (tid % columns) / CH8;
  const int r_lo = run * run_rows;
  const int r_hi = min(rows, r_lo + run_rows);
  if (run >= runs || r_lo >= r_hi) return;
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  float wk[9][8];
  __nv_bfloat162 sc2[4], sh2[4];           // BN scale and shift (bf16)
#pragma unroll
  for (int t = 0; t < 9; ++t) {
#pragma unroll
    for (int j = 0; j < 8; ++j) wk[t][j] = wl[t * MID + 8 * c8 + j];
  }
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    sc2[i] = pair(wl + 9 * MID, 8 * c8 + 2 * i);
    sh2[i] = pair(wl + 10 * MID, 8 * c8 + 2 * i);
  }
  unsigned char* up = rank > 0 ? cluster.map_shared_rank(za, rank - 1)
                               : za;
  unsigned char* down =
      rank + 1 < static_cast<int>(cluster.num_blocks())
          ? cluster.map_shared_rank(za, rank + 1) : za;
  float win[3][3][8];                      // rows r-1, r, r+1
  uint4 raw[3];                            // the next row, as loaded
  window_row<CH8>(za, up, down, r_lo - 1, rows, w, h, r0, xc, c8, raw);
#pragma unroll
  for (int k = 0; k < 3; ++k) unpack8(raw[k], win[0][k]);
  window_row<CH8>(za, up, down, r_lo, rows, w, h, r0, xc, c8, raw);
#pragma unroll
  for (int k = 0; k < 3; ++k) unpack8(raw[k], win[1][k]);
  window_row<CH8>(za, up, down, r_lo + 1, rows, w, h, r0, xc, c8, raw);
#pragma unroll 3   // the window's row shifts become register renames
  for (int r = r_lo; r < r_hi; ++r) {
#pragma unroll
    for (int k = 0; k < 3; ++k) unpack8(raw[k], win[2][k]);
    if (r + 1 < r_hi)
      window_row<CH8>(za, up, down, r + 2, rows, w, h, r0, xc, c8, raw);
    float acc[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int t = 0; t < 9; ++t) {
#pragma unroll
      for (int j = 0; j < 8; ++j)
        acc[j] = fmaf(win[t / 3][t % 3][j], wk[t][j], acc[j]);
    }
    uint32_t o[4];
#pragma unroll
    for (int i = 0; i < 4; ++i)
      o[i] = bits(relu2(bn2(acc[2 * i], acc[2 * i + 1], sc2[i], sh2[i])));
    const uint4 out = make_uint4(o[0], o[1], o[2], o[3]);
    if (pool) {
      float v[8];
      unpack8(out, v);
#pragma unroll
      for (int j = 0; j < 8; ++j) part[j] += v[j];
    }
    *reinterpret_cast<uint4*>(chunk_ptr<CH8>(zb, r * w + xc, c8)) = out;
#pragma unroll
    for (int k = 0; k < 3; ++k) {
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        win[0][k][j] = win[1][k][j];
        win[1][k][j] = win[2][k][j];
      }
    }
  }
}

template <int MID>
__global__ void __launch_bounds__(kThreads, 1)
osblock_kernel(const __nv_bfloat16* __restrict__ x,
               const uint2* __restrict__ frag,
               const float* __restrict__ vec,
               __nv_bfloat16* __restrict__ out,
               int h, int w, int cin, int features, int hid, int rows,
               bool stage_weights, FragLayout FL, VecLayout VL,
               SmemLayout SL) {
  constexpr int CH8 = MID / 8, KT = (MID + 15) / 16, NT = MID / 8;
  constexpr int act = (kThreads / CH8) * CH8;
  constexpr int kParts = kThreads / MID;
  cg::cluster_group cluster = cg::this_cluster();
  const int csize = static_cast<int>(cluster.num_blocks());
  const int rank = static_cast<int>(cluster.block_rank());
  const int crop = blockIdx.x / csize;
  const int r0 = rank * rows;
  const int pix = rows * w;
  const int mtiles = pix / 16;
  const size_t px0 = static_cast<size_t>(crop) * h * w
                     + static_cast<size_t>(r0) * w;
  const __nv_bfloat16* xb = x + px0 * cin;
  __nv_bfloat16* ob = out + px0 * features;

  extern __shared__ __align__(16) unsigned char smem[];
  unsigned char* y = smem;
  const XTile xt = x_tile(smem + SL.plane, cin);   // x: conv1, conv3
  unsigned char* zb = smem + 3 * SL.plane;
  float* gacc = reinterpret_cast<float*>(smem + SL.gacc);
  float* red = reinterpret_cast<float*>(smem + SL.red);
  float* band_sum = reinterpret_cast<float*>(smem + SL.vec);  // [2][MID]
  float* pooled = band_sum + 2 * MID;
  float* gate = pooled + MID;
  float* hidden = gate + MID;
  float* red_parts = hidden + hid;   // [kParts][MID]

  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;
  const int c8 = tid % CH8;

  // the weights, copied once into shared memory where the plan has room
  // for them, else read through L1 from device memory
  const uint2* wf = frag;
  const float* wv = vec;
  if (stage_weights) {
    uint4* fs = reinterpret_cast<uint4*>(smem + SL.wfrag);
    float* vs = reinterpret_cast<float*>(smem + SL.wvec);
    for (int i = tid; i < FL.total * 16; i += kThreads)
      fs[i] = __ldg(reinterpret_cast<const uint4*>(frag) + i);
    for (int i = tid; i < VL.total; i += kThreads) vs[i] = __ldg(vec + i);
    __syncthreads();
    wf = reinterpret_cast<const uint2*>(fs);
    wv = vs;
  }

  // conv1 1x1 + folded BN + ReLU: y = relu(bn(x @ w1)), x staged in the
  // planes after y (za, zb, gacc: free until the first LiteConv)
  stage_x(xb, xt, pix);
  __syncthreads();
  for (int mt = warp; mt < mtiles; mt += kWarps) {
    const int p0 = 16 * mt;
    float acc[NT][4];
#pragma unroll
    for (int nt = 0; nt < NT; ++nt)
      acc[nt][0] = acc[nt][1] = acc[nt][2] = acc[nt][3] = 0.f;
    const int kts = cin / 16;
    for (int kt = 0; kt < kts; ++kt) {
      uint32_t a[4];
      load_a_x(xt, p0, kt, lane, a);
#pragma unroll
      for (int nt = 0; nt < NT; ++nt)
        mma_bf16(acc[nt], a, wf[(FL.w1 + nt * kts + kt) * 32 + lane]);
    }
#pragma unroll
    for (int nt = 0; nt < NT; ++nt) {
      const int c = 8 * nt + 2 * t;
      const __nv_bfloat162 sc = pair(wv + VL.sc1, c), sh = pair(wv + VL.sh1, c);
      store_pair<CH8>(y, p0 + g, c,
                      bits(relu2(bn2(acc[nt][0], acc[nt][1], sc, sh))));
      store_pair<CH8>(y, p0 + g + 8, c,
                      bits(relu2(bn2(acc[nt][2], acc[nt][3], sc, sh))));
    }
  }
  __syncthreads();

  // four streams of 1..4 LiteConvs, LiteConv_0..9 in order; each stream's
  // output gated and summed into gacc (the last sum rounded into y)
  int n = 0;
  for (int s = 0; s < 4; ++s) {
    unsigned char* src = y;
    float part[8] = {0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f, 0.f};
    for (int j = 0; j <= s; ++j, ++n) {
      unsigned char* za = smem + (1 + (n & 1)) * SL.plane;
      conv_plane<MID>(src, za, wf + (FL.lite + n * FL.lite_stride) * 32,
                      mtiles);
      cluster.sync();                 // za complete in every band
      depthwise<MID>(za, zb, wv + VL.lite + n * 11 * MID, rows, w, h, r0,
                     j == s, part);
      __syncthreads();
      src = zb;
    }

    // aggregation gate: mean over the crop -> Dense -> ReLU -> Dense ->
    // sigmoid, in f32. The band's sum in a fixed order: each thread's
    // pixels, PARTS strided sums of those per channel, then the parts;
    // the cluster's band sums in rank order.
    float* bsum = band_sum + (s & 1) * MID;
    if (tid < act) {
#pragma unroll
      for (int j = 0; j < 8; ++j) red[(tid / CH8) * MID + 8 * c8 + j] = part[j];
    }
    __syncthreads();
    if (tid < kParts * MID) {
      const int c = tid % MID, q = tid / MID;
      float sum = 0.f;
      for (int k = q; k < act / CH8; k += kParts) sum += red[k * MID + c];
      red_parts[q * MID + c] = sum;
    }
    __syncthreads();
    if (tid < MID) {
      float sum = 0.f;
#pragma unroll
      for (int q = 0; q < kParts; ++q) sum += red_parts[q * MID + tid];
      bsum[tid] = sum;
    }
    cluster.sync();                   // every band's sum is published
    if (tid < MID) {
      float sum = 0.f;
      for (int r = 0; r < csize; ++r) sum += *cluster.map_shared_rank(bsum + tid, r);
      pooled[tid] = sum / static_cast<float>(h * w);
    }
    __syncthreads();
    if (warp < hid) {                 // one warp a hidden unit
      float a = 0.f;
      for (int c = lane; c < MID; c += 32) a += wv[VL.gw1 + c * hid + warp] * pooled[c];
#pragma unroll
      for (int off = 16; off > 0; off >>= 1) a += __shfl_xor_sync(0xffffffffu, a, off);
      if (lane == 0) hidden[warp] = fmaxf(a + wv[VL.gb1 + warp], 0.f);
    }
    __syncthreads();
    if (tid < MID) {
      float a = 0.f;
      for (int k = 0; k < hid; ++k) a += wv[VL.gw2 + k * MID + tid] * hidden[k];
      gate[tid] = 1.f / (1.f + expf(-(a + wv[VL.gb2 + tid])));
    }
    __syncthreads();

    // gated sum in stream order: gacc = g0 + g1 + g2 + g3, g = zb * gate
    if (tid < act) {
      float gt[8];
#pragma unroll
      for (int j = 0; j < 8; ++j) gt[j] = gate[8 * c8 + j];
      for (int p = tid / CH8; p < pix; p += act / CH8) {
        float f[8];
        unpack8(*reinterpret_cast<const uint4*>(chunk_ptr<CH8>(zb, p, c8)), f);
        float4* ga = reinterpret_cast<float4*>(gacc + p * MID + 8 * c8);
        float v[8];
        if (s == 0) {
#pragma unroll
          for (int j = 0; j < 8; ++j) v[j] = __fmul_rn(f[j], gt[j]);
        } else {
          const float4 lo = ga[0], hi = ga[1];
          const float old[8] = {lo.x, lo.y, lo.z, lo.w, hi.x, hi.y, hi.z, hi.w};
#pragma unroll
          for (int j = 0; j < 8; ++j)
            v[j] = __fadd_rn(old[j], __fmul_rn(f[j], gt[j]));
        }
        if (s < 3) {
          ga[0] = make_float4(v[0], v[1], v[2], v[3]);
          ga[1] = make_float4(v[4], v[5], v[6], v[7]);
        } else {
          *reinterpret_cast<uint4*>(chunk_ptr<CH8>(y, p, c8)) = pack8(v);
        }
      }
    }
    __syncthreads();
  }

  // conv3 1x1 + folded BN, the identity (or its 1x1 downsample + folded
  // BN), residual add, ReLU; 32 output channels at a time through a
  // per-warp staging tile, then 16-byte stores
  const bool downsample = FL.wd >= 0;
  const int kts = cin / 16;
  unsigned char* stage = smem + SL.stage + warp * (16 * kChunkF * 2);
  stage_x(xb, xt, pix);   // x again, into the dead za, zb and gacc
  __syncthreads();
  for (int mt = warp; mt < mtiles; mt += kWarps) {
    const int p0 = 16 * mt;
    uint32_t a[KT][4];
#pragma unroll
    for (int kt = 0; kt < KT; ++kt) load_a_plane<CH8>(y, p0, kt, lane, a[kt]);
    for (int f0 = 0; f0 < features; f0 += kChunkF) {
      float acc[4][4], accd[4][4];
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
#pragma unroll
        for (int e = 0; e < 4; ++e) acc[nt][e] = accd[nt][e] = 0.f;
#pragma unroll
        for (int kt = 0; kt < KT; ++kt)
          mma_bf16(acc[nt], a[kt],
                   wf[(FL.w3 + (f0 / 8 + nt) * KT + kt) * 32 + lane]);
      }
      if (downsample) {
        for (int kt = 0; kt < kts; ++kt) {
          uint32_t ax[4];
          load_a_x(xt, p0, kt, lane, ax);
#pragma unroll
          for (int nt = 0; nt < 4; ++nt)
            mma_bf16(accd[nt], ax,
                     wf[(FL.wd + (f0 / 8 + nt) * kts + kt) * 32 + lane]);
        }
      }
#pragma unroll
      for (int nt = 0; nt < 4; ++nt) {
        const int c = 8 * nt + 2 * t;          // channel within the chunk
        const int f = f0 + c;
        const __nv_bfloat162 s3 = pair(wv + VL.sc3, f);
        const __nv_bfloat162 h3 = pair(wv + VL.sh3, f);
#pragma unroll
        for (int half = 0; half < 2; ++half) {
          const int row = g + 8 * half;
          const __nv_bfloat162 o =
              bn2(acc[nt][2 * half], acc[nt][2 * half + 1], s3, h3);
          const __nv_bfloat162 ident = downsample
              ? bn2(accd[nt][2 * half], accd[nt][2 * half + 1],
                    pair(wv + VL.scd, f), pair(wv + VL.shd, f))
              : *reinterpret_cast<const __nv_bfloat162*>(
                    x_ptr(xt, p0 + row, f >> 3) + (f & 7) * 2);
          *reinterpret_cast<uint32_t*>(chunk_ptr<4>(stage, row, c >> 3)
                                       + (c & 7) * 2) =
              bits(relu2(__hadd2(o, ident)));
        }
      }
      __syncwarp();
#pragma unroll
      for (int it = 0; it < 2; ++it) {
        const int item = lane + 32 * it;
        const int row = item >> 2, ch = item & 3;
        *reinterpret_cast<uint4*>(ob + static_cast<size_t>(p0 + row) * features
                                  + f0 + 8 * ch) =
            *reinterpret_cast<const uint4*>(chunk_ptr<4>(stage, row, ch));
      }
      __syncwarp();
    }
  }

  cluster.sync();   // no CTA leaves while a neighbour may read its planes
}

cudaLaunchConfig_t launch_config(int batch, int cluster, int smem,
                                 cudaStream_t stream,
                                 cudaLaunchAttribute* attr) {
  attr->id = cudaLaunchAttributeClusterDimension;
  attr->val.clusterDim.x = cluster;
  attr->val.clusterDim.y = 1;
  attr->val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(batch * cluster);
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = smem;
  cfg.stream = stream;
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return cfg;
}

// Allows the kernel the card's whole opt-in shared memory and counts the
// clusters of `cluster` CTAs with `smem` bytes each that fit at once.
template <int MID>
int prepare(int cluster, int smem, int* clusters) {
  auto kern = osblock_kernel<MID>;
  int device = 0, max_smem = 0;
  cudaError_t err = cudaGetDevice(&device);
  if (err == cudaSuccess)
    err = cudaDeviceGetAttribute(
        &max_smem, cudaDevAttrMaxSharedMemoryPerBlockOptin, device);
  if (err == cudaSuccess)
    err = cudaFuncSetAttribute(
        kern, cudaFuncAttributeMaxDynamicSharedMemorySize, max_smem);
  if (err != cudaSuccess) return static_cast<int>(err);
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(1, cluster, smem, 0, &attr);
  return static_cast<int>(cudaOccupancyMaxActiveClusters(clusters, kern,
                                                         &cfg));
}

template <int MID>
int launch(const void* x, const void* frag, const void* vec, void* out,
           int batch, int h, int w, int cin, int features, int hid,
           int cluster, bool stage_weights, const FragLayout& FL,
           const VecLayout& VL, const SmemLayout& SL, cudaStream_t stream) {
  cudaLaunchAttribute attr;
  const cudaLaunchConfig_t cfg = launch_config(batch, cluster, SL.total,
                                               stream, &attr);
  const cudaError_t err = cudaLaunchKernelEx(
      &cfg, osblock_kernel<MID>, static_cast<const __nv_bfloat16*>(x),
      static_cast<const uint2*>(frag), static_cast<const float*>(vec),
      static_cast<__nv_bfloat16*>(out), h, w, cin, features, hid,
      h / cluster, stage_weights, FL, VL, SL);
  if (err != cudaSuccess) return static_cast<int>(err);
  return static_cast<int>(cudaGetLastError());
}

}  // namespace

extern "C" {

// Number of bf16 values in frag (tiles of 32 lanes x 4 values).
int osblock_frag_count(int cin, int features, int mid) {
  return frag_layout(cin, features, mid).total * 128;
}

// Number of floats in vec.
int osblock_vec_count(int cin, int features, int mid, int hid) {
  return vec_layout(cin, features, mid, hid).total;
}

// Shared-memory bytes of one CTA whose band holds `pix` pixels, with
// frag_n bf16 and vec_n f32 weights staged (0 and 0: none).
int osblock_smem_bytes(int pix, int mid, int hid, int frag_n, int vec_n) {
  return smem_layout(pix, mid, hid, frag_n, vec_n).total;
}

#define OSBLOCK_MIDS(X) X(16) X(24) X(32) X(64) X(96) X(128)

// Prepares the kernel for clusters of `cluster` CTAs with `smem` bytes of
// shared memory each, and writes how many such clusters fit on the card
// at once to `clusters` (0: none; the wrapper raises). Returns 0 or a
// cudaError_t. Called once per launch plan, before its first launch.
int osblock_prepare(int mid, int cluster, int smem, int* clusters) {
  *clusters = 0;
  switch (mid) {
#define OSBLOCK_PREPARE(M) \
    case M: return prepare<M>(cluster, smem, clusters);
    OSBLOCK_MIDS(OSBLOCK_PREPARE)
#undef OSBLOCK_PREPARE
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

// Launches the kernel on `stream` as clusters of `cluster` CTAs per crop
// with `smem` bytes each, the weights staged in shared memory or not (the
// launch plan of ops/osnet_block.py, prepared by osblock_prepare).
// Returns 0 or a cudaError_t.
int osblock_forward(const void* x, const void* frag, const void* vec,
                    void* out, int batch, int h, int w, int cin,
                    int features, int mid, int hid, int cluster,
                    int stage_weights, int smem, void* stream) {
  if (batch <= 0) return 0;
  if (cluster < 1 || cluster > kMaxCluster || h % cluster != 0
      || (h / cluster * w) % 16 != 0 || cin % 16 != 0 || features % kChunkF
      || hid < 1 || hid > kWarps || mid != features / 4
      || w * (mid / 8) > kThreads || cin > 5 * mid)
    return static_cast<int>(cudaErrorInvalidValue);
  const FragLayout FL = frag_layout(cin, features, mid);
  const VecLayout VL = vec_layout(cin, features, mid, hid);
  const SmemLayout SL = smem_layout(h / cluster * w, mid, hid,
                                    stage_weights ? FL.total * 128 : 0,
                                    stage_weights ? VL.total : 0);
  if (smem != SL.total) return static_cast<int>(cudaErrorInvalidValue);
  const bool sw = stage_weights != 0;
  const cudaStream_t s = static_cast<cudaStream_t>(stream);
  switch (mid) {
#define OSBLOCK_LAUNCH(M)                                                  \
    case M:                                                                \
      return launch<M>(x, frag, vec, out, batch, h, w, cin, features, hid, \
                       cluster, sw, FL, VL, SL, s);
    OSBLOCK_MIDS(OSBLOCK_LAUNCH)
#undef OSBLOCK_LAUNCH
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
}

const char* osblock_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
