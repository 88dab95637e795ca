"""Host builds of the port's hand kernels for the CPU tests.

``build_host(name, ...)`` compiles ``fastmot_tpu_torch/csrc/<name>.cu`` with
g++ through ``HOST_SHIM``, a header that stands in for ``cuda_runtime.h``
with just enough of CUDA for the kernels of csrc/gap_commit.cu,
csrc/flow_preprocess.cu, csrc/gap_points.cu and csrc/assoc_solvers.cu:

- a launch (``kernel<<<grid, block, smem, stream>>>(...)``, rewritten into
  ``host_launch``, or ``cudaLaunchKernelEx``) runs its blocks one after
  another on one team of host threads, which meet after each block: the
  block's own thread count, or ``set_host_threads(n)``'s where a test sets
  one (the kernels stride their loops by ``blockDim.x`` and take whole
  warps, so any multiple of 32 computes the same);
- ``__syncthreads``, ``__syncthreads_count``, ``__syncthreads_or`` and
  ``__syncthreads_and`` are a barrier of the team
  (a mutex and condition variable; a barrier some thread never reaches
  aborts after 60 s);
- ``__syncwarp``, the shuffles, ``__ballot_sync``, ``__match_any_sync``
  and the unsigned warp reductions ``__reduce_max_sync`` and
  ``__reduce_min_sync`` are meetings of a warp's 32 threads: each lane puts its value in its
  slot and, after the warp's spinning barrier, reads the slots of the row
  (two slot rows in turn, so a lane writes a row only after every lane
  has read it);
- ``__shared__`` arrays are static storage (a block's threads share them,
  and blocks run in turn), and a dynamic ``extern __shared__`` array is a
  static one of ``HOST_DYNAMIC_SMEM`` bytes;
- with ``clusters=True``, a launch whose ``cudaLaunchKernelEx`` attributes
  give a cluster dimension runs each cluster's blocks together, on one
  team of host threads (the block's thread count times the cluster's
  blocks), and the clusters in turn; a dynamic ``extern __shared__`` array
  is then each block's own (``HOST_DYNAMIC_SMEM`` bytes a block, zeroed at
  the launch); ``cooperative_groups::this_cluster()`` gives the block's
  rank, the cluster's size, ``sync()`` (a barrier of every thread of the
  cluster) and ``map_shared_rank`` (a pointer into the block's dynamic
  shared memory moved to the same place in another block's). A kernel
  launched so keeps all its shared state in dynamic shared memory: its
  static ``__shared__`` arrays would be one storage for the whole
  cluster. Launches without a cluster dimension, or with clusters of one
  block, run as above (one team, the blocks in turn, one dynamic shared
  memory that they take in turn), and ``this_cluster()`` in them is a
  cluster of one block;
- the atomics (32-bit, ``atomicCAS`` on ints, and 64-bit ``atomicMax``)
  are the compiler's ``__atomic`` builtins; the asynchronous copies into
  shared memory (``cp.async``, ``cp.async.bulk`` and their mbarrier) sit in
  the kernels under ``__CUDA_ARCH__`` beside plain copies, which the host
  build takes; the programmatic-dependent-launch calls do nothing, since
  the launches already run one after another;
- ``-ffp-contract=off`` rounds every product and sum on its own, as the
  card's build under ``-fmad=false`` does, so the two builds agree bit for
  bit.
"""
import ctypes
import re
import shutil
import subprocess

import pytest

HOST_SHIM = r"""
#pragma once
#include <math.h>
#include <algorithm>
#include <atomic>
#include <chrono>
#include <condition_variable>
#include <cstddef>
#include <cstdint>
#include <cstdlib>
#include <cstring>
#include <memory>
#include <mutex>
#include <thread>
#include <vector>
#define __host__
#define __device__
#define __global__
#define __forceinline__ inline
#define __launch_bounds__(...)
#define __restrict__
#define __shared__ static
#define __align__(n) alignas(n)
#define HOST_DYNAMIC_SMEM (1 << 18)
using std::max;
using std::min;
struct float2 { float x, y; };
inline float2 make_float2(float x, float y) { return {x, y}; }
struct alignas(16) float4 { float x, y, z, w; };
inline float4 make_float4(float x, float y, float z, float w) {
  return {x, y, z, w};
}
struct alignas(8) uint2 { unsigned x, y; };
inline uint2 make_uint2(unsigned x, unsigned y) { return {x, y}; }
struct alignas(16) uint4 { unsigned x, y, z, w; };
struct alignas(16) ulonglong2 { unsigned long long x, y; };
struct uint3 { unsigned x, y, z; };
struct dim3 {
  unsigned x, y, z;
  dim3(unsigned a = 1, unsigned b = 1, unsigned c = 1) : x(a), y(b), z(c) {}
};
static thread_local uint3 blockIdx, threadIdx;
static thread_local dim3 blockDim, gridDim;
typedef void* cudaStream_t;
typedef int cudaError_t;
enum { cudaSuccess = 0, cudaErrorInvalidValue = 1 };
enum cudaFuncAttribute {
  cudaFuncAttributeMaxDynamicSharedMemorySize = 8,
  cudaFuncAttributeNonPortableClusterSizeAllowed = 16
};
inline cudaError_t cudaGetLastError() { return 0; }
inline const char* cudaGetErrorString(cudaError_t e) {
  return e ? "invalid value" : "no error";
}
template <class F>
cudaError_t cudaFuncSetAttribute(F, cudaFuncAttribute a, int value) {
  return a != cudaFuncAttributeMaxDynamicSharedMemorySize
      || value <= HOST_DYNAMIC_SMEM ? cudaSuccess : cudaErrorInvalidValue;
}
inline unsigned __float_as_uint(float f) {
  unsigned u;
  std::memcpy(&u, &f, 4);
  return u;
}
inline float __uint_as_float(unsigned u) {
  float f;
  std::memcpy(&f, &u, 4);
  return f;
}
inline int __popc(unsigned v) { return __builtin_popcount(v); }
inline int __ffs(int v) { return __builtin_ffs(v); }
inline int __clzll(long long v) {
  return v ? __builtin_clzll(static_cast<unsigned long long>(v)) : 64;
}
inline int atomicAdd(int* p, int v) {
  return __atomic_fetch_add(p, v, __ATOMIC_RELAXED);
}
inline unsigned atomicMax(unsigned* p, unsigned v) {
  unsigned old = __atomic_load_n(p, __ATOMIC_RELAXED);
  while (old < v && !__atomic_compare_exchange_n(
             p, &old, v, true, __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
  }
  return old;
}
inline unsigned long long atomicMax(unsigned long long* p,
                                    unsigned long long v) {
  unsigned long long old = __atomic_load_n(p, __ATOMIC_RELAXED);
  while (old < v && !__atomic_compare_exchange_n(
             p, &old, v, true, __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
  }
  return old;
}
inline unsigned atomicOr(unsigned* p, unsigned v) {
  return __atomic_fetch_or(p, v, __ATOMIC_RELAXED);
}
inline unsigned atomicAnd(unsigned* p, unsigned v) {
  return __atomic_fetch_and(p, v, __ATOMIC_RELAXED);
}
inline int atomicCAS(int* p, int compare, int v) {
  __atomic_compare_exchange_n(p, &compare, v, false, __ATOMIC_SEQ_CST,
                              __ATOMIC_SEQ_CST);
  return compare;   // the old value
}
inline unsigned atomicMin(unsigned* p, unsigned v) {
  unsigned old = __atomic_load_n(p, __ATOMIC_RELAXED);
  while (old > v && !__atomic_compare_exchange_n(
             p, &old, v, true, __ATOMIC_RELAXED, __ATOMIC_RELAXED)) {
  }
  return old;
}

struct Barrier {
  std::mutex m;
  std::condition_variable cv;
  int n = 0, waiting = 0, generation = 0, count = 0, result = 0;
  // waits for the group; returns how many of it met with a nonzero pred
  int meet(int pred = 0) {
    std::unique_lock<std::mutex> lock(m);
    const int g = generation;
    count += pred != 0;
    if (++waiting == n) {
      result = count;
      count = 0;
      waiting = 0;
      ++generation;
      cv.notify_all();
    } else if (!cv.wait_for(lock, std::chrono::seconds(60),
                            [&] { return generation != g; })) {
      std::abort();
    }
    return result;
  }
};
// a warp's barrier: its threads spin (yielding the core) on a generation
// count, cheaper than a sleep for the many short waits of shuffles, and
// after a few rounds sleep on a condition variable, so that a machine
// whose cores are busy with other teams still gets to the last arrival
struct SpinBarrier {
  std::atomic<int> waiting{0}, generation{0};
  int n = 0;
  std::mutex m;
  std::condition_variable cv;
  void meet() {
    const int g = generation.load(std::memory_order_acquire);
    if (waiting.fetch_add(1, std::memory_order_acq_rel) + 1 == n) {
      waiting.store(0, std::memory_order_relaxed);
      {
        std::lock_guard<std::mutex> lock(m);
        generation.fetch_add(1, std::memory_order_release);
      }
      cv.notify_all();
      return;
    }
    auto passed = [&] {
      return generation.load(std::memory_order_acquire) != g;
    };
    for (int spins = 0; spins < 64; ++spins) {
      if (passed()) return;
      std::this_thread::yield();
    }
    std::unique_lock<std::mutex> lock(m);
    if (!cv.wait_for(lock, std::chrono::seconds(60), passed)) std::abort();
  }
};
struct Warp {
  SpinBarrier barrier;
  uint64_t slot[2][32];
  int row[32] = {};
};
static thread_local Barrier* block_barrier;
static thread_local Warp* this_warp;
// a cluster launch's shared state (clusters=True)
struct HostCluster {
  int size = 1;
  Barrier barrier;
  std::vector<char> arena;   // the blocks' dynamic shared memory in turn
};
static thread_local HostCluster* host_cluster;
static thread_local int host_cluster_rank;
static thread_local char* host_smem_base;
// this block's dynamic shared memory (clusters=True)
inline char* host_block_smem() { return host_smem_base; }
inline void __syncthreads() { block_barrier->meet(); }
inline int __syncthreads_count(int pred) { return block_barrier->meet(pred); }
inline int __syncthreads_or(int pred) { return block_barrier->meet(pred) > 0; }
inline int __syncthreads_and(int pred) {
  return block_barrier->meet(pred) == block_barrier->n;
}
inline void __syncwarp(unsigned = 0xFFFFFFFFu) { this_warp->barrier.meet(); }
// every lane puts v in its slot and, after the warp's barrier, reads the
// slots of the row (read(row))
template <class T, class Read>
auto warp_exchange(T v, Read read) {
  Warp& w = *this_warp;
  const int lane = threadIdx.x % 32, row = w.row[lane];
  w.row[lane] ^= 1;
  uint64_t bits = 0;
  std::memcpy(&bits, &v, sizeof(T));
  w.slot[row][lane] = bits;
  w.barrier.meet();
  return read(w.slot[row]);
}
template <class T>
T lane_value(const uint64_t* slots, int lane) {
  T out;
  std::memcpy(&out, &slots[lane], sizeof(T));
  return out;
}
template <class T>
T __shfl_sync(unsigned, T v, int src) {
  return warp_exchange(v, [&](const uint64_t* r) {
    return lane_value<T>(r, src);
  });
}
template <class T>
T __shfl_up_sync(unsigned, T v, int d) {
  const int l = threadIdx.x % 32;
  return warp_exchange(v, [&](const uint64_t* r) {
    return lane_value<T>(r, l - d >= 0 ? l - d : l);
  });
}
template <class T>
T __shfl_down_sync(unsigned, T v, int d) {
  const int l = threadIdx.x % 32;
  return warp_exchange(v, [&](const uint64_t* r) {
    return lane_value<T>(r, l + d < 32 ? l + d : l);
  });
}
template <class T>
T __shfl_xor_sync(unsigned, T v, int m) {
  const int l = threadIdx.x % 32;
  return warp_exchange(v, [&](const uint64_t* r) {
    return lane_value<T>(r, l ^ m);
  });
}
inline unsigned __ballot_sync(unsigned, int pred) {
  return warp_exchange(pred != 0, [](const uint64_t* r) {
    unsigned out = 0;
    for (int l = 0; l < 32; ++l) out |= static_cast<unsigned>(r[l] != 0) << l;
    return out;
  });
}
// the warp reductions over the 32 lanes (every lane of the warp takes part)
template <class F>
unsigned warp_reduce(unsigned v, F op) {
  return warp_exchange(v, [&](const uint64_t* r) {
    unsigned out = static_cast<unsigned>(r[0]);
    for (int l = 1; l < 32; ++l) out = op(out, static_cast<unsigned>(r[l]));
    return out;
  });
}
inline unsigned __reduce_max_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned a, unsigned b) { return a > b ? a : b; });
}
inline unsigned __reduce_min_sync(unsigned, unsigned v) {
  return warp_reduce(v, [](unsigned a, unsigned b) { return a < b ? a : b; });
}
template <class T>
unsigned __match_any_sync(unsigned, T v) {
  return warp_exchange(v, [&](const uint64_t* r) {
    const uint64_t mine = r[threadIdx.x % 32];
    unsigned out = 0;
    for (int l = 0; l < 32; ++l) out |= static_cast<unsigned>(r[l] == mine) << l;
    return out;
  });
}
inline void cudaTriggerProgrammaticLaunchCompletion() {}
inline void cudaGridDependencySynchronize() {}

static int host_threads = 0;
// the team size of every launch from now on (0: each block's own)
extern "C" void set_host_threads(int n) { host_threads = n; }

// the blocks in turn on one team of host threads, which meet after each
// block (a thread that returned early waits there)
template <class F, class... A>
void host_launch(dim3 grid, int threads, F f, A... args) {
  const int n = host_threads > 0 ? host_threads : threads;
  Barrier barrier, block_end;
  barrier.n = block_end.n = n;
  const int n_warps = (n + 31) / 32;
  std::unique_ptr<Warp[]> warps(new Warp[n_warps]);
  for (int w = 0; w < n_warps; ++w) warps[w].barrier.n = min(32, n - 32 * w);
#ifdef HOST_CLUSTERS
  std::vector<char> arena(HOST_DYNAMIC_SMEM, 0);   // the blocks' in turn
#endif
  std::vector<std::thread> team;
  for (int t = 0; t < n; ++t)
    team.emplace_back([&, t] {
      threadIdx = {static_cast<unsigned>(t), 0, 0};
      blockDim = dim3(n);
      gridDim = grid;
      block_barrier = &barrier;
      this_warp = &warps[t / 32];
#ifdef HOST_CLUSTERS
      host_smem_base = arena.data();
#endif
      for (unsigned y = 0; y < grid.y; ++y)
        for (unsigned b = 0; b < grid.x; ++b) {
          blockIdx = {b, y, 0};
          f(args...);
          block_end.meet();
        }
    });
  for (auto& th : team) th.join();
}

enum cudaLaunchAttributeID {
  cudaLaunchAttributeProgrammaticStreamSerialization = 1,
  cudaLaunchAttributeClusterDimension = 4
};
struct cudaLaunchAttribute {
  cudaLaunchAttributeID id;
  union {
    int programmaticStreamSerializationAllowed;
    struct { unsigned x, y, z; } clusterDim;
  } val;
};
struct cudaLaunchConfig_t {
  dim3 gridDim, blockDim;
  size_t dynamicSmemBytes;
  cudaStream_t stream;
  cudaLaunchAttribute* attrs;
  unsigned numAttrs;
};
#ifdef HOST_CLUSTERS
// a cluster's blocks together on one team (the block's threads times the
// cluster's blocks), each block with its own barrier, warps and dynamic
// shared memory; the clusters in turn
template <class F, class... A>
void host_launch_cluster(dim3 grid, int threads, int size, F f, A... args) {
  const int n = host_threads > 0 ? host_threads : threads;
  const int n_warps = (n + 31) / 32;
  for (unsigned y = 0; y < grid.y; ++y)
    for (unsigned c = 0; c < grid.x / size; ++c) {
      HostCluster cluster;
      cluster.size = size;
      cluster.barrier.n = n * size;
      cluster.arena.assign(static_cast<size_t>(size) * HOST_DYNAMIC_SMEM, 0);
      std::vector<Barrier> barriers(size);
      std::vector<std::unique_ptr<Warp[]>> warps(size);
      for (int r = 0; r < size; ++r) {
        barriers[r].n = n;
        warps[r].reset(new Warp[n_warps]);
        for (int w = 0; w < n_warps; ++w)
          warps[r][w].barrier.n = min(32, n - 32 * w);
      }
      std::vector<std::thread> team;
      for (int t = 0; t < n * size; ++t)
        team.emplace_back([&, t] {
          const int r = t / n, local = t % n;
          threadIdx = {static_cast<unsigned>(local), 0, 0};
          blockDim = dim3(n);
          gridDim = grid;
          blockIdx = {c * size + r, y, 0};
          block_barrier = &barriers[r];
          this_warp = &warps[r][local / 32];
          host_cluster = &cluster;
          host_cluster_rank = r;
          host_smem_base = cluster.arena.data()
              + static_cast<size_t>(r) * HOST_DYNAMIC_SMEM;
          f(args...);
        });
      for (auto& th : team) th.join();
    }
}
#endif

template <class... E, class... A>
cudaError_t cudaLaunchKernelEx(const cudaLaunchConfig_t* cfg,
                               void (*f)(E...), A&&... args) {
  int size = 1;
  for (unsigned a = 0; a < cfg->numAttrs; ++a)
    if (cfg->attrs[a].id == cudaLaunchAttributeClusterDimension)
      size = static_cast<int>(cfg->attrs[a].val.clusterDim.x);
#ifdef HOST_CLUSTERS
  if (size < 1 || cfg->gridDim.x % size) return cudaErrorInvalidValue;
  if (size > 1) {
    host_launch_cluster(cfg->gridDim, cfg->blockDim.x, size, f, args...);
    return cudaSuccess;
  }
#else
  if (size != 1) return cudaErrorInvalidValue;   // build with clusters=True
#endif
  host_launch(cfg->gridDim, cfg->blockDim.x, f, args...);
  return cudaSuccess;
}

namespace cooperative_groups {
// this block's cluster (of one block outside a cluster launch)
struct cluster_group {
  void sync() const {
    if (host_cluster) host_cluster->barrier.meet();
    else block_barrier->meet();
  }
  unsigned block_rank() const { return host_cluster_rank; }
  unsigned num_blocks() const {
    return host_cluster ? host_cluster->size : 1;
  }
  // addr (in this block's dynamic shared memory) in block `rank`'s
  template <class T>
  T* map_shared_rank(T* addr, int rank) const {
    char* p = reinterpret_cast<char*>(addr);
    if (!host_cluster) return addr;
    if (p < host_smem_base || p >= host_smem_base + HOST_DYNAMIC_SMEM)
      std::abort();   // not this block's dynamic shared memory
    return reinterpret_cast<T*>(
        p + (static_cast<long>(rank) - host_cluster_rank) * HOST_DYNAMIC_SMEM);
  }
};
inline cluster_group this_cluster() { return {}; }
}  // namespace cooperative_groups
"""

# with clusters=True: each block's own dynamic shared memory
COOPERATIVE_GROUPS = """#pragma once
#include "cuda_runtime.h"
"""


def build_host(name, tmp_path_factory, defines=(), extra='', launches=1,
               opt='-O2', clusters=False, source=None):
    """``csrc/<name>.cu`` (or ``source``, the text of one) built for the
    host with g++ and ``HOST_SHIM``, as a ctypes library with
    ``set_host_threads`` declared: each ``kernel<<<grid, block, smem,
    stream>>>(`` becomes a ``host_launch`` (``launches`` of them; the rest
    launch by ``cudaLaunchKernelEx``), a dynamic ``extern __shared__``
    array static storage (with ``clusters``, a pointer to the block's own
    dynamic shared memory, and cluster launches run as the module's
    docstring says), ``extra`` is appended to the source (the same
    translation unit) and ``defines`` are ``-D`` flags."""
    from fastmot_tpu_torch.ops.cuda_build import CSRC
    if shutil.which('g++') is None:
        pytest.skip('needs g++')
    d = tmp_path_factory.mktemp(f'{name}_host')
    (d / 'cuda_runtime.h').write_text(HOST_SHIM)
    (d / 'cooperative_groups.h').write_text(COOPERATIVE_GROUPS)
    src, n = re.subn(r'(\w+)<<<(\w+), (\w+), \w+, \w+>>>\(',
                     r'host_launch(\2, \3, \1, ',
                     source if source is not None
                     else (CSRC / f'{name}.cu').read_text())
    assert n == launches, (name, n)
    if clusters:
        src = re.sub(r'extern __shared__ (.*?)(\w+) (\w+)\[\];',
                     r'\1\2* const \3 = '
                     r'reinterpret_cast<\1\2*>(host_block_smem());', src)
        defines = (*defines, '-DHOST_CLUSTERS=1')
    else:
        src = re.sub(r'extern __shared__ (.*?)(\w+) (\w+)\[\];',
                     r'static \1\2 \3[HOST_DYNAMIC_SMEM / sizeof(\2)];',
                     src)
    (d / f'{name}.cpp').write_text(src + extra)
    built = subprocess.run(
        ['g++', opt, '-std=c++17', '-pthread', '-ffp-contract=off',
         '-fno-strict-aliasing', '-fPIC', '-shared', *defines, '-I', str(d),
         '-o', str(d / f'{name}.so'), str(d / f'{name}.cpp')],
        capture_output=True, text=True)
    assert built.returncode == 0, built.stderr[-4000:]
    lib = ctypes.CDLL(str(d / f'{name}.so'))
    lib.set_host_threads.argtypes = [ctypes.c_int]
    return lib
