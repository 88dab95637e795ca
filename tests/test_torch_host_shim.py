"""The host shim's cluster launches (tests/cuda_host_shim.py,
``build_host(..., clusters=True)``), which the CPU tests of
``csrc/nms_waves.cu``'s select launch run on: a cluster's blocks run
together and each has its own dynamic shared memory, ``this_cluster()``
gives the rank and the size, ``sync()`` is a barrier of the whole cluster,
``map_shared_rank`` reaches another block's shared memory, and a block's
barriers count its own threads only. Without ``clusters=True`` a cluster
launch is refused."""
import ctypes

import numpy as np
import pytest

from .cuda_host_shim import build_host

PROBE = r"""
#include <cuda_runtime.h>
#include <cooperative_groups.h>

namespace {

// every block writes a word naming it into each of its shared words, then
// reads the next block's (in its cluster) through map_shared_rank; the
// block's barrier counts its threads
__global__ void cluster_probe_kernel(int* out, int* counts, int words) {
  extern __shared__ int smem[];
  auto cluster = cooperative_groups::this_cluster();
  const int rank = static_cast<int>(cluster.block_rank());
  const int size = static_cast<int>(cluster.num_blocks());
  const int block = blockIdx.y * gridDim.x + blockIdx.x;
  for (int x = threadIdx.x; x < words; x += blockDim.x)
    smem[x] = 1000 * block + 10 * rank + x % 7;
  const int n = __syncthreads_count(1);
  cluster.sync();   // every block of the cluster has written its words
  const int* peer = cluster.map_shared_rank(smem, (rank + 1) % size);
  for (int x = threadIdx.x; x < words; x += blockDim.x)
    out[block * words + x] = peer[x];
  if (threadIdx.x == 0) counts[block] = n * 100 + size;
  cluster.sync();   // no block leaves while another reads its memory
}

}  // namespace

extern "C" int cluster_probe(int* out, int* counts, int grid_x, int grid_y,
                             int cluster, int threads, int words) {
  cudaLaunchAttribute attr[1];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = cluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(grid_x, grid_y);
  cfg.blockDim = dim3(threads);
  cfg.dynamicSmemBytes = words * sizeof(int);
  cfg.attrs = attr;
  cfg.numAttrs = 1;
  return static_cast<int>(
      cudaLaunchKernelEx(&cfg, cluster_probe_kernel, out, counts, words));
}
"""


def probe_library(tmp_path_factory, clusters):
    lib = build_host('cluster_probe', tmp_path_factory, launches=0,
                     clusters=clusters, source=PROBE)
    lib.cluster_probe.argtypes = [ctypes.c_void_p] * 2 + [ctypes.c_int] * 5
    lib.cluster_probe.restype = ctypes.c_int
    return lib


@pytest.fixture(scope='module')
def probe(tmp_path_factory):
    return probe_library(tmp_path_factory, True)


@pytest.mark.parametrize('grid_x,grid_y,cluster,threads', [
    (8, 1, 8, 32), (6, 2, 3, 64), (4, 1, 1, 32), (2, 3, 2, 96)])
def test_cluster_blocks_share_their_memory(probe, grid_x, grid_y, cluster,
                                           threads):
    words = 100
    blocks = grid_x * grid_y
    out = np.full((blocks, words), -1, np.int32)
    counts = np.zeros(blocks, np.int32)
    probe.set_host_threads(0)
    assert probe.cluster_probe(out.ctypes.data, counts.ctypes.data, grid_x,
                               grid_y, cluster, threads, words) == 0
    x = np.arange(words)
    for by in range(grid_y):
        for bx in range(grid_x):
            rank = bx % cluster
            peer_rank = (rank + 1) % cluster
            peer = by * grid_x + bx - rank + peer_rank
            want = 1000 * peer + 10 * peer_rank + x % 7
            np.testing.assert_array_equal(out[by * grid_x + bx], want)
    np.testing.assert_array_equal(counts, threads * 100 + cluster)


def test_cluster_launch_needs_clusters(tmp_path_factory):
    lib = probe_library(tmp_path_factory, False)
    out = np.zeros((8, 4), np.int32)
    counts = np.zeros(8, np.int32)
    assert lib.cluster_probe(out.ctypes.data, counts.ctypes.data, 8, 1, 8,
                             32, 4) != 0
    assert not out.any()
