"""Stamped copies of the port's hand kernels, for the profilers
(scripts/prof_gap_commit.py, scripts/prof_gap_points.py).

``stamped_library(name, marks)`` builds a copy of
``fastmot_tpu_torch/csrc/<name>.cu`` with a stamp where the text of each of
``marks`` has '@' (without the '@', each text must occur in the source
once), with the kernel's own nvcc flags, into
``fastmot_tpu_torch/csrc/build/``. A stamp, in thread 0 of the block that
reaches it, appends (its mark's index, the launch's linear block
``blockIdx.y * gridDim.x + blockIdx.x``, ``clock64``, the global timer in
ns) to a log in device memory; ``read_stamps`` returns the log in the order
the stamps were taken and empties it. Every stamp takes an atomic on one
counter, which the times include.
"""
import ctypes
import subprocess

import numpy as np

from fastmot_tpu_torch.ops import cuda_build

LOG = 1 << 16                       # stamps the log holds
PRELUDE = r'''
__device__ int g_stamp_n;
__device__ int g_stamp_mark[LOG], g_stamp_block[LOG];
__device__ long long g_stamp_clock[LOG];
__device__ unsigned long long g_stamp_time[LOG];
__device__ __forceinline__ void stamp(int mark) {
  if (threadIdx.x != 0) return;
  const int i = atomicAdd(&g_stamp_n, 1);
  if (i >= LOG) return;
  unsigned long long t;
  asm volatile("mov.u64 %0, %%globaltimer;" : "=l"(t));
  g_stamp_mark[i] = mark;
  g_stamp_block[i] = blockIdx.y * gridDim.x + blockIdx.x;
  g_stamp_clock[i] = clock64();
  g_stamp_time[i] = t;
}
'''
READER = r'''
extern "C" int stamps_read(int* mark, int* block, long long* clock,
                           unsigned long long* time) {
  int n = 0;
  if (cudaMemcpyFromSymbol(&n, g_stamp_n, sizeof n)) return -1;
  n = n < LOG ? n : LOG;
  if (n && (cudaMemcpyFromSymbol(mark, g_stamp_mark, sizeof(int) * n)
            || cudaMemcpyFromSymbol(block, g_stamp_block, sizeof(int) * n)
            || cudaMemcpyFromSymbol(clock, g_stamp_clock, 8 * n)
            || cudaMemcpyFromSymbol(time, g_stamp_time, 8 * n)))
    return -1;
  const int zero = 0;
  if (cudaMemcpyToSymbol(g_stamp_n, &zero, sizeof zero)) return -1;
  return n;
}
'''


def stamped_library(name: str, marks, source=None, tag='') -> ctypes.CDLL:
    """The stamped build of csrc/<name>.cu (or of ``source``, another
    version of it, built apart under ``tag``): stamp(i) where marks[i] has
    '@'. Raises RuntimeError if a mark's text is not in the source once."""
    src = source if source is not None else \
        (cuda_build.CSRC / f'{name}.cu').read_text()
    places = []
    for i, mark in enumerate(marks):
        text = mark.replace('@', '')
        if src.count(text) != 1:
            raise RuntimeError(f'{name}: mark not found once: {text!r}')
        places.append((src.index(text) + mark.index('@'), i))
    for at, i in sorted(places, reverse=True):
        src = src[:at] + f'stamp({i});\n' + src[at:]
    prelude = PRELUDE.replace('LOG', str(LOG))
    src = src.replace('namespace {', prelude + 'namespace {', 1)
    src += READER.replace('LOG', str(LOG))
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    cu = cuda_build.BUILD_DIR / f'{name}_stamped{tag}.cu'
    so = cuda_build.BUILD_DIR / f'{name}_stamped{tag}.so'
    cu.write_text(src)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.nvcc_flags(name),
                    '-o', str(so), str(cu)], check=True)
    lib = ctypes.CDLL(str(so))
    lib.stamps_read.argtypes = [ctypes.c_void_p] * 4
    lib.stamps_read.restype = ctypes.c_int
    return lib


def read_stamps(lib: ctypes.CDLL):
    """The log since the last read, in the order the stamps were taken:
    (mark, block, clock, time) arrays. Empties it."""
    mark, block = np.zeros(LOG, np.int32), np.zeros(LOG, np.int32)
    clock, time = np.zeros(LOG, np.int64), np.zeros(LOG, np.uint64)
    n = lib.stamps_read(*(a.ctypes.data for a in (mark, block, clock, time)))
    if n < 0:
        raise RuntimeError('stamps_read failed')
    return mark[:n], block[:n], clock[:n], time[:n].astype(np.int64)
