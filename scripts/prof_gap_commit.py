#!/usr/bin/env python3
"""Where the gap-commit kernel (fastmot_tpu_torch/csrc/gap_commit.cu)
spends its time, on one NVIDIA GPU:

    python3 scripts/prof_gap_commit.py [--launches 100]

It builds a copy of the kernel that records ``clock64`` in thread 0 of the
first block at each phase boundary (into ``fastmot_tpu_torch/csrc/
build/``), runs it once on the synthetic camera case of
tests/test_torch_gap_commit.py at 1 stream x flow budget 48 and at 8
streams x 128, with the main path's 256 background points, and prints
the SM cycles each phase took (a phase inside the similarity rounds
summed over the rounds), beside the device time a
launch of the unstamped kernel (CUDA events around ``--launches``
launches queued behind a sleep, as chip_smoke.py phase 17 times it).
"""
import argparse
import ctypes
import subprocess
import sys
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import tests.test_torch_gap_commit as tg  # noqa: E402
from fastmot_tpu_torch.ops import gap_commit as gc  # noqa: E402
from fastmot_tpu_torch.ops.flow_kernels import BG_KP  # noqa: E402

# (text in csrc/gap_commit.cu, the phase that ends there): the stamp goes
# where the text has '@', at the start of a line
PHASE_MARKS = [
    ('@  // ---- stage the background points', 'launch'),
    ('@  // ---- homography RANSAC', 'staging'),
    ('@    // a hypothesis a thread', 'Hartley + order'),
    ('@    int score = 0;', 'hypotheses: draws + 8x8 solves'),
    ('@    // the first hypothesis of the highest count',
     'hypotheses: scores'),
    ('@    // two guarded refits over the inliers', 'arg-max + inliers'),
    ('@    if (tid == 0) {\n      const float h22', 'refits'),
    ('@  // ---- per-track similarity RANSAC', 'h22 + h_ok'),
    ('@    int cnt = 0;\n    if (live) {', 'similarity: matches'),
    ('@    uint32_t k1 = 0, k2 = 0;', 'similarity: order'),
    ('@    float sim[4] = {0.f, 0.f, 0.f, 0.f};', 'similarity: hypotheses'),
    ('@    for (int it = 0; it < 2; ++it) {\n      // the 8 sums',
     'similarity: arg-max'),
    ('@    if (live && lane == 0) {', 'similarity: refits'),
    ('@  // ---- slot scatter, Kalman, commit', 'similarity: estimates'),
    ('@    float mean[8], cov[8][8];', 'slot scatter + keypoints'),
    ('@    kalman_warp(', 'Kalman loads'),
    ('@    kalman_predict(', 'Kalman warp'),
    ('@    if (has_klt) {\n      const float z[4]', 'Kalman predict'),
    ('@    // as_tlbr, then intersection', 'Kalman update'),
    ('@  if (tid < 10) info[tid]', 'commit + info'),
]


def phase_library():
    """Builds the kernel with a clock64 stamp at each of PHASE_MARKS."""
    from fastmot_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / 'gap_commit.cu').read_text()
    for i, (mark, _) in enumerate(PHASE_MARKS):
        text = mark.replace('@', '')
        if src.count(text) != 1:
            raise RuntimeError(f'phase mark not found once: {text!r}')
        stamp = ('if (blockIdx.x == 0 && threadIdx.x == 0 && g_n < 4096) '
                 f'{{ g_ids[g_n] = {i}; g_stamps[g_n++] = clock64(); }}\n')
        src = src.replace(text, mark.replace('@', stamp))
    src = src.replace('namespace {', '__device__ long long g_stamps[4096];\n'
                      '__device__ int g_ids[4096];\n__device__ int g_n;\n'
                      'namespace {', 1)
    src += ('extern "C" int gap_commit_stamps(long long* out, int* ids, '
            'int reset) {\n'
            '  int n = 0;\n'
            '  if (reset) return (int)cudaMemcpyToSymbol(g_n, &n, sizeof n);\n'
            '  cudaMemcpyFromSymbol(&n, g_n, sizeof n);\n'
            '  cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * n);\n'
            '  cudaMemcpyFromSymbol(ids, g_ids, sizeof(int) * n);\n'
            '  return n;\n}\n')
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / 'gap_commit_phases.cu'
    path.write_text(src)
    lib = cuda_build.BUILD_DIR / 'gap_commit_phases.so'
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.nvcc_flags(
        'gap_commit'), '-o', str(lib), str(path)], check=True)
    return ctypes.CDLL(str(lib))


def cuda_args(kinds, f_cap):
    args = tg.commit_args(kinds, f_cap, list(range(len(kinds))),
                          n_bg=BG_KP)
    return [tuple(x.cuda() for x in a) if isinstance(a, tuple) else
            a.cuda() if isinstance(a, torch.Tensor) else a for a in args]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('--launches', type=int, default=100)
    args = parser.parse_args()
    card = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    cases = {'1 stream x 48': cuda_args(['camera'], 48),
             '8 streams x 128': cuda_args(['camera'] * 8, 128)}
    times = {}
    for tag, a in cases.items():       # the unstamped kernel first
        _, launch = gc.gap_commit_launch_args(*a)
        times[tag] = chip_smoke.lk_device_ms(
            gc.gap_commit_library().gap_commit_forward, launch,
            n=args.launches, tag='gap_commit')
    from fastmot_tpu_torch.ops import cuda_build
    lib = phase_library()
    lib.gap_commit_stamps.argtypes = [ctypes.c_void_p, ctypes.c_void_p,
                                      ctypes.c_int]
    lib.gap_commit_stamps.restype = ctypes.c_int
    cuda_build.load = lambda name: lib
    gc.gap_commit_library.cache_clear()
    for tag, a in cases.items():
        gc.gap_commit(*a)
        torch.cuda.synchronize()
        lib.gap_commit_stamps(None, None, 1)
        gc.gap_commit(*a)
        torch.cuda.synchronize()
        stamps, ids = (ctypes.c_longlong * 4096)(), (ctypes.c_int * 4096)()
        n = lib.gap_commit_stamps(stamps, ids, 0)
        sums = {}
        for i in range(1, n):
            label = PHASE_MARKS[ids[i]][1]
            sums[label] = sums.get(label, 0) + stamps[i] - stamps[i - 1]
        total = stamps[n - 1] - stamps[0]
        print(f'gap_commit {tag}: {times[tag] * 1e3:.2f} us a launch '
              f'unstamped; {total} cycles from the first stamp to the last '
              f'in block 0; ' + ', '.join(f'{k} {v} ({v / total:.1%})'
                                          for k, v in sums.items())
              + f'; {card}', flush=True)


if __name__ == '__main__':
    main()
