#!/usr/bin/env python3
"""Where the gap-commit kernels (fastmot_tpu_torch/csrc/gap_commit.cu)
spend their time, on one NVIDIA GPU:

    python3 scripts/prof_gap_commit.py [--launches 100]

It builds a copy of the source that records, in thread 0 of every block,
``clock64`` and the global timer at each phase boundary
(scripts/kernel_stamps.py), runs it once on the synthetic camera case of
tests/test_torch_gap_commit.py at 1 stream x flow budget 48 and at 8
streams x 128, with the main path's 256 background points, and prints
for each role (the homography and similarity roles of the first launch,
the Kalman role of the second) the SM cycles each phase took in the
role's first block, and when (global timer, ns from the first stamp of
the call) each role's
first block started and ended, beside the device time a launch of the
unstamped kernels (CUDA events around ``--launches`` calls queued behind
a sleep, as chip_smoke.py phase 17 times them).
"""
import argparse
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import kernel_stamps  # noqa: E402
import tests.test_torch_gap_commit as tg  # noqa: E402
from fastmot_tpu_torch.ops import gap_commit as gc  # noqa: E402
from fastmot_tpu_torch.ops.flow_kernels import BG_KP  # noqa: E402

# (text in csrc/gap_commit.cu, the phase that ends there, role): the stamp
# goes where the text has '@'; a role's first mark starts its clock
PHASE_MARKS = [
    ('@  const int s = block / kHParts, part = block % kHParts;',
     'start', 'homography'),
    ('@  const float cntf = n_valid > 1.f ? n_valid : 1.f;',
     'staging + Hartley', 'homography'),
    ('@  // a hypothesis a thread', 'order', 'homography'),
    ('@  if (part == 0) {\n#pragma unroll\n    for (int i = 0; i < 9; ++i) '
     'sc.hyps', 'draws + 8x8 solves', 'homography'),
    ('  sc.counts[part * kHypH + tid] = score;\n@',
     'scores (a share of the points)', 'homography'),
    ('@  const int f_cap = p.f_cap;\n  const int blocks = (f_cap + kWarps',
     'start', 'similarity'),
    ('@  if (t < f_cap) {\n    const Keys keys', 'staging the boxes',
     'similarity'),
    ('@    tp[warp][lane] = a;', 'matches', 'similarity'),
    ('@    // 64 two-point hypotheses', 'order', 'similarity'),
    ('@    const int best = kHypA - 1 - key % kHypA;',
     'hypotheses + arg-max', 'similarity'),
    ('@    const uint32_t bits = __ballot_sync(kFull, inl && ok);', 'refits',
     'similarity'),
    ('      sc.kp_bits[t] = bits;\n@', 'estimate', 'similarity'),
    ('@  const int s = block / blocks, part = block % blocks;', 'start',
     'Kalman'),
    ('@  if (tid < f_cap) {\n    const int64_t slot = p.forder',
     'loads', 'Kalman'),
    ("@  // the slot's inputs, and its keypoints' copy, need nothing",
     'slot scatter + staging + Hartley', 'Kalman'),
    ('@  // ---- launch 1 done', 'slot inputs + keypoints copied', 'Kalman'),
    ('@  const Scratch sc = scratch_of(p, s);\n  {\n    int score = 0;',
     'waiting for launch 1', 'Kalman'),
    ("@    // two guarded refits over the inliers' DLT rows",
     'arg-max + inliers', 'Kalman'),
    ('@      tree_sum<44>(terms, sm.red, nrm);',
     'refits: terms (and rescores)',
     'Kalman'),
    ('@      if (tid < 32) chol_factor_rows(nrm, lmat);',
     'refits: the 44 sums\' tree', 'Kalman'),
    ('@      if (tid == 0) {\n        float l[8][8], rhs[8];',
     'refits: 8x8 factor (warp 0)', 'Kalman'),
    ('@      const bool inl_new = valid_pt && h_err2(h_ref',
     'refits: substitutions (thread 0)', 'Kalman'),
    ('@    if (tid < 9) {\n      const float h22', 'refits: rescores',
     'Kalman'),
    ('@  // ---- Kalman and commit', 'h22 + info', 'Kalman'),
    ('@    __syncwarp();\n    // row r\'s nonzeros, in order',
     'Kalman: slot, a Jacobian row', 'Kalman'),
    ('@  // predict with size-scaled', 'Kalman warp: J C J^T', 'Kalman'),
    ('@  // the correction by the flow', 'Kalman predict', 'Kalman'),
    ('@  // as_tlbr, then intersection', 'Kalman update', 'Kalman'),
    ('@  if (!has_slot) return;', 'commit', 'Kalman'),
    ('  o[slot] = ev && in_flow;\n@', 'writes', 'Kalman'),
]
ROLES = ('homography', 'similarity', 'Kalman')


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
    for tag, a in cases.items():       # the unstamped kernels first
        _, launch = gc.gap_commit_launch_args(*a)
        times[tag] = chip_smoke.lk_device_ms(
            gc.gap_commit_library().gap_commit_forward, launch,
            n=args.launches, tag='gap_commit')
    from fastmot_tpu_torch.ops import cuda_build
    lib = kernel_stamps.stamped_library(
        'gap_commit', [m for m, _, _ in PHASE_MARKS])
    cuda_build.load = lambda name: lib
    gc.gap_commit_library.cache_clear()
    for tag, a in cases.items():
        gc.gap_commit(*a)
        torch.cuda.synchronize()
        kernel_stamps.read_stamps(lib)
        gc.gap_commit(*a)
        torch.cuda.synchronize()
        mark, block, clock, time = kernel_stamps.read_stamps(lib)
        t0 = time.min()
        parts = []
        for role in ROLES:
            ids = [i for i, m in enumerate(PHASE_MARKS) if m[2] == role]
            ours = np.isin(mark, ids)
            mine = np.flatnonzero(ours & (block == block[ours].min()))
            sums = {}
            for a_, b_ in zip(mine, mine[1:]):
                label = PHASE_MARKS[mark[b_]][1]
                sums[label] = sums.get(label, 0) + clock[b_] - clock[a_]
            total = clock[mine[-1]] - clock[mine[0]]
            parts.append(
                f'{role} block 0 at {time[mine[0]] - t0}-'
                f'{time[mine[-1]] - t0} ns, {total} cycles: '
                + ', '.join(f'{k} {v} ({v / total:.1%})'
                            for k, v in sums.items()))
        print(f'gap_commit {tag}: {times[tag] * 1e3:.2f} us a call '
              f'unstamped (two launches); ' + '; '.join(parts)
              + f'; {card}', flush=True)


if __name__ == '__main__':
    main()
