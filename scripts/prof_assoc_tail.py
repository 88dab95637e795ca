#!/usr/bin/env python3
"""Where the NMS, SSD-merge and commit kernels spend their cycles, on the
card: stamped builds of csrc/nms_waves.cu and csrc/assoc_commit.cu
(scripts/kernel_stamps.py) run on chip_smoke.py phase 20's contested cases
(1,024 same-label boxes in chains eight waves deep; 800 SSD rows whose
components span the tiles; the full-width contested commit) and on
tests/test_torch_assoc_commit.py's full-width frame-like commit, one stream
each.

    python3 scripts/prof_assoc_tail.py

For each launch's blocks it prints, for every pair of stamps in a row (the
mark before, the mark after), how often it occurred and its cycles in all
and on average: the NMS's pack blocks, the waves launch's wait for them,
its staging of the bits and each wave's two halves; the merge's staging of
the edges and its rounds; the commit's phases (rectify, the scatters, the
lifecycle, the ranks, a slot a thread, the history, the plan; the rows
launch's wait and its rows, its first block). Each
stamp takes an atomic on one counter in device memory, which the cycles
include (about 800 cycles a stamp on an H100); with the card's name and
power limit.
"""
import collections
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import kernel_stamps  # noqa: E402

# (name, the kernel's text with '@' where the stamp goes)
NMS_MARKS = [
    ('pack start', '  const int w = blockIdx.x, b = blockIdx.y, n = p.n;@'),
    ('pack end', '    out[j] = word;\n  }\n@}'),
    ('waves start', '@  cudaGridDependencySynchronize();\n'
                    '  const unsigned* bits'),
    ('pack done', '  cudaGridDependencySynchronize();\n@'
                  '  const unsigned* bits'),
    ('bits staged', 'smem_bits[x] = bits[x];\n  __syncthreads();\n@'),
    ('wave', '    if (!__syncthreads_or(mine)) break;\n@'),
    ('wave whole', '    __syncthreads();   // the wave is whole\n@'),
    ('waves end', '@  for (int j = tid; j < n; j += nt)\n    p.keep[row + j]'),
    ('merge start', '@#pragma unroll 4\n  for (int x = tid; x < n * nw;'),
    ('edges staged', 'lbl[0][i] = p.valid[row + i] ? i : n;\n@'),
    ('round', '    cur ^= 1;\n@'),
]
COMMIT_MARKS = [
    ('start', '  const int T = p.t, D = p.d, H = p.h;\n@'),
    ('rectify', '@  // ---- the scatters'),
    ('scatters', '@  // ---- 2. lifecycle decisions'),
    ('lifecycle', '@  // ---- 3. ranks'),
    ('ranks', '@  // ---- 4. a thread a track slot'),
    ('slots', '@  // ---- 5. the history'),
    ('history', '@  // ---- 6. the plan of the wide rows'),
    ('plan written', '      kp[2 * i + 1] = create_det[i] >= 0;\n    }\n'
                     '  }\n@}'),
    ('rows launched', '@  cudaGridDependencySynchronize();\n'
                      '  const int first'),
    ('rows start', '  cudaGridDependencySynchronize();\n@'
                   '  const int first'),
    ('rows end', '        o_kpv[r * K + x] = kpv[kp[0] * K + x] && !kp[1];\n'
                 '    }\n  }\n@}'),
]


def breakdown(lib, marks, launch, blocks=(0,)):
    """Runs ``launch()`` twice (the second counted) and prints each block's
    cycles between consecutive stamps, by pair of marks."""
    for _ in range(2):
        kernel_stamps.read_stamps(lib)
        launch()
        torch.cuda.synchronize()
        mark, block, clock, _ = kernel_stamps.read_stamps(lib)
    for b in blocks:
        m, c = mark[block == b], clock[block == b]
        pairs = collections.defaultdict(lambda: [0, 0])
        for a, z, c0, c1 in zip(m[:-1], m[1:], c[:-1], c[1:]):
            key = f'{marks[a][0]} -> {marks[z][0]}'
            pairs[key][0] += 1
            pairs[key][1] += int(c1 - c0)
        print(f'  block {b}: {len(m)} stamps, {int(c[-1] - c[0])} cycles')
        for key, (n, cyc) in sorted(pairs.items(), key=lambda kv: -kv[1][1]):
            print(f'    {key:30s} {n:5d} x {cyc / n:9.1f} = {cyc:9d} cycles')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('prof_assoc_tail: needs a CUDA device')
    import tests.test_torch_assoc_commit as tc
    import tests.test_torch_nms_kernel as tn
    from fastmot_tpu_torch.kalman import KalmanConfig
    from fastmot_tpu_torch.ops import assoc_commit as ac
    from fastmot_tpu_torch.ops import geometry as geom
    from fastmot_tpu_torch.ops import nms_waves as nw
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    lib_n = nw.declare(kernel_stamps.stamped_library(
        'nms_waves', [m for _, m in NMS_MARKS]))
    lib_c = ac.declare(kernel_stamps.stamped_library(
        'assoc_commit', [m for _, m in COMMIT_MARKS]))

    b, s, v = (torch.as_tensor(a, device='cuda')
               for a in tn.contested_nms(seed=0))
    keep, args, inputs = nw.suppress_launch_args(
        geom.diou_matrix(b, 0.6)[None], s[None], v[None], 0.5)
    print(f'contested NMS (1,024 boxes, 8 waves): pack blocks 0 and 31, '
          f'then the waves block 0; {card}', flush=True)
    breakdown(lib_n, NMS_MARKS,
              lambda: lib_n.greedy_suppress_forward(*args), blocks=(0, 31))
    del inputs
    edge, valid = (torch.as_tensor(a, device='cuda')
                   for a in tn.contested_merge(0))
    labels, args, inputs = nw.merge_launch_args(edge, valid)
    print(f'contested merge (800 rows); {card}', flush=True)
    breakdown(lib_n, NMS_MARKS, lambda: lib_n.merge_labels_forward(*args))
    del inputs
    for kind in ('full_width', 'contested_full'):
        if kind == 'contested_full':
            call = smoke.contested_commit_args(1)
        else:
            states, hists, dets, embs, casc, history_size = tc.torch_case(
                tc.commit_case(kind, tc.CASE_SEEDS[kind]))
            call = (KalmanConfig(), tc.CONFIRM, tc.MAX_AGE, history_size,
                    tuple(a.cuda() for a in states),
                    tuple(a.cuda() for a in hists),
                    tuple(a.cuda() for a in dets), embs.cuda(), tc.FRAME_ID,
                    tc.T(tc.FRAME).cuda(), tuple(a.cuda() for a in casc))
        outputs, args = ac.commit_launch_args(*call)
        print(f'commit, {kind} (128 slots, 128 detections, 64 history '
              f'slots, 512 features); {card}', flush=True)
        breakdown(lib_c, COMMIT_MARKS,
                  lambda: lib_c.assoc_commit_forward(*args))
        del outputs


if __name__ == '__main__':
    main()
