#!/usr/bin/env python3
"""Where the association solvers' kernels spend their cycles, on the card:
a stamped build of csrc/assoc_solvers.cu (scripts/kernel_stamps.py) run on
chip_smoke.py's contested stage-1 cascade and its one-stage auction, on the
main-path-like frame of scripts/prof_auction_torch.py, and on the
contested greedy problems, one stream each.

    python3 scripts/prof_assoc_solvers.py

For the first block of each launch it prints, for every pair of stamps in a
row (the mark before, the mark after), how often it occurred and its
cycles in all and on average: the set-up of the launch, a stage's scan of
its live rows, the pre-assignment, each round of many bidders, a lone
bidder's chain, the phase and stage ends; the greedy's rounds and its
rescans. Each stamp takes an atomic on one counter in device memory, which
the cycles include (about 800 cycles a stamp on an H100, the shortest
pairs); with the card's name and power limit.
"""
import collections
import ctypes
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import kernel_stamps  # noqa: E402
from prof_auction_torch import frame_case  # noqa: E402

# (name, the kernel's text with '@' where the stamp goes)
MARKS = [
    ('start', '@  cudaTriggerProgrammaticLaunchCompletion();'),
    ('set-up done', '@  for (int k = 0; k < p.n_stages; ++k) {\n    Stage st;'),
    ('stage', '    Stage st;@\n'),
    ('live rows scanned', '    any_odd = __syncthreads_or(any_odd);@'),
    ('phase', '    for (int ph = 0; ph < p.n_phases; ++ph, eps *= 0.125f) {@'),
    ('round of many', '        ++rounds;\n        __syncthreads();\n'
                      '        u = count_bits(unassigned, W);@'),
    ('lone chain', '        __syncthreads();\n        if (warp == 0) {@'),
    ('phase end', '      __syncthreads();\n@      if (tid == 0) {\n'
                  '        if (p.rounds_out)'),
    ('stage end', 'unassigned[tid] = 0u;\n    __syncthreads();@'),
    ('end', '@  if (!staged) stage_wait_bulk(&bar, bulk);'),
    ('greedy rows', "@  // each live row's least key"),
    ('greedy round', '  for (;;) {@\n'
                     '    const unsigned long long best = warp_min64(mine);'),
    ('greedy rescanned', '    __syncwarp();\n    mine = lane_min();@'),
]


def breakdown(lib, launch, blocks=(0,)):
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
            key = f'{MARKS[a][0]} -> {MARKS[z][0]}'
            pairs[key][0] += 1
            pairs[key][1] += int(c1 - c0)
        print(f'  block {b}: {len(m)} stamps, {int(c[-1] - c[0])} cycles')
        for key, (n, cyc) in sorted(pairs.items(), key=lambda kv: -kv[1][1]):
            print(f'    {key:36s} {n:5d} x {cyc / n:9.1f} = {cyc:9d} cycles')


def main():
    if not torch.cuda.is_available():
        raise SystemExit('prof_assoc_solvers: needs a CUDA device')
    from fastmot_tpu_torch.ops import assignment as asg
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    lib = kernel_stamps.stamped_library('assoc_solvers',
                                        [m for _, m in MARKS])
    for entry in (lib.cascade_auction_forward, lib.greedy_match_forward):
        entry.argtypes = asg.FORWARD_ARGTYPES
        entry.restype = ctypes.c_int
    eps = 1e-2
    (cost, rv, cv), stage1 = smoke.stage1_case(1)
    frame, _ = frame_case(1)
    for name, call, kw in (
            ('stage-1 cascade', stage1, {}),
            ('stage-1 auction', ((cost,), (rv,), (0,), (False,), cv, None),
             {'row4col': True}),
            ('frame cascade', frame, {})):
        outs, args, keep = asg.cascade_launch_args(*call, eps, **kw)
        print(f'{name}, one stream; {card}', flush=True)
        breakdown(lib, lambda: lib.cascade_auction_forward(*args))
        del keep
    problems = smoke.contested_greedy(
        [(torch.zeros((1, 64, 128), device='cuda'), None, None, 0.45),
         (torch.zeros((1, 128, 128), device='cuda'), None, None, 0.2)],
        seed=1)
    outs, args, keep = asg.greedy_launch_args(problems)
    print(f'contested greedy problems (reID block 0, rectify block 1); '
          f'{card}', flush=True)
    breakdown(lib, lambda: lib.greedy_match_forward(*args), blocks=(0, 1))


if __name__ == '__main__':
    main()
