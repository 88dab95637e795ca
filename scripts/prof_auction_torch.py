#!/usr/bin/env python3
"""Time the port's association solvers on production-shaped inputs: the
torch twin of scripts/prof_auction.py (the bench workload's stage-1 regime:
~64 live track rows, ~40 valid detections, near-tie appearance costs, in
128 x 128 padded matrices; ``chip_smoke.stage1_case``).

    python3 scripts/prof_auction_torch.py [--iters N] [--json PATH]

On one CUDA card, at 1 and 8 streams (each stream its own seed), for
``auction_lap`` on the stage-1 cost (one stage) and for the tracker's whole
cascade (``ops.assignment.cascade_auction``: four appearance + motion
stages by track age, then the two IoU stages) on the stage-1 cost and an
IoU-like cost, it prints:

- the kernel's bidding rounds and bids by stream, stage and eps phase;
- the host syncs a call of the kernel (0 expected) and of the plain loop
  (``auction_lap_reference`` / ``cascade_reference``), as torch's CUDA sync
  debug mode counts them;
- times: the kernel's device time a call (CUDA events around ``--iters``
  calls of the C entry, queued behind a sleep kernel), the wrapper's time
  and its host time a call, and the plain loop's time a call
  (synchronised), with the card's name and power limit.

chip_smoke.py phase 19 holds the kernel against the plain loop on these
cases, bit for bit; this script only measures.
"""
import argparse
import json
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--json', help='write the results here as JSON')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('prof_auction_torch: needs a CUDA device')
    from fastmot_tpu_torch.ops import assignment as asg
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(f'card: {card}; torch {torch.__version__}', flush=True)
    lib = asg.assoc_solvers_library()
    eps = 1e-2
    results = {'card': card, 'cases': {}}
    for n_streams in (1, 8):
        (cost, rv, cv), cascade_args = smoke.stage1_case(n_streams)
        runs = {
            'auction': (
                asg.cascade_launch_args((cost,), (rv,), (0,), (False,), cv,
                                        None, eps, row4col=True,
                                        rounds=True),
                lambda: asg.auction_lap(cost, rv, cv, eps),
                lambda: asg.auction_lap_reference(cost, rv, cv, eps)),
            'cascade': (
                asg.cascade_launch_args(*cascade_args, eps, rounds=True),
                lambda: asg.cascade_auction(*cascade_args, eps),
                lambda: asg.cascade_reference(*cascade_args, eps))}
        row = {}
        for name, ((outs, c_args, keep), kernel, plain) in runs.items():
            if lib.cascade_auction_forward(*c_args):
                raise RuntimeError(f'{name}: launch failed')
            torch.cuda.synchronize()
            row[name] = {
                'rounds': outs[3].cpu().tolist(),
                'bids': int(outs[4].sum()),
                'syncs': {'kernel': smoke.count_syncs(kernel),
                          'plain': smoke.count_syncs(plain)},
                'ms': {'device': smoke.lk_device_ms(
                    lib.cascade_auction_forward, c_args, n=args.iters,
                    tag=name),
                       'wrapper': smoke.launches_ms(kernel),
                       'host': smoke.host_ms(kernel),
                       'plain': smoke.wall_ms(plain, n=5, warmup=1)}}
            del keep
            r = row[name]
            print(f'{n_streams} stream(s), {name}: rounds by stream, '
                  f'stage and phase {r["rounds"]}; {r["bids"]} bids; host '
                  f'syncs a call {r["syncs"]}; ms: ' + '; '.join(
                      f'{k} {v:.4f}' for k, v in r['ms'].items())
                  + f'; {card}', flush=True)
        results['cases'][f'{n_streams}_streams'] = row
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(results, f, indent=1)


if __name__ == '__main__':
    main()
