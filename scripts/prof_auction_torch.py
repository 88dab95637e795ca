#!/usr/bin/env python3
"""Time the port's association solvers on production-shaped inputs: the
torch twin of scripts/prof_auction.py (the bench workload's stage-1 regime:
~64 live track rows, ~40 valid detections, near-tie appearance costs, in
128 x 128 padded matrices; ``chip_smoke.stage1_case``), beside a main-path
frame (40 tracks on 40 detections, which settles in a round or two).

    python3 scripts/prof_auction_torch.py [--iters N] [--json PATH]
        [--other ROOT] [--sweep]

On one CUDA card, at 1 and 8 streams (each stream its own seed), for
``auction_lap`` on the stage-1 cost (one stage) and for the tracker's whole
cascade (``ops.assignment.cascade_auction``: four appearance + motion
stages by track age, then the two IoU stages) on the stage-1 and the frame
costs, it prints:

- the kernel's bidding rounds and bids by stream, stage and eps phase;
- the host syncs a call of the kernel (0 expected) and of the plain loop
  (``auction_lap_reference`` / ``cascade_reference``), as torch's CUDA sync
  debug mode counts them;
- times: the kernel's device time a call (CUDA events around ``--iters``
  calls of the C entry, queued behind a sleep kernel) with the rounds and
  bids output off and on, the wrapper's time and its host time a call, and
  the plain loop's time a call (synchronised), with the card's name and
  power limit;
- the greedy entry on the finals' two problems of chip_smoke.py's
  contested shapes, and the finals launch (``finals_forward``: masks,
  rectify cost, both matches) on ``chip_smoke.contested_finals`` and on the
  frame's finals.

``--other ROOT`` builds ROOT's ``fastmot_tpu_torch/csrc/assoc_solvers.cu``
with this checkout's nvcc flags (the C entries ``cascade_auction_forward``
and ``greedy_match_forward`` take the same arguments) and times both
libraries on the same calls in turns (this, other, other, this), after
holding the other's outputs (rounds and bids too) equal to this one's, bit
for bit. ``--sweep`` times this library's cascade (1,024 threads, a lone
bidder's rounds on warp 0 alone) against variants built from its source
with the text of the launch or of the rounds' loop rewritten (``SWEEP``):
blocks of 512 threads, and a lone bidder's rounds on the whole block as
every other round, in turns, after holding each variant's outputs equal to
this one's. chip_smoke.py phase 19 holds the kernels against the plain
versions on these cases' kind; this script measures.
"""
import argparse
import ctypes
import json
import os
import subprocess
import sys
import tempfile
from pathlib import Path

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def frame_case(n_streams, seed=0):
    """A main-path association frame's cascade and finals arguments, [S,
    ...] on the card: 40 confirmed tracks of age 0 each near its own
    detection (cost 0.1-0.3 on its detection, the rest gated; the IoU cost
    likewise), padded to 128; 40 detections; a history store of 64 rows, 10
    of them usable. The first stage matches every track, and the other five
    have no live row (the IoU stage of active tracks excludes the matched
    ones)."""
    rng = np.random.default_rng(seed)
    cap, live = 128, 40
    cost = np.full((n_streams, cap, cap), 1e5, np.float32)
    iou = np.full((n_streams, cap, cap), 1e5, np.float32)
    tlbrs = np.zeros((n_streams, cap, 4), np.float32)
    d_tlbrs = np.zeros((n_streams, cap, 4), np.float32)
    for s in range(n_streams):
        perm = rng.permutation(live)
        cost[s, np.arange(live), perm] = rng.uniform(0.1, 0.3, live)
        iou[s, np.arange(live), perm] = rng.uniform(0.05, 0.2, live)
        xy = rng.uniform(0, 1200, (live, 2))
        d_tlbrs[s, :live] = np.concatenate([xy, xy + 60], 1)
        tlbrs[s, :live] = d_tlbrs[s, perm] + rng.normal(0, 1, (live, 4))
    valid = np.arange(cap) < live
    masks = [valid] + [np.zeros(cap, bool)] * 3 + [valid, np.zeros(cap, bool)]

    def dev(a):
        return torch.as_tensor(a, device='cuda')
    col4row = dev(np.full((n_streams, cap), -1, np.int32))
    call = ((dev(cost), dev(iou)),
            tuple(dev(np.broadcast_to(m, (n_streams, cap)).copy())
                  for m in masks),
            (0,) * 4 + (1, 1), (False,) * 4 + (True, False),
            dev(np.broadcast_to(valid, (n_streams, cap)).copy()), col4row)
    hist = 64
    finals = (0.5, 0.45, 0.2, 3, dev(tlbrs), call[1][0],
              dev(np.zeros((n_streams, cap), np.int32)),
              dev(np.full((n_streams, cap), 5, np.int32)), dev(d_tlbrs),
              dev(np.full((n_streams, cap), 0.9, np.float32)),
              dev(rng.uniform(0, 1, (n_streams, hist, cap)).astype(
                  np.float32)),
              dev(np.broadcast_to(np.arange(hist) < 10,
                                  (n_streams, hist)).copy()),
              dev(np.zeros((n_streams, cap), bool)))
    return call, finals


# the sweep's variants of this checkout's source: (text, replacement)
# pairs, each text found once
SWEEP = {
    '512 threads': [('<<<grid, kCascadeThreads, smem', '<<<grid, 512, smem')],
    'no lone chain': [('while (u > 1 && rounds', 'while (u > 0 && rounds')]}
SWEEP['512 threads, no lone chain'] = (SWEEP['512 threads']
                                       + SWEEP['no lone chain'])


def source_library(src, tag):
    """The source text of csrc/assoc_solvers.cu ``src`` built with this
    checkout's flags."""
    from fastmot_tpu_torch.ops import assignment as asg
    from fastmot_tpu_torch.ops import cuda_build
    tmp = Path(tempfile.mkdtemp())
    cu, out = tmp / f'assoc_solvers_{tag}.cu', tmp / f'assoc_solvers_{tag}.so'
    cu.write_text(src)
    subprocess.run([cuda_build.find_nvcc(),
                    *cuda_build.nvcc_flags('assoc_solvers'), '-o', str(out),
                    str(cu)], check=True, capture_output=True)
    lib = ctypes.CDLL(str(out))
    for entry in (lib.cascade_auction_forward, lib.greedy_match_forward):
        entry.argtypes = asg.FORWARD_ARGTYPES
        entry.restype = ctypes.c_int
    return lib


def other_library(root):
    """ROOT's csrc/assoc_solvers.cu built with this checkout's flags."""
    return source_library((Path(root) / 'fastmot_tpu_torch' / 'csrc'
                           / 'assoc_solvers.cu').read_text(), 'other')


def sweep_libraries():
    """Each of ``SWEEP``'s variants of this checkout's source, built."""
    from fastmot_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / 'assoc_solvers.cu').read_text()
    libs = {}
    for k, (tag, edits) in enumerate(SWEEP.items()):
        text = src
        for old, new in edits:
            if text.count(old) != 1:
                raise RuntimeError(f'{tag}: {old!r} not in the source once')
            text = text.replace(old, new)
        libs[tag] = source_library(text, f'sweep{k}')
    return libs


def run(entry, args, outs):
    """One call of a C entry; its outputs copied to the host."""
    if entry(*args):
        raise RuntimeError('launch failed')
    return [o.cpu() for o in outs if o is not None]


def turns(named, args, iters):
    """Device ms a call of each (name, entry) on ``args``, in turns: in
    order, then back (the first, the second, the second, the first)."""
    times = {name: [] for name, _ in named}
    for name, entry in named + named[::-1]:
        times[name].append(smoke.lk_device_ms(entry, args, n=iters,
                                              tag=name))
    return times


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--json', help='write the results here as JSON')
    ap.add_argument('--other', help='the root of a checkout to compare')
    ap.add_argument('--sweep', action='store_true')
    args = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('prof_auction_torch: needs a CUDA device')
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import assignment as asg
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    print(f'card: {card}; torch {torch.__version__}', flush=True)
    lib = asg.assoc_solvers_library()
    other = other_library(args.other) if args.other else None
    variants = sweep_libraries() if args.sweep else {}
    eps = 1e-2
    results = {'card': card, 'cases': {}}

    def us(v):
        return '/'.join(f'{t * 1e3:.2f}' for t in v)
    for n_streams in (1, 8):
        (cost, rv, cv), stage1 = smoke.stage1_case(n_streams)
        frame, frame_finals = frame_case(n_streams)
        cascades = {
            'auction': (((cost,), (rv,), (0,), (False,), cv, None),
                        {'row4col': True},
                        lambda: asg.auction_lap(cost, rv, cv, eps),
                        lambda: asg.auction_lap_reference(cost, rv, cv, eps)),
            'stage1 cascade': (stage1, {},
                               lambda: asg.cascade_auction(*stage1, eps),
                               lambda: asg.cascade_reference(*stage1, eps)),
            'frame cascade': (frame, {},
                              lambda: asg.cascade_auction(*frame, eps),
                              lambda: asg.cascade_reference(*frame, eps))}
        row = {}
        for name, (call, kw, kernel, plain) in cascades.items():
            outs, c_args, keep = asg.cascade_launch_args(
                *call, eps, rounds=True, **kw)
            _, off_args, off_keep = asg.cascade_launch_args(*call, eps, **kw)
            mine = run(lib.cascade_auction_forward, c_args, outs)
            r = row[name] = {
                'rounds': outs[3].cpu().tolist(), 'bids': int(outs[4].sum()),
                'syncs': {'kernel': smoke.count_syncs(kernel),
                          'plain': smoke.count_syncs(plain)},
                'ms': {'wrapper': smoke.launches_ms(kernel),
                       'host': smoke.host_ms(kernel),
                       'plain': smoke.wall_ms(plain, n=5, warmup=1)}}
            entries = [('this', lib.cascade_auction_forward)]
            if other is not None:
                theirs = run(other.cascade_auction_forward, c_args, outs)
                if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
                    raise AssertionError(f'{n_streams} stream(s), {name}: '
                                         'the other checkout differs')
                entries.append(('other', other.cascade_auction_forward))
            for counted, a in (('rounds off', off_args), ('rounds on', c_args)):
                t = turns(entries, a, args.iters)
                r['ms'].update({f'device {k}, {counted}': v
                                for k, v in t.items()})
            if variants:
                sweep = [('1024 threads, lone chain', lib)] + list(
                    variants.items())
                for tag, v in sweep:
                    if not all(torch.equal(a, b) for a, b in zip(
                            run(v.cascade_auction_forward, c_args, outs),
                            mine)):
                        raise AssertionError(f'{tag}: outputs differ')
                r['ms'].update({
                    f'device {k}': t for k, t in turns(
                        [(tag, v.cascade_auction_forward)
                         for tag, v in sweep], off_args,
                        args.iters).items()})
            del keep, off_keep
            print(f'{n_streams} stream(s), {name}: rounds by stream, stage '
                  f'and phase {r["rounds"]}; {r["bids"]} bids; host syncs a '
                  f'call {r["syncs"]}; us: ' + '; '.join(
                      f'{k} {us(v if isinstance(v, list) else [v])}'
                      for k, v in r['ms'].items()) + f'; {card}', flush=True)

        # the greedy entry alone on the finals' two problems (contested),
        # and the finals launch on contested and on frame finals
        template = (0.5, 0.45, 0.2, 3) + tuple(t[0] for t in frame_finals[4:])
        problems = smoke.contested_greedy(
            [(torch.zeros((n_streams, 64, 128), device='cuda'), None, None,
              0.45),
             (torch.zeros((n_streams, 128, 128), device='cuda'), None, None,
              0.2)], seed=n_streams)
        g_out, g_args, g_keep = asg.greedy_launch_args(problems)
        mine = run(lib.greedy_match_forward, g_args,
                   [t for pair in g_out for t in pair])
        entries = [('this', lib.greedy_match_forward)]
        if other is not None:
            theirs = run(other.greedy_match_forward, g_args,
                         [t for pair in g_out for t in pair])
            if not all(torch.equal(a, b) for a, b in zip(mine, theirs)):
                raise AssertionError(f'{n_streams} stream(s), greedy: the '
                                     'other checkout differs')
            entries.append(('other', other.greedy_match_forward))
        g = row['contested greedy'] = {
            'matches': [int((c >= 0).sum()) for _, c in g_out],
            'ms': {f'device {k}': v for k, v in
                   turns(entries, g_args, args.iters).items()}}
        print(f'{n_streams} stream(s), contested greedy: matches '
              f'{g["matches"]}; us: ' + '; '.join(
                  f'{k} {us(v)}' for k, v in g['ms'].items()) + f'; {card}',
              flush=True)
        del g_keep
        for name, fin in (('contested finals', smoke.contested_finals(
                template, n_streams, seed=n_streams)),
                ('frame finals', frame_finals[:13] + tuple(
                    asg.cascade_auction(*frame, eps)))):
            f_out, f_args, f_keep = asg.finals_launch_args(*fin)
            got = run(lib.finals_forward, f_args, f_out)
            f = row[name] = {
                'matches': [int((got[1] >= 0).sum()),
                            int((got[2] >= 0).sum())],
                'syncs': smoke.count_syncs(lambda: tr.finals_core(*fin)),
                'ms': {'device': smoke.lk_device_ms(
                    lib.finals_forward, f_args, n=args.iters, tag=name),
                       'wrapper': smoke.launches_ms(
                           lambda: tr.finals_core(*fin)),
                       'host': smoke.host_ms(lambda: tr.finals_core(*fin)),
                       'plain': smoke.wall_ms(
                           lambda: smoke.plain_finals(fin), n=5, warmup=1)}}
            del f_keep
            print(f'{n_streams} stream(s), {name}: reID and rectify matches '
                  f'{f["matches"]}; host syncs a call {f["syncs"]}; us: '
                  + '; '.join(f'{k} {v * 1e3:.2f}'
                              for k, v in f['ms'].items()) + f'; {card}',
                  flush=True)
        results['cases'][f'{n_streams}_streams'] = row
    if args.json:
        with open(args.json, 'w') as f:
            json.dump(results, f, indent=1)


if __name__ == '__main__':
    main()
