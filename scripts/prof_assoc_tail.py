#!/usr/bin/env python3
"""Where the NMS, SSD-merge and commit kernels spend their cycles, and how
two checkouts' commit kernels compare, on the card: stamped builds of
csrc/nms_waves.cu and csrc/assoc_commit.cu (scripts/kernel_stamps.py) run
on chip_smoke.py phase 20's contested cases (1,024 same-label boxes in
chains eight waves deep; 800 SSD rows whose components span the tiles; the
full-width contested commit) and on tests/test_torch_assoc_commit.py's
full-width frame-like commit, one stream each.

    python3 scripts/prof_assoc_tail.py [--other ROOT ...] [--only commit]
        [--no-stamps] [--iters N]

For each launch's blocks it prints, for every pair of stamps in a row (the
mark before, the mark after), how often it occurred and its cycles in all
and on average: the NMS's pack blocks, the waves launch's wait for them,
its staging of the bits and each wave's two halves; the merge's staging of
the edges and its rounds; the commit's phases (rectify, the scatters, the
lifecycle, the ranks and the matched Kalman updates, the slots, the
history, the plan; the rows launch's wait and its rows, its first block).
Each stamp takes an atomic on one counter in device memory, which the
cycles include (about 800 cycles a stamp on an H100); with the card's name
and power limit.

Times: the commit's device time a call (chip_smoke.lk_device_ms: 100 calls
of the C entry between CUDA events behind a sleep kernel) on the main
path's association frame (cfg/mot.json's YOLOv4-512 + OSNet-x0.25 at
random weights, 40 synthetic detections, run as scripts/assoc_stages_turns.py
runs it; at 8 streams its one stream repeated) and on the contested
full-width commit at 1 and 8 streams, with the wrapper's time and host
time a call and of that the C entry's. ``--other ROOT`` (repeatable)
builds ROOT's ``fastmot_tpu_torch/csrc/assoc_commit.cu`` with this
checkout's nvcc flags (its C entry takes the same arguments), holds its
outputs equal to this checkout's bit for bit on every case, and times the
libraries in turns (this, the others, then the same backwards); its
stamps too, where its source has the marks of ``OTHER_MARKS``.
"""
import collections
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
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
SSD_MARKS = [
    ('nms start', '@  const float* tile = p.tiles + 4 * t;'),
    ('rows staged', '  __syncthreads();   // the rows are staged\n@'),
    ('bits whole', '  __syncthreads();   // the bits are whole\n@'),
    ('waves end', '  run_waves<true>(bits, nullptr, remaining, wave, kept, k, '
                  'nw);\n@'),
    ('nms end', '    p.r_valid[row0 + j] = (kept[j >> 5] >> (j & 31)) & 1u;'
                '\n  }\n@}'),
    ('merge start', "@  // the NMS launch's rows\n"
                    '  cudaGridDependencySynchronize();'),
    ('nms done', "  // the NMS launch's rows\n"
                 '  cudaGridDependencySynchronize();\n@'),
    ('compacted', '  __syncthreads();   // the kept rows are staged\n@'),
    ('sorted', "  __syncthreads();   // the rows in the order of their left "
               "edges' buckets\n@"),
    ('listed', '  __syncthreads();   // every edge is listed\n@'),
    ('joined', '  __syncthreads();   // every edge is joined\n@'),
    ('labelled', "  __syncthreads();   // each row's label is its "
                 "component's least member\n@"),
    ('collapsed', "  __syncthreads();   // every member's keys are in\n@"),
    ('ordered', '  count_keys<false>(fin, reps, fin, reps, below);\n'
                '  __syncthreads();\n@'),
    ('merge end', '      p.out_keep[at] = 0;\n    }\n    carry += all;\n'
                  '  }\n@}'),
]
COMMIT_MARKS = [
    ('start', '  const int T = p.t, D = p.d, H = p.h;\n@'),
    ('armed', '@#pragma unroll\n  for (int k = 0; k < kNumStaged; ++k) '
              '{\n    unsigned char* dst = dyn + p.f_off[k];'),
    ('issued', '@#if defined(__CUDA_ARCH__)\n  asm volatile("cp.async.'
               'commit_group;'),
    ('copied', '"cp.async.commit_group;\\ncp.async.wait_group 0;\\n" :::\n'
               '               "memory");\n#endif\n@'),
    ('staged', "  __syncthreads();     // every thread's cp.async copies "
               'are in\n@'),
    ('late staged', '  stage_wait(&bar, bulk);     // the means and '
                    'covariances\n@'),
    ('rectify', '@  // ---- the scatters'),
    ('scatters', '@  // ---- 2. lifecycle decisions'),
    ('lifecycle', '@  // ---- 3. ranks'),
    ('ranks', '  if (warp == 4 % n_warps) {\n    int n = 0;\n    for (int '
              'x0 = 0; x0 < D; x0 += 32) {\n      const int x = x0 + (tid '
              '& 31);\n'
              '      n += __popc(__ballot_sync(kFull, x < D && dv[x]));\n'
              '    }\n    if ((tid & 31) == 0) n_dvalid = n;\n  }\n'
              '  __syncthreads();\n@'),
    ('updates', '@  // ---- 4. the slots: 8 lanes a slot write the rows'),
    ('slot rows', '@    const float* tlbrs = STAGED(const float, sTlbrs);'),
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
# the marks of the first design's source (a thread a slot), for --other
OTHER_MARKS = [
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
        if len(m) < 2:
            print(f'  block {b}: {len(m)} stamps')
            continue
        pairs = collections.defaultdict(lambda: [0, 0])
        for a, z, c0, c1 in zip(m[:-1], m[1:], c[:-1], c[1:]):
            key = f'{marks[a][0]} -> {marks[z][0]}'
            pairs[key][0] += 1
            pairs[key][1] += int(c1 - c0)
        print(f'  block {b}: {len(m)} stamps, {int(c[-1] - c[0])} cycles')
        for key, (n, cyc) in sorted(pairs.items(), key=lambda kv: -kv[1][1]):
            print(f'    {key:30s} {n:5d} x {cyc / n:9.1f} = {cyc:9d} cycles')


def commit_cases(streams):
    """{case: ``assoc_commit``'s arguments}: the main path's association
    frame at 1 and ``streams`` streams (its one stream repeated), and the
    contested full-width commit at 1 and ``streams``."""
    import json

    from assoc_stages_turns import run_main_path
    from fastmot_tpu_torch.utils import ConfigDecoder
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'cfg', 'mot.json')) as f:
        mot_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    mot, frames, staged, _ = run_main_path(smoke, mot_cfg)
    smoke.assoc_stages_ms(mot, frames, staged)
    one = smoke.batched_commit_args(smoke.STAGE_ARGS.pop('tail')['commit'])
    smoke.STAGE_ARGS.pop('frame', None)

    def tiled(x):
        if isinstance(x, tuple):
            return tuple(tiled(a) for a in x)
        if isinstance(x, torch.Tensor) and x.dim() and x.shape[0] == 1:
            return x.expand(streams, *x.shape[1:]).contiguous()
        return x
    many = one[:4] + tuple(tiled(a) for a in one[4:8]) + one[8:10] \
        + (tiled(one[10]),)
    return {'main_1_stream': one, f'main_{streams}_streams': many,
            'contested_1_stream': smoke.contested_commit_args(1),
            f'contested_{streams}_streams':
                smoke.contested_commit_args(streams)}


def other_package(root):
    """ROOT's ``fastmot_tpu_torch`` imported whole under another name
    (its kernels built from ROOT's sources into ROOT's csrc/build): its
    ``detector`` module."""
    import importlib
    import importlib.util
    name = 'fastmot_tpu_torch_' + ''.join(
        c if c.isalnum() else '_' for c in os.path.basename(
            os.path.abspath(root)))
    pkg = os.path.join(root, 'fastmot_tpu_torch')
    spec = importlib.util.spec_from_file_location(
        name, os.path.join(pkg, '__init__.py'),
        submodule_search_locations=[pkg])
    module = importlib.util.module_from_spec(spec)
    sys.modules[name] = module
    spec.loader.exec_module(module)
    return importlib.import_module(f'{name}.detector')


def ssd_post(opts, card):
    """``--only ssd_post``: the SSD detector's stages (chip_smoke.
    ssd_stages_ms) on chip_smoke.py phase 9's detector (SSDInceptionV2,
    cfg/mot.json's 4 x 2 tiles, random weights) and frame, and on
    tests/test_torch_ssd_post.py's crowded rows; with ``--other``, each
    checkout's ``SSDDetector._postprocess_device`` held equal to this
    one's bit for bit, then the stages in turns (this, the others, then
    the same backwards), the same detector and inputs for all."""
    import json

    import tests.test_torch_ssd_post as ts
    from fastmot_tpu_torch.detector import SSDDetector
    from fastmot_tpu_torch.models.ssd import decode_ssd
    from fastmot_tpu_torch.utils import ConfigDecoder
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    with open(os.path.join(root, 'cfg', 'mot.json')) as f:
        mot_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    det = SSDDetector(smoke.SIZE, mot_cfg['class_ids'], device='cuda',
                      **mot_cfg['ssd_detector_cfg'])
    frame = torch.as_tensor(smoke.textured_frames(smoke.SIZE, 1)[0],
                            device='cuda')
    crowded = tuple(torch.as_tensor(a, device='cuda')
                    for a in ts.crowded_rows(0))
    scalars = (det.conf_thresh, det.max_area, det.merge_thresh,
               det.model.NMS_THRESH)
    with torch.no_grad():
        det_out = decode_ssd(*det.module(det.preprocess(frame)),
                             det._anchors, det.model.TOPK)
    cases = {'the run\'s rows': (det_out, det._tiles_f, det._scale,
                                 det.label_mask),
             'crowded rows': crowded,
             'phase 8\'s rows': tuple(torch.as_tensor(a, device='cuda')
                                     for a in smoke.synthetic_ssd_rows(
                                         np.random.default_rng(42)))}
    designs = [('this', SSDDetector._postprocess_device)] + [
        (r, other_package(r).SSDDetector._postprocess_device)
        for r in opts.other]
    for case, a in cases.items():
        want = designs[0][1](*a, *scalars)
        for tag, post in designs[1:]:
            if any(not torch.equal(x, y)
                   for x, y in zip(want, post(*a, *scalars))):
                raise AssertionError(f'ssd postprocess, {case}: {tag}\'s '
                                     'outputs differ')
        print(f'ssd postprocess, {case} {tuple(a[0].shape)}: '
              f'{int(want[3].sum())} kept'
              + (', every checkout\'s outputs equal bit for bit'
                 if len(designs) > 1 else ''), flush=True)
    for tag, post in designs + designs[::-1]:
        with torch.no_grad():
            stages = smoke.ssd_stages_ms(det, frame, crowded, post)
        smoke.log_ssd_stages(f'ssd stages ({tag})', stages, card)

    # this checkout's kernels alone: stamps, then device, wrapper and host
    # times a call
    from fastmot_tpu_torch.detector import MAX_DETS
    from fastmot_tpu_torch.ops import nms_waves as nw

    def out_rows(a):
        return min(a[0].shape[0] * a[0].shape[1], MAX_DETS)
    if not opts.no_stamps:
        lib_s = nw.declare(kernel_stamps.stamped_library(
            'nms_waves', [t for _, t in SSD_MARKS]))
        for case, a in cases.items():
            outputs, args, inputs = nw.ssd_postprocess_launch_args(
                *a, *scalars, out_rows(a))
            print(f'ssd_postprocess stamps, {case}: the NMS launch\'s '
                  'blocks 0 and 7, then the merge block (block 0\'s pairs '
                  'across the two launches span two SMs\' clocks); '
                  f'{card}', flush=True)
            breakdown(lib_s, SSD_MARKS,
                      lambda: lib_s.ssd_postprocess_forward(*args),
                      blocks=(0, 7))
            del inputs
    lib = nw.nms_waves_library()
    for case, a in cases.items():
        m = out_rows(a)
        outputs, args, inputs = nw.ssd_postprocess_launch_args(
            *a, *scalars, m)
        dev = smoke.lk_device_ms(lib.ssd_postprocess_forward, args,
                                 n=opts.iters, tag=f'ssd {case}')
        call = smoke.launches_ms(lambda: nw.ssd_postprocess(*a, *scalars, m))
        host = smoke.host_ms(lambda: nw.ssd_postprocess(*a, *scalars, m))
        entry = smoke.host_ms(lambda: lib.ssd_postprocess_forward(*args))
        print(f'ssd_postprocess {case}: device {dev * 1e3:.2f} us a call; '
              f'the wrapper {call * 1e3:.2f} us a call, host '
              f'{host * 1e3:.2f} us (of it the C entry {entry * 1e3:.2f} '
              f'us); {card}', flush=True)
        del inputs


def commit_library(root, tag):
    """ROOT's csrc/assoc_commit.cu built with this checkout's flags."""
    import ctypes
    import tempfile

    from fastmot_tpu_torch.ops import assoc_commit as ac
    from fastmot_tpu_torch.ops import cuda_build
    src = os.path.join(root, 'fastmot_tpu_torch', 'csrc', 'assoc_commit.cu')
    tmp = tempfile.mkdtemp()
    so = os.path.join(tmp, f'assoc_commit_{tag}.so')
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.nvcc_flags(
        'assoc_commit'), '-o', so, src], check=True, capture_output=True)
    return ac.declare(ctypes.CDLL(so))


def main():
    import argparse
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--other', action='append', default=[],
                    help='the root of a checkout to compare (repeatable)')
    ap.add_argument('--only', choices=('commit', 'ssd_post'),
                    help='the commit alone, or the SSD postprocess alone')
    ap.add_argument('--no-stamps', action='store_true')
    ap.add_argument('--iters', type=int, default=100)
    opts = ap.parse_args()
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
    print(f'card: {card}; torch {torch.__version__}', flush=True)
    smoke.phase_build()
    if opts.only == 'ssd_post':
        ssd_post(opts, card)
        return
    stamped = [] if opts.no_stamps else [('this', ac.declare(
        kernel_stamps.stamped_library(
            'assoc_commit', [m for _, m in COMMIT_MARKS])), COMMIT_MARKS)]
    for root in ([] if opts.no_stamps else opts.other):
        src = open(os.path.join(root, 'fastmot_tpu_torch', 'csrc',
                                'assoc_commit.cu')).read()
        if all(src.count(m.replace('@', '')) == 1 for _, m in OTHER_MARKS):
            stamped.append((root, ac.declare(kernel_stamps.stamped_library(
                'assoc_commit', [m for _, m in OTHER_MARKS], source=src,
                tag=os.path.basename(root))), OTHER_MARKS))

    if opts.only != 'commit' and not opts.no_stamps:
        lib_n = nw.declare(kernel_stamps.stamped_library(
            'nms_waves', [m for _, m in NMS_MARKS]))
        b, s, v = (torch.as_tensor(a, device='cuda')
                   for a in tn.contested_nms(seed=0))
        keep, args, inputs = nw.suppress_launch_args(
            geom.diou_matrix(b, 0.6)[None], s[None], v[None], 0.5)
        print(f'contested NMS (1,024 boxes, 8 waves): pack blocks 0 and 31, '
              f'then the waves block 0; {card}', flush=True)
        breakdown(lib_n, NMS_MARKS,
                  lambda: lib_n.greedy_suppress_forward(*args),
                  blocks=(0, 31))
        del inputs
        edge, valid = (torch.as_tensor(a, device='cuda')
                       for a in tn.contested_merge(0))
        labels, args, inputs = nw.merge_launch_args(edge, valid)
        print(f'contested merge (800 rows); {card}', flush=True)
        breakdown(lib_n, NMS_MARKS, lambda: lib_n.merge_labels_forward(*args))
        del inputs
    for tag, lib_c, marks in stamped:
        for kind in ('full_width', 'contested_full'):
            if kind == 'contested_full':
                call = smoke.contested_commit_args(1)
            else:
                states, hists, dets, embs, casc, history_size = \
                    tc.torch_case(tc.commit_case(kind, tc.CASE_SEEDS[kind]))
                call = (KalmanConfig(), tc.CONFIRM, tc.MAX_AGE, history_size,
                        tuple(a.cuda() for a in states),
                        tuple(a.cuda() for a in hists),
                        tuple(a.cuda() for a in dets), embs.cuda(),
                        tc.FRAME_ID, tc.T(tc.FRAME).cuda(),
                        tuple(a.cuda() for a in casc))
            outputs, args = ac.commit_launch_args(*call)
            print(f'commit ({tag}), {kind} (128 slots, 128 detections, 64 '
                  f'history slots, 512 features); {card}', flush=True)
            breakdown(lib_c, marks,
                      lambda: lib_c.assoc_commit_forward(*args))
            del outputs

    # the device times, in turns with the other checkout's
    mine = ac.assoc_commit_library()
    others = [(root, commit_library(root, os.path.basename(root)))
              for root in opts.other]
    for case, a in commit_cases(smoke.N_STREAMS).items():
        outputs, args = ac.commit_launch_args(*a)
        flat = list(outputs[0]) + list(outputs[1]) + [outputs[2]]
        named = [('this', mine.assoc_commit_forward)] + [
            (root, lib.assoc_commit_forward) for root, lib in others]
        got = []
        for _, fn in named:
            if fn(*args):
                raise RuntimeError(f'{case}: launch failed')
            torch.cuda.synchronize()
            got.append([x.clone() for x in flat])
        for (tag, _), g in zip(named[1:], got[1:]):
            if any(not torch.equal(x, y) for x, y in zip(got[0], g)):
                raise AssertionError(f'commit {case}: {tag}\'s outputs '
                                     'differ')
        times = {tag: [] for tag, _ in named}
        for tag, fn in named + named[::-1]:
            times[tag].append(smoke.lk_device_ms(
                fn, args, n=opts.iters, tag=f'commit {case}'))
        call = smoke.launches_ms(lambda: ac.assoc_commit(*a))
        host = smoke.host_ms(lambda: ac.assoc_commit(*a))
        entry_host = smoke.host_ms(lambda: mine.assoc_commit_forward(*args))
        print(f'commit {case}: device us a call ' + '; '.join(
            f'{tag} ' + ' / '.join(f'{t * 1e3:.2f}' for t in v)
            for tag, v in times.items())
            + ' (in turns' + (', outputs equal bit for bit'
                              if len(named) > 1 else '')
            + f'); this wrapper {call * 1e3:.2f} us a call, host '
            f'{host * 1e3:.2f} us (of it the C entry {entry_host * 1e3:.2f} '
            f'us); {card}', flush=True)
        del outputs


if __name__ == '__main__':
    main()
