#!/usr/bin/env python3
"""Where the YOLO postprocess, costs and ReID-input kernels spend their
cycles, and how two checkouts' kernels compare, on the card.

    python3 scripts/prof_frame_kernels.py [--other ROOT ...] [--iters N]
        [--no-stamps] [--only NAME ...] [--json PATH]

The cases are chip_smoke.py phase 21's: the main path's association frame
(cfg/mot.json's YOLOv4-512 + OSNet-x0.25 at random weights, 40 synthetic
detections, run as scripts/assoc_stages_turns.py runs it; at 8 streams the
detector's rows of 8 drifting frames and the one stream's costs arguments
repeated), the contested NMS (16,128 decoded rows of which more than 1,024
pass the gates), the contested costs (tests/test_torch_assoc_costs.py's
full width) and the stage-1 costs, at 1 and 8 streams; and the ReID
input's: the main frame's 64 crops, 8 streams of 128 boxes (the main
path's 40 on each stream's drifting frame, the rest padding) and the
contested 64 / 8 x 128 crops past every frame edge, each in float32 and
in bf16 (what the float OSNet reads).

Stamps (unless ``--no-stamps``): stamped builds of csrc/nms_waves.cu (its
``nms_select_forward`` launches), csrc/assoc_costs.cu and
csrc/reid_crops.cu (scripts/kernel_stamps.py) on the main and contested
cases at one stream and on 64 crops with boxes past the frame's edges;
for each launch and each of its listed blocks, every pair of that
launch's stamps in a row (the mark before, the mark after), how often it
occurred and its cycles in all and on average. Each stamp takes an atomic
on one counter in device memory, which the cycles include (about 800
cycles a stamp on an H100, more where many blocks stamp at once).

Times: each case's device time a call of this checkout's C entry (100
calls between CUDA events behind a sleep kernel, chip_smoke.lk_device_ms)
and the wrapper's time and host time a call, and of that the C entry's
host time. ``--other ROOT`` (repeatable) builds ROOT's
``fastmot_tpu_torch/csrc/nms_waves.cu``, ``assoc_costs.cu`` and
``reid_crops.cu`` with this checkout's nvcc flags (their C entries take the
same arguments), holds their outputs equal to this checkout's bit for bit
on every case, and times the libraries in turns (this, the others, then
the same backwards); a ROOT's crops take the bf16 cases only where its
wrapper has ``out_dtype``. ``--only`` keeps the named kernels
(nms_select, assoc_costs, reid_crops). Every line carries the card's name
and power limit.
"""
import argparse
import ctypes
import json
import subprocess
import sys
import tempfile
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))
sys.path.insert(0, str(ROOT / 'scripts'))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import kernel_stamps  # noqa: E402

# (name, the kernel's text with '@' where the stamp goes), and the blocks
# whose stamps are printed
SELECT_MARKS = [
    ('select start', '  if (tid < kVars) m.vars[tid] = 0;\n'
                     '  __syncthreads();\n@'),
    ('keys', '  __syncthreads();   // the keys are whole\n@'),
    ('pass counted', "@      cluster.sync();   // every block's counts are "
                     'in'),
    ('pass summed', "      cluster.sync();   // every block's counts are in"
                    '\n@'),
    ('pass found', '      find_digit(total, nb, need, m.vars, m.scan);\n'
                   '      __syncthreads();\n@'),
    ('selected', "  cluster.sync();   // every block's selected keys are "
                 'compacted\n@'),
    ('gathered', '    m.sel[x] = cluster.map_shared_rank(m.mine, b)[at];\n'
                 '  }\n  __syncthreads();\n@'),
    ('ranked', '  count_keys<true>(m.sel, k, m.sel + q0, q1 - q0, m.place);\n'
               '  __syncthreads();\n@'),
    ('select end', '@  cluster.sync();   // no block leaves while another '
                   'reads its memory'),
    ('pack start', '  for (int c = tid; c < kPackCols; c += nt) col_bits[c] = '
                   '0;\n  // the select launch\'s candidates\n@'),
    ('pack rows', '      row_obj[tid] = p.c_obj[base + i];\n'
                  '    }\n  }\n  __syncthreads();\n@'),
    ('pack end', '  for (int c = tid; c < n_cols; c += nt) out[j0 + c] = '
                 'col_bits[c];\n@}'),
    ('order start', '  // the select and pack launches are done\n@'),
    ('bits staged', '@  run_waves<true>(smem_bits, nullptr, remaining, wave, '
                    'kept, k, nw);'),
    ('waves done', '  run_waves<true>(smem_bits, nullptr, remaining, wave, '
                   'kept, k, nw);\n@'),
    ('keys made', '      if (bits < kInfBits) atomicAdd(&n_below, 1);\n    }'
                  '\n  }\n  __syncthreads();\n@'),
    ('infinities placed', '  const int n_inf = carry - n_below;\n@'),
    ('order end', '    if (place < m) write_out(place, static_cast<int>(key & '
                  '0xFFFFFFFFu));\n  }\n@}'),
]
# each launch's marks (index ranges), and the blocks whose stamps are
# printed: the select's first and last blocks of stream 0, pack blocks 0
# and 127, the order's block 0
SELECT_LAUNCHES = {'select': range(0, 9), 'pack': range(9, 12),
                   'order': range(12, 18)}
SELECT_BLOCKS = {'select': (0, 7), 'pack': (0, 127), 'order': (0,)}
COSTS_MARKS = [
    ('factors start', '  const int T = p.t, H = p.h;\n@  for (int row = '
                      'threadIdx.x; row < T + H; row += blockDim.x) {'),
    ('factors end', 'p.hist_count[at] >= 2.0f;\n    }\n  }\n@}'),
    ('rows start', '  const int n_rows = T + H - row0 < kPrepRows ? T + H - '
                   'row0 : kPrepRows;\n@'),
    ('masks, factors', '@  if (!products) return;   // (the whole block '
                       'alike)\n  // the averaged features'),
    ('first pass', '@  if (summer) {\n    const float norm'),
    ('rows normalised', '+ row0 + r_sum] = sq2;\n  }\n@}'),
    ('dets start', '  const int j1 = j0 + kDetBlock < D ? j0 + kDetBlock : D;'
                   '\n@'),
    ('occlusion', '@  if (!products) return;   // (the whole block alike)\n'
                  '  // |b|^2'),
    ('dets b2', '    p.b2[static_cast<size_t>(s) * D + j0 + tid] = b2;\n@'),
    ('tile start', '  const int stage = 2 * kRows * kChunkStride;\n@'),
    ('tile waited', '  cudaGridDependencySynchronize();\n@  // the prep '
                    "launch's: the rows' features first"),
    ('chunk summed', '      __syncthreads();   // the stage is read before it '
                     'is copied into again\n@'),
    ('products', '@  copies_wait<0>();\n  __syncthreads();   // occ, b2, a2 '
                 'and the factors are whole'),
    ('tile end', 'box_r, empty_r);\n  }\n@}'),
]
# the prep's factor block 0, row block 1 (rows 0-3) and detection block
# 49 (detections 0-7 at T + H = 192), the tile's blocks 0 and 95 (the last
# at T = D = 128, H = 64)
COSTS_LAUNCHES = {'prep factors': range(0, 2), 'prep rows': range(2, 6),
                  'prep detections': range(6, 9), 'tile': range(9, 14)}
COSTS_BLOCKS = {'prep factors': (0,), 'prep rows': (1,),
                'prep detections': (49,), 'tile': (0, 95)}
CROPS_MARKS = [
    ('start', '  const int s = n / p.boxes_a_stream;\n@'),
    ('taps', '  const size_t frame = static_cast<size_t>(s) * H * W * 3;\n'
             '  const int groups = (ow + kPixels - 1) / kPixels;\n'
             '  __syncthreads();\n@'),
    ('column pass', '      }\n    }\n    __syncthreads();\n@  }'),
    ('end', '                     + j0) * 3, npix, o);\n  }\n@}'),
]


def breakdown(lib, marks, launches, blocks, launch):
    """Runs ``launch()`` twice (the second counted) and prints, for each
    launch of ``launches`` ({name: the indices of its marks}) and each of
    its ``blocks``, the cycles between consecutive stamps of that launch
    (a block's stamps of other launches, which ran on other SMs, apart),
    by pair of marks."""
    import collections
    for _ in range(2):
        kernel_stamps.read_stamps(lib)
        launch()
        torch.cuda.synchronize()
        mark, block, clock, _ = kernel_stamps.read_stamps(lib)
    for name, idx in launches.items():
        for b in blocks[name]:
            keep = (block == b) & np.isin(mark, list(idx))
            m, c = mark[keep], clock[keep]
            if len(m) < 2:
                continue
            pairs = collections.defaultdict(lambda: [0, 0])
            for a, z, c0, c1 in zip(m[:-1], m[1:], c[:-1], c[1:]):
                key = f'{marks[a][0]} -> {marks[z][0]}'
                pairs[key][0] += 1
                pairs[key][1] += int(c1 - c0)
            print(f'  {name} block {b}: {len(m)} stamps, '
                  f'{int(c[-1] - c[0])} cycles')
            for key, (n, cyc) in sorted(pairs.items(),
                                        key=lambda kv: -kv[1][1]):
                print(f'    {key:34s} {n:5d} x {cyc / n:9.1f} = {cyc:9d} '
                      'cycles')


def source_library(name, src, tag, defines=()):
    """``src`` (a version of csrc/<name>.cu) built with this checkout's
    nvcc flags for ``name`` (and ``defines``), its forward entry declared
    as this checkout's."""
    from fastmot_tpu_torch.ops import assoc_commit as ac
    from fastmot_tpu_torch.ops import assoc_costs as acost
    from fastmot_tpu_torch.ops import cuda_build
    from fastmot_tpu_torch.ops import nms_waves as nw
    from fastmot_tpu_torch.ops import reid_crops as rc
    tmp = Path(tempfile.mkdtemp())
    cu, so = tmp / f'{name}_{tag}.cu', tmp / f'{name}_{tag}.so'
    cu.write_text(src)
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.nvcc_flags(name),
                    *defines, '-o', str(so), str(cu)], check=True,
                   capture_output=True)
    lib = ctypes.CDLL(str(so))
    entry, argtypes = {
        'nms_waves': ('nms_select_forward', nw.SELECT_ARGTYPES),
        'assoc_costs': ('assoc_costs_forward', acost.FORWARD_ARGTYPES),
        'reid_crops': ('reid_crops_forward', rc.FORWARD_ARGTYPES),
        'assoc_commit': ('assoc_commit_forward', ac.FORWARD_ARGTYPES)}[name]
    getattr(lib, entry).argtypes = argtypes
    getattr(lib, entry).restype = ctypes.c_int
    return lib


def other_libraries(root, names):
    """ROOT's libraries of ``names`` (its postprocess, costs and crops),
    built with this checkout's flags."""
    csrc = Path(root) / 'fastmot_tpu_torch' / 'csrc'
    return {name: source_library(name, (csrc / f'{name}.cu').read_text(),
                                 Path(root).name)
            for name in names}


def takes_bf16(root):
    """Whether ROOT's crops kernel writes bf16 (its wrapper takes
    ``out_dtype``)."""
    return 'out_dtype' in (Path(root) / 'fastmot_tpu_torch' / 'ops'
                           / 'reid_crops.py').read_text()


def main_frame(streams):
    """The main path's association frame: (the NMS's arguments at 1 and
    ``streams`` streams, the costs' arguments at 1 and ``streams``, the
    crops' arguments of the one stream)."""
    from assoc_stages_turns import run_main_path
    from fastmot_tpu_torch.models.yolo import decode_heads
    from fastmot_tpu_torch.utils import ConfigDecoder
    with open(ROOT / 'cfg' / 'mot.json') as f:
        mot_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    mot, frames, staged, _ = run_main_path(smoke, mot_cfg)
    smoke.assoc_stages_ms(mot, frames, staged)
    frame_args = smoke.STAGE_ARGS.pop('frame')
    smoke.STAGE_ARGS.pop('tail', None)
    det = mot.detector
    _, ih, iw = det.model.INPUT_SHAPE
    anchors = getattr(det, '_anchors', det.model.ANCHORS)
    rows = []
    for frame in smoke.textured_frames(smoke.SIZE, streams, seed=13):
        heads = det.module(det.preprocess(torch.as_tensor(frame,
                                                          device='cuda')))
        rows.append(decode_heads(heads, anchors, det.model.SCALES, (ih, iw),
                                 det.model.NEW_COORDS)[0])
    nms1 = frame_args['nms']
    nms_s = (torch.stack(rows),) + tuple(nms1[1:])
    costs1 = frame_args['costs']

    def tiled(x):
        if isinstance(x, tuple):
            return tuple(tiled(a) for a in x)
        return x.expand(streams, *x.shape[1:]).contiguous()
    costs_s = (costs1[0],) + tuple(tiled(a) for a in costs1[1:5]) \
        + tuple(costs1[5:])
    return (nms1, nms_s), (costs1, costs_s), frame_args['crops']


def crop_cases(crops1, streams, rng):
    """{case: ``reid_crops``' arguments}: the main frame's crops, 8
    drifting frames with the main path's 40 boxes each padded to 128 rows,
    and phase 21's contested crops, at 1 and ``streams`` streams."""
    import tests.test_torch_reid_crops as tcrop
    from fastmot_tpu_torch.detector import MAX_DETS
    frames = torch.as_tensor(np.stack(smoke.textured_frames(
        smoke.SIZE, streams, seed=13)), device='cuda')
    boxes = np.zeros((streams, MAX_DETS, 4), np.float32)
    for i in range(streams):
        boxes[i, :smoke.N_OBJECTS] = smoke.synth_tlbrs(5 * i, smoke.SIZE)
    edge = [torch.as_tensor(np.stack([
        tcrop.edge_boxes(rng, n, smoke.SIZE[1], smoke.SIZE[0])
        for _ in range(k)]), device='cuda') for k, n in ((1, 64),
                                                         (streams, 128))]
    hw = crops1[2]
    return {'main_1_stream': crops1,
            f'main_{streams}_streams': (frames, torch.as_tensor(
                boxes, device='cuda'), hw),
            'contested_1_stream': (frames[0], edge[0][0], hw),
            f'contested_{streams}_streams': (frames, edge[1], hw)}


def cases(streams):
    """Phase 21's kinds of case at 1 and ``streams`` streams: {case: args}
    for the NMS (``nms_and_gate``'s arguments), the costs ((params,
    states, hists, dets, embeddings, emb_cap)) and the crops."""
    import tests.test_torch_assoc_costs as tcost
    import tests.test_torch_nms_select as tsel
    (nms1, nms_s), (costs1, costs_s), crops1 = main_frame(streams)
    rng = np.random.default_rng(21)
    scale = torch.tensor([1280.0, 720.0, 1280.0, 720.0], device='cuda')
    mask3 = torch.ones(3, dtype=torch.bool, device='cuda')

    def contested_nms(n):
        rows = np.stack([tsel.clustered_rows(rng, 16128, 3, 120)
                         for _ in range(n)])
        det = torch.as_tensor(rows, device='cuda')
        return (det if n > 1 else det[0], mask3, 0.25, 0.5, 800000, 1.2,
                scale, torch.zeros(2, device='cuda'))

    def costs(kind, n):
        case = tcost.torch_case(tcost.costs_case(
            kind, tcost.CASE_SEEDS[kind], streams=n), 'cuda')
        return (tcost.params(kind),) + case + (tcost.CASES[kind].emb_cap,)
    nms = {'main_1_stream': nms1, f'main_{streams}_streams': nms_s,
           'contested_1_stream': contested_nms(1),
           f'contested_{streams}_streams': contested_nms(streams)}
    cost = {'main_1_stream': costs1, f'main_{streams}_streams': costs_s,
            'contested_1_stream': costs('full_width', 1),
            f'contested_{streams}_streams': costs('full_width', streams),
            'stage1_1_stream': costs('stage1', 1),
            f'stage1_{streams}_streams': costs('stage1', streams)}
    return nms, cost, crop_cases(crops1, streams, rng)


def nms_launch(a):
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch.ops import nms_waves as nw
    k = min(detmod.MAX_RAW, a[0].shape[-2])
    return nw.nms_select_launch_args(*a, k, min(k, detmod.MAX_DETS))


def costs_launch(a):
    from fastmot_tpu_torch.ops import assoc_costs as acost
    return acost.assoc_costs_launch_args(*a[0], *a[1:])


def run(entry, args, outputs):
    """One call of a C entry; its outputs' bytes on the host."""
    if entry(*args):
        raise RuntimeError('launch failed')
    torch.cuda.synchronize()
    return [o.cpu().contiguous().view(torch.uint8) for o in outputs]


def crops_launch(dtype):
    from fastmot_tpu_torch.ops import reid_crops as rc
    return lambda a: rc.reid_crops_launch_args(*a, dtype)


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('--other', action='append', default=[],
                    help='the root of a checkout to compare (repeatable)')
    ap.add_argument('--iters', type=int, default=100)
    ap.add_argument('--no-stamps', action='store_true')
    ap.add_argument('--only', nargs='+', help='the kernels to run')
    ap.add_argument('--json', help='write the times here as JSON')
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('prof_frame_kernels: needs a CUDA device')
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch.ops import assoc_costs as acost
    from fastmot_tpu_torch.ops import nms_waves as nw
    from fastmot_tpu_torch.ops import reid_crops as rc
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    print(f'card: {card}; torch {torch.__version__}', flush=True)
    smoke.phase_build()
    only = set(opts.only or ('nms_select', 'assoc_costs', 'reid_crops'))
    # the stamped builds first: a mark that is not in the source fails fast
    stamped = {} if opts.no_stamps else {
        name: declare(kernel_stamps.stamped_library(
            name, [m for _, m in marks]))
        for name, declare, marks, kernel in (
            ('nms_waves', nw.declare, SELECT_MARKS, 'nms_select'),
            ('assoc_costs', acost.declare, COSTS_MARKS, 'assoc_costs'),
            ('reid_crops', rc.declare, CROPS_MARKS, 'reid_crops'))
        if kernel in only}
    nms_cases, costs_cases, crops_cases = cases(smoke.N_STREAMS)
    # name: (cases, launch, library, entry, marks, blocks, wrapper, whether
    # every checkout's library takes the call)
    kernels = {
        'nms_select': (nms_cases, nms_launch, 'nms_waves',
                       'nms_select_forward', SELECT_MARKS,
                       (SELECT_LAUNCHES, SELECT_BLOCKS),
                       lambda a: detmod.nms_and_gate(*a), True),
        'assoc_costs': (costs_cases, costs_launch, 'assoc_costs',
                        'assoc_costs_forward', COSTS_MARKS,
                        (COSTS_LAUNCHES, COSTS_BLOCKS),
                        lambda a: acost.assoc_costs(*a[0], *a[1:]), True),
        'reid_crops': (crops_cases, crops_launch(torch.float32), 'reid_crops',
                       'reid_crops_forward', CROPS_MARKS, None,
                       lambda a: rc.reid_crops(*a), True),
        'reid_crops_bf16': (crops_cases, crops_launch(torch.bfloat16),
                            'reid_crops', 'reid_crops_forward', CROPS_MARKS,
                            None, lambda a: rc.reid_crops(
                                *a, torch.bfloat16), False)}
    kernels = {k: v for k, v in kernels.items()
               if k.replace('_bf16', '') in only}
    mine = {'nms_waves': nw.nms_waves_library(),
            'assoc_costs': acost.assoc_costs_library(),
            'reid_crops': rc.reid_crops_library()}
    lib_names = {kernels[k][2] for k in kernels}
    others = {f'{Path(r).name} ({r})': (other_libraries(r, lib_names),
                                         takes_bf16(r))
              for r in opts.other}

    if stamped:
        for name, (cs, launch, lib_name, entry, marks, blocks, _, _) in \
                kernels.items():
            if blocks is None:
                continue
            lib = stamped[lib_name]
            for case in ('main_1_stream', 'contested_1_stream'):
                _, args, keep = launch(cs[case])
                print(f'{name} {case}: {card}', flush=True)
                breakdown(lib, marks, *blocks,
                          lambda: getattr(lib, entry)(*args))
                del keep
        if 'reid_crops' in stamped:
            lib = stamped['reid_crops']
            for case in ('main_1_stream', 'contested_1_stream'):
                out, r_args, keep = rc.reid_crops_launch_args(
                    *crops_cases[case])
                print(f'reid_crops {case}, bands 0 and 1 of crop 0: {card}',
                      flush=True)
                breakdown(lib, CROPS_MARKS, {'crops': range(4)},
                          {'crops': (0, 1)},
                          lambda: lib.reid_crops_forward(*r_args))
                del keep

    results = {'card': card, 'cases': {}}
    for name, (cs, launch, lib_name, entry, _, _, wrapper, others_ok) in \
            kernels.items():
        for case, a in cs.items():
            outputs, args, keep = launch(a)
            outputs = outputs if isinstance(outputs, (tuple, list)) \
                else [outputs]
            named = [('this', getattr(mine[lib_name], entry))]
            got = run(named[0][1], args, outputs)
            extra = [(tag, getattr(libs[lib_name], entry))
                     for tag, (libs, bf16) in others.items()
                     if others_ok or bf16]
            for tag, fn in extra:
                theirs = run(fn, args, outputs)
                if not all(torch.equal(x, y) for x, y in zip(got, theirs)):
                    raise AssertionError(f'{name} {case}: {tag}\'s outputs '
                                         'differ')
                named.append((tag, fn))
            times = {tag: [] for tag, _ in named}
            for tag, fn in named + named[::-1]:
                times[tag].append(smoke.lk_device_ms(
                    fn, args, n=opts.iters, tag=f'{name} {case}'))
            call = smoke.launches_ms(lambda: wrapper(a))
            host = smoke.host_ms(lambda: wrapper(a))
            entry_host = smoke.host_ms(lambda: named[0][1](*args))
            del keep
            results['cases'][f'{name} {case}'] = {
                'device_ms': times, 'wrapper_ms': call, 'host_ms': host,
                'entry_host_ms': entry_host}
            print(f'{name} {case}: device us a call ' + '; '.join(
                f'{tag} ' + ' / '.join(f'{t * 1e3:.2f}' for t in v)
                for tag, v in times.items())
                + ' (in turns'
                + (', outputs equal bit for bit' if len(named) > 1 else '')
                + f'); this wrapper {call * 1e3:.2f} us a call, host '
                f'{host * 1e3:.2f} us (of it the C entry '
                f'{entry_host * 1e3:.2f} us); {card}', flush=True)
    if opts.json:
        with open(opts.json, 'w') as f:
            json.dump(results, f, indent=1)


if __name__ == '__main__':
    main()
