#!/usr/bin/env python3
"""Where the preprocess kernel (fastmot_tpu_torch/csrc/flow_preprocess.cu)
spends its time, on one NVIDIA GPU:

    python3 scripts/prof_preprocess.py

It builds a copy of the source that records, in thread 0 of every block,
the global timer at each phase boundary of the frame and bg roles
(scripts/kernel_stamps.py), warms it up, runs it once on 1 and on 8
textured 1280x720 frames (the main path's flow, scales 0.5 and 0.1), and
prints when the launch's blocks started and ended (ns from the first
block's start: how its waves fall) and, for each role, the median and
largest time of each phase: the staging (the frame's loads and gray, or the
bg resize, through the first barrier), the column pass beside the
pyramid's levels 0-2 through the second barrier, levels 3-5 on warp 0 and
the row pass with the cells' candidates; beside the device time a call of the
unstamped kernel (CUDA events around 100 calls queued behind a sleep, as
chip_smoke.py phase 18 times it).
"""
import ctypes
import subprocess
import sys
from pathlib import Path

import numpy as np
import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
import kernel_stamps  # noqa: E402
from fastmot_tpu_torch.ops import flow_kernels as fk  # noqa: E402

SLOTS = 8                 # phase boundaries a block
# (text in csrc/flow_preprocess.cu with '@' where the stamp goes, slot)
MARKS = [
    ('frame_tile(const Params& p, int s, int tile, float* sm) {\n@', 0),
    ('  stage_frame_gray(frame, p.h, p.w, py0, px0, g);\n  __syncthreads();'
     '\n@', 2),
    ('@  if (p.nested && threadIdx.x < 32) pyramid_lower(p, s, ty, tx, l2);',
     5),
    ('  if (p.nested && threadIdx.x < 32) pyramid_lower(p, s, ty, tx, l2);\n@',
     6),
    ('                     p.out + p.off_cand_score + s * n);\n@}', 7),
    ('bg_tile(const Params& p, int s, int tile, float* sm) {\n@', 0),
    ('  stage_bg(p, frame, py0, px0, g);\n  __syncthreads();\n@', 2),
    ('                 blockDim.x);\n  __syncthreads();\n@', 5),
    ('                     p.out + p.off_bg_score + s * n);\n@}', 7),
]
FRAME_PHASES = (('staging (loads, gray, barrier)', 0, 2),
                ('column pass beside levels 0-2, barrier', 2, 5),
                ('levels 3-5', 5, 6), ('row pass and cells', 6, 7))
BG_PHASES = (('staging (resize, barrier)', 0, 2),
             ('column pass, barrier', 2, 5), ('row pass and cells', 5, 7))


def stamps(lib, n_blocks):
    """The log of one call as [block, slot] global times."""
    st = np.zeros((n_blocks, SLOTS), np.int64)
    mark, block, _, time = kernel_stamps.read_stamps(lib)
    for m, b, t in zip(mark, block, time):
        st[b, MARKS[m][1]] = t
    return st


def main():
    lib = kernel_stamps.stamped_library('flow_preprocess',
                                        [m for m, _ in MARKS])
    vp = ctypes.c_void_p
    lib.flow_preprocess_forward.argtypes = [
        vp, vp, ctypes.POINTER(ctypes.c_int), ctypes.POINTER(ctypes.c_float),
        vp]
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    size = chip_smoke.SIZE
    spec = fk.FlowSpec(size=size, opt_scale=(0.5, 0.5), bg_scale=(0.1, 0.1))
    bw, bh = spec.bg_size
    n_bg = -(-(bh // fk.BG_CELL) // 4) * -(-(bw // fk.BG_CELL) // 8)
    ow, oh = spec.opt_size
    n_tiles = n_bg + -(-oh // 32) * -(-ow // 32)
    for n_streams in (1, 8):
        frames = torch.as_tensor(np.stack([
            chip_smoke.textured_frames(size, 1, seed=s)[0]
            for s in range(n_streams)]), device='cuda')
        # the state stays referenced while the launches write it
        state, launch = fk.preprocess_launch_args(spec, frames)
        for _ in range(3):
            lib.flow_preprocess_forward(*launch)
        torch.cuda.synchronize()
        kernel_stamps.read_stamps(lib)
        assert lib.flow_preprocess_forward(*launch) == 0
        torch.cuda.synchronize()
        st = stamps(lib, n_streams * n_tiles).reshape(n_streams, n_tiles,
                                                       SLOTS)
        t0 = st[..., 0].min()
        starts = np.sort((st[..., 0] - t0).ravel())
        log = [f'preprocess {n_streams} x {size[0]}x{size[1]} ({n_bg} bg '
               f'and {n_tiles - n_bg} frame tiles a stream): blocks start '
               f'0-{starts[-1]} ns (deciles '
               f'{[int(v) for v in np.percentile(starts, range(10, 100, 10))]})'
               f', end {st[..., 7].min() - t0}-{st[..., 7].max() - t0} ns']
        for name, rows, phases in (('frame', st[:, n_bg:], FRAME_PHASES),
                                   ('bg', st[:, :n_bg], BG_PHASES)):
            rows = rows.reshape(-1, SLOTS)
            spans = [(label, rows[:, b] - rows[:, a])
                     for label, a, b in phases]
            log.append(f'  {name} blocks ({len(rows)}), median / largest ns: '
                       + '; '.join(f'{label} {int(np.median(d))} / '
                                   f'{int(d.max())}' for label, d in spans)
                       + f'; whole {int(np.median(rows[:, 7] - rows[:, 0]))}'
                       f' / {int((rows[:, 7] - rows[:, 0]).max())}')
        state, launch = fk.preprocess_launch_args(spec, frames)
        ms = chip_smoke.lk_device_ms(
            fk.preprocess_library().flow_preprocess_forward, launch,
            tag='preprocess')
        log.append(f'  unstamped device time {ms * 1e3:.2f} us a call; {card}')
        print('\n'.join(log), flush=True)


if __name__ == '__main__':
    main()
