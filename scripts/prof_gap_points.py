#!/usr/bin/env python3
"""Where the gap-points kernels (fastmot_tpu_torch/csrc/gap_points.cu)
spend their time, on one NVIDIA GPU:

    python3 scripts/prof_gap_points.py

It builds a copy of the source that records, in thread 0 of every block,
the global timer at each phase boundary (scripts/kernel_stamps.py), warms
it up, runs it once at 1 stream x flow budget 48 (40 tracks, the main
path's) and at 8 streams x 128 (110 tracks a stream), on textured 1280x720
frames preprocessed by the preprocess kernel, with chip_smoke.py's
synthetic boxes and random keypoints inside them, and prints when the
owner launch and the select launch ran (ns from the first block's start)
and when the select blocks passed their wait for the owners, the median
and largest time of each phase of a track's block (the depth order and
the clipped boxes, the keypoints' propagation, the wait, the owned
candidates' count and staging, the selection, the -inf places, the
writes) and of each background block's phases, beside the device time a
call of the unstamped kernels (CUDA events around 100 calls queued behind
a sleep, as chip_smoke.py phase 18 times them).
"""
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
from fastmot_tpu_torch.ops import gap_points as gp  # noqa: E402

SLOTS = 8                 # phase boundaries a block
MAX_BLOCKS = 8192         # blocks a launch
# (text in csrc/gap_points.cu with '@' where the stamp goes, launch, slot)
MARKS = [
    ('points_owner_kernel(const Params p) {\n@', 0, 0),
    ('    owner[c] = o == ~0ull ? kNoOwner : static_cast<uint8_t>(o);\n  }\n@}',
     0, 7),
    ('points_select_kernel(const Params p) {\n@', 1, 0),
    # a track's block
    ('  const bool* kpv = p.kpv + t * kKp;\n@', 1, 1),
    ('@  cudaGridDependencySynchronize();\n  const uint8_t* owner = p.owner\n'
     '      + static_cast<size_t>(s) * (p.n_cands + p.n_bg);\n  int my_owned',
     1, 2),
    ('  cudaGridDependencySynchronize();\n@  const uint8_t* owner = p.owner\n'
     '      + static_cast<size_t>(s) * (p.n_cands + p.n_bg);\n  int my_owned',
     1, 3),
    ('  const int owned = block_sum(my_owned, sh.wsum);  // its barrier '
     'publishes\n@', 1, 4),
    ('@  if (n_sel < kKp) fill_rest(p.n_cands, kKp, n_sel, elig_at, sh);\n',
     1, 5),
    ('  if (n_sel < kKp) fill_rest(p.n_cands, kKp, n_sel, elig_at, sh);\n@',
     1, 6),
    ('      out_valid[tid] = prop;\n    }\n@    return;', 1, 7),
    ('    out_valid[tid] = tid < n_sel;\n  }\n@}', 1, 7),
    # the background block
    ('  const float thr = 0.01f * fmaxf(unord(best), 1e-6f);\n@', 1, 2),
    ('  cudaGridDependencySynchronize();\n@  const uint8_t* owner = p.owner\n'
     '      + static_cast<size_t>(s) * (p.n_cands + p.n_bg) + p.n_cands;',
     1, 3),
    ('                kStage);\n  }\n  __syncthreads();\n@  int n_sel;', 1, 4),
    ('@  if (n_sel < p.bg_keep) fill_rest(', 1, 5),
    ('  if (n_sel < p.bg_keep) fill_rest(p.n_bg, p.bg_keep, n_sel, elig_at, '
     'sh);\n@', 1, 6),
    ('    p.all_valid[base + k] = k < n_sel;\n  }\n@}', 1, 7),
]
TRACK_PHASES = (('flow row and nearer boxes', 0, 1),
                ('propagation and the cells ahead', 1, 2),
                ('wait for the owners', 2, 3),
                ('owned count and staging', 3, 4), ('selection', 4, 5),
                ('-inf places', 5, 6), ('writes', 6, 7))
BG_PHASES = (('best score', 0, 2), ('wait for the owners', 2, 3),
             ('staging', 3, 4), ('selection', 4, 5), ('-inf places', 5, 6),
             ('writes', 6, 7))


def stamps(lib):
    """The log of one call as [launch, block, slot] global times."""
    st = np.zeros((2, MAX_BLOCKS, SLOTS), np.int64)
    mark, block, _, time = kernel_stamps.read_stamps(lib)
    for m, b, t in zip(mark, block, time):
        _, launch, slot = MARKS[m]
        st[launch, b, slot] = t
    return st


def case(n_streams, n_tracks, f_cap, seed=0):
    """gap_points' arguments: n_tracks of chip_smoke.py's synthetic boxes
    a stream (128 slots), active, half their keypoints valid."""
    rng = np.random.default_rng(seed)
    size, t_cap = chip_smoke.SIZE, 128
    frames = np.stack([chip_smoke.textured_frames(size, 1, seed=s)[0]
                       for s in range(n_streams)])
    spec = fk.FlowSpec(size=size, opt_scale=(0.5, 0.5), bg_scale=(0.1, 0.1))
    prev = fk.preprocess(spec, torch.as_tensor(frames, device='cuda'))
    tlbrs = np.zeros((n_streams, t_cap, 4), np.float32)
    for s in range(n_streams):
        tlbrs[s, :n_tracks] = chip_smoke.synth_tlbrs(s, size, n_tracks)
    valid = np.arange(t_cap)[None].repeat(n_streams, 0) < n_tracks
    centre = (tlbrs[..., None, :2] + tlbrs[..., None, 2:]) / 2
    kps = (centre + rng.uniform(-0.4, 0.4, (n_streams, t_cap, 32, 2))
           * (tlbrs[..., None, 2:] - tlbrs[..., None, :2])).astype(np.float32)
    kpv = rng.uniform(size=(n_streams, t_cap, 32)) < 0.5

    def put(a, dtype=None):
        return torch.as_tensor(a, dtype=dtype, device='cuda')
    zeros = torch.zeros((n_streams, t_cap), device='cuda')
    state = [zeros] * 15
    state[2], state[3] = put(tlbrs), put(valid)
    state[4] = put(np.zeros((n_streams, t_cap)), torch.int32)
    state[11], state[12] = put(kps), put(kpv)
    return spec, tuple(state), prev, f_cap


def main():
    lib = kernel_stamps.stamped_library('gap_points',
                                        [m for m, _, _ in MARKS])
    lib.gap_points_forward.argtypes = gp.FORWARD_ARGTYPES
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True).stdout.strip()
    for n_streams, n_tracks, f_cap in ((1, 40, 48), (8, 110, 128)):
        args = case(n_streams, n_tracks, f_cap)
        # the outputs stay referenced while the launches write them
        outputs, launch = gp.gap_points_launch_args(*args)
        for _ in range(3):
            lib.gap_points_forward(*launch)
        torch.cuda.synchronize()
        kernel_stamps.read_stamps(lib)
        assert lib.gap_points_forward(*launch) == 0
        torch.cuda.synchronize()
        st = stamps(lib)
        n_items = args[2][3].shape[-1] + args[2][5].shape[-1]
        own = st[0, :n_streams * -(-n_items // gp.OWNER_CHUNK)]
        t_cap = args[1][2].shape[-2]              # a block a track slot
        sel = st[1, :n_streams * (t_cap + 1)].reshape(n_streams, t_cap + 1,
                                                       SLOTS)
        t0 = min(own[:, 0].min(), sel[..., 0].min())
        tracks = sel[:, :t_cap].reshape(-1, SLOTS)
        tracks = tracks[tracks[:, 1] > 0]           # the flow rows' blocks
        waited = np.concatenate([tracks[:, 3], sel[:, t_cap, 3]])
        log = [f'gap_points {n_streams} x {f_cap} ({n_tracks} tracks a '
               f'stream): owner launch {own[:, 0].min() - t0}-'
               f'{own[:, 7].max() - t0} ns, select launch '
               f'{sel[..., 0].min() - t0}-{sel[..., 7].max() - t0} ns, its '
               f'flow rows and bg past the wait {waited.min() - t0}-'
               f'{waited.max() - t0} ns']
        need = tracks[:, 5] > 0
        for name, rows, phases in (
                ('select new keypoints', need, TRACK_PHASES),
                ('keep theirs', ~need, TRACK_PHASES[:4])):
            spans = [(label, tracks[rows, b] - tracks[rows, a])
                     for label, a, b in phases]
            if rows.any():
                log.append(
                    f'  {int(rows.sum())} of {len(tracks)} track blocks '
                    f'{name}; their phases, median / largest ns: '
                    + '; '.join(f'{label} {int(np.median(d))} / '
                                f'{int(d.max())}' for label, d in spans))
        bg = sel[:, t_cap]
        log.append('  background blocks, median / largest ns: ' + '; '.join(
            f'{name} {int(np.median(bg[:, b] - bg[:, a]))} / '
            f'{int((bg[:, b] - bg[:, a]).max())}' for name, a, b in BG_PHASES
            if (bg[:, b] > 0).all()))
        outputs, launch = gp.gap_points_launch_args(*args)
        ms = chip_smoke.lk_device_ms(
            gp.gap_points_library().gap_points_forward, launch,
            tag='gap_points')
        log.append(f'  unstamped device time {ms * 1e3:.2f} us a call; {card}')
        print('\n'.join(log), flush=True)


if __name__ == '__main__':
    main()
