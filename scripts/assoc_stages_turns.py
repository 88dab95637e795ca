#!/usr/bin/env python3
"""The association frame of one checkout's main path, stage by stage, on
one NVIDIA GPU, for comparing checkouts in turns inside one machine (A, B,
B, A):

    python3 scripts/assoc_stages_turns.py [ROOT]

ROOT (default: this checkout) is the root of the checkout whose
``fastmot_tpu_torch`` and ``cfg/mot.json`` are used. The script runs that
checkout's main path as chip_smoke.py phase 6 does (``MOT`` at 1280x720,
YOLOv4-512 and OSNet-x0.25 with random weights, skip 5, 40 synthetic
detections spliced in after the real detector graph ran, 20 frames through
``step``), prints the step medians (gap and association frames apart),
then times one association frame's stages alone with this checkout's
``chip_smoke.assoc_stages_ms`` (the detector's net, its NMS,
``greedy_suppress`` alone, the crops alone (the ReID input before OSNet),
crops + OSNet, the costs, the cascade, the finals, the commit, the whole
``update_device_fused`` call and the whole association frame with the net
and the NMS; where ROOT has them, the plain NMS, costs and crops beside the
kernels; each synchronised, the median of 5) and the host syncs a call of
each stage and of the whole frame, and the host's time a call of the NMS's,
the costs', the commit's and the crops' wrappers (``nms_and_gate``,
``assoc_costs_core``, ``commit_core``, ``reid_crops``; no sync inside a
window of 50 calls, the median of 21 windows), with the card's name and
power limit.
"""
import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def run_main_path(smoke, mot_cfg):
    """``mot_cfg``'s main path as chip_smoke.py phase 6 runs it (``MOT`` at
    1280x720 on the card, random weights, 40 synthetic detections spliced
    in after the real detector graph ran), 20 frames through ``step``:
    (mot, frames, staged detections, step ms by frame)."""
    import numpy as np
    import torch
    from fastmot_tpu_torch import MOT
    from fastmot_tpu_torch.detector import MAX_DETS, make_detections
    mot = MOT(smoke.SIZE, device='cuda', **mot_cfg)
    skip = mot.detector_frame_skip
    frames = smoke.textured_frames(smoke.SIZE, 20)
    det = mot.detector
    real_post, real_post_dev = det.postprocess, det.postprocess_device
    staged = {}
    for i in range(0, len(frames), skip):
        tlbrs = np.zeros((MAX_DETS, 4), np.float32)
        tlbrs[:smoke.N_OBJECTS] = smoke.synth_tlbrs(i, smoke.SIZE)
        labels = np.full(MAX_DETS, -1, np.int32)
        labels[:smoke.N_OBJECTS] = 1
        confs = np.zeros(MAX_DETS, np.float32)
        confs[:smoke.N_OBJECTS] = 0.9
        valid = np.arange(MAX_DETS) < smoke.N_OBJECTS
        staged[i] = tuple(torch.as_tensor(a, device='cuda')
                          for a in (tlbrs, labels, confs, valid))

    def post():
        real_post()
        return make_detections(smoke.synth_tlbrs(mot.frame_count, smoke.SIZE),
                               np.ones(smoke.N_OBJECTS, int),
                               np.full(smoke.N_OBJECTS, 0.9))

    def post_dev():
        real_post_dev()
        return staged[mot.frame_count]
    det.postprocess, det.postprocess_device = post, post_dev
    mot.reset(1 / 30.0)
    step_ms = []
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mot.step(frame)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    return mot, frames, staged, step_ms


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('root', nargs='?', default=str(HERE))
    opts = parser.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import json

    import torch
    spec = importlib.util.spec_from_file_location('smoke_here',
                                                  HERE / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fastmot_tpu_torch.utils import ConfigDecoder
    if not torch.cuda.is_available():
        raise SystemExit('assoc_stages_turns: CUDA is not available')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    tag = f'[{root.name}]'
    with open(root / 'cfg' / 'mot.json') as f:
        mot_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    mot, frames, staged, step_ms = run_main_path(smoke, mot_cfg)
    skip = mot.detector_frame_skip
    gap = [t for i, t in enumerate(step_ms) if i % skip]
    assoc = [t for i, t in enumerate(step_ms) if i and i % skip == 0]
    print(f'{tag} step ms median {statistics.median(step_ms):.3f} (gap '
          f'frames {statistics.median(gap):.3f}, association frames '
          f'{statistics.median(assoc):.3f}: '
          f'{" ".join(f"{t:.3f}" for t in assoc)}); {card}', flush=True)
    stage_ms, syncs, _ = smoke.assoc_stages_ms(mot, frames, staged)
    print(f'{tag} association stages alone, ms: ' + '; '.join(
        f'{name} {ms:.3f}' for name, ms in stage_ms.items()) + f'; {card}',
        flush=True)
    print(f'{tag} host syncs a call: ' + ', '.join(
        f'{name} {n}' for name, n in syncs.items()), flush=True)
    # the NMS's and the costs' wrappers on the frame's arguments: the host's
    # time a call, no sync inside a window
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch import tracker as tr
    frame = smoke.STAGE_ARGS['frame']
    params, states, hists, dets, emb, emb_cap = frame['costs']

    def one(xs):
        return tuple(a[0] for a in xs)
    from fastmot_tpu_torch import feature_extractor as fe
    wrappers = {
        'nms_and_gate': lambda: detmod.nms_and_gate(*frame['nms']),
        'assoc_costs_core': lambda: tr.assoc_costs_core(
            *params, one(states), one(hists), *one(dets), emb[0],
            emb_cap=emb_cap),
        'commit_core': lambda: tr.commit_core(*frame['commit']),
        'reid_crops': lambda: fe.rc.reid_crops(*frame['crops'])}
    print(f'{tag} host us a call (median of 21 windows of 50 calls): '
          + '; '.join(f'{name} {smoke.host_ms(fn, n=50, reps=21) * 1e3:.2f}'
                      for name, fn in wrappers.items()) + f'; {card}',
          flush=True)


if __name__ == '__main__':
    main()
