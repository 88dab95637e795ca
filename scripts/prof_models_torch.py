#!/usr/bin/env python3
"""Per-op device time of the port's detector and ReID graphs on one NVIDIA
GPU, from ``torch.profiler``: the torch twin of scripts/prof_models.py and
scripts/profile_trace.py (which trace the JAX package on a TPU).

    python3 scripts/prof_models_torch.py [yolo|osnet|frame|all]
        [--iters 10] [--top 40] [--out chiprun_out/prof_models_torch.txt]

Workloads, at random weights (the repository holds no trained ones):

- ``yolo``: YOLOv4-512 on a 1280x720 frame (letterbox, network, decode,
  the NMS kernels): ``YOLODetector.detect_async`` and
  ``postprocess_device``;
- ``osnet``: OSNet-x0.25 on 64 crops of a 1280x720 frame (the ReID-input
  kernel, the network, the L2 normalisation): ``extract_core``;
- ``frame``: one whole association frame of the main path (cfg/mot.json,
  as chip_smoke.py phase 6 runs it: 20 frames through ``MOT.step`` first,
  40 synthetic detections spliced in after the real detector graph ran),
  the net, the NMS and ``update_device_fused``.

For each it prints the card's name and power limit, the wall time a call
(synchronised), the kernels' summed device time a call and the device busy
share (the union of the kernels' intervals over the wall time of the
profiled calls), then the top kernels by device time with their launches
a call, and the top torch ops by the device time of their kernels with
their calls; the full tables go to ``--out``. If the profiler sees no
device time (CUPTI unavailable), it says so and prints CUDA-event totals.
"""
import argparse
import importlib.util
import statistics
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def device_us(evt, self_only):
    """An averaged event's device time in us (torch's newer and older
    attribute names)."""
    names = (('self_device_time_total', 'self_cuda_time_total') if self_only
             else ('device_time_total', 'cuda_time_total'))
    for name in names:
        if hasattr(evt, name):
            return float(getattr(evt, name))
    return 0.0


def busy_share(prof, wall_us):
    """The union of the kernels' device intervals over ``wall_us``."""
    spans = []
    for evt in prof.events():
        if getattr(evt, 'device_type', None) is not None and \
                str(evt.device_type).endswith('CUDA'):
            spans.append((evt.time_range.start, evt.time_range.end))
    spans.sort()
    busy, end = 0.0, None
    for a, b in spans:
        if end is None or a > end:
            busy += b - a
            end = b
        elif b > end:
            busy += b - end
            end = b
    return busy / wall_us if wall_us else 0.0, len(spans)


def profile(name, fn, iters, top, card, lines):
    import torch
    from torch.profiler import ProfilerActivity
    from torch.profiler import profile as torch_profile
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    walls = []
    for _ in range(iters):
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        walls.append((time.perf_counter() - t0) * 1e3)
    with torch_profile(activities=[ProfilerActivity.CPU,
                                   ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
        wall_us = (time.perf_counter() - t0) * 1e6
    share, n_kernels = busy_share(prof, wall_us)
    avg = prof.key_averages()
    kernels = [e for e in avg if device_us(e, True) > 0
               and not e.key.startswith('aten::')]
    kernels.sort(key=lambda e: -device_us(e, True))
    ops = [e for e in avg if e.key.startswith('aten::')
           and device_us(e, False) > 0]
    ops.sort(key=lambda e: -device_us(e, False))
    dev_total = sum(device_us(e, True) for e in kernels) / iters
    head = (f'[{name}] wall {statistics.median(walls):.3f} ms a call '
            f'(median of {iters}, synchronised); kernels '
            f'{dev_total / 1e3:.3f} ms of device time a call, '
            f'{n_kernels / iters:.0f} launches a call; device busy share '
            f'{share:.4f} over {iters} profiled calls; {card}')
    print(head, flush=True)
    lines.append(head)
    if not kernels:
        ev = (torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True))
        ev[0].record()
        for _ in range(iters):
            fn()
        ev[1].record()
        torch.cuda.synchronize()
        msg = (f'[{name}] the profiler saw no device time; CUDA events: '
               f'{ev[0].elapsed_time(ev[1]) / iters:.3f} ms a call')
        print(msg, flush=True)
        lines.append(msg)
        return
    rows = [f'[{name}] top {top} kernels by device time: us a call, '
            'launches a call, share of the kernels\' time, name']
    for e in kernels[:top]:
        us = device_us(e, True) / iters
        rows.append(f'  {us:10.1f} {e.count / iters:7.1f} '
                    f'{us / dev_total:7.4f}  {e.key[:110]}')
    rows.append(f'[{name}] top {top} torch ops by their kernels\' device '
                'time: us a call, calls a call, name')
    for e in ops[:top]:
        rows.append(f'  {device_us(e, False) / iters:10.1f} '
                    f'{e.count / iters:7.1f}  {e.key}')
    for r in rows[:top + 1]:
        print(r, flush=True)
    lines.extend(rows)


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('which', nargs='?', default='all',
                        choices=('yolo', 'osnet', 'frame', 'all'))
    parser.add_argument('--iters', type=int, default=10)
    parser.add_argument('--top', type=int, default=40)
    parser.add_argument('--out', default=str(HERE / 'chiprun_out'
                                             / 'prof_models_torch.txt'))
    opts = parser.parse_args()
    sys.path.insert(0, str(HERE))
    import numpy as np
    import torch
    if not torch.cuda.is_available():
        raise SystemExit('prof_models_torch: CUDA is not available')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    spec = importlib.util.spec_from_file_location('smoke_here',
                                                  HERE / 'chip_smoke.py')
    smoke = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(smoke)
    from fastmot_tpu_torch.detector import YOLODetector
    from fastmot_tpu_torch.feature_extractor import (FeatureExtractor,
                                                     extract_core)
    lines = []
    frame = torch.as_tensor(smoke.textured_frames(smoke.SIZE, 1)[0],
                            device='cuda')
    torch.set_grad_enabled(False)
    if opts.which in ('yolo', 'all'):
        det = YOLODetector(smoke.SIZE, class_ids=(1,), model='YOLOv4',
                           device='cuda')

        def run_yolo():
            det.detect_async(frame)
            det.postprocess_device()
        profile('YOLOv4-512, 1280x720 (letterbox, net, decode, NMS)',
                run_yolo, opts.iters, opts.top, card, lines)
        del det
    if opts.which in ('osnet', 'all'):
        ext = FeatureExtractor('OSNet025', device='cuda')
        n = 64
        i = np.arange(n)
        tlbrs = torch.as_tensor(np.stack([
            (i * 23) % 1100.0, (i * 17) % 500.0, (i * 23) % 1100.0 + 80,
            (i * 17) % 500.0 + 200], -1).astype(np.float32), device='cuda')
        valid = torch.ones(n, dtype=torch.bool, device='cuda')
        profile('OSNet-x0.25, 64 crops (ReID input, net, L2)',
                lambda: extract_core(ext.module, ext.out_hw, frame, tlbrs,
                                     valid),
                opts.iters, opts.top, card, lines)
        del ext
    if opts.which in ('frame', 'all'):
        profile('one association frame (net, NMS, update_device_fused)',
                association_frame(smoke), opts.iters, opts.top, card, lines)
    out = Path(opts.out)
    out.parent.mkdir(parents=True, exist_ok=True)
    out.write_text('\n'.join(lines) + '\n')
    print(f'tables written to {out}', flush=True)


def association_frame(smoke):
    """The main path after a 20-frame run (``smoke.phase_main_path``'s
    set-up): a callable running one association frame's net, NMS and
    ``update_device_fused`` on its last frame and staged detections."""
    import json

    import numpy as np
    import torch
    from fastmot_tpu_torch import MOT
    from fastmot_tpu_torch.detector import MAX_DETS, make_detections
    from fastmot_tpu_torch.utils import ConfigDecoder
    with open(HERE / 'cfg' / 'mot.json') as f:
        mot_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    mot = MOT(smoke.SIZE, device='cuda', **mot_cfg)
    frames = smoke.textured_frames(smoke.SIZE, 20)
    det = mot.detector
    real_post, real_post_dev = det.postprocess, det.postprocess_device
    staged = {}
    for i in range(0, len(frames), mot.detector_frame_skip):
        tlbrs = np.zeros((MAX_DETS, 4), np.float32)
        tlbrs[:smoke.N_OBJECTS] = smoke.synth_tlbrs(i, smoke.SIZE)
        valid = np.arange(MAX_DETS) < smoke.N_OBJECTS
        staged[i] = tuple(torch.as_tensor(a, device='cuda') for a in (
            tlbrs, np.where(valid, 1, -1).astype(np.int32),
            np.where(valid, 0.9, 0).astype(np.float32), valid))

    def post():
        real_post()
        return make_detections(smoke.synth_tlbrs(mot.frame_count,
                                                 smoke.SIZE),
                               np.ones(smoke.N_OBJECTS, int),
                               np.full(smoke.N_OBJECTS, 0.9))

    def post_dev():
        real_post_dev()
        return staged[mot.frame_count]
    det.postprocess, det.postprocess_device = post, post_dev
    mot.reset(1 / 30.0)
    for f in frames:
        mot.step(f)
    torch.cuda.synchronize()
    trk, ext = mot.tracker, mot.extractors[0]
    frame = torch.as_tensor(frames[-1], device='cuda')
    det_dev = staged[max(staged)]
    frame_id = mot.frame_count

    def run():
        det.detect_async(frame)
        real_post_dev()
        trk.update_device_fused(frame_id, frame, det_dev, ext)
    return run


if __name__ == '__main__':
    main()
