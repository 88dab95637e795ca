#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the exit code is then non-zero):

1. device: requires CUDA, prints the card and its power limit, turns TF32
   off for matrix products and convolutions;
2. build: compiles the OSBlock kernel (csrc/osnet_block.cu) from the
   sources in this checkout;
3. kernel vs its plain version at the six OSNet-x0.25 block shapes (64
   crops, bf16; two calls bitwise equal), with each shape's time (20
   back-to-back launches between two CUDA events), bound, roofline share
   and launch plan; again at 1,024 crops, the batch of the multi-stream
   path (phase 13);
4. OSNet-x0.25 forward on 64 crops, kernel path vs plain path;
5. reference: the tracker on a small synthetic sequence, GPU against the
   port's CPU path; ``StreamTracker`` at 2 streams (synthetic detections
   and embeddings) and the legacy ``compute_flow`` + ``apply_kalman``,
   GPU against CPU;
6. main path: ``MOT`` at 1280x720 with cfg/mot.json (YOLOv4-512 with
   random weights, OSNet-x0.25, detector_frame_skip=5) on drifting
   textured frames, with 40 synthetic detections spliced in after the
   real YOLO graph ran; 20 frames through ``step``, then 20 through
   ``step_batch`` in chunks of 5; equal snapshots, visible tracks, finite
   Kalman state, and the OSBlock kernel launched 6 times per association
   frame;
7. detector zoo: every registered YOLO and SSD with random weights at its
   full input size on a 1280x720 frame: raw head shapes, finite values,
   the median time of the whole detector; SSDMobileNetV1 and YOLOv4-tiny
   also against the same module on the CPU;
8. SSD postprocess: the synthetic decoded rows of tests/test_detector.py
   through ``SSDDetector._postprocess_device`` on the card and on the
   CPU, equal;
9. SSD main path: phase 6 with ``detector_type='SSD'`` (SSDInceptionV2 in
   a 4x2 tiling of 300x300 tiles, cfg/mot.json's ``ssd_detector_cfg``);
10. int8 conv: ``models.quantize.int8_conv`` (im2col + ``torch._int_mm``)
   on the card against its CPU plain version at the main path's kinds of
   shape (YOLOv4-512's 3x3/2 after the stem, a 3x3 at 256x256x64, a 1x1
   head with N = 255, OSNet's 7x7/2 on 3 channels, an SSD extra layer with
   M = 8, a grouped conv): equal int32 sums; times beside the bf16 cuDNN
   conv of the same shape;
11. OSNet-x0.25 under ``QuantizedModule`` on 64 crops, card against CPU,
   weight-only, calibrated fake-quant, calibrated native convs, dynamic
   native convs; times beside the kernel path;
12. int8 main path: phase 6 with ``quantize='int8'`` and bench.py
   --int8's cache (``{'outputs': {}, 'inputs': {'*': 0.0}}``) for the
   detector and the extractor: one ``int8_conv`` launch per eligible conv
   of YOLOv4 and OSNet-x0.25, no OSBlock launch;
13. multi-stream path (BASELINE config 5, bench.py config 5):
   ``parallel.MultiStreamMOT`` at 8 streams of 1280x720 with cfg/mot.json's
   YOLOv4-512, OSNet-x0.25 and detector_frame_skip=5, drifting textured
   frames (streams 0 and 1 identical), 40 synthetic detections a stream
   spliced in after the real batched YOLO graph ran, 20 frames: visible
   tracks on every stream, finite Kalman state, 6 OSBlock launches per
   association frame (one OSNet call on 1,024 crops, not one per stream),
   streams 0 and 1 equal; the step medians and the aggregate FPS beside
   phase 6's single-stream median, then each stage alone;
14. mesh (``parallel.make_stream_mesh``, torch.distributed): (a) phase 13
   over a 1x1 NCCL mesh in this process, (b) phase 13 over two spawned
   gloo ranks sharing the card as a (2, 1) mesh, 4 streams each, (c)
   ``multichip.dryrun_multichip(1)`` over NCCL (YOLOv4-512 under
   ``shard_conv_channels``, the chained gap step, the association). Every
   stream's rows of (a) and (b) equal phase 13's (IDs, ages, hits; boxes
   within 1e-3 px), and the OSBlock runs 6 times an association frame on
   each rank. The process groups are destroyed before the phase returns.

The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""
import json
import statistics
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from unittest import mock

import numpy as np
import torch

ROOT = Path(__file__).resolve().parent
SIZE = (1280, 720)
N_OBJECTS = 40
BLOCK_SHAPES = ((16, 64, 64, 32), (64, 64, 64, 32), (64, 96, 32, 16),
                (96, 96, 32, 16), (96, 128, 16, 8), (128, 128, 16, 8))
BATCH = 64
N_STREAMS = 8
MULTI_BATCH = N_STREAMS * 128     # phase 13's crops per OSNet call
MAX_REL, MEAN_REL = 0.04, 0.004        # tests/test_osnet_block.py bounds
DIFFER = 0.05        # share of outputs off the plain version's (test_torch_cuda)
OSNET_MAX_REL = 0.05
# bf16 nets, card against CPU: one-ulp roundings that differ between cuDNN
# and the CPU's conv sums propagate through 20-30 layers
ZOO_MAX_REL = 0.05
# an H100 SXM's published peaks (dense): bf16 tensor cores, f32 on CUDA
# cores, HBM3
PEAK_BF16, PEAK_F32, PEAK_BYTES = 989e12, 67e12, 3.35e12
# (name, batch, H, W, C_in, C_out, k, stride, groups) of phase 10
INT8_SHAPES = (('yolov4 3x3/2 after the stem', 1, 256, 256, 64, 128, 3, 2, 1),
               ('3x3 at 256x256x64', 1, 256, 256, 64, 64, 3, 1, 1),
               ('yolov4 1x1 head N=255', 1, 64, 64, 256, 255, 1, 1, 1),
               ('osnet 7x7/2 K=147', 64, 256, 128, 3, 16, 7, 2, 1),
               ('ssd extra 3x3/2 M=8', 8, 2, 2, 64, 128, 3, 2, 1),
               ('grouped 3x3 g=2', 1, 64, 64, 64, 64, 3, 1, 2))
# card against CPU under int8: a sum one bf16 ulp apart flips a level now
# and then, and later convs spread the flip
INT8_MIN_COS = 0.99
# phase 14 against phase 13: the sharded runs batch fewer streams, which
# may round a box an ulp apart
MESH_PX = 1e-3


def log(*args):
    print(*args, flush=True)


def cuda_ms(fn, n=20, warmup=3):
    """Median of ``n`` CUDA-event timings of ``fn`` after warm-up."""
    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(n):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b))
    return statistics.median(times)


def wall_ms(fn, n=5, warmup=2):
    """Median host-clock time of ``fn`` with a device sync on each side
    (the detectors sync inside their NMS loops)."""
    for _ in range(warmup):
        fn()
    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append((time.perf_counter() - t0) * 1e3)
    return statistics.median(times)


def rel_err(got, ref):
    denom = ref.float().abs().max().item() + 1e-6
    err = (got.float() - ref.float()).abs()
    return err.max().item() / denom, err.mean().item() / denom, \
        err.max().item()


def phase_device():
    if not torch.cuda.is_available():
        raise SystemExit('chip_smoke: CUDA is not available')
    name = torch.cuda.get_device_name(0)
    smi = subprocess.run(
        ['nvidia-smi', '--query-gpu=name,power.limit',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()
    torch.backends.cudnn.allow_tf32 = False
    torch.backends.cuda.matmul.allow_tf32 = False
    log(f'device: {name}; torch {torch.__version__} cuda '
        f'{torch.version.cuda}')
    log(smi)
    log('tf32: cudnn', torch.backends.cudnn.allow_tf32, 'matmul',
        torch.backends.cuda.matmul.allow_tf32)
    return name


def phase_build():
    from fastmot_tpu_torch.ops import cuda_build
    path, seconds, nvcc_out = cuda_build.build('osnet_block')
    log(f'build: osnet_block {seconds:.2f} s -> {path.name}')
    for line in nvcc_out.splitlines():      # registers, spills, smem
        if 'registers' in line or 'spill' in line:
            log('ptxas:', line.strip())


def _random_block(cin, features, gen):
    from fastmot_tpu_torch.models.layers import BatchNorm, random_init_
    from fastmot_tpu_torch.models.osnet import OSBlock
    blk = OSBlock(cin, features).requires_grad_(False)
    random_init_(blk, gen)
    for m in blk.modules():        # non-trivial BN folds
        if isinstance(m, BatchNorm):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0.0, 0.1, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    return blk.cuda().folded()


def osblock_bound_ms(batch, h, w, cin, features, packed):
    """The least time an H100 could take for one OSBlock call, and what
    sets it: each input byte read once (x, the packed weights) and each
    output byte written once, over 3.35 TB/s; against the 1x1 convs' FLOPs
    over 989 TFLOP/s (bf16 tensor cores) plus the depthwise, BN, gated-sum
    and residual FLOPs over 67 TFLOP/s (f32)."""
    from fastmot_tpu_torch.ops.osnet_block import block_dims
    mid, _ = block_dims(features)
    px = batch * h * w
    ds = cin != features
    mm = 2 * px * (cin * mid + 10 * mid * mid + mid * features
                   + (cin * features if ds else 0))
    # per pixel: 10 depthwise 3x3 (mul + add), 11 mid-wide BNs, the
    # gated sum (4 mul, 3 add), conv3's and the downsample's BN, the add
    f32 = px * (mid * (10 * 18 + 11 * 2 + 7)
                + features * (2 + (2 if ds else 0) + 1))
    nbytes = px * (cin + features) * 2 \
        + sum(t.numel() * t.element_size() for t in packed)
    ops_ms = (mm / PEAK_BF16 + f32 / PEAK_F32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms


def launches_ms(fn, n=20, reps=5):
    """Median over ``reps`` windows of ``n`` back-to-back calls of ``fn``
    between two CUDA events, per call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        a = torch.cuda.Event(enable_timing=True)
        b = torch.cuda.Event(enable_timing=True)
        a.record()
        for _ in range(n):
            fn()
        b.record()
        torch.cuda.synchronize()
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def phase_kernel(batch=BATCH):
    from fastmot_tpu_torch.ops import osnet_block as ob
    gen = torch.Generator().manual_seed(0)
    worst_abs = 0.0
    total = {'ms': 0.0, 'plain_ms': 0.0, 'bound_ms': 0.0, 'ops_ms': 0.0,
             'bytes_ms': 0.0}
    for cin, f, h, w in BLOCK_SHAPES:
        flat, packed = _random_block(cin, f, gen)
        x = torch.randn(batch, h, w, cin, generator=gen) \
            .to('cuda', torch.bfloat16)
        got = ob.osblock(x, flat, cin, f, packed)
        torch.cuda.synchronize()
        ref = ob.osblock_reference(x, flat, cin, f)
        max_rel, mean_rel, max_abs = rel_err(got, ref)
        differ = (got != ref).float().mean().item()
        again = ob.osblock(x, flat, cin, f, packed)
        ms = launches_ms(lambda: ob.osblock(x, flat, cin, f, packed))
        plain = cuda_ms(lambda: ob.osblock_reference(x, flat, cin, f),
                        *((5, 3) if batch <= BATCH else (3, 1)))
        bound, ops_ms, bytes_ms = osblock_bound_ms(batch, h, w, cin, f,
                                                   packed)
        plan = ob._prepared_plan(batch, h, w, cin, f,
                                 torch.cuda.current_device())
        by = 'bytes' if bytes_ms >= ops_ms else 'operations'
        log(f'osblock B={batch} {h}x{w} {cin}->{f}: max-rel {max_rel:.2e} '
            f'mean-rel {mean_rel:.2e} differing {differ:.5f}; kernel '
            f'{ms * 1e3:.1f} us, bound '
            f'{bound * 1e3:.2f} us ({by}), roofline share '
            f'{bound / ms:.3f}; plain {plain:.3f} ms; plan: clusters of '
            f'{plan.cluster} CTAs x {plan.rows} rows, {plan.ctas} CTAs, '
            f'{plan.variant}, {plan.smem} B shared memory')
        if not (max_rel < MAX_REL and mean_rel < MEAN_REL
                and differ < DIFFER):
            raise AssertionError(f'osblock {cin}->{f} disagrees with its '
                                 f'plain version: {max_rel} / {mean_rel} '
                                 f'/ {differ}')
        if not torch.equal(got, again):
            raise AssertionError(f'osblock {cin}->{f}: two calls differ')
        worst_abs = max(worst_abs, max_abs)
        for k, v in zip(total, (ms, plain, bound, ops_ms, bytes_ms)):
            total[k] += v
    total['bound_by'] = 'bytes' if total['bytes_ms'] >= total['ops_ms'] \
        else 'operations'
    total['roofline_share'] = total['bound_ms'] / total['ms']
    log(f'osblock six shapes B={batch}: kernel {total["ms"]:.4f} ms, bound '
        f'{total["bound_ms"]:.4f} ms ({total["bound_by"]}), roofline share '
        f'{total["roofline_share"]:.4f}; plain {total["plain_ms"]:.3f} ms')
    return dict(total, max_abs_err=worst_abs)


def phase_osnet():
    from fastmot_tpu_torch.models import osnet
    from fastmot_tpu_torch.models.layers import random_init_
    from fastmot_tpu_torch.ops.osnet_block import osblock_reference

    def plain_block(x, flat, cin, features, packed=None):
        return osblock_reference(x, flat, cin, features)

    net = osnet.OSNet().requires_grad_(False)
    random_init_(net, torch.Generator().manual_seed(1))
    net = net.cuda().eval()
    x = torch.rand(BATCH, 256, 128, 3,
                   generator=torch.Generator().manual_seed(2)).cuda()
    with torch.no_grad():
        got = net(x)
        with mock.patch.object(osnet, 'osblock', plain_block):
            ref = net(x)
            plain = cuda_ms(lambda: net(x), n=10)
        ms = cuda_ms(lambda: net(x), n=10)
    max_rel, _, _ = rel_err(got, ref)
    log(f'osnet025 [64, 256, 128, 3]: max-rel {max_rel:.2e} kernel path '
        f'{ms:.3f} ms plain path {plain:.3f} ms')
    if not (torch.isfinite(got).all() and got.shape == (BATCH, 512)):
        raise AssertionError('osnet025 output is not finite [64, 512]')
    if not max_rel < OSNET_MAX_REL:
        raise AssertionError(f'osnet025 kernel path disagrees: {max_rel}')


def textured_frames(size, n, seed=0, pad=16):
    """Drifting textured frames (camera motion every frame)."""
    import scipy.ndimage as ndi
    rng = np.random.default_rng(seed)
    w, h = size
    base = ndi.gaussian_filter(
        rng.uniform(0, 255, (h + 2 * pad, w + 2 * pad, 3))
        .astype(np.float32), 1.5)
    frames = []
    for i in range(n):
        ph = 2 * np.pi * (i % 40) / 40
        dx = int(pad / 2 + pad / 2 * np.sin(ph))
        dy = int(pad / 2 + pad / 2 * np.cos(2 * ph))
        frames.append(np.ascontiguousarray(np.clip(
            base[pad + dy:pad + dy + h, pad + dx:pad + dx + w], 0, 255))
            .astype(np.uint8))
    return frames


def synth_tlbrs(frame_id, size, n=N_OBJECTS):
    xs = (np.arange(n) * 97 + frame_id * 3) % (size[0] - 120)
    ys = (np.arange(n) * 53 + frame_id * 2) % (size[1] - 260)
    w = 60 + (np.arange(n) * 13) % 40
    h = 160 + (np.arange(n) * 17) % 80
    return np.rint(np.stack([xs, ys, xs + w, ys + h], -1).astype(float))


def snapshots(mot):
    return {fid: sorted((tid, tuple(np.round(tlbr, 4))) for tid, tlbr in rows)
            for fid, rows in mot.flush_tracks().items()}


def phase_reference():
    """The tracker's GPU path against the port's CPU path (itself held
    against the JAX package by the CPU tests) on a small sequence."""
    from fastmot_tpu_torch import MOT
    size, n_frames = (320, 240), 12
    frames = textured_frames(size, n_frames, seed=3)
    with tempfile.TemporaryDirectory() as tmp:
        seq = Path(tmp) / 'SYN'
        (seq / 'det').mkdir(parents=True)
        (seq / 'seqinfo.ini').write_text(
            '[Sequence]\nimWidth=320\nimHeight=240\n')
        rows = []
        for f in range(n_frames):
            for x, y, w, h in ((40 + 2 * f, 30, 40, 90),
                               (150 - f, 60 + f, 45, 100),
                               (230, 100 - f, 35, 80)):
                rows.append(f'{f + 1},-1,{x},{y},{w},{h},1,-1,-1,-1')
        (seq / 'det' / 'det.txt').write_text('\n'.join(rows) + '\n')
        cfg = dict(detector_type='PUBLIC', detector_frame_skip=3,
                   class_ids=(1,),
                   public_detector_cfg={'sequence_path': str(seq)},
                   feature_extractor_cfgs=({'model': 'OSNet025'},),
                   tracker_cfg={'max_age': 6})
        runs = []
        for device in ('cpu', 'cuda'):
            mot = MOT(size, device=device, **cfg)
            mot.reset(1 / 30.0)
            for frame in frames:
                mot.step(frame)
            runs.append(snapshots(mot))
    cpu, gpu = runs
    for fid in cpu:
        ids_c = [t for t, _ in cpu[fid]]
        ids_g = [t for t, _ in gpu.get(fid, [])]
        if ids_c != ids_g:
            raise AssertionError(f'frame {fid}: GPU ids {ids_g} vs CPU '
                                 f'{ids_c}')
        for (_, a), (_, b) in zip(cpu[fid], gpu[fid]):
            if np.abs(np.array(a) - np.array(b)).max() > 2.0:
                raise AssertionError(f'frame {fid}: GPU box {b} vs CPU {a}')
    n_rows = sum(len(r) for r in cpu.values())
    if not n_rows:
        raise AssertionError('reference run tracked nothing')
    log(f'reference: GPU == CPU on {len(cpu)} frames, {n_rows} track rows')


def _stream_dets(f, s, n=3):
    """[n, 4] boxes moving 2 px a frame, offset per stream (320x240)."""
    x = 30.0 + 90 * np.arange(n) + 2 * f + 12 * s
    y = 40.0 + 20 * np.arange(n) + f
    return np.stack([x, y, x + 45, y + 110], -1)


def phase_stream_reference():
    """``StreamTracker`` (2 streams, synthetic detections and embeddings)
    on the card against the port's CPU path: the same track IDs on every
    frame of every stream, boxes within 2 px."""
    from fastmot_tpu_torch.detector import MAX_DETS, make_detections
    from fastmot_tpu_torch.parallel import StreamTracker
    size, n, n_frames, skip, n_obj = (320, 240), 2, 12, 3, 3
    frames = [textured_frames(size, n_frames, seed=20 + s) for s in range(n)]
    emb = np.zeros((n, MAX_DETS, 512), np.float32)
    for s in range(n):
        e = np.random.default_rng(100 + s).normal(size=(n_obj, 512))
        emb[s, :n_obj] = e / np.linalg.norm(e, axis=1, keepdims=True)
    runs = []
    for device in ('cpu', 'cuda'):
        st = StreamTracker(size, 'euclidean', n, device=device, max_age=6)
        st.reset(1 / 30.0)
        st.init(np.stack([fr[0] for fr in frames]), [make_detections(
            _stream_dets(0, s), np.ones(n_obj, int), np.full(n_obj, 0.9))
            for s in range(n)])
        snaps = []
        for f in range(1, n_frames):
            st.track(np.stack([fr[f] for fr in frames]), f)
            if f % skip == 0:
                tlbr = np.zeros((n, MAX_DETS, 4), np.float32)
                for s in range(n):
                    tlbr[s, :n_obj] = _stream_dets(f, s)
                valid = np.arange(MAX_DETS)[None].repeat(n, 0) < n_obj
                st.update_device(f, tuple(torch.as_tensor(a, device=device)
                                          for a in (
                    tlbr, np.where(valid, 1, -1).astype(np.int32),
                    np.where(valid, 0.9, 0).astype(np.float32), valid)),
                    torch.as_tensor(emb, device=device))
            st.sync()
            snaps.append([sorted((t.trk_id, t.tlbr.copy())
                                 for t in trk.tracks.values())
                          for trk in st.trackers])
        runs.append(snaps)
    _same_rows('stream tracker', *runs)
    log(f'reference: StreamTracker GPU == CPU on {n_frames - 1} frames of '
        f'{n} streams')


def _same_rows(tag, cpu, gpu):
    """Per frame and stream, the same (id, tlbr) rows within 2 px."""
    n_rows = 0
    for f, (c_streams, g_streams) in enumerate(zip(cpu, gpu)):
        for s, (c, g) in enumerate(zip(c_streams, g_streams)):
            if [t for t, _ in c] != [t for t, _ in g]:
                raise AssertionError(f'{tag} frame {f} stream {s}: GPU ids '
                                     f'{[t for t, _ in g]} vs CPU '
                                     f'{[t for t, _ in c]}')
            for (_, a), (_, b) in zip(c, g):
                if np.abs(a - b).max() > 2.0:
                    raise AssertionError(f'{tag} frame {f} stream {s}: GPU '
                                         f'box {b} vs CPU {a}')
            n_rows += len(c)
    if not n_rows:
        raise AssertionError(f'{tag}: tracked nothing')


def phase_legacy_api():
    """The legacy per-track path (``compute_flow`` + ``apply_kalman``) on
    the card against the CPU over 4 frames."""
    from fastmot_tpu_torch import MultiTracker
    from fastmot_tpu_torch.detector import make_detections
    size, n_obj = (320, 240), 3
    frames = textured_frames(size, 5, seed=4)
    runs = []
    for device in ('cpu', 'cuda'):
        trk = MultiTracker(size, 'euclidean', device=device)
        trk.reset(1 / 30.0)
        trk.init(torch.as_tensor(frames[0], device=device), make_detections(
            _stream_dets(0, 0), np.ones(n_obj, int), np.full(n_obj, 0.9)))
        snaps = []
        for frame in frames[1:]:
            trk.compute_flow(torch.as_tensor(frame, device=device))
            trk.apply_kalman()
            snaps.append([sorted((tid, t.tlbr.copy())
                                 for tid, t in trk.tracks.items())])
        runs.append(snaps)
    _same_rows('legacy compute_flow + apply_kalman', *runs)
    log('reference: compute_flow + apply_kalman GPU == CPU on 4 frames, '
        f'{len(runs[0][-1][0])} tracks')


def phase_main_path(detector_type='YOLO', tag='main path', int8=False):
    from fastmot_tpu_torch import MOT
    from fastmot_tpu_torch.detector import MAX_DETS, make_detections
    from fastmot_tpu_torch.models.layers import Conv
    from fastmot_tpu_torch.models.quantize import int8_conv
    from fastmot_tpu_torch.ops.osnet_block import osblock
    from fastmot_tpu_torch.utils import ConfigDecoder

    with open(ROOT / 'cfg' / 'mot.json') as f:
        mot_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    mot_cfg['detector_type'] = detector_type
    with tempfile.TemporaryDirectory() as tmp:
        if int8:        # bench.py --int8: dynamic native convs everywhere
            cache = Path(tmp) / 'int8_cal.json'
            cache.write_text(json.dumps({'outputs': {},
                                         'inputs': {'*': 0.0}}))
            for cfg in (mot_cfg['yolo_detector_cfg'],
                        *mot_cfg['feature_extractor_cfgs']):
                cfg.update(quantize='int8', calib_cache=str(cache))
        mot = MOT(SIZE, device='cuda', **mot_cfg)
    skip = mot.detector_frame_skip
    frames = textured_frames(SIZE, 20)

    # splice synthetic detections after the real detector graph ran
    # (random weights detect nothing), staged on the device like real
    # output
    det = mot.detector
    real_post, real_post_dev = det.postprocess, det.postprocess_device
    staged = {}
    for i in range(0, len(frames), skip):
        tlbrs = np.zeros((MAX_DETS, 4), np.float32)
        tlbrs[:N_OBJECTS] = synth_tlbrs(i, SIZE)
        labels = np.full(MAX_DETS, -1, np.int32)
        labels[:N_OBJECTS] = 1
        confs = np.zeros(MAX_DETS, np.float32)
        confs[:N_OBJECTS] = 0.9
        valid = np.arange(MAX_DETS) < N_OBJECTS
        staged[i] = tuple(torch.as_tensor(a, device='cuda')
                          for a in (tlbrs, labels, confs, valid))

    def post():
        real_post()
        i = mot.frame_count
        return make_detections(synth_tlbrs(i, SIZE),
                               np.ones(N_OBJECTS, int),
                               np.full(N_OBJECTS, 0.9))

    def post_dev():
        real_post_dev()
        return staged[mot.frame_count]

    det.postprocess, det.postprocess_device = post, post_dev

    osblock.launches = int8_conv.launches = 0
    mot.reset(1 / 30.0)
    step_ms = []
    for frame in frames:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mot.step(frame)
        torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
    snap_step = snapshots(mot)
    visible = len(list(mot.visible_tracks()))
    state = mot.tracker._dev_state
    finite = bool(torch.isfinite(state[0]).all()
                  and torch.isfinite(state[1]).all())

    mot.reset(1 / 30.0)
    batch_ms = []
    for lo in range(0, len(frames), 5):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        mot.step_batch(frames[lo:lo + 5])
        torch.cuda.synchronize()
        batch_ms.append((time.perf_counter() - t0) * 1e3)
    snap_batch = snapshots(mot)
    state = mot.tracker._dev_state
    finite = finite and bool(torch.isfinite(state[0]).all()
                             and torch.isfinite(state[1]).all())
    launches, int8_launches = osblock.launches, int8_conv.launches

    n_assoc = 2 * sum(1 for i in range(1, len(frames)) if i % skip == 0)
    n_detect = n_assoc + 2                   # frame 0 of each run detects
    # eligible convs: every layers.Conv but the darknet stem's
    c, ih, iw = det.model.INPUT_SHAPE
    det_convs = sum(isinstance(m, Conv) for m in det.module.modules()) - \
        (det.module.module.stem_layers(ih, iw) if int8 else 0)
    reid_convs = sum(isinstance(m, Conv)
                     for m in mot.extractors[0].module.modules())
    log(f'{tag} step ms per frame:', ' '.join(f'{t:.1f}' for t in step_ms))
    gap = [t for i, t in enumerate(step_ms) if i % skip]
    assoc = [t for i, t in enumerate(step_ms) if i and i % skip == 0]
    log(f'{tag} step ms median {statistics.median(step_ms):.3f} '
        f'(gap frames {statistics.median(gap):.3f}, association frames '
        f'{statistics.median(assoc):.3f})')
    log(f'{tag} step_batch ms per 5-frame chunk:',
        ' '.join(f'{t:.1f}' for t in batch_ms))
    log(f'{tag}: visible tracks {visible}, association frames '
        f'{n_assoc}, osblock launches {launches}, int8_conv launches '
        f'{int8_launches}')
    if snap_step != snap_batch:
        raise AssertionError(f'{tag}: step and step_batch snapshots differ')
    if not visible:
        raise AssertionError(f'{tag}: no visible tracks')
    if not finite:
        raise AssertionError(f'{tag}: non-finite Kalman state')
    want = (0, n_detect * det_convs + n_assoc * reid_convs) if int8 else \
        (6 * n_assoc, 0)
    if (launches, int8_launches) != want:
        raise AssertionError(f'{tag}: osblock and int8_conv launched '
                             f'{launches} and {int8_launches} times, '
                             f'expected {want}')
    if int8:
        log(f'{tag}: int8_conv launches per association frame '
            f'{det_convs + reid_convs} ({det_convs} detector convs, '
            f'{reid_convs} OSNet convs; {n_detect} detector runs, '
            f'{n_assoc} association frames)')
    return launches, statistics.median(step_ms)


def _zoo_raw_checks(name, det, raw):
    """Shapes and finiteness of a detector's raw network output."""
    c, ih, iw = det.model.INPUT_SHAPE
    if hasattr(det.model, 'TOPK'):                        # SSD
        n = det.batch_size
        want = [(n, 1917, 4), (n, 1917, det.model.NUM_CLASSES)]
    else:
        want = [(1, ih // f, iw // f,
                 len(a) // 2 * (5 + det.model.NUM_CLASSES))
                for f, a in zip(det.model.LAYER_FACTORS, det.model.ANCHORS)]
    got = [tuple(t.shape) for t in raw]
    if got != want:
        raise AssertionError(f'{name}: raw output shapes {got}, want {want}')
    if not all(bool(torch.isfinite(t).all()) for t in raw):
        raise AssertionError(f'{name}: raw output is not finite')


def phase_zoo():
    """Every registered detector at its full input size on one frame."""
    from fastmot_tpu_torch.detector import MAX_DETS, SSDDetector, \
        YOLODetector
    from fastmot_tpu_torch.models import registry
    frame = torch.from_numpy(textured_frames(SIZE, 1, seed=5)[0]).cuda()
    zoo = [(YOLODetector, registry.YOLOModel.get_model(n))
           for n in sorted(registry._YOLO_REGISTRY)] + \
        [(SSDDetector, registry.SSDModel.get_model(n))
         for n in sorted(registry._SSD_REGISTRY)]
    for cls, model in zoo:
        name = model.__name__
        person = min(1, model.NUM_CLASSES - 1)     # class 0 if single-class
        det = cls(SIZE, (person,), model=name, device='cuda')
        with torch.no_grad():
            x = det.preprocess(frame)
            raw = det.module(x)
            torch.cuda.synchronize()
            _zoo_raw_checks(name, det, raw)
            out = det.run(frame)
            if [tuple(t.shape)[0] for t in out] != [MAX_DETS] * 4:
                raise AssertionError(f'{name}: padded output shapes '
                                     f'{[tuple(t.shape) for t in out]}')
            ms = wall_ms(lambda: det.run(frame))
            line = (f'zoo {name} {tuple(x.shape)}: detector {ms:.3f} ms, '
                    f'{int(out[3].sum())} detections')
            if name in ('SSDMobileNetV1', 'YOLOv4Tiny'):
                ref = det.model.init_params('cpu')(x.cpu())
                worst = max(rel_err(g.cpu(), r)[0] for g, r in zip(raw, ref))
                line += f'; card vs CPU max-rel {worst:.2e}'
                if not worst < ZOO_MAX_REL:
                    raise AssertionError(f'{name}: card output disagrees '
                                         f'with the CPU: {worst}')
        log(line)
        del det, raw, out
        torch.cuda.empty_cache()


def synthetic_ssd_rows(rng):
    """The decoded rows of tests/test_detector.py (four tiles, cross-tile
    and same-tile duplicates, a cross-label overlap)."""
    n_tiles, topk = 4, 20
    det_out = np.zeros((n_tiles, topk, 7), np.float32)
    for t in range(n_tiles):
        conf = np.sort(rng.uniform(0, 1, topk))[::-1]
        label = rng.choice([1, 1, 1, 2], topk)
        x1 = rng.uniform(0, 0.8, topk)
        y1 = rng.uniform(0, 0.8, topk)
        w = rng.uniform(0.05, 0.3, topk)
        h = rng.uniform(0.05, 0.3, topk)
        det_out[t] = np.stack([np.zeros(topk), label, conf,
                               x1, y1, x1 + w, y1 + h], -1)
    det_out[0, 0] = [0, 1, 0.95, 0.80, 0.30, 0.95, 0.55]
    det_out[1, 0] = [0, 1, 0.90, 0.05, 0.31, 0.21, 0.56]
    det_out[0, 1] = [0, 1, 0.93, 0.81, 0.31, 0.96, 0.56]
    det_out[0, 2] = [0, 1, 0.88, 0.79, 0.29, 0.94, 0.54]
    det_out[0, 3] = [0, 2, 0.87, 0.80, 0.30, 0.95, 0.55]
    det_out[3, 0] = [0, 1, 0.92, 0.10, 0.10, 0.30, 0.40]
    det_out[3, 1] = [0, 1, 0.91, 0.11, 0.12, 0.31, 0.42]
    tiles = np.array([[0, 0, 299, 299], [225, 0, 524, 299],
                      [0, 225, 299, 524], [225, 225, 524, 524]], np.float32)
    scale = np.array([1.5, 1.2], np.float32)
    label_mask = np.zeros(91, bool)
    label_mask[1] = True
    return det_out, tiles, scale, label_mask


def phase_ssd_postprocess():
    from fastmot_tpu_torch.detector import SSDDetector
    arrays = synthetic_ssd_rows(np.random.default_rng(42))
    outs = [SSDDetector._postprocess_device(
        *(torch.as_tensor(a, device=dev) for a in arrays),
        0.5, 120000, 0.6, 0.5) for dev in ('cpu', 'cuda')]
    for a, b in zip(*outs):
        if not torch.equal(a, b.cpu()):
            raise AssertionError('SSD postprocess: card and CPU differ')
    n = int(outs[0][3].sum())
    if not n:
        raise AssertionError('SSD postprocess kept nothing')
    log(f'ssd postprocess: card == CPU, {n} detections')


def phase_int8_conv():
    """``int8_conv`` on the card against its CPU plain version (equal int32
    sums, equal outputs), dynamic input range as on the int8 main path;
    timed beside the bf16 cuDNN conv of the same shape (the port's
    ``layers.Conv`` in bf16) and the s8 conv alone (im2col + _int_mm)."""
    from fastmot_tpu_torch.models import quantize as tq
    from fastmot_tpu_torch.models.layers import Conv
    gen = torch.Generator().manual_seed(7)
    for name, b, h, w, cin, cout, k, s, g in INT8_SHAPES:
        x = torch.randn(b, h, w, cin, generator=gen)
        conv = Conv(cin, cout, k, s, groups=g, bias=cout == 255,
                    dtype=torch.bfloat16).requires_grad_(False)
        conv.weight.normal_(0, 0.05, generator=gen)
        if conv.bias is not None:
            conv.bias.normal_(0, 0.1, generator=gen)
        q, scale = tq.quantize_weight_int8(conv.weight)
        bias = conv.bias
        args = (s, 'SAME', g)
        ref = tq.int8_conv(x, q, scale, 0.0, *args, bias=bias)
        xq = torch.randint(-127, 128, x.shape, generator=gen,
                           dtype=torch.int8)
        sums = tq.s8_conv(xq, q, *args)
        xd, qd, sd = x.cuda(), q.cuda(), scale.cuda()
        bd = None if bias is None else bias.cuda()
        conv = conv.cuda()
        got = tq.int8_conv(xd, qd, sd, 0.0, *args, bias=bd)
        got_sums = tq.s8_conv(xq.cuda(), qd, *args)
        torch.cuda.synchronize()
        if not torch.equal(got_sums.cpu(), sums):
            raise AssertionError(f'int8 conv {name}: card sums differ from '
                                 'the CPU plain version')
        err = (got.cpu() - ref).abs().max().item()
        if not (torch.isfinite(got).all() and err <= 1e-5 *
                ref.abs().max().item()):
            raise AssertionError(f'int8 conv {name}: output off the CPU '
                                 f'plain version by {err}')
        ms = launches_ms(lambda: tq.int8_conv(xd, qd, sd, 0.0, *args,
                                              bias=bd))
        xqd = xq.cuda()
        mm_ms = launches_ms(lambda: tq.s8_conv(xqd, qd, *args))
        xb = xd.to(torch.bfloat16)
        bf16_ms = launches_ms(lambda: conv(xb))
        oh, ow = -(-h // s), -(-w // s)
        log(f'int8 conv {name} [{b}, {h}, {w}, {cin}] -> {cout} (M '
            f'{b * oh * ow}, K {k * k * cin // g}, N {cout // g}): sums '
            f'equal, max-abs {err:.2e}; int8_conv {ms:.4f} ms (s8 conv '
            f'{mm_ms:.4f} ms), bf16 conv {bf16_ms:.4f} ms')


def _osnet(device, seed=1):
    from fastmot_tpu_torch.models import osnet
    from fastmot_tpu_torch.models.layers import random_init_
    net = osnet.OSNet().requires_grad_(False)
    random_init_(net, torch.Generator().manual_seed(seed))
    return net.to(device).eval()


def phase_osnet_int8():
    """OSNet-x0.25 under QuantizedModule on 64 crops, card against CPU,
    in the four modes, with ranges from the port's calibrator."""
    from fastmot_tpu_torch.models import quantize as tq
    x = torch.rand(BATCH, 256, 128, 3,
                   generator=torch.Generator().manual_seed(2))
    cal = tq.EntropyCalibrator(_osnet('cuda'), num_bins=512)
    cal.observe(x[:8].numpy())
    outs, ins = cal.compute_ranges(), cal.compute_input_ranges()
    xd = x.cuda()
    net = _osnet('cuda')
    with torch.no_grad():
        kernel_ms = cuda_ms(lambda: net(xd), n=10)
    line = [f'kernel path {kernel_ms:.3f} ms']
    for mode, ranges in (('weights', (None, None)),
                         ('outputs', (outs, None)), ('inputs', (None, ins)),
                         ('dynamic', (None, {'*': 0.0}))):
        qm = tq.QuantizedModule(_osnet('cuda'), *ranges)
        with torch.no_grad():
            got = qm(xd)
            ref = tq.QuantizedModule(_osnet('cpu'), *ranges)(x)
            ms = cuda_ms(lambda: qm(xd), n=10)
        got = got.cpu()
        cos = torch.nn.functional.cosine_similarity(got, ref).min().item()
        max_rel = rel_err(got, ref)[0]
        line.append(f'{mode} {ms:.3f} ms (card vs CPU max-rel {max_rel:.2e}, '
                    f'min cosine {cos:.6f})')
        if not (torch.isfinite(got).all() and got.shape == (BATCH, 512)):
            raise AssertionError(f'osnet025 int8 {mode}: not finite [64, 512]')
        ok = max_rel < OSNET_MAX_REL if mode == 'weights' else \
            cos >= INT8_MIN_COS
        if not ok:
            raise AssertionError(f'osnet025 int8 {mode}: card disagrees '
                                 f'with the CPU ({max_rel}, {cos})')
    log(f'osnet025 int8 on [64, 256, 128, 3] ({len(outs)} output, '
        f'{len(ins)} input ranges):', '; '.join(line))


def multi_stream_inputs(n_streams=N_STREAMS, n_frames=20, skip=5):
    """Phase 13's drifting textured frames (each stream its own texture,
    streams 0 and 1 the same input) and its detections, 40 a stream on
    every detection frame, as global arrays (``multichip.splice_
    detections``)."""
    from fastmot_tpu_torch.detector import MAX_DETS
    seeds = [10 + max(s, 1) for s in range(n_streams)]
    textures = {seed: textured_frames(SIZE, n_frames, seed=seed)
                for seed in set(seeds)}
    frames = [np.stack([textures[seed][i] for seed in seeds])
              for i in range(n_frames)]
    offsets = [4.0 * max(s - 1, 0) for s in range(n_streams)]
    det_frames = list(range(0, n_frames, skip))
    tlbr = np.zeros((len(det_frames), n_streams, MAX_DETS, 4), np.float32)
    for i, f in enumerate(det_frames):
        for s in range(n_streams):
            tlbr[i, s, :N_OBJECTS] = synth_tlbrs(f, SIZE) + offsets[s]
    valid = np.zeros(tlbr.shape[:3], bool)
    valid[..., :N_OBJECTS] = True
    return frames, dict(frames=np.array(det_frames), tlbr=tlbr,
                        label=np.where(valid, 1, -1).astype(np.int32),
                        conf=np.where(valid, 0.9, 0).astype(np.float32),
                        valid=valid)


def multi_stream_kwargs():
    """``MultiStreamMOT``'s arguments from cfg/mot.json (bench.py config
    5): YOLOv4-512, OSNet-x0.25, detector_frame_skip=5."""
    from fastmot_tpu_torch.utils import ConfigDecoder
    with open(ROOT / 'cfg' / 'mot.json') as f:
        cfg = json.load(f, cls=ConfigDecoder)['mot_cfg']
    return dict(size=SIZE, detector_frame_skip=cfg['detector_frame_skip'],
                class_ids=cfg['class_ids'],
                yolo_detector_cfg=cfg['yolo_detector_cfg'],
                feature_extractor_cfgs=cfg['feature_extractor_cfgs'],
                tracker_cfg=cfg['tracker_cfg'])


def phase_multi_stream(single_ms, frames, dets, n_streams=N_STREAMS):
    """``MultiStreamMOT`` at 8 streams of 1280x720 with cfg/mot.json's
    detector, extractor, skip and tracker (bench.py config 5). Returns the
    OSBlock launches, every stream's final rows and the step median."""
    from fastmot_tpu_torch.detector import MAX_DETS
    from fastmot_tpu_torch.multichip import run_multi_stream
    from fastmot_tpu_torch.ops.osnet_block import osblock
    from fastmot_tpu_torch.parallel import MultiStreamMOT

    mot = MultiStreamMOT(n_streams=n_streams, device='cuda',
                         **multi_stream_kwargs())
    skip = mot.detector_frame_skip
    n_frames = len(frames)
    det = mot.detector
    real_dev = det.postprocess_device_batch

    osblock.launches = 0
    (rows,), step_ms = run_multi_stream(mot, frames, dets)
    launches = osblock.launches
    n_assoc = sum(1 for i in range(1, n_frames) if i % skip == 0)
    visible = [len(list(mot.visible_tracks(s))) for s in range(n_streams)]
    state = mot.stream_tracker._dev_state
    finite = bool(torch.isfinite(state[0]).all()
                  and torch.isfinite(state[1]).all())

    gap = [t for i, t in enumerate(step_ms) if i % skip]
    assoc = [t for i, t in enumerate(step_ms) if i and i % skip == 0]
    fps = n_streams * n_frames / (sum(step_ms) / 1e3)
    log(f'multi-stream ({n_streams} streams) step ms per frame:',
        ' '.join(f'{t:.1f}' for t in step_ms))
    log(f'multi-stream step ms median {statistics.median(step_ms):.3f} '
        f'(gap frames {statistics.median(gap):.3f}, association frames '
        f'{statistics.median(assoc):.3f}); aggregate {fps:.2f} FPS over '
        f'{n_frames} frames; single-stream main path median '
        f'{single_ms:.3f} ms ({1e3 / single_ms:.2f} FPS)')
    log(f'multi-stream: visible tracks per stream {visible}, association '
        f'frames {n_assoc}, osblock launches {launches}')
    if not all(visible):
        raise AssertionError(f'multi-stream: a stream has no visible '
                             f'tracks: {visible}')
    if not finite:
        raise AssertionError('multi-stream: non-finite Kalman state')
    if launches != 6 * n_assoc:
        raise AssertionError(f'multi-stream: osblock launched {launches} '
                             f'times, expected {6 * n_assoc} (one OSNet '
                             'call per association frame)')
    if [r[1:] for r in rows[0]] != [r[1:] for r in rows[1]]:
        raise AssertionError('multi-stream: streams 0 and 1 had the same '
                             'input but differ')

    # where the time goes: each stage alone, synchronised; the gap frames
    # alternate between the last two frames, so that LK has motion to
    # track (on a repeated frame it stops after one step a level)
    last = mot._stage_frames(frames[-1])
    pair = [mot._stage_frames(frames[-2]), last]
    det_b = tuple(torch.as_tensor(dets[k][0], device='cuda')
                  for k in ('tlbr', 'label', 'conf', 'valid'))
    ext = mot.extractor
    emb = [None]

    def embed():
        ext.extract_async_batch(last, det_b[0], det_b[3])
        emb[0] = ext.postprocess_device()

    def gap_frame():
        pair.reverse()
        mot.stream_tracker.track(pair[0])

    stages = {
        f'detector (letterbox, YOLOv4 on {n_streams} frames, decode, NMS)':
            lambda: (det.detect_async(last), real_dev()),
        f'crops + OSNet on {n_streams * MAX_DETS} crops': embed,
        'gap frame (preprocess, points, LK, RANSAC, Kalman)': gap_frame,
        'association (costs, cascade, finals, commit)':
            lambda: mot.stream_tracker.update_device(n_frames, det_b, emb[0]),
    }
    embed()
    log('multi-stream stages alone, ms: ' + '; '.join(
        f'{name} {wall_ms(fn, n=3, warmup=1):.3f}'
        for name, fn in stages.items()))
    return launches, rows, statistics.median(step_ms)


def _same_streams(tag, got, want):
    """Per stream, the same (id, age, hits) rows and boxes within
    MESH_PX; returns the largest box difference."""
    worst = 0.0
    for s in sorted(want):
        g, w = got[s], want[s]
        if [(r[0], r[2], r[3]) for r in g] != [(r[0], r[2], r[3])
                                               for r in w]:
            raise AssertionError(f'{tag} stream {s}: (id, age, hits) '
                                 f'{[(r[0], r[2], r[3]) for r in g]} vs '
                                 f'{[(r[0], r[2], r[3]) for r in w]}')
        for a, b in zip(g, w):
            worst = max(worst, float(np.abs(np.subtract(a[1], b[1])).max()))
    if worst > MESH_PX:
        raise AssertionError(f'{tag}: boxes {worst} px off phase 13')
    return worst


def phase_mesh(frames, dets, want_rows, single_multi_ms, n_streams=N_STREAMS):
    """(a) ``MultiStreamMOT`` over a 1x1 NCCL mesh in this process; (b) two
    gloo ranks sharing the card as a (2, 1) mesh, 4 streams each; (c)
    ``dryrun_multichip(1)`` over NCCL. (a) and (b) on phase 13's frames
    and detections, every stream's rows against phase 13's. Returns the
    OSBlock launches of (a) and (b)."""
    import torch.distributed as dist
    from fastmot_tpu_torch import multichip
    from fastmot_tpu_torch.ops.osnet_block import osblock
    from fastmot_tpu_torch.parallel import MultiStreamMOT, make_stream_mesh

    t_phase = time.perf_counter()
    kwargs = multi_stream_kwargs()
    skip = kwargs['detector_frame_skip']
    n_assoc = sum(1 for i in range(1, len(frames)) if i % skip == 0)
    with tempfile.TemporaryDirectory() as tmp:
        dist.init_process_group('nccl', init_method=f'file://{tmp}/store',
                                world_size=1, rank=0)
        try:
            mot = MultiStreamMOT(n_streams=n_streams, device='cuda',
                                 mesh=make_stream_mesh(device='cuda'),
                                 **kwargs)
            osblock.launches = 0
            (rows,), step_ms = multichip.run_multi_stream(mot, frames, dets)
            launches = osblock.launches
        finally:
            dist.destroy_process_group()
    del mot
    torch.cuda.empty_cache()
    worst = _same_streams('mesh (a) 1 NCCL rank', rows, want_rows)
    log(f'mesh (a) 1 NCCL rank, 8 streams: rows == phase 13 on every '
        f'stream (boxes within {worst} px), osblock launches {launches}; '
        f'step ms median {statistics.median(step_ms):.3f} against phase '
        f"13's {single_multi_ms:.3f}")
    if launches != 6 * n_assoc:
        raise AssertionError(f'mesh (a): osblock launched {launches} times, '
                             f'expected {6 * n_assoc}')

    t_b = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        np.save(Path(tmp) / 'frames.npy', np.stack(frames))
        np.savez(Path(tmp) / 'dets.npz', **dets)
        ranks = multichip.run_ranks(2, multichip.multi_stream_rank, (
            tmp, n_streams, 1, kwargs, 'cuda', 'cpu'), backend='gloo')
    rows_b = {}
    for r, out in enumerate(ranks):
        rows_b.update(out['rows'][0])
        if out['osblock_launches'] != 6 * n_assoc:
            raise AssertionError(f'mesh (b) rank {r}: osblock launched '
                                 f'{out["osblock_launches"]} times, '
                                 f'expected {6 * n_assoc}')
    worst = _same_streams('mesh (b) 2 gloo ranks', rows_b, want_rows)
    log(f'mesh (b) 2 gloo ranks on one card, streams '
        f'{[o["local_streams"] for o in ranks]}: rows == phase 13 on every '
        f'stream (boxes within {worst} px), osblock launches '
        f'{[o["osblock_launches"] for o in ranks]}; step ms medians '
        f'{[round(statistics.median(o["step_ms"]), 3) for o in ranks]}; '
        f'{time.perf_counter() - t_b:.1f} s, spawn and build included')

    t0 = time.perf_counter()
    multichip.dryrun_multichip(1, device='cuda')
    log(f'mesh (c) dryrun_multichip(1) over NCCL: '
        f'{time.perf_counter() - t0:.1f} s, spawn and build included; '
        f'phase 14 {time.perf_counter() - t_phase:.1f} s')
    return launches + sum(o['osblock_launches'] for o in ranks)


def main():
    t0 = time.perf_counter()
    name = phase_device()
    phase_build()
    kern = phase_kernel()
    worst_abs = max(kern['max_abs_err'],
                    phase_kernel(MULTI_BATCH)['max_abs_err'])
    phase_osnet()
    phase_reference()
    phase_stream_reference()
    phase_legacy_api()
    launches, float_ms = phase_main_path()
    phase_zoo()
    phase_ssd_postprocess()
    launches += phase_main_path('SSD', 'ssd main path')[0]
    phase_int8_conv()
    phase_osnet_int8()
    _, int8_ms = phase_main_path(tag='int8 main path', int8=True)
    log(f'main path step median: float {float_ms:.3f} ms, int8 '
        f'{int8_ms:.3f} ms')
    frames, dets = multi_stream_inputs()
    multi_launches, rows, multi_ms = phase_multi_stream(float_ms, frames,
                                                        dets)
    launches += multi_launches
    launches += phase_mesh(frames, dets, rows, multi_ms)
    log(f'every phase passed in {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'kernels': [{
        'name': 'osblock', 'route': 'cuda',
        'source': 'fastmot_tpu_torch/csrc/osnet_block.cu',
        'replaces': 'fastmot_tpu/ops/osnet_block.py:213',
        'launches': launches, 'max_abs_err': worst_abs,
        'ms': kern['ms'], 'plain_ms': kern['plain_ms'],
        'bound_ms': kern['bound_ms'], 'bound_by': kern['bound_by'],
        'library_ms': None,
        'roofline_share': kern['roofline_share']}]}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    main()
