"""Multi-card entry points of the port (the twin of ``__graft_entry__.py``).

``entry()``: YOLOv4's forward plus the fused head decode, with an example
input on the card.

``dryrun_multichip(n, device='cuda')``: one multi-stream pipeline step
over an n-rank ``('streams', 'model')`` mesh with the real cores: the zoo
YOLO graph under ``shard_conv_channels``, the chained gap step (points, LK,
RANSAC, Kalman) over each rank's streams, and the association cascade
with its on-device decisions, at the JAX dryrun's tiny tracker shapes
(2-way ``'model'`` when n is even). As in the JAX dryrun, the 512-d ReID
features (track sums, history, detection embeddings) are split over
``'model'``, and the association all-reduces their partial norms and dot
products. ``FASTMOT_DRYRUN_MODEL`` selects the
graph: the flagship YOLOv4 at 512x512 by default, ``YOLOv4Tiny`` at 64x64
for a quick run.

    python -m fastmot_tpu_torch.multichip --dryrun N [--device cpu]

Each rank is a process spawned here (``run_ranks``): on ``'cuda'`` one
NCCL rank per card, and fewer cards than ranks raise; ``--device cpu``
runs gloo ranks on the CPU. The JAX entry re-execs itself onto a CPU mesh
when it lacks devices; this one never moves to the CPU unasked. The rank
workers live in this module, so a spawned child imports torch and the
port only.
"""
from __future__ import annotations

import argparse
import contextlib
import datetime
import os
import queue
import shutil
import tempfile
import time
import traceback
from pathlib import Path

import numpy as np
import torch
import torch.distributed as dist

from .device import torch_device

__all__ = ['entry', 'dryrun_multichip', 'run_ranks', 'run_multi_stream',
           'splice_detections', 'multi_stream_rank', 'sharded_heads_rank',
           'each_run', 'zoo_module', 'zoo_outputs']


def entry(device='cuda'):
    """``(fn, example_args)``: ``fn(module, frame)`` is YOLOv4's forward plus
    the fused head decode; the example is the module and a zero frame on
    ``device``."""
    from .models.yolo import YOLOv4, anchor_tensors, decode_heads
    dev = torch_device(device)
    c, h, w = YOLOv4.INPUT_SHAPE
    anchors = anchor_tensors(YOLOv4.ANCHORS, dev)

    def fn(module, frame):
        return decode_heads(module(frame), anchors, YOLOv4.SCALES,
                            (h, w), YOLOv4.NEW_COORDS)

    return fn, (YOLOv4.init_params(dev),
                torch.zeros((1, h, w, c), dtype=torch.float32, device=dev))


# ---------------------------------------------------------------------------
# Spawned ranks
# ---------------------------------------------------------------------------

def _rank_main(rank, world, backend, store, fn, args, results):
    torch.set_num_threads(1)
    try:
        if backend == 'nccl':
            torch.cuda.set_device(rank % torch.cuda.device_count())
        dist.init_process_group(backend, init_method=f'file://{store}',
                                world_size=world, rank=rank,
                                timeout=datetime.timedelta(seconds=600))
        try:
            out = fn(*args)
        finally:
            dist.destroy_process_group()
        results.put((rank, True, out))
    except BaseException:
        results.put((rank, False, traceback.format_exc()))


def run_ranks(n: int, fn, args=(), backend='gloo', timeout=1800.0):
    """Run ``fn(*args)`` in ``n`` spawned processes joined in one process
    group (``backend``: 'nccl', one rank per card, or 'gloo'; one torch
    thread each); returns each rank's return value, in rank order. A rank
    that fails stops the others and raises here with its traceback."""
    if backend == 'nccl':
        torch_device('cuda')
        if n > torch.cuda.device_count():
            raise RuntimeError(f'{n} NCCL ranks need {n} cards; '
                               f'{torch.cuda.device_count()} present')
    ctx = torch.multiprocessing.get_context('spawn')
    tmp = tempfile.mkdtemp(prefix='fastmot_ranks_')
    results = ctx.Queue()
    procs = [ctx.Process(target=_rank_main,
                         args=(r, n, backend, os.path.join(tmp, 'store'),
                               fn, args, results), daemon=True)
             for r in range(n)]
    out = [None] * n
    try:
        for p in procs:
            p.start()
        deadline = time.monotonic() + timeout
        pending = set(range(n))
        while pending:
            try:
                rank, ok, value = results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r in pending if procs[r].exitcode is not None]
                if dead:
                    raise RuntimeError(f'rank {dead[0]} exited with code '
                                       f'{procs[dead[0]].exitcode}')
                if time.monotonic() > deadline:
                    raise TimeoutError(f'{n} ranks did not finish in '
                                       f'{timeout} s')
                continue
            if not ok:
                raise RuntimeError(f'rank {rank} failed:\n{value}')
            out[rank] = value
            pending.discard(rank)
        for p in procs:
            p.join(60)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join(10)
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# The dryrun
# ---------------------------------------------------------------------------

def dryrun_multichip(n_devices: int, device: str = 'cuda') -> list[dict]:
    """One multi-stream pipeline step over an ``n_devices``-rank mesh,
    NCCL on the card (one rank per card) or gloo on the CPU; prints the
    ``dryrun ok: ...`` line and returns each rank's results
    (``_dryrun_rank``)."""
    model_name = os.environ.get('FASTMOT_DRYRUN_MODEL', 'YOLOv4')
    ranks = run_ranks(n_devices, _dryrun_rank,
                      (n_devices, model_name, device),
                      backend='nccl' if device == 'cuda' else 'gloo')
    print(ranks[0]['line'], flush=True)
    return ranks


def tail_launches(reset: bool = False) -> tuple:
    """This process's generic NMS and merge, SSD postprocess and commit
    kernel calls (``greedy_suppress``, ``merge_labels``,
    ``ssd_postprocess``, ``assoc_commit``); with ``reset``, zeroed
    first."""
    from .ops import assoc_commit as ac
    from .ops import geometry as geom
    from .ops import nms_waves as nw
    if reset:
        geom.greedy_suppress.launches = nw.merge_labels.launches = 0
        nw.ssd_postprocess.launches = ac.assoc_commit.launches = 0
    return (geom.greedy_suppress.launches, nw.merge_labels.launches,
            nw.ssd_postprocess.launches, ac.assoc_commit.launches)


def frame_launches(reset: bool = False) -> tuple:
    """This process's YOLO postprocess, costs and ReID-input kernel calls
    (``nms_select``, ``assoc_costs``, ``reid_crops``); with ``reset``,
    zeroed first."""
    from .ops import assoc_costs as acost
    from .ops import nms_waves as nw
    from .ops import reid_crops as rc
    if reset:
        nw.nms_select.launches = acost.assoc_costs.launches = 0
        rc.reid_crops.launches = 0
    return (nw.nms_select.launches, acost.assoc_costs.launches,
            rc.reid_crops.launches)


def _dryrun_rank(n_devices: int, model_name: str, device: str) -> dict:
    """The multi-stream step on this rank: real cores, tiny shapes.
    Returns the ``dryrun ok`` line, this rank's feature slice, its LK,
    gap-commit, preprocess and gap-points kernel launches, its cascade,
    greedy kernel and finals launches (``assoc_launches``), its NMS, merge,
    SSD postprocess and commit launches (``tail_launches``), its
    postprocess, costs and ReID-input calls (``frame_launches``) and, as
    numpy, the association's costs, its matches (``col4row``), the tracks'
    validity and the new history store."""
    from .detector import _resize_bilinear
    from .kalman import KalmanConfig, init_mats
    from .models import registry
    from .models.layers import random_init_
    from .models.yolo import anchor_tensors, decode_heads
    from .ops import assignment as asg
    from .ops import distance as dist_ops
    from .ops import flow_kernels as fk
    from .ops.gap_commit import gap_commit
    from .ops.gap_points import gap_points
    from .parallel.streams import (axis_size, make_stream_mesh,
                                   shard_conv_channels)
    from .tracker import (assoc_costs_batch, commit_batch, finals_core,
                          stages_scan_core)

    dev = torch.device('cuda', torch.cuda.current_device()) \
        if device == 'cuda' else torch.device('cpu')
    model_par = 2 if n_devices % 2 == 0 and n_devices >= 2 else 1
    n_streams = n_devices // model_par
    mesh = make_stream_mesh(model_parallel=model_par, device=device)
    assert axis_size(mesh, 'streams') == n_streams
    block = mesh.get_local_rank('streams')
    me = slice(block, block + 1)
    # this rank's slice of the 512 ReID features
    part, n_part = mesh.get_local_rank('model'), model_par

    # the JAX dryrun's tiny shapes; the flow kernels' capacity is a module
    # constant, so the track capacity equals it
    fw, fh = 64, 48
    t_cap = fk.MAX_FLOW_TRACKS
    d_cap, hist_cap, feat = 64, 32, 512
    kp = fk.KP_PER_TRACK
    spec = fk.FlowSpec(size=(fw, fh), opt_scale=(0.5, 0.5),
                       bg_scale=(0.25, 0.25), max_level=2)
    cfg = KalmanConfig()
    acc_cov, _, trans = (torch.as_tensor(a, device=dev)
                         for a in init_mats(cfg, 1 / 30.0))
    frame_rect = torch.tensor([0.0, 0.0, fw - 1.0, fh - 1.0], device=dev)

    # the zoo model, channel-sharded over 'model'; tiny runs at 64x64, the
    # flagship at its full input
    model_cls = registry.YOLOModel.get_model(model_name)
    yolo = model_cls.build().requires_grad_(False)
    random_init_(yolo, torch.Generator().manual_seed(0))
    yolo = yolo.to(dev).eval()
    shard_conv_channels(yolo, mesh)
    net_hw = (64, 64) if model_name == 'YOLOv4Tiny' \
        else model_cls.INPUT_SHAPE[1:]

    # every stream's inputs drawn from one seed, this rank's block kept
    rng = np.random.default_rng(1)
    frames0 = rng.integers(0, 256, (n_streams, fh, fw, 3)).astype(np.uint8)
    frames1 = np.clip(frames0 + rng.normal(0, 2.0, frames0.shape), 0,
                      255).astype(np.uint8)
    offs = rng.uniform(0, 24.0, (n_streams, t_cap, 1))
    fsl = slice(part * feat // n_part, (part + 1) * feat // n_part)
    feat_sum = rng.normal(size=(n_streams, t_cap, feat))[..., fsl]
    hist_sum = rng.normal(size=(n_streams, hist_cap, feat))[..., fsl]
    d_emb = rng.normal(size=(n_streams, d_cap, feat))[..., fsl]

    def put(a, dtype=torch.float32):
        return torch.tensor(np.asarray(a)[me], dtype=dtype, device=dev)

    s = 1
    tlbrs = np.array([8.0, 8.0, 24.0, 30.0])[None, None] + offs
    valid = np.broadcast_to(np.arange(t_cap) < 8, (n_streams, t_cap))
    state = (put(np.concatenate([tlbrs, np.zeros((n_streams, t_cap, 4))],
                                -1)),
             put(np.tile(np.eye(8) * 4.0, (n_streams, t_cap, 1, 1))),
             put(tlbrs), put(valid, torch.bool),
             put(np.zeros((n_streams, t_cap)), torch.int32),
             put(np.where(valid, 3, 0), torch.int32),
             put(np.zeros((n_streams, t_cap)), torch.int32),
             put(np.zeros((n_streams, t_cap)), torch.int32),
             put(np.full((n_streams, t_cap), 4), torch.int32),
             put(np.zeros((n_streams, t_cap)), torch.bool),
             put(np.ones((n_streams, t_cap))),
             put(np.zeros((n_streams, t_cap, kp, 2))),
             put(np.zeros((n_streams, t_cap, kp)), torch.bool),
             put(feat_sum), put(np.where(valid, 2.0, 0.0)))
    hist = (put(hist_sum), put(np.full((n_streams, hist_cap), 3.0)),
            put(np.zeros((n_streams, hist_cap)), torch.int32),
            put(np.ones((n_streams, hist_cap)), torch.bool),
            put(np.zeros((n_streams, hist_cap)), torch.int32),
            put(np.full((n_streams, hist_cap), 3), torch.int32))
    dets = (put(np.clip(tlbrs[:, :d_cap] + 1.5, 0.0, fw - 1.0)),
            put(np.zeros((n_streams, d_cap)), torch.int32),
            put(np.full((n_streams, d_cap), 0.9)),
            put(np.broadcast_to(np.arange(d_cap) < 10, (n_streams, d_cap)),
                torch.bool))
    emb = put(d_emb)
    f0, f1 = put(frames0, torch.uint8), put(frames1, torch.uint8)
    anchors = anchor_tensors(model_cls.ANCHORS, f1.device)

    with torch.no_grad():
        # 1. detector: the zoo graph + fused decode on this rank's frames
        rgb = f1.float().flip(-1) / 255.0
        heads = yolo(_resize_bilinear(rgb, net_hw))
        det7 = decode_heads(heads, anchors, model_cls.SCALES, net_hw,
                            model_cls.NEW_COORDS)

        # 2. gap frame: points, LK, RANSAC, Kalman over this rank's streams
        f_cap = fk.MAX_FLOW_TRACKS
        prev, cur = fk.preprocess(spec, f0), fk.preprocess(spec, f1)
        all_prev, all_valid, inside, forder, f_tlbrs, f_valid = \
            gap_points(spec, state, prev, f_cap)
        all_cur, status = fk.lk_core(spec, prev[1], cur[1], all_prev,
                                     all_valid)
        state, _ = gap_commit(
            cfg, spec, 2.0, s, state, inside, f_tlbrs, f_valid, forder,
            all_prev, all_cur, status, range(n_streams)[me], trans, acc_cov,
            frame_rect)

        # 3. association: costs, cascade, finals, on-device commit
        n_depth = 4
        params = (cfg, dist_ops.Metric.EUCLIDEAN, n_depth, 0.2, 0.9, 0.6,
                  1.0, 0.7, s)
        feature_psum = None
        if model_par > 1:
            def feature_psum(t):
                red = t.cpu() if dist.get_backend() == 'gloo' else t
                dist.all_reduce(red, group=mesh.get_group('model'))
                t.copy_(red)
        (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
         base_iou_active, base_unconf, u_det, col4row) = assoc_costs_batch(
            params, state, hist, dets, emb, feature_psum)
        u_det, col4row = stages_scan_core(
            n_depth, cost, iou_cost, depth_masks, base_iou_active,
            base_unconf, u_det, col4row)
        u_det_conf, reid_c4r, rect_c4r = finals_core(
            0.5, 0.45, 0.2, s, state[2], state[3], state[4], state[5],
            dets[0], dets[2], reid_cost, h_reid_ok, occluded, u_det,
            col4row)
        new_state, new_hist, _ = commit_batch(
            cfg, s, 6, hist_cap - 2, state, hist, dets, emb, 5, frame_rect,
            (occluded, col4row, u_det_conf, reid_c4r, rect_c4r))

    assert det7.dim() == 3 and det7.shape[0] == 1 and det7.shape[2] == 7
    assert bool(torch.isfinite(det7).all())
    assert new_state[0].shape == (1, t_cap, 8)
    assert new_hist[0].shape == (1, hist_cap, feat // n_part)
    # every stream's seeded near-identity detections matched, the tracks
    # kept alive by the on-device decisions
    alive = [None] * dist.get_world_size()
    dist.all_gather_object(alive, new_state[3][0, :8].cpu().tolist())
    alive = np.array(alive[::model_par])
    assert alive.mean() > 0.5, alive
    line = (f'dryrun ok: {n_streams} streams x {model_par}-way TP on '
            f'{n_devices} devices ({dist.get_backend()}, {device}); '
            f'detector={model_name} @{net_hw[0]}x{net_hw[1]}; '
            f'{int(alive.sum())}/{alive.size} seeded tracks alive after '
            f'the fused on-device association; {feat // n_part} of {feat} '
            f'ReID features a rank')

    def host(t):
        return t.cpu().numpy()
    return {'line': line, 'features': (fsl.start, fsl.stop),
            'lk_launches': dict(fk.lk_pyramidal.launches),
            'gap_commit_launches': gap_commit.launches,
            'preprocess_launches': fk.preprocess.launches,
            'gap_points_launches': gap_points.launches,
            'assoc_launches': (asg.cascade_auction.launches,
                               asg.greedy_match.launches,
                               asg.greedy_finals.launches),
            'tail_launches': tail_launches(),
            'frame_launches': frame_launches(),
            'cost': host(cost),
            'reid_cost': host(reid_cost),
            'col4row': host(col4row), 'valid': host(new_state[3]),
            'feat_sum': host(new_state[13]),
            'hist': [host(t) for t in new_hist]}


# ---------------------------------------------------------------------------
# Multi-stream runs on a mesh
# ---------------------------------------------------------------------------

def splice_detections(mot, dets):
    """Make ``mot``'s detector answer with ``dets`` after its network ran:
    ``dets`` holds ``frames`` (the frame indices that detect) and the
    global ``tlbr [F, S, D, 4]``, ``label``, ``conf``, ``valid [F, S, D]``;
    each rank takes its ``local_streams``. What the network found is kept
    in ``mot.network_dets``: ``{frame: [(tlbr, label, conf) of each local
    stream]}``."""
    from .detector import make_detections
    det = mot.detector
    mine = mot.local_streams
    at = {int(f): i for i, f in enumerate(dets['frames'])}
    arrays = [np.asarray(dets[k])[:, mine.start:mine.stop]
              for k in ('tlbr', 'label', 'conf', 'valid')]
    staged = {f: tuple(torch.as_tensor(a[i], device=mot.device)
                       for a in arrays) for f, i in at.items()}
    real_post, real_dev = det.postprocess, det.postprocess_device_batch
    mot.network_dets = {}

    def post():
        mot.network_dets[mot.frame_count] = [
            (d.tlbr, d.label, d.conf) for d in real_post()]
        tlbr, label, conf, valid = (a[at[mot.frame_count]] for a in arrays)
        return [make_detections(tlbr[s][valid[s]].astype(float),
                                label[s][valid[s]].astype(int),
                                conf[s][valid[s]].astype(float))
                for s in range(len(mine))]

    def post_dev():
        tlbr, label, conf, valid = (t.cpu().numpy() for t in real_dev())
        mot.network_dets[mot.frame_count] = [
            (tlbr[s][valid[s]], label[s][valid[s]], conf[s][valid[s]])
            for s in range(len(mine))]
        return staged[mot.frame_count]

    det.postprocess, det.postprocess_device_batch = post, post_dev


def track_rows(mot):
    """``{stream: sorted [(id, tlbr, age, hits)]}`` of every track of this
    rank's streams."""
    return {s: sorted((t.trk_id, tuple(map(float, t.tlbr)), t.age, t.hits)
                      for t in trk.tracks.values())
            for s, trk in zip(mot.local_streams, mot.trackers)}


def run_multi_stream(mot, frames, dets=None, sync_every_frame=False):
    """Reset ``mot`` and step it through ``frames`` (global batches
    ``[S, H, W, 3]``), with ``dets`` spliced in if given. Returns the track
    rows (``track_rows``) after every frame with ``sync_every_frame``, else
    once at the end, and the step times in ms (the device synchronised on
    each side)."""
    if dets is not None:
        splice_detections(mot, dets)
    cuda = mot.device.type == 'cuda'
    mot.reset(1 / 30.0)
    rows, step_ms = [], []
    for frame in frames:
        if cuda:
            torch.cuda.synchronize()
        t0 = time.perf_counter()
        mot.step(frame)
        if cuda:
            torch.cuda.synchronize()
        step_ms.append((time.perf_counter() - t0) * 1e3)
        if sync_every_frame:
            mot.sync()
            rows.append(track_rows(mot))
    if not sync_every_frame:
        mot.sync()
        rows.append(track_rows(mot))
    return rows, step_ms


def multi_stream_rank(inputs, n_streams, model_parallel, mot_kwargs,
                      device='cpu', mesh_device='cpu',
                      sync_every_frame=False):
    """Rank worker: ``MultiStreamMOT`` on a ``make_stream_mesh(
    model_parallel=, device=mesh_device)`` mesh over the frames of
    ``inputs/frames.npy`` (``[F, S, H, W, 3]``, read for this rank's streams
    only) and the detections of ``inputs/dets.npz`` (``splice_detections``);
    returns this rank's ``local_streams``, rows, step times, OSBlock, LK,
    gap-commit, preprocess, gap-points, cascade and greedy kernel launches,
    its NMS, merge, SSD postprocess and commit launches
    (``tail_launches``), its YOLO postprocess, costs and ReID-input calls
    (``frame_launches``) and what its detector's network found
    (``network_dets``)."""
    from .ops import assignment as asg
    from .ops.flow_kernels import lk_pyramidal, preprocess
    from .ops.gap_commit import gap_commit
    from .ops.gap_points import gap_points
    from .ops.osnet_block import osblock
    from .parallel import MultiStreamMOT, make_stream_mesh
    mesh = make_stream_mesh(model_parallel=model_parallel, device=mesh_device)
    frames = np.load(Path(inputs) / 'frames.npy', mmap_mode='r')
    with np.load(Path(inputs) / 'dets.npz') as f:
        dets = {k: f[k] for k in f.files}
    mot = MultiStreamMOT(n_streams=n_streams, device=device, mesh=mesh,
                         **mot_kwargs)
    osblock.launches = 0
    lk_pyramidal.launches = dict.fromkeys(lk_pyramidal.launches, 0)
    gap_commit.launches = preprocess.launches = gap_points.launches = 0
    asg.cascade_auction.launches = asg.greedy_match.launches = 0
    asg.greedy_finals.launches = 0
    tail_launches(reset=True)
    frame_launches(reset=True)
    rows, step_ms = run_multi_stream(mot, frames, dets, sync_every_frame)
    return {'local_streams': list(mot.local_streams), 'rows': rows,
            'step_ms': step_ms, 'osblock_launches': osblock.launches,
            'lk_launches': dict(lk_pyramidal.launches),
            'gap_commit_launches': gap_commit.launches,
            'preprocess_launches': preprocess.launches,
            'gap_points_launches': gap_points.launches,
            'assoc_launches': (asg.cascade_auction.launches,
                               asg.greedy_match.launches,
                               asg.greedy_finals.launches),
            'tail_launches': tail_launches(),
            'frame_launches': frame_launches(),
            'network_dets': mot.network_dets}


def each_run(fn, arg_lists) -> list:
    """Rank worker: ``fn(*args)`` for each of ``arg_lists`` in turn, in
    one process (one spawn for several runs)."""
    return [fn(*args) for args in arg_lists]


def zoo_module(model_name: str, seed: int = 0, varied_bn: bool = False):
    """The registered YOLO, SSD or ReID model ``model_name`` in eval mode
    on the CPU, random init from ``seed`` (Flax's defaults; with
    ``varied_bn`` each BN's four vectors then drawn away from identity)."""
    from .models import registry
    from .models.layers import BatchNorm, random_init_
    for reg in (registry.YOLOModel, registry.SSDModel, registry.ReIDModel):
        try:
            cls = reg.get_model(model_name)
            break
        except KeyError:
            continue
    else:
        raise KeyError(f'{model_name!r} is not a registered model')
    module = cls.build().requires_grad_(False).eval()
    gen = torch.Generator().manual_seed(seed)
    random_init_(module, gen)
    if varied_bn:
        for m in module.modules():
            if isinstance(m, BatchNorm):
                m.weight.uniform_(0.5, 1.5, generator=gen)
                m.bias.uniform_(-0.1, 0.1, generator=gen)
                m.running_mean.uniform_(-0.1, 0.1, generator=gen)
                m.running_var.uniform_(0.5, 1.5, generator=gen)
    return module


def zoo_outputs(module, x, literal: bool = False) -> list:
    """``module`` on ``x`` (NHWC float32) as a list of numpy arrays: a
    YOLO's heads, an SSD's (locs, confs), a ReID model's embeddings;
    ``literal``: OSNet's per-stream forward (``force_plain_streams``)."""
    from .models.osnet import force_plain_streams
    x = torch.as_tensor(x, device=next(module.parameters()).device)
    with torch.no_grad(), (force_plain_streams() if literal
                           else contextlib.nullcontext()):
        out = module(x)
    out = [out] if isinstance(out, torch.Tensor) else list(out)
    return [o.float().cpu().numpy() for o in out]


def sharded_heads_rank(model_name, x, model_parallel, seed=0,
                       varied_bn=False, literal=False, device='cpu'):
    """Rank worker: ``zoo_module(model_name, seed, varied_bn)`` on
    ``device`` under ``shard_conv_channels`` over a gloo mesh; returns the
    plan, the shapes of the sharded state dict, its outputs on ``x``
    (``zoo_outputs``; ``literal`` adds OSNet's per-stream forward under
    ``'literal'``), the forward's time in ms and the OSBlock launches."""
    from .ops.osnet_block import osblock
    from .parallel.streams import make_stream_mesh, shard_conv_channels
    from .weights import flax_shapes
    mesh = make_stream_mesh(model_parallel=model_parallel, device='cpu')
    module = zoo_module(model_name, seed, varied_bn).to(device)
    plan = shard_conv_channels(module, mesh)
    out = {'plan': plan, 'shapes': flax_shapes(module)}
    zoo_outputs(module, x)                  # gathers the OSBlock weights
    if device != 'cpu':
        torch.cuda.synchronize()
    osblock.launches = 0
    t0 = time.perf_counter()
    out['heads'] = zoo_outputs(module, x)
    out['ms'] = (time.perf_counter() - t0) * 1e3
    out['osblock_launches'] = osblock.launches
    if literal:
        out['literal'] = zoo_outputs(module, x, literal=True)
    return out


def main(argv=None):
    p = argparse.ArgumentParser(description=__doc__,
                                formatter_class=argparse.RawTextHelpFormatter)
    p.add_argument('--dryrun', type=int, required=True, metavar='N',
                   help='ranks of the (streams, model) mesh')
    p.add_argument('--device', default='cuda', choices=('cuda', 'cpu'),
                   help="'cuda': one NCCL rank per card; 'cpu': gloo ranks")
    args = p.parse_args(argv)
    dryrun_multichip(args.dryrun, args.device)
    print(f'dryrun_multichip({args.dryrun}) OK')


if __name__ == '__main__':
    main()
