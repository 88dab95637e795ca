#!/usr/bin/env python3
"""Smoke run of the PyTorch + CUDA port on one NVIDIA GPU.

    python3 chip_smoke.py

Phases, each raising on failure (the exit code is then non-zero):

1. device: requires CUDA, prints the card and its power limit, turns TF32
   off for matrix products and convolutions;
2. build: compiles the OSBlock kernel (csrc/osnet_block.cu), the
   pyramidal-LK kernels (csrc/lk_pyramidal.cu: a tile of lanes a point,
   and one thread a point), the gap-commit kernel (csrc/gap_commit.cu),
   the preprocess kernel (csrc/flow_preprocess.cu), the gap-points
   kernel (csrc/gap_points.cu), the association solvers' kernels
   (csrc/assoc_solvers.cu), the NMS, merge, YOLO and SSD postprocess
   kernels (csrc/nms_waves.cu), the commit kernel (csrc/assoc_commit.cu),
   the costs kernel (csrc/assoc_costs.cu) and the ReID-input kernel
   (csrc/reid_crops.cu) from the sources in this checkout, one ``nvcc``
   each, all at once, and prints ptxas's registers, shared memory and
   spills;
3. kernel vs its plain version at the six OSNet-x0.25 block shapes (64
   crops, bf16; two calls bitwise equal), with each shape's time (20
   back-to-back launches between two CUDA events), bound, roofline share
   and launch plan; again at 1,024 crops, the batch of the multi-stream
   path (phase 13);
4. OSNet-x0.25 forward on 64 crops, kernel path vs plain path;
5. reference: the tracker on a small synthetic sequence, GPU against the
   port's CPU path; ``StreamTracker`` at 2 streams (synthetic detections
   and embeddings) and the legacy ``compute_flow`` + ``apply_kalman``,
   GPU against CPU; the LK kernel launched once a tracked frame on the GPU,
   and the gap-commit kernel too (not on the legacy path, which keeps the
   plain RANSAC and Kalman);
6. main path: ``MOT`` at 1280x720 with cfg/mot.json (YOLOv4-512 with
   random weights, OSNet-x0.25, detector_frame_skip=5) on drifting
   textured frames, with 40 synthetic detections spliced in after the
   real YOLO graph ran; 20 frames through ``step``, then 20 through
   ``step_batch`` in chunks of 5; equal snapshots, visible tracks, finite
   Kalman state, the OSBlock kernel launched 6 times per association
   frame and an LK kernel once per frame after the first of each run
   (every frame but the first tracks, the detection frames too; one
   kernel a run, the one ``lk_design`` picks for its points); the float
   run also times a gap frame's stages alone, the preprocess and the point
   assembly through their kernels with their plain versions beside them
   (phase 16 prints them), and an association frame's stages alone
   (``assoc_stages_ms``: the detector's net, its NMS, the crops alone,
   crops + OSNet, the costs, the cascade, the finals and the commit
   through the kernels and through the plain versions, the whole
   ``update_device_fused`` call and the whole association frame), the
   host syncs a call of the NMS, the crops alone, crops + OSNet, the
   costs, the cascade, the finals, the commit, ``update_device_fused`` and
   a whole association frame (net, NMS and ``update_device_fused``), and
   the cascade kernel's bidding rounds by stage and phase;
7. detector zoo: every registered YOLO and SSD with random weights at its
   full input size on a 1280x720 frame: raw head shapes, finite values,
   the median time of the whole detector; SSDMobileNetV1 and YOLOv4-tiny
   also against the same module on the CPU;
8. SSD postprocess: the synthetic decoded rows of tests/test_detector.py
   through ``SSDDetector._postprocess_device`` on the card and on the
   CPU, equal;
9. SSD main path: phase 6 with ``detector_type='SSD'`` (SSDInceptionV2 in
   a 4x2 tiling of 300x300 tiles, cfg/mot.json's ``ssd_detector_cfg``),
   then the SSD detector's stages alone (``ssd_stages_ms``: the tiling
   preprocess, the net, ``decode_ssd``, the postprocess on the run's rows
   and on tests/test_torch_ssd_post.py's crowded rows, the whole run; each
   between CUDA events, its host time and its kernels from
   ``torch.profiler``);
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
   streams 0 and 1 equal, the LK kernel once a frame for all 8 streams;
   the step medians and the aggregate FPS beside phase 6's single-stream
   median, then each stage alone, and the 8-stream association's cascade
   and finals alone through the kernels and the plain versions;
14. mesh (``parallel.make_stream_mesh``, torch.distributed): (a) phase 13
   over a 1x1 NCCL mesh in this process, (b) phase 13 over two spawned
   gloo ranks sharing the card as a (2, 1) mesh, 4 streams each, (c)
   ``multichip.dryrun_multichip(1)`` over NCCL (YOLOv4-512 under
   ``shard_conv_channels``, the chained gap step, the association). Every
   stream's rows of (a) and (b) equal phase 13's (IDs, ages, hits; boxes
   within 1e-3 px), the OSBlock runs 6 times an association frame and the
   LK kernel once a frame on each rank, and once in (c). The process groups
   are destroyed before the phase returns;
15. the port's last gaps with the JAX package: (a) ``ransac_draws`` on
   the card bit-equal to a numpy threefry-2x32 reference and to bit
   patterns recorded from ``jax.random``, and phase 13's rows (made with
   those draws) with visible, unique track IDs on every stream, and the
   draws' host time at phase 13's flow budget and at 8 x 128 tracks
   against the CPU ``torch.Generator`` draw they replaced; (b)
   OSNet-x0.25 on 64 crops 2 ways over ``'model'`` (two gloo ranks sharing
   the card; the OSBlock kernel on each rank, on its gathered weights)
   against the unsharded kernel run, at phase 3's tolerances; (c)
   SSDInceptionV2 on 8 tiles of 300x300 2 ways against unsharded, with
   the difference's cause shown in this process: the unsharded run twice
   is bit-equal, and each bf16 conv recomputed for half its output
   channels against the whole conv's output sliced; (d)
   ``extract_async_batch`` under dynamic int8 on 4 streams x 16 crops of
   different brightness against each stream's own extraction, and a
   control with the ranges pooled over the streams that must fail the
   same bound;
16. pyramidal LK, both kernels (a tile of lanes a point; one thread a
   point), each against the plain version on the same inputs run on the
   CPU, bit for bit and at the tolerance of the port against JAX (and the
   shares against its run on the card, beside the card's plain run
   against the CPU's), at the main path's shape (1 stream, flow budget
   48: 1,792 points) and at 8 differing streams with budget 128 (34,816
   points), on textured 1280x720 frames with a known drift per stream;
   the wrapper launches the kernel ``lk_design`` picks; two calls bitwise
   equal; the drift recovered; then the two kernels in turns (tile, one
   thread, one thread, tile), each with its device time a launch (100
   launches of the C entry between two CUDA events, queued behind a sleep
   kernel), and the wrapper's time a call (20 calls between CUDA events)
   and its host time a call (host clock, no sync) before and after the
   turns, beside the bound, the roofline share, the plain version's time
   and the SM clocks before and after; both kernels' device times on the
   first 256, 512, ... of the 8 streams' 4,352 points (2,048 to 34,816
   points), both sides of ``lk_design``'s threshold; and the gap frame's
   stages alone from phases 6 and 13. Phases 5-15 run under a counter of
   plain-LK calls on CUDA tensors, which must stay 0, and each LK kernel
   must launch there; likewise the plain gap commit
   (``tracker.gap_commit_core``) on CUDA tensors and, outside the legacy
   path and phase 15 (a), the host's RANSAC draws for the card
   (``ransac_draws_batch``), which must stay 0, while the gap-commit
   kernel launches once a tracked frame for all of a call's streams
   (phases 5, 6, 9, 12, 13 and 14); and the plain preprocess
   (``preprocess_reference``) and the plain point assembly
   (``tracker.gap_points_core``, ``tracker.gap_points_batch``) on CUDA
   tensors, which must stay 0, while the preprocess kernel launches once a
   frame and the gap-points kernel once a tracked frame, each for all of a
   call's streams (the legacy path's ``Flow.predict`` takes the preprocess
   kernel and keeps the plain ``flow_points_core``);
17. the gap-commit kernel (RANSAC draws, homography and similarity RANSAC,
   Kalman warp/predict/update and commit; two launches a call, a
   stream's homography, its tracks' similarity fits and its Kalman slots
   spread over blocks): its draws
   bit-equal to ``ransac_draws_batch`` and to phase 15 (a)'s ``jax.random``
   bits; every output, to the bit, on each synthetic call of
   tests/test_torch_gap_commit.py::OUTPUT_SHA256 (the sha256 the first
   design, one block a stream, gave); the kernel against the plain
   version run on the CPU on a real
   main-path gap frame (1 stream, flow budget 48, from phase 6) and on
   phase 13's 8 streams at budget 128 (booleans may differ on at most 1 %
   of the track slots, the share printed; H within 0.01 px at the frame's
   corners, means within 1e-3 px and covariances within 1e-4 of a track's
   largest entry where a stream's inliers agree), against the plain
   version run on the card (the same rule), and on the synthetic cases of
   tests/test_torch_gap_commit.py at that file's tolerances; two calls
   bitwise equal; each launch's registers and shared memory as ptxas
   reported them; then its device time a call (100 calls of the C entry,
   each its two launches, between CUDA events, queued behind a sleep
   kernel), the wrapper's time a call and host time a call, the plain
   version's time on the card, and the bound (``gap_commit_bound_ms``);
18. the preprocess kernel and the gap-points kernel on phase 6's real gap
   frame (1 stream, its flow budget of 48) and phase 13's 8 streams at
   budget 128: each against its plain version run on the CPU, every value
   bit for bit (the bit-equal share printed), and run on the card (the
   share printed); two calls bitwise equal; every output, to the bit, on
   each synthetic call of tests/test_torch_flow_preprocess.py's and
   tests/test_torch_gap_points.py's ``OUTPUT_SHA256`` (the sha256 the first
   designs gave); each launch's registers, shared memory and spills as
   ptxas reported them; then each kernel's device time a call (100 calls
   of the C entry between CUDA events, queued behind a sleep kernel), the
   wrapper's time a call and host time a call, the plain version's time on
   the card, and the bound (``preprocess_bound_ms``,
   ``gap_points_bound_ms``);
19. the association solvers' kernels (csrc/assoc_solvers.cu: the whole
   auction cascade of a call in one launch, a block a stream; the finals
   (their masks, the rectify cost and both greedy matchings) in one launch
   of the greedy kernel, a block a stream and problem, behind the cascade
   by a programmatic dependent launch): each against its plain version
   (``cascade_reference``, ``greedy_match_reference``,
   ``tracker.finals_reference``) run on the CPU and on the card, bit for
   bit, on phase 6's real association arguments (1 stream) and phase 13's
   (8 streams), on contested problems at the kernels' full width (the
   stage-1 cascade of scripts/prof_auction.py, 64 tracks and 40
   detections padded to 128, and its one-stage auction, at 1 and 8
   streams; greedy problems of the finals' shapes and gates that take
   tens of matches; finals of 128 tracks whose near-duplicate pairs
   contend for the rectify matches, ``contested_finals``), and on the
   seeded cases of tests/test_torch_assoc_solvers.py, whose every output
   is also held to the sha256 the first design of the kernels gave
   (``OUTPUT_SHA256``); the matches, rounds and bids logged; two calls
   equal; ``stages_scan_core`` and ``finals_core`` on the real arguments
   under ``torch.cuda.set_sync_debug_mode('error')``; each kernel's
   registers, spills and shared memory as ptxas reported them and each
   launch's plan (blocks, threads, dynamic shared memory); then each
   launch's device time a call (100 calls of the C entry between CUDA
   events, queued behind a sleep kernel: the cascade, the finals, and the
   greedy entry alone on the finals' two problems), the wrapper's time a
   call and host time a call, the plain version's time on the card, and
   the bound of the work each case's data needs (``cascade_bound_ms``,
   ``greedy_bound_ms``, ``finals_bound_ms``: the live entries only, the
   bids the run made; the finals' masks, boxes and rectify cost too).
   Phases 5-14 count both kernels' launches: one cascade and one finals
   launch (of the greedy kernel) an association frame, for all of a
   call's streams (``expect_assoc``); and calls of the plain solvers
   (``auction_lap_reference``, ``cascade_reference``,
   ``greedy_match_reference``, ``tracker.finals_reference``) on CUDA
   tensors, which must stay 0.
20. the generic NMS kernel (csrc/nms_waves.cu: the overlap packed into
   bits by many blocks, then a block a problem runs the waves to the end;
   ``geometry.greedy_suppress``, ``nms_mask``, ``diou_nms_mask``), the
   generic merge kernel (the same file: a block a problem runs the label
   rounds to the fixpoint; ``merge_labels``), which no main path runs (the
   YOLO and SSD postprocesses have their own kernels, phases 21 and 22),
   and the commit kernel (csrc/assoc_commit.cu: the
   decisions a block a stream, then the wide rows a warp a row): each
   against its plain version (``geometry.greedy_suppress_reference``,
   ``nms_waves.merge_labels_reference``, ``tracker.commit_part``) run on
   the CPU and on the card, the NMS and the merge bit for bit, the
   commit's integers, booleans and feature sums bit for bit and its means
   and covariances at tests/test_torch_assoc_commit.py's tolerances, on
   phase 6's and phase 13's real NMS and commit arguments,
   the SSD postprocess's merge of phase 8's rows, contested cases (1,024
   same-label candidates in chains eight waves deep at 1 and 8 streams;
   800 SSD rows whose components span the 8 tiles; the full-width
   contested commit, with merges, duplicates, reinstates, dropped
   creations, out-of-frame exits, steals and evictions, at 1 and 8
   streams), and the seeded cases of tests/test_torch_nms_kernel.py and
   tests/test_torch_assoc_commit.py with their ``OUTPUT_SHA256``; two calls
   equal; ``nms_and_gate``, the SSD postprocess, ``commit_core`` and
   ``commit_batch`` under ``torch.cuda.set_sync_debug_mode('error')``;
   ptxas's registers, spills and shared memory; each kernel's device time
   a call (100 calls of the C entry between CUDA events, queued behind a
   sleep kernel), the wrapper's time and host time a call, the plain
   version's time on the card and the bound (``suppress_bound_ms``,
   ``merge_bound_ms``, ``commit_bound_ms``). Phases 5-14 count the
   generic NMS and merge kernels' launches (none), the SSD postprocess
   kernels' (one an SSD detector run) and the commit kernel's (one an
   association frame, for all of a call's streams) (``expect_tail``), and
   calls of the plain versions on CUDA tensors, which must stay 0.
21. the YOLO postprocess kernels (csrc/nms_waves.cu ``nms_select_forward``:
   a block a stream selects and orders the top MAX_RAW candidates by a
   radix select, many blocks compute the DIoU bits from their boxes, a
   block a stream runs the waves, the gates and the order), the costs
   kernel (csrc/assoc_costs.cu: a block a tile of 16 track or history
   rows and a stream) and the ReID-input kernel (csrc/reid_crops.cu: a
   block an output row of a crop): each against its plain version
   (``detector.nms_and_gate_reference``, ``tracker.assoc_costs_reference``,
   ``ops.reid_crops.reid_crops_reference``) on the CPU and on the card,
   the postprocess and the crops bit for bit, the costs' masks,
   occlusion, IoU cost and gates bit for bit and the fused and reID costs
   at tests/test_torch_assoc_costs.py's tolerances, at 1 and 8 streams on
   phase 6's and phase 13's real arguments and on contested cases, and on
   the seeded cases of tests/test_torch_nms_select.py,
   tests/test_torch_assoc_costs.py and tests/test_torch_reid_crops.py
   with their ``OUTPUT_SHA256``; no DIoU matrix on the card; the
   cascade, the finals and the commit fed the kernel's costs give the
   plain costs' integers (phase 6's and 13's frames, the stage-1 regime);
   glibc's and the CPU's ``pow`` against the card's; a whole association
   frame at 1 and 8 streams under ``set_sync_debug_mode('error')``; each
   kernel's device time, wrapper and host time a call, plain time and
   bound (``nms_select_bound_ms``, ``assoc_costs_bound_ms``,
   ``reid_crops_bound_ms``). Phases 5-14 count the three kernels'
   launches (``expect_frame``: the postprocess once a YOLO detector run,
   the costs once an association frame, the crops once an extraction,
   each for all of a call's streams), and calls of their plain versions
   on CUDA tensors, which must stay 0; the YOLO detectors' NMS waves run
   inside the postprocess kernels;
22. the SSD postprocess kernels (csrc/nms_waves.cu
   ``ssd_postprocess_forward``: a block a tile computes the pixel boxes,
   the gates and the NMS's dominance bits from the boxes and runs the
   waves; by programmatic dependent launch one block compacts the kept
   rows, orders them by x, sweeps their pairs for the cross-tile IoM
   edges, joins components by union-find, collapses them and places the
   rows by counting) against their plain version
   (``detector.ssd_postprocess_reference``) on the CPU and on the card,
   every output bit for bit, on the seeded cases of
   tests/test_torch_ssd_post.py with their ``OUTPUT_SHA256``, phase 9's
   own decoded rows, phase 8's rows and the crowded full-width rows; each
   under ``set_sync_debug_mode('error')`` with the plain version's [n, n]
   functions made to raise, its allocations' peak under an [n, n] bool
   matrix, its two kernels counted by ``torch.profiler`` and no torch op
   but allocations and views dispatched (``dispatched_ops``); two calls
   equal; ptxas's registers, spills and shared memory; device, wrapper,
   host and C-entry times a call, the plain time on the card and the bound
   (``ssd_post_bound_ms``). Phases 5-14 count its calls (``expect_tail``:
   one an SSD detector run) and the plain version's on CUDA tensors, which
   must stay 0.

The line before the last is a JSON object of the kernels; the last line
is ``{"ok": true, "device": {...}}``.
"""
import json
import re
import statistics
import subprocess
import sys
import tempfile
import time
from collections import Counter
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
# phase 16: (streams, flow budget) of the main path and of phase 13's
# largest budget
LK_CASES = ((1, 48), (8, 128))
# phase 17, the gap-commit kernel against its plain version on a real gap
# frame: the share of track slots whose booleans (valid, lost, pending,
# has_klt, the estimate's validity) may differ (an inlier at the 3 px
# threshold, or a box at a rounding boundary, can flip one), and the
# tolerances of tests/test_torch_gap_commit.py where a stream's
# background inliers agree
GAP_BOOL_SHARE = 0.01
GAP_H_PX, GAP_MEAN_PX, GAP_COV_REL, GAP_RATIO = 0.01, 1e-3, 1e-4, 1e-6
# the gap commit's two launches (csrc/gap_commit.cu), in their order; the
# preprocess's launch and the point assembly's two
GAP_KERNELS = ('gap_fit_kernel', 'gap_kalman_kernel')
# the association solvers' two kernels (csrc/assoc_solvers.cu)
ASSOC_KERNELS = ('cascade_auction_kernel', 'greedy_match_kernel')
TAIL_KERNELS = ('suppress_pack_kernel', 'suppress_waves_kernel',
                'merge_labels_kernel', 'assoc_commit_rows_kernel',
                'assoc_commit_kernel')
FLOW_KERNELS = ('preprocess_kernel', 'points_owner_kernel',
                'points_select_kernel')
FRAME_KERNELS = ('nms_select_kernel', 'nms_pack_boxes_kernel',
                 'nms_order_kernel', 'assoc_prep_kernel',
                 'assoc_tile_kernel', 'reid_crops_kernel')
# the H100 SXM's 32-bit integer rate (64 INT32 lanes an SM a clock, 132
# SMs, 1.98 GHz; the draws' threefry rounds are integer work)
PEAK_I32 = 132 * 64 * 1.98e9
# phase 16: launches a device time averages over, and the sleep they
# queue behind (cycles of the SM clock, about 10 ms at 1.98 GHz), so that
# the card runs them back to back whatever the host's enqueue rate
LK_TIMED_LAUNCHES = 100
LK_SLEEP_CYCLES = 20_000_000
# phase 16: the points a stream of the last case's sweep grow by
LK_SWEEP_STEP = 256
# the LK kernel against its plain version on the same inputs, run on the
# CPU: the bounds of the port against JAX (tests/test_torch_flow.py::
# test_lk_matches_jax), the same status on more than 99 % of the points,
# and on points tracked by both more than 90 % within 1e-3 px and all
# within 0.1 px (the kernel rounds as the CPU does and read bit-equal).
# The plain version run on the card sums in CUDA's order: a point whose
# steps never settle below 0.03 px can then end pixels away (2.18 px of
# 34,816 points, H100 80GB HBM3 at 700 W), so against that run, and in the
# control of the card's plain run against the CPU's, the two shares apply
# and the largest difference is printed
LK_STATUS_SHARE, LK_CLOSE_SHARE, LK_CLOSE_PX, LK_MAX_PX = 0.99, 0.9, 1e-3, 0.1
# readings with the plain LK loop on the card that the gap frame is
# printed beside (PERF.md section 5, H100 80GB HBM3 at 700 W): LK of one
# stream's gap frame, and phase 13's gap frame at 8 streams
PLAIN_LK_MS, PLAIN_GAP8_MS = 70.7, 70.222
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
# phase 15 (c), sharded SSDInceptionV2 against unsharded on the card: for
# some bf16 convs cuDNN gives other roundings when it computes half the
# output channels (the phase shows it), and the one-ulp seeds reach every
# output. Readings on an H100 80GB HBM3 at 700 W (chip_smoke.py): max-rel
# 4.57e-3 / 4.93e-3, mean-rel 5.41e-4 / 7.10e-4; the bounds are twice
# those, with no cap on the share of differing outputs (it read 0.99999
# and 1.0)
SHARD_MAX_REL, SHARD_MEAN_REL = 1e-2, 1.5e-3
# phase 15 (d), batched against per-stream int8 extraction on the same
# card, largest absolute difference of the unit-norm embeddings: it read
# up to 8.9e-8, and 6.3e-4 to 2.2e-3 with the ranges pooled over the
# streams (H100 80GB HBM3, 700 W)
INT8_STREAM_ATOL = 1e-5
# phase 15 (a): int32 bit patterns of jax.random's RANSAC uniforms at
# f_cap 16 (u_h[0, 0], u_h[-1, -1], u_a[0, 0, 0], u_a[-1, -1, -1]),
# recorded with JAX 0.9.0 (jax_threefry_partitionable)
JAX_DRAW_BITS = {0: (1062707686, 1049013672, 1058287196, 1047990976),
                 7: (1063128062, 1035415520, 1048240920, 1058237628),
                 2 ** 32 - 1: (1063880662, 1056177516, 1054358328,
                               1051539472)}


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
    return name, smi


def sm_clocks():
    """The SM clock and its maximum, as nvidia-smi reads them now."""
    return subprocess.run(
        ['nvidia-smi', '--query-gpu=clocks.sm,clocks.max.sm',
         '--format=csv,noheader'], capture_output=True, text=True,
        check=True).stdout.strip()


def phase_build():
    """Every kernel source, one ``nvcc`` each, started together."""
    from concurrent.futures import ThreadPoolExecutor
    from fastmot_tpu_torch.ops import cuda_build
    names = ('osnet_block', 'lk_pyramidal', 'gap_commit', 'flow_preprocess',
             'gap_points', 'assoc_solvers', 'nms_waves', 'assoc_commit',
             'assoc_costs', 'reid_crops')
    t0 = time.perf_counter()
    with ThreadPoolExecutor(len(names)) as pool:
        built = list(pool.map(cuda_build.build, names))
    for name, (path, seconds, nvcc_out) in zip(names, built):
        log(f'build: {name} {seconds:.2f} s -> {path.name}')
        for line in nvcc_out.splitlines():      # registers, spills, smem
            if 'registers' in line or 'spill' in line or 'Compiling' in line:
                log(f'ptxas {name}:', line.strip())
    log(f'build: {time.perf_counter() - t0:.2f} s for all '
        f'{len(names)}')
    return {name: nvcc_out for name, (_, _, nvcc_out) in zip(names, built)}


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


def reset_lk():
    """Zeroes the LK kernels', the gap-commit kernel's, the preprocess
    kernel's, the gap-points kernel's, the association solvers', the NMS,
    merge, SSD postprocess and commit kernels' and the YOLO postprocess,
    costs and ReID-input kernels' launch counts."""
    from fastmot_tpu_torch.multichip import tail_launches
    from fastmot_tpu_torch.ops import assignment as asg
    from fastmot_tpu_torch.ops.flow_kernels import lk_pyramidal, preprocess
    from fastmot_tpu_torch.ops.gap_commit import gap_commit
    from fastmot_tpu_torch.ops.gap_points import gap_points
    lk_pyramidal.launches = dict.fromkeys(lk_pyramidal.launches, 0)
    gap_commit.launches = preprocess.launches = gap_points.launches = 0
    asg.cascade_auction.launches = asg.greedy_match.launches = 0
    asg.greedy_finals.launches = 0
    tail_launches(reset=True)
    frame_counts(reset=True)


def flow_counts():
    """The preprocess and gap-points kernels' launches since
    ``reset_lk``."""
    from fastmot_tpu_torch.ops.flow_kernels import preprocess
    from fastmot_tpu_torch.ops.gap_points import gap_points
    return preprocess.launches, gap_points.launches


# the preprocess and gap-points kernels' launches on the main paths, by
# kernel (the kernels line's counts)
FLOW_LAUNCHES = Counter()


def expect_flow(tag, counts, frames, tracked):
    """The preprocess kernel ran once a frame (``frames``) and the
    gap-points kernel once a tracked frame (``tracked``), each for all of a
    call's streams."""
    if tuple(counts) != (frames, tracked):
        raise AssertionError(f'{tag}: preprocess and gap_points launched '
                             f'{tuple(counts)} times, expected '
                             f'{(frames, tracked)}')
    FLOW_LAUNCHES['flow_preprocess'] += counts[0]
    FLOW_LAUNCHES['gap_points'] += counts[1]


def gap_launches():
    """The gap-commit kernel's launches since ``reset_lk``."""
    from fastmot_tpu_torch.ops.gap_commit import gap_commit
    return gap_commit.launches


# the gap-commit kernel's launches on the main paths, by the run that
# ``expect_gap`` checked them in (the kernels line's count)
GAP_LAUNCHES = Counter()


def expect_gap(tag, launches, want):
    """The gap-commit kernel ran ``want`` times: once a tracked frame, for
    all of a call's streams at once."""
    if launches != want:
        raise AssertionError(f'{tag}: gap_commit launched {launches} '
                             f'times, expected {want}')
    GAP_LAUNCHES[tag] += launches


def lk_counts():
    """The LK kernels' launches since ``reset_lk``, by design."""
    from fastmot_tpu_torch.ops.flow_kernels import lk_pyramidal
    return dict(lk_pyramidal.launches)


def expect_lk(tag, launches, want):
    """The LK kernels ran ``want`` times in all (one launch a tracked
    frame, for all of a call's streams at once), and one kernel only: a
    run's point count, and so ``lk_design``'s pick, is fixed."""
    if sum(launches.values()) != want or \
            sum(n > 0 for n in launches.values()) != 1:
        raise AssertionError(f'{tag}: lk_pyramidal launched {launches}, '
                             f'expected {want} launches of one kernel')


def snapshots(mot):
    return {fid: sorted((tid, tuple(np.round(tlbr, 4))) for tid, tlbr in rows)
            for fid, rows in mot.flush_tracks().items()}


def phase_reference():
    """The tracker's GPU path against the port's CPU path (itself held
    against the JAX package by the CPU tests) on a small sequence. Returns
    the LK kernel's launches."""
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
        reset_lk()
        for device in ('cpu', 'cuda'):
            mot = MOT(size, device=device, **cfg)
            mot.reset(1 / 30.0)
            for frame in frames:
                mot.step(frame)
            runs.append(snapshots(mot))
    lk, gap_n, flow_n = lk_counts(), gap_launches(), flow_counts()
    assoc_n, tail_n = assoc_counts(), tail_counts()
    expect_lk('reference', lk, n_frames - 1)
    expect_gap('reference', gap_n, n_frames - 1)
    expect_flow('reference', flow_n, n_frames, n_frames - 1)
    # an association frame every third frame after the first (3, 6, 9)
    expect_assoc('reference', assoc_n, (n_frames - 1) // 3)
    # the public detections go through no NMS; the tracker embeds them on
    # the device (update_device_fused)
    expect_tail('reference', tail_n, 0, (n_frames - 1) // 3)
    expect_frame('reference', frame_counts(), 0, (n_frames - 1) // 3,
                 (n_frames - 1) // 3)
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
    log(f'reference: GPU == CPU on {len(cpu)} frames, {n_rows} track rows; '
        f'lk_pyramidal launches {lk}, gap_commit launches {gap_n}, '
        f'preprocess and gap_points launches {flow_n}, cascade_auction, '
        f'greedy_match and greedy_finals launches {assoc_n}, '
        f'greedy_suppress, merge_labels and assoc_commit launches {tail_n}')
    return lk


def _stream_dets(f, s, n=3):
    """[n, 4] boxes moving 2 px a frame, offset per stream (320x240)."""
    x = 30.0 + 90 * np.arange(n) + 2 * f + 12 * s
    y = 40.0 + 20 * np.arange(n) + f
    return np.stack([x, y, x + 45, y + 110], -1)


def phase_stream_reference():
    """``StreamTracker`` (2 streams, synthetic detections and embeddings)
    on the card against the port's CPU path: the same track IDs on every
    frame of every stream, boxes within 2 px. Returns the LK kernel's
    launches."""
    from fastmot_tpu_torch.detector import MAX_DETS, make_detections
    from fastmot_tpu_torch.parallel import StreamTracker
    size, n, n_frames, skip, n_obj = (320, 240), 2, 12, 3, 3
    frames = [textured_frames(size, n_frames, seed=20 + s) for s in range(n)]
    emb = np.zeros((n, MAX_DETS, 512), np.float32)
    for s in range(n):
        e = np.random.default_rng(100 + s).normal(size=(n_obj, 512))
        emb[s, :n_obj] = e / np.linalg.norm(e, axis=1, keepdims=True)
    runs = []
    reset_lk()
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
    lk, gap_n, flow_n = lk_counts(), gap_launches(), flow_counts()
    assoc_n, tail_n = assoc_counts(), tail_counts()
    expect_lk('stream tracker', lk, n_frames - 1)
    expect_gap('stream tracker', gap_n, n_frames - 1)
    expect_flow('stream tracker', flow_n, n_frames, n_frames - 1)
    expect_assoc('stream tracker', assoc_n,
                 sum(1 for f in range(1, n_frames) if f % skip == 0))
    expect_tail('stream tracker', tail_n, 0,
                sum(1 for f in range(1, n_frames) if f % skip == 0))
    # the embeddings are given: no crops
    expect_frame('stream tracker', frame_counts(), 0,
                 sum(1 for f in range(1, n_frames) if f % skip == 0), 0)
    _same_rows('stream tracker', *runs)
    log(f'reference: StreamTracker GPU == CPU on {n_frames - 1} frames of '
        f'{n} streams; lk_pyramidal launches {lk}, gap_commit launches '
        f'{gap_n}, preprocess and gap_points launches {flow_n}, '
        f'cascade_auction, greedy_match and greedy_finals launches {assoc_n}'
        f', greedy_suppress, merge_labels and assoc_commit launches {tail_n}')
    return lk


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
    the card against the CPU over 4 frames. Returns the LK kernel's
    launches."""
    from fastmot_tpu_torch import MultiTracker
    from fastmot_tpu_torch.detector import make_detections
    size, n_obj = (320, 240), 3
    frames = textured_frames(size, 5, seed=4)
    runs = []
    reset_lk()
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
    lk = lk_counts()
    expect_lk('legacy compute_flow', lk, len(frames) - 1)
    # the legacy path keeps the plain RANSAC and Kalman and the plain point
    # assembly of host-sorted tracks (ROADMAP section 2); Flow.init and
    # Flow.predict preprocess through the kernel
    expect_gap('legacy compute_flow', gap_launches(), 0)
    expect_flow('legacy compute_flow', flow_counts(), len(frames), 0)
    expect_assoc('legacy compute_flow', assoc_counts(), 0)
    expect_tail('legacy compute_flow', tail_counts(), 0, 0)
    expect_frame('legacy compute_flow', frame_counts(), 0, 0, 0)
    _same_rows('legacy compute_flow + apply_kalman', *runs)
    log('reference: compute_flow + apply_kalman GPU == CPU on 4 frames, '
        f'{len(runs[0][-1][0])} tracks; lk_pyramidal launches {lk}')
    return lk


def unpatched(module, name):
    """``module.name`` as it was before ``main`` put a counter around it."""
    return PLAIN.get(name, getattr(module, name))


# the plain versions main() counts on the card, before their counters
PLAIN = {}
# arguments a stage timer captured for a later phase (``assoc_stages_ms``:
# the main path's NMS and commit arguments, phase 20's; its postprocess,
# costs, crops and whole frame, phase 21's, and phase 13's as 'frame8')
STAGE_ARGS = {}


def gap_stages_ms(mot, frames):
    """One gap frame of ``mot``'s tracker after a run, each stage alone and
    the whole ``track`` call, synchronised (ms), the preprocess, the point
    assembly and the gap commit through their wrappers (the kernels) and
    their plain versions (the gap commit's with the host draws made before)
    beside them; the gap commit's arguments (one stream, phase 17's
    main-path case) and the preprocess's and point assembly's (phase 18's).
    The stages track from the last frame to the one before, and the whole
    call alternates between the two, so that LK has motion to track."""
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops import gap_commit as gc
    from fastmot_tpu_torch.ops import gap_points as gp
    trk = mot.tracker
    if trk._dev_state is None or trk._mirrors_dirty:
        trk._upload_state()
    spec, state, prev = trk.flow.spec, trk._dev_state, trk.flow.device_state
    pair = [torch.as_tensor(f, device='cuda') for f in frames[-2:]]
    f_cap = fk.flow_budget(sum(1 for t in trk.tracks.values() if t.active))
    cur = fk.preprocess(spec, pair[0])
    all_prev, all_valid, inside, forder, f_tlbrs, f_valid = \
        gp.gap_points(spec, state, prev, f_cap)
    all_cur, status = fk.lk_core(spec, prev[1], cur[1], all_prev, all_valid)
    draws = tuple(u[0] for u in unpatched(fk, 'ransac_draws_batch')(
        [trk.flow.seed], f_cap, 'cuda'))
    plain = unpatched(tr, 'gap_commit_core')
    args = (trk.kf_cfg, spec, float(trk.age_penalty), trk.confirm_hits,
            tuple(a[None] for a in state), inside[None], f_tlbrs[None],
            f_valid[None], forder[None], all_prev[None], all_cur[None],
            status[None], [trk.flow.seed], trk._trans_mat, trk._acc_cov,
            trk._frame_rect_dev)

    def whole():
        pair.reverse()
        trk.track(pair[0])
    plain_pre = unpatched(fk, 'preprocess_reference')
    plain_points = unpatched(tr, 'gap_points_core')
    stages = {
        'preprocess': lambda: fk.preprocess(spec, pair[0]),
        'preprocess, plain': lambda: plain_pre(spec, pair[0]),
        'points': lambda: gp.gap_points(spec, state, prev, f_cap),
        'points, plain': lambda: plain_points(spec, state, prev, f_cap),
        'LK': lambda: fk.lk_core(spec, prev[1], cur[1], all_prev, all_valid),
        'RANSAC + Kalman + commit': lambda: gc.gap_commit(*args),
        'RANSAC + Kalman + commit, plain': lambda: plain(
            trk.kf_cfg, spec, float(trk.age_penalty), trk.confirm_hits,
            state, inside, f_tlbrs, f_valid, forder, all_prev, all_cur,
            status, draws, trk._trans_mat, trk._acc_cov,
            trk._frame_rect_dev),
        'whole gap frame (track)': whole}
    out = {name: wall_ms(fn) for name, fn in stages.items()}
    out['flow budget'] = f_cap
    return out, args, (spec, pair[0].clone(), state, prev, f_cap)


def phase_main_path(detector_type='YOLO', tag='main path', int8=False,
                    stages=False, card=''):
    """Returns the OSBlock and LK kernels' launches, the step median and,
    with ``stages``, ``gap_stages_ms``'s and ``assoc_stages_ms``'s times
    and arguments after the run. An SSD run then times the detector's
    stages (``ssd_stages_ms`` on its last frame and on
    tests/test_torch_ssd_post.py's crowded rows) and leaves its decoded
    rows of that frame in ``STAGE_ARGS['ssd']`` (phase 22's)."""
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
    reset_lk()
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
    lk, gap_n, flow_n = lk_counts(), gap_launches(), flow_counts()
    assoc_n, tail_n, frame_n = assoc_counts(), tail_counts(), frame_counts()

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
        f'{int8_launches}, lk_pyramidal launches {lk}, gap_commit launches '
        f'{gap_n}, preprocess and gap_points launches {flow_n}, '
        f'cascade_auction, greedy_match and greedy_finals launches {assoc_n}'
        f', greedy_suppress, merge_labels and assoc_commit launches {tail_n}'
        f', nms_select, assoc_costs and reid_crops launches {frame_n}')
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
    expect_lk(tag, lk, 2 * (len(frames) - 1))     # step, then step_batch
    expect_gap(tag, gap_n, 2 * (len(frames) - 1))
    expect_flow(tag, flow_n, 2 * len(frames), 2 * (len(frames) - 1))
    expect_assoc(tag, assoc_n, n_assoc)
    # the SSD's per-tile NMS and merge; YOLO's whole postprocess in the
    # nms_select kernels
    ssd = detector_type == 'SSD'
    expect_tail(tag, tail_n, n_detect if ssd else 0, n_assoc)
    expect_frame(tag, frame_n, 0 if ssd else n_detect, n_assoc, n_assoc)
    if int8:
        log(f'{tag}: int8_conv launches per association frame '
            f'{det_convs + reid_convs} ({det_convs} detector convs, '
            f'{reid_convs} OSNet convs; {n_detect} detector runs, '
            f'{n_assoc} association frames)')
    out = {'osblock': launches, 'lk': lk,
           'median': statistics.median(step_ms)}
    if ssd:
        import tests.test_torch_ssd_post as ts
        from fastmot_tpu_torch.models.ssd import decode_ssd
        frame = torch.as_tensor(frames[-1], device='cuda')
        crowded = tuple(torch.as_tensor(a, device='cuda')
                        for a in ts.crowded_rows(0))
        with torch.no_grad():
            log_ssd_stages(tag, ssd_stages_ms(det, frame, crowded), card)
            det_out = decode_ssd(*det.module(det.preprocess(frame)),
                                 det._anchors, det.model.TOPK)
        STAGE_ARGS['ssd'] = (
            (det_out, det._tiles_f, det._scale, det.label_mask),
            (det.conf_thresh, det.max_area, det.merge_thresh,
             det.model.NMS_THRESH))
    if stages:
        out['gap stages'], out['gap args'], out['flow args'] = \
            gap_stages_ms(mot, frames)
        out['assoc stages'], out['assoc syncs'], out['assoc args'] = \
            assoc_stages_ms(mot, frames, staged)
        out['tail args'] = STAGE_ARGS.pop('tail')
        out['frame args'] = STAGE_ARGS.pop('frame')
        # the cascade and the finals through the plain versions beside
        solver_ms, syncs, out['assoc rounds'] = solver_stages_ms(
            *out['assoc args'])
        for name in ('cascade', 'finals'):
            out['assoc stages'][f'{name}, plain'] = solver_ms[f'{name}, plain']
            out['assoc syncs'][f'{name}, plain'] = syncs[f'{name}, plain']
    return out


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


def profiled_kernels(fn, iters=10, tries=5, expect=None):
    """``fn``'s device work a call as ``torch.profiler`` traces it over
    ``iters`` calls: (kernels launched, their summed device ms), each a
    call, and the kernels' names. The profiler sometimes returns a trace
    with fewer device events than were launched, or none: a trace without
    ``expect`` kernels a call (without any, if ``expect`` is None) is
    taken again, up to ``tries`` traces, and the last is returned."""
    from torch.profiler import ProfilerActivity, profile
    fn()
    torch.cuda.synchronize()
    for _ in range(tries):
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            for _ in range(iters):
                fn()
            torch.cuda.synchronize()
        kernels = [e for e in prof.events()
                   if str(getattr(e, 'device_type', '')).endswith('CUDA')]
        if len(kernels) == expect * iters if expect else kernels:
            break
    us = sum(e.time_range.end - e.time_range.start for e in kernels)
    return len(kernels) / iters, us / iters / 1e3, {e.name for e in kernels}


def dispatched_ops(fn):
    """The names of the torch ops that ``fn`` dispatches (a
    ``TorchDispatchMode`` log): ops that only allocate or view launch no
    kernel."""
    from torch.utils._python_dispatch import TorchDispatchMode
    seen = set()

    class Log(TorchDispatchMode):
        def __torch_dispatch__(self, func, types, args=(), kwargs=None):
            seen.add(func.overloadpacket.__name__)
            return func(*args, **(kwargs or {}))
    with Log():
        fn()
    return seen


def ssd_stages_ms(det, frame, crowded, post=None):
    """The SSD detector's stages alone on the card: the tiling preprocess,
    the net, ``decode_ssd``, the postprocess on the run's own decoded rows
    and on ``crowded`` ((det_out, tiles, scale, label_mask) on the card,
    e.g. tests/test_torch_ssd_post.py's ``crowded_rows``), and the whole
    ``det.run``. For each: its ms a call between CUDA events (the median of
    20 after warm-up), the host's ms a call (no sync) and, from
    ``torch.profiler``, its kernels a call and their device ms. ``post``:
    the postprocess to run (by default the detector's; the whole run takes
    it too)."""
    from fastmot_tpu_torch.models.ssd import decode_ssd
    post = post or det._postprocess_device
    x = det.preprocess(frame)
    locs, confs = det.module(x)
    det_out = decode_ssd(locs, confs, det._anchors, det.model.TOPK)
    scalars = (det.conf_thresh, det.max_area, det.merge_thresh,
               det.model.NMS_THRESH)

    def run():
        with mock.patch.object(det, '_postprocess_device', post):
            return det.run(frame)
    stages = {
        'tiling preprocess': lambda: det.preprocess(frame),
        'net': lambda: det.module(x),
        'decode_ssd': lambda: decode_ssd(locs, confs, det._anchors,
                                         det.model.TOPK),
        f'postprocess, the run\'s rows {tuple(det_out.shape)}':
            lambda: post(det_out, det._tiles_f, det._scale, det.label_mask,
                         *scalars),
        f'postprocess, crowded rows {tuple(crowded[0].shape)}':
            lambda: post(*crowded, *scalars),
        'whole run': run,
    }
    out = {}
    for name, fn in stages.items():
        launches, kernel_ms, _ = profiled_kernels(fn)
        out[name] = {'ms': cuda_ms(fn), 'host_ms': host_ms(fn),
                     'launches': launches, 'kernel_ms': kernel_ms}
    return out


def log_ssd_stages(tag, stages, card):
    for name, s in stages.items():
        log(f'{tag} {name}: {s["ms"]:.4f} ms a call (CUDA events), host '
            f'{s["host_ms"]:.4f} ms; {s["launches"]:.0f} kernels a call, '
            f'{s["kernel_ms"]:.4f} ms of their device time; {card}')


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


def phase_multi_stream(single_ms, frames, dets, card, n_streams=N_STREAMS):
    """``MultiStreamMOT`` at 8 streams of 1280x720 with cfg/mot.json's
    detector, extractor, skip and tracker (bench.py config 5). Returns the
    OSBlock and LK launches, every stream's final rows, the step median,
    the gap frame alone, and phase 17's 8-stream gap-commit arguments,
    phase 18's preprocess and point-assembly arguments, phase 19's
    association arguments (after the cascade and the finals alone at 8
    streams, through the kernels and the plain versions) and phase 20's
    NMS and commit arguments."""
    from fastmot_tpu_torch.detector import MAX_DETS
    from fastmot_tpu_torch.tracker import assoc_costs_batch, finals_core
    from fastmot_tpu_torch.multichip import run_multi_stream
    from fastmot_tpu_torch.ops import geometry as geom
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops.osnet_block import osblock
    from fastmot_tpu_torch.parallel import MultiStreamMOT

    mot = MultiStreamMOT(n_streams=n_streams, device='cuda',
                         **multi_stream_kwargs())
    skip = mot.detector_frame_skip
    n_frames = len(frames)
    det = mot.detector
    real_dev = det.postprocess_device_batch

    osblock.launches = 0
    reset_lk()
    (rows,), step_ms = run_multi_stream(mot, frames, dets)
    launches, lk, gap_n = osblock.launches, lk_counts(), gap_launches()
    flow_n, assoc_n, tail_n = flow_counts(), assoc_counts(), tail_counts()
    frame_n = frame_counts()
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
        f'frames {n_assoc}, osblock launches {launches}, lk_pyramidal '
        f'launches {lk}, gap_commit launches {gap_n}, preprocess and '
        f'gap_points launches {flow_n}, cascade_auction, greedy_match and '
        f'greedy_finals launches {assoc_n}, greedy_suppress, merge_labels '
        f'and assoc_commit launches {tail_n}, nms_select, assoc_costs and '
        f'reid_crops launches {frame_n}')
    expect_assoc('multi-stream', assoc_n, n_assoc)
    # frame 0's detector run, then one an association frame
    expect_tail('multi-stream', tail_n, 0, n_assoc)
    expect_frame('multi-stream', frame_n, n_assoc + 1, n_assoc, n_assoc)
    expect_lk('multi-stream', lk, n_frames - 1)
    expect_gap('multi-stream', gap_n, n_frames - 1)
    expect_flow('multi-stream', flow_n, n_frames, n_frames - 1)
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
    stage_ms = {name: wall_ms(fn, n=3, warmup=1)
                for name, fn in stages.items()}
    log('multi-stream stages alone, ms: ' + '; '.join(
        f'{name} {ms:.3f}' for name, ms in stage_ms.items()))
    gap8_args, flow8_args = gap_commit_args_at(mot.stream_tracker, last,
                                               fk.MAX_FLOW_TRACKS)
    # the association's solvers alone at 8 streams, through the kernels and
    # the plain versions
    st = mot.stream_tracker
    if st._dirty:
        st._stack_from_mirrors()
    t0 = st.trackers[0]
    costs = assoc_costs_batch(t0._assoc_params(), st._dev_state,
                              st._hist_store, det_b, emb[0])
    assoc8_args = assoc_solver_args(t0, (costs, st._dev_state), det_b,
                                    (t0.max_age + 2) // 2)
    solver_ms, syncs, rounds = solver_stages_ms(*assoc8_args)
    log_assoc_stages(f'multi-stream ({n_streams} streams)', solver_ms,
                     syncs, rounds, card)
    # phase 20's 8-stream arguments: the batched detector's waves (from its
    # plain postprocess, where the card runs the whole of it in the
    # nms_select kernels), and the commit of the association above;
    # phase 21's: the postprocess, the costs, the crops and a whole
    # association frame
    from fastmot_tpu_torch import detector as detmod
    nms8, real_nms = [], detmod.nms_and_gate
    with mock.patch.object(detmod, 'nms_and_gate', lambda *a: (
            nms8.append(a), real_nms(*a))[1]):
        det.detect_async(last)
        real_dev()
    suppress8, real_suppress = [], geom.greedy_suppress
    with mock.patch.object(geom, 'greedy_suppress', lambda *a: (
            suppress8.append(a), real_suppress(*a))[1]):
        unpatched(detmod, 'nms_and_gate_reference')(*nms8[0])

    def whole8():
        det.detect_async(last)
        real_dev()
        embed()
        mot.stream_tracker.update_device(n_frames, det_b, emb[0])
    STAGE_ARGS['frame8'] = {
        'nms': nms8[0], 'crops': (last, det_b[0], ext.out_hw),
        'costs': (t0._assoc_params(), st._dev_state, st._hist_store, det_b,
                  emb[0], None),
        'whole': whole8}
    finals_args = assoc8_args[2]
    cascade_out = (costs[3], finals_args[-1]) + finals_core(*finals_args)
    tail8_args = {'suppress': suppress8[0], 'commit': (
        st.kf_cfg, t0.confirm_hits, t0.max_age, t0.history_size,
        st._dev_state, st._hist_store, det_b, emb[0], n_frames,
        t0._frame_rect_dev, cascade_out)}
    return launches, lk, rows, statistics.median(step_ms), \
        stage_ms['gap frame (preprocess, points, LK, RANSAC, Kalman)'], \
        gap8_args, flow8_args, assoc8_args, tail8_args


def gap_commit_args_at(st, frames, f_cap):
    """The gap commit's arguments of ``st``'s next gap frame (``frames``
    staged on the card) at flow budget ``f_cap``, as ``StreamTracker.track``
    makes them: phase 17's 8-stream case; and the preprocess's and point
    assembly's (phase 18's)."""
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops import gap_points as gp
    if st._dirty:
        st._stack_from_mirrors()
    t0 = st.trackers[0]
    spec, prev = t0.flow.spec, st._prev_pre
    cur = st._preprocess(frames)
    all_prev, all_valid, inside, forder, f_tlbrs, f_valid = gp.gap_points(
        spec, st._dev_state, prev, f_cap)
    all_cur, status = fk.lk_core(spec, prev[1], cur[1], all_prev, all_valid)
    return (st.kf_cfg, spec, float(t0.age_penalty), t0.confirm_hits,
            st._dev_state, inside, f_tlbrs, f_valid, forder, all_prev,
            all_cur, status, list(st._seeds), t0._trans_mat, t0._acc_cov,
            t0._frame_rect_dev), (spec, frames, st._dev_state, prev, f_cap)


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
    OSBlock launches of (a) and (b) and the LK launches of (a)-(c)."""
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
            reset_lk()
            (rows,), step_ms = multichip.run_multi_stream(mot, frames, dets)
            launches, lk = osblock.launches, lk_counts()
            gap_n, flow_n = gap_launches(), flow_counts()
            assoc_n, tail_n = assoc_counts(), tail_counts()
            frame_n = frame_counts()
        finally:
            dist.destroy_process_group()
    del mot
    torch.cuda.empty_cache()
    worst = _same_streams('mesh (a) 1 NCCL rank', rows, want_rows)
    log(f'mesh (a) 1 NCCL rank, 8 streams: rows == phase 13 on every '
        f'stream (boxes within {worst} px), osblock launches {launches}, '
        f'lk_pyramidal launches {lk}, gap_commit launches {gap_n}; step ms '
        f'median '
        f"{statistics.median(step_ms):.3f} against phase 13's "
        f'{single_multi_ms:.3f}')
    if launches != 6 * n_assoc:
        raise AssertionError(f'mesh (a): osblock launched {launches} times, '
                             f'expected {6 * n_assoc}')
    expect_lk('mesh (a)', lk, len(frames) - 1)
    expect_gap('mesh (a)', gap_n, len(frames) - 1)
    expect_flow('mesh (a)', flow_n, len(frames), len(frames) - 1)
    expect_assoc('mesh (a)', assoc_n, n_assoc)
    expect_tail('mesh (a)', tail_n, 0, n_assoc)
    expect_frame('mesh (a)', frame_n, n_assoc + 1, n_assoc, n_assoc)

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
        expect_lk(f'mesh (b) rank {r}', out['lk_launches'], len(frames) - 1)
        expect_gap(f'mesh (b) rank {r}', out['gap_commit_launches'],
                   len(frames) - 1)
        expect_flow(f'mesh (b) rank {r}', (out['preprocess_launches'],
                                           out['gap_points_launches']),
                    len(frames), len(frames) - 1)
        expect_assoc(f'mesh (b) rank {r}', out['assoc_launches'], n_assoc)
        expect_tail(f'mesh (b) rank {r}', out['tail_launches'], 0,
                    n_assoc)
        expect_frame(f'mesh (b) rank {r}', out['frame_launches'],
                     n_assoc + 1, n_assoc, n_assoc)
    worst = _same_streams('mesh (b) 2 gloo ranks', rows_b, want_rows)
    log(f'mesh (b) 2 gloo ranks on one card, streams '
        f'{[o["local_streams"] for o in ranks]}: rows == phase 13 on every '
        f'stream (boxes within {worst} px), osblock launches '
        f'{[o["osblock_launches"] for o in ranks]}, lk_pyramidal launches '
        f'{[o["lk_launches"] for o in ranks]}, gap_commit launches '
        f'{[o["gap_commit_launches"] for o in ranks]}; step ms medians '
        f'{[round(statistics.median(o["step_ms"]), 3) for o in ranks]}; '
        f'{time.perf_counter() - t_b:.1f} s, spawn and build included')

    t0 = time.perf_counter()
    dry = multichip.dryrun_multichip(1, device='cuda')
    expect_lk('mesh (c)', dry[0]['lk_launches'], 1)
    expect_gap('mesh (c)', dry[0]['gap_commit_launches'], 1)
    # the dryrun's one gap step preprocesses its two frames
    expect_flow('mesh (c)', (dry[0]['preprocess_launches'],
                             dry[0]['gap_points_launches']), 2, 1)
    expect_assoc('mesh (c)', dry[0]['assoc_launches'], 1)
    # the dryrun's association commits; its detector runs no NMS
    expect_tail('mesh (c)', dry[0]['tail_launches'], 0, 1)
    # its costs; its embeddings are made up, its detector runs no NMS
    expect_frame('mesh (c)', dry[0]['frame_launches'], 0, 1, 0)
    log(f'mesh (c) dryrun_multichip(1) over NCCL: '
        f'{time.perf_counter() - t0:.1f} s, spawn and build included, '
        f'lk_pyramidal launches {dry[0]["lk_launches"]}, gap_commit '
        f'launches {dry[0]["gap_commit_launches"]}; phase 14 '
        f'{time.perf_counter() - t_phase:.1f} s')
    lk = Counter(lk)
    for counts in [o['lk_launches'] for o in ranks] + [dry[0]['lk_launches']]:
        lk.update(counts)
    return launches + sum(o['osblock_launches'] for o in ranks), lk


def threefry_numpy(key, x1, x2):
    """Threefry-2x32 on numpy uint32 (the host reference of phase 15)."""
    rot = ((13, 15, 26, 6), (17, 29, 16, 24))
    k = (np.uint32(key[0]), np.uint32(key[1]))
    ks = (k[0], k[1], k[0] ^ k[1] ^ np.uint32(0x1BD11BDA))
    x1 = np.asarray(x1, np.uint32) + ks[0]
    x2 = np.asarray(x2, np.uint32) + ks[1]
    for i in range(5):
        for r in rot[i % 2]:
            x1 = x1 + x2
            x2 = x1 ^ ((x2 << np.uint32(r)) | (x2 >> np.uint32(32 - r)))
        x1 = x1 + ks[(i + 1) % 3]
        x2 = x2 + ks[(i + 2) % 3] + np.uint32(i + 1)
    return x1, x2


def draws_numpy(seed, f_cap):
    """``jax.random``'s RANSAC uniforms of ``flow_post_core`` for a seed:
    ``PRNGKey``, ``fold_in``, ``split`` and ``uniform`` over
    ``threefry_numpy``."""
    def fold(key, d):
        return tuple(int(v[0]) for v in threefry_numpy(key, [0], [d]))

    def uniform(key, n):
        b1, b2 = threefry_numpy(key, np.zeros(n), np.arange(n))
        bits = ((b1 ^ b2) >> np.uint32(9)) | np.uint32(0x3F800000)
        return bits.view(np.float32) - np.float32(1.0)
    key = (0, seed & 0xFFFFFFFF)
    u_h = uniform(fold(key, 0), 256 * 4).reshape(256, 4)
    k1 = fold(key, 1)
    s1, s2 = threefry_numpy(k1, np.zeros(f_cap), np.arange(f_cap))
    u_a = np.stack([uniform((a, b), 64 * 2).reshape(64, 2)
                    for a, b in zip(s1, s2)])
    return u_h, u_a


def generator_draws(seeds, f_cap, device):
    """The RANSAC uniforms as the port drew them before they were JAX's: a
    CPU ``torch.Generator`` per seed, moved to ``device`` (timed in phase
    15 against ``ransac_draws_batch``)."""
    hs, as_ = [], []
    for seed in seeds:
        g = torch.Generator().manual_seed(int(seed))
        hs.append(torch.rand((256, 4), generator=g))
        as_.append(torch.rand((f_cap, 64, 2), generator=g))
    return torch.stack(hs).to(device), torch.stack(as_).to(device)


def conv_slice_differences(module, x):
    """Phase 15 (c)'s cause: ``module`` (on the card) on ``x`` twice, and
    each bf16 conv with even output channels recomputed for each half of
    them, against the whole conv's output sliced. Returns (the two runs
    bit-equal, half-convs compared, half-convs that differ, outputs that
    differ, outputs compared, largest relative difference)."""
    import torch.nn.functional as F
    from fastmot_tpu_torch import multichip
    from fastmot_tpu_torch.models.layers import Conv, nchw, nhwc, pad_same
    seen = []
    hooks = [m.register_forward_hook(
        lambda m, i, o: seen.append((m, i[0], o)))
        for m in module.modules()
        if isinstance(m, Conv) and m.dtype == torch.bfloat16
        and m.groups == 1 and m.weight.shape[0] % 2 == 0]
    first = multichip.zoo_outputs(module, x)
    for h in hooks:
        h.remove()
    same = all(np.array_equal(a, b) for a, b in
               zip(first, multichip.zoo_outputs(module, x)))
    n_diff = outs = n_out = 0
    worst = 0.0
    with torch.no_grad():
        for m, xin, whole in seen:
            if m.padding == 'SAME':
                xin = pad_same(xin, m.k, m.stride)
            half = m.weight.shape[0] // 2
            for part in (slice(0, half), slice(half, 2 * half)):
                y = nhwc(F.conv2d(nchw(xin.to(m.dtype)),
                                  m.weight[part].to(m.dtype),
                                  stride=m.stride))
                if m.bias is not None:
                    y = y + m.bias[part].to(y.dtype)
                ref = whole[..., part]
                d = int((y != ref).sum())
                n_diff += d > 0
                outs += d
                n_out += ref.numel()
                if d:
                    worst = max(worst, rel_err(y, ref)[0])
    return same, 2 * len(seen), n_diff, outs, n_out, worst


def phase_gaps(multi_rows, gap_ms, n_streams=N_STREAMS):
    """Phase 15 (a)-(d); ``gap_ms``: phase 13's gap frame alone. Returns
    the OSBlock launches of (b)'s ranks."""
    from fastmot_tpu_torch import feature_extractor as fe
    from fastmot_tpu_torch import multichip
    from fastmot_tpu_torch.feature_extractor import FeatureExtractor
    from fastmot_tpu_torch.ops import flow_kernels as fk

    # (a) the draws, and phase 13's rows that were made with them
    t0 = time.perf_counter()
    seeds = sorted(JAX_DRAW_BITS) + [1, 2 ** 31 + 5]
    u_h, u_a = fk.ransac_draws_batch(seeds, 16, 'cuda')
    for s, seed in enumerate(seeds):
        want_h, want_a = draws_numpy(seed, 16)
        got_h = u_h[s].cpu().numpy().view(np.int32)
        got_a = u_a[s].cpu().numpy().view(np.int32)
        if not (np.array_equal(got_h, want_h.view(np.int32))
                and np.array_equal(got_a, want_a.view(np.int32))):
            raise AssertionError(f'ransac_draws({seed}) differs from the '
                                 'threefry reference')
        if seed in JAX_DRAW_BITS and (
                int(got_h[0, 0]), int(got_h[-1, -1]), int(got_a[0, 0, 0]),
                int(got_a[-1, -1, -1])) != JAX_DRAW_BITS[seed]:
            raise AssertionError(f'ransac_draws({seed}) differs from '
                                 'jax.random')
    ids = {s: [r[0] for r in multi_rows[s]] for s in range(n_streams)}
    if not all(ids.values()) or any(len(set(v)) != len(v)
                                    for v in ids.values()):
        raise AssertionError(f'phase 13 track IDs: {ids}')
    log(f'gaps (a) ransac_draws on the card == threefry reference and '
        f'jax.random bits for seeds {seeds}; phase 13 tracks per stream '
        f'{[len(v) for v in ids.values()]}, IDs unique')
    # the draws' host time, upload and sync included, at phase 13's flow
    # budget and at the largest, against the torch.Generator draw
    budget = fk.flow_budget(max(len(v) for v in ids.values()))
    for f_cap in sorted({budget, fk.MAX_FLOW_TRACKS}):
        ms = [wall_ms(lambda: draw(range(n_streams), f_cap, 'cuda'), n=30,
                      warmup=3)
              for draw in (fk.ransac_draws_batch, generator_draws)]
        log(f'gaps (a) draws for {n_streams} streams x {f_cap} tracks: '
            f'ransac_draws_batch {ms[0]:.3f} ms, torch.Generator '
            f'{ms[1]:.3f} ms; phase 13 gap frame alone {gap_ms:.3f} ms '
            f'(draws {100 * ms[0] / gap_ms:.2f} % of it)')
    log(f'gaps (a): {time.perf_counter() - t0:.1f} s')

    # (b), (c) 'model' sharding on two gloo ranks sharing the card, both
    # models in one spawn
    t0 = time.perf_counter()
    cases = (('(b)', 'OSNet025', (BATCH, 256, 128, 3),
              (MAX_REL, MEAN_REL, DIFFER)),
             ('(c)', 'SSDInceptionV2', (8, 300, 300, 3),
              (SHARD_MAX_REL, SHARD_MEAN_REL, 1.0)))
    xs = [np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
          for _, _, shape, _ in cases]
    wants, unsharded_ms = [], []
    for (_, name, _, _), x in zip(cases, xs):
        module = multichip.zoo_module(name, 1, True).cuda()
        wants.append(multichip.zoo_outputs(module, x))
        unsharded_ms.append(wall_ms(
            lambda: multichip.zoo_outputs(module, x), n=3, warmup=1))
        if name == 'SSDInceptionV2':
            cause = conv_slice_differences(module, x)
        del module
        torch.cuda.empty_cache()
    runs = multichip.run_ranks(2, multichip.each_run, (
        multichip.sharded_heads_rank,
        [(name, x, 2, 1, True, False, 'cuda')
         for (_, name, _, _), x in zip(cases, xs)]), backend='gloo')
    launches = 0
    for i, ((tag, name, shape, bounds), want, ms) in enumerate(
            zip(cases, wants, unsharded_ms)):
        ranks = [run[i] for run in runs]
        for r, out in enumerate(ranks):
            max_rel = mean_rel = differ = 0.0
            for g, w in zip(out['heads'], want):
                errs = rel_err(torch.from_numpy(g), torch.from_numpy(w))
                max_rel = max(max_rel, errs[0])
                mean_rel = max(mean_rel, errs[1])
                differ = max(differ, float(np.mean(g != w)))
            if not (max_rel < bounds[0] and mean_rel < bounds[1]
                    and differ <= bounds[2]):
                raise AssertionError(
                    f'gaps {tag} {name} rank {r}: sharded vs unsharded '
                    f'{max_rel} / {mean_rel} / {differ}')
            log(f'gaps {tag} {name} {list(shape)} 2 ways over model, rank '
                f'{r}: {len(out["plan"])} sharded leaves, max-rel '
                f'{max_rel:.2e} mean-rel {mean_rel:.2e} differing '
                f'{differ:.5f}; sharded forward {out["ms"]:.3f} ms, '
                f'osblock launches {out["osblock_launches"]}')
        if name == 'OSNet025':
            per_rank = [o['osblock_launches'] for o in ranks]
            if per_rank != [6, 6]:
                raise AssertionError(f'gaps (b): osblock launches per rank '
                                     f'{per_rank}, expected 6 each')
            launches += sum(per_rank)
        log(f'gaps {tag} {name}: unsharded {ms:.3f} ms')
    same, n_half, n_diff, outs, n_out, worst = cause
    log(f'gaps (c) cause: unsharded SSDInceptionV2 twice bit-equal: {same}; '
        f'{n_diff} of {n_half} half-channel bf16 convs differ from the '
        f'whole conv sliced, {outs} of {n_out} outputs, max-rel '
        f'{worst:.2e}')
    if not same:
        raise AssertionError('gaps (c): the unsharded SSD run is not '
                             'deterministic')
    if n_diff == 0:
        raise AssertionError('gaps (c): sharded differs from unsharded, '
                             'but no half-channel conv differs')
    log(f'gaps (b) and (c): {time.perf_counter() - t0:.1f} s, spawn '
        'included')

    # (d) per-stream dynamic int8 ranges of the batched extractor
    t0 = time.perf_counter()
    with tempfile.TemporaryDirectory() as tmp:
        cache = Path(tmp) / 'dynamic.json'
        cache.write_text(json.dumps({'outputs': {}, 'inputs': {'*': 0.0}}))
        ext = FeatureExtractor('OSNet025', quantize='int8',
                               calib_cache=cache, device='cuda')
    base = textured_frames(SIZE, 1, seed=21)[0].astype(np.float32)
    frames = torch.as_tensor(np.stack([
        np.clip(base * g, 0, 255) for g in (0.25, 1.0, 0.55, 0.8)])
        .astype(np.uint8), device='cuda')
    tlbrs = torch.as_tensor(np.stack([synth_tlbrs(0, SIZE)[:16] + 3.0 * s
                                      for s in range(4)]), device='cuda',
                            dtype=torch.float32)
    valid = torch.ones(tlbrs.shape[:2], dtype=torch.bool, device='cuda')

    def batched():
        ext.extract_async_batch(frames, tlbrs, valid)
        return ext.postprocess_device().cpu().numpy()
    got = batched()
    # the control: every stream's crops under one range pooled over all
    # four streams (the batched path before per-stream ranges)
    real = fe.dynamic_ranges
    fe.dynamic_ranges = lambda groups=1, process_group=None: real(
        1, process_group)
    try:
        pooled = batched()
    finally:
        fe.dynamic_ranges = real
    worst = worst_pooled = 0.0
    for s in range(4):
        ext.extract_async_device(frames[s], tlbrs[s], valid[s])
        one = ext.postprocess_device().cpu().numpy()
        worst = max(worst, float(np.abs(got[s] - one).max()))
        worst_pooled = max(worst_pooled, float(np.abs(pooled[s] - one).max()))
    log(f'gaps (d) int8 dynamic, 4 streams x 16 crops: batched vs '
        f'per-stream extraction max-abs {worst:.3e} (bound '
        f'{INT8_STREAM_ATOL:.0e}); control with the ranges pooled over the '
        f'streams {worst_pooled:.3e}; {time.perf_counter() - t0:.1f} s')
    if not worst < INT8_STREAM_ATOL:
        raise AssertionError(f'gaps (d): batched int8 extraction is not '
                             f'the per-stream one: max-abs {worst}')
    if not worst_pooled >= INT8_STREAM_ATOL:
        raise AssertionError(f'gaps (d): pooled ranges pass the bound too '
                             f'(max-abs {worst_pooled}): the bound does not '
                             'tell them apart')
    return launches


def lk_inputs(n_streams, f_cap, seed=30):
    """Phase 16's inputs on the card: the main path's flow (cfg/mot.json's
    ``tracker_cfg.flow_cfg`` at 1280x720) over ``textured_frames``, each
    stream its own texture and its own drift (frame 0 to frame 2 + s),
    and f_cap x 32 + 256 points a stream over the flow-scale frame and 2
    px beyond it, 90 % valid. Returns (spec, previous levels, current
    levels, pts, valid, the drift of each stream at flow scale [S, 2])."""
    from fastmot_tpu_torch.flow import Flow
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.utils import ConfigDecoder
    with open(ROOT / 'cfg' / 'mot.json') as f:
        flow_cfg = json.load(f, cls=ConfigDecoder)['mot_cfg'][
            'tracker_cfg']['flow_cfg']
    spec = Flow(SIZE, **flow_cfg, device='cuda').spec
    pairs, drift = [], []
    for s in range(n_streams):
        k = 2 + s
        frames = textured_frames(SIZE, k + 1, seed=seed + s)
        pairs.append((frames[0], frames[k]))
        # textured_frames crops at (dx_i, dy_i): content moves by minus
        # the change of the crop
        d = [(int(8 + 8 * np.sin(2 * np.pi * i / 40)),
              int(8 + 8 * np.cos(4 * np.pi * i / 40))) for i in (0, k)]
        drift.append([-(d[1][0] - d[0][0]) * spec.opt_scale[0],
                      -(d[1][1] - d[0][1]) * spec.opt_scale[1]])
    prev, cur = (fk.preprocess(spec, torch.as_tensor(
        np.stack([p[i] for p in pairs]), device='cuda'))[1] for i in (0, 1))
    rng = np.random.default_rng(seed)
    n = f_cap * fk.KP_PER_TRACK + fk.BG_KP
    ow, oh = spec.opt_size
    pts = np.stack([rng.uniform(-2, ow + 2, (n_streams, n)),
                    rng.uniform(-2, oh + 2, (n_streams, n))], -1)
    valid = rng.uniform(size=(n_streams, n)) < 0.9
    return (spec, prev, cur,
            torch.as_tensor(pts, dtype=torch.float32, device='cuda'),
            torch.as_tensor(valid, device='cuda'), np.array(drift))


def lk_agreement(tag, got, want, all_close=True):
    """``got`` against ``want`` (new_pts, status, err) at the LK tolerance,
    its bound on the largest difference only with ``all_close``; returns
    (largest point difference where both track, share of points equal bit
    for bit in all three outputs)."""
    g_pts, g_ok, g_err = (t.cpu() for t in got)
    w_pts, w_ok, w_err = (t.cpu() for t in want)
    same = (g_ok == w_ok).float().mean().item()
    both = g_ok & w_ok
    diff = (g_pts[both] - w_pts[both]).abs().amax(-1)
    close = (diff < LK_CLOSE_PX).float().mean().item()
    worst = diff.max().item()
    bits = ((g_pts.view(torch.int32) == w_pts.view(torch.int32)).all(-1)
            & (g_ok == w_ok) & (g_err.view(torch.int32)
                                == w_err.view(torch.int32)))
    bits = bits.float().mean().item()
    log(f'lk {tag}: status equal on {same:.5f} of the points; on the '
        f'{int(both.sum())} tracked by both, {close:.5f} within '
        f'{LK_CLOSE_PX} px, max {worst:.3e} px; bit-equal {bits:.5f}')
    if not (same > LK_STATUS_SHARE and close > LK_CLOSE_SHARE
            and (worst < LK_MAX_PX or not all_close)
            and both.sum() > 0.5 * both.numel()):
        raise AssertionError(f'lk {tag}: outside the tolerance ({same}, '
                             f'{close}, {worst})')
    return worst, bits


def lk_sectors(level, sid, xy, lo, k, win):
    """The 32-byte sectors (global addresses // 32) of ``level`` [S, h, w]
    float32 that the k x k bilinear taps of rows and columns [lo, lo + k)
    of the halo around each point ``xy`` [N, 2] of stream ``sid`` [N]
    read, edge-clamped as ``_sample_halo`` clamps them."""
    h, w = level.shape[-2:]
    half = (win - 1) // 2
    x0 = torch.floor(torch.clamp(xy[:, 0], 0.0, w - 1.001)).long()
    y0 = torch.floor(torch.clamp(xy[:, 1], 0.0, h - 1.001)).long()
    rows = torch.clamp(y0[:, None] - half - 1 + lo
                       + torch.arange(k, device=xy.device), 0, h - 1)
    c_first = torch.clamp(x0 - half - 1 + lo, 0, w - 1)
    c_last = torch.clamp(x0 - half - 1 + lo + k - 1, 0, w - 1)
    row0 = level.data_ptr() + 4 * (sid[:, None] * h * w + rows * w)
    first = (row0 + 4 * c_first[:, None]) // 32
    last = (row0 + 4 * c_last[:, None]) // 32
    # a row of k taps spans at most k // 8 + 2 sectors: first, the ones
    # between, last
    spans = [torch.minimum(first + j, last) for j in range(k // 8 + 2)]
    return torch.cat([t.reshape(-1) for t in spans])


def lk_bound_ms(spec, prev, cur, valid, trace):
    """The least time an H100 could take for one LK call on these inputs,
    and what sets it: the bytes the function must move over 3.35 TB/s
    against its float32 operations over 67 TFLOP/s. Bytes: pts and valid
    read once, new_pts, status and err written once, and each distinct
    32-byte sector of the pyramids that the points' taps touch read once
    (the (win+3)^2 template halos in the previous levels, the (win+1)^2
    windows of every step these inputs take in the current ones, both
    from the plain version's ``trace`` on the same inputs). Operations,
    over the same steps: per template the (win+2)^2 bilinear samples (7
    each), the gradients, G's products and sums, the gate (7 (win+2)^2 +
    10 win^2 + 23); per step the win^2 samples, the difference, its
    absolute value and mean, two products and sums, the solve, clamp and
    test (14 win^2 + 28). Returns (bound, operations' time, bytes' time,
    steps, sectors' bytes)."""
    wi = spec.win
    n_pts = valid.numel()
    per_stream = valid.shape[-1]
    sid_all = torch.arange(n_pts, device=valid.device) // per_stream
    flat_valid = valid.reshape(-1)
    templates = int(flat_valid.sum()) * len(trace)
    sectors, n_steps = [], 0
    for lvl, p, trips in trace:
        sectors.append(lk_sectors(prev[lvl], sid_all[flat_valid],
                                  p[flat_valid], 0, wi + 3, wi))
        for xy, active in trips:
            n_steps += int(active.sum())
            sectors.append(lk_sectors(cur[lvl], sid_all[active], xy[active],
                                      1, wi + 1, wi))
    pyramid_bytes = 32 * torch.unique(torch.cat(sectors)).numel()
    nbytes = n_pts * (8 + 1 + 8 + 1 + 4) + pyramid_bytes
    ops = templates * (7 * (wi + 2) ** 2 + 10 * wi * wi + 23) + \
        n_steps * (14 * wi * wi + 28)
    ops_ms, bytes_ms = ops / PEAK_F32 * 1e3, nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), ops_ms, bytes_ms, n_steps, pyramid_bytes


def lk_device_ms(entry, args, n=LK_TIMED_LAUNCHES, reps=3, tag='lk',
                 tries=3):
    """Device time per launch of the C entry ``entry(*args)``: ``n``
    launches between two CUDA events, queued behind ``torch.cuda._sleep``
    so that the card runs them back to back whatever the host's enqueue
    rate; the median of ``reps`` windows. A window whose launches took the
    host longer to queue than the card slept is taken again behind twice
    the sleep, up to ``tries`` times (the host is shared and sometimes
    slow). Raises on a launch error, or if the host never queued the
    launches within the sleep."""
    if entry(*args):
        raise AssertionError(f'{tag}: launch failed')
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        for attempt in range(tries):
            s, a, b = (torch.cuda.Event(enable_timing=True)
                       for _ in range(3))
            s.record()
            torch.cuda._sleep(LK_SLEEP_CYCLES << attempt)
            a.record()
            t0 = time.perf_counter()
            codes = [entry(*args) for _ in range(n)]
            queued_ms = (time.perf_counter() - t0) * 1e3
            b.record()
            torch.cuda.synchronize()
            if any(codes):
                raise AssertionError(f'{tag}: launch failed ({set(codes)})')
            if queued_ms < s.elapsed_time(a):
                break
        else:
            raise AssertionError(f'{tag}: {n} launches took '
                                 f'{queued_ms:.3f} ms to queue, the sleep '
                                 f'{s.elapsed_time(a):.3f} ms')
        times.append(a.elapsed_time(b) / n)
    return statistics.median(times)


def host_ms(fn, n=20, reps=5):
    """Median over ``reps`` windows of ``n`` back-to-back calls of ``fn`` on
    the host clock, with no sync inside a window, per call: what the host
    spends on a call."""
    fn()
    torch.cuda.synchronize()
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) * 1e3 / n)
        torch.cuda.synchronize()
    return statistics.median(times)


def lk_bit_equal(tag, got, want):
    """Raises unless (new_pts, status, err) equal bit for bit."""
    for name, g, w in zip(('new_pts', 'status', 'err'), got, want):
        g, w = g.cpu(), w.cpu()
        if g.dtype == torch.float32:
            g, w = g.view(torch.int32), w.view(torch.int32)
        if not torch.equal(g, w):
            raise AssertionError(f'lk {tag}: {name} differs on '
                                 f'{int((g != w).sum())} entries')


def phase_lk(gap_stages, gap8_ms, card):
    """Both LK kernels against their plain version at LK_CASES and against
    each other, bit for bit, and the wrapper's pick (``lk_design``); the
    two timed in turns (device time; the wrapper's time per call and its
    host time around them) beside the bound and the SM clocks before and
    after; both on growing parts of the last case's points, across the
    pick's threshold; then the gap frame's stages (phases 6 and 13).
    Returns, by case, each kernel's mean device time, the case's pick,
    bound, plain time, error and wrapper times, and the tile width."""
    from fastmot_tpu_torch.ops import flow_kernels as fk
    log('lk: host CPU capability '
        f'{torch.backends.cpu.get_cpu_capability()}; the kernel sums in the '
        '8-lane order of ATen\'s x86 CPU sum, which it then equals bit for '
        'bit')
    lib = fk.lk_library()
    lanes, per_block = lib.lk_tile_lanes(), lib.lk_tile_points()
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    entries = {d: getattr(lib, e) for d, e in fk.LK_ENTRIES.items()}
    names = {'tile': f'tile kernel (G = {lanes})',
             'per_thread': 'one thread a point'}
    cases = {}
    for n_streams, f_cap in LK_CASES:
        clocks = [sm_clocks()]
        spec, prev, cur, pts, valid, drift = lk_inputs(n_streams, f_cap)
        n = valid.numel()
        tag = f'{n_streams} stream(s) x {pts.shape[1]} points'
        pick = fk.lk_design(n, sms)
        before = lk_counts()
        got = fk.lk_pyramidal(prev, cur, pts, valid, spec)
        again = fk.lk_pyramidal(prev, cur, pts, valid, spec)
        moved = {d: c - before[d] for d, c in lk_counts().items()}
        if moved != {d: 2 * (d == pick) for d in entries}:
            raise AssertionError(f'lk {tag}: launches moved by {moved}, '
                                 f'lk_design picks {pick}')
        each = {}
        for d, entry in entries.items():
            each[d], args = fk.lk_launch_args(prev, cur, pts, valid, spec)
            if entry(*args):
                raise AssertionError(f'lk {tag}: {names[d]} launch failed')
        torch.cuda.synchronize()
        log(f'lk {tag}: lk_design picks the {names[pick]} on the {sms} SMs '
            f'(one thread a point: {-(-n // fk.LK_PER_THREAD_BLOCK)} blocks '
            f'of {fk.LK_PER_THREAD_BLOCK}; tile kernel: {-(-n // per_block)} '
            f'blocks of {per_block} points, {per_block * lanes} threads)')
        lk_bit_equal(f'{tag}, two calls', got, again)
        for d, o in each.items():
            lk_bit_equal(f'{tag}, the pick vs the {names[d]}', got, o)
        if not (torch.isfinite(got[0]).all() and torch.isfinite(got[2]).all()
                and got[0].shape == pts.shape and got[1].shape == valid.shape):
            raise AssertionError(f'lk {tag}: outputs not finite or of the '
                                 'wrong shape')
        trace = []
        plain = fk.lk_pyramidal_reference(prev, cur, pts, valid, spec, trace)
        plain_cpu = fk.lk_pyramidal_reference(
            [t.cpu() for t in prev], [t.cpu() for t in cur], pts.cpu(),
            valid.cpu(), spec)
        worst, _ = lk_agreement(f'{tag}, kernel vs plain on the CPU', got,
                                plain_cpu)
        lk_bit_equal(f'{tag}, kernel vs plain on the CPU', got, plain_cpu)
        lk_agreement(f'{tag}, kernel vs plain on the card', got, plain,
                     all_close=False)
        lk_agreement(f'{tag}, control: plain on the card vs plain on the '
                     'CPU', plain, plain_cpu, all_close=False)
        moved = (got[0] - pts).cpu().numpy()
        ok = got[1].cpu().numpy()
        med = np.array([np.median(moved[s][ok[s]], 0)
                        for s in range(n_streams)])
        if not np.abs(med - drift).max() < 0.05:
            raise AssertionError(f'lk {tag}: median motion {med.tolist()}, '
                                 f'drift {drift.tolist()}')
        # the kernels' device times in turns, through their C entries; the
        # wrapper (which launches the pick) a call and its host time, before
        # and after them (the outputs stay referenced while the entries
        # write them)
        timed_out, args = fk.lk_launch_args(prev, cur, pts, valid, spec)

        def call():
            fk.lk_pyramidal(prev, cur, pts, valid, spec)
        times = {d: [] for d in entries}
        wrapper = {'call_ms': [launches_ms(call)], 'host_ms': [host_ms(call)]}
        for d in ('tile', 'per_thread', 'per_thread', 'tile'):
            times[d].append(lk_device_ms(entries[d], args))
        wrapper['call_ms'].append(launches_ms(call))
        wrapper['host_ms'].append(host_ms(call))
        clocks.append(sm_clocks())
        plain_ms = cuda_ms(lambda: fk.lk_pyramidal_reference(
            prev, cur, pts, valid, spec), n=5, warmup=1)
        bound, ops_ms, bytes_ms, n_steps, pyramid_bytes = lk_bound_ms(
            spec, prev, cur, valid, trace)
        most = sum(t.numel() * t.element_size() for t in prev + cur)
        by = 'bytes' if bytes_ms >= ops_ms else 'operations'
        mean = {d: statistics.mean(t) for d, t in times.items()}
        log(f'lk {tag}: drift recovered (median motion within 0.05 px of '
            f'{drift.tolist()[:2]}...); {n_steps} Gauss-Newton steps '
            f'({n_steps / max(int(valid.sum()), 1):.2f} a valid point); '
            f'bound {bound * 1e3:.3f} us ({by}; operations '
            f'{ops_ms * 1e3:.3f} us, bytes {bytes_ms * 1e3:.3f} us, of which '
            f'the pyramid sectors the taps touch {pyramid_bytes} B of the '
            f'pyramids\' {most} B); plain {plain_ms:.3f} ms; {card}')

        def us(v):
            return ' / '.join(f'{x * 1e3:.2f}' for x in v)
        for d, t in times.items():
            log(f'lk {tag}, {names[d]}{" (the pick)" if d == pick else ""}: '
                f'device {us(t)} us a launch (two turns, '
                f'{LK_TIMED_LAUNCHES} launches each), roofline share '
                f'{bound / mean[d]:.4f}; {card}')
        log(f'lk {tag}, the wrapper (launching the {names[pick]}), before '
            f'and after the turns: {us(wrapper["call_ms"])} us a call (20 '
            f'between CUDA events), host {us(wrapper["host_ms"])} us a call '
            f'(host clock, no sync); {card}')
        if n_streams == 1:
            # what a step costs: the step cap at 1 against its full value
            capped = args[:12] + (1,) + args[13:]
            for d in entries:
                one, full = lk_device_ms(entries[d], capped), mean[d]
                step = (full - one) / (spec.iters - 1)
                log(f'lk {tag}, {names[d]}: device {one * 1e3:.2f} us a '
                    f'launch at a step cap of 1 against {full * 1e3:.2f} at '
                    f'{spec.iters}: {step * 1e3:.3f} us a unit of the cap; '
                    f'{card}')
        log(f'lk {tag}: SM clock, max before and after the turns: '
            f'{clocks[0]}; {clocks[1]}')
        key = f'{n_streams}_stream' + ('s' if n_streams > 1 else '')
        cases[key] = {'pick': pick, 'max_abs_err': worst,
                      'plain_ms': plain_ms, 'bound_ms': bound,
                      'bound_by': by, 'ms': mean,
                      **{m: statistics.mean(v) for m, v in wrapper.items()}}
    lk_threshold_sweep(spec, prev, cur, pts, valid, entries, names, sms,
                       card)
    log('lk gap frame, 1 stream (phase 6, flow budget '
        f'{gap_stages["flow budget"]}), each stage alone, synchronised, ms: '
        + '; '.join(f'{k} {v:.3f}' for k, v in gap_stages.items()
                    if k != 'flow budget')
        + f' (with the plain LK loop: LK {PLAIN_LK_MS} ms of a gap frame); '
        + card)
    log(f'lk gap frame at {N_STREAMS} streams alone (phase 13): '
        f'{gap8_ms:.3f} ms (with the plain LK loop: {PLAIN_GAP8_MS} ms); '
        f'{card}')
    return cases, lanes


def lk_threshold_sweep(spec, prev, cur, pts, valid, entries, names, sms,
                       card):
    """Both LK kernels' device times on the first LK_SWEEP_STEP, 2
    LK_SWEEP_STEP, ... points of every stream of one case, in turns (tile,
    one thread, one thread, tile): both sides of ``lk_design``'s
    threshold, with its pick and the faster beside them; the two kernels'
    outputs bit-equal at every size."""
    from fastmot_tpu_torch.ops import flow_kernels as fk
    n_streams, n_points = pts.shape[:2]
    for p in range(LK_SWEEP_STEP, n_points + 1, LK_SWEEP_STEP):
        sub = (prev, cur, pts[:, :p].contiguous(),
               valid[:, :p].contiguous(), spec)
        n = n_streams * p
        launch = {d: fk.lk_launch_args(*sub) for d in entries}
        times = {d: [] for d in entries}
        for d in ('tile', 'per_thread', 'per_thread', 'tile'):
            times[d].append(lk_device_ms(entries[d], launch[d][1]))
        lk_bit_equal(f'sweep, {n} points', launch['tile'][0],
                     launch['per_thread'][0])
        mean = {d: statistics.mean(t) for d, t in times.items()}
        log(f'lk sweep, {n_streams} x {p} = {n} points '
            f'({-(-n // fk.LK_PER_THREAD_BLOCK)} blocks of one thread a '
            f'point on the {sms} SMs): '
            + '; '.join(f'{names[d]} ' + ' / '.join(f'{x * 1e3:.2f}'
                                                   for x in t)
                        for d, t in times.items())
            + f' us a launch; lk_design picks the '
            f'{names[fk.lk_design(n, sms)]}, the faster is the '
            f'{names[min(mean, key=mean.get)]}; {card}')


def lk_kernel_entries(cases, launches, lanes):
    """The kernels line's entries of the two LK kernels. Each takes its
    unsuffixed times from the case whose pick it is (the main paths run it
    there; the wrapper's time a call and host time are that case's), and
    the other case's with the case's name as suffix."""
    out = []
    for design, name in (('tile', 'lk_pyramidal'),
                         ('per_thread', 'lk_pyramidal_per_thread')):
        own = next((c for c, r in cases.items() if r['pick'] == design),
                   next(iter(cases)))
        entry = {'name': name, 'route': 'cuda',
                 'source': 'fastmot_tpu_torch/csrc/lk_pyramidal.cu',
                 'replaces': 'fastmot_tpu/ops/flow_kernels.py:313',
                 'launches': launches[design],
                 'max_abs_err': max(r['max_abs_err'] for r in cases.values()),
                 'library_ms': None, 'case': own}
        if design == 'tile':
            entry['tile_lanes'] = lanes
        for case, r in cases.items():
            key = '' if case == own else f'_{case}'
            if r['pick'] == design:      # the wrapper launched this kernel
                entry.update({f'call_ms{key}': r['call_ms'],
                              f'host_ms{key}': r['host_ms']})
            entry.update({
                f'ms{key}': r['ms'][design],
                f'plain_ms{key}': r['plain_ms'],
                f'bound_ms{key}': r['bound_ms'],
                f'bound_by{key}': r['bound_by'],
                f'roofline_share{key}': r['bound_ms'] / r['ms'][design]})
        out.append(entry)
    return out


def gap_agreement(tag, args, got, want, check=True):
    """The gap commit's outputs ``got`` against a plain run's ``want`` on
    the inputs ``args`` ([S, ...]): the share of the valid track slots
    whose booleans (valid, lost_pending, lost, has_klt, the estimate's
    validity) differ, at most GAP_BOOL_SHARE; on the streams whose h_ok and
    background inliers agree, H within GAP_H_PX at the frame's corners,
    and on their slots whose booleans agree the estimates equal, the
    inlier ratios within GAP_RATIO, the means within GAP_MEAN_PX and the
    covariances within GAP_COV_REL of the track's largest entry. Raises
    (with ``check``) or prints. Returns the largest mean and H differences
    (px) over the compared slots and streams."""
    from tests.test_torch_gap_commit import unpack
    (g_st, g_info), (w_st, w_info) = (
        ([a.cpu().numpy() for a in r[0]], r[1].cpu().numpy())
        for r in (got, want))
    spec = args[1]
    n_s, n_t = w_st[0].shape[:2]
    n_bg = args[9].shape[1] - args[6].shape[1] * 32
    valid_in = args[4][3].cpu().numpy()
    w_f, h_f = spec.size
    corners = np.array([[0, 0, 1], [w_f - 1, 0, 1], [0, h_f - 1, 1],
                        [w_f - 1, h_f - 1, 1]], np.float64)
    differ, same_streams, faults = 0, 0, []
    worst_mean = worst_h = 0.0
    for s in range(n_s):
        g, w = unpack(g_info[s], n_bg, n_t), unpack(w_info[s], n_bg, n_t)
        bools = [(g_st[i][s], w_st[i][s]) for i in (3, 9)] + [
            (g[k] > 0.5, w[k] > 0.5) for k in ('lost', 'has_klt', 'est_ok')]
        slot_differs = np.zeros(n_t, bool)
        for a, b in bools:
            slot_differs |= a != b
        stream_same = g['h_ok'][0] == w['h_ok'][0] and np.array_equal(
            g['bg_inlier'], w['bg_inlier'])
        if g['h_ok'][0] != w['h_ok'][0]:
            slot_differs |= True
        differ += int((slot_differs & valid_in[s]).sum())
        if not stream_same:
            continue
        same_streams += 1
        if w['h_ok'][0] > 0.5:
            proj = [corners @ x['h_mat'].astype(np.float64).reshape(3, 3).T
                    for x in (g, w)]
            d = float(np.abs(proj[0][:, :2] / proj[0][:, 2:]
                             - proj[1][:, :2] / proj[1][:, 2:]).max())
            worst_h = max(worst_h, d)
            if d > GAP_H_PX:
                faults.append(f'stream {s}: H {d:.3g} px off at a corner')
        ok = ~slot_differs
        d = float(np.abs(g_st[0][s][ok] - w_st[0][s][ok]).max(initial=0.0))
        worst_mean = max(worst_mean, d)
        scale = np.abs(w_st[1][s][ok]).max(axis=(1, 2), keepdims=True)
        cov = float((np.abs(g_st[1][s][ok] - w_st[1][s][ok])
                     / np.maximum(scale, 1e-30)).max(initial=0.0))
        est = g['klt_tlbrs'].reshape(-1, 4)[ok & (w['est_ok'] > 0.5)]
        est_w = w['klt_tlbrs'].reshape(-1, 4)[ok & (w['est_ok'] > 0.5)]
        ratio = float(np.abs(g['new_inl'] - w['new_inl'])[ok].max(
            initial=0.0))
        if d > GAP_MEAN_PX or cov > GAP_COV_REL or ratio > GAP_RATIO \
                or not np.array_equal(est, est_w):
            faults.append(f'stream {s}: means {d:.3g} px, covariances '
                          f'{cov:.3g} relative, inlier ratios {ratio:.3g}, '
                          f'estimates equal {np.array_equal(est, est_w)}')
    n_valid = int(valid_in.sum())
    share = differ / max(n_valid, 1)
    log(f'gap_commit {tag}: booleans differ on {differ} of {n_valid} valid '
        f'track slots ({share:.4f}); {same_streams} of {n_s} streams with '
        f'equal h_ok and background inliers: H up to {worst_h:.3g} px at '
        f'the corners, means up to {worst_mean:.3g} px'
        + (f'; {"; ".join(faults)}' if faults else ''))
    if check and (share > GAP_BOOL_SHARE or faults):
        raise AssertionError(f'gap_commit {tag}: share {share:.4f}, '
                             f'{faults}')
    return worst_mean, worst_h


def gap_commit_bound_ms(args, result):
    """The least time the card could take for one gap commit on ``args``
    with this run's data (``result`` gives the inliers and the updated
    tracks): the inputs read once and the outputs written once over the
    memory rate, and the float32 operations (a product, sum, quotient or
    root each) over the f32 rate and the draws' 32-bit integer operations
    over PEAK_I32, counted for what the data needs: the homography's 256
    hypotheses on the valid background points and two refits on its
    inliers, the similarity fits of the valid flow tracks, the Kalman warp
    and predict of the valid slots and the update of those with an
    estimate. Returns (bound, bound_by, ops_ms, bytes_ms)."""
    from tests.test_torch_gap_commit import unpack
    states, infos = result
    n_s, n_t = args[4][0].shape[:2]
    f_cap, n_points = args[6].shape[1], args[9].shape[1]
    n_bg = n_points - f_cap * 32
    nbytes = sum(t.numel() * t.element_size()
                 for t in (*(args[4][i] for i in (0, 1, 2, 3, 4, 5, 9, 10,
                                                  11, 12)),
                           *args[5:12], args[13], args[14], args[15]))
    nbytes += sum(states[i].numel() * states[i].element_size()
                  for i in (0, 1, 2, 3, 9, 10, 11, 12))
    nbytes += infos.numel() * infos.element_size()
    status = args[11].cpu().numpy()
    f_valid = args[7].cpu().numpy()
    valid = args[4][3].cpu().numpy()
    info = infos.cpu().numpy()
    flops = int_ops = 0
    for s in range(n_s):
        n_v = int(status[s, f_cap * 32:].sum())
        u = unpack(info[s], n_bg, n_t)
        inl, has_klt = int(u['bg_inlier'].sum()), int(u['has_klt'].sum())
        n_trk = int(f_valid[s].sum())
        # homography: Hartley (24 a point), 256 x (the DLT rows 24, the
        # 8x8 normal equations 712, Cholesky and substitutions 332, the
        # denormalisation 90) and their scores (19 a point); two refits
        # (the 44 sums over two rows an inlier 176, the solve 430, the
        # rescoring 19 a point)
        flops += 24 * n_bg + 256 * (1158 + 19 * n_v) \
            + 2 * (176 * inl + 430 + 19 * n_v)
        # similarity, a valid track: 64 hypotheses (23 each, 13 a point
        # scored), two refits (8 sums of 14 a point, the 4x4 solve 66, 13
        # a point rescored), the box estimate 20
        flops += n_trk * (64 * (23 + 13 * 32) + 2 * (14 * 32 + 66 + 13 * 32)
                          + 20)
        # Kalman: warp 956 and predict 2,365 a valid slot, the update
        # 1,200 a slot with an estimate, the commit 20 a slot
        flops += int(valid[s].sum()) * (956 + 2365) + 1200 * has_klt \
            + 20 * n_t
        # draws: 2 key derivations, 1,024 homography and 128 per valid
        # track uniforms and n_trk split keys, each threefry about 120
        # integer operations (20 rounds of add, rotate, xor; 5 key
        # injections) and 3 to make the float
        int_ops += 123 * (2 + 1024 + n_trk * 129)
    ops_ms = (flops / PEAK_F32 + int_ops / PEAK_I32) * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    by = 'bytes' if bytes_ms >= ops_ms else 'operations'
    return max(ops_ms, bytes_ms), by, ops_ms, bytes_ms


def ptxas_kernels(nvcc_out):
    """{kernel: 'N registers, ... smem, spills'} of each __global__ in
    ``nvcc -Xptxas -v``'s output."""
    out, name = {}, None
    for line in nvcc_out.splitlines():
        m = re.search(r"Compiling entry function '(\w+)'", line)
        if m:
            name = next((k for k in GAP_KERNELS + FLOW_KERNELS
                         + ASSOC_KERNELS + TAIL_KERNELS + FRAME_KERNELS
                         if k in m.group(1)), m.group(1))
        m = re.search(r'(\d+) bytes spill stores', line)
        if m and name:
            out[name] = f'{m.group(1)} bytes spilled'
        m = re.search(r'Used (\d+) registers(?:.*?(\d+) bytes smem)?', line)
        if m and name:
            out[name] = (f'{m.group(1)} registers, {m.group(2) or 0} bytes '
                         f'static shared memory, '
                         + out.get(name, 'no spill line'))
    return out


def phase_gap_commit(main_args, multi_args, card, nvcc_out):
    """Phase 17: the gap-commit kernel's draws, the kernel against its
    plain version (the main path's gap frame, phase 13's 8 streams at
    budget 128, the CPU tests' synthetic cases) and against the outputs
    the first design gave (their sha256), two calls equal, each role's
    registers and shared memory (``nvcc_out``: the build's ptxas
    output), and its times beside the bound. Returns the cases' numbers
    for the kernels line."""
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops import gap_commit as gc
    import tests.test_torch_gap_commit as tg
    t_phase = time.perf_counter()
    # (a) the draws
    seeds = sorted(JAX_DRAW_BITS) + [1, 2 ** 31 - 1, 123456789]
    for f_cap in (16, 48, 128):
        got = gc.kernel_draws(seeds, f_cap, 'cuda')
        want = fk.ransac_draws_batch(seeds, f_cap, 'cpu')
        for g, w in zip(got, want):
            if not torch.equal(g.cpu().view(torch.int32), w.view(torch.int32)):
                raise AssertionError(f'gap_commit draws at f_cap {f_cap} '
                                     'differ from ransac_draws_batch')
        if f_cap == 16:
            u_h, u_a = (u.cpu().numpy().view(np.int32) for u in got)
            for s, seed in enumerate(seeds):
                if seed in JAX_DRAW_BITS and (
                        int(u_h[s, 0, 0]), int(u_h[s, -1, -1]),
                        int(u_a[s, 0, 0, 0]), int(u_a[s, -1, -1, -1])) \
                        != JAX_DRAW_BITS[seed]:
                    raise AssertionError(f'gap_commit draws of seed {seed} '
                                         'differ from jax.random')
    log(f'gap_commit draws == ransac_draws_batch bit for bit (seeds '
        f'{seeds}, flow budgets 16, 48 and 128) and == the jax.random bits '
        f'of seeds {sorted(JAX_DRAW_BITS)}')

    # (b) the synthetic cases of the CPU tests, at their tolerances
    for kinds in [(k,) for k in tg.CASES] + [
            ('camera', 'lost', 'all_invalid'),
            ('few_matches', 'few_bg', 'out_of_frame')]:
        for f_cap in (32, 48):
            args = tg.commit_args(kinds, f_cap, list(range(3, 3 + len(kinds))))
            got = gc.gap_commit(*[tuple(x.cuda() for x in a)
                                  if isinstance(a, tuple) else
                                  a.cuda() if isinstance(a, torch.Tensor)
                                  else a for a in args])
            got = (tuple(a.cpu() for a in got[0]), got[1].cpu())
            want = gc.gap_commit_reference(*args)
            for s, kind in enumerate(kinds):
                tg.assert_commit_close(tg.per_stream(got, s),
                                       tg.per_stream(want, s),
                                       f'{kind} (stream {s}, {f_cap}): ')
    log('gap_commit on the synthetic cases of tests/test_torch_gap_commit.py '
        '(one stream of each, two mixes of three; flow budgets 32 and 48): '
        '== the plain version on the CPU at that file\'s tolerances')
    for case in tg.OUTPUT_SHA256:
        new, info = gc.gap_commit(*[tuple(x.cuda() for x in a)
                                    if isinstance(a, tuple) else
                                    a.cuda() if isinstance(a, torch.Tensor)
                                    else a for a in tg.hash_case_args(case)])
        got = tg.output_sha256([new[i] for i in gc.STATE_OUT] + [info])
        differ = [i for i, (g, w) in enumerate(zip(
            got, tg.OUTPUT_SHA256[case])) if g != w]
        if differ:
            raise AssertionError(f'gap_commit {tg.hash_case_id(case)}: '
                                 f'outputs {differ} differ from the first '
                                 'design\'s')
    log(f'gap_commit on the {len(tg.OUTPUT_SHA256)} synthetic calls of '
        'tests/test_torch_gap_commit.py::OUTPUT_SHA256: every output\'s '
        'sha256 == the first design\'s (one block a stream), bit for bit')
    for name, line in ptxas_kernels(nvcc_out).items():
        log(f'gap_commit ptxas {name}: {line}')

    # (c) real gap frames: kernel against the plain version on the CPU and
    # on the card, two calls equal, then the times
    lib = gc.gap_commit_library()
    cases = {}
    for key, args in (('1_stream', main_args), ('8_streams', multi_args)):
        n_s, f_cap = args[4][0].shape[0], args[6].shape[1]
        tag = f'{n_s} stream(s) x flow budget {f_cap}'
        got = gc.gap_commit(*args)
        again = gc.gap_commit(*args)
        torch.cuda.synchronize()
        for a, b in zip(got[0] + (got[1],), again[0] + (again[1],)):
            if not torch.equal(a, b):
                raise AssertionError(f'gap_commit {tag}: two calls differ')
        if not (torch.isfinite(got[0][0]).all()
                and torch.isfinite(got[0][1]).all()
                and torch.isfinite(got[1]).all()):
            raise AssertionError(f'gap_commit {tag}: outputs not finite')
        cpu_args = [tuple(x.cpu() for x in a) if isinstance(a, tuple) else
                    a.cpu() if isinstance(a, torch.Tensor) else a
                    for a in args]
        worst, worst_h = gap_agreement(f'{tag}, kernel vs plain on the CPU',
                                       args, got,
                                       gc.gap_commit_reference(*cpu_args))
        plain_card = gc.gap_commit_reference(*args)
        gap_agreement(f'{tag}, kernel vs plain on the card', args, got,
                      plain_card, check=False)
        bound, by, ops_ms, bytes_ms = gap_commit_bound_ms(args, got)
        _, launch = gc.gap_commit_launch_args(*args)
        device = [lk_device_ms(lib.gap_commit_forward, launch,
                               tag='gap_commit') for _ in range(2)]

        def call():
            gc.gap_commit(*args)
        call_ms, call_host = launches_ms(call), host_ms(call)
        plain_ms = wall_ms(lambda: gc.gap_commit_reference(*args))
        ms = statistics.mean(device)
        per_window = ' / '.join(f'{d * 1e3:.2f}' for d in device)
        n_t = args[4][0].shape[1]
        log(f'gap_commit {tag}: device {per_window} us a call of its two '
            f'launches ({n_s * gc.H_PARTS} homography and '
            f'{n_s * -(-f_cap // 8)} similarity blocks, then '
            f'{n_s * -(-n_t // 32)} Kalman blocks; two windows of '
            f'{LK_TIMED_LAUNCHES} calls); '
            f'the wrapper {call_ms * 1e3:.2f} us a call, host '
            f'{call_host * 1e3:.2f} us a call; plain on the card '
            f'{plain_ms:.3f} ms; bound {bound * 1e3:.4f} us ({by}: '
            f'operations {ops_ms * 1e3:.4f} us, bytes {bytes_ms * 1e3:.4f} '
            f'us), roofline share {bound / ms:.5f}: the dependent chain, '
            f'not the work, sets the time; {card}')
        cases[key] = {'ms': ms, 'call_ms': call_ms, 'host_ms': call_host,
                      'plain_ms': plain_ms, 'bound_ms': bound,
                      'bound_by': by, 'max_abs_err': worst,
                      'h_corner_px': worst_h}
    log(f'gap_commit phase: {time.perf_counter() - t_phase:.1f} s')
    return cases


def gap_kernel_entry(cases):
    """The kernels line's entry of the gap-commit kernel: the main path's
    case unsuffixed, the 8-stream case's numbers suffixed."""
    entry = {'name': 'gap_commit', 'route': 'cuda',
             'source': 'fastmot_tpu_torch/csrc/gap_commit.cu',
             'replaces': 'fastmot_tpu/tracker.py:264',
             'launches': sum(GAP_LAUNCHES.values()),
             'max_abs_err': max(c['max_abs_err'] for c in cases.values()),
             'library_ms': None, 'case': '1_stream'}
    for case, r in cases.items():
        key = '' if case == '1_stream' else f'_{case}'
        entry.update({f'ms{key}': r['ms'], f'plain_ms{key}': r['plain_ms'],
                      f'bound_ms{key}': r['bound_ms'],
                      f'bound_by{key}': r['bound_by'],
                      f'call_ms{key}': r['call_ms'],
                      f'host_ms{key}': r['host_ms'],
                      f'roofline_share{key}': r['bound_ms'] / r['ms']})
    return entry


def preprocess_bound_ms(spec, frames, state):
    """The least time the card could take for one preprocess call: the
    frames read once and the state written once over the memory rate, and
    the float32 operations over the f32 rate (gray 5 a frame pixel; its
    gradients, products, 3x3 sums, response and cell maximum 30 a frame
    pixel and 30 a bg pixel; a resized pixel 7, a 2x2 mean 4 and a uint8
    rounding 3 a level pixel). Returns (bound, bound_by)."""
    n_px = frames.numel() // 3
    n_s = frames.shape[0] if frames.dim() == 4 else 1
    bw, bh = spec.bg_size
    levels = sum(t.numel() for t in state[0])
    lvl0 = state[0][0].numel()
    out_bytes = sum(t.numel() * 4 for t in state[0] + state[1]) + sum(
        t.numel() * 4 for t in state[2:])
    ops = 35 * n_px + 37 * n_s * bh * bw + 10 * lvl0 + 7 * (levels - lvl0)
    ops_ms = ops / PEAK_F32 * 1e3
    bytes_ms = (frames.numel() + out_bytes) / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), 'bytes' if bytes_ms >= ops_ms \
        else 'operations'


def gap_points_bound_ms(args, outputs):
    """The least time the card could take for one point assembly with this
    run's data: the bytes it must read once (of every track slot the depth
    key's y2, validity and age; of the f_cap flow rows the rest of the box,
    the keypoints and their validity; the candidates and bg candidates)
    and its outputs written once over the memory rate, and the comparisons
    over the f32 rate: each candidate and bg candidate against each valid
    flow track's box (4), a keypoint against the nearer valid boxes (4
    each), and for each valid track the ellipse and quality tests of its
    box's candidates (10). Returns (bound, bound_by)."""
    from fastmot_tpu_torch.ops import gap_points as gp
    spec, states, prev, f_cap = args
    inputs = gp._inputs(states, prev)
    tlbrs, valid, ages, kps, kp_valid = inputs[:5]
    n_slots = valid.numel()
    n_rows = n_slots // valid.shape[-1] * f_cap           # streams x f_cap
    k = kp_valid.shape[-1]
    nbytes = (n_slots * (tlbrs.element_size() + valid.element_size()
                         + ages.element_size())
              + n_rows * (3 * tlbrs.element_size()
                          + 2 * k * kps.element_size()
                          + k * kp_valid.element_size())
              + sum(t.numel() * t.element_size() for t in inputs[5:])
              + sum(t.numel() * t.element_size() for t in outputs))
    f_valid = outputs[5].reshape(-1, f_cap).cpu()
    inside = outputs[2].reshape(-1, f_cap, 4).cpu()
    n_c = inputs[6].shape[-1]
    n_bg = inputs[8].shape[-1]
    ops = 0
    for s in range(f_valid.shape[0]):
        n_v = int(f_valid[s].sum())
        box = inside[s][f_valid[s]]
        cells = ((box[:, 2] - box[:, 0]).clamp(min=0) / 8 + 1) * \
            ((box[:, 3] - box[:, 1]).clamp(min=0) / 8 + 1)
        ops += 4 * (n_c + n_bg) * n_v + 4 * 32 * n_v * (n_v - 1) // 2 \
            + 10 * float(cells.sum())
    ops_ms = ops / PEAK_F32 * 1e3
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    return max(ops_ms, bytes_ms), 'bytes' if bytes_ms >= ops_ms \
        else 'operations'


def phase_flow_kernels(main_args, multi_args, card, nvcc_out):
    """Phase 18: the preprocess and gap-points kernels against their plain
    versions (on the CPU and on the card) on phase 6's gap frame (1 stream)
    and phase 13's 8 streams at budget 128, two calls equal, ptxas's
    registers and shared memory, then the times beside the bounds. Returns
    each kernel's cases for the kernels line."""
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops import gap_points as gp
    import tests.test_torch_flow_preprocess as tp
    import tests.test_torch_gap_points as tg
    t_phase = time.perf_counter()
    for name in ('flow_preprocess', 'gap_points'):
        for kernel, line in ptxas_kernels(nvcc_out[name]).items():
            log(f'{name} ptxas {kernel}: {line}')
    pre_lib, pts_lib = fk.preprocess_library(), gp.gap_points_library()

    def to(x, device):
        if isinstance(x, torch.Tensor):
            return x.to(device)
        if isinstance(x, (list, tuple)):
            return type(x)(to(y, device) for y in x)
        return x

    def cpu(x):
        return to(x, 'cpu')

    # the synthetic calls of the CPU tests, against the first designs' sha256
    for name, mod, run in (
            ('preprocess', tp, lambda case: fk.preprocess(
                case[0], case[1].cuda())),
            ('gap_points', tg,
             lambda case: gp.gap_points(*to(case, 'cuda')))):
        differ = [mod.hash_case_id(key) for key in mod.OUTPUT_SHA256
                  if mod.output_sha256(run(mod.hash_case(key)))
                  != mod.OUTPUT_SHA256[key]]
        if differ:
            raise AssertionError(f'{name}: outputs of {differ} differ from '
                                 'the first design\'s')
        log(f'{name} on the {len(mod.OUTPUT_SHA256)} synthetic calls of '
            f'{mod.__name__}.OUTPUT_SHA256: every output == the first '
            'design\'s, bit for bit')

    out = {'flow_preprocess': {}, 'gap_points': {}}
    for key, (spec, frames, states, prev, f_cap) in (
            ('1_stream', main_args), ('8_streams', multi_args)):
        n_s = frames.shape[0] if frames.dim() == 4 else 1
        tag = f'{n_s} stream(s) x flow budget {f_cap}'
        # the preprocess
        got = fk.preprocess(spec, frames)
        again = fk.preprocess(spec, frames)
        torch.cuda.synchronize()
        flat, flat2 = tp.flat_state(got), tp.flat_state(again)
        if not all(torch.equal(a, b) for a, b in zip(flat, flat2)):
            raise AssertionError(f'preprocess {tag}: two calls differ')
        if not all(torch.isfinite(t).all() for t in flat):
            raise AssertionError(f'preprocess {tag}: outputs not finite')
        want = fk.preprocess_reference(spec, frames.cpu())
        tp.assert_state_equal(got, want, spec, f'preprocess {tag} vs the CPU')
        n_all = sum(t.numel() for t in flat)
        equal = sum(int((g.cpu().view(torch.int32)
                         == w.view(torch.int32)).sum())
                    for g, w in zip(flat, tp.flat_state(want)))
        worst = max(float((g.cpu() - w).abs().max())
                    for g, w in zip(flat, tp.flat_state(want)))
        plain_card = fk.preprocess_reference(spec, frames)
        equal_card = sum(int((g.view(torch.int32)
                              == w.view(torch.int32)).sum())
                         for g, w in zip(flat, tp.flat_state(plain_card)))
        log(f'preprocess {tag}: kernel vs plain on the CPU: '
            f'{equal / n_all:.6f} of {n_all} values bit-equal, largest '
            f'difference {worst}; vs plain on the card: '
            f'{equal_card / n_all:.6f} bit-equal')
        state, launch = fk.preprocess_launch_args(spec, frames)
        device = [lk_device_ms(pre_lib.flow_preprocess_forward, launch,
                               tag='preprocess') for _ in range(2)]

        def call_pre():
            fk.preprocess(spec, frames)
        call_ms, call_host = launches_ms(call_pre), host_ms(call_pre)
        plain_ms = wall_ms(lambda: fk.preprocess_reference(spec, frames))
        bound, by = preprocess_bound_ms(spec, frames, got)
        ms = statistics.mean(device)
        log(f'preprocess {tag}: device '
            f'{" / ".join(f"{d * 1e3:.2f}" for d in device)} us a call (one '
            f'launch; two windows of {LK_TIMED_LAUNCHES} calls); the wrapper '
            f'{call_ms * 1e3:.2f} us a call, host {call_host * 1e3:.2f} us a '
            f'call; plain on the card {plain_ms:.3f} ms; bound '
            f'{bound * 1e3:.4f} us ({by}), roofline share {bound / ms:.5f}; '
            f'{card}')
        out['flow_preprocess'][key] = {
            'ms': ms, 'call_ms': call_ms, 'host_ms': call_host,
            'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
            'max_abs_err': worst}
        # the point assembly
        args = (spec, states, prev, f_cap)
        got = gp.gap_points(*args)
        again = gp.gap_points(*args)
        torch.cuda.synchronize()
        if not all(torch.equal(a, b) for a, b in zip(got, again)):
            raise AssertionError(f'gap_points {tag}: two calls differ')
        want = gp.gap_points_reference(*cpu(args))
        tg.assert_points_equal(tuple(g.cpu() for g in got), want,
                               f'gap_points {tag} vs the CPU')
        plain_card = gp.gap_points_reference(*args)
        same_card = all(torch.equal(g, w) for g, w in zip(got, plain_card))
        n_valid = int(got[1].sum())
        log(f'gap_points {tag}: kernel == plain on the CPU bit for bit '
            f'({n_valid} valid points of {got[1].numel()}); == plain on the '
            f'card: {same_card}')
        outputs, launch = gp.gap_points_launch_args(*args)
        device = [lk_device_ms(pts_lib.gap_points_forward, launch,
                               tag='gap_points') for _ in range(2)]

        def call_pts():
            gp.gap_points(*args)
        call_ms, call_host = launches_ms(call_pts), host_ms(call_pts)
        plain_ms = wall_ms(lambda: gp.gap_points_reference(*args))
        bound, by = gap_points_bound_ms(args, got)
        ms = statistics.mean(device)
        owner_blocks = -(-(prev[3].shape[-1] + prev[5].shape[-1])
                         // gp.OWNER_CHUNK)
        log(f'gap_points {tag}: device '
            f'{" / ".join(f"{d * 1e3:.2f}" for d in device)} us a call (two '
            f'launches: {n_s * owner_blocks} owner blocks, then '
            f'{n_s * (states[2].shape[-2] + 1)} track and bg blocks '
            f'beside them until the owners are read; two windows of '
            f'{LK_TIMED_LAUNCHES} calls); the wrapper {call_ms * 1e3:.2f} us '
            f'a call, host {call_host * 1e3:.2f} us a call; plain on the '
            f'card {plain_ms:.3f} ms; bound {bound * 1e3:.4f} us ({by}), '
            f'roofline share {bound / ms:.5f}: the chain of a track\'s '
            f'selection, not the work, sets the time; {card}')
        out['gap_points'][key] = {
            'ms': ms, 'call_ms': call_ms, 'host_ms': call_host,
            'plain_ms': plain_ms, 'bound_ms': bound, 'bound_by': by,
            'max_abs_err': 0.0}
    log(f'flow kernels phase: {time.perf_counter() - t_phase:.1f} s')
    return out


def flow_kernel_entries(cases):
    """The kernels line's entries of the preprocess and gap-points kernels:
    the main path's case unsuffixed, the 8-stream case's numbers
    suffixed."""
    meta = {'flow_preprocess': ('fastmot_tpu_torch/csrc/flow_preprocess.cu',
                                'fastmot_tpu/ops/flow_kernels.py:716'),
            'gap_points': ('fastmot_tpu_torch/csrc/gap_points.cu',
                           'fastmot_tpu/tracker.py:243')}
    entries = []
    for name, (source, replaces) in meta.items():
        entry = {'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': FLOW_LAUNCHES[name],
                 'max_abs_err': max(c['max_abs_err']
                                    for c in cases[name].values()),
                 'library_ms': None, 'case': '1_stream'}
        for case, r in cases[name].items():
            key = '' if case == '1_stream' else f'_{case}'
            entry.update({f'ms{key}': r['ms'],
                          f'plain_ms{key}': r['plain_ms'],
                          f'bound_ms{key}': r['bound_ms'],
                          f'bound_by{key}': r['bound_by'],
                          f'call_ms{key}': r['call_ms'],
                          f'host_ms{key}': r['host_ms'],
                          f'roofline_share{key}': r['bound_ms'] / r['ms']})
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The association solvers (phase 19, and the association frame's stages)
# ---------------------------------------------------------------------------

def assoc_counts():
    """The cascade and greedy kernels' launches since ``reset_lk``, and
    the greedy kernel's through the finals entry."""
    from fastmot_tpu_torch.ops import assignment as asg
    return (asg.cascade_auction.launches, asg.greedy_match.launches,
            asg.greedy_finals.launches)


# the association kernels' launches on the main paths, by kernel and the
# finals entry (the kernels line's counts)
ASSOC_NAMES = ('cascade_auction', 'greedy_match', 'greedy_finals')
ASSOC_LAUNCHES = Counter()


def expect_assoc(tag, counts, frames):
    """The cascade kernel and the greedy kernel ran once an association
    frame (``frames``) each, for all of a call's streams and stages, the
    greedy kernel through the finals entry."""
    if tuple(counts) != (frames,) * 3:
        raise AssertionError(f'{tag}: cascade_auction, greedy_match and '
                             f'greedy_finals launched {tuple(counts)} '
                             f'times, expected {(frames,) * 3}')
    for name, n in zip(ASSOC_NAMES, counts):
        ASSOC_LAUNCHES[name] += n


def tail_counts():
    """The generic NMS and merge kernels', the SSD postprocess kernels' and
    the commit kernel's launches since ``reset_lk``."""
    from fastmot_tpu_torch.multichip import tail_launches
    return tail_launches()


# the NMS, merge, SSD postprocess and commit kernels' launches on the main
# paths (the kernels line's counts)
TAIL_NAMES = ('greedy_suppress', 'merge_labels', 'ssd_postprocess',
              'assoc_commit')
TAIL_LAUNCHES = Counter()


def expect_tail(tag, counts, ssd_runs, commits):
    """The SSD postprocess kernels ran once an SSD detector run
    (``ssd_runs``) and the commit kernel once an association frame
    (``commits``), for all of a call's streams; the generic NMS and merge
    kernels, which no main path runs (the YOLO postprocess and the SSD's
    have their own), not at all."""
    want = (0, 0, ssd_runs, commits)
    if tuple(counts) != want:
        raise AssertionError(f'{tag}: greedy_suppress, merge_labels, '
                             f'ssd_postprocess and assoc_commit launched '
                             f'{tuple(counts)} times, expected {want}')
    for name, n in zip(TAIL_NAMES, counts):
        TAIL_LAUNCHES[name] += n


def frame_counts(reset=False):
    """The YOLO postprocess kernels' (``nms_waves.nms_select``), the costs
    kernel's and the ReID-input kernel's calls since ``reset_lk`` (with
    ``reset``, zeroed first)."""
    from fastmot_tpu_torch.multichip import frame_launches
    return frame_launches(reset)


# the YOLO postprocess, costs and ReID-input kernels' calls on the main
# paths (the kernels line's counts)
FRAME_NAMES = ('nms_select', 'assoc_costs', 'reid_crops')
FRAME_LAUNCHES = Counter()


def expect_frame(tag, counts, detections, costs, crops):
    """The YOLO postprocess kernels ran once a YOLO detector run
    (``detections``, for all of a call's streams), the costs kernel once
    an association frame (``costs``) and the ReID-input kernel once an
    extraction (``crops``), each for all of a call's streams."""
    want = (detections, costs, crops)
    if tuple(counts) != want:
        raise AssertionError(f'{tag}: nms_select, assoc_costs and '
                             f'reid_crops launched {tuple(counts)} times, '
                             f'expected {want}')
    for name, n in zip(FRAME_NAMES, counts):
        FRAME_LAUNCHES[name] += n


def plain_solvers():
    """A context in which ``ops.assignment``'s plain solvers are the
    originals, not ``main``'s counters (to time them on the card)."""
    from contextlib import ExitStack
    from fastmot_tpu_torch.ops import assignment as asg
    from fastmot_tpu_torch import tracker as tr
    stack = ExitStack()
    for name in ('auction_lap_reference', 'cascade_reference',
                 'greedy_match_reference'):
        if name in PLAIN:
            stack.enter_context(mock.patch.object(asg, name, PLAIN[name]))
    if 'finals_reference' in PLAIN:
        stack.enter_context(mock.patch.object(tr, 'finals_reference',
                                              PLAIN['finals_reference']))
    return stack


def plain_finals(finals_args):
    """``tracker.finals_reference`` (the finals' plain version) with the
    plain greedy matches, on the device of its arguments."""
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import assignment as asg
    plain_greedy = PLAIN.get('greedy_match_reference',
                             asg.greedy_match_reference)
    with plain_solvers(), mock.patch.object(
            asg, 'greedy_match', lambda p: [plain_greedy(*q) for q in p]):
        return tr.finals_reference(*finals_args)


def count_syncs(fn):
    """The host syncs a call of ``fn()`` makes after a first call, as
    torch's CUDA sync debug mode reports them (a warning a synchronizing
    call)."""
    import warnings
    fn()
    torch.cuda.synchronize()
    with warnings.catch_warnings(record=True) as caught:
        warnings.simplefilter('always')
        torch.cuda.set_sync_debug_mode('warn')
        try:
            fn()
        finally:
            torch.cuda.set_sync_debug_mode(0)
    # the mode's own note that it is a prototype is not a sync
    return sum('synchroniz' in str(w.message)
               and 'debug mode' not in str(w.message) for w in caught)


def assoc_solver_args(trk, scan_costs, det_dev, n_depth):
    """The cascade's and the finals' arguments of an association frame, as
    ``scan_finals_commit_core`` (one stream, ``trk`` a ``MultiTracker``)
    or ``StreamTracker.update_device`` (``trk`` its first tracker, with
    [S, ...] costs) makes them: ``(scan_args, eps, finals_args)``, the
    finals on the cascade's result."""
    from fastmot_tpu_torch import tracker as tr
    (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks,
     base_iou_active, base_unconf, u_det, col4row), st = scan_costs
    scan_args = (n_depth, cost, iou_cost, tuple(depth_masks),
                 base_iou_active, base_unconf, u_det, col4row)
    u2, c2 = tr.stages_scan_core(*scan_args, eps=trk.assoc_eps)
    finals_args = (trk.conf_thresh, trk.max_reid_cost,
                   1.0 - trk.duplicate_thresh, trk.confirm_hits, st[2],
                   st[3], st[4], st[5], det_dev[0], det_dev[2], reid_cost,
                   h_reid_ok, occluded, u2, c2)
    return scan_args, trk.assoc_eps, finals_args


def cascade_call(scan_args, eps):
    """``stages_scan_core``'s cascade as ``ops.assignment`` takes it, with a
    stream axis: (costs, masks, cost_of, exclude, u_det, col4row)."""
    n_depth, cost, iou_cost, depth_masks, ba, bu, u_det, col4row = scan_args
    masks = tuple(depth_masks) + (ba, bu)
    n = len(depth_masks)
    one = cost.dim() == 2

    def lead(t):
        return t[None] if one else t
    return ((lead(cost), lead(iou_cost)), tuple(lead(m) for m in masks),
            (0,) * n + (1, 1), (False,) * n + (True, False), lead(u_det),
            lead(col4row))


def greedy_call(finals_args):
    """The two greedy problems ``finals_core`` hands ``greedy_match``, with
    a stream axis."""
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import assignment as asg
    problems = []

    def capture(p):
        problems.extend(p)
        return [PLAIN.get('greedy_match_reference',
                          asg.greedy_match_reference)(*q) for q in p]
    with plain_solvers(), mock.patch.object(asg, 'greedy_match', capture):
        tr.finals_reference(*finals_args)
    if problems[0][0].dim() == 2:
        problems = [(c[None], r[None], v[None], m)
                    for c, r, v, m in problems]
    return problems


def cascade_rounds(call, eps):
    """The cascade kernel's bidding rounds and the bids made in them, each
    [S, stage, phase], on ``call`` (``cascade_call``'s arguments), from one
    call of its C entry."""
    from fastmot_tpu_torch.ops import assignment as asg
    (_, _, _, rounds, bids), args, keep = asg.cascade_launch_args(
        *call, eps, rounds=True)
    if asg.assoc_solvers_library().cascade_auction_forward(*args):
        raise AssertionError('cascade_auction: launch failed')
    return rounds.cpu().numpy(), bids.cpu().numpy()


def solver_stages_ms(scan_args, eps, finals_args):
    """The cascade (``stages_scan_core``) and the finals (``finals_core``)
    alone, synchronised (ms), each through the kernels and through the
    plain versions; the host syncs a call of each makes; the kernel's
    bidding rounds by stage and phase of each stream."""
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import assignment as asg
    call = cascade_call(scan_args, eps)

    def cascade():
        return tr.stages_scan_core(*scan_args, eps=eps)

    def cascade_plain():
        with plain_solvers():
            return asg.cascade_reference(*call, eps)

    def finals():
        return tr.finals_core(*finals_args)

    def finals_plain():
        return plain_finals(finals_args)
    out = {'cascade': wall_ms(cascade), 'cascade, plain':
           wall_ms(cascade_plain, n=3, warmup=1),
           'finals': wall_ms(finals), 'finals, plain':
           wall_ms(finals_plain, n=3, warmup=1)}
    syncs = {name: count_syncs(fn) for name, fn in (
        ('cascade', cascade), ('cascade, plain', cascade_plain),
        ('finals', finals), ('finals, plain', finals_plain))}
    return out, syncs, cascade_rounds(call, eps)[0]


def assoc_stages_ms(mot, frames, staged):
    """One association frame of ``mot``'s main path after a run (its last
    frame, the detections staged for its last association frame), each
    stage alone and the whole ``update_device_fused`` call, synchronised
    (ms): the detector's net (letterbox, YOLOv4, decode), its NMS
    (``nms_and_gate``, and ``geom.greedy_suppress`` alone on the arguments
    it got, with its plain version beside it where the checkout has one),
    crops + OSNet, the costs (``assoc_costs_core``), the cascade
    (``stages_scan_core``), the finals (``finals_core``) and the commit
    (``tracker.commit_core``, the kernel on the card, with the plain
    ``commit_part`` beside it; ``commit_part`` where the checkout has no
    ``commit_core``), and the crops alone (the ReID input before OSNet:
    ``ops.reid_crops.reid_crops``, or an earlier checkout's
    ``crop_resize_batch`` and normalisation); where the checkout has them,
    the plain NMS, costs and crops beside the kernels. Returns the times,
    the host syncs a call of the NMS, the crops alone, crops + OSNet, the
    costs, the cascade, the finals, the commit, ``update_device_fused`` and
    a whole association frame (the net, the NMS and
    ``update_device_fused``) make, and the solvers' arguments (phase 19's);
    the NMS's and the commit's go to ``STAGE_ARGS['tail']`` (phase 20's),
    the NMS's, the costs', the crops' and the whole frame's to
    ``STAGE_ARGS['frame']`` (phase 21's). It calls only what every
    checkout of the port has, so that scripts/assoc_stages_turns.py runs it
    on an earlier one too."""
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch import feature_extractor as fe
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.detector import nms_and_gate
    from fastmot_tpu_torch.feature_extractor import extract_core
    from fastmot_tpu_torch.models.yolo import decode_heads
    from fastmot_tpu_torch.ops import geometry as geom
    trk, det, ext = mot.tracker, mot.detector, mot.extractors[0]
    if trk._dev_state is None or trk._mirrors_dirty:
        trk._upload_state()
    trk._ensure_hist_store()
    det_dev = staged[max(staged)]
    frame = torch.as_tensor(frames[-1], device=det_dev[0].device)
    d_cap = int(det_dev[0].shape[0])
    est = max(sum(1 for t in trk.tracks.values() if t.active),
              trk._det_count_hint)
    emb_cap = 64 if (est <= 56 and d_cap > 64) else d_cap
    _, ih, iw = det.model.INPUT_SHAPE

    # the anchors on the device where the checkout builds them once
    anchors = getattr(det, '_anchors', det.model.ANCHORS)

    def net():
        heads = det.module(det.preprocess(frame))
        return decode_heads(heads, anchors, det.model.SCALES,
                            (ih, iw), det.model.NEW_COORDS)[0]
    det_out = net()
    nms_args = (det_out, det.label_mask, det.conf_thresh, det.nms_thresh,
                det.max_area, det.min_aspect_ratio, det._scale_wh,
                det._offset)

    def nms():
        return nms_and_gate(*nms_args)
    # the waves' arguments, from the plain NMS where the card runs the
    # whole postprocess in its kernels
    plain_nms = unpatched(detmod, 'nms_and_gate_reference') \
        if hasattr(detmod, 'nms_and_gate_reference') else None
    suppress_args, real_suppress = [], geom.greedy_suppress
    with mock.patch.object(geom, 'greedy_suppress', lambda *a: (
            suppress_args.append(a), real_suppress(*a))[1]):
        (plain_nms or nms_and_gate)(*nms_args)
    state, hist = trk._dev_state, trk._hist_store
    params = trk._assoc_params()
    costs, emb = tr.extract_costs_core(
        ext.module, ext.out_hw, emb_cap, *params, frame, state, hist,
        *det_dev)
    n_depth = (trk.max_age + 2) // 2
    scan_args, eps, finals_args = assoc_solver_args(trk, (costs, state),
                                                    det_dev, n_depth)
    cascade_out = (costs[3], finals_args[-1]) + tr.finals_core(*finals_args)
    frame_id = mot.frame_count

    def cascade():
        return tr.stages_scan_core(*scan_args, eps=eps)

    def finals():
        return tr.finals_core(*finals_args)

    # the commit through its dispatch, the kernel on the card (earlier
    # checkouts commit through commit_part alone)
    commit_fn = getattr(tr, 'commit_core', tr.commit_part)
    commit_args = (trk.kf_cfg, trk.confirm_hits, trk.max_age,
                   trk.history_size, state, hist, *det_dev, emb, frame_id,
                   trk._frame_rect_dev, cascade_out)

    def commit():
        return commit_fn(*commit_args)

    def whole():
        return trk.update_device_fused(frame_id, frame, det_dev, ext)

    def whole_with_detector():
        net()
        nms()
        whole()
    crop_args = (frame, det_dev[0][:emb_cap], ext.out_hw)
    if not hasattr(fe, 'rc'):
        # an earlier checkout: the crop, then extract_core's lines before
        # the network
        def crops():
            x = fe.crop_resize_batch(*crop_args).flip(-1)
            mean = torch.tensor(fe._IMAGENET_MEAN, device=frame.device)
            std = torch.tensor(fe._IMAGENET_STD, device=frame.device)
            return (x / 255.0 - mean) / std
    else:
        def crops():
            return fe.rc.reid_crops(*crop_args)
    stages = {
        'detector net (letterbox, YOLOv4, decode)': net,
        'NMS and gates (nms_and_gate)': nms,
        f'greedy_suppress alone ({suppress_args[0][0].shape[-1]} '
        'candidates)': lambda: real_suppress(*suppress_args[0]),
        f'crops alone ({emb_cap} crops, before OSNet)': crops,
        f'crops + OSNet ({emb_cap} crops)': lambda: extract_core(
            ext.module, ext.out_hw, frame, det_dev[0][:emb_cap],
            det_dev[3][:emb_cap]),
        'costs (assoc_costs_core)': lambda: tr.assoc_costs_core(
            *params, state, hist, *det_dev, emb, emb_cap=emb_cap),
        'cascade (stages_scan_core)': cascade,
        'finals (finals_core)': finals,
        'commit': commit}
    if hasattr(geom, 'greedy_suppress_reference'):
        plain_suppress = unpatched(geom, 'greedy_suppress_reference')
        stages['greedy_suppress alone, plain'] = lambda: plain_suppress(
            *suppress_args[0])
    if hasattr(tr, 'commit_core'):
        plain_commit = unpatched(tr, 'commit_part')
        stages['commit, plain (commit_part)'] = lambda: plain_commit(
            *commit_args)
    if plain_nms is not None:
        stages['NMS and gates, plain (nms_and_gate_reference)'] = \
            lambda: plain_nms(*nms_args)
    if hasattr(tr, 'assoc_costs_reference'):
        plain_costs = unpatched(tr, 'assoc_costs_reference')
        stages['costs, plain (assoc_costs_reference)'] = lambda: plain_costs(
            *params, state, hist, *det_dev, emb, emb_cap=emb_cap)
    if hasattr(fe, 'rc'):
        plain_crops = unpatched(fe.rc, 'reid_crops_reference')
        stages['crops alone, plain (reid_crops_reference)'] = \
            lambda: plain_crops(*crop_args)
    out = {name: wall_ms(fn) for name, fn in stages.items()}
    syncs = {'NMS and gates': count_syncs(nms),
             'crops alone': count_syncs(crops),
             'crops + OSNet': count_syncs(
                 stages[f'crops + OSNet ({emb_cap} crops)']),
             'costs': count_syncs(stages['costs (assoc_costs_core)']),
             'cascade': count_syncs(cascade), 'finals': count_syncs(finals),
             'commit': count_syncs(commit),
             'update_device_fused': count_syncs(whole),
             'whole association frame (net, NMS, update_device_fused)':
                 count_syncs(whole_with_detector)}
    out['whole association frame (update_device_fused)'] = wall_ms(whole)
    out['whole association frame (net, NMS, update_device_fused)'] = \
        wall_ms(whole_with_detector)
    # phase 20's real arguments of the main path's frame
    STAGE_ARGS['tail'] = {'nms': nms_args, 'suppress': suppress_args[0],
                          'commit': commit_args}
    # phase 21's: the NMS, the costs (with a stream axis of one), the
    # crops, and the whole association frame for its sync-free check
    STAGE_ARGS['frame'] = {
        'nms': nms_args, 'crops': crop_args,
        'costs': (params, tuple(a[None] for a in state),
                  tuple(a[None] for a in hist),
                  tuple(a[None] for a in det_dev), emb[None], emb_cap),
        'frame_id': frame_id, 'commit': commit_args,
        'whole': whole_with_detector}
    trk.sync()
    return out, syncs, (scan_args, eps, finals_args)


def log_assoc_stages(tag, stage_ms, syncs, rounds, card):
    log(f'{tag} association stages alone, ms: ' + '; '.join(
        f'{name} {ms:.3f}' for name, ms in stage_ms.items()) + f'; {card}')
    log(f'{tag} host syncs a call: ' + ', '.join(
        f'{name} {n}' for name, n in syncs.items()))
    log(f'{tag} cascade kernel bidding rounds [stream][stage][phase]: '
        f'{rounds.tolist()} (sum {int(rounds.sum())})')


def stage1_cost(t_live=64, d_live=40, cap=128, seed=0):
    """The stage-1 cost of scripts/prof_auction.py, the bench workload's
    contested regime: ``t_live`` track rows and ``d_live`` detections on a
    1280 x 720 field in ``cap`` x ``cap`` padded matrices, appearance
    nearly constant (0.35 + N(0, 2e-3)), motion a scaled Mahalanobis
    distance of tracks placed near the detections, gated at 1.0 (motion)
    and 0.9 (fused) to 1e5; an IoU-like cost beside it; the rows' masks of
    the tracker's six cascade stages over ages 0-7 and hits 0-5. Returns
    numpy (cost, iou, row_valid, col_valid, masks)."""
    rng = np.random.default_rng(seed)
    dx = rng.uniform(0, 1280, d_live)
    dy = rng.uniform(0, 720, d_live)
    tx = np.concatenate([dx + rng.normal(0, 12, d_live),
                         rng.uniform(0, 1280, t_live - d_live)])
    ty = np.concatenate([dy + rng.normal(0, 12, d_live),
                         rng.uniform(0, 720, t_live - d_live)])
    d2 = ((tx[:, None] - dx[None, :]) ** 2
          + (ty[:, None] - dy[None, :]) ** 2) / (40.0 ** 2)
    maha_norm = np.clip(d2, 0, 12.0) / 9.4877
    app = 0.35 + rng.normal(0, 2e-3, (t_live, d_live))
    fused = 0.8 * app + 0.2 * maha_norm
    gated = np.where(maha_norm > 1.0, 1e5, fused)
    gated = np.where(gated > 0.9, 1e5, gated)
    cost = np.full((cap, cap), 1e5, np.float32)
    cost[:t_live, :d_live] = gated
    iou = np.full((cap, cap), 1e5, np.float32)
    near = np.sqrt(d2) < 1.0
    iou[:t_live, :d_live] = np.where(near, np.clip(np.sqrt(d2), 0, 1), 1e5)
    ages = rng.integers(0, 8, cap)
    hits = rng.integers(0, 6, cap)
    valid = np.arange(cap) < t_live
    confirmed = hits >= 3
    n_depth = 4
    masks = [valid & confirmed & (ages // 2 == d) for d in range(n_depth)]
    masks += [valid & confirmed & (ages < 2), valid & ~confirmed]
    return cost, iou, valid, np.arange(cap) < d_live, masks


def stage1_case(n_streams, device='cuda'):
    """``stage1_cost`` of seeds 0 .. ``n_streams`` - 1 on ``device``: the
    one-stage auction's arguments (cost, row_valid, col_valid) and the
    tracker's cascade (``cascade_call``'s form: four appearance + motion
    stages, then the two IoU stages)."""
    per = [stage1_cost(seed=s) for s in range(n_streams)]

    def stack(k):
        return torch.as_tensor(np.stack([p[k] for p in per]), device=device)
    cost, iou, rv, cv = stack(0), stack(1), stack(2), stack(3)
    n = len(per[0][4])
    masks = tuple(torch.as_tensor(np.stack([p[4][k] for p in per]),
                                  device=device) for k in range(n))
    col4row = torch.full(rv.shape, -1, dtype=torch.int32, device=device)
    return (cost, rv, cv), ((cost, iou), masks, (0,) * (n - 2) + (1, 1),
                            (False,) * (n - 2) + (True, False), cv, col4row)


def contested_greedy(problems, seed):
    """Greedy problems of the finals' shapes and gates (``problems``, as
    ``greedy_call`` gives them) that take tens of matches: the first 64
    rows and 40 columns live (at most the problem's), costs uniform on [0,
    2 max_cost) in steps of 1/64, so with exact ties."""
    gen = torch.Generator().manual_seed(seed)
    out = []
    for cost, _, _, max_cost in problems:
        s, r, c = cost.shape
        levels = max(2, int(128 * max_cost))
        q = torch.randint(0, levels, (s, r, c), generator=gen) / 64.0
        rv = (torch.arange(r) < min(r, 64)).expand(s, r).contiguous()
        cv = (torch.arange(c) < min(c, 40)).expand(s, c).contiguous()
        out.append((q.to(torch.float32).to(cost.device), rv.to(cost.device),
                    cv.to(cost.device), max_cost))
    return out


def contested_finals(template, n_streams, seed):
    """Finals arguments of the main path's sizes and scalars (those of
    ``template``, a case's ``finals_args``) in which the rectify matches
    and the reID matches contend, ``n_streams`` streams: tracks T/2 .. T
    inactive and matched to detections 0 .. T/2, tracks 0 .. T/2 active,
    unmatched and confirmed, each within a few pixels of one of detections
    0-23 (two or three tracks to a detection, near-duplicates whose IoU
    with it passes the gate); the other detections unmatched and mostly
    confident; reID costs uniform on [0, 2 max_reid_cost) in steps of 1/64
    (exact ties), 30 % gated. Returns them on the card, with a stream
    axis."""
    conf, max_reid, dup_gate, confirm = template[:4]
    t_cap = int(template[4].shape[-2])
    d_cap = int(template[8].shape[-2])
    h_cap = int(template[10].shape[-2])
    half = t_cap // 2
    rng = np.random.default_rng(seed)
    per = []
    for _ in range(n_streams):
        xy = rng.uniform(0, 1200, (d_cap, 2))
        d_tlbrs = np.concatenate([xy, xy + rng.uniform(30, 80, (d_cap, 2))],
                                 1)
        col4row = np.full(t_cap, -1, np.int32)
        col4row[half:] = np.arange(t_cap - half)
        tlbrs = np.empty((t_cap, 4))
        tlbrs[half:] = d_tlbrs[:t_cap - half] + rng.normal(0, 1,
                                                            (t_cap - half, 4))
        tlbrs[:half] = d_tlbrs[rng.integers(0, 24, half)] + np.round(
            rng.normal(0, 2, (half, 4)))
        ages = np.where(np.arange(t_cap) < half, rng.integers(0, 2, t_cap),
                        rng.integers(2, 8, t_cap)).astype(np.int32)
        hits = np.full(t_cap, confirm + 1, np.int32)
        u_det = np.arange(d_cap) >= t_cap - half
        reid = rng.integers(0, max(2, int(128 * max_reid)),
                            (h_cap, d_cap)) / 64.0
        reid[rng.uniform(size=reid.shape) < 0.3] = 1e5
        per.append((tlbrs.astype(np.float32), np.ones(t_cap, bool), ages, hits,
                    d_tlbrs.astype(np.float32),
                    rng.uniform(0.3, 1.0, d_cap).astype(np.float32),
                    reid.astype(np.float32), rng.uniform(size=h_cap) < 0.8,
                    rng.uniform(size=d_cap) < 0.2, u_det, col4row))
    return (conf, max_reid, dup_gate, confirm) + tuple(
        torch.as_tensor(np.stack([p[k] for p in per]), device='cuda')
        for k in range(11))


def finals_bound_ms(finals_args, outputs):
    """The least time an H100 could take for a finals call (``finals_args``
    with a stream axis), and what sets it. Bytes, over 3.35 TB/s: the masks'
    inputs (h_reid_ok, u_det, d_conf, occluded, t_valid, ages, hits,
    col4row) read once, the boxes of the rectify problem's live rows and
    of its live columns' detections, each live reID cost, the three outputs
    written once. Operations, over 67 TFLOP/s: 17 float32 operations a live
    rectify entry (its IoU: two maxima, two minima, two widths, both areas,
    the product, the union, the quotient, the complement), and
    ``greedy_bound_ms``'s comparisons for both problems."""
    conf, _, _, confirm = finals_args[:4]
    (tlbrs, t_valid, ages, hits, d_tlbrs, d_conf, reid, h_ok, occ, u_det,
     c4r) = (t.cpu() for t in finals_args[4:])
    reid_cols = u_det & (d_conf >= conf) & ~occ
    rect_rows = t_valid & (hits >= confirm) & (ages < 2) & (c4r < 0)
    rect_cols = (c4r >= 0) & ~(ages < 2)
    nbytes = (h_ok.numel() + u_det.numel() + 4 * d_conf.numel()
              + occ.numel() + t_valid.numel() + 12 * c4r.numel()
              + 16 * int(rect_rows.sum() + rect_cols.sum())
              + 4 * int((h_ok.sum(1) * reid_cols.sum(1)).sum())
              + sum(o.numel() * o.element_size() for o in outputs))
    ops = 17 * int((rect_rows.sum(1) * rect_cols.sum(1)).sum())
    for rows, cols, got in ((h_ok, reid_cols, outputs[1]),
                            (rect_rows, rect_cols, outputs[2])):
        for a, b, m in zip(rows.sum(1).tolist(), cols.sum(1).tolist(),
                           (got.cpu() >= 0).sum(1).tolist()):
            ops += sum((a - t) * (b - t) for t in range(m + 1))
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def cascade_live(call, eps):
    """Each stage's live rows [S, r] and live columns [S, c] on ``call``
    (``cascade_call``'s arguments): the rows of its mask, less those an
    earlier stage matched where it excludes them, and the detections no
    earlier stage took. The kernel reads a stage's cost only where both
    are live. From the plain version run a stage at a time on the CPU."""
    from fastmot_tpu_torch.ops import assignment as asg
    costs, masks, cost_of, exclude, u_det, col4row = (
        tuple(t.cpu() for t in call[0]), tuple(m.cpu() for m in call[1]),
        call[2], call[3], call[4].cpu(), call[5].cpu())
    live = []
    for k, mask in enumerate(masks):
        live.append((mask & (col4row < 0) if exclude[k] else mask, u_det))
        u_det, col4row = asg.cascade_reference(
            (costs[cost_of[k]],), (mask,), (0,), (exclude[k],), u_det,
            col4row, eps)
    return live


def cascade_bound_ms(call, live, bids):
    """The least time an H100 could take for a cascade call, and what sets
    it. Bytes: each cost entry some stage reads (a live row and a live
    column of a stage of that cost) read once, the masks, u_det and
    col4row read once and the outputs written once, over 3.35 TB/s.
    Operations, over 67 TFLOP/s: a stage's benefit, 3 an entry it reads
    (the clamp, the noise product, the sum); and each bid of the run (the
    kernel's count, ``bids`` [S, stage, phase]) a subtraction and two
    comparisons on each live column of its stage."""
    costs, masks, cost_of = call[:3]
    s, r, c = costs[0].shape
    read = [torch.zeros((s, r, c), dtype=torch.bool) for _ in costs]
    ops = 0
    for k, (rows, cols) in enumerate(live):
        entries = rows[:, :, None] & cols[:, None, :]
        read[cost_of[k]] |= entries
        ops += 3 * int(entries.sum())
        ops += 3 * int((torch.as_tensor(bids[:, k].sum(1))
                        * cols.sum(1)).sum())
    nbytes = 4 * sum(int(t.sum()) for t in read) + len(masks) * s * r \
        + 2 * (s * c + s * r * 4)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def greedy_bound_ms(problems, outputs):
    """The same for a greedy call: each problem's live costs (a valid row
    and a valid column), its masks read and its two outputs written once;
    against a comparison a live entry a round. A match kills a live row
    and a live column, so a stream's round t (of its matches and the one
    that stops) has (rows - t) (columns - t) live entries."""
    nbytes = ops = 0
    for (cost, rv, cv, _), (r4c, c4r) in zip(problems, outputs):
        rows, cols = rv.sum(1).tolist(), cv.sum(1).tolist()
        matches = (c4r >= 0).sum(1).tolist()
        nbytes += 4 * sum(a * b for a, b in zip(rows, cols)) + rv.numel() \
            + cv.numel() + 4 * (r4c.numel() + c4r.numel())
        ops += sum((a - t) * (b - t) for a, b, m in zip(rows, cols, matches)
                   for t in range(m + 1))
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def phase_assoc_solvers(main_args, multi_args, card, nvcc_out):
    """Phase 19: the cascade and greedy kernels against their plain
    versions (on the CPU and on the card), bit for bit, on phase 6's and
    phase 13's real association arguments, on contested problems at the
    kernels' full width (``stage1_case``, ``contested_greedy``) and on
    the seeded cases of tests/test_torch_assoc_solvers.py;
    ``stages_scan_core`` and ``finals_core`` on the real arguments under
    ``torch.cuda.set_sync_debug_mode('error')``;
    two calls equal; ptxas's registers and shared memory; then each
    kernel's device time (100 calls of its C entry between CUDA events,
    queued behind a sleep kernel), the wrapper's time and host time a
    call, the plain version's time on the card, beside the bound. Returns
    each kernel's cases for the kernels line."""
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import assignment as asg
    import tests.test_torch_assoc_solvers as ta
    t_phase = time.perf_counter()
    for kernel, line in ptxas_kernels(nvcc_out).items():
        log(f'assoc_solvers ptxas {kernel}: {line}')
    lib = asg.assoc_solvers_library()

    def cpu(x):
        if isinstance(x, torch.Tensor):
            return x.cpu()
        if isinstance(x, (list, tuple)):
            return type(x)(cpu(y) for y in x)
        return x

    def same(tag, got, want):
        if not all(torch.equal(g.cpu(), w.cpu()) for g, w in zip(got, want)):
            raise AssertionError(f'{tag}: the kernel differs from the plain '
                                 'version')

    # the seeded cases of the CPU tests: the kernel on the card against the
    # plain version on the CPU
    for kind in ta.AUCTION_KINDS:
        cost, rv, cv, max_iters = (ta.T(a) if isinstance(a, np.ndarray)
                                   else a for a in ta.auction_case(kind, 1))
        same(f'auction {kind}', asg.auction_lap(
            cost.cuda(), rv.cuda(), cv.cuda(), 1e-2, max_iters),
            asg.auction_lap_reference(cost, rv, cv, 1e-2, max_iters))
    for kind in ta.CASCADE_KINDS:
        args, max_iters = ta.torch_cascade(ta.cascade_case(kind, 2))
        dev = (tuple(c.cuda() for c in args[0]),
               tuple(m.cuda() for m in args[1]), *args[2:4],
               args[4].cuda(), args[5].cuda())
        same(f'cascade {kind}', asg.cascade_auction(*dev,
                                                    max_iters=max_iters),
             asg.cascade_reference(*args, max_iters=max_iters))
    for kind in ta.GREEDY_KINDS:
        problems = [(ta.T(c), ta.T(r), ta.T(v), m)
                    for c, r, v, m in ta.greedy_case(kind, 4)]
        for got, p in zip(asg.greedy_match([
                (c.cuda(), r.cuda(), v.cuda(), m)
                for c, r, v, m in problems]), problems):
            same(f'greedy {kind}', got, asg.greedy_match_reference(*p))
    for kind in ta.FINALS_KINDS:
        args = ta.torch_finals(kind)
        same(f'finals {kind}', tr.finals_core(*args[:4], *(
            t.cuda() for t in args[4:])), plain_finals(args))
    for key in ta.OUTPUT_SHA256:
        if ta.output_sha256(ta.case_outputs(lib, key, None, 'cuda')) \
                != ta.OUTPUT_SHA256[key]:
            raise AssertionError(f'{key}: the kernels differ from the '
                                 'outputs of their first design')
    log(f'assoc_solvers on the seeded cases of {ta.__name__} '
        f'({len(ta.AUCTION_KINDS)} auctions, {len(ta.CASCADE_KINDS)} '
        f'cascades, {len(ta.GREEDY_KINDS)} greedy pairs, '
        f'{len(ta.FINALS_KINDS)} finals): the kernels == the plain versions '
        f'on the CPU, bit for bit; all {len(ta.OUTPUT_SHA256)} cases\' '
        'outputs (rounds and bids too) == the first design\'s '
        '(OUTPUT_SHA256)')

    # the main paths' association arguments (phase 6's one stream, phase
    # 13's eight), then contested problems at the kernels' full width: the
    # stage-1 cascade of scripts/prof_auction.py (64 tracks, 40 detections,
    # padded to 128) at 1 and 8 streams, and greedy problems of the finals'
    # shapes and gates that take tens of matches
    eps = main_args[1]
    cases = [(case, cascade_call(scan_args, c_eps), c_eps,
              greedy_call(finals_args), (scan_args, finals_args),
              finals_args)
             for case, (scan_args, c_eps, finals_args) in (
                 ('1_stream', main_args),
                 (f'{N_STREAMS}_streams', multi_args))]
    for k, n in enumerate((1, N_STREAMS)):
        auction, call = stage1_case(n)
        cases.append((f'stage1_{n}_stream{"s" if n > 1 else ""}', call, eps,
                      contested_greedy(cases[k][3], seed=n), auction,
                      contested_finals(main_args[2], n, seed=n)))
    log('assoc_solvers launch plans: the cascade a block of 1,024 threads a '
        f'stream, {4 * (128 * 128 + 2 * 128 * 128):,} B of dynamic shared '
        'memory at 128 x 128 (a stage\'s benefit table, then both costs); '
        'the finals and the greedy entry a block of 512 threads a stream and '
        f'problem, {4 * 128 * 129:,} B of dynamic shared memory (a staged or '
        'computed cost)')

    out = {name: {} for name in ASSOC_NAMES}
    for case, call, eps, problems, extra, fin_args in cases:
        costs, masks = call[:2]
        rounds, bids = cascade_rounds(call, eps)
        got = asg.cascade_auction(*call, eps)
        again = asg.cascade_auction(*call, eps)
        same(f'cascade {case}: two calls', got, again)
        same(f'cascade {case} against the plain version on the CPU', got,
             asg.cascade_reference(*cpu(call), eps))
        same(f'cascade {case} against the plain version on the card', got,
             asg.cascade_reference(*call, eps))
        g_got = asg.greedy_match(problems)
        g_again = asg.greedy_match(problems)
        for k, p in enumerate(problems):
            same(f'greedy {case} problem {k}: two calls', g_got[k],
                 g_again[k])
            same(f'greedy {case} problem {k} against the plain version on '
                 'the CPU', g_got[k], asg.greedy_match_reference(*cpu(p)))
            same(f'greedy {case} problem {k} against the plain version on '
                 'the card', g_got[k], asg.greedy_match_reference(*p))
        if case.startswith('stage1'):
            # the one-stage auction of the same cost (auction_lap)
            a_got = asg.auction_lap(*extra, eps)
            same(f'auction {case} against the plain version on the CPU',
                 a_got, asg.auction_lap_reference(*cpu(extra), eps))
            note = (f'auction_lap == plain on the CPU, '
                    f'{int((a_got[1] >= 0).sum())} pairs')
        else:
            # no host sync in the cascade or the finals
            scan_args, finals_args = extra
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode('error')
            try:
                u2, c2 = tr.stages_scan_core(*scan_args, eps=eps)
                tr.finals_core(*finals_args[:-2], u2, c2)
            finally:
                torch.cuda.set_sync_debug_mode(0)
            torch.cuda.synchronize()
            note = ("stages_scan_core + finals_core ran under "
                    "set_sync_debug_mode('error')")
        # the finals in one launch: masks, rectify cost, both matches
        f_got = tr.finals_core(*fin_args)
        same(f'finals {case}: two calls', f_got, tr.finals_core(*fin_args))
        same(f'finals {case} against the plain version on the CPU', f_got,
             plain_finals(cpu(fin_args)))
        same(f'finals {case} against the plain version on the card', f_got,
             plain_finals(fin_args))
        note += (f'; finals == plain on the CPU and on the card, '
                 f'{int((f_got[1] >= 0).sum())} reID and '
                 f'{int((f_got[2] >= 0).sum())} rectify matches')
        matched = int((got[1] >= 0).sum())
        log(f'assoc_solvers {case}: cascade == plain on the CPU and on the '
            f'card, bit for bit ({matched} matches; rounds by stream, stage '
            f'and phase {rounds.tolist()}, sum {int(rounds.sum())}; bids '
            f'{int(bids.sum())}); greedy == plain, '
            f'{[int((c >= 0).sum()) for _, c in g_got]} matches; two calls '
            f'equal; {note}')

        outputs, c_args, keep = asg.cascade_launch_args(*call, eps)
        g_out, g_args, g_keep = asg.greedy_launch_args(problems)
        lead = fin_args[:4] + tuple(t[None] if fin_args[4].dim() == 2 else t
                                    for t in fin_args[4:])
        f_out, f_args, f_keep = asg.finals_launch_args(*lead)
        for name, entry, args, wrapper, plain, bound in (
                ('cascade_auction', lib.cascade_auction_forward, c_args,
                 lambda: asg.cascade_auction(*call, eps),
                 lambda: asg.cascade_reference(*call, eps),
                 cascade_bound_ms(call, cascade_live(call, eps), bids)),
                ('greedy_match', lib.greedy_match_forward, g_args,
                 lambda: asg.greedy_match(problems),
                 lambda: [asg.greedy_match_reference(*p) for p in problems],
                 greedy_bound_ms(problems, g_got)),
                ('greedy_finals', lib.finals_forward, f_args,
                 lambda: tr.finals_core(*fin_args),
                 lambda: plain_finals(fin_args),
                 finals_bound_ms(lead, tuple(
                     o if fin_args[4].dim() == 3 else o[None]
                     for o in f_got)))):
            dev_ms = lk_device_ms(entry, args, tag=name)
            call_ms = launches_ms(wrapper)
            host = host_ms(wrapper)
            plain_ms = wall_ms(plain, n=3, warmup=1)
            out[name][case] = {
                'ms': dev_ms, 'call_ms': call_ms, 'host_ms': host,
                'plain_ms': plain_ms, 'bound_ms': bound[0],
                'bound_by': bound[1]}
            log(f'{ASSOC_WHAT[name]} {case}: device {dev_ms * 1e3:.2f} us '
                f'a call (100 calls, one launch each); the wrapper '
                f'{call_ms * 1e3:.2f} '
                f'us a call, host {host * 1e3:.2f} us; plain on the card '
                f'{plain_ms:.3f} ms; bound {bound[0] * 1e3:.6f} us '
                f'({bound[1]}), roofline share {bound[0] / dev_ms:.6f}; '
                f'{card}')
        del keep, g_keep, f_keep
    log(f'assoc solvers phase: {time.perf_counter() - t_phase:.1f} s')
    return out


# what each of the kernels line's association entries times
ASSOC_WHAT = {
    'cascade_auction': 'cascade_auction',
    'greedy_match': "greedy_match (the greedy entry alone on the finals' "
                    'two problems)',
    'greedy_finals': 'greedy_finals (the greedy kernel\'s finals launch: '
                     'masks, rectify cost, both matches)'}


def assoc_kernel_entries(cases):
    """The kernels line's entries of the cascade kernel, the greedy kernel
    and its finals launch (the greedy kernel again, through the finals
    entry): the main path's case unsuffixed, the other cases' numbers
    suffixed."""
    replaces = {'cascade_auction': 'fastmot_tpu/ops/assignment.py:36',
                'greedy_match': 'fastmot_tpu/ops/assignment.py:237',
                'greedy_finals': 'fastmot_tpu/ops/assignment.py:237'}
    entries = []
    for name, where in replaces.items():
        entry = {'name': name, 'route': 'cuda',
                 'source': 'fastmot_tpu_torch/csrc/assoc_solvers.cu',
                 'replaces': where, 'launches': ASSOC_LAUNCHES[name],
                 'max_abs_err': 0.0, 'library_ms': None, 'case': '1_stream'}
        for case, r in cases[name].items():
            key = '' if case == '1_stream' else f'_{case}'
            entry.update({f'{k}{key}': v for k, v in r.items()})
            entry[f'roofline_share{key}'] = r['bound_ms'] / r['ms']
        entries.append(entry)
    return entries



# ---------------------------------------------------------------------------
# The NMS, the SSD merge and the commit (phase 20)
# ---------------------------------------------------------------------------

# a matched track's Kalman update in float32 operations (csrc/assoc_commit.cu
# kalman_update: the noise 8, the projected covariance 20, the Cholesky 30,
# eight columns' substitutions 256, the innovation 4, the mean 64, gain x S
# 224, its product with the gain and the subtraction 512)
KALMAN_UPDATE_OPS = 1118
KALMAN_CREATE_OPS = 40       # a created track's state
SLOT_OPS = 40                # a slot's box, IoS and bookkeeping


def suppress_bound_ms(args, keep):
    """The least time an H100 could take for an NMS call (``greedy_
    suppress``'s arguments), and what sets it: the overlap, the scores and
    the valid mask read once and the keep mask written once, over 3.35 TB/s,
    against one comparison an overlap entry (its test against the
    threshold) over 67 TFLOP/s."""
    overlap, scores, valid = args[:3]
    nbytes = 4 * (overlap.numel() + scores.numel()) + valid.numel() \
        + keep.numel()
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = overlap.numel() / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def merge_rounds(edge, valid):
    """The plain propagation's rounds (the last one changes nothing)."""
    from fastmot_tpu_torch.ops import nms_waves as nw
    lbl, rounds = None, 0
    n = edge.shape[-1]
    cur = torch.where(valid.cpu(), torch.arange(n), n)
    e = edge.cpu()
    while lbl is None or not torch.equal(lbl, cur):
        lbl, rounds = cur, rounds + 1
        cur = torch.minimum(lbl, torch.where(e, lbl[..., None, :], n)
                            .amin(dim=-1))
    assert torch.equal(cur, nw.merge_labels_reference(e, valid.cpu()))
    return rounds


def merge_bound_ms(edge, valid, labels, rounds):
    """The same for a merge call: the edges (one byte each) and the valid
    mask read once and the int64 labels written once, against one minimum
    an edge a round of the run's ``rounds``."""
    nbytes = edge.numel() + valid.numel() + 8 * labels.numel()
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = rounds * int(edge.sum()) / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def commit_bound_ms(args, outputs):
    """The same for a commit call (``assoc_commit``'s arguments): the
    state, the history, the detections' boxes, labels and valid mask and
    the cascade's outputs read once, the embeddings of the detections a
    track absorbs (from the info) read once, every output written once,
    over 3.35 TB/s; against ``KALMAN_UPDATE_OPS`` a matched track,
    ``KALMAN_CREATE_OPS`` a created one, ``SLOT_OPS`` a slot and a feature
    width of adds a merged or absorbing track, over 67 TFLOP/s."""
    import tests.test_torch_assoc_commit as tc
    states, hists, dets, embs = args[4:8]
    cascade = args[10]
    infos = outputs[2].cpu().numpy()
    s, t = states[0].shape[:2]
    h, f = hists[0].shape[1], embs.shape[2]
    nbytes = sum(x.numel() * x.element_size() for x in (
        *states, *hists, dets[0], dets[1], dets[3], *cascade, args[9]))
    nbytes += sum(x.numel() * x.element_size()
                  for x in (*outputs[0], *outputs[1], outputs[2]))
    ops = SLOT_OPS * s * t
    for k in range(s):
        i = tc.split_info(infos[k], t, h)
        m = i['match_det'] >= 0
        absorbed = (m & (i['feat_ok'] > 0) & (i['out_of_frame'] == 0)) | \
            ((i['create_det'] >= 0) & (i['reinstate_hist'] >= 0))
        nbytes += 4 * f * int(absorbed.sum())
        ops += KALMAN_UPDATE_OPS * int(m.sum()) \
            + KALMAN_CREATE_OPS * int((i['create_det'] >= 0).sum()) \
            + f * int(absorbed.sum() + (i['merge_src'] >= 0).sum())
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def batched_commit_args(args):
    """``commit_core``'s one-stream arguments as ``assoc_commit`` takes
    them, with a stream axis of one."""
    (cfg, confirm, max_age, history_size, state, hist, d_tlbrs, d_labels,
     d_conf, d_valid, d_emb, frame_id, frame_tlbr, cascade_out) = args
    return (cfg, confirm, max_age, history_size,
            tuple(a[None] for a in state), tuple(a[None] for a in hist),
            (d_tlbrs[None], d_labels[None], d_conf[None], d_valid[None]),
            d_emb[None], frame_id, frame_tlbr,
            tuple(a[None] for a in cascade_out))


def contested_commit_args(n_streams, device='cuda'):
    """tests/test_torch_assoc_commit.py's full-width contested case
    (``contested_full``: 128 slots, 128 detections, 64 history slots, 512
    features; merges, duplicates, reinstates, dropped creations,
    out-of-frame exits, steals and evictions) at ``n_streams`` streams, as
    ``assoc_commit`` takes it."""
    import tests.test_torch_assoc_commit as tc
    from fastmot_tpu_torch.kalman import KalmanConfig
    states, hists, dets, embs, casc, history_size = tc.torch_case(
        tc.commit_case('contested_full', tc.CASE_SEEDS['contested_full'],
                       streams=n_streams))
    return (KalmanConfig(), tc.CONFIRM, tc.MAX_AGE, history_size,
            tuple(a.to(device) for a in states),
            tuple(a.to(device) for a in hists),
            tuple(a.to(device) for a in dets), embs.to(device), tc.FRAME_ID,
            tc.T(tc.FRAME).to(device), tuple(a.to(device) for a in casc))


def _host(x):
    if isinstance(x, torch.Tensor):
        return x.cpu()
    if isinstance(x, (list, tuple)):
        return type(x)(_host(y) for y in x)
    return x


def phase_assoc_tail(main_args, multi_args, card, nvcc_out):
    """Phase 20: the NMS kernel, the SSD merge kernel and the commit kernel
    against their plain versions (on the CPU and on the card): the NMS and
    the merge bit for bit, the commit at tests/test_torch_assoc_commit.py's
    rules, on the seeded cases of the CPU tests (and their ``OUTPUT_SHA256``),
    on phase 6's and phase 13's real NMS and commit arguments, on the SSD
    postprocess's merge of phase 8's rows, and on contested cases (1,024
    same-label candidates in chains eight waves deep at 1 and 8 streams;
    800 SSD rows in components of one row a tile; the full-width contested
    commit at 1 and 8 streams); two calls equal; ``nms_and_gate``, the SSD
    postprocess and the commit under ``set_sync_debug_mode('error')``;
    ptxas's registers, spills and shared memory; then each kernel's device
    time (100 calls of the C entry between CUDA events, queued behind a
    sleep kernel), the wrapper's time and host time a call, the plain
    version's time on the card, beside the bound. Returns each kernel's
    cases for the kernels line."""
    import tests.test_torch_assoc_commit as tc
    import tests.test_torch_nms_kernel as tn
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.detector import (SSDDetector, nms_and_gate,
                                            ssd_postprocess_reference)
    from fastmot_tpu_torch.ops import assoc_commit as ac
    from fastmot_tpu_torch.ops import geometry as geom
    from fastmot_tpu_torch.ops import nms_waves as nw
    t_phase = time.perf_counter()
    for name in ('nms_waves', 'assoc_commit'):
        for kernel, line in ptxas_kernels(nvcc_out[name]).items():
            log(f'{name} ptxas {kernel}: {line}')
    lib_n, lib_c = nw.nms_waves_library(), ac.assoc_commit_library()

    def same(tag, got, want):
        if not torch.equal(got.cpu(), want.cpu()):
            raise AssertionError(f'{tag}: the kernel differs from the plain '
                                 'version')

    def commit_close(tag, got, want):
        flips = tc.assert_commit_close(_host(got), _host(want), tag)
        if flips:
            raise AssertionError(f'{tag}: {flips} boxes differ')
        return float((got[0][0].cpu() - want[0][0].cpu()).abs().max())

    # (a) the CPU tests' seeded cases: each kernel on the card against its
    # plain version on the CPU, and the first design's outputs
    for kind in tn.SUPPRESS_KINDS:
        ov, sc, va, th = tn.torch_case(tn.suppress_case(kind, seed=1))
        same(f'greedy_suppress {kind}', geom.greedy_suppress(
            ov.cuda(), sc.cuda(), va.cuda(), th),
            geom.greedy_suppress_reference(ov, sc, va, th))
    for kind in tn.MERGE_KINDS:
        e, va = tn.torch_case(tn.merge_case(kind, seed=2))
        same(f'merge_labels {kind}', nw.merge_labels(e.cuda(), va.cuda()),
             nw.merge_labels_reference(e, va))
    for key, want in tn.OUTPUT_SHA256.items():
        if tn.output_sha256(tn.case_outputs(lib_n, key, None, 'cuda')) \
                != want:
            raise AssertionError(f'{key}: the NMS kernels differ from the '
                                 'outputs of their first design')
    for kind in tc.CASES:
        case = tc.commit_case(kind, tc.CASE_SEEDS[kind])
        got = tc.host_commit(lib_c, case, None, 'cuda')
        commit_close(f'assoc_commit {kind}', got, tc.plain(case))
        if tc.output_sha256(got) != tc.OUTPUT_SHA256[kind]:
            raise AssertionError(f'assoc_commit {kind}: differs from the '
                                 'outputs of its first design')
    for kind in tc.EDGE_KINDS:
        case = tc.edge_case(kind)
        got = tc.host_commit(lib_c, case, None, 'cuda')
        commit_close(f'assoc_commit {kind}', got, tc.plain(case))
        if tc.output_sha256(got) != tc.EDGE_SHA256[kind]:
            raise AssertionError(f'assoc_commit {kind}: differs from the '
                                 'outputs of its first design')
    log(f'nms_waves on the seeded cases of {tn.__name__} '
        f'({len(tn.SUPPRESS_KINDS)} NMS, {len(tn.MERGE_KINDS)} merges) and '
        f'assoc_commit on those of {tc.__name__} ({len(tc.CASES)} calls and '
        f'{len(tc.EDGE_KINDS)} at the edges: {", ".join(tc.EDGE_KINDS)}): '
        'the kernels == the plain versions on the CPU (the NMS and the '
        'merge bit for bit, the commit at the CPU tests\' rules); every '
        'output == the first design\'s (OUTPUT_SHA256, EDGE_SHA256)')

    # (b) no host sync: the YOLO NMS of phase 6's frame, the SSD
    # postprocess of phase 8's rows, the commit of phase 6's and phase
    # 13's association frames
    ssd_rows = tuple(torch.as_tensor(a, device='cuda') for a in
                     synthetic_ssd_rows(np.random.default_rng(42)))
    ssd_scalars = (0.5, 120000, 0.6, 0.5)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        nms_and_gate(*main_args['nms'])
        SSDDetector._postprocess_device(*ssd_rows, *ssd_scalars)
        tr.commit_core(*main_args['commit'])
        tr.commit_batch(*multi_args['commit'])
    finally:
        torch.cuda.set_sync_debug_mode(0)
    torch.cuda.synchronize()
    log("nms_and_gate, SSDDetector._postprocess_device, commit_core and "
        "commit_batch ran under set_sync_debug_mode('error')")

    # (c) the cases timed: the main paths' and contested; the merge's on
    # phase 8's rows as the plain SSD postprocess makes them (the card's
    # SSD path runs its own kernels)
    merges = []
    real_merge = nw.merge_labels
    with mock.patch.object(nw, 'merge_labels', lambda e, v: (
            merges.append((e, v)), real_merge(e, v))[1]):
        ssd_postprocess_reference(*ssd_rows, *ssd_scalars)
    contested = [tuple(torch.as_tensor(a, device='cuda')
                       for a in tn.contested_nms(seed=s)) for s in range(8)]

    def contested_suppress(n):
        rows = contested[:n]
        over = torch.stack([geom.diou_matrix(b, 0.6) for b, _, _ in rows])
        return (over, torch.stack([r[1] for r in rows]),
                torch.stack([r[2] for r in rows]), 0.5)
    suppress_cases = {'1_stream': main_args['suppress'],
                      f'{N_STREAMS}_streams': multi_args['suppress'],
                      'contested_1_stream': contested_suppress(1),
                      f'contested_{N_STREAMS}_streams':
                          contested_suppress(N_STREAMS)}
    merge_cases = {'ssd_rows': merges[0], 'contested': tuple(
        torch.as_tensor(a, device='cuda') for a in tn.contested_merge(0))}
    commit_cases = {'1_stream': batched_commit_args(main_args['commit']),
                    f'{N_STREAMS}_streams': multi_args['commit'],
                    'contested_1_stream': contested_commit_args(1),
                    f'contested_{N_STREAMS}_streams':
                        contested_commit_args(N_STREAMS)}
    log('nms_waves launch plans: the NMS a pack launch of ceil(N / 32) x '
        'problems blocks of min(1,024, N rounded up to 32) threads, then '
        'the waves launch, a block a problem, with ceil(N / 32) x N x 4 + '
        f'N x 4 B of dynamic shared memory ({4 * (32 * 1024 + 1024):,} B at '
        'N = 1,024); the merge a block a problem, ceil(N / 32) x N x 4 + '
        f'N x 8 B ({4 * (25 * 800 + 1600):,} B at N = 800); assoc_commit '
        'the decisions a block of 512 threads a stream, the inputs staged '
        f'in {ac.staged_bytes(128, 128, 64):,} B of dynamic shared memory '
        'at T = D = 128, H = 64, the matched Kalman updates 8 lanes a '
        'slot, then the rows launch of ceil((T + H) / 8) blocks of 256 '
        'threads a stream, a warp a row')

    out = {name: {} for name in TAIL_NAMES if name != 'ssd_postprocess'}
    for case, a in suppress_cases.items():
        keep = geom.greedy_suppress(*a)
        same(f'greedy_suppress {case}: two calls', keep,
             geom.greedy_suppress(*a))
        host_a = _host(a)
        same(f'greedy_suppress {case} against the plain version on the CPU',
             keep, geom.greedy_suppress_reference(*host_a))
        same(f'greedy_suppress {case} against the plain version on the '
             'card', keep, geom.greedy_suppress_reference(*a))
        waves = tn.plain_waves(*host_a)
        log(f'greedy_suppress {case}: {tuple(a[0].shape)} overlap, '
            f'{int(a[2].sum())} valid, {int(keep.sum())} kept in {waves} '
            'waves; == plain on the CPU and on the card, bit for bit; two '
            'calls equal')
        k_out, s_args, s_keep = nw.suppress_launch_args(*a)
        out['greedy_suppress'][case] = time_kernel(
            'greedy_suppress', case, lib_n.greedy_suppress_forward, s_args,
            lambda: geom.greedy_suppress(*a),
            lambda: geom.greedy_suppress_reference(*a),
            suppress_bound_ms(a, keep), card)
        out['greedy_suppress'][case]['max_abs_err'] = 0.0
        del s_keep
    for case, (e, va) in merge_cases.items():
        lbl = nw.merge_labels(e, va)
        same(f'merge_labels {case}: two calls', lbl, nw.merge_labels(e, va))
        same(f'merge_labels {case} against the plain version on the CPU',
             lbl, nw.merge_labels_reference(e.cpu(), va.cpu()))
        same(f'merge_labels {case} against the plain version on the card',
             lbl, nw.merge_labels_reference(e, va))
        rounds = merge_rounds(e, va)
        log(f'merge_labels {case}: {tuple(e.shape)} edges, '
            f'{int(e.sum())} set, {int(va.sum())} valid rows in '
            f'{len(torch.unique(lbl[va]))} components after {rounds} '
            'rounds; == plain on the CPU and on the card, bit for bit; two '
            'calls equal')
        m_out, m_args, m_keep = nw.merge_launch_args(e, va)
        out['merge_labels'][case] = time_kernel(
            'merge_labels', case, lib_n.merge_labels_forward, m_args,
            lambda: nw.merge_labels(e, va),
            lambda: nw.merge_labels_reference(e, va),
            merge_bound_ms(e, va, lbl, rounds), card)
        out['merge_labels'][case]['max_abs_err'] = 0.0
        del m_keep
    for case, a in commit_cases.items():
        got = ac.assoc_commit(*a)
        again = ac.assoc_commit(*a)
        for x, y in zip(got[0] + got[1] + (got[2],),
                        again[0] + again[1] + (again[2],)):
            same(f'assoc_commit {case}: two calls', x, y)
        err = commit_close(f'assoc_commit {case} against the plain version '
                           'on the CPU', got, ac.commit_reference(*_host(a)))
        commit_close(f'assoc_commit {case} against the plain version on '
                     'the card', got, ac.commit_reference(*a))
        t, h = got[0][0].shape[1], got[1][0].shape[1]
        log(f'assoc_commit {case}: {got[0][0].shape[0]} streams x {t} '
            f'slots; {tc.branches(_host(got))}; == plain on the '
            'CPU and on the card (integers, booleans and feature sums '
            f'equal; means within {err:.2e} px); two calls equal')
        outputs, c_args = ac.commit_launch_args(*a)
        out['assoc_commit'][case] = time_kernel(
            'assoc_commit', case, lib_c.assoc_commit_forward, c_args,
            lambda: ac.assoc_commit(*a), lambda: ac.commit_reference(*a),
            commit_bound_ms(a, got), card)
        out['assoc_commit'][case]['max_abs_err'] = err
        del outputs
    log(f'nms and commit phase: {time.perf_counter() - t_phase:.1f} s')
    return out


def time_kernel(name, case, entry, args, wrapper, plain, bound, card):
    """A kernel's device time a call (100 calls of its C entry between CUDA
    events behind a sleep kernel), its wrapper's time and host time a call
    (and of that the C entry's host time), the plain version's time on the
    card, logged beside ``bound``."""
    dev_ms = lk_device_ms(entry, args, tag=name)
    call_ms = launches_ms(wrapper)
    host = host_ms(wrapper)
    entry_host = host_ms(lambda: entry(*args))
    plain_ms = wall_ms(plain, n=3, warmup=1)
    log(f'{name} {case}: device {dev_ms * 1e3:.2f} us a call (100 calls); '
        f'the wrapper {call_ms * 1e3:.2f} us a call, host {host * 1e3:.2f} '
        f'us (of it the C entry {entry_host * 1e3:.2f} us); plain on the '
        f'card {plain_ms:.3f} ms; bound '
        f'{bound[0] * 1e3:.6f} us ({bound[1]}), roofline share '
        f'{bound[0] / dev_ms:.6f}; {card}')
    return {'ms': dev_ms, 'call_ms': call_ms, 'host_ms': host,
            'entry_host_ms': entry_host, 'plain_ms': plain_ms,
            'bound_ms': bound[0], 'bound_by': bound[1]}


def tail_kernel_entries(cases):
    """The kernels line's entries of the NMS, merge, SSD postprocess and
    commit kernels: the main path's case unsuffixed (the NMS's and the
    commit's one stream of phase 6, the merge's SSD rows of phase 8, the
    SSD postprocess's decoded rows of phase 9), the other cases' numbers
    suffixed. The generic NMS and merge kernels run on no main path (the
    YOLO and SSD postprocesses have their own kernels): their launches
    are 0."""
    where = {'greedy_suppress': ('fastmot_tpu_torch/csrc/nms_waves.cu',
                                 'fastmot_tpu/ops/geometry.py:186',
                                 '1_stream'),
             'merge_labels': ('fastmot_tpu_torch/csrc/nms_waves.cu',
                              'fastmot_tpu/detector.py:511', 'ssd_rows'),
             'ssd_postprocess': ('fastmot_tpu_torch/csrc/nms_waves.cu',
                                 'fastmot_tpu/detector.py:435', 'ssd_main'),
             'assoc_commit': ('fastmot_tpu_torch/csrc/assoc_commit.cu',
                              'fastmot_tpu/tracker.py:779', '1_stream')}
    entries = []
    for name, (source, replaces, main_case) in where.items():
        entry = {'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': TAIL_LAUNCHES[name],
                 'on_main_path': TAIL_LAUNCHES[name] > 0,
                 'library_ms': None, 'case': main_case}
        for case, r in cases[name].items():
            key = '' if case == main_case else f'_{case}'
            entry.update({f'{k}{key}': v for k, v in r.items()})
            entry[f'roofline_share{key}'] = r['bound_ms'] / r['ms']
        entries.append(entry)
    return entries


# ---------------------------------------------------------------------------
# The SSD postprocess (phase 22)
# ---------------------------------------------------------------------------

def ssd_post_bound_ms(arrays, scalars):
    """The least time an H100 could take for an SSD postprocess call
    (CPU tensors of ``SSDDetector._postprocess_device``'s arguments): the
    decoded rows, tiles, scale and label mask read once and the outputs
    written once, over 3.35 TB/s, against ``IOU_OPS`` for each pair that
    needs a quotient, over 67 TFLOP/s: each same-label pair of valid rows of
    one tile (the NMS's IoU, each pair once) and each same-label pair of
    kept rows of different tiles whose boxes intersect (the merge's IoM).
    Returns (ms, what sets it) and the two pair counts."""
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch.ops import geometry as geom
    from fastmot_tpu_torch.ops import nms_waves as nw
    seen = {}
    real_suppress, real_merge = geom.greedy_suppress, nw.merge_labels
    real_iom = geom.iom_matrix
    with mock.patch.object(geom, 'greedy_suppress', lambda ov, sc, va, th: (
            seen.update(valid=va), real_suppress(ov, sc, va, th))[1]), \
            mock.patch.object(nw, 'merge_labels', lambda e, va: (
                seen.update(kept=va), real_merge(e, va))[1]), \
            mock.patch.object(geom, 'iom_matrix', lambda t: (
                seen.update(tlbr=t), real_iom(t))[1]):
        outputs = detmod.ssd_postprocess_reference(*arrays, *scalars)
    t, k = arrays[0].shape[:2]
    tile = torch.arange(t * k) // k
    label = arrays[0].reshape(-1, 7)[:, 1].to(torch.int32)
    same = (label[:, None] == label[None, :]) & torch.ones(
        t * k, t * k, dtype=torch.bool).triu(1)
    same_tile = tile[:, None] == tile[None, :]
    valid, kept = seen['valid'], seen['kept']
    nms_pairs = int((same & same_tile & valid[:, None]
                     & valid[None, :]).sum())
    inter = geom._inter_area(seen['tlbr'][:, None, :],
                             seen['tlbr'][None, :, :]) > 0
    merge_pairs = int((same & ~same_tile & kept[:, None] & kept[None, :]
                       & inter).sum())
    nbytes = sum(a.numel() * a.element_size()
                 for a in (*arrays, *outputs))
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = IOU_OPS * (nms_pairs + merge_pairs) / PEAK_F32 * 1e3
    return (max(bytes_ms, ops_ms),
            'bytes' if bytes_ms >= ops_ms else 'operations'), \
        (nms_pairs, merge_pairs)


def phase_ssd_post(real, card, nvcc_out):
    """Phase 22: the SSD postprocess kernels (csrc/nms_waves.cu
    ``ssd_postprocess_forward``) against their plain version
    (``detector.ssd_postprocess_reference``) on the CPU and on the card,
    every output bit for bit: the seeded cases of
    tests/test_torch_ssd_post.py with their ``OUTPUT_SHA256``; phase 9's
    own decoded rows (``real``), phase 8's rows and the crowded full-width
    rows, each run through ``SSDDetector._postprocess_device`` under
    ``set_sync_debug_mode('error')`` with the [n, n] functions of the plain
    version (``bbox_ious``, ``iom_matrix``, ``greedy_suppress``,
    ``merge_labels``) made to raise, its peak of allocated memory under an
    [n, n] bool matrix, its kernels, as ``torch.profiler`` counts them, the
    two of ``ssd_postprocess_forward``, and its torch ops allocations and
    views only (``dispatched_ops``); two calls equal; ptxas's
    registers, spills and shared memory; each case's device time (100 calls
    of the C entry between CUDA events, behind a sleep kernel), wrapper
    and host time a call, the plain version's time on the card and the
    bound (``ssd_post_bound_ms``). Returns the cases' numbers for the
    kernels line."""
    import tests.test_torch_ssd_post as ts
    from fastmot_tpu_torch.detector import (MAX_DETS, SSDDetector,
                                            ssd_postprocess_reference)
    from fastmot_tpu_torch.ops import geometry as geom
    from fastmot_tpu_torch.ops import nms_waves as nw
    t_phase = time.perf_counter()
    for kernel, line in ptxas_kernels(nvcc_out['nms_waves']).items():
        if 'ssd' in kernel:
            log(f'nms_waves ptxas {kernel}: {line}')
    lib = nw.nms_waves_library()
    for kind in ts.KINDS:
        arrays, scalars = ts.case(kind)
        got = ts.host_post(lib, tuple(a.cuda() for a in arrays), scalars,
                           None)
        ts.assert_same(got, ts.plain(arrays, scalars), kind)
        if ts.output_sha256(got) != ts.OUTPUT_SHA256[kind]:
            raise AssertionError(f'ssd_postprocess {kind}: differs from the '
                                 'recorded outputs')
    log(f'ssd_postprocess on the seeded cases of {ts.__name__} '
        f'({", ".join(ts.KINDS)}): == the plain version on the CPU bit for '
        'bit, and == OUTPUT_SHA256')

    cases = {'ssd_main': real,
             'phase8_rows': (synthetic_ssd_rows(np.random.default_rng(42)),
                             (0.5, 120000, 0.6, 0.5)),
             'crowded': (ts.crowded_rows(0), ts.SCALARS)}
    matrix_fns = [(geom, 'bbox_ious'), (geom, 'iom_matrix'),
                  (geom, 'greedy_suppress'), (nw, 'merge_labels')]
    out = {}
    for case, (arrays, scalars) in cases.items():
        on_card = tuple(torch.as_tensor(a).cuda() for a in arrays)
        host = tuple(a.cpu() for a in on_card)
        n = on_card[0].shape[0] * on_card[0].shape[1]
        torch.cuda.synchronize()
        before = torch.cuda.memory_allocated()
        torch.cuda.reset_peak_memory_stats()
        patches = [mock.patch.object(m, name, side_effect=AssertionError(
            f'{name} ran on the card path')) for m, name in matrix_fns]
        for patch in patches:
            patch.start()
        torch.cuda.set_sync_debug_mode('error')
        try:
            got = SSDDetector._postprocess_device(*on_card, *scalars)
            torch.cuda.set_sync_debug_mode(0)
            kernels, _, names = profiled_kernels(
                lambda: SSDDetector._postprocess_device(*on_card, *scalars),
                expect=2)
        finally:
            torch.cuda.set_sync_debug_mode(0)
            for patch in patches:
                patch.stop()
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() - before
        if peak >= n * n:
            raise AssertionError(f'ssd_postprocess {case}: {peak} B '
                                 f'allocated, an [n, n] bool is {n * n} B')
        ops = dispatched_ops(
            lambda: SSDDetector._postprocess_device(*on_card, *scalars))
        # every kernel traced is one of the two (a trace may lack some of
        # the launches: the dispatch log shows that no torch op launched
        # one)
        if kernels > 2 or len(names) != 2 \
                or not all('ssd_' in x for x in names) \
                or not ops <= {'empty', 'view', 'as_strided', 'detach'}:
            raise AssertionError(f'ssd_postprocess {case}: {kernels} kernels '
                                 f'a call ({sorted(names)}), torch ops '
                                 f'{sorted(ops)}; expected its 2 kernels and '
                                 'no torch op but allocations and views')
        ts.assert_same(got, ssd_postprocess_reference(*host, *scalars),
                       f'{case} against the plain version on the CPU')
        ts.assert_same(got, ssd_postprocess_reference(*on_card, *scalars),
                       f'{case} against the plain version on the card')
        ts.assert_same(got, SSDDetector._postprocess_device(*on_card,
                                                            *scalars),
                       f'{case}: two calls')
        valid, after, waves, rounds, span, kept, edges = ts.plain_stats(
            host, scalars)
        bound, pairs = ssd_post_bound_ms(host, scalars)
        log(f'ssd_postprocess {case}: {n} rows, {valid} valid, {after} after '
            f'the NMS ({waves} waves), {kept} kept of {min(n, MAX_DETS)} '
            f'out ({edges} merge edges, the plain merge {rounds} rounds, a '
            f'component over {span} tiles at most; {pairs[0]} IoU pairs, '
            f'{pairs[1]} IoM pairs); '
            f'== plain on the CPU and on the card, bit for bit; two calls '
            f'equal; no host sync; {kernels:g} kernels a call in the '
            f'profiler\'s trace ({", ".join(sorted(names))}'
            + ('' if kernels == 2 else '; the trace lacked some launches')
            + f'), torch ops {sorted(ops)}; {peak} B allocated at the peak')
        outputs, args, inputs = nw.ssd_postprocess_launch_args(
            *on_card, *scalars, min(n, MAX_DETS))
        out[case] = time_kernel(
            'ssd_postprocess', case, lib.ssd_postprocess_forward, args,
            lambda: SSDDetector._postprocess_device(*on_card, *scalars),
            lambda: ssd_postprocess_reference(*on_card, *scalars), bound,
            card)
        out[case]['max_abs_err'] = 0.0
        del inputs
    log(f'ssd postprocess phase: {time.perf_counter() - t_phase:.1f} s')
    return out


# ---------------------------------------------------------------------------
# The YOLO postprocess, the costs and the ReID input (phase 21)
# ---------------------------------------------------------------------------

# float32 operations of one same-label pair's IoU test in csrc/nms_waves.cu
# diou_exceeds (the two overlaps 8, the intersection 1, the union 2, the
# quotient 1, the test 1), and of its whole DIoU test (diou_entry, the
# power counted as one), which only a pair whose IoU passes goes on to
IOU_OPS, DIOU_OPS = 13, 45
# of one track-detection entry of csrc/assoc_costs.cu past the product:
# the distance 5, the Mahalanobis substitutions and sum 27, the fusion and
# the gates 7, the IoU cost and its gate 16
COST_ENTRY_OPS = 55
# of one detection pair's IoS test, and of one output value of
# csrc/reid_crops.cu (two column passes, the row pass, the normalisation)
IOS_OPS, CROP_OPS = 12, 12


def nms_select_bound_ms(args, outputs):
    """The least time an H100 could take for ``nms_and_gate`` on the card
    (``args`` its arguments), and what sets it: the decoded rows, the label
    mask, the scale and the offset read once and the outputs written once,
    over 3.35 TB/s, against what this run's data needs over 67 TFLOP/s: 2
    operations a row (the score and its gate); ``IOU_OPS`` a same-label
    pair of the valid selected candidates, each pair once (the DIoU is
    symmetric), and the rest of ``DIOU_OPS`` for a pair whose IoU exceeds
    the threshold (recomputed from the plain version's candidates); one
    comparison an overlap entry a wave the run took (from the plain
    version's overlap)."""
    import tests.test_torch_nms_kernel as tn
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch.ops import geometry as geom
    det_out = args[0]
    nbytes = det_out.numel() * 4 + args[1].numel() + 24 + sum(
        x.numel() * x.element_size() for x in outputs)
    captured, real_diou, real_suppress = {}, geom.diou_matrix, \
        geom.greedy_suppress
    with mock.patch.object(geom, 'diou_matrix', lambda t, beta: (
            captured.setdefault('tlbr', t), real_diou(t, beta))[1]), \
            mock.patch.object(geom, 'greedy_suppress', lambda *a: (
                captured.setdefault('suppress', a), real_suppress(*a))[1]):
        unpatched(detmod, 'nms_and_gate_reference')(*args)
    overlap, scores, valid, thresh = (
        x.cpu() if isinstance(x, torch.Tensor) else x
        for x in captured['suppress'])
    tlbr, k = captured['tlbr'].cpu(), overlap.shape[-1]
    # the overlap is -inf where the labels differ
    pairs = (overlap != -float('inf')) & valid[..., :, None] \
        & valid[..., None, :] & torch.ones(k, k, dtype=torch.bool).triu(1)
    passing = pairs & ~(geom.bbox_ious(tlbr, tlbr) <= thresh)
    waves = tn.plain_waves(overlap, scores, valid, thresh)
    ops = 2 * det_out.numel() // 7 + IOU_OPS * int(pairs.sum()) \
        + (DIOU_OPS - IOU_OPS) * int(passing.sum()) \
        + waves * overlap.numel()
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def assoc_costs_bound_ms(args, outputs):
    """The least time an H100 could take for a costs call (``args`` as
    phase 21 holds them: params, states, hists, dets, embeddings), and
    what sets it: of the inputs what the costs read (a track's 4 mean
    entries, the 10 of its projected covariance's lower triangle, box,
    validity, age, hits, label, feature sum and count; a history row's
    features, count, label and validity; a detection's box, label,
    validity and embedding) once and every output once, over 3.35 TB/s,
    against the appearance products (2 F a track or history row and a
    detection), the rows' normalisation (3 F a row), ``COST_ENTRY_OPS`` a
    track entry and ``IOS_OPS`` a detection pair, over 67 TFLOP/s."""
    _, states, hists, dets, emb = args[:5]
    s, t = states[0].shape[:2]
    h, f = hists[0].shape[1:]
    d = dets[0].shape[1]
    nbytes = s * (t * (4 + 10 + 4 + 1 + 1 + 1 + 1 + f + 1)
                  + h * (f + 3) + d * (4 + 2 + f)) * 4 + sum(
        x.numel() * x.element_size() for x in outputs)
    ops = s * (2 * (t + h) * d * f + 3 * (t + h) * f + COST_ENTRY_OPS * t * d
               + IOS_OPS * d * d)
    bytes_ms, ops_ms = nbytes / PEAK_BYTES * 1e3, ops / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def reid_crops_bound_ms(args, out):
    """The least time an H100 could take for a ReID-input call (``args``
    ``reid_crops``'), and what sets it: the frame pixels the taps read (a
    crop's distinct source rows by its distinct source columns, at most
    the frames) once and the output written once (by its element size,
    float32 or bf16), over 3.35 TB/s, against ``CROP_OPS`` an output value
    over 67 TFLOP/s."""
    frame, tlbrs, (oh, ow) = args
    frames = frame if frame.dim() == 4 else frame[None]
    boxes = (tlbrs if frame.dim() == 4 else tlbrs[None]).reshape(-1, 4)
    fh, fw = frames.shape[1:3]
    b = torch.clamp(torch.floor(boxes.float().cpu()), min=0.0)

    def taps(start, size, n_out, n_in):
        pos = torch.clamp(start[:, None] + ((torch.arange(n_out) + 0.5)
                                            * (1.0 / n_out))[None]
                          * size[:, None] - 0.5, 0.0, n_in - 1.0)
        i0 = torch.floor(pos).long()
        return [len(torch.unique(torch.cat([r, torch.clamp(r + 1,
                                                           max=n_in - 1)])))
                for r in i0]
    cols = taps(b[:, 0], b[:, 2] - b[:, 0] + 1.0, ow, fw)
    rows = taps(b[:, 1], b[:, 3] - b[:, 1] + 1.0, oh, fh)
    read = min(sum(r * c for r, c in zip(rows, cols)),
               frames.shape[0] * fh * fw) * 3 * frames.element_size()
    nbytes = read + out.numel() * out.element_size()
    bytes_ms = nbytes / PEAK_BYTES * 1e3
    ops_ms = CROP_OPS * out.numel() / PEAK_F32 * 1e3
    return max(bytes_ms, ops_ms), ('bytes' if bytes_ms >= ops_ms
                                   else 'operations')


def crop_bands(args):
    """How the ReID-input kernel runs a call's bands of output rows
    (csrc/reid_crops.cu, ``reid_crops.band_rows``): how many keep their
    column pass in shared memory (their source rows span at most
    ``span_cap``) of them; the others run it a pixel."""
    from fastmot_tpu_torch.ops import reid_crops as rc
    frame, tlbrs, (oh, ow) = args
    frames = frame if frame.dim() == 4 else frame[None]
    boxes = (tlbrs if frame.dim() == 4 else tlbrs[None]).reshape(-1, 4)
    fh = frames.shape[1]
    b = torch.clamp(torch.floor(boxes.float().cpu()), min=0.0)
    h = b[:, 3] - b[:, 1] + 1.0
    pos = torch.clamp(b[:, 1:2] + ((torch.arange(oh) + 0.5) * (1.0 / oh))
                      [None] * h[:, None] - 0.5, 0.0, fh - 1.0)
    i0 = torch.nan_to_num(torch.floor(pos)).long()
    i1 = torch.clamp(i0 + 1, max=fh - 1)
    band = rc.band_rows(len(b), oh)
    cap = rc.span_cap(ow, band)
    kept = n = 0
    for r0 in range(0, oh, band):
        last = min(r0 + band - 1, oh - 1)
        lo = torch.minimum(i0[:, r0], i0[:, last])
        hi = torch.maximum(i1[:, r0], i1[:, last])
        kept += int((hi - lo + 1 <= cap).sum())
        n += len(b)
    return (f'{kept} of {n} bands of {band} rows keep their column '
            'pass')


def plain_costs(params, states, hists, dets, emb, emb_cap=None, app=None):
    """``tracker.assoc_costs_reference`` under ``vmap`` over the streams,
    on the device of the arguments."""
    from fastmot_tpu_torch import tracker as tr
    ref = unpatched(tr, 'assoc_costs_reference')

    def one(state, hist, det, e, *a):
        return ref(*params, state, hist, *det, e, emb_cap=emb_cap,
                   appearance=a or None)
    return torch.func.vmap(one)(states, hists, dets, emb,
                                *(app if app is not None else ()))


def downstream_integers(params, states, hists, dets, emb, costs, eps,
                        finals_scalars, commit_scalars, frame_rect):
    """The cascade (``stages_scan_core``), the finals (``finals_core``)
    and the commit (``commit_batch``) of every stream fed ``costs``: their
    integer outputs (col4row, u_det_conf, reid_c4r, rect_c4r, and the
    commit's integer state, history and info)."""
    from fastmot_tpu_torch import tracker as tr
    (cost, iou_cost, reid_cost, occluded, h_reid_ok, depth_masks, base_ia,
     base_u, u_det, col4row) = costs
    n_depth = len(depth_masks)
    u2, c2 = tr.stages_scan_core(n_depth, cost, iou_cost, depth_masks,
                                 base_ia, base_u, u_det, col4row, eps=eps)
    finals = tr.finals_core(*finals_scalars, params[-1], states[2],
                            states[3], states[4], states[5], dets[0],
                            dets[2], reid_cost, h_reid_ok, occluded, u2, c2)
    new_state, new_hist, info = tr.commit_batch(
        params[0], params[-1], *commit_scalars, states, hists, dets, emb,
        37, frame_rect, (occluded, c2) + tuple(finals))
    return [c2, *finals] + [a for a in (*new_state, *new_hist, info)
                            if not a.is_floating_point()]


def phase_frame_kernels(main_args, multi_args, card, nvcc_out):
    """Phase 21: the YOLO postprocess kernels (``nms_select``), the costs
    kernel and the ReID-input kernel against their plain versions (on the
    CPU and on the card), at 1 and 8 streams: on phase 6's and phase 13's
    real arguments, on contested cases (the NMS: 16,128 rows of which more
    than 1,024 pass the gates, tied scores, three labels through an
    all-true mask, rows failing each gate; the costs: 128 tracks and 128
    detections with a full history, occluded detections, tracks without
    features, and the stage-1 regime; the crops: boxes past every frame
    edge, 1-pixel boxes and boxes larger than the frame) and on the CPU
    tests' seeded cases and their ``OUTPUT_SHA256``; the NMS and the crops
    bit for bit, the costs at tests/test_torch_assoc_costs.py's rules; the
    cascade, the finals and the commit fed the kernel's costs give the
    plain costs' integers on phase 6's and phase 13's frames and the
    stage-1 cases; glibc's and the CPU's ``pow`` against the card's; a
    whole association frame (net, NMS, update) at 1 and 8 streams under
    ``set_sync_debug_mode('error')``; then each kernel's device time, the
    wrapper's time and host time a call and the plain version's time
    beside its bound. Returns each kernel's cases for the kernels line."""
    import ctypes.util
    import tests.test_torch_assoc_costs as tcost
    import tests.test_torch_nms_select as tsel
    import tests.test_torch_reid_crops as tcrop
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch.ops import assoc_costs as acost
    from fastmot_tpu_torch.ops import nms_waves as nw
    from fastmot_tpu_torch.ops import reid_crops as rc
    t_phase = time.perf_counter()
    for name in ('nms_waves', 'assoc_costs', 'reid_crops'):
        for kernel, line in ptxas_kernels(nvcc_out[name]).items():
            if kernel in FRAME_KERNELS:
                log(f'{name} ptxas {kernel}: {line}')
    lib_n, lib_c = nw.nms_waves_library(), acost.assoc_costs_library()
    lib_r = rc.reid_crops_library()
    plain_nms = unpatched(detmod, 'nms_and_gate_reference')
    plain_crops = unpatched(rc, 'reid_crops_reference')

    def same(tag, got, want):
        for g, w in zip(got if isinstance(got, tuple) else (got,),
                        want if isinstance(want, tuple) else (want,)):
            if g.dtype != w.dtype or not torch.equal(g.cpu(), w.cpu()):
                raise AssertionError(f'{tag}: the kernel differs from the '
                                     'plain version')

    # (a) the CPU tests' seeded cases: each kernel on the card against its
    # plain version on the CPU, and the first design's outputs
    for kind in tsel.KINDS:
        case = tsel.torch_case(tsel.select_case(kind, seed=1))
        got = tsel.host_select(lib_n, case, None, 'cuda')
        same(f'nms_select {kind}', got, tsel.plain(case))
        if tsel.output_sha256(got) != tsel.OUTPUT_SHA256[kind]:
            raise AssertionError(f'nms_select {kind}: differs from the '
                                 'outputs of its first design')
    for kind in tcrop.KINDS:
        frame, tlbrs, hw = (tcrop.T(a) if isinstance(a, np.ndarray) else a
                            for a in tcrop.crop_case(kind, seed=1))
        got = tcrop.host_crops(lib_r, frame.cuda(), tlbrs.cuda(), hw, None)
        same(f'reid_crops {kind}', got, plain_crops(frame, tlbrs, hw))
        if tcrop.output_sha256(got) != tcrop.OUTPUT_SHA256[kind]:
            raise AssertionError(f'reid_crops {kind}: differs from the '
                                 'outputs of its first design')
        same(f'reid_crops {kind} in bf16', tcrop.host_crops(
            lib_r, frame.cuda(), tlbrs.cuda(), hw, None, torch.bfloat16),
            plain_crops(frame, tlbrs, hw, torch.bfloat16))
    # the crops' edge cases: NaN where the plain version (on the boxes it
    # can index by) is NaN, equal elsewhere, and the sha256 a host build of
    # the first design's source gave, NaNs made canonical
    for kind in tcrop.EDGE_KINDS:
        frame, tlbrs, hw = (tcrop.T(a) if isinstance(a, np.ndarray) else a
                            for a in tcrop.edge_crop_case(kind))
        for dtype in (torch.float32, torch.bfloat16):
            got = tcrop.host_crops(lib_r, frame.cuda(), tlbrs.cuda(), hw,
                                   None, dtype).cpu()
            want = tcrop.edge_plain(frame, tlbrs, hw, kind, dtype)
            if not (torch.equal(torch.isnan(got), torch.isnan(want))
                    and torch.equal(torch.nan_to_num(got),
                                    torch.nan_to_num(want))):
                raise AssertionError(f'reid_crops {kind} ({dtype}): the '
                                     'kernel differs from the plain version')
            if dtype == torch.float32 and \
                    tcrop.edge_sha256(got) != tcrop.EDGE_SHA256[kind]:
                raise AssertionError(f'reid_crops {kind}: differs from the '
                                     'outputs of its first design')
    cost_err = {'cost': 0.0, 'reid_cost': 0.0}
    for kind in tcost.CASES:
        cpu = tcost.torch_case(tcost.costs_case(kind, tcost.CASE_SEEDS[kind]))
        on_card = tuple(tuple(a.cuda() for a in x) if isinstance(x, tuple)
                        else x.cuda() for x in cpu)
        # the split path's distances as the CPU computes them, which the
        # recorded sha256 read
        app = tcost.given_appearance(kind, cpu)
        got = tcost.host_costs(lib_c, kind, on_card, 'cuda',
                               None if app is None
                               else tuple(x.cuda() for x in app))
        err = tcost.assert_costs_close(
            got, tcost.plain(kind, cpu), f'assoc_costs {kind}',
            tcost.plain_appearance(kind, cpu),
            euclidean=tcost.CASES[kind].metric == 'euclidean')
        for k, v in err.items():
            cost_err[k] = max(cost_err.get(k, 0.0), v)
        if tcost.output_sha256(got) != tcost.OUTPUT_SHA256[kind]:
            raise AssertionError(f'assoc_costs {kind}: differs from the '
                                 'outputs of its first design')
    # the select's and the costs' edge cases, against the plain versions
    # on the CPU and a host build of the first design's source
    for kind in tsel.EDGE_KINDS:
        det, mask, scale, offset, keep, n_out = tsel.edge_case(kind)
        case = tsel.torch_case((det, mask, scale, offset))
        got = tsel.host_select(lib_n, case, None, 'cuda', keep, n_out)
        same(f'nms_select {kind}', got, tsel.plain(case, keep, n_out))
        if tsel.output_sha256(got) != tsel.EDGE_SHA256[kind]:
            raise AssertionError(f'nms_select {kind}: differs from the '
                                 'outputs of its first design')
    for kind in tcost.EDGE_CASES:
        cpu = tcost.torch_case(tcost.costs_case(kind, tcost.CASE_SEEDS[kind]))
        app = tcost.given_appearance(kind, cpu)
        got = tcost.host_costs(lib_c, kind, tuple(
            tuple(a.cuda() for a in x) if isinstance(x, tuple) else x.cuda()
            for x in cpu), 'cuda',
            None if app is None else tuple(x.cuda() for x in app))
        err = tcost.assert_costs_close(
            got, tcost.plain(kind, cpu), f'assoc_costs {kind}',
            tcost.plain_appearance(kind, cpu),
            euclidean=tcost.ALL_CASES[kind].metric == 'euclidean')
        for k, v in err.items():
            cost_err[k] = max(cost_err.get(k, 0.0), v)
        if tcost.output_sha256(got) != tcost.EDGE_SHA256[kind]:
            raise AssertionError(f'assoc_costs {kind}: differs from the '
                                 'outputs of its first design')
    log(f'nms_select on the seeded cases of {tsel.__name__} '
        f'({len(tsel.KINDS)} + {len(tsel.EDGE_KINDS)} at the select\'s '
        f'edges), reid_crops on those of {tcrop.__name__} '
        f'({len(tcrop.KINDS)} + {len(tcrop.EDGE_KINDS)} at the edges, each '
        'in float32 and bf16): == the plain versions on the CPU, bit for '
        f'bit; assoc_costs on those of {tcost.__name__} '
        f'({len(tcost.CASES)} + {len(tcost.EDGE_CASES)} at the edges): '
        f'masks, occlusion, IoU cost and gates == the plain version on the '
        f'CPU, the fused and reID costs within {cost_err["cost"]:.3g} / '
        f'{cost_err["reid_cost"]:.3g}; every output == the first design\'s '
        '(OUTPUT_SHA256, EDGE_SHA256)')

    # (b) the card's pow against glibc's powf (the host build's) and the
    # CPU's: the DIoU's (d / c) ** 0.6 on the main frame's ratios and on a
    # uniform sweep of [0, 1]
    libm = ctypes.CDLL(ctypes.util.find_library('m'))
    libm.powf.argtypes = [ctypes.c_float, ctypes.c_float]
    libm.powf.restype = ctypes.c_float
    gen = torch.Generator().manual_seed(0)
    ratio = torch.cat([torch.rand(200_000, generator=gen),
                       torch.linspace(0, 1, 50_001)])
    card_pow = (ratio.cuda() ** 0.6).cpu()
    cpu_pow = ratio ** 0.6
    glibc = torch.tensor([libm.powf(float(x), 0.6) for x in ratio.tolist()],
                         dtype=torch.float32)

    def ulps(a, b):
        d = (a.view(torch.int32).long() - b.view(torch.int32).long()).abs()
        return int((d > 0).sum()), int(d.max())
    (n_glibc, u_glibc), (n_cpu, u_cpu) = ulps(glibc, card_pow), \
        ulps(cpu_pow, card_pow)
    log(f'pow(x, 0.6) on {ratio.numel():,} ratios in [0, 1]: glibc powf '
        f'(the host build) differs from the card\'s on {n_glibc:,} (at most '
        f'{u_glibc} ulp), torch\'s CPU pow (the plain version on the CPU) '
        f'on {n_cpu:,} (at most {u_cpu} ulp)')

    # (c) the real frames' and the contested cases, at 1 and 8 streams
    rng = np.random.default_rng(21)
    scale = torch.tensor([1280.0, 720.0, 1280.0, 720.0], device='cuda')
    mask3 = torch.ones(3, dtype=torch.bool, device='cuda')

    def contested_nms(n_streams):
        rows = np.stack([tsel.clustered_rows(rng, 16128, 3, 120)
                         for _ in range(n_streams)])
        det = torch.as_tensor(rows, device='cuda')
        return (det if n_streams > 1 else det[0], mask3, 0.25, 0.5, 800000,
                1.2, scale, torch.zeros(2, device='cuda'))
    nms_cases = {'1_stream': main_args['nms'],
                 f'{N_STREAMS}_streams': multi_args['nms'],
                 'contested_1_stream': contested_nms(1),
                 f'contested_{N_STREAMS}_streams': contested_nms(N_STREAMS)}

    def contested_costs(kind, n_streams):
        case = tcost.torch_case(tcost.costs_case(
            kind, tcost.CASE_SEEDS[kind], streams=n_streams), 'cuda')
        return (tcost.params(kind),) + case + (tcost.CASES[kind].emb_cap,)
    costs_cases = {'1_stream': main_args['costs'],
                   f'{N_STREAMS}_streams': multi_args['costs'],
                   'contested_1_stream': contested_costs('full_width', 1),
                   f'contested_{N_STREAMS}_streams':
                       contested_costs('full_width', N_STREAMS),
                   'stage1_1_stream': contested_costs('stage1', 1),
                   f'stage1_{N_STREAMS}_streams':
                       contested_costs('stage1', N_STREAMS)}

    def contested_crops(n_streams, n_boxes):
        frames = torch.as_tensor(np.stack(textured_frames(SIZE, n_streams,
                                                          seed=21)),
                                 device='cuda')
        boxes = np.stack([tcrop.edge_boxes(rng, n_boxes, SIZE[1], SIZE[0])
                          for _ in range(n_streams)])
        boxes = torch.as_tensor(boxes, device='cuda')
        return (frames[0], boxes[0], main_args['crops'][2]) \
            if n_streams == 1 else (frames, boxes, main_args['crops'][2])
    crops_cases = {'1_stream': main_args['crops'],
                   f'{N_STREAMS}_streams': multi_args['crops'],
                   'contested_1_stream': contested_crops(1, 64),
                   f'contested_{N_STREAMS}_streams':
                       contested_crops(N_STREAMS, 128)}
    log('phase 21 launch plans: nms_select a cluster of min(8, ceil(N / '
        '256)) select blocks of 1,024 threads a stream (8 at N = 16,128), '
        'then by programmatic dependent launch the dominance bits in '
        'ceil(K / 32) x ceil(K / 32) x streams blocks of 256 threads, then '
        'a waves and order block of min(K, 1,024) threads a '
        'stream with ceil(K / 32) x K x 4 B of dynamic shared memory; '
        'assoc_costs a prep launch of 1 + ceil((T + H) / 4) + ceil(D / 8) '
        'blocks of 256 threads a stream (the factors, 48 row blocks and 16 '
        'detection blocks at T = D = 128, H = 64), then by programmatic '
        'dependent launch (ceil(T / 16) + ceil(H / 16)) x ceil(D / 16) '
        'tile blocks of 128 threads a stream (96) with 67,584 B of dynamic '
        'shared memory (four chunk stages); reid_crops a block of 128 '
        'threads a band of 8 output rows of a crop (16 above '
        f'{rc.BAND_SWITCH_ROWS:,} output rows), 4 pixels a thread, the '
        'column taps, the row taps and the column pass of up to 16 (32) '
        'source rows in dynamic shared memory '
        f'({rc.dynamic_smem(128, 8):,} / {rc.dynamic_smem(128, 16):,} B at '
        '256 x 128)')

    out = {name: {} for name in FRAME_NAMES}
    for case, a in nms_cases.items():
        got = detmod.nms_and_gate(*a)
        with mock.patch.object(detmod.geom, 'diou_matrix',
                               side_effect=AssertionError(
                                   'nms_select built a DIoU matrix')):
            same(f'nms_select {case}: two calls', got,
                 detmod.nms_and_gate(*a))
        same(f'nms_select {case} against the plain version on the card',
             got, plain_nms(*a))
        if case.startswith('contested') or case == '1_stream':
            same(f'nms_select {case} against the plain version on the CPU',
                 got, plain_nms(*_host(a)))
        passed = int((a[0][..., 4] * a[0][..., 6] >= a[2]).sum())
        log(f'nms_select {case}: {tuple(a[0].shape)} rows, {passed} past '
            f'the confidence gate, {int(got[3].sum())} kept; == plain on '
            'the card (and on the CPU), bit for bit, all four outputs in '
            'order; two calls equal; no DIoU matrix')
        k = min(detmod.MAX_RAW, a[0].shape[-2])
        outputs, s_args, keep = nw.nms_select_launch_args(
            *a, k, min(k, detmod.MAX_DETS))
        out['nms_select'][case] = time_kernel(
            'nms_select', case, lib_n.nms_select_forward, s_args,
            lambda: detmod.nms_and_gate(*a), lambda: plain_nms(*a),
            nms_select_bound_ms(a, outputs), card)
        out['nms_select'][case]['max_abs_err'] = 0.0
        del keep
    flips = 0
    for case, a in costs_cases.items():
        got = acost.assoc_costs(*a[0], *a[1:])
        same(f'assoc_costs {case}: two calls', tuple(tcost.flat(got)),
             tuple(tcost.flat(acost.assoc_costs(*a[0], *a[1:]))))
        kind = 'stage1' if case.startswith('stage1') else 'full_width'
        app = tcost.plain_appearance(kind, a[1:5], a[6] if len(a) > 6
                                     else None)
        err = tcost.assert_costs_close(
            got, plain_costs(*a), f'assoc_costs {case} against the plain '
            'version on the card', app,
            euclidean=a[0][1].name == 'EUCLIDEAN')
        # the cascade, the finals and the commit on each side's costs
        if case.startswith('stage1') or case in ('1_stream',
                                                 f'{N_STREAMS}_streams'):
            params = a[0]
            frame_rect = main_args['commit'][12]
            ints_k = downstream_integers(*a[:5], got, 1e-2, (0.5, 0.45, 0.2),
                                         (6, 50), frame_rect)
            ints_p = downstream_integers(*a[:5], plain_costs(*a), 1e-2,
                                         (0.5, 0.45, 0.2), (6, 50),
                                         frame_rect)
            n_flip = sum(int((x != y).sum()) for x, y in zip(ints_k, ints_p))
            matches = int((ints_k[0] >= 0).sum())
            log(f'assoc_costs {case}: the cascade, the finals and the commit '
                f'from the kernel\'s costs and from the plain costs: '
                f'{matches} cascade matches, {n_flip} integer outputs '
                'differ')
            flips += n_flip
            del params
        live = int((got[0] < 1e5).sum())
        log(f'assoc_costs {case}: {tuple(got[0].shape)} costs, {live} live; '
            'masks, occlusion, IoU cost and gates == plain on the card, bit '
            f'for bit; fused and reID costs within {err["cost"]:.3g} / '
            f'{err["reid_cost"]:.3g}, squared appearance distances within '
            f'{err.get("sq", 0.0):.3g}; two calls equal')
        outputs, c_args, keep = acost.assoc_costs_launch_args(
            *a[0], *a[1:5], *a[5:])
        out['assoc_costs'][case] = time_kernel(
            'assoc_costs', case, lib_c.assoc_costs_forward, c_args,
            lambda: acost.assoc_costs(*a[0], *a[1:]), lambda: plain_costs(*a),
            assoc_costs_bound_ms(a, outputs), card)
        out['assoc_costs'][case]['max_abs_err'] = max(err['cost'],
                                                      err['reid_cost'])
        del keep
    if flips:
        raise AssertionError(f'assoc_costs: {flips} integer outputs of the '
                             'cascade, the finals and the commit differ '
                             'between the kernel\'s and the plain costs')
    for case, a in crops_cases.items():
        got = rc.reid_crops(*a)
        same(f'reid_crops {case}: two calls', got, rc.reid_crops(*a))
        same(f'reid_crops {case} against the plain version on the card',
             got, plain_crops(*a))
        if case in ('1_stream', 'contested_1_stream'):
            same(f'reid_crops {case} against the plain version on the CPU',
                 got, plain_crops(*_host(a)))
        # bf16, what the float OSNet reads: the float32 output rounded
        got16 = rc.reid_crops(*a, torch.bfloat16)
        same(f'reid_crops {case} in bf16 against the float32 output '
             'rounded', got16, got.to(torch.bfloat16))
        same(f'reid_crops {case} in bf16 against the plain version on the '
             'card', got16, plain_crops(*a, torch.bfloat16))
        log(f'reid_crops {case}: {tuple(got.shape)} == plain on the card '
            '(and on the CPU), bit for bit, in float32 and bf16; two calls '
            f'equal; {crop_bands(a)}')
        for dtype, key in ((torch.float32, case),
                           (torch.bfloat16, f'bf16_{case}')):
            outputs, r_args, keep = rc.reid_crops_launch_args(*a, dtype)
            out['reid_crops'][key] = time_kernel(
                'reid_crops', key, lib_r.reid_crops_forward, r_args,
                lambda: rc.reid_crops(*a, dtype),
                lambda: plain_crops(*a, dtype),
                reid_crops_bound_ms(a, outputs), card)
            out['reid_crops'][key]['max_abs_err'] = 0.0
            del keep

    # OSNet-x0.25's embeddings of the main frame's crops from bf16 crops
    # (what extract_core passes the float OSNet) equal those of the float32
    # crops bit for bit; a second float32 run is the control
    from fastmot_tpu_torch.models import registry
    net = registry.ReIDModel.get_model('OSNet025').init_params('cuda')
    with torch.no_grad():
        x32 = rc.reid_crops(*main_args['crops'])
        emb = [net(x32), net(rc.reid_crops(*main_args['crops'],
                                           torch.bfloat16)), net(x32)]
    torch.cuda.synchronize()
    if not torch.equal(emb[0], emb[2]):
        raise AssertionError('OSNet025 gives two embeddings of one input')
    if not torch.equal(emb[0], emb[1]):
        raise AssertionError('OSNet025: the bf16 crops\' embeddings differ '
                             'from the float32 crops\'')
    log(f'OSNet025 on the main frame\'s {x32.shape[0]} crops: embeddings '
        'of the bf16 crops == of the float32 crops, bit for bit')

    # (d) a whole association frame, at 1 and 8 streams, with no host sync
    for tag, whole in (('1 stream', main_args['whole']),
                       (f'{N_STREAMS} streams', multi_args['whole'])):
        whole()
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode('error')
        try:
            whole()
        finally:
            torch.cuda.set_sync_debug_mode(0)
        torch.cuda.synchronize()
        log(f'a whole association frame ({tag}: the net, the NMS, the '
            "crops, OSNet, the costs, the cascade, the finals, the commit) "
            "ran under set_sync_debug_mode('error')")
    log(f'phase 21: {time.perf_counter() - t_phase:.1f} s')
    return out


def frame_kernel_entries(cases):
    """The kernels line's entries of the YOLO postprocess, costs and
    ReID-input kernels: the main path's case (phase 6's one stream)
    unsuffixed, the other cases' numbers suffixed."""
    where = {'nms_select': ('fastmot_tpu_torch/csrc/nms_waves.cu',
                            'fastmot_tpu/detector.py:128'),
             'assoc_costs': ('fastmot_tpu_torch/csrc/assoc_costs.cu',
                             'fastmot_tpu/tracker.py:560'),
             'reid_crops': ('fastmot_tpu_torch/csrc/reid_crops.cu',
                            'fastmot_tpu/feature_extractor.py:34')}
    entries = []
    for name, (source, replaces) in where.items():
        entry = {'name': name, 'route': 'cuda', 'source': source,
                 'replaces': replaces, 'launches': FRAME_LAUNCHES[name],
                 'library_ms': None, 'case': '1_stream'}
        for case, r in cases[name].items():
            key = '' if case == '1_stream' else f'_{case}'
            entry.update({f'{k}{key}': v for k, v in r.items()})
            entry[f'roofline_share{key}'] = r['bound_ms'] / r['ms']
        entries.append(entry)
    return entries


def main():
    from fastmot_tpu_torch import detector as detmod
    from fastmot_tpu_torch import tracker as tr
    from fastmot_tpu_torch.ops import assignment as asg
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops import geometry as geom
    from fastmot_tpu_torch.ops import nms_waves as nw
    from fastmot_tpu_torch.ops import reid_crops as rc
    t0 = time.perf_counter()
    name, card = phase_device()
    nvcc_out = phase_build()
    kern = phase_kernel()
    worst_abs = max(kern['max_abs_err'],
                    phase_kernel(MULTI_BATCH)['max_abs_err'])
    phase_osnet()
    # the main paths run the plain LK and the plain gap commit on the CPU
    # only (phase 5's CPU runs); on the card a kernel, every time, and the
    # gap commit's RANSAC draws are made there, not on the host (but on the
    # legacy path and in phase 15 (a), which draw on the host on purpose)
    plain_on_card = Counter()
    plain_lk = fk.lk_pyramidal_reference
    PLAIN.update(gap_commit_core=tr.gap_commit_core,
                 ransac_draws_batch=fk.ransac_draws_batch,
                 preprocess_reference=fk.preprocess_reference,
                 gap_points_core=tr.gap_points_core,
                 gap_points_batch=tr.gap_points_batch,
                 auction_lap_reference=asg.auction_lap_reference,
                 cascade_reference=asg.cascade_reference,
                 greedy_match_reference=asg.greedy_match_reference,
                 finals_reference=tr.finals_reference,
                 greedy_suppress_reference=geom.greedy_suppress_reference,
                 merge_labels_reference=nw.merge_labels_reference,
                 commit_part=tr.commit_part,
                 nms_and_gate_reference=detmod.nms_and_gate_reference,
                 ssd_postprocess_reference=detmod.ssd_postprocess_reference,
                 assoc_costs_reference=tr.assoc_costs_reference,
                 reid_crops_reference=rc.reid_crops_reference)
    host_draws = [False]

    def counted_plain_lk(prev, cur, pts, *args, **kwargs):
        plain_on_card['lk_pyramidal_reference'] += pts.is_cuda
        return plain_lk(prev, cur, pts, *args, **kwargs)

    def counted_plain_commit(*args):
        plain_on_card['gap_commit_core'] += args[4][0].is_cuda
        return PLAIN['gap_commit_core'](*args)

    def counted_draws(seeds, f_cap, device):
        if not host_draws[0]:
            plain_on_card['ransac_draws_batch'] += \
                torch.device(device).type == 'cuda'
        return PLAIN['ransac_draws_batch'](seeds, f_cap, device)

    def counted(name, is_cuda):
        def plain(*args):
            plain_on_card[name] += is_cuda(*args)
            return PLAIN[name](*args)
        return plain

    def drawing_on_the_host(phase, *args):
        host_draws[0] = True
        try:
            return phase(*args)
        finally:
            host_draws[0] = False
    lk_launches = Counter()
    with mock.patch.object(fk, 'lk_pyramidal_reference', counted_plain_lk), \
            mock.patch.object(tr, 'gap_commit_core', counted_plain_commit), \
            mock.patch.object(fk, 'ransac_draws_batch', counted_draws), \
            mock.patch.object(fk, 'preprocess_reference', counted(
                'preprocess_reference', lambda spec, f: f.is_cuda)), \
            mock.patch.object(tr, 'gap_points_core', counted(
                'gap_points_core', lambda spec, st, *a: st[2].is_cuda)), \
            mock.patch.object(tr, 'gap_points_batch', counted(
                'gap_points_batch', lambda spec, f_cap, st, pre:
                st[2].is_cuda)), \
            mock.patch.object(asg, 'auction_lap_reference', counted(
                'auction_lap_reference', lambda cost, *a: cost.is_cuda)), \
            mock.patch.object(asg, 'cascade_reference', counted(
                'cascade_reference', lambda costs, *a: costs[0].is_cuda)), \
            mock.patch.object(asg, 'greedy_match_reference', counted(
                'greedy_match_reference', lambda cost, *a: cost.is_cuda)), \
            mock.patch.object(tr, 'finals_reference', counted(
                'finals_reference', lambda *a: a[4].is_cuda)), \
            mock.patch.object(geom, 'greedy_suppress_reference', counted(
                'greedy_suppress_reference', lambda ov, *a: ov.is_cuda)), \
            mock.patch.object(nw, 'merge_labels_reference', counted(
                'merge_labels_reference', lambda edge, v: edge.is_cuda)), \
            mock.patch.object(tr, 'commit_part', counted(
                'commit_part', lambda *a: a[4][0].is_cuda)), \
            mock.patch.object(detmod, 'nms_and_gate_reference', counted(
                'nms_and_gate_reference', lambda det, *a: det.is_cuda)), \
            mock.patch.object(detmod, 'ssd_postprocess_reference', counted(
                'ssd_postprocess_reference', lambda det, *a: det.is_cuda)), \
            mock.patch.object(tr, 'assoc_costs_reference', counted(
                'assoc_costs_reference', lambda *a: a[11].is_cuda)), \
            mock.patch.object(rc, 'reid_crops_reference', counted(
                'reid_crops_reference', lambda frame, *a: frame.is_cuda)):
        for counts in (phase_reference(), phase_stream_reference(),
                       drawing_on_the_host(phase_legacy_api)):
            lk_launches.update(counts)
        main_run = phase_main_path(stages=True)
        launches, float_ms = main_run['osblock'], main_run['median']
        log_assoc_stages('main path', main_run['assoc stages'],
                         main_run['assoc syncs'], main_run['assoc rounds'],
                         card)
        phase_zoo()
        phase_ssd_postprocess()
        ssd = phase_main_path('SSD', 'ssd main path', card=card)
        launches += ssd['osblock']
        phase_int8_conv()
        phase_osnet_int8()
        int8 = phase_main_path(tag='int8 main path', int8=True)
        for run in (main_run, ssd, int8):
            lk_launches.update(run['lk'])
        log(f'main path step median: float {float_ms:.3f} ms, int8 '
            f'{int8["median"]:.3f} ms')
        frames, dets = multi_stream_inputs()
        (multi_launches, multi_lk, rows, multi_ms, gap_ms, gap8_args,
         flow8_args, assoc8_args, tail8_args) = phase_multi_stream(
             float_ms, frames, dets, card)
        launches += multi_launches
        mesh_launches, mesh_lk = phase_mesh(frames, dets, rows, multi_ms)
        launches += mesh_launches
        lk_launches.update(multi_lk)
        lk_launches.update(mesh_lk)
        launches += drawing_on_the_host(phase_gaps, rows, gap_ms)
    if any(plain_on_card.values()):
        raise AssertionError(f'plain versions ran on the card in phases '
                             f'5-15: {dict(plain_on_card)}')
    if not all(lk_launches[d] for d in fk.LK_ENTRIES):
        raise AssertionError(f'phases 5-15: the LK kernels launched '
                             f'{dict(lk_launches)} times; each must launch')
    log(f'phases 5-15: the LK kernels launched {dict(lk_launches)} times on '
        'the main paths, the plain LK 0 times on the card; the gap-commit '
        f'kernel {sum(GAP_LAUNCHES.values())} times ({dict(GAP_LAUNCHES)}), '
        'the plain gap commit and the host draws for the card 0 times; the '
        f'preprocess and gap-points kernels {dict(FLOW_LAUNCHES)} times, '
        'their plain versions 0 times on the card; the cascade and greedy '
        f'kernels {dict(ASSOC_LAUNCHES)} times, the plain solvers 0 times '
        f'on the card; the NMS, merge, SSD postprocess and commit kernels '
        f'{dict(TAIL_LAUNCHES)} times, the plain NMS, merge, SSD '
        'postprocess and commit 0 times on the card; the YOLO postprocess, '
        'costs and ReID-input '
        f'kernels {dict(FRAME_LAUNCHES)} times, their plain versions 0 times '
        'on the card')
    if not all(FRAME_LAUNCHES[n] for n in FRAME_NAMES):
        raise AssertionError(f'phases 5-14: the YOLO postprocess, costs and '
                             f'ReID-input kernels launched '
                             f'{dict(FRAME_LAUNCHES)} times; each must '
                             'launch')
    if not TAIL_LAUNCHES['ssd_postprocess'] \
            or not TAIL_LAUNCHES['assoc_commit']:
        raise AssertionError(f'phases 5-14: the SSD postprocess and commit '
                             f'kernels launched {dict(TAIL_LAUNCHES)} times; '
                             'each must launch')
    cases, lanes = phase_lk(main_run['gap stages'], gap_ms, card)
    gap_cases = phase_gap_commit(main_run['gap args'], gap8_args, card,
                                 nvcc_out['gap_commit'])
    flow_cases = phase_flow_kernels(main_run['flow args'], flow8_args, card,
                                    nvcc_out)
    assoc_cases = phase_assoc_solvers(main_run['assoc args'], assoc8_args,
                                      card, nvcc_out['assoc_solvers'])
    tail_cases = phase_assoc_tail(main_run['tail args'], tail8_args, card,
                                  nvcc_out)
    frame_cases = phase_frame_kernels(main_run['frame args'],
                                      STAGE_ARGS.pop('frame8'), card,
                                      nvcc_out)
    tail_cases['ssd_postprocess'] = phase_ssd_post(STAGE_ARGS.pop('ssd'),
                                                   card, nvcc_out)
    log(f'every phase passed in {time.perf_counter() - t0:.1f} s')
    print(json.dumps({'kernels': [{
        'name': 'osblock', 'route': 'cuda',
        'source': 'fastmot_tpu_torch/csrc/osnet_block.cu',
        'replaces': 'fastmot_tpu/ops/osnet_block.py:213',
        'launches': launches, 'max_abs_err': worst_abs,
        'ms': kern['ms'], 'plain_ms': kern['plain_ms'],
        'bound_ms': kern['bound_ms'], 'bound_by': kern['bound_by'],
        'library_ms': None,
        'roofline_share': kern['roofline_share']}]
        + lk_kernel_entries(cases, lk_launches, lanes)
        + [gap_kernel_entry(gap_cases)]
        + flow_kernel_entries(flow_cases)
        + assoc_kernel_entries(assoc_cases)
        + tail_kernel_entries(tail_cases)
        + frame_kernel_entries(frame_cases)}))
    print(json.dumps({'ok': True, 'device': {
        'platform': 'gpu', 'kind': name,
        'count': torch.cuda.device_count()}}))


if __name__ == '__main__':
    sys.path.insert(0, str(ROOT))
    main()
