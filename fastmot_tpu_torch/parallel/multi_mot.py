"""Multi-stream MOT: several video streams tracked on one card (port of
``fastmot_tpu/parallel/multi_mot.py``, BASELINE config 5).

Every stage runs once per frame for all S streams:

  * the detector is ONE network forward over the S letterboxed frames
    [S, ih, iw, 3], one head decode and one NMS loop with a leading stream
    axis (``BatchedYOLODetector``);
  * ReID crops from every stream share ONE OSNet call on [S * D] crops
    (``FeatureExtractor.extract_async_batch``);
  * the tracker state carries the stream axis (``StreamTracker``).

All streams share the detector-skip schedule of the single-stream
``MOT``. With ``mesh`` (``parallel.make_stream_mesh``) the stream axis is
sharded over the ranks of ``'streams'``: ``step`` takes the global batch
of S frames and stages only this rank's ``local_streams``, whose detector,
ReID (``S_local * 128`` crops in one OSNet call) and tracker run on this
rank; the ranks on ``'model'`` of one block run the same streams, as the
JAX package replicates them. Under int8 with dynamic ranges each stream's
crops take their own input ranges (the JAX package's ``vmap``), and the
detector's range spans all streams' frames: each native conv's input
absmax is all-reduced (MAX) over ``'streams'``, the global range of the
JAX package's sharded batch.
"""
from __future__ import annotations

import numpy as np
import torch

from ..detector import YOLODetector, make_detections
from ..device import torch_device
from ..feature_extractor import FeatureExtractor
from ..models.quantize import dynamic_ranges
from ..tracker import cfg_kwargs
from ..utils import profiler
from ..utils.profiler import Profiler
from ..utils.staging import FrameStager
from .stream_tracker import StreamTracker


class BatchedYOLODetector:
    """YOLO detector over a stream axis: one network batch for S frames.
    ``range_group``: the process group over which a dynamic int8 input
    range is all-reduced (the ranks holding the other streams; None: this
    batch alone)."""

    def __init__(self, size, class_ids, n_streams, model='YOLOv4',
                 conf_thresh=0.25, nms_thresh=0.5, max_area=800000,
                 min_aspect_ratio=1.2, quantize=None, calib_cache=None,
                 device='cuda', range_group=None):
        # the single-stream detector's geometry, module and postprocess
        self._single = YOLODetector(size, class_ids, model, conf_thresh,
                                    nms_thresh, max_area, min_aspect_ratio,
                                    quantize, calib_cache, device=device)
        self.n_streams = n_streams
        self.device = self._single.device
        self.range_group = range_group
        self._pending = None

    def detect_async(self, frames):
        """``frames`` [S, H, W, 3] uint8 BGR."""
        with Profiler('detector'), \
                dynamic_ranges(process_group=self.range_group):
            self._pending = self._single.run(
                torch.as_tensor(frames, device=self.device))

    def postprocess(self):
        """Per-stream host recarrays, from four device-to-host reads."""
        with Profiler('detector.post'):
            profiler.count('host_syncs', len(self._pending))
            tlbr, label, conf, valid = (t.cpu().numpy()
                                        for t in self._pending)
        self._pending = None
        out = []
        for s in range(tlbr.shape[0]):
            keep = valid[s]
            out.append(make_detections(tlbr[s][keep].astype(float),
                                       label[s][keep].astype(int),
                                       conf[s][keep].astype(float)))
        return out

    def postprocess_device_batch(self):
        """Padded per-stream device tensors (tlbr [S, D, 4], label, conf,
        valid [S, D]), no host sync."""
        with Profiler('detector.post'):
            out, self._pending = self._pending, None
        return out


class MultiStreamMOT:
    """S independent streams, every stage batched over the stream axis.

    API: ``step(frames)`` where ``frames`` is a length-S list of BGR
    frames (or an [S, H, W, 3] array or tensor); ``visible_tracks(s)`` per
    stream; ``reset(cap_dt)``; ``sync()`` flushes deferred host
    bookkeeping; ``trackers`` the per-stream host mirrors (this rank's
    ``local_streams`` under a mesh; ``sync`` and ``visible_tracks`` are
    then collective over ``'streams'``)."""

    def __init__(self, size, n_streams,
                 detector_frame_skip=5,
                 class_ids=(1,),
                 yolo_detector_cfg=None,
                 feature_extractor_cfgs=None,
                 tracker_cfg=None,
                 device='cuda', mesh=None):
        self.size = size
        self.n_streams = n_streams
        self.device = torch_device(device)
        assert detector_frame_skip >= 1
        self.detector_frame_skip = detector_frame_skip
        self.class_ids = tuple(np.unique(class_ids))

        if feature_extractor_cfgs is None:
            feature_extractor_cfgs = ({'model': 'OSNet025'},)
        self.extractor = FeatureExtractor(
            device=self.device, **cfg_kwargs(feature_extractor_cfgs[0]))
        self.stream_tracker = StreamTracker(
            size, self.extractor.metric, n_streams, device=self.device,
            mesh=mesh, **cfg_kwargs(tracker_cfg))
        self.detector = BatchedYOLODetector(
            size, self.class_ids, len(self.local_streams),
            device=self.device,
            range_group=None if mesh is None else mesh.get_group('streams'),
            **cfg_kwargs(yolo_detector_cfg))
        self._stage = FrameStager(self.device)
        self.frame_count = 0

    @property
    def local_streams(self):
        """The global indices of the streams this rank tracks."""
        return self.stream_tracker.local_streams

    @property
    def trackers(self):
        """Per-stream host mirrors (presentation shells)."""
        return self.stream_tracker.trackers

    def visible_tracks(self, stream: int):
        return self.stream_tracker.visible_tracks(stream)

    def sync(self):
        self.stream_tracker.sync()

    def reset(self, cap_dt):
        self.frame_count = 0
        self.stream_tracker.reset(cap_dt)

    def _stage_frames(self, frames):
        """This rank's streams of the global batch, on the device
        (``FrameStager``: host frames through a pinned ring, no host
        sync)."""
        assert len(frames) == self.n_streams
        mine = self.local_streams
        return self._stage(frames[mine.start:mine.stop])

    @torch.no_grad()
    def step(self, frames):
        f = self.frame_count
        kind = 'init' if f == 0 else \
            'assoc' if f % self.detector_frame_skip == 0 else 'gap'
        with Profiler('step', step=f, kind=kind):
            frames_dev = self._stage_frames(frames)
            if kind == 'init':
                self.detector.detect_async(frames_dev)
                all_dets = self.detector.postprocess()
                self.stream_tracker.init(frames_dev, all_dets)
            elif kind == 'assoc':
                self.detector.detect_async(frames_dev)
                # the gap step of every stream, then the detections
                self.stream_tracker.track(frames_dev)
                det_b = self.detector.postprocess_device_batch()
                self.extractor.extract_async_batch(
                    frames_dev, det_b[0], det_b[3])
                emb_b = self.extractor.postprocess_device()
                # one pass for ALL streams' associations; the decisions
                # replay into the host mirrors at the next sync()
                self.stream_tracker.update_device(f, det_b, emb_b)
            else:
                self.stream_tracker.track(frames_dev)
        self.frame_count += 1
