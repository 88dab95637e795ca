"""Top-level MOT orchestrator (port of ``fastmot_tpu/mot.py``).

Same public API (``MOT(size, **cfg)``, ``step``, ``step_batch``,
``reset``, ``visible_tracks``, ``flush_tracks``, ``frame_count``) and the
same detector-skip schedule: the detector and the ReID extractor run every
``detector_frame_skip`` frames, KLT flow + Kalman fill the gap frames.
``device`` places every component (default ``'cuda'``, which raises
without a card; ``'cpu'`` runs on the CPU); frames are ``[H, W, 3]`` uint8 BGR.
OpenCV is imported only when drawing.
"""
from __future__ import annotations

import enum
import logging
from types import SimpleNamespace

import numpy as np
import torch

from .detector import PublicDetector
from .device import torch_device
from .feature_extractor import FeatureExtractor
from .tracker import MultiTracker, cfg_kwargs
from .utils.profiler import Profiler
from .utils.staging import FrameStager

LOGGER = logging.getLogger(__name__)

# the program's spans, in the order ``print_timing_info`` prints them
SPANS = ('step', 'stage', 'detector', 'detector.post', 'flow', 'reid',
         'assoc', 'sync', 'sync.fetch', 'sync.replay')


class DetectorType(enum.Enum):
    SSD = 0
    YOLO = 1
    PUBLIC = 2


class MOT:
    """Integrates detection, feature extraction, and tracking."""

    def __init__(self, size,
                 detector_type='YOLO',
                 detector_frame_skip=5,
                 class_ids=(1,),
                 ssd_detector_cfg=None,
                 yolo_detector_cfg=None,
                 public_detector_cfg=None,
                 feature_extractor_cfgs=None,
                 tracker_cfg=None,
                 visualizer_cfg=None,
                 draw=False,
                 device='cuda'):
        self.size = size
        self.device = torch_device(device)
        self.detector_type = DetectorType[detector_type.upper()]
        assert detector_frame_skip >= 1
        self.detector_frame_skip = detector_frame_skip
        self.class_ids = tuple(np.unique(class_ids))
        self.draw = draw

        if feature_extractor_cfgs is None:
            feature_extractor_cfgs = (SimpleNamespace(),)
        if len(feature_extractor_cfgs) != len(self.class_ids):
            raise ValueError(
                'Number of feature extractors must match length of class IDs')

        LOGGER.info('Loading detector model...')
        if self.detector_type == DetectorType.SSD:
            from .detector import SSDDetector
            self.detector = SSDDetector(self.size, self.class_ids,
                                        device=self.device,
                                        **cfg_kwargs(ssd_detector_cfg))
        elif self.detector_type == DetectorType.YOLO:
            from .detector import YOLODetector
            self.detector = YOLODetector(self.size, self.class_ids,
                                         device=self.device,
                                         **cfg_kwargs(yolo_detector_cfg))
        else:
            self.detector = PublicDetector(self.size, self.class_ids,
                                           self.detector_frame_skip,
                                           device=self.device,
                                           **cfg_kwargs(public_detector_cfg))

        LOGGER.info('Loading feature extractor models...')
        self.extractors = [FeatureExtractor(device=self.device,
                                            **cfg_kwargs(cfg))
                           for cfg in feature_extractor_cfgs]
        self.tracker = MultiTracker(self.size, self.extractors[0].metric,
                                    device=self.device,
                                    **cfg_kwargs(tracker_cfg))
        self.visualizer = None
        if draw:
            from .utils.visualization import Visualizer
            self.visualizer = Visualizer(**cfg_kwargs(visualizer_cfg))
        # a fresh device tensor a frame: buffered gap frames outlive the
        # caller's (reused) array
        self._stage = FrameStager(self.device)
        self.frame_count = 0
        # gap frames buffered by step_batch across calls; flushed by the
        # next detection frame, step(), visible_tracks/flush_tracks or reset
        self._gap_buf = []

    def visible_tracks(self):
        """Confirmed and active tracks (syncs the host mirrors)."""
        self._flush_gaps()
        self.tracker.sync()
        return (track for track in self.tracker.tracks.values()
                if track.confirmed and track.active)

    def flush_tracks(self):
        """``{frame_id: [(trk_id, tlbr), ...]}`` snapshots of the
        confirmed+active tracks after each frame processed since the last
        flush, from one transfer of the queued device results."""
        self._flush_gaps()
        return self.tracker.sync(snapshots=True)

    def reset(self, cap_dt):
        """Reset the tracker; must be called before ``step``."""
        if self._gap_buf and self.frame_count:
            self._flush_gaps()
        self._gap_buf.clear()
        self.frame_count = 0
        self.tracker.reset(cap_dt)

    def _flush_gaps(self):
        if not self._gap_buf:
            return
        buf, self._gap_buf = self._gap_buf, []
        with Profiler('flow'):
            self.tracker.track_chain([f for f, _ in buf],
                                     [i for _, i in buf])

    def _kind(self):
        if self.frame_count == 0:
            return 'init'
        return 'assoc' if self.frame_count % self.detector_frame_skip == 0 \
            else 'gap'

    def _device_path(self):
        return len(self.extractors) == 1 and \
            hasattr(self.detector, 'postprocess_device')

    @torch.no_grad()
    def step(self, frame):
        """Run the tracker on the next frame."""
        self._flush_gaps()
        detections = []
        kind = self._kind()
        with Profiler('step', step=self.frame_count, kind=kind):
            frame_dev = self._stage(frame)
            if kind == 'init':
                with Profiler('detector'):
                    self.detector.detect_async(frame_dev)
                with Profiler('detector.post'):
                    detections = self.detector.postprocess()
                self.tracker.init(frame_dev, detections)
            elif kind == 'assoc':
                detections = self._associate(frame_dev)
            else:
                with Profiler('flow'):
                    self.tracker.track(frame_dev, self.frame_count)

        if self.draw:
            self._draw(frame, detections)
        self.frame_count += 1

    def _associate(self, frame_dev):
        """A detection frame's work after the upload; returns the host
        detections (empty on the device path)."""
        device_path = not self.draw and self._device_path()
        detections = []
        with Profiler('detector'):
            self.detector.detect_async(frame_dev)
        with Profiler('flow'):
            self.tracker.track(frame_dev, self.frame_count)
        with Profiler('detector.post'):
            if device_path:
                det_dev = self.detector.postprocess_device()
            else:
                detections = self.detector.postprocess()
        if device_path:
            with Profiler('assoc'):
                self.tracker.update_device_fused(
                    self.frame_count, frame_dev, det_dev,
                    self.extractors[0])
            return detections
        with Profiler('reid'):
            cls_bboxes = self._split_bboxes_by_cls(
                detections.tlbr, detections.label, self.class_ids)
            for extractor, bboxes in zip(self.extractors, cls_bboxes):
                extractor.extract_async(frame_dev, bboxes)
            embeddings = [ex.postprocess() for ex in self.extractors]
            embeddings = np.concatenate(embeddings) \
                if len(embeddings) > 1 else embeddings[0]
        with Profiler('assoc'):
            self.tracker.update(self.frame_count, detections, embeddings)
        return detections

    @torch.no_grad()
    def step_batch(self, frames):
        """Process several frames: the same schedule and outputs as
        ``for f in frames: step(f)``, with gap frames buffered across calls
        and run together when the next detection frame (or a flush)
        arrives. Steps per frame when drawing."""
        if self.draw:
            for frame in frames:
                self.step(frame)
            return
        for frame in frames:
            kind = self._kind()
            if kind == 'init' or (kind == 'assoc'
                                  and not self._device_path()):
                self.step(frame)
                continue
            with Profiler('step', step=self.frame_count, kind=kind):
                frame_dev = self._stage(frame)
                if kind == 'assoc':
                    with Profiler('detector'):
                        self.detector.detect_async(frame_dev)
                    self._gap_buf.append((frame_dev, self.frame_count))
                    self._flush_gaps()
                    with Profiler('detector.post'):
                        det_dev = self.detector.postprocess_device()
                    with Profiler('assoc'):
                        self.tracker.update_device_fused(
                            self.frame_count, frame_dev, det_dev,
                            self.extractors[0])
                else:
                    self._gap_buf.append((frame_dev, self.frame_count))
            self.frame_count += 1

    @staticmethod
    def print_timing_info():
        """Each span's mean self time (its length less its child spans'),
        so that no time is counted twice."""
        LOGGER.debug('=================Timing Stats=================')
        for name in SPANS:
            LOGGER.debug(f"{name + ' self time:':<37}"
                         f"{Profiler.get_avg_self_millis(name):>6.3f} ms")

    @staticmethod
    def _split_bboxes_by_cls(bboxes, labels, class_ids):
        """Split class-sorted detections into per-class box groups."""
        cls_bboxes = []
        begin = 0
        for cls_id in class_ids:
            end = int(np.searchsorted(labels, cls_id, side='right')) \
                if len(labels) else 0
            cls_bboxes.append(bboxes[begin:end])
            begin = end
        return cls_bboxes

    def _draw(self, frame, detections):
        import cv2
        visible_tracks = list(self.visible_tracks())
        self.visualizer.render(frame, visible_tracks, detections,
                               self.tracker.klt_bboxes.values(),
                               self.tracker.flow.prev_bg_keypoints,
                               self.tracker.flow.bg_keypoints)
        cv2.putText(frame, f'visible: {len(visible_tracks)}', (30, 30),
                    cv2.FONT_HERSHEY_SIMPLEX, 1, 0, 2, cv2.LINE_AA)
