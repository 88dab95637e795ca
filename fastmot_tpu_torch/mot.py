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
from .utils import Profiler

LOGGER = logging.getLogger(__name__)


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

    def _upload(self, frame) -> torch.Tensor:
        # a copy: buffered frames outlive the caller's (reused) array
        return torch.as_tensor(frame).to(self.device, copy=True)

    def _flush_gaps(self):
        if not self._gap_buf:
            return
        buf, self._gap_buf = self._gap_buf, []
        with Profiler('track'):
            self.tracker.track_chain([f for f, _ in buf],
                                     [i for _, i in buf])

    def _device_path(self):
        return len(self.extractors) == 1 and \
            hasattr(self.detector, 'postprocess_device')

    @torch.no_grad()
    def step(self, frame):
        """Run the tracker on the next frame."""
        self._flush_gaps()
        detections = []
        frame_dev = self._upload(frame)
        if self.frame_count == 0:
            detections = self.detector(frame_dev)
            self.tracker.init(frame_dev, detections)
        elif self.frame_count % self.detector_frame_skip == 0:
            device_path = not self.draw and self._device_path()
            with Profiler('preproc'):
                self.detector.detect_async(frame_dev)
            with Profiler('detect'):
                with Profiler('track'):
                    self.tracker.track(frame_dev, self.frame_count)
                if device_path:
                    det_dev = self.detector.postprocess_device()
                else:
                    detections = self.detector.postprocess()
            with Profiler('extract'):
                if not device_path:
                    cls_bboxes = self._split_bboxes_by_cls(
                        detections.tlbr, detections.label, self.class_ids)
                    for extractor, bboxes in zip(self.extractors,
                                                 cls_bboxes):
                        extractor.extract_async(frame_dev, bboxes)
                    embeddings = [ex.postprocess() for ex in self.extractors]
                    embeddings = np.concatenate(embeddings) \
                        if len(embeddings) > 1 else embeddings[0]
            with Profiler('assoc'):
                if device_path:
                    self.tracker.update_device_fused(
                        self.frame_count, frame_dev, det_dev,
                        self.extractors[0])
                else:
                    self.tracker.update(self.frame_count, detections,
                                        embeddings)
        else:
            with Profiler('track'):
                self.tracker.track(frame_dev, self.frame_count)

        if self.draw:
            self._draw(frame, detections)
        self.frame_count += 1

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
            if self.frame_count == 0:
                self.step(frame)
            elif self.frame_count % self.detector_frame_skip == 0:
                if not self._device_path():
                    self.step(frame)
                    continue
                frame_dev = self._upload(frame)
                with Profiler('preproc'):
                    self.detector.detect_async(frame_dev)
                self._gap_buf.append((frame_dev, self.frame_count))
                with Profiler('detect'):
                    self._flush_gaps()
                    det_dev = self.detector.postprocess_device()
                with Profiler('assoc'):
                    self.tracker.update_device_fused(
                        self.frame_count, frame_dev, det_dev,
                        self.extractors[0])
                self.frame_count += 1
            else:
                self._gap_buf.append((self._upload(frame), self.frame_count))
                self.frame_count += 1

    @staticmethod
    def print_timing_info():
        LOGGER.debug('=================Timing Stats=================')
        LOGGER.debug(f"{'track time:':<37}"
                     f"{Profiler.get_avg_millis('track'):>6.3f} ms")
        LOGGER.debug(f"{'preprocess time:':<37}"
                     f"{Profiler.get_avg_millis('preproc'):>6.3f} ms")
        LOGGER.debug(f"{'detect/flow time:':<37}"
                     f"{Profiler.get_avg_millis('detect'):>6.3f} ms")
        LOGGER.debug(f"{'feature extract/kalman filter time:':<37}"
                     f"{Profiler.get_avg_millis('extract'):>6.3f} ms")
        LOGGER.debug(f"{'association time:':<37}"
                     f"{Profiler.get_avg_millis('assoc'):>6.3f} ms")

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
