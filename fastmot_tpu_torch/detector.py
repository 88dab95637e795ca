"""Object detectors: YOLO and SSD (torch network + decode + NMS on the
device) and the MOT-Challenge public-detection replay.

Port of ``fastmot_tpu/detector.py``. ``detect_async`` runs the resize,
the network, the head decode and the NMS on the detector's device;
``postprocess`` returns a host recarray, ``postprocess_device`` the padded
device tensors ``(tlbr, label, conf, valid)`` that the association
consumes without a host round trip. ``quantize='int8'`` (with an optional
``calib_cache``) runs the network under ``models.quantize``.
"""
from __future__ import annotations

import abc
import configparser
from collections import defaultdict
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F

from .device import torch_device
from .models.quantize import quantize_module
from .ops import geometry as geom
from .ops import nms_waves
from .utils import profiler

MAX_DETS = 128      # padded capacity of the final detection set
MAX_RAW = 1024      # candidates entering NMS after confidence filtering

DET_DTYPE = np.dtype(
    [('tlbr', float, 4),
     ('label', int),
     ('conf', float)],
    align=True
)


def make_detections(tlbrs, labels, confs) -> np.recarray:
    """Build a DET_DTYPE recarray from plain arrays."""
    n = len(tlbrs)
    out = np.empty(n, DET_DTYPE).view(np.recarray)
    if n:
        out.tlbr = tlbrs
        out.label = labels
        out.conf = confs
    return out


class Detector(abc.ABC):
    @abc.abstractmethod
    def __init__(self, size):
        self.size = size

    def __call__(self, frame):
        self.detect_async(frame)
        return self.postprocess()

    @abc.abstractmethod
    def detect_async(self, frame):
        raise NotImplementedError

    @abc.abstractmethod
    def postprocess(self):
        raise NotImplementedError


def _padded_to_host(padded) -> np.recarray:
    profiler.count('host_syncs', len(padded))
    tlbr, label, conf, valid = (t.cpu().numpy() for t in padded)
    return make_detections(tlbr[valid].astype(float),
                           label[valid].astype(int),
                           conf[valid].astype(float))


def _resize_bilinear(img: torch.Tensor, out_hw) -> torch.Tensor:
    """Bilinear resize of an HWC (or NHWC) float image with half-pixel
    centres and edge clamping, the JAX package's ``_resize_bilinear_rgb``."""
    x = img if img.dim() == 4 else img[None]
    out = F.interpolate(x.permute(0, 3, 1, 2), size=tuple(out_hw),
                        mode='bilinear', align_corners=False,
                        antialias=False).permute(0, 2, 3, 1)
    return out if img.dim() == 4 else out[0]


class _NetworkDetector(Detector):
    """A detector whose ``run`` does the whole detection on ``device``;
    ``detect_async`` stores its padded result until it is read."""

    def __init__(self, size, model, class_ids, device):
        super().__init__(size)
        self.model = model
        self.device = torch_device(device)
        label_mask = np.zeros(model.NUM_CLASSES, dtype=bool)
        try:
            label_mask[tuple(class_ids),] = True
        except IndexError as err:
            raise ValueError('Unsupported class IDs') from err
        self.label_mask = torch.as_tensor(label_mask, device=self.device)
        self._pending = None

    @abc.abstractmethod
    def run(self, frame: torch.Tensor):
        raise NotImplementedError

    def detect_async(self, frame):
        self._pending = self.run(torch.as_tensor(frame, device=self.device))

    def postprocess(self):
        out, self._pending = self._pending, None
        return _padded_to_host(out)

    def postprocess_device(self):
        """The padded (tlbr, label, conf, valid) device tensors."""
        out, self._pending = self._pending, None
        return out


def nms_and_gate(det_out, label_mask, conf_thresh, nms_thresh, max_area,
                 min_ar, scale_wh, offset):
    """Fused postprocess after the head decode: confidence filter, pixel
    scaling, class-aware DIoU-NMS over the top MAX_RAW candidates,
    area/aspect gates. Returns padded (tlbr, label, conf, valid) sorted by
    class ascending, then score descending. ``det_out`` [N, 7], or [S, N,
    7] for S streams in one NMS call (padded outputs [S, MAX_DETS]). On
    CUDA tensors the whole of it runs in ``csrc/nms_waves.cu``
    (``nms_waves.nms_select``: three launches, no host sync, no [S,
    MAX_RAW, MAX_RAW] matrix); on CPU tensors ``nms_and_gate_reference``;
    any other device raises. The two agree bit for bit."""
    device = det_out.device
    if device.type == 'cpu':
        return nms_and_gate_reference(det_out, label_mask, conf_thresh,
                                      nms_thresh, max_area, min_ar,
                                      scale_wh, offset)
    if device.type != 'cuda':
        raise ValueError(f'nms_and_gate: unsupported device {device}')
    k = min(MAX_RAW, det_out.shape[-2])
    return nms_waves.nms_select(det_out, label_mask, conf_thresh, nms_thresh,
                                max_area, min_ar, scale_wh, offset, k,
                                min(k, MAX_DETS))


def nms_and_gate_reference(det_out, label_mask, conf_thresh, nms_thresh,
                           max_area, min_ar, scale_wh, offset):
    """The plain version of ``nms_and_gate``: torch ops around
    ``geometry.greedy_suppress`` (the waves kernel on the card, whose
    [.., MAX_RAW, MAX_RAW] overlap this builds with
    ``geometry.diou_matrix``)."""
    def take(x, i):
        return torch.take_along_dim(x, i[..., None] if x.dim() > i.dim()
                                    else i, dim=i.dim() - 1)

    boxes = det_out[..., 0:4]
    obj = det_out[..., 4]
    label = det_out[..., 5].to(torch.int64)
    cls_prob = det_out[..., 6]
    score = obj * cls_prob
    keep = label_mask[torch.clamp(label, 0, label_mask.shape[0] - 1)] & \
        (score >= conf_thresh)
    xy = boxes[..., 0:2] * scale_wh[:2] - offset
    wh = boxes[..., 2:4] * scale_wh[2:]
    tlbr = geom.to_tlbr(torch.cat([xy, wh], -1))

    cand_score = torch.where(keep, score, torch.full_like(score, -1.0))
    k = min(MAX_RAW, score.shape[-1])
    top_score, top_i = torch.sort(cand_score, dim=-1, descending=True,
                                  stable=True)
    top_score, top_i = top_score[..., :k], top_i[..., :k]
    c_tlbr, c_label = take(tlbr, top_i), take(label, top_i)
    c_obj, c_cls = take(obj, top_i), take(cls_prob, top_i)
    c_valid = top_score > 0

    overlap = geom.diou_matrix(c_tlbr, 0.6)
    overlap = torch.where(c_label[..., :, None] == c_label[..., None, :],
                          overlap, torch.full_like(overlap, -float('inf')))
    nms_keep = geom.greedy_suppress(overlap, c_obj, c_valid, nms_thresh)
    area = geom.area(c_tlbr)
    final = nms_keep & (area > 0) & (area <= max_area) & \
        (geom.aspect_ratio(c_tlbr) >= min_ar)

    order_key = c_label.to(torch.float32) * 1e4 - c_obj * c_cls
    order_key = torch.where(final, order_key,
                            torch.full_like(order_key, float('inf')))
    order = torch.argsort(order_key, dim=-1, stable=True)[..., :MAX_DETS]
    return (take(c_tlbr, order), take(c_label, order).to(torch.int32),
            take(c_obj * c_cls, order), take(final, order))


class YOLODetector(_NetworkDetector):
    """YOLO detector: letterbox/resize, network, decode and NMS on the
    device."""

    def __init__(self, size,
                 class_ids,
                 model='YOLOv4',
                 conf_thresh=0.25,
                 nms_thresh=0.5,
                 max_area=800000,
                 min_aspect_ratio=1.2,
                 quantize=None,
                 calib_cache=None,
                 device='cuda'):
        from .models import registry
        super().__init__(size, registry.YOLOModel.get_model(model),
                         class_ids, device)
        assert 0 <= conf_thresh <= 1
        self.conf_thresh = conf_thresh
        assert 0 <= nms_thresh <= 1
        self.nms_thresh = nms_thresh
        assert max_area >= 0
        self.max_area = max_area
        assert min_aspect_ratio >= 0
        self.min_aspect_ratio = min_aspect_ratio
        self.module = quantize_module(self.model.init_params(self.device),
                                      quantize, calib_cache)

        # letterbox geometry
        src_size = np.array(self.size)
        c, ih, iw = self.model.INPUT_SHAPE
        dst_size = np.array([iw, ih])
        if self.model.LETTERBOX:
            scale_factor = min(dst_size / src_size)
            scaled_size = np.rint(src_size * scale_factor).astype(int)
            img_offset = ((dst_size - scaled_size) / 2).astype(int)
            self._roi = (int(img_offset[1]), int(img_offset[0]),
                         int(scaled_size[1]), int(scaled_size[0]))
            upscaled_sz = np.rint(dst_size / scale_factor).astype(int)
            bbox_offset = (upscaled_sz - src_size) / 2
        else:
            self._roi = (0, 0, ih, iw)
            upscaled_sz = src_size
            bbox_offset = np.zeros(2)
        self._scale_wh = torch.tensor(
            np.concatenate([upscaled_sz, upscaled_sz]), dtype=torch.float32,
            device=self.device)
        self._offset = torch.tensor(bbox_offset, dtype=torch.float32,
                                    device=self.device)
        from .models.yolo import anchor_tensors
        self._anchors = anchor_tensors(self.model.ANCHORS, self.device)

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """``[H, W, 3]`` BGR frame (or a stack ``[S, H, W, 3]``) -> the
        letterboxed ``[1, ih, iw, 3]`` (``[S, ih, iw, 3]``) network input
        in [0, 1]."""
        frames = frame if frame.dim() == 4 else frame[None]
        c, ih, iw = self.model.INPUT_SHAPE
        oy, ox, rh, rw = self._roi
        rgb = frames.float().flip(-1) / 255.0
        canvas = torch.full((frames.shape[0], ih, iw, c), 0.5,
                            dtype=torch.float32, device=frame.device)
        canvas[:, oy:oy + rh, ox:ox + rw] = _resize_bilinear(rgb, (rh, rw))
        return canvas

    @torch.no_grad()
    def run(self, frame: torch.Tensor):
        """Letterbox + network + decode + NMS on the device; returns the
        padded (tlbr, label, conf, valid) tensors. A stack of frames [S, H,
        W, 3] runs as one network batch and one NMS loop, with [S, ...]
        outputs."""
        from .models.yolo import decode_heads
        c, ih, iw = self.model.INPUT_SHAPE
        heads = self.module(self.preprocess(frame))
        det_out = decode_heads(heads, self._anchors, self.model.SCALES,
                               (ih, iw), self.model.NEW_COORDS)
        if frame.dim() == 3:
            det_out = det_out[0]
        return nms_and_gate(det_out, self.label_mask, self.conf_thresh,
                            self.nms_thresh, self.max_area,
                            self.min_aspect_ratio, self._scale_wh,
                            self._offset)


class SSDDetector(_NetworkDetector):
    """SSD detector: the frame is resized to a tiling region, cut into a
    grid of overlapping tiles that run as one batch, and the per-tile
    detections are NMS'd and merged across tiles on the device."""

    def __init__(self, size,
                 class_ids,
                 model='SSDInceptionV2',
                 tile_overlap=0.25,
                 tiling_grid=(4, 2),
                 conf_thresh=0.5,
                 merge_thresh=0.6,
                 max_area=120000,
                 quantize=None,
                 calib_cache=None,
                 device='cuda'):
        from .models import registry
        from .models.ssd import generate_anchors
        super().__init__(size, registry.SSDModel.get_model(model),
                         class_ids, device)
        assert 0 <= tile_overlap <= 1
        self.tile_overlap = tile_overlap
        assert tiling_grid[0] >= 1 and tiling_grid[1] >= 1
        self.tiling_grid = tuple(tiling_grid)
        assert 0 <= conf_thresh <= 1
        self.conf_thresh = conf_thresh
        assert 0 <= merge_thresh <= 1
        self.merge_thresh = merge_thresh
        assert max_area >= 0
        self.max_area = max_area

        self.batch_size = int(np.prod(self.tiling_grid))
        self.tiles, self.tiling_region_sz = self._generate_tiles()
        self.scale_factor = np.array(self.size) / self.tiling_region_sz
        self._tiles_f = torch.as_tensor(self.tiles, device=self.device)
        self._scale = torch.tensor(self.scale_factor, dtype=torch.float32,
                                   device=self.device)
        self._anchors = torch.as_tensor(generate_anchors(),
                                        device=self.device)
        self.module = quantize_module(self.model.init_params(self.device),
                                      quantize, calib_cache)

    def _generate_tiles(self):
        """Tile layout over a slightly upscaled region."""
        c, ih, iw = self.model.INPUT_SHAPE
        tile_size = np.array([iw, ih])
        tiling_grid = np.array(self.tiling_grid)
        step_size = (1 - self.tile_overlap) * tile_size
        total_size = np.rint((tiling_grid - 1) * step_size
                             + tile_size).astype(int)
        tiles = np.array([
            geom.to_tlbr(torch.tensor(
                [c_i * step_size[0], r * step_size[1], iw, ih],
                dtype=torch.float32)).numpy()
            for r in range(tiling_grid[1]) for c_i in range(tiling_grid[0])])
        return tiles.astype(np.float32), tuple(total_size)

    def preprocess(self, frame: torch.Tensor) -> torch.Tensor:
        """``[H, W, 3]`` BGR frame -> the ``[n_tiles, ih, iw, 3]`` batch of
        RGB tiles scaled to [-1, 1]."""
        c, ih, iw = self.model.INPUT_SHAPE
        rw, rh = self.tiling_region_sz
        region = _resize_bilinear(frame.float().flip(-1), (rh, rw))
        crops = []
        for x0, y0 in self.tiles[:, :2].astype(int):
            # start indices clamped like lax.dynamic_slice
            y0 = min(max(y0, 0), rh - ih)
            x0 = min(max(x0, 0), rw - iw)
            crops.append(region[y0:y0 + ih, x0:x0 + iw])
        return torch.stack(crops) * (2.0 / 255.0) - 1.0

    @torch.no_grad()
    def run(self, frame: torch.Tensor):
        """Tiling + network + decode + NMS + cross-tile merge on the
        device; returns the padded (tlbr, label, conf, valid) tensors."""
        from .models.ssd import decode_ssd
        locs, confs = self.module(self.preprocess(frame))
        det_out = decode_ssd(locs, confs, self._anchors, self.model.TOPK)
        return self._postprocess_device(
            det_out, self._tiles_f, self._scale, self.label_mask,
            self.conf_thresh, self.max_area, self.merge_thresh,
            self.model.NMS_THRESH)

    @staticmethod
    def _postprocess_device(det_out, tiles_f, scale, label_mask,
                            conf_thresh, max_area, merge_thresh,
                            nms_thresh=0.5):
        """Filter, pixel scaling, per-tile class-aware NMS, and the
        cross-tile IoM merge: padded (tlbr, label, conf, keep), class
        ascending, then index, ``min(n, MAX_DETS)`` rows. On CUDA tensors
        the whole of it runs in ``csrc/nms_waves.cu``
        (``nms_waves.ssd_postprocess``: two launches, no host sync, no [n,
        n] matrix); on CPU tensors ``ssd_postprocess_reference``; any other
        device raises. The two agree bit for bit."""
        device = det_out.device
        if device.type == 'cpu':
            return ssd_postprocess_reference(
                det_out, tiles_f, scale, label_mask, conf_thresh, max_area,
                merge_thresh, nms_thresh)
        if device.type != 'cuda':
            raise ValueError(f'ssd postprocess: unsupported device {device}')
        n = det_out.shape[0] * det_out.shape[1]
        return nms_waves.ssd_postprocess(
            det_out, tiles_f, scale, label_mask, conf_thresh, max_area,
            merge_thresh, nms_thresh, min(n, MAX_DETS))


def ssd_postprocess_reference(det_out, tiles_f, scale, label_mask,
                              conf_thresh, max_area, merge_thresh,
                              nms_thresh=0.5):
    """The plain version of ``SSDDetector._postprocess_device``: filter,
    pixel scaling, per-tile class-aware NMS, and the cross-tile IoM merge,
    as padded tensor ops.

    The per-tile NMS is one ``greedy_suppress`` over all rows with the
    overlap masked to the same tile and label: suppression acts only
    on overlapping pairs, so this is the JAX package's per-tile vmap
    (for ``nms_thresh`` >= 0, which no overlap of 0 exceeds).
    The merge takes connected components of the symmetric relation
    "other tile, same label, IoM >= merge_thresh" by min-label
    propagation to a fixpoint (``ops.nms_waves.merge_labels``); each
    component collapses onto its lowest-index member with the enclosing
    box and the highest confidence."""
    n_tiles, topk = det_out.shape[0], det_out.shape[1]
    n = n_tiles * topk
    dev = det_out.device
    rows = det_out.reshape(n, 7)
    tile_id = torch.arange(n, device=dev) // topk
    label = rows[:, 1].to(torch.int32)
    conf = rows[:, 2]
    t = tiles_f[tile_id]
    tw = t[:, 2] - t[:, 0] + 1.0
    th = t[:, 3] - t[:, 1] + 1.0
    xy_scale = torch.stack([tw, th, tw, th], -1)
    off = torch.stack([t[:, 0], t[:, 1], t[:, 0], t[:, 1]], -1)
    sc = torch.cat([scale, scale])
    tlbr = torch.round((rows[:, 3:7] * xy_scale + off) * sc[None, :])
    area = geom.area(tlbr)
    valid = (conf >= conf_thresh) & \
        label_mask[torch.clamp(label, 0, label_mask.shape[0] - 1).long()] \
        & (area > 0) & (area <= max_area)

    same_label = label[:, None] == label[None, :]
    same_tile = tile_id[:, None] == tile_id[None, :]
    overlap = torch.where(same_tile & same_label,
                          geom.bbox_ious(tlbr, tlbr),
                          torch.zeros((), device=dev))
    valid = valid & geom.greedy_suppress(overlap, conf, valid,
                                         nms_thresh)

    edge = (geom.iom_matrix(tlbr) >= merge_thresh) & ~same_tile & \
        same_label & valid[:, None] & valid[None, :]
    idx = torch.arange(n, device=dev)
    lbl = nms_waves.merge_labels(edge, valid)

    # collapse each component onto its representative; row n takes
    # the invalid rows and is dropped (scatter mode='drop')
    safe = torch.where(valid, lbl, n)
    tl = torch.full((n + 1, 2), float('inf'), device=dev).scatter_reduce(
        0, safe[:, None].expand(n, 2), tlbr[:, :2], 'amin')[:n]
    br = torch.full((n + 1, 2), -float('inf'), device=dev) \
        .scatter_reduce(0, safe[:, None].expand(n, 2), tlbr[:, 2:],
                        'amax')[:n]
    cmax = torch.zeros(n + 1, device=dev).scatter_reduce(
        0, safe, conf, 'amax')[:n]
    keep = valid & (lbl == idx)
    out_tlbr = torch.where(keep[:, None], torch.cat([tl, br], 1),
                           torch.zeros((), device=dev))
    out_conf = torch.where(keep, cmax, torch.zeros((), device=dev))

    # class ascending, then index, padded to MAX_DETS
    order_key = torch.where(keep, label.float() * n + idx.float(),
                            torch.full((), float('inf'), device=dev))
    order = torch.argsort(order_key, stable=True)[:MAX_DETS]
    return out_tlbr[order], label[order], out_conf[order], keep[order]


class PublicDetector(Detector):
    """Replays MOT Challenge public detections."""

    def __init__(self, size,
                 class_ids,
                 frame_skip,
                 sequence_path=None,
                 conf_thresh=0.5,
                 max_area=800000,
                 device='cuda'):
        super().__init__(size)
        assert tuple(class_ids) == (1,)
        self.frame_skip = frame_skip
        self.device = torch_device(device)
        assert sequence_path is not None
        seq_root = Path(sequence_path)
        if not seq_root.is_absolute():
            seq_root = Path(__file__).parents[1] / sequence_path
        self.seq_root = seq_root
        assert 0 <= conf_thresh <= 1
        self.conf_thresh = conf_thresh
        assert max_area >= 0
        self.max_area = max_area

        assert self.seq_root.exists(), f'{self.seq_root} not found'
        seqinfo = configparser.ConfigParser()
        seqinfo.read(self.seq_root / 'seqinfo.ini')
        self.seq_size = (int(seqinfo['Sequence']['imWidth']),
                         int(seqinfo['Sequence']['imHeight']))

        self.detections = defaultdict(list)
        self.frame_id = 0

        size_arr = np.array(self.size, float)
        seq_size = np.array(self.seq_size, float)
        det_txt = self.seq_root / 'det' / 'det.txt'
        for row in np.loadtxt(det_txt, delimiter=','):
            frame_id = int(row[0]) - 1
            tlwh = row[2:6].astype(np.float32)
            tlbr = np.rint(np.concatenate([tlwh[:2], tlwh[:2] + tlwh[2:]
                                           - 1.0])).astype(float)
            conf = 1.0
            label = 1  # person
            tlbr[:2] = tlbr[:2] / seq_size * size_arr
            tlbr[2:] = tlbr[2:] / seq_size * size_arr
            tlbr = np.rint(tlbr)
            area = max(tlbr[2] - tlbr[0] + 1, 0) * \
                max(tlbr[3] - tlbr[1] + 1, 0)
            if conf >= self.conf_thresh and area <= self.max_area:
                self.detections[frame_id].append((tlbr, label, conf))

    def detect_async(self, frame):
        pass

    def postprocess(self):
        dets = self.detections[self.frame_id]
        out = np.array(dets, DET_DTYPE).view(np.recarray) if dets else \
            np.empty(0, DET_DTYPE).view(np.recarray)
        self.frame_id += self.frame_skip
        return out

    def postprocess_device(self):
        """The next detections as padded device tensors."""
        det = self.postprocess()
        n = min(len(det), MAX_DETS)
        tlbrs = np.zeros((MAX_DETS, 4), np.float32)
        labels = np.full(MAX_DETS, -1, np.int32)
        confs = np.zeros(MAX_DETS, np.float32)
        valid = np.zeros(MAX_DETS, bool)
        if n:
            tlbrs[:n] = det.tlbr[:n]
            labels[:n] = det.label[:n]
            confs[:n] = det.conf[:n]
            valid[:n] = True
        profiler.count('host_syncs', 4)     # the four uploads
        return tuple(torch.as_tensor(a, device=self.device)
                     for a in (tlbrs, labels, confs, valid))
