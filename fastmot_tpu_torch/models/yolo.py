"""YOLO detectors as torch modules with the head decode (port of
``fastmot_tpu/models/yolo.py``).

The eleven registered models of the JAX package, with its constants: YOLOv4,
the Scaled-YOLOv4 family (CSP, x-mish, CSP-swish, CSP-x-swish, P5, P6;
letterboxed, new_coords decode), YOLOv3, YOLOv3-SPP and the two tinies.
Each is a cfg generated by ``cfgs.py`` and run by
``darknet.DarknetModule`` in bf16, so released ``.weights`` load through
``darknet.load_darknet_weights``.

Decode (yolo_layer.cu semantics):
  standard:   bx = (col + s*sigmoid(tx) - (s-1)/2) / W,  bw = exp(tw)*aw/iw
  new_coords: bx = (col + s*tx - (s-1)/2) / W,           bw = tw^2*4*aw/iw
"""
from __future__ import annotations

import torch

from .registry import YOLOModel, register_yolo


def _darknet_build(cfg_text: str):
    """A bf16 DarknetModule from generated cfg text."""
    from .darknet import DarknetModule, parse_cfg
    return DarknetModule(parse_cfg(cfg_text), dtype=torch.bfloat16)


def anchor_tensors(anchors, device):
    """Each head's flat (w, h) anchor pairs as a float32 [A, 2] tensor on
    ``device``: built once, where a detector is made, and handed to
    ``decode_heads``."""
    return tuple(torch.tensor(a, dtype=torch.float32,
                              device=device).reshape(-1, 2) for a in anchors)


def decode_heads(heads, anchors, scales, input_hw, new_coords):
    """Raw head maps -> [B, N, 7] rows ``[x, y, w, h, obj, class_id,
    class_prob]`` with (x, y) the top-left corner normalised to [0, 1].
    ``anchors``: ``anchor_tensors``' [A, 2] tensors, one a head, already on
    the heads' device (no host copy a call)."""
    in_h, in_w = input_hw
    outs = []
    for head, anc, s in zip(heads, anchors, scales):
        b, gh, gw, _ = head.shape
        a = anc.shape[0]
        x = head.reshape(b, gh, gw, a, -1)
        col = torch.arange(gw, dtype=torch.float32,
                           device=head.device)[None, :, None]
        row = torch.arange(gh, dtype=torch.float32,
                           device=head.device)[:, None, None]
        if new_coords:
            tx, ty, tw, th = x[..., 0], x[..., 1], x[..., 2], x[..., 3]
            obj = x[..., 4]
            cls_prob, cls_id = torch.max(x[..., 5:], dim=-1)
            bw = (tw * tw) * 4.0 * anc[:, 0] / in_w
            bh = (th * th) * 4.0 * anc[:, 1] / in_h
        else:
            tx = torch.sigmoid(x[..., 0])
            ty = torch.sigmoid(x[..., 1])
            obj = torch.sigmoid(x[..., 4])
            logit, cls_id = torch.max(x[..., 5:], dim=-1)
            cls_prob = torch.sigmoid(logit)
            bw = torch.exp(x[..., 2]) * anc[:, 0] / in_w
            bh = torch.exp(x[..., 3]) * anc[:, 1] / in_h
        bx = (col + s * tx - (s - 1.0) * 0.5) / gw
        by = (row + s * ty - (s - 1.0) * 0.5) / gh
        bx = bx - bw * 0.5
        by = by - bh * 0.5
        det = torch.stack([bx, by, bw, bh, obj, cls_id.to(torch.float32),
                           cls_prob], dim=-1)
        outs.append(det.reshape(b, -1, 7))
    return torch.cat(outs, dim=1)


@register_yolo
class YOLOv4(YOLOModel):
    NUM_CLASSES = 2
    LETTERBOX = False
    NEW_COORDS = False
    INPUT_SHAPE = (3, 512, 512)
    LAYER_FACTORS = [8, 16, 32]
    SCALES = [1.2, 1.1, 1.05]
    ANCHORS = [[11, 22, 24, 60, 37, 116],
               [54, 186, 69, 268, 89, 369],
               [126, 491, 194, 314, 278, 520]]

    @classmethod
    def build(cls):
        from .cfgs import yolov4_cfg
        c, h, w = cls.INPUT_SHAPE
        return _darknet_build(yolov4_cfg(
            cls.NUM_CLASSES, h, w,
            [a for head in cls.ANCHORS for a in head], cls.SCALES))


class _ScaledBase(YOLOModel):
    """Scaled-YOLOv4 family: letterboxed input, new_coords decode."""
    LETTERBOX = True
    NEW_COORDS = True
    ACT = 'mish'
    STEM = 32
    WIDTHS = (64, 128, 256, 512, 1024)
    DEPTHS = (1, 2, 8, 8, 4)
    FIRST_PLAIN = True
    NECK_PAIRS = 2

    @classmethod
    def build(cls):
        from .cfgs import scaled_yolov4_cfg
        c, h, w = cls.INPUT_SHAPE
        flat = [a for head in cls.ANCHORS for a in head]
        return _darknet_build(scaled_yolov4_cfg(
            cls.NUM_CLASSES, h, w, flat, len(cls.LAYER_FACTORS),
            cls.WIDTHS, cls.DEPTHS, act=cls.ACT, stem=cls.STEM,
            first_plain=cls.FIRST_PLAIN, neck_pairs=cls.NECK_PAIRS))


_CSP_ANCHORS = [[12, 16, 19, 36, 40, 28],
                [36, 75, 76, 55, 72, 146],
                [142, 110, 192, 243, 459, 401]]


@register_yolo
class YOLOv4CSP(_ScaledBase):
    NUM_CLASSES = 1
    INPUT_SHAPE = (3, 640, 640)
    LAYER_FACTORS = [8, 16, 32]
    SCALES = [2.0, 2.0, 2.0]
    ANCHORS = _CSP_ANCHORS


@register_yolo
class YOLOv4xMish(_ScaledBase):
    NUM_CLASSES = 1
    INPUT_SHAPE = (3, 640, 640)
    LAYER_FACTORS = [8, 16, 32]
    SCALES = [2.0, 2.0, 2.0]
    ANCHORS = _CSP_ANCHORS
    STEM = 40
    WIDTHS = (80, 160, 320, 640, 1280)
    DEPTHS = (1, 3, 11, 11, 5)
    NECK_PAIRS = 3


@register_yolo
class YOLOv4CSPSwish(_ScaledBase):
    NUM_CLASSES = 1
    INPUT_SHAPE = (3, 640, 640)
    LAYER_FACTORS = [8, 16, 32]
    SCALES = [2.0, 2.0, 2.0]
    ANCHORS = _CSP_ANCHORS
    ACT = 'swish'


@register_yolo
class YOLOv4CSPxSwish(_ScaledBase):
    NUM_CLASSES = 1
    INPUT_SHAPE = (3, 640, 640)
    LAYER_FACTORS = [8, 16, 32]
    SCALES = [2.0, 2.0, 2.0]
    ANCHORS = _CSP_ANCHORS
    ACT = 'swish'
    STEM = 40
    WIDTHS = (80, 160, 320, 640, 1280)
    DEPTHS = (1, 3, 11, 11, 5)
    NECK_PAIRS = 3


@register_yolo
class YOLOv4P5(_ScaledBase):
    NUM_CLASSES = 1
    INPUT_SHAPE = (3, 896, 896)
    LAYER_FACTORS = [8, 16, 32]
    SCALES = [2.0, 2.0, 2.0]
    ANCHORS = [[13, 17, 31, 25, 24, 51, 61, 45],
               [48, 102, 119, 96, 97, 189, 217, 184],
               [171, 384, 324, 451, 616, 618, 800, 800]]
    DEPTHS = (1, 3, 15, 15, 7)
    FIRST_PLAIN = False
    NECK_PAIRS = 3


@register_yolo
class YOLOv4P6(_ScaledBase):
    NUM_CLASSES = 1
    INPUT_SHAPE = (3, 1280, 1280)
    LAYER_FACTORS = [8, 16, 32, 64]
    SCALES = [2.0, 2.0, 2.0, 2.0]
    ANCHORS = [[13, 17, 31, 25, 24, 51, 61, 45],
               [61, 45, 48, 102, 119, 96, 97, 189],
               [97, 189, 217, 184, 171, 384, 324, 451],
               [324, 451, 545, 357, 616, 618, 1024, 1024]]
    WIDTHS = (64, 128, 256, 512, 1024, 1024)
    DEPTHS = (1, 3, 15, 15, 7, 7)
    FIRST_PLAIN = False
    NECK_PAIRS = 3


@register_yolo
class YOLOv4Tiny(YOLOModel):
    NUM_CLASSES = 1
    LETTERBOX = False
    NEW_COORDS = False
    INPUT_SHAPE = (3, 416, 416)
    LAYER_FACTORS = [32, 16]
    SCALES = [1.05, 1.05]
    ANCHORS = [[81, 82, 135, 169, 344, 319],
               [23, 27, 37, 58, 81, 82]]

    # upstream yolov4-tiny.cfg anchor table; masks (3,4,5) and (1,2,3)
    # reproduce the per-head ANCHORS above, (81, 82) shared by both heads
    FULL_ANCHORS = [10, 14, 23, 27, 37, 58, 81, 82, 135, 169, 344, 319]

    @classmethod
    def build(cls):
        from .cfgs import yolov4_tiny_cfg
        c, h, w = cls.INPUT_SHAPE
        return _darknet_build(yolov4_tiny_cfg(
            cls.NUM_CLASSES, h, w, cls.FULL_ANCHORS, cls.SCALES))


class _YOLOv3Base(YOLOModel):
    LETTERBOX = False
    NEW_COORDS = False
    NUM_CLASSES = 1
    LAYER_FACTORS = [32, 16, 8]
    SCALES = [1.0, 1.0, 1.0]
    ANCHORS = [[116, 90, 156, 198, 373, 326],
               [30, 61, 62, 45, 59, 119],
               [10, 13, 16, 30, 33, 23]]

    @classmethod
    def _flat_anchors(cls):
        # heads come stride 32, 16, 8 (LAYER_FACTORS order), so the flat
        # anchor table is the per-head lists reversed
        return [a for head in reversed(cls.ANCHORS) for a in head]


@register_yolo
class YOLOv3(_YOLOv3Base):
    INPUT_SHAPE = (3, 416, 416)

    @classmethod
    def build(cls):
        from .cfgs import yolov3_cfg
        c, h, w = cls.INPUT_SHAPE
        return _darknet_build(yolov3_cfg(cls.NUM_CLASSES, h, w,
                                         cls._flat_anchors()))


@register_yolo
class YOLOv3SPP(_YOLOv3Base):
    INPUT_SHAPE = (3, 608, 608)

    @classmethod
    def build(cls):
        from .cfgs import yolov3_cfg
        c, h, w = cls.INPUT_SHAPE
        return _darknet_build(yolov3_cfg(cls.NUM_CLASSES, h, w,
                                         cls._flat_anchors(), spp=True))


@register_yolo
class YOLOv3Tiny(_YOLOv3Base):
    INPUT_SHAPE = (3, 416, 416)
    LAYER_FACTORS = [32, 16]
    SCALES = [1.0, 1.0]
    ANCHORS = [[81, 82, 135, 169, 344, 319],
               [10, 14, 23, 27, 37, 58]]

    @classmethod
    def build(cls):
        from .cfgs import yolov3_tiny_cfg
        c, h, w = cls.INPUT_SHAPE
        return _darknet_build(yolov3_tiny_cfg(cls.NUM_CLASSES, h, w,
                                              cls._flat_anchors()))
