"""Plain float32 reference of the YOLO detector: the letterbox, the network
from its Darknet cfg, the head decode and the class-aware DIoU NMS.

The network runs every layer in float32 (TF32 off on the card) from the
raw weights the benchmark drew: each convolution with its own batch norm,
never folded. Padding is the Flax/XLA 'SAME' split (the smaller half
first), as the configuration states it for the port and for the JAX
package it mirrors; Darknet's own symmetric padding would shift every
stride-2 output by a pixel. With ``counter`` (a list) the forward adds
each convolution's multiply-accumulates to ``counter[0]``, which on meta
tensors counts a network's work from its shapes alone.

``decode_heads`` and ``nms_and_gate`` are frozen copies of the port's
plain versions (``fastmot_tpu_torch/models/yolo.py`` and
``fastmot_tpu_torch/detector.py``).
"""
from __future__ import annotations

import numpy as np
import torch
import torch.nn.functional as F

from . import geometry as geom

MAX_DETS = 128
MAX_RAW = 1024
BN_EPS = 1e-5


def parse_cfg(text: str) -> list[dict]:
    """Darknet cfg text as an ordered list of section dicts (numbers
    parsed; comma lists as lists)."""
    sections: list[dict] = []
    for raw in text.splitlines():
        line = raw.split('#')[0].strip()
        if not line:
            continue
        if line.startswith('['):
            sections.append({'type': line.strip('[]').strip()})
            continue
        key, _, val = (s.strip() for s in line.partition('='))
        items = [v.strip() for v in val.split(',')]
        parsed = []
        for v in items:
            try:
                parsed.append(int(v))
            except ValueError:
                try:
                    parsed.append(float(v))
                except ValueError:
                    parsed.append(v)
        sections[-1][key] = parsed if len(parsed) > 1 else parsed[0]
    return sections


def _listed(v):
    return list(v) if isinstance(v, (list, tuple)) else [v]


def _same(x, k, s, value=0.0):
    """NCHW ``x`` padded for a k x k window of stride s, 'SAME'."""
    pads = []
    for size in (x.shape[3], x.shape[2]):
        out = -(-size // s)
        total = max((out - 1) * s + k - size, 0)
        pads += [total // 2, total - total // 2]
    return F.pad(x, pads, value=value) if any(pads) else x


ACTIVATIONS = {
    'leaky': lambda x: F.leaky_relu(x, 0.1),
    'mish': lambda x: x * torch.tanh(F.softplus(x)),
    'swish': F.silu,
    'logistic': torch.sigmoid,
    'linear': lambda x: x,
}


def batch_norm(x, sd, prefix, axis=1):
    shape = [1] * x.dim()
    shape[axis] = -1
    scale = sd[f'{prefix}.weight'] / torch.sqrt(
        sd[f'{prefix}.running_var'] + BN_EPS)
    return (x - sd[f'{prefix}.running_mean'].reshape(shape)) \
        * scale.reshape(shape) + sd[f'{prefix}.bias'].reshape(shape)


def fp8(t):
    """``t`` through float8 e4m3 with a per-tensor scale (its largest
    magnitude at e4m3's 448), back in float32."""
    s = t.abs().amax().clamp(min=1e-30) / 448.0
    return (t / s).to(torch.float8_e4m3fn).to(torch.float32) * s


def conv(x, weight, stride=1, groups=1, same=True, counter=None,
         quant=None):
    """A convolution; ``quant`` (e.g. ``fp8``) rounds its input and
    weight first."""
    k = weight.shape[-1]
    if quant is not None:
        x, weight = quant(x), quant(weight)
    if same:
        x = _same(x, k, stride)
    y = F.conv2d(x, weight, stride=stride, groups=groups)
    if counter is not None:
        counter[0] += y.shape[0] * y.shape[1] * y.shape[2] * y.shape[3] \
            * weight.shape[1] * k * k
    return y


def darknet_forward(sections, sd, x, counter=None, quant=None,
                    calibrate=None):
    """The cfg's network on NCHW float ``x``; returns the yolo-head maps
    as NHWC float32, in cfg order. ``sd`` holds ``conv{i}.weight`` (OIHW),
    ``conv{i}.bias`` or ``bn{i}.*`` by the index of the layer; ``quant``
    rounds every convolution's input and weight. With ``calibrate`` (a
    standard deviation) each batch norm's running variance in ``sd`` is
    first scaled by its input's variance over ``x`` (the mean over
    channels) over ``calibrate`` squared, so that random weights keep every
    layer's output near that scale instead of shrinking or growing it
    layer by layer."""
    layers = [s for s in sections if s['type'] != 'net']
    outputs, heads = [], []
    for i, sec in enumerate(layers):
        t = sec['type']
        if t == 'convolutional':
            w = sd[f'conv{i}.weight']
            x = conv(x, w, int(sec.get('stride', 1)),
                     int(sec.get('groups', 1)), bool(int(sec.get('pad', 0))),
                     counter, quant)
            if int(sec.get('batch_normalize', 0)):
                if calibrate:
                    # one factor for all of a layer's channels: a channel
                    # of little variance is not scaled up into an
                    # amplifier of rounding
                    var = float(x.var((0, 2, 3), unbiased=False).mean())
                    sd[f'bn{i}.running_var'] = \
                        sd[f'bn{i}.running_var'] * var / calibrate ** 2
                x = batch_norm(x, sd, f'bn{i}')
            else:
                x = x + sd[f'conv{i}.bias'].reshape(1, -1, 1, 1)
            x = ACTIVATIONS[sec.get('activation', 'linear')](x)
        elif t == 'shortcut':
            frm = int(sec['from'])
            x = x + outputs[i + frm if frm < 0 else frm]
            x = ACTIVATIONS[sec.get('activation', 'linear')](x)
        elif t == 'route':
            feats = [outputs[i + j if j < 0 else j]
                     for j in _listed(sec['layers'])]
            x = torch.cat(feats, 1) if len(feats) > 1 else feats[0]
            g = int(sec.get('groups', 1))
            if g > 1:
                c = x.shape[1] // g
                gid = int(sec.get('group_id', 0))
                x = x[:, gid * c:(gid + 1) * c]
        elif t == 'upsample':
            s = int(sec.get('stride', 2))
            x = F.interpolate(x, scale_factor=s, mode='nearest')
        elif t == 'maxpool':
            size = int(sec.get('size', 2))
            stride = int(sec.get('stride', size))
            x = F.max_pool2d(_same(x, size, stride, -float('inf')), size,
                             stride)
        elif t == 'yolo':
            heads.append(x.permute(0, 2, 3, 1))
        else:
            raise ValueError(f'unsupported darknet layer {t}')
        outputs.append(x)
    return heads


class Letterbox:
    """The detector's input geometry: the frame resized into the network
    input (aspect kept and centred on grey with ``letterbox``, else
    stretched), and the map from normalised boxes back to frame pixels."""

    def __init__(self, frame_wh, input_hw, letterbox):
        src = np.array(frame_wh)
        ih, iw = input_hw
        dst = np.array([iw, ih])
        if letterbox:
            factor = min(dst / src)
            scaled = np.rint(src * factor).astype(int)
            off = ((dst - scaled) / 2).astype(int)
            self.roi = (int(off[1]), int(off[0]), int(scaled[1]),
                        int(scaled[0]))
            up = np.rint(dst / factor).astype(int)
            self.offset = (up - src) / 2
        else:
            self.roi = (0, 0, ih, iw)
            up = src
            self.offset = np.zeros(2)
        self.input_hw = (ih, iw)
        self.scale_wh = np.concatenate([up, up]).astype(np.float32)

    def __call__(self, frames_u8):
        """[S, H, W, 3] uint8 BGR -> [S, 3, ih, iw] float32 RGB in [0, 1],
        bilinear with half-pixel centres, on grey (0.5)."""
        oy, ox, rh, rw = self.roi
        ih, iw = self.input_hw
        rgb = frames_u8.float().flip(-1).permute(0, 3, 1, 2) / 255.0
        out = torch.full((rgb.shape[0], 3, ih, iw), 0.5,
                         dtype=torch.float32, device=rgb.device)
        out[:, :, oy:oy + rh, ox:ox + rw] = F.interpolate(
            rgb, size=(rh, rw), mode='bilinear', align_corners=False)
        return out


def decode_heads(heads, anchors, scales, input_hw, new_coords):
    """Raw head maps -> [B, N, 7] rows ``[x, y, w, h, obj, class_id,
    class_prob]`` with (x, y) the top-left corner normalised to [0, 1]
    (``fastmot_tpu_torch/models/yolo.py``)."""
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


def nms_and_gate(det_out, label_mask, conf_thresh, nms_thresh, max_area,
                 min_ar, scale_wh, offset):
    """Confidence filter, pixel scaling, class-aware DIoU-NMS over the top
    MAX_RAW candidates, area/aspect gates; padded (tlbr, label, conf,
    valid) sorted by class, then score descending
    (``fastmot_tpu_torch/detector.py``'s ``nms_and_gate_reference``)."""
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
