"""ReID feature extractor (port of ``fastmot_tpu/feature_extractor.py``).

One pass per association frame: per-box bilinear crop + resize of the
frame on the device, BGR -> RGB, ImageNet normalisation, OSNet, L2
normalisation. The crop reproduces the JAX package's arithmetic exactly:
there it is two bf16 matrix products with f32 accumulation whose weight
matrices hold at most two non-zero hat weights per row, so here it is the
same two-tap blend written as a gather, with the weights and the
column-pass intermediate rounded to bf16 where the JAX products round.
Host boxes are padded to the JAX package's batch bucket with zero boxes:
under dynamic int8 the input absmax of every conv spans the whole batch
(one stream's batch, with a stream axis).
"""
from __future__ import annotations

import numpy as np
import torch

from .device import torch_device
from .models import registry
from .models.quantize import dynamic_ranges, quantize_module

_IMAGENET_MEAN = (0.485, 0.456, 0.406)
_IMAGENET_STD = (0.229, 0.224, 0.225)


def _bucket(n: int, lo: int = 16) -> int:
    """The padded batch of ``n`` boxes: ``lo`` doubled until it holds n."""
    b = lo
    while b < n:
        b *= 2
    return b


def _taps(pos: torch.Tensor, n_in: int):
    """Two-tap hat weights of clamped source positions: (i0, i1, w0, w1)
    with w0 = 1 - frac, w1 = frac, both rounded to bf16."""
    i0 = torch.floor(pos)
    frac = pos - i0
    i0 = i0.to(torch.int64)
    i1 = torch.clamp(i0 + 1, max=n_in - 1)
    bf = torch.bfloat16
    return i0, i1, (1.0 - frac).to(bf).float(), frac.to(bf).float()


def crop_resize_batch(frame: torch.Tensor, tlbrs: torch.Tensor,
                      out_hw: tuple[int, int]) -> torch.Tensor:
    """Crop each box (inclusive corners, floored and clamped to >= 0) and
    resize it to ``out_hw`` with half-pixel centres and edge clamping.
    frame [H, W, 3] (values exact in bf16, e.g. uint8), tlbrs [N, 4] ->
    [N, oh, ow, 3] float32. With a stream axis, frames [S, H, W, 3] and
    tlbrs [S, D, 4] -> [S * D, oh, ow, 3] in one gather, each box read
    from its own stream's frame."""
    if frame.dim() == 3:
        frame, tlbrs = frame[None], tlbrs[None]
    fh, fw = frame.shape[1], frame.shape[2]
    oh, ow = out_hw
    dev = frame.device
    sid = torch.arange(tlbrs.shape[0], device=dev).repeat_interleave(
        tlbrs.shape[1])[:, None, None]
    tlbrs = tlbrs.reshape(-1, 4)
    boxes = torch.clamp(torch.floor(tlbrs.float()), min=0.0)
    x0, y0 = boxes[:, 0], boxes[:, 1]
    w = boxes[:, 2] - boxes[:, 0] + 1.0
    h = boxes[:, 3] - boxes[:, 1] + 1.0
    us = (torch.arange(ow, dtype=torch.float32, device=dev) + 0.5) / ow
    vs = (torch.arange(oh, dtype=torch.float32, device=dev) + 0.5) / oh
    xs = torch.clamp(x0[:, None] + us[None, :] * w[:, None] - 0.5,
                     0.0, fw - 1.0)
    ys = torch.clamp(y0[:, None] + vs[None, :] * h[:, None] - 0.5,
                     0.0, fh - 1.0)
    xi0, xi1, wx0, wx1 = _taps(xs, fw)            # [N, ow]
    yi0, yi1, wy0, wy1 = _taps(ys, fh)            # [N, oh]
    img = frame.to(torch.bfloat16).float()

    def column_pass(rows):                        # rows [N, oh]
        r = rows[:, :, None]
        a = img[sid, r, xi0[:, None, :]]          # [N, oh, ow, 3]
        b = img[sid, r, xi1[:, None, :]]
        t = wx0[:, None, :, None] * a + wx1[:, None, :, None] * b
        return t.to(torch.bfloat16).float()

    return (wy0[:, :, None, None] * column_pass(yi0)
            + wy1[:, :, None, None] * column_pass(yi1))


def extract_core(module, out_hw, frame, tlbrs, valid) -> torch.Tensor:
    """Crop -> resize -> normalise -> OSNet -> L2; rows of invalid boxes
    are zero. frame [H, W, 3] uint8 BGR, tlbrs [N, 4], valid [N] ->
    [N, D] float32. With a stream axis (frames [S, H, W, 3], tlbrs [S, N,
    4], valid [S, N]) every stream's crops go through ONE OSNet call on
    the [S * N] batch -> [S, N, D]; under dynamic int8 each stream's N
    crops take their own input ranges, as the JAX package's ``vmap`` over
    streams gives them."""
    crops = crop_resize_batch(frame, tlbrs, out_hw)
    rgb = crops.flip(-1)
    mean = torch.tensor(_IMAGENET_MEAN, device=frame.device)
    std = torch.tensor(_IMAGENET_STD, device=frame.device)
    with dynamic_ranges(frame.shape[0] if frame.dim() == 4 else 1):
        emb = module((rgb / 255.0 - mean) / std)
    norm = torch.linalg.norm(emb, dim=1, keepdim=True)
    emb = emb / torch.where(norm > 0, norm, torch.ones_like(norm))
    emb = emb.reshape(valid.shape + emb.shape[-1:])
    return torch.where(valid[..., None], emb, torch.zeros_like(emb))


class FeatureExtractor:
    """Extracts ReID embeddings for detected boxes."""

    def __init__(self, model='OSNet025', batch_size=16, quantize=None,
                 calib_cache=None, device='cuda'):
        self.model = registry.ReIDModel.get_model(model)
        assert batch_size >= 1
        self.batch_size = batch_size   # config parity: one padded batch
        self.device = torch_device(device)
        self.feature_dim = self.model.OUTPUT_LAYOUT
        self.module = quantize_module(self.model.init_params(self.device),
                                      quantize, calib_cache)
        c, h, w = self.model.INPUT_SHAPE
        self.out_hw = (h, w)
        self._pending = None
        self._n = 0

    @property
    def metric(self):
        return self.model.METRIC

    def __call__(self, frame, tlbrs):
        self.extract_async(frame, tlbrs)
        return self.postprocess()

    @torch.no_grad()
    def extract_async(self, frame, tlbrs):
        """Embeddings of host boxes ``[N, 4]``, run as a batch of
        ``_bucket(N)`` rows."""
        n = len(tlbrs)
        self._n = n
        if n == 0:
            self._pending = np.empty((0, self.feature_dim), np.float32)
            return
        boxes = np.zeros((_bucket(n), 4), np.float32)
        boxes[:n] = tlbrs
        valid = torch.as_tensor(np.arange(len(boxes)) < n,
                                device=self.device)
        frame = torch.as_tensor(frame, device=self.device)
        self._pending = extract_core(self.module, self.out_hw, frame,
                                     torch.as_tensor(boxes,
                                                     device=self.device),
                                     valid)

    @torch.no_grad()
    def extract_async_device(self, frame_dev, tlbrs_dev, valid_dev):
        """Embeddings of device boxes [D, 4] (straight from the detector,
        no host round trip); every row is embedded."""
        self._n = int(tlbrs_dev.shape[0])
        self._pending = extract_core(self.module, self.out_hw, frame_dev,
                                     tlbrs_dev, valid_dev)

    @torch.no_grad()
    def extract_async_batch(self, frames_dev, tlbrs_dev, valid_dev):
        """Stream-batched device variant: frames [S, H, W, 3], boxes [S, D,
        4], valid [S, D] -> pending [S, D, F], one OSNet call on the
        [S * D] crops."""
        self._n = int(tlbrs_dev.shape[0]) * int(tlbrs_dev.shape[1])
        self._pending = extract_core(self.module, self.out_hw, frames_dev,
                                     tlbrs_dev, valid_dev)

    def postprocess(self):
        """[N, D] float32 numpy embeddings of the last extract_async."""
        out = self._pending
        self._pending = None
        return out if isinstance(out, np.ndarray) else \
            out[:self._n].cpu().numpy()

    def postprocess_device(self):
        """The pending embeddings as a device tensor (row i aligns with box
        i; [S, D, F] after ``extract_async_batch``), no synchronisation."""
        out = self._pending
        self._pending = None
        return out

    def null_embeddings(self, detections):
        """Identical embeddings: disables appearance."""
        emb = np.ones((len(detections), self.feature_dim), np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        return emb
