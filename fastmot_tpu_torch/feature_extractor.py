"""ReID feature extractor (port of ``fastmot_tpu/feature_extractor.py``).

One pass per association frame: per-box bilinear crop + resize of the
frame on the device, BGR -> RGB, ImageNet normalisation (all three in
``ops.reid_crops.reid_crops``: one launch of ``csrc/reid_crops.cu`` on the
card, whose plain version reproduces the JAX package's crop arithmetic
exactly; bf16 for the float OSNet, whose stem rounds its input to bf16),
OSNet, L2 normalisation.
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
from .ops import reid_crops as rc
# the JAX module's public name, which the port's surface keeps
from .ops.reid_crops import crop_resize_batch  # noqa: F401
from .utils import profiler
from .utils.profiler import Profiler


def _bucket(n: int, lo: int = 16) -> int:
    """The padded batch of ``n`` boxes: ``lo`` doubled until it holds n."""
    b = lo
    while b < n:
        b *= 2
    return b


def extract_core(module, out_hw, frame, tlbrs, valid) -> torch.Tensor:
    """Crop -> resize -> normalise -> OSNet -> L2; rows of invalid boxes
    are zero. frame [H, W, 3] uint8 BGR, tlbrs [N, 4], valid [N] ->
    [N, D] float32. With a stream axis (frames [S, H, W, 3], tlbrs [S, N,
    4], valid [S, N]) every stream's crops go through ONE OSNet call on
    the [S * N] batch -> [S, N, D]; under dynamic int8 each stream's N
    crops take their own input ranges, as the JAX package's ``vmap`` over
    streams gives them. The crops come in bf16 where the module's first
    operation rounds its input to bf16 (``input_dtype``: the float OSNet),
    which gives the float32 crops' embeddings bit for bit with half the
    bytes written; a ``QuantizedModule`` takes its ranges from float32
    crops."""
    x = rc.reid_crops(frame, tlbrs, out_hw,
                      getattr(module, 'input_dtype', torch.float32))
    with dynamic_ranges(frame.shape[0] if frame.dim() == 4 else 1):
        emb = module(x)
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
        profiler.count('host_syncs', 2)     # the boxes' and mask's uploads
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
        with Profiler('reid'):
            self._n = int(tlbrs_dev.shape[0]) * int(tlbrs_dev.shape[1])
            self._pending = extract_core(self.module, self.out_hw,
                                         frames_dev, tlbrs_dev, valid_dev)

    def postprocess(self):
        """[N, D] float32 numpy embeddings of the last extract_async."""
        out = self._pending
        self._pending = None
        if isinstance(out, np.ndarray):
            return out
        profiler.count('host_syncs')
        return out[:self._n].cpu().numpy()

    def postprocess_device(self):
        """The pending embeddings as a device tensor (row i aligns with box
        i; [S, D, F] after ``extract_async_batch``), no synchronisation."""
        with Profiler('reid'):
            out, self._pending = self._pending, None
        return out

    def null_embeddings(self, detections):
        """Identical embeddings: disables appearance."""
        emb = np.ones((len(detections), self.feature_dim), np.float32)
        emb /= np.linalg.norm(emb, axis=1, keepdims=True)
        return emb
