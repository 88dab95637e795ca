"""Post-training int8 quantization (port of
``fastmot_tpu/models/quantize.py``).

The JAX package's functional API (``quantize_params_int8``,
``dequantize_params``, ``make_quantized_apply``) works on state dicts.
Its three other parts, in PyTorch idiom (a module wrapper, forward
hooks and plain functions on tensors where it used a Flax interceptor):

- ``quantize_weight_int8``: symmetric per-output-channel int8 for every
  weight of rank >= 2 (convs, depthwise convs, dense layers; no BN
  parameter, no bias). The output channel is axis 0 in the port's layouts
  (OIHW, ``[C, 1, 3, 3]``, Linear ``[out, in]``); the arithmetic is the JAX
  package's numpy float32, so values and scales are its bits after the
  layout transpose. ``QuantizedModule`` keeps them as buffers and runs the
  wrapped module on ``q.float() * scale``, which each layer casts as before.
- ``fake_quant``: calibrated activation fake-quant, applied by forward
  hooks to every submodule output that a calibration cache names.
- ``int8_conv``: a conv run natively, s8 x s8 -> s32, from a calibrated or
  a dynamic input range. PyTorch has no CUDA int8 convolution and the JAX
  package leaves this conv to XLA (no Pallas kernel), so the port uses a
  library GEMM: im2col of the int8 input (the k*k shifted slices of the
  zero-padded tensor, concatenated along channels) and ``torch._int_mm``
  (cuBLASLt s8 x s8 -> s32). ``_int_mm`` wants M > 16 and K, N multiples
  of 8; zero rows and columns pad up to that, which is exact. On a CPU
  tensor the plain version takes the same integer sums exactly (a float64
  product: every partial sum is an integer below 2**53). On a CUDA tensor
  it is ``_int_mm`` or an error, never a float conv.

``EntropyCalibrator`` collects the ranges with TensorRT's KL threshold
search and writes the cache that ``load_calib_ranges`` reads. Range keys
are the Flax module paths: the port's module names with '/' for '.', so a
cache written by either package loads in the other. "Eligible" for native
int8 means what ``isinstance(m, nn.Conv)`` meant in Flax: a ``layers.Conv``,
not a ``DepthwiseConv3x3``, and not a darknet stem conv (one called with
``f32_sum=True``, the JAX package's ``_StemConv``).

XLA divides a float32 tensor by a constant as a product with the
constant's float32 reciprocal, and a bf16 tensor in f32 rounded to bf16;
``fake_quant`` and ``int8_conv`` do the same, so their outputs are the JAX
package's bits on the CPU.

Divergences from the JAX package, where it raises (ROADMAP.md section 3):
``kl_threshold`` returns the top edge when the unclipped candidate wins
(JAX indexes past the end), and ``EntropyCalibrator`` gives no range to an
output that is not one tensor, such as a detector's list of heads (JAX
cannot stack it). Such outputs are never fake-quantized in either package.
"""
from __future__ import annotations

import functools
import json
from pathlib import Path

import numpy as np
import torch
import torch.nn.functional as F
from torch import nn

from .layers import Conv, pad_same
from .osnet import force_plain_streams

# the largest contraction whose int8 products an int32 sum holds exactly
MAX_K = (2 ** 31 - 1) // (127 * 127)
_R127 = float(np.float32(1) / np.float32(127))


def quantize_weight_int8(w: torch.Tensor):
    """``(q, scale)``: ``w`` as int8 with one float32 scale per output
    channel (axis 0); ``scale`` has ``w``'s rank, its other axes 1."""
    a = w.detach().cpu().float().numpy()
    absmax = np.max(np.abs(a), axis=tuple(range(1, a.ndim)), keepdims=True)
    scale = (np.maximum(absmax, 1e-8) / 127.0).astype(np.float32)
    q = np.clip(np.rint(a / scale), -127, 127).astype(np.int8)
    return (torch.from_numpy(q).to(w.device),
            torch.from_numpy(scale).to(w.device))


def quantize_params_int8(state_dict):
    """The JAX package's functional API: ``(q_state, scales)``, the state
    dict with every weight of rank >= 2 as int8 and its float32
    per-output-channel scale (the leaves the JAX package picks); other
    entries pass through (scale None)."""
    q_state, scales = {}, {}
    for name, t in state_dict.items():
        if name.rsplit('.', 1)[-1] == 'weight' and t.dim() >= 2:
            q_state[name], scales[name] = quantize_weight_int8(t)
        else:
            q_state[name], scales[name] = t, None
    return q_state, scales


def dequantize_params(q_state, scales):
    """Float state dict from ``quantize_params_int8``'s pair."""
    return {k: q if scales[k] is None else q.float() * scales[k]
            for k, q in q_state.items()}


def make_quantized_apply(module: nn.Module, state_dict):
    """``(apply_fn, q_state)``: ``apply_fn(q_state, x)`` runs ``module``
    through ``torch.func.functional_call`` on the int8 weights dequantized
    per call."""
    q_state = quantize_params_int8(state_dict)

    def apply_fn(q_state, x):
        q, scales = q_state
        return torch.func.functional_call(module, dequantize_params(q, scales),
                                          (x,))

    return apply_fn, q_state


def fake_quant(x: torch.Tensor, thresh: float) -> torch.Tensor:
    """Symmetric int8 fake-quant at clip threshold ``thresh``: clip,
    quantize to 255 levels, dequantize, in ``x``'s dtype."""
    s = float(torch.tensor(thresh / 127.0, dtype=x.dtype))
    y = x.clamp(-thresh, thresh)
    if x.dtype == torch.float32:
        y = y * float(np.float32(1) / np.float32(s))
    else:
        # a device tensor: CUDA divides by a host scalar as a product
        y = y / torch.full((), s, dtype=x.dtype, device=x.device)
    return torch.round(y) * s


def s8_matmul(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """``[M, K] @ [K, N]`` of int8 matrices -> int32, exact. On the card
    ``a`` goes row-major and ``b`` column-major, cuBLASLt's int8 layout
    (it refuses two row-major operands at some shapes, e.g. M = 45000,
    K = N = 32)."""
    if a.device.type == 'cpu':
        return (a.double() @ b.double()).to(torch.int32)
    if a.device.type != 'cuda':
        raise ValueError(f's8_matmul: unsupported device {a.device}')
    m, k = a.shape
    n = b.shape[1]
    pad_m, pad_k, pad_n = max(17 - m, 0), -k % 8, -n % 8
    if pad_m or pad_k:
        a = F.pad(a, (0, pad_k, 0, pad_m))
    bt = b.t()
    if pad_k or pad_n:
        bt = F.pad(bt, (0, pad_k, 0, pad_n))
    y = torch._int_mm(a.contiguous(), bt.contiguous().t())
    return y[:m, :n] if pad_m or pad_n else y


def _im2col(x: torch.Tensor, k: int, stride: int, oh: int, ow: int):
    """``[B, H, W, C]`` (padded) -> ``[B * oh * ow, k * k * C]``, columns
    in (dy, dx, c) order."""
    s = stride
    taps = [x[:, dy:dy + s * (oh - 1) + 1:s, dx:dx + s * (ow - 1) + 1:s]
            for dy in range(k) for dx in range(k)]
    cols = taps[0] if k == 1 else torch.cat(taps, -1)
    return cols.reshape(-1, cols.shape[-1])


def s8_conv(xq: torch.Tensor, wq: torch.Tensor, stride: int = 1,
            padding: str = 'SAME', groups: int = 1) -> torch.Tensor:
    """s8 x s8 -> s32 conv: ``xq [B, H, W, C]`` int8, ``wq [O, C / groups,
    k, k]`` int8 -> ``[B, oh, ow, O]`` int32, Flax 'SAME' or 'VALID'."""
    if xq.dtype != torch.int8 or wq.dtype != torch.int8:
        raise ValueError(f's8_conv: int8 operands only, got {xq.dtype} '
                         f'and {wq.dtype}')
    if xq.device != wq.device:
        raise ValueError(f's8_conv: input on {xq.device}, weight on '
                         f'{wq.device}')
    if xq.dim() != 4 or wq.dim() != 4 or wq.shape[2] != wq.shape[3]:
        raise ValueError(f's8_conv: shapes {tuple(xq.shape)} and '
                         f'{tuple(wq.shape)}')
    b, _, _, c = xq.shape
    o, cg, k, _ = wq.shape
    if c != cg * groups or o % groups:
        raise ValueError(f's8_conv: {c} input channels, weight '
                         f'{tuple(wq.shape)}, groups {groups}')
    if k * k * cg > MAX_K:
        raise ValueError(f's8_conv: K = {k * k * cg} overflows int32 sums')
    if padding == 'SAME':
        xq = pad_same(xq, k, stride)
    oh = (xq.shape[1] - k) // stride + 1
    ow = (xq.shape[2] - k) // stride + 1
    og = o // groups
    outs = []
    for g in range(groups):
        xg = xq if groups == 1 else xq[..., g * cg:(g + 1) * cg]
        wmat = wq[g * og:(g + 1) * og].permute(0, 2, 3, 1).reshape(og, -1)
        outs.append(s8_matmul(_im2col(xg, k, stride, oh, ow), wmat.t()))
    y = outs[0] if groups == 1 else torch.cat(outs, 1)
    return y.reshape(b, oh, ow, o)


def int8_conv(x: torch.Tensor, weight_int8: torch.Tensor,
              weight_scale: torch.Tensor, t_in: float, stride: int = 1,
              padding: str = 'SAME', groups: int = 1,
              bias: torch.Tensor | None = None) -> torch.Tensor:
    """One conv run natively in int8 (``QuantizedModule._int8_conv``):
    quantize the NHWC input at threshold ``t_in`` (``t_in <= 0``: dynamic,
    the absmax of the whole tensor), s8 x s8 -> s32 conv, rescale by
    ``s_in * weight_scale`` per output channel, add the bias. Returns
    float32. ``int8_conv.launches`` counts calls on a CUDA tensor."""
    x = x.float()
    if t_in > 0:
        s_in = float(np.float32(t_in / 127.0))
        xq = x * float(np.float32(1) / np.float32(s_in))
    else:
        s_in = torch.clamp(x.abs().amax(), min=1e-6) * _R127
        xq = x / s_in
    xq = torch.clamp(torch.round(xq), -127, 127).to(torch.int8)
    y = s8_conv(xq, weight_int8, stride, padding, groups)
    if x.is_cuda:
        int8_conv.launches += 1
    y = y.float() * (s_in * weight_scale.reshape(-1))
    return y if bias is None else y + bias.float()


int8_conv.launches = 0


# ---------------------------------------------------------------------------
# QuantizedModule: int8 weights, activation fake-quant, native int8 convs
# ---------------------------------------------------------------------------

def _dequantize(layer, args):
    layer.weight = layer.weight_int8.float() * layer.weight_scale


def _drop_dequantized(layer, args, out):
    del layer.weight


def _native_forward(layer, t_in, x, f32_sum=False):
    """An eligible conv's forward under ``QuantizedModule``: ``int8_conv``,
    or, called as a darknet stem conv, the float conv on the dequantized
    weight (the JAX package's ``_StemConv`` is never native)."""
    if not f32_sum:
        return int8_conv(x, layer.weight_int8, layer.weight_scale, t_in,
                         layer.stride, layer.padding, layer.groups,
                         layer.bias)
    _dequantize(layer, (x,))
    try:
        return Conv.forward(layer, x, f32_sum=True)
    finally:
        del layer.weight


def _fake_quant_hook(thresh, native, layer, args, kwargs, out):
    if native and not kwargs.get('f32_sum'):
        return None                 # ran natively: its output stays
    return fake_quant(out, thresh) if isinstance(out, torch.Tensor) \
        else None


class QuantizedModule(nn.Module):
    """``module`` with int8 weights (the ``quantize: "int8"`` config knob).

    The float weight of every layer in ``module`` (taken over, not copied)
    becomes the buffers ``weight_int8`` and ``weight_scale``, so it lives
    on the device as int8; each forward dequantizes it. OSNet takes its
    literal per-stream forward (the OSBlock kernel is not launched).

    ``act_ranges`` (``{module path: threshold}``, ``EntropyCalibrator.
    compute_ranges``) fake-quantizes every call's output of each named
    submodule; the root output stays float. ``in_ranges``
    (``compute_input_ranges``) runs each named eligible conv natively in
    int8 at its input threshold; the key ``'*'`` covers every eligible conv
    without an entry of its own, and a threshold <= 0 under it is dynamic
    (the input's absmax, what ``bench.py --int8`` uses). A conv that ran
    natively, and any key in ``in_ranges``, is not fake-quantized."""

    def __init__(self, module: nn.Module, act_ranges: dict | None = None,
                 in_ranges: dict | None = None):
        super().__init__()
        self.act_ranges = {k: float(v) for k, v in
                           (act_ranges or {}).items() if v > 0} or None
        self.in_ranges = {k: float(v) for k, v in (in_ranges or {}).items()
                          if v > 0 or k == '*'} or None
        self.module = module
        acts, ins = self.act_ranges or {}, self.in_ranges or {}
        for name, layer in module.named_modules():
            key = name.replace('.', '/')
            t_in = ins.get(key, ins.get('*')) \
                if name and isinstance(layer, Conv) else None
            w = layer._parameters.get('weight')
            if w is not None and w.dim() >= 2:
                q, s = quantize_weight_int8(w)
                del layer.weight
                layer.register_buffer('weight_int8', q)
                layer.register_buffer('weight_scale', s)
                if t_in is None:
                    layer.register_forward_pre_hook(_dequantize)
                    layer.register_forward_hook(_drop_dequantized)
                else:
                    layer.forward = functools.partial(_native_forward,
                                                      layer, t_in)
            if name and key in acts and key not in ins:
                layer.register_forward_hook(
                    functools.partial(_fake_quant_hook, acts[key],
                                      t_in is not None), with_kwargs=True)

    def forward(self, *args, **kwargs):
        with force_plain_streams():
            return self.module(*args, **kwargs)


def quantize_module(module: nn.Module, quantize=None, calib_cache=None):
    """``module`` as the ``quantize=``/``calib_cache=`` knobs of the
    detectors and the feature extractor ask: itself, or a
    ``QuantizedModule`` with the cache's ranges."""
    assert quantize in (None, 'int8'), quantize
    if quantize is None:
        return module
    act_ranges, in_ranges = load_calib_ranges(calib_cache)
    return QuantizedModule(module, act_ranges, in_ranges)


# ---------------------------------------------------------------------------
# Entropy calibration (KL threshold search, TensorRT-style)
# ---------------------------------------------------------------------------

def kl_threshold(hist: np.ndarray, bin_edges: np.ndarray,
                 num_quant_bins: int = 128) -> float:
    """The |x| clip threshold minimizing KL(P || Q), Q being P re-binned to
    ``num_quant_bins`` levels (IInt8EntropyCalibrator2). ``bin_edges`` are
    the upper edges of ``hist``'s bins. When the unclipped candidate wins,
    the top edge (the JAX package indexes past the end there)."""
    total = hist.sum()
    if total == 0:
        return float(bin_edges[-1])
    best_kl = np.inf
    best_t = bin_edges[-1]
    n = len(hist)
    hist = hist.astype(np.float64)
    tail = np.concatenate([np.cumsum(hist[::-1])[::-1], [0.0]])
    for i in range(num_quant_bins, n + 1):
        ref = hist[:i].copy()
        ref[i - 1] += tail[i]            # fold the tail into the last bin
        p = ref / ref.sum()
        # re-bin the first i bins to num_quant_bins levels: each level j
        # covers ref[floor(j*i/K) : floor((j+1)*i/K)] and spreads its mass
        # evenly over that chunk's NONZERO bins (TensorRT semantics)
        bounds = (np.arange(num_quant_bins + 1) * i) // num_quant_bins
        sums = np.add.reduceat(ref, bounds[:-1])
        nz = np.add.reduceat((ref > 0).astype(np.float64), bounds[:-1])
        avg = np.divide(sums, nz, out=np.zeros_like(sums), where=nz > 0)
        q = np.repeat(avg, np.diff(bounds))
        q = np.where(ref > 0, q, 0.0)
        qs = q.sum()
        if qs == 0:
            continue
        q /= qs
        mask = p > 0
        kl = np.sum(p[mask] * np.log(p[mask] / np.maximum(q[mask], 1e-12)))
        if kl < best_kl:
            best_kl = kl
            best_t = bin_edges[min(i, n - 1)]
    return float(best_t)


def _capture_output(cap, key, layer, args, out):
    if key not in cap:                  # the first call only
        cap[key] = out.detach().float().cpu().numpy() \
            if isinstance(out, torch.Tensor) else None


def _capture_input(cap, key, layer, args, kwargs):
    if not kwargs.get('f32_sum'):       # a stem conv is not eligible
        cap[key] = args[0].detach().float().cpu().numpy()


class EntropyCalibrator:
    """Per-layer activation histograms over calibration batches and their
    KL-optimal clip ranges: every submodule's output (``compute_ranges``;
    the root's, when it is one tensor, under ``'__call__'``; a module
    called several times contributes its first call) and every eligible
    conv's input (``compute_input_ranges``). Two passes per family, as in
    the JAX package: the absmax of each tensor over all batches, then its
    histogram over [0, absmax]. ``module`` is the float model; it runs its
    literal forward on its own device.

    Usage::

        cal = EntropyCalibrator(module)
        for batch in batches:
            cal.observe(batch)
        cal.save('calib_cache.json')
    """

    def __init__(self, module: nn.Module, num_bins: int = 2048):
        self.module = module
        self.num_bins = num_bins
        self._batches: list[np.ndarray] = []
        self._ranges: dict[str, float] | None = None
        self._in_ranges: dict[str, float] | None = None

    def observe(self, batch):
        """Add a calibration batch (NHWC float32, the module's input)."""
        self._batches.append(np.asarray(batch, np.float32))
        self._ranges = None
        self._in_ranges = None

    @torch.no_grad()
    def _activations(self, batch, inputs: bool) -> dict[str, np.ndarray]:
        cap, handles = {}, []
        for name, m in self.module.named_modules():
            key = name.replace('.', '/') or '__call__'
            if not inputs:
                handles.append(m.register_forward_hook(
                    functools.partial(_capture_output, cap, key)))
            elif name and isinstance(m, Conv):
                handles.append(m.register_forward_pre_hook(
                    functools.partial(_capture_input, cap, key),
                    with_kwargs=True))
        device = next(self.module.parameters()).device
        try:
            with force_plain_streams():
                self.module(torch.as_tensor(batch, device=device))
        finally:
            for h in handles:
                h.remove()
        return {k: v for k, v in cap.items() if v is not None}

    def _search(self, inputs: bool) -> dict[str, float]:
        absmax: dict[str, float] = {}
        for b in self._batches:
            for name, act in self._activations(b, inputs).items():
                m = float(np.max(np.abs(act)))
                absmax[name] = max(absmax.get(name, 0.0), m)
        hists: dict[str, np.ndarray] = {}
        for b in self._batches:
            for name, act in self._activations(b, inputs).items():
                amax = absmax[name]
                if amax == 0:
                    continue
                h, _ = np.histogram(np.abs(act), bins=self.num_bins,
                                    range=(0, amax))
                hists[name] = hists[name] + h if name in hists \
                    else h.astype(np.int64)
        return {name: kl_threshold(
            h, np.linspace(0, absmax[name], self.num_bins + 1)[1:])
            for name, h in hists.items()}

    def compute_ranges(self) -> dict[str, float]:
        """KL-optimal thresholds of the submodule outputs."""
        if self._ranges is None:
            self._ranges = self._search(inputs=False)
        return self._ranges

    def compute_input_ranges(self) -> dict[str, float]:
        """KL-optimal thresholds of the eligible convs' inputs (the native
        int8 path's quantization points)."""
        if self._in_ranges is None:
            self._in_ranges = self._search(inputs=True)
        return self._in_ranges

    def save(self, path):
        """Write both families: ``outputs`` and ``inputs``."""
        Path(path).write_text(json.dumps(
            {'outputs': self.compute_ranges(),
             'inputs': self.compute_input_ranges()}, indent=1))

    @staticmethod
    def load(path) -> dict[str, float]:
        """Output-range view of a cache (a flat cache is output ranges)."""
        data = json.loads(Path(path).read_text())
        return data.get('outputs', data) if isinstance(data, dict) else data


def load_act_ranges(calib_cache) -> dict[str, float] | None:
    """The output ranges of a calibration cache; None when no path was
    configured or the file does not exist yet."""
    return load_calib_ranges(calib_cache)[0]


def load_calib_ranges(calib_cache):
    """``(act_ranges, in_ranges)`` of a calibration cache, the two
    ``QuantizedModule`` knobs. A flat legacy cache gives ``(ranges,
    None)``; a missing or unconfigured one ``(None, None)``."""
    if calib_cache is None:
        return None, None
    p = Path(calib_cache)
    if not p.exists():
        return None, None
    data = json.loads(p.read_text())
    if isinstance(data, dict) and 'outputs' in data:
        return data['outputs'] or None, data.get('inputs') or None
    return data or None, None
