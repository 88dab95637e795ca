"""Random weights for a network, drawn on the device from the seed in a few
large calls, as a state dict that the program and the reference both take.

Every convolution and linear weight (a tensor of two or more dimensions)
is a standard normal scaled by ``sqrt(1 / fan_in)`` (LeCun's scale, the
Flax default the port's own random init follows). Batch norms are not the
identity, so that a fold or a skipped norm shows: scale and variance drawn
from [0.8, 1.2], shift and mean from [-0.1, 0.1]; other biases from
[-0.1, 0.1]. The names and shapes are the module's own; the values depend
on the seed alone.
"""
from __future__ import annotations

import torch


def draw(shapes: dict, seed: int, salt: int, device) -> dict:
    """``{name: tensor}`` float32 on ``device`` for ``shapes`` (``{name:
    shape}``, in a fixed order)."""
    g = torch.Generator(device=device)
    g.manual_seed((int(seed) * 7919 + salt) % (2 ** 63))
    mats = [(k, s) for k, s in shapes.items() if len(s) >= 2]
    vecs = [(k, s) for k, s in shapes.items() if len(s) < 2]
    out = {}
    n_mat = sum(int(torch.Size(s).numel()) for _, s in mats)
    flat = torch.randn(n_mat, generator=g, device=device)
    off = 0
    for k, s in mats:
        n = int(torch.Size(s).numel())
        fan_in = n // s[0]
        out[k] = (flat[off:off + n] * fan_in ** -0.5).reshape(s)
        off += n
    n_vec = sum(int(torch.Size(s).numel()) for _, s in vecs)
    flat = torch.rand(n_vec, generator=g, device=device)
    off = 0
    for k, s in vecs:
        n = int(torch.Size(s).numel())
        u = flat[off:off + n].reshape(s)
        off += n
        leaf = k.rsplit('.', 1)[-1]
        if leaf in ('running_var', 'weight'):
            out[k] = 0.8 + 0.4 * u          # a 1-d weight is a norm's scale
        else:
            out[k] = 0.2 * u - 0.1          # shifts, means, biases
    return out


CAL_STD = 0.5        # a detector layer's output scale after calibration


def calibrate_detector(cell, sd: dict, frames_u8):
    """The detector's batch norms' running variances scaled, in place, so
    that each layer's output has a standard deviation near ``CAL_STD`` on
    the cell's first frames [S, H, W, 3] through the float32 reference
    network (``reference.detect.darknet_forward``'s ``calibrate``). With
    LeCun-scaled random weights Scaled-YOLOv4's mish layers otherwise
    shrink the activations layer by layer until its logistic heads read
    0.5 wherever the layers before them differ (an fp8 network then reads
    within 0.0013 of the float32 one), as trained batch norms do not."""
    from .reference import detect
    det = cell.config['detector']
    box = detect.Letterbox(tuple(cell.config['frame_size']),
                           tuple(det['input_hw']), det['letterbox'])
    device = next(iter(sd.values())).device
    with torch.no_grad():
        detect.darknet_forward(cell.darknet_sections(), sd,
                               box(torch.as_tensor(frames_u8,
                                                   device=device)),
                               calibrate=CAL_STD)


def for_module(module, seed: int, salt: int, device) -> dict:
    """``draw`` for every float parameter and buffer of ``module``."""
    shapes = {k: tuple(v.shape) for k, v in module.state_dict().items()
              if v.is_floating_point()}
    return draw(shapes, seed, salt, device)
