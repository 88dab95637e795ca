"""torchreid OSNet checkpoint -> Flax parameter mapping.

Capability reference: the reference converts torchreid OSNet to ONNX and
builds a TensorRT engine from it (fastmot/models/reid.py:95-109,
scripts/download_models.sh). Here the mapping is STRUCTURAL, not
order-based: both layouts are generated from the same architecture walk,
so every tensor is matched by name with an explicit transform — no
reliance on dict ordering. The map is exhaustive (asserted against the
Flax parameter tree in tests/test_weight_pipeline.py); a checkpoint from
a different architecture revision fails loudly on missing keys.

torchreid key layout (osnet.py upstream):
  conv1.{conv,bn}, conv2.<i>.<OSBlock>, conv2.2.{conv,bn} transition,
  conv3..., conv4.{0,1}, conv5.{conv,bn}, fc.0 (Linear), fc.1 (BN1d);
  OSBlock: conv1, conv2a, conv2b.{0,1}, conv2c.{0..2}, conv2d.{0..3}
  (LightConv3x3: conv1 1x1, conv2 depthwise, bn), gate.{fc1,fc2},
  conv3, downsample (iff in != out). classifier.* is training-only.
"""
from __future__ import annotations

import numpy as np

# transforms: how a torch tensor becomes the flax leaf
#   conv   OIHW -> HWIO
#   dense  [out, in] -> [in, out]
#   gate   1x1-conv [out, in, 1, 1] -> dense kernel [in, out]
#   copy   as-is (bn vectors, biases)


def _convbn(tp, fp):
    return [
        (f'{tp}.conv.weight', f'params/{fp}/Conv_0/kernel', 'conv'),
        (f'{tp}.bn.weight', f'params/{fp}/BatchNorm_0/scale', 'copy'),
        (f'{tp}.bn.bias', f'params/{fp}/BatchNorm_0/bias', 'copy'),
        (f'{tp}.bn.running_mean', f'batch_stats/{fp}/BatchNorm_0/mean',
         'copy'),
        (f'{tp}.bn.running_var', f'batch_stats/{fp}/BatchNorm_0/var',
         'copy'),
    ]


def _lite(tp, fp):
    return [
        (f'{tp}.conv1.weight', f'params/{fp}/Conv_0/kernel', 'conv'),
        (f'{tp}.conv2.weight', f'params/{fp}/DepthwiseConv3x3_0/kernel',
         'conv'),
        (f'{tp}.bn.weight', f'params/{fp}/BatchNorm_0/scale', 'copy'),
        (f'{tp}.bn.bias', f'params/{fp}/BatchNorm_0/bias', 'copy'),
        (f'{tp}.bn.running_mean', f'batch_stats/{fp}/BatchNorm_0/mean',
         'copy'),
        (f'{tp}.bn.running_var', f'batch_stats/{fp}/BatchNorm_0/var',
         'copy'),
    ]


def _osblock(tp, fp, downsample):
    # stream order in the flax module: t=1 stream first (LiteConv_0),
    # then the gate is first called, then streams t=2..4 (LiteConv_1..9)
    pairs = _convbn(f'{tp}.conv1', f'{fp}/ConvBNReLU_0')
    pairs += _lite(f'{tp}.conv2a', f'{fp}/LiteConv_0')
    li = 1
    for sname, n in (('conv2b', 2), ('conv2c', 3), ('conv2d', 4)):
        for j in range(n):
            pairs += _lite(f'{tp}.{sname}.{j}', f'{fp}/LiteConv_{li}')
            li += 1
    g = f'{fp}/AggregationGate_0'
    pairs += [
        (f'{tp}.gate.fc1.weight', f'params/{g}/Dense_0/kernel', 'gate'),
        (f'{tp}.gate.fc1.bias', f'params/{g}/Dense_0/bias', 'copy'),
        (f'{tp}.gate.fc2.weight', f'params/{g}/Dense_1/kernel', 'gate'),
        (f'{tp}.gate.fc2.bias', f'params/{g}/Dense_1/bias', 'copy'),
    ]
    pairs += _convbn(f'{tp}.conv3', f'{fp}/ConvBNReLU_1')
    if downsample:
        pairs += _convbn(f'{tp}.downsample', f'{fp}/ConvBNReLU_2')
    return pairs


def osnet_key_map(channels=(16, 64, 96, 128)):
    """Complete (torch_key, flax_path, transform) list for an OSNet."""
    c = channels
    pairs = _convbn('conv1', 'ConvBNReLU_0')
    block = 0
    trans = 1
    in_c = c[0]
    for stage, ch in enumerate(c[1:]):
        tname = f'conv{stage + 2}'
        pairs += _osblock(f'{tname}.0', f'OSBlock_{block}', in_c != ch)
        pairs += _osblock(f'{tname}.1', f'OSBlock_{block + 1}', False)
        block += 2
        in_c = ch
        if stage < len(c) - 2:
            pairs += _convbn(f'{tname}.2', f'ConvBNReLU_{trans}')
            trans += 1
    pairs += _convbn('conv5', f'ConvBNReLU_{trans}')
    pairs += [
        ('fc.0.weight', 'params/Dense_0/kernel', 'dense'),
        ('fc.0.bias', 'params/Dense_0/bias', 'copy'),
        ('fc.1.weight', 'params/BatchNorm_0/scale', 'copy'),
        ('fc.1.bias', 'params/BatchNorm_0/bias', 'copy'),
        ('fc.1.running_mean', 'batch_stats/BatchNorm_0/mean', 'copy'),
        ('fc.1.running_var', 'batch_stats/BatchNorm_0/var', 'copy'),
    ]
    return pairs


def apply_transform(arr: np.ndarray, kind: str) -> np.ndarray:
    if kind == 'conv':
        return np.transpose(arr, (2, 3, 1, 0))
    if kind == 'dense':
        return np.transpose(arr, (1, 0))
    if kind == 'gate':
        return np.transpose(arr[:, :, 0, 0], (1, 0))
    return np.asarray(arr)


def convert_state_dict(state_dict, channels=(16, 64, 96, 128)):
    """torch state_dict -> flat {flax_path: array} dict (load_npz format).

    Raises KeyError listing what's absent if the checkpoint does not
    match the expected torchreid OSNet layout.
    """
    out = {}
    missing = []
    for tkey, fpath, kind in osnet_key_map(channels):
        if tkey not in state_dict:
            missing.append(tkey)
            continue
        out[fpath] = apply_transform(np.asarray(state_dict[tkey]), kind)
    if missing:
        raise KeyError(
            f'checkpoint is missing {len(missing)} expected torchreid '
            f'OSNet tensors (e.g. {missing[:4]}) — wrong model or '
            f'architecture revision')
    return out
