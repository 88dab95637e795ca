"""TF-Object-Detection frozen graph -> SSD parameters (port of
``fastmot_tpu/models/ssd_convert.py``).

Capability reference: the reference builds its SSD engines from TF
frozen graphs (fastmot/models/ssd.py PATH/... ssd_*_coco.pb via UFF ->
TensorRT). Here the frozen graph's Const tensors are read directly with
the wire-format reader (protoparse.graphdef_constants — no tensorflow
dependency) and mapped STRUCTURALLY onto the SSDNet's Flax-named
parameters (``weights.flax_shapes`` of the port's module):

  trunk    MobilenetV1: Conv2d_0 + Conv2d_{i}_{depthwise,pointwise}
           MobilenetV2: Conv + expanded_conv{,_i}/{expand,depthwise,
           project} + Conv_1
           InceptionV2: separable stem (depthwise_weights zero-embedded
           into a dense kernel) + Conv2d_2b/2c + the Mixed_3b..5c block
           table (ssd.INCEPTION_V2_BLOCKS, layer-exact to TF slim)
  extras   feature_map_generators naming: ``*_1_Conv2d_{n}_1x1_{c}`` /
           ``*_2_Conv2d_{n}_3x3_s2_{c}`` (discovered by regex, ordered
           by n — robust to the per-backbone base-name prefix)
  heads    BoxPredictor_{i}/{BoxEncodingPredictor,ClassPredictor}

TF conv kernels are already HWIO; depthwise kernels are [H, W, C, 1] ->
our DepthwiseConv3x3 [H, W, 1, C]. Every mapped tensor is shape-checked
against the model and the result is verified by a strict load, so a
frozen graph from a different architecture revision fails loudly with
the offending tensor name. A BatchNorm gamma absent from the graph
(slim batch_norm scale=False trunks) maps to ones. The result is a flat
``{flax/path: array}`` dict: ``weights.flax_to_state_dict`` turns it into
the module's state dict.
"""
from __future__ import annotations

import re

import numpy as np

_BN_SUFFIX = {
    'scale': 'gamma', 'bias': 'beta', 'mean': 'moving_mean',
    'var': 'moving_variance',
}


class _Mapper:
    def __init__(self, consts, module):
        from ..weights import flax_shapes
        self.consts = consts
        self.shapes = flax_shapes(module)
        self.flat = {}
        self.consumed = set()

    def _tf(self, name, expect_shape):
        if name not in self.consts:
            close = [k for k in self.consts if name.split('/')[-2] in k][:3]
            raise KeyError(
                f'frozen graph has no Const {name!r} (closest: {close})')
        arr = np.asarray(self.consts[name], np.float32)
        if tuple(arr.shape) != tuple(expect_shape):
            raise ValueError(
                f'{name}: checkpoint shape {arr.shape} != model '
                f'{tuple(expect_shape)}')
        self.consumed.add(name)
        return arr

    def _leaf_shape(self, flax_path):
        if flax_path not in self.shapes:
            raise KeyError(f'model tree has no leaf {flax_path!r}')
        return self.shapes[flax_path]

    def conv(self, tf_layer, flax_mod, depthwise=False, bias=False):
        """One TF conv layer (+BatchNorm or +biases) -> one flax module."""
        if depthwise:
            kpath = f'params/{flax_mod}/DepthwiseConv3x3_0/kernel'
            h, w, one, c = self._leaf_shape(kpath)
            arr = self._tf(f'{tf_layer}/depthwise_weights', (h, w, c, one))
            self.flat[kpath] = np.transpose(arr, (0, 1, 3, 2)).copy()
        else:
            kpath = f'params/{flax_mod}/Conv_0/kernel'
            self.flat[kpath] = self._tf(f'{tf_layer}/weights',
                                        self._leaf_shape(kpath))
        if bias:
            bpath = f'params/{flax_mod}/Conv_0/bias'
            self.flat[bpath] = self._tf(f'{tf_layer}/biases',
                                        self._leaf_shape(bpath))
        else:
            self.bn(tf_layer, flax_mod)

    def conv_at(self, tf_layer, flax_mod):
        """Conv + BN whose Conv_0/BatchNorm_0 live directly on
        ``flax_mod`` (MobileNetV2's project conv on InvertedResidual)."""
        kpath = f'params/{flax_mod}/Conv_0/kernel'
        self.flat[kpath] = self._tf(f'{tf_layer}/weights',
                                    self._leaf_shape(kpath))
        self.bn(tf_layer, flax_mod)

    def bn(self, tf_layer, flax_mod):
        """BatchNorm-only mapping; a missing gamma (slim batch_norm
        scale=False trunks) maps to ones."""
        for ours, tf in _BN_SUFFIX.items():
            top = 'params' if ours in ('scale', 'bias') else 'batch_stats'
            path = f'{top}/{flax_mod}/BatchNorm_0/{ours}'
            name = f'{tf_layer}/BatchNorm/{tf}'
            if ours == 'scale' and name not in self.consts:
                self.flat[path] = np.ones(self._leaf_shape(path),
                                          np.float32)
                continue
            self.flat[path] = self._tf(name, self._leaf_shape(path))

    def raw_conv(self, tf_layer, flax_conv_path):
        """A bare nn.Conv (predictor): weights + biases."""
        kpath = f'params/{flax_conv_path}/kernel'
        self.flat[kpath] = self._tf(f'{tf_layer}/weights',
                                    self._leaf_shape(kpath))
        bpath = f'params/{flax_conv_path}/bias'
        self.flat[bpath] = self._tf(f'{tf_layer}/biases',
                                    self._leaf_shape(bpath))


def _extras_layers(consts):
    """Discover the 4 extra-feature 1x1/3x3 conv layer names, in order."""
    ones, threes = {}, {}
    for name in consts:
        m = re.search(r'^(.*_1_Conv2d_(\d+)_1x1_\d+)/weights$', name)
        if m:
            ones[int(m.group(2))] = m.group(1)
        m = re.search(r'^(.*_2_Conv2d_(\d+)_3x3_s2_\d+)/weights$', name)
        if m:
            threes[int(m.group(2))] = m.group(1)
    if sorted(ones) != sorted(threes) or len(ones) != 4:
        raise ValueError(
            f'expected 4 extra-feature conv pairs, found 1x1 at indices '
            f'{sorted(ones)} and 3x3 at {sorted(threes)}')
    return [(ones[i], threes[i]) for i in sorted(ones)]


def _map_head(m, consts, head='SSDHead_0'):
    for j, (one, three) in enumerate(_extras_layers(consts)):
        m.conv(one, f'{head}/ConvBNReLU6_{2 * j}')
        m.conv(three, f'{head}/ConvBNReLU6_{2 * j + 1}')
    for i in range(6):
        m.raw_conv(f'BoxPredictor_{i}/BoxEncodingPredictor',
                   f'{head}/Conv_{2 * i}')
        m.raw_conv(f'BoxPredictor_{i}/ClassPredictor',
                   f'{head}/Conv_{2 * i + 1}')


def convert_frozen_graph(consts, module, backbone):
    """{tf_const_name: ndarray} + the SSDNet module -> flat npz dict
    ('params/...', 'batch_stats/...' keys, the JAX package's .npz layout)."""
    m = _Mapper(consts, module)
    if backbone == 'mobilenet_v1':
        bb = 'MobileNetV1Backbone_0'
        pre = 'FeatureExtractor/MobilenetV1'
        m.conv(f'{pre}/Conv2d_0', f'{bb}/ConvBNReLU6_0')
        for i in range(1, 14):
            m.conv(f'{pre}/Conv2d_{i}_depthwise',
                   f'{bb}/ConvBNReLU6_{2 * i - 1}', depthwise=True)
            m.conv(f'{pre}/Conv2d_{i}_pointwise', f'{bb}/ConvBNReLU6_{2 * i}')
    elif backbone == 'mobilenet_v2':
        bb = 'MobileNetV2Backbone_0'
        pre = 'FeatureExtractor/MobilenetV2'
        m.conv(f'{pre}/Conv', f'{bb}/ConvBNReLU6_0')
        for i in range(17):
            blk = f'{pre}/expanded_conv' + (f'_{i}' if i else '')
            flax_blk = f'{bb}/InvertedResidual_{i}'
            if i == 0:       # expand_ratio 1: no expand conv
                m.conv(f'{blk}/depthwise', f'{flax_blk}/ConvBNReLU6_0',
                       depthwise=True)
            else:
                m.conv(f'{blk}/expand', f'{flax_blk}/ConvBNReLU6_0')
                m.conv(f'{blk}/depthwise', f'{flax_blk}/ConvBNReLU6_1',
                       depthwise=True)
            m.conv_at(f'{blk}/project', flax_blk)
        m.conv(f'{pre}/Conv_1', f'{bb}/ConvBNReLU6_1')
    elif backbone == 'inception_v2':
        from .ssd import INCEPTION_V2_BLOCKS
        bb = 'InceptionV2Backbone_0'
        pre = 'FeatureExtractor/InceptionV2'
        # stem separable 7x7: the released depthwise_weights [7,7,3,8]
        # embed into the model's dense [7,7,3,24] kernel with the
        # cross-channel taps zero (exact; see InceptionV2Backbone)
        kpath = f'params/{bb}/Conv2d_1a_7x7_depthwise/kernel'
        h, w, cin, cout = m._leaf_shape(kpath)
        mult = cout // cin
        dw = m._tf(f'{pre}/Conv2d_1a_7x7/depthwise_weights',
                   (h, w, cin, mult))
        dense = np.zeros((h, w, cin, cout), np.float32)
        for i in range(cin):
            dense[:, :, i, i * mult:(i + 1) * mult] = dw[:, :, i, :]
        m.flat[kpath] = dense
        pw = f'{bb}/Conv2d_1a_7x7_pointwise'
        kpath = f'params/{pw}/Conv_0/kernel'
        m.flat[kpath] = m._tf(f'{pre}/Conv2d_1a_7x7/pointwise_weights',
                              m._leaf_shape(kpath))
        m.bn(f'{pre}/Conv2d_1a_7x7', pw)
        m.conv(f'{pre}/Conv2d_2b_1x1', f'{bb}/Conv2d_2b_1x1')
        m.conv(f'{pre}/Conv2d_2c_3x3', f'{bb}/Conv2d_2c_3x3')
        for name, spec in INCEPTION_V2_BLOCKS:
            if spec.get('red'):
                branches = [('Branch_0', ['Conv2d_0a_1x1', 'Conv2d_1a_3x3']),
                            ('Branch_1', ['Conv2d_0a_1x1', 'Conv2d_0b_3x3',
                                          'Conv2d_1a_3x3'])]
            else:
                branches = [('Branch_0', ['Conv2d_0a_1x1']),
                            ('Branch_1', ['Conv2d_0a_1x1', 'Conv2d_0b_3x3']),
                            ('Branch_2', ['Conv2d_0a_1x1', 'Conv2d_0b_3x3',
                                          'Conv2d_0c_3x3']),
                            ('Branch_3', ['Conv2d_0b_1x1'])]
            for br, convs in branches:
                for cname in convs:
                    m.conv(f'{pre}/{name}/{br}/{cname}',
                           f'{bb}/{name}__{br}__{cname}')
    else:
        raise ValueError(backbone)
    _map_head(m, consts, head='SSDHead_0')
    return m.flat
