"""The port's int8 quantization (fastmot_tpu_torch/models/quantize.py)
against the JAX package's (fastmot_tpu/models/quantize.py) on the CPU: the
same seeded numpy inputs and the same weights (the port's seeded random
init, carried to Flax by inverting weights.flax_to_state_dict) through the
weight quantizer, the native int8 conv, the KL search, the calibrator,
QuantizedModule and the detector and extractor knobs. The JAX side runs
jitted, as its detectors and extractor run it. The card is checked by
tests/test_torch_cuda.py."""
import json
from unittest import mock

import flax.linen as fnn
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu import detector as jdet
from fastmot_tpu import feature_extractor as jfe
from fastmot_tpu.models import osnet as josnet
from fastmot_tpu.models import quantize as jq
from fastmot_tpu.models import yolo as jyolo
from fastmot_tpu_torch import detector as tdet
from fastmot_tpu_torch import feature_extractor as tfe
from fastmot_tpu_torch.models import osnet as tosnet
from fastmot_tpu_torch.models import quantize as tq
from fastmot_tpu_torch.models import yolo as tyolo
from fastmot_tpu_torch.models.layers import BatchNorm, Conv, random_init_

MAX_REL, MEAN_REL = 0.04, 0.004        # tests/test_torch_osnet_block.py
MIN_COS = 0.999
CROPS = (2, 64, 32, 3)                 # OSNet-x0.25 at a small crop size


@pytest.fixture(scope='module', autouse=True)
def one_thread():
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


def port_model(cls, seed=0):
    """``cls.build()`` with a seeded random init and non-trivial BNs."""
    module = cls.build().requires_grad_(False)
    gen = torch.Generator().manual_seed(seed)
    random_init_(module, gen)
    for m in module.modules():
        if isinstance(m, BatchNorm):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.uniform_(-0.1, 0.1, generator=gen)
            m.running_mean.uniform_(-0.1, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    return module.eval()


def to_flax(module):
    """A port module's Flax variables (weights.flax_to_state_dict
    inverted)."""
    tree = {}
    for name, t in module.state_dict().items():
        *mods, leaf = name.split('.')
        a = t.float().numpy()
        if leaf.startswith('running_'):
            top, leaf = 'batch_stats', leaf[len('running_'):]
        elif leaf == 'weight' and a.ndim == 1:
            top, leaf = 'params', 'scale'
        elif leaf == 'weight':
            top, leaf = 'params', 'kernel'
            a = a.transpose(2, 3, 1, 0) if a.ndim == 4 else a.T
        else:
            top = 'params'
        node = tree.setdefault(top, {})
        for m in mods:
            node = node.setdefault(m, {})
        node[leaf] = jnp.asarray(a)
    return tree


def flax_leaf(tree, name):
    """The Flax leaf of a port state-dict weight name."""
    *mods, _ = name.split('.')
    for m in mods:
        tree = tree[m]
    return np.asarray(tree['kernel'])


class JaxNativeConvs:
    """Records the int8 input of every native conv the JAX package runs
    (``lax.conv_general_dilated`` with int8 operands), in call order, from
    inside jit."""

    def __init__(self):
        self.xq = []
        self._conv = jax.lax.conv_general_dilated

    def _capture(self, lhs, *args, **kwargs):
        if lhs.dtype == jnp.int8:
            jax.debug.callback(lambda v: self.xq.append(np.asarray(v)),
                               lhs, ordered=True)
        return self._conv(lhs, *args, **kwargs)

    def __enter__(self):
        self._patch = mock.patch.object(jax.lax, 'conv_general_dilated',
                                        self._capture)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


class PortNativeConvs:
    """Records the int8 input of every native conv the port runs."""

    def __init__(self):
        self.xq = []
        self._conv = tq.s8_conv

    def _capture(self, xq, *args, **kwargs):
        self.xq.append(xq.numpy().copy())
        return self._conv(xq, *args, **kwargs)

    def __enter__(self):
        self._patch = mock.patch.object(tq, 's8_conv', self._capture)
        self._patch.start()
        return self

    def __exit__(self, *exc):
        self._patch.stop()


def jax_apply(qm, q_state, x):
    return [np.asarray(h, np.float32) for h in jax.tree_util.tree_leaves(
        jax.jit(qm.apply)(q_state, jnp.asarray(x)))]


def port_apply(qm, x):
    with torch.no_grad():
        out = qm(torch.from_numpy(x))
    return [t.float().numpy() for t in
            (out if isinstance(out, (list, tuple)) else [out])]


def rel(got, ref):
    denom = np.abs(ref).max() + 1e-6
    return np.abs(got - ref).max() / denom, np.abs(got - ref).mean() / denom


def min_cos(got, ref):
    got, ref = got.reshape(len(got), -1), ref.reshape(len(ref), -1)
    return float(np.min(np.sum(got * ref, 1) / (
        np.linalg.norm(got, axis=1) * np.linalg.norm(ref, axis=1) + 1e-12)))


def close_share(got: dict, ref: dict, tol=0.05) -> float:
    return np.mean([abs(got[k] - ref[k]) <= tol * abs(ref[k]) for k in ref])


# ---------------------------------------------------------------------------
# weights, the native conv, the KL search
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('cls', [tosnet.OSNet025, tyolo.YOLOv4Tiny],
                         ids=['OSNet025', 'YOLOv4Tiny'])
def test_int8_weights_are_the_jax_bits(cls):
    module = port_model(cls)
    q_params, scales = jq.quantize_params_int8(to_flax(module))
    got = tq.quantize_state_int8(module.state_dict())
    n_jax = sum(1 for p, leaf in jax.tree_util.tree_flatten_with_path(
        q_params)[0] if leaf.dtype == jnp.int8)
    assert len(got) == n_jax > 20
    for name, (q, s) in got.items():
        assert q.dtype == torch.int8 and s.dtype == torch.float32
        jq_leaf = flax_leaf(q_params['params'], name)
        js_leaf = flax_leaf(scales['params'], name)
        perm = (2, 3, 1, 0) if q.dim() == 4 else (1, 0)
        np.testing.assert_array_equal(q.numpy().transpose(perm), jq_leaf)
        np.testing.assert_array_equal(s.numpy().transpose(perm), js_leaf)


class FlaxConvNet(fnn.Module):
    """tests/test_quantize.py's native-int8 nets, with a grouped conv."""

    @fnn.compact
    def __call__(self, x):
        x = fnn.relu(fnn.Conv(8, (3, 3), name='c0', use_bias=False)(x))
        x = fnn.relu(fnn.Conv(8, (3, 3), (2, 2), name='c1',
                              use_bias=False)(x))
        x = fnn.relu(fnn.Conv(8, (3, 3), name='grp', use_bias=False,
                              feature_group_count=2)(x))
        return fnn.Conv(4, (1, 1), name='head', use_bias=True)(x)


class PortConvNet(torch.nn.Module):
    def __init__(self):
        super().__init__()
        self.c0 = Conv(3, 8, 3)
        self.c1 = Conv(8, 8, 3, 2)
        self.grp = Conv(8, 8, 3, groups=2)
        self.head = Conv(8, 4, 1, bias=True)

    def forward(self, x):
        x = torch.relu(self.c0(x))
        x = torch.relu(self.c1(x))
        x = torch.relu(self.grp(x))
        return self.head(x)


@pytest.mark.parametrize('in_ranges', [
    {'c0': 2.5, 'c1': 1.0, 'grp': 0.73, 'head': 1.0},
    {'*': 0.0, 'head': 1.5}], ids=['calibrated', 'dynamic'])
def test_int8_conv_matches_jax(in_ranges):
    def build():
        net = PortConvNet().requires_grad_(False)
        random_init_(net, torch.Generator().manual_seed(3))
        net.head.bias.uniform_(-1, 1, generator=torch.Generator()
                               .manual_seed(4))
        return net
    x = np.random.default_rng(5).normal(0, 1, (2, 16, 16, 3)) \
        .astype(np.float32)
    jm = jq.QuantizedModule(FlaxConvNet(), in_ranges=in_ranges)
    with JaxNativeConvs() as jcap:
        want = jax_apply(jm, jm.quantize(to_flax(build())), x)[0]
    with PortNativeConvs() as tcap:
        got = port_apply(tq.QuantizedModule(build(), in_ranges=in_ranges),
                         x)[0]
    assert len(tcap.xq) == len(jcap.xq) == 4
    for a, b in zip(tcap.xq, jcap.xq):
        np.testing.assert_array_equal(a, b)
    np.testing.assert_allclose(got, want, rtol=0, atol=1e-5)


def test_s8_conv_sums_are_exact():
    """The CPU plain version against an int64 conv, 'SAME' and 'VALID',
    strided and grouped."""
    rng = np.random.default_rng(6)
    for k, s, pad, g, (h, w) in ((3, 2, 'SAME', 1, (9, 8)),
                                 (7, 2, 'SAME', 1, (12, 10)),
                                 (3, 1, 'VALID', 2, (6, 7)),
                                 (1, 1, 'SAME', 1, (5, 5))):
        xq = rng.integers(-127, 128, (2, h, w, 4), dtype=np.int8)
        wq = rng.integers(-127, 128, (6, 4 // g, k, k), dtype=np.int8)
        got = tq.s8_conv(torch.from_numpy(xq), torch.from_numpy(wq), s,
                         pad, g)
        assert got.dtype == torch.int32
        xp = torch.from_numpy(xq).long().permute(0, 3, 1, 2)
        if pad == 'SAME':
            from fastmot_tpu_torch.models.layers import same_pads
            t, b = same_pads(h, k, s)
            lft, r = same_pads(w, k, s)
            xp = torch.nn.functional.pad(xp, (lft, r, t, b))
        cols = torch.nn.functional.unfold(xp.double(), k, stride=s)
        ref = []
        for gi in range(g):
            ci = 4 // g * k * k
            wg = torch.from_numpy(wq[gi * 6 // g:(gi + 1) * 6 // g]) \
                .long().reshape(6 // g, -1)
            ref.append(torch.einsum('ok,bkl->bol', wg,
                                    cols[:, gi * ci:(gi + 1) * ci].long()))
        ref = torch.cat(ref, 1).reshape(2, 6, *got.shape[1:3])
        assert torch.equal(got.long(), ref.permute(0, 2, 3, 1))


def test_s8_conv_rejects_what_it_does_not_take():
    xq = torch.zeros(1, 4, 4, 4, dtype=torch.int8)
    wq = torch.zeros(4, 4, 3, 3, dtype=torch.int8)
    with pytest.raises(ValueError):
        tq.s8_conv(xq.float(), wq)                      # int8 only
    with pytest.raises(ValueError):
        tq.s8_conv(xq, wq[:, :2], groups=1)             # channels
    with pytest.raises(ValueError):                     # int32 overflow
        tq.s8_conv(torch.zeros(1, 1, 1, tq.MAX_K + 1, dtype=torch.int8),
                   torch.zeros(1, tq.MAX_K + 1, 1, 1, dtype=torch.int8))


def test_kl_threshold_is_the_jax_bits():
    rng = np.random.default_rng(7)
    for seed in range(6):
        vals = np.abs(np.concatenate([rng.normal(0, 1, 20000),
                                      rng.normal(0, 6, 40 * seed)]))
        h, edges = np.histogram(vals, bins=512, range=(0, vals.max()))
        assert tq.kl_threshold(h, edges[1:]) == \
            jq.kl_threshold(h, edges[1:])


def test_kl_threshold_unclipped_candidate():
    """With as many bins as levels only the unclipped candidate i == n is
    searched: the JAX package indexes past the end, the port returns the
    top edge (ROADMAP.md section 3)."""
    h = np.random.default_rng(8).integers(1, 50, 128)
    edges = np.linspace(0, 3.0, 129)[1:]
    with pytest.raises(IndexError):
        jq.kl_threshold(h, edges)
    assert tq.kl_threshold(h, edges) == 3.0


# ---------------------------------------------------------------------------
# QuantizedModule on OSNet-x0.25 (the calibrated modes:
# tests/test_torch_quantize_models.py)
# ---------------------------------------------------------------------------

def check_osnet_mode(variables, act_ranges=None, in_ranges=None,
                     port_module=None):
    """OSNet-x0.25 under the JAX package's QuantizedModule and the port's
    (``port_module``, else one built from ``variables``' seed) agree:
    weight-only by the trunk's bf16 bounds; with fake-quant or native
    convs by cosine, since fake-quant of a bf16 map may skip an
    intermediate rounding under XLA's excess precision and flip a level.
    The OSBlock kernel is not launched."""
    x = np.random.default_rng(10).uniform(-2, 2, CROPS).astype(np.float32)
    jm = jq.QuantizedModule(josnet.OSNet025.build(), act_ranges, in_ranges)
    want = jax_apply(jm, jm.quantize(variables), x)[0]
    tm = port_module or tq.QuantizedModule(port_model(tosnet.OSNet025),
                                           act_ranges, in_ranges)
    assert tm.act_ranges == (dict(jm.act_ranges) if jm.act_ranges else None)
    assert tm.in_ranges == (dict(jm.in_ranges) if jm.in_ranges else None)
    before = tosnet.osblock.launches
    got = port_apply(tm, x)[0]
    assert tosnet.osblock.launches == before
    assert got.shape == want.shape == (2, 512)
    if act_ranges is None and in_ranges is None:
        max_rel, mean_rel = rel(got, want)
        assert max_rel < MAX_REL and mean_rel < MEAN_REL, (max_rel,
                                                           mean_rel)
    else:
        assert min_cos(got, want) >= MIN_COS


@pytest.mark.parametrize('in_ranges', [None, {'*': 0.0}],
                         ids=['weights', 'dynamic'])
def test_osnet_int8_matches_jax(in_ranges):
    """Weight-only, and native convs at dynamic ranges (bench.py
    --int8)."""
    check_osnet_mode(to_flax(port_model(tosnet.OSNet025)),
                     in_ranges=in_ranges)


def test_quantized_module_holds_int8_buffers():
    module = port_model(tosnet.OSNet025)
    n_weights = sum(1 for _, p in module.named_parameters() if p.dim() >= 2)
    qm = tq.QuantizedModule(module)
    q = [b for name, b in qm.named_buffers() if name.endswith('weight_int8')]
    assert len(q) == n_weights and all(b.dtype == torch.int8 for b in q)
    assert not any(p.dim() >= 2 for p in qm.parameters())


# ---------------------------------------------------------------------------
# darknet: the stem, the calibrator, the detector knob
# ---------------------------------------------------------------------------

@pytest.mark.parametrize('explicit', [True, False],
                         ids=['explicit', 'wildcard'])
def test_darknet_stem_never_runs_natively(explicit):
    """YOLOv4-tiny's stem conv0 folds to space-to-depth in the JAX package
    (a _StemConv, no nn.Conv): it is never native, not even with an entry
    of its own; every other conv is."""
    module = port_model(tyolo.YOLOv4Tiny)
    keys = [n for n, m in module.named_modules() if isinstance(m, Conv)]
    in_ranges = {k: 4.0 for k in keys} if explicit else {'*': 0.0}
    x = np.random.default_rng(11).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    jm = jq.QuantizedModule(jyolo.YOLOv4Tiny.build(), in_ranges=in_ranges)
    with JaxNativeConvs() as jcap:
        want = jax_apply(jm, jm.quantize(to_flax(module)), x)
    with PortNativeConvs() as tcap:
        got = port_apply(tq.QuantizedModule(port_model(tyolo.YOLOv4Tiny),
                                            in_ranges=in_ranges), x)
    assert module.stem_layers(64, 64) == 1 and keys[0] == 'conv0'
    assert len(tcap.xq) == len(jcap.xq) == len(keys) - 1 == 20
    for g, w in zip(got, want):
        assert min_cos(g, w) >= MIN_COS


def test_calibrator_on_yolov4_tiny():
    """Input ranges as in the JAX package (20, none for the stem conv0);
    output ranges where the JAX package raises on the list of heads."""
    rng = np.random.default_rng(12)
    batches = [rng.uniform(0, 1, (1, 64, 64, 3)).astype(np.float32)
               for _ in range(2)]
    module = port_model(tyolo.YOLOv4Tiny)
    jcal = jq.EntropyCalibrator(jyolo.YOLOv4Tiny.build(), to_flax(module),
                                num_bins=256)
    tcal = tq.EntropyCalibrator(module, num_bins=256)
    for b in batches:
        jcal.observe(b)
        tcal.observe(b)
    jin, tin = jcal.compute_input_ranges(), tcal.compute_input_ranges()
    assert set(tin) == set(jin) and len(tin) == 20 and 'conv0' not in tin
    assert close_share(tin, jin) >= 0.95
    with pytest.raises(ValueError, match='inhomogeneous'):
        jcal.compute_ranges()
    tout = tcal.compute_ranges()
    assert '__call__' not in tout and 'conv0' in tout and 'bn20' in tout


@pytest.fixture
def jax_weights_of_port(monkeypatch):
    """The JAX package's models take the port's seeded weights."""
    def use(jcls, tcls):
        variables = to_flax(tcls.init_params('cpu'))
        monkeypatch.setattr(jcls, 'init_params', classmethod(
            lambda cls, seed=0: (cls.build(), variables)))
    return use


def test_feature_extractor_int8_knob_matches_jax(jax_weights_of_port):
    jax_weights_of_port(josnet.OSNet025, tosnet.OSNet025)
    rng = np.random.default_rng(13)
    frame = rng.integers(0, 256, (120, 160, 3), dtype=np.uint8)
    tlbrs = np.array([[10, 10, 60, 100], [80, 20, 140, 110]], np.float32)
    jx = jfe.FeatureExtractor(model='OSNet025', quantize='int8')
    tx = tfe.FeatureExtractor(model='OSNet025', quantize='int8',
                              device='cpu')
    assert isinstance(tx.module, tq.QuantizedModule)
    want = jx(frame, tlbrs)
    got = tx(frame, tlbrs)
    assert got.shape == want.shape == (2, 512)
    max_rel, mean_rel = rel(got, want)
    assert max_rel < MAX_REL and mean_rel < MEAN_REL, (max_rel, mean_rel)


def test_yolo_detector_native_int8_knob_matches_jax(jax_weights_of_port,
                                                    tmp_path):
    """tests/test_quantize.py's cache, an input range for every conv (the
    stem's included), through the knobs of both packages. The first
    native conv's input is the JAX package's but for the rare value whose
    f32 stem sum rounds across a level; a flipped level moves the sums of
    the next conv, so flips spread by layer (about 4 % of the inputs of
    the twentieth conv at 416x416): the heads agree by cosine."""
    jax_weights_of_port(jyolo.YOLOv4Tiny, tyolo.YOLOv4Tiny)
    names = [n for n, m in tyolo.YOLOv4Tiny.build().named_modules()
             if isinstance(m, Conv)]
    cache = tmp_path / 'cal.json'
    cache.write_text(json.dumps({'outputs': {},
                                 'inputs': {k: 4.0 for k in names}}))
    cfg = dict(model='YOLOv4Tiny', quantize='int8', calib_cache=cache)
    jd = jdet.YOLODetector((320, 256), (0,), **cfg)
    td = tdet.YOLODetector((320, 256), (0,), device='cpu', **cfg)
    assert td.module.in_ranges == dict(jd.module.in_ranges)
    frame = np.random.default_rng(14).integers(0, 256, (256, 320, 3),
                                               dtype=np.uint8)
    x = td.preprocess(torch.from_numpy(frame)).numpy()
    with PortNativeConvs() as tcap:
        got = port_apply(td.module, x)
    with JaxNativeConvs() as jcap:
        want = jax_apply(jd.module, jd.params, x)
    assert len(tcap.xq) == len(jcap.xq) == len(names) - 1
    assert (tcap.xq[0] != jcap.xq[0]).mean() < 1e-5
    for a, b in zip(tcap.xq, jcap.xq):
        assert np.abs(a.astype(np.int32) - b).max() <= 2
    for g, w in zip(got, want):
        assert min_cos(g, w) >= 0.95
    # random weights: about 60 weak boxes; flips near the 0.25 confidence
    # bound add or drop a few
    boxes_t, boxes_j = td(torch.from_numpy(frame)).tlbr, jd(frame).tlbr
    found = [np.abs(boxes_j - b).max(1).min() <= 2 for b in boxes_t]
    assert len(boxes_j) > 10 and np.sum(found) >= 0.9 * len(boxes_j)


def test_calibrate_int8_cli_on_yolov4_tiny(tmp_path):
    """``python -m fastmot_tpu_torch.calibrate_int8`` writes a cache the
    detector knob reads (the JAX script fails for YOLO models)."""
    import cv2
    from fastmot_tpu_torch import calibrate_int8
    rng = np.random.default_rng(15)
    for i in range(3):
        cv2.imwrite(str(tmp_path / f'{i:06d}.png'),
                    rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
    out = tmp_path / 'cal.json'
    calibrate_int8.main(['--images', str(tmp_path), '--model', 'YOLOv4Tiny',
                         '--out', str(out), '--n', '2', '--device', 'cpu'])
    act_ranges, in_ranges = tq.load_calib_ranges(out)
    assert len(in_ranges) == 20 and 'conv0' not in in_ranges
    # the 21 convs and 19 BNs; no range for the root's list of heads
    assert '__call__' not in act_ranges and len(act_ranges) == 40
    det = tdet.YOLODetector((160, 120), (0,), model='YOLOv4Tiny',
                            quantize='int8', calib_cache=out, device='cpu')
    assert det.module.in_ranges == in_ranges
