"""Tensor parallelism over the mesh's 'model' axis for every model of the
zoo, on gloo CPU ranks spawned by ``fastmot_tpu_torch.multichip.run_ranks``:

- ``shard_conv_channels`` accepts all 16 registered models (the eleven
  YOLOs, the three SSDs, both OSNets) and slices exactly the leaves of
  ``conv_channel_plan``, the Flax paths the JAX package's
  ``conv_channel_shardings`` shards (tests/test_torch_parallel.py holds
  the plan against JAX's);
- sharded equals unsharded, same random weights with BNs away from
  identity: SSD-MobileNetV2 and SSD-InceptionV2 2 ways at 300x300,
  OSNet-x1.0 2 ways and OSNet-x0.25 4 ways on 8 crops (the OSBlock
  through its kernel's plain version and through the literal per-stream
  forward; its weights are gathered, the rest runs on channel blocks).
  Tolerance: 1e-5 of each output's largest magnitude, as the YOLO test of
  tests/test_torch_parallel.py (an output channel's sums are the
  unsharded ones; only a conv algorithm chosen for fewer outputs can
  reorder an f32 sum);
- the port's twin of tests/test_parallel.py's YOLOv4-P6 test: the whole P6
  graph 2 ways at 256x256, more than 200 sharded leaves and the four
  heads within that test's rtol 1e-2 / atol 1.5e-3;
- ``dryrun_multichip`` at 2 ranks (one stream, 2-way 'model') with the
  512-d ReID features split over 'model' gives the unsplit step's
  matches (``col4row``), track validity and history store, and its costs
  within 1e-5 relative (the partial norms and dot products are summed
  over the ranks); the same step on one rank (all 512 features) is the
  unsplit baseline;
- ``split_feature_dists`` on a single slice (an identity all-reduce)
  gives ``assoc_costs_core``'s own euclidean distances within 1e-5
  relative, and refuses the cosine metric.
"""
import numpy as np
import pytest
import torch

from fastmot_tpu_torch import multichip
from fastmot_tpu_torch.ops import distance as dist_ops
from fastmot_tpu_torch.models import registry
from fastmot_tpu_torch.parallel import (conv_channel_plan,
                                        shard_conv_channels)
from fastmot_tpu_torch.tracker import normalized_feats, split_feature_dists
from fastmot_tpu_torch.weights import flax_shapes

from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

OUT_REL = 1e-5
P6_RTOL, P6_ATOL = 1e-2, 1.5e-3
COST_REL = 1e-5


class _Mesh:
    """A 2-way 'model' axis seen from its rank 1, for slicing alone (no
    collective runs, so no process group is needed)."""
    mesh_dim_names = ('streams', 'model')

    def size(self, dim):
        return 2 if dim == 1 else 1

    def get_local_rank(self, axis):
        return 1 if axis == 'model' else 0

    def get_group(self, axis):
        return None


def _every_model():
    return sorted([*registry._YOLO_REGISTRY, *registry._SSD_REGISTRY,
                   *registry._REID_REGISTRY])


def test_every_registered_model_shards():
    names = _every_model()
    assert len(names) == 16
    for name in names:
        with torch.device('meta'):
            module = multichip.zoo_module(name)
        before = flax_shapes(module)
        plan = conv_channel_plan(module, 2)
        assert shard_conv_channels(module, _Mesh()) == plan, name
        after = flax_shapes(module)
        assert sorted(p for p in before if after[p] != before[p]) == plan
        for p in plan:
            assert after[p][-1] * 2 == before[p][-1], (name, p)


def test_a_foreign_layer_is_refused():
    module = torch.nn.Sequential(torch.nn.Conv2d(3, 4, 1))
    with pytest.raises(TypeError, match='Conv2d'):
        shard_conv_channels(module, _Mesh())


FORWARD_CASES = [('SSDMobileNetV2', 2, (1, 300, 300, 3)),
                 ('SSDInceptionV2', 2, (1, 300, 300, 3)),
                 ('OSNet10', 2, (2, 256, 128, 3)),
                 ('OSNet025', 4, (8, 256, 128, 3))]


def _check_ranks(name, k, ranks, module):
    plan = conv_channel_plan(module, k)
    full = flax_shapes(module)
    for out in ranks:
        assert out['plan'] == plan
        split = sorted(p for p, s in out['shapes'].items() if s != full[p])
        assert split == plan, name
        for p in plan:
            assert out['shapes'][p][-1] * k == full[p][-1]
    return plan


@pytest.mark.parametrize('name,k,shape', FORWARD_CASES,
                         ids=[f'{c[0]}-{c[1]}' for c in FORWARD_CASES])
def test_sharded_forward_matches_unsharded(name, k, shape):
    x = np.random.default_rng(5).uniform(0, 1, shape).astype(np.float32)
    module = multichip.zoo_module(name, seed=1, varied_bn=True)
    osnet = name.startswith('OSNet')
    want = multichip.zoo_outputs(module, x)
    ranks = multichip.run_ranks(k, multichip.sharded_heads_rank,
                                (name, x, k, 1, True, osnet))
    assert len(_check_ranks(name, k, ranks, module)) > 100
    wants = [('heads', want)]
    if osnet:
        wants.append(('literal', multichip.zoo_outputs(module, x, True)))
    for out in ranks:
        for key, ref in wants:
            assert [g.shape for g in out[key]] == [w.shape for w in ref]
            for g, w in zip(out[key], ref):
                np.testing.assert_allclose(
                    g, w, rtol=0, atol=OUT_REL * np.abs(w).max(),
                    err_msg=f'{name} {key}')


def test_p6_tensor_parallelism():
    """YOLOv4-P6, the model the 'model' axis is for, 2 ways at 256x256
    (a stride-64 input: every conv and its sharding as at 1280x1280)."""
    x = np.random.default_rng(5).uniform(0, 1, (1, 256, 256, 3)) \
        .astype(np.float32)
    module = multichip.zoo_module('YOLOv4P6', seed=1)
    want = multichip.zoo_outputs(module, x)
    assert len(want) == 4            # P6's four heads all present
    ranks = multichip.run_ranks(2, multichip.sharded_heads_rank,
                                ('YOLOv4P6', x, 2, 1))
    assert len(_check_ranks('YOLOv4P6', 2, ranks, module)) > 200
    for out in ranks:
        for g, w in zip(out['heads'], want):
            np.testing.assert_allclose(g, w, rtol=P6_RTOL, atol=P6_ATOL)


def test_dryrun_feature_split_matches_unsplit(monkeypatch):
    monkeypatch.setenv('FASTMOT_DRYRUN_MODEL', 'YOLOv4Tiny')
    # one rank holds all 512 features of the same single stream, from the
    # same inputs and draws (the 2-rank mesh has one stream, 2-way TP)
    whole = multichip.dryrun_multichip(1, device='cpu')
    split = multichip.dryrun_multichip(2, device='cpu')
    assert [r['features'] for r in split] == [(0, 256), (256, 512)]
    assert [r['features'] for r in whole] == [(0, 512)]
    want = whole[0]
    assert want['valid'][0, :8].all()
    for got in split:
        np.testing.assert_array_equal(got['col4row'], want['col4row'])
        np.testing.assert_array_equal(got['valid'], want['valid'])
        for key in ('cost', 'reid_cost'):
            np.testing.assert_allclose(got[key], want[key], rtol=COST_REL,
                                       atol=0, err_msg=key)
        for g, w in zip(got['hist'][1:], want['hist'][1:]):
            np.testing.assert_array_equal(g, w)
    # the feature sums and the history, put back together from the slices
    for key, get in (('feat_sum', lambda r: r['feat_sum']),
                     ('hist_sum', lambda r: r['hist'][0])):
        whole_feats = np.concatenate([get(r) for r in split], -1)
        np.testing.assert_array_equal(whole_feats, get(want), err_msg=key)


def test_split_feature_dists_single_slice():
    rng = np.random.default_rng(3)
    s, t, h, d, f = 2, 6, 5, 7, 16
    feat_sum, hist_sum, emb = (
        torch.tensor(rng.normal(size=(s, n, f)), dtype=torch.float32)
        for n in (t, h, d))
    feat_count = torch.tensor(rng.integers(0, 4, (s, t)), dtype=torch.float32)
    hist_count = torch.tensor(rng.integers(1, 4, (s, h)), dtype=torch.float32)
    got = split_feature_dists(dist_ops.Metric.EUCLIDEAN, feat_sum,
                              feat_count, hist_sum, hist_count, emb,
                              lambda x: None)
    for i in range(s):
        for g, f_sum, count in ((got[0], feat_sum, feat_count),
                                (got[1], hist_sum, hist_count)):
            want = dist_ops.cdist(normalized_feats(f_sum[i], count[i]),
                                  emb[i], dist_ops.Metric.EUCLIDEAN)
            np.testing.assert_allclose(g[i], want, rtol=COST_REL, atol=0)
    with pytest.raises(ValueError):
        split_feature_dists(dist_ops.Metric.COSINE, feat_sum, feat_count,
                            hist_sum, hist_count, emb, lambda x: None)
