"""The port's OSNet block (fastmot_tpu_torch/ops/osnet_block.py) and OSNet
against the JAX package: the same seeded inputs and the same weights
(moved over by fastmot_tpu_torch.weights) through the Flax modules, the
Pallas kernel in interpret mode, and the port's plain version. The CUDA
kernel itself is checked on the card by tests/test_torch_cuda.py."""
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from fastmot_tpu.models.osnet import OSBlock as FlaxOSBlock
from fastmot_tpu.models.osnet import OSNet as FlaxOSNet
from fastmot_tpu.models.osnet import force_plain_streams as jax_plain_streams
from fastmot_tpu.ops.osnet_block import fold_osblock as jax_fold
from fastmot_tpu.ops.osnet_block import osblock_fused
from fastmot_tpu_torch.models.layers import DepthwiseConv3x3, random_init_
from fastmot_tpu_torch.models.osnet import (OSBlock, OSNet,
                                            force_plain_streams)
from fastmot_tpu_torch.ops.osnet_block import (fold_osblock, osblock,
                                               osblock_reference)
from fastmot_tpu_torch.weights import flax_shapes, flax_to_state_dict

# (C_in, F, H, W, B, Pallas tile): stage 1, its identity block, stage 2,
# stage 3
SHAPES = [(16, 64, 16, 8, 4, 2), (64, 64, 16, 8, 4, 2), (64, 96, 8, 8, 4, 2),
          (96, 128, 8, 8, 4, 2)]


def flax_flat(variables) -> dict:
    """Flax variables as the flat {path: array} dict of registry.save_npz."""
    return {'/'.join(str(getattr(k, 'key', k)) for k in path): np.asarray(v)
            for path, v in jax.tree_util.tree_flatten_with_path(variables)[0]}


def perturb_bn(variables, seed):
    """Non-trivial BN statistics and affine terms, so the fold matters."""
    rng = np.random.default_rng(seed)

    def visit(path, leaf):
        name = str(getattr(path[-1], 'key', path[-1]))
        shape = np.shape(leaf)
        if name == 'mean':
            return jnp.asarray(rng.normal(0, 0.1, shape), jnp.float32)
        if name == 'var':
            return jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
        if name == 'scale':
            return jnp.asarray(rng.uniform(0.5, 1.5, shape), jnp.float32)
        if name == 'bias' and 'BatchNorm' in str(path):
            return jnp.asarray(rng.normal(0, 0.1, shape), jnp.float32)
        return leaf
    return jax.tree_util.tree_map_with_path(visit, variables)


@functools.cache
def _block(cin, features, h, w, b):
    rng = np.random.default_rng(cin + features)
    x = jnp.asarray(rng.normal(0, 1, (b, h, w, cin)).astype(np.float32)
                    ).astype(jnp.bfloat16)
    module = FlaxOSBlock(features)
    variables = perturb_bn(module.init(jax.random.PRNGKey(3), x), cin)
    port = OSBlock(cin, features).requires_grad_(False)
    port.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    sd = dict(port.named_parameters())
    sd.update(port.named_buffers())
    return x, module, variables, fold_osblock(sd, cin, features)


def _rel(got, ref):
    denom = np.abs(ref).max() + 1e-6
    return np.abs(got - ref).max() / denom, np.abs(got - ref).mean() / denom


@pytest.mark.parametrize('cin,features,h,w,b,tile', SHAPES)
def test_fold_osblock_matches_jax(cin, features, h, w, b, tile):
    x, module, variables, flat = _block(cin, features, h, w, b)
    ref = jax_fold(variables, cin, features)
    assert len(flat) == len(ref)
    for got, want in zip(flat, ref):
        assert tuple(got.shape) == tuple(want.shape)
        assert str(got.dtype) == f'torch.{want.dtype}'
        np.testing.assert_array_equal(got.float().numpy(),
                                      np.asarray(want, np.float32))


@pytest.mark.parametrize('cin,features,h,w,b,tile', SHAPES)
def test_osblock_reference_matches_flax_and_pallas(cin, features, h, w, b,
                                                   tile):
    x, module, variables, flat = _block(cin, features, h, w, b)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    got = osblock_reference(xt, flat, cin, features).float().numpy()
    flax = np.asarray(module.apply(variables, x), np.float32)
    pallas = np.asarray(osblock_fused(
        x, jax_fold(variables, cin, features), h=h, w=w, ch_in=cin,
        features=features, tile_b=tile, interpret=True), np.float32)
    # against Flax: bf16 rounds in other places (the bounds of
    # tests/test_osnet_block.py); against the Pallas kernel: the same
    # rounding points, so only f32 summation order may differ
    max_rel, mean_rel = _rel(got, flax)
    assert max_rel < 0.04 and mean_rel < 0.004, (max_rel, mean_rel)
    max_rel, mean_rel = _rel(got, pallas)
    assert max_rel < 0.01 and mean_rel < 1e-4, (max_rel, mean_rel)


def test_osblock_wrapper_on_cpu_is_the_plain_version():
    x, module, variables, flat = _block(16, 64, 16, 8, 2)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    before = osblock.launches
    got = osblock(xt, flat, 16, 64)
    assert osblock.launches == before          # no kernel launch on a CPU
    assert torch.equal(got, osblock_reference(xt, flat, 16, 64))


def test_osnet025_embedding_matches_flax():
    rng = np.random.default_rng(11)
    module = FlaxOSNet(channels=(16, 64, 96, 128), feature_dim=512)
    x = rng.uniform(0, 1, (4, 64, 32, 3)).astype(np.float32)
    variables = perturb_bn(module.init(jax.random.PRNGKey(0), x), 7)
    ref = np.asarray(module.apply(variables, jnp.asarray(x)), np.float32)
    port = OSNet().requires_grad_(False)
    port.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    got = port(torch.from_numpy(x)).numpy()
    assert got.shape == (4, 512)
    # bf16 trunk: the bound of tests/test_osnet_block.py's full forward
    max_rel, _ = _rel(got, ref)
    assert max_rel < 0.05, max_rel



def test_osblock_fold_cache_follows_load_state_dict():
    """OSBlock folds its weights once and keeps them; a load_state_dict
    after the first forward refolds, so the block then gives a fresh
    block's output, held against the Flax block."""
    x, module, variables, _ = _block(64, 96, 8, 8, 4)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32)))
    sd = flax_to_state_dict(flax_flat(variables))
    port = OSBlock(64, 96).requires_grad_(False)
    random_init_(port, torch.Generator().manual_seed(9))
    before = port(xt)                       # folds the random weights
    port.load_state_dict(sd)
    got = port(xt)
    fresh = OSBlock(64, 96).requires_grad_(False)
    fresh.load_state_dict(sd)
    assert torch.equal(got, fresh(xt))
    assert not torch.equal(got, before)
    ref = np.asarray(module.apply(variables, x), np.float32)
    max_rel, mean_rel = _rel(got.float().numpy(), ref)
    assert max_rel < 0.04 and mean_rel < 0.004, (max_rel, mean_rel)


@pytest.mark.parametrize('cin,features,h,w,b,tile', SHAPES)
def test_osblock_plain_streams_match_flax(cin, features, h, w, b, tile):
    """The literal per-stream forward (what int8 hooks) against the Flax
    block's, both under their force_plain_streams; the float main path
    still goes through the OSBlock kernel's wrapper."""
    x, module, variables, flat = _block(cin, features, h, w, b)
    xt = torch.from_numpy(np.array(x.astype(jnp.float32))).to(torch.bfloat16)
    port = OSBlock(cin, features).requires_grad_(False)
    port.load_state_dict(flax_to_state_dict(flax_flat(variables)))
    with jax_plain_streams():
        ref = np.asarray(module.apply(variables, x), np.float32)
    before = osblock.launches
    with force_plain_streams():
        got = port(xt)
    assert osblock.launches == before
    assert got.dtype == torch.bfloat16
    max_rel, mean_rel = _rel(got.float().numpy(), ref)
    assert max_rel < 0.02 and mean_rel < 1e-3, (max_rel, mean_rel)
    assert torch.equal(port(xt), osblock_reference(xt, flat, cin, features))


def test_lite_conv_depthwise_keeps_its_key_and_shape():
    """LiteConv's depthwise is the shifted-tap layer (not a grouped conv
    that int8 would run natively), under the Flax key and shape."""
    port = OSBlock(64, 96)
    assert all(isinstance(getattr(port, f'LiteConv_{i}').DepthwiseConv3x3_0,
                          DepthwiseConv3x3) for i in range(10))
    _, module, variables, _ = _block(64, 96, 8, 8, 4)
    assert flax_shapes(port) == {k: v.shape for k, v in
                                 flax_flat(variables).items()}
