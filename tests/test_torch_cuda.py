"""The port's hand-written CUDA kernels against their plain torch versions,
on the card (marker ``cuda``; they skip without one). This file imports no
JAX, so it runs on a machine that has only torch:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import pytest
import torch

from fastmot_tpu_torch.models.layers import BatchNorm, random_init_
from fastmot_tpu_torch.models.osnet import OSBlock
from fastmot_tpu_torch.ops import osnet_block as ob
from fastmot_tpu_torch.ops.osnet_block import (fold_osblock, osblock,
                                               osblock_reference,
                                               pack_osblock)

# (C_in, F, H, W) of every OSBlock at 256x128 crops
OSNET025_BLOCKS = [(16, 64, 64, 32), (64, 64, 64, 32), (64, 96, 32, 16),
                   (96, 96, 32, 16), (96, 128, 16, 8), (128, 128, 16, 8)]
OSNET10_BLOCKS = [(64, 256, 64, 32), (256, 256, 64, 32), (256, 384, 32, 16),
                  (384, 384, 32, 16), (384, 512, 16, 8), (512, 512, 16, 8)]


@pytest.fixture
def cuda_device():
    """The card, or a skip: the CUDA kernels have no CPU mode."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (python -m pytest '
                    'tests/test_torch_cuda.py on a machine with the card)')
    return torch.device('cuda')


def _folded_block(cin, features, device, gen):
    port = OSBlock(cin, features).requires_grad_(False)
    random_init_(port, gen)
    for m in port.modules():            # non-trivial BN folds
        if isinstance(m, BatchNorm):
            m.weight.uniform_(0.5, 1.5, generator=gen)
            m.bias.normal_(0.0, 0.1, generator=gen)
            m.running_mean.normal_(0.0, 0.1, generator=gen)
            m.running_var.uniform_(0.5, 1.5, generator=gen)
    port = port.to(device)
    sd = dict(port.named_parameters())
    sd.update(port.named_buffers())
    return fold_osblock(sd, cin, features)


def _rel(got, ref):
    err = (got.float() - ref.float()).abs()
    denom = ref.float().abs().max().item() + 1e-6
    return err.max().item() / denom, err.mean().item() / denom


@pytest.mark.cuda
@pytest.mark.parametrize('batch,cin,features,h,w',
                         [(b,) + s for b in (1, 3, 64, 128)
                          for s in OSNET025_BLOCKS]
                         + [(8,) + s for s in OSNET10_BLOCKS])
def test_osblock_kernel_matches_plain_on_card(cuda_device, batch, cin,
                                              features, h, w):
    gen = torch.Generator().manual_seed(cin * features)
    flat = _folded_block(cin, features, cuda_device, gen)
    x = torch.randn(batch, h, w, cin, generator=gen).to(cuda_device,
                                                        torch.bfloat16)
    before = osblock.launches
    got = osblock(x, flat, cin, features)
    torch.cuda.synchronize()
    assert osblock.launches == before + 1
    assert got.shape == (batch, h, w, features)
    assert got.dtype == torch.bfloat16
    ref = osblock_reference(x, flat, cin, features)
    # the same rounding points as the plain version; only the f32
    # summation order differs (bounds of tests/test_osnet_block.py)
    max_rel, mean_rel = _rel(got, ref)
    assert max_rel < 0.04 and mean_rel < 0.004, (max_rel, mean_rel)
    # so all but a few outputs are equal (at most 0.2 % at x0.25 and 1.3 %
    # at x1.0's deeper sums on an H100); a rounding point moved, as when a
    # bf16 multiply and add fuse into one FMA, changes far more of them
    differ = (got != ref).float().mean().item()
    assert differ < 0.05, differ


@pytest.mark.cuda
def test_osblock_wrapper_rejects_what_the_kernel_does_not_take(cuda_device):
    gen = torch.Generator().manual_seed(0)
    flat = _folded_block(16, 64, cuda_device, gen)
    x = torch.randn(2, 8, 8, 16, generator=gen).to(cuda_device,
                                                   torch.bfloat16)
    before = osblock.launches
    with pytest.raises(ValueError):
        osblock(x.float(), flat, 16, 64)                 # bf16 only
    with pytest.raises(ValueError):
        osblock(x.permute(0, 2, 1, 3), flat, 16, 64)    # contiguous only
    with pytest.raises(ValueError):
        osblock(x[..., :8].contiguous(), flat, 16, 64)  # C_in mismatch
    with pytest.raises(ValueError):
        osblock(x, flat[:-1], 16, 64)                   # weights mismatch
    assert osblock.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('cin,features,h,w', OSNET025_BLOCKS)
def test_osblock_kernel_is_bitwise_reproducible(cuda_device, cin, features,
                                                h, w):
    """No atomics: the cluster adds its band sums in rank order, so two
    calls on one input give the same bits."""
    gen = torch.Generator().manual_seed(cin + features)
    flat = _folded_block(cin, features, cuda_device, gen)
    packed = pack_osblock(flat, cin, features)
    x = torch.randn(64, h, w, cin, generator=gen).to(cuda_device,
                                                     torch.bfloat16)
    first = osblock(x, flat, cin, features, packed)
    second = osblock(x, flat, cin, features, packed)
    assert torch.equal(first, second)


@pytest.mark.cuda
def test_osblock_plan_matches_the_kernel_layout(cuda_device):
    """The Python plan's shared memory is the kernel's, for every band
    the twelve block shapes can take, with and without staged weights,
    and the packed buffers have the kernel's sizes."""
    lib = ob._lib()
    for cin, features, h, w in OSNET025_BLOCKS + OSNET10_BLOCKS:
        mid, hid = ob.block_dims(features)
        frag_n, vec_n = ob.weight_counts(cin, features)
        assert lib.osblock_frag_count(cin, features, mid) == frag_n
        assert lib.osblock_vec_count(cin, features, mid, hid) == vec_n
        for c in (1, 2, 4, 8):
            pix = h // c * w
            for counts in ((0, 0), (frag_n, vec_n)):
                assert lib.osblock_smem_bytes(pix, mid, hid, *counts) == \
                    ob.smem_bytes(pix, mid, hid, *counts)


@pytest.mark.cuda
def test_osblock_module_uses_its_packed_weights(cuda_device):
    """OSBlock on the card: the cached packed buffers give the plain
    version's output, and follow new weights."""
    gen = torch.Generator().manual_seed(4)
    block = OSBlock(64, 96).requires_grad_(False)
    random_init_(block, gen)
    block = block.to(cuda_device)
    x = torch.randn(64, 32, 16, 64, generator=gen).to(cuda_device,
                                                      torch.bfloat16)
    first = block(x)
    flat, packed = block.folded()
    assert packed is not None and packed[0].is_cuda
    max_rel, mean_rel = _rel(first, osblock_reference(x, flat, 64, 96))
    assert max_rel < 0.04 and mean_rel < 0.004, (max_rel, mean_rel)
    other = OSBlock(64, 96).requires_grad_(False)
    random_init_(other, torch.Generator().manual_seed(5))
    block.load_state_dict(other.state_dict())
    assert block.folded()[1] is not packed
    other = other.to(cuda_device)
    assert torch.equal(block(x), other(x))
