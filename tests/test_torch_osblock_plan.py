"""What surrounds the port's OSBlock kernel, on the CPU: the launch plan
(bands, shared memory, CTAs), the packed weight layout the kernel reads,
the fold cache of ``OSBlock``, and the entry points' device default. The
kernel itself runs only on the card (tests/test_torch_cuda.py)."""
import numpy as np
import pytest
import torch

from fastmot_tpu_torch import (FeatureExtractor, Flow, KalmanFilter, MOT,
                               MultiTracker, app)
from fastmot_tpu_torch.detector import (PublicDetector, SSDDetector,
                                        YOLODetector)
from fastmot_tpu_torch.models.layers import random_init_
from fastmot_tpu_torch.models.osnet import OSBlock
from fastmot_tpu_torch.ops import osnet_block as ob
from fastmot_tpu_torch.parallel import StreamTracker

# (C_in, F, H, W) of every OSBlock at 256x128 crops
OSNET025_BLOCKS = [(16, 64, 64, 32), (64, 64, 64, 32), (64, 96, 32, 16),
                   (96, 96, 32, 16), (96, 128, 16, 8), (128, 128, 16, 8)]
OSNET10_BLOCKS = [(64, 256, 64, 32), (256, 256, 64, 32), (256, 384, 32, 16),
                  (384, 384, 32, 16), (384, 512, 16, 8), (512, 512, 16, 8)]
BATCHES = (1, 3, 64, 128)
H100_SMEM = 227 * 1024          # opt-in shared memory a block may use


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test workers on the
    cores, and an oversubscribed thread pool slows these small ops."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.mark.parametrize('cin,features,h,w',
                         OSNET025_BLOCKS + OSNET10_BLOCKS)
def test_launch_plan_covers_every_row_once(cin, features, h, w):
    for batch in BATCHES:
        plan = ob.launch_plan(batch, h, w, cin, features)
        rows = [r for band in plan.bands() for r in band]
        assert rows == list(range(h))
        assert plan.cluster * plan.rows == h
        assert plan.rows * w % 16 == 0          # whole 16-pixel mma tiles
        assert plan.ctas == batch * plan.cluster


@pytest.mark.parametrize('cin,features,h,w',
                         OSNET025_BLOCKS + OSNET10_BLOCKS)
def test_launch_plan_fits_in_shared_memory(cin, features, h, w):
    mid, hid = ob.block_dims(features)
    for batch in BATCHES:
        plan = ob.launch_plan(batch, h, w, cin, features)
        assert plan.smem <= H100_SMEM
        staged = ob.weight_counts(cin, features) if plan.stage_weights \
            else (0, 0)
        assert plan.smem == ob.smem_bytes(plan.rows * w, mid, hid, *staged)
        assert 1 <= plan.cluster <= ob.MAX_CLUSTER


@pytest.mark.parametrize('cin,features,h,w', OSNET025_BLOCKS)
def test_launch_plan_fills_the_card_at_64_crops(cin, features, h, w):
    """The main path's 64 crops: at least 128 CTAs, every x0.25 block's
    weights in shared memory."""
    plan = ob.launch_plan(64, h, w, cin, features)
    assert plan.ctas >= 128
    assert plan.stage_weights
    assert plan.variant == 'weights in shared memory'


def test_launch_plan_rejects_what_no_kernel_takes():
    with pytest.raises(ValueError):
        ob.launch_plan(64, 32, 16, 64, 192)      # mid 48: no instance
    with pytest.raises(ValueError):
        ob.launch_plan(64, 32, 16, 40, 96)       # C_in not a multiple of 16
    with pytest.raises(ValueError):
        ob.launch_plan(1, 64, 32, 64, 64, smem_limit=48 * 1024)


def _folded(cin, features, seed):
    block = OSBlock(cin, features).requires_grad_(False)
    random_init_(block, torch.Generator().manual_seed(seed))
    sd = dict(block.named_parameters())
    sd.update(block.named_buffers())
    return ob.fold_osblock(sd, cin, features)


@pytest.mark.parametrize('cin,features,h,w',
                         OSNET025_BLOCKS + OSNET10_BLOCKS)
def test_packed_weights_unpack_to_the_fold_exactly(cin, features, h, w):
    flat = _folded(cin, features, cin + features)
    frag, vec = ob.pack_osblock(flat, cin, features)
    assert frag.dtype == torch.bfloat16 and vec.dtype == torch.float32
    assert (frag.numel(), vec.numel()) == ob.weight_counts(cin, features)
    back = ob.unpack_osblock(frag, vec, cin, features)
    assert len(back) == len(flat)
    for got, want in zip(back, flat):
        assert got.dtype == want.dtype and got.shape == want.shape
        assert torch.equal(got, want)


@pytest.mark.parametrize('k,n', [(16, 16), (24, 24), (64, 96), (96, 128)])
def test_fragment_order_is_the_mma_b_layout(k, n):
    """Lane 4 g + t of tile (nt, kt) holds B[16 kt + 2t + {0, 1, 8, 9},
    8 nt + g], the m16n8k16 B fragment; rows past K are zero."""
    rng = np.random.default_rng(k * n)
    wt = torch.from_numpy(rng.normal(size=(k, n)).astype(np.float32)) \
        .to(torch.bfloat16)
    frag = ob._frag(wt).float().numpy()
    k16 = -(-k // 16) * 16
    padded = np.zeros((k16, n), np.float32)
    padded[:k] = wt.float().numpy()
    tiles = frag.reshape(n // 8, k16 // 16, 32, 4)
    for nt in range(n // 8):
        for kt in range(k16 // 16):
            for lane in range(32):
                g, t = divmod(lane, 4)
                rows = [16 * kt + 2 * t + d for d in (0, 1, 8, 9)]
                np.testing.assert_array_equal(
                    tiles[nt, kt, lane], padded[rows, 8 * nt + g])


def test_pack_rejects_a_wrong_weight_list():
    flat = _folded(16, 64, 0)
    with pytest.raises(ValueError):
        ob.pack_osblock(flat[:-1], 16, 64)
    with pytest.raises(ValueError):
        ob.pack_osblock([flat[1]] + flat[1:], 16, 64)


def test_osblock_folds_once_until_its_weights_change(monkeypatch):
    """No folding per call: the fold runs at the first forward, and again
    only after an in-place write or a new storage."""
    from fastmot_tpu_torch.models import osnet
    calls = []
    fold = osnet.fold_osblock
    monkeypatch.setattr(osnet, 'fold_osblock',
                        lambda *a: calls.append(1) or fold(*a))
    block = OSBlock(16, 64).requires_grad_(False)
    random_init_(block, torch.Generator().manual_seed(1))
    x = torch.randn(2, 8, 8, 16, generator=torch.Generator().manual_seed(2))
    first = block(x)
    block(x)
    assert len(calls) == 1
    assert block.folded()[1] is None             # nothing packed on a CPU
    with torch.no_grad():
        block.LiteConv_3.BatchNorm_0.running_var.mul_(2.0)
    changed = block(x)
    assert len(calls) == 2 and not torch.equal(first, changed)
    block.to('cpu')                              # the same storages
    block(x)
    assert len(calls) == 2


ENTRY_POINTS = {
    'MOT': lambda: MOT((160, 120)),
    'YOLODetector': lambda: YOLODetector((160, 120), (1,)),
    'SSDDetector': lambda: SSDDetector((160, 120), (1,)),
    'PublicDetector': lambda: PublicDetector((160, 120), (1,), 3),
    'FeatureExtractor': lambda: FeatureExtractor(),
    'MultiTracker': lambda: MultiTracker((160, 120), 'euclidean'),
    'Flow': lambda: Flow((160, 120)),
    'KalmanFilter': lambda: KalmanFilter(),
    'StreamTracker': lambda: StreamTracker((160, 120), 'euclidean', 2),
    'CLI': lambda: app.main(['-i', 'missing.mp4', '--mot']),
}


@pytest.mark.parametrize('name', sorted(ENTRY_POINTS))
def test_entry_points_need_the_card_unless_asked_for_the_cpu(name):
    """Every entry point runs on the card by default; without one it
    raises (it never falls back to the CPU)."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        ENTRY_POINTS[name]()
