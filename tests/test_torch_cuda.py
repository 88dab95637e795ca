"""The port's hand-written CUDA kernels, and its int8 convs (im2col +
``torch._int_mm``), against their plain torch versions on the card, and the
multi-stream path on the card against the CPU (marker ``cuda``; they skip
without one). This file imports no JAX, so it runs on a machine that has
only torch:

    python -m pytest tests/test_torch_cuda.py -m cuda
"""
import pytest
import torch

from fastmot_tpu_torch.models import quantize as tq
from fastmot_tpu_torch.models.layers import BatchNorm, random_init_
from fastmot_tpu_torch.models.osnet import OSBlock, OSNet
from fastmot_tpu_torch.ops import osnet_block as ob
from fastmot_tpu_torch.ops.osnet_block import (fold_osblock, osblock,
                                               osblock_reference,
                                               pack_osblock)

# (C_in, F, H, W) of every OSBlock at 256x128 crops
OSNET025_BLOCKS = [(16, 64, 64, 32), (64, 64, 64, 32), (64, 96, 32, 16),
                   (96, 96, 32, 16), (96, 128, 16, 8), (128, 128, 16, 8)]
OSNET10_BLOCKS = [(64, 256, 64, 32), (256, 256, 64, 32), (256, 384, 32, 16),
                  (384, 384, 32, 16), (384, 512, 16, 8), (512, 512, 16, 8)]
# (batch, H, W, C_in, C_out, k, stride, groups) of the int8 convs of
# chip_smoke.py phase 10: YOLOv4-512's 3x3/2 after the stem, a 3x3 at
# 256x256x64, a 1x1 head with N = 255, OSNet's 7x7/2 (K = 147), an SSD
# extra layer (M = 8), a grouped conv
INT8_SHAPES = [(1, 256, 256, 64, 128, 3, 2, 1), (1, 256, 256, 64, 64, 3, 1, 1),
               (1, 64, 64, 256, 255, 1, 1, 1), (64, 256, 128, 3, 16, 7, 2, 1),
               (8, 2, 2, 64, 128, 3, 2, 1), (1, 64, 64, 64, 64, 3, 1, 2)]


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
                         [(b,) + s for b in (1, 3, 64, 128, 1024)
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


@pytest.mark.cuda
@pytest.mark.parametrize('batch,h,w,cin,cout,k,stride,groups', INT8_SHAPES)
def test_int8_conv_sums_match_plain_on_card(cuda_device, batch, h, w, cin,
                                            cout, k, stride, groups):
    """s8 x s8 -> s32 sums on the card equal the CPU plain version's, and
    so do int8_conv's outputs (dynamic and calibrated input ranges)."""
    gen = torch.Generator().manual_seed(cin * cout + k)
    xq = torch.randint(-127, 128, (batch, h, w, cin), generator=gen,
                       dtype=torch.int8)
    wq = torch.randint(-127, 128, (cout, cin // groups, k, k), generator=gen,
                       dtype=torch.int8)
    ref = tq.s8_conv(xq, wq, stride, 'SAME', groups)
    got = tq.s8_conv(xq.to(cuda_device), wq.to(cuda_device), stride, 'SAME',
                     groups)
    assert got.dtype == torch.int32 and torch.equal(got.cpu(), ref)
    x = torch.randn(batch, h, w, cin, generator=gen)
    scale = torch.rand(cout, 1, 1, 1, generator=gen) * 1e-3
    bias = torch.randn(cout, generator=gen)
    for t_in in (0.0, 2.5):
        before = tq.int8_conv.launches
        got = tq.int8_conv(x.to(cuda_device), wq.to(cuda_device),
                           scale.to(cuda_device), t_in, stride, 'SAME',
                           groups, bias.to(cuda_device))
        assert tq.int8_conv.launches == before + 1
        want = tq.int8_conv(x, wq, scale, t_in, stride, 'SAME', groups, bias)
        assert torch.equal(got.cpu(), want)


@pytest.mark.cuda
def test_int8_conv_raises_on_what_it_does_not_take(cuda_device):
    """On a CUDA tensor an int8 conv is _int_mm or an error, never a float
    conv."""
    x = torch.randn(1, 8, 8, 16, device=cuda_device)
    wq = torch.zeros(8, 16, 3, 3, dtype=torch.int8)
    scale = torch.ones(8, 1, 1, 1)
    before = tq.int8_conv.launches
    with pytest.raises(ValueError):             # weight on the CPU
        tq.int8_conv(x, wq, scale.to(cuda_device), 0.0)
    with pytest.raises(ValueError):             # not an int8 weight
        tq.int8_conv(x, wq.float().to(cuda_device), scale.to(cuda_device),
                     0.0)
    with pytest.raises(ValueError):             # channels
        tq.int8_conv(x[..., :12], wq.to(cuda_device), scale.to(cuda_device),
                     0.0)
    with pytest.raises(ValueError):             # int32 sums would overflow
        tq.s8_conv(torch.zeros(1, 1, 1, tq.MAX_K + 8, dtype=torch.int8,
                               device=cuda_device),
                   torch.zeros(8, tq.MAX_K + 8, 1, 1, dtype=torch.int8,
                               device=cuda_device))
    assert tq.int8_conv.launches == before


@pytest.mark.cuda
@pytest.mark.parametrize('mode', ['weights', 'dynamic'])
def test_quantized_osnet_card_matches_cpu(cuda_device, mode):
    """OSNet-x0.25 under QuantizedModule on the card against the CPU, on
    16 crops: its literal forward (no OSBlock launch) with bf16 convs that
    round their sums apart from the CPU's now and then."""
    def build(device):
        net = OSNet().requires_grad_(False)
        random_init_(net, torch.Generator().manual_seed(1))
        return tq.QuantizedModule(net.to(device).eval(), None,
                                  {'*': 0.0} if mode == 'dynamic' else None)
    x = torch.rand(16, 256, 128, 3, generator=torch.Generator().manual_seed(2))
    before = osblock.launches, tq.int8_conv.launches
    with torch.no_grad():
        got = build(cuda_device)(x.to(cuda_device)).cpu()
        ref = build('cpu')(x)
    assert osblock.launches == before[0]
    assert tq.int8_conv.launches == before[1] + (79 if mode == 'dynamic'
                                                 else 0)
    assert torch.isfinite(got).all() and got.shape == (16, 512)
    if mode == 'weights':
        max_rel, _ = _rel(got, ref)
        assert max_rel < 0.05, max_rel
    else:
        cos = torch.nn.functional.cosine_similarity(got, ref)
        assert cos.min().item() >= 0.99, cos.min().item()


def _int8_entry_point(kind, device, cache):
    from fastmot_tpu_torch.detector import SSDDetector, YOLODetector
    from fastmot_tpu_torch.feature_extractor import FeatureExtractor
    knobs = dict(quantize='int8', calib_cache=cache, device=device)
    if kind == 'yolo':
        return YOLODetector((320, 240), (0,), model='YOLOv4Tiny', **knobs)
    if kind == 'ssd':
        return SSDDetector((320, 240), (1,), model='SSDMobileNetV1',
                           tiling_grid=(2, 1), **knobs)
    return FeatureExtractor(model='OSNet025', **knobs)


@pytest.mark.cuda
@pytest.mark.parametrize('cached', [False, True], ids=['weights', 'cache'])
@pytest.mark.parametrize('kind', ['yolo', 'ssd', 'extractor'])
def test_int8_entry_points_card_match_cpu(cuda_device, tmp_path, kind,
                                          cached):
    """YOLODetector, SSDDetector and FeatureExtractor with quantize='int8',
    without a cache and with bench.py --int8's, on the card against the
    CPU: the network's outputs (the embeddings for the extractor)."""
    import json
    cache = None
    if cached:
        cache = tmp_path / 'cal.json'
        cache.write_text(json.dumps({'outputs': {}, 'inputs': {'*': 0.0}}))
    frame = torch.randint(0, 256, (240, 320, 3), dtype=torch.uint8,
                          generator=torch.Generator().manual_seed(3))
    outs = []
    for device in (cuda_device, 'cpu'):
        ep = _int8_entry_point(kind, device, cache)
        assert isinstance(ep.module, tq.QuantizedModule)
        with torch.no_grad():
            if kind == 'extractor':
                outs.append([torch.as_tensor(ep(frame.numpy(), [
                    [10, 20, 90, 200], [150, 30, 260, 220]]))])
            else:
                x = ep.preprocess(frame.to(device))
                outs.append([t.float().cpu() for t in ep.module(x)])
                ep.detect_async(frame)
                assert ep.postprocess_device()[0].shape == (128, 4)
    for got, ref in zip(*outs):
        assert torch.isfinite(got).all() and got.shape == ref.shape
        cos = torch.nn.functional.cosine_similarity(
            got.reshape(len(got), -1), ref.reshape(len(ref), -1))
        assert cos.min().item() >= 0.99, cos.min().item()


@pytest.mark.cuda
def test_calibrate_int8_cli_on_card(cuda_device, tmp_path):
    """``python -m fastmot_tpu_torch.calibrate_int8`` on the card, from
    image files (cv2 reads them)."""
    import numpy as np

    from fastmot_tpu_torch import calibrate_int8
    cv2 = pytest.importorskip('cv2')
    for i in range(2):
        cv2.imwrite(str(tmp_path / f'{i:06d}.png'), np.random.default_rng(
            i).integers(0, 256, (120, 160, 3), dtype=np.uint8))
    out = tmp_path / 'cal.json'
    calibrate_int8.main(['--images', str(tmp_path), '--model', 'YOLOv4Tiny',
                         '--out', str(out), '--n', '2'])
    act_ranges, in_ranges = tq.load_calib_ranges(out)
    assert len(in_ranges) == 20 and 'conv0' not in in_ranges
    assert len(act_ranges) == 40


def _multi_stream_run(device, mesh=None):
    """``MultiStreamMOT`` at 2 streams of 320x256 (YOLOv4-tiny, skip 2, 6
    frames) with 3 synthetic boxes a stream spliced in after the real
    batched detector ran, on ``mesh`` if given. Returns each stream's (id,
    tlbr) rows after each frame."""
    import numpy as np

    from fastmot_tpu_torch.detector import make_detections
    from fastmot_tpu_torch.parallel import MultiStreamMOT
    size, n, n_obj = (320, 256), 2, 3
    mot = MultiStreamMOT(size, n, detector_frame_skip=2, class_ids=(0,),
                         yolo_detector_cfg={'model': 'YOLOv4Tiny'},
                         tracker_cfg={'max_age': 3}, device=device,
                         mesh=mesh)
    base = np.random.default_rng(3).integers(0, 256, (size[1] + 8,
                                                      size[0] + 8, 3))

    def boxes(f, s):
        x = 30.0 + 80 * np.arange(n_obj) + 2 * f + 10 * s
        y = 40.0 + 30 * np.arange(n_obj)
        return np.stack([x, y, x + 40, y + 110], -1)

    def padded(f):
        tlbr = torch.zeros(n, 128, 4)
        for s in range(n):
            tlbr[s, :n_obj] = torch.as_tensor(boxes(f, s))
        valid = torch.arange(128).expand(n, 128) < n_obj
        return tuple(t.to(device) for t in (
            tlbr, torch.where(valid, 0, -1).int(), valid.float() * 0.9,
            valid))

    det = mot.detector
    real_post, real_dev = det.postprocess, det.postprocess_device_batch

    def post():
        real_post()
        return [make_detections(boxes(0, s), np.zeros(n_obj, int),
                                np.full(n_obj, 0.9)) for s in range(n)]

    def post_dev():
        real_dev()
        return padded(mot.frame_count)

    det.postprocess, det.postprocess_device_batch = post, post_dev
    mot.reset(1 / 30.0)
    rows = []
    for i in range(6):
        mot.step([base[i % 4:i % 4 + size[1], (i + s) % 8:(i + s) % 8
                       + size[0]].astype(np.uint8) for s in range(n)])
        rows.append([sorted((t.trk_id, t.tlbr.copy())
                            for t in mot.visible_tracks(s))
                     for s in range(n)])
    return rows


@pytest.mark.cuda
def test_multi_stream_mot_card_matches_cpu(cuda_device):
    """One YOLO batch, one OSNet call on 256 crops and the stream-axis
    tracker on the card: every stream's track IDs on every frame equal the
    CPU run's, boxes within 2 px."""
    before = osblock.launches
    got = _multi_stream_run(cuda_device)
    assert osblock.launches == before + 6 * 2        # frames 2 and 4
    want = _multi_stream_run('cpu')
    n_rows = 0
    for g_streams, w_streams in zip(got, want):
        for g, w in zip(g_streams, w_streams):
            assert [t for t, _ in g] == [t for t, _ in w]
            for (_, a), (_, b) in zip(g, w):
                assert abs(a - b).max() <= 2.0
            n_rows += len(g)
    assert n_rows == 3 * 2 * 4                       # confirmed at frame 2


@pytest.mark.cuda
def test_multi_stream_mot_on_a_one_rank_nccl_mesh(cuda_device, tmp_path):
    """``MultiStreamMOT`` over a 1x1 NCCL ``make_stream_mesh`` gives the
    mesh-less run's track IDs and boxes on every stream and frame (the
    same streams in one batch: equal to the bit)."""
    import numpy as np
    import torch.distributed as dist

    from fastmot_tpu_torch.parallel import make_stream_mesh
    want = _multi_stream_run(cuda_device)
    dist.init_process_group('nccl', init_method=f'file://{tmp_path}/store',
                            world_size=1, rank=0)
    try:
        got = _multi_stream_run(cuda_device,
                                mesh=make_stream_mesh(device='cuda'))
    finally:
        dist.destroy_process_group()
    for g_streams, w_streams in zip(got, want):
        for g, w in zip(g_streams, w_streams):
            assert [t for t, _ in g] == [t for t, _ in w]
            for (_, a), (_, b) in zip(g, w):
                np.testing.assert_array_equal(a, b)


def test_multi_stream_mot_needs_the_card_unless_asked_for_the_cpu():
    """``MultiStreamMOT`` runs on the card by default; without one it
    raises (it never falls back to the CPU)."""
    from fastmot_tpu_torch.parallel import MultiStreamMOT
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        MultiStreamMOT((160, 128), 2)
