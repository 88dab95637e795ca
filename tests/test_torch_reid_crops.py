"""The ReID input kernel of the port (``csrc/reid_crops.cu``, wrapper
``ops.reid_crops.reid_crops``, plain version ``reid_crops_reference``):
every box's crop resized to OSNet's input, BGR -> RGB, ImageNet's mean and
std, in one launch.

On the CPU:

- the plain version against the JAX package's ``crop_resize_batch`` and
  the lines of ``_extract_core`` before the network (the network stood in
  by a module that hands its input back): the crops equal JAX's to the
  bit, the normalised input within 1e-6 (JAX divides by 255 where the
  port multiplies by the float32 reciprocal, as torch's CUDA division by
  a Python scalar does: an ulp of x / 255, which the mean's subtraction
  and the std's division carry to at most 7.2e-7, three float32 ulps of
  values near 2.4);
- the kernel's own source built for the host with g++ through
  tests/cuda_host_shim.py (a launch's blocks in turn on a team of host
  threads; the kernel strides its loops by the block's thread count, so
  teams of 32, 64 and 96 threads compute what 128 do): bit for bit the
  plain version on seeded cases (boxes past every frame edge, 1-pixel
  boxes, boxes larger than the frame, three streams, float frames whose
  values round to bf16, two crops at OSNet's 256 x 128), and every output's
  sha256 as the first design gave it (``OUTPUT_SHA256``);
- edge cases (``EDGE_KINDS``: crops one column wide, 13 columns whose rows
  are never 16-byte aligned, boxes too tall for a band's kept column pass,
  1-pixel boxes and boxes past every edge at 256 x 128, boxes with NaN
  corners, float frames at two streams) against the plain version and the
  sha256 a host build of the first design's source gave
  (``EDGE_SHA256``, NaNs made canonical);
- bf16 output (``out_dtype=torch.bfloat16``): the float32 output rounded,
  as the plain version's ``.to(torch.bfloat16)``, bit for bit; and
  OSNet-x0.25's embeddings of the bf16 crops equal those of the float32
  crops (the stem rounds its input to bf16 first), which is why
  ``extract_core`` asks the float OSNet for bf16 and a
  ``QuantizedModule`` for float32.

On the card (marker ``cuda``; they skip without one):

    python -m pytest tests/test_torch_reid_crops.py -m cuda
"""
import hashlib

import numpy as np
import pytest
import torch

from fastmot_tpu_torch.ops import reid_crops as rc

from .cuda_host_shim import build_host

F32 = np.float32
KINDS = ('edges', 'streams', 'float', 'osnet')
# JAX against the plain version: the normalised input (the module's
# docstring: 7.2e-7 read on the seeded cases)
JAX_ATOL = 1e-6


def T(a):
    return torch.from_numpy(np.ascontiguousarray(a))


def edge_boxes(rng, n, fh, fw):
    """``n`` boxes: random ones inside, then past each edge, 1-pixel,
    larger than the frame, and with fractional corners."""
    x = rng.uniform(0, fw - 10, n)
    y = rng.uniform(0, fh - 10, n)
    boxes = np.stack([x, y, x + rng.uniform(2, 30, n),
                      y + rng.uniform(2, 40, n)], -1)
    fixed = np.array([[-20.3, -7.0, 15.0, 12.0],          # past top-left
                      [fw - 9.0, fh - 5.0, fw + 30.0, fh + 9.5],
                      [-5.0, 10.0, fw + 5.0, 20.0],       # wider than it
                      [11.0, 13.0, 11.0, 13.0],           # 1 pixel
                      [3.7, 4.2, 3.9, 4.9],               # 1 pixel, floored
                      [-100.0, -100.0, fw + 100.0, fh + 100.0],
                      [fw + 3.0, 2.0, fw + 8.0, 9.0],     # right of it
                      [0.0, fh - 1.0, fw - 1.0, fh - 1.0]])
    return np.concatenate([fixed, boxes])[:max(n, len(fixed))].astype(F32)


def crop_case(kind, seed=0):
    """(frames, tlbrs, out_hw) of a kind of case, numpy: frames [H, W, 3]
    or [S, H, W, 3], tlbrs [N, 4] or [S, D, 4]."""
    rng = np.random.default_rng(seed)
    if kind == 'edges':
        frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
        return frame, edge_boxes(rng, 12, 37, 53), (24, 12)
    if kind == 'streams':
        frames = rng.integers(0, 256, (3, 40, 48, 3), dtype=np.uint8)
        boxes = np.stack([edge_boxes(rng, 8, 40, 48) for _ in range(3)])
        return frames, boxes, (16, 8)
    if kind == 'float':
        frame = (rng.uniform(0, 255, (30, 44, 3))).astype(F32)
        return frame, edge_boxes(rng, 9, 30, 44), (20, 10)
    if kind == 'osnet':
        frame = rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
        return frame, np.array([[10.0, 3.0, 50.2, 70.0],
                                [-4.0, 30.0, 140.0, 90.0]], F32), (256, 128)
    raise ValueError(kind)


# cases at the kernel's edges: crops one column wide; 13 columns, whose
# rows of 39 floats are never 16-byte aligned, from frames 61 pixels wide;
# boxes wider than the kernel stages in shared memory; 1-pixel boxes and
# boxes past every edge at OSNet's 256 x 128; boxes with NaN corners; float
# frames at two streams
EDGE_KINDS = ('ow1', 'ow_odd', 'wide', 'tiny', 'nan', 'float_streams')
NAN_BOXES = (1, 4, 6)          # the rows of the 'nan' case's NaN boxes


def edge_crop_case(kind, seed=7):
    """(frames, tlbrs, out_hw) of an edge case, numpy."""
    rng = np.random.default_rng(seed)
    if kind == 'ow1':
        frame = rng.integers(0, 256, (37, 53, 3), dtype=np.uint8)
        return frame, edge_boxes(rng, 10, 37, 53), (9, 1)
    if kind == 'ow_odd':
        frames = rng.integers(0, 256, (2, 45, 61, 3), dtype=np.uint8)
        boxes = np.stack([edge_boxes(rng, 9, 45, 61) for _ in range(2)])
        return frames, boxes, (7, 13)
    if kind == 'wide':
        frame = rng.integers(0, 256, (200, 1500, 3), dtype=np.uint8)
        return frame, np.array([[0.0, 0.0, 1499.0, 199.0],
                                [-30.0, 10.0, 1530.0, 150.0],
                                [100.0, 20.0, 1400.0, 190.5],
                                [7.0, 3.0, 900.0, 60.0]], F32), (20, 64)
    if kind == 'tiny':
        frame = rng.integers(0, 256, (72, 128, 3), dtype=np.uint8)
        return frame, np.array([[5.0, 5.0, 5.0, 5.0],
                                [3.7, 4.2, 3.9, 4.9],
                                [127.0, 71.0, 127.0, 71.0],
                                [-50.0, -50.0, -10.0, -10.0],
                                [140.0, 80.0, 200.0, 120.0],
                                [-1e4, -1e4, 1e4, 1e4],
                                [0.0, 71.0, 127.0, 71.0],
                                [127.0, 0.0, 127.0, 71.0]], F32), (256, 128)
    if kind == 'nan':
        frame = rng.integers(0, 256, (30, 40, 3), dtype=np.uint8)
        boxes = edge_boxes(rng, 8, 30, 40)
        boxes[NAN_BOXES[0], 0] = np.nan
        boxes[NAN_BOXES[1], 1:3] = np.nan
        boxes[NAN_BOXES[2]] = np.nan
        return frame, boxes, (12, 8)
    if kind == 'float_streams':
        frames = rng.uniform(0, 255, (2, 50, 70, 3)).astype(F32)
        boxes = np.stack([edge_boxes(rng, 6, 50, 70) for _ in range(2)])
        return frames, boxes, (256, 128)
    raise ValueError(kind)


def edge_sha256(t):
    """``output_sha256`` with every NaN as torch's canonical NaN: the card
    makes a NaN of its own bits where the host's arithmetic carries the
    NaN it was given."""
    t = t.contiguous().cpu()
    return output_sha256(torch.where(torch.isnan(t), torch.full_like(
        t, float('nan')), t))


def output_sha256(t):
    return hashlib.sha256(t.contiguous().cpu().numpy().tobytes()).hexdigest()


# every seeded case's output (seed 1) as the first design of the kernel
# gave it (the plain version's too)
OUTPUT_SHA256 = {
    'edges':
        'ede38f1f896c66408f9aab978ec86695b12aa9f4e7aeafe385628b9eb782fe2d',
    'streams':
        'f1c1756ddda7e3518dfba69ae484f3f2fb364ac5704e0454c4c807ec9ec28949',
    'float':
        '076db7c8767fc089eb3c4b0a34e82877a528e5d924c0e25514b61569fb5940b1',
    'osnet':
        '0140379b0713699edf8f5234c2234bfbee6e60d8f4c980dc60a068d58b27ec3d',
}


# every edge case's output (``edge_sha256``) as a host build of the first
# design's source gave it
EDGE_SHA256 = {
    'ow1':
        'cbda8771474344ed847814d37271ac5205e53b671d844e8aa1ccf6236cd2d259',
    'ow_odd':
        'aeebcaa7baf63b5c11f53e958c4870e5de8cd4c782cc51153bd19b96adb8520a',
    'wide':
        '318ae7003ea99fe82b11beac63e06432dbf4bb59fa56ba8ceedf0a994b22a427',
    'tiny':
        '5666f3751097daeebe6692520e799e0ae909438715c7036ce9ccd5608f988f73',
    'nan':
        '15399b21fc92103de637229ca1f5137938a066176b993726fdc6e8cd5868f452',
    'float_streams':
        '8bc797c01cc051084f14939249b79e1b4598ba3284b3099bb345b73781a4dd6b',
}


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six workers on the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


# the kernel's band constants, appended to the host build
BAND_PROBE = '''
extern "C" int band_probe(int which) {
  return which == 0 ? kMaxBandRows : kPassBytes;
}
'''


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    return rc.declare(build_host('reid_crops', tmp_path_factory,
                                 extra=BAND_PROBE))


def host_crops(lib, frame, tlbrs, out_hw, threads=32,
               out_dtype=torch.float32, band=None):
    """``reid_crops`` through the host build (or, ``threads`` None, the
    card's library on CUDA tensors), in bands of ``band`` output rows
    (``band_rows``' pick by default)."""
    if threads is not None:
        lib.set_host_threads(threads)
    out, args, _ = rc.reid_crops_launch_args(frame, tlbrs, out_hw,
                                             out_dtype, band)
    assert lib.reid_crops_forward(*args) == 0
    return out


def jax_input(frame, tlbrs, out_hw):
    """The JAX package's network input and crops: ``_extract_core`` up to
    the network, whose ``apply`` keeps its input, stream by stream (the
    batched program vmaps the same function over the streams)."""
    import jax.numpy as jnp
    from fastmot_tpu import feature_extractor as jfe

    class Capture:
        def apply(self, params, x):
            self.x = x
            return jnp.ones((x.shape[0], 1), jnp.float32)

    frames = frame if frame.ndim == 4 else frame[None]
    boxes = tlbrs if frame.ndim == 4 else tlbrs[None]
    inputs, crops = [], []
    for f, b in zip(frames, boxes):
        net = Capture()
        jfe._extract_core(net, out_hw, None, jnp.asarray(f), jnp.asarray(b),
                          jnp.ones(len(b), bool))
        inputs.append(np.asarray(net.x))
        crops.append(np.asarray(jfe.crop_resize_batch(
            jnp.asarray(f, jnp.float32), jnp.asarray(b), out_hw)))
    return np.concatenate(inputs), np.concatenate(crops)


@pytest.mark.parametrize('kind', KINDS)
def test_plain_version_matches_jax(kind):
    frame, tlbrs, out_hw = crop_case(kind, seed=3)
    want, want_crops = jax_input(frame, tlbrs, out_hw)
    crops = rc.crop_resize_batch(T(frame), T(tlbrs), out_hw)
    np.testing.assert_array_equal(crops.numpy(), want_crops)
    got = rc.reid_crops_reference(T(frame), T(tlbrs), out_hw)
    assert got.shape == want.shape
    np.testing.assert_allclose(got.numpy(), want, rtol=0, atol=JAX_ATOL)


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in KINDS]
                         + [('edges', 96), ('streams', 64)])
def test_host_build_equals_plain_version(host_kernel, kind, threads):
    frame, tlbrs, out_hw = (T(a) if isinstance(a, np.ndarray) else a
                            for a in crop_case(kind, seed=1))
    got = host_crops(host_kernel, frame, tlbrs, out_hw, threads)
    assert torch.equal(got, rc.reid_crops_reference(frame, tlbrs, out_hw))


@pytest.mark.parametrize('kind', KINDS)
def test_host_outputs_equal_the_first_design(host_kernel, kind):
    frame, tlbrs, out_hw = crop_case(kind, seed=1)
    got = host_crops(host_kernel, T(frame), T(tlbrs), out_hw)
    assert output_sha256(got) == OUTPUT_SHA256[kind]


def edge_plain(frame, tlbrs, out_hw, kind, dtype=torch.float32):
    """The plain version on an edge case; the 'nan' case's NaN boxes,
    which it cannot index by, give all-NaN crops (the kernel's)."""
    if kind != 'nan':
        return rc.reid_crops_reference(frame, tlbrs, out_hw, dtype)
    ok = torch.ones(len(tlbrs), dtype=torch.bool)
    ok[list(NAN_BOXES)] = False
    out = torch.full((len(tlbrs), *out_hw, 3), float('nan'), dtype=dtype)
    out[ok] = rc.reid_crops_reference(frame, tlbrs[ok], out_hw, dtype)
    return out


@pytest.mark.parametrize('kind,threads', [(k, 32) for k in EDGE_KINDS]
                         + [('ow_odd', 96), ('wide', 64)])
def test_host_edge_cases(host_kernel, kind, threads):
    """Each edge case: the plain version bit for bit (NaN where it is
    NaN), and the outputs a host build of the first design's source
    gave."""
    frame, tlbrs, out_hw = (T(a) if isinstance(a, np.ndarray) else a
                            for a in edge_crop_case(kind))
    got = host_crops(host_kernel, frame, tlbrs, out_hw, threads)
    want = edge_plain(frame, tlbrs, out_hw, kind)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    assert edge_sha256(got) == EDGE_SHA256[kind]


@pytest.mark.parametrize('kind', KINDS + EDGE_KINDS)
def test_host_bf16_output(host_kernel, kind):
    """bf16 output: the float32 output rounded to bf16, as the plain
    version's ``.to(torch.bfloat16)`` gives it, bit for bit (NaN where it
    is NaN)."""
    frame, tlbrs, out_hw = (T(a) if isinstance(a, np.ndarray) else a
                            for a in (crop_case(kind, seed=1) if kind in KINDS
                                      else edge_crop_case(kind)))
    got = host_crops(host_kernel, frame, tlbrs, out_hw, 64, torch.bfloat16)
    assert got.dtype == torch.bfloat16
    want = edge_plain(frame, tlbrs, out_hw, kind, torch.bfloat16)
    assert torch.equal(torch.isnan(got), torch.isnan(want))
    assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
    f32 = host_crops(host_kernel, frame, tlbrs, out_hw, 64)
    assert torch.equal(torch.nan_to_num(got),
                       torch.nan_to_num(f32.to(torch.bfloat16)))


def test_osnet_embeddings_equal_from_bf16_crops(monkeypatch):
    """OSNet-x0.25's embeddings of bf16 crops equal those of the float32
    crops bit for bit (its stem rounds its input to bf16 first), so
    ``extract_core`` asks the float OSNet for bf16 crops; under int8
    (``QuantizedModule``, whose dynamic ranges read the crops) it asks for
    float32."""
    from fastmot_tpu_torch import feature_extractor as fe
    from fastmot_tpu_torch.models import registry
    from fastmot_tpu_torch.models.quantize import quantize_module
    frame, tlbrs, out_hw = crop_case('osnet', seed=2)
    frame, tlbrs = T(frame), T(tlbrs)
    net = registry.ReIDModel.get_model('OSNet025').init_params('cpu')
    x32 = rc.reid_crops(frame, tlbrs, out_hw)
    x16 = rc.reid_crops(frame, tlbrs, out_hw, torch.bfloat16)
    assert torch.equal(x16, x32.to(torch.bfloat16))
    with torch.no_grad():
        assert torch.equal(net(x16), net(x32))
    asked, real = [], rc.reid_crops
    monkeypatch.setattr(rc, 'reid_crops', lambda *a: (
        asked.append(a[3]), real(*a))[1])
    valid = torch.ones(len(tlbrs), dtype=torch.bool)
    with torch.no_grad():
        emb = fe.extract_core(net, out_hw, frame, tlbrs, valid)
        fe.extract_core(quantize_module(registry.ReIDModel.get_model(
            'OSNet025').init_params('cpu'), 'int8'), out_hw, frame, tlbrs,
            valid)
    assert asked == [torch.bfloat16, torch.float32]
    with torch.no_grad():
        want = net(x32)
    want = want / torch.linalg.norm(want, dim=1, keepdim=True)
    assert torch.equal(emb, want)


def test_band_constants_match_the_kernel(host_kernel):
    """``ops.reid_crops``' mirrors of the kernel's bands, which
    chip_smoke.py prints; the band's rows by the call's size; the edge
    cases run both of a band's forms (the 'wide' case's bands span too
    many source rows to keep their column pass, the others keep it)."""
    assert (host_kernel.band_probe(0), host_kernel.band_probe(1)) \
        == (16, rc.PASS_BYTES)
    assert rc.band_rows(64, 256) == 8 and rc.band_rows(1024, 256) == 16
    assert rc.span_cap(128, 8) == 16 and rc.span_cap(128, 16) == 32
    assert rc.span_cap(4096, 8) == 1
    frame, tlbrs, (oh, ow) = edge_crop_case('wide')
    h = np.floor(tlbrs[:, 3]) - np.maximum(np.floor(tlbrs[:, 1]), 0) + 1
    assert (h * 8 / oh > rc.span_cap(ow, 8)).all()


@pytest.mark.parametrize('kind', KINDS + EDGE_KINDS)
def test_host_bands_of_16(host_kernel, kind):
    """Bands of 16 output rows, which the kernel takes for large calls,
    give the bands of 8's output bit for bit, in float32 and bf16."""
    frame, tlbrs, out_hw = (T(a) if isinstance(a, np.ndarray) else a
                            for a in (crop_case(kind, seed=1) if kind in KINDS
                                      else edge_crop_case(kind)))
    for dtype in (torch.float32, torch.bfloat16):
        a, b = (host_crops(host_kernel, frame, tlbrs, out_hw, 64, dtype,
                           band) for band in (8, 16))
        assert torch.equal(torch.isnan(a), torch.isnan(b))
        assert torch.equal(torch.nan_to_num(a), torch.nan_to_num(b))


def test_wrapper_on_cpu_is_the_plain_version(monkeypatch):
    frame, tlbrs, out_hw = crop_case('streams', seed=1)
    before = rc.reid_crops.launches
    monkeypatch.setattr(rc, 'reid_crops_library', lambda: pytest.fail(
        'the kernel library was loaded for CPU tensors'))
    assert torch.equal(rc.reid_crops(T(frame), T(tlbrs), out_hw),
                       rc.reid_crops_reference(T(frame), T(tlbrs), out_hw))
    assert rc.reid_crops.launches == before


def test_wrapper_raises_on_other_devices():
    with pytest.raises(ValueError, match='unsupported device'):
        rc.reid_crops(torch.zeros((8, 8, 3), device='meta'),
                      torch.zeros((2, 4), device='meta'), (4, 2))


@pytest.mark.parametrize('fault', ['channels', 'dtype', 'boxes', 'streams',
                                   'box_dtype', 'empty'])
def test_launch_args_raise_on_each_fault(fault):
    frame = torch.zeros((2, 8, 8, 4 if fault == 'channels' else 3),
                        dtype=torch.int32 if fault == 'dtype'
                        else torch.uint8)
    boxes = torch.zeros((3 if fault == 'streams' else 2,
                         0 if fault == 'empty' else 5,
                         5 if fault == 'boxes' else 4),
                        dtype=torch.float64 if fault == 'box_dtype'
                        else torch.float32)
    with pytest.raises(ValueError, match='reid_crops'):
        rc.reid_crops_launch_args(frame, boxes, (4, 2))


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('kind', KINDS)
def test_kernel_matches_plain_version(cuda, kind):
    frame, tlbrs, out_hw = (T(a) if isinstance(a, np.ndarray) else a
                            for a in crop_case(kind, seed=1))
    before = rc.reid_crops.launches
    got = rc.reid_crops(frame.to(cuda), tlbrs.to(cuda), out_hw)
    torch.cuda.synchronize()
    assert rc.reid_crops.launches == before + 1
    want = rc.reid_crops_reference(frame, tlbrs, out_hw)
    assert torch.equal(got.cpu(), want)
    assert torch.equal(got, rc.reid_crops_reference(
        frame.to(cuda), tlbrs.to(cuda), out_hw))
    assert output_sha256(got) == OUTPUT_SHA256[kind]


@pytest.mark.cuda
@pytest.mark.parametrize('kind', EDGE_KINDS)
def test_kernel_edge_cases(cuda, kind):
    """The edge cases on the card: the plain version (NaN where it is NaN)
    in float32 and bf16, and the first design's sha256."""
    frame, tlbrs, out_hw = (T(a) if isinstance(a, np.ndarray) else a
                            for a in edge_crop_case(kind))
    for dtype in (torch.float32, torch.bfloat16):
        got = rc.reid_crops(frame.to(cuda), tlbrs.to(cuda), out_hw,
                            dtype).cpu()
        want = edge_plain(frame, tlbrs, out_hw, kind, dtype)
        assert torch.equal(torch.isnan(got), torch.isnan(want))
        assert torch.equal(torch.nan_to_num(got), torch.nan_to_num(want))
        if dtype == torch.float32:
            assert edge_sha256(got) == EDGE_SHA256[kind]


@pytest.mark.cuda
def test_kernel_makes_no_host_sync(cuda):
    frame, tlbrs, out_hw = crop_case('streams', seed=1)
    frame, tlbrs = T(frame).to(cuda), T(tlbrs).to(cuda)
    rc.reid_crops(frame, tlbrs, out_hw)
    torch.cuda.synchronize()
    torch.cuda.set_sync_debug_mode('error')
    try:
        rc.reid_crops(frame, tlbrs, out_hw)
    finally:
        torch.cuda.set_sync_debug_mode(0)
