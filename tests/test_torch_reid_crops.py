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
  threads; the kernel strides its loop by the block's thread count, so
  teams of 32 and 96 threads compute what 128 do): bit for bit the plain
  version on seeded cases (boxes past every frame edge, 1-pixel boxes,
  boxes larger than the frame, three streams, float frames whose values
  round to bf16, two crops at OSNet's 256 x 128), and every output's
  sha256 as the first design gave it (``OUTPUT_SHA256``).

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


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six workers on the
    cores."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    return rc.declare(build_host('reid_crops', tmp_path_factory))


def host_crops(lib, frame, tlbrs, out_hw, threads=32):
    """``reid_crops`` through the host build (or, ``threads`` None, the
    card's library on CUDA tensors)."""
    if threads is not None:
        lib.set_host_threads(threads)
    out, args, _ = rc.reid_crops_launch_args(frame, tlbrs, out_hw)
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
