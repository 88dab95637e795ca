"""The preprocess kernel of the port (``csrc/flow_preprocess.cu``, wrapper
``ops.flow_kernels.preprocess``): gray, the image pyramid and its uint8
rounding, the Shi-Tomasi grid candidates and the background candidates of
a gap frame, for every stream of a call.

On the CPU the kernel's own source is built for the host with g++ through
tests/cuda_host_shim.py (a launch runs its blocks in turn on a team of host
threads, ``__syncthreads`` a barrier of the team, the shuffles meetings of
a warp's 32, ``__shared__`` and the dynamic shared memory static storage;
``-ffp-contract=off`` as the card's build runs under ``-fmad=false``). The
kernel strides every loop by its block's thread count and takes whole
warps, so the tests run it with 32 and with 64 threads a block. That build
equals the plain version (``preprocess_reference``) bit for bit, every
level, uint8 level, candidate and score, on textured frames, on frames
whose cells hold tied responses (a period-4 pattern and flat patches), at
320x240 and 250x170 (odd levels and cells truncate; 250 px rows are 750
bytes, so no 16-byte load group is aligned past the first row), at one and
two streams, at the 64-px tiles' ragged right and bottom edges, and off the
main path's integer resize ratios (flow scale 0.37, bg scale 0.13, where
the bilinear weights are not 0.5, and 321x241, whose flow size is not half
the frame: the pyramid takes its own tiles), and gives every output that
the first design (three roles side by side) gave on each synthetic call
(``OUTPUT_SHA256``). The plain resize (``resize_bilinear``) rounds each
product and sum on its own, as the kernel does, and agrees with
F.interpolate within 1e-4 (bit for bit at the main path's ratios). On the
card, ``chip_smoke.py`` holds the kernel to the plain version run on the
CPU bit for bit, and to ``OUTPUT_SHA256``. The plain version and the host
build match the JAX package's ``_preprocess_jit`` at
tests/test_torch_flow.py's tolerances.

On the card (marker ``cuda``; they skip without one, and JAX is imported
only by the CPU tests that need it):

    python -m pytest tests/test_torch_flow_preprocess.py -m cuda
"""
import ctypes
import hashlib

import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from fastmot_tpu_torch.ops import flow_kernels as tfk

from .cuda_host_shim import build_host

SIZES = ((320, 240), (250, 170))            # (W, H)
KINDS = ('texture', 'ties')
# resize_bilinear against F.interpolate: two float32 ulps at 255
LEVEL_ATOL = 1e-4


def spec_of(size, opt_scale=(0.5, 0.5), bg_scale=(0.1, 0.1)):
    return tfk.FlowSpec(size=size, opt_scale=opt_scale, bg_scale=bg_scale)


def make_frame(kind, size, seed=0):
    """[H, W, 3] uint8 BGR: 'texture' smoothed noise with independent
    channels; 'ties' a random 4x4 patch repeated (every cell holds each
    response four times) with flat patches and one textured band."""
    w, h = size
    rng = np.random.default_rng(seed)
    if kind == 'texture':
        noise = rng.uniform(0, 255, (h, w, 3)).astype(np.float32)
        img = ndi.gaussian_filter(noise, (2, 2, 0))
        img = (img - img.min()) / (np.ptp(img) + 1e-6) * 255.0
        return np.round(img).astype(np.uint8)
    patch = rng.integers(0, 256, (4, 4, 3))
    img = np.tile(patch, (h // 4 + 1, w // 4 + 1, 1))[:h, :w]
    img[h // 4:h // 2, w // 5:w // 2] = 77             # flat: zero responses
    img[h // 2:h // 2 + 3] = 200
    band = rng.uniform(0, 255, (16, w, 3))
    img[-20:-4] = ndi.gaussian_filter(band, (1, 1, 0))
    return img.astype(np.uint8)


def frames_of(kind, size, n_streams=1, seed=0):
    """[H, W, 3] for one stream, [S, H, W, 3] for several (each its own
    seed)."""
    if n_streams == 1:
        return torch.from_numpy(make_frame(kind, size, seed))
    return torch.from_numpy(np.stack([make_frame(kind, size, seed + s)
                                      for s in range(n_streams)]))


def flat_state(state):
    """The state's 16 tensors in order."""
    return list(state[0]) + list(state[1]) + list(state[2:])


def state_names(spec):
    n = spec.max_level + 1
    return ([f'pyr[{i}]' for i in range(n)] + [f'pyr_u8[{i}]' for i in
                                               range(n)]
            + ['cand_pts', 'cand_score', 'bg_pts', 'bg_score'])


def assert_state_equal(got, want, spec, tag=''):
    for name, g, w in zip(state_names(spec), flat_state(got),
                          flat_state(want)):
        g = g.cpu()
        assert g.shape == w.shape and g.dtype == w.dtype, (tag, name)
        diff = (g.view(torch.int32) != w.view(torch.int32))
        assert not diff.any(), (f'{tag} {name}: {int(diff.sum())} of '
                                f'{diff.numel()} differ')


def cell_margin(resp, cell):
    """Each cell's best response less its second best, row-major cells of
    ``resp`` [..., h, w] (numpy)."""
    h, w = resp.shape[-2:]
    gh, gw = h // cell, w // cell
    r = resp[..., :gh * cell, :gw * cell].reshape(
        resp.shape[:-2] + (gh, cell, gw, cell)).swapaxes(-3, -2)
    r = np.sort(r.reshape(resp.shape[:-2] + (gh * gw, cell * cell)), -1)
    return r[..., -1] - r[..., -2]


def assert_matches_jax(state, jstate, spec, tag=''):
    """tests/test_torch_flow.py::test_preprocess_matches_jax's tolerances,
    one stream."""
    jpyr, jtabs, jcp, jcs, jbp, jbs = jstate
    pyr, pyr_u8, cp, cs, bp, bs = state
    off = 0
    wide = spec.win + 3
    center = (spec.win - 1) // 2 + 1
    for jl, tl, tu in zip(jpyr, pyr, pyr_u8):
        jl = np.asarray(jl)
        np.testing.assert_allclose(tl.numpy(), jl, atol=2e-3, err_msg=tag)
        h, w = jl.shape
        tab = np.asarray(jtabs[off:off + h * w]).reshape(h, w, wide, wide)
        off += h * w
        ju8 = tab[:, :, center, center].astype(np.float32)
        clear = np.abs(jl - np.floor(jl) - 0.5) > 1e-3
        np.testing.assert_array_equal(tu.numpy()[clear], ju8[clear])
        assert (tu.numpy() != ju8).mean() < 1e-3, tag
    np.testing.assert_array_equal(cp.numpy(), np.asarray(jcp))
    np.testing.assert_allclose(cs.numpy(), np.asarray(jcs), rtol=1e-4,
                               atol=1e-3)
    np.testing.assert_array_equal(bp.numpy(), np.asarray(jbp))
    np.testing.assert_allclose(bs.numpy(), np.asarray(jbs), rtol=1e-4,
                               atol=1e-2)


# ---------------------------------------------------------------------------
# The host build
# ---------------------------------------------------------------------------

@pytest.fixture(scope='module')
def host_kernel(tmp_path_factory):
    lib = build_host('flow_preprocess', tmp_path_factory)
    lib.flow_preprocess_forward.argtypes = [
        ctypes.c_void_p, ctypes.c_void_p, ctypes.POINTER(ctypes.c_int),
        ctypes.POINTER(ctypes.c_float), ctypes.c_void_p]
    lib.flow_preprocess_forward.restype = ctypes.c_int
    return lib


def host_run(lib, spec, frames, threads=32):
    """One call of the host-built kernel on CPU frames, ``threads`` host
    threads a block (0: the launch's own): the state, as ``preprocess``
    returns it."""
    lib.set_host_threads(threads)
    state, args = tfk.preprocess_launch_args(spec, frames)
    assert lib.flow_preprocess_forward(*args) == 0
    return state


@pytest.mark.parametrize('threads', [32, 64])
@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_host_kernel_equals_plain_version(host_kernel, size, kind, threads):
    spec = spec_of(size)
    frames = frames_of(kind, size)
    got = host_run(host_kernel, spec, frames, threads)
    want = tfk.preprocess_reference(spec, frames)
    assert_state_equal(got, want, spec, f'{kind} {size}')
    if kind == 'ties':                # the cells did hold tied maxima
        resp = tfk.shi_tomasi_response(
            frames.float() @ torch.tensor([0.114, 0.587, 0.299]))
        assert (cell_margin(resp.numpy(), tfk.CELL) == 0).mean() > 0.3


@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_host_kernel_two_streams(host_kernel, size):
    """Two streams in one call: the plain version's stacked state, and each
    stream what it gets alone."""
    spec = spec_of(size)
    frames = torch.cat([frames_of('texture', size, 1, 3)[None],
                        frames_of('ties', size, 1, 4)[None]])
    got = host_run(host_kernel, spec, frames)
    assert_state_equal(got, tfk.preprocess_reference(spec, frames), spec)
    for s in range(2):
        alone = host_run(host_kernel, spec, frames[s], 64)
        for g, a in zip(flat_state(got), flat_state(alone)):
            assert torch.equal(g[s], a)


@pytest.mark.parametrize('kind', KINDS)
def test_host_kernel_off_the_integer_ratios(host_kernel, kind):
    """Flow scale 0.37 and bg scale 0.13 (bilinear weights other than 0.5,
    a bg image of 42 x 31): bit for bit."""
    size = (320, 240)
    spec = spec_of(size, (0.37, 0.37), (0.13, 0.13))
    frames = frames_of(kind, size, 2, 7)
    got = host_run(host_kernel, spec, frames)
    assert_state_equal(got, tfk.preprocess_reference(spec, frames), spec,
                       kind)


# Each synthetic call's outputs as the first design of the kernel (three
# roles side by side) gave them: (kind, (W, H), flow scale, bg scale,
# streams, seed) -> the sha256 of the state's 16 tensors' bytes in order
OUTPUT_SHA256 = {
    ('texture', (320, 240), 0.5, 0.1, 1, 0):
        'a9d483f151a13fa47d6000755773913bf1bc372285b919ee8d200ab381031ade',
    ('ties', (250, 170), 0.5, 0.1, 2, 1):
        '329b36797d394d14c2d67caf5aa68e6cf6436c71d7af94c139a9ae4c7df18067',
    ('texture', (320, 240), 0.37, 0.13, 2, 7):
        'dc0f4905b07a3f83637f101cb9db0d2695c35594f9653a7c8694874ffc3137e1',
    ('ties', (250, 170), 0.37, 0.13, 1, 3):
        '2c157403e29ea72856d87d0b48f5ade52c65c50a8af2508152b5f3af5e388fc1',
    ('texture', (336, 200), 0.5, 0.1, 1, 4):
        '215c727e5e5bb759b831196d87cbe01a67bca56e624e4445c31bc62520fa04d0',
    ('ties', (326, 202), 0.5, 0.1, 2, 5):
        '51f1e3deee253fc81b3d2067c70886b5b267312bec528adf7de1a8d282a43e4b',
    ('texture', (321, 241), 0.5, 0.1, 1, 6):
        'cafbd4e70e6c56149ac4722408b4ed60a36f9544540581ca0f278db6e12640e0',
}


def hash_case(case):
    """(spec, frames) of an OUTPUT_SHA256 call."""
    kind, size, opt, bg, n_streams, seed = case
    return (spec_of(size, (opt, opt), (bg, bg)),
            frames_of(kind, size, n_streams, seed))


def output_sha256(state):
    h = hashlib.sha256()
    for t in flat_state(state):
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()


def hash_case_id(case):
    kind, size, opt, bg, n_streams, _ = case
    return f'{kind}-{size[0]}x{size[1]}-{opt}-{bg}-{n_streams}'


@pytest.mark.parametrize('case', OUTPUT_SHA256, ids=hash_case_id)
def test_host_kernel_outputs_equal_the_first_design(host_kernel, case):
    """Every output of the host build, to the bit, is what the first design
    gave on the same call (``OUTPUT_SHA256``)."""
    spec, frames = hash_case(case)
    assert output_sha256(host_run(host_kernel, spec, frames)) \
        == OUTPUT_SHA256[case]


# (W, H) of frames at the tiles' edges: 336x200 ragged right and bottom
# (5.25 x 3.125 tiles of 64 px) with rows of 1,008 B, a multiple of 16;
# 326x202 ragged, rows of 978 B (no 16-byte group aligned but the first
# row's); 321x241, whose flow size 160x120 is not half of it, so the
# pyramid takes its own tiles
EDGE_SIZES = ((336, 200), (326, 202), (321, 241))


@pytest.mark.parametrize('kind', KINDS)
@pytest.mark.parametrize('size', EDGE_SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_host_kernel_at_the_tiles_edges(host_kernel, size, kind):
    """Frames at the edge cases of the staging and of the pyramid's nesting
    (EDGE_SIZES), at two streams: bit for bit."""
    spec = spec_of(size)
    ow, oh = spec.opt_size
    assert ((size[0] % 64, size[1] % 64) != (0, 0)
            and ((size[0] * 3) % 16 != 0) == (size != (336, 200))
            and (size == (ow * 2, oh * 2)) == (size != (321, 241)))
    frames = frames_of(kind, size, 2, 8)
    assert_state_equal(host_run(host_kernel, spec, frames, 64),
                       tfk.preprocess_reference(spec, frames), spec,
                       f'{kind} {size}')


@pytest.mark.parametrize('kind,size,n_streams', [
    ('texture', (320, 240), 1), ('ties', (326, 202), 2)])
def test_host_kernel_with_its_own_block(host_kernel, kind, size, n_streams):
    """The kernel's own 256 threads a block (the frame role's column pass
    on five warps beside the pyramid's levels 0-2 on the other three,
    which teams of 32 and 64 threads run one after the other): bit for
    bit."""
    spec = spec_of(size)
    frames = frames_of(kind, size, n_streams, 9)
    assert_state_equal(host_run(host_kernel, spec, frames, 0),
                       tfk.preprocess_reference(spec, frames), spec, kind)


@pytest.mark.parametrize('out_hw', [(360, 640), (72, 128), (266, 474),
                                    (94, 166), (17, 25), (720, 1280)])
def test_resize_matches_f_interpolate(out_hw):
    """``resize_bilinear`` against F.interpolate(bilinear, align_corners=
    False, antialias=False) from 1280x720: the same taps and weights, the
    sums rounded in another order, so within 1e-4 at 0..255 (two float32
    ulps at 255 are 3.1e-5), and bit for bit where the weights are 0.5
    (the flow scale 1/2 and the bg scale 1/10) or the size is kept."""
    rng = np.random.default_rng(3)
    img = torch.from_numpy(rng.uniform(0, 255, (720, 1280)).astype(
        np.float32))
    got = tfk.resize_bilinear(img, out_hw)
    want = torch.nn.functional.interpolate(
        img[None, None], size=out_hw, mode='bilinear', align_corners=False,
        antialias=False)[0, 0]
    assert (got - want).abs().max() <= LEVEL_ATOL
    if out_hw in ((360, 640), (72, 128), (720, 1280)):
        assert torch.equal(got.view(torch.int32), want.view(torch.int32))


@pytest.mark.parametrize('size', SIZES, ids=lambda s: f'{s[0]}x{s[1]}')
def test_plain_and_host_match_jax(host_kernel, size):
    """The plain version and the host build against the JAX package's
    ``_preprocess_jit`` at tests/test_torch_flow.py's tolerances."""
    from fastmot_tpu.ops import flow_kernels as jfk
    spec = spec_of(size)
    jspec = jfk.FlowSpec(size=size, opt_scale=(0.5, 0.5),
                         bg_scale=(0.1, 0.1))
    frame = make_frame('texture', size, 5)
    jstate = jfk.preprocess(jspec, frame)
    plain = tfk.preprocess_reference(spec, torch.from_numpy(frame))
    host = host_run(host_kernel, spec, torch.from_numpy(frame))
    assert_matches_jax(plain, jstate, spec, 'plain')
    assert_matches_jax(host, jstate, spec, 'host')


def test_shi_tomasi_root_is_correctly_rounded():
    """The plain response equals, bit for bit, numpy's float32 sums in its
    order with numpy's float32 root, which is rounded correctly (as XLA's
    and the kernel's are; ATen's vectorised CPU root can be an ulp low)."""
    f32 = np.float32
    img = make_frame('texture', (96, 64), 3)[..., 1].astype(f32)
    ix = np.zeros_like(img)
    iy = np.zeros_like(img)
    ix[:, 1:-1] = (img[:, 2:] - img[:, :-2]) * f32(0.5)
    iy[1:-1] = (img[2:] - img[:-2]) * f32(0.5)

    def box3(x):
        xp = np.pad(x, 1)
        r = (xp[:-2] + xp[1:-1]) + xp[2:]
        return (r[:, :-2] + r[:, 1:-1]) + r[:, 2:]
    sxx, syy, sxy = box3(ix * ix), box3(iy * iy), box3(ix * iy)
    d = sxx - syy
    root = np.sqrt(np.maximum(d * d + f32(4) * (sxy * sxy), f32(0)))
    want = f32(0.5) * ((sxx + syy) - root)
    got = tfk.shi_tomasi_response(torch.from_numpy(img)).numpy()
    np.testing.assert_array_equal(got.view(np.int32), want.view(np.int32))


# ---------------------------------------------------------------------------
# The wrapper
# ---------------------------------------------------------------------------

def test_wrapper_on_cpu_is_the_plain_version():
    spec = spec_of((250, 170))
    for frames in (frames_of('texture', (250, 170)),
                   frames_of('ties', (250, 170), 2)):
        assert_state_equal(tfk.preprocess(spec, frames),
                           tfk.preprocess_reference(spec, frames), spec)


def test_wrapper_raises_on_other_devices():
    with pytest.raises(ValueError, match='unsupported device'):
        tfk.preprocess(spec_of((64, 48)),
                       torch.zeros((48, 64, 3), dtype=torch.uint8,
                                   device='meta'))


@pytest.mark.parametrize('fault', ['dtype', 'channels', 'dims',
                                   'contiguous', 'levels', 'tiny'])
def test_launch_args_raise_on_each_fault(fault):
    spec = spec_of((128, 96))
    frame = torch.zeros((96, 128, 3), dtype=torch.uint8)
    tfk.preprocess_launch_args(spec, frame)    # the unbroken call passes
    if fault == 'dtype':
        frame = frame.float()
    elif fault == 'channels':
        frame = frame[..., :2]
    elif fault == 'dims':
        frame = frame[None, None]
    elif fault == 'contiguous':
        frame = torch.zeros((96, 256, 3), dtype=torch.uint8)[:, ::2]
    elif fault == 'levels':
        spec = tfk.FlowSpec(size=(128, 96), opt_scale=(1.0, 1.0),
                            bg_scale=(0.1, 0.1), max_level=6)
    elif fault == 'tiny':                  # level 5 would keep no row
        spec = spec_of((128, 96), (0.25, 0.25))
    with pytest.raises(ValueError, match='preprocess: '):
        tfk.preprocess_launch_args(spec, frame)


def test_layout_outputs_are_disjoint_and_aligned():
    """The state's views tile the buffer without overlap, each 256 B
    aligned, in the kernel's offsets."""
    spec = spec_of((1280, 720))
    for frames in (torch.zeros((720, 1280, 3), dtype=torch.uint8),
                   torch.zeros((8, 720, 1280, 3), dtype=torch.uint8)):
        state, args = tfk.preprocess_launch_args(spec, frames)
        views = flat_state(state)
        spans = sorted((v.storage_offset(), v.storage_offset() + v.numel())
                       for v in views)
        assert all(a[1] <= b[0] for a, b in zip(spans, spans[1:]))
        assert all(v.storage_offset() % 64 == 0 for v in views)
        assert spans[-1][1] <= views[0].untyped_storage().nbytes() // 4
        assert list(args[2])[8:] == [v.storage_offset() for v in views]
    assert [tuple(v.shape) for v in state[0]] == [
        (8, 360, 640), (8, 180, 320), (8, 90, 160), (8, 45, 80),
        (8, 22, 40), (8, 11, 20)]
    assert tuple(state[2].shape) == (8, 14400, 2)
    assert tuple(state[4].shape) == (8, 576, 2)


def test_main_path_frames_pass_the_kernel_checks(monkeypatch):
    """``MultiTracker`` and ``StreamTracker`` on the CPU hand the wrapper
    frames its kernel takes (every call checked): one call a frame, for all
    of a call's streams."""
    from fastmot_tpu_torch import tracker as ttr
    from fastmot_tpu_torch.detector import make_detections
    from fastmot_tpu_torch.parallel import StreamTracker
    calls = []
    real = tfk.preprocess

    def checked(spec, frames):
        tfk.preprocess_launch_args(spec, frames)
        calls.append(frames.shape[0] if frames.dim() == 4 else 1)
        return real(spec, frames)
    monkeypatch.setattr(tfk, 'preprocess', checked)
    size = (320, 240)
    frames = [frames_of('texture', size, 1, s).numpy() for s in range(3)]
    boxes = np.array([[30, 40, 80, 150], [150, 50, 205, 170]], float)
    dets = make_detections(boxes, np.ones(2, int), np.full(2, 0.9))
    trk = ttr.MultiTracker(size, 'euclidean', device='cpu')
    trk.reset(1 / 30.0)
    trk.init(torch.from_numpy(frames[0]), dets)
    for i in (1, 2):
        trk.track(torch.from_numpy(frames[i]), i)
    st = StreamTracker(size, 'euclidean', 2, device='cpu')
    st.reset(1 / 30.0)
    st.init(np.stack([frames[0], frames[1]]), [dets, dets])
    for i in (1, 2):
        st.track(np.stack([frames[i], frames[0]]), i)
    assert calls == [1, 1, 1, 2, 2, 2]


# ---------------------------------------------------------------------------
# On the card
# ---------------------------------------------------------------------------

@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device')
    return torch.device('cuda')


@pytest.mark.cuda
@pytest.mark.parametrize('n_streams', [1, 8])
def test_kernel_matches_plain_version(cuda, n_streams):
    """The kernel on the card against the plain version run on the CPU, bit
    for bit, at 1280x720 and at 250x170 off the integer ratios, one launch
    a call."""
    for size, scales in (((1280, 720), ((0.5, 0.5), (0.1, 0.1))),
                         ((250, 170), ((0.37, 0.37), (0.13, 0.13)))):
        spec = spec_of(size, *scales)
        frames = frames_of('texture', size, n_streams, 11)
        before = tfk.preprocess.launches
        got = tfk.preprocess(spec, frames.to(cuda))
        torch.cuda.synchronize()
        assert tfk.preprocess.launches == before + 1
        assert_state_equal(got, tfk.preprocess_reference(spec, frames),
                           spec, str(size))


@pytest.mark.cuda
def test_kernel_is_repeatable_and_raises_on_bad_frames(cuda):
    spec = spec_of((1280, 720))
    frames = frames_of('ties', (1280, 720), 2).to(cuda)
    a, b = tfk.preprocess(spec, frames), tfk.preprocess(spec, frames)
    assert all(torch.equal(x, y) for x, y in zip(flat_state(a),
                                                 flat_state(b)))
    with pytest.raises(ValueError, match='preprocess: '):
        tfk.preprocess(spec, frames.float())
