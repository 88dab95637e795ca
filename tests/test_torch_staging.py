"""The port's frame staging (``fastmot_tpu_torch.utils.staging``): host
frames through a ring of reused host buffers onto the device, as
``MultiStreamMOT._stage_frames`` and ``MOT`` use it. On the CPU the same
code runs with unpinned slots; the cases marked ``cuda`` run it with
page-locked slots and non-blocking copies on the card. This file imports no
JAX:

    python -m pytest tests/test_torch_staging.py -m cuda
"""
import numpy as np
import pytest
import torch

from fastmot_tpu_torch.detector import MAX_DETS, make_detections
from fastmot_tpu_torch.mot import MOT
from fastmot_tpu_torch.parallel import MultiStreamMOT
from fastmot_tpu_torch.utils import profiler
from fastmot_tpu_torch.utils.profiler import Profiler
from fastmot_tpu_torch.utils.staging import SLOTS, FrameStager

COUNTERS = ('host_syncs', 'stage_pinned', 'stage_slot_waits')
SHAPES = {'frame': (48, 80, 3), 'batch': (3, 48, 80, 3)}
SIZE, N_STREAMS, N_OBJ, SKIP = (320, 256), 2, 3, 2


@pytest.fixture(autouse=True, scope='module')
def one_torch_thread():
    """One intra-op thread: the tier-1 run puts six test workers on the
    cores, and torch's pool, oversubscribed, slows small CPU ops tenfold."""
    n = torch.get_num_threads()
    torch.set_num_threads(1)
    yield
    torch.set_num_threads(n)


@pytest.fixture
def cuda_device():
    """The card, or a skip: pinned memory and non-blocking copies need
    one."""
    if not torch.cuda.is_available():
        pytest.skip('needs a CUDA device (python -m pytest '
                    'tests/test_torch_staging.py -m cuda on a machine with '
                    'the card)')
    return torch.device('cuda')


def _counts():
    return {k: Profiler.counters[k] for k in COUNTERS}


def _delta(before):
    return {k: Profiler.counters[k] - v for k, v in before.items()}


def _frames(shape, seed=0):
    return np.random.default_rng(seed).integers(0, 256, shape, np.uint8)


def _as_form(a, form, tmp_path):
    """``a`` as the caller would hand it over."""
    if form == 'ndarray':
        return a
    if form == 'memmap':             # read-only, as a recorded batch is
        path = tmp_path / 'frames.u8'
        a.tofile(path)
        return np.memmap(path, np.uint8, 'r', shape=a.shape)
    if form == 'cpu_tensor':
        return torch.from_numpy(a)
    if form == 'list':
        return list(a)
    return tuple(torch.from_numpy(f) for f in a)      # 'tensor_tuple'


def _slot_ptrs(stager):
    return {s.data_ptr() for s in stager._slots}


@pytest.mark.parametrize('form, shape', [
    (form, shape) for shape in SHAPES
    for form in ('ndarray', 'memmap', 'cpu_tensor', 'list', 'tensor_tuple')
    if shape != 'frame' or form not in ('list', 'tensor_tuple')])
def test_every_host_form_stages_to_the_same_tensor(form, shape, tmp_path):
    """Each host form of a frame or batch (a list holds frames, so only a
    batch comes as one) stages to a fresh tensor equal to it, through the
    ring (a slot of its shape), with no sync counted."""
    a = _frames(SHAPES[shape])
    stager = FrameStager('cpu')
    before, spans = _counts(), Profiler.count['stage']
    out = stager(_as_form(a, form, tmp_path))
    assert out.device.type == 'cpu' and out.dtype == torch.uint8
    assert torch.equal(out, torch.from_numpy(a))
    assert out.data_ptr() not in _slot_ptrs(stager)
    assert [tuple(s.shape) for s in stager._slots] == [a.shape] * SLOTS
    assert _delta(before) == dict.fromkeys(COUNTERS, 0)
    assert Profiler.count['stage'] == spans + 1


@pytest.mark.parametrize('form', ['ndarray', 'cpu_tensor', 'list'])
def test_staged_tensors_survive_the_callers_overwrite(form, tmp_path):
    """One array reused by the caller, overwritten right after each call,
    over three turns of the ring: every staged tensor keeps the frames it
    was given."""
    buf = _frames(SHAPES['batch'])
    stager = FrameStager('cpu')
    want, got = [], []
    for i in range(3 * SLOTS):
        want.append(buf.copy())
        got.append(stager(_as_form(buf, form, tmp_path)))
        buf[...] = _frames(buf.shape, seed=i + 1)
    for w, g in zip(want, got):
        assert torch.equal(g, torch.from_numpy(w))


@pytest.mark.parametrize('odd', [(48, 81, 3), (1, 80, 3)], ids=['width',
                                                              'broadcast'])
def test_a_batch_of_frames_of_another_shape_is_refused(odd):
    """A list whose frames differ in shape raises, even where one would
    broadcast into the slot."""
    frames = [_frames(SHAPES['frame']), _frames(odd)]
    with pytest.raises(ValueError, match='differ'):
        FrameStager('cpu')(frames)


def test_a_new_shape_reallocates_the_ring():
    """A frame of another shape allocates the ring anew and starts it at its
    first slot; the old shape's frames afterwards stage as before."""
    stager = FrameStager('cpu')
    a, b = _frames(SHAPES['batch']), _frames(SHAPES['frame'], seed=1)
    assert torch.equal(stager(a), torch.from_numpy(a))
    old = _slot_ptrs(stager)
    assert stager._next == 1
    assert torch.equal(stager(b), torch.from_numpy(b))
    assert [tuple(s.shape) for s in stager._slots] == [b.shape] * SLOTS
    assert _slot_ptrs(stager).isdisjoint(old) and stager._next == 1
    assert torch.equal(stager(a), torch.from_numpy(a))
    assert [tuple(s.shape) for s in stager._slots] == [a.shape] * SLOTS


class MeanColour(torch.nn.Module):
    """A stand-in for OSNet (its 256 crops take the CPU 20 s a frame): each
    crop's mean colour through a fixed projection."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Parameter(torch.randn(
            3, 512, generator=torch.Generator().manual_seed(3)))

    def forward(self, x):
        return x.float().mean((1, 2)) @ self.proj


def _boxes(f, s):
    x = 30.0 + 80 * np.arange(N_OBJ) + 2 * f + 10 * s
    y = 40.0 + 30 * np.arange(N_OBJ)
    return np.stack([x, y, x + 40, y + 110], -1)


def _padded(f, streams, device):
    """The synthetic detections as the detector's padded device tensors
    ([MAX_DETS] rows, a leading stream axis unless ``streams`` is None)."""
    tlbr = torch.zeros(streams or 1, MAX_DETS, 4)
    for s in range(streams or 1):
        tlbr[s, :N_OBJ] = torch.as_tensor(_boxes(f, s))
    valid = torch.arange(MAX_DETS).expand(streams or 1, MAX_DETS) < N_OBJ
    out = (tlbr, torch.where(valid, 0, -1).int(), valid.float() * 0.9, valid)
    return tuple((t if streams else t[0]).to(device) for t in out)


def _splice(det, streams, frame_count, device):
    """The real detector runs; its rows are replaced by the synthetic
    ones."""
    real_post = det.postprocess
    real_dev = det.postprocess_device_batch if streams else \
        det.postprocess_device

    def post():
        real_post()
        dets = [make_detections(_boxes(0, s), np.zeros(N_OBJ, int),
                                np.full(N_OBJ, 0.9))
                for s in range(streams or 1)]
        return dets if streams else dets[0]

    def post_dev():
        real_dev()
        return _padded(frame_count(), streams, device)

    det.postprocess = post
    if streams:
        det.postprocess_device_batch = post_dev
    else:
        det.postprocess_device = post_dev


def _program(path, device):
    """``MultiStreamMOT`` ('multi') or ``MOT`` ('step', 'step_batch') on
    YOLOv4-tiny with synthetic detections spliced in and the stand-in
    ReID."""
    torch.manual_seed(0)
    kw = dict(detector_frame_skip=SKIP, class_ids=(0,),
              yolo_detector_cfg={'model': 'YOLOv4Tiny'},
              tracker_cfg={'max_age': 3}, device=device)
    if path == 'multi':
        mot = MultiStreamMOT(SIZE, N_STREAMS, **kw)
        ext = mot.extractor
    else:
        mot = MOT(SIZE, detector_type='YOLO', **kw)
        ext = mot.extractors[0]
    ext.module, ext.out_hw = MeanColour().to(device), (16, 8)
    _splice(mot.detector, N_STREAMS if path == 'multi' else None,
            lambda: mot.frame_count, device)
    mot.reset(1 / 30.0)
    return mot


def _texture(n):
    base = np.random.default_rng(3).integers(0, 256, (SIZE[1] + 8,
                                                      SIZE[0] + 8, 3))
    return [[base[i % 4:i % 4 + SIZE[1], (i + s) % 8:(i + s) % 8 + SIZE[0]]
             .astype(np.uint8) for s in range(N_STREAMS)] for i in range(n)]


def _tracks(path, device, reuse, n_frames=2 * SKIP + 1):
    """Each stream's sorted (id, tlbr) rows after every association frame.
    ``reuse``: the caller writes every frame into one array, overwritten
    right after each call; else a fresh array a frame, staged by the plain
    copy staging was before the ring."""
    mot = _program(path, device)
    if not reuse:
        mot._stage = lambda f: torch.tensor(np.array(f)).to(device)
    buf = np.zeros((N_STREAMS, SIZE[1], SIZE[0], 3), np.uint8)
    rows = []
    for i, streams in enumerate(_texture(n_frames)):
        frames = buf if reuse else np.stack(streams)
        frames[...] = np.stack(streams)
        if path == 'multi':
            mot.step(list(frames) if reuse else frames)
        elif path == 'step':
            mot.step(frames[0])
        else:
            mot.step_batch([frames[0]])
        if reuse:
            buf[...] = 0
        if i % SKIP == 0:
            if path == 'multi':
                mot.sync()
                rows.append([sorted((t.trk_id, t.tlbr.tolist())
                                    for t in mot.visible_tracks(s))
                             for s in range(N_STREAMS)])
            else:
                rows.append(sorted((t.trk_id, t.tlbr.tolist())
                                   for t in mot.visible_tracks()))
    return rows, mot


@pytest.mark.parametrize('path', ['multi', 'step', 'step_batch'])
def test_tracks_as_before_with_the_callers_array_reused(path):
    """``MultiStreamMOT.step``, ``MOT.step`` and ``MOT.step_batch`` (whose
    gap frames wait in its buffer for the next detection frame) over two
    skip cycles: the same tracks, bit for bit, as with a fresh copy of
    every frame, while the caller overwrites its one array after each
    call."""
    want, _ = _tracks(path, 'cpu', reuse=False)
    got, _ = _tracks(path, 'cpu', reuse=True)
    assert got == want
    assert sum(len(s) for r in got
               for s in (r if path == 'multi' else [r])) > 0


@pytest.mark.cuda
@pytest.mark.parametrize('busy', [False, True])
def test_pinned_ring_on_the_card_keeps_every_batch(cuda_device, busy):
    """Three turns of the ring at the main path's batch (8 x 1280x720) with
    no sync between them, the caller overwriting one array after each call:
    every staged batch equals its source bit for bit. On a stream held busy
    by a sleep kernel the ring comes round to a slot whose copy is still
    queued, and waits on it (each wait a host sync); on an idle one it never
    waits."""
    stager = FrameStager(cuda_device)
    want = [_frames((8, 720, 1280, 3), seed=i) for i in range(3 * SLOTS)]
    buf = want[0].copy()
    stager(buf)
    torch.cuda.synchronize()
    before = _counts()
    if busy:
        torch.cuda._sleep(2_000_000_000)        # about 1 s of the card
    got = []
    for i in range(3 * SLOTS):
        got.append(stager(buf))
        buf[...] = want[(i + 1) % len(want)]
    torch.cuda.synchronize()
    for w, g in zip(want, got):
        assert g.device.type == 'cuda'
        assert torch.equal(g.cpu(), torch.from_numpy(w))
    counts = _delta(before)
    assert counts['stage_pinned'] == 3 * SLOTS
    assert counts['host_syncs'] == counts['stage_slot_waits']
    assert (counts['stage_slot_waits'] > 0) == busy
    assert all(s.is_pinned() for s in stager._slots)


@pytest.mark.cuda
def test_multi_stream_steps_stage_once_pinned_without_a_sync(cuda_device):
    """``MultiStreamMOT`` on the card over three skip cycles with the
    tracer on: every step's ``stage`` span stages one batch through a
    pinned slot, counts no host sync, and no step after the first cycle
    waits on a slot."""
    mot = _program('multi', cuda_device)
    frames = [np.stack(s) for s in _texture(2 * SKIP + 1)]
    mot.step(frames[0])
    mot.sync()
    profiler.records()
    profiler.enable()
    try:
        for i in range(3 * SKIP):
            mot.step(frames[(i + 1) % len(frames)])
        mot.sync()
    finally:
        profiler.disable()
    stages = [r for r in profiler.records() if r.name == 'stage']
    assert len(stages) == 3 * SKIP
    assert [r.counts for r in stages] == [{'stage_pinned': 1}] * len(stages)
