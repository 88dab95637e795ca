"""The port's ``parallel.MultiStreamMOT`` against the JAX package's, in the
setup of tests/test_multi_mot.py (2 streams at 320x256, YOLOv4-tiny,
detector_frame_skip=2, 5 frames), the JAX package's YOLOv4-tiny and
OSNet-x0.25 parameters carried across and its RANSAC draws fed to the
port: the batched detector's padded output (before synthetic detections
are spliced in, since random weights find little), the [S, D, F]
embeddings of one OSNet call, and each stream's tracks on every frame."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from fastmot_tpu.detector import make_detections as jax_detections
from fastmot_tpu.models import registry as jreg
from fastmot_tpu.parallel.multi_mot import MultiStreamMOT as JaxMultiMOT
from fastmot_tpu_torch.detector import MAX_DETS, make_detections
from fastmot_tpu_torch.ops import flow_kernels as tfk
from fastmot_tpu_torch.parallel import MultiStreamMOT
from fastmot_tpu_torch.weights import flax_to_state_dict

from .test_torch_flow import jax_draws
from .test_torch_osnet_block import flax_flat
from .test_torch_ssd import (  # noqa: F401 (autouse fixture)
    numpy_variables, one_torch_thread)

SIZE, N_STREAMS, N_FRAMES = (320, 256), 2, 5
CFG = dict(detector_frame_skip=2, class_ids=(0,),
           yolo_detector_cfg={'model': 'YOLOv4Tiny', 'conf_thresh': 0.9,
                              'min_aspect_ratio': 0.0},
           tracker_cfg={'max_age': 3})
N_OBJ = 3
HEAD_GAIN = 20.0
REL = 5e-2      # the zoo and OSNet tolerance (bf16 nets)


def frames_of():
    """Drifting textured frames, a different texture and drift per
    stream."""
    out = []
    for s in range(N_STREAMS):
        rng = np.random.default_rng(7 + s)
        base = ndi.gaussian_filter(
            rng.uniform(0, 255, (SIZE[1] + 8, SIZE[0] + 8, 3))
            .astype(np.float32), 1.5)
        out.append([np.clip(base[(i * (s + 1)) % 4:(i * (s + 1)) % 4 + SIZE[1],
                                 i % 3:i % 3 + SIZE[0]], 0, 255)
                    .astype(np.uint8) for i in range(N_FRAMES)])
    return [np.stack([out[s][i] for s in range(N_STREAMS)])
            for i in range(N_FRAMES)]


def synth(f, s):
    """[N_OBJ, 4] boxes moving 2 px a frame, offset per stream."""
    x = 30.0 + 80 * np.arange(N_OBJ) + 2 * f + 10 * s
    y = 40.0 + 30 * np.arange(N_OBJ)
    return np.rint(np.stack([x, y, x + 40, y + 110], -1))


def padded(f):
    tlbr = np.zeros((N_STREAMS, MAX_DETS, 4), np.float32)
    for s in range(N_STREAMS):
        tlbr[s, :N_OBJ] = synth(f, s)
    valid = np.zeros((N_STREAMS, MAX_DETS), bool)
    valid[:, :N_OBJ] = True
    return (tlbr, np.where(valid, 0, -1).astype(np.int32),
            np.where(valid, 0.9, 0).astype(np.float32), valid)


def run(mot, frames, as_array, make):
    """Steps the frames with the synthetic detections spliced in after the
    real batched detector ran. Returns the real padded detector outputs,
    the embeddings of each association frame and every stream's
    (id, tlbr) rows after each frame."""
    det, ext = mot.detector, mot.extractor
    real_post, real_dev = det.postprocess, det.postprocess_device_batch
    real_emb = ext.postprocess_device
    seen = {'det': [], 'emb': []}

    def post():
        real_post()
        return [make(synth(0, s), np.zeros(N_OBJ, int), np.full(N_OBJ, 0.9))
                for s in range(N_STREAMS)]

    def post_dev():
        seen['det'].append([np.asarray(a) for a in real_dev()])
        return tuple(as_array(a) for a in padded(mot.frame_count))

    def emb_dev():
        out = real_emb()
        seen['emb'].append(np.asarray(out))
        return out

    det.postprocess, det.postprocess_device_batch = post, post_dev
    ext.postprocess_device = emb_dev
    mot.reset(1 / 30.0)
    snaps = []
    for frame in frames:
        mot.step(as_array(frame))
        mot.sync()
        snaps.append([sorted((t.trk_id, np.asarray(t.tlbr, float))
                             for t in mot.visible_tracks(s))
                      for s in range(N_STREAMS)])
    return seen, snaps, mot


def numpy_init(cls, seed=0):
    """The JAX registry's ``init_params`` with seeded numpy values in place
    of ``module.init`` (which compiles the whole network). A YOLO's head
    convs are scaled up by ``HEAD_GAIN``: random weights otherwise score
    hundreds of boxes within 1e-4 of each other, and which of them the
    padded output keeps turns on bf16 roundings."""
    module = cls.build()
    c, h, w = cls.INPUT_SHAPE
    variables = numpy_variables(module, np.zeros((1, h, w, c), np.float32),
                                5 + seed)
    n_head = 3 * (5 + getattr(cls, 'NUM_CLASSES', -5))
    return module, jax.tree.map(
        lambda a: a * HEAD_GAIN if a.shape[-1] == n_head else a, variables)


@pytest.fixture(scope='module')
def runs():
    frames = frames_of()
    mp = pytest.MonkeyPatch()
    try:
        mp.setattr(jreg._ModelBase, 'init_params', classmethod(numpy_init))
        jmot = JaxMultiMOT(SIZE, N_STREAMS, **CFG)
        want = run(jmot, frames, jnp.asarray, jax_detections)
        mp.setattr(tfk, 'ransac_draws_batch',
                   lambda seeds, f_cap, device: tuple(
                       torch.stack(u).to(device) for u in
                       zip(*(jax_draws(s, f_cap) for s in seeds))))
        mot = MultiStreamMOT(SIZE, N_STREAMS, device='cpu', **CFG)
        mot.detector._single.module.load_state_dict(flax_to_state_dict(
            flax_flat(jmot.detector._single.params)))
        mot.extractor.module.load_state_dict(flax_to_state_dict(flax_flat(
            jmot.extractor.params)))
        got = run(mot, frames, torch.as_tensor, make_detections)
    finally:
        mp.undo()
    return got, want


def test_batched_detector_matches_jax(runs):
    """The raw heads of one network batch over both streams' resized
    frames within 5e-2 relative of the JAX package's; then the
    padded detections after the stream-batched NMS: counts within 10 %,
    and 80 % of the port's kept boxes have a box of the JAX package's of
    the same label within 5e-2 of its size and 5e-2 in confidence. A bf16
    ulp can reorder near-tied scores or flip a box at the confidence or
    the NMS threshold, and the random net's boxes overlap heavily (2-4 of
    35 flip in a stream)."""
    from fastmot_tpu.detector import _resize_bilinear_rgb

    (got, _, mot), (want, _, jmot) = runs
    frames = frames_of()[2]
    d, jd = mot.detector._single, jmot.detector._single
    c, ih, iw = d.model.INPUT_SHAPE
    assert not d.model.LETTERBOX
    with torch.no_grad():
        heads = d.module(d.preprocess(torch.as_tensor(frames)))
    canvases = jax.vmap(lambda f: _resize_bilinear_rgb(
        f[..., ::-1].astype(jnp.float32) / 255.0, (ih, iw)))(frames)
    want_heads = jax.jit(jd.module.apply)(jd.params, canvases)
    for h, w in zip(heads, want_heads):
        h, w = h.float().numpy(), np.asarray(w, np.float32)
        assert h.shape == w.shape and h.shape[0] == N_STREAMS
        assert np.abs(h - w).max() / np.abs(w).max() < REL

    assert len(got['det']) == len(want['det']) == 2
    n_kept = 0
    for g, w in zip(got['det'], want['det']):
        assert g[0].shape == w[0].shape == (N_STREAMS, MAX_DETS, 4)
        for s in range(N_STREAMS):
            g_tlbr, g_label, g_conf = (a[s][g[3][s]] for a in g[:3])
            w_tlbr, w_label, w_conf = (a[s][w[3][s]] for a in w[:3])
            assert abs(len(g_tlbr) - len(w_tlbr)) <= 0.1 * len(w_tlbr)
            extent = (w_tlbr[:, 2:] - w_tlbr[:, :2] + 1).max(-1)
            near = ((g_label[:, None] == w_label[None])
                    & (np.abs(g_tlbr[:, None] - w_tlbr[None]).max(-1)
                       <= REL * extent[None])
                    & (np.abs(g_conf[:, None] - w_conf[None])
                       <= REL * w_conf[None]))
            assert near.any(1).mean() >= 0.8, near.any(1).mean()
            n_kept += len(g_tlbr)
    assert n_kept > 0


def test_batched_embeddings_match_jax(runs):
    """One OSNet call on the [S * D] crops gives the JAX package's [S, D,
    F] rows: the valid ones within 5e-2 relative (cosine >= 0.999), the
    padded ones zero."""
    (got, _, _), (want, _, _) = runs
    for g, w in zip(got['emb'], want['emb']):
        assert g.shape == w.shape == (N_STREAMS, MAX_DETS, 512)
        g, w = g[:, :N_OBJ].reshape(-1, 512), w[:, :N_OBJ].reshape(-1, 512)
        err = np.abs(g - w).max() / np.abs(w).max()
        cos = (g * w).sum(1) / (np.linalg.norm(g, axis=1)
                                * np.linalg.norm(w, axis=1))
        assert err < REL or cos.min() >= 0.999, (err, cos.min())
    assert not got['emb'][0][:, N_OBJ:].any()


def test_multi_stream_tracks_match_jax(runs):
    (_, got, _), (_, want, _) = runs
    assert len(got) == len(want) == N_FRAMES
    n_rows = 0
    for f, (g_streams, w_streams) in enumerate(zip(got, want)):
        for s, (g, w) in enumerate(zip(g_streams, w_streams)):
            assert [t for t, _ in g] == [t for t, _ in w], (f, s, g, w)
            for (_, a), (_, b) in zip(g, w):
                assert np.abs(a - b).max() <= 2.0, (f, s, a, b)
            n_rows += len(g)
    # tracks are confirmed at the first association frame (frame 2)
    assert n_rows == N_OBJ * N_STREAMS * (N_FRAMES - 2)
