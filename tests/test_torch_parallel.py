"""The port's ('streams', 'model') mesh over torch.distributed (gloo ranks
on the CPU, spawned by ``fastmot_tpu_torch.multichip.run_ranks``) against
the JAX package's mesh and the port's unsharded runs:

- the Flax paths ``shard_conv_channels`` shards for YOLOv4-tiny at k = 2
  and 4 are the ones JAX ``conv_channel_shardings`` marks sharded on the
  8-device CPU mesh of tests/conftest.py;
- YOLOv4-tiny at 64x64 channel-sharded 4 ways gives the unsharded heads
  within 1e-5 relative (each rank keeps a quarter of every conv's output
  channels and gathers them after the activation; the sums of one output
  channel are the same sums, so only a conv algorithm chosen for the
  narrower output could move them);
- ``MultiStreamMOT`` at 4 streams on (2, 2) and (4, 1) meshes gives the
  unsharded run's track IDs, ages and hits on every stream and frame, and
  its boxes within 1e-3 px (the batched cores run on fewer streams, which
  may round apart by an ulp);
- ``dryrun_multichip(4, device='cpu')`` with YOLOv4-tiny passes.
"""
import numpy as np
import pytest
import scipy.ndimage as ndi
import torch

from fastmot_tpu_torch import multichip
from fastmot_tpu_torch.models import registry
from fastmot_tpu_torch.models.layers import random_init_
from fastmot_tpu_torch.parallel import MultiStreamMOT, conv_channel_plan

from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse)

HEADS_REL = 1e-5
BOX_PX = 1e-3
SIZE, N_STREAMS, N_FRAMES, D_CAP = (320, 256), 4, 5, 8
MOT_KWARGS = dict(size=SIZE, detector_frame_skip=2, class_ids=(0,),
                  yolo_detector_cfg={'model': 'YOLOv4Tiny'},
                  tracker_cfg={'max_age': 3})


@pytest.mark.parametrize('k', [2, 4])
def test_shard_plan_matches_jax(k):
    import jax
    import jax.numpy as jnp
    from fastmot_tpu.models import registry as jreg
    from fastmot_tpu.parallel import conv_channel_shardings, make_stream_mesh

    module = jreg.YOLOModel.get_model('YOLOv4Tiny').build()
    shapes = jax.eval_shape(module.init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 64, 64, 3), jnp.float32))
    shardings = conv_channel_shardings(shapes,
                                       make_stream_mesh(model_parallel=k))
    want = sorted('/'.join(str(p.key) for p in path) for path, s in
                  jax.tree_util.tree_leaves_with_path(shardings)
                  if not s.is_fully_replicated)
    got = conv_channel_plan(
        registry.YOLOModel.get_model('YOLOv4Tiny').build(), k)
    assert got == want and len(got) > 10


def test_channel_sharded_yolo_matches_unsharded():
    x = np.random.default_rng(3).uniform(0, 1, (1, 64, 64, 3)) \
        .astype(np.float32)
    module = registry.YOLOModel.get_model('YOLOv4Tiny').build() \
        .requires_grad_(False).eval()
    random_init_(module, torch.Generator().manual_seed(0))
    full = {k: tuple(v.shape) for k, v in module.state_dict().items()}
    with torch.no_grad():
        want = [h.numpy() for h in module(torch.from_numpy(x))]
    ranks = multichip.run_ranks(4, multichip.sharded_heads_rank,
                                ('YOLOv4Tiny', x, 4))
    plan = conv_channel_plan(module, 4)
    from fastmot_tpu_torch.weights import flax_shapes
    full_flax = flax_shapes(module)
    for out in ranks:
        assert out['plan'] == plan
        # exactly the planned entries hold a quarter of their channels
        split = sorted(p for p, s in out['shapes'].items()
                       if s != full_flax[p])
        assert split == plan
        for p in plan:
            assert out['shapes'][p][-1] * 4 == full_flax[p][-1]
        for g, w in zip(out['heads'], want):
            np.testing.assert_allclose(g, w, rtol=0,
                                       atol=HEADS_REL * np.abs(w).max())
    assert len(full) > len(plan)


def _frames():
    out = []
    for s in range(N_STREAMS):
        rng = np.random.default_rng(30 + s)
        base = ndi.gaussian_filter(
            rng.uniform(0, 255, (SIZE[1] + 8, SIZE[0] + 8, 3))
            .astype(np.float32), 1.5)
        out.append([np.clip(base[i:i + SIZE[1], 2 * i:2 * i + SIZE[0]], 0,
                            255).astype(np.uint8) for i in range(N_FRAMES)])
    return np.stack([np.stack([out[s][i] for s in range(N_STREAMS)])
                     for i in range(N_FRAMES)])


def _dets():
    """Stream s starts with 2 + s objects, which move 2 px a frame; at
    frame 2 the odd streams gain one, at frame 4 every stream (new tracks
    at those syncs, whose IDs depend on the other ranks'). Padded to
    D_CAP rows, not the detector's MAX_DETS: OSNet embeds every row, and
    on the CPU 4 x 128 crops take a minute."""
    det_frames = [0, 2, 4]
    tlbr = np.zeros((3, N_STREAMS, D_CAP, 4), np.float32)
    valid = np.zeros((3, N_STREAMS, D_CAP), bool)
    for i, f in enumerate(det_frames):
        for s in range(N_STREAMS):
            n = 2 + s + (f > 0 and s % 2) + (f > 2)
            x = 4.0 + 29 * np.arange(n) + 2 * f
            y = 10.0 + 9 * np.arange(n) + f
            tlbr[i, s, :n] = np.stack([x, y, x + 26, y + 60], -1)
            valid[i, s, :n] = True
    return dict(frames=np.array(det_frames), tlbr=tlbr,
                label=np.where(valid, 0, -1).astype(np.int32),
                conf=np.where(valid, 0.9, 0).astype(np.float32),
                valid=valid)


def _same(got, want, where):
    assert [r[0] for r in got] == [r[0] for r in want], where
    assert [r[2:] for r in got] == [r[2:] for r in want], where
    for g, w in zip(got, want):
        assert np.abs(np.subtract(g[1], w[1])).max() <= BOX_PX, where


def test_multi_stream_mesh_gives_unsharded_ids(tmp_path):
    frames, dets = _frames(), _dets()
    np.save(tmp_path / 'frames.npy', frames)
    np.savez(tmp_path / 'dets.npz', **dets)
    kwargs = dict(MOT_KWARGS)
    size = kwargs.pop('size')
    ref, _ = multichip.run_multi_stream(
        MultiStreamMOT(size, N_STREAMS, device='cpu', **kwargs), frames,
        dets, sync_every_frame=True)
    assert all(ref[-1][s] for s in range(N_STREAMS))
    for shape in ((2, 2), (4, 1)):
        ranks = multichip.run_ranks(4, multichip.multi_stream_rank, (
            str(tmp_path), N_STREAMS, shape[1], MOT_KWARGS, 'cpu', 'cpu',
            True))
        for rank, out in enumerate(ranks):
            block = rank // shape[1]
            n_local = N_STREAMS // shape[0]
            assert out['local_streams'] == list(
                range(block * n_local, (block + 1) * n_local))
            for f, (got, want) in enumerate(zip(out['rows'], ref)):
                for s in out['local_streams']:
                    _same(got[s], want[s], (shape, rank, f, s))


class _Mesh:
    """A (2, 2) mesh seen from global rank 3 (no process group needed: the
    ownership check runs before any collective)."""
    mesh_dim_names = ('streams', 'model')
    mesh = torch.arange(4).reshape(2, 2)

    def size(self, dim):
        return 2

    def get_local_rank(self, axis):
        return 1

    def get_rank(self):
        return 3

    def get_group(self, axis):
        return None


def test_visible_tracks_names_the_owner():
    from fastmot_tpu_torch.parallel import StreamTracker
    st = StreamTracker(SIZE, 'euclidean', N_STREAMS, device='cpu',
                       mesh=_Mesh())
    assert st.local_streams == range(2, 4) and len(st.trackers) == 2
    with pytest.raises(ValueError, match=r'stream 1 is tracked on '
                                         r'rank\(s\) \[0, 1\], not on rank 3'):
        st.visible_tracks(1)


def test_entry_is_yolov4_with_the_fused_decode():
    fn, (module, frame) = multichip.entry(device='cpu')
    assert tuple(frame.shape) == (1, 512, 512, 3)
    with torch.no_grad():      # fully convolutional: a small input will do
        rows = fn(module, frame[:, :64, :64])
    assert tuple(rows.shape) == (1, 3 * (8 * 8 + 4 * 4 + 2 * 2), 7)
    assert bool(torch.isfinite(rows).all())


def test_mesh_entry_points_need_the_card_unless_asked_for_the_cpu():
    """On the card by default; without one they raise, never moving to
    the CPU unasked."""
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present: the default is valid here')
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multichip.dryrun_multichip(1)
    with pytest.raises(RuntimeError, match="device='cpu'"):
        multichip.entry()


def test_dryrun_multichip_cpu(monkeypatch, capsys):
    monkeypatch.setenv('FASTMOT_DRYRUN_MODEL', 'YOLOv4Tiny')
    multichip.dryrun_multichip(4, device='cpu')
    out = capsys.readouterr().out
    assert 'dryrun ok: 2 streams x 2-way TP on 4 devices' in out
    assert 'detector=YOLOv4Tiny @64x64; 16/16 seeded tracks alive' in out


@pytest.mark.slow
def test_dryrun_multichip_flagship_cpu(monkeypatch, capsys):
    monkeypatch.setenv('FASTMOT_DRYRUN_MODEL', 'YOLOv4')
    multichip.dryrun_multichip(4, device='cpu')
    assert 'detector=YOLOv4 @512x512' in capsys.readouterr().out
