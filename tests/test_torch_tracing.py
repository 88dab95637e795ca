"""The port's tracer (``fastmot_tpu_torch.utils.profiler``) and its spans
and ``host_syncs`` counter in ``parallel.MultiStreamMOT``, in the setup of
tests/test_torch_multi_mot.py (2 streams at 320x256, YOLOv4-tiny,
detector_frame_skip=2, 5 frames, synthetic detections spliced in after the
real detector), on the CPU, with a stand-in for OSNet (a 16x8 crop's mean
colour through a fixed projection: OSNet's 256 crops of 256x128 take the
CPU 20 s a frame). The same program runs twice, with the tracer off and
then on under a CPU ``torch.profiler``."""
import json
import logging
from collections import Counter

import numpy as np
import pytest
import torch

from fastmot_tpu_torch.detector import make_detections
from fastmot_tpu_torch.mot import MOT, SPANS
from fastmot_tpu_torch.parallel import MultiStreamMOT
from fastmot_tpu_torch.utils import profiler
from fastmot_tpu_torch.utils.profiler import Profiler

from .test_torch_multi_mot import CFG, N_OBJ, N_STREAMS, SIZE, frames_of, run
from .test_torch_ssd import one_torch_thread  # noqa: F401 (autouse fixture)

KINDS = ['init', 'gap', 'assoc', 'gap', 'assoc']
# each kind's spans directly under its step, in the order they open
STEP_CHILDREN = {
    'init': ['stage', 'detector', 'detector.post'],
    'gap': ['stage', 'flow'],
    'assoc': ['stage', 'detector', 'flow', 'detector.post', 'reid', 'reid',
              'assoc'],
}


class MeanColour(torch.nn.Module):
    """[N, h, w, 3] crops -> [N, 512]: each crop's mean colour through a
    fixed projection."""

    def __init__(self):
        super().__init__()
        self.proj = torch.nn.Parameter(torch.randn(
            3, 512, generator=torch.Generator().manual_seed(3)))

    def forward(self, x):
        return x.float().mean((1, 2)) @ self.proj


def _syncs():
    return Profiler.counters['host_syncs']


@pytest.fixture(scope='module')
def traced(tmp_path_factory):
    """(tracks with the tracer off, tracks with it on, the records, the
    profiler's ``fastmot.*`` events, host_syncs counted with it on, the
    program)."""
    torch.manual_seed(0)
    mot = MultiStreamMOT(SIZE, N_STREAMS, device='cpu', **CFG)
    mot.extractor.module = MeanColour()
    mot.extractor.out_hw = (16, 8)
    frames = frames_of()
    profiler.disable()
    # with the tracer off, no range opens even while a profiler records
    entered = []
    with pytest.MonkeyPatch.context() as mp:
        mp.setattr(torch.profiler, 'record_function',
                   lambda name: entered.append(name))
        mp.setattr(profiler, '_profiling', lambda: True)
        _, off, _ = run(mot, frames, torch.as_tensor, make_detections)
    off_recs = profiler.records()
    from torch.profiler import ProfilerActivity, profile
    before = _syncs()
    profiler.enable()
    try:
        with profile(activities=[ProfilerActivity.CPU]) as prof:
            _, on, _ = run(mot, frames, torch.as_tensor, make_detections)
    finally:
        profiler.disable()
    counted = _syncs() - before
    recs = profiler.records()
    path = tmp_path_factory.mktemp('trace') / 'trace.json'
    prof.export_chrome_trace(str(path))
    events = [e for e in json.loads(path.read_text())['traceEvents']
              if e.get('cat') == 'user_annotation'
              and e.get('name', '').startswith('fastmot.')]
    return off, on, recs, events, counted, mot, (off_recs, entered)


def _by_id(recs):
    return {r.id: r for r in recs}


def _children(recs, parent):
    return sorted((r for r in recs if r.parent == parent.id),
                  key=lambda r: r.start)


def _subtree_syncs(recs, root):
    kids = [r for r in recs if r.parent == root.id]
    return root.counts.get('host_syncs', 0) + sum(
        _subtree_syncs(recs, k) for k in kids)


def test_tracks_bit_equal_with_the_tracer_on_and_off(traced):
    off, on = traced[0], traced[1]
    assert len(off) == len(on) == len(KINDS)
    for f_off, f_on in zip(off, on):
        for s_off, s_on in zip(f_off, f_on):
            assert [t for t, _ in s_off] == [t for t, _ in s_on]
            for (_, a), (_, b) in zip(s_off, s_on):
                assert np.array_equal(a, b)
    assert sum(len(s) for f in on for s in f) == \
        N_OBJ * N_STREAMS * (len(KINDS) - 2)


def test_every_span_lies_inside_its_parent(traced):
    recs = traced[2]
    by_id = _by_id(recs)
    assert recs
    for r in recs:
        assert r.start <= r.end
        if r.parent is None:
            assert r.name in ('step', 'sync'), r
            continue
        p = by_id[r.parent]
        assert p.start <= r.start <= r.end <= p.end, (r, p)
        assert r.step == p.step


def test_every_step_carries_its_frame_and_kind(traced):
    steps = [r for r in traced[2] if r.name == 'step']
    assert [(r.step, r.kind) for r in sorted(steps, key=lambda r: r.start)] \
        == list(enumerate(KINDS))
    assert all(r.kind is None for r in traced[2] if r.name != 'step')


@pytest.mark.parametrize('kind', sorted(STEP_CHILDREN))
def test_each_kind_of_step_holds_its_spans(traced, kind):
    recs = traced[2]
    steps = [r for r in recs if r.name == 'step' and r.kind == kind]
    assert steps
    for step in steps:
        assert [c.name for c in _children(recs, step)] == \
            STEP_CHILDREN[kind]
        # nothing nests deeper here: no restack met pending infos
        for c in _children(recs, step):
            assert not _children(recs, c), c


def test_sync_holds_one_fetch_then_one_replay(traced):
    recs = traced[2]
    syncs = [r for r in recs if r.name == 'sync']
    # the read-back after each frame, the init frame's found nothing
    assert len(syncs) == len(KINDS) - 1
    for s in syncs:
        assert [c.name for c in _children(recs, s)] == \
            ['sync.fetch', 'sync.replay']
    by_id = _by_id(recs)
    for r in recs:
        if r.name in ('sync.fetch', 'sync.replay'):
            assert by_id[r.parent].name == 'sync'


def test_host_syncs_count_each_wait(traced):
    """Every real wait, and no staging: the frames go through the staging
    ring with no wait of their own. On the init step the detector's four
    reads, on each stream with detections the Kalman init's upload and two
    reads, and the restack's upload of every state and history array; on
    each tracked step the upload of ``lk_core``'s constant; one fetch a
    sync."""
    recs, counted, mot = traced[2], traced[4], traced[5]
    st = mot.stream_tracker
    restack = len(st._dev_state) + len(st._hist_store)
    want = {'init': 4 + 3 * N_STREAMS + restack, 'gap': 1, 'assoc': 1}
    steps = sorted((r for r in recs if r.name == 'step'),
                   key=lambda r: r.start)
    got = [_subtree_syncs(recs, r) for r in steps]
    assert got == [want[k] for k in KINDS]
    syncs = [r for r in recs if r.name == 'sync']
    assert [_subtree_syncs(recs, r) for r in syncs] == [1] * len(syncs)
    assert counted == sum(got) + len(syncs) == \
        sum(r.counts.get('host_syncs', 0) for r in recs)


def test_exported_ranges_match_the_records(traced):
    """The profiler's ``fastmot.*`` ranges: the records' names, each
    nested under the record's parent."""
    recs, events = traced[2], traced[3]
    by_id = _by_id(recs)
    want = Counter((r.name, by_id[r.parent].name if r.parent is not None
                    else None) for r in recs)
    events = sorted(events, key=lambda e: (e['ts'], -e['dur']))
    got, open_ = Counter(), []
    for e in events:
        while open_ and e['ts'] >= open_[-1]['ts'] + open_[-1]['dur']:
            open_.pop()
        parent = open_[-1]['name'][len('fastmot.'):] if open_ else None
        got[e['name'][len('fastmot.'):], parent] += 1
        open_.append(e)
    assert got == want


def test_a_restack_with_pending_infos_syncs_inside_flow(traced):
    """A restack (the mirrors changed on the host) reads the pending
    infos first: ``sync`` under ``flow``."""
    mot = traced[5]
    frames = frames_of()
    mot.step(torch.as_tensor(frames[mot.frame_count % len(frames)]))
    for trk in mot.trackers:
        trk._mirrors_dirty = True
    profiler.enable()
    try:
        mot.stream_tracker.track(torch.as_tensor(frames[0]))
    finally:
        profiler.disable()
    recs = profiler.records()
    by_id = _by_id(recs)
    (sync,) = [r for r in recs if r.name == 'sync']
    assert by_id[sync.parent].name == 'flow'
    assert [c.name for c in _children(recs, sync)] == \
        ['sync.fetch', 'sync.replay']
    mot.sync()


def test_disabled_tracer_records_nothing_and_opens_no_range(traced):
    off_recs, entered = traced[6]
    assert off_recs == [] and entered == []
    assert len(traced[2]) > len(KINDS)


def test_enabled_tracer_opens_a_range_only_while_profiling(monkeypatch):
    entered = []

    class Range:
        def __init__(self, name):
            entered.append(name)

        def __enter__(self):
            return self

        def __exit__(self, *exc):
            return False
    monkeypatch.setattr(torch.profiler, 'record_function', Range)
    profiler.enable()
    try:
        with Profiler('t.quiet'):
            pass
        monkeypatch.setattr(profiler, '_profiling', lambda: True)
        with Profiler('t.loud'):
            with Profiler('t.inner'):
                pass
    finally:
        profiler.disable()
    assert entered == ['fastmot.t.loud', 'fastmot.t.inner']
    assert [r.name for r in profiler.records()] == ['t.quiet', 't.inner',
                                                    't.loud']


@pytest.mark.parametrize('enabled', [False, True])
def test_self_time_and_counts_of_nested_spans(enabled):
    """Self time is a span's length less its children's, an exception
    closes the span, counts land on the innermost open span, and a root
    span takes the last step given."""
    profiler.records()
    self_before = Profiler.self_timing['t.outer']
    n_before = Profiler.counters['t.n']
    if enabled:
        profiler.enable()
    try:
        with Profiler('t.outer', step=7, kind='k') as outer:
            profiler.count('t.n', 2)
            with Profiler('t.inner') as inner:
                profiler.count('t.n')
            with pytest.raises(ValueError):
                with Profiler('t.inner') as failed:
                    raise ValueError
        with Profiler('t.after') as after:
            pass
    finally:
        profiler.disable()
    assert Profiler.counters['t.n'] - n_before == 3
    assert Profiler.self_timing['t.outer'] - self_before == pytest.approx(
        outer.duration - inner.duration - failed.duration, abs=1e-9)
    recs = profiler.records()
    if not enabled:
        assert recs == []
        return
    assert after.step == 7
    assert [r.name for r in recs] == ['t.inner', 't.inner', 't.outer',
                                      't.after']
    by_name = {r.name: r for r in recs}
    assert by_name['t.outer'].counts == {'t.n': 2}
    assert by_name['t.outer'].kind == 'k'
    assert recs[0].counts == {'t.n': 1} and recs[1].counts == {}
    assert recs[0].parent == recs[1].parent == by_name['t.outer'].id
    assert by_name['t.after'].parent is None
    assert [r.step for r in recs] == [7] * 4
    assert profiler.records() == []


def test_print_timing_info_prints_each_span(caplog):
    with Profiler('stage'):
        pass
    with caplog.at_level(logging.DEBUG, logger='fastmot_tpu_torch.mot'):
        MOT.print_timing_info()
    text = caplog.text
    assert 'Timing Stats' in text
    for name in SPANS:
        assert f'{name} self time:' in text
