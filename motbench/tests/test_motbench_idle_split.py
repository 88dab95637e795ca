"""The device's idle time charged to the program's spans, on synthetic
Kineto events: a kernel, a gap while the host reads back and stages the
next frame, a kernel."""
from types import SimpleNamespace

import pytest

from motbench import idle_split as isp
from motbench.measure import reader
from motbench.trace import Trace

MS = 1e3        # the trace's microseconds in a millisecond


def annotation(name, a, b):
    return {'cat': 'user_annotation', 'name': name, 'ts': a * MS,
            'dur': (b - a) * MS}


def kernel(name, a, b, corr):
    return {'cat': 'kernel', 'name': name, 'ts': a * MS, 'dur': (b - a) * MS,
            'args': {'correlation': corr}}


def launch(t, corr):
    return {'cat': 'cuda_runtime', 'name': 'cudaLaunchKernel', 'ts': t * MS,
            'dur': 1.0, 'args': {'correlation': corr}}


# times in ms; the window is [0, 11], the device idle over (1, 10)
BENCH_EVENTS = [
    annotation('motbench.flow', 0.0, 0.9), launch(0.0, 1),
    kernel('lk_kernel', 0.0, 1.0, 1),
    annotation('motbench.readback', 1.2, 6.2),
    annotation('motbench.h2d', 6.4, 8.2), launch(9.8, 2),
    kernel('preprocess_kernel', 10.0, 11.0, 2),
]
PROGRAM_EVENTS = [
    annotation('fastmot.step', 0.0, 0.95),
    annotation('fastmot.flow', 0.05, 0.9),
    annotation('fastmot.sync', 2.0, 6.0),
    annotation('fastmot.sync.fetch', 2.0, 3.0),
    annotation('fastmot.sync.replay', 3.0, 6.0),
    annotation('fastmot.step', 6.5, 9.9),
    annotation('fastmot.stage', 7.0, 8.0),
    annotation('fastmot.flow', 8.5, 9.9),
]
LO, HI = 0.0, 11e-3


def _charged(events):
    tr = Trace(events)
    kernels = [(a, b) for _, a, b, _ in tr.kernels]
    return isp.charge_idle(kernels, isp.program_spans(events), LO, HI)


def test_a_gap_is_split_across_the_spans_it_ran_through():
    got = _charged(BENCH_EVENTS + PROGRAM_EVENTS)
    want = {'sync.fetch': 1.0, 'sync.replay': 3.0, 'stage': 1.0,
            'flow': 1.4, 'step': 1.0, None: 1.6}
    assert set(got) == set(want)
    for name, ms in want.items():
        assert got[name] == pytest.approx(ms * 1e-3, abs=1e-12), name


def test_the_parts_sum_to_the_idle_share():
    events = BENCH_EVENTS + PROGRAM_EVENTS
    parts = isp.split(_charged(events), LO, HI)
    prof = SimpleNamespace(trace=Trace(events), bounds=(LO, HI))
    idle = reader('device.idle_share')(SimpleNamespace(prof=prof))
    assert idle == pytest.approx(9 / 11 * 100)
    assert sum(parts.values()) == pytest.approx(idle, abs=1e-9)
    assert parts['device.idle_sync'] == pytest.approx(4 / 11 * 100)
    assert parts['device.idle_outside_program'] == \
        pytest.approx(1.6 / 11 * 100)
    assert parts['remainder'] == pytest.approx(1.0 / 11 * 100)


def test_without_program_spans_all_idle_is_outside_them():
    """A program whose tracer was off (or that has none) opens no
    ``fastmot.*`` range: every idle instant is outside the program."""
    parts = isp.split(_charged(BENCH_EVENTS), LO, HI)
    assert parts['device.idle_outside_program'] == \
        pytest.approx(9 / 11 * 100)
    assert sum(v for k, v in parts.items()
               if k != 'device.idle_outside_program') == 0


@pytest.mark.parametrize('name', ['detector.device_ms', 'detector.launches',
                                  'reid.device_ms', 'device.idle_share',
                                  'mfu', 'device_ms_per_frame'])
def test_the_trace_readers_ignore_program_spans(name):
    """The benchmark's readers, its kernel ties and its breakdown read the
    same with the program's ranges in the trace as without them."""
    plain, both = Trace(BENCH_EVENTS), Trace(BENCH_EVENTS + PROGRAM_EVENTS)
    assert plain.spans == both.spans and plain.kernels == both.kernels
    assert plain.breakdown(LO, HI) == both.breakdown(LO, HI)
    info = {'n_assoc': 1, 'n_gap': 1, 'crops': 4}

    def ctx(tr):
        return SimpleNamespace(
            prof=SimpleNamespace(trace=tr, bounds=(LO, HI), info=info),
            streams=2, det_macs=10, osnet_macs=5)
    assert reader(name)(ctx(plain)) == reader(name)(ctx(both))


def test_innermost_names_each_piece_by_the_deepest_open_span():
    spans = [(0, 10, 'a'), (2, 8, 'b'), (3, 4, 'c'), (5, 6, 'd')]
    assert isp.innermost(spans) == [
        (0, 2, 'a'), (2, 3, 'b'), (3, 4, 'c'), (4, 5, 'b'), (5, 6, 'd'),
        (6, 8, 'b'), (8, 10, 'a')]
