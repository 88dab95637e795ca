"""The benchmark's driver of the program: a cell resolved by name, the
program built with the seed's weights and traffic, the spliced detector,
the benchmark's own spans, and the measured windows.

The timed path is ``fastmot_tpu_torch.parallel.MultiStreamMOT.step``: one
frame for each of S streams, host uint8 frames in, so the host-to-device
copy is part of it. The real detector runs (letterbox, net, decode,
``nms_select``) and its result is then replaced by the traffic's
detections, staged on the device. Results are read back as users read
recorded files: ``sync()`` and every stream's ``visible_tracks``, once a
skip cycle (an association frame and the gap frames after it), as
``app.py`` flushes a ``step_batch`` chunk.
"""
from __future__ import annotations

import json
import os
import time
from collections import defaultdict
from contextlib import nullcontext
from pathlib import Path

import numpy as np
import torch

from . import traffic as tr
from . import weights

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent


class Cell:
    """A workload of ``BENCHMARK.json``, with its configuration, traffic
    and metric entries, each found by its name."""

    def __init__(self, workload: str, bench: dict, root: Path = ROOT):
        cells = {w['name']: w for w in bench['workloads']}
        if workload not in cells:
            raise KeyError(f'no workload {workload!r} in BENCHMARK.json')
        w = cells[workload]
        self.name = workload
        self.chips = int(w['chips'])
        self.config_name, self.traffic_name = w['config'], w['traffic']
        configs = {c['name']: c for c in bench['configs']}
        self.config_file = REPO / configs[self.config_name]['file']
        self.config = json.loads(self.config_file.read_text())
        self.traffic = tr.Traffic.load(root / 'traffic' /
                                       f'{self.traffic_name}.json')

        def mine(m):
            return workload in m.get('workloads', [workload])
        self.end_to_end = [m for m in bench['end_to_end'] if mine(m)]
        self.per_layer = [m for m in bench['per_layer'] if mine(m)]

    @property
    def skip(self) -> int:
        return int(self.config['detector_frame_skip'])

    def darknet_sections(self):
        from .reference.detect import parse_cfg
        det = self.config['detector']
        return parse_cfg((self.config_file.parent / det['darknet_cfg'])
                         .read_text())


class Spans:
    """The benchmark's spans around the calls into each layer: host time
    by (span, step kind) while ``on``, and a ``record_function`` range
    for the profiler while ``profiling``."""

    def __init__(self):
        self.on = False
        self.profiling = False
        self.kind = 'gap'
        self.host = defaultdict(float)

    def wrap(self, name, fn):
        def call(*args, **kwargs):
            if not self.on:
                return fn(*args, **kwargs)
            ctx = nullcontext()
            if self.profiling:
                from torch.profiler import record_function
                ctx = record_function(f'motbench.{name}')
            t0 = time.perf_counter()
            with ctx:
                out = fn(*args, **kwargs)
            self.host[name, self.kind] += time.perf_counter() - t0
            return out
        return call


class Probe:
    """What the correctness check reads from the timed path: at the frames
    in ``assoc_frames`` the detector's heads, decoded rows and selected
    rows, the embeddings and the association's state before and after; at
    the frames in ``gap_frames`` the gap frame's state before and after.
    Everything is copied as it is made (device copies, small)."""

    def __init__(self):
        self.assoc_frames, self.gap_frames = set(), set()
        self.frame = -1
        self.assoc, self.gap = {}, {}

    def wants_assoc(self):
        return self.frame in self.assoc_frames

    def wants_gap(self):
        return self.frame in self.gap_frames


def _clone(ts):
    return tuple(t.clone() for t in ts)


class Program:
    """``MultiStreamMOT`` set up for a cell: weights from the seed, the
    detector spliced, spans and the probe around its layers."""

    def __init__(self, cell: Cell, seed: int, frames, device='cuda',
                 control=None):
        from fastmot_tpu_torch.models import yolo
        from fastmot_tpu_torch.parallel import MultiStreamMOT
        cfg, t = cell.config, cell.traffic
        self.cell, self.device = cell, torch.device(device)
        self.n_streams = t.streams
        self.mot = MultiStreamMOT(
            tuple(cfg['frame_size']), self.n_streams,
            detector_frame_skip=cell.skip,
            class_ids=tuple(cfg['class_ids']),
            yolo_detector_cfg=tuples(cfg['yolo_detector_cfg']),
            feature_extractor_cfgs=tuples(cfg['feature_extractor_cfgs']),
            tracker_cfg=tuples(cfg['tracker_cfg']), device=device)
        mot = self.mot
        det = mot.detector._single
        self.det_weights = weights.for_module(det.module, seed, 11, device)
        weights.calibrate_detector(cell, self.det_weights, frames[0])
        self.reid_weights = weights.for_module(mot.extractor.module, seed,
                                               13, device)
        _load(det.module, self.det_weights)
        _load(mot.extractor.module, self.reid_weights)
        if control == 'int8':
            self._int8()
        self.spans = Spans()
        self.probe = Probe()
        self._splice(cell, seed, yolo)
        sp = self.spans
        mot._stage_frames = sp.wrap('h2d', mot._stage_frames)
        mot.detector.detect_async = sp.wrap('detector',
                                            mot.detector.detect_async)
        mot.detector.postprocess_device_batch = sp.wrap(
            'detector', mot.detector.postprocess_device_batch)
        ext = mot.extractor
        ext.extract_async_batch = sp.wrap('reid', ext.extract_async_batch)
        ext.postprocess_device = sp.wrap('reid', self._probe_emb(
            ext.postprocess_device))
        st = mot.stream_tracker
        st.track = sp.wrap('flow', self._probe_track(st.track))
        st.update_device = sp.wrap('assoc',
                                   self._probe_assoc(st.update_device))
        self.readback = sp.wrap('readback', self.readback)

    def _int8(self):
        """The program's own int8 path, dynamic ranges (the control)."""
        from fastmot_tpu_torch.models.quantize import quantize_module
        cache = ROOT / '.cache' / 'int8_dynamic.json'
        cache.parent.mkdir(parents=True, exist_ok=True)
        cache.write_text(json.dumps({'outputs': {}, 'inputs': {'*': 0.0}}))
        det = self.mot.detector._single
        det.module = quantize_module(det.module, 'int8', str(cache))
        ext = self.mot.extractor
        ext.module = quantize_module(ext.module, 'int8', str(cache))

    def _splice(self, cell, seed, yolo):
        mot, t, probe = self.mot, cell.traffic, self.probe
        label = int(cell.config['class_ids'][0])
        self.dets = tr.make_detections(t, seed, cell.skip, label,
                                       self.device)
        n_sets = self.dets[0].shape[0]
        skip = cell.skip
        det = mot.detector
        real_dev, real_single = det.postprocess_device_batch, det._single

        def staged(frame):
            i = (frame // skip) % n_sets
            return tuple(d[i] for d in self.dets)

        def post_dev():
            real = real_dev()
            if probe.wants_assoc():
                probe.assoc.setdefault(probe.frame, {})['nms'] = _clone(real)
            return staged(mot.frame_count)

        def post():
            # frame 0 (set-up only): the host path of the first frame
            real_dev()
            tlbr, lab, conf, val = (d.cpu().numpy()
                                    for d in staged(mot.frame_count))
            from fastmot_tpu_torch.detector import make_detections
            return [make_detections(tlbr[s][val[s]].astype(float),
                                    lab[s][val[s]].astype(int),
                                    conf[s][val[s]].astype(float))
                    for s in range(len(tlbr))]
        det.postprocess_device_batch, det.postprocess = post_dev, post

        def heads_hook(module, args, out):
            if probe.wants_assoc():
                probe.assoc.setdefault(probe.frame, {})['heads'] = \
                    _clone(out)
        real_single.module.register_forward_hook(heads_hook)
        real_decode = yolo.decode_heads
        self._restore = lambda: setattr(yolo, 'decode_heads', real_decode)

        def decode(*args, **kwargs):
            out = real_decode(*args, **kwargs)
            if probe.wants_assoc():
                probe.assoc.setdefault(probe.frame, {})['decoded'] = \
                    out.clone()
            return out
        yolo.decode_heads = decode

    def _probe_emb(self, fn):
        probe = self.probe

        def call():
            out = fn()
            if probe.wants_assoc():
                probe.assoc.setdefault(probe.frame, {})['emb'] = out.clone()
            return out
        return call

    def _probe_track(self, fn):
        probe, st = self.probe, self.mot.stream_tracker

        def call(frames, *args, **kwargs):
            if not probe.wants_gap() or st._prev_pre is None:
                return fn(frames, *args, **kwargs)
            if st._dirty:
                st._stack_from_mirrors()
            rec = {'state': _clone(st._dev_state),
                   'seeds': list(st._seeds)}
            out = fn(frames, *args, **kwargs)
            rec['new_state'] = _clone(st._dev_state)
            probe.gap[probe.frame] = rec
            return out
        return call

    def _probe_assoc(self, fn):
        probe, st = self.probe, self.mot.stream_tracker

        def call(frame_id, det_batch, emb_batch):
            if not probe.wants_assoc():
                return fn(frame_id, det_batch, emb_batch)
            if st._dirty:
                st._stack_from_mirrors()
            rec = probe.assoc.setdefault(probe.frame, {})
            rec.update(state=_clone(st._dev_state),
                       hist=_clone(st._hist_store),
                       dets=_clone(det_batch), frame_id=int(frame_id))
            out = fn(frame_id, det_batch, emb_batch)
            rec.update(new_state=_clone(st._dev_state),
                       new_hist=_clone(st._hist_store))
            return out
        return call

    def step(self, frames):
        """One frame of every stream; the step kind goes to the spans."""
        mot = self.mot
        f = mot.frame_count
        self.probe.frame = f
        self.spans.kind = 'assoc' if f and f % mot.detector_frame_skip == 0 \
            else 'gap'
        mot.step(frames)

    def readback(self):
        """``sync`` and every stream's visible tracks, as (id, tlbr)."""
        self.mot.sync()
        return [[(t.trk_id, t.tlbr) for t in self.mot.visible_tracks(s)]
                for s in range(self.n_streams)]

    def close(self):
        """Puts back what the splice patched outside the program's
        objects."""
        self._restore()

    def overflow(self):
        """The tracker's fixed-capacity clip counts, summed over streams."""
        total = defaultdict(int)
        for trk in self.mot.trackers:
            for k, v in trk.overflow.items():
                total[k] += v
        return dict(total)


def tuples(x):
    """A configuration section with every JSON array as a tuple, as the
    program's own config decoder reads its files."""
    if isinstance(x, dict):
        return {k: tuples(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return tuple(tuples(v) for v in x)
    return x


def _load(module, sd):
    missing, unexpected = module.load_state_dict(sd, strict=False)
    floats = {k for k, v in module.state_dict().items()
              if v.is_floating_point()}
    if unexpected or floats & set(missing):
        raise RuntimeError(f'weights do not cover the module: missing '
                           f'{sorted(floats & set(missing))[:3]}, '
                           f'unexpected {unexpected[:3]}')


def sync(device):
    if torch.device(device).type == 'cuda':
        torch.cuda.synchronize()


def warm_up(prog: Program, frames: np.ndarray, cycles: int):
    """``cycles`` skip cycles from frame 0 (the tracker's init), read
    back as the cell reads them: every kernel and shape the window uses
    runs before it, and the window starts at an association frame."""
    for _ in range(cycles * prog.cell.skip):
        prog.step(frames[prog.mot.frame_count % len(frames)])
        prog.readback()
    sync(prog.device)


class HostReading:
    """The host around the measured window, printed beside the result so
    that a run's share of the spread that the host causes can be told
    apart: the CPUs the process may use, and the main thread's CPU time
    and context switches over the window."""

    def __init__(self):
        import resource
        self._rusage = lambda: resource.getrusage(resource.RUSAGE_THREAD)
        self.t0, self.r0 = time.perf_counter(), self._rusage()

    def line(self):
        r1, r0 = self._rusage(), self.r0
        cpu = (r1.ru_utime + r1.ru_stime) - (r0.ru_utime + r0.ru_stime)
        return (f'host: {len(os.sched_getaffinity(0))} CPUs; main thread '
                f'over the window {cpu:.3f} s CPU of '
                f'{time.perf_counter() - self.t0:.3f} s, '
                f'{r1.ru_nvcsw - r0.ru_nvcsw} voluntary and '
                f'{r1.ru_nivcsw - r0.ru_nivcsw} involuntary switches')


def closed_window(prog: Program, frames, seconds, per_step_sync=False,
                  on_cycle=None):
    """Steps as fast as the program takes them, read back once a skip
    cycle (an association frame, then its gap frames), for about
    ``seconds``: the cycle that would end past them, by
    the mean cycle so far, is the last. ``on_cycle(first frame, elapsed
    s, last)`` is called as each cycle starts. Returns the window's
    length, the frames read back and the steps' synchronised times by
    kind (with ``per_step_sync``)."""
    skip, n = prog.cell.skip, len(frames)
    steps = defaultdict(list)
    read = cycles = 0
    sync(prog.device)
    t0 = time.perf_counter()
    last = False
    while not last:
        elapsed = time.perf_counter() - t0
        last = elapsed + (elapsed / cycles if cycles else 0.0) >= seconds
        if on_cycle is not None:
            on_cycle(prog.mot.frame_count, elapsed, last)
        for _ in range(skip):
            ts = time.perf_counter()
            prog.step(frames[prog.mot.frame_count % n])
            if per_step_sync:
                sync(prog.device)
                steps[prog.spans.kind].append(time.perf_counter() - ts)
        prog.readback()
        read += skip * prog.n_streams
        cycles += 1
    return time.perf_counter() - t0, read, steps
