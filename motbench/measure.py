"""One run of a cell: set-up, the measured window, the profiled cycles
after it (with ``trace``, or where an end-to-end metric is read from the
device's trace), the metrics by their readers, and the correctness check.

``run_cell`` returns the result's object and the lines to print on
standard error; ``run.py`` is the command line around it. The tests call
it on the CPU at small sizes, with ``fault`` breaking the timed path.
"""
from __future__ import annotations

import importlib.util
import random
import statistics
import time
from types import SimpleNamespace

import torch

from . import arith
from . import check as chk
from . import harness as hs
from . import traffic as tr

TRACE_CYCLES = 4           # skip cycles under the profiler
WARM_CYCLES = 3            # skip cycles of warm-up, frame 0's included
PROBE_BEFORE = 0.9         # the drawn probes start before this share


def reader(name: str):
    """``metrics/<name>.py``'s ``read``."""
    path = hs.ROOT / 'metrics' / f'{name}.py'
    spec = importlib.util.spec_from_file_location(
        f'motbench_metric_{name.replace(".", "_")}', path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod.read


class ProbePlan:
    """The frames the check reads, drawn from the seed across the whole
    window: the association frame and one gap frame of the first cycle to
    start after a drawn share of the window (each its own share, under
    ``PROBE_BEFORE``), and the same two of the window's last cycle. A
    cycle's frames are ``first`` .. ``first + skip - 1``, the first its
    association frame. ``arm`` is the window's ``on_cycle``: it hands the
    probe its frames as their cycles start."""

    def __init__(self, seed: int, skip: int, seconds: float, probe):
        rng = random.Random(int(seed))
        self.skip, self.probe = skip, probe
        self.assoc_at = rng.uniform(0, PROBE_BEFORE) * seconds
        self.gap_at = rng.uniform(0, PROBE_BEFORE) * seconds
        self.gap_offsets = [rng.randrange(1, skip) if skip > 1 else 0
                            for _ in range(2)]

    def arm(self, first: int, elapsed: float, last: bool):
        if self.assoc_at is not None and (elapsed >= self.assoc_at or last):
            self.probe.assoc_frames.add(first)
            self.assoc_at = None
        if self.gap_at is not None and (elapsed >= self.gap_at or last) \
                and self.skip > 1:
            self.probe.gap_frames.add(first + self.gap_offsets[0])
            self.gap_at = None
        if last:
            self.probe.assoc_frames.add(first)
            if self.skip > 1:
                self.probe.gap_frames.add(first + self.gap_offsets[1])


def _profiled_cycles(prog, frames):
    """``TRACE_CYCLES`` cycles as the cell runs them, spans recorded for
    the profiler; returns the counts the device metrics divide by."""
    skip = prog.cell.skip
    n_assoc = crops = 0
    for k in range(TRACE_CYCLES * skip):
        f = prog.mot.frame_count
        if f % skip == 0:
            n_assoc += 1
            i = (f // skip) % prog.dets[3].shape[0]
            crops += int(prog.dets[3][i].sum())
        prog.step(frames[f % len(frames)])
        if (k + 1) % skip == 0:
            prog.readback()
    return dict(n_assoc=n_assoc, n_gap=TRACE_CYCLES * skip - n_assoc,
                crops=crops)


def run_cell(cell, seed, seconds, trace, t_start, device='cuda',
             control=None, fault=None, build=None):
    """Runs the cell; returns (result dict, stderr lines).
    ``t_start``: the process's start on ``time.perf_counter``'s clock;
    ``fault(prog)`` (tests) breaks the program before the window;
    ``build()`` builds the program's kernels before anything else."""
    if build is not None:
        build()
    t = cell.traffic
    frames = tr.make_frames(t, seed, device)
    prog = hs.Program(cell, seed, frames, device, control)
    hs.warm_up(prog, frames, WARM_CYCLES)
    if fault is not None:
        fault(prog)
    plan = ProbePlan(seed, cell.skip, seconds, prog.probe)
    setup_s = time.perf_counter() - t_start
    cuda = torch.device(device).type == 'cuda'

    prog.spans.on = bool(trace)
    host = hs.HostReading()
    elapsed, read, steps = hs.closed_window(
        prog, frames, seconds, per_step_sync=bool(trace), on_cycle=plan.arm)
    win = dict(elapsed=elapsed, read=read, steps=steps)
    lines = [host.line()]
    prof = None
    # profiled cycles after the window: in the traced run, and in any run
    # of a cell with an end-to-end metric read from the device's trace
    device_e2e = any(m.get('source') == 'device_trace'
                     for m in cell.end_to_end)
    if cuda and (trace or device_e2e):
        from . import trace as trc
        host_spans = dict(prog.spans.host)
        prog.spans.profiling = True
        tr_, info, bounds, complete, deltas = trc.profiled(
            lambda: _profiled_cycles(prog, frames))
        prog.spans.profiling = False
        lines.append(f'trace: {len(tr_.kernels)} kernels, '
                     f'{tr_.tied} tied to a launch; launch counters '
                     f'{deltas}, trace counts '
                     f'{ {k: tr_.count(k) for k in deltas} }; complete '
                     f'{complete}')
        prof = SimpleNamespace(trace=tr_ if complete else None, info=info,
                               bounds=bounds, complete=complete)
    else:
        host_spans = dict(prog.spans.host)
    prog.spans.on = False
    peak = torch.cuda.max_memory_allocated() if cuda else 0
    overflow = prog.overflow()
    lines.append(f'overflow (fixed-capacity clips, all streams): '
                 f'{overflow or {}}')

    ctx = SimpleNamespace(
        cell=cell, traffic=t, streams=t.streams, skip=cell.skip,
        setup_s=setup_s, window=win, host_spans=host_spans,
        prof=prof, det_macs=arith.detector_macs(
            cell.darknet_sections(), cell.config['detector']['input_hw']),
        osnet_macs=arith.osnet_macs(
            cell.config['reid']['channels'],
            cell.config['reid']['feature_dim'],
            cell.config['reid']['input_hw']),
        osblock_shapes=arith.osnet_block_shapes(
            cell.config['reid']['channels'],
            cell.config['reid']['input_hw']))
    entries = cell.per_layer if trace else cell.end_to_end
    metrics = {}
    for m in entries:
        value = reader(m['name'])(ctx)
        if value is not None:
            metrics[m['name']] = {'value': value, 'unit': m['unit']}

    # the check: the program's state freed, the reference in its place
    det_w = {k: v.cpu() for k, v in prog.det_weights.items()}
    reid_w = {k: v.cpu() for k, v in prog.reid_weights.items()}
    probe = chk.to_cpu(SimpleNamespace(assoc=prog.probe.assoc,
                                       gap=prog.probe.gap).__dict__)
    want_a, want_g = prog.probe.assoc_frames, prog.probe.gap_frames
    lines.append('probed: ' + '; '.join(
        f'frame {f}: {int(r["nms"][3].sum())} rows kept by the detector, '
        f'{int(r["state"][3].sum())} live tracks'
        for f, r in sorted(probe['assoc'].items()) if 'nms' in r))
    prog.close()
    del prog
    if cuda:
        torch.cuda.empty_cache()
        torch.backends.cuda.matmul.allow_tf32 = False
        torch.backends.cudnn.allow_tf32 = False
    checker = chk.Checker(cell, det_w, reid_w, device)
    numbers = chk.run_checks(checker, SimpleNamespace(**probe),
                             lambda f: frames[f % len(frames)],
                             control=control is not None)
    missing = sorted(want_a - set(probe['assoc'])) + \
        sorted(want_g - set(probe['gap']))
    limits = cell.config['limits']
    checks = {k: {'value': numbers.get(k, float('nan')), 'limit': lim}
              for k, lim in limits.items()}
    correct = not missing and all(
        c['value'] <= c['limit'] for c in checks.values())
    if missing:
        lines.append(f'check: probed frames never ran: {missing}')
    for k in sorted(set(numbers) - set(limits)):
        lines.append(f'reading {k}: {numbers[k]!r}')
    for k, c in checks.items():
        lines.append(f'check {k}: {c["value"]!r} limit {c["limit"]!r}')

    attempted = win['read']
    traced = prof if trace else None
    result = {'correct': bool(correct), 'attempted': attempted,
              'failed': 0, 'metrics': metrics,
              'device': device_info(cuda, peak, traced)}
    if traced is not None and traced.complete:
        result['breakdown'] = prof.trace.breakdown(*prof.bounds)
    result['checks'] = checks
    return result, lines


def device_info(cuda, peak, prof):
    if not cuda:
        return {'platform': 'cpu', 'kind': 'cpu', 'count': 0,
                'memory_peak_bytes': 0}
    out = {'platform': 'gpu', 'kind': torch.cuda.get_device_name(0),
           'count': 1, 'memory_peak_bytes': int(peak)}
    if prof is not None and prof.complete:
        lo, hi = prof.bounds
        out['busy_s'] = prof.trace.busy_s()
        out['window_s'] = hi - lo
    return out


def mean_ms(values):
    return statistics.fmean(values) * 1e3 if values else None
