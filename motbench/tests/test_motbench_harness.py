"""The harness finds a cell's files by name, and loads nothing of JAX or
of the JAX package."""
import json
import subprocess
import sys
from pathlib import Path

import pytest

from motbench import harness as hs
from motbench import run

REPO = Path(__file__).resolve().parents[2]
BENCH = json.loads((REPO / 'BENCHMARK.json').read_text())


@pytest.mark.parametrize('workload', [w['name'] for w in BENCH['workloads']])
def test_cell_files_by_name(workload):
    cell = hs.Cell(workload, BENCH)
    assert cell.config['name'] == cell.config_name
    assert cell.traffic.streams >= 1
    assert cell.end_to_end and cell.per_layer
    names = {m['name'] for m in cell.end_to_end}
    assert 'setup_s' in names and len(names) >= 2
    for m in cell.end_to_end + cell.per_layer:
        assert (hs.ROOT / 'metrics' / f'{m["name"]}.py').is_file()
    sections = cell.darknet_sections()
    assert sum(s['type'] == 'yolo' for s in sections) == \
        len(cell.config['detector']['anchors'])
    assert set(cell.config['limits']) >= {
        'det_heads_rel', 'reid_crops_off', 'assoc_mean_px', 'gap_mean_px'}


def test_every_metric_has_a_reader():
    from motbench.measure import reader
    for m in BENCH['end_to_end'] + BENCH['per_layer']:
        assert callable(reader(m['name']))


def test_moves_names_a_metric_each_listed_cell_reports():
    for m in BENCH['per_layer']:
        for w in m['workloads']:
            cell = hs.Cell(w, BENCH)
            assert m['moves'] in {e['name'] for e in cell.end_to_end}


def test_device_ms_per_frame_is_busy_time_over_frames():
    from types import SimpleNamespace

    from motbench.measure import reader
    read = reader('device_ms_per_frame')
    prof = SimpleNamespace(trace=SimpleNamespace(busy_s=lambda: 0.048),
                           info={'n_assoc': 1, 'n_gap': 4})
    assert read(SimpleNamespace(prof=prof, streams=8)) == \
        pytest.approx(1.2)
    assert read(SimpleNamespace(prof=None, streams=8)) is None


def test_unknown_workload():
    with pytest.raises(KeyError):
        hs.Cell('no_such.cell', BENCH)


@pytest.mark.parametrize('mods, bad', [
    (['fastmot_tpu_torch', 'fastmot_tpu_torch.ops', 'jaxtyping'], []),
    (['fastmot_tpu.tracker', 'torch'], ['fastmot_tpu.tracker']),
    (['jax', 'jax.numpy', 'jaxlib.xla', 'flax.linen', 'numpy'],
     ['flax.linen', 'jax', 'jax.numpy', 'jaxlib.xla']),
])
def test_forbidden_names_compare_whole(monkeypatch, mods, bad):
    fake = {m: object() for m in mods}
    monkeypatch.setattr(sys, 'modules', fake)
    assert run.forbidden_modules() == bad


def test_a_run_loads_no_jax():
    """A CPU run of the tiny cell in a fresh process loads no module whose
    top-level name is jax, jaxlib, flax or fastmot_tpu."""
    code = (
        'import sys, time; sys.path.insert(0, %r)\n'
        'from tests_support import tiny_run\n'
        'tiny_run(seconds=0.0)\n'
        'from motbench.run import forbidden_modules\n'
        'print("FORBIDDEN", forbidden_modules())\n'
        'print("PORT", "fastmot_tpu_torch" in sys.modules)\n'
        % str(Path(__file__).resolve().parent))
    out = subprocess.run([sys.executable, '-c', code], cwd=REPO,
                         capture_output=True, text=True, timeout=600)
    assert out.returncode == 0, out.stderr[-3000:]
    assert 'FORBIDDEN []' in out.stdout and 'PORT True' in out.stdout


def test_no_card_no_result(capsys):
    """Without the devices the cell asks for: exit code 2, no result."""
    import torch
    if torch.cuda.is_available():
        pytest.skip('a CUDA device is present')
    rc = run.main(['--workload', BENCH['workloads'][0]['name'],
                   '--seed', '1', '--seconds', '1', '--trace', '0'])
    out = capsys.readouterr()
    assert rc == 2 and out.out == ''


@pytest.mark.cuda
def test_a_cell_on_the_card(card):
    """The first cell, briefly, on the card: a result line, correct."""
    out = subprocess.run(
        [sys.executable, 'motbench/run.py', '--workload',
         BENCH['workloads'][0]['name'], '--seed', '2147483659',
         '--seconds', '2', '--trace', '0'], cwd=REPO, capture_output=True,
        text=True, timeout=900)
    assert out.returncode == 0, out.stderr[-3000:]
    result = json.loads(out.stdout.strip().splitlines()[-1])
    assert result['correct'], out.stderr[-3000:]
    assert result['device']['platform'] == 'gpu'


def _armed(seed, cycles, seconds=20.0, skip=5):
    from types import SimpleNamespace

    from motbench.measure import ProbePlan
    probe = SimpleNamespace(assoc_frames=set(), gap_frames=set())
    plan = ProbePlan(seed, skip, seconds, probe)
    for c in range(cycles):
        plan.arm(15 + skip * c, seconds * c / cycles, c == cycles - 1)
    return probe


@pytest.mark.parametrize('seed', [1, 2 ** 31 + 11, 987654321987])
def test_probes_reach_the_last_cycle(seed):
    """Every run probes the window's last cycle, and one association
    frame and one gap frame drawn from the seed."""
    probe = _armed(seed, 200)
    last = 15 + 5 * 199
    assert last in probe.assoc_frames and 1 <= len(probe.assoc_frames) <= 2
    assert all(f % 5 == 0 for f in probe.assoc_frames)
    assert any(last < f < last + 5 for f in probe.gap_frames)
    assert all(f % 5 for f in probe.gap_frames)
    assert probe == _armed(seed, 200)


def test_drawn_probes_span_the_window():
    """Over seeds, the drawn association frames fall early and late."""
    drawn = [min(_armed(s, 200).assoc_frames) for s in range(40)]
    assert min(drawn) < 15 + 5 * 40 and max(drawn) > 15 + 5 * 140
