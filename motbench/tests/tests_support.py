"""The tiny cell the CPU tests run: YOLOv4-tiny over two 320x192
streams (``data/``)."""
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parent
sys.path.insert(0, str(HERE.parents[1]))

DATA = HERE / 'data'


def tiny_bench(traffic='tiny'):
    return {
        'configs': [{'name': 'tiny', 'file': 'motbench/tests/data/tiny.json'}],
        'workloads': [{'name': 'tiny.cell', 'config': 'tiny',
                       'traffic': traffic, 'chips': 1}],
        'end_to_end': [{'name': 'fps', 'unit': 'frames/s'},
                       {'name': 'setup_s', 'unit': 's'}],
        'per_layer': []}


def tiny_run(seconds=0.0, seed=123456789012, traffic='tiny', **kwargs):
    from motbench.harness import Cell
    from motbench.measure import run_cell
    cell = Cell('tiny.cell', tiny_bench(traffic), root=DATA)
    return run_cell(cell, seed, seconds, 0, time.perf_counter(),
                    device='cpu', **kwargs)
