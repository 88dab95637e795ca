"""The benchmark's command line: one run of one cell.

    python3 motbench/run.py --workload <name> --seed <n> --seconds <s>
        --trace <0|1> [--control int8]

Run from the root of a checkout on a machine with as many CUDA devices as
the cell asks for. Prints the overflow counters and each compared number
beside its limit on standard error, and as the last line of standard
output one JSON object: ``correct``, ``attempted``, ``failed``,
``metrics`` (the cell's end-to-end metrics, or with ``--trace 1`` its
per-layer ones), ``device``, with ``--trace 1`` ``breakdown``, and last
``checks``. ``--control int8`` runs the check's control (the program's
int8 networks, the tracker's reference state in bfloat16); it is not a
measurement. Exits with 2, printing no result, without the devices, and
with 3 when a module of JAX or of the JAX package is loaded.
"""
import time

T_START = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import os  # noqa: E402
import sys  # noqa: E402
from pathlib import Path  # noqa: E402

HERE = Path(__file__).resolve().parent
REPO = HERE.parent
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'fastmot_tpu')
KERNELS = ('osnet_block', 'lk_pyramidal', 'gap_commit', 'flow_preprocess',
           'gap_points', 'assoc_solvers', 'nms_waves', 'assoc_commit',
           'assoc_costs', 'reid_crops')


def forbidden_modules():
    """Loaded modules whose top-level name (before the first dot) is one
    of ``FORBIDDEN``, compared whole."""
    return sorted({m for m in sys.modules
                   if m.split('.', 1)[0] in FORBIDDEN})


def build_kernels():
    """The program's ten kernel libraries, built in parallel where not yet
    built (the build directory is inside the checkout)."""
    from concurrent.futures import ThreadPoolExecutor

    from fastmot_tpu_torch.ops import cuda_build
    with ThreadPoolExecutor(len(KERNELS)) as pool:
        list(pool.map(cuda_build.build, KERNELS))


def power_limit():
    import subprocess
    try:
        return subprocess.run(
            ['nvidia-smi', '--query-gpu=name,power.limit',
             '--format=csv,noheader'], capture_output=True, text=True,
            timeout=30).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        return 'nvidia-smi not readable'


def main(argv=None, t_start=T_START):
    p = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    p.add_argument('--workload', required=True)
    p.add_argument('--seed', type=int, required=True)
    p.add_argument('--seconds', type=float, required=True)
    p.add_argument('--trace', type=int, choices=(0, 1), default=0)
    p.add_argument('--control', choices=('int8',), default=None)
    args = p.parse_args(argv)

    # caches at fixed paths inside the checkout
    cache = HERE / '.cache'
    os.environ['TRITON_CACHE_DIR'] = str(cache / 'triton')
    os.environ['TORCH_EXTENSIONS_DIR'] = str(cache / 'torch_extensions')
    sys.path.insert(0, str(REPO))

    import torch

    from motbench.harness import Cell
    from motbench.measure import run_cell

    bench = json.loads((REPO / 'BENCHMARK.json').read_text())
    cell = Cell(args.workload, bench)
    if not torch.cuda.is_available() or \
            torch.cuda.device_count() < cell.chips:
        print(f'motbench: {args.workload} needs {cell.chips} CUDA '
              f'device(s); this machine has '
              f'{torch.cuda.device_count() if torch.cuda.is_available() else 0}',
              file=sys.stderr)
        return 2
    result, lines = run_cell(cell, args.seed, args.seconds, args.trace,
                             t_start, control=args.control,
                             build=build_kernels)
    bad = forbidden_modules()
    if bad:
        print(f'motbench: modules of JAX or the JAX package are loaded: '
              f'{bad}', file=sys.stderr)
        return 3
    print(f'card: {power_limit()}', file=sys.stderr)
    for line in lines:
        print(line, file=sys.stderr)
    sys.stderr.flush()
    print(json.dumps(result), flush=True)
    return 0


if __name__ == '__main__':
    sys.exit(main())
