#!/usr/bin/env python3
"""The gap-commit kernel of one checkout on one NVIDIA GPU, for comparing
checkouts in turns inside one machine (A, B, B, A):

    python3 scripts/gap_commit_turns.py [ROOT] [--pieces] [--steps]

ROOT (default: this checkout) is the root of the checkout whose
``fastmot_tpu_torch`` and ``chip_smoke.py`` are used. The script builds
ROOT's ``csrc/gap_commit.cu`` and prints ptxas's lines of each kernel,
checks the card's outputs on the synthetic calls of this checkout's
tests/test_torch_gap_commit.py against their recorded sha256
(``OUTPUT_SHA256``), and prints, on the camera case of that file with the
main path's 256 background points at 1 stream x flow budget 48 and 8
streams x 128: the device time a call (CUDA events around 100 calls of
the C entry queued behind a sleep, as chip_smoke.py phase 17 times it),
the wrapper's time a call and its host time a call, with the card's name
and power limit. ``--pieces``: the host time of the wrapper's torch
operations one by one; ``--steps``: the main path's step medians and a
gap frame's stages alone (chip_smoke.py phase 6).
"""
import argparse
import importlib.util
import re
import subprocess
import sys
import time
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def cuda_args(args):
    import torch
    return [tuple(x.cuda() for x in a) if isinstance(a, tuple) else
            a.cuda() if isinstance(a, torch.Tensor) else a for a in args]


def host_us(fn, n=200, reps=5):
    """Median over ``reps`` windows of the host time of ``n`` calls, us."""
    import torch
    times = []
    for _ in range(reps):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            fn()
        times.append((time.perf_counter() - t0) / n * 1e6)
    torch.cuda.synchronize()
    return sorted(times)[reps // 2]


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('root', nargs='?', default=str(HERE))
    parser.add_argument('--pieces', action='store_true')
    parser.add_argument('--steps', action='store_true')
    opts = parser.parse_args()
    root = Path(opts.root).resolve()
    sys.path.insert(0, str(root))
    import torch
    import chip_smoke
    from fastmot_tpu_torch.ops import cuda_build
    from fastmot_tpu_torch.ops import gap_commit as gc
    spec = importlib.util.spec_from_file_location(
        'gap_commit_tests', HERE / 'tests' / 'test_torch_gap_commit.py')
    tg = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(tg)
    if not torch.cuda.is_available():
        raise SystemExit('gap_commit_turns: CUDA is not available')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    tag = f'[{root.name}]'
    _, seconds, out = cuda_build.build('gap_commit')
    print(f'{tag} built in {seconds:.1f} s', flush=True)
    for line in out.splitlines():
        if re.search(r'Compiling entry|Used \d+ registers|spill', line):
            print(f'{tag} ptxas: {line.strip()}')
    lib = gc.gap_commit_library()

    differ = []
    for case in tg.OUTPUT_SHA256:
        new, info = gc.gap_commit(*cuda_args(tg.hash_case_args(case)))
        got = tg.output_sha256([new[i] for i in gc.STATE_OUT] + [info])
        if got != tg.OUTPUT_SHA256[case]:
            differ.append(tg.hash_case_id(case))
    print(f'{tag} card outputs vs recorded sha256: '
          f'{len(tg.OUTPUT_SHA256) - len(differ)} of '
          f'{len(tg.OUTPUT_SHA256)} equal; differ: {differ}', flush=True)

    for name, kinds, f_cap in (('1x48', ['camera'], 48),
                               ('8x128', ['camera'] * 8, 128)):
        args = cuda_args(tg.commit_args(kinds, f_cap, list(range(len(kinds))),
                                        n_bg=256))
        _, launch = gc.gap_commit_launch_args(*args)
        device = [chip_smoke.lk_device_ms(lib.gap_commit_forward, launch,
                                          tag='gap_commit') * 1e3
                  for _ in range(2)]
        call = chip_smoke.launches_ms(lambda: gc.gap_commit(*args)) * 1e3
        host = chip_smoke.host_ms(lambda: gc.gap_commit(*args)) * 1e3
        print(f'{tag} {name}: device {device[0]:.2f} / {device[1]:.2f} us '
              f'a call; the wrapper {call:.2f} us a call, host {host:.2f} '
              f'us; {card}', flush=True)

    if opts.pieces:
        args = cuda_args(tg.commit_args(['camera'], 48, [3], n_bg=256))
        _, launch = gc.gap_commit_launch_args(*args)
        states, dev = args[4], args[4][0].device
        inputs = tuple(states[i] for i in gc.STATE_IN) + tuple(args[5:12]) \
            + tuple(args[13:])
        buf = torch.empty(30000, device=dev)
        pieces = {
            'gap_commit (whole)': lambda: gc.gap_commit(*args),
            'gap_commit_launch_args': lambda: gc.gap_commit_launch_args(
                *args),
            'C entry alone': lambda: lib.gap_commit_forward(*launch),
            '(dtype, shape, device) x 20': lambda: [
                (x.dtype, x.shape, x.device) for x in inputs],
            'is_contiguous x 20': lambda: [x.is_contiguous()
                                           for x in inputs],
            'data_ptr x 20': lambda: [x.data_ptr() for x in inputs],
            'torch.empty on the card': lambda: torch.empty(
                30000, dtype=torch.float32, device=dev),
            'as_strided': lambda: buf.as_strided((1, 128, 8), (1024, 8, 1),
                                                 64),
            'as_strided x 9': lambda: [buf.as_strided(
                (1, 128, 8), (1024, 8, 1), 64) for _ in range(9)],
            'current_stream().cuda_stream': lambda: torch.cuda.current_stream(
                dev).cuda_stream,
        }
        for name, fn in pieces.items():
            print(f'{tag} host {name}: {host_us(fn):.2f} us', flush=True)

    if opts.steps:
        chip_smoke.phase_device()
        for name in ('osnet_block', 'lk_pyramidal'):
            cuda_build.build(name)
        run = chip_smoke.phase_main_path(stages=True)
        stages = {k: round(v, 3) if isinstance(v, float) else v
                  for k, v in run['gap stages'].items()}
        print(f'{tag} main path step median {run["median"]:.3f} ms; a gap '
              f'frame\'s stages alone, ms: {stages}; {card}', flush=True)


if __name__ == '__main__':
    main()
