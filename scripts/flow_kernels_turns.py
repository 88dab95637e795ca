#!/usr/bin/env python3
"""The preprocess and gap-points kernels of one checkout on one NVIDIA GPU,
for comparing checkouts in turns inside one machine (A, B, B, A):

    python3 scripts/flow_kernels_turns.py [ROOT]

ROOT (default: this checkout) is the root of the checkout whose
``fastmot_tpu_torch`` and ``chip_smoke.py`` are used. The script builds
ROOT's ``csrc/flow_preprocess.cu`` and ``csrc/gap_points.cu`` and prints
ptxas's lines of each kernel, checks the card's outputs on the synthetic
calls of this checkout's tests/test_torch_flow_preprocess.py and
tests/test_torch_gap_points.py against their recorded sha256
(``OUTPUT_SHA256``: the first designs' outputs), and prints, for the
preprocess on 1 and 8 textured 1280x720 frames and for the point assembly
at 1 stream x flow budget 48 (40 tracks) and 8 x 128 (110 tracks a stream,
scripts/prof_gap_points.py's cases), the sha256 of the outputs, the device
time a call (CUDA events around 100 calls of the C entry queued behind a
sleep, as chip_smoke.py phase 18 times it), the wrapper's time a call and
its host time a call, with the card's name and power limit.
"""
import argparse
import hashlib
import importlib
import importlib.util
import re
import subprocess
import sys
from pathlib import Path

HERE = Path(__file__).resolve().parents[1]


def here_tests():
    """This checkout's two test modules, loaded as the package
    ``here_tests`` so that their imports of the port resolve to ROOT's."""
    spec = importlib.util.spec_from_file_location(
        'here_tests', HERE / 'tests' / '__init__.py',
        submodule_search_locations=[str(HERE / 'tests')])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules['here_tests'] = pkg
    spec.loader.exec_module(pkg)
    return (importlib.import_module('here_tests.test_torch_flow_preprocess'),
            importlib.import_module('here_tests.test_torch_gap_points'))


def sha256(tensors):
    h = hashlib.sha256()
    for t in tensors:
        h.update(t.contiguous().cpu().numpy().tobytes())
    return h.hexdigest()[:16]


def to(x, device):
    import torch
    if isinstance(x, torch.Tensor):
        return x.to(device)
    if isinstance(x, (list, tuple)):
        return type(x)(to(y, device) for y in x)
    return x


def main():
    parser = argparse.ArgumentParser(description=__doc__.split('\n')[0])
    parser.add_argument('root', nargs='?', default=str(HERE))
    root = Path(parser.parse_args().root).resolve()
    sys.path.insert(0, str(root))
    import numpy as np
    import torch
    import chip_smoke
    from fastmot_tpu_torch.ops import cuda_build
    from fastmot_tpu_torch.ops import flow_kernels as fk
    from fastmot_tpu_torch.ops import gap_points as gp
    if not torch.cuda.is_available():
        raise SystemExit('flow_kernels_turns: CUDA is not available')
    tp, tg = here_tests()
    sys.path.insert(1, str(HERE / 'scripts'))
    from prof_gap_points import case as points_case
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    tag = f'[{root.name}]'
    for name in ('flow_preprocess', 'gap_points'):
        _, seconds, out = cuda_build.build(name)
        print(f'{tag} {name} built in {seconds:.1f} s', flush=True)
        for line in out.splitlines():
            if re.search(r'Compiling entry|Used \d+ registers|spill', line):
                print(f'{tag} {name} ptxas: {line.strip()}')

    for name, mod, run in (
            ('preprocess', tp, lambda c: tp.flat_state(
                fk.preprocess(c[0], c[1].cuda()))),
            ('gap_points', tg, lambda c: gp.gap_points(*to(c, 'cuda')))):
        differ = [mod.hash_case_id(key) for key in mod.OUTPUT_SHA256
                  if mod.output_sha256(run(mod.hash_case(key)))
                  != mod.OUTPUT_SHA256[key]]
        print(f'{tag} {name} card outputs vs recorded sha256: '
              f'{len(mod.OUTPUT_SHA256) - len(differ)} of '
              f'{len(mod.OUTPUT_SHA256)} equal; differ: {differ}',
              flush=True)

    spec = fk.FlowSpec(size=chip_smoke.SIZE, opt_scale=(0.5, 0.5),
                       bg_scale=(0.1, 0.1))
    pre_lib, pts_lib = fk.preprocess_library(), gp.gap_points_library()
    for n_streams, n_tracks, f_cap in ((1, 40, 48), (8, 110, 128)):
        frames = torch.as_tensor(np.stack([
            chip_smoke.textured_frames(chip_smoke.SIZE, 1, seed=s)[0]
            for s in range(n_streams)]), device='cuda')
        args = points_case(n_streams, n_tracks, f_cap)
        for name, entry, launch_args, call in (
                ('preprocess', pre_lib.flow_preprocess_forward,
                 lambda: fk.preprocess_launch_args(spec, frames),
                 lambda: tp.flat_state(fk.preprocess(spec, frames))),
                ('gap_points', pts_lib.gap_points_forward,
                 lambda: gp.gap_points_launch_args(*args),
                 lambda: gp.gap_points(*args))):
            digest = sha256(call())
            # the outputs stay referenced while the launches write them
            outputs, launch = launch_args()
            device = [chip_smoke.lk_device_ms(entry, launch, tag=name) * 1e3
                      for _ in range(2)]
            wrapper = chip_smoke.launches_ms(call) * 1e3
            host = chip_smoke.host_ms(call) * 1e3
            print(f'{tag} {name} {n_streams} stream(s) (flow budget {f_cap}): '
                  f'outputs {digest}; device {device[0]:.2f} / '
                  f'{device[1]:.2f} us a call; the wrapper {wrapper:.2f} us '
                  f'a call, host {host:.2f} us; {card}', flush=True)


if __name__ == '__main__':
    main()
