#!/usr/bin/env python3
"""The host's time a call of the YOLO postprocess's, the costs', the
commit's and the ReID input's wrappers (``ops.nms_waves.nms_select``,
``ops.assoc_costs.assoc_costs``, ``ops.assoc_commit.assoc_commit``,
``ops.reid_crops.reid_crops``) of this checkout and of other checkouts, in
one process and in turns, on one NVIDIA GPU:

    python3 scripts/wrapper_host_turns.py ROOT [ROOT ...] [--rounds N]

Each ROOT's ``fastmot_tpu_torch/ops`` is loaded as a package of its own
(its modules import each other relatively, and build their kernels from
ROOT's csrc/). The arguments are made from a seed at the main path's
shapes: 16,128 decoded rows (YOLOv4-512) of chip_smoke.py phase 21's
contested postprocess at 1 and 8 streams; tests/test_torch_assoc_costs.py's
'full_width' costs (T = D = 128, H = 64, F = 512) at one stream without the
stream axis (as ``tracker.assoc_costs_core`` passes it; skipped for a
checkout that does not take it), with a stream axis of one, and at 8
streams; tests/test_torch_assoc_commit.py's 'contested_full' commit (T =
D = 128, H = 64, F = 512) at one stream without the stream axis (as
``tracker.commit_core`` passes it) and at 8 streams; the ReID input of 64
and 8 x 128 boxes on drifting 1280x720 frames (float32, which every
checkout writes). Every checkout's outputs are first held equal to this
one's, bit for bit. A round times each checkout once
(``chip_smoke.host_ms``: 50 calls on the host clock with no sync inside,
the median of 11 windows), in the order reversed every other round; the
script prints each checkout's times in round order and their median, with
the card's name and power limit.
"""
import argparse
import importlib
import importlib.util
import statistics
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402


def load_ops(root, tag):
    """ROOT's ``fastmot_tpu_torch/ops`` as the package ``tag``: its
    (nms_waves, assoc_costs, assoc_commit, reid_crops) modules."""
    path = Path(root).resolve() / 'fastmot_tpu_torch' / 'ops'
    spec = importlib.util.spec_from_file_location(
        tag, path / '__init__.py', submodule_search_locations=[str(path)])
    pkg = importlib.util.module_from_spec(spec)
    sys.modules[tag] = pkg
    spec.loader.exec_module(pkg)
    return tuple(importlib.import_module(f'{tag}.{name}') for name in
                 ('nms_waves', 'assoc_costs', 'assoc_commit', 'reid_crops'))


def cases():
    """{case: (wrapper's module index, arguments)}: the postprocess's
    ``nms_select`` arguments, the costs' ``assoc_costs`` arguments (the
    metric by name, which every checkout's wrapper takes), the commit's and
    the crops'."""
    import tests.test_torch_assoc_costs as tcost
    import tests.test_torch_nms_select as tsel
    from fastmot_tpu_torch import detector as detmod
    rng = np.random.default_rng(21)
    scale = torch.tensor([1280.0, 720.0, 1280.0, 720.0], device='cuda')
    mask = torch.ones(3, dtype=torch.bool, device='cuda')
    out = {}
    for n in (1, smoke.N_STREAMS):
        rows = np.stack([tsel.clustered_rows(rng, 16128, 3, 120)
                         for _ in range(n)])
        det = torch.as_tensor(rows, device='cuda')
        out[f'nms_select, {n} stream(s)'] = (0, (
            det[0] if n == 1 else det, mask, 0.25, 0.5, 800000, 1.2, scale,
            torch.zeros(2, device='cuda'), detmod.MAX_RAW, detmod.MAX_DETS))
    kind = 'full_width'
    params = tcost.params(kind)
    params = params[:1] + (params[1].name,) + params[2:]
    emb_cap = tcost.CASES[kind].emb_cap
    for n in (1, smoke.N_STREAMS):
        states, hists, dets, embs = tcost.torch_case(tcost.costs_case(
            kind, tcost.CASE_SEEDS[kind], streams=n), 'cuda')
        out[f'assoc_costs, {n} stream(s)'] = (1, params + (
            states, hists, dets, embs, emb_cap))
        if n == 1:
            def one(xs):
                return tuple(a[0] for a in xs)
            out['assoc_costs, 1 stream without the axis'] = (1, params + (
                one(states), one(hists), one(dets), embs[0], emb_cap))
    commit1 = smoke.contested_commit_args(1)
    out['assoc_commit, 1 stream without the axis'] = (2, commit1[:4] + tuple(
        tuple(a[0] for a in x) if isinstance(x, tuple)
        else x[0] if isinstance(x, torch.Tensor) and k != 9 else x
        for k, x in enumerate(commit1[4:], 4)))
    out[f'assoc_commit, {smoke.N_STREAMS} streams'] = (
        2, smoke.contested_commit_args(smoke.N_STREAMS))
    import tests.test_torch_reid_crops as tcrop
    frames = torch.as_tensor(np.stack(smoke.textured_frames(
        smoke.SIZE, smoke.N_STREAMS, seed=13)), device='cuda')
    for n, k in ((1, 64), (smoke.N_STREAMS, 128)):
        boxes = torch.as_tensor(np.stack([tcrop.edge_boxes(
            rng, k, smoke.SIZE[1], smoke.SIZE[0]) for _ in range(n)]),
            device='cuda')
        out[f'reid_crops, {n} x {k} crops'] = (3, (
            frames[0], boxes[0], (256, 128)) if n == 1 else (
            frames, boxes, (256, 128)))
    return out


def flat(x):
    if isinstance(x, (tuple, list)):
        return [y for a in x for y in flat(a)]
    return [x]


def main():
    ap = argparse.ArgumentParser(description=__doc__.split('\n\n')[0])
    ap.add_argument('roots', nargs='+', help='checkouts to compare')
    ap.add_argument('--rounds', type=int, default=4)
    opts = ap.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('wrapper_host_turns: needs a CUDA device')
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    from fastmot_tpu_torch.ops import (assoc_commit, assoc_costs, nms_waves,
                                       reid_crops)
    checkouts = {'this': (nms_waves, assoc_costs, assoc_commit, reid_crops)}
    for i, root in enumerate(opts.roots):
        checkouts[f'{Path(root).name} ({root})'] = load_ops(root,
                                                           f'other_ops{i}')
    print(f'checkouts: {", ".join(checkouts)}; {card}', flush=True)
    for case, (which, args) in cases().items():
        wrapper = {tag: (m[0].nms_select, m[1].assoc_costs,
                         m[2].assoc_commit, m[3].reid_crops)[which]
                   for tag, m in checkouts.items()}
        want = flat(wrapper['this'](*args))
        fns = {}
        for tag, fn in wrapper.items():
            try:
                got = flat(fn(*args))
            except ValueError as e:
                print(f'{case}: {tag} does not take these arguments ({e})',
                      flush=True)
                continue
            if len(got) != len(want) or not all(
                    torch.equal(g, w) for g, w in zip(got, want)):
                raise AssertionError(f'{case}: {tag} differs from this '
                                     'checkout')
            fns[tag] = (lambda f=fn: f(*args))
        times = {tag: [] for tag in fns}
        for r in range(opts.rounds):
            for tag in (list(fns) if r % 2 == 0 else list(fns)[::-1]):
                times[tag].append(smoke.host_ms(fns[tag], n=50, reps=11))
        print(f'{case}: host us a call, ' + '; '.join(
            f'{tag} ' + ' / '.join(f'{t * 1e3:.2f}' for t in v)
            + f' (median {statistics.median(v) * 1e3:.2f})'
            for tag, v in times.items())
            + f' (outputs equal bit for bit); {card}', flush=True)


if __name__ == '__main__':
    main()
