#!/usr/bin/env python3
"""Times the port's OSBlock kernel (fastmot_tpu_torch/csrc/osnet_block.cu)
under every launch plan it can take at the six OSNet-x0.25 block shapes,
on one NVIDIA GPU:

    python3 scripts/prof_osblock_torch.py [--batch 64] [--phases | --agreement]

For each shape and each cluster size whose bands fit, with the weights in
shared memory (where they fit) and from device memory, it prints the
kernel's time (median of 5 windows of 20 back-to-back launches between two
CUDA events, per launch) and marks the plan ``launch_plan`` picks. Every
plan's output is held against the plain version with chip_smoke.py's
bounds (another cluster size adds the pool's band sums in another order).

With ``--phases`` it builds a copy of the kernel that records ``clock64``
in thread 0 of the first CTA at each phase boundary (into
``fastmot_tpu_torch/csrc/build/``), runs each shape once with the chosen
plan, and prints the SM cycles each phase took.

With ``--agreement`` it prints, for every case tests/test_torch_cuda.py
checks, the kernel's max-rel and mean-rel error against the plain version
and the share of outputs that differ from it.
"""
import argparse
import ctypes
import subprocess
import sys
import time
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(ROOT))

import chip_smoke  # noqa: E402
from fastmot_tpu_torch.ops import osnet_block as ob  # noqa: E402


def plans(batch, h, w, cin, features, limit):
    mid, hid = ob.block_dims(features)
    counts = ob.weight_counts(cin, features)
    for c in (1, 2, 4, 8):
        pix = h // c * w
        if h % c or pix % 16:
            continue
        for staged in (True, False):
            smem = ob.smem_bytes(pix, mid, hid, *(counts if staged
                                                  else (0, 0)))
            if smem <= limit:
                yield ob.LaunchPlan(batch, c, h // c, staged, smem)


def graph_launches_ms(fn, n=20, reps=5):
    """``launches_ms`` with the ``n`` calls captured in one CUDA graph:
    the device's time alone, without the host's launch work."""
    graph = torch.cuda.CUDAGraph()
    stream = torch.cuda.Stream()
    stream.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(stream):
        fn()                                  # warm-up outside the capture
        with torch.cuda.graph(graph, stream=stream):
            for _ in range(n):
                fn()
    torch.cuda.current_stream().wait_stream(stream)
    return chip_smoke.launches_ms(graph.replay, n=1, reps=reps) / n


def host_us(fn, n=200):
    """Host time of one call of ``fn`` (enqueue only), in microseconds."""
    fn()
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(n):
        fn()
    t1 = time.perf_counter()
    torch.cuda.synchronize()
    return (t1 - t0) / n * 1e6


# (text in csrc/osnet_block.cu, phase that ends there): the stamp goes
# where the text has '@', at the start of a line
PHASE_MARKS = [
    ('@  // the weights, copied once', 'launch'),
    ('@  // conv1 1x1 + folded BN', 'weights to shared memory'),
    ('@  // four streams of 1..4 LiteConvs', 'conv1'),
    ('                      mtiles);\n@      cluster.sync();', 'LiteConv 1x1'),
    ('      cluster.sync();                 // za complete in every band\n@',
     'cluster barrier (za)'),
    ('      __syncthreads();\n@      src = zb;\n', 'depthwise + BN'),
    ('@    cluster.sync();                   // every band', 'pool partials'),
    ('    cluster.sync();                   // every band\'s sum is '
     'published\n@', 'cluster barrier (pool)'),
    ('@    // gated sum in stream order', 'gate'),
    ('    __syncthreads();\n@  }\n\n  // conv3 1x1', 'gated sum'),
    ('@  cluster.sync();   // no CTA leaves', 'conv3 + residual + store'),
    ('  cluster.sync();   // no CTA leaves while a neighbour may read its '
     'planes\n@', 'exit barrier'),
]


def phase_library():
    """Builds the kernel with a clock64 stamp at each of PHASE_MARKS."""
    from fastmot_tpu_torch.ops import cuda_build
    src = (cuda_build.CSRC / 'osnet_block.cu').read_text()
    stamp = ('if (blockIdx.x == 0 && threadIdx.x == 0) '
             'g_stamps[g_n++] = clock64();\n')
    for mark, _ in PHASE_MARKS:
        text = mark.replace('@', '')
        if src.count(text) != 1:
            raise RuntimeError(f'phase mark not found once: {text!r}')
        src = src.replace(text, mark.replace('@', stamp))
    src = src.replace('namespace {', '__device__ long long g_stamps[512];\n'
                      '__device__ int g_n;\nnamespace {', 1)
    src += ('extern "C" int osblock_stamps(long long* out, int reset) {\n'
            '  int n = 0;\n'
            '  if (reset) return (int)cudaMemcpyToSymbol(g_n, &n, sizeof n);\n'
            '  cudaMemcpyFromSymbol(&n, g_n, sizeof n);\n'
            '  cudaMemcpyFromSymbol(out, g_stamps, sizeof(long long) * n);\n'
            '  return n;\n}\n')
    cuda_build.BUILD_DIR.mkdir(parents=True, exist_ok=True)
    path = cuda_build.BUILD_DIR / 'osnet_block_phases.cu'
    path.write_text(src)
    lib = cuda_build.BUILD_DIR / 'osnet_block_phases.so'
    subprocess.run([cuda_build.find_nvcc(), *cuda_build.NVCC_FLAGS, '-o',
                    str(lib), str(path)], check=True)
    return ctypes.CDLL(str(lib))


def phases(batch):
    from fastmot_tpu_torch.ops import cuda_build
    lib = phase_library()
    lib.osblock_stamps.argtypes = [ctypes.c_void_p, ctypes.c_int]
    lib.osblock_stamps.restype = ctypes.c_int
    cuda_build.load = lambda name: lib
    ob._lib.cache_clear()
    gen = torch.Generator().manual_seed(0)
    order = [label for _, label in PHASE_MARKS]
    for cin, f, h, w in chip_smoke.BLOCK_SHAPES:
        flat, packed = chip_smoke._random_block(cin, f, gen)
        x = torch.randn(batch, h, w, cin, generator=gen) \
            .to('cuda', torch.bfloat16)
        ob.osblock(x, flat, cin, f, packed)
        torch.cuda.synchronize()
        lib.osblock_stamps(None, 1)
        ob.osblock(x, flat, cin, f, packed)
        torch.cuda.synchronize()
        stamps = (ctypes.c_longlong * 512)()
        n = lib.osblock_stamps(stamps, 0)
        # the stamps follow the kernel's order: launch, weights, conv1,
        # ten LiteConvs of three stamps with a gate of four after each
        # stream's last, conv3, exit
        labels = order[:3]
        for s in range(4):
            labels += order[3:6] * (s + 1) + order[6:10]
        labels += order[10:]
        if n != len(labels):
            raise AssertionError(f'{n} stamps, expected {len(labels)}')
        sums = {}
        for label, a, b in zip(labels[1:], stamps[:n - 1], stamps[1:n]):
            sums[label] = sums.get(label, 0) + (b - a)
        total = stamps[n - 1] - stamps[0]
        print(f'B={batch} {h}x{w} {cin}->{f}: {total} cycles from the '
              'first stamp to the last; ' + ', '.join(
                  f'{k} {v} ({v / total:.1%})' for k, v in sums.items()),
              flush=True)


def agreement():
    sys.path.insert(0, str(ROOT / 'tests'))
    import test_torch_cuda as t
    device = torch.device('cuda')
    cases = [(b,) + s for b in (1, 3, 64, 128) for s in t.OSNET025_BLOCKS]
    cases += [(8,) + s for s in t.OSNET10_BLOCKS]
    for batch, cin, f, h, w in cases:
        gen = torch.Generator().manual_seed(cin * f)
        flat = t._folded_block(cin, f, device, gen)
        x = torch.randn(batch, h, w, cin, generator=gen).to(device,
                                                            torch.bfloat16)
        got = ob.osblock(x, flat, cin, f)
        ref = ob.osblock_reference(x, flat, cin, f)
        max_rel, mean_rel = t._rel(got, ref)
        print(f'B={batch} {h}x{w} {cin}->{f}: max-rel {max_rel:.2e} '
              f'mean-rel {mean_rel:.2e} differing '
              f'{(got != ref).float().mean().item():.5f}', flush=True)


def main():
    parser = argparse.ArgumentParser()
    parser.add_argument('--batch', type=int, default=chip_smoke.BATCH)
    parser.add_argument('--phases', action='store_true',
                        help='SM cycles per phase of the chosen plans')
    parser.add_argument('--agreement', action='store_true',
                        help="errors against the plain version at the card "
                             "tests' cases")
    args = parser.parse_args()
    if not torch.cuda.is_available():
        raise SystemExit('prof_osblock_torch: CUDA is not available')
    print(subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                          '--format=csv,noheader'], capture_output=True,
                         text=True, check=True).stdout.strip())
    if args.agreement:
        return agreement()
    if args.phases:
        return phases(args.batch)
    limit = ob._smem_limit(torch.cuda.current_device())
    gen = torch.Generator().manual_seed(0)
    chosen_total = 0.0
    for cin, f, h, w in chip_smoke.BLOCK_SHAPES:
        flat, packed = chip_smoke._random_block(cin, f, gen)
        x = torch.randn(args.batch, h, w, cin, generator=gen) \
            .to('cuda', torch.bfloat16)
        chosen = ob.launch_plan(args.batch, h, w, cin, f, limit)
        ref = ob.osblock_reference(x, flat, cin, f)
        real_plan = ob.launch_plan
        for plan in plans(args.batch, h, w, cin, f, limit):
            ob.launch_plan = lambda *a, _p=plan, **k: _p
            ob._prepared_plan.cache_clear()
            try:
                out = ob.osblock(x, flat, cin, f, packed)
                ms = chip_smoke.launches_ms(
                    lambda: ob.osblock(x, flat, cin, f, packed))
                graph_ms = graph_launches_ms(
                    lambda: ob.osblock(x, flat, cin, f, packed))
            finally:
                ob.launch_plan = real_plan
                ob._prepared_plan.cache_clear()
            max_rel, mean_rel, _ = chip_smoke.rel_err(out, ref)
            if not (max_rel < chip_smoke.MAX_REL
                    and mean_rel < chip_smoke.MEAN_REL):
                raise AssertionError(f'{cin}->{f} {plan}: disagrees with '
                                     f'the plain version: {max_rel}')
            mark = ' <- launch_plan' if plan == chosen else ''
            if plan == chosen:
                host = host_us(lambda: ob.osblock(x, flat, cin, f, packed))
                mark += f' (host {host:.1f} us a call)'
            if plan == chosen:
                chosen_total += ms
            print(f'B={args.batch} {h}x{w} {cin}->{f}: cluster '
                  f'{plan.cluster} x {plan.rows} rows, {plan.ctas} CTAs, '
                  f'{plan.variant}, {plan.smem} B: {ms * 1e3:.1f} us '
                  f'eager, {graph_ms * 1e3:.1f} us in a CUDA graph{mark}',
                  flush=True)
    print(f'six shapes with the chosen plans: {chosen_total:.4f} ms')


if __name__ == '__main__':
    main()
