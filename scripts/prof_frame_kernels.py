#!/usr/bin/env python3
"""Where the YOLO postprocess, costs and ReID-input kernels spend their
cycles, on the card: stamped builds of csrc/nms_waves.cu (its
``nms_select_forward`` launches), csrc/assoc_costs.cu and
csrc/reid_crops.cu (scripts/kernel_stamps.py) on chip_smoke.py phase 21's
contested cases at one stream (16,128 decoded rows of which more than
1,024 pass the gates; tests/test_torch_assoc_costs.py's full-width case;
64 crops of a 1280 x 720 frame with boxes past its edges), then each
kernel's device time (100 calls between CUDA events behind a sleep
kernel), the costs kernel with and without its appearance products.

    python3 scripts/prof_frame_kernels.py

For each launch's first blocks it prints, for every pair of stamps in a
row (the mark before, the mark after), how often it occurred and its
cycles in all and on average. Each stamp takes an atomic on one counter
in device memory, which the cycles include (about 800 cycles a stamp on an
H100); with the card's name and power limit.
"""
import os
import subprocess
import sys

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))

import numpy as np  # noqa: E402
import torch  # noqa: E402

import chip_smoke as smoke  # noqa: E402
import kernel_stamps  # noqa: E402
from prof_assoc_tail import breakdown  # noqa: E402

# (name, the kernel's text with '@' where the stamp goes)
SELECT_MARKS = [
    ('select start', '  if (tid == 0) s_count = 0;\n@'),
    ('keys', '  __syncthreads();   // the keys are whole\n@'),
    ('radix pass', '      __syncthreads();   // s_digit, s_above and s_bin '
                   'are read\n@'),
    ('compacted', '  const int p2 = next_pow2(k);\n  __syncthreads();\n@'),
    ('sorted', '  bitonic_sort(sel, p2, true);\n@'),
    ('select end', '    p.c_valid[out0 + t] = (keep ? score : -1.0f) '
                   '> 0.0f;\n  }\n@}'),
    ('pack start', '  const size_t base = static_cast<size_t>(s) * k;\n'
                   '  // the select launch\'s candidates\n@'),
    ('pack rows', '      row_label[threadIdx.x] = p.c_label[base + i];\n'
                  '    }\n  }\n  __syncthreads();\n@'),
    ('pack end', '    out[j] = bits_j;\n  }\n@}'),
    ('order start', '  // the select and pack launches are done\n@'),
    ('order staged', 'smem_bits[x] = stream_bits[x];\n  __syncthreads();\n@'),
    ('waves done', '  run_waves(smem_bits, score, remaining, wave, kept, k, '
                   'nw);\n@'),
    ('keys ordered', '  bitonic_sort(order, p2, false);\n@'),
    ('order end', '    p.out_valid[out0 + r] = final_box[t];\n  }\n@}'),
]
COSTS_MARKS = [
    ('start', '  const bool live = row < n_rows;\n@'),
    ('detections', '    valid_d[j] = p.d_valid[static_cast<size_t>(s) * D '
                   '+ j];\n  }\n  __syncthreads();\n@'),
    ('occlusion', '@  if (tile == 0 && c0 == 0) {'),
    ('masks', '@  // the tile\'s rows: (tracks) the projected mean'),
    ('cholesky', '@  // the products: the tile\'s normalised features'),
    ('features', '@    float b2_mine = 0.0f;'),
    ('chunk staged', '      __syncthreads();\n@      if (k0 + kChunk < fp)'),
    ('products', '@  __syncthreads();   // occ, chol, b2 and row_a2 are '
                 'whole'),
    ('end', '        (!label_ok || iou_cost > p.iou_gate) ? kInfCost '
            ': iou_cost;\n  }\n@}'),
]
CROPS_MARKS = [
    ('start', '  const int s = n / p.boxes_a_stream;\n@'),
    ('row taps', '  float* out = p.out + ((static_cast<size_t>(n) * p.out_h '
                 '+ row)\n                        * p.out_w) * 3;\n@'),
    ('end', '      out[3 * j + c] = (x - mean_of(c)) / std_of(c);\n    }\n'
            '  }\n@}'),
]


def main():
    if not torch.cuda.is_available():
        raise SystemExit('prof_frame_kernels: needs a CUDA device')
    import tests.test_torch_assoc_costs as tcost
    import tests.test_torch_nms_select as tsel
    import tests.test_torch_reid_crops as tcrop
    from fastmot_tpu_torch.ops import assoc_costs as acost
    from fastmot_tpu_torch.ops import nms_waves as nw
    from fastmot_tpu_torch.ops import reid_crops as rc
    card = subprocess.run(['nvidia-smi', '--query-gpu=name,power.limit',
                           '--format=csv,noheader'], capture_output=True,
                          text=True, check=True).stdout.strip()
    torch.backends.cuda.matmul.allow_tf32 = False
    rng = np.random.default_rng(21)

    lib = nw.declare(kernel_stamps.stamped_library(
        'nms_waves', [m for _, m in SELECT_MARKS]))
    det = torch.as_tensor(tsel.clustered_rows(rng, 16128, 3, 120),
                          device='cuda')
    args = (det, torch.ones(3, dtype=torch.bool, device='cuda'), 0.25, 0.5,
            800000, 1.2, torch.tensor([1280.0, 720, 1280, 720],
                                      device='cuda'),
            torch.zeros(2, device='cuda'))
    outputs, s_args, keep = nw.nms_select_launch_args(*args, 1024, 128)
    print(f'nms_select, contested 16,128 rows (1 stream): block 0 of each '
          f'launch (the select, a pack block, the order) and pack block '
          f'127; {card}', flush=True)
    breakdown(lib, SELECT_MARKS, lambda: lib.nms_select_forward(*s_args),
              blocks=(0, 127))
    del keep
    plain = nw.declare(nw.nms_waves_library())
    dev = smoke.lk_device_ms(plain.nms_select_forward, s_args)
    print(f'nms_select: device {dev * 1e3:.2f} us a call; {card}',
          flush=True)

    lib = acost.declare(kernel_stamps.stamped_library(
        'assoc_costs', [m for _, m in COSTS_MARKS]))
    kind = 'full_width'
    states, hists, dets, embs = tcost.torch_case(
        tcost.costs_case(kind, tcost.CASE_SEEDS[kind]), 'cuda')
    outputs, c_args, keep = acost.assoc_costs_launch_args(
        *tcost.params(kind), states, hists, dets, embs,
        tcost.CASES[kind].emb_cap)
    print(f'assoc_costs, full width (1 stream): blocks 0 and 31 (track '
          f'rows 0-15 and 112-127 by detections 0-31 and 96-127) and 32 '
          f'(history rows 0-15); {card}', flush=True)
    breakdown(lib, COSTS_MARKS, lambda: lib.assoc_costs_forward(*c_args),
              blocks=(0, 31, 32))
    plain = acost.assoc_costs_library()
    app = tcost.plain_appearance(kind, (states, hists, dets, embs))
    _, g_args, g_keep = acost.assoc_costs_launch_args(
        *tcost.params(kind), states, hists, dets, embs,
        tcost.CASES[kind].emb_cap, app)
    dev = smoke.lk_device_ms(plain.assoc_costs_forward, c_args)
    given = smoke.lk_device_ms(plain.assoc_costs_forward, g_args)
    print(f'assoc_costs: device {dev * 1e3:.2f} us a call with the '
          f'products, {given * 1e3:.2f} with the distances given (the split '
          f'path); {card}', flush=True)
    del keep, g_keep

    lib = rc.declare(kernel_stamps.stamped_library(
        'reid_crops', [m for _, m in CROPS_MARKS]))
    frame = torch.as_tensor(smoke.textured_frames(smoke.SIZE, 1)[0],
                            device='cuda')
    boxes = torch.as_tensor(tcrop.edge_boxes(rng, 64, 720, 1280),
                            device='cuda')
    out, r_args, keep = rc.reid_crops_launch_args(frame, boxes, (256, 128))
    print(f'reid_crops, 64 crops: blocks 0 and 1; {card}', flush=True)
    breakdown(lib, CROPS_MARKS, lambda: lib.reid_crops_forward(*r_args),
              blocks=(0, 1))
    plain = rc.reid_crops_library()
    dev = smoke.lk_device_ms(plain.reid_crops_forward, r_args)
    print(f'reid_crops: device {dev * 1e3:.2f} us a call; {card}',
          flush=True)
    del keep


if __name__ == '__main__':
    main()
