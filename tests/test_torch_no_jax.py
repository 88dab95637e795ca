"""The port's main path needs neither JAX nor OpenCV (the machine with the
card has neither): in a fresh interpreter where both are unimportable,
``fastmot_tpu_torch``, its checkpoint importers, its int8 modules and
``fastmot_tpu_torch.parallel`` import, ``MOT`` runs a few frames with the
PUBLIC and the SSD detectors, and an association frame under int8, and a
2-stream ``MultiStreamMOT`` runs its first frame and a gap frame."""
import os
import re
import subprocess
import sys
from pathlib import Path

ROOT = Path(__file__).parents[1]

PRELUDE = '''
import sys
sys.modules['jax'] = None      # any import of jax or cv2 now raises
sys.modules['cv2'] = None
import numpy as np
import fastmot_tpu_torch
from fastmot_tpu_torch import MOT
rng = np.random.default_rng(0)
'''

CHECK = '''
loaded = [m for m in sys.modules if m.split('.')[0] in
          ('jax', 'flax', 'fastmot_tpu', 'cv2')
          and sys.modules[m] is not None]
assert not loaded, loaded
print('OK')
'''

PUBLIC = '''
seq = sys.argv[1]
mot = MOT((160, 120), detector_type='PUBLIC', detector_frame_skip=3,
          public_detector_cfg={'sequence_path': seq},
          feature_extractor_cfgs=({'model': 'OSNet025'},),
          device='cpu')
mot.reset(1 / 30.0)
for _ in range(4):
    mot.step(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
assert mot.frame_count == 4
'''

SSD = '''
import fastmot_tpu_torch.eval  # noqa: F401
from fastmot_tpu_torch.models import (darknet, onnx_import,  # noqa: F401
                                      osnet_convert, ssd_convert)
mot = MOT((160, 120), detector_type='SSD', detector_frame_skip=2,
          ssd_detector_cfg={'model': 'SSDMobileNetV1',
                            'tiling_grid': (2, 1)},
          feature_extractor_cfgs=({'model': 'OSNet025'},),
          device='cpu')
mot.reset(1 / 30.0)
for _ in range(3):
    mot.step(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
assert mot.frame_count == 3
'''

INT8 = '''
import json, tempfile
from fastmot_tpu_torch import calibrate_int8  # noqa: F401
from fastmot_tpu_torch.models import quantize
cache = tempfile.mktemp(suffix='.json')
with open(cache, 'w') as f:     # bench.py --int8's cache
    json.dump({'outputs': {}, 'inputs': {'*': 0.0}}, f)
int8 = {'quantize': 'int8', 'calib_cache': cache}
mot = MOT((160, 120), detector_type='YOLO', detector_frame_skip=2,
          class_ids=(0,), yolo_detector_cfg={'model': 'YOLOv4Tiny', **int8},
          feature_extractor_cfgs=({'model': 'OSNet025', **int8},),
          device='cpu')
assert isinstance(mot.detector.module, quantize.QuantizedModule)
assert isinstance(mot.extractors[0].module, quantize.QuantizedModule)
mot.reset(1 / 30.0)
for _ in range(3):
    mot.step(rng.integers(0, 256, (120, 160, 3), dtype=np.uint8))
assert mot.frame_count == 3
'''

MULTI = '''
from fastmot_tpu_torch.parallel import MultiStreamMOT
mot = MultiStreamMOT((160, 128), 2, detector_frame_skip=2, class_ids=(0,),
                     yolo_detector_cfg={'model': 'YOLOv4Tiny'},
                     tracker_cfg={'max_age': 3}, device='cpu')
mot.reset(1 / 30.0)
for _ in range(2):
    mot.step([rng.integers(0, 256, (128, 160, 3), dtype=np.uint8)
              for _ in range(2)])
mot.sync()
assert mot.frame_count == 2 and len(mot.trackers) == 2
'''


def run_without_jax(body, *args):
    """Run ``body`` in a fresh interpreter where jax and cv2 are
    unimportable. One intra-op thread: the subprocess shares the cores
    with the other test workers, and torch's thread pool, oversubscribed,
    slows tiny CPU ops by two orders of magnitude."""
    proc = subprocess.run(
        [sys.executable, '-c', PRELUDE + body + CHECK, *map(str, args)],
        cwd=ROOT, capture_output=True, text=True, timeout=120,
        env={**os.environ, 'OMP_NUM_THREADS': '1'})
    assert proc.returncode == 0, proc.stderr[-3000:]
    assert proc.stdout.startswith('OK')


def test_main_path_imports_neither_jax_nor_cv2(tmp_path):
    seq = tmp_path / 'SEQ'
    (seq / 'det').mkdir(parents=True)
    (seq / 'seqinfo.ini').write_text(
        '[Sequence]\nimWidth=160\nimHeight=120\n')
    (seq / 'det' / 'det.txt').write_text(''.join(
        f'{f + 1},-1,{20 + f},30,30,60,1,-1,-1,-1\n' for f in range(4)))
    run_without_jax(PUBLIC, seq)


def test_ssd_path_and_importers_import_neither_jax_nor_cv2():
    run_without_jax(SSD)


def test_int8_path_imports_neither_jax_nor_cv2():
    run_without_jax(INT8)


def test_multi_stream_path_imports_neither_jax_nor_cv2():
    run_without_jax(MULTI)


def test_port_sources_import_no_jax():
    pattern = re.compile(r'^\s*(import|from)\s+(jax|flax|fastmot_tpu)\b',
                         re.M)
    sources = [*(ROOT / 'fastmot_tpu_torch').rglob('*.py'),
               ROOT / 'chip_smoke.py']
    offenders = [str(p) for p in sources if pattern.search(p.read_text())]
    assert not offenders, offenders
