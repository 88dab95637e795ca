"""Build and load the port's hand-written CUDA kernels.

Each ``csrc/<name>.cu`` exposes a plain C interface and is compiled by
``nvcc`` into ``csrc/build/<name>-<hash>.so`` at first use, keyed by a
hash of the source, then loaded with ``ctypes``. Nothing here runs at
import time. ``nvcc`` is taken from ``$CUDA_HOME/bin``, then ``PATH``,
then ``/usr/local/cuda/bin``.
"""
from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
import time
from pathlib import Path

CSRC = Path(__file__).resolve().parents[1] / 'csrc'
BUILD_DIR = CSRC / 'build'
NVCC_FLAGS = ('-gencode', 'arch=compute_90a,code=sm_90a', '-O3',
              '-std=c++17', '-shared', '-Xcompiler', '-fPIC')
# a kernel's own flags: these round every product and sum on their own (no
# FMA contraction), as their host builds in the tests do
KERNEL_FLAGS = {name: ('-fmad=false',) for name in
                ('gap_commit', 'flow_preprocess', 'gap_points',
                 'assoc_solvers', 'nms_waves', 'assoc_commit',
                 'assoc_costs', 'reid_crops')}


def nvcc_flags(name: str) -> tuple[str, ...]:
    return NVCC_FLAGS + KERNEL_FLAGS.get(name, ())


def find_nvcc() -> str:
    cands = []
    if os.environ.get('CUDA_HOME'):
        cands.append(Path(os.environ['CUDA_HOME']) / 'bin' / 'nvcc')
    which = shutil.which('nvcc')
    if which:
        cands.append(Path(which))
    cands.append(Path('/usr/local/cuda/bin/nvcc'))
    for c in cands:
        if c.is_file():
            return str(c)
    raise RuntimeError('nvcc not found (looked in $CUDA_HOME/bin, PATH and '
                       '/usr/local/cuda/bin)')


def library_path(name: str) -> Path:
    src = CSRC / f'{name}.cu'
    digest = hashlib.sha256(src.read_bytes()
                            + ' '.join(nvcc_flags(name)).encode()
                            ).hexdigest()[:16]
    return BUILD_DIR / f'{name}-{digest}.so'


def build(name: str) -> tuple[Path, float, str]:
    """Compile ``csrc/<name>.cu`` unless its hashed ``.so`` exists.
    Returns (path, seconds spent compiling, nvcc's output)."""
    out = library_path(name)
    if out.exists():
        return out, 0.0, ''
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    fd, tmp = tempfile.mkstemp(suffix='.so', dir=BUILD_DIR)
    os.close(fd)
    cmd = [find_nvcc(), *nvcc_flags(name), '-Xptxas', '-v', '-o', tmp,
           str(CSRC / f'{name}.cu')]
    t0 = time.perf_counter()
    proc = subprocess.run(cmd, capture_output=True, text=True)
    seconds = time.perf_counter() - t0
    if proc.returncode != 0:
        os.unlink(tmp)
        raise RuntimeError(f'nvcc failed to build {name}.cu '
                           f'(exit {proc.returncode}):\n{proc.stderr}')
    os.replace(tmp, out)   # atomic: concurrent builders never see half a file
    return out, seconds, proc.stdout + proc.stderr


@functools.cache
def load(name: str) -> ctypes.CDLL:
    """The built library of ``csrc/<name>.cu`` (built on first call)."""
    path, _, _ = build(name)
    return ctypes.CDLL(str(path))
