"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `csrc/*.cu` into one shared library with a plain C
interface, for sm_90a (Hopper), into `edgegan_torch/build/` (listed in
`.gitignore`). The library's name carries a hash of the sources, so an
edited kernel is rebuilt and a stale one is never loaded. Nothing here
runs at import time: the CPU tests import every module, and they have
no `nvcc`.
"""
from __future__ import annotations

import ctypes
import glob
import hashlib
import os
import shutil
import subprocess
import threading
import time

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCES = sorted(glob.glob(os.path.join(_PKG, 'csrc', '*.cu')))
BUILD_DIR = os.path.join(_PKG, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-shared', '-Xcompiler', '-fPIC']

_lock = threading.Lock()
_lib = None
build_seconds = None  # wall time of the last build in this process


def _nvcc() -> str:
    for cand in (os.environ.get('CUDA_HOME') and
                 os.path.join(os.environ['CUDA_HOME'], 'bin', 'nvcc'),
                 shutil.which('nvcc'), '/usr/local/cuda/bin/nvcc'):
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError('nvcc not found: the CUDA kernels of edgegan_torch '
                       'are built from edgegan_torch/csrc at first use')


def _digest() -> str:
    h = hashlib.sha256(' '.join(NVCC_FLAGS).encode())
    for src in SOURCES:
        with open(src, 'rb') as f:
            h.update(f.read())
    return h.hexdigest()[:16]


def build() -> str:
    """Compile the sources if this version is not built yet; return the
    library's path."""
    global build_seconds
    path = os.path.join(BUILD_DIR, f'libedgegan_kernels_{_digest()}.so')
    if os.path.exists(path):
        return path
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    t0 = time.perf_counter()
    proc = subprocess.run([_nvcc(), *NVCC_FLAGS, '-o', tmp, *SOURCES],
                          capture_output=True, text=True)
    if proc.returncode != 0:
        raise RuntimeError(f'nvcc failed ({proc.returncode}):\n'
                           f'{proc.stdout}{proc.stderr}')
    os.replace(tmp, path)  # atomic: another process never loads half
    build_seconds = time.perf_counter() - t0
    return path


def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    global _lib
    with _lock:
        if _lib is None:
            lib = ctypes.CDLL(build())
            ptr, i64, i32 = ctypes.c_void_p, ctypes.c_int64, ctypes.c_int
            # (x, y, planes, hw, dtype, act, stream)
            fwd = lib.edgegan_instance_norm_act_fwd
            fwd.argtypes = [ptr, ptr, i64, i64, i32, i32, ptr]
            # (x, g, dx, planes, hw, dtype, act, stream)
            bwd = lib.edgegan_instance_norm_act_bwd
            bwd.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, ptr]
            for fn in (fwd, bwd):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
