"""Builds the port's CUDA kernels at first use and loads them with ctypes.

`nvcc` compiles every `csrc/*.cu` for sm_90a (Hopper), one process per
source, all started together, and links the objects into one shared
library with a plain C interface in `edgegan_torch/build/` (listed in
`.gitignore`). The library's name carries a hash of the sources and the
headers they share (`csrc/*.cuh`), so an edited kernel is rebuilt and a
stale one is never loaded. Nothing here runs at import time: the CPU
tests import every module, and they have no `nvcc`.
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
HEADERS = sorted(glob.glob(os.path.join(_PKG, 'csrc', '*.cuh')))
BUILD_DIR = os.path.join(_PKG, 'build')
NVCC_FLAGS = ['-gencode', 'arch=compute_90a,code=sm_90a', '-std=c++17',
              '-O3', '-Xcompiler', '-fPIC']

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
    for src in SOURCES + HEADERS:
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
    tmp = f'{path}.{os.getpid()}.tmp'
    obj_dir = f'{tmp}.objs'
    os.makedirs(obj_dir, exist_ok=True)
    t0 = time.perf_counter()
    nvcc = _nvcc()
    try:
        objs = [os.path.join(obj_dir, os.path.basename(src) + '.o')
                for src in SOURCES]
        procs = [subprocess.Popen([nvcc, *NVCC_FLAGS, '-c', src, '-o', obj],
                                  stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True)
                 for src, obj in zip(SOURCES, objs)]
        failed = []
        for src, proc in zip(SOURCES, procs):
            out, _ = proc.communicate()
            if proc.returncode != 0:
                failed.append(f'{os.path.basename(src)} '
                              f'({proc.returncode}):\n{out}')
        if failed:
            raise RuntimeError('nvcc failed: ' + '\n'.join(failed))
        proc = subprocess.run([nvcc, '-shared', '-o', tmp, *objs],
                              capture_output=True, text=True)
        if proc.returncode != 0:
            raise RuntimeError(f'nvcc link failed ({proc.returncode}):\n'
                               f'{proc.stdout}{proc.stderr}')
    finally:
        shutil.rmtree(obj_dir, ignore_errors=True)
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
            # (x, y, planes, hw, dtype, act, variant, lanes, vectors,
            #  stream)
            fwd = lib.edgegan_instance_norm_act_fwd
            fwd.argtypes = [ptr, ptr, i64, i64, i32, i32, i32, i32, i32, ptr]
            # (x, g, dx, planes, hw, dtype, act, variant, lanes, vectors,
            #  stream)
            bwd = lib.edgegan_instance_norm_act_bwd
            bwd.argtypes = [ptr, ptr, ptr, i64, i64, i32, i32, i32, i32, i32,
                            ptr]
            # (bwd, dtype, act, variant, lanes, vectors, int[2] out)
            attrs = lib.edgegan_instance_norm_act_attrs
            attrs.argtypes = [i32, i32, i32, i32, i32, i32, ptr]
            # (x, g, leak, dx, dleak, partials, n, partials_len, dtype,
            #  stream)
            prelu = lib.edgegan_prelu_bwd
            prelu.argtypes = [ptr, ptr, ptr, ptr, ptr, ptr, i64, i32, i32,
                              ptr]
            # (rg, ht, img, out, planes, hw, dtype, stream)
            gate = lib.edgegan_mru_gate_fwd
            gate.argtypes = [ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
            # (rg, img, g, drg, dimg, planes, hw, dtype, stream)
            gate_bwd = lib.edgegan_mru_gate_bwd
            gate_bwd.argtypes = [ptr, ptr, ptr, ptr, ptr, i64, i64, i32, ptr]
            for fn in (fwd, bwd, attrs, prelu, gate, gate_bwd):
                fn.restype = ctypes.c_int
            _lib = lib
        return _lib
