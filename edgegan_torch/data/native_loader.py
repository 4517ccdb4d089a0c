"""ctypes binding of the repository's C++ batch PNG decoder
(native/loader.cpp; the JAX package's data/native_loader.py:1-87).

The library is built at first use with `g++ -O3 -shared -fPIC ... -lpng
-lpthread` into `edgegan_torch/build/` (listed in `.gitignore`), under a
name that carries a hash of the source, so an edited source is rebuilt;
nothing is written next to the source. `decode_batch` decodes PNGs that
are already at the target size: decode, scipy's bytescale stretch and
`x / 127.5 - 1` in float32, bit for bit what the JAX package's dataset
gives for such files. An image it cannot take (another size, not a PNG,
a decode error) is flagged in the fail mask, and the caller decodes it
with PIL; without g++ or libpng there is no library and `decode_batch`
returns None (`build_error` then says why).

This is host decoding, not a device kernel.
"""
from __future__ import annotations

import ctypes
import hashlib
import os
import subprocess
import threading
from typing import List, Optional

import numpy as np

_PKG = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SOURCE = os.path.join(os.path.dirname(_PKG), 'native', 'loader.cpp')
BUILD_DIR = os.path.join(_PKG, 'build')

_lock = threading.Lock()
_lib = None
build_error: Optional[str] = None  # why the library is unavailable


def _library_path() -> str:
    with open(SOURCE, 'rb') as f:
        digest = hashlib.sha256(f.read()).hexdigest()[:16]
    return os.path.join(BUILD_DIR, f'libedgegan_loader_{digest}.so')


def _build(path: str):
    """Compile SOURCE to `path` (through a temporary file renamed into
    place, so a concurrent reader never loads half a library)."""
    os.makedirs(BUILD_DIR, exist_ok=True)
    tmp = f'{path}.{os.getpid()}.tmp'
    try:
        subprocess.run(['g++', '-O3', '-shared', '-fPIC', '-o', tmp, SOURCE,
                        '-lpng', '-lpthread'],
                       check=True, capture_output=True, text=True,
                       timeout=120)
        os.replace(tmp, path)
    finally:
        if os.path.exists(tmp):
            os.remove(tmp)


def get_lib() -> Optional[ctypes.CDLL]:
    """The loaded library, built first if needed, or None when it cannot
    be built or loaded (the reason in `build_error`)."""
    global _lib, build_error
    with _lock:
        if _lib is not None or build_error is not None:
            return _lib
        try:
            path = _library_path()
            if not os.path.exists(path):
                _build(path)
            lib = ctypes.CDLL(path)
        except subprocess.CalledProcessError as e:
            build_error = (e.stderr or str(e)).strip()
            return None
        except (OSError, subprocess.TimeoutExpired) as e:
            build_error = str(e)
            return None
        lib.edgegan_decode_batch.restype = ctypes.c_int
        lib.edgegan_decode_batch.argtypes = [
            ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int,
            ctypes.c_int, ctypes.POINTER(ctypes.c_float),
            ctypes.POINTER(ctypes.c_uint8), ctypes.c_int]
        _lib = lib
    return _lib


def decode_batch(paths: List[str], height: int, width: int,
                 n_threads: int = 8):
    """-> (images [n, h, w, 3] float32 in [-1, 1], fail_mask [n] bool),
    where fail_mask[i] means image i was not decoded (the caller falls
    back to PIL); None when the library is unavailable."""
    lib = get_lib()
    if lib is None:
        return None
    n = len(paths)
    out = np.empty((n, height, width, 3), np.float32)
    fail = np.zeros((n,), np.uint8)
    arr = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    lib.edgegan_decode_batch(
        arr, n, height, width,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        fail.ctypes.data_as(ctypes.POINTER(ctypes.c_uint8)),
        n_threads)
    return out, fail.astype(bool)
