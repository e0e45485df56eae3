"""Native (C++) runtime components, bound via ctypes.

Built on demand with g++ into a cached shared library under
``build/poccala_tpu_torch/`` at the repository root (beside the CUDA
kernels' libraries); everything here degrades gracefully to the
pure-Python paths when the toolchain is unavailable.
"""

from __future__ import annotations

import ctypes
import os
import subprocess
import sys

import numpy as np

_SRC_DIR = os.path.dirname(os.path.abspath(__file__))
# built lib lives outside the package so package walkers don't try
# to import the ctypes .so as a Python extension module
_BUILD_DIR = os.path.join(os.path.dirname(os.path.dirname(_SRC_DIR)),
                          "build", "poccala_tpu_torch")
_LIB_PATH = os.path.join(_BUILD_DIR, "libpoccala_native.so")
_lib = None
_build_error: str | None = None


def _build() -> str | None:
    src = os.path.join(_SRC_DIR, "wavio.cpp")
    os.makedirs(_BUILD_DIR, exist_ok=True)
    if os.path.exists(_LIB_PATH) and os.path.getmtime(_LIB_PATH) >= os.path.getmtime(src):
        return _LIB_PATH
    cmd = [
        "g++", "-O3", "-shared", "-fPIC", "-std=c++17", "-pthread",
        src, "-o", _LIB_PATH,
    ]
    try:
        subprocess.run(cmd, check=True, capture_output=True, text=True)
    except (subprocess.CalledProcessError, FileNotFoundError) as e:
        global _build_error
        _build_error = getattr(e, "stderr", str(e)) or str(e)
        return None
    return _LIB_PATH


def get_lib():
    """Load (building if needed) the native library; None if unavailable."""
    global _lib
    if _lib is not None:
        return _lib
    path = _build()
    if path is None:
        return None
    lib = ctypes.CDLL(path)
    lib.poccala_load_wav_batch.restype = ctypes.c_int
    lib.poccala_load_wav_batch.argtypes = [
        ctypes.POINTER(ctypes.c_char_p), ctypes.c_int, ctypes.c_int64,
        ctypes.c_int, ctypes.c_int,
        ctypes.POINTER(ctypes.c_float),
        ctypes.POINTER(ctypes.c_int32),
        ctypes.POINTER(ctypes.c_int32),
    ]
    _lib = lib
    return lib


def available() -> bool:
    return get_lib() is not None


def load_wav_batch(
    paths: list[str],
    max_samples: int,
    drop_zeros: bool = False,
    num_threads: int | None = None,
):
    """Threaded native batch WAV load.

    :returns: (signals ``float32[n, max_samples]``, lengths ``int32[n]``
        (-1 for failed files), rates ``int32[n]``)
    :raises RuntimeError: when the native library cannot be built
    """
    lib = get_lib()
    if lib is None:
        raise RuntimeError(f"native library unavailable: {_build_error}")
    n = len(paths)
    out = np.zeros((n, max_samples), np.float32)
    lengths = np.zeros(n, np.int32)
    rates = np.zeros(n, np.int32)
    c_paths = (ctypes.c_char_p * n)(*[p.encode() for p in paths])
    if num_threads is None:
        num_threads = min(max(os.cpu_count() or 1, 1), 8)
    lib.poccala_load_wav_batch(
        c_paths, n, max_samples, int(drop_zeros), num_threads,
        out.ctypes.data_as(ctypes.POINTER(ctypes.c_float)),
        lengths.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
        rates.ctypes.data_as(ctypes.POINTER(ctypes.c_int32)),
    )
    return out, lengths, rates
